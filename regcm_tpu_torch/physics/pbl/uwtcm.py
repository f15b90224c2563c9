"""UW turbulent closure model (ibltyp=2), torch twin of
``regcm_tpu/physics/pbl/uwtcm.py``: the Bretherton-McCaa-Grenier (2004)
moist TKE PBL of ``Main/pbllib/mod_pbl_uwtcm.F90:137`` (uwtcm) and
``mod_pbl_thetal.F90``.

Prognoses TKE on the kz+1 interface levels; diffuses liquid-water
potential temperature and total water (and ice and momentum) implicitly
with Mellor-Yamada level-2.5 stability functions; diagnoses the PBL
height from connected convectively unstable (N²≤0) interface layers,
extended up and down by the integrated N²·l² criterion with cloud-top
radiative and entrainment contributions (Grenier-Bretherton 2001).

Every column is processed at once: the tridiagonal solves are batched
Thomas sweeps, loops over k on whole (iy, jx) planes (plain torch: this
solve is not one of the TPU kernels); the reference's unstable-layer
bookkeeping is recast, as in the JAX package, as run-labelling prefix
sweeps plus one upward and one downward extension sweep, with merged
layers reconnected by a final relabel. ``thv0 = thgb*(1+tvfac)``
reproduces the reference formula at mod_pbl_uwtcm.F90:329 verbatim.

Index conventions: k=0 is the model top. Layer arrays are (kz, iy, jx);
interface arrays (kz+1, iy, jx) with interface kz = the surface.
Interface k sits between layer k-1 (above) and layer k (below).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...utils import constants as c
from ...utils.thermo import pfwsat

UWTKEMIN = 1.0e-3          # uwtkemin (mod_pbl_uwtcm.F90:86)
XFR = 0.1                  # fraction of turb layer in bbls (:90)
AONE = 1.9 * XFR           # :92
MINN2 = 1.0e-7             # :95
KTHMAX = 1.0e3             # melloryamada kthmax/kzmmax (:813-814)
# Mellor-Yamada closure constants (melloryamada :810-811)
A1, C1, A2, B2 = 0.92, 0.08, 0.74, 10.1


class UWParams(NamedTuple):
    """uwparam namelist defaults (Main/mod_params.F90:476-480)."""
    atwo: float = 15.0
    rstbl: float = 1.5
    czero: float = 5.869
    nuk: float = 5.0


class UWOut(NamedTuple):
    uten: torch.Tensor      # (kz,iy,jx) uncoupled cross du/dt
    vten: torch.Tensor
    tten: torch.Tensor      # uncoupled dT/dt
    qvten: torch.Tensor
    qcten: torch.Tensor
    qiten: torch.Tensor
    tketen: torch.Tensor    # (kz+1,iy,jx) d(tke)/dt
    kth: torch.Tensor       # scalar diffusivity, interfaces
    kzm: torch.Tensor       # momentum diffusivity, interfaces
    kpbl: torch.Tensor      # (iy,jx) PBL-top interface index
    zpbl: torch.Tensor      # (iy,jx) PBL height (m)


def _tridiag(a, b, cc, rhs_list):
    """Batched Thomas algorithm along dim 0 (solve_tridiag,
    mod_pbl_uwtcm.F90:725-757). a/b/cc: (n, iy, jx)."""
    n = a.shape[0]
    bps = [b[0]]
    vps = [[r[0]] for r in rhs_list]
    for k in range(1, n):
        m = a[k] / bps[-1]
        bps.append(b[k] - m * cc[k - 1])
        for r, vp in zip(rhs_list, vps):
            vp.append(r[k] - m * vp[-1])
    outs = []
    for vp in vps:
        xs = [vp[n - 1] / bps[n - 1]]
        for k in range(n - 2, -1, -1):
            xs.append((vp[k] - cc[k] * xs[-1]) / bps[k])
        outs.append(torch.stack(xs[::-1]))
    return tuple(outs)


def _set_row(a, k, v):
    """a with row k replaced by v (a fresh tensor)."""
    a = a.clone()
    a[k] = v
    return a


def _n2(thl, qw, exnerfl, rexnerfl, presfl, rdza, qw_ref):
    """Saturation-adjusted buoyancy frequency at interfaces 1..kz-1
    (n2, mod_pbl_uwtcm.F90:759-803). Returns (nsq, rcldb) on the
    (kz+1, …) interface grid (row 0 a copy of row 1, row kz zero: the
    caller fills it). qw_ref: the qw profile of the virtual-effect
    factor (the reference closes over the *outer* qwx, not the
    iterate)."""
    kz = thl.shape[0]
    ex, pr = exnerfl[1:kz], presfl[1:kz]

    def sat_adjust(thl_lay, qw_lay):
        # one Newton step from the liquid-water temperature
        templ = thl_lay * ex
        rvls = pfwsat(templ, pr)
        temps = templ + (qw_lay - rvls) / (
            c.cpowlhv + c.ep2 * c.wlhv * rvls / (c.rgas * templ * templ))
        rvls = pfwsat(temps, pr)
        return templ, torch.clamp(qw_lay - rvls, min=0.0)

    # below-interface parcel: layer k lifted to interface k
    templ_b, rcld_b = sat_adjust(thl[1:], qw[1:])
    tvbl = (templ_b + c.wlhvocp * rcld_b) * (
        1.0 + c.ep1 * (qw_ref[1:] - rcld_b) - rcld_b) * rexnerfl[1:kz]
    # above-interface parcel: layer k-1 lowered to interface k
    templ_a, rcld_a = sat_adjust(thl[:-1], qw[:-1])
    tvab = (templ_a + c.wlhvocp * rcld_a) * (
        1.0 + c.ep1 * (qw_ref[:-1] - rcld_a) - rcld_a) * rexnerfl[1:kz]

    thvxfl = 0.5 * (tvab + tvbl)
    dtvdz = (tvab - tvbl) * rdza[1:kz]
    nsq_i = c.egrav / thvxfl * dtvdz
    z1 = torch.zeros_like(nsq_i[:1])
    nsq = torch.cat([nsq_i[:1], nsq_i, z1], dim=0)
    rcldb = torch.cat([torch.zeros_like(rcld_b[:1]), rcld_b, z1], dim=0)
    return nsq, rcldb


def _label_runs(mask):
    """Run starts, ends and each member's run top and bottom interface
    by prefix sweeps down and up the column."""
    n = mask.shape[0]
    above = torch.cat([torch.zeros_like(mask[:1]), mask[:-1]], dim=0)
    start = mask & ~above
    below = torch.cat([mask[1:], torch.zeros_like(mask[:1])], dim=0)
    end = mask & ~below
    zi = torch.zeros(mask.shape[1:], dtype=torch.int64, device=mask.device)
    tops, cur = [], zi
    for k in range(n):
        cur = torch.where(start[k], k, cur)
        tops.append(cur)
    bots, cur = [None] * n, zi
    for k in range(n - 1, -1, -1):
        cur = torch.where(end[k], k, cur)
        bots[k] = cur
    return start, end, torch.stack(tops), torch.stack(bots)


def _run_reduce(start, end, vals, mask):
    """Sum vals over each run; the total broadcast to every member."""
    n = vals.shape[0]
    prefix, s = [], torch.zeros_like(vals[0])
    for k in range(n):
        s = torch.where(start[k], vals[k],
                        s + torch.where(mask[k], vals[k], 0.0))
        prefix.append(s)
    tot, cur = [None] * n, torch.zeros_like(vals[0])
    for k in range(n - 1, -1, -1):
        cur = torch.where(end[k], prefix[k], cur)
        tot[k] = cur
    return torch.stack(tot)


def _pblhgt(nsq, tke, zq_ext, qc_lay, heatrt, presfl, rhoxfl, uthv,
            exnerfl, rexnerhl, thl, thx, qw, ktr, p: UWParams):
    """PBL height and master length scale (pblhgt,
    mod_pbl_uwtcm.F90:909-1057). Returns (bbls, top_mask, kmix, zpbl)
    where top_mask marks the convective-layer top interfaces."""
    kzp1 = nsq.shape[0]
    kz = kzp1 - 1
    karr = torch.arange(kzp1, device=nsq.device)[:, None, None]
    vkzq = c.vonkar * zq_ext[:kzp1]

    unstable = nsq <= 0.0
    unstable[0] = False                    # the ref loop starts at k=2

    def run_geometry(mask):
        start, end, tops, bots = _label_runs(mask)
        # blinf = xfr*(zq[top-1] - zq[bot+1]) (:951)
        ztop = zq_ext.gather(0, torch.clamp(tops - 1, min=0))
        zbot = zq_ext.gather(0, torch.clamp(bots + 1, max=kzp1))
        blinf = XFR * (ztop - zbot)
        bbls_c = torch.minimum(blinf, vkzq)
        nn = nsq * bbls_c * bbls_c
        rnnll = _run_reduce(start, end, torch.where(mask, nn, 0.0), mask)
        nlev = _run_reduce(start, end,
                           torch.where(mask, nsq.new_tensor(1.0), 0.0),
                           mask)
        tketot = _run_reduce(start, end, torch.where(mask, tke, 0.0), mask)
        tkeavg = tketot / torch.clamp(nlev, min=1.0)
        return start, end, blinf, bbls_c, rnnll, nlev, tkeavg

    start, end, blinf, bbls_c, rnnll, nlev, tkeavg = \
        run_geometry(unstable)

    # ---- upward extension (searchup1 :963-990): k = kz → 1 -----------
    z2b = torch.zeros(nsq.shape[1:], dtype=torch.bool, device=nsq.device)
    z2f = torch.zeros_like(nsq[0])
    active, rnn, nl, bli, first = z2b, z2f, z2f, z2f, z2b
    ext_up = torch.zeros_like(unstable)
    for k in range(kzp1 - 1, 0, -1):
        is_top = start[k]
        active = active | is_top
        rnn = torch.where(is_top, rnnll[k], rnn)
        nl = torch.where(is_top, nlev[k], nl)
        bli = torch.where(is_top, blinf[k], bli)
        first = first | is_top
        kk = k - 1     # the candidate interface above
        tb = torch.minimum(bli, vkzq[kk])
        trn = nsq[kk] * tb * tb
        cont = active & (first | (trn * nl < -0.5 * rnn)) & ~unstable[kk]
        if kk < 1:
            cont = cont & False
        rnn = torch.where(cont, rnn + trn, rnn)
        nl = torch.where(cont, nl + 1.0, nl)
        active = cont
        first = z2b
        ext_up[kk] = cont

    mask2 = unstable | ext_up
    start, end, blinf, bbls_c, rnnll, nlev, tkeavg = run_geometry(mask2)

    # ---- cloud-top radiative + entrainment terms (:992-1010) ----------
    qc_i = torch.cat([qc_lay, torch.zeros_like(qc_lay[:1])], dim=0)
    heat_i = torch.cat([heatrt, torch.zeros_like(heatrt[:1])], dim=0)
    presfl_x = torch.cat([presfl, presfl[-1:]], dim=0)
    radnnll = torch.where(
        qc_i > c.minqq,
        heat_i * (presfl_x[1:kzp1 + 1] - presfl_x[:kzp1])
        / (rhoxfl * uthv * exnerfl), 0.0)
    thl_i = torch.cat([thl, thl[-1:]], dim=0)
    thx_i = torch.cat([thx, thx[-1:]], dim=0)
    qw_i = torch.cat([qw, qw[-1:]], dim=0)
    thvl = thl_i + thx_i * c.ep1 * qw_i            # per layer
    delthvl = (torch.roll(thvl, 2, dims=0) - thvl)[:kzp1]
    # elambda from the qc of the layer below (a conservative estimate of
    # the interface's rcldb)
    elam = c.wlhvocp * qc_i * torch.cat(
        [rexnerhl, rexnerhl[-1:]], dim=0)[:kzp1] \
        / torch.clamp(delthvl, min=0.1)
    biga = AONE * (1.0 + p.atwo * 0.8 * elam)
    entnnll = torch.where(karr >= 2, biga * tkeavg ** 1.5
                          / torch.clamp(bbls_c, min=1e-10), 0.0)
    addtop = torch.where(
        (tkeavg > 0.0) & start,
        torch.clamp(bbls_c / torch.sqrt(torch.clamp(tkeavg, min=1e-12))
                    * (radnnll + entnnll), max=0.0), 0.0)
    # add the top contribution to the whole run's rnnll
    rnnll = rnnll + _run_reduce(start, end, addtop, mask2)

    # ---- downward extension (searchdown1 :1012-1037): k = 0 → kz-1 ----
    active, rnn, nl, bli = z2b, z2f, z2f, z2f
    ext_dn = torch.zeros_like(unstable)
    for k in range(kzp1 - 1):
        is_bot = end[k]
        active = active | is_bot
        rnn = torch.where(is_bot, rnnll[k], rnn)
        nl = torch.where(is_bot, nlev[k], nl)
        bli = torch.where(is_bot, blinf[k], bli)
        kk = k + 1
        tb = torch.minimum(bli, vkzq[kk])
        trn = nsq[kk] * tb * tb
        cont = active & (trn * nl < -0.5 * rnn) & ~mask2[kk]
        rnn = torch.where(cont, rnn + trn, rnn)
        nl = torch.where(cont, nl + 1.0, nl)
        active = cont
        ext_dn[kk] = cont

    mask3 = mask2 | ext_dn
    s3, _, t3, b3 = _label_runs(mask3)
    ztop = zq_ext.gather(0, torch.clamp(t3 - 1, min=0))
    zbot = zq_ext.gather(0, torch.clamp(b3 + 1, max=kzp1))
    blinf3 = XFR * (ztop - zbot)

    # final master length scale (setbbls :1041-1048 + stable branch :938)
    bbls_stable = torch.where(
        nsq > 0.0,
        torch.minimum(p.rstbl * torch.sqrt(tke / torch.clamp(nsq,
                                                             min=1e-20)),
                      vkzq), 0.0)
    bbls = torch.where(mask3, torch.minimum(blinf3, vkzq), bbls_stable)
    bbls[0] = 0.0

    any_run = torch.any(mask3, dim=0)
    kmin = torch.amin(torch.where(mask3, karr, kzp1), dim=0)
    kmix = torch.where(any_run, torch.maximum(kmin, ktr), kz)
    zpbl = zq_ext.gather(0, kmix[None])[0]
    return bbls, s3, kmix, zpbl


def uwtcm(t, qv, qc, qi, u, v, za, zq, dzq, patm, patmf, tke0,
          heatrt, tg, q2m, qfx, hfx, uvdrag, lndmsk, ptrop, dt,
          p: UWParams = UWParams(), diffuse_ice: bool = False):
    """One UW TCM step over the whole grid (uwtcm,
    Main/pbllib/mod_pbl_uwtcm.F90:137-714). All 3-D layer inputs are
    (kz, iy, jx) decoupled physical fields at time b; tke0 is
    (kz+1, iy, jx); ptrop the tropopause interface index. Returns
    uncoupled tendencies (UWOut)."""
    kz = t.shape[0]
    kzp1 = kz + 1
    rczero = 1.0 / p.czero
    tkefac = p.czero ** (2.0 / 3.0)
    b1 = p.czero * 2.0 ** 1.5

    tke = torch.clamp(tke0, min=UWTKEMIN)
    zq_ext = torch.cat([zq, torch.zeros_like(zq[:1])], dim=0)

    exnerhl = (patm / c.stdp) ** c.rovcp
    rexnerhl = 1.0 / exnerhl
    exnerfl = (patmf / c.stdp) ** c.rovcp
    rexnerfl = 1.0 / exnerfl
    rdzq = 1.0 / dzq

    thx = t * rexnerhl
    qw = qv + qc
    tvcon = 1.0 + c.ep1 * qv - qc
    tvx = t * tvcon
    uthv = thx * tvcon
    thl = thx - c.wlhvocp * qc * rexnerhl

    rhoxhl = patm / (c.rgas * tvx)
    rrhoxhl = 1.0 / rhoxhl

    # interface spacing/density (:283-293)
    dza = za[:-1] - za[1:]                       # interfaces 1..kz-1
    rdza_i = 1.0 / dza
    z1 = torch.zeros_like(t[:1])
    rdza = torch.cat([z1, rdza_i, z1], dim=0)   # (kz+1)
    fracz = (zq[1:kz] - za[1:]) * rdza_i
    rhoxfl_i = rhoxhl[1:] + (rhoxhl[:-1] - rhoxhl[1:]) * fracz
    rhoxfl = torch.cat([rhoxhl[:1], rhoxfl_i, rhoxhl[-1:]], dim=0)
    rrhoxfl = 1.0 / rhoxfl
    # interface uthv for the radiative buoyancy term
    uthv_i = torch.cat([uthv, uthv[-1:]], dim=0)

    # ---- surface (:314-345) -------------------------------------------
    thgb = tg * rexnerfl[kz]
    q0s = pfwsat(tg, patmf[kz])
    tvfac = torch.where(lndmsk > 0.5, 1.0 + c.ep1 * q2m, 1.0 + c.ep1 * q0s)
    rhoxsf = patmf[kz] / (c.rgas * tvx[kz - 1])
    # verbatim reference formula (:329)
    thv0 = thgb * (1.0 + tvfac)
    dthv = uthv[kz - 1] - thv0

    # ---- N², PBL height (:352-365) ------------------------------------
    nsq, rcldb = _n2(thl, qw, exnerfl, rexnerfl, patmf, rdza, qw)
    nsq = _set_row(nsq, kz, c.egrav / uthv[kz - 1] * dthv / za[kz - 1])

    bbls, top_mask, kmix, zpbl = _pblhgt(
        nsq, tke, zq_ext, qc, heatrt, patmf, rhoxfl, uthv_i, exnerfl,
        rexnerhl, thl, thx, qw, ptrop, p)
    karr = torch.arange(kzp1, device=t.device)[:, None, None]

    # ---- Mellor-Yamada diffusivities ----------------------------------
    def melloryamada(nsq_in, rcldb_in, thl_in, qw_in):
        gh = -bbls ** 2 * nsq_in / (2.0 * tke + 1.0e-9)
        gh = torch.clamp(gh, -0.28, 0.0233)      # Galperin 88 limits
        a1ob1 = A1 / b1
        sm = A1 * (1.0 - 3.0 * C1 - 6.0 * a1ob1 - 3.0 * A2 * gh *
                   ((B2 - 3.0 * A2) * (1.0 - 6.0 * a1ob1)
                    - 3.0 * C1 * (B2 + 6.0 * A1))) / \
            ((1.0 - 3.0 * A2 * gh * (6.0 * A1 + B2))
             * (1.0 - 9.0 * A1 * A2 * gh))
        sh = A2 * (1.0 - 6.0 * a1ob1) / (1.0 - 3.0 * A2 * gh
                                         * (6.0 * A1 + B2))
        speed = torch.sqrt(2.0 * tke)
        edge = (karr == 0) | (karr == kz)
        kth = torch.where(edge, 0.0,
                          torch.clamp(bbls * speed * sh, max=KTHMAX))
        kzm = torch.where(edge, 0.0,
                          torch.clamp(bbls * speed * sm, max=KTHMAX))
        # kethl on layers (:863): geometric mean of bounding interfaces
        kethl = torch.clamp(p.nuk * torch.sqrt(kzm[:kz] * kzm[1:]),
                            max=KTHMAX)
        # convective-top entrainment closure (conv :869-901)
        thvl = thl_in + thx * c.ep1 * qw_in
        thvl_i = torch.cat([thvl, thvl[-1:]], dim=0)
        delthvl = (torch.roll(thvl_i, 2, dims=0) - thvl_i)[:kzp1]
        elam = c.wlhvocp * rcldb_in * torch.cat(
            [rexnerhl, rexnerhl[-1:]], dim=0)[:kzp1] \
            / torch.clamp(delthvl, min=0.1)
        biga = AONE * (1.0 + p.atwo * 0.8 * elam)
        bbmax = torch.maximum(bbls, torch.cat([bbls[1:], bbls[-1:]], dim=0))
        kth_ent = torch.minimum(
            kth, biga * tke ** 1.5 / torch.clamp(nsq_in, min=MINN2)
            / torch.clamp(bbmax, min=1e-10))
        sel = top_mask & (nsq_in >= MINN2) & (karr >= 2)
        kth_new = torch.where(sel, torch.clamp(kth_ent, max=KTHMAX), kth)
        sh_dn = torch.cat([sh[1:], sh[-1:]], dim=0)
        sm_dn = torch.cat([sm[1:], sm[-1:]], dim=0)
        kzm_new = torch.where(
            sel, torch.clamp(torch.minimum(kzm, kth_new / sh_dn * sm_dn),
                             max=KTHMAX), kzm)
        # kethl: conv tops get nuk*kzm[k+1]; the level above zeroed
        kzm_dn = torch.cat([kzm_new[1:], kzm_new[-1:]], dim=0)
        sel_l = sel[:kz]
        kethl = torch.where(sel_l, torch.clamp(p.nuk * kzm_dn[:kz],
                                               max=KTHMAX), kethl)
        above = torch.cat([sel_l[1:], torch.zeros_like(sel_l[:1])], dim=0)
        kethl = torch.where(above & (karr[:kz] >= 2), 0.0, kethl)
        kethl = torch.cat([kethl[1:2], kethl[1:kz - 1],
                           (p.nuk * 0.5 * kzm_new[kz - 1])[None]], dim=0)
        return kth_new, kzm_new, kethl

    def implicit_coeffs(kk):
        """Sub- and super-diagonals of the layer diffusion with the
        interface diffusivity kk."""
        a = torch.cat([z1, -(rhoxfl[1:kz] * rrhoxhl[1:]) * kk[1:kz] * dt
                       * rdzq[1:] * rdza[1:kz]], dim=0)
        cc = torch.cat([-(rhoxfl[1:kz] * rrhoxhl[:-1]) * kk[1:kz] * dt
                        * rdzq[:-1] * rdza[1:kz], z1], dim=0)
        return a, 1.0 - a - cc, cc

    # ---- 2-iteration semi-implicit thl/qw diffusion (:377-421) --------
    thl_it, qw_it = thl, qw
    nsq_it, rcldb_it = nsq, rcldb
    for _ in range(2):
        kth, kzm, kethl = melloryamada(nsq_it, rcldb_it, thl_it, qw_it)
        a, b, cc = implicit_coeffs(kth)
        r1 = _set_row(thl, kz - 1, thl[kz - 1] + dt * hfx * rrhoxhl[kz - 1]
                      * c.rcpd * rdzq[kz - 1] * rexnerhl[kz - 1])
        r2 = _set_row(qw, kz - 1, qw[kz - 1] + dt * qfx * rrhoxhl[kz - 1]
                      * rdzq[kz - 1])
        thl_it, qw_it = _tridiag(a, b, cc, [r1, r2])
        nsq_it, rcldb_it = _n2(thl_it, qw_it, exnerfl, rexnerfl, patmf,
                               rdza, qw)
        # surface N² from the updated lowest layer (:415-419)
        thx_t = thl_it[kz - 1] + c.wlhvocp * qc[kz - 1] * rexnerhl[kz - 1]
        thvx_t = thx_t * (1.0 + c.ep1 * qv[kz - 1] - qc[kz - 1])
        nsq_it = _set_row(nsq_it, kz, c.egrav / thvx_t * (thvx_t - thv0)
                          / za[kz - 1])

    # ---- recover T, qv, qc from thl/qw (3-iter Newton, :443-465) ------
    templ = thl_it * exnerhl
    temps = templ
    rvls = pfwsat(temps, patm)
    for _ in range(3):
        dtc = ((templ - temps) * c.cpowlhv + qw_it - rvls) / (
            c.cpowlhv + c.ep2 * c.wlhv * rvls / (c.rgas * temps * temps))
        temps = temps + dtc
        rvls = pfwsat(temps, patm)
    qc_new = torch.clamp(qw_it - rvls, min=0.0)
    qv_new = qw_it - qc_new
    thx_new = (templ + c.wlhvocp * qc_new) * rexnerhl
    uthv_new = thx_new * (1.0 + c.ep1 * qv_new - qc_new)

    # ---- implicit momentum diffusion (:470-496) -----------------------
    uflxp = -uvdrag * u[kz - 1] / rhoxsf
    vflxp = -uvdrag * v[kz - 1] / rhoxsf
    a, b, cc = implicit_coeffs(kzm)
    ru = _set_row(u, kz - 1, u[kz - 1] + dt * uflxp
                  * (rhoxsf * rrhoxhl[kz - 1]) * rdzq[kz - 1])
    rv = _set_row(v, kz - 1, v[kz - 1] + dt * vflxp
                  * (rhoxsf * rrhoxhl[kz - 1]) * rdzq[kz - 1])
    if diffuse_ice:
        (qi_new,) = _tridiag(*implicit_coeffs(kth), [qi])
        qi_new = torch.clamp(qi_new, min=0.0)
    else:
        qi_new = qi
    u_new, v_new = _tridiag(a, b, cc, [ru, rv])

    # ---- TKE budget (:584-665) ----------------------------------------
    uflxp = -uvdrag * u_new[kz - 1] / rhoxsf
    vflxp = -uvdrag * v_new[kz - 1] / rhoxsf
    ustxsq = torch.sqrt(uflxp ** 2 + vflxp ** 2)
    dthv = uthv_new[kz - 1] - thv0
    nsq_it = _set_row(nsq_it, kz,
                      c.egrav / uthv_new[kz - 1] * dthv / za[kz - 1])

    dudz = (u_new[:-1] - u_new[1:]) * rdza[1:kz]
    dvdz = (v_new[:-1] - v_new[1:]) * rdza[1:kz]
    svs = dudz ** 2 + dvdz ** 2
    zi1 = torch.zeros_like(nsq[:1])
    buoyan = torch.cat([zi1, -kth[1:kz] * nsq_it[1:kz], zi1], dim=0)
    shear = torch.cat([zi1, kzm[1:kz] * svs, zi1], dim=0)
    # cloud-top radiative divergence (radib :607-614)
    qc_i = torch.cat([qc, torch.zeros_like(qc[:1])], dim=0)
    heat_i = torch.cat([heatrt, torch.zeros_like(heatrt[:1])], dim=0)
    patmf_x = torch.cat([patmf, patmf[-1:]], dim=0)
    radterm = torch.where(
        top_mask & (qc_i > c.minqq) & (karr >= 1),
        heat_i * (patmf_x[1:kzp1 + 1] - patmf_x[:kzp1]) * rrhoxfl
        * rexnerfl / uthv_i, 0.0)
    buoyan = buoyan - radterm

    tke_sfc = torch.clamp(tkefac * ustxsq, min=UWTKEMIN)
    # rows: interfaces 1..kz-1 (kz-1 unknowns)
    n = kz - 1
    row = torch.arange(n, device=t.device)[:, None, None]
    a_t = torch.where(row > 0, -(rhoxhl[:n] * rrhoxfl[1:kz]) * kethl[:n]
                      * dt * rdzq[:n] * rdza[1:kz], 0.0)
    c_t = torch.where(row < n - 1, -(rhoxhl[1:kz] * rrhoxfl[1:kz])
                      * kethl[1:kz] * dt * rdzq[1:kz] * rdza[1:kz], 0.0)
    tbbls = torch.maximum(bbls[1:kz], bbls[2:kzp1])
    diss_mid = torch.where(tbbls > 0.0,
                           dt * torch.sqrt(tke[1:kz]) * rczero
                           / torch.clamp(tbbls, min=1e-10), 0.0)
    sfc_coup = (rhoxhl[kz - 1] * rrhoxfl[kz - 1]) * kethl[kz - 1] \
        * rdzq[kz - 1] * rdza[kz - 1]
    diss_bot = torch.where(
        bbls[kz - 1] > 0.0,
        dt * (torch.sqrt(tke[kz - 1]) * rczero
              / torch.clamp(bbls[kz - 1], min=1e-10) + sfc_coup),
        dt * sfc_coup)
    b_t = 1.0 - a_t - c_t + torch.where(row == n - 1, diss_bot[None],
                                        diss_mid)
    r_t = tke[1:kz] + dt * (shear[1:kz] + buoyan[1:kz])
    r_t = _set_row(r_t, n - 1, r_t[n - 1] + dt * tke_sfc * sfc_coup)
    (tke_sol,) = _tridiag(a_t, b_t, c_t, [r_t])
    tke_new = torch.cat([torch.zeros_like(tke[:1]),
                         torch.clamp(tke_sol, min=UWTKEMIN),
                         tke_sfc[None]], dim=0)

    # ---- tendencies (:675-712) ----------------------------------------
    rdt = 1.0 / dt
    return UWOut(
        uten=(u_new - u) * rdt,
        vten=(v_new - v) * rdt,
        tten=(thx_new - thx) * exnerhl * rdt,
        qvten=(qv_new - qv) * rdt,
        qcten=(qc_new - qc) * rdt,
        qiten=(qi_new - qi) * rdt,
        tketen=(tke_new - tke0) * rdt,
        kth=kth, kzm=kzm, kpbl=kmix, zpbl=zpbl)
