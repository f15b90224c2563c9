"""GFS (Hong-Pan ``moninq``) PBL scheme (ibltyp=3), torch twin of
``regcm_tpu/physics/pbl/gfs.py`` (``Main/pbllib/mod_pbl_gfs.F90``
:279-903).

As in the JAX package, the reference's effective behaviour: line :571
``if ( kpbl(i) >= 1 ) pblflg(i) = .false.`` always clears ``pblflg``
(1-based ``kpbl`` is never below 1), so the nonlocal K, the
counter-gradient terms and the inverse-Prandtl block never run and
``kpbl`` is reset to 1: a local Louis-type K on every interface plus
the stratocumulus cloud-top radiatively driven K, solved implicitly.
The first guess ``kpblx``/``hpblx`` still feeds the stable Prandtl
number and the diagnosed PBL height.

Columns (ncol, kz) bottom-up, moninq's own orientation; the level
searches are masked reductions, the Thomas solves loops over levels on
(ncol,) planes, and the cloud-deck depth a sum in level order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...dynamics.hydrostatic import level_sum
from ...utils import constants as c

GOCP = c.egrav * c.rcpd
RLAM = 30.0
VK = c.vonkar
PRMAX = 4.0
DW2MIN = 0.0001
DKMIN, DKMAX = 0.0, 1000.0
RIMIN = -100.0
RBCR = 0.25
QMIN = 1.0e-8
XKZM = 1.0
TDZMIN = 1.0e-3
QLMIN = 1.0e-12
H1 = 1.0 / 3.0
CLDTIME = 500.0
XKZMU = 3.0
XKZMINV = 0.3
RLAMUN = 150.0
RENTF1, RENTF2 = 0.2, 1.0
RADFAC = 0.85
ZSTBLMAX = 2500.0
QLCR = 3.5e-5
ACTEI = 0.7


class GFSOut(NamedTuple):
    du: torch.Tensor      # (ncol, kz) bottom-up u tendency (m/s^2)
    dv: torch.Tensor
    tau: torch.Tensor     # T tendency (K/s)
    rtgq: torch.Tensor    # qv (specific humidity) tendency (1/s)
    rtgc: torch.Tensor    # cloud water tendency
    hpbl: torch.Tensor    # PBL height (m)
    kpbl: torch.Tensor    # PBL top level (bottom-up index)


def _tridiag(cl, cm, cu, rhs_list):
    """Batched Thomas solve (tridi2/tridin, :905-1010) down and up the
    levels; cl/cm/cu are (ncol, n), cl[:, 0] and cu[:, n-1] unused."""
    n = cm.shape[1]
    rhs = torch.stack(rhs_list, dim=0)              # (nr, ncol, n)
    fk = 1.0 / cm[:, 0]
    au = [fk * cu[:, 0]]
    a = [fk[None] * rhs[:, :, 0]]
    for k in range(1, n):
        fk = 1.0 / (cm[:, k] - cl[:, k] * au[-1])
        au.append(fk * cu[:, k])
        a.append(fk[None] * (rhs[:, :, k] - cl[None, :, k] * a[-1]))
    sol = [a[n - 1]]
    for k in range(n - 2, -1, -1):
        sol.append(a[k] - au[k][None] * sol[-1])
    full = torch.stack(sol[::-1], dim=2)            # (nr, ncol, n)
    return [full[r] for r in range(len(rhs_list))]


def _contig_below(mask, cond):
    """Where ``mask`` holds and ``cond`` holds on every masked level from
    here up to the top of the mask: a run from the top of the masked
    range downward (the reference's backward level loops with exit)."""
    run = torch.where(mask, cond, torch.ones_like(cond)).to(torch.int64)
    return mask & (torch.flip(torch.cumprod(torch.flip(run, [1]), dim=1),
                              [1]) > 0)


def moninq(u1, v1, t1, q1, ql1, prsl, prsi, del_, prslk, psk, phil,
           phii, thraten, heat, evap, stress, rbsoil, spd1, dt
           ) -> GFSOut:
    """Hong-Pan PBL on (ncol, kz) bottom-up columns.

    u1/v1/t1 winds and T; q1 water vapour and ql1 cloud water (specific
    humidity); prsl/prsi mid/interface p (cb); del_ layer thickness (cb);
    prslk Exner; psk surface Exner; phil/phii geopotentials (m²/s²);
    thraten radiative theta tendency (K/s); heat/evap kinematic surface
    fluxes (K·m/s, m/s·kg/kg); stress = ustar²; rbsoil surface bulk
    Richardson; spd1 lowest-level wind speed."""
    ncol, km = t1.shape
    km1 = km - 1
    kmpbl = km // 2
    dev = t1.device
    ii = torch.arange(km, device=dev)[None, :]
    kidx = ii[:, :km1]
    rdt = 1.0 / dt
    take = lambda a, k: torch.gather(a, 1, k[:, None])[:, 0]

    def first(mask, default):
        """First level where ``mask`` holds, else ``default``."""
        return torch.where(mask.any(dim=1),
                           torch.argmax(mask.to(torch.int32), dim=1),
                           default)

    zi = phii * c.regrav                      # (ncol, km+1)
    zl = phil * c.regrav
    rdzt = 1.0 / (zl[:, 1:] - zl[:, :-1])     # (ncol, km1)

    # background diffusivities (:369-389)
    tem1 = 1.0 - prsi[:, 1:km] / prsi[:, :1]
    tem1 = torch.clamp(tem1 * tem1 * 10.0, max=25.0)
    xkzo = XKZM * torch.clamp(torch.exp(-tem1), max=1.0)
    ptem = prsi[:, 1:km] / prsi[:, :1]
    # the reference's anchor ptem1 (prsi at the last level with ptem ≥
    # 0.2) approximated by 0.2·psfc, as in the JAX package
    tem1m = 1.0 - prsi[:, 1:km] / (0.2 * prsi[:, :1])
    tem1m = torch.clamp(tem1m * tem1m * 5.0, max=25.0)
    xkzmo = torch.where(ptem >= 0.2, XKZMU,
                        XKZMU * torch.clamp(torch.exp(-tem1m), max=1.0))
    # inversion-layer cap (:391-400)
    dtdz = (t1[:, 1:] - t1[:, :-1]) * rdzt
    inv = (zi[:, 1:km] > 250.0) & (dtdz > 1.0e-5) & (kidx < kmpbl)
    xkzo = torch.where(inv, torch.clamp(xkzo, max=XKZMINV), xkzo)

    # thermodynamic fields (:425-437)
    theta = t1 * psk[:, None] / prslk
    qlx = torch.clamp(ql1, min=QLMIN)
    qv = torch.clamp(q1, min=QMIN)
    qtx = qv + qlx
    thetae = theta * (1.0 + c.wlhv * qv / (c.cpd * t1))
    thvx = theta * (1.0 + c.ep1 * qv - qlx)
    thlvx = (theta - (c.wlhv / c.cpd) * qlx) * (1.0 + c.ep1 * qtx)

    radx = (zi[:, 1:km] - zi[:, :km1]) * thraten[:, :km1]
    lcld = first(zl[:, :km1] >= ZSTBLMAX, km1 - 1)    # (:453-460)

    bf = (thvx[:, 1:] - thvx[:, :-1]) * rdzt
    govrth = c.egrav / theta[:, 0]
    beta = dt / (zi[:, 1] - zi[:, 0])
    thermal = thvx[:, 0]

    # first-guess PBL height from the bulk Richardson number (:478-507)
    spdk2 = torch.clamp(u1 ** 2 + v1 ** 2, min=1.0)
    rb = (thvx - thermal[:, None]) * (c.egrav * zl / thvx[:, :1]) / spdk2
    scanr = (ii >= 1) & (ii <= kmpbl - 1)
    kpblx = first(scanr & (rb > RBCR), kmpbl - 1)
    rbup = take(rb, kpblx)
    rbdn = torch.where(kpblx >= 2, take(rb, torch.clamp(kpblx - 1, min=1)),
                       rbsoil)
    rbint = torch.where(rbdn >= RBCR, 0.0,
                        torch.where(rbup <= RBCR, 1.0,
                                    (RBCR - rbdn)
                                    / torch.clamp(rbup - rbdn, min=1e-12)))
    km_ = torch.clamp(kpblx - 1, min=0)
    hpblx = take(zl, km_) + rbint * (take(zl, kpblx) - take(zl, km_))
    kpblx = torch.clamp(torch.where(hpblx < take(zi, kpblx),
                                    kpblx - 1, kpblx), min=0)

    # stratocumulus detection (:575-673)
    inrange = (kidx <= lcld[:, None]) & (kidx < kmpbl)
    iscld = qlx[:, :km1] >= QLCR
    kcld = torch.amax(torch.where(inrange & iscld, kidx, -1), dim=1)
    scuflg = kcld >= 0
    kcld = torch.clamp(kcld, min=0)
    # krad: the least radx in the cloud deck running down from kcld
    # (:594-607)
    contig = _contig_below(kidx <= kcld[:, None], iscld)
    radm = torch.where(contig, radx, 1e30)
    krad = torch.argmin(radm, dim=1)
    radmin = torch.amin(radm, dim=1)
    scuflg = scuflg & (krad >= 1) & (radmin < 0.0)
    # icld: the cloudy layers at and below krad, k ≥ 2 (:615-628)
    contig_r = _contig_below((kidx <= krad[:, None]) & (kidx >= 1), iscld)
    icld = contig_r.sum(dim=1)
    scuflg = scuflg & (icld >= 1)
    hrad = take(zi, krad + 1)
    scuflg = scuflg & (hrad >= zi[:, 1])
    temk = take(zi, krad + 1) - take(zi, krad)
    thlvx1 = take(thlvx, krad) + CLDTIME * radmin / temk
    contig_d = _contig_below(kidx <= krad[:, None],
                             thlvx1[:, None] <= thlvx[:, :km1])
    dzi = torch.where(contig_d, zi[:, 1:km] - zi[:, :km1], 0.0)
    zd = level_sum(dzi.T)
    kk = torch.clamp(krad + 1 - icld, min=0)
    zdd = hrad - take(zi, kk)
    zd = torch.minimum(torch.maximum(zd, zdd), hrad)
    vrad = (govrth * zd * torch.clamp(-radmin, min=0.0)) ** H1

    # local K everywhere (:704-739; kpbl == 1 after the :571 reset)
    rdz = rdzt
    ti = 2.0 / (t1[:, :-1] + t1[:, 1:])
    dw2 = (u1[:, :-1] - u1[:, 1:]) ** 2 + (v1[:, :-1] - v1[:, 1:]) ** 2
    shr2 = torch.clamp(dw2, min=DW2MIN) * rdz * rdz
    bvf2 = c.egrav * bf * ti
    ri = torch.clamp(bvf2 / shr2, min=RIMIN)
    zk = VK * zi[:, 1:km]
    rl2u = zk * RLAMUN / (RLAMUN + zk)
    dk_u = rl2u * rl2u * torch.sqrt(shr2)
    sri = torch.sqrt(torch.clamp(-ri, min=0.0))
    dku_un = xkzmo + dk_u * (1.0 + 8.0 * (-ri) / (1.0 + 1.746 * sri))
    dkt_un = xkzo + dk_u * (1.0 + 8.0 * (-ri) / (1.0 + 1.286 * sri))
    rl2s = zk * RLAM / (RLAM + zk)
    dk_s = rl2s * rl2s * torch.sqrt(shr2)
    tem1s = dk_s / (1.0 + 5.0 * ri) ** 2
    prnum = torch.where(kidx >= kpblx[:, None],
                        torch.clamp(1.0 + 2.1 * ri, max=PRMAX), 1.0)
    dku = torch.where(ri < 0.0, dku_un, xkzmo + tem1s * prnum)
    dkt = torch.where(ri < 0.0, dkt_un, xkzo + tem1s)
    dku = torch.clamp(dku, DKMIN, DKMAX)
    dkt = torch.clamp(dkt, DKMIN, DKMAX)

    # cloud-top driven diffusion (:743-790)
    kradp = torch.clamp(krad + 1, max=km - 1)
    te = take(thetae, krad) - take(thetae, kradp)
    tq = take(qtx, krad) - take(qtx, kradp)
    cteit = torch.where((te > 0.0) & (tq > 0.0),
                        c.cpd * te / (c.wlhv * torch.clamp(tq, min=1e-12)),
                        0.0)
    rent = torch.where(cteit > ACTEI, RENTF2,
                       torch.full_like(cteit, RENTF1))
    bfk = torch.clamp(take(bf, torch.clamp(krad, max=km1 - 1)), min=TDZMIN)
    ckt_rad = -rent * radmin / bfk
    tem1z = hrad - zd
    tem2 = zi[:, 1:km] - tem1z[:, None]
    ptem_c = torch.clamp(tem2 / torch.clamp(zd[:, None], min=1e-10),
                         max=1.0)
    ptem_c = tem2 * ptem_c * torch.sqrt(torch.clamp(1.0 - ptem_c, min=0.0))
    ckt_prof = torch.clamp(RADFAC * VK * vrad[:, None] * ptem_c,
                           DKMIN, DKMAX)
    below_rad = kidx < krad[:, None]
    ckt = torch.where(below_rad & (tem2 > 0.0), ckt_prof, 0.0)
    atrad = kidx == krad[:, None]
    ckt = torch.where(atrad, ckt_rad[:, None], ckt)
    cku = torch.where(atrad, ckt, 0.75 * ckt)
    scu2 = scuflg[:, None] & (kidx < kmpbl)
    dkt = torch.clamp(torch.where(scu2, dkt + ckt, dkt), max=DKMAX)
    dku = torch.clamp(torch.where(scu2, dku + cku, dku), max=DKMAX)

    # heat and moisture implicit solve (:792-863; the counter-gradient
    # terms never run after the :571 reset)
    dtodsd = dt / del_[:, :km1]
    dtodsu = dt / del_[:, 1:]
    dsig = prsl[:, :km1] - prsl[:, 1:]
    tem1d = dsig * dkt * rdz
    dsdzt = tem1d * GOCP
    dsdz2 = tem1d * rdz
    au = -dtodsd * dsdz2
    al = -dtodsu * dsdz2
    one = torch.ones((ncol, 1), dtype=t1.dtype, device=dev)
    zero = torch.zeros((ncol, 1), dtype=t1.dtype, device=dev)
    ad = torch.cat([one, 1.0 - al], dim=1)
    ad = torch.cat([ad[:, :km1] - au, ad[:, km1:]], dim=1)
    a1 = torch.cat([t1[:, :1] + (beta * heat)[:, None], t1[:, 1:]], dim=1)
    a1 = torch.cat([a1[:, :km1] + dtodsd * dsdzt, a1[:, km1:]], dim=1)
    a1 = torch.cat([a1[:, :1], a1[:, 1:] - dtodsu * dsdzt], dim=1)
    a2 = torch.cat([q1[:, :1] + (beta * evap)[:, None], q1[:, 1:]], dim=1)
    cl = torch.cat([zero, al], dim=1)
    cu_ = torch.cat([au, zero], dim=1)
    t_new, q_new, qc_new = _tridiag(cl, ad, cu_, [a1, a2, ql1])
    tau = (t_new - t1) * rdt
    rtgq = (q_new - q1) * rdt
    rtgc = (qc_new - ql1) * rdt

    # momentum implicit solve (:864-897)
    dsdz2m = dsig * dku * rdz * rdz
    aum = -dtodsd * dsdz2m
    alm = -dtodsu * dsdz2m
    adm = torch.cat([(1.0 + beta * stress / torch.clamp(spd1, min=0.1))
                     [:, None], 1.0 - alm], dim=1)
    adm = torch.cat([adm[:, :km1] - aum, adm[:, km1:]], dim=1)
    clm = torch.cat([zero, alm], dim=1)
    cum = torch.cat([aum, zero], dim=1)
    u_new, v_new = _tridiag(clm, adm, cum, [u1, v1])
    du = (u_new - u1) * rdt
    dv = (v_new - v1) * rdt

    return GFSOut(du=du, dv=dv, tau=tau, rtgq=rtgq, rtgc=rtgc,
                  hpbl=hpblx, kpbl=kpblx)
