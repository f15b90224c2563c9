"""Tiedtke mass-flux cumulus convection (icup=5, the "new Tiedtke"
variant), torch twin of ``regcm_tpu/physics/cumulus/tiedtke.py``
(``Main/cumlib/mod_cu_tiedtke.F90``: ``ntiedtke`` :4508-5520 with
initcum :5524, cloudbase :7056, ascent :5818, entrainm :6221, mcbase
:6255, lfs :6291, ddrafdsc :6389, dtdqc :6521, dudvx :6694, cfluxes
:6840, moistadj :5657, solver :5611).

Columns are (np, nk) tensors, top-down; each level recursion is a
Python loop over the levels whose every iteration updates whole (np,)
planes, with every conditional a ``torch.where``. Feature flags
(&tiedtkeparam): ``lmfmid`` (midlevel convection, ktype=3; needs
``omega``) and ``lmfsmooth`` (the smoothing of the tracer-transport mass
fluxes at the draughts' edges). ``ntiedtke`` returns the CFL-rescaled
draught fluxes that the convective tracer transport (``ctracer``, run by
the suite's chemistry hook) reads. As in the JAX package, the 350/60/950
hPa marker levels
(and the cmcptop midlevel ceiling) come from the standard-atmosphere
sigma profile, llconscheck is omitted and lmfwstar is off.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...dynamics.hydrostatic import level_sum
from ...utils import constants as c

# mod_constants.F90:218-222
RTBER = c.tzero - 5.0
RTICE = c.tzero - 23.0
RTWAT = c.tzero
RTWAT_RTICE_R = 1.0 / (RTWAT - RTICE)
# mod_cu_tiedtke.F90:51-107 fixed parameters
RKAP = 0.4
QSMAX = 0.5
CWDRAG = (3.0 / 8.0) * 0.506 / 0.200
RMFSOLUV = 1.0
RMFSOLTQ = 1.0
RMFLIC = 1.0
RMFLIA = 0.0
RTAUMEL = 5.0 * 3600.0 * 1.5
RDEPTHS = 2.0e4
RMFDEPS = 0.3
CMFCMAX = 1.0
CMFCMIN = 1.0e-10
# mod_params.F90:427-458 defaults
ENTRPEN_LND = 1.75e-3
ENTRPEN_OCN = 1.75e-3
DETRPEN = 0.75e-4
ENTSHALP = 2.0
ENTRDD = 3.0e-4
RPRC = 1.4e-3
RHEBC = 0.8
RCUC = 0.05
RCPEC = 5.55e-5


def xalpha(t):
    return torch.clamp(((torch.clamp(t, RTICE, RTWAT) - RTICE)
                        * RTWAT_RTICE_R) ** 2, max=1.0)


def fesat(t):
    a = xalpha(t)
    return c.c2es * (a * torch.exp(c.c3les * (t - c.tzero)
                                   / (t - c.c4les))
                     + (1.0 - a) * torch.exp(c.c3ies * (t - c.tzero)
                                             / (t - c.c4ies)))


def fdqsat(t):
    a = xalpha(t)
    return (a * c.c5alvcp / (t - c.c4les) ** 2
            + (1.0 - a) * c.c5alscp / (t - c.c4ies) ** 2)


def mlwocp(t):
    a = xalpha(t)
    return a * c.wlhvocp + (1.0 - a) * c.wlhsocp


def mlw(t):
    a = xalpha(t)
    return a * c.wlhv + (1.0 - a) * c.wlhs


def _moistadj(sp, t, q, flag, mode):
    """Saturation adjustment (moistadj, :5657-5807). sp (np,) Pa;
    t/q (np,) at one level; flag the active mask; mode the jcall
    semantics: 1 = condense only (cond>0 gate, mixed-phase explicit
    es), 2 = evaporate only (cond<0, wet-bulb), else unconditional."""
    rp = 1.0 / sp

    def qsat(tv):
        qs = torch.clamp(fesat(tv) * rp, max=QSMAX)
        cor = 1.0 / (1.0 - c.ep1 * qs)
        return qs * cor, cor

    if mode == 1:
        def cond_of(tv, qv):
            zl = 1.0 / (tv - c.c4les)
            zi = 1.0 / (tv - c.c4ies)
            a = xalpha(tv)
            qs = c.c2es * (a * torch.exp(c.c3les * (tv - c.tzero) * zl)
                           + (1.0 - a) * torch.exp(c.c3ies * (tv - c.tzero)
                                                   * zi)) * rp
            qs = torch.clamp(qs, max=QSMAX)
            cor = 1.0 - c.ep1 * qs
            zf = a * c.c5alvcp * zl ** 2 + (1.0 - a) * c.c5alscp * zi ** 2
            return (qv * cor ** 2 - qs * cor) / (cor ** 2 + qs * zf)
        cond = cond_of(t, q)
        cond = torch.where(flag & (cond > 0.0), cond, 0.0)
        t1 = t + mlwocp(t) * cond
        q1 = q - cond
        cond1 = cond_of(t1, q1)
        cond1 = torch.where(flag & (torch.abs(cond) > 1e-30), cond1, 0.0)
        return t1 + mlwocp(t1) * cond1, q1 - cond1

    qs, cor = qsat(t)
    cond = (q - qs) / (1.0 + qs * cor * fdqsat(t))
    if mode == 2:
        cond = torch.clamp(cond, max=0.0)
    cond = torch.where(flag, cond, 0.0)
    t1 = t + mlwocp(t) * cond
    q1 = q - cond
    qs, cor = qsat(t1)
    cond1 = (q1 - qs) / (1.0 + qs * cor * fdqsat(t1))
    if mode == 2:
        cond1 = torch.where(torch.abs(cond) < 1e-30,
                            torch.clamp(cond1, max=0.0), cond1)
    cond1 = torch.where(flag, cond1, 0.0)
    return t1 + mlwocp(t1) * cond1, q1 - cond1


class TiedtkeOut(NamedTuple):
    tten: torch.Tensor      # K/s
    qten: torch.Tensor      # kg/kg/s (specific humidity basis)
    lten: torch.Tensor      # detrained liquid (kg/kg/s)
    iten: torch.Tensor      # detrained ice
    uten: torch.Tensor
    vten: torch.Tensor
    prate: torch.Tensor     # surface rain+snow (kg/m²/s)
    qdetr: torch.Tensor     # detrained water per step (kg/kg)
    raincc: torch.Tensor    # rain flux profile (m/s)
    cldfra: torch.Tensor    # Xu-Krueger cloud fraction
    ktype: torch.Tensor
    kctop: torch.Tensor
    kcbot: torch.Tensor
    # tracer-transport interface (section 11, :5344-5380): CFL-rescaled
    # draught fluxes and detrainment rates for ctracer
    ct_mfu: torch.Tensor
    ct_mfd: torch.Tensor
    ct_udrate: torch.Tensor
    ct_ddrate: torch.Tensor
    ct_ldcum: torch.Tensor
    ct_lddraf: torch.Tensor
    idtop: torch.Tensor


def _at(a, idx):
    """a[i, idx[i]] for each row i, with the JAX package's index rules
    (a negative index counts from the end, an index past the end is
    clamped to it)."""
    n = a.shape[1]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return a.gather(1, idx[:, None].long())[:, 0]


def _put(a, k, mask, v):
    """a[:, k] = where(mask, v, a[:, k]), in place."""
    a[:, k] = torch.where(mask, v, a[:, k])


def _colsum(a):
    """Σ over the levels (dim 1) in level order (``level_sum``)."""
    return level_sum(a.T)


def _full(npx, v, like, dtype=torch.int64):
    return torch.full((npx,), v, dtype=dtype, device=like.device)


def cloudbase_search(t, q, tf, qf, qs, pf, geof, ahfs, qhfl,
                     entrpen, kt1, kt2, pnorm):
    """Departure-level cloud-base search — the reference's `cloudbase`
    (mod_cu_tiedtke.F90:7043-7493).

    The surface departure level (kk = nk-1) may only yield SHALLOW
    convection (:7391-7394) and the search always continues upward; the
    first ELEVATED departure level whose cloud reaches rdepths wins and
    overrides any prior shallow accept, resetting the profile outside
    its span (:7449-7486). The departure levels are an outer loop whose
    body runs one inner ascent loop over the levels above.

    Inputs are top-down (np, nk) columns: tf/qf the half-level
    static-energy-max temperature / humidity from initcum, qs the
    full-level saturation humidity, pf (np, nk+1) interface Pa, geof
    interface geopotential, ahfs/qhfl turbulent heat/moisture flux
    (surface slot nk), kt1/kt2 the 350/60 hPa marker levels, pnorm the
    normalized static pressure profile (for the 60 hPa mixed-layer
    gate). Returns (ldcum, kcbot, ictop0, idpl, wubase, tu, qu, lu,
    ilab)."""
    npx, nk = t.shape
    dev = t.device
    tu = tf
    qu = qf
    lu = torch.zeros_like(t)
    ilab = torch.zeros((npx, nk), dtype=torch.int64, device=dev)
    karr = torch.arange(nk, device=dev)[None, :]
    xsenh = c.cpd * tf + geof[:, :nk]
    # ascent scratch state persists ACROSS departure levels (:7106)
    xtu = tf.clone()
    xqu = qf.clone()
    xlu = torch.zeros_like(t)
    suh = torch.zeros_like(t)
    wu2h = torch.zeros_like(t)
    buoh = torch.zeros_like(t)
    iilab = torch.zeros((npx, nk), dtype=torch.int64, device=dev)
    z1 = torch.zeros_like(t[:, 0])

    def ascent(st, kk, surface):
        """The test-parcel ascent (:7241-7372) from departure level
        ``kk`` over levels nk-2 .. kt2; `surface` selects the
        1/z-entrainment shallow variant."""
        icbot, ll_ldbase, ictop, lldcum, go = st
        for k in range(nk - 2, kt2 - 1, -1):
            act = go & (k <= kk - 1)
            dz = (geof[:, k] - geof[:, k + 1]) * c.regrav
            qfm = 0.5 * (qf[:, k + 1] + qf[:, k])
            sfm = 0.5 * (xsenh[:, k + 1] + xsenh[:, k])
            if surface:
                eps = 0.55 / torch.clamp(
                    (geof[:, k] - geof[:, nk]) * c.regrav, min=1.0) + 1.0e-4
                zmix = 0.5 * dz * eps
                xtmp = 1.0 / (1.0 + zmix)
                quk = (xqu[:, k + 1] * (1.0 - zmix)
                       + 2.0 * zmix * qfm) * xtmp
                shk = (suh[:, k + 1] * (1.0 - zmix)
                       + 2.0 * zmix * sfm) * xtmp
            else:
                zmix = 0.4 * entrpen * dz * torch.clamp(
                    (qs[:, k] / qs[:, nk - 1]) ** 3, max=1.0)
                quk = xqu[:, k + 1] * (1.0 - zmix) + qfm * zmix
                shk = suh[:, k + 1] * (1.0 - zmix) + sfm * zmix
            qold = quk
            tk = (shk - geof[:, k]) * c.rcpd
            tk, quk = _moistadj(pf[:, k], tk, quk, act, 1)
            dq = torch.clamp(qold - quk, min=0.0)
            luk = xlu[:, k + 1] + dq
            xlglac = dq * (xalpha(xtu[:, k + 1]) - xalpha(tk))
            if surface:
                luk = torch.clamp(luk, max=5.0e-3)
            else:
                luk = 0.5 * luk
            shk = c.cpd * (tk + c.wlhfocp * xlglac) + geof[:, k]
            tvuh = (1.0 + c.ep1 * quk - luk) * tk + c.wlhfocp * xlglac
            tvenh = (1.0 + c.ep1 * qf[:, k]) \
                * (xsenh[:, k] - geof[:, k]) * c.rcpd
            bk = (tvuh - tvenh) * c.egrav / tvenh
            buof = 0.5 * (bk + buoh[:, k + 1])
            xtmp = 1.0 / (1.0 + 2.0 * zmix)
            w2k = (wu2h[:, k + 1] * (1.0 - 2.0 * zmix)
                   + 2.0 * buof * dz) * xtmp
            # exact cloud base (:7324-7360): back out the LCL pressure
            # from dq/(dqsdt·dtdp) at the level below and choose the
            # nearest model level
            first_liq = act & (luk > 0.0) & (iilab[:, k + 1] == 1)
            tik = xtu[:, k + 1]
            qik = xqu[:, k + 1]
            es = fesat(tik) / pf[:, k + 1]
            qsu0 = torch.clamp(es, max=QSMAX)
            qsu = qsu0 / (1.0 - c.ep1 * qsu0)
            dq2 = torch.clamp(qik - qsu, max=0.0)
            a2 = xalpha(tik)
            fac = a2 * c.c5les / (tik - c.c4les) ** 2 \
                + (1.0 - a2) * c.c5ies / (tik - c.c4ies) ** 2
            dqsdt = fac * qsu / (1.0 - c.ep1 * es)
            dtdp = c.rgas * tik / (c.cpd * pf[:, k + 1])
            cbase = pf[:, k + 1] + dq2 / torch.clamp(dqsdt * dtdp,
                                                     min=1e-10)
            pdifftop = cbase - pf[:, k]
            pdiffbot = pf[:, k + 1] - cbase
            base_up = first_liq & (pdifftop > pdiffbot) \
                & (wu2h[:, k + 1] > 0.0)
            base_here = first_liq & (pdifftop <= pdiffbot) & (w2k > 0.0)
            kb1 = min(nk - 2, k + 1)
            newb = (base_up | base_here) & ~ll_ldbase
            icbot = torch.where(newb & base_up, kb1, icbot)
            icbot = torch.where(newb & base_here & ~base_up, k, icbot)
            ll_ldbase = ll_ldbase | newb
            # store while active (go at loop entry)
            _put(xtu, k, act, tk)
            _put(xqu, k, act, quk)
            _put(xlu, k, act, luk)
            xlu[:, k + 1] = torch.where(base_up, c.minqq, xlu[:, k + 1])
            _put(suh, k, act, shk)
            _put(buoh, k, act, bk)
            _put(wu2h, k, act, w2k)
            # label semantics (:7340-7372): the exact-base block sets
            # iilab(k)=2 in BOTH branches; on termination (w2k<0) the
            # label is left as it is
            lab_base = torch.where(base_up | base_here, 2, iilab[:, k])
            lab_k = torch.where(
                act,
                torch.where(w2k < 0.0, lab_base,
                            torch.where((luk > 0.0) | base_here | base_up,
                                        2, 1)),
                iilab[:, k])
            iilab[:, k] = lab_k
            iilab[:, kb1] = torch.where(base_up, 2, iilab[:, kb1])
            # termination: kinetic energy negative (:7364-7372)
            stopd = act & (w2k < 0.0)
            ictop = torch.where(stopd, k, ictop)
            lldcum = torch.where(stopd, xlu[:, k + 1] > 0.0, lldcum)
            go = go & ~stopd
        return icbot, ll_ldbase, ictop, lldcum, go

    # ---- surface departure round (kk = nk-1) ------------------------
    kk = nk - 1
    fls = torch.zeros(npx, dtype=torch.bool, device=dev)
    go = ~fls
    rho_s = pf[:, nk] / (c.rgas * t[:, nk - 1]
                         * (1.0 + c.ep1 * q[:, nk - 1]))
    khvfl = (ahfs[:, nk] * c.rcpd
             + c.ep1 * t[:, nk - 1] * qhfl[:, nk]) / rho_s
    ws0 = 0.001 - 1.5 * RKAP * khvfl \
        * (geof[:, nk - 1] - geof[:, nk]) / t[:, nk - 1]
    go = go & (khvfl < 0.0)
    # reference exponent is the literal 0.3333, not 1/3 (:7165)
    ws = 1.2 * torch.clamp(ws0, min=1e-10) ** 0.3333
    texc = torch.clamp(-1.5 * ahfs[:, nk] / (rho_s * ws * c.cpd), min=0.0)
    qexc = torch.clamp(-1.5 * qhfl[:, nk] / (rho_s * ws), min=0.0)
    _put(xqu, kk, go, qf[:, kk] + qexc)
    _put(suh, kk, go, xsenh[:, kk] + c.cpd * texc)
    _put(xtu, kk, go, (xsenh[:, kk] - geof[:, kk]) * c.rcpd + texc)
    _put(xlu, kk, go, z1)
    _put(wu2h, kk, go, ws ** 2)
    iilab[:, kk] = torch.where(go, 1, iilab[:, kk])
    tvenh = (1.0 + c.ep1 * qf[:, kk]) \
        * (xsenh[:, kk] - geof[:, kk]) * c.rcpd
    tvuh = (1.0 + c.ep1 * xqu[:, kk]) * xtu[:, kk]
    _put(buoh, kk, go, (tvuh - tvenh) * c.egrav / tvenh)

    icbot, _, ictop, lldcum, _ = ascent(
        (_full(npx, kk, t), fls, _full(npx, nk - 2, t), fls, go), kk, True)

    depth = _at(pf, icbot) - _at(pf, ictop)
    # surface departure: shallow/Sc only (:7388-7394); the search
    # continues for every column
    lldcum = lldcum & ~(depth > RDEPTHS)
    ldcum = lldcum
    kcbot = torch.where(lldcum, icbot, -1)
    ictop0 = torch.where(lldcum, ictop, -1)
    idpl = torch.where(lldcum, nk - 1, nk - 2)
    wubase = torch.where(
        lldcum, torch.sqrt(torch.clamp(_at(wu2h, icbot), min=0.0)), 0.0)
    span = karr >= ictop[:, None]
    tu = torch.where(span, xtu, tu)
    qu = torch.where(span, xqu, qu)
    lu = torch.where(span, xlu, lu)
    ilab = torch.where(span, iilab, ilab)
    llgo_on = ~fls
    llfirst = ~fls
    lldeep = fls

    # ---- elevated departure rounds (outer loop over kk) -------------
    for kk in range(nk - 2, kt1 - 1, -1):
        go = llgo_on
        texc, qexc = 0.2, 1.0e-4
        quk = qf[:, kk] + qexc
        shk = xsenh[:, kk] + c.cpd * texc
        tuk = (xsenh[:, kk] - geof[:, kk]) * c.rcpd + texc
        # mixed layer for parcels in the lowest 60 hPa (level gate
        # from the static pnorm profile)
        if (c.stdp - pnorm[kk - 1]) < 60.0e2:
            w1 = z1
            qm = z1
            sm = z1
            for off in (1, 0, -1):            # k2 = kk+1, kk, kk-1
                k2 = kk + off
                w2 = pf[:, k2] - pf[:, k2 - 1]
                take = w1 < 50.0e2
                qm = qm + torch.where(take, qf[:, k2] * w2, 0.0)
                sm = sm + torch.where(take, xsenh[:, k2] * w2, 0.0)
                w1 = w1 + torch.where(take, w2, 0.0)
            quk = qm / torch.clamp(w1, min=1.0) + qexc
            shk = sm / torch.clamp(w1, min=1.0) + c.cpd * texc
            tuk = (shk - geof[:, kk]) * c.rcpd + texc  # :7218
        _put(xqu, kk, go, quk)
        _put(suh, kk, go, shk)
        _put(xtu, kk, go, tuk)
        _put(xlu, kk, go, z1)
        _put(wu2h, kk, go, torch.ones_like(z1))
        iilab[:, kk] = torch.where(go, 1, iilab[:, kk])
        tvenh = (1.0 + c.ep1 * qf[:, kk]) \
            * (xsenh[:, kk] - geof[:, kk]) * c.rcpd
        tvuh = (1.0 + c.ep1 * xqu[:, kk]) * xtu[:, kk]
        _put(buoh, kk, go, (tvuh - tvenh) * c.egrav / tvenh)

        icbot, _, ictop, lldcum, _ = ascent(
            (_full(npx, kk, t), fls, _full(npx, nk - 2, t), fls, go),
            kk, False)

        depth = _at(pf, icbot) - _at(pf, ictop)
        # first deep-depth elevated level wins (:7438-7486)
        accept = llgo_on & llfirst & (depth >= RDEPTHS)
        llfirst = llfirst & ~accept
        lldeep = lldeep | accept
        idpl = torch.where(accept, kk, idpl)
        ictop0 = torch.where(accept, ictop, ictop0)
        kcbot = torch.where(accept, icbot, kcbot)
        ldcum = torch.where(accept, lldcum, ldcum)
        wubase = torch.where(
            accept, torch.sqrt(torch.clamp(_at(wu2h, icbot), min=0.0)),
            wubase)
        acc2 = accept[:, None]
        span = (karr <= kk) & (karr >= ictop[:, None])
        env_lab = torch.where(karr < ictop[:, None], 0, 1)
        tu = torch.where(acc2, torch.where(span, xtu, tf), tu)
        qu = torch.where(acc2, torch.where(span, xqu, qf), qu)
        lu = torch.where(acc2, torch.where(span, xlu, 0.0), lu)
        ilab = torch.where(acc2, torch.where(span, iilab, env_lab), ilab)
        llgo_on = ~lldeep

    kcbot = torch.where(ldcum, torch.clamp(kcbot, min=0), nk - 2)
    ictop0 = torch.where(ldcum, torch.clamp(ictop0, min=0), nk - 2)
    return (ldcum, kcbot, ictop0, idpl, wubase, tu, qu, lu, ilab)


def ntiedtke(t, q, u, v, qctot, qhfl, ahfs, ph, pf, geo, geof,
             tenq_dyn, tent_dyn, ldland, dtcum, dx, pref,
             omega=None, lmfmid=True, lmfsmooth=False):
    """One Tiedtke call on (np, nk) columns (top-down ordering).

    t/q (K, specific humidity), ph/pf layer/interface Pa, geo/geof
    geopotential, omega (Pa/s), qhfl/ahfs turbulent moisture/heat flux
    (surface value in slot nk), tenq_dyn/tent_dyn the dynamic
    tendencies (for moisture-convergence closures). Returns the
    CUMULUS tendencies alone (not including the input dynamics), and the
    tracer-transport fluxes (``lmfsmooth`` smooths them only)."""
    npx, nk = t.shape
    dev = t.device
    dt = dtcum
    rdt = 1.0 / dt
    cons2 = (3.0 if dx >= 17747.5 else 5.0) / (c.egrav * dtcum)
    cons = 1.0 / (c.egrav * dtcum)
    rtau_s = min(3.0, 1.0 + 264.0 / max(dx / 1000.0, 1.0))

    # static marker levels from the normalized profile `pref`
    # (hsigma·stdp; the reference uses the instantaneous domain mean)
    pnorm = np.asarray(pref) / np.asarray(pref)[nk - 1] * c.stdp

    def _first_below(plev):
        m = pnorm > plev
        return int(np.argmax(m)) if m.any() else nk - 1

    nk350 = _first_below(350.0e2)
    nk060 = _first_below(60.0e2)
    nk950 = _first_below(950.0e2)
    nmctop0 = _first_below(300.0e2)   # cmcptop=300 hPa (:111, :331-342)
    if omega is None:
        lmfmid = False

    qs = torch.clamp(fesat(t) / ph, max=QSMAX)
    qs = qs / (1.0 - c.ep1 * qs)

    entrpen = torch.where(ldland, t.new_tensor(ENTRPEN_LND), ENTRPEN_OCN)

    # ---------------- initcum (:5524) ---------------------------------
    # per-level interpolation is independent; the downward
    # static-energy max cascade is a loop
    karr_i = torch.arange(1, nk, device=dev)[None, :]
    tf_mid = (torch.maximum(c.cpd * t[:, :-1] + geo[:, :-1],
                            c.cpd * t[:, 1:] + geo[:, 1:])
              - geof[:, 1:nk]) * c.rcpd
    tma, qma = _moistadj(pf[:, 1:nk], tf_mid, qs[:, :-1],
                         torch.ones_like(tf_mid, dtype=torch.bool), 3)
    qf_ma = torch.clamp(torch.minimum(q[:, :-1], qs[:, :-1])
                        + (qma - qs[:, :-1]), min=0.0)
    ma_span = (karr_i >= nk060) & (karr_i < nk - 2)
    tf = torch.cat([t[:, :1], torch.where(ma_span, tma, tf_mid)], dim=1)
    qf = torch.cat([q[:, :1], torch.where(ma_span, qf_ma, q[:, :-1])],
                   dim=1)
    tf[:, nk - 1] = (c.cpd * t[:, nk - 1] + geo[:, nk - 1]
                     - geof[:, nk - 1]) * c.rcpd
    qf[:, nk - 1] = q[:, nk - 1]
    for k in range(nk - 2, 0, -1):
        zs = torch.maximum(c.cpd * tf[:, k] + geof[:, k],
                           c.cpd * tf[:, k + 1] + geof[:, k + 1])
        tf[:, k] = (zs - geof[:, k]) * c.rcpd

    td = tf.clone()
    qd = qf.clone()
    uu = torch.cat([u[:, :1], u[:, :-1]], dim=1)
    vu = torch.cat([v[:, :1], v[:, :-1]], dim=1)
    ud = uu.clone()
    vd = vu.clone()

    # ---------------- cloudbase (:7056): departure-level search -------
    (ldcum, kcbot, ictop0, idpl, wubase, tu, qu, lu,
     ilab) = cloudbase_search(t, q, tf, qf, qs, pf, geof, ahfs,
                              qhfl, entrpen, nk350, nk060, pnorm)

    # ---------------- moisture convergence + cloud type ---------------
    karr = torch.arange(nk, device=dev)[None, :]
    dpk = pf[:, 1:] - pf[:, :-1]
    below_base = karr >= kcbot[:, None]
    dhpbl = _colsum(torch.where(below_base & ldcum[:, None],
                                  (c.wlhv * tenq_dyn
                                   + c.cpd * tent_dyn) * dpk, 0.0))
    depth = _at(pf, kcbot) - _at(pf, ictop0)
    ktype = torch.where(ldcum, torch.where(depth >= RDEPTHS, 1, 2), 0)

    # initial cloud-base mass flux
    mfmax_b = (_at(pf, kcbot) - _at(pf, kcbot - 1)) * cons2 * RMFLIC \
        + RMFLIA
    qumqe = _at(qu, kcbot) + _at(lu, kcbot) - _at(qf, kcbot)
    dqmin = torch.clamp(0.01 * _at(qf, kcbot), min=1.0e-10)
    dhb = c.cpd * (_at(tu, kcbot) - _at(tf, kcbot)) + c.wlhv * qumqe
    dhb = c.egrav * torch.maximum(dhb, 1.0e5 * dqmin)
    mfub_shal = torch.where(dhpbl > 0.0,
                            torch.minimum(dhpbl / dhb, mfmax_b),
                            mfmax_b * 0.1)
    ldcum = torch.where((ktype == 2) & (dhpbl <= 0.0), False, ldcum)
    mfub = torch.where(ktype == 1, mfmax_b * 0.1,
                       torch.where(ktype == 2, mfub_shal, 0.0))
    mfub = torch.where(ldcum, mfub, 0.0)

    # ---------------- ascent (:5818) ----------------------------------
    kctop = kcbot
    z2 = torch.zeros_like(t)
    lude = z2.clone()
    lglac = z2.clone()
    dmfup = z2.clone()
    xrain = z2.clone()
    mfude_rate = z2.clone()
    z1 = torch.zeros_like(t[:, 0])
    wmean = z1
    dpmean = z1
    zoentr = z1

    lu = torch.where(karr == kcbot[:, None], lu, 0.0)
    base2 = ldcum[:, None] & (karr == kcbot[:, None])
    mfu = torch.where(base2, mfub[:, None], 0.0)
    mfus = torch.where(base2, mfub[:, None]
                       * (c.cpd * tu + geof[:, :nk]), 0.0)
    mfuq = torch.where(base2, mfub[:, None] * qu, 0.0)
    mful = torch.where(base2, mfub[:, None] * lu, 0.0)
    kineu = torch.where(base2, 0.5 * wubase[:, None] ** 2, 0.0)
    tu = tu.clone()
    qu = qu.clone()
    ilab = ilab.clone()

    dnoprc = torch.where(ldland, t.new_tensor(5.0e-4), 3.0e-4)
    prcdgw = RPRC * c.regrav

    for k in range(nk - 2, 1, -1):
        if lmfmid:
            # midlevel cloud base (mcbase, :6255-6283): start a fresh
            # ktype=3 updraft where no convection exists yet
            mc = (~ldcum) & (ilab[:, k + 1] == 0) \
                & (geo[:, k] > 5000.0) & (geo[:, k] < 10000.0) \
                & (q[:, k] > 0.8 * qs[:, k])
            if not (k < nk - 2 and k > nmctop0):
                mc = mc & False
            mfub_mc = torch.clamp(-omega[:, k] * c.regrav, CMFCMIN,
                                  CMFCMAX)
            tu_mc = (c.cpd * t[:, k] + geo[:, k]
                     - geof[:, k + 1]) * c.rcpd
            _put(tu, k + 1, mc, tu_mc)
            _put(qu, k + 1, mc, q[:, k])
            _put(lu, k + 1, mc, z1)
            _put(mfu, k + 1, mc, mfub_mc)
            _put(mfus, k + 1, mc, mfub_mc * (c.cpd * tu_mc
                                             + geof[:, k + 1]))
            _put(mfuq, k + 1, mc, mfub_mc * q[:, k])
            _put(mful, k + 1, mc, z1)
            _put(dmfup, k + 1, mc, z1)
            _put(xrain, k + 1, mc, z1)
            kcbot = torch.where(mc, k, kcbot)
            ilab[:, k + 1] = torch.where(mc, 1, ilab[:, k + 1])
            ktype = torch.where(mc, 3, ktype)
            mfub = torch.where(mc, mfub_mc, mfub)
            # cap midlevel base mass flux (:5942-5952)
            cap = (ktype == 3) & (kcbot == k)
            mfmax_mc = (pf[:, k] - pf[:, k - 1]) * cons2 * RMFLIC + RMFLIA
            fac_mc = torch.where(cap & (mfub > mfmax_mc),
                                 mfmax_mc / torch.clamp(mfub, min=CMFCMIN),
                                 1.0)
            mfu[:, k + 1] = mfu[:, k + 1] * fac_mc
            mfus[:, k + 1] = mfus[:, k + 1] * fac_mc
            mfuq[:, k + 1] = mfuq[:, k + 1] * fac_mc
            mfub = torch.where(cap, torch.minimum(mfub, mfmax_mc), mfub)
        # midlevel first saturated step enters via ilab==1 (:5930-5931)
        mid1 = (ktype == 3) & (ilab[:, k + 1] == 1)
        active = (ldcum & (ilab[:, k + 1] == 2)) | mid1
        # entrainment/detrainment (entrainm + organized)
        below = k < kcbot
        mfterm = mfu[:, k + 1] * (geof[:, k] - geof[:, k + 1]) * c.regrav
        dmfen0 = torch.where(below, entrpen * mfterm, 0.0)
        dmfde0 = torch.where(below, DETRPEN * mfterm, 0.0)
        dmfde0 = torch.minimum(dmfde0, 0.75 * mfu[:, k + 1])
        atbase = kcbot == k
        zoentr = torch.where(
            atbase,
            torch.clamp(
                -entrpen * (torch.clamp(q[:, k] / qs[:, k], max=1.0)
                            - 1.0)
                * (geof[:, k] - geof[:, k + 1]) * c.regrav, max=0.4)
            * mfu[:, k + 1],
            zoentr)
        mfmax = (pf[:, k] - pf[:, k - 1]) * cons2 * RMFLIC + RMFLIA
        zxs = torch.clamp(mfu[:, k + 1] - mfmax, min=0.0)
        wmean = wmean + torch.where(active & below,
                                    kineu[:, k + 1]
                                    * (ph[:, k + 1] - ph[:, k]), 0.0)
        dpmean = dpmean + torch.where(active & below,
                                      ph[:, k + 1] - ph[:, k], 0.0)
        dmfen = torch.where(below, zoentr, dmfen0)
        shal = ktype >= 2
        dmfen = torch.where(below & shal, ENTSHALP * dmfen, dmfen)
        dmfde = torch.where(below & shal, dmfen, dmfde0)
        dmfde = torch.where(
            below, dmfde * (1.6 - torch.clamp(q[:, k] / qs[:, k],
                                              max=1.0)), dmfde)
        mftest = mfu[:, k + 1] + dmfen - dmfde
        change = torch.clamp(mftest - mfmax, min=0.0)
        zxe = torch.clamp(change - zxs, min=0.0)
        dmfen = torch.where(below, dmfen - zxe, dmfen)
        change = change - zxe
        dmfde = torch.where(below, dmfde + change, dmfde)

        mfk = mfu[:, k + 1] + dmfen - dmfde
        qeen = qf[:, k + 1] * dmfen
        seen = (c.cpd * tf[:, k + 1] + geof[:, k + 1]) * dmfen
        leen = torch.where(qctot[:, k] > c.minqq, qctot[:, k] * dmfen, 0.0)
        scde = (c.cpd * tu[:, k + 1] + geof[:, k + 1]) * dmfde
        qude = qu[:, k + 1] * dmfde
        lude_k = lu[:, k + 1] * dmfde
        mfusk = mfus[:, k + 1] + seen - scde
        mfuqk = mfuq[:, k + 1] + qeen - qude
        mfulk = mful[:, k + 1] + leen - lude_k
        rmf = 1.0 / torch.clamp(mfk, min=CMFCMIN)
        luk = mfulk * rmf
        quk = mfuqk * rmf
        tk = torch.clamp((mfusk * rmf - geof[:, k]) * c.rcpd, 100.0, 400.0)
        qold = quk
        xrk = xrain[:, k + 1] * (mfu[:, k + 1] - dmfde) * rmf
        luold = luk
        # moist adjustment
        tk, quk = _moistadj(pf[:, k], tk, quk, active, 1)
        condensed = active & (torch.abs(quk - qold) > 0.0)
        lgl = torch.where(condensed,
                          luk * (xalpha(tu[:, k + 1]) - xalpha(tk)), 0.0)
        tk = tk + c.wlhfocp * lgl
        luk = torch.where(condensed, luk + qold - quk, luk)
        bc = tk * (1.0 + c.ep1 * quk - lu[:, k + 1] - xrain[:, k + 1])
        be = tf[:, k] * (1.0 + c.ep1 * qf[:, k])
        buo_k = bc - be
        # midlevel first-step acceptance (:6052-6063)
        ok3 = mid1 & condensed & (buo_k > -0.5)
        bad3 = mid1 & condensed & (buo_k <= -0.5)
        ldcum = ldcum | ok3
        kctop = torch.where(ok3, k, kctop)
        buoc = (buo_k / (tf[:, k] * (1.0 + c.ep1 * qf[:, k])) + z1) * 0.5
        dkbuo = (geof[:, k] - geof[:, k + 1]) * (0.5 / 1.5) * buoc
        dken = torch.clamp((1.0 + CWDRAG)
                           * torch.where(dmfen > 0.0, dmfen, dmfde)
                           / torch.clamp(mfu[:, k + 1], min=CMFCMIN),
                           max=1.0)
        kin_k = (kineu[:, k + 1] * (1.0 - dken) + dkbuo) / (1.0 + dken)
        kin_k = torch.where(ok3, 0.5, kin_k)
        # negative buoyancy: enhanced detrainment (ilab==2 only)
        negb = condensed & (buo_k < 0.0) & ~mid1
        kedke = torch.clamp(kin_k / torch.clamp(kineu[:, k + 1],
                                                min=1.0e-10), 0.0, 1.0)
        mfun = torch.sqrt(kedke) * mfu[:, k + 1]
        dmfde = torch.where(negb, torch.maximum(dmfde,
                                                mfu[:, k + 1] - mfun),
                            dmfde)
        lude_k = torch.where(negb, lu[:, k + 1] * dmfde, lude_k)
        mfk = torch.where(negb, mfu[:, k + 1] + dmfen - dmfde, mfk)
        # failed midlevel first step: cancel the plume (:6059-6063)
        mfk = torch.where(bad3, 0.0, mfk)
        kin_k = torch.where(bad3, 0.0, kin_k)
        lude_k = torch.where(bad3, 0.0, lude_k)
        luk = torch.where(bad3, 0.0, luk)
        # organized entrainment for next level
        posb = condensed & (buo_k > -0.2) & ~mid1
        zoentr = torch.where(
            posb,
            torch.clamp(entrpen
                        * (0.3 - (torch.clamp(q[:, k - 1] / qs[:, k - 1],
                                              max=1.0) - 1.0))
                        * (geof[:, k - 1] - geof[:, k]) * c.regrav
                        * torch.clamp(qs[:, k] / _at(qs, kcbot),
                                      max=1.0) ** 3, max=0.4) * mfk,
            torch.where(condensed, 0.0, zoentr))
        alive = condensed & (kin_k > 0.0) & (mfk > 0.0)
        kctop = torch.where(alive, k, kctop)
        dead = condensed & ~alive & ~bad3   # bad3 cancels with lude=0
        dmfde = torch.where(dead, mfu[:, k + 1], dmfde)
        lude_k = torch.where(dead, lu[:, k + 1] * dmfde, lude_k)
        mfk = torch.where(dead, 0.0, mfk)
        kin_k = torch.where(dead, 0.0, kin_k)
        # shallow termination without condensation
        term2 = active & (ktype == 2) & ~condensed
        dmfde = torch.where(term2, mfu[:, k + 1], dmfde)
        lude_k = torch.where(term2, lu[:, k + 1] * dmfde, lude_k)
        mfk = torch.where(term2, 0.0, mfk)
        kin_k = torch.where(term2, 0.0, kin_k)
        lab_k = torch.where(alive, 2, 0)
        # precipitation by analytic integration of the l-equation
        hasprc = alive & (luk > dnoprc)
        zwu = torch.clamp(torch.sqrt(
            2.0 * torch.clamp(kineu[:, k + 1], min=0.1)), max=15.0)
        prcon = prcdgw / (0.75 * zwu)
        zdt = torch.clamp(torch.clamp(RTBER - tk, min=0.0),
                          max=RTBER - RTICE)
        cbf = 1.0 + 0.5 * torch.sqrt(zdt)
        zco = prcon * cbf
        lcrit = dnoprc / cbf
        zdfi = geof[:, k] - geof[:, k + 1]
        zc = luk - luold
        arg = (luk / lcrit) ** 2
        zd = torch.where(arg < 25.0,
                         zco * (1.0 - torch.exp(-torch.clamp(arg, max=25.0)))
                         * zdfi,
                         zco * zdfi)
        zint = torch.exp(-torch.clamp(zd, max=25.0))
        lnew = torch.minimum(torch.clamp(
            luold * zint + zc / torch.clamp(zd, min=1e-10) * (1.0 - zint),
            min=0.0), torch.clamp(luk, max=5.0e-3))
        precip = torch.where(hasprc,
                             torch.clamp(luold + zc - lnew, min=0.0), 0.0)
        dmfup_k = precip * mfk
        xrk = xrk + precip
        luk = torch.where(hasprc, lnew, luk)
        # rain evaporation/unloading in the updraught
        hasrain = alive & (xrk > 0.0)
        zvw = 21.18 * torch.clamp(xrk, min=1e-20) ** 0.2
        zvi = 0.5 * zvw
        alfaw = xalpha(tk)
        zvv = alfaw * zvw + (1.0 - alfaw) * zvi
        rold = xrk - precip
        zwu2 = torch.clamp(torch.sqrt(2.0 * torch.clamp(kin_k, min=0.1)),
                           max=15.0)
        zd2 = zvv / zwu2
        zint2 = torch.exp(-torch.clamp(zd2, max=25.0))
        rnew = torch.minimum(torch.clamp(
            rold * zint2 + precip / torch.clamp(zd2, min=1e-10)
            * (1.0 - zint2), min=0.0), xrk)
        xrk = torch.where(hasrain, rnew, xrk)

        store = active
        mfude_rate[:, k] = torch.where(store & (mfu[:, k + 1] > 0.0),
                                       dmfde, 0.0)
        _put(mfu, k, store, mfk)
        _put(tu, k, store, tk)
        _put(qu, k, store, quk)
        _put(lu, k, store, luk)
        _put(lude, k, store, lude_k)
        _put(lglac, k, store, lgl)
        dmfup[:, k] = torch.where(store, dmfup_k, 0.0)
        xrain[:, k] = torch.where(store, xrk, 0.0)
        _put(kineu, k, store, kin_k)
        ilab[:, k] = torch.where(store, lab_k, ilab[:, k])
        _put(mful, k, store, luk * mfk)
        _put(mfus, k, store, (c.cpd * tk + geof[:, k]) * mfk)
        _put(mfuq, k, store, quk * mfk)

    ldcum = ldcum & (kctop >= 0)
    kcbot = torch.maximum(kcbot, kctop)
    wmean = torch.sqrt(2.0 * torch.clamp(
        wmean / torch.clamp(dpmean, min=1.0), min=1.0e-2))
    # re-evaluate the type from the realized depth
    depth = _at(pf, kcbot) - _at(pf, kctop)
    ktype = torch.where(ldcum & (ktype == 1) & (depth < RDEPTHS), 2, ktype)
    ktype = torch.where(ldcum & (ktype == 2) & (depth >= RDEPTHS), 1,
                        ktype)

    rfl = _colsum(dmfup)

    # ---------------- downdrafts: lfs + ddrafdsc ----------------------
    mfd = z2.clone()
    mfds = z2.clone()
    mfdq = z2.clone()
    dmfdp = z2.clone()
    mfdde_rate = z2.clone()
    lddraf = torch.zeros_like(ldcum)
    idtop = torch.full_like(kcbot, nk)
    hs = c.cpd * t + geo + mlw(t) * qs
    hs = torch.where((karr >= 2) & (karr <= nk - 3), hs, 1.0e9)
    ikhsmin = torch.argmin(hs, dim=1)

    mftop = -RMFDEPS * mfub
    for k in range(2, nk - 3):
        cand = ldcum & (rfl > 0.0) & ~lddraf \
            & (kcbot > k) & (kctop < k) & (ikhsmin <= k)
        tw, qw = _moistadj(pf[:, k], tf[:, k], qf[:, k], cand, 2)
        ttest = 0.5 * (tu[:, k] + tw)
        qtest = 0.5 * (qu[:, k] + qw)
        buo = ttest * (1.0 + c.ep1 * qtest) \
            - tf[:, k] * (1.0 + c.ep1 * qf[:, k])
        cond = qf[:, k] - qw
        trig = cand & (buo < 0.0) & (rfl > 10.0 * mftop * cond)
        idtop = torch.where(trig, k, idtop)
        lddraf = lddraf | trig
        _put(td, k, trig, ttest)
        _put(qd, k, trig, qtest)
        _put(mfd, k, trig, mftop)
        _put(mfds, k, trig, mftop * (c.cpd * ttest + geof[:, k]))
        _put(mfdq, k, trig, mftop * qtest)
        _put(dmfdp, k - 1, trig, -0.5 * mftop * cond)
        rfl = rfl + torch.where(trig, -0.5 * mftop * cond, 0.0)

    # descent
    oentr = z1
    buoyI = z1
    itopde = nk950
    for k in range(2, nk):
        act = lddraf & (mfd[:, k - 1] < 0.0)
        entr = ENTRDD * mfd[:, k - 1] \
            * (geof[:, k - 1] - geof[:, k]) * c.regrav
        # below itopde the profile decreases linearly; above it the
        # buoyancy-organized entrainment applies (itopde static)
        if k > itopde:
            dmfen = z1
            xdmfde = mfd[:, itopde] * (pf[:, k] - pf[:, k - 1]) \
                / (pf[:, nk] - pf[:, itopde])
        else:
            dzn = -(geof[:, k - 1] - geof[:, k]) * c.regrav
            zentr = oentr * dzn * mfd[:, k - 1]
            dmfen = entr + zentr
            dmfen = torch.maximum(dmfen, 0.3 * mfd[:, k - 1])
            dmfen = torch.maximum(
                dmfen, -0.75 * mfu[:, k] - (mfd[:, k - 1] - entr))
            dmfen = torch.clamp(dmfen, max=0.0)
            xdmfde = entr
        mfdk = mfd[:, k - 1] + dmfen - xdmfde
        seen = (c.cpd * tf[:, k - 1] + geof[:, k - 1]) * dmfen
        qeen = qf[:, k - 1] * dmfen
        sdde = (c.cpd * td[:, k - 1] + geof[:, k - 1]) * xdmfde
        qdde = qd[:, k - 1] * xdmfde
        mfdsk = mfds[:, k - 1] + seen - sdde
        mfdqk = mfdq[:, k - 1] + qeen - qdde
        rmfd = 1.0 / torch.clamp(mfdk, max=-CMFCMIN)
        qdk = mfdqk * rmfd
        tdk = torch.clamp((mfdsk * rmfd - geof[:, k]) * c.rcpd, 100.0,
                          400.0)
        cond0 = qdk
        tdk, qdk = _moistadj(pf[:, k], tdk, qdk, act, 2)
        cond = cond0 - qdk
        buo = tdk * (1.0 + c.ep1 * qdk) \
            - tf[:, k] * (1.0 + c.ep1 * qf[:, k])
        hasr = (rfl > 0.0) & (mfu[:, k] > 0.0)
        buo = buo - torch.where(hasr, tdk * rfl
                                / torch.clamp(mfu[:, k], min=CMFCMIN), 0.0)
        kill = act & ((buo >= 0.0) | (rfl <= mfdk * cond))
        mfdk = torch.where(kill, 0.0, mfdk)
        xdmfdp = -mfdk * cond
        store = act
        _put(mfd, k, store, mfdk)
        _put(td, k, store, tdk)
        _put(qd, k, store, qdk)
        _put(mfds, k, store, (c.cpd * tdk + geof[:, k]) * mfdk)
        _put(mfdq, k, store, qdk * mfdk)
        _put(dmfdp, k - 1, store, xdmfdp)
        rfl = rfl + torch.where(store, xdmfdp, 0.0)
        mfdde_rate[:, k] = torch.where(store, -xdmfde, 0.0)
        buoyz = torch.clamp(torch.where(store, buo / tf[:, k], 0.0),
                            max=0.0)
        dzn2 = -(geo[:, k - 1] - geo[:, k])
        buoyI = buoyI + buoyz * dzn2
        oentr = torch.where(store, c.egrav * buoyz * 0.5 / (1.0 + buoyI),
                            oentr)

    # ---------------- CAPE closure ------------------------------------
    karr1 = karr[:, 1:]
    span_c = ldcum[:, None] & (ktype == 1)[:, None] \
        & (karr1 <= kcbot[:, None]) & (karr1 > kctop[:, None])
    xro = pf[:, 1:nk] / (c.rgas * tf[:, 1:] * (1.0 + c.ep1 * qf[:, 1:]))
    dzk = geof[:, :nk - 1] - geof[:, 1:nk]
    rheat = _colsum(torch.where(
        span_c,
        ((t[:, :-1] - t[:, 1:] + dzk * c.rcpd) / tf[:, 1:]
         + c.ep1 * (q[:, :-1] - q[:, 1:]))
        * (c.egrav * (mfu[:, 1:] + mfd[:, 1:])) / xro, 0.0))
    xcape = _colsum(torch.where(
        span_c,
        ((tu[:, 1:] - tf[:, 1:]) / tf[:, 1:]
         + c.ep1 * (qu[:, 1:] - qf[:, 1:]) - lu[:, 1:]) * dzk,
        0.0))
    xcape = torch.clamp(xcape, 0.0, 5000.0)
    rheat = torch.clamp(rheat, min=1.0e-4)
    tau = (_at(geof, kctop) - _at(geof, kcbot)) \
        / ((2.0 + torch.clamp(wmean, max=15.0)) * c.egrav) * rtau_s
    tau = torch.clamp(tau, 720.0, 10800.0)
    mfub1_deep = torch.minimum(torch.clamp(xcape * mfub / (rheat * tau),
                                           min=0.001), mfmax_b)
    mfd_b = _at(mfd, kcbot)
    eps_d = torch.where(mfd_b < 0.0,
                        -mfd_b / torch.clamp(mfub, min=1.0e-10), 0.0)
    qumqe2 = _at(qu, kcbot) + _at(lu, kcbot) - eps_d * _at(qd, kcbot) \
        - (1.0 - eps_d) * _at(qf, kcbot)
    dh2 = c.cpd * (_at(tu, kcbot) - eps_d * _at(td, kcbot)
                   - (1.0 - eps_d) * _at(tf, kcbot)) + c.wlhv * qumqe2
    dh2 = c.egrav * torch.maximum(dh2, 1.0e5 * dqmin)
    mfub1_shal = torch.where(dhpbl > 0.0,
                             torch.minimum(dhpbl / dh2, mfmax_b), mfub)
    # ktype=3: mfub1 = mfub*(1+eps) capped (:4929-4932)
    mfub1_mid = torch.minimum(mfub * (1.0 + eps_d), mfmax_b)
    mfub1 = torch.where(ktype == 1, mfub1_deep,
                        torch.where(ktype == 2, mfub1_shal,
                                    torch.where(ktype == 3, mfub1_mid,
                                                mfub)))
    mfub1 = torch.where(ldcum, mfub1, 0.0)
    # rescale the downdraft fluxes
    facd = torch.where(lddraf & (ktype != 3),
                       mfub1 / torch.clamp(mfub, min=1.0e-10), 1.0)[:, None]
    mfd = mfd * facd
    mfds = mfds * facd
    mfdq = mfdq * facd
    dmfdp = dmfdp * facd
    mfdde_rate = mfdde_rate * facd
    # updraft scaling (with the CFL cap): the running minimum over the
    # span is the minimum of the per-level CFL ratios
    mfs = torch.where(ldcum, mfub1 / torch.clamp(mfub, min=CMFCMIN), 1.0)
    inspan_s = ldcum[:, None] & (karr1 >= kctop[:, None] - 1)
    mfmaxk = (pf[:, 1:nk] - pf[:, :nk - 1]) * cons2 * RMFLIC + RMFLIA
    ratios = torch.where(inspan_s,
                         mfmaxk / torch.clamp(mfu[:, 1:], min=CMFCMIN),
                         torch.inf)
    mfs = torch.minimum(mfs, ratios.amin(dim=1))
    span_u = ldcum[:, None] & (karr <= kcbot[:, None]) \
        & (karr >= kctop[:, None] - 1)
    scale = torch.where(span_u, mfs[:, None], 1.0)
    mfu = mfu * scale
    mfus = mfus * scale
    mfuq = mfuq * scale
    mful = mful * scale
    dmfup = dmfup * scale
    lude = lude * scale
    mfude_rate = mfude_rate * scale

    # drop the downdrafts above cloud top
    idtop = torch.where(lddraf & (idtop <= kctop), kctop + 1, idtop)
    above_dd = karr < idtop[:, None]
    mfd = torch.where(above_dd, 0.0, mfd)
    mfds = torch.where(above_dd, 0.0, mfds)
    mfdq = torch.where(above_dd, 0.0, mfdq)
    mfdde_rate = torch.where(karr <= idtop[:, None], 0.0, mfdde_rate)
    dmfdp = torch.where(above_dd, 0.0, dmfdp)

    # ---------------- cfluxes (:6840) ---------------------------------
    incloud = ldcum[:, None] & (karr >= kctop[:, None])
    mfus = torch.where(incloud,
                       mfus - mfu * (c.cpd * tf + geof[:, :nk]), 0.0)
    mfuq = torch.where(incloud, mfuq - mfu * qf, 0.0)
    lglac = torch.where(incloud, mfu * lglac, 0.0)
    dd_act = lddraf[:, None] & (karr >= idtop[:, None])
    mfds = torch.where(incloud & dd_act,
                       mfds - mfd * (c.cpd * tf + geof[:, :nk]), 0.0)
    mfdq = torch.where(incloud & dd_act, mfdq - mfd * qf, 0.0)
    mfd = torch.where(incloud & dd_act, mfd, 0.0)
    mfu = torch.where(incloud, mfu, 0.0)
    mful = torch.where(incloud, mful, 0.0)
    dmfup = torch.where(incloud, dmfup, 0.0)
    dmfdp = torch.where(incloud & dd_act, dmfdp, 0.0)
    lude = torch.where(
        ldcum[:, None] & (karr >= kctop[:, None] - 1), lude, 0.0)

    # composite below-cloud linear decrease (:6917-6941): the two
    # reference stages (kcbot→kcbot+1, then scaling from kcbot+1)
    # telescope to (psfc − pf(k)) / (psfc − pf(kcbot))
    ikb = kcbot
    zp_num = pf[:, nk][:, None] - pf[:, :nk]
    zp_den = pf[:, nk] - _at(pf, ikb)
    zp = zp_num / torch.clamp(zp_den, min=1.0)[:, None]
    belowb = ldcum[:, None] & (karr > ikb[:, None])
    mfu_ikb1 = _at(mfu, ikb)[:, None]
    mfus_ikb1 = (_at(mfus, ikb) - mlw(_at(tf, ikb)) * _at(mful, ikb))[:, None]
    mfuq_ikb1 = (_at(mfuq, ikb) + _at(mful, ikb))[:, None]
    mfu = torch.where(belowb, mfu_ikb1 * zp, mfu)
    mfus = torch.where(belowb, mfus_ikb1 * zp, mfus)
    mfuq = torch.where(belowb, mfuq_ikb1 * zp, mfuq)
    mful = torch.where(belowb, 0.0, mful)

    # rain/snow fluxes with melting + evaporation below cloud base
    cons1a = c.cpd / (c.wlhf * c.egrav * RTAUMEL)
    mflxr = torch.zeros((npx, nk + 1), dtype=t.dtype, device=dev)
    mflxs = torch.zeros_like(mflxr)
    dpmel = z2.clone()
    for k in range(1, nk):
        span = ldcum & (kctop - 1 <= k)
        dpk_ = pf[:, k + 1] - pf[:, k]
        cons1 = cons1a * (1.0 + 0.5 * (t[:, k] - c.tzero))
        fac = cons1 * dpk_
        snmlt = torch.where(span & (mflxs[:, k] > 0.0)
                            & (t[:, k] > c.tzero),
                            torch.minimum(mflxs[:, k],
                                          fac * (t[:, k] - c.tzero)), 0.0)
        dpmel[:, k] = snmlt
        alfaw = xalpha(t[:, k])
        frz = span & (t[:, k] < c.tzero) & (alfaw > 0.0)
        lglac[:, k] = lglac[:, k] + torch.where(
            frz, alfaw * (dmfup[:, k] + dmfdp[:, k]), 0.0)
        alfaw = torch.where(frz, 0.0, alfaw)
        add = dmfup[:, k] + dmfdp[:, k]
        r_next = mflxr[:, k] + torch.where(span, alfaw * add + snmlt, 0.0)
        s_next = mflxs[:, k] + torch.where(span, (1.0 - alfaw) * add
                                           - snmlt, 0.0)
        tot = r_next + s_next
        r_new = torch.where(tot < 0.0, 0.0,
                            torch.where(r_next < 0.0, 0.0,
                                        torch.where(s_next < 0.0,
                                                    tot, r_next)))
        s_next = torch.where(tot < 0.0, 0.0,
                             torch.where(s_next < 0.0, 0.0,
                                         torch.where(mflxr[:, k] + alfaw
                                                     * add + snmlt < 0.0,
                                                     tot, s_next)))
        r_next = r_new
        # below-base evaporation (Kessler-type)
        below = ldcum & (kcbot <= k)
        xrfl = r_next + s_next
        drfl1 = RCPEC * torch.clamp(qs[:, k] - q[:, k], min=0.0) * RCUC \
            * (torch.sqrt(pf[:, k] / pf[:, nk]) / 5.09e-3
               * torch.clamp(xrfl, min=1e-20) / RCUC) ** 0.5777 * dpk_
        rnew = xrfl - drfl1
        rmin = xrfl - RCUC * torch.clamp(
            RHEBC * qs[:, k] - q[:, k], min=0.0) * cons2 * dpk_
        xrfln = torch.clamp(torch.maximum(rnew, rmin), min=0.0)
        drfl = torch.clamp(xrfln - xrfl, max=0.0)
        frac_r = r_next / torch.clamp(xrfl, min=1e-20)
        ev_ok = below & (xrfl > 1e-20)
        r_next = torch.where(ev_ok, r_next + drfl * frac_r, r_next)
        s_next = torch.where(ev_ok, s_next + drfl * (1.0 - frac_r), s_next)
        dmfup[:, k] = dmfup[:, k] + torch.where(ev_ok, drfl, 0.0)
        mflxr[:, k + 1] = torch.clamp(r_next, min=0.0)
        mflxs[:, k + 1] = torch.clamp(s_next, min=0.0)

    # ---------------- dtdqc: implicit T/q update (:6521) --------------
    dp_g = c.egrav / (pf[:, 1:] - pf[:, :-1])
    inspan2 = ldcum[:, None] & (karr1 >= kctop[:, None] - 1)
    gq2 = (qf[:, 1:] - q[:, :-1]) / torch.clamp(qs[:, 1:], min=1e-10)
    gh2 = c.cpd * t[:, 1:] + geo[:, 1:]
    gs2 = (c.cpd * (tf[:, 1:] - t[:, :-1])
           + geof[:, 1:nk] - geo[:, :-1]) / gh2
    # ximp = 0: zs = cpd·gs·t(k) + geo(k-1) + gs·geo(k) (:6580)
    zs2 = c.cpd * gs2 * t[:, 1:] + geo[:, :-1] + gs2 * geo[:, 1:]
    zq2 = gq2 * qs[:, 1:]
    dd2 = lddraf[:, None] & (karr1 >= idtop[:, None])
    first = lambda a, rest: torch.cat([a[:, :1], rest], dim=1)
    xmfus = first(mfus, torch.where(inspan2, mfus[:, 1:] - mfu[:, 1:] * zs2,
                                    mfus[:, 1:]))
    xmfuq = first(mfuq, torch.where(inspan2, mfuq[:, 1:] - mfu[:, 1:] * zq2,
                                    mfuq[:, 1:]))
    xmfds = first(mfds, torch.where(inspan2 & dd2,
                                    mfds[:, 1:] - mfd[:, 1:] * zs2,
                                    mfds[:, 1:]))
    xmfdq = first(mfdq, torch.where(inspan2 & dd2,
                                    mfdq[:, 1:] - mfd[:, 1:] * zq2,
                                    mfdq[:, 1:]))

    # the flux at the interface below each layer: the next column, zero
    # under the lowest layer (whose own formula follows)
    nxt = lambda a: torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    xalv = mlw(t)
    dtdt = dp_g * c.rcpd * (
        nxt(xmfus) - xmfus + nxt(xmfds) - xmfds
        + c.wlhf * lglac - c.wlhf * dpmel
        - xalv * (nxt(mful) - mful - lude - dmfup))
    dqdt = dp_g * (nxt(xmfuq) - xmfuq + nxt(xmfdq) - xmfdq
                   + nxt(mful) - mful - lude - dmfup)
    # surface layer (k=nk-1): no inflow from below
    ks = nk - 1
    dtdt[:, ks] = -dp_g[:, ks] * c.rcpd * (
        xmfus[:, ks] + xmfds[:, ks] + c.wlhf * dpmel[:, ks]
        - xalv[:, ks] * (mful[:, ks] + dmfup[:, ks]))
    dqdt[:, ks] = -dp_g[:, ks] * (xmfuq[:, ks] + xmfdq[:, ks]
                                  + mful[:, ks] + dmfup[:, ks])

    # implicit bidiagonal solve (rmfsoltq=1; solver :5611)
    cummask = ldcum[:, None] & (karr >= kctop[:, None] - 1)

    def bidiag(aa_m, bb_m, rhs_a, rhs_b):
        """Forward bidiagonal substitution (solver, :5611) for two
        right-hand sides at once, the top row at kctop-1."""
        r1p = r2p = z1
        ys1, ys2 = [], []
        for k in range(nk):
            attop = kctop - 1 == k
            solv = cummask[:, k] & (torch.abs(bb_m[:, k]) > 1e-30)
            r1k = torch.where(attop, rhs_a[:, k] / bb_m[:, k],
                              (rhs_a[:, k] - aa_m[:, k] * r1p) / bb_m[:, k])
            r2k = torch.where(attop, rhs_b[:, k] / bb_m[:, k],
                              (rhs_b[:, k] - aa_m[:, k] * r2p) / bb_m[:, k])
            r1p = torch.where(solv, r1k, 0.0)
            r2p = torch.where(solv, r2k, 0.0)
            ys1.append(r1p)
            ys2.append(r2p)
        return torch.stack(ys1, dim=1), torch.stack(ys2, dim=1)

    zp = RMFSOLTQ * dp_g * dt
    aa = torch.where(cummask, -zp * (mfu + mfd), 0.0)
    bbst = torch.where(cummask, 1.0 + zp * nxt(mfu + mfd), 1.0)
    bbst[:, nk - 1] = 1.0
    rhs_t = torch.where(cummask, dtdt * dt + t, t)
    rhs_q = torch.where(cummask, dqdt * dt + q, q)
    r1, r2 = bidiag(aa, bbst, rhs_t, rhs_q)
    tten = torch.where(cummask, (r1 - t) * rdt, 0.0)
    qten = torch.where(cummask, (r2 - q) * rdt, 0.0)

    # ---------------- section 9: draught momentum (:5175-5280) --------
    ruvper = 0.3
    # updraft winds: set at cloud base from the level above the
    # departure level, then evolved upward with enhanced entrainment
    u_dp = _at(u, idpl - 1)
    v_dp = _at(v, idpl - 1)
    uu = uu.clone()
    vu = vu.clone()
    for k in range(nk - 2, 0, -1):
        atbase = ldcum & (kcbot == k)
        _put(uu, k, atbase, u_dp)
        _put(vu, k, atbase, v_dp)
        inup = ldcum & (kcbot > k) & (kctop <= k)
        fac = torch.where(ktype == 1, t.new_tensor(2.0), 0.0)
        fac = torch.where((ktype == 1) & (kctop + 2 >= k), 3.0, fac)
        erate = mfu[:, k] - mfu[:, k + 1] + (1.0 + fac) * mfude_rate[:, k]
        derate = (1.0 + fac) * mfude_rate[:, k]
        mfa = 1.0 / torch.clamp(mfu[:, k], min=CMFCMIN)
        _put(uu, k, inup, (uu[:, k + 1] * mfu[:, k + 1] + erate * u[:, k]
                           - derate * uu[:, k + 1]) * mfa)
        _put(vu, k, inup, (vu[:, k + 1] * mfu[:, k + 1] + erate * v[:, k]
                           - derate * vu[:, k + 1]) * mfa)

    # downdraft winds from the LFS downward
    for k in range(2, nk):
        attop = ldcum & (idtop == k)
        _put(ud, k, attop, 0.5 * (uu[:, k] + u[:, k - 1]))
        _put(vd, k, attop, 0.5 * (vu[:, k] + v[:, k - 1]))
        indn = ldcum & (idtop < k)
        erate = -mfd[:, k] + mfd[:, k - 1] + mfdde_rate[:, k]
        mfa = 1.0 / torch.clamp(mfd[:, k], max=-CMFCMIN)
        _put(ud, k, indn, (ud[:, k - 1] * mfd[:, k - 1]
                           - erate * u[:, k - 1]
                           + mfdde_rate[:, k] * ud[:, k - 1]) * mfa)
        _put(vd, k, indn, (vd[:, k - 1] * mfd[:, k - 1]
                           - erate * v[:, k - 1]
                           + mfdde_rate[:, k] * vd[:, k - 1]) * mfa)

    # CFL rescale of the momentum-transporting fluxes (:5227-5248;
    # mfmax here uses cons without the rmfcfl factor)
    lim9 = ldcum[:, None] & (karr1 >= kctop[:, None])
    mfmax9 = (pf[:, 1:nk] - pf[:, :nk - 1]) * cons
    mfs2 = torch.clamp(torch.where(
        lim9 & (mfu[:, 1:] > mfmax9),
        mfmax9 / torch.clamp(mfu[:, 1:], min=CMFCMIN),
        torch.inf).amin(dim=1), max=1.0)
    span9 = ldcum[:, None] & (karr >= kctop[:, None] - 1)
    mfuus = torch.where(span9, mfu * mfs2[:, None], mfu)
    mfdus = torch.where(span9, mfd * mfs2[:, None], mfd)
    # implicit (rmfsoluv=1): linear sub-cloud draught profiles (:5251)
    u_b1 = _at(u, kcbot - 1)
    v_b1 = _at(v, kcbot - 1)
    mfuus_b = _at(mfuus, kcbot)
    mfuub = mfuus_b * (_at(uu, kcbot) - u_b1)
    mfuvb = mfuus_b * (_at(vu, kcbot) - v_b1)
    below9 = ldcum[:, None] & (karr1 > kcbot[:, None])
    zp9l = (pf[:, nk][:, None] - pf[:, 1:nk]) \
        / torch.clamp(pf[:, nk] - _at(pf, kcbot), min=1.0)[:, None]
    mfa9 = 1.0 / torch.clamp(mfuus[:, 1:], min=CMFCMIN)
    um1 = u[:, :-1]
    vm1 = v[:, :-1]
    ud_b = _at(ud, kcbot) - u_b1
    vd_b = _at(vd, kcbot) - v_b1
    mfdus_b = _at(mfdus, kcbot)
    uu = first(uu, torch.where(below9, um1 + mfuub[:, None] * zp9l * mfa9,
                               uu[:, 1:]))
    vu = first(vu, torch.where(below9, vm1 + mfuvb[:, None] * zp9l * mfa9,
                               vu[:, 1:]))
    mfdus = first(mfdus, torch.where(below9, mfdus_b[:, None] * zp9l,
                                     mfdus[:, 1:]))
    ud = first(ud, torch.where(below9, um1 + ud_b[:, None], ud[:, 1:]))
    vd = first(vd, torch.where(below9, vm1 + vd_b[:, None], vd[:, 1:]))
    pert9 = ldcum[:, None] & (karr1 >= kctop[:, None])
    uu = first(uu, torch.where(pert9, uu[:, 1:] - ruvper
                               * torch.sign(uu[:, 1:]), uu[:, 1:]))
    vu = first(vu, torch.where(pert9, vu[:, 1:] - ruvper
                               * torch.sign(vu[:, 1:]), vu[:, 1:]))

    # ---------------- dudvx (:6694): implicit momentum update ---------
    mfuu = torch.where(cummask, mfuus * uu, 0.0)     # ximp = 0
    mfuv = torch.where(cummask, mfuus * vu, 0.0)
    mfdu = torch.where(cummask, mfdus * ud, 0.0)
    mfdv = torch.where(cummask, mfdus * vd, 0.0)
    dudt = dp_g * (nxt(mfuu) - mfuu + nxt(mfdu) - mfdu)
    dvdt = dp_g * (nxt(mfuv) - mfuv + nxt(mfdv) - mfdv)
    dudt[:, ks] = -dp_g[:, ks] * (mfuu[:, ks] + mfdu[:, ks])
    dvdt[:, ks] = -dp_g[:, ks] * (mfuv[:, ks] + mfdv[:, ks])
    zp9 = RMFSOLUV * dp_g * dt
    aa9 = torch.where(cummask, -zp9 * (mfuus + mfdus), 0.0)
    bb9 = torch.where(cummask, 1.0 + zp9 * nxt(mfuus + mfdus), 1.0)
    bb9[:, nk - 1] = torch.where(cummask[:, nk - 1], 1.0, bb9[:, nk - 1])
    rhs_u = torch.where(cummask, dudt * dt + u, u)
    rhs_v = torch.where(cummask, dvdt * dt + v, v)
    r1u, r2v = bidiag(aa9, bb9, rhs_u, rhs_v)
    uten = torch.where(cummask, (r1u - u) * rdt, 0.0)
    vten = torch.where(cummask, (r2v - v) * rdt, 0.0)
    # KE dissipation heating (lmfuvdis, :5288-5315)
    dzp = pf[:, 1:] - pf[:, :-1]
    uv2 = torch.where(cummask, torch.sqrt(uten ** 2 + vten ** 2), 0.0)
    xsum22 = _colsum(uv2 * dzp)
    xsum12 = -_colsum(torch.where(cummask, (u * uten + v * vten) * dzp,
                                  0.0))
    tdis = c.rcpd * xsum12[:, None] * uv2 \
        / torch.clamp(xsum22, min=1e-15)[:, None]
    tten = tten + torch.where(cummask, tdis, 0.0)

    # detrained condensate tendencies + cloud fraction ----------------
    tenl = lude * c.egrav / (pf[:, 1:] - pf[:, :-1])
    teni = (1.0 - xalpha(t)) * tenl
    tenl = tenl - teni
    qdetr = lude * dt * c.egrav / (pf[:, 1:] - pf[:, :-1])
    # prsfc = mflxr(nk+1): the driver's 1e3 undoes the scheme's 1e-3
    # (cucall :718-719 vs :5508-5515) → kg/m²/s net
    prate = torch.where(ldcum & (ktype > 0),
                        mflxr[:, nk] + mflxs[:, nk], 0.0)
    raincc = mflxr[:, :nk] * 1.0e-3     # cu_raincc parity (m/s)
    # Xu & Krueger 1991 cloud fraction (tiedtkedrv :458-485;
    # defaults mod_params.F90:339-341)
    kfac_deep, kfac_shal, k2c = 0.14, 0.07, 500.0
    inspan3 = ldcum[:, None] & (karr >= kctop[:, None]) \
        & (karr <= kcbot[:, None])
    lg = torch.log1p(k2c * mfu)
    cf_deep = torch.clamp(kfac_deep * lg, 0.01, 0.6)
    cf_shal = torch.clamp(kfac_shal * lg, 0.01, 0.2)
    cf_mid = torch.clamp(0.5 * (kfac_deep + kfac_shal) * lg, 0.01, 0.4)
    cldfra = torch.where(
        inspan3,
        torch.where((ktype == 1)[:, None], cf_deep,
                    torch.where((ktype == 2)[:, None], cf_shal, cf_mid)),
        0.0)

    # section 11 (:5344-5380): CFL-rescale the fluxes for tracer
    # transport (tighter 0.8·cons cap, rmfsolct ≤ 3)
    ct_ldcum = ldcum & (ktype != 3) & (kcbot - kctop >= 1)
    lim11 = ct_ldcum[:, None] & (karr1 >= kctop[:, None])
    mfmax11 = (pf[:, 1:nk] - pf[:, :nk - 1]) * 0.8 * cons
    mfs11 = torch.clamp(torch.where(
        lim11 & (mfu[:, 1:] > mfmax11),
        mfmax11 / torch.clamp(mfu[:, 1:], min=CMFCMIN),
        torch.inf).amin(dim=1), max=1.0)
    span11u = ct_ldcum[:, None] & (karr >= kctop[:, None] - 1)
    ct_lddraf = lddraf & ct_ldcum
    span11d = ct_lddraf[:, None] & (karr >= idtop[:, None] - 1)
    ct_mfu = torch.where(span11u, mfu * mfs11[:, None], 0.0)
    ct_udrate = torch.where(span11u, mfude_rate * mfs11[:, None], 0.0)
    ct_mfd = torch.where(span11d, mfd * mfs11[:, None], 0.0)
    ct_ddrate = torch.where(span11d, mfdde_rate * mfs11[:, None], 0.0)
    if lmfsmooth:
        ct_mfu, ct_mfd, ct_udrate, ct_ddrate = _smooth_fluxes(
            ct_mfu, ct_mfd, ct_udrate, ct_ddrate, ct_ldcum, ct_lddraf,
            kctop, karr)

    z = torch.where(ldcum[:, None], t.new_tensor(1.0), 0.0)
    return TiedtkeOut(tten=tten * z, qten=qten * z, lten=tenl * z,
                      iten=teni * z, uten=uten * z, vten=vten * z,
                      prate=prate, qdetr=qdetr * z, raincc=raincc,
                      cldfra=cldfra, ktype=ktype, kctop=kctop,
                      kcbot=kcbot, ct_mfu=ct_mfu, ct_mfd=ct_mfd,
                      ct_udrate=ct_udrate, ct_ddrate=ct_ddrate,
                      ct_ldcum=ct_ldcum, ct_lddraf=ct_lddraf, idtop=idtop)


def _smooth_fluxes(ct_mfu, ct_mfd, ct_udrate, ct_ddrate, ct_ldcum,
                   ct_lddraf, kctop, karr):
    """``lmfsmooth``: the tracer-transport mass fluxes smoothed at the
    draughts' edges (:5387-5417)."""
    nk = ct_mfu.shape[1]
    attop = ct_ldcum[:, None] & (karr == kctop[:, None]) \
        & (karr >= 1) & (karr <= nk - 2)
    mfu_p1 = torch.cat([ct_mfu[:, 1:], ct_mfu[:, -1:]], dim=1)
    erate_u = torch.clamp(ct_mfu - 0.5 * mfu_p1, min=0.0)
    new_mfu = torch.where(attop, ct_mfu - erate_u, ct_mfu)
    ct_udrate = torch.where(attop, ct_udrate + erate_u, ct_udrate)
    # mfudr(kctop-1) = smoothed mfuus(kctop)
    wrt = torch.cat([attop[:, 1:], torch.zeros_like(attop[:, :1])], dim=1)
    val = torch.cat([new_mfu[:, 1:], new_mfu[:, -1:]], dim=1)
    ct_udrate = torch.where(wrt, val, ct_udrate)
    m_p1 = torch.cat([ct_mfd[:, 1:], torch.zeros_like(ct_mfd[:, :1])], dim=1)
    m_m1 = torch.cat([torch.zeros_like(ct_mfd[:, :1]), ct_mfd[:, :-1]], dim=1)
    dcond = ct_lddraf[:, None] & (ct_mfd < 0.0) & (torch.abs(m_p1) < 1e-30) \
        & (karr >= 1) & (karr <= nk - 2)
    erate_d = torch.clamp(ct_mfd - 0.5 * m_m1, max=0.0)
    new_mfd = torch.where(dcond, ct_mfd - erate_d, ct_mfd)
    ct_ddrate = torch.where(dcond, ct_ddrate - erate_d, ct_ddrate)
    # mfddr(k+1) = -smoothed mfdus(k)
    wrtd = torch.cat([torch.zeros_like(dcond[:, :1]), dcond[:, :-1]], dim=1)
    vald = torch.cat([torch.zeros_like(new_mfd[:, :1]), -new_mfd[:, :-1]],
                     dim=1)
    ct_ddrate = torch.where(wrtd, vald, ct_ddrate)
    udr_m1 = torch.cat([torch.zeros_like(ct_udrate[:, :1]),
                        ct_udrate[:, :-1]], dim=1)
    fill = ct_ldcum[:, None] & (torch.abs(ct_udrate) < 1e-30) \
        & (udr_m1 > 0.0) & (karr >= 1) & (karr <= nk - 2)
    ct_udrate = torch.where(fill, 0.5 * udr_m1, ct_udrate)
    return new_mfu, new_mfd, ct_udrate, ct_ddrate


def ctracer(qtrac, out: TiedtkeOut, pf, dt):
    """Convective tracer transport (ctracer, :7549-7707): updraft and
    downdraft tracer profiles from the CFL-rescaled mass fluxes, then an
    implicit bidiagonal update (rmfsolct=1).

    qtrac (np, nk, ntr) uncoupled mixing ratios; returns the tracer
    tendency (np, nk, ntr). Applied by the caller on the cumulus alarm's
    steps only: the reference's impulse semantics (tenc is written
    straight into the chem tendency array on alarm steps)."""
    npx, nk, ntrc = qtrac.shape
    mfu, mfd = out.ct_mfu, out.ct_mfd
    udrate, ddrate = out.ct_udrate, out.ct_ddrate
    ldcum, lddraf = out.ct_ldcum, out.ct_lddraf
    kctop, idtop = out.kctop, out.idtop
    karr = torch.arange(nk, device=qtrac.device)[None, :]
    rdt = 1.0 / dt
    dp_g = c.egrav / (pf[:, 1:] - pf[:, :-1])
    cumask = ldcum[:, None] & (karr >= kctop[:, None] - 1) & (karr >= 1)

    # 2. updraft values (:7559-7572), sequential upward
    cu = torch.zeros_like(qtrac)
    cu[:, nk - 1] = qtrac[:, nk - 1]
    for k in range(nk - 2, 1, -1):
        erate = (mfu[:, k] - mfu[:, k + 1] + udrate[:, k])[:, None]
        mfa = (1.0 / torch.clamp(mfu[:, k], min=CMFCMIN))[:, None]
        upd = (cumask[:, k] & (k >= kctop))[:, None]
        val = (mfu[:, k + 1][:, None] * cu[:, k + 1] + erate * qtrac[:, k]
               - udrate[:, k][:, None] * cu[:, k + 1]) * mfa
        cu[:, k] = torch.where(upd, val, cu[:, k])

    # 3. downdraft values (:7576-7592), sequential downward
    cd = torch.zeros_like(qtrac)
    for k in range(2, nk):
        attop = (lddraf & (k == idtop))[:, None]
        cd_top = 0.1 * cu[:, k] + 0.9 * qtrac[:, k - 1]
        erate = (-mfd[:, k] + mfd[:, k - 1] + ddrate[:, k])[:, None]
        mfa = (1.0 / torch.clamp(mfd[:, k], max=-CMFCMIN))[:, None]
        indn = (lddraf & (k > idtop))[:, None]
        val = (mfd[:, k - 1][:, None] * cd[:, k - 1]
               - erate * qtrac[:, k - 1]
               + ddrate[:, k][:, None] * cd[:, k - 1]) * mfa
        cd[:, k] = torch.where(attop, cd_top,
                               torch.where(indn, val, cd[:, k]))

    # surface positivity guard (:7595-7608)
    ks = nk - 1
    posi = -dp_g[:, ks][:, None] * (
        mfu[:, ks][:, None] * cu[:, ks] + mfd[:, ks][:, None] * cd[:, ks]
        - (mfu[:, ks] + mfd[:, ks])[:, None] * qtrac[:, ks - 1])
    neg = lddraf[:, None] & (qtrac[:, ks] + posi * dt < 0.0)
    mfa_s = (1.0 / torch.clamp(mfd[:, ks], max=-CMFCMIN))[:, None]
    cd_fix = ((mfu[:, ks] + mfd[:, ks])[:, None] * qtrac[:, ks - 1]
              - mfu[:, ks][:, None] * cu[:, ks]
              + qtrac[:, ks] / (dt * dp_g[:, ks][:, None])) * mfa_s
    cd[:, ks] = torch.where(neg, cd_fix, cd[:, ks])

    # 4-5. fluxes and explicit divergence (ximp = 0, :7612-7638)
    mfc = torch.where(cumask[:, :, None],
                      mfu[:, :, None] * cu + mfd[:, :, None] * cd, 0.0)
    mfc_p = torch.cat([mfc, mfc.new_zeros((npx, 1, ntrc))], dim=1)
    xtenc = torch.where(cumask[:, :, None],
                        dp_g[:, :, None] * (mfc_p[:, 1:] - mfc), 0.0)
    xtenc[:, nk - 1] = torch.where(
        ldcum[:, None], -dp_g[:, nk - 1][:, None] * mfc[:, nk - 1], 0.0)

    # 7. implicit bidiagonal solve (rmfsolct=1, :7656-7695)
    zp = dp_g * dt
    aa = torch.where(cumask, -zp * (mfu + mfd), 0.0)
    mf_p = torch.cat([mfu + mfd, mfu.new_zeros((npx, 1))], dim=1)
    bb = torch.where(cumask, 1.0 + zp * mf_p[:, 1:], 1.0)
    bb[:, nk - 1] = torch.where(cumask[:, nk - 1], 1.0, bb[:, nk - 1])
    rhs = torch.where(cumask[:, :, None], xtenc * dt + qtrac, qtrac)
    rp = qtrac.new_zeros((npx, ntrc))
    rys = []
    for k in range(nk):
        attop = (k == kctop - 1)[:, None]
        solv = (cumask[:, k] & (torch.abs(bb[:, k]) > 1e-30))[:, None]
        rk = torch.where(attop, rhs[:, k] / bb[:, k][:, None],
                         (rhs[:, k] - aa[:, k][:, None] * rp)
                         / bb[:, k][:, None])
        rp = torch.where(solv, rk, 0.0)
        rys.append(rp)
    r1 = torch.stack(rys, dim=1)
    return torch.where(cumask[:, :, None], (r1 - qtrac) * rdt, 0.0)
