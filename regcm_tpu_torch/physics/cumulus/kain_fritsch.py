"""Kain-Fritsch mass-flux cumulus convection (icup=6), torch twin of
``regcm_tpu/physics/cumulus/kain_fritsch.py``.

``Main/cumlib/mod_cu_kf.F90`` (the WRF kfeta scheme adapted to RegCM;
driver ``kfdrv`` :167, column ``kfpara`` :344, lookup tables
``kf_lutab`` :2439, with ``tpmix2`` :2095, ``dtfrznew`` :2196,
``condload`` :2246, ``prof5`` :2322, ``tpmix2dd`` :2357 and
``envirtht`` :2404), kf_trigger = 3 (the Ma-Tan/Narita-Ohmori RH
perturbation) as the reference hardcodes it.

Columns are (ncol, nk) tensors with nk=0 at the SURFACE (the scheme's
own order; the suite flips the model's top-down fields). As in the JAX
package:
- the updraft source-layer search (the ``usl:`` loop, first deep cloud
  wins with a shallow fallback) is a candidate axis: the updrafts of all
  NCAND candidate source layers rise at once, (ncol, NCAND) planes in a
  loop over the levels, and the winner is chosen by mask;
- the 10-pass CAPE closure runs every pass with per-column convergence
  masks, and the compensating-subsidence advection NSTEPMAX masked
  substeps, each column its own nstep, so nothing is read back to the
  host. The advected fields are stacked into one (nf, ncol, nk) tensor so
  that a substep is a handful of operations;
- ``tpmix2dd`` inverts theta_es by 28 bisection steps, not the table
  walk, and ``envirtht`` takes the logarithm directly.
Where a level recursion does not feed the inversion (the wet-bulb
descent, the closure's parcel ascent), the inversions of all levels run
as one batch. Every sum over levels (the mixing layer, the budgets, the
mass-flux profiles) runs in level order, so a column gives the same
bits in any block of a decomposed domain. The lookup tables are built in
numpy at construction (``KFTables.build``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...dynamics.hydrostatic import level_sum
from ...utils import constants as c

# Buck (1981) saturation constants (mod_constants.F90:327-336)
ALIQ, BLIQ, CLIQ, DLIQ = 613.3, 17.502, 4780.8, 32.19
XLV0, XLV1 = 3.15e6, 2370.0
C1, C2, C4 = 3374.6525, 2.5403, 0.810
P00 = 1.0e5
EP2 = c.ep2
EP1 = 0.6077338
GDRY = -c.egrav / c.cpd
TTFRZ = c.tzero - 5.0
TBFRZ = c.tzero - 25.0
DPMIN = 5.0e3
ASTRT, AINCB = 1.0e-3, 0.025
KFNT, KFNP, KFNA = 500, 440, 600
NCAND = 20          # 15 hPa source-layer candidates to p_sfc - 300 hPa
NSTEPMAX = 100      # sub-CFL advection substeps bound
MAXITER = 10


class KFParams(NamedTuple):
    """kfparam namelist (Main/mod_params.F90:463-471) and the
    cloud-fraction constants (:339-341)."""
    entrate: float = 0.03
    convrate: float = 0.03
    min_pef: float = 0.2
    max_pef: float = 0.9
    dpp: float = 150.0
    min_dtcape: float = 1800.0
    max_dtcape: float = 3600.0
    tkemax: float = 5.0
    wthreshold: float = 0.02
    k2_const: float = 500.0
    kfac_shal: float = 0.07
    kfac_deep: float = 0.14


def _thes(t, p, qs):
    """Saturated equivalent potential temperature, the Bolton form used
    throughout the scheme (numpy)."""
    pi = (P00 / p) ** (0.2854 * (1.0 - 0.28 * qs))
    return t * pi * np.exp((C1 / t - C2) * qs * (1.0 + C4 * qs))


def kf_lutab(ptop_pa: float):
    """Saturation-point lookup tables (kf_lutab, :2439-2528): ttab/qstab
    (KFNT, KFNP) of T and qs against (theta_es, p), the0k the base
    theta_es of each pressure, alu the log table; a secant iteration over
    all pressures at once."""
    tmin, pbot, dth = 150.0, 1.1e5, 0.5
    plutop = max(ptop_pa, 5000.0)
    dpr = (pbot - plutop) / (KFNP - 1)
    p = plutop + dpr * np.arange(KFNP)
    es = ALIQ * np.exp((BLIQ * tmin - CLIQ) / (tmin - DLIQ))
    qs = EP2 * es / (p - es)
    the0k = _thes(tmin, p, qs)

    ttab = np.zeros((KFNT, KFNP))
    qstab = np.zeros((KFNT, KFNP))
    tprev = np.full(KFNP, tmin)
    for it in range(KFNT):
        thes = the0k + dth * it
        tgues = tprev.copy()
        es = ALIQ * np.exp((BLIQ * tgues - CLIQ) / (tgues - DLIQ))
        qs = EP2 * es / (p - es)
        f0 = _thes(tgues, p, qs) - thes
        t1 = tgues - 0.5 * f0
        t0 = tgues
        for _ in range(11):
            if np.all(np.abs(t1 - t0) < 1e-5):
                break
            es = ALIQ * np.exp((BLIQ * t1 - CLIQ) / (t1 - DLIQ))
            qs = EP2 * es / (p - es)
            f1 = _thes(t1, p, qs) - thes
            denom = np.where(np.abs(f1 - f0) < 1e-30, 1e-30, f1 - f0)
            dtx = f1 * (t1 - t0) / denom
            t0, f0 = t1, f1
            t1 = t1 - dtx
        es = ALIQ * np.exp((BLIQ * t1 - CLIQ) / (t1 - DLIQ))
        qs = EP2 * es / (p - es)
        ttab[it] = t1
        qstab[it] = qs
        tprev = t1
    alu = np.log(ASTRT + AINCB * np.arange(KFNA))
    return dict(ttab=ttab, qstab=qstab, the0k=the0k, alu=alu,
                plutop=plutop, rdpr=1.0 / dpr, rdthk=1.0 / dth)


class KFTables(NamedTuple):
    ttab: torch.Tensor
    qstab: torch.Tensor
    the0k: torch.Tensor
    alu: torch.Tensor
    plutop: float
    rdpr: float
    rdthk: float

    @classmethod
    def build(cls, ptop_pa, device, dtype=torch.float64):
        """The tables on the caller's ``device`` (no default: a model on
        the card builds them there)."""
        d = kf_lutab(float(ptop_pa))
        f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        return cls(f(d["ttab"]), f(d["qstab"]), f(d["the0k"]),
                   f(d["alu"]), d["plutop"], d["rdpr"], d["rdthk"])


# -- level-order reductions (the same bits in any block of a domain) ----

def _lsum(a):
    """Σ over the last (level) axis in level order (``level_sum``)."""
    return level_sum(a.movedim(-1, 0))


def _lcumsum(a):
    """Cumulative sum over the last (level) axis in level order."""
    out = torch.empty_like(a)
    acc = a[..., 0]
    out[..., 0] = acc
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., k]
        out[..., k] = acc
    return out


def _rcumsum(a):
    """Cumulative sum from the top level down (flip, cumsum, flip)."""
    return torch.flip(_lcumsum(torch.flip(a, [-1])), [-1])


def _first_true(mask, dim=-1, default=0):
    """Index of the first True along ``dim`` (default where none) and
    whether there is one; argmax on an integer cast keeps the first."""
    any_ = mask.any(dim=dim)
    idx = torch.argmax(mask.to(torch.int32), dim=dim)
    return torch.where(any_, idx, default), any_


def _g1(a, k):
    """a[n, k[n]] for (ncol, nk) a and (ncol,) integer k."""
    return torch.gather(a, 1, k[:, None])[:, 0]


def _thes_j(t, p, qs):
    """Traced twin of _thes, the exponent clamped so f32 stays finite
    where qs saturates near the domain top."""
    pi = (P00 / p) ** (0.2854 * (1.0 - 0.28 * qs))
    arg = torch.clamp((C1 / t - C2) * qs * (1.0 + C4 * qs), max=50.0)
    return t * pi * torch.exp(arg)


def _qes_j(t, p):
    es = torch.minimum(ALIQ * torch.exp((BLIQ * t - CLIQ) / (t - DLIQ)),
                       0.5 * p)
    return EP2 * es / (p - es)


def tpmix2dd(tab: KFTables, p, thes):
    """(theta_es, p) → (T, qs) (tpmix2dd, :2357-2402) by bisection on
    [100, 400] K: theta_es(T; p) is monotone in T, so 28 steps give
    ~1e-6 K, branch-free."""
    p, thes = torch.broadcast_tensors(p, thes)
    lo = torch.full_like(thes, 100.0)
    hi = torch.full_like(thes, 400.0)
    for _ in range(28):
        mid = 0.5 * (lo + hi)
        below = _thes_j(mid, p, _qes_j(mid, p)) < thes
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    t1 = 0.5 * (lo + hi)
    return t1, _qes_j(t1, p)


def tpmix2(tab: KFTables, p, thes, qu, qliq, qice):
    """Saturation-point adjustment along constant theta_es (tpmix2,
    :2095-2194). Returns (tu, qu, qliq, qice, qnewlq, qnewic)."""
    temp, qs = tpmix2dd(tab, p, thes)
    dq = qs - qu
    sat = dq <= 0.0
    # supersaturated: condense the excess
    qnew_s = qu - qs
    # subsaturated: evaporate the available condensate
    qtot = qliq + qice
    enough = qtot >= dq
    frac = dq / (qtot + 1.0e-10)
    qliq_e = qliq - frac * qliq
    qice_e = qice - frac * qice
    rll = XLV0 - XLV1 * temp
    cpp = c.cpd * (1.0 + 0.89 * qu)
    none_avail = qtot < 1.0e-10
    temp_n = temp + rll * (dq / (1.0 + dq)) / cpp
    temp_p = temp + rll * ((dq - qtot) / (1.0 + dq - qtot)) / cpp
    temp_u = torch.where(enough, temp,
                         torch.where(none_avail, temp_n, temp_p))
    qu_u = torch.where(enough, qs, torch.where(none_avail, qu, qu + qtot))
    qliq_u = torch.where(enough, qliq_e,
                         torch.where(none_avail, qliq, 0.0))
    qice_u = torch.where(enough, qice_e,
                         torch.where(none_avail, qice, 0.0))
    qnewlq = torch.where(sat, qnew_s, 0.0)
    return (torch.where(sat, temp, temp_u), torch.where(sat, qs, qu_u),
            torch.where(sat, qliq, qliq_u), torch.where(sat, qice, qice_u),
            qnewlq, torch.zeros_like(qnewlq))


def _tdpt_from_e(tab: KFTables, e, t):
    """Dew point and LCL temperature from the vapour pressure (the
    lookup-table dew point of :555-563 and envirtht, the logarithm taken
    directly)."""
    tlog = torch.log(torch.clamp(e / ALIQ, min=1.0e-20))
    tdpt = (CLIQ - DLIQ * tlog) / (BLIQ - tlog)
    tlcl = tdpt - (0.212 + 1.571e-3 * (tdpt - c.tzero)
                   - 4.36e-4 * (t - c.tzero)) * (t - tdpt)
    return torch.minimum(tlcl, t)


def envirtht(tab: KFTables, p, t, q):
    """Environmental theta-e (envirtht, :2404-2431)."""
    ee = q * p / (EP2 + q)
    tsat = _tdpt_from_e(tab, ee, t)
    tht = t * (P00 / p) ** (0.2854 * (1.0 - 0.28 * q))
    return tht * torch.exp((C1 / tsat - C2) * q * (1.0 + C4 * q))


def prof5(eq):
    """Gaussian mixed-fraction integrals → fractional entrainment and
    detrainment rates (prof5, :2322-2355; Kain-Fritsch 1990 Eq. 2)."""
    sqrt2p, a1, a2, a3 = 2.506628, 0.4361836, -0.1201676, 0.9372980
    pcoef, sigma, fe = 0.33267, 0.166666667, 0.202765151
    y = 6.0 * eq - 3.0
    ey = torch.exp(-0.5 * y * y)
    e45 = np.exp(-4.5)
    t2 = 1.0 / (1.0 + pcoef * y.abs())
    t1 = 0.500498
    c1_ = a1 * t1 + a2 * t1 ** 2 + a3 * t1 ** 3
    c2_ = a1 * t2 + a2 * t2 ** 2 + a3 * t2 ** 3
    ee_pos = sigma * (0.5 * (sqrt2p - e45 * c1_ - ey * c2_)
                      + sigma * (e45 - ey)) - e45 * eq * eq * 0.5
    ud_pos = sigma * (0.5 * (ey * c2_ - e45 * c1_)
                      + sigma * (e45 - ey)) \
        - e45 * (0.5 + 0.5 * eq * eq - eq)
    ee_neg = sigma * (0.5 * (ey * c2_ - e45 * c1_)
                      + sigma * (e45 - ey)) - e45 * eq * eq * 0.5
    ud_neg = sigma * (0.5 * (sqrt2p - e45 * c1_ - ey * c2_)
                      + sigma * (e45 - ey)) \
        - e45 * (0.5 + 0.5 * eq * eq - eq)
    pos = y >= 0.0
    return (torch.where(pos, ee_pos, ee_neg) / fe,
            torch.where(pos, ud_pos, ud_neg) / fe)


def condload(qliq, qice, wtw, dz, boterm, enterm, qnewlq, qnewic,
             convrate):
    """Precipitation fallout and the vertical-velocity update (condload,
    :2246-2308; Ogura-Cho 1973 fallout, KF90 Eq. 9)."""
    convfac = 0.4
    qtot = qliq + qice
    qnew = qnewlq + qnewic
    qest = 0.5 * (qtot + qnew)
    g1 = torch.clamp(wtw + boterm - enterm
                     - 2.0 * c.egrav * dz * qest / 1.5, min=0.0)
    wavg = 0.5 * (torch.sqrt(torch.clamp(wtw, min=0.0)) + torch.sqrt(g1))
    conv = convrate * dz / torch.clamp(wavg, min=1e-10)
    ratio3 = qnewlq / torch.clamp(qnew, min=1.0e-8)
    qtot = qtot + (1.0 - convfac) * qnew
    oldq = qtot
    ratio4 = ((1.0 - convfac) * qnewlq + qliq) \
        / torch.clamp(qtot, min=1.0e-8)
    qtot = torch.where(conv > 25.0, 1.0e-8, qtot * torch.exp(-conv))
    dq = oldq - qtot
    qlqout = ratio4 * dq
    qicout = (1.0 - ratio4) * dq
    pptdrg = 0.5 * (oldq + qtot - 0.2 * qnew)
    wtw_n = wtw + boterm - enterm - 2.0 * c.egrav * dz * pptdrg / 1.5
    wtw_n = torch.where(wtw_n.abs() < 1.0e-4, 1.0e-4, wtw_n)
    qliq_n = ratio4 * qtot + ratio3 * convfac * qnew
    qice_n = (1.0 - ratio4) * qtot + (1.0 - ratio3) * convfac * qnew
    return qliq_n, qice_n, wtw_n, qlqout, qicout


def dtfrznew(tu, p, qu, qfrz, qice):
    """Freezing warming and saturation re-adjustment (dtfrznew,
    :2196-2238). Returns (tu, thteu, qu, qice)."""
    rlc = 2.5e6 - 2369.276 * (tu - c.tzero)
    rls = 2833922.0 - 259.532 * (tu - c.tzero)
    rlf = rls - rlc
    cpp = c.cpd * (1.0 + 0.89 * qu)
    a = (CLIQ - BLIQ * DLIQ) / ((tu - DLIQ) * (tu - DLIQ))
    dtfrz = rlf * qfrz / (cpp + rls * qu * a)
    tu = tu + dtfrz
    es = ALIQ * torch.exp((BLIQ * tu - CLIQ) / (tu - DLIQ))
    qs = es * EP2 / (p - es)
    dqevap = qs - qu
    dqevap = torch.where(dqevap > 0.0, torch.minimum(qice, dqevap),
                         torch.maximum(-qu, dqevap))
    qice = qice - dqevap
    qu = qu + dqevap
    pii = (P00 / p) ** (0.2854 * (1.0 - 0.28 * qu))
    thteu = tu * pii * torch.exp((C1 / tu - C2) * qu * (1.0 + C4 * qu))
    return tu, thteu, qu, qice


# ---------------------------------------------------------------------------
# the updraft of every candidate source layer (the usl: loop, :481-1016)
# ---------------------------------------------------------------------------

_PROF_KEYS = ("umf", "uer", "udr", "detlq", "detic", "pptliq", "pptice",
              "qliq", "qice", "qdt", "wu", "tu", "dilfrc", "tvqu",
              "qlqout", "qicout")


def _updraft_candidates(tab, par, t0, q0, qes, z0, p0, dp, w0avg,
                        dx, dxsq):
    """Mixing layer, trigger and full updraft of every candidate source
    layer. Inputs (ncol, nk) bottom-up; returns per-candidate (ncol,
    NCAND[, nk]) fields and masks."""
    ncol, nk = t0.shape
    dev, dtype = t0.device, t0.dtype
    lev = torch.arange(nk, device=dev)
    tv0 = t0 * (1.0 + EP1 * q0)

    # candidate source levels: the surface and the first level above
    # each successive 15 hPa threshold (kcheck, :466-478), limited to
    # p > p_sfc - 300 hPa (llfc)
    thr = p0[:, :1] - 15.0e2 * torch.arange(1, NCAND, device=dev,
                                            dtype=dtype)[None, :]
    below = p0[:, None, :] < thr[:, :, None]       # (ncol, NCAND-1, nk)
    kc_rest, kc_ok = _first_true(below, dim=-1)
    kcand = torch.cat([torch.zeros((ncol, 1), dtype=torch.int64,
                                   device=dev), kc_rest], dim=1)
    p_at = torch.gather(p0, 1, kcand)
    cand_valid = torch.cat([torch.ones((ncol, 1), dtype=torch.bool,
                                       device=dev), kc_ok], dim=1) \
        & (p_at >= p0[:, :1] - 30000.0)

    # ---- 50 hPa mixing layer from each candidate base (:497-527)
    cdp = _lcumsum(dp)
    cdp0 = torch.cat([torch.zeros_like(dp[:, :1]), cdp[:, :-1]], dim=1)
    base = torch.gather(cdp0, 1, kcand)            # Σdp below lc
    depth = cdp[:, None, :] - base[:, :, None]     # (ncol, NCAND, nk)
    above = lev[None, None, :] >= kcand[:, :, None]
    kpbl, has_pbl = _first_true((depth > DPMIN) & above, dim=-1)
    cand_valid = cand_valid & has_pbl
    inmix = above & (lev[None, None, :] <= kpbl[:, :, None])
    wmix = torch.where(inmix, dp[:, None, :], 0.0)
    dpthmx = _lsum(wmix)
    wsum = lambda a: _lsum(wmix * a[:, None, :]) \
        / torch.clamp(dpthmx, min=1e-10)
    tmix, qmix = wsum(t0), wsum(q0)
    zmix, pmix = wsum(z0), wsum(p0)
    emix = qmix * pmix / (EP2 + qmix)

    # ---- LCL (:548-580)
    tlcl = _tdpt_from_e(tab, emix, tmix)
    tvlcl = tlcl * (1.0 + EP1 * qmix)
    zlcl = zmix + (tlcl - tmix) / GDRY
    above_lcl = (z0[:, None, :] >= zlcl[:, :, None]) \
        & (lev[None, None, :] >= kcand[:, :, None])
    klcl, in_dom = _first_true(above_lcl, dim=-1, default=nk - 1)
    klcl = torch.clamp(klcl, min=1)
    cand_valid = cand_valid & in_dom
    kbelow = klcl - 1
    gl = lambda a, k: torch.gather(a, 1, k)
    z_k, z_k1 = gl(z0, kbelow), gl(z0, klcl)
    dlp = (zlcl - z_k) / torch.clamp(z_k1 - z_k, min=1e-10)
    interp = lambda a: gl(a, kbelow) + (gl(a, klcl) - gl(a, kbelow)) * dlp
    tenv = interp(t0)
    qenv = interp(q0)
    tven = tenv * (1.0 + EP1 * qenv)

    # ---- trigger (:586-635): Kain (2004) Eqs. 1-2 and the RH term
    wklcl = torch.where(zlcl < 2.0e3, par.wthreshold * zlcl / 2.0e3,
                        par.wthreshold)
    w_int = interp(w0avg)
    scale = dx / 25.0e3 if dx >= 25.0e3 else 1.0
    wkl = w_int * scale - wklcl
    dtlcl = torch.where(wkl < 1.0e-4, 0.0,
                        4.64 * torch.clamp(wkl, min=1e-30) ** 0.33)
    # trigger 3: the Narita-Ohmori RH perturbation
    qslcl = interp(qes)
    rhlcl = torch.clamp(qenv / torch.clamp(qslcl, min=1e-12), 0.0, 1.0)
    dqssdt = qmix * (CLIQ - BLIQ * DLIQ) / ((tlcl - DLIQ) * (tlcl - DLIQ))
    dtrh = torch.where(
        (rhlcl >= 0.90) & (rhlcl <= 0.95),
        0.25 * (rhlcl - 0.75) * qmix / dqssdt,
        torch.where(rhlcl > 0.95,
                    (1.0 / torch.clamp(rhlcl, min=1e-6) - 1.0)
                    * qmix / dqssdt, 0.0))
    trig = (tlcl + dtlcl + dtrh >= tenv) & cand_valid

    # ---- updraft launch (:643-712)
    theteu0 = envirtht(tab, pmix, tmix, qmix)
    dttot = dtlcl + dtrh
    gdt = 2.0 * c.egrav * dttot * 500.0 / tven
    wlcl = torch.where(dttot > 1.0e-4, torch.clamp(
        1.0 + 0.5 * torch.sqrt(torch.clamp(gdt, min=0.0)), max=3.0), 1.0)
    plcl = interp(p0)
    rholcl = plcl / (c.rgas * tvlcl)
    rad = torch.where(wkl < 0.0, 1000.0,
                      torch.where(wkl > 0.1, 2000.0,
                                  1000.0 + 1000.0 * wkl / 0.1))
    au0 = 0.01 * dxsq
    vmflcl = rholcl * au0

    # the environmental theta-e profile (the entrainment source)
    thetee = envirtht(tab, p0, t0, q0)             # (ncol, nk)

    # ---- the ascent (:705-920): (ncol, NCAND) planes, levels 1..nk-1
    sh = (ncol, NCAND)
    zeros = lambda: torch.zeros(sh, dtype=dtype, device=dev)
    theteu, qu = theteu0, qmix
    qliq_c, qice_c = zeros(), zeros()
    wtw_c = wlcl * wlcl
    umf_c = vmflcl
    dilfrc_prev = torch.ones(sh, dtype=dtype, device=dev)
    ttemp_c = torch.full(sh, TTFRZ, dtype=dtype, device=dev)
    ee1 = torch.ones(sh, dtype=dtype, device=dev)
    ud1, rei_c, abe, trppt = zeros(), zeros(), zeros(), zeros()
    tvqu_prev_c, tvu_prev_c = zeros(), zeros()
    let_c, ltop_c = klcl, klcl
    stopped = torch.zeros(sh, dtype=torch.bool, device=dev)
    upold_last = vmflcl
    profs = {k: torch.zeros(sh + (nk,), dtype=dtype, device=dev)
             for k in _PROF_KEYS}
    # the two trial mixes of each level (0.95 and 0.10 environment) are
    # one batch
    trials = ((0.95, 1.0 - 0.95), (0.10, 1.0 - 0.10))
    mix2 = lambda env, upd: torch.stack([f1 * env + f2 * upd
                                         for f1, f2 in trials])
    part2 = lambda upd: torch.stack([f2 * upd for _, f2 in trials])

    for nk1 in range(1, nk):
        active = (nk1 > kbelow) & trig & ~stopped
        first = nk1 == klcl
        pnk1 = p0[:, nk1, None]
        tv0k = tv0[:, nk1, None]
        q0k = q0[:, nk1, None]
        tu, qu_n, qliq, qice, qnewlq, qnewic = tpmix2(
            tab, pnk1, theteu, qu, qliq_c, qice_c)
        th_u = theteu
        # freezing interval (:726-760)
        frz = tu <= TTFRZ
        ttemp_eff = torch.clamp(ttemp_c, max=TTFRZ)
        frc1 = torch.where(
            tu > TBFRZ,
            (ttemp_eff - tu) / torch.clamp(ttemp_eff - TBFRZ, min=1e-10),
            1.0)
        frc1 = torch.where(frz, torch.clamp(frc1, 0.0, 1.0), 0.0)
        qfrz = (qliq + qnewlq) * frc1
        qnewic_f = qnewic + qnewlq * frc1
        qnewlq_f = qnewlq - qnewlq * frc1
        qice_f = qice + qliq * frc1
        qliq_f = qliq - qliq * frc1
        tu_f, theteu_f, qu_f, qice_f2 = dtfrznew(tu, pnk1, qu_n, qfrz,
                                                 qice_f)
        tu = torch.where(frz, tu_f, tu)
        th_u = torch.where(frz, theteu_f, th_u)
        qu_n = torch.where(frz, qu_f, qu_n)
        qliq = torch.where(frz, qliq_f, qliq)
        qice = torch.where(frz, qice_f2, qice)
        qnewlq = torch.where(frz, qnewlq_f, qnewlq)
        qnewic = torch.where(frz, qnewic_f, qnewic)
        ttemp = torch.where(frz, tu, ttemp_c)
        tvu = tu * (1.0 + EP1 * qu_n)
        # buoyancy term (:764-775)
        z_nk = torch.where(first, zlcl, z0[:, nk1 - 1, None])
        dzz = z0[:, nk1, None] - z_nk
        tvu_prev = torch.where(first, tvlcl, tvu_prev_c)
        tv0_prev = torch.where(first, tven, tv0[:, nk1 - 1, None])
        be = (tvu_prev + tvu) / (tv0_prev + tv0k) - 1.0
        boterm = 2.0 * dzz * c.egrav * be / 1.5
        enterm = 2.0 * rei_c * wtw_c / torch.clamp(upold_last, min=1e-10)
        qliq, qice, wtw, qlqout, qicout = condload(
            qliq, qice, wtw_c, dzz, boterm, enterm, qnewlq, qnewic,
            par.convrate)
        # the vertical-velocity exit (:781-787)
        stop_w = wtw < 1.0e-3
        wu = torch.sqrt(torch.clamp(wtw, min=0.0))
        # entrainment rate (:795-799)
        rei = vmflcl * dp[:, nk1, None] * par.entrate / rad
        tvqu = tu * (1.0 + EP1 * qu_n - qliq - qice)
        tvqu_prev = torch.where(first, tvlcl, tvqu_prev_c)
        dilbe = torch.where(
            first, ((tvlcl + tvqu) / (tven + tv0k) - 1.0) * dzz,
            ((tvqu_prev + tvqu) / (tv0_prev + tv0k) - 1.0) * dzz)
        abe_inc = torch.where(dilbe > 0.0, dilbe * c.egrav, 0.0)
        # entrainment/detrainment fractions (:807-877): the critical
        # mixed fraction from two trial mixes
        neg_buoy = tvqu <= tv0k
        ttmp, qtmp2, tl2, ti2, _, _ = tpmix2(
            tab, pnk1, mix2(thetee[:, nk1, None], th_u), mix2(q0k, qu_n),
            part2(qliq), part2(qice))
        tu_tr = ttmp * (1.0 + EP1 * qtmp2 - tl2 - ti2)
        tu95, tu10 = tu_tr[0], tu_tr[1]
        eqfrc = (tv0k - tvqu) * 0.10 \
            / torch.where((tu10 - tvqu).abs() < 1e-30, 1e-30, tu10 - tvqu)
        eqfrc = torch.clamp(eqfrc, 0.0, 1.0)
        ee2_g, ud2_g = prof5(torch.clamp(eqfrc, 1e-6, 1.0 - 1e-6))
        tiny = 1e-30
        small = (tu10 - tvqu).abs() < 1.0e-3
        ee2 = torch.where(
            neg_buoy, 0.5, torch.where(
                tu95 > tv0k, 1.0, torch.where(
                    small, 1.0, torch.where(
                        1.0 - eqfrc < tiny, 1.0,
                        torch.where(eqfrc < tiny, 0.0, ee2_g)))))
        ud2 = torch.where(
            neg_buoy, 1.0, torch.where(
                tu95 > tv0k, 0.0, torch.where(
                    small, 0.0, torch.where(
                        1.0 - eqfrc < tiny, 0.0,
                        torch.where(eqfrc < tiny, 1.0, ud2_g)))))
        let = torch.where(active & ~stop_w & ~neg_buoy, nk1, let_c)
        ee2 = torch.clamp(ee2, min=0.5)
        ud2 = 1.5 * ud2
        uer = 0.5 * rei * (ee1 + ee2)
        udr = 0.5 * rei * (ud1 + ud2)
        # the total-detrainment exit (:883-895)
        stop_d = (umf_c - udr) < 10.0
        upold = umf_c - udr
        upnew = upold + uer
        dilfrc = upnew / torch.clamp(upold, min=1e-10)
        rup = torch.clamp(upnew, min=1e-10)
        qu_dil = (upold * qu_n + uer * q0k) / rup
        theteu_dil = (th_u * upold + thetee[:, nk1, None] * uer) / rup
        qliq_dil = qliq * upold / rup
        qice_dil = qice * upold / rup
        pptliq = qlqout * umf_c
        pptice = qicout * umf_c
        # source-layer inflow (:916)
        uer_ex = torch.where(nk1 <= kpbl,
                             uer + vmflcl * dp[:, nk1, None] / dpthmx, uer)
        # the abe correction on the total-detrainment exit (:888-891)
        abe_new = abe + torch.where(stop_d, 0.0, abe_inc)
        # updates only while active and not exiting
        ok = active & ~stop_w & ~stop_d
        upd = lambda new, old: torch.where(ok, new, old)
        outs = dict(
            umf=upd(upnew, 0.0), uer=upd(uer_ex, 0.0), udr=upd(udr, 0.0),
            # detrainment carries the PRE-dilution condensate (:904-906)
            detlq=upd(qliq * udr, 0.0), detic=upd(qice * udr, 0.0),
            pptliq=upd(pptliq, 0.0), pptice=upd(pptice, 0.0),
            qliq=upd(qliq_dil, 0.0), qice=upd(qice_dil, 0.0),
            qdt=upd(qu_n, 0.0), wu=upd(wu, 0.0),
            tu=torch.where(active, tu, 0.0),
            dilfrc=torch.where(ok, dilfrc, 1.0),
            tvqu=torch.where(active, tvqu, 0.0),
            qlqout=upd(qlqout, 0.0), qicout=upd(qicout, 0.0))
        for k, v in outs.items():
            profs[k][:, :, nk1] = v
        theteu = upd(theteu_dil, theteu)
        qu = upd(qu_dil, qu)
        qliq_c = upd(qliq_dil, qliq_c)
        qice_c = upd(qice_dil, qice_c)
        wtw_c = upd(wtw, wtw_c)
        umf_c = upd(upnew, umf_c)
        dilfrc_prev = upd(dilfrc, dilfrc_prev)
        ttemp_c = upd(ttemp, ttemp_c)
        ee1 = upd(ee2, ee1)
        ud1 = upd(ud2, ud1)
        rei_c = upd(rei, rei_c)
        abe = torch.where(active, abe_new, abe)
        trppt = upd(trppt + pptliq + pptice, trppt)
        tvqu_prev_c = upd(tvqu, tvqu_prev_c)
        tvu_prev_c = upd(tvu, tvu_prev_c)
        let_c = torch.where(active, let, let_c)
        # on exit ltop is the previous level; on running levels it
        # tracks nk1, so a full-loop finish keeps the last level
        ltop_c = torch.where(active & (stop_w | stop_d), nk1 - 1,
                             torch.where(ok, nk1, ltop_c))
        stopped = stopped | (active & (stop_w | stop_d))
        upold_last = upd(upnew, upold_last)

    fcarry = dict(let=let_c, ltop=ltop_c, abe=abe, trppt=trppt,
                  dilfrc_prev=dilfrc_prev)
    return dict(
        profs=profs, fcarry=fcarry, trig=trig, kcand=kcand,
        kpbl=kpbl, klcl=klcl, kbelow=kbelow, tlcl=tlcl, tvlcl=tvlcl,
        zlcl=zlcl, plcl=plcl, tmix=tmix, qmix=qmix, zmix=zmix, pmix=pmix,
        dpthmx=dpthmx, vmflcl=vmflcl, wlcl=wlcl, tven=tven, wkl=wkl,
        inmix=inmix)


# ---------------------------------------------------------------------------
# candidate selection and the single-column profiles (:922-1016)
# ---------------------------------------------------------------------------

def _select_candidates(cand, z0, par):
    """First deep candidate wins, else the deepest shallow one; every
    per-candidate field is gathered at the winner."""
    profs, fc = cand["profs"], cand["fcarry"]
    ncol, nk = z0.shape
    ltop, let, abe = fc["ltop"], fc["let"], fc["abe"]
    cldhgt = torch.gather(z0, 1, ltop) - cand["zlcl"]
    tlcl = cand["tlcl"]
    chmin = torch.where(tlcl > 293.0, 4.0e3,
                        torch.where(tlcl >= 273.0,
                                    2.0e3 + 100.0 * (tlcl - 273.0), 2.0e3))
    # no-convection conditions (:966-985)
    no_conv = (ltop <= cand["klcl"]) | (ltop <= cand["kpbl"]) \
        | (let + 1 <= cand["kpbl"]) | ~cand["trig"]
    deep = ~no_conv & (cldhgt > chmin) & (abe > 1.0)
    shal = ~no_conv & ~deep & (cldhgt > 0.0)
    cldhgt_s = torch.where(shal, cldhgt, -1.0)

    deep_c, has_deep = _first_true(deep, dim=1)
    shal_c = torch.argmax(cldhgt_s, dim=1)
    has_shal = shal.any(dim=1)
    ishall = ~has_deep & has_shal
    active = has_deep | has_shal
    chosen = torch.where(has_deep, deep_c, shal_c)[:, None]

    idx3 = chosen[:, :, None].expand(ncol, 1, nk)
    sel = {k: torch.gather(v, 1, idx3)[:, 0] for k, v in profs.items()}
    g1 = lambda a: torch.gather(a, 1, chosen)[:, 0]
    scal = dict(
        ltop=g1(ltop), let=g1(let), abe=g1(abe), trppt=g1(fc["trppt"]),
        klcl=g1(cand["klcl"]), kpbl=g1(cand["kpbl"]),
        lc=g1(cand["kcand"]), kbelow=g1(cand["kbelow"]),
        tlcl=g1(tlcl), tvlcl=g1(cand["tvlcl"]),
        zlcl=g1(cand["zlcl"]), plcl=g1(cand["plcl"]),
        tmix=g1(cand["tmix"]), qmix=g1(cand["qmix"]),
        zmix=g1(cand["zmix"]), pmix=g1(cand["pmix"]),
        dpthmx=g1(cand["dpthmx"]), vmflcl=g1(cand["vmflcl"]),
        wlcl=g1(cand["wlcl"]), tven=g1(cand["tven"]),
        wkl=g1(cand["wkl"]), cldhgt=g1(cldhgt),
        dilfrc_last=g1(fc["dilfrc_prev"]),
        ishall=ishall, active=active, has_deep=has_deep)
    sel_inmix = torch.gather(cand["inmix"], 1, idx3)[:, 0]
    return sel, scal, sel_inmix


def _adjust_let(sel, scal, dp):
    """The mass-flux taper between LET and the cloud top (:1025-1077)."""
    nk = dp.shape[1]
    lev = torch.arange(nk, device=dp.device)[None, :]
    let = scal["let"][:, None]
    ltop = scal["ltop"][:, None]
    umf, udr, uer = sel["umf"], sel["udr"], sel["uer"]
    detlq, detic = sel["detlq"], sel["detic"]
    qliq, qice = sel["qliq"], sel["qice"]
    dilfrc = sel["dilfrc"]
    pptliq, pptice = sel["pptliq"], sel["pptice"]
    qlqout, qicout = sel["qlqout"], sel["qicout"]
    trppt = scal["trppt"]

    same = scal["let"] == scal["ltop"]
    # let == ltop: full detrainment at ltop (:1028-1033)
    at_s = (lev == ltop) & same[:, None]
    g_ltop = lambda a: _g1(a, scal["ltop"])
    udr_lt = g_ltop(umf) + g_ltop(udr) - g_ltop(uer)
    dil_lt = scal["dilfrc_last"]
    udr_s = torch.where(at_s, udr_lt[:, None], udr)
    detlq_s = torch.where(at_s, (g_ltop(qliq) * udr_lt * dil_lt)[:, None]
                          * torch.ones_like(udr), detlq)
    detic_s = torch.where(at_s, (g_ltop(qice) * udr_lt * dil_lt)[:, None]
                          * torch.ones_like(udr), detic)
    uer_s = torch.where(at_s, 0.0, uer)
    umf_s = torch.where(at_s, 0.0, umf)

    # let < ltop: linear taper (:1037-1076)
    span = (lev > let) & (lev <= ltop)
    dp_span = torch.where(span, dp, 0.0)
    dptt = _lsum(dp_span)
    umf_let = _g1(umf, scal["let"])
    dumfdp = umf_let / torch.clamp(dptt, min=1e-10)
    cdp_span = _lcumsum(dp_span)
    umf_t = umf_let[:, None] - cdp_span * dumfdp[:, None]
    # the previous level's tapered umf: umf(let) at the first span level
    umf_tm1 = umf_let[:, None] - (cdp_span - dp) * dumfdp[:, None]
    taper = ~same[:, None]
    in_body = taper & span & (lev < ltop)
    at_top = taper & span & (lev == ltop)
    uer_t = umf_t * (1.0 - 1.0 / torch.clamp(dilfrc, min=1e-10))
    udr_t = umf_tm1 - umf_t + uer_t
    umf_n = torch.where(in_body, umf_t, torch.where(at_top, 0.0, umf_s))
    uer_n = torch.where(in_body, uer_t, torch.where(at_top, 0.0, uer_s))
    udr_n = torch.where(in_body, udr_t,
                        torch.where(at_top, umf_tm1, udr_s))
    detlq_n = torch.where(taper & span, udr_n * qliq * dilfrc, detlq_s)
    detic_n = torch.where(taper & span, udr_n * qice * dilfrc, detic_s)
    # the precipitation re-derived for nk >= let+2 (:1070-1075)
    refl = span & (lev >= let + 2)
    ppl_new = torch.where(refl, umf_tm1 * qlqout, pptliq)
    ppi_new = torch.where(refl, umf_tm1 * qicout, pptice)
    trppt_n = torch.where(
        same, trppt,
        trppt + _lsum(torch.where(refl, (ppl_new - pptliq)
                                  + (ppi_new - pptice), 0.0)))
    out = dict(sel)
    out.update(umf=umf_n, uer=uer_n, udr=udr_n, detlq=detlq_n,
               detic=detic_n,
               pptliq=torch.where(taper & refl, ppl_new, pptliq),
               pptice=torch.where(taper & refl, ppi_new, pptice))
    return out, trppt_n


# ---------------------------------------------------------------------------
# below/above-cloud profiles, the time scale and the precipitation
# efficiency (:1081-1232)
# ---------------------------------------------------------------------------

def _init_profiles(tab, sel, scal, t0, q0, p0, z0, dp, wspd, l5, dx,
                   par):
    nk = t0.shape[1]
    lev = torch.arange(nk, device=t0.device)[None, :]
    lc = scal["lc"][:, None]
    kpbl = scal["kpbl"][:, None]
    ltop = scal["ltop"][:, None]
    vmflcl = scal["vmflcl"][:, None]

    # below the cloud base: the source-layer buildup (:1085-1110)
    frac = vmflcl * dp / scal["dpthmx"][:, None]
    in_src = (lev >= lc) & (lev <= kpbl)
    cum_src = _lcumsum(torch.where(in_src, frac, 0.0))
    sub = lev <= scal["kbelow"][:, None]
    umf_b = torch.where(in_src, cum_src,
                        torch.where((lev > kpbl) & sub, vmflcl, 0.0))
    uer_b = torch.where(in_src, frac, 0.0)
    tu_b = scal["tmix"][:, None] + (z0 - scal["zmix"][:, None]) * GDRY
    qu_b = scal["qmix"][:, None] * torch.ones_like(t0)
    wu_b = scal["wlcl"][:, None] * torch.ones_like(t0)
    up = lev >= lc

    umf = torch.where(sub, umf_b, sel["umf"])
    uer = torch.where(sub, uer_b, sel["uer"])
    udr = torch.where(sub, 0.0, sel["udr"])
    tu = torch.where(sub, torch.where(up, tu_b, 0.0), sel["tu"])
    qu = torch.where(sub, torch.where(up, qu_b, 0.0), sel["qdt"])
    wu = torch.where(sub, torch.where(up, wu_b, 0.0), sel["wu"])
    zsub = lambda k: torch.where(sub, 0.0, sel[k])
    qdt, qliq, qice = zsub("qdt"), zsub("qliq"), zsub("qice")
    qlqout, qicout = zsub("qlqout"), zsub("qicout")
    detlq, detic = zsub("detlq"), zsub("detic")
    pptliq, pptice = zsub("pptliq"), zsub("pptice")
    dilfrc = torch.where(sub, 1.0, sel["dilfrc"])

    # above the cloud top: everything zero (:1126-1162)
    abv = lev > ltop
    zab = lambda a: torch.where(abv, 0.0, a)
    umf, uer, udr, qdt = zab(umf), zab(uer), zab(udr), zab(qdt)
    qliq, qice, qlqout, qicout = zab(qliq), zab(qice), zab(qlqout), \
        zab(qicout)
    detlq, detic, pptliq, pptice = zab(detlq), zab(detic), zab(pptliq), \
        zab(pptice)
    abv1 = lev > ltop + 1
    tu = torch.where(abv1, 0.0, tu)
    qu = torch.where(abv1, 0.0, qu)
    wu = torch.where(abv1, 0.0, wu)

    # energies and potential temperatures (:1164-1178)
    ems = dp * (dx * dx) / c.egrav
    emsd = 1.0 / ems
    thtau = tu * (P00 / p0) ** (0.2854 * (1.0 - 0.28 * qdt))
    thta0 = t0 * (P00 / p0) ** (0.2854 * (1.0 - 0.28 * q0))
    ddilfrc = 1.0 / torch.clamp(dilfrc, min=1e-10)
    thetee = envirtht(tab, p0, t0, q0)

    # the convective time scale (:1182-1200)
    vconv = 0.5 * (_g1(wspd, scal["klcl"]) + _g1(wspd, l5))
    timec = dx / torch.clamp(vconv, min=1e-3)
    tadvec = timec
    timec = torch.clamp(timec, par.min_dtcape, par.max_dtcape)
    timec = torch.where(scal["ishall"], 600.0, timec)

    # the precipitation efficiency (:1204-1232)
    wspd_top = _g1(wspd, scal["ltop"])
    wspd_lcl = _g1(wspd, scal["klcl"])
    shsign = torch.where(wspd_top > wspd_lcl, 1.0, -1.0)
    du = _g1(sel["u0"], scal["ltop"]) - _g1(sel["u0"], scal["klcl"])
    dv = _g1(sel["v0"], scal["ltop"]) - _g1(sel["v0"], scal["klcl"])
    z_top = _g1(z0, scal["ltop"])
    z_lcl = _g1(z0, scal["klcl"])
    vws = 1.0e3 * shsign * torch.sqrt(du * du + dv * dv) \
        / torch.clamp(z_top - z_lcl, min=1.0)
    pef = 1.591 + vws * (-0.639 + vws * (9.53e-2 - vws * 4.96e-3))
    pef = torch.clamp(pef, par.min_pef, par.max_pef)
    cbh = (scal["zlcl"] - z0[:, 0]) * 3.281e-3
    rcbh = torch.where(
        cbh < 3.0, 0.02,
        0.96729352 + cbh * (-0.70034167 + cbh * (0.162179896
            + cbh * (-1.2569798e-2 + cbh * (4.2772e-4
                                            - cbh * 5.44e-6)))))
    rcbh = torch.where(cbh > 25.0, 2.4, rcbh)
    pefcbh = torch.clamp(1.0 / (1.0 + rcbh), par.min_pef, par.max_pef)
    peff = 0.5 * (pef + pefcbh)

    return dict(umf=umf, uer=uer, udr=udr, tu=tu, qu=qu, wu=wu,
                qdt=qdt, qliq=qliq, qice=qice, qlqout=qlqout,
                qicout=qicout, detlq=detlq, detic=detic,
                pptliq=pptliq, pptice=pptice, dilfrc=dilfrc,
                ddilfrc=ddilfrc, ems=ems, emsd=emsd, thtau=thtau,
                thta0=thta0, thetee=thetee, timec=timec,
                tadvec=tadvec, peff=peff, intop=lev <= ltop)


# ---------------------------------------------------------------------------
# the downdraft (:1236-1445)
# ---------------------------------------------------------------------------

def _downdraft(tab, prof, scal, t0, q0, qes, p0, z0, dp, rh, tv0,
               dx, par, peff, au0):
    ncol, nk = t0.shape
    dev = t0.device
    lev = torch.arange(nk, device=dev)[None, :]
    deep = scal["active"] & ~scal["ishall"]
    kstart = scal["kpbl"] + 1
    let = scal["let"]
    # LFS: the first level above kstart with p(kstart) - p > dpp hPa
    g1s = lambda a, k: _g1(a, torch.clamp(k, 0, nk - 1))
    p_ks = g1s(p0, kstart)
    above = (lev > kstart[:, None]) \
        & ((p_ks[:, None] - p0) > par.dpp * 100.0)
    klfs0, found = _first_true(above, dim=1, default=nk - 1)
    klfs = torch.where(found, klfs0, let - 1)
    lfs = torch.clamp(torch.minimum(klfs, let - 1), 0, nk - 1)
    has_dd = deep & ((p_ks - g1s(p0, lfs)) > 50.0e2)

    # the initial downdraft at the LFS (:1263-1283)
    thetee = prof["thetee"]
    theted_lfs = g1s(thetee, lfs)
    tz_lfs, qss_lfs = tpmix2dd(tab, g1s(p0, lfs), theted_lfs)
    tvd_lfs = tz_lfs * (1.0 + EP1 * qss_lfs)
    rdd = g1s(p0, lfs) / (c.rgas * tvd_lfs)
    a1 = (1.0 - peff) * au0
    dmf_lfs = -a1 * rdd
    ems = prof["ems"]
    ems_lfs = g1s(ems, lfs)

    # the downward mixing from nk-2 to 0, active in [kstart, lfs-1]
    dmf = dmf_lfs
    theted = theted_lfs
    qd = g1s(q0, lfs)
    rhbar = torch.where(has_dd, g1s(rh, lfs) * g1s(dp, lfs), 0.0)
    dptt = torch.where(has_dd, g1s(dp, lfs), 0.0)
    der_prof = torch.zeros_like(t0)
    dmf_mix = torch.zeros_like(t0)
    for nd in range(nk - 2, -1, -1):
        act = has_dd & (nd >= kstart) & (nd < lfs)
        der_nd = dmf_lfs * ems[:, nd] / torch.clamp(ems_lfs, min=1e-10)
        dmf_nd = dmf + der_nd
        rdmf = torch.where(dmf_nd.abs() < 1e-10, 1e-10, dmf_nd)
        theted_nd = (theted * dmf + thetee[:, nd] * der_nd) / rdmf
        qd_nd = (qd * dmf + q0[:, nd] * der_nd) / rdmf
        rhbar = rhbar + torch.where(act, rh[:, nd] * dp[:, nd], 0.0)
        dptt = dptt + torch.where(act, dp[:, nd], 0.0)
        dmf = torch.where(act, dmf_nd, dmf)
        theted = torch.where(act, theted_nd, theted)
        qd = torch.where(act, qd_nd, qd)
        der_prof[:, nd] = torch.where(act, der_nd, 0.0)
        dmf_mix[:, nd] = torch.where(act, dmf_nd, 0.0)
    at_lfs = lev == lfs[:, None]
    der_prof = torch.where(at_lfs, dmf_lfs[:, None], der_prof)
    rhbar = rhbar / torch.clamp(dptt, min=1e-10)
    dmffrc = 2.0 * (1.0 - rhbar)                 # Kain (2004) Eq. 11

    # melting of the frozen precipitation (:1300-1317)
    in_cld = (lev >= scal["klcl"][:, None]) & (lev <= scal["ltop"][:, None])
    pptmlt = _lsum(torch.where(in_cld, prof["pptice"], 0.0))
    umf_klcl = g1s(prof["umf"], scal["klcl"])
    # ml: the highest level below ltop with t0 > 0C
    warm = (t0 > c.tzero) & (lev <= scal["ltop"][:, None])
    ml = torch.where(warm.any(dim=1),
                     (nk - 1) - torch.argmax(torch.flip(warm, [1]).to(
                         torch.int32), dim=1), -1)
    dtmelt = torch.where(scal["lc"] < ml,
                         c.wlhf * pptmlt
                         / (c.cpd * torch.clamp(umf_klcl, min=1e-10)), 0.0)
    tz_ks, _ = tpmix2dd(tab, p_ks, theted)
    tz_ks = tz_ks - dtmelt
    es_ks = ALIQ * torch.exp((BLIQ * tz_ks - CLIQ) / (tz_ks - DLIQ))
    qss_ks = EP2 * es_ks / (p_ks - es_ks)
    theted_ks = tz_ks * (P00 / p_ks) ** (0.2854 * (1.0 - 0.28 * qss_ks)) \
        * torch.exp((C1 / tz_ks - C2) * qss_ks * (1.0 + C4 * qss_ks))

    # the descending wet-bulb search LDT → LDB (:1318-1360); the
    # saturation point of theted_ks and the RH adjustment of every level
    # are one batch, the search a loop over the levels
    ldt = torch.minimum(lfs - 1, kstart - 1)
    z_ks = g1s(z0, kstart)
    tz_all, qss = tpmix2dd(tab, p0, theted_ks[:, None])
    rhh = 1.0 - 0.2e-3 * (z_ks[:, None] - z0)
    # adjust to the specified RH (:1335-1353)
    dssdt = (CLIQ - BLIQ * DLIQ) / ((tz_all - DLIQ) ** 2)
    rl = XLV0 - XLV1 * tz_all
    dtmp = rl * qss * (1.0 - rhh) / (c.cpd + rl * rhh * qss * dssdt)
    t1rh = tz_all + dtmp
    es_rh = rhh * ALIQ * torch.exp((BLIQ * t1rh - CLIQ) / (t1rh - DLIQ))
    qsrh = EP2 * es_rh / (p0 - es_rh)
    too_dry = qsrh < qd[:, None]
    qsrh_f = torch.where(too_dry, qd[:, None], qsrh)
    t1rh_f = torch.where(too_dry, tz_all + (qss - qsrh_f) * rl / c.cpd,
                         t1rh)
    adj = rhh < 1.0
    tz_f = torch.where(adj, t1rh_f, tz_all)
    qss_f = torch.where(adj, qsrh_f, qss)
    tvd = tz_f * (1.0 + EP1 * qss_f)
    found = ~has_dd
    ldb = torch.zeros((ncol,), dtype=torch.int64, device=dev)
    dpdd = torch.zeros_like(t0[:, 0])
    tz_prof = torch.zeros_like(t0)
    qsd_prof = torch.zeros_like(t0)
    for nd in range(nk - 2, -1, -1):
        searching = has_dd & (nd <= ldt) & ~found
        is_ldb = searching & ((tvd[:, nd] > tv0[:, nd]) | (nd == 0))
        dpdd = dpdd + torch.where(searching, dp[:, nd], 0.0)
        found = found | is_ldb
        ldb = torch.where(is_ldb, nd, ldb)
        tz_prof[:, nd] = torch.where(searching, tz_f[:, nd], 0.0)
        qsd_prof[:, nd] = torch.where(searching, qss_f[:, nd], 0.0)
    deep_enough = has_dd & ((g1s(p0, ldb) - g1s(p0, lfs)) > 50.0e2)

    # the detrainment leg LDT → LDB (:1361-1372): the kstart downdraft
    # mass detrains fully over [ldb, ldt] (:1363-1366)
    in_dd = (lev >= ldb[:, None]) & (lev <= ldt[:, None]) \
        & deep_enough[:, None]
    ddr_prof = torch.where(in_dd, -dmf[:, None] * dp
                           / torch.clamp(dpdd, min=1e-10)[:, None], 0.0)
    tder = _lsum(torch.where(in_dd, (qsd_prof - qd[:, None]) * ddr_prof,
                             0.0))
    # the dmf profile: the mixing leg, and below ldt the kstart value
    # plus the detrainment accumulated from above
    dmf_prof = torch.where(at_lfs, dmf_lfs[:, None], dmf_mix)
    dmf_prof = torch.where(in_dd, dmf[:, None] + _rcumsum(ddr_prof),
                           dmf_prof)
    qd_prof = torch.where(in_dd, qsd_prof, qd[:, None])
    thtad_prof = torch.where(
        in_dd, tz_prof * (P00 / p0) ** (0.2854 * (1.0 - 0.28 * qd_prof)),
        0.0)
    return dict(lfs=lfs, ldb=ldb, ldt=ldt, kstart=kstart, tder=tder,
                dmffrc=dmffrc, deep_enough=deep_enough, dmf=dmf_prof,
                der=der_prof, ddr=ddr_prof, qd=qd_prof, thtad=thtad_prof,
                tz=tz_prof, dmf_kstart=dmf, umf_klcl=umf_klcl, ml=ml)


# ---------------------------------------------------------------------------
# compensating-subsidence advection (one pass, masked substeps)
# ---------------------------------------------------------------------------

def _advect(fields, srcs, fxm, nstep, dtime, emsd, intop):
    """Upstream forward-in-time advection of a stack of level fields
    (nf, ncol, nk) with per-level sources (:1516-1553): NSTEPMAX masked
    substeps, each column running its own nstep."""
    down = fxm <= 0.0
    dtc = dtime[:, None]
    zcol = torch.zeros_like(fields[..., :1])
    f = fields
    for it in range(NSTEPMAX):
        run = ((it < nstep)[:, None] & intop)
        # the flux through the bottom interface of level k (k >= 1)
        f_dn = torch.cat([zcol, f[..., :-1]], dim=-1)
        flux_bot = torch.where(down, -fxm * f_dn, -fxm * f)
        flux_bot = torch.cat([zcol, flux_bot[..., 1:]], dim=-1)
        flux_top = torch.cat([flux_bot[..., 1:], zcol], dim=-1)
        fn = f + (flux_bot - flux_top + srcs) * dtc * emsd
        f = torch.where(run, fn, f)
    return f


def _borrow_moisture(qg, ems, emsd, ltop, klcl):
    """The qg<0 fix: borrow from the neighbours (:1557-1603)."""
    ncol, nk = qg.shape
    qg = qg.clone()
    lev = torch.arange(nk, device=qg.device)[None, :]
    for nkv in range(1, nk):
        neg = (qg[:, nkv] < 0.0) & (nkv <= ltop)
        nk1 = torch.where(nkv == ltop, klcl, min(nkv + 1, nk - 1))
        tma = _g1(qg, nk1) * _g1(ems, nk1)
        tmb = qg[:, nkv - 1] * ems[:, nkv - 1]
        tmm = (qg[:, nkv] - 1.0e-9) * ems[:, nkv]
        rtmb = torch.where(tmb.abs() < 1e-30, 1e-30, tmb)
        bco = -tmm / ((tma * tma) / rtmb + tmb)
        aco = bco * tma / rtmb
        tmb_n = tmb * (1.0 - bco)
        tma_n = tma * (1.0 - aco)
        qg[:, nkv] = torch.where(neg, 1.0e-9, qg[:, nkv])
        new_nk1 = torch.where(neg, tma_n * _g1(emsd, nk1), _g1(qg, nk1))
        qg = torch.where((lev == nk1[:, None]) & neg[:, None],
                         new_nk1[:, None], qg)
        qg[:, nkv - 1] = torch.where(neg, tmb_n * emsd[:, nkv - 1],
                                     qg[:, nkv - 1])
    return qg


class KFOut(NamedTuple):
    dtdt: torch.Tensor       # (ncol, nk) K/s, bottom-up
    dqdt: torch.Tensor       # qv tendency
    dqcdt: torch.Tensor
    dqidt: torch.Tensor
    dqrdt: torch.Tensor
    dqsdt: torch.Tensor
    prate: torch.Tensor      # (ncol,) kg/m²/s
    cldfra: torch.Tensor     # (ncol, nk)
    conv_ppt: torch.Tensor   # (ncol, nk) precipitation generation
    ktop: torch.Tensor
    kbot: torch.Tensor
    ishall: torch.Tensor
    active: torch.Tensor
    timec: torch.Tensor      # CAPE-removal time scale (s)


def kfpara(tab: KFTables, par: KFParams, t0, q0, u0, v0, z0, p0,
           rho, dzq, w0avg, tke, ql0, qi0, dt, dx, f_qi: bool):
    """The KF column physics, dense over (ncol, nk) bottom-up columns
    (kfpara, :344-2093)."""
    ncol, nk = t0.shape
    dtype, dev = t0.dtype, t0.device
    dxsq = dx * dx
    lev = torch.arange(nk, device=dev)[None, :]

    # saturation and input conditioning (kfdrv :205-212)
    es = ALIQ * torch.exp((BLIQ * t0 - CLIQ) / (t0 - DLIQ))
    qes = EP2 * es / (p0 - es)
    q0 = torch.minimum(torch.clamp(q0, min=1.0e-6), qes)
    rh01 = torch.clamp(q0 / qes, 0.0, 1.0)
    tv0 = t0 * (1.0 + EP1 * q0)
    dp = rho * c.egrav * dzq
    wspd = torch.sqrt(u0 * u0 + v0 * v0)
    # l5: the last level with p >= p_sfc/2
    l5 = torch.clamp((p0 >= 0.5 * p0[:, :1]).sum(dim=1) - 1, min=0)

    # ---- candidate updrafts and the selection
    cand = _updraft_candidates(tab, par, t0, q0, qes, z0, p0, dp, w0avg,
                               dx, dxsq)
    sel, scal, inmix = _select_candidates(cand, z0, par)
    # shallow: let = kstart = max(kpbl, klcl) (:1018-1021)
    scal["let"] = torch.where(scal["ishall"],
                              torch.maximum(scal["kpbl"], scal["klcl"]),
                              scal["let"])
    sel["u0"], sel["v0"] = u0, v0

    sel2, trppt = _adjust_let(sel, scal, dp)
    scal["trppt"] = trppt
    prof = _init_profiles(tab, sel2, scal, t0, q0, p0, z0, dp, wspd, l5,
                          dx, par)
    timec = prof["timec"]
    nic = torch.clamp(torch.round(timec / dt).to(torch.int64), min=1)
    timec = nic.to(dtype) * dt
    peff = prof["peff"]

    dd = _downdraft(tab, prof, scal, t0, q0, qes, p0, z0, dp, rh01, tv0,
                    dx, par, peff, 0.01 * dxsq)

    # ---- the downdraft strength (d_mf, :1379-1445)
    no_dd = dd["tder"] < 1.0
    ddinc = -dd["dmffrc"] * dd["umf_klcl"] / torch.where(
        dd["dmf_kstart"].abs() < 1e-10, -1e-10, dd["dmf_kstart"])
    ddinc = torch.where(dd["tder"] * ddinc > scal["trppt"],
                        scal["trppt"] / torch.clamp(dd["tder"], min=1e-10),
                        ddinc)
    ddinc = torch.where(no_dd, 0.0, ddinc)
    tder = torch.where(no_dd, 0.0, dd["tder"] * ddinc)
    # downdrafts only inside [ldb, lfs] (:1418-1436)
    in_dd_span = (lev >= dd["ldb"][:, None]) & (lev <= dd["lfs"][:, None])
    dmf = torch.where(in_dd_span, dd["dmf"] * ddinc[:, None], 0.0)
    der = torch.where(in_dd_span, dd["der"] * ddinc[:, None], 0.0)
    ddr = torch.where(in_dd_span, dd["ddr"] * ddinc[:, None], 0.0)
    cpr = scal["trppt"]
    pptflx = torch.where(no_dd, scal["trppt"], scal["trppt"] - tder)
    fb_dd = in_dd_span & ~no_dd[:, None]
    qd_fb = torch.where(fb_dd, dd["qd"], 0.0)
    thtad_fb = torch.where(fb_dd, dd["thtad"], 0.0)

    # ---- the inflow limit (:1451-1463)
    lmax = torch.maximum(scal["klcl"], dd["lfs"])
    uer_net = prof["uer"] - der
    in_inflow = (lev >= scal["lc"][:, None]) & (lev <= lmax[:, None])
    aincm1 = torch.where(in_inflow & (uer_net > 1.0e-3),
                         prof["ems"] / torch.clamp(uer_net, min=1e-10)
                         / timec[:, None], 1.0e3)
    aincmx = torch.clamp(aincm1.amin(dim=1), max=1.0e3)
    ainc0 = torch.clamp(aincmx, max=1.0)

    # the unit profiles (:1468-1480)
    unit = dict(umf=prof["umf"], uer=prof["uer"], udr=prof["udr"],
                detlq=prof["detlq"], detic=prof["detic"],
                dmf=dmf, der=der, ddr=ddr)

    # the shallow mass flux from TKE (:1487-1507)
    in_tke = (lev >= scal["lc"][:, None]) & (lev <= scal["klcl"][:, None])
    evac = 0.5 * torch.where(in_tke, tke, 0.0).amax(dim=1) * 0.1
    ainc_sh = evac * scal["dpthmx"] * dxsq \
        / (torch.clamp(scal["vmflcl"], min=1e-10) * c.egrav * timec)
    ainc0 = torch.where(scal["ishall"], ainc_sh, ainc0)

    # ---- the closure iteration (iter:, :1510-1787)
    thta0, thtau = prof["thta0"], prof["thtau"]
    emsd, ems = prof["emsd"], prof["ems"]
    intop = prof["intop"]
    abe = scal["abe"]
    ltop, klcl = scal["ltop"], scal["klcl"]
    fields0 = torch.stack([thta0, q0])
    udr_src = torch.stack([thtau, prof["qdt"]])
    ddr_src = torch.stack([thtad_fb, qd_fb])

    def one_pass(ainc):
        """The subsidence flux, its substeps and the adjusted sounding
        for the current mass-flux factor."""
        s = {k: v * ainc[:, None] for k, v in unit.items()}
        net_ent = s["uer"] - s["der"]
        domgdp = -(net_ent - s["udr"] - s["ddr"]) * emsd
        domgdp = torch.where(intop, domgdp, 0.0)
        omg = torch.cat([torch.zeros_like(dp[:, :1]),
                         -_lcumsum(dp * domgdp)[:, :-1]], dim=1)
        absomg = omg[:, 1:].abs()
        dp_m1 = dp[:, :-1]
        half = timec[:, None] / 2.0
        lim = torch.where((absomg * half > 0.75 * dp_m1) & intop[:, 1:],
                          0.75 * dp_m1 / torch.clamp(absomg, min=1e-10),
                          half)
        dtt = torch.minimum(lim.amin(dim=1), timec / 2.0)
        nstep = torch.clamp(torch.round(timec / dtt).to(torch.int64), 1,
                            NSTEPMAX)
        dtime = timec / nstep.to(dtype)
        # no flux through the cloud-top interface (the reference's flux
        # loop runs nk = 2..ltop only, :1530)
        fxm = torch.where(intop, omg * dxsq / c.egrav, 0.0)
        srcs = s["udr"] * udr_src + s["ddr"] * ddr_src \
            - net_ent * fields0
        adv = _advect(fields0, srcs, fxm, nstep, dtime, emsd, intop)
        qg = _borrow_moisture(adv[1], ems, emsd, ltop, klcl)
        tg = adv[0] / (P00 / p0) ** (0.2854 * (1.0 - 0.28 * qg))
        return fxm, nstep, dtime, tg, qg

    # the adjusted sounding's mixing layer (:1620-1705)
    wmix_sel = torch.where(inmix, dp, 0.0)
    dpth_sel = torch.clamp(_lsum(wmix_sel), min=1e-10)
    dza_z = torch.cat([z0[:, 1:] - z0[:, :-1], torch.zeros_like(z0[:, :1])],
                      dim=1)
    ddilfrc = prof["ddilfrc"]
    qlq_sel, qic_sel = sel2["qliq"], sel2["qice"]

    def abeg_of(tg, qg):
        """Adjusted buoyant energy of the post-convective sounding."""
        tmix = _lsum(wmix_sel * tg) / dpth_sel
        qmix = _lsum(wmix_sel * qg) / dpth_sel
        pmix = scal["pmix"]
        es_m = ALIQ * torch.exp((tmix * BLIQ - CLIQ) / (tmix - DLIQ))
        qss = EP2 * es_m / (pmix - es_m)
        sup = qmix > qss
        rl = XLV0 - XLV1 * tmix
        cpm = c.cpd * (1.0 + 0.887 * qmix)
        dssdt = qss * (CLIQ - BLIQ * DLIQ) / ((tmix - DLIQ) ** 2)
        dq = (qmix - qss) / (1.0 + rl * dssdt / cpm)
        tmix_s = tmix + rl / c.cpd * dq
        qmix_s = qmix - dq
        qmp = torch.clamp(qmix, min=0.0)
        emix = qmp * pmix / (EP2 + qmp)
        tlcl = torch.where(sup, tmix_s, _tdpt_from_e(tab, emix, tmix))
        tmix = torch.where(sup, tmix_s, tmix)
        qmix = torch.where(sup, qmix_s, qmix)
        tvlcl = tlcl * (1.0 + EP1 * qmix)
        zlcl = scal["zmix"] + (tlcl - tmix) / GDRY
        above_l = (z0 >= zlcl[:, None]) & (lev >= scal["lc"][:, None])
        klcl2, _ = _first_true(above_l, dim=1, default=nk - 1)
        klcl2 = torch.clamp(klcl2, min=1)
        k2 = klcl2 - 1
        dlp = (zlcl - _g1(z0, k2)) \
            / torch.clamp(_g1(z0, klcl2) - _g1(z0, k2), min=1e-10)
        tenv = _g1(tg, k2) + (_g1(tg, klcl2) - _g1(tg, k2)) * dlp
        qenv = _g1(qg, k2) + (_g1(qg, klcl2) - _g1(qg, k2)) * dlp
        tven = tenv * (1.0 + EP1 * qenv)
        theteu = tmix * (P00 / pmix) ** (0.2854 * (1.0 - 0.28 * qmix)) \
            * torch.exp((C1 / tlcl - C2) * qmix * (1.0 + C4 * qmix))
        thteeg = envirtht(tab, p0, tg, qg)
        tvg = tg * (1.0 + EP1 * qg)
        dz_first = _g1(z0, klcl2) - zlcl
        # the parcel's theta-e entering each level (a recursion that the
        # saturation point does not feed), then every level's saturation
        # point in one batch
        th_in = torch.empty_like(tg)
        th_in[:, 0] = theteu
        for nk1 in range(1, nk):
            act = (nk1 > k2) & (nk1 <= ltop)
            th_in[:, nk1] = theteu
            ddil = ddilfrc[:, nk1]
            theteu = torch.where(act, theteu * ddil
                                 + thteeg[:, nk1] * (1.0 - ddil), theteu)
        tgu, qgu = tpmix2dd(tab, p0, th_in)
        tvqu_all = tgu * (1.0 + EP1 * qgu - qlq_sel - qic_sel)
        tvqu_prev = torch.zeros_like(tmix)
        abeg = torch.zeros_like(tmix)
        for nk1 in range(1, nk):
            act = (nk1 > k2) & (nk1 <= ltop)
            first = nk1 == klcl2
            tvqu = tvqu_all[:, nk1]
            dzz = torch.where(first, dz_first, dza_z[:, nk1 - 1])
            tvq_p = torch.where(first, tvlcl, tvqu_prev)
            tvg_p = torch.where(first, tven, tvg[:, nk1 - 1])
            dilbe = ((tvq_p + tvqu) / (tvg_p + tvg[:, nk1]) - 1.0) * dzz
            abeg = abeg + torch.where(act & (dilbe > 0.0),
                                      dilbe * c.egrav, 0.0)
            tvqu_prev = torch.where(act, tvqu, tvqu_prev)
        return abeg

    stab = 0.95
    active = scal["active"]
    ishall = scal["ishall"]
    zb = torch.zeros((ncol,), dtype=torch.bool, device=dev)
    ainc, fabe_o, ainc_o, ainc_used = ainc0, torch.ones_like(ainc0), \
        ainc0, ainc0
    noitr, done, dead = zb, zb, zb
    tg, qg = t0, q0
    fxm = torch.zeros_like(t0)
    nstep = torch.ones((ncol,), dtype=torch.int64, device=dev)
    dtime = timec
    for i in range(MAXITER):
        fxm_n, nstep_n, dtime_n, tg_n, qg_n = one_pass(ainc)
        run = ~done & ~dead & active
        run2 = run[:, None]
        tg = torch.where(run2, tg_n, tg)
        qg = torch.where(run2, qg_n, qg)
        fxm = torch.where(run2, fxm_n, fxm)
        nstep = torch.where(run, nstep_n, nstep)
        dtime = torch.where(run, dtime_n, dtime)
        # the mass-flux factor the saved fields belong to: the feedback
        # reuses exactly this factor
        ainc_used = torch.where(run, ainc, ainc_used)
        # shallow columns leave after the first pass (:1612-1614)
        done_sh = ishall & run
        abeg = abeg_of(tg_n, qg_n)
        fabe = abeg / torch.clamp(abe, min=1e-10)
        dabe = torch.maximum(abe - abeg, 0.1 * abe)
        # fabe > 1: the environment more unstable, abandon (:1714-1716)
        dead_n = dead | (run & ~ishall & (fabe > 1.0))
        # the secant safeguard (:1717-1729)
        dainc = ainc - ainc_o
        dfda = (fabe - fabe_o) / torch.where(dainc.abs() < 1e-30, 1e-30,
                                             dainc)
        freeze = run & ((dainc.abs() < 1e-4) | (dfda > 0.0)) & ~noitr \
            if i > 0 else zb
        # frozen columns redo one pass at the OLD ainc, then stop
        done_frozen = run & noitr
        conv1 = run & (ainc / torch.clamp(aincmx, min=1e-10) > 0.999) \
            & (fabe > 1.05 - stab)
        conv2 = run & (fabe <= 1.05 - stab) & (fabe >= 0.95 - stab)
        new_done = done | done_sh | conv1 | conv2 | done_frozen | dead_n
        # the next ainc (:1754-1775)
        ainc_next = torch.where(
            fabe.abs() < 1e-15, ainc * 0.5,
            torch.where(dabe < 1.0e-4, ainc,
                        ainc * stab * abe / torch.clamp(dabe, min=1e-10)))
        ainc_next = torch.minimum(aincmx, ainc_next)
        dead_n = dead_n | (run & ~ishall & ~new_done & (ainc_next < 0.05))
        go = run & ~new_done
        ainc_new = torch.where(go, torch.where(freeze, ainc_o, ainc_next),
                               ainc)
        noitr = noitr | freeze
        fabe_o = torch.where(run, fabe, fabe_o)
        ainc_o = torch.where(go & ~freeze, ainc, ainc_o)
        ainc, done, dead = ainc_new, new_done, dead_n
    # the ainc the final fields belong to
    ainc_f = ainc_used
    live = active & ~dead

    # ---- cloud fraction (Xu-Krueger, :1789-1809)
    in_cf = (lev >= klcl[:, None] - 1) & (lev <= ltop[:, None] + 1)
    umf_new = unit["umf"] * ainc_f[:, None] / dxsq
    sc = lambda shal, deep: torch.where(
        ishall, torch.full_like(timec, shal),
        torch.full_like(timec, deep))[:, None]
    kfac = sc(par.kfac_shal, par.kfac_deep)
    capv = sc(0.6, 0.2)
    xcld = torch.minimum(torch.clamp(
        kfac * torch.log(1.0 + par.k2_const * umf_new), min=0.01), capv)
    cldfra = torch.where(in_cf & live[:, None], xcld, 0.0)

    # ---- hydrometeor redistribution (:1812-1879)
    fbfrc = ishall.to(dtype)
    frc2 = torch.where(cpr > 0.0, pptflx / torch.clamp(cpr, min=1e-10),
                       0.0)
    af = ainc_f[:, None]
    ffb = (ainc_f * fbfrc * frc2)[:, None]
    zeros = torch.zeros_like(t0)
    hyd = _advect(torch.stack([ql0, qi0, zeros, zeros]),
                  torch.stack([unit["detlq"] * af, unit["detic"] * af,
                               prof["pptliq"] * ffb, prof["pptice"] * ffb]),
                  fxm, nstep, dtime, emsd, intop)
    qlg, qig, qrg, qsg = hyd[0], hyd[1], hyd[2], hyd[3]

    # ---- feedback tendencies (:1990-2075)
    rt = (1.0 / timec)[:, None]
    if f_qi:
        dqcdt = (qlg - ql0) * rt
        dqidt = (qig - qi0) * rt
        dqrdt = qrg * rt
        dqsdt = qsg * rt
        tg_fb = tg
    else:
        # no ice phase: frozen hydrometeors melt and feed back as ql/qr
        cpm = c.cpd * (1.0 + 0.887 * qg)
        tg_fb = tg - (qig + qsg) * c.wlhf / cpm
        dqcdt = (qlg + qig - ql0 - qi0) * rt
        dqidt = zeros
        dqrdt = (qrg + qsg) * rt
        dqsdt = zeros
    dtdt = (tg_fb - t0) * rt
    dqdt = (qg - q0) * rt
    pratec = pptflx * ainc_f * (1.0 - fbfrc) / dxsq

    m = live[:, None]
    zz = lambda a: torch.where(m, a, 0.0)
    return KFOut(
        dtdt=zz(dtdt), dqdt=zz(dqdt), dqcdt=zz(dqcdt), dqidt=zz(dqidt),
        dqrdt=zz(dqrdt), dqsdt=zz(dqsdt),
        prate=torch.where(live, torch.clamp(pratec, min=0.0), 0.0),
        cldfra=cldfra,
        conv_ppt=zz((prof["pptliq"] + prof["pptice"]) * af),
        ktop=torch.where(live, ltop, 0), kbot=torch.where(live, klcl, 0),
        ishall=ishall & live, active=live, timec=timec)
