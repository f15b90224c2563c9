"""Emanuel (1991) convection scheme V4.3C (icup=4), torch twin of
``regcm_tpu/physics/cumulus/emanuel.py``.

``Main/cumlib/mod_cu_em.F90`` (``cupemandrv`` :107, ``cupeman`` :406,
``tlift`` :1185): buoyancy-sorting episodic mixing, quasi-equilibrium
cloud-base mass-flux closure, unsaturated precipitating downdraft and
convective momentum transport, as dense masked algebra over (ncol, NL)
columns (level 0 = lowest level). The mixing-matrix reductions go
through kernel K2 (``kernels.emanuel_mixing``); the downdraft recursion
is a loop from cloud top to the surface, batched over columns. With
``tra`` the chemistry tracers ride the same plume and downdraft algebra
as u and v (chemcutran, mod_cu_em.F90:454, :605-1150): their mixing
contraction comes from K2's tracer form, and ``ftra`` returns their
tendencies.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...utils import constants as c

from ...dynamics.hydrostatic import level_sum
from ...kernels.emanuel_mixing import emanuel_mixing
from ...utils.thermo import pfwsat

# emanparam defaults (Main/mod_params.F90:405-422)
ELCRIT_LND = 1.1e-3
ELCRIT_OCN = 1.1e-4
TLCRIT = -55.0
ENTP = 0.06
SIGD = 0.05
SIGS = 0.15
OMTRAIN = 50.0
OMTSNOW = 5.5
COEFFR = 1.0
COEFFS = 0.8
CU = 0.7
DTMAX = 0.65
ALPHAE = 0.02
DAMP = 0.01
EPMAX = 0.999
CL = 2500.0
CPVMCL = CL - c.cpv
MINCBMF = 1.0e-30
# cloud fraction factors (Main/mod_params.F90:339-341)
K2_CONST = 500.0
KFAC_SHAL = 0.07
KFAC_DEEP = 0.14


class EmanuelOut(NamedTuple):
    ft: torch.Tensor       # T tendency (K/s), Emanuel orientation
    fq: torch.Tensor       # specific-humidity tendency (kg/kg/s)
    fu: torch.Tensor
    fv: torch.Tensor
    precip: torch.Tensor   # surface precip (kg/m2/s == mm/s)
    cbmf: torch.Tensor     # updated cloud-base mass flux
    cldfra: torch.Tensor
    kbase: torch.Tensor    # cloud base level (Emanuel orientation)
    ktop: torch.Tensor
    active: torch.Tensor   # bool: convection occurred
    ftra: Optional[torch.Tensor] = None   # tracer tendencies (ncol, NL, ntr)


def _take(a, idx):
    """a[n, idx[n]] for (ncol, L) a and (ncol,) integer idx."""
    return torch.gather(a, 1, idx[:, None])[:, 0]


def _first_true(mask):
    """Index of the first True along axis 1 (0 where none): argmax on
    an integer cast keeps first-occurrence ties."""
    return torch.argmax(mask.to(torch.int32), dim=1)


def _tlift(t, q, qs, gz, p, nk):
    """Lifted parcel T, Tv and adiabatic water (tlift,
    mod_cu_em.F90:1185-1240)."""
    qnk = _take(q, nk)
    tnk = _take(t, nk)
    gznk = _take(gz, nk)
    ah0 = (c.cpd * (1.0 - qnk) + CL * qnk) * tnk \
        + qnk * (c.wlhv - CPVMCL * (tnk - c.tzero)) + gznk
    cpp = c.cpd * (1.0 - qnk) + qnk * c.cpv
    tpk_dry = tnk[:, None] - (gz - gznk[:, None]) / cpp[:, None]
    tvp_dry = tpk_dry * (1.0 + qnk[:, None] * c.rgowi)
    # saturated ascent (2 Newton iterations, :1222-1233)
    tg = t
    qg = qs
    alv = c.wlhv - CPVMCL * (t - c.tzero)
    for _ in range(2):
        s = 1.0 / (c.cpd + alv * alv * qg / (c.rwat * t * t))
        ahg = c.cpd * tg + (CL - c.cpd) * qnk[:, None] * t + alv * qg + gz
        tg = torch.clamp(tg + s * (ah0[:, None] - ahg), min=35.0)
        qg = pfwsat(tg, p * 100.0)
    tpk_wet = (ah0[:, None] - (CL - c.cpd) * qnk[:, None] * t - gz
               - alv * qg) * c.rcpd
    clw = torch.clamp(qnk[:, None] - qg, min=0.0)
    rg = qg / (1.0 - qnk[:, None])
    tvp_wet = tpk_wet * (1.0 + rg * c.rgowi)
    return tpk_dry, tvp_dry, tpk_wet, tvp_wet, clw


def _mixing_terms(h, hp, q, qs, t, lv, qti, clw, ep, m, u, v, dph,
                  unk, vnk, icb, ict, cloud, tra=None, trank=None):
    """Reduced mixing terms through kernel K2, its tracer form with
    ``tra`` (contiguous operands)."""
    cont = lambda a: None if a is None else a.contiguous()
    return emanuel_mixing(*(cont(a) for a in (h, hp, q, qs, t, lv, qti,
                                              clw, ep, m, u, v, dph)),
                          cont(unk), cont(vnk), cont(icb), cont(ict),
                          cont(cloud), tra=cont(tra), trank=cont(trank))


def cupeman(t, q, qs, u, v, p, ph, cbmf_in, dt, elcrit, epmax,
            minorig: int, tra=None) -> EmanuelOut:
    """One Emanuel call. Inputs (ncol, NL) bottom-up: t (K), q/qs
    specific humidity (kg/kg), u/v (m/s), p (hPa), ph (ncol, NL+1)
    interface hPa; cbmf_in: cloud-base mass-flux memory; dt: leapfrog
    step; elcrit/epmax (ncol,); tra (ncol, NL, ntr) bottom-up tracer
    mixing ratios, whose tendencies come back as ``ftra``."""
    ncol, NL2 = t.shape
    NL = NL2 - 1
    rdt = 1.0 / dt
    dev = t.device
    ii = torch.arange(NL2, device=dev)[None, :]

    # thermodynamic profiles (cupeman :460-500)
    lv = c.wlhv - CPVMCL * (t - c.tzero)
    cpn = c.cpd * (1.0 - q) + c.cpv * q
    tv = t * (1.0 + q * c.rgowi - q)
    gz = torch.cat([
        torch.zeros_like(t[:, :1]),
        torch.cumsum(0.5 * c.rgas * (tv[:, 1:] + tv[:, :-1])
                     * (p[:, :-1] - p[:, 1:]) / ph[:, 1:NL2], dim=1)],
        dim=1)
    h = t * cpn + gz
    hm = (c.cpd * (1.0 - q) + CL * q) * (t - t[:, 0:1]) + lv * q + gz
    hm[:, 0] = lv[:, 0] * q[:, 0]           # fresh tensor: local write

    # level of minimum hm above minorig, with the descent requirement
    hms = torch.where((ii >= minorig) & (ii >= 1)
                      & (hm < torch.roll(hm, 1, dims=1)), hm, 1.0e12)
    ihmin = torch.argmin(hms, dim=1)
    ihmin = torch.where(torch.min(hms, dim=1)[0] >= 1.0e12, NL - 1, ihmin)
    ihmin = torch.clamp(ihmin, max=NL - 2)
    # parcel origin: max hm in [minorig, ihmin]
    hmx = torch.where((ii >= minorig) & (ii <= ihmin[:, None]), hm,
                      -1.0e12)
    nk = torch.clamp(torch.argmax(hmx, dim=1), min=minorig)

    tnk = _take(t, nk)
    qnk = _take(q, nk)
    qsnk = _take(qs, nk)
    pnk = _take(p, nk)
    ok0 = (tnk >= 250.0) & (qnk > 0.0) & (ihmin != NL - 2)

    # LCL (Bolton 1980; :523-531)
    rh = qnk / qsnk
    chi = tnk / (1669.0 - 122.0 * rh - tnk)
    plcl = pnk * torch.clamp(rh, min=1e-10) ** chi
    ok1 = (plcl >= 200.0) & (plcl < 2000.0)
    above = (p < plcl[:, None]) & (ii > nk[:, None])
    icb = torch.where(torch.any(above, dim=1), _first_true(above), NL - 2)
    icb = torch.clamp(icb, max=NL - 2)
    ok2 = icb < NL - 2

    # lifted parcel
    tpk_dry, tvp_dry, tpk_wet, tvp_wet, clw_w = _tlift(t, q, qs, gz, p, nk)
    below = ii <= icb[:, None]
    tp = torch.where(below, tpk_dry, tpk_wet)
    tvp = torch.where(below, tvp_dry, tvp_wet)
    clw = torch.where(below, 0.0, clw_w)
    tvp = tvp - tp * qnk[:, None]
    tvp[:, NL] = tvp[:, NL - 1] - (gz[:, NL] - gz[:, NL - 1]) * c.rcpd

    tvicb = _take(tv, icb)
    tvpicb = _take(tvp, icb)
    stable_noconv = (torch.abs(cbmf_in) < MINCBMF) \
        & (tvpicb <= tvicb - DTMAX)
    active0 = ok0 & ok1 & ok2 & (~stable_noconv)

    # precipitation efficiencies (:576-596)
    tca = tp - c.tzero
    elacrit = torch.where(tca >= 0.0, elcrit[:, None],
                          elcrit[:, None] * (1.0 - tca / TLCRIT))
    elacrit = torch.clamp(elacrit, min=0.0)
    ep = epmax[:, None] * (1.0 - elacrit / torch.clamp(clw, min=1.0e-8))
    ep = torch.minimum(torch.clamp(ep, min=0.0), epmax[:, None])
    ep = torch.where(ii <= nk[:, None], 0.0, ep)

    lvcp = lv / cpn

    # CAPE levels (:652-676)
    dph = ph[:, :-1] - ph[:, 1:]
    by = (tvp - tv) * dph / p
    in_range = (ii >= icb[:, None] + 1) & (ii <= NL - 2)
    by_m = torch.where(in_range, by, 0.0)
    cape_cum = torch.cumsum(by_m, dim=1)
    pos = torch.where(in_range & (by_m >= 0.0), ii, -1)
    posmax = torch.max(pos, dim=1)[0]
    ict1 = torch.where(posmax < 0, icb + 1, posmax + 1)
    posc = torch.where(in_range & (cape_cum > 0.0), ii, -1)
    poscmax = torch.max(posc, dim=1)[0]
    ict = torch.where(poscmax < 0, icb + 1, poscmax + 1)
    ict = torch.clamp(torch.maximum(ict, ict1), max=NL - 1)

    # liquid water static energy of the lifted parcel (:680-683)
    hnk = _take(h, nk)
    hp = torch.where((ii >= icb[:, None]) & (ii <= ict[:, None]),
                     hnk[:, None] + (lv + (c.cpd - c.cpv) * t) * ep * clw,
                     h)

    # cloud-base mass-flux closure (:690-735)
    icbm1 = torch.clamp(icb - 1, min=0)
    icbp1 = torch.clamp(icb + 1, max=NL2 - 1)
    tvp_icbm1 = _take(tvp, icbm1)
    p_icbm1 = _take(p, icbm1)
    cpn_icbm1 = _take(cpn, icbm1)
    tvpplcl = tvp_icbm1 - c.rgas * tvp_icbm1 * (p_icbm1 - plcl) \
        / (cpn_icbm1 * p_icbm1)
    p_icb = _take(p, icb)
    p_icbp1 = _take(p, icbp1)
    tvaplcl = tvicb + (tvpicb - _take(tvp, icbp1)) \
        * (plcl - p_icb) / torch.clamp(p_icb - p_icbp1, min=0.1)
    inpbl = (ii >= nk[:, None]) & (ii <= icb[:, None] - 1)
    dtpbl = torch.sum(torch.where(inpbl, (tvp - tv) * dph, 0.0), dim=1) \
        / torch.clamp(_take(ph, nk) - _take(ph, icb), min=0.1)
    dtma = tvpplcl - tvaplcl + DTMAX + dtpbl
    damps = DAMP * dt / 300.0
    cbmf = (1.0 - damps) * cbmf_in + 0.1 * ALPHAE * dtma
    cbmf = torch.where(active0, torch.clamp(cbmf, min=0.0), 0.0)
    active = active0 & ((cbmf >= MINCBMF) | (torch.abs(cbmf_in) >= MINCBMF))

    # mixing rates m(i) (:707-718): x[min(i, ict1)]
    below_ict1 = ii <= ict1[:, None]
    km_sel = lambda x: torch.where(below_ict1, x, _take(x, ict1)[:, None])
    tvk = km_sel(tv)
    tvpk = km_sel(tvp)
    dphk = km_sel(dph)
    cloud = (ii >= icb[:, None] + 1) & (ii <= ict[:, None])
    dbo = torch.where(cloud,
                      torch.abs(tvk - tvpk) + ENTP * 0.02 * dphk, 0.0)
    dbosum = torch.sum(dbo, dim=1)
    m = cbmf[:, None] * dbo / torch.clamp(dbosum[:, None], min=1e-30)

    # mixing matrices, reduced (:723-840 + the :975-1100 contractions)
    unk = _take(u, nk)
    vnk = _take(v, nk)
    qti = qnk[:, None] - ep * clw
    trank = None
    if tra is not None:
        trank = torch.gather(tra, 1, nk[:, None, None].expand(
            -1, 1, tra.shape[2]))[:, 0]                 # (ncol, ntr)
    mix = _mixing_terms(h, hp, q, qs, t, lv, qti, clw, ep, m, u, v,
                        dph, unk, vnk, icb, ict, cloud, tra=tra, trank=trank)

    # precipitating downdraft (:845-960), top → bottom
    wdtrain = c.egrav * ep * m * clw + mix["wdtrain_mix"]
    coeff = torch.where(t > c.tzero, t.new_tensor(COEFFR), COEFFS)
    wt = torch.where(t > c.tzero, t.new_tensor(OMTRAIN), OMTSNOW)
    in_dd = ii <= ict[:, None]
    zc = torch.zeros_like(t[:, 0])
    water_kp1, wt_kp1, mp_kp1 = zc, zc + OMTSNOW, zc
    qp_kp1, up_kp1, vp_kp1 = q[:, -1] * 0.0, zc, zc
    jtt_set = torch.zeros_like(zc, dtype=torch.bool)
    mp_jtt, p_jtt = zc, zc + 1.0
    water_l, evap_l, mp_l, qp_l, up_l, vp_l, trap_l = (
        [None] * NL2 for _ in range(7))
    # the downdraft's tracers start from the top level's (trap(i) holds
    # the shifted profile, :624-633)
    trap_kp1 = tra[:, -1, :] if tra is not None else None
    for k in range(NL2 - 1, -1, -1):
        kp1 = min(k + 1, NL2 - 1)
        km1 = max(k - 1, 0)
        act = in_dd[:, k]
        tk = t[:, k]
        qk = q[:, k]
        qsk = qs[:, k]
        phk = ph[:, k]
        phkp1 = ph[:, kp1]
        pk = p[:, k]
        qsm = 0.5 * (qk + qp_kp1)
        afac = torch.clamp(coeff[:, k] * phk * (qsk - qsm)
                           / (1.0e4 + 2.0e3 * phk * qsk), min=0.0)
        b6 = 100.0 * (phk - phkp1) * SIGS * afac / wt[:, k]
        c6 = (water_kp1 * wt_kp1 + wdtrain[:, k] / SIGD) / wt[:, k]
        revap = 0.5 * (-b6 + torch.sqrt(b6 * b6 + 4.0 * c6))
        evap_k = SIGS * afac * revap
        water_k = revap * revap
        # downdraft mass flux
        dhdp = torch.clamp((h[:, k] - h[:, km1])
                           / torch.clamp(p[:, km1] - pk, min=0.1), min=10.0)
        mp_k = torch.clamp(100.0 * c.regrav * lv[:, k] * SIGD * evap_k
                           / dhdp, min=0.0)
        fac = 20.0 / torch.clamp(ph[:, km1] - phk, min=0.1)
        mp_k = (fac * mp_kp1 + mp_k) / (1.0 + fac)
        # linear decrease below 0.949 p1
        nearsfc = pk > 0.949 * p[:, 0]
        first_near = nearsfc & (~jtt_set)
        mp_jtt_new = torch.where(first_near, mp_k, mp_jtt)
        p_jtt_new = torch.where(first_near, pk, p_jtt)
        mp_k = torch.where(nearsfc & jtt_set,
                           mp_jtt * (p[:, 0] - pk)
                           / torch.clamp(p[:, 0] - p_jtt, min=0.1), mp_k)
        jtt_set = jtt_set | nearsfc
        if k == 0:
            mp_k = torch.zeros_like(mp_k)   # mp(1)=0 (loop `if i/=1`)
        # downdraft properties
        qstm = qs[:, km1]
        grow = mp_k > mp_kp1
        rat = mp_kp1 / torch.clamp(mp_k, min=1e-30)
        qp_k_grow = qp_kp1 * rat + qk * (1.0 - rat) \
            + 100.0 * c.regrav * SIGD * (phk - phkp1) \
            * (evap_k / torch.clamp(mp_k, min=1e-30))
        up_k_grow = up_kp1 * rat + u[:, k] * (1.0 - rat)
        vp_k_grow = vp_kp1 * rat + v[:, k] * (1.0 - rat)
        if tra is not None:
            # the growth branch mixes against the shifted profile
            # (:940-944)
            trap_k = torch.where(
                grow[:, None], trap_kp1 * rat[:, None]
                + tra[:, km1, :] * (1.0 - rat[:, None]), trap_kp1)
            trap_k = torch.where(act[:, None], trap_k, tra[:, k, :])
            trap_l[k] = trap_k
            trap_kp1 = trap_k
        tkp1 = t[:, kp1]
        lvkp1 = lv[:, kp1]
        qp_k_desc = (gz[:, kp1] - gz[:, k]
                     + qp_kp1 * (lvkp1 + tkp1 * (CL - c.cpd))
                     + c.cpd * (tkp1 - tk)) / (lv[:, k] + tk * (CL - c.cpd))
        qp_k = torch.where(grow, qp_k_grow,
                           torch.where(mp_kp1 > 0.0, qp_k_desc, qp_kp1))
        up_k = torch.where(grow, up_k_grow, up_kp1)
        vp_k = torch.where(grow, vp_k_grow, vp_kp1)
        qp_k = torch.minimum(torch.clamp(qp_k, min=0.0), qstm)
        # inactive levels keep zero state
        water_k = torch.where(act, water_k, 0.0)
        evap_k = torch.where(act, evap_k, 0.0)
        mp_k = torch.where(act, mp_k, 0.0)
        qp_k = torch.where(act, qp_k, qk)
        water_l[k], evap_l[k], mp_l[k] = water_k, evap_k, mp_k
        qp_l[k], up_l[k], vp_l[k] = qp_k, up_k, vp_k
        water_kp1, wt_kp1, mp_kp1 = water_k, wt[:, k], mp_k
        qp_kp1, up_kp1, vp_kp1 = qp_k, up_k, vp_k
        mp_jtt, p_jtt = mp_jtt_new, p_jtt_new
    st = lambda lst: torch.stack(lst, dim=1)
    water, evap, mp = st(water_l), st(evap_l), st(mp_l)
    qp, up, vp = st(qp_l), st(up_l), st(vp_l)
    trap = st(trap_l) if tra is not None else None
    # downdraft only when ep(ict) >= 1e-4 (:845)
    has_dd = (_take(ep, ict) >= 1.0e-4).to(t.dtype)
    water = water * has_dd[:, None]
    evap = evap * has_dd[:, None]
    mp = mp * has_dd[:, None]
    precip = wt[:, 0] * SIGD * water[:, 0] * c.regrav * has_dd

    # tendencies (:975-1100)
    shift_p1 = lambda a: torch.cat([a[:, 1:], a[:, -1:]], dim=1)
    shift_m1 = lambda a: torch.cat([a[:, :1], a[:, :-1]], dim=1)
    dpinv = 0.01 / torch.clamp(dph, min=0.01)
    cpinv = 1.0 / cpn

    # amp1(i) = Σ_{k>i} m(k) [i>=nk] + Σ_{k<=i, j>i} ment(k,j)
    m_rcum = torch.flip(torch.cumsum(torch.flip(m, [1]), dim=1), [1])
    amp1_m = torch.where(ii >= nk[:, None], shift_p1(m_rcum), 0.0)
    amp1 = amp1_m + mix["amp1_e"]
    ad = mix["ad"]

    tp1, tm1 = shift_p1(t), shift_m1(t)
    qp1_, qm1 = shift_p1(q), shift_m1(q)
    up1, um1 = shift_p1(u), shift_m1(u)
    vp1, vm1 = shift_p1(v), shift_m1(v)
    gzp1, gzm1 = shift_p1(gz), shift_m1(gz)
    mp_p1, qp_p1 = shift_p1(mp), shift_p1(qp)
    up_p1, vp_p1 = shift_p1(up), shift_p1(vp)
    wat_p1, wt_p1 = shift_p1(water), shift_p1(wt)

    mentii = mix["mentii"]
    qentii = mix["qentii"]
    ft = c.egrav * dpinv * (amp1 * (tp1 - t + (gzp1 - gz) * cpinv)
                            - ad * (t - tm1 + (gz - gzm1) * cpinv)) \
        - SIGD * lvcp * evap
    ft = ft + c.egrav * dpinv * mentii \
        * (hp - h + t * (c.cpv - c.cpd) * (q - qentii)) * cpinv
    ft = ft + SIGD * wt_p1 * (CL - c.cpd) * wat_p1 * (tp1 - t) \
        * dpinv * cpinv
    fq = c.egrav * dpinv * (amp1 * (qp1_ - q) - ad * (q - qm1))
    fu = c.egrav * dpinv * (amp1 * (up1 - u) - ad * (u - um1))
    fv = c.egrav * dpinv * (amp1 * (vp1 - v) - ad * (v - vm1))
    fq = fq + c.egrav * dpinv * mix["sum_q"]
    fu = fu + c.egrav * dpinv * mix["sum_u"]
    fv = fv + c.egrav * dpinv * mix["sum_v"]
    # downdraft terms
    fq = fq + SIGD * evap + c.egrav * dpinv \
        * (mp_p1 * (qp_p1 - q) - mp * (qp - qm1))
    fu = fu + c.egrav * dpinv * (mp_p1 * (up_p1 - u) - mp * (up - um1))
    fv = fv + c.egrav * dpinv * (mp_p1 * (vp_p1 - v) - mp * (vp - vm1))
    ftra = None
    if tra is not None:
        # tracer tendencies mirror fu term for term (:994-1095)
        d3 = dpinv[:, :, None]
        ftra = c.egrav * d3 * (amp1[:, :, None] * (shift_p1(tra) - tra)
                               - ad[:, :, None] * (tra - shift_m1(tra)))
        ftra = ftra + c.egrav * d3 * mix["sum_tra"]
        ftra = ftra + c.egrav * d3 * (
            mp_p1[:, :, None] * (shift_p1(trap) - tra)
            - mp[:, :, None] * (trap - shift_m1(tra)))
    conv_lay = ii <= ict[:, None]
    ft = torch.where(conv_lay, ft, 0.0)
    fq = torch.where(conv_lay, fq, 0.0)
    fu = torch.where(conv_lay, fu, 0.0)
    fv = torch.where(conv_lay, fv, 0.0)

    # enthalpy/momentum conservation adjustment (:1127-1150)
    dphm = torch.where(conv_lay, dph, 0.0)
    norm = torch.clamp(torch.sum(dphm, dim=1), min=0.1)
    ents = torch.sum((cpn * ft + lv * fq) * dphm, dim=1) / norm
    uav = torch.sum(fu * dphm, dim=1) / norm
    vav = torch.sum(fv * dphm, dim=1) / norm
    ft = torch.where(conv_lay, ft - ents[:, None] / cpn, ft)
    fu = torch.where(conv_lay, (1.0 - CU) * (fu - uav[:, None]), fu)
    fv = torch.where(conv_lay, (1.0 - CU) * (fv - vav[:, None]), fv)
    if tra is not None:
        # exact tracer-mass conservation (:1142-1150)
        c3 = conv_lay[:, :, None]
        ftra = torch.where(c3, ftra, 0.0)
        # the level sum in level order: a column's bits do not depend on
        # the number of columns
        traav = level_sum(torch.movedim(ftra * dphm[:, :, None], 1, 0)) \
            / norm[:, None]
        ftra = torch.where(c3, ftra - traav[:, None, :], ftra)

    # CFL guard: clamp the magnitude
    cfl = 2.0 * c.egrav * dpinv * amp1
    scale = torch.clamp((0.9 * rdt) / torch.clamp(cfl, min=1e-30), max=1.0)
    scale = torch.min(torch.where(conv_lay, scale, 1.0), dim=1)[0][:, None]
    ft = ft * scale
    fq = fq * scale
    fu = fu * scale
    fv = fv * scale
    if tra is not None:
        ftra = ftra * scale[:, :, None]

    # cloud fraction (Xu & Krueger; :1160-1178)
    mmid = 0.5 * (m + shift_p1(m))
    zrel = gz * c.regrav
    deep = (_take(zrel, ict) - _take(zrel, icb)) >= 2000.0
    cf_deep = torch.clamp(KFAC_DEEP * torch.log1p(K2_CONST * mmid),
                          0.01, 0.6)
    cf_shal = torch.clamp(KFAC_SHAL * torch.log1p(K2_CONST * mmid),
                          0.01, 0.2)
    incloud = (ii >= icb[:, None]) & (ii <= ict[:, None])
    cldfra = torch.where(incloud,
                         torch.where(deep[:, None], cf_deep, cf_shal), 0.0)

    act = active[:, None]
    return EmanuelOut(
        ft=torch.where(act, ft, 0.0), fq=torch.where(act, fq, 0.0),
        fu=torch.where(act, fu, 0.0), fv=torch.where(act, fv, 0.0),
        precip=torch.where(active, torch.clamp(precip, min=0.0), 0.0),
        cbmf=torch.where(active, cbmf, 0.0),
        cldfra=torch.where(act, cldfra, 0.0),
        kbase=icb, ktop=ict, active=active,
        ftra=None if tra is None else torch.where(act[:, :, None], ftra, 0.0))
