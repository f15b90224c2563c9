"""Grell cumulus scheme (icup=2) with the AS74/FC80 closures, torch twin
of ``regcm_tpu/physics/cumulus/grell.py``.

``Main/cumlib/mod_cu_grell.F90`` (``cuparan`` :207, ``cup`` :460-1235):
one updraft/downdraft pair whose moist-static-energy cloud work function
is evaluated on three states (current, large-scale-forced and
cloud-modified), a wind-shear precipitation efficiency, and the
Arakawa-Schubert (igcc=1) or Fritsch-Chappell (igcc=2) closure.

Columns are (ncol, kz) tensors, bottom-up (index 0 = lowest level). The
level searches are masked reductions; the four level recursions (the
height build, the updraft water cascade with its cloud work function,
the downdraft recursion and the cloud-modified heights) are loops over
the levels on (ncol,) planes. Every sum over levels runs in level order
(``level_sum``), so a column gives the same bits in any block of a
decomposed domain. Two documented deviations from the Fortran, shared
with the JAX package: ``detdo`` reads ``dkk(k+1)`` (the reference indexes
a stale loop variable, :849), and the heating bound rescales the mass
flux once, by the worst level (the reference rescales level by level,
:1108-1118). Parameters follow the grellparam defaults
(Main/mod_params.F90:379-400).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...dynamics.hydrostatic import level_sum
from ...utils import constants as c
from ...utils.thermo import pfwsat
from .emanuel import K2_CONST, KFAC_DEEP, KFAC_SHAL

# grellparam defaults
SHRMIN, SHRMAX = 0.30, 0.90
EDTMIN, EDTMAX = 0.20, 0.80
PBCMAX = 50.0
MINCLD = 50.0
HTMIN, HTMAX = -250.0, 500.0
SKBMAX = 0.4
DTAUC = 60.0 * 60.0          # s (namelist is minutes)
ZDETR = 650.0


class GrellOut(NamedTuple):
    outt: torch.Tensor      # (ncol, kz) bottom-up T tendency (K/s)
    outq: torch.Tensor      # qv (mixing ratio) tendency
    pratec: torch.Tensor    # precip rate (kg/m2/s)
    cldfrc: torch.Tensor
    kbcon: torch.Tensor
    ktop: torch.Tensor
    active: torch.Tensor


def _first_true(mask, ii, default):
    """Smallest index with mask True, else default (per column)."""
    out = torch.where(mask, ii, 10 ** 6).amin(dim=1)
    return torch.where(out >= 10 ** 6, default, out)


def _take(a, k):
    """a[n, k[n]] for (ncol, kz) a and (ncol,) integer k."""
    return torch.gather(a, 1, k[:, None])[:, 0]


def _mid(a):
    """½(f_k + f_{k+1}), the top level unchanged."""
    return 0.5 * (a + torch.cat([a[:, 1:], a[:, -1:]], dim=1))


def _heights(p, tv, ter11, psur):
    """Hydrostatic heights: z1 from the surface, then log-p upward."""
    kz = p.shape[1]
    z = torch.empty_like(tv)
    z[:, 0] = ter11 - (torch.log(p[:, 0]) - torch.log(psur)) * c.rgas \
        * tv[:, 0] * c.regrav
    for k in range(1, kz):
        tvbar = 0.5 * (tv[:, k] + tv[:, k - 1])
        z[:, k] = z[:, k - 1] - (torch.log(p[:, k]) - torch.log(p[:, k - 1])) \
            * c.rgas * tvbar * c.regrav
    return z


def cup(t, q, tn, qo, p, psur, ter11, vsp, dtime, igcc=2,
        kbmax=None) -> GrellOut:
    """Grell cup. All (ncol, kz) BOTTOM-UP (index 0 = lowest level);
    t/q current state; tn/qo large-scale-forced state; p (hPa), psur
    (hPa), ter11 terrain (m), vsp wind speed; dtime leapfrog dt.
    kbmax: highest 0-based departure level (the reference derives it
    from hsigma > skbmax, mod_params.F90:2283-2285); defaults to a
    pressure-ratio approximation."""
    ncol, kz = t.shape
    dev = t.device
    ii = torch.arange(kz, device=dev)[None, :]
    rows = torch.arange(ncol, device=dev)
    mbdt = dtime * 5.0e-3

    def env(tt, qq):
        qes = torch.clamp(pfwsat(tt, p * 100.0), min=c.minqq)
        qq = torch.minimum(qq, qes)
        tv = tt * (1.0 + c.ep1 * qq)
        z = _heights(p, tv, ter11, psur)
        he = c.egrav * z + c.cpd * tt + c.wlhv * qq
        hes = c.egrav * z + c.cpd * tt + c.wlhv * qes
        he = torch.minimum(he, hes)
        return qes, qq, tv, z, he, hes

    qes, q, tv, z, he, hes = env(t, q)
    qeso, qo, tvo, zo, heo, heso = env(tn, qo)

    # kdet: highest 0-based level with z > zdetr + terrain (:513)
    kdet = torch.where(z > ZDETR + ter11[:, None], ii, 0).amax(dim=1)
    # dkk (:565-568): kp/(kdet+1) up to kdet, 1.0 above
    iif = ii.to(t.dtype)
    dkk = torch.where(ii <= kdet[:, None],
                      iif / (kdet[:, None].to(t.dtype) + 1.0), 1.0)

    if kbmax is None:
        # approximate sigma > skbmax via pressure: p > skbmax·psur
        kbmax = torch.where(p > SKBMAX * psur[:, None], ii, 0).amax(dim=1)
        kbmax = torch.clamp(kbmax, min=2)
    else:
        kbmax = torch.full((ncol,), int(kbmax), dtype=torch.int64,
                           device=dev)

    # k22: level of max he at or below kbmax (maximi2)
    hem = torch.where(ii <= kbmax[:, None], he, -1e18)
    k22 = torch.argmax(hem, dim=1)
    act = k22 < kbmax

    he_mid, q_mid = _mid(he), _mid(q)
    heo_mid, qo_mid = _mid(heo), _mid(qo)
    hkb = _take(he_mid, k22)
    qkb = _take(q_mid, k22)
    hkbo = _take(heo_mid, k22)
    qkbo = _take(qo_mid, k22)
    hes_mid = _mid(hes)
    heso_mid = _mid(heso)

    kbcon = k22
    # cloud base search with lid removal and the pbcdif retry
    # (:560-612): bounded retries, masked
    for _ in range(6):
        cand = (ii >= kbcon[:, None]) & (hkb[:, None] >= hes_mid)
        kbcon = _first_true(cand, ii, kbmax + 1)
        cand_o = (ii >= kbcon[:, None]) & (hkbo[:, None] >= heso_mid)
        kbcon = _first_true(cand_o, ii, kbmax + 1)
        bad = kbcon > kbmax
        act = act & ~bad
        pbcdif = _take(p, torch.clamp(k22, max=kz - 1)) \
            - _take(p, torch.clamp(kbcon, max=kz - 1))
        retry = act & (pbcdif > PBCMAX)
        k22 = torch.where(retry, k22 + 1, k22)
        act = act & (k22 < kbmax)
        k22c = torch.clamp(k22, max=kz - 1)
        hkb = torch.where(retry, _take(he_mid, k22c), hkb)
        qkb = torch.where(retry, _take(q_mid, k22c), qkb)
        hkbo = torch.where(retry, _take(heo_mid, k22c), hkbo)
        qkbo = torch.where(retry, _take(qo_mid, k22c), qkbo)
        # the reference restarts the base search from kb = k22 after a
        # retry (:565-566): the new hkb can qualify below the failed kbcon
        kbcon = torch.where(retry, k22, kbcon)

    kbcon = torch.clamp(kbcon, max=kz - 2)
    # buoyancy and cloud top (:620-650)
    dby = hkb[:, None] - hes_mid
    dbyo = hkbo[:, None] - heso_mid
    dby[:, kz - 1] = hkb - hes[:, kz - 1]
    dbyo[:, kz - 1] = hkbo - heso[:, kz - 1]
    topc = (ii >= kbcon[:, None]) & (dby <= 0.0)
    ktop = _first_true(topc, ii, kz - 1)
    act = act & (_take(p, kbcon) - _take(p, ktop) >= MINCLD) \
        & topc.any(dim=1)
    ktop = torch.clamp(ktop, 2, kz - 1)

    # kmin: level of min he in [kb, ktop] (minimi2)
    hemin = torch.where((ii >= k22[:, None]) & (ii <= ktop[:, None]),
                        he, 1e18)
    kmin = torch.argmin(hemin, dim=1)
    # the reference rejects kmin <= 3 (1-based, :668): 0-based <= 2
    act = act & (kmin > 2)
    kmin = torch.clamp(kmin, 3, kz - 2)

    # updraft water cascade + cloud work function (:672-716)
    def updraft(qck, dbyX, qesX, tX, zX):
        agam = c.wlhvocp * (c.wlhv / (c.rwat * tX ** 2)) * qesX
        pwc = torch.zeros_like(tX)
        pwcav = torch.zeros_like(tX[:, 0])
        cwf = torch.zeros_like(tX[:, 0])
        for k in range(1, kz - 1):
            inlayer = (k > kbcon) & (k < ktop) & act
            qrch = qesX[:, k] + c.rwlhv * (agam[:, k]
                                           / (1.0 + agam[:, k])) * dbyX[:, k]
            pwc_k = torch.where(inlayer, qck - qrch, 0.0)
            qck = torch.where(inlayer, qrch, qck)
            pwcav = pwcav + pwc_k
            dz1 = zX[:, k] - zX[:, k - 1]
            tbar = 0.5 * (tX[:, k] + tX[:, k - 1])
            gbar = 0.5 * (agam[:, k] + agam[:, k - 1])
            cwf = cwf + torch.where(
                inlayer, dz1 * (c.egrav / (c.cpd * tbar)) * dbyX[:, k - 1]
                / (1.0 + gbar), 0.0)
            pwc[:, k] = pwc_k
        # cloud-top fallout (:718-733)
        pwc_top = qck - _take(qesX, ktop)
        pwc[rows, ktop] = pwc_top
        pwcav = pwcav + pwc_top
        return pwc, pwcav, cwf

    pwc, pwcav, xac = updraft(qkb, dby, qes, t, z)
    pwco, pwcavo, xao = updraft(qkbo, dbyo, qeso, tn, zo)

    # shear-dependent precipitation efficiency (:738-760)
    shr_lay = (ii >= kbcon[:, None]) \
        & (ii <= torch.clamp(ktop, max=kz - 2)[:, None])
    p_kp1 = torch.cat([p[:, 1:], p[:, -1:]], dim=1)
    v_kp1 = torch.cat([vsp[:, 1:], vsp[:, -1:]], dim=1)
    z_kp1 = torch.cat([z[:, 1:], z[:, -1:]], dim=1)
    vshear = level_sum(torch.where(
        shr_lay, (v_kp1 - vsp / torch.clamp(z_kp1 - z, min=1.0))
        * (p - p_kp1), 0.0).T)
    sdp = torch.clamp(level_sum(torch.where(shr_lay, p - p_kp1, 0.0).T),
                      min=1.0)
    vshear = vshear * 1000.0 / sdp
    edt = 1.0 - (1.591 - 0.639 * vshear + 0.0953 * vshear ** 2
                 - 0.00496 * vshear ** 3)
    edt = torch.clamp(edt, SHRMIN, SHRMAX)
    edto = edt

    # downdraft properties (:756-795): from kz-2 down to 0, active
    # below kmin
    def downdraft(hcd0, qcd, hesX, qesX, tX, zX):
        agam_m = c.wlhvocp * (c.wlhv / (c.rwat * _mid(tX) ** 2)) \
            * _mid(qesX)
        hes_m = _mid(hesX)
        qes_m = _mid(qesX)
        bu = torch.zeros_like(tX[:, 0])
        pwcev = torch.zeros_like(tX[:, 0])
        pwcd = torch.zeros_like(tX)
        # the qrcd profile: mid(qes) (:532) overwritten below kmin with
        # the draught value (:780); dellaq reads it
        qrcd_prof = torch.cat([qes_m[:, :-1], qesX[:, -1:]], dim=1)
        for kk in range(kz - 2, -1, -1):
            on = (kk < kmin) & act
            dz = -0.5 * (zX[:, kk] - zX[:, min(kk + 2, kz - 1)])
            dh = hcd0 - hes_m[:, kk]
            bu = bu + torch.where(on, dz * dh, 0.0)
            qrcd = qes_m[:, kk] + c.rwlhv * (agam_m[:, kk]
                                             / (1.0 + agam_m[:, kk])) * dh
            pwcd_k = torch.where(on, dkk[:, kk] * (qcd - qrcd), 0.0)
            qcd = torch.where(on, qrcd, qcd)
            pwcev = pwcev + pwcd_k
            pwcd[:, kk] = pwcd_k
            qrcd_prof[:, kk] = torch.where(on, qrcd, qes_m[:, kk])
        return bu, pwcev, pwcd, qrcd_prof

    hcd = _take(he_mid, kmin)
    hcdo = _take(heo_mid, kmin)
    bu, pwcev, pwcd, qrcd_prof = downdraft(hcd, _take(q_mid, kmin), hes,
                                           qes, t, z)
    buo, pwcevo, _, _ = downdraft(hcdo, _take(qo_mid, kmin), heso, qeso,
                                  tn, zo)

    act = act & (bu < 0.0) & (buo < 0.0) & (pwcev < 0.0) & (pwcevo < 0.0)
    edt_shear = edt       # edtx rescales from the raw shear edt (:752)
    edt = torch.clamp(-edt * pwcav / torch.where(pwcev == 0, -1.0, pwcev),
                      EDTMIN, EDTMAX)
    edto = torch.clamp(-edto * pwcavo
                       / torch.where(pwcevo == 0, -1.0, pwcevo),
                       EDTMIN, EDTMAX)

    # tendencies per unit mass flux: dellah/dellaq (:815-905)
    he_mm1 = torch.cat([he[:, :1], he_mid[:, :-1]], dim=1)   # ½(k,k-1)
    q_mm1 = torch.cat([q[:, :1], q_mid[:, :-1]], dim=1)
    dkk_p1 = torch.cat([dkk[:, 1:], dkk[:, -1:]], dim=1)
    aup = torch.where(ii > k22[:, None], 1.0, 0.0).to(t.dtype)
    adw = torch.where(ii <= kmin[:, None], 1.0, 0.0).to(t.dtype)
    p_km1 = torch.cat([p[:, :1], p[:, :-1]], dim=1)
    dpinv = 1.0 / (50.0 * torch.clamp(p_km1 - p_kp1, min=0.1))
    # detdo reads dkk(k+1), as detdoq does (module docstring)
    detdo = (dkk_p1 - dkk) * (hcd[:, None] - he)
    detdoq = (dkk_p1 - dkk) * (qrcd_prof - q)
    edt2 = edt[:, None]
    dellah = ((aup - adw * dkk_p1 * edt2) * (he_mid - he)
              + (aup - adw * dkk * edt2) * (he - he_mm1)) \
        * c.egrav * dpinv + adw * edt2 * detdo * c.egrav * dpinv
    dellaq = ((aup - adw * dkk_p1 * edt2) * (q_mid - q)
              + (aup - adw * dkk * edt2) * (q - q_mm1)) \
        * c.egrav * dpinv + adw * edt2 * detdoq * c.egrav * dpinv
    # lowest level (:817-830)
    dp_s0 = 50.0 * (psur - p[:, 1])
    dellah[:, 0] = edt * (dkk[:, 1] * hcd - dkk[:, 1] * he_mid[:, 0]) \
        * c.egrav / dp_s0
    dellaq[:, 0] = edt * (dkk[:, 1] * qrcd_prof[:, 1]
                          - dkk[:, 0] * q_mid[:, 0]) * c.egrav / dp_s0
    # cloud top (:907-920)
    dp_top = 100.0 * torch.clamp(_take(p_km1, ktop) - _take(p, ktop),
                                 min=0.1)
    dellah[rows, ktop] = (hkb - _take(he_mm1, ktop)) * c.egrav / dp_top
    dellaq[rows, ktop] = (_take(qes, ktop) - _take(q_mm1, ktop)) \
        * c.egrav / dp_top
    incl = ii <= ktop[:, None]
    dellah = torch.where(incl, dellah, 0.0)
    dellaq = torch.where(incl, dellaq, 0.0)
    dellat = c.rcpd * (dellah - c.wlhv * dellaq)

    # cloud-modified state (x arrays, :855-948): xhe accumulates the
    # tendency on the capped he, xq floors to minqq only when <= 0,
    # xqes has no minqq floor
    xt = t + mbdt * dellat
    xq_raw = q + mbdt * dellaq
    xq = torch.where(xq_raw <= 0.0, c.minqq, xq_raw)
    xqes = pfwsat(xt, p * 100.0)
    xq = torch.minimum(xq, xqes)
    xtv = xt * (1.0 + c.ep1 * xq)
    xz = _heights(p, xtv, ter11, psur)
    xhes = c.egrav * xz + c.cpd * xt + c.wlhv * xqes
    xhe = torch.minimum(he + mbdt * dellah, xhes)
    xhkb = hkb + mbdt * _take(dellah, kbcon)
    xqkb_raw = qkb + mbdt * _take(dellaq, kbcon)
    xqkb = torch.where(xqkb_raw <= 0.0, c.minqq, xqkb_raw)
    xdby = xhkb[:, None] - _mid(xhes)
    _, xpwcav, xxac = updraft(xqkb, xdby, xqes, xt, xz)
    xhcd = _take(_mid(xhe), kmin)
    xbu, xpwcev, _, _ = downdraft(xhcd, _take(_mid(xq), kmin), xhes,
                                  xqes, xt, xz)
    act = act & (xbu < 0.0)
    # edtx rescales the raw shear edt, guarded on |xpwcev| (:1030-1036)
    edtx = torch.where(xpwcev.abs() > 1.0e-20,
                       -edt_shear * xpwcav / xpwcev, edt_shear)
    edtx = torch.clamp(edtx, EDTMIN, EDTMAX)

    # downdraft cloud work contributions (:1030-1080)
    def dd_cwf2(edtX, hcdX, tX, qesX, hesX, zX):
        agam = c.wlhvocp * (c.wlhv / (c.rwat * tX ** 2)) * qesX
        z_kp1c = torch.cat([zX[:, 1:], zX[:, -1:]], dim=1)
        dzv = (zX - z_kp1c) * dkk
        contrib = torch.where(
            ii < kmin[:, None],
            edtX[:, None] * dzv * (c.egrav / (c.cpd * _mid(tX)))
            * ((hcdX[:, None] - _mid(hesX)) / (1.0 + _mid(agam))), 0.0)
        return level_sum(contrib.T)

    xac = xac + dd_cwf2(edt, hcd, t, qes, hes, z)
    xao = xao + dd_cwf2(edto, hcdo, tn, qeso, heso, zo)
    xxac = xxac + dd_cwf2(edtx, xhcd, xt, xqes, xhes, xz)

    # closure (:1086-1102); only columns whose total cloud work function
    # is non-negative close (`if xac >= 0`, :1087)
    act_c = act & (xac >= 0.0)
    if igcc == 1:
        fcl = (xao - xac) / dtime
    else:
        fcl = xac / DTAUC
    xk = (xxac - xac) / mbdt
    xmb = torch.where((fcl <= 0.0) | (xk >= 0.0), 0.0, -fcl / xk)
    xmb = torch.where(act_c, xmb, 0.0)

    # heating bound feedback (:1108-1118), read from the module so a
    # caller may lift it
    outtes = dellat * xmb[:, None] * c.secpd
    fac_hi = torch.where((outtes > HTMAX) & incl,
                         1.001 * HTMAX / torch.clamp(outtes, min=1e-10), 1.0)
    fac_lo = torch.where((outtes < HTMIN) & incl,
                         1.001 * HTMIN / torch.clamp(outtes, max=-1e-10),
                         1.0)
    scale = torch.minimum(fac_hi, fac_lo).amin(dim=1)
    xmb = xmb * torch.clamp(scale, 0.0, 1.0)

    outt = torch.where(incl, dellat * xmb[:, None], 0.0)
    outq = torch.where(incl, dellaq * xmb[:, None], 0.0)
    pratec = torch.clamp(level_sum(torch.where(
        incl, (pwc + edt2 * pwcd) * xmb[:, None], 0.0).T), min=0.0)

    # cloud fraction (:1125-1140)
    mflx = torch.clamp(100.0 * (p / (c.rgas * t)) * dellah * xmb[:, None],
                       min=0.0)
    deep = (_take(z, ktop) - _take(z, kbcon)) > 2000.0
    cf_deep = torch.clamp(KFAC_DEEP * torch.log1p(K2_CONST * mflx),
                          0.01, 0.6)
    cf_shal = torch.clamp(KFAC_SHAL * torch.log1p(K2_CONST * mflx),
                          0.01, 0.2)
    incb = (ii >= kbcon[:, None]) & incl
    # the 0.01 floor stands in the cloud layer even when xmb = 0
    # (:1125-1140): gate on act_c, not on xmb > 0
    cldfrc = torch.where(incb & act_c[:, None],
                         torch.where(deep[:, None], cf_deep, cf_shal), 0.0)

    actf = act_c & (xmb > 0.0)
    am = actf[:, None]
    return GrellOut(outt=torch.where(am, outt, 0.0),
                    outq=torch.where(am, outq, 0.0),
                    pratec=torch.where(actf, pratec, 0.0),
                    cldfrc=cldfrc, kbcon=kbcon, ktop=ktop, active=actf)
