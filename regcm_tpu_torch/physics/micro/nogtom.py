"""Nogherotto-Tompkins 5-species implicit microphysics (ipptls=2), torch
twin of ``regcm_tpu/physics/micro/nogtom.py``
(``Main/microlib/mod_micro_nogtom.F90:358``; Nogherotto et al. 2016).

Prognostic qv/qc/qr/qi/qs with an explicit/implicit source-sink matrix
per grid box and a per-layer 5×5 linear solve; sedimentation marches
top-down so each layer's falling flux feeds the next (pfplsx).

The level sweep, which carries the precipitation flux and the
max-random precipitation-cover memory downward, is a loop over levels
on (ncol,) planes. The Fortran ``qsexp/qsimp`` (nqx, nqx) matrices are
5×5 tables of (ncol,) planes with ``None`` for a structural zero. The
implicit system is column-diagonally dominant (each diagonal entry is 1
plus the fall sink plus its column's implicit sinks), so Gaussian
elimination without pivoting in a fixed order solves it, the same
operations for every column whatever the size of the block it lies in
(a decomposed run stays bit-identical to one rank).

Species order: 0=qv, 1=qc (liquid), 2=qr, 3=qi (ice), 4=qs (snow).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...utils import constants as c

IQV, IQL, IQR, IQI, IQS = 0, 1, 2, 3, 4
LFALL = (False, False, True, True, True)   # qr, qi, qs fall
# defaults (mod_runparams/mod_params): vfqr=4, vfqi=0.15, vfqs=1 m/s
VQX = (0.0, 0.0, 4.0, 0.15, 1.0)

ACTIVQX = 1.0e-8
ZEROCF, ONECF = 1.0e-2, 0.99
CLFEPS = 1.0e-6
RLCRITSNOW = 4.0e-5
RCLCRIT_LAND, RCLCRIT_SEA = 5.0e-4, 3.0e-4
RPRC1 = 3.0e2
RPRECRHMAX = 0.7
TW1, TW2, TW3, TW4, TW5 = 1329.31, 0.0074615, 0.85e5, 40.637, 275.0
THOMO = 235.16
ICEINIT = 1.0e-12
RKOOP1, RKOOP2 = 2.583, 0.48116e-2
CIDEN13 = 8.87
AIRCONDUCT = 2.4e-2
RLDCP = 1.0 / (c.wlhsocp - c.wlhvocp)      # cp/Lf
# tunables (mod_params defaults)
RCLDIFF = 1.0e-6
RKCONV = 1.0 / 6000.0
SKCONV = 1.0 / 6000.0
RCOVPMIN = 0.1
RPECONS = 5.547e-5


class NogtomOut(NamedTuple):
    tten: torch.Tensor      # uncoupled K/s, (kz, iy, jx)
    qxten: torch.Tensor     # uncoupled (5, kz, iy, jx)
    rainnc: torch.Tensor    # surface liquid precip flux (kg/m2/s)
    snownc: torch.Tensor    # surface frozen precip flux
    pfplsl: torch.Tensor    # (kz+1, iy, jx) liquid sedimentation flux
    pfplsn: torch.Tensor


def _qliq_phase(t):
    """Mixed-phase partition function ((T−Tice)/(T0−Tice))²."""
    rtice = c.tzero - 23.0
    return torch.clamp(((torch.clamp(t, rtice, c.tzero) - rtice)
                        / 23.0) ** 2, 0.0, 1.0)


def _eeliq(t):
    return c.c2es * torch.exp(c.c3les * (t - c.tzero) / (t - c.c4les))


def _eeice(t):
    return c.c2es * torch.exp(c.c3ies * (t - c.tzero) / (t - c.c4ies))


def _eewm(t, phase):
    return phase * _eeliq(t) + (1.0 - phase) * _eeice(t)


def _edem(t, phase):
    return phase * c.c5alvcp / (t - c.c4les) ** 2 \
        + (1.0 - phase) * c.c5alscp / (t - c.c4ies) ** 2


def _eldcpm(t):
    ph = _qliq_phase(t)
    return ph * c.wlhvocp + (1.0 - ph) * c.wlhsocp


def _add(m, i, j, amt):
    """m[i][j] += amt on a table whose None entries are zeros."""
    m[i][j] = amt if m[i][j] is None else m[i][j] + amt


def _solve5(a, b):
    """Solve a·x = b for a 5×5 table ``a`` of (ncol,) planes (None a
    structural zero) and the list ``b`` of 5 planes: forward elimination
    without pivoting, then back substitution, in a fixed order."""
    n = len(b)
    a = [row[:] for row in a]
    b = b[:]
    for p in range(n):
        for r in range(p + 1, n):
            if a[r][p] is None:
                continue
            m = a[r][p] / a[p][p]
            for j in range(p + 1, n):
                if a[p][j] is not None:
                    _add(a, r, j, -m * a[p][j])
            b[r] = b[r] - m * b[p]
    x = [None] * n
    for r in range(n - 1, -1, -1):
        acc = b[r]
        for j in range(r + 1, n):
            if a[r][j] is not None:
                acc = acc - a[r][j] * x[j]
        x[r] = acc / a[r][r]
    return x


def nogtom(t3, qx5, phs, pfs, rho, fcc, qdetr, heatrt, pverv,
           landmask, dt):
    """One microphysics step (nogtom, mod_micro_nogtom.F90:358-1935).

    t3 (kz,iy,jx) K; qx5 (5,kz,iy,jx) mixing ratios; phs/pfs half/full
    level pressures (Pa); rho density; fcc cloud fraction; qdetr
    convective detrainment (kg/kg per step); heatrt radiative heating
    (K/s); pverv omega (Pa/s); landmask (iy,jx). Returns uncoupled
    tendencies and the surface precipitation fluxes."""
    kz, iy, jx = t3.shape
    ncol = iy * jx
    oneodt = 1.0 / dt
    f = lambda a: a.reshape(a.shape[:-2] + (ncol,))
    tL = f(t3)
    qxL = f(qx5)                       # (5, kz, ncol)
    phsL = f(phs)
    pfsL = f(pfs)
    rhoL = f(rho)
    fccL = torch.clamp(f(fcc), 0.0, 1.0)
    qdetrL = f(qdetr)
    heatL = f(heatrt)
    vervL = f(pverv)
    xlcrit = torch.where(landmask.reshape(ncol) > 0.5,
                         tL.new_tensor(RCLCRIT_LAND), RCLCRIT_SEA)
    pbot = pfsL[kz]
    dpfs = pfsL[1:] - pfsL[:-1]

    qliq = _qliq_phase(tL)
    eeliq = _eeliq(tL)
    eeice = _eeice(tL)
    koop = torch.minimum(RKOOP1 - RKOOP2 * tL, eeliq / eeice)
    eewmt = torch.clamp((eeliq * qliq + eeice * (1.0 - qliq)) / phsL,
                        max=0.5)
    qsmix = eewmt / (1.0 - c.ep1 * eewmt)
    zdelta = (tL > c.tzero).to(tL.dtype)
    eew = torch.clamp((zdelta * eeliq + (1.0 - zdelta) * eeice) / phsL,
                      max=0.5)
    qsice = torch.clamp(eeice / phsL, max=0.5)
    qsice = qsice / (1.0 - c.ep1 * qsice)
    eeliqt = torch.clamp(eeliq / phsL, max=0.5)
    qsliq = eeliqt / (1.0 - c.ep1 * eeliqt)
    qlt = qxL[IQL] + qxL[IQI]
    qliqfrac = torch.where(qlt > 0.0,
                           qxL[IQL] / torch.clamp(qlt, min=1e-30), 0.0)
    qicefrac = torch.where(qlt > 0.0, 1.0 - qliqfrac, 0.0)

    pfplsx = [torch.zeros_like(pbot) for _ in range(5)]
    covptot = torch.zeros_like(pbot)
    zero = torch.zeros_like(pbot)
    dqs, dtts, pfls = [], [], []
    for k in range(kz):
        tk = tL[k]
        qx0 = [qxL[n, k] for n in range(5)]
        ph = phsL[k]
        dens = rhoL[k]
        ccov_in = fccL[k]
        qdet = qdetrL[k]
        hrt = heatL[k]
        wv = vervL[k]
        dp = dpfs[k]
        alfaw = qliq[k]
        koopk = koop[k]
        sqmix0 = qsmix[k]
        eewk = eew[k]
        qsicek = qsice[k]
        qsliqk = qsliq[k]
        eeliqtk = eeliqt[k]
        eeliqk = eeliq[k]
        eeicek = eeice[k]
        qlf = qliqfrac[k]
        qif = qicefrac[k]
        lccover = fccL[k - 1] if k > 0 else zero

        qsexp = [[None] * 5 for _ in range(5)]
        qsimp = [[None] * 5 for _ in range(5)]
        qxfg = list(qx0)

        def addexp(src, snk, amt, update_fg=True):
            _add(qsexp, src, snk, amt)
            _add(qsexp, snk, src, -amt)
            if update_fg:
                qxfg[src] = qxfg[src] + amt

        # evaporate tiny amounts (into vapour; :793-812)
        for n in (IQL, IQI, IQR, IQS):
            tiny = qxfg[n] < ACTIVQX
            addexp(IQV, n, torch.where(tiny, qxfg[n], 0.0),
                   update_fg=False)
            qxfg[n] = torch.where(tiny, 0.0, qxfg[n])

        tc = tk - c.tzero
        gdp = c.egrav / dp
        dtgdp = dt * gdp
        rdtgdp = 1.0 / dtgdp
        # dqs/dT correction factors
        facw = c.c5les / (tk - c.c4les) ** 2
        corr = 1.0 / (1.0 - c.ep1 * eeliqtk)
        dqsliqdt = facw * corr * qsliqk
        corqsliq = 1.0 + c.wlhvocp * dqsliqdt
        faci = c.c5ies / (tk - c.c4ies) ** 2
        corr = 1.0 / (1.0 - c.ep1 * eewk)
        dqsicedt = faci * corr * qsicek
        corqsice = 1.0 + c.wlhsocp * dqsicedt
        facl = alfaw * facw + (1.0 - alfaw) * faci
        corr = 1.0 / (1.0 - c.ep1 * (eewk * 0.0 + sqmix0
                                     / (1.0 + c.ep1 * sqmix0)))
        dqsmixdt = facl * corr * sqmix0
        corqsmix = 1.0 / (1.0 + _eldcpm(tk) * dqsmixdt)
        evaplimmix = torch.clamp((sqmix0 - qx0[IQV]) * corqsmix, min=0.0)

        # fall source from above (:902-910)
        for n in range(5):
            if LFALL[n]:
                src = pfplsx[n] * dtgdp
                _add(qsexp, n, n, src)
                qxfg[n] = qxfg[n] + src

        # supersaturation adjustment (:930-995)
        ltkgt0 = tk > c.tzero
        ltkgthomo = tk > THOMO
        facl_s = torch.where(ltkgt0, tk.new_tensor(1.0),
                             ccov_in + koopk * (1.0 - ccov_in))
        supsat = torch.clamp((qx0[IQV] - facl_s * sqmix0) * corqsmix,
                             min=0.0)
        subsat = torch.clamp((qx0[IQV] - facl_s * sqmix0) * corqsmix,
                             max=0.0)
        big = supsat > c.dlowval
        addexp(IQL, IQV, torch.where(big & ltkgthomo, supsat, 0.0))
        addexp(IQI, IQV, torch.where(big & ~ltkgthomo, supsat, 0.0))
        qlifg = qxfg[IQL] + qxfg[IQI]
        lliq = qlifg > ACTIVQX
        excess = qlifg + subsat
        do_ev = (supsat <= c.dlowval) & (subsat < 0.0) & lliq \
            & (excess < 0.0)
        evap = torch.maximum(-qlifg, -evaplimmix)
        addexp(IQL, IQV, torch.where(do_ev & ltkgthomo, evap, 0.0))
        addexp(IQI, IQV, torch.where(do_ev & ~ltkgthomo, evap, 0.0))

        # convective detrainment (:1021-1036)
        has_det = qdet > ACTIVQX
        det_l = torch.where(has_det, alfaw * qdet, 0.0)
        det_i = torch.where(has_det, (1.0 - alfaw) * qdet, 0.0)
        _add(qsexp, IQL, IQL, det_l)
        _add(qsexp, IQI, IQI, det_i)
        qxfg[IQL] = qxfg[IQL] + det_l
        qxfg[IQI] = qxfg[IQI] + det_i

        # cloud cover refresh for the saturation-adjusted state (:1044)
        ccover = 1.0 - torch.sqrt(torch.clamp(
            1.0 - qx0[IQV] / sqmix0, min=0.0) / 0.4)
        ccover = torch.clamp(ccover, 0.0, ONECF)
        lcloud = ccover >= ZEROCF
        locast = ccover >= ONECF
        tmpa = 1.0 / torch.clamp(ccover, min=ZEROCF)
        ql_incld = torch.where(lcloud, qxfg[IQL] * tmpa, 0.0)
        qi_incld = torch.where(lcloud, qxfg[IQI] * tmpa, 0.0)
        qli_incld = ql_incld + qi_incld

        # turbulent erosion (:1074-1094)
        leros = ccover * RCLDIFF * dt \
            * torch.clamp(sqmix0 - qx0[IQV], min=0.0)
        leros = torch.minimum(torch.minimum(leros, evaplimmix), qlifg)
        leros = torch.where(lliq, leros, 0.0)
        addexp(IQL, IQV, -qlf * leros)
        addexp(IQI, IQV, -qif * leros)

        # condensation from dqsat/dt forcing (:1102-1216)
        dtdp = c.rovcp * tk / ph
        dpmxdt = dp * oneodt
        wtot = torch.maximum(torch.minimum(wv, dpmxdt), -dpmxdt)
        dtdiab = torch.maximum(torch.minimum(hrt, dpmxdt * dtdp),
                               -dpmxdt * dtdp) * dt
        dtforc = dtdp * wtot * dt + dtdiab
        qold = sqmix0
        tcond = torch.clamp(tk + dtforc, min=160.0)
        qp = 1.0 / ph
        sqmix = qold
        for _ in range(2):
            phase2 = _qliq_phase(tcond)
            qsat = torch.clamp(_eewm(tcond, phase2) * qp, max=0.5)
            qsat = qsat / (1.0 - c.ep1 * qsat)
            cond = (sqmix - qsat) / (1.0 + qsat * _edem(tcond, phase2))
            tcond = tcond + _eldcpm(tcond) * cond
            sqmix = sqmix - cond
        dqsat = sqmix - qold
        sqmix = qold
        # dqs > 0: evaporation
        levap = ccover * torch.minimum(dqsat, qli_incld)
        levap = torch.minimum(levap, evaplimmix)
        levap = torch.clamp(torch.minimum(
            levap, torch.clamp(sqmix - qx0[IQV], min=0.0)), min=0.0)
        levap = torch.where(dqsat > 0.0, levap, 0.0)
        addexp(IQV, IQL, qlf * levap, update_fg=False)
        addexp(IQV, IQI, qif * levap, update_fg=False)
        qxfg[IQL] = qxfg[IQL] - qlf * levap
        qxfg[IQI] = qxfg[IQI] - qif * levap
        # dqs < 0: formation in existing clouds
        chng = torch.clamp(-dqsat, min=0.0)
        corr = 1.0 / (1.0 - c.ep1 * sqmix)
        cdmax_oc = (qx0[IQV] - sqmix) \
            / (1.0 + corr * sqmix * _edem(tk, alfaw))
        cdmax_pc = (qx0[IQV] - ccover * sqmix) \
            / torch.clamp(ccover, min=ZEROCF)
        cdmax = torch.where(locast, cdmax_oc, cdmax_pc)
        chng = ccover * torch.minimum(torch.clamp(chng, min=0.0),
                                      torch.clamp(cdmax, min=0.0))
        chng = torch.where(chng < ACTIVQX, 0.0, chng)
        chng = torch.where(lcloud & (dqsat <= -ACTIVQX), chng, 0.0)
        addexp(IQL, IQV, torch.where(ltkgthomo, chng, 0.0))
        addexp(IQI, IQV, torch.where(~ltkgthomo, chng, 0.0))

        # sedimentation sink, included in first guess (:1232-1249)
        fallsink = [None] * 5
        for n in range(5):
            if LFALL[n]:
                sink = dtgdp * VQX[n] * dens
                fallsink[n] = sink
                qxfg[n] = qxfg[n] / (1.0 + sink)

        # vapour deposition on ice (Rotstayn/Meyers, :1275-1335)
        can_dep = (~ltkgt0) & (qxfg[IQL] > ACTIVQX)
        icenuclei = 1000.0 * torch.exp(
            12.96 * (eeliqk - eeicek) / eeicek - 0.639)
        xadd = c.wlhs * (c.wlhs / (c.rwat * tk) - 1.0) \
            / (AIRCONDUCT * tk)
        xbdd = c.rwat * tk * ph / (2.21 * eeicek)
        cvds = torch.clamp(
            (7.8 / torch.clamp(qlf, min=CLFEPS))
            * (icenuclei / dens) ** 0.666 * (eeliqk - eeicek)
            / (CIDEN13 * (xadd + xbdd) * eeicek), min=0.0)
        qice0 = torch.clamp(torch.maximum(qi_incld,
                                          icenuclei * ICEINIT / dens),
                            min=0.0)
        qinew = (0.666 * cvds * dt + qice0 ** 0.666) ** 1.5
        dep = torch.clamp(ccover * (qinew - qice0), min=0.0)
        dep = torch.minimum(dep, torch.clamp(qxfg[IQL], min=0.0))
        dep = torch.where(can_dep, dep, 0.0)
        addexp(IQI, IQL, dep)
        qxfg[IQL] = qxfg[IQL] - dep

        tmpa = 1.0 / torch.clamp(ccover, min=ZEROCF)
        ql_incld = torch.where(lcloud, qxfg[IQL] * tmpa, 0.0)
        qi_incld = torch.where(lcloud, qxfg[IQI] * tmpa, 0.0)

        # precip cover max-random overlap (:1364-1373)
        qpretot0 = qxfg[IQR] + qxfg[IQI] + qxfg[IQS]
        has_pre = (qpretot0 > c.dlowval) & (lccover > c.dlowval)
        covptot = torch.where(
            has_pre,
            torch.clamp(1.0 - ((1.0 - covptot)
                               * (1.0 - torch.maximum(ccover, lccover))
                               / (1.0 - torch.clamp(lccover, max=ONECF))),
                        min=RCOVPMIN),
            0.0)
        covpclr = torch.clamp(covptot - ccover, min=0.0)

        # warm autoconversion (:1378-1402; Sundqvist, the iautoconv=4
        # default, the suite's only choice)
        do_auto = (ql_incld > ACTIVQX) & lcloud
        alpha1 = torch.clamp(ql_incld, max=RKCONV * dt)
        acrit = xlcrit
        hasp = covptot > c.dlowval
        precip = torch.where(hasp, (pfplsx[IQR] + pfplsx[IQS])
                             / torch.clamp(covptot, min=RCOVPMIN), 0.0)
        cfpr = 1.0 + RPRC1 * torch.sqrt(torch.clamp(precip, min=0.0))
        alpha1 = torch.where(hasp, alpha1 * cfpr, alpha1)
        acrit = torch.where(hasp, acrit / torch.clamp(cfpr, min=c.dlowval),
                            acrit)
        arg = (ql_incld / acrit) ** 2
        rainaut = ccover * alpha1 * torch.where(
            arg < 25.0, 1.0 - torch.exp(-torch.clamp(arg, max=25.0)), 1.0)
        rainaut = torch.where(rainaut < ACTIVQX, 0.0, rainaut)
        rainaut = torch.where(do_auto, rainaut, 0.0)
        _add(qsimp, IQR, IQL, torch.where(ltkgt0, rainaut, 0.0))
        _add(qsimp, IQS, IQL, torch.where(~ltkgt0, rainaut, 0.0))

        # snow autoconversion (cold; Lin 83, :1409-1423)
        do_snow = (~ltkgt0) & (qi_incld > ACTIVQX) & lcloud
        alpha1 = torch.minimum(dt * SKCONV * torch.exp(0.025 * tc),
                               qi_incld)
        arg = (qi_incld / RLCRITSNOW) ** 2
        snowaut = ccover * alpha1 * torch.where(
            arg < 25.0, 1.0 - torch.exp(-torch.clamp(arg, max=25.0)), 1.0)
        _add(qsimp, IQS, IQI, torch.where(do_snow, snowaut, 0.0))

        # melting (warm; :1434-1478)
        qicetot = qxfg[IQI] + qxfg[IQS]
        subsat2 = torch.clamp(sqmix0 - qx0[IQV], min=0.0)
        tdiff = tc - subsat2 * (TW1 + TW2 * (ph - TW3)
                                - TW4 * (tk - TW5))
        chngmax = torch.clamp(tdiff * RLDCP, min=0.0)
        can_melt = ltkgt0 & (qicetot > ACTIVQX) & (chngmax > c.dlowval)
        for n, m2 in ((IQI, IQL), (IQS, IQR)):
            phase_n = qxfg[n] / torch.clamp(qicetot, min=1e-30)
            mlt = torch.clamp(torch.minimum(qxfg[n], phase_n * chngmax),
                              min=0.0)
            mlt = torch.where(can_melt, mlt, 0.0)
            qxfg[n] = qxfg[n] - mlt
            qxfg[m2] = qxfg[m2] + mlt
            _add(qsexp, m2, n, mlt)
            _add(qsexp, n, m2, -mlt)

        # freezing of rain (:1489-1500)
        chngmax = torch.clamp((c.tzero - tk) * RLDCP, min=0.0)
        frz_r = torch.where((chngmax > c.dlowval) & (qxfg[IQR] > ACTIVQX),
                            torch.minimum(qxfg[IQR], chngmax), 0.0)
        _add(qsexp, IQS, IQR, frz_r)
        _add(qsexp, IQR, IQS, -frz_r)
        # homogeneous freezing of liquid (:1506-1519)
        chngmax = torch.clamp((THOMO - tk) * RLDCP, min=0.0)
        frz_l = torch.where((chngmax > c.dlowval) & (qxfg[IQL] > ACTIVQX),
                            torch.minimum(qxfg[IQL], chngmax), 0.0)
        addexp(IQI, IQL, frz_l)
        qxfg[IQL] = qxfg[IQL] - frz_l

        # precip evaporation (rain, then snow; :1537-1660)
        qpretot = qxfg[IQR] + qxfg[IQI] + qxfg[IQS]
        for n, qsat_k, corq in ((IQR, qsliqk, corqsliq),
                                (IQS, qsicek, corqsice)):
            zrh = torch.clamp(RPRECRHMAX + (1.0 - RPRECRHMAX) * covpclr
                              / torch.clamp(1.0 - ccover, min=1e-6),
                              RPRECRHMAX, 1.0)
            qe = (qx0[IQV] - ccover * qsat_k) \
                / torch.clamp(1.0 - ccover, min=1e-6)
            qe = torch.minimum(torch.clamp(qe, min=0.0), qsat_k)
            lactiv = (covpclr > c.dlowval) & (covptot > c.dlowval) \
                & (qpretot > c.dlowval) & (qxfg[n] > ACTIVQX) \
                & (qe < zrh * qsat_k)
            preclr = qpretot * covpclr \
                / (torch.clamp(covptot, min=RCOVPMIN) * dtgdp)
            beta1 = torch.sqrt(ph / pbot) / 5.09e-3 * preclr \
                / torch.clamp(covpclr, min=1e-6)
            beta = 0.5 * c.egrav * RPECONS \
                * torch.clamp(beta1, min=0.0) ** 0.5777
            denom = 1.0 + beta * dt * corq
            dpr = covpclr * beta * (qsat_k - qe) / denom * dp * c.regrav
            dpevap = dpr * dtgdp
            dpevap = torch.where(qxfg[n] < ACTIVQX, qxfg[n], dpevap)
            chng_e = torch.where(beta1 >= 0.0,
                                 torch.minimum(dpevap, qxfg[n]), qxfg[n])
            chng_e = torch.clamp(torch.where(lactiv, chng_e, 0.0), min=0.0)
            covptot = torch.where(
                lactiv & (beta1 >= 0.0),
                torch.clamp(covptot - torch.clamp(
                    (covptot - ccover) * dpevap
                    / torch.clamp(qpretot, min=c.dlowval), min=0.0),
                    min=RCOVPMIN),
                covptot)
            _add(qsexp, IQV, n, chng_e)
            _add(qsexp, n, IQV, -chng_e)
            qxfg[n] = qxfg[n] - chng_e

        # ---- sink overshoot rescale (:1670-1752) ----------------------
        scale = []
        for n in range(5):
            row = [e for e in qsexp[n] if e is not None]
            tot = row[0]
            for e in row[1:]:
                tot = tot + e
            sinksum = -tot
            ratio = torch.where(qx0[n] > c.dlowval,
                                torch.clamp(qx0[n], min=c.dlowval)
                                / torch.maximum(sinksum, qx0[n]), 1.0)
            scale.append(torch.where(ratio < c.dlowval, ratio, 1.0))
        neg = [[None if e is None else e < 0.0 for e in row]
               for row in qsexp]
        for i in range(5):
            for j in range(5):
                if neg[i][j] is not None:
                    qsexp[i][j] = torch.where(neg[i][j],
                                              qsexp[i][j] * scale[i],
                                              qsexp[i][j])
        # mirror entries: scale (i, j) by scale[j] where (j, i) was neg
        for i in range(5):
            for j in range(5):
                if neg[j][i] is not None and qsexp[i][j] is not None:
                    qsexp[i][j] = torch.where(neg[j][i],
                                              qsexp[i][j] * scale[j],
                                              qsexp[i][j])

        # ---- implicit 5×5 solve (:1757-1785 + mysolve) ----------------
        # qlhs[jn,n] = -qsimp[jn,n] off-diagonal;
        # diagonal: 1 + fallsink[n] + Σ_jo qsimp[jo,n] (:1757-1771)
        qlhs = [[None] * 5 for _ in range(5)]
        for n in range(5):
            d = torch.ones_like(tk) if fallsink[n] is None \
                else 1.0 + fallsink[n]
            for jo in range(5):
                if qsimp[jo][n] is not None:
                    d = d + qsimp[jo][n]
                    if jo != n:
                        qlhs[jo][n] = -qsimp[jo][n]
            qlhs[n][n] = d
        rhs = []
        for n in range(5):
            r = qx0[n]
            for e in qsexp[n]:
                if e is not None:
                    r = r + e
            rhs.append(r)
        qxn = _solve5(qlhs, rhs)

        dtt = torch.zeros_like(tk)
        for n in range(5):
            fs = fallsink[n]
            pfpl_next = zero if fs is None else fs * qxn[n] * rdtgdp
            fallsrce = pfplsx[n] * dtgdp
            fluxq = fallsrce - (0.0 if fs is None else fs * qxn[n])
            if n != IQV:
                lat = c.wlhvocp if n in (IQL, IQR) else c.wlhsocp
                dtt = dtt + lat * (qxn[n] - qx0[n] - fluxq) * oneodt
            pfplsx[n] = pfpl_next
        dqs.append(torch.stack([(qxn[n] - qx0[n]) * oneodt
                                for n in range(5)]))
        dtts.append(dtt)
        pfls.append(torch.stack(pfplsx))

    qxten = torch.stack(dqs, dim=1).reshape(5, kz, iy, jx)
    tten = torch.stack(dtts).reshape(kz, iy, jx)
    # sedimentation fluxes at interfaces 1..kz (pfl[k] = flux leaving
    # layer k); a zero top flux first
    pfall = torch.cat([torch.zeros((1, 5, ncol), dtype=tL.dtype,
                                   device=tL.device),
                       torch.stack(pfls)], dim=0)
    pfplsl = (pfall[:, IQL] + pfall[:, IQR]).reshape(kz + 1, iy, jx)
    pfplsn = (pfall[:, IQI] + pfall[:, IQS]).reshape(kz + 1, iy, jx)
    return NogtomOut(tten=tten, qxten=qxten, rainnc=pfplsl[kz],
                     snownc=pfplsn[kz], pfplsl=pfplsl, pfplsn=pfplsn)
