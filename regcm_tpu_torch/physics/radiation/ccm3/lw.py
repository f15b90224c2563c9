"""CCM3 longwave: absorptivity/emissivity formulation, torch twin of
``regcm_tpu/physics/radiation/ccm3/lw.py``.

``radclw`` / ``radtpl`` / ``radoz2`` / ``radabs`` / ``radems``
(``Main/radlib/mod_rad_radiation.F90:1876-3945``) and the trace-gas
module (``Main/radlib/mod_rad_tracer.F90``). The all-pairs (k1, k2)
absorptivity is one broadcast over a (ncol, kz+1, kz+1) tensor and the
nearest-layer set one over (ncol, kz, 4). Pressures dynes/cm², fluxes
cgs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import tables as tb


def _dbvt(t):
    """Planck derivative at 9.6 µm (dbvt)."""
    return (-2.8911366682e-4 + (2.3771251896e-6 + 1.1305188929e-10 * t)
            * t) / (1.0 + (-6.1364820707e-3 + 1.5550319767e-5 * t) * t)


def _fo3(u, v):
    return u / torch.sqrt(4.0 + u * (1.0 + v))


def _func(u, b):
    """Trace-gas band function (trcab func)."""
    return u / torch.sqrt(4.0 + u * (1.0 + 1.0 / torch.clamp(b, min=1e-30)))


def radtpl(ts, tnm, pmln, qnm, piln, pint, plh2o):
    """Temperatures and H2O path quantities (radtpl,
    mod_rad_radiation.F90:3987-4080). All (ncol, kz[+1]), k=0 top."""
    ncol, kz = tnm.shape
    dy = (piln[:, 1:kz] - pmln[:, 1:kz]) \
        / (pmln[:, 0:kz - 1] - pmln[:, 1:kz])
    tint_mid = tnm[:, 1:kz] - dy * (tnm[:, 1:kz] - tnm[:, 0:kz - 1])
    tint = torch.cat([tnm[:, :1], tint_mid, ts[:, None]], dim=1)
    tint4 = tint ** 4
    tlayr = torch.cat([tint[:, :1], tnm], dim=1)
    tlayr4 = tlayr ** 4
    tplnka = torch.cat([tnm[:, :1], 0.5 * (tint[:, 1:] + tint[:, :-1])],
                       dim=1)
    tplnke = tplnka[:, 0]
    rtnm = 1.0 / tnm
    dpnm = pint[:, 1:] - pint[:, :-1]
    dpnmsq = pint[:, 1:] ** 2 - pint[:, :-1] ** 2
    s2t0 = plh2o[:, :1] * tnm[:, :1]
    w0 = tb.SSLP * (plh2o[:, :1] * 2.0) / pint[:, :1]
    s2c0 = plh2o[:, :1] * torch.exp(1800.0 * (rtnm[:, :1] - tb.R296)) \
        * qnm[:, :1] * tb.REPSIL
    s2t = torch.cat([s2t0, s2t0 + torch.cumsum(tb.RGSSLP * dpnmsq * qnm * tnm, dim=1)], dim=1)
    w = torch.cat([w0, w0 + torch.cumsum(tb.REGRAVGTS * qnm * dpnm, dim=1)], dim=1)
    s2c = torch.cat(
        [s2c0, s2c0 + torch.cumsum(
            tb.RGSSLP * dpnmsq * qnm
            * torch.exp(1800.0 * (rtnm - tb.R296)) * qnm * tb.REPSIL, dim=1)],
        dim=1)
    return dict(tint=tint, tint4=tint4, tlayr=tlayr, tlayr4=tlayr4,
                tplnka=tplnka, tplnke=tplnke, s2t=s2t, w=w, s2c=s2c)


def radoz2(o3vmr, pint):
    """Ozone path lengths (radoz2, :3946-3979)."""
    plos0 = 0.1 * tb.CPLOS * o3vmr[:, :1] * pint[:, :1]
    plol0 = 0.01 * tb.CPLOL * o3vmr[:, :1] * pint[:, :1] ** 2
    plos = torch.cat([plos0, plos0 + torch.cumsum(
        0.1 * tb.CPLOS * o3vmr * (pint[:, 1:] - pint[:, :-1]), dim=1)], dim=1)
    plol = torch.cat([plol0, plol0 + torch.cumsum(
        0.01 * tb.CPLOL * o3vmr * (pint[:, 1:] ** 2 - pint[:, :-1] ** 2), dim=1)], dim=1)
    return plos, plol


def trcmix(dlat, xptrop, pmid, gas):
    """Latitude/height-dependent trace gas mixing ratios (trcmix,
    mod_rad_tracer.F90:58-112)."""
    alat = torch.abs(dlat)[:, None]
    lo = alat <= 45.0
    xn2o = torch.where(lo, 0.3478 + 0.00116 * alat,
                       0.4000 + 0.013333 * (alat - 45.0))
    xch4 = torch.where(lo, alat.new_tensor(0.2353),
                       0.2353 + 0.0225489 * (alat - 45.0))
    xcfc11 = torch.where(lo, 0.7273 + 0.00606 * alat,
                         1.00 + 0.013333 * (alat - 45.0))
    xcfc12 = torch.where(lo, 0.4000 + 0.00222 * alat,
                         0.50 + 0.024444 * (alat - 45.0))
    below = pmid >= xptrop[:, None]
    pratio = torch.clamp(pmid / xptrop[:, None], max=1.0)
    mix = lambda g0, x: torch.where(below, pmid.new_tensor(g0),
                                    g0 * pratio ** x)
    return (mix(gas["n2o0"], xn2o), mix(gas["ch40"], xch4),
            mix(gas["cfc110"], xcfc11), mix(gas["cfc120"], xcfc12))


def trcpth(tnm, pnm, cfc11, cfc12, n2o, ch4, qnm, co2mmr):
    """Trace gas path lengths (trcpth, mod_rad_tracer.F90:153-244):
    dict of (ncol, kz+1) interface paths."""
    diff = 1.66
    t1 = tnm[:, :1]
    p1 = pnm[:, :1]
    rsq1 = 1.0 / torch.sqrt(t1)
    co2fac1 = diff * co2mmr * p1 * tb.REGRAVGTS
    alpha1_1 = (1.0 - torch.exp(-1540.0 / t1)) ** 3 / torch.sqrt(t1)
    alpha2_1 = (1.0 - torch.exp(-1360.0 / t1)) ** 3 / torch.sqrt(t1)
    top = dict(
        ucfc11=1.8 * cfc11[:, :1] * p1 * tb.REGRAVGTS,
        ucfc12=1.8 * cfc12[:, :1] * p1 * tb.REGRAVGTS,
        un2o0=diff * 1.02346e5 * n2o[:, :1] * p1 * tb.REGRAVGTS * rsq1)
    top["un2o1"] = diff * 2.01909 * top["un2o0"] * torch.exp(-847.36 / t1)
    top["uch4"] = diff * 8.60957e4 * ch4[:, :1] * p1 * tb.REGRAVGTS * rsq1
    top["uco211"] = 3.42217e3 * co2fac1 * alpha1_1 * torch.exp(-1849.7 / t1)
    top["uco212"] = 6.02454e3 * co2fac1 * alpha1_1 * torch.exp(-2782.1 / t1)
    top["uco213"] = 5.53143e3 * co2fac1 * alpha1_1 * torch.exp(-3723.2 / t1)
    top["uco221"] = 3.88984e3 * co2fac1 * alpha2_1 * torch.exp(-1997.6 / t1)
    top["uco222"] = 3.67108e3 * co2fac1 * alpha2_1 * torch.exp(-3843.8 / t1)
    top["uco223"] = 6.50642e3 * co2fac1 * alpha2_1 * torch.exp(-2989.7 / t1)
    top["bn2o0"] = diff * 19.399 * p1 ** 2 * n2o[:, :1] * 1.02346e5 \
        * tb.REGRAVGTS / (tb.SSLP * t1)
    top["bn2o1"] = top["bn2o0"] * torch.exp(-847.36 / t1) * 2.06646e5
    top["bch4"] = diff * 2.94449 * ch4[:, :1] * p1 ** 2 \
        * tb.REGRAVGTS * 8.60957e4 / (tb.SSLP * t1)
    top["uptype"] = diff * qnm[:, :1] * p1 ** 2 \
        * torch.exp(1800.0 * (1.0 / t1 - 1.0 / 296.0)) \
        * tb.REGRAVGTS / tb.SSLP

    rt = 1.0 / tnm
    rsqrt = torch.sqrt(rt)
    pbar = 0.5 * (pnm[:, 1:] + pnm[:, :-1]) / tb.SSLP
    dpnm = (pnm[:, 1:] - pnm[:, :-1]) * tb.REGRAVGTS
    alpha1 = diff * rsqrt * (1.0 - torch.exp(-1540.0 / tnm)) ** 3
    alpha2 = diff * rsqrt * (1.0 - torch.exp(-1360.0 / tnm)) ** 3
    inc = dict(
        ucfc11=1.8 * cfc11 * dpnm,
        ucfc12=1.8 * cfc12 * dpnm,
        un2o0=diff * 1.02346e5 * n2o * rsqrt * dpnm,
        un2o1=diff * 2.06646e5 * n2o * rsqrt
        * torch.exp(-847.36 / tnm) * dpnm,
        uch4=diff * 8.60957e4 * ch4 * rsqrt * dpnm,
        uco211=1.15 * 3.42217e3 * alpha1 * co2mmr
        * torch.exp(-1849.7 / tnm) * dpnm,
        uco212=1.15 * 6.02454e3 * alpha1 * co2mmr
        * torch.exp(-2782.1 / tnm) * dpnm,
        uco213=1.15 * 5.53143e3 * alpha1 * co2mmr
        * torch.exp(-3723.2 / tnm) * dpnm,
        uco221=1.15 * 3.88984e3 * alpha2 * co2mmr
        * torch.exp(-1997.6 / tnm) * dpnm,
        uco222=1.15 * 3.67108e3 * alpha2 * co2mmr
        * torch.exp(-3843.8 / tnm) * dpnm,
        uco223=1.15 * 6.50642e3 * alpha2 * co2mmr
        * torch.exp(-2989.7 / tnm) * dpnm,
        bn2o0=diff * 19.399 * pbar * rt * 1.02346e5 * n2o * dpnm,
        bn2o1=diff * 19.399 * pbar * rt * 2.06646e5
        * torch.exp(-847.36 / tnm) * n2o * dpnm,
        bch4=diff * 2.94449 * rt * pbar * 8.60957e4 * ch4 * dpnm,
        uptype=diff * qnm * torch.exp(1800.0 * (1.0 / tnm - 1.0 / 296.0))
        * pbar * dpnm)
    return {key: torch.cat([top[key], top[key] + torch.cumsum(inc[key], dim=1)],
                           dim=1) for key in top}


def trcplk(tint, tlayr, tplnke):
    """Planck functions for the trace-gas bands (trcplk): emplnk
    (ncol, 14), abplnk1/2 (ncol, kz+1, 14)."""
    f = lambda a: torch.as_tensor(a, dtype=tint.dtype, device=tint.device)
    f1, f2, f3 = f(tb.PLK_F1), f(tb.PLK_F2), f(tb.PLK_F3)
    emplnk = f1[None, :] / (tplnke[:, None] ** 4
                            * (torch.exp(f3[None, :] / tplnke[:, None])
                               - 1.0))

    def ab(tarr):
        t = tarr[:, :, None]
        return (f2[None, None, :] * torch.exp(f3[None, None, :] / t)) \
            / (t ** 5 * (torch.exp(f3[None, None, :] / t) - 1.0) ** 2)
    return emplnk, ab(tint), ab(tlayr)


def _h2o_terms(dtx, dty, bands):
    """Band polynomial terms 1-5 (radems bands 1,3; radabs bands 2,4)."""
    t = {}
    for ib in bands:
        t[ib] = dict(
            term1=tb.COEFE[0, ib] + tb.COEFE[1, ib] * dtx
            * (1.0 + tb.C1[ib] * dtx),
            term2=tb.COEFB[0, ib] + tb.COEFB[1, ib] * dtx
            * (1.0 + tb.C2[ib] * dtx * (1.0 + tb.C3[ib] * dtx)),
            term3=tb.COEFD[0, ib] + tb.COEFD[1, ib] * dtx
            * (1.0 + tb.C4[ib] * dtx * (1.0 + tb.C5[ib] * dtx)),
            term4=tb.COEFA[0, ib] + tb.COEFA[1, ib] * dty
            * (1.0 + tb.C6[ib] * dty),
            term5=tb.COEFC[0, ib] + tb.COEFC[1, ib] * dty
            * (1.0 + tb.C7[ib] * dty))
    return t


def _trc_tw(tt, pnew, wfac, ds2c, duptyp):
    """6-band H2O overlap transmission tw(l) of trcab/trcabn/trcems."""
    tws = []
    for l in range(6):
        psi1 = torch.exp(tb.TRC_ABP[l] * tt + tb.TRC_BBP[l] * tt * tt)
        phi1 = torch.exp(tb.TRC_AB[l] * tt + tb.TRC_BB[l] * tt * tt)
        p1 = pnew * (psi1 / phi1) / tb.SSLP
        w1 = wfac * phi1
        tws.append(torch.exp(
            -tb.TRC_G1[l] * p1
            * (torch.sqrt(1.0 + tb.TRC_G2[l]
                          * (w1 / torch.clamp(p1, min=1e-30))) - 1.0)
            - tb.TRC_G3[l] * ds2c - tb.TRC_G4[l] * duptyp))
    return tws


def _trc_gas_abs(tw, du1, du2, duch4, dbetac, du01, du11, dbeta01,
                 dbeta11, duc11, duc12, duc13, dbetc1, dbetc2,
                 duc21, duc22, duc23, tlw, th2o, tco2, to3, sqti, plk):
    """CFC/CH4/N2O/CO2-minor absorptivity sum of trcab, trcabn and
    trcems; plk[i] is the Planck factor of band i."""
    tcfc3 = torch.exp(-175.005 * du1)
    tcfc4 = torch.exp(-1202.18 * du1)
    tcfc6 = torch.exp(-5786.73 * du2)
    tcfc7 = torch.exp(-2873.51 * du2)
    tcfc8 = torch.exp(-2085.59 * du2)
    acfc1 = 50.0 * (1.0 - torch.exp(-54.09 * du1)) * tw[0] * plk[6]
    acfc2 = 60.0 * (1.0 - torch.exp(-5130.03 * du1)) * tw[1] * plk[7]
    acfc3 = 60.0 * (1.0 - tcfc3) * tw[3] * tcfc6 * plk[8]
    acfc4 = 100.0 * (1.0 - tcfc4) * tw[4] * plk[9]
    acfc5 = 45.0 * (1.0 - torch.exp(-1272.35 * du2)) * tw[2] * plk[10]
    acfc6 = 50.0 * (1.0 - tcfc6) * tw[3] * plk[11]
    acfc7 = 80.0 * (1.0 - tcfc7) * tw[4] * tcfc4 * plk[12]
    acfc8 = 70.0 * (1.0 - tcfc8) * tw[5] * plk[13]
    ach4 = 6.00444 * sqti * torch.log(1.0 + _func(duch4, dbetac)) \
        * tlw * plk[2]
    tch4 = 1.0 / (1.0 + 0.02 * _func(duch4, dbetac))
    an2o1 = 2.35558 * sqti * torch.log(
        1.0 + _func(du01, dbeta01) + _func(du11, dbeta11)) \
        * tlw * tch4 * plk[3]
    du02 = 0.100090 * du01
    du12 = 0.0992746 * du11
    dbeta02 = 0.964282 * dbeta01
    an2o2 = 2.65581 * sqti * torch.log(
        1.0 + _func(du02, dbeta02) + _func(du12, dbeta02)) \
        * th2o * tco2 * plk[4]
    du03 = 0.0333767 * du01
    dbeta03 = 0.982143 * dbeta01
    an2o3 = 2.54034 * sqti * torch.log(1.0 + _func(du03, dbeta03)) \
        * tw[5] * tcfc8 * plk[5]
    aco21 = 3.7571 * sqti * torch.log(
        1.0 + _func(duc11, dbetc1) + _func(duc12, dbetc2)
        + _func(duc13, dbetc2)) * to3 * tw[4] * tcfc4 * tcfc7 * plk[1]
    aco22 = 3.8443 * sqti * torch.log(
        1.0 + _func(duc21, dbetc1) + _func(duc22, dbetc1)
        + _func(duc23, dbetc2)) * tw[3] * tcfc3 * tcfc6 * plk[0]
    return (acfc1 + acfc2 + acfc3 + acfc4 + acfc5 + acfc6 + acfc7
            + acfc8 + an2o1 + an2o2 + an2o3 + ach4 + aco21 + aco22)


def radems(pint, tp, plh2o, plco2, plos, plol, paths, emplnk, co2vmr):
    """Total gas emissivity (radems, mod_rad_radiation.F90:3557-3782)
    + trace-gas emissivity (trcems). Returns emsgastot (ncol, kz+1) and
    the co2t/co2em/co2eml/h2otr arrays reused by radabs."""
    tplnke = tp["tplnke"][:, None]
    tlayr = tp["tlayr"]
    tlayr4 = tp["tlayr4"]
    tint = tp["tint"]
    tint4 = tp["tint4"]
    s2c = tp["s2c"]
    s2t = tp["s2t"]
    w = tp["w"]
    ex = torch.exp(960.0 / tplnke[:, 0])
    co2plk = 5.0e8 / (tplnke[:, 0] ** 4 * (ex - 1.0))
    dp = pint[:, 1:] - pint[:, :-1]
    xsum = tplnke * pint[:, :1] \
        + torch.cat([torch.zeros_like(pint[:, :1]),
                     torch.cumsum(tlayr[:, 1:] * dp, dim=1)], dim=1)
    co2t = xsum / pint
    exl = torch.exp(960.0 / tlayr[:, 1:])
    co2eml = 1.2e11 * exl / (tlayr[:, 1:] * tlayr4[:, 1:]
                             * (exl - 1.0) ** 2)
    # H2O emissivity over all interfaces at once
    uc = s2c + 2.0e-3 * plh2o
    ux = plh2o
    sqrtu = torch.sqrt(ux)
    uc1 = (s2c + 1.7e-3 * plh2o) * (1.0 + 2.0 * s2c) / (1.0 + 15.0 * s2c)
    tpathe = s2t / plh2o
    dtx = tplnke - 250.0
    dty = tpathe - 250.0
    terms = _h2o_terms(dtx, dty, (0, 2))
    dtp = dty - 50.0
    dtz = dtx - 50.0
    a11 = 0.37 - 3.33e-5 * dtz + 3.33e-6 * dtz * dtz
    a31 = 1.07 - 1.00e-3 * dtp + 1.475e-5 * dtp * dtp
    a21 = 1.3870 + 3.80e-3 * dtz - 7.8e-6 * dtz * dtz
    a22 = 1.0 - 1.21e-3 * dtp - 5.33e-6 * dtp * dtp
    a23 = 0.9 + 2.62 * sqrtu
    corfac = a31 * (a11 + ((a21 * a22) / a23))
    t1t4 = terms[0]["term1"] * terms[0]["term4"]
    t2t5 = terms[0]["term2"] * terms[0]["term5"]
    a = t1t4 + t2t5 / (1.0 + t2t5 * sqrtu * corfac)
    fwk = tb.FWCOEF + tb.FWC1 / (1.0 + tb.FWC2 * ux)
    rsum = torch.exp(-a * (sqrtu + fwk * ux))
    emis1 = (1.0 - rsum) * terms[0]["term3"]
    a41 = 1.75 - 3.96e-3 * dtz
    a51 = 1.00 + 1.3 * sqrtu
    a61 = 1.00 + 1.25e-3 * dtp + 6.25e-5 * dtp * dtp
    corfac = 0.3 * (1.0 + a41 / a51) * a61
    t1t4 = terms[2]["term1"] * terms[2]["term4"]
    t2t5 = terms[2]["term2"] * terms[2]["term5"]
    a = t1t4 + t2t5 / (1.0 + t2t5 * sqrtu * corfac)
    rsum = torch.exp(-a * (sqrtu + fwk * ux))
    emis2 = (1.0 - rsum) * terms[2]["term3"]
    trline = []
    for l in range(2):
        phi = torch.exp(tb.A1[l] * (dty + 15.0)
                        + tb.A2[l] * (dty + 15.0) ** 2)
        psi = torch.exp(tb.B1[l] * (dty + 15.0)
                        + tb.B2[l] * (dty + 15.0) ** 2)
        ubar = w * phi * 1.66 * tb.R80257
        pbar = (ux / w) * (psi / phi)
        cf812 = tb.CFA1 + ((1.0 - tb.CFA1) / (1.0 + ubar * pbar * 10.0))
        g1 = (tb.REALK[l] * pbar) / (2.0 * tb.ST[l])
        g2 = 1.0 + (ubar * 4.0 * tb.ST[l] * cf812) / pbar
        trline.append(torch.exp(-(g1 * (torch.sqrt(g2) - 1.0))))
    xterm6 = tb.COEFF[0, 0] + tb.COEFF[1, 0] * dtx \
        * (1.0 + tb.C8 * dtx * (1.0 + tb.C10 * dtx
           * (1.0 + tb.C12 * dtx * (1.0 + tb.C14 * dtx))))
    term7 = [tb.COEFJ[0, 0] + tb.COEFJ[1, 0] * dty * (1.0 + tb.C16 * dty),
             tb.COEFJ[0, 1] + tb.COEFJ[1, 1] * dty * (1.0 + tb.C26 * dty)]
    term8 = [tb.COEFK[0, 0] + tb.COEFK[1, 0] * dty * (1.0 + tb.C17 * dty),
             tb.COEFK[0, 1] + tb.COEFK[1, 1] * dty * (1.0 + tb.C27 * dty)]
    trem4 = torch.exp(-(tb.COEFG[0, 0] + tb.COEFG[1, 0] * dtx) * uc) \
        * trline[1]
    trem6 = torch.exp(-(tb.COEFG[0, 1] + tb.COEFG[1, 1] * dtx) * uc) \
        * trline[0]
    emis3 = xterm6 * (1.0 - trem4 * 0.5 - trem6 * 0.5)
    k21 = term7[0] + term8[0] / (1.0 + (tb.C30 + tb.C31
                                        * (dty - 10.0) ** 2) * sqrtu)
    k22 = term7[1] + term8[1] / (1.0 + (tb.C28 + tb.C29
                                        * (dty - 10.0)) * sqrtu)
    xterm9 = tb.COEFI[0, 0] + tb.COEFI[1, 0] * dtx \
        * (1.0 + tb.C18 * dtx * (1.0 + tb.C20 * dtx
           * (1.0 + tb.C22 * dtx * (1.0 + tb.C24 * dtx))))
    tr1 = torch.exp(-(k21 * (sqrtu + tb.FC1 * fwk * ux)))
    tr2 = torch.exp(-(k22 * (sqrtu + tb.FC1 * fwk * ux)))
    tr3 = torch.exp(-((tb.COEFH[0, 0] + tb.COEFH[1, 0] * dtx) * uc1))
    tr4 = torch.exp(-((tb.COEFH[0, 1] + tb.COEFH[1, 1] * dtx) * uc1))
    tr7 = tr1 * tr3
    tr8 = tr2 * tr4
    emis4 = xterm9 * 0.5 * (tr1 - tr7 + tr2 - tr8)
    h2oems = emis1 + emis2 + emis3 + emis4
    troco2 = 0.65 * tr7 + 0.35 * tr8
    th2o = tr8
    # CO2 15µm band emissivity
    sqti = torch.sqrt(co2t)
    rsqti = 1.0 / sqti
    et = torch.exp(-480.0 / co2t)
    et2 = et * et
    et4 = et2 * et2
    omet = 1.0 - 1.5 * et2
    f1co2 = 899.70 * omet * (1.0 + 1.94774 * et + 4.73486 * et2) * rsqti
    sqwp = torch.sqrt(plco2)
    f1sqwp = f1co2 * sqwp
    t1co2 = 1.0 / (1.0 + 245.18 * omet * sqwp * rsqti)
    oneme = 1.0 - et2
    alphat = oneme ** 3 * rsqti
    wco2 = 2.5221 * co2vmr * pint * tb.REGRAVGTS
    u7 = 4.9411e4 * alphat * et2 * wco2
    u8 = 3.9744e4 * alphat * et4 * wco2
    u9 = 1.0447e5 * alphat * et4 * et2 * wco2
    u13 = 2.8388e3 * alphat * et4 * wco2
    tcrfac = torch.sqrt((tplnke * tb.R250) * (co2t * tb.R300))
    pi = pint * tb.RSSLP + 2.0 * tb.DPFCO2 * tcrfac
    posqt = pi / (2.0 * sqti)
    rbeta7 = 1.0 / (5.3288 * posqt)
    rbeta8 = 1.0 / (10.6576 * posqt)
    f2co2 = (u7 / torch.sqrt(4.0 + u7 * (1.0 + rbeta7))) \
        + (u8 / torch.sqrt(4.0 + u8 * (1.0 + rbeta8))) \
        + (u9 / torch.sqrt(4.0 + u9 * (1.0 + rbeta7)))
    f3co2 = u13 / torch.sqrt(4.0 + u13 * (1.0 + rbeta7))
    absbnd = (torch.log(1.0 + f1sqwp) + 2.0 * t1co2
              * torch.log(1.0 + f2co2) + 2.0 * torch.log(1.0 + f3co2)) \
        * sqti
    tco2 = 1.0 / (1.0 + 10.0 * (u7 / torch.sqrt(4.0 + u7
                                                * (1.0 + rbeta7))))
    co2ems = troco2 * absbnd * co2plk[:, None]
    exi = torch.exp(960.0 / tint)
    co2em = 1.2e11 * exi / (tint * tint4 * (exi - 1.0) ** 2)
    # O3 9.6µm emissivity
    h2otr = torch.exp(-12.0 * s2c)
    te = (co2t / 293.0) ** 0.7
    u1 = 18.29 * plos / te
    u2 = 0.5649 * plos / te
    phat = plos / plol
    tcrfac = torch.sqrt(tplnke * tb.R250) * te
    beta = (1.0 / 0.3205) * ((1.0 / phat) + tb.DPFO3 * tcrfac)
    realnu = (1.0 / beta) * te
    o3bndi = 74.0 * te * (tplnke / 375.0) \
        * torch.log(1.0 + _fo3(u1, realnu) + _fo3(u2, realnu))
    o3ems = _dbvt(tplnke) * h2otr * o3bndi
    to3 = 1.0 / (1.0 + 0.1 * _fo3(u1, realnu) + 0.1 * _fo3(u2, realnu))
    # trace gas emissivity (trcems)
    tw = _trc_tw(torch.abs(co2t - 250.0), pint, w, s2c, paths["uptype"])
    plk = [emplnk[:, i][:, None] for i in range(14)]
    emstrc = _trc_gas_abs(
        tw, paths["ucfc11"], paths["ucfc12"], paths["uch4"],
        paths["bch4"] / paths["uch4"],
        paths["un2o0"], paths["un2o1"],
        paths["bn2o0"] / paths["un2o0"],
        paths["bn2o1"] / paths["un2o1"],
        paths["uco211"], paths["uco212"], paths["uco213"],
        2.97558 * pint / (tb.SSLP * sqti),
        2.0 * 2.97558 * pint / (tb.SSLP * sqti),
        paths["uco221"], paths["uco222"], paths["uco223"],
        torch.exp(-torch.sqrt(plh2o)), th2o, tco2, to3, sqti, plk)
    emsgastot = h2oems + co2ems + o3ems + emstrc
    return dict(emsgastot=emsgastot, co2t=co2t, co2em=co2em,
                co2eml=co2eml, h2otr=h2otr)


def _safe_div(a, b, eps=1e-30):
    return a / torch.where(torch.abs(b) < eps,
                           torch.where(b < 0, b.new_tensor(-eps), eps), b)


def _h2o_abs_common(ux, sqrtu, uc, uc1, dw, pnew, dtx, dty):
    """H2O absorptivity bands of radabs (:2955-3025), shared by the
    non-nearest and nearest blocks."""
    terms = _h2o_terms(dtx, dty, (1, 3))
    dtyp15 = dty + 15.0
    dtyp15sq = dtyp15 ** 2
    dtz = dtx - 50.0
    dtp = dty - 50.0
    a11 = 0.44 + 3.380e-4 * dtz - 1.520e-6 * dtz * dtz
    a31 = 1.05 - 6.000e-3 * dtp + 3.000e-6 * dtp * dtp
    a21 = 1.00 + 1.717e-3 * dtz - 1.133e-5 * dtz * dtz
    a22 = 1.00 + 4.443e-3 * dtp + 2.750e-5 * dtp * dtp
    a23 = 1.00 + 3.600 * sqrtu
    corfac = a31 * (a11 + ((2.0 * a21 * a22) / a23))
    t1t4 = terms[1]["term1"] * terms[1]["term4"]
    t2t5 = terms[1]["term2"] * terms[1]["term5"]
    a = t1t4 + t2t5 / (1.0 + t2t5 * sqrtu * corfac)
    fwk = tb.FWCOEF + tb.FWC1 / (1.0 + tb.FWC2 * ux)
    fwku = fwk * ux
    rsum = torch.exp(-a * (sqrtu + fwku))
    abso1 = (1.0 - rsum) * terms[1]["term3"]
    a41 = 1.75 - 3.960e-3 * dtz
    a51 = 1.00 + 1.3 * sqrtu
    a61 = 1.00 + 1.250e-3 * dtp + 6.250e-5 * dtp * dtp
    corfac = 0.29 * (1.0 + a41 / a51) * a61
    t1t4 = terms[3]["term1"] * terms[3]["term4"]
    t2t5 = terms[3]["term2"] * terms[3]["term5"]
    a = t1t4 + t2t5 / (1.0 + t2t5 * sqrtu * corfac)
    rsum = torch.exp(-a * (sqrtu + fwku))
    abso2 = (1.0 - rsum) * terms[3]["term3"]
    trline = []
    for l in range(2):
        phi = torch.exp(tb.A1[l] * dtyp15 + tb.A2[l] * dtyp15sq)
        psi = torch.exp(tb.B1[l] * dtyp15 + tb.B2[l] * dtyp15sq)
        ubar = dw * phi * 1.66 * tb.R80257
        pbar = pnew * (psi / phi)
        cf812 = tb.CFA1 + (1.0 - tb.CFA1) / (1.0 + ubar * pbar * 10.0)
        g2 = 1.0 + ubar * 4.0 * tb.ST[l] * cf812 \
            / torch.clamp(pbar, min=1e-30)
        g4 = tb.REALK[l] * pbar * (1.0 / (2.0 * tb.ST[l])) \
            * (torch.sqrt(g2) - 1.0)
        trline.append(torch.exp(-g4))
    term7 = [tb.COEFJ[0, 0] + tb.COEFJ[1, 0] * dty * (1.0 + tb.C16 * dty),
             tb.COEFJ[0, 1] + tb.COEFJ[1, 1] * dty * (1.0 + tb.C26 * dty)]
    term8 = [tb.COEFK[0, 0] + tb.COEFK[1, 0] * dty * (1.0 + tb.C17 * dty),
             tb.COEFK[0, 1] + tb.COEFK[1, 1] * dty * (1.0 + tb.C27 * dty)]
    dtym10 = dty - 10.0
    k21 = term7[0] + term8[0] / (1.0 + (tb.C30 + tb.C31 * dtym10
                                        * dtym10) * sqrtu)
    k22 = term7[1] + term8[1] / (1.0 + (tb.C28 + tb.C29 * dtym10) * sqrtu)
    tr1 = torch.exp(-(k21 * (sqrtu + tb.FC1 * fwku)))
    tr2 = torch.exp(-(k22 * (sqrtu + tb.FC1 * fwku)))
    tr5 = torch.exp(-((tb.COEFH[0, 2] + tb.COEFH[1, 2] * dtx) * uc1))
    tr6 = torch.exp(-((tb.COEFH[0, 3] + tb.COEFH[1, 3] * dtx) * uc1))
    tr9 = tr1 * tr5
    tr10 = tr2 * tr6
    trab2 = 0.65 * tr9 + 0.35 * tr10
    trab4 = torch.exp(-(tb.COEFG[0, 2] + tb.COEFG[1, 2] * dtx) * uc)
    trab6 = torch.exp(-(tb.COEFG[0, 3] + tb.COEFG[1, 3] * dtx) * uc)
    abso3fac = 1.0 - trab4 * 0.5 * trline[1] - trab6 * 0.5 * trline[0]
    abso4fac = 0.5 * (tr1 - tr9 + tr2 - tr10)
    return abso1, abso2, abso3fac, abso4fac, tr10, trab2


def _co2_15um(sqwp, tpath_t, wco2_pi, posqt):
    """CO2 15µm band absorptance pieces (radabs :3196-3246)."""
    et = torch.exp(-480.0 / tpath_t)
    sqti = torch.sqrt(tpath_t)
    rsqti = 1.0 / sqti
    et2 = et * et
    et4 = et2 * et2
    omet = 1.0 - 1.5 * et2
    f1co2 = 899.70 * omet * (1.0 + 1.94774 * et + 4.73486 * et2) * rsqti
    f1sqwp = f1co2 * sqwp
    t1co2 = 1.0 / (1.0 + 245.18 * omet * sqwp * rsqti)
    oneme = 1.0 - et2
    alphat = oneme ** 3 * rsqti
    wco2 = 2.5221 * wco2_pi * tb.REGRAVGTS
    u7 = 4.9411e4 * alphat * et2 * wco2
    u8 = 3.9744e4 * alphat * et4 * wco2
    u9 = 1.0447e5 * alphat * et4 * et2 * wco2
    u13 = 2.8388e3 * alphat * et4 * wco2
    rbeta7 = 1.0 / (5.3228 * posqt)
    rbeta8 = 1.0 / (10.6576 * posqt)
    f2co2 = (u7 / torch.sqrt(4.0 + u7 * (1.0 + rbeta7))) \
        + (u8 / torch.sqrt(4.0 + u8 * (1.0 + rbeta8))) \
        + (u9 / torch.sqrt(4.0 + u9 * (1.0 + rbeta7)))
    f3co2 = u13 / torch.sqrt(4.0 + u13 * (1.0 + rbeta7))
    tco2 = 1.0 / (1.0 + 10.0 * (u7 / torch.sqrt(4.0 + u7
                                                * (1.0 + rbeta7))))
    return f1sqwp, t1co2, f2co2, f3co2, tco2


def _term69(dtx, coef, c9, c11, c13, c15):
    return coef[0, 1] + coef[1, 1] * dtx * (1.0 + c9 * dtx * (
        1.0 + c11 * dtx * (1.0 + c13 * dtx * (1.0 + c15 * dtx))))


def radabs(pint, pmid, piln, pmln, tp, em, plh2o, plco2, plos, plol,
           paths, abplnk1, abplnk2, co2vmr):
    """Gas absorptivities (radabs, mod_rad_radiation.F90:2879-3523 +
    trcab/trcabn): absgastot (ncol, kz+1, kz+1) indexed [k1, k2] and
    absgasnxt (ncol, kz, 4)."""
    ncol, kzp1 = pint.shape
    dev = pint.device
    tint = tp["tint"]
    tlayr = tp["tlayr"]
    tplnka = tp["tplnka"]
    s2c = tp["s2c"]
    s2t = tp["s2t"]
    w = tp["w"]
    co2t = em["co2t"]
    h2otr = em["h2otr"]
    dbvtit = _dbvt(tint)

    dtx_k = tplnka - 250.0
    term6 = _term69(dtx_k, tb.COEFF, tb.C9, tb.C11, tb.C13, tb.C15)
    term9 = _term69(dtx_k, tb.COEFI, tb.C19, tb.C21, tb.C23, tb.C25)

    # ---- non-nearest pairs: axes (ncol, k1, k2) ------------------------
    e1 = lambda a: a[:, :, None]
    e2 = lambda a: a[:, None, :]
    dplh2o = e1(plh2o) - e2(plh2o)
    ux = torch.abs(dplh2o)
    sqrtu = torch.sqrt(ux)
    ds2c = torch.abs(e1(s2c) - e2(s2c))
    dw = torch.abs(e1(w) - e2(w))
    uc1 = (ds2c + 1.7e-3 * ux) * (1.0 + 2.0 * ds2c) / (1.0 + 15.0 * ds2c)
    uc = ds2c + 2.0e-3 * ux
    pnew = _safe_div(ux, dw)
    tpatha = _safe_div(e1(s2t) - e2(s2t), dplh2o)
    dtx = e2(tplnka) - 250.0
    dty = tpatha - 250.0
    (abso1, abso2, abso3fac, abso4fac, th2o_nn,
     trab2) = _h2o_abs_common(ux, sqrtu, uc, uc1, dw, pnew, dtx, dty)
    abso3 = e2(term6) * abso3fac
    abso4 = e2(term9) * abso4fac
    # O3 9.6µm
    to3h2o = torch.exp(-12.0 * ds2c)
    dpnm = e1(pint) - e2(pint)
    to3co2 = _safe_div(e1(pint * co2t) - e2(pint * co2t), dpnm)
    te = (to3co2 * tb.R293) ** 0.7
    dplos = e1(plos) - e2(plos)
    dplol = e1(plol) - e2(plol)
    u1 = 18.29 * torch.abs(dplos) / te
    u2 = 0.5649 * torch.abs(dplos) / te
    rphat = _safe_div(dplol, dplos)
    tcrfac = torch.sqrt(e2(tint) * tb.R250) * te
    beta = tb.R3205 * (rphat + tb.DPFO3 * tcrfac)
    realnu = _safe_div(te, beta)
    tmp1 = u1 / torch.sqrt(4.0 + u1 * (1.0 + realnu))
    tmp2 = u2 / torch.sqrt(4.0 + u2 * (1.0 + realnu))
    o3bndi = 74.0 * te * torch.log(1.0 + tmp1 + tmp2)
    abso5 = o3bndi * to3h2o * e2(dbvtit)
    to3_nn = 1.0 / (1.0 + 0.1 * tmp1 + 0.1 * tmp2)
    # CO2 15µm
    sqwp = torch.sqrt(torch.abs(e1(plco2) - e2(plco2)))
    sqti_p = torch.sqrt(to3co2)
    rsqti = 1.0 / sqti_p
    tcrfac = torch.sqrt(e2(tint) * tb.R250 * to3co2 * tb.R300)
    posqt = ((e2(pint) + e1(pint)) * tb.R2SSLP
             + tb.DPFCO2 * tcrfac) * rsqti
    f1sqwp, t1co2, f2co2, f3co2, tco2_nn = _co2_15um(
        sqwp, to3co2, co2vmr * torch.abs(dpnm), posqt)
    # sqti switches to the layer T when k2 >= k1 (radabs :3237-3239)
    kk = torch.arange(kzp1, device=dev)
    upper = kk[None, None, :] >= kk[None, :, None]
    sqti_use = torch.where(upper, torch.sqrt(e2(tlayr)), sqti_p)
    absbnd = (torch.log(1.0 + f1sqwp) + 2.0 * t1co2
              * torch.log(1.0 + f2co2) + 2.0 * torch.log(1.0 + f3co2)) \
        * sqti_use
    abso6 = trab2 * e2(em["co2em"]) * absbnd
    absgastot = abso1 + abso2 + abso3 + abso4 + abso5 + abso6
    # trace gases (trcab)
    tw = _trc_tw(torch.abs(to3co2 - 250.0), pnew, dw, ds2c,
                 torch.abs(e1(paths["uptype"]) - e2(paths["uptype"])))
    dpair = lambda key: torch.abs(e1(paths[key]) - e2(paths[key]))
    duch4 = dpair("uch4")
    du01 = dpair("un2o0")
    du11 = dpair("un2o1")
    dbetc1 = 2.97558 * torch.abs(e1(pint) + e2(pint)) \
        / (2.0 * tb.SSLP * sqti_p)
    plk_nn = [e2(abplnk1[:, :, i]) for i in range(14)]
    abstrc = _trc_gas_abs(
        tw, dpair("ucfc11"), dpair("ucfc12"), duch4,
        _safe_div(dpair("bch4"), duch4),
        du01, du11,
        _safe_div(dpair("bn2o0"), du01),
        _safe_div(dpair("bn2o1"), du11),
        dpair("uco211"), dpair("uco212"), dpair("uco213"),
        dbetc1, 2.0 * dbetc1,
        dpair("uco221"), dpair("uco222"), dpair("uco223"),
        torch.exp(-torch.sqrt(ux)), th2o_nn, tco2_nn, to3_nn, sqti_p,
        plk_nn)
    absgastot = absgastot + abstrc

    # ---- nearest-layer block: axes (ncol, kz, 4) -----------------------
    tint_a = tint[:, :-1]
    tint_b = tint[:, 1:]
    tlay_l = tlayr[:, 1:]
    co2em_a = em["co2em"][:, :-1]
    co2em_b = em["co2em"][:, 1:]
    co2eml = em["co2eml"]
    dbvtly = _dbvt(tlay_l)
    dbvtit_a = dbvtit[:, :-1]
    dbvtit_b = dbvtit[:, 1:]
    e3 = lambda a: a[:, :, None]
    st4 = lambda *a: torch.stack(a, dim=2)
    tbar1 = 0.5 * (tint_b + tlay_l)
    tbar2 = 0.5 * (tlay_l + tint_a)
    tbar3 = 0.5 * (tbar1 + tbar2)
    tbar = st4(tbar1, tbar2, tbar3, tbar3)
    emm_b = 0.5 * (co2em_b + co2eml)
    emm_a = 0.5 * (co2em_a + co2eml)
    emm = st4(emm_b, emm_a, emm_b, emm_a)
    o3_b = 0.5 * (dbvtit_b + dbvtly)
    o3_a = 0.5 * (dbvtit_a + dbvtly)
    o3emm = st4(o3_b, o3_a, o3_b, o3_a)
    temh2o = st4(tbar1, tbar2, tbar1, tbar2)
    pi_a = pint[:, :-1]
    pi_b = pint[:, 1:]
    dpnm_l = pi_b - pi_a
    pnmsq_a = pi_a ** 2
    pnmsq_b = pi_b ** 2
    p1 = 0.5 * (pmid + pi_b)
    p2 = 0.5 * (pmid + pi_a)
    rdpnmsq = 1.0 / (pnmsq_b - pnmsq_a)
    rdpnm = 1.0 / dpnm_l
    uinpl = st4((pnmsq_b - p1 ** 2) * rdpnmsq,
                -(pnmsq_a - p2 ** 2) * rdpnmsq,
                -(pnmsq_a - p1 ** 2) * rdpnmsq,
                (pnmsq_b - p2 ** 2) * rdpnmsq)
    winpl = st4((0.5 * (pi_b - pmid)) * rdpnm,
                (0.5 * (pmid - pi_a)) * rdpnm,
                (0.5 * (pi_b + pmid) - pi_a) * rdpnm,
                (pi_b - 0.5 * (pi_a + pmid)) * rdpnm)
    tmp1z = 1.0 / (piln[:, 1:] - piln[:, :-1])
    tmp2z = piln[:, 1:] - pmln
    tmp3z = piln[:, :-1] - pmln
    zinpl = st4((0.5 * tmp2z) * tmp1z,
                (-0.5 * tmp3z) * tmp1z,
                (0.5 * tmp2z - tmp3z) * tmp1z,
                (tmp2z - 0.5 * tmp3z) * tmp1z)
    pinpl = st4(0.5 * (p1 + pi_b), 0.5 * (p2 + pi_a),
                0.5 * (p1 + pi_a), 0.5 * (p2 + pi_b))
    # bplnk: (ncol, kz, 4, 14)
    bp1 = 0.5 * (abplnk1[:, 1:, :] + abplnk2[:, :-1, :])
    bp2 = 0.5 * (abplnk1[:, :-1, :] + abplnk2[:, :-1, :])
    bplnk = st4(bp1, bp2, bp1, bp2)

    dplh2o_l = e3(torch.abs(plh2o[:, :-1] - plh2o[:, 1:]))
    ux_n = uinpl * dplh2o_l
    sqrtu_n = torch.sqrt(ux_n)
    dw_n = e3(torch.abs(w[:, :-1] - w[:, 1:]))
    pnew_n = _safe_div(ux_n, winpl * dw_n)
    ds2c_l = e3(torch.abs(s2c[:, :-1] - s2c[:, 1:]))
    uc1_n = uinpl * ds2c_l
    uc1_n = (uc1_n + 1.7e-3 * ux_n) * (1.0 + 2.0 * uc1_n) \
        / (1.0 + 15.0 * uc1_n)
    uc_n = uinpl * ds2c_l + 2.0e-3 * ux_n
    dtx_n = temh2o - 250.0
    dty_n = tbar - 250.0
    (abso1n, abso2n, abso3facn, abso4facn, th2o_n,
     trab2n) = _h2o_abs_common(ux_n, sqrtu_n, uc_n, uc1_n, dw_n * winpl,
                               pnew_n, dtx_n, dty_n)
    # term6/term9 recomputed with the sub-layer dtx (radabs :3395-3410)
    abso3n = _term69(dtx_n, tb.COEFF, tb.C9, tb.C11, tb.C13, tb.C15) \
        * abso3facn
    abso4n = _term69(dtx_n, tb.COEFI, tb.C19, tb.C21, tb.C23, tb.C25) \
        * abso4facn
    te_n = (tbar * tb.R293) ** 0.7
    dplos_l = e3(torch.abs(plos[:, 1:] - plos[:, :-1]))
    u1n = zinpl * 18.29 * dplos_l / te_n
    u2n = zinpl * 0.5649 * dplos_l / te_n
    tcrfac_n = torch.sqrt(tbar * tb.R250) * te_n
    beta_n = tb.R3205 * (pinpl * tb.RSSLP + tb.DPFO3 * tcrfac_n)
    realnu_n = te_n / beta_n
    tmp1n = u1n / torch.sqrt(4.0 + u1n * (1.0 + realnu_n))
    tmp2n = u2n / torch.sqrt(4.0 + u2n * (1.0 + realnu_n))
    o3bndi_n = 74.0 * te_n * torch.log(1.0 + tmp1n + tmp2n)
    abso5n = o3bndi_n * o3emm * e3(h2otr[:, 1:] / h2otr[:, :-1])
    to3_n = 1.0 / (1.0 + 0.1 * tmp1n + 0.1 * tmp2n)
    dplco2_l = e3(plco2[:, 1:] - plco2[:, :-1])
    sqwp_n = torch.sqrt(uinpl * dplco2_l)
    posqt_n = (pinpl * tb.RSSLP
               + tb.DPFCO2 * torch.sqrt((tbar * tb.R250)
                                        * (tbar * tb.R300))) \
        / torch.sqrt(tbar)
    f1sqwpn, t1co2n, f2co2n, f3co2n, tco2_n = _co2_15um(
        sqwp_n, tbar, co2vmr * e3(torch.abs(dpnm_l)) * winpl, posqt_n)
    absbnd_n = (torch.log(1.0 + f1sqwpn) + 2.0 * t1co2n
                * torch.log(1.0 + f2co2n) + 2.0
                * torch.log(1.0 + f3co2n)) * torch.sqrt(tbar)
    abso6n = trab2n * emm * absbnd_n
    absgasnxt = abso1n + abso2n + abso3n + abso4n + abso5n + abso6n
    # trcabn
    tw_n = _trc_tw(torch.abs(tbar - 250.0), pnew_n, dw_n * winpl,
                   uinpl * ds2c_l,
                   uinpl * e3(torch.abs(paths["uptype"][:, 1:]
                                        - paths["uptype"][:, :-1])))
    dn = lambda key: winpl * e3(torch.abs(paths[key][:, 1:]
                                          - paths[key][:, :-1]))
    rsqti_n = 1.0 / torch.sqrt(tbar)
    dbetac_n = 2.94449 * pinpl * rsqti_n / tb.SSLP
    dbeta01_n = 19.399 * pinpl * rsqti_n / tb.SSLP
    dbetc1_n = 2.97558 * pinpl * rsqti_n / tb.SSLP
    plk_n = [bplnk[:, :, :, i] for i in range(14)]
    abstrc_n = _trc_gas_abs(
        tw_n, dn("ucfc11"), dn("ucfc12"), dn("uch4"), dbetac_n,
        dn("un2o0"), dn("un2o1"), dbeta01_n, dbeta01_n,
        dn("uco211"), dn("uco212"), dn("uco213"),
        dbetc1_n, 2.0 * dbetc1_n,
        dn("uco221"), dn("uco222"), dn("uco223"),
        torch.exp(-torch.sqrt(ux_n)), th2o_n, tco2_n, to3_n,
        torch.sqrt(tbar), plk_n)
    absgasnxt = absgasnxt + abstrc_n
    # the k1==k2 diagonal is never consumed (radclw takes adjacent
    # layers from absnxt) and holds 0/0 artifacts: zero it
    absgastot = torch.where(kk[None, :, None] == kk[None, None, :], 0.0,
                            absgastot)
    return absgastot, absgasnxt


class LWResult(NamedTuple):
    qrl: torch.Tensor      # longwave heating rate (K/s), (ncol, kz)
    flns: torch.Tensor     # net surface up-down flux (cgs)
    flnt: torch.Tensor     # net TOA outgoing
    lwout: torch.Tensor    # upward at TOA
    lwin: torch.Tensor     # downward at TOA
    flnsc: torch.Tensor    # clear-sky surface net
    flntc: torch.Tensor    # clear-sky TOA
    flwds: torch.Tensor    # surface downward LW


def radclw(ts, emiss, effcld, tp, emsgastot, abstot, absnxt, pint):
    """Longwave fluxes with cloud overlap (radclw,
    mod_rad_radiation.F90:1876-2306).

    effcld (ncol, kz+1): index i = Fortran layer i+1, [:, kz] = 0. The
    bottom-counting cloud search and the overlap flux loops are masked
    contractions over a bottom-index axis."""
    ncol, kzp1 = pint.shape
    kz = kzp1 - 1
    dev = pint.device
    tint4 = tp["tint4"]
    tlayr4 = tp["tlayr4"]
    tplnke = tp["tplnke"]
    stebol = tb.STEBOL
    ar = lambda lo, hi: torch.arange(lo, hi, device=dev)

    # tclrsf[:, j] = Fortran tclrsf(j+1); tclrsf(k+1)=tclrsf(k)(1-cld(k+1))
    tclrsf = torch.cat([torch.ones_like(pint[:, :1]),
                        torch.cumprod(1.0 - effcld[:, 1:], dim=1)], dim=1)
    rtclrsf = 1.0 / torch.clamp(tclrsf, min=1e-30)

    # lowest/highest cloudy bottom-index (klov/khiv); cld at bottom
    # index k = effcld[:, kzp1-k] = cld_bot[:, k-1]
    cld_bot = torch.flip(effcld, [1])
    hascld = cld_bot > 0.0
    any_cld = torch.any(hascld, dim=1)
    hascld_i = hascld.to(torch.int32)
    klov = torch.where(any_cld, torch.argmax(hascld_i, dim=1) + 1, 0)
    khiv = torch.where(any_cld,
                       kzp1 - torch.argmax(torch.flip(hascld_i, [1]),
                                           dim=1), 0)
    khivm = khiv - 1

    # fclt4/fclb4 per Fortran layer j (py j-1), nonzero for bottom
    # index k = kzp1-j in [klov, khiv]
    kofj = kzp1 - ar(1, kz + 1)
    inrange = (kofj[None, :] >= klov[:, None]) \
        & (kofj[None, :] <= khiv[:, None]) & any_cld[:, None]
    fclt4 = torch.where(inrange, stebol * tint4[:, 1:kzp1], 0.0)
    pad_t4 = torch.cat([tint4, tint4[:, -1:]], dim=1)
    fclb4 = torch.where(inrange, stebol * pad_t4[:, 2:kzp1 + 1], 0.0)

    # ---- S integrals (ncol, kzp1, km=2..kzp1) --------------------------
    delt = tint4[:, 0:kz] - tlayr4[:, 1:kzp1]
    delt1 = tlayr4[:, 1:kzp1] - tint4[:, 1:kzp1]
    k_ax = ar(1, kzp1 + 1)[None, :, None]
    km_ax = ar(2, kzp1 + 1)[None, None, :]
    bk_far = 0.5 * (abstot[:, :, 0:kz] + abstot[:, :, 1:kzp1])
    an = lambda m: absnxt[:, None, :, m]
    bk2 = torch.where(k_ax == km_ax, an(3),
                      torch.where(k_ax == km_ax - 1, an(1), bk_far))
    bk1 = torch.where(k_ax == km_ax, an(0),
                      torch.where(k_ax == km_ax - 1, an(2), bk_far))
    B = stebol * (bk2 * delt[:, None, :] + bk1 * delt1[:, None, :])
    # s(k,km) = Σ_{m=km..kzp1} B(k,m): reversed cumsum over km
    s_km = torch.flip(torch.cumsum(torch.flip(B, [2]), dim=2), [2])
    # 1-based padded S: S[:, k, c] = s(k, c), zero elsewhere
    S = torch.zeros((ncol, kzp1 + 1, kzp1 + 2), dtype=pint.dtype,
                    device=dev)
    S[:, 1:, 2:kzp1 + 1] = s_km              # fresh tensor: local write

    # ---- clear-sky fluxes ----------------------------------------------
    fsul_sfc = emiss * stebol * ts ** 4
    tmp = fsul_sfc - stebol * tint4[:, -1]
    k1b = ar(1, kzp1)
    s_k_kp1 = S[:, k1b, k1b + 1]
    fsul = torch.cat([fsul_sfc[:, None] - abstot[:, 0:kz, kz] * tmp[:, None]
                      + s_k_kp1, fsul_sfc[:, None]], dim=1)
    bt4 = stebol * tplnke[:, None] ** 4
    fsdl = emsgastot * bt4
    dm = ar(0, kz - 1)
    fsdl = torch.cat([
        fsdl[:, :1],
        fsdl[:, 1:kz] - (S[:, 2:kzp1, 2]
                         - S[:, 2:kzp1, 3:kzp1 + 1][:, dm, dm]),
        fsdl[:, kz:] - S[:, kzp1, 2][:, None]], dim=1)

    # ---- cloud modifications -------------------------------------------
    a_ax = ar(1, kzp1 + 1)
    b_ax = ar(1, kzp1 + 1)
    take1 = lambda arr, fidx: arr[:, torch.clamp(fidx - 1, 0, kz)]
    rt_khiv = torch.gather(
        rtclrsf, 1, torch.clamp(kzp1 - khiv[:, None] - 1, 0, kz))

    fclb4p = torch.cat([torch.zeros_like(pint[:, :1]), fclb4], dim=1)
    fclt4p = torch.cat([torch.zeros_like(pint[:, :1]), fclt4], dim=1)
    tclr_kz = tclrsf[:, kz - 1][:, None]
    bmask = (b_ax[None, :] >= 3) & (b_ax[None, :] <= khiv[:, None])
    rt_km2 = take1(rtclrsf, kzp1 + 1 - b_ax)
    w_b = torch.where(bmask, cld_bot * tclr_kz * rt_km2, 0.0)
    fclb4_b = fclb4p[:, torch.clamp(kzp1 - b_ax, 0, kz)]
    s_b4 = S[:, kzp1, :][:, torch.clamp(kzp1 + 3 - b_ax, 0, kzp1 + 1)]
    fdl_sfc_cld = fsdl[:, kz] * (tclrsf[:, kz - 1] * rt_khiv[:, 0]) \
        + fclb4p[:, kz - 1] * effcld[:, kz - 1] \
        + torch.sum(w_b * (fclb4_b - s_b4), dim=1)
    fdl = torch.cat([fsdl[:, :kz],
                     torch.where(any_cld, fdl_sfc_cld, fsdl[:, kz])[:, None]],
                    dim=1)

    # ful rows: bottom index a ↔ Fortran level k2 = kzp2-a (py kzp1-a)
    S_k2 = torch.flip(S, [1])[:, 0:kzp1, :]
    diag = ar(0, kzp1)
    s_k2_k3 = S_k2[:, :, torch.clamp(kzp1 + 2 - a_ax, 0, kzp1 + 1)][
        :, diag, diag]
    s_k2_km3 = S_k2[:, :, torch.clamp(kzp1 + 2 - b_ax, 0, kzp1 + 1)]
    fclt4_b = fclt4p[:, torch.clamp(kzp1 - b_ax, 0, kz)]
    tclr_b1 = take1(tclrsf, kzp1 - b_ax)
    fsul_bot = torch.flip(fsul, [1])[:, 0:kzp1]
    # loop A: a in [klov, khivm], b in [klov, min(a, khivm)]
    mA_a = (a_ax[None, :] >= klov[:, None]) \
        & (a_ax[None, :] <= khivm[:, None]) & any_cld[:, None]
    mA_b = (b_ax[None, :] <= khivm[:, None]) \
        & (b_ax[None, :] >= klov[:, None])
    mA = mA_a[:, :, None] & mA_b[:, None, :] \
        & (b_ax[None, None, :] <= a_ax[None, :, None])
    rt_a1 = take1(rtclrsf, kzp1 - a_ax)
    WA = torch.where(mA, (cld_bot * tclr_b1)[:, None, :], 0.0) \
        * rt_a1[:, :, None]
    fulA = fsul_bot * (tclrsf[:, kz][:, None] * rt_a1) \
        + torch.sum(WA * (fclt4_b[:, None, :] + s_k2_k3[:, :, None]
                          - s_k2_km3), dim=2)
    # loop B: a in [khiv, kzp1], b in [klov, khiv]
    mB_a = (a_ax[None, :] >= khiv[:, None]) & any_cld[:, None]
    mB_b = (b_ax[None, :] >= klov[:, None]) \
        & (b_ax[None, :] <= khiv[:, None])
    mB = mB_a[:, :, None] & mB_b[:, None, :]
    WB = torch.where(mB, (cld_bot * tclr_b1)[:, None, :], 0.0) \
        * rt_khiv[:, :, None]
    fulB = fsul_bot * (tclrsf[:, kz][:, None] * rt_khiv) \
        + torch.sum(WB * (fclt4_b[:, None, :] + s_k2_k3[:, :, None]
                          - s_k2_km3), dim=2)
    ful = torch.flip(torch.where(mB_a, fulB,
                                 torch.where(mA_a, fulA, fsul_bot)), [1])

    # fdl rows: a in [2, khivm]; sum over b in [max(a+1, klov), khiv]
    s_b4_k2 = S_k2[:, :, torch.clamp(kzp1 + 3 - b_ax, 0, kzp1 + 1)]
    mD_a = (a_ax[None, :] >= 2) & (a_ax[None, :] <= khivm[:, None]) \
        & any_cld[:, None]
    mD = mD_a[:, :, None] & mB_b[:, None, :] \
        & (b_ax[None, None, :] >= a_ax[None, :, None] + 1)
    tclr_a1 = take1(tclrsf, kzp1 - a_ax)
    WD = torch.where(mD, (cld_bot * rt_km2)[:, None, :], 0.0) \
        * tclr_a1[:, :, None]
    fdl_bot = torch.flip(fdl, [1])
    fdlD = torch.sum(WD * (fclb4_b[:, None, :] - s_b4_k2
                           + s_k2_k3[:, :, None]), dim=2) \
        + torch.flip(fsdl, [1])[:, 0:kzp1] * (tclr_a1 * rt_khiv)
    fdl = torch.flip(torch.where(mD_a, fdlD, fdl_bot), [1])

    flns = ful[:, kz] - fdl[:, kz]
    qrl = (ful[:, 0:kz] - fdl[:, 0:kz] - ful[:, 1:] + fdl[:, 1:]) \
        * tb.GOCP / (pint[:, 0:kz] - pint[:, 1:])
    return LWResult(qrl=qrl, flns=flns, flnt=ful[:, 0] - fdl[:, 0],
                    lwout=ful[:, 0], lwin=fdl[:, 0],
                    flnsc=fsul[:, kz] - fsdl[:, kz], flntc=fsul[:, 0],
                    flwds=fdl[:, kz])
