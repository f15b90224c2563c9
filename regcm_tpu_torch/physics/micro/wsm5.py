"""WSM5 single-moment 5-class microphysics (ipptls=3), torch twin of
``regcm_tpu/physics/micro/wsm5.py`` (``Main/microlib/mod_micro_wsm5.F90
:214`` ``wsm5`` and ``wsm52d`` at ``:434``).

The qv/qc/qr/qi/qs mixed-phase source and sink terms of Hong, Dudhia and
Chen (2004) with the Hong-Lim (2006) revisions, the reference's
production-term set with the sequential ``ifsat`` saturation budget and
the per-species conservation rescaling (``:900-1030``). As in the JAX
package: dense (ncol, kz) columns with k=0 at the surface; the
semi-Lagrangian PLM sedimentation replaced by an implicit-upwind
(backward-Euler) flux sweep down the column, here a loop over levels on
(ncol,) planes; the minor-loop count ``loops = max(nint(dt/120), 1)``
(``:528``) a constant of the call.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ...utils import constants as c
from ...utils.thermo import pfwsat

# -- scheme constants (mod_micro_wsm5.F90:33-92) -------------------------
dtcldcr = 120.0
n0r = 8.0e6
avtr = 841.9
bvtr = 0.8
r0 = 0.8e-5
peaut = 0.55
xncr = 3.0e8
xmyu = 1.718e-5
avts = 11.72
bvts = 0.41
n0smax = 1.0e11
lamdarmax = 8.0e4
lamdasmax = 1.0e5
dicon = 11.9
dimax = 500.0e-6
n0s = 2.0e6
alpha = 0.12
pfrz1 = 100.0
pfrz2 = 0.66
qrsmin = 1.0e-15
qcimin = 1.0e-15
eacrc = 1.0
minni = 1.0e3
maxni = 1.0e6

# derived (init_wsm5, mod_micro_wsm5.F90:145-188); rgmma == Γ
_g = math.gamma
qc0 = (4.0 / 3.0) * math.pi * c.rhoh2o * r0 ** 3 * xncr / c.stdrho
qck1 = (0.104 * c.egrav * peaut / (xncr * c.rhoh2o) ** (1.0 / 3.0)
        / xmyu * c.stdrho ** (4.0 / 3.0))
pidnc = math.pi * c.rhoh2o / 6.0
bvtr1, bvtr2, bvtr3, bvtr4 = 1.0 + bvtr, 2.5 + 0.5 * bvtr, 3.0 + bvtr, \
    4.0 + bvtr
g1pbr, g3pbr, g4pbr, g5pbro2 = _g(bvtr1), _g(bvtr3), _g(bvtr4), _g(bvtr2)
pvtr = avtr * g4pbr / 6.0
eacrr = 1.0
pacrr = math.pi * n0r * avtr * g3pbr * 0.25 * eacrr
precr1 = 2.0 * math.pi * n0r * 0.78
precr2 = 2.0 * math.pi * n0r * 0.31 * avtr ** 0.5 * g5pbro2
xmmax = (dimax / dicon) ** 2
roqimax = 2.08e22 * dimax ** 8
bvts1, bvts2, bvts3, bvts4 = 1.0 + bvts, 2.5 + 0.5 * bvts, 3.0 + bvts, \
    4.0 + bvts
g1pbs, g3pbs, g4pbs, g5pbso2 = _g(bvts1), _g(bvts3), _g(bvts4), _g(bvts2)
pvts = avts * g4pbs / 6.0
pacrs = math.pi * n0s * avts * g3pbs * 0.25
precs1 = 4.0 * n0s * 0.65
precs2 = 4.0 * n0s * 0.44 * avts ** 0.5 * g5pbso2
pidn0r = math.pi * c.rhoh2o * n0r
pidn0s = math.pi * c.rhosnow * n0s
pacrc = math.pi * n0s * avts * g3pbs * 0.25 * eacrc
rslopermax = 1.0 / lamdarmax
rslopesmax = 1.0 / lamdasmax


class WSM5Out(NamedTuple):
    t: torch.Tensor        # updated temperature (ncol, kz)
    qv: torch.Tensor
    qc: torch.Tensor
    qi: torch.Tensor
    qr: torch.Tensor
    qs: torch.Tensor
    rain: torch.Tensor     # surface rain rate (mm/s == kg m-2 s-1), (ncol,)
    snow: torch.Tensor     # frozen part of the surface rate (mm/s)
    remrat: torch.Tensor   # rainout rate for chemistry scavenging (1/s)


def _clip(x, lo, hi):
    """jnp.clip with tensor or scalar bounds: min(max(x, lo), hi)."""
    lo = torch.maximum(x, lo) if isinstance(lo, torch.Tensor) \
        else torch.clamp(x, min=lo)
    return torch.minimum(lo, hi) if isinstance(hi, torch.Tensor) \
        else torch.clamp(lo, max=hi)


def _cpm(qv):
    """cpmcal (mod_micro_wsm5.F90:1089): cpd(1-qv)+cpv·qv."""
    q = torch.clamp(qv, min=qcimin)
    return c.cpd * (1.0 - q) + c.cpv * q


def _xl(t):
    """xlcal: latent heat of vaporisation."""
    return c.xlv0 - c.xlv1 * (t - c.tzero)


def _viscos(t, den):
    return 1.496e-6 * t * torch.sqrt(t) / (t + 120.0) / den


def _diffus(t, p):
    return 8.794e-5 * torch.exp(1.81 * torch.log(t)) / p


def _slopes(qr, qs_, den, denfac, t):
    """slope_wsm5 (mod_micro_wsm5.F90:1145-1240): inverse slope powers
    and mass-weighted terminal velocities of rain and snow."""
    supcol = c.tzero - t
    n0sfac = torch.clamp(torch.exp(alpha * supcol), 1.0, n0smax / n0s)
    lamr = torch.sqrt(torch.sqrt(pidn0r / (torch.clamp(qr, min=qrsmin)
                                           * den)))
    lams = torch.sqrt(torch.sqrt(pidn0s * n0sfac
                                 / (torch.clamp(qs_, min=qrsmin) * den)))
    rsr = torch.where(qr <= qrsmin, rslopermax, 1.0 / lamr)
    rss = torch.where(qs_ <= qrsmin, rslopesmax, 1.0 / lams)
    rsrb = rsr ** bvtr
    rssb = rss ** bvts
    vtr = torch.where(qr > 0.0, pvtr * rsrb * denfac, 0.0)
    vts = torch.where(qs_ > 0.0, pvts * rssb * denfac, 0.0)
    return (rsr, rsrb, rsr * rsr, rsr ** 3,
            rss, rssb, rss * rss, rss ** 3, vtr, vts, n0sfac)


def _sediment(rho_q, vt, delz, dtcld):
    """Implicit-upwind sedimentation sweep (in place of
    nislfv_rain_plm), from the top level down to the surface.

    rho_q: ρ·q (kg/m3) on (ncol, kz), k=0 the surface. Returns the new
    ρ·q and the flux through each cell's bottom (kg/m2/s)."""
    kz = rho_q.shape[1]
    flux_in = torch.zeros_like(rho_q[:, 0])
    rq_new = [None] * kz
    flux = [None] * kz
    for k in range(kz - 1, -1, -1):
        dz = delz[:, k]
        rq_new[k] = (rho_q[:, k] + dtcld * flux_in / dz) \
            / (1.0 + dtcld * vt[:, k] / dz)
        flux[k] = flux_in = vt[:, k] * rq_new[k]
    return torch.stack(rq_new, dim=1), torch.stack(flux, dim=1)


def wsm5(t0, qv0, qc0_, qi0, qr0, qs0, p, delz, den, qsat, rh, delt):
    """One WSM5 call on (ncol, kz) columns, k=0 at the surface.

    t0 [K], q* mixing ratios [kg/kg], p [Pa], delz [m], den [kg/m3],
    qsat/rh the saturation mixing ratio and relative humidity of the
    input state (the reference passes the slice values, wsm5:252-254).
    Returns the adjusted state and the surface rates."""
    loops = max(int(round(delt / dtcldcr)), 1)
    if delt <= dtcldcr:
        loops = 1
    dtcld = delt / loops
    rdtcld = 1.0 / dtcld

    t = t0
    qv = qv0
    qc = torch.where(qc0_ < qcimin, 0.0, qc0_)
    qi = torch.where(qi0 < qcimin, 0.0, qi0)
    qr = torch.clamp(qr0, min=0.0)
    qs_ = torch.clamp(qs0, min=0.0)
    rain = torch.zeros_like(t[:, 0])
    snow = torch.zeros_like(t[:, 0])
    rh = torch.clamp(rh, 0.0, 1.0)
    fall_r = torch.zeros_like(t)
    fall_s = torch.zeros_like(t)

    cpm = _cpm(qv)
    xl = _xl(t)
    denfac = torch.sqrt(c.stdrho / den)

    for _ in range(loops):
        # ni, slopes, sedimentation (wsm52d:560-640)
        (rsr, rsrb, rsr2, rsr3, rss, rssb, rss2, rss3,
         vtr, vts, n0sfac) = _slopes(qr, qs_, den, denfac, t)
        rqr, flux_r = _sediment(den * qr, vtr, delz, dtcld)
        rqs, flux_s = _sediment(den * qs_, vts, delz, dtcld)
        qr = torch.clamp(rqr / den, min=0.0)
        qs_ = torch.clamp(rqs / den, min=0.0)
        fall_r = flux_r / delz            # kg/m3/s, for remrat
        fall_s = flux_s / delz
        # psmlt: melting of snow while falling (wsm52d:575-600)
        (rsr, rsrb, rsr2, rsr3, rss, rssb, rss2, rss3,
         vtr, vts, n0sfac) = _slopes(qr, qs_, den, denfac, t)
        xlf = c.wlhf
        venf = (torch.exp((1.0 / 3.0) * torch.log(
            _viscos(t, den) / _diffus(t, p)))
            / torch.sqrt(_viscos(t, den)) * torch.sqrt(denfac))
        coeres = rss2 * torch.sqrt(rss * rssb)
        psmlt = (1.414e3 * _viscos(t, den) * den / xlf
                 * (c.tzero - t) * 0.5 * math.pi * n0sfac
                 * (precs1 * rss2 + precs2 * venf * coeres))
        psmlt = torch.where((t > c.tzero) & (qs_ > 0.0),
                            _clip(psmlt * dtcld, -qs_, 0.0), 0.0)
        qs_ = qs_ + psmlt
        qr = qr - psmlt
        t = t + xlf / cpm * psmlt

        # ice fallout (vice, wsm52d:604-636)
        xni = torch.clamp(5.38e7 * (den * torch.clamp(qi, min=qcimin))
                          ** 0.75, minni, maxni)
        xmi = den * qi / xni
        diam = torch.clamp(dicon * torch.sqrt(xmi), 1e-25, dimax)
        vti = torch.where(qi > 0.0, 1.49e4 * diam ** 1.31, 0.0)
        rqi, flux_i = _sediment(den * qi, vti, delz, dtcld)
        qi = torch.clamp(rqi / den, min=0.0)

        # surface rates (wsm52d:640-650)
        fallsum = flux_r[:, 0] + flux_s[:, 0] + flux_i[:, 0]
        fallsum_qsi = flux_s[:, 0] + flux_i[:, 0]
        rain = rain + torch.clamp(fallsum, min=0.0) * dtcld / delt
        snow = snow + torch.clamp(fallsum_qsi, min=0.0) * dtcld / delt

        # instantaneous melting and freezing (wsm52d:652-700)
        supcol = c.tzero - t
        xlf = torch.where(supcol < 0.0, c.wlhf, c.wlhs - _xl(t))
        # pimlt: i->c above freezing
        m = (supcol < 0.0) & (qi > 0.0)
        t = torch.where(m, t - xlf / cpm * qi, t)
        qc = torch.where(m, qc + qi, qc)
        qi = torch.where(m, 0.0, qi)
        # pihmf: homogeneous freezing below -40C
        m = (supcol > 40.0) & (qc > 0.0)
        t = torch.where(m, t + xlf / cpm * qc, t)
        qi = torch.where(m, qi + qc, qi)
        qc = torch.where(m, 0.0, qc)
        # pihtf: heterogeneous (Bigg) freezing 0>-40C
        supcolt = torch.clamp(supcol, max=50.0)
        pfrzdtc = torch.minimum(
            pfrz1 * (torch.exp(pfrz2 * supcolt) - 1.0)
            * den / c.rhoh2o / xncr * qc * qc * dtcld, qc)
        m = (supcol > 0.0) & (qc > 0.0)
        pfrzdtc = torch.where(m, pfrzdtc, 0.0)
        qi = qi + pfrzdtc
        t = t + xlf / cpm * pfrzdtc
        qc = qc - pfrzdtc
        # psfrz: freezing of rain  r->s
        (rsr, rsrb, rsr2, rsr3, rss, rssb, rss2, rss3,
         vtr, vts, n0sfac) = _slopes(qr, qs_, den, denfac, t)
        pfrzdtr = torch.minimum(
            20.0 * math.pi ** 2 * pfrz1 * n0r * c.rhoh2o / den
            * (torch.exp(pfrz2 * supcolt) - 1.0) * rsr ** 7 * dtcld, qr)
        m = (supcol > 0.0) & (qr > 0.0)
        pfrzdtr = torch.where(m, pfrzdtr, 0.0)
        qs_ = qs_ + pfrzdtr
        t = t + xlf / cpm * pfrzdtr
        qr = qr - pfrzdtr

        # slopes and thermodynamic work terms (wsm52d:702-745)
        (rsr, rsrb, rsr2, rsr3, rss, rssb, rss2, rss3,
         vtr, vts, n0sfac) = _slopes(qr, qs_, den, denfac, t)
        xl = _xl(t)
        cpm = _cpm(qv)
        qsv = torch.clamp(qsat, min=qcimin)
        diffac_w = (den * xl * xl * (t + 120.0) * den
                    / (1.414e3 * 1.496e-6 * t * torch.sqrt(t) * den
                       * c.rwat * t * t)
                    + p / (qsv * 8.794e-5 * torch.exp(1.81 * torch.log(t))))
        diffac_i = (den * c.wlhs * c.wlhs * (t + 120.0) * den
                    / (1.414e3 * 1.496e-6 * t * torch.sqrt(t) * den
                       * c.rwat * t * t)
                    + p / (qsv * 8.794e-5 * torch.exp(1.81 * torch.log(t))))
        venf = (torch.exp((1.0 / 3.0) * torch.log(
            1.496e-6 * t * torch.sqrt(t) * p
            / ((t + 120.0) * den * 8.794e-5
               * torch.exp(1.81 * torch.log(t)))))
            * torch.sqrt(torch.sqrt(c.stdrho / den)))
        venf = venf / torch.sqrt(1.496e-6 * t * torch.sqrt(t)
                                 / ((t + 120.0) * den))

        # warm rain (wsm52d:747-800)
        supsat = torch.clamp(qv, min=c.minqq) - qsv
        satdt = supsat * rdtcld
        praut = torch.where(
            qc > qc0,
            torch.minimum(qck1 * torch.clamp(qc, min=qcimin) ** (7.0 / 3.0),
                          qc * rdtcld), 0.0)
        pracw = torch.where(
            (qr > qrsmin) & (qc > qcimin),
            torch.minimum(pacrr * rsr3 * rsrb * qc * denfac, qc * rdtcld),
            0.0)
        coeres = rsr2 * torch.sqrt(rsr * rsrb)
        prevp0 = ((rh - 1.0) * (precr1 * rsr2 + precr2 * venf * coeres)
                  / diffac_w)
        prevp = torch.where(
            prevp0 < 0.0,
            torch.maximum(torch.maximum(prevp0, -qr * rdtcld), 0.5 * satdt),
            torch.minimum(prevp0, 0.5 * satdt))
        prevp = torch.where(qr > 0.0, prevp, 0.0)

        # cold rain (wsm52d:802-900)
        supcol = c.tzero - t
        n0sfac = torch.clamp(torch.exp(alpha * supcol), 1.0, n0smax / n0s)
        eacrs = torch.exp(0.07 * (-supcol))
        xni = torch.clamp(5.38e7 * (den * torch.clamp(qi, min=qcimin))
                          ** 0.75, minni, maxni)
        xmi = den * qi / xni
        diam = torch.clamp(dicon * torch.sqrt(torch.clamp(xmi, min=0.0)),
                           max=dimax)
        vt2i = 1.49e4 * torch.clamp(diam, min=1e-25) ** 1.31
        vt2s = pvts * rssb * denfac
        acrfac = 2.0 * rss3 + 2.0 * diam * rss2 + diam ** 2 * rss
        psaci = torch.where(
            (supcol > 0.0) & (qs_ > qrsmin) & (qi > qcimin),
            math.pi * qi * eacrs * n0s * n0sfac
            * torch.abs(vt2s - vt2i) * acrfac * 0.25, 0.0)
        psacw = torch.where(
            (qs_ > qrsmin) & (qc > qcimin),
            torch.minimum(pacrc * n0sfac * rss3 * rssb * qc * denfac,
                          qc * rdtcld), 0.0)
        # pidep with the sequential saturation budget (ifsat)
        pidep0 = 4.0 * diam * xni * (rh - 1.0) / diffac_i
        supice = satdt - prevp
        pidep = torch.where(
            pidep0 < 0.0,
            torch.maximum(torch.maximum(pidep0, 0.5 * satdt),
                          torch.maximum(supice, -qi * rdtcld)),
            torch.minimum(torch.minimum(pidep0, 0.5 * satdt), supice))
        pidep = torch.where((supcol > 0.0) & (qi > 0.0), pidep, 0.0)
        sat1 = torch.abs(prevp + pidep) >= torch.abs(satdt)
        coeres_s = rss2 * torch.sqrt(rss * rssb)
        psdep0 = ((rh - 1.0) * n0sfac
                  * (precs1 * rss2 + precs2 * venf * coeres_s) / diffac_i)
        supice2 = satdt - prevp - pidep
        psdep = torch.where(
            psdep0 < 0.0,
            torch.maximum(torch.maximum(psdep0, -qs_ * rdtcld),
                          torch.maximum(0.5 * satdt, supice2)),
            torch.minimum(torch.minimum(psdep0, 0.5 * satdt), supice2))
        psdep = torch.where((supcol > 0.0) & (qs_ > 0.0) & (~sat1),
                            psdep, 0.0)
        sat2 = torch.abs(prevp + pidep + psdep) >= torch.abs(satdt)
        supice3 = satdt - prevp - pidep - psdep
        xni0 = minni * torch.exp(0.1 * supcol)
        roqi0 = 4.92e-11 * torch.exp(1.33 * torch.log(xni0))
        pigen = torch.clamp((roqi0 / den - torch.clamp(qi, min=0.0))
                            * rdtcld, min=0.0)
        pigen = torch.minimum(torch.minimum(pigen, satdt), supice3)
        pigen = torch.where((supcol > 0.0) & (supsat > 0.0) & (~sat2),
                            torch.clamp(pigen, min=0.0), 0.0)
        qimax = roqimax / den
        psaut = torch.where((supcol > 0.0) & (qi > 0.0),
                            torch.clamp((qi - qimax) * rdtcld, min=0.0), 0.0)
        psevp0 = psdep * diffac_i / diffac_w
        psevp = torch.where(
            (supcol <= 0.0) & (qs_ > 0.0) & (rh < 1.0),
            _clip(psevp0, -qs_ * rdtcld, 0.0), 0.0)

        # conservation rescaling and the update (wsm52d:900-1032)
        cold = t <= c.tzero
        # the cloud water sink (both regimes share this triple)
        srcc = (praut + pracw + psacw) * dtcld
        qcm = torch.clamp(qc, min=qcimin)
        fac = torch.where(srcc > qcm, qcm / torch.clamp(srcc, min=1e-30),
                          1.0)
        praut, pracw, psacw = praut * fac, pracw * fac, psacw * fac
        # cloud ice (cold only)
        srci = (psaut + psaci - pigen - pidep) * dtcld
        qim = torch.clamp(qi, min=qcimin)
        fac = torch.where(cold & (srci > qim),
                          qim / torch.where(srci == 0.0, 1.0, srci), 1.0)
        psaut, psaci = psaut * fac, psaci * fac
        pigen, pidep = pigen * fac, pidep * fac
        # rain
        srcr = torch.where(cold, (-praut - pracw - prevp) * dtcld,
                           (-praut - pracw - prevp - psacw) * dtcld)
        qrm = torch.clamp(qr, min=qcimin)
        fac = torch.where(srcr > qrm,
                          qrm / torch.where(srcr == 0.0, 1.0, srcr), 1.0)
        praut, pracw, prevp = praut * fac, pracw * fac, prevp * fac
        psacw = torch.where(cold, psacw, psacw * fac)
        # snow
        srcs = torch.where(cold,
                           (-psdep - psaut - psaci - psacw) * dtcld,
                           (-psevp) * dtcld)
        qsm = torch.clamp(qs_, min=qcimin)
        fac = torch.where(srcs > qsm,
                          qsm / torch.where(srcs == 0.0, 1.0, srcs), 1.0)
        psdep = torch.where(cold, psdep * fac, psdep)
        psaut = torch.where(cold, psaut * fac, psaut)
        psaci = torch.where(cold, psaci * fac, psaci)
        psacw = torch.where(cold, psacw * fac, psacw)
        psevp = torch.where(cold, psevp, psevp * fac)

        dqv_cold = -(prevp + psdep + pigen + pidep)
        dqv_warm = -(prevp + psevp)
        qv = qv + torch.where(cold, dqv_cold, dqv_warm) * dtcld
        qc = torch.clamp(qc - (praut + pracw + psacw) * dtcld, min=0.0)
        qr = torch.where(
            cold,
            torch.clamp(qr + (praut + pracw + prevp) * dtcld, min=0.0),
            torch.clamp(qr + (praut + pracw + prevp + psacw) * dtcld,
                        min=0.0))
        qi = torch.where(
            cold,
            torch.clamp(qi - (psaut + psaci - pigen - pidep) * dtcld,
                        min=0.0), qi)
        qs_ = torch.where(
            cold,
            torch.clamp(qs_ + (psdep + psaut + psaci + psacw) * dtcld,
                        min=0.0),
            torch.clamp(qs_ + psevp * dtcld, min=0.0))
        xlf = c.wlhs - xl
        xlwork2 = torch.where(
            cold,
            -c.wlhs * (psdep + pidep + pigen) - xl * prevp - xlf * psacw,
            -xl * (prevp + psevp))
        t = t - xlwork2 / cpm * dtcld

        # pcond saturation adjustment (wsm52d:1033-1068)
        qsw = pfwsat(t, p)
        qvm = torch.clamp(qv, min=c.minqq)
        work1 = ((qvm - qsw)
                 / (1.0 + xl * xl / (c.rwat * cpm) * qsw / (t * t)))
        pcond = _clip(work1 * rdtcld, 0.0, qvm * rdtcld)
        pcond = torch.where((qc > 0.0) & (work1 < 0.0),
                            torch.maximum(work1, -qc) * rdtcld, pcond)
        qv = qv - pcond * dtcld
        qc = torch.clamp(qc + pcond * dtcld, min=0.0)
        t = t + pcond * xl / cpm * dtcld

    qc = torch.where(qc < qcimin, 0.0, qc)
    qi = torch.where(qi < qcimin, 0.0, qi)
    qr = torch.clamp(qr, min=0.0)
    qs_ = torch.clamp(qs_, min=0.0)
    # remrat for chemistry (wsm5:320-340): fall·dz/(ρw·q)
    remrat = (torch.where(qr > c.dlowval,
                          fall_r * delz / c.rhoh2o
                          / torch.clamp(qr, min=1e-30), 0.0)
              + torch.where(qs_ > c.dlowval,
                            fall_s * delz / c.rhoh2o
                            / torch.clamp(qs_, min=1e-30), 0.0))
    return WSM5Out(t=t, qv=qv, qc=qc, qi=qi, qr=qr, qs=qs_,
                   rain=rain, snow=snow, remrat=remrat)
