"""COARE 3.0 bulk ocean-flux scheme (iocnflx=3), torch twin of
``regcm_tpu/physics/surface/coare.py``.

``Main/ocnlib/mod_ocn_coare.F90`` (``coare3_drv`` :46-419, Fairall et
al. 2003): Monin-Obukhov similarity with Liu-Katsaros-Businger scalar
roughness, gustiness from the convective velocity scale and a cool-skin
(``dter``) sublayer. The reference's per-point early exit (``niter=1``
where ``zetu > 50``) is a masked freeze inside a fixed 3-iteration loop;
sea-ice points (``icemask``) take the Andreas (1987) roughness branch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ...utils import constants as c
from ...utils.thermo import pfqsat, pfqsdt, wlh

BETA = 1.25     # gustiness coefficient
FDG = 1.0       # thermal/wind von Karman ratio
VISW = 1.0e-6   # water kinematic viscosity
TCW = 0.6       # water thermal diffusivity
RHOW = 1022.0   # water density
BE = 0.026      # salinity expansion coefficient
CPW = 4.0e3     # specific heat of water

_SQ3 = math.sqrt(3.0)
_AT1 = math.atan(1.0)


def _psic(x):
    """The convective limb shared by both profile functions."""
    return (1.5 * torch.log((1.0 + x + x * x) / 3.0)
            - _SQ3 * torch.atan((1.0 + 2.0 * x) / _SQ3)
            + 4.0 * _AT1 / _SQ3)


def _psiuo(zet):
    """Velocity profile function (mod_ocn_coare.F90:378-397)."""
    zet_n = torch.clamp(zet, max=-1e-12)
    x = (1.0 - 15.0 * zet_n) ** 0.25
    psik = (2.0 * torch.log((1.0 + x) / 2.0)
            + torch.log((1.0 + x * x) / 2.0)
            - 2.0 * torch.atan(x) + 2.0 * _AT1)
    psic = _psic((1.0 - 10.15 * zet_n) ** 0.3333)
    f = zet_n * zet_n / (1.0 + zet_n * zet_n)
    unstable = (1.0 - f) * psik + f * psic
    zet_p = torch.clamp(zet, min=0.0)
    cc = torch.clamp(0.35 * zet_p, max=50.0)
    stable = -((1.0 + 1.0 * zet_p) ** 1.0
               + 0.667 * (zet_p - 14.28) / torch.exp(cc) + 8.525)
    return torch.where(zet < 0.0, unstable, stable)


def _psit(zet):
    """Scalar profile function (mod_ocn_coare.F90:399-417)."""
    zet_n = torch.clamp(zet, max=-1e-12)
    x = (1.0 - 15.0 * zet_n) ** 0.5
    psik = 2.0 * torch.log((1.0 + x) / 2.0)
    psic = _psic((1.0 - 34.15 * zet_n) ** 0.3333)
    f = zet_n * zet_n / (1.0 + zet_n * zet_n)
    unstable = (1.0 - f) * psik + f * psic
    zet_p = torch.clamp(zet, min=0.0)
    cc = torch.clamp(0.35 * zet_p, max=50.0)
    stable = -((1.0 + 2.0 / 3.0 * zet_p) ** 1.5
               + 0.667 * (zet_p - 14.28) / torch.exp(cc) + 8.525)
    return torch.where(zet < 0.0, unstable, stable)


def _scalar_roughness_ice(rr):
    """Andreas (1987) snow/ice roughness Reynolds laws (:231-244)."""
    lrr = torch.log(torch.clamp(rr, min=1e-30))

    def law(a0, a1, a2, a3):
        return torch.where(
            rr <= 0.135, rr * math.exp(a0),
            torch.where(rr <= 2.5, rr * torch.exp(a1[0] + a1[1] * lrr),
                        torch.where(rr <= 1000.0,
                                    rr * torch.exp(a2[0] + a2[1] * lrr
                                                   + a2[2] * lrr * lrr),
                                    a3)))
    rt = law(1.250, (0.149, -0.550), (0.317, -0.565, -0.183), 1e-10)
    rq = law(1.610, (0.351, -0.628), (0.396, -0.512, -0.180), 1e-10)
    return rt, rq


def _scalar_roughness_ocean(rr):
    """Liu et al. (1979) roughness Reynolds laws (:246-274)."""
    rs = torch.clamp(rr, min=1e-30)
    bounds = [0.11, 0.8, 3.0, 10.0, 30.0, 100.0, 300.0, 1000.0]
    rt_co = [(0.177, 0.0), (1.376, 0.929), (1.026, -0.599),
             (1.625, -1.018), (4.661, -1.475), (34.904, -2.067),
             (1667.19, -2.907), (5.88e5, -3.935)]
    rq_co = [(0.292, 0.0), (1.808, 0.826), (1.393, -0.528),
             (1.956, -0.870), (4.994, -1.297), (30.709, -1.845),
             (1448.68, -2.682), (2.98e5, -3.616)]
    rt = torch.full_like(rr, 1e-10)
    rq = torch.full_like(rr, 1e-10)
    for b, (at, pt), (aq, pq) in zip(reversed(bounds),
                                     reversed(rt_co), reversed(rq_co)):
        rt = torch.where(rr <= b, at * rs ** pt, rt)
        rq = torch.where(rr <= b, aq * rs ** pq, rq)
    return rt, rq


class CoareOut(NamedTuple):
    sent: torch.Tensor      # sensible heat flux (W/m2, + upward)
    evpr: torch.Tensor      # evaporation (kg/m2/s)
    drag: torch.Tensor      # usr²·rhox/uv995 (uvdrag)
    ustar: torch.Tensor
    u10: torch.Tensor
    t2m: torch.Tensor
    q2m: torch.Tensor
    zo: torch.Tensor


def coare3(usw, vsw, tatm, qvmix, ht, sfps, sfta, tgrd, hpbl,
           rswf, rlwf, rhox, icemask=None) -> CoareOut:
    """COARE3 fluxes over ocean (and sea ice, through ``icemask``).

    usw/vsw lowest-level winds (m/s); tatm lowest-level T (K); qvmix its
    vapour mixing ratio; ht level height (m); sfps surface pressure
    (Pa); sfta surface air temperature (K, ``tp3d[kz]``); tgrd SST (K);
    hpbl PBL height (m); rswf net surface SW (+down), rlwf net surface
    LW cooling (+up, W/m2); rhox surface air density. As in the
    reference, the temperature contrast ``dt = ta - t995 - tzero`` (:143)
    is ``sfta − tatm``; the SST acts through qs(SST), the cool skin and
    the latent heat."""
    iflag = (icemask > 0.5) if icemask is not None \
        else torch.zeros_like(tatm, dtype=torch.bool)
    ts = tgrd - c.tzero
    uv995 = torch.clamp(torch.sqrt(usw ** 2 + vsw ** 2), min=0.02)
    t995 = tatm - c.tzero
    q995 = qvmix
    zu = zt = zq = ht
    zi = torch.clamp(hpbl, min=10.0)
    ta = sfta

    le = wlh(tgrd)
    rhoa = sfps / (c.rgas * ta * (1.0 + c.ep1 * q995))
    visa = 1.326e-5 * (1.0 + 6.542e-3 * t995 + 8.301e-6 * t995 ** 2
                       - 4.84e-9 * t995 ** 3)
    bigc = 16.0 * c.egrav * CPW * (RHOW * VISW) ** 3 / (TCW * TCW
                                                        * rhoa * rhoa)
    al = torch.where(ts > -2.0,
                     2.1e-5 * torch.clamp(ts + 3.2, min=1e-6) ** 0.79,
                     2.4253e-05)
    rns = rswf
    rnl = rlwf

    qs = pfqsat(tgrd, sfps) * 0.98
    wetc = pfqsdt(tgrd, sfps)
    q995 = q995 / (1.0 + q995)          # specific humidity
    dt = ta - t995 - c.tzero
    dq = qs - q995
    du = uv995                           # no currents
    ug = torch.full_like(du, 0.5)
    ut = torch.sqrt(du * du + ug * ug)
    zero = torch.zeros_like(du)
    dter = torch.where(iflag, zero, 0.3)

    zogs = torch.where(iflag, zero + 4.5e-4, 1e-4)
    u10 = ut * torch.log(10.0 / zogs) / torch.log(zu / zogs)
    cdhg = c.vonkar / torch.log(10.0 / zogs)
    usr = cdhg * u10
    zo10 = torch.where(iflag, zogs,
                       0.011 * usr * usr * c.regrav + 0.11 * visa / usr)
    cd10 = (c.vonkar / torch.log(10.0 / zo10)) ** 2
    ch10 = torch.where(iflag, zero + 0.0015, 0.00115)
    ct10 = ch10 / torch.sqrt(cd10)
    zot10 = 10.0 / torch.exp(c.vonkar / ct10)
    cd = (c.vonkar / torch.log(zu / zo10)) ** 2
    ct = c.vonkar / torch.log(zt / zot10)
    cc = c.vonkar * ct / cd
    ribcu = -zu / zi / 0.004 / BETA ** 3
    br = -c.egrav * zu / ta * ((dt - dter) + c.ep1 * ta * dq) / ut ** 2
    zetu = torch.where(br < 0.0, cc * br / (1.0 + br / ribcu),
                       cc * br * (1.0 + 3.0 * br / cc))
    l10 = zu / zetu
    one_iter = zetu > 50.0

    usr = ut * c.vonkar / (torch.log(zu / zo10) - _psiuo(zu / l10))
    tsr = -(dt - dter) * c.vonkar * FDG \
        / (torch.log(zt / zot10) - _psit(zt / l10))
    qsr = -(dq - wetc * dter) * c.vonkar * FDG \
        / (torch.log(zq / zot10) - _psit(zq / l10))
    tkt = torch.full_like(usr, 0.001)
    ram1 = torch.log(zu / zo10)
    zo = zo10

    for k in range(3):
        zet = c.vonkar * c.egrav * zu / ta \
            * (tsr + c.ep1 * ta * qsr) / (usr * usr)
        zo_n = torch.where(iflag, zogs,
                           0.011 * usr * usr * c.regrav + 0.11 * visa / usr)
        rr = zo_n * usr / visa
        rt_i, rq_i = _scalar_roughness_ice(rr)
        rt_o, rq_o = _scalar_roughness_ocean(rr)
        rt = torch.where(iflag, rt_i, rt_o)
        rq = torch.where(iflag, rq_i, rq_o)
        ll = zu / zet
        zot = rt * visa / usr
        zoq = rq * visa / usr
        ram = torch.log(zu / zo_n) - _psiuo(zu / ll)
        rah = torch.log(zt / zot) - _psit(zt / ll)
        usr_n = ut * c.vonkar / ram
        tsr_n = -(dt - dter) * c.vonkar * FDG / rah
        qsr_n = -(dq - wetc * dter) * c.vonkar * FDG \
            / (torch.log(zq / zoq) - _psit(zq / ll))
        bf = -c.egrav / ta * usr_n * (tsr_n + c.ep1 * ta * qsr_n)
        ug_n = torch.where(bf > 0.0,
                           BETA * torch.clamp(bf * zi, min=0.0) ** 0.333,
                           0.2)
        ut_n = torch.sqrt(du * du + ug_n * ug_n)
        hsb = -rhoa * c.cpd * usr_n * tsr_n
        hlb = -rhoa * le * usr_n * qsr_n
        qout = rnl + hsb + hlb
        dels = rns * (0.137 + 11.0 * tkt
                      - 6.6e-5 / tkt * (1.0 - torch.exp(-tkt / 8.0e-4)))
        qcol = qout - dels
        alq = al * qcol + BE * hlb * CPW / le
        xlamx = 6.0 / (1.0 + (bigc * torch.clamp(alq, min=0.0)
                              / usr_n ** 4) ** 0.75) ** 0.333
        tkt_n = xlamx * VISW / (torch.sqrt(rhoa / RHOW) * usr_n)
        cool = (qcol > 0.0) & (alq >= 0.0)
        dter_n = torch.where(cool, qcol * tkt_n / TCW, 0.0)
        tkt_n = torch.where(cool, tkt_n, tkt)
        dter_n = torch.where(iflag, zero, dter_n)
        # points with zetu > 50 keep the first iteration's values
        # (reference niter=1, :205)
        if k == 0:
            usr, tsr, qsr, ut, ug, dter, tkt, zo, ram1 = (
                usr_n, tsr_n, qsr_n, ut_n, ug_n, dter_n, tkt_n, zo_n, ram)
        else:
            sel = lambda new, old: torch.where(one_iter, old, new)
            usr, tsr, qsr, ut, ug, dter, tkt, zo, ram1 = (
                sel(usr_n, usr), sel(tsr_n, tsr), sel(qsr_n, qsr),
                sel(ut_n, ut), sel(ug_n, ug), sel(dter_n, dter),
                sel(tkt_n, tkt), sel(zo_n, zo), sel(ram, ram1))

    uv10 = torch.where(
        zetu < 0.0,
        uv995 + (usr / c.vonkar) * (torch.log(10.0 / zu)
                                    - (_psiuo(zetu) - _psiuo(zu / l10))),
        uv995 + (usr / c.vonkar) * (torch.log(10.0 / zu)
                                    + 5.0 * zetu - 5.0 * zu / l10))
    hsb = -rhoa * c.cpd * usr * tsr
    hlb = -rhoa * le * usr * qsr
    sent = torch.where(torch.abs(hsb) < c.dlowval, 0.0, hsb)
    evpr = torch.clamp(hlb / le, min=0.0)
    evpr = torch.where(evpr < c.dlowval, 0.0, evpr)
    facttq = torch.log(ht * 0.5) / torch.log(ht / zo)
    drag = usr ** 2 * rhox / uv995
    t2m = t995 + c.tzero - dt * facttq
    q2m = q995 - dq * facttq
    return CoareOut(sent=sent, evpr=evpr, drag=drag, ustar=usr,
                    u10=uv10, t2m=t2m, q2m=q2m, zo=zo)
