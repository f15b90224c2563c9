"""Zeng ocean-flux scheme (iocnflx=2), torch twin of
``regcm_tpu/physics/surface/zeng.py``.

``Main/ocnlib/mod_ocn_zeng.F90`` (``zengocndrv`` :55-420, Zeng et al.
1998): Monin-Obukhov similarity with convective gustiness,
Charnock-type roughness and a fixed count of 10 iterations.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ...utils import constants as c

from ...utils.thermo import pfwsat, wlh

ZETAT = 0.465
ZETAM = 1.574
MINW = 0.1
MINZ = 1.0e-6
ONET = 1.0 / 3.0


def _psi(k, zeta):
    """Unstable similarity functions (mod_ocn_zeng.F90:411-424)."""
    if isinstance(zeta, float):
        chik = (1.0 - 16.0 * min(zeta, 0.0)) ** 0.25
        if k == 1:
            return (2.0 * math.log((1.0 + chik) * 0.5)
                    + math.log((1.0 + chik * chik) * 0.5)
                    - 2.0 * math.atan(chik) + 0.5 * math.pi)
        return 2.0 * math.log((1.0 + chik * chik) * 0.5)
    chik = (1.0 - 16.0 * torch.clamp(zeta, max=0.0)) ** 0.25
    if k == 1:
        return (2.0 * torch.log((1.0 + chik) * 0.5)
                + torch.log((1.0 + chik * chik) * 0.5)
                - 2.0 * torch.atan(chik) + 0.5 * math.pi)
    return 2.0 * torch.log((1.0 + chik * chik) * 0.5)


def _ocnrough(ustar, visa):
    """zo and zoq (ocnrough, mod_ocn_zeng.F90:428-512; iocnrough=1)."""
    zo = torch.clamp(0.0065 * c.regrav * ustar ** 2, min=1.0e-8)
    re = ustar * zo / visa
    xtq = 2.67 * re ** 0.25 - 2.57
    return zo, zo / torch.exp(xtq)


def _resist(zeta, obu, zx, z995, zetax, coef):
    """Integrated stability function for one roughness length."""
    return torch.where(
        zeta < -zetax,
        torch.log(-zetax * obu / zx) - _psi(coef[0], -zetax)
        + _psi(coef[0], zx / obu) + coef[1],
        torch.where(
            zeta < 0.0,
            torch.log(z995 / zx) - _psi(coef[0], zeta)
            + _psi(coef[0], zx / obu),
            torch.where(zeta <= 1.0,
                        torch.log(z995 / zx) + 5.0 * zeta - 5.0 * zx / obu,
                        torch.log(obu / zx) + 5.0 - 5.0 * zx / obu
                        + 5.0 * torch.log(torch.clamp(zeta, min=1.0))
                        + zeta - 1.0)))


class ZengOut(NamedTuple):
    sent: torch.Tensor
    evpr: torch.Tensor
    drag: torch.Tensor
    ustar: torch.Tensor
    u10: torch.Tensor
    t2m: torch.Tensor
    q2m: torch.Tensor


def zengocn(usw, vsw, tatm, qv, ht, sfps, patm, tgrd, hpbl) -> ZengOut:
    """Ocean fluxes from lowest-level winds/T/qv (mixing ratio), height
    ht (m), surface/level pressure (Pa), SST tgrd (K), PBL height."""
    uv995 = torch.sqrt(usw ** 2 + vsw ** 2)
    t995 = tatm - c.tzero
    z995 = ht
    zi = torch.maximum(z995, hpbl)
    th = tgrd * (c.stdp / sfps) ** c.rovcp
    tha = tatm * (c.stdp / patm) ** c.rovcp
    dth = tha - th
    qs = pfwsat(tgrd, sfps) * 0.98
    dqh = qv - qs
    thv = th * (1.0 + c.ep1 * qv)
    dthv = dth * (1.0 + c.ep1 * qv) + c.ep1 * th * dqh
    xdens = sfps / (c.rgas * tatm * (1.0 + c.ep1 * qv))
    visa = 1.326e-5 * (1.0 + 6.542e-3 * t995 + 8.301e-6 * t995 ** 2
                       - 4.840e-9 * t995 ** 3)

    ustar = torch.full_like(uv995, 0.06)
    wc = torch.full_like(uv995, 0.5)
    um = torch.where(dthv >= 0.0, torch.clamp(uv995, min=MINW),
                     torch.sqrt(uv995 ** 2 + wc ** 2))
    for _ in range(2):
        zo, _zoq = _ocnrough(ustar, visa)
        ustar = c.vonkar * um / torch.log(z995 / zo)
    br = c.egrav * z995 * dthv / (thv * um * um)
    zeta = torch.where(
        br >= 0.0,
        torch.clamp(br * torch.log(z995 / zo)
                    / (1.0 - 5.0 * torch.clamp(br, max=0.19)), MINZ, 2.0),
        torch.clamp(br * torch.log(z995 / zo), -100.0, -MINZ))
    obu = z995 / zeta
    wc = ustar * torch.clamp(-zi * c.vonkar / obu, min=0.0) ** ONET

    tstar = torch.zeros_like(ustar)
    qstar = torch.zeros_like(ustar)
    for _ in range(10):
        zo, zoq = _ocnrough(ustar, visa)
        zeta = z995 / obu
        # momentum (mod_ocn_zeng.F90:186-205)
        ram1 = _resist(zeta, obu, zo, z995, ZETAM,
                       (1, 1.14 * ((-zeta) ** ONET - ZETAM ** ONET)))
        ustar = c.vonkar * um / torch.clamp(ram1, min=0.1)
        # heat and moisture share one resistance: zot = zoq
        rah1 = _resist(zeta, obu, zoq, z995, ZETAT,
                       (2, 0.8 * (ZETAT ** (-ONET) - (-zeta) ** (-ONET))))
        tstar = c.vonkar * dth / torch.clamp(rah1, min=0.1)
        qstar = c.vonkar * dqh / torch.clamp(rah1, min=0.1)
        thvstar = tstar * (1.0 + c.ep1 * qv) + c.ep1 * th * qstar
        zeta_n = c.vonkar * c.egrav * thvstar * z995 / (ustar ** 2 * thv)
        stable = zeta_n >= 0.0
        um = torch.where(stable, torch.clamp(uv995, min=MINW),
                         torch.sqrt(uv995 ** 2 + wc ** 2))
        wc = torch.where(stable, wc,
                         torch.clamp(-c.egrav * ustar * thvstar * zi / thv,
                                     min=0.0) ** ONET)
        zeta_n = torch.where(stable, torch.clamp(zeta_n, MINZ, 2.0),
                             torch.clamp(zeta_n, -100.0, -MINZ))
        obu = z995 / zeta_n

    tau = xdens * ustar ** 2 * uv995 / torch.clamp(um, min=MINW)
    lh = -xdens * wlh(tatm) * qstar * ustar
    sh = -xdens * c.cpd * tstar * ustar
    evpr = torch.clamp(lh / wlh(tatm), min=0.0)
    # 10 m wind (:230-238)
    zeta10 = 10.0 / obu
    uv10 = torch.where(
        zeta10 < 0.0,
        uv995 + (ustar / c.vonkar) * (torch.log(10.0 / z995)
                                      - (_psi(1, zeta10)
                                         - _psi(1, z995 / obu))),
        uv995 + (ustar / c.vonkar) * (torch.log(10.0 / z995)
                                      + 5.0 * zeta10 - 5.0 * z995 / obu))
    fact = torch.log(z995 * 0.5) / torch.log(z995 / torch.clamp(zo,
                                                                min=1e-8))
    return ZengOut(sent=sh, evpr=evpr,
                   drag=tau / torch.clamp(uv995, min=MINW),
                   ustar=ustar, u10=uv10, t2m=tatm - dth * fact,
                   q2m=qv - dqh * fact)
