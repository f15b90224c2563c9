"""Surface turbulent fluxes + ground temperature, torch twin of
``regcm_tpu/physics/surface/fluxes.py``.

BATS bulk drag with Richardson-number stability corrections
(``ocnbats``, ``Main/ocnlib/mod_ocn_bats.F90:18-85``) and a force-restore
land ground temperature. Over ocean the bulk form is the BATS ocean
flux (iocnflx=1); the Zeng scheme (iocnflx=2, the default) or COARE 3.0
(iocnflx=3) replaces it. The force-restore ground serves every land
point when the land scheme is not BATS1e.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...utils import constants as c

from ...utils.thermo import pfqsat
from .coare import coare3
from .zeng import zengocn

ZLND = 0.01     # land roughness (Share/mod_constants.F90:290)
ZOCE = 0.00023  # ocean roughness (:292)
WTUR = 0.1      # turbulent wind floor (:300)


class SurfaceOut(NamedTuple):
    hfx: torch.Tensor      # sensible heat flux (W/m2, + upward)
    qfx: torch.Tensor      # moisture flux (kg/m2/s)
    uvdrag: torch.Tensor   # rho·Cd·V (surface drag)
    tg: torch.Tensor       # updated ground temperature
    t2m: torch.Tensor
    q2m: torch.Tensor
    u10m: torch.Tensor
    v10m: torch.Tensor


def bats_drag(usw, vsw, tatm, tgrd, ht, rhox, z0):
    """BATS bulk drag (ocnbats, Main/ocnlib/mod_ocn_bats.F90:44-60)."""
    ribd = usw ** 2 + vsw ** 2 + WTUR ** 2
    vspda = torch.sqrt(ribd)
    cdrn = (c.vonkar / torch.log(ht / z0)) ** 2
    ribn = ht * c.egrav * (1.0 - tgrd / tatm)
    br = ribn / ribd
    cdrx = torch.where(br < 0.0,
                       cdrn * (1.0 + 24.5 * torch.sqrt(cdrn * torch.abs(br))),
                       cdrn / (1.0 + 11.5 * br))
    cdrmin = torch.clamp(0.25 * cdrn, min=6.0e-4)
    cdrx = torch.maximum(cdrx, cdrmin)
    return cdrx * vspda * rhox, vspda, cdrn


def surface_fluxes(usw, vsw, tatm, qvatm, ht, rhox, sfps, tg, sst,
                   landmask, swabs, lwnet, prcp, dtsrf,
                   beta_lnd=0.5, iocnflx=2) -> SurfaceOut:
    """Surface fluxes and one force-restore step of the land Tg.

    usw/vsw lowest-level winds (m/s); tatm/qvatm lowest-level T (K) and
    qv (mixing ratio); ht lowest-level height (m); rhox surface air
    density; sfps surface pressure (Pa); sst ocean surface T; swabs
    absorbed SW, lwnet net downward LW (W/m2); dtsrf surface step (s)."""
    land = landmask > 0.5
    tgrd = torch.where(land, tg, sst)
    z0 = torch.where(land, tg.new_tensor(ZLND), ZOCE)
    drag, vspda, cdrn = bats_drag(usw, vsw, tatm, tgrd, ht, rhox, z0)

    qs = qvatm / (1.0 + qvatm)
    qgrd = pfqsat(tgrd, sfps)
    delt = tatm - tgrd
    delq = qs - qgrd
    beta = torch.where(land, tg.new_tensor(beta_lnd), 1.0)
    evpr = torch.clamp(-drag * beta * delq, min=0.0)
    sent = -drag * c.cpd * delt
    sent = torch.where(torch.abs(sent) < c.dlowval, 0.0, sent)
    evpr = torch.where(evpr < c.dlowval, 0.0, evpr)
    hpbl = torch.full_like(ht, 500.0)
    if iocnflx == 2:
        # Zeng ocean fluxes replace the bulk form over ocean points
        oc = zengocn(usw, vsw, tatm, qvatm, ht, sfps, sfps * 0.99, sst,
                     hpbl)
    elif iocnflx == 3:
        # COARE3 over ocean points (mod_ocn_coare.F90), sfta = tp3d[kz]:
        # the air T referenced adiabatically to the surface
        # (mod_slice.F90:125, mod_lm_interface.F90:339)
        sfta = tatm * (sfps / (sfps - rhox * c.egrav * ht)) ** c.rovcp
        oc = coare3(usw, vsw, tatm, qvatm, ht, sfps, sfta, sst, hpbl,
                    swabs, -lwnet, rhox)
    if iocnflx in (2, 3):
        sent = torch.where(land, sent, oc.sent)
        evpr = torch.where(land, evpr, torch.clamp(oc.evpr, min=0.0))
        drag = torch.where(land, drag, torch.clamp(oc.drag, min=1e-5))

    # land ground temperature: force-restore energy balance
    lh = torch.where(tgrd > c.tzero, tg.new_tensor(c.wlhv), c.wlhs)
    csoil = 3.0e5          # areal heat capacity (J/m2/K), ~5cm soil
    tau_deep = 86400.0
    netflx = swabs + lwnet - sent - lh * evpr
    tg_new = tg + dtsrf * (netflx / csoil - (tg - tatm) / tau_deep)
    tg_new = torch.clamp(tg_new, 180.0, 340.0)
    tg_out = torch.where(land, tg_new, sst)

    fact = torch.log(ht * 0.5) / torch.log(ht / z0)
    factuv = torch.log(ht * 0.1) / torch.log(ht / z0)
    return SurfaceOut(
        hfx=sent, qfx=evpr, uvdrag=drag, tg=tg_out,
        t2m=tatm - delt * fact, q2m=qs - delq * fact,
        u10m=usw * (1.0 - factuv), v10m=vsw * (1.0 - factuv))
