"""Bulk surface albedo and the broadband radiation option, torch twin of
``regcm_tpu/physics/radiation/simple.py``.

``surface_albedo`` is the ocean/land albedo the CCM3 path blends with
the BATS land albedo; ``radiation`` is the calibrated broadband
surrogate kept as the ``rad_scheme='broadband'`` option.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ...utils import constants as c

# GHG emissivity sensitivities per unit log concentration (the JAX
# package's calibration: a CO2 doubling gives ΔOLR ≈ −3.7 W/m2)
KCO2 = 0.084
KCH4 = 0.018
KN2O = 0.011


class RadOut(NamedTuple):
    heatrt: torch.Tensor     # (kz, iy, jx) K/s (decoupled)
    swabs_sfc: torch.Tensor  # absorbed SW at surface (W/m2)
    lwnet_sfc: torch.Tensor  # net downward LW at surface (W/m2)
    olr: torch.Tensor        # outgoing LW at TOA (W/m2)
    swtoa: torch.Tensor      # net SW at TOA (W/m2)


def radiation(t, qv, pf, ph, cldfra, cldlwc, coszrs, tg, albedo,
              eccf=1.0, co2ppm=330.0, ch4ppb=1700.0,
              n2oppb=310.0) -> RadOut:
    """Broadband radiative transfer; (kz, iy, jx) fields, pf (kz+1,...).
    t (K), qv (kg/kg), pf/ph (Pa), cldfra (0-1), cldlwc in-cloud g/m3,
    coszrs cosine zenith, tg ground T, albedo surface albedo."""
    kz = t.shape[0]
    dp = pf[1:] - pf[:-1]
    wpath = qv * dp * c.regrav
    dz = dp / (torch.clamp(ph, min=1.0) / (c.rgas * t)) * c.regrav
    lwp = cldlwc * cldfra * dz

    # shortwave: Lacis-Hansen H2O absorption on the cumulative slant
    # path, Rayleigh, cloud reflection/absorption from LWP
    s0 = c.solcon * eccf * torch.clamp(coszrs, min=0.0)
    mu = torch.clamp(coszrs, min=0.01)
    wcum = torch.cumsum(wpath, dim=0) / 10.0 / mu[None]
    lh = lambda w: 2.9 * w / ((1.0 + 141.5 * w) ** 0.635 + 5.925 * w)
    atot = lh(wcum)
    atop = torch.cat([torch.zeros_like(atot[:1]), atot[:-1]], dim=0)
    absw = torch.clamp(atot - atop, 0.0, 0.5)
    tray = 1.0 - 0.03 * (dp / c.stdp)
    tau_c = 0.15 * lwp / torch.clamp(mu[None], min=0.1)
    refl_c = tau_c / (6.7 + tau_c)
    abs_c = torch.clamp(0.025 * tau_c, 0.0, 0.2) * cldfra
    trans = tray * (1.0 - absw) * (1.0 - refl_c) * (1.0 - abs_c)
    absorb = (1.0 - absw) * 0.0 + absw + abs_c
    beam = s0
    sw_abs = []
    for k in range(kz):
        sw_abs.append(beam * torch.clamp(absorb[k], 0.0, 0.9))
        beam = beam * torch.clamp(trans[k], 0.0, 1.0)
    swabs_sfc = beam * (1.0 - albedo)
    cpdp = c.cpd * dp * c.regrav
    sw_heat = torch.stack(sw_abs) / cpdp

    # longwave: grey emissivity from vapour path + cloud + GHG increment
    emis_v = 1.0 - torch.exp(-0.2 * torch.sqrt(torch.clamp(wpath, min=0.0)))
    emis_c = cldfra * (1.0 - torch.exp(-0.13 * lwp))
    ghfac = (KCO2 * math.log(co2ppm / 330.0)
             + KCH4 * math.log(ch4ppb / 1700.0)
             + KN2O * math.log(n2oppb / 310.0))
    emis_g = min(max(ghfac, -0.3), 0.3) * (dp / c.stdp)
    emis = torch.clamp(emis_v + emis_c * (1.0 - emis_v) + emis_g,
                       1.0e-4, 0.999)
    bint = c.sigm * t ** 4
    fdn_l = [torch.zeros_like(tg)]
    for k in range(kz):
        fdn_l.append(fdn_l[-1] * (1.0 - emis[k]) + emis[k] * bint[k])
    fdn_if = torch.stack(fdn_l)
    fdn_sfc = fdn_l[-1]
    sfc_emis = 0.98
    fup_sfc = sfc_emis * c.sigm * tg ** 4 + (1.0 - sfc_emis) * fdn_sfc
    fup_l = [fup_sfc]
    for k in range(kz - 1, -1, -1):
        fup_l.append(fup_l[-1] * (1.0 - emis[k]) + emis[k] * bint[k])
    olr = fup_l[-1]
    fup_if = torch.stack(fup_l[::-1])
    fnet = fup_if - fdn_if
    lw_heat = -(fnet[:-1] - fnet[1:]) / cpdp
    heatrt = torch.clamp(sw_heat + lw_heat, -30.0 / 86400.0, 30.0 / 86400.0)
    return RadOut(heatrt=heatrt, swabs_sfc=swabs_sfc,
                  lwnet_sfc=fdn_sfc - fup_sfc, olr=olr,
                  swtoa=s0 - beam * albedo)


def surface_albedo(coszrs, landmask):
    """Bulk land/ocean albedo (surface_albedo contract,
    Main/mod_lm_interface.F90:440)."""
    mu = torch.clamp(coszrs, min=0.01)
    return torch.where(landmask > 0.5, coszrs.new_tensor(0.16),
                       0.05 / (mu + 0.15))
