"""Sulfur chemistry: SO2 → SO4 conversion (``chemsox``,
``Main/chemlib/mod_che_sox.F90:45-409``), torch twin of
``regcm_tpu/chem/sox.py``.

Three pathways, exactly as the reference:

1. gas phase SO2 + OH with the troe-form rate (``rrate`` :395-407),
   OH from the oxidant climatology scaled ×1.99 day / ×0.01 night;
2. aqueous conversion in large-scale cloud water (wl > 0.01 g/m³),
   limited by min(H2O2, SO2) in moles, e-folding wl/360 s⁻¹ over the
   cloud fraction, plus Levin & Schwartz below-cloud SO2 washout
   (krembc = 6.5e-5 · rembc^0.68);
3. aqueous conversion in cumulus towers (fixed 2 g/m³ water, columns
   between kcumtop and the surface).

The 96/64 = 1.5 molar-mass ratio converts the SO2 sink into the SO4
source.  All tendencies are returned UNCOUPLED (kg/kg/s); the caller
applies the p*/m_ci coupling.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

AMDK = 28.9         # dry-air kg/kmol as used by chemsox (:68,:167)
NAVGDR = 6.02214129e26
CLMIN = 0.01        # g/m³ non-precipitating cloud threshold
SOLSO2 = 0.6


def so2_oh_rate(cair, temp):
    """Troe-form SO2+OH rate coefficient, cm³/molec/s (rrate,
    mod_che_sox.F90:395-407)."""
    rkk = 3.0e-31 * cair * (temp / 300.0) ** (-3.3)
    rki = 1.5e-12
    expo = 1.0 / (1.0 + (torch.log10(rkk / rki)) ** 2)
    return (rkk * rki / (rkk + rki)) * 0.6 ** expo


class SoxOut(NamedTuple):
    so2_ten: torch.Tensor      # kg/kg/s (uncoupled)
    so4_ten: torch.Tensor
    washout_so2: torch.Tensor  # kg/kg/s removal (+) for diagnostics


def chemsox(so2, so4, rho, temp, czen, wl, fracloud, fracum,
            kcumtop, rembc, oh_clim, h2o2_clim, dt):
    """SO2/SO4 tendencies for one call.

    so2/so4: uncoupled mixing ratios (kg/kg), (kz, iy, jx);
    wl: cloud liquid water g/m³; fracloud/fracum: LS/cumulus cloud
    fractions; kcumtop: (iy, jx) top level index of cumulus (-1 =
    none); rembc: below-cloud stratiform precip rate (mm/hr);
    oh_clim: OH molec/cm³; h2o2_clim: H2O2 mol/mol.
    """
    kz = so2.shape[0]
    caircell = 1.0e-6 * rho / AMDK * NAVGDR      # molec/cm³ (:68)

    # --- gas-phase conversion (:88-135) -----------------------------
    day = czen >= 0.001
    oh = oh_clim * torch.where(day, oh_clim.new_tensor(1.99), 0.01)[None]
    so2_rate = so2_oh_rate(caircell, temp) * oh
    so2_avail = torch.clamp(so2, min=0.0) / dt
    so2_snk = so2_avail * (1.0 - torch.exp(-so2_rate * dt))
    so2_ten = -so2_snk
    so4_ten = 1.5 * so2_snk

    # --- aqueous in large-scale clouds (:160-270) -------------------
    # mole-limited convertible SO2 (igaschem=0 branch, ioxclim=1)
    chimol = (AMDK / 64.0) * torch.clamp(so2, min=0.0)
    concmin = torch.minimum(h2o2_clim, chimol) * 64.0 / AMDK
    in_cloud = wl > CLMIN
    rxs1 = torch.where(
        in_cloud,
        fracloud * SOLSO2 * concmin
        * (torch.exp(-wl / 360.0 * dt) - 1.0), 0.0)
    # below-cloud SO2 washout, Levin & Schwartz (:244-249)
    krembc = 6.5e-5 * torch.clamp(rembc, min=0.0) ** 0.68
    wetrem = torch.where(rembc > 0.0,
                         SOLSO2 * concmin * (torch.exp(-krembc * dt) - 1.0),
                         0.0)
    so2_ten = so2_ten + rxs1 / dt + wetrem / dt
    so4_ten = so4_ten - 1.5 * rxs1 / dt
    washout = -wetrem / dt

    # --- aqueous in cumulus towers (:271-312) -----------------------
    # columns from kcumtop down to the surface; fixed 2 g/m³ water
    klev = torch.arange(kz, device=so2.device)[:, None, None]
    in_cum = (kcumtop[None] >= 0) & (klev >= kcumtop[None])
    rxs2 = torch.where(
        in_cum,
        fracum * SOLSO2 * concmin
        * (math.exp(-2.0 / 360.0 * dt) - 1.0), 0.0)
    so2_ten = so2_ten + rxs2 / dt
    so4_ten = so4_ten - 1.5 * rxs2 / dt

    return SoxOut(so2_ten, so4_ten, washout)
