"""Sea-salt surface emission (``sea_salt``,
``Main/chemlib/mod_che_seasalt.F90:66-165``), torch twin of
``regcm_tpu/chem/seasalt.py``.

Monahan (1986) whitecap emission integrated over each transport bin
with Gong et al. (1997) hygroscopic growth at RH 80% and the O'Dowd
(1997) lognormal adjustment below r_dry = 0.1 µm (``seasalt_emit``
:153-430).  The 1000-sub-bin integration runs once at config time in
NumPy; the runtime flux is ``emfac · u10^3.41`` over open-water
points (Gong's Eqn 5a wind dependence).
"""
from __future__ import annotations

import numpy as np
import torch

# Gong (1997) hygroscopic growth constants (Table 2 / Eqn 3)
_C1, _C2, _C3, _C4 = 0.7674, 3.079, 2.573e-11, -1.424
_DRYDENS = 2.165          # g/cm³
_RELHUM = 0.80
_RDRY_STAR = 0.1          # µm, below which O'Dowd adjustment applies
_SIGMAG_STAR = 1.9


def _rwet(rdry_um: np.ndarray) -> np.ndarray:
    """Wet radius (µm) at RH 80% from dry radius (Gong Eqn 3)."""
    r_cm = rdry_um * 1.0e-4
    rw_cm = (r_cm ** 3 + (_C1 * r_cm ** _C2)
             / ((_C3 * r_cm ** _C4) - np.log10(_RELHUM))) ** (1.0 / 3.0)
    return rw_cm * 1.0e4


def _df0drwet(rwet_um: np.ndarray) -> np.ndarray:
    """Monahan dF0/dr at the wet radius (Gong Eqn 5a)."""
    b = (0.380 - np.log10(rwet_um)) / 0.650
    return (1.373 * rwet_um ** -3.0
            * (1.0 + 0.057 * rwet_um ** 1.05)
            * 10.0 ** (1.19 * np.exp(-b * b)))


def seasalt_emit(dplo_um: float, dphi_um: float, nsub: int = 1000):
    """(number, mass) emission factors for a dry-diameter bin —
    flux = factor · u10^3.41; mass factor in g/m²/s per unit wind
    factor (seasalt_emit, mod_che_seasalt.F90:153-424)."""
    rlo, rhi = dplo_um * 0.5, dphi_um * 0.5
    dens_f = _DRYDENS * (4.0 / 3.0) * np.pi * 1.0e-12   # r³µm → g
    sum_na = sum_ma = 0.0
    # Section 1: rdry > rdry_star, Monahan directly
    if rhi > _RDRY_STAR:
        lo = max(rlo, _RDRY_STAR)
        edges = np.exp(np.linspace(np.log(lo), np.log(rhi), nsub + 1))
        rwet_edges = _rwet(edges)
        rdry = np.sqrt(edges[:-1] * edges[1:])
        rwet = np.sqrt(rwet_edges[:-1] * rwet_edges[1:])
        drwet = np.diff(rwet_edges)
        xmdry = dens_f * rdry ** 3
        df0 = _df0drwet(rwet)
        sum_na += float(np.sum(drwet * df0))
        sum_ma += float(np.sum(drwet * df0 * xmdry))
    # Section 2: rdry < rdry_star, O'Dowd lognormal extrapolation
    if rlo < _RDRY_STAR:
        raa, rbb = 0.99 * _RDRY_STAR, 1.01 * _RDRY_STAR
        rwa, rwb = _rwet(np.array([raa]))[0], _rwet(np.array([rbb]))[0]
        rw = 0.5 * (rwa + rwb)
        df0_star = (_df0drwet(np.array([rw]))[0]
                    * (rwb - rwa) / np.log(rbb / raa))
        hi = min(rhi, _RDRY_STAR)
        ln_edges = np.linspace(np.log(rlo), np.log(hi), nsub + 1)
        dln = ln_edges[1] - ln_edges[0]
        rdry = np.exp(0.5 * (ln_edges[:-1] + ln_edges[1:]))
        xmdry = dens_f * rdry ** 3
        adj = np.exp(-0.5 * (np.log(rdry / _RDRY_STAR)
                             / np.log(_SIGMAG_STAR)) ** 2)
        sum_na += float(np.sum(dln * df0_star * adj))
        sum_ma += float(np.sum(dln * df0_star * adj * xmdry))
    return sum_na, sum_ma


class SeasaltEmission:
    """Config-time emission factors for the sbin transport bins
    (mass in kg/m²/s per u10^3.41)."""

    def __init__(self, bins_um=((0.05, 1.0), (1.0, 10.0))):
        mf = [seasalt_emit(lo, hi)[1] for lo, hi in bins_um]
        # g/m²/s → kg/m²/s (the reference's kmol with mw=1 equals kg
        # ×1e-3: mod_che_seasalt.F90:117-122)
        self.emfac_mass = np.asarray(mf) * 1.0e-3

    def __call__(self, wind10, ocean_mask):
        """(nbins, iy, jx) surface mass flux kg/m²/s."""
        u = torch.clamp(wind10, 0.0, 100.0) ** 3.41
        f = torch.as_tensor(self.emfac_mass, dtype=wind10.dtype,
                            device=wind10.device)
        return f[:, None, None] * (u * ocean_mask)[None]
