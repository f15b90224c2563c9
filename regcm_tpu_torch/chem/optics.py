"""Aerosol optical properties for the CCM3 (standard) radiation — the
dust part of ``aeroppt`` (``Main/radlib/mod_rad_aerosol.F90:
1955-2260``), torch twin of ``regcm_tpu/chem/optics.py``: the external
mixture over tracer bins, per CCM3 spectral interval (nspi=19), plus the
grey LW dust transmission ``aertrlw``.

The SW mixture quantities follow the reference's layout for radcsw:
tauxar3d = Σ τ; tauasc3d = Σ ω·τ; gtota3d = Σ g·ω·τ; ftota3d = Σ g²·ω·τ
(already ω- and τ-weighted numerators). Sums over the tracers are added
in tracer order.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dynamics.hydrostatic import level_sum
from ..utils import constants as c
from ._dust_optics_data import (KSDUST_STAND, WSDUST_STAND,
                                GSDUST_STAND, KSDUST12_STAND,
                                WSDUST12_STAND, GSDUST12_STAND)

QABSLW_DUST = 0.1      # grey LW absorption coeff m²/g (aeroppt :2203)
FIVEOTHREE = 5.0 / 3.0


class AerosolOptics(NamedTuple):
    """Per-tracer SW tables for the external mixture (nspi, ntr)."""
    ks: torch.Tensor
    ws: torch.Tensor
    gs: torch.Tensor
    lw_mask: torch.Tensor  # per tracer, 1.0 where the grey LW term applies


def dust_optics_tables(ntr: int, device="cpu",
                       dtype=torch.float64) -> AerosolOptics:
    """DUST/DU12 SW tables (ksdust_stand/ksdust12_stand)."""
    if ntr == 4:
        ks, ws, gs = KSDUST_STAND, WSDUST_STAND, GSDUST_STAND
    elif ntr == 12:
        ks, ws, gs = KSDUST12_STAND, WSDUST12_STAND, GSDUST12_STAND
    else:
        raise ValueError(f"no dust optics for ntr={ntr}")
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return AerosolOptics(ks=f(ks), ws=f(ws), gs=f(gs),
                         lw_mask=f(np.ones(ntr)))


class SWAerosol(NamedTuple):
    """radcsw aerosol inputs, (ncol, kz+1, nspi), padded like the cloud
    optical arrays (the extra CCM3 top layer at index 0)."""
    tauxar: torch.Tensor
    tauasc: torch.Tensor
    gtota: torch.Tensor
    ftota: torch.Tensor


def sw_aerosol_mixture(aermmr, pint_pa, tab: AerosolOptics) -> SWAerosol:
    """External mixture over bins (aeroppt spectral loop :2010-2140).

    aermmr (ntr, ncol, kz) decoupled kg/kg; pint_pa (ncol, kz+1) Pa."""
    path = (pint_pa[:, 1:] - pint_pa[:, :-1]) * c.regrav   # kg/m²
    u = aermmr * path[None] * 1000.0                       # g/m²
    # tau (ntr, ncol, kz, nspi)
    tau = u[..., None] * tab.ks.T[:, None, None, :]
    wtau = tau * tab.ws.T[:, None, None, :]
    g = tab.gs.T[:, None, None, :]
    pad = lambda a: torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
    return SWAerosol(tauxar=pad(level_sum(tau)), tauasc=pad(level_sum(wtau)),
                     gtota=pad(level_sum(wtau * g)),
                     ftota=pad(level_sum(wtau * g ** 2)))


def lw_dust_path(aermmr, pint_pa, lw_mask):
    """Cumulative dust path u(k) from TOA (g/m²) for the grey LW
    transmission aertrlw(k1,k2)=exp(−5/3·qabs·|u(k2)−u(k1)|)
    (aeroppt :2203-2250). Returns (ncol, kz+1)."""
    path = (pint_pa[:, 1:] - pint_pa[:, :-1]) * c.regrav
    u = level_sum(aermmr * lw_mask[:, None, None]) * path * 1000.0
    return torch.cat([torch.zeros_like(u[:, :1]), torch.cumsum(u, dim=1)],
                     dim=1)
