"""Carbonaceous aerosol aging (``aging_carb``/``doaging``,
``Main/chemlib/mod_che_carbonaer.F90:145-180,265-300``), torch twin of
``regcm_tpu/chem/carbon.py``.

Hydrophobic → hydrophilic conversion with the constant Cooke et al.
(1999) 1.15-day e-folding time (carb_aging_control=.false., the
reference default). Tendencies returned uncoupled (kg/kg/s).
"""
from __future__ import annotations

import math

import torch

from .species import CARB_AGING_EFOLD

MINTR = 1.0e-30


def aging_tend(chi, aging_pairs, dt, efold=CARB_AGING_EFOLD):
    """chi (ntr, kz, iy, jx) uncoupled mixing ratios; for each
    (hydrophobic b1 → hydrophilic b2) pair the mass moved by the
    e-folding law (doaging, mod_che_carbonaer.F90:265-300)."""
    ten = torch.zeros_like(chi)
    factor = (1.0 - math.exp(-dt / efold)) / dt
    for b1, b2 in aging_pairs:
        a = -torch.clamp(chi[b1] - MINTR, min=0.0) * factor
        ten[b1] = ten[b1] + a          # ten is fresh: in-place is local
        ten[b2] = ten[b2] - a
    return ten
