"""Pollen surface emission (``pollen_emission``,
``Main/chemlib/mod_che_pollen.F90:58-140``), torch twin of
``regcm_tpu/chem/pollen.py``.

Sofiev et al. (2006) flowering-season flux: the emission-potential map
(grain/m²/day, from the CHEMISS inventory when present, else zero) is
converted to a mass flux modulated by humidity (fh), wind (fw) and
precipitation (fr) factors and the friction velocity.
"""
from __future__ import annotations

import math

import torch

from .species import RHOPOLLEN, REFFPOLLEN

CE = 1.0e-4
HTC = 1.0


def pollen_emission(emispot_grains, ustar, wind10, rh10, prate):
    """(iy, jx) surface mass flux kg/m²/s. emispot_grains the emission
    potential map (chemsrc); rh10 fractional RH; prate total surface
    precipitation kg/m²/s."""
    # grains/m² per day → kg/m² (mod_che_pollen.F90:76-81)
    emis = (emispot_grains * 24.0) * (math.pi / 6.0) \
        * (REFFPOLLEN * 1.0e-6) ** 3 * RHOPOLLEN
    rh = rh10 * 100.0
    fh = torch.clamp((80.0 - rh) / 30.0, 0.0, 1.0)
    precip = prate * 3600.0
    fr = torch.clamp((0.5 - precip) / 0.5, 0.0, 1.0)
    fw = 0.5 + (1.0 - torch.exp(-wind10 / 5.0))
    return emis * ustar / HTC * CE * fh * fw * fr
