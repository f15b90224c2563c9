"""CB6r2 gas-phase kinetics + photolysis mapping, torch twin of
``regcm_tpu/chem/cb6.py``.

The reference ships the complete KPP-generated CB6r2 mechanism
(``Main/chemlib/GAS_CB6r2/mod_cb6_*.F90``, 216 reactions / 76 var +
6 fixed species) but wires it to no ``chemsimtype`` — the modules are
compiled by no Makefile and used by no interface (its ``C_Mb`` global
is never even assigned).  Here the mechanism is a first-class citizen:
``chemsimtype = 'CB6'`` selects it, running the same batched Ros2
machinery as CBMZ (``kinetics.GasKinetics``) on the tensors extracted
by ``tools/extract_cb6.py``.

Photolysis: the reference's CB6 jvalues come from the same external
TUVGRID2 table archive as CBMZ's (``mod_cb6_jval1.F90 readhv``, absent
from the tree and this environment), so the MCM analytic stand-in
(jvalues.py) supplies the 28 CB6 channels.  Channels without a direct
MCM fit are scaled from spectrally similar ones (factors below,
JPL/IUPAC magnitudes) — all inside the mechanism's own rtol = atol =
0.1 solver tolerance.

Fixed species (mod_cb6_Main.F90:106-112): WTR = water vapor,
DIHY = 0.55 ppm H2, O2 = 0.20946·M, METH = 1.8 ppm CH4, M = 0.78084·M
(N2 despite the name), DUMMY2 = 0.
"""
from __future__ import annotations

import torch

from . import _cb6_mech_data as M
from .kinetics import GasKinetics
from .jvalues import cbmz_jvals

NVAR, NFIX, NREACT = M.NVAR, M.NFIX, M.NREACT

KIN = GasKinetics(M)
fun = KIN.fun
jac = KIN.jac
integrate = KIN.integrate

# CB6 jval channel → (MCM base channel, scale).  Scales are JPL 15-10
# / IUPAC cross-section magnitude ratios for channels MCM lacks:
#   DNPOb: N2O5 photolysis ≈ 4× J(H2O2) (same UV window, ~4e-5 vs
#          ~8e-6 s⁻¹ overhead-sun)
#   PACN/PANX (PAN-type): ≈ 0.1× J(H2O2) (~8e-7 s⁻¹ overhead sun)
#   NTR/NTR-like organic nitrates: ≈ 2× J(HNO3)
#   GLY (glyoxal): ≈ 15× J(CH3CHO) (~8e-5 s⁻¹); MEGY ≈ 20×;
#   GLYD ≈ 1×; ISPD/HPLD/CRON/XOPN/ROPN: carbonyl-window channels
#   scaled from CH3CHO per the CAMx CB6 ratios.
_J_MAP = {
    "NDOX": ("no2", 1.0),
    "O33P": ("o33p", 1.0),
    "O31D": ("o31d", 1.0),
    "HPOX": ("h2o2", 1.0),
    "NTOXa": ("no3a", 1.0),      # NO3 → NO   (rconst 28)
    "NTOXb": ("no3b", 1.0),      # NO3 → NO2 + O (rconst 27)
    "DNPOb": ("h2o2", 4.0),
    "HONO": ("hno2", 1.0),
    "NTRC": ("hno3", 1.0),
    "PNA": ("hno4", 1.0),
    "PACN": ("h2o2", 0.1),
    "PANX": ("h2o2", 0.1),
    "MEPX": ("ch3ooh", 1.0),
    "RPOX": ("ch3ooh", 1.0),
    "NTR": ("hno3", 2.0),
    "FORM": ("ch2oa", 1.0),      # the reference feeds ONE jval to
                                 # both FORM channels (rconst 97/98)
    "AALD": ("ch3choa", 1.0),
    "ALDX": ("ch3choa", 1.2),
    "GLYD": ("ch3choa", 1.0),
    "GLY": ("ch3choa", 15.0),
    "MEGY": ("ch3choa", 20.0),
    "KET": ("ch3coch3", 1.0),
    "ACET": ("ch3coch3", 1.0),
    "ISPD": ("ch3choa", 0.5),
    "HPLD": ("ch3ooh", 5.0),
    "CRON": ("hno3", 100.0),     # nitro-cresol, fast visible channel
    "XOPN": ("ch2oa", 0.5),
    "ROPN": ("ch2oa", 0.5),
}


def cb6_jvals(coszen, alt_km, tau_above, tau_below):
    """CB6-named photolysis dict from the MCM base channels."""
    base = cbmz_jvals(coszen, alt_km, tau_above, tau_below)
    return {k: s * base[b] for k, (b, s) in _J_MAP.items()}


def fixed_species(c_m, wtr):
    """(…, 6) fixed-species concentrations (mod_cb6_Main.F90:106-112).
    c_m air molec/cm³, wtr water molec/cm³."""
    zeros = torch.zeros_like(c_m)
    return torch.stack([wtr, 5.5e-7 * c_m, 0.20946 * c_m,
                        1.8e-6 * c_m, 0.78084 * c_m, zeros], dim=-1)
