"""CBMZ gas-phase kinetics — the generic batched Ros2 machinery
(``kinetics.GasKinetics``) instantiated with the extracted CBMZ
tensors (``_cbmz_mech_data``, from ``tools/extract_cbmz.py``); torch
twin of ``regcm_tpu/chem/cbmz.py``.

The reference integrates the KPP-generated CBMZ mechanism per grid
cell with an adaptive-order LSODE/BDF (``mod_cbmz_integrator.F90``)
at rtol = atol = 0.1 (``chemmain``, ``mod_cbmz_main.F90:92-95``);
see kinetics.py for the documented LSODE → Rosenbrock deviation.

Peroxy-peroxy ``rk_param`` cross terms are dead code in the reference
(``peroxyrateconstants`` result never enters ``update_rconst``) and
are omitted identically.
"""
from __future__ import annotations

from . import _cbmz_mech_data as M
from .kinetics import GasKinetics

NVAR, NFIX, NREACT = M.NVAR, M.NFIX, M.NREACT
NTOT = NVAR + NFIX + 1          # + constant-1 slot

KIN = GasKinetics(M)
fun = KIN.fun
jac = KIN.jac
integrate = KIN.integrate
