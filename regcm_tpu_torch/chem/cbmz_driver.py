"""Gas-phase chemistry model coupling, the ``chemistry`` equivalent
(``Main/chemlib/mod_che_chemistry.F90:50-147``), mechanism-generic (the
CBMZ and CB6r2 instantiations below); torch twin of
``regcm_tpu/chem/cbmz_driver.py``.

Per call: convert the transported tracers (uncoupled kg/kg) to molec/cm³
with ``cfactor = ρ·1e-3·N_A`` and the per-tracer molecular weight (:68,
:101), seed every NON-transported species at zero as the reference does
(the ``chemall`` restore at :93-97 is commented out there), set the
mechanism's fixed species, compute photolysis from the cosine zenith and
the cloud optical depths above and below each layer (``ichjphcld``,
:76-83), integrate the mechanism with the batched Rosenbrock
(``kinetics.GasKinetics``), and return the coupled tracer tendency.

DOCUMENTED DEVIATIONS (of the JAX package, kept)
- solver cadence: the reference solves every ``dtchsolv`` = 900 s and
  applies the held tendency each dt; here the solver runs every
  chemistry call over ``dt``.
- stratosphere skip: cells with p < 10 kPa (and the topmost level,
  kmin=2) get zero chemistry tendency, standing in for the ``cptrop``
  tropopause test (:65).
- photolysis: MCM analytic fits replace the absent TUVGRID2 table (see
  jvalues.py).

The cloud optical depth above each layer is a cumulative sum down the
levels in level order (``torch.cumsum`` over the level axis), so that a
rank's block sums as the whole domain does. ``stats`` (a dict, or None)
gathers the solver's iterations and host syncs over the calls.
"""
from __future__ import annotations

import numpy as np
import torch

BOLTZ = 1.380658e-23       # J/K
NAVGDR = 6.02214129e23
AMW_H2O = 18.0


class GasChemDriver:
    """Bound to one grid and configuration and a mechanism; called from
    ChemTend.

    ``mech``: generated ``_*_mech_data`` module; ``kin``: the mechanism's
    GasKinetics; ``jval_fn(coszen, alt, ta, tb)``; ``fix_fn(c_m, wtr)`` →
    (…, nfix) fixed species; ``h2o_var``: variable-species index of water
    (CBMZ) or None when water is a fixed species (CB6)."""

    def __init__(self, cfg, spec, mech, kin, jval_fn, fix_fn, h2o_var=None):
        self.cfg = cfg
        self.spec = spec
        self.mech = mech
        self.kin = kin
        self.jval_fn = jval_fn
        self.fix_fn = fix_fn
        self.h2o_var = h2o_var
        # tracers absent from the mechanism (aerosols, inert NH3 in the
        # DCCB set) are skipped: the reference's indcbmz<0 guard
        # (mod_che_chemistry.F90:100,135)
        self.indmech = np.array(
            [mech.SPECIES.index(n) if n in mech.SPECIES else -1
             for n in spec.names], np.int32)
        self.mw = np.array([mech.MW[i] if i >= 0 else 1.0
                            for i in self.indmech])
        self.kmin = 1              # skip topmost level (kmin=2 1-based)
        self.ptrop_pa = 1.0e4      # stratosphere cutoff
        self.ichjphcld = int(getattr(cfg.chem, "ichjphcld", 1))
        self.stats = {}
        # the tracers in the mechanism, their species slots and weights
        self._itr = [n for n in range(spec.ntr) if self.indmech[n] >= 0]
        self._cache = {}

    def _index(self, like):
        key = like.device
        if key not in self._cache:
            self._cache[key] = (
                torch.as_tensor(self._itr, dtype=torch.long,
                                device=like.device),
                torch.as_tensor(self.indmech[self._itr], dtype=torch.long,
                                device=like.device))
        return self._cache[key]

    def __call__(self, atms, s, chib, cpl, dt):
        """Coupled chemistry tendency (ntr, kz, iy, jx)."""
        ntr, kz, iy, jx = chib.shape
        nvar = self.kin.nvar
        tb3 = atms["tb3"]
        pb3 = atms["pb3"]                       # Pa
        rho = atms["rhob3"]
        rpsb = atms.get("rpsb")
        chi = torch.clamp(chib * rpsb[None], min=0.0) if rpsb is not None \
            else torch.clamp(chib, min=0.0)
        qv = torch.clamp(atms["qvb3"], min=0.0)

        cfactor = rho * 1.0e-3 * NAVGDR         # (kg/kg)·cf/mw → molec/cm³
        c_m = pb3 / (BOLTZ * tb3) * 1.0e-6      # air molec/cm³

        # photolysis: cloud optical depth above/below each layer from the
        # cloud water path (τ ≈ 0.15·LWP[g/m²] at re = 10 µm)
        coszen = atms.get("coszrs")
        if coszen is None:
            coszen = torch.zeros((iy, jx), dtype=tb3.dtype,
                                 device=tb3.device)
        if self.ichjphcld == 1:
            lwp = atms["qcb3"] * rho * atms["dzq"] * 1.0e3   # g/m²
            tau = 0.15 * lwp
            cum = torch.cumsum(tau, dim=0)
            tau_above = cum - tau
            tau_below = cum[-1][None] - cum
        else:
            tau_above = tau_below = torch.zeros_like(tb3)
        alt_km = atms["za"] * 1.0e-3
        jv = self.jval_fn(coszen, alt_km, tau_above, tau_below)

        # rate constants (nreact, kz, iy, jx)
        rconst = self.mech.update_rconst(tb3, c_m, jv)

        # pack concentrations: (ncell, nvar)
        ncell = kz * iy * jx
        itr, slot = self._index(chib)
        mw = torch.as_tensor(self.mw, dtype=tb3.dtype, device=tb3.device)
        cf_flat = cfactor.reshape(ncell)
        var0 = torch.zeros((ncell, nvar), dtype=tb3.dtype, device=tb3.device)
        var0[:, slot] = (chi[itr].reshape(len(self._itr), ncell)
                         * cf_flat / mw[itr, None]).T
        wtr = qv.reshape(ncell) * cf_flat / AMW_H2O
        if self.h2o_var is not None:
            var0[:, self.h2o_var] = wtr
        fix = self.fix_fn(c_m.reshape(ncell), wtr)
        rc_flat = rconst.reshape(self.kin.nreact, ncell).T

        varo = self.kin.integrate(var0, fix, rc_flat, dt, stats=self.stats)

        # tendency back to coupled kg/kg/s (chemistry :126-143)
        solve = (pb3 > self.ptrop_pa) & (
            torch.arange(kz, device=tb3.device)[:, None, None] >= self.kmin)
        dvar = (varo - var0)[:, slot].T.reshape(len(self._itr), kz, iy, jx)
        pfact = cpl[None] / cfactor / dt
        chemten = torch.zeros_like(chib)
        chemten[itr] = torch.where(solve, dvar * pfact * mw[itr, None, None,
                                                             None], 0.0)
        return chemten


def CbmzDriver(cfg, spec):
    """CBMZ instantiation: H2O is a VARIABLE species; fixed = O2/N2 at
    0.22/0.78·M (``chemmain``, mod_cbmz_main.F90:96-97; the reference's
    0.22 quirk kept)."""
    from . import _cbmz_mech_data as M
    from .cbmz import KIN
    from .jvalues import cbmz_jvals

    def fix_fn(c_m, wtr):
        return torch.stack([0.22 * c_m, 0.78 * c_m], dim=-1)

    return GasChemDriver(cfg, spec, M, KIN, cbmz_jvals, fix_fn,
                         h2o_var=M.SPECIES.index("H2O"))


def Cb6Driver(cfg, spec):
    """CB6r2 instantiation: water is the WTR FIXED species
    (mod_cb6_Main.F90:107)."""
    from . import _cb6_mech_data as M
    from .cb6 import KIN, cb6_jvals, fixed_species

    return GasChemDriver(cfg, spec, M, KIN, cb6_jvals, fixed_species,
                         h2o_var=None)
