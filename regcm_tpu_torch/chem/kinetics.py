"""Generic batched gas-phase kinetics: tensors and the Rosenbrock solver,
torch twin of ``regcm_tpu/chem/kinetics.py``.

One machinery for every KPP-generated mechanism the reference ships
(CBMZ ``GAS_CBMZ_NEW/``, CB6r2 ``GAS_CB6r2/``): a mechanism is three
extracted tensors, a (nreact, ≤3) reactant-index table, a dense
(nvar, nreact) stoichiometry matrix and an ``update_rconst`` rate
function, and the solver is a batched adaptive two-stage Rosenbrock
(Ros2, L-stable; Verwer et al. 1999 / the KPP ros2 tableau) over the
grid cells:

- rates:    a_r = rconst_r · Π_s c[idx_{r,s}]   (gather and product)
- vdot:     a @ Sᵀ
- Jacobian: ∂a_r/∂c_j per reactant slot as rconst·(product of the other
  slots), one contraction a slot summed in slot order; each slot's
  contraction maps the reactions onto the Jacobian's nonzero entries
  only (525 of 58² for CBMZ, 919 of 76² for CB6r2), which are then
  placed into the dense matrix
- stage solves: batched LU of P = I/(hγ) − J, two back-solves a step
  (``kernels.gas_lu``: LAPACK's getrf and getrs on the CPU, a hand-written
  CUDA kernel a warp a cell on the card)

DOCUMENTED DEVIATION (of the JAX package, kept): the reference's
per-cell LSODE/BDF (``mod_cbmz_integrator.F90`` /
``mod_cb6_Integrator.F90``, rtol = atol = 0.1) is a batched Ros2.

Each iteration takes the cells still short of tend in chunks of a fixed
number of cells: the dense Jacobian is 13.5 KB a cell at NVAR 58 in f32,
so two million cells' J, P and LU do not fit on one card at once. A
chunk is padded to the full chunk size with inert cells (no rates, no
species), so that every GEMM of a solve has one shape whatever the
rank's block and the number of cells still iterating, and its summation
order does not follow the batch (the LU kernel is a warp a cell): a
decomposed run stays bit-identical to one card. The cells are
independent and a finished cell is left as it is, so a chunked solve
gives the numbers the whole batch gives. Finding the cells still short
of tend reads their count back from the device once an iteration;
``stats`` counts the iterations, those host syncs and the chunk solves.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.gas_lu import lu_factor_solve, lu_solve

# Ros2 tableau (gamma = 1 + 1/sqrt(2); KPP ros2 coefficients)
_G = 1.0 + 1.0 / np.sqrt(2.0)
_A21 = 1.0 / _G
_C21 = -2.0 / _G
_M1, _M2 = 3.0 / (2.0 * _G), 1.0 / (2.0 * _G)
_E1, _E2 = 1.0 / (2.0 * _G), 1.0 / (2.0 * _G)

# cells a chunk on a CUDA device (the padded solve shape)
CUDA_CHUNK = 65536


class GasKinetics:
    """Mechanism-bound kinetics; ``mech`` is a generated ``_*_mech_data``
    module (NVAR/NFIX/NREACT, STOICH, REACT_IDX)."""

    def __init__(self, mech):
        self.mech = mech
        self.nvar = nvar = mech.NVAR
        self.nfix = mech.NFIX
        self.nreact = nreact = mech.NREACT
        self.nslot = mech.REACT_IDX.shape[1]
        stoich = np.asarray(mech.STOICH, np.float64)
        idx = np.asarray(mech.REACT_IDX)
        # slot s's one-hot E_s (nreact, nvar) folded with S: the
        # Jacobian entry (v, j) of slot s is Σ_r S[v, r]·E_s[r, j]·others
        full = np.zeros((self.nslot, nreact, nvar, nvar))
        for s in range(self.nslot):
            for r in range(nreact):
                if idx[r, s] < nvar:
                    full[s, r, :, idx[r, s]] = stoich[:, r]
        nz = np.flatnonzero(np.any(full != 0.0, axis=(0, 1)).reshape(-1))
        self._pos = nz                                  # (P,) of nvar²
        diag = np.isin(np.arange(nvar) * (nvar + 1), nz)
        self._diag_on = np.flatnonzero(diag)
        self._diag_off = np.flatnonzero(~diag)
        # row-major tables: a GEMM on a transposed operand takes another
        # path for a batch of one cell, which sums in another order
        self._w = np.ascontiguousarray(
            full.reshape(self.nslot, nreact, nvar * nvar)[:, :, nz])
        self._st = np.ascontiguousarray(stoich.T)       # (nreact, nvar)
        self._idx = idx
        self._cache = {}

    def _tables(self, like):
        key = (like.device, like.dtype)
        if key not in self._cache:
            t = lambda a, dt=like.dtype: torch.as_tensor(a, dtype=dt,
                                                         device=like.device)
            self._cache[key] = (t(self._st), t(self._w),
                                t(self._idx, torch.long),
                                t(self._pos, torch.long))
        return self._cache[key]

    def _factors(self, var, fix):
        """The reactant factors c[idx] (…, nreact, nslot)."""
        _, _, idx, _ = self._tables(var)
        one = torch.ones(var.shape[:-1] + (1,), dtype=var.dtype,
                         device=var.device)
        return torch.cat([var, fix, one], dim=-1)[..., idx]

    def fun(self, var, fix, rconst):
        """vdot (…, nvar)."""
        st = self._tables(var)[0]
        f = self._factors(var, fix)
        a = rconst
        for s in range(self.nslot):          # the JAX package's multiply
            a = a * f[..., s]                # order
        return a @ st

    def _jac_nonzero(self, var, fix, rconst):
        """The Jacobian's nonzero entries (…, P), the slots summed in
        order."""
        w = self._tables(var)[1]
        f = self._factors(var, fix)
        jnz = None
        for s in range(self.nslot):
            others = rconst
            for s2 in range(self.nslot):
                if s2 != s:
                    others = others * f[..., s2]
            g = others @ w[s]
            jnz = g if jnz is None else jnz + g
        return jnz

    def _dense(self, vals, like, out=None):
        """The (…, nvar, nvar) matrix holding ``vals`` at the Jacobian's
        nonzero entries and zeros elsewhere (``out``: a matrix of the same
        pattern to write them into)."""
        if out is None:
            out = torch.zeros(like.shape[:-1] + (self.nvar, self.nvar),
                              dtype=like.dtype, device=like.device)
        out.view(like.shape[:-1] + (-1,))[..., self._tables(like)[3]] = vals
        return out

    def jac(self, var, fix, rconst):
        """Dense Jacobian (…, nvar, nvar) of fun with respect to var."""
        return self._dense(self._jac_nonzero(var, fix, rconst), var)

    def stage_matrix(self, var, fix, rconst, hh):
        """P = I/(hh·γ) − J (n, nvar, nvar), the JAX package's
        ``eye / (hh * _G) - j0`` bit for bit (a − b = a + (−b) in IEEE
        arithmetic) without forming the identity."""
        p = self._dense(-self._jac_nonzero(var, fix, rconst), var)
        inv = (1.0 / (hh * _G))[:, None]
        diag = p.diagonal(dim1=-2, dim2=-1)
        on, off = self._diag_split(var)
        diag[:, on] += inv
        diag[:, off] = inv.expand(-1, len(self._diag_off))
        return p

    def _diag_split(self, like):
        """The diagonal's entries inside and outside the Jacobian's
        pattern, as index tensors on ``like``'s device."""
        key = ("diag", like.device)
        if key not in self._cache:
            self._cache[key] = tuple(
                torch.as_tensor(a, dtype=torch.long, device=like.device)
                for a in (self._diag_on, self._diag_off))
        return self._cache[key]

    def integrate(self, var0, fix, rconst, tend, rtol=0.1, atol=0.1,
                  hstart=1.0e-5, hmin=1.0e-8, max_steps=120, chunk=None,
                  stats=None):
        """Batched adaptive Ros2 from t=0 to ``tend`` (seconds).

        var0 (n, nvar) molec/cm³; fix (n, nfix); rconst (n, nreact).
        Columns advance independently; the loop exits when every cell
        reaches tend or after ``max_steps`` iterations (remaining cells
        keep their last state). The integration starts at a tiny h (1e-5
        s) because the radical spin-up from the zeroed non-transported
        species (µs lifetimes) must be resolved before the controller
        grows the step. ``chunk``: the cells a solve, the width every
        chunk is padded to (default ``CUDA_CHUNK`` on a CUDA device; on
        the CPU none: the cells still iterating in one solve, unpadded,
        as the CPU's GEMMs sum a row alike whatever the batch); ``stats``
        (a dict) gains ``iterations``, ``syncs`` and ``solves``."""
        n = var0.shape[0]
        if chunk is None and var0.device.type == "cuda":
            chunk = CUDA_CHUNK
        y = var0.clone()
        t = torch.zeros((n,), dtype=y.dtype, device=y.device)
        h = torch.full((n,), min(hstart, tend), dtype=y.dtype,
                       device=y.device)
        it = syncs = solves = 0
        while it < max_steps:
            sel = torch.nonzero(t < tend)[:, 0]
            syncs += 1
            if len(sel) == 0:
                break
            size = chunk or len(sel)
            for i0 in range(0, len(sel), size):
                self._step(y, t, h, sel[i0:i0 + size], fix, rconst,
                           float(tend), size, rtol, atol, hmin)
                solves += 1
            it += 1
        if stats is not None:
            for k, v in (("iterations", it), ("syncs", syncs),
                         ("solves", solves)):
                stats[k] = stats.get(k, 0) + v
        return y

    def _step(self, y, t, h, idx, fix, rconst, tend, width, rtol, atol,
              hmin):
        """One Ros2 step of the cells ``idx`` (each short of tend),
        gathered into ``width`` cells padded with inert ones; writes their
        new y, t and h back."""
        m = len(idx)

        def take(a):
            if m == width:
                return a[idx]
            out = a.new_zeros((width,) + a.shape[1:])
            out[:m] = a[idx]
            return out
        ys, fs, rs, ts, hs = (take(a) for a in (y, fix, rconst, t, h))
        hh = torch.clamp(torch.clamp(tend - ts, max=hs), min=hmin)
        f0 = self.fun(ys, fs, rs)
        lu, piv, k1 = lu_factor_solve(self.stage_matrix(ys, fs, rs, hh), f0)
        y2 = ys + _A21 * k1
        f2 = self.fun(torch.clamp(y2, min=0.0), fs, rs)
        rhs2 = f2 + (_C21 / hh)[:, None] * k1
        k2 = lu_solve(lu, piv, rhs2)
        ynew = ys + _M1 * k1 + _M2 * k2
        yerr = _E1 * k1 + _E2 * k2
        sc = atol + rtol * torch.maximum(ys.abs(), ynew.abs())
        err = torch.sqrt(torch.mean((yerr / sc) ** 2, dim=-1))
        err = torch.clamp(err, min=1e-10)
        accept = err <= 1.0
        fac = torch.clamp(0.9 * err ** -0.5, 0.2, 10.0)
        hnew = torch.clamp(hh * fac, hmin, tend)
        y[idx] = torch.where(accept[:, None], torch.clamp(ynew, min=0.0),
                             ys)[:m]
        t[idx] = torch.where(accept, ts + hh, ts)[:m]
        h[idx] = hnew[:m]
