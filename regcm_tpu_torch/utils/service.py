"""Observability: per-section timing, mass budget, NaN/CFL watchdog (torch
twin of ``regcm_tpu/utils/service.py``).

- ``StepProfiler`` ↔ the ``mod_service`` call-stack timers
  (``Main/mpplib/mod_service.F90:62-381``): wall time per named section
  on the host clock, with a report table; each section is also a
  ``torch.profiler`` range, and ``trace`` records a ``torch.profiler``
  trace of a scope.
- ``mass_budget`` ↔ ``massck`` (``Main/mod_massck.F90:54``): the dry and
  water mass sums, on the device, reduced over the ranks of a mesh.
- ``watchdog`` ↔ the syncro_rep NaN/CFL guard
  (``Main/mod_moloch.F90:437-460``): raises on a non-finite or
  unphysical surface pressure ``ps_a``. The MOLOCH state has none, in
  the JAX package too: the watchdog serves the sigma-p cores.
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

import numpy as np
import torch


class StepProfiler:
    """Named-section wall timer (mod_service equivalent). A section does
    not synchronise the device: wrap it in ``torch.cuda.synchronize()``
    calls, or use ``trace``, for the device's time."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        """time_print equivalent: per-section totals and averages."""
        lines = [f"{'section':<28}{'calls':>8}{'total_s':>12}{'avg_ms':>10}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            cnt = self.counts[name]
            lines.append(f"{name:<28}{cnt:>8}{tot:>12.3f}"
                         f"{tot / max(cnt, 1) * 1e3:>10.2f}")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    @contextmanager
    def trace(self, logdir: str):
        """Record a ``torch.profiler`` trace (host and, on a card, device
        activity) of this scope into ``logdir/trace.json``."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def mass_budget(state, grid, dsigma, mesh=None) -> Dict[str, torch.Tensor]:
    """Global dry-air and water mass (massck, Main/mod_massck.F90:54):
    cb-weighted area sums of the whole domain, formed on the device and
    summed over the ranks of ``mesh``; track the drift against step 0."""
    ps = state.ps_a
    w = np.asarray(grid.m_cross / grid.msfx ** 2)
    w = torch.as_tensor(w if mesh is None else mesh.local(w),
                        dtype=ps.dtype, device=ps.device)
    ds3 = torch.as_tensor(np.asarray(dsigma), dtype=ps.dtype,
                          device=ps.device)[:, None, None]
    dry = torch.sum(ps * w)
    water = torch.sum(torch.sum(state.qx_a, dim=0) * ds3 * w[None])
    if mesh is not None:
        both = mesh.all_reduce(torch.stack([dry, water]),
                               torch.distributed.ReduceOp.SUM)
        dry, water = both[0], both[1]
    return {"dry": dry, "water": water}


class MassTracker:
    """Drift against the initial state (the debug_level>0 report)."""

    def __init__(self, model):
        self.model = model
        b = self._budget()
        self.dry0 = float(b["dry"])
        self.water0 = float(b["water"])

    def _budget(self):
        m = self.model
        return mass_budget(m.state, m.grid, m.grid.dsigma,
                           getattr(m, "mesh", None))

    def drift(self) -> Dict[str, float]:
        b = self._budget()
        return {
            "dry_rel": float(b["dry"]) / self.dry0 - 1.0,
            "water_rel": (float(b["water"]) / self.water0 - 1.0)
            if self.water0 != 0 else 0.0,
        }


def watchdog(model, context: str = ""):
    """NaN/CFL guard on the whole domain's ``ps_a`` (cb): raise like the
    reference's fatal ('CFL VIOLATION', Main/mod_moloch.F90:443-450);
    returns (max, min) of the interior."""
    ps = model.state.ps_a
    mesh = getattr(model, "mesh", None)
    if mesh is not None:
        ps = mesh.gather(ps)
    ps = ps.detach().cpu().numpy()
    iy, jx = ps.shape
    core = ps[1:iy - 2, 1:jx - 2]
    if not np.isfinite(core).all():
        raise FloatingPointError(
            f"CFL VIOLATION / NaN detected in surface pressure {context}"
            " — decrease dt")
    pmax, pmin = core.max(), core.min()
    if pmax > 200.0 or pmin < 20.0:       # cb sanity window
        raise FloatingPointError(
            f"surface pressure out of physical range "
            f"[{pmin:.2f}, {pmax:.2f}] cb {context}")
    return pmax, pmin
