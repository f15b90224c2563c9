"""Ensembling utilities: O'Brien, Sloan & Snyder (2010, Clim. Dyn.
10.1007/s00382-010-0900-5) multiplicative ICBC noise and the
-log-uniform random split (Share/mod_ensemble.F90).

Host-side numpy like the reference (perturbation happens at file-read
time, outside the jitted model step); pass a seeded Generator for
reproducible ensemble members.

A copy of ``regcm_tpu/utils/ensemble.py`` (JAX-free), held equal to it by
``tests/test_torch_shared.py``.
"""
from __future__ import annotations

import numpy as np


def randify(arr, frac: float, rng: np.random.Generator):
    """arr + arr·frac·U(-1, 1): each value moves by at most ±frac of
    itself (randify2D/3D, mod_ensemble.F90:186-301)."""
    a = np.asarray(arr)
    return a + a * frac * (2.0 * rng.random(a.shape) - 1.0)


def random_pick(thesum: float, nv: int, rng: np.random.Generator):
    """Split ``thesum`` into ``nv`` random positive parts: yi=-log(U)
    normalized (random_pick_1d, mod_ensemble.F90:57-95)."""
    out = np.zeros(nv)
    if thesum < 1.0e-30:
        return out
    yi = -np.log(np.maximum(rng.random(nv), 1.0e-300))
    return yi / yi.sum() * thesum
