#!/usr/bin/env python3
"""The JAX package's MM5 non-hydrostatic core (idynamic=2) at the 3 km
flagship's settings on a 48x48x41 cut of its 192x192 domain: ds 3 km,
dt 15 s, float32 on the CPU (x64 off), default physics, flat terrain,
from ``nh_initial_state(perturb=0.5, seed=1)``.

dt is half the MOLOCH flagship's 30 s: the acoustic solver takes
istep = max(int(2·dtsec/dtsmax), 4) substeps of a leapfrog step 2·dtsec,
with dtsmax = dx/cs/(1+nhxkd) = 7.86 s at 3 km; at dt 30 s that is 7
substeps of 8.57 s, above dtsmax, and the state goes non-finite within
12 steps (``--dt 30``); at dt 15 s it is 4 substeps of 7.5 s.

Prints, at every sixth step through ``--steps`` (48 by default), the
largest |w| (m/s) and |pp| (Pa) and the T range (K) of the decoupled
state, and whether the state stayed finite. ``chip_smoke.py`` phase 14a
holds the port on the card to the numbers of steps 6-24 (its
``NH_REFERENCE``); the run to step 48 checks that these settings stay
finite for the stretch that phase times. Run from the repository root:

    JAX_PLATFORMS=cpu python3 tools/nh_3km_reference.py [--steps 48] [--dt 15]
"""
import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

N, KZ = 48, 41


def summary(state):
    """(max |w| m/s, max |pp| Pa, T min K, T max K) of a HydroState."""
    ps = np.asarray(state.ps_a)
    w = np.asarray(state.w_a) / ps[None]
    pp = np.asarray(state.pp_a) / ps[None]
    t = np.asarray(state.t_a) / ps[None]
    return (float(np.abs(w).max()), float(np.abs(pp).max()),
            float(t.min()), float(t.max()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--dt", type=float, default=15.0)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    from regcm_tpu.config.params import RegCMConfig
    from regcm_tpu.core.grid import build_grid
    from regcm_tpu.driver import Model, nh_initial_state
    from regcm_tpu.dynamics.hydrostatic import HydroCore
    with jax.enable_x64(False):
        cfg = RegCMConfig()
        cfg.core.idynamic = 2
        cfg.dim.iy = cfg.dim.jx = N
        cfg.dim.kz = KZ
        cfg.geo.ds = 3.0
        cfg.time.dt = args.dt
        grid = build_grid(cfg)
        s0 = nh_initial_state(HydroCore(grid, cfg, dtype=jnp.float32),
                              perturb=0.5, seed=1)
        m = Model(cfg, grid=grid, dtype=jnp.float32, initial_state=s0)
        for n in range(1, args.steps + 1):
            m.step()
            if n % 6 == 0:
                wmax, ppmax, tmin, tmax = summary(m.state)
                print(f"step {n}: wmax {wmax:.5f} m/s, ppmax {ppmax:.4f} "
                      f"Pa, T {tmin:.4f}..{tmax:.4f} K", flush=True)
        print(f"finite through step {args.steps}: {m.check_finite()}")


if __name__ == "__main__":
    main()
