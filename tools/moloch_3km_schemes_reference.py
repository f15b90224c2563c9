#!/usr/bin/env python3
"""The JAX package's MOLOCH core with configuration B's physics (no deep
convection, icup_lnd = icup_ocn = 0; the 5-species Nogherotto-Tompkins
microphysics, ipptls=2; Holtslag) at the 3 km flagship's settings on a
48x48x41 cut of its 192x192 domain: ds 3 km, dt 30 s, float32 on the
CPU (x64 off), flat terrain, from ``initial_state(perturb=0.3,
seed=1)`` moistened as ``chip_smoke.moisten`` does it: qv 1.8 times the
rest state's (about 90% of saturation), cloud water 1e-4 between 250 K
and 290 K and ice 3e-5 between 220 K and 265 K.

Prints, at every sixth step through ``--steps`` (12 by default), the
surface-pressure range (hPa), the largest |w| (m/s) and the largest
mixing ratio of each hydrometeor (qc, qr, qi, qs, kg/kg), and whether
the state stayed finite. ``chip_smoke.py`` phase 15b holds the port on
the card to these numbers (its ``B_REFERENCE``). Run from the repository
root:

    JAX_PLATFORMS=cpu python3 tools/moloch_3km_schemes_reference.py [--steps 12]
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
# configuration B's physics
B = dict(icup_lnd=0, icup_ocn=0, ibltyp=1, ipptls=2, icldfrac=0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    from regcm_tpu.config.params import RegCMConfig
    from regcm_tpu.core.grid import build_grid
    from regcm_tpu.driver import Model
    from regcm_tpu.dynamics.moloch import MolochCore
    with jax.enable_x64(False):
        cfg = RegCMConfig()
        cfg.core.idynamic = 3
        cfg.dim.iy = cfg.dim.jx = N
        cfg.dim.kz = KZ
        cfg.geo.ds = 3.0
        cfg.time.dt = 30.0
        for k, v in B.items():
            setattr(cfg.physics, k, v)
        grid = build_grid(cfg)
        s0 = MolochCore(grid, cfg, dtype=jnp.float32).initial_state(
            perturb=0.3, seed=1)
        t = np.asarray(s0.t)
        qx0 = np.asarray(s0.qx)
        qc = np.where((t > 250.0) & (t < 290.0), 1.0e-4, 0.0)
        qi = np.where((t > 220.0) & (t < 265.0), 3.0e-5, 0.0)
        z = np.zeros_like(t)
        qx = np.stack([1.8 * qx0[0], qc, z, qi, z]).astype(qx0.dtype)
        s0 = s0._replace(qx=jnp.asarray(qx))
        m = Model(cfg, grid=grid, dtype=jnp.float32, initial_state=s0)
        for n in range(1, args.steps + 1):
            m.step()
            if n % 6 == 0:
                d = m.decoupled()
                qx = np.asarray(m.state.qx)
                qmax = ", ".join(f"{q} {float(qx[i].max()):.6e}" for i, q
                                 in enumerate(("qc", "qr", "qi", "qs"), 1))
                print(f"step {n}: ps {float(np.min(d['ps'])):.4f}.."
                      f"{float(np.max(d['ps'])):.4f} hPa, wmax "
                      f"{float(np.abs(np.asarray(d['w'])).max()):.5f} m/s, "
                      f"{qmax}", flush=True)
        print(f"finite through step {args.steps}: {m.check_finite()}")


if __name__ == "__main__":
    main()
