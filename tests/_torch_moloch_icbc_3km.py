"""The MOLOCH 3 km ICBC start, the JAX package and the port side by side
(f32, CPU): the flagship's settings (ds 3 km, dt 30 s, kz 41, flat, a
one-day ICBC file of 10 m/s jet records written by the JAX package's
``generate_synthetic_icbc``) on an n x n cut, run through the radiation
step 60; prints the surface-pressure range and max |w| of both at steps
12, 24, 36, 48 and 61, and where the port's surface pressure peaks.

Not collected by pytest (a minute of JAX compiles per alarm pattern).
Run from the repository root:

    JAX_PLATFORMS=cpu python -m tests._torch_moloch_icbc_3km [n]
"""
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

from regcm_tpu.config.params import RegCMConfig as JConfig
from regcm_tpu.driver import Model as JModel
from regcm_tpu.preproc.icbc import ICBCReader as JReader
from regcm_tpu.preproc.icbc import generate_synthetic_icbc
from regcm_tpu.preproc.terrain import synthetic_topo
from regcm_tpu_torch.config.params import RegCMConfig
from regcm_tpu_torch.driver import Model
from regcm_tpu_torch.preproc.icbc import ICBCReader

MARKS = (12, 24, 36, 48, 61)


def setup(cfg, n):
    cfg.core.idynamic = 3
    cfg.dim.iy = cfg.dim.jx = n
    cfg.dim.kz = 41
    cfg.geo.ds = 3.0
    cfg.time.dt = 30.0
    cfg.globdat.gdate2 = 1990060200
    return cfg


def main(n=32):
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    jcfg, tcfg = setup(JConfig(), n), setup(RegCMConfig(), n)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "icbc.nc")
        topo, _, _ = synthetic_topo(jcfg, kind="flat")
        generate_synthetic_icbc(jcfg, topo, path, jet=10.0)
        jm = JModel(jcfg, dtype=jnp.float32)
        jm.init_from_icbc(JReader(path))
        tm = Model(tcfg, device="cpu", dtype=torch.float32)
        tm.init_from_icbc(ICBCReader(path))
    for step in range(1, max(MARKS) + 1):
        jm.run_icbc(1)
        tm.run_icbc(1)
        if step in MARKS:
            jd = {k: np.asarray(v) for k, v in jm.decoupled().items()}
            td = tm.decoupled()
            peak = np.unravel_index(np.argmax(td["ps"]), td["ps"].shape)
            print(f"{n}x{n}x41 step {step}: JAX ps {jd['ps'].min():.3f}.."
                  f"{jd['ps'].max():.3f} hPa, wmax "
                  f"{np.abs(jd['w']).max():.4f} m/s; port ps "
                  f"{td['ps'].min():.3f}..{td['ps'].max():.3f} hPa, wmax "
                  f"{np.abs(td['w']).max():.4f} m/s; port ps peak at (y, x) "
                  f"{tuple(int(i) for i in peak)}", flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
