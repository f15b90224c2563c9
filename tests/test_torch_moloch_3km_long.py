"""MOLOCH at the flagship's settings (ds 3 km, dt 30 s, 41 levels, float32,
default physics, flat terrain, the rest state perturbed by 0.3 K) on a
96×96 cut of its 192×192 domain, stepped until the state goes
non-finite: the JAX package and the port, both in float32 on the CPU
(x64 off), from the same numpy state.

The grid-scale mode of ``tests/test_torch_moloch_3km.py`` keeps growing
past step 24 into a state far from any real atmosphere (T beyond
180-340 K by step 90), and both packages blow up shortly before step
100. The port tracks the reference through step 90 and fails within a
few steps of it: a 60-step radiation cycle cannot be run from this
state, by either package. The JAX package's run goes in a spawned
process beside the port's."""
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from regcm_tpu.config.params import RegCMConfig  # noqa: E402
from regcm_tpu.core.grid import build_grid  # noqa: E402
from regcm_tpu_torch.config.params import RegCMConfig as TConfig  # noqa
from regcm_tpu_torch.core.grid import build_grid as tbuild_grid  # noqa

N, KZ, MAX_STEPS = 96, 41, 110
CHECKS = (30, 60, 90)


def cfgs():
    out = []
    for cls in (RegCMConfig, TConfig):
        cfg = cls()
        cfg.core.idynamic = 3
        cfg.dim.iy = cfg.dim.jx = N
        cfg.dim.kz = KZ
        cfg.geo.ds = 3.0
        cfg.time.dt = 30.0
        out.append(cfg)
    return out


def summary(d):
    return (float(d["ps"].min()), float(d["ps"].max()),
            float(np.abs(d["w"]).max()), float(d["t"].min()),
            float(d["t"].max()))


def _start():
    """The JAX package's float32 initial state (numpy), the start of both
    runs."""
    from regcm_tpu.dynamics.moloch import MolochCore as JCore
    jcfg, _ = cfgs()
    with jax.enable_x64(False):
        jg = build_grid(jcfg)
        return jax.device_get(JCore(jg, jcfg, dtype=jnp.float32)
                              .initial_state(perturb=0.3, seed=1))


def _step_until_blowup(m, to_numpy):
    """Summaries of ``m`` at CHECKS and the first step after which its
    state holds a non-finite value (None if it never did)."""
    out = {}
    for n in range(1, MAX_STEPS + 1):
        m.step()
        if not m.check_finite():
            return out, n
        if n in CHECKS:
            out[n] = summary({k: to_numpy(v)
                              for k, v in m.decoupled().items()})
    return out, None


def _jax_side(s0):
    """The JAX package's run (float32, x64 off) in a spawned process,
    which has not read the conftest's settings."""
    jax.config.update("jax_platforms", "cpu")
    from regcm_tpu.driver import Model as JModel
    jcfg, _ = cfgs()
    with jax.enable_x64(False):
        m = JModel(jcfg, grid=build_grid(jcfg), dtype=jnp.float32,
                   initial_state=jax.tree_util.tree_map(jnp.asarray, s0))
        return _step_until_blowup(m, np.asarray)


@pytest.fixture(scope="module")
def runs():
    """Summaries of both packages at CHECKS, and the first step after
    which each state holds a non-finite value (None if it never did).
    The JAX package runs in a spawned process beside the port."""
    from regcm_tpu_torch.driver import Model as TModel

    _, tcfg = cfgs()
    s0 = _start()
    # two torch threads: the test workers share the cores, and torch's
    # thread pools stall when oversubscribed at these sizes; this file of
    # five tests is among the last that --dist loadfile hands out (it
    # orders the files by their number of tests), when most workers are
    # done, and on one thread the port's run is the longer side
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as pool:
            job = pool.submit(_jax_side, s0)
            port = _step_until_blowup(
                TModel(tcfg, grid=tbuild_grid(tcfg), device="cpu",
                       dtype=torch.float32, initial_state=s0), np.asarray)
            ref = job.result()
    finally:
        torch.set_num_threads(threads)
    out = {"jax": ref[0], "port": port[0],
           "blowup": {"jax": ref[1], "port": port[1]}}
    for n in CHECKS:
        print(f"step {n}: JAX {out['jax'].get(n)}, port "
              f"{out['port'].get(n)}")
    print(f"first non-finite step: {out['blowup']}")
    return out


@pytest.mark.parametrize("step", CHECKS)
def test_port_tracks_reference_to_step_90(step, runs):
    """ps extremes within 2% of the reference's ps range and wmax within
    2%: float32 roundoff of two op orders, grown with the mode (at step
    60 the ps maxima differ by ~0.7 hPa of a ~140 hPa range)."""
    j, p = runs["jax"].get(step), runs["port"].get(step)
    assert j is not None and p is not None, "non-finite before the check"
    tol = 0.02 * (j[1] - j[0])
    assert abs(p[0] - j[0]) < tol and abs(p[1] - j[1]) < tol
    assert abs(p[2] - j[2]) < 0.02 * j[2]


def test_both_blow_up_together(runs):
    """Both states go non-finite between steps 90 and MAX_STEPS, the
    port within three steps of the reference."""
    jb, pb = runs["blowup"]["jax"], runs["blowup"]["port"]
    assert jb is not None and 90 < jb <= MAX_STEPS
    assert pb is not None and abs(pb - jb) <= 3


def test_state_is_unphysical_before_the_blow_up(runs):
    """By step 90 the temperature has left 180-340 K in both packages:
    the run is no longer a weather state, so no later step is timed."""
    for name in ("jax", "port"):
        tmin, tmax = runs[name][90][3:]
        assert tmin < 190.0 or tmax > 335.0, name
