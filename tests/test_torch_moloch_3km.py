"""MOLOCH at the flagship's settings (ds 3 km, dt 30 s, 41 levels, float32,
default physics, flat terrain, the rest state perturbed by 0.3 K) on a
48×48 cut of its 192×192 domain: the JAX package and the port, both in
float32 on the CPU (x64 off, as the flagship runs), 24 steps of
``Model(idynamic=3)`` from the same numpy state.

In this regime both packages grow a grid-scale surface-pressure mode:
the ps range widens from ~2 hPa at step 12 to ~76 hPa at step 24, with
the minimum and maximum on neighbouring points, and wmax reaches
~3.1 m/s; the port grows it without physics as well. ``REFERENCE`` pins
the JAX package's numbers at four steps (printed by ``pytest -s`` on
this file); the tests hold the JAX run to them and the port to the JAX
run step by step. ``chip_smoke.py`` holds
the port on the card to the same numbers."""
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
from ._torch_jax_child import use_suite_cache  # noqa: E402

N, KZ, STEPS = 48, 41, 24
# JAX package, float32, CPU: step -> (ps min hPa, ps max hPa, max |w| m/s)
REFERENCE = {6: (1011.3323, 1013.6910, 0.22048),
             12: (1010.3247, 1014.5790, 0.20938),
             18: (1002.8120, 1022.8336, 0.65207),
             24: (979.3270, 1055.1946, 3.13658)}


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
            float(np.abs(d["w"]).max()))


def _start():
    """The JAX package's float32 initial state (numpy), the start of every
    run."""
    from regcm_tpu.dynamics.moloch import MolochCore as JCore
    jcfg, _ = cfgs()
    with jax.enable_x64(False):
        jg = build_grid(jcfg)
        return jax.device_get(JCore(jg, jcfg, dtype=jnp.float32)
                              .initial_state(perturb=0.3, seed=1))


def _jax_side(s0):
    """The JAX package's run (float32, x64 off) in a spawned process,
    which has not read the conftest's settings: the summaries at each
    step of REFERENCE and the decoupled fields at the last step."""
    use_suite_cache()
    jax.config.update("jax_platforms", "cpu")
    from regcm_tpu.driver import Model as JModel
    jcfg, _ = cfgs()
    out = {}
    with jax.enable_x64(False):
        jm = JModel(jcfg, grid=build_grid(jcfg), dtype=jnp.float32,
                    initial_state=jax.tree_util.tree_map(jnp.asarray, s0))
        for n in range(1, STEPS + 1):
            jm.step()
            if n in REFERENCE:
                jd = {k: np.asarray(v) for k, v in jm.decoupled().items()}
                out[n] = summary(jd)
    return out, jd


@pytest.fixture(scope="module")
def runs():
    """(JAX, port, port without physics) summaries at each step of
    REFERENCE, and the decoupled fields at the last step of JAX, the port
    and the port from a 1e-7 relative change of T (its float32 roundoff
    spread). The JAX package runs in a spawned process beside the
    port."""
    from regcm_tpu_torch.driver import Model as TModel

    _, tcfg = cfgs()
    s0 = _start()
    out = {"jax": {}, "port": {}}
    # one torch thread: the test workers share the cores, and torch's
    # thread pools stall when oversubscribed at these sizes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as pool:
            job = pool.submit(_jax_side, s0)
            tg = tbuild_grid(tcfg)
            tm = TModel(tcfg, grid=tg, device="cpu", dtype=torch.float32,
                        initial_state=s0)
            rng = np.random.default_rng(0)
            t1 = np.asarray(s0.t) * (1.0 + 1e-7 * rng.standard_normal(
                np.shape(s0.t)))
            s1 = s0._replace(t=t1.astype(np.float32))
            pm = TModel(tcfg, grid=tg, device="cpu", dtype=torch.float32,
                        initial_state=s1)
            dm = TModel(tcfg, grid=tg, device="cpu", dtype=torch.float32,
                        initial_state=s0, physics=False)
            out["dyn"] = {}
            for n in range(1, STEPS + 1):
                for m in (tm, pm, dm):
                    m.step()
                if n in REFERENCE:
                    out["port"][n] = summary(tm.decoupled())
                    out["dyn"][n] = summary(dm.decoupled())
            out["jax"], jd = job.result()
    finally:
        torch.set_num_threads(threads)
    for n in sorted(REFERENCE):
        print(f"step {n}: JAX ps {out['jax'][n][0]:.4f}.."
              f"{out['jax'][n][1]:.4f} hPa wmax "
              f"{out['jax'][n][2]:.5f} m/s; port ps "
              f"{out['port'][n][0]:.4f}..{out['port'][n][1]:.4f} "
              f"hPa wmax {out['port'][n][2]:.5f} m/s; port "
              f"without physics ps {out['dyn'][n][0]:.4f}.."
              f"{out['dyn'][n][1]:.4f} hPa wmax "
              f"{out['dyn'][n][2]:.5f} m/s")
    out["fields"] = (jd, tm.decoupled(), pm.decoupled())
    out["finite"] = tm.check_finite() and pm.check_finite()
    return out


@pytest.mark.parametrize("step", sorted(REFERENCE))
def test_reference_regime(step, runs):
    """The JAX package reproduces its pinned numbers: 0.05 hPa and 1%
    of wmax, the room that float32 roundoff of another XLA build leaves
    after the mode's growth (the port, a different order of float32 ops,
    lands within 0.02 hPa and 0.1%)."""
    lo, hi, wmax = runs["jax"][step]
    rlo, rhi, rwmax = REFERENCE[step]
    assert abs(lo - rlo) < 0.05 and abs(hi - rhi) < 0.05
    assert abs(wmax - rwmax) < 0.01 * rwmax


@pytest.mark.parametrize("step", sorted(REFERENCE))
def test_port_follows_reference_mode(step, runs):
    """The port grows the same mode at the same rate: ps extremes within
    0.05 hPa and wmax within 1% of the JAX run at every checked step."""
    assert runs["finite"]
    jlo, jhi, jw = runs["jax"][step]
    lo, hi, w = runs["port"][step]
    assert abs(lo - jlo) < 0.05 and abs(hi - jhi) < 0.05
    assert abs(w - jw) < 0.01 * jw


@pytest.mark.parametrize("step", sorted(REFERENCE))
def test_mode_is_the_dynamical_cores(step, runs):
    """Without physics the port grows the same mode: ps extremes within
    0.2 hPa and wmax within 2% of the full-physics run, so the physics
    neither drives nor damps it over these 24 steps."""
    lo, hi, w = runs["port"][step]
    dlo, dhi, dw = runs["dyn"][step]
    assert abs(dlo - lo) < 0.2 and abs(dhi - hi) < 0.2
    assert abs(dw - w) < 0.02 * w


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / (np.sqrt(np.mean(want ** 2)) + 1e-30))


@pytest.mark.parametrize("field", ["ps", "t", "qv", "u", "v", "w"])
def test_port_fields_after_24_steps(field, runs):
    """Whole fields at step 24, float32: rel-RMS within four times the
    port's own spread under a 1e-7 relative change of T, since the two
    packages order their float32 operations differently and the growing
    mode amplifies that roundoff as it amplifies the change of T."""
    jd, td, pd = runs["fields"]
    spread = _rel_rms(pd[field], td[field])
    err = _rel_rms(td[field], jd[field])
    assert spread < 1e-2                   # the port's own conditioning
    assert err < 4.0 * spread, \
        f"{field}: rel-RMS {err:.3e}, roundoff spread {spread:.3e}"
