"""The port's observability helpers (``regcm_tpu_torch.utils.service``):
the twins of ``tests/test_service.py`` on configurations rebuilt from
``RegCMConfig()`` (test_001 cut to 16x24, dynamics only, from the 0.2 K
perturbed rest state), the mass budget against the JAX package's on the
same state, and the profiler's trace."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from regcm_tpu_torch.utils.service import (MassTracker,  # noqa: E402
                                           StepProfiler, mass_budget,
                                           watchdog)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: the runs here are small, and the other test
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model, standard_atmosphere_state
    cfg = RegCMConfig()
    cfg.dim.iy, cfg.dim.jx = 16, 24
    grid = build_grid(cfg)
    s = standard_atmosphere_state(grid, cfg, "cpu", perturb=0.2, seed=4)
    return Model(cfg, grid=grid, device="cpu", initial_state=s,
                 physics=False)


def test_profiler_sections(model):
    prof = StepProfiler()
    with prof.section("step"):
        model.step()
    with prof.section("step"):
        model.step()
    rep = prof.report()
    assert "step" in rep
    assert prof.counts["step"] == 2
    assert prof.totals["step"] > 0.0


def test_profiler_trace_records_the_sections(model, tmp_path):
    """``trace`` writes a torch.profiler trace of its scope, in which a
    section is a named range."""
    prof = StepProfiler()
    with prof.trace(str(tmp_path)):
        with prof.section("traced_step"):
            model.step()
    path = tmp_path / "trace.json"
    assert path.exists() and "traced_step" in path.read_text()


def test_mass_tracker(model):
    mt = MassTracker(model)
    for _ in range(10):
        model.step()
    d = mt.drift()
    # dry mass conserved to high accuracy with fixed boundaries
    assert abs(d["dry_rel"]) < 1e-4
    assert abs(d["water_rel"]) < 1e-2


def test_mass_budget_matches_jax(model):
    """The device sums equal the JAX package's mass_budget on the same
    state, 1e-12 relative."""
    from regcm_tpu.utils.service import mass_budget as jbudget
    from regcm_tpu.core.state import HydroState
    s = model.state
    js = HydroState(**{k: jnp.asarray(getattr(s, k).numpy())
                       for k in HydroState._fields})
    got = mass_budget(s, model.grid, model.grid.dsigma)
    want = jbudget(js, model.grid, model.grid.dsigma)
    for k in ("dry", "water"):
        assert abs(float(got[k]) / float(want[k]) - 1.0) <= 1e-12, k


def test_watchdog_passes_and_raises(model):
    pmax, pmin = watchdog(model)
    assert 20.0 < pmin <= pmax < 200.0
    # poison the state: must raise (the reference's fatal)
    ps = model.state.ps_a.clone()
    ps[5, 5] = float("nan")

    class Dummy:
        pass
    dm = Dummy()
    dm.state = model.state._replace(ps_a=ps)
    dm.grid = model.grid
    with pytest.raises(FloatingPointError):
        watchdog(dm)
    dm.state = model.state._replace(ps_a=model.state.ps_a * 3.0)
    with pytest.raises(FloatingPointError, match="physical range"):
        watchdog(dm)
