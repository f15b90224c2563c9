"""The whole PyTorch model against the JAX package: ``Model`` at the
golden setup (16×20×14, ds 60 km, dt 150 s, f64, 10 steps), built from
``RegCMConfig()`` plus overrides, from the same numpy initial state. The
JAX package's trajectories run in two spawned processes started with the
module."""
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

NSTEPS = 10
FIELDS = ("ps", "t", "qv", "u", "v")


def golden_cfgs(conf=None):
    """(JAX config, port config): RegCMConfig() of each package with the
    same overrides."""
    out = []
    for cls in (RegCMConfig, TConfig):
        cfg = cls()
        cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 16, 20, 14
        cfg.geo.ds = 60.0
        cfg.time.dt = 150.0
        if conf is not None:
            cfg.subex.conf = conf
        out.append(cfg)
    return tuple(out)


def _rel_rms(got, want):
    rms = float(np.sqrt(np.mean((got - want) ** 2)))
    return rms / (float(np.sqrt(np.mean(want ** 2))) + 1e-30)


def _start(conf):
    """The JAX package's golden initial state (numpy)."""
    from regcm_tpu.driver import standard_atmosphere_state as jstate
    jcfg, _ = golden_cfgs(conf)
    return jax.device_get(jstate(build_grid(jcfg), jcfg, jnp.float64,
                                 perturb=0.3, seed=2024))


def _jax_trajectory(conf, s0):
    """The JAX package's Model for NSTEPS steps from ``s0`` (a compile for
    each alarm pattern): the decoupled fields after the first and the
    last step. Runs in a spawned process, which has not read the
    conftest's settings."""
    use_suite_cache()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from regcm_tpu.driver import Model as JModel
    jcfg, _ = golden_cfgs(conf)
    jm = JModel(jcfg, grid=build_grid(jcfg), dtype=jnp.float64,
                initial_state=s0)
    out = {}
    for n in range(NSTEPS):
        jm.step()
        if n in (0, NSTEPS - 1):
            out[n + 1] = {k: np.asarray(v) for k, v in jm.decoupled().items()}
    return out


@pytest.fixture(scope="module", autouse=True)
def jax_started():
    """The JAX package's two trajectories (default and conf=0), in two
    spawned processes started with the module, beside the other tests."""
    starts = {conf: _start(conf) for conf in (None, 0.0)}
    with ProcessPoolExecutor(2, mp_context=mp.get_context("spawn")) as pool:
        yield {conf: (s0, pool.submit(_jax_trajectory, conf, s0))
               for conf, s0 in starts.items()}


@pytest.fixture(scope="module")
def trajectories(jax_started):
    """One 10-step trajectory of each package from the same numpy state
    (the JAX side compiles four step variants, one per alarm pattern:
    run it once), plus the port from that state with a 1e-15 relative
    perturbation of T, which measures the trajectory's roundoff spread."""
    from regcm_tpu_torch.driver import Model as TModel

    _, tcfg = golden_cfgs()
    tgrid = tbuild_grid(tcfg)
    s0, job = jax_started[None]
    rng = np.random.default_rng(0)
    s1 = s0._replace(t_a=np.asarray(s0.t_a) * (
        1.0 + 1e-15 * rng.standard_normal(np.shape(s0.t_a))))
    tm = TModel(tcfg, grid=tgrid, device="cpu", dtype=torch.float64,
                initial_state=s0)
    pm = TModel(tcfg, grid=tgrid, device="cpu", dtype=torch.float64,
                initial_state=s1)
    flags, out = [], {}
    for n in range(NSTEPS):
        flags.append(tm._flags())
        tm.step()
        pm.step()
        if n in (0, NSTEPS - 1):
            out[n + 1] = (tm.decoupled(), pm.decoupled())
    jd = job.result()
    out = {n: (jd[n],) + v for n, v in out.items()}
    return dict(steps=out, flags=flags, finite=tm.check_finite())


def test_trajectory_covers_every_alarm(trajectories):
    fl = trajectories["flags"]
    assert fl[0].do_rad and fl[0].do_abem and fl[0].do_srf
    assert sum(f.do_cum for f in fl) == 5          # dtcum 300 s
    assert sum(f.do_srf for f in fl) == 3          # dtsrf 600 s
    assert not any(f.do_rad for f in fl[1:])       # dtrad 30 min
    assert trajectories["finite"]


@pytest.mark.parametrize("field", FIELDS)
def test_first_step_matches_jax(field, trajectories):
    """Step 1 runs every scheme (cumulus, microphysics, radiation with
    the absorptivity build, surface, PBL): 1e-10 covers the reordered
    sums before any threshold branch can flip."""
    jd, td, _ = trajectories["steps"][1]
    assert _rel_rms(td[field], jd[field]) < 1e-10


@pytest.mark.parametrize("field", FIELDS)
def test_golden_trajectory_matches_jax(field, trajectories):
    """After ten steps: the golden gate of tests/test_parity.py
    (rel-RMS < 1e-7), or four times the trajectory's own roundoff
    spread where that is larger. From the rest state a 1e-15 relative
    change of T moves u and v by ~4e-7 rel-RMS in ten steps (threshold
    branches such as the extrema guard, the negative-water fix and the
    BATS free-convection wind flip on roundoff-level values; the JAX
    package's jitted and eager BATS already differ by 1.8e-7 in the
    step-1 drag on identical inputs), so no implementation that does
    not reproduce XLA's arithmetic bit for bit meets 1e-7 on u and v."""
    jd, td, pd = trajectories["steps"][NSTEPS]
    spread = _rel_rms(pd[field], td[field])
    assert spread < 1e-6                 # the port's own conditioning
    err = _rel_rms(td[field], jd[field])
    assert err < max(1e-7, 4.0 * spread), \
        f"{field}: rel-RMS {err:.3e}, roundoff spread {spread:.3e}"


@pytest.fixture(scope="module")
def dry_trajectories(jax_started):
    """Both packages for 10 steps from the golden state with the SUBEX
    saturation adjustment switched off (subexparam conf=0): no cloud
    water forms, so no threshold branch acts on roundoff-level values."""
    from regcm_tpu_torch.driver import Model as TModel

    _, tcfg = golden_cfgs(conf=0.0)
    s0, job = jax_started[0.0]
    tm = TModel(tcfg, grid=tbuild_grid(tcfg), device="cpu",
                dtype=torch.float64, initial_state=s0)
    for _ in range(NSTEPS):
        tm.step()
    return job.result()[NSTEPS], tm.decoupled()


@pytest.mark.parametrize("field", FIELDS)
def test_trajectory_without_condensation_matches_jax(field,
                                                     dry_trajectories):
    """Well conditioned, the full-physics trajectory agrees far inside
    the golden gate (measured ~2e-11 rel-RMS in u and v): 1e-9 leaves
    room for summation-order differences between hosts."""
    jd, td = dry_trajectories
    assert float(np.max(td["qc"])) == 0.0
    assert _rel_rms(td[field], jd[field]) < 1e-9


def test_standard_atmosphere_state_matches_jax():
    from regcm_tpu.driver import standard_atmosphere_state as jstate
    from regcm_tpu_torch.driver import standard_atmosphere_state as tstate

    jcfg, tcfg = golden_cfgs()
    js = jax.device_get(jstate(build_grid(jcfg), jcfg, jnp.float64,
                               perturb=0.3, seed=7))
    ts = tstate(tbuild_grid(tcfg), tcfg, device="cpu", dtype=torch.float64,
                perturb=0.3, seed=7)
    for name in js._fields:
        # identical numpy arithmetic, one shared pfwsat polynomial
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=1e-14, atol=0, err_msg=name)


def test_model_refuses_unported_options():
    """Every option the port leaves out, or the JAX package refuses,
    raises at model build: Kuo over land beside Emanuel over water (Kuo
    is never mixed), RRTMG (irrtm=1, item 15), chemistry on the NH core
    and without a chemsimtype (the JAX package's refusals), the UW TCM, a
    periodic domain and the subgrid surface on MOLOCH. The gas-phase
    chemistry (CBMZ) and Tiedtke's tracer transport (DUST with Tiedtke
    over land), refused until they were ported, build and step; a rank's
    core of a decomposed run takes the gas phase's 37 tracers and the
    semi-Lagrangian advection (ROADMAP item 10e)."""
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.parallel.mesh import DomainMesh

    for overrides in ((("core", "idynamic", 4),),
                      (("physics", "icup_lnd", 1),),
                      (("physics", "irrtm", 1),),
                      (("physics", "ibltyp", 2), ("core", "idynamic", 3)),
                      (("geo", "i_band", 1), ("core", "idynamic", 3)),
                      (("geo", "i_crm", 1), ("core", "idynamic", 3)),
                      (("physics", "ichem", 1),),
                      (("physics", "ichem", 1), ("chem", "chemsimtype",
                                                 "DUST"),
                       ("core", "idynamic", 2)),
                      (("physics", "idiffu", 4),),
                      (("physics", "iboudy", 6),),
                      (("dim", "nsg", 2), ("core", "idynamic", 3))):
        _, cfg = golden_cfgs()
        for section, name, val in overrides:
            setattr(getattr(cfg, section), name, val)
        with pytest.raises((ValueError, NotImplementedError)):
            Model(cfg, device="cpu")
    for overrides in ((("chem", "chemsimtype", "CBMZ"),),
                      (("chem", "chemsimtype", "DUST"),
                       ("physics", "icup_lnd", 5))):
        _, cfg = golden_cfgs()
        cfg.dim.iy, cfg.dim.jx = 8, 10      # a step of the gas solver
        cfg.physics.ichem = 1
        for section, name, val in overrides:
            setattr(getattr(cfg, section), name, val)
        m = Model(cfg, device="cpu")
        m.step()
        assert m.check_finite()
    from regcm_tpu_torch.dynamics.hydrostatic import HydroCore
    _, cfg = golden_cfgs()
    mesh = DomainMesh(2, 2, cfg.dim.iy, cfg.dim.jx, rank=0)
    cfg.physics.ichem = 1
    cfg.chem.chemsimtype = "CBMZ"
    core = HydroCore(tbuild_grid(cfg), cfg, device="cpu", mesh=mesh,
                     physics=None)
    assert core.ntr == 37 and core.mesh is mesh
    _, cfg = golden_cfgs()
    cfg.physics.isladvec = 1
    core = HydroCore(tbuild_grid(cfg), cfg, device="cpu", mesh=mesh,
                     physics=None)
    assert core.isladvec == 1 and core.mesh is mesh


def test_state_round_trip_through_numpy():
    from regcm_tpu.driver import standard_atmosphere_state as jstate
    from regcm_tpu_torch.core.state import state_from_numpy, state_to_numpy

    jcfg, _ = golden_cfgs()
    js = jax.device_get(jstate(build_grid(jcfg), jcfg, jnp.float64,
                               perturb=0.3, seed=3))
    back = state_to_numpy(state_from_numpy(js, device="cpu"))
    assert set(back) == set(js._fields)
    for name in js._fields:
        np.testing.assert_array_equal(back[name],
                                      np.asarray(getattr(js, name)))


def test_entry_points_run_on_the_card_unless_asked():
    """With no device argument every entry point puts its tensors on the
    CUDA card; on a host without one it raises and says to pass
    device="cpu", which runs."""
    from regcm_tpu_torch.core.state import zeros_hydro
    from regcm_tpu_torch.driver import Model, standard_atmosphere_state
    from regcm_tpu_torch.dynamics.hydrostatic import HydroCore
    from regcm_tpu_torch.dynamics.moloch import MolochCore
    from regcm_tpu_torch.physics.suite import PhysicsSuite

    _, cfg = golden_cfgs()
    _, mcfg = golden_cfgs()
    mcfg.core.idynamic = 3
    grid, mgrid = tbuild_grid(cfg), tbuild_grid(mcfg)
    builds = [lambda: Model(cfg).state.t_a,
              lambda: Model(mcfg).state.t,
              lambda: HydroCore(grid, cfg).msfx,
              lambda: MolochCore(mgrid, mcfg).fmz,
              lambda: PhysicsSuite(cfg, grid).xlat,
              lambda: standard_atmosphere_state(grid, cfg).t_a,
              lambda: zeros_hydro(14, 16, 20).t_a]
    for build in builds:
        if torch.cuda.is_available():
            assert build().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                build()
    m = Model(mcfg, device="cpu")
    m.step()
    assert m.state.t.device.type == "cpu" and m.check_finite()
