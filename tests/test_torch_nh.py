"""The MM5 non-hydrostatic core (idynamic=2) of the PyTorch port against
the JAX package, in f64 on the CPU, over the test hill at 16x20x14 (ds
10 km, dt 30 s; ``tests/_torch_nh_ranks.py`` ``NH``): the reference
atmosphere, one call of the acoustic solver with either top, ten steps
of the dynamics, three steps of ``Model`` with the default physics, the
same on 2x2 ranks, the cold start from ICBC files, and the port's twins
of the JAX package's behaviour tests of the core.

The JAX package's full-physics run and the 2x2 group (whose processes
run PyTorch's generic CPU kernels, as ``tests/test_torch_parallel.py``
explains) start with the module, in processes of their own, and run
while the other tests do."""
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from regcm_tpu.config.params import RegCMConfig  # noqa: E402
from regcm_tpu.core.grid import build_grid  # noqa: E402
from regcm_tpu_torch.config.params import RegCMConfig as TConfig  # noqa
from regcm_tpu_torch.core.grid import build_grid as tbuild_grid  # noqa
from regcm_tpu_torch.parallel import launch  # noqa: E402

from . import _torch_nh_ranks as R  # noqa: E402
from ._torch_icbc_files import write_files  # noqa: E402
from ._torch_jax_child import use_suite_cache  # noqa: E402

max_rel = R.max_rel
# the decoupled fields each comparison reads: state field, divided by p*
FIELDS = {"u": "u_a", "v": "v_a", "t": "t_a", "qv": "qx_a", "pp": "pp_a",
          "w": "w_a"}


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / (np.sqrt(np.mean(want ** 2)) + 1e-30))


def _jax_core(dyn=False, **physics):
    from regcm_tpu.dynamics.hydrostatic import HydroCore
    cfg = R.nh_cfg(RegCMConfig(), dyn=dyn, **physics)
    grid = build_grid(cfg, ht=R.nh_hill())
    return HydroCore(grid, cfg, dtype=jnp.float64)


def _jax_dyn(steps=R.NH["dyn_steps"], **physics):
    """The JAX package's step_nh on the dynamics setting (R.dyn_run's
    twin); the state fields after the last step. Also runs in spawned
    processes, which have not read the conftest's settings."""
    use_suite_cache()
    jax.config.update("jax_enable_x64", True)
    from regcm_tpu.core.state import StepFlags, bdy_from_state
    from regcm_tpu.driver import nh_initial_state
    core = _jax_core(dyn=True, **physics)
    s = nh_initial_state(core, perturb=R.NH["perturb"], seed=R.NH["seed"])
    bdy = bdy_from_state(s)
    step = jax.jit(core.step_nh, static_argnames=("flags",))
    xt, dt = 0.0, core.cfg.dtsec
    for _ in range(steps):
        s, _ = step(s, bdy, xt, dt, StepFlags())
        xt += core.cfg.dtsec
        dt = 2.0 * core.cfg.dtsec
    return {k: np.asarray(getattr(s, k)) for k in R.STATE_FIELDS}


def _jax_phys():
    """The JAX package's Model with the default physics on the NH
    setting, three steps from its nh_initial_state; the state fields and
    the alarms of each step. Runs in a spawned process, which has not
    read the conftest's settings."""
    use_suite_cache()
    jax.config.update("jax_enable_x64", True)
    from regcm_tpu.driver import Model, nh_initial_state
    core = _jax_core()
    s0 = nh_initial_state(core, perturb=R.NH["perturb"], seed=R.NH["seed"])
    m = Model(core.cfg, grid=core.grid, dtype=jnp.float64, initial_state=s0)
    flags = []
    for _ in range(R.NH["phys_steps"]):
        flags.append(m._flags())
        m.step()
    return dict(state={k: np.asarray(getattr(m.state, k))
                       for k in R.STATE_FIELDS},
                flags=flags, start=jax.device_get(s0))


@pytest.fixture(scope="module")
def background():
    """A thread for the 2x2 group (its processes run the generic CPU
    kernels) and a process for the JAX package's full-physics run."""
    cap = os.environ.get("ATEN_CPU_CAPABILITY")
    os.environ["ATEN_CPU_CAPABILITY"] = "default"
    try:
        with ThreadPoolExecutor(1) as th, ProcessPoolExecutor(
                1, mp_context=mp.get_context("spawn")) as pr:
            yield th, pr
    finally:
        if cap is None:
            os.environ.pop("ATEN_CPU_CAPABILITY", None)
        else:
            os.environ["ATEN_CPU_CAPABILITY"] = cap


@pytest.fixture(scope="module")
def group22_started(background):
    return background[0].submit(launch.spawn, R.two_by_two, 2, 2, "gloo",
                                "cpu", timeout=600)


@pytest.fixture(scope="module")
def jax_phys_started(background):
    return background[1].submit(_jax_phys)


@pytest.fixture(scope="module", autouse=True)
def _start_in_background(group22_started, jax_phys_started):
    """Start the 2x2 group and the JAX full-physics run with the module;
    this process's torch on one thread beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def group22(group22_started):
    return group22_started.result()


@pytest.fixture(scope="module")
def jax_phys(jax_phys_started):
    return jax_phys_started.result()


# -- the reference atmosphere, the start, the acoustic solver ------------
def test_base_state_matches_jax():
    """make_base_state over the hill: every field within 1e-13."""
    from regcm_tpu_torch.dynamics.sound import make_base_state
    core = _jax_core()
    tcfg = R.nh_cfg(TConfig())
    got = make_base_state(tbuild_grid(tcfg, ht=R.nh_hill()), core.ptop,
                          logp_lrate=tcfg.nonhydro.logp_lrate)
    for name in got._fields:
        want = np.asarray(getattr(core.base, name))
        assert max_rel(getattr(got, name), want) <= 1e-13, name
    assert np.ptp(got.ps0) > 5.0        # the hill shapes the base p*


def test_nh_initial_state_matches_jax():
    """The port's nh_initial_state equals the JAX package's (one shared
    pfwsat polynomial, numpy arithmetic): 1e-14."""
    from regcm_tpu.driver import nh_initial_state as jstate
    from regcm_tpu_torch.driver import nh_initial_state
    core = _jax_core()
    js = jax.device_get(jstate(core, perturb=0.3, seed=7))
    tcfg = R.nh_cfg(TConfig())
    ts = nh_initial_state(tbuild_grid(tcfg, ht=R.nh_hill()), tcfg, "cpu",
                          perturb=0.3, seed=7)
    for name in js._fields:
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=1e-14, atol=0, err_msg=name)


def _sound_inputs(core):
    """A NH state with winds, pp and w, and long-step tendencies, drawn
    from a seed (coupled, as step_nh hands them to the solver)."""
    from regcm_tpu.driver import nh_initial_state
    s = jax.device_get(nh_initial_state(core, perturb=0.3, seed=3))
    rng = np.random.default_rng(5)
    kz, iy, jx = np.shape(s.t_a)
    ps = np.asarray(s.ps_a)
    cpl = ps[None]
    n = lambda *sh: rng.standard_normal(sh)
    s = s._replace(u_b=(6.0 + n(kz, iy, jx)) * cpl,
                   v_b=(-3.0 + n(kz, iy, jx)) * cpl,
                   pp_b=20.0 * n(kz, iy, jx) * cpl,
                   w_b=0.2 * n(kz + 1, iy, jx) * cpl)
    tens = (1e-3 * n(kz, iy, jx) * cpl, 1e-3 * n(kz, iy, jx) * cpl,
            0.05 * n(kz, iy, jx) * cpl, 1e-3 * n(kz + 1, iy, jx) * cpl)
    tdec_b = np.asarray(s.t_b) / ps[None]
    qv_b = np.asarray(s.qx_b[0]) / ps[None]
    return s, tens, tdec_b, qv_b


@pytest.mark.parametrize("ifupr", [0, 1])
def test_sound_matches_jax(ifupr):
    """One call of the acoustic solver (leapfrog dt 60 s, 4 substeps)
    with the rigid lid and with the radiative top: u, v, pp, w and both
    T levels within 1e-12."""
    from regcm_tpu.dynamics.sound import sound as jsound
    from regcm_tpu_torch.core.state import state_from_numpy
    from regcm_tpu_torch.dynamics.hydrostatic import HydroCore as TCore
    from regcm_tpu_torch.dynamics.sound import sound
    core = _jax_core()
    core.cfg.nonhydro.ifupr = ifupr
    s, tens, tdec_b, qv_b = _sound_inputs(core)
    dt = 2.0 * core.cfg.dtsec
    want = jax.jit(lambda *a: jsound(core, core.base, *a, dt))(
        jax.tree_util.tree_map(jnp.asarray, s), *map(jnp.asarray, tens),
        jnp.asarray(tdec_b), jnp.asarray(qv_b))
    tcfg = R.nh_cfg(TConfig())
    tcfg.nonhydro.ifupr = ifupr
    tcore = TCore(tbuild_grid(tcfg, ht=R.nh_hill()), tcfg, device="cpu")
    T = torch.as_tensor
    got = sound(tcore, tcore.base, state_from_numpy(s, "cpu"),
                *map(T, tens), T(tdec_b), T(qv_b), dt)
    for name, g, w in zip(("u", "v", "pp", "w", "t_a", "t_b"), got, want):
        assert max_rel(g.numpy(), np.asarray(w)) <= 1e-12, name
    w_top = got[3][0].numpy()
    assert (np.abs(w_top).max() > 0.0) == (ifupr == 1)


# -- the dynamics, ten steps ----------------------------------------------
@pytest.fixture(scope="module")
def dyn_runs():
    return dict(jax=_jax_dyn(), port=R.dyn_run())


@pytest.mark.parametrize("field", list(FIELDS))
def test_step_nh_dynamics_matches_jax(field, dyn_runs):
    """step_nh without physics and without the saturation adjustment,
    ten steps over the hill with the radiative top: 1e-10 relative
    (measured ~1e-13)."""
    name = FIELDS[field]
    got, want = dyn_runs["port"][name], dyn_runs["jax"][name]
    if field == "qv":
        got, want = got[0], want[0]
    assert np.all(np.isfinite(got))
    assert max_rel(got, want) <= 1e-10
    assert np.abs(dyn_runs["port"]["w_a"]).max() > 0.0


# -- 2x2 ranks ------------------------------------------------------------
@pytest.mark.parametrize("kind", ["dyn", "phys"])
def test_nh_mesh_matches_single_rank(kind, group22):
    """The NH core on 2x2 ranks (8x10 blocks; the radiative top's sums
    and window over the whole domain) against one rank, every state
    field: 1e-12 relative (measured: bit-identical); every rank
    exchanged halos and read the whole domain's diagnostics."""
    want = group22[0]["single"][kind]
    got = group22[0][kind]
    for name in R.STATE_FIELDS:
        err = max_rel(got[name], want[name])
        assert err <= 1e-12, f"{kind} {name}: {err:.3e}"
    if kind == "phys":
        assert got["finite"]
    else:
        assert all(r["exchanges"] > 0 for r in group22)
        for r in group22:
            assert r["dyn"]["diags"] == want["diags"]


# -- the cold start from ICBC files ----------------------------------------
def test_init_from_icbc_nh_matches_jax(tmp_path):
    """Model.init_from_icbc with idynamic=2 on the hydrostatic ICBC
    setting's DOMAIN and ICBC files: the state and the first boundary
    pair within 1e-12 of the JAX package (which takes the record's p* for
    the base state's and keeps pp = w = 0)."""
    from regcm_tpu.driver import Model as JModel
    from regcm_tpu.preproc.icbc import ICBCReader as JReader
    from regcm_tpu.preproc.terrain import build_grid_from_domain as jgrid
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    from regcm_tpu_torch.preproc.terrain import build_grid_from_domain
    from . import _torch_parallel_ranks as P
    paths = write_files("hydro", str(tmp_path))
    out = {}
    for pkg, cfg_cls in (("jax", RegCMConfig), ("port", TConfig)):
        cfg = P.icbc_setup(cfg_cls(), "hydro")
        cfg.core.idynamic = 2
        if pkg == "jax":
            m = JModel(cfg, grid=jgrid(cfg, paths["domain"]),
                       dtype=jnp.float64)
            m.init_from_icbc(JReader(paths["icbc"], cfg.globdat.calendar))
        else:
            m = Model(cfg, grid=build_grid_from_domain(cfg, paths["domain"]),
                      device="cpu")
            m.init_from_icbc(ICBCReader(paths["icbc"], cfg.globdat.calendar))
        fields = {k: np.asarray(v) for nt in (m.state, m.bdy)
                  for k, v in nt._asdict().items() if v is not None}
        out[pkg] = {k: v for k, v in fields.items() if v.size}
    assert set(out["port"]) == set(out["jax"])
    for k, want in out["jax"].items():
        assert max_rel(out["port"][k], want) <= 1e-12, k
    assert not np.any(out["port"]["pp_a"]) and not np.any(out["port"]["w_a"])


# -- the port's twins of the JAX package's behaviour tests -----------------
def _port_nh(iy=24, jx=32, ds=10.0, dt=30.0, kz=None, **extras):
    """The port's NH Model without physics on RegCMConfig() (test_001's
    vertical grid) at the JAX tests' sizes."""
    from regcm_tpu_torch.driver import Model
    cfg = TConfig()
    cfg.core.idynamic = 2
    cfg.dim.iy, cfg.dim.jx = iy, jx
    if kz is not None:
        cfg.dim.kz = kz
    cfg.geo.ds = ds
    cfg.time.dt = dt
    for k, v in extras.items():
        if k == "ifupr":
            cfg.nonhydro.ifupr = v
        else:
            cfg.dyn.extras[k] = v
    return Model(cfg, device="cpu", physics=False)


def _start(m, perturb, seed):
    from regcm_tpu_torch.driver import nh_initial_state
    return nh_initial_state(m.grid, m.cfg, "cpu", perturb=perturb,
                            seed=seed)


def test_nh_core_stable():
    """tests/test_hydrostatic.py::test_nh_core_stable's twin: a 0.5 K
    perturbation of the rest state stays bounded under the
    semi-implicit acoustic solver for 20 steps."""
    m = _port_nh()
    m.state = _start(m, 0.5, 5)
    for _ in range(20):
        d = m.step()
    assert m.check_finite()
    assert float(d["wmax"]) < 5.0
    assert float(d["ppmax"]) < 500.0


def test_nh_rayleigh_damping():
    """tests/test_hydrostatic.py::test_nh_rayleigh_damping's twin: a
    top-level wind anomaly decays faster with the damper on."""
    res = {}
    for ifrayd in (0, 1):
        m = _port_nh(ifrayd=ifrayd)
        u = m.state.u_a.clone()
        u[:3] += 5.0 * m.state.ps_a[None]
        m.state = m.state._replace(u_a=u, u_b=u)
        for _ in range(25):
            m.step()
        assert m.check_finite()
        ua = (m.state.u_a / m.state.ps_a[None]).numpy()
        res[ifrayd] = float(np.abs(ua[:3, 2:-2, 2:-2]).max())
    assert res[1] < res[0]


def test_ifupr_radiative_top():
    """tests/test_core_options.py::test_ifupr_radiative_top's twin: the
    radiative top's w is nonzero and the run stable; the rigid lid keeps
    w(top) = 0; the trajectories differ below the top too."""
    runs = {}
    for ifupr in (1, 0):
        from regcm_tpu_torch.core.state import bdy_from_state
        m = _port_nh(16, 20, 30.0, 90.0, kz=14, ifupr=ifupr)
        m.state = _start(m, 0.3, 0)
        m.bdy = bdy_from_state(m.state)
        for _ in range(6):
            m.step()
        assert m.check_finite()
        runs[ifupr] = m.state.w_a.numpy()
    assert np.abs(runs[0][0]).max() == 0.0
    assert np.abs(runs[1][0]).max() > 0.0
    assert np.abs(runs[1] - runs[0]).max() > 0.0


# -- Model with the default physics, three steps (last: the JAX package's
# run started with the module) ------------------------------------------
@pytest.fixture(scope="module")
def phys_runs(jax_phys):
    """The port's Model from the JAX run's start, and from that start
    with T changed by 1e-15 relative (the trajectory's roundoff spread),
    counting the plain K1/K2 calls of the first run."""
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    from regcm_tpu_torch.kernels import pbl_tridiag as k1
    s0 = jax_phys["start"]
    calls = {"K1": 0, "K2": 0}
    plain = (k1.pbl_tridiag_plain, k2.emanuel_mixing_plain)

    def counted(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    k1.launches = k2.launches = 0
    k1.pbl_tridiag_plain = counted("K1", plain[0])
    k2.emanuel_mixing_plain = counted("K2", plain[1])
    try:
        port = R.phys_run(initial_state=s0)
    finally:
        k1.pbl_tridiag_plain, k2.emanuel_mixing_plain = plain
    rng = np.random.default_rng(0)
    s1 = s0._replace(t_a=np.asarray(s0.t_a) * (
        1.0 + 1e-15 * rng.standard_normal(np.shape(s0.t_a))))
    return dict(port=port, spread=R.phys_run(initial_state=s1),
                calls=calls, launches=(k1.launches, k2.launches))


def test_model_nh_runs_every_alarm_through_k1_k2(jax_phys, phys_runs):
    """Step 0 runs radiation, surface and cumulus; on the CPU the K1 and
    K2 wrappers take their plain versions (the counters of kernel
    launches stay 0)."""
    f = jax_phys["flags"]
    assert f[0].do_rad and f[0].do_srf and f[0].do_cum and f[0].do_abem
    assert not any(x.do_rad for x in f[1:])
    assert phys_runs["port"]["finite"]
    assert phys_runs["calls"]["K1"] >= R.NH["phys_steps"]
    assert phys_runs["calls"]["K2"] >= 1
    assert phys_runs["launches"] == (0, 0)


@pytest.mark.parametrize("field", list(FIELDS))
def test_model_nh_matches_jax(field, jax_phys, phys_runs):
    """Three full-physics steps: rel-RMS below 1e-7, or four times the
    port's measured roundoff spread where that is larger (PERF.md §2;
    the saturation adjustment's threshold branches amplify roundoff)."""
    name = FIELDS[field]
    got = phys_runs["port"][name]
    want = jax_phys["state"][name]
    spr = phys_runs["spread"][name]
    if field == "qv":
        got, want, spr = got[0], want[0], spr[0]
    spread = _rel_rms(spr, got)
    assert spread < 1e-6
    err = _rel_rms(got, want)
    assert err < max(1e-7, 4.0 * spread), \
        f"{field}: rel-RMS {err:.3e}, roundoff spread {spread:.3e}"


def test_nh_mesh_matches_jax(group22, dyn_runs, jax_phys):
    """The 2x2 runs against the JAX package: the dynamics 1e-9 in every
    field, the full physics by the rule of test_model_nh_matches_jax."""
    for name in R.STATE_FIELDS:
        err = max_rel(group22[0]["dyn"][name], dyn_runs["jax"][name])
        assert err <= 1e-9, f"dynamics {name}: {err:.3e}"
    for field, name in FIELDS.items():
        got = group22[0]["phys"][name]
        want = jax_phys["state"][name]
        if field == "qv":
            got, want = got[0], want[0]
        assert _rel_rms(got, want) < 1e-7, field
