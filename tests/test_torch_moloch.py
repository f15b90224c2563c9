"""The MOLOCH core (idynamic=3) of the PyTorch port against the JAX
package, in f64 on the CPU: the core's constants, the initial state, each
method of the step on the same numpy inputs, a dynamics-only trajectory
and the whole model (``Model`` with the default physics), on a 16×20×14
grid (ds 10 km, dt 60 s) over a seeded Gaussian hill of ~800 m, so that
the terrain slopes and metric terms are not zero. The JAX package's
whole-model runs go in two spawned processes started with the module."""
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from regcm_tpu.config.params import RegCMConfig  # noqa: E402
from regcm_tpu.core.grid import build_grid  # noqa: E402
from regcm_tpu.dynamics import moloch as jmo  # noqa: E402
from regcm_tpu.utils import constants as c  # noqa: E402
from regcm_tpu_torch.config.params import RegCMConfig as TConfig  # noqa
from regcm_tpu_torch.core.grid import build_grid as tbuild_grid  # noqa
from regcm_tpu_torch.dynamics import moloch as tmo  # noqa: E402
from ._torch_jax_child import use_suite_cache  # noqa: E402

IY, JX, KZ = 16, 20, 14
TRAJ_FIELDS = ("ps", "t", "qv", "u", "v", "w")


def moloch_cfgs(conf=None):
    """(JAX config, port config): RegCMConfig() of each package with the
    same MOLOCH overrides."""
    out = []
    for cls in (RegCMConfig, TConfig):
        cfg = cls()
        cfg.core.idynamic = 3
        cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = IY, JX, KZ
        cfg.geo.ds = 10.0
        cfg.time.dt = 60.0
        if conf is not None:
            cfg.subex.conf = conf
        out.append(cfg)
    return tuple(out)


def hill(seed=5):
    """Seeded Gaussian hill, ~800 m, on the (iy-1, jx-1) cross grid."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(IY - 1), np.arange(JX - 1),
                         indexing="ij")
    return 800.0 * np.exp(-(((yy - 7.0) / 3.5) ** 2
                            + ((xx - 9.0) / 4.0) ** 2)) \
        + 20.0 * rng.random((IY - 1, JX - 1))


def grids(jcfg, tcfg):
    ht = hill()
    return build_grid(jcfg, ht=ht), tbuild_grid(tcfg, ht=ht)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / (np.sqrt(np.mean(want ** 2)) + 1e-30))


@pytest.fixture(scope="module")
def cores():
    jcfg, tcfg = moloch_cfgs()
    jg, tg = grids(jcfg, tcfg)
    jc = jmo.MolochCore(jg, jcfg, dtype=jnp.float64)
    tc = tmo.MolochCore(tg, tcfg, device="cpu", dtype=torch.float64)
    s0 = jax.device_get(jc.initial_state(perturb=0.3, seed=1))
    return jc, tc, s0


CONSTANTS = ["fmz", "fmzf", "zeta", "zetaf", "ffilt", "gzitak", "gzitakh",
             "hx", "hy", "coriou", "coriov", "raytau", "raytau_u",
             "raytau_v", "m_u", "m_v", "m_ci", "nfc", "ngc", "mx2", "rmu",
             "rmv", "mu", "mv", "qck1", "rh0"]


@pytest.mark.parametrize("name", CONSTANTS)
def test_core_constant_matches_jax(name, cores):
    """The same numpy expressions on the same grid: 1e-14 relative."""
    jc, tc, _ = cores
    assert _rel(getattr(tc, name).numpy(), getattr(jc, name)) <= 1e-14
    assert float(np.max(np.abs(np.asarray(jc.hx)))) > 1e-3   # real slopes


def test_initial_state_matches_jax(cores):
    """Numpy on both sides, one pfwsat polynomial: 1e-13 relative."""
    jc, tc, s0 = cores
    ts = tc.initial_state(perturb=0.3, seed=1)
    assert ts._fields == s0._fields
    for name in s0._fields:
        want = np.asarray(getattr(s0, name))
        got = getattr(ts, name).numpy()
        assert got.shape == want.shape, name
        if want.size and np.max(np.abs(want)) > 0:
            assert _rel(got, want) <= 1e-13, name
        else:
            assert np.array_equal(got, want), name


def test_state_round_trip_through_numpy(cores):
    _, _, s0 = cores
    ts = tmo.moloch_state_from_numpy(s0, device="cpu")
    back = tmo.moloch_state_to_numpy(ts)
    for name in s0._fields:
        np.testing.assert_array_equal(back[name], np.asarray(getattr(s0,
                                                                     name)))


def _method_inputs(jc, s0, seed=3):
    """Winds and perturbations of realistic size on the balanced state."""
    rng = np.random.default_rng(seed)
    kz, iy, jx = jc.kz, jc.iy, jc.jx
    n = lambda *s: rng.normal(size=s)
    t = np.asarray(s0.t)
    pai = np.asarray(s0.pai)
    qx = np.asarray(s0.qx).copy()
    qx[1] = np.abs(2e-5 * n(kz, iy, jx))
    qv = np.maximum(qx[0], c.minqq)
    return dict(
        u=8.0 + 2.0 * n(kz, iy, jx), v=-5.0 + 2.0 * n(kz, iy, jx),
        w=0.05 * n(kz + 1, iy, jx), pai=pai, t=t, qx=qx,
        tetav=t * (1.0 + c.ep1 * qv - qx[1]) / pai,
        s=0.01 * n(kz + 1, iy, jx),
        fields=np.concatenate([t[None], pai[None], 5.0 * n(2, kz, iy, jx),
                               qx]),
        tten=1e-4 * n(kz, iy, jx), qxten=1e-7 * n(2, kz, iy, jx),
        cldfra=np.clip(0.3 + 0.3 * n(kz, iy, jx), 0.0, 0.9),
        diff=n(kz, iy, jx))


def _method(name, jc, tc, s0):
    """(jax result, port result) of one MolochCore method, flattened."""
    d = _method_inputs(jc, s0)
    J = lambda a: jnp.asarray(a)
    T = lambda a: torch.as_tensor(np.array(a))
    flat_j = lambda xs: np.concatenate([np.ravel(np.asarray(x)) for x in xs])
    flat_t = lambda xs: np.concatenate([x.reshape(-1).numpy() for x in xs])
    if name == "sound":
        dts = jc.dtsec / jc.nadv / jc.nsound
        args = (d["u"], d["v"], d["w"], d["pai"], d["tetav"], d["qx"][0],
                d["qx"][0])
        return (flat_j(jc._sound(*map(J, args), dts)),
                flat_t(tc._sound(*map(T, args), dts)))
    if name == "wafone":
        args = (d["fields"], d["u"], d["v"], d["s"])
        dta = jc.dtsec / jc.nadv
        want = jax.vmap(lambda f: jc._wafone(f, *map(J, args[1:]), dta))(
            J(args[0]))
        return np.asarray(want), tc._wafone(*map(T, args), dta).numpy()
    if name == "mkslice":
        args = (d["t"], d["pai"], d["qx"], d["u"], d["v"], d["w"])
        a = jc.mkslice(*map(J, args))
        b = tc.mkslice(*map(T, args))
        assert set(a) == set(b)
        keys = sorted(a)
        return flat_j([a[k] for k in keys]), flat_t([b[k] for k in keys])
    if name == "condtq":
        p = d["pai"] ** c.cpovr * c.stdp
        qx = d["qx"].copy()
        qx[0] = qx[0] * 1.3                 # supersaturate some cells
        args = (d["t"], qx, p, d["tten"], d["qxten"], d["cldfra"])
        return (flat_j(jc._condtq(*map(J, args), 60.0)),
                flat_t(tc._condtq(*map(T, args), 60.0)))
    if name == "nudge":
        return np.asarray(jc._nudge(J(d["diff"]))), \
            tc._nudge(T(d["diff"])).numpy()
    if name == "stagger":
        args = (d["u"], d["v"])
        a = jc.uvstag2x(*map(J, args)) + jc.x2uvstag(*map(J, args)) \
            + (jc.wstag2x(J(d["w"])),
               jc.x2wstag(J(d["w"][1:]), J(d["w"]))) \
            + jc.couple_uvten(*map(J, args), None)
        b = tc.uvstag2x(*map(T, args)) + tc.x2uvstag(*map(T, args)) \
            + (tc.wstag2x(T(d["w"])),
               tc.x2wstag(T(d["w"][1:]), T(d["w"]))) \
            + tc.couple_uvten(*map(T, args), None)
        return flat_j(a), flat_t(b)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["sound", "wafone", "mkslice", "condtq",
                                  "nudge", "stagger"])
def test_method_matches_jax(name, cores):
    """Each method at 1e-12 relative to the result's scale: the same f64
    elementwise arithmetic (the _sound tridiagonal solve and the WAF
    limiter are the same recurrences and thresholds)."""
    jc, tc, s0 = cores
    want, got = _method(name, jc, tc, s0)
    assert _rel(got, want) <= 1e-12, name


def _jstate(s0):
    return jax.tree_util.tree_map(jnp.asarray, s0)


@pytest.fixture(scope="module")
def dyn_runs():
    """Dynamics only (physics=False, boundary held at the initial
    state), 10 steps of each package from the same numpy state."""
    from regcm_tpu.driver import Model as JModel
    from regcm_tpu_torch.driver import Model as TModel

    jcfg, tcfg = moloch_cfgs()
    jg, tg = grids(jcfg, tcfg)
    jm = JModel(jcfg, grid=jg, dtype=jnp.float64, physics=False)
    s0 = jax.device_get(jm.core.initial_state(perturb=0.3, seed=1))
    jm = JModel(jcfg, grid=jg, dtype=jnp.float64, physics=False,
                initial_state=_jstate(s0))
    tm = TModel(tcfg, grid=tg, device="cpu", dtype=torch.float64,
                physics=False, initial_state=s0)
    for _ in range(10):
        jm.step()
        tm.step()
    return ({k: np.asarray(v) for k, v in jm.decoupled().items()},
            tm.decoupled(), jm.state, tm.state)


@pytest.mark.parametrize("field", ["pai", "t", "qv", "u", "v", "w"])
def test_dynamics_ten_steps_match_jax(field, dyn_runs):
    """Without physics nothing amplifies roundoff: 1e-10 rel-RMS on the
    prognostics after ten steps."""
    _, _, js, ts = dyn_runs
    if field == "qv":
        want, got = np.asarray(js.qx[0]), ts.qx[0].numpy()
    else:
        want, got = np.asarray(getattr(js, field)), \
            getattr(ts, field).numpy()
    assert _rel_rms(got, want) <= 1e-10
    assert np.all(np.isfinite(got))


def _slice_start(conf):
    """The JAX package's initial state (numpy) of the whole-model runs."""
    from regcm_tpu.driver import Model as JModel
    jcfg, tcfg = moloch_cfgs(conf)
    jg, _ = grids(jcfg, tcfg)
    jm = JModel(jcfg, grid=jg, dtype=jnp.float64)
    return jax.device_get(jm.core.initial_state(perturb=0.3, seed=1))


def _jax_slice(conf, s0):
    """The JAX package's Model(idynamic=3) for 12 steps from ``s0``: the
    decoupled fields. Runs in a spawned process, which has not read the
    conftest's settings."""
    use_suite_cache()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from regcm_tpu.driver import Model as JModel
    jcfg, tcfg = moloch_cfgs(conf)
    jg, _ = grids(jcfg, tcfg)
    jm = JModel(jcfg, grid=jg, dtype=jnp.float64, initial_state=_jstate(s0))
    for _ in range(12):
        jm.step()
    return {k: np.asarray(v) for k, v in jm.decoupled().items()}


@pytest.fixture(scope="module", autouse=True)
def slice_jax_started():
    """The JAX package's two whole-model runs (default and conf=0; a
    compile for each alarm pattern of each), in two spawned processes
    started with the module, beside the other tests."""
    starts = {conf: _slice_start(conf) for conf in (None, 0.0)}
    with ProcessPoolExecutor(2, mp_context=mp.get_context("spawn")) as pool:
        yield {conf: (s0, pool.submit(_jax_slice, conf, s0))
               for conf, s0 in starts.items()}


@pytest.fixture(scope="module")
def slice_runs(slice_jax_started):
    """The whole model, Model(idynamic=3) with the default physics, 12
    steps (cumulus at steps 0, 5, 10; surface at 0 and 10; radiation and
    absorptivities at 0), run once per package per configuration: the
    default run, the port from a 1e-15 relative perturbation of T (the
    trajectory's roundoff spread) and both packages with the SUBEX
    saturation adjustment off (conf=0)."""
    from regcm_tpu_torch.driver import Model as TModel

    out = {}
    for conf in (None, 0.0):
        _, tcfg = moloch_cfgs(conf)
        tg = grids(*moloch_cfgs(conf))[1]
        s0, job = slice_jax_started[conf]
        runs = [TModel(tcfg, grid=tg, device="cpu", dtype=torch.float64,
                       initial_state=s0)]
        if conf is None:
            rng = np.random.default_rng(0)
            s1 = s0._replace(t=np.asarray(s0.t) * (
                1.0 + 1e-15 * rng.standard_normal(np.shape(s0.t))))
            runs.append(TModel(tcfg, grid=tg, device="cpu",
                               dtype=torch.float64, initial_state=s1))
        flags = []
        for _ in range(12):
            flags.append(runs[0]._flags())
            for m in runs:
                m.step()
        dec = [job.result()] + [m.decoupled() for m in runs]
        out["dry" if conf == 0.0 else "default"] = dict(
            dec=dec, flags=flags,
            finite=all(m.check_finite() for m in runs),
            heatrt=float(runs[0].state.heatrt.abs().max()))
    return out


def test_slice_covers_every_alarm(slice_runs):
    run = slice_runs["default"]
    fl = run["flags"]
    assert [n for n, f in enumerate(fl) if f.do_cum] == [0, 5, 10]
    assert [n for n, f in enumerate(fl) if f.do_srf] == [0, 10]
    assert [n for n, f in enumerate(fl) if f.do_rad] == [0]
    assert fl[0].do_abem
    assert run["finite"] and slice_runs["dry"]["finite"]
    assert run["heatrt"] > 0.0                 # radiation engaged


@pytest.mark.parametrize("field", TRAJ_FIELDS)
def test_slice_twelve_steps_match_jax(field, slice_runs):
    """Model(idynamic=3), default physics, 12 steps: rel-RMS < 1e-7, or
    four times the port's own roundoff spread (a 1e-15 relative change
    of T) where that is larger, as for the hydrostatic core: threshold
    branches (saturation adjustment, BATS, the WAF limiter) act on
    roundoff-level values."""
    jd, td, pd = slice_runs["default"]["dec"]
    spread = _rel_rms(pd[field], td[field])
    assert spread < 1e-6                   # the port's own conditioning
    err = _rel_rms(td[field], jd[field])
    assert err < max(1e-7, 4.0 * spread), \
        f"{field}: rel-RMS {err:.3e}, roundoff spread {spread:.3e}"


@pytest.mark.parametrize("field", TRAJ_FIELDS)
def test_slice_without_condensation_matches_jax(field, slice_runs):
    """With the saturation adjustment off (subexparam conf=0) the
    trajectory is well conditioned: 1e-9 rel-RMS after 12 steps."""
    jd, td = slice_runs["dry"]["dec"]
    assert _rel_rms(td[field], jd[field]) < 1e-9


def test_moloch_refusals():
    """Kuo, the UW TCM and the periodic domains on MOLOCH are refused; the
    gas-phase chemistry (CBMZ, its 37 tracers in K4's stack) and
    Tiedtke's tracer transport (DUST with Tiedtke over water), refused
    until they were ported, build and step."""
    from regcm_tpu_torch.driver import Model

    for overrides in ((("physics", "icup_lnd", 1),),
                      (("physics", "ibltyp", 2),),
                      (("geo", "i_band", 1),),
                      (("geo", "i_crm", 1),)):
        _, cfg = moloch_cfgs()
        for section, name, val in overrides:
            setattr(getattr(cfg, section), name, val)
        with pytest.raises((ValueError, NotImplementedError)):
            Model(cfg, device="cpu")
    for overrides in ((("chem", "chemsimtype", "CBMZ"),),
                      (("chem", "chemsimtype", "DUST"),
                       ("physics", "icup_ocn", 5))):
        _, cfg = moloch_cfgs()
        cfg.dim.iy, cfg.dim.jx = 8, 10      # a step of the gas solver
        cfg.physics.ichem = 1
        for section, name, val in overrides:
            setattr(getattr(cfg, section), name, val)
        m = Model(cfg, device="cpu")
        m.step()
        assert m.check_finite()


def test_float32_step_stays_float32():
    """The Python-float constants of the step (0.5, 0.25, c.egrav·dts,
    zetaf's top value) must not promote a float32 run to float64."""
    from regcm_tpu_torch.driver import Model

    _, cfg = moloch_cfgs()
    m = Model(cfg, grid=tbuild_grid(cfg, ht=hill()), device="cpu",
              dtype=torch.float32)
    m.step()
    assert m.check_finite()
    for name, field in m.state._asdict().items():
        assert field.dtype == torch.float32, name
