"""The hydrostatic core of the PyTorch port against the JAX package:
every phase of ``HydroCore.step`` on the same numpy fields at 1e-12,
then dynamics-only trajectories (``physics=None``) from the same state."""
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
from regcm_tpu.core.state import HydroState as JState  # noqa: E402
from regcm_tpu.driver import standard_atmosphere_state as jstate  # noqa
from regcm_tpu.dynamics import hydrostatic as jh  # noqa: E402
from regcm_tpu.dynamics import stencil as jst  # noqa: E402
from regcm_tpu_torch.core.state import state_from_numpy  # noqa: E402
from regcm_tpu_torch.dynamics import hydrostatic as th  # noqa: E402
from regcm_tpu_torch.dynamics import stencil as tst  # noqa: E402
from ._torch_jax_child import use_suite_cache  # noqa: E402

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


@pytest.fixture(scope="module")
def cores():
    jcfg, tcfg = golden_cfgs()
    grid, tgrid = build_grid(jcfg), tbuild_grid(tcfg)
    jc = jh.HydroCore(grid, jcfg, dtype=jnp.float64)
    tc = th.HydroCore(tgrid, tcfg, device="cpu", dtype=torch.float64)
    s0 = jax.device_get(jstate(grid, jcfg, jnp.float64, perturb=0.3,
                               seed=2024))
    return (jcfg, tcfg), (grid, tgrid), jc, tc, s0


def _inputs(grid, seed=11):
    """Fields of realistic magnitude with grid-scale noise."""
    rng = np.random.default_rng(seed)
    kz, iy, jx = grid.kz, grid.iy, grid.jx
    n = lambda *s: rng.normal(size=s)
    ps = 96.0 + 0.5 * n(iy, jx)
    return dict(
        ps=ps, wind=5.0 * n(kz, iy, jx), wind2=5.0 * n(kz, iy, jx),
        cwind=ps[None] * 5.0 * n(kz, iy, jx),
        cwind2=ps[None] * 5.0 * n(kz, iy, jx),
        svv=1e-4 * n(kz + 1, iy, jx), temp=280.0 + 2.0 * n(kz, iy, jx),
        q=np.abs(5e-3 + 2e-3 * n(kz, iy, jx)), qh=1e-5 * n(2, kz, iy, jx),
        avg=[500.0 * n(kz, iy, jx) for _ in range(4)],
        fint=1e-3 * n(kz - 1, iy, jx), fint4=1e-3 * n(2, kz - 1, iy, jx),
        diff=n(kz, iy, jx), diff2=n(iy, jx), xk=1e-4 * rng.uniform(
            0.5, 1.5, (kz, iy, jx)), ten=1e-4 * n(kz, iy, jx),
        modes=n(2, iy, jx))


def _phase(name, jc, tc, grid, s0):
    """(jax result, torch result) of one HydroCore phase."""
    d = _inputs(grid)
    J = lambda a: jnp.asarray(a)
    T = lambda a: torch.as_tensor(a)
    ps = d["ps"]
    if name == "advection_uv":
        args = (d["cwind"], d["cwind2"], d["wind"], d["wind2"], d["cwind"],
                d["cwind2"], d["svv"])
        return (jnp.stack(jc._advection_uv(*map(J, args))),
                torch.stack(tc._advection_uv(*map(T, args))))
    if name in ("hadv_scalar", "hadv_scalar_centred"):
        args = (d["temp"], *d["avg"], ps)
        if name == "hadv_scalar_centred":
            jc.upstream_mode = tc.upstream_mode = False
        try:
            return (jc._hadv_scalar(*map(J, args)),
                    tc._hadv_scalar(*map(T, args)))
        finally:
            jc.upstream_mode = tc.upstream_mode = True
    if name in ("stability_guard_abs", "stability_guard_rel"):
        mode = name[-3:]
        f = d["temp"] * ps[None] if mode == "abs" else d["q"]
        args = (d["ten"], f, ps)
        return (jc._stability_guard(*map(J, args), mode),
                tc._stability_guard(*map(T, args), mode))
    if name == "vadv_flux":
        return (jc._vadv_flux(J(d["fint"]), None),
                tc._vadv_flux(T(d["fint"])))
    if name == "vadv_flux_species":
        return (jc._vadv_flux(J(d["fint4"]), None),
                tc._vadv_flux(T(d["fint4"])))
    if name == "nudge2d":
        return jc._nudge2d(J(d["diff2"])), tc._nudge2d(T(d["diff2"]))
    if name in ("nudge3_cross", "nudge3_dot"):
        dot = name.endswith("dot")
        fj, gj = (jc.nfd, jc.ngd) if dot else (jc.nfc, jc.ngc)
        ft, gt = (tc.nfd, tc.ngd) if dot else (tc.nfc, tc.ngc)
        return (jc._nudge3(J(d["diff"]), fj, gj, dot=dot),
                tc._nudge3(T(d["diff"]), ft, gt, dot=dot))
    if name == "diffu_cross":
        return (jc._diffu_cross(J(d["temp"]), J(d["xk"])),
                tc._diffu_cross(T(d["temp"]), T(d["xk"])))
    if name == "diffu_dot":
        return (jc._diffu_dot(J(d["wind"]), J(d["xk"])),
                tc._diffu_dot(T(d["wind"]), T(d["xk"])))
    if name == "negfix":
        return jc._negfix(J(d["qh"])), tc._negfix(T(d["qh"]))
    if name == "flow_edges":
        args = (d["qh"] * ps[None, None], ps, d["wind"], d["wind2"])
        return jc._flow_edges(*map(J, args)), tc._flow_edges(*map(T, args))
    if name == "couple_uvten":
        args = (d["ten"], d["ten"][::-1].copy(), ps)
        return (jnp.stack(jc.couple_uvten(*map(J, args))),
                torch.stack(tc.couple_uvten(*map(T, args))))
    if name == "fix_cross_pad":
        return jh.fix_cross_pad(J(d["temp"])), th.fix_cross_pad(T(d["temp"]))
    if name == "cpmf":
        return jh.cpmf(J(d["q"])), th.cpmf(T(d["q"]))
    if name == "condtq":
        js_ = JState(*(jnp.asarray(v) for v in s0))
        ts_ = state_from_numpy(s0, device="cpu")
        # saturate a few cells so the adjustment acts
        qvt = d["ten"] * 3e-2 + 1e-3
        args = (d["ten"], qvt, 1e-2 * d["ten"], ps, 1.0 / ps,
                np.clip(d["q"] * 50.0, 0.0, 0.9), 300.0)
        return (jnp.stack(jc._condtq(js_, *map(J, args[:-1]), args[-1])),
                torch.stack(tc._condtq(ts_, *map(T, args[:-1]), args[-1])))
    if name == "mode_divergence":
        return (jc._mode_divergence(J(d["cwind"]), J(d["cwind2"])),
                tc._mode_divergence(T(d["cwind"]), T(d["cwind2"])))
    if name == "mode_geopotential":
        t3 = d["temp"] * ps[None]
        return (jc._mode_geopotential(J(t3), J(ps)),
                tc._mode_geopotential(T(t3), T(ps)))
    if name == "splitf":
        t3 = d["temp"] * ps[None]
        args = (ps, ps + 0.01, t3, t3 * 1.0001, d["cwind"], d["cwind2"],
                d["cwind2"], d["cwind"], d["modes"], 10.0 * d["modes"])
        return (jnp.concatenate([jnp.ravel(a) for a in
                                 jc._splitf(*map(J, args))]),
                torch.cat([a.reshape(-1) for a in
                           tc._splitf(*map(T, args))]))
    if name == "init_split_storage":
        js_ = JState(*(jnp.asarray(v) for v in s0))
        a = jc.init_split_storage(js_)
        b = tc.init_split_storage(state_from_numpy(s0, device="cpu"))
        return (jnp.stack([a.dstor, a.hstor]),
                torch.stack([b.dstor, b.hstor]))
    raise KeyError(name)


PHASES = ["advection_uv", "hadv_scalar", "hadv_scalar_centred",
          "stability_guard_abs", "stability_guard_rel", "vadv_flux",
          "vadv_flux_species", "nudge2d", "nudge3_cross", "nudge3_dot",
          "diffu_cross", "diffu_dot", "negfix", "flow_edges",
          "couple_uvten", "fix_cross_pad", "cpmf", "condtq",
          "mode_divergence", "mode_geopotential", "splitf",
          "init_split_storage"]


@pytest.mark.parametrize("name", PHASES)
def test_phase_matches_jax(name, cores):
    """Each phase at 1e-12 relative to the result's scale: the same
    elementwise f64 arithmetic, with sums (einsum, cumsum) reordered."""
    _, (grid, _), jc, tc, s0 = cores
    with jst.topology(), tst.topology():
        want, got = _phase(name, jc, tc, grid, s0)
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)
    assert err < 1e-12, f"{name}: {err:.3e}"


def _rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / (np.sqrt(np.mean(b ** 2)) + 1e-30))


@pytest.fixture(scope="module")
def dyn_runs(cores):
    """Dynamics-only runs: JAX and port from the same state, plus the
    port from that state with a 1e-15 relative perturbation of T (the
    trajectory's own roundoff spread)."""
    from regcm_tpu.driver import Model as JModel
    from regcm_tpu_torch.driver import Model as TModel

    (jcfg, tcfg), (grid, tgrid), _, _, s0 = cores
    rng = np.random.default_rng(0)
    s1 = s0._replace(t_a=np.asarray(s0.t_a) * (
        1.0 + 1e-15 * rng.standard_normal(np.shape(s0.t_a))))
    jm = JModel(jcfg, grid=grid, dtype=jnp.float64, initial_state=s0,
                physics=False)
    tm = TModel(tcfg, grid=tgrid, device="cpu", dtype=torch.float64,
                initial_state=s0, physics=False)
    pm = TModel(tcfg, grid=tgrid, device="cpu", dtype=torch.float64,
                initial_state=s1, physics=False)
    out = {}
    for n in range(10):
        jm.step()
        tm.step()
        pm.step()
        if n in (0, 9):
            jd = {k: np.asarray(v) for k, v in jm.decoupled().items()}
            out[n + 1] = (jd, tm.decoupled(), pm.decoupled())
    return out


@pytest.mark.parametrize("field", FIELDS)
def test_dynamics_first_step_matches_jax(field, dyn_runs):
    jd, td, _ = dyn_runs[1]
    assert _rel_rms(td[field], jd[field]) < 1e-10


@pytest.mark.parametrize("field", FIELDS)
def test_dynamics_ten_steps_match_jax(field, dyn_runs):
    """After ten steps the JAX/port difference must stay within the
    trajectory's roundoff spread. The rest-state start makes that
    spread large: a 1e-15 relative change of T moves u and v by ~3e-7
    rel-RMS, because threshold branches (the extrema guard, the
    negative-water fix, saturation) flip on values at roundoff level.
    The bound is 1e-10 or four times that measured spread."""
    jd, td, pd = dyn_runs[10]
    spread = _rel_rms(pd[field], td[field])
    assert spread < 1e-6                 # the port's own conditioning
    err = _rel_rms(td[field], jd[field])
    assert err < max(1e-10, 4.0 * spread), \
        f"{field}: rel-RMS {err:.3e}, roundoff spread {spread:.3e}"


@pytest.fixture(scope="module")
def dry_dyn_runs(cores):
    """Dynamics-only, 10 steps, with the SUBEX saturation adjustment off
    (subexparam conf=0): a well-conditioned trajectory."""
    from regcm_tpu.driver import Model as JModel
    from regcm_tpu_torch.driver import Model as TModel

    _, (grid, tgrid), _, _, s0 = cores
    jcfg, tcfg = golden_cfgs(conf=0.0)
    jm = JModel(jcfg, grid=grid, dtype=jnp.float64, initial_state=s0,
                physics=False)
    tm = TModel(tcfg, grid=tgrid, device="cpu", dtype=torch.float64,
                initial_state=s0, physics=False)
    for _ in range(10):
        jm.step()
        tm.step()
    return ({k: np.asarray(v) for k, v in jm.decoupled().items()},
            tm.decoupled())


@pytest.mark.parametrize("field", FIELDS)
def test_dynamics_ten_steps_without_condensation_match_jax(field,
                                                           dry_dyn_runs):
    """Without condensation nothing amplifies roundoff: 1e-10 rel-RMS
    after ten steps (measured ~1e-12 in u and v)."""
    jd, td = dry_dyn_runs
    assert _rel_rms(td[field], jd[field]) < 1e-10


# The periodic topologies (tests/test_parallel.py's settings): the
# tropical band, x-periodic (18x32x14, NORMER, clat 0, dt 120 s), and the
# CRM, doubly periodic (16x16x14, ds 4 km, dt 20 s); from the golden
# state with a 10 m/s westerly and the saturation adjustment off
# (subexparam conf=0). Bounds: rel-RMS ten times the measured worst
# field (dynamics 10 steps: band 1.1e-12, CRM 1.8e-12; full physics 4
# steps: band 1.3e-10, CRM 3.1e-11).
PERIODIC = {
    "band": dict(iy=18, jx=32, i_band=1, iproj="NORMER", clat=0.0,
                 dt=120.0, bounds=(1.1e-11, 1.3e-9)),
    "crm": dict(iy=16, jx=16, i_crm=1, ds=4.0, dt=20.0,
                bounds=(1.8e-11, 3.1e-10)),
}


def periodic_cfgs(probe):
    """(JAX config, port config) of a PERIODIC probe."""
    p = PERIODIC[probe]
    out = []
    for cls in (RegCMConfig, TConfig):
        cfg = cls()
        cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = p["iy"], p["jx"], 14
        cfg.geo.i_band = p.get("i_band", 0)
        cfg.geo.i_crm = p.get("i_crm", 0)
        if "iproj" in p:
            cfg.geo.iproj, cfg.geo.clat = p["iproj"], p["clat"]
        if "ds" in p:
            cfg.geo.ds = p["ds"]
        cfg.time.dt = p["dt"]
        cfg.subex.conf = 0.0
        out.append(cfg)
    return tuple(out)


def _periodic_start(probe):
    """(JAX config, port config, JAX grid, port grid, the numpy state):
    the golden state with a 10 m/s westerly on the probe's grid."""
    jcfg, tcfg = periodic_cfgs(probe)
    grid, tgrid = build_grid(jcfg), tbuild_grid(tcfg)
    s0 = jstate(grid, jcfg, jnp.float64, perturb=0.3, seed=2024)
    with jst.topology(True, bool(jcfg.geo.i_crm)):
        psd = jst.cross2dot(s0.ps_a)
    u = 10.0 * psd[None] * jnp.ones_like(s0.u_a)
    return jcfg, tcfg, grid, tgrid, jax.device_get(s0._replace(u_a=u,
                                                                u_b=u))


def _periodic_jax(probe, physics):
    """The JAX package on a PERIODIC probe: full physics through ``Model``
    for 4 steps (its alarms), or dynamics for 10 steps through its core
    with constant flags (one compile); the decoupled fields. Runs in a
    spawned process, which has not read the conftest's settings."""
    use_suite_cache()
    jax.config.update("jax_enable_x64", True)
    from regcm_tpu.core.state import StepFlags
    from regcm_tpu.driver import Model as JModel
    jcfg, _, grid, _, s0 = _periodic_start(probe)
    m = JModel(jcfg, grid=grid, dtype=jnp.float64, initial_state=s0,
               physics=None if physics else False)
    if physics:
        for _ in range(4):
            m.step()
    else:
        step = jax.jit(m.core.step, static_argnames=("flags",))
        s, xt, dt = m.state, 0.0, jcfg.dtsec
        for _ in range(10):
            s, _ = step(s, m.bdy, xt, dt, StepFlags())
            xt += jcfg.dtsec
            dt = 2.0 * jcfg.dtsec
        m.state = s
    assert bool(jnp.all(jnp.isfinite(m.state.t_a)))
    return {k: np.asarray(v) for k, v in m.decoupled().items()}


def _periodic_port(probe, physics):
    """The port on a PERIODIC probe, driven as ``_periodic_jax`` drives the
    JAX package."""
    from regcm_tpu_torch.core.state import StepFlags, bdy_from_state
    from regcm_tpu_torch.driver import Model as TModel
    _, tcfg, _, tgrid, s0 = _periodic_start(probe)
    m = TModel(tcfg, grid=tgrid, device="cpu", dtype=torch.float64,
               initial_state=s0, physics=None if physics else False)
    if physics:
        m.run(4)
    else:
        s, b, xt, dt = m.state, bdy_from_state(m.state), 0.0, tcfg.dtsec
        for _ in range(10):
            s, _ = m.core.step(s, b, xt, dt, StepFlags())
            xt += tcfg.dtsec
            dt = 2.0 * tcfg.dtsec
        m.state = s
    assert m.check_finite()
    return m.decoupled()


@pytest.fixture(scope="module", autouse=True)
def periodic_jax_started():
    """The JAX package's four probe runs (a compile of up to a minute for
    each alarm pattern), in two spawned processes started with the
    module, beside the other tests."""
    with ProcessPoolExecutor(2, mp_context=mp.get_context("spawn")) as pool:
        yield {(probe, physics): pool.submit(_periodic_jax, probe, physics)
               for physics in (True, False) for probe in PERIODIC}


@pytest.mark.parametrize("physics", [False, True],
                         ids=["dynamics", "physics"])
@pytest.mark.parametrize("probe", list(PERIODIC))
def test_periodic_core_matches_jax(probe, physics, periodic_jax_started):
    """The band and CRM cores on one rank against the JAX package, f64:
    rel-RMS within the probe's bound in ps, T, qv, u and v."""
    td = _periodic_port(probe, physics)
    jd = periodic_jax_started[(probe, physics)].result()
    bound = PERIODIC[probe]["bounds"][int(physics)]
    for f in FIELDS:
        err = _rel_rms(td[f], jd[f])
        assert err < bound, f"{probe} {f}: rel-RMS {err:.3e}"
