"""The sigma-p cores' dynamics options of the PyTorch port against the
JAX package, in f64 on the CPU: each of idiffu 2 and 3, iboudy 3 and 4,
ipgf 1, ithadv 1 and isladvec 1 (iqmsl 0 and 1) over five steps of the
hydrostatic dynamics on 18x24x14 over the test hill, and idiffu 3 and
iboudy 4 over five steps of the MM5 non-hydrostatic dynamics
(``tests/_torch_nh_ranks.py`` ``NH``); then the port's twins of the JAX
package's behaviour tests of these options and the numpy oracle of the
6th-order diffusion. iboudy 0-2 step through iboudy 5's code with other
relaxation maps, which the grid module (held equal to the JAX package's
by ``tests/test_torch_shared.py``) builds."""
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from regcm_tpu.config.params import RegCMConfig  # noqa: E402
from regcm_tpu_torch.config.params import RegCMConfig as TConfig  # noqa

from . import _torch_nh_ranks as R  # noqa: E402
from ._torch_parallel_ranks import hill  # noqa: E402
from .test_torch_nh import _jax_dyn  # noqa: E402

STEPS = 5
IY, JX = 18, 24
# option -> the physicsparam (or dynparam extras, "ithadv") overrides
HYDRO_OPTIONS = {
    "idiffu2": dict(idiffu=2), "idiffu3": dict(idiffu=3),
    "iboudy3": dict(iboudy=3), "iboudy4": dict(iboudy=4),
    "ipgf1": dict(ipgf=1),
    "ithadv1": dict(ithadv=1),
    "isladvec_qmsl0": dict(isladvec=1, iqmsl=0),
    "isladvec_qmsl1": dict(isladvec=1, iqmsl=1)}
NH_OPTIONS = {"nh_idiffu3": dict(idiffu=3), "nh_iboudy4": dict(iboudy=4)}


def hydro_cfg(cfg, **opts):
    """18x24x14, ds 60 km, dt 120 s (tests/test_parallel.py's pair), no
    saturation adjustment, with the option's overrides."""
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = IY, JX, 14
    cfg.geo.ds = 60.0
    cfg.time.dt = 120.0
    cfg.physics.ipptls = 0
    for k, v in opts.items():
        if k == "ithadv":
            cfg.dyn.extras[k] = v
        else:
            setattr(cfg.physics, k, v)
    return cfg


def hydro_start(s, psd):
    """The perturbed standard atmosphere with a 10 m/s westerly jet and
    qv lifted off the minqq floor (numpy, either package's state). No
    cloud water: where the advection of a cloud's edge undershoots, the
    negative-water fix turns the sign of a roundoff into 1e-8 of the
    field, which the comparison would read."""
    ps = np.asarray(s.ps_a)
    u = 10.0 * np.asarray(psd)[None] * np.ones(np.shape(s.u_a))
    qx = np.array(s.qx_a)
    qx[0] = np.maximum(qx[0], 1e-5 * ps[None])
    return s._replace(u_a=u, u_b=u, qx_a=qx, qx_b=qx.copy())


def _jax_hydro(opts):
    """The JAX package's HydroCore.step, five steps of the option."""
    from regcm_tpu.core.grid import build_grid
    from regcm_tpu.core.state import StepFlags, bdy_from_state
    from regcm_tpu.driver import standard_atmosphere_state
    from regcm_tpu.dynamics.hydrostatic import HydroCore
    from regcm_tpu.dynamics.stencil import cross2dot
    cfg = hydro_cfg(RegCMConfig(), **opts)
    core = HydroCore(build_grid(cfg, ht=hill(IY, JX)), cfg,
                     dtype=jnp.float64)
    s = jax.device_get(standard_atmosphere_state(core.grid, cfg,
                                                 perturb=0.2, seed=3))
    s = hydro_start(s, cross2dot(jnp.asarray(s.ps_a)))
    s = core.init_split_storage(jax.tree_util.tree_map(jnp.asarray, s))
    bdy = bdy_from_state(s)
    step = jax.jit(core.step, static_argnames=("flags",))
    xt, dt = 0.0, cfg.dtsec
    for _ in range(STEPS):
        s, _ = step(s, bdy, xt, dt, StepFlags())
        xt += cfg.dtsec
        dt = 2.0 * cfg.dtsec
    return {k: np.asarray(getattr(s, k)) for k in R.STATE_FIELDS[:-2]}


def _port_hydro(opts):
    """The port's HydroCore.step on the same start."""
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.core.state import (StepFlags, bdy_from_state,
                                            state_from_numpy, state_to_numpy)
    from regcm_tpu_torch.driver import standard_atmosphere_state
    from regcm_tpu_torch.dynamics.hydrostatic import HydroCore
    from regcm_tpu_torch.dynamics.stencil import cross2dot
    cfg = hydro_cfg(TConfig(), **opts)
    core = HydroCore(build_grid(cfg, ht=hill(IY, JX)), cfg, device="cpu")
    s0 = standard_atmosphere_state(core.grid, cfg, "cpu", perturb=0.2,
                                   seed=3)
    s = hydro_start(s0._replace(**state_to_numpy(s0)),
                    cross2dot(s0.ps_a).numpy())
    s = core.init_split_storage(state_from_numpy(s, "cpu"))
    bdy = bdy_from_state(s)
    xt, dt = 0.0, cfg.dtsec
    for _ in range(STEPS):
        s, _ = core.step(s, bdy, xt, dt, StepFlags())
        xt += cfg.dtsec
        dt = 2.0 * cfg.dtsec
    return {k: getattr(s, k).numpy() for k in R.STATE_FIELDS[:-2]}


@pytest.fixture(scope="module")
def nh_jax():
    """The NH options' JAX runs, in a process of their own beside the
    hydrostatic ones."""
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as pr:
        futs = {k: pr.submit(_jax_dyn, STEPS, **opts)
                for k, opts in NH_OPTIONS.items()}
        yield futs


@pytest.fixture(scope="module", autouse=True)
def _one_thread(nh_jax):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def defaults():
    """The port's runs without an option, one of each core."""
    return dict(hydro=_port_hydro({}), nh=R.dyn_run(steps=STEPS))


@pytest.mark.parametrize("option", list(HYDRO_OPTIONS) + list(NH_OPTIONS))
def test_option_matches_jax(option, nh_jax, defaults):
    """Five dynamics steps with the option: every prognostic within
    1e-10 of the JAX package (max relative; measured ~1e-13), and the
    option changes the trajectory against the default."""
    if option in NH_OPTIONS:
        want = nh_jax[option].result()
        got = R.dyn_run(steps=STEPS, **NH_OPTIONS[option])
        base = defaults["nh"]
    else:
        want = _jax_hydro(HYDRO_OPTIONS[option])
        got = _port_hydro(HYDRO_OPTIONS[option])
        base = defaults["hydro"]
    for k, w in want.items():
        assert np.all(np.isfinite(got[k])), k
        err = R.max_rel(got[k], w)
        assert err <= 1e-10, f"{option} {k}: {err:.3e}"
    assert any(not np.array_equal(got[k], base[k]) for k in want)


# -- the port's twins of the JAX package's behaviour tests -----------------
def _model(cfg, state=None):
    from regcm_tpu_torch.driver import Model
    return Model(cfg, device="cpu", physics=False, initial_state=state)


def _standard(cfg, perturb, seed):
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import standard_atmosphere_state
    return standard_atmosphere_state(build_grid(cfg), cfg, "cpu",
                                     perturb=perturb, seed=seed)


def _test001(iy=24, jx=32):
    cfg = TConfig()
    cfg.dim.iy, cfg.dim.jx = iy, jx
    return cfg


def test_sponge_boundary():
    """tests/test_hydrostatic.py::test_sponge_boundary's twin: the
    iboudy=4 weights on the distance-2 ring and inside, and a stable
    15-step run."""
    from regcm_tpu_torch.core.grid import build_grid
    cfg = _test001()
    cfg.physics.iboudy = 4
    wc = build_grid(cfg).extras["sponge_wc"]
    assert wc[1, 10] == pytest.approx(0.4)
    assert wc[2, 10] == pytest.approx(0.7)
    assert wc[10, 10] == 1.0
    m = _model(cfg, _standard(cfg, 0.2, 3))
    m.run(15)
    assert m.check_finite()
    ps = m.state.ps_a.numpy()
    assert ps.max() < 200.0 and ps.min() > 20.0


def test_inflow_outflow_boundary():
    """tests/test_hydrostatic.py::test_inflow_outflow_boundary's twin:
    under a westerly the west edge is inflow (its hydrometeors forced to
    0); the east edge follows the interior."""
    cfg = _test001()
    cfg.physics.iboudy = 3
    s = _standard(cfg, 0.0, 0)
    u = s.u_a + 5.0 * s.ps_a[None]
    qx = s.qx_a.clone()
    qx[1, :, :, 1:4] = 1e-4 * s.ps_a[None, :, 1:4]
    m = _model(cfg, s._replace(u_a=u, u_b=u, qx_a=qx, qx_b=qx.clone()))
    m.run(8)
    assert m.check_finite()
    qc = (m.state.qx_a[1] / m.state.ps_a[None]).numpy()
    assert float(np.abs(qc[:, 2:-2, 0]).max()) == 0.0
    assert np.isfinite(qc[:, :, -2]).all()


def test_semilagrangian_advection():
    """tests/test_hydrostatic.py::test_semilagrangian_advection's twin: a
    qc blob advects downstream under the semi-Lagrangian scheme with the
    QMSL limiter, within its initial range, and the run stays finite."""
    from regcm_tpu_torch.core.state import bdy_from_state
    from regcm_tpu_torch.dynamics.stencil import cross2dot
    cfg = TConfig()
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 16, 30, 14
    cfg.geo.ds = 60.0
    cfg.time.dt = 120.0
    cfg.physics.isladvec = 1
    cfg.physics.ipptls = 0
    m = _model(cfg)
    s = m.state
    u = 25.0 * cross2dot(s.ps_a)[None] * torch.ones_like(s.u_a)
    qc = torch.zeros_like(s.qx_a[1])
    qc[:, 5:11, 6:10] = 1.0e-4
    qc = qc * s.ps_a[None]
    qx = torch.stack([s.qx_a[0], qc])
    s = m.core.init_split_storage(s._replace(u_a=u, u_b=u, qx_a=qx,
                                             qx_b=qx.clone()))
    m.state, m.bdy = s, bdy_from_state(s)
    m.run(10)
    q1 = (m.state.qx_a[1] / m.state.ps_a[None]).numpy()
    assert np.isfinite(q1).all()
    assert q1.max() <= 1.05e-4
    assert q1.min() >= -1e-12
    q0 = (qc / s.ps_a[None]).numpy()
    x = np.arange(q1.shape[-1])
    c0 = (q0.sum(axis=(0, 1)) * x).sum() / max(q0.sum(), 1e-30)
    c1 = (q1.sum(axis=(0, 1)) * x).sum() / max(q1.sum(), 1e-30)
    assert c1 > c0 + 0.3


def test_idiffu3_monotonic_oracle():
    """tests/test_core_options.py::test_idiffu3_monotonic_oracle's twin:
    the port's _diffu6 against a literal f64 re-derivation of the
    Fortran flux loops (h4 coefficients, index clamping, the limiter's
    sign test on f/mpd) over the whole interior: 1e-12."""
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.dynamics.hydrostatic import HydroCore
    cfg = _test001(12, 14)
    cfg.physics.idiffu = 3
    grid = build_grid(cfg)
    core = HydroCore(grid, cfg, device="cpu")
    rng = np.random.default_rng(11)
    kz, iy, jx = 5, 12, 14
    f = rng.normal(size=(kz, iy, jx))
    mpd = np.asarray(grid.msfd)
    T = torch.as_tensor
    got = core._diffu6(T(f), T(f / mpd[None]), T(1.0),
                       torch.ones(iy, jx, dtype=torch.float64)).numpy()
    h1, h2, h3 = 10.0, -5.0, 1.0
    want = np.zeros_like(f)
    cl = lambda n, hi: min(max(n, 0), hi - 1)
    for k in range(kz):
        for i in range(iy):
            for j in range(jx):
                acc = 0.0
                for ax in (0, 1):            # x then y sweep
                    def g(n):
                        if ax == 0:
                            return f[k, i, cl(j + n, jx)]
                        return f[k, cl(i + n, iy), j]

                    def gl(n):
                        if ax == 0:
                            return f[k, i, cl(j + n, jx)] \
                                / mpd[i, cl(j + n, jx)]
                        return f[k, cl(i + n, iy), j] \
                            / mpd[cl(i + n, iy), j]
                    fp1 = (h1 * (g(1) - g(0)) + h2 * (g(2) - g(-1))
                           + h3 * (g(3) - g(-2)))
                    if fp1 * (gl(1) - gl(0)) <= 0.0:
                        fp1 = 0.0
                    fp0 = (h1 * (g(0) - g(-1)) + h2 * (g(1) - g(-2))
                           + h3 * (g(2) - g(-3)))
                    if fp0 * (gl(0) - gl(-1)) <= 0.0:
                        fp0 = 0.0
                    acc += fp1 - fp0
                want[k, i, j] = acc
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
