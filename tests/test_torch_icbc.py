"""ICBC-driven runs of the PyTorch port against the JAX package, one rank,
f64 on the CPU: ``MolochCore.fields_from_sigma`` and ``paicompute`` on
the same record, then ``Model.init_from_icbc``, ``update_boundary`` and
``run_icbc`` of both cores from the same DOMAIN and ICBC files (the
settings ``ICBC`` of ``tests/_torch_parallel_ranks.py``, written by the
JAX package's preprocessors). The port steps both cores through the
hourly boundary update; the JAX package steps the hydrostatic core
through it too, and MOLOCH for tests/test_moloch.py's four steps (each
alarm pattern it meets costs a compile of up to a minute), and forms
the pair of the update at its date directly.

The JAX package's runs go in two spawned processes, started with the
module, while the port's runs go on here."""
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from regcm_tpu_torch.config.params import RegCMConfig  # noqa: E402

from . import _torch_parallel_ranks as R  # noqa: E402
from ._torch_icbc_files import write_files  # noqa: E402
from ._torch_jax_child import use_suite_cache  # noqa: E402

FIELDS = ("ps", "t", "qv", "u", "v")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / (np.sqrt(np.mean(want ** 2)) + 1e-30))


# the steps the JAX package runs of each setting
JAX_STEPS = {"hydro": 25, "moloch": 4}


def _icbc_jax(kind, paths):
    """The JAX package's Model on an ICBC setting, as ``R.icbc_run`` drives
    the port's, through JAX_STEPS; then the boundary pair that the
    hourly update forms, by ``update_boundary`` at its date. Runs in a
    spawned process, which has not read the conftest's settings."""
    use_suite_cache()
    jax.config.update("jax_enable_x64", True)
    from regcm_tpu.config.params import RegCMConfig as JConfig
    from regcm_tpu.driver import Model
    from regcm_tpu.preproc.icbc import ICBCReader
    from regcm_tpu.preproc.terrain import build_grid_from_domain
    cfg = R.icbc_setup(JConfig(), kind)
    grid = build_grid_from_domain(cfg, paths["domain"]) \
        if "domain" in paths else None
    m = Model(cfg, grid=grid, dtype=jnp.float64)
    m.init_from_icbc(ICBCReader(paths["icbc"], cfg.globdat.calendar))
    np_of = lambda nt: {k: np.asarray(v) for k, v in nt._asdict().items()
                        if v is not None and np.size(v)}
    start = m.date
    out = dict(init=np_of(m.state), bdy0=np_of(m.bdy))
    n = JAX_STEPS[kind]
    m.run_icbc(n)
    out[n] = dict(state=np_of(m.state), bdy=np_of(m.bdy),
                  dec={k: np.asarray(v) for k, v in m.decoupled().items()},
                  nstep=m.nstep, xbctime=m.xbctime)
    m.date = start.add_seconds(3600.0)
    m.update_boundary()
    out["update"] = np_of(m.bdy)
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # torch on one thread: the port's runs here are small and the JAX
    # processes' compiles share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("icbc")
    return {kind: write_files(kind, str(d)) for kind in R.ICBC}


@pytest.fixture(scope="module")
def jax_started(paths):
    with ProcessPoolExecutor(len(R.ICBC),
                             mp_context=mp.get_context("spawn")) as pool:
        yield {kind: pool.submit(_icbc_jax, kind, paths[kind])
               for kind in R.ICBC}


@pytest.fixture(scope="module")
def port_runs(paths, jax_started):
    """The port on each setting through the hourly update."""
    return {kind: R.icbc_run(kind, paths[kind]) for kind in R.ICBC}


@pytest.fixture(scope="module")
def hydro_spread(paths, jax_started):
    """The hydrostatic setting again with the state's T changed by 1e-15
    relative right after the cold start (the trajectory's roundoff
    spread): the decoupled fields after step 25."""
    return _perturbed_run("hydro", paths["hydro"])[25]


def _perturbed_run(kind, paths):
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    from regcm_tpu_torch.preproc.terrain import build_grid_from_domain
    cfg = R.icbc_setup(RegCMConfig(), kind)
    grid = build_grid_from_domain(cfg, paths["domain"]) \
        if "domain" in paths else None
    m = Model(cfg, grid=grid, device="cpu", dtype=torch.float64)
    m.init_from_icbc(ICBCReader(paths["icbc"], cfg.globdat.calendar))
    name = "t" if kind == "moloch" else "t_a"
    t = getattr(m.state, name)
    rng = np.random.default_rng(0)
    m.state = m.state._replace(**{name: t * (1.0 + 1e-15 * torch.as_tensor(
        rng.standard_normal(tuple(t.shape))))})
    out = {}
    for n in R.ICBC[kind]["record"]:
        m.run_icbc(n - m.nstep)
        out[n] = m.decoupled()
    return out


@pytest.fixture(scope="module")
def jax_runs(jax_started):
    return {kind: f.result() for kind, f in jax_started.items()}


@pytest.fixture(scope="module")
def moloch_record(paths):
    """The MOLOCH setting's first ICBC record, and both packages' cores on
    its flat grid."""
    from regcm_tpu.config.params import RegCMConfig as JConfig
    from regcm_tpu.core.grid import build_grid
    from regcm_tpu.dynamics.moloch import MolochCore as JCore
    from regcm_tpu_torch.core.grid import build_grid as tbuild_grid
    from regcm_tpu_torch.dynamics.moloch import MolochCore
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    from regcm_tpu_torch.utils.calendar import Date
    jcfg = R.icbc_setup(JConfig(), "moloch")
    tcfg = R.icbc_setup(RegCMConfig(), "moloch")
    rec, _ = ICBCReader(paths["moloch"]["icbc"]).record_at(
        Date.from_int(tcfg.restart.mdate1))
    jgrid, tgrid = build_grid(jcfg), tbuild_grid(tcfg)
    return (rec, tgrid.sigma, JCore(jgrid, jcfg, dtype=jnp.float64),
            MolochCore(tgrid, tcfg, device="cpu", dtype=torch.float64))


def test_fields_from_sigma_matches_jax(moloch_record):
    """Sigma-level record -> zita levels (height interpolation, paicompute,
    the face staggering): 1e-12 relative in pai, t, qv, u, v."""
    rec, sigma, jc, tc = moloch_record
    args = (rec["ps"], rec["t"], rec["qv"], rec["u"], rec["v"], sigma)
    want = jc.fields_from_sigma(*args)
    got = tc.fields_from_sigma(*args)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float64
        assert _rel(got[k].numpy(), want[k]) <= 1e-12, k


def test_paicompute_matches_jax(moloch_record):
    """paicompute on the record's own levels (T, qv as they come): 1e-12."""
    rec, _, jc, tc = moloch_record
    kz = tc.kz
    t = np.asarray(rec["t"], np.float64)[:kz]
    qv = np.asarray(rec["qv"], np.float64)[:kz]
    want = jc.paicompute(rec["ps"], t, qv)
    got = tc.paicompute(rec["ps"], t, qv)
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("kind", list(R.ICBC))
def test_init_from_icbc_matches_jax(kind, port_runs, jax_runs):
    """After init_from_icbc: every state field and the first boundary pair
    (b0 and its tendency toward the next record), 1e-12 relative."""
    got, want = port_runs[kind], jax_runs[kind]
    for part in ("init", "bdy0"):
        assert set(got[part]) == set(want[part]), part
        for k, w in want[part].items():
            assert _rel(got[part][k], w) <= 1e-12, (part, k)
    assert np.max(np.abs(want["bdy0"]["ut"])) > 0.0   # the boundary moves


@pytest.mark.parametrize("kind", list(R.ICBC))
def test_update_boundary_matches_jax(kind, port_runs, jax_runs):
    """The port's run_icbc crosses the hourly update (after step 24 of the
    hydrostatic run at dt 150 s, step 60 of MOLOCH's at dt 60 s): the
    boundary clock restarts, and the new pair (b0 and its tendency toward
    the next, stronger-jet record) equals the one the JAX package's
    update_boundary forms at that date, 1e-12 relative."""
    n = max(R.ICBC[kind]["record"])
    got = port_runs[kind][n]
    dt = R.icbc_setup(RegCMConfig(), kind).dtsec
    assert got["finite"]
    assert (got["nstep"], got["xbctime"]) == (n, n * dt - 3600.0)
    want = jax_runs[kind]["update"]
    assert set(got["bdy"]) == set(want)
    for k, b in want.items():
        assert _rel(got["bdy"][k], b) <= 1e-12, k
    assert not np.array_equal(got["bdy"]["u0"],
                              port_runs[kind]["bdy0"]["u0"])


def test_hydro_run_icbc_crosses_the_update_as_jax(port_runs, jax_runs,
                                                  hydro_spread):
    """Both packages step the hydrostatic setting through the update: after
    step 25 the same step count and boundary clock, and the decoupled
    fields within rel-RMS 1e-7 or four times the port's own roundoff
    spread where that is larger (tests/test_torch_model.py's gate for a
    full-physics trajectory; measured v 1.4e-7 against a spread of
    1.1e-7)."""
    g, w = port_runs["hydro"][25], jax_runs["hydro"][25]
    assert (g["nstep"], g["xbctime"]) == (w["nstep"], w["xbctime"])
    for f in FIELDS:
        spread = _rel_rms(hydro_spread[f], g["dec"][f])
        assert spread < 1e-6, f
        err = _rel_rms(g["dec"][f], w["dec"][f])
        assert err < max(1e-7, 4.0 * spread), \
            f"{f}: rel-RMS {err:.3e}, roundoff spread {spread:.3e}"


def test_moloch_run_icbc_four_steps_matches_jax(port_runs, jax_runs):
    """tests/test_moloch.py's four ICBC-driven MOLOCH steps: every
    decoupled field within 1e-10 of its scale; the start balanced within
    the reference's band (mean surface p 980-1040 hPa, |w| < 5 m/s)."""
    got, want = port_runs["moloch"][4], jax_runs["moloch"][4]
    assert got["finite"]
    for f, w in want["dec"].items():
        assert _rel(got["dec"][f], w) <= 1e-10, f
    assert 980.0 < float(np.mean(got["dec"]["ps"])) < 1040.0
    assert float(np.max(np.abs(got["dec"]["w"]))) < 5.0
