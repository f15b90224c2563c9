"""The port's Grell, Kuo, Betts-Miller, shallow and Kain-Fritsch cumulus
schemes against the JAX package in f64 on the CPU: Grell (``cup``, both
closures), Kuo (with its weight tables), Betts-Miller, the shallow scheme
and Kain-Fritsch (deep, shallow-fallback and mixed-phase soundings, and
its lookup tables), column by column from the same seeded numpy inputs;
the port's twins of the JAX package's column tests and oracles of these
schemes; and ``Model`` on the settings of
``tests/_torch_schemes_ranks.CUMULUS`` (configuration C, Kuo, Betts-Miller
with shallow convection, Kain-Fritsch with the UW TCM and
Nogherotto-Tompkins, Grell on MOLOCH), three steps each at 14x16x14
against the JAX package's Model, with what stays refused.

The JAX Model runs start with the module in three spawned processes,
one JAX compilation for each setting, and run while the column tests
do. Configuration C on 2x2 ranks is held to one rank by the rank group
of ``tests/test_torch_model_schemes.py``."""
import functools
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from regcm_tpu.utils import constants as c  # noqa: E402

from . import _torch_schemes_ranks as R  # noqa: E402
from ._torch_jax_child import use_suite_cache  # noqa: E402

TOL = 1e-12
# the JAX Model runs, grouped by process (about 80 s of compilation
# each, on a CPU core each)
JAX_GROUPS = (("C", "grell_moloch"), ("kf", "kuo"), ("bm",))
NAMES = tuple(R.CUMULUS)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _j(a):
    return jnp.asarray(np.asarray(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    """max |got − want| over the scale max |want|."""
    got, want = _np(got).astype(float), _np(want).astype(float)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-300)


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / (np.sqrt(np.mean(want ** 2)) + 1e-30))


# -- the JAX package's Model, in spawned processes ----------------------
def _jax_runs(names):
    """The JAX package's Model of each setting for R.STEPS steps from
    its own moistened initial state: that state, the final state fields,
    the decoupled fields and the alarms. Runs in a spawned process, which
    has not read the conftest's settings."""
    use_suite_cache()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from regcm_tpu.config.params import RegCMConfig
    from regcm_tpu.core.grid import build_grid
    from regcm_tpu.core.state import StepFlags
    from regcm_tpu.driver import Model, standard_atmosphere_state
    from regcm_tpu.dynamics.moloch import MolochCore
    out = {}
    for name in names:
        cfg = R.setup(RegCMConfig(), name)
        ht, mask = R.terrain(cfg)
        grid = build_grid(cfg, ht=ht, landmask=mask)
        kw = dict(perturb=R.PERTURB, seed=R.SEED)
        if cfg.core.idynamic == 3:
            s0 = MolochCore(grid, cfg, dtype=jnp.float64).initial_state(
                **kw)
        else:
            s0 = standard_atmosphere_state(grid, cfg, jnp.float64, **kw)
        s0 = R.moisten(jax.device_get(s0), cfg.core.idynamic,
                       R.qv_factor(name))
        m = Model(cfg, grid=grid, dtype=jnp.float64,
                  initial_state=jax.tree_util.tree_map(jnp.asarray, s0))
        m._flags = lambda: StepFlags(**R.ALARMS)
        flags = []
        for _ in range(R.STEPS):
            flags.append(tuple(m._flags()))
            m.step()
        keys = R.STATE_FIELDS[cfg.core.idynamic] \
            + (("rainc",) if cfg.core.idynamic == 1 else ())
        out[name] = dict(
            start=s0, flags=flags, finite=m.check_finite(),
            state={k: np.asarray(getattr(m.state, k)) for k in keys},
            dec={k: np.asarray(v) for k, v in m.decoupled().items()})
    return out


@pytest.fixture(scope="module")
def jax_pool():
    with ProcessPoolExecutor(len(JAX_GROUPS),
                             mp_context=mp.get_context("spawn")) as pr:
        yield pr


@pytest.fixture(scope="module")
def jax_jobs(jax_pool):
    return [jax_pool.submit(_jax_runs, g) for g in JAX_GROUPS]


@pytest.fixture(scope="module", autouse=True)
def _start_in_background(jax_jobs):
    """Start the JAX runs with the module; this process's torch on one
    thread beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_models(jax_jobs):
    out = {}
    for job in jax_jobs:
        out.update(job.result())
    return out


# -- Grell (cup) ------------------------------------------------------------
def _grell_columns(seed=7, ncol=24):
    """The oracle fixture's four columns and ``ncol`` random soundings of
    the same construction (bottom-up, hPa)."""
    from .test_grell_oracle import _fixture, _pfwsat
    t, q, tn, qo, p, psur, ter11, vsp, kbmax0 = _fixture()
    rng = np.random.default_rng(seed)
    kz = t.shape[1]
    x = np.linspace(0.0, 1.0, kz)
    sig = 0.995 - (0.995 - 0.03) * x ** 1.8
    ps2 = rng.uniform(980.0, 1015.0, ncol)
    p2 = sig[None] * (ps2[:, None] - 50.0) + 50.0
    zz = 287.0 * 265.0 / 9.81 * np.log(ps2[:, None] / p2)
    t2 = np.maximum(rng.uniform(295.0, 305.0, (ncol, 1))
                    - rng.uniform(0.006, 0.008, (ncol, 1))
                    * np.minimum(zz, 7000.0)
                    - 0.0015 * np.maximum(zz - 7000.0, 0.0), 205.0) \
        + rng.normal(0.0, 0.1, (ncol, kz))
    q2 = _pfwsat(t2, p2 * 100.0) * rng.uniform(0.6, 0.98, (ncol, 1)) \
        * np.linspace(1.0, 0.25, kz)[None]
    tn2 = t2 + rng.normal(0.1, 0.05, t2.shape)
    qo2 = q2 * (1.0 + rng.normal(0.02, 0.01, q2.shape))
    vsp2 = np.abs(rng.normal(5.0, 3.0, (ncol, kz))) \
        + np.linspace(0.0, 12.0, kz)[None]
    cat = lambda a, b: np.concatenate([a, b])
    return (cat(t, t2), cat(q, q2), cat(tn, tn2), cat(qo, qo2),
            cat(p, p2), cat(psur, ps2), cat(ter11, rng.uniform(0, 800, ncol)),
            cat(vsp, vsp2), kbmax0)


@functools.lru_cache(maxsize=None)
def _grell_pair(igcc, kbmax_given):
    from regcm_tpu.physics.cumulus.grell import cup as jcup
    from regcm_tpu_torch.physics.cumulus.grell import cup
    *args, kbmax0 = _grell_columns()
    kb = kbmax0 if kbmax_given else None
    want = jcup(*map(_j, args), 300.0, igcc=igcc, kbmax=kb)
    got = cup(*map(_t, args), 300.0, igcc=igcc, kbmax=kb)
    return got, want


@pytest.mark.parametrize("kbmax_given", [True, False])
@pytest.mark.parametrize("igcc", [1, 2])
def test_grell_matches_jax(igcc, kbmax_given):
    """cup with the AS74 and FC80 closures (kbmax from the sigma levels
    or from the pressure-ratio default) on 28 columns: the branches
    (active, kbcon, ktop) equal, the tendencies, rain and cloud 1e-12."""
    got, want = _grell_pair(igcc, kbmax_given)
    act = _np(want.active)
    assert act.any() and (~act).any()
    differ = int((_np(got.active) != act).sum())
    print(f"igcc {igcc}: {act.sum()} active, {differ} columns in another "
          "branch")
    assert differ == 0
    np.testing.assert_array_equal(_np(got.kbcon)[act], _np(want.kbcon)[act])
    np.testing.assert_array_equal(_np(got.ktop)[act], _np(want.ktop)[act])
    for k in ("outt", "outq", "pratec", "cldfrc"):
        assert _rel(getattr(got, k), getattr(want, k)) <= TOL, k


# twins of tests/test_grell_oracle.py: the port against the NumPy
# transcription of the Fortran loops
@pytest.mark.parametrize("igcc", [1, 2])
def test_cup_vs_fortran_oracle(igcc):
    from regcm_tpu_torch.physics.cumulus.grell import cup
    from .test_grell_oracle import _fixture, cup_oracle
    t, q, tn, qo, p, psur, ter11, vsp, kbmax0 = _fixture()
    (outt_e, outq_e, prate_e, cldf_e, kbcon_e, ktop_e, act_e,
     cover) = cup_oracle(t, q, tn, qo, p, psur, ter11, vsp, 300.0, igcc,
                         kbmax0)
    assert act_e.any() and (~act_e).any()
    assert cover["deep"] > 0 and cover["htcap"] > 0
    out = cup(*map(_t, (t, q, tn, qo, p, psur, ter11, vsp)), 300.0,
              igcc=igcc, kbmax=kbmax0)
    act = _np(out.active)
    np.testing.assert_array_equal(act, act_e)
    np.testing.assert_array_equal(_np(out.kbcon)[act_e], kbcon_e[act_e])
    np.testing.assert_array_equal(_np(out.ktop)[act_e], ktop_e[act_e])
    np.testing.assert_allclose(_np(out.outt), outt_e, rtol=1e-9, atol=1e-16)
    np.testing.assert_allclose(_np(out.outq), outq_e, rtol=1e-9, atol=1e-19)
    np.testing.assert_allclose(_np(out.pratec), prate_e, rtol=1e-9,
                               atol=1e-16)
    np.testing.assert_allclose(_np(out.cldfrc), cldf_e, rtol=1e-9,
                               atol=1e-12)


def test_cup_oracle_retry_branch():
    """The pbcdif retry exhausts kbmax: the column goes inactive in both
    the oracle and the port."""
    from regcm_tpu_torch.physics.cumulus.grell import cup
    from .test_grell_oracle import _fixture, cup_oracle
    t, q, tn, qo, p, psur, ter11, vsp, kbmax0 = _fixture()
    t2, q2, tn2, qo2 = t.copy(), q.copy(), tn.copy(), qo.copy()
    span, bump, dryf = 8, 2.5, 0.25
    t2[0, 1:span] += bump * np.exp(-np.arange(1, span) / 4.0)
    tn2[0, 1:span] = t2[0, 1:span] + 0.1
    q2[0, 1:span] *= dryf
    qo2[0, 1:span] = q2[0, 1:span] * 1.02
    (outt_e, outq_e, prate_e, _, _, _, act_e, cover) = cup_oracle(
        t2, q2, tn2, qo2, p, psur, ter11, vsp, 300.0, 2, kbmax0)
    assert cover["retry"] > 0 and not act_e[0] and act_e.any()
    out = cup(*map(_t, (t2, q2, tn2, qo2, p, psur, ter11, vsp)), 300.0,
              igcc=2, kbmax=kbmax0)
    np.testing.assert_array_equal(_np(out.active), act_e)
    np.testing.assert_allclose(_np(out.outt), outt_e, rtol=1e-9, atol=1e-16)
    np.testing.assert_allclose(_np(out.outq), outq_e, rtol=1e-9, atol=1e-19)
    np.testing.assert_allclose(_np(out.pratec), prate_e, rtol=1e-9,
                               atol=1e-16)


@pytest.mark.parametrize("igcc", [1, 2])
def test_cup_closure_uncapped(igcc, monkeypatch):
    """The heating bound lifted in the port's module: xmb is the
    closure's -f/xk alone, against the oracle."""
    import regcm_tpu_torch.physics.cumulus.grell as G
    from .test_grell_oracle import _fixture, cup_oracle
    monkeypatch.setattr(G, "HTMAX", 1.0e6)
    monkeypatch.setattr(G, "HTMIN", -1.0e6)
    t, q, tn, qo, p, psur, ter11, vsp, kbmax0 = _fixture()
    (outt_e, outq_e, prate_e, _, _, _, act_e, cover) = cup_oracle(
        t, q, tn, qo, p, psur, ter11, vsp, 300.0, igcc, kbmax0,
        htmax=1.0e6, htmin=-1.0e6)
    assert cover["htcap"] == 0 and act_e.any()
    out = G.cup(*map(_t, (t, q, tn, qo, p, psur, ter11, vsp)), 300.0,
                igcc=igcc, kbmax=kbmax0)
    np.testing.assert_array_equal(_np(out.active), act_e)
    np.testing.assert_allclose(_np(out.pratec), prate_e, rtol=1e-9,
                               atol=1e-16)
    np.testing.assert_allclose(_np(out.outt), outt_e, rtol=1e-9, atol=1e-16)
    np.testing.assert_allclose(_np(out.outq), outq_e, rtol=1e-9, atol=1e-19)


def test_cup_closures_differ_uncapped(monkeypatch):
    """AS74 and FC80 give different uncapped rain in the port."""
    import regcm_tpu_torch.physics.cumulus.grell as G
    from .test_grell_oracle import _fixture
    monkeypatch.setattr(G, "HTMAX", 1.0e6)
    monkeypatch.setattr(G, "HTMIN", -1.0e6)
    t, q, tn, qo, p, psur, ter11, vsp, kbmax0 = _fixture()
    args = list(map(_t, (t, q, tn, qo, p, psur, ter11, vsp)))
    r1 = G.cup(*args, 300.0, igcc=1, kbmax=kbmax0)
    r2 = G.cup(*args, 300.0, igcc=2, kbmax=kbmax0)
    act = _np(r1.active) & _np(r2.active)
    assert act.any()
    assert not np.allclose(_np(r1.pratec)[act], _np(r2.pratec)[act])


def test_grell_fingerprint():
    """Twin of tests/test_cumulus_oracles.py::test_grell_fingerprint: the
    port's cup reproduces the frozen f64 fingerprint."""
    from regcm_tpu_torch.physics.cumulus.grell import cup
    from .test_cumulus_oracles import FP_GRELL, _grell_setup
    out = cup(*map(_t, _grell_setup()), 300.0, igcc=2)
    fp = (float(out.pratec[0]), float(out.outt[0].sum()),
          float(out.outq[0].sum()))
    for a, b in zip(fp, FP_GRELL):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-30)


def test_grell_convection():
    """Twin of tests/test_physics.py::test_grell_convection: a moist
    unstable column convects with the FC80 closure, a dry one does not."""
    from regcm_tpu_torch.physics.cumulus.grell import cup
    from .test_cumulus_oracles import _grell_setup
    out = cup(*map(_t, _grell_setup()), 300.0, igcc=2)
    assert bool(out.active[0]) and not bool(out.active[1])
    assert float(out.pratec[0]) * 86400.0 > 1.0
    assert float(out.pratec[1]) == 0.0
    assert float(out.outt[0].max()) * 86400.0 > 1.0
    assert float(out.outt[0].abs().max()) * 86400.0 <= 505.0
    assert bool(torch.isfinite(out.outt).all())


# -- Kuo --------------------------------------------------------------------
def _kuo_inputs(seed=5, ny=5, nx=6, kz=18):
    from regcm_tpu.utils.vertical import sigma_levels
    from regcm_tpu_torch.utils.thermo import pfwsat
    rng = np.random.default_rng(seed)
    sf, sh, dsg = sigma_levels(kz)
    ptop = 5.0
    psx = rng.uniform(94.0, 97.0, (ny, nx))
    p = sh[:, None, None] * psx[None] + ptop
    t = np.maximum(302.0 * (p / 101.325) ** 0.23, 205.0) \
        + rng.normal(0.0, 0.3, (kz, ny, nx))
    qv = pfwsat(_t(t), _t(p * 1000.0)).numpy() \
        * rng.uniform(0.6, 0.95, (1, ny, nx))
    qadv = np.zeros((kz, ny, nx))
    qadv[10:] = rng.uniform(-2e-6, 8e-6, (ny, nx))
    return t, qv, p, psx + ptop, qadv, sf, sh, dsg, ptop


def test_kuo_tables_equal():
    """build_kuo_tables: the port's copy gives the JAX package's tables
    exactly, at 18 and 23 levels."""
    from regcm_tpu.physics.cumulus.kuo import build_kuo_tables as jb
    from regcm_tpu.utils.vertical import sigma_levels
    from regcm_tpu_torch.physics.cumulus.kuo import build_kuo_tables
    for kz in (18, 23):
        sf, sh, dsg = sigma_levels(kz)
        for a, b in zip(build_kuo_tables(sf, sh, dsg, 5.0),
                        jb(sf, sh, dsg, 5.0)):
            np.testing.assert_array_equal(a, b)


def test_kuo_matches_jax():
    """kuo on a 5x6 grid with random moisture convergence: the trigger
    and the cloud layers equal, the tendencies and rain 1e-12."""
    from regcm_tpu.physics.cumulus.kuo import build_kuo_tables, kuo as jk
    from regcm_tpu_torch.physics.cumulus.kuo import kuo
    t, qv, p, psx, qadv, sf, sh, dsg, ptop = _kuo_inputs()
    tw, vq = build_kuo_tables(sf, sh, dsg, ptop)
    args = (t, qv, p, psx, qadv, sf, sh, dsg, tw, vq)
    want = jk(*map(_j, args), ptop, 7)
    got = kuo(*map(_t, args), ptop, 7)
    act = _np(want.active)
    assert act.any() and (~act).any()
    for k in ("active", "kbase", "ktop"):
        np.testing.assert_array_equal(_np(getattr(got, k)),
                                      _np(getattr(want, k)))
    for k in ("tten", "qvten", "prate"):
        assert _rel(getattr(got, k), getattr(want, k)) <= TOL, k


def test_kuo_convection():
    """Twin of tests/test_physics.py::test_kuo_convection: Kuo convects
    only with moisture convergence above qdcrit."""
    from regcm_tpu.utils.vertical import sigma_levels
    from regcm_tpu_torch.physics.cumulus.kuo import build_kuo_tables, kuo
    from regcm_tpu_torch.utils.thermo import pfwsat
    kz = 18
    sf, sh, dsg = sigma_levels(kz)
    ptop = 5.0
    ps = torch.full((3, 3), 96.325, dtype=torch.float64)
    p = _t(sh)[:, None, None] * ps[None] + ptop
    t = torch.clamp(302.0 * (p / 101.325) ** 0.23, min=205.0)
    qv = pfwsat(t, p * 1000.0) * 0.85
    qadv = torch.zeros((kz, 3, 3), dtype=torch.float64)
    qadv[12:, 1, 1] = 5e-6
    tw, vq = build_kuo_tables(sf, sh, dsg, ptop)
    out = kuo(t, qv, p, ps + ptop, qadv, _t(sf), _t(sh), _t(dsg), _t(tw),
              _t(vq), ptop, 7)
    assert bool(out.active[1, 1]) and not bool(out.active[0, 0])
    assert float(out.prate[1, 1]) > 0.0
    assert float(out.prate[0, 0]) == 0.0
    assert float(out.tten[:, 1, 1].max()) > 0.0
    assert bool(torch.isfinite(out.tten).all())


# -- Betts-Miller -----------------------------------------------------------
_BM_SIG = np.array([0.025, 0.075, 0.13, 0.195, 0.27, 0.35, 0.425, 0.5,
                    0.57, 0.64, 0.71, 0.78, 0.845, 0.895, 0.93, 0.96,
                    0.98, 0.993])                 # top-down


def _heights_topdown(t, p, ps):
    z = np.zeros_like(t)
    z[:, -1] = 287.0 * t[:, -1] / 9.81 * np.log(ps / p[:, -1])
    for k in range(t.shape[1] - 2, -1, -1):
        z[:, k] = z[:, k + 1] + 287.0 * 0.5 * (t[:, k] + t[:, k + 1]) \
            / 9.81 * np.log(p[:, k + 1] / p[:, k])
    return z


def _bm_inputs(seed=11, ncol=400):
    """Top-down columns, some under an inversion with dry air above (the
    shallow branch)."""
    from regcm_tpu_torch.utils.thermo import pfwsat
    rng = np.random.default_rng(seed)
    ps = rng.uniform(98000.0, 102000.0, ncol)
    p = _BM_SIG[None] * (ps[:, None] - 5000.0) + 5000.0
    pf = np.concatenate([np.full((ncol, 1), 5000.0),
                         0.5 * (p[:, 1:] + p[:, :-1]), ps[:, None]], 1)
    t = np.maximum(rng.uniform(290.0, 305.0, (ncol, 1))
                   * (p / ps[:, None]) ** 0.21, 200.0)
    pinv = rng.uniform(60000.0, 85000.0, (ncol, 1))
    t = t + rng.uniform(0.0, 8.0, (ncol, 1)) * (p < pinv)
    q = pfwsat(_t(t), _t(p)).numpy() * np.where(
        p < pinv, rng.uniform(0.05, 0.6, (ncol, 1)),
        rng.uniform(0.6, 1.0, (ncol, 1)))
    lm = (rng.uniform(size=ncol) > 0.5).astype(float)
    cld = rng.uniform(0.2, 1.0, ncol)
    return t, q, p, pf, _heights_topdown(t, p, ps), ps, lm, cld


def test_betts_miller_matches_jax():
    """bmpara on 400 columns over land and water (deep, shallow and
    quiet columns), the cloud from its extent and the water content:
    the cloud layers and cldefi equal, the tendencies and rain 1e-12."""
    import regcm_tpu.physics.cumulus.betts_miller as J
    import regcm_tpu_torch.physics.cumulus.betts_miller as T
    args = _bm_inputs()
    want = J.bmpara(*map(_j, args), 150.0)
    got = T.bmpara(*map(_t, args), 150.0)
    for k in ("kbot", "ktop"):
        np.testing.assert_array_equal(_np(getattr(got, k)),
                                      _np(getattr(want, k)))
    for k in ("tten", "qten", "prate", "cldefi"):
        assert _rel(getattr(got, k), getattr(want, k)) <= TOL, k
    touched = np.abs(_np(want.tten)).max(1) > 0.0
    rains = _np(want.prate) > 0.0
    assert rains.any() and (touched & ~rains).any() and (~touched).any()
    kz = _BM_SIG.size
    np.testing.assert_array_equal(
        T.model_cumulus_cloud(got.kbot, got.ktop, kz, 50.0).numpy(),
        np.asarray(J.model_cumulus_cloud(want.kbot, want.ktop, kz, 50.0)))
    assert _rel(T.clwfromt(_t(args[0])), J.clwfromt(_j(args[0]))) <= TOL


def test_betts_miller():
    """Twin of tests/test_physics.py::test_betts_miller: a moist column
    deep-convects, a dry one stays untouched."""
    from regcm_tpu_torch.physics.cumulus.betts_miller import AVGEFI, bmpara
    from regcm_tpu_torch.utils.thermo import pfwsat
    ps = 101300.0
    p = _BM_SIG * (ps - 5000.0) + 5000.0
    pf = np.concatenate([[5000.0], 0.5 * (p[1:] + p[:-1]), [ps]])
    t = np.maximum(302.0 * (p / ps) ** 0.21, 200.0)
    qs = pfwsat(_t(t), _t(p)).numpy()
    t2 = np.tile(t, (2, 1))
    q2 = np.stack([qs * 0.85, qs * 0.15])
    z = _heights_topdown(t2[:1], p[None], np.array([ps]))
    out = bmpara(_t(t2), _t(q2), _t(np.tile(p, (2, 1))),
                 _t(np.tile(pf, (2, 1))), _t(np.tile(z, (2, 1))),
                 torch.full((2,), ps, dtype=torch.float64),
                 torch.zeros(2, dtype=torch.float64),
                 torch.full((2,), AVGEFI, dtype=torch.float64), 150.0)
    tten = _np(out.tten)
    assert np.isfinite(tten).all() and np.isfinite(_np(out.qten)).all()
    assert float(out.prate[0]) > 0.0 and float(out.prate[1]) == 0.0
    assert np.abs(tten[1]).max() == 0.0
    assert int(out.ktop[0]) < int(out.kbot[0]) - 2
    assert tten[0, int(out.ktop[0])] > 0.0


# -- shallow convection -----------------------------------------------------
_SH_SIG = _BM_SIG[::-1]                           # bottom-up


def _shallow_inputs(seed=1, ncol=32):
    from regcm_tpu_torch.utils.thermo import pfwsat
    rng = np.random.default_rng(seed)
    kz = _SH_SIG.size
    ps = rng.uniform(990.0, 1010.0, ncol)
    p = _SH_SIG[None] * (ps[:, None] - 50.0) + 50.0
    t = np.maximum(300.0 * (p / ps[:, None]) ** 0.2857, 210.0) \
        + rng.normal(0.0, 0.3, (ncol, kz))
    t[:, 1] += 1.5
    t[:, 2] += 2.0
    rhp = np.concatenate([[0.97, 0.9, 0.8, 0.75, 0.7], [0.45] * 5,
                          [0.3] * 8])
    q = pfwsat(_t(t), _t(p * 100.0)).numpy() * rhp[None] \
        * rng.uniform(0.9, 1.02, (ncol, 1))
    tten = np.zeros((ncol, kz))
    qten = np.zeros((ncol, kz))
    tten[:, :3] = rng.uniform(0.0, 4.0, (ncol, 1)) / 3600.0
    qten[:, :4] = rng.uniform(0.0, 3e-3, (ncol, 1)) / 3600.0
    return t, q, tten, qten, p, ps, rng.uniform(0.0, 300.0, ncol)


def test_shallow_matches_jax():
    """shallcu on 32 forced boundary-layer columns: 1e-12 (the mass flux
    and both tendencies), the same columns active."""
    from regcm_tpu.physics.cumulus.shallow import shallcu as js
    from regcm_tpu_torch.physics.cumulus.shallow import shallcu
    args = _shallow_inputs()
    want = js(*map(_j, args), 300.0)
    got = shallcu(*map(_t, args), 300.0)
    on = _np(want.xmb) > 0.0
    assert on.any() and (~on).any()
    np.testing.assert_array_equal(_np(got.xmb) > 0.0, on)
    for k in ("outts", "outqs", "xmb"):
        assert _rel(getattr(got, k), getattr(want, k)) <= TOL, k


def test_shallow_convection():
    """Twin of tests/test_physics.py::test_shallow_convection: a forced
    unstable boundary layer convects without rain, below 400 hPa, about
    enthalpy-neutral; an unforced one does not."""
    from regcm_tpu_torch.physics.cumulus.shallow import shallcu
    from regcm_tpu_torch.utils.thermo import pfwsat
    kz = _SH_SIG.size
    ps = 1000.0
    p = _SH_SIG * (ps - 50.0) + 50.0
    t = np.maximum(300.0 * (p / ps) ** 0.2857, 210.0)
    t[1] += 1.5
    t[2] += 2.0
    qs = pfwsat(_t(t), _t(p * 100.0)).numpy()
    q = qs * np.concatenate([[0.97, 0.9, 0.8, 0.75, 0.7], [0.45] * 5,
                             [0.3] * 8])
    tten = np.zeros((2, kz))
    qten = np.zeros((2, kz))
    tten[0, :3] = 3.0 / 3600.0
    qten[0, :4] = 2.0e-3 / 3600.0
    out = shallcu(_t(np.tile(t, (2, 1))), _t(np.tile(q, (2, 1))),
                  _t(tten), _t(qten), _t(np.tile(p, (2, 1))),
                  torch.full((2,), ps, dtype=torch.float64),
                  torch.zeros(2, dtype=torch.float64), 300.0)
    outts, outqs = _np(out.outts), _np(out.outqs)
    assert np.isfinite(outts).all() and np.isfinite(outqs).all()
    assert float(out.xmb[0]) > 0.0 and float(out.xmb[1]) == 0.0
    assert float(np.abs(outts[:, p < 400.0]).max()) == 0.0
    dp = -np.gradient(p)
    mse = np.sum((c.cpd * outts[0] + c.wlhv * outqs[0]) * dp)
    scale = np.sum(np.abs(c.cpd * outts[0]) * dp) + 1e-30
    assert abs(mse) / scale < 0.6


# -- Kain-Fritsch -----------------------------------------------------------
def _kf_soundings():
    """Deep (test_kf's moist ascending column), subsidence, a capped
    boundary layer under an 8 K inversion at 1.8 km (the shallow
    fallback), and the deep column with cloud water and ice in it (the
    mixed-phase inputs); (4, 18) each."""
    from .test_kf import _sounding
    from regcm_tpu.physics.cumulus.kain_fritsch import (ALIQ, BLIQ, CLIQ,
                                                         DLIQ, EP2)
    deep, quiet = _sounding(), _sounding(w=-0.05)
    cap = {k: np.array(v) for k, v in _sounding(rh_lo=0.95).items()}
    z, p = cap["z0"][0], cap["p0"][0]
    t = cap["t0"][0] + 8.0 * np.clip((z - 1800.0) / 500.0, 0.0, 1.0)
    qes = EP2 * ALIQ * np.exp((BLIQ * t - CLIQ) / (t - DLIQ))
    qes = qes / (p - ALIQ * np.exp((BLIQ * t - CLIQ) / (t - DLIQ)))
    q = np.where(z > 1800.0, 0.2 * qes, 0.95 * qes)
    cap.update(t0=t[None], q0=q[None],
               rho=(p / (287.0 * t * (1 + 0.608 * q)))[None])
    mixed = {k: np.array(v) for k, v in deep.items()}
    tt = mixed["t0"]
    mixed["ql0"] = np.where((tt > 250.0) & (tt < 285.0), 2e-4, 0.0)
    mixed["qi0"] = np.where((tt > 220.0) & (tt < 262.0), 5e-5, 0.0)
    cols = [deep, quiet, cap, mixed]
    return {k: np.concatenate([np.asarray(s[k]) for s in cols])
            for k in deep}


@functools.lru_cache(maxsize=None)
def _kf_pair(f_qi):
    import regcm_tpu.physics.cumulus.kain_fritsch as J
    import regcm_tpu_torch.physics.cumulus.kain_fritsch as T
    a = _kf_soundings()
    want = J.kfpara(J.KFTables.build(5000.0), J.KFParams(),
                    **{k: _j(v) for k, v in a.items()}, dt=150.0, dx=60e3,
                    f_qi=f_qi)
    got = T.kfpara(T.KFTables.build(5000.0, "cpu"), T.KFParams(),
                   **{k: _t(v) for k, v in a.items()}, dt=150.0, dx=60e3,
                   f_qi=f_qi)
    return got, want


@pytest.mark.parametrize("f_qi", [False, True])
def test_kain_fritsch_matches_jax(f_qi):
    """kfpara on the deep, subsidence, shallow-fallback and mixed-phase
    soundings, without and with the ice feedback (f_qi): the trigger,
    the deep/shallow choice and the cloud layers equal, every tendency,
    the rain and the cloud 1e-12."""
    got, want = _kf_pair(f_qi)
    np.testing.assert_array_equal(_np(want.active),
                                  [True, False, True, True])
    np.testing.assert_array_equal(_np(want.ishall),
                                  [False, False, True, False])
    for k in ("active", "ishall", "ktop", "kbot", "timec"):
        np.testing.assert_array_equal(_np(getattr(got, k)),
                                      _np(getattr(want, k)))
    for k in ("dtdt", "dqdt", "dqcdt", "dqidt", "dqrdt", "dqsdt", "prate",
              "cldfra", "conv_ppt"):
        want_k = _np(getattr(want, k))
        if np.abs(want_k).max() == 0.0:
            assert _np(getattr(got, k)).max() == 0.0, k
        else:
            assert _rel(getattr(got, k), want_k) <= TOL, k
    if f_qi:
        assert np.abs(_np(want.dqidt)[3]).max() > 0.0


def test_kf_tables_equal():
    """kf_lutab/KFTables: the port's copy gives the JAX package's tables
    exactly."""
    import regcm_tpu.physics.cumulus.kain_fritsch as J
    import regcm_tpu_torch.physics.cumulus.kain_fritsch as T
    for ptop in (5000.0, 1000.0):
        want, got = J.KFTables.build(ptop), T.KFTables.build(ptop, "cpu")
        for k in ("ttab", "qstab", "the0k", "alu"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(want, k)))
        for k in ("plutop", "rdpr", "rdthk"):
            assert getattr(got, k) == getattr(want, k)


# twins of tests/test_kf.py
@pytest.fixture(scope="module")
def kf_tab():
    from regcm_tpu_torch.physics.cumulus.kain_fritsch import KFTables
    return KFTables.build(5000.0, "cpu")


def _thes_np(t, p, qs):
    from regcm_tpu_torch.physics.cumulus.kain_fritsch import C1, C2, C4, P00
    pi = (P00 / p) ** (0.2854 * (1.0 - 0.28 * qs))
    return t * pi * np.exp((C1 / t - C2) * qs * (1.0 + C4 * qs))


class TestKFOracles:
    def test_lutab_inverts_thetaes(self, kf_tab):
        """tpmix2dd inverts the Bolton theta_es to < 5 mK."""
        from regcm_tpu_torch.physics.cumulus.kain_fritsch import (
            ALIQ, BLIQ, CLIQ, DLIQ, EP2, tpmix2dd)
        for t, p in ((300.0, 95000.0), (280.0, 70000.0),
                     (255.0, 40000.0), (225.0, 20000.0)):
            es = ALIQ * np.exp((BLIQ * t - CLIQ) / (t - DLIQ))
            qs = EP2 * es / (p - es)
            tt, qq = tpmix2dd(kf_tab, _t(p), _t(_thes_np(t, p, qs)))
            assert abs(float(tt) - t) < 5e-3, (t, p)
            assert abs(float(qq) - qs) / qs < 1e-3

    def test_prof5_gaussian_oracle(self):
        """prof5 against a direct integration of the KF90 Eq. 2
        Gaussian mixed-fraction distribution."""
        from regcm_tpu_torch.physics.cumulus.kain_fritsch import prof5
        sigma, e45, fe = 1.0 / 6.0, np.exp(-4.5), 0.202765151
        x = np.linspace(0.0, 1.0, 200001)
        phi = (np.exp(-0.5 * ((x - 0.5) / sigma) ** 2) - e45) \
            / (sigma * np.sqrt(2.0 * np.pi))
        for eq in (0.3, 0.5, 0.7, 0.9):
            w = x <= eq
            ee_num = np.trapezoid(np.where(w, x * phi, 0.0), x) / fe \
                * sigma * np.sqrt(2.0 * np.pi)
            ud_num = np.trapezoid(np.where(~w, (1 - x) * phi, 0.0), x) \
                / fe * sigma * np.sqrt(2 * np.pi)
            ee, ud = prof5(_t(eq))
            assert abs(float(ee) - ee_num) < 2e-3, eq
            assert abs(float(ud) - ud_num) < 2e-3, eq
        e1, u1 = prof5(_t(0.5))
        np.testing.assert_allclose(float(e1), float(u1), rtol=1e-10)

    def test_condload_conserves_condensate(self):
        """condload: the change of condensate plus the fallout is the
        fresh condensate."""
        from regcm_tpu_torch.physics.cumulus.kain_fritsch import condload
        qliq, qice, qnl, qni = _t(2e-3), _t(1e-3), _t(5e-4), _t(2e-4)
        ql2, qi2, wtw, qlo, qio = condload(qliq, qice, _t(25.0), 600.0,
                                           0.5, 0.1, qnl, qni, 0.03)
        np.testing.assert_allclose(float(ql2 + qi2 + qlo + qio),
                                   float(qliq + qice + qnl + qni),
                                   rtol=1e-12)
        assert float(qlo) > 0.0 and float(wtw) > 0.0

    def test_envirtht_matches_bolton(self, kf_tab):
        from regcm_tpu_torch.physics.cumulus.kain_fritsch import (
            ALIQ, BLIQ, C1, C2, C4, CLIQ, DLIQ, EP2, P00, envirtht)
        t, p, q = 295.0, 90000.0, 0.012
        got = float(envirtht(kf_tab, _t(p), _t(t), _t(q)))
        e = q * p / (EP2 + q)
        tlog = np.log(e / ALIQ)
        tdpt = (CLIQ - DLIQ * tlog) / (BLIQ - tlog)
        tsat = tdpt - (0.212 + 1.571e-3 * (tdpt - 273.15)
                       - 4.36e-4 * (t - 273.15)) * (t - tdpt)
        want = (t * (P00 / p) ** (0.2854 * (1 - 0.28 * q))
                * np.exp((C1 / tsat - C2) * q * (1 + C4 * q)))
        np.testing.assert_allclose(got, want, rtol=2e-4)


def _kf_column(f_qi, **kw):
    from regcm_tpu_torch.physics.cumulus.kain_fritsch import KFParams, kfpara
    from regcm_tpu_torch.physics.cumulus.kain_fritsch import KFTables
    from .test_kf import _sounding
    a = _sounding(**kw)
    return a, kfpara(KFTables.build(5000.0, "cpu"), KFParams(),
                     **{k: _t(v) for k, v in a.items()}, dt=150.0, dx=60e3,
                     f_qi=f_qi)


def _water_closure(a, out):
    dp = np.asarray(a["rho"][0]) * 9.80665 * np.asarray(a["dzq"][0])
    dq = _np(out.dqdt[0] + out.dqcdt[0] + out.dqidt[0] + out.dqrdt[0]
             + out.dqsdt[0])
    np.testing.assert_allclose((dq * dp).sum() / 9.80665,
                               -float(out.prate[0]), rtol=1e-10)


class TestKFColumn:
    def test_deep_trigger_and_budget(self):
        """Deep convection triggers, warms aloft, rains and closes the
        column water budget to machine precision; subsidence stays
        quiet."""
        a, out = _kf_column(False)
        assert bool(out.active[0]) and not bool(out.ishall[0])
        assert float(out.prate[0]) > 1e-5
        assert _np(out.dtdt[0])[5:12].min() > 0.0
        assert 1800.0 <= float(out.timec[0]) <= 3600.0
        _water_closure(a, out)
        _, out_q = _kf_column(False, w=-0.05)
        assert not bool(out_q.active[0])
        assert float(out_q.dtdt.abs().max()) == 0.0

    def test_mixed_phase_feedback(self):
        """f_qi: ice detrainment in dqidt, the all-species budget
        closed."""
        a, out = _kf_column(True)
        assert bool(out.active[0])
        assert float(out.dqidt.abs().max()) > 0.0
        _water_closure(a, out)

    def test_shallow_fallback(self):
        """Weak forcing: if it convects, the shallow fallback with the
        TKE mass flux and no surface rain."""
        _, out = _kf_column(False, rh_lo=0.75, w=0.005)
        if bool(out.active[0]):
            assert bool(out.ishall[0]) and float(out.prate[0]) == 0.0
            assert float(out.timec[0]) == 600.0


class TestModelKF:
    def test_icup6_model_runs(self):
        """Twin of tests/test_kf.py::TestModelKF::test_icup6_model_runs,
        from RegCMConfig() (that test reads the reference's test_001.in):
        icup=6 builds, steps, stays finite, rains from a moistened low
        level and updates the running-mean w."""
        from regcm_tpu_torch.config.params import RegCMConfig
        from regcm_tpu_torch.driver import Model
        cfg = RegCMConfig()
        cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 14, 16, 18
        cfg.physics.icup_lnd = cfg.physics.icup_ocn = 6
        m = Model(cfg, device="cpu", dtype=torch.float64)
        qx = m.state.qx_a.clone()
        qx[0, 12:] = torch.maximum(qx[0, 12:], 0.012 * m.state.ps_a[None])
        m.state = m.state._replace(qx_a=qx, qx_b=qx.clone())
        for _ in range(4):
            m.step()
        s = m.state
        for f in ("t_a", "qx_a", "ps_a", "u_a", "rainc", "wavg"):
            assert bool(torch.isfinite(getattr(s, f)).all()), f
        assert float(s.rainc.max()) > 0.0
        assert float(s.wavg.abs().max()) > 0.0

    def test_kfparam_namelist_honored(self):
        from regcm_tpu_torch.config.params import RegCMConfig
        cfg = RegCMConfig.from_string(
            "&kfparam\n kf_entrate = 0.05,\n kf_max_pef = 0.8,\n/\n")
        assert cfg.kf.kf_entrate == 0.05
        assert cfg.kf.kf_max_pef == 0.8
        assert cfg.kf.kf_dpp == 150.0


# -- Model against the JAX package ------------------------------------------
@pytest.fixture(scope="module")
def port_models(jax_models):
    """Each setting: the port from the JAX run's initial state, and from
    that state with T changed by a relative 1e-15 (the trajectory's
    roundoff spread)."""
    out = {}
    rng = np.random.default_rng(0)
    for name in NAMES:
        s0 = jax_models[name]["start"]
        tname = "t" if R.CUMULUS[name]["idynamic"] == 3 else "t_a"
        t0 = np.asarray(getattr(s0, tname))
        s1 = s0._replace(**{tname: t0 * (1.0 + 1e-15 * rng.standard_normal(
            t0.shape))})
        out[name] = dict(port=R.port_run(name, s0),
                         perturbed=R.port_run(name, s1))
    return out


def _fields(run, idynamic):
    """The compared fields: decoupled ps, t, qv, u, v (and w), each
    hydrometeor, and the TKE under the UW TCM."""
    f = {k: run["dec"][k] for k in ("ps", "t", "qv", "u", "v")}
    qx = run["state"]["qx" if idynamic == 3 else "qx_a"]
    for n, q in enumerate(("qc", "qr", "qi", "qs")[:qx.shape[0] - 1],
                          start=1):
        f[q] = qx[n]
    if idynamic == 3:
        f["w"] = run["dec"]["w"]
    elif np.abs(run["state"]["tke_a"]).max() > 0.0:
        f["tke"] = run["state"]["tke_a"]
    return f


@pytest.mark.parametrize("name", NAMES)
def test_model_matches_jax(name, jax_models, port_models):
    """Three steps, every alarm on each: each field within the golden
    gate (rel-RMS 1e-7) or four times the port's own roundoff spread (the
    rule of tests/test_torch_model.py); a hydrometeor past it only at the
    few points where a threshold branch flipped (at most 1%)."""
    want_run = jax_models[name]
    r = port_models[name]
    idyn = R.CUMULUS[name]["idynamic"]
    assert r["port"]["finite"] and want_run["finite"]
    assert [tuple(f) for f in r["port"]["flags"]] == want_run["flags"]
    got = _fields(r["port"], idyn)
    want = _fields(want_run, idyn)
    spread = _fields(r["perturbed"], idyn)
    flipped = {}
    for k in got:
        s = _rel_rms(spread[k], got[k])
        err = _rel_rms(got[k], want[k])
        if err < max(1e-7, 4.0 * s):
            continue
        assert k in ("qc", "qr", "qi", "qs"), \
            f"{k}: rel-RMS {err:.3e}, roundoff spread {s:.3e}"
        off = np.abs(got[k] - want[k]) > 1e-7 * np.abs(want[k]).max()
        flipped[k] = int(off.sum())
        assert off.mean() <= 0.01, (k, err, s, flipped[k])
    print(f"{name}: points past 1e-7 by a branch flip: {flipped}")


def test_model_schemes_convect(jax_models):
    """The moistened hill convects in the JAX package's runs of C, Kuo,
    Betts-Miller and Kain-Fritsch (convective rain at some point), so
    the trajectory comparison covers the schemes' active branches."""
    for name in ("C", "kuo", "bm", "kf"):
        assert float(jax_models[name]["state"]["rainc"].max()) > 0.0, name


def test_c_runs_both_schemes():
    """Configuration C's grid has land and water, so Grell (land) and
    Emanuel (water) run on each cumulus step; the blend keeps Emanuel's
    cloud-base mass flux off the land points."""
    from regcm_tpu_torch.driver import Model
    cfg, grid = R.port_grid("C")
    assert 0.0 < float(np.mean(grid.lndocn)) < 1.0
    m = Model(cfg, grid=grid, device="cpu", initial_state=R.port_start("C"))
    suite = m.core.physics
    called = []
    one = suite._cumulus_one
    suite._cumulus_one = lambda icup, *a: called.append(icup) or one(
        icup, *a)
    m.run(2)                          # dtcum = dt: steps 0 and 1
    assert called == [2, 4, 2, 4]
    assert float(m.state.cbmf.numpy()[grid.lndocn > 0.5].max()) == 0.0


def test_kuo_defers_qv_vertical_advection(monkeypatch):
    """With Kuo the sigma-p cores hand the qv vertical advection to the
    scheme, which gives it back to the columns that do not convect: the
    suite flags it, the core leaves it out of qvten, and with no column
    convecting the step equals the one without Kuo."""
    from regcm_tpu_torch.driver import Model
    cfg, grid = R.port_grid("kuo")
    s0 = R.port_start("kuo")
    m = Model(cfg, grid=grid, device="cpu", initial_state=s0)
    assert m.core.physics.kuo_defer and m.core._kuo_defer()
    cfg0, _ = R.port_grid("kuo")
    cfg0.physics.icup_lnd = cfg0.physics.icup_ocn = 0
    m0 = Model(cfg0, grid=grid, device="cpu", initial_state=s0)
    assert not m0.core._kuo_defer()
    # no moisture convergence reaches qdcrit: Kuo convects nowhere
    import regcm_tpu_torch.physics.cumulus.kuo as K
    monkeypatch.setattr(K, "QDCRIT", 1.0e30)
    m.step()
    m0.step()
    for k in ("t_a", "qx_a", "ps_a", "u_a", "v_a"):
        assert R.max_rel(getattr(m.state, k).numpy(),
                         getattr(m0.state, k).numpy()) <= 1e-13, k


@pytest.mark.parametrize("icup", [2, 3, 6, -2])
def test_moloch_accepts_scheme(icup):
    """MolochCore runs Grell, Betts-Miller, Kain-Fritsch and shallow
    convection (the JAX package's MOLOCH hands the suite zero dynamics
    terms): one step, finite."""
    from regcm_tpu_torch.driver import Model
    cfg, grid = R.port_grid("grell_moloch")
    cfg.physics.icup_lnd = cfg.physics.icup_ocn = icup
    m = Model(cfg, grid=grid, device="cpu",
              initial_state=R.port_start("grell_moloch"))
    m.run(1)
    assert m.check_finite()


@pytest.mark.parametrize("overrides,match", [
    ((("physics", "icup_lnd", 1), ("physics", "icup_ocn", 1),
      ("core", "idynamic", 3)), r"icup=1 \(Kuo\).*MOLOCH"),
    ((("physics", "icup_lnd", 1), ("physics", "icup_ocn", 4)),
     r"icup=1 \(Kuo\) cannot be mixed"),
    ((("physics", "icup_lnd", -1), ("physics", "icup_ocn", 1)),
     r"icup=1 \(Kuo\) cannot be mixed"),
    ((("physics", "icup_lnd", 7),), r"icup_lnd=7 is not ported"),
    ((("physics", "irrtm", 1),), r"irrtm=1 \(RRTMG"),
    ((("physics", "ichem", 1),), r"chemistry \(ichem=1"),
])
def test_refusals(overrides, match):
    """What stays refused raises at model build and names it: Kuo on
    MOLOCH, Kuo mixed with another scheme or with none (icup_lnd=-1 is
    shallow convection and no deep scheme over land), an icup beyond 6,
    RRTMG (irrtm=1) and chemistry."""
    from regcm_tpu_torch.driver import Model
    cfg, _ = R.port_grid("C")
    for section, name, val in overrides:
        setattr(getattr(cfg, section), name, val)
    with pytest.raises((NotImplementedError, ValueError), match=match):
        Model(cfg, device="cpu")
