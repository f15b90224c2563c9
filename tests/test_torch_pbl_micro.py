"""The port's GFS and MYJ PBL schemes and the WSM5 microphysics against
the JAX package in f64 on the CPU: ``moninq`` on a sounding with a
stratocumulus deck under radiative cooling, ``myjpbl`` on its first and a
later step, ``wsm5`` warm, mixed-phase and with falling rain and snow,
each at 1e-12 from the same seeded numpy inputs (every column in the
same branch); the port's twins of the JAX package's GFS and MYJ
behaviour tests and of its MYJ ``prodq2`` oracle; and ``Model`` on
setting (iii) of ``tests/_torch_surface_settings`` (the MM5 NH core with
MYJ, the BATS ocean fluxes and nsg=2) for three steps at 14x16x14
against the JAX package's Model by the spread rule, its JAX run in a
spawned process started with the module."""
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from regcm_tpu.utils import constants as c  # noqa: E402

from . import _torch_surface_settings as S  # noqa: E402
from ._torch_jax_child import use_suite_cache  # noqa: E402

TOL = 1e-12
MODEL_SETTING = "nh_myj"


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


def _check(got, want, tol=TOL, tols=None):
    """Every field within ``tol`` of its largest value, a field named in
    ``tols`` within its own bound there."""
    tols = tols or {}
    for k in got._fields:
        err = _rel(getattr(got, k), getattr(want, k))
        assert err <= tols.get(k, tol), (k, err)


@pytest.fixture(scope="module", autouse=True)
def jax_model():
    """The JAX package's Model of setting (iii), in a spawned process
    started with the module."""
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"),
                             initializer=use_suite_cache) as pool:
        job = pool.submit(S.jax_run, MODEL_SETTING)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield job
        torch.set_num_threads(threads)


# -- GFS (moninq) -------------------------------------------------------------
_SIG18 = np.array([0.025, 0.075, 0.13, 0.195, 0.27, 0.35, 0.425, 0.5,
                   0.57, 0.64, 0.71, 0.78, 0.845, 0.895, 0.93, 0.96,
                   0.98, 0.993])[::-1]                # bottom-up


def _gfs_inputs(deck, seed=21, ncol=12):
    """moninq's bottom-up inputs on 18 levels, the column of
    tests/test_physics.py::test_gfs_pbl with seeded noise; with ``deck``
    a stratocumulus layer (cloud water above the critical 3.5e-5 at
    levels 3-5) cooled radiatively at its top in every column."""
    from regcm_tpu_torch.utils.thermo import pfwsat
    rng = np.random.default_rng(seed)
    kz = 18
    ps = 101325.0
    p = _SIG18 * (ps - 5000.0) + 5000.0
    pf = np.concatenate([[ps], 0.5 * (p[1:] + p[:-1]), [5000.0]])
    t0 = np.maximum(288.0 * (p / ps) ** 0.19, 216.0)
    t = t0[None] + 0.3 * rng.standard_normal((ncol, kz))
    dz = 287.0 * t0 / 9.81 * np.gradient(-np.log(p))
    z = np.cumsum(dz) - 0.5 * dz
    qs = pfwsat(_t(t), _t(np.tile(p, (ncol, 1)))).numpy()
    q = (qs * 0.5) / (1.0 + qs * 0.5)
    tile = lambda a: np.tile(a, (ncol, 1))
    ql = np.zeros((ncol, kz))
    thr = np.zeros((ncol, kz))
    if deck:
        ql[:, 3:6] = rng.uniform(2e-4, 4e-4, (ncol, 3))
        q[:, 3:6] = qs[:, 3:6] / (1.0 + qs[:, 3:6])
        thr[:, 5] = -rng.uniform(2e-4, 4e-4, ncol)
    u = 8.0 + rng.uniform(-1.0, 1.0, (ncol, kz)) \
        + 0.5 * np.arange(kz)[None]
    return (u, rng.uniform(-1.0, 1.0, (ncol, kz)), t, q, ql,
            tile(p) * 1e-3, tile(pf) * 1e-3,
            tile(np.abs(np.gradient(pf))[:-1]) * 1e-3,
            (tile(p) / c.stdp) ** c.rovcp,
            np.full(ncol, (ps / c.stdp) ** c.rovcp),
            tile(z) * 9.81, tile(np.concatenate([[0.0], np.cumsum(dz)])) * 9.81,
            thr, rng.uniform(0.1, 0.2, ncol), rng.uniform(3e-5, 6e-5, ncol),
            rng.uniform(0.06, 0.1, ncol), -rng.uniform(0.3, 0.7, ncol),
            rng.uniform(6.0, 9.0, ncol))


@pytest.mark.parametrize("deck", [False, True])
def test_moninq_matches_jax(deck):
    """moninq against the JAX package: the local K on every interface,
    and with the deck the cloud-top radiatively driven K (scuflg set in
    every column)."""
    from regcm_tpu.physics.pbl.gfs import moninq as jmoninq
    from regcm_tpu_torch.physics.pbl.gfs import moninq
    args = _gfs_inputs(deck)
    want = jmoninq(*map(_j, args), 300.0)
    got = moninq(*map(_t, args), 300.0)
    _check(got, want)


def test_gfs_pbl():
    """Twin of test_physics.py::test_gfs_pbl."""
    from regcm_tpu_torch.physics.pbl.gfs import moninq
    from regcm_tpu_torch.utils.thermo import pfwsat
    kz, ncol = 18, 4
    ps = 101325.0
    p = _SIG18 * (ps - 5000.0) + 5000.0
    pf = np.concatenate([[ps], 0.5 * (p[1:] + p[:-1]), [5000.0]])
    t = np.maximum(288.0 * (p / ps) ** 0.19, 216.0)
    dz = 287.0 * t / 9.81 * np.gradient(-np.log(p))
    z = np.cumsum(dz) - 0.5 * dz
    qs = pfwsat(_t(t), _t(p)).numpy()
    q = (qs * 0.5) / (1.0 + qs * 0.5)
    tile = lambda a: _t(np.tile(a, (ncol, 1)))
    full = lambda v: torch.full((ncol,), float(v), dtype=torch.float64)
    delk = tile(np.abs(np.gradient(pf))[:-1]) * 1e-3
    out = moninq(tile(np.full(kz, 8.0)), tile(np.zeros(kz)), tile(t),
                 tile(q), tile(np.zeros(kz)), tile(p) * 1e-3,
                 tile(pf) * 1e-3, delk, (tile(p) / c.stdp) ** c.rovcp,
                 full((ps / c.stdp) ** c.rovcp), tile(z) * 9.81,
                 tile(np.concatenate([[0.0], np.cumsum(dz)])) * 9.81,
                 tile(np.zeros(kz)), full(0.15), full(5e-5), full(0.09),
                 full(-0.5), full(8.0), 300.0)
    assert torch.isfinite(out.tau).all()
    assert float(out.tau[0, 0]) > 0.0
    assert float(out.rtgq[0, 0]) > 0.0
    assert float(out.du[0, 0]) < 0.0
    assert float(out.hpbl[0]) > 50.0
    colh = float((out.tau[0] * delk[0]).sum() / delk[0].sum())
    assert colh > 0.0


# -- MYJ (myjpbl) --------------------------------------------------------------
def _myj_inputs(seed=31, iy=3, jx=4):
    """tests/test_physics.py::test_myj_pbl's sheared column with seeded
    noise, cloud water at mid levels and ice aloft."""
    rng = np.random.default_rng(seed)
    kz = 18
    sig = (np.arange(kz) + 0.5) / kz
    p0 = 101325.0
    ones = np.ones((kz, iy, jx))
    patm = (sig[:, None, None] * (p0 - 5000) + 5000) * ones
    sigf = np.arange(kz + 1) / kz
    patmf = (sigf[:, None, None] * (p0 - 5000) + 5000) \
        * np.ones((kz + 1, iy, jx))
    t = (288.0 - 60 * (1 - sig))[:, None, None] * ones \
        + 0.2 * rng.standard_normal((kz, iy, jx))
    t[-1] += 1.5
    qv = np.maximum(1e-6, 0.008 * sig ** 2)[:, None, None] * ones
    qc = np.where((sig > 0.6) & (sig < 0.8), 1e-4, 0.0)[:, None, None] \
        * ones
    qi = np.where((sig > 0.2) & (sig < 0.4), 2e-5, 0.0)[:, None, None] \
        * ones
    u = (20.0 * (1 - sig))[:, None, None] * ones + 5.0 \
        + rng.uniform(-0.5, 0.5, (kz, iy, jx))
    v = rng.uniform(-1.0, 1.0, (kz, iy, jx))
    tv = t * (1 + 0.608 * qv)
    dzl = 287.0 * tv / 9.81 * np.log(patmf[1:]
                                     / np.maximum(patmf[:-1], 1.0))
    zq = np.zeros((kz + 1, iy, jx))
    for k in range(kz - 1, -1, -1):
        zq[k] = zq[k + 1] + dzl[k]
    ht = rng.uniform(0.0, 200.0, (iy, jx))
    tke = np.full((kz, iy, jx), 0.1) + rng.uniform(0.0, 0.3, (kz, iy, jx))
    tg = t[-1] + 1.0
    uvdrag = rng.uniform(0.03, 0.08, (iy, jx))
    lnd = np.zeros((iy, jx))
    lnd[:, :2] = 1.0
    return (t, qv, qc, qi, u, v, zq, ht, patm, patmf, tke, tg, qv[-1],
            uvdrag, lnd, tg * 1.02, qv[-1])


@pytest.mark.parametrize("five", [False, True])
@pytest.mark.parametrize("first", [True, False])
def test_myjpbl_matches_jax(first, five):
    """myjpbl on its first step (the surface layer set) and a later one
    (blended), with two or five water species."""
    from regcm_tpu.physics.pbl.myj import myjpbl as jmyj
    from regcm_tpu_torch.physics.pbl.myj import myjpbl
    args = _myj_inputs()
    want = jmyj(*map(_j, args), dt=300.0, five_species=five, first=first)
    got = myjpbl(*map(_t, args), dt=300.0, five_species=five, first=first)
    # T's, qc's and qi's tendencies are formed as (new − old)/dt: the
    # difference cancels ~1e-13 K of a potential temperature of 300-400 K
    # (and the like of qc, qi), which leaves up to 5.2e-12 of each
    # tendency's largest value between the packages (uten, vten ~4e-14)
    _check(got, want, tols=dict(tten=1e-11, qcten=1e-11, qiten=1e-11))


def test_myj_pbl():
    """Twin of test_physics.py::test_myj_pbl."""
    from regcm_tpu_torch.physics.pbl.myj import EPSQ2, myjpbl
    kz, iy, jx = 18, 3, 3
    sig = (np.arange(kz) + 0.5) / kz
    p0 = 101325.0
    ones = np.ones((kz, iy, jx))
    patm = (sig[:, None, None] * (p0 - 5000) + 5000) * ones
    sigf = np.arange(kz + 1) / kz
    patmf = (sigf[:, None, None] * (p0 - 5000) + 5000) \
        * np.ones((kz + 1, iy, jx))
    t = (288.0 - 60 * (1 - sig))[:, None, None] * ones
    t[-1] += 1.5
    qv = np.maximum(1e-6, 0.008 * sig ** 2)[:, None, None] * ones
    u = (20.0 * (1 - sig))[:, None, None] * ones + 5.0
    v = np.zeros_like(t)
    tv = t * (1 + 0.608 * qv)
    dzl = 287.0 * tv / 9.81 * np.log(patmf[1:]
                                     / np.maximum(patmf[:-1], 1.0))
    zq = np.zeros((kz + 1, iy, jx))
    for k in range(kz - 1, -1, -1):
        zq[k] = zq[k + 1] + dzl[k]
    tke = np.full((kz, iy, jx), 0.5 * EPSQ2)
    tg = t[-1] + 1.0
    out = myjpbl(*map(_t, (t, qv, np.zeros_like(t), np.zeros_like(t), u,
                           v, zq, np.zeros((iy, jx)), patm, patmf, tke, tg,
                           qv[-1], np.full((iy, jx), 0.05),
                           np.ones((iy, jx)), tg * 1.02, qv[-1])),
                 dt=300.0, first=True)
    for f in out:
        assert torch.isfinite(f).all()
    assert float(out.tkepbl[kz - 4:, 1, 1].max()) > 0.5 * EPSQ2 * 1.05
    assert float(out.uten.abs().max()) > 0.0
    assert bool((out.zpbl >= 0.0).all())


def test_myj_prodq2_oracle(monkeypatch):
    """Twin of test_oracles.py::test_myj_prodq2_oracle, by import: the JAX
    test's own NumPy transcription of the Fortran prodq2, run against the
    port's ``_prodq2`` in place of the JAX package's."""
    import types
    import regcm_tpu.physics.pbl as jpbl
    from regcm_tpu_torch.physics.pbl import myj as P
    from .test_oracles import test_myj_prodq2_oracle as oracle
    shim = types.ModuleType("myj")
    shim.__dict__.update({k: v for k, v in vars(P).items()
                          if k.isupper()})
    shim._prodq2 = lambda dt, *a: P._prodq2(dt, *map(_t, a))
    monkeypatch.setattr(jpbl, "myj", shim, raising=False)
    oracle()


# -- WSM5 -----------------------------------------------------------------------
def _wsm5_inputs(kind, seed=41, ncol=10, kz=18):
    """Bottom-up columns: ``warm`` (all above freezing, cloud water and
    rain), ``mixed`` (a freezing level at mid-column, cloud water, ice,
    snow and rain) or ``fall`` (heavy rain and snow aloft, so that they
    sediment through several levels in one call)."""
    from regcm_tpu_torch.utils.thermo import pfwsat
    rng = np.random.default_rng(seed)
    sig = _SIG18[:kz]
    ps = 100000.0 + 500.0 * rng.standard_normal(ncol)
    p = sig[None] * (ps[:, None] - 5000.0) + 5000.0
    t_sfc = 300.0 if kind == "warm" else 285.0
    t = np.maximum(t_sfc * (p / 1.0e5) ** 0.19, 215.0) \
        + 0.2 * rng.standard_normal((ncol, kz))
    if kind == "warm":
        t = np.maximum(t, 275.0)
    qs = pfwsat(_t(t), _t(p)).numpy()
    rh = np.clip(rng.uniform(0.85, 1.02, (ncol, kz)), 0.0, 1.05)
    qv = rh * qs
    warm = t > c.tzero
    qc = np.where(rh > 0.95, rng.uniform(1e-4, 5e-4, (ncol, kz)), 0.0)
    qr = np.where(warm, rng.uniform(0.0, 2e-4, (ncol, kz)), 0.0)
    qi = np.where(~warm, rng.uniform(0.0, 5e-5, (ncol, kz)), 0.0)
    qsn = np.where(~warm, rng.uniform(0.0, 2e-4, (ncol, kz)), 0.0)
    if kind == "fall":
        qr[:, 8:12] = 2e-3
        qsn[:, 12:15] = 1.5e-3
    dz = 287.0 * t / 9.81 * np.log(np.concatenate(
        [ps[:, None], 0.5 * (p[:, 1:] + p[:, :-1])], 1)
        / np.concatenate([0.5 * (p[:, 1:] + p[:, :-1]),
                          np.full((ncol, 1), 5000.0)], 1))
    den = p / (287.0 * t)
    return (t, qv, qc, qi, qr, qsn, p, dz, den, qs, rh)


@pytest.mark.parametrize("kind", ["warm", "mixed", "fall"])
def test_wsm5_matches_jax(kind):
    """wsm5 against the JAX package for a 600 s call (five minor loops)."""
    from regcm_tpu.physics.micro.wsm5 import wsm5 as jwsm5
    from regcm_tpu_torch.physics.micro.wsm5 import wsm5
    args = _wsm5_inputs(kind)
    want = jwsm5(*map(_j, args), 600.0)
    got = wsm5(*map(_t, args), 600.0)
    _check(got, want)
    if kind == "fall":
        assert float(np.asarray(want.rain).min()) > 0.0


def test_wsm5_budget():
    """WSM5 conserves water: the column's vapour and condensate lost
    equal the surface precipitation over the call (ρ·dz weighted)."""
    from regcm_tpu_torch.physics.micro.wsm5 import wsm5
    args = list(map(_t, _wsm5_inputs("fall")))
    out = wsm5(*args, 600.0)
    den, dz = args[8], args[7]
    w0 = sum(args[i] for i in (1, 2, 3, 4, 5))
    w1 = out.qv + out.qc + out.qi + out.qr + out.qs
    lost = ((w0 - w1) * den * dz).sum(dim=1)
    np.testing.assert_allclose(lost.numpy(), (out.rain * 600.0).numpy(),
                               rtol=1e-6)


# -- Model against the JAX package --------------------------------------------
def test_model_matches_jax(jax_model):
    """Setting (iii), three steps with every alarm: each field within the
    golden gate (rel-RMS 1e-7) or four times the largest of three seeds'
    roundoff spreads; the MYJ TKE and surface layer and the subcells'
    BATS pack within the same rule."""
    want = jax_model.result()
    got = S.port_run(MODEL_SETTING, want["start"])
    assert got["finite"] and want["finite"]
    assert got["flags"] == want["flags"]
    spreads = [S.port_run(MODEL_SETTING,
                          S.perturbed(MODEL_SETTING, want["start"], seed))
               for seed in range(3)]
    for k in got["fields"]:
        s = max(S.rel_rms(p["fields"][k], got["fields"][k])
                for p in spreads)
        err = S.rel_rms(got["fields"][k], want["fields"][k])
        assert err < max(1e-7, 4.0 * s), (k, err, s)
    S.check_active(MODEL_SETTING, want)
