"""The port's surface schemes against the JAX package in f64 on the CPU:
COARE 3.0 (iocnflx=3) over unstable and stable air, the BATS ocean fluxes
(iocnflx=1) and COARE through ``surface_fluxes``, the slab ocean with and
without restoring, the diurnal skin SST by day and by night, sea ice over
frozen and open water, the Hostetler lake with and without ice, each
column function at 1e-12 from the same seeded numpy
inputs (every column in the same branch); the port's twins of the JAX
package's behaviour tests of these schemes and of its subgrid test; and
``Model`` on two settings of ``tests/_torch_surface_settings`` (the band
with COARE and the slab ocean on the hydrostatic core; Zeng with the
skin SST, sea ice, the lake, WSM5 and GFS on MOLOCH), three steps at
14x16x14 against the JAX package's Model by the spread rule.

The JAX Model runs start with the module in two spawned processes and
run while the column tests do."""
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from . import _torch_surface_settings as S  # noqa: E402

TOL = 1e-12
MODEL_SETTINGS = ("band_slab", "moloch_sfc")


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


def _check(got, want, tol=TOL):
    """Every field of two NamedTuples (or sequences) within ``tol``."""
    fields = got._fields if hasattr(got, "_fields") \
        else range(len(got))
    for k in fields:
        g = getattr(got, k) if hasattr(got, "_fields") else got[k]
        w = getattr(want, k) if hasattr(want, "_fields") else want[k]
        assert _rel(g, w) <= tol, (k, _rel(g, w))


# -- the JAX package's Model, in spawned processes ----------------------
@pytest.fixture(scope="module", autouse=True)
def jax_jobs():
    """The JAX package's Model runs, started with the module."""
    with ProcessPoolExecutor(len(MODEL_SETTINGS),
                             mp_context=mp.get_context("spawn")) as pool:
        jobs = {n: pool.submit(S.jax_run, n) for n in MODEL_SETTINGS}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield jobs
        torch.set_num_threads(threads)


# -- thermodynamics -----------------------------------------------------
def test_cpmf_matches_jax():
    from regcm_tpu.utils.thermo import cpmf as jcpmf
    from regcm_tpu_torch.utils.thermo import cpmf
    q = np.random.default_rng(0).uniform(0.0, 0.03, (6, 7))
    assert _rel(cpmf(_t(q)), jcpmf(_j(q))) <= 1e-15


# -- COARE 3.0 ----------------------------------------------------------
def _coare_inputs(stable, seed=4, shape=(5, 6)):
    """Lowest-level air over the sea: unstable (a sea 6-9 K warmer than
    the air, the surface-referenced air 1-1.5 K warmer than the level:
    past the cool skin's 0.3 K, so that the sensible flux is upward at
    every point) or stable (a sea 4-6 K colder, a dry level, the surface
    air colder: downward at every point)."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, shape)
    tatm = u(286.0, 292.0)
    if stable:
        sst = tatm - u(4.0, 6.0)
        sfta = tatm - u(0.5, 1.0)
        qv = u(0.004, 0.006)
    else:
        sst = tatm + u(6.0, 9.0)
        sfta = tatm + u(1.0, 1.5)
        qv = u(0.008, 0.011)
    return (u(3.0, 12.0), u(-2.0, 2.0), tatm, qv, u(30.0, 50.0),
            u(100500.0, 102000.0), sfta, sst, u(400.0, 900.0),
            u(100.0, 400.0), u(30.0, 70.0), u(1.15, 1.25))


@pytest.mark.parametrize("stable", [False, True])
def test_coare3_matches_jax(stable):
    """COARE3 against the JAX package in both stability regimes (the
    profile functions' stable and unstable limbs, the cool skin on and
    off); the ice branch through ``icemask`` on half the points."""
    from regcm_tpu.physics.surface.coare import coare3 as jcoare3
    from regcm_tpu_torch.physics.surface.coare import coare3
    args = _coare_inputs(stable)
    want = jcoare3(*map(_j, args))
    got = coare3(*map(_t, args))
    sign = np.sign(np.asarray(want.sent))
    assert np.all(sign == (1.0 if not stable else -1.0))   # one regime
    _check(got, want)
    ice = np.zeros(args[0].shape)
    ice[:, :3] = 1.0
    _check(coare3(*map(_t, args), icemask=_t(ice)),
           jcoare3(*map(_j, args), icemask=_j(ice)))


def _surface_inputs(seed=6, shape=(6, 7)):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, shape)
    land = np.zeros(shape)
    land[:, :3] = 1.0
    tatm = u(285.0, 295.0)
    return dict(usw=u(2.0, 10.0), vsw=u(-3.0, 3.0), tatm=tatm,
                qvatm=u(0.005, 0.010), ht=u(30.0, 50.0), rhox=u(1.15, 1.25),
                sfps=u(100000.0, 102000.0), tg=tatm + u(-3.0, 3.0),
                sst=tatm + u(1.0, 4.0), landmask=land,
                swabs=u(100.0, 600.0), lwnet=u(-90.0, -40.0),
                prcp=u(0.0, 1e-4))


@pytest.mark.parametrize("iocnflx", [1, 2, 3])
def test_surface_fluxes_matches_jax(iocnflx):
    """``surface_fluxes`` with the BATS ocean fluxes, Zeng and COARE
    over the ocean points, the force-restore ground over land."""
    from regcm_tpu.physics.surface.fluxes import surface_fluxes as jsf
    from regcm_tpu_torch.physics.surface.fluxes import surface_fluxes
    a = _surface_inputs()
    want = jsf(**{k: _j(v) for k, v in a.items()}, dtsrf=600.0,
               iocnflx=iocnflx)
    got = surface_fluxes(**{k: _t(v) for k, v in a.items()}, dtsrf=600.0,
                         iocnflx=iocnflx)
    _check(got, want)


# -- slab ocean -----------------------------------------------------------
@pytest.mark.parametrize("restore", [True, False])
def test_slab_ocean_matches_jax(restore):
    from regcm_tpu.physics.surface.slab import update_slabocean as jslab
    from regcm_tpu_torch.physics.surface.slab import update_slabocean
    rng = np.random.default_rng(8)
    u = lambda lo, hi: rng.uniform(lo, hi, (5, 6))
    oc = u(0.0, 1.0) > 0.3
    args = (u(285.0, 300.0), u(285.0, 300.0), oc, u(0.0, 500.0),
            u(30.0, 90.0), u(-20.0, 60.0), u(0.0, 1e-4), 600.0)
    kw = dict(mixed_layer_depth=30.0, do_restore_sst=restore,
              sst_restore_timescale=3.0, qflux_adj=4.0)
    want = jslab(*[_j(a) if isinstance(a, np.ndarray) else a
                   for a in args], **kw)
    got = update_slabocean(*[torch.as_tensor(a) if isinstance(a, np.ndarray)
                             else a for a in args], **kw)
    _check(got, want)


# -- diurnal skin SST -----------------------------------------------------
@pytest.mark.parametrize("day", [True, False])
def test_dcsst_matches_jax(day):
    """Six steps of the warm layer and cool skin from a cold start, by
    day (900 W/m2 absorbed, a growing warm layer) or by night."""
    from regcm_tpu.physics.surface.dcsst import dcsst as jdcsst
    from regcm_tpu_torch.physics.surface.dcsst import dcsst
    rng = np.random.default_rng(9 if day else 10)
    u = lambda lo, hi: rng.uniform(lo, hi, (4, 5))
    ocn = np.zeros((4, 5))
    ocn[0, 0] = 1.0                       # one land point
    sw = u(800.0, 950.0) if day else np.zeros((4, 5))
    args = (u(298.0, 302.0), sw, u(50.0, 130.0), u(5.0, 30.0),
            u(2e-5, 8e-5), u(0.06, 0.3), u(1.1, 1.2))
    sj = jnp.zeros((3, 4, 5))
    st = torch.zeros((3, 4, 5), dtype=torch.float64)
    for _ in range(6):
        want = jdcsst(*map(_j, args), sj, _j(ocn), 600.0)
        got = dcsst(*map(_t, args), st, _t(ocn), 600.0)
        _check(got, want)
        sj, st = want.dcsst, got.dcsst


# -- sea ice -----------------------------------------------------------------
def _seaice_args(frozen, seed):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, (4, 5))
    sst = u(268.0, 270.5) if frozen else u(274.0, 280.0)
    return (u(258.0, 266.0), u(0.001, 0.003), u(2.0, 8.0), u(-2.0, 2.0),
            u(30.0, 50.0), u(1.25, 1.35), u(100000.0, 102000.0),
            u(0.0, 2e-4), u(20.0, 80.0), u(50.0, 90.0), sst)


@pytest.mark.parametrize("frozen", [True, False])
def test_seaice_matches_jax(frozen):
    """Five steps over frozen (SST below the trigger: ice forms, snow
    falls on it) or open water (no ice anywhere)."""
    from regcm_tpu.physics.surface.seaice import seaice as jseaice
    from regcm_tpu_torch.physics.surface.seaice import seaice
    args = _seaice_args(frozen, 12)
    ocn = np.zeros((4, 5))
    ocn[3, 4] = 1.0
    ij = jnp.zeros((4, 4, 5))
    it = torch.zeros((4, 4, 5), dtype=torch.float64)
    for _ in range(5):
        want = jseaice(*map(_j, args), ij, _j(ocn), 600.0)
        got = seaice(*map(_t, args), it, _t(ocn), 600.0)
        _check(got, want)
        ij, it = want.ice, got.ice
    iced = np.asarray(want.icemask)
    assert iced[:3].all() if frozen else not iced.any()


# -- Hostetler lake --------------------------------------------------------
def _lake_args(iced, seed=14, nlak=30):
    from regcm_tpu_torch.physics.surface.lake import init_lake
    rng = np.random.default_rng(seed)
    shape = (4, 5)
    u = lambda lo, hi: rng.uniform(lo, hi, shape)
    dh = u(8.0, 28.0)
    dh[0, 0] = 0.0                               # not a lake
    xlat = u(35.0, 55.0)
    tlak, eta, idep = init_lake(dh, xlat, u(280.0, 290.0), nlak)
    lakice = np.zeros(shape)
    lakhi = np.full(shape, 0.01)
    snow = np.zeros(shape)
    if iced:
        tlak[0] = -u(0.2, 1.0)
        tlak[1:4] = 0.5
        lakice = u(0.2, 0.4)
        lakhi = lakice.copy()
        snow = u(5.0, 20.0)
    tatm = u(258.0, 266.0) if iced else u(288.0, 294.0)
    lakmsk = (dh >= 2.0).astype(float)
    return (tatm, u(0.002, 0.009), u(2.0, 7.0), u(-2.0, 2.0),
            u(30.0, 50.0), u(200.0, 650.0), u(-90.0, -40.0),
            u(0.0, 1e-4), u(-10.0, 30.0), u(1e-5, 5e-5), u(1.15, 1.3),
            u(100000.0, 102000.0), tlak, lakhi, lakice, snow,
            np.zeros(shape), u(270.0, 290.0), eta, idep, lakmsk, xlat)


@pytest.mark.parametrize("iced", [False, True])
def test_lakedrv_matches_jax(iced):
    """One lake step open (eddy diffusion, the heat budget, the mixer)
    or under ice and snow (the secant surface temperature, melt or
    growth), then a second from the first's state."""
    from regcm_tpu.physics.surface.lake import lakedrv as jlake
    from regcm_tpu_torch.physics.surface.lake import lakedrv
    a = list(_lake_args(iced))
    b = list(a)
    for _ in range(2):
        want = jlake(*[_j(x) for x in a[:-4]],
                     jnp.asarray(a[-4]), jnp.asarray(a[-3]),
                     _j(a[-2]), _j(a[-1]), 600.0)
        got = lakedrv(*[_t(x) for x in b[:-4]], _t(b[-4]),
                      torch.as_tensor(b[-3]), _t(b[-2]), _t(b[-1]), 600.0)
        _check(got, want)
        a[12:17] = [np.asarray(x) for x in want[:5]]
        b[12:17] = [x for x in got[:5]]
    assert (np.asarray(want.lakice)[1:] > 0.0).all() == iced


# -- twins of tests/test_physics.py ----------------------------------------
def test_coare3_fluxes():
    """Twin of test_physics.py::test_coare3_fluxes."""
    from regcm_tpu_torch.physics.surface.coare import coare3
    f2 = lambda v: torch.full((4, 4), float(v), dtype=torch.float64)
    base = (f2(290.0), f2(0.010), f2(40.0), f2(101325.0), f2(290.2),
            f2(299.0), f2(600.0), f2(200.0), f2(50.0), f2(1.2))
    out = coare3(f2(6.0), f2(0.0), *base)
    assert torch.isfinite(out.sent).all() and torch.isfinite(out.evpr).all()
    assert float(out.evpr.min()) > 0.0
    assert float(out.drag.min()) > 0.0
    assert 0.05 < float(out.ustar.mean()) < 1.5
    assert 3.0 < float(out.u10.mean()) < 9.0
    out2 = coare3(f2(12.0), f2(0.0), *base)
    assert float(out2.evpr.mean()) > float(out.evpr.mean())
    assert float(out2.ustar.mean()) > float(out.ustar.mean())
    out3 = coare3(f2(6.0), f2(0.0), f2(290.0), f2(0.008), f2(40.0),
                  f2(101325.0), f2(290.2), f2(283.0), f2(600.0),
                  f2(200.0), f2(50.0), f2(1.2))
    assert float(out3.evpr.max()) == 0.0


def test_slab_ocean():
    """Twin of test_physics.py::test_slab_ocean."""
    from regcm_tpu_torch.physics.surface.slab import update_slabocean
    from regcm_tpu_torch.utils import constants as cc
    f2 = lambda v: torch.full((4, 4), float(v), dtype=torch.float64)
    ocmask = torch.ones((4, 4), dtype=torch.bool)
    ocmask[0, 0] = False
    sst = f2(290.0)
    s1, _ = update_slabocean(sst, sst, ocmask, f2(400.0), f2(60.0),
                             f2(20.0), f2(5e-5), 600.0)
    d = (s1 - sst).numpy()
    assert d[1, 1] > 0.0 and d[0, 0] == 0.0
    expect = 600.0 * (400.0 - 60.0 - 20.0 - cc.wlhv * 5e-5) / (50.0 * 4.0e6)
    assert abs(d[1, 1] - expect) < 1e-12
    s2, q2 = update_slabocean(sst, f2(295.0), ocmask, f2(0.0), f2(0.0),
                              f2(0.0), f2(0.0), 600.0)
    assert float(s2[1, 1]) > 290.0 and float(q2[1, 1]) > 0.0


def test_hostetler_lake():
    """Twin of test_physics.py::test_hostetler_lake."""
    from regcm_tpu_torch.physics.surface.lake import (
        _density, _lakemixer, init_lake, lakedrv)
    iy, jx, nlak = 6, 6, 40
    dh = np.zeros((iy, jx))
    dh[2:4, 2:4] = 30.0
    xlat = np.full((iy, jx), 45.0)
    tg0 = np.full((iy, jx), 288.0)
    tlak, eta, idep = init_lake(dh, xlat, tg0, nlak)
    assert tlak.shape == (nlak, iy, jx)
    assert float(eta[2, 2]) == -0.60 and int(idep[2, 2]) == 30
    prof = _t(np.where(np.arange(nlak)[:, None, None] < 5, 3.0, 10.0)
              * np.ones((nlak, iy, jx)))
    kbot = torch.as_tensor(idep, dtype=torch.int64) - 1
    kmask = torch.arange(nlak)[:, None, None] <= kbot[None]
    mixed = _lakemixer(prof, kmask, kbot)
    d0 = _density(prof).numpy()[:30, 2, 2]
    d1 = _density(mixed).numpy()[:30, 2, 2]
    jump0 = np.maximum(d0[:-1] - d0[1:], 0.0).max()
    jump1 = np.maximum(d1[:-1] - d1[1:], 0.0).max()
    assert jump1 < 0.3 * jump0
    np.testing.assert_allclose(mixed.numpy()[:30, 2, 2].sum(),
                               prof.numpy()[:30, 2, 2].sum(), rtol=1e-12)
    f2 = lambda v: torch.full((iy, jx), float(v), dtype=torch.float64)
    out = lakedrv(f2(290.0), f2(0.008), f2(3.0), f2(0.0), f2(40.0),
                  f2(600.0), f2(-60.0), f2(0.0), f2(10.0), f2(3e-5),
                  f2(1.2), f2(101325.0), _t(tlak), f2(0.01), f2(0.0),
                  f2(0.0), f2(0.0), _t(tg0), _t(eta), torch.as_tensor(idep),
                  _t(dh >= 2.0), _t(xlat), 600.0)
    assert torch.isfinite(out.tlak).all()
    assert float(out.tlak[0, 2, 2]) > float(tlak[0, 2, 2])
    np.testing.assert_allclose(out.tlak[:, 0, 0].numpy(), tlak[:, 0, 0])
    assert float(out.tg[2, 2]) > 273.0
    assert np.isfinite(float(out.sent[2, 2]))
    assert float(out.drag[2, 2]) > 0.0


def test_lake_in_model():
    """Twin of test_physics.py::test_lake_in_model, from ``RegCMConfig()``
    with test_012's selector (lakemod=1) in place of the namelist."""
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model
    cfg = RegCMConfig()
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 12, 14, 14
    cfg.geo.ds = 60.0
    cfg.time.dt = 150.0
    cfg.physics.lakemod = 1
    iy, jx = cfg.dim.iy, cfg.dim.jx
    lnd = np.ones((iy - 1, jx - 1))
    lnd[4:7, 4:7] = 0.0
    dh = np.zeros((iy - 1, jx - 1))
    dh[4:7, 4:7] = 25.0
    grid = build_grid(cfg, landmask=lnd, dhlake=dh)
    m = Model(cfg, grid=grid, device="cpu")
    t0 = m.state.tlak[:, 5, 5].clone()
    m.run(3)
    assert m.check_finite()
    assert float((m.state.tlak[:, 5, 5] - t0).abs().max()) > 0.0
    assert 260.0 < float(m.state.tg[5, 5]) < 310.0


def test_seaice():
    """Twin of test_physics.py::test_seaice."""
    from regcm_tpu_torch.physics.surface.seaice import ICETRIGGERT, seaice
    f2 = lambda v: torch.full((4, 4), float(v), dtype=torch.float64)
    sst = np.full((4, 4), 275.0)
    sst[0:2, :] = 270.0
    ice0 = torch.zeros((4, 4, 4), dtype=torch.float64)
    ocn = f2(0.0)
    out = seaice(f2(265.0), f2(0.0028), f2(5.0), f2(0.0), f2(40.0),
                 f2(1.3), f2(101325.0), f2(1e-4), f2(50.0), f2(60.0),
                 _t(sst), ice0, ocn, 600.0)
    assert torch.isfinite(out.ice).all()
    assert float(out.icemask[0, 0]) == 1.0 and float(out.icemask[3, 3]) == 0.0
    assert float(out.ice[0][0, 0]) > 0.01
    assert float(out.tg[0, 0]) <= ICETRIGGERT + 1e-6
    assert float(out.ice[1][0, 0]) > 0.0
    ice = out.ice
    for _ in range(5):
        ice = seaice(f2(260.0), f2(0.001), f2(5.0), f2(0.0), f2(40.0),
                     f2(1.3), f2(101325.0), f2(0.0), f2(20.0), f2(70.0),
                     _t(sst), ice, ocn, 600.0).ice
    assert torch.isfinite(ice).all()
    assert float(ice[0][0, 0]) >= float(out.ice[0][0, 0])


def test_dcsst_diurnal_skin():
    """Twin of test_physics.py::test_dcsst_diurnal_skin."""
    from regcm_tpu_torch.physics.surface.dcsst import dcsst
    f2 = lambda v: torch.full((4, 4), float(v), dtype=torch.float64)
    sstb, ocn = f2(300.0), f2(0.0)
    st = torch.zeros((3, 4, 4), dtype=torch.float64)
    for _ in range(12):
        out = dcsst(sstb, f2(900.0), f2(60.0), f2(8.0), f2(3e-5),
                    f2(0.08), f2(1.15), st, ocn, 600.0)
        st = out.dcsst
    assert torch.isfinite(st).all()
    tskin_day = float(out.tskin[1, 1])
    assert 300.05 < tskin_day < 304.0
    for _ in range(30):
        out = dcsst(sstb, f2(0.0), f2(120.0), f2(30.0), f2(8e-5),
                    f2(0.25), f2(1.15), st, ocn, 600.0)
        st = out.dcsst
    tskin_night = float(out.tskin[1, 1])
    assert tskin_night < tskin_day and tskin_night < 300.05


def test_subgrid_state_and_fluxes():
    """Twin of test_subgrid.py::test_subgrid_state_and_fluxes, from
    ``RegCMConfig()`` in place of test_001's namelist: nsg=2 with four
    landuse classes per land cell keeps a BATS state per subcell, whose
    ground temperatures part."""
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model
    cfg = RegCMConfig()
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 14, 18, 14
    cfg.dim.nsg = 2
    grid = S.subgrid_landuse(build_grid(cfg))
    m = Model(cfg, grid=grid, device="cpu")
    assert m.core.physics.nnsg == 4
    assert tuple(m.state.bats.shape[:2]) == (10, 4)
    m.run(6)
    assert m.check_finite()
    b = m.state.bats.numpy()
    land_all = (m.core.physics.lnd_sub.numpy() > 0.5).all(axis=0)
    spread = b[0].max(axis=0) - b[0].min(axis=0)
    assert float(spread[land_all].max()) > 1.0e-4
    assert float(m.state.hfx.abs().max()) < 1000.0


# -- Model against the JAX package -------------------------------------------
@pytest.fixture(scope="module")
def jax_models(jax_jobs):
    return {n: j.result() for n, j in jax_jobs.items()}


@pytest.mark.parametrize("name", MODEL_SETTINGS)
def test_model_matches_jax(name, jax_models):
    """Three steps, every alarm on each, from the JAX run's initial state:
    each field within the golden gate (rel-RMS 1e-7) or four times the
    largest of three seeds' roundoff spreads (a relative 1e-15 change of
    T); the surface models' state within the same rule."""
    want = jax_models[name]
    got = S.port_run(name, want["start"])
    assert got["finite"] and want["finite"]
    assert got["flags"] == want["flags"]
    spreads = [S.port_run(name, S.perturbed(name, want["start"], seed))
               for seed in range(3)]
    for k in got["fields"]:
        s = max(S.rel_rms(p["fields"][k], got["fields"][k])
                for p in spreads)
        err = S.rel_rms(got["fields"][k], want["fields"][k])
        assert err < max(1e-7, 4.0 * s), (k, err, s)
    S.check_active(name, want)
