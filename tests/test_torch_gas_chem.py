"""The gas-phase chemistry of the PyTorch port against the JAX package, in
float64 on the CPU, function by function from the same seeded numpy
inputs: both mechanisms' rate constants (``update_rconst``), right-hand
side and Jacobian at 1e-13; the batched Ros2 solver on a batch of box
states at 1e-10 (each species relative to its largest value over the
batch, or to 1 molec/cm³, ten times the solver's own atol, whichever is
larger), its chunked solve bit for bit the unchunked one; the photolysis
rates; the SNA equilibrium and its driver; the gas-phase driver of either mechanism on a 10x12x14 grid;
Tiedtke's convective tracer transport with and without ``lmfsmooth``;
K2's tracer form (its plain version) past 32 tracers; the chemical
boundary records (``chem_icbc``) and the boundary pair ``_chbc_pair``,
whole and on the blocks of a 2x2 mesh, and a Model's boundary relaxing
toward them."""
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from regcm_tpu.chem import cb6 as jcb6  # noqa: E402
from regcm_tpu.chem import cbmz as jcbmz  # noqa: E402
from regcm_tpu.chem import cbmz_driver as jdrv  # noqa: E402
from regcm_tpu.chem import jvalues as jjv  # noqa: E402
from regcm_tpu.chem import sna as jsna  # noqa: E402
from regcm_tpu_torch.chem import cb6 as tcb6  # noqa: E402
from regcm_tpu_torch.chem import cbmz as tcbmz  # noqa: E402
from regcm_tpu_torch.chem import cbmz_driver as tdrv  # noqa: E402
from regcm_tpu_torch.chem import jvalues as tjv  # noqa: E402
from regcm_tpu_torch.chem import sna as tsna  # noqa: E402

from .test_torch_physics import J, T  # noqa: E402

TOL = 1e-13
# mechanism -> (JAX module, port module, JAX jvals, port jvals)
MECHS = {"cbmz": (jcbmz, tcbmz, jjv.cbmz_jvals, tjv.cbmz_jvals),
         "cb6": (jcb6, tcb6, jcb6.cb6_jvals, tcb6.cb6_jvals)}
# a polluted boundary layer (ppb; the JAX package's tests/test_cbmz.py
# and tests/test_cb6.py box states)
BOX = {"cbmz": dict(NO=5.0, NO2=10.0, O3=50.0, CO=200.0, HCHO=5.0,
                    CH4=1800.0, C2H6=2.0, SO2=5.0, ISOP=1.0, PAR=20.0,
                    ETH=1.0, OLET=1.0, TOL=1.0, XYL=0.5, ALD2=1.0, H2O2=1.0,
                    HNO3=1.0, DMS=0.1, H2=500.0),
       "cb6": dict(NMOX=5.0, NDOX=10.0, OZN=50.0, CMON=200.0, FORM=5.0,
                   ETHA=2.0, SDIO=5.0, ISPR=1.0, ALKA=20.0, ETHE=1.0,
                   OLE=1.0, TOLN=1.0, XYLN=0.5, AALD=1.0, HPOX=1.0,
                   NTRC=1.0, BENZ=0.5, PRPA=2.0, ACET=1.0, MEOH=2.0)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-300)


def _rows(n, seed):
    """n cells' temperature, air density and photolysis inputs, the sun
    up in most of them (1, n) each."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(270.0, 305.0, (1, n))
    m = rng.uniform(50e3, 101e3, (1, n)) / (1.380658e-23 * t) * 1e-6
    cz = rng.uniform(-0.2, 1.0, (n,))
    alt = rng.uniform(0.0, 10.0, (1, n))
    ta, tb = (rng.uniform(0.0, 8.0, (1, n)) for _ in range(2))
    return t, m, cz, alt, ta, tb


def _jv(mech, cz, alt, ta, tb):
    _, _, jf, tf = MECHS[mech]
    return (jf(J(cz), J(alt), J(ta), J(tb)),
            tf(T(cz), T(alt), T(ta), T(tb)))


@functools.lru_cache(maxsize=None)
def _box(mech, n=96, seed=3):
    """A batch of box states: the polluted layer scaled per cell and
    species by 0.3-1.7, the fixed species, and the rate constants at
    each cell's temperature, density and sun (JAX's, as numpy)."""
    jm, tm, _, _ = MECHS[mech]
    rng = np.random.default_rng(seed)
    t, m, cz, alt, ta, tb = _rows(n, seed)
    var = np.zeros((n, jm.NVAR))
    for k, v in BOX[mech].items():
        var[:, jm.M.SPECIES.index(k)] = v * 1e-9 * m[0] \
            * rng.uniform(0.3, 1.7, n)
    wtr = rng.uniform(1e17, 5e17, n)
    if mech == "cbmz":
        var[:, jm.M.SPECIES.index("H2O")] = wtr
        fix = np.stack([0.22 * m[0], 0.78 * m[0]], axis=-1)
    else:
        fix = np.asarray(jcb6.fixed_species(J(m[0]), J(wtr)))
    jj, _ = _jv(mech, cz, alt, ta, tb)
    rc = np.asarray(jm.M.update_rconst(J(t), J(m), jj))[:, 0].T.copy()
    return var, fix, rc


@pytest.mark.parametrize("mech", sorted(MECHS))
def test_update_rconst_matches_jax(mech):
    """The rate constants of every reaction (photolysis, Arrhenius, the
    fall-off forms) at a batch of temperatures, densities and suns."""
    jm, tm, _, _ = MECHS[mech]
    t, m, cz, alt, ta, tb = _rows(64, 1)
    jj, tj = _jv(mech, cz, alt, ta, tb)
    want = np.asarray(jm.M.update_rconst(J(t), J(m), jj))
    got = tm.M.update_rconst(T(t), T(m), tj)
    assert got.shape == want.shape == (jm.NREACT, 1, 64)
    err = np.abs(got.numpy() - want) / np.maximum(np.abs(want), 1e-300)
    assert float(err.max()) <= TOL, float(err.max())
    assert (want[:, 0] > 0.0).any(axis=1).sum() >= jm.NREACT - 2


@pytest.mark.parametrize("mech", sorted(MECHS))
def test_fun_and_jac_match_jax(mech):
    """vdot and the dense Jacobian of each mechanism on seeded states, at
    1e-13 of their scale; the Jacobian against central differences of
    vdot too."""
    jm, tm, _, _ = MECHS[mech]
    var, fix, rc = _box(mech)
    fw = np.asarray(jm.fun(J(var), J(fix), J(rc)))
    fg = tm.fun(T(var), T(fix), T(rc))
    assert _rel(fg, fw) <= TOL
    jw = np.asarray(jm.jac(J(var), J(fix), J(rc)))
    jg = tm.jac(T(var), T(fix), T(rc))
    assert jg.shape == (var.shape[0], jm.NVAR, jm.NVAR)
    assert _rel(jg, jw) <= TOL
    # one column of the Jacobian by central differences of fun
    k = jm.M.SPECIES.index("NO2" if mech == "cbmz" else "NDOX")
    dv = np.zeros_like(var)
    dv[:, k] = 1e-4 * var[:, k]
    fd = (tm.fun(T(var + dv), T(fix), T(rc))
          - tm.fun(T(var - dv), T(fix), T(rc))) / T(2.0 * dv[:, k:k + 1])
    assert _rel(fd, jg[:, :, k]) < 1e-6


@pytest.mark.parametrize("mech", sorted(MECHS))
def test_integrate_matches_jax(mech):
    """The batched Ros2 over 150 s on 96 box states against the JAX
    package's: 1e-10 of each species' scale over the batch (of 1
    molec/cm³ at least; a species near the solver's atol, such as EPX2 at
    0.26 molec/cm³ in one cell, differs by 1e-9 of itself after the ~10
    steps that roundoff moves apart); the solve in chunks
    of 13 cells (the last padded with inert cells) equals the unchunked
    one bit for bit; the iterations, host syncs and chunk solves are
    counted."""
    jm, tm, _, _ = MECHS[mech]
    var, fix, rc = _box(mech)
    want = np.asarray(jm.integrate(J(var), J(fix), J(rc), 150.0))
    stats = {}
    got = tm.integrate(T(var), T(fix), T(rc), 150.0, stats=stats).numpy()
    err = np.abs(got - want) / np.maximum(np.abs(want).max(axis=0), 1.0)
    assert float(err.max()) <= 1e-10, float(err.max())
    no2 = jm.M.SPECIES.index("NO2" if mech == "cbmz" else "NDOX")
    assert float(np.abs(want[:, no2] / var[:, no2] - 1.0).max()) > 0.01
    assert stats["solves"] == stats["iterations"]
    assert 5 < stats["iterations"] <= 120
    assert stats["syncs"] == stats["iterations"] + 1
    cstats = {}
    chunked = tm.integrate(T(var), T(fix), T(rc), 150.0, chunk=13,
                           stats=cstats)
    assert torch.equal(chunked, torch.as_tensor(got))
    assert cstats["iterations"] == stats["iterations"]
    assert cstats["solves"] > cstats["iterations"]


def test_jvalues_match_jax():
    """The clear-sky channels, the cloud and altitude factors and both
    mechanisms' photolysis dicts at model levels."""
    rng = np.random.default_rng(8)
    cz = rng.uniform(-0.3, 1.0, (6, 7))
    alt, ta, tb = (rng.uniform(0.0, 12.0, (5, 6, 7)) for _ in range(3))
    for jf, tf in ((jjv.cbmz_jvals, tjv.cbmz_jvals),
                   (jcb6.cb6_jvals, tcb6.cb6_jvals)):
        want = jf(J(cz), J(alt), J(ta), J(tb))
        got = tf(T(cz), T(alt), T(ta), T(tb))
        assert set(got) == set(want)
        for k in want:
            assert _rel(got[k], want[k]) <= TOL, k
    assert _rel(tjv.cloud_factor(T(cz)[None], T(ta), T(tb)),
                jjv.cloud_factor(J(cz)[None], J(ta), J(tb))) <= TOL


def _grid_atms(seed, shape=(14, 10, 12)):
    """A seeded 10x12x14 atmosphere as the suite's ``atms`` (top-down
    levels, the top two above 10 kPa), numpy."""
    rng = np.random.default_rng(seed)
    kz, iy, jx = shape
    sig = np.linspace(0.06, 0.995, kz)[:, None, None]
    ps = rng.uniform(95e3, 101e3, (iy, jx))
    pb3 = sig * ps
    tb3 = 215.0 + 85.0 * sig + rng.uniform(-2.0, 2.0, shape)
    rho = pb3 / (287.04 * tb3)
    dzq = 287.04 * tb3 / 9.80665 * 0.07 / sig
    za = np.flip(np.cumsum(np.flip(dzq, 0), axis=0), 0) - 0.5 * dzq
    qc = np.where(rng.uniform(0, 1, shape) > 0.6,
                  rng.uniform(0.0, 4e-4, shape), 0.0)
    return dict(tb3=tb3, pb3=pb3, rhob3=rho, dzq=dzq, za=za, qcb3=qc,
                qvb3=0.016 * sig ** 3 * rng.uniform(0.4, 1.0, shape),
                rhb3=rng.uniform(0.2, 0.99, shape),
                coszrs=rng.uniform(-0.3, 1.0, (iy, jx)),
                rpsb=1.0 / (ps / 1000.0))


def _grid_tracers(spec, atms, seed):
    """Coupled tracers (ntr, kz, iy, jx): the CHBC climatology of each
    tracer scaled by 0.5-1.5, NH3, H2SO4 and the SNA aerosol added."""
    from regcm_tpu_torch.preproc.chem_icbc import climatic_chi
    rng = np.random.default_rng(seed)
    kz, iy, jx = atms["tb3"].shape
    chi = climatic_chi(spec, np.linspace(0.06, 0.995, kz),
                       rng.uniform(-30.0, 30.0, (iy, jx)), 6)
    chi = chi * rng.uniform(0.5, 1.5, chi.shape)
    for name, v in (("NH3", 2e-9), ("H2SO4", 1e-9), ("ANH4", 2e-10),
                    ("ANO3", 1e-10)):
        if name in spec.names:
            chi[spec.names.index(name)] += v * rng.uniform(0.0, 2.0,
                                                           (kz, iy, jx))
    return chi / atms["rpsb"][None, None]


@pytest.mark.parametrize("sim", ["CBMZ", "CB6"])
def test_gas_driver_matches_jax(sim):
    """``GasChemDriver`` (CBMZ and CB6) on a 10x12x14 grid over one 150 s
    step: the packing of the transported tracers into the solver's
    layout (the tracers outside the mechanism skipped), the photolysis
    under the clouds above and below, the stratosphere cutoff and kmin,
    the coupled tendency of every tracer within 1e-10 of its scale."""
    from regcm_tpu.chem.species import build_species as jspec
    from regcm_tpu.config.params import RegCMConfig as JConfig
    from regcm_tpu_torch.chem.species import build_species as tspec
    from regcm_tpu_torch.config.params import RegCMConfig as TConfig
    atms = _grid_atms(11)
    spec = tspec(sim)
    chib = _grid_tracers(spec, atms, 12)
    cpl = 1.0 / atms["rpsb"]
    jmk = jdrv.Cb6Driver if sim == "CB6" else jdrv.CbmzDriver
    tmk = tdrv.Cb6Driver if sim == "CB6" else tdrv.CbmzDriver
    want = np.asarray(jmk(JConfig(), None, jspec(sim))(
        {k: J(v) for k, v in atms.items()}, None, J(chib), J(cpl), 150.0))
    drv = tmk(TConfig(), spec)
    got = drv({k: T(v) for k, v in atms.items()}, None, T(chib), T(cpl),
              150.0).numpy()
    assert got.shape == want.shape == chib.shape
    for n in range(spec.ntr):
        assert _rel(got[n], want[n]) <= 1e-10, (spec.names[n],
                                                _rel(got[n], want[n]))
    assert float(np.abs(want).max()) > 0.0
    assert not want[:, 0].any()                # kmin
    assert not want[:, atms["pb3"] < 1e4].any()    # the cutoff
    assert drv.stats["iterations"] > 0
    assert drv.stats["solves"] == drv.stats["iterations"]


def test_sna_matches_jax():
    """The NH4NO3 dissociation constant, the forward SNA partition and the
    DCCB repartition tendency (``SnaDriver``) on a 10x12x14 grid."""
    from regcm_tpu.chem.species import build_species as jspec
    from regcm_tpu_torch.chem.species import build_species as tspec
    rng = np.random.default_rng(21)
    t = rng.uniform(250.0, 310.0, 500)
    rh = rng.uniform(0.0, 1.0, 500)
    assert _rel(tsna.nh4no3_kp(T(t), T(rh)),
                jsna.nh4no3_kp(J(t), J(rh))) <= TOL
    ts, ta, tn = (rng.uniform(0.0, 4e-7, 500) for _ in range(3))
    for g, w in zip(tsna.sna_equilibrium(*map(T, (ts, ta, tn, t, rh))),
                    jsna.sna_equilibrium(*map(J, (ts, ta, tn, t, rh)))):
        assert _rel(g, w) <= TOL
    atms = _grid_atms(22)
    spec = tspec("DCCB")
    chib = _grid_tracers(spec, atms, 23)
    cpl = 1.0 / atms["rpsb"]
    want = np.asarray(jsna.SnaDriver(jspec("DCCB"))(
        {k: J(v) for k, v in atms.items()}, None, J(chib), J(cpl), 150.0))
    got = tsna.SnaDriver(spec)({k: T(v) for k, v in atms.items()}, None,
                               T(chib), T(cpl), 150.0)
    assert _rel(got, want) <= TOL
    ianh4 = spec.names.index("ANH4")
    assert float(want[ianh4].max()) > 0.0


@pytest.mark.parametrize("lmfsmooth", [False, True])
def test_ctracer_matches_jax(lmfsmooth):
    """Tiedtke's convective tracer transport on the deep sounding's
    columns: each package's own ntiedtke fluxes (``ct_*``, with and
    without the lmfsmooth smoothing) and ctracer on five seeded tracers,
    the tendencies at 1e-10 of their scale."""
    from regcm_tpu.physics.cumulus.tiedtke import ctracer as jct
    from regcm_tpu_torch.physics.cumulus.tiedtke import ctracer as tct

    from .test_torch_schemes import _tiedtke_case, _tiedtke_pair
    got, want = _tiedtke_pair("deep", lmfsmooth=lmfsmooth)
    args, dtcum, _, _, _ = _tiedtke_case("deep")
    pf = np.asarray(args[8])
    rng = np.random.default_rng(31)
    npx, nk = pf.shape[0], pf.shape[1] - 1
    prof = np.exp(-((np.arange(nk) - (nk - 1)) / 5.0) ** 2)
    qtrac = 1e-8 * prof[None, :, None] * rng.uniform(0.5, 1.5, (npx, nk, 5))
    jout = type(want)(*[jnp.asarray(x) for x in want])
    w = np.asarray(jct(J(qtrac), jout, J(pf), dtcum))
    g = tct(T(qtrac), got, T(pf), dtcum)
    assert float(np.abs(w).max()) > 0.0
    assert _rel(g, w) <= 1e-10, _rel(g, w)


@functools.lru_cache(maxsize=None)
def _mixing_64(L=40, ntr=64):
    """K2's inputs at L levels with ntr seeded tracers, and the JAX mixing
    body's terms with them (numpy)."""
    from regcm_tpu.physics.cumulus import emanuel as jem

    from .test_torch_kernels import _mixing_inputs
    levels, unk, vnk, icb, ict, cloud = _mixing_inputs(seed=4, L=L)
    rng = np.random.default_rng(92)
    ncol = levels[0].shape[0]
    tra = rng.uniform(0.0, 1e-6, (ncol, L, ntr))
    trank = rng.uniform(0.0, 1e-6, (ncol, ntr))
    want = jax.jit(lambda *a: jem._mixing_body(
        *a[:18], jem._LayCF(L), tra=a[18], trank=a[19]))(
        *map(J, levels), J(unk), J(vnk), jnp.asarray(icb, jnp.int32),
        jnp.asarray(ict, jnp.int32), J(cloud), J(tra), J(trank))
    return (levels, unk, vnk, icb, ict, cloud, tra, trank,
            {k: np.asarray(v) for k, v in want.items()})


@pytest.mark.parametrize("ntr", [37, 50, 51, 64])
def test_emanuel_tracer_form_past_32_matches_jax(ntr):
    """K2's tracer form (its plain version, the one a CPU tensor takes)
    at the gas-phase tracer counts (CBMZ 37, DCCB 50, CB6 51) and the
    kernel's limit (64) against the JAX mixing body's contraction, each
    tracer's sums its own; 65 tracers are refused."""
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    levels, unk, vnk, icb, ict, cloud, tra, trank, want = _mixing_64()
    got = k2.emanuel_mixing(*map(T, levels), T(unk), T(vnk), T(icb),
                            T(ict), T(cloud),
                            tra=T(np.ascontiguousarray(tra[..., :ntr])),
                            trank=T(np.ascontiguousarray(trank[:, :ntr])))
    assert k2.MAX_TRACERS == 64
    assert got["sum_tra"].shape[-1] == ntr
    assert _rel(got["sum_tra"], want["sum_tra"][..., :ntr]) < 1e-12
    if ntr == 64:
        with pytest.raises(ValueError, match="ntr=65"):
            k2.emanuel_mixing(
                *map(T, levels), T(unk), T(vnk), T(icb), T(ict), T(cloud),
                tra=T(np.zeros(tra.shape[:2] + (65,))),
                trank=T(np.zeros((tra.shape[0], 65))))


def test_chbc_pair_matches_jax(tmp_path):
    """``Model._chbc_pair`` (the coupled chemical boundary pair from the
    CHBC records) against the JAX package's for the same surface
    pressures, on the whole domain and on each rank's block of a 2x2
    mesh; without a reader there is none."""
    from regcm_tpu.driver import Model as JModel
    from regcm_tpu.preproc.chem_icbc import CHBCReader as JReader
    from regcm_tpu.utils.calendar import Date as JDate
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.parallel.mesh import DomainMesh
    from regcm_tpu_torch.preproc.chem_icbc import (CHBCReader,
                                                   generate_chem_icbc)
    from regcm_tpu_torch.utils.calendar import Date
    cfg = RegCMConfig()
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 16, 20, 14
    cfg.chem.chemsimtype = "DCCB"
    cfg.globdat.gdate2 = 1990060200
    path = generate_chem_icbc(cfg, str(tmp_path / "d_CHBC.nc"))
    rng = np.random.default_rng(41)
    ps0, ps1 = (rng.uniform(94.0, 100.0, (16, 20)) for _ in range(2))
    ntr = 50
    jm = SimpleNamespace(_chbc=JReader(path), core=SimpleNamespace(ntr=ntr),
                         dtype=jnp.float64)
    jd0 = JDate.from_int(1990060106, "gregorian")
    want = [np.asarray(a) for a in JModel._chbc_pair(
        jm, jd0, jd0.add_hours(6), J(ps0), J(ps1), 21600.0)]
    assert want[0].shape == (ntr, 14, 16, 20) and float(want[0].max()) > 0
    assert float(np.abs(want[1]).max()) > 0.0
    d0 = Date.from_int(1990060106, "gregorian")
    meshes = [None] + [DomainMesh(2, 2, 16, 20, rank=r) for r in range(4)]
    for mesh in meshes:
        local = (lambda a: a) if mesh is None else mesh.local
        m = Model.__new__(Model)
        m.mesh, m.device, m.dtype = mesh, torch.device("cpu"), torch.float64
        m.core = SimpleNamespace(ntr=ntr)
        m._chbc = CHBCReader(path)
        got = m._chbc_pair(d0, d0.add_hours(6), T(local(ps0)),
                           T(local(ps1)), 21600.0)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), local(w), rtol=1e-15,
                                       atol=0.0)
        m._chbc = None
        assert m._chbc_pair(d0, d0, T(local(ps0)), T(local(ps1)),
                            1.0) == (None, None)


def test_chbc_boundary_relaxes_toward_records(tmp_path):
    """A Model from ICBC files with a CHBC file attached (``set_chem_bc``):
    the boundary pair equals ``_chbc_pair``'s and the lateral boundary
    relaxes the tracers toward the records, where without it they relax
    toward clean air."""
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.preproc.chem_icbc import (CHBCReader,
                                                   generate_chem_icbc)
    from regcm_tpu_torch.preproc.icbc import (ICBCReader,
                                              generate_synthetic_icbc)
    from regcm_tpu_torch.preproc.terrain import (build_grid_from_domain,
                                                 synthetic_topo,
                                                 write_domain)
    cfg = RegCMConfig()
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 14, 16, 14
    cfg.globdat.gdate2 = 1990060200
    cfg.physics.icup_lnd = cfg.physics.icup_ocn = 0
    cfg.physics.extras["rad_scheme"] = "broadband"
    cfg.physics.ichem = 1
    cfg.chem.chemsimtype = "SULF"
    topo, lnd, mask = synthetic_topo(cfg, kind="gauss", height=500.0)
    write_domain(cfg, str(tmp_path / "d_DOMAIN000.nc"), topo, lnd, mask)
    generate_synthetic_icbc(cfg, topo, str(tmp_path / "d_ICBC.nc"), jet=8.0)
    generate_chem_icbc(cfg, str(tmp_path / "d_CHBC.nc"))
    edge = {}
    for chbc in (False, True):
        m = Model(cfg, grid=build_grid_from_domain(
            cfg, str(tmp_path / "d_DOMAIN000.nc")), device="cpu")
        m.init_from_icbc(ICBCReader(str(tmp_path / "d_ICBC.nc")))
        assert m.bdy.chi0 is None
        if chbc:
            m.set_chem_bc(CHBCReader(str(tmp_path / "d_CHBC.nc")))
            d1 = m.date.add_hours(6)
            ps1 = m._icbc_to_state_fields(m._icbc.record_at(d1)[0])[0]
            want = m._chbc_pair(m.date, d1, m.bdy.ps0, ps1, 21600.0)
            assert torch.equal(m.bdy.chi0, want[0])
            assert torch.equal(m.bdy.chit, want[1])
        m.run_icbc(3)
        assert m.check_finite()
        chi = m.state.chi_a / m.state.ps_a[None, None]
        edge[chbc] = float(chi[:, :, 1].abs().max())
    assert edge[False] < 1e-3 * edge[True] and edge[True] > 0.0
