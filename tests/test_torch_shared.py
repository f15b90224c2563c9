"""The port's own copies of the JAX package's JAX-free modules (config,
grid, constants, projections, vertical, calendar, sun, vmodes, GHG and
CCM3 tables, the lake cold start, the Zarr writer, the ensemble
perturbation) give what the originals give. Both sides run the same numpy
code on the same inputs, so every comparison is exact."""
import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from regcm_tpu.config import params as jparams  # noqa: E402
from regcm_tpu.core import grid as jgrid  # noqa: E402
from regcm_tpu.dynamics import vmodes as jvm  # noqa: E402
from regcm_tpu.physics.radiation import ghg as jghg  # noqa: E402
from regcm_tpu.physics.radiation.ccm3 import tables as jtab  # noqa: E402
from regcm_tpu.utils import calendar as jcal  # noqa: E402
from regcm_tpu.utils import constants as jc  # noqa: E402
from regcm_tpu.utils import sun as jsun  # noqa: E402
from regcm_tpu_torch.config import params as tparams  # noqa: E402
from regcm_tpu_torch.core import grid as tgrid  # noqa: E402
from regcm_tpu_torch.dynamics import vmodes as tvm  # noqa: E402
from regcm_tpu_torch.physics.radiation import ghg as tghg  # noqa: E402
from regcm_tpu_torch.physics.radiation.ccm3 import tables as ttab  # noqa
from regcm_tpu_torch.utils import calendar as tcal  # noqa: E402
from regcm_tpu_torch.utils import constants as tc  # noqa: E402
from regcm_tpu_torch.utils import sun as tsun  # noqa: E402

OVERRIDES = {
    "default": {},
    "golden": {"dim.iy": 16, "dim.jx": 20, "dim.kz": 14, "geo.ds": 60.0,
               "time.dt": 150.0},
    "moloch_flagship": {"core.idynamic": 3, "dim.iy": 192, "dim.jx": 192,
                        "dim.kz": 41, "geo.ds": 3.0, "time.dt": 30.0},
    "dry_south": {"subex.conf": 0.0, "geo.clat": -30.0, "dim.kz": 23},
}


def configs(overrides):
    """RegCMConfig() of each package with the same overrides."""
    out = []
    for mod in (jparams, tparams):
        cfg = mod.RegCMConfig()
        for key, val in overrides.items():
            section, name = key.split(".")
            setattr(getattr(cfg, section), name, val)
        out.append(cfg)
    return out


def _equal(a, b, where):
    """Exact equality of nested numbers, arrays, dicts and sequences."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and not hasattr(a, "_fields"):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or hasattr(a, "_fields"):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=where)
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_config_matches_jax(case):
    jcfg, tcfg = configs(OVERRIDES[case])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for attr in ("dtsec", "ds_m"):
        assert getattr(tcfg, attr) == getattr(jcfg, attr)


def test_namelist_parse_matches_jax():
    from regcm_tpu.config.namelist import parse_namelist as jparse
    from regcm_tpu_torch.config.namelist import parse_namelist as tparse
    text = ("&dimparam\n iy = 34, jx = 48, kz = 18,\n/\n"
            "&geoparam\n iproj = 'LAMCON', ds = 60.0, clat = 45.39,\n"
            " truelatl = 30., truelath = 60.,\n/\n"
            "&physicsparam\n ibltyp = 1, lakemod = 0, ! a comment\n"
            " dtrad = 30., iocnflx = 2,\n/\n")
    _equal(jparse(text), tparse(text), "namelist")


def _hill(iy, jx, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(iy - 1), np.arange(jx - 1),
                         indexing="ij")
    return 800.0 * np.exp(-(((yy - iy / 2) / 3.5) ** 2
                            + ((xx - jx / 2) / 4.0) ** 2)) \
        + 20.0 * rng.random((iy - 1, jx - 1))


@pytest.mark.parametrize("case", ["golden_flat", "moloch_hill"])
def test_build_grid_matches_jax(case):
    if case == "golden_flat":
        jcfg, tcfg = configs(OVERRIDES["golden"])
        ht = None
    else:
        jcfg, tcfg = configs({"core.idynamic": 3, "dim.iy": 16,
                              "dim.jx": 20, "dim.kz": 14, "geo.ds": 10.0,
                              "time.dt": 60.0})
        ht = _hill(16, 20, seed=5)
    jg = jgrid.build_grid(jcfg, ht=ht)
    tg = tgrid.build_grid(tcfg, ht=ht)
    assert type(tg).__module__ == "regcm_tpu_torch.core.grid"
    for f in dataclasses.fields(jg):
        _equal(getattr(jg, f.name), getattr(tg, f.name), f.name)


def test_constants_and_split_coeffs_match_jax():
    names = [n for n in dir(jc) if not n.startswith("_")
             and isinstance(getattr(jc, n), (int, float))]
    assert len(names) > 50
    for n in names:
        assert getattr(tc, n) == getattr(jc, n), n
    jcfg, _ = configs(OVERRIDES["golden"])
    g = jgrid.build_grid(jcfg)
    a = jvm.make_split_coeffs(g.sigma, float(g.ptop), 2, jcfg.dtsec)
    b = tvm.make_split_coeffs(g.sigma, float(g.ptop), 2, jcfg.dtsec)
    for f in dataclasses.fields(a):
        _equal(getattr(a, f.name), getattr(b, f.name), f.name)


@pytest.mark.parametrize("scenario,year", [("RCP4.5", 1990.0),
                                          ("SSP585", 2050.0),
                                          ("CONST", 1950.0)])
def test_ghg_matches_jax(scenario, year):
    a = jghg.ghg_concentrations(scenario, year, 1950)
    b = tghg.ghg_concentrations(scenario, year, 1950)
    _equal(a, b, scenario)
    gases = dict(co2=a["co2ppm"], ch4=a["ch4ppb"], n2o=a["n2oppb"],
                 cfc11=a["cfc11ppt"], cfc12=a["cfc12ppt"])
    _equal(jtab.ghg_mmr(gases), ttab.ghg_mmr(gases), "ghg_mmr")


@pytest.mark.parametrize("date", [1990010100, 2000061512, 2023093018])
def test_sun_and_calendar_match_jax(date):
    jd = jcal.Date.from_int(date, "gregorian")
    td = tcal.Date.from_int(date, "gregorian")
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    later = 86400.0 * 40 + 600.0
    assert dataclasses.asdict(td.add_seconds(later)) == \
        dataclasses.asdict(jd.add_seconds(later))
    for kw in (dict(), dict(isolconst=1), dict(ifixsolar=1,
                                               fixedsolarval=1361.0)):
        _equal(jsun.solar_state(jd, **kw), tsun.solar_state(td, **kw),
               f"solar_state {kw}")
    jcfg, _ = configs(OVERRIDES["golden"])
    g = jgrid.build_grid(jcfg)
    decl = jsun.solar_state(jd).declin
    _equal(jsun.coszrs(jd, g.xlat, g.xlon, decl=decl),
           tsun.coszrs(td, g.xlat, g.xlon, decl=decl), "coszrs")


def test_ccm3_tables_match_jax():
    names = [n for n in dir(jtab) if not n.startswith("_")
             and isinstance(getattr(jtab, n), (int, float, np.ndarray))]
    assert len(names) > 60
    for n in names:
        _equal(getattr(jtab, n), getattr(ttab, n), n)
    _equal(jtab.o3_annual_profile(), ttab.o3_annual_profile(), "o3")


def test_ncio_round_trip_matches_jax(tmp_path):
    """A file written by each package's NCWriter (statics, two records,
    then one more appended) reads back the same through either read_nc,
    with the attributes."""
    from regcm_tpu.io import ncio as jnc
    from regcm_tpu_torch.io import ncio as tnc
    rng = np.random.default_rng(0)
    topo = rng.normal(size=(5, 7))
    recs = [rng.normal(size=(3, 5, 7)) for _ in range(3)]
    files = {}
    for name, mod in (("jax", jnc), ("port", tnc)):
        p = str(tmp_path / f"{name}.nc")
        w = mod.NCWriter(p, dims={"kz": 3, "iy": 5, "jx": 7},
                         attrs={"title": "round trip"})
        w.def_static("topo", ("iy", "jx"), topo, "m", "Surface elevation")
        w.def_time_var("t", ("kz", "iy", "jx"), "K", "Temperature")
        for n in range(2):
            w.write_record(6.0 * n, {"t": recs[n]})
        w.close()
        w = mod.NCWriter(p, dims={}, append=True)
        w.bind_time_var("t")
        w.write_record(12.0, {"t": recs[2]})
        w.close()
        files[name] = p
    for p in files.values():
        _equal(jnc.read_nc(p, with_attrs=True),
               tnc.read_nc(p, with_attrs=True), p)
    _equal(tnc.read_nc(files["jax"]), tnc.read_nc(files["port"]), "files")
    d = tnc.read_nc(files["port"])
    np.testing.assert_array_equal(d["time"], [0.0, 6.0, 12.0])
    np.testing.assert_array_equal(d["t"], np.asarray(recs, np.float32))


@pytest.mark.parametrize("kind", ["flat", "gauss", "ridge", "random"])
def test_terrain_matches_jax(kind, tmp_path):
    """synthetic_topo, smoothing, write_domain and build_grid_from_domain
    of each package: the same topography, DOMAIN file and grid."""
    from regcm_tpu.preproc import terrain as jter
    from regcm_tpu_torch.preproc import terrain as tter
    jcfg, tcfg = configs({"dim.iy": 20, "dim.jx": 28})
    jt = jter.synthetic_topo(jcfg, kind=kind, height=800.0, seed=3)
    tt = tter.synthetic_topo(tcfg, kind=kind, height=800.0, seed=3)
    _equal(jt, tt, "synthetic_topo")
    _equal(jter.smoothing(jt[0], 3), tter.smoothing(tt[0], 3), "smoothing")
    pj, pt = str(tmp_path / "j_DOMAIN000.nc"), str(tmp_path / "t_DOMAIN000.nc")
    jter.write_domain(jcfg, pj, *jt)
    tter.write_domain(tcfg, pt, *tt)
    _equal(jter.read_domain(pj), tter.read_domain(pt), "DOMAIN")
    jg = jter.build_grid_from_domain(jcfg, pt)
    tg = tter.build_grid_from_domain(tcfg, pj)
    for f in dataclasses.fields(jg):
        _equal(getattr(jg, f.name), getattr(tg, f.name), f.name)


def test_icbc_matches_jax(tmp_path):
    """synthetic_fields of each package (the port's saturation mixing
    ratio from its own utils.thermo) are equal, and an ICBC file written
    by either generate_synthetic_icbc gives the other's ICBCReader the
    same records, times and record indices."""
    from regcm_tpu.preproc import icbc as jic
    from regcm_tpu.preproc.terrain import synthetic_topo
    from regcm_tpu_torch.preproc import icbc as tic
    jcfg, tcfg = configs({"dim.iy": 20, "dim.jx": 28,
                          "globdat.gdate2": 1990060200})
    topo = synthetic_topo(jcfg, kind="gauss", height=900.0)[0]
    jd = jcal.Date.from_int(1990060106)
    td = tcal.Date.from_int(1990060106)
    _equal(jic.synthetic_fields(jcfg, topo, jd, jet=12.0),
           tic.synthetic_fields(tcfg, topo, td, jet=12.0),
           "synthetic_fields")
    pj, pt = str(tmp_path / "j_ICBC.nc"), str(tmp_path / "t_ICBC.nc")
    jic.generate_synthetic_icbc(jcfg, topo, pj, jet=12.0)
    tic.generate_synthetic_icbc(tcfg, topo, pt, jet=12.0)
    readers = [mod.ICBCReader(p) for mod in (jic, tic) for p in (pj, pt)]
    assert [r.nrec() for r in readers] == [5] * 4
    for r in readers[1:]:
        np.testing.assert_array_equal(r.times, readers[0].times)
    for hour in (0, 5, 6, 13, 24):
        when = jcal.Date.from_int(1990060100).add_hours(hour)
        when_t = tcal.Date.from_int(1990060100).add_hours(hour)
        want = readers[0].record_at(when)
        for r, d in zip(readers[1:], (when, when_t, when_t)):
            _equal(want, r.record_at(d), f"record at +{hour} h")


def test_init_lake_and_lake_grid_match_jax():
    """The port's numpy copy of the lake cold start (``init_lake``) and its
    ``build_grid`` with a DOMAIN lake depth give the JAX package's
    arrays."""
    from regcm_tpu.physics.surface.lake import init_lake as jinit
    from regcm_tpu_torch.physics.surface.lake import init_lake
    rng = np.random.default_rng(3)
    dh = rng.uniform(0.0, 150.0, (6, 7))
    xlat = rng.uniform(-60.0, 60.0, (6, 7))
    tg = rng.uniform(270.0, 305.0, (6, 7))
    _equal(init_lake(dh, xlat, tg, 60), jinit(dh, xlat, tg, 60), "init_lake")
    jcfg, tcfg = configs(OVERRIDES["golden"])
    dh = rng.uniform(0.0, 30.0, (15, 19))
    jg = jgrid.build_grid(jcfg, dhlake=dh)
    tg = tgrid.build_grid(tcfg, dhlake=dh)
    _equal(np.asarray(tg.extras["dhlake"]), np.asarray(jg.extras["dhlake"]),
           "dhlake")


@pytest.mark.parametrize("seed", [0, 7])
def test_ensemble_matches_jax(seed):
    """randify and random_pick of each package, from generators of one
    seed: the same numbers, exactly."""
    from regcm_tpu.utils import ensemble as jens
    from regcm_tpu_torch.utils import ensemble as tens
    a = np.random.default_rng(3).normal(size=(4, 6, 5))
    gens = [np.random.default_rng(seed) for _ in range(2)]
    for frac in (0.001, 0.05):
        _equal(jens.randify(a, frac, gens[0]), tens.randify(a, frac, gens[1]),
               f"randify {frac}")
    for total, nv in ((1.0, 5), (0.0, 3), (42.0, 9)):
        _equal(jens.random_pick(total, nv, gens[0]),
               tens.random_pick(total, nv, gens[1]), f"random_pick {nv}")


def test_zarr_store_matches_jax(tmp_path):
    """A store written by each package's ZarrWriter (statics, two
    records, then one more appended) has the same files, byte for byte,
    and reads back the same through either read_zarr."""
    from regcm_tpu.io import zarrio as jz
    from regcm_tpu_torch.io import zarrio as tz
    rng = np.random.default_rng(1)
    topo = rng.normal(size=(5, 7))
    recs = [rng.normal(size=(3, 5, 7)) for _ in range(3)]
    stores = {}
    for name, mod in (("jax", jz), ("port", tz)):
        p = str(tmp_path / f"{name}.zarr")
        w = mod.ZarrWriter(p, {"kz": 3, "iy": 5, "jx": 7}, {"title": "t"})
        w.def_static("topo", ("iy", "jx"), topo, "m", "Surface elevation")
        w.def_time_var("t", ("kz", "iy", "jx"), "K", "Temperature")
        for n in range(2):
            w.write_record(6.0 * n, {"t": recs[n]})
        w = mod.ZarrWriter(p, {"kz": 3, "iy": 5, "jx": 7}, append=True)
        w.bind_time_var("t")
        w.write_record(12.0, {"t": recs[2]})
        stores[name] = p
    files = {}
    for name, p in stores.items():
        files[name] = {os.path.relpath(os.path.join(d, f), p):
                       open(os.path.join(d, f), "rb").read()
                       for d, _, fs in os.walk(p) for f in fs}
    assert files["jax"] == files["port"]
    for p in stores.values():
        _equal(jz.read_zarr(p, with_attrs=True),
               tz.read_zarr(p, with_attrs=True), p)
    d = tz.read_zarr(stores["port"])
    np.testing.assert_array_equal(d["time"], [0.0, 6.0, 12.0])
    np.testing.assert_array_equal(d["t"], np.asarray(recs, np.float32))


@pytest.mark.parametrize("sim", ["DUST", "DU12", "SSLT", "DUSS", "CARB",
                                 "SULF", "SUCA", "AERO", "POLLEN", "CBMZ",
                                 "DCCB", "CB6"])
def test_chem_species_match_jax(sim):
    """The port's copy of the tracer registry gives each chemsimtype's
    tracer set, kinds, sizes, densities, solubilities, aging pairs and
    oxidant and gas-phase switches as the JAX package's (the gas-phase
    sets from each package's own mechanism tables)."""
    from regcm_tpu.chem import species as js
    from regcm_tpu_torch.chem import species as ts
    want = dataclasses.asdict(js.build_species(sim))
    got = dataclasses.asdict(ts.build_species(sim))
    _equal(got, want, sim)
    assert ts.build_species("") is None and js.build_species("") is None
    with pytest.raises(ValueError):
        ts.build_species("MINE")


@pytest.mark.parametrize("table", ["dust_optics", "drydep_gas", "oxclim",
                                   "cbmz_mech", "cb6_mech"])
def test_chem_tables_match_jax(table, tmp_path):
    """The port's copies of the dust optics and Zhang gas-deposition
    tables, and the tables of its twins of the CBMZ and CB6r2 mechanism
    modules (species, weights, stoichiometry, reactant indices, the
    tracer lists), equal the JAX package's; its oxidant climatology gives
    the JAX package's analytic fields on a grid, and reads an OXBC file
    in the run directory as the JAX package does."""
    if table == "oxclim":
        from regcm_tpu.chem import oxclim as jo
        from regcm_tpu_torch.chem import oxclim as to
        jcfg, tcfg = configs(OVERRIDES["golden"])
        jg, tg = jgrid.build_grid(jcfg), tgrid.build_grid(tcfg)
        sig = np.asarray(jg.hsigma)
        _equal(to.analytic_oxidants(np.asarray(tg.xlat), sig),
               jo.analytic_oxidants(np.asarray(jg.xlat), sig), "analytic")
        from scipy.io import netcdf_file
        shape = (1, 3, 4, 5)
        rng = np.random.default_rng(2)
        with netcdf_file(str(tmp_path / "domain_OXBC.1990.nc"), "w") as nc:
            for n, d in zip(("time", "kz", "iy", "jx"), shape):
                nc.createDimension(n, d)
            for v in ("OH", "HO2", "O3", "NO3", "H2O2"):
                nc.createVariable(v, "d", ("time", "kz", "iy", "jx"))[:] = \
                    rng.uniform(0.0, 1.0, shape)
        jcfg.globdat.dirglob = tcfg.globdat.dirglob = str(tmp_path)
        _equal(to.load_oxidants(tcfg, tg, sig),
               jo.load_oxidants(jcfg, jg, sig), "OXBC")
        return
    mods = {"dust_optics": "_dust_optics_data",
            "drydep_gas": "_drydep_gas_data", "cbmz_mech": "_cbmz_mech_data",
            "cb6_mech": "_cb6_mech_data"}[table]
    import importlib
    jm = importlib.import_module(f"regcm_tpu.chem.{mods}")
    tm = importlib.import_module(f"regcm_tpu_torch.chem.{mods}")
    names = sorted(n for n in dir(jm) if isinstance(getattr(jm, n),
                                                    np.ndarray))
    assert names and names == sorted(
        n for n in dir(tm) if isinstance(getattr(tm, n), np.ndarray))
    for n in names:
        _equal(getattr(tm, n), getattr(jm, n), n)
    lists = [n for n in dir(jm) if n.isupper()
             and isinstance(getattr(jm, n), (int, list))]
    for n in lists:
        _equal(getattr(tm, n), getattr(jm, n), n)


@pytest.mark.parametrize("sim", ["DCCB", "CB6"])
def test_chem_icbc_matches_jax(sim, tmp_path):
    """The port's copy of the chemical ICBC preprocessor writes the JAX
    package's CHBC records (the month-interpolated climatology of each
    tracer), over a month boundary, and each package's CHBCReader reads
    either file alike."""
    from regcm_tpu.preproc import chem_icbc as jch
    from regcm_tpu_torch.preproc import chem_icbc as tch
    jcfg, tcfg = configs(dict(OVERRIDES["golden"], **{
        "chem.chemsimtype": sim, "globdat.gdate1": 1990061418,
        "globdat.gdate2": 1990061512}))
    pj, pt = str(tmp_path / "j_CHBC.nc"), str(tmp_path / "t_CHBC.nc")
    jch.generate_chem_icbc(jcfg, pj)
    tch.generate_chem_icbc(tcfg, pt)
    date = tcal.Date.from_int(1990061500, tcfg.globdat.calendar)
    jdate = jcal.Date.from_int(1990061500, jcfg.globdat.calendar)
    for path in (pj, pt):
        jr, tr = jch.CHBCReader(path), tch.CHBCReader(path)
        assert tr.nrec() == jr.nrec() == 4 and tr.names == jr.names
        _equal(tr.record_at(date), jr.record_at(jdate), path)
    got, want = tch.CHBCReader(pt), jch.CHBCReader(pj)
    for n in range(want.nrec()):
        _equal(got.data["chi"][n], want.data["chi"][n], f"record {n}")
    assert float(np.max(want.data["chi"])) > 0.0
    xlat = np.asarray(tgrid.build_grid(tcfg).xlat)
    spec = tch.build_species(sim)
    _equal(tch.climatic_chi(spec, np.linspace(0.05, 0.995, 14), xlat, 12),
           jch.climatic_chi(spec, np.linspace(0.05, 0.995, 14), xlat, 12),
           "climatic_chi")
