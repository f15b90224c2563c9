"""Restart, output streams, ensemble perturbation, SOM q-flux and the
coupling contract of the PyTorch port against the JAX package, on the
CPU in f64 at small sizes, from configurations rebuilt on
``RegCMConfig()`` plus overrides.

Restart chains (n steps, save, load into a fresh Model, n steps) equal
the uninterrupted 2n steps bit for bit on each core; SAV files written by
either package load in the other exactly; each output stream's records
equal the JAX package's ``OutputStreams`` records for the same state
(the f64 records 1e-12 relative, the f32 files within 1 ulp), where the
JAX ``Model`` holds the port's state and omega and takes no step.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from regcm_tpu.config.params import RegCMConfig as JConfig  # noqa: E402
from regcm_tpu_torch.config.params import RegCMConfig as TConfig  # noqa
from regcm_tpu_torch.io.ncio import read_nc  # noqa: E402
from regcm_tpu_torch.io.zarrio import read_zarr  # noqa: E402

from ._torch_icbc_files import write_files  # noqa: E402
from . import _torch_parallel_ranks as R  # noqa: E402

N = 2      # steps before and after the restart

# core -> (idynamic, iy, jx, kz, ds, dt)
CORES = {"hydro": (1, 14, 16, 14, 60.0, 150.0),
         "nh": (2, 16, 20, 14, 10.0, 30.0),
         "moloch": (3, 16, 20, 14, 10.0, 60.0)}
# every stream on the hydrostatic core: the lake (LAK), two subcells a
# side (SUB), the slab ocean (SLABOC), Nogherotto-Tompkins (clr, cli,
# cls) and the UW TCM (tke)
ALL = dict(lakemod=1, islab_ocean=1, ipptls=2, ibltyp=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: the runs here are small, and the other test
    workers and their processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def setup(cfg, core, alarms=True, physics=None, nsg=1):
    """A RegCMConfig of either package at the core's small size; with
    ``alarms`` the run starts at noon (the sun up over the domain) and
    radiation comes at steps 0 and 2N-2, surface and cumulus every two
    steps, so that each fires after a restart at step N."""
    idyn, iy, jx, kz, ds, dt = CORES[core]
    cfg.core.idynamic = idyn
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = iy, jx, kz
    cfg.geo.ds, cfg.time.dt = ds, dt
    cfg.dim.nsg = nsg
    if alarms:
        cfg.restart.mdate1 = 1990060112
        cfg.time.dtrad = (2 * N - 2) * dt / 60.0
        cfg.time.dtsrf = 2 * dt
        cfg.time.dtcum = 2 * dt
    for k, v in (physics or {}).items():
        setattr(cfg.physics, k, v)
    return cfg


def start(core, grid, cfg):
    """The perturbed rest state each core starts from (whole domain)."""
    from regcm_tpu_torch import driver
    from regcm_tpu_torch.dynamics.moloch import MolochCore
    if core == "moloch":
        return MolochCore(grid, cfg, device="cpu").initial_state(perturb=0.3,
                                                                  seed=1)
    f = driver.nh_initial_state if core == "nh" \
        else driver.standard_atmosphere_state
    return f(grid, cfg, "cpu", torch.float64, perturb=0.3, seed=7)


def port_model(core, **kw):
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model
    cfg = setup(TConfig(), core, **kw)
    grid = build_grid(cfg)
    return Model(cfg, grid=grid, device="cpu",
                 initial_state=start(core, grid, cfg))


def whole(nt):
    return {k: v.numpy().copy() for k, v in nt._asdict().items()
            if v is not None and v.numel()}


def assert_same(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """Each core's restart chain: run A 2N steps with a SAV at step N,
    run B loaded from it for N steps; the states and boundaries."""
    d = tmp_path_factory.mktemp("chains")
    out = {}
    for core in CORES:
        a = port_model(core)
        a.run(N)
        sav = str(d / f"{core}_SAV.nc")
        a.save_restart(sav)
        at_n = whole(a.state)
        a.run(N)
        b = port_model(core)
        b.load_restart(sav)
        loaded = dict(state=whole(b.state), bdy=whole(b.bdy),
                      nstep=b.nstep, date=b.date, xbctime=b.xbctime)
        b.run(N)
        out[core] = dict(sav=sav, at_n=at_n, loaded=loaded,
                         a=dict(state=whole(a.state), bdy=whole(a.bdy),
                                date=a.date, nstep=a.nstep),
                         b=dict(state=whole(b.state), bdy=whole(b.bdy),
                                date=b.date, nstep=b.nstep),
                         model=b)
    return out


@pytest.mark.parametrize("core", list(CORES))
def test_restart_chain_is_bit_exact(core, chains):
    """tests/test_io.py:49's twin on each core: the SAV round trip is
    exact, and N steps after the load (a surface, cumulus and radiation
    alarm among them) give the uninterrupted run's state and boundary bit
    for bit."""
    c = chains[core]
    assert c["loaded"]["nstep"] == N
    assert_same(c["loaded"]["state"], c["at_n"], f"{core} SAV round trip")
    assert_same(c["b"]["state"], c["a"]["state"], f"{core} state")
    assert_same(c["b"]["bdy"], c["a"]["bdy"], f"{core} boundary")
    assert (c["b"]["date"], c["b"]["nstep"]) == (c["a"]["date"],
                                                 c["a"]["nstep"])


@pytest.mark.parametrize("core", ["hydro", "moloch"])
def test_port_sav_reads_in_jax(core, chains):
    """A SAV the port wrote reads through the JAX package's
    read_savefile with the same names, shapes and values, exactly."""
    from regcm_tpu.io.restart import read_savefile
    c = chains[core]
    fields, date, nstep, xbctime, bdy = read_savefile(c["sav"])
    assert_same(fields, c["at_n"], "state")
    assert_same(bdy, c["loaded"]["bdy"], "boundary")
    assert (nstep, date.to_seconds()) == (N, c["loaded"]["date"].to_seconds())
    assert xbctime == c["loaded"]["xbctime"]


def test_jax_sav_loads_in_port(tmp_path):
    """A SAV the JAX package wrote from its own state (no JAX step) loads
    in the port's Model as that state, boundary, date and counters,
    exactly; the zero-size tracer fields keep the port's template."""
    from regcm_tpu.core.grid import build_grid
    from regcm_tpu.core.state import bdy_from_state
    from regcm_tpu.driver import standard_atmosphere_state
    from regcm_tpu.io.restart import write_savefile
    from regcm_tpu.utils.calendar import Date
    jcfg = setup(JConfig(), "hydro")
    js = jax.device_get(standard_atmosphere_state(
        build_grid(jcfg), jcfg, jnp.float64, perturb=0.4, seed=2))
    jb = jax.device_get(bdy_from_state(js))
    path = str(tmp_path / "jax_SAV.nc")
    write_savefile(path, js, Date.from_int(1990060206), 42, 1234.5, bdy=jb)
    m = port_model("hydro")
    template = m.state.chi_a
    m.load_restart(path)
    for k in js._fields:
        np.testing.assert_array_equal(getattr(m.state, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    for k in jb._fields:
        if getattr(jb, k) is not None:
            np.testing.assert_array_equal(getattr(m.bdy, k).numpy(),
                                          np.asarray(getattr(jb, k)))
    assert m.state.chi_a.shape == template.shape
    assert (m.nstep, m.xbctime) == (42, 1234.5)
    assert (m.date.year, m.date.month, m.date.day, m.date.hour) == \
        (1990, 6, 2, 6)


def test_f32_state_restores_exactly(tmp_path):
    """An f32 model's state goes through the f64 file unchanged."""
    from regcm_tpu_torch.driver import Model
    cfg = setup(TConfig(), "moloch")
    a = Model(cfg, device="cpu", dtype=torch.float32)
    a.run(2)
    a.save_restart(str(tmp_path / "f32_SAV.nc"))
    b = Model(cfg, device="cpu", dtype=torch.float32)
    b.load_restart(str(tmp_path / "f32_SAV.nc"))
    for k, v in a.state._asdict().items():
        assert getattr(b.state, k).dtype == torch.float32
        assert torch.equal(getattr(b.state, k), v), k


# -- output streams against the JAX package ---------------------------------
STREAMS = ("atm", "srf", "rad", "sts", "lak", "sub", "slaboc")


def pair_cfgs(kind):
    """(JAX, port) configurations and grids of an output setting: "all"
    (the hydrostatic core with every stream) or "moloch"."""
    from regcm_tpu.core.grid import build_grid as jbuild
    from regcm_tpu_torch.core.grid import build_grid as tbuild
    core, physics, nsg = ("hydro", ALL, 2) if kind == "all" \
        else ("moloch", {}, 1)
    out = []
    for cls, build in ((JConfig, jbuild), (TConfig, tbuild)):
        cfg = setup(cls(), core, alarms=False, physics=physics, nsg=nsg)
        if kind == "all":
            dh = np.zeros((cfg.dim.iy - 1, cfg.dim.jx - 1))
            dh[3:6, 3:6] = 20.0                  # a 20 m lake
            grid = build(cfg, dhlake=dh)
            grid.lndocn[:, cfg.dim.jx // 2:] = 0.0    # an ocean half
        else:
            grid = build(cfg)
        out.append((cfg, grid))
    return out


def jax_twin(jcfg, jgrid, pm):
    """The JAX package's Model holding the port model's state, date, step
    count and omega (built without a step)."""
    from regcm_tpu.driver import Model as JModel
    if pm.idynamic == 3:
        from regcm_tpu.dynamics.moloch import MolochState as cls
    else:
        from regcm_tpu.core.state import HydroState as cls
    js = cls(**{k: jnp.asarray(getattr(pm.state, k).numpy())
                for k in cls._fields})
    jm = JModel(jcfg, grid=jgrid, dtype=jnp.float64, initial_state=js)
    sync(jm, pm)
    return jm


def sync(jm, pm):
    """Give the JAX model the port model's state, clock and omega."""
    cls = type(jm.state)
    jm.state = cls(**{k: jnp.asarray(getattr(pm.state, k).numpy())
                      for k in cls._fields})
    jm.date, jm.nstep = pm.date, pm.nstep
    om = pm.last_diags.get("omega")
    jm.last_diags = {} if om is None else {"omega": jnp.asarray(om.numpy())}


def recorded(streams):
    """Wrap each writer's write_record to keep (hours, record) copies."""
    log = {}
    for name in STREAMS:
        w = getattr(streams, name, None)
        if w is None:
            continue
        log[name] = []

        def rec(hours, fields, _w=w.write_record, _l=log[name]):
            _l.append((hours, {k: np.array(v, dtype=np.float64)
                               for k, v in fields.items()}))
            return _w(hours, fields)
        w.write_record = rec
    return log


def write_all(st, between):
    """Every stream once, STS over two steps (``between`` steps)."""
    st.sts_accumulate()
    between()
    st.sts_accumulate()
    st.write_sts()
    for w in (st.write_atm, st.write_srf, st.write_rad, st.write_lak,
              st.write_sub, st.write_slaboc):
        w()
    st.close()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """The output settings' stream pairs, each made when first asked for
    (``streams_of``)."""
    made = {}

    def streams_of(kind):
        if kind not in made:
            made[kind] = _streams_pair(kind, tmp_path_factory)
        return made[kind]
    return streams_of


@pytest.fixture(scope="module", params=["all", "moloch"])
def streams_pair(request, pairs):
    return pairs(request.param)


def _streams_pair(kind, tmp_path_factory):
    """An output setting's port and JAX streams, written from the same
    states: the recorded f64 records and the file directories."""
    from regcm_tpu.io.output import OutputStreams as JOut
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.io.output import OutputStreams as TOut
    (jcfg, jgrid), (tcfg, tgrid) = pair_cfgs(kind)
    pm = Model(tcfg, grid=tgrid, device="cpu")
    pm.run(2)
    jm = jax_twin(jcfg, jgrid, pm)
    d = tmp_path_factory.mktemp(kind)
    tst = TOut(pm, str(d / "port"), async_write=False)
    jst = JOut(jm, str(d / "jax"), async_write=False)
    tlog, jlog = recorded(tst), recorded(jst)
    jst.sts_accumulate()
    write_all(tst, lambda: (pm.step(), sync(jm, pm), jst.sts_accumulate()))
    write_all_jax = [jst.write_sts, jst.write_atm, jst.write_srf,
                     jst.write_rad, jst.write_lak, jst.write_sub,
                     jst.write_slaboc]
    for w in write_all_jax:
        w()
    jst.close()
    return dict(kind=kind, port=tlog, jax=jlog, dir=d, pm=pm, jm=jm)


def test_streams_open_as_jax(streams_pair):
    """The port opens the JAX package's streams for the setting, with
    the same file names."""
    p = streams_pair
    assert set(p["port"]) == set(p["jax"])
    want = {"all": set(STREAMS), "moloch": {"atm", "srf", "rad", "sts"}}
    assert set(p["port"]) == want[p["kind"]]
    assert sorted(os.listdir(p["dir"] / "port")) == \
        sorted(os.listdir(p["dir"] / "jax"))


@pytest.mark.parametrize("stream", STREAMS)
def test_stream_records_match_jax(stream, streams_pair):
    """The f64 records the port hands the writer equal the JAX package's
    for the same state: the same variables, times and values (1e-12
    relative to each field's scale)."""
    p = streams_pair
    if stream not in p["jax"]:
        assert stream not in p["port"]
        return
    got, want = p["port"][stream], p["jax"][stream]
    assert len(got) == len(want) == 1
    (th, tr), (jh, jr) = got[0], want[0]
    assert th == jh
    assert set(tr) == set(jr)
    for k, w in jr.items():
        scale = max(float(np.max(np.abs(w))), 1e-300)
        err = float(np.max(np.abs(tr[k] - w))) / scale if w.size else 0.0
        assert tr[k].shape == w.shape and err <= 1e-12, (stream, k, err)


def test_stream_files_match_jax_within_an_ulp(streams_pair):
    """Every variable of every file, statics included, within 1 ulp of
    float32 of the JAX package's file (the same f64 records rounded)."""
    p = streams_pair
    for fn in sorted(os.listdir(p["dir"] / "jax")):
        want = read_nc(str(p["dir"] / "jax" / fn))
        got = read_nc(str(p["dir"] / "port" / fn))
        assert set(got) == set(want), fn
        for k, w in want.items():
            np.testing.assert_array_max_ulp(got[k], w, maxulp=1)


def test_atm_record_is_the_decoupled_state(streams_pair):
    """The ATM record is Model.decoupled() cut to the interior, the winds
    rotated to earth-relative ones with the grid's rotcos and rotsin
    (uvrot2d), exactly."""
    p = streams_pair
    pm = p["pm"]
    dec = pm.decoupled()
    _, rec = p["port"]["atm"][0]
    cut = lambda a: a[..., :pm.grid.iy - 1, :pm.grid.jx - 1]
    for k, f in (("ta", "t"), ("hus", "qv"), ("clw", "qc"), ("ps", "ps")):
        np.testing.assert_array_equal(rec[k], cut(dec[f]), err_msg=k)
    rc, rs = (cut(np.asarray(pm.grid.extras[k])) for k in ("rotcos",
                                                           "rotsin"))
    u, v = cut(dec["u"]), cut(dec["v"])
    assert np.abs(rs).max() > 0.0
    np.testing.assert_array_equal(rec["ua"], u * rc - v * rs)
    np.testing.assert_array_equal(rec["va"], v * rc + u * rs)


def test_zarr_matches_netcdf(tmp_path):
    """tests/test_io.py:362's twin: the Zarr store of every stream holds
    the NetCDF files' variables and values, statics and time axis
    included."""
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.io.output import OutputStreams
    _, (tcfg, tgrid) = pair_cfgs("all")
    m = Model(tcfg, grid=tgrid, device="cpu")
    m.run(1)
    for backend in ("netcdf", "zarr"):
        st = OutputStreams(m, str(tmp_path / backend), backend=backend)
        write_all(st, lambda: None)
    names = sorted(os.listdir(tmp_path / "netcdf"))
    assert len(names) == len(STREAMS)
    for fn in names:
        nc = read_nc(str(tmp_path / "netcdf" / fn))
        zr = read_zarr(str(tmp_path / "zarr" / fn.replace(".nc", ".zarr")))
        assert set(zr) == set(nc), fn
        for k, v in nc.items():
            np.testing.assert_array_equal(zr[k], v, err_msg=f"{fn} {k}")


def test_output_restart_append(tmp_path):
    """tests/test_io.py:136's twin: a restarted run reopens the streams
    and appends (a record every 2 steps at dt 180 s): the ATM time axis
    grows and stays monotone, SRF has its variables, STS exists; and
    the ATM and RAD files equal an uninterrupted run's."""
    from regcm_tpu_torch.driver import Model

    def model():
        cfg = TConfig()
        cfg.dim.iy, cfg.dim.jx = 16, 24
        cfg.time.dt = 180.0
        cfg.out.atmfrq = cfg.out.srffrq = cfg.out.radfrq = 0.1
        return Model(cfg, device="cpu")
    outdir, whole_dir = str(tmp_path / "out"), str(tmp_path / "whole")
    m = model()
    m.open_output(outdir)
    m.run_with_output(3)
    m.streams.close()
    sav = str(tmp_path / "mid_SAV.nc")
    m.save_restart(sav)
    m2 = model()
    m2.load_restart(sav)
    m2.open_output(outdir, append=True)
    n0 = m2.streams.atm.nrec
    assert n0 >= 1
    m2.run_with_output(3)
    m2.streams.close()
    u = model()
    u.open_output(whole_dir)
    u.run_with_output(6)
    u.streams.close()
    files = sorted(os.listdir(outdir))
    pick = lambda s: [f for f in files if f"_{s}." in f][0]
    atm = read_nc(os.path.join(outdir, pick("ATM")))
    assert atm["time"].shape[0] > n0
    assert np.all(np.diff(atm["time"]) > 0)
    srf = read_nc(os.path.join(outdir, pick("SRF")))
    for v in ("tpr", "prcv", "uvdrag", "rsns", "rlns", "ts"):
        assert v in srf, f"SRF missing {v}"
    assert any("STS" in f for f in files)
    for s in ("ATM", "RAD"):
        got = read_nc(os.path.join(outdir, pick(s)))
        want = read_nc(os.path.join(whole_dir, pick(s)))
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=f"{s} {k}")


def test_sts_daily_statistics(tmp_path):
    """tests/test_io.py:180's twin: the accumulators update every step
    on the device, and a forced flush writes the STS record."""
    m = port_model("hydro", alarms=False)
    st = m.open_output(str(tmp_path / "sts"))
    for _ in range(3):
        m.step()
        st.sts_accumulate()
    d = st._sts
    assert d["tgmax"].shape == (m.grid.iy, m.grid.jx)
    assert bool((d["tgmax"] >= d["tgmin"]).all())
    st.write_sts()
    st.close()
    fn = [f for f in os.listdir(tmp_path / "sts") if "STS" in f][0]
    sts = read_nc(str(tmp_path / "sts" / fn))
    for v in ("tgmax", "tgmin", "pcpavg", "pcpmax", "psavg", "psmin",
              "sund"):
        assert v in sts and np.isfinite(sts[v]).all()


def test_chemistry_streams_refuse(streams_pair):
    """CHE and OPT are chemistry's: without it no stream is opened and the
    writers have nothing to write; with chemistry on MOLOCH the streams
    are refused (the JAX package's writers read the sigma-p cores'
    tracers, chi_a and ps_a; tests/test_torch_chem_model.py holds them on
    the hydrostatic core)."""
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.io.output import OutputStreams
    p = streams_pair
    st = OutputStreams(p["pm"], str(p["dir"] / "nochem"), async_write=False)
    assert st.che is None and st.opt is None
    st.write_che()
    st.write_opt()
    st.close()
    assert not any("CHE" in f or "OPT" in f
                   for f in os.listdir(p["dir"] / "nochem"))
    if p["kind"] == "moloch":
        _, (cfg, grid) = pair_cfgs("moloch")
        cfg.physics.ichem = 1
        cfg.chem.chemsimtype = "DUST"
        m = Model(cfg, grid=grid, device="cpu")
        with pytest.raises(NotImplementedError, match="CHE and OPT"):
            OutputStreams(m, str(p["dir"] / "chem"), async_write=False)


# -- ensemble, SOM and coupling ------------------------------------------
def test_ensemble_matches_jax(tmp_path):
    """O'Brien's perturbation drawn from one seed in the JAX package's
    order: the perturbed topography exactly, with the same draws made;
    the cold start and first
    boundary pair from the perturbed records 1e-12 relative; both
    generators then in the same state, and the next perturbed record
    equal exactly."""
    from regcm_tpu.driver import Model as JModel
    from regcm_tpu.preproc.icbc import ICBCReader as JReader
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    paths = write_files("hydro", str(tmp_path))
    jcfg, tcfg = R.ensemble_cfg(JConfig()), R.ensemble_cfg(TConfig())
    jm = JModel(jcfg, dtype=jnp.float64, physics=False)
    pm = Model(tcfg, device="cpu", physics=False)
    # the JAX package perturbs the grid it builds itself, which is flat:
    # the draws are made, and the topography stays as it was
    np.testing.assert_array_equal(pm.grid.ht, np.asarray(jm.grid.ht))
    assert pm._perturb_rng.bit_generator.state == \
        jm._perturb_rng.bit_generator.state
    jm.init_from_icbc(JReader(paths["icbc"], jcfg.globdat.calendar))
    pm.init_from_icbc(ICBCReader(paths["icbc"], tcfg.globdat.calendar))
    for part in ("state", "bdy"):
        j, t = getattr(jm, part), getattr(pm, part)
        for k in t._fields:
            w = getattr(j, k)
            if getattr(t, k) is None or not np.size(w):
                continue
            w = np.asarray(w)
            err = np.max(np.abs(getattr(t, k).numpy() - w)) \
                / max(np.max(np.abs(w)), 1e-300)
            assert err <= 1e-12, (part, k, err)
    assert pm._perturb_rng.bit_generator.state == \
        jm._perturb_rng.bit_generator.state
    rec, _ = ICBCReader(paths["icbc"]).record_at(pm.date)
    a, b = pm._maybe_perturb(rec), jm._maybe_perturb(rec)
    for k in ("ts", "ps", "t", "qv", "u", "v"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def som_file(path, iy, jx):
    """A SOM file of 12 monthly qflx records (W m-2), each a different
    field."""
    from regcm_tpu_torch.io.ncio import NCWriter
    rng = np.random.default_rng(9)
    w = NCWriter(path, {"iy": iy, "jx": jx})
    w.def_time_var("qflx", ("iy", "jx"), "W m-2", "q-flux")
    for mm in range(12):
        w.write_record(float(mm + 1), {"qflx": 50.0 * (mm + 1)
                                       + rng.normal(size=(iy, jx))})
    w.close()
    return path


def test_som_value_matches_jax(pairs, tmp_path):
    """attach_som and the mid-month interpolation of the monthly qflx
    equal the JAX package's exactly at dates across the year (the
    interior-extent file edge-replicated), and set bdy.qflb0."""
    from regcm_tpu_torch.utils.calendar import Date
    pm, jm = pairs("all")["pm"], pairs("all")["jm"]
    path = som_file(str(tmp_path / "SOM.nc"), pm.grid.iy - 1,
                    pm.grid.jx - 1)
    date0 = pm.date
    try:
        pm.attach_som(path)
        jm.attach_som(path)
        np.testing.assert_array_equal(pm.bdy.qflb0.numpy(),
                                      np.asarray(jm.bdy.qflb0))
        for when in (1990010100, 1990011512, 1990022812, 1990060100,
                     1990071618, 1990123118):
            pm.date = jm.date = Date.from_int(when)
            np.testing.assert_array_equal(pm._som_value().numpy(),
                                          np.asarray(jm._som_value()),
                                          err_msg=str(when))
    finally:
        pm.date = date0
        pm.bdy = pm.bdy._replace(qflb0=None)
        pm._som_qflx = None


def test_coupling_matches_jax(pairs):
    """tests/test_io.py:254's twin against the JAX package: rcm_put's
    exports 1e-12 relative; rcm_get with SST +2 K over water (MISSING
    elsewhere) moves core.sst as the JAX package's does, exactly. The
    sea-ice import is held to its formula: the JAX package's raises
    there (it writes into the read-only host view of a device array)."""
    from regcm_tpu.coupling import (ImportFields as JImport,
                                    rcm_get as jget, rcm_put as jput)
    from regcm_tpu_torch.coupling import (MISSING, ImportFields, rcm_get,
                                          rcm_put)
    pm, jm = pairs("all")["pm"], pairs("all")["jm"]
    sync(jm, pm)
    got, want = rcm_put(pm), jput(jm)
    for f in type(want).__dataclass_fields__:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f)
        scale = max(float(np.max(np.abs(w))), 1e-300)
        assert float(np.max(np.abs(g - w))) <= 1e-12 * scale, f
    assert 60000.0 < got.psfc.mean() < 106000.0
    water = np.asarray(pm.grid.lndocn) < 0.5
    sst0 = pm.core.sst.numpy().copy()
    sst = np.where(water, sst0 + 2.0, MISSING)
    sit = np.where(water, 0.3, MISSING)
    ice0 = pm.state.seaice.numpy().copy()
    state0 = pm.state
    try:
        rcm_get(pm, ImportFields(sst=sst, sit=sit))
        jget(jm, JImport(sst=sst))
        with pytest.raises(ValueError, match="read-only"):
            jget(jm, JImport(sit=sit))
        np.testing.assert_array_equal(pm.core.sst.numpy(),
                                      np.asarray(jm.core.sst))
        want = ice0.copy()
        want[0] = np.where(water, 0.3, ice0[0])
        np.testing.assert_array_equal(pm.state.seaice.numpy(), want)
        np.testing.assert_array_equal(pm.core.sst.numpy()[water],
                                      sst0[water] + 2.0)
        np.testing.assert_array_equal(pm.core.sst.numpy()[~water],
                                      sst0[~water])
    finally:
        pm.core.sst = torch.as_tensor(sst0)
        pm.state = state0


def test_run_logs_scalar_diagnostics(capsys):
    """Model.run(n, log_every) prints the JAX package's log line: the
    step, the date and the scalar diagnostics."""
    m = port_model("moloch", alarms=False)
    m.run(2, log_every=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[1].startswith("step 2 ")
    assert "wmax=" in lines[1] and "pmin=" in lines[1]
