"""``Model`` with chemistry against the JAX package, in f64 on the CPU,
from configurations rebuilt on ``RegCMConfig()`` plus overrides
(``tests/_torch_chem_settings``): the nine aerosol chemsimtypes on the
hydrostatic core (AERO with configuration E's physics, the tropical
band: Emanuel's tracer transport through K2's tracer form, the tracers'
Holtslag solve through K1, CCM3, COARE, the slab ocean; DUST with the
aerosol direct effect beside the well-mixed convective transport) and
DUST on MOLOCH (the tracers in K4's WAF stack), three steps at 14x16x14,
each field (the dynamics, every tracer at both time levels, the
emission and deposition totals) within the golden gate (rel-RMS 1e-7)
or four times the largest of three seeds' roundoff spreads. The JAX
runs start with the module in spawned processes, compiled with most of
XLA's optimisations off (half the compile time; three small steps do
not need them).

Then the twins of the JAX package's chemistry gates that read the
reference Testing corpus: the test_008 DUST model emits, the dust mass
budget closes, the direct effect cuts the surface SW; a SAV restart
chain carrying the tracers and the accumulators equals the
uninterrupted run bit for bit; and the CHE and OPT records equal the JAX
package's for the same state, on NetCDF and on Zarr."""
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from regcm_tpu_torch.config.params import RegCMConfig  # noqa: E402
from regcm_tpu_torch.core.grid import build_grid  # noqa: E402
from regcm_tpu_torch.driver import Model  # noqa: E402
from regcm_tpu_torch.io.ncio import read_nc  # noqa: E402
from regcm_tpu_torch.io.zarrio import read_zarr  # noqa: E402

from . import _torch_chem_settings as S  # noqa: E402
from ._torch_jax_child import use_suite_cache  # noqa: E402

# the JAX runs, a spawned process each group (one to two minutes each)
GROUPS = (("AERO", "DU12"), ("dust_moloch", "DUSS"),
          ("DUST", "SULF", "SSLT"), ("CARB", "SUCA", "POLLEN"))


@pytest.fixture(scope="module", autouse=True)
def jax_jobs():
    """The JAX package's Model runs, started with the module; torch on one
    thread meanwhile."""
    with ProcessPoolExecutor(len(GROUPS), mp_context=mp.get_context("spawn"),
                             initializer=use_suite_cache) as pool:
        jobs = [pool.submit(S.jax_run, g) for g in GROUPS]
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield jobs
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_models(jax_jobs):
    out = {}
    for j in jax_jobs:
        out.update(j.result())
    return out


def _check_model(name, want):
    got = S.port_run(name, want["start"])
    assert got["finite"] and want["finite"]
    assert got["flags"] == want["flags"]
    spreads = None
    for k in want["fields"]:
        err = S.rel_rms(got["fields"][k], want["fields"][k])
        if err < 1e-7:
            continue
        if spreads is None:     # run only where the golden gate is not met
            spreads = [S.port_run(name, S.perturbed(name, want["start"],
                                                    seed))
                       for seed in range(3)]
        s = max(S.rel_rms(p["fields"][k], got["fields"][k]) for p in spreads)
        assert err < max(1e-7, 4.0 * s), (name, k, err, s)
    return got


# -- twins of the JAX package's chemistry gates ------------------------------
def _test008(iy=20, jx=24, idirect=2, mdate1=None):
    """RegCM4's test_008 setting (DUST, the direct effect) on RegCMConfig()
    at a reduced size: the land a desert, as tests/test_chem.py's
    ``_build_model``."""
    cfg = RegCMConfig()
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = iy, jx, 18
    cfg.physics.ichem = 1
    cfg.chem.chemsimtype = "DUST"
    cfg.chem.idirect = idirect
    if mdate1:
        cfg.restart.mdate1 = mdate1
    ht, mask = S.R.terrain(cfg)
    g = build_grid(cfg, ht=ht, landmask=mask)
    g.extras["lveg"] = np.where(np.asarray(g.lndocn) > 0.5, 8, 15)
    return cfg, g


def _windy(m, wind=12.0):
    from regcm_tpu_torch.dynamics.stencil import cross2dot
    u = wind * cross2dot(m.state.ps_a)[None] * torch.ones_like(m.state.u_a)
    m.state = m.state._replace(u_a=u, u_b=u)
    return m


def test_008_builds_and_emits():
    """tests/test_chem.py:85's twin: the DUST model builds with the optics
    wired (idirect=2), and all four bins hold dust within four steps."""
    cfg, g = _test008()
    m = _windy(Model(cfg, grid=g, device="cpu"))
    assert m.core.ntr == 4 and m.core.physics.chem is not None
    assert m.core.physics.aertab is not None
    m.run(4)
    assert m.check_finite()
    assert float(m.state.chemdiag[0].sum()) > 0.0
    for b in range(4):
        assert float(m.state.chi_a[b].max()) > 0.0, b


def _burden(s, grid):
    dsig = torch.as_tensor(np.asarray(grid.dsigma))[None, :, None, None]
    return float((s.chi_a * dsig).sum() * 1000.0 / 9.80665)


def test_dust_mass_budget_closed():
    """tests/test_chem.py:107's twin: a calm run with a smooth surface dust
    blob and the lateral nudging zeroed loses, in six steps, the mass its
    accumulated deposition says, and emits nothing."""
    cfg = RegCMConfig()
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 20, 24, 18
    cfg.physics.ichem = 1
    cfg.chem.chemsimtype = "DUST"
    g = build_grid(cfg)
    g.nudge_fc[:] = 0.0
    g.nudge_gc[:] = 0.0
    m = Model(cfg, grid=g, device="cpu")
    iy, jx, kz = 20, 24, 18
    yy, xx = np.meshgrid(np.arange(iy), np.arange(jx), indexing="ij")
    horiz = np.exp(-(((yy - 10) / 3.0) ** 2 + ((xx - 12) / 3.0) ** 2))
    vert = np.exp(-((np.arange(kz) - (kz - 1)) / 2.0) ** 2)
    blob = torch.as_tensor(1e-5 * vert[:, None, None] * horiz[None])
    chi = blob[None] * m.state.ps_a[None, None] * torch.ones((4, 1, 1, 1),
                                                             dtype=blob.dtype)
    m.state = m.state._replace(chi_a=chi, chi_b=chi.clone())
    b0 = _burden(m.state, g)
    m.run(6)
    assert m.check_finite()
    lost = b0 - _burden(m.state, g)
    em, dd, wd = (float(m.state.chemdiag[n].sum()) for n in range(3))
    assert em == 0.0
    assert dd > 0.0
    np.testing.assert_allclose(lost, dd + wd - em, atol=2e-3 * b0, rtol=0.1)


def test_dust_direct_effect_cuts_surface_sw():
    """tests/test_chem.py:162's twin: at midday a dust layer (idirect=2)
    cuts the surface SW against the same layer with idirect=0."""
    sw = {}
    for idirect in (2, 0):
        cfg, g = _test008(16, 20, idirect, mdate1=2006060112)
        m = _windy(Model(cfg, grid=g, device="cpu"))
        chi = m.state.chi_a.clone()
        chi[:, 10:14] = 2e-5 * m.state.ps_a[None, None]
        m.state = m.state._replace(chi_a=chi, chi_b=chi.clone())
        m.step()
        assert m.check_finite()
        sw[idirect] = m.state.swsfc.numpy()
    assert (sw[0] - sw[2]).mean() > 0.5


def test_chem_restart_chain_bit_identical(tmp_path):
    """Three steps, a SAV file, three more from it in a fresh Model: the
    uninterrupted run's state bit for bit, the tracers and the
    accumulators included (AERO with E's physics, the band)."""
    name = "AERO"
    s0 = S.port_start(name)
    a = S.port_model(name, s0)
    a.run(3)
    a.save_restart(str(tmp_path / "chem.sav"))
    a.run(3)
    b = S.port_model(name, s0)
    b.load_restart(str(tmp_path / "chem.sav"))
    b.run(3)
    assert float(a.state.chemdiag.abs().max()) > 0.0
    for k, v in a.state._asdict().items():
        assert torch.equal(getattr(b.state, k), v), k


def test_che_opt_streams_match_jax(tmp_path):
    """The CHE and OPT records of the test_008 setting after two steps
    equal the JAX package's OutputStreams records for the same state
    (1e-12 of each field's scale; OPT's interface pressures take the hPa
    surface pressure times 1000 in both packages); run_with_output with
    chemfrq every two steps writes NetCDF and Zarr stores that agree
    record for record."""
    from regcm_tpu.config.params import RegCMConfig as JConfig
    from regcm_tpu.core.grid import build_grid as jbuild
    from regcm_tpu.driver import Model as JModel
    from regcm_tpu.io.output import OutputStreams as JOut
    from regcm_tpu_torch.io.output import OutputStreams as TOut
    cfg, g = _test008(14, 16)
    m = _windy(Model(cfg, grid=g, device="cpu"))
    m.run(2)
    jcfg = JConfig()
    for sec in ("dim", "physics", "chem"):
        for k, v in vars(getattr(cfg, sec)).items():
            setattr(getattr(jcfg, sec), k, v)
    ht, mask = S.R.terrain(jcfg)
    jg = jbuild(jcfg, ht=ht, landmask=mask)
    jg.extras["lveg"] = np.asarray(g.extras["lveg"])
    from regcm_tpu.core.state import HydroState as cls
    jm = JModel(jcfg, grid=jg, dtype=jnp.float64, initial_state=cls(
        **{k: jnp.asarray(getattr(m.state, k).numpy()) for k in cls._fields}))
    jm.date, jm.nstep = m.date, m.nstep
    recs = {}
    for tag, out, model in (("port", TOut, m), ("jax", JOut, jm)):
        st = out(model, str(tmp_path / tag), async_write=False)
        for name in ("che", "opt"):
            w = getattr(st, name)

            def keep(hours, rec, _w=w.write_record, _n=name, _t=tag):
                recs[(_t, _n)] = {k: np.array(v, np.float64)
                                  for k, v in rec.items()}
                return _w(hours, rec)
            w.write_record = keep
        st.write_che()
        st.write_opt()
        st.close()
    for name in ("che", "opt"):
        got, want = recs[("port", name)], recs[("jax", name)]
        assert set(got) == set(want)
        for k, w in want.items():
            err = float(np.abs(got[k] - w).max()) / max(
                float(np.abs(w).max()), 1e-300)
            assert err <= 1e-12, (name, k, err)
    assert float(recs[("port", "opt")]["aod"].max()) > 0.0
    cfg.out.chemfrq = 2 * cfg.dtsec / 3600.0
    for backend in ("netcdf", "zarr"):
        r = _windy(Model(cfg, grid=g, device="cpu"))
        r.open_output(str(tmp_path / backend), backend=backend)
        r.run_with_output(4)
        r.streams.close()
    tag = "domain_{}.1990060100"
    for stream in ("CHE", "OPT"):
        nc = read_nc(str(tmp_path / "netcdf" / (tag.format(stream) + ".nc")))
        zr = read_zarr(str(tmp_path / "zarr"
                           / (tag.format(stream) + ".zarr")))
        assert set(zr) == set(nc) and len(nc["time"]) == 3, stream
        for k, v in nc.items():
            np.testing.assert_array_equal(zr[k], v, err_msg=f"{stream} {k}")


# -- Model against the JAX package (after the twins, which run while the
#    JAX processes compile) ----------------------------------------------
@pytest.mark.parametrize("name", S.SIMS + ("dust_moloch",))
def test_chemistry_matches_jax(name, jax_models):
    """Each aerosol chemsimtype on the hydrostatic core and DUST on MOLOCH,
    three steps, every alarm on each: the port within the spread rule of
    the JAX package's Model; every aerosol tracer deposited, and in E's
    physics (AERO) dust and sea salt emitted."""
    from regcm_tpu_torch.chem.species import build_species
    got = _check_model(name, jax_models[name])
    f = got["fields"]
    spec = build_species(S.SETTINGS[name]["sim"])
    for n, kind in enumerate(spec.kind):
        # the aerosol tracers settle and deposit (SO2 is a gas)
        assert kind == "so2" or float(f[f"chemdiag{n}"][1].max()) > 0.0, n
        if kind in ("dust", "sslt") and name in ("AERO", "DUST"):
            assert float(f[f"chemdiag{n}"][0].max()) > 0.0, n
