"""``Model`` with the second physics set, the PyTorch port against the
JAX package in f64 on the CPU (settings in ``tests/_torch_schemes_ranks.py``):
configuration A (Emanuel over land, Tiedtke over water, the UW TCM and
the Nogherotto-Tompkins microphysics) on the hydrostatic and the MM5
non-hydrostatic core, and B's physics (no deep convection,
Nogherotto-Tompkins, Holtslag) on MOLOCH, three steps each at 14x16x14
over a hill with land and water; CCM3 radiation with five species; A on
2x2 ranks against one rank; what stays refused; and the port's twins of
the JAX package's Model-level tests of these schemes.

The three JAX runs and the 2x2 group (whose processes run PyTorch's
generic CPU kernels, as ``tests/test_torch_parallel.py`` explains) start
with the module, in processes of their own, and run while the other
tests do."""
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from regcm_tpu_torch.parallel import launch  # noqa: E402

from . import _torch_schemes_ranks as R  # noqa: E402

NAMES = tuple(R.SETTINGS)


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / (np.sqrt(np.mean(want ** 2)) + 1e-30))


def _jax_run(name):
    """The JAX package's Model of setting ``name`` for R.STEPS steps from
    its own initial state: that state, the final state fields, the
    decoupled fields and the alarms. Runs in a spawned process, which
    has not read the conftest's settings."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from regcm_tpu.config.params import RegCMConfig
    from regcm_tpu.core.grid import build_grid
    from regcm_tpu.driver import (Model, nh_initial_state,
                                  standard_atmosphere_state)
    from regcm_tpu.dynamics.hydrostatic import HydroCore
    from regcm_tpu.dynamics.moloch import MolochCore
    cfg = R.setup(RegCMConfig(), name)
    ht, mask = R.terrain(cfg)
    grid = build_grid(cfg, ht=ht, landmask=mask)
    kw = dict(perturb=R.PERTURB, seed=R.SEED)
    if cfg.core.idynamic == 3:
        s0 = MolochCore(grid, cfg, dtype=jnp.float64).initial_state(**kw)
    elif cfg.core.idynamic == 2:
        s0 = nh_initial_state(HydroCore(grid, cfg, dtype=jnp.float64),
                              **kw)
    else:
        s0 = standard_atmosphere_state(grid, cfg, jnp.float64, **kw)
    s0 = R.moisten(jax.device_get(s0), cfg.core.idynamic)
    from regcm_tpu.core.state import StepFlags
    m = Model(cfg, grid=grid, dtype=jnp.float64,
              initial_state=jax.tree_util.tree_map(jnp.asarray, s0))
    m._flags = lambda: StepFlags(**R.ALARMS)
    flags = []
    for _ in range(R.STEPS):
        flags.append(tuple(m._flags()))
        m.step()
    state = {k: np.asarray(getattr(m.state, k))
             for k in R.STATE_FIELDS[cfg.core.idynamic]}
    return dict(start=s0, state=state, flags=flags,
                dec={k: np.asarray(v) for k, v in m.decoupled().items()},
                finite=m.check_finite())


@pytest.fixture(scope="module")
def background():
    """A thread for the 2x2 group (its processes run the generic CPU
    kernels) and a process for each JAX run."""
    cap = os.environ.get("ATEN_CPU_CAPABILITY")
    os.environ["ATEN_CPU_CAPABILITY"] = "default"
    try:
        with ThreadPoolExecutor(1) as th, ProcessPoolExecutor(
                len(NAMES), mp_context=mp.get_context("spawn")) as pr:
            yield th, pr
    finally:
        if cap is None:
            os.environ.pop("ATEN_CPU_CAPABILITY", None)
        else:
            os.environ["ATEN_CPU_CAPABILITY"] = cap


@pytest.fixture(scope="module")
def started(background):
    th, pr = background
    jobs = {n: pr.submit(_jax_run, n) for n in NAMES}
    jobs["group22"] = th.submit(launch.spawn, R.two_by_two, 2, 2, "gloo",
                                "cpu", timeout=600)
    return jobs


@pytest.fixture(scope="module", autouse=True)
def _start_in_background(started):
    """Start the JAX runs and the 2x2 group with the module; this
    process's torch on one thread beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(started):
    """Each setting: the JAX run, the port from the JAX run's initial
    state, and the port from that state with T changed by a relative
    1e-15 (the trajectory's roundoff spread)."""
    out = {}
    rng = np.random.default_rng(0)
    for name in NAMES:
        j = started[name].result()
        s0 = j["start"]
        tname = "t" if R.SETTINGS[name]["idynamic"] == 3 else "t_a"
        t0 = np.asarray(getattr(s0, tname))
        s1 = s0._replace(**{tname: t0 * (1.0 + 1e-15 * rng.standard_normal(
            t0.shape))})
        out[name] = dict(jax=j, port=R.port_run(name, s0),
                         perturbed=R.port_run(name, s1))
    return out


@pytest.fixture(scope="module")
def group22(started):
    return started["group22"].result()


def _fields(run, idynamic):
    """The compared fields: decoupled ps, t, qv, u, v (and w), each
    hydrometeor and the TKE."""
    f = {k: run["dec"][k] for k in ("ps", "t", "qv", "u", "v")}
    st = run["state"]
    qx = st["qx" if idynamic == 3 else "qx_a"]
    for n, q in enumerate(("qc", "qr", "qi", "qs"), start=1):
        f[q] = qx[n]
    if idynamic == 3:
        f["w"] = run["dec"]["w"]
    else:
        f["tke"] = st["tke_a"]
    return f


@pytest.mark.parametrize("name", NAMES)
def test_trajectory_matches_jax(name, runs):
    """Three steps, every scheme on each: each field within the golden
    gate (rel-RMS 1e-7) or four times the port's own roundoff spread, the
    rule of tests/test_torch_model.py (the schemes' threshold branches
    turn roundoff into larger differences); a hydrometeor outside it
    only by a branch flipped at a few points (below)."""
    r = runs[name]
    idyn = R.SETTINGS[name]["idynamic"]
    assert r["port"]["finite"] and r["jax"]["finite"]
    assert [tuple(f) for f in r["port"]["flags"]] == r["jax"]["flags"]
    assert all(f.do_rad and f.do_srf and f.do_cum and f.do_abem
               for f in r["port"]["flags"])
    got = _fields(r["port"], idyn)
    want = _fields(r["jax"], idyn)
    spread = _fields(r["perturbed"], idyn)
    assert float(np.abs(want["qr"]).max() + np.abs(want["qs"]).max()
                 + np.abs(want["qi"]).max()) > 0.0      # 5 species live
    flipped = {}
    for k in got:
        s = _rel_rms(spread[k], got[k])
        err = _rel_rms(got[k], want[k])
        if err < max(1e-7, 4.0 * s):
            continue
        # a hydrometeor may still differ at the few points where one of
        # the microphysics' threshold branches flipped (the JAX package's
        # jitted BATS already differs from the eager one by ~1e-8 in the
        # step-0 fluxes): at most 1% of the points, and within 1e-7 of
        # the field's scale everywhere else
        assert k in ("qc", "qr", "qi", "qs"), \
            f"{k}: rel-RMS {err:.3e}, roundoff spread {s:.3e}"
        off = np.abs(got[k] - want[k]) > 1e-7 * np.abs(want[k]).max()
        flipped[k] = int(off.sum())
        assert off.mean() <= 0.01, (k, err, s, flipped[k])
    print(f"{name}: points past 1e-7 by a branch flip: {flipped}")


def test_both_cumulus_schemes_run():
    """Configuration A's grid has land and water, so Emanuel (land) and
    Tiedtke (water) both run on each cumulus step, and the land/ocean
    blend keeps Emanuel's cloud-base mass flux off the water points."""
    from regcm_tpu_torch.driver import Model
    cfg, grid = R.port_grid("hydro")
    assert 0.0 < float(np.mean(grid.lndocn)) < 1.0
    m = Model(cfg, grid=grid, device="cpu", initial_state=R.port_start(
        "hydro"))
    suite = m.core.physics
    called = []
    one = suite._cumulus_one
    suite._cumulus_one = lambda icup, *a: called.append(icup) or one(
        icup, *a)
    m.run(3)                         # dtcum 300 s: steps 0 and 2
    assert called == [4, 5, 4, 5]
    water = grid.lndocn < 0.5
    assert float(m.state.cbmf.numpy()[water].max()) == 0.0


def test_decomposed_matches_one_rank(group22):
    """A on 2x2 ranks (7x8 blocks) against one rank, f64, three steps:
    1e-12 in every state field (the level sums of the new schemes run in
    level order, the 5x5 solve of nogtom by a fixed elimination)."""
    got, want = group22[0]["run"], group22[0]["single"]
    assert got["finite"] and want["finite"]
    for k, v in want["state"].items():
        assert R.max_rel(got["state"][k], v) <= 1e-12, k
    for k, v in want["dec"].items():
        assert R.max_rel(got["dec"][k], v) <= 1e-12, k


def test_decomposed_c_matches_one_rank(group22):
    """Configuration C (Grell over land, Emanuel over water, Holtslag,
    SUBEX; tests/test_torch_cumulus.py holds it to the JAX package) on
    2x2 ranks against one rank, f64, three steps: 1e-12 in every state
    field (Grell's sums over levels run in level order)."""
    got, want = group22[0]["run_c"], group22[0]["single_c"]
    assert got["finite"] and want["finite"]
    for k, v in want["state"].items():
        assert R.max_rel(got["state"][k], v) <= 1e-12, k
    for k, v in want["dec"].items():
        assert R.max_rel(got["dec"][k], v) <= 1e-12, k


def test_ccm3_five_species_matches_jax():
    """CCM3 radiation with five species (ice in the clouds): 1e-12."""
    from regcm_tpu.physics.radiation.ccm3.driver import ccm3_radiation as jr
    from regcm_tpu_torch.physics.radiation.ccm3.driver import \
        ccm3_radiation as tr
    from .test_torch_physics import J, T, _check, _radiation_inputs
    args, ghg = _radiation_inputs(12)
    rng = np.random.default_rng(4)
    qc = args[2]
    args[3] = np.where(qc > 0, rng.uniform(0.0, 1.5, qc.shape) * qc, 0.0)
    assert float(args[3].max()) > 0.0
    kw = dict(eccf=1.01, solcon=1361.0, want_cache=True,
              five_species=True)
    want, wc = jr(*map(J, args), ghg, **kw)
    got, gc = tr(*map(T, args), ghg, **kw)
    _check(got, want, 1e-12, "ccm3 five species")
    _check(gc, wc, 1e-12, "cache")
    # the ice changes the answer: not the two-species path
    two, _ = tr(*map(T, args), ghg, eccf=1.01, solcon=1361.0)
    assert float((got.heatrt - two.heatrt).abs().max()) > 0.0


@pytest.mark.parametrize("icldfrac", range(1, 7))
def test_cloud_fraction_schemes_run_in_model(icldfrac):
    """Each icldfrac on configuration A's Model (the fractions
    themselves are held to the JAX package column by column in
    tests/test_torch_schemes.py): one step, finite, and a radiative
    cloud field of its own."""
    from regcm_tpu_torch.driver import Model
    cfg, grid = R.port_grid("hydro")
    cfg.physics.icldfrac = icldfrac
    m = Model(cfg, grid=grid, device="cpu",
              initial_state=R.port_start("hydro"))
    m.run(1)
    assert m.check_finite()


def test_nogtom_in_model():
    """Twin of tests/test_physics.py::test_nogtom_in_model: ipptls=2
    runs through the port's Model with the 5-species advected state."""
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.driver import Model
    cfg = RegCMConfig()
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 14, 16, 14
    cfg.geo.ds = 60.0
    cfg.time.dt = 150.0
    cfg.physics.ipptls = 2
    m = Model(cfg, device="cpu", dtype=torch.float64)
    assert m.core.nqx == 5 and m.state.qx_a.shape[0] == 5
    m.run(3)
    assert m.check_finite()


def test_model_icup5():
    """Twin of tests/test_tiedtke.py::test_model_icup5 (RegCMConfig() in
    place of the reference's test_001.in): Tiedtke on the dtcum alarm in
    the full suite, nine cuten slots, a finite state."""
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model, standard_atmosphere_state
    cfg = RegCMConfig()
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 12, 16, 14
    cfg.physics.icup_lnd = cfg.physics.icup_ocn = 5
    grid = build_grid(cfg)
    s = standard_atmosphere_state(grid, cfg, "cpu", perturb=0.5, seed=11)
    m = Model(cfg, grid=grid, device="cpu", initial_state=s)
    assert m.state.cuten.shape[0] == 9
    m.run(3)
    dec = m.decoupled()
    for name in ("t", "qv", "ps"):
        assert np.isfinite(dec[name]).all(), name
    assert 150.0 < float(dec["t"].min()) and float(dec["t"].max()) < 330.0


@pytest.mark.parametrize("overrides,match", [
    ((("physics", "icup_lnd", 1), ("physics", "icup_ocn", 1),
      ("core", "idynamic", 3)), r"icup=1 \(Kuo\).*MOLOCH"),
    ((("physics", "icup_ocn", 1),), r"icup=1 \(Kuo\) cannot be mixed"),
    ((("physics", "irrtm", 1),), r"irrtm=1 \(RRTMG, ROADMAP.md item 15\)"),
    ((("physics", "ichem", 1),), r"chemistry \(ichem=1, ROADMAP.md item 13\)"),
    ((("physics", "ichem", 1), ("core", "idynamic", 3)),
     r"chemistry \(ichem=1, ROADMAP.md item 13\)"),
    ((("geo", "i_band", 1), ("core", "idynamic", 3), ("physics", "ibltyp", 1)),
     "periodic MOLOCH"),
    ((("geo", "i_crm", 1), ("core", "idynamic", 3), ("physics", "ibltyp", 1)),
     "periodic MOLOCH"),
    ((("dim", "nsg", 2), ("core", "idynamic", 3)), r"nsg>1.*MOLOCH"),
    ((("physics", "ibltyp", 2), ("core", "idynamic", 3)),
     r"UW TCM.*ROADMAP.md item 12"),
])
def test_unported_schemes_refused(overrides, match):
    """What stays refused raises at model build and names the scheme and
    its ROADMAP item: Kuo on MOLOCH and Kuo mixed with another scheme, the
    subgrid surface and the UW TCM on MOLOCH (as the JAX package refuses
    them), RRTMG, chemistry on either core and a periodic MOLOCH domain
    (which the JAX package has no core to hold a port against)."""
    from regcm_tpu_torch.driver import Model
    cfg, _ = R.port_grid("hydro")
    for section, name, val in overrides:
        setattr(getattr(cfg, section), name, val)
    with pytest.raises((NotImplementedError, ValueError), match=match):
        Model(cfg, device="cpu")
