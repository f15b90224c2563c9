"""The decomposed paths of the PyTorch port on the CPU, both cores: rank
groups of ``torch.distributed`` (gloo) started by ``parallel.launch.spawn``,
held against the undecomposed port and against the JAX package's
sharded kernels, MOLOCH core and hydrostatic core in f64, from a rest
state and from ICBC files, on the bounded and the periodic topologies
(the band on both sigma-p cores, the doubly periodic CRM).

The ranks run ``tests/_torch_parallel_ranks.py`` and never import jax;
one 2x2 group does every 2x2 check and, after it, the undecomposed runs
it is held to, each on one of its ranks. The group and the JAX
package's MOLOCH and hydrostatic trajectories (cold compiles of about a
minute each, in two processes of their own so that their tracing does
not share this one's interpreter lock with the Pallas interpret run)
start when the module does, and run while the other tests do.

The processes this module starts run PyTorch's generic CPU kernels
(``ATEN_CPU_CAPABILITY=default``). With the vectorised ones (AVX2,
AVX-512) a transcendental function such as ``pow`` rounds differently in
the vector body of an elementwise loop and in its scalar tail, so a
column's value depends on where it falls in the flattened tensor, and a
block of the domain can differ from the same columns of the whole in
the last bit (first seen in the trace-gas mixing ratios of the CCM3
longwave, ``trcmix``); the saturation adjustment then amplifies the bit
(measured 5.6e-10 relative in qv after 4 steps at 18x24). With the
generic kernels every element takes the same path, so the 2x2 runs are
held to the undecomposed ones at 1e-12 (measured: bit-identical). On the
card each element takes the same path in any case."""
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from regcm_tpu_torch.parallel import launch  # noqa: E402
from regcm_tpu_torch.parallel.halo import extend_block  # noqa: E402
from regcm_tpu_torch.parallel.mesh import DomainMesh, factor2d  # noqa: E402

from . import _torch_parallel_ranks as R  # noqa: E402
from . import _torch_surface_settings as S  # noqa: E402
from ._torch_icbc_files import write_files  # noqa: E402
from ._torch_jax_child import use_suite_cache  # noqa: E402

IY, JX = 16, 16                   # the 2x2 checks: 8x8 blocks
K5_SHAPE = (7, 14, 16, 24)        # K5a's stack: nf, kz, iy, jx (f64)


def _rel(got, want):
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


def k5_inputs():
    """K5a/b/c operands of the MOLOCH step's kind (as chip_smoke.py
    draws them): smooth fields with noise, winds and s of both signs,
    fmzf 0 at the top, an interior mask; the tridiagonal coefficients
    diagonally dominant."""
    nf, kz, iy, jx = K5_SHAPE
    rng = np.random.default_rng(11)
    sm = lambda sh: rng.normal(size=sh) + 10.0 * np.sin(
        np.linspace(0, 3, int(np.prod(sh))).reshape(sh))
    pp = sm((nf, kz, iy, jx))
    pp[0] += 300.0
    um = 8.0 + 0.5 * sm((kz, iy, jx))
    vm = -5.0 + 0.5 * sm((kz, iy, jx))
    s = 0.1 * sm((kz + 1, iy, jx))
    fmz = 1.0 + 0.05 * rng.random((kz, iy, jx))
    fmzf = 1.0 + 0.05 * rng.random((kz + 1, iy, jx))
    fmzf[0] = 0.0
    mx2 = 1.0 + 0.01 * rng.random((iy, jx))
    m_ci = np.zeros((iy, jx))
    m_ci[1:iy - 2, 1:jx - 2] = 1.0
    w3 = (kz - 1, iy, jx)
    tw = (rng.normal(size=w3), rng.uniform(0.01, 0.5, w3),
          rng.uniform(0.01, 0.5, w3), rng.normal(size=(iy, jx)))
    sh = (5, kz, iy, jx)
    al, be = rng.uniform(0.1, 1.0, sh), rng.uniform(0.1, 1.0, sh)
    bkp = np.concatenate([be[:, 1:], np.zeros_like(be[:, :1])], axis=1)
    c1, c3 = 150.0 * al * bkp, 150.0 * al * be
    c3[:, 0] = 0.0
    pb = (c1, 1.0 + c1 + c3, c3, rng.normal(size=sh))
    return ((pp, um, vm, s, fmz, fmzf, mx2, m_ci), 30.0 / 3000.0,
            30.0 / 199.4, tw, pb)


def assemble(blocks, ny, nx):
    """The global array from the blocks of ranks 0..ny·nx-1."""
    return np.concatenate([np.concatenate(blocks[py * nx:(py + 1) * nx],
                                          axis=-1) for py in range(ny)],
                          axis=-2)


@pytest.fixture(scope="module")
def k5():
    return k5_inputs()


@pytest.fixture(scope="module")
def background():
    # torch on one thread here: the ranks and the JAX compile share the
    # cores, and torch's pool at these sizes only contends with them;
    # the processes started here use the generic CPU kernels (see above)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cap = os.environ.get("ATEN_CPU_CAPABILITY")
    os.environ["ATEN_CPU_CAPABILITY"] = "default"
    try:
        with ThreadPoolExecutor(1) as th, ProcessPoolExecutor(
                2, mp_context=mp.get_context("spawn")) as pr:
            yield th, pr
    finally:
        torch.set_num_threads(threads)
        if cap is None:
            os.environ.pop("ATEN_CPU_CAPABILITY", None)
        else:
            os.environ["ATEN_CPU_CAPABILITY"] = cap


@pytest.fixture(scope="module")
def icbc_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("icbc")
    return {kind: write_files(kind, str(d)) for kind in R.ICBC}


@pytest.fixture(scope="module")
def group22_started(background, k5, icbc_paths, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("group22"))
    return background[0].submit(launch.spawn, R.two_by_two, 2, 2, "gloo",
                                "cpu", args=(IY, JX, k5, icbc_paths, work),
                                timeout=900)


@pytest.fixture(scope="module")
def group22(group22_started):
    return group22_started.result()


def _dryrun_jax():
    """The JAX package's MOLOCH on dryrun_multichip's settings, one
    device (the JAX sharded gate is 1e-6). Runs in a spawned process,
    which has not read the conftest's settings."""
    use_suite_cache()
    jax.config.update("jax_enable_x64", True)
    from regcm_tpu.config.params import RegCMConfig
    from regcm_tpu.core.state import StepFlags
    from regcm_tpu.driver import Model, moloch_bdy_from_state
    cfg = RegCMConfig()
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = IY, JX, 14
    cfg.geo.ds = 10.0
    cfg.time.dt = 60.0
    cfg.core.idynamic = 3
    m = Model(cfg, dtype=jnp.float64)
    st = m.core.initial_state(perturb=0.2)
    bdy = moloch_bdy_from_state(st)
    step = jax.jit(m.core.step, static_argnames=("flags",))
    mu = jnp.full((IY, JX), 0.4, jnp.float64)
    solar = jnp.asarray([1.0343, 1361.8], jnp.float64)
    xt = 0.0
    for n in range(3):
        flags = StepFlags(do_rad=True, do_srf=True, do_cum=True,
                          do_abem=True, first=True) if n == 0 \
            else StepFlags(do_rad=False, do_srf=True, do_cum=True)
        st, _ = step(st, bdy, xt, cfg.dtsec, flags, mu, solar)
        xt += cfg.dtsec
    return {k: np.asarray(getattr(st, k)) for k in R.MOLOCH_FIELDS}


def _hydro_jax(names):
    """The JAX package's hydrostatic core on HYDRO settings, one device:
    the state after each recorded step, as ``R.hydro_run`` builds it
    (dryrun_multichip drives the jitted ``HydroCore.step`` the same way).
    Runs in a spawned process."""
    use_suite_cache()
    jax.config.update("jax_enable_x64", True)
    from regcm_tpu.config.params import RegCMConfig
    from regcm_tpu.core.state import StepFlags, bdy_from_state
    from regcm_tpu.driver import Model, standard_atmosphere_state
    from regcm_tpu.dynamics.stencil import cross2dot
    f64 = jnp.float64
    out = {}
    for name in names:
        st = R.HYDRO[name]
        cfg = R.hydro_setup(RegCMConfig(), name)
        m = Model(cfg, dtype=f64, physics=None if st["physics"] else False)
        s = standard_atmosphere_state(m.grid, cfg, f64,
                                      perturb=st["perturb"], seed=st["seed"])
        u = 10.0 * cross2dot(s.ps_a)[None] * jnp.ones_like(s.u_a)
        qx = s.qx_a.at[0].set(jnp.maximum(s.qx_a[0], 1e-5 * s.ps_a[None]))
        s = s._replace(u_a=u, u_b=u, qx_a=qx, qx_b=qx)
        if st["physics"]:
            s = s._replace(tg=s.t_a[-1] / s.ps_a, bats=m.state.bats)
        s = m.core.init_split_storage(s)
        bdy = bdy_from_state(s)
        step = jax.jit(m.core.step, static_argnames=("flags",))
        mu = jnp.full((cfg.dim.iy, cfg.dim.jx), 0.4, f64)
        solar = None if st.get("solar") is None \
            else jnp.asarray(st["solar"], f64)
        xt, dt = 0.0, cfg.dtsec
        out[name] = {}
        for n in range(max(st["record"])):
            flags = StepFlags(**R.hydro_flags(name, n))
            if st["physics"]:
                s, _ = step(s, bdy, xt, dt, flags, mu, solar)
            else:
                s, _ = step(s, bdy, xt, dt, flags)
            xt += cfg.dtsec
            dt = 2.0 * cfg.dtsec
            if n + 1 in st["record"]:
                out[name][n + 1] = {k: np.asarray(v) for k, v in
                                    s._asdict().items() if np.size(v)}
    return out


@pytest.fixture(scope="module")
def dryrun_jax_started(background):
    return background[1].submit(_dryrun_jax)


@pytest.fixture(scope="module")
def hydro_jax_started(background):
    """dryrun_multichip's hydrostatic settings, beside the MOLOCH
    trajectory."""
    return background[1].submit(_hydro_jax, ["dryrun_dyn", "dryrun_phys"])


@pytest.fixture(scope="module", autouse=True)
def _start_in_background(group22_started, dryrun_jax_started,
                         hydro_jax_started):
    """Start the 2x2 group and the JAX trajectories with the module."""


def test_k5a_plain_halo_form_matches_jax_and_unsharded(k5, group22_started):
    """K5a's plain halo form on a 2x2 split of a (7, 14, 16, 24) f64
    stack against the JAX package's waf_advect_sharded on a 2x2 mesh of
    the test's CPU devices (Pallas interpret mode) and against the
    port's unsharded plain K4. Against the port: exact. Against JAX:
    1e-12 relative, the JAX package's own Pallas-vs-XLA tolerance
    (tests/test_moloch.py); measured 3.7e-16, the gap that the
    unsharded Pallas kernel already has to the port's plain K4 (2.7e-16,
    tests/test_torch_kernels.py), which equals jax.vmap(_wafone)."""
    from jax.sharding import Mesh
    from regcm_tpu.dynamics.pallas_kernels import waf_advect_sharded
    from regcm_tpu_torch.kernels import waf_advect as k4
    waf, dtrdx, dtrdz = k5[:3]
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("y", "x"))
    pp, um, vm, s, fmz, fmzf, mx2, m_ci = map(jnp.asarray, waf)
    jgot = np.asarray(waf_advect_sharded(mesh, pp, um, vm, s, fmz, fmzf,
                                         mx2, m_ci, dtrdx, dtrdz,
                                         interpret=True))
    got = assemble([r["k5"]["waf"] for r in group22_started.result()],
                   2, 2)
    T = torch.as_tensor
    want = k4.waf_advect_plain(*map(T, waf), dtrdx, dtrdz).numpy()
    np.testing.assert_array_equal(got, want)
    assert _rel(got, jgot) <= 1e-12


@pytest.mark.parametrize("n", range(1, 17))
def test_factor2d_matches_jax(n):
    from regcm_tpu.parallel.mesh import factor2d as jfactor2d
    assert factor2d(n) == jfactor2d(n)
    assert factor2d(n, 2.0) == jfactor2d(n, 2.0)


def _pad_reference(g, mode, periodic_x, h=2):
    fill = "constant" if mode == "zero" else "edge"
    a = np.pad(g, ((0, 0), (h, h), (0, 0)), mode=fill)
    return np.pad(a, ((0, 0), (0, 0), (h, h)),
                  mode="wrap" if periodic_x else fill)


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
def test_halo_expand2d_matches_numpy_pad(grid, group22):
    """Every rank's extended block is numpy.pad of the global array,
    sliced: zero and edge fill, with and without a periodic x axis."""
    ny, nx = grid
    iy, jx = (IY, JX) if grid == (2, 2) else (8, 32)
    res = [r["halo"] for r in group22] if grid == (2, 2) else \
        launch.spawn(R.halo_blocks, ny, nx, "gloo", "cpu", args=(iy, jx))
    g = R.field((3, iy, jx))
    ly, lx = iy // ny, jx // nx
    for rank, blocks in enumerate(res):
        py, px = divmod(rank, nx)
        for (mode, per), got in blocks.items():
            want = _pad_reference(g, mode, per)[
                :, py * ly:py * ly + ly + 4, px * lx:px * lx + lx + 4]
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{rank} {mode} {per}")
            if not per:
                np.testing.assert_array_equal(
                    got, extend_block(torch.as_tensor(g), py * ly, px * lx,
                                      ly, lx, 2, mode).numpy())


SHIFT_CASES = [(k, dy, dx) for k in ("shift", "shifte")
               for dy, dx in R.SHIFTS] + ["cross2dot", "dot2cross"]


@pytest.mark.parametrize("case", SHIFT_CASES, ids=str)
def test_shift_under_mesh_is_exact(case, group22):
    """Under a 2x2 mesh each rank's shift is its block of the global
    shift: exact."""
    from regcm_tpu_torch.dynamics import stencil
    g = torch.as_tensor(R.field((3, IY, JX), seed=1))
    if isinstance(case, tuple):
        kind, dy, dx = case
        want = getattr(stencil, kind)(g, dy, dx).numpy()
    else:
        want = getattr(stencil, case)(g).numpy()
    got = assemble([r["shifts"][case] for r in group22], 2, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k5a_halo_form_from_extended_blocks_is_exact(k5, dtype):
    """The halo form fed with blocks extended from the global tensors
    (``extend_block``: what chip_smoke.py hands the CUDA kernel) gives
    the unsharded result bit for bit, on every block of a 2x2 and a 1x3
    split; an off-domain block is refused."""
    from regcm_tpu_torch.kernels import waf_advect as k4
    waf, dtrdx, dtrdz = k5[:3]
    g = [torch.as_tensor(a, dtype=dtype) for a in waf]
    want = k4.waf_advect(*g, dtrdx, dtrdz).numpy()
    nf, kz, iy, jx = K5_SHAPE
    modes = ["zero"] * 4 + ["edge"] * 2 + ["zero"] * 2
    for ny, nx in ((2, 2), (1, 3)):
        blocks = []
        for r in range(ny * nx):
            m = DomainMesh(ny, nx, iy, jx, rank=r)
            ext = [extend_block(a, m.y0, m.x0, m.ly, m.lx, 2, mode)
                   for a, mode in zip(g, modes)]
            blocks.append(k4.waf_advect_halo(*ext, dtrdx, dtrdz, iy, jx,
                                             m.y0, m.x0).numpy())
        np.testing.assert_array_equal(assemble(blocks, ny, nx), want)
    with pytest.raises(ValueError):
        k4.waf_advect_halo(*ext, dtrdx, dtrdz, iy, jx, m.y0 + 4, m.x0)
    assert k4.launches_sharded == 0          # CPU tensors: plain version


@pytest.mark.parametrize("name", ["tw", "pb"])
def test_k5b_k5c_blocks_are_exact(name, k5, group22):
    """tridiag_w_sharded and pbl_tridiag_sharded on each rank's block
    make up the unsharded solve exactly (the columns are independent)."""
    from regcm_tpu_torch.kernels import pbl_tridiag as k1
    from regcm_tpu_torch.kernels import tridiag_w as k3
    fn = k3.tridiag_w if name == "tw" else k1.pbl_tridiag
    want = fn(*map(torch.as_tensor, k5[3 if name == "tw" else 4])).numpy()
    got = assemble([r["k5"][name] for r in group22], 2, 2)
    np.testing.assert_array_equal(got, want)


def _single(group, case):
    """An undecomposed reference run by one of the group's ranks."""
    return next(r["single"][case] for r in group if case in r["single"])


@pytest.fixture(scope="module")
def dryrun_single(group22):
    return _single(group22, ("dryrun", None))


@pytest.mark.parametrize("field", R.MOLOCH_FIELDS)
def test_dryrun_moloch_matches_single_rank(field, group22, dryrun_single):
    """dryrun_multichip's 3-step full-physics MOLOCH trajectory (f64,
    16x16x14) on 2x2 ranks against one: 1e-12 relative. The halo copies
    are exact; what differs is summation order in the column physics on
    64 instead of 256 columns (measured: qx ~1e-20, the rest 0.0)."""
    got = group22[0]["dryrun"][field]
    want = dryrun_single[field]
    assert np.all(np.isfinite(got))
    assert _rel(got, want) <= 1e-12


def test_dryrun_diagnostics_are_global(group22, dryrun_single):
    """wmax, pmin and pmax are reduced over the ranks; every rank reads
    the halo counters of a real exchange."""
    for r in group22:
        for k, v in dryrun_single["diags"].items():
            assert r["dryrun"]["diags"][k] == pytest.approx(v, rel=1e-12)
        assert r["dryrun_halo"][0] > 0 and r["dryrun_halo"][1] > 0


@pytest.fixture(scope="module")
def model_single(group22):
    return _single(group22, ("model", None))


@pytest.mark.parametrize("field", ["ps", "t", "qv", "qc", "u", "v", "w"])
def test_model_mesh_matches_single_rank(field, group22, model_single):
    """Model(cfg, mesh=...) with the default physics over the hill, six
    steps (every alarm), 2x2 against one rank: 1e-12 relative."""
    got = group22[0]["model"]
    assert got["finite"]
    assert _rel(got["dec"][field], model_single["dec"][field]) <= 1e-12


@pytest.mark.parametrize("topology", ["i_band", "i_crm"])
def test_model_mesh_refuses_the_periodic_topologies(topology):
    """The band and CRM topologies decompose on the sigma-p cores (the
    cases below); MOLOCH refuses them on one rank and under a mesh
    alike, since the JAX package's MolochCore has no periodic domain to
    hold a port against (ROADMAP.md Queue 3)."""
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.driver import Model
    cfg = RegCMConfig()
    cfg.core.idynamic = 3
    setattr(cfg.geo, topology, 1)
    mesh = DomainMesh(2, 2, cfg.dim.iy, cfg.dim.jx, rank=0)
    with pytest.raises(NotImplementedError, match="periodic MOLOCH"):
        Model(cfg, device="cpu", mesh=mesh, physics=False)


@pytest.mark.parametrize("kind", list(S.PERIODIC))
def test_periodic_mesh_matches_single_rank(kind, group22):
    """The periodic topologies decomposed (ROADMAP item 10d): the band
    on the hydrostatic core with COARE and the slab ocean, the band on
    the NH core (dynamics) and the doubly periodic CRM, 2x2 against one
    rank, every compared field: 1e-12 relative (bit-identical
    expected); every rank exchanged halos, across the seam too."""
    want = _single(group22, ("periodic", kind))
    got = group22[0]["periodic"][kind]
    assert got["finite"] and want["finite"]
    _every_field(got["fields"], want["fields"], 1e-12, kind)
    assert all(r["periodic"][kind]["exchanges"] > 0 for r in group22)


def _every_field(got, want, bound, what):
    """Each field of ``want`` (nonzero size) against ``got``: the same
    shape, finite, and within ``bound`` of max|want| at every point."""
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (what, k)
        assert np.all(np.isfinite(g)), (what, k)
        err = _rel(g, w)
        assert err <= bound, f"{what} {k}: max rel err {err:.3e}"


@pytest.mark.parametrize("name", list(R.HYDRO))
def test_hydro_mesh_matches_single_rank(name, group22):
    """The hydrostatic core on 2x2 ranks against one rank, every state
    field after each recorded step: dryrun_multichip's dynamics (3 steps)
    and full physics with every alarm at step 0 (1 and 3 steps), and
    tests/test_parallel.py's 18x24x14 dynamics (10 steps) and full
    physics (1 and 4 steps): 1e-12 relative (measured: bit-identical);
    every rank exchanged halos."""
    want = _single(group22, ("hydro", name))
    got = group22[0]["hydro"][name]
    assert set(got) == set(want) | {"exchanges"}
    for step, fields in want.items():
        _every_field(got[step], fields, 1e-12, f"{name} step {step}")
    assert all(r["hydro"][name]["exchanges"] > 0 for r in group22)


def test_hydro_dryrun_matches_jax(hydro_jax_started, group22):
    """dryrun_multichip's hydrostatic gates, the 2x2 run against the
    JAX package unsharded: dynamics after 3 steps 1e-9 in ps, T, u, v;
    full physics 1e-9 after one step and 1e-3 after three in the fields
    that dryrun_multichip compares."""
    want = hydro_jax_started.result()
    got = group22[0]["hydro"]
    for f in ("ps_a", "t_a", "u_a", "v_a"):
        err = _rel(got["dryrun_dyn"][3][f], want["dryrun_dyn"][3][f])
        assert err <= 1e-9, f"dynamics {f}: {err:.3e}"
    for step, bound in ((1, 1e-9), (3, 1e-3)):
        for f in ("ps_a", "t_a", "u_a", "v_a", "qx_a", "tg", "heatrt",
                  "swsfc", "hfx", "bats"):
            err = _rel(got["dryrun_phys"][step][f],
                       want["dryrun_phys"][step][f])
            assert err <= bound, f"physics step {step} {f}: {err:.3e}"


@pytest.mark.parametrize("kind", list(R.ICBC))
def test_icbc_mesh_matches_single_rank(kind, group22):
    """Model.init_from_icbc and run_icbc on 2x2 ranks against one rank,
    from the same DOMAIN and ICBC files: the state and the boundary
    after the cold start, then the state, boundary and decoupled fields
    after each recorded step (past the hourly update: step 25 of the
    hydrostatic run, step 61 of MOLOCH's), 1e-12 relative (measured:
    bit-identical); the step count and boundary clock the same."""
    want = _single(group22, ("icbc", kind))
    got = group22[0]["icbc"][kind]
    for part in ("init", "bdy0"):
        _every_field(got[part], want[part], 1e-12, f"{kind} {part}")
    for step in R.ICBC[kind]["record"]:
        g, w = got[step], want[step]
        assert g["finite"] and w["finite"]
        assert (g["nstep"], g["xbctime"]) == (w["nstep"], w["xbctime"])
        for part in ("state", "bdy", "dec"):
            _every_field(g[part], w[part], 1e-12, f"{kind} {step} {part}")
    # the hourly update took the next pair of records (whose jet is
    # stronger) and restarted the boundary clock
    last = got[max(R.ICBC[kind]["record"])]
    assert last["xbctime"] < 3600.0
    assert not np.array_equal(last["bdy"]["u0"], got["bdy0"]["u0"])


def _chain(group, kind, mesh):
    """(A, B) of a restart chain, each its state, boundary and clocks:
    the 2x2 run's (``mesh``) or one rank's."""
    if kind == "moloch":
        out = group[0]["moloch_chain"] if mesh \
            else _single(group, ("moloch_chain", None))
        return out["a"], out["b"]
    run = group[0]["icbc"]["hydro"] if mesh \
        else _single(group, ("icbc", "hydro"))
    return run[max(R.ICBC["hydro"]["record"])], run["restart"]


def _same_chain(a, b, kind):
    assert b["clock"] == a["clock"]
    for part in ("state", "bdy"):
        assert set(b[part]) == set(a[part])
        for k, w in a[part].items():
            np.testing.assert_array_equal(b[part][k], w,
                                          err_msg=f"{kind} {part} {k}")


@pytest.mark.parametrize("kind", ["hydro", "moloch"])
def test_restart_chain_on_one_rank(kind, group22):
    """tests/test_io.py:96's twin on one rank: test_001 from ICBC files
    saved at step 22 and continued by a fresh Model that only
    re-attaches the reader, past the hourly update after step 24 and
    the radiation step 24; MOLOCH from noon past a radiation, surface
    and cumulus step: bit for bit the uninterrupted run."""
    a, b = _chain(group22, kind, mesh=False)
    _same_chain(a, b, kind)
    if kind == "hydro":
        assert a["clock"][1] < 3600.0       # updated after step 24


@pytest.mark.parametrize("kind", ["hydro", "moloch"])
def test_restart_chain_on_mesh(kind, group22):
    """Restart chains on 2x2 ranks: rank 0 writes the gathered SAV, every
    rank loads its block into a fresh Model; the continued run equals the
    uninterrupted 2x2 run bit for bit (the ICBC setting past its hourly
    boundary update and a radiation step, MOLOCH past a radiation,
    surface and cumulus step), which equals one rank's 1e-12 relative
    (measured: bit-identical)."""
    a, b = _chain(group22, kind, mesh=True)
    _same_chain(a, b, kind)
    one, _ = _chain(group22, kind, mesh=False)
    assert one["clock"] == a["clock"]
    for part in ("state", "bdy"):
        _every_field(a[part], one[part], 1e-12, f"{kind} {part}")


@pytest.mark.parametrize("backend", ["netcdf", "zarr"])
def test_output_mesh_matches_single_rank(backend, group22):
    """run_with_output on 2x2 ranks writes the one-rank run's files:
    every stream's variables, statics and time axis equal, exactly; the
    NetCDF files from rank 0's gathered records, the Zarr stores from
    each rank's chunks (four a 2-D record)."""
    from regcm_tpu_torch.io.ncio import read_nc
    from regcm_tpu_torch.io.zarrio import read_zarr
    mesh_dir = group22[0]["output"][backend]
    one_dir = _single(group22, ("output", backend))
    names = sorted(os.listdir(one_dir))
    assert names == sorted(os.listdir(mesh_dir))
    assert len(names) == 4            # ATM, SRF, RAD, STS
    read = read_nc if backend == "netcdf" else read_zarr
    for fn in names:
        want = read(os.path.join(one_dir, fn))
        got = read(os.path.join(mesh_dir, fn))
        assert set(got) == set(want), fn
        assert want["time"].shape[0] >= 1, fn
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=f"{fn} {k}")
    if backend == "zarr":
        atm = [f for f in names if "_ATM." in f][0]
        chunks = [f for f in os.listdir(os.path.join(mesh_dir, atm, "ps"))
                  if not f.startswith(".")]
        assert len(chunks) == 4 * (R.OUTPUT_STEPS // 2 + 1)


def test_ensemble_mesh_matches_single_rank(group22):
    """An ensemble member on 2x2 ranks, each rank drawing the whole
    record's noise and keeping its block: the state and boundary after
    the cold start and three steps equal one rank's 1e-12 relative
    (measured: bit-identical), and the mass budget, summed over the
    ranks, 1e-12."""
    got = group22[0]["ensemble"]
    want = _single(group22, ("ensemble", None))
    for part in ("state", "bdy"):
        _every_field(got[part], want[part], 1e-12, f"ensemble {part}")
    for k, w in want["mass"].items():
        assert abs(got["mass"][k] / w - 1.0) <= 1e-12, k


@pytest.mark.parametrize("name", R.CHEM)
def test_chem_mesh_matches_single_rank(name, group22):
    """The chemistry decomposed: AERO with configuration E's physics on
    the band and DUST with the direct effect and cumtran, three steps
    with every alarm, 2x2 against one rank, every compared field (the
    dynamics, both tracer levels, the emission and deposition totals):
    1e-12 relative (bit-identical expected); every rank exchanged halos,
    the tracers riding the hydrometeors' exchanges."""
    want = _single(group22, ("chem", name))
    got = group22[0]["chem"][name]
    assert got["finite"] and want["finite"] and got["flags"] == want["flags"]
    _every_field(got["fields"], want["fields"], 1e-12, name)
    assert all(r["chem"][name]["exchanges"] > 0 for r in group22)


def test_mesh_refusals():
    with pytest.raises(ValueError):
        DomainMesh(3, 2, 16, 16, rank=0)        # uneven
    with pytest.raises(ValueError):
        DomainMesh(2, 4, 16, 12, rank=0)        # 8x3 blocks
    with pytest.raises(RuntimeError):
        DomainMesh(2, 2, 16, 16)                # no group
    m = DomainMesh(2, 2, 16, 16, rank=3)
    assert (m.py, m.px, m.y0, m.x0, m.ly, m.lx) == (1, 1, 8, 8, 8, 8)
    with pytest.raises(RuntimeError):
        m.gather(torch.zeros(8, 8))             # detached
    with pytest.raises(ValueError):
        launch.spawn(R.halo_blocks, 2, 2, "nccl", "cpu", args=(16, 16))
    with pytest.raises(ValueError):
        launch.spawn(R.halo_blocks, 2, 2, "mpi", "cpu", args=(16, 16))


def test_a_failing_rank_fails_the_group():
    with pytest.raises(RuntimeError, match="rank2 failed first"):
        launch.spawn(R.fail_on, 2, 2, "gloo", "cpu", args=(2,), timeout=120)


@pytest.mark.cuda
def test_k5_kernels_match_unsharded_on_card(k5):
    """On a CUDA card: the halo form of the WAF kernel on each block of a
    2x2 split equals the unsharded kernel bit for bit, f32 and f64, and
    K5b/K5c on blocks equal K3/K1 (chip_smoke.py phase 9 does the same
    at 192x192x41)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from regcm_tpu_torch.kernels import pbl_tridiag as k1
    from regcm_tpu_torch.kernels import tridiag_w as k3
    from regcm_tpu_torch.kernels import waf_advect as k4
    waf, dtrdx, dtrdz, tw, pb = k5
    nf, kz, iy, jx = K5_SHAPE
    modes = ["zero"] * 4 + ["edge"] * 2 + ["zero"] * 2
    meshes = [DomainMesh(2, 2, iy, jx, rank=r) for r in range(4)]
    for dtype in (torch.float64, torch.float32):
        g = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in waf]
        want = k4.waf_advect(*g, dtrdx, dtrdz).cpu().numpy()
        blocks = [k4.waf_advect_halo(
            *[extend_block(a, m.y0, m.x0, m.ly, m.lx, 2, mode)
              for a, mode in zip(g, modes)], dtrdx, dtrdz, iy, jx, m.y0,
            m.x0).cpu().numpy() for m in meshes]
        np.testing.assert_array_equal(assemble(blocks, 2, 2), want)
        for mod, name, arrs in ((k3, "tridiag_w", tw),
                                (k1, "pbl_tridiag", pb)):
            a = [torch.as_tensor(x, dtype=dtype, device="cuda")
                 for x in arrs]
            want = getattr(mod, name)(*a).cpu().numpy()
            got = [getattr(mod, name + "_sharded")(
                m, *[m.local(x) for x in a]).cpu().numpy() for m in meshes]
            np.testing.assert_array_equal(assemble(got, 2, 2), want)


def test_gather_to_one_rank(group22):
    """mesh.gather(t, dst=0) rebuilds the global array on rank 0 alone."""
    np.testing.assert_array_equal(group22[0]["gathered"],
                                  R.field((3, IY, JX), seed=1))
    assert all(r["gathered"] is None for r in group22[1:])


def test_init_from_env_joins_a_torchrun_group(tmp_path):
    """A process given torchrun's environment joins its group (one rank
    here, gloo on the CPU) and gets its block's mesh."""
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    code = ("from regcm_tpu_torch.parallel.launch import init_from_env\n"
            "import torch.distributed as dist\n"
            "r = init_from_env(1, 1, 'gloo', 'cpu')\n"
            "m = r.mesh(8, 12)\n"
            "print(r.rank, r.world, r.device, m.ly, m.lx, m.backend)\n"
            "dist.destroy_process_group()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(port), PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["0", "1", "cpu", "8", "12", "gloo"]


def test_dryrun_moloch_matches_jax(dryrun_jax_started, group22):
    """The 2x2 trajectory against the JAX package: 1e-9 relative in
    every field."""
    want = dryrun_jax_started.result()
    for field in R.MOLOCH_FIELDS:
        got = group22[0]["dryrun"][field]
        assert _rel(got, want[field]) <= 1e-9, field
