"""Kernels K1 (pbl_tridiag), K2 (emanuel_mixing), K3 (tridiag_w) and K4
(waf_advect) of the PyTorch port: their plain PyTorch versions against
the JAX package (the Pallas kernels in interpret mode and the XLA
reference), the wrapper's dispatch rules, and, on a CUDA card only,
kernel against plain."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from regcm_tpu.config.params import RegCMConfig  # noqa: E402
from regcm_tpu.core.grid import build_grid  # noqa: E402
from regcm_tpu.dynamics import pallas_kernels as pk  # noqa: E402
from regcm_tpu.dynamics.moloch import MolochCore  # noqa: E402
from regcm_tpu.physics.cumulus import emanuel as jem  # noqa: E402
from regcm_tpu.physics.pbl import holtslag as jhb  # noqa: E402
from regcm_tpu_torch.kernels import emanuel_mixing as k2  # noqa: E402
from regcm_tpu_torch.kernels import pbl_tridiag as k1  # noqa: E402
from regcm_tpu_torch.kernels import tridiag_w as k3  # noqa: E402
from regcm_tpu_torch.kernels import waf_advect as k4  # noqa: E402
from regcm_tpu_torch.parallel.halo import extend_block  # noqa: E402
from regcm_tpu_torch.physics.pbl import holtslag as thb  # noqa: E402

T = torch.as_tensor


def _tridiag_inputs(seed=3, shape=(5, 14, 16, 20)):
    """Diffusion systems as holtbl builds them: alpha/beta > 0."""
    rng = np.random.default_rng(seed)
    ns, kz, iy, jx = shape
    al = rng.uniform(0.1, 1.0, (kz, ns, iy, jx))
    be = rng.uniform(0.1, 1.0, (kz, ns, iy, jx))
    f = rng.normal(size=(kz, ns, iy, jx))
    se = rng.normal(size=(ns, iy, jx))
    return al, be, f, se


def _coefs(al, be, f, se, dt):
    """c1/c2/c3/rhs (ns, kz, iy, jx) from (kz, ns, ...) alpha/beta."""
    bkp = np.concatenate([be[1:], np.zeros_like(be[:1])], axis=0)
    c1 = dt * al * bkp
    c3 = dt * al * be
    c3[0] = 0.0
    c2 = 1.0 + c1 + c3
    rhs = f.copy()
    rhs[-1] = rhs[-1] + se
    tr = lambda a: np.ascontiguousarray(np.swapaxes(a, 0, 1))
    return tr(c1), tr(c2), tr(c3), tr(rhs)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("shape", [(5, 14, 16, 20), (5, 41, 37, 45),
                                   (2, 1, 5, 7)])
def test_pbl_tridiag_plain_matches_pallas_interpret(shape):
    """Same Thomas recurrence, same operation order: 1e-12 covers the
    roundoff of a well-conditioned (diagonally dominant) solve. The
    odd 37x45 plane and the one-level column are edge shapes of the CUDA
    kernel, so the card comparison there holds it to a verified
    reference."""
    c1, c2, c3, rhs = _coefs(*_tridiag_inputs(shape=shape), dt=150.0)
    want = pk.pbl_tridiag(*(jnp.asarray(a) for a in (c1, c2, c3, rhs)),
                          interpret=True)
    got = k1.pbl_tridiag_plain(*(T(a) for a in (c1, c2, c3, rhs)))
    assert _rel(got.numpy(), want) < 1e-12


def test_pbl_tridiag_many_matches_holtslag_scan():
    """The port's holtbl solve (coefficients + K1) against the JAX
    ``_tridiag_implicit`` scan sweeps, at 1e-12 relative."""
    al, be, f, se = _tridiag_inputs(seed=5)
    dt = 300.0
    want = jhb._tridiag_implicit(jnp.asarray(f), jnp.asarray(al),
                                 jnp.asarray(be), dt, jnp.asarray(se))
    ns = f.shape[1]
    got = thb._tridiag_implicit_many(
        [T(f[:, i]) for i in range(ns)], [T(al[:, i]) for i in range(ns)],
        [T(be[:, i]) for i in range(ns)], dt, [T(se[i]) for i in range(ns)])
    for i in range(ns):
        assert _rel(got[i].numpy(), np.asarray(want)[:, i]) < 1e-12


def _mixing_inputs(ncol=200, L=20, seed=0):
    """The generator of tests/test_physics.py's Pallas mixing test."""
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: rng.uniform(lo, hi, (ncol, L))
    levels = [f(2.8e5, 3.5e5), f(2.8e5, 3.5e5), f(1e-4, 2e-2),
              f(1e-3, 3e-2), f(200, 300), f(2.3e6, 2.6e6), f(1e-4, 2e-2),
              f(0, 2e-3), f(0, 1), f(0, 0.05), f(-20, 20), f(-20, 20),
              f(5, 60)]
    unk = rng.uniform(-20, 20, ncol)
    vnk = rng.uniform(-20, 20, ncol)
    icb = rng.integers(1, 6, ncol)
    ict = rng.integers(8, L - 2, ncol)
    ii = np.arange(L)[None]
    cloud = (ii >= icb[:, None] + 1) & (ii <= ict[:, None])
    return levels, unk, vnk, icb, ict, cloud


def _mixing_torch(levels, unk, vnk, icb, ict, cloud, fn=None):
    fn = fn or k2.emanuel_mixing
    return fn(*(T(a) for a in levels), T(unk), T(vnk), T(icb), T(ict),
              T(cloud))


@pytest.mark.parametrize("L", [20, 33, 64])
@pytest.mark.parametrize("ref", ["xla_layout_cf", "pallas_interpret"])
def test_emanuel_mixing_plain_matches_jax(ref, L):
    """Plain K2 against the JAX mixing body in both layouts, f64: the
    reductions reorder sums (cumsum vs triangular matmul), so 1e-10
    relative to each term's scale. L = 33 and 64 are where the CUDA
    kernel's lanes take two levels each (one up to 32), so the card
    comparison at those sizes holds the kernel to a verified reference."""
    levels, unk, vnk, icb, ict, cloud = _mixing_inputs(L=L)
    J = [jnp.asarray(a) for a in levels]
    L = levels[0].shape[1]
    if ref == "xla_layout_cf":
        want = jem._mixing_body(*J, jnp.asarray(unk), jnp.asarray(vnk),
                                jnp.asarray(icb, jnp.int32),
                                jnp.asarray(ict, jnp.int32),
                                jnp.asarray(cloud), jem._LayCF(L))
    else:
        want = pk.emanuel_mixing(jem._mixing_body, jem._LayCL, *J,
                                 jnp.asarray(unk), jnp.asarray(vnk),
                                 jnp.asarray(icb, jnp.int32),
                                 jnp.asarray(ict, jnp.int32),
                                 jnp.asarray(cloud), cb=128,
                                 interpret=True)
    got = _mixing_torch(levels, unk, vnk, icb, ict, cloud)
    assert set(got) == set(want) == set(k2.KEYS)
    for k in k2.KEYS:
        assert _rel(got[k].numpy(), want[k]) < 1e-10, k


def test_emanuel_mixing_plain_branch_counts():
    """The branch counts that size K2's work leave the result unchanged
    and nest as the branches do: use_min within c_cond within the valid
    pairs with j > i, redo only where j > i."""
    levels, unk, vnk, icb, ict, cloud = _mixing_inputs()
    ncol, L = levels[0].shape
    counts = {}
    plain = k2.emanuel_mixing_plain
    got = _mixing_torch(levels, unk, vnk, icb, ict, cloud,
                        fn=lambda *a: plain(*a, counts=counts))
    want = _mixing_torch(levels, unk, vnk, icb, ict, cloud, fn=plain)
    for k in k2.KEYS:
        assert torch.equal(got[k], want[k]), k
    assert 0 < counts["use_min"] <= counts["c_cond"] <= counts["valid_gt"] \
        < counts["valid"] < ncol * L * L
    assert 0 < counts["redo"] <= ncol * L * (L - 1) // 2


def _w_inputs(seed=7, shape=(40, 24, 40)):
    """The operands of tests/test_moloch.py's implicit-w test."""
    rng = np.random.default_rng(seed)
    n, iy, jx = shape
    return (rng.normal(size=(n, iy, jx)),
            rng.uniform(0.01, 0.5, (n, iy, jx)),
            rng.uniform(0.01, 0.5, (n, iy, jx)),
            rng.normal(size=(iy, jx)))


def _w_scan(wexpl, zm, zp, wbot):
    """The lax.scan sweeps of MolochCore._sound (moloch.py:566-588)."""
    kz = wexpl.shape[0] + 1

    def up_body(carry, K):
        w_kp1, wwkw_kp1 = carry
        i = K - 1
        zrapp = 1.0 / (1.0 + zm[i] + zp[i] - zm[i] * wwkw_kp1)
        w_k = zrapp * (wexpl[i] + zm[i] * w_kp1)
        return (w_k, zrapp * zp[i]), (w_k, zrapp * zp[i])

    _, (wpr, wwr) = jax.lax.scan(up_body, (wbot, jnp.zeros_like(wbot)),
                                 jnp.arange(kz - 1, 0, -1))
    wprov, wwkw = jnp.flip(wpr, 0), jnp.flip(wwr, 0)

    def dn_body(w_km1, i):
        w_k = wprov[i] + wwkw[i] * w_km1
        return w_k, w_k

    return jax.lax.scan(dn_body, jnp.zeros_like(wbot),
                        jnp.arange(kz - 1))[1]


@pytest.mark.parametrize("shape", [(40, 24, 40), (40, 37, 45), (1, 5, 7)])
@pytest.mark.parametrize("ref", ["pallas_interpret", "lax_scan"])
def test_tridiag_w_plain_matches_jax(ref, shape):
    """Plain K3 against the Pallas kernel (interpret mode) and the
    lax.scan sweeps: the same recurrence in the same order, so 1e-13
    relative covers any rounding difference. The odd 37x45 plane and the
    one-interface column are edge shapes of the CUDA kernel."""
    args = _w_inputs(shape=shape)
    J = [jnp.asarray(a) for a in args]
    want = pk.tridiag_w(*J, interpret=True) if ref == "pallas_interpret" \
        else _w_scan(*J)
    got = k3.tridiag_w(*(T(a) for a in args))
    assert _rel(got.numpy(), want) <= 1e-13


def _waf_core(iy, jx, kz):
    cfg = RegCMConfig()
    cfg.core.idynamic = 3
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = iy, jx, kz
    cfg.geo.ds = 3.0
    cfg.time.dt = 20.0
    return MolochCore(build_grid(cfg), cfg, dtype=jnp.float64)


def _waf_inputs(core, seed=11):
    """The operands of tests/test_moloch.py's WAF test: smooth fields
    with noise, a mean wind and a vertical velocity of both signs."""
    rng = np.random.default_rng(seed)
    kz, iy, jx = core.kz, core.iy, core.jx
    sm = lambda sh: rng.normal(size=sh) + 10.0 * np.sin(
        np.linspace(0, 3, np.prod(sh)).reshape(sh))
    fields = sm((3, kz, iy, jx))
    u = 8.0 + sm((kz, iy, jx)) * 0.5
    v = -5.0 + sm((kz, iy, jx)) * 0.5
    s = sm((kz + 1, iy, jx)) * 0.1
    return fields, u, v, s


@pytest.mark.parametrize("size", [(16, 16, 14), (13, 21, 18)])
@pytest.mark.parametrize("ref", ["pallas_interpret", "xla_wafone"])
def test_waf_advect_plain_matches_jax(size, ref):
    """Plain K4 against the fused Pallas kernel (interpret mode) and
    jax.vmap(MolochCore._wafone), square and non-square: the same f64
    arithmetic and the same upwind/limiter thresholds, so 1e-12."""
    core = _waf_core(*size)
    fields, u, v, s = _waf_inputs(core)
    dta = core.dtsec / core.nadv
    ops = [np.array(a) for a in (u * np.asarray(core.rmu)[None],
                                   v * np.asarray(core.rmv)[None], s,
                                   core.fmz, core.fmzf, core.mx2,
                                   core.m_ci)]
    if ref == "pallas_interpret":
        want = pk.waf_advect(jnp.asarray(fields),
                             *(jnp.asarray(a) for a in ops),
                             dta / core.dx, dta / core.dz, interpret=True)
    else:
        J = jnp.asarray
        want = jax.vmap(lambda f: core._wafone(f, J(u), J(v), J(s),
                                               dta))(J(fields))
    got = k4.waf_advect(T(fields), *(T(a) for a in ops), dta / core.dx,
                        dta / core.dz)
    assert got.shape == fields.shape
    assert _rel(got.numpy(), want) <= 1e-12


def _waf_edge_inputs(shape, seed=11):
    """WAF operands at any (nf, kz, iy, jx): smooth fields with noise,
    winds and s of both signs, metric factors near 1, fmzf = 0 at the
    top, the interior mask of the MOLOCH core."""
    rng = np.random.default_rng(seed)
    nf, kz, iy, jx = shape
    sm = lambda sh: rng.normal(size=sh) + 10.0 * np.sin(
        np.linspace(0, 3, int(np.prod(sh))).reshape(sh))
    fmzf = 1.0 + 0.05 * rng.random((kz + 1, iy, jx))
    fmzf[0] = 0.0
    m_ci = np.zeros((iy, jx))
    m_ci[1:iy - 2, 1:jx - 2] = 1.0
    return (sm(shape), 8.0 + 0.5 * sm((kz, iy, jx)),
            -5.0 + 0.5 * sm((kz, iy, jx)), 0.1 * sm((kz + 1, iy, jx)),
            1.0 + 0.05 * rng.random((kz, iy, jx)), fmzf,
            1.0 + 0.01 * rng.random((iy, jx)), m_ci)


def test_cpu_calls_launch_no_kernel():
    k1.launches = k2.launches = k3.launches = k4.launches = 0
    c1, c2, c3, rhs = _coefs(*_tridiag_inputs(shape=(2, 6, 3, 4)),
                             dt=150.0)
    k1.pbl_tridiag(*(T(a) for a in (c1, c2, c3, rhs)))
    _mixing_torch(*_mixing_inputs(ncol=8, L=12))
    k3.tridiag_w(*(T(a) for a in _w_inputs(shape=(5, 6, 7))))
    core = _waf_core(8, 9, 14)
    fields, u, v, s = _waf_inputs(core)
    k4.waf_advect(T(fields), *(T(np.array(a)) for a in (
        u, v, s, core.fmz, core.fmzf, core.mx2, core.m_ci)), 0.1, 0.01)
    assert (k1.launches, k2.launches, k3.launches, k4.launches) == \
        (0, 0, 0, 0)


@pytest.mark.parametrize("mod", [k1, k3], ids=["pbl_tridiag", "tridiag_w"])
def test_column_longer_than_kernel_limit_raises(mod):
    """A column longer than the CUDA kernel's MAX_LEVELS is refused with
    a ValueError naming the limit on any tensor that would reach the
    kernel (a meta tensor here: the check precedes the launch), while the
    plain version on the CPU takes any length."""
    n = mod.MAX_LEVELS + 1
    if mod is k1:
        shape = (1, n, 2, 3)
        args = [torch.ones(shape, dtype=torch.float64) for _ in range(4)]
        args[2][:, 0] = 0.0
        args[1] += 2.0
    else:
        shape = (n, 2, 3)
        args = [torch.full(shape, 0.1, dtype=torch.float64)
                for _ in range(3)] + [torch.ones(2, 3, dtype=torch.float64)]
    fn = getattr(mod, mod.__name__.rsplit(".", 1)[1])
    assert torch.isfinite(fn(*args)).all()
    with pytest.raises(ValueError, match=f"MAX_LEVELS = {mod.MAX_LEVELS}"):
        fn(*(a.to("meta") for a in args))


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """On a CUDA card: each hand-written kernel against its plain
    version at the test_001 shapes, a ragged MOLOCH shape and the edge
    shapes of K1-K4, and K1, K3 refusing a column longer than their
    MAX_LEVELS (chip_smoke.py runs the full comparison, more shapes and
    two dtypes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    c1, c2, c3, rhs = _coefs(*_tridiag_inputs(shape=(5, 18, 34, 48)),
                             dt=150.0)
    args = [T(a).to(dev) for a in (c1, c2, c3, rhs)]
    got = k1.pbl_tridiag(*args)
    torch.cuda.synchronize()
    assert _rel(got.cpu().numpy(),
                k1.pbl_tridiag_plain(*args).cpu().numpy()) < 1e-12
    levels, unk, vnk, icb, ict, cloud = _mixing_inputs(ncol=34 * 48, L=18)
    dargs = [T(a).to(dev) for a in (*levels, unk, vnk, icb, ict, cloud)]
    got = k2.emanuel_mixing(*dargs)
    want = k2.emanuel_mixing_plain(*dargs)
    torch.cuda.synchronize()
    for k in k2.KEYS:
        assert _rel(got[k].cpu().numpy(), want[k].cpu().numpy()) < 1e-10
    wargs = [T(a).to(dev) for a in _w_inputs(shape=(13, 34, 48))]
    got = k3.tridiag_w(*wargs)
    torch.cuda.synchronize()
    assert _rel(got.cpu().numpy(),
                k3.tridiag_w_plain(*wargs).cpu().numpy()) < 1e-12
    core = _waf_core(34, 48, 14)
    fields, u, v, s = _waf_inputs(core)
    fields = np.concatenate([fields, fields[:2] * 0.5, fields[:2] + 3.0])
    dargs = [T(np.array(a)).to(dev) for a in (
        fields, u, v, s, core.fmz, core.fmzf, core.mx2, core.m_ci)]
    got = k4.waf_advect(*dargs, 0.02, 0.003)
    torch.cuda.synchronize()
    assert _rel(got.cpu().numpy(), k4.waf_advect_plain(
        *dargs, 0.02, 0.003).cpu().numpy()) < 1e-12
    # the shapes that stress the kernels' layouts: K2 with one level a
    # lane (L = 32) and two (33, 64); K4 on tiles the domain's edge cuts
    # (37x45, one field of two levels), and its halo form on blocks of
    # unequal size, bit for bit
    for L in (32, 33, 64):
        levels, unk, vnk, icb, ict, cloud = _mixing_inputs(ncol=500, L=L)
        dargs = [T(a).to(dev) for a in (*levels, unk, vnk, icb, ict, cloud)]
        got = k2.emanuel_mixing(*dargs)
        want = k2.emanuel_mixing_plain(*dargs)
        torch.cuda.synchronize()
        for k in k2.KEYS:
            assert _rel(got[k].cpu().numpy(),
                        want[k].cpu().numpy()) < 1e-10, (L, k)
    # K1 and K3 on an odd plane (37x45: unaligned rows, a ragged last
    # block), on one-level columns and on columns of 100 levels
    for shape in ((5, 41, 37, 45), (2, 1, 5, 7), (1, 100, 16, 20)):
        args = [T(a).to(dev) for a in _coefs(*_tridiag_inputs(shape=shape),
                                             dt=150.0)]
        got = k1.pbl_tridiag(*args)
        torch.cuda.synchronize()
        assert _rel(got.cpu().numpy(), k1.pbl_tridiag_plain(
            *args).cpu().numpy()) < 1e-12, shape
    for shape in ((40, 37, 45), (1, 5, 7), (99, 16, 20)):
        wargs = [T(a).to(dev) for a in _w_inputs(shape=shape)]
        got = k3.tridiag_w(*wargs)
        torch.cuda.synchronize()
        assert _rel(got.cpu().numpy(), k3.tridiag_w_plain(
            *wargs).cpu().numpy()) < 1e-12, shape
    with pytest.raises(ValueError, match="MAX_LEVELS"):
        k1.pbl_tridiag(*(torch.ones((1, k1.MAX_LEVELS + 1, 2, 3),
                                    device=dev) for _ in range(4)))
    with pytest.raises(ValueError, match="MAX_LEVELS"):
        k3.tridiag_w(*(torch.ones((k3.MAX_LEVELS + 1, 2, 3), device=dev)
                       for _ in range(3)), torch.ones((2, 3), device=dev))
    ops = [T(a).to(dev) for a in _waf_edge_inputs((1, 2, 37, 45))]
    got = k4.waf_advect(*ops, 0.01, 0.15)
    torch.cuda.synchronize()
    assert torch.equal(got, k4.waf_advect_plain(*ops, 0.01, 0.15))
    ops = [T(a).to(dev) for a in _waf_edge_inputs((7, 14, 34, 48))]
    whole = k4.waf_advect(*ops, 0.01, 0.15)
    modes = ["zero"] * 4 + ["edge"] * 2 + ["zero"] * 2
    ys, xs = (0, 11, 23, 34), (0, 20, 48)
    rows = []
    for y0, y1 in zip(ys[:-1], ys[1:]):
        rows.append(torch.cat([k4.waf_advect_halo(
            *(extend_block(a, y0, x0, y1 - y0, x1 - x0, 2, m)
              for a, m in zip(ops, modes)), 0.01, 0.15, 34, 48, y0, x0)
            for x0, x1 in zip(xs[:-1], xs[1:])], dim=-1))
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(rows, dim=-2), whole)


@pytest.mark.cuda
def test_emanuel_mixing_tracer_form_on_card():
    """On a CUDA card: K2's tracer form against its plain version in both
    dtypes, with one level a lane (L = 18, configuration E's) and two (L
    = 41), at 12 and 32 tracers (the limit); the eight terms at the
    eight-term bound, sum_tra at 1e-12 (f64) and 1e-5 (f32)."""
    _tracer_form_on_card(((18, 12), (41, 32)))


def _tracer_form_on_card(cases):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    for L, ntr in cases:
        levels, unk, vnk, icb, ict, cloud = _mixing_inputs(ncol=700, L=L)
        tra = rng.uniform(0.0, 1e-6, (700, L, ntr))
        trank = rng.uniform(0.0, 1e-6, (700, ntr))
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            f = lambda a: T(np.asarray(a)).to(dev, dtype)
            dargs = [f(a) for a in (*levels, unk, vnk)] + [
                T(icb).to(dev), T(ict).to(dev), T(cloud).to(dev)]
            got = k2.emanuel_mixing(*dargs, tra=f(tra), trank=f(trank))
            want = k2.emanuel_mixing_plain(*dargs, tra=f(tra),
                                           trank=f(trank))
            torch.cuda.synchronize()
            for k in k2.KEYS:
                assert _rel(got[k].double().cpu().numpy(), want[k].double()
                            .cpu().numpy()) < max(1e-10, tol), (L, k)
            assert _rel(got["sum_tra"].double().cpu().numpy(),
                        want["sum_tra"].double().cpu().numpy()) < tol


@pytest.mark.cuda
def test_emanuel_mixing_tracer_form_past_32_on_card(tmp_path):
    """On a CUDA card: K2's tracer form at the gas-phase tracer counts
    (CBMZ 37, DCCB 50, CB6 51) and its limit (64), f64 past 48 KB of shared
    memory, against its plain version; and at 32 tracers and fewer bit for
    bit the previous source's (the one that stopped at 32), which
    ``tools/chip_chem.py`` rebuilds by taking the change back."""
    _tracer_form_on_card(((18, 37), (18, 50), (41, 51), (41, 64)))
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "tools" / "chip_chem.py"
    spec = importlib.util.spec_from_file_location("chip_chem", path)
    chip_chem = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_chem)
    chip_chem.previous_k2_check(torch.device("cuda"), tmp_path)


def _stage_matrices(ncell, n, seed=6):
    """Stage matrices I·2 − J of the gas solver's form and right-hand
    sides, numpy."""
    rng = np.random.default_rng(seed)
    p = 2.0 * np.eye(n) - rng.normal(size=(ncell, n, n)) / np.sqrt(n)
    return p, rng.normal(size=(ncell, n))


def test_gas_lu_plain_solves_on_cpu():
    """K6's wrapper on CPU tensors: the plain version (LAPACK), no launch;
    the factorisation solves P x = b and serves a second right-hand side;
    mismatched shapes and dtypes are refused."""
    from regcm_tpu_torch.kernels import gas_lu as k6
    p, b = _stage_matrices(50, 58)
    k6.launches = k6.launches_solve = 0
    lu, piv, x = k6.lu_factor_solve(T(p), T(b))
    np.testing.assert_allclose(np.einsum("cij,cj->ci", p, x.numpy()), b,
                               rtol=0, atol=1e-12)
    y = k6.lu_solve(lu, piv, T(2.0 * b))
    np.testing.assert_allclose(y.numpy(), 2.0 * x.numpy(), rtol=1e-13,
                               atol=1e-13)
    assert k6.launches == k6.launches_solve == 0
    with pytest.raises(ValueError):
        k6.lu_factor_solve(T(p), T(b[:, :57]))
    with pytest.raises(TypeError):
        k6.lu_factor_solve(T(p).to(torch.int64), T(b))
    with pytest.raises(ValueError):
        k6.lu_factor_solve(T(p), T(b).float())


@pytest.mark.cuda
def test_gas_lu_on_card():
    """On a CUDA card: K6's factorisation and both solves against the plain
    version (torch.linalg.lu_factor and lu_solve), CBMZ's and CB6's sizes
    and the kernel's limit, f64 at 1e-12 and f32 at 1e-5 of the solution's
    scale, the plain version's pivots kept; a launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from regcm_tpu_torch.kernels import gas_lu as k6
    dev = torch.device("cuda")
    for ncell, n in ((1000, 58), (333, 76), (100, 96), (65, 5)):
        p, b = _stage_matrices(ncell, n)
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            f = lambda a: T(a).to(dev, dtype)
            k6.launches = k6.launches_solve = 0
            lu, piv, x = k6.lu_factor_solve(f(p), f(b))
            y = k6.lu_solve(lu, piv, f(2.0 * b))
            assert k6.launches == k6.launches_solve == 1
            lu_w, piv_w, x_w = k6.lu_factor_solve_plain(f(p), f(b))
            y_w = k6.lu_solve_plain(lu_w, piv_w, f(2.0 * b))
            torch.cuda.synchronize()
            assert torch.equal(piv.long().cpu() + 1, piv_w.long().cpu())
            for g, w in ((x, x_w), (y, y_w), (lu, lu_w)):
                assert _rel(g.double().cpu().numpy(),
                            w.double().cpu().numpy()) < tol, (n, dtype)
