"""Column physics of the PyTorch port against the JAX package, one test
per scheme, on the same numpy columns in float64. Elementwise schemes
agree to roundoff; where sums are reordered (cumsum, LW all-pairs
contractions, per-column sums) the bound is 1e-10 relative to each
output's scale."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from regcm_tpu.dynamics import stencil as jst  # noqa: E402
from regcm_tpu.physics.radiation.ccm3.tables import ghg_mmr  # noqa: E402
from regcm_tpu.physics.radiation.ghg import ghg_concentrations  # noqa
from regcm_tpu_torch.dynamics import stencil as tst  # noqa: E402

TOL = 1e-10
KZ, IY, JX = 14, 6, 7


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.tensor(np.asarray(a))


def _check(got, want, tol=TOL, name=""):
    """Max error relative to the reference's scale, field by field."""
    if hasattr(want, "_fields"):
        for f in want._fields:
            w = getattr(want, f)
            if w is not None:
                _check(getattr(got, f), w, tol, f"{name}.{f}")
        return
    if isinstance(want, dict):
        for k in want:
            _check(got[k], want[k], tol, f"{name}[{k}]")
        return
    if isinstance(want, (tuple, list)):
        for n, (g, w) in enumerate(zip(got, want)):
            _check(g, w, tol, f"{name}[{n}]")
        return
    w = np.asarray(want)
    g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert g.shape == w.shape, name
    if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w, err_msg=name)
        return
    err = np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-300)
    assert err <= tol, f"{name}: {err:.3e}"


def _columns(seed=0, kz=KZ, iy=IY, jx=JX):
    """A moist sigma-level atmosphere with noise: pressures (Pa),
    temperature, humidity, cloud, winds and heights."""
    rng = np.random.default_rng(seed)
    sig = np.linspace(0.0, 1.0, kz + 1) ** 1.3
    hs = 0.5 * (sig[1:] + sig[:-1])
    ps = rng.uniform(93.0, 101.0, (iy, jx))          # p* (cb)
    pf = (sig[:, None, None] * ps[None] + 5.0) * 1000.0
    pb = (hs[:, None, None] * ps[None] + 5.0) * 1000.0
    t = np.maximum(288.0 * (pb / 101325.0) ** 0.19, 210.0) \
        + rng.normal(0.0, 1.0, pb.shape)
    es = 611.2 * np.exp(17.67 * (t - 273.15) / (t - 29.65))
    qs = 0.622 * es / (pb - es)
    qv = qs * rng.uniform(0.4, 1.02, pb.shape)
    qc = np.where(rng.uniform(0, 1, pb.shape) > 0.5,
                  rng.uniform(1e-7, 8e-4, pb.shape), 0.0)
    dzq = 287.0 * t / 9.80616 * np.log(pf[1:] / pf[:-1])
    zq = np.concatenate([np.cumsum(dzq[::-1], 0)[::-1],
                         np.zeros((1, iy, jx))], 0)
    za = 0.5 * (zq[:-1] + zq[1:])
    return dict(rng=rng, ps=ps, pf=pf, pb=pb, t=t, qv=qv, qs=qs, qc=qc,
                dzq=dzq, za=za, rh=np.clip(qv / qs, 0.01, 1.01),
                rho=pb / (287.0 * t),
                u=rng.uniform(-12, 12, pb.shape),
                v=rng.uniform(-12, 12, pb.shape))


def test_subex_and_clouds_match_jax():
    from regcm_tpu.physics.micro import subex as jm
    from regcm_tpu_torch.physics.micro import subex as tm

    c = _columns(1)
    rng = c["rng"]
    rh0 = rng.uniform(0.8, 0.9, (1, IY, JX))
    fargs = (c["t"], c["pb"], c["qv"], c["qc"], c["rh"], rh0)
    _check(tm.subex_cldfrac(*map(T, fargs)), jm.subex_cldfrac(*map(J, fargs)),
           1e-14, "subex_cldfrac")
    fcc = np.asarray(jm.subex_cldfrac(*map(J, fargs)))
    cum_f = np.where(rng.uniform(0, 1, fcc.shape) > 0.6,
                     rng.uniform(0.01, 0.6, fcc.shape), 0.0)
    cum_l = rng.uniform(0.0, 0.5, fcc.shape)
    cargs = (fcc, c["qc"], c["rho"], c["t"], cum_f, cum_l)
    _check(tm.combine_clouds(*map(T, cargs)),
           jm.combine_clouds(*map(J, cargs)), 1e-14, "combine_clouds")
    two = lambda lo, hi: rng.uniform(lo, hi, (IY, JX))
    sargs = (c["t"], c["pb"], c["pf"], c["qv"], c["qc"], c["rh"], c["rho"],
             fcc, c["ps"])
    coefs = (two(2e-4, 3e-4), two(0.3, 0.5), two(1e-3, 2e-3), two(2.5, 3.5))
    want = jm.subex(*map(J, sargs), 300.0, *map(J, coefs))
    got = tm.subex(*map(T, sargs), 300.0, *map(T, coefs))
    assert float(np.asarray(want.precip).max()) > 0.0
    _check(got, want, TOL, "subex")


def test_holtbl_matches_jax():
    from regcm_tpu.physics.pbl.holtslag import holtbl as jhb
    from regcm_tpu_torch.physics.pbl.holtslag import holtbl as thb

    c = _columns(2)
    rng = c["rng"]
    two = lambda lo, hi: rng.uniform(lo, hi, (IY, JX))
    ps2d = (c["ps"] + 5.0) * 1000.0
    tp3 = c["t"] * (ps2d[None] / c["pb"]) ** 0.2857
    hfx = two(-40.0, 300.0)
    hfx[0, :3] = (0.0, 1e-30, -1e-30)              # flux sign branches
    kmx = np.full((IY, JX), 4, dtype=np.int64)
    psb = c["ps"]
    args = (tp3, c["t"], c["pb"], c["pf"], c["qv"], c["qc"], c["u"],
            c["v"], c["u"] * 0.9, c["v"] * 1.1, c["za"], c["dzq"],
            ps2d / (287.0 * c["t"][-1]), two(1e-3, 2e-2), hfx,
            two(-1e-5, 2e-4), c["t"][-1] + two(-3.0, 3.0),
            two(5e-5, 1.2e-4), psb, psb * 0.99)
    m_ci = (rng.uniform(0, 1, (IY, JX)) > 0.1).astype(float)
    with jst.topology(), tst.topology():
        want = jhb(*map(J, args), J(kmx), 300.0, cross2dot_fn=jst.cross2dot,
                   m_di=J(m_ci), m_ci=J(m_ci))
        got = thb(*map(T, args), T(kmx), 300.0, cross2dot_fn=tst.cross2dot,
                  m_di=T(m_ci), m_ci=T(m_ci))
    for f in got._fields:
        _check(getattr(got, f), getattr(want, f), 1e-12, f"holtbl.{f}")


def test_cupeman_matches_jax():
    from regcm_tpu.physics.cumulus import emanuel as je
    from regcm_tpu_torch.physics.cumulus import emanuel as te

    c = _columns(5, iy=12, jx=25)
    ncol = 12 * 25
    flipc = lambda a: np.ascontiguousarray(a[::-1].reshape(a.shape[0],
                                                           ncol).T)
    t = c["t"] + 6.0 * np.linspace(0, 1, KZ)[:, None, None]   # unstable
    qspec = c["qv"] / (1.0 + c["qv"])
    qsspec = c["qs"] / (1.0 + c["qs"])
    args = [flipc(t), flipc(qspec), flipc(qsspec), flipc(c["u"]),
            flipc(c["v"]), flipc(c["pb"]) * 0.01, flipc(c["pf"]) * 0.01]
    rng = c["rng"]
    cb = rng.uniform(0, 0.02, ncol) * (rng.uniform(0, 1, ncol) > 0.5)
    elc = np.where(rng.uniform(0, 1, ncol) > 0.5, 1.1e-3, 1.1e-4)
    epm = np.full(ncol, 0.999)
    want = je.cupeman(*map(J, args), J(cb), 300.0, J(elc), J(epm), 1)
    got = te.cupeman(*map(T, args), T(cb), 300.0, T(elc), T(epm), 1)
    assert int(np.asarray(want.active).sum()) > ncol // 4
    # every output field but ftra, None without tracers in both packages
    # (tests/test_torch_chem.py holds it)
    _check(got, want, TOL, "cupeman")


def _surface_inputs(seed):
    c = _columns(seed)
    rng = c["rng"]
    two = lambda lo, hi: rng.uniform(lo, hi, (IY, JX))
    ps2d = (c["ps"] + 5.0) * 1000.0
    t1 = c["t"][-1]
    return c, rng, two, ps2d, t1


def test_surface_fluxes_with_zeng_match_jax():
    from regcm_tpu.physics.surface import fluxes as jf
    from regcm_tpu.physics.surface import zeng as jz
    from regcm_tpu_torch.physics.surface import fluxes as tf
    from regcm_tpu_torch.physics.surface import zeng as tz

    c, rng, two, ps2d, t1 = _surface_inputs(6)
    land = (rng.uniform(0, 1, (IY, JX)) > 0.5).astype(float)
    args = (c["u"][-1], c["v"][-1], t1, c["qv"][-1], c["za"][-1],
            ps2d / (287.0 * t1), ps2d, t1 + two(-4, 4), t1 + two(-3, 3),
            land, two(0, 700), two(-120, -20), two(0, 1e-3))
    want = jf.surface_fluxes(*map(J, args), 600.0, iocnflx=2)
    got = tf.surface_fluxes(*map(T, args), 600.0, iocnflx=2)
    _check(got, want, TOL, "surface_fluxes")
    zargs = (c["u"][-1], c["v"][-1], t1, c["qv"][-1], c["za"][-1], ps2d,
             ps2d * 0.99, t1 + two(-3, 3), two(100, 1500))
    _check(tz.zengocn(*map(T, zargs)), jz.zengocn(*map(J, zargs)), TOL,
           "zengocn")


def test_vecbats_and_albedo_match_jax():
    from regcm_tpu.physics.surface import bats as jb
    from regcm_tpu_torch.physics.surface import bats as tb

    c, rng, two, ps2d, t1 = _surface_inputs(7)
    lveg = rng.choice([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 16, 17,
                       18, 19, 20, 21, 22], (IY, JX))
    ltex = rng.integers(1, 13, (IY, JX))
    ss = jb.soil_static(lveg, ltex)
    for k in ss:                                   # shared numpy tables
        np.testing.assert_array_equal(tb.soil_static(lveg, ltex)[k], ss[k])
    land = np.ones((IY, JX))
    land[0, :2] = 0.0
    tg = t1 + two(-4, 4)
    b0 = jb.bats_init_state(ss, land, tg)
    np.testing.assert_array_equal(tb.bats_init_state(ss, land, tg), b0)
    b0 = b0.copy()
    b0[4] = np.where(rng.uniform(0, 1, (IY, JX)) > 0.6, 30.0, 0.0)  # snow
    b0[5] = rng.uniform(0, 2, (IY, JX))
    q1 = c["qv"][-1]
    args = (t1, q1 / (1 + q1), c["u"][-1], c["v"][-1], c["za"][-1],
            ps2d / (287.0 * t1), ps2d, two(0, 1e-3), two(0, 700),
            two(20, 120), two(0, 700), two(-0.2, 1.0), tg, b0)
    jss = {k: J(v) for k, v in ss.items()}
    tss = tb.soil_static_tensors(ss)
    want = jb.vecbats(*map(J, args), jss, J(land), 600.0)
    got = tb.vecbats(*map(T, args), tss, T(land), 600.0)
    _check(got, want, TOL, "vecbats")
    aargs = (two(-0.2, 1.0), b0[0], b0[6], b0[4], b0[5])
    _check(tb.bats_albedo(*map(T, aargs), tss, T(land)),
           jb.bats_albedo(*map(J, aargs), jss, J(land)), 1e-14,
           "bats_albedo")


def _radiation_inputs(seed, iy=IY, jx=JX):
    c = _columns(seed, iy=iy, jx=jx)
    rng = c["rng"]
    two = lambda lo, hi: rng.uniform(lo, hi, (iy, jx))
    cf = np.where(c["qc"] > 0, rng.uniform(0.05, 0.9, c["qc"].shape), 0.0)
    lwc = np.where(c["qc"] > 0, rng.uniform(0.01, 0.5, c["qc"].shape), 0.0)
    args = [c["t"], c["qv"], c["qc"], np.zeros_like(c["qc"]), c["pb"],
            c["pf"], c["rh"], c["dzq"], cf, lwc, two(-0.3, 0.95),
            c["t"][-1] + two(-3, 3), (two(0, 1) > 0.5).astype(float),
            two(20, 60)] + [two(0.05, 0.4) for _ in range(6)] \
        + [two(0.95, 0.99)]
    g = ghg_concentrations("SSP585", 1990.0, 1950)
    ghg = ghg_mmr(dict(co2=g["co2ppm"], ch4=g["ch4ppb"], n2o=g["n2oppb"],
                       cfc11=g["cfc11ppt"], cfc12=g["cfc12ppt"]))
    return args, ghg


@pytest.mark.parametrize("do_abem", [True, False])
def test_ccm3_radiation_matches_jax(do_abem):
    """With do_abem the LW absorptivities are built and returned as the
    dtabem cache; without it the call consumes a given cache."""
    from regcm_tpu.physics.radiation.ccm3.driver import ccm3_radiation as jr
    from regcm_tpu_torch.physics.radiation.ccm3.driver import \
        ccm3_radiation as tr

    args, ghg = _radiation_inputs(8)
    kw = dict(eccf=1.01, solcon=1361.0, want_cache=do_abem)
    if not do_abem:
        src, _ = _radiation_inputs(9)
        _, cache = jr(*map(J, src), ghg, want_cache=True)
        kw_j = dict(kw, cache=cache)
        kw_t = dict(kw, cache={k: T(np.asarray(v)) for k, v in
                               cache.items()})
    else:
        kw_j = kw_t = kw
    want, wc = jr(*map(J, args), ghg, **kw_j)
    got, gc = tr(*map(T, args), ghg, **kw_t)
    _check(got, want, TOL, "ccm3")
    if do_abem:
        _check(gc, wc, TOL, "cache")
    else:
        assert gc is None and wc is None


def test_ccm3_radiation_column_chunks():
    """Column chunking (the JAX lax.map path) gives the unchunked
    answer: columns are independent."""
    from regcm_tpu_torch.physics.radiation.ccm3.driver import \
        ccm3_radiation as tr

    args, ghg = _radiation_inputs(10)
    full, fc = tr(*map(T, args), ghg, want_cache=True, col_chunk=0)
    part, pc = tr(*map(T, args), ghg, want_cache=True, col_chunk=11)
    _check(part, full, 1e-14, "chunked")
    _check(pc, fc, 1e-14, "chunked cache")


def test_broadband_radiation_and_albedo_match_jax():
    from regcm_tpu.physics.radiation import simple as js_
    from regcm_tpu_torch.physics.radiation import simple as ts_

    c = _columns(11)
    rng = c["rng"]
    two = lambda lo, hi: rng.uniform(lo, hi, (IY, JX))
    mu = two(-0.3, 0.95)
    land = (two(0, 1) > 0.5).astype(float)
    _check(ts_.surface_albedo(T(mu), T(land)),
           js_.surface_albedo(J(mu), J(land)), 1e-14, "surface_albedo")
    cf = np.where(c["qc"] > 0, 0.5, 0.0)
    args = (c["t"], c["qv"], c["pf"], c["pb"], cf, cf * 0.2, mu,
            c["t"][-1], two(0.1, 0.3))
    kw = dict(eccf=1.02, co2ppm=410.0, ch4ppb=1900.0, n2oppb=330.0)
    _check(ts_.radiation(*map(T, args), **kw),
           js_.radiation(*map(J, args), **kw), TOL, "radiation")
