"""The second physics set of the PyTorch port against the JAX package,
column by column, in f64 on the CPU: the seven cloud-fraction schemes
(icldfrac 0-6), the Nogherotto-Tompkins microphysics (nogtom, with and
without convective detrainment), the Tiedtke cumulus (ntiedtke on deep,
shallow and mid-level soundings) and the UW TCM PBL (uwtcm), each from
the same seeded numpy inputs; and the port's twins of the JAX package's
behaviour tests and oracles of these schemes."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from regcm_tpu.utils import constants as c  # noqa: E402

TOL = 1e-10


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    """max |got − want| over the scale max |want|."""
    got, want = _np(got).astype(float), _np(want).astype(float)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-300)


def _sigma_columns(kz, iy, jx, seed):
    """Layer/interface pressures, a standard-atmosphere T with noise
    and the Flatau saturation over (kz, iy, jx)."""
    from regcm_tpu_torch.utils.thermo import pfwsat
    rng = np.random.default_rng(seed)
    sig = (np.arange(kz) + 0.5) / kz
    sigf = np.arange(kz + 1) / kz
    ps = 100000.0 + 1500.0 * rng.standard_normal((iy, jx))
    ph = sig[:, None, None] * (ps - 5000.0)[None] + 5000.0
    pf = sigf[:, None, None] * (ps - 5000.0)[None] + 5000.0
    t = np.maximum(292.0 * (ph / 1.0e5) ** 0.19, 212.0) \
        + 0.8 * rng.standard_normal((kz, iy, jx))
    qs = pfwsat(_t(t), _t(ph)).numpy()
    return rng, ph, pf, ps, t, qs


# -- cloud fraction (icldfrac 0-6) --------------------------------------
def _cldfrac_inputs(seed=3):
    kz, iy, jx = 14, 5, 6
    rng, ph, pf, ps, t, qs = _sigma_columns(kz, iy, jx, seed)
    rh = np.clip(rng.uniform(0.3, 1.02, (kz, iy, jx)), 0.01, 1.01)
    qv = rh * qs
    qc = np.where(rng.uniform(size=(kz, iy, jx)) < 0.7,
                  rng.uniform(0.0, 4e-4, (kz, iy, jx)), 0.0)
    rh0 = np.where(rng.uniform(size=(iy, jx)) < 0.5, 0.8, 0.9)
    lnd = (rng.uniform(size=(iy, jx)) < 0.5).astype(float)
    return t, ph, qv, qc, rh, qs, rh0, ps, lnd


@pytest.mark.parametrize("icldfrac", range(7))
def test_cldfrac_matches_jax(icldfrac):
    """Every cloud-fraction scheme on random cloudy columns: 1e-10 (the
    fractions are elementwise but for Thompson's column searches)."""
    from regcm_tpu.physics.cloud.fractions import cldfrac_dispatch as jf
    from regcm_tpu_torch.physics.cloud.fractions import cldfrac_dispatch
    t, ph, qv, qc, rh, qs, rh0, ps, lnd = _cldfrac_inputs()
    for ds in (12.0, 50.0):
        want = jf(icldfrac, *[jnp.asarray(a) for a in
                              (t, ph, qv, qc, rh, qs, rh0[None], ps)],
                  ds, landmask=jnp.asarray(lnd))
        got = cldfrac_dispatch(icldfrac, *[_t(a) for a in
                                           (t, ph, qv, qc, rh, qs,
                                            rh0[None], ps)],
                               ds, landmask=_t(lnd))
        assert got.dtype == torch.float64
        assert np.abs(_np(got) - _np(want)).max() <= TOL, ds
        assert 0.0 < float(got.max()) <= 1.0


def _column(rh=0.9, kz=14):
    """test_physics.py's column: (t, ph, pf, qv, rho) as (kz, 2, 2)."""
    from regcm_tpu_torch.utils.thermo import pfwsat
    sig = (np.arange(kz) + 0.5) / kz
    sigf = np.arange(kz + 1) / kz
    ps = 96.325
    ph = np.broadcast_to(((sig * ps + 5.0) * 1000.0)[:, None, None],
                         (kz, 2, 2)).copy()
    pf = np.broadcast_to(((sigf * ps + 5.0) * 1000.0)[:, None, None],
                         (kz + 1, 2, 2)).copy()
    t = np.maximum(288.0 * (ph / 101325.0) ** 0.19, 210.0)
    qv = rh * pfwsat(_t(t), _t(ph)).numpy()
    return _t(t), _t(ph), _t(pf), _t(qv), _t(ph / (287.0 * t))


def test_cldfrac_limits():
    """Twin of tests/test_physics.py::test_cldfrac_limits on the port's
    SUBEX-Sundqvist fraction (icldfrac=0)."""
    from regcm_tpu_torch.physics.micro.subex import subex_cldfrac
    t, ph, pf, qv, rho = _column(rh=1.005)
    qc = torch.full_like(t, 1e-4)
    rh = torch.full_like(t, 1.0)
    rh0 = torch.full_like(t[0], 0.8)
    assert float(subex_cldfrac(t, ph, qv, qc, rh, rh0).max()) == 1.0
    fcc0 = subex_cldfrac(t, ph, qv, torch.zeros_like(qc), rh, rh0)
    assert float(fcc0.max()) == 0.0


def test_cloud_fraction_schemes():
    """Twin of tests/test_physics.py::test_cloud_fraction_schemes: every
    scheme bounded in [0,1], zero without condensate, increasing with
    RH."""
    from regcm_tpu_torch.physics.cloud.fractions import (
        xuran_cldfrac, gulisa_cldfrac, texeira_cldfrac, tompkins_cldfrac,
        echam5_cldfrac)
    from regcm_tpu_torch.utils.thermo import pfwsat
    t, ph, pf, qv, rho = _column(rh=0.9)
    qs = pfwsat(t, ph)
    qc = torch.full_like(t, 2e-4)
    rh_lo = torch.full_like(t, 0.5)
    rh_hi = torch.full_like(t, 0.95)
    ps2d = pf[-1]
    for name, lo, hi in (
            ("xuran", xuran_cldfrac(ph, qc, qv, qs, rh_lo),
             xuran_cldfrac(ph, qc, qv, qs, rh_hi)),
            ("texeira", texeira_cldfrac(qc, qs, rh_lo),
             texeira_cldfrac(qc, qs, rh_hi)),
            ("echam5", echam5_cldfrac(qc, rh_lo, ph, ps2d),
             echam5_cldfrac(qc, rh_hi, ph, ps2d)),
            ("tompkins", tompkins_cldfrac(qc, rh_lo, ph, ps2d),
             tompkins_cldfrac(qc, rh_hi, ph, ps2d))):
        assert float(lo.min()) >= 0.0 and float(hi.max()) <= 1.0, name
        assert float(hi.mean()) >= float(lo.mean()), name
    zero = torch.zeros_like(qc)
    assert float(xuran_cldfrac(ph, zero, qv, qs, rh_hi).max()) == 0.0
    g = gulisa_cldfrac(qv, qs, qc, 60.0)
    assert float(g.min()) >= 0.0 and float(g.max()) <= 1.0


# -- Nogherotto-Tompkins -------------------------------------------------
def _nogtom_inputs(seed=11):
    """Cloudy warm and cold columns with rain, ice and snow present,
    rising and sinking air and radiative cooling."""
    kz, iy, jx = 16, 4, 5
    rng, ph, pf, ps, t, qs = _sigma_columns(kz, iy, jx, seed)
    rho = ph / (c.rgas * t)
    qv = qs * rng.uniform(0.6, 1.04, (kz, iy, jx))
    cloudy = rng.uniform(size=(kz, iy, jx)) < 0.6
    u = lambda hi: np.where(cloudy, rng.uniform(0.0, hi, (kz, iy, jx)), 0.0)
    qx = np.stack([qv, u(6e-4), u(2e-4), u(2e-4), u(3e-4)])
    fcc = np.where(cloudy, rng.uniform(0.05, 1.0, (kz, iy, jx)), 0.0)
    heatrt = -2e-5 * rng.uniform(size=(kz, iy, jx))
    omega = 0.4 * rng.standard_normal((kz, iy, jx))
    qdetr = np.where(rng.uniform(size=(kz, iy, jx)) < 0.3,
                     rng.uniform(0.0, 5e-5, (kz, iy, jx)), 0.0)
    lnd = (rng.uniform(size=(iy, jx)) < 0.5).astype(float)
    return t, qx, ph, pf, rho, fcc, qdetr, heatrt, omega, lnd


@pytest.mark.parametrize("detrain", [False, True])
def test_nogtom_matches_jax(detrain):
    """One nogtom step over 20 columns of 16 levels, with and without
    Tiedtke's detrained water: every output within 1e-10 of its scale."""
    from regcm_tpu.physics.micro.nogtom import nogtom as jnogtom
    from regcm_tpu_torch.physics.micro.nogtom import nogtom
    args = list(_nogtom_inputs())
    if not detrain:
        args[6] = np.zeros_like(args[6])
    want = jnogtom(*[jnp.asarray(a) for a in args], 300.0)
    got = nogtom(*[_t(a) for a in args], 300.0)
    for name in want._fields:
        assert _rel(getattr(got, name), getattr(want, name)) <= TOL, name
    assert float(got.rainnc.max() + got.snownc.max()) > 0.0


def test_nogtom_microphysics():
    """Twin of tests/test_physics.py::test_nogtom_microphysics: cloudy
    columns rain, dry ones do not, and the column water closes on the
    surface flux."""
    from regcm_tpu_torch.physics.micro.nogtom import nogtom
    from regcm_tpu_torch.utils.thermo import pfwsat
    kz, iy, jx = 18, 3, 3
    sig = (np.arange(kz) + 0.5) / kz
    p0 = 101325.0
    ones = np.ones((kz, iy, jx))
    phs = (sig[:, None, None] * (p0 - 5000) + 5000) * ones
    sigf = np.arange(kz + 1) / kz
    pfs = (sigf[:, None, None] * (p0 - 5000) + 5000) \
        * np.ones((kz + 1, iy, jx))
    t = np.maximum(288.0 * (phs / p0) ** 0.19, 210.0)
    rho = phs / (287.0 * t)
    qs = pfwsat(_t(t), _t(phs)).numpy()
    qv = 0.97 * qs
    qv[:, 0, :] = 0.2 * qs[:, 0, :]           # dry row
    qc = np.zeros_like(t)
    qc[10:14, 1:, :] = 5e-4                   # cloud in moist rows
    qx = np.stack([qv, qc] + [np.zeros_like(t)] * 3)
    fcc = np.where(qc > 0, 0.9, 0.0)
    out = nogtom(*[_t(a) for a in
                   (t, qx, phs, pfs, rho, fcc, np.zeros_like(t),
                    np.zeros_like(t), np.full_like(t, -0.3),
                    np.ones((iy, jx)))], dt=300.0)
    assert all(torch.isfinite(v).all() for v in out)
    assert float(out.rainnc[1, 1] + out.snownc[1, 1]) > 0.0
    assert float(out.rainnc[0, 1] + out.snownc[0, 1]) < 1e-12
    dp = (pfs[1:] - pfs[:-1]) / 9.80665
    colchg = (out.qxten.sum(0).numpy() * dp).sum(axis=0)
    np.testing.assert_allclose(colchg, -(out.rainnc + out.snownc).numpy(),
                               rtol=1e-6, atol=1e-12)


def test_nogtom_autoconversion_oracle():
    """Twin of tests/test_oracles.py::test_nogtom_autoconversion_oracle:
    one warm cloudy layer, tiny dt, rain production at the explicit
    Sundqvist rate."""
    from regcm_tpu_torch.physics.micro import nogtom as N
    from regcm_tpu_torch.utils.thermo import pfwsat
    kz, dt = 6, 2.0
    t = np.full(kz, 290.0)
    p = np.linspace(60000.0, 98000.0, kz)
    pf = np.concatenate([[55000.0], 0.5 * (p[1:] + p[:-1]), [101000.0]])
    rho = p / (287.0 * t)
    qv = pfwsat(_t(t), _t(p)).numpy()
    qc = np.zeros(kz)
    k0 = 2
    qc[k0] = 8.0e-4
    cf = np.zeros(kz)
    cf[k0] = 0.5
    sh = lambda a: _t(np.asarray(a)[:, None, None])
    z = np.zeros(kz)
    out = N.nogtom(sh(t), torch.stack([sh(qv), sh(qc), sh(z), sh(z),
                                       sh(z)]),
                   sh(p), sh(pf), sh(rho), sh(cf), sh(z), sh(z), sh(z),
                   torch.ones((1, 1), dtype=torch.float64), dt)
    # rainaut is an implicit transfer coefficient multiplying ql in the
    # per-step solve: column rain production ≈ rainaut·qc·Δp/g up to
    # the implicit coupling with same-step processes (factor ~2)
    ql_incld = qc[k0] / cf[k0]
    alpha1 = min(N.RKCONV * dt, ql_incld)
    coeff = cf[k0] * alpha1 * (1.0 - np.exp(-(ql_incld
                                              / N.RCLCRIT_LAND) ** 2))
    dpg = (pf[1:] - pf[:-1]) / 9.80665
    col_qr = float((out.qxten[2][:, 0, 0].numpy() * dpg).sum()) * dt
    produced = col_qr + float(out.rainnc[0, 0]) * dt
    expected = coeff * qc[k0] * dpg[k0]
    assert 0.5 * expected < produced < 3.0 * expected, (produced,
                                                        expected)


# -- Tiedtke -------------------------------------------------------------
def _sounding(npx=4, nk=18, rh_nodes=(0.1, 0.4, 0.85, 0.92), dry=(2,),
              t0=302.0, inversion=None, seed=None):
    """test_tiedtke.py's tropical columns (moist unstable BL, one dry
    column), optionally capped by an inversion at sigma ``inversion``;
    the ntiedtke argument tuple as numpy, and (ph, pf)."""
    sig = (np.arange(nk) + 0.5) / nk
    ps, ptop = 100500.0, 5000.0
    ph = ptop + sig * (ps - ptop)
    pf = ptop + np.arange(nk + 1) / nk * (ps - ptop)
    t = np.zeros((npx, nk))
    z = 287.0 * 260.0 / 9.81 * np.log(ps / ph)
    t[:] = np.maximum(t0 - 6.5e-3 * z, 200.0)
    if inversion is not None:
        # warm the air above the inversion: a capped moist layer
        t[:, sig < inversion] += 8.0 * np.exp(
            -(sig[sig < inversion] - inversion) ** 2 / 0.02)
    if seed is not None:
        t += 0.3 * np.random.default_rng(seed).standard_normal(t.shape)
    qsat = 0.622 * 610.78 * np.exp(17.27 * (t - 273.15)
                                   / (t - 35.86)) / ph[None, :]
    rh = np.interp(sig, [0.0, 0.5, 0.8, 1.0], list(rh_nodes))
    q = qsat * rh[None, :]
    for n in dry:
        q[n] = qsat[n] * 0.15
    u = np.full((npx, nk), 3.0) + np.linspace(8.0, 0.0, nk)[None, :]
    v = np.full((npx, nk), -1.0) - np.linspace(4.0, 0.0, nk)[None, :]
    za = np.zeros((npx, nk))
    zf = np.zeros((npx, nk + 1))
    for k in range(nk - 1, -1, -1):
        tv = t[:, k] * (1 + 0.608 * q[:, k])
        zf[:, k] = zf[:, k + 1] + 287.0 * tv / 9.81 \
            * np.log(pf[k + 1] / pf[k])
        za[:, k] = 0.5 * (zf[:, k] + zf[:, k + 1])
    qhfl = np.zeros((npx, nk + 1))
    qhfl[:, nk] = -8e-5
    ahfs = np.zeros((npx, nk + 1))
    ahfs[:, nk] = -120.0
    ldland = (np.arange(npx) % 3) != 2
    args = (t, q, u, v, np.zeros((npx, nk)), qhfl, ahfs,
            np.broadcast_to(ph, (npx, nk)).copy(),
            np.broadcast_to(pf, (npx, nk + 1)).copy(), za * c.egrav,
            zf * c.egrav, np.full((npx, nk), 2e-8), np.zeros((npx, nk)),
            ldland)
    return args, ph, pf


def _midlevel_sounding():
    """test_cumulus_oracles.py's mid-level profile (stable PBL, moist
    lifted layer) as ntiedtke's positional arguments, omega and pref."""
    from .test_cumulus_oracles import _midlevel_profile
    t, q, omega, kw = _midlevel_profile()
    zz = np.zeros_like(np.asarray(t))
    args = (np.asarray(t), np.asarray(q), zz, zz) + tuple(
        np.asarray(kw[k]) for k in ("qctot", "qhfl", "ahfs", "ph", "pf",
                                    "geo", "geof", "tenq_dyn", "tent_dyn",
                                    "ldland"))
    return args, np.asarray(omega), kw


def _tiedtke_case(kind):
    """(ntiedtke's positional arguments, dtcum, dx, pref, omega) of a
    sounding: "deep", "shallow" (SOUNDINGS) or "mid"."""
    if kind == "mid":
        args, omega, kw = _midlevel_sounding()
        return args, kw["dtcum"], kw["dx"], kw["pref"], omega
    args, ph, _ = SOUNDINGS[kind]()
    return args, 60.0, 25000.0, ph.copy(), None


@functools.lru_cache(maxsize=None)
def _jax_tiedtke(kind, **kw):
    """The JAX package's ntiedtke on a sounding, as numpy (each call
    compiles its scans: the tests share one call per case)."""
    from regcm_tpu.physics.cumulus.tiedtke import ntiedtke as jnt
    args, dtcum, dx, pref, omega = _tiedtke_case(kind)
    out = jnt(*[jnp.asarray(a) for a in args], dtcum=dtcum, dx=dx,
              pref=pref, omega=None if omega is None else jnp.asarray(omega),
              **kw)
    return type(out)(*[np.asarray(x) for x in out])


def _tiedtke_pair(kind, **kw):
    """(the port's ntiedtke, the JAX package's) on a sounding."""
    from regcm_tpu_torch.physics.cumulus.tiedtke import ntiedtke
    args, dtcum, dx, pref, omega = _tiedtke_case(kind)
    targs = [torch.as_tensor(np.asarray(x)) if np.asarray(x).dtype == bool
             else _t(x) for x in args]
    got = ntiedtke(*targs, dtcum=dtcum, dx=dx, pref=pref,
                   omega=None if omega is None else _t(omega), **kw)
    return got, _jax_tiedtke(kind, **kw)


def _check_tiedtke(got, want):
    """Columns where both packages take the same branches (ktype,
    kcbot, kctop equal) agree at 1e-10; returns how many differ."""
    same = ((_np(got.ktype) == _np(want.ktype))
            & (_np(got.kcbot) == _np(want.kcbot))
            & (_np(got.kctop) == _np(want.kctop)))
    for name in got._fields:
        # the tracer-transport interface holds bool draught masks
        g, w = (_np(getattr(x, name)).astype(np.float64)
                for x in (got, want))
        if name in ("ktype", "kcbot", "kctop"):
            continue
        assert np.isfinite(g).all(), name
        scale = max(float(np.abs(w).max()), 1e-300)
        err = np.abs(g - w).reshape(len(same), -1).max(axis=1) / scale
        assert (err[same] <= TOL).all(), (name, err.max())
    return int((~same).sum())


def _capped_sounding():
    """The six columns of tests/test_tiedtke_cloudbase_oracle.py (deep
    from an elevated level, shallow under a low inversion, dry) as
    ntiedtke's arguments, and (ph, pf)."""
    from .test_tiedtke_cloudbase_oracle import _prepared_inputs
    t, q, _, _, _, pf, geof, ahfs, qhfl, _ = _prepared_inputs()
    npx, nk = t.shape
    ph = 0.5 * (pf[:, 1:] + pf[:, :-1])
    geo = 0.5 * (geof[:, 1:] + geof[:, :-1])
    u = np.full((npx, nk), 4.0) + np.linspace(6.0, 0.0, nk)[None, :]
    args = (t, q, u, -0.5 * u, np.zeros((npx, nk)), qhfl, ahfs, ph, pf,
            geo, geof, np.full((npx, nk), 2e-8), np.zeros((npx, nk)),
            np.arange(npx) % 2 == 0)
    return args, ph[0].copy(), pf[0]


SOUNDINGS = {
    # moist unstable tropical columns and one dry column
    "deep": lambda: _sounding(),
    # deep, capped (surface-rooted shallow) and dry columns
    "shallow": _capped_sounding,
}


@pytest.mark.parametrize("kind", ["deep", "shallow"])
def test_tiedtke_matches_jax(kind):
    got, want = _tiedtke_pair(kind)
    kt = _np(want.ktype)
    assert (kt == (1 if kind == "deep" else 2)).any(), kt
    assert _check_tiedtke(got, want) == 0
    np.testing.assert_array_equal(_np(got.ktype), kt)


def test_tiedtke_midlevel_matches_jax():
    """The mid-level (mcbase, ktype=3) regime with lmfmid on and off."""
    for lmfmid in (True, False):
        got, want = _tiedtke_pair("mid", lmfmid=lmfmid)
        assert (int(_np(want.ktype)[0]) == 3) == lmfmid
        assert _check_tiedtke(got, want) == 0


def test_tiedtke_lmfsmooth_leaves_the_tendencies():
    """lmfsmooth smooths the tracer-transport mass fluxes only: the
    port's outputs with it on equal the JAX package's with it on, and
    every output but the tracer-transport fluxes (``ct_*``) equals the
    JAX package's with it off; the smoothing moves those fluxes."""
    got, want_on = _tiedtke_pair("deep", lmfsmooth=True)
    want_off = _jax_tiedtke("deep")
    assert _check_tiedtke(got, want_on) == 0
    for name in got._fields:
        if not name.startswith("ct_"):
            np.testing.assert_array_equal(_np(getattr(want_on, name)),
                                          _np(getattr(want_off, name)))
    assert any(not np.array_equal(_np(getattr(want_on, n)),
                                  _np(getattr(want_off, n)))
               for n in ("ct_mfu", "ct_mfd", "ct_udrate", "ct_ddrate"))


def _port_tiedtke(args, ph, **kw):
    from regcm_tpu_torch.physics.cumulus.tiedtke import ntiedtke
    targs = tuple(torch.as_tensor(np.asarray(x)) if
                  np.asarray(x).dtype == bool else _t(x) for x in args)
    return ntiedtke(*targs, dtcum=60.0, dx=25000.0, pref=ph.copy(), **kw)


def test_tiedtke_column_deep():
    """Twin of tests/test_tiedtke.py::test_tiedtke_column_deep."""
    args, ph, pf = _sounding()
    out = _port_tiedtke(args, ph)
    kt = _np(out.ktype)
    assert (kt[[0, 1, 3]] == 1).all() and kt[2] == 0
    assert float(out.tten[2].abs().max()) == 0.0
    kc, kb = _np(out.kctop), _np(out.kcbot)
    assert (pf[kb[0]] - pf[kc[0]]) >= 2.0e4
    assert (_np(out.prate)[[0, 1, 3]] > 1e-5).all()
    cf = _np(out.cldfra)
    assert 0.0 <= cf.max() <= 0.6
    assert cf[0, kc[0]:kb[0] + 1].max() > 0.05
    assert 1e-6 < float(out.uten.abs().max()) < 0.05
    for name in out._fields:
        assert torch.isfinite(getattr(out, name).double()).all(), name


def test_tiedtke_budget_contracts():
    """Twin of tests/test_tiedtke.py::test_tiedtke_budget_contracts."""
    args, ph, pf = _sounding()
    out = _port_tiedtke(args, ph)
    dp = (pf[1:] - pf[:-1]) / c.egrav
    qint = (_np(out.qten + out.lten + out.iten) * dp[None]).sum(1)
    prate = _np(out.prate)
    for n in (0, 1, 3):
        assert prate[n] > 0
        assert abs(qint[n] + prate[n]) < 0.6 * abs(qint[n])
    tint = (_np(out.tten) * dp[None]).sum(1)
    assert (tint[[0, 1, 3]] > 0).all()


def test_tiedtke_fingerprint():
    """Twin of tests/test_cumulus_oracles.py::test_tiedtke_fingerprint:
    the port on the frozen single column within 1e-9."""
    from .test_cumulus_oracles import FP_TIEDTKE
    args, ph, pf = _sounding(npx=1, dry=())
    args = list(args)
    args[2] = np.full_like(args[2], 3.0)
    args[3] = np.full_like(args[3], -1.0)
    args[13] = np.array([True])
    out = _port_tiedtke(tuple(args), ph)
    fp = (float(out.prate[0]), float(out.tten[0].sum()),
          float(out.qten[0].sum()))
    np.testing.assert_allclose(fp, FP_TIEDTKE, rtol=1e-9, atol=1e-30)


def test_tiedtke_midlevel_ktype3():
    """Twin of tests/test_cumulus_oracles.py::
    test_tiedtke_midlevel_ktype3 (without the tracer flag, which the
    port does not form)."""
    from regcm_tpu_torch.physics.cumulus.tiedtke import ntiedtke
    args, omega, kw = _midlevel_sounding()
    targs = tuple(torch.as_tensor(np.asarray(x)) if
                  np.asarray(x).dtype == bool else _t(x) for x in args)
    run = lambda m: ntiedtke(*targs, dtcum=kw["dtcum"], dx=kw["dx"],
                             pref=kw["pref"], omega=_t(omega), lmfmid=m)
    on, off = run(True), run(False)
    assert int(on.ktype[0]) == 3 and int(off.ktype[0]) != 3
    assert torch.isfinite(on.tten).all()
    assert float(on.tten.abs().max()) > 0.0


def _cloudbase_case():
    from .test_tiedtke_cloudbase_oracle import (
        ENTRPEN_LND, _prepared_inputs)
    (t, q, tf, qf, qs, pf, geof, ahfs, qhfl,
     pnorm) = _prepared_inputs()
    npx, nk = t.shape
    entrpen = np.full(npx, ENTRPEN_LND)
    kt1 = int(np.argmax(pf[0, 1:] > 350.0e2))
    kt2 = int(np.argmax(pf[0, 1:] > 60.0e2))
    return (t, q, tf, qf, qs, pf, geof, ahfs, qhfl, entrpen, kt1, kt2,
            pnorm)


def _port_cloudbase(case):
    from regcm_tpu_torch.physics.cumulus.tiedtke import cloudbase_search
    (t, q, tf, qf, qs, pf, geof, ahfs, qhfl, entrpen, kt1, kt2,
     pnorm) = case
    got = cloudbase_search(*[_t(a) for a in (t, q, tf, qf, qs, pf, geof,
                                             ahfs, qhfl, entrpen)],
                           kt1, kt2, pnorm)
    return [_np(x) for x in got]


def test_cloudbase_search_vs_fortran_oracle():
    """Twin of tests/test_tiedtke_cloudbase_oracle.py::
    test_cloudbase_search_vs_fortran_oracle: the port's departure-level
    search against the loop-by-loop numpy transcription of the
    reference's cloudbase."""
    from .test_tiedtke_cloudbase_oracle import cloudbase_oracle
    case = _cloudbase_case()
    nk = case[0].shape[1]
    (ldcum_e, kcbot_e, ictop0_e, idpl_e, wubase_e, tu_e, qu_e, lu_e,
     ilab_e) = cloudbase_oracle(*case[:12])
    (ldcum, kcbot, ictop0, idpl, wubase, tu, qu, lu,
     ilab) = _port_cloudbase(case)
    assert ldcum_e.any() and (~ldcum_e).any()
    np.testing.assert_array_equal(ldcum, ldcum_e)
    np.testing.assert_array_equal(kcbot[ldcum_e], kcbot_e[ldcum_e])
    np.testing.assert_array_equal(ictop0[ldcum_e], ictop0_e[ldcum_e])
    np.testing.assert_array_equal(kcbot[~ldcum_e],
                                  np.full((~ldcum_e).sum(), nk - 2))
    np.testing.assert_array_equal(idpl, idpl_e)
    np.testing.assert_array_equal(ilab, ilab_e)
    np.testing.assert_allclose(wubase, wubase_e, rtol=5e-6, atol=1e-12)
    np.testing.assert_allclose(tu, tu_e, rtol=5e-6)
    np.testing.assert_allclose(qu, qu_e, rtol=5e-6, atol=1e-12)
    np.testing.assert_allclose(lu, lu_e, rtol=5e-6, atol=1e-12)


def test_cloudbase_deep_shallow_split():
    """Twin of tests/test_tiedtke_cloudbase_oracle.py::
    test_cloudbase_oracle_deep_shallow_split on the port's search: deep
    columns depart from an elevated level, capped ones are shallow from
    the surface round, the dry column is off; and the port equals the
    JAX package's search exactly in the integer outputs."""
    from regcm_tpu.physics.cumulus.tiedtke import cloudbase_search as jcs
    from regcm_tpu.physics.cumulus.tiedtke import RDEPTHS
    case = _cloudbase_case()
    nk = case[0].shape[1]
    (ldcum, kcbot, ictop0, idpl, wubase, tu, qu, lu,
     ilab) = _port_cloudbase(case)
    pf = case[5]
    assert not ldcum[2] and ldcum[[0, 1, 3, 4, 5]].all()
    ar = np.arange(len(ldcum))
    depth = np.where(ldcum, pf[ar, kcbot] - pf[ar, ictop0], 0.0)
    deep = ldcum & (depth >= RDEPTHS)
    shal = ldcum & ~deep
    assert deep[[0, 3, 5]].all() and shal[[1, 4]].all()
    assert (idpl[deep] < nk - 1).all() and (idpl[shal] == nk - 1).all()
    want = jcs(*[jnp.asarray(a) for a in case[:10]], *case[10:])
    for g, w in zip((ldcum, kcbot, ictop0, idpl, ilab), (0, 1, 2, 3, 8)):
        np.testing.assert_array_equal(g, np.asarray(want[w]))
    for g, w in zip((wubase, tu, qu, lu), (4, 5, 6, 7)):
        assert _rel(g, want[w]) <= TOL


# -- UW TCM ----------------------------------------------------------------
def _uw_column(kz=18, iy=3, jx=4, seed=None, cloudy=False):
    """test_physics.py's UW column (a superadiabatic surface layer under
    a stable profile), optionally perturbed and with cloud water and
    ice; uwtcm's arguments as numpy (without dt)."""
    rng = np.random.default_rng(seed)
    sig = (np.arange(kz) + 0.5) / kz
    p0 = 101325.0
    ones = np.ones((kz, iy, jx))
    patm = (sig[:, None, None] * (p0 - 5000) + 5000) * ones
    sigf = np.arange(kz + 1) / kz
    patmf = (sigf[:, None, None] * (p0 - 5000) + 5000) \
        * np.ones((kz + 1, iy, jx))
    t = (288.0 - 60 * (1 - sig))[:, None, None] * ones
    t[-1] += 2.0
    qv = np.maximum(1e-6, 0.008 * sig ** 2)[:, None, None] * ones
    qc = np.zeros_like(t)
    qi = np.zeros_like(t)
    u = 8.0 * ones
    v = np.zeros_like(t)
    heatrt = np.zeros_like(t)
    tke0 = np.full((kz + 1, iy, jx), 1.0e-3)
    if seed is not None:
        t = t + 0.5 * rng.standard_normal(t.shape)
        u = u + rng.standard_normal(t.shape)
        v = v + rng.standard_normal(t.shape)
        tke0 = tke0 + 0.3 * rng.uniform(size=tke0.shape)
    if cloudy:
        qc[kz - 6:kz - 3] = 3e-4
        qi[2:6] = 5e-5
        heatrt[kz - 7:kz - 4] = -3e-5
    tv = t * (1 + 0.608 * qv)
    dzl = 287.0 * tv / 9.81 * np.log(patmf[1:]
                                     / np.maximum(patmf[:-1], 1.0))
    zq = np.zeros((kz + 1, iy, jx))
    for k in range(kz - 1, -1, -1):
        zq[k] = zq[k + 1] + dzl[k]
    za = 0.5 * (zq[:-1] + zq[1:])
    dzq = zq[:-1] - zq[1:]
    tg = t[-1] + 2.0
    lnd = (np.arange(iy * jx).reshape(iy, jx) % 2).astype(float)
    return (t, qv, qc, qi, u, v, za, zq, dzq, patm, patmf, tke0, heatrt,
            tg, qv[-1], np.full((iy, jx), 6e-5), np.full((iy, jx), 120.0),
            np.full((iy, jx), 0.05), lnd, np.full((iy, jx), 4))


@pytest.mark.parametrize("case", ["clear", "cloudy_ice"])
def test_uwtcm_matches_jax(case):
    """One UW TCM step over 12 perturbed columns (clear, and with cloud
    water, ice diffused and cloud-top cooling): every output within
    1e-10 of its scale, the PBL top index exactly."""
    from regcm_tpu.physics.pbl.uwtcm import uwtcm as juw
    from regcm_tpu_torch.physics.pbl.uwtcm import uwtcm
    cloudy = case == "cloudy_ice"
    args = _uw_column(seed=7, cloudy=cloudy)
    want = juw(*[jnp.asarray(a) for a in args[:-1]],
               jnp.asarray(args[-1], jnp.int32), 150.0,
               diffuse_ice=cloudy)
    got = uwtcm(*[_t(a) for a in args[:-1]], torch.as_tensor(args[-1]),
                150.0, diffuse_ice=cloudy)
    for name in want._fields:
        if name == "kpbl":
            np.testing.assert_array_equal(_np(got.kpbl), _np(want.kpbl))
            continue
        assert _rel(getattr(got, name), getattr(want, name)) <= TOL, name
    assert float(got.tketen[1:-1].abs().max()) > 0.0


def test_uwtcm_pbl():
    """Twin of tests/test_physics.py::test_uwtcm_pbl: heat flux and
    shear raise TKE above the floor, the mixed layer warms, and the PBL
    has a height."""
    from regcm_tpu_torch.physics.pbl.uwtcm import uwtcm, UWTKEMIN
    args = _uw_column(iy=3, jx=3)
    lnd = np.ones((3, 3))
    targs = [_t(a) for a in args[:-2]] + [_t(lnd),
                                          torch.full((3, 3), 4)]
    out = uwtcm(*targs, 300.0)
    for v in out:
        assert torch.isfinite(v.double()).all()
    tke_new = _t(args[11]) + 300.0 * out.tketen
    assert float(tke_new.max()) > 10.0 * UWTKEMIN
    assert float(out.tten[-1].mean()) > 0.0
    assert float(out.zpbl.min()) > 0.0


def test_uwtcm_n2_oracle():
    """Twin of tests/test_oracles.py::test_uwtcm_n2_oracle: unsaturated
    N² is the dry g·dθv/dz/θv."""
    from regcm_tpu_torch.physics.pbl.uwtcm import _n2
    kz = 10
    z = np.linspace(3000.0, 100.0, kz)
    theta = 300.0 + 0.004 * z
    p0 = 101325.0
    pres = p0 * (1.0 - 2.25577e-5 * z) ** 5.25588
    qv = np.full(kz, 2.0e-3)
    presfl = np.concatenate([[pres[0] - 500.0],
                             0.5 * (pres[1:] + pres[:-1]),
                             [pres[-1] + 500.0]])
    exnerfl = (presfl / p0) ** (c.rgas / c.cpd)
    rdza = np.concatenate([[1.0], 1.0 / (z[:-1] - z[1:]), [1.0]])
    sh = lambda a: _t(a[:, None, None])
    nsq, _ = _n2(sh(theta), sh(qv), sh(exnerfl), sh(1.0 / exnerfl),
                 sh(presfl), sh(rdza), sh(qv))
    thv = theta * (1.0 + c.ep1 * qv)
    thvfl = 0.5 * (thv[1:] + thv[:-1])
    n2_dry = c.egrav * (thv[:-1] - thv[1:]) / (z[:-1] - z[1:]) / thvfl
    np.testing.assert_allclose(nsq.numpy()[1:kz, 0, 0], n2_dry, rtol=0.02)
