"""The aerosol chemistry of the PyTorch port against the JAX package, in
float64 on the CPU, function by function from the same seeded numpy
inputs: dust, sea salt, pollen emission, the carbon aging, the sulfur
chemistry, SO2's gas dry deposition, the aerosol dry and wet
deposition, the convective well-mixed transport, the aerosol optics and
CCM3 with the aerosol direct effect, each at 1e-12 of the output's
scale; Emanuel's tracer transport (``cupeman(tra=)``) and K2's tracer
form (the plain version) against the JAX mixing body, and the tracers'
Holtslag solve (K1's plain version at ns = ntr) against the JAX
package's ``_tridiag_implicit``, at the same bound. Twins of the JAX
package's own chemistry tests that need no reference Testing corpus
close the file."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from regcm_tpu.chem import carbon as jcarb  # noqa: E402
from regcm_tpu.chem import cumtran as jcum  # noqa: E402
from regcm_tpu.chem import deposition as jdep  # noqa: E402
from regcm_tpu.chem import drydep_gas as jgas  # noqa: E402
from regcm_tpu.chem import dust as jdust  # noqa: E402
from regcm_tpu.chem import optics as jopt  # noqa: E402
from regcm_tpu.chem import pollen as jpol  # noqa: E402
from regcm_tpu.chem import seasalt as jss  # noqa: E402
from regcm_tpu.chem import sox as jsox  # noqa: E402
from regcm_tpu.chem.species import build_species  # noqa: E402
from regcm_tpu_torch.chem import carbon as tcarb  # noqa: E402
from regcm_tpu_torch.chem import cumtran as tcum  # noqa: E402
from regcm_tpu_torch.chem import deposition as tdep  # noqa: E402
from regcm_tpu_torch.chem import drydep_gas as tgas  # noqa: E402
from regcm_tpu_torch.chem import dust as tdust  # noqa: E402
from regcm_tpu_torch.chem import optics as topt  # noqa: E402
from regcm_tpu_torch.chem import pollen as tpol  # noqa: E402
from regcm_tpu_torch.chem import seasalt as tss  # noqa: E402
from regcm_tpu_torch.chem import sox as tsox  # noqa: E402

from .test_torch_physics import (KZ, _columns, _radiation_inputs,  # noqa
                                 J, T)

TOL = 1e-12
IY, JX = 6, 7


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got.astype(float) - want.astype(float)).max()) \
        / max(float(np.abs(want).max()), 1e-300)


def _check(got, want, tol=TOL, name=""):
    """Every field of a NamedTuple, dict or sequence (or one array)
    within ``tol`` of the reference's scale."""
    if hasattr(want, "_fields"):
        for f in want._fields:
            _check(getattr(got, f), getattr(want, f), tol, f"{name}.{f}")
    elif isinstance(want, dict):
        for k in want:
            _check(got[k], want[k], tol, f"{name}[{k}]")
    elif isinstance(want, (tuple, list)):
        for n, (g, w) in enumerate(zip(got, want)):
            _check(g, w, tol, f"{name}[{n}]")
    else:
        assert _rel(got, want) <= tol, (name, _rel(got, want))


def _two(rng, lo, hi, shape=(IY, JX)):
    return rng.uniform(lo, hi, shape)


def _jit(fn, *args, **static):
    """The JAX function jitted with its keyword arguments static: one XLA
    compile costs less than the op-by-op compiles of an eager call."""
    return jax.jit(functools.partial(fn, **static))(*args)


# -- emission ----------------------------------------------------------------
@pytest.mark.parametrize("ichdustemd", [1, 2])
@pytest.mark.parametrize("sim", ["DUST", "DU12"])
def test_dust_emission_matches_jax(sim, ichdustemd):
    """The Alfaro (1) and Kok (2) emission of both bin sets on desert
    points with a dry and a wet soil, a calm and a windy column (the
    threshold, Fecan and saltation branches)."""
    spec = build_species(sim)
    rng = np.random.default_rng(11 + ichdustemd)
    tex = rng.uniform(0.0, 1.0, (12, IY, JX))
    tex /= tex.sum(axis=0)
    emit = (_two(rng, 0, 1) > 0.3).astype(float)
    args = (_two(rng, 0.05, 0.9), _two(rng, 1e-4, 0.05),
            _two(rng, 0.0, 0.2), _two(rng, 0.5, 25.0), _two(rng, 1.0, 1.3),
            _two(rng, 0.0, 0.6), _two(rng, 0.0, 0.3))
    kw = dict(ichdustemd=ichdustemd, rdstemfac=0.9)
    want = jdust.DustEmission(spec.bin_size, tex, emit, **kw)(*map(J, args))
    got = tdust.DustEmission(spec.bin_size, tex, emit, **kw)(*map(T, args))
    assert float(np.asarray(want).max()) > 0.0
    _check(got, want, TOL, "dust")
    dp = rng.uniform(1e-4, 1e-1, (5, IY, JX))
    _check(tdust.ustart01(T(dp), T(args[4])),
           jdust.ustart01(J(dp), J(args[4])), TOL, "ustart01")


def test_seasalt_pollen_aging_match_jax():
    rng = np.random.default_rng(21)
    w10 = _two(rng, 0.0, 30.0)
    ocean = (_two(rng, 0, 1) > 0.4).astype(float)
    _check(tss.SeasaltEmission()(T(w10), T(ocean)),
           jss.SeasaltEmission()(J(w10), J(ocean)), TOL, "seasalt")
    pargs = (_two(rng, 0.0, 5e3), _two(rng, 0.1, 0.8), w10,
             _two(rng, 0.2, 1.0), _two(rng, 0.0, 2e-4))
    _check(tpol.pollen_emission(*map(T, pargs)),
           jpol.pollen_emission(*map(J, pargs)), TOL, "pollen")
    chi = rng.uniform(0.0, 1e-8, (6, KZ, IY, JX))
    chi[1, :, 0] = 0.0                           # below MINTR
    pairs = build_species("SUCA").aging_pairs
    _check(tcarb.aging_tend(T(chi), pairs, 300.0),
           jcarb.aging_tend(J(chi), pairs, 300.0), TOL, "aging")


# -- sulfur ------------------------------------------------------------------
def test_chemsox_matches_jax():
    """Gas-phase by day and by night, the aqueous paths in and out of the
    stratiform and cumulus clouds, the below-cloud washout."""
    c = _columns(31, iy=IY, jx=JX)
    rng = c["rng"]
    so2 = rng.uniform(0.0, 5e-9, c["t"].shape)
    so2[0, 0, 0] = -1e-12                        # a negative value
    so4 = rng.uniform(0.0, 2e-9, c["t"].shape)
    wl = np.where(rng.uniform(0, 1, c["t"].shape) > 0.5,
                  rng.uniform(0.0, 0.5, c["t"].shape), 0.0)
    frac = rng.uniform(0.0, 0.8, c["t"].shape)
    fcum = rng.uniform(0.0, 0.3, c["t"].shape)
    ktop = rng.integers(-1, KZ - 2, (IY, JX))
    rembc = np.where(rng.uniform(0, 1, c["t"].shape) > 0.5,
                     rng.uniform(0.0, 3.0, c["t"].shape), 0.0)
    oh = rng.uniform(5e4, 2e6, c["t"].shape)
    h2o2 = rng.uniform(5e-11, 1e-9, c["t"].shape)
    czen = _two(rng, -0.5, 1.0)
    args = (so2, so4, c["rho"], c["t"], czen, wl, frac, fcum)
    want = jsox.chemsox(*map(J, args), J(ktop), J(rembc), J(oh), J(h2o2),
                        300.0)
    got = tsox.chemsox(*map(T, args), T(ktop), T(rembc), T(oh), T(h2o2),
                       300.0)
    _check(got, want, TOL, "chemsox")


def test_gas_drydep_matches_jax():
    """SO2's Zhang (2003) deposition velocity over every landuse class
    the chemistry passes (1-20: water is 14, above 20 is 20), wet and
    dry, day and night, below and above freezing."""
    rng = np.random.default_rng(41)
    shape = (4, 20)
    lcov = np.tile(np.arange(1, 21), (4, 1))
    ts = rng.uniform(265.0, 305.0, shape)
    args = (rng.uniform(0.05, 0.8, shape), rng.uniform(5.0, 300.0, shape),
            np.where(rng.uniform(0, 1, shape) > 0.5,
                     rng.uniform(0.0, 2.0, shape), 0.0),
            np.zeros(shape), rng.uniform(0.0, 900.0, shape), ts,
            ts + rng.uniform(-2.0, 2.0, shape),
            rng.uniform(0.2, 1.0, shape), rng.uniform(-0.3, 1.0, shape))
    for mpos in (1.2, 6.5, 12.7):
        want = jgas.gas_drydep_velocity(["SO2"], J(lcov), mpos,
                                        *map(J, args))
        got = tgas.gas_drydep_velocity(["SO2"], T(lcov), mpos,
                                       *map(T, args))
        _check(got, want, TOL, f"drydep_gas({mpos})")


# -- aerosol deposition ------------------------------------------------------
def _deposition_inputs(seed, ntr=4):
    c = _columns(seed, iy=IY, jx=JX)
    rng = c["rng"]
    spec = build_species("DUST")
    water = _two(rng, 0, 1) > 0.6
    ivegcov = np.where(water, 0, rng.integers(1, 23, (IY, JX)))
    chib = rng.uniform(0.0, 1e-6, (ntr,) + c["t"].shape) * c["ps"][None, None]
    chib[:, :, 0, 0] = 0.0                      # a clean column
    return c, rng, spec, water, ivegcov, chib


def test_aerodyresis_and_drydep_aero_match_jax():
    c, rng, spec, water, ivegcov, _ = _deposition_inputs(51)
    from regcm_tpu.chem.deposition import CROUGH
    zeff = np.where(ivegcov > 0, CROUGH[np.clip(ivegcov - 1, 0, 21)],
                    0.0004)
    t10 = c["t"][-1] + _two(rng, -1.0, 1.0)
    args = (zeff, _two(rng, 0.0, 15.0), t10, t10 + _two(rng, -4.0, 4.0),
            _two(rng, 0.2, 1.0), _two(rng, 0.0, 800.0))
    want = jdep.aerodyresis(*map(J, args), J(water))
    got = tdep.aerodyresis(*map(T, args), T(water))
    _check(got, want, TOL, "aerodyresis")
    ustar, ra = (np.asarray(a) for a in want)
    dargs = (spec.bin_diam, spec.rhop, c["t"], c["rho"], c["pb"])
    want = jdep.drydep_aero(*map(J, dargs), J(ivegcov), J(ustar), J(ra))
    got = tdep.drydep_aero(*map(T, dargs), T(ivegcov), T(ustar), T(ra))
    _check(got, want, TOL, "drydep_aero")


def test_settling_and_wetdep_match_jax():
    """The settling/deposition tendency and the rainout, convective
    rainout and washout with both removal switches, across a cumulus
    column, a clear column and freezing levels (blcld's phases)."""
    c, rng, spec, _, _, chib = _deposition_inputs(61)
    ntr = chib.shape[0]
    grid_twt = rng.uniform(0.3, 0.7, (KZ, 1, 1))
    pdepv = rng.uniform(0.0, 0.05, chib.shape)
    ddepv = rng.uniform(0.0, 0.08, (ntr, IY, JX))
    sargs = (chib, c["ps"], pdepv, ddepv, c["dzq"], c["rho"], grid_twt,
             1.0 - grid_twt)
    _check(tdep.settling_tend(*map(T, sargs), 300.0),
           jdep.settling_tend(*map(J, sargs), 300.0), TOL, "settling")
    t = c["t"] - 25.0 * (rng.uniform(0, 1, c["t"].shape) > 0.7)
    wl = np.where(rng.uniform(0, 1, t.shape) > 0.5,
                  rng.uniform(0.0, 0.4, t.shape), 0.0)
    frac = np.where(wl > 0, rng.uniform(0.05, 0.9, t.shape), 0.0)
    fcum = rng.uniform(0.0, 0.3, t.shape)
    remrat = np.where(wl > 0, rng.uniform(0.0, 1e-3, t.shape), 0.0)
    ktop = rng.integers(-1, KZ - 4, (IY, JX))
    kbot = np.where(ktop >= 0, np.minimum(ktop + rng.integers(2, 6, (IY, JX)),
                                          KZ - 1), -1)
    strappt = np.where(rng.uniform(0, 1, t.shape) > 0.4,
                       rng.uniform(0.0, 1e-3, t.shape), 0.0)
    conv = _two(rng, 0.0, 5e-4)
    wargs = (chib, c["ps"], t, wl, frac, fcum, remrat)
    pargs = (strappt, conv, pdepv, spec.bin_diam, spec.rhop, spec.sol,
             c["dzq"], c["rho"])
    for lsc, cvc in ((1, 1), (0, 1), (1, 0)):
        kw = dict(ichremlsc=lsc, ichremcvc=cvc)
        want = jdep.wetdep_tend(*map(J, wargs), J(ktop), J(kbot),
                                *map(J, pargs), 300.0, **kw)
        got = tdep.wetdep_tend(*map(T, wargs), T(ktop), T(kbot),
                               *map(T, pargs), 300.0, **kw)
        _check(got, want, TOL, f"wetdep{lsc}{cvc}")


# -- transport and optics ----------------------------------------------------
def test_cumtran_and_optics_match_jax():
    rng = np.random.default_rng(71)
    chi = rng.uniform(0.0, 1e-6, (3, KZ, IY, JX))
    f = np.where(rng.uniform(0, 1, (KZ, IY, JX)) > 0.5,
                 rng.uniform(0.0, 0.6, (KZ, IY, JX)), 0.0)
    f[:, 0, :] = 0.0                             # cloudless columns
    dsig = rng.uniform(0.02, 0.1, KZ)
    dotran = _two(rng, 0, 1) > 0.3
    want = jcum.cumtran((J(chi), J(chi * 2.0)), J(f), J(dsig), J(dotran))
    got = tcum.cumtran((T(chi), T(chi * 2.0)), T(f), T(dsig), T(dotran))
    _check(got, want, TOL, "cumtran")
    for ntr in (4, 12):
        aer = rng.uniform(0.0, 1e-6, (ntr, IY * JX, KZ))
        pint = np.sort(rng.uniform(5e3, 1.01e5, (IY * JX, KZ + 1)), axis=1)
        jt, tt = jopt.dust_optics_tables(ntr), topt.dust_optics_tables(ntr)
        _check(topt.sw_aerosol_mixture(T(aer), T(pint), tt),
               jopt.sw_aerosol_mixture(J(aer), J(pint), jt), TOL, "sw_mix")
        _check(topt.lw_dust_path(T(aer), T(pint), tt.lw_mask),
               jopt.lw_dust_path(J(aer), J(pint), jt.lw_mask), TOL,
               "lw_path")


def test_ccm3_with_dust_matches_jax():
    """CCM3 with the aerosol direct effect (aeroppt into the SW, the grey
    dust LW transmission applied to cached gas absorptivities, the path
    between two dtabem alarms; the gas-only build is
    tests/test_torch_physics.py's) against the JAX package, at the
    radiation tests' bound (the LW all-pairs contractions reorder sums),
    and the dust's effect: less surface SW at the same clouds."""
    from regcm_tpu.physics.radiation.ccm3.driver import ccm3_radiation as jr
    from regcm_tpu_torch.physics.radiation.ccm3.driver import \
        ccm3_radiation as tr

    args, ghg = _radiation_inputs(8)
    rng = np.random.default_rng(81)
    aer = rng.uniform(0.0, 5e-5, (4, KZ, IY, JX))
    kz1 = KZ + 1
    cache = dict(abstot=rng.uniform(0.0, 0.9, (kz1 * kz1, IY, JX)),
                 absnxt=rng.uniform(0.0, 0.9, (4 * KZ, IY, JX)),
                 emstot=rng.uniform(0.1, 0.9, (kz1, IY, JX)))
    kw = dict(eccf=1.01, solcon=1361.0)
    want, _ = _jit(jr, *map(J, args), ghg=ghg, aertab=jopt.dust_optics_tables(4),
                   cache={k: J(v) for k, v in cache.items()}, aermmr=J(aer),
                   **kw)
    kw.update(cache={k: T(v) for k, v in cache.items()})
    got, _ = tr(*map(T, args), ghg, aermmr=T(aer),
                aertab=topt.dust_optics_tables(4), **kw)
    _check(got, want, 1e-10, "ccm3_dust")
    clean, _ = tr(*map(T, args), ghg, **kw)
    day = np.asarray(args[10]) > 0.1
    assert float((clean.swabs_sfc - got.swabs_sfc).numpy()[day].min()) > 0.0


# -- Emanuel's tracer transport and K2's tracer form -----------------------
def test_cupeman_tracers_match_jax():
    """``cupeman(tra=)``: every output and the tracer tendencies ftra
    against the JAX package on unstable columns, a quarter or more of
    them convecting."""
    from regcm_tpu.physics.cumulus import emanuel as je
    from regcm_tpu_torch.physics.cumulus import emanuel as te

    c = _columns(5, iy=12, jx=25)
    ncol = 12 * 25
    flipc = lambda a: np.ascontiguousarray(a[::-1].reshape(a.shape[0],
                                                           ncol).T)
    t = c["t"] + 6.0 * np.linspace(0, 1, KZ)[:, None, None]
    args = [flipc(t), flipc(c["qv"] / (1.0 + c["qv"])),
            flipc(c["qs"] / (1.0 + c["qs"])), flipc(c["u"]), flipc(c["v"]),
            flipc(c["pb"]) * 0.01, flipc(c["pf"]) * 0.01]
    rng = c["rng"]
    cb = rng.uniform(0, 0.02, ncol) * (rng.uniform(0, 1, ncol) > 0.5)
    elc = np.where(rng.uniform(0, 1, ncol) > 0.5, 1.1e-3, 1.1e-4)
    epm = np.full(ncol, 0.999)
    tra = rng.uniform(0.0, 1e-6, (ncol, KZ, 6))
    want = _jit(lambda *a: je.cupeman(*a[:8], 300.0, *a[8:10], 1,
                                      tra=a[10]),
                *map(J, args), J(cb), J(elc), J(epm), J(tra))
    got = te.cupeman(*map(T, args), T(cb), 300.0, T(elc), T(epm), 1,
                     tra=T(tra))
    assert int(np.asarray(want.active).sum()) > ncol // 4
    assert float(np.abs(np.asarray(want.ftra)).max()) > 0.0
    _check(got, want, TOL, "cupeman")


def test_emanuel_mixing_tracer_form_matches_jax():
    """K2's plain tracer form against the JAX mixing body with tra/trank
    (the CF layout, the only one that takes tracers): the eight terms and
    sum_tra, at L = 40, where the kernel's lanes take two levels."""
    from regcm_tpu.physics.cumulus import emanuel as jem
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    from .test_torch_kernels import _mixing_inputs

    L = 40
    levels, unk, vnk, icb, ict, cloud = _mixing_inputs(seed=4, L=L)
    rng = np.random.default_rng(91)
    ncol = levels[0].shape[0]
    tra = rng.uniform(0.0, 1e-6, (ncol, L, 12))
    trank = rng.uniform(0.0, 1e-6, (ncol, 12))
    want = _jit(lambda *a: jem._mixing_body(*a[:18], jem._LayCF(L),
                                            tra=a[18], trank=a[19]),
                *map(J, levels), J(unk), J(vnk),
                jnp.asarray(icb, jnp.int32), jnp.asarray(ict, jnp.int32),
                J(cloud), J(tra), J(trank))
    got = k2.emanuel_mixing(*map(T, levels), T(unk), T(vnk), T(icb),
                            T(ict), T(cloud), tra=T(tra), trank=T(trank))
    assert set(got) == set(want) == set(k2.KEYS) | {"sum_tra"}
    # the reductions reorder sums (cumsum vs triangular matmul), as in
    # the eight-term test of tests/test_torch_kernels.py
    for k in want:
        assert _rel(got[k], want[k]) < 1e-10, k
    assert _rel(got["sum_tra"], want["sum_tra"]) < TOL
    with pytest.raises(ValueError, match="ntr"):
        k2.emanuel_mixing(*map(T, levels), T(unk), T(vnk), T(icb), T(ict),
                          T(cloud), tra=T(np.zeros((ncol, L, 65))),
                          trank=T(np.zeros((ncol, 65))))


def test_tracer_diffusion_matches_jax():
    """The tracers' Holtslag solve through K1's plain version (ns = ntr)
    against the JAX package's scan ``_tridiag_implicit`` with the tracers
    after the level axis, as its chemistry hook calls it."""
    from regcm_tpu.physics.pbl.holtslag import _tridiag_implicit
    from regcm_tpu_torch.physics.pbl.holtslag import tracer_diffusion

    rng = np.random.default_rng(101)
    chi = rng.uniform(0.0, 1e-6, (12, KZ, IY, JX))
    al = rng.uniform(1e-4, 1e-2, (KZ, IY, JX))
    be = rng.uniform(0.0, 5.0, (KZ, IY, JX))
    want = np.swapaxes(np.asarray(_tridiag_implicit(
        jnp.swapaxes(J(chi), 0, 1), J(al)[:, None], J(be)[:, None], 300.0,
        0.0)), 0, 1)
    got = tracer_diffusion(T(chi), T(al), T(be), 300.0)
    assert _rel(got, want) < TOL


# -- twins of the JAX package's behaviour tests -----------------------------
def test_dust_tables_normalized():
    """tests/test_chem.py's table invariants on the port's tables."""
    spec = build_species("DUST")
    t = tdust.dust_tables(spec.bin_size)
    assert t.srel.shape == (tdust.NSOIL, tdust.NATS)
    s = t.srel.sum(axis=0)
    assert np.all((np.abs(s - 1.0) < 1e-6) | (s == 0.0))
    np.testing.assert_allclose(t.frac.sum(), 1.0, atol=1e-12)
    assert np.all(t.frac >= 0.0)
    for f in (t.frac1, t.frac2, t.frac3):
        assert np.all(f >= 0.0) and f.sum() <= 1.0 + 1e-9


def test_cumtran_wellmixed_conserves():
    """tests/test_chem.py:191 on the port: blending toward the sigma-
    weighted mean conserves the column's tracer mass over the cloud
    span, makes the f=1 limit exactly well mixed, and leaves no-cloud and
    no-transport columns untouched."""
    rng = np.random.default_rng(3)
    kz, iy, jx = 12, 4, 5
    chi = rng.uniform(0.1, 2.0, (2, kz, iy, jx))
    dsig = rng.uniform(0.5, 1.5, kz)
    f = np.zeros((kz, iy, jx))
    f[5:, :, :2] = 1.0
    f[5:, :, 2] = 0.3
    dotran = np.ones((iy, jx), bool)
    dotran[:, 3] = False
    (out,) = tcum.cumtran((T(chi),), T(f), T(dsig), T(dotran))
    out = out.numpy()
    bar = (chi[:, 5:, :, 0] * dsig[None, 5:, None]).sum(1) / dsig[5:].sum()
    np.testing.assert_allclose(out[:, 5:, :, 0],
                               np.broadcast_to(bar[:, None, :], (2, 7, iy)),
                               rtol=1e-12)
    m0 = (chi[:, 5:, :, 2] * dsig[None, 5:, None]).sum(1)
    m1 = (out[:, 5:, :, 2] * dsig[None, 5:, None]).sum(1)
    np.testing.assert_allclose(m0, m1, rtol=1e-12)
    np.testing.assert_array_equal(out[:, :5], chi[:, :5])
    np.testing.assert_array_equal(out[..., 3], chi[..., 3])
    np.testing.assert_array_equal(out[..., 4], chi[..., 4])
