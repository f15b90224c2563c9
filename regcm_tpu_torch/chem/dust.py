"""Mineral dust emission (Marticorena & Bergametti 1995 / Alfaro-Gomes
via Zakey et al. 2006, or Kok et al. 2014), torch twin of
``regcm_tpu/chem/dust.py``.

``Main/chemlib/mod_che_dust.F90`` (inidust :227, sfflux :547,
dust_module :678, emission :779, ustart01 :481): the soil-aggregate
relative-surface spectrum ``srel`` is one (nsoil, nats) table, the
per-point flux a contraction over the soil spectrum and the texture
classes. The texture weighting is folded into a static (nsoil, iy, jx)
weight at set-up, W = srel·texfrac, so that the run-time contraction is
Σ_ns g(ns)·W(ns), added one soil bin at a time (``level_sum``): every
column gets the same operations whatever the size of its block. The
effective emitter cells (ivegcov 8/11) are a dense mask.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dynamics.hydrostatic import level_sum
from ..utils import constants as c

# global dust constants (mod_che_dust.F90:90-124)
RHODUST = 2650.0                  # particle density kg/m³
NSOIL = 152                       # soil size spectrum resolution
MODE = 5                          # soil-population modes
NATS = 12                         # soil texture classes
# Alfaro lognormal modes (µm) + kinetic energies (g cm²/s²)
D1, D2, D3 = 1.5, 6.7, 14.2
SIGMA1, SIGMA2, SIGMA3 = 1.7, 1.2, 1.5
E1, E2, E3 = 3.61, 3.52, 3.46
# Kok 2011 brittle-fragmentation distribution parameters
KOK_D, KOK_SIGMAS, KOK_CV, KOK_LAMBDA = 3.4, 3.0, 12.62, 12.0
MXARG = 25.0
VONKAR = 0.4

# soil texture composition: percent of (coarse sand, fine-medium sand,
# silt, clay, salt) for the 12 STAT-FAO classes (Menut et al. 2013;
# mod_che_dust.F90:254-266 soiltexpc) — (MODE, NATS)
SOILTEXPC = np.array([
    [0.46, 0.46, 0.05, 0.03, 0.0],
    [0.41, 0.41, 0.18, 0.00, 0.0],
    [0.29, 0.29, 0.32, 0.10, 0.0],
    [0.00, 0.17, 0.70, 0.13, 0.0],
    [0.00, 0.10, 0.85, 0.05, 0.0],
    [0.00, 0.43, 0.39, 0.18, 0.0],
    [0.29, 0.29, 0.15, 0.27, 0.0],
    [0.00, 0.10, 0.56, 0.34, 0.0],
    [0.00, 0.32, 0.34, 0.34, 0.0],
    [0.00, 0.52, 0.06, 0.42, 0.0],
    [0.00, 0.06, 0.47, 0.47, 0.0],
    [0.00, 0.22, 0.20, 0.58, 0.0]]).T        # (MODE, NATS)
TEXMMD = np.array([690.0, 210.0, 125.0, 2.0, 520.0])   # µm
TEXSTD = np.array([1.6, 1.6, 1.8, 2.0, 1.50])
BCLY = SOILTEXPC[3]               # clay fraction per texture class


class DustTables(NamedTuple):
    """Set-up constant tables (numpy)."""
    dp_array: np.ndarray          # (NSOIL,) aggregate diameters (cm)
    srel: np.ndarray              # (NSOIL, NATS) relative surface
    frac1: np.ndarray             # (nbin,) Alfaro mode-1 weights
    frac2: np.ndarray
    frac3: np.ndarray
    frac: np.ndarray              # (nbin,) Kok weights (ichdustemd=2)


def dust_tables(bin_size: np.ndarray, ichdustemd: int = 1) -> DustTables:
    """The soil spectrum and the emission-distribution weights (inidust,
    mod_che_dust.F90:227-471); bin_size (nbin, 2) µm. numpy, as in the
    JAX package."""
    nbin = bin_size.shape[0]
    deldp = 0.0460517018598807
    dp = 1.0e-4 * np.exp(deldp * np.arange(NSOIL))       # cm
    pcent = SOILTEXPC.copy()
    mmd = np.where(pcent > 1e-14, TEXMMD[:, None], 0.0)
    sig = np.where(pcent > 1e-14, TEXSTD[:, None], 0.0)
    ss = np.zeros((NSOIL, NATS))
    for nm in range(MODE):
        ok = (pcent[nm] > 1e-10) & (sig[nm] > 1e-10)
        with np.errstate(divide="ignore", invalid="ignore"):
            xk = pcent[nm] / (np.sqrt(2.0 * np.pi) * np.log(sig[nm]))
            xl = ((np.log(dp)[:, None]
                   - np.log(mmd[nm] * 1.0e-4)[None]) ** 2
                  / (2.0 * np.log(sig[nm])[None] ** 2))
        xm = np.where(ok[None] & (xl <= MXARG), xk[None] * np.exp(
            np.minimum(xl, MXARG) * -1.0), 0.0)
        xn = RHODUST * (2.0 / 3.0) * (dp * 0.5)
        ss += np.where(ok[None], xm * deldp / xn[:, None], 0.0)
    stot = ss.sum(axis=0)
    srel = np.where(stot[None] > 0.0, np.minimum(ss / stot[None], 1.0),
                    0.0)
    ndi = 4000 if nbin == 4 else 6500
    di = np.maximum(0.01 * np.arange(ndi), 0.01)         # µm
    inbin = ((di[:, None] > bin_size[None, :, 0])
             & (di[:, None] <= bin_size[None, :, 1]))    # (ndi, nbin)
    f123 = []
    for dm, sg in ((D1, SIGMA1), (D2, SIGMA2), (D3, SIGMA3)):
        ex = ((np.log10(di) - np.log10(dm)) ** 2
              / (2.0 * np.log10(sg) ** 2))
        term = np.where(ex < MXARG, np.exp(-np.minimum(ex, MXARG)) / di,
                        0.0)
        f123.append((term[:, None] * inbin).sum(axis=0) / term.sum())
    from math import erf
    termk = np.array([
        1.0 / KOK_CV * (1.0 + erf(np.log(x / KOK_D)
                                  / (np.sqrt(2.0) * np.log(KOK_SIGMAS))))
        * np.exp(-(x / KOK_LAMBDA) ** 3) for x in di])
    frac = (termk[:, None] * inbin).sum(axis=0) / termk.sum()
    frac[np.argmax(frac)] += 1.0 - frac.sum()
    return DustTables(dp_array=dp, srel=srel, frac1=f123[0],
                      frac2=f123[1], frac3=f123[2], frac=frac)


def ustart01(dp_cm, rhair):
    """Iversen & White (1982) threshold friction velocity for a smooth
    surface (mod_che_dust.F90:481-515); dp in cm, result cm/s."""
    a2, c1_, c2_, c3_, c4_, c5_ = 0.129, 0.006, 1.928, 0.0858, \
        -0.0617, 2.5
    y1, y2, y3 = 1331.647, 1.561228, 0.38194
    dm = dp_cm
    rep = y1 * dm ** y2 + y3
    term1 = torch.sqrt(1.0 + c1_ / (RHODUST * c.egrav * 0.1 * dm ** c5_))
    term2 = torch.sqrt(RHODUST * c.egrav * 100.0 * dm / rhair)
    term = term1 * term2
    return torch.where(
        rep > 10.0, a2 * term * (1.0 - c3_ * torch.exp(c4_ * (rep - 10.0))),
        a2 * term / torch.sqrt(c2_ * rep ** 0.092 - 1.0))


def _soil_sum(g, w):
    """Σ_ns g[..., ns, y, x]·w[ns, y, x], added in soil-bin order."""
    return level_sum(torch.movedim(g * w, -3, 0))


class DustEmission:
    """Dense dust-emission operator for one grid (or a rank's block of it:
    the (…, iy, jx) inputs given cut to it).

    texfrac (NATS, iy, jx) soil texture class fractions (dustsotex);
    emitmask 1 where ivegcov is 8 (desert) or 11 (semi-desert)
    (sfflux's effective-emitter gather, mod_che_dust.F90:585-605)."""

    def __init__(self, bin_size, texfrac, emitmask, ichdustemd=1,
                 rdstemfac=1.0, device="cpu", dtype=torch.float64):
        t = dust_tables(np.asarray(bin_size), ichdustemd)
        self.ichdustemd = int(ichdustemd)
        self.rdstemfac = float(rdstemfac)
        self.nbin = np.asarray(bin_size).shape[0]
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                      device=device)
        tex = np.asarray(texfrac, dtype=np.float64)
        self.dp = f(t.dp_array)
        self.frac1, self.frac2, self.frac3 = (f(t.frac1), f(t.frac2),
                                              f(t.frac3))
        self.frac = f(t.frac)
        # the texture weighting of the soil spectrum, per point: the
        # Alfaro branch's Σ_nt srel·tex and the Kok branch's Σ_nt
        # srel·bcly·tex
        self.w_alfaro = f(np.einsum("sn,nij->sij", t.srel, tex))
        self.w_kok = f(np.einsum("sn,nij->sij", t.srel * BCLY[None], tex))
        self.emitmask = f(emitmask)
        # grid clay percent (inidust clayrow2)
        self.clayrow = f(np.einsum("nij,n->ij", tex, BCLY) * 100.0)

    def __call__(self, ustar_ms, z0, soilw, surfwd, roarow, vegfrac,
                 snowfrac):
        """Surface dust flux (nbin, iy, jx) in kg/m²/s (dust_module +
        emission, mod_che_dust.F90:678-955): ustar_ms the non-dust
        friction velocity (m/s), z0 roughness (m), soilw gravimetric soil
        water (kg/kg), surfwd 10 m wind (m/s), roarow surface air density
        (kg/m³)."""
        dp = self.dp[:, None, None]                       # (NSOIL,1,1)
        utheff = ustart01(dp, roarow[None])               # cm/s
        # roughness correction (Marticorena 1997; z0s=1e-3, x=10)
        z0s, x = 1.0e-3, 10.0
        rc0 = 1.0 - (np.log(0.50e-2 / z0s)
                     / np.log(0.35 * (x / z0s) ** 0.8))
        # Fecan et al. 1999 soil-humidity correction
        cly = self.clayrow
        wprim = 0.0014 * cly * cly + 0.17 * cly
        tempd = torch.clamp(soilw * 100.0 - wprim, min=1.0e-5)
        hc = torch.where(soilw * 100.0 > wprim,
                         torch.sqrt(1.0 + 1.21 * tempd ** 0.68), 1.0)
        rc = rc0 / hc
        # friction velocity with the saltation-layer roughness increase
        # (Gillette et al. 1998)
        srl = z0 * 100.0                                  # cm
        umin = 15.0
        utmin = (umin / (100.0 * VONKAR * rc)) \
            * torch.log(1000.0 / torch.clamp(srl, min=1e-10))
        ustarns = ustar_ms * 100.0                        # cm/s
        ustar = torch.where(surfwd >= utmin,
                            ustarns + 0.3 * (surfwd - utmin) ** 2, ustarns)
        ustar = torch.clamp(ustar, min=1.0e-10)

        uth = utheff / (rc * ustar)[None]                 # (NSOIL,iy,jx)
        ok = uth <= 1.0
        fdp1 = ustar[None] ** 3 * (1.0 - uth * uth)
        fdp2 = (1.0 + uth) * self.rdstemfac * 1.0e-5 \
            * roarow[None] * c.regrav
        fdp = torch.where(ok & (fdp2 > 0.0), fdp1 * fdp2, 0.0)

        if self.ichdustemd == 1:
            # Alfaro sandblasting: the kinetic-energy flux partitioned
            # into the three aerosol modes (emission :812-870)
            dec_fac = 16300.0                             # beta
            ec = (np.pi / 12.0) * RHODUST * 1.0e-3 * dp ** 3 \
                * (20.0 * ustar[None]) ** 2
            p1 = torch.where(ec > E1, (ec - E1) / (ec - E3), 0.0)
            p2 = torch.where(ec > E1, (1.0 - p1) * (ec - E2) / (ec - E3),
                             torch.where(ec > E2, (ec - E2) / (ec - E3),
                                         0.0))
            p3 = torch.where(ec > E3, 1.0 - p1 - p2, 0.0)
            g = torch.stack([p * fdp * dec_fac / e * 1.0e-2
                             * (np.pi / 6.0) * RHODUST * (d * 1.0e-4) ** 3
                             for p, e, d in ((p1, E1, D1), (p2, E2, D2),
                                             (p3, E3, D3))])
            fl = _soil_sum(g, self.w_alfaro)              # (3, iy, jx)
            rsfrow = (self.frac1[:, None, None] * fl[0]
                      + self.frac2[:, None, None] * fl[1]
                      + self.frac3[:, None, None] * fl[2])
        else:
            # Kok et al. 2014 (emission :874-915)
            roa0, usst0, calph, ce, cd0 = 1.225, 0.16, 2.7, 2.0, 4.5e-5
            utheffc = utheff / rc[None]                   # cm/s
            uthk = utheffc / ustar[None]
            usst = utheffc * torch.sqrt(roarow[None] / roa0) / 100.0
            utheffc_m = utheffc / 100.0
            ustark = (ustar / 100.0)[None]
            k1 = calph * (usst - usst0) / usst0
            k2 = roarow[None] * (ustark ** 2 - utheffc_m ** 2) / usst
            cd = cd0 * torch.exp(-ce * (usst - usst0) / usst0)
            g = torch.where(uthk <= 1.0,
                            cd * k1 * uthk ** torch.clamp(k2, min=-20.0),
                            0.0)
            fl = _soil_sum(g, self.w_kok)
            rsfrow = self.frac[:, None, None] * fl
        w = self.emitmask * (1.0 - vegfrac) * (1.0 - snowfrac)
        return rsfrow * w[None]
