"""Vertical normal modes for the hydrostatic split-explicit scheme.

NumPy re-implementation of ``Main/mod_vmodes.F90`` (Errico & Bates,
NCAR/TN-312+IA): builds the thermodynamic matrix ``a0``, the linearized
hydrostatic matrices ``hydros``/``hydroc``, the tau matrix, and its
eigen-decomposition (equivalent depths ``hbar`` + mode matrix ``zmatx``)
using numpy.linalg instead of the vendored EISPACK (``Main/netlib``).
Runs once at setup on the host; the outputs are small (kz×kz) constant
matrices consumed by the jitted split-explicit step.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import constants as c


@dataclass
class VModes:
    sigmah: np.ndarray     # (kz+1,) half-sigma with sigmah[kz]=1
    tbarh: np.ndarray      # (kz,) reference temperature profile
    hbar: np.ndarray       # (kz,) equivalent depths (ordered desc)
    zmatx: np.ndarray      # (kz, kz) vertical modes (normalized)
    zmatxr: np.ndarray     # inverse
    tau: np.ndarray        # (kz, kz)
    a0: np.ndarray         # (kz, kz) with a4 removed (for am)
    varpa1: np.ndarray     # (kz, kz+1)
    hydros: np.ndarray     # (kz, kz)
    hydroc: np.ndarray     # (kz, kz+1)
    xps: float             # reference surface pressure (cb)
    pd: float              # xps - ptop


def standard_tbarh(sigmah, pd, ptop):
    """US standard atmosphere T at half levels (vtlaps,
    Main/mod_vmodes.F90)."""
    tstrat, zstrat = 218.15, 10769.0
    p0 = 101.325  # cb
    fac = c.rgas * c.lrate * c.regrav
    p = sigmah[:-1] * pd + ptop
    t = c.stdt * (p / p0) ** fac
    z = (c.stdt - t) / c.lrate
    return np.where(z > zstrat, tstrat, t)


def compute_vmodes(sigma: np.ndarray, ptop: float,
                   tbarh: np.ndarray | None = None,
                   xps: float | None = None) -> VModes:
    """Compute vertical modes (vmodes, Main/mod_vmodes.F90:86-500).

    sigma: (kz+1,) interface levels; ptop in cb; tbarh/xps optional
    linearization profile (defaults to the standard atmosphere, the
    reference's ``lstand`` path).
    """
    kz = len(sigma) - 1
    sigmah = np.empty(kz + 1)
    sigmah[:kz] = 0.5 * (sigma[:-1] + sigma[1:])
    sigmah[kz] = 1.0
    sdsigma = np.diff(sigma)

    if xps is None:
        xps = 101.325  # stdpcb
    pd = xps - ptop
    if tbarh is None:
        tbarh = standard_tbarh(sigmah, pd, ptop)

    # tbarf / thetaf at interfaces
    tbarf = np.zeros(kz + 1)
    for k in range(1, kz):
        # 1-based k=2..kz → 0-based interface k
        k1 = k - 1
        tbarf[k] = (tbarh[k1] * (sigmah[k] - sigma[k])
                    / (sigmah[k] - sigmah[k1])
                    + tbarh[k] * (sigma[k] - sigmah[k1])
                    / (sigmah[k] - sigmah[k1]))

    # matrices (Fortran k,l 1-based → numpy 0-based [k,l])
    e1 = np.ones((kz, kz))
    e2 = np.tril(np.ones((kz, kz)))            # l <= k
    d1 = np.diag(sdsigma)
    a3 = np.diag(-tbarh)
    d2 = np.diag(c.rovcp * tbarh / (sigmah[:kz] + ptop / pd))
    s1 = np.diag(sigma[:kz])
    s2 = np.diag(sigmah[:kz])
    x1 = np.eye(kz)
    e3 = np.eye(kz) + np.diag(np.ones(kz - 1), 1)
    g1 = np.zeros((kz, kz))
    for k in range(kz):
        if k > 0:
            g1[k, k] = tbarf[k]
        if k < kz - 1:
            g1[k, k + 1] = -tbarf[k + 1]

    # g2: divergence → sigma-dot transform
    w1 = e2 - x1
    w2 = w1 @ d1
    g2 = e1 @ d1
    g2 = s1 @ g2 - w2
    # a1
    w2i = np.diag(1.0 / sdsigma)
    a1 = w2i @ (g1 @ g2)
    # a2
    a2m = s2 @ (e1 @ d1)
    w2 = 0.5 * (e3 @ g2)
    a2 = d2 @ (w2 - a2m)
    # a4
    a4 = -(a3 @ (e1 @ d1))
    a0 = a1 + a2 + a3 + a4

    # hydros: matrix multiplying T in hydrostatic integration
    dlogp = np.zeros(kz + 1)
    for k in range(1, kz):
        dlogp[k] = np.log((sigmah[k] + ptop / pd)
                          / (sigmah[k - 1] + ptop / pd))
    hydros = np.zeros((kz, kz))
    for k in range(kz - 1):
        for lv in range(k, kz - 1):
            hydros[k, lv] += dlogp[lv + 1] * sdsigma[lv] \
                / (sdsigma[lv + 1] + sdsigma[lv])
            hydros[k, lv + 1] += dlogp[lv + 1] * sdsigma[lv + 1] \
                / (sdsigma[lv + 1] + sdsigma[lv])
    hydros[:, kz - 1] += np.log((1.0 + ptop / pd)
                                / (sigmah[kz - 1] + ptop / pd))

    # hydroc: matrix multiplying log(sigma p* + ptop)
    hydroc = np.zeros((kz, kz + 1))
    tweigh = np.zeros(kz)
    for lv in range(1, kz):
        tweigh[lv] = (tbarh[lv] * sdsigma[lv] + tbarh[lv - 1]
                      * sdsigma[lv - 1]) / (sdsigma[lv] + sdsigma[lv - 1])
    for lv in range(1, kz - 1):
        hydroc[:lv, lv] = tweigh[lv] - tweigh[lv + 1]
    for lv in range(kz - 1):
        hydroc[lv, lv] = tbarh[lv] - tweigh[lv + 1]
    hydroc[: kz - 1, kz - 1] = tweigh[kz - 1] - tbarh[kz - 1]
    hydroc[:, kz] = tbarh[kz - 1]

    # tau matrix
    w3 = np.zeros((kz + 1, kz))
    for lv in range(kz):
        w3[:, lv] = sdsigma[lv] / (1.0 + ptop / (pd * sigmah))
    tau = -c.rgas * (hydros @ a0 - hydroc @ w3)

    # eigen-decomposition (replaces EISPACK rg)
    evals, evecs = np.linalg.eig(tau)
    evals = np.real_if_close(evals, tol=1e6)
    if np.iscomplexobj(evals):
        evals = evals.real
        evecs = evecs.real
    # order desc by eigenvalue (vorder)
    order = np.argsort(-evals)
    hbar = evals[order]
    zmatx = evecs[:, order].copy()
    # normalize (vnorml): largest-|component| positive, mass-weighted
    # square sum = 1
    for lv in range(kz):
        col = zmatx[:, lv]
        kmax = np.argmax(np.abs(col))
        v = np.sum(sdsigma * col * col)
        a = np.sign(col[kmax]) / np.sqrt(v)
        zmatx[:, lv] = a * col
    zmatxr = np.linalg.inv(zmatx)

    # varpa1 (Daley variational surface-pressure weights)
    hydror = np.linalg.inv(hydros)
    hweigh = np.zeros(kz)
    hweigh[kz - 1] = 1.0
    w1m = np.zeros((kz, kz))
    for k1 in range(kz):
        for k2 in range(kz):
            w1m[k2, k1] = np.sum(hydror[:, k2] * hydror[:, k1]
                                 * hweigh / tbarh ** 2)
    varpa1 = (w1m @ hydroc) * (xps * xps)

    # reference subtracts a4 from a0 before computing am
    a0_am = a0 - a4
    # tau used below is rgas*zmatxr·hydros etc. — keep raw pieces
    return VModes(sigmah=sigmah, tbarh=tbarh, hbar=hbar, zmatx=zmatx,
                  zmatxr=zmatxr, tau=tau, a0=a0_am, varpa1=varpa1,
                  hydros=hydros, hydroc=hydroc, xps=xps, pd=pd)


@dataclass
class SplitCoeffs:
    """Per-mode coefficients for splitf (spinit, Main/mod_split.F90:75-180).

    Only the first `nsplit` (fastest) modes are integrated.
    """
    nsplit: int
    aam: np.ndarray        # substep counts per mode
    dtau: np.ndarray       # substep lengths
    hbar: np.ndarray       # equivalent depths of split modes (nsplit,)
    an: np.ndarray         # (nsplit,) ps correction weights (×fac)
    am: np.ndarray         # (kz, nsplit) T correction weights (×fac)
    zmatx: np.ndarray      # (kz, nsplit) u,v correction weights (×fac)
    zmatxr: np.ndarray     # (nsplit, kz) mode projection
    tau_n: np.ndarray      # (nsplit, kz) rgas·zmatxr·hydros
    varpa1_n: np.ndarray   # (nsplit, kz+1) rgas·zmatxr·hydroc ·... see spinit
    sigmah: np.ndarray
    pd: float


def compute_split_coeffs(vm: VModes, nsplit: int, dtsec: float) -> SplitCoeffs:
    kz = len(vm.tbarh)
    # dtau(ns) = dt·0.5/(nsplit-ns+1) (Main/mod_params.F90:1703-1704)
    dtau = np.array([dtsec * 0.5 / (nsplit - ns) for ns in range(nsplit)])
    aam = np.rint(dtsec / dtau)
    an = np.zeros(nsplit)
    am = np.zeros((kz, nsplit))
    tau_n = np.zeros((nsplit, kz))
    varpa1_n = np.zeros((nsplit, kz + 1))
    zmatx = vm.zmatx[:, :nsplit].copy()
    zmatxr = vm.zmatxr[:nsplit, :].copy()
    dsig = np.diff(vm.sigmah, prepend=0.0)  # not used; keep simple
    sdsigma = None
    # an(n) = Σ_l dsigma(l) zmatx(l,n)
    # recompute dsigma from sigmah? use vm: reference uses model dsigma
    # caller passes exact dsigma via vm.sigmah? Use differences of sigma...
    # store via hydros trick: dsigma = row sums not available; caller fixes.
    return SplitCoeffs(nsplit=nsplit, aam=aam, dtau=dtau,
                       hbar=vm.hbar[:nsplit].copy(), an=an, am=am,
                       zmatx=zmatx, zmatxr=zmatxr, tau_n=tau_n,
                       varpa1_n=varpa1_n, sigmah=vm.sigmah, pd=vm.pd)


def finish_split_coeffs(sc: SplitCoeffs, vm: VModes, dsigma: np.ndarray,
                        dtsec: float) -> SplitCoeffs:
    """Fill an/am/tau/varpa1 with the model dsigma (spinit second half)."""
    kz = len(dsigma)
    for n in range(sc.nsplit):
        sc.an[n] = np.sum(dsigma * vm.zmatx[:, n])
        sc.am[:, n] = vm.a0 @ vm.zmatx[:, n]
        sc.tau_n[n, :] = c.rgas * (vm.zmatxr[n, :] @ vm.hydros)
        sc.varpa1_n[n, :] = c.rgas * (vm.zmatxr[n, :] @ vm.hydroc)
    # multiply am, an, zmatx by fac = 2·dtsec/(2·aam+1)
    for n in range(sc.nsplit):
        fac = 2.0 * dtsec / (2.0 * sc.aam[n] + 1.0)
        sc.an[n] *= fac
        sc.zmatx[:, n] = sc.zmatx[:, n] * fac
        sc.am[:, n] = sc.am[:, n] * fac
    return sc


def make_split_coeffs(sigma: np.ndarray, ptop: float, nsplit: int,
                      dtsec: float, tbarh=None, xps=None) -> SplitCoeffs:
    vm = compute_vmodes(sigma, ptop, tbarh, xps)
    sc = compute_split_coeffs(vm, nsplit, dtsec)
    return finish_split_coeffs(sc, vm, np.diff(sigma), dtsec)
