"""MOLOCH non-hydrostatic dynamical core (idynamic=3), torch twin of
``regcm_tpu/dynamics/moloch.py``.

``Main/mod_moloch.F90`` (``moloch`` :224, ``sound`` :708,
``advection``/``wafone`` :1042-1361) with the zita terrain-following
height coordinate of ``Share/mod_zita.F90``. Arakawa-C grid: u at
x-faces, v at y-faces, w and s at the zita interfaces, scalars at the
centres; the prognostics are not mass-coupled (u, v, w in m/s, pai the
Exner function, t the temperature, qx mixing ratios).

Each step runs ``nsound`` implicit-vertical acoustic substeps, whose w
solve goes through kernel K3 (``kernels.tridiag_w``), nested in ``nadv``
WAF advection passes of the whole field stack through kernel K4
(``kernels.waf_advect``), then the physics, the boundary relaxation and
the every-step smoothers. With chemistry the tracers (``chi_b``,
uncoupled mixing ratios) join the WAF stack (nf = 5 + nqx + ntr), take
the physics' tendency, relax toward clean air at the lateral boundary
and are smoothed as the hydrometeors are. The metric and mask constants
are built in numpy, as in the JAX package, and put on the device once.

With a ``DomainMesh`` (``MolochCore(..., mesh=...)``, the JAX core's
``set_mesh``) the core steps one rank's (ly, lx) block of the domain:
the constants and the initial state are built on the whole grid and
sliced, every horizontal stencil reads across block edges through the
halo exchange of ``stencil.shift``/``shifte``, the w solve goes through
K5b and the WAF pass through K5a (Holtslag's solve through K5c), and
the diagnostics are reduced over the ranks.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..chem import chem_ntr
from ..config.params import RegCMConfig
from ..core.grid import ModelGrid
from ..core.state import (sliced, species_count, tensors_from,
                          state_to_numpy)
from ..device import resolve_device
from ..kernels.tridiag_w import tridiag_w, tridiag_w_sharded
from ..kernels.waf_advect import (waf_advect, waf_advect_plain,
                                  waf_advect_sharded)
from ..physics.surface.lake import lake_layers
from ..utils import constants as c
from ..utils.thermo import pfwsat, wlh
from .hydrostatic import level_sum
from .stencil import shift, shifte, topology, with_topology

T0_ZITA = 280.0
HZITA = c.rgas * T0_ZITA / c.egrav          # Share/mod_zita.F90:32


def gzita(z, a0=0.0):
    r = z / HZITA
    return 1.0 - a0 * r - (3.0 - 2.0 * a0) * r ** 2 + (2.0 - a0) * r ** 3


def gzitap(z, a0=0.0):
    r = z / HZITA
    return (-a0 - (6.0 - 4.0 * a0) * r + (6.0 - 3.0 * a0) * r ** 2) / HZITA


def bzita(z, b0=0.0):
    return b0 + (1.0 - b0) * (z / HZITA)


def bzitap(z, b0=0.0):
    return (1.0 - b0) / HZITA


def md_fmz_h(z, orog, a0=0.0, b0=0.0):
    """Vertical metric factor (Share/mod_zita.F90 md_fmz, Equation 9)."""
    zfz = 1.0 - z / HZITA
    return zfz / (bzita(z, b0) + orog * zfz * gzitap(z, a0)
                  - HZITA * zfz * np.log(np.maximum(zfz, 1e-12))
                  * bzitap(z, b0))


def md_zeta_h(z, orog, a0=0.0, b0=0.0):
    """Height above orography (Equation 7)."""
    zfz = np.maximum(1.0 - z / HZITA, 1e-12)
    return np.maximum(orog * gzita(z, a0) - HZITA * bzita(z, b0)
                      * np.log(zfz) - orog, 0.0)


def _x2uvstag(ux, vx):
    """Cross-point winds to the C-grid faces (xtouvstag)."""
    u = 0.5 * (ux + shifte(ux, 0, -1))
    v = 0.5 * (vx + shifte(vx, -1, 0))
    return u, v


class MolochState(NamedTuple):
    """MOLOCH prognostics and the physics/surface state; the field names,
    shapes and meaning of ``regcm_tpu.dynamics.moloch.MolochState``."""
    u: torch.Tensor       # (kz, iy, jx) at u-faces (west face of cross)
    v: torch.Tensor       # (kz, iy, jx) at v-faces (south face)
    w: torch.Tensor       # (kz+1, iy, jx) at interfaces (0=top, kz=surface)
    pai: torch.Tensor     # Exner function at centres
    t: torch.Tensor       # temperature at centres
    qx: torch.Tensor      # (nqx, kz, iy, jx) mixing ratios
    tg: torch.Tensor
    rainnc: torch.Tensor
    rainc: torch.Tensor
    heatrt: torch.Tensor  # (kz, iy, jx) radiative heating rate (K/s)
    qfx: torch.Tensor
    hfx: torch.Tensor
    uvdrag: torch.Tensor
    swsfc: torch.Tensor
    lwsfc: torch.Tensor
    cbmf: torch.Tensor
    cldefi: torch.Tensor
    cuten: torch.Tensor   # (9, kz, iy, jx) held cumulus tendencies
    cuprate: torch.Tensor
    wavg: torch.Tensor
    bats: torch.Tensor    # (10, iy, jx)
    seaice: torch.Tensor  # (4, iy, jx)
    dcsst: torch.Tensor   # (3, iy, jx)
    tlak: torch.Tensor    # (nlak, iy, jx)
    lakhi: torch.Tensor
    lakice: torch.Tensor
    laksnow: torch.Tensor
    laksnag: torch.Tensor
    tke_a: torch.Tensor   # (kz+1, iy, jx)
    pbl0: torch.Tensor    # (2, iy, jx)
    abstot: torch.Tensor  # ((kz+1)², iy, jx)
    absnxt: torch.Tensor  # (4·kz, iy, jx)
    emstot: torch.Tensor  # (kz+1, iy, jx)
    chi_b: torch.Tensor   # (ntr, kz, iy, jx)
    chemdiag: torch.Tensor  # (3, ntr, iy, jx)


class MolochBdy(NamedTuple):
    """Lateral boundary pairs (b0 + t·bt), uncoupled fields."""
    pai0: torch.Tensor
    pait: torch.Tensor
    t0: torch.Tensor
    tt: torch.Tensor
    qv0: torch.Tensor
    qvt: torch.Tensor
    u0: torch.Tensor
    ut: torch.Tensor
    v0: torch.Tensor
    vt: torch.Tensor


def zeros_moloch_phys(kz: int, iy: int, jx: int, device="cuda",
                      dtype=torch.float64, nlak: int = 1, ntr: int = 0):
    """Zero-initialised physics/surface fields of a MolochState with
    ``ntr`` chemistry tracers."""
    device = resolve_device(device)

    def full(shape, v=0.0):
        return torch.full(shape, v, dtype=dtype, device=device)
    z2 = full((iy, jx))
    z3 = full((kz, iy, jx))
    return dict(tg=z2, rainnc=z2, rainc=z2, heatrt=z3, qfx=z2, hfx=z2,
                uvdrag=z2, swsfc=z2, lwsfc=z2, cbmf=z2,
                cldefi=full((iy, jx), 0.6),
                cuten=full((9, kz, iy, jx)),
                cuprate=z2, wavg=z3,
                bats=full((10, iy, jx)),
                seaice=full((4, iy, jx)),
                dcsst=full((3, iy, jx)),
                tlak=full((nlak, iy, jx)),
                lakhi=full((iy, jx), 0.01),
                lakice=z2, laksnow=z2, laksnag=z2,
                tke_a=full((kz + 1, iy, jx), 1.0e-3),
                pbl0=full((2, iy, jx)),
                abstot=full(((kz + 1) * (kz + 1), iy, jx)),
                absnxt=full((4 * kz, iy, jx)),
                emstot=full((kz + 1, iy, jx)),
                chi_b=full((ntr, kz, iy, jx)),
                chemdiag=full((3, ntr, iy, jx)))


def moloch_state_from_numpy(s, device="cuda", dtype=torch.float64,
                            mesh=None) -> MolochState:
    """MolochState of tensors from any NamedTuple with the same fields
    (e.g. the JAX package's state after ``jax.device_get``); with a
    ``DomainMesh`` the global arrays are cut to the rank's block."""
    return tensors_from(MolochState, sliced(s, mesh), device, dtype)


def moloch_bdy_from_numpy(b, device="cuda", dtype=torch.float64,
                          mesh=None) -> MolochBdy:
    """MolochBdy of tensors from any NamedTuple with the same fields (cut
    to the rank's block of ``mesh``)."""
    return tensors_from(MolochBdy, sliced(b, mesh), device, dtype)


# field name → numpy array (host copy), as for the hydrostatic state
moloch_state_to_numpy = state_to_numpy


def _refuse_options(cfg: RegCMConfig):
    """Raise for every MOLOCH option this port leaves out."""
    if cfg.core.idynamic != 3:
        raise NotImplementedError(
            f"MolochCore needs idynamic=3, got {cfg.core.idynamic}")
    if cfg.geo.i_band or cfg.geo.i_crm:
        raise NotImplementedError(
            "regcm_tpu_torch does not port periodic MOLOCH domains "
            "(i_band/i_crm): the JAX package's MolochCore has none to hold "
            "a port against (ROADMAP.md Queue 3)")


class MolochCore:
    """MOLOCH integration engine: device constants and the eager step."""

    def __init__(self, grid: ModelGrid, cfg: RegCMConfig, device="cuda",
                 dtype=torch.float64, physics=None, mesh=None):
        _refuse_options(cfg)
        device = resolve_device(device)
        self.grid = grid
        self.cfg = cfg
        self.device = device
        self.dtype = dtype
        self.physics = physics
        self.mesh = mesh
        # vertical profiles, and (..., iy, jx) fields built on the whole
        # grid (np.roll wraps around it, hx[:, 0] fixes its edge) and cut
        # to the rank's block
        f1 = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,
                                       device=device)
        f = f1 if mesh is None \
            else (lambda x: f1(mesh.local(np.asarray(x))))
        g = grid
        kz, iy, jx = g.kz, g.iy, g.jx
        self.kz, self.iy, self.jx = kz, iy, jx
        self.dx = float(g.ds)
        self.dtsec = cfg.dtsec
        self.nadv = cfg.moloch.mo_nadv
        self.nsound = cfg.moloch.mo_nsound
        self.a0 = cfg.moloch.mo_a0
        self.b0 = cfg.moloch.mo_b0
        self.dz = HZITA / kz                 # mo_dz (mod_params.F90:1169)

        # vertical coordinate (mod_params.F90:2802-2813): index 0 = top
        # interface (zita = kz·dz), index kz = surface (0)
        zitaf = np.array([(kz - k) * self.dz for k in range(kz + 1)])
        zitah = zitaf[1:] + 0.5 * self.dz    # centres (0=top layer)
        ht = np.asarray(g.ht)                # geopotential g·z
        orog = ht / c.egrav
        self.fmz = f(np.stack([md_fmz_h(zitah[k], orog, self.a0, self.b0)
                               for k in range(kz)]))
        fmzf = np.stack([md_fmz_h(zitaf[k], orog, self.a0, self.b0)
                         for k in range(kz + 1)])
        fmzf[0] = 0.0                        # mod_params: fmzf(:,:,1)=0
        self.fmzf = f(fmzf)
        zeta_np = np.stack([md_zeta_h(zitah[k], orog, self.a0, self.b0)
                            for k in range(kz)])
        self.zeta = f(zeta_np)
        # what initial_state and fields_from_sigma need of the whole grid,
        # in the working dtype
        self._init_fields = tuple(
            torch.as_tensor(a, dtype=dtype) for a in (zeta_np, ht, fmzf))
        zetaf = np.stack([md_zeta_h(zitaf[k], orog, self.a0, self.b0)
                          for k in range(kz + 1)])
        zetaf[0] = 48446.4
        self.zetaf = f(zetaf)
        self.gzitak = f1(gzita(zitaf, self.a0))      # (kz+1,)
        self.gzitakh = f1(gzita(zitah, self.a0))     # (kz,)

        # acoustic vertical filter (mod_init.F90:999-1012), interface idx
        mo_nzfilt = int(cfg.moloch.extras.get("mo_nzfilt", 10))
        ffilt = np.zeros(kz + 1)
        if mo_nzfilt > 0:
            ntop = int(0.08 * kz)
            zfilt = (kz + 1 - ntop + mo_nzfilt) * self.dz
            for k in range(1, kz):           # 1-based k → interface k
                if k + 1 > ntop + mo_nzfilt - 1:
                    ffilt[k] = 0.0
                else:
                    zzi = (self.dz * (kz + 1 - (k + 1)) - zfilt) \
                        / (HZITA - zfilt)
                    ffilt[k] = 0.8 * math.sin(0.5 * math.pi * zzi) ** 2
        self.ffilt = f1(ffilt)

        # horizontal metrics: map factors at the faces, terrain slopes
        # hx/hy (mod_params.F90:2762-2776)
        msfx = np.asarray(g.msfx)
        msfu = 0.5 * (msfx + np.roll(msfx, 1, axis=1))   # west face
        msfv = 0.5 * (msfx + np.roll(msfx, 1, axis=0))   # south face
        self.mx2 = f(msfx * msfx)
        self.rmu = f(1.0 / msfu)
        self.rmv = f(1.0 / msfv)
        self.mu = f(msfu)
        self.mv = f(msfv)
        rdx = 1.0 / self.dx
        hx = (ht - np.roll(ht, 1, axis=1)) * msfu * rdx * c.regrav
        hy = (ht - np.roll(ht, 1, axis=0)) * msfv * rdx * c.regrav
        hx[:, 0] = hx[:, 1]
        hy[0, :] = hy[1, :]
        self.hx = f(hx)
        self.hy = f(hy)
        lat = np.asarray(g.xlat)
        self.coriou = f(2.0 * c.eomeg * np.sin(
            0.5 * (lat + np.roll(lat, 1, axis=1)) * c.degrad))
        self.coriov = f(2.0 * c.eomeg * np.sin(
            0.5 * (lat + np.roll(lat, 1, axis=0)) * c.degrad))
        self.ht = f(ht)

        # masks: cross interior, and the C-grid face interiors of the
        # sound momentum loops (mod_moloch.F90:947-1035): u faces
        # x∈[2,jx-3], y∈[1,iy-3]; v faces y∈[2,iy-3], x∈[1,jx-3] (0-based)
        self.m_ci = f(g.m_cross_int)
        mu_m = np.zeros((iy, jx))
        mu_m[1:iy - 2, 2:jx - 2] = 1.0
        mv_m = np.zeros((iy, jx))
        mv_m[2:iy - 2, 1:jx - 2] = 1.0
        self.m_u = f(mu_m)
        self.m_v = f(mv_m)
        # nudging maps (iboudy coefficients scaled ×nadv·nsound,
        # setup_bdycon Main/mod_bdycod.F90:215-219)
        scl = float(self.nadv * self.nsound)
        self.nfc = f(g.nudge_fc) * scl
        self.ngc = f(g.nudge_gc) * scl

        # every-step smoother coefficients (mod_moloch.F90:217-219)
        self.nupait = 1.0 / self.nadv
        self.nuwind = 1.0 / self.nsound
        self.nuqx = 0.5 * self.nuwind

        # physics contract read by PhysicsSuite (uncoupled prognostics:
        # the coupling factor in atms is 1)
        self.nqx = species_count(cfg.physics.ipptls)
        # chemistry tracers (chi_b, uncoupled mixing ratios) and the
        # interface weights of their settling flux (twt of mod_vertint)
        self.ntr = chem_ntr(cfg)
        self.twt1 = f1(g.twt[:, 0])[:, None, None]
        self.twt2 = f1(g.twt[:, 1])[:, None, None]
        self.grid_lndocn = f(g.lndocn)
        self.sst = torch.full_like(self.mx2, 288.0)
        self.coriol = f(g.coriol)
        self.m_di = self.m_u                 # only used by B-grid paths
        sx = cfg.subex
        land = np.asarray(g.lndocn) > 0.5
        self.qck1 = f(np.where(land, sx.qck1land, sx.qck1oce))
        self.cgul = f(np.where(land, sx.gulland, sx.guloce))
        self.cevap = f(np.where(land, sx.cevaplnd, sx.cevapoce))
        self.caccr = f(np.where(land, sx.caccrlnd, sx.caccroce))
        self.rh0 = f(np.where(land, sx.rh0land, sx.rh0oce))
        self.rhmax = sx.rhmax
        self.rhmin = 0.01
        self.conf = sx.conf

        # upper Rayleigh damping toward the boundary values (moraydamp,
        # Main/mod_bdycod.F90 + tau :5115; ramps over rayhd below the top)
        dxp = cfg.dyn.extras
        self.ifrayd = int(dxp.get("ifrayd", 1))
        self.rayalpha0 = float(dxp.get("rayalpha0", 3.0e-4))
        self.rayhd = float(dxp.get("rayhd", 1.0e4))
        ztop = zeta_np[0]
        ramp = lambda z: np.where(
            z > ztop - self.rayhd,
            self.rayalpha0
            * np.sin(0.5 * np.pi
                     * (1.0 - (ztop - z) / self.rayhd)) ** 2, 0.0)
        self.raytau = f(ramp(zeta_np))              # cross centres
        zeta_u = 0.5 * (zeta_np + np.roll(zeta_np, 1, axis=2))
        zeta_v = 0.5 * (zeta_np + np.roll(zeta_np, 1, axis=1))
        ztop_u = zeta_u[0]
        ztop_v = zeta_v[0]
        self.raytau_u = f(np.where(
            zeta_u > ztop_u - self.rayhd,
            self.rayalpha0 * np.sin(0.5 * np.pi * (
                1.0 - (ztop_u - zeta_u) / self.rayhd)) ** 2, 0.0))
        self.raytau_v = f(np.where(
            zeta_v > ztop_v - self.rayhd,
            self.rayalpha0 * np.sin(0.5 * np.pi * (
                1.0 - (ztop_v - zeta_v) / self.rayhd)) ** 2, 0.0))

    # ------------------------------------------------------------------
    def initial_state(self, perturb=0.0, bubble=None, seed=0
                      ) -> MolochState:
        """Hydrostatically balanced standard atmosphere on zita levels,
        built in numpy on the host and put on the core's device.

        bubble: optional (amp_K, y0, x0, rad_m, zc_m) warm bubble;
        perturb: white-noise T amplitude from numpy.random.default_rng(seed)."""
        kz, iy, jx = self.kz, self.iy, self.jx
        # on the whole grid (in the working dtype), then cut to the block
        zeta, ht, fmzf = (a.numpy() for a in self._init_fields)
        dev = self.device if self.mesh is None else torch.device("cpu")
        zc = zeta + ht[None] * c.regrav
        t = np.maximum(c.stdt - c.lrate * zc, 216.65)
        # analytic hydrostatic Exner of the standard atmosphere
        pex = c.egrav / (c.cpd * c.lrate)
        pai0 = (101325.0 / c.stdp) ** c.rovcp
        ztrop = (c.stdt - 216.65) / c.lrate
        pai_trop = pai0 * (216.65 / c.stdt) ** pex
        pai = np.where(zc <= ztrop,
                       pai0 * (1.0 - c.lrate * zc / c.stdt) ** pex,
                       pai_trop * np.exp(-c.egrav * (zc - ztrop)
                                         / (c.cpd * 216.65)))
        # discrete hydrostatic balance of the sound solver:
        # pai[K-1] = pai[K] − g·dz/(cp·fmzf[K]·½(θv[K-1]+θv[K]))
        tv = t
        for K in range(kz - 1, 0, -1):
            x = pai[K - 1].copy()
            for _ in range(8):
                thf = 0.5 * (tv[K - 1] / x + tv[K] / pai[K])
                x = pai[K] - c.egrav * self.dz / (c.cpd * fmzf[K] * thf)
            pai[K - 1] = x
        if bubble is not None:
            amp, y0, x0, rad, zcb = bubble
            yy = np.arange(iy)[None, :, None]
            xx = np.arange(jx)[None, None, :]
            dist = np.sqrt(((yy - y0) * self.dx) ** 2
                           + ((xx - x0) * self.dx) ** 2
                           + ((zc - zcb) * 6.0) ** 2)
            t = t + amp * np.maximum(1.0 - dist / rad, 0.0)
        if perturb > 0.0:
            rng = np.random.default_rng(seed)
            t = t + perturb * rng.standard_normal(t.shape) \
                * np.asarray(self.grid.m_cross_int)[None]
        qv = 0.4 * pfwsat(torch.as_tensor(t),
                          torch.as_tensor(pai ** c.cpovr * c.stdp)).numpy()
        qv = np.minimum(qv, 0.012)
        f = lambda x: torch.as_tensor(x, dtype=self.dtype, device=dev)
        qx = torch.cat([f(qv)[None],
                        torch.zeros((self.nqx - 1, kz, iy, jx),
                                    dtype=self.dtype, device=dev)])
        phys = zeros_moloch_phys(kz, iy, jx, dev, self.dtype,
                                 nlak=lake_layers(self.cfg.physics),
                                 ntr=self.ntr)
        phys["tg"] = f(t[kz - 1])
        z3 = torch.zeros((kz, iy, jx), dtype=self.dtype, device=dev)
        st = MolochState(
            u=z3, v=z3.clone(),
            w=torch.zeros((kz + 1, iy, jx), dtype=self.dtype, device=dev),
            pai=f(pai), t=f(t), qx=qx, **phys)
        if self.mesh is not None:
            st = MolochState(*(self.mesh.local(a).to(self.device)
                               for a in st))
        return st

    # ------------------------------------------------------------------
    def fields_from_sigma(self, ps, t, qv, u, v, sigma_f):
        """ICBC fields on sigma-p half levels → MOLOCH zita levels (the
        mod_init idynamic=3 path: height interpolation and the hydrostatic
        pai of ``paicompute``, Main/mod_bdycod.F90:5125).

        ps in Pa (full surface pressure), t/qv/u/v (kz_src, iy, jx) on
        sigma half levels (top→bottom), sigma_f (kz_src+1,) interfaces, all
        of the whole domain. Returns dict(pai, t, qv, u, v) of the whole
        domain as host tensors in the working dtype (u/v at the C-grid
        faces). numpy in float64 up to the staggering, as in the JAX
        package; runs once per boundary input."""
        ps = np.asarray(ps, np.float64)
        t = np.asarray(t, np.float64)
        qv = np.asarray(qv, np.float64)
        ptop = float(self.grid.ptop) * 1000.0          # Pa
        sf = np.asarray(sigma_f, np.float64)[:, None, None]
        pf = sf * (ps[None] - ptop) + ptop             # (kzs+1, iy, jx)
        tv = t * (1.0 + c.ep1 * qv)
        # hypsometric heights above ground at half levels
        dz_lay = c.rgas * tv / c.egrav * np.log(pf[1:] / pf[:-1])
        zf = np.zeros_like(pf)
        zf[:-1] = np.cumsum(dz_lay[::-1], axis=0)[::-1]
        za_src = 0.5 * (zf[:-1] + zf[1:])              # above ground
        za_dst = self._init_fields[0].numpy()          # above ground
        kzs = za_src.shape[0]
        src_z = za_src[::-1]                    # ascending in height
        dst_z = za_dst[::-1]
        idx = np.sum(src_z[None] <= dst_z[:, None], axis=1)
        idx = np.clip(idx, 1, kzs - 1)
        lo, hi = idx - 1, idx
        zlo = np.take_along_axis(src_z, lo, 0)
        zhi = np.take_along_axis(src_z, hi, 0)
        wgt = np.clip((dst_z - zlo) / np.maximum(zhi - zlo, 1e-9),
                      0.0, 1.0)

        def vinterp(fld):
            # linear in height, clamped at the profile ends (every column
            # at once)
            src_f = np.asarray(fld, np.float64)[::-1]
            flo = np.take_along_axis(src_f, lo, 0)
            fhi = np.take_along_axis(src_f, hi, 0)
            return (flo + wgt * (fhi - flo))[::-1]
        t_m = vinterp(t)
        qv_m = np.maximum(vinterp(qv), c.minqq)
        u_m = vinterp(u)
        v_m = vinterp(v)
        pai = self.paicompute(ps, t_m, qv_m)
        f = lambda x: torch.as_tensor(np.ascontiguousarray(x),
                                      dtype=self.dtype)
        with topology():                 # the whole domain, on the host
            uf, vf = _x2uvstag(f(u_m), f(v_m))
        return dict(pai=f(pai), t=f(t_m), qv=f(qv_m), u=uf, v=vf)

    def paicompute(self, ps, t, qv):
        """Hydrostatic Exner initialisation (paicompute,
        Main/mod_bdycod.F90:5125-5155) on the whole domain: the lowest
        level from ps extrapolated over the surface half layer, then the
        upward quadratic recursion. numpy float64 in and out."""
        kz = self.kz
        t = np.asarray(t, np.float64)
        qv = np.asarray(qv, np.float64)
        _, ht, fmzf = (np.asarray(a.numpy(), np.float64)
                       for a in self._init_fields)
        zz1 = -c.egrav * HZITA * bzita(0.5 * self.dz, self.b0) \
            * math.log(1.0 - 0.5 * self.dz / HZITA)
        zdelta = ht * (gzita(0.5 * self.dz, self.a0) - 1.0) + zz1
        tvk = t[kz - 1] * (1.0 + c.ep1 * qv[kz - 1])
        p_low = np.asarray(ps, np.float64) \
            * np.exp(-zdelta / (c.rgas * tvk))
        pai = np.empty((kz,) + p_low.shape, np.float64)
        pai[kz - 1] = (p_low / c.stdp) ** c.rovcp
        for k in range(kz - 2, -1, -1):
            tv1 = t[k] * (1.0 + c.ep1 * qv[k])
            tv2 = t[k + 1] * (1.0 + c.ep1 * qv[k + 1])
            zb = 2.0 * c.egrav * self.dz / (fmzf[k + 1] * c.cpd) \
                + tv1 - tv2
            zdel = np.sqrt(zb ** 2 + 4.0 * tv2 * tv1)
            pai[k] = -pai[k + 1] / (2.0 * tv2) * (zb - zdel)
        return pai

    # ------------------------------------------------------------------
    def _sound(self, u, v, w, pai, tetav, qv, qsat, dts):
        """The nsound acoustic substeps (sound, mod_moloch.F90:708-1040);
        the implicit w solve of each goes through kernel K3."""
        kz = self.kz
        dtrdx = dts / self.dx
        dtrdz = dts / self.dz
        zcs2 = dtrdz ** 2 * c.rdrcv

        for jsound in range(1, self.nsound + 1):
            # surface w from terrain-following flow (:744-755)
            zuh = u[kz - 1] * self.hx + shift(u[kz - 1], 0, 1) \
                * shift(self.hx, 0, 1)
            zvh = v[kz - 1] * self.hy + shift(v[kz - 1], 1, 0) \
                * shift(self.hy, 1, 0)
            w_sfc = 0.5 * (zuh + zvh)
            w = w.clone()                   # w.at[kz].set(w_sfc)
            w[kz] = w_sfc
            # partial generalized vertical velocity s (Equation 10)
            zuh_i = ((u[1:] + u[:-1]) * self.hx[None]
                     + (shift(u[1:], 0, 1) + shift(u[:-1], 0, 1))
                     * shift(self.hx, 0, 1)[None])
            zvh_i = ((v[1:] + v[:-1]) * self.hy[None]
                     + (shift(v[1:], 1, 0) + shift(v[:-1], 1, 0))
                     * shift(self.hy, 1, 0)[None])
            s_int = -0.25 * (zuh_i + zvh_i) * self.gzitak[1:kz, None, None]
            s = torch.cat([torch.zeros_like(w[:1]), s_int, -w_sfc[None]],
                          dim=0)

            # horizontal divergence (Equation 16, :800-830)
            favg = lambda a, dy, dx_: 2.0 / (a + shifte(a, dy, dx_))
            zum = u * self.rmu[None] * favg(self.fmz, 0, -1)
            zup = shift(u, 0, 1) * shift(self.rmu, 0, 1)[None] \
                * 2.0 / (self.fmz + shifte(self.fmz, 0, 1))
            zvm = v * self.rmv[None] * favg(self.fmz, -1, 0)
            zvp = shift(v, 1, 0) * shift(self.rmv, 1, 0)[None] \
                * 2.0 / (self.fmz + shifte(self.fmz, 1, 0))
            zdiv2 = ((zup - zum) + (zvp - zvm)) * dtrdx
            # (the JAX core adds a 4-point laplacian of zdiv2 times 0.0
            # here, a placeholder for filt3d; the port leaves it out)
            zdiv2 = self.fmz * (self.mx2[None] * zdiv2
                                + dtrdz * (s[:kz] - s[1:]))

            # implicit w (Equation 19, :838-905): tridiagonal per column
            th_abv = tetav[:-1]                 # θv at centre above iface K
            th_blw = tetav[1:]
            fmzf_i = self.fmzf[1:kz]
            rom1w = 0.5 * c.cpd * fmzf_i * (th_abv + th_blw) \
                - c.cpd * w[1:kz] * fmzf_i ** 2 * float(jsound) * dtrdz \
                * (th_abv - th_blw)
            wexpl = w[1:kz] - rom1w * dtrdz * (pai[:-1] - pai[1:]) \
                - c.egrav * dts \
                + c.rdrcv * rom1w * dtrdz * (pai[:-1] * zdiv2[:-1]
                                             - pai[1:] * zdiv2[1:])
            zp = zcs2 * self.fmz[:-1] * rom1w * pai[:-1] \
                + self.ffilt[1:kz, None, None]
            zm = zcs2 * self.fmz[1:] * rom1w * pai[1:] \
                + self.ffilt[1:kz, None, None]

            w_old = w
            w_new_int = tridiag_w(wexpl, zm, zp, w[kz]) \
                if self.mesh is None \
                else tridiag_w_sharded(self.mesh, wexpl, zm, zp, w[kz])
            w = torch.cat([torch.zeros_like(w[:1]), w_new_int, w[kz:]],
                          dim=0)
            deltaw = w - w_old
            deltaw[kz] = 0.0                # fresh tensor: in-place is safe

            # new Exner (Equation 19, :920-940)
            zdiv2 = zdiv2 + dtrdz * self.fmz * (w[:kz] - w[1:])
            pai = torch.where(self.m_ci[None] > 0.5,
                              pai * (1.0 - c.rdrcv * zdiv2), pai)

            # horizontal momentum (Equations 17/18, :947-1035)
            dwc = deltaw[:kz] + deltaw[1:]       # centre sum w, k+1
            zfz_u = 0.25 * (shift(dwc, 0, -1) + dwc) + c.egrav * dts
            rom1u = 0.5 * c.cpd * (shift(tetav, 0, -1) + tetav)
            vd4 = 0.25 * (v + shift(v, 0, -1) + shift(v, 1, 0)
                          + shift(v, 1, -1))
            du = (self.coriou[None] * vd4 * dts
                  - zfz_u * self.hx[None] * self.gzitakh[:, None, None]
                  - dtrdx * self.mu[None] * rom1u
                  * (pai - shift(pai, 0, -1)))
            u = u + du * self.m_u
            zfz_v = 0.25 * (shift(dwc, -1, 0) + dwc) + c.egrav * dts
            rom1v = 0.5 * c.cpd * (shift(tetav, -1, 0) + tetav)
            ud4 = 0.25 * (u + shift(u, 0, 1) + shift(u, -1, 0)
                          + shift(u, -1, 1))
            dv = (-self.coriov[None] * ud4 * dts
                  - zfz_v * self.hy[None] * self.gzitakh[:, None, None]
                  - dtrdx * self.mv[None] * rom1v
                  * (pai - shift(pai, -1, 0)))
            v = v + dv * self.m_v

        # complete generalized vertical velocity (:1040-1060)
        s_fin_int = (w[1:kz] + s[1:kz]) * self.fmzf[1:kz]
        s = torch.cat([torch.zeros_like(w[:1]), s_fin_int,
                       torch.zeros_like(w[:1])], dim=0)
        return u, v, w, pai, s

    # ------------------------------------------------------------------
    def _wafone(self, pp, u, v, s, dta):
        """One WAF advection pass (vertical→meridional→zonal) of pp
        (..., kz, iy, jx), mod_moloch.F90:1098-1361: the plain version
        of kernel K4."""
        return waf_advect_plain(pp, u * self.rmu[None], v * self.rmv[None],
                                s, self.fmz, self.fmzf, self.mx2, self.m_ci,
                                dta / self.dx, dta / self.dz)

    # staggering helpers (uvstagtox/xtouvstag, mod_moloch public)
    @with_topology
    def uvstag2x(self, u, v):
        ux = 0.5 * (u + shift(u, 0, 1))
        vx = 0.5 * (v + shift(v, 1, 0))
        return ux, vx

    @with_topology
    def x2uvstag(self, ux, vx):
        return _x2uvstag(ux, vx)

    def wstag2x(self, w):
        return 0.5 * (w[:-1] + w[1:])

    def x2wstag(self, wx, w_old):
        w_int = 0.5 * (wx[:-1] + wx[1:])
        return torch.cat([w_old[:1], w_int, w_old[-1:]], dim=0)

    @with_topology
    def couple_uvten(self, utenx, vtenx, cpl):
        """Cross-point physics wind tendencies → C-grid faces
        (tenxtouvten, Main/mpplib/mod_mppparam.F90:13524-13580): 4th-order
        interpolation in the face-normal direction, no p* factor
        (uncoupled prognostics), interior faces only."""
        u = 0.5625 * (utenx + shifte(utenx, 0, -1)) \
            - 0.0625 * (shifte(utenx, 0, 1) + shifte(utenx, 0, -2))
        v = 0.5625 * (vtenx + shifte(vtenx, -1, 0)) \
            - 0.0625 * (shifte(vtenx, 1, 0) + shifte(vtenx, -2, 0))
        return u * self.m_u, v * self.m_v

    # ------------------------------------------------------------------
    def mkslice(self, t, pai, qx, u, v, w):
        """Physics-ready fields (init_slice MOLOCH aliases,
        Main/mod_slice.F90:49-99 + the idynamic=3 branch :107-167): the
        hydrostatic core's ``atms`` contract with coupling factor 1."""
        kz = self.kz
        qv = torch.clamp(qx[0], min=c.minqq)
        qh = torch.clamp(qx[1:], min=0.0)
        qc = qh[0]
        qcond = level_sum(qh)
        tvirt = t * (1.0 + c.ep1 * qv - qcond)
        p = pai ** c.cpovr * c.stdp
        rho = p / (c.rgas * t)
        # surface pressure (mod_moloch.F90:374-381): extrapolate the
        # lowest-layer virtual temperature over the half-layer to z=0
        zz1 = -c.egrav * HZITA * bzita(0.5 * self.dz, self.b0) \
            * math.log(1.0 - 0.5 * self.dz / HZITA)
        zdgz = self.ht * (gzita(0.5 * self.dz, self.a0) - 1.0) + zz1
        ps = p[kz - 1] * torch.exp(zdgz / (c.rgas * tvirt[kz - 1]))
        # interface pressures (mkslice :109-116)
        pf_int = c.stdp * (0.5 * (pai[1:] + pai[:-1])) ** c.cpovr
        pf3 = torch.cat([torch.full((1,) + tuple(ps.shape), 100.0,
                                    dtype=self.dtype, device=ps.device),
                         pf_int, ps[None]], dim=0)
        qsb3 = pfwsat(t, p)
        rhb3 = torch.clamp(qv / qsb3, 0.01, 1.0)
        ux, vx = self.uvstag2x(u, v)
        dzq = self.zetaf[:-1] - self.zetaf[1:]
        return dict(
            ubd3=ux, vbd3=vx, ubx3=ux, vbx3=vx, tb3=t, qvb3=qv, qcb3=qc,
            qhb3=qh, tvb3=tvirt, pb3=p, pf3=pf3, ps2d=ps, rhob3=rho,
            qsb3=qsb3, rhb3=rhb3,
            za=self.zeta, zq=self.zetaf, dzq=dzq,
            cpl=torch.ones_like(ps), psb=ps * 1e-3,
            psa=ps * 1e-3, rpsb=torch.ones_like(ps),
            omega_pa=-0.5 * c.egrav * rho * (w[:kz] + w[1:]),
            qdot=torch.zeros_like(w), coszrs=torch.zeros_like(ps))

    def decoupled(self, s: MolochState) -> Dict[str, torch.Tensor]:
        """Physical-unit prognostics (already uncoupled), the face winds
        at the cross points."""
        ux, vx = self.uvstag2x(s.u, s.v)
        atms = self.mkslice(s.t, s.pai, s.qx, s.u, s.v, s.w)
        return dict(ps=atms["ps2d"] / 100.0,                    # hPa
                    t=s.t, qv=s.qx[0], qc=s.qx[1], u=ux, v=vx, w=s.w)

    def _condtq(self, t, qx, p, tten, qxten, cldfra, dt):
        """SUBEX saturation adjustment, MOLOCH branch (condtq,
        Main/mod_micro_interface.F90:395-493 idynamic==3 path):
        condensation/evaporation increments, uncoupled."""
        qv = torch.clamp(qx[0], min=c.minqq)
        t_p1 = torch.clamp(t + dt * tten, min=10.0)
        qv_p1 = torch.clamp(qx[0] + dt * qxten[0], min=c.minqq)
        qc_p1 = torch.clamp(qx[1] + dt * qxten[1], min=0.0)
        qvs = pfwsat(t_p1, p)
        wwlh = wlh(t_p1)
        r1 = 1.0 / (1.0 + wwlh * wwlh * qvs
                    / (c.rwat * c.cpd * t_p1 ** 2))
        rhc = torch.clamp(qv_p1 / qvs, 0.0, 1.0)
        rh = torch.clamp(qv / pfwsat(torch.clamp(t, min=10.0), p),
                         self.rhmin, self.rhmax)
        rh0adj = 1.0 - (1.0 - rh) / torch.clamp((1.0 - cldfra) ** 2,
                                                min=1e-10)
        rh0adj = torch.clamp(rh0adj, 0.0, 0.99999)
        qvc_cld = torch.clamp(pfwsat(torch.clamp(t, min=10.0), p)
                              + dt * qxten[0], min=0.0)
        fccc = 1.0 - torch.sqrt(torch.clamp(
            (1.0 - rhc) / torch.clamp(1.0 - rh0adj, min=1e-10), min=0.0))
        fccc = torch.clamp(fccc, 0.0, 1.0)
        dqv = torch.where((rhc < rh0adj) | (rhc > 0.99999),
                          self.conf * (qv_p1 - qvs),
                          self.conf * fccc * (qvc_cld - qvs))
        tmp1 = r1 * dqv
        exces = qc_p1 + tmp1
        tmp2 = torch.where(exces >= 0.0, tmp1 / dt, -qc_p1 / dt)
        tmp2 = torch.where(torch.abs(tmp2) > c.dlowval, tmp2, 0.0) \
            * self.m_ci
        return tmp2 * wwlh * c.rcpd, -tmp2, tmp2

    # ------------------------------------------------------------------
    @with_topology
    def step(self, st: MolochState, bdy=None, xt=0.0, dt=None,
             flags=None, coszrs=None, solar=None
             ) -> Tuple[MolochState, Dict[str, torch.Tensor]]:
        """One MOLOCH model step (moloch, mod_moloch.F90:224-480):
        acoustic/advection substeps → decouple → mkslice → physics
        (physical_parametrizations :1386) → boundary nudge + raydamp →
        every-step filters (filtuv/filtt/filtq :571-707).

        ``dt`` is accepted for signature uniformity with the hydrostatic
        core; MOLOCH is forward in time and always steps cfg dtsec."""
        kz = self.kz
        dtsec = self.dtsec
        dtstepa = dtsec / self.nadv
        dtsound = dtstepa / self.nsound
        if isinstance(bdy, dict):
            bdy = MolochBdy(**bdy)

        u, v, w = st.u, st.v, st.w
        pai, t = st.pai, st.t
        qx = st.qx
        qv = torch.clamp(qx[0], min=c.minqq)
        qcond = level_sum(torch.clamp(qx[1:], min=0.0))
        p = pai ** c.cpovr * c.stdp
        qsat = pfwsat(t, p)
        tvirt = t * (1.0 + c.ep1 * qv - qcond)
        tetav = tvirt / pai
        chi = st.chi_b

        for _ in range(self.nadv):
            u, v, w, pai, s = self._sound(u, v, w, pai, tetav, qv, qsat,
                                          dtsound)
            # advection of the whole field stack {θv, π, ux, vx, wx, qx,
            # the chemistry tracers} by one K4 launch (advection,
            # :1042-1095): nf = 5 + nqx + ntr
            ux, vx = self.uvstag2x(u, v)
            wx = self.wstag2x(w)
            fields = torch.cat([tetav[None], pai[None], ux[None], vx[None],
                                wx[None], qx] + ([chi] if self.ntr else []),
                               dim=0)
            args = (fields, u * self.rmu[None], v * self.rmv[None], s,
                    self.fmz, self.fmzf, self.mx2, self.m_ci,
                    dtstepa / self.dx, dtstepa / self.dz)
            adv = waf_advect(*args) if self.mesh is None \
                else waf_advect_sharded(self.mesh, *args)
            tetav, pai, ux, vx, wx = (adv[0], adv[1], adv[2], adv[3],
                                      adv[4])
            qx = adv[5:5 + self.nqx]
            if self.ntr:
                chi = torch.clamp(adv[5 + self.nqx:], min=0.0)
            u, v = self.x2uvstag(ux, vx)
            w = self.x2wstag(wx, w)

        # de-couple: T from θv·π (:322-350)
        qv = torch.clamp(qx[0], min=c.minqq)
        qh = torch.clamp(qx[1:], min=0.0)
        qx = torch.cat([qv[None], qh])
        qcond = level_sum(qh)
        tvirt = tetav * pai
        t = tvirt / (1.0 + c.ep1 * qv - qcond)

        # -- physics (physical_parametrizations, :1386)
        sfupd: Dict[str, torch.Tensor] = {}
        heatrt = st.heatrt
        if self.physics is not None and flags is not None:
            atms = self.mkslice(t, pai, qx, u, v, w)
            if coszrs is not None:
                atms["coszrs"] = coszrs
            if solar is not None:
                atms["eccf"], atms["solcon"] = solar[0], solar[1]
                if len(solar) > 2:
                    atms["mpos"] = solar[2]
            s_now = st._replace(u=u, v=v, w=w, pai=pai, t=t, qx=qx)
            z3 = torch.zeros_like(t)
            (tphy, qvphy, qhphy, uphy, vphy, cldfra, heatrt,
             sfupd) = self.physics(
                 self, atms, s_now, bdy, flags, dtsec,
                 dyn=dict(tdyn=z3, qvdyn=z3, qvhadv=z3, qv_vadv=z3))
            # heating rate added uncoupled every step (:1489-1492)
            tphy = tphy + heatrt * self.m_ci
            if self.cfg.physics.ipptls == 1:
                dtc, dqv, dqc = self._condtq(
                    t, qx, atms["pb3"], tphy,
                    torch.stack([qvphy, qhphy[0]]), cldfra, dtsec)
                tphy = tphy + dtc
                qvphy = qvphy + dqv
                qhphy = qhphy.clone()       # qhphy.at[0].add(dqc)
                qhphy[0] = qhphy[0] + dqc
            # the chemistry tendencies (formed from the state before this
            # step's advection, as in the JAX package)
            chiphy = sfupd.pop("_chiten", None)
            if self.ntr and chiphy is not None:
                chi = torch.clamp(chi + dtsec * chiphy
                                  * self.m_ci[None, None], min=0.0)
            # update status (:1546-1568): forward-Euler apply, floors
            t = t + dtsec * tphy * self.m_ci
            qv = torch.clamp(qv + dtsec * qvphy * self.m_ci, min=c.minqq)
            qh = torch.clamp(qh + dtsec * qhphy * self.m_ci, min=0.0)
            qx = torch.cat([qv[None], qh])
            u = u + dtsec * uphy
            v = v + dtsec * vphy

        # -- boundary relaxation (moloch boundary, :485-548)
        if bdy is not None:
            xtd = xt + dtsec
            pai = pai + self._nudge(bdy.pai0 + xtd * bdy.pait - pai)
            t = t + self._nudge(bdy.t0 + xtd * bdy.tt - t)
            qv = torch.clamp(
                qv + self._nudge(bdy.qv0 + xtd * bdy.qvt - qv), min=c.minqq)
            u = u + self._nudge(bdy.u0 + xtd * bdy.ut - u)
            v = v + self._nudge(bdy.v0 + xtd * bdy.vt - v)
            qx = torch.cat([qv[None], qx[1:]])     # qx.at[0].set(qv)
            if self.ntr:
                # chemistry lateral boundary: relaxation toward clean
                # inflow air (mod_che_bdyco nudge on chemt)
                chi = torch.clamp(chi + self._nudge(-chi), min=0.0)
            # upper Rayleigh damping toward the boundary values
            # (moraydamp, mod_moloch.F90:420-425)
            if self.ifrayd == 1:
                u = u + dtsec * self.raytau_u \
                    * (bdy.u0 + xtd * bdy.ut - u) * self.m_u
                v = v + dtsec * self.raytau_v \
                    * (bdy.v0 + xtd * bdy.vt - v) * self.m_v
                t = t + dtsec * self.raytau \
                    * (bdy.t0 + xtd * bdy.tt - t) * self.m_ci
                pai = pai + dtsec * self.raytau \
                    * (bdy.pai0 + xtd * bdy.pait - pai) * self.m_ci

        # -- every-step 4-point smoothers (filtuv/filtt/filtq)
        lap4 = lambda a: 0.125 * (shift(a, 0, -1) + shift(a, 0, 1)
                                  + shift(a, -1, 0) + shift(a, 1, 0)) \
            - 0.5 * a
        u = u + self.nuwind * lap4(u) * self.m_u
        v = v + self.nuwind * lap4(v) * self.m_v
        t = t + self.nupait * lap4(t) * self.m_ci
        qv2 = qx[0] + self.nuqx * lap4(qx[0]) * self.m_ci
        qh2 = qx[1:] + 0.5 * self.nuqx * lap4(qx[1:]) * self.m_ci[None]
        qx = torch.cat([qv2[None], qh2])
        if self.ntr:
            chi = torch.clamp(
                chi + 0.5 * self.nuqx * lap4(chi) * self.m_ci[None], min=0.0)
            sfupd = dict(sfupd, chi_b=chi)

        ns = st._replace(u=u, v=v, w=w, pai=pai, t=t, qx=qx,
                         heatrt=heatrt, **sfupd)
        p = pai ** c.cpovr * c.stdp
        diags = dict(
            wmax=torch.max(torch.abs(w)),
            pmin=torch.min(torch.where(self.m_ci > 0.5, p[kz - 1], 1e9)),
            pmax=torch.max(torch.where(self.m_ci > 0.5, p[kz - 1], 0.0)),
        )
        if self.mesh is not None:       # over the whole domain
            red = self.mesh.all_reduce(torch.stack(
                [diags["wmax"], -diags["pmin"], diags["pmax"]]))
            diags = dict(wmax=red[0], pmin=-red[1], pmax=red[2])
        return ns, diags

    def _nudge(self, diff):
        """Relaxation increment (nudge applied directly to the fields in
        MOLOCH; coefficients pre-scaled ×nadv·nsound)."""
        lap = (shift(diff, 0, -1) + shift(diff, 0, 1)
               + shift(diff, -1, 0) + shift(diff, 1, 0) - 4.0 * diff)
        return (self.nfc * diff - self.ngc * lap) * self.m_ci \
            * (self.dtsec / (self.nadv * self.nsound))
