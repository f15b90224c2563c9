"""The sigma-p dynamical cores, torch twin of
``regcm_tpu/dynamics/hydrostatic.py``: the hydrostatic core (idynamic=1,
``HydroCore.step``) and the MM5 non-hydrostatic core (idynamic=2,
``HydroCore.step_nh``).

The reference's leapfrog split-explicit hydrostatic core
(``Main/mod_tendency.F90:212`` ``tend`` and its phases, with
``mod_advection``, ``mod_diffusion``, ``mod_timefilter``, ``mod_split``
and the ``mod_bdycod`` relaxation), and its NH branches with the
semi-implicit acoustic solver of ``dynamics/sound.py`` in place of the
split-explicit modes. Both steps run eagerly on the tensors' device;
prognostics are p*-coupled on the Arakawa-B grid.

The dynamics options of the JAX package are ported: diffusion
``idiffu`` 1-3, ``ipgf`` 0/1, theta advection ``ithadv=1``, the
semi-Lagrangian moisture advection ``isladvec=1`` (``sladvection.py``),
the lateral boundary schemes ``iboudy`` 0-5 (3 and 4 with the
inflow/outflow qv edges, 4 the sponge) and the NH core's upper Rayleigh
damping (``ifrayd``), and the UW TCM's prognostic TKE (``ibltyp=2``:
advected, diffused and forecast beside the physics' tendency).
Chemistry is refused at construction.

With a ``DomainMesh`` (``HydroCore(..., mesh=...)``) the core steps one
rank's (ly, lx) block of the domain: the 2-D constants are built on the
whole grid and sliced, every horizontal stencil reads across block edges
through the halo exchange of ``stencil.shift``/``shifte``, the writes
that belong to the domain's edges (``fix_cross_pad``, ``_flow_edges``)
happen on the ranks that hold those edges, and the diagnostics are
reduced over the ranks. The periodic topologies (the band, i_band=1,
periodic in x; the CRM, i_crm=1, in x and y) decompose as the others,
the first and last ranks of a periodic axis exchanging across the seam;
the semi-Lagrangian advection is not decomposed.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config.params import RegCMConfig
from ..core.grid import ModelGrid
from ..core.state import (BdyState, HydroState, StepFlags, IQV, IQC,
                          species_count)
from ..device import resolve_device
from ..utils import constants as c
from ..utils.thermo import pfwsat, wlh
from . import stencil
from .sladvection import sl_weights, slhadv
from .sound import NHBaseState, make_base_state, sound, \
    upper_radiation_tables
from .stencil import (shift, shifte, cross2dot, dot2cross, halo_pad,
                      with_topology)
from .vmodes import make_split_coeffs


def fix_cross_pad(a):
    """Re-replicate the dead padding row/col of a cross-grid field
    (periodic axes have none). Under a mesh only the ranks that hold the
    domain's last row or column write, into their block's last one."""
    m = stencil.mesh()
    last_y = not stencil.periodic_y() and (m is None or m.py == m.ny - 1)
    last_x = not stencil.periodic_x() and (m is None or m.px == m.nx - 1)
    if not (last_y or last_x):
        return a
    a = a.clone()
    if last_y:
        a[..., -1, :] = a[..., -2, :]
    if last_x:
        a[..., :, -1] = a[..., :, -2]
    return a


# the perturbation PGF's reference profile (ipgf=1, mod_tendency.F90:1886)
T00PG, P00PG = 287.0, 101.325
PGFAA1 = 6.5e-3 * c.rgas * c.regrav


def levels_dot(mat, f):
    """out[n, y, x] = Σ_k mat[n, k]·f[k, y, x], added one level at a time
    in level order: every column gets the same operations whatever the
    size of the block it lies in (the order of summation of a GEMM or of
    a reduction over levels may change with the number of columns, which
    would cost a decomposed run its bit-identity to one rank)."""
    out = mat[:, 0, None, None] * f[0]
    for k in range(1, mat.shape[1]):
        out = out + mat[:, k, None, None] * f[k]
    return out


def level_sum(f):
    """Σ_k f[k, y, x] in level order (see ``levels_dot``)."""
    out = f[0]
    for k in range(1, f.shape[0]):
        out = out + f[k]
    return out


def cpmf(qv):
    """Moist heat capacity (Share/cpmf.inc): cpd·(1+0.80 qv)."""
    return c.cpd * (1.0 + 0.80 * qv)


def _refuse_options(cfg: RegCMConfig, mesh):
    """Raise for every sigma-p core option this port leaves out."""
    p = cfg.physics
    if int(getattr(p, "idiffu", 1)) not in (1, 2, 3):
        raise ValueError(
            f"physicsparam idiffu={p.idiffu} is not a diffusion scheme (1 "
            "split-order, 2 9-point 4th-order, 3 6th-order monotonic)")
    if int(p.iboudy) not in range(6):
        raise ValueError(f"physicsparam iboudy={p.iboudy} is not a "
                         "lateral boundary scheme (0-5)")
    refused = [
        (cfg.core.idynamic not in (1, 2),
         f"coreparam idynamic={cfg.core.idynamic} in HydroCore (1: "
         "hydrostatic, 2: MM5 non-hydrostatic; MOLOCH is MolochCore)"),
        (int(p.ichem) != 0, "chemistry (ichem=1, ROADMAP.md item 13)"),
        (mesh is not None and cfg.core.idynamic == 1
         and int(p.isladvec) == 1,
         "a decomposed run (mesh=) of the semi-Lagrangian advection "
         "(isladvec=1) yet (ROADMAP.md Queue 1, item 10e)"),
    ]
    for bad, what in refused:
        if bad:
            raise NotImplementedError(
                f"regcm_tpu_torch does not port {what}")


class HydroCore:
    """Holds the grid constants as tensors; ``step`` is one model step."""

    def __init__(self, grid: ModelGrid, cfg: RegCMConfig,
                 device="cuda", dtype=torch.float64,
                 physics: Optional[Callable] = None, mesh=None):
        _refuse_options(cfg, mesh)
        device = resolve_device(device)
        self.grid = grid
        self.cfg = cfg
        self.device = device
        self.dtype = dtype
        self.periodic_x = bool(cfg.geo.i_band or cfg.geo.i_crm)
        self.periodic_y = bool(cfg.geo.i_crm)
        self.mesh = mesh
        # vertical profiles; (..., iy, jx) fields built on the whole grid
        # and cut to the rank's block
        f1 = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,
                                       device=device)
        f = f1 if mesh is None \
            else (lambda x: f1(mesh.local(np.asarray(x))))
        g = grid
        kz = g.kz
        self.kz = kz
        self.ptop = float(g.ptop)
        self.dx = float(g.ds)
        self.dtsec = cfg.dtsec
        # upstream-weighted scalar advection + local-extrema guard, the
        # reference's forced defaults for idynamic<3
        # (mod_params.F90:645-661)
        ex = cfg.physics.extras
        self.upstream_mode = bool(ex.get("upstream_mode", True))
        self.stability_enhance = bool(ex.get("stability_enhance", True))
        self.t_extrema = float(ex.get("t_extrema", 5.0))
        self.q_rel_extrema = float(ex.get("q_rel_extrema", 0.20))
        uoffc = float(ex.get("uoffc", 0.25))
        self.ul_adv = uoffc * 0.5 * cfg.dtsec / self.dx
        p = cfg.physics
        self.idiffu = int(getattr(p, "idiffu", 1))
        # idiffu=3's constant coefficient (initialize_diffusion,
        # Main/mod_diffusion.F90:154: 0.12·0.015625/(2·dt))
        self.diff6 = 0.12 * 0.015625 / (2.0 * cfg.dtsec)
        self.ipgf = int(p.ipgf)
        # temperature advection form (0: T flux advection and omega
        # heating, 1: theta advection)
        self.ithadv = int(cfg.dyn.extras.get("ithadv", 0))
        # semi-Lagrangian moisture advection (Main/mod_sladvection.F90)
        self.isladvec = int(p.isladvec)
        self.iqmsl = int(p.iqmsl)
        self.iboudy = int(p.iboudy)
        self.idynamic = cfg.core.idynamic
        self.nqx = species_count(p.ipptls)
        # the UW TCM's prognostic TKE (ibltyp=2,
        # mod_tendency.F90:518-544,1414-1424,1544-1547)
        self.ibltyp = int(p.ibltyp)
        self.nuk = float(ex.get("nuk", 5.0))
        self.tkemin = 1.0e-3         # uwtkemin (mod_pbl_uwtcm.F90:86)

        # 2-D constants
        self.msfx = f(g.msfx)
        self.msfd = f(g.msfd)
        self.coriol = f(g.coriol)
        self.ht = f(g.ht)
        self.xmapf = 1.0 / (self.msfx ** 2 * 4.0 * self.dx)
        self.dmapf = 1.0 / (self.msfd ** 2 * 16.0 * self.dx)
        self.m_c = f(g.m_cross)
        self.m_ci = f(g.m_cross_int)
        self.m_ci2 = f(g.m_cross_int2)
        self.m_di = f(g.m_dot_int)
        self.m_di2 = f(g.m_dot_int2)
        self.e_call = f(np.minimum(sum(g.e_cross.values()), 1.0))
        self.e_dall = f(np.minimum(sum(g.e_dot.values()), 1.0))
        # two outer dot rings (decouple boundary wind override)
        iy, jx = g.iy, g.jx
        d2 = np.zeros((iy, jx))
        if not self.periodic_y:
            d2[:2, :] = 1.0
            d2[-2:, :] = 1.0
        if not self.periodic_x:
            d2[:, :2] = 1.0
            d2[:, -2:] = 1.0
        self.e_d2 = f(d2)

        # vertical
        self.twt1 = f1(g.twt[:, 0])[:, None, None]
        self.twt2 = f1(g.twt[:, 1])[:, None, None]
        self.qcon = f1(g.qcon)[:, None, None]
        self.hsig3 = f1(g.hsigma)[:, None, None]
        self.dsig3 = f1(g.dsigma)[:, None, None]
        self.sig3 = f1(g.sigma)[:, None, None]

        # nudging coefficient maps
        self.nfc = f(g.nudge_fc)
        self.ngc = f(g.nudge_gc)
        self.nfd = f(g.nudge_fd)
        self.ngd = f(g.nudge_gd)
        self.hgfact = f(g.hgfact)
        self.xkhmax = float(g.extras["xkhmax"])
        self.dydc = float(g.extras["dydc"])

        # split-explicit coefficients (shared numpy vmodes)
        nsplit = cfg.hydro.nsplit
        self.nsplit = nsplit
        sc = make_split_coeffs(g.sigma, self.ptop, nsplit, cfg.dtsec)
        self.sp_aam = [int(a) for a in sc.aam]
        self.sp_dtau = [float(d) for d in sc.dtau]
        self.sp_hbar = [float(h) for h in sc.hbar]
        self.sp_an = f1(sc.an)
        self.sp_am = f1(sc.am)
        self.sp_zmatx = f1(sc.zmatx)
        self.sp_zmatxr = f1(sc.zmatxr)
        self.sp_tau = f1(sc.tau_n)
        sigmah = sc.sigmah
        pdlog = np.log(sigmah * sc.pd + self.ptop)
        ceps = sigmah / (sigmah * sc.pd + self.ptop)
        self.sp_hconst = f1(sc.varpa1_n @ pdlog)
        self.sp_hslope = f1(sc.varpa1_n @ ceps)
        self.sp_pd = float(sc.pd)

        # physics hook: physics(core, atms, state, bdy, flags, dt, dyn)
        self.physics = physics
        self.grid_lndocn = f(g.lndocn)
        # prescribed SST (standard-atmosphere surface T)
        self.sst = torch.full_like(self.msfx, 288.0)

        # SUBEX parameters (subexparam, Main/mod_params.F90)
        sx = cfg.subex
        land = g.lndocn > 0.5
        self.qck1 = f(np.where(land, sx.qck1land, sx.qck1oce))
        self.cgul = f(np.where(land, sx.gulland, sx.guloce))
        self.cevap = f(np.where(land, sx.cevaplnd, sx.cevapoce))
        self.caccr = f(np.where(land, sx.caccrlnd, sx.caccroce))
        self.rh0 = f(np.where(land, sx.rh0land, sx.rh0oce))
        self.rhmax = sx.rhmax
        self.rhmin = 0.01
        self.conf = sx.conf
        self.gnu1 = cfg.dyn.gnu1
        self.gnu2 = cfg.dyn.gnu2
        if self.iboudy == 4:      # sponge weights (mod_bdycod.F90:237)
            self.spwc = f(g.extras["sponge_wc"])
            self.spwd = f(g.extras["sponge_wd"])
        if self.idynamic == 2:
            # the NH reference atmosphere, built on the whole grid
            self.base = NHBaseState(*map(f, make_base_state(
                g, self.ptop, logp_lrate=cfg.nonhydro.logp_lrate)))
            # upper-level Rayleigh damping toward the boundary values
            # (ifrayd/rayndamp/rayalpha0/rayhd; Main/mod_bdycod.F90:5115)
            dx = cfg.dyn.extras
            self.ifrayd = int(dx.get("ifrayd", 1))
            self.rayndamp = int(dx.get("rayndamp", 5))
            self.rayalpha0 = float(dx.get("rayalpha0", 3.0e-4))
            self.rayhd = float(dx.get("rayhd", 1.0e4))
            # the radiative top's tables and its count of interior
            # points, from the whole grid
            geom, xkleff = upper_radiation_tables(g.msfx, self.dx)
            self.upr_geom = f1(geom)
            self.upr_xkleff = f1(xkleff)
            self.upr_npts = max(float(np.sum(g.m_cross_int)), 1.0)

    # ------------------------------------------------------------------
    # phases (pure functions of tensors (kz, iy, jx) or (iy, jx))
    # ------------------------------------------------------------------
    def couple_uvten(self, utenx, vtenx, cpl):
        """Couple cross-grid wind tendencies onto dot points ×p*_dot
        (uvcross2dot, cu_interface :375-381)."""
        psd = cross2dot(cpl)
        return (cross2dot(utenx) * psd[None] * self.m_di,
                cross2dot(vtenx) * psd[None] * self.m_di)

    def _advection_uv(self, ua, va, ud, vd, uc, vc, svv):
        """hadvuv + vadvuv (Main/mod_advection.F90:124-305)."""
        ucmona = shift(ua, 1, 0) + 2.0 * ua + shift(ua, -1, 0)
        ucmonb = shift(ua, 1, 1) + 2.0 * shift(ua, 0, 1) + shift(ua, -1, 1)
        ucmonc = shift(ua, 1, -1) + 2.0 * shift(ua, 0, -1) + shift(ua, -1, -1)
        vcmona = shift(va, 0, 1) + 2.0 * va + shift(va, 0, -1)
        vcmonb = shift(va, 1, 1) + 2.0 * shift(va, 1, 0) + shift(va, 1, -1)
        vcmonc = shift(va, -1, 1) + 2.0 * shift(va, -1, 0) + shift(va, -1, -1)
        ucb = ucmona + ucmonb
        ucc_ = ucmonc + ucmona
        vcb = vcmona + vcmonb
        vcc_ = vcmonc + vcmona
        uten = -self.dmapf * (
            (shift(ud, 0, 1) + ud) * ucb - (ud + shift(ud, 0, -1)) * ucc_
            + (shift(ud, 1, 0) + ud) * vcb - (ud + shift(ud, -1, 0)) * vcc_)
        vten = -self.dmapf * (
            (shift(vd, 0, 1) + vd) * ucb - (vd + shift(vd, 0, -1)) * ucc_
            + (shift(vd, 1, 0) + vd) * vcb - (vd + shift(vd, -1, 0)) * vcc_)
        qq = 0.25 * (svv + shifte(svv, 0, -1) + shifte(svv, -1, 0)
                     + shifte(svv, -1, -1))
        uf = qq[1:self.kz] * (self.twt1[1:] * uc[1:]
                              + self.twt2[1:] * uc[:-1])
        vf = qq[1:self.kz] * (self.twt1[1:] * vc[1:]
                              + self.twt2[1:] * vc[:-1])
        zt = torch.zeros_like(uc[:1])
        ufp = torch.cat([zt, uf, zt], dim=0)
        vfp = torch.cat([zt, vf, zt], dim=0)
        uten = uten + (ufp[:-1] - ufp[1:]) / self.dsig3
        vten = vten + (vfp[:-1] - vfp[1:]) / self.dsig3
        return uten * self.m_di, vten * self.m_di

    def _hadv_scalar(self, fdec, uavg1, uavg2, vavg1, vavg2, ps=None):
        """Flux-form horizontal advection of a decoupled cross scalar
        (hadvt/hadv3d, Main/mod_advection.F90:311-480), upstream-weighted
        when ``upstream_mode``."""
        fm = shift(fdec, 0, -1)
        fp = shift(fdec, 0, 1)
        gm = shift(fdec, -1, 0)
        gp = shift(fdec, 1, 0)
        if self.upstream_mode and ps is not None:
            f1 = 0.5 * self.ul_adv * (uavg2 + uavg1) / ps[None]
            f2 = 0.5 * self.ul_adv * (vavg2 + vavg1) / ps[None]
            fx1 = (1.0 + f1) * fm + (1.0 - f1) * fdec
            fx2 = (1.0 + f1) * fdec + (1.0 - f1) * fp
            fy1 = (1.0 + f2) * gm + (1.0 - f2) * fdec
            fy2 = (1.0 + f2) * fdec + (1.0 - f2) * gp
        else:
            fx1 = fm + fdec
            fx2 = fdec + fp
            fy1 = gm + fdec
            fy2 = fdec + gp
        return -self.xmapf * (uavg2 * fx2 - uavg1 * fx1
                              + vavg2 * fy2 - vavg1 * fy1) * self.m_ci

    def _stability_guard(self, fg, fcoup, ps, mode):
        """Local-extrema instability correction (stability_enhance,
        Main/mod_advection.F90:354-387 and :565-597)."""
        if not self.stability_enhance:
            return fg
        interior = self.m_ci > 0.5
        for dy, dx in ((0, 1), (1, 0)):
            fp = shift(fcoup, dy, dx)
            fm = shift(fcoup, -dy, -dx)
            sec = torch.abs(fp + fm - 2.0 * fcoup)
            if mode == "abs":
                exceed = sec / ps[None] > self.t_extrema
            else:
                exceed = sec / torch.clamp(fcoup, min=1e-30) \
                    > self.q_rel_extrema
            exceed = exceed & interior
            locmax = (fcoup > fp) & (fcoup > fm)
            locmin = (fcoup < fp) & (fcoup < fm)
            fg = torch.where(exceed & locmax, torch.clamp(fg, max=0.0), fg)
            fg = torch.where(exceed & locmin, torch.clamp(fg, min=0.0), fg)
        return fg

    def _tke_dyn(self, s, qdot, uavg1, uavg2, vavg1, vavg2, psa, xkcf):
        """UW TKE dynamics tendency (coupled, on the kz+1 interfaces):
        hadv ind=1 of the decoupled tke (mod_tendency.F90:1416), vadv
        ind=0 of tke·p* (:1421-1424) and the horizontal diffusion with
        the nuk coefficient (:1544-1547)."""
        kz = self.kz
        tk = s.tke_a                       # uncoupled, (kz+1, iy, jx)
        # hadv ind=1: the winds interpolated to the interior interfaces
        ua1_i = self.twt1[1:] * uavg1[1:] + self.twt2[1:] * uavg1[:-1]
        ua2_i = self.twt1[1:] * uavg2[1:] + self.twt2[1:] * uavg2[:-1]
        va1_i = self.twt1[1:] * vavg1[1:] + self.twt2[1:] * vavg1[:-1]
        va2_i = self.twt1[1:] * vavg2[1:] + self.twt2[1:] * vavg2[:-1]
        tk_i = tk[1:kz]
        fx1 = shift(tk_i, 0, -1) + tk_i
        fx2 = tk_i + shift(tk_i, 0, 1)
        fy1 = shift(tk_i, -1, 0) + tk_i
        fy2 = tk_i + shift(tk_i, 1, 0)
        th_ = -self.xmapf[None] * (ua2_i * fx2 - ua1_i * fx1
                                   + va2_i * fy2 - va1_i * fy1) \
            * self.m_ci
        # vadv ind=0 nk=kzp1 on the coupled tke·p* (half-level fluxes)
        tkps = tk * psa[None]
        fx0 = 0.5 * (qdot[:kz] + qdot[1:]) * (tkps[:kz] + tkps[1:])
        dds_i = 1.0 / (self.dsig3[1:] + self.dsig3[:-1])
        zt = torch.zeros_like(tk[:1])
        tked = torch.cat([zt, th_ + (fx0[:-1] - fx0[1:]) * dds_i, zt])
        # horizontal diffusion ×nuk on the decoupled b-level tke
        return tked + self.nuk * self._diffu_cross(s.tke_b, xkcf)

    def _tke_forecast(self, s, tkedyn, tkephy, rpsa, dt):
        """Forecast and Asselin filter of the UW TKE
        (mod_tendency.F90:528-543)."""
        tketen = tkedyn * rpsa[None] + tkephy
        tkec = torch.clamp(s.tke_b + dt * tketen, min=self.tkemin)
        beta = 0.53
        dtk = self.gnu2 * (tkec + s.tke_b - 2.0 * s.tke_a)
        mci = self.m_ci[None] > 0.5
        tke_b_n = torch.where(
            mci, torch.clamp(s.tke_a + beta * dtk, min=self.tkemin),
            s.tke_b)
        tke_a_n = torch.where(
            mci, torch.clamp(tkec + (beta - 1.0) * dtk, min=self.tkemin),
            s.tke_a)
        return tke_a_n, tke_b_n

    def _kuo_defer(self):
        """Whether the physics suite's Kuo scheme takes the qv vertical
        advection term (``PhysicsSuite.kuo_defer``)."""
        return bool(getattr(self.physics, "kuo_defer", False))

    def _tke_update(self, sfupd, s, qdot, uavg, psa, rpsa, xkcf, dt):
        """The UW TCM's prognostic TKE (ibltyp=2): advected, diffused and
        forecast, with the physics tendency ``_tkephy`` the suite hands
        back; a no-op for the other PBL schemes."""
        tkephy = sfupd.pop("_tkephy", None)
        if self.ibltyp != 2:
            return sfupd
        tkedyn = self._tke_dyn(s, qdot, *uavg, psa, xkcf)
        tke_a_n, tke_b_n = self._tke_forecast(
            s, tkedyn, tkephy if tkephy is not None else 0.0, rpsa, dt)
        return dict(sfupd, tke_a=tke_a_n, tke_b=tke_b_n)

    def _vadv_flux(self, fint):
        """Vertical flux divergence of interface fluxes at the interior
        full levels (axis -3; leading species axes broadcast)."""
        zt = torch.zeros_like(fint[..., :1, :, :])
        fp = torch.cat([zt, fint, zt], dim=-3)
        return (fp[..., :-1, :, :] - fp[..., 1:, :, :]) / self.dsig3

    @with_topology
    def step(self, s: HydroState, bdy: BdyState, xt: float, dt: float,
             flags: StepFlags = StepFlags(), coszrs=None, solar=None
             ) -> Tuple[HydroState, Dict[str, torch.Tensor]]:
        """One leapfrog step (tend, Main/mod_tendency.F90:212-560).

        xt: seconds since the boundary b0 time; dt: leapfrog step
        (dtsec on the first step, 2·dtsec after)."""
        kz = self.kz
        ptop = self.ptop

        # -- surface_pressures (mod_tendency.F90:815-850)
        psa = s.ps_a
        psb = s.ps_b
        rpsa = 1.0 / psa
        rpsb = 1.0 / psb
        psdota = cross2dot(psa)
        psdotb = cross2dot(psb)
        rpsda = 1.0 / psdota

        # -- decouple (mod_tendency.F90:852-1110)
        uc = s.u_a
        vc = s.v_a
        umc = uc * self.msfd
        vmc = vc * self.msfd
        ud = uc * rpsda
        vd = vc * rpsda
        ub_bdy = (bdy.u0 + xt * bdy.ut) * rpsda
        vb_bdy = (bdy.v0 + xt * bdy.vt) * rpsda
        ud = torch.where(self.e_d2 > 0.5, ub_bdy, ud)
        vd = torch.where(self.e_d2 > 0.5, vb_bdy, vd)
        tdec = s.t_a * rpsa
        qvdec = torch.clamp(s.qx_a[IQV] * rpsa, min=c.minqq)
        qhdec = torch.clamp(s.qx_a[1:] * rpsa, min=0.0)
        qcdec = qhdec[0]
        tv = tdec * (1.0 + c.ep1 * qvdec)

        # -- compute_omega (mod_tendency.F90:1118-1225)
        rmsfx2 = 1.0 / (2.0 * self.dx * self.msfx ** 2)
        div = ((shift(umc, 1, 1) + shift(umc, 0, 1)
                - shift(umc, 1, 0) - umc)
               + (shift(vmc, 1, 1) + shift(vmc, 1, 0)
                  - shift(vmc, 0, 1) - vmc)) * rmsfx2
        div = div * self.m_c
        pten = -level_sum(div * self.dsig3)
        inc = -(pten[None] + div) * self.dsig3 * rpsa[None]
        qdot = torch.cat([torch.zeros_like(inc[:1]),
                          torch.cumsum(inc, dim=0)], dim=0)
        qdot[kz] = 0.0       # qdot is freshly built: in-place is safe
        udsum = ud + shift(ud, 0, 1) + shift(ud, 1, 1) + shift(ud, 1, 0)
        vdsum = vd + shift(vd, 0, 1) + shift(vd, 1, 1) + shift(vd, 1, 0)
        dpsx = shift(psa, 0, 1) - shift(psa, 0, -1)
        dpsy = shift(psa, 1, 0) - shift(psa, -1, 0)
        omega = (0.5 * (qdot[1:] + qdot[:-1]) * psa[None]
                 + self.hsig3 * (pten[None]
                                 + (udsum * dpsx[None] + vdsum * dpsy[None])
                                 / (8.0 * self.dx * self.msfx)[None]))
        omega = omega * self.m_ci

        # -- mkslice (Main/mod_slice.F90:102-340)
        ubd3 = s.u_b / psdotb
        vbd3 = s.v_b / psdotb
        ubx3 = dot2cross(ubd3)
        vbx3 = dot2cross(vbd3)
        tb3 = s.t_b * rpsb
        qvb3 = torch.clamp(s.qx_b[IQV] * rpsb, min=c.minqq)
        qhb3 = torch.clamp(s.qx_b[1:] * rpsb, min=0.0)
        qcb3 = qhb3[0]
        tvb3 = tb3 * (1.0 + c.ep1 * qvb3 - qcb3)
        pb3 = (self.hsig3 * psb[None] + ptop) * 1000.0
        pf3 = (self.sig3 * psb[None] + ptop) * 1000.0
        ps2d = (psb + ptop) * 1000.0
        rhob3 = pb3 / (c.rgas * tb3)
        qsb3 = pfwsat(tb3, pb3)
        rhb3 = torch.clamp(qvb3 / qsb3, self.rhmin, self.rhmax)
        cell = ptop * rpsb[None]
        dzq_fac = c.rovg * tvb3 * torch.log((self.sig3[1:] + cell)
                                            / (self.sig3[:-1] + cell))
        zq = torch.cat([torch.flip(torch.cumsum(torch.flip(dzq_fac, [0]),
                                                dim=0), [0]),
                        torch.zeros_like(dzq_fac[:1])], dim=0)
        za = 0.5 * (zq[:-1] + zq[1:])
        dzq = zq[:-1] - zq[1:]

        if coszrs is None:
            coszrs = torch.zeros_like(psb)
        atms = dict(ubd3=ubd3, vbd3=vbd3, ubx3=ubx3, vbx3=vbx3, tb3=tb3,
                    qvb3=qvb3, qcb3=qcb3, qhb3=qhb3, tvb3=tvb3, pb3=pb3,
                    pf3=pf3, ps2d=ps2d, rhob3=rhob3, qsb3=qsb3, rhb3=rhb3,
                    za=za, zq=zq, dzq=dzq, psb=psb, psa=psa,
                    omega_pa=omega * 1000.0, qdot=qdot, rpsb=rpsb,
                    coszrs=coszrs)
        if solar is not None:
            # per-day solar forcing: eccentricity factor, TSI, month
            atms["eccf"], atms["solcon"] = solar[0], solar[1]
            if len(solar) > 2:
                atms["mpos"] = solar[2]

        # -- new_pressure (mod_tendency.F90:1428-1460)
        if self.iboudy == 4:
            # sponge2d: blend toward the boundary tendency
            # (mod_bdycod.F90:2726)
            pten_n = self.spwc * pten + (1.0 - self.spwc) * bdy.pst
        else:
            ps_bdy_diff = (bdy.ps0 + (xt + dt) * bdy.pst) - psb
            pten_n = pten + self._nudge2d(ps_bdy_diff)
        psc = fix_cross_pad(psb + pten_n * dt)
        rpsc = 1.0 / psc

        # -- calc_coeff (Main/mod_diffusion.F90:148-255)
        xkc, xkd = self._calc_coeff(ubd3, vbd3, psb, psdotb)

        # -- advection (mod_tendency.F90:1270-1426)
        uavg1 = shift(umc, 1, 0) + umc
        uavg2 = shift(umc, 1, 1) + shift(umc, 0, 1)
        vavg1 = shift(vmc, 0, 1) + vmc
        vavg2 = shift(vmc, 1, 1) + shift(vmc, 1, 0)

        udyn, vdyn = self._advection_uv(umc, vmc, ud, vd, uc, vc, qdot)

        if self.ithadv == 1:
            # theta advection (ithadv=1, mod_tendency.F90:1352-1366)
            pr_a = (self.hsig3 * psa[None] + ptop) * 1000.0
            th = tdec * (c.stdp / pr_a) ** c.rovcp
            tha = th * psa[None]
            thten = self._hadv_scalar(th, uavg1, uavg2, vavg1, vavg2,
                                      ps=psa)
            thten = self._stability_guard(thten, tha, psa, "abs")
            fth = qdot[1:kz] * (self.twt1[1:] * tha[1:]
                                + self.twt2[1:] * tha[:-1])
            thten = thten + self._vadv_flux(fth)
        else:
            # plain T flux advection (ithadv=0) + vadv3d with
            # exner-weighted interface interpolation
            # (mod_advection.F90:730-790)
            tdyn0 = self._hadv_scalar(tdec, uavg1, uavg2, vavg1, vavg2,
                                      ps=psa)
            tdyn0 = self._stability_guard(tdyn0, tdec * psa[None], psa,
                                          "abs")
            pfs = (self.sig3 * psa[None] + ptop) * 1000.0
            phs = (self.hsig3 * psa[None] + ptop) * 1000.0
            ta = s.t_a
            fT = qdot[1:kz] * (
                self.twt1[1:] * ta[1:] * (pfs[1:kz] / phs[1:]) ** c.c287
                + self.twt2[1:] * ta[:-1] * (pfs[1:kz] / phs[:-1]) ** c.c287)
            tdyn0 = tdyn0 + self._vadv_flux(fT)
        # qv: hadv on decoupled (or the semi-Lagrangian form on the
        # coupled b level, mod_tendency.F90:1283,1361-1380) + vadv on
        # coupled
        if self.isladvec == 1:
            slw = sl_weights(ud, vd, self.msfx, self.dx, dt, *psa.shape)
            qvhadv = slhadv(s.qx_b[IQV], slw, dt,
                            qmsl=self.iqmsl == 1) * self.m_ci
        else:
            qvhadv = self._hadv_scalar(qvdec, uavg1, uavg2, vavg1, vavg2,
                                       ps=psa)
            qvhadv = self._stability_guard(qvhadv, qvdec, psa, "rel")
        qva = s.qx_a[IQV]
        ok = ((qva[1:] > c.minqq * psa[None])
              & (qva[:-1] > c.minqq * psa[None]))
        fgq = torch.where(ok, qva[1:] * (qva[:-1]
                                         / torch.clamp(qva[1:], min=1e-30))
                          ** self.qcon[1:], 0.0)
        qv_vadv = self._vadv_flux(qdot[1:kz] * fgq)
        # Kuo takes the qv vertical advection over (mod_tendency.F90:
        # 1371-1373): the core adds it only when no Kuo scheme runs
        qvten = qvhadv if self._kuo_defer() else qvhadv + qv_vadv
        # hydrometeors: hadv + vadv4d with the upstream sign guard
        if self.isladvec == 1:
            qhten = slhadv(s.qx_b[1:], slw, dt,
                           qmsl=self.iqmsl == 1) * self.m_ci
        else:
            qhten = self._hadv_scalar(qhdec, uavg1, uavg2, vavg1, vavg2,
                                      ps=psa)
            qhten = self._stability_guard(qhten, qhdec, psa, "rel")
        qha = s.qx_a[1:]
        fi = self.twt1[1:] * qha[:, 1:] + self.twt2[1:] * qha[:, :-1]
        thr = c.minqq * c.minqq * psa[None]
        okup = qha[:, :-1] > thr
        okdn = qha[:, 1:] > thr
        fqh = torch.where(qdot[1:kz] > 0.0,
                          torch.where(okup, qdot[1:kz] * fi, 0.0),
                          torch.where(okdn, qdot[1:kz] * fi, 0.0))
        qhten = qhten + self._vadv_flux(fqh)

        # -- Coriolis (mod_tendency.F90:1822-1848)
        udyn = udyn + self.coriol[None] * vc * self.m_di
        vdyn = vdyn - self.coriol[None] * uc * self.m_di

        if self.ithadv == 1:
            # -- adiabatic theta term (mod_tendency.F90:1597-1604)
            thten = thten + th * div
            tdyn = s.t_a * thten / torch.where(tha == 0.0, 1.0, tha) \
                * self.m_ci
        else:
            # -- omega heating (mod_tendency.F90:1568-1576)
            rovcpm = c.rgas / cpmf(qvdec)
            tdyn = tdyn0 + (omega * rovcpm * tv
                            / (ptop * rpsa[None] + self.hsig3)) * self.m_ci

        # -- boundary nudging (nudge3d, Main/mod_bdycod.F90:4218)
        xtd = xt + dt
        tdyn = tdyn + self._nudge3(
            (bdy.t0 + xtd * bdy.tt) - s.t_b, self.nfc, self.ngc)
        qvten = qvten + self._nudge3(
            (bdy.qv0 + xtd * bdy.qvt) - s.qx_b[IQV], self.nfc, self.ngc)
        udyn = udyn + self._nudge3(
            (bdy.u0 + xtd * bdy.ut) - s.u_b, self.nfd, self.ngd, dot=True)
        vdyn = vdyn + self._nudge3(
            (bdy.v0 + xtd * bdy.vt) - s.v_b, self.nfd, self.ngd, dot=True)

        # -- physics (mod_tendency.F90:1682-1820)
        tphy = torch.zeros_like(tdyn)
        qvphy = torch.zeros_like(qvten)
        qhphy = torch.zeros_like(qhten)
        uphy = torch.zeros_like(udyn)
        vphy = torch.zeros_like(vdyn)
        sfupd: Dict[str, torch.Tensor] = {}
        cldfra = torch.zeros_like(tdyn)
        heatrt = s.heatrt
        if self.physics is not None:
            (tphy, qvphy, qhphy, uphy, vphy, cldfra,
             heatrt, sfupd) = self.physics(
                 self, atms, s, bdy, flags, dt,
                 dyn=dict(tdyn=tdyn, qvdyn=qvten, qvhadv=qvhadv,
                          qv_vadv=qv_vadv))
        # radiation heating: tphy += psb·heatrt (mod_tendency.F90:1776)
        tphy = tphy + psb[None] * heatrt * self.m_ci

        # -- diffusion (mod_tendency.F90:1515-1553)
        udyn = udyn + self._diffu_dot(ubd3, xkd)
        vdyn = vdyn + self._diffu_dot(vbd3, xkd)
        tdyn = tdyn + self._diffu_cross(tb3, xkc)
        qvten = qvten + self._diffu_cross(qvb3, xkc)
        qhten = qhten + self._diffu_cross(qhb3, xkc)

        # -- total tendencies + SUBEX condtq
        tten = tdyn + tphy
        qvten_t = qvten + qvphy
        qhten_t = qhten + qhphy
        if self.cfg.physics.ipptls == 1:
            dtc, dqv, dqc = self._condtq(s, tten, qvten_t, qhten_t[0],
                                         psc, rpsc, cldfra, dt)
            tten = tten + dtc
            qvten_t = qvten_t + dqv
            qhten_t = torch.cat([(qhten_t[0] + dqc)[None], qhten_t[1:]])
        if self.iboudy == 4:
            # sponge on the total tendencies (mod_tendency.F90:1481-1483):
            # ften <- w·ften + (1-w)·bt, the hydrometeors' bt zero
            wc3 = self.spwc[None]
            tten = wc3 * tten + (1.0 - wc3) * bdy.tt
            qvten_t = wc3 * qvten_t + (1.0 - wc3) * bdy.qvt
            qhten_t = wc3 * qhten_t

        # -- forecast t, qx at tau+1 (mod_tendency.F90:380-420)
        tc = s.t_b + dt * tten * self.m_ci
        qvc = self._negfix(s.qx_b[IQV] + dt * qvten_t * self.m_ci)
        qhc = self._negfix(s.qx_b[1:] + dt * qhten_t * self.m_ci)

        # -- PGF (mod_tendency.F90:1886-2120): ipgf 0 the full-field
        # form, ipgf 1 the perturbation form, which removes a reference
        # profile t00pg·((σp*+ptop)/p00pg)^pgfaa1 from the virtual
        # temperature in both parts of the force
        td = s.t_a * (1.0 + c.ep1 * qvdec)
        tvfac = 1.0 / (1.0 + qcdec / (1.0 + qvdec))
        ptrps = ptop * rpsa[None]
        if self.ipgf == 1:
            tref3 = T00PG * ((self.hsig3 * psa[None] + ptop)
                             / P00PG) ** PGFAA1
            td = td - psa[None] * tref3        # ttld (:1901)
        logfac = torch.log((self.hsig3 + ptrps)
                           / torch.cat([self.hsig3[1:] + ptrps,
                                        1.0 + ptrps[:1]], dim=0))
        tvavg_up = ((td[:-1] * self.dsig3[:-1] + td[1:] * self.dsig3[1:])
                    / (psa[None] * (self.dsig3[:-1] + self.dsig3[1:]))
                    * tvfac[:-1])
        phi_kz = self.ht - c.rgas * (td[kz - 1] * rpsa
                                     * tvfac[kz - 1]) * logfac[kz - 1]
        if self.ipgf == 1:
            # the reference profile's geopotential (:2046-2047)
            phi_kz = phi_kz + c.rgas * T00PG / PGFAA1 \
                * ((psa + ptop) / P00PG) ** PGFAA1
        incs = -c.rgas * tvavg_up * logfac[:-1]
        phi = torch.cat([torch.flip(torch.cumsum(torch.flip(incs, [0]),
                                                 dim=0), [0])
                         + phi_kz[None], phi_kz[None]], dim=0)
        hpsx2 = 0.5 * (psa + shift(psa, -1, 0))
        hpsx2m = 0.5 * (shift(psa, 0, -1) + shift(psa, -1, -1))
        hpsy2 = 0.5 * (psa + shift(psa, 0, -1))
        hpsy2m = 0.5 * (shift(psa, -1, 0) + shift(psa, -1, -1))
        tvdot4 = 0.25 * (shift(tv, -1, -1) + shift(tv, 0, -1)
                         + shift(tv, -1, 0) + tv)
        if self.ipgf == 1:
            tvdot4 = tvdot4 - T00PG * (
                (self.hsig3 * psdota[None] + ptop) / P00PG) ** PGFAA1
        rtbar = c.rgas * psdota[None] * tvdot4
        dmsf = 1.0 / (self.dx * self.msfd)
        udyn = udyn - rtbar * (
            torch.log(hpsx2[None] * self.hsig3 + ptop)
            - torch.log(hpsx2m[None] * self.hsig3 + ptop)) * dmsf[None] \
            * self.m_di
        vdyn = vdyn - rtbar * (
            torch.log(hpsy2[None] * self.hsig3 + ptop)
            - torch.log(hpsy2m[None] * self.hsig3 + ptop)) * dmsf[None] \
            * self.m_di
        dmsf2 = 1.0 / (2.0 * self.dx * self.msfd)
        udyn = udyn - psdota[None] * (
            phi + shift(phi, -1, 0) - shift(phi, 0, -1)
            - shift(phi, -1, -1)) * dmsf2[None] * self.m_di
        vdyn = vdyn - psdota[None] * (
            phi + shift(phi, 0, -1) - shift(phi, -1, 0)
            - shift(phi, -1, -1)) * dmsf2[None] * self.m_di

        uten = udyn + uphy
        vten = vdyn + vphy
        if self.iboudy == 4:
            wd3 = self.spwd[None]
            uten = wd3 * uten + (1.0 - wd3) * bdy.ut
            vten = wd3 * vten + (1.0 - wd3) * bdy.vt
        uten = uten * self.m_di
        vten = vten * self.m_di

        # -- time filters (mod_timefilter.F90)
        mci = self.m_ci > 0.5
        mdi = self.m_di > 0.5
        dps = self.gnu1 * (psc + psb - 2.0 * psa)
        psb_n = torch.where(mci, psa + dps, psb)
        psa_n = torch.where(mci, psc, psa)
        dtf = self.gnu1 * (tc + s.t_b - 2.0 * s.t_a)
        t_b_n = torch.where(mci, s.t_a + dtf, s.t_b)
        t_a_n = torch.where(mci, tc, s.t_a)
        beta = 0.53
        dq = self.gnu1 * (qvc + s.qx_b[IQV] - 2.0 * s.qx_a[IQV])
        qv_b_n = torch.where(mci, torch.maximum(s.qx_a[IQV] + beta * dq,
                                                c.minqq * psa),
                             s.qx_b[IQV])
        qv_a_n = torch.where(mci, torch.maximum(qvc + (beta - 1.0) * dq,
                                                c.minqq * psb),
                             s.qx_a[IQV])
        dqcf = self.gnu2 * (qhc + s.qx_b[1:] - 2.0 * s.qx_a[1:])
        qh_b_n = torch.where(mci, torch.clamp(s.qx_a[1:] + beta * dqcf,
                                              min=0.0), s.qx_b[1:])
        qh_a_n = torch.where(mci, torch.clamp(qhc + (beta - 1.0) * dqcf,
                                              min=0.0), s.qx_a[1:])
        ucf = s.u_b + dt * uten
        vcf = s.v_b + dt * vten
        duf = self.gnu1 * (ucf + s.u_b - 2.0 * s.u_a)
        dvf = self.gnu1 * (vcf + s.v_b - 2.0 * s.v_a)
        u_b_n = torch.where(mdi, s.u_a + duf, s.u_b)
        u_a_n = torch.where(mdi, ucf, s.u_a)
        v_b_n = torch.where(mdi, s.v_a + dvf, s.v_b)
        v_a_n = torch.where(mdi, vcf, s.v_a)

        psa_n = fix_cross_pad(psa_n)
        psb_n = fix_cross_pad(psb_n)

        # -- split-explicit correction (mod_split.F90:243-480)
        (psa_n, psb_n, t_a_n, t_b_n, u_a_n, u_b_n, v_a_n, v_b_n,
         dstor_n, hstor_n) = self._splitf(
            psa_n, psb_n, t_a_n, t_b_n, u_a_n, u_b_n, v_a_n, v_b_n,
            s.dstor, s.hstor)
        psa_n = fix_cross_pad(psa_n)
        psb_n = fix_cross_pad(psb_n)

        # -- bdyval: boundary ring values (mod_bdycod.F90:1109)
        xt2 = xt + dt
        ecm = self.e_call > 0.5
        edm = self.e_dall > 0.5
        psb_n = torch.where(ecm, psa_n, psb_n)
        t_b_n = torch.where(ecm, t_a_n, t_b_n)
        qv_b_n = torch.where(ecm, qv_a_n, qv_b_n)
        qh_b_n = torch.where(ecm, qh_a_n, qh_b_n)
        u_b_n = torch.where(edm, u_a_n, u_b_n)
        v_b_n = torch.where(edm, v_a_n, v_b_n)
        psa_n = torch.where(ecm, bdy.ps0 + xt2 * bdy.pst, psa_n)
        t_a_n = torch.where(ecm, bdy.t0 + xt2 * bdy.tt, t_a_n)
        qv_a_n = torch.where(ecm, bdy.qv0 + xt2 * bdy.qvt, qv_a_n)
        u_a_n = torch.where(edm, bdy.u0 + xt2 * bdy.ut, u_a_n)
        v_a_n = torch.where(edm, bdy.v0 + xt2 * bdy.vt, v_a_n)
        psa_n = fix_cross_pad(psa_n)
        psb_n = fix_cross_pad(psb_n)
        # inflow/outflow edges (mod_bdycod.F90:1809+): the hydrometeors
        # always (bdyflow), qv with iboudy 3 or 4
        ucx = dot2cross(u_a_n)
        vcx = dot2cross(v_a_n)
        qh_a_n = self._flow_edges(qh_a_n, psa_n, ucx, vcx)
        if self.iboudy in (3, 4):
            qv_a_n = self._flow_edges(qv_a_n, psa_n, ucx, vcx, qext=qv_a_n)

        sfupd = self._tke_update(
            sfupd, s, qdot, (uavg1, uavg2, vavg1, vavg2), psa, rpsa,
            torch.cat([xkc[:1], xkc], dim=0), dt)
        ns = s._replace(
            ps_a=psa_n, ps_b=psb_n, u_a=u_a_n, u_b=u_b_n,
            v_a=v_a_n, v_b=v_b_n, t_a=t_a_n, t_b=t_b_n,
            qx_a=torch.cat([qv_a_n[None], qh_a_n]),
            qx_b=torch.cat([qv_b_n[None], qh_b_n]),
            dstor=dstor_n, hstor=hstor_n, heatrt=heatrt, **sfupd)
        diags = dict(
            pten=pten_n, omega=omega,
            tmax=torch.max(torch.where(mci, tdec, 0.0)),
            psmax=torch.max(torch.where(mci, psa_n, 0.0)),
            psmin=torch.min(torch.where(mci, psa_n, 1e9)))
        if self.mesh is not None:       # over the whole domain
            red = self.mesh.all_reduce(torch.stack(
                [diags["tmax"], diags["psmax"], -diags["psmin"]]))
            diags.update(tmax=red[0], psmax=red[1], psmin=-red[2])
        return ns, diags

    # ------------------------------------------------------------------
    @with_topology
    def step_nh(self, s: HydroState, bdy: BdyState, xt: float, dt: float,
                flags: StepFlags = StepFlags(), coszrs=None, solar=None
                ) -> Tuple[HydroState, Dict[str, torch.Tensor]]:
        """One MM5 non-hydrostatic step (idynamic=2): the NH branches of
        tend (mod_tendency.F90 decouple/compute_omega/adiabatic) and the
        semi-implicit acoustic solver (Main/mod_sound.F90) in place of the
        split-explicit modes. p* is the constant reference ps0−ptop; pp
        and w are prognostic. Arguments as ``step``."""
        base = self.base
        kz = self.kz
        ptop = self.ptop

        psa = s.ps_a          # the constant base.ps0
        psb = s.ps_b
        rpsa = 1.0 / psa
        rpsb = 1.0 / psb
        psdota = cross2dot(psa)
        rpsda = 1.0 / psdota

        # -- decouple (mod_tendency decouple, NH parts :1040-1075)
        uc, vc = s.u_a, s.v_a
        umc = uc * self.msfd
        vmc = vc * self.msfd
        ud = uc * rpsda
        vd = vc * rpsda
        ub_bdy = (bdy.u0 + xt * bdy.ut) * rpsda
        vb_bdy = (bdy.v0 + xt * bdy.vt) * rpsda
        ud = torch.where(self.e_d2 > 0.5, ub_bdy, ud)
        vd = torch.where(self.e_d2 > 0.5, vb_bdy, vd)
        umd = ud * self.msfd
        vmd = vd * self.msfd
        tdec = s.t_a * rpsa
        qvdec = torch.clamp(s.qx_a[IQV] * rpsa, min=c.minqq)
        qhdec = torch.clamp(s.qx_a[1:] * rpsa, min=0.0)
        qcdec = qhdec[0]
        tv = tdec * (1.0 + c.ep1 * qvdec)
        ppdec = s.pp_a * rpsa[None]
        wdec = s.w_a * rpsa[None]
        pr1 = base.pr0 + ppdec
        rho1 = pr1 / (c.rgas * torch.clamp(tv, min=100.0))
        # buoyancy factor (atmx%pr, mod_tendency.F90:1068-1071)
        bfac = (tv - base.t0 - ppdec / (c.cpd * base.rho0)) \
            / torch.clamp(tdec, min=100.0)

        # -- compute_omega, NH (:1157-1195)
        ucc4 = umd + shift(umd, 0, 1) + shift(umd, 1, 0) + shift(umd, 1, 1)
        vcc4 = vmd + shift(vmd, 0, 1) + shift(vmd, 1, 0) + shift(vmd, 1, 1)
        qdot_i = (-base.rhof0[1:kz] * c.egrav * wdec[1:kz]
                  / (base.psfull[None] - ptop * 1000.0)
                  - self.sig3[1:kz] * (
                      base.dpsdxm[None] * (self.twt1[1:] * ucc4[1:]
                                           + self.twt2[1:] * ucc4[:-1])
                      + base.dpsdym[None] * (self.twt1[1:] * vcc4[1:]
                                             + self.twt2[1:] * vcc4[:-1])))
        zt = torch.zeros_like(qdot_i[:1])
        qdot = torch.cat([zt, qdot_i, zt], dim=0)
        rmsfx2 = 1.0 / (2.0 * self.dx * self.msfx ** 2)
        divh = ((shift(umc, 1, 1) + shift(umc, 0, 1)
                 - shift(umc, 1, 0) - umc)
                + (shift(vmc, 1, 1) + shift(vmc, 1, 0)
                   - shift(vmc, 0, 1) - vmc)) * rmsfx2
        div = (divh + (qdot[1:] - qdot[:kz]) * psa[None] / self.dsig3) \
            * self.m_c
        omega = -0.5 * c.egrav * base.rho0 * rpsb[None] \
            * (s.w_b[:kz] + s.w_b[1:]) * rpsb[None]

        # -- mkslice equivalents for the physics (time level b)
        psdotb = cross2dot(psb)
        ubd3 = s.u_b / psdotb
        vbd3 = s.v_b / psdotb
        tb3 = s.t_b * rpsb
        qvb3 = torch.clamp(s.qx_b[IQV] * rpsb, min=c.minqq)
        qhb3 = torch.clamp(s.qx_b[1:] * rpsb, min=0.0)
        qcb3 = qhb3[0]
        ppb3 = s.pp_b * rpsb[None]
        pb3 = base.pr0 + ppb3
        pf3 = torch.cat([base.pf0[:1],
                         base.pf0[1:kz] + 0.5 * (ppb3[:-1] + ppb3[1:]),
                         base.psfull[None] + ppb3[kz - 1:kz]], dim=0)
        ps2d = base.psfull + ppb3[kz - 1]
        tvb3 = tb3 * (1.0 + c.ep1 * qvb3 - qcb3)
        rhob3 = pb3 / (c.rgas * torch.clamp(tb3, min=100.0))
        qsb3 = pfwsat(torch.clamp(tb3, min=100.0), pb3)
        rhb3 = torch.clamp(qvb3 / qsb3, self.rhmin, self.rhmax)
        dzq = (pf3[1:] - pf3[:-1]) / (rhob3 * c.egrav)
        zq = torch.cat([torch.flip(torch.cumsum(torch.flip(dzq, [0]),
                                                dim=0), [0]),
                        torch.zeros_like(dzq[:1])], dim=0)
        za = 0.5 * (zq[:-1] + zq[1:])
        if coszrs is None:
            coszrs = torch.zeros_like(psb)
        atms = dict(ubd3=ubd3, vbd3=vbd3, ubx3=dot2cross(ubd3),
                    vbx3=dot2cross(vbd3), tb3=tb3, qvb3=qvb3, qcb3=qcb3,
                    qhb3=qhb3, tvb3=tvb3, pb3=pb3, pf3=pf3, ps2d=ps2d,
                    rhob3=rhob3, qsb3=qsb3, rhb3=rhb3, za=za, zq=zq,
                    dzq=dzq, psb=psb, psa=psa, omega_pa=omega, qdot=qdot,
                    rpsb=rpsb, coszrs=coszrs)
        if solar is not None:
            atms["eccf"], atms["solcon"] = solar[0], solar[1]
            if len(solar) > 2:
                atms["mpos"] = solar[2]

        # -- diffusion coefficients, the NH variant
        wb3dec = s.w_b * rpsb[None]
        xkc, xkd = self._calc_coeff(ubd3, vbd3, psb, psdotb,
                                    dwdz=wb3dec[:kz] - wb3dec[1:])
        xkcf = torch.cat([xkc[:1], xkc], dim=0)

        # -- advection
        uavg1 = shift(umc, 1, 0) + umc
        uavg2 = shift(umc, 1, 1) + shift(umc, 0, 1)
        vavg1 = shift(vmc, 0, 1) + vmc
        vavg2 = shift(vmc, 1, 1) + shift(vmc, 1, 0)
        udyn, vdyn = self._advection_uv(umc, vmc, ud, vd, uc, vc, qdot)
        # T (ithadv=0, NH: exner-weighted interfaces on p0)
        tdyn0 = self._hadv_scalar(tdec, uavg1, uavg2, vavg1, vavg2, ps=psa)
        tdyn0 = self._stability_guard(tdyn0, tdec * psa[None], psa, "abs")
        dq_t = s.t_a * base.pr0 ** (-c.c287)
        fT = base.pf0[1:kz] ** c.c287 * qdot[1:kz] * (
            self.twt1[1:] * dq_t[1:] + self.twt2[1:] * dq_t[:-1])
        tdyn0 = tdyn0 + self._vadv_flux(fT)
        # qv and the hydrometeors (the hydrostatic forms)
        qvhadv = self._hadv_scalar(qvdec, uavg1, uavg2, vavg1, vavg2,
                                   ps=psa)
        qvhadv = self._stability_guard(qvhadv, qvdec, psa, "rel")
        qva = s.qx_a[IQV]
        ok = ((qva[1:] > c.minqq * psa[None])
              & (qva[:-1] > c.minqq * psa[None]))
        fgq = torch.where(ok, qva[1:] * (qva[:-1]
                                         / torch.clamp(qva[1:], min=1e-30))
                          ** self.qcon[1:], 0.0)
        qv_vadv = self._vadv_flux(qdot[1:kz] * fgq)
        # Kuo takes the qv vertical advection over (mod_tendency.F90:
        # 1371-1373): the core adds it only when no Kuo scheme runs
        qvten = qvhadv if self._kuo_defer() else qvhadv + qv_vadv
        qhten = self._hadv_scalar(qhdec, uavg1, uavg2, vavg1, vavg2, ps=psa)
        qhten = self._stability_guard(qhten, qhdec, psa, "rel")
        qha = s.qx_a[1:]
        fi = self.twt1[1:] * qha[:, 1:] + self.twt2[1:] * qha[:, :-1]
        thr = c.minqq * c.minqq * psa[None]
        fqh = torch.where(qdot[1:kz] > 0.0,
                          torch.where(qha[:, :-1] > thr, qdot[1:kz] * fi,
                                      0.0),
                          torch.where(qha[:, 1:] > thr, qdot[1:kz] * fi,
                                      0.0))
        qhten = qhten + self._vadv_flux(fqh)
        # pp (hadv ind=0 on the decoupled, vadv ind=0 on the coupled)
        ppdyn = self._hadv_scalar(ppdec, uavg1, uavg2, vavg1, vavg2)
        fpp = qdot[1:kz] * (self.twt1[1:] * s.pp_a[1:]
                            + self.twt2[1:] * s.pp_a[:-1])
        ppdyn = ppdyn + self._vadv_flux(fpp)
        # w on the interior interfaces (hadv ind=1 with the winds
        # interpolated to the interfaces; vadv nk=kzp1 ind=0 with
        # half-level fluxes, Main/mod_advection.F90:754-766)
        ua1_i = self.twt1[1:] * uavg1[1:] + self.twt2[1:] * uavg1[:-1]
        ua2_i = self.twt1[1:] * uavg2[1:] + self.twt2[1:] * uavg2[:-1]
        va1_i = self.twt1[1:] * vavg1[1:] + self.twt2[1:] * vavg1[:-1]
        va2_i = self.twt1[1:] * vavg2[1:] + self.twt2[1:] * vavg2[:-1]
        wd_i = wdec[1:kz]
        fx1 = shift(wd_i, 0, -1) + wd_i
        fx2 = wd_i + shift(wd_i, 0, 1)
        fy1 = shift(wd_i, -1, 0) + wd_i
        fy2 = wd_i + shift(wd_i, 1, 0)
        wdyn_i = -self.xmapf[None] * (ua2_i * fx2 - ua1_i * fx1
                                      + va2_i * fy2 - va1_i * fy1) \
            * self.m_ci
        fx0 = 0.5 * (qdot[:kz] + qdot[1:]) * (s.w_a[:kz] + s.w_a[1:])
        wdyn_i = wdyn_i + (fx0[:-1] - fx0[1:]) \
            * (1.0 / (self.dsig3[1:] + self.dsig3[:-1]))

        # -- Coriolis (the NH curvature terms :1838-1876, the horizontal
        # Coriolis part)
        udyn = udyn + self.coriol[None] * vc * self.m_di
        vdyn = vdyn - self.coriol[None] * uc * self.m_di

        # -- adiabatic, NH (:1568-1680)
        cpm = cpmf(qvdec)
        scr1 = 0.5 * c.egrav * base.rho0 * (s.w_a[:kz] + s.w_a[1:]) \
            * rpsa[None]
        tdyn = tdyn0 + (tdec * div
                        - (scr1 * psa[None] + ppdyn
                           + ppdec * div) / (rho1 * cpm)) * self.m_ci
        ppdyn = ppdyn + ppdec * div * self.m_ci
        qvten = qvten + qvdec * div * self.m_ci
        qhten = qhten + qhdec * div * self.m_ci
        # w buoyancy, curvature and divergence terms (:1620-1660) and the
        # water loading
        rofac_i = (self.dsig3[:-1] * base.rho0[1:]
                   + self.dsig3[1:] * base.rho0[:-1]) \
            / (self.dsig3[:-1] * rho1[1:] + self.dsig3[1:] * rho1[:-1])
        ucc4c = uc + shift(uc, 0, 1) + shift(uc, 1, 0) + shift(uc, 1, 1)
        vcc4c = vc + shift(vc, 0, 1) + shift(vc, 1, 0) + shift(vc, 1, 1)
        uaq = 0.25 * (self.twt1[1:] * ucc4c[1:]
                      + self.twt2[1:] * ucc4c[:-1])
        vaq = 0.25 * (self.twt1[1:] * vcc4c[1:]
                      + self.twt2[1:] * vcc4c[:-1])
        wbuoy = ((self.twt2[1:] * bfac[:-1] + self.twt1[1:] * bfac[1:])
                 * rofac_i * c.egrav * psa[None]
                 + (uaq ** 2 + vaq ** 2) * c.rearthrad * rpsa[None]
                 + wdec[1:kz] * (self.twt1[1:] * div[1:]
                                 + self.twt2[1:] * div[:-1]))
        wbuoy = wbuoy - c.egrav * psa[None] * (
            self.twt2[1:] * qcdec[:-1] + self.twt1[1:] * qcdec[1:])
        wdyn_i = wdyn_i + wbuoy * self.m_ci

        # -- boundary nudging (T, qv, u, v as the hydrostatic core; pp and
        # w toward 0)
        xtd = xt + dt
        tdyn = tdyn + self._nudge3(
            (bdy.t0 + xtd * bdy.tt) - s.t_b, self.nfc, self.ngc)
        qvten = qvten + self._nudge3(
            (bdy.qv0 + xtd * bdy.qvt) - s.qx_b[IQV], self.nfc, self.ngc)
        udyn = udyn + self._nudge3(
            (bdy.u0 + xtd * bdy.ut) - s.u_b, self.nfd, self.ngd, dot=True)
        vdyn = vdyn + self._nudge3(
            (bdy.v0 + xtd * bdy.vt) - s.v_b, self.nfd, self.ngd, dot=True)
        ppdyn = ppdyn + self._nudge3(-s.pp_b, self.nfc, self.ngc)
        wdyn_i = wdyn_i + self._nudge3(-s.w_b[1:kz], self.nfc[:kz - 1],
                                       self.ngc[:kz - 1])
        wdyn = torch.cat([zt, wdyn_i, zt], dim=0)

        # -- physics
        tphy = torch.zeros_like(tdyn)
        qvphy = torch.zeros_like(qvten)
        qhphy = torch.zeros_like(qhten)
        uphy = torch.zeros_like(udyn)
        vphy = torch.zeros_like(vdyn)
        sfupd: Dict[str, torch.Tensor] = {}
        cldfra = torch.zeros_like(tdyn)
        heatrt = s.heatrt
        if self.physics is not None:
            (tphy, qvphy, qhphy, uphy, vphy, cldfra,
             heatrt, sfupd) = self.physics(
                 self, atms, s, bdy, flags, dt,
                 dyn=dict(tdyn=tdyn, qvdyn=qvten, qvhadv=qvhadv,
                          qv_vadv=qv_vadv))
        tphy = tphy + psb[None] * heatrt * self.m_ci
        # pp heating tendency (xgamma·p0·Q/(cp·T0), the NH radiation
        # coupling)
        ppphy = (1.0 / (1.0 - c.rovcp)) * base.pr0 * heatrt \
            / torch.clamp(base.t0, min=100.0) * psb[None] * c.rcpd

        # -- diffusion
        udyn = udyn + self._diffu_dot(ubd3, xkd)
        vdyn = vdyn + self._diffu_dot(vbd3, xkd)
        tdyn = tdyn + self._diffu_cross(tb3, xkc)
        qvten = qvten + self._diffu_cross(qvb3, xkc)
        qhten = qhten + self._diffu_cross(qhb3, xkc)
        ppdyn = ppdyn + self._diffu_cross(ppb3, xkc)
        wdyn = wdyn + self._diffu_cross(wb3dec, xkcf)

        tten = tdyn + tphy
        qvten_t = qvten + qvphy
        qhten_t = qhten + qhphy
        ppten_t = ppdyn + ppphy
        wten_t = wdyn
        uten = udyn + uphy
        vten = vdyn + vphy
        if self.cfg.physics.ipptls == 1:
            dtc, dqv, dqc = self._condtq(s, tten, qvten_t, qhten_t[0],
                                         psb, rpsb, cldfra, dt)
            tten = tten + dtc
            qvten_t = qvten_t + dqv
            qhten_t = torch.cat([(qhten_t[0] + dqc)[None], qhten_t[1:]])
        if self.iboudy == 4:
            # sponge on the total tendencies (mod_tendency.F90:1481-1499);
            # the pp and w boundary values are 0
            wc3 = self.spwc[None]
            wd3 = self.spwd[None]
            tten = wc3 * tten + (1.0 - wc3) * bdy.tt
            qvten_t = wc3 * qvten_t + (1.0 - wc3) * bdy.qvt
            qhten_t = wc3 * qhten_t
            uten = wd3 * uten + (1.0 - wd3) * bdy.ut
            vten = wd3 * vten + (1.0 - wd3) * bdy.vt
            ppten_t = wc3 * ppten_t
            wten_t = wc3 * wten_t
        if self.ifrayd == 1:
            # upper-level Rayleigh damping toward the boundary values
            # (mod_tendency.F90:356-364, 465-477; tau at
            # mod_bdycod.F90:5115-5123) on the top min(kz, rayndamp)
            # levels; pp and w relax toward 0
            nr = min(kz, self.rayndamp)
            xt2 = xt + dt
            tau_c = self._rayleigh_tau(za, nr)
            tten = tten + tau_c * ((bdy.t0 + xt2 * bdy.tt) - s.t_b)
            qvten_t = qvten_t + tau_c * (
                (bdy.qv0 + xt2 * bdy.qvt) - s.qx_b[IQV])
            # dot-point heights: the 4-point average (raydampuv :4966)
            tau_d = self._rayleigh_tau(cross2dot(za), nr)
            uten = uten + tau_d * ((bdy.u0 + xt2 * bdy.ut) - s.u_b)
            vten = vten + tau_d * ((bdy.v0 + xt2 * bdy.vt) - s.v_b)
            ppten_t = ppten_t - tau_c * s.pp_b
            wten_t = wten_t - self._rayleigh_tau(zq, nr) * s.w_b

        # -- forecast t and qx, then their filters
        mci = self.m_ci > 0.5
        mdi = self.m_di > 0.5
        tc = s.t_b + dt * tten * self.m_ci
        qvc = self._negfix(s.qx_b[IQV] + dt * qvten_t * self.m_ci)
        qhc = self._negfix(s.qx_b[1:] + dt * qhten_t * self.m_ci)
        dtf = self.gnu1 * (tc + s.t_b - 2.0 * s.t_a)
        t_b_n = torch.where(mci, s.t_a + dtf, s.t_b)
        t_a_n = torch.where(mci, tc, s.t_a)
        beta = 0.53
        dq = self.gnu1 * (qvc + s.qx_b[IQV] - 2.0 * s.qx_a[IQV])
        qv_b_n = torch.where(mci, torch.maximum(s.qx_a[IQV] + beta * dq,
                                                c.minqq * psa),
                             s.qx_b[IQV])
        qv_a_n = torch.where(mci, torch.maximum(qvc + (beta - 1.0) * dq,
                                                c.minqq * psb),
                             s.qx_a[IQV])
        dqcf = self.gnu2 * (qhc + s.qx_b[1:] - 2.0 * s.qx_a[1:])
        qh_b_n = torch.where(mci, torch.clamp(s.qx_a[1:] + beta * dqcf,
                                              min=0.0), s.qx_b[1:])
        qh_a_n = torch.where(mci, torch.clamp(qhc + (beta - 1.0) * dqcf,
                                              min=0.0), s.qx_a[1:])

        # -- the acoustic solver: new u, v, pp, w and the dp' heating of T
        u_c, v_c, pp_c, w_c, t_a_n, t_b_n = sound(
            self, base, s._replace(t_a=t_a_n, t_b=t_b_n), uten, vten,
            ppten_t, wten_t, tb3, qvb3, dt)
        # Asselin filters of the solver's output (mod_sound.F90:690-716)
        duf = self.gnu1 * (u_c + s.u_b - 2.0 * s.u_a)
        u_b_n = torch.where(mdi, s.u_a + duf, s.u_b)
        u_a_n = torch.where(mdi, u_c, s.u_a)
        dvf = self.gnu1 * (v_c + s.v_b - 2.0 * s.v_a)
        v_b_n = torch.where(mdi, s.v_a + dvf, s.v_b)
        v_a_n = torch.where(mdi, v_c, s.v_a)
        dpf = self.gnu1 * (pp_c + s.pp_b - 2.0 * s.pp_a)
        pp_b_n = torch.where(mci, s.pp_a + dpf, s.pp_b)
        pp_a_n = torch.where(mci, pp_c, s.pp_a)
        dwf = self.gnu2 * (w_c + s.w_b - 2.0 * s.w_a)
        w_b_n = torch.where(mci, s.w_a + dwf, s.w_b)
        w_a_n = torch.where(mci, w_c, s.w_a)

        # -- bdyval
        xt2 = xt + dt
        ecm = self.e_call > 0.5
        edm = self.e_dall > 0.5
        t_b_n = torch.where(ecm, t_a_n, t_b_n)
        qv_b_n = torch.where(ecm, qv_a_n, qv_b_n)
        qh_b_n = torch.where(ecm, qh_a_n, qh_b_n)
        u_b_n = torch.where(edm, u_a_n, u_b_n)
        v_b_n = torch.where(edm, v_a_n, v_b_n)
        pp_b_n = torch.where(ecm, pp_a_n, pp_b_n)
        w_b_n = torch.where(ecm, w_a_n, w_b_n)
        t_a_n = torch.where(ecm, bdy.t0 + xt2 * bdy.tt, t_a_n)
        qv_a_n = torch.where(ecm, bdy.qv0 + xt2 * bdy.qvt, qv_a_n)
        u_a_n = torch.where(edm, bdy.u0 + xt2 * bdy.ut, u_a_n)
        v_a_n = torch.where(edm, bdy.v0 + xt2 * bdy.vt, v_a_n)
        # inflow/outflow edges (mod_bdycod.F90:1809+)
        ucx = dot2cross(u_a_n)
        vcx = dot2cross(v_a_n)
        qh_a_n = self._flow_edges(qh_a_n, psa, ucx, vcx)
        if self.iboudy in (3, 4):
            qv_a_n = self._flow_edges(qv_a_n, psa, ucx, vcx, qext=qv_a_n)

        sfupd = self._tke_update(
            sfupd, s, qdot, (uavg1, uavg2, vavg1, vavg2), psa, rpsa, xkcf,
            dt)
        ns = s._replace(
            u_a=u_a_n, u_b=u_b_n, v_a=v_a_n, v_b=v_b_n,
            t_a=t_a_n, t_b=t_b_n,
            qx_a=torch.cat([qv_a_n[None], qh_a_n]),
            qx_b=torch.cat([qv_b_n[None], qh_b_n]),
            pp_a=pp_a_n, pp_b=pp_b_n, w_a=w_a_n, w_b=w_b_n,
            heatrt=heatrt, **sfupd)
        diags = dict(
            wmax=torch.max(torch.abs(w_a_n * rpsb[None])),
            ppmax=torch.max(torch.abs(pp_a_n * rpsb[None])),
            tmax=torch.max(torch.where(mci, tdec, 0.0)))
        if self.mesh is not None:       # over the whole domain
            red = self.mesh.all_reduce(torch.stack(
                [diags["wmax"], diags["ppmax"], diags["tmax"]]))
            diags.update(wmax=red[0], ppmax=red[1], tmax=red[2])
        return ns, diags

    def _rayleigh_tau(self, z, nr):
        """The Rayleigh damping rate at heights z (levels, y, x) on the
        top nr levels (mod_bdycod.F90:5115-5123): rayalpha0·sin²(π/2·(1 −
        (ztop − z)/rayhd)) within rayhd of the column's top level ztop."""
        zmax = z[0:1]
        tau = self.rayalpha0 * torch.sin(
            0.5 * np.pi * (1.0 - (zmax - z) / self.rayhd)) ** 2
        tau = torch.where(z > zmax - self.rayhd, tau, 0.0)
        return torch.cat([tau[:nr], torch.zeros_like(tau[nr:])], dim=0)

    # ------------------------------------------------------------------
    def _flow_edges(self, q, ps, ucx, vcx, qext=None):
        """Inflow/outflow edge values (mod_bdycod.F90:1809-1948 for qv
        with iboudy 3/4, :2155-2230 for the hydrometeors): inflow edges
        take the external value ``qext`` (0 for the hydrometeors,
        qext=None), outflow edges extrapolate the decoupled interior
        value recoupled with the edge p*. q may carry leading species
        axes; periodic directions have no flow edges. The edges are the
        domain's rows 0 and iy-2 and columns 0 and jx-2: under a mesh, the
        first and last ranks of each axis write them at the same local
        offsets from their block's edge (a block holds at least 4 rows
        and columns)."""
        ly, lx = q.shape[-2], q.shape[-1]
        m = self.mesh
        west = m is None or m.px == 0
        east = m is None or m.px == m.nx - 1
        south = m is None or m.py == 0
        north = m is None or m.py == m.ny - 1
        qdec = q / ps
        q = q.clone()        # fresh copy: the edge writes below are local
        ext = (lambda sl: 0.0) if qext is None else (lambda sl: qext[sl])
        if not self.periodic_x:
            if west:
                q[..., 0] = torch.where(ucx[:, :, 0] > 0.0,
                                        ext((Ellipsis, 0)),
                                        qdec[..., 1] * ps[:, 0])
            if east:
                q[..., lx - 2] = torch.where(
                    ucx[:, :, lx - 2] < 0.0, ext((Ellipsis, lx - 2)),
                    qdec[..., lx - 3] * ps[:, lx - 2])
        if not self.periodic_y:
            if south:
                q[..., 0, :] = torch.where(vcx[:, 0, :] > 0.0,
                                           ext((Ellipsis, 0, slice(None))),
                                           qdec[..., 1, :] * ps[0, :])
            if north:
                q[..., ly - 2, :] = torch.where(
                    vcx[:, ly - 2, :] < 0.0,
                    ext((Ellipsis, ly - 2, slice(None))),
                    qdec[..., ly - 3, :] * ps[ly - 2, :])
        return q

    def _nudge2d(self, diff):
        """nudge2d for ps (Main/mod_bdycod.F90:4597)."""
        lap = (shift(diff, 0, -1) + shift(diff, 0, 1)
               + shift(diff, -1, 0) + shift(diff, 1, 0) - 4.0 * diff)
        return (self.nfc[-1] * diff - self.ngc[-1] * lap) * self.m_ci

    def _nudge3(self, diff, fmap, gmap, dot=False):
        """nudge3d (Main/mod_bdycod.F90:4218-4406): F·Δ − G·∇²Δ."""
        lap = (shift(diff, 0, -1) + shift(diff, 0, 1)
               + shift(diff, -1, 0) + shift(diff, 1, 0) - 4.0 * diff)
        m = self.m_di if dot else self.m_ci
        return (fmap * diff - gmap * lap) * m

    def _calc_coeff(self, ubd3, vbd3, psb, psdotb, dwdz=None):
        """Horizontal diffusion coefficients at cross and dot points
        (calc_coeff, Main/mod_diffusion.F90:148-255), coupled by p*: the
        deformation-dependent form (the NH variant with the dw/dz term
        ``dwdz`` and twice the cap), or idiffu=3's constant
        6th-order coefficient (diff_6th_coef·p*, :174-183)."""
        if self.idiffu == 3:
            shape = (self.kz,) + tuple(psb.shape)
            return ((self.diff6 * psb)[None].expand(shape),
                    (self.diff6 * psdotb)[None].expand(shape))
        dudx = (shift(ubd3, 1, 1) + shift(ubd3, 0, 1) - shift(ubd3, 1, 0)
                - ubd3)
        dvdx = (shift(vbd3, 1, 1) + shift(vbd3, 0, 1) - shift(vbd3, 1, 0)
                - vbd3)
        dudy = (shift(ubd3, 1, 0) + shift(ubd3, 1, 1) - ubd3
                - shift(ubd3, 0, 1))
        dvdy = (shift(vbd3, 1, 0) + shift(vbd3, 1, 1) - vbd3
                - shift(vbd3, 0, 1))
        if dwdz is None:
            duv = torch.sqrt((dudx - dvdy) ** 2 + (dvdx + dudy) ** 2)
            cap = self.xkhmax
        else:
            duv = torch.sqrt(torch.clamp(
                (dudx - dvdy) ** 2 + (dvdx + dudy) ** 2 - dwdz ** 2,
                min=0.0))
            cap = 2.0 * self.xkhmax
        xkc_raw = torch.clamp(self.hgfact[None] + self.dydc * duv,
                              max=cap) * self.m_c
        xkc_raw = fix_cross_pad(xkc_raw)
        xkd = 0.25 * (xkc_raw + shifte(xkc_raw, -1, -1)
                      + shifte(xkc_raw, 0, -1) + shifte(xkc_raw, -1, 0))
        rdxsq = 1.0 / (self.dx * self.dx)
        return xkc_raw * rdxsq * psb[None], xkd * rdxsq * psdotb[None]

    def _diffu6(self, fflux, flim, xk, m):
        """idiffu=3 6th-order monotonic hyperdiffusion (the diffu_*
        idiffu==3 branches, Main/mod_diffusion.F90:412-519,602-660;
        WRF's Knievel et al. 2007 scheme): interface fluxes
        10·Δ1 − 5·Δ2 + Δ3, zeroed where the flux runs up the gradient of
        ``flim`` (the cross version limits on f/mpd while fluxing f, as
        the reference does), with the edges replicated. As the JAX
        package does, over the whole interior: the reference's own loops
        visit a single row and column (``do j = jdi2, jdi2``, :421/:611)."""
        ny, nx = fflux.shape[-2], fflux.shape[-1]
        ffp = halo_pad(fflux, 3)
        flp = halo_pad(flim, 3)

        def one_axis(dy, dx):
            def cut(a, n):
                y0 = 3 + n * dy
                x0 = 3 + n * dx
                return a[..., y0:y0 + ny, x0:x0 + nx]
            sh = lambda n: cut(ffp, n)
            sl = lambda n: cut(flp, n)
            fp1 = (10.0 * (sh(1) - sh(0)) - 5.0 * (sh(2) - sh(-1))
                   + (sh(3) - sh(-2)))
            fp1 = torch.where(fp1 * (sl(1) - sl(0)) <= 0.0, 0.0, fp1)
            fp0 = (10.0 * (sh(0) - sh(-1)) - 5.0 * (sh(1) - sh(-2))
                   + (sh(2) - sh(-3)))
            fp0 = torch.where(fp0 * (sl(0) - sl(-1)) <= 0.0, 0.0, fp0)
            return fp1 - fp0
        return xk * (one_axis(0, 1) + one_axis(1, 0)) * m

    def _diffu_cross(self, fdec, xkc):
        """diffu_x3d (Main/mod_diffusion.F90:539-660): idiffu=1
        4th-order interior and 2nd-order on the first interior ring;
        idiffu=2 one 9-point 4th-order operator (:592-601); idiffu=3
        6th-order monotonic (_diffu6)."""
        if self.idiffu == 3:
            return self._diffu6(fdec, fdec / self.msfd, xkc, self.m_ci)
        s1 = (shift(fdec, 0, 1) + shift(fdec, 0, -1)
              + shift(fdec, 1, 0) + shift(fdec, -1, 0))
        if self.idiffu == 2:
            sd = (shift(fdec, 1, 1) + shift(fdec, -1, -1)
                  + shift(fdec, -1, 1) + shift(fdec, 1, -1))
            return xkc * ((4.0 / 6.0) * s1 + (1.0 / 6.0) * sd
                          - (20.0 / 6.0) * fdec) * self.m_ci
        s2 = (shift(fdec, 0, 2) + shift(fdec, 0, -2)
              + shift(fdec, 2, 0) + shift(fdec, -2, 0))
        four = -xkc * (s2 - 4.0 * s1 + 12.0 * fdec)
        two = xkc * (s1 - 4.0 * fdec)
        ring = self.m_ci * (1.0 - self.m_ci2)
        return four * self.m_ci2 + two * ring

    def _diffu_dot(self, fdec, xkd):
        """diffu_d (Main/mod_diffusion.F90:280-440) on f/msfd: idiffu=2
        the 9-point 4th-order operator (:386-411), idiffu=3 6th-order
        monotonic (:412-519)."""
        fm = fdec / self.msfd
        if self.idiffu == 3:
            return self._diffu6(fm, fm, xkd, self.m_di)
        s1 = (shift(fm, 0, 1) + shift(fm, 0, -1)
              + shift(fm, 1, 0) + shift(fm, -1, 0))
        if self.idiffu == 2:
            sd = (shift(fm, 1, 1) + shift(fm, -1, -1)
                  + shift(fm, -1, 1) + shift(fm, 1, -1))
            return xkd * ((4.0 / 6.0) * s1 + (1.0 / 6.0) * sd
                          - (20.0 / 6.0) * fm) * self.m_di
        s2 = (shift(fm, 0, 2) + shift(fm, 0, -2)
              + shift(fm, 2, 0) + shift(fm, -2, 0))
        four = -xkd * (s2 - 4.0 * s1 + 12.0 * fm)
        two = xkd * (s1 - 4.0 * fm)
        ring = self.m_di * (1.0 - self.m_di2)
        return four * self.m_di2 + two * ring

    def _negfix(self, q):
        """Negative-water fix (mod_tendency.F90:383-393): negative values
        become 1% of the 3×3-neighbourhood mean absolute value."""
        acc = torch.zeros_like(q)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                acc = acc + torch.abs(shift(q, dy, dx))
        repl = 0.01 * acc / 9.0
        return torch.where((q < 0.0) & (self.m_ci > 0.5), repl, q)

    def _condtq(self, s, tten, qvten, qcten, psc, rpsc, cldfra, dt):
        """SUBEX saturation adjustment (condtq,
        Main/mod_micro_interface.F90:382-493)."""
        t_p1 = (s.t_b + dt * tten) * rpsc[None]
        qv_p1 = s.qx_b[IQV] + dt * qvten
        qc_p1 = s.qx_b[IQC] + dt * qcten
        qv_p1 = torch.maximum(qv_p1, c.minqq * psc[None]) * rpsc[None]
        qc_p1 = torch.where(qc_p1 < c.dlowval * psc[None], 0.0,
                            qc_p1) * rpsc[None]
        pres = (self.hsig3 * psc[None] + self.ptop) * 1000.0
        t_p1 = torch.clamp(t_p1, min=10.0)
        qvs = pfwsat(t_p1, pres)
        wwlh = wlh(t_p1)
        r1 = 1.0 / (1.0 + wwlh * wwlh * qvs / (c.rwat * c.cpd * t_p1 ** 2))
        rhc = torch.clamp(qv_p1 / qvs, 0.0, 1.0)
        rpsb = 1.0 / s.ps_b
        qvb3 = torch.clamp(s.qx_b[IQV] * rpsb[None], min=c.minqq)
        pb3 = (self.hsig3 * s.ps_b[None] + self.ptop) * 1000.0
        tb3 = torch.clamp(s.t_b * rpsb[None], min=10.0)
        rh = torch.clamp(qvb3 / pfwsat(tb3, pb3), self.rhmin, self.rhmax)
        rh0adj = 1.0 - (1.0 - rh) / torch.clamp((1.0 - cldfra) ** 2,
                                                min=1e-10)
        rh0adj = torch.clamp(rh0adj, 0.0, 0.99999)
        qvc_cld = torch.clamp(pfwsat(tb3, pb3) + dt * qvten * rpsc[None],
                              min=0.0)
        fccc = 1.0 - torch.sqrt(torch.clamp(
            (1.0 - rhc) / torch.clamp(1.0 - rh0adj, min=1e-10), min=0.0))
        fccc = torch.clamp(fccc, 0.0, 1.0)
        dqv = torch.where((rhc < rh0adj) | (rhc > 0.99999),
                          self.conf * (qv_p1 - qvs),
                          self.conf * fccc * (qvc_cld - qvs))
        tmp1 = r1 * dqv
        exces = qc_p1 + tmp1
        tmp2 = torch.where(exces >= 0.0, tmp1 / dt, -qc_p1 / dt)
        active = torch.abs(tmp2) > c.dlowval
        tmp2 = torch.where(active, tmp2, 0.0) * self.m_ci
        return (psc[None] * tmp2 * wwlh * c.rcpd, -psc[None] * tmp2,
                psc[None] * tmp2)

    # ------------------------------------------------------------------
    def _mode_geopotential(self, t, ps):
        """delh per mode (mod_split.F90:341-408)."""
        tsum = levels_dot(self.sp_tau, t) / ps[None]
        return (self.sp_hconst[:, None, None]
                + self.sp_hslope[:, None, None] * (ps - self.sp_pd)[None]
                + tsum)

    def _grad_dot(self, h):
        """Cross→dot gradient pair of spstep (mod_split.F90:500-520)."""
        fac = 1.0 / (2.0 * self.dx * self.msfx)
        gx = (h + shift(h, -1, 0) - shift(h, 0, -1)
              - shift(h, -1, -1)) * fac
        gy = (h + shift(h, 0, -1) - shift(h, -1, 0)
              - shift(h, -1, -1)) * fac
        return gx * self.m_di, gy * self.m_di

    def _div_cross(self, uu, vv):
        """Dot→cross divergence (mod_split.F90:312-320)."""
        d = ((shift(uu, 0, 1) + shift(uu, 1, 1) - uu - shift(uu, 1, 0))
             + (shift(vv, 1, 0) + shift(vv, 1, 1) - vv - shift(vv, 0, 1))
             ) / (2.0 * self.dx * self.msfx ** 2)
        return d * self.m_c

    def _splitf(self, psa, psb, t_a, t_b, u_a, u_b, v_a, v_b,
                dstor, hstor):
        """Split-explicit fast-mode correction (splitf + spstep,
        Main/mod_split.F90:243-670; Madala 1987)."""
        psdota = cross2dot(psa)
        d_f = self._mode_divergence(u_a, v_a)
        d_0 = self._mode_divergence(u_b, v_b)
        h_f = self._mode_geopotential(t_a, psa)
        h_0 = self._mode_geopotential(t_b, psb)
        deld1 = dstor - d_0
        deld3 = d_f - dstor
        delh1 = hstor - h_0
        delh3 = h_f - hstor

        edge = self.e_call > 0.5

        def lstep(h):
            gx, gy = self._grad_dot(h)
            return self._div_cross(gx * psdota * self.msfd,
                                   gy * psdota * self.msfd)

        ddsum_l = []
        dhsum_l = []
        for ns in range(self.nsplit):
            aam = self.sp_aam[ns]
            dtau = self.sp_dtau[ns]
            hbar = self.sp_hbar[ns]
            m2 = 2 * aam
            fd = deld3[ns]
            fh = delh3[ns]
            d0 = deld1[ns]
            h0 = delh1[ns]
            # first forward substep
            d1 = d0 - dtau * lstep(h0) + fd / m2
            h1 = h0 - dtau * hbar * d0 / psa + fh / m2
            h1 = torch.where(edge, h0 * (aam - 1.0) / aam, h1)
            ddsum = d0 + d1
            dhsum = h0 + h1
            dm1, dcur, hm1, hcur = d0, d1, h0, h1
            # leapfrog substeps
            for _ in range(2, m2 + 1):
                dnew = dm1 - 2.0 * dtau * lstep(hcur) + fd / aam
                hnew = hm1 - 2.0 * dtau * hbar * dcur / psa + fh / aam
                hnew = torch.where(edge, 2.0 * hcur - hm1, hnew)
                ddsum = ddsum + dnew
                dhsum = dhsum + hnew
                dm1, dcur, hm1, hcur = dcur, dnew, hcur, hnew
            ddsum_l.append(ddsum)
            dhsum_l.append(dhsum)
        ddsum = torch.stack(ddsum_l)
        dhsum = torch.stack(dhsum_l)

        # corrections (mod_split.F90:418-476)
        dps = levels_dot(self.sp_an[None], ddsum)[0]
        psa = psa - dps * self.m_ci
        psb = psb - self.gnu1 * dps * self.m_ci
        dtm = levels_dot(self.sp_am, ddsum)
        t_a = t_a + dtm * self.m_ci
        t_b = t_b + self.gnu1 * dtm * self.m_ci
        fac = psdota / (2.0 * self.dx * self.msfd)
        h = dhsum
        gx = (h + shift(h, -1, 0) - shift(h, 0, -1) - shift(h, -1, -1)) * fac
        gy = (h + shift(h, 0, -1) - shift(h, -1, 0) - shift(h, -1, -1)) * fac
        dum = levels_dot(self.sp_zmatx, gx)
        dvm = levels_dot(self.sp_zmatx, gy)
        u_a = u_a - dum * self.m_di
        u_b = u_b - self.gnu1 * dum * self.m_di
        v_a = v_a - dvm * self.m_di
        v_b = v_b - self.gnu1 * dvm * self.m_di
        return (psa, psb, t_a, t_b, u_a, u_b, v_a, v_b, d_0, h_0)

    def _mode_divergence(self, u, v):
        """Divergence of coupled winds projected on the split modes
        (mod_split.F90:270-300), (nsplit, iy, jx)."""
        uu = u * self.msfd[None]
        vv = v * self.msfd[None]
        ddiv = ((shift(uu, 0, 1) + shift(uu, 1, 1) - uu - shift(uu, 1, 0))
                + (shift(vv, 1, 0) + shift(vv, 1, 1) - vv
                   - shift(vv, 0, 1))) / (2.0 * self.dx
                                          * self.msfx[None] ** 2)
        ddiv = ddiv * self.m_c
        return levels_dot(self.sp_zmatxr, ddiv)

    def decoupled(self, s: HydroState) -> Dict[str, torch.Tensor]:
        """Physical-unit prognostics: p*-coupled fields divided by p*
        (the dot-point p* with the edge replication of the non-periodic
        topology whatever the core's, as the JAX package's
        ``Model.decoupled``; read across the blocks of a mesh)."""
        rps = 1.0 / s.ps_a
        with stencil.topology(mesh=self.mesh):
            rpsd = 1.0 / cross2dot(s.ps_a)
        return dict(ps=(s.ps_a + self.ptop) * 10.0,                # hPa
                    t=s.t_a * rps[None], qv=s.qx_a[IQV] * rps[None],
                    qc=s.qx_a[IQC] * rps[None],
                    u=s.u_a * rpsd[None], v=s.v_a * rpsd[None])

    @with_topology
    def init_split_storage(self, s: HydroState) -> HydroState:
        """Initial dstor/hstor from the b-level state (spinit,
        Main/mod_split.F90:180-240)."""
        return s._replace(dstor=self._mode_divergence(s.u_b, s.v_b),
                          hstor=self._mode_geopotential(s.t_b, s.ps_b))
