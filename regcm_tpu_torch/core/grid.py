"""Model grid: static geometry, masks and vertical structure.

The ModelGrid bundles everything the reference keeps in ``mddom``
(``Main/mpplib/mod_regcm_types.F90:65``, filled by ``Main/mod_params.F90``)
plus the vertical coordinate arrays of ``Main/mpplib/mod_runparams.F90``
(sigma/hsigma/dsigma/twt/qcon, ``Main/mod_params.F90:2208-2215``).

Array convention (TPU-first): all 2-D fields are stored full-size
``(iy, jx)`` with axis order (y, x); y maps to the reference's ``i``
index, x to ``j``. Cross-point (mass) fields occupy ``[:iy-1, :jx-1]``;
the last row/column is dead padding kept at edge-replicated values.
Dot-point (wind, Arakawa-B corner) fields use the full extent. This
uniform shape keeps the state pytree stackable and shardable with a
single PartitionSpec over (y, x).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from ..config.params import RegCMConfig
from ..utils import constants as c
from ..utils.projections import grid_geometry
from ..utils.vertical import sigma_levels


def _pad_cross(a: np.ndarray) -> np.ndarray:
    """Pad a cross-grid array (iy-1, jx-1) to (iy, jx) replicating edges."""
    return np.pad(a, ((0, 1), (0, 1)), mode="edge")


@dataclass
class ModelGrid:
    """Static grid data. All numpy float64; converted to jnp on use."""
    iy: int
    jx: int
    kz: int
    ds: float                  # grid spacing (m)
    ptop: float                # model top (cb), reference Share/mod_dynparam.F90:93
    # -- 2-D geometry, full (iy, jx) arrays ------------------------------
    xlat: np.ndarray           # cross lat (padded)
    xlon: np.ndarray
    dlat: np.ndarray           # dot lat
    dlon: np.ndarray
    msfx: np.ndarray           # cross map factor (padded)
    msfd: np.ndarray           # dot map factor
    coriol: np.ndarray         # 2 Ω sin(lat) on cross (padded; used for both)
    ht: np.ndarray             # surface geopotential g·z (m2/s2), cross padded
    lndocn: np.ndarray         # land mask (1 land, 0 ocean), cross padded
    # -- vertical --------------------------------------------------------
    sigma: np.ndarray          # full (interface) levels, kz+1
    hsigma: np.ndarray         # half levels, kz
    dsigma: np.ndarray         # layer thickness, kz
    twt: np.ndarray            # (kz, 2) full-level interp weights
    qcon: np.ndarray           # (kz,) qv vertical advection exponents
    # -- masks (float 0/1, full (iy,jx)) ---------------------------------
    m_cross: np.ndarray        # valid cross cells
    m_cross_int: np.ndarray    # interior cross (excl. outer ring)
    m_cross_int2: np.ndarray   # doubly-interior cross (for 4th-ord diffusion)
    m_dot_int: np.ndarray      # interior dot
    m_dot_int2: np.ndarray
    e_cross: Dict[str, np.ndarray] = field(default_factory=dict)  # edge masks
    e_dot: Dict[str, np.ndarray] = field(default_factory=dict)
    ibnd_cross: Optional[np.ndarray] = None  # distance-from-boundary index
    ibnd_dot: Optional[np.ndarray] = None
    # nudging coefficient fields (precomputed F/G maps per level)
    nudge_fc: Optional[np.ndarray] = None    # (kz, iy, jx) cross F coeff
    nudge_gc: Optional[np.ndarray] = None
    nudge_fd: Optional[np.ndarray] = None    # dot
    nudge_gd: Optional[np.ndarray] = None
    hgfact: Optional[np.ndarray] = None      # topo-corrected diffusion bg
    extras: Dict[str, Any] = field(default_factory=dict)

    # Derived scalars
    @property
    def dx(self):
        return self.ds

    @property
    def dx2(self):
        return 2.0 * self.ds

    @property
    def dx4(self):
        return 4.0 * self.ds

    @property
    def dx8(self):
        return 8.0 * self.ds

    @property
    def dx16(self):
        return 16.0 * self.ds

    @property
    def rdxsq(self):
        return 1.0 / (self.ds * self.ds)


def _boundary_distance(ny: int, nx: int) -> np.ndarray:
    """Distance-from-nearest-edge index, 1-based like the reference's
    ``ba%ibnd`` (edge ring itself = 1)."""
    y = np.arange(ny)
    x = np.arange(nx)
    dy = np.minimum(y, ny - 1 - y)
    dx = np.minimum(x, nx - 1 - x)
    return np.minimum(dy[:, None], dx[None, :]) + 1


def build_grid(cfg: RegCMConfig, ht: Optional[np.ndarray] = None,
               landmask: Optional[np.ndarray] = None,
               dhlake: Optional[np.ndarray] = None) -> ModelGrid:
    """Construct the model grid from a configuration.

    ht: surface elevation (m) on the cross grid (iy-1, jx-1); default flat.
    dhlake: lake depth field (m) on the cross grid (DOMAIN dhlake,
    used by the Hostetler model when lakemod=1).
    Replicates ``Main/mod_params.F90`` grid setup + ``setup_bdycon``
    (``Main/mod_bdycod.F90:183-278``) relaxation coefficients.
    """
    iy, jx, kz = cfg.dim.iy, cfg.dim.jx, cfg.dim.kz
    ds = cfg.ds_m
    geo = cfg.geo
    g = grid_geometry(geo.iproj, ds, geo.clat, geo.clon, jx, iy,
                      truelat1=geo.truelatl, truelat2=geo.truelath,
                      plat=geo.plat, plon=geo.plon)
    # cross arrays from grid_geometry are full (iy, jx) computed at cross
    # positions; the valid cross region is [:iy-1,:jx-1]. Keep values
    # everywhere (they're smooth), they act as edge padding.
    sf, sh, dsg = sigma_levels(kz, cfg.dim.dsmax, cfg.dim.dsmin)
    twt = np.zeros((kz, 2))
    qcon = np.zeros(kz)
    for k in range(1, kz):
        # Main/mod_params.F90:2212-2215 (1-based k → 0-based)
        twt[k, 0] = (sf[k] - sh[k - 1]) / (sh[k] - sh[k - 1])
        twt[k, 1] = 1.0 - twt[k, 0]
        qcon[k] = (sf[k] - sh[k]) / (sh[k - 1] - sh[k])

    if ht is None:
        ht_full = np.zeros((iy, jx))
    else:
        ht_full = _pad_cross(np.asarray(ht, dtype=np.float64))
    if landmask is None:
        lnd = np.ones((iy, jx))
    else:
        lnd = _pad_cross(np.asarray(landmask, dtype=np.float64))

    # masks ---------------------------------------------------------------
    # periodic topologies (band: x wraps; CRM: x and y wrap,
    # Main/mpplib/mod_mppparam.F90:1131 dim_period): a periodic
    # direction has no dead padding column/row, no boundary rings and
    # no relaxation zone.
    px = bool(geo.i_band or geo.i_crm)
    py = bool(geo.i_crm)
    cy = iy if py else iy - 1       # cross extent per direction
    cx = jx if px else jx - 1
    m_cross = np.zeros((iy, jx))
    m_cross[:cy, :cx] = 1.0
    m_cross_int = np.zeros((iy, jx))
    m_cross_int[slice(None) if py else slice(1, iy - 2),
                slice(None) if px else slice(1, jx - 2)] = 1.0
    m_cross_int2 = np.zeros((iy, jx))
    m_cross_int2[slice(None) if py else slice(2, iy - 3),
                 slice(None) if px else slice(2, jx - 3)] = 1.0
    m_dot_int = np.zeros((iy, jx))
    m_dot_int[slice(None) if py else slice(1, iy - 1),
              slice(None) if px else slice(1, jx - 1)] = 1.0
    m_dot_int2 = np.zeros((iy, jx))
    m_dot_int2[slice(None) if py else slice(2, iy - 2),
               slice(None) if px else slice(2, jx - 2)] = 1.0

    e_cross = {}
    e_dot = {}
    for name, sl, per in (("south", (0, slice(None)), py),
                          ("north", (iy - 2, slice(None)), py),
                          ("west", (slice(None), 0), px),
                          ("east", (slice(None), jx - 2), px)):
        m = np.zeros((iy, jx))
        if not per:
            m[sl] = 1.0
        m *= m_cross
        e_cross[name] = m
    for name, sl, per in (("south", (0, slice(None)), py),
                          ("north", (iy - 1, slice(None)), py),
                          ("west", (slice(None), 0), px),
                          ("east", (slice(None), jx - 1), px)):
        m = np.zeros((iy, jx))
        if not per:
            m[sl] = 1.0
        e_dot[name] = m

    def bdy_dist(ny, nx):
        """Distance-from-edge counting only non-periodic directions."""
        dy = np.minimum(np.arange(ny), ny - 1 - np.arange(ny)) \
            if not py else np.full(ny, ny + nx)
        dx = np.minimum(np.arange(nx), nx - 1 - np.arange(nx)) \
            if not px else np.full(nx, ny + nx)
        return np.minimum(dy[:, None], dx[None, :]) + 1

    ibnd_cross = bdy_dist(cy, cx)
    ibnd_cross = np.pad(ibnd_cross, ((0, iy - cy), (0, jx - cx)),
                        mode="edge")
    ibnd_dot = bdy_dist(iy, jx)

    # nudging coefficients (setup_bdycon, Main/mod_bdycod.F90:183-278) ----
    dt = cfg.dtsec
    iboudy = cfg.physics.iboudy
    nspgx, nspgd = cfg.sponge_widths()
    bp = cfg.boundary
    fnudge = bp.extras.get("bdy_nm", 0) or 0.1 / dt
    gnudge = bp.extras.get("bdy_dm", 0) or 1.0 / (dt * 50.0)
    if getattr(bp, "bdy_nm", 0) and bp.bdy_nm > 0:
        fnudge = bp.bdy_nm
    if getattr(bp, "bdy_dm", 0) and bp.bdy_dm > 0:
        gnudge = bp.bdy_dm

    def coeff_maps(ibnd, nspg, dotgrid):
        """(kz, iy, jx) F and G coefficient maps; zero outside zone."""
        fmap = np.zeros((kz, iy, jx))
        gmap = np.zeros((kz, iy, jx))
        if iboudy in (1, 2):
            for n in range(2, nspg):
                xfun = float(nspg - n) / float(nspg - 2)
                m = (ibnd == n)
                fmap[:, m] = fnudge * xfun
                gmap[:, m] = gnudge * xfun
        elif iboudy == 5:
            anudge = np.where(sh < 0.4, bp.high_nudge,
                              np.where(sh < 0.8, bp.medium_nudge,
                                       bp.low_nudge))
            for n in range(2, nspg):
                xfun = np.exp(-(n - 2) / anudge)      # (kz,)
                m = (ibnd == n)
                fmap[:, m] = (fnudge * xfun)[:, None]
                gmap[:, m] = (gnudge * xfun)[:, None]
        return fmap, gmap

    fc, gc = coeff_maps(ibnd_cross, nspgx, False)
    fd, gd = coeff_maps(ibnd_dot, nspgd, True)

    # sponge (iboudy=4) blending weights, setup_bdycon
    # (Main/mod_bdycod.F90:237-251): ften ← w·ften + (1−w)·bt
    sponge_extras = {}
    if iboudy == 4:
        def sponge_map(ibnd, nspg, wgts):
            w = np.ones((iy, jx))
            for n in range(2, nspg):
                w[ibnd == n] = wgts[n - 2] if n - 2 < len(wgts) else 1.0
            return w
        sponge_extras["sponge_wc"] = sponge_map(
            ibnd_cross, nspgx, [0.4, 0.7, 0.9])
        sponge_extras["sponge_wd"] = sponge_map(
            ibnd_dot, nspgd, [0.20, 0.55, 0.80, 0.95])

    # diffusion topo factor (initialize_diffusion,
    # Main/mod_diffusion.F90:96-147)
    dtsec = dt
    dxsq = ds * ds
    xkhz = cfg.dyn.ckh * 1.5e-3 * dxsq / dtsec
    hgfact = np.full((iy, jx), xkhz)
    if cfg.dyn.diffu_hgtf == 1:
        htp = ht_full
        hg1 = np.abs(htp - np.roll(htp, 1, axis=1)) / ds
        hg2 = np.abs(htp - np.roll(htp, -1, axis=1)) / ds
        hg3 = np.abs(htp - np.roll(htp, 1, axis=0)) / ds
        hg4 = np.abs(htp - np.roll(htp, -1, axis=0)) / ds
        hgmax = np.maximum(np.maximum(hg1, hg2), np.maximum(hg3, hg4)) \
            * c.regrav * 1.0e3
        hgfact = xkhz / (1.0 + hgmax ** 2)

    return ModelGrid(
        iy=iy, jx=jx, kz=kz, ds=ds, ptop=cfg.ptop_cb,
        xlat=g["xlat"], xlon=g["xlon"], dlat=g["dlat"], dlon=g["dlon"],
        msfx=g["msfx"], msfd=g["msfd"], coriol=g["coriol"],
        ht=ht_full * c.egrav,   # store as geopotential
        lndocn=lnd,
        sigma=sf, hsigma=sh, dsigma=dsg, twt=twt, qcon=qcon,
        m_cross=m_cross, m_cross_int=m_cross_int, m_cross_int2=m_cross_int2,
        m_dot_int=m_dot_int, m_dot_int2=m_dot_int2,
        e_cross=e_cross, e_dot=e_dot,
        ibnd_cross=ibnd_cross, ibnd_dot=ibnd_dot,
        nudge_fc=fc, nudge_gc=gc, nudge_fd=fd, nudge_gd=gd,
        hgfact=hgfact,
        extras={"dhlake": (_pad_cross(np.asarray(dhlake, np.float64))
                           if dhlake is not None
                           else np.zeros((iy, jx))),
                "rotcos": g["rotcos"], "rotsin": g["rotsin"],
                "nspgx": nspgx, "nspgd": nspgd,
                "fnudge": fnudge, "gnudge": gnudge,
                "xkhmax": dxsq / (64.0 * dtsec),
                "dydc": cfg.dyn.adyndif * c.vonkar * c.vonkar * ds * 0.25,
                **sponge_extras},
    )
