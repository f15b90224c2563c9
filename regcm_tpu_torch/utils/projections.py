"""Map projections, map factors and wind rotation.

NumPy re-implementation of the reference projection engine
(``Share/mod_projections.F90``): Lambert conformal (``LAMCON``,
setup at ``:599``, transforms ``:667-715``, map factor ``:1007``),
polar stereographic (``POLSTR``, ``:717-801``), normal Mercator
(``NORMER``, ``:803-846``) and rotated Mercator (``ROTMER``,
``:848-960``). Grid geometry is computed once on the host at model
setup; only the resulting static 2-D arrays (lat, lon, map factor,
coriolis, rotation cos/sin) enter jitted code.

Grid index convention: this module uses 1-based fractional (i, j) grid
coordinates like the reference, where i runs along x/longitude (jx) and
j along y/latitude (iy). The grid center is at
(ci, cj) = (nlon/2 [- 0.5 if unstaggered], nlat/2 [- 0.5 if unstaggered]).
"""
from __future__ import annotations

import numpy as np

from .constants import earthrad, degrad, raddeg, eomeg

_D90 = 90.0
_D180 = 180.0
_D360 = 360.0
_DLOW = 1.0e-20


def _wrap_lon(lon):
    lon = np.where(lon > _D180, lon - _D360, lon)
    lon = np.where(lon < -_D180, lon + _D360, lon)
    return lon


class Projection:
    """A configured map projection for a model grid.

    Parameters mirror ``anyprojparams`` (``Share/mod_projections.F90:33``):
    ds in meters, clat/clon grid-center lat/lon, truelat1/2 for Lambert,
    plat/plon rotated pole. ``nlon``/``nlat`` are grid sizes (jx, iy);
    staggerx/staggery offset the center for dot-grid setup.
    """

    def __init__(self, pcode: str, ds: float, clat: float, clon: float,
                 nlon: int, nlat: int, truelat1: float = 30.0,
                 truelat2: float = 60.0, plat: float = 0.0, plon: float = 0.0,
                 staggerx: bool = False, staggery: bool = False):
        self.code = pcode.upper()
        self.ds = float(ds)
        self.clat, self.clon = float(clat), float(clon)
        self.nlon, self.nlat = int(nlon), int(nlat)
        ci = nlon * 0.5
        cj = nlat * 0.5
        if not staggerx:
            ci -= 0.5
        if not staggery:
            cj -= 0.5
        self.ci, self.cj = ci, cj
        if self.code == "LAMCON":
            self._setup_lcc(truelat1, truelat2)
        elif self.code == "POLSTR":
            self._setup_ps()
        elif self.code == "NORMER":
            self._setup_mc()
        elif self.code in ("ROTMER", "ROTLLR"):
            self._setup_rmc(plat, plon)
        else:
            raise ValueError(f"unknown projection {pcode}")

    # -- Lambert conformal (setup_lcc, Share/mod_projections.F90:599) ----
    def _setup_lcc(self, trlat1, trlat2):
        self.stdlon = self.clon
        self.truelat1, self.truelat2 = trlat1, trlat2
        tl1r, tl2r = trlat1 * degrad, trlat2 * degrad
        self.colat1 = degrad * (_D90 - trlat1)
        self.colat2 = degrad * (_D90 - trlat2)
        self.nfac = ((np.log(np.sin(self.colat1))
                      - np.log(np.sin(self.colat2)))
                     / (np.log(np.tan(self.colat1 * 0.5))
                        - np.log(np.tan(self.colat2 * 0.5))))
        self.hemi = 1.0 if self.clat > 0.0 else -1.0
        self.rebydx = earthrad / self.ds
        if abs(trlat1 - trlat2) > 0.1:
            cf = (np.log10(np.cos(tl1r)) - np.log10(np.cos(tl2r)))
            cf /= (np.log10(np.tan((45.0 - abs(trlat1) / 2.0) * degrad))
                   - np.log10(np.tan((45.0 - abs(trlat2) / 2.0) * degrad)))
            self.conefac = cf
            self.lamtan = False
        else:
            self.conefac = np.sin(abs(tl1r))
            self.lamtan = True
        self.rconefac = 1.0 / self.conefac
        deltalon1 = _wrap_lon(np.asarray(self.clon - self.stdlon))
        self.ctl1r = np.cos(tl1r)
        self.xct1 = np.tan((_D90 * self.hemi - trlat1) * degrad * 0.5)
        self.rsw = (self.rebydx * self.ctl1r * self.rconefac
                    * (np.tan((_D90 * self.hemi - self.clat) * degrad * 0.5)
                       / self.xct1) ** self.conefac)
        arg = self.conefac * (deltalon1 * degrad)
        self.polei = self.hemi * self.ci - self.hemi * self.rsw * np.sin(arg)
        self.polej = self.hemi * self.cj + self.rsw * np.cos(arg)
        self.chi1 = (_D90 - self.hemi * trlat1) * degrad
        self.chi2 = (_D90 - self.hemi * trlat2) * degrad
        self.tanchi1h = np.tan(self.chi1 * 0.5)
        self.tchi1 = np.tan(self.chi1)
        self.schi1 = np.sin(self.chi1)

    # -- Polar stereographic (setup_plr, :717) ---------------------------
    def _setup_ps(self):
        self.stdlon = self.clon
        self.hemi = 1.0 if self.clat > 0.0 else -1.0
        self.rebydx = earthrad / self.ds
        self.reflon = self.stdlon + _D90
        ala1 = self.clat * degrad
        alo1 = (self.clon - self.reflon) * degrad
        self.scale_top = 1.0 + self.hemi * np.sin(ala1)
        self.rsw = (self.rebydx * np.cos(ala1) * self.scale_top
                    / (1.0 + self.hemi * np.sin(ala1)))
        self.polei = self.ci - self.rsw * np.cos(alo1)
        self.polej = self.cj - self.hemi * self.rsw * np.sin(alo1)

    # -- Normal Mercator (setup_mrc, :803) -------------------------------
    def _setup_mc(self):
        self.stdlon = self.clon
        clain = np.cos(self.clat * degrad)
        self.dlon = self.ds / (earthrad * clain)
        self.rsw = 0.0
        if abs(self.clat) > _DLOW:
            self.rsw = np.log(
                np.tan(0.5 * ((self.clat + _D90) * degrad))) / self.dlon
        self.polei, self.polej = self.ci, self.cj

    # -- Rotated Mercator (setup_rmc, :848) ------------------------------
    def _setup_rmc(self, plat, plon):
        self.plat, self.plon = plat, plon
        self.polei, self.polej = self.ci, self.cj
        self.dlon = self.ds * raddeg / earthrad
        self.dlat = self.ds * raddeg / earthrad
        self.xoff = self.clon - plon
        self.yoff = self.clat - plat
        pphi = _D90 - plat
        plam = plon + _D180
        if plam > _D180:
            plam -= _D360
        self.zlampol = degrad * plam
        zphipol = degrad * pphi
        self.zsinpol = np.sin(zphipol)
        self.zcospol = np.cos(zphipol)
        if plat > 0.0:
            pphi_r = (_D90 - plat) * degrad
            pollam = plon + _D180
        else:
            pphi_r = (_D90 + plat) * degrad
            pollam = plon
        if pollam > _D180:
            pollam -= _D360
        elif pollam < -_D180:
            pollam += _D360
        self.pollam = pollam
        self.polcphi = np.cos(pphi_r)
        self.polsphi = np.sin(pphi_r)

    # -- grid-index → lat/lon (vectorized) -------------------------------
    def ijll(self, i, j):
        i = np.asarray(i, dtype=np.float64)
        j = np.asarray(j, dtype=np.float64)
        if self.code == "LAMCON":
            inew, jnew = self.hemi * i, self.hemi * j
            xx = inew - self.polei
            yy = self.polej - jnew
            r2 = xx * xx + yy * yy
            r = np.sqrt(r2) / self.rebydx
            lon = self.stdlon + raddeg * np.arctan2(
                xx, self.hemi * yy) * self.rconefac
            if self.lamtan:
                chi = 2.0 * np.arctan(
                    (r / self.tchi1) ** self.rconefac * self.tanchi1h)
            else:
                chi = 2.0 * np.arctan(
                    (r * self.conefac / self.schi1) ** self.rconefac
                    * self.tanchi1h)
            lat = (_D90 - chi * raddeg) * self.hemi
            pole = np.abs(r2) < _DLOW
            lat = np.where(pole, self.hemi * _D90, lat)
            lon = np.where(pole, self.stdlon, lon)
            return lat, _wrap_lon(lon)
        if self.code == "POLSTR":
            xx = i - self.polei
            yy = (j - self.polej) * self.hemi
            r2 = xx * xx + yy * yy
            gi2 = (self.rebydx * self.scale_top) ** 2
            lat = raddeg * self.hemi * np.arcsin((gi2 - r2) / (gi2 + r2))
            arcc = np.arccos(xx / np.sqrt(np.maximum(r2, _DLOW)))
            lon = np.where(yy > 0.0, self.reflon + raddeg * arcc,
                           self.reflon - raddeg * arcc)
            pole = np.abs(r2) < _DLOW
            lat = np.where(pole, self.hemi * _D90, lat)
            lon = np.where(pole, self.reflon, lon)
            return lat, _wrap_lon(lon)
        if self.code == "NORMER":
            lat = 2.0 * np.arctan(
                np.exp(self.dlon * (self.rsw + j - self.polej))) \
                * raddeg - _D90
            lon = (i - self.polei) * self.dlon * raddeg + self.stdlon
            return lat, _wrap_lon(lon)
        # ROTMER
        xr = self.xoff + (i - self.polei) * self.dlon
        xr = np.where(xr > _D180, xr - _D360, xr) * degrad
        yr = self.yoff + (j - self.polej) * self.dlat
        yr = 2.0 * np.arctan(np.exp(degrad * yr)) - np.pi / 2.0
        arg = self.zcospol * np.cos(yr) * np.cos(xr) \
            + self.zsinpol * np.sin(yr)
        lat = raddeg * np.arcsin(arg)
        zarg1 = (np.sin(self.zlampol)
                 * (-self.zsinpol * np.cos(xr) * np.cos(yr)
                    + self.zcospol * np.sin(yr))
                 - np.cos(self.zlampol) * np.sin(xr) * np.cos(yr))
        zarg2 = (np.cos(self.zlampol)
                 * (-self.zsinpol * np.cos(xr) * np.cos(yr)
                    + self.zcospol * np.sin(yr))
                 + np.sin(self.zlampol) * np.sin(xr) * np.cos(yr))
        lon = raddeg * np.arctan2(zarg1, zarg2)
        return lat, _wrap_lon(lon)

    # -- lat/lon → grid-index --------------------------------------------
    def llij(self, lat, lon):
        lat = np.asarray(lat, dtype=np.float64)
        lon = np.asarray(lon, dtype=np.float64)
        if self.code == "LAMCON":
            deltalon = _wrap_lon(lon - self.stdlon)
            rm = (self.rebydx * self.ctl1r * self.rconefac
                  * (np.tan((_D90 * self.hemi - lat) * degrad * 0.5)
                     / self.xct1) ** self.conefac)
            arg = self.conefac * (deltalon * degrad)
            i = self.hemi * (self.polei + self.hemi * rm * np.sin(arg))
            j = self.hemi * (self.polej - rm * np.cos(arg))
            return i, j
        if self.code == "POLSTR":
            deltalon = _wrap_lon(lon - self.reflon)
            alo = deltalon * degrad
            ala = lat * degrad
            rm = (self.rebydx * np.cos(ala) * self.scale_top
                  / (1.0 + self.hemi * np.sin(ala)))
            return (self.polei + rm * np.cos(alo),
                    self.polej + self.hemi * rm * np.sin(alo))
        if self.code == "NORMER":
            deltalon = _wrap_lon(lon - self.stdlon)
            i = self.polei + deltalon / (self.dlon * raddeg)
            j = self.polej + np.log(
                np.tan(0.5 * ((lat + _D90) * degrad))) / self.dlon - self.rsw
            return i, j
        # ROTMER
        zphi = degrad * lat
        zlam = np.where(lon > _D180, lon - _D360, lon) * degrad
        zarg = (self.zcospol * np.cos(zphi) * np.cos(zlam - self.zlampol)
                + self.zsinpol * np.sin(zphi))
        phis = np.arcsin(zarg)
        phis = np.log(np.tan(phis * 0.5 + np.pi / 4.0)) * raddeg
        zarg1 = -np.sin(zlam - self.zlampol) * np.cos(zphi)
        zarg2 = (-self.zsinpol * np.cos(zphi) * np.cos(zlam - self.zlampol)
                 + self.zcospol * np.sin(zphi))
        lams = raddeg * np.arctan2(zarg1, zarg2)
        i = self.polei + (lams - self.xoff) / self.dlon
        j = self.polej + (phis - self.yoff) / self.dlat
        return i, j

    # -- map factor (fac_lc/ps/mc/rc, :1007-1044) ------------------------
    def mapfac(self, lat, lon=None):
        lat = np.asarray(lat, dtype=np.float64)
        if self.code == "LAMCON":
            colat = degrad * (_D90 - lat)
            if not self.lamtan:
                return (np.sin(self.colat2) / np.sin(colat)
                        * (np.tan(colat * 0.5)
                           / np.tan(self.colat2 * 0.5)) ** self.nfac)
            return (np.sin(self.colat1) / np.sin(colat)
                    * (np.tan(colat * 0.5)
                       / np.tan(self.colat1 * 0.5)) ** np.cos(self.colat1))
        if self.code == "POLSTR":
            return self.scale_top / (1.0 + self.hemi * np.sin(lat * degrad))
        if self.code == "NORMER":
            return 1.0 / np.cos(lat * degrad)
        # ROTMER: map factor from rotated latitude (fac_rc, :1036)
        assert lon is not None
        ri, rj = self.llij(lat, lon)
        yr = self.yoff + (rj - self.polej) * self.dlon
        return 1.0 / np.cos(yr * degrad)

    # -- wind rotation angle (uvrot_lc/ps, :1046-1083) -------------------
    def rotation_cossin(self, lat, lon):
        """cos/sin of the local grid-north vs true-north angle."""
        lon = np.asarray(lon, dtype=np.float64)
        if self.code == "LAMCON":
            deltalon = _wrap_lon(self.stdlon - lon)
            alpha = deltalon * degrad * self.conefac
            return np.cos(alpha), np.sin(alpha)
        if self.code == "POLSTR":
            deltalon = _wrap_lon(self.stdlon - lon)
            alpha = deltalon * degrad * self.hemi
            return np.cos(alpha), np.sin(alpha)
        if self.code == "NORMER":
            one = np.ones_like(lon)
            return one, np.zeros_like(lon)
        # ROTMER (uvrot_rc, :1068)
        lat = np.asarray(lat, dtype=np.float64)
        zrla = np.where(lat > _D90 - 1e-5, 0.0, lon)
        zrlap = (self.pollam - zrla) * degrad
        zphi = lat * degrad
        zarg1 = self.polcphi * np.sin(zrlap)
        zarg2 = (self.polsphi * np.cos(zphi)
                 - self.polcphi * np.sin(zphi) * np.cos(zrlap))
        znorm = 1.0 / np.sqrt(zarg1 * zarg1 + zarg2 * zarg2)
        return zarg2 * znorm, zarg1 * znorm


def grid_geometry(pcode, ds_m, clat, clon, jx, iy, **kw):
    """Build cross- and dot-grid lat/lon/mapfactor/coriolis arrays.

    Returns dict of float64 numpy arrays shaped (iy, jx): xlat, xlon, msfx
    (cross map factor), dlat, dlon, msfd (dot), coriol f = 2 Ω sin(lat),
    and wind-rotation cos/sin on the cross grid.

    Arakawa-B: dot (wind) points sit at grid corners, offset by (-0.5,-0.5)
    grid units from cross (mass) points (cf. setup in
    ``Main/mod_atm_interface.F90:181`` and ``PreProc/Terrain/mod_maps.F90``).
    """
    pj_x = Projection(pcode, ds_m, clat, clon, jx, iy,
                      staggerx=False, staggery=False, **kw)
    pj_d = Projection(pcode, ds_m, clat, clon, jx, iy,
                      staggerx=True, staggery=True, **kw)
    jj, ii = np.meshgrid(np.arange(1, iy + 1, dtype=np.float64),
                         np.arange(1, jx + 1, dtype=np.float64),
                         indexing="ij")
    xlat, xlon = pj_x.ijll(ii, jj)
    dlat, dlon = pj_d.ijll(ii - 0.5, jj - 0.5)
    msfx = pj_x.mapfac(xlat, xlon)
    msfd = pj_d.mapfac(dlat, dlon)
    fcor = 2.0 * eomeg * np.sin(xlat * degrad)
    fcord = 2.0 * eomeg * np.sin(dlat * degrad)
    rotcos, rotsin = pj_x.rotation_cossin(xlat, xlon)
    return dict(xlat=xlat, xlon=xlon, msfx=msfx,
                dlat=dlat, dlon=dlon, msfd=msfd,
                coriol=fcor, coriod=fcord,
                rotcos=rotcos, rotsin=rotsin,
                projection=pj_x, projection_dot=pj_d)
