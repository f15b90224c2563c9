"""External coupling contract, torch twin of ``regcm_tpu/coupling.py``:
the RCM_Get/RCM_Put export/import interface of ``Main/mod_update.F90:35-54``
(ESMF/RegESM ocean-wave coupling) and the CLM4.5 land-model attachment
contract of ``Main/mod_lm_interface.F90:440-603``.

The containers hold host numpy arrays of the whole domain, as the JAX
package's do, so a coupler programs against either package alike:

  1. every coupling interval the driver calls ``rcm_put(model)`` and
     ships ``ExportFields`` to the ocean/wave component;
  2. the driver receives the ocean state and calls
     ``rcm_get(model, imp)`` with ``ImportFields``; imported SST and ice
     override the model's lower boundary where the mask is water
     (missing values, the reference's 1e20, keep the model's own);
  3. 3-D exports (``ExportFields3d``) serve atmosphere-to-chemistry or
     wave consumers.

Under a ``DomainMesh`` ``rcm_put`` gathers the whole domain on every rank
and ``rcm_get`` keeps each rank's block of the imported fields. The
imported SST lives on the core (``core.sst``), outside the state, so it
is not in a SAV file: in the JAX package neither.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .utils import constants as c

MISSING = 1.0e20
_TOL = MISSING / 2.0


@dataclasses.dataclass
class ExportFields:
    """2-D atmosphere→ocean exports (exp_data, mod_update.F90:93-126;
    all (iy, jx), SI units)."""
    psfc: np.ndarray     # surface pressure (Pa)
    tsfc: np.ndarray     # 2 m / lowest-level air temperature (K)
    qsfc: np.ndarray     # lowest-level specific humidity (kg/kg)
    swrd: np.ndarray     # net surface shortwave (W/m²)
    lwrd: np.ndarray     # net surface longwave, positive up (W/m²)
    dlwr: np.ndarray     # downward longwave (W/m²)
    lhfx: np.ndarray     # latent heat flux (W/m²)
    shfx: np.ndarray     # sensible heat flux (W/m²)
    prec: np.ndarray     # total precipitation (kg/m²/s)
    wndu: np.ndarray     # lowest-level u wind (m/s)
    wndv: np.ndarray     # lowest-level v wind (m/s)
    rnof: np.ndarray     # surface runoff (kg/m²/s)
    snof: np.ndarray     # sub-surface runoff (kg/m²/s)
    taux: np.ndarray     # zonal wind stress (N/m²)
    tauy: np.ndarray     # meridional wind stress (N/m²)
    wspd: np.ndarray     # wind speed (m/s)
    wdir: np.ndarray     # wind direction (rad)
    ustr: np.ndarray     # friction velocity (m/s)
    nflx: np.ndarray     # net heat flux (W/m²)
    sflx: np.ndarray     # salt/freshwater flux (kg/m²/s)
    snow: np.ndarray     # snowfall (kg/m²/s)
    dswr: np.ndarray     # downward shortwave (W/m²)
    rhoa: np.ndarray     # surface air density (kg/m³)


@dataclasses.dataclass
class ExportFields3d:
    """3-D exports (exp_data3d): (kz, iy, jx)."""
    u: np.ndarray
    v: np.ndarray
    w: np.ndarray        # omega proxy (Pa/s) for the sigma-p cores
    t: np.ndarray
    q: np.ndarray
    cldfrc: np.ndarray
    cldlwc: np.ndarray


@dataclasses.dataclass
class ImportFields:
    """Ocean→atmosphere imports (imp_data): SST (K), sea-ice
    thickness/fraction, surface roughness, friction velocity —
    MISSING (1e20) entries leave the model's own field untouched."""
    sst: Optional[np.ndarray] = None
    sit: Optional[np.ndarray] = None
    msk: Optional[np.ndarray] = None
    zo: Optional[np.ndarray] = None
    ustar: Optional[np.ndarray] = None


def _whole(model, t) -> np.ndarray:
    """The whole domain of a state field as a host array (gathered on
    every rank of a mesh)."""
    if model.mesh is not None:
        t = model.mesh.gather(t)
    return t.detach().cpu().numpy()


def rcm_put(model) -> ExportFields:
    """Assemble the export state from a live Model (RCM_Put,
    mod_update.F90; the surface diagnostics the reference funnels into
    exportFields)."""
    s = model.state
    dec = model.decoupled()
    kz = model.grid.kz
    ps = np.asarray(dec["ps"]) * 100.0
    ta = np.asarray(dec["t"])[kz - 1]
    qa = np.asarray(dec["qv"])[kz - 1]
    ua = np.asarray(dec["u"])[kz - 1]
    va = np.asarray(dec["v"])[kz - 1]
    rhoa = ps / (c.rgas * ta)
    wspd = np.hypot(ua, va)
    uvdrag = _whole(model, s.uvdrag)
    taux = uvdrag * ua
    tauy = uvdrag * va
    ustr = np.sqrt(np.maximum(uvdrag, 0.0) * np.maximum(wspd, 0.1)
                   / np.maximum(rhoa, 0.1))
    lh = _whole(model, s.qfx) * c.wlhv
    sh = _whole(model, s.hfx)
    sw = _whole(model, s.swsfc)
    lwsfc = _whole(model, s.lwsfc)
    lwn = -lwsfc                          # positive up
    prec = np.zeros_like(ps)              # instantaneous rate from accum
    return ExportFields(
        psfc=ps, tsfc=ta, qsfc=qa / (1.0 + qa), swrd=sw, lwrd=lwn,
        dlwr=lwsfc, lhfx=lh, shfx=sh, prec=prec,
        wndu=ua, wndv=va, rnof=np.zeros_like(ps),
        snof=np.zeros_like(ps), taux=taux, tauy=tauy, wspd=wspd,
        wdir=np.arctan2(va, ua), ustr=ustr, nflx=sw - lwn - lh - sh,
        sflx=np.zeros_like(ps), snow=np.zeros_like(ps), dswr=sw,
        rhoa=rhoa)


def rcm_get(model, imp: ImportFields) -> None:
    """Apply the imported ocean state (whole-domain arrays) to the
    model's lower boundary (RCM_Get): the SST replaces the forcing SST
    over water where valid; the sea-ice thickness sets the first sea-ice
    field where valid."""
    def block(a):
        return torch.as_tensor(model._local(np.asarray(a, np.float64)),
                               dtype=model.dtype, device=model.device)
    if imp.sst is not None:
        sst = np.asarray(imp.sst)
        ok = (sst < _TOL) & (np.asarray(model.grid.lndocn) < 0.5)
        model.core.sst = torch.where(block(ok) > 0.5, block(sst),
                                     model.core.sst)
    if imp.sit is not None and hasattr(model.state, "seaice"):
        sit = np.asarray(imp.sit)
        ice = model.state.seaice.clone()
        ice[0] = torch.where(block(sit < _TOL) > 0.5,
                             block(np.maximum(sit, 0.0)), ice[0])
        model.state = model.state._replace(seaice=ice)


# ----------------------------------------------------------------------
# CLM4.5 attachment contract (mod_lm_interface.F90:440-603).
# A land model replacing BATS1e must implement this interface; the
# suite's surface section consumes exactly these outputs.
# ----------------------------------------------------------------------
@dataclasses.dataclass
class LandImport:
    """Atmosphere→land forcing (lm_exchange atm2lnd subset; all
    (iy, jx) or (nnsg, iy, jx), SI)."""
    tatm: np.ndarray     # lowest-level T (K)
    qatm: np.ndarray     # lowest-level specific humidity
    uatm: np.ndarray     # lowest-level u (m/s)
    vatm: np.ndarray     # lowest-level v (m/s)
    zatm: np.ndarray     # lowest-level height (m)
    psurf: np.ndarray    # surface pressure (Pa)
    rhoa: np.ndarray     # air density (kg/m³)
    prcp: np.ndarray     # total precipitation (kg/m²/s)
    swd: np.ndarray      # absorbed/downward solar (W/m²)
    lwd: np.ndarray      # downward longwave (W/m²)
    coszen: np.ndarray   # cosine solar zenith
    dtsrf: float         # surface coupling interval (s)


@dataclasses.dataclass
class LandExport:
    """Land→atmosphere response (lnd2atm subset) — what PhysicsSuite
    blends over land points (see suite.py BATS branch for the
    consuming code path)."""
    sent: np.ndarray     # sensible heat flux (W/m²)
    evpr: np.ndarray     # moisture flux (kg/m²/s)
    drag: np.ndarray     # ρ·Cd·V bulk drag
    tgrd: np.ndarray     # ground/skin temperature (K)
    aldirs: np.ndarray   # direct SW albedo
    aldifs: np.ndarray   # diffuse SW albedo
    aldirl: np.ndarray   # direct LW-band albedo
    aldifl: np.ndarray   # diffuse LW-band albedo
    emiss: np.ndarray    # surface emissivity
