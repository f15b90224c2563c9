"""Typed configuration tree mirroring the reference namelist groups.

The group/field names follow the reference namelists (``dimparam``,
``coreparam``, ``geoparam``, ``boundaryparam``, ``timeparam``,
``physicsparam``, … read at ``Share/mod_dynparam.F90:453-476`` and
``Main/mod_params.F90:87-174``) so that real ``regcm.in`` files from the
reference's ``Testing/`` corpus configure this framework verbatim.

Cross-validation/derivation logic follows ``Share/mod_dynparam.F90:500-760``
(e.g. grid-spacing-dependent sponge widths) and ``Main/mod_params.F90``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .namelist import read_namelist, parse_namelist


def _fill(cls, src: Dict[str, Any]):
    """Build dataclass from a namelist group dict; unknown keys → extras."""
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in src.items() if k in names}
    obj = cls(**kw)
    extras = {k: v for k, v in src.items() if k not in names and k != "extras"}
    if hasattr(obj, "extras"):
        obj.extras.update(extras)
    return obj


@dataclass
class DimParam:
    """&dimparam (Share/mod_dynparam.F90:453)."""
    iy: int = 34
    jx: int = 48
    kz: int = 18
    nsg: int = 1
    dsmax: float = 0.05
    dsmin: float = 0.01
    njxcpus: int = -1
    niycpus: int = -1
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class CoreParam:
    """&coreparam — dynamical core selector (Share/mod_dynparam.F90:454)."""
    idynamic: int = 1   # 1 hydrostatic, 2 MM5-NH, 3 MOLOCH
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class GeoParam:
    """&geoparam (Share/mod_dynparam.F90:456)."""
    iproj: str = "LAMCON"
    ds: float = 50.0          # grid spacing (km)
    ptop: float = 5.0         # model top (cb = hPa/10... reference uses cb)
    clat: float = 45.0
    clon: float = 13.0
    plat: float = 45.0
    plon: float = 13.0
    truelatl: float = 30.0
    truelath: float = 60.0
    i_band: int = 0           # tropical band (x-periodic)
    i_crm: int = 0            # doubly-periodic CRM mode
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class BoundaryParam:
    """&boundaryparam (Share/mod_dynparam.F90:463).

    nspgx/nspgd: sponge/relaxation width in cross/dot points; rescaled with
    grid spacing exactly as Share/mod_dynparam.F90:664-675.
    """
    nspgx: int = 12
    nspgd: int = 12
    high_nudge: float = 3.0
    medium_nudge: float = 2.0
    low_nudge: float = 1.0
    bdy_nm: int = 0
    bdy_dm: int = 0
    extras: Dict[str, Any] = field(default_factory=dict)

    def scaled_widths(self, ds_km: float, jx: int, iy: int):
        nx = max(min(max(int(self.nspgx * 50.0 / ds_km), self.nspgx),
                     min(jx, iy) // 4), 3)
        nd = max(min(max(int(self.nspgd * 50.0 / ds_km), self.nspgd),
                     min(jx, iy) // 4), 3)
        return nx, nd


@dataclass
class RestartParam:
    """&restartparam (Main/mod_params.F90:87)."""
    ifrest: bool = False
    mdate0: int = 1990060100
    mdate1: int = 1990060100
    mdate2: int = 1990060600
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TimeParam:
    """&timeparam (Main/mod_params.F90:89). Units follow the reference:
    dt seconds; dtrad/dtabem minutes→ stored in minutes there; here all
    converted to seconds in `derive()`."""
    dt: float = 150.0        # model timestep (s)
    dtrad: float = 30.0      # radiation call interval (minutes)
    dtabem: float = 18.0     # absorption/emissivity recompute (hours)
    dtsrf: float = 600.0     # surface call interval (s)
    dtcum: float = 300.0
    dtche: float = 900.0
    extras: Dict[str, Any] = field(default_factory=dict)

    @property
    def dtrad_sec(self) -> float:
        return self.dtrad * 60.0

    @property
    def dtabem_sec(self) -> float:
        return self.dtabem * 3600.0


@dataclass
class OutParam:
    """&outparam (Main/mod_params.F90:91)."""
    ifsave: bool = True
    savfrq: float = 0.0
    ifatm: bool = True
    atmfrq: float = 6.0
    ifrad: bool = True
    radfrq: float = 6.0
    ifsrf: bool = True
    srffrq: float = 3.0
    ifsub: bool = False
    ifsts: bool = False
    ifchem: bool = False
    chemfrq: float = 6.0
    iflak: bool = False
    lakfrq: float = 6.0
    dirout: str = "./output"
    prestr: str = ""
    # "netcdf" (single-writer NetCDF-3) or "zarr" (sharded Zarr-v2
    # store; the do_parallel_netcdf_out analogue,
    # Share/mod_ncstream.F90:118-146)
    backend: str = "netcdf"
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class PhysicsParam:
    """&physicsparam (Main/mod_params.F90:100)."""
    iboudy: int = 5          # lateral boundary scheme (5=exp relaxation)
    ibltyp: int = 1          # PBL: 1 Holtslag, 2 UW, 3 GFS, 4 MYJ
    icup_lnd: int = 4        # cumulus over land (4=Emanuel)
    icup_ocn: int = 4        # cumulus over ocean
    igcc: int = 2            # Grell closure
    ipptls: int = 1          # microphysics: 1 SUBEX, 2 nogtom, 3 WSM5
    iocnflx: int = 2         # ocean flux: 1 BATS, 2 Zeng, 3 COARE
    ipgf: int = 0            # PGF scheme (1 = perturbation form)
    idiffu: int = 1          # diffusion scheme (1 split-order, 2 O4-9pt)
    iemiss: int = 0
    lakemod: int = 0
    ichem: int = 0
    idcsst: int = 0
    iseaice: int = 0
    idesseas: int = 0
    iconvlwp: int = 0
    icldfrac: int = 0        # cloud fraction scheme
    irrtm: int = 0           # radiation: 0 CCM3, 1 RRTMG
    iclimao3: int = 0
    isladvec: int = 0        # semi-Lagrangian advection
    iqmsl: int = 1
    islab_ocean: int = 0
    itweak: int = 0
    scenario: str = "SSP585"
    # solar forcing controls (Main/mod_params.F90:273-276)
    isolconst: int = 0       # 1 = pin TSI at 1367 W/m²
    ifixsolar: int = 0       # 1 = no diurnal/seasonal cycle
    fixedsolarval: float = 343.0
    year_offset: int = 0     # paleo orbit offset (solar1)
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DynParam:
    """&dynparam (Main/mod_params.F90:109) — diffusion/dynamics tuning."""
    gnu1: float = 0.10       # Asselin filter coefficient (leapfrog)
    gnu2: float = 0.10
    diffu_hgtf: int = 1      # topo-gradient diffusion damping
    ckh: float = 1.0         # background diffusion multiplier
    adyndif: float = 1.0     # deformation diffusion multiplier
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class HydroParam:
    """&hydroparam (Main/mod_params.F90:113) — split-explicit."""
    nsplit: int = 2
    lstand: bool = False
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class NonHydroParam:
    """&nonhydroparam (Main/mod_params.F90:115)."""
    ifupr: int = 1
    nhbet: float = 0.4       # Ikawa beta acoustic offcentering
    nhxkd: float = 0.1
    logp_lrate: float = 50.0
    dtsmax: float = 10.0     # max acoustic substep length
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class MolochParam:
    """&molochparam (Share/mod_dynparam.F90:455) + substep counts
    (Main/mpplib/mod_runparams.F90:175-176)."""
    mo_a0: float = 0.0
    mo_b0: float = 0.5   # Share/mod_dynparam.F90:190
    mo_nadv: int = 1
    mo_nsound: int = 6
    mo_ztop: float = 30000.0
    mo_h: float = 8000.0
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SubexParam:
    """&subexparam (Main/mod_params.F90:126) — SUBEX microphysics tuning.

    Defaults follow Main/mod_params.F90 initialisation of the subexparam
    group (qck1/cevap/caccr etc.).
    """
    qck1land: float = 0.250e-3
    qck1oce: float = 0.250e-3
    gulland: float = 0.4
    guloce: float = 0.4
    rhmax: float = 1.01
    rh0land: float = 0.80
    rh0oce: float = 0.90
    cevaplnd: float = 0.100e-2
    cevapoce: float = 0.100e-2
    caccrlnd: float = 3.000
    caccroce: float = 3.000
    cllwcv: float = 0.3e-3
    clfrcvmax: float = 0.75
    cftotmax: float = 0.75
    conf: float = 1.0
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class KFParamNL:
    """&kfparam (Main/mod_params.F90:151-153; defaults :463-471)."""
    kf_min_pef: float = 0.2
    kf_max_pef: float = 0.9
    kf_entrate: float = 0.03
    kf_dpp: float = 150.0
    kf_min_dtcape: float = 1800.0
    kf_max_dtcape: float = 3600.0
    kf_tkemax: float = 5.0
    kf_convrate: float = 0.03
    kf_wthreshold: float = 0.02
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class PerturbParam:
    """&perturbparam (Share/mod_dynparam.F90:417-471): O'Brien, Sloan
    & Snyder (2010) ensemble perturbation of ICBC reads; only honored
    when globdatparam's ensemble_run is true (:711-731)."""
    lperturb_topo: bool = False
    lperturb_ts: bool = False
    lperturb_ps: bool = False
    lperturb_t: bool = False
    lperturb_q: bool = False
    lperturb_u: bool = False
    lperturb_v: bool = False
    perturb_frac_topo: float = 0.001
    perturb_frac_ts: float = 0.001
    perturb_frac_ps: float = 0.001
    perturb_frac_t: float = 0.001
    perturb_frac_q: float = 0.001
    perturb_frac_u: float = 0.001
    perturb_frac_v: float = 0.001
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TiedtkeParamNL:
    """&tiedtkeparam flags we consume (Main/mod_params.F90:144-149;
    defaults :450-457). Rate constants (entrpen etc.) follow the
    reference defaults as module constants in physics/cumulus/tiedtke."""
    lmfmid: bool = True       # midlevel convection (ktype=3)
    lmfsmooth: bool = False   # smooth mass fluxes for tracer transport
    lmftrac: bool = True      # convective tracer transport
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DebugParam:
    debug_level: int = 0
    dbgfrq: float = 3.0
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TerrainParam:
    domname: str = "domain"
    dirter: str = "."
    inpter: str = "."
    lakedpth: bool = False
    smthbdy: bool = False
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SlabOceanParam:
    """&slabocparam (Main/mod_params.F90:171)."""
    do_qflux_adj: bool = False
    do_restore_sst: bool = True
    sst_restore_timescale: float = 5.0   # days (mod_params.F90:495)
    mixed_layer_depth: float = 50.0      # m (mod_params.F90:494)
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class GlobdatParam:
    dattyp: str = "EIN15"
    ssttyp: str = "OI_WK"
    gdate1: int = 1990060100
    gdate2: int = 1990070100
    ibdyfrq: int = 6
    dirglob: str = "."
    inpglob: str = "."
    calendar: str = "gregorian"
    ensemble_run: bool = False
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ChemParam:
    """&chemparam (Main/mod_params.F90:155-157; defaults :515-533)."""
    chemsimtype: str = ""
    ichremlsc: int = 1       # large-scale wet removal
    ichremcvc: int = 1       # convective wet removal
    ichdrdepo: int = 1       # dry deposition (1 = tendency, 2 = via BL)
    ichcumtra: int = 1       # cumulus tracer transport
    ichsolver: int = 1
    idirect: int = 0         # aerosol direct effect in radiation
    iindirect: int = 0
    ichdustemd: int = 1      # dust emission distribution (1 Alfaro 2 Kok)
    ichdiag: int = 0
    ichsursrc: int = 1       # natural surface sources
    ichebdy: int = 1         # chemistry lateral boundaries
    rdstemfac: float = 1.0   # dust emission tuning factor
    ichjphcld: int = 1
    ichbion: int = 0
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class RegCMConfig:
    """Full model configuration (the runparams singleton equivalent,
    Main/mpplib/mod_runparams.F90)."""
    dim: DimParam = field(default_factory=DimParam)
    core: CoreParam = field(default_factory=CoreParam)
    geo: GeoParam = field(default_factory=GeoParam)
    boundary: BoundaryParam = field(default_factory=BoundaryParam)
    restart: RestartParam = field(default_factory=RestartParam)
    time: TimeParam = field(default_factory=TimeParam)
    out: OutParam = field(default_factory=OutParam)
    physics: PhysicsParam = field(default_factory=PhysicsParam)
    dyn: DynParam = field(default_factory=DynParam)
    hydro: HydroParam = field(default_factory=HydroParam)
    nonhydro: NonHydroParam = field(default_factory=NonHydroParam)
    moloch: MolochParam = field(default_factory=MolochParam)
    subex: SubexParam = field(default_factory=SubexParam)
    debug: DebugParam = field(default_factory=DebugParam)
    terrain: TerrainParam = field(default_factory=TerrainParam)
    globdat: GlobdatParam = field(default_factory=GlobdatParam)
    slaboc: SlabOceanParam = field(default_factory=SlabOceanParam)
    chem: ChemParam = field(default_factory=ChemParam)
    kf: KFParamNL = field(default_factory=KFParamNL)
    tiedtke: TiedtkeParamNL = field(default_factory=TiedtkeParamNL)
    perturb: PerturbParam = field(default_factory=PerturbParam)
    raw: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    _GROUP_MAP = {
        "dimparam": ("dim", DimParam),
        "coreparam": ("core", CoreParam),
        "geoparam": ("geo", GeoParam),
        "boundaryparam": ("boundary", BoundaryParam),
        "restartparam": ("restart", RestartParam),
        "timeparam": ("time", TimeParam),
        "outparam": ("out", OutParam),
        "physicsparam": ("physics", PhysicsParam),
        "dynparam": ("dyn", DynParam),
        "hydroparam": ("hydro", HydroParam),
        "nonhydroparam": ("nonhydro", NonHydroParam),
        "molochparam": ("moloch", MolochParam),
        "subexparam": ("subex", SubexParam),
        "debugparam": ("debug", DebugParam),
        "terrainparam": ("terrain", TerrainParam),
        "globdatparam": ("globdat", GlobdatParam),
        "slabocparam": ("slaboc", SlabOceanParam),
        "chemparam": ("chem", ChemParam),
        "kfparam": ("kf", KFParamNL),
        "tiedtkeparam": ("tiedtke", TiedtkeParamNL),
        "perturbparam": ("perturb", PerturbParam),
    }

    @classmethod
    def from_groups(cls, groups: Dict[str, Dict[str, Any]]) -> "RegCMConfig":
        cfg = cls()
        for gname, gdict in groups.items():
            if gname in cls._GROUP_MAP:
                attr, klass = cls._GROUP_MAP[gname]
                setattr(cfg, attr, _fill(klass, gdict))
        cfg.raw = groups
        return cfg

    @classmethod
    def from_file(cls, path: str) -> "RegCMConfig":
        return cls.from_groups(read_namelist(path))

    @classmethod
    def from_string(cls, text: str) -> "RegCMConfig":
        return cls.from_groups(parse_namelist(text))

    # Derived quantities -------------------------------------------------
    @property
    def ptop_cb(self) -> float:
        """Model top in centibar (reference stores ptop in cb,
        Share/mod_dynparam.F90:93; namelist value is hPa/10? The reference
        namelist value 5.0 means 5 cb = 50 hPa)."""
        return float(self.geo.ptop)

    @property
    def ds_m(self) -> float:
        return float(self.geo.ds) * 1000.0

    @property
    def dtsec(self) -> float:
        return float(self.time.dt)

    def sponge_widths(self):
        return self.boundary.scaled_widths(
            float(self.geo.ds), self.dim.jx, self.dim.iy)
