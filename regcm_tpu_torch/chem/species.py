"""Tracer registry: chemsimtype → active species set.

The reference fixes the tracer table in ``mod_che_start.F90``
(chtrname assignment per ``chemsimtype``,
``mod_che_common.F90:240-410``) with indices in
``mod_che_indices.F90``.  Implemented simulations: the dust sets
(``DUST``/``DU12``), sea salt (``SSLT``), dust+seasalt (``DUSS``),
carbonaceous (``CARB``), sulfur (``SULF``), sulfur+carbon (``SUCA``),
the full aerosol mix (``AERO``), ``POLLEN``, the CBMZ gas phase
(``CBMZ``), CB6r2 (``CB6``), and ``DCCB`` (CBMZ + aerosols + the
SNA thermodynamic equilibrium, chem/sna.py).

Scientific constant tables (bin edges, effective diameters,
densities, solubilities) are the reference's published aerosol
parameters (``mod_che_dust.F90:39-90``, ``mod_che_seasalt.F90:33-44``,
``mod_che_carbonaer.F90:35-82``, ``mod_che_pollen.F90:37-46``) —
parameter similarity, not code translation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

# 4-bin transport size ranges (µm) — mod_che_dust.F90:47 dustbsiz1
DUSTBSIZ4 = np.array([[0.01, 1.00], [1.00, 2.50],
                      [2.50, 5.00], [5.00, 20.0]])
# 12-bin edges — mod_che_dust.F90:55 dustbsiz2
_E12 = [0.09, 0.18, 0.60, 1.55, 2.50, 3.75, 4.70, 5.70, 7.50, 14.5,
        25.0, 35.0, 50.0]
DUSTBSIZ12 = np.array([[_E12[i], _E12[i + 1]] for i in range(12)])
# bin effective diameters (µm) — mod_che_dust.F90:71,74
DUSTBED4 = np.array([0.658184, 1.75093, 3.67936, 8.46347])
DUSTBED12 = np.array([0.14062217, 0.43004150, 1.10404692, 1.96586770,
                      3.06595481, 4.18119746, 5.15961048, 6.54926438,
                      10.48942724, 18.92482164, 29.55897871,
                      41.62382698])
RHODUST = 2650.0          # kg/m³ (mod_che_dust.F90:90)
SOLDUST = 0.1             # solubility fraction (mod_che_dust.F90:84)

# sea salt (mod_che_seasalt.F90:33-44)
RHOSSLT = 1020.0
SSLTBSIZ = np.array([[0.05, 1.0], [1.0, 10.0]])   # dry diameter µm
SSLTBED = np.array([0.6, 6.0])
SOLSSLT = 0.8

# carbonaceous (mod_che_carbonaer.F90:35-82); SO4 rides in the carb
# group with reffochl/solso4 (mod_che_start.F90:158-166).  Group
# density follows the reference's drydep call (rhooc for the whole
# icarb vector, mod_che_tend.F90:409-417) — a documented group-level
# shortcut of the reference itself.
RHOBC, RHOOC, RHOCARB_GROUP = 2000.0, 1200.0, 1200.0
REFFBC, REFFOC, REFFHL = 0.05, 0.2, 0.3
SOLBC, SOLOC, SOLHL = 0.05, 0.05, 0.8
CARB_AGING_EFOLD = 1.15 * 86400.0     # s (Cooke et al. 1999)

# sulfur (mod_che_sox.F90:36-37)
SOLSO2, SOLSO4 = 0.6, 1.0

# pollen (mod_che_pollen.F90:37-46)
RHOPOLLEN, REFFPOLLEN, SOLPOLLEN = 1200.0, 20.0, 0.05


@dataclass
class ChemSpec:
    """Active tracer set + per-tracer parameters.

    ``kind``: per-tracer category — 'dust', 'sslt', 'carb' (aerosol
    group incl. SO4), 'so2' (gas), 'pollen', 'gas' (CBMZ species).
    Aerosol deposition fields are zero/unused for gas tracers.
    """
    simtype: str
    names: List[str]
    kind: List[str]
    bin_diam: np.ndarray          # effective diameter (µm) per tracer
    bin_size: np.ndarray          # (ndust, 2) dust emission ranges (µm)
    rhop: np.ndarray              # particle density (kg/m³)
    sol: np.ndarray               # solubility fraction chtrsol
    ioxclim: int = 0              # prescribed oxidant climatology
    igaschem: int = 0             # interactive gas-phase solver
    isna: int = 0                 # SNA thermodynamic equilibrium
    # carbon aging pairs (hydrophobic idx → hydrophilic idx)
    aging_pairs: List[tuple] = field(default_factory=list)

    @property
    def ntr(self) -> int:
        return len(self.names)

    @property
    def aerosol_mask(self) -> np.ndarray:
        return np.array([k != "gas" and k != "so2" for k in self.kind])

    def index(self, name: str) -> int:
        return self.names.index(name)

    def indices(self, *kinds: str) -> List[int]:
        return [i for i, k in enumerate(self.kind) if k in kinds]

    @property
    def iso2(self) -> Optional[int]:
        return self.names.index("SO2") if "SO2" in self.names else None

    @property
    def iso4(self) -> Optional[int]:
        for n in ("SO4", "H2SO4"):
            if n in self.names:
                return self.names.index(n)
        return None


SUPPORTED_CHEMSIM = ("DUST", "DU12", "SSLT", "DUSS", "CARB", "SULF",
                     "SUCA", "AERO", "POLLEN", "CBMZ", "CB6", "DCCB")


def _dust(nbin):
    if nbin == 4:
        return (["DUST%02d" % (i + 1) for i in range(4)], DUSTBED4,
                DUSTBSIZ4)
    return (["DUST%02d" % (i + 1) for i in range(12)], DUSTBED12,
            DUSTBSIZ12)


def _mk(simtype, names, kind, diam, rho, sol, **kw):
    return ChemSpec(simtype=simtype, names=names, kind=kind,
                    bin_diam=np.asarray(diam, float),
                    bin_size=kw.pop("bin_size", np.zeros((0, 2))),
                    rhop=np.asarray(rho, float),
                    sol=np.asarray(sol, float), **kw)


# carbonaceous block: BC_HL, BC_HB, OC_HL, OC_HB in the reference's
# CARB/AERO ordering (mod_che_common.F90:284-287)
_CARB_NAMES = ["BC_HL", "BC_HB", "OC_HL", "OC_HB"]
_CARB_DIAM = [REFFHL, REFFBC, REFFHL, REFFOC]
_CARB_SOL = [SOLHL, SOLBC, SOLHL, SOLOC]


def build_species(chemsimtype: str) -> Optional[ChemSpec]:
    """Translate the chemparam ``chemsimtype`` string into a tracer
    set (mod_che_start.F90 start_chem).  Raises for simulations whose
    solvers are not yet ported — never a silent no-op."""
    sim = (chemsimtype or "").strip().upper()
    if not sim:
        return None
    if sim in ("DUST", "DU12"):
        nbin = 4 if sim == "DUST" else 12
        names, bed, bsz = _dust(nbin)
        return _mk(sim, names, ["dust"] * nbin, bed,
                   [RHODUST] * nbin, [SOLDUST] * nbin, bin_size=bsz)
    if sim == "SSLT":
        return _mk(sim, ["SSLT01", "SSLT02"], ["sslt"] * 2, SSLTBED,
                   [RHOSSLT] * 2, [SOLSSLT] * 2)
    if sim == "DUSS":
        names, bed, bsz = _dust(4)
        return _mk(sim, names + ["SSLT01", "SSLT02"],
                   ["dust"] * 4 + ["sslt"] * 2,
                   np.concatenate([bed, SSLTBED]),
                   [RHODUST] * 4 + [RHOSSLT] * 2,
                   [SOLDUST] * 4 + [SOLSSLT] * 2, bin_size=bsz)
    if sim == "CARB":
        sp = _mk(sim, list(_CARB_NAMES), ["carb"] * 4, _CARB_DIAM,
                 [RHOCARB_GROUP] * 4, _CARB_SOL)
        sp.aging_pairs = [(1, 0), (3, 2)]     # BC_HB→BC_HL, OC_HB→OC_HL
        return sp
    if sim == "SULF":
        # SO2 gas + SO4 aerosol (in the carb group for deposition:
        # reff = reffochl, sol = solso4; mod_che_start.F90:158-166)
        return _mk(sim, ["SO2", "SO4"], ["so2", "carb"],
                   [0.0, REFFHL], [0.0, RHOCARB_GROUP],
                   [SOLSO2, SOLSO4], ioxclim=1)
    if sim == "SUCA":
        sp = _mk(sim, list(_CARB_NAMES) + ["SO2", "SO4"],
                 ["carb"] * 4 + ["so2", "carb"],
                 _CARB_DIAM + [0.0, REFFHL],
                 [RHOCARB_GROUP] * 4 + [0.0, RHOCARB_GROUP],
                 _CARB_SOL + [SOLSO2, SOLSO4], ioxclim=1)
        sp.aging_pairs = [(1, 0), (3, 2)]
        return sp
    if sim == "AERO":
        names, bed, bsz = _dust(4)
        sp = _mk(sim,
                 list(_CARB_NAMES) + ["SO2", "SO4"] + names
                 + ["SSLT01", "SSLT02"],
                 ["carb"] * 4 + ["so2", "carb"] + ["dust"] * 4
                 + ["sslt"] * 2,
                 _CARB_DIAM + [0.0, REFFHL] + list(bed)
                 + list(SSLTBED),
                 [RHOCARB_GROUP] * 4 + [0.0, RHOCARB_GROUP]
                 + [RHODUST] * 4 + [RHOSSLT] * 2,
                 _CARB_SOL + [SOLSO2, SOLSO4] + [SOLDUST] * 4
                 + [SOLSSLT] * 2,
                 bin_size=bsz, ioxclim=1)
        sp.aging_pairs = [(1, 0), (3, 2)]
        return sp
    if sim == "POLLEN":
        return _mk(sim, ["POLLEN"], ["pollen"], [REFFPOLLEN],
                   [RHOPOLLEN], [SOLPOLLEN])
    if sim == "CBMZ":
        try:
            from ._cbmz_mech_data import CBMZ_TRACERS, CBMZ_TRACER_SOL
        except ImportError as e:
            raise ValueError(
                "chemsimtype='CBMZ' needs the generated mechanism "
                f"tables (_cbmz_mech_data.py): {e}") from e
        ntr = len(CBMZ_TRACERS)
        kind = ["so2" if n == "SO2" else "gas" for n in CBMZ_TRACERS]
        return _mk(sim, list(CBMZ_TRACERS), kind, [0.0] * ntr,
                   [0.0] * ntr, list(CBMZ_TRACER_SOL), igaschem=1)
    if sim == "DCCB":
        # CBMZ gas phase + the full aerosol mix + SNA equilibrium
        # (mod_che_common.F90:341-380, ismoke=0 → 50 tracers;
        # iisoropia=1 handled by chem/sna.py).  NH3 is transported
        # but inert in the gas mechanism (indcbmz<0 skip,
        # mod_che_chemistry.F90:100); H2SO4/ANO3/ANH4 join the carb
        # deposition group with reffochl/solso4
        # (mod_che_start.F90:158-181).
        try:
            from ._cbmz_mech_data import CBMZ_TRACERS, CBMZ_TRACER_SOL
        except ImportError as e:
            raise ValueError(
                "chemsimtype='DCCB' needs the generated CBMZ "
                f"mechanism tables (_cbmz_mech_data.py): {e}") from e
        gnames = list(CBMZ_TRACERS)
        ng = len(gnames)
        gkind = ["so2" if n == "SO2" else
                 ("carb" if n == "H2SO4" else "gas") for n in gnames]
        gdiam = [REFFHL if n == "H2SO4" else 0.0 for n in gnames]
        grho = [RHOCARB_GROUP if n == "H2SO4" else 0.0
                for n in gnames]
        gsol = [SOLSO4 if n == "H2SO4" else s
                for n, s in zip(gnames, CBMZ_TRACER_SOL)]
        dnames, bed, bsz = _dust(4)
        names = gnames + ["NH3"] + dnames + list(_CARB_NAMES) \
            + ["SSLT01", "SSLT02"] + ["ANO3", "ANH4"]
        kind = gkind + ["gas"] + ["dust"] * 4 + ["carb"] * 4 \
            + ["sslt"] * 2 + ["carb"] * 2
        diam = gdiam + [0.0] + list(bed) + _CARB_DIAM \
            + list(SSLTBED) + [REFFHL] * 2
        rho = grho + [0.0] + [RHODUST] * 4 + [RHOCARB_GROUP] * 4 \
            + [RHOSSLT] * 2 + [RHOCARB_GROUP] * 2
        sol = gsol + [0.0] + [SOLDUST] * 4 + _CARB_SOL \
            + [SOLSSLT] * 2 + [SOLSO4] * 2
        sp = _mk(sim, names, kind, diam, rho, sol, bin_size=bsz,
                 igaschem=1, isna=1)
        ib = ng + 5                       # BC_HL position
        sp.aging_pairs = [(ib + 1, ib), (ib + 3, ib + 2)]
        return sp
    if sim == "CB6":
        # the reference ships the full KPP CB6r2 mechanism
        # (GAS_CB6r2/) but wires no chemsimtype to it; regcm_tpu
        # exposes it first-class (chem/cb6.py docstring)
        try:
            from ._cb6_mech_data import CB6_TRACERS, CB6_TRACER_SOL
        except ImportError as e:
            raise ValueError(
                "chemsimtype='CB6' needs the generated mechanism "
                f"tables (_cb6_mech_data.py): {e}") from e
        ntr = len(CB6_TRACERS)
        kind = ["so2" if n == "SDIO" else "gas" for n in CB6_TRACERS]
        return _mk(sim, list(CB6_TRACERS), kind, [0.0] * ntr,
                   [0.0] * ntr, list(CB6_TRACER_SOL), igaschem=1)
    raise ValueError(
        f"chemparam chemsimtype='{chemsimtype}' is not implemented in "
        f"regcm_tpu (supported: {SUPPORTED_CHEMSIM}; MINE needs soil "
        "mineralogy data). Refusing to run with silently-disabled "
        "chemistry.")
