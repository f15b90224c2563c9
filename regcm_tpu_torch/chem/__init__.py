"""Aerosol chemistry and its tracer transport (chemsimtypes DUST, DU12,
SSLT, DUSS, CARB, SULF, SUCA, AERO, POLLEN), torch twin of
``regcm_tpu/chem``."""
from .species import build_species


def chem_ntr(cfg) -> int:
    """The state's tracer count (ntr of mod_che_indices; 0 when chemistry
    is off), as the JAX package's ``driver.chem_ntr``."""
    if cfg.physics.ichem:
        refuse_gas_phase(cfg.chem.chemsimtype)
        return require_species(cfg.chem.chemsimtype).ntr
    return 0


def require_species(chemsimtype: str):
    """The tracer set of ``chemsimtype``; raises when ichem=1 comes
    without one."""
    spec = build_species(chemsimtype)
    if spec is None:
        raise ValueError(
            "chemistry (ichem=1, ROADMAP.md item 13) needs chemparam "
            "chemsimtype: DUST, DU12, SSLT, DUSS, CARB, SULF, SUCA, AERO or "
            "POLLEN (the gas-phase CBMZ, DCCB and CB6 are item 13b)")
    return spec


# the chemsimtypes whose solvers wait for ROADMAP item 13b
GAS_PHASE = ("CBMZ", "DCCB", "CB6")


def refuse_gas_phase(chemsimtype: str):
    """Raise for the gas-phase mechanisms (ROADMAP item 13b)."""
    sim = (chemsimtype or "").strip().upper()
    if sim in GAS_PHASE:
        raise NotImplementedError(
            f"regcm_tpu_torch does not port chemsimtype={sim!r}: the "
            "gas-phase mechanisms (CBMZ, DCCB, CB6) and the SNA "
            "equilibrium are ROADMAP.md item 13b")
