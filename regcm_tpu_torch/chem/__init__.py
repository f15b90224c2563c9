"""The chemistry (chemsimtypes DUST, DU12, SSLT, DUSS, CARB, SULF, SUCA,
AERO, POLLEN, and the gas phase CBMZ, DCCB and CB6) and its tracer
transport, torch twin of ``regcm_tpu/chem``."""
from .species import build_species


def chem_ntr(cfg) -> int:
    """The state's tracer count (ntr of mod_che_indices; 0 when chemistry
    is off), as the JAX package's ``driver.chem_ntr``."""
    if cfg.physics.ichem:
        return require_species(cfg.chem.chemsimtype).ntr
    return 0


def require_species(chemsimtype: str):
    """The tracer set of ``chemsimtype``; raises when ichem=1 comes
    without one."""
    spec = build_species(chemsimtype)
    if spec is None:
        raise ValueError(
            "chemistry (ichem=1, ROADMAP.md item 13) needs chemparam "
            "chemsimtype: DUST, DU12, SSLT, DUSS, CARB, SULF, SUCA, AERO, "
            "POLLEN, CBMZ, DCCB or CB6")
    return spec
