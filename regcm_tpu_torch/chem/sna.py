"""Sulfate–nitrate–ammonium (SNA) thermodynamic equilibrium, torch twin
of ``regcm_tpu/chem/sna.py``.

The reference's DCCB configuration closes the secondary-inorganic
loop with ISORROPIA-II called in *forward, metastable* mode on the
3-component Na-free system only (``aerodriver``,
``Main/chemlib/mod_che_isorropia.F90:64-161``: cntrl=(0,1), wi has
just SO4/NH4-total/NO3-total, everything else zero).  ISORROPIA
itself cannot be ported — its license forbids modification or reuse
of any portion in other codes (mod_che_common_isorropia.F90:28-56) —
and the 46k-line case machinery exists to handle crustal/sea-salt
components the DCCB call never passes.  What DCCB actually exercises
is the classic SNA equilibrium, which this module re-derives
independently from the published equilibrium formulation:

- sulfate is non-volatile: all H2SO4 partitions to the aerosol
  (the reference makes the same assumption, mod_che_start.F90:152-157);
- ammonia first neutralizes sulfate (2 NH4 per SO4);
- remaining ("free") ammonia partitions against HNO3 via the
  NH4NO3(s/aq) ⇌ NH3(g) + HNO3(g) dissociation constant of
  Mozurkewich (1993), with the relative-humidity-dependent
  aqueous branch above the NH4NO3 deliquescence RH
  (temperature dependence per Wexler & Seinfeld 1991) — the
  metastable (cntrl(2)=1) behavior the reference requests;
- sulfate-rich cells (TA < 2·TS) hold no aerosol nitrate and all
  ammonia condenses, matching the ISORROPIA sulfate-rich regimes
  at the fidelity the 900 s repartition cadence can resolve.

Everything is elementwise over the whole grid, against the reference's
per-cell scalar case dispatch.

Tendency application mirrors ``aerodriver`` exactly: new-equilibrium
minus current, divided by ``dtaesolv`` = 900 s, added to the coupled
chemistry tendency for H2SO4 / NH3 / HNO3 / ANH4 / ANO3.
"""
from __future__ import annotations

import torch

# molecular weights (g/mol) — mod_che_molwg.F90 values
W_SO4 = 98.0           # sulfate carried on the H2SO4 tracer
W_NH3 = 17.0
W_HNO3 = 63.0
W_ANO3 = 62.0
W_ANH4 = 18.0

RGAS = 8.314           # J/mol/K
DTAESOLV = 900.0       # s, aerodriver dtaesolv
CONMIN = 1.0e-30


def nh4no3_kp(t, rh):
    """NH4NO3 ⇌ NH3(g)+HNO3(g) dissociation constant in (mol/m³)².

    Dry branch: Mozurkewich (1993) ln Kp[nb²] = 118.87 − 24084/T −
    6.025 ln T.  Above the deliquescence RH (DRH = 0.6183·
    exp(852·(1/T−1/298)), Wexler & Seinfeld 1991) the aqueous
    dissociation product is reduced by the Mozurkewich polynomial
    (P1 − P2(1−aw) + P3(1−aw)²)·(1−aw)^1.75."""
    lnt = torch.log(t)
    kp_nb = torch.exp(118.87 - 24084.0 / t - 6.025 * lnt)
    drh = 0.6183 * torch.exp(852.0 * (1.0 / t - 1.0 / 298.0))
    aw = torch.clamp(rh, 0.01, 0.99)
    p1 = torch.exp(-135.94 + 8763.0 / t + 19.12 * lnt)
    p2 = torch.exp(-122.65 + 9969.0 / t + 16.22 * lnt)
    p3 = torch.exp(-182.61 + 13875.0 / t + 24.46 * lnt)
    oma = 1.0 - aw
    kp_wet = (p1 - p2 * oma + p3 * oma ** 2) * oma ** 1.75 * kp_nb
    kp = torch.where(aw > drh, torch.minimum(kp_wet, kp_nb), kp_nb)
    # nb² → (mol/m³)²:  c = p/(RT),  1 nb = 1e-4 Pa
    conv = (1.0e-4 / (RGAS * t)) ** 2
    return kp * conv


def sna_equilibrium(ts, ta, tn, t, rh):
    """Forward-mode SNA partition.

    Inputs are *totals* in mol/m³: ts sulfate, ta ammonia+ammonium,
    tn nitric-acid+nitrate; t in K, rh as fraction.  Returns
    (gnh3, ghno3) gas-phase mol/m³; the aerosol fractions are
    ta−gnh3 and tn−ghno3 (sulfate is entirely aerosol)."""
    ts = torch.clamp(ts, min=0.0)
    ta = torch.clamp(ta, min=0.0)
    tn = torch.clamp(tn, min=0.0)
    fa = ta - 2.0 * ts                    # free ammonia after (NH4)2SO4
    kp = nh4no3_kp(t, rh)
    # sulfate-poor: (fa−x)(tn−x) = Kp for aerosol nitrate x ≥ 0
    fap = torch.clamp(fa, min=0.0)
    disc = (fap - tn) ** 2 + 4.0 * kp
    x = 0.5 * (fap + tn - torch.sqrt(disc))
    x = torch.clamp(torch.clamp(x, min=0.0), max=torch.minimum(fap, tn))
    gnh3 = torch.where(fa > 0.0, fap - x, 0.0)
    ghno3 = torch.where(fa > 0.0, tn - x, tn)
    return gnh3, ghno3


class SnaDriver:
    """Equilibrium repartition tendency bound to one tracer set
    (the ``aerodriver`` equivalent, called from ChemTend on every
    chemistry call — same cadence deviation as the gas solver,
    documented in cbmz_driver.py)."""

    def __init__(self, spec):
        n = spec.names
        self.ih2so4 = n.index("H2SO4")
        self.inh3 = n.index("NH3")
        self.ihno3 = n.index("HNO3")
        self.iano3 = n.index("ANO3")
        self.ianh4 = n.index("ANH4")

    def __call__(self, atms, s, chib, cpl, dt):
        rho = atms["rhob3"]
        tb3 = atms["tb3"]
        rh = torch.clamp(atms["rhb3"], 0.0, 0.99)
        rpsb = atms.get("rpsb")
        chi = torch.clamp(chib * rpsb[None], min=0.0) if rpsb is not None \
            else torch.clamp(chib, min=0.0)
        # kg/kg → mol/m³ (massfactor conversion, aerodriver :112-116)
        mol = lambda i, w: torch.clamp(
            chi[i] / w * rho * 1000.0, min=CONMIN)
        ts = mol(self.ih2so4, W_SO4)
        ta = mol(self.inh3, W_NH3) + mol(self.ianh4, W_ANH4)
        tn = mol(self.ihno3, W_HNO3) + mol(self.iano3, W_ANO3)
        gnh3, ghno3 = sna_equilibrium(ts, ta, tn, tb3, rh)
        # back to kg/kg and coupled tendency over dtaesolv
        back = lambda c, w: c * w / 1000.0 / rho
        ten = torch.zeros_like(chib)
        upd = [(self.ih2so4, back(ts, W_SO4)),
               (self.inh3, back(gnh3, W_NH3)),
               (self.ihno3, back(ghno3, W_HNO3)),
               (self.ianh4, back(ta - gnh3, W_ANH4)),
               (self.iano3, back(tn - ghno3, W_ANO3))]
        for i, new in upd:
            ten[i] = (new - chi[i]) * cpl / DTAESOLV
        return ten
