"""SUBEX resolved-scale precipitation + cloud fraction (ipptls=1),
torch twin of ``regcm_tpu/physics/micro/subex.py``.

SUBEX (``Main/microlib/mod_micro_subex.F90:99-439``, Pal et al. 2000),
the Sundqvist cloud fraction (``Main/cloudlib/mod_cloud_subex.F90``) and
the large-scale/convective cloud combination of ``cldfrac``
(``Main/mod_micro_interface.F90:211-362``). Arrays are (kz, iy, jx); the
top-to-surface precipitation cascade is a loop over k, batched over the
(y, x) plane.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...utils import constants as c

from ...utils.thermo import pfwsat, wlh

REMFRC = 0.0
ACTCLD = 0.0
ACCRFRC = 0.5
PPTMIN = 0.0


def subex_cldfrac(t, p, qv, qc, rh, rh0, tc0=238.0, rhmin=0.01, rhmax=1.01):
    """Sundqvist (1989) large-scale cloud fraction
    (Main/cloudlib/mod_cloud_subex.F90:46-107)."""
    rhrng = torch.clamp(rh, rhmin, rhmax)
    rh0adj = torch.where(t > tc0, rh0,
                         0.99999 - (1.0 - rh0) / (1.0 + 0.15 * (tc0 - t)))
    fcc = 1.0 - torch.sqrt(torch.clamp((1.0 - rhrng)
                                       / torch.clamp(1.0 - rh0adj, min=1e-10),
                                       min=0.0))
    fcc = torch.where(rhrng <= rh0adj, 0.0,
                      torch.where(rhrng > 0.99999, 1.0, fcc))
    fcc = torch.where(qc > 1.0e-7, fcc, 0.0)
    return torch.clamp(fcc, 0.0, 1.0)


def combine_clouds(fcc, qcn, rho, t, cldfra_cum, cldlwc_cum):
    """Combine large-scale + convective cloud for radiation (cldfrac,
    Main/mod_micro_interface.F90:296-362). Returns (cldlwc g/m3
    in-cloud, cldfra)."""
    lowcld, hicld = 1.0e-4, 0.9999
    fcc = torch.clamp(fcc, 0.0, hicld)
    totc = torch.where(qcn <= 1.0e-10, 0.0, qcn)
    exlwc = torch.where(fcc > lowcld,
                        totc * 1000.0 * rho / torch.clamp(fcc, min=lowcld),
                        0.0)
    chi_s = 0.97 * torch.exp(-((fcc - 0.098) ** 2) / 0.0365) + 0.255
    exlwc = torch.where(fcc > lowcld, exlwc * chi_s, 0.0)
    has_cum = cldfra_cum > lowcld
    cldlwc = torch.where(
        has_cum,
        (exlwc * fcc + cldlwc_cum * cldfra_cum)
        / torch.clamp(cldfra_cum + fcc, min=lowcld),
        exlwc)
    cldfra = torch.where(has_cum, torch.maximum(cldfra_cum, fcc), fcc)
    cldfra = torch.where(cldlwc > 0.0, torch.clamp(cldfra, 0.0, hicld), 0.0)
    return cldlwc, cldfra


class SubexOut(NamedTuple):
    tten: torch.Tensor     # coupled K/s·cb
    qvten: torch.Tensor
    qcten: torch.Tensor
    precip: torch.Tensor   # surface precipitation rate (kg/m2/s)
    remrat: torch.Tensor   # in-cloud removal rate (1/s)
    rembc: torch.Tensor    # below-cloud washout rate (mm/hr)


def subex(t, phs, pfs, qvn, qcn, rh, rho, fcc, psb, dt,
          qck1, cgul, cevap, caccr, rhmax=1.01, rhmin=0.01) -> SubexOut:
    """SUBEX precipitation cascade (Main/microlib/mod_micro_subex.F90:99).
    Inputs decoupled; psb (cb) couples the output tendencies."""
    kz = t.shape[0]
    afc = fcc
    qcincl = qcn / torch.clamp(afc, min=1e-10)
    tcel = t - c.tzero
    qcth = cgul[None] * (10.0 ** (-0.48911 + 0.01344 * tcel)) * 1.0e-3
    dqc = torch.where((qcn > c.minqc) & (afc > ACTCLD),
                      torch.clamp(qcincl - qcth, min=0.0), 0.0)
    dpovg = (pfs[1:] - pfs[:-1]) * c.regrav
    qs = pfwsat(t, phs)
    wl = wlh(t)

    pptsum = torch.zeros_like(psb)
    ttens, qvtens, qctens, remrats = [], [], [], []
    for k in range(kz):
        afck = afc[k]
        qcw = qcn[k]
        dpg = dpovg[k]
        pptkm1 = torch.where(pptsum > 0.0, pptsum / dpg, 0.0)
        # raindrop evaporation in the clear fraction (below the top)
        dqv = (qs[k] - qvn[k]) / dt
        rhcs = (rh[k] - afck * rhmax) / torch.clamp(1.0 - afck, min=1e-10)
        rhcs = torch.clamp(rhcs, rhmin, rhmax)
        rdevap = cevap * (rhmax - rhcs) \
            * torch.sqrt(torch.clamp(pptsum, min=0.0)) * (1.0 - afck)
        rdevap = torch.minimum(torch.minimum(rdevap, dqv), pptkm1)
        rdevap = torch.where((pptkm1 > PPTMIN) & (dqv > 0.0)
                             & (rdevap > c.dlowval) & (k > 0), rdevap, 0.0)
        pptsum = torch.clamp(pptsum - rdevap * dpg, min=0.0)
        pptkm1 = pptkm1 - rdevap
        qvtens.append(rdevap * psb)
        ttens.append(-wl[k] * c.rcpd * rdevap * psb)
        # autoconversion + accretion
        pptmax = (1.0 - REMFRC) * qcw / dt
        pptnew = torch.minimum(pptmax, qck1 * dqc[k] * afck)
        qcleft = torch.clamp(qcw - pptnew * dt, min=0.0)
        pptk = (pptkm1 + ACCRFRC * pptnew / torch.clamp(afck, min=1e-10)) \
            * rho[k] * dt
        pptacc = caccr * qcleft * pptk
        pptnew = torch.minimum(pptmax, pptacc + pptnew)
        active = (qcw > c.minqc) & (afck > ACTCLD) & (pptnew > PPTMIN)
        pptnew = torch.where(active, pptnew, 0.0)
        pptsum = pptsum + pptnew * dpg
        qctens.append(-pptnew * psb)
        remrats.append(torch.where(
            active, pptnew / torch.clamp(qcw, min=1e-30), 0.0))
    remrat = torch.stack(remrats)
    # below-cloud washout rate (mod_micro_subex.F90:359-372)
    crem = torch.cumsum(remrat, dim=0) - remrat
    rembc = torch.where(remrat > 0.0, crem * qcn * dpovg, 0.0)
    return SubexOut(tten=torch.stack(ttens), qvten=torch.stack(qvtens),
                    qcten=torch.stack(qctens), precip=pptsum,
                    remrat=remrat, rembc=rembc)
