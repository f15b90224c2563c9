"""Cloud fraction schemes (icldfrac dispatch), torch twin of
``regcm_tpu/physics/cloud/fractions.py``.

The ``Main/cloudlib/`` scheme family selected by ``icldfrac`` (dispatch
at ``Main/mod_micro_interface.F90:254-268``): 0 SUBEX-Sundqvist (in
``physics/micro/subex.py``), 1 Xu-Randall, 2 Thompson scale-aware with
its own liquid/ice Flatau saturation, 3 Gultepe-Isaac, 4 Texeira,
5 Tompkins, 6 ECHAM5. All elementwise on (kz, iy, jx) tensors, apart
from Thompson's tropopause and mixed-layer searches, which run down
each column.
"""
from __future__ import annotations

import math

import torch

from ...utils import constants as c
from ..micro.subex import subex_cldfrac


def xuran_cldfrac(p, qc, qv, qs, rh, rhmin=0.01, rhmax=1.01):
    """Xu & Randall (1996) (mod_cloud_xuran.F90)."""
    rhrng = torch.clamp(rh, rhmin, rhmax)
    botm = rhrng ** 0.25
    rm = -(100.0 * qc) / torch.clamp(((1.0 - rhrng) * qs) ** 0.49,
                                     min=1e-12)
    fcc = botm * (1.0 - torch.exp(rm))
    fcc = torch.where(rhrng > 0.99999, 1.0, fcc)
    return torch.where(qc < 1.0e-7, 0.0, torch.clamp(fcc, 0.0, 1.0))


def gulisa_cldfrac(qv, qs, qt, ds_km):
    """Gultepe & Isaac (mod_cloud_guli2007.F90): resolution-blended
    power laws of total condensate (g/kg)."""
    qgkg = (qt + torch.clamp(qv - qs, min=0.0)) * 1.0e3
    qgkg = torch.clamp(qgkg, min=0.0)
    fcc = (1.0 / 90.0) * ((100.0 - ds_km) * 5.57 * qgkg ** 0.78
                          + (ds_km - 10.0) * 4.82 * qgkg ** 0.94)
    return torch.clamp(fcc, 0.0, 1.0)


def texeira_cldfrac(qc, qs, rh):
    """Texeira (2001) source/dissipation equilibrium
    (mod_cloud_texeira.F90)."""
    kappa = 1.0e-6
    d = 4.0e-6
    rhrng = torch.clamp(rh, 0.001, 0.999)
    spq = qs / (1.0 + qs)
    arg = (4.0 * spq * (1.0 - rhrng) * kappa) \
        / torch.clamp(d * qc, min=1e-20)
    fcc = d * qc / (2.0 * spq * (1.0 - rhrng) * kappa) \
        * (-1.0 + torch.sqrt(1.0 + arg))
    return torch.where(qc > 1.0e-7, torch.clamp(fcc, 0.0, 1.0), 0.0)


def tompkins_cldfrac(qc, rh, p, ps):
    """Tompkins-style sigma-dependent critical RH
    (mod_cloud_tompkins.F90)."""
    rhrng = torch.clamp(rh, 0.001, 0.999)
    sig = p / ps[None]
    kappa = torch.clamp(0.9 * torch.abs(sig - 0.2) ** 0.2, min=0.0)
    rhcrit = 0.7 * sig * (1.0 - sig) * (1.85 + 0.95 * (sig - 0.5))
    fcc = 1.0 - torch.sqrt(torch.clamp(
        (1.0 - rhrng) / torch.clamp(1.0 - rhcrit
                                    - kappa * (rhrng - rhcrit), min=1e-10),
        min=0.0))
    fcc = torch.where(rhrng > rhcrit, fcc, 0.0)
    return torch.where(qc < 1.0e-7, 0.0, torch.clamp(fcc, 0.0, 1.0))


def echam5_cldfrac(qc, rh, p, ps):
    """ECHAM5 critical-RH Sundqvist form (mod_cloud_echam5.F90)."""
    ct, cs, nx = 0.35, 0.85, 4.0
    rhrng = torch.clamp(rh, 0.001, 0.999)
    sig = ps[None] / torch.clamp(p, min=1.0)
    rhcrit = ct + (ct - cs) * torch.exp(
        torch.clamp(1.0 - sig ** nx, -50.0, 50.0))
    fcc = 1.0 - torch.sqrt(torch.clamp(
        (1.0 - rhrng) / torch.clamp(1.0 - rhcrit, min=1e-10), min=0.0))
    fcc = torch.where(rhrng < rhcrit, 0.0,
                      torch.where(rhrng > 0.99999, 1.0, fcc))
    return torch.where(qc > 1.0e-7, torch.clamp(fcc, 0.0, 1.0), 0.0)


def cldfrac_dispatch(icldfrac, tb3, pb3, qvb3, qcb3, rh, qs, rh0, ps2d,
                     ds_km, landmask=None):
    """icldfrac dispatch (mod_micro_interface.F90:254-268)."""
    if icldfrac == 1:
        return xuran_cldfrac(pb3, qcb3, qvb3, qs, rh)
    if icldfrac == 2:
        rho = pb3 / (287.0 * tb3)
        z3 = torch.zeros_like(qcb3)
        return thomp_cldfrac(pb3, tb3, rho, qvb3, qcb3, z3, z3,
                             landmask if landmask is not None
                             else torch.ones_like(pb3[0]), ds_km)
    if icldfrac == 3:
        return gulisa_cldfrac(qvb3, qs, qcb3, ds_km)
    if icldfrac == 4:
        return texeira_cldfrac(qcb3, qs, rh)
    if icldfrac == 5:
        return tompkins_cldfrac(qcb3, rh, pb3, ps2d)
    if icldfrac == 6:
        return echam5_cldfrac(qcb3, rh, pb3, ps2d)
    return subex_cldfrac(tb3, pb3, qvb3, qcb3, rh, rh0)


def thomp_cldfrac(p, t, rho, qv, qc, qs, qi, landmask, gridkm):
    """Thompson scale-aware cloud fraction (icldfrac=2,
    Main/cloudlib/mod_cloud_thomp.F90:47-185): Mocko-Cotton/Sundqvist
    with grid-spacing-dependent RH thresholds (land vs ocean) and a
    liquid/ice-blended saturation; fractional clouds are removed above
    the diagnosed tropopause and below the well-mixed PBL top
    (find_cloudlayers cfr edits, :240-257). cfr is the sole output.

    Inputs (kz, iy, jx), k=0 at the model top; landmask 1=land."""
    kz = t.shape[0]
    tc = t - c.tzero
    # Flatau-style saturation polynomials of the reference (rslf/rsif)
    x = torch.clamp(tc, min=-80.0)
    esl = (0.611583699e3 + x * (0.444606896e2 + x * (0.143177157e1
           + x * (0.264224321e-1 + x * (0.299291081e-3
           + x * (0.203154182e-5 + x * (0.702620698e-8
           + x * (0.379534310e-11 + x * (-0.321582393e-13)))))))))
    esi = (0.609868993e3 + x * (0.499320233e2 + x * (0.184672631e1
           + x * (0.402737184e-1 + x * (0.565392987e-3
           + x * (0.521693933e-5 + x * (0.307839583e-7
           + x * (0.105785160e-9 + x * 0.161444444e-12))))))))
    qvsw = c.ep2 * esl / torch.clamp(p - esl, min=1.0)
    qvsi = c.ep2 * esi / torch.clamp(p - esi, min=1.0)
    qvsat = torch.where(tc >= -12.0, qvsw,
                        torch.where(tc < -30.0, qvsi,
                                    qvsw - (qvsw - qvsi) * (-12.0 - tc)
                                    / 18.0))
    rhum = torch.clamp(qv / qvsat, 0.0, 1.0)
    rh_00l = 0.839 + math.sqrt(1.0 / (50.0 + gridkm ** 3 * 0.5))
    rh_00o = 0.879 + math.sqrt(1.0 / (100.0 + gridkm ** 2))
    rh00 = torch.where(landmask[None] > 0.5, t.new_tensor(rh_00l), rh_00o)
    warm = torch.clamp(1.0 - torch.sqrt(
        torch.clamp(1.0 - rhum, min=0.0)
        / torch.clamp(1.0 - rh00, min=1e-10)), min=0.0)
    rhi_max = torch.maximum(rhum + 1e-6, qvsw / torch.clamp(qvsi, min=1e-12))
    cold = torch.clamp(((rh00 - rhum) / (rh00 - rhi_max)) ** 2, min=0.0)
    cfr = torch.where(tc >= -12.0, warm,
                      torch.where((tc > -70.0) & (rhum > rh_00o), cold,
                                  0.0))
    cfr = torch.clamp(cfr, 0.0, 1.0)
    cfr = torch.where(qc + qi > 1.0e-4, 1.0, cfr)

    # tropopause: topmost level (scanning up) where dθ/dz over 2 levels
    # < 10/1500 K/m within 4-19 km (find_cloudlayers :227-238)
    theta = t * (1.0e5 / p) ** c.rovcp
    ht = 44307.692 * (1.0 - (p / c.stdp) ** 0.190)
    dth = theta[:-2] - theta[2:]             # θ(k) − θ(k+2), k upper
    dht = ht[:-2] - ht[2:]
    grad = dth / torch.clamp(dht, min=1.0)
    is_tr = (grad < 10.0 / 1500.0) & (ht[2:] > 4000.0) \
        & (ht[2:] < 19000.0)
    dev = t.device
    karr = torch.arange(kz - 2, device=dev)[:, None, None]
    ktr = torch.amin(torch.where(is_tr, karr, kz), dim=0)
    kk = torch.arange(kz, device=dev)[:, None, None]
    frac = (cfr > 0.0) & (cfr < 0.999)
    cfr = torch.where((kk < ktr[None]) & frac, 0.0, cfr)

    # well-mixed PBL: zero fractional clouds below the first stable
    # layer above the surface (:248-257); stability dθ > 0.05e-3·dz
    dz = torch.cat([ht[:-1] - ht[1:], (ht[-2:-1] - ht[-1:])], dim=0)
    stab = (theta[:-1] - theta[1:]) > 0.05e-3 * dz[1:]
    m12 = tc > -12.0
    kar1 = torch.arange(kz - 1, device=dev)[:, None, None]
    kbot = torch.amax(torch.where(stab & m12[1:], kar1 + 1, 1), dim=0)
    cfr = torch.where((kk > kbot[None]) & frac, 0.0, cfr)
    return cfr
