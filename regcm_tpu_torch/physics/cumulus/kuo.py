"""Kuo cumulus scheme (icup=1), Anthes-Keyser/Kuo (1983), torch twin of
``regcm_tpu/physics/cumulus/kuo.py``.

``Main/cumlib/mod_cu_kuo.F90`` (``cupara`` :75-290) with the heating and
moisture-flux weight tables of ``Main/mod_params.F90:2217-2276`` (twght
and vqflx, parabolic in log sigma), built in numpy at construction.

Trigger: column moisture convergence (the coupled horizontal qv
advection tendency) above qdcrit in a conditionally unstable sounding
(the max-θe parcel below 700 hPa, its LCL, the cloud top where the
saturation θe exceeds the parcel's). The per-column (kbase, ktop) weight
profiles are a gather from the (kz, kz+1, kz+1) tables. The column
integrals run in level order (``level_sum``). Kuo is the one scheme that
changes the sigma-p cores: they hand it the qv vertical advection
instead of adding it (``PhysicsSuite.kuo_defer``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ...dynamics.hydrostatic import level_sum
from ...utils import constants as c

QDCRIT = 3.0e-7
PERT = 1.0
PERQ = 1.0e-3
DLT = 3.0
CDSCLD = 0.3
BFAC = 0.5
SVPT0 = c.tzero
SVP1, SVP2, SVP3 = 0.6112, 17.67, 29.65
VQRANG = 5.0e-4


def build_kuo_tables(sigma: np.ndarray, hsigma: np.ndarray,
                     dsigma: np.ndarray, ptop_cb: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """twght/vqflx tables (Main/mod_params.F90:2226-2276), numpy host."""
    kz = len(hsigma)
    twght = np.zeros((kz, kz + 1, kz + 1))     # [k, kbase, ktop] 1-based
    vqflx = np.zeros((kz, kz + 1, kz + 1))
    for kbase in range(5, kz + 1):
        for ktop in range(1, kbase - 2):
            bb = np.log(hsigma[ktop - 1]) + np.log(hsigma[kbase - 1])
            cc = np.log(hsigma[ktop - 1]) * np.log(hsigma[kbase - 1])
            ssum = 0.0
            for k in range(ktop, kbase + 1):
                xx = np.log(hsigma[k - 1])
                twght[k - 1, kbase, ktop] = xx * xx - bb * xx + cc
                ssum += twght[k - 1, kbase, ktop] * dsigma[k - 1]
            if abs(ssum) > 1e-30:    # ssum<0: signs cancel (ref :2244)
                twght[:, kbase, ktop] /= ssum
            twght[:ktop - 1, kbase, ktop] = 0.0
            twght[kbase:, kbase, ktop] = 0.0
            xtop = np.log((100.0 - ptop_cb) * sigma[ktop - 1] + ptop_cb)
            xbot = np.log((100.0 - ptop_cb) * sigma[kbase] + ptop_cb)
            bb = xtop + xbot
            cc = xtop * xbot
            wk = xtop * xtop - bb * xtop + cc
            qk = -(xbot * xbot - bb * xbot + cc)
            vqmax = 0.0
            for k in range(ktop, kbase + 1):
                xx = np.log((100.0 - ptop_cb) * sigma[k] + ptop_cb)
                yy = np.log((100.0 - ptop_cb)
                            * (sigma[ktop - 1] + sigma[kbase]
                               - sigma[k]) + ptop_cb)
                wkp1 = xx * xx - bb * xx + cc
                qkp1 = -(yy * yy - bb * yy + cc)
                vqflx[k - 1, kbase, ktop] = -(wkp1 * qkp1 - wk * qk) \
                    / dsigma[k - 1]
                vqmax = max(vqmax, abs(vqflx[k - 1, kbase, ktop]))
                wk, qk = wkp1, qkp1
            if vqmax > 0:
                vqflx[:, kbase, ktop] *= VQRANG / vqmax
    return twght, vqflx


class KuoOut(NamedTuple):
    tten: torch.Tensor      # decoupled K/s, (kz, iy, jx)
    qvten: torch.Tensor
    prate: torch.Tensor
    kbase: torch.Tensor
    ktop: torch.Tensor
    active: torch.Tensor


def kuo(t, qv, p_cb, psx_cb, qadv, sigma, hsigma, dsigma, twght, vqflx,
        ptop_cb, k700: int) -> KuoOut:
    """Kuo convection. t/qv/p (kz, …) top-down model order (index 0 =
    top); p in cb; qadv: COUPLED horizontal qv advection tendency
    (cb·kg/kg/s, the reference's qxten at the hadv-only stage,
    mod_cu_kuo.F90:96-106); psx_cb: full surface pressure in cb;
    twght/vqflx: tables [k, kbase, ktop] 1-based. tten/qvten come out
    divided by psx (ref :248-250): the caller recouples with p*."""
    kz = t.shape[0]
    grid_shape = t.shape[1:]
    dev = t.device
    kidx = torch.arange(1, kz + 1, device=dev)[:, None, None]  # 1-based
    ds3 = dsigma[:, None, None]
    hs3 = hsigma[:, None, None]

    sca = level_sum(qadv * ds3)
    trig = sca >= QDCRIT

    # parcel: max θe between k700 and the surface, with perturbations
    ttp = t + PERT
    q = qv + PERQ
    t1 = ttp * (100.0 / p_cb) ** c.rovcp
    ee = p_cb * q / (0.622 + q)
    tdpt = torch.minimum(1.0 / (1.0 / SVPT0 - c.rwat / c.wlhv
                                * torch.log(torch.clamp(ee, min=1e-10)
                                            / 0.611)), ttp)
    tlcl0 = tdpt - (0.212 + 1.571e-3 * (tdpt - SVPT0)
                    - 4.36e-4 * (ttp - SVPT0)) * (ttp - tdpt)
    eqt = t1 * torch.exp(c.wlhvocp * q / torch.clamp(tlcl0, min=150.0))
    eqt_m = torch.where(kidx >= k700, eqt, -1.0)
    kmax = torch.argmax(eqt_m, dim=0)[None]
    take = lambda a: torch.gather(a, 0, kmax)[0]
    eqtm = take(eqt_m)
    tmax = take(ttp)
    qmax = take(q)
    pmax = take(p_cb)

    # LCL (dew point / lapse construction, :125-140)
    emax = qmax * pmax / (c.ep2 + qmax)
    lem = torch.log(torch.clamp(emax, min=1e-10) / SVP1)
    tdmax = (SVP3 * lem - SVP2 * SVPT0) / (lem - SVP2)
    dalr = c.egrav * c.rcpd
    dplr = (c.egrav * tdmax ** 2) / (c.ep2 * c.wlhv * tmax)
    zlcl = torch.clamp((tmax - tdmax) / (dalr - dplr), min=0.0)
    tlcl = tmax - dalr * zlcl
    tmean = 0.5 * (tmax + tlcl)
    plcl = pmax * torch.exp(-(c.egrav * zlcl) / (c.rgas * tmean))
    siglcl = (plcl - ptop_cb) / psx_cb

    # kbase: the layer where the LCL sits (largest 1-based k with
    # hsigma <= siglcl)
    kbase = torch.where(hs3 <= siglcl[None], kidx, 1).amax(dim=0)
    kbase = torch.clamp(kbase, 5, kz)

    # saturation θe above the LCL
    ees = SVP1 * torch.exp(SVP2 * (t - SVPT0) / (t - SVP3))
    qs = c.ep2 * ees / torch.clamp(p_cb - ees, min=1e-3)
    seqt = (t * (100.0 / p_cb) ** c.rovcp) * torch.exp(c.wlhvocp * qs / t)
    # ktop: the deepest level at or above kbase where seqt - eqtm > dlt,
    # bounded to kbase-3
    over = (seqt - eqtm[None] > DLT) & (kidx <= kbase[None])
    ktop = torch.where(over, kidx, 0).amax(dim=0)
    ktop = torch.where(ktop == 0, 1, ktop)
    ktop = torch.minimum(ktop, torch.clamp(kbase - 3, min=1))

    hs_top = hsigma[ktop - 1]
    dsc = siglcl - hs_top
    deep = dsc >= CDSCLD

    incloud = (kidx >= ktop[None]) & (kidx <= kbase[None])
    ttsum = level_sum(torch.where(incloud, (eqtm[None] - seqt) * ds3, 0.0))
    unstable = ttsum >= 0.0
    active = trig & deep & unstable

    # Kuo partitioning (b factor) over [ktop, kz]
    lowcloud = kidx >= ktop[None]
    rh = torch.clamp(qv / qs, 0.0, 1.0)
    xsav = (1.0 - rh) * qs
    suma = level_sum(torch.where(lowcloud, xsav * ds3, 0.0))
    sumb = level_sum(torch.where(lowcloud, qs * ds3, 0.0))
    arh = level_sum(torch.where(lowcloud, rh * qs * ds3, 0.0)) \
        / torch.clamp(sumb, min=1e-10)
    c301 = torch.clamp(BFAC * (1.0 - arh), 0.0, 1.0)
    c301 = torch.where(suma <= 0.0, 0.0, c301)
    suma = torch.where(suma <= 0.0, 1.0, suma)
    qwght = torch.where(lowcloud, xsav / suma[None], 0.0)

    # the (kbase, ktop) weight profile of each column
    def gather_tab(tab):
        return tab[:, kbase.reshape(-1), ktop.reshape(-1)].reshape(
            (kz,) + tuple(grid_shape))

    tw = gather_tab(twght)
    vq = gather_tab(vqflx)
    sca_p = torch.clamp(sca, min=0.0)
    ttconv = c.wlhvocp * (1.0 - c301[None]) * tw * sca_p[None]
    apcnt = (1.0 - c301[None]) * sca_p[None] / 4.3e-3
    eddyf = apcnt * vq
    qvten = torch.where(incloud, c301[None] * qwght * sca_p[None] + eddyf,
                        0.0) / psx_cb[None]
    tten = torch.where(incloud, ttconv, 0.0) / psx_cb[None]
    prate = torch.clamp((1.0 - c301) * sca_p * 100.0 * c.regrav, min=0.0)

    am = active[None]
    return KuoOut(tten=torch.where(am, tten, 0.0),
                  qvten=torch.where(am, qvten, 0.0),
                  prate=torch.where(active, prate, 0.0),
                  kbase=kbase, ktop=ktop, active=active)
