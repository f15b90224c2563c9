"""Sea-ice surface scheme (iseaice=1), torch twin of
``regcm_tpu/physics/surface/seaice.py`` (``seaice``,
``Main/ocnlib/mod_ocn_bats.F90:105-319``, dispatched from ``vecocn``,
``mod_ocn_common.F90:62``).

Ocean points whose driving SST is at or below the freezing trigger
become ice points: BATS drag with a lead fraction, snow on the ice with
its age, conduction through ice and snow (Maykut-Untersteiner/Semtner
under snow, Slack 1980 bare), the ice thickness grown or melted, and
lead-weighted fluxes. Elementwise over the whole grid, masked. Packed
state (4, iy, jx): sfice (m), sncv (mm w.e.), snag (snow age),
tgrd_ice (ice surface temperature, K).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...utils import constants as c
from ...utils.thermo import pfqsat

ICETRIGGERT = 271.35       # icetriggert (Share/mod_constants)
ICEMINH = 0.01
AAREA = 0.02
AGE3 = 0.3
ZLND, ZSNO, ZOCE = 0.01, 0.00040, 0.00023
WTUR = 0.1
SHICE = 2.0e6              # sea-ice heat capacity per volume (J/m3/K)
CSNW = 0.49 * 4.186e6


class SeaIceOut(NamedTuple):
    ice: torch.Tensor       # packed (4, iy, jx) updated state
    tg: torch.Tensor
    sent: torch.Tensor
    evpr: torch.Tensor
    drag: torch.Tensor
    icemask: torch.Tensor   # 1 where the point is ice-covered


def seaice(tatm, qv, usw, vsw, zh, rhox, sfps, prcp, rswf, rlwf_up,
           sst, ice_in, ocnmask, dtocn):
    """One sea-ice step over the whole grid. rlwf_up net upward LW; sst
    the driving ocean temperature (tgb). Points without ice return
    zeros: blend with the open-ocean fluxes by ``icemask``."""
    sfice0, sncv0, snag0, tgrd0 = ice_in[0], ice_in[1], ice_in[2], \
        ice_in[3]
    # ice where the driving SST is below the trigger or ice is left
    icemask = (ocnmask < 0.5) & ((sst < ICETRIGGERT) | (sfice0 > ICEMINH))
    # surface temperature (:127-135)
    tgrd = torch.where(sst >= ICETRIGGERT, sst,
                       torch.where(tatm > ICETRIGGERT,
                                   torch.full_like(tatm, ICETRIGGERT),
                                   tatm - 0.01))
    tgrd = torch.where(sfice0 > ICEMINH, torch.minimum(tgrd, tgrd0), tgrd)
    tgbrd = torch.full_like(tgrd, ICETRIGGERT)
    # seed thickness of newly frozen points
    sfice = torch.where(icemask & (sfice0 <= ICEMINH), 2.0 * ICEMINH,
                        sfice0)

    delt = tatm - tgrd
    # snowfall on ice (:141-147)
    ps = torch.where(tatm < c.tzero, prcp, 0.0)
    sold = sncv0
    sncv = sncv0 + dtocn * ps
    # snow age (:149-166)
    arg = 5.0e3 * (1.0 / c.tzero - 1.0 / torch.clamp(tgrd, min=150.0))
    age1 = torch.exp(torch.clamp(arg, max=10.0))
    age2 = torch.exp(torch.clamp(10.0 * arg, -25.0, 0.0))
    dela = 1.0e-6 * dtocn * (age1 + age2 + AGE3)
    dels = 0.1 * torch.clamp(sncv - sold, min=0.0)
    snag = (snag0 + dela) * (1.0 - dels)
    snow_gone = sncv < c.dlowval
    sncv = torch.where(snow_gone, 0.0, sncv)
    snag = torch.where(snow_gone | (sncv > 800.0), 0.0, snag)
    age = 1.0 - 1.0 / (1.0 + snag)

    # drag over ice and leads (:169-204)
    cdrn = (c.vonkar / torch.log(zh / ZLND)) ** 2
    u1 = torch.where(delt < 0.0,
                     WTUR + 2.0 * torch.sqrt(torch.clamp(-delt, min=0.0)),
                     WTUR)
    ribd = usw ** 2 + vsw ** 2 + u1 ** 2
    vspda = torch.sqrt(ribd)
    br = zh * c.egrav * (delt / tatm) / ribd
    cdr = torch.where(br < 0.0,
                      cdrn * (1.0 + 24.5 * torch.sqrt(cdrn * torch.abs(br))),
                      cdrn / (1.0 + 11.5 * br))
    cdr = torch.maximum(cdr, torch.clamp(0.25 * cdrn, min=6.0e-4))
    rhosw3 = (0.10 * (1.0 + 3.0 * age)) ** 3
    cdrn_s = (c.vonkar / torch.log(zh / ZSNO)) ** 2
    ribl = (1.0 - ICETRIGGERT / tatm) * zh * c.egrav / ribd
    clead = torch.where(
        ribl < 0.0,
        cdrn_s * (1.0 + 24.5 * torch.sqrt(cdrn_s * torch.abs(ribl))),
        cdrn_s / (1.0 + 11.5 * br))
    cdrx = (1.0 - AAREA) * cdr + AAREA * clead
    drag = cdrx * vspda * rhox

    # conduction through ice and snow (:210-228)
    qs = qv / (1.0 + qv)
    sficemm = torch.clamp(sfice, min=ICEMINH) * 1000.0
    rsd1 = SHICE * sficemm * 1e-3
    qgrd_i = pfqsat(torch.full_like(tgrd, ICETRIGGERT), sfps)
    snowy = sncv > 0.0
    rsd1 = torch.where(snowy, rsd1 + CSNW * sncv * 1e-3, rsd1)
    rsi = 1.4 * rhosw3 * sficemm / torch.clamp(sncv, min=c.dlowval)
    ksnow = 7.0e-4 * rhosw3 / torch.clamp(sncv, min=c.dlowval)
    fss = torch.where(snowy,
                      ksnow * (tgbrd - tgrd) / (1.0 + rsi),
                      2.14 * (tgbrd - tgrd) / sficemm)
    # ice growth from the conductive flux (:229-231)
    sfice = torch.where(icemask,
                        (sficemm + 1.087 * (fss / c.wlhf) * dtocn) * 1e-3,
                        sfice)

    melted = sfice <= ICEMINH
    # thin ice: open-water fluxes at the SST (:233-247)
    qgrd_w = pfqsat(sst, sfps)
    delq_w = qs - qgrd_w
    delt_w = tatm - sst
    evpr_thin = torch.clamp(-drag * delq_w, min=0.0)
    sent_thin = -drag * c.cpd * delt_w

    # thick ice: lead-weighted fluxes (:248-300)
    qice = qgrd_i
    qgrnd = ((1.0 - AAREA) * cdr * qgrd_i + AAREA * clead * qice) / cdrx
    tgrnd = ((1.0 - AAREA) * cdr * tgrd
             + AAREA * clead * ICETRIGGERT) / cdrx
    delt_i = tatm - tgrnd
    delq_i = qs - qgrnd
    evpr_ice = torch.clamp(-drag * delq_i, min=0.0)
    live = icemask & ~melted
    sncv = torch.where(live, torch.clamp(sncv - dtocn * evpr_ice, min=0.0),
                       sncv)
    sent_ice = -drag * c.cpd * delt_i
    hrl = rhox * vspda * clead * (qice - qs)
    hsl = rhox * vspda * clead * (ICETRIGGERT - tatm) * c.cpd
    fseng = (sent_ice - AAREA * hsl) / (1.0 - AAREA)
    fevpg = (evpr_ice - AAREA * hrl) / (1.0 - AAREA)
    hs = rswf - rlwf_up - fseng - c.wlhs * fevpg
    bb = dtocn * (hs + fss) / rsd1
    # snowmelt (:304-310)
    sm = torch.where(tgrd >= c.tzero,
                     torch.clamp((hs + fss) / c.wlhf, min=0.0), 0.0)
    sm = torch.minimum(sm, sncv / dtocn)
    sncv_new = torch.clamp(sncv - sm * dtocn, min=0.0)
    # surface temperature, capped at freezing (:332-336)
    tg_new = torch.clamp(tgrd + bb, max=ICETRIGGERT)
    sncv = torch.where(live, sncv_new, sncv)
    tgrd = torch.where(live, tg_new, tgrd)
    # melted-out points go back to the SST and open water
    sncv = torch.where(melted, 0.0, sncv)
    snag = torch.where(melted, 0.0, snag)
    sfice = torch.where(melted, 0.0, sfice)
    tgrd = torch.where(melted, sst, tgrd)

    sent = torch.where(melted, sent_thin, sent_ice)
    evpr = torch.where(melted, evpr_thin, evpr_ice)
    sent = torch.where(torch.abs(sent) < c.dlowval, 0.0, sent)

    m = icemask
    ice_out = torch.stack([
        torch.where(m, sfice, 0.0), torch.where(m, sncv, 0.0),
        torch.where(m, snag, 0.0), torch.where(m, tgrd, ICETRIGGERT)])
    return SeaIceOut(
        ice=ice_out,
        tg=torch.where(m, tgrd, sst),
        sent=torch.where(m, sent, 0.0),
        evpr=torch.where(m, evpr, 0.0),
        drag=torch.where(m, drag, 0.0),
        icemask=m.to(tatm.dtype))
