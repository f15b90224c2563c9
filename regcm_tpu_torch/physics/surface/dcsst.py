"""Diurnal cycle of SST (idcsst=1), torch twin of
``regcm_tpu/physics/surface/dcsst.py``: the Zeng & Beljaars (2005)
prognostic skin temperature of the Zeng ocean-flux driver
(``Main/ocnlib/mod_ocn_zeng.F90:293-377``).

A warm layer between the 3 m bulk SST and the sublayer top, heated by
the solar absorption in the layer (3-exponential transmission) and
mixed by Monin-Obukhov-stable turbulence, then a molecular cool-skin
correction gives the skin temperature. Packed state (3, iy, jx):
deltas (cool-skin thickness, m), tdeltas (warm-layer top T, K), tskin.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ...utils import constants as c

A1, A2, A3 = 0.28, 0.27, 0.45
B1, B2, B3 = 71.5, 2.8, 0.07
ALPHAW = 0.207e-06       # thermal expansion of water
NUW = 1.004e-06          # kinematic viscosity of water
KW = 0.60                # thermal conductivity of water
NU = 0.3                 # warm-layer profile exponent
DD = 3.0                 # bulk SST reference depth (m)
CPW0 = 4190.0            # specific heat of sea water


class DcsstOut(NamedTuple):
    dcsst: torch.Tensor     # packed (3, iy, jx) updated state
    tskin: torch.Tensor     # skin temperature, the ocean Tg


def dcsst(sst_bulk, swabs, lwnet_up, hfx, qfx, ustar_air, rhox,
          state_in, ocnmask, dtsst):
    """One skin-temperature step (mod_ocn_zeng.F90:293-377).

    sst_bulk the driving (3 m) SST; swabs net absorbed SW (W/m2);
    lwnet_up net upward LW; hfx, qfx sensible flux (W/m2, +up) and
    evaporation (kg/m2/s); ustar_air the air-side friction velocity."""
    deltas0 = torch.clamp(state_in[0], min=1.0e-6)
    tdeltas0 = state_in[1]
    td = sst_bulk
    # first step: tdeltas is 0, start at the bulk SST
    tdelta = torch.where(tdeltas0 > 100.0, tdeltas0, td)
    delta = torch.where(state_in[0] > 0.0, deltas0, 0.001)

    rs = swabs
    rd = rs * (A1 * math.exp(-DD * B1) + A2 * math.exp(-DD * B2)
               + A3 * math.exp(-DD * B3))
    ustarw = 0.5 * ustar_air * torch.sqrt(rhox / c.rhoh2o)
    ustarw = torch.clamp(ustarw, min=1.0e-5)
    lh = qfx * c.wlhv
    q = -(lh + hfx + lwnet_up)
    fs = 0.065 + 11.0 * delta - (6.6e-5 / delta) \
        * (1.0 - torch.exp(-delta / 8.0e-4))
    dts = tdelta - td
    fd = torch.where(
        dts > 0.0,
        math.sqrt(NU * c.egrav * ALPHAW / (5.0 * DD)) * c.rhoh2o
        * CPW0 * ustarw ** 2 * torch.sqrt(torch.clamp(dts, min=0.0)),
        c.egrav * ALPHAW * (q + rs - rd))
    lmo = c.rhoh2o * CPW0 * ustarw ** 3 \
        / (c.vonkar * torch.where(torch.abs(fd) < 1e-12, 1e-12, fd))
    dol = DD / lmo
    phidl = torch.where(fd > 0.0,
                        torch.where(dol >= 0.0, 1.0 + 5.0 * dol,
                                    (1.0 - 16.0 * dol) ** -0.5),
                        1.0)
    aa = (q + rs - rd) / (DD * CPW0 * c.rhoh2o * NU / (NU + 1.0))
    bb = (NU + 1.0) * c.vonkar * ustarw / (DD * phidl)
    dtstend = aa - dts * (1.0 - torch.exp(-bb * dtsst)) / dtsst
    dts = dts + dtstend * dtsst
    tdelta = dts + td
    # cool-skin correction
    aa2 = -16.0 * c.egrav * ALPHAW * c.rhoh2o * CPW0 * NUW ** 3 \
        / (ustarw ** 4 * KW ** 2)
    qfs = q + rs * fs
    cool = aa2 * qfs > 0.0
    lamb = 6.0 * (1.0 + torch.clamp(aa2 * qfs, min=0.0) ** 0.75) \
        ** (-1.0 / 3.0)
    delta_new = torch.where(cool, lamb * NUW / ustarw, delta)
    tskin = torch.where(cool,
                        delta_new / (c.rhoh2o * CPW0 * KW) * qfs + tdelta,
                        tdelta)
    m = ocnmask < 0.5
    out = torch.stack([
        torch.where(m, delta_new, 0.0),
        torch.where(m, tdelta, 0.0),
        torch.where(m, tskin, sst_bulk)])
    return DcsstOut(dcsst=out, tskin=torch.where(m, tskin, sst_bulk))
