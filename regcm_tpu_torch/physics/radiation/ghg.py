"""GHG scenario concentrations (``set_scenario``/``cgas``,
``Main/mpplib/mod_ipcc_scenario.F90:216-1789``).

The reference embeds per-year 1850-2100 tables per scenario; here the
same public concentration records (IPCC AR5 / Meinshausen et al. 2011
RCP database) are stored at node years and interpolated linearly —
accurate to ~1 ppm for CO2, well below the broadband scheme's
sensitivity. Scenario naming follows the reference (RCP2.6/RCP4.5/
RCP6.0/RCP8.5, 'CONST' pinned at ghg_year_const); AR6 SSP names are
mapped to the closest RCP trajectory.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# node years → (CO2 ppm, CH4 ppb, N2O ppb); historical to 2005
_HIST = {
    1850: (284.7, 791.6, 275.7),
    1875: (288.7, 828.6, 277.8),
    1900: (295.8, 879.4, 279.6),
    1925: (305.0, 1000.0, 285.0),
    1950: (311.3, 1147.0, 290.0),
    1960: (316.6, 1240.0, 293.0),
    1970: (325.0, 1386.0, 296.0),
    1980: (338.4, 1547.0, 302.0),
    1990: (353.9, 1694.0, 308.0),
    2000: (368.9, 1751.0, 316.0),
    2005: (378.8, 1754.0, 319.0),
}

_RCP: Dict[str, Dict[int, Tuple[float, float, float]]] = {
    "RCP2.6": {
        2010: (389.0, 1779.0, 323.0), 2020: (412.0, 1731.0, 329.0),
        2030: (431.0, 1600.0, 335.0), 2040: (440.0, 1527.0, 339.0),
        2050: (443.0, 1452.0, 342.0), 2060: (442.0, 1365.0, 343.0),
        2070: (437.0, 1311.0, 344.0), 2080: (431.0, 1285.0, 344.0),
        2090: (426.0, 1268.0, 344.0), 2100: (421.0, 1254.0, 344.0),
    },
    "RCP4.5": {
        2010: (389.0, 1801.0, 323.0), 2020: (411.0, 1801.0, 329.0),
        2030: (435.0, 1830.0, 336.0), 2040: (461.0, 1842.0, 344.0),
        2050: (487.0, 1833.0, 351.0), 2060: (509.0, 1767.0, 357.0),
        2070: (524.0, 1687.0, 362.0), 2080: (531.0, 1619.0, 366.0),
        2090: (534.0, 1593.0, 369.0), 2100: (538.0, 1576.0, 372.0),
    },
    "RCP6.0": {
        2010: (389.0, 1805.0, 323.0), 2020: (409.0, 1826.0, 328.0),
        2030: (429.0, 1858.0, 333.0), 2040: (450.0, 1881.0, 341.0),
        2050: (478.0, 1895.0, 355.0), 2060: (510.0, 1880.0, 367.0),
        2070: (550.0, 1842.0, 378.0), 2080: (595.0, 1783.0, 388.0),
        2090: (635.0, 1713.0, 398.0), 2100: (670.0, 1649.0, 406.0),
    },
    "RCP8.5": {
        2010: (389.0, 1846.0, 323.0), 2020: (415.0, 1924.0, 331.0),
        2030: (449.0, 2132.0, 339.0), 2040: (489.0, 2399.0, 349.0),
        2050: (541.0, 2740.0, 367.0), 2060: (604.0, 3076.0, 381.0),
        2070: (677.0, 3322.0, 395.0), 2080: (758.0, 3517.0, 409.0),
        2090: (845.0, 3652.0, 422.0), 2100: (936.0, 3751.0, 435.0),
    },
}

# CFC-11 / CFC-12 (ppt) — Montreal-Protocol trajectory shared by all
# RCPs within the broadband scheme's sensitivity (WMO ozone assessment
# / Meinshausen et al. 2011 ODS record): growth to mid-90s peaks
# (CFC-11 ≈ 270 ppt 1994, CFC-12 ≈ 545 ppt 2003), slow decline after
_CFC = {
    1850: (0.0, 0.0), 1940: (0.0, 0.2), 1950: (1.0, 6.0),
    1960: (9.0, 30.0), 1970: (60.0, 120.0), 1980: (162.0, 297.0),
    1990: (255.0, 465.0), 1995: (268.0, 520.0), 2000: (263.0, 537.0),
    2005: (253.0, 543.0), 2010: (240.0, 531.0), 2020: (220.0, 498.0),
    2030: (193.0, 453.0), 2040: (166.0, 405.0), 2050: (141.0, 358.0),
    2070: (99.0, 272.0), 2100: (55.0, 178.0),
}

# AR6 SSP names → closest AR5 RCP trajectory
_SSP_MAP = {
    "SSP119": "RCP2.6", "SSP126": "RCP2.6", "SSP245": "RCP4.5",
    "SSP370": "RCP6.0", "SSP460": "RCP6.0", "SSP585": "RCP8.5",
}


def _normalize(scenario: str) -> str:
    s = scenario.strip().upper().replace(" ", "")
    aliases = {"RCP26": "RCP2.6", "RCP3PD": "RCP2.6", "RCP45": "RCP4.5",
               "RCP60": "RCP6.0", "RCP6": "RCP6.0", "RCP85": "RCP8.5",
               "RF": "RCP4.5", "A1B": "RCP6.0", "A2": "RCP8.5",
               "B1": "RCP4.5", "B2": "RCP6.0"}
    s = aliases.get(s, s)
    return _SSP_MAP.get(s, s)


def ghg_concentrations(scenario: str, year: float,
                       ghg_year_const: int = 1950
                       ) -> Dict[str, float]:
    """(co2 ppm, ch4 ppb, n2o ppb) for a scenario at a fractional year.

    'CONST' pins to ghg_year_const (mod_params.F90:259-260 defaults).
    """
    s = _normalize(scenario)
    if s == "CONST":
        year = float(ghg_year_const)
        s = "RCP4.5"          # historical record; any RCP works pre-2005
    table = dict(_HIST)
    table.update(_RCP.get(s, _RCP["RCP4.5"]))
    years = np.array(sorted(table))
    vals = np.array([table[y] for y in years])   # (n, 3)
    y = float(np.clip(year, years[0], years[-1]))
    co2 = float(np.interp(y, years, vals[:, 0]))
    ch4 = float(np.interp(y, years, vals[:, 1]))
    n2o = float(np.interp(y, years, vals[:, 2]))
    cyears = np.array(sorted(_CFC))
    cvals = np.array([_CFC[cy] for cy in cyears])
    cfc11 = float(np.interp(y, cyears, cvals[:, 0]))
    cfc12 = float(np.interp(y, cyears, cvals[:, 1]))
    return {"co2ppm": co2, "ch4ppb": ch4, "n2oppb": n2o,
            "cfc11ppt": cfc11, "cfc12ppt": cfc12}
