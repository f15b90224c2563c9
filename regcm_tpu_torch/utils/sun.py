"""Solar geometry: Berger orbital parameters, declination, zenith
angle, eccentricity factor and total solar irradiance.

Host-side equivalent of ``Main/mod_sun.F90`` (``solar1`` :258,
``zenitm`` :303, ``solar_irradiance`` :346) and
``Share/mod_sunorbit.F90`` (``orb_params`` :85, ``orb_decl`` :496).
The Berger (1978) trigonometric-series coefficients and the Lean TSI
reconstruction table live in ``_solar_data.py`` (generated).  The
Spencer (1971) Fourier fits are kept as a light fallback.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np

from .calendar import Date, days_in_year, is_leap, days_in_month
from .constants import degrad


def declination(date: Date) -> float:
    """Solar declination (radians), Spencer series."""
    ndays = days_in_year(date.year, date.calendar)
    frac = (date.year_fraction() - 1.0) / ndays
    th = 2.0 * np.pi * frac
    return (0.006918 - 0.399912 * np.cos(th) + 0.070257 * np.sin(th)
            - 0.006758 * np.cos(2 * th) + 0.000907 * np.sin(2 * th)
            - 0.002697 * np.cos(3 * th) + 0.001480 * np.sin(3 * th))


def eccentricity_factor(date: Date) -> float:
    """(r0/r)^2 solar distance factor."""
    ndays = days_in_year(date.year, date.calendar)
    th = 2.0 * np.pi * (date.year_fraction() - 1.0) / ndays
    return (1.000110 + 0.034221 * np.cos(th) + 0.001280 * np.sin(th)
            + 0.000719 * np.cos(2 * th) + 0.000077 * np.sin(2 * th))


def coszrs(date: Date, xlat: np.ndarray, xlon: np.ndarray,
           decl: float | None = None) -> np.ndarray:
    """Cosine of solar zenith angle, clipped at 0 (zenitm,
    Main/mod_sun.F90:303-360).  ``decl`` overrides the Spencer-series
    declination with an orbital (Berger) value when provided."""
    if decl is None:
        decl = declination(date)
    gmt_hours = date.hour + date.minute / 60.0 + date.second / 3600.0
    # hour angle: local solar time relative to solar noon
    ha = (gmt_hours / 24.0 * 2.0 * np.pi + xlon * degrad) - np.pi
    mu = (np.sin(xlat * degrad) * np.sin(decl)
          + np.cos(xlat * degrad) * np.cos(decl) * np.cos(ha))
    return np.maximum(mu, 0.0)


# ---------------------------------------------------------------------------
# Berger (1978) orbital parameters (Share/mod_sunorbit.F90)
# ---------------------------------------------------------------------------

_PSECDEG = 1.0 / 3600.0         # arc seconds → degrees


class OrbitParams(NamedTuple):
    eccen: float    # orbital eccentricity
    obliqr: float   # obliquity (radians)
    lambm0: float   # mean longitude of perihelion at vernal equinox (rad)
    mvelpp: float   # moving vernal equinox long. of perihelion + pi (rad)


@lru_cache(maxsize=32)
def orb_params(iyear_ad: int) -> OrbitParams:
    """Berger (1978) series for eccentricity, obliquity and longitude
    of perihelion for the given year AD (orb_params,
    Share/mod_sunorbit.F90:85-489)."""
    from . import _solar_data as sd
    years = float(iyear_ad) - 1950.0
    dr = degrad

    obsum = np.sum(sd.OBAMP * _PSECDEG * np.cos(
        (sd.OBRATE * _PSECDEG * years + sd.OBPHAS) * dr))
    obliq = 23.320556 + obsum

    arg = (sd.ECRATE * _PSECDEG * years + sd.ECPHAS) * dr
    cossum = float(np.sum(sd.ECAMP * np.cos(arg)))
    sinsum = float(np.sum(sd.ECAMP * np.sin(arg)))
    eccen2 = cossum * cossum + sinsum * sinsum
    eccen = np.sqrt(eccen2)
    eccen3 = eccen2 * eccen

    # fixed vernal-equinox longitude of perihelion (radians), with the
    # reference's quadrant cases
    if abs(cossum) <= 1.0e-8:
        fvelp = 0.0 if sinsum == 0.0 else \
            (1.5 * np.pi if sinsum < 0.0 else 0.5 * np.pi)
    elif cossum < 0.0:
        fvelp = np.arctan(sinsum / cossum) + np.pi
    elif sinsum < 0.0:
        fvelp = np.arctan(sinsum / cossum) + 2.0 * np.pi
    else:
        fvelp = np.arctan(sinsum / cossum)

    mvsum = np.sum(sd.MVAMP * _PSECDEG * np.sin(
        (sd.MVRATE * _PSECDEG * years + sd.MVPHAS) * dr))
    mvelp = fvelp / dr + 50.439273 * _PSECDEG * years + 3.392506 + mvsum
    mvelp = mvelp % 360.0

    obliqr = obliq * dr
    mvelpp = (mvelp + 180.0) * dr
    beta = np.sqrt(1.0 - eccen2)
    lambm0 = 2.0 * ((0.5 * eccen + 0.125 * eccen3) * (1.0 + beta)
                    * np.sin(mvelpp)
                    - 0.25 * eccen2 * (0.5 + beta)
                    * np.sin(2.0 * mvelpp)
                    + 0.125 * eccen3 * (1.0 / 3.0 + beta)
                    * np.sin(3.0 * mvelpp))
    return OrbitParams(float(eccen), float(obliqr), float(lambm0),
                       float(mvelpp))


def _calendar_consts(calendar: str):
    """(days per year, vernal equinox day) per calendar
    (Share/mod_dynparam.F90:689-698)."""
    cal = (calendar or "gregorian").lower()
    if cal in ("gregorian", "standard", "proleptic_gregorian"):
        return 365.2422, 80.447
    if cal in ("noleap", "365_day"):
        return 365.0, 80.50
    return 360.0, 81.618      # 360_day


def yearpoint(date: Date) -> float:
    """Day-of-year with the reference's Gregorian leap-cycle shift
    (yearpoint, Share/mod_date.F90:1930-1962)."""
    cal = (date.calendar or "gregorian").lower()
    if cal in ("gregorian", "standard", "proleptic_gregorian"):
        yp = float(date.day + sum(days_in_month(date.year, m, "gregorian")
                                  for m in range(1, date.month)))
        if is_leap(date.year):
            lc = -(yp + 1095.0) / 1461.0
        elif is_leap(date.year + 1):
            lc = -(yp + 730.0) / 1461.0
        elif is_leap(date.year + 2):
            lc = -(yp + 365.0) / 1461.0
        else:
            lc = -yp / 1461.0
        return yp + lc
    if cal in ("noleap", "365_day"):
        return float(date.day + sum(
            days_in_month(date.year, m, "noleap")
            for m in range(1, date.month)))
    return float(date.day + 30 * (date.month - 1))


def orb_decl(calday: float, orb: OrbitParams, calendar: str = "gregorian"
             ) -> tuple:
    """Solar declination (rad) and eccentricity factor (1/r)^2 from the
    Berger formulas (orb_decl, Share/mod_sunorbit.F90:496-547)."""
    dayspy, veday = _calendar_consts(calendar)
    lambm = orb.lambm0 + (calday - veday) * 2.0 * np.pi / dayspy
    lmm = lambm - orb.mvelpp
    e = orb.eccen
    sinl = np.sin(lmm)
    lamb = lambm + e * (2.0 * sinl + e * (1.25 * np.sin(2.0 * lmm)
                        + e * ((13.0 / 12.0) * np.sin(3.0 * lmm)
                               - 0.25 * sinl)))
    invrho = (1.0 + e * np.cos(lamb - orb.mvelpp)) / (1.0 - e * e)
    delta = np.arcsin(np.sin(orb.obliqr) * np.sin(lamb))
    eccf = invrho * invrho
    return float(delta), float(eccf)


_TSIFAC = 0.9965                 # Main/mod_sun.F90:40


def solar_irradiance(date: Date, isolconst: int = 0) -> float:
    """Total solar irradiance (W/m²) from the Lean reconstruction
    table with the reference's year-interpolation and out-of-range
    11/12-year cycling (solar_irradiance, Main/mod_sun.F90:346-384)."""
    if isolconst == 1:
        return 1367.0
    from . import _solar_data as sd
    dayspy, _ = _calendar_consts(date.calendar)
    calday = yeardayfrac(date)
    if calday > dayspy / 2.0:
        w2 = calday / dayspy - 0.5
        w1 = 1.0 - w2
        iyear = date.year
    else:
        w1 = 0.5 - calday / dayspy
        w2 = 1.0 - w1
        iyear = date.year - 1
    iidate = date.year * 10000 + date.month * 100 + date.day
    if iidate > 20080630:
        iyear = date.year % 12 + 1996
    if iidate < 16100101:
        iyear = 1610 + date.year % 12
    i0 = iyear - sd.TSI_YEAR0
    i0 = min(max(i0, 0), sd.TSI_TABLE.shape[0] - 2)
    return float(_TSIFAC * (w1 * sd.TSI_TABLE[i0, 2]
                            + w2 * sd.TSI_TABLE[i0 + 1, 2]))


def yeardayfrac(date: Date) -> float:
    """Fractional day-of-year counted from 0.0 (yeardayfrac,
    Share/mod_date.F90:1965-1975)."""
    return (float(date.day_of_year()) + date.hour / 24.0
            + date.minute / 1440.0 + date.second / 86400.0 - 1.0)


class SolarState(NamedTuple):
    """Per-step solar forcing (solar1 + solar_irradiance outputs)."""
    declin: float    # solar declination (rad)
    eccf: float      # (1/r)^2 eccentricity factor
    solcon: float    # TSI (W/m²)


def solar_state(date: Date, year_offset: int = 0, ifixsolar: int = 0,
                fixedsolarval: float = 343.0, isolconst: int = 0
                ) -> SolarState:
    """Full solar forcing for a model date (solar1 + zenitm preamble,
    Main/mod_sun.F90:258-330)."""
    if ifixsolar == 1:
        return SolarState(0.0, 1.0, float(fixedsolarval))
    orb = orb_params(date.year + int(year_offset))
    declin, eccf = orb_decl(yearpoint(date), orb, date.calendar)
    solcon = solar_irradiance(date, isolconst)
    return SolarState(declin, eccf, solcon)
