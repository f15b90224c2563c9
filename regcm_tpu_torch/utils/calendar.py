"""Model calendar & date arithmetic.

Re-implements the reference date system (``Share/mod_date.F90:42-83``,
types ``rcm_time_and_date`` / ``rcm_time_interval``) with the same three
calendars: ``gregorian``, ``noleap`` (365-day) and ``360_day``. Dates are
host-side objects (never traced); the jitted step loop only sees elapsed
seconds and precomputed orbital parameters.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

GREGORIAN = "gregorian"
NOLEAP = "noleap"
Y360 = "360_day"

_MLEN = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
_MLEN_CUM = [0]
for _m in _MLEN:
    _MLEN_CUM.append(_MLEN_CUM[-1] + _m)


def is_leap(year: int) -> bool:
    return year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)


def days_in_month(year: int, month: int, calendar: str = GREGORIAN) -> int:
    if calendar == Y360:
        return 30
    if month == 2 and calendar == GREGORIAN and is_leap(year):
        return 29
    return _MLEN[month - 1]


def days_in_year(year: int, calendar: str = GREGORIAN) -> int:
    if calendar == Y360:
        return 360
    if calendar == NOLEAP:
        return 365
    return 366 if is_leap(year) else 365


def _greg_days_from_civil(y: int, m: int, d: int) -> int:
    """Days since 1970-01-01 (proleptic Gregorian, Howard Hinnant algo)."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _greg_civil_from_days(z: int) -> Tuple[int, int, int]:
    z += 719468
    era = (z if z >= 0 else z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + (3 if mp < 10 else -9)
    return y + (m <= 2), m, d


@dataclass(frozen=True, order=False)
class Date:
    """A calendar-aware timestamp (second resolution)."""
    year: int
    month: int = 1
    day: int = 1
    hour: int = 0
    minute: int = 0
    second: int = 0
    calendar: str = GREGORIAN

    # -- construction ----------------------------------------------------
    @classmethod
    def from_int(cls, val: int, calendar: str = GREGORIAN) -> "Date":
        """Parse reference-style integer dates: yyyymmddhh (10 digits) or
        yyyymmdd (8 digits), e.g. 1990060100 (restartparam mdate values)."""
        s = str(val)
        if len(s) == 10:
            return cls(int(s[0:4]), int(s[4:6]), int(s[6:8]), int(s[8:10]),
                       calendar=calendar)
        if len(s) == 8:
            return cls(int(s[0:4]), int(s[4:6]), int(s[6:8]),
                       calendar=calendar)
        raise ValueError(f"cannot parse date integer {val!r}")

    def to_int(self) -> int:
        return (self.year * 1000000 + self.month * 10000
                + self.day * 100 + self.hour)

    # -- epoch arithmetic ------------------------------------------------
    def _days_since_epoch(self) -> int:
        if self.calendar == GREGORIAN:
            return _greg_days_from_civil(self.year, self.month, self.day)
        if self.calendar == NOLEAP:
            return (self.year - 1970) * 365 + _MLEN_CUM[self.month - 1] + \
                (self.day - 1)
        if self.calendar == Y360:
            return (self.year - 1970) * 360 + (self.month - 1) * 30 + \
                (self.day - 1)
        raise ValueError(f"unknown calendar {self.calendar}")

    def to_seconds(self) -> int:
        """Seconds since 1970-01-01 00:00 in this calendar."""
        return (self._days_since_epoch() * 86400 + self.hour * 3600
                + self.minute * 60 + self.second)

    @classmethod
    def from_seconds(cls, secs: int, calendar: str = GREGORIAN) -> "Date":
        days, rem = divmod(int(secs), 86400)
        hh, rem = divmod(rem, 3600)
        mm, ss = divmod(rem, 60)
        if calendar == GREGORIAN:
            y, mo, d = _greg_civil_from_days(days)
        elif calendar == NOLEAP:
            y, rem_d = 1970 + days // 365, days % 365
            mo = 1
            while rem_d >= _MLEN_CUM[mo]:
                mo += 1
            d = rem_d - _MLEN_CUM[mo - 1] + 1
        elif calendar == Y360:
            y, rem_d = 1970 + days // 360, days % 360
            mo, d = rem_d // 30 + 1, rem_d % 30 + 1
        else:
            raise ValueError(f"unknown calendar {calendar}")
        return cls(y, mo, d, hh, mm, ss, calendar)

    # -- operators -------------------------------------------------------
    def add_seconds(self, secs: float) -> "Date":
        return Date.from_seconds(self.to_seconds() + int(round(secs)),
                                 self.calendar)

    def add_hours(self, hours: float) -> "Date":
        return self.add_seconds(hours * 3600.0)

    def __sub__(self, other: "Date") -> float:
        """Difference in seconds."""
        assert self.calendar == other.calendar
        return float(self.to_seconds() - other.to_seconds())

    def __lt__(self, o):
        return self.to_seconds() < o.to_seconds()

    def __le__(self, o):
        return self.to_seconds() <= o.to_seconds()

    # -- astronomy helpers ----------------------------------------------
    def day_of_year(self) -> int:
        if self.calendar == Y360:
            return (self.month - 1) * 30 + self.day
        doy = _MLEN_CUM[self.month - 1] + self.day
        if (self.calendar == GREGORIAN and self.month > 2
                and is_leap(self.year)):
            doy += 1
        return doy

    def year_fraction(self) -> float:
        """Fractional day-of-year including time of day (for solar decl)."""
        frac = (self.hour * 3600 + self.minute * 60 + self.second) / 86400.0
        return self.day_of_year() + frac

    def __str__(self):
        return (f"{self.year:04d}-{self.month:02d}-{self.day:02d} "
                f"{self.hour:02d}:{self.minute:02d}:{self.second:02d} "
                f"UTC ({self.calendar})")


def hours_between(d1: Date, d2: Date) -> float:
    return (d2 - d1) / 3600.0
