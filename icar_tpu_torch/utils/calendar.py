"""Copy of icar_tpu/utils/calendar.py, kept identical by tests/test_torch_setup.py.

Calendar / model-time objects.

Host-side replacement for the reference time objects
(src/utilities/time_h.f90, time_obj.f90, time_delta_obj.f90):
``Time`` supports GREGORIAN / NOLEAP / 360-day calendars with MJD-style
arithmetic, comparison operators, ``as_string`` and day-of-year helpers used
by the simple radiation scheme (time_obj.f90:404-487).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from functools import total_ordering

GREGORIAN = "gregorian"
NOLEAP = "noleap"
THREESIXTY = "360-day"

_CALENDAR_ALIASES = {
    "gregorian": GREGORIAN, "standard": GREGORIAN, "proleptic_gregorian": GREGORIAN,
    "noleap": NOLEAP, "365-day": NOLEAP, "365_day": NOLEAP,
    "360-day": THREESIXTY, "360_day": THREESIXTY, "360day": THREESIXTY,
}

_DAYS_PER_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)
_SECONDS_PER_DAY = 86400.0


def normalize_calendar(name: str) -> str:
    key = name.strip().lower()
    if key not in _CALENDAR_ALIASES:
        raise ValueError(f"unknown calendar: {name!r}")
    return _CALENDAR_ALIASES[key]


def _is_leap(year: int) -> bool:
    return (year % 4 == 0 and year % 100 != 0) or (year % 400 == 0)


def _days_in_month(year: int, month: int, calendar: str) -> int:
    if calendar == THREESIXTY:
        return 30
    d = _DAYS_PER_MONTH[month - 1]
    if calendar == GREGORIAN and month == 2 and _is_leap(year):
        d += 1
    return d


def date_to_mjd(year, month, day, hour=0, minute=0, second=0.0,
                calendar: str = GREGORIAN) -> float:
    """Days since the modified-Julian-date epoch (1858-11-17 for gregorian;
    days since year 0 for the idealized calendars, matching time_obj.f90)."""
    calendar = normalize_calendar(calendar)
    frac = (hour * 3600.0 + minute * 60.0 + second) / _SECONDS_PER_DAY
    if calendar == GREGORIAN:
        a = (14 - month) // 12
        y = year + 4800 - a
        m = month + 12 * a - 3
        jdn = day + (153 * m + 2) // 5 + 365 * y + y // 4 - y // 100 + y // 400 - 32045
        # jdn is the noon-based Julian Day Number; midnight MJD = jdn - 2400001
        return jdn - 2400001 + frac
    if calendar == NOLEAP:
        doy = sum(_DAYS_PER_MONTH[: month - 1]) + day - 1
        return year * 365.0 + doy + frac
    # 360-day
    return year * 360.0 + (month - 1) * 30.0 + day - 1 + frac


def mjd_to_date(mjd: float, calendar: str = GREGORIAN):
    calendar = normalize_calendar(calendar)
    days = int(mjd // 1)
    frac = mjd - days
    # round to the nearest millisecond: large MJDs carry ~1e-5 s float64 noise
    secs = round(frac * _SECONDS_PER_DAY, 3)
    if secs >= _SECONDS_PER_DAY:
        secs -= _SECONDS_PER_DAY
        days += 1
    hour = int(secs // 3600)
    minute = int((secs - hour * 3600) // 60)
    second = secs - hour * 3600 - minute * 60
    if calendar == GREGORIAN:
        jdn = days + 2400001  # int(mjd + 2400000.5) for mjd frac<0.5
        a = jdn + 32044
        b = (4 * a + 3) // 146097
        c = a - 146097 * b // 4
        d = (4 * c + 3) // 1461
        e = c - 1461 * d // 4
        m = (5 * e + 2) // 153
        day = e - (153 * m + 2) // 5 + 1
        month = m + 3 - 12 * (m // 10)
        year = 100 * b + d - 4800 + m // 10
    elif calendar == NOLEAP:
        year, doy = divmod(days, 365)
        month = 1
        while doy >= _DAYS_PER_MONTH[month - 1]:
            doy -= _DAYS_PER_MONTH[month - 1]
            month += 1
        day = doy + 1
    else:
        year, doy = divmod(days, 360)
        month = doy // 30 + 1
        day = doy % 30 + 1
    return year, month, day, hour, minute, second


@total_ordering
@dataclass(frozen=True)
class TimeDelta:
    """A span of model time (time_delta_obj.f90)."""
    _seconds: float = 0.0

    @classmethod
    def from_units(cls, days=0.0, hours=0.0, minutes=0.0, seconds=0.0):
        return cls(days * _SECONDS_PER_DAY + hours * 3600.0 + minutes * 60.0 + seconds)

    def seconds(self) -> float:
        return self._seconds

    def days(self) -> float:
        return self._seconds / _SECONDS_PER_DAY

    def __add__(self, other):
        return TimeDelta(self._seconds + other._seconds)

    def __sub__(self, other):
        return TimeDelta(self._seconds - other._seconds)

    def __mul__(self, k):
        return TimeDelta(self._seconds * k)

    def __neg__(self):
        return TimeDelta(-self._seconds)

    def __eq__(self, other):
        return self._seconds == other._seconds

    def __lt__(self, other):
        return self._seconds < other._seconds

    def as_string(self) -> str:
        s = self._seconds
        if abs(s) < 60:
            return f"{s:6.2f} seconds"
        if abs(s) < 3600:
            return f"{s/60:6.2f} minutes"
        if abs(s) < _SECONDS_PER_DAY:
            return f"{s/3600:6.2f} hours"
        return f"{s/_SECONDS_PER_DAY:6.2f} days"


@total_ordering
class Time:
    """A point in model time on a specific calendar (time_h.f90:22).

    Stored as integer day + float seconds-of-day so that time arithmetic is
    exact to float32-second precision even for large MJD values.
    """

    __slots__ = ("calendar", "_day", "_sec")

    def __init__(self, calendar: str = GREGORIAN, mjd: float = 0.0):
        self.calendar = normalize_calendar(calendar)
        day = int(mjd // 1)
        self._day, self._sec = self._norm(day, (mjd - day) * _SECONDS_PER_DAY)

    @staticmethod
    def _norm(day, sec):
        extra = int(sec // _SECONDS_PER_DAY)
        return day + extra, sec - extra * _SECONDS_PER_DAY

    @property
    def mjd(self) -> float:
        return self._day + self._sec / _SECONDS_PER_DAY

    # -- constructors --
    @classmethod
    def from_date(cls, year, month, day, hour=0, minute=0, second=0.0,
                  calendar: str = GREGORIAN) -> "Time":
        t = cls(calendar, 0.0)
        t._day = int(date_to_mjd(year, month, day, calendar=calendar))
        t._sec = hour * 3600.0 + minute * 60.0 + second
        return t

    @classmethod
    def from_string(cls, datestr: str, calendar: str = GREGORIAN) -> "Time":
        """Parse 'YYYY-MM-DD [hh:mm:ss]' (and 'YYYY/MM/DD', 'T' separator)."""
        m = re.match(
            r"\s*(\d{1,4})[-/](\d{1,2})[-/](\d{1,2})"
            r"(?:[ T_](\d{1,2}):(\d{1,2})(?::(\d{1,2}(?:\.\d*)?))?)?", datestr)
        if not m:
            raise ValueError(f"cannot parse date string: {datestr!r}")
        y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
        h = int(m.group(4) or 0)
        mi = int(m.group(5) or 0)
        s = float(m.group(6) or 0.0)
        return cls.from_date(y, mo, d, h, mi, s, calendar)

    # -- accessors --
    def date(self):
        hour = int(self._sec // 3600)
        minute = int((self._sec - hour * 3600) // 60)
        second = round(self._sec - hour * 3600 - minute * 60, 6)
        y, mo, d, _, _, _ = mjd_to_date(float(self._day), self.calendar)
        return y, mo, d, hour, minute, second

    def seconds(self) -> float:
        return self._day * _SECONDS_PER_DAY + self._sec

    def year_length(self) -> float:
        if self.calendar == THREESIXTY:
            return 360.0
        if self.calendar == NOLEAP:
            return 365.0
        y = self.date()[0]
        return 366.0 if _is_leap(y) else 365.0

    def day_of_year(self) -> float:
        """Zero-based fractional day of year (time_obj.f90:404-441)."""
        y, *_ = self.date()
        start = Time.from_date(y, 1, 1, calendar=self.calendar)
        return (self._day - start._day) + self._sec / _SECONDS_PER_DAY

    def year_fraction(self) -> float:
        return self.day_of_year() / self.year_length()

    def day_fraction(self) -> float:
        return self._sec / _SECONDS_PER_DAY

    def as_string(self, fmt: str = None) -> str:
        y, mo, d, h, mi, s = self.date()
        return f"{y:04d}/{mo:02d}/{d:02d} {h:02d}:{mi:02d}:{s:06.3f}"

    # -- arithmetic --
    def __add__(self, delta: TimeDelta) -> "Time":
        t = Time(self.calendar, 0.0)
        t._day, t._sec = self._norm(self._day, self._sec + delta.seconds())
        return t

    def __sub__(self, other):
        if isinstance(other, Time):
            if other.calendar != self.calendar:
                raise ValueError("cannot subtract times on different calendars")
            return TimeDelta((self._day - other._day) * _SECONDS_PER_DAY
                             + (self._sec - other._sec))
        return self + TimeDelta(-other.seconds())

    def __eq__(self, other):
        return (isinstance(other, Time)
                and abs((self - other).seconds()) < 1e-6)

    def __lt__(self, other):
        return (self - other).seconds() < -1e-6

    def __hash__(self):
        return hash((self.calendar, self._day, round(self._sec, 6)))

    def __repr__(self):
        return f"Time({self.as_string()}, {self.calendar})"
