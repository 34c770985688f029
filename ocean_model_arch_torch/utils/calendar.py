"""Model calendar (tools/time_manager.f90 + legacy/service/time_tools.f90)
(the port's own copy of ``ocean_model_arch_tpu/utils/calendar.py``).

Maps a step count to calendar date/time given the timestep and initial
year. ``yr_type`` 0 = 365-day years, 1 = leap years on the 4-year cycle
(the reference's tables use the simple %4 rule)."""

from __future__ import annotations

import dataclasses

_DAYS = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]


def _is_leap(year: int, yr_type: int) -> bool:
    return yr_type == 1 and year % 4 == 0


def days_in_year(year: int, yr_type: int) -> int:
    return 366 if _is_leap(year, yr_type) else 365


@dataclasses.dataclass
class ModelTime:
    year: int
    month: int      # 1-based
    day: int        # 1-based
    hour: int
    minute: int
    second: float
    num_step: int

    def stamp(self) -> str:
        return (f"{self.year:04d}-{self.month:02d}-{self.day:02d} "
                f"{self.hour:02d}:{self.minute:02d}:{self.second:06.3f}")


def model_time(num_step: int, tau: float, init_year: int,
               yr_type: int = 0) -> ModelTime:
    """Step -> calendar time since init_year-01-01 00:00:00
    (model_time_def, time_tools.f90:9-175)."""
    total = num_step * tau
    year = init_year
    while total >= days_in_year(year, yr_type) * 86400.0:
        total -= days_in_year(year, yr_type) * 86400.0
        year += 1
    month = 1
    while True:
        dm = _DAYS[month - 1]
        if month == 2 and _is_leap(year, yr_type):
            dm += 1
        if total < dm * 86400.0:
            break
        total -= dm * 86400.0
        month += 1
    day = int(total // 86400.0) + 1
    total -= (day - 1) * 86400.0
    hour = int(total // 3600.0)
    total -= hour * 3600.0
    minute = int(total // 60.0)
    second = total - minute * 60.0
    return ModelTime(year, month, day, hour, minute, second, num_step)
