"""Julian <-> proleptic-Gregorian datetime rebase — the counterpart of
spark_rapids_tpu/ops/rebase.py (the reference's datetimeRebaseUtils.scala
and JNI DateTimeRebase): files written by legacy
Spark (< 3.0) or Hive store dates/timestamps in the hybrid
Julian-Gregorian calendar; modern Spark (and this engine) is proleptic
Gregorian. Rebase re-interprets the same Y-M-D wall date across
calendars, a piecewise-constant day shift with breakpoints at Julian
century leap days and the 1582-10-15 cutover.

The breakpoint table is generated once from the standard JDN formulas
(no data files), as in the JAX package, and moved to the device; the
kernel is a searchsorted and an add. The Parquet reader's LEGACY mode
calls it (io/parquet.ParquetSource).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

_EPOCH_JDN = 2440588          # 1970-01-01 proleptic Gregorian
_CUTOVER_DAYS = -141427       # 1582-10-15, first Gregorian day of the hybrid
MICROS_PER_DAY = 86_400_000_000


def _julian_ymd_to_jdn(y: int, m: int, d: int) -> int:
    a = (14 - m) // 12
    y2 = y + 4800 - a
    m2 = m + 12 * a - 3
    return d + (153 * m2 + 2) // 5 + 365 * y2 + y2 // 4 - 32083


def _greg_ymd_to_jdn(y: int, m: int, d: int) -> int:
    a = (14 - m) // 12
    y2 = y + 4800 - a
    m2 = m + 12 * a - 3
    return (d + (153 * m2 + 2) // 5 + 365 * y2 + y2 // 4 - y2 // 100
            + y2 // 400 - 32045)


def _jdn_to_julian_ymd(jdn: int) -> Tuple[int, int, int]:
    c = jdn + 32082
    d = (4 * c + 3) // 1461
    e = c - (1461 * d) // 4
    m = (5 * e + 2) // 153
    day = e - (153 * m + 2) // 5 + 1
    month = m + 3 - 12 * (m // 10)
    year = d - 4800 + m // 10
    return year, month, day


def _jdn_to_greg_ymd(jdn: int) -> Tuple[int, int, int]:
    a = jdn + 32044
    b = (4 * a + 3) // 146097
    c = a - (146097 * b) // 4
    d = (4 * c + 3) // 1461
    e = c - (1461 * d) // 4
    m = (5 * e + 2) // 153
    day = e - (153 * m + 2) // 5 + 1
    month = m + 3 - 12 * (m // 10)
    year = 100 * b + d - 4800 + m // 10
    return year, month, day


def _hybrid_to_proleptic(days: int) -> int:
    """One hybrid-calendar day number → proleptic-Gregorian day number."""
    if days >= _CUTOVER_DAYS:
        return days
    y, m, d = _jdn_to_julian_ymd(days + _EPOCH_JDN)
    return _greg_ymd_to_jdn(y, m, d) - _EPOCH_JDN


def _proleptic_to_hybrid(days: int) -> int:
    if days >= _CUTOVER_DAYS:
        return days
    y, m, d = _jdn_to_greg_ymd(days + _EPOCH_JDN)
    # dates that existed only in the Gregorian gap (none before 1582)
    return _julian_ymd_to_jdn(y, m, d) - _EPOCH_JDN


@functools.lru_cache(maxsize=2)
def _switch_table(direction: str) -> Tuple[np.ndarray, np.ndarray]:
    """(switch_days, diffs) in the SOURCE calendar's day numbers. The
    shift changes only at Julian century leap days (Feb 29 Julian /
    absent Gregorian) and the cutover, so probing around each century's
    March 1 (both calendars) finds every breakpoint."""
    conv = _hybrid_to_proleptic if direction == "j2g" else \
        _proleptic_to_hybrid
    probes = []
    for y in range(-4800, 1601, 100):
        for to_jdn in (_julian_ymd_to_jdn, _greg_ymd_to_jdn):
            base = to_jdn(y, 3, 1) - _EPOCH_JDN
            probes.extend(range(base - 3, base + 3))
    probes.extend(range(_CUTOVER_DAYS - 15, _CUTOVER_DAYS + 2))
    probes = sorted(set(probes))
    switch, diffs = [probes[0]], [conv(probes[0]) - probes[0]]
    prev = diffs[0]
    for p in probes[1:]:
        diff = conv(p) - p
        if diff != prev:
            # walk back to the first day carrying the new shift (probes
            # bracket every breakpoint within a few days)
            q = p
            while conv(q - 1) - (q - 1) == diff:
                q -= 1
            switch.append(q)
            diffs.append(diff)
            prev = diff
    return (np.array(switch, np.int64), np.array(diffs, np.int64))


def _apply(days, direction: str):
    switch, diffs = _switch_table(direction)
    sw = torch.from_numpy(switch).to(days.device)
    df = torch.from_numpy(diffs).to(days.device)
    i = torch.clamp(torch.searchsorted(sw, days.to(torch.int64),
                                       right=True) - 1, 0, sw.shape[0] - 1)
    shift = torch.where(days < _CUTOVER_DAYS, df[i], 0)
    return (days + shift).to(days.dtype)


def rebase_julian_to_gregorian_days(days):
    """LEGACY-written DATE (hybrid calendar) → proleptic Gregorian."""
    return _apply(days, "j2g")


def rebase_gregorian_to_julian_days(days):
    """proleptic Gregorian DATE → LEGACY hybrid calendar (write path)."""
    return _apply(days, "g2j")


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def rebase_julian_to_gregorian_micros(micros):
    """LEGACY TIMESTAMP rebase: shift the day component, keep the time of
    day (the reference's JNI rebase is also day-granular for the calendar
    component; sub-day zone shifts are the timezone DB's job)."""
    days = _floordiv(micros, MICROS_PER_DAY)
    tod = micros - days * MICROS_PER_DAY
    return rebase_julian_to_gregorian_days(days) * MICROS_PER_DAY + tod


def rebase_gregorian_to_julian_micros(micros):
    days = _floordiv(micros, MICROS_PER_DAY)
    tod = micros - days * MICROS_PER_DAY
    return rebase_gregorian_to_julian_days(days) * MICROS_PER_DAY + tod
