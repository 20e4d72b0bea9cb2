"""Date and time kernels — the counterpart of
spark_rapids_tpu/ops/datetime_ops.py. Dates are int32 days since the
epoch, timestamps int64 microseconds UTC, in the proleptic Gregorian
calendar (Spark >= 3.0); the civil-calendar conversions are Howard
Hinnant's branch-free algorithms, as in the JAX package. torch's `//` and
`%` on integers floor, as jnp's do.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column, StringColumn
from ..types import DATE

_DAY_US = 86_400_000_000
_DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def days_from_civil(y, m, d):
    """(y, m, d) -> days since 1970-01-01, in y's integer dtype (int32
    lanes wrap as the JAX package's do for absurd years)."""
    y = y - (m <= 2).to(y.dtype)
    m = m.to(y.dtype)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d.to(y.dtype) - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def civil_from_days(days):
    """days since 1970-01-01 -> (y, m, d) int32 lanes."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def _is_leap(y):
    return ((torch.remainder(y, 4) == 0) & (torch.remainder(y, 100) != 0)) \
        | (torch.remainder(y, 400) == 0)


def days_in_month(y, m):
    table = torch.tensor(_DAYS_IN_MONTH, dtype=torch.int32, device=y.device)
    base = table[torch.clamp(m - 1, 0, 11).long()]
    return torch.where((m == 2) & _is_leap(y), 29, base).to(torch.int32)


def string_to_date(col: StringColumn) -> Column:
    """Spark cast(string as date): 'yyyy', 'yyyy-m[m]' or 'yyyy-m[m]-d[d]',
    a time part after 'T' or ' ' ignored once the day is complete;
    anything else -> NULL."""
    from .cast_strings import _byte_matrix, _trimmed_span
    s, e = _trimmed_span(col)
    b, act = _byte_matrix(col, s, e)
    cap = s.shape[0]
    dev = s.device
    z = torch.zeros(cap, dtype=torch.int32, device=dev)
    seg, y, m, d, seg_len = z, z, z, z, z
    ok = torch.ones(cap, dtype=torch.bool, device=dev)
    done = torch.zeros_like(ok)
    for t in range(b.shape[1]):
        bt = b[:, t]
        active = act[:, t] & ~done
        is_digit = (bt >= ord("0")) & (bt <= ord("9"))
        is_dash = bt == ord("-")
        is_t = (bt == ord("T")) | (bt == ord(" "))
        dg = (bt - ord("0")).to(torch.int32)
        step = active & is_digit
        y = torch.where(step & (seg == 0), y * 10 + dg, y)
        m = torch.where(step & (seg == 1), m * 10 + dg, m)
        d = torch.where(step & (seg == 2), d * 10 + dg, d)
        seg_len_n = torch.where(step, seg_len + 1, seg_len)
        advance = active & is_dash & (seg < 2) & (seg_len > 0)
        day_done = is_t & (seg == 2) & (seg_len > 0)
        done = done | (active & day_done)
        ok = ok & ~(active & ~(is_digit | advance | day_done))
        seg = torch.where(advance, seg + 1, seg)
        seg_len = torch.where(advance, 0, seg_len_n)
    m = torch.where(seg >= 1, m, 1)
    d = torch.where(seg >= 2, d, 1)
    ok = ok & (e > s) & (m >= 1) & (m <= 12) & (d >= 1) \
        & (d <= days_in_month(y, m))
    days = days_from_civil(y, m, d).to(torch.int32)
    valid = col.validity & ok
    return Column(torch.where(valid, days, 0), valid, DATE)


# -- field extraction --------------------------------------------------------

def extract_year(days):
    return civil_from_days(days)[0]


def extract_month(days):
    return civil_from_days(days)[1]


def extract_day(days):
    return civil_from_days(days)[2]


def extract_dayofweek(days):
    """Spark dayofweek: 1 = Sunday ... 7 = Saturday (1970-01-01 was a
    Thursday)."""
    return (torch.remainder(days.to(torch.int64) + 4, 7) + 1).to(torch.int32)


def extract_dayofyear(days):
    y = civil_from_days(days)[0]
    one = torch.ones_like(y)
    jan1 = days_from_civil(y, one, one)
    return (days.to(torch.int64) - jan1 + 1).to(torch.int32)


def extract_quarter(days):
    m = civil_from_days(days)[1]
    return _fdiv(m - 1, 3) + 1


def timestamp_to_date_days(micros):
    return _fdiv(micros, _DAY_US).to(torch.int32)


def extract_hour(micros):
    return _fdiv(torch.remainder(micros, _DAY_US), 3_600_000_000) \
        .to(torch.int32)


def extract_minute(micros):
    day_us = torch.remainder(micros, _DAY_US)
    return torch.remainder(_fdiv(day_us, 60_000_000), 60).to(torch.int32)


def extract_second(micros):
    day_us = torch.remainder(micros, _DAY_US)
    return torch.remainder(_fdiv(day_us, 1_000_000), 60).to(torch.int32)


def date_add(days, n):
    return (days.to(torch.int64) + n.to(torch.int64)).to(torch.int32)


def date_diff(end, start):
    return (end.to(torch.int64) - start.to(torch.int64)).to(torch.int32)


def last_day(days):
    y, m, _ = civil_from_days(days)
    return days_from_civil(y, m, days_in_month(y, m)).to(torch.int32)


def add_months(days, n):
    y, m, d = civil_from_days(days)
    total = y * 12 + (m - 1) + n
    ny = _fdiv(total, 12)
    nm = torch.remainder(total, 12) + 1
    nd = torch.minimum(d, days_in_month(ny, nm))
    return days_from_civil(ny, nm, nd).to(torch.int32)


def trunc_date(days, unit: str):
    y, m, _d = civil_from_days(days)
    one = torch.ones_like(m)
    if unit in ("year", "yyyy", "yy"):
        return days_from_civil(y, one, one).to(torch.int32)
    if unit in ("quarter",):
        qm = _fdiv(m - 1, 3) * 3 + 1
        return days_from_civil(y, qm, one).to(torch.int32)
    if unit in ("month", "mon", "mm"):
        return days_from_civil(y, m, one).to(torch.int32)
    if unit in ("week",):
        # Monday-aligned: 1970-01-01 is a Thursday
        dow = torch.remainder(days.to(torch.int64) + 3, 7)  # 0 = Monday
        return (days.to(torch.int64) - dow).to(torch.int32)
    raise ValueError(f"unsupported trunc unit {unit}")
