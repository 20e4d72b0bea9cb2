"""Datetime expressions — the counterpart of
spark_rapids_tpu/expr/datetimeexprs.py (reference datetimeExpressions.scala;
the kernels of ops/datetime_ops.py use Howard Hinnant's civil-calendar
algorithms). Dates are int32 days since the epoch, timestamps int64
microseconds UTC (Spark's physical encodings)."""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..ops import datetime_ops as dt
from ..types import DateType, IntegerType, TimestampType
from .core import Expression


class _UnaryDatetime(Expression):
    out_type = IntegerType()

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def data_type(self):
        return self.out_type

    def with_children(self, cs):
        return type(self)(cs[0])

    def _days(self, batch):
        c = self.children[0].columnar_eval(batch)
        if isinstance(c.dtype, TimestampType):
            return dt.timestamp_to_date_days(c.data), c.validity
        return c.data, c.validity

    def columnar_eval(self, batch) -> Column:
        days, valid = self._days(batch)
        return Column(self.kernel(days).to(torch.int32), valid,
                      self.out_type)

    kernel = None


class Year(_UnaryDatetime):
    kernel = staticmethod(dt.extract_year)


class Month(_UnaryDatetime):
    kernel = staticmethod(dt.extract_month)


class DayOfMonth(_UnaryDatetime):
    kernel = staticmethod(dt.extract_day)


class DayOfWeek(_UnaryDatetime):
    kernel = staticmethod(dt.extract_dayofweek)


class DayOfYear(_UnaryDatetime):
    kernel = staticmethod(dt.extract_dayofyear)


class Quarter(_UnaryDatetime):
    kernel = staticmethod(dt.extract_quarter)


class _TimePart(Expression):
    """hour/minute/second need the raw microseconds, not days."""

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def data_type(self):
        return IntegerType()

    def with_children(self, cs):
        return type(self)(cs[0])

    def columnar_eval(self, batch):
        c = self.children[0].columnar_eval(batch)
        return Column(self.kernel(c.data).to(torch.int32), c.validity,
                      IntegerType())

    kernel = None


class Hour(_TimePart):
    kernel = staticmethod(dt.extract_hour)


class Minute(_TimePart):
    kernel = staticmethod(dt.extract_minute)


class Second(_TimePart):
    kernel = staticmethod(dt.extract_second)


class LastDay(_UnaryDatetime):
    out_type = DateType()
    kernel = staticmethod(dt.last_day)


class DateAdd(Expression):
    """date_add(date, n) / date_sub via negated n."""

    def __init__(self, date: Expression, n: Expression, negate: bool = False):
        self.children = (date, n)
        self.negate = negate

    @property
    def data_type(self):
        return DateType()

    def with_children(self, cs):
        return DateAdd(cs[0], cs[1], self.negate)

    def columnar_eval(self, batch):
        d = self.children[0].columnar_eval(batch)
        n = self.children[1].columnar_eval(batch)
        delta = -n.data if self.negate else n.data
        return Column(dt.date_add(d.data, delta).to(torch.int32),
                      d.validity & n.validity, DateType())


class DateDiff(Expression):
    def __init__(self, end: Expression, start: Expression):
        self.children = (end, start)

    @property
    def data_type(self):
        return IntegerType()

    def with_children(self, cs):
        return DateDiff(cs[0], cs[1])

    def columnar_eval(self, batch):
        e = self.children[0].columnar_eval(batch)
        s = self.children[1].columnar_eval(batch)
        return Column(dt.date_diff(e.data, s.data).to(torch.int32),
                      e.validity & s.validity, IntegerType())


class AddMonths(Expression):
    def __init__(self, date: Expression, n: Expression):
        self.children = (date, n)

    @property
    def data_type(self):
        return DateType()

    def with_children(self, cs):
        return AddMonths(cs[0], cs[1])

    def columnar_eval(self, batch):
        d = self.children[0].columnar_eval(batch)
        n = self.children[1].columnar_eval(batch)
        return Column(dt.add_months(d.data, n.data).to(torch.int32),
                      d.validity & n.validity, DateType())


class TruncDate(Expression):
    def __init__(self, date: Expression, unit: str):
        self.children = (date,)
        self.unit = unit.lower()

    @property
    def data_type(self):
        return DateType()

    def with_children(self, cs):
        return TruncDate(cs[0], self.unit)

    def columnar_eval(self, batch):
        d = self.children[0].columnar_eval(batch)
        return Column(dt.trunc_date(d.data, self.unit).to(torch.int32),
                      d.validity, DateType())


class FromUTCTimestamp(Expression):
    """from_utc_timestamp(ts, tz): UTC instant → wall clock in tz
    (reference GpuFromUTCTimestamp + GpuTimeZoneDB device transition
    tables; ops/timezone.py)."""

    def __init__(self, ts: Expression, tz):
        self.children = (ts,)
        self.tz = tz.value if hasattr(tz, "value") else tz

    @property
    def data_type(self):
        return TimestampType()

    def with_children(self, cs):
        return type(self)(cs[0], self.tz)

    def columnar_eval(self, batch):
        from ..ops.timezone import utc_to_local
        c = self.children[0].columnar_eval(batch)
        return Column(utc_to_local(c.data, self.tz), c.validity,
                      TimestampType())


class ToUTCTimestamp(FromUTCTimestamp):
    """to_utc_timestamp(ts, tz): wall clock in tz → UTC instant (fold=0
    for ambiguous DST-overlap times, matching Java's zone rules)."""

    def columnar_eval(self, batch):
        from ..ops.timezone import local_to_utc
        c = self.children[0].columnar_eval(batch)
        return Column(local_to_utc(c.data, self.tz), c.validity,
                      TimestampType())
