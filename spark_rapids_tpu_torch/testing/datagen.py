"""Composable random data generators — the counterpart of
spark_rapids_tpu/testing/datagen.py, the engine's data_gen.py (reference
integration_tests/src/main/python/data_gen.py: DataGen hierarchy with
special-value weighting, nullability, and seeded reproducibility).

Every generator deliberately over-samples the values that break columnar
kernels: type min/max, 0/-0.0/NaN/±inf for floats, empty and
max-length strings, epoch boundaries for dates/timestamps. Nulls are mixed
in at a configurable probability.

The generators make the JAX package's numpy draws in the same order, so
one seed gives the same Python values in both packages, bit for bit; the
schemas are built of the port's types.
"""

from __future__ import annotations

import datetime
import string as _string
from decimal import Decimal
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..types import (
    BooleanType, ByteType, DataType, DateType, DecimalType, DoubleType,
    FloatType, IntegerType, LongType, Schema, ShortType, StringType,
    StructField, TimestampType,
)

#: probability of drawing from the special-value pool instead of random
SPECIAL_PROB = 0.05


class DataGen:
    """Base generator: produces python values of `data_type`."""

    def __init__(self, data_type: DataType, nullable: bool = True,
                 null_prob: float = 0.08):
        self.data_type = data_type
        self.nullable = nullable
        self.null_prob = null_prob if nullable else 0.0
        self._specials: List[Any] = []

    def with_special_case(self, value, weight: float = 1.0) -> "DataGen":
        self._specials.append(value)
        return self

    # -- subclass surface --------------------------------------------------
    def gen_value(self, rng: np.random.Generator):
        raise NotImplementedError(type(self).__name__)

    # -- drive -------------------------------------------------------------
    def gen_list(self, rng: np.random.Generator, n: int) -> List:
        out = []
        for _ in range(n):
            if self.nullable and rng.random() < self.null_prob:
                out.append(None)
            elif self._specials and rng.random() < SPECIAL_PROB:
                out.append(self._specials[int(rng.integers(
                    0, len(self._specials)))])
            else:
                out.append(self.gen_value(rng))
        return out


class _IntGen(DataGen):
    BITS = 64

    def __init__(self, data_type, nullable=True, null_prob=0.08,
                 min_val: Optional[int] = None,
                 max_val: Optional[int] = None):
        super().__init__(data_type, nullable, null_prob)
        lo = -(1 << (self.BITS - 1))
        hi = (1 << (self.BITS - 1)) - 1
        self.min_val = lo if min_val is None else min_val
        self.max_val = hi if max_val is None else max_val
        for s in (0, 1, -1, self.min_val, self.max_val):
            if self.min_val <= s <= self.max_val:
                self.with_special_case(s)

    def gen_value(self, rng):
        return int(rng.integers(self.min_val, self.max_val, endpoint=True))


class ByteGen(_IntGen):
    BITS = 8

    def __init__(self, **kw):
        super().__init__(ByteType(), **kw)


class ShortGen(_IntGen):
    BITS = 16

    def __init__(self, **kw):
        super().__init__(ShortType(), **kw)


class IntegerGen(_IntGen):
    BITS = 32

    def __init__(self, **kw):
        super().__init__(IntegerType(), **kw)


class LongGen(_IntGen):
    BITS = 64

    def __init__(self, **kw):
        super().__init__(LongType(), **kw)


class _FpGen(DataGen):
    def __init__(self, data_type, nullable=True, null_prob=0.08,
                 no_nans: bool = False, special_cases: Optional[Sequence] = None):
        super().__init__(data_type, nullable, null_prob)
        if special_cases is None:
            special_cases = [0.0, -0.0, 1.0, -1.0,
                             float("inf"), float("-inf")]
            if not no_nans:
                special_cases.append(float("nan"))
        for s in special_cases:
            self.with_special_case(s)

    def gen_value(self, rng):
        # mix magnitudes: uniform small, exponential large
        scale = 10.0 ** rng.integers(-3, 12)
        return float(rng.normal(0, 1) * scale)


class DoubleGen(_FpGen):
    def __init__(self, **kw):
        super().__init__(DoubleType(), **kw)


class FloatGen(_FpGen):
    def __init__(self, **kw):
        super().__init__(FloatType(), **kw)

    def gen_value(self, rng):
        return float(np.float32(super().gen_value(rng)))


class BooleanGen(DataGen):
    def __init__(self, nullable=True, null_prob=0.08):
        super().__init__(BooleanType(), nullable, null_prob)

    def gen_value(self, rng):
        return bool(rng.random() < 0.5)


class StringGen(DataGen):
    """Random strings over a charset with length-edge special cases. The
    default charset includes multi-byte UTF-8 so offset kernels see
    non-ASCII byte lengths."""

    def __init__(self, nullable=True, null_prob=0.08, min_length=0,
                 max_length=20, charset: Optional[str] = None,
                 ascii_only: bool = False):
        super().__init__(StringType(), nullable, null_prob)
        base = _string.ascii_letters + _string.digits + " _-."
        if not ascii_only:
            base += "é中ß"
        self.charset = charset or base
        self.min_length = min_length
        self.max_length = max_length
        self.with_special_case("")
        self.with_special_case("A" * max_length)
        self.with_special_case(" leading")
        self.with_special_case("trailing ")

    def gen_value(self, rng):
        n = int(rng.integers(self.min_length, self.max_length, endpoint=True))
        idx = rng.integers(0, len(self.charset), n)
        return "".join(self.charset[int(i)] for i in idx)


class DateGen(DataGen):
    """Days since epoch as datetime.date (civil-calendar edge cases)."""

    def __init__(self, nullable=True, null_prob=0.08,
                 start=datetime.date(1900, 1, 1),
                 end=datetime.date(2100, 12, 31)):
        super().__init__(DateType(), nullable, null_prob)
        self.start_days = start.toordinal()
        self.end_days = end.toordinal()
        for s in (datetime.date(1970, 1, 1), datetime.date(2000, 2, 29),
                  datetime.date(1999, 12, 31), start, end):
            if start <= s <= end:
                self.with_special_case(s)

    def gen_value(self, rng):
        return datetime.date.fromordinal(
            int(rng.integers(self.start_days, self.end_days, endpoint=True)))


class TimestampGen(DataGen):
    """Microseconds since epoch as tz-naive datetime (engine is UTC-only,
    like the reference defaults with spark.sql.session.timeZone=UTC)."""

    def __init__(self, nullable=True, null_prob=0.08,
                 start=datetime.datetime(1970, 1, 1),
                 end=datetime.datetime(2100, 1, 1)):
        super().__init__(TimestampType(), nullable, null_prob)
        self.start_us = (start - datetime.datetime(1970, 1, 1)) // \
            datetime.timedelta(microseconds=1)
        self.end_us = (end - datetime.datetime(1970, 1, 1)) // \
            datetime.timedelta(microseconds=1)
        self.with_special_case(datetime.datetime(1970, 1, 1))
        self.with_special_case(end)

    def gen_value(self, rng):
        us = int(rng.integers(self.start_us, self.end_us, endpoint=True))
        return datetime.datetime(1970, 1, 1) + datetime.timedelta(
            microseconds=us)


class DecimalGen(DataGen):
    def __init__(self, precision=10, scale=2, nullable=True, null_prob=0.08):
        super().__init__(DecimalType(precision, scale), nullable, null_prob)
        self.precision = precision
        self.scale = scale
        unscaled_max = 10 ** precision - 1
        for s in (0, 1, -1, unscaled_max, -unscaled_max):
            self.with_special_case(Decimal(s).scaleb(-scale))

    def gen_value(self, rng):
        unscaled_max = 10 ** self.precision - 1
        u = int(rng.integers(-unscaled_max, unscaled_max, endpoint=True))
        return Decimal(u).scaleb(-self.scale)


class SetValuesGen(DataGen):
    """Draw uniformly from a fixed pool (low-cardinality keys)."""

    def __init__(self, data_type, values: Sequence, nullable=True,
                 null_prob=0.08):
        super().__init__(data_type, nullable and None in values,
                         null_prob if None in values else 0.0)
        self.values = [v for v in values if v is not None]
        self._has_null = None in values

    def gen_value(self, rng):
        return self.values[int(rng.integers(0, len(self.values)))]


class RepeatSeqGen(DataGen):
    """Cycle a fixed sequence deterministically (stable group keys)."""

    def __init__(self, data_type, values: Sequence):
        super().__init__(data_type, nullable=False, null_prob=0.0)
        self.values = list(values)
        self._i = 0

    def gen_list(self, rng, n):
        out = [self.values[(self._i + i) % len(self.values)]
               for i in range(n)]
        self._i = (self._i + n) % len(self.values)
        return out


def gen_pydict(gens: Sequence[Tuple[str, DataGen]], n: int,
               seed: int = 0) -> Tuple[dict, Schema]:
    """Generate a column dict + matching Schema from (name, gen) pairs."""
    rng = np.random.default_rng(seed)
    data = {}
    fields = []
    for name, g in gens:
        data[name] = g.gen_list(rng, n)
        fields.append(StructField(name, g.data_type, g.nullable))
    return data, Schema(tuple(fields))


def gen_df(session, gens: Sequence[Tuple[str, DataGen]], n: int = 256,
           seed: int = 0, batch_rows: Optional[int] = None):
    """Generate a DataFrame in `session` (reference gen_df, data_gen.py)."""
    data, schema = gen_pydict(gens, n, seed)
    return session.from_pydict(data, schema, batch_rows=batch_rows)
