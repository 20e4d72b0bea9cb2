"""Cast expression — the counterpart of spark_rapids_tpu/expr/cast.py
(Spark's cast matrix, reference GpuCast.scala:1823): the numeric,
boolean, date, timestamp and DECIMAL(p<=18) casts, with strings through
ops/cast_strings.py. Casts the JAX package has no device kernel for
(float, double or timestamp to string; string to timestamp or decimal;
decimal128 either way) are tagged off at plan time
(plan/overrides.py `_tag_cast`) and raise here.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..types import (BooleanType, ByteType, DataType, DateType, DecimalType,
                     FractionalType, IntegerType, IntegralType, LongType,
                     ShortType, StringType, TimestampType)
from .arithmetic import _masked, _round_div_half_up, _trunc_div
from .core import Expression

_INT_BOUNDS = {
    ByteType: (-128, 127),
    ShortType: (-32768, 32767),
    IntegerType: (-(2**31), 2**31 - 1),
    LongType: (-(2**63), 2**63 - 1),
}
_DAY_US = 86_400_000_000


def _to_int64_saturating(x: torch.Tensor) -> torch.Tensor:
    """Float lanes to int64 as XLA converts them: NaN -> 0, out of range
    -> the nearest bound (a bare conversion is undefined there)."""
    big = 2.0 ** 63
    safe = torch.where(torch.isnan(x) | (x >= big) | (x < -big),
                       torch.zeros_like(x), x)
    out = safe.to(torch.int64)
    out = torch.where(x >= big, torch.full_like(out, 2**63 - 1), out)
    return torch.where(x < -big, torch.full_like(out, -(2**63)), out)


class Cast(Expression):
    def __init__(self, child: Expression, dtype: DataType,
                 ansi: bool = False):
        self.children = (child,)
        self._dtype = dtype
        self.ansi = ansi

    def with_children(self, children):
        return Cast(children[0], self._dtype, self.ansi)

    @property
    def data_type(self):
        return self._dtype

    def __repr__(self):
        return f"cast({self.children[0]!r} as {self._dtype!r})"

    def columnar_eval(self, batch):
        from ..columnar.encoded import materialize_column
        c = materialize_column(self.children[0].columnar_eval(batch))
        src, dst = c.dtype, self._dtype
        if src == dst:
            return c
        if isinstance(dst, StringType):
            from ..ops.cast_strings import cast_to_string
            return cast_to_string(c)
        if isinstance(src, StringType):
            from ..ops.cast_strings import cast_string_to
            return cast_string_to(c, dst)
        if (isinstance(src, DecimalType) and src.is_decimal128) or \
                (isinstance(dst, DecimalType) and dst.is_decimal128):
            raise NotImplementedError(
                f"cast {src!r} -> {dst!r}: decimal128 casts are tagged off "
                "at plan time, as in the JAX package")
        if isinstance(dst, BooleanType):
            data = c.data != 0
            return Column(data & c.validity, c.validity, dst)
        if isinstance(src, BooleanType):
            return Column(c.data.to(dst.torch_dtype), c.validity, dst)
        if isinstance(dst, IntegralType) and isinstance(src, FractionalType) \
                and not isinstance(src, DecimalType):
            # Spark float -> int: truncate; NaN -> 0; out of range
            # saturates (clamped in the float domain, then as an integer)
            lo, hi = _INT_BOUNDS[type(dst)]
            x = torch.nan_to_num(c.data, nan=0.0, posinf=float(hi),
                                 neginf=float(lo))
            x = torch.clamp(torch.trunc(x), float(lo), float(hi))
            data = torch.clamp(_to_int64_saturating(x), lo, hi)
            return Column(_masked(data.to(dst.torch_dtype), c.validity),
                          c.validity, dst)
        if isinstance(dst, DecimalType):
            return self._cast_to_decimal(c, src, dst)
        if isinstance(src, DecimalType):
            return self._cast_from_decimal(c, src, dst)
        if isinstance(src, DateType) and isinstance(dst, TimestampType):
            data = c.data.to(torch.int64) * _DAY_US
            return Column(_masked(data, c.validity), c.validity, dst)
        if isinstance(src, TimestampType) and isinstance(dst, DateType):
            days = torch.div(c.data, _DAY_US, rounding_mode="floor")
            return Column(_masked(days.to(torch.int32), c.validity),
                          c.validity, dst)
        if isinstance(src, TimestampType) and isinstance(dst, LongType):
            data = torch.div(c.data, 1_000_000, rounding_mode="floor")
            return Column(_masked(data, c.validity), c.validity, dst)
        if isinstance(src, IntegralType) and isinstance(dst, TimestampType):
            data = c.data.to(torch.int64) * 1_000_000
            return Column(_masked(data, c.validity), c.validity, dst)
        # numeric widening/narrowing: Java-style wrap on narrowing
        data = c.data.to(dst.torch_dtype)
        return Column(_masked(data, c.validity), c.validity, dst)

    def _cast_to_decimal(self, c, src, dst: DecimalType):
        if isinstance(src, DecimalType):
            shift = dst.scale - src.scale
            if shift >= 0:
                unscaled = c.data * 10 ** shift
            else:
                unscaled = _round_div_half_up(c.data, 10 ** (-shift))
        elif isinstance(src, IntegralType):
            unscaled = c.data.to(torch.int64) * 10 ** dst.scale
        else:  # float/double -> decimal, HALF_UP at the target scale
            x = c.data.to(torch.float64) * float(10 ** dst.scale)
            unscaled = _to_int64_saturating(
                torch.where(x >= 0, torch.floor(x + 0.5),
                            torch.ceil(x - 0.5)))
        # overflow -> null (non-ANSI)
        bound = 10 ** dst.precision
        valid = c.validity & (unscaled < bound) & (unscaled > -bound)
        return Column(_masked(unscaled, valid), valid, dst)

    def _cast_from_decimal(self, c, src: DecimalType, dst):
        m = 10 ** src.scale
        if isinstance(dst, FractionalType):
            data = (c.data.to(torch.float64) / m).to(dst.torch_dtype)
            return Column(_masked(data, c.validity), c.validity, dst)
        if isinstance(dst, IntegralType):
            q = _trunc_div(c.data, torch.full_like(c.data, m))
            lo, hi = _INT_BOUNDS[type(dst)]
            valid = c.validity & (q >= lo) & (q <= hi)
            return Column(_masked(q.to(dst.torch_dtype), valid), valid, dst)
        raise TypeError(f"cast decimal -> {dst} unsupported")
