"""Spark DecimalPrecision result-type rules (allowPrecisionLoss=true) —
the counterpart of spark_rapids_tpu/expr/decimal_rules.py."""

from __future__ import annotations

from ..types import (ByteType, DataType, DecimalType, IntegerType,
                     IntegralType, LongType, ShortType)

MAX_PRECISION = 38
MINIMUM_ADJUSTED_SCALE = 6


def _adjust(precision: int, scale: int) -> DecimalType:
    if precision <= MAX_PRECISION:
        return DecimalType(precision, scale)
    int_digits = precision - scale
    min_scale = min(scale, MINIMUM_ADJUSTED_SCALE)
    adjusted_scale = max(MAX_PRECISION - int_digits, min_scale)
    return DecimalType(MAX_PRECISION, adjusted_scale)


def integral_as_decimal(dt: DataType) -> DecimalType:
    if isinstance(dt, ByteType):
        return DecimalType(3, 0)
    if isinstance(dt, ShortType):
        return DecimalType(5, 0)
    if isinstance(dt, IntegerType):
        return DecimalType(10, 0)
    if isinstance(dt, LongType):
        return DecimalType(20, 0)
    raise TypeError(dt)


def _coerce(dt: DataType) -> DecimalType:
    if isinstance(dt, DecimalType):
        return dt
    if isinstance(dt, IntegralType):
        return integral_as_decimal(dt)
    raise TypeError(f"cannot coerce {dt} to decimal")


def binary_result_type(op: str, lt: DataType, rt: DataType) -> DecimalType:
    left = _coerce(lt)
    right = _coerce(rt)
    p1, s1, p2, s2 = left.precision, left.scale, right.precision, right.scale
    if op in ("Add", "Subtract"):
        scale = max(s1, s2)
        return _adjust(max(p1 - s1, p2 - s2) + scale + 1, scale)
    if op == "Multiply":
        return _adjust(p1 + p2 + 1, s1 + s2)
    if op == "Divide":
        scale = max(MINIMUM_ADJUSTED_SCALE, s1 + p2 + 1)
        return _adjust(p1 - s1 + s2 + scale, scale)
    if op in ("Remainder", "Pmod"):
        scale = max(s1, s2)
        return _adjust(min(p1 - s1, p2 - s2) + scale, scale)
    raise TypeError(f"no decimal rule for {op}")
