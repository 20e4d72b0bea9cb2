"""Spark-semantics data types for the PyTorch/CUDA port — the counterpart
of spark_rapids_tpu/types.py, limited to the fixed-width types.

Physical encodings on the card:
  - fixed-width types -> a single tensor of the listed torch dtype
  - BOOLEAN           -> torch.bool (validity is carried separately)
  - DATE              -> int32 days since epoch
  - TIMESTAMP         -> int64 microseconds since epoch UTC
  - TIMESTAMP_NTZ     -> int64 microseconds since epoch, local wall clock
  - DECIMAL(p<=18)    -> int64 unscaled values + (precision, scale)
  - DECIMAL(p>18)     -> two int64 limbs (hi, lo): decimal128
                         (columnar/column.py Decimal128Column)
  - STRING / BINARY   -> uint8 bytes + int32 offsets (columnar/column.py
                         StringColumn), or int32 codes into a per-batch
                         dictionary (columnar/encoded.py DictionaryColumn)

Nested types wait for a later slice of the port (ROADMAP A.8).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


class DataType:
    """Base of the engine's logical type lattice."""

    #: torch dtype of the data tensor; None for types without one
    torch_dtype: Optional[torch.dtype] = None

    @property
    def is_numeric(self) -> bool:
        return isinstance(self, NumericType)

    @property
    def is_fixed_width(self) -> bool:
        return self.torch_dtype is not None

    @property
    def np_dtype(self) -> np.dtype:
        return _NP_DTYPES[self.torch_dtype]

    def simple_name(self) -> str:
        return type(self).__name__.replace("Type", "").lower()

    def __repr__(self) -> str:
        return self.simple_name()

    def __eq__(self, other) -> bool:
        if dataclasses.is_dataclass(self):
            return type(self) is type(other) \
                and dataclasses.asdict(self) == dataclasses.asdict(other)
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(repr(self))


class NumericType(DataType):
    pass


class IntegralType(NumericType):
    pass


class FractionalType(NumericType):
    pass


class BooleanType(DataType):
    torch_dtype = torch.bool


class ByteType(IntegralType):
    torch_dtype = torch.int8


class ShortType(IntegralType):
    torch_dtype = torch.int16


class IntegerType(IntegralType):
    torch_dtype = torch.int32

    def simple_name(self) -> str:
        return "int"


class LongType(IntegralType):
    torch_dtype = torch.int64

    def simple_name(self) -> str:
        return "bigint"


class FloatType(FractionalType):
    torch_dtype = torch.float32


class DoubleType(FractionalType):
    torch_dtype = torch.float64


class StringType(DataType):
    """UTF-8 bytes + int32 offsets (Arrow layout); no fixed-width tensor."""


class BinaryType(DataType):
    """Raw bytes, laid out as StringType."""


class NullType(DataType):
    """The type of an untyped null literal: all rows null, no data."""


class DateType(DataType):
    """Days since unix epoch, proleptic Gregorian (int32)."""
    torch_dtype = torch.int32


class TimestampType(DataType):
    """Microseconds since unix epoch UTC (int64)."""
    torch_dtype = torch.int64


class TimestampNTZType(DataType):
    """Timestamp without timezone; micros since epoch in local wall clock."""
    torch_dtype = torch.int64


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class DecimalType(FractionalType):
    """Fixed-point decimal. p<=18 packs in one int64 of unscaled value
    (Spark's Decimal64 fast path); p<=38 in two int64 limbs (decimal128)."""
    precision: int = 10
    scale: int = 0

    MAX_INT_DIGITS = 9
    MAX_LONG_DIGITS = 18
    MAX_PRECISION = 38

    #: the unscaled lane (decimal128: each limb's)
    torch_dtype = torch.int64

    def __post_init__(self):
        if not 1 <= self.precision <= self.MAX_PRECISION:
            raise ValueError(f"decimal precision {self.precision}")
        if not 0 <= self.scale <= self.precision:
            raise ValueError(f"decimal scale {self.scale} of precision "
                             f"{self.precision}")

    @property
    def is_decimal128(self) -> bool:
        return self.precision > self.MAX_LONG_DIGITS

    def simple_name(self) -> str:
        return f"decimal({self.precision},{self.scale})"

    def __hash__(self) -> int:
        return hash(("decimal", self.precision, self.scale))


# Canonical singletons (Spark-style)
BOOLEAN = BooleanType()
BYTE = ByteType()
SHORT = ShortType()
INT = IntegerType()
LONG = LongType()
FLOAT = FloatType()
DOUBLE = DoubleType()
DATE = DateType()
TIMESTAMP = TimestampType()
TIMESTAMP_NTZ = TimestampNTZType()
STRING = StringType()
BINARY = BinaryType()
NULL = NullType()

_NP_DTYPES = {
    torch.bool: np.dtype(np.bool_), torch.int8: np.dtype(np.int8),
    torch.int16: np.dtype(np.int16), torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64), torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
}

_NUMERIC_ORDER = [ByteType, ShortType, IntegerType, LongType, FloatType,
                  DoubleType]


def numeric_promote(a: DataType, b: DataType) -> DataType:
    """Spark's binary-arithmetic common type for non-decimal numerics."""
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        raise TypeError("decimal promotion handled by DecimalPrecision rules")
    ia = _NUMERIC_ORDER.index(type(a))
    ib = _NUMERIC_ORDER.index(type(b))
    return (a, b)[ia < ib]


@dataclasses.dataclass(frozen=True, eq=True)
class StructField:
    name: str
    data_type: DataType
    nullable: bool = True

    def __hash__(self) -> int:
        return hash((self.name, self.data_type, self.nullable))


@dataclasses.dataclass(frozen=True)
class Schema:
    """Ordered named columns; the engine's row-schema object."""
    fields: Tuple[StructField, ...]

    def __post_init__(self):
        if len({f.name for f in self.fields}) != len(self.fields):
            raise ValueError(f"duplicate column names in {self.names}")

    @property
    def names(self):
        return [f.name for f in self.fields]

    @property
    def types(self):
        return [f.data_type for f in self.fields]

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(f"column {name!r} not in schema {self.names}")

    def __len__(self):
        return len(self.fields)

    def __getitem__(self, i):
        return self.fields[i]


def from_arrow(at) -> DataType:
    """A pyarrow type as the engine's (a dictionary type as its value
    type: the encoding is the column's layout, not its type). Nested and
    null types raise, naming ROADMAP A.8."""
    import pyarrow as pa
    checks = ((pa.types.is_boolean, BOOLEAN), (pa.types.is_int8, BYTE),
              (pa.types.is_int16, SHORT), (pa.types.is_int32, INT),
              (pa.types.is_int64, LONG), (pa.types.is_float32, FLOAT),
              (pa.types.is_float64, DOUBLE), (pa.types.is_string, STRING),
              (pa.types.is_large_string, STRING),
              (pa.types.is_binary, BINARY),
              (pa.types.is_large_binary, BINARY),
              (pa.types.is_date32, DATE))
    for check, dt in checks:
        if check(at):
            return dt
    if pa.types.is_timestamp(at):
        return TIMESTAMP if at.tz is not None else TIMESTAMP_NTZ
    if pa.types.is_decimal(at):
        return DecimalType(at.precision, at.scale)
    if pa.types.is_dictionary(at):
        return from_arrow(at.value_type)
    raise NotImplementedError(
        f"arrow type {at}: nested and null types wait for their slice "
        f"(ROADMAP A.8)")


def to_arrow(dt: DataType):
    import pyarrow as pa
    out = {BooleanType: pa.bool_(), ByteType: pa.int8(),
           ShortType: pa.int16(), IntegerType: pa.int32(),
           LongType: pa.int64(), FloatType: pa.float32(),
           DoubleType: pa.float64(), StringType: pa.string(),
           BinaryType: pa.binary(), DateType: pa.date32(),
           TimestampType: pa.timestamp("us", tz="UTC"),
           TimestampNTZType: pa.timestamp("us")}.get(type(dt))
    if isinstance(dt, DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    if out is None:
        raise NotImplementedError(f"{dt!r}: nested and null types wait for "
                                  f"their slice (ROADMAP A.8)")
    return out
