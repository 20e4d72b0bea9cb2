"""Spark-semantics data types for the PyTorch/CUDA port — the counterpart
of spark_rapids_tpu/types.py, limited to the fixed-width types.

Physical encodings on the card:
  - fixed-width types -> a single tensor of the listed torch dtype
  - BOOLEAN           -> torch.bool (validity is carried separately)
  - DATE              -> int32 days since epoch
  - TIMESTAMP         -> int64 microseconds since epoch UTC

Strings, decimals and nested types wait for a later slice of the port.
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


class DateType(DataType):
    """Days since unix epoch, proleptic Gregorian (int32)."""
    torch_dtype = torch.int32


class TimestampType(DataType):
    """Microseconds since unix epoch UTC (int64)."""
    torch_dtype = torch.int64


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
