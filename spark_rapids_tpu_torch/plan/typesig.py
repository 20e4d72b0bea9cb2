"""TypeSig — per-operator type-support signatures, the counterpart of
spark_rapids_tpu/plan/typesig.py (reference TypeChecks.scala:168 TypeSig /
:1456 ExprChecks; drives both tagging and the generated supported-ops
documentation).

The tags are the JAX package's.
"""

from __future__ import annotations

from typing import FrozenSet, Optional

from ..types import (
    ArrayType, BinaryType, BooleanType, ByteType, DataType, DateType,
    DecimalType, DoubleType, FloatType, IntegerType, LongType, MapType,
    NullType, ShortType, StringType, StructType, TimestampNTZType,
    TimestampType,
)

_ALL_TAGS = {
    "BOOLEAN": BooleanType, "BYTE": ByteType, "SHORT": ShortType,
    "INT": IntegerType, "LONG": LongType, "FLOAT": FloatType,
    "DOUBLE": DoubleType, "DATE": DateType, "TIMESTAMP": TimestampType,
    "TIMESTAMP_NTZ": TimestampNTZType, "STRING": StringType,
    "BINARY": BinaryType, "NULL": NullType, "DECIMAL": DecimalType,
    "ARRAY": ArrayType, "MAP": MapType, "STRUCT": StructType,
}


class TypeSig:
    """An immutable set of supported type tags with set algebra."""

    def __init__(self, tags: FrozenSet[str]):
        self.tags = frozenset(tags)

    @staticmethod
    def of(*names: str) -> "TypeSig":
        for n in names:
            assert n in _ALL_TAGS, n
        return TypeSig(frozenset(names))

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self.tags | other.tags)

    def __sub__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self.tags - other.tags)

    def supports(self, dt: DataType) -> bool:
        for tag in self.tags:
            if isinstance(dt, _ALL_TAGS[tag]):
                return True
        return False

    def reason_not_supported(self, dt: DataType) -> Optional[str]:
        if self.supports(dt):
            return None
        return (f"{dt.simple_name()} is not supported "
                f"(supported: {', '.join(sorted(self.tags))})")

    def __repr__(self):
        return f"TypeSig({'+'.join(sorted(self.tags))})"


BOOLEAN = TypeSig.of("BOOLEAN")
integral = TypeSig.of("BYTE", "SHORT", "INT", "LONG")
fp = TypeSig.of("FLOAT", "DOUBLE")
numeric = integral + fp
decimal = TypeSig.of("DECIMAL")
numeric_and_decimal = numeric + decimal
datetime = TypeSig.of("DATE", "TIMESTAMP", "TIMESTAMP_NTZ")
stringlike = TypeSig.of("STRING", "BINARY")
nulltype = TypeSig.of("NULL")
comparable = numeric_and_decimal + datetime + stringlike + BOOLEAN + nulltype
orderable = comparable
#: everything current kernels handle for pass-through (gather/concat/sort
#: payloads). ARRAY/MAP/STRUCT restricted until nested gather lands.
commonly_supported = comparable
all_types = TypeSig(frozenset(_ALL_TAGS))
nested = TypeSig.of("ARRAY", "MAP", "STRUCT")
