"""Expression tree core — the counterpart of spark_rapids_tpu/expr/core.py.

Every expression evaluates columnar: `columnar_eval(batch) -> Column`, a
function of torch tensors. Null semantics follow Spark exactly:
null-intolerant operators AND child validities; And/Or implement Spark's
three-valued logic on validity lanes.

Expressions absorbed into the fused scan-aggregate kernel are also
translated to CUDA C++ by ops/fused_scan_agg.py; that emitter repeats
these evaluation rules, null rules included, one row at a time.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence

import torch

from ..columnar.column import Column
from ..types import (BOOLEAN, DATE, DOUBLE, INT, LONG, NULL, STRING,
                     TIMESTAMP, BinaryType, DataType, DecimalType,
                     StringType)


class Expression:
    """Base expression node. Immutable; children in `children`."""

    children: Sequence["Expression"] = ()

    @property
    def data_type(self) -> DataType:
        raise NotImplementedError(type(self).__name__)

    @property
    def nullable(self) -> bool:
        return True

    def columnar_eval(self, batch) -> Column:
        raise NotImplementedError(type(self).__name__)

    def transform_up(self, fn):
        new_children = [c.transform_up(fn) for c in self.children]
        node = self.with_children(new_children) if new_children else self
        return fn(node)

    def with_children(self, children: List["Expression"]) -> "Expression":
        if not self.children:
            return self
        raise NotImplementedError(type(self).__name__)

    def __repr__(self):
        args = ", ".join(repr(c) for c in self.children)
        return f"{type(self).__name__}({args})"

    # operator sugar (the DataFrame-style surface the JAX package offers)
    def _bin(self, other, cls):
        return cls(self, lit(other))

    def __add__(self, other):
        from .arithmetic import Add
        return self._bin(other, Add)

    def __sub__(self, other):
        from .arithmetic import Subtract
        return self._bin(other, Subtract)

    def __mul__(self, other):
        from .arithmetic import Multiply
        return self._bin(other, Multiply)

    def __truediv__(self, other):
        from .arithmetic import Divide
        return self._bin(other, Divide)

    def __neg__(self):
        from .arithmetic import UnaryMinus
        return UnaryMinus(self)

    def __eq__(self, other):  # type: ignore[override]
        from .predicates import EqualTo
        return self._bin(other, EqualTo)

    def __ne__(self, other):  # type: ignore[override]
        from .predicates import EqualTo, Not
        return Not(self._bin(other, EqualTo))

    def __lt__(self, other):
        from .predicates import LessThan
        return self._bin(other, LessThan)

    def __le__(self, other):
        from .predicates import LessThanOrEqual
        return self._bin(other, LessThanOrEqual)

    def __gt__(self, other):
        from .predicates import GreaterThan
        return self._bin(other, GreaterThan)

    def __ge__(self, other):
        from .predicates import GreaterThanOrEqual
        return self._bin(other, GreaterThanOrEqual)

    def __and__(self, other):
        from .predicates import And
        return self._bin(other, And)

    def __or__(self, other):
        from .predicates import Or
        return self._bin(other, Or)

    def __invert__(self):
        from .predicates import Not
        return Not(self)

    def __hash__(self):
        return id(self)

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def cast(self, dt: DataType) -> "Expression":
        from .cast import Cast
        return Cast(self, dt)


class LeafExpression(Expression):
    children = ()

    def with_children(self, children):
        return self


class Literal(LeafExpression):
    """A constant, held as its physical value: a `datetime.date` as a
    DATE (days since the epoch), a `datetime.datetime` as a TIMESTAMP
    (microseconds since the epoch, UTC; a naive one is taken as UTC), a
    `decimal.Decimal` given a DecimalType as its unscaled int. A literal
    of a decimal type otherwise holds the unscaled int; `lit` infers no
    decimal type (the JAX package's rule). `Literal(None, dtype)` is a
    typed null: every row null over zero data (a string null over
    zero-length rows), as in the JAX package; `lit(None)` is of NullType."""

    def __init__(self, value, dtype: Optional[DataType] = None):
        self._dtype = dtype or _infer_literal_type(value)
        if value is not None:
            from ..columnar.column import _logical_to_physical
            if isinstance(value, datetime.date) \
                    and not isinstance(value, datetime.datetime):
                value = (value - _EPOCH).days
            else:
                value = _logical_to_physical(self._dtype)(value)
        self.value = value

    @property
    def data_type(self):
        return self._dtype

    @property
    def nullable(self):
        return self.value is None

    def columnar_eval(self, batch) -> Column:
        cap, dev = batch.capacity, batch.device
        dt = self._dtype
        valid = torch.full((cap,), self.value is not None, dtype=torch.bool,
                           device=dev)
        if isinstance(dt, (StringType, BinaryType)):
            return _string_literal(self.value, cap, dev, valid, dt)
        if isinstance(dt, DecimalType) and dt.is_decimal128:
            from ..columnar.column import Decimal128Column
            u = (self.value or 0) & ((1 << 128) - 1)
            hi, lo = [v - (1 << 64) if v >= 1 << 63 else v
                      for v in (u >> 64, u & ((1 << 64) - 1))]
            return Decimal128Column.from_limbs(
                torch.full((cap,), hi, dtype=torch.int64, device=dev),
                torch.full((cap,), lo, dtype=torch.int64, device=dev),
                valid, dt)
        if self.value is None:
            tdt = dt.torch_dtype or torch.int8
            return Column(torch.zeros(cap, dtype=tdt, device=dev), valid, dt)
        data = torch.full((cap,), self.value, dtype=dt.torch_dtype,
                          device=dev)
        return Column(data, valid, dt)

    def __repr__(self):
        return f"lit({self.value!r})"


def _string_literal(value, cap: int, dev, valid, dtype) -> Column:
    """The literal repeated over `cap` rows, as the JAX package lays it
    out: a byte bucket of the pattern tiled, offsets at its length."""
    import numpy as np
    from ..columnar.column import StringColumn, bucket_capacity
    b = value.encode("utf-8") if isinstance(value, str) else (value or b"")
    byte_cap = bucket_capacity(max(len(b), 1) * cap)
    lengths = torch.full((cap,), len(b), dtype=torch.int32, device=dev)
    offsets = torch.cat([lengths.new_zeros(1),
                         torch.cumsum(lengths, 0, dtype=torch.int32)])
    if b:
        reps = -(-byte_cap // len(b))
        data = np.tile(np.frombuffer(b, dtype=np.uint8), reps)[:byte_cap]
    else:
        data = np.zeros(byte_cap, dtype=np.uint8)
    return StringColumn(torch.from_numpy(data.copy()).to(dev), offsets,
                        valid, dtype)


_EPOCH = datetime.date(1970, 1, 1)


def _infer_literal_type(value) -> DataType:
    if value is None:
        return NULL
    if isinstance(value, datetime.datetime):
        return TIMESTAMP
    if isinstance(value, datetime.date):
        return DATE
    if isinstance(value, bool):
        return BOOLEAN
    if isinstance(value, int):
        return INT if -(2**31) <= value < 2**31 else LONG
    if isinstance(value, float):
        return DOUBLE
    if isinstance(value, (str, bytes)):
        return STRING
    raise TypeError(f"cannot infer literal type for {value!r}")


def lit(value) -> Expression:
    return value if isinstance(value, Expression) else Literal(value)


class BoundReference(LeafExpression):
    """Resolved column reference by ordinal (Catalyst BoundReference)."""

    def __init__(self, ordinal: int, dtype: DataType, name: str = ""):
        self.ordinal = ordinal
        self._dtype = dtype
        self.name = name

    @property
    def data_type(self):
        return self._dtype

    def columnar_eval(self, batch) -> Column:
        return batch.columns[self.ordinal]

    def __repr__(self):
        return f"#{self.ordinal}:{self.name}"


class UnresolvedAttribute(LeafExpression):
    """Named column reference; resolved against a schema during planning."""

    def __init__(self, name: str):
        self.name = name

    @property
    def data_type(self):
        raise TypeError(f"unresolved attribute {self.name!r}")

    def columnar_eval(self, batch) -> Column:
        return batch.column(self.name)

    def __repr__(self):
        return f"col({self.name!r})"


def col(name: str) -> UnresolvedAttribute:
    return UnresolvedAttribute(name)


class Alias(Expression):
    def __init__(self, child: Expression, name: str):
        self.children = (child,)
        self.name = name

    @property
    def child(self):
        return self.children[0]

    @property
    def data_type(self):
        return self.child.data_type

    @property
    def nullable(self):
        return self.child.nullable

    def columnar_eval(self, batch):
        return self.child.columnar_eval(batch)

    def with_children(self, children):
        return Alias(children[0], self.name)

    def __repr__(self):
        return f"{self.children[0]!r} AS {self.name}"


def resolve(expr: Expression, schema) -> Expression:
    """Bind UnresolvedAttribute -> BoundReference against `schema`."""
    def fn(node):
        if isinstance(node, UnresolvedAttribute):
            idx = schema.index_of(node.name)
            return BoundReference(idx, schema.fields[idx].data_type, node.name)
        return node
    return expr.transform_up(fn)


def output_name(expr: Expression, default: str) -> str:
    if isinstance(expr, Alias):
        return expr.name
    if isinstance(expr, (UnresolvedAttribute, BoundReference)):
        return expr.name
    return default
