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

from typing import List, Optional, Sequence

import torch

from ..columnar.column import Column
from ..types import BOOLEAN, DOUBLE, INT, LONG, DataType


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


class LeafExpression(Expression):
    children = ()

    def with_children(self, children):
        return self


class Literal(LeafExpression):
    def __init__(self, value, dtype: Optional[DataType] = None):
        if value is None:
            raise NotImplementedError("null literals wait for a later slice")
        self.value = value
        self._dtype = dtype or _infer_literal_type(value)

    @property
    def data_type(self):
        return self._dtype

    @property
    def nullable(self):
        return False

    def columnar_eval(self, batch) -> Column:
        cap, dev = batch.capacity, batch.device
        data = torch.full((cap,), self.value, dtype=self._dtype.torch_dtype,
                          device=dev)
        return Column(data, torch.ones(cap, dtype=torch.bool, device=dev),
                      self._dtype)

    def __repr__(self):
        return f"lit({self.value!r})"


def _infer_literal_type(value) -> DataType:
    if isinstance(value, bool):
        return BOOLEAN
    if isinstance(value, int):
        return INT if -(2**31) <= value < 2**31 else LONG
    if isinstance(value, float):
        return DOUBLE
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
