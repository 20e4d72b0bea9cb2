"""Arithmetic expressions with Spark semantics (non-ANSI mode) — the
counterpart of spark_rapids_tpu/expr/arithmetic.py, limited to the
arithmetic the fused scan-aggregate kernel accepts (Add, Subtract,
Multiply, Divide, UnaryMinus, Abs; decimals wait for a later slice).

  * integral overflow wraps (Java semantics; torch integer ops wrap);
  * Divide returns NULL when the divisor is 0 and always yields DOUBLE;
  * binary operands promote to the wider numeric type.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..types import DOUBLE, DataType, numeric_promote
from .core import Expression


def _promote(l: Column, r: Column, target: DataType):
    ld = l.data.to(target.torch_dtype) if l.dtype != target else l.data
    rd = r.data.to(target.torch_dtype) if r.dtype != target else r.data
    return ld, rd


class BinaryArithmetic(Expression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    def with_children(self, children):
        return type(self)(children[0], children[1])

    @property
    def data_type(self) -> DataType:
        lt, rt = self.left.data_type, self.right.data_type
        if lt == rt:
            return lt
        return numeric_promote(lt, rt)

    def columnar_eval(self, batch) -> Column:
        l = self.left.columnar_eval(batch)
        r = self.right.columnar_eval(batch)
        out_t = self.data_type
        ld, rd = _promote(l, r, out_t)
        valid = l.validity & r.validity
        data = self._op(ld, rd)
        data = torch.where(valid, data, torch.zeros((), dtype=data.dtype,
                                                    device=data.device))
        return Column(data, valid, out_t)

    def _op(self, l, r):
        raise NotImplementedError

    def __repr__(self):
        return f"({self.children[0]!r} {self.symbol} {self.children[1]!r})"


class Add(BinaryArithmetic):
    symbol = "+"

    def _op(self, l, r):
        return l + r


class Subtract(BinaryArithmetic):
    symbol = "-"

    def _op(self, l, r):
        return l - r


class Multiply(BinaryArithmetic):
    symbol = "*"

    def _op(self, l, r):
        return l * r


class Divide(BinaryArithmetic):
    """Spark `/`: fractional result; NULL on divide-by-zero."""
    symbol = "/"

    @property
    def data_type(self):
        return DOUBLE

    def columnar_eval(self, batch):
        l = self.left.columnar_eval(batch)
        r = self.right.columnar_eval(batch)
        out_t = self.data_type
        ld, rd = _promote(l, r, out_t)
        div_ok = rd != 0
        valid = l.validity & r.validity & div_ok
        data = ld / torch.where(div_ok, rd, torch.ones_like(rd))
        data = torch.where(valid, data, torch.zeros_like(data))
        return Column(data, valid, out_t)


class UnaryMinus(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def data_type(self):
        return self.children[0].data_type

    def with_children(self, children):
        return UnaryMinus(children[0])

    def columnar_eval(self, batch):
        c = self.children[0].columnar_eval(batch)
        return Column(-c.data, c.validity, c.dtype)


class Abs(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def data_type(self):
        return self.children[0].data_type

    def with_children(self, children):
        return Abs(children[0])

    def columnar_eval(self, batch):
        c = self.children[0].columnar_eval(batch)
        return Column(torch.abs(c.data), c.validity, c.dtype)
