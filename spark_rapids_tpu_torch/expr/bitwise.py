"""Bitwise and shift expressions — the counterpart of
spark_rapids_tpu/expr/bitwise.py (Spark's BitwiseAnd/Or/Xor/Not and
ShiftLeft/ShiftRight/ShiftRightUnsigned):

- bitwise ops promote to the wider integral type (Add's promotion);
- shifts take an INT distance, keep the value's type (byte and short
  promote to int), and mask the distance to the type's width as Java
  does (`x << (n & 31|63)`);
- >>> is logical (zero fill), >> arithmetic (sign fill).
"""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..types import DataType, IntegerType, LongType, numeric_promote
from .arithmetic import _masked, _promote
from .core import Expression


class _BitwiseBinary(Expression):
    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def with_children(self, cs):
        return type(self)(cs[0], cs[1])

    @property
    def data_type(self) -> DataType:
        lt = self.children[0].data_type
        rt = self.children[1].data_type
        return lt if lt == rt else numeric_promote(lt, rt)

    def columnar_eval(self, batch) -> Column:
        l = self.children[0].columnar_eval(batch)
        r = self.children[1].columnar_eval(batch)
        out_t = self.data_type
        ld, rd = _promote(l, r, out_t)
        valid = l.validity & r.validity
        return Column(_masked(self._op(ld, rd), valid), valid, out_t)


class BitwiseAnd(_BitwiseBinary):
    @staticmethod
    def _op(a, b):
        return torch.bitwise_and(a, b)


class BitwiseOr(_BitwiseBinary):
    @staticmethod
    def _op(a, b):
        return torch.bitwise_or(a, b)


class BitwiseXor(_BitwiseBinary):
    @staticmethod
    def _op(a, b):
        return torch.bitwise_xor(a, b)


class BitwiseNot(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, cs):
        return type(self)(cs[0])

    @property
    def data_type(self):
        return self.children[0].data_type

    def columnar_eval(self, batch) -> Column:
        c = self.children[0].columnar_eval(batch)
        return Column(_masked(torch.bitwise_not(c.data), c.validity),
                      c.validity, self.data_type)


class _ShiftBase(Expression):
    """value SHIFT amount: the result keeps the value's type; the distance
    is masked to the type width like Java (x << 65 == x << 1 for int64)."""

    def __init__(self, value: Expression, amount: Expression):
        self.children = (value, amount)

    def with_children(self, cs):
        return type(self)(cs[0], cs[1])

    @property
    def data_type(self):
        dt = self.children[0].data_type
        return dt if isinstance(dt, LongType) else IntegerType()

    def columnar_eval(self, batch) -> Column:
        v = self.children[0].columnar_eval(batch)
        n = self.children[1].columnar_eval(batch)
        out_t = self.data_type
        bits = 64 if isinstance(out_t, LongType) else 32
        data = v.data.to(out_t.torch_dtype)
        dist = (n.data.to(torch.int32) & (bits - 1)).to(data.dtype)
        valid = v.validity & n.validity
        return Column(_masked(self._op(data, dist, bits), valid), valid,
                      out_t)


class ShiftLeft(_ShiftBase):
    @staticmethod
    def _op(x, d, bits):
        return torch.bitwise_left_shift(x, d)


class ShiftRight(_ShiftBase):
    @staticmethod
    def _op(x, d, bits):
        return torch.bitwise_right_shift(x, d)


class ShiftRightUnsigned(_ShiftBase):
    @staticmethod
    def _op(x, d, bits):
        # an arithmetic shift, then the sign fill masked off; a zero
        # distance keeps every bit
        mask = torch.where(d == 0, torch.full_like(x, -1),
                           torch.bitwise_left_shift(torch.ones_like(x),
                                                    bits - d) - 1)
        return torch.bitwise_right_shift(x, d) & mask
