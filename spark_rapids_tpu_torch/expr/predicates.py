"""Predicates & comparisons with Spark's three-valued logic — the
counterpart of spark_rapids_tpu/expr/predicates.py (fixed-width operands):
  AND: F && anything = F ;  T && NULL = NULL
  OR : T || anything = T ;  F || NULL = NULL
Float comparisons use Spark's total order: NaN equals NaN and sorts
above every other value.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..types import BOOLEAN, DataType, numeric_promote
from .core import Expression


def _float_compare_sign(l, r):
    """Spark/Java float ordering as a sign lane: NaN equals NaN and sorts
    greater than any other value (Double.compare semantics)."""
    ln = torch.isnan(l)
    rn = torch.isnan(r)
    lt = (~ln & rn) | (~ln & ~rn & (l < r))
    gt = (ln & ~rn) | (~ln & ~rn & (l > r))
    one = torch.ones_like(l, dtype=torch.int32)
    return torch.where(lt, -one, torch.where(gt, one, torch.zeros_like(one)))


class BinaryComparison(Expression):
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
        return BOOLEAN

    def columnar_eval(self, batch) -> Column:
        l = self.left.columnar_eval(batch)
        r = self.right.columnar_eval(batch)
        valid = l.validity & r.validity
        common = l.dtype if l.dtype == r.dtype \
            else numeric_promote(l.dtype, r.dtype)
        ld = l.data.to(common.torch_dtype)
        rd = r.data.to(common.torch_dtype)
        if ld.dtype.is_floating_point:
            data = self._cmp_from_sign(_float_compare_sign(ld, rd))
        else:
            data = self._op(ld, rd)
        return Column(data & valid, valid, BOOLEAN)

    def _op(self, l, r):
        raise NotImplementedError

    def _cmp_from_sign(self, cmp):
        raise NotImplementedError

    def __repr__(self):
        return f"({self.children[0]!r} {self.symbol} {self.children[1]!r})"


class EqualTo(BinaryComparison):
    symbol = "="

    def _op(self, l, r):
        return l == r

    def _cmp_from_sign(self, cmp):
        return cmp == 0


class LessThan(BinaryComparison):
    symbol = "<"

    def _op(self, l, r):
        return l < r

    def _cmp_from_sign(self, cmp):
        return cmp < 0


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    def _op(self, l, r):
        return l <= r

    def _cmp_from_sign(self, cmp):
        return cmp <= 0


class GreaterThan(BinaryComparison):
    symbol = ">"

    def _op(self, l, r):
        return l > r

    def _cmp_from_sign(self, cmp):
        return cmp > 0


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="

    def _op(self, l, r):
        return l >= r

    def _cmp_from_sign(self, cmp):
        return cmp >= 0


class EqualNullSafe(BinaryComparison):
    """<=> : null-safe equality, never returns null."""
    symbol = "<=>"

    @property
    def nullable(self):
        return False

    def columnar_eval(self, batch):
        l = self.left.columnar_eval(batch)
        r = self.right.columnar_eval(batch)
        if l.data.dtype.is_floating_point or r.data.dtype.is_floating_point:
            eq_vals = _float_compare_sign(l.data.to(torch.float64),
                                          r.data.to(torch.float64)) == 0
        else:
            eq_vals = l.data == r.data
        both_valid = l.validity & r.validity
        both_null = ~l.validity & ~r.validity
        data = (both_valid & eq_vals) | both_null
        return Column(data, torch.ones_like(data), BOOLEAN)


class And(Expression):
    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def with_children(self, children):
        return And(children[0], children[1])

    @property
    def data_type(self):
        return BOOLEAN

    def columnar_eval(self, batch):
        l = self.children[0].columnar_eval(batch)
        r = self.children[1].columnar_eval(batch)
        lv, rv = l.validity, r.validity
        ld = l.data & lv  # null is "unknown": its data lane is meaningless
        rd = r.data & rv
        false_l = lv & ~l.data
        false_r = rv & ~r.data
        data = ld & rd
        valid = (lv & rv) | false_l | false_r
        return Column(data & valid, valid, BOOLEAN)

    def __repr__(self):
        return f"({self.children[0]!r} AND {self.children[1]!r})"


class Or(Expression):
    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def with_children(self, children):
        return Or(children[0], children[1])

    @property
    def data_type(self):
        return BOOLEAN

    def columnar_eval(self, batch):
        l = self.children[0].columnar_eval(batch)
        r = self.children[1].columnar_eval(batch)
        lv, rv = l.validity, r.validity
        true_l = lv & l.data
        true_r = rv & r.data
        data = true_l | true_r
        valid = (lv & rv) | true_l | true_r
        return Column(data & valid, valid, BOOLEAN)

    def __repr__(self):
        return f"({self.children[0]!r} OR {self.children[1]!r})"


class Not(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, children):
        return Not(children[0])

    @property
    def data_type(self):
        return BOOLEAN

    def columnar_eval(self, batch):
        c = self.children[0].columnar_eval(batch)
        return Column(~c.data & c.validity, c.validity, BOOLEAN)

    def __repr__(self):
        return f"NOT {self.children[0]!r}"


class IsNull(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, children):
        return IsNull(children[0])

    @property
    def data_type(self):
        return BOOLEAN

    @property
    def nullable(self):
        return False

    def columnar_eval(self, batch):
        c = self.children[0].columnar_eval(batch)
        return Column(~c.validity, torch.ones_like(c.validity), BOOLEAN)


class IsNotNull(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, children):
        return IsNotNull(children[0])

    @property
    def data_type(self):
        return BOOLEAN

    @property
    def nullable(self):
        return False

    def columnar_eval(self, batch):
        c = self.children[0].columnar_eval(batch)
        return Column(c.validity, torch.ones_like(c.validity), BOOLEAN)
