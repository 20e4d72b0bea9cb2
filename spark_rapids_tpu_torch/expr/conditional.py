"""Conditional and null expressions — the counterpart of
spark_rapids_tpu/expr/conditional.py: If, CaseWhen, Coalesce, Nvl, Nvl2,
NullIf, IsNaN and NaNvl.

Columnar evaluation computes every branch and blends them row by row
with torch.where, as the JAX package does (Spark evaluates branches
lazily only for their side effects, which these expressions have none
of). A null predicate takes the else branch. The data under a null
result is zero, as everywhere in the engine. String results blend their
offsets and bytes (`_blend_strings`), with no comparison of bytes.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..columnar.column import Column, StringColumn
from ..types import BOOLEAN, NullType
from .core import Expression, Literal


def _blend(pred_data, pred_valid, t: Column, f: Column) -> Column:
    """`t` where the predicate is TRUE (valid and set), else `f`."""
    take_t = pred_data & pred_valid
    if isinstance(t, StringColumn) or isinstance(f, StringColumn):
        return _blend_strings(take_t, t, f)
    data = torch.where(take_t, t.data, f.data)
    valid = torch.where(take_t, t.validity, f.validity)
    return Column(torch.where(valid, data, torch.zeros((), dtype=data.dtype,
                                                       device=data.device)),
                  valid, t.dtype)


def _blend_strings(take_t, t: StringColumn, f: StringColumn) -> StringColumn:
    """Row-wise select between two string columns: new offsets from the
    chosen lengths, and each output byte read from its row's chosen side.
    The byte bucket is the sum of both inputs' (the selection can keep
    every byte of either)."""
    from ..ops.strings import _rebuild_offsets, _row_of_byte, string_lengths
    valid = torch.where(take_t, t.validity, f.validity)
    lengths = torch.where(valid, torch.where(take_t, string_lengths(t),
                                             string_lengths(f)), 0)
    new_offsets = _rebuild_offsets(lengths.to(torch.int32))
    byte_cap = t.byte_capacity + f.byte_capacity
    pos, row, intra = _row_of_byte(new_offsets, byte_cap, t.capacity)
    r = row.long()
    from_t = take_t[r]
    t_pos = torch.clamp(t.offsets[r] + intra, 0, t.byte_capacity - 1).long()
    f_pos = torch.clamp(f.offsets[r] + intra, 0, f.byte_capacity - 1).long()
    in_use = pos < new_offsets[-1]
    data = torch.where(in_use, torch.where(from_t, t.data[t_pos],
                                           f.data[f_pos]),
                       torch.zeros((), dtype=torch.uint8, device=pos.device))
    return StringColumn(data, new_offsets, valid, t.dtype)


class If(Expression):
    def __init__(self, pred: Expression, t: Expression, f: Expression):
        self.children = (pred, t, f)

    def with_children(self, children):
        return If(*children)

    @property
    def data_type(self):
        return self.children[1].data_type

    def columnar_eval(self, batch):
        p = self.children[0].columnar_eval(batch)
        t = self.children[1].columnar_eval(batch)
        f = self.children[2].columnar_eval(batch)
        return _blend(p.data, p.validity, t, f)


class CaseWhen(Expression):
    """CASE WHEN c1 THEN v1 ... ELSE e END: a right fold of If blends, so
    the first true branch wins; with no ELSE the result is a typed null."""

    def __init__(self, branches, else_value: Optional[Expression] = None):
        flat = []
        for c, v in branches:
            flat += [c, v]
        if else_value is not None:
            flat.append(else_value)
        self.children = tuple(flat)
        self.n_branches = len(branches)
        self.has_else = else_value is not None

    def with_children(self, children):
        n = self.n_branches
        branches = [(children[2 * i], children[2 * i + 1]) for i in range(n)]
        return CaseWhen(branches, children[-1] if self.has_else else None)

    @property
    def data_type(self):
        return self.children[1].data_type

    def columnar_eval(self, batch):
        if self.has_else:
            result = self.children[-1].columnar_eval(batch)
        else:
            result = Literal(None, self.data_type).columnar_eval(batch)
        for i in reversed(range(self.n_branches)):
            p = self.children[2 * i].columnar_eval(batch)
            v = self.children[2 * i + 1].columnar_eval(batch)
            result = _blend(p.data, p.validity, v, result)
        return result


class Coalesce(Expression):
    def __init__(self, *children: Expression):
        self.children = tuple(children)

    def with_children(self, children):
        return type(self)(*children)

    @property
    def data_type(self):
        for c in self.children:
            if not isinstance(c.data_type, NullType):
                return c.data_type
        return self.children[0].data_type

    def columnar_eval(self, batch):
        cols = [c.columnar_eval(batch) for c in self.children]
        result = cols[-1]
        for c in reversed(cols[:-1]):
            result = _blend(c.validity, torch.ones_like(c.validity), c,
                            result)
        return result


class Nvl(Coalesce):
    """nvl/ifnull(a, b) == coalesce(a, b)."""

    def __init__(self, a: Expression, b: Expression):
        super().__init__(a, b)


class Nvl2(Expression):
    """nvl2(a, b, c): b where a is not null, else c (both evaluated)."""

    def __init__(self, a: Expression, b: Expression, c: Expression):
        self.children = (a, b, c)

    def with_children(self, children):
        return Nvl2(*children)

    @property
    def data_type(self):
        return self.children[1].data_type

    def columnar_eval(self, batch):
        a, b, c = (e.columnar_eval(batch) for e in self.children)
        return _blend(a.validity, torch.ones_like(a.validity), b, c)


class NullIf(Expression):
    """nullif(a, b): null where a == b, else a."""

    def __init__(self, a: Expression, b: Expression):
        self.children = (a, b)

    def with_children(self, children):
        return NullIf(*children)

    @property
    def data_type(self):
        return self.children[0].data_type

    def columnar_eval(self, batch):
        a = self.children[0].columnar_eval(batch)
        b = self.children[1].columnar_eval(batch)
        if isinstance(a, StringColumn):
            from ..ops.strings import string_equal
            eq_col = string_equal(a, b)
            eq = eq_col.data & eq_col.validity
            return StringColumn(a.data, a.offsets, a.validity & ~eq,
                                a.dtype)
        eq = (a.data == b.data) & a.validity & b.validity
        valid = a.validity & ~eq
        return Column(torch.where(valid, a.data, torch.zeros(
            (), dtype=a.data.dtype, device=a.data.device)), valid, a.dtype)


class IsNaN(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, children):
        return IsNaN(children[0])

    @property
    def data_type(self):
        return BOOLEAN

    @property
    def nullable(self):
        return False

    def columnar_eval(self, batch):
        c = self.children[0].columnar_eval(batch)
        return Column(torch.isnan(c.data) & c.validity,
                      torch.ones_like(c.validity), BOOLEAN)


class NaNvl(Expression):
    """nanvl(a, b): a unless a is NaN, then b (the chosen side's null)."""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def with_children(self, children):
        return NaNvl(*children)

    @property
    def data_type(self):
        return self.children[0].data_type

    def columnar_eval(self, batch):
        a = self.children[0].columnar_eval(batch)
        b = self.children[1].columnar_eval(batch)
        use_b = torch.isnan(a.data) & a.validity
        data = torch.where(use_b, b.data.to(a.data.dtype), a.data)
        valid = torch.where(use_b, b.validity, a.validity)
        return Column(torch.where(valid, data, torch.zeros(
            (), dtype=data.dtype, device=data.device)), valid, a.dtype)
