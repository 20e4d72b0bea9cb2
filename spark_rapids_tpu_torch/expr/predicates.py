"""Predicates & comparisons with Spark's three-valued logic — the
counterpart of spark_rapids_tpu/expr/predicates.py (fixed-width operands,
and dictionary-encoded strings in code space):
  AND: F && anything = F ;  T && NULL = NULL
  OR : T || anything = T ;  F || NULL = NULL
Float comparisons use Spark's total order: NaN equals NaN and sorts
above every other value.

`EqualTo` of a dictionary column and a string literal, and `In` over
string literals, evaluate on the codes (columnar/encoded.py); any other
comparison that meets a dictionary column raises TypeError (the exec
layer decodes first: `encoded_safe_predicate`). Decoded strings compare
as bytes: the orderings through ops/strings.string_compare_cols (a loop
over the common prefix, one counted host read), equality and `In`
through ops/strings.string_equal (no loop), where the JAX package takes
the compare's sign for both.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column, StringColumn
from ..columnar.encoded import DictionaryColumn, encoded_equal_literal
from ..ops.strings import string_compare_cols, string_equal
from ..types import BOOLEAN, BinaryType, DataType, StringType, numeric_promote
from .core import Alias, BoundReference, Expression, Literal, \
    UnresolvedAttribute, lit


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
        # the column operand first: a dictionary column fails loudly
        # before a string literal is expanded to its rows
        order = (1, 0) if isinstance(self.left, Literal) else (0, 1)
        cols = [None, None]
        for i in order:
            cols[i] = self.children[i].columnar_eval(batch)
            if isinstance(cols[i], DictionaryColumn):
                # only EqualTo against a literal has a code-space lane
                # (taken in EqualTo.columnar_eval); fail loudly instead of
                # misreading the encoded layout
                raise TypeError(
                    "dictionary-encoded column reached a non-code-space "
                    "comparison — materialize first (columnar/encoded.py)")
        return self._compare_cols(*cols)

    def _compare_cols(self, l: Column, r: Column) -> Column:
        valid = l.validity & r.validity
        if isinstance(l, StringColumn) or isinstance(r, StringColumn):
            data = self._compare_strings(l, r)
            return Column(data & valid, valid, BOOLEAN)
        common = l.dtype if l.dtype == r.dtype \
            else numeric_promote(l.dtype, r.dtype)
        ld = l.data.to(common.torch_dtype)
        rd = r.data.to(common.torch_dtype)
        if ld.dtype.is_floating_point:
            data = self._cmp_from_sign(_float_compare_sign(ld, rd))
        else:
            data = self._op(ld, rd)
        return Column(data & valid, valid, BOOLEAN)

    def _compare_strings(self, l: StringColumn, r: StringColumn):
        return self._cmp_from_sign(string_compare_cols(l, r))

    def _op(self, l, r):
        raise NotImplementedError

    def _cmp_from_sign(self, cmp):
        raise NotImplementedError

    def __repr__(self):
        return f"({self.children[0]!r} {self.symbol} {self.children[1]!r})"


class EqualTo(BinaryComparison):
    symbol = "="

    def columnar_eval(self, batch) -> Column:
        """Code-space lane: `dictionary column == literal` matches the
        literal against the dictionary once and takes each row's answer
        by its code (columnar/encoded.encoded_equal_literal), never
        decoding a row. Everything else takes the generic path."""
        lit_l = isinstance(self.left, Literal)
        if lit_l != isinstance(self.right, Literal):
            other, literal = (self.right, self.left) if lit_l \
                else (self.left, self.right)
            return self.against_literal(other.columnar_eval(batch), literal,
                                        batch)
        return super().columnar_eval(batch)

    def against_literal(self, c: Column, literal: Literal, batch) -> Column:
        """`c == literal` for the evaluated other operand `c`: on the
        codes for a dictionary column, else the generic comparison."""
        if isinstance(c, DictionaryColumn):
            return encoded_equal_literal(c, literal.value)
        return self._compare_cols(c, literal.columnar_eval(batch))

    def _compare_strings(self, l: StringColumn, r: StringColumn):
        # equal lengths and bytes: the compare's sign == 0 without its loop
        return string_equal(l, r).data

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


class In(Expression):
    """Spark IN over a literal list: a null list item gives NULL where no
    item matched (three-valued membership). Each item is one EqualTo, so
    a dictionary column answers every item in code space."""

    def __init__(self, value: Expression, items):
        self.children = (value,)
        self.items = tuple(items)

    def with_children(self, children):
        return In(children[0], self.items)

    @property
    def data_type(self):
        return BOOLEAN

    def columnar_eval(self, batch):
        c = self.children[0]
        v = c.columnar_eval(batch)
        has_null = any(i is None for i in self.items)
        hit = None
        for item in self.items:
            if item is None:
                continue
            eq = EqualTo(c, lit(item))
            e = eq.against_literal(v, eq.right, batch)
            hit = e.data if hit is None else (hit | e.data)
        if hit is None:
            hit = torch.zeros_like(v.validity)
        valid = v.validity & (hit | (not has_null))
        return Column(hit & valid, valid, BOOLEAN)

    def __repr__(self):
        return f"({self.children[0]!r} IN {self.items!r})"


# -- encoded-execution eligibility walk --------------------------------------
# Can this expression evaluate correctly when its string-typed inputs
# arrive as DictionaryColumns? The positions with a code-space lane:
# equality/IN against a literal, null checks, bare pass-through references,
# and And/Or/Not compositions of those. An unrecognized node is safe only
# when no string/binary-typed reference occurs anywhere below it.

def _string_free_subtree(e: Expression) -> bool:
    """True when no string/binary-typed column reference occurs in the
    subtree. Unresolved attributes (no type known) count as possibly
    string: False."""
    if isinstance(e, UnresolvedAttribute):
        return False
    if isinstance(e, BoundReference):
        return not isinstance(e.data_type, (StringType, BinaryType))
    return all(_string_free_subtree(c) for c in e.children)


def _encoded_operand(e: Expression) -> bool:
    """A position whose evaluation tolerates an encoded column directly
    (bare reference) or never produces one (string-free subtree)."""
    if isinstance(e, Alias):
        return _encoded_operand(e.children[0])
    if isinstance(e, (BoundReference, UnresolvedAttribute)):
        return True
    return _string_free_subtree(e)


def encoded_safe_predicate(e: Expression) -> bool:
    """True when the predicate evaluates correctly over a batch whose
    string columns are dictionary-encoded."""
    if isinstance(e, (And, Or)):
        return all(encoded_safe_predicate(c) for c in e.children)
    if isinstance(e, Not):
        return encoded_safe_predicate(e.children[0])
    if isinstance(e, (IsNull, IsNotNull)):
        return True   # validity lane only: works on any column class
    if isinstance(e, EqualTo):
        l, r = e.children
        if isinstance(r, Literal):
            return _encoded_operand(l)
        if isinstance(l, Literal):
            return _encoded_operand(r)
        return _string_free_subtree(e)
    if isinstance(e, In):
        return _encoded_operand(e.children[0])
    if isinstance(e, EqualNullSafe) and isinstance(e.children[1], Literal) \
            and e.children[1].data_type == BOOLEAN:
        # `p IS TRUE` (Delta's DML conditions): p's own walk
        return encoded_safe_predicate(e.children[0])
    return _string_free_subtree(e)


def encoded_safe_projection(e: Expression) -> bool:
    """True when a projection expression evaluates correctly over encoded
    input: bare (aliased) references carry the encoded column forward
    untouched; predicates reduce to the walk above; anything else is safe
    only when string-reference-free."""
    if isinstance(e, Alias):
        return encoded_safe_projection(e.children[0])
    return _encoded_operand(e) or encoded_safe_predicate(e)
