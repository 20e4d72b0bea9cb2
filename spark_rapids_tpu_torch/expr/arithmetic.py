"""Arithmetic expressions with Spark semantics (non-ANSI mode) — the
counterpart of spark_rapids_tpu/expr/arithmetic.py:

  * integral overflow wraps (Java semantics; torch integer ops wrap);
  * Divide / IntegralDivide / Remainder / Pmod return NULL when the
    divisor is 0 (Spark's non-ANSI behaviour, unlike IEEE);
  * binary operands promote to the wider numeric type;
  * a decimal operand takes Spark's DecimalPrecision result type
    (expr/decimal_rules.py) and computes on unscaled lanes: one int64
    lane up to 18 digits, the two limbs of ops/decimal128.py past them;
    a result past its precision is NULL.

The fused scan-aggregate kernel (ops/fused_scan_agg.py) translates Add,
Subtract, Multiply, Divide, UnaryMinus and Abs over non-decimal inputs;
it refuses every decimal expression.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..types import (DOUBLE, LONG, DataType, DecimalType, FractionalType,
                     numeric_promote)
from .core import Expression

def _promote(l: Column, r: Column, target: DataType):
    ld = l.data.to(target.torch_dtype) if l.dtype != target else l.data
    rd = r.data.to(target.torch_dtype) if r.dtype != target else r.data
    return ld, rd


def _zero(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=t.dtype, device=t.device)


def _masked(data: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """`data` with zero under the null rows."""
    return torch.where(valid, data, _zero(data))


def _trunc_div(a, b):
    """Integer division truncated toward zero, as Java's `/`:
    MIN / -1 wraps to MIN, as XLA's division does (the CPU would trap)."""
    wraps = (a == torch.iinfo(a.dtype).min) & (b == -1)
    q = torch.div(a, torch.where(wraps, torch.ones_like(b), b),
                  rounding_mode="trunc")
    return torch.where(wraps, a, q)


def _trunc_mod(a, b):
    return a - _trunc_div(a, b) * b


def _round_div_half_up(a, m):
    """(a / m) rounded HALF_UP on int lanes (m a positive int)."""
    half = m // 2
    adj = torch.where(a >= 0, a + half, a - half)
    if not isinstance(m, torch.Tensor):
        m = torch.full_like(a, m)
    return _trunc_div(adj, m)


def _round_div_half_up_signed(a, b):
    """(a / b) rounded HALF_UP where b may be negative (lanes)."""
    one = torch.ones_like(a)
    sign = torch.where((a >= 0) == (b >= 0), one, -one)
    ab = torch.abs(b)
    half = torch.div(ab, 2, rounding_mode="floor")
    mag = _trunc_div(torch.abs(a) + half, ab)
    return sign * mag


def _decimal_scale_of(dt: DataType) -> int:
    if isinstance(dt, DecimalType):
        return dt.scale
    return 0  # an integral operand is decimal(p, 0)


def _rescale_unscaled(data, from_scale: int, to_scale: int):
    if to_scale == from_scale:
        return data
    if to_scale > from_scale:
        return data * 10 ** (to_scale - from_scale)
    return _round_div_half_up(data, 10 ** (from_scale - to_scale))


def _limbs(c: Column):
    from ..columnar.column import Decimal128Column
    from ..ops import decimal128 as D
    if isinstance(c, Decimal128Column):
        return c.hi.data, c.lo.data
    return D.from_i64(c.data.to(torch.int64))


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
        if isinstance(lt, DecimalType) or isinstance(rt, DecimalType):
            return self._decimal_type(lt, rt)
        if lt == rt:
            return lt
        return numeric_promote(lt, rt)

    def _decimal_type(self, lt, rt) -> DataType:
        from .decimal_rules import binary_result_type
        return binary_result_type(type(self).__name__, lt, rt)

    def columnar_eval(self, batch) -> Column:
        l = self.left.columnar_eval(batch)
        r = self.right.columnar_eval(batch)
        out_t = self.data_type
        if isinstance(out_t, DecimalType):
            return self._decimal_eval(l, r, out_t)
        ld, rd = _promote(l, r, out_t)
        valid = l.validity & r.validity
        data = self._op(ld, rd)
        data = _masked(data, valid)
        return Column(data, valid, out_t)

    def _decimal_eval(self, l: Column, r: Column,
                      out_t: DecimalType) -> Column:
        """Decimal arithmetic on unscaled lanes: rescale to a common
        working scale, operate, rescale HALF_UP to the result scale;
        overflow past the result precision -> NULL. Results or inputs
        past 18 digits take the two-limb path."""
        from ..columnar.column import Decimal128Column
        name = type(self).__name__
        if out_t.precision > 18 or isinstance(l, Decimal128Column) \
                or isinstance(r, Decimal128Column):
            return self._decimal128_eval(l, r, out_t)
        s1 = _decimal_scale_of(l.dtype)
        s2 = _decimal_scale_of(r.dtype)
        valid = l.validity & r.validity
        ld = l.data.to(torch.int64)
        rd = r.data.to(torch.int64)
        if name in ("Add", "Subtract"):
            ws = max(s1, s2)
            a = _rescale_unscaled(ld, s1, ws)
            b = _rescale_unscaled(rd, s2, ws)
            res = a + b if name == "Add" else a - b
            res = _rescale_unscaled(res, ws, out_t.scale)
        elif name == "Multiply":
            res = _rescale_unscaled(ld * rd, s1 + s2, out_t.scale)
        elif name == "Divide":
            # l / r at result scale rs: unscaled = l * 10^(rs - s1 + s2) / r
            shift = out_t.scale - s1 + s2
            num = ld * 10 ** max(shift, 0)
            if shift < 0:
                num = _round_div_half_up(num, 10 ** (-shift))
            div_ok = rd != 0
            res = _round_div_half_up_signed(
                num, torch.where(div_ok, rd, torch.ones_like(rd)))
            valid = valid & div_ok
        elif name in ("Remainder", "Pmod"):
            ws = max(s1, s2)
            a = _rescale_unscaled(ld, s1, ws)
            b = _rescale_unscaled(rd, s2, ws)
            div_ok = b != 0
            safe_b = torch.where(div_ok, b, torch.ones_like(b))
            res = _trunc_mod(a, safe_b)
            if name == "Pmod":
                res = torch.where(res < 0, res + torch.abs(safe_b), res)
            res = _rescale_unscaled(res, ws, out_t.scale)
            valid = valid & div_ok
        else:
            raise TypeError(f"no decimal eval for {name}")
        bound = 10 ** min(out_t.precision, 18)
        valid = valid & (res < bound) & (res > -bound)
        return Column(_masked(res, valid), valid, out_t)

    def _decimal128_eval(self, l: Column, r: Column,
                         out_t: DecimalType) -> Column:
        """Two-limb path for results (or inputs) past 18 digits. A
        multiply or divide with a >18-digit input is tagged off at plan
        time (plan/overrides.py `_tag_decimal128`), as in the JAX
        package."""
        from ..columnar.column import Decimal128Column
        from ..ops import decimal128 as D
        name = type(self).__name__
        s1 = _decimal_scale_of(l.dtype)
        s2 = _decimal_scale_of(r.dtype)
        valid = l.validity & r.validity
        wide = isinstance(l, Decimal128Column) \
            or isinstance(r, Decimal128Column)
        over = torch.zeros_like(valid)
        if name in ("Add", "Subtract"):
            ws = max(s1, s2)
            h1, l1 = _limbs(l)
            h2, l2 = _limbs(r)
            h1, l1, o1 = D.rescale(h1, l1, s1, ws)
            h2, l2, o2 = D.rescale(h2, l2, s2, ws)
            fn = D.add128 if name == "Add" else D.sub128
            rh, rl = fn(h1, l1, h2, l2)
            rh, rl, o3 = D.rescale(rh, rl, ws, out_t.scale)
            over = o1 | o2 | o3
        elif name == "Multiply":
            if wide:
                raise NotImplementedError(
                    "decimal multiply with >18-digit inputs needs a "
                    "256-bit intermediate (tagged off at plan time)")
            rh, rl = D.mul_i64_i64(l.data.to(torch.int64),
                                   r.data.to(torch.int64))
            rh, rl, over = D.rescale(rh, rl, s1 + s2, out_t.scale)
        elif name == "Divide":
            if wide:
                raise NotImplementedError(
                    "decimal divide with >18-digit inputs is tagged off "
                    "at plan time")
            # unscaled = l * 10^(rs - s1 + s2) / r, HALF_UP
            shift = out_t.scale - s1 + s2
            nh, nl = D.from_i64(l.data.to(torch.int64))
            nh, nl, over = D.rescale(nh, nl, 0, max(shift, 0))
            if shift < 0:
                nh, nl, _ = D.rescale(nh, nl, -shift, 0)
            rd = r.data.to(torch.int64)
            div_ok = rd != 0
            rh, rl = D.div128_round_half_up(
                nh, nl, torch.where(div_ok, rd, torch.ones_like(rd)))
            valid = valid & div_ok
        else:
            raise NotImplementedError(
                f"decimal128 {name} has no device kernel, and a decimal "
                "never runs on the host row engine: the planner tags it "
                "off, as in the JAX package")
        valid = valid & D.fits_precision(rh, rl, out_t.precision) & ~over
        rh = _masked(rh, valid)
        rl = _masked(rl, valid)
        if out_t.precision <= 18:
            return Column(rl, valid, out_t)  # fits one limb by the check
        return Decimal128Column.from_limbs(rh, rl, valid, out_t)

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
        lt, rt = self.left.data_type, self.right.data_type
        if isinstance(lt, DecimalType) or isinstance(rt, DecimalType):
            return self._decimal_type(lt, rt)
        return DOUBLE

    def columnar_eval(self, batch):
        l = self.left.columnar_eval(batch)
        r = self.right.columnar_eval(batch)
        out_t = self.data_type
        if isinstance(out_t, DecimalType):
            return self._decimal_eval(l, r, out_t)
        ld, rd = _promote(l, r, out_t)
        div_ok = rd != 0
        valid = l.validity & r.validity & div_ok
        data = ld / torch.where(div_ok, rd, torch.ones_like(rd))
        data = torch.where(valid, data, torch.zeros_like(data))
        return Column(data, valid, out_t)


class IntegralDivide(BinaryArithmetic):
    """Spark `div`: long result, truncated toward zero; NULL on a zero
    divisor."""
    symbol = "div"

    @property
    def data_type(self):
        return LONG

    def columnar_eval(self, batch):
        l = self.left.columnar_eval(batch)
        r = self.right.columnar_eval(batch)
        s1 = _decimal_scale_of(l.dtype)
        s2 = _decimal_scale_of(r.dtype)
        ws = max(s1, s2)
        ld = _rescale_unscaled(l.data.to(torch.int64), s1, ws)
        rd = _rescale_unscaled(r.data.to(torch.int64), s2, ws)
        div_ok = rd != 0
        valid = l.validity & r.validity & div_ok
        q = _trunc_div(ld, torch.where(div_ok, rd, torch.ones_like(rd)))
        return Column(_masked(q, valid), valid, LONG)


def _frac_rem(x, safe_r):
    return x - torch.trunc(x / safe_r) * safe_r


class Remainder(BinaryArithmetic):
    """Spark `%`: the sign of the dividend (Java); NULL on a zero
    divisor."""
    symbol = "%"

    def columnar_eval(self, batch):
        l = self.left.columnar_eval(batch)
        r = self.right.columnar_eval(batch)
        out_t = self.data_type
        if isinstance(out_t, DecimalType):
            return self._decimal_eval(l, r, out_t)
        ld, rd = _promote(l, r, out_t)
        div_ok = rd != 0
        safe_r = torch.where(div_ok, rd, torch.ones_like(rd))
        if isinstance(out_t, FractionalType):
            data = _frac_rem(ld, safe_r)
        else:
            data = _trunc_mod(ld, safe_r)
        valid = l.validity & r.validity & div_ok
        return Column(_masked(data, valid), valid, out_t)


class Pmod(BinaryArithmetic):
    """Spark pmod (`r = a % n; r < 0 ? (r + n) % n : r`, Java remainder):
    non-negative for positive divisors, negative results for n < 0
    (pmod(-7, -2) = -1 in Spark). NULL on a zero divisor."""
    symbol = "pmod"

    def columnar_eval(self, batch):
        l = self.left.columnar_eval(batch)
        r = self.right.columnar_eval(batch)
        out_t = self.data_type
        if isinstance(out_t, DecimalType):
            return self._decimal_eval(l, r, out_t)
        ld, rd = _promote(l, r, out_t)
        div_ok = rd != 0
        safe_r = torch.where(div_ok, rd, torch.ones_like(rd))
        if isinstance(out_t, FractionalType):
            def rem(x):
                return _frac_rem(x, safe_r)
        else:
            def rem(x):
                return _trunc_mod(x, safe_r)
        r0 = rem(ld)
        m = torch.where(r0 < 0, rem(r0 + safe_r), r0)
        valid = l.validity & r.validity & div_ok
        return Column(_masked(m, valid), valid, out_t)


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


class Least(Expression):
    """Spark least(): null-skipping minimum across children."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def data_type(self):
        return self.children[0].data_type

    def with_children(self, children):
        return Least(*children)

    def columnar_eval(self, batch):
        return _least_greatest(self, batch, want_smaller=True)


class Greatest(Expression):
    """Spark greatest(): null-skipping maximum across children."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def data_type(self):
        return self.children[0].data_type

    def with_children(self, children):
        return Greatest(*children)

    def columnar_eval(self, batch):
        return _least_greatest(self, batch, want_smaller=False)


def _least_greatest(node, batch, want_smaller: bool):
    """Null-skipping min/max across children with Java float ordering
    (NaN greatest), as Spark's least()/greatest()."""
    from .predicates import _float_compare_sign
    cols = [c.columnar_eval(batch) for c in node.children]
    out_t = node.data_type
    data = valid = None
    for c in cols:
        d = c.data.to(out_t.torch_dtype)
        if data is None:
            data, valid = d, c.validity
            continue
        if d.is_floating_point():
            sign = _float_compare_sign(d, data)
            better = (sign < 0) if want_smaller else (sign > 0)
        else:
            better = (d < data) if want_smaller else (d > data)
        take_new = c.validity & (~valid | better)
        data = torch.where(take_new, d, data)
        valid = valid | c.validity
    return Column(_masked(data, valid), valid, out_t)
