"""Math expressions — the counterpart of spark_rapids_tpu/expr/math.py
(reference mathExpressions.scala): the unary transcendentals over
doubles, with Spark's NULL for the logarithms of non-positive inputs,
Pow and Atan2, Floor and Ceil, and Round (HALF_UP) and BRound
(HALF_EVEN).

The transcendentals are torch's, which may differ from XLA's in the last
bits (tests/test_torch_math_bitwise.py states the ulp bound of each).
A DECIMAL input is read as its value (unscaled / 10^scale), and Floor,
Ceil, Round and BRound of a DECIMAL round its value exactly on the
unscaled lane. The JAX package reads the unscaled lane as if it were the
value there (ROADMAP C.5): the port does not copy that.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..types import DOUBLE, LONG, DataType, DecimalType, IntegralType
from .core import Expression


def _as_f64(c: Column) -> torch.Tensor:
    if isinstance(c.dtype, DecimalType):
        if c.dtype.is_decimal128:
            raise NotImplementedError(
                "math over decimal128 is tagged off at plan time")
        return c.data.to(torch.float64) / float(10 ** c.dtype.scale)
    return c.data.to(torch.float64)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root: pow(|x|, 1/3) with one Newton step, the sign kept."""
    a = torch.abs(x)
    y = torch.pow(a, 1.0 / 3.0)
    ok = torch.isfinite(y) & (y > 0)
    ys = torch.where(ok, y, torch.ones_like(y))
    y = torch.where(ok, ys - (ys * ys * ys - a) / (3.0 * ys * ys), y)
    return torch.where(x < 0, -y, y)


def _signum(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign: NaN stays NaN, a zero keeps its sign."""
    one = torch.ones_like(x)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


class UnaryMath(Expression):
    """double -> double elementwise; the input read as a double."""

    fn = None
    #: non-positive inputs produce NULL (Spark's log family)
    null_on_nonpositive = False
    null_on_negative = False
    #: lower bound (exclusive) below which the result is NULL (log1p: -1)
    null_below = None

    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, children):
        return type(self)(children[0])

    @property
    def data_type(self) -> DataType:
        return DOUBLE

    def columnar_eval(self, batch):
        c = self.children[0].columnar_eval(batch)
        x = _as_f64(c)
        valid = c.validity
        if self.null_on_nonpositive:
            ok = x > 0
            valid = valid & ok
            x = torch.where(ok, x, 1.0)
        if self.null_on_negative:
            ok = x >= 0
            valid = valid & ok
            x = torch.where(ok, x, 0.0)
        if self.null_below is not None:
            ok = x > self.null_below
            valid = valid & ok
            x = torch.where(ok, x, 0.0)
        data = type(self).fn(x)
        return Column(torch.where(valid, data, 0.0), valid, DOUBLE)


def _mk(name, fn, **attrs):
    return type(name, (UnaryMath,), {"fn": staticmethod(fn), **attrs})


Sqrt = _mk("Sqrt", torch.sqrt)  # Spark sqrt(-x) -> NaN (not null)
Exp = _mk("Exp", torch.exp)
Expm1 = _mk("Expm1", torch.expm1)
Log = _mk("Log", torch.log, null_on_nonpositive=True)
Log2 = _mk("Log2", torch.log2, null_on_nonpositive=True)
Log10 = _mk("Log10", torch.log10, null_on_nonpositive=True)
Log1p = _mk("Log1p", torch.log1p, null_below=-1.0)
Sin = _mk("Sin", torch.sin)
Cos = _mk("Cos", torch.cos)
Tan = _mk("Tan", torch.tan)
Asin = _mk("Asin", torch.asin)
Acos = _mk("Acos", torch.acos)
Atan = _mk("Atan", torch.atan)
Sinh = _mk("Sinh", torch.sinh)
Cosh = _mk("Cosh", torch.cosh)
Tanh = _mk("Tanh", torch.tanh)
Asinh = _mk("Asinh", torch.asinh)
Acosh = _mk("Acosh", torch.acosh)
Atanh = _mk("Atanh", torch.atanh)
Cbrt = _mk("Cbrt", _cbrt)
ToDegrees = _mk("ToDegrees", torch.rad2deg)
ToRadians = _mk("ToRadians", torch.deg2rad)
Signum = _mk("Signum", _signum)
Rint = _mk("Rint", torch.round)  # half to even


class _BinaryMath(Expression):
    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def with_children(self, children):
        return type(self)(*children)

    @property
    def data_type(self):
        return DOUBLE

    def columnar_eval(self, batch):
        l = self.children[0].columnar_eval(batch)
        r = self.children[1].columnar_eval(batch)
        valid = l.validity & r.validity
        data = type(self).fn(_as_f64(l), _as_f64(r))
        return Column(torch.where(valid, data, 0.0), valid, DOUBLE)


class Pow(_BinaryMath):
    fn = staticmethod(torch.pow)


class Atan2(_BinaryMath):
    fn = staticmethod(torch.atan2)


def _decimal_round(c: Column, digits: int, mode: str):
    """The unscaled lane of a DECIMAL(p<=18) rounded to `digits` places
    of its value (mode 'half_up', 'half_even', 'floor' or 'ceil'), still
    at the column's scale; NULL past its precision."""
    dt = c.dtype
    k = dt.scale - digits
    if k <= 0:
        return c.data
    if k > 18:
        return torch.zeros_like(c.data)
    m = 10 ** k
    q = torch.div(c.data, m, rounding_mode="floor")
    r = c.data - q * m                        # 0 <= r < m
    twice = 2 * r
    if mode == "floor":
        up = torch.zeros_like(r, dtype=torch.bool)
    elif mode == "ceil":
        up = r > 0
    elif mode == "half_up":
        # a tie rounds away from zero: up for a positive value only
        up = (twice > m) | ((twice == m) & (c.data >= 0))
    else:
        # a tie rounds to the even neighbour
        up = (twice > m) | ((twice == m) & (torch.remainder(q, 2) == 1))
    return (q + up.to(torch.int64)) * m


def _decimal_fits(data, dt: DecimalType):
    bound = 10 ** dt.precision
    return (data < bound) & (data > -bound)


class Floor(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, children):
        return type(self)(children[0])

    @property
    def data_type(self):
        dt = self.children[0].data_type
        return dt if isinstance(dt, IntegralType) else LONG

    _mode = "floor"
    _fn = staticmethod(torch.floor)

    def columnar_eval(self, batch):
        c = self.children[0].columnar_eval(batch)
        if isinstance(c.dtype, IntegralType):
            return c
        if isinstance(c.dtype, DecimalType):
            data = torch.div(_decimal_round(c, 0, self._mode),
                             10 ** c.dtype.scale, rounding_mode="floor")
        else:
            from .cast import _to_int64_saturating
            data = _to_int64_saturating(type(self)._fn(c.data))
        return Column(torch.where(c.validity, data, 0), c.validity, LONG)


class Ceil(Floor):
    _mode = "ceil"
    _fn = staticmethod(torch.ceil)


def _round_half_up(x, scale: int):
    m = 10.0 ** scale
    scaled = x * m
    # HALF_UP: away from zero at .5 (Java BigDecimal ROUND_HALF_UP)
    return torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                       torch.ceil(scaled - 0.5)) / m


def _round_half_even(x, scale: int):
    m = 10.0 ** scale
    return torch.round(x * m) / m


class Round(Expression):
    """Spark round(col, scale): HALF_UP."""

    _mode = "half_up"

    def __init__(self, child: Expression, scale: int = 0):
        self.children = (child,)
        self.scale = scale

    def with_children(self, children):
        return type(self)(children[0], self.scale)

    @property
    def data_type(self):
        return self.children[0].data_type

    def columnar_eval(self, batch):
        c = self.children[0].columnar_eval(batch)
        dt = c.dtype
        if isinstance(dt, DecimalType):
            if dt.is_decimal128:
                raise NotImplementedError(
                    "round of decimal128 is tagged off at plan time")
            data = _decimal_round(c, self.scale, self._mode)
            valid = c.validity & _decimal_fits(data, dt)
            return Column(torch.where(valid, data, 0), valid, dt)
        if isinstance(dt, IntegralType):
            return self._round_integral(c)
        fn = _round_half_up if self._mode == "half_up" else _round_half_even
        data = fn(c.data.to(torch.float64), self.scale).to(dt.torch_dtype)
        return Column(torch.where(c.validity, data, 0), c.validity, dt)

    def _round_integral(self, c: Column) -> Column:
        if self.scale >= 0:
            return c
        from .arithmetic import _round_div_half_up
        m = 10 ** (-self.scale)
        data = _round_div_half_up(c.data, m) * m
        return Column(torch.where(c.validity, data, 0), c.validity, c.dtype)


class BRound(Round):
    """Spark bround: HALF_EVEN. An integral input with a negative scale
    rounds exactly on its integer lane (the JAX package rounds it through
    a double, which agrees while the value has 53 bits)."""

    _mode = "half_even"

    def _round_integral(self, c: Column) -> Column:
        if self.scale >= 0:
            return c
        m = 10 ** (-self.scale)
        x = c.data.to(torch.int64)
        q = torch.div(x, m, rounding_mode="floor")
        twice = 2 * (x - q * m)
        up = (twice > m) | ((twice == m) & (torch.remainder(q, 2) == 1))
        # past the type's range the value saturates, as the JAX
        # package's conversion from a double does
        info = torch.iinfo(c.dtype.torch_dtype)
        data = torch.clamp((q + up.to(torch.int64)) * m, info.min,
                           info.max).to(c.dtype.torch_dtype)
        return Column(torch.where(c.validity, data, 0), c.validity, c.dtype)
