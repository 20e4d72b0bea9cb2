"""The host row engine — the counterpart of spark_rapids_tpu/exec/fallback.py
(the reference's convertToCpu path: GpuOverrides.scala:4427 hands a node
to Spark's CPU operators, with GpuColumnarToRowExec.scala:335 and
GpuRowToColumnarExec.scala:861 at the boundary).

As in the JAX package, the engine ships its own host row engine: a Python
interpreter over the same expression tree, one evaluator per expression
class (`_EVALS`, the special forms, each class's `host_eval_row` or
`host_eval_with_row`). It is a placement the planner makes at plan time
for a Project or Filter whose expressions lack a device path
(`supports_host_eval` must hold for all of them), shown with `~` in
explain(); nothing catches a device error at run time and sends the work
here. A tree the host cannot evaluate still tags off.

    RowToColumnarExec                       (one packed upload a batch)
      HostProjectExec / HostFilterExec      (the row engine)
        ColumnarToRowExec                   (one packed fetch a batch)
          ... device plan ...

Host rows carry the port's `to_pylist` values: a DATE as its days, a
TIMESTAMP as its microseconds, a DECIMAL as its unscaled int. So a
decimal-typed tree never falls back (Python arithmetic would ignore
Spark's rescale rules), as in the JAX package.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterator, List, Sequence, Type

from ..columnar.batch import ColumnarBatch
from ..expr import arithmetic as A
from ..expr import conditional as C
from ..expr import predicates as P
from ..expr import stringexprs as S
from ..expr.cast import Cast
from ..expr.core import (Alias, BoundReference, Expression, Literal,
                         UnresolvedAttribute, output_name, resolve)
from ..types import (BooleanType, ByteType, DecimalType, DoubleType,
                     FloatType, IntegerType, LongType, Schema, ShortType,
                     StringType, StructField, TimestampType)
from .base import TpuExec

_I64 = (1 << 64)


def _wrap64(v: int) -> int:
    """Java long overflow (the device lanes wrap the same way)."""
    v &= _I64 - 1
    return v - _I64 if v >= (1 << 63) else v


class HostEvalUnsupported(Exception):
    pass


# ---------------------------------------------------------------------------
# host evaluator registry
# ---------------------------------------------------------------------------

_EVALS: Dict[Type[Expression], Callable] = {}


def _reg(cls, fn: Callable, null_intolerant: bool = True):
    if null_intolerant:
        def wrapped(expr, *vals, _fn=fn):
            if any(v is None for v in vals):
                return None
            return _fn(expr, *vals)
        _EVALS[cls] = wrapped
    else:
        _EVALS[cls] = fn


_INT_TYPES = (ByteType, ShortType, IntegerType, LongType)


def _is_int_expr(expr) -> bool:
    """Whether `expr` is of an integral type, kept on the node after the
    first row (a data type is computed from the whole subtree)."""
    got = expr.__dict__.get("_host_int")
    if got is None:
        try:
            got = isinstance(expr.data_type, _INT_TYPES)
        except (TypeError, NotImplementedError):
            got = False
        expr._host_int = got
    return got


def _arith(op):
    def fn(expr, a, b):
        r = op(a, b)
        return _wrap64(r) if _is_int_expr(expr) and isinstance(r, int) \
            and not isinstance(r, bool) else r
    return fn


_reg(A.Add, _arith(lambda a, b: a + b))
_reg(A.Subtract, _arith(lambda a, b: a - b))
_reg(A.Multiply, _arith(lambda a, b: a * b))
_reg(A.Divide, lambda e, a, b: None if b == 0 else a / b)
_reg(A.IntegralDivide,
     lambda e, a, b: None if b == 0 else _wrap64(int(a // b)
                                                 if (a < 0) == (b < 0)
                                                 else -(-a // b if a < 0
                                                        else a // -b)))


def _java_rem(a, b):
    """Java % (the sign of the dividend); integers by exact truncated
    division, as a float division would corrupt longs past 2^53."""
    if isinstance(a, float) or isinstance(b, float):
        return math.fmod(a, b)
    q = abs(a) // abs(b)
    if (a < 0) != (b < 0):
        q = -q
    return a - q * b


def _pmod(e, a, b):
    """Spark's Pmod: r = a % n; r < 0 ? (r + n) % n : r, with Java's
    remainder, as the device kernel computes it."""
    if b == 0:
        return None
    r = _java_rem(a, b)
    return _java_rem(r + b, b) if r < 0 else r


_reg(A.Remainder, lambda e, a, b: None if b == 0 else _java_rem(a, b))
_reg(A.Pmod, _pmod)
_reg(A.UnaryMinus, lambda e, a: _wrap64(-a) if _is_int_expr(e) else -a)
_reg(A.Abs, lambda e, a: _wrap64(abs(a)) if _is_int_expr(e) else abs(a))
_reg(A.Least, lambda e, *vs: min(vs), null_intolerant=False)
_reg(A.Greatest, lambda e, *vs: max(vs), null_intolerant=False)


def _ignore_null_minmax(fn):
    def out(expr, *vals):
        vs = [v for v in vals if v is not None]
        return fn(vs) if vs else None
    return out


_EVALS[A.Least] = _ignore_null_minmax(min)
_EVALS[A.Greatest] = _ignore_null_minmax(max)

_reg(P.EqualTo, lambda e, a, b: a == b)
_reg(P.LessThan, lambda e, a, b: a < b)
_reg(P.LessThanOrEqual, lambda e, a, b: a <= b)
_reg(P.GreaterThan, lambda e, a, b: a > b)
_reg(P.GreaterThanOrEqual, lambda e, a, b: a >= b)
_reg(P.EqualNullSafe,
     lambda e, a, b: (a is None and b is None)
     or (a is not None and b is not None and a == b),
     null_intolerant=False)


def _and3(expr, a, b):
    if a is False or b is False:
        return False
    if a is None or b is None:
        return None
    return True


def _or3(expr, a, b):
    if a is True or b is True:
        return True
    if a is None or b is None:
        return None
    return False


_reg(P.And, _and3, null_intolerant=False)
_reg(P.Or, _or3, null_intolerant=False)
_reg(P.Not, lambda e, a: not a)
_reg(P.IsNull, lambda e, a: a is None, null_intolerant=False)
_reg(P.IsNotNull, lambda e, a: a is not None, null_intolerant=False)

_reg(C.If, lambda e, p, t, f: t if p is True else f, null_intolerant=False)
_reg(C.Coalesce,
     lambda e, *vs: next((v for v in vs if v is not None), None),
     null_intolerant=False)
_reg(C.Nvl,
     lambda e, *vs: next((v for v in vs if v is not None), None),
     null_intolerant=False)
_reg(C.Nvl2, lambda e, a, b, c: b if a is not None else c,
     null_intolerant=False)
_reg(C.NullIf, lambda e, a, b: None
     if a is not None and b is not None and a == b else a,
     null_intolerant=False)
_reg(C.IsNaN, lambda e, a: isinstance(a, float) and math.isnan(a))
_reg(C.NaNvl, lambda e, a, b: b
     if isinstance(a, float) and math.isnan(a) else a)


# collection family: device kernels exist; the host evaluators let them
# ride the row engine beside host-only expressions ------------------------

def _reg_collections():
    from ..expr import collectionexprs as ce

    def _contains(e, a):
        # the needle is an attribute (e.value), not a child
        v = e.value
        if v is None:
            return None
        if any(x == v for x in a if x is not None):
            return True
        return None if None in a else False

    def _sort_array(e, a):
        # as the device kernel: ascending puts nulls first, descending
        # last
        nulls = [None] * sum(1 for x in a if x is None)
        vals = [x for x in a if x is not None]
        if getattr(e, "ascending", True):
            return nulls + sorted(vals)
        return sorted(vals, reverse=True) + nulls

    _reg(ce.CreateArray, lambda e, *vs: list(vs), null_intolerant=False)
    _reg(ce.Size, lambda e, a: len(a))
    _reg(ce.ArrayContains, _contains)
    _reg(ce.SortArray, _sort_array)
    _reg(ce.ArrayMin, lambda e, a: min(
        (x for x in a if x is not None), default=None))
    _reg(ce.ArrayMax, lambda e, a: max(
        (x for x in a if x is not None), default=None))


_reg_collections()


# string family --------------------------------------------------------------

_reg(S.Length, lambda e, s: len(s))
_reg(S.OctetLength, lambda e, s: len(s.encode("utf-8")))
_reg(S.BitLength, lambda e, s: 8 * len(s.encode("utf-8")))
_reg(S.Upper, lambda e, s: s.upper())
_reg(S.Lower, lambda e, s: s.lower())
_reg(S.Reverse, lambda e, s: s[::-1])
_reg(S.InitCap, lambda e, s: " ".join(
    w[:1].upper() + w[1:].lower() if w else w for w in s.split(" ")))
_reg(S.Concat, lambda e, *vs: "".join(vs))
_reg(S.ConcatWs,
     lambda e, *vs: e.sep.decode("utf-8").join(
         v for v in vs if v is not None),
     null_intolerant=False)
_reg(S.Ascii, lambda e, s: ord(s[0]) if s else 0)
_reg(S.Chr, lambda e, v: "" if v <= 0 else chr(v % 256))


def _substring(expr, *vals):
    s = vals[0]
    if s is None:
        return None
    pos = getattr(expr, "pos", 1)
    length = getattr(expr, "length", None)
    if pos > 0:
        start = pos - 1
    elif pos == 0:
        start = 0
    else:
        start = max(len(s) + pos, 0)
    end = len(s) if length is None else min(start + max(length, 0), len(s))
    return s[start:end]


# ---------------------------------------------------------------------------
# evaluation entry points
# ---------------------------------------------------------------------------

def _sql_like_to_re(pattern: str, escape: str) -> "re.Pattern":
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile("(?s)^" + "".join(out) + "$")


def _host_eval_special(expr: Expression, row) -> object:
    """Expressions whose semantics need fields beyond child values."""
    t = type(expr)
    if t is S.Substring:
        return _substring(expr, row_eval(expr.children[0], row))
    if t in (S.StartsWith, S.EndsWith, S.Contains):
        s = row_eval(expr.children[0], row)
        if s is None:
            return None
        needle = expr.needle  # stored UTF-8 encoded
        needle = needle.decode("utf-8") if isinstance(needle, bytes) \
            else needle
        if t is S.StartsWith:
            return s.startswith(needle)
        if t is S.EndsWith:
            return s.endswith(needle)
        return needle in s
    if t is S.RLike:
        s = row_eval(expr.children[0], row)
        if s is None:
            return None
        return re.search(expr.pattern, s) is not None
    if t is S.Like:
        s = row_eval(expr.children[0], row)
        if s is None:
            return None
        return _sql_like_to_re(expr.pattern,
                               expr.escape_char).match(s) is not None
    if t is C.CaseWhen:
        n = expr.n_branches
        for i in range(n):
            if row_eval(expr.children[2 * i], row) is True:
                return row_eval(expr.children[2 * i + 1], row)
        if expr.has_else:
            return row_eval(expr.children[-1], row)
        return None
    if t is P.In:
        v = row_eval(expr.children[0], row)
        if v is None:
            return None
        items = expr.items
        if any(x == v for x in items if x is not None):
            return True
        return None if any(x is None for x in items) else False
    if t is Cast:
        return _host_cast(expr, row_eval(expr.children[0], row))
    raise HostEvalUnsupported(type(expr).__name__)


def _java_double_str(v: float, repr_fn=repr) -> str:
    """Java's Double.toString (Spark's double -> string cast): plain
    decimal for 1e-3 <= |v| < 1e7, else d.dddE±n; the shortest
    round-trip mantissa; at least one fraction digit ('1.0', '1.0E-4')."""
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    neg = math.copysign(1.0, v) < 0
    a = abs(v)
    if a == 0.0:
        return "-0.0" if neg else "0.0"
    if a == 5e-324:
        return "-4.9E-324" if neg else "4.9E-324"  # Java's MIN_VALUE digits
    s = repr_fn(a)  # the shortest round-trip decimal
    mant, _, es = s.partition("e")
    exp = int(es) if es else 0
    ip, _, fp = mant.partition(".")
    digits = (ip + fp).lstrip("0")
    if ip.strip("0"):
        dec_exp = len(ip) + exp          # value = 0.<digits> * 10**dec_exp
    else:
        lead_zeros = len(fp) - len(fp.lstrip("0"))
        dec_exp = -lead_zeros + exp
    digits = digits.rstrip("0") or "0"
    if 1e-3 <= a < 1e7:
        if dec_exp <= 0:
            body = "0." + "0" * (-dec_exp) + digits
        elif dec_exp >= len(digits):
            body = digits + "0" * (dec_exp - len(digits)) + ".0"
        else:
            body = digits[:dec_exp] + "." + digits[dec_exp:]
    else:
        body = digits[0] + "." + (digits[1:] or "0") + "E" + str(dec_exp - 1)
    return ("-" if neg else "") + body


def _java_float_str(v: float) -> str:
    """Java's Float.toString: Double.toString's rules with the shortest
    decimal that round-trips at float precision ('0.1')."""
    import numpy as np
    v = float(np.float32(v))  # thresholds act on the f32 value
    if abs(v) == 1.401298464324817e-45:  # Float.MIN_VALUE digits in Java
        return "-1.4E-45" if v < 0 else "1.4E-45"
    return _java_double_str(v, repr_fn=lambda a: str(np.float32(a)))


def _timestamp_str(micros: int) -> str:
    """Spark's timestamp -> string: 'yyyy-MM-dd HH:mm:ss' and the
    fractional seconds with trailing zeros trimmed (no trailing dot)."""
    import datetime as _dt
    d = _dt.datetime(1970, 1, 1) + _dt.timedelta(microseconds=int(micros))
    base = d.strftime("%Y-%m-%d %H:%M:%S")
    if d.microsecond:
        base += (".%06d" % d.microsecond).rstrip("0")
    return base


def _host_cast(expr: Cast, v):
    if v is None:
        return None
    to = expr.data_type
    if isinstance(to, StringType):
        if isinstance(v, bool):
            return "true" if v else "false"
        try:
            src = expr.children[0].data_type
        except (TypeError, NotImplementedError):
            src = None
        if isinstance(v, float):
            if isinstance(src, FloatType):
                return _java_float_str(v)
            return _java_double_str(v)
        if isinstance(src, TimestampType):
            return _timestamp_str(v)
        return str(v)
    if isinstance(to, _INT_TYPES):
        bits = {ByteType: 8, ShortType: 16, IntegerType: 32,
                LongType: 64}[type(to)]
        if isinstance(v, str):
            try:
                v = int(v.strip())
            except ValueError:
                return None
        elif isinstance(v, float):
            if math.isnan(v) or math.isinf(v):
                return None
            v = int(v)
        elif isinstance(v, bool):
            v = int(v)
        v &= (1 << bits) - 1
        return v - (1 << bits) if v >= (1 << (bits - 1)) else v
    if isinstance(to, (DoubleType, FloatType)):
        if isinstance(v, str):
            try:
                return float(v.strip())
            except ValueError:
                return None
        return float(v)
    if isinstance(to, BooleanType):
        if isinstance(v, str):
            lv = v.strip().lower()
            if lv in ("t", "true", "y", "yes", "1"):
                return True
            if lv in ("f", "false", "n", "no", "0"):
                return False
            return None
        return bool(v)
    raise HostEvalUnsupported(f"host cast to {to.simple_name()}")


_SPECIAL = (S.Substring, S.StartsWith, S.EndsWith, S.Contains, S.RLike,
            S.Like, C.CaseWhen, P.In, Cast)


def row_eval(expr: Expression, row) -> object:
    """Evaluate one expression against a host row (a tuple of values,
    indexed by BoundReference ordinal)."""
    if isinstance(expr, Literal):
        return expr.value
    if isinstance(expr, BoundReference):
        return row[expr.ordinal]
    if isinstance(expr, Alias):
        return row_eval(expr.children[0], row)
    if isinstance(expr, _SPECIAL):
        return _host_eval_special(expr, row)
    # the host-tier classes carry their own scalar semantics; the
    # `_with_row` form drives sub-evaluation itself (a lambda binds its
    # variable per element)
    rich_fn = getattr(expr, "host_eval_with_row", None)
    if rich_fn is not None:
        return rich_fn(row, row_eval)
    host_fn = getattr(expr, "host_eval_row", None)
    if host_fn is not None:
        return host_fn(*[row_eval(c, row) for c in expr.children])
    fn = _EVALS.get(type(expr))
    if fn is None:
        raise HostEvalUnsupported(type(expr).__name__)
    vals = [row_eval(c, row) for c in expr.children]
    return fn(expr, *vals)


_HOST_CASTABLE = (StringType, ByteType, ShortType, IntegerType, LongType,
                  DoubleType, FloatType, BooleanType)


def _decimal_typed(expr: Expression) -> bool:
    """A decimal tree never falls back: host rows carry the unscaled
    ints, and Python arithmetic would ignore Spark's rescale rules."""
    try:
        if isinstance(expr.data_type, DecimalType):
            return True
    except (TypeError, NotImplementedError):
        pass
    return any(_decimal_typed(c) for c in expr.children
               if isinstance(c, Expression))


def _compiles(pattern) -> bool:
    if not isinstance(pattern, str):
        return False
    try:
        re.compile(pattern)
    except re.error:
        return False
    return True


def supports_host_eval(expr: Expression) -> bool:
    """Plan-time check: can the row engine evaluate this tree? Exact for
    the special forms (the pattern compiles under Python's re, the cast
    target is implemented): an over-approximation would fail mid-query
    instead of tagging off at plan time."""
    if isinstance(expr, (Literal, BoundReference, UnresolvedAttribute)):
        return True
    if isinstance(expr, Alias):
        return supports_host_eval(expr.children[0])
    if _decimal_typed(expr):
        return False
    if isinstance(expr, (S.RLike, S.Like)):
        if not isinstance(expr.pattern, str):
            return False
        if isinstance(expr, S.RLike) and not _compiles(expr.pattern):
            return False
        return supports_host_eval(expr.children[0])
    if isinstance(expr, Cast):
        if not isinstance(expr.data_type, _HOST_CASTABLE):
            return False
        return supports_host_eval(expr.children[0])
    if isinstance(expr, (S.StringSplit, S.RegExpExtract, S.RegExpReplace)):
        if not _compiles(expr.pattern):
            return False
        return all(supports_host_eval(c) for c in expr.children)
    from ..expr.collectionexprs import ArrayAggregate, LambdaVar, _HostHOF
    if isinstance(expr, LambdaVar):
        return True  # bound per element by the enclosing lambda
    if isinstance(expr, _HostHOF):
        return supports_host_eval(expr.children[0]) \
            and supports_host_eval(expr.body)
    if isinstance(expr, ArrayAggregate):
        return all(supports_host_eval(c) for c in expr.children) \
            and supports_host_eval(expr.merge) \
            and (expr.finish is None or supports_host_eval(expr.finish))
    if isinstance(expr, _SPECIAL) or type(expr) in _EVALS \
            or getattr(expr, "host_eval_row", None) is not None:
        return all(supports_host_eval(c) for c in expr.children)
    return False


# ---------------------------------------------------------------------------
# transitions and host operators
# ---------------------------------------------------------------------------

class ColumnarToRowExec(TpuExec):
    """Device batches -> host rows (reference GpuColumnarToRowExec): each
    batch crosses in one packed copy (ColumnarBatch.to_pylist)."""

    def __init__(self, child: TpuExec):
        super().__init__(child)

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    def rows(self) -> Iterator[tuple]:
        for b in self.child.execute():
            yield from b.to_pylist()

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        yield from self.child.execute()


class RowToColumnarExec(TpuExec):
    """Host rows -> device batches (reference GpuRowToColumnarExec),
    `batch_rows` rows a batch, each built on the host and uploaded in one
    packed copy to the plan's device."""

    def __init__(self, child: TpuExec, schema: Schema,
                 batch_rows: int = 1 << 16):
        super().__init__(child)
        self._schema = schema
        self._batch_rows = batch_rows

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        names = self._schema.names
        buf: List[tuple] = []
        for row in self.child.rows():
            buf.append(row)
            if len(buf) >= self._batch_rows:
                yield self._flush(names, buf)
                buf = []
        if buf:
            yield self._flush(names, buf)

    def _flush(self, names, buf) -> ColumnarBatch:
        from ..columnar.upload import promote_batch
        data = {n: [r[i] for r in buf] for i, n in enumerate(names)}
        host = ColumnarBatch.from_pydict(data, self._schema, device="cpu")
        return promote_batch(host, self.device)


class _HostRowExec(TpuExec):
    """Base of the row engine's operators: children expose rows()."""

    def rows(self) -> Iterator[tuple]:
        raise NotImplementedError

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        raise AssertionError(
            f"{type(self).__name__} is row-based; wrap in RowToColumnarExec")


class HostProjectExec(_HostRowExec):
    """Row-engine projection over host-evaluable expressions."""

    def __init__(self, exprs: Sequence[Expression], child: TpuExec):
        super().__init__(child)
        in_schema = child.output_schema
        self._bound = [resolve(e, in_schema) for e in exprs]
        self._schema = Schema(tuple(
            StructField(output_name(raw, f"col{i}"), b.data_type)
            for i, (raw, b) in enumerate(zip(exprs, self._bound))))

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def rows(self) -> Iterator[tuple]:
        for row in self.child.rows():
            yield tuple(row_eval(e, row) for e in self._bound)


class HostFilterExec(_HostRowExec):
    def __init__(self, condition: Expression, child: TpuExec):
        super().__init__(child)
        self._bound = resolve(condition, child.output_schema)

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    def rows(self) -> Iterator[tuple]:
        for row in self.child.rows():
            if row_eval(self._bound, row) is True:
                yield row
