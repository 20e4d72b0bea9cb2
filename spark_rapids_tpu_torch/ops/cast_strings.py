"""String <-> value casts with Spark semantics — the counterpart of
spark_rapids_tpu/ops/cast_strings.py (the reference's CastStrings
kernels).

  * numbers, booleans, dates and DECIMAL(p<=18) render to strings as the
    JAX package renders them: each row's characters are laid out in a
    fixed-width (rows, width) byte matrix, then the used bytes of every
    row are taken in row order (one masked select) behind offsets from
    the lengths;
  * strings parse to integers, floats, booleans and dates with Spark's
    whitespace trim (every byte <= 0x20 at either end), sign and null
    rules (non-ANSI: malformed or out of range -> NULL, never an error).

Parsing walks the bytes of every row at once, one position per step, for
as many steps as the longest trimmed row has bytes (one host read, as
the JAX package's `while_loop` bounds itself by a device reduction).

String to double keeps the JAX package's own digit algorithm, not
Python's `float()`: the digits accumulate in a double (`mant * 10 + d`,
which XLA contracts into one fused multiply-add; `_mul10_add` rounds
once too), then `mant * 10^exp`. The power of ten comes from a table of correctly
rounded doubles; the JAX package takes it from XLA's `pow`, which agrees
but for 10^23 and 10^210 (one ulp) and flushes 10^-308 and below to zero
(tests/test_torch_cast.py holds the bound).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..columnar.column import Column, StringColumn
from ..types import (BOOLEAN, STRING, BooleanType, ByteType, DataType,
                     DateType, DecimalType, DoubleType, FloatType,
                     IntegerType, IntegralType, LongType, ShortType)
from .strings import _rebuild_offsets

_INT_BOUNDS = {
    ByteType: (-128, 127),
    ShortType: (-32768, 32767),
    IntegerType: (-(2**31), 2**31 - 1),
    LongType: (-(2**63), 2**63 - 1),
}
_I64_MIN = -(1 << 63)


# -- rendering -----------------------------------------------------------------

def _from_char_matrix(chars: torch.Tensor, lengths: torch.Tensor,
                      validity: torch.Tensor) -> StringColumn:
    """A (rows, width) uint8 matrix whose row i holds its string in its
    first lengths[i] bytes -> StringColumn (null rows empty)."""
    lengths = torch.where(validity, lengths.to(torch.int32), 0)
    width = chars.shape[1]
    pos = torch.arange(width, dtype=torch.int32, device=chars.device)
    used = pos[None, :] < lengths[:, None]
    data = torch.masked_select(chars, used)
    if data.shape[0] == 0:
        data = torch.zeros(1, dtype=torch.uint8, device=chars.device)
    return StringColumn(data, _rebuild_offsets(lengths), validity, STRING)


def _digits_lsb(vals: torch.Tensor, n: int) -> torch.Tensor:
    """(rows, n) int64 decimal digits of |vals|, least significant first,
    exact at INT64_MIN (the digits come off the signed value)."""
    out = []
    q = vals
    for _ in range(n):
        out.append(torch.abs(torch.fmod(q, 10)))
        q = torch.div(q, 10, rounding_mode="trunc")
    return torch.stack(out, dim=1)


def _ndigits(d: torch.Tensor) -> torch.Tensor:
    """Significant digits of an LSB-first digit matrix (at least 1)."""
    k = torch.arange(1, d.shape[1] + 1, device=d.device)
    return torch.clamp(torch.max(torch.where(d != 0, k, 0), dim=1).values,
                       min=1)


def _place_digits(d: torch.Tensor, nd: torch.Tensor, start: torch.Tensor,
                  chars: torch.Tensor) -> None:
    """Write each row's nd most significant digits of the LSB-first `d`
    into `chars` from column `start` on (in place)."""
    width = chars.shape[1]
    pos = torch.arange(width, device=d.device)[None, :]
    t = pos - start[:, None]
    src = torch.clamp(nd[:, None] - 1 - t, 0, d.shape[1] - 1)
    dig = torch.gather(d, 1, src) + ord("0")
    inside = (t >= 0) & (t < nd[:, None])
    chars.copy_(torch.where(inside, dig.to(torch.uint8), chars))


def int_to_string(col: Column) -> StringColumn:
    vals = col.data.to(torch.int64)
    neg = vals < 0
    d = _digits_lsb(vals, 19)
    nd = _ndigits(d)
    chars = torch.zeros((vals.shape[0], 20), dtype=torch.uint8,
                        device=vals.device)
    chars[:, 0] = torch.where(neg, ord("-"), 0).to(torch.uint8)
    _place_digits(d, nd, neg.to(torch.int64), chars)
    return _from_char_matrix(chars, nd + neg.to(torch.int64), col.validity)


def bool_to_string(col: Column) -> StringColumn:
    t = torch.tensor(list(b"true\x00"), dtype=torch.uint8,
                     device=col.device)
    f = torch.tensor(list(b"false"), dtype=torch.uint8, device=col.device)
    chars = torch.where(col.data[:, None], t[None, :], f[None, :])
    return _from_char_matrix(chars, torch.where(col.data, 4, 5),
                             col.validity)


def date_to_string(col: Column) -> StringColumn:
    """DATE -> 'YYYY-MM-DD' (the year's last four digits, as the JAX
    package renders it)."""
    from .datetime_ops import civil_from_days
    y, m, d = (v.to(torch.int64) for v in civil_from_days(col.data))

    def dig(v, k):
        return torch.remainder(torch.div(v, k, rounding_mode="floor"), 10)

    dash = torch.full_like(y, ord("-") - ord("0"))
    cols = [dig(y, 1000), dig(y, 100), dig(y, 10), dig(y, 1), dash,
            dig(m, 10), dig(m, 1), dash, dig(d, 10), dig(d, 1)]
    chars = (torch.stack(cols, dim=1) + ord("0")).to(torch.uint8)
    return _from_char_matrix(chars, torch.full_like(y, 10), col.validity)


def decimal_to_string(col: Column) -> StringColumn:
    """DECIMAL(p<=18) -> string with exactly `scale` fraction digits
    (Spark's plain rendering: "-0.05", "12.30")."""
    dt = col.dtype
    if dt.scale == 0:
        return int_to_string(Column(col.data, col.validity, LongType()))
    if dt.is_decimal128:
        raise NotImplementedError(
            "cast of decimal128 to string is tagged off at plan time, as "
            "in the JAX package")
    m = 10 ** dt.scale
    vals = col.data
    neg = vals < 0
    mag = torch.abs(vals)
    int_part = torch.div(mag, m, rounding_mode="floor")
    frac = torch.remainder(mag, m)
    di = _digits_lsb(int_part, 19)
    ni = _ndigits(di)
    df = _digits_lsb(frac, dt.scale)
    nneg = neg.to(torch.int64)
    width = 1 + 19 + 1 + dt.scale
    chars = torch.zeros((vals.shape[0], width), dtype=torch.uint8,
                        device=vals.device)
    chars[:, 0] = torch.where(neg, ord("-"), 0).to(torch.uint8)
    _place_digits(di, ni, nneg, chars)
    dot = nneg + ni
    pos = torch.arange(width, device=vals.device)[None, :]
    chars.copy_(torch.where(pos == dot[:, None], ord("."), chars)
                .to(torch.uint8))
    _place_digits(df, torch.full_like(ni, dt.scale), dot + 1, chars)
    return _from_char_matrix(chars, dot + 1 + dt.scale, col.validity)


def cast_to_string(col: Column) -> StringColumn:
    dt = col.dtype
    if isinstance(dt, BooleanType):
        return bool_to_string(col)
    if isinstance(dt, IntegralType):
        return int_to_string(col)
    if isinstance(dt, DateType):
        return date_to_string(col)
    if isinstance(dt, DecimalType):
        return decimal_to_string(col)
    raise TypeError(f"cast {dt} -> string not yet on device")


# -- parsing ---------------------------------------------------------------------

def _trimmed_span(col: StringColumn) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, end) of each row with the bytes <= 0x20 trimmed off both
    ends, as Spark trims before parsing."""
    s = col.offsets[:-1].to(torch.int64)
    e = col.offsets[1:].to(torch.int64)
    cap = col.byte_capacity
    data = col.data
    longest = int(torch.max(e - s)) if s.shape[0] else 0
    for _ in range(longest):
        b = data[torch.clamp(s, 0, cap - 1)]
        s = torch.where((s < e) & (b <= 0x20), s + 1, s)
    for _ in range(longest):
        b = data[torch.clamp(e - 1, 0, cap - 1)]
        e = torch.where((s < e) & (b <= 0x20), e - 1, e)
    return s, e


def _byte_matrix(col: StringColumn, start: torch.Tensor, end: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, L) int64 bytes from `start` on, with (rows, L) activity
    (position < end); L is the longest span (one host read)."""
    width = max(int(torch.max(end - start)) if start.shape[0] else 0, 0)
    t = torch.arange(width, dtype=torch.int64, device=start.device)
    p = start[:, None] + t[None, :]
    b = col.data[torch.clamp(p, 0, col.byte_capacity - 1)].to(torch.int64)
    return b, p < end[:, None]


def string_to_integral(col: StringColumn, dst) -> Column:
    """Spark string -> int: an optional sign and digits only; overflow or
    anything else -> NULL. The magnitude accumulates negated, so that
    Long.MIN_VALUE's 2^63 is exact."""
    s, e = _trimmed_span(col)
    first = col.data[torch.clamp(s, 0, col.byte_capacity - 1)]
    neg = (first == ord("-")) & (s < e)
    has_sign = (neg | (first == ord("+"))) & (s < e)
    ds = s + has_sign.to(torch.int64)
    b, act = _byte_matrix(col, ds, e)
    cap = s.shape[0]
    acc = torch.zeros(cap, dtype=torch.int64, device=s.device)
    ok = torch.ones(cap, dtype=torch.bool, device=s.device)
    ovf = torch.zeros_like(ok)
    for t in range(b.shape[1]):
        bt, at = b[:, t], act[:, t]
        is_digit = (bt >= ord("0")) & (bt <= ord("9"))
        d = bt - ord("0")
        step = at & is_digit
        # acc * 10 - d >= MIN  <=>  acc >= ceil((MIN + d) / 10)
        ovf = ovf | (step & (acc < torch.div(_I64_MIN + d, 10,
                                             rounding_mode="trunc")))
        acc = torch.where(step & ~ovf, acc * 10 - d, acc)
        ok = ok & (~at | is_digit)
    ok = ok & ((e - ds) > 0) & ~ovf & (neg | (acc != _I64_MIN))
    val = torch.where(neg, acc, -acc)
    lo, hi = _INT_BOUNDS[type(dst)]
    valid = col.validity & ok & (val >= lo) & (val <= hi)
    out = torch.where(valid, val, 0).to(dst.torch_dtype)
    return Column(out, valid, dst)


_POW10_LO, _POW10_HI = -400, 400
_POW10 = {}


def _pow10_table(device) -> torch.Tensor:
    """Correctly rounded 10^k for k in [-400, 400] (inf past 10^308)."""
    got = _POW10.get(device)
    if got is None:
        from fractions import Fraction
        vals = []
        for k in range(_POW10_LO, _POW10_HI + 1):
            try:
                vals.append(float(Fraction(10) ** k))
            except OverflowError:
                vals.append(float("inf"))
        got = torch.tensor(vals, dtype=torch.float64, device=device)
        _POW10[device] = got
    return got


def pow10(exp: torch.Tensor) -> torch.Tensor:
    """10.0 ** exp for int lanes: the table, 0 below it, inf above."""
    table = _pow10_table(exp.device)
    k = torch.clamp(exp.to(torch.int64), _POW10_LO, _POW10_HI) - _POW10_LO
    v = table[k]
    v = torch.where(exp < _POW10_LO, 0.0, v)
    return torch.where(exp > _POW10_HI, float("inf"), v)


def _mul10_add(m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """m * 10 + d with one rounding, as the fused multiply-add XLA makes
    of the JAX package's `mant * 10 + d`: 10m = 8m + 2m exactly as a sum
    and its error (TwoSum), then d added the same way."""
    a, b = m * 8.0, m * 2.0
    s = a + b
    bb = s - a
    t = (a - (s - bb)) + (b - bb)          # s + t == 10m exactly
    s2 = s + d
    bb2 = s2 - s
    t2 = (s - (s2 - bb2)) + (d - bb2)      # s2 + t2 == s + d exactly
    return s2 + (t2 + t)


def string_to_fractional(col: StringColumn, dst) -> Column:
    """string -> float/double: sign, digits, optional '.', optional
    exponent, and NaN / Inf / Infinity (any case) as Spark reads them;
    anything else -> NULL."""
    s, e = _trimmed_span(col)
    cap = s.shape[0]
    dev = s.device
    first = col.data[torch.clamp(s, 0, col.byte_capacity - 1)]
    neg = first == ord("-")
    p0 = s + (neg | (first == ord("+"))).to(torch.int64)
    b, act = _byte_matrix(col, p0, e)
    length = e - p0

    def match_lit(lit: bytes):
        ok = length == len(lit)
        for j, ch in enumerate(lit):
            bj = b[:, j] if j < b.shape[1] else torch.zeros_like(s)
            if chr(ch).isalpha():
                ok = ok & ((bj == ch) | (bj == (ch ^ 0x20)))
            else:
                ok = ok & (bj == ch)
        return ok

    is_nan = match_lit(b"NaN")
    is_inf = match_lit(b"Infinity") | match_lit(b"Inf")

    zb = torch.zeros(cap, dtype=torch.bool, device=dev)
    zi = torch.zeros(cap, dtype=torch.int32, device=dev)
    mant = torch.zeros(cap, dtype=torch.float64, device=dev)
    frac_digits, exp_val = zi, zi
    seen_dot = seen_digit = exp_neg = in_exp = seen_exp_digit = zb
    ok = torch.ones(cap, dtype=torch.bool, device=dev)
    for t in range(b.shape[1]):
        bt, active = b[:, t], act[:, t]
        is_digit = (bt >= ord("0")) & (bt <= ord("9"))
        is_dot = bt == ord(".")
        is_e = (bt == ord("e")) | (bt == ord("E"))
        is_sign = (bt == ord("+")) | (bt == ord("-"))
        is_exp_sign = is_sign & in_exp & ~seen_exp_digit
        mant_step = is_digit & ~in_exp & active
        mant = torch.where(mant_step,
                           _mul10_add(mant, (bt - ord("0")).to(torch.float64)),
                           mant)
        frac_digits = torch.where(mant_step & seen_dot, frac_digits + 1,
                                  frac_digits)
        exp_val = torch.where(is_digit & in_exp & active,
                              exp_val * 10 + (bt - ord("0")).to(torch.int32),
                              exp_val)
        bad = ~(is_digit | (is_dot & ~seen_dot & ~in_exp)
                | (is_e & ~in_exp & seen_digit) | is_exp_sign)
        ok = ok & (~active | ~bad)
        seen_dot = seen_dot | (is_dot & active)
        seen_digit = seen_digit | (is_digit & active & ~in_exp)
        exp_neg = exp_neg | (is_exp_sign & (bt == ord("-")) & active)
        seen_exp_digit = seen_exp_digit | (is_digit & in_exp & active)
        in_exp = in_exp | (is_e & active)
    ok = ok & seen_digit & (~in_exp | seen_exp_digit)
    exp = torch.where(exp_neg, -exp_val, exp_val) - frac_digits
    val = mant * pow10(exp)
    val = torch.where(neg, -val, val)
    val = torch.where(is_nan, float("nan"), val)
    val = torch.where(is_inf, torch.where(neg, float("-inf"), float("inf")),
                      val)
    valid = col.validity & (ok | is_nan | is_inf)
    out = torch.where(valid, val, 0.0).to(dst.torch_dtype)
    return Column(out, valid, dst)


def string_to_boolean(col: StringColumn) -> Column:
    """Spark reads t/true/y/yes/1 and f/false/n/no/0, in any case."""
    s, e = _trimmed_span(col)
    b, _ = _byte_matrix(col, s, e)
    low = torch.where((b >= ord("A")) & (b <= ord("Z")), b + 32, b)
    length = e - s

    def eq_lit(lit: bytes):
        ok = length == len(lit)
        for j, ch in enumerate(lit):
            ok = ok & ((low[:, j] == ch) if j < low.shape[1]
                       else torch.zeros_like(ok))
        return ok

    truthy = eq_lit(b"t") | eq_lit(b"true") | eq_lit(b"y") \
        | eq_lit(b"yes") | eq_lit(b"1")
    falsy = eq_lit(b"f") | eq_lit(b"false") | eq_lit(b"n") \
        | eq_lit(b"no") | eq_lit(b"0")
    valid = col.validity & (truthy | falsy)
    return Column(truthy & valid, valid, BOOLEAN)


def cast_string_to(col: StringColumn, dst: DataType) -> Column:
    if isinstance(dst, BooleanType):
        return string_to_boolean(col)
    if isinstance(dst, IntegralType):
        return string_to_integral(col, dst)
    if isinstance(dst, (FloatType, DoubleType)):
        return string_to_fractional(col, dst)
    if isinstance(dst, DateType):
        from .datetime_ops import string_to_date
        return string_to_date(col)
    raise TypeError(f"cast string -> {dst} not yet on device")


# -- format_number ---------------------------------------------------------------

def format_number_string(col: Column, decimals: int) -> StringColumn:
    """format_number(x, d): HALF_EVEN rounding to d places and thousands
    separators (Java DecimalFormat '#,##0.00'). The scaled value rides an
    int64, so |x| * 10^d past 2^63 saturates, as in the JAX package."""
    if not 0 <= decimals <= 18:
        raise ValueError("format_number takes 0 to 18 decimals")
    x = col.data.to(torch.float64)
    neg = x < 0
    p = 10 ** decimals
    scaled = torch.clamp(torch.round(torch.abs(x) * float(p)), 0.0, 9.2e18)
    scaled = scaled.to(torch.int64)
    if not col.data.dtype.is_floating_point and col.data.dtype != torch.bool:
        # exact for integral inputs: no float round trip of the int part
        v = col.data.to(torch.int64)
        mag = torch.where(neg, -v, v)
        limit = (2 ** 63 - 1) // p
        scaled = torch.where(mag > limit, 2 ** 63 - 1, mag * p)
    int_part = torch.div(scaled, p, rounding_mode="floor")
    frac = torch.remainder(scaled, p)
    d = _digits_lsb(int_part, 19)
    nd = _ndigits(d)
    n_commas = torch.div(nd - 1, 3, rounding_mode="floor")
    int_chars = nd + n_commas
    nneg = neg.to(torch.int64)
    width = 1 + 27 + 1 + decimals
    rows = x.shape[0]
    pos = torch.arange(width, device=x.device)[None, :]
    j = pos - nneg[:, None]                    # 0-based in the int section
    m = int_chars[:, None]
    in_int = (j >= 0) & (j < m)
    r0 = m - 1 - j                             # 0-based from the right
    is_comma = in_int & (torch.remainder(r0 + 1, 4) == 0)
    from_right = r0 - torch.div(r0 + 1, 4, rounding_mode="floor")
    dig = torch.gather(d, 1, torch.clamp(from_right, 0, 18))
    fpos = j - m                               # 0 is the '.', 1.. digits
    chars = torch.zeros((rows, width), dtype=torch.int64, device=x.device)
    chars = torch.where(in_int, dig + ord("0"), chars)
    chars = torch.where(is_comma, ord(","), chars)
    chars = torch.where((pos == 0) & neg[:, None], ord("-"), chars)
    if decimals:
        fd = _digits_lsb(frac, decimals)
        k = torch.clamp(decimals - fpos, 0, decimals - 1)
        fch = torch.gather(fd, 1, k) + ord("0")
        chars = torch.where((fpos >= 1) & (fpos <= decimals), fch, chars)
        chars = torch.where(fpos == 0, ord("."), chars)
    lengths = nneg + int_chars + ((1 + decimals) if decimals else 0)
    return _from_char_matrix(chars.to(torch.uint8), lengths, col.validity)
