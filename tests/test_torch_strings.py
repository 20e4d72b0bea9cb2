"""The port's string expressions (expr/stringexprs.py over ops/strings.py),
its hash expressions (expr/hashexprs.py) and its comparisons of decoded
strings (expr/predicates.py) against the JAX package's, on the CPU.

Every device expression runs once through both packages on the same
seeded rows (ASCII, UTF-8 of two to four bytes, empty, blank, nulls,
self-overlapping runs); their outputs are equal byte for byte (a byte
-semantics op may cut a UTF-8 character, so rows compare as bytes) and
booleans, ints and hashes exactly. Further cases are held to Python
oracles of the JAX package's semantics: byte positions and lengths for
substring, pad, locate and reverse, characters for length, ASCII letters
only for upper, lower and initcap. The loops that take a bound from the
host count their reads.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import hashexprs as jhash
from spark_rapids_tpu.expr import predicates as jpred
from spark_rapids_tpu.expr import stringexprs as jse

from spark_rapids_tpu_torch.columnar.column import Column, StringColumn
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import hashexprs as thash
from spark_rapids_tpu_torch.expr import predicates as tpred
from spark_rapids_tpu_torch.expr import stringexprs as tse
from spark_rapids_tpu_torch.ops import strings as S
from spark_rapids_tpu_torch.types import INT

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases

JAX = SimpleNamespace(core=jcore, se=jse, pred=jpred, hash=jhash)
TORCH = SimpleNamespace(core=tcore, se=tse, pred=tpred, hash=thash)

WORDS = ["hello", "  wörld ", "", "aaaa", "日本語", "x y\tz", "PROMO BRUSHED",
         "aXbXXc", "0x1F", "ÿ€𝄞", " ", "hello world", "héllo wörld",
         "Mixed CASE text", "a,b,,c", "\n trim \r", "abcabcab", "🙂ok"]


def _rows(n=96, seed=0):
    rng = np.random.default_rng(seed)
    s = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
    u = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
    return {"s": (s, "STRING", rng.random(n) > 0.15),
            "u": (u, "STRING", rng.random(n) > 0.15),
            "i": (rng.integers(-300, 300, n).astype(np.int32), "INT",
                  rng.random(n) > 0.1),
            "l": (rng.integers(-2**62, 2**62, n), "LONG",
                  rng.random(n) > 0.1)}


@pytest.fixture(scope="module")
def batches():
    with jax_aliases():
        yield both_batch(_rows(), 96)


def raw(c, n):
    """Rows as bytes (strings) or Python values, None for null."""
    d, v = np.asarray(c.data), np.asarray(c.validity)
    if not hasattr(c, "offsets"):
        return [x if ok else None for x, ok in zip(d[:n].tolist(), v[:n])]
    o = np.asarray(c.offsets)
    return [bytes(d[o[i]:o[i + 1]]) if v[i] else None for i in range(n)]


#: every device expression of the string and hash modules, and the
#: comparisons of decoded strings, as (module namespace) -> expression
EXPRS = {
    "Length": lambda m, c: m.se.Length(c("s")),
    "Upper": lambda m, c: m.se.Upper(c("s")),
    "Lower": lambda m, c: m.se.Lower(c("s")),
    "Substring": lambda m, c: m.se.Substring(c("s"), -4, 3),
    "StartsWith": lambda m, c: m.se.StartsWith(c("s"), "he"),
    "EndsWith": lambda m, c: m.se.EndsWith(c("s"), "d "),
    "Contains": lambda m, c: m.se.Contains(c("s"), "ll"),
    "StringTrim": lambda m, c: m.se.StringTrim(c("s")),
    "StringTrimLeft": lambda m, c: m.se.StringTrimLeft(c("s"), " \n"),
    "StringTrimRight": lambda m, c: m.se.StringTrimRight(c("s"), "d "),
    "StringLPad": lambda m, c: m.se.StringLPad(c("s"), 7, "xy"),
    "StringRPad": lambda m, c: m.se.StringRPad(c("s"), 5, "-"),
    "StringRepeat": lambda m, c: m.se.StringRepeat(c("s"), 3),
    "Reverse": lambda m, c: m.se.Reverse(c("s")),
    "InitCap": lambda m, c: m.se.InitCap(c("s")),
    "StringLocate": lambda m, c: m.se.StringLocate("l", c("s"), 4),
    "StringReplace": lambda m, c: m.se.StringReplace(c("s"), "aa", "b"),
    "Concat": lambda m, c: m.se.Concat(c("s"), c("u")),
    "Concat3": lambda m, c: m.se.Concat(c("s"), c("u"), c("s")),
    "ConcatWs": lambda m, c: m.se.ConcatWs(", ", c("s"), c("u"), c("s")),
    "StringTranslate": lambda m, c: m.se.StringTranslate(c("s"), "lo ",
                                                         "01"),
    "Ascii": lambda m, c: m.se.Ascii(c("s")),
    "Chr": lambda m, c: m.se.Chr(c("i")),
    "OctetLength": lambda m, c: m.se.OctetLength(c("s")),
    "BitLength": lambda m, c: m.se.BitLength(c("s")),
    "Left": lambda m, c: m.se.Left(c("s"), 3),
    "Right": lambda m, c: m.se.Right(c("s"), 3),
    "Murmur3Hash": lambda m, c: m.hash.Murmur3Hash(c("s"), c("l"), c("i")),
    "XxHash64": lambda m, c: m.hash.XxHash64(c("l"), c("s")),
    "LessThan": lambda m, c: m.pred.LessThan(c("s"), c("u")),
    "GreaterThanOrEqual": lambda m, c: m.pred.GreaterThanOrEqual(
        c("s"), m.core.lit("hello")),
    "EqualTo": lambda m, c: m.pred.EqualTo(c("s"), c("u")),
    "In": lambda m, c: m.pred.In(c("s"), ["aaaa", "日本語", None]),
}


@pytest.mark.parametrize("name", list(EXPRS))
def test_device_expression_matches_jax(batches, name):
    jb, tb = batches
    with jax_aliases():
        want = raw(jcore.resolve(EXPRS[name](JAX, jcore.col), jb.schema)
                   .columnar_eval(jb), 96)
    got = raw(tcore.resolve(EXPRS[name](TORCH, tcore.col), tb.schema)
              .columnar_eval(tb), 96)
    assert got == want


def _col(values):
    return StringColumn.from_pylist(values, device="cpu")


def _bytes(c, n):
    return raw(c, n)


VALUES = [w for w in WORDS] + [None, "aaaaa", "ababab"]
B = [None if v is None else v.encode() for v in VALUES]


def _py_substring(b, pos, length):
    n = len(b)
    begin = min(pos - 1, n) if pos > 0 else 0 if pos == 0 else max(n + pos, 0)
    end = n if length is None else begin + max(min(length, n - begin), 0)
    return b[begin:end]


def _py_pad(b, target, pad, left):
    target = max(target, 0)
    if not pad or len(b) >= target:
        return b[:target]
    fill = (pad * target)[:target - len(b)]
    return fill + b if left else b + fill


def _py_ascii_case(b, up):
    lo, hi, d = (97, 122, -32) if up else (65, 90, 32)
    return bytes(x + d if lo <= x <= hi else x for x in b)


def _py_initcap(b):
    out, prev = bytearray(), None
    for x in b:
        start = prev is None or prev in b" \t\n\r"
        out.append(x - 32 if start and 97 <= x <= 122 else
                   x + 32 if not start and 65 <= x <= 90 else x)
        prev = x
    return bytes(out)


def _py_locate(b, needle, start):
    if not needle:
        return min(max(start - 1, 0), len(b)) + 1
    return b.find(needle, max(start - 1, 0)) + 1


ORACLES = {
    "substring 2,3": (lambda c: S.substring(c, 2, 3),
                      lambda b: _py_substring(b, 2, 3)),
    "substring -2": (lambda c: S.substring(c, -2, None),
                     lambda b: _py_substring(b, -2, None)),
    "substring 0,2": (lambda c: S.substring(c, 0, 2),
                      lambda b: _py_substring(b, 0, 2)),
    "substring 9,-1": (lambda c: S.substring(c, 9, -1),
                       lambda b: _py_substring(b, 9, -1)),
    "lpad 10 ab": (lambda c: S.str_pad(c, 10, b"ab", "left"),
                   lambda b: _py_pad(b, 10, b"ab", True)),
    "rpad 3 empty": (lambda c: S.str_pad(c, 3, b"", "right"),
                     lambda b: _py_pad(b, 3, b"", False)),
    "rpad 0": (lambda c: S.str_pad(c, 0, b"z", "right"),
               lambda b: _py_pad(b, 0, b"z", False)),
    "upper": (S.str_upper_ascii, lambda b: _py_ascii_case(b, True)),
    "lower": (S.str_lower_ascii, lambda b: _py_ascii_case(b, False)),
    "initcap": (S.str_initcap, _py_initcap),
    "reverse": (S.str_reverse, lambda b: b[::-1]),
    "repeat 0": (lambda c: S.str_repeat(c, 0), lambda b: b""),
    "repeat 2": (lambda c: S.str_repeat(c, 2), lambda b: b * 2),
    "trim": (lambda c: S.str_trim(c, "both", b" \t\n\r"),
             lambda b: b.strip(b" \t\n\r")),
    "ltrim a": (lambda c: S.str_trim(c, "left", b"a"),
                lambda b: b.lstrip(b"a")),
    "replace aa": (lambda c: S.str_replace(c, b"aa", b"<>"),
                   lambda b: b.replace(b"aa", b"<>")),
    "replace ab": (lambda c: S.str_replace(c, b"ab", b""),
                   lambda b: b.replace(b"ab", b"")),
    "replace l": (lambda c: S.str_replace(c, b"l", b"LLL"),
                  lambda b: b.replace(b"l", b"LLL")),
    "translate": (lambda c: S.str_translate(c, b"abca", b"xy"),
                  lambda b: b.translate(bytes.maketrans(b"ab", b"xy"),
                                        b"c")),
    "length chars": (lambda c: S.str_length_chars(c),
                     lambda b: len(b.decode())),
    "locate o 1": (lambda c: S.str_locate(c, b"o", 1),
                   lambda b: _py_locate(b, b"o", 1)),
    "locate ab 3": (lambda c: S.str_locate(c, b"ab", 3),
                    lambda b: _py_locate(b, b"ab", 3)),
    "locate empty 3": (lambda c: S.str_locate(c, b"", 3),
                       lambda b: _py_locate(b, b"", 3)),
    "contains aa": (lambda c: S.str_contains(c, b"aa"),
                    lambda b: b"aa" in b),
    "starts ab": (lambda c: S.str_starts_with(c, b"ab"),
                  lambda b: b.startswith(b"ab")),
    "ends b": (lambda c: S.str_ends_with(c, b"b"),
               lambda b: b.endswith(b"b")),
    "ascii": (S.str_ascii, lambda b: b[0] if b else 0),
}


@pytest.mark.parametrize("case", list(ORACLES))
def test_string_ops_follow_python_oracles(case):
    op, oracle = ORACLES[case]
    got = _bytes(op(_col(VALUES)), len(VALUES))
    assert got == [None if b is None else oracle(b) for b in B]


def test_concat_ws_skips_nulls_and_concat_is_null_intolerant():
    a = _col(["a", None, "", None, "日"])
    b = _col(["b", "x", None, None, "本"])
    assert _bytes(S.str_concat_ws(b"--", [a, b, a]), 5) == [
        b"a--b--a", b"x", b"--", b"", "日--本--日".encode()]
    assert _bytes(S.str_concat_pair(a, b), 5) == [b"ab", None, None, None,
                                                  "日本".encode()]


def test_chr_and_compare_follow_python():
    codes = Column.from_pylist([65, 0, -1, 256 + 66, 200, None], INT,
                               device="cpu")
    assert _bytes(S.str_chr(codes), 6) == [b"A", b"", b"", b"B",
                                          bytes([200]), None]
    a, b = _col(VALUES), _col(list(reversed(VALUES)))
    S.reset_counters()
    sign = S.string_compare_cols(a, b)[:len(VALUES)].tolist()
    want = [0 if x is None or y is None else (x > y) - (x < y)
            for x, y in zip(B, reversed(B))]
    assert [s if x is not None and y is not None else 0
            for s, x, y in zip(sign, B, reversed(B))] == want
    assert S.counters()["host_reads"] == 1


def test_bordered_needles_select_greedily_with_one_counted_read():
    c = _col(["aaaaa", "aaa", "baaab", None, "", "aa"])
    S.reset_counters()
    hits = S.select_literal_hits(c, b"aa")
    starts = [p for p in range(c.byte_capacity) if hits[p]]
    assert starts == [0, 2, 5, 9, 13]  # Java's left-to-right choice
    assert S.counters()["host_reads"] == 1
    S.reset_counters()
    S.select_literal_hits(c, b"ab")  # no border: no loop, no read
    assert S.counters()["host_reads"] == 0


def test_padded_round_trip():
    c = _col(VALUES)
    lengths, padded = S.string_to_padded(c, 6)
    back = S.string_from_padded(lengths, padded, c.validity)
    assert _bytes(back, len(VALUES)) == [None if b is None else b[:6]
                                         for b in B]
