"""The port's string codecs (ops/codecs.py: base64 and hex both ways),
charsets (ops/charsets.py: single-byte encode and decode, the UTF-8
passthrough) and the delimiter family (ops/string_split.py:
substring_index, find_in_set), through their expressions, against the
JAX package's on the CPU (once each, byte for byte) and against Python's
base64, bytes.hex/fromhex, str.encode/decode and split/index on more
cases. Malformed input gives null as the JAX package's host tier does.
"""

import base64
from types import SimpleNamespace

import numpy as np
import pytest

from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import stringexprs as jse

from spark_rapids_tpu_torch.columnar.column import Column, StringColumn
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import stringexprs as tse
from spark_rapids_tpu_torch.ops import charsets, codecs, string_split
from spark_rapids_tpu_torch.types import LONG

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases
from test_torch_strings import raw

JAX = SimpleNamespace(core=jcore, se=jse)
TORCH = SimpleNamespace(core=tcore, se=tse)

WORDS = ["", "a", "ab", "abc", "hello wörld", "日本語", "QUJD", "QUI=",
         "QQ==", "QQ", "Q", "a=b", "!!!!", "0x1F", "DEADbeef", "abc",
         "a,b,,c", "b", ",", "a,b,", "café", "ÿ", "x.y.z", "a..b"]


def _rows(n=64, seed=1):
    rng = np.random.default_rng(seed)
    s = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
    u = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
    return {"s": (s, "STRING", rng.random(n) > 0.1),
            "u": (u, "STRING", rng.random(n) > 0.1),
            "l": (rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
                  "LONG", rng.random(n) > 0.1)}


@pytest.fixture(scope="module")
def batches():
    with jax_aliases():
        yield both_batch(_rows(), 64)


EXPRS = {
    "Base64Encode": lambda m, c: m.se.Base64Encode(c("s")),
    "UnBase64": lambda m, c: m.se.UnBase64(c("s")),
    "Hex string": lambda m, c: m.se.Hex(c("s")),
    "Hex long": lambda m, c: m.se.Hex(c("l")),
    "Unhex": lambda m, c: m.se.Unhex(c("s")),
    "Encode US-ASCII": lambda m, c: m.se.Encode(c("s"), "US-ASCII"),
    "Encode ISO-8859-1": lambda m, c: m.se.Encode(c("s"), "ISO-8859-1"),
    "Encode UTF-8": lambda m, c: m.se.Encode(c("s"), "utf-8"),
    "Decode ISO-8859-1": lambda m, c: m.se.Decode(c("s"), "ISO-8859-1"),
    "Decode US-ASCII": lambda m, c: m.se.Decode(c("s"), "US-ASCII"),
    "SubstringIndex": lambda m, c: m.se.SubstringIndex(c("s"), ".", -2),
    "SubstringIndex bordered": lambda m, c: m.se.SubstringIndex(
        c("s"), "..", 1),
    "FindInSet": lambda m, c: m.se.FindInSet(c("u"), c("s")),
}


@pytest.mark.parametrize("name", list(EXPRS))
def test_expression_matches_jax(batches, name):
    jb, tb = batches
    with jax_aliases():
        want = raw(jcore.resolve(EXPRS[name](JAX, jcore.col), jb.schema)
                   .columnar_eval(jb), 64)
    got = raw(tcore.resolve(EXPRS[name](TORCH, tcore.col), tb.schema)
              .columnar_eval(tb), 64)
    assert got == want


VALUES = WORDS + [None, "a" * 50, "ab" * 20]
B = [None if v is None else v.encode() for v in VALUES]


def _col(values=VALUES):
    return StringColumn.from_pylist(values, device="cpu")


def _unbase64(b):
    try:
        b.decode("ascii")
    except UnicodeDecodeError:
        return None
    body = b.rstrip(b"=")
    if (len(b) - len(body) > 2 or b"=" in body or len(body) % 4 == 1
            or any(ch not in b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnop"
                   b"qrstuvwxyz0123456789+/" for ch in body)):
        return None
    return base64.b64decode(body + b"=" * (-len(body) % 4))


def _unhex(b):
    if any(ch not in b"0123456789abcdefABCDEF" for ch in b):
        return None
    return bytes.fromhex(("0" if len(b) % 2 else "") + b.decode())


def _substring_index(b, delim, count):
    parts = b.split(delim)
    if count > 0:
        return delim.join(parts[:count]) if len(parts) > count else b
    return delim.join(parts[count:]) if len(parts) > -count else b


ORACLES = {
    "base64": (codecs.base64_encode, base64.b64encode),
    "unbase64": (codecs.base64_decode, _unbase64),
    "hex": (codecs.hex_encode, lambda b: b.hex().upper().encode()),
    "unhex": (codecs.hex_decode, _unhex),
    "base64 round trip": (
        lambda c: codecs.base64_decode(codecs.base64_encode(c)),
        lambda b: b),
    "encode ascii": (
        lambda c: charsets.encode_single_byte(c, "US-ASCII"),
        lambda b: b.decode().encode("ascii", errors="replace")),
    "encode latin-1": (
        lambda c: charsets.encode_single_byte(c, "ISO-8859-1"),
        lambda b: b.decode().encode("latin-1", errors="replace")),
    "decode latin-1": (
        lambda c: charsets.decode_single_byte(c, "ISO-8859-1"),
        lambda b: b.decode("latin-1").encode()),
    "decode ascii": (
        lambda c: charsets.decode_single_byte(c, "US-ASCII"),
        lambda b: b.decode("ascii", errors="replace").encode()),
    "substring_index , 2": (
        lambda c: string_split.substring_index(c, b",", 2),
        lambda b: _substring_index(b, b",", 2)),
    "substring_index , -1": (
        lambda c: string_split.substring_index(c, b",", -1),
        lambda b: _substring_index(b, b",", -1)),
    "substring_index aa 2": (
        lambda c: string_split.substring_index(c, b"aa", 2),
        lambda b: _substring_index(b, b"aa", 2)),
    "substring_index ab -3": (
        lambda c: string_split.substring_index(c, b"ab", -3),
        lambda b: _substring_index(b, b"ab", -3)),
    "substring_index x 0": (
        lambda c: string_split.substring_index(c, b"x", 0),
        lambda b: b""),
}


@pytest.mark.parametrize("case", list(ORACLES))
def test_codecs_follow_python(case):
    op, oracle = ORACLES[case]
    assert raw(op(_col()), len(VALUES)) == [None if b is None else oracle(b)
                                            for b in B]


def test_hex_of_longs_follows_python():
    vals = [0, 1, 15, 16, 255, -1, -(2**63), 2**63 - 1, 1234567890123, None]
    c = Column.from_pylist(vals, LONG, device="cpu")
    assert raw(codecs.hex_encode_long(c), len(vals)) == [
        None if v is None else format(v & (2**64 - 1), "X").encode()
        for v in vals]


def test_find_in_set_follows_python():
    sets = ["a,b,c", "a,b,c", "", ",", "a,,b", "abc", "a,b,", None, "x,y"]
    needles = ["b", "d", "", "", "", "abc", "", "a", "a,b"]
    got = raw(string_split.find_in_set(_col(needles), _col(sets)), 9)

    def want(n, s):
        if n is None or s is None:
            return None
        if "," in n:
            return 0
        items = s.split(",")
        return items.index(n) + 1 if n in items else 0
    assert got == [want(n, s) for n, s in zip(needles, sets)]
