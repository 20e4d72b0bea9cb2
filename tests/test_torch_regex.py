"""The port's regex (regex/) against the JAX package's, on the CPU: the
copied parser and Glushkov construction give the same programs (byte
table, follow rows, first/last masks, nullability, anchors) and reject
the same constructs with the same message; LIKE translates as the
reference's; the matching loop (`regex_find`, one state mask per row in
int64 lanes) equals the JAX package's while_loop once per pattern kind
(unanchored, anchored start with its early exit, both anchors) and
Python's `re` on more patterns; the span finder's regexp_extract and
regexp_replace equal the JAX package's and Python's. The loop's trip
count is one counted host read; the early exit adds a read at 1, 2, 4,
... steps.
"""

import re

import numpy as np
import pytest

from spark_rapids_tpu import regex as jregex
from spark_rapids_tpu.columnar.column import StringColumn as JString
from spark_rapids_tpu.regex import spans as jspans

from spark_rapids_tpu_torch import regex as tregex
from spark_rapids_tpu_torch.columnar.column import StringColumn
from spark_rapids_tpu_torch.regex import kernel as tkernel
from spark_rapids_tpu_torch.regex import spans as tspans

from test_torch_jax_ref import jax_aliases

ROWS = ["abc", "xxabcxx", "", "a", "aaab", "PROMO BRUSHED TIN",
        "STANDARD PLATED NICKEL", "12-345-678-9012", "héllo 42 wörld",
        "line\nbreak", "a.b*c", "abcabc", "zzz", None, "ab", "000123abc",
        "  spaced  out  ", "PROMO", "xPROMO"]
BYTES = [None if r is None else r.encode() for r in ROWS]

PATTERNS = ["abc", "a+b", "^a", "c$", "^abc$", "[0-9]+", "a|b|zz", "(ab)+",
            "x{2}a", "\\d{3}-\\d{3}", "[^a-z ]", "h.llo", "a?b?c?",
            "PROMO.*", "^$", "\\s+", "[A-Z]{5} [A-Z]+", "b{1,3}"]
REJECTED = ["(a)\\1", "(?=a)", "a*?", "\\bword", "\\p{L}", "(?<n>a)",
            "a|b$", "a{1,40}", "a^b", "[z-a]", "(?i)a", "a{9}" * 4]
LIKES = ["PROMO%", "%BRUSHED%", "a_c", "%", "", "abc", "\\%x", "_%_",
         "%abc%abc%"]


def _col(rows=ROWS):
    return StringColumn.from_pylist(rows, device="cpu")


def _jcol(t):
    import jax.numpy as jnp
    from spark_rapids_tpu.types import StringType
    return JString(jnp.asarray(t.data.numpy()), jnp.asarray(t.offsets.numpy()),
                   jnp.asarray(t.validity.numpy()), StringType())


def _bools(c, n=len(ROWS)):
    d, v = np.asarray(c.data), np.asarray(c.validity)
    return [bool(x) if ok else None for x, ok in zip(d[:n], v[:n])]


def _raw(c, n=len(ROWS)):
    d, o, v = (np.asarray(x) for x in (c.data, c.offsets, c.validity))
    return [bytes(d[o[i]:o[i + 1]]) if v[i] else None for i in range(n)]


def _same_program(a, b):
    assert (a.n_pos, a.first_mask, a.last_mask, a.nullable, a.anchored_start,
            a.anchored_end) == (b.n_pos, b.first_mask, b.last_mask,
                                b.nullable, b.anchored_start, b.anchored_end)
    np.testing.assert_array_equal(a.byte_table, b.byte_table)
    np.testing.assert_array_equal(a.follow_rows, b.follow_rows)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_programs_equal_the_jax_packages(pattern):
    _same_program(tregex.compile_regex(pattern),
                  jregex.compile_regex(pattern))


@pytest.mark.parametrize("pattern", LIKES)
def test_like_translates_as_the_jax_package(pattern):
    _same_program(tregex.like_to_program(pattern),
                  jregex.like_to_program(pattern))


@pytest.mark.parametrize("pattern", REJECTED + ["a" * 33])
def test_unsupported_constructs_raise_the_same_reason(pattern):
    with pytest.raises(jregex.RegexUnsupported) as jerr:
        jregex.compile_regex(pattern)
    with pytest.raises(tregex.RegexUnsupported) as terr:
        tregex.compile_regex(pattern)
    assert str(terr.value) == str(jerr.value)


#: one pattern of each loop kind: unanchored find, anchored start (the
#: early exit), both anchors (LIKE), a 32-position program (bit 31 live)
JAX_CASES = {"find": "a+b", "anchored start": "^[a-z]+c",
             "like": None, "32 positions": "a" * 31 + "b"}


@pytest.mark.parametrize("kind", list(JAX_CASES))
def test_regex_find_matches_jax(kind):
    pattern = JAX_CASES[kind]
    rows = ROWS + ["a" * 31 + "b", "x" + "a" * 31 + "b"]
    t = _col(rows)
    tprog = tregex.like_to_program("%BRUSHED%") if pattern is None \
        else tregex.compile_regex(pattern)
    jprog = jregex.like_to_program("%BRUSHED%") if pattern is None \
        else jregex.compile_regex(pattern)
    with jax_aliases():
        want = _bools(jregex.regex_find(_jcol(t), jprog), len(rows))
    assert _bools(tregex.regex_find(t, tprog), len(rows)) == want


@pytest.mark.parametrize("pattern", PATTERNS)
def test_rlike_follows_python_re(pattern):
    got = _bools(tregex.regex_find(_col(), tregex.compile_regex(pattern)))
    rx = re.compile(pattern.encode())
    want = [None if b is None else rx.search(b) is not None for b in BYTES]
    assert got == want


def _like_re(pattern):
    out, i = [], 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\":
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        out.append(".*" if ch == "%" else "." if ch == "_" else
                   re.escape(ch))
        i += 1
    return re.compile("".join(out).encode(), re.DOTALL)


@pytest.mark.parametrize("pattern", LIKES)
def test_like_follows_python(pattern):
    got = _bools(tregex.regex_find(_col(), tregex.like_to_program(pattern)))
    rx = _like_re(pattern)
    assert got == [None if b is None else rx.fullmatch(b) is not None
                   for b in BYTES]


def test_loop_reads_its_bound_once_and_exits_early():
    """The trip count is one read; an anchored-start find whose rows all
    die on their first byte stops after one step, reading once more."""
    rows = ["zz" + "y" * 200, "q" * 150, None, "zzzz"]
    tkernel.reset_counters()
    got = _bools(tregex.regex_find(_col(rows), tregex.compile_regex("^a")),
                 4)
    assert got == [False, False, None, False]
    c = tkernel.counters()
    assert c == {"evaluations": 1, "steps": 1, "host_reads": 2}
    tkernel.reset_counters()
    tregex.regex_find(_col(rows), tregex.compile_regex("a"))
    assert tkernel.counters() == {"evaluations": 1, "steps": 202,
                                  "host_reads": 1}


SPAN_CASES = [("[0-9]+", 0, "#"), ("([0-9]+)", 1, ""), ("a", 0, "AA"),
              ("[a-z]{2}", 0, "-"), ("(a)(b)c", 2, "X"), ("^[A-Z]+", 0, "_"),
              ("\\s+", 0, " "), ("[0-9]{3}$", 0, "")]


@pytest.mark.parametrize("pattern,idx,repl", SPAN_CASES[:2])
def test_spans_match_jax(pattern, idx, repl):
    t = _col()
    tplan, jplan = tspans.compile_spans(pattern), jspans.compile_spans(pattern)
    with jax_aliases():
        j = _jcol(t)
        want = (_raw(jspans.regexp_extract_device(j, jplan, idx)),
                _raw(jspans.regexp_replace_device(j, jplan, repl.encode())))
    got = (_raw(tspans.regexp_extract_device(t, tplan, idx)),
           _raw(tspans.regexp_replace_device(t, tplan, repl.encode())))
    assert got == want


@pytest.mark.parametrize("pattern,idx,repl", SPAN_CASES)
def test_spans_follow_python_re(pattern, idx, repl):
    t = _col()
    plan = tspans.compile_spans(pattern)
    rx = re.compile(pattern.encode())

    def extract(b):
        m = rx.search(b)
        return b"" if m is None else m.group(idx)
    assert _raw(tspans.regexp_extract_device(t, plan, idx)) == [
        None if b is None else extract(b) for b in BYTES]
    assert _raw(tspans.regexp_replace_device(t, plan, repl.encode())) == [
        None if b is None else rx.sub(repl.encode(), b) for b in BYTES]


@pytest.mark.parametrize("pattern", ["a*b", "(a|bc)", "([0-9])+", "a+b+"])
def test_span_finder_rejects_what_it_cannot_place(pattern):
    with pytest.raises(jregex.RegexUnsupported) as jerr:
        jspans.compile_spans(pattern) if pattern != "([0-9])+" else \
            jspans.regexp_extract_device(
                JString.from_pylist([]), jspans.compile_spans(pattern), 1)
    with pytest.raises(tregex.RegexUnsupported) as terr:
        tspans.compile_spans(pattern) if pattern != "([0-9])+" else \
            tspans.extract_window(tspans.compile_spans(pattern), 1)
    assert str(terr.value) == str(jerr.value)
