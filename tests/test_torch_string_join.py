"""String-key joins in the port (ops/join.py, exec/joins.py) against the
JAX package, on the CPU:

- an inner HashJoinExec on string keys, dictionary keys whose two
  dictionaries list the words in different orders (and hold words the
  other lacks), a string side against a dictionary side both ways, a
  (string, INT) key pair, null keys on both sides, duplicate build keys
  (fan-out), a string payload, an absorbed filter and a residual
  condition: the output rows and their order equal the JAX package's bit
  for bit;
- the join's bucket hash gives a string and its dictionary-encoded form
  the same value, as in the JAX package, and `verify_pairs` the JAX
  package's verdicts on the same candidates;
- string and dictionary keys never reach the probe kernel: they take the
  expand-and-verify route.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import joins as jjoins
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred
from spark_rapids_tpu.columnar import encoded as jenc
from spark_rapids_tpu.ops import join as jjoin

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar import encoded as tenc
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import joins as tjoins
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import predicates as tpred
from spark_rapids_tpu_torch.ops import join as tjoin

from test_torch_encoded import both_batch, both_column
from test_torch_jax_ref import jax_aliases

JAX = SimpleNamespace(t=jt, core=jcore, pred=jpred, basic=jbasic,
                      joins=jjoins)
TORCH = SimpleNamespace(t=tt, core=tcore, pred=tpred, basic=tbasic,
                        joins=tjoins)
WORDS = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB", "",
         "DELIVER IN PERSON", "é", "a much longer key, past thirty-two bytes")


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _key_spec(kind, rng, n, words):
    """One key column spec for both_batch: a plain string column or a
    dictionary of `words` in the order given, ~10 % nulls."""
    codes = rng.integers(0, len(words), n).astype(np.int32)
    valid = rng.random(n) > 0.1
    if kind == "dict":
        return ((codes, tuple(words)), "STRING", valid)
    return ([words[c] for c in codes], "STRING", valid)


def _sides(stream_kind, build_kind, seed=0, n_stream=2000, n_build=300):
    rng = np.random.default_rng(seed)
    # the build side's dictionary: another order, one word the stream
    # lacks, and missing one the stream has
    build_words = tuple(reversed(WORDS[1:])) + ("ONLY BUILD",)
    stream = {"sk": _key_spec(stream_kind, rng, n_stream, WORDS),
              "si": (rng.integers(0, 3, n_stream).astype(np.int32), "INT",
                     rng.random(n_stream) > 0.1),
              "sv": (rng.random(n_stream) * 100, "DOUBLE", None)}
    build = {"bk": _key_spec(build_kind, rng, n_build, build_words),
             "bi": (rng.integers(0, 3, n_build).astype(np.int32), "INT",
                    rng.random(n_build) > 0.1),
             "bw": (rng.random(n_build) * 100, "DOUBLE", None),
             "bs": ([f"payload-{i}" * (i % 4) for i in range(n_build)],
                    "STRING", rng.random(n_build) > 0.1)}
    return both_batch(stream, n_stream), both_batch(build, n_build)


def _plan(p, sb, bb, two_keys=False, condition=False, stream_filter=False):
    col, lit = p.core.col, p.core.lit
    s = p.basic.InMemoryScanExec([sb], sb.schema)
    if stream_filter:
        s = p.basic.FilterExec(p.pred.GreaterThan(col("sv"), lit(20.0)), s)
    b = p.basic.InMemoryScanExec([bb], bb.schema)
    lk, rk = [col("sk")], [col("bk")]
    if two_keys:
        lk.append(col("si"))
        rk.append(col("bi"))
    cond = p.pred.LessThan(col("sv"), col("bw")) if condition else None
    return p.joins.HashJoinExec(s, b, lk, rk, "inner", build_side="right",
                                condition=cond)


def _rows(plan):
    plan._encoded_ok_for_parent = True     # as an encoded-aware parent
    return [r for b in plan.execute() for r in b.to_pylist()]


CASES = {
    "string keys": ("str", "str", {}),
    "dictionaries in different orders": ("dict", "dict", {}),
    "dictionary stream, string build": ("dict", "str", {}),
    "string stream, dictionary build": ("str", "dict", {}),
    "string and INT keys": ("dict", "str", {"two_keys": True}),
    "residual condition": ("dict", "dict", {"condition": True}),
    "absorbed filter": ("str", "dict", {"stream_filter": True,
                                        "two_keys": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_string_key_join_matches_jax(case, monkeypatch):
    sk, bk, kw = CASES[case]
    (js, ts), (jb, tb) = _sides(sk, bk, seed=len(case))
    calls = []
    real = tjoins.fused_probe_verify
    monkeypatch.setattr(tjoins, "fused_probe_verify",
                        lambda *a: calls.append(1) or real(*a))
    trows = _rows(_plan(TORCH, ts, tb, **kw))
    jrows = _rows(_plan(JAX, js, jb, **kw))
    assert trows == jrows
    assert not calls
    # against a nested-loop oracle: the same multiset of pairs
    want = _oracle(ts, tb, kw)
    assert sorted(trows, key=repr) == sorted(want, key=repr)
    assert len(trows) > 100


def _oracle(ts, tb, kw):
    srows = [r for r in zip(*(c.to_pylist(2000) for c in ts.columns))]
    brows = [r for r in zip(*(c.to_pylist(300) for c in tb.columns))]
    out = []
    for s in srows:
        if kw.get("stream_filter") and not s[2] > 20.0:
            continue
        for b in brows:
            if s[0] is None or b[0] is None or s[0] != b[0]:
                continue
            if kw.get("two_keys") and (s[1] is None or b[1] is None
                                       or s[1] != b[1]):
                continue
            if kw.get("condition") and not s[2] < b[2]:
                continue
            out.append(s + b)
    return out


def test_integer_keys_still_take_the_probe_kernel(monkeypatch):
    (js, ts), (jb, tb) = _sides("str", "str", seed=9)
    calls = []
    real = tjoins.fused_probe_verify
    monkeypatch.setattr(tjoins, "fused_probe_verify",
                        lambda *a: calls.append(1) or real(*a))

    def plan(p, sb, bb):
        col = p.core.col
        return p.joins.HashJoinExec(
            p.basic.InMemoryScanExec([sb], sb.schema),
            p.basic.InMemoryScanExec([bb], bb.schema), [col("si")],
            [col("bi")], "inner", build_side="right")
    assert _rows(plan(TORCH, ts, tb)) == _rows(plan(JAX, js, jb))
    assert calls == [1]


def test_bucket_hash_of_a_string_equals_its_dictionary_form():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, len(WORDS), 500).astype(np.int32)
    valid = rng.random(500) > 0.1
    jd, td = both_column((codes, WORDS), "STRING", valid)
    js, ts = both_column([WORDS[c] for c in codes], "STRING", valid)
    for lo_too in (True, False):
        hd = tjoin.join_hash_pair([td], lo_too)
        hs = tjoin.join_hash_pair([ts], lo_too)
        jh = jjoin.join_hash_pair([jd], lo_too)
        for a, b, c in zip(hd, hs, jh):
            if c is None:
                assert a is None and b is None
                continue
            np.testing.assert_array_equal(a.numpy()[:500][valid],
                                          b.numpy()[:500][valid])
            np.testing.assert_array_equal(
                a.numpy().view(np.uint32), np.asarray(c))


def test_verify_pairs_matches_jax_on_dictionary_candidates():
    (js, ts), (jb, tb) = _sides("dict", "str", seed=5)
    n_s, n_b = 2000, 300
    jt_ = jjoin.BuildTable.build([jb.columns[0]], list(jb.columns),
                                 jnp.int32(n_b), jb.capacity)
    tt_ = tjoin.BuildTable.build([tb.columns[0]], list(tb.columns),
                                 torch.tensor(n_b), tb.capacity)
    assert tt_.key_lanes is None
    np.testing.assert_array_equal(tt_.perm.numpy(), np.asarray(jt_.perm))
    np.testing.assert_array_equal(tt_.bucket_table.numpy(),
                                  np.asarray(jt_.bucket_table))
    jlo, jc, _ = jjoin.probe_counts(jt_, [js.columns[0]], jnp.int32(n_s),
                                    js.capacity)
    tlo, tc, _ = tjoin.probe_counts(tt_, [ts.columns[0]], torch.tensor(n_s),
                                    ts.capacity)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    cap = 1 << int(int(tc.sum()) - 1).bit_length()
    js_idx, jpos, _ = jjoin.expand_candidates(jlo, jc, cap)
    ts_idx, tpos, _ = tjoin.expand_candidates(tlo, tc, cap)
    np.testing.assert_array_equal(ts_idx.numpy(), np.asarray(js_idx))
    jok, jrow = jjoin.verify_pairs(jt_, [js.columns[0]], js_idx, jpos,
                                   js_idx >= 0)
    tok, trow = tjoin.verify_pairs(tt_, [ts.columns[0]], ts_idx, tpos,
                                   ts_idx >= 0)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(trow.numpy(), np.asarray(jrow))
    assert 0 < int(tok.sum()) <= int(tc.sum())


@pytest.mark.parametrize("kinds", [("str", "str"), ("dict", "str"),
                                   ("dict", "dict")])
def test_bytes_equal_rows_matches_jax(kinds):
    """Row-wise byte equality of two varlen columns of any mix, validity
    aside, as the JAX package's."""
    rng = np.random.default_rng(6)
    a = both_column(*_key_spec(kinds[0], rng, 700, WORDS))
    b = both_column(*_key_spec(kinds[1], rng, 700, WORDS[::-1]))
    want = np.asarray(jenc.bytes_equal_rows(a[0], b[0]))
    got = tenc.bytes_equal_rows(a[1], b[1]).numpy()
    np.testing.assert_array_equal(got, want)
    assert 30 < got[:700].sum() < 650
