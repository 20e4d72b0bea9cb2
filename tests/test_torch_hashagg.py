"""The hash group-by (ops/hashagg.py, ops/aggregate.groupby_aggregate_hash)
and the string route of AggregateExec against the JAX package, on the
CPU:

- the group assignment (slots, representative rows, `leftover`) and the
  dense ids, bit for bit, over string keys, string and integer keys with
  nulls, and keys that leave rows over;
- groupby_aggregate_hash's keys, counts and sums (integers exact, f64
  sums to rtol 1e-9: reduction order);
- a forced fallback: 1,024 distinct strings at capacity 1,024 leave rows
  over after 2 rounds in both packages, and the sort-based group-by with
  string lanes gives the JAX package's result;
- AggregateExec grouped by strings: its rows in order equal the JAX
  package's, and the route it counts (`hash_rounds_2`, `hash_rounds_6`,
  `sort_fallback`); min and max over strings (the sort path);
- Average with null and empty groups (null where the count is 0).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.exec import aggregate as jagg
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.expr import aggexprs as jaggexprs
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred
from spark_rapids_tpu.ops import aggregate as jopagg
from spark_rapids_tpu.ops import hashagg as jha

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.exec import aggregate as tagg
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.expr import aggexprs as taggexprs
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import predicates as tpred
from spark_rapids_tpu_torch.ops import aggregate as topagg
from spark_rapids_tpu_torch.ops import hashagg as tha
from spark_rapids_tpu_torch.ops import sort as tsort

from test_torch_encoded import both_batch, both_column
from test_torch_jax_ref import jax_aliases

RTOL = 1e-9
JAX = SimpleNamespace(t=jt, core=jcore, pred=jpred, basic=jbasic, agg=jagg,
                      aggexprs=jaggexprs)
TORCH = SimpleNamespace(t=tt, core=tcore, pred=tpred, basic=tbasic,
                        agg=tagg, aggexprs=taggexprs)
MODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB", "")


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _keys(seed, n, dom, with_int=False, nulls=True):
    """(JAX, port) key columns: strings drawn from `dom` words (some past
    32 bytes; dom None: n distinct words), optionally an INT key; ~10 %
    nulls each."""
    rng = np.random.default_rng(seed)
    draws = rng.permutation(n) if dom is None else rng.integers(0, dom, n)
    vals = [f"k{w}-" + "z" * (w % 37) for w in draws]
    valid = rng.random(n) > 0.1 if nulls else np.ones(n, bool)
    out = [both_column(vals, "STRING", valid)]
    if with_int:
        out.append(both_column(rng.integers(0, 3, n).astype(np.int32),
                               "INT", rng.random(n) > 0.1 if nulls
                               else None))
    return [p[0] for p in out], [p[1] for p in out]


@pytest.mark.parametrize("case", [
    (0, 3000, 40, False, 2), (1, 3000, 40, True, 2),
    (2, 1000, 1000, False, 2), (3, 1000, 1000, False, 6),
    (4, 100, 5, True, 1)])
def test_assignment_dense_ids_and_leftover_match_jax(case):
    seed, n, dom, with_int, rounds = case
    jk, tk = _keys(seed, n, dom, with_int)
    cap = jk[0].capacity
    jseg, jrep, jleft = jha.hash_group_assignment(jk, jnp.int32(n), cap,
                                                  rounds)
    tseg, trep, tleft = tha.hash_group_assignment(tk, torch.tensor(n), cap,
                                                  rounds)
    np.testing.assert_array_equal(tseg.numpy(), np.asarray(jseg))
    np.testing.assert_array_equal(trep.numpy(), np.asarray(jrep))
    assert bool(tleft) == bool(jleft)
    jd, jg, jn = jha.dense_group_ids(jseg, jrep, cap, rounds)
    td, tg, tn = tha.dense_group_ids(tseg, trep, cap, rounds)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert int(tn) == int(jn)


def _assert_keys_equal(tkeys, jkeys, n):
    for t, j in zip(tkeys, jkeys):
        assert t.to_pylist(n) == j.to_pylist(n)


def _assert_results_close(tres, jres, n):
    for (tk, tr), (jk, jr) in zip(tres, jres):
        assert tk == jk == "raw"
        td, tv = tr
        jd, jv = np.asarray(jr[0])[:n], np.asarray(jr[1])[:n]
        np.testing.assert_array_equal(tv.numpy()[:n], jv)
        td = td.numpy()[:n]
        if td.dtype.kind == "f":
            np.testing.assert_allclose(td[jv], jd[jv], rtol=RTOL)
        else:
            np.testing.assert_array_equal(td[jv], jd[jv])


def _agg_inputs(seed, n, cap):
    rng = np.random.default_rng(seed)
    jv, tv = both_column(rng.random(n) * 1e4, "DOUBLE", rng.random(n) > 0.2,
                         capacity=cap)
    ji, ti = both_column(rng.integers(-50, 50, n).astype(np.int64), "LONG",
                         rng.random(n) > 0.2, capacity=cap)
    ops = ("sum", "count", "min", "max", "sum_sq")
    ja = [(op, jv) for op in ops] + [("sum", ji), ("count_star", None)]
    ta = [(op, tv) for op in ops] + [("sum", ti), ("count_star", None)]
    return ja, ta


@pytest.mark.parametrize("with_int", [False, True])
def test_groupby_aggregate_hash_matches_jax(with_int):
    n = 3000
    jk, tk = _keys(7, n, 60, with_int)
    cap = jk[0].capacity
    ja, ta = _agg_inputs(8, n, cap)
    jkeys, jres, jn, jleft = jopagg.groupby_aggregate_hash(
        jk, ja, jnp.int32(n), cap, rounds=2)
    tkeys, tres, tn, tleft = topagg.groupby_aggregate_hash(
        tk, ta, torch.tensor(n), cap, rounds=2)
    assert not bool(jleft) and not bool(tleft)
    assert int(tn) == int(jn) > 50
    _assert_keys_equal(tkeys, jkeys, int(jn))
    _assert_results_close(tres, jres, int(jn))


def test_forced_fallback_to_the_sort_path_matches_jax():
    """1,024 distinct strings at capacity 1,024: two hash rounds leave rows
    over in both packages; the exact sort path with string lanes then
    gives the JAX package's groups, in its order."""
    n = 1024
    jk, tk = _keys(9, n, None, nulls=False)
    words = set(tk[0].to_pylist(n))
    assert len(words) == n and tk[0].capacity == n
    ja, ta = (a[:2] + a[-1:] for a in _agg_inputs(10, n, n))
    *_, jleft = jopagg.groupby_aggregate_hash(jk, ja, jnp.int32(n), n, 2)
    *_, tleft = topagg.groupby_aggregate_hash(tk, ta, torch.tensor(n), n, 2)
    assert bool(jleft) and bool(tleft)
    words_n = tsort.string_words_for(tk, [0])
    assert words_n == 8     # the longest key is past 4 words
    jkeys, jres, jn = jopagg.groupby_aggregate(jk, ja, jnp.int32(n), n,
                                               words_n)
    tkeys, tres, tn = topagg.groupby_aggregate(tk, ta, torch.tensor(n), n,
                                               words_n)
    assert int(tn) == int(jn) == n
    _assert_keys_equal(tkeys, jkeys, n)
    _assert_results_close(tres, jres, n)
    assert tkeys[0].to_pylist(n) == sorted(words, key=str.encode)


def _plan(p, batch, aggs, keys=("m",)):
    col = p.core.col
    return p.agg.AggregateExec([col(k) for k in keys],
                               [(fn(p), name) for fn, name in aggs],
                               p.basic.InMemoryScanExec([batch],
                                                        batch.schema))


def _rows(plan):
    return [r for b in plan.execute() for r in b.to_pylist()]


def _assert_rows_close(trows, jrows):
    assert len(trows) == len(jrows)
    for t, j in zip(trows, jrows):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=RTOL, abs=0)
            else:
                assert a == b


AGGS = [(lambda p: p.aggexprs.Sum(p.core.col("v")), "s"),
        (lambda p: p.aggexprs.Count(p.core.col("v")), "c"),
        (lambda p: p.aggexprs.Average(p.core.col("v")), "a"),
        (lambda p: p.aggexprs.Count(), "n")]


@pytest.mark.parametrize("case", ["modes", "dictionary", "distinct",
                                  "two keys"])
def test_aggregate_exec_string_route_matches_jax(case):
    rng = np.random.default_rng(11)
    n = 1024 if case == "distinct" else 2000
    if case == "distinct":
        keys = [f"Customer#{i:09d}" for i in rng.permutation(n)]
        m = (keys, "STRING", None)
    elif case == "dictionary":
        m = ((rng.integers(0, len(MODES), n).astype(np.int32), MODES),
             "STRING", rng.random(n) > 0.1)
    else:
        m = ([MODES[i] for i in rng.integers(0, len(MODES), n)], "STRING",
             rng.random(n) > 0.1)
    cols = {"m": m, "k": (rng.integers(0, 4, n).astype(np.int32), "INT",
                          rng.random(n) > 0.2),
            "v": (rng.random(n) * 100, "DOUBLE", rng.random(n) > 0.2)}
    jb, tb = both_batch(cols, n)
    keys = ("m", "k") if case == "two keys" else ("m",)
    jplan, tplan = _plan(JAX, jb, AGGS, keys), _plan(TORCH, tb, AGGS, keys)
    trows, jrows = _rows(tplan), _rows(jplan)
    _assert_rows_close(trows, jrows)
    routes = {k: tplan.metrics[k].value
              for k in ("hash_rounds_2", "hash_rounds_6", "sort_fallback")}
    assert sum(routes.values()) == 1        # one batch, one route
    if case == "distinct":
        assert len(trows) == n and all(r[-1] == 1 for r in trows)
    else:
        assert routes["hash_rounds_2"] == 1
    assert not tplan._fused_steps and tplan._scan_agg_spec is None


def test_string_min_max_take_the_sort_path():
    rng = np.random.default_rng(12)
    n = 1500
    words = [f"{w}-{'q' * (w % 40)}" for w in range(50)] + ["é", "\x7f"]
    cols = {"m": ([MODES[i] for i in rng.integers(0, 8, n)], "STRING",
                  rng.random(n) > 0.1),
            "w": ([words[i] for i in rng.integers(0, len(words), n)],
                  "STRING", rng.random(n) > 0.3)}
    jb, tb = both_batch(cols, n)
    aggs = [(lambda p: p.aggexprs.Min(p.core.col("w")), "lo"),
            (lambda p: p.aggexprs.Max(p.core.col("w")), "hi"),
            (lambda p: p.aggexprs.Count(p.core.col("w")), "c")]
    tplan = _plan(TORCH, tb, aggs)
    assert not tplan._hash_path_ok
    trows = _rows(tplan)
    assert trows == _rows(_plan(JAX, jb, aggs))
    assert tplan.metrics["sort_fallback"].value == 1
    # against Python's byte order
    got = {r[0]: r[1:] for r in trows}
    m_vals = tb.columns[0].to_pylist(n)
    w_vals = tb.columns[1].to_pylist(n)
    for key in set(m_vals):
        ws = [w for k, w in zip(m_vals, w_vals) if k == key and w is not None]
        want = (min(ws, key=str.encode), max(ws, key=str.encode), len(ws)) \
            if ws else (None, None, 0)
        assert got[key] == want


def test_average_null_and_empty_groups():
    """A group whose values are all null averages to null (count 0); a
    grand average over no rows is null; both as in the JAX package."""
    n = 12
    cols = {"m": (["a", "b", "c"] * 4, "STRING", None),
            "v": (np.arange(n, dtype=np.float64), "DOUBLE",
                  np.array([i % 3 != 1 for i in range(n)]))}
    jb, tb = both_batch(cols, n)
    aggs = [(lambda p: p.aggexprs.Average(p.core.col("v")), "a"),
            (lambda p: p.aggexprs.Count(p.core.col("v")), "c")]
    trows = _rows(_plan(TORCH, tb, aggs))
    assert trows == _rows(_plan(JAX, jb, aggs))
    assert sorted(trows) == [("a", 4.5, 4), ("b", None, 0), ("c", 6.5, 4)]

    def grand(p, batch):
        col, lit = p.core.col, p.core.lit
        empty = p.basic.FilterExec(p.pred.GreaterThan(col("v"), lit(1e9)),
                                   p.basic.InMemoryScanExec([batch],
                                                            batch.schema))
        return p.agg.AggregateExec([], [(p.aggexprs.Average(col("v")), "a"),
                                        (p.aggexprs.Count(), "n")], empty)
    assert _rows(grand(TORCH, tb)) == _rows(grand(JAX, jb)) == [(None, 0)]


def test_count_of_a_string_input_on_the_hash_path():
    """count(string) by a string key: the port's hash path counts the
    non-null strings; the JAX package's hash path raises for it (ROADMAP
    C.5), so the reference is its sort path, compared group by group."""
    rng = np.random.default_rng(13)
    n = 500
    jk, tk = _keys(14, n, 9)
    jv, tv = both_column([MODES[i] for i in rng.integers(0, 8, n)],
                         "STRING", rng.random(n) > 0.3)
    cap = jk[0].capacity
    with pytest.raises(NotImplementedError):
        jopagg.groupby_aggregate_hash(jk, [("count", jv)], jnp.int32(n),
                                      cap, 2)
    tkeys, tres, tn, tleft = topagg.groupby_aggregate_hash(
        tk, [("count", tv)], torch.tensor(n), cap, 2)
    jkeys, jres, jn = jopagg.groupby_aggregate(jk, [("count", jv)],
                                               jnp.int32(n), cap, 4)
    assert not bool(tleft) and int(tn) == int(jn)
    got = dict(zip(tkeys[0].to_pylist(int(tn)),
                   tres[0][1][0].numpy()[:int(tn)].tolist()))
    want = dict(zip(jkeys[0].to_pylist(int(jn)),
                    np.asarray(jres[0][1][0])[:int(jn)].tolist()))
    assert got == want
