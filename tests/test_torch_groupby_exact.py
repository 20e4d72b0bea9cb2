"""Parity of the port's exact aggregation tier with the JAX package:

- the multi-column sort (`sort_permutation`, `sort_batch_columns`) and
  `group_segment_ids`, ascending and descending, nulls first and last,
  over INT/LONG/SHORT/BOOLEAN/FLOAT/DOUBLE keys with NaN and -0.0;
- the sort-based `groupby_aggregate` (sum, sum_sq, count, count_star, min,
  max; `pre_grouped` too) and `masked_groupby_exact` on both of its
  branches, with and without a row mask;
- `AggregateExec`'s exact tier over many batches (the MERGE_FAN_IN window,
  the device tree merge and the shrink) and a grand aggregate;
- q1 at high cardinality: the speculative tier trips its flag and
  `collect()` re-runs the plan exactly instead of raising.

Keys, group order, counts, integer sums and min/max are exact; f64 sums
agree to rtol 1e-9 (the port reduces each segment directly, the reference
through a segment-local scan: only the order of the additions differs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.exec import aggregate as jagg
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import speculation as jspec
from spark_rapids_tpu.expr import aggexprs as jaggexprs
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.ops import aggregate as jopagg
from spark_rapids_tpu.ops import maskedagg as jm
from spark_rapids_tpu.ops import sort as jsort

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.columnar.column import Column as TColumn
from spark_rapids_tpu_torch.exec import aggregate as tagg
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import speculation as tspec
from spark_rapids_tpu_torch.expr import aggexprs as taggexprs
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.ops import aggregate as topagg
from spark_rapids_tpu_torch.ops import maskedagg as tm
from spark_rapids_tpu_torch.ops import sort as tsort

from test_torch_jax_ref import jax_aliases

CAP = 4096
RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _values(rng, n, type_name, dom):
    if type_name == "BOOLEAN":
        return rng.integers(0, 2, n).astype(np.bool_)
    if type_name in ("FLOAT", "DOUBLE"):
        v = rng.integers(-dom, dom, n) / 4.0
        v[::13] = np.nan
        v[::17] = -0.0
        v[::19] = 0.0
        return v.astype(np.float32 if type_name == "FLOAT" else np.float64)
    return rng.integers(-dom, dom, n).astype(getattr(tt, type_name).np_dtype)


def _pair(values, type_name, valid):
    jc = JColumn.from_numpy(values, getattr(jt, type_name), validity=valid,
                            capacity=CAP)
    tc = TColumn(torch.from_numpy(np.asarray(jc.data).copy()),
                 torch.from_numpy(np.asarray(jc.validity).copy()),
                 getattr(tt, type_name))
    return jc, tc


def _cols(seed, types, n, dom=40, null_rate=0.1):
    rng = np.random.default_rng(seed)
    pairs = [_pair(_values(rng, n, t, dom), t, rng.random(n) > null_rate)
             for t in types]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def _assert_keys_equal(tcols, jcols):
    for tc, jc in zip(tcols, jcols):
        np.testing.assert_array_equal(tc.validity.numpy(),
                                      np.asarray(jc.validity))
        np.testing.assert_array_equal(_bits(tc.data.numpy()),
                                      _bits(jc.data))


def _assert_results_close(tres, jres, n_groups):
    for (_, (td, tv)), (_, (jd, jv)) in zip(tres, jres):
        td, tv = td.numpy()[:n_groups], tv.numpy()[:n_groups]
        jd, jv = np.asarray(jd)[:n_groups], np.asarray(jv)[:n_groups]
        np.testing.assert_array_equal(tv, jv)
        assert td.dtype == jd.dtype
        if td.dtype.kind == "f":
            np.testing.assert_allclose(td[tv], jd[jv], rtol=RTOL, atol=0)
        else:
            np.testing.assert_array_equal(td[tv], jd[jv])


ORDERS = [(True, None), (False, None), (True, False), (False, True)]


@pytest.mark.parametrize("ascending,nulls_first", ORDERS)
def test_sort_permutation_matches_jax(ascending, nulls_first):
    types = ["INT", "DOUBLE", "LONG", "FLOAT", "BOOLEAN", "SHORT"]
    jcols, tcols = _cols(1, types, 3500, dom=6)
    n = 3300
    orders_j = [jsort.SortOrder(i, ascending, nulls_first)
                for i in range(len(types))]
    orders_t = [tsort.SortOrder(i, ascending, nulls_first)
                for i in range(len(types))]
    assert [o.nulls_first for o in orders_t] == \
        [o.nulls_first for o in orders_j]
    want = np.asarray(jsort.sort_permutation(jcols, orders_j, jnp.int32(n),
                                             CAP))
    got = tsort.sort_permutation(tcols, orders_t, torch.tensor(n), CAP)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    js, jp = jsort.sort_batch_columns(jcols, orders_j[:2], jnp.int32(n), CAP)
    ts, tp = tsort.sort_batch_columns(tcols, orders_t[:2], torch.tensor(n),
                                      CAP)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    _assert_keys_equal(ts, js)


def test_group_segment_ids_match_jax():
    jcols, tcols = _cols(2, ["LONG", "DOUBLE"], 3000, dom=5)
    orders_j = [jsort.SortOrder(0), jsort.SortOrder(1)]
    orders_t = [tsort.SortOrder(0), tsort.SortOrder(1)]
    js, _ = jsort.sort_batch_columns(jcols, orders_j, jnp.int32(3000), CAP)
    ts, _ = tsort.sort_batch_columns(tcols, orders_t, torch.tensor(3000), CAP)
    jseg, jn = jsort.group_segment_ids(js, jnp.int32(3000), CAP)
    tseg, tn = tsort.group_segment_ids(ts, torch.tensor(3000), CAP)
    assert int(tn) == int(jn) > 1
    np.testing.assert_array_equal(tseg.numpy(), np.asarray(jseg))


AGGS = [("sum", 2), ("sum_sq", 3), ("count", 2), ("count_star", None),
        ("min", 3), ("max", 2), ("min", 4), ("max", 4), ("sum", 4)]


def _agg_inputs(cols):
    return [(op, cols[i] if i is not None else None) for op, i in AGGS]


@pytest.mark.parametrize("key_types", [["INT"], ["LONG", "DOUBLE"],
                                       ["FLOAT", "BOOLEAN"]])
@pytest.mark.parametrize("n", [0, 1, 3000])
def test_groupby_aggregate_matches_jax(key_types, n):
    types = key_types + ["DOUBLE", "LONG", "INT"]
    types = (types + ["DOUBLE"])[:5] if len(key_types) == 1 else types
    jcols, tcols = _cols(n + len(key_types), types, max(n, 1), dom=30)
    k = len(key_types)
    aggs = [(op, i + k - 2 if i is not None else None) for op, i in AGGS]
    ja = [(op, jcols[i] if i is not None else None) for op, i in aggs]
    ta = [(op, tcols[i] if i is not None else None) for op, i in aggs]
    jk, jr, jn = jopagg.groupby_aggregate(jcols[:k], ja, jnp.int32(n), CAP, 1)
    tk, tr, tn = topagg.groupby_aggregate(tcols[:k], ta, torch.tensor(n), CAP)
    assert int(tn) == int(jn)
    _assert_keys_equal(tk, jk)
    _assert_results_close(tr, jr, int(jn))


def test_groupby_aggregate_pre_grouped_matches_jax():
    rng = np.random.default_rng(3)
    n = 2500
    keys = np.sort(rng.integers(0, 300, n)).astype(np.int64)[::-1].copy()
    jk_, tk_ = _pair(keys, "LONG", np.ones(n, bool))
    jv, tv = _pair(rng.random(n) * 1e6, "DOUBLE", rng.random(n) > 0.1)
    ja = [("sum", jv), ("count", jv), ("count_star", None)]
    ta = [("sum", tv), ("count", tv), ("count_star", None)]
    jk, jr, jn = jopagg.groupby_aggregate([jk_], ja, jnp.int32(n), CAP, 1,
                                          pre_grouped=True)
    tk, tr, tn = topagg.groupby_aggregate([tk_], ta, torch.tensor(n), CAP,
                                          pre_grouped=True)
    assert int(tn) == int(jn) > 200
    _assert_keys_equal(tk, jk)
    _assert_results_close(tr, jr, int(jn))


@pytest.mark.parametrize("dom", [8, 2000])   # fast branch; sort branch
@pytest.mark.parametrize("masked", [False, True])
def test_masked_groupby_exact_matches_jax(dom, masked):
    jcols, tcols = _cols(dom, ["INT", "LONG", "DOUBLE", "DOUBLE", "INT"],
                         3600, dom=dom)
    n = 3500
    mask = np.random.default_rng(4).random(CAP) > 0.3 if masked else None
    jk, jr, jn = jm.masked_groupby_exact(
        jcols[:2], _agg_inputs(jcols), jnp.int32(n), CAP,
        None if mask is None else jnp.asarray(mask))
    tk, tr, tn = tm.masked_groupby_exact(
        tcols[:2], _agg_inputs(tcols), torch.tensor(n), CAP,
        None if mask is None else torch.from_numpy(mask))
    assert int(tn) == int(jn) > 0
    _assert_keys_equal(tk, jk)
    _assert_results_close(tr, jr, int(jn))


# -- the exec ---------------------------------------------------------------

def _agg_plans(seed, n_batches, rows, dom, group=True):
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_batches):
        batches.append({
            "k": rng.integers(0, dom, rows).astype(np.int64),
            "q": rng.integers(-50, 50, rows).astype(np.int32),
            "p": rng.random(rows) * 1000.0,
        })

    def plan(t, Batch, Column, basic, agg, aggexprs, core, device):
        schema = t.Schema((t.StructField("k", t.LONG),
                           t.StructField("q", t.INT),
                           t.StructField("p", t.DOUBLE)))
        kw = {"device": device} if device else {}
        bs = [Batch([Column.from_numpy(d[f.name], f.data_type,
                                       validity=np.arange(rows) % 29 != 3,
                                       **kw)
                     for f in schema.fields], rows, schema) for d in batches]
        col, lit = core.col, core.lit
        filt = basic.FilterExec(col("q") > lit(-40),
                                basic.InMemoryScanExec(bs, schema, **kw))
        return agg.AggregateExec(
            [col("k")] if group else [],
            [(aggexprs.Sum(col("p")), "sp"), (aggexprs.Count(), "c"),
             (aggexprs.Min(col("q")), "mn"), (aggexprs.Max(col("p")), "mx")],
            filt)

    return (plan(jt, JBatch, JColumn, jbasic, jagg, jaggexprs, jcore, None),
            plan(tt, TBatch, TColumn, tbasic, tagg, taggexprs, tcore, "cpu"))


def _assert_rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=RTOL, abs=0)
            else:
                assert a == b


@pytest.mark.parametrize("n_batches,dom", [(1, 6), (3, 3000), (10, 40)])
def test_exact_tier_matches_jax(n_batches, dom):
    jplan, tplan = _agg_plans(n_batches, n_batches, 1500, dom)
    want = [r for b in jplan.execute() for r in b.to_pylist()]
    got = [r for b in tplan.execute() for r in b.to_pylist()]
    assert len(want) > 1
    _assert_rows_close(got, want)


def test_exact_tier_grand_aggregate_and_empty_input_match_jax():
    jplan, tplan = _agg_plans(5, 2, 700, 10, group=False)
    _assert_rows_close([r for b in tplan.execute() for r in b.to_pylist()],
                       [r for b in jplan.execute() for r in b.to_pylist()])
    jplan, tplan = _agg_plans(6, 0, 700, 10, group=False)
    want = [r for b in jplan.execute() for r in b.to_pylist()]
    got = [r for b in tplan.execute() for r in b.to_pylist()]
    assert got == want == [(None, 0, None, None)]
    jplan, tplan = _agg_plans(6, 0, 700, 10)
    assert [b for b in tplan.execute()] == []


def test_spec_disabled_pins_the_exact_tier_inside_a_scope():
    jplan, tplan = _agg_plans(7, 2, 1200, 2500)
    jplan._spec_enabled = tplan._spec_enabled = False
    with jspec.speculation_scope() as js, tspec.speculation_scope() as ts:
        want = [r for b in jplan.execute() for r in b.to_pylist()]
        got = [r for b in tplan.execute() for r in b.to_pylist()]
        assert not ts.tripped() and not js.tripped()
    _assert_rows_close(got, want)


def test_q1_high_cardinality_collect_reruns_exactly():
    """Group by a 5000-value key: the masked buckets overflow, the scope
    trips, and collect() re-runs the plan on the exact tier."""
    jplan, tplan = _agg_plans(8, 2, 4000, 5000)
    with tspec.speculation_scope() as scope:
        list(tplan.execute())
        assert scope.tripped()
    got = tplan.collect()
    want = jplan.collect()
    assert len(want) > 3000
    _assert_rows_close(got, want)
