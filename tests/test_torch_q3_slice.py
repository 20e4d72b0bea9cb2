"""The q3 slice end to end: bench.py's plan (two filtered scans -> inner
HashJoinExec with the build side on the right -> ProjectExec(rev) ->
exact-tier AggregateExec by l_orderkey -> TopNExec(10)) built in both
packages at 4K orders and 16K lineitems, against each other and against
bench.q3_oracle.

Keys and row order are exact; revenue agrees to rtol 1e-9 (summation
order). Also: a stale speculative candidate size trips the join's flag
and collect() re-runs the plan exactly; the INT-key variant; SortExec and
TopNExec (limit, offset, descending, nulls) row for row; and no kernel
launches on CPU tensors.
"""

import numpy as np
import pytest

import bench
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.exec import aggregate as jagg
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import joins as jjoins
from spark_rapids_tpu.exec import sort as jsortexec
from spark_rapids_tpu.exec import speculation as jspec
from spark_rapids_tpu.expr import aggexprs as jaggexprs
from spark_rapids_tpu.expr import core as jcore

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.columnar.column import Column as TColumn
from spark_rapids_tpu_torch.exec import aggregate as tagg
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import joins as tjoins
from spark_rapids_tpu_torch.exec import sort as tsortexec
from spark_rapids_tpu_torch.exec import speculation as tspec
from spark_rapids_tpu_torch.expr import aggexprs as taggexprs
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.ops import murmur3_lanes, probe_verify, row_gather

from test_torch_jax_ref import jax_aliases

N_ORDERS = 1 << 12
N_LINES = 1 << 14
RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def q3_data(key_dtype=np.int64):
    """bench.build_q3_data at N_ORDERS x N_LINES (same seed, same draws)."""
    rng = np.random.default_rng(1)
    return {
        "o_orderkey": np.arange(N_ORDERS, dtype=key_dtype),
        "o_flag": rng.integers(0, 10, N_ORDERS, dtype=np.int32),
        "l_orderkey": rng.integers(0, N_ORDERS, N_LINES,
                                   dtype=np.int64).astype(key_dtype),
        "l_price": rng.random(N_LINES) * 1000.0,
        "l_disc": rng.random(N_LINES) * 0.1,
        "l_flag": rng.integers(0, 4, N_LINES, dtype=np.int32),
    }


class _Pkg:
    def __init__(self, t, Batch, Column, basic, joins, agg, sortexec,
                 aggexprs, core, device):
        self.__dict__.update(locals())


JAX = _Pkg(jt, JBatch, JColumn, jbasic, jjoins, jagg, jsortexec, jaggexprs,
           jcore, None)
TORCH = _Pkg(tt, TBatch, TColumn, tbasic, tjoins, tagg, tsortexec,
             taggexprs, tcore, "cpu")


def q3_plan(p, d, key="LONG"):
    """bench.py make_q3_plan, as an operator tree, in either package."""
    t = p.t
    kt = getattr(t, key)
    o_schema = t.Schema((t.StructField("o_orderkey", kt),
                         t.StructField("o_flag", t.INT)))
    l_schema = t.Schema((t.StructField("l_orderkey", kt),
                         t.StructField("l_price", t.DOUBLE),
                         t.StructField("l_disc", t.DOUBLE),
                         t.StructField("l_flag", t.INT)))

    def mk(schema, n):
        kw = {"device": p.device} if p.device else {}
        cols = [p.Column.from_numpy(d[f.name], f.data_type, **kw)
                for f in schema.fields]
        return p.Batch(cols, n, schema)

    col, lit = p.core.col, p.core.lit
    o_scan = p.basic.FilterExec(col("o_flag") < lit(5),
                                p.basic.InMemoryScanExec(
                                    [mk(o_schema, N_ORDERS)], o_schema))
    l_scan = p.basic.FilterExec(col("l_flag") != lit(0),
                                p.basic.InMemoryScanExec(
                                    [mk(l_schema, N_LINES)], l_schema))
    joined = p.joins.HashJoinExec(l_scan, o_scan, [col("l_orderkey")],
                                  [col("o_orderkey")], "inner",
                                  build_side="right")
    proj = p.basic.ProjectExec([
        col("l_orderkey"),
        (col("l_price") * (lit(1.0) - col("l_disc"))).alias("rev")], joined)
    agg = p.agg.AggregateExec([col("l_orderkey")],
                              [(p.aggexprs.Sum(col("rev")), "revenue")],
                              proj)
    agg._spec_enabled = False
    return p.sortexec.TopNExec(10, [(col("revenue"), False)], agg)


def _run(plan, spec):
    with spec.speculation_scope() as scope:
        rows = [r for b in plan.execute() for r in b.to_pylist()]
        assert not scope.tripped()
    return rows


def _assert_q3(got, want_rows=None, oracle=None):
    if want_rows is not None:
        assert [r[0] for r in got] == [r[0] for r in want_rows]
        for g, w in zip(got, want_rows):
            assert g[1] == pytest.approx(w[1], rel=RTOL, abs=0)
    if oracle is not None:
        assert {r[0] for r in got} == set(oracle)
        for k, v in got:
            assert v == pytest.approx(oracle[k], rel=RTOL, abs=0)


#: the wrappers of the kernels on the q3 path
KERNELS = (murmur3_lanes.murmur3_columns, murmur3_lanes.murmur3_long_lanes,
           murmur3_lanes.murmur3_int_lanes, probe_verify.fused_probe_verify,
           row_gather.dma_row_gather)


def _zero_launches():
    for fn in KERNELS:
        fn.launches = 0


def _launches():
    return tuple(fn.launches for fn in KERNELS)


def test_q3_slice_matches_jax_and_oracle():
    d = q3_data()
    jrows = _run(q3_plan(JAX, d), jspec)
    _zero_launches()
    tplan = q3_plan(TORCH, d)
    trows = _run(tplan, tspec)
    assert _launches() == (0, 0, 0, 0, 0)   # CPU tensors: plain versions
    assert len(trows) == 10
    oracle = bench.q3_oracle(d)
    _assert_q3(trows, jrows, oracle)
    # the join absorbed both filters; the aggregate absorbed the project
    agg = tplan.child
    join = agg._source
    assert type(join).__name__ == "HashJoinExec"
    assert [type(c).__name__ for c in join.children] == \
        ["InMemoryScanExec", "InMemoryScanExec"]
    assert [s[0] for s in agg._fused_steps] == ["project"]
    # a second run with the speculative candidate size cached
    assert join._size_cache
    _assert_q3(_run(tplan, tspec), jrows, oracle)


def test_q3_slice_int_keys_match_oracle():
    d = q3_data(np.int32)
    trows = _run(q3_plan(TORCH, d, key="INT"), tspec)
    jrows = _run(q3_plan(JAX, d, key="INT"), jspec)
    _assert_q3(trows, jrows, bench.q3_oracle(d))


def test_stale_join_size_cache_trips_and_collect_reruns_exactly():
    d = q3_data()
    plan = q3_plan(TORCH, d)
    join = plan.child._source
    _run(plan, tspec)                       # measures and caches the size
    key, = join._size_cache
    join._size_cache[key] = 128             # far below the candidate total
    with tspec.speculation_scope() as scope:
        list(plan.execute())
        assert scope.tripped()
    join._size_cache[key] = 128
    rows = plan.collect()                   # trips, then re-runs exactly
    _assert_q3(rows, oracle=bench.q3_oracle(d))
    assert join._size_cache[key] > 128      # the exact run re-measured


def _sort_plans(seed, orders, limit=None, offset=0):
    rng = np.random.default_rng(seed)
    n = 3000
    data = {"a": rng.integers(-5, 5, n).astype(np.int32),
            "b": rng.normal(0, 100, n),
            "c": rng.integers(-10**12, 10**12, n).astype(np.int64)}
    data["b"][::37] = np.nan
    valid = {k: rng.random(n) > 0.1 for k in data}

    def plan(p):
        t = p.t
        schema = t.Schema((t.StructField("a", t.INT),
                           t.StructField("b", t.DOUBLE),
                           t.StructField("c", t.LONG)))
        kw = {"device": p.device} if p.device else {}
        half = n // 2
        batches = [p.Batch([p.Column.from_numpy(data[f.name][s], f.data_type,
                                                validity=valid[f.name][s],
                                                **kw)
                            for f in schema.fields], half, schema)
                   for s in (slice(0, half), slice(half, n))]
        scan = p.basic.InMemoryScanExec(batches, schema)
        os = [(p.core.col(c), asc, nf) for c, asc, nf in orders]
        if limit is None:
            return p.sortexec.SortExec(os, scan)
        return p.sortexec.TopNExec(limit, os, scan, offset=offset)

    return plan(JAX), plan(TORCH)


@pytest.mark.parametrize("orders,limit,offset", [
    ([("a", True, None), ("c", False, None)], None, 0),
    ([("b", False, True), ("a", True, False)], None, 0),
    ([("b", True, None), ("c", True, None)], 25, 0),
    ([("a", False, None), ("c", True, True)], 20, 7),
])
def test_sort_and_topn_match_jax(orders, limit, offset):
    jplan, tplan = _sort_plans(len(orders) + (limit or 0), orders, limit,
                               offset)

    def rows(plan):
        out = [r for b in plan.execute() for r in b.to_pylist()]
        return [tuple("nan" if isinstance(v, float) and v != v else v
                      for v in r) for r in out]

    want, got = rows(jplan), rows(tplan)
    assert len(want) == (3000 if limit is None else limit)
    assert got == want
