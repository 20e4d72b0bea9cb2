"""The q1 slice end to end: bench.py's scan -> filter -> project ->
aggregate tree built in both packages at 16K rows, run under a speculation
scope, against each other and against bench.numpy_oracle.

Groups must come out in the same order with exact integers; f64 sums
agree to rtol 1e-12 (summation order). The JAX exec path needs the jax
0.9 aliases of test_torch_jax_ref.jax_aliases, installed for this module
only.
"""

import numpy as np
import pytest

import bench
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.exec import aggregate as jagg
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import speculation as jspec
from spark_rapids_tpu.expr import aggexprs as jaggexprs
from spark_rapids_tpu.expr import core as jcore

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.exec import aggregate as tagg
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import speculation as tspec
from spark_rapids_tpu_torch.expr import aggexprs as taggexprs
from spark_rapids_tpu_torch.expr import core as tcore

from test_torch_jax_ref import jax_aliases

ROWS = 1 << 14


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return {  # bench.build_data at ROWS rows
        "returnflag": rng.integers(0, 4, ROWS, dtype=np.int32),
        "quantity": rng.integers(1, 51, ROWS, dtype=np.int64),
        "extendedprice": rng.random(ROWS) * 1000.0,
        "discount": rng.random(ROWS) * 0.1,
    }


def _schema(t):
    return t.Schema((t.StructField("returnflag", t.INT),
                     t.StructField("quantity", t.LONG),
                     t.StructField("extendedprice", t.DOUBLE),
                     t.StructField("discount", t.DOUBLE)))


def _q1_plan(basic, agg, aggexprs, core, batch, schema):
    """bench.py make_plan, in either package."""
    col, lit = core.col, core.lit
    scan = basic.InMemoryScanExec([batch], schema)
    filt = basic.FilterExec(col("quantity") <= lit(45), scan)
    proj = basic.ProjectExec([
        col("returnflag"), col("quantity"),
        (col("extendedprice") * (lit(1.0) - col("discount")))
        .alias("disc_price")], filt)
    return agg.AggregateExec(
        [col("returnflag")],
        [(aggexprs.Sum(col("quantity")), "sum_qty"),
         (aggexprs.Sum(col("disc_price")), "sum_disc"),
         (aggexprs.Count(), "cnt")], proj)


def _batches(data):
    jschema, tschema = _schema(jt), _schema(tt)
    jcols = [JColumn.from_numpy(data[f.name], f.data_type)
             for f in jschema.fields]
    jb = JBatch(jcols, ROWS, jschema)
    tb = TBatch.from_numpy_columns(
        [(np.asarray(c.data), np.asarray(c.validity)) for c in jcols],
        tschema, ROWS, device="cpu")
    return jb, jschema, tb, tschema


def _run_jax(plan):
    with jspec.speculation_scope() as scope:
        out = [b.to_pylist() for b in plan.execute()]
        assert not scope.tripped()
    return [r for rows in out for r in rows]


def _run_torch(plan):
    with tspec.speculation_scope() as scope:
        out = [b.to_pylist() for b in plan.execute()]
        assert not scope.tripped()
    return [r for rows in out for r in rows]


def _assert_rows_close(got, want):
    assert [r[0] for r in got] == [r[0] for r in want]  # same group order
    for g, w in zip(got, want):
        assert g[1] == w[1] and g[3] == w[3]
        assert g[2] == pytest.approx(w[2], rel=1e-12, abs=0)


def test_q1_slice_matches_jax_and_oracle(data):
    jb, jschema, tb, tschema = _batches(data)
    jplan = _q1_plan(jbasic, jagg, jaggexprs, jcore, jb, jschema)
    tplan = _q1_plan(tbasic, tagg, taggexprs, tcore, tb, tschema)
    assert jplan._pallas_agg_spec is not None
    assert tplan._scan_agg_spec is not None
    jrows, trows = _run_jax(jplan), _run_torch(tplan)
    _assert_rows_close(trows, jrows)
    oracle = bench.numpy_oracle(data)
    assert sorted(r[0] for r in trows) == sorted(oracle)
    for k, qty, dp, cnt in trows:
        assert (qty, cnt) == (oracle[k][0], oracle[k][2])
        assert dp == pytest.approx(oracle[k][1], rel=1e-12, abs=0)


def test_q1_slice_collect_and_metrics(data):
    _, _, tb, tschema = _batches(data)
    plan = _q1_plan(tbasic, tagg, taggexprs, tcore, tb, tschema)
    rows = plan.collect()
    assert len(rows) == 4
    assert plan.metrics["numOutputRows"].value == 4
    assert plan.metrics["computeAggTime"].value > 0
    assert [type(p).__name__ for p in (plan, plan._source)] == \
        ["AggregateExec", "InMemoryScanExec"]
    assert [s[0] for s in plan._fused_steps] == ["filter", "project"]


def test_q1_outside_speculation_scope_raises(data):
    """Outside a speculation scope q1 no longer raises: it runs the exact
    tier, in the same group order as the JAX package's exact tier."""
    jb, jschema, tb, tschema = _batches(data)
    jplan = _q1_plan(jbasic, jagg, jaggexprs, jcore, jb, jschema)
    tplan = _q1_plan(tbasic, tagg, taggexprs, tcore, tb, tschema)
    jrows = [r for b in jplan.execute() for r in b.to_pylist()]
    trows = [r for b in tplan.execute() for r in b.to_pylist()]
    _assert_rows_close(trows, jrows)


def test_ineligible_chain_takes_masked_groupby_like_jax(data):
    """A BOOLEAN group key is outside the kernel's whitelist: both
    packages take the masked_groupby path, with the same answers."""
    jb, jschema, tb, tschema = _batches(data)

    def plan(basic, agg, aggexprs, core, b, schema, t):
        col, lit = core.col, core.lit
        scan = basic.InMemoryScanExec([b], schema)
        filt = basic.FilterExec(col("discount") < lit(0.05), scan)
        return agg.AggregateExec(
            [core.Alias(col("quantity") > lit(25), "big")],
            [(aggexprs.Max(col("extendedprice")), "mx"),
             (aggexprs.Min(col("returnflag")), "mn"),
             (aggexprs.Count(col("discount")), "cnt")], filt)

    jplan = plan(jbasic, jagg, jaggexprs, jcore, jb, jschema, jt)
    tplan = plan(tbasic, tagg, taggexprs, tcore, tb, tschema, tt)
    assert jplan._pallas_agg_spec is None and tplan._scan_agg_spec is None
    jrows, trows = _run_jax(jplan), _run_torch(tplan)
    assert trows == jrows


def test_standalone_filter_and_project_match_jax(data):
    jb, jschema, tb, tschema = _batches(data)

    def plan(basic, core, b, schema):
        col, lit = core.col, core.lit
        scan = basic.InMemoryScanExec([b], schema)
        filt = basic.FilterExec(
            (col("quantity") > lit(40)) & (col("discount") < lit(0.02)),
            scan)
        return basic.ProjectExec(
            [col("returnflag"),
             (col("extendedprice") / col("quantity")).alias("unit")], filt)

    jout = list(plan(jbasic, jcore, jb, jschema).execute())[0]
    tout = list(plan(tbasic, tcore, tb, tschema).execute())[0]
    assert tout.num_rows_host == jout.num_rows_host > 0
    assert tout.to_pylist() == jout.to_pylist()
