"""The array lambdas (ops/array_hof.py, expr/collectionexprs.py's
ArrayTransform, ArrayFilter, ArrayExists, ArrayForAll) against the JAX
package on the CPU, in one projection a package: LONG, DOUBLE and STRING
elements, null arrays, null elements, empty arrays, Spark's three-valued
exists/forall. The host-tier shapes (aggregate, a body that reads an outer
column, nested arrays) run on the host row engine in both packages.
GetArrayItem with a column index
(ROADMAP C.12) gives Spark's rows on a hand-built and a planned plan,
held to Python (the JAX package gives NULL there, C.5). Then P30's
lambdas at a small size against chip_smoke's oracle. Everything exact."""

import pytest

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.exec import basic as jb
from spark_rapids_tpu.expr import collectionexprs as jce
from spark_rapids_tpu.expr import core as jc
from spark_rapids_tpu.plan.overrides import TpuOverrides as JOverrides

from spark_rapids_tpu_torch import functions as tF
from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.exec import basic as tb
from spark_rapids_tpu_torch.expr import collectionexprs as tce
from spark_rapids_tpu_torch.expr import core as tc

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs
from test_torch_structs import both

AL, AD, AS = (tt.ArrayType(tt.LONG), tt.ArrayType(tt.DOUBLE),
              tt.ArrayType(tt.STRING))
LONGS = [[3, 1, None, 2], [], None, [50, 60], [None], [-1, 0, 26, 25]]
DOUBLES = [[1.5, 30.0], None, [], [49.5, None, 2.0], [0.5], [26.0, -3.0]]
STRS = [["a", "bb"], None, [], ["a", None, ""], ["cc"], ["bb", "a"]]
GET_ITEM = ([[3, 1, None, 2, 2], [], None, [5], [None, None],
             [-9, 2 ** 62, -2 ** 62]], [1, 0, -1, 7, -3, 2],
            [1, None, None, None, None, -2 ** 62])


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


def _exprs(ce, c):
    lit, col = c.lit, c.col
    LV = ce.LambdaVar
    x = LV("x")
    return [
        ce.ArrayTransform(col("l"), x * lit(2) + lit(1), "x").alias("t"),
        ce.ArrayTransform(col("d"), x * lit(0.5), "x").alias("td"),
        ce.ArrayFilter(col("l"), x > lit(1), "x").alias("f"),
        ce.ArrayFilter(col("d"), x >= lit(2.0), "x").alias("fd"),
        ce.ArrayFilter(col("s"), x == lit("a"), "x").alias("fs"),
        ce.ArrayExists(col("l"), x > lit(25), "x").alias("e"),
        ce.ArrayExists(col("d"), x > lit(49.0), "x").alias("ed"),
        ce.ArrayForAll(col("l"), x >= lit(0), "x").alias("fa"),
        ce.ArrayForAll(col("d"), x < lit(40.0), "x").alias("fad"),
        ce.Size(ce.ArrayFilter(col("l"), x > lit(1), "x")).alias("nf")]


def test_lambdas_match_jax():
    jbatch, tbatch = both({"k": list(range(6)), "l": LONGS, "d": DOUBLES,
                           "s": STRS},
                          {"k": tt.LONG, "l": AL, "d": AD, "s": AS})
    jp = jb.ProjectExec(_exprs(jce, jc),
                        jb.InMemoryScanExec([jbatch], jbatch.schema))
    tp = tb.ProjectExec(_exprs(tce, tc),
                        tb.InMemoryScanExec([tbatch], tbatch.schema))
    assert all(e.children[0].device_supported for e in tp._bound[:-1])
    jrows = [r for x in jp.execute() for r in x.to_pylist()]
    trows = [r for x in tp.execute() for r in x.to_pylist()]
    assert trows == jrows
    assert [r[5] for r in trows] == [None, False, None, True, None, True]


def test_lambdas_through_the_session_match_jax():
    data = {"l": LONGS}
    tdf = tsession.TpuSession(device="cpu").from_pydict(
        data, tt.Schema((tt.StructField("l", AL),)))
    jdf = jsession.TpuSession().from_pydict(
        data, jt.Schema((jt.StructField("l", jt.ArrayType(jt.LONG)),)))
    rows = [df.select(F.transform("l", lambda x: x + 1).alias("t"),
                      F.filter_("l", lambda x: x > 0).alias("f"),
                      F.exists("l", lambda x: x < 0).alias("e"),
                      F.forall("l", lambda x: x < 100).alias("a"))
            .collect() for F, df in ((tF, tdf), (jF, jdf))]
    assert rows[0] == rows[1]
    assert tdf.select(tF.transform("l", lambda x: x + 1)).explain() \
        .startswith("*")


def test_host_tier_lambdas_tag_off_naming_wave_4():
    """aggregate(), a body over an outer column and a lambda over nested
    arrays have no device path: both packages plan them on the host row
    engine (`~`). The first two give the JAX package's rows; the third
    raises in the JAX package's host tier (ROADMAP C.5), so the port is
    held to Python's rows there."""
    data = {"k": [1, 2], "l": [[1, 2], None], "n": [[[1], [2, 3]], None]}
    tdf = tsession.TpuSession(device="cpu").from_pydict(
        data, tt.Schema((tt.StructField("k", tt.LONG),
                         tt.StructField("l", AL),
                         tt.StructField("n", tt.ArrayType(AL)))))
    jdf = jsession.TpuSession().from_pydict(
        data, jt.Schema((jt.StructField("k", jt.LONG),
                         jt.StructField("l", jt.ArrayType(jt.LONG)),
                         jt.StructField("n", jt.ArrayType(
                             jt.ArrayType(jt.LONG))))))
    cases = [
        lambda F, c: F.aggregate("l", c.lit(0), lambda acc, x: acc + x),
        lambda F, c: F.transform("l", lambda x: x + c.col("k")),
        lambda F, c: F.transform("n", lambda x: F.size(x))]
    for k, make in enumerate(cases):
        tq = tdf.select(make(tF, tc).alias("r"))
        assert tq.explain().startswith("~ ")
        jq = jdf.select(make(jF, jc).alias("r"))
        assert JOverrides._all_ok(JOverrides(jdf.session.conf).wrap_and_tag(
            jq.logical_plan()))
        if k < 2:
            assert tq.collect() == jq.collect()
        else:
            assert tq.collect() == [([1, 2],), (None,)]


def test_get_array_item_with_a_column_index_gives_spark_rows():
    """ROADMAP C.12: a column index is 0-based, NULL for a negative or
    out-of-bounds index and for a null array or index, on a hand-built
    ProjectExec and through the planner (whose tag-off is lifted)."""
    arrays, index, want = GET_ITEM
    _, tbatch = both({"a": arrays, "i": index}, {"a": AL, "i": tt.INT})
    tp = tb.ProjectExec([tce.GetArrayItem(tc.col("a"), tc.col("i"))
                         .alias("g")],
                        tb.InMemoryScanExec([tbatch], tbatch.schema))
    assert [r[0] for x in tp.execute() for r in x.to_pylist()] == want
    df = tsession.TpuSession(device="cpu").from_batches([tbatch],
                                                        tbatch.schema)
    q = df.select(tF.get_array_item("a", tc.col("i")).alias("g"),
                  tF.get_array_item("a", 0).alias("g0"))
    assert q.explain().startswith("*")
    rows = q.collect()
    assert [r[0] for r in rows] == want
    assert [r[1] for r in rows] == [3, None, None, 5, None, -9]


def test_p30_lambdas_plan_and_match_the_oracle():
    import chip_smoke as cs
    dj = cs.tpch_join_data(sf=0.002)
    q3d = cs.q3_types_data(dj)
    d19 = cs.q19_data(n_part=2048, n_line=16384)
    m, b, checks = cs.nested_inputs("cpu", dj, q3d, d19)
    dfs = cs.nested_dfs(m, "cpu", b)
    out = list(cs.planned(m, dfs["P30 lambdas"])[0].execute())
    checks["P30 lambdas"](out, "P30 lambdas")
