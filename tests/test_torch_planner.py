"""The planner: both packages' TpuOverrides over the same DataFrame queries
(chip_smoke's q1_df, q3_df, q19_df and tpch_q1_df, built once per
package over batches made from the same numpy data), held class by class.

Per query: the converted exec trees (`wrap_and_tag(plan).convert()`: the
JAX package's stage compiler runs after conversion and is left out) have
the same classes, with the same aggregate modes, join build sides and
exchange partitionings; `estimate_plan_size` gives the same bytes for
every join side; `extract_pushable_filters` gives the same conjuncts.
Cases: the default confs (the order side of q3 broadcast), broadcasting
off, a host shuffle of 4 partitions, and a join side of unknown size.
Nodes the port has not ported raise PlanNotSupported naming their
ROADMAP item; conversion is deterministic, so exact equality is the
tolerance throughout.
"""

from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as cs
from spark_rapids_tpu import config as jconfig
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred
from spark_rapids_tpu.plan import logical as jL
from spark_rapids_tpu.plan import overrides as jover

from spark_rapids_tpu_torch import config as tconfig
from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import functions as tF
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import predicates as tpred
from spark_rapids_tpu_torch.plan import logical as tL
from spark_rapids_tpu_torch.plan import overrides as tover

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases

JAX = SimpleNamespace(core=jcore, pred=jpred, F=jF, session=jsession,
                      overrides=jover, L=jL, t=jt)
TORCH = SimpleNamespace(core=tcore, pred=tpred, F=tF, session=tsession,
                        overrides=tover, L=tL, t=tt)
N_Q1 = 2048
N_ORDERS = 512
N_LINES = 2048
N_PART = 1 << 9
N_Q19_LINES = 1 << 11


@contextmanager
def active_confs():
    """Both packages' active confs of this thread put back on exit: a
    session makes its conf active, and later tests read the defaults."""
    saved = [getattr(c._active, "conf", None) for c in (jconfig, tconfig)]
    try:
        yield
    finally:
        for c, conf in zip((jconfig, tconfig), saved):
            if conf is None:
                c._active.__dict__.pop("conf", None)
            else:
                c._active.conf = conf


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs():
        yield


def sessions(conf=None):
    """(JAX session, port session on the CPU) over the same conf."""
    return (jsession.TpuSession(dict(conf or {})),
            tsession.TpuSession(dict(conf or {}), device="cpu"))


def split_batches(columns, n, parts):
    """Both packages' batches of `columns` ({name: (array, type name)}) as
    `parts` batches of equal size: ([JAX batches], [port batches])."""
    step = n // parts
    out = ([], [])
    for i in range(0, n, step):
        pair = both_batch({k: (v[i: i + step], ty, None)
                           for k, (v, ty) in columns.items()}, step)
        out[0].append(pair[0])
        out[1].append(pair[1])
    return out


def q1_columns(seed=0):
    rng = np.random.default_rng(seed)
    return {"returnflag": (rng.integers(0, 4, N_Q1).astype(np.int32), "INT"),
            "quantity": (rng.integers(1, 51, N_Q1).astype(np.int64), "LONG"),
            "extendedprice": (rng.random(N_Q1) * 1000.0, "DOUBLE"),
            "discount": (rng.random(N_Q1) * 0.1, "DOUBLE")}


def q3_columns(key_dtype=np.int64, seed=1):
    """bench.build_q3_data's columns at N_ORDERS x N_LINES: (orders,
    lineitems) as {name: (array, type name)}."""
    rng = np.random.default_rng(seed)
    ty = "LONG" if key_dtype == np.int64 else "INT"
    orders = {"o_orderkey": (np.arange(N_ORDERS, dtype=key_dtype), ty),
              "o_flag": (rng.integers(0, 10, N_ORDERS, dtype=np.int32),
                         "INT")}
    lines = {"l_orderkey": (rng.integers(0, N_ORDERS, N_LINES)
                            .astype(key_dtype), ty),
             "l_price": (rng.random(N_LINES) * 1000.0, "DOUBLE"),
             "l_disc": (rng.random(N_LINES) * 0.1, "DOUBLE"),
             "l_flag": (rng.integers(0, 4, N_LINES, dtype=np.int32), "INT")}
    return orders, lines


def q3_oracle(key_dtype=np.int64):
    orders, lines = q3_columns(key_dtype)
    d = {k: v for k, (v, _) in {**orders, **lines}.items()}
    return cs.q3_oracle(d)


def q19_batches():
    """((JAX lineitem, JAX part), (port lineitem, port part)) of
    chip_smoke.q19_data at N_PART x N_Q19_LINES, and the data."""
    d = cs.q19_data(N_PART, N_Q19_LINES)
    out = []
    for fields in (cs.Q19_LINE_FIELDS, cs.Q19_PART_FIELDS):
        cols = {name: (d[name], ty, None) for name, ty in fields}
        out.append(both_batch(cols, len(d[fields[0][0]])))
    (jl, tl), (jp, tp) = out
    return (jl, jp), (tl, tp), d


def cutoff(m):
    """TPC-H Q1's ship-date cutoff as a DATE literal of days (the JAX
    package cannot evaluate a datetime.date literal, ROADMAP C.5)."""
    days = (cs.Q1_SHIP_CUTOFF - cs.datetime.date(1970, 1, 1)).days
    return m.core.Literal(days, m.t.DATE)


def queries(conf=None, q1_parts=2):
    """{label: (JAX DataFrame, port DataFrame)} of the phase 3c queries
    over the same data, both sessions on `conf`."""
    js, ts = sessions(conf)
    q1_j, q1_t = split_batches(q1_columns(), N_Q1, q1_parts)
    out = {"q1": (cs.q1_df(JAX, js, q1_j), cs.q1_df(TORCH, ts, q1_t))}
    for label, dtype in (("q3", np.int64), ("q3 INT keys", np.int32)):
        orders, lines = q3_columns(dtype)
        (oj, ot), (lj, lt) = (split_batches(orders, N_ORDERS, 1),
                              split_batches(lines, N_LINES, 2))
        out[label] = (cs.q3_df(JAX, js, oj, lj), cs.q3_df(TORCH, ts, ot, lt))
    (jl, jp), (tl, tp), d = q19_batches()
    out["q19"] = (cs.q19_df(JAX, js, jl, jp), cs.q19_df(TORCH, ts, tl, tp))
    jb, tb = both_batch({name: (d[name], ty, None)
                         for name, ty in cs.Q1_LINE_FIELDS}, N_Q19_LINES)
    out["P6"] = (cs.tpch_q1_df(JAX, js, jb, cutoff(JAX)),
                 cs.tpch_q1_df(TORCH, ts, tb, cutoff(TORCH)))
    return out


def converted(m, df):
    """df's exec tree, built under its session's conf as collect() does."""
    m.session.set_active_conf(df.session.conf)
    return m.overrides.TpuOverrides(df.session.conf).wrap_and_tag(
        df.logical_plan()).convert()


def tree(node):
    """An exec tree as nested (class, attributes, children): the
    attributes that tell two trees of the same classes apart."""
    attrs = tuple((a, getattr(node, a)) for a in
                  ("mode", "build_side", "join_type", "n_partitions",
                   "partitioning", "limit", "offset")
                  if hasattr(node, a))
    return (type(node).__name__, attrs,
            tuple(tree(c) for c in node.children))


def joins(plan):
    out = [plan] if type(plan).__name__ == "LogicalJoin" else []
    for c in plan.children:
        out.extend(joins(c))
    return out


def filters_over_scans(plan):
    out = []
    if type(plan).__name__ == "LogicalFilter" \
            and type(plan.children[0]).__name__ == "LogicalScan":
        out.append(plan)
    for c in plan.children:
        out.extend(filters_over_scans(c))
    return out


CONFS = {
    "default": {},
    "no broadcast": {"spark.rapids.sql.broadcastSizeThreshold": "-1"},
    "4 partitions": {"spark.rapids.sql.shuffle.partitions": "4"},
    "4 partitions, no broadcast": {
        "spark.rapids.sql.shuffle.partitions": "4",
        "spark.rapids.sql.broadcastSizeThreshold": "-1"},
}
LABELS = ("q1", "q3", "q3 INT keys", "q19", "P6")


@pytest.fixture(scope="module")
def planned():
    return {name: queries(conf) for name, conf in CONFS.items()}


@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("conf", list(CONFS))
def test_converted_trees_match_jax(planned, conf, label):
    jdf, tdf = planned[conf][label]
    got = tree(converted(TORCH, tdf))
    assert got == tree(converted(JAX, jdf))
    if conf.startswith("4 partitions") and label == "P6":
        # an unlimited sort over 4 partitions is a range-partitioned sort
        # in both packages
        assert "PartitionWiseSortExec" in repr(got)


def test_the_strategies_the_cases_reach(planned):
    """The cases cover a broadcast, a plain hash join, the host-shuffled
    join and the shuffled aggregate, and Q19's part side broadcast."""
    def classes(conf, label):
        return repr(tree(converted(TORCH, planned[conf][label][1])))
    assert "BroadcastExchangeExec" in classes("default", "q3")
    assert "BroadcastExchangeExec" in classes("default", "q19")
    no_bcast = classes("no broadcast", "q3")
    assert "BroadcastExchangeExec" not in no_bcast \
        and "HashJoinExec" in no_bcast
    shuffled = classes("4 partitions, no broadcast", "q3")
    assert "ShuffledHashJoinExec" in shuffled
    assert "('mode', 'partial')" in shuffled
    assert "('mode', 'final')" in classes("4 partitions", "q1")
    assert classes("default", "q1").count("CoalesceBatchesExec") == 1


@pytest.mark.parametrize("label", ("q3", "q3 INT keys", "q19"))
def test_estimated_join_side_sizes_match_jax(planned, label):
    jdf, tdf = planned["default"][label]
    jsides = [c for j in joins(jdf.logical_plan()) for c in j.children]
    tsides = [c for j in joins(tdf.logical_plan()) for c in j.children]
    jsizes = [jover.estimate_plan_size(c) for c in jsides]
    tsizes = [tover.estimate_plan_size(c) for c in tsides]
    assert tsizes == jsizes and all(s > 0 for s in tsizes)


@pytest.mark.parametrize("threshold", [None, "100"])
def test_unknown_join_side_size_matches_jax(threshold):
    """A keyed aggregate's size is unknown. Under the default threshold
    the known side is broadcast, the build on the left, in both packages;
    under a threshold of 100 bytes the JAX package plans its adaptive
    join, which the port tags off naming ROADMAP A.3."""
    js, ts = sessions({} if threshold is None else {
        "spark.rapids.sql.broadcastSizeThreshold": threshold})
    sides = []
    for m, sess in ((JAX, js), (TORCH, ts)):
        (oj, ot), (lj, lt) = [split_batches(c, n, 1) for c, n in
                              zip(q3_columns(), (N_ORDERS, N_LINES))]
        o, lines = (oj, lj) if m is JAX else (ot, lt)
        per_order = sess.from_batches(lines, lines[0].schema) \
            .group_by("l_orderkey").agg((m.F.count(), "n"))
        sides.append(sess.from_batches(o, o[0].schema).join(
            per_order, left_on="o_orderkey", right_on="l_orderkey"))
    jdf, tdf = sides
    if threshold is None:
        assert tree(converted(TORCH, tdf)) == tree(converted(JAX, jdf))
        assert converted(TORCH, tdf).build_side == "left"
        orders, lines = q3_columns()
        keys, counts = np.unique(lines["l_orderkey"][0], return_counts=True)
        flag = orders["o_flag"][0]
        assert sorted(tdf.collect()) == [
            (int(k), int(flag[k]), int(k), int(c))
            for k, c in zip(keys, counts)]
        return
    assert "AdaptiveJoinExec" in repr(tree(converted(JAX, jdf)))
    with pytest.raises(tover.PlanNotSupported, match="AdaptiveJoinExec"):
        tdf.collect()
    assert "ROADMAP A.3" in tdf.explain()


@pytest.mark.parametrize("label", LABELS)
def test_pushable_filters_match_jax(planned, label):
    jdf, tdf = planned["default"][label]
    jf = [jover.extract_pushable_filters(f.condition, f.children[0].schema)
          for f in filters_over_scans(jdf.logical_plan())]
    tf = [tover.extract_pushable_filters(f.condition, f.children[0].schema)
          for f in filters_over_scans(tdf.logical_plan())]
    assert tf == jf and len(tf) >= 1


def test_pushable_filters_of_mixed_conjuncts_match_jax():
    out = []
    for m, t in ((JAX, jt), (TORCH, tt)):
        col, lit, pr = m.core.col, m.core.lit, m.pred
        schema = t.Schema((t.StructField("a", t.INT),
                           t.StructField("b", t.DOUBLE),
                           t.StructField("s", t.STRING)))
        cond = pr.And(pr.And(pr.LessThan(lit(3), col("a")),
                             pr.IsNotNull(col("b"))),
                      pr.And(pr.Or(pr.EqualTo(col("a"), lit(1)),
                                   pr.IsNull(col("s"))),
                             pr.And(pr.GreaterThanOrEqual(col("b"),
                                                          lit(2.5)),
                                    pr.EqualTo(col("s"), lit("x")))))
        out.append(m.overrides.extract_pushable_filters(cond, schema))
    assert out[1] == out[0] == [("a", ">", 3), ("b", "is_not_null", None),
                                ("b", ">=", 2.5), ("s", "==", "x")]


def _port_df():
    _, ts = sessions()
    _, (tb,) = split_batches({"k": (np.arange(8, dtype=np.int64), "LONG"),
                              "v": (np.ones(8), "DOUBLE")}, 8, 1)
    return ts, ts.from_batches([tb], tb.schema)


@pytest.mark.parametrize("case", ["sample", "range-partitioned sort",
                                  "adaptive join", "first", "windows"])
def test_unported_nodes_raise_naming_their_item(case):
    """Nodes the port has not ported raise naming their ROADMAP item: at
    planning (PlanNotSupported with the explain report), or at the
    DataFrame method that would build a node the port lacks. The sample
    and the range-partitioned sort were such nodes until A.8 wave 1
    ported them: they now plan and run."""
    ts, df = _port_df()
    if case == "windows":
        with pytest.raises(NotImplementedError, match="ROADMAP A.8 wave 3"):
            df.with_windows()
        return
    if case == "sample":
        rows = df.sample(0.5, seed=3).collect()
        assert set(rows) <= set(df.collect())
        assert rows == df.sample(0.5, seed=3).collect()
        return
    if case == "range-partitioned sort":
        sess = tsession.TpuSession({"spark.rapids.sql.shuffle.partitions":
                                    "4"}, device="cpu")
        df = tsession.DataFrame(df.sort("k").logical_plan(), sess)
        assert "PartitionWiseSortExec" in repr(tree(converted(TORCH, df)))
        assert df.collect() == sorted(df.collect())
        return
    if case == "adaptive join":
        sess = tsession.TpuSession(
            {"spark.rapids.sql.broadcastSizeThreshold": "100"}, device="cpu")
        side = tsession.DataFrame(df.group_by("k").agg(
            (tF.count(), "n")).logical_plan(), sess)
        df = tsession.DataFrame(df.logical_plan(), sess).join(
            side.select(tcore.col("k").alias("k2"), tcore.col("n")),
            left_on="k", right_on="k2", how="left_outer")
        item = "A.3"
    else:
        # the JAX package's first(): an aggregate function the port's
        # rule table lacks
        from spark_rapids_tpu_torch.expr.aggexprs import Min

        class FirstValue(Min):
            name = "first"
        df = df.group_by("k").agg((FirstValue(tcore.col("v")), "f"))
        item = "A.2"
    with pytest.raises(tover.PlanNotSupported) as e:
        df.collect()
    assert f"ROADMAP {item}" in str(e.value)
    assert e.value.report == df.explain()


def _ported_node_frames(m, sess, batches):
    """The five nodes of the earlier tag-offs as queries of one package:
    a union, a left outer join, a range, a limit with an offset and a
    keyless (nested-loop) join with a condition."""
    col, lit = m.core.col, m.core.lit
    df = sess.from_batches(batches, batches[0].schema)
    other = df.select(col("k").alias("k2"), (col("v") * lit(2.0))
                      .alias("w")).filter(col("k2") > lit(2))
    return {
        "union": df.union(df.filter(col("k") < lit(4))),
        "left join": df.join(other, left_on="k", right_on="k2",
                             how="left_outer"),
        "range": sess.range(3, 40, 4),
        "limit": df.limit(3, offset=2),
        "keyless join": df.join(other.filter(col("k2") < lit(5)),
                                condition=col("k") < col("k2")),
    }


@pytest.mark.parametrize("conf", ["default", "no broadcast"])
@pytest.mark.parametrize("case", ["union", "left join", "range", "limit",
                                  "keyless join"])
def test_ported_nodes_plan_and_match_jax(case, conf):
    js, ts = sessions(CONFS[conf])
    jb, tb = split_batches({"k": (np.arange(8, dtype=np.int64), "LONG"),
                            "v": (np.arange(8) * 0.5, "DOUBLE")}, 8, 2)
    jdf = _ported_node_frames(JAX, js, jb)[case]
    tdf = _ported_node_frames(TORCH, ts, tb)[case]
    assert tree(converted(TORCH, tdf)) == tree(converted(JAX, jdf))
    assert tdf.collect() == jdf.collect()
    assert tdf.explain().startswith("*")


def test_disabled_operator_and_sql_off_tag_off():
    ts, df = _port_df()
    for conf in ({"spark.rapids.sql.exec.Filter": "false"},
                 {"spark.rapids.sql.enabled": "false"}):
        sess = tsession.TpuSession(conf, device="cpu")
        q = tsession.DataFrame(df.filter(tcore.col("k") > tcore.lit(2))
                               .logical_plan(), sess)
        with pytest.raises(tover.PlanNotSupported):
            q.collect()
    ok = df.filter(tcore.col("k") > tcore.lit(2))
    assert [r[0] for r in ok.collect()] == [3, 4, 5, 6, 7]
