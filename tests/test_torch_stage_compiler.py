"""exec/stage_compiler.py, the port's whole-stage compiler, against the
JAX package's (tests/test_stage_compiler.py's cases, mirrored).

On the CPU a compiled stage runs its bodies eagerly (a program site calls
its body; graph capture runs only on the card, in chip_smoke.py's phase
3l). Held here:

- the planner: the same stage kinds and absorbed chains as the JAX
  package's `compile_stages` for q1, q3, the map and Expand plans and
  chip_smoke's planned queries; a bare group-by stays per-operator;
  fusion off is a no-op rewrite;
- results: fusion on equals fusion off and the JAX package's rows, for
  q1, q3 (exact and speculative tiers), Q19, the empty-input corners and
  the forced-spill recipe (keys and counts exact, f64 sums to rtol 1e-9:
  summation order);
- the plan fingerprint: equal for equal plans, different for a changed
  literal, schema, expression parameter or body-affecting conf, and
  none for a plan with a Python UDF; a second collect() builds no new
  site;
- governance: an open device_dispatch breaker demotes a stage to the
  per-operator execs (which call the kernel wrappers, never a plain
  version directly), the stage's fault point recovers through task
  retry, the stage_fused event carries the JAX package's keys, and the
  query profile shows a fused chain as one row;
- the program sites: a site on CPU tensors never captures; flatten and
  clone keep batches and build tables whole; and the bodies the card
  captures read nothing on the host (a trap on the torch calls that
  would synchronize or copy from host memory, the CPU's stand-in for a
  capture).
"""

import json
from contextlib import contextmanager

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import chip_smoke as cs
from spark_rapids_tpu.exec import stage_compiler as jstage
from spark_rapids_tpu.obs import dispatch as jdispatch
from spark_rapids_tpu.obs import events as jevents
from spark_rapids_tpu_torch import faults as tfaults
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec import lifecycle as tlifecycle
from spark_rapids_tpu_torch.exec import stage_compiler as tstage
from spark_rapids_tpu_torch.obs import dispatch as tdispatch
from spark_rapids_tpu_torch.obs import events as tevents

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import JAX, TORCH, active_confs, queries

RTOL = 1e-9
OFF = {"spark.rapids.tpu.stage.fusion.enabled": "false"}
Q3_CONF = {"spark.rapids.sql.broadcastSizeThreshold": "-1",
           "spark.rapids.tpu.agg.speculative.enabled": "false"}
SPEC_Q3_CONF = {"spark.rapids.sql.broadcastSizeThreshold": "-1"}


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


def _reset():
    for d, st, ev in ((jdispatch, jstage, jevents),
                      (tdispatch, tstage, tevents)):
        d.reset_dispatch_ledger()
        st.reset_stage_counters()
        ev.reset_event_bus()
    tdispatch.reset_site_cache()


@pytest.fixture(autouse=True)
def _fresh_planes():
    _reset()
    yield
    _reset()
    tfaults.install(None)
    tlifecycle.reset_lifecycle()


def _session(m, conf=None):
    conf = dict(conf or {})
    return m.session.TpuSession(conf, device="cpu") if m is TORCH \
        else m.session.TpuSession(conf)


def _schema(m, **fields):
    t = m.t
    return t.Schema(tuple(t.StructField(n, getattr(t, ty))
                          for n, ty in fields.items()))


def _q1(m, sess, n=3000, batch_rows=None):
    rng = np.random.default_rng(0)
    col, lit, F = m.core.col, m.core.lit, m.F
    df = sess.from_pydict({"k": rng.integers(0, 6, n).tolist(),
                           "q": rng.integers(1, 50, n).tolist(),
                           "p": (rng.random(n) * 10).tolist()},
                          _schema(m, k="INT", q="LONG", p="DOUBLE"),
                          batch_rows=batch_rows)
    return (df.filter(col("q") <= lit(40))
              .group_by("k").agg((F.sum(col("p")), "s"), (F.count(), "c")))


def _q3(m, sess, n=800):
    rng = np.random.default_rng(1)
    col, lit, F = m.core.col, m.core.lit, m.F
    orders = sess.from_pydict(
        {"o": list(range(n)), "d": rng.integers(0, 100, n).tolist()},
        _schema(m, o="LONG", d="LONG"))
    lines = sess.from_pydict(
        {"o": [int(v) for v in rng.integers(0, n, 2 * n)],
         "x": (rng.random(2 * n) * 5).tolist()},
        _schema(m, o="LONG", x="DOUBLE"))
    return (orders.filter(col("d") < lit(50))
                  .join(lines, on="o")
                  .group_by("o").agg((F.sum(col("x")), "rev")))


def _map(m, sess):
    col, lit = m.core.col, m.core.lit
    df = sess.from_pydict({"a": list(range(40)),
                           "b": [i * 3 for i in range(40)]},
                          _schema(m, a="LONG", b="LONG"), batch_rows=16)
    return (df.filter(col("a") > lit(4))
              .select(col("a"), (col("b") + col("a")).alias("c"))
              .filter(col("c") > lit(30))
              .sort(("c", False)))


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def stages(plan):
    """The plan's compiled stages in tree order: (kind, absorbed classes),
    in either package."""
    return [(n._kind, [type(o).__name__ for o in n._absorbed])
            for n in _walk(plan) if type(n).__name__ == "CompiledStageExec"]


def assert_rows_close(got, want):
    got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert a == pytest.approx(b, rel=RTOL, abs=0)
            else:
                assert a == b


def _stage_row(sess):
    rows = [r for r in sess.last_query_profile().dispatch_summary()["stages"]
            if r["op"] == "CompiledStageExec"]
    assert rows, "no CompiledStageExec in the plan"
    return rows[0]


# -- the planner --------------------------------------------------------------

def test_q1_plan_compiles_filter_project_agg_chain():
    jax_stages, port_stages = (stages(_q1(m, _session(m))._exec())
                               for m in (JAX, TORCH))
    assert port_stages == jax_stages
    (kind, ops), = port_stages
    assert kind == "agg" and ops[0] == "AggregateExec" and "FilterExec" in ops
    assert isinstance(_q1(TORCH, _session(TORCH))._exec(),
                      tstage.CompiledStageExec)


def test_q3_plan_compiles_join_agg_chain():
    jax_stages, port_stages = (stages(_q3(m, _session(m, Q3_CONF))._exec())
                               for m in (JAX, TORCH))
    assert port_stages == jax_stages
    kind, ops = port_stages[0]
    assert kind == "join_agg"
    assert ops[0] == "AggregateExec" and ops[-1] == "HashJoinExec"


@pytest.mark.parametrize("conf", [{}, {"spark.rapids.tpu.agg.speculative."
                                       "enabled": "false"},
                                  {"spark.rapids.sql.shuffle.partitions": "4",
                                   "spark.rapids.sql.broadcastSizeThreshold":
                                   "-1"}],
                         ids=["default", "exact", "shuffled"])
def test_planned_queries_compile_the_same_stages_as_jax(conf):
    """chip_smoke's phase 3c queries (q1, q3 with LONG and INT keys, Q19,
    TPC-H Q1) through both packages' apply(): the same stages, kinds and
    absorbed chains, in tree order."""
    for label, (jdf, tdf) in queries(conf).items():
        assert stages(tdf._exec()) == stages(jdf._exec()), label


def test_fusion_off_is_a_noop_rewrite():
    sess = _session(TORCH, OFF)
    plan = _q1(TORCH, sess)._exec()
    assert not isinstance(plan, tstage.CompiledStageExec)
    assert tstage.compile_stages(plan, sess.conf) is plan
    assert stages(plan) == stages(_q1(JAX, _session(JAX, OFF))._exec()) == []


def test_bare_group_by_stays_per_operator():
    """A group-by with no absorbed chain is already one step per batch."""
    for m in (JAX, TORCH):
        df = _session(m).from_pydict({"k": [1, 2, 1], "v": [3, 4, 5]},
                                     _schema(m, k="INT", v="LONG"))
        plan = df.group_by("k").agg((m.F.sum(m.core.col("v")), "s"))._exec()
        assert stages(plan) == []


# -- results ------------------------------------------------------------------

def test_q1_fusion_on_off_byte_identical():
    on = sorted(_q1(TORCH, _session(TORCH)).collect())
    off = sorted(_q1(TORCH, _session(TORCH, OFF)).collect())
    assert on == off  # the same bodies, eagerly
    assert tstage.counters()["executions"] == 1
    assert_rows_close(on, _q1(JAX, _session(JAX)).collect())


def test_q3_fusion_on_off_byte_identical():
    on = sorted(_q3(TORCH, _session(TORCH, Q3_CONF)).collect())
    off = sorted(_q3(TORCH, _session(TORCH, dict(Q3_CONF, **OFF))).collect())
    assert on == off
    assert_rows_close(on, _q3(JAX, _session(JAX, Q3_CONF)).collect())


def test_q3_speculative_tier_on_off_equality():
    """With the speculative aggregate the q3 cardinality trips the bucket
    table and collect() re-runs on the exact tier: the stage keeps the
    trip-and-rerun contract (two executions, the second cold-sized)."""
    on = sorted(_q3(TORCH, _session(TORCH, SPEC_Q3_CONF)).collect())
    c = tstage.counters()
    assert c["executions"] == 2 and c["cold_sizings"] == 2
    off = sorted(_q3(TORCH, _session(TORCH, dict(SPEC_Q3_CONF, **OFF)))
                 .collect())
    assert on == off
    assert_rows_close(on, _q3(JAX, _session(JAX, SPEC_Q3_CONF)).collect())


def test_q19_join_agg_matches_its_oracle_on_and_off():
    """Q19 (dictionary-encoded strings, the residual OR as the join's
    condition) through a join_agg stage: the revenue and the qualifying
    rows, which the stage counts on the absorbed join as the per-operator
    plan does."""
    d = cs.q19_data(n_part=4096, n_line=65536)
    want = cs.q19_oracle(d)
    for conf in ({}, OFF):
        sess = _session(TORCH, conf)
        lines, parts = cs.q19_batches(d, "cpu")
        df = cs.q19_df(TORCH, sess, lines, parts)
        rows = df.collect()
        pairs = next(v["numOutputRows"]
                     for k, v in sess.last_query_metrics().items()
                     if k.startswith("HashJoinExec#"))
        cs.check_q19(rows, pairs, want, f"Q19 {conf}")
    assert stages(df._exec()) == [] and tstage.counters()["executions"] == 1


def test_empty_input_corners_match_per_op():
    out = {}
    for m, conf in ((TORCH, {}), (TORCH, OFF), (JAX, {})):
        df = _session(m, conf).from_pydict({"k": [1, 2], "v": [3, 4]},
                                           _schema(m, k="INT", v="LONG"))
        col, lit, F = m.core.col, m.core.lit, m.F
        keyed = (df.filter(col("v") > lit(100))
                   .group_by("k").agg((F.sum(col("v")), "s"))).collect()
        grand = (df.filter(col("v") > lit(100))
                   .agg((F.count(), "c"))).collect()
        out[(m.session.__name__, bool(conf))] = (keyed, grand)
    assert all(v == ([], [(0,)]) for v in out.values()), out
    assert tstage.counters()["executions"] == 2


def test_forced_spill_parquet_equality(tmp_path):
    """The forced-spill recipe (scan -> filter -> join -> agg -> sort over
    parquet, a 192 KiB budget): the catalog really spills under the fused
    stage, and the rows match the per-operator path and the JAX package's
    (run without the budget: its catalog defects, ROADMAP C.5)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.memory import (buffer_catalog,
                                               reset_buffer_catalog,
                                               reset_memory_budget)
    rng = np.random.default_rng(3)
    n_l, n_o = 4000, 500
    lp, op = str(tmp_path / "lines.parquet"), str(tmp_path / "orders.parquet")
    pq.write_table(pa.table({
        "l_key": pa.array(rng.integers(0, n_o, n_l), pa.int64()),
        "l_val": pa.array(rng.random(n_l) * 100.0, pa.float64()),
        "l_flag": pa.array(rng.integers(0, 4, n_l), pa.int64()),
    }), lp, row_group_size=512)
    pq.write_table(pa.table({
        "o_key": pa.array(np.arange(n_o), pa.int64()),
        "o_flag": pa.array(rng.integers(0, 10, n_o), pa.int64()),
    }), op, row_group_size=128)

    def query(m, sess):
        col, lit, F = m.core.col, m.core.lit, m.F
        lines = sess.read_parquet(lp).filter(col("l_flag") != lit(0))
        orders = sess.read_parquet(op).filter(col("o_flag") < lit(5))
        j = lines.join(orders, left_on=["l_key"], right_on=["o_key"])
        agg = j.group_by("l_key").agg((F.sum("l_val"), "rev"),
                                      (F.count(), "cnt"))
        return agg.sort(("rev", False))

    results, spilled, fused = {}, {}, {}
    try:
        for mode, settings in (("on", {}), ("off", dict(OFF))):
            reset_buffer_catalog(spill_dir=str(tmp_path))
            reset_memory_budget(192 * 1024)
            before = tstage.counters()["executions"]
            results[mode] = query(TORCH, _session(TORCH, settings)).collect()
            fused[mode] = tstage.counters()["executions"] - before
            spilled[mode] = buffer_catalog().spilled_device_bytes
    finally:
        reset_buffer_catalog()
        reset_memory_budget()
    assert spilled["on"] > 0 and spilled["off"] > 0  # the budget did bite
    assert fused["on"] > 0 and fused["off"] == 0  # the stage did engage
    assert_rows_close(results["on"], results["off"])
    assert_rows_close(results["on"], query(JAX, _session(JAX)).collect())


# -- dispatches per output batch ---------------------------------------------

def test_q1_chain_one_dispatch_per_output_batch():
    """The fused q1 chain makes one site call per input batch: one batch
    in, one call, one output batch."""
    sess = _session(TORCH)
    _q1(TORCH, sess).collect()
    row = _stage_row(sess)
    assert row["dispatches_per_batch"] == 1.0, row
    assert row["programs"] == 1


def test_q3_chain_dispatch_rate_acceptance():
    """The exact-tier q3 stage, per execution: the build (one eager
    step), the probe (the graphed step on the card) and the exact update
    (eager: C.2) of its one stream batch, plus a sizing pass when cold.
    Warm executions (a fresh exec tree per collect; the sizing cache is
    shared by fingerprint) make no sizing call."""
    sess = _session(TORCH, Q3_CONF)
    q = _q3(TORCH, sess)
    q.collect()
    cold = _stage_row(sess)
    assert cold["dispatches"] == 4 and cold["batches"] == 1, cold
    for _ in range(2):
        q.collect()
        row = _stage_row(sess)
        assert row["dispatches"] == 3 and row["dispatches_per_batch"] == 3.0
    assert tstage.counters()["cold_sizings"] == 1


# -- the plan-fingerprint program cache ---------------------------------------

@pytest.mark.parametrize("conf,build", [({}, _q1), (Q3_CONF, _q3)],
                         ids=["q1", "q3"])
def test_second_collect_is_all_cache_hits(conf, build):
    """A second collect() of an equal plan builds no new site: the rebuilt
    exec tree gets every site (and, on the card, its graphs) from the
    cache, and nothing is captured (nothing is on the CPU either)."""
    sess = _session(TORCH, conf)
    q = build(TORCH, sess)
    r1 = sorted(q.collect())
    c1, l1 = tstage.counters(), tdispatch.calls_by_label("stage")
    assert c1["cache_misses"] > 0  # the first collect built its sites
    r2 = sorted(q.collect())
    c2, l2 = tstage.counters(), tdispatch.calls_by_label("stage")
    assert r1 == r2
    assert c2["cache_misses"] == c1["cache_misses"], "second collect built"
    assert c2["cache_hits"] - c1["cache_hits"] == c1["cache_misses"]
    assert sum(l2.values()) > sum(l1.values())
    assert c2["graph_captures"] == 0 and tdispatch.counters()["traces"] == 0


def test_fingerprints_distinguish_plans_and_conf():
    """Different plans (another predicate literal, another schema) or a
    different body-affecting conf (bucket slots) never share sites;
    equal plans under equal confs do."""
    p1 = _q1(TORCH, _session(TORCH))._exec()
    col, lit, F = TORCH.core.col, TORCH.core.lit, TORCH.F

    def variant(schema, bound):
        df = _session(TORCH).from_pydict({"k": [1], "q": [2], "p": [3.0]},
                                         schema)
        return (df.filter(col("q") <= lit(bound)).group_by("k")
                  .agg((F.sum(col("p")), "s"), (F.count(), "c"))._exec())

    base = _schema(TORCH, k="INT", q="LONG", p="DOUBLE")
    assert p1.plan_fingerprint() == variant(base, 40).plan_fingerprint()
    assert p1.plan_fingerprint() != variant(base, 7).plan_fingerprint()
    other = _schema(TORCH, k="LONG", q="LONG", p="DOUBLE")
    assert p1.plan_fingerprint() != variant(other, 40).plan_fingerprint()
    p3 = _q1(TORCH, _session(
        TORCH, {"spark.rapids.tpu.agg.bucketSlots": "16"}))._exec()
    assert p1.plan_fingerprint() != p3.plan_fingerprint()
    assert _q1(TORCH, _session(TORCH))._exec().plan_fingerprint() == \
        p1.plan_fingerprint()
    assert _q1(TORCH, _session(TORCH, OFF))._exec().plan_fingerprint() \
        is None


def test_fingerprints_are_value_complete_not_repr():
    """Expression parameters outside the children (a trim set, a
    percentile's fraction, first()'s ignore_nulls) tell plans apart; a
    Python UDF opts its subtree out of the cache."""
    from spark_rapids_tpu_torch.expr.aggexprs import (ApproxPercentile,
                                                      First, Last,
                                                      Percentile)
    from spark_rapids_tpu_torch.expr.udf import PythonUDF
    col, F = TORCH.core.col, TORCH.F
    key = tstage.semantic_key

    def proj_fp(expr):
        df = _session(TORCH).from_pydict({"s": ["x"]},
                                         _schema(TORCH, s="STRING"))
        return df.select(expr.alias("r"))._exec().plan_fingerprint()

    assert proj_fp(F.trim(col("s"))) != proj_fp(F.trim(col("s"), "ag "))
    assert key(Percentile(col("x"), 0.05)) != key(Percentile(col("x"), 0.95))
    assert key(ApproxPercentile(col("x"), 0.5, 100)) != \
        key(ApproxPercentile(col("x"), 0.5, 200))
    assert key(First(col("x"), ignore_nulls=True)) != \
        key(First(col("x"), ignore_nulls=False))

    def agg_fp(fn):
        df = _session(TORCH).from_pydict({"k": [1], "x": [2.0]},
                                         _schema(TORCH, k="INT", x="DOUBLE"))
        return (df.filter(col("x") > TORCH.core.lit(0)).group_by("k")
                  .agg((fn, "r"))._exec().plan_fingerprint())

    assert agg_fp(First(col("x"), ignore_nulls=True)) != \
        agg_fp(First(col("x"), ignore_nulls=False))
    assert agg_fp(First(col("x"))) != agg_fp(Last(col("x")))

    df = _session(TORCH).from_pydict({"a": [1, 2]}, _schema(TORCH, a="LONG"))
    udf = PythonUDF(lambda x: x + 1, TORCH.t.LONG, col("a"))
    plan = df.select(udf.alias("r"))._exec()
    projs = [n for n in _walk(plan)
             if type(n).__name__ in ("ProjectExec", "HostProjectExec")]
    assert projs and all(n.plan_fingerprint() is None for n in projs)


# -- map stages ---------------------------------------------------------------

def test_map_stage_fuses_filter_project_chain():
    """A filter -> project -> filter chain under a sort compiles to a map
    stage: every projection and one compaction in one step per input
    batch, rows equal to the per-operator chain's and the JAX package's."""
    sess = _session(TORCH)
    kinds = stages(_map(TORCH, sess)._exec())
    assert kinds == stages(_map(JAX, _session(JAX))._exec())
    assert kinds == [("map", ["FilterExec", "ProjectExec", "FilterExec"])]
    on = _map(TORCH, sess).collect()
    assert on == _map(TORCH, _session(TORCH, OFF)).collect()
    assert on == _map(JAX, _session(JAX)).collect()
    row = _stage_row(sess)
    assert row["dispatches_per_batch"] == 1.0, row


def test_map_stage_expand_fans_out_from_one_program():
    """An expand inside a map chain emits all its projections from one
    step per input batch (the grouping-sets shape)."""
    def tree(m, basic, batch_of):
        schema = _schema(m, k="LONG", v="LONG")
        col, lit = m.core.col, m.core.lit
        batch = batch_of({"k": [1, 2, 3, 4], "v": [10, 20, 30, 40]}, schema)
        scan = basic.InMemoryScanExec([batch], schema)
        expand = basic.ExpandExec(
            [[col("k"), col("v")], [col("k"), (col("v") * lit(2)).alias("v")]],
            scan)
        return basic.FilterExec(col("v") > lit(15), expand)

    from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
    from spark_rapids_tpu.exec import basic as jbasic
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
    from spark_rapids_tpu_torch.exec import basic as tbasic

    def tbatch(d, s):
        return TBatch.from_pydict(d, s, device="cpu")

    per_op = sorted(r for b in tree(TORCH, tbasic, tbatch).execute()
                    for r in b.to_pylist())
    conf = _session(TORCH).conf
    fused = tstage.compile_stages(tree(TORCH, tbasic, tbatch), conf)
    jfused = jstage.compile_stages(tree(JAX, jbasic, JBatch.from_pydict),
                                   _session(JAX).conf)
    assert stages(fused) == stages(jfused) == \
        [("map", ["FilterExec", "ExpandExec"])]
    got = sorted(r for b in fused.execute() for r in b.to_pylist())
    assert got == per_op
    assert got == sorted(r for b in jfused.execute() for r in b.to_pylist())
    # 1 input batch -> 2 output batches from one step
    assert fused.metrics["numDispatches"].value == 1
    assert fused.metrics["numOutputBatches"].value == 2


# -- governance at the stage boundary -----------------------------------------

BREAKER = {"spark.rapids.tpu.breaker.enabled": "true",
           "spark.rapids.tpu.breaker.threshold": "1",
           "spark.rapids.tpu.breaker.cooldownMs": "600000"}


def test_breaker_demotes_stage_to_per_op():
    """An open device_dispatch breaker demotes the stage to per-operator
    execution: rows unchanged, the fallback counter proves the lane."""
    sess = _session(TORCH, BREAKER)
    baseline = sorted(_q1(TORCH, sess).collect())
    tlifecycle.record_domain_failure("device_dispatch")
    assert not tlifecycle.breaker_allows("device_dispatch")
    before = tstage.counters()
    demoted = sorted(_q1(TORCH, sess).collect())
    after = tstage.counters()
    assert demoted == baseline
    assert after["fallbacks"] > before["fallbacks"]
    assert after["executions"] == before["executions"]
    assert tlifecycle.health()["breakers"]["device_dispatch"]["state"] == \
        "open"


def test_open_breaker_routes_to_the_per_operator_execs(monkeypatch):
    """The demoted q3 stage runs the absorbed HashJoinExec and
    AggregateExec themselves, and they reach the probe through its kernel
    wrapper (`fused_probe_verify`, which launches the kernel on the card),
    never a plain version directly; the stage's own sites are not
    called."""
    from spark_rapids_tpu_torch.exec import joins
    calls = []
    wrapper = joins.fused_probe_verify

    def spy(*a, **k):
        calls.append("wrapper")
        return wrapper(*a, **k)
    monkeypatch.setattr(joins, "fused_probe_verify", spy)
    sess = _session(TORCH, dict(Q3_CONF, **BREAKER))
    baseline = sorted(_q3(TORCH, sess).collect())
    assert calls  # the fused stage probes through the wrapper too
    tlifecycle.record_domain_failure("device_dispatch")
    plan = _q3(TORCH, sess)._exec()
    sites_before = [s.calls for s in plan.stage_sites()]
    calls.clear()
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    with speculation_scope():
        rows = sorted(r for b in plan.execute() for r in b.to_pylist())
    assert rows == baseline and calls
    assert [s.calls for s in plan.stage_sites()] == sites_before
    assert plan._join.metrics["numOutputRows"].value > 0


def test_stage_fault_point_recovers_via_task_retry():
    """The stage boundary draws the device.dispatch fault point with a
    stage-keyed work item: one injected device fault converges through
    task re-execution."""
    sess = _session(TORCH, {"spark.rapids.tpu.task.maxAttempts": "5"})
    expect = sorted(_q1(TORCH, sess).collect())
    tfaults.install("device.dispatch:prob=1.0,seed=7,kind=device,max=1")
    got = sorted(_q1(TORCH, sess).collect())
    assert tfaults.stats().get("device.dispatch", 0) >= 1
    tfaults.install(None)
    assert got == expect


def test_stage_fused_event_fields(tmp_path):
    """One stage_fused event per fused execution, with the JAX package's
    keys."""
    records = {}
    for name, m, ev in (("jax", JAX, jevents), ("port", TORCH, tevents)):
        d = tmp_path / name
        sess = _session(m, {"spark.rapids.tpu.eventLog.enabled": "true",
                            "spark.rapids.tpu.eventLog.dir": str(d)})
        _q1(m, sess).collect()
        path = ev.active_bus().path
        ev.reset_event_bus()
        records[name] = [json.loads(ln) for ln in open(path)
                         if '"stage_fused"' in ln]
    (j,), (t,) = records["jax"], records["port"]
    assert set(t) == set(j)
    assert t["stage"] == j["stage"] == "agg" and t["ops"] == j["ops"] >= 2
    assert t["label"] == j["label"] and "AggregateExec" in t["label"]
    assert t["batches"] >= 1 and t["dispatches"] >= 1
    assert t["donated_bytes"] > 0  # the carried state's bytes


def test_dispatch_summary_shows_a_fused_chain_as_one_row():
    sess = _session(TORCH)
    _q1(TORCH, sess).collect()
    summary = sess.last_query_profile().dispatch_summary()
    (row,) = summary["stages"]
    assert row["op"] == "CompiledStageExec"
    assert row["desc"] == "CompiledStageExec[agg: AggregateExec+FilterExec]"
    assert summary["stage"]["executions"] == 1
    assert summary["counters"]["dispatches"] >= row["dispatches"]


# -- the program sites --------------------------------------------------------

def test_a_site_on_cpu_tensors_never_captures():
    before = tdispatch.graph_counters()
    site = tdispatch.instrument(lambda x: x * 2, "test.double")
    with site.run() as run:
        for _ in range(3):
            out = run(torch.arange(4))
            assert not run.replayed and run.eager_cause is None
    assert out.tolist() == [0, 2, 4, 6]
    after = tdispatch.graph_counters()
    assert after["captures"] == before["captures"]
    assert after["replays"] == before["replays"]
    assert after["eager_calls"] - before["eager_calls"] == 3
    assert site.captures == 0 and site.calls == 3


def test_flatten_round_trips_batches_and_build_tables():
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.ops.join import BuildTable
    schema = _schema(TORCH, k="LONG", s="STRING", x="DOUBLE")
    b = ColumnarBatch.from_pydict({"k": [3, 1, None, 2],
                                   "s": ["a", None, "ccc", "dd"],
                                   "x": [1.5, 2.5, 3.5, None]}, schema,
                                  device="cpu")
    table = BuildTable.build([b.columns[0]], list(b.columns), b.num_rows,
                             b.capacity)
    leaves = []
    spec = tdispatch.flatten((table, b, 7, None), leaves)
    again = tdispatch.unflatten(spec, iter(leaves))
    assert again[1]._host_rows is None  # counted on the device
    assert again[1].to_pylist() == b.to_pylist()
    assert again[2:] == (7, None)
    assert torch.equal(again[0].perm, table.perm)
    # equal shapes give equal keys; another capacity another
    b2 = ColumnarBatch.from_pydict({"k": [9, 8, 7, 6], "s": ["x"] * 4,
                                    "x": [0.0] * 4}, schema, device="cpu")
    assert tdispatch._key_of(tdispatch.flatten(b, [])) == \
        tdispatch._key_of(tdispatch.flatten(b2, []))
    b3 = ColumnarBatch.from_pydict({"k": [1] * 200, "s": ["x"] * 200,
                                    "x": [0.0] * 200}, schema, device="cpu")
    assert tdispatch._key_of(tdispatch.flatten(b, [])) != \
        tdispatch._key_of(tdispatch.flatten(b3, []))
    copy = tdispatch.clone_value(b)
    copy.columns[0].data.add_(1)
    assert b.to_pylist() == again[1].to_pylist()


def test_flatten_refuses_what_does_not_cross_a_site():
    """Only the registered kinds flatten: an object that is not a tensor,
    container, batch, column, schema or `_site_fields` class (an exec, a
    session) raises rather than being walked into the graph key; a site
    that is never captured takes such arguments without flattening."""
    class Opaque:
        def __init__(self):
            self.t = torch.arange(3)

    with pytest.raises(TypeError, match="Opaque"):
        tdispatch.flatten((torch.arange(2), [Opaque()]), [])
    site = tdispatch.instrument(lambda xs, owner: xs[0] + 1, "test.eager",
                                graph=False, cause="a test body")
    with site.run() as run:
        assert run([torch.arange(3)], Opaque()).tolist() == [1, 2, 3]
    graphed = tdispatch.instrument(lambda x, owner: x, "test.graphed")
    with graphed.run() as run, pytest.raises(TypeError, match="Opaque"):
        run(torch.arange(3), Opaque())


def test_a_replay_counts_its_recorded_launches_and_frees_its_constants():
    """A replay adds each recorded kernel site's launches to the counter
    the site named and to an open launch tally; a graph checked back in
    keeps no reference to its run's constants. (Capture runs only on the
    card: the graph here is a stand-in over CPU buffers.)"""
    class Counted:
        launches = 0

    class Replayed:
        replays = 0

        def replay(self):
            self.replays += 1

        def reset(self):
            pass

    site = tdispatch.ProgramSite(lambda x: x, "test.replay")
    g = tdispatch._Graph(site, "key")
    g.graph = Replayed()
    g.static_in = [torch.zeros(4, dtype=torch.int64)]
    g.out_spec = tdispatch.flatten(g.static_in[0], g.static_out)
    from spark_rapids_tpu_torch.ops import gather as tgather
    g.gathers = {k: 0 for k in tgather.counters()}
    g.kernels = [("dma_row_gather", (4, 2), "cuda", 2, Counted),
                 ("murmur3_columns", (4, 1), "cuda", 1, None)]
    const = torch.arange(4)
    with tdispatch.launch_tally() as tally:
        out = site._replay(g, [const], {0})
        out2 = site._replay(g, [const], {0})
    assert g.graph.replays == 2 and Counted.launches == 4
    assert tally == {"dma_row_gather": 4, "murmur3_columns": 2}
    assert out.tolist() == out2.tolist() == [0, 1, 2, 3]
    assert g.fixed_seen[0][0] is const
    site._checkin(g)
    assert g.fixed_seen == {}
    assert site._discard(g) == 0 and g.graph is None


def test_launch_tally_counts_kernel_sites_with_the_ledger_on_or_off():
    tdispatch.configure(RapidsConf({
        "spark.rapids.tpu.dispatch.ledger.enabled": "false"}))
    try:
        with tdispatch.launch_tally() as outer:
            with tdispatch.kernel_site("dict_gather", (8,), "cpu") as f:
                f.count()
            with tdispatch.launch_tally() as inner:
                with tdispatch.kernel_site("dict_gather", (8,), "cpu") as f:
                    f.count(2)
        assert inner == {"dict_gather": 2} and outer == {"dict_gather": 3}
        tdispatch.configure(RapidsConf())
        with tdispatch.launch_tally() as tally:
            with tdispatch.kernel_site("dma_row_gather", (8,), "cpu") as f:
                f.count()
        assert tally == {"dma_row_gather": 1}
    finally:
        tdispatch.configure(RapidsConf())


class HostReadTrap(TorchFunctionMode):
    """Records every torch call that would synchronize with the card or
    copy from host memory on it: what a CUDA graph capture refuses."""

    SYNC = {"item", "tolist", "__bool__", "__int__", "__float__",
            "__index__", "nonzero", "masked_select", "unique", "numpy",
            "tensor", "as_tensor"}

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        bad = name in self.SYNC or (name == "repeat_interleave"
                                    and "output_size" not in kwargs)
        if name == "__getitem__" and len(args) > 1:
            idx = args[1] if isinstance(args[1], tuple) else (args[1],)
            bad = any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                      for i in idx)
        if bad:
            self.hits.append(name)
        return func(*args, **kwargs)


@contextmanager
def trapped_graph_bodies(monkeypatch):
    """Run every graphable site body under a HostReadTrap; yields
    {site label: [trapped calls]}, `from_numpy` included."""
    hits = {}
    real_call = tdispatch.SiteRun.__call__
    real_from_numpy = torch.from_numpy
    active = []

    def from_numpy(a):
        if active:
            active[-1].hits.append("from_numpy")
        return real_from_numpy(a)

    def call(self, *args, fixed=()):
        site = self.site
        if not site.graph:
            return real_call(self, *args, fixed=fixed)
        fn = site._fn

        def trapped(*a):
            trap = HostReadTrap()
            active.append(trap)
            try:
                with trap:
                    return fn(*a)
            finally:
                active.pop()
                hits.setdefault(site.label, []).extend(trap.hits)
        site._fn = trapped
        try:
            return real_call(self, *args, fixed=fixed)
        finally:
            site._fn = fn

    monkeypatch.setattr(tdispatch.SiteRun, "__call__", call)
    monkeypatch.setattr(torch, "from_numpy", from_numpy)
    yield hits


def test_graphed_bodies_read_nothing_on_the_host(monkeypatch):
    """The bodies the card captures (q1's agg step, q3's probe, the
    speculative probe step, Q19's probe step with its code-space
    predicates, the map step) make no call that synchronizes with the
    card or copies from host memory, the calls a capture refuses; the
    exact step and the build are eager by design."""
    d = cs.q19_data(n_part=4096, n_line=65536)
    with trapped_graph_bodies(monkeypatch) as hits:
        _q1(TORCH, _session(TORCH)).collect()
        _q3(TORCH, _session(TORCH, Q3_CONF)).collect()
        _q3(TORCH, _session(TORCH, SPEC_Q3_CONF)).collect()
        lines, parts = cs.q19_batches(d, "cpu")
        cs.q19_df(TORCH, _session(TORCH), lines, parts).collect()
        _map(TORCH, _session(TORCH)).collect()
    assert set(hits) == {"CompiledStageExec.step",
                         "CompiledStageExec.probe",
                         "CompiledStageExec.probe_step",
                         "CompiledStageExec.map"}
    assert hits == {k: [] for k in hits}
    plan = _q3(TORCH, _session(TORCH, Q3_CONF))._exec()
    assert [(s.label, s.graph) for s in plan.stage_sites()] == [
        ("CompiledStageExec.build", False),
        ("CompiledStageExec.sizing", False),
        ("CompiledStageExec.probe_step", True),
        ("CompiledStageExec.probe", True),
        ("CompiledStageExec.step_exact", False)]
    assert plan._exact_site.cause == tstage.CAUSE_EXACT


def test_the_budget_drops_idle_graphs_least_recently_used_first():
    """Captured graphs' pools count against the device budget they were
    reserved in; a reservation under pressure drops that budget's graphs
    no run holds, least recently used first, never one a run holds, and a
    dropped graph's bytes leave its own budget (a test budget installed
    later is not credited with an earlier one's graphs). (Capture itself
    runs only on the card: the graphs here are stand-ins with the pool
    bytes a capture would have measured.)"""
    from spark_rapids_tpu_torch.memory import reset_memory_budget

    class Captured:
        def __init__(self):
            self.resets = 0

        def reset(self):
            self.resets += 1

    def stand_in(site, key, nbytes, budget):
        g = tdispatch._Graph(site, key)
        g.graph, g.pool_bytes, g.budget = Captured(), nbytes, budget
        budget.reserve(nbytes)
        return g

    try:
        site = tdispatch.ProgramSite(lambda x: x, "test.graphs")
        # a graph whose pool an earlier budget holds
        old_budget = reset_memory_budget(1000)
        old = stand_in(site, "old", 500, old_budget)
        budget = reset_memory_budget(1000)
        graphs = [stand_in(site, k, 300, budget) for k in ("a", "b", "c")]
        captured = [g.graph for g in graphs]
        held = site.run()
        held._held["c"] = graphs[2]          # a run holds c
        for g in (old, graphs[0], graphs[1]):
            site._checkin(g)                 # least recently used first
        assert budget.used == 900
        budget.reserve(350)                  # 250 short: drops a, not old
        assert captured[0].resets == 1 and graphs[0].graph is None
        assert old.graph is not None and graphs[1].graph is not None
        assert budget.used == 950 and old_budget.used == 500
        assert tdispatch.drop_cached_graphs() == 800   # old and b; c held
        assert budget.used == 650 and old_budget.used == 0
        assert captured[1].resets == 1 and captured[2].resets == 0
        held.close()                         # c back in the free list
        assert site._checkout("c") is graphs[2]
        # a key whose graph the budget could not hold runs eagerly while
        # the budget has no room for its pool, and may capture again once
        # it has
        site._over_budget["d"] = 400           # 350 bytes free now
        assert site._budget_room("a") and not site._budget_room("d")
        budget.release(800)
        assert site._budget_room("d")
    finally:
        reset_memory_budget()


def test_cached_graphs_report_what_a_replay_launches():
    """The site cache's idle graphs are listed with their pools and the
    kernel launches one replay adds (stand-ins: capture runs only on the
    card)."""
    site = tdispatch.instrument(lambda x: x, "test.report", cache_key="k")
    g = tdispatch._Graph(site, "key")
    g.pool_bytes = 4096
    g.kernels = [("dma_row_gather", (1024, 8), "cuda", 2, None),
                 ("murmur3_columns", (1024, 1), "cuda", 1, None),
                 ("dma_row_gather", (2048, 4), "cuda", 1, None)]
    site._checkin(g)
    assert tdispatch.cached_graphs() == [
        {"label": "test.report", "pool_bytes": 4096,
         "kernels": {"dma_row_gather": 3, "murmur3_columns": 1}}]
    tdispatch.reset_site_cache()
    assert tdispatch.cached_graphs() == []
