"""The out-of-core sort and the q3 plan under a small device budget, in
the port against the JAX package, on the CPU.

Both packages get the same numpy batches, the same budget and host
limit, and the same fan-in. A SortExec over more runs than its fan-in
merges out of core in both; its rows and their order must be equal bit
for bit, the port's catalog must have spilled to the host and to the
disk, and a consumer that abandons the merge must leave the catalog
empty. q3 with its lineitems in 8 batches under a small budget gives the
reference's result and bench.q3_oracle (keys exact, revenue rtol 1e-9).
"""

import numpy as np
import pytest

import bench
from spark_rapids_tpu import config as jconf
from spark_rapids_tpu import memory as jmem

from spark_rapids_tpu_torch import memory as tmem

from test_torch_jax_ref import jax_aliases
from test_torch_q3_slice import JAX, TORCH, RTOL, q3_data

N_BATCH = 300            # rows a batch (capacity 512)


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


@pytest.fixture
def budgets(tmp_path):
    """Install the same device budget in both packages, and the host
    limit in the port. The JAX package spills synchronously and keeps
    its spills on the host: its out-of-core merge loads a run's chunk
    without a retry (an unspill there cannot wait for the writer to free
    the budget, so with the writer on its result would depend on thread
    timing), and the disk pass a promotion's reservation runs can take
    the promoted entry's host copy away (ROADMAP C)."""
    def install(limit, host_limit):
        jconf.set_active_conf(jconf.RapidsConf({
            "spark.rapids.memory.host.spillStorageSize": str(1 << 40),
            "spark.rapids.memory.spillDirectory": str(tmp_path / "jax"),
            "spark.rapids.tpu.spill.asyncWrite": "false"}))
        jmem.reset_buffer_catalog()
        jmem.reset_memory_budget(limit)
        jmem.register_task(1)
        tmem.reset_memory_budget(limit)
        tmem.register_task(1)
        return tmem.reset_buffer_catalog(host_limit=host_limit,
                                         spill_dir=str(tmp_path / "torch"))
    yield install
    jmem.reset_buffer_catalog()
    jmem.reset_memory_budget()
    jconf.set_active_conf(jconf.RapidsConf())
    tmem.reset_buffer_catalog()
    tmem.reset_memory_budget()


def _sort_data(n_batches, seed):
    """Keys with duplicates and nulls, prices with ties (so the merge's
    tie order is checked too), a payload column."""
    rng = np.random.default_rng(seed)
    n = n_batches * N_BATCH
    return {"k": (rng.integers(0, 40, n).astype(np.int64),
                  rng.random(n) > 0.05),
            "p": (np.round(rng.random(n) * 50) / 4, rng.random(n) > 0.05),
            "f": (rng.integers(-9, 9, n).astype(np.int32), None)}


def _sort_plan(p, d, n_batches, fan_in):
    t = p.t
    schema = t.Schema((t.StructField("k", t.LONG),
                       t.StructField("p", t.DOUBLE),
                       t.StructField("f", t.INT)))
    batches = []
    for i in range(0, n_batches * N_BATCH, N_BATCH):
        kw = {"device": p.device} if p.device else {}
        cols = []
        for f in schema.fields:
            v, valid = d[f.name]
            cols.append(p.Column.from_numpy(
                v[i: i + N_BATCH], f.data_type, validity=None
                if valid is None else valid[i: i + N_BATCH], **kw))
        batches.append(p.Batch(cols, N_BATCH, schema))
    col = p.core.col
    sort = p.sortexec.SortExec([(col("k"), True, None),
                                (col("p"), False, None)],
                               p.basic.InMemoryScanExec(batches, schema))
    sort.MERGE_FAN_IN = fan_in
    return sort


def _rows(plan):
    return [tuple(r) for b in plan.execute() for r in b.to_pylist()]


@pytest.mark.parametrize("n_batches,fan_in,passes",
                         [(12, 8, 2), (20, 4, 3), (9, 8, 2)])
def test_out_of_core_sort_matches_the_reference(budgets, n_batches, fan_in,
                                                passes):
    d = _sort_data(n_batches, n_batches)
    per_run = _sort_plan(TORCH, d, 1, fan_in).child._batches[0].nbytes
    # about three runs' worth of device, one of host: the runs spill to
    # the host and on to the disk
    cat = budgets(3 * per_run + per_run // 2, per_run)
    tsort = _sort_plan(TORCH, d, n_batches, fan_in)
    trows = _rows(tsort)
    jrows = _rows(_sort_plan(JAX, d, n_batches, fan_in))
    assert trows == jrows
    assert len(trows) == n_batches * N_BATCH
    c = cat.counters()
    assert c["to_host"] > 0 and c["to_disk"] > 0 and c["to_device"] > 0
    assert tsort.metrics["mergePasses"].value == passes
    assert tsort.metrics["mergeHostReads"].value > 0
    assert cat.num_entries() == 0 and cat.device_bytes() == 0


def test_out_of_core_sort_order_against_numpy(budgets):
    """Keys ascending with nulls first, distinct prices descending: the
    order numpy's lexsort gives (without ties the order is defined)."""
    n_batches = 10
    d = _sort_data(n_batches, 5)
    k, kv = d["k"]
    p = np.random.default_rng(6).random(k.shape[0]) * 1000.0
    d["p"] = (p, None)
    cat = budgets(1 << 20, 1 << 16)
    rows = _rows(_sort_plan(TORCH, d, n_batches, 8))
    order = np.lexsort((-p, np.where(kv, k, -1)))
    want = [(int(k[i]) if kv[i] else None, float(p[i]), int(d["f"][0][i]))
            for i in order]
    assert rows == want
    assert cat.num_entries() == 0


@pytest.mark.parametrize("taken", [0, 1, 5])
def test_abandoned_merge_leaves_the_catalog_empty(budgets, taken):
    d = _sort_data(12, 3)
    per_run = _sort_plan(TORCH, d, 1, 8).child._batches[0].nbytes
    cat = budgets(3 * per_run, per_run)
    it = _sort_plan(TORCH, d, 12, 8).execute()
    got = [next(it) for _ in range(taken + 1)]
    assert got[0].num_rows_host > 0
    assert cat.num_entries() > 0
    it.close()
    assert cat.num_entries() == 0
    assert tmem.memory_budget().used == 0


def _q3_plan(p, d, line_batches):
    """The q3 slice's plan with the lineitems fed as `line_batches`
    batches (bench.py's make_q3_plan)."""
    t, col, lit = p.t, p.core.col, p.core.lit
    n_orders, n_lines = d["o_orderkey"].shape[0], d["l_orderkey"].shape[0]
    o_schema = t.Schema((t.StructField("o_orderkey", t.LONG),
                         t.StructField("o_flag", t.INT)))
    l_schema = t.Schema((t.StructField("l_orderkey", t.LONG),
                         t.StructField("l_price", t.DOUBLE),
                         t.StructField("l_disc", t.DOUBLE),
                         t.StructField("l_flag", t.INT)))

    def mk(schema, lo, hi):
        kw = {"device": p.device} if p.device else {}
        return p.Batch([p.Column.from_numpy(d[f.name][lo:hi], f.data_type,
                                            **kw)
                        for f in schema.fields], hi - lo, schema)

    step = n_lines // line_batches
    lines = [mk(l_schema, i, i + step) for i in range(0, n_lines, step)]
    o_scan = p.basic.FilterExec(col("o_flag") < lit(5),
                                p.basic.InMemoryScanExec(
                                    [mk(o_schema, 0, n_orders)], o_schema))
    l_scan = p.basic.FilterExec(col("l_flag") != lit(0),
                                p.basic.InMemoryScanExec(lines, l_schema))
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


def test_q3_under_a_small_budget_matches_the_reference(budgets):
    d = q3_data()
    cat = budgets(1 << 40, 1 << 40)
    tmem.force_split_and_retry_oom(1)
    _rows(_q3_plan(TORCH, d, 8))
    # the least budget the plan's wiring runs in: what it holds in use at
    # once (the merge of its partials), above a quarter of the peak
    peak = tmem.memory_budget().peak
    limit = max(peak // 4, cat.peak_pinned_bytes)
    assert peak // 4 < limit < peak
    cat = budgets(limit, peak // 8)
    tmem.force_split_and_retry_oom(1)
    jmem.force_split_and_retry_oom(1)
    trows = _rows(_q3_plan(TORCH, d, 8))
    jrows = _rows(_q3_plan(JAX, d, 8))
    oracle = bench.q3_oracle(d)
    assert [k for k, _ in trows] == [k for k, _ in jrows]
    assert {k for k, _ in trows} == set(oracle)
    for (k, v), (_, jv) in zip(trows, jrows):
        assert v == pytest.approx(jv, rel=RTOL, abs=0)
        assert v == pytest.approx(oracle[k], rel=RTOL, abs=0)
    c = cat.counters()
    assert c["to_host"] > 0 and c["to_disk"] > 0 and c["to_device"] > 0
    assert tmem.task_retry_counts()[1] == 1
    assert cat.num_entries() == 0 and cat.device_bytes() == 0
