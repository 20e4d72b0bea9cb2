"""collect_list and collect_set (expr/aggexprs.py, ops/aggregate.py's list
buffers) against the JAX package on the CPU: grouped and grand, over
several batches (partials concatenated and merged by `collect_merge`),
with null values and null keys, over LONG, DOUBLE (-0.0 and NaN dedup as
Spark's equality) and STRING (collect_list only: collect_set over a
string is tagged off in both packages).

The partial and final modes over the host shuffle: the JAX package plans
these aggregates single-partition (its final mode takes no shuffled list
buffers) and so does the port's planner; the port's own partial ->
HostShuffleExchangeExec -> final drive carries the list buffers through
the shuffle's frames and gives the single-stage result. A set's element
order is unspecified (Spark): sets compare sorted, lists exactly.
"""

import math

import numpy as np
import pytest

from spark_rapids_tpu.exec import aggregate as ja
from spark_rapids_tpu.exec import basic as jb
from spark_rapids_tpu.expr import aggexprs as jae
from spark_rapids_tpu.expr import core as jc

from spark_rapids_tpu_torch import functions as tF
from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec import aggregate as ta
from spark_rapids_tpu_torch.exec import basic as tb
from spark_rapids_tpu_torch.exec import exchange as tx
from spark_rapids_tpu_torch.expr import aggexprs as tae
from spark_rapids_tpu_torch.expr import core as tc

from test_torch_arrays import both
from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


def _aggs(ae, c):
    return [(ae.CollectList(c.col("v")), "lv"),
            (ae.CollectSet(c.col("v")), "sv"),
            (ae.CollectSet(c.col("d")), "sd"),
            (ae.CollectList(c.col("s")), "ls")]


def _data(seed, n=60):
    rng = np.random.default_rng(seed)
    v = [None if rng.random() < 0.15 else int(x)
         for x in rng.integers(0, 6, n)]
    d = [None if rng.random() < 0.1 else float(x)
         for x in rng.choice([0.0, -0.0, 1.5, math.nan, 2.5], n)]
    s = [None if rng.random() < 0.1 else f"w{x}"
         for x in rng.integers(0, 4, n)]
    k = [None if rng.random() < 0.1 else int(x)
         for x in rng.integers(0, 4, n)]
    return {"k": k, "v": v, "d": d, "s": s}


TYPES = {"k": tt.INT, "v": tt.LONG, "d": tt.DOUBLE, "s": tt.STRING}


def _canon(rows, set_cols):
    """Rows with each set sorted (NaN last) for comparison."""
    def key(x):
        return (x is None, isinstance(x, float) and math.isnan(x),
                0.0 if x is None or (isinstance(x, float) and math.isnan(x))
                else x)
    out = []
    for r in rows:
        r = list(r)
        for i in set_cols:
            if r[i] is not None:
                r[i] = [("nan" if isinstance(x, float) and math.isnan(x)
                         else x) for x in sorted(r[i], key=key)]
        out.append(tuple(r))
    return sorted(out, key=repr)


@pytest.mark.parametrize("keys", [True, False])
def test_collect_matches_jax(keys):
    """Grouped: against the JAX package; grand: against the values in
    batch order (a list) and their distinct values (a set)."""
    pairs = [both(_data(s), TYPES) for s in range(3)]
    out = []
    packages = ((ja, jb, jae, jc, 0),) if keys else ()
    for ex, b, ae, c, k in packages + ((ta, tb, tae, tc, 1),):
        node = ex.AggregateExec([c.col("k")] if keys else [], _aggs(ae, c),
                                b.InMemoryScanExec([p[k] for p in pairs],
                                                   pairs[0][k].schema))
        out.append([r for x in node.execute() for r in x.to_pylist()])
    if keys:
        assert _canon(out[1], (2, 3)) == _canon(out[0], (2, 3))
        return
    # lists keep the input order: the concatenation of every batch's rows
    flat = {c: [x for s in range(3) for x in _data(s)[c] if x is not None]
            for c in ("v", "d", "s")}
    (row,) = out[0]
    assert row[0] == flat["v"] and row[3] == flat["s"]
    assert sorted(row[1]) == sorted(set(flat["v"]))
    # Spark's equality: -0.0 equals 0.0, NaN equals NaN
    want = {("nan" if math.isnan(x) else x + 0.0) for x in flat["d"]}
    got = [("nan" if math.isnan(x) else x + 0.0) for x in row[2]]
    assert len(got) == len(set(got)) and set(got) == want


def test_partial_final_over_the_host_shuffle():
    """The port's partial -> exchange (4 partitions) -> final drive moves
    the list buffers through the shuffle's frames: the same groups,
    lists and sets as the single-stage aggregate."""
    pairs = [both(_data(s), TYPES) for s in range(3)]
    scan = tb.InMemoryScanExec([p[1] for p in pairs], pairs[0][1].schema)
    aggs = _aggs(tae, tc)
    single = ta.AggregateExec([tc.col("k")], aggs, scan)
    partial = ta.AggregateExec([tc.col("k")], aggs, scan, mode="partial")
    exchange = tx.HostShuffleExchangeExec([tc.col("k")], partial, 4,
                                          RapidsConf())
    final = ta.AggregateExec([tc.col("k")], aggs, exchange, mode="final",
                             input_types=partial._input_types)
    want = [r for x in single.execute() for r in x.to_pylist()]
    got = [r for x in final.execute() for r in x.to_pylist()]
    # the lists' element order follows the partials' order: compare as
    # multisets
    assert _canon(got, (1, 2, 3, 4)) == _canon(want, (1, 2, 3, 4))


def test_planner_keeps_list_aggregates_single_partition():
    sess = tsession.TpuSession({"spark.rapids.sql.shuffle.partitions": "4"},
                               device="cpu")
    data = _data(0)
    df = sess.from_pydict(data, tt.Schema(tuple(
        tt.StructField(k, TYPES[k]) for k in data)))
    q = df.group_by("k").agg((tF.collect_list("v"), "l"))
    tree = tsession.TpuOverrides(sess.conf).apply(q.logical_plan())
    names = set()
    stack = [tree]
    while stack:
        n = stack.pop()
        names.add(type(n).__name__)
        stack.extend(n.children)
    assert "HostShuffleExchangeExec" not in names
    assert len(q.collect()) == len({k for k in data["k"]})
