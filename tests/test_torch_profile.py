"""obs/profile.py and exec/task_metrics.py: the QueryProfile of one
planned query (q3 at the exact tier, the JAX package's stage fusion off,
so both packages execute the same tree) has the JAX package's node names
in the same shape, and per node the same metric names less the ones one
package records and the other does not (`REF_ONLY`: the JAX package's
per-operator op time, batch count and dispatch/gather instrumentation;
`PORT_ONLY`: the port's merge and hash-route counters), exactly. The
renderers work, `top_operators` ranks by time, `statistics` gives
selectivities, the task summary carries the semaphore wait, retries and
spill volumes, and `phases()` sums to its wall."""

import json

import pytest

import chip_smoke as cs

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs, q3_oracle
from test_torch_task_retry import _q3

#: metrics the JAX package's execs record that the port's do not
REF_ONLY = {"opTime", "numOutputBatches", "numDispatches", "compileTimeNs",
            "gatherTimeNs", "numGathers", "concatTime"}
#: the port's own counters (the sort's merge passes and host reads, the
#: hash route's rounds and its sort fallback)
PORT_ONLY = ("mergeHostReads", "mergePasses", "hash_rounds_",
             "sort_fallback")

CONF = {"spark.rapids.tpu.agg.speculative.enabled": "false",
        "spark.rapids.tpu.stage.fusion.enabled": "false"}


@pytest.fixture(scope="module")
def profiles():
    with jax_aliases(), active_confs(), one_torch_thread():
        jdf, tdf = _q3(CONF)
        out = []
        for df in (jdf, tdf):
            rows = df.collect()
            out.append((rows, df.session.last_query_profile()))
        yield out


def _names(node):
    return {n for n in node["metrics"] if not n.startswith(PORT_ONLY)} \
        - REF_ONLY


def test_node_and_metric_names_match_jax(profiles):
    (_, jp), (rows, tp) = profiles
    cs.check_q3(rows, q3_oracle(), "q3")

    def walk(a, b):
        assert a["op"] == b["op"]
        assert _names(a) == _names(b), a["op"]
        assert len(a["children"]) == len(b["children"])
        for x, y in zip(a["children"], b["children"]):
            walk(x, y)

    walk(jp.tree, tp.tree)


def test_renderers_and_rollups(profiles):
    _, (rows, p) = profiles
    text = p.text()
    assert text.startswith("== TPU Query Profile ==")
    assert "HashJoinExec" in text and "task: semWaitTimeNs=" in text
    d = json.loads(p.to_json())
    assert d["plan"]["op"] == "TopNExec"
    assert sum(d["phases"].values()) == d["phases_wall_ns"]
    top = p.top_operators(3)
    assert len(top) == 3
    assert [r["time_ns"] for r in top] == sorted(
        (r["time_ns"] for r in top), reverse=True)
    stats = p.statistics()
    assert stats["exchanges"] == {}  # one partition: no shuffle
    join = next(r for r in stats["operators"] if r["op"] == "HashJoinExec")
    assert join["rows_out"] > 0 and join["rows_in"] > join["rows_out"]
    for k in ("semWaitTimeNs", "retryCount", "splitAndRetryCount",
              "spilledDeviceBytes", "spilledHostBytes"):
        assert k in p.summary
    assert p.summary["total.numOutputRows"] > 0
    assert p.summary["ops.TopNExec.numOutputRows"] == len(rows)
    ph = p.phases()
    assert sum(ph.values()) == p.phases_wall_ns()
    assert ph["device-compute"] > 0
