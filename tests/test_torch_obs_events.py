"""obs/events.py: the event kinds and levels are the JAX package's plus
the port's `kernel_failure`; the query-level event sequence of one planned query is
the JAX package's exactly. Port-only: records carry the query id and the
emitting thread's name, levels filter, the file rotates at maxBytes,
configure() keeps or tears down the process bus as the JAX package's
does, pipeline producers and shuffle pool threads carry the query id,
and a disabled bus writes nothing."""

import json
import threading

import pytest

from spark_rapids_tpu.obs import events as jevents
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.obs import events as tevents

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs
from test_torch_task_retry import _q3

#: kinds of the stall watchdog, the speculative sub-reads, dispatch
#: timeouts, the shuffle's lineage recovery and dead-peer invalidation
SHIELD_KINDS = {"query_stalled", "speculative_fetch", "dispatch_timeout",
                "map_output_invalidated", "partition_recompute"}
PORT_ONLY = {"kernel_failure"}


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield
    jevents.reset_event_bus()
    tevents.reset_event_bus()


def test_event_levels_match_jax():
    ref = dict(jevents.EVENT_LEVELS)
    port = {k: v for k, v in tevents.EVENT_LEVELS.items()
            if k not in PORT_ONLY}
    assert port == ref
    assert SHIELD_KINDS <= set(tevents.EVENT_LEVELS)
    assert (tevents.ESSENTIAL, tevents.MODERATE, tevents.DEBUG) == \
        (jevents.ESSENTIAL, jevents.MODERATE, jevents.DEBUG)


def _records(events_mod):
    bus = events_mod.active_bus()
    out = []
    for path in getattr(bus, "paths", [bus.path]):
        with open(path) as f:
            out.extend(json.loads(line) for line in f)
    return out


def test_query_level_sequence_matches_jax(tmp_path):
    conf = {"spark.rapids.tpu.agg.speculative.enabled": "false",
            "spark.rapids.tpu.eventLog.enabled": "true",
            "spark.rapids.tpu.eventLog.level": "ESSENTIAL"}
    jdf, _ = _q3(dict(conf, **{"spark.rapids.tpu.eventLog.dir":
                               str(tmp_path / "jax")}))
    _, tdf = _q3(dict(conf, **{"spark.rapids.tpu.eventLog.dir":
                               str(tmp_path / "torch")}))
    seqs = []
    for df, m in ((jdf, jevents), (tdf, tevents)):
        df.collect()
        recs = _records(m)
        seqs.append([(r["kind"], r.get("ok"), r.get("root"),
                      r.get("attempts")) for r in recs])
        assert len({r["query"] for r in recs}) == 1
        m.reset_event_bus()
    assert seqs[1] == seqs[0]
    assert [k for k, *_ in seqs[1]] == ["query_start", "query_end",
                                        "query_phases"]


def test_records_levels_and_rotation(tmp_path):
    bus = tevents.enable(str(tmp_path), "MODERATE", max_bytes=300)
    with tevents.query_scope() as qid:
        for i in range(10):
            tevents.emit("exchange", i=i)
        tevents.emit("op_batch", i=99)  # DEBUG: filtered at MODERATE

        def other():
            tevents.emit("spill", bytes=1)

        t = threading.Thread(target=other, name="spill-writer")
        t.start()
        t.join(timeout=10)
    recs = tevents.read_events(bus)
    assert [r["i"] for r in recs if r["kind"] == "exchange"] == \
        list(range(10))
    assert all(r["query"] == qid and r["thread"] == "MainThread"
               for r in recs if r["kind"] == "exchange")
    spill = next(r for r in recs if r["kind"] == "spill")
    assert spill["thread"] == "spill-writer" and spill["query"] is None
    assert not any(r["kind"] == "op_batch" for r in recs)
    assert len(bus.paths) > 1  # rotated at 300 bytes
    tevents.reset_event_bus()


def test_configure_keeps_or_tears_down_the_bus(tmp_path):
    on = RapidsConf({"spark.rapids.tpu.eventLog.enabled": "true",
                     "spark.rapids.tpu.eventLog.dir": str(tmp_path)})
    bus = tevents.configure(on)
    assert tevents.configure(on) is bus
    assert tevents.configure(RapidsConf()) is bus  # unset: kept
    assert tevents.configure(RapidsConf(
        {"spark.rapids.tpu.eventLog.enabled": "false"})) is None
    assert tevents.active_bus() is None
    tevents.emit("query_start")  # off: nothing written
    assert list(tmp_path.iterdir()) == []


def test_shuffle_and_pipeline_threads_carry_the_query(tmp_path):
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.types import (LONG, DOUBLE, Schema,
                                              StructField)
    sess = TpuSession({"spark.rapids.tpu.eventLog.enabled": "true",
                       "spark.rapids.tpu.eventLog.dir": str(tmp_path),
                       "spark.rapids.sql.shuffle.partitions": "4",
                       "spark.rapids.sql.broadcastSizeThreshold": "-1"},
                      device="cpu")
    schema = Schema([StructField("k", LONG), StructField("v", DOUBLE)])
    df = sess.from_pydict({"k": [1, 2, 1, 3] * 8,
                           "v": [1.0, 2.0, 3.0, 4.0] * 8}, schema,
                          batch_rows=8)
    assert sorted(df.group_by("k").agg(F.sum("v")).collect()) == [
        (1, 32.0), (2, 16.0), (3, 32.0)]
    recs = _records(tevents)
    qids = {r["query"] for r in recs}
    assert len(qids) == 1 and None not in qids
    threads = {r["thread"] for r in recs}
    assert any(t.startswith("pipeline-") for t in threads)
    kinds = {r["kind"] for r in recs}
    assert {"exchange", "shuffle_write", "exchange_stats", "op_close",
            "pipeline_wait", "query_phases"} <= kinds
    tevents.reset_event_bus()
