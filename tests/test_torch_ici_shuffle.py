"""The host shuffle exchange's device lane (exec/exchange.py over
parallel/exchange.py) in the port, on a mesh of 4 CPU shards, against
its own host lane and the JAX package's lane on 4 virtual devices:

- a round-robin repartition of string, null and decimal128 payloads
  gives the host lane's rows in order, and the JAX package's;
- a shuffled join under an aggregate takes the lane with adaptive off
  (rounds, no fallback) and, at the default confs, stands down on the
  join's stream side as the JAX package does, with its fallback count;
- zero host serialize frames and zero shuffle-read uploads on the lane;
- staged shards are catalog entries tagged `ici_exchange` that spill and
  come back; abandoned partition streams release them;
- an injected `shuffle.ici_exchange` fault, before any round and in mid
  stream (the hybrid drain), gives the host lane's rows with one
  fallback and one exchange_stats record; a failing child stream raises
  with no fallback; failures open the `ici_exchange` breaker, which
  keeps the next exchange on the host lane;
- a struct's string field longer than every top-level string crosses
  whole (the round's width measure walks into the struct);
- each execution runs over the mesh active then (the port keeps no step
  cache: nothing compiles); eligibility (the partition count, range
  partitioning, array payloads);
- tpu.shuffle.devicePartition.enabled=false splits on the host with the
  device split's rows.
"""

import decimal
import gc

import numpy as np
import pytest

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JSession
from spark_rapids_tpu.shuffle import manager as jmanager

from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar import upload
from spark_rapids_tpu_torch.exec import lifecycle
from spark_rapids_tpu_torch.memory.catalog import buffer_catalog
from spark_rapids_tpu_torch.obs import events
from spark_rapids_tpu_torch.parallel.mesh import Mesh, set_active_mesh
from spark_rapids_tpu_torch.shuffle import manager as shuffle_mgr

from test_torch_jax_ref import jax_aliases, one_torch_thread

N = 4


@pytest.fixture(scope="module", autouse=True)
def _env():
    from spark_rapids_tpu.parallel.mesh import set_active_mesh as jset
    with jax_aliases(), one_torch_thread():
        yield
    set_active_mesh(None)
    jset(None)


@pytest.fixture(autouse=True)
def _clean():
    faults.install(None)
    lifecycle.reset_lifecycle()
    yield
    faults.install(None)
    lifecycle.reset_lifecycle()


def _conf(ici, extra=None):
    conf = {"spark.rapids.sql.shuffle.partitions": str(N),
            "spark.rapids.tpu.shuffle.planExchange": "false",
            "spark.rapids.sql.broadcastSizeThreshold": "-1",
            "spark.rapids.tpu.shuffle.ici.enabled": str(ici).lower()}
    conf.update(extra or {})
    return conf


def _ici(extra=None):
    return TpuSession(_conf(True, extra), device="cpu", mesh_devices=N)


def _host(extra=None):
    return TpuSession(_conf(False, extra), device="cpu", mesh_devices=N)


def _rich_data(n=300):
    rng = np.random.default_rng(16)
    return {
        "k": [int(x) for x in rng.integers(0, 20, n)],
        "v": [None if x % 11 == 0 else int(x)
              for x in rng.integers(-(10 ** 12), 10 ** 12, n)],
        "s": [None if x % 5 == 0 else ("värde-%d" % x) * (x % 4)
              for x in range(n)],
        "d": [None if x % 7 == 0 else float(x) * 0.5 for x in range(n)],
        "dec": [None if x % 6 == 0
                else decimal.Decimal(int(x) * 123456789).scaleb(-2)
                for x in rng.integers(0, 10 ** 6, n)],
    }


def _rich_schema(t):
    return t.Schema((t.StructField("k", t.LONG), t.StructField("v", t.LONG),
                     t.StructField("s", t.STRING),
                     t.StructField("d", t.DOUBLE),
                     t.StructField("dec", t.DecimalType(30, 2))))


def _repartition(sess, data=None, batch_rows=64, schema=None):
    data = data or _rich_data()
    return sess.from_pydict(data, schema or _rich_schema(tt),
                            batch_rows=batch_rows).repartition(N)


def _find_exchange(plan):
    if type(plan).__name__ == "HostShuffleExchangeExec":
        return plan
    for c in plan.children:
        found = _find_exchange(c)
        if found is not None:
            return found
    return None


def _delta(before, after):
    return {k: after[k] - before[k] for k in before}


def test_ici_repartition_matches_the_host_lane_and_jax():
    host = _repartition(_host()).collect()
    i0 = shuffle_mgr.ici_counters()
    ici = _repartition(_ici()).collect()
    d = _delta(i0, shuffle_mgr.ici_counters())
    assert d["rounds"] == d["host_reads"] > 0 and d["fallbacks"] == 0
    assert ici == host                            # equal in order
    j0 = jmanager.ici_counters()
    jrows = JSession(_conf(True), mesh_devices=N).from_pydict(
        _rich_data(), _rich_schema(jt), batch_rows=64).repartition(
        N).collect()
    jd = _delta(j0, jmanager.ici_counters())
    assert [tuple(r) for r in jrows] == ici
    assert jd["rounds"] == d["rounds"]


def _struct_payload(top_string, n=240):
    """Rows whose struct<string> field (30 to 60 bytes) is longer than any
    top-level string (at most 4 bytes), or than 8 bytes when there is no
    top-level string: the string width must cover the struct's child."""
    rng = np.random.default_rng(23)
    data = {"k": [int(x) for x in rng.integers(0, 20, n)],
            "st": [None if i % 9 == 0 else
                   {"name": None if i % 7 == 0
                    else "ü" * (i % 5) + "x" * (30 + i % 23), "n": i}
                   for i in range(n)]}
    fields = [tt.StructField("k", tt.LONG), tt.StructField("st", tt.StructType(
        (tt.StructField("name", tt.STRING), tt.StructField("n", tt.LONG))))]
    if top_string:
        data["s"] = [None if i % 6 == 0 else "ab" * (i % 3) for i in range(n)]
        fields.append(tt.StructField("s", tt.STRING))
    return data, tt.Schema(tuple(fields))


@pytest.mark.parametrize("top_string", [True, False])
def test_a_struct_string_longer_than_the_top_level_ones_crosses_whole(
        top_string):
    data, schema = _struct_payload(top_string)
    host = _repartition(_host(), data, 64, schema).collect()
    i0 = shuffle_mgr.ici_counters()
    ici = _repartition(_ici(), data, 64, schema).collect()
    d = _delta(i0, shuffle_mgr.ici_counters())
    assert d["rounds"] > 0 and d["fallbacks"] == 0
    assert ici == host
    names = sorted((r[1] or {}).get("name") or "" for r in ici)
    assert names == sorted((st or {}).get("name") or ""
                           for st in data["st"])


def test_the_jax_package_cannot_carry_the_struct_string_the_port_keeps():
    """ROADMAP C.5: the JAX package's lane aligns the byte capacities of
    top-level string columns only, so stacking shards whose struct
    strings differ in byte capacity raises (an empty shard is enough);
    and its measure covers top-level strings only, so a stack that did
    succeed would cut the struct's longer field. The port's lane carries
    it whole."""
    data, schema = _struct_payload(True)
    jschema = jt.Schema((jt.StructField("k", jt.LONG), jt.StructField(
        "st", jt.StructType((jt.StructField("name", jt.STRING),
                             jt.StructField("n", jt.LONG)))),
        jt.StructField("s", jt.STRING)))
    host = _repartition(_host(), data, 64, schema).collect()
    assert _repartition(_ici(), data, 64, schema).collect() == host
    with pytest.raises(ValueError, match="same shape"):
        JSession(_conf(True), mesh_devices=N).from_pydict(
            data, jschema, batch_rows=64).repartition(N).collect()


def _join_agg(sess, t=tt, fns=F):
    rng = np.random.default_rng(7)
    ldata = {"k": [int(x) for x in rng.integers(0, 20, 300)],
             "v": [int(x) for x in rng.integers(0, 50, 300)]}
    rdata = {"k": [int(x) for x in rng.integers(0, 20, 200)],
             "w": [["a", "bb", None, "dddd"][int(x)]
                   for x in rng.integers(0, 4, 200)]}
    left = sess.from_pydict(ldata, t.Schema((t.StructField("k", t.LONG),
                                             t.StructField("v", t.LONG))),
                            batch_rows=64)
    right = sess.from_pydict(rdata, t.Schema((t.StructField("k", t.LONG),
                                              t.StructField("w", t.STRING))),
                             batch_rows=64)
    return left.join(right, on="k").group_by("k").agg(
        (fns.sum(fns.col("v")), "sv"), (fns.count(), "c")).collect()


def test_ici_join_agg_takes_the_lane_with_adaptive_off():
    off = {"spark.rapids.tpu.adaptive.enabled": "false"}
    host = _join_agg(_host(off))
    i0 = shuffle_mgr.ici_counters()
    ici = _join_agg(_ici(off))
    d = _delta(i0, shuffle_mgr.ici_counters())
    # three exchanges (both join sides, the aggregate's), a round each,
    # twice: the speculative aggregate trips and collect() re-runs the
    # plan exact; the JAX package counts the same six
    assert d["rounds"] == 6 and d["fallbacks"] == 0
    assert ici == host


def test_ici_join_agg_stands_down_at_the_defaults_as_jax_does():
    spy = []
    real = events.emit

    def emit(kind, **fields):
        if kind == "ici_exchange" and fields.get("fallback"):
            spy.append(fields.get("reason"))
        return real(kind, **fields)
    events.emit, saved = emit, events.emit
    try:
        host = _join_agg(_host())
        i0 = shuffle_mgr.ici_counters()
        ici = _join_agg(_ici())
        d = _delta(i0, shuffle_mgr.ici_counters())
    finally:
        events.emit = saved
    j0 = jmanager.ici_counters()
    jrows = _join_agg(JSession(_conf(True), mesh_devices=N), jt, JF)
    jd = _delta(j0, jmanager.ici_counters())
    # the skew shield keeps the join's stream side off the lane
    assert (d["rounds"], d["fallbacks"]) == (jd["rounds"],
                                             jd["fallbacks"]) == (4, 2)
    assert spy == ["adaptive_skew_split"] * 2
    assert ici == host == [tuple(r) for r in jrows]


def test_ici_lane_writes_no_frame_and_uploads_nothing():
    sess = _ici()
    df = _repartition(sess)
    c0, i0, u0 = shuffle_mgr.counters(), shuffle_mgr.ici_counters(), \
        upload.counters()
    rows = df.collect()
    c1, i1, u1 = shuffle_mgr.counters(), shuffle_mgr.ici_counters(), \
        upload.counters()
    assert len(rows) == 300
    assert c1["frames"] == c0["frames"] and c1["bytes"] == c0["bytes"]
    assert u1["uploads"] == u0["uploads"]
    assert i1["rounds"] > i0["rounds"] and i1["bytes"] > i0["bytes"]


def _ici_bytes():
    return sum(buffer_catalog().bytes_by_origin().get("ici_exchange",
                                                      (0, 0)))


def test_staged_shards_spill_and_come_back():
    host = _repartition(_host()).collect()
    plan = _repartition(_ici())._exec()
    it = plan.execute()
    first = next(it)
    org = buffer_catalog().bytes_by_origin()
    assert sum(org["ici_exchange"]) > 0
    assert buffer_catalog().synchronous_spill(None) > 0
    assert buffer_catalog().bytes_by_origin()["ici_exchange"][0] == 0
    rows = [r for b in [first] + list(it) for r in b.to_pylist()]
    assert rows == host
    assert _ici_bytes() == 0


def test_abandoned_partition_streams_release_their_staged_shards():
    plan = _repartition(_ici())._exec()
    ex = _find_exchange(plan)
    base = _ici_bytes()
    outer = ex.execute_partitions()
    g0 = next(outer)                  # never started
    g1 = next(outer)
    next(g1)                          # partly drained, then abandoned
    assert _ici_bytes() > base
    del g0, g1
    outer.close()                     # partitions 2, 3 never handed out
    del outer
    gc.collect()
    assert _ici_bytes() == base


def test_an_injected_round_fault_falls_back_to_the_host_lane():
    host = _repartition(_host()).collect()
    i0 = shuffle_mgr.ici_counters()
    faults.install("shuffle.ici_exchange:prob=1,seed=3,kind=device,max=1")
    try:
        ici = _repartition(_ici()).collect()
    finally:
        faults.install(None)
    d = _delta(i0, shuffle_mgr.ici_counters())
    assert d["fallbacks"] == 1 and d["rounds"] == 0
    assert ici == host


def _midstream(extra=None):
    rng = np.random.default_rng(11)
    data = {"k": [int(x) for x in rng.integers(0, 9, 1200)],
            "v": [int(x) for x in rng.integers(-40, 40, 1200)]}
    schema = tt.Schema((tt.StructField("k", tt.LONG),
                        tt.StructField("v", tt.LONG)))
    # a small coalesce target keeps the 64-row batches apart: 19 map
    # batches, five rounds
    conf = dict({"spark.rapids.sql.batchSizeBytes": "4096"}, **(extra or {}))
    return lambda sess_of: _repartition(sess_of(conf), data, 64, schema)


def test_a_midstream_fault_drains_hybrid_with_one_stats_record():
    df_of = _midstream()
    host = df_of(_host).collect()
    plan = df_of(_ici)._exec()
    ex = _find_exchange(plan)
    orig = ex._ici_exchange_round

    def flaky(batches, rr_offs, round_idx):
        if round_idx >= 1:
            raise faults.InjectedDeviceError("shuffle.ici_exchange")
        return orig(batches, rr_offs, round_idx)
    ex._ici_exchange_round = flaky
    stats = []
    real = events.emit

    def emit(kind, **fields):
        if kind == "exchange_stats":
            stats.append(fields)
        return real(kind, **fields)
    events.emit, saved = emit, events.emit
    i0 = shuffle_mgr.ici_counters()
    try:
        rows = [r for b in plan.execute() for r in b.to_pylist()]
    finally:
        events.emit = saved
    d = _delta(i0, shuffle_mgr.ici_counters())
    assert d["rounds"] == 1 and d["fallbacks"] == 1
    assert rows == host
    assert len(stats) == 1 and stats[0]["maps"] == 19
    assert stats[0]["rows"] == 1200
    assert _ici_bytes() == 0


def test_a_child_stream_error_propagates_without_a_fallback():
    plan = _midstream()(_ici)._exec()
    ex = _find_exchange(plan)
    orig = ex.child.execute

    def flaky_child():
        for i, b in enumerate(orig()):
            if i >= N + 1:              # past round 0: shards staged
                raise faults.InjectedDeviceError("upstream.compute")
            yield b
    ex.child.execute = flaky_child
    base = _ici_bytes()
    i0 = shuffle_mgr.ici_counters()
    with pytest.raises(faults.InjectedDeviceError):
        list(plan.execute())
    d = _delta(i0, shuffle_mgr.ici_counters())
    assert d["fallbacks"] == 0 and d["rounds"] == 1
    assert _ici_bytes() == base


def test_round_failures_open_the_breaker_and_the_next_exchange_stays_home():
    breaker = {"spark.rapids.tpu.breaker.enabled": "true",
               "spark.rapids.tpu.breaker.threshold": "1",
               "spark.rapids.tpu.breaker.cooldownMs": "600000"}
    host = _repartition(_host()).collect()
    faults.install("shuffle.ici_exchange:prob=1,seed=3,kind=device,max=1")
    try:
        assert _repartition(_ici(breaker)).collect() == host
    finally:
        faults.install(None)
    assert lifecycle.open_breakers() == ["ici_exchange"]
    i0, c0 = shuffle_mgr.ici_counters(), shuffle_mgr.counters()
    assert _repartition(_ici(breaker)).collect() == host
    d = _delta(i0, shuffle_mgr.ici_counters())
    assert d["rounds"] == d["fallbacks"] == 0
    assert shuffle_mgr.counters()["frames"] > c0["frames"]


def test_the_step_cache_keys_on_the_mesh_identity():
    """The JAX package caches a compiled step per grid shape and mesh;
    the port compiles nothing, so each round calls exchange_columns over
    the mesh active when the execution starts: a later mesh of the same
    size is the one the next execution runs over."""
    df = _repartition(_ici(), _rich_data(80))
    plan = df._exec()
    ex = _find_exchange(plan)
    first = [r for b in plan.execute() for r in b.to_pylist()]
    mesh0 = ex._ici_mesh
    other = Mesh(["cpu"] * N)
    assert other == mesh0 and other is not mesh0
    set_active_mesh(other)
    i0 = shuffle_mgr.ici_counters()
    again = [r for b in plan.execute() for r in b.to_pylist()]
    assert ex._ici_mesh is other
    assert _delta(i0, shuffle_mgr.ici_counters())["rounds"] > 0
    assert again == first


@pytest.mark.parametrize("case", ["partition count", "range", "array"])
def test_ineligible_exchanges_keep_the_host_lane(case):
    i0, c0 = shuffle_mgr.ici_counters(), shuffle_mgr.counters()
    if case == "partition count":
        three = {"spark.rapids.sql.shuffle.partitions": "3"}

        def agg(sess):
            return sorted(sess.from_pydict(
                _rich_data(), _rich_schema(tt), batch_rows=64).group_by(
                "k").agg((F.count(), "c")).collect())
        want = agg(_host(three))
        i0, c0 = shuffle_mgr.ici_counters(), shuffle_mgr.counters()
        assert agg(_ici(three)) == want
    elif case == "range":
        sess = _ici()
        rows = sess.from_pydict(_rich_data(), _rich_schema(tt),
                                batch_rows=64).sort("k").collect()
        assert [r[0] for r in rows] == sorted(r[0] for r in rows)
    else:
        data = {"k": list(range(60)), "a": [[x, x + 1] for x in range(60)]}
        schema = tt.Schema((tt.StructField("k", tt.LONG),
                            tt.StructField("a", tt.ArrayType(tt.LONG))))
        host = _repartition(_host(), data, 16, schema).collect()
        i0, c0 = shuffle_mgr.ici_counters(), shuffle_mgr.counters()
        rows = _repartition(_ici(), data, 16, schema).collect()
        assert rows == host
    d = _delta(i0, shuffle_mgr.ici_counters())
    assert d["rounds"] == 0 and d["fallbacks"] == 0
    assert shuffle_mgr.counters()["frames"] > c0["frames"]


@pytest.mark.parametrize("mode", ["hash", "roundrobin", "single"])
def test_device_partition_off_splits_on_the_host_with_the_same_rows(mode):
    from spark_rapids_tpu_torch.exec import basic as tbasic
    from spark_rapids_tpu_torch.exec import exchange as texchange
    from spark_rapids_tpu_torch.config import RapidsConf
    from spark_rapids_tpu_torch.expr import core as tcore
    sess = TpuSession(device="cpu")
    set_active_mesh(None)
    batches = sess.from_pydict(_rich_data(), _rich_schema(tt),
                               batch_rows=64)._batches()
    out = {}
    for split in ("true", "false"):
        conf = RapidsConf({
            "spark.rapids.tpu.shuffle.devicePartition.enabled": split,
            "spark.rapids.tpu.adaptive.enabled": "false"})
        ex = texchange.HostShuffleExchangeExec(
            [tcore.col("k")] if mode == "hash" else [],
            tbasic.InMemoryScanExec(batches, batches[0].schema), N, conf,
            partitioning=mode)
        assert ex._device_partition == (split == "true")
        out[split] = [[r for b in part for r in b.to_pylist()]
                      for part in ex.execute_partitions()]
        assert ex.metrics[texchange.NUM_REORDER_GATHERS].value == (
            0 if split == "false" or mode == "single" else len(batches))
    assert out["false"] == out["true"]
    assert sum(len(p) for p in out["true"]) == 300
