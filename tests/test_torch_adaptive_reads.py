"""The host exchange's adaptive read plan (exec/exchange.py,
exec/adaptive.py) against the JAX package's, on the CPU, from the same
seeded numpy map batches (the JAX package's own tests read Parquet):

- the skew split on the JAX package's zipf shape (2,400 rows, 80 % on
  one key, 4 partitions, 256-row map batches as a 4 KiB batch target
  gives them, skewedPartitionMinBytes 1024): every partition's rows in
  order equal the split-off run and the reference's, and the decisions
  are the reference's field for field (partition, bytes, threshold,
  median, subs, max_sub_bytes) — the serializer's frames are the
  reference's byte for byte, so the measured bytes are equal; a shuffled
  join over the split stream side gives the reference's rows in order;
- coalescing merges the flat stream's small partitions into the
  reference's reads and leaves a partition-aware consumer's boundaries;
- a shuffled join whose build side measures under
  adaptive.autoBroadcastMaxBytes converts to one single-build pass, with
  the reference's decision and rows in the same order;
- batch right-sizing: note_oom_split halves a governed query's batch
  target to the reference's floor, and CoalesceBatchesExec flushes at it.
"""

import numpy as np
import pytest

from spark_rapids_tpu import config as jconfig
from spark_rapids_tpu.exec import adaptive as jadaptive
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import exchange as jexchange
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.obs import events as jevents

from spark_rapids_tpu_torch import config as tconfig
from spark_rapids_tpu_torch.exec import adaptive as tadaptive
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import exchange as texchange
from spark_rapids_tpu_torch.exec import lifecycle as tlifecycle
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.obs import events as tevents
from spark_rapids_tpu_torch.shuffle import manager as tmanager

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs

#: the JAX package's zipf drive (tests/test_adaptive.py BASE), at the
#: exchange: the split alone (no conversion, no coalescing)
SPLIT = {"spark.rapids.tpu.adaptive.skewedPartitionMinBytes": "1024",
         "spark.rapids.tpu.adaptive.autoBroadcastMaxBytes": "-1",
         "spark.rapids.tpu.adaptive.coalesceTargetBytes": "0"}
OFF = {"spark.rapids.tpu.adaptive.enabled": "false"}
N, HOT, ROWS_PER_MAP, PARTS = 2400, 0.8, 256, 4


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def _fresh(tmp_path):
    mgr = tmanager.reset_shuffle_manager(str(tmp_path))
    tadaptive.reset_adaptive()
    jadaptive.reset_adaptive()
    yield
    assert mgr.registered() == 0


@pytest.fixture
def spy(monkeypatch):
    """Both packages' adaptive_replan events, without the op ids."""
    seen = {"jax": [], "port": []}
    for name, mod in (("jax", jevents), ("port", tevents)):
        real = mod.emit

        def emit(kind, _real=real, _name=name, **fields):
            if kind == "adaptive_replan":
                seen[_name].append({k: v for k, v in fields.items()
                                    if k != "op_id"})
            return _real(kind, **fields)
        monkeypatch.setattr(mod, "emit", emit)
    return seen


def _zipf_scans(seed=7):
    """(JAX scan, port scan) of the fact side as 256-row map batches."""
    rng = np.random.default_rng(seed)
    hot = rng.random(N) < HOT
    k = np.where(hot, 0, rng.integers(0, 64, N)).astype(np.int64)
    v = rng.integers(0, 1000, N).astype(np.int64)
    js, ts = [], []
    for i in range(0, N, ROWS_PER_MAP):
        n = min(ROWS_PER_MAP, N - i)
        jb, tb = both_batch({"k": (k[i:i + n], "LONG", None),
                             "v": (v[i:i + n], "LONG", None)}, n)
        js.append(jb)
        ts.append(tb)
    return (jbasic.InMemoryScanExec(js, js[0].schema),
            tbasic.InMemoryScanExec(ts, ts[0].schema))


def _dim_scans():
    rk = np.arange(64, dtype=np.int64)
    jb, tb = both_batch({"rk": (rk, "LONG", None),
                         "w": (rk * 10, "LONG", None)}, 64)
    return (jbasic.InMemoryScanExec([jb], jb.schema),
            tbasic.InMemoryScanExec([tb], tb.schema))


def _exchanges(settings, scans, n_parts=PARTS, key="k"):
    js, ts = scans
    return (jexchange.HostShuffleExchangeExec(
                [jcore.col(key)], js, n_parts, jconfig.RapidsConf(settings)),
            texchange.HostShuffleExchangeExec(
                [tcore.col(key)], ts, n_parts, tconfig.RapidsConf(settings)))


def _partitions(ex):
    return [[r for b in part for r in b.to_pylist()]
            for part in ex.execute_partitions()]


def test_skew_split_matches_jax_field_for_field(spy):
    jex, tex = _exchanges(SPLIT, _zipf_scans())
    want, got = _partitions(jex), _partitions(tex)
    assert got == want and len(got) == PARTS
    assert spy["port"] == spy["jax"]
    splits = [e for e in spy["port"] if e["decision"] == "skew_split"]
    assert splits
    for e in splits:
        assert e["bytes"] > e["threshold"] >= e["median_bytes"]
        assert e["subs"] >= 2 and e["max_sub_bytes"] <= e["threshold"]
    tc, jc = tadaptive.counters(), jadaptive.counters()
    assert tc["skew_splits"] == jc["skew_splits"] == len(splits)
    # the split regroups the same frames: the static read's rows in order
    spy["port"].clear()
    _, off = _exchanges(OFF, _zipf_scans())
    assert _partitions(off) == got and not spy["port"]


def _skew_join(settings, build_side="right"):
    out = []
    fact, dim = _zipf_scans(), _dim_scans()
    for i, (m, core, conf) in enumerate((
            (jexchange, jcore, jconfig.RapidsConf(settings)),
            (texchange, tcore, tconfig.RapidsConf(settings)))):
        lex = m.HostShuffleExchangeExec([core.col("k")], fact[i], PARTS,
                                        conf)
        rex = m.HostShuffleExchangeExec([core.col("rk")], dim[i], PARTS,
                                        conf)
        out.append(m.ShuffledHashJoinExec(lex, rex, [core.col("k")],
                                          [core.col("rk")], "inner",
                                          build_side=build_side))
    return out


@pytest.mark.parametrize("settings", [SPLIT, {}], ids=["split", "default"])
def test_shuffled_join_decisions_and_rows_match_jax(spy, settings):
    """The split arms the stream side (rows in the reference's order);
    at the default confs the 64-row build side converts the join to one
    single-build pass in both packages."""
    jplan, tplan = _skew_join(settings)
    want = [r for b in jplan.execute() for r in b.to_pylist()]
    got = [r for b in tplan.execute() for r in b.to_pylist()]
    assert got == want and len(got) == N
    assert spy["port"] == spy["jax"]
    kinds = {e["decision"] for e in spy["port"]}
    if settings:
        assert "skew_split" in kinds and tplan.metrics[
            "numPartitionPairs"].value >= 1
    else:
        conv = [e for e in spy["port"]
                if e["decision"] == "single_build_convert"]
        assert len(conv) == 1
        assert conv[0]["measured_bytes"] <= conv[0]["threshold"] == 64 << 20
        # the stream exchange is skipped: nothing written or read there
        assert tplan.children[0].metrics["numInputBatches"].value == 0
        assert tplan.metrics["numPartitionPairs"].value == 1
    assert tadaptive.counters() == jadaptive.counters()


def test_coalesce_flat_consumers_only(spy):
    def scans():
        out = [], []
        for i in range(2):
            jb, tb = both_batch({"k": (np.arange(64, dtype=np.int64),
                                       "LONG", None),
                                 "v": (np.arange(i * 64, (i + 1) * 64,
                                                 dtype=np.int64),
                                       "LONG", None)}, 64)
            out[0].append(jb)
            out[1].append(tb)
        return (jbasic.InMemoryScanExec(out[0], out[0][0].schema),
                tbasic.InMemoryScanExec(out[1], out[1][0].schema))

    conf = {"spark.rapids.tpu.adaptive.coalesceTargetBytes": "1m"}
    jex, tex = _exchanges(conf, scans(), n_parts=8)
    want = [r for b in jex.internal_execute() for r in b.to_pylist()]
    got = [r for b in tex.internal_execute() for r in b.to_pylist()]
    assert got == want and len(got) == 128
    assert spy["port"] == spy["jax"]
    ev = [e for e in spy["port"] if e["decision"] == "partition_coalesce"]
    assert len(ev) == 1 and ev[0]["reads"] < ev[0]["partitions"] == 8
    # a partition-aware consumer keeps the 8 static boundaries
    spy["port"].clear()
    _, tex2 = _exchanges(conf, scans(), n_parts=8)
    parts = _partitions(tex2)
    assert len(parts) == 8 and not spy["port"]
    assert sorted(r for p in parts for r in p) == sorted(got)


def test_note_oom_split_halves_the_target_and_coalesce_honours_it(spy):
    from spark_rapids_tpu.exec import lifecycle as jlifecycle
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.exec.coalesce import CoalesceBatchesExec
    from spark_rapids_tpu_torch.types import LONG, Schema, StructField
    assert tadaptive.batch_target_override() is None
    tadaptive.note_oom_split()  # no governed query: a no-op
    settings = {"spark.rapids.sql.batchSizeBytes": "32k"}
    targets = []
    for conf_mod, life, ad in ((jconfig, jlifecycle, jadaptive),
                               (tconfig, tlifecycle, tadaptive)):
        conf = conf_mod.RapidsConf(settings)
        conf_mod.set_active_conf(conf)
        with life.governed(conf) as ctx:
            seq = []
            for _ in range(4):
                ad.note_oom_split()
                seq.append(ctx.adaptive_batch_target)
            for _ in range(10):
                ad.note_oom_split()
            seq.append(ctx.adaptive_batch_target)
            targets.append(seq)
        conf_mod.set_active_conf(conf_mod.RapidsConf())
    assert targets[0] == targets[1] == [16384, 8192, 4096, 4096, 4096]
    assert spy["port"] == spy["jax"]
    assert tadaptive.batch_target_override() is None
    # CoalesceBatchesExec flushes at the halved target: 8 batches of
    # 2,048 rows (about 18 KB each at capacity) under a 1 MiB conf target
    # come out one by one once the target is 8 KiB
    schema = Schema((StructField("k", LONG),))
    batches = [ColumnarBatch.from_numpy_columns(
        [(np.arange(2048, dtype=np.int64), np.ones(2048, np.bool_))],
        schema, 2048, device="cpu")
        for _ in range(8)]
    conf = tconfig.RapidsConf({"spark.rapids.sql.batchSizeBytes": "1m"})
    tconfig.set_active_conf(conf)
    try:
        plain = list(CoalesceBatchesExec(
            tbasic.InMemoryScanExec(batches, schema)).execute())
        with tlifecycle.governed(conf) as ctx:
            ctx.adaptive_batch_target = 8192
            small = list(CoalesceBatchesExec(
                tbasic.InMemoryScanExec(batches, schema)).execute())
    finally:
        tconfig.set_active_conf(tconfig.RapidsConf())
    assert len(plain) == 1 and len(small) == 8
    assert sum(b.num_rows_host for b in small) == 8 * 2048
