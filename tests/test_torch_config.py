"""The conf registry: the port's config.py against the JAX package's.

Same keys, defaults, docs, flags and converters (each converter on the
same raw strings gives the same value); the same keys rejected; the same
generated docs but for the module path. An entry the port does not read
is in config._UNREAD with its ROADMAP item, and the module docstring's
table lists it; a value of such an entry that the port cannot honour
raises NotImplementedError naming the item, and the values it does
honour are accepted. The wired modules read their confs from the
session's conf, also on the pipeline's producer thread and for the
shuffle's pools.
"""

import pathlib
import re
import threading

import pytest

from spark_rapids_tpu import config as jconfig
from spark_rapids_tpu_torch import config as tconfig
from spark_rapids_tpu_torch.api import session as tsession

from test_torch_planner import active_confs

PORT = pathlib.Path(tconfig.__file__).parent
RAW = {"_bool": ("true", "false", "1", "no"), "int": ("7", "-1"),
       "float": ("0.5", "2"), "str": ("x", "MULTITHREADED"),
       "_bytes": ("64m", "1g", "512", "1.5k")}


@pytest.fixture(autouse=True)
def _confs():
    with active_confs():
        yield


def test_registry_matches_jax():
    assert set(tconfig._REGISTRY) == set(jconfig._REGISTRY)
    assert len(tconfig._REGISTRY) == 99
    for key, j in jconfig._REGISTRY.items():
        t = tconfig._REGISTRY[key]
        assert (t.default, t.doc, t.internal, t.startup_only,
                t.commonly_used, t.conv.__name__) == \
            (j.default, j.doc, j.internal, j.startup_only,
             j.commonly_used, j.conv.__name__), key
        for raw in RAW[j.conv.__name__]:
            assert t.conv(raw) == j.conv(raw), (key, raw)
        assert t.get(tconfig.RapidsConf()) == j.get(jconfig.RapidsConf())


def test_generated_docs_match_jax():
    port = tconfig.generate_docs()
    assert port.replace("spark_rapids_tpu_torch", "spark_rapids_tpu") == \
        jconfig.generate_docs()
    assert "`spark_rapids_tpu_torch/config.py`" in port


@pytest.mark.parametrize("key", ["spark.rapids.sql.noSuchKey",
                                 "spark.rapids.tpu.agg.bucketslots"])
def test_unknown_keys_raise_in_both(key):
    for conf in (jconfig.RapidsConf, tconfig.RapidsConf):
        with pytest.raises(KeyError, match="unknown config"):
            conf({key: "1"})


def test_dynamic_prefixes_and_foreign_keys_are_accepted():
    settings = {"spark.rapids.sql.exec.FilterExec": "false",
                "spark.rapids.sql.expression.Add": "false",
                "spark.rapids.sql.input.ParquetScan": "true",
                "spark.rapids.sql.format.parquet.enabled": "true",
                "spark.sql.shuffle.partitions": "200"}
    jconfig.RapidsConf(settings)
    tconfig.RapidsConf(settings)


@pytest.mark.parametrize("key, value, item", [
    ("spark.rapids.tpu.pallas.enabled", "false", "no tier switch"),
    ("spark.rapids.tpu.pallas.fusedTier", "off", "no tier switch"),
    ("spark.rapids.tpu.shuffle.ici.enabled", "true", "A.6"),
    ("spark.rapids.tpu.shuffle.devicePartition.enabled", "false", "A.6"),
    ("spark.rapids.sql.optimizer.enabled", "true", "A.8 wave 4"),
    ("spark.rapids.sql.udfCompiler.enabled", "true", "A.8 wave 4"),
    ("spark.rapids.tpu.eventLog.enabled", "true", "A.9"),
    ("spark.rapids.tpu.workload.enabled", "true", "A.9"),
    ("spark.rapids.tpu.query.timeoutMs", "1000", "A.9"),
    ("spark.rapids.tpu.task.maxAttempts", "2", "A.9"),
    ("spark.rapids.tpu.stage.programCache.maxSites", "8", "A.1.4"),
    ("spark.rapids.sql.format.parquet.datetimeRebaseModeInRead", "LEGACY",
     "A.8"),
])
def test_values_the_port_cannot_honour_raise_naming_their_item(key, value,
                                                                item):
    jconfig.RapidsConf({key: value})  # the JAX package takes them all
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        tconfig.RapidsConf({key: value})
    with pytest.raises(NotImplementedError):
        tsession.TpuSession({key: value}, device="cpu")


@pytest.mark.parametrize("key, value", [
    ("spark.rapids.tpu.adaptive.enabled", "false"),
    ("spark.rapids.tpu.task.partitionRecovery.enabled", "false"),
    ("spark.rapids.tpu.stage.fusion.enabled", "false"),
    ("spark.rapids.tpu.stage.fusion.enabled", "true"),
    ("spark.rapids.tpu.task.maxAttempts", "1"),
    ("spark.rapids.tpu.pallas.fusedTier", "on"),
    ("spark.rapids.tpu.phases.enabled", "false"),
    ("spark.rapids.tpu.eventLog.enabled", "false"),
    ("spark.rapids.sql.decimalType.enabled", "false"),
    ("spark.rapids.sql.explain", "ALL"),
])
def test_values_the_port_honours_are_accepted(key, value):
    tconfig.RapidsConf({key: value})


def test_every_entry_is_read_or_listed_with_its_item():
    sources = "\n".join(p.read_text() for p in PORT.rglob("*.py")
                        if p.name != "config.py")
    doc = tconfig.__doc__
    for name, entry in vars(tconfig).items():
        if not isinstance(entry, tconfig.ConfEntry):
            continue
        if entry.key in tconfig._UNREAD:
            item, _ = tconfig._UNREAD[entry.key]
            assert item == "none" or "ROADMAP" in item, entry.key
            assert entry.key.removeprefix("spark.rapids.") in \
                _table_keys(doc), entry.key
            assert not re.search(rf"\b{name}\b", sources), \
                f"{name} is read: drop it from _UNREAD"
        else:
            assert re.search(rf"\b{name}\b", sources), \
                f"{name} has no reader and no item"


def _table_keys(doc):
    """The keys of the docstring's table, `a.{b,c}` expanded."""
    keys = set()
    for cell in re.findall(r"`([a-z][\w.{},]*)`", doc):
        m = re.match(r"(.*)\{([^}]*)\}(.*)", cell)
        if m:
            keys.update(m.group(1) + part + m.group(3)
                        for part in m.group(2).split(","))
        else:
            keys.add(cell)
    return keys


def test_wired_modules_read_the_sessions_conf(tmp_path):
    from spark_rapids_tpu_torch.exec import aggregate, pipeline
    from spark_rapids_tpu_torch.exec.basic import InMemoryScanExec
    from spark_rapids_tpu_torch.exec.sort import SortExec
    from spark_rapids_tpu_torch.expr.core import col
    from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
    from spark_rapids_tpu_torch.shuffle import manager
    from spark_rapids_tpu_torch import functions as F, types as t
    sess = tsession.TpuSession({
        "spark.rapids.tpu.agg.bucketSlots": "16",
        "spark.rapids.tpu.agg.bucketRounds": "3",
        "spark.rapids.tpu.agg.speculative.enabled": "false",
        "spark.rapids.shuffle.multiThreaded.writer.threads": "3",
        "spark.rapids.shuffle.multiThreaded.reader.threads": "2",
        "spark.rapids.tpu.pipeline.depth": "5",
        "spark.rapids.sql.concurrentGpuTasks": "3",
        "spark.rapids.sql.sort.outOfCore.enabled": "false",
        "spark.rapids.sql.batchSizeBytes": "4096"}, device="cpu")
    schema = t.Schema((t.StructField("k", t.LONG),))
    scan = InMemoryScanExec([], schema, device="cpu")
    agg = aggregate.AggregateExec([col("k")], [(F.count(), "n")], scan)
    assert (agg._slots, agg._rounds, agg._spec_enabled) == (16, 3, False)
    assert not SortExec([col("k")], scan)._ooc_enabled
    assert TpuSemaphore().permits == 3
    assert pipeline.pipeline_depth() == 5
    # the producer thread of a stage sees the conf its consumer built it
    # under
    seen = []

    def source():
        seen.append((threading.current_thread().name,
                     tconfig.active_conf()))
        yield 1
    stage = pipeline.pipelined(source())
    assert list(stage) == [1]
    stage.close()
    assert seen[0][0].startswith("pipeline-") and seen[0][1] is sess.conf
    # the shuffle manager's pools, sized from the exchange's conf
    manager.reset_shuffle_manager(str(tmp_path))
    try:
        df = sess.from_pydict({"k": list(range(300))}, schema,
                              batch_rows=100).repartition(4)
        assert sorted(r[0] for r in df.collect()) == list(range(300))
        mgr = manager.shuffle_manager()
        assert mgr._writer_pool._max_workers == 3
        assert mgr._reader_pool._max_workers == 2
        coalesce = [n for n in _nodes(tsession.TpuOverrides(
            sess.conf).apply(df.logical_plan()))
            if type(n).__name__ == "CoalesceBatchesExec"]
        assert [c.target_bytes for c in coalesce] == [4096]
    finally:
        manager.reset_shuffle_manager()


def _nodes(node):
    out = [node]
    for c in node.children:
        out.extend(_nodes(c))
    return out


def test_executor_plugin_validates_and_classifies():
    """The executor plugin refuses a machine without a compute-capability
    9.0 card, and kills the executor for sticky CUDA errors only."""
    import torch
    from spark_rapids_tpu_torch import plugin
    from spark_rapids_tpu_torch.memory.retry import (TpuRetryOOM,
                                                     TpuSplitAndRetryOOM)
    exits = []
    ex = plugin.TpuExecutorPlugin(tconfig.RapidsConf(), exit_fn=exits.append)
    if not torch.cuda.is_available():
        with pytest.raises(plugin.FatalDeviceError):
            ex.init()
    classify = plugin.TpuExecutorPlugin._classify_fatal
    assert not classify(TpuRetryOOM("x"))
    assert not classify(TpuSplitAndRetryOOM("x"))
    assert not classify(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert not classify(RuntimeError("an ordinary failure"))
    assert not classify(ValueError("bad input"))
    assert classify(plugin.FatalDeviceError("lost"))
    assert classify(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    ex.on_task_failed(RuntimeError("CUDA error: unspecified launch failure"))
    ex.on_task_failed(TpuRetryOOM("transient"))
    assert exits == [1]
    driver = plugin.TpuDriverPlugin().init()
    assert driver.heartbeat_manager is None
