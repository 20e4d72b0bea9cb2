"""The shuffle's partition-granular recovery (shuffle/manager.py,
exec/exchange.py's lineage capture) against the JAX package's, on the
CPU, over the same seeded numpy map batches:

- a `shuffle.decode` corrupt fault: one attempt and one
  `partition_recompute` in both packages, the partitions' rows in order
  those of the fault-free run; a corrupt rewrite escalates to the
  task-retry lane with the block's provenance (two attempts);
- a `shuffle.skew_split` corrupt fault in a split read recovers one map
  output, the rows unchanged;
- range partitioning captures no lineage: its corrupt block escalates;
- task.partitionRecovery.enabled=false: the whole-plan lane;
- `invalidate_peer_outputs` (on_peer_dead) makes the next read
  recompute each invalidated output exactly once (trigger dead_peer).
"""

import pytest

from spark_rapids_tpu import config as jconfig
from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu.exec import exchange as jexchange
from spark_rapids_tpu.exec import lifecycle as jlifecycle
from spark_rapids_tpu.exec import task_retry as jretry
from spark_rapids_tpu.expr import core as jcore

from spark_rapids_tpu_torch import config as tconfig
from spark_rapids_tpu_torch import faults as tfaults
from spark_rapids_tpu_torch.exec import exchange as texchange
from spark_rapids_tpu_torch.exec import lifecycle as tlifecycle
from spark_rapids_tpu_torch.exec import speculation_shield as shield
from spark_rapids_tpu_torch.exec import task_retry as tretry
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.obs import events as tevents
from spark_rapids_tpu_torch.shuffle import manager as tmanager

from test_torch_adaptive_reads import SPLIT, _zipf_scans
from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs

DECODE = "shuffle.decode:prob=1,seed=6,kind=corrupt,max=1"
RETRY = {"spark.rapids.tpu.task.maxAttempts": "3",
         "spark.rapids.tpu.task.retryBackoffMs": "1"}
PKGS = {"jax": (jexchange, jcore, jconfig, jfaults, jlifecycle, jretry),
        "port": (texchange, tcore, tconfig, tfaults, tlifecycle, tretry)}


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def _fresh(tmp_path):
    mgr = tmanager.reset_shuffle_manager(str(tmp_path))
    for _, _, _, faults, life, _ in PKGS.values():
        faults.install(None)
        life.reset_lifecycle()
    yield mgr
    for _, _, _, faults, _, _ in PKGS.values():
        faults.install(None)
    assert mgr.registered() == 0


def _read(pkg, settings, spec=None, partitioning="hash"):
    """Every partition's rows of the zipf exchange in `pkg` under the
    fault `spec`, through the package's task-retry lane: (partitions,
    attempts, partition recomputes)."""
    ex_mod, core, conf_mod, faults, life, retry = PKGS[pkg]
    conf = conf_mod.RapidsConf(dict(RETRY, **settings))
    scan = _zipf_scans()[0 if pkg == "jax" else 1]
    kw = {"partitioning": partitioning}
    if partitioning == "range":
        kw["range_order"] = (0, True, True)

    def run(attempt):
        ex = ex_mod.HostShuffleExchangeExec([core.col("k")], scan, 4, conf,
                                            **kw)
        return [[r for b in part for r in b.to_pylist()]
                for part in ex.execute_partitions()]

    before = retry.task_retry_total()
    rec0 = life.counters()["partition_recompute"]
    faults.install(spec)
    try:
        out = retry.with_task_retry(run, conf=conf)
    finally:
        faults.install(None)
    return (out, retry.task_retry_total() - before + 1,
            life.counters()["partition_recompute"] - rec0)


@pytest.mark.parametrize("settings", [{}, SPLIT], ids=["default", "split"])
def test_decode_fault_recomputes_one_map_output_in_both(settings):
    clean, _, _ = _read("port", settings)
    got = {pkg: _read(pkg, settings, DECODE) for pkg in PKGS}
    assert got["port"] == got["jax"] == (clean, 1, 1)


def test_skew_split_fault_recovers_one_map_output():
    spec = "shuffle.skew_split:prob=1,seed=3,kind=corrupt,max=1"
    clean, _, _ = _read("port", SPLIT)
    got = {pkg: _read(pkg, SPLIT, spec) for pkg in PKGS}
    assert got["port"] == got["jax"] == (clean, 1, 1)


def test_corrupt_rewrite_escalates_to_the_task_retry_lane(monkeypatch):
    seen = []
    real = tevents.emit

    def emit(kind, **fields):
        if kind == "task_retry":
            seen.append(fields)
        return real(kind, **fields)
    monkeypatch.setattr(tevents, "emit", emit)
    from spark_rapids_tpu.shuffle import manager as jmanager
    clean, _, _ = _read("port", {})
    # the recovered block's decode meets a damaged rewrite once
    for mod in (jmanager, tmanager):
        real_decode = mod.HostShuffleReader._decode
        state = {"left": 1}

        def decode(self, frame, key="", _real=real_decode, _state=state):
            if key.startswith("recover:") and _state["left"]:
                _state["left"] -= 1
                frame = frame[:-1] + bytes([frame[-1] ^ 0xFF])
            return _real(self, frame, key)
        monkeypatch.setattr(mod.HostShuffleReader, "_decode", decode)
    got = {pkg: _read(pkg, {}, DECODE) for pkg in PKGS}
    # the block goes to the whole-plan lane with its provenance, and the
    # next attempt is clean
    assert got["port"] == got["jax"] == (clean, 2, 1)
    prov = seen[0]["provenance"]
    assert prov["kind"] == "shuffle_block" and prov["map_path"]


@pytest.mark.parametrize("case", ["range", "recovery off"])
def test_no_lineage_takes_the_whole_plan_lane(case):
    settings = {"spark.rapids.tpu.task.partitionRecovery.enabled": "false"} \
        if case == "recovery off" else {}
    partitioning = "range" if case == "range" else "hash"
    clean, _, _ = _read("port", settings, partitioning=partitioning)
    got = {pkg: _read(pkg, settings, DECODE, partitioning)
           for pkg in PKGS}
    assert got["port"] == got["jax"] == (clean, 2, 0)


def test_dead_peer_invalidation_recomputes_once(monkeypatch, _fresh):
    recs = []
    real = tevents.emit

    def emit(kind, **fields):
        if kind in ("partition_recompute", "map_output_invalidated"):
            recs.append((kind, fields))
        return real(kind, **fields)
    monkeypatch.setattr(tevents, "emit", emit)
    shield.reset_shield()
    clean, _, _ = _read("port", {})
    mgr = _fresh
    scan = _zipf_scans()[1]
    ex = texchange.HostShuffleExchangeExec([tcore.col("k")], scan, 4,
                                           tconfig.RapidsConf())
    parts = ex.execute_partitions()
    first = next(parts)                  # the write phase ran
    handle = next(iter(mgr._handles.values()))
    paths = list(handle.map_outputs)
    assert set(handle.lineage) == set(paths)
    for path in paths[:2]:
        mgr.bind_peer_output("exec-1", handle, path)
    rec0 = tlifecycle.counters()["partition_recompute"]
    shield.on_peer_dead("exec-1")
    shield.on_peer_dead("exec-1")        # the bindings went with the call
    assert shield.counters()["outputs_invalidated"] == 2
    assert shield.counters()["peer_invalidations"] == 1
    got = [[r for b in first for r in b.to_pylist()]]
    got += [[r for b in part for r in b.to_pylist()] for part in parts]
    assert got == clean
    assert tlifecycle.counters()["partition_recompute"] - rec0 == 2
    kinds = [k for k, _ in recs]
    assert kinds.count("map_output_invalidated") == 2
    recomputes = [f for k, f in recs if k == "partition_recompute"]
    assert len(recomputes) == 2
    assert all(f["trigger"] == "dead_peer" for f in recomputes)
    assert not handle.invalidated
