"""Query history store — the counterpart of
spark_rapids_tpu/obs/history.py: one JSONL capsule per finished governed
query, the engine's history-server analog.

Behind spark.rapids.tpu.history.{enabled,dir,maxBytes} (off by default:
one pointer check per collect), `DataFrame.collect()` appends one record
per query, with the JAX package's keys:

    {"ts_ms", "query", "fingerprint", "ok", "priority", "attempts",
     "wall_ns", "mesh_devices", "phases", "rows", "batches",
     "sem_wait_ns", "spill_bytes", "skew",
     "shuffle", "ici", "upload", "dispatch", "workload", "encoded",
     "adaptive", "speculation"}

The last eight are the query's deltas of the process counter families.
`ici` is the mesh exchange lane's counters (shuffle/manager.
ici_counters) and `mesh_devices` the session mesh's shard count (1
without one). `fingerprint` is `plan_fingerprint` of the executed
plan: a digest of each node's class and output schema, so one plan shape
gives one fingerprint across sessions and processes (the JAX package's
digest also covers each node's semantic fields; the two packages'
fingerprints differ). `rows` and `batches` are the summed operator totals
(`total.numOutputRows`), as in the JAX package.

Files: `history-<pid>-<seq>.jsonl` per store, rotating to
`<base>.<n>.jsonl` past history.maxBytes; created lazily. A write failure
warns once and uninstalls the store, so a full disk never fails a query.
The JAX package's stdlib-only `tools/history_report.py` reads them.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, Optional

#: the store's directory when spark.rapids.tpu.history.dir is empty
DEFAULT_DIR = os.path.join(tempfile.gettempdir(),
                           "spark_rapids_tpu_torch_history")


class HistoryStore:
    """Append-only JSONL capsule sink (one line per finished query)."""

    _seq = 0
    _seq_lock = threading.Lock()

    def __init__(self, directory: str, max_bytes: int = 0):
        self.directory = directory or DEFAULT_DIR
        #: rotation threshold (history.maxBytes): 0 = unbounded
        self.max_bytes = max(0, int(max_bytes))
        with HistoryStore._seq_lock:
            HistoryStore._seq += 1
            seq = HistoryStore._seq
        self._base = os.path.join(self.directory,
                                  f"history-{os.getpid()}-{seq}")
        self._rot = 0
        self._written = 0
        self.path = f"{self._base}.jsonl"
        self._lock = threading.Lock()
        self._file = None
        self._closed = False
        #: capsules appended
        self.records = 0

    def _rotate_locked(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        self._rot += 1
        self._written = 0
        self.path = f"{self._base}.{self._rot}.jsonl"

    def append(self, capsule: Dict[str, Any]) -> None:
        """Write one capsule. Runs in collect()'s finally chain, so it
        never raises: a failure warns once and uninstalls the store."""
        if self._closed:
            return
        try:
            line = json.dumps(capsule, separators=(",", ":"), default=str)
            with self._lock:
                if self._closed:
                    return
                if self._file is None:
                    os.makedirs(self.directory, exist_ok=True)
                    self._file = open(self.path, "a")
                self._file.write(line + "\n")
                self._file.flush()
                self._written += len(line) + 1
                self.records += 1
                if self.max_bytes and self._written >= self.max_bytes:
                    self._rotate_locked()
        except Exception as e:  # noqa: BLE001 — never fail a query
            import logging
            logging.getLogger("spark_rapids_tpu_torch.obs").warning(
                "query history disabled: cannot write %s (%s: %s)",
                self.path, type(e).__name__, e)
            self.close()
            _deactivate(self)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._file is not None:
                self._file.close()
                self._file = None


_store: Optional[HistoryStore] = None
_store_lock = threading.Lock()


def active_store() -> Optional[HistoryStore]:
    """The configured store, or None (the one check a collect pays)."""
    return _store


def _deactivate(store: HistoryStore) -> None:
    global _store
    with _store_lock:
        if _store is store:
            _store = None


def configure(conf=None) -> Optional[HistoryStore]:
    """(Re)configure from a RapidsConf, process-wide, as the event bus:
    a conf that leaves history.enabled unset keeps another session's
    store, an explicit false tears it down, and an unchanged dir and
    maxBytes keep the current file."""
    global _store
    from ..config import (HISTORY_DIR, HISTORY_ENABLED, HISTORY_MAX_BYTES,
                          active_conf)
    conf = conf if conf is not None else active_conf()
    enabled = conf.get(HISTORY_ENABLED)
    with _store_lock:
        if not enabled:
            if HISTORY_ENABLED.key in conf._settings \
                    and _store is not None:
                _store.close()
                _store = None
            return _store
        directory = conf.get(HISTORY_DIR) or DEFAULT_DIR
        max_bytes = max(0, conf.get(HISTORY_MAX_BYTES))
        if _store is not None and _store.directory == directory \
                and _store.max_bytes == max_bytes:
            return _store
        if _store is not None:
            _store.close()
        _store = HistoryStore(directory, max_bytes=max_bytes)
        return _store


def enable(directory: str, max_bytes: int = 0) -> HistoryStore:
    """Switch a store on without a conf."""
    global _store
    with _store_lock:
        if _store is not None:
            _store.close()
        _store = HistoryStore(directory, max_bytes=max_bytes)
        return _store


def reset_history() -> None:
    """Tear the store down (test isolation)."""
    global _store
    with _store_lock:
        if _store is not None:
            _store.close()
        _store = None


# -- capsule assembly ---------------------------------------------------------

def plan_fingerprint(root) -> str:
    """A digest of the plan's shape: each node's class and output
    schema, its children in order."""
    def node(op) -> str:
        schema = ",".join(f"{f.name}:{f.data_type.simple_name()}"
                          for f in op.output_schema.fields)
        kids = ";".join(node(c) for c in op.children)
        return f"{type(op).__name__}[{schema}]({kids})"
    return hashlib.sha256(node(root).encode()).hexdigest()[:16]


def process_counters() -> Dict[str, Dict[str, int]]:
    """One snapshot of every counter family a capsule diffs (read only
    when a store is active)."""
    from ..columnar import encoded, upload
    from ..exec import adaptive, speculation_shield, workload
    from ..obs import dispatch as obs_dispatch
    from ..shuffle import manager as shuffle_manager
    return {
        "shuffle": shuffle_manager.counters(),
        "ici": shuffle_manager.ici_counters(),
        "upload": upload.counters(),
        "dispatch": obs_dispatch.counters(),
        "workload": workload.counters(),
        "encoded": encoded.counters(),
        "adaptive": adaptive.counters(),
        "speculation": speculation_shield.counters(),
    }


def counters_delta(before: Dict[str, Dict[str, int]],
                   after: Dict[str, Dict[str, int]]
                   ) -> Dict[str, Dict[str, int]]:
    """Per family {key: after - before}, numeric keys only."""
    out: Dict[str, Dict[str, int]] = {}
    for fam, cur in after.items():
        base = before.get(fam, {})
        out[fam] = {k: v - base.get(k, 0) for k, v in cur.items()
                    if isinstance(v, (int, float))
                    and not isinstance(v, bool)}
    return out


def worst_skew(stats) -> Optional[Dict[str, Any]]:
    """The highest-ratio exchange skew of a query's RuntimeStats, tagged
    with its op; None when the query ran no exchange."""
    worst = None
    if stats is None:
        return None
    for st in stats.exchanges():
        sk = st.skew()
        if worst is None or sk["ratio"] > worst["ratio"]:
            worst = dict(sk)
            worst["op"] = f"{st.op}#{st.op_id}"
            worst["partitions"] = st.partitions
    return worst


def build_capsule(*, query_id, fingerprint, ok, priority, attempts,
                  wall_ns, phases, stats, summary, deltas,
                  mesh_devices: int = 1) -> Dict[str, Any]:
    """The one-line history record; `phases` is the closed ledger dict
    or None when phase attribution was off."""
    summary = summary or {}
    capsule: Dict[str, Any] = {
        "ts_ms": int(time.time() * 1000),
        "query": query_id,
        "fingerprint": fingerprint,
        "ok": bool(ok),
        "priority": priority,
        "attempts": attempts,
        "wall_ns": int(wall_ns),
        "mesh_devices": int(mesh_devices),
        "phases": phases,
        "rows": summary.get("total.numOutputRows", 0),
        "batches": summary.get("total.numOutputBatches", 0),
        "sem_wait_ns": summary.get("semWaitTimeNs", 0),
        "spill_bytes": (summary.get("spilledDeviceBytes", 0)
                        + summary.get("spilledHostBytes", 0)),
        "skew": worst_skew(stats),
    }
    capsule.update(deltas)
    return capsule
