"""Process-wide structured event bus — the counterpart of
spark_rapids_tpu/obs/events.py.

One JSON-lines file per configured bus, each line a self-describing
record:

    {"ts_ns": ..., "kind": ..., "query": <id or null>, "thread": ..., ...}

`EVENT_LEVELS` gives each kind the lowest spark.rapids.tpu.eventLog.level
(ESSENTIAL < MODERATE < DEBUG) at which it is written: the JAX package's
table, plus `kernel_failure`, the port's record of
a transient attempt failure that engaged a CUDA kernel family (such
failures are counted and emitted, and never change a kernel's route:
exec/lifecycle.py).

Cost discipline: `active_bus()` returns None when logging is disabled,
and every producer guards on it, so the batch loop pays one pointer
check. When enabled, each record is written and flushed behind a lock,
so a crashed query still leaves a parseable log.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, Iterator, Optional

ESSENTIAL = 0
MODERATE = 1
DEBUG = 2

_LEVEL_NAMES = {"ESSENTIAL": ESSENTIAL, "MODERATE": MODERATE, "DEBUG": DEBUG}

#: event kind -> minimum eventLog.level at which it is written
EVENT_LEVELS: Dict[str, int] = {
    "query_start": ESSENTIAL,
    "query_end": ESSENTIAL,
    "op_close": MODERATE,
    "op_error": MODERATE,
    "semaphore_acquire": MODERATE,
    "spill": MODERATE,
    "oom_retry": MODERATE,
    "pallas_tier": MODERATE,
    "plan_fallback": MODERATE,
    "plan_not_on_tpu": MODERATE,
    "exchange": MODERATE,
    # one record per map task: lane, frames, bytes and the write-time
    # split (pack, serialize, file IO)
    "shuffle_write": MODERATE,
    "ici_exchange": MODERATE,
    "pipeline_wait": MODERATE,
    "pipeline_full": MODERATE,
    # the failure story: injected faults, retries at every level (IO ->
    # OOM -> task), integrity quarantines and watchdog trips
    "fault_inject": MODERATE,
    "io_retry": MODERATE,
    "task_retry": MODERATE,
    "integrity_fail": MODERATE,
    # partition-granular recovery: one map output recomputed from its
    # lineage (shuffle/manager.py)
    "partition_recompute": MODERATE,
    "pipeline_stuck": MODERATE,
    "spill_error": MODERATE,
    "spill_writer_dead": MODERATE,
    # the lifecycle governor: a cancellation is headline, breaker
    # transitions and settle failures between attempts are MODERATE
    "query_cancelled": ESSENTIAL,
    "task_retry_settle_error": MODERATE,
    "breaker_open": MODERATE,
    "breaker_half_open": MODERATE,
    "breaker_close": MODERATE,
    "peer_dead": MODERATE,
    # the workload governor: a shed query is headline (its caller got an
    # error), queue and admission transitions and quota spills MODERATE
    "query_queued": MODERATE,
    "query_admitted": MODERATE,
    "query_shed": ESSENTIAL,
    "quota_spill": MODERATE,
    # one record per host->device batch upload
    "upload": MODERATE,
    "gather_stats": MODERATE,
    # one per exchange execution with its distributions and skew
    # (obs/stats.py), one per telemetry sampler tick (obs/telemetry.py)
    "exchange_stats": MODERATE,
    "telemetry_sample": MODERATE,
    # the dispatch ledger (obs/dispatch.py): one record per kernel
    # library first built in the process, one per wired execution, and
    # the headline storm of builds of one label
    "program_compile": MODERATE,
    "dispatch_stats": MODERATE,
    "recompile_storm": ESSENTIAL,
    # one record per governed query with its closed phase ledger
    # (obs/phase.py, sum(phases) == wall_ns exactly)
    "query_phases": ESSENTIAL,
    "stage_fused": MODERATE,
    "encoded_scan": MODERATE,
    "encoded_materialize": MODERATE,
    # the adaptive replanner (exec/adaptive.py)
    "adaptive_replan": MODERATE,
    "adaptive_demote": ESSENTIAL,
    # the straggler and stall shield (exec/speculation_shield.py): a
    # stalled query is headline, the rest MODERATE
    "query_stalled": ESSENTIAL,
    "speculative_fetch": MODERATE,
    "dispatch_timeout": MODERATE,
    "map_output_invalidated": MODERATE,
    # the port's own: a transient attempt failure that engaged a CUDA
    # kernel family (exec/lifecycle.attempt_failed)
    "kernel_failure": MODERATE,
    "op_open": DEBUG,
    "op_batch": DEBUG,
    "span": DEBUG,
}

#: the bus directory when spark.rapids.tpu.eventLog.dir is empty
DEFAULT_DIR = os.path.join(tempfile.gettempdir(),
                           "spark_rapids_tpu_torch_events")


def parse_level(name: str, default: int = MODERATE) -> int:
    return _LEVEL_NAMES.get(str(name).strip().upper(), default)


class EventBus:
    """Append-only JSONL sink. The file is created lazily on the first
    record, so an enabled but silent process leaves no empty files."""

    _seq = 0
    _seq_lock = threading.Lock()

    def __init__(self, directory: str, level: int = MODERATE,
                 max_bytes: int = 0):
        self.directory = directory or DEFAULT_DIR
        self.level = level
        #: rotation threshold (spark.rapids.tpu.eventLog.maxBytes): past
        #: it the file closes and writing goes on in <base>.<n>.jsonl.
        #: 0 = unbounded.
        self.max_bytes = max(0, int(max_bytes))
        with EventBus._seq_lock:
            EventBus._seq += 1
            seq = EventBus._seq
        self._base = os.path.join(self.directory,
                                  f"events-{os.getpid()}-{seq}")
        self._rot = 0
        self._written = 0
        self.path = f"{self._base}.jsonl"
        #: every file this bus wrote, in order
        self.paths = []
        self._lock = threading.Lock()
        self._file = None
        self._closed = False

    def _rotate_locked(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        self._rot += 1
        self._written = 0
        self.path = f"{self._base}.{self._rot}.jsonl"

    def emit(self, kind: str, **fields: Any) -> None:
        if self._closed or EVENT_LEVELS.get(kind, MODERATE) > self.level:
            return
        # `thread`: the emitting thread's name, so a timeline tells the
        # consumer from pipeline-* producers, the spill writer and pool
        # workers
        rec = {"ts_ns": time.time_ns(), "kind": kind,
               "query": current_query_id(),
               "thread": threading.current_thread().name}
        rec.update(fields)
        try:
            line = json.dumps(rec, separators=(",", ":"), default=str)
            with self._lock:
                if self._closed:
                    return
                if self._file is None:
                    os.makedirs(self.directory, exist_ok=True)
                    self._file = open(self.path, "a")
                    self.paths.append(self.path)
                self._file.write(line + "\n")
                self._file.flush()
                self._written += len(line) + 1
                if self.max_bytes and self._written >= self.max_bytes:
                    self._rotate_locked()
        except Exception as e:  # noqa: BLE001 — emit runs inside
            # operator and collect finally blocks: an unwritable log must
            # never fail a query or mask its exception. One warning, then
            # the bus stays down.
            import logging
            logging.getLogger("spark_rapids_tpu_torch.obs").warning(
                "event log disabled: cannot write %s (%s: %s)",
                self.path, type(e).__name__, e)
            self.close()
            _deactivate(self)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._file is not None:
                self._file.close()
                self._file = None


_bus: Optional[EventBus] = None
_bus_lock = threading.Lock()


def active_bus() -> Optional[EventBus]:
    """The configured bus, or None when event logging is disabled: the
    whole disabled-mode cost of a producer."""
    return _bus


def emit(kind: str, **fields: Any) -> None:
    """Emit one event if logging is enabled."""
    b = _bus
    if b is not None:
        b.emit(kind, **fields)


def _deactivate(bus: EventBus) -> None:
    global _bus
    with _bus_lock:
        if _bus is bus:
            _bus = None


def configure(conf=None) -> Optional[EventBus]:
    """(Re)configure the process bus from a RapidsConf (None = the
    thread's active conf). Process-wide like a Spark event log: a conf
    that leaves eventLog.enabled unset keeps whatever bus another
    session enabled; an explicit enabled=false tears it down; an enabled
    conf with unchanged dir, level and size keeps the file open."""
    global _bus
    from ..config import (EVENT_LOG_DIR, EVENT_LOG_ENABLED,
                          EVENT_LOG_LEVEL, EVENT_LOG_MAX_BYTES,
                          active_conf)
    conf = conf if conf is not None else active_conf()
    enabled = conf.get(EVENT_LOG_ENABLED)
    with _bus_lock:
        if not enabled:
            if EVENT_LOG_ENABLED.key in conf._settings \
                    and _bus is not None:
                _bus.close()
                _bus = None
            return _bus
        directory = conf.get(EVENT_LOG_DIR) or DEFAULT_DIR
        level = parse_level(conf.get(EVENT_LOG_LEVEL))
        max_bytes = max(0, conf.get(EVENT_LOG_MAX_BYTES))
        if _bus is not None and _bus.directory == directory \
                and _bus.level == level and _bus.max_bytes == max_bytes:
            return _bus
        if _bus is not None:
            _bus.close()
        _bus = EventBus(directory, level, max_bytes=max_bytes)
        return _bus


def enable(directory: str, level: str = "MODERATE",
           max_bytes: int = 0) -> EventBus:
    """Conf-free switch-on (tools, tests)."""
    global _bus
    with _bus_lock:
        if _bus is not None:
            _bus.close()
        _bus = EventBus(directory, parse_level(level),
                        max_bytes=max_bytes)
        return _bus


def reset_event_bus() -> None:
    """Tear down the bus (test isolation)."""
    global _bus
    with _bus_lock:
        if _bus is not None:
            _bus.close()
        _bus = None


def read_events(bus: EventBus) -> list:
    """Every record `bus` wrote, in order (its rotated files too)."""
    out = []
    for path in list(bus.paths):
        with open(path) as f:
            out.extend(json.loads(line) for line in f if line.strip())
    return out


# -- query attribution ------------------------------------------------------

_qlocal = threading.local()
_query_counter = 0
_query_counter_lock = threading.Lock()


def current_query_id() -> Optional[int]:
    return getattr(_qlocal, "qid", None)


def adopt_query_id(qid: Optional[int]) -> None:
    """Attribute this thread's events to an existing query id (pipeline
    producer threads carry their consumer's)."""
    _qlocal.qid = qid


def with_query_id(qid: Optional[int], fn, *args, **kwargs):
    """Run `fn` with this thread's events attributed to `qid`, restoring
    the previous attribution after: the shared decode and shuffle pools
    serve many queries from long-lived threads, so the submitter captures
    current_query_id() and wraps each work item."""
    prev = current_query_id()
    adopt_query_id(qid)
    try:
        return fn(*args, **kwargs)
    finally:
        adopt_query_id(prev)


@contextlib.contextmanager
def query_scope(qid: Optional[int] = None) -> Iterator[int]:
    """Attribute every event this thread emits in the body to one query
    id (a fresh monotonic id when not given). Nests: an inner scope
    shadows and restores."""
    global _query_counter
    if qid is None:
        with _query_counter_lock:
            _query_counter += 1
            qid = _query_counter
    prev = getattr(_qlocal, "qid", None)
    _qlocal.qid = qid
    try:
        yield qid
    finally:
        _qlocal.qid = prev
