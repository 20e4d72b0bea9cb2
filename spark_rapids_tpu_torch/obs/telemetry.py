"""Per-query resource-attribution telemetry — the counterpart of
spark_rapids_tpu/obs/telemetry.py: a process-wide metrics registry (push
counters, sampled gauges, bounded ring-buffer series) behind
`spark.rapids.tpu.telemetry.{enabled,intervalMs,historySize}`.

Sampling is pull-based: a periodic sampler thread (`telemetry-sampler`)
reads the engine's existing process counters — the catalog's tiers and
per-owner device attribution (memory/catalog.bytes_by_owner), the
upload and fetch link bytes, the semaphore wait, the workload queue, the
breakers, the spill volumes — so instrumented code pays nothing new.
Push counters (`telemetry.add`) cost one pointer check when disabled.
Each sample lands in every series' ring and, when the event bus is up,
flushes as one `telemetry_sample` record. The `ici.*` series read the
mesh exchange lane's counters (shuffle/manager.ici_counters).

`reset_telemetry()` stops and joins the sampler thread.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional

#: sampled series name -> meaning. Every key appears in each sample and
#: carries the JAX package's name (a parity test holds them). Per-owner
#: HBM attribution rides the sample as the structured `hbm_by_owner`
#: field (a map, not a scalar series).
SERIES: Dict[str, str] = {
    "hbm.device_bytes": "catalog bytes resident on the DEVICE tier",
    "hbm.host_bytes": "catalog bytes resident on the HOST tier",
    "budget.used_bytes": "HBM budget manager's reserved bytes",
    "link.h2d_bytes": "cumulative host->device upload bytes",
    "link.d2h_bytes": "cumulative device->host packed-fetch bytes",
    "spill.device_bytes": "cumulative bytes spilled off the device tier",
    "spill.host_bytes": "cumulative bytes spilled host->disk",
    "sem.wait_ns": "cumulative admission-semaphore wait",
    "workload.queue_depth": "queries waiting in the admission queue",
    "workload.admitted": "queries currently admitted",
    "queries.active": "registered (governed) query contexts",
    "breakers.open": "circuit-breaker domains not closed",
    "ici.rounds": "cumulative ICI all-to-all exchange rounds",
    "ici.bytes": "cumulative bytes moved over the ICI shuffle lane",
    "ici.fallbacks": "ICI exchanges degraded to the host shuffle lane",
}

#: per-priority-class latency ring depth (queries kept for the SLO
#: percentile surface). Bounded so a soak's registry stays O(1).
_SLO_RING = 512

#: percentile points health()["slo"] reports, in order
_SLO_PCTS = (50, 95, 99)


def _percentile(sorted_ns, pct: int) -> int:
    """Nearest-rank percentile over an already-sorted list (exact for
    the bounded ring sizes we keep — no interpolation surprises in
    golden tests)."""
    n = len(sorted_ns)
    if n == 0:
        return 0
    rank = max(1, -(-pct * n // 100))  # ceil(pct/100 * n), min 1
    return sorted_ns[min(n, rank) - 1]


class TelemetryRegistry:
    """Counters + ring-buffer series + the sampler thread. One instance
    per enabled process (module singleton, `active_registry()`)."""

    def __init__(self, interval_ms: int, history: int):
        self.interval_ms = max(10, int(interval_ms))
        self.history = max(1, int(history))
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._series: Dict[str, deque] = {
            name: deque(maxlen=self.history) for name in SERIES}
        #: per-priority-class query wall-clock ring: the
        #: health()["slo"] percentile surface. Keys are priority-class
        #: names ("interactive"/"batch"), values bounded deques of ns.
        self._latency: Dict[str, deque] = {}
        self._queries_seen: Dict[str, int] = {}
        self.samples_taken = 0
        self.writes = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- push counters -----------------------------------------------------
    def add(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + delta
            self.writes += 1

    def counter_values(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    # -- SLO latency ring ---------------------------------------
    def note_query_latency(self, priority: str, wall_ns: int) -> None:
        """Record one finished governed query's wall-clock under its
        priority class. Bounded ring per class; percentiles are computed
        lazily on read (slo_snapshot), so the per-query cost is one
        append under the registry lock."""
        with self._lock:
            ring = self._latency.get(priority)
            if ring is None:
                ring = self._latency[priority] = deque(maxlen=_SLO_RING)
            ring.append(int(wall_ns))
            self._queries_seen[priority] = \
                self._queries_seen.get(priority, 0) + 1
            self.writes += 1

    def slo_snapshot(self) -> Dict[str, Dict[str, int]]:
        """Per-priority-class p50/p95/p99 wall-clock (ns) over the last
        <= _SLO_RING finished queries, plus the all-time count. Empty
        dict when no governed query has finished yet."""
        with self._lock:
            rings = {p: sorted(r) for p, r in self._latency.items()}
            seen = dict(self._queries_seen)
        out: Dict[str, Dict[str, int]] = {}
        for p, xs in rings.items():
            row = {f"p{q}_ns": _percentile(xs, q) for q in _SLO_PCTS}
            row["window"] = len(xs)
            row["queries"] = seen.get(p, 0)
            out[p] = row
        return out

    # -- sampling ----------------------------------------------------------
    def sample(self) -> Dict[str, Any]:
        """Take one snapshot of every gauge source, append it to the
        ring buffers, and flush it to the event bus (when one is up) as
        a `telemetry_sample` record. Also the on-demand entry for
        health()/tests — the sampler thread just calls this on a
        timer."""
        snap = collect_sample()
        with self._lock:
            self.samples_taken += 1
            self.writes += 1
            for name in SERIES:
                self._series[name].append((snap["ts_ms"], snap[name]))
            snap["counters"] = dict(self._counters)
        from . import events as obs_events
        obs_events.emit("telemetry_sample", **snap)
        return snap

    def series(self, name: str) -> list:
        with self._lock:
            return list(self._series[name])

    def last_sample(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            if not self._series["hbm.device_bytes"]:
                return None
            return {name: self._series[name][-1][1] for name in SERIES}

    # -- sampler thread ----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        # contract: ok thread-adopt — process-wide sampler: it reads
        # global gauges and emits unattributed telemetry_sample records
        # by design; there is no per-query context to adopt
        self._thread = threading.Thread(
            target=self._loop, name="telemetry-sampler", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_ms / 1000.0):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 — a sampling failure must
                pass           # never kill the exporter (or the engine)

    def shutdown(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None


def collect_sample() -> Dict[str, Any]:
    """One pull over every gauge source. All reads are lock-light
    snapshots the owning modules already expose; the per-owner HBM
    attribution and the tier totals come from ONE catalog lock pass
    (memory/catalog.bytes_by_owner), so `sum(hbm_by_owner.device) ==
    hbm.device_bytes` holds exactly at every tick."""
    from ..columnar import transfer, upload
    from ..exec import lifecycle, workload
    from ..memory.budget import memory_budget
    from ..memory.catalog import buffer_catalog
    from ..memory.semaphore import tpu_semaphore

    cat = buffer_catalog()
    dev_by_owner, host_by_owner, dev_total, host_total = \
        cat.bytes_by_owner()
    up = upload.counters()
    d2h = transfer.counters()
    wl = workload.snapshot()
    from ..shuffle import manager as shuffle_manager
    ici = shuffle_manager.ici_counters()
    return {
        "ts_ms": int(time.time() * 1000),
        "hbm.device_bytes": dev_total,
        "hbm.host_bytes": host_total,
        "budget.used_bytes": memory_budget().used,
        "link.h2d_bytes": up["bytes"],
        "link.d2h_bytes": d2h["d2h_bytes"],
        "spill.device_bytes": cat.spilled_device_bytes,
        "spill.host_bytes": cat.spilled_host_bytes,
        "sem.wait_ns": tpu_semaphore().total_wait_ns,
        "workload.queue_depth": wl["queue_depth"],
        "workload.admitted": wl["admitted"],
        "queries.active": len(lifecycle.active_query_ids()),
        "breakers.open": len(lifecycle.open_breakers()),
        "ici.rounds": ici["rounds"],
        "ici.bytes": ici["bytes"],
        "ici.fallbacks": ici["fallbacks"],
        "hbm_by_owner": {"device": dev_by_owner, "host": host_by_owner},
    }


# ---------------------------------------------------------------------------
# module singleton (the events.py active-bus pattern)
# ---------------------------------------------------------------------------

_registry: Optional[TelemetryRegistry] = None
_registry_lock = threading.Lock()


def active_registry() -> Optional[TelemetryRegistry]:
    """The enabled registry, or None — the single pointer check every
    push site pays in disabled mode."""
    return _registry


def add(name: str, delta: int = 1) -> None:
    """Push-counter update (cold paths / seams without their own
    process counter). One pointer check when telemetry is off."""
    r = _registry
    if r is not None:
        r.add(name, delta)


def note_query_latency(priority: str, wall_ns: int) -> None:
    """Per-query SLO accounting entry (api/session.collect). One
    pointer check when telemetry is off."""
    r = _registry
    if r is not None:
        r.note_query_latency(priority, wall_ns)


def slo_section() -> Dict[str, Any]:
    """The `slo` section of TpuSession.health(): per-priority-class
    wall-clock percentiles over the latency ring."""
    r = _registry
    if r is None:
        return {"enabled": False}
    return {"enabled": True, "classes": r.slo_snapshot()}


def configure(conf=None) -> Optional[TelemetryRegistry]:
    """(Re)configure from a RapidsConf — process-wide, the event-bus
    semantics: an unset telemetry.enabled keeps another session's
    registry running; an EXPLICIT enabled=false tears it down; an
    enabled conf with unchanged interval/history keeps the current
    registry (and its ring-buffer history) alive."""
    global _registry
    from ..config import (TELEMETRY_ENABLED, TELEMETRY_HISTORY_SIZE,
                          TELEMETRY_INTERVAL_MS, active_conf)
    conf = conf if conf is not None else active_conf()
    enabled = conf.get(TELEMETRY_ENABLED)
    # the replaced registry is detached under the lock but its sampler
    # is JOINED outside it 
    # joins up to 5s — holding `telemetry-config` across that stalled
    # every concurrent configure/enable/reset). The detached sampler
    # may take one last sample while the successor starts: harmless,
    # each writes only its own registry object.
    to_stop = None
    try:
        with _registry_lock:
            if not enabled:
                if TELEMETRY_ENABLED.key in conf._settings \
                        and _registry is not None:
                    to_stop, _registry = _registry, None
                return _registry
            interval = conf.get(TELEMETRY_INTERVAL_MS)
            history = conf.get(TELEMETRY_HISTORY_SIZE)
            if _registry is not None \
                    and _registry.interval_ms == max(10, interval) \
                    and _registry.history == max(1, history):
                return _registry
            to_stop = _registry
            _registry = TelemetryRegistry(interval, history)
            _registry.start()
            return _registry
    finally:
        if to_stop is not None:
            to_stop.shutdown()


def reset_telemetry() -> None:
    """Tear down the registry + sampler thread (test isolation; the
    conftest tripwire asserts no `telemetry-*` thread survives it)."""
    global _registry
    with _registry_lock:
        to_stop, _registry = _registry, None
    if to_stop is not None:
        to_stop.shutdown()  # join outside the config lock


def counters() -> Dict[str, int]:
    """Flat cumulative counters, for a caller to delta per run:
    registry activity plus every push counter. All zeros when telemetry
    is off — the block stays present so a round can assert the plane
    actually engaged."""
    r = _registry
    out = {"samples": 0, "registry_writes": 0}
    if r is not None:
        out["samples"] = r.samples_taken
        out["registry_writes"] = r.writes
        for k, v in r.counter_values().items():
            out[k.replace(".", "_")] = v
    return out


def health_section() -> Dict[str, Any]:
    """The `telemetry` section of TpuSession.health()."""
    r = _registry
    if r is None:
        return {"enabled": False}
    return {
        "enabled": True,
        "interval_ms": r.interval_ms,
        "history_size": r.history,
        "samples": r.samples_taken,
        "last": r.last_sample(),
    }
