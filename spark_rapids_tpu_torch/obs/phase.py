"""Wall-clock phase attribution — the counterpart of
spark_rapids_tpu/obs/phase.py: each governed query's wall-clock split
into a closed set of named phases, with `sum(phases) == wall_ns`
exactly.

The sites that accrue, in the port:

* `admission-wait`: the workload governor's queue (exec/workload.py);
* `compile`: a CUDA kernel library's first-use build and load
  (kernels/build.py, through obs/dispatch.note_build);
* `device-compute`: the wall time of the instrumented dispatch sites on
  the driving thread (obs/dispatch.py: each exec's batch step and the
  six kernel wrappers), host reads inside them included, less every
  nested accrual below;
* `host-pack-serialize` and `shuffle-io`: the shuffle map write
  (exec/exchange.py) and its file IO;
* `spill-wait`: synchronous spills and waits on spill writebacks
  (memory/catalog.py);
* `semaphore-wait`: the device admission semaphore (memory/semaphore.py);
* `pipeline-stall`: a consumer blocked on its producer
  (exec/pipeline.py);
* `retry-backoff`: the task-retry and OOM-retry sleeps;
* `spec-wait`: the wait past the straggler bound of a speculative
  shuffle sub-read (exec/speculation_shield.py);
* `ici-collective`: a round of the host exchange's device lane — its
  measure, its all-to-all step and its staging (exec/exchange.py);
* `other`: the derived remainder, never accrued directly.

Two surfaces fed by the same `add`/`span` calls: process-global
cumulative counters (`counters()`), always on, and a per-query
PhaseLedger attached to the governed QueryContext by `DataFrame.collect()`
when spark.rapids.tpu.phases.enabled.

Exactness: accruals on the query's driving thread are sequential and
exclusive (`span()` keeps a thread-local stack and subtracts what nested
frames report), so they never sum past wall. Accruals from other threads
(pipeline producers, which adopt the query's context) land in a separate
`folded` map, and `snapshot()` re-attributes them into the consumer's
pipeline-stall budget, scaled down when producers report more than the
consumer stalled.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, Optional

#: the closed phase set; `other` is the derived remainder
PHASES = (
    "admission-wait",      # workload-governor queue (exec/workload.py)
    "compile",             # kernel library build + load (kernels/build.py)
    "device-compute",      # instrumented dispatch sites (obs/dispatch.py)
    "host-pack-serialize", # shuffle write pack/serialize (exec/exchange.py)
    "shuffle-io",          # shuffle file write/read io
    "ici-collective",      # the mesh lane's rounds (exec/exchange.py)
    "spill-wait",          # catalog writeback waits + synchronous spill
    "semaphore-wait",      # device admission (memory/semaphore.py)
    "pipeline-stall",      # consumer blocked on producer (exec/pipeline.py)
    "retry-backoff",       # task-retry + OOM-retry backoff sleeps
    "spec-wait",           # speculative sub-reads (speculation_shield)
    "other",               # derived remainder — never negative
)

#: phases a site may accrue into (everything but the derived remainder)
ACCRUABLE = PHASES[:-1]


# ---------------------------------------------------------------------------
# process-global counters
# ---------------------------------------------------------------------------

_global_lock = threading.Lock()
_global_ns: Dict[str, int] = {p: 0 for p in ACCRUABLE}


def counters() -> Dict[str, int]:
    """Process-cumulative per-phase nanoseconds."""
    with _global_lock:
        return dict(_global_ns)


# ---------------------------------------------------------------------------
# thread-local span stack (exclusive accounting)
# ---------------------------------------------------------------------------

_tls = threading.local()


def _stack() -> list:
    s = getattr(_tls, "spans", None)
    if s is None:
        s = _tls.spans = []
    return s


def in_span() -> bool:
    """Is this thread inside an attribution span?"""
    return bool(getattr(_tls, "spans", None))


def _ledger() -> Optional["PhaseLedger"]:
    from ..exec import lifecycle
    ctx = lifecycle.current_context()
    return getattr(ctx, "phase_ledger", None) if ctx is not None else None


def add(phase: str, ns: int) -> None:
    """Accrue `ns` of wall-clock to `phase`: the process counters always,
    this thread's governed query's ledger when one is attached, and the
    enclosing span frame, so the parent phase excludes this time."""
    if ns <= 0:
        return
    ns = int(ns)
    with _global_lock:
        _global_ns[phase] += ns
    s = getattr(_tls, "spans", None)
    if s:
        s[-1][1] += ns
    led = _ledger()
    if led is not None:
        led.add(phase, ns)


@contextlib.contextmanager
def span(phase: str) -> Iterator[None]:
    """Attribute this block's EXCLUSIVE elapsed time to `phase`: what any
    nested add()/span() reports is subtracted, and the block's full
    elapsed is notified upward, so nested attribution sums to the
    outermost block's wall-clock, once."""
    t0 = time.perf_counter_ns()
    frame = [phase, 0]
    stack = _stack()
    stack.append(frame)
    try:
        yield
    finally:
        stack.pop()
        elapsed = time.perf_counter_ns() - t0
        exclusive = elapsed - frame[1]
        if exclusive > 0:
            with _global_lock:
                _global_ns[phase] += exclusive
            led = _ledger()
            if led is not None:
                led.add(phase, exclusive)
        if stack and elapsed > 0:
            stack[-1][1] += elapsed


# ---------------------------------------------------------------------------
# per-query ledger
# ---------------------------------------------------------------------------

class PhaseLedger:
    """Per-governed-query phase books. Created on the driving thread by
    DataFrame.collect; accruals from that thread land in `_direct`,
    accruals from adopted producer threads in `_folded`."""

    __slots__ = ("_t0", "_thread", "_direct", "_folded", "_lock", "_wall")

    def __init__(self):
        self._t0 = time.perf_counter_ns()
        self._thread = threading.get_ident()
        self._direct: Dict[str, int] = {}
        self._folded: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._wall: Optional[int] = None

    def add(self, phase: str, ns: int) -> None:
        direct = threading.get_ident() == self._thread
        with self._lock:
            tgt = self._direct if direct else self._folded
            tgt[phase] = tgt.get(phase, 0) + ns

    def finish(self) -> int:
        """Close the measurement window (idempotent); returns wall_ns."""
        if self._wall is None:
            self._wall = time.perf_counter_ns() - self._t0
        return self._wall

    @property
    def wall_ns(self) -> int:
        return self.finish()

    def dominant_phase(self) -> Optional[str]:
        """The largest phase accrued so far, read mid-flight without
        closing the window (the stall watchdog's attribution); None when
        nothing has accrued."""
        with self._lock:
            merged = dict(self._direct)
            for p, v in self._folded.items():
                merged[p] = merged.get(p, 0) + v
        if not merged:
            return None
        return max(merged, key=merged.get)

    def snapshot(self) -> Dict[str, int]:
        """The closed phase dict: every name in PHASES present,
        `sum(values) == wall_ns` exactly, nothing negative. Folded
        producer time displaces pipeline-stall one for one, scaled down
        when producers report more than the consumer stalled."""
        wall = self.finish()
        with self._lock:
            direct = dict(self._direct)
            folded = dict(self._folded)
        out: Dict[str, int] = {p: 0 for p in PHASES}
        for p, v in direct.items():
            out[p] += v
        folded_total = sum(folded.values())
        if folded_total > 0:
            budget = out["pipeline-stall"]
            attributed = 0
            for p, v in folded.items():
                share = v if folded_total <= budget \
                    else v * budget // folded_total
                out[p] += share
                attributed += share
            out["pipeline-stall"] = budget - attributed
        total = sum(out.values())
        if total > wall:
            # unreachable by construction (direct spans are exclusive on
            # one thread, folded time never exceeds the stall budget),
            # but the invariant is what readers rely on: trim largest
            # first rather than report sum > wall
            excess = total - wall
            for p in sorted(out, key=out.__getitem__, reverse=True):
                take = min(out[p], excess)
                out[p] -= take
                excess -= take
                if excess <= 0:
                    break
        out["other"] = wall - sum(v for k, v in out.items()
                                  if k != "other")
        return out


def attach(ctx) -> PhaseLedger:
    """Attach a fresh ledger to a governed QueryContext."""
    led = PhaseLedger()
    ctx.phase_ledger = led
    return led
