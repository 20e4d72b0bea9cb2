"""Straggler and stall shield — the counterpart of
spark_rapids_tpu/exec/speculation_shield.py: the tail-latency control
loop over the lifecycle, stats and phase planes, in four conf-gated
pieces.

* **Progress watchdog** (`ProgressWatchdog`, `watchdog_for`): a governed
  query whose root output (the QueryContext's batches and rows, and its
  attempt number) has not moved for `spark.rapids.tpu.stall.timeoutMs`
  emits one `query_stalled` event (the operator that last yielded and
  the dominant phase so far) and takes `stall.action`: `report`,
  `retry-seam` (the QueryContext's `stall_retry` flag: the attempt's next
  cancellation checkpoint raises QueryStalledError onto the task-retry
  lane) or `cancel` (the query's cancel token). It re-arms after each
  episode. Distinct from `query.timeoutMs`, which bounds the total wall.

* **Speculative shuffle sub-reads** (`ReadSpeculation`,
  `reader_speculation`): a fetch or decode future still running past
  its bound — the reader's own measured latencies' p95 (a Log2Hist, in
  ms) times `shuffle.speculation.multiplier`, floored at `minMs` — gets
  one duplicate under a `spec:` key; the first result wins and the loser
  is cancelled or discarded. `maxInFlight` caps the duplicates of one
  query; a denied straggler waits on its primary. The wait past the
  bound accrues to the `spec-wait` phase.

* **Dispatch hang bound** (`timed_call`, `await_ready`): with
  `dispatch.timeoutMs` > 0 the dispatch ledger's sites (obs/dispatch.py:
  the kernel wrappers and the execs' batch steps) record a CUDA event
  after their launches and poll it on the calling thread until the
  deadline, so no helper thread is left blocked behind a wedged kernel.
  Past the deadline: a `dispatch_timeout` event, a count, and
  DispatchTimeoutError, a transient error for the task-retry lane. The
  JAX package also trips its `device_dispatch` breaker here; in the port
  an open breaker would send a kernel to its plain version, the fallback
  the port forbids, so a timeout never changes a kernel's route. The
  wedged kernel keeps its stream busy, so a retry queues behind it and
  the bounded task-retry lane surfaces the failure (ROADMAP C.16).

* **Dead-peer invalidation** (`on_peer_dead`): a peer's death invalidates
  its registered map outputs (shuffle/manager.invalidate_peer_outputs),
  so their next read recomputes them from lineage. The heartbeat
  manager's dead-peer emit calls it (parallel/heartbeat.install), gated
  by `shuffle.deadPeerInvalidation.enabled`.

Every piece is off by default and costs one conf or pointer check when
off. The counters are process-cumulative (`counters()`).
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import FIRST_COMPLETED
from concurrent.futures import TimeoutError as FuturesTimeout
from concurrent.futures import wait as futures_wait
from typing import Callable, Dict, Optional

#: what the watchdog may do on a stall
STALL_ACTIONS = ("report", "retry-seam", "cancel")

_counter_lock = threading.Lock()
_counters: Dict[str, int] = {
    "stalls": 0,
    "stall_retries": 0,
    "stall_cancels": 0,
    "spec_launched": 0,
    "spec_wins": 0,
    "spec_primary_wins": 0,
    "spec_denied": 0,
    "spec_wait_ns": 0,
    "dispatch_timeouts": 0,
    "peer_invalidations": 0,
    "outputs_invalidated": 0,
}


def _count(key: str, n: int = 1) -> None:
    with _counter_lock:
        _counters[key] += n


def counters() -> Dict[str, int]:
    """The process-cumulative shield counters."""
    with _counter_lock:
        return dict(_counters)


def reset_shield() -> None:
    """Zero the counters and drop the per-query speculation slots (test
    isolation)."""
    with _counter_lock:
        for k in _counters:
            _counters[k] = 0
    with _slot_lock:
        _slots.clear()


# ---------------------------------------------------------------------------
# progress watchdog
# ---------------------------------------------------------------------------

class ProgressWatchdog:
    """One daemon monitor per governed query, polling its QueryContext's
    root-output counters; always stopped by collect()'s finally."""

    def __init__(self, ctx, timeout_ms: int, action: str):
        self.ctx = ctx
        self.timeout_s = max(1, int(timeout_ms)) / 1000.0
        self.action = action if action in STALL_ACTIONS else "report"
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        # a few polls a window, so a stall is seen within ~1.25 windows
        interval = min(max(self.timeout_s / 4.0, 0.005), 1.0)
        self._thread = threading.Thread(
            target=self._loop, args=(interval,), daemon=True,
            name=f"stall-watchdog-{self.ctx.ctx_id}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)

    def _progress(self) -> tuple:
        c = self.ctx
        # a retry restarts the counts: a new attempt is progress
        return (c.attempt_no, c.batches_produced, c.rows_produced)

    def _loop(self, interval: float) -> None:
        last = self._progress()
        last_t = time.monotonic()
        while not self._stop.wait(interval):
            cur = self._progress()
            now = time.monotonic()
            if cur != last:
                last, last_t = cur, now
                continue
            if now - last_t < self.timeout_s:
                continue
            self._fire(now - last_t)
            # re-arm: a query still frozen fires again after a full window
            last_t = now

    def _fire(self, stalled_s: float) -> None:
        ctx = self.ctx
        _count("stalls")
        led = ctx.phase_ledger
        phase = led.dominant_phase() if led is not None else None
        from ..obs import events as obs_events
        obs_events.with_query_id(
            ctx.events_qid, obs_events.emit, "query_stalled",
            stalled_ms=int(stalled_s * 1000),
            timeout_ms=int(self.timeout_s * 1000),
            action=self.action, seam=ctx.current_op, phase=phase,
            attempt=ctx.attempt_no, batches=ctx.batches_produced,
            rows=ctx.rows_produced)
        if self.action == "cancel":
            _count("stall_cancels")
            ctx.cancel("stalled")
        elif self.action == "retry-seam":
            _count("stall_retries")
            ctx.stall_retry = True


def watchdog_for(ctx, conf) -> Optional[ProgressWatchdog]:
    """A started watchdog when `stall.timeoutMs` > 0, else None."""
    from ..config import STALL_ACTION, STALL_TIMEOUT_MS
    timeout_ms = conf.get(STALL_TIMEOUT_MS)
    if not timeout_ms or timeout_ms <= 0:
        return None
    dog = ProgressWatchdog(ctx, timeout_ms, conf.get(STALL_ACTION))
    dog.start()
    return dog


# ---------------------------------------------------------------------------
# speculative shuffle sub-reads
# ---------------------------------------------------------------------------

#: in-flight duplicates per governed query (key: its ctx_id, or None for
#: readers outside a governed query: bounded all the same)
_slot_lock = threading.Lock()
_slots: Dict[Optional[int], int] = {}


def _slot_key() -> Optional[int]:
    from . import lifecycle
    ctx = lifecycle.current_context()
    return ctx.ctx_id if ctx is not None else None


def _take_slot(max_inflight: int) -> bool:
    key = _slot_key()
    with _slot_lock:
        n = _slots.get(key, 0)
        if n >= max_inflight:
            return False
        _slots[key] = n + 1
        return True


def _release_slot() -> None:
    key = _slot_key()
    with _slot_lock:
        n = _slots.get(key, 0) - 1
        if n <= 0:
            _slots.pop(key, None)
        else:
            _slots[key] = n


class ReadSpeculation:
    """One reader's speculative sub-read policy: its fetch and decode
    latency histograms (ms), the bound derived from them, and the
    first-result-wins race."""

    __slots__ = ("multiplier", "min_ms", "max_inflight", "_hists",
                 "_lock")

    def __init__(self, multiplier: float, min_ms: int, max_inflight: int):
        from ..obs.stats import Log2Hist
        self.multiplier = max(1.0, float(multiplier))
        self.min_ms = max(1, int(min_ms))
        self.max_inflight = max(1, int(max_inflight))
        self._hists = {"fetch": Log2Hist(), "decode": Log2Hist()}
        self._lock = threading.Lock()

    def timed(self, stage: str, fn, *args):
        """Pool-side: run the fetch or decode and record its latency."""
        t0 = time.perf_counter_ns()
        out = fn(*args)
        ms = (time.perf_counter_ns() - t0) // 1_000_000
        with self._lock:
            self._hists[stage].add(int(ms))
        return out

    def bound_ms(self, stage: str) -> int:
        """p95 x multiplier, floored at min_ms (a cold histogram or
        sub-ms local reads must not start duplicates)."""
        with self._lock:
            p95 = self._hists[stage].percentile(95)
        return max(int(p95 * self.multiplier), self.min_ms)

    def resolve(self, stage: str, primary, launch: Callable[[], object],
                key: str):
        """Wait on `primary` up to the bound; past it, take a slot and
        race one duplicate from `launch()` (a Future). The first success
        wins, the loser is cancelled. A denied straggler waits on its
        primary. Both failing raises the primary's error."""
        bound_s = self.bound_ms(stage) / 1000.0
        try:
            return primary.result(timeout=bound_s)
        except FuturesTimeout:
            pass
        t0 = time.perf_counter_ns()
        if not _take_slot(self.max_inflight):
            _count("spec_denied")
            try:
                return self._await(primary)
            finally:
                self._note_wait(t0)
        _count("spec_launched")
        spec = None
        try:
            spec = launch()
            winner, out, err = self._race(primary, spec)
        except BaseException:
            # cancelled mid-race: drop both attempts
            primary.cancel()
            if spec is not None:
                spec.cancel()
            raise
        finally:
            _release_slot()
        wait_ns = self._note_wait(t0)
        if winner == "spec":
            _count("spec_wins")
        elif winner == "primary":
            _count("spec_primary_wins")
        from ..obs import events as obs_events
        obs_events.emit("speculative_fetch", stage=stage, key=key,
                        winner=winner, bound_ms=int(bound_s * 1000),
                        wait_ms=wait_ns // 1_000_000)
        if err is not None:
            raise err
        return out

    @staticmethod
    def _note_wait(t0: int) -> int:
        """Accrue the wait past the bound to the counters and the
        `spec-wait` phase (on a producer thread it folds into the
        consumer's pipeline-stall budget, so the ledger stays closed)."""
        ns = int(time.perf_counter_ns() - t0)
        _count("spec_wait_ns", ns)
        from ..obs import phase as obs_phase
        obs_phase.add("spec-wait", ns)
        return ns

    @staticmethod
    def _await(fut):
        """Wait on one future, polling for cancellation."""
        from . import lifecycle
        while True:
            try:
                return fut.result(timeout=0.05)
            except FuturesTimeout:
                lifecycle.check_current("pipeline-wait")

    @staticmethod
    def _race(primary, spec):
        """(winner, result, error) of the two attempts; error only when
        both failed."""
        from . import lifecycle
        pending = {primary: "primary", spec: "spec"}
        errs: Dict[str, BaseException] = {}
        while pending:
            done, _ = futures_wait(list(pending), timeout=0.05,
                                   return_when=FIRST_COMPLETED)
            if not done:
                lifecycle.check_current("pipeline-wait")
                continue
            for fut in done:
                who = pending.pop(fut)
                err = fut.exception()
                if err is None:
                    for loser in pending:
                        loser.cancel()
                    # contract: ok bounded-wait — fut came from the
                    # FIRST_COMPLETED done set: already resolved,
                    # result() returns without blocking
                    return who, fut.result(), None
                errs[who] = err
        return "none", None, errs.get("primary") or errs.get("spec")


def reader_speculation(conf) -> Optional[ReadSpeculation]:
    """A ReadSpeculation when `shuffle.speculation.enabled`, else None."""
    from ..config import (SHUFFLE_SPECULATION_ENABLED,
                          SHUFFLE_SPECULATION_MAX_INFLIGHT,
                          SHUFFLE_SPECULATION_MIN_MS,
                          SHUFFLE_SPECULATION_MULTIPLIER)
    if not conf.get(SHUFFLE_SPECULATION_ENABLED):
        return None
    return ReadSpeculation(conf.get(SHUFFLE_SPECULATION_MULTIPLIER),
                           conf.get(SHUFFLE_SPECULATION_MIN_MS),
                           conf.get(SHUFFLE_SPECULATION_MAX_INFLIGHT))


# ---------------------------------------------------------------------------
# dispatch hang bound
# ---------------------------------------------------------------------------

def cuda_ready(device=None) -> Optional[Callable[[], bool]]:
    """A predicate that turns true once the work enqueued so far on
    `device`'s current CUDA stream is done (an event recorded now and
    queried); None for the CPU, whose work is done when it returns."""
    import torch
    if device is not None and getattr(device, "type", device) != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event.query


def await_ready(ready: Optional[Callable[[], bool]], timeout_ms: int,
                domain: str, what: str) -> None:
    """Poll `ready()` on this thread until it is true or `timeout_ms`
    passes; past it, count, emit `dispatch_timeout` and raise
    DispatchTimeoutError. The polls back off from 20 us to 1 ms."""
    if ready is None or ready():
        return
    deadline = time.monotonic() + max(1, int(timeout_ms)) / 1000.0
    pause = 20e-6
    while not ready():
        if time.monotonic() >= deadline:
            _count("dispatch_timeouts")
            from ..obs import events as obs_events
            obs_events.emit("dispatch_timeout", domain=domain, what=what,
                            timeout_ms=int(timeout_ms))
            from ..faults import DispatchTimeoutError
            raise DispatchTimeoutError(
                f"{what}: device work not done after {timeout_ms}ms "
                f"(domain {domain}); the attempt goes to the task-retry "
                f"lane")
        time.sleep(pause)
        pause = min(pause * 2, 1e-3)


def timed_call(fn: Callable[[], object], timeout_ms: int, domain: str,
               what: str, ready: Optional[Callable[[], Callable[[], bool]]]
               = None):
    """Run `fn()` (a launch) on this thread, then wait for its device
    work under the hang bound. `ready` makes the done-predicate after
    the launch (default `cuda_ready` on the current device when a card is
    present, else nothing to wait for). Results and errors of `fn` pass
    through."""
    out = fn()
    if ready is None:
        import torch
        pred = cuda_ready() if torch.cuda.is_available() else None
    else:
        pred = ready()
    await_ready(pred, timeout_ms, domain, what)
    return out


def dispatch_timeout_ms(conf=None) -> int:
    """The configured hang bound (0 = off), read by the dispatch ledger's
    configure(), never per dispatch."""
    from ..config import DISPATCH_TIMEOUT_MS, active_conf
    conf = conf if conf is not None else active_conf()
    return max(0, int(conf.get(DISPATCH_TIMEOUT_MS)))


_domain_tls = threading.local()


@contextlib.contextmanager
def dispatch_domain(domain: str):
    """Hang-bounded dispatches inside this block name `domain` in their
    timeout event (the JAX package's ICI round sets `ici_exchange`).
    Nests; restores on exit."""
    prev = getattr(_domain_tls, "domain", None)
    _domain_tls.domain = domain
    try:
        yield
    finally:
        _domain_tls.domain = prev


def current_dispatch_domain() -> str:
    return getattr(_domain_tls, "domain", None) or "device_dispatch"


# ---------------------------------------------------------------------------
# dead-peer map-output invalidation
# ---------------------------------------------------------------------------

def on_peer_dead(executor_id: str) -> None:
    """The HeartbeatManager's dead-peer hook (wired by
    parallel/heartbeat.install): invalidate the dead peer's registered
    map outputs, so the next read recovers them through the
    partition-granular lane. Gated by
    `shuffle.deadPeerInvalidation.enabled`; runs outside the heartbeat
    lock, on whatever thread noticed the transition."""
    from ..config import DEAD_PEER_INVALIDATION_ENABLED, active_conf
    if not active_conf().get(DEAD_PEER_INVALIDATION_ENABLED):
        return
    from ..shuffle.manager import shuffle_manager
    n = shuffle_manager().invalidate_peer_outputs(executor_id)
    if n:
        _count("peer_invalidations")
        _count("outputs_invalidated", n)
