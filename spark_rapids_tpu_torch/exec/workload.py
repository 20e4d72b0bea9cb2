"""Concurrent workload governor — the counterpart of
spark_rapids_tpu/exec/workload.py: fair admission, per-query memory
quotas, overload shedding.

* **Admission** — `admitted()` wraps every governed collect. At most
  `spark.rapids.tpu.workload.maxConcurrentQueries` queries run; up to
  `workload.queueDepth` more wait in the queue, granted in
  priority-then-FIFO order (`PRIORITIES`: interactive before batch) with
  aging: every AGING_EVERY-th grant goes to the oldest waiter whatever
  its class (`pick_fair`, shared with the device semaphore). The
  deadline spans the queue wait (the QueryContext is installed before
  admission), `cancel_query()` dequeues a queued query, and the wait
  accrues to the `admission-wait` phase.

* **Per-query memory quotas** — each admitted query gets a soft share of
  the device budget, max(budget * memoryQuotaFraction,
  budget / admitted), rebalanced as queries finish. The budget manager
  (memory/budget.py) consults it on the pressure path only: an
  over-quota query spills its own catalog entries first (quota_spill)
  and surfaces the rest as its own TpuRetryOOM. Tickets ride the
  QueryContext, so pipeline producers inherit them.

* **Overload shedding** — queue-full, admission-timeout and
  deadline-infeasible arrivals fail fast with QueryAdmissionError
  (classified fatal) carrying a `retry_after_ms` hint.
  `TpuSession.health()` reports the queue depth, the admitted count and
  the counters. Arrivals are also shed while the `device_dispatch`
  breaker (compiled stages, exec/lifecycle.py) is open, as in the JAX
  package.

Disabled (`spark.rapids.tpu.workload.enabled`, default false) the module
costs one conf read per collect and nothing per batch.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

#: admission states a query moves through (docs/robustness.md table is
#: lint-checked against this, like the breaker tables)
ADMISSION_STATES = ("queued", "admitted", "shed", "cancelled", "released")

#: priority class -> rank (lower = preferred). The admission queue and
#: the device semaphore both order waiters by (rank, FIFO seq); the
#: docs table is lint-checked against this registry.
PRIORITIES: Dict[str, int] = {"interactive": 0, "batch": 1}

#: aging cadence shared by admission and the semaphore: every
#: AGING_EVERY-th grant picks the OLDEST waiter regardless of priority
#: class — the deterministic no-starvation guarantee (a batch waiter is
#: granted within AGING_EVERY * queue-length grants, worst case)
AGING_EVERY = 4

#: admission-log records kept (arrivals and grants)
_LOG_MAX = 4096


class QueryAdmissionError(RuntimeError):
    """The workload governor refused to start this query (queue full,
    admission timeout, or a known-degraded device). Classified `fatal`
    by faults.classify — retrying immediately would re-ask a saturated
    engine; `retry_after_ms` is the earliest sensible resubmit hint."""

    def __init__(self, msg: str, reason: str = "queue_full",
                 retry_after_ms: int = 0):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_ms = retry_after_ms


def priority_rank(name: str) -> int:
    return PRIORITIES.get(str(name).strip().lower(),
                          PRIORITIES["interactive"])


def pick_fair(items, grants: int, rank, seq):
    """THE priority-then-FIFO-with-aging selection rule, shared by the
    admission queue and the device semaphore's permit pool (fairness
    must hold identically at both gates — docs/robustness.md): normally
    min (rank, seq); every AGING_EVERY-th grant the oldest item
    outright, so the lower class cannot starve. `rank`/`seq` are
    accessors over the waiter type. Returns None when empty."""
    if not items:
        return None
    if grants % AGING_EVERY == AGING_EVERY - 1:
        return min(items, key=seq)
    return min(items, key=lambda x: (rank(x), seq(x)))


class Ticket:
    """One query's admission record. `device_bytes` is the quota
    accounting surface — charged/discharged by the buffer catalog as
    entries it owns move on/off the DEVICE tier. `quota_frac` is
    captured from the ADMITTING conf (the reserving thread's
    active_conf may be unrelated — the same class of bug
    _max_concurrent guards release() against)."""

    _ids = itertools.count(1)

    __slots__ = ("ticket_id", "priority", "rank", "state", "seq",
                 "enqueued_at", "device_bytes", "quota_frac")

    def __init__(self, priority: str = "interactive", seq: int = 0,
                 quota_frac: float = 0.5):
        self.ticket_id = next(Ticket._ids)
        self.priority = priority if priority in PRIORITIES \
            else "interactive"
        self.rank = PRIORITIES[self.priority]
        self.state = "queued"
        self.seq = seq
        self.enqueued_at = time.monotonic()
        self.device_bytes = 0
        self.quota_frac = quota_frac


class WorkloadManager:
    """Process-wide admission queue + quota bookkeeping. All state under
    one condition; grants happen inside `_pump_locked` whenever a slot
    frees or an arrival finds one open."""

    def __init__(self):
        self._cond = threading.Condition()
        self._queued: List[Ticket] = []
        self._admitted: List[Ticket] = []
        self._seq = itertools.count(1)
        self._grants = 0
        #: the admission cap of the most recent admit() — release()
        #: pumps with THIS, not the releasing thread's active_conf():
        #: a caller may admit with a conf never installed thread-locally,
        #: and a mismatched cap would over-admit past the configured
        #: slots or leave freed slots to the waiters' 50ms self-poll
        self._max_concurrent = 4
        #: the admission log, in lock order: ("arrive", seq, rank) when
        #: a ticket joins the queue, ("grant", seq) when it is admitted,
        #: ("leave", seq) when it leaves the queue ungranted — what
        #: `replay_grants` checks the fairness rule against
        self._log: deque = deque(maxlen=_LOG_MAX)
        self._counters: Dict[str, int] = {
            "queued": 0, "admitted": 0, "shed": 0,
            "cancelled_in_queue": 0, "quota_spills": 0,
        }

    # -- fair ordering -----------------------------------------------------
    def _pick_next(self) -> Optional[Ticket]:
        """Next queued ticket under the shared weighted-fair-with-aging
        rule (pick_fair)."""
        return pick_fair(self._queued, self._grants,
                         rank=lambda t: t.rank, seq=lambda t: t.seq)

    def _pump_locked(self, max_concurrent: int,
                     pending: List[tuple]) -> None:
        """Grant queued tickets while slots are free (caller holds the
        condition). Events are APPENDED to `pending`, not emitted: the
        condition also serializes the per-batch charge/discharge hot
        path, so event-bus file I/O must happen after the caller
        releases it (_flush)."""
        granted = False
        while len(self._admitted) < max_concurrent:
            t = self._pick_next()
            if t is None:
                break
            self._queued.remove(t)
            self._grants += 1
            self._log.append(("grant", t.seq))
            t.state = "admitted"
            self._admitted.append(t)
            self._counters["admitted"] += 1
            granted = True
            pending.append(("query_admitted", dict(
                priority=t.priority,
                wait_ms=int((time.monotonic() - t.enqueued_at) * 1000),
                admitted=len(self._admitted),
                queued=len(self._queued))))
        if granted:
            self._cond.notify_all()

    @staticmethod
    def _flush(pending: List[tuple]) -> None:
        """Emit buffered (kind, fields) events — always OUTSIDE the
        condition."""
        if not pending:
            return
        from ..obs import events as obs_events
        for kind, fields in pending:
            obs_events.emit(kind, **fields)
        pending.clear()

    # -- admission ---------------------------------------------------------
    def admit(self, conf, ctx=None) -> Ticket:
        """Block until this query is admitted, or shed it. `ctx` is the
        governing QueryContext (deadline + cancellation span the queue
        wait); None runs admission without cancellation (callers
        driving exec trees directly)."""
        from ..config import (WORKLOAD_ADMISSION_TIMEOUT_MS,
                              WORKLOAD_MAX_CONCURRENT,
                              WORKLOAD_MEMORY_QUOTA_FRACTION,
                              WORKLOAD_PRIORITY, WORKLOAD_QUEUE_DEPTH)
        max_concurrent = max(1, conf.get(WORKLOAD_MAX_CONCURRENT))
        queue_depth = max(0, conf.get(WORKLOAD_QUEUE_DEPTH))
        timeout_ms = max(0, conf.get(WORKLOAD_ADMISSION_TIMEOUT_MS))
        priority = conf.get(WORKLOAD_PRIORITY)
        quota_frac = conf.get(WORKLOAD_MEMORY_QUOTA_FRACTION)
        # shed BEFORE queueing into a known-degraded device: an open
        # device_dispatch breaker means dispatches are currently dying —
        # admitting would spend this query's whole retry budget on them.
        # Read-only consult (no half-open transition: recovery probes
        # belong to already-running attempts, not to admission).
        from . import lifecycle
        cooldown_ms = lifecycle.breaker_shed_hint_ms("device_dispatch",
                                                     conf)
        t_adm0 = time.monotonic_ns()
        pending: List[tuple] = []
        try:
            if cooldown_ms is not None:
                self._shed("breaker_open", cooldown_ms, priority, None,
                           pending)
            with self._cond:
                self._max_concurrent = max_concurrent
                t = Ticket(priority, seq=next(self._seq),
                           quota_frac=quota_frac)
                if len(self._admitted) < max_concurrent \
                        and not self._queued:
                    # free slot, empty queue: grant through the one
                    # shared path (no queue residency — wait_ms ~0)
                    self._queued.append(t)
                    self._log.append(("arrive", t.seq, t.rank))
                    self._pump_locked(max_concurrent, pending)
                    assert t.state == "admitted"
                    if ctx is not None:
                        ctx.phase = "admitted"
                    return t
                if len(self._queued) >= queue_depth:
                    # "come back after roughly one admission turn" —
                    # the admission TIMEOUT is a queue-wait bound, not
                    # a queue-full backoff; don't conflate them
                    self._shed("queue_full", 100, priority, t, pending)
                if ctx is not None and ctx.deadline is not None \
                        and ctx.deadline - time.monotonic() <= 0:
                    # the query's whole wall-clock budget is already
                    # gone: queueing could only hand a dead query a slot
                    self._shed("deadline_infeasible", 100, priority, t,
                               pending)
                self._queued.append(t)
                self._log.append(("arrive", t.seq, t.rank))
                self._counters["queued"] += 1
                if ctx is not None:
                    ctx.phase = "queued"
                pending.append(("query_queued", dict(
                    priority=t.priority, queued=len(self._queued),
                    admitted=len(self._admitted))))
            deadline = (time.monotonic() + timeout_ms / 1000.0
                        if timeout_ms else None)
            while True:
                # each 50ms turn re-enters the condition for the checks
                # and exits to flush — buffered events (incl. grants
                # this waiter's pump handed to OTHERS) never sit behind
                # a parked wait
                self._flush(pending)
                with self._cond:
                    try:
                        self._pump_locked(max_concurrent, pending)
                        if t.state != "queued":
                            if ctx is not None:
                                ctx.phase = "admitted"
                            break
                        if deadline is not None \
                                and time.monotonic() >= deadline:
                            # the wait already proved the queue moves
                            # slower than the configured bound
                            self._shed("timeout",
                                       max(timeout_ms, 100), priority,
                                       t, pending)
                        if ctx is not None:
                            # deadline expiry / cancel_query() while
                            # queued: raises QueryCancelledError with
                            # admission-wait phase attribution
                            ctx.check("admission-wait")
                        self._cond.wait(0.05)
                    except BaseException:
                        if t in self._queued:
                            self._queued.remove(t)
                            self._log.append(("leave", t.seq))
                        if t.state == "queued":
                            t.state = "cancelled"
                            self._counters["cancelled_in_queue"] += 1
                        elif t.state == "admitted":
                            # another thread's pump granted t while an
                            # async exception (KeyboardInterrupt) was
                            # landing in wait(): the caller never sees
                            # the ticket, so release() would never run
                            # — free the slot now or it leaks for the
                            # process lifetime
                            if t in self._admitted:
                                self._admitted.remove(t)
                            t.state = "released"
                            self._pump_locked(max_concurrent, pending)
                        self._cond.notify_all()
                        raise
            # phase attribution: the queue residency this
            # slow path just sat out is the query's admission-wait
            # share (the fast-path grant above never queues — ~0 wait)
            from ..obs import phase as obs_phase
            obs_phase.add("admission-wait",
                          time.monotonic_ns() - t_adm0)
            return t
        finally:
            self._flush(pending)

    def _shed(self, reason: str, retry_after_ms: int, priority: str,
              ticket: Optional[Ticket], pending: List[tuple]) -> None:
        """THE shed path: counter + ticket state + buffered event +
        raise, in one place (a reason added later cannot miss one of
        the side effects). Safe with or without the condition held —
        it is re-entrant; the event lands in `pending` and the caller's
        finally emits it outside the lock."""
        with self._cond:
            self._counters["shed"] += 1
            if ticket is not None:
                ticket.state = "shed"
        pending.append(("query_shed", dict(
            reason=reason, priority=priority,
            retry_after_ms=retry_after_ms)))
        raise QueryAdmissionError(
            f"query admission shed ({reason}); retry after "
            f"~{retry_after_ms}ms", reason=reason,
            retry_after_ms=retry_after_ms)

    def release(self, ticket: Ticket) -> None:
        """Query end (success, failure or cancellation): free the slot,
        rebalance quotas, grant the next fair waiter — under the cap
        the queries were ADMITTED with (the releasing thread's
        active_conf may be unrelated, e.g. a pool thread)."""
        pending: List[tuple] = []
        with self._cond:
            if ticket in self._admitted:
                self._admitted.remove(ticket)
            elif ticket in self._queued:  # defensive: never left queued
                self._queued.remove(ticket)
                self._log.append(("leave", ticket.seq))
            ticket.state = "released"
            self._pump_locked(self._max_concurrent, pending)
            self._cond.notify_all()
        self._flush(pending)

    # -- quotas ------------------------------------------------------------
    def quota_bytes(self, limit: int, frac: float) -> Optional[int]:
        """The soft per-admitted-query device share right now, or None
        when unlimited (nothing admitted). A lone query always gets the
        whole budget; shares grow back as neighbors finish."""
        with self._cond:
            n = len(self._admitted)
        if n <= 1:
            return None
        return max(int(limit * frac), limit // n)

    def note_quota_spill(self) -> None:
        with self._cond:
            self._counters["quota_spills"] += 1

    # -- accounting / surfaces ---------------------------------------------
    def charge(self, ticket: Optional[Ticket], nbytes: int) -> None:
        if ticket is None:
            return
        with self._cond:
            ticket.device_bytes += nbytes

    def discharge(self, ticket: Optional[Ticket], nbytes: int) -> None:
        if ticket is None:
            return
        with self._cond:
            ticket.device_bytes = max(0, ticket.device_bytes - nbytes)

    def counters(self) -> Dict[str, int]:
        with self._cond:
            return dict(self._counters)

    def admission_log(self) -> List[tuple]:
        with self._cond:
            return list(self._log)

    def snapshot(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "queue_depth": len(self._queued),
                "admitted": len(self._admitted),
                "counters": dict(self._counters),
            }


_manager: Optional[WorkloadManager] = None
_manager_lock = threading.Lock()


def manager() -> WorkloadManager:
    global _manager
    with _manager_lock:
        if _manager is None:
            _manager = WorkloadManager()
        return _manager


def reset_workload() -> WorkloadManager:
    """Test isolation (the conftest module tripwire)."""
    global _manager
    with _manager_lock:
        _manager = WorkloadManager()
        return _manager


@contextlib.contextmanager
def admitted(conf=None, ctx=None) -> Iterator[Optional[Ticket]]:
    """Admission around one driven query. With the governor disabled
    (spark.rapids.tpu.workload.enabled=false, the default) this is one
    conf read and no ticket. The ticket rides the QueryContext so every
    thread serving the query (pipeline producers adopt the context)
    resolves the same quota accounting."""
    from ..config import WORKLOAD_ENABLED, active_conf
    conf = conf if conf is not None else active_conf()
    if not conf.get(WORKLOAD_ENABLED):
        yield None
        return
    from . import lifecycle
    if ctx is None:
        ctx = lifecycle.current_context()
    ticket = manager().admit(conf, ctx)
    if ctx is not None:
        ctx.workload_ticket = ticket
    try:
        yield ticket
    finally:
        if ctx is not None:
            ctx.workload_ticket = None
        manager().release(ticket)


def current_ticket() -> Optional[Ticket]:
    """The admitted ticket of this thread's governed query (None when
    ungoverned or the governor is off) — resolved through the
    QueryContext, so producer threads inherit it with adopt_context."""
    from . import lifecycle
    ctx = lifecycle.current_context()
    if ctx is None:
        return None
    return getattr(ctx, "workload_ticket", None)


def current_priority_rank() -> int:
    """Semaphore-waiter ordering hook: the rank of this thread's
    query's priority class (interactive when ungoverned)."""
    t = current_ticket()
    return t.rank if t is not None else PRIORITIES["interactive"]


def charge(ticket: Optional[Ticket], nbytes: int) -> None:
    """Catalog hook: `nbytes` of device budget now attributed to
    `ticket`'s query (mirrors every memory_budget().reserve a catalog
    entry makes). None-ticket is the disabled/ungoverned fast path."""
    if ticket is not None:
        manager().charge(ticket, nbytes)


def discharge(ticket: Optional[Ticket], nbytes: int) -> None:
    """Catalog hook: device budget released for `ticket`'s query."""
    if ticket is not None:
        manager().discharge(ticket, nbytes)


def quota_bytes(limit: int) -> Optional[int]:
    """The current thread's query's soft device share of `limit`, or
    None (no quota: governor off, query ungoverned, fraction <= 0, or
    it is the only admitted query). Consulted by memory/budget.py on
    the pressure path only; the fraction is the one the query was
    ADMITTED with (Ticket.quota_frac)."""
    t = current_ticket()
    if t is None or _manager is None or t.quota_frac <= 0:
        return None
    return _manager.quota_bytes(limit, t.quota_frac)


def note_quota_spill(ticket: Ticket, need: int, quota: int,
                     freed: int) -> None:
    """An over-quota query under budget pressure spilled its own
    working set: one quota_spill event + counter."""
    manager().note_quota_spill()
    from ..obs import events as obs_events
    obs_events.emit("quota_spill", need=need, quota=quota, freed=freed,
                    device_bytes=ticket.device_bytes,
                    priority=ticket.priority)


def admission_log() -> List[tuple]:
    """The manager's admission log (arrivals and grants, in order)."""
    m = _manager
    return m.admission_log() if m is not None else []


def replay_grants(log: List[tuple]) -> List[int]:
    """`pick_fair` replayed on a log's arrivals: the ticket seq each
    grant must have gone to (a log whose grants equal this list was
    granted by the fairness rule). The log must start with an empty
    queue and no grant (a fresh manager)."""
    queue: List[tuple] = []
    grants = 0
    out: List[int] = []
    for rec in log:
        if rec[0] == "arrive":
            queue.append((rec[2], rec[1]))
            continue
        if rec[0] == "leave":
            queue = [w for w in queue if w[1] != rec[1]]
            continue
        pick = pick_fair(queue, grants, rank=lambda w: w[0],
                         seq=lambda w: w[1])
        queue.remove(pick)
        grants += 1
        out.append(pick[1])
    return out


def counters() -> Dict[str, int]:
    """Process-cumulative workload counters."""
    m = _manager
    if m is None:
        return {"queued": 0, "admitted": 0, "shed": 0,
                "cancelled_in_queue": 0, "quota_spills": 0}
    return m.counters()


def snapshot() -> Dict[str, Any]:
    """The TpuSession.health() workload section."""
    m = _manager
    if m is None:
        return {"queue_depth": 0, "admitted": 0, "counters": counters()}
    return m.snapshot()
