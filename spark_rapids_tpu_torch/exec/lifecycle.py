"""Query lifecycle governor — the counterpart of
spark_rapids_tpu/exec/lifecycle.py: deadlines and cooperative
cancellation, partition-recompute accounting, and the degradation
circuit breakers.

* **QueryContext** — one cancellation token per driven query.
  `DataFrame.collect()` installs it thread-locally (pipeline producer
  threads adopt it, as they adopt the conf and the query id);
  `TpuExec`'s drive loop ticks it every batch (one pointer check when no
  query is governed), and the blocking seams — the admission semaphore,
  pipeline stage waits, spill-writeback waits, the admission queue —
  check it inside their poll loops. A deadline
  (`spark.rapids.tpu.query.timeoutMs`, spanning every task attempt) or
  `TpuSession.cancel_query()` makes every checker raise
  `QueryCancelledError`; the query unwinds through the try/finally
  chains (stages join, spillables close, the budget settles) and one
  `query_cancelled` event records where the cancellation was noticed
  (`CANCEL_PHASES`).

* **Partition-recompute accounting** — the counter the shuffle's
  lineage recovery bumps (shuffle/manager.py).

* **The stall verdict** — the progress watchdog
  (exec/speculation_shield.py) sets `stall_retry` under
  `stall.action=retry-seam`; the next cancellation checkpoint consumes
  it and raises `QueryStalledError`, a transient error, onto the
  task-retry lane. `adaptive_batch_target` carries the OOM-feedback
  batch right-sizing (exec/adaptive.py) across the query's attempts.

* **Circuit breakers** — a sliding failure window per fault domain:
  past `spark.rapids.tpu.breaker.threshold` failures inside `windowMs`
  the breaker opens and the domain takes its safe path until a
  post-cooldown half-open probe succeeds. The JAX package maps its
  Pallas kernel families onto domains and an open breaker demotes a
  kernel to its XLA tier. The port has no tier switch, and a breaker
  that sent a CUDA kernel to its plain PyTorch version would be the
  fallback the port forbids (ROADMAP C): the port keeps only the
  domains whose safe path is another real plan — `adaptive`, whose
  safe path is the static plan; `device_dispatch`, whose safe path
  demotes a compiled stage (exec/stage_compiler.py) to the per-operator
  execs over the same sources, which launch the same hand-written
  kernels; and `ici_exchange`, whose safe path is the host exchange's
  serialize lane instead of its device lane, the same partition ids and
  reorders on the same kernels. A kernel family's transient attempt
  failures are counted (`kernel_failures()`) and emitted
  (`kernel_failure`), and never change the route. `health()` reports
  the JAX package's sections.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, Iterator, List, Optional


class QueryCancelledError(RuntimeError):
    """The governed query was cancelled (deadline or user) — classified
    "fatal" by faults.classify, so it unwinds straight through the
    task-retry layer."""

    def __init__(self, msg: str, phase: str = "compute",
                 reason: str = "user"):
        super().__init__(msg)
        self.phase = phase
        self.reason = reason


#: phases a cancellation can be noticed in; admission-wait is the
#: workload governor's queue (exec/workload.py)
CANCEL_PHASES = ("compute", "sem-wait", "pipeline-wait", "spill-wait",
                 "task-retry", "admission-wait")


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

_counter_lock = threading.Lock()
_counters: Dict[str, int] = {
    "cancelled": 0,
    "partition_recompute": 0,
    "breaker_open": 0,
    "breaker_half_open": 0,
    "breaker_close": 0,
}
#: kernel family -> transient attempt failures that engaged it
_kernel_failures: Dict[str, int] = {}


def _count(key: str) -> None:
    with _counter_lock:
        _counters[key] += 1


def counters() -> Dict[str, int]:
    """The process-cumulative lifecycle counters, plus the whole-plan
    re-execution total of exec/task_retry.py."""
    from .task_retry import task_retry_total
    with _counter_lock:
        out = dict(_counters)
    out["whole_plan_retries"] = task_retry_total()
    return out


def kernel_failures() -> Dict[str, int]:
    with _counter_lock:
        return dict(_kernel_failures)


def note_partition_recompute() -> None:
    """One map output recomputed in place (the shuffle's lineage lane)."""
    _count("partition_recompute")


# ---------------------------------------------------------------------------
# QueryContext + registry
# ---------------------------------------------------------------------------

_tls = threading.local()

_reg_lock = threading.Lock()
_active: Dict[int, "QueryContext"] = {}


class QueryContext:
    """Per-query cancellation token, deadline and engagement notes,
    shared by every thread serving the query; thread-safe."""

    _ids = itertools.count(1)

    __slots__ = ("ctx_id", "owner", "t0", "deadline", "check_every",
                 "_cancel", "reason", "_ticks", "_emit_lock", "_emitted",
                 "engaged_domains", "engaged_families", "workload_ticket",
                 "phase", "current_op", "root_op_id", "batches_produced",
                 "rows_produced", "attempt_no", "spill_count",
                 "spill_bytes", "runtime_stats", "phase_ledger",
                 "events_qid", "cancel_noticed", "adaptive_batch_target",
                 "stall_retry")

    def __init__(self, timeout_ms: int = 0, check_every: int = 8,
                 owner: Any = None):
        self.ctx_id = next(QueryContext._ids)
        self.owner = owner
        self.t0 = time.monotonic()
        self.deadline = (self.t0 + timeout_ms / 1000.0
                         if timeout_ms and timeout_ms > 0 else None)
        self.check_every = max(1, check_every)
        self._cancel = threading.Event()
        self.reason: Optional[str] = None
        self._ticks = 0
        self._emit_lock = threading.Lock()
        self._emitted = False
        #: breaker domains this attempt engaged; cleared per attempt
        self.engaged_domains: set = set()
        #: CUDA kernel families this attempt launched; cleared per attempt
        self.engaged_families: set = set()
        #: the workload governor's admission ticket (exec/workload.py)
        self.workload_ticket = None
        # -- live introspection (read lock-free by active_queries()) --
        #: queued | admitted | executing | retrying
        self.phase = "executing"
        #: operator that most recently yielded a batch on any thread
        self.current_op: Optional[str] = None
        #: the plan root's op id: batches/rows count root output only
        self.root_op_id = -1
        self.batches_produced = 0
        self.rows_produced = 0
        self.attempt_no = 1
        self.spill_count = 0
        self.spill_bytes = 0
        #: per-attempt RuntimeStats (obs/stats.py)
        self.runtime_stats = None
        #: per-query phase ledger (obs/phase.py), or None
        self.phase_ledger = None
        #: the events-plane id of the latest attempt's query_scope
        self.events_qid = None
        #: (phase, monotonic s) of the first checker that raised
        self.cancel_noticed: Optional[tuple] = None
        #: the batch target halved after an OOM split (exec/adaptive.py),
        #: read by CoalesceBatchesExec; kept across attempts
        self.adaptive_batch_target: Optional[int] = None
        #: the watchdog's retry-seam verdict, consumed once by check()
        self.stall_retry = False

    def note_batch(self, op: str, op_id: int,
                   rows: Optional[int]) -> None:
        """Batch-boundary progress note (TpuExec's drive loop)."""
        self.current_op = op
        if op_id == self.root_op_id:
            self.batches_produced += 1
            if rows:
                self.rows_produced += rows

    def info(self) -> Dict[str, Any]:
        """One query's live introspection row."""
        now = time.monotonic()
        out = {
            "query": self.ctx_id,
            "phase": self.phase,
            "current_op": self.current_op,
            "batches": self.batches_produced,
            "rows": self.rows_produced,
            "elapsed_ms": int((now - self.t0) * 1000),
            "deadline_remaining_ms": (
                int((self.deadline - now) * 1000)
                if self.deadline is not None else None),
            "attempt": self.attempt_no,
            "spill_count": self.spill_count,
            "spill_bytes": self.spill_bytes,
            "cancelled": self._cancel.is_set(),
        }
        t = self.workload_ticket
        if t is not None:
            from ..memory.budget import memory_budget
            from . import workload
            limit = memory_budget().limit
            quota = workload.manager().quota_bytes(limit, t.quota_frac)
            out["quota"] = {
                "priority": t.priority,
                "used_bytes": t.device_bytes,
                "granted_bytes": quota if quota is not None else limit,
            }
        return out

    def cancel(self, reason: str = "user") -> None:
        if not self._cancel.is_set():
            if self.reason is None:
                self.reason = reason
            self._cancel.set()

    def cancelled(self) -> bool:
        if self._cancel.is_set():
            return True
        if self.deadline is not None and time.monotonic() >= self.deadline:
            self.cancel("timeout")
            return True
        return False

    def check(self, phase: str = "compute") -> None:
        """Raise QueryCancelledError when the query is cancelled or past
        its deadline. The first checker (any thread) emits the one
        `query_cancelled` event with its phase: the wait the query died
        in. A pending stall verdict raises QueryStalledError first."""
        if self.stall_retry:
            # consumed here, so the retried attempt starts clean
            self.stall_retry = False
            from ..faults import QueryStalledError
            raise QueryStalledError(
                f"query stalled at seam {self.current_op!r}; retrying "
                f"the attempt (noticed in phase {phase})")
        if not self.cancelled():
            return
        reason = self.reason or "user"
        emit = False
        with self._emit_lock:
            if not self._emitted:
                self._emitted = True
                self.cancel_noticed = (phase, time.monotonic())
                emit = True
        if emit:
            _count("cancelled")
            from ..obs import events as obs_events
            obs_events.emit(
                "query_cancelled", phase=phase, reason=reason,
                elapsed_ms=int((time.monotonic() - self.t0) * 1000))
        raise QueryCancelledError(
            f"query cancelled ({reason}) in phase {phase} after "
            f"{time.monotonic() - self.t0:.3f}s", phase=phase,
            reason=reason)

    def tick(self) -> None:
        """Batch-boundary hook: a counter, and a real deadline/cancel
        check every `check_every` ticks."""
        self._ticks += 1
        if self._ticks >= self.check_every:
            self._ticks = 0
            self.check("compute")


def current_context() -> Optional[QueryContext]:
    """This thread's governed query context (None outside one)."""
    return getattr(_tls, "ctx", None)


def adopt_context(ctx: Optional[QueryContext]) -> None:
    """Install a captured context on this (producer) thread."""
    _tls.ctx = ctx


def check_current(phase: str = "compute") -> None:
    """Raise QueryCancelledError if this thread's governed query is
    cancelled; one pointer check otherwise."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        ctx.check(phase)


def current_cancelled() -> bool:
    """Predicate flavor of check_current (for callers that must clean
    up before raising)."""
    ctx = getattr(_tls, "ctx", None)
    return ctx is not None and ctx.cancelled()


@contextlib.contextmanager
def governed(conf=None, owner: Any = None,
             timeout_ms: Optional[int] = None) -> Iterator[QueryContext]:
    """Install a QueryContext around one driven query (outside
    with_task_retry, so the deadline spans every attempt). Registers it
    so cancel_owner can find it; always unregisters on the way out."""
    from ..config import (QUERY_CANCEL_CHECK_BATCHES, QUERY_TIMEOUT_MS,
                          active_conf)
    conf = conf if conf is not None else active_conf()
    if timeout_ms is None:
        timeout_ms = conf.get(QUERY_TIMEOUT_MS)
    ctx = QueryContext(timeout_ms=timeout_ms,
                       check_every=conf.get(QUERY_CANCEL_CHECK_BATCHES),
                       owner=owner)
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    with _reg_lock:
        _active[ctx.ctx_id] = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev
        with _reg_lock:
            _active.pop(ctx.ctx_id, None)


def cancel_owner(owner: Any, reason: str = "user") -> int:
    """Cancel every registered context of `owner` (from any thread);
    returns how many were cancelled."""
    with _reg_lock:
        targets = [c for c in _active.values() if c.owner is owner]
    for c in targets:
        c.cancel(reason)
    return len(targets)


def active_query_ids() -> List[int]:
    with _reg_lock:
        return sorted(_active)


def set_phase(phase: str) -> None:
    """Live-introspection phase note for this thread's governed query."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        ctx.phase = phase


def note_spill(freed_bytes: int) -> None:
    """Per-query spill attribution: the catalog calls this once per
    synchronous spill that freed anything, on the thread whose
    reservation triggered it."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        ctx.spill_count += 1
        ctx.spill_bytes += freed_bytes


def active_queries(owner: Any = None) -> List[Dict[str, Any]]:
    """Live rows for every registered (in-flight) query, oldest first;
    `mine` marks the queries of `owner`."""
    with _reg_lock:
        ctxs = sorted(_active.values(), key=lambda c: c.ctx_id)
    out = []
    for c in ctxs:
        row = c.info()
        row["mine"] = owner is not None and c.owner is owner
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# degradation circuit breakers
# ---------------------------------------------------------------------------

#: domain -> (what it covers, its safe path when open): the domains whose
#: safe path is another real plan
BREAKER_DOMAINS: Dict[str, str] = {
    "adaptive": "runtime replanner (exec/adaptive.py) "
                "-> static plan: measured-statistics decisions are "
                "skipped while open",
    "device_dispatch": "compiled stages (exec/stage_compiler.py) -> "
                       "per-operator execution over the same sources, "
                       "on the same hand-written kernels",
    "ici_exchange": "the host exchange's device lane (exec/exchange.py) "
                    "-> the host serialize lane over the same kernels: "
                    "exchanges skip the lane while open",
}

#: the CUDA kernel families (the six wrappers' labels): their failures
#: are counted and emitted, never routed (module docstring)
KERNEL_FAMILIES = ("fused_scan_agg", "murmur3_columns",
                   "murmur3_long_lanes", "murmur3_int_lanes",
                   "fused_probe_verify", "dma_row_gather", "dict_gather")

BREAKER_STATES = ("closed", "open", "half_open")


class _Breaker:
    __slots__ = ("domain", "state", "failures", "opened_at", "trips",
                 "probe_at")

    def __init__(self, domain: str):
        self.domain = domain
        self.state = "closed"
        self.failures: List[float] = []  # monotonic failure timestamps
        self.opened_at = 0.0
        self.trips = 0
        #: when the half-open probe was let through (0 = none in flight)
        self.probe_at = 0.0


_breaker_lock = threading.Lock()
_breakers: Dict[str, _Breaker] = {}


def _breaker_conf(conf=None):
    from ..config import (BREAKER_COOLDOWN_MS, BREAKER_ENABLED,
                          BREAKER_THRESHOLD, BREAKER_WINDOW_MS, active_conf)
    conf = conf if conf is not None else active_conf()
    return (bool(conf.get(BREAKER_ENABLED)),
            max(1, conf.get(BREAKER_THRESHOLD)),
            max(1, conf.get(BREAKER_WINDOW_MS)) / 1000.0,
            max(1, conf.get(BREAKER_COOLDOWN_MS)) / 1000.0)


def _emit_breaker(kind: str, br: _Breaker, **fields) -> None:
    _count(kind)
    from ..obs import events as obs_events
    obs_events.emit(kind, domain=br.domain, trips=br.trips,
                    failures=len(br.failures), **fields)


def breaker_allows(domain: str) -> bool:
    """May `domain`'s path engage now? closed -> yes; open -> no until
    the cooldown, then the consult half-opens the breaker and lets one
    probe through; half_open -> only while no probe is in flight. A
    disabled conf (the kill switch) answers yes."""
    if not _breakers:
        return True
    enabled, _thr, _window, cooldown = _breaker_conf()
    if not enabled:
        return True
    emit = None
    with _breaker_lock:
        br = _breakers.get(domain)
        if br is None or br.state == "closed":
            return True
        now = time.monotonic()
        if br.state == "open":
            if now - br.opened_at < cooldown:
                return False
            br.state = "half_open"
            br.probe_at = now
            emit = br
        else:  # half_open
            if br.probe_at and now - br.probe_at <= cooldown:
                return False  # one probe at a time
            br.probe_at = now
    if emit is not None:
        _emit_breaker("breaker_half_open", emit)
    return True


def record_domain_failure(domain: str) -> None:
    """One classified-transient failure attributed to `domain`
    (spark.rapids.tpu.breaker.enabled, default off)."""
    enabled, threshold, window, _cooldown = _breaker_conf()
    if not enabled or domain not in BREAKER_DOMAINS:
        return
    now = time.monotonic()
    opened = None
    with _breaker_lock:
        br = _breakers.get(domain)
        if br is None:
            br = _breakers[domain] = _Breaker(domain)
        br.failures = [t for t in br.failures if now - t <= window]
        br.failures.append(now)
        if br.state == "half_open" or (br.state == "closed"
                                       and len(br.failures) >= threshold):
            br.state = "open"
            br.opened_at = now
            br.probe_at = 0.0
            br.trips += 1
            opened = br
    if opened is not None:
        _emit_breaker("breaker_open", opened,
                      safe_path=BREAKER_DOMAINS[domain])


def record_domain_success(domain: str) -> None:
    """A successful attempt that engaged `domain`: a half-open breaker's
    probe passed — close it."""
    if not _breakers:
        return
    closed = None
    with _breaker_lock:
        br = _breakers.get(domain)
        if br is not None and br.state == "half_open":
            br.state = "closed"
            br.failures = []
            br.probe_at = 0.0
            closed = br
    if closed is not None:
        _emit_breaker("breaker_close", closed)


def breaker_shed_hint_ms(domain: str, conf=None) -> Optional[int]:
    """Read-only admission consult: the remaining cooldown in ms while
    `domain`'s breaker is open, else None (the workload governor sheds
    while the device_dispatch breaker is open, as in the JAX package)."""
    if not _breakers:
        return None
    enabled, _thr, _window, cooldown = _breaker_conf(conf)
    if not enabled:
        return None
    with _breaker_lock:
        br = _breakers.get(domain)
        if br is None or br.state != "open":
            return None
        remaining = cooldown - (time.monotonic() - br.opened_at)
        if remaining <= 0:
            return None
        return max(1, int(remaining * 1000))


def open_breakers() -> List[str]:
    """Domains whose breaker is not closed."""
    with _breaker_lock:
        return sorted(d for d, b in _breakers.items()
                      if b.state != "closed")


# -- attempt attribution (exec/task_retry.py hooks) -------------------------

def _engaged(attr: str, create: bool = False) -> set:
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        return getattr(ctx, attr)
    s = getattr(_tls, attr, None)
    if s is None and create:
        s = set()
        setattr(_tls, attr, s)
    return s if s is not None else set()


def note_engagement(family: str) -> None:
    """A CUDA kernel family launched for the current attempt (the
    dispatch ledger's kernel sites)."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        ctx.engaged_families.add(family)
        return
    s = getattr(_tls, "engaged_families", None)
    if s is not None:
        s.add(family)


def engage_domain(domain: str) -> None:
    """Engage a breaker domain for the current attempt (the adaptive
    replanner, on each decision it applies; a compiled stage, on each
    fused execution)."""
    if domain not in BREAKER_DOMAINS:
        return
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        ctx.engaged_domains.add(domain)
        return
    s = getattr(_tls, "engaged_domains", None)
    if s is not None:
        s.add(domain)


def capture_engagement() -> Optional[tuple]:
    """The engagement sets serving this thread's attempt, captured at a
    pipeline stage boundary so producer-thread engagements land in the
    consumer's attempt."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        return ctx.engaged_domains, ctx.engaged_families
    d = getattr(_tls, "engaged_domains", None)
    f = getattr(_tls, "engaged_families", None)
    return None if d is None and f is None else (d, f)


def adopt_engagement(sets: Optional[tuple]) -> None:
    """Install captured engagement sets on this (producer) thread; the
    governed case needs nothing (adopt_context shares the context's)."""
    if sets is not None and getattr(_tls, "ctx", None) is None:
        _tls.engaged_domains, _tls.engaged_families = sets


def begin_attempt(attempt: int = 1) -> None:
    """Task-attempt start: clear the engagement notes, note the attempt
    and the executing phase on the governed context."""
    _engaged("engaged_domains", create=True).clear()
    _engaged("engaged_families", create=True).clear()
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        ctx.attempt_no = attempt
        ctx.phase = "executing"
        ctx.current_op = None
        ctx.batches_produced = 0
        ctx.rows_produced = 0


def attempt_failed(exc: BaseException) -> None:
    """A classified-transient task-attempt failure: recorded against
    every breaker domain the attempt engaged, and counted and emitted
    for every kernel family it launched (no route changes)."""
    for d in set(_engaged("engaged_domains")):
        record_domain_failure(d)
    families = sorted(_engaged("engaged_families"))
    if not families:
        return
    from ..obs import events as obs_events
    with _counter_lock:
        for f in families:
            _kernel_failures[f] = _kernel_failures.get(f, 0) + 1
    for f in families:
        obs_events.emit("kernel_failure", family=f,
                        error=f"{type(exc).__name__}: {exc}"[:200])


def attempt_succeeded() -> None:
    """A task attempt completed: a half-open breaker whose domain it
    engaged closes (the success is the probe's outcome)."""
    if not _breakers:
        return
    for d in set(_engaged("engaged_domains")):
        record_domain_success(d)


# ---------------------------------------------------------------------------
# health surface + test reset
# ---------------------------------------------------------------------------

def health() -> Dict[str, Any]:
    """The TpuSession.health() payload: breaker states, governed-query
    count, the lifecycle counters and the workload governor's
    admission surface."""
    now = time.monotonic()
    with _breaker_lock:
        breakers: Dict[str, Any] = {
            d: {"state": b.state, "trips": b.trips,
                "failures_in_window": len(b.failures),
                "open_for_ms": int((now - b.opened_at) * 1000)
                if b.state != "closed" else 0}
            for d, b in _breakers.items()}
    from . import workload
    return {"breakers": breakers,
            "kernel_failures": kernel_failures(),
            "active_queries": len(active_query_ids()),
            "counters": counters(),
            "workload": workload.snapshot()}


def reset_lifecycle() -> None:
    """Test isolation: drop every breaker, registered context and
    counter."""
    with _breaker_lock:
        _breakers.clear()
    with _reg_lock:
        _active.clear()
    with _counter_lock:
        for k in _counters:
            _counters[k] = 0
        _kernel_failures.clear()
