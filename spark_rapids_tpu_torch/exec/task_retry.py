"""Task-attempt re-execution — the counterpart of
spark_rapids_tpu/exec/task_retry.py (Spark's task scheduler retrying a
failed task attempt).

A "task" is one driven query (DataFrame.collect): when an attempt dies
with a transient failure (faults.classify -> "task": an injected fault,
a checksum-quarantined spill file or shuffle block), its outputs are
discarded and the plan re-executes from the sources, up to
spark.rapids.tpu.task.maxAttempts attempts with capped exponential
backoff from spark.rapids.tpu.task.retryBackoffMs. OOM stays on the
with_retry spill/split lane (memory/retry.py); everything "fatal" —
a CUDA error among them — surfaces at once. The settle and backoff
between attempts accrue to the `retry-backoff` phase, and a governed
query's deadline is checked through the sleep.

`task_attempt()` exposes the current attempt number thread-locally, and
pipeline producers adopt it (`capture_attempt`/`adopt_attempt`).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, TypeVar

from ..config import (TASK_MAX_ATTEMPTS, TASK_RETRY_BACKOFF_MS, RapidsConf,
                      active_conf)
from .. import faults
from ..faults import TpuTaskRetryError, classify  # noqa: F401 — re-export

T = TypeVar("T")

_BACKOFF_CAP_MS = 5000

_tls = threading.local()

#: total task re-executions in this process
_retry_count = 0
_retry_lock = threading.Lock()


def task_attempt() -> int:
    """The current task attempt number (1-based; 1 outside any
    with_task_retry scope)."""
    return getattr(_tls, "attempt", 1)


def capture_attempt() -> Optional[int]:
    """The raw attempt thread-local (None outside a retry scope), for a
    pipeline producer to adopt."""
    return getattr(_tls, "attempt", None)


def adopt_attempt(attempt: Optional[int]) -> None:
    """Install a captured attempt on this (producer) thread."""
    if attempt is None:
        if hasattr(_tls, "attempt"):
            del _tls.attempt
    else:
        _tls.attempt = attempt


def task_retry_total() -> int:
    return _retry_count


def _backoff_s(attempt: int, base_ms: int, label: str) -> float:
    # the label in the jitter key: concurrent tasks retrying at the same
    # attempt spread out instead of re-herding in lockstep
    return faults.backoff_s(attempt, base_ms, _BACKOFF_CAP_MS,
                            f"task:{label}:{attempt}")


def _settle_between_attempts() -> None:
    """Let the failed attempt's spill writebacks land (their budget
    releases with them), so the fresh attempt starts from settled
    accounting. Best effort, but a failure is emitted."""
    from ..memory.catalog import buffer_catalog
    try:
        buffer_catalog().drain_writeback()
    except Exception as e:  # noqa: BLE001 — settling is best-effort
        from ..obs import events as obs_events
        obs_events.emit("task_retry_settle_error",
                        error=f"{type(e).__name__}: {e}"[:200])


def with_task_retry(run: Callable[[int], T],
                    conf: Optional[RapidsConf] = None,
                    label: str = "query") -> T:
    """Execute `run(attempt)` with bounded task-level re-execution.
    `run` must be restartable from the sources (DataFrame.collect
    rebuilds its exec tree every attempt). Non-transient errors and
    exhausted attempts propagate with their traceback."""
    global _retry_count
    conf = conf if conf is not None else active_conf()
    max_attempts = max(1, conf.get(TASK_MAX_ATTEMPTS))
    base_ms = max(1, conf.get(TASK_RETRY_BACKOFF_MS))
    prev = getattr(_tls, "attempt", None)
    from . import lifecycle
    try:
        attempt = 0
        while True:
            attempt += 1
            _tls.attempt = attempt
            lifecycle.begin_attempt(attempt)
            try:
                result = run(attempt)
                lifecycle.attempt_succeeded()
                return result
            except Exception as e:  # noqa: BLE001 — classified below
                transient = classify(e) == "task"
                if transient:
                    lifecycle.attempt_failed(e)
                if not transient or attempt >= max_attempts:
                    raise
                # a cancelled or expired query burns no further attempt
                lifecycle.check_current("task-retry")
                with _retry_lock:
                    _retry_count += 1
                backoff = _backoff_s(attempt, base_ms, label)
                from ..obs import events as obs_events
                prov = getattr(e, "provenance", None)
                extra = {"provenance": prov} if prov else {}
                obs_events.emit(
                    "task_retry", label=label, attempt=attempt,
                    max_attempts=max_attempts,
                    backoff_ns=int(backoff * 1e9), lane="whole_plan",
                    error=f"{type(e).__name__}: {e}"[:200], **extra)
                lifecycle.set_phase("retrying")
                from ..obs import phase as obs_phase
                t0b = time.perf_counter_ns()
                try:
                    _settle_between_attempts()
                    # deadline-aware backoff: a governed query's deadline
                    # can expire mid-sleep
                    end = time.monotonic() + backoff
                    while True:
                        lifecycle.check_current("task-retry")
                        remaining = end - time.monotonic()
                        if remaining <= 0:
                            break
                        time.sleep(min(0.05, remaining))
                finally:
                    obs_phase.add("retry-backoff",
                                  time.perf_counter_ns() - t0b)
    finally:
        if prev is None:
            if hasattr(_tls, "attempt"):
                del _tls.attempt
        else:
            _tls.attempt = prev
