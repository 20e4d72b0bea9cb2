"""OOM-retry framework — the counterpart of spark_rapids_tpu/memory/retry.py
(the contract of the reference's RmmRapidsRetryIterator and its per-thread
OOM state machine).

The discipline is proactive budgeting: an operator registers its batches
with the spill catalog (memory/catalog.py), whose accounting against the
device budget (memory/budget.py) spills idle batches under pressure and
raises TpuRetryOOM when that is not enough. `with_retry` runs an
operator's step over a spillable input, spills and retries on
TpuRetryOOM, and splits the input on TpuSplitAndRetryOOM. A real
allocator failure on the card (`torch.cuda.OutOfMemoryError`) takes the
retry lane too (`is_oom_error`).

`force_retry_oom` / `force_split_and_retry_oom` arm injection on this
thread for the next guarded sections (the reference's RmmSpark test API);
`register_task` arms it from spark.rapids.sql.test.injectRetryOOM
('retry:N' or 'split:N'). `with_retry` reads its attempts and backoff
(spark.rapids.sql.retry.maxAttempts, spark.rapids.tpu.retry.backoffMs)
from its thread's active conf (a pipeline producer adopts its
consumer's).

`oom_guard` is also the `device.dispatch` fault point (faults.py). A
failure inside a guarded section takes the retry lane only when
faults.classify calls it "oom"; each retry and split is an `oom_retry`
event, and the backoff sleep accrues to the `retry-backoff` phase. A
split halves the governed query's batch target
(exec/adaptive.note_oom_split), which CoalesceBatchesExec reads.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, Iterator, List, Optional, TypeVar

import torch

from ..config import (OOM_RETRY_BACKOFF_MS, RETRY_MAX_ATTEMPTS,
                      TEST_RETRY_OOM_INJECTION_MODE, active_conf)

#: the cap of the sleep between attempts, which starts at
#: spark.rapids.tpu.retry.backoffMs and doubles per attempt
_OOM_BACKOFF_CAP_MS = 200


class TpuOOMError(MemoryError):
    pass


class TpuRetryOOM(TpuOOMError):
    """Transient: spill/wait should free memory; re-run the SAME input."""


class TpuSplitAndRetryOOM(TpuOOMError):
    """The input itself is too big: split it and run the halves."""


class CpuRetryOOM(TpuOOMError):
    """Host-memory pressure analog (reference CpuRetryOOM)."""


def is_oom_error(exc: BaseException) -> bool:
    """The card's allocator ran out: PyTorch raises
    torch.cuda.OutOfMemoryError (the reference maps XLA's
    RESOURCE_EXHAUSTED here)."""
    return isinstance(exc, torch.cuda.OutOfMemoryError)


class _TaskState(threading.local):
    def __init__(self):
        self.task_id: Optional[int] = None
        self.guarded_calls = 0
        self.inject_mode: Optional[str] = None
        self.inject_at = 0
        self.inject_remaining = 0
        self.retry_count = 0
        self.split_retry_count = 0


_state = _TaskState()


def register_task(task_id: int):
    """Associate this thread with a task; resets the retry counters and
    arms the injection that spark.rapids.sql.test.injectRetryOOM asks
    for ('retry:N' / 'split:N': at the Nth guarded section), if any."""
    _state.task_id = task_id
    _state.guarded_calls = 0
    _state.retry_count = 0
    _state.split_retry_count = 0
    inj = active_conf().get(TEST_RETRY_OOM_INJECTION_MODE)
    if inj:
        mode, _, n = inj.partition(":")
        _state.inject_mode = mode
        _state.inject_at = int(n or 1)
        _state.inject_remaining = 1
    else:
        _state.inject_mode = None
        _state.inject_remaining = 0


def unregister_task():
    _state.task_id = None
    _state.inject_mode = None


def capture_task_state() -> dict:
    """This thread's task state (task id, injection, retry counts),
    captured at a pipeline stage boundary for the producer thread."""
    return dict(vars(_state))


def adopt_task_state(state: dict) -> None:
    """Install a captured task state on this (producer) thread."""
    vars(_state).update(state)


def current_task_id() -> Optional[int]:
    return _state.task_id


def force_retry_oom(num_ooms: int = 1):
    """Arm injection on this thread for the next `num_ooms` guarded
    sections (reference RmmSpark.forceRetryOOM)."""
    _state.inject_mode = "retry"
    _state.inject_at = _state.guarded_calls + 1
    _state.inject_remaining = num_ooms


def force_split_and_retry_oom(num_ooms: int = 1):
    _state.inject_mode = "split"
    _state.inject_at = _state.guarded_calls + 1
    _state.inject_remaining = num_ooms


def oom_guard():
    """Called at the top of every guarded device section; applies the
    armed OOM injection and the `device.dispatch` fault point."""
    _state.guarded_calls += 1
    if (_state.inject_mode and _state.inject_remaining > 0
            and _state.guarded_calls >= _state.inject_at):
        _state.inject_remaining -= 1
        if _state.inject_mode == "retry":
            raise TpuRetryOOM("injected retry OOM")
        if _state.inject_mode == "split":
            raise TpuSplitAndRetryOOM("injected split-and-retry OOM")
    from ..faults import check
    check("device.dispatch")


def task_retry_counts():
    return _state.retry_count, _state.split_retry_count


T = TypeVar("T")
R = TypeVar("R")


def _oom_backoff_s(attempt: int) -> float:
    """min(base * 2^(attempt-1), cap) plus up to 25% jitter that is a
    pure hash of (task, attempt), as the reference's faults.backoff_s."""
    base_ms = active_conf().get(OOM_RETRY_BACKOFF_MS)
    if base_ms <= 0:
        return 0.0
    ms = min(base_ms * (1 << (attempt - 1)), _OOM_BACKOFF_CAP_MS)
    frac = zlib.crc32(f"oom:{_state.task_id}:{attempt}".encode()) / 2 ** 32
    return ms * (1.0 + 0.25 * frac) / 1000.0


def split_in_half_by_rows(item):
    """Default split policy: halve a (Spillable)ColumnarBatch by rows
    (reference splitSpillableInHalfByRows). The halves are registered
    before the source is released, so the accounting never undercounts
    live device memory mid-split; with_retry owns (and closes) them."""
    from .spillable import SpillableBatch
    if isinstance(item, SpillableBatch):
        batch = item.get_batch()
        try:
            a, b = _split_batch(batch)
            halves = [SpillableBatch.from_batch(a),
                      SpillableBatch.from_batch(b)]
        finally:
            item.release()
        item.close()
        return halves
    return list(_split_batch(item))


def _split_batch(batch):
    """Rows [0, n/2) and [n/2, n) at the parent's capacity (one host read
    of the row count)."""
    from ..columnar.batch import ColumnarBatch
    from ..ops.basic import slice_rows
    n = batch.num_rows_host
    if n < 2:
        raise TpuSplitAndRetryOOM("cannot split a batch with < 2 rows")
    half = n // 2
    cap = batch.capacity
    left = ColumnarBatch([slice_rows(c, 0, half, cap)
                          for c in batch.columns], half, batch.schema)
    right = ColumnarBatch([slice_rows(c, half, n - half, cap)
                           for c in batch.columns], n - half, batch.schema)
    return left, right


def with_retry(input_item: T, fn: Callable[[T], R],
               split_policy: Optional[Callable[[T], List[T]]] = None,
               ) -> Iterator[R]:
    """Run fn over input_item with OOM retry/split-retry semantics
    (reference withRetry). Yields one result per (sub-)input. fn MUST be
    idempotent; inputs should be spillable while waiting."""
    from .budget import spill_for_retry
    from .spillable import SpillableBatch
    max_attempts = active_conf().get(RETRY_MAX_ATTEMPTS)
    queue: List[T] = [input_item]
    owned: set = set()  # split products with_retry must close itself

    def _close_owned(item):
        if id(item) in owned and isinstance(item, SpillableBatch):
            owned.discard(id(item))
            item.close()

    def handle_retry_oom(attempts: int) -> bool:
        """Count, spill, then sleep a capped exponential backoff so that
        the writebacks the spill queued can land."""
        _state.retry_count += 1
        backoff = _oom_backoff_s(attempts)
        from ..obs import events as obs_events
        obs_events.emit("oom_retry", oom="retry", attempt=attempts,
                        max_attempts=max_attempts,
                        backoff_ns=int(backoff * 1e9),
                        task_id=_state.task_id)
        if attempts >= max_attempts:
            return False
        spill_for_retry()
        if backoff:
            from ..obs import phase as obs_phase
            t0b = time.perf_counter_ns()
            time.sleep(backoff)
            obs_phase.add("retry-backoff", time.perf_counter_ns() - t0b)
        return True

    try:
        while queue:
            item = queue.pop(0)
            attempts = 0
            try:
                while True:
                    attempts += 1
                    try:
                        oom_guard()
                        result = fn(item)
                        _close_owned(item)
                        yield result
                        break
                    except TpuRetryOOM:
                        if not handle_retry_oom(attempts):
                            raise
                    except TpuSplitAndRetryOOM:
                        _state.split_retry_count += 1
                        from ..obs import events as obs_events
                        obs_events.emit("oom_retry", oom="split",
                                        attempt=attempts,
                                        task_id=_state.task_id)
                        if split_policy is None:
                            raise
                        # the card just proved this batch size wrong:
                        # later batches of the query coalesce smaller
                        from ..exec import adaptive
                        adaptive.note_oom_split()
                        halves = split_policy(item)
                        owned.discard(id(item))
                        owned.update(id(h) for h in halves)
                        queue = halves + queue
                        break
                    except Exception as e:
                        # the card's allocator failed: the spill-and-retry
                        # lane, at the guarded section (the taxonomy's
                        # "oom"); anything else goes up to task retry or
                        # surfaces
                        from ..faults import classify
                        if classify(e) != "oom":
                            raise
                        if not handle_retry_oom(attempts):
                            raise TpuRetryOOM(str(e)) from e
            except BaseException:
                _close_owned(item)  # the in-flight item, if owned
                raise
    except BaseException:
        for item in queue:
            _close_owned(item)
        raise


def with_retry_no_split(input_item: T, fn: Callable[[T], R]) -> R:
    """withRetryNoSplit: retry on TpuRetryOOM only; split escalates."""
    for result in with_retry(input_item, fn, split_policy=None):
        return result
    raise RuntimeError("with_retry produced no result")
