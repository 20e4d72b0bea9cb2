"""TpuSemaphore — device admission control, the counterpart of
spark_rapids_tpu/memory/semaphore.py (reference GpuSemaphore.scala:51).

At most spark.rapids.sql.concurrentGpuTasks tasks hold the device at once; the others
block in `acquire_if_necessary`, their operator state held as spillable
batches. The wait accumulates in `total_wait_ns` (the reference's
semWaitTime).

Re-entrant across threads, per task: a pipeline producer thread that
uploads for the same task as its consumer shares the task's one permit.
When two threads race a task's first acquire, the loser waits for the
winner instead of taking a second permit. A blocked acquire polls an
optional `cancel` predicate, so an abandoned pipelined scan can always
tear down.

Waiters are served by the workload governor's fairness rule
(exec/workload.pick_fair): priority class first — the class of the
waiting thread's governed query, interactive when ungoverned — then
first in, first out, with every AGING_EVERY-th grant going to the oldest
waiter whatever its class. A governed query's cancellation or deadline
is checked inside the wait (phase `sem-wait`); the wait accrues to the
`semaphore-wait` phase and is emitted as `semaphore_acquire`.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, Optional

from ..config import CONCURRENT_TPU_TASKS, active_conf

_POLL_S = 0.05


class SemaphoreTimeout(TimeoutError):
    """A task waited longer than the semaphore's `timeout_s` for its
    first permit."""


class _Waiter:
    __slots__ = ("priority", "seq", "granted")

    def __init__(self, priority: int, seq: int):
        self.priority = priority
        self.seq = seq
        self.granted = False


class _FairPermits:
    """Permit pool that grants by the fairness rule. A waiter registers
    once per blocked acquire (its place in line survives poll timeouts)
    and polls `try_acquire`; a permit goes to the waiter the rule picks,
    never to whichever thread the scheduler wakes first."""

    def __init__(self, permits: int):
        self._cond = threading.Condition()
        self._avail = permits
        self._waiters: list = []
        self._seq = itertools.count(1)
        self._grants = 0

    def register(self, priority: int = 0) -> _Waiter:
        with self._cond:
            w = _Waiter(priority, next(self._seq))
            self._waiters.append(w)
            return w

    def _next_waiter(self) -> Optional[_Waiter]:
        from ..exec.workload import pick_fair
        return pick_fair(self._waiters, self._grants,
                         rank=lambda w: w.priority, seq=lambda w: w.seq)

    def try_acquire(self, w: _Waiter, timeout: float) -> bool:
        """True when `w` was granted a permit; False on timeout (`w`
        keeps its place in line)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                if self._avail > 0 and self._next_waiter() is w:
                    self._avail -= 1
                    self._grants += 1
                    self._waiters.remove(w)
                    w.granted = True
                    self._cond.notify_all()
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)

    def deregister(self, w: _Waiter) -> None:
        """A waiter that gives up leaves the line."""
        with self._cond:
            if not w.granted and w in self._waiters:
                self._waiters.remove(w)
                self._cond.notify_all()

    def release(self) -> None:
        with self._cond:
            self._avail += 1
            self._cond.notify_all()

    @property
    def available(self) -> int:
        return self._avail


class _TaskHold:
    __slots__ = ("count", "ready", "abandoned")

    def __init__(self):
        self.count = 0                  # re-entrant depth (one permit)
        self.ready = threading.Event()  # set once the permit is held
        self.abandoned = False          # released mid-first-acquire


class TpuSemaphore:
    """`permits` defaults to spark.rapids.sql.concurrentGpuTasks of the
    active conf, read here. `timeout_s` bounds a
    task's first acquire (None: wait as long as it takes, the reference's
    behaviour); past it the acquire raises SemaphoreTimeout."""

    def __init__(self, permits: Optional[int] = None,
                 timeout_s: Optional[float] = None):
        self.permits = permits or active_conf().get(CONCURRENT_TPU_TASKS)
        self.timeout_s = timeout_s
        self._pool = _FairPermits(self.permits)
        self._holders: Dict[int, _TaskHold] = {}
        self._lock = threading.Lock()
        self.total_wait_ns = 0

    def _check_deadline(self, t0: int, task_id: int) -> None:
        if self.timeout_s is not None and \
                time.monotonic_ns() - t0 > self.timeout_s * 1e9:
            raise SemaphoreTimeout(
                f"task {task_id} waited over {self.timeout_s} s for a "
                f"device permit ({self.permits} permits)")

    def acquire_if_necessary(self, task_id: int,
                             cancel: Optional[Callable[[], bool]] = None
                             ) -> bool:
        """Idempotent per task (reference acquireIfNecessary): the task's
        first call blocks for a permit; later calls, from any thread, are
        free. Returns False, with no permit held, when `cancel()` went
        true while waiting or the task's hold was released (task end)
        while this first acquire was still blocked."""
        t0 = time.monotonic_ns()
        raced = False
        while True:
            with self._lock:
                hold = self._holders.get(task_id)
                reentered = hold is not None and hold.count > 0
                if reentered:
                    hold.count += 1
                    # a thread that lost the race for the first acquire
                    # waited for real
                    waited = time.monotonic_ns() - t0 if raced else 0
                    self.total_wait_ns += waited
                elif hold is None:
                    hold = _TaskHold()
                    self._holders[task_id] = hold
                    break  # this thread owns the first acquire
            if reentered:
                if raced:
                    _note_wait(task_id, waited)
                return True
            # another thread is mid-first-acquire for this task: wait for
            # it (or its cancellation) and check again
            raced = True
            hold.ready.wait(_POLL_S)
            if (cancel is not None and cancel()) or hold.abandoned:
                return False
            # nothing is registered for this thread yet: raising is clean
            from ..exec import lifecycle
            lifecycle.check_current("sem-wait")
            self._check_deadline(t0, task_id)
        from ..exec.workload import current_priority_rank
        w = self._pool.register(current_priority_rank())
        try:
            while not self._pool.try_acquire(w, timeout=_POLL_S):
                if hold.abandoned:
                    hold.ready.set()
                    return False
                timed_out = self.timeout_s is not None and \
                    time.monotonic_ns() - t0 > self.timeout_s * 1e9
                from ..exec import lifecycle
                if lifecycle.current_cancelled():
                    # the governed query was cancelled while this thread
                    # waited for a permit: drop the pending hold, then
                    # raise with sem-wait attribution
                    with self._lock:
                        if self._holders.get(task_id) is hold:
                            del self._holders[task_id]
                    hold.ready.set()
                    lifecycle.check_current("sem-wait")
                if (cancel is not None and cancel()) or timed_out:
                    with self._lock:
                        if self._holders.get(task_id) is hold:
                            del self._holders[task_id]
                    hold.ready.set()  # racers retry a fresh acquire
                    self._check_deadline(t0, task_id)
                    return False
        finally:
            if not w.granted:
                self._pool.deregister(w)
        waited = time.monotonic_ns() - t0
        with self._lock:
            abandoned = hold.abandoned
            if abandoned:
                if self._holders.get(task_id) is hold:
                    del self._holders[task_id]
            else:
                self.total_wait_ns += waited
                hold.count = 1
        hold.ready.set()
        if abandoned:
            # the task ended while this acquire was blocked: keeping the
            # permit would leak it (the task never releases again)
            self._pool.release()
            return False
        _note_wait(task_id, waited)
        return True

    def release_if_necessary(self, task_id: int) -> None:
        """Release the task's permit entirely (task end: the whole hold,
        not one nesting level)."""
        with self._lock:
            hold = self._holders.pop(task_id, None)
            if hold is None:
                return
            hold.abandoned = True
            held = hold.count > 0
        hold.ready.set()
        if held:
            self._pool.release()

    def held_by(self, task_id: int) -> bool:
        with self._lock:
            hold = self._holders.get(task_id)
            return hold is not None and hold.count > 0

    def holders(self) -> int:
        """Tasks holding a permit now."""
        with self._lock:
            return sum(h.count > 0 for h in self._holders.values())

    @property
    def available(self) -> int:
        return self._pool.available


def _note_wait(task_id: int, waited: int) -> None:
    from ..obs import events as obs_events
    from ..obs import phase as obs_phase
    obs_phase.add("semaphore-wait", waited)
    obs_events.emit("semaphore_acquire", task_id=task_id, wait_ns=waited)


_semaphore: Optional[TpuSemaphore] = None
_sem_lock = threading.Lock()


def tpu_semaphore() -> TpuSemaphore:
    global _semaphore
    with _sem_lock:
        if _semaphore is None:
            _semaphore = TpuSemaphore()
        return _semaphore


def reset_tpu_semaphore(permits: Optional[int] = None,
                        timeout_s: Optional[float] = None) -> TpuSemaphore:
    global _semaphore
    with _sem_lock:
        _semaphore = TpuSemaphore(permits, timeout_s)
        return _semaphore
