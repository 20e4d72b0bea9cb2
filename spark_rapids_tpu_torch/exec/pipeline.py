"""Bounded asynchronous stage boundary for the pull-model operator chain —
the counterpart of spark_rapids_tpu/exec/pipeline.py.

While the host decodes, packs and uploads the next batch, the card would
otherwise sit idle. `pipelined(it, depth)` moves an input iterator onto a
background producer thread that feeds a bounded FIFO queue, so the
producer works `depth` batches ahead of the consumer.

Contracts (tests/test_torch_pipeline.py):

* strict FIFO: items arrive in the source's order;
* a producer error is raised at the consumer's next `next()`, after the
  items produced before it (its traceback travels on the exception);
* `close()` (or abandoning the wrapping generator, whose `finally` calls
  it) unblocks a producer stuck on a full queue, closes the source and
  joins the thread; a producer wedged past pipeline.closeTimeoutMs is
  left behind (`stuck`), a daemon thread;
* depth <= 0 is the plain synchronous iterator.

The consumer's thread-local state is captured when the stage is built and
installed on the producer: the active conf (config.active_conf), the
speculation scope and `forced_exact`
(exec/speculation.py) and the retry runtime's task state
(memory/retry.py), so that work behind the boundary records its flags into
the consumer's scope and runs as the consumer's task.

The boundary counts the consumer's stall on an empty queue (`wait_ns`)
and the producer's on a full one (`full_ns`), into the owning exec's
pipelineWaitNs / pipelineFullWaitNs / pipelineWallNs metrics when given.
Left out with their modules (ROADMAP A.9): the `pipeline.produce` fault
point, the lifecycle governor's cancellation checks, the task-retry
attempt carried into the producer, the query id and the pipeline events.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterable, Optional

from ..config import (PIPELINE_CLOSE_TIMEOUT_MS, PIPELINE_DEPTH,
                      PIPELINE_ENABLED, active_conf, set_active_conf)

_END = object()

#: a blocked producer or consumer checks the closed flag this often
_POLL_S = 0.05

_tls = threading.local()


class StageCancelled(RuntimeError):
    """Raised by a stage consumer that runs on an outer, closed stage's
    producer thread (nested stages). Not StopIteration: a consumer that
    materializes its input must see the cut as an error, not as the end
    of its input."""


def cancelled() -> bool:
    """True on a producer thread whose consumer closed the stage. Long
    waits inside producer code (the admission semaphore) poll it."""
    ev = getattr(_tls, "cancel_event", None)
    return ev is not None and ev.is_set()


def pipeline_depth(conf=None) -> int:
    """The configured prefetch depth (of `conf`, default the active
    conf), 0 when pipelining is off."""
    conf = conf if conf is not None else active_conf()
    if not conf.get(PIPELINE_ENABLED):
        return 0
    return max(0, conf.get(PIPELINE_DEPTH))


def pipelined(source: Iterable[Any], depth: Optional[int] = None,
              label: str = "stage", wait_metric=None, full_metric=None,
              wall_metric=None):
    """`source` behind a bounded background producer; depth None takes
    pipeline_depth(), depth <= 0 the synchronous iterator. The result
    always has close(): consumers call it from a `finally`."""
    d = pipeline_depth() if depth is None else depth
    if d <= 0:
        return _SyncStage(source)
    return PipelinedIterator(source, d, label=label,
                             wait_metric=wait_metric,
                             full_metric=full_metric,
                             wall_metric=wall_metric)


class _SyncStage:
    """The synchronous stage: the source iterator with the close() and
    counters of a pipelined one (which never stall here)."""

    __slots__ = ("_it", "wait_ns", "full_ns", "wall_ns", "batches")

    def __init__(self, source: Iterable[Any]):
        self._it = iter(source)
        self.wait_ns = 0
        self.full_ns = 0
        self.wall_ns = 0
        self.batches = 0

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self._it)
        self.batches += 1
        return item

    def close(self) -> None:
        close = getattr(self._it, "close", None)
        if close is not None:
            close()


class PipelinedIterator:
    """Background producer thread and bounded FIFO queue (one stage
    boundary); one producer, one consumer."""

    def __init__(self, source: Iterable[Any], depth: int,
                 label: str = "stage", wait_metric=None, full_metric=None,
                 wall_metric=None):
        from ..memory.retry import capture_task_state
        from .speculation import capture_context
        self._source = source
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, depth))
        self._label = label
        self._closed = threading.Event()
        self._exc: Optional[BaseException] = None
        self._finished = False
        self._stats_done = False
        self._wait_metric = wait_metric
        self._full_metric = full_metric
        self._wall_metric = wall_metric
        self._conf = active_conf()
        self._close_timeout_s = max(
            0.1, self._conf.get(PIPELINE_CLOSE_TIMEOUT_MS) / 1000.0)
        #: True once close() gave up joining a wedged producer
        self.stuck = False
        self.wait_ns = 0
        self.full_ns = 0
        self.wall_ns = 0
        self.batches = 0
        self._t0 = time.perf_counter_ns()
        # the consumer's thread-local state, captured on its thread
        self._spec_ctx = capture_context()
        self._task_state = capture_task_state()
        self._thread = threading.Thread(
            target=self._run, name=f"pipeline-{label}", daemon=True)
        self._thread.start()

    # -- producer ----------------------------------------------------------
    def _run(self) -> None:
        # everything inside the try: a failure in the context install or
        # in iter(source) must still post _END, or the consumer waits
        # forever
        it = None
        try:
            from ..memory.retry import adopt_task_state
            from .speculation import adopt_context
            set_active_conf(self._conf)
            adopt_context(*self._spec_ctx)
            adopt_task_state(self._task_state)
            _tls.cancel_event = self._closed
            it = iter(self._source)
            while not self._closed.is_set():
                try:
                    item = next(it)
                except StopIteration:
                    break
                t0 = time.perf_counter_ns()
                if not self._offer(item):
                    break
                self.full_ns += time.perf_counter_ns() - t0
        except BaseException as e:  # noqa: BLE001 — raised at the consumer
            self._exc = e
        finally:
            if it is not None and self._closed.is_set():
                # abandoned: close the source so its finally blocks run
                close = getattr(it, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:  # noqa: BLE001 — teardown only: the
                        pass           # consumer has gone
            self._offer(_END)

    def _offer(self, item: Any) -> bool:
        """put() that the consumer's close() can always unblock."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer ----------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        t0 = time.perf_counter_ns()
        while True:
            try:
                item = self._q.get(timeout=_POLL_S)
                break
            except queue.Empty:
                if cancelled():
                    # this consumer is an outer stage's producer, and that
                    # stage was closed: stop pulling so its close() joins
                    self.wait_ns += time.perf_counter_ns() - t0
                    raise StageCancelled(self._label)
        self.wait_ns += time.perf_counter_ns() - t0
        if item is _END:
            self._finished = True
            self._thread.join()
            self._finish_stats()
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
            raise StopIteration
        self.batches += 1
        return item

    def close(self) -> None:
        """Shut the stage down (idempotent): unblock and join the
        producer, drain the queue, report the stalls. A producer still
        alive after pipeline.closeTimeoutMs is left behind (`stuck`)."""
        self._closed.set()
        self._drain()
        deadline = time.monotonic() + self._close_timeout_s
        while self._thread.is_alive():
            if time.monotonic() >= deadline:
                self.stuck = True
                break
            self._thread.join(timeout=_POLL_S)
            self._drain()
        self._finished = True
        self._finish_stats()

    def _drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def _finish_stats(self) -> None:
        if self._stats_done:
            return
        self._stats_done = True
        self.wall_ns = time.perf_counter_ns() - self._t0
        for metric, v in ((self._wait_metric, self.wait_ns),
                          (self._full_metric, self.full_ns),
                          (self._wall_metric, self.wall_ns)):
            if metric is not None:
                metric.add(v)
