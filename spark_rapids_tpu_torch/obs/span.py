"""op_span — the counterpart of spark_rapids_tpu/obs/span.py (the
reference's NvtxWithMetrics: one object that is both the profiler range
and the metric scope).

One context manager that opens `utils.tracing.annotate_op` (a
torch.profiler range, an NVTX range on CUDA), times the body with
perf_counter_ns into an optional TpuMetric, and appends a `span` event
(DEBUG level) when the event log is on. The time and the event are
recorded even when the body raises.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Iterator

from ..utils.tracing import annotate_op
from . import events


@contextlib.contextmanager
def op_span(name: str, metric=None, kind: str = "span",
            **fields: Any) -> Iterator[None]:
    bus = events.active_bus()
    t0 = time.perf_counter_ns()
    ok = True
    try:
        with annotate_op(name):
            yield
    except BaseException:
        ok = False
        raise
    finally:
        dt = time.perf_counter_ns() - t0
        if metric is not None:
            metric.add(dt)
        if bus is not None:
            bus.emit(kind, op=name, wall_ns=dt, ok=ok, **fields)
