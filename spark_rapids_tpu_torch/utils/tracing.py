"""Tracing and profiling — the counterpart of
spark_rapids_tpu/utils/tracing.py, on torch.profiler.

  * `annotate_op(name)` — a `torch.profiler.record_function` range around
    an operator's per-batch work, so a profiler timeline shows the
    engine's operator names over the kernels they launched; on CUDA the
    range is also an NVTX range that Nsight Systems shows. Outside a
    profile it costs the record_function's enter and exit.
  * `op_span(name, metric=None, ...)` (obs/span.py) — the same range plus
    TpuMetric ns accumulation plus a `span` event.
  * `profile_trace(out_dir)` — a `torch.profiler.profile` of a code
    region, written as a Chrome trace (`trace-<pid>-<n>.json`) into
    `out_dir`; with out_dir None it reads
    spark.rapids.tpu.profile.{enabled,dir} of the active conf, and a
    disabled conf makes it a no-op so call sites can wrap
    unconditionally.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
from typing import Iterator, Optional

_TRACE_SEQ = itertools.count(1)


def __getattr__(name: str):
    # lazy: obs.span imports annotate_op from here
    if name == "op_span":
        from ..obs.span import op_span
        return op_span
    raise AttributeError(name)


@contextlib.contextmanager
def annotate_op(name: str) -> Iterator[None]:
    """Named profiler range around the body."""
    import torch
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_trace(out_dir: Optional[str] = None) -> Iterator[None]:
    """Profile the body with torch.profiler (CPU activity, and CUDA when a
    card is present) and export a Chrome trace into `out_dir`."""
    from ..config import PROFILE_DIR, PROFILE_ENABLED, active_conf
    if out_dir is None:
        conf = active_conf()
        if not conf.get(PROFILE_ENABLED):
            yield
            return
        out_dir = conf.get(PROFILE_DIR) or os.path.join(
            tempfile.gettempdir(), "spark_rapids_tpu_torch_trace")
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        out_dir, f"trace-{os.getpid()}-{next(_TRACE_SEQ)}.json"))
