"""Task-level metrics roll-up — the counterpart of
spark_rapids_tpu/exec/task_metrics.py (the reference's GpuTaskMetrics:
semWaitTimeNs, retryCount, splitAndRetryCount and the spill sizes
accumulated per task).

A "task" is one driven query: `query_snapshot()` captures the
process-global accumulators (the admission semaphore's wait, the
OOM-retry counters, the spill volumes) before execution, and
`query_summary()` diffs them after and rolls the executed TpuExec tree's
metrics into one flat dict:

- task-scoped globals (diffed):  semWaitTimeNs, retryCount,
  splitAndRetryCount, spilledDeviceBytes, spilledHostBytes
- per-metric sums over the operator tree:  total.<metricName>
- per-operator breakdown:  ops.<Path>.<metricName>  (TpuExec.all_metrics
  addressing)

The session keeps it as `TpuSession.last_query_profile().summary`.
"""

from __future__ import annotations

from typing import Dict, Optional

from .base import TpuExec


def query_snapshot() -> Dict[str, int]:
    """Process-global accumulators before a query, for delta-ing."""
    from ..memory.catalog import buffer_catalog
    from ..memory.retry import task_retry_counts
    from ..memory.semaphore import tpu_semaphore
    retry, split_retry = task_retry_counts()
    cat = buffer_catalog()
    return {
        "semWaitTimeNs": tpu_semaphore().total_wait_ns,
        "retryCount": retry,
        "splitAndRetryCount": split_retry,
        "spilledDeviceBytes": cat.spilled_device_bytes,
        "spilledHostBytes": cat.spilled_host_bytes,
    }


def query_summary(root: TpuExec,
                  before: Optional[Dict[str, int]] = None
                  ) -> Dict[str, int]:
    """Roll one executed plan's metrics into a per-query summary; with
    `before` (a query_snapshot() taken before execution) the globals are
    this query's deltas, else the running totals."""
    after = query_snapshot()
    out: Dict[str, int] = {}
    for k, v in after.items():
        out[k] = v - (before or {}).get(k, 0)
    per_op = root.all_metrics()
    totals: Dict[str, int] = {}
    for path, value in per_op.items():
        name = path.rsplit(".", 1)[1]
        totals[name] = totals.get(name, 0) + value
    for name in sorted(totals):
        out[f"total.{name}"] = totals[name]
    for path in sorted(per_op):
        out[f"ops.{path}"] = per_op[path]
    return out
