"""Per-query profile — the counterpart of spark_rapids_tpu/obs/profile.py:
the executed TpuExec tree annotated with its metrics (the reference's
Spark-SQL-UI plan graph with GpuMetrics merged in).

`QueryProfile` is built by `DataFrame.collect()` from the executed plan
root, the task-metrics summary (exec/task_metrics.py), the query's
RuntimeStats and its phase ledger, and surfaced as
`TpuSession.last_query_profile()`. Metric visibility honours
spark.rapids.sql.metrics.level as `TpuExec.all_metrics()` does.

Reading a metric value reads its pending device scalars (one stacked
copy per metric): profiles are built at query end, never in the batch
loop.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


def metrics_level(conf=None) -> int:
    """spark.rapids.sql.metrics.level as an int level."""
    from ..exec.base import metrics_level_from_conf
    return metrics_level_from_conf(conf)


def _fmt_ns(ns: int) -> str:
    if ns < 1_000:
        return f"{ns}ns"
    if ns < 1_000_000:
        return f"{ns / 1_000:.1f}us"
    if ns < 1_000_000_000:
        return f"{ns / 1_000_000:.1f}ms"
    return f"{ns / 1_000_000_000:.2f}s"


def _fmt_bytes(b: int) -> str:
    if b < (1 << 10):
        return f"{b}B"
    if b < (1 << 20):
        return f"{b / (1 << 10):.1f}KB"
    if b < (1 << 30):
        return f"{b / (1 << 20):.1f}MB"
    return f"{b / (1 << 30):.2f}GB"


def _fmt_metric(name: str, value: int) -> str:
    if name.endswith(("Time", "Ns")):
        return _fmt_ns(value)
    if name.endswith(("Bytes", "Size")) or name == "dataSize":
        return _fmt_bytes(value)
    return str(value)


def _node(op, level: int) -> Dict[str, Any]:
    node = {
        "op": type(op).__name__,
        "op_id": getattr(op, "_op_id", None),
        "desc": op.node_description(),
        "metrics": {name: m.value for name, m in op.metrics.items()
                    if m.level <= level},
        "children": [_node(c, level) for c in op.children],
    }
    sites = getattr(op, "stage_sites", None)
    if sites is not None:
        # a compiled stage's programs: the sites it has called
        node["programs"] = sum(1 for s in sites() if s.calls)
    return node


class QueryProfile:
    """Executed-plan profile: `.tree` (nested dict), `.summary` (the
    task-metrics roll-up), `.text()` and `.to_json()` renderers,
    `.top_operators()`, `.statistics()` and `.phases()`."""

    def __init__(self, root, summary: Optional[Dict[str, int]] = None,
                 level: Optional[int] = None, statistics=None,
                 phases=None):
        level = metrics_level() if level is None else level
        self.tree = _node(root, level)
        self.summary = dict(summary or {})
        #: the executed plan's shape digest (obs/history.plan_fingerprint),
        #: taken only when a history store is on
        from . import history
        self.fingerprint = history.plan_fingerprint(root) \
            if history.active_store() is not None else None
        #: the query's RuntimeStats (obs/stats.py)
        self._runtime_stats = statistics
        #: the governed query's PhaseLedger (obs/phase.py), or None
        self._phase_ledger = phases

    def phases(self) -> Optional[Dict[str, int]]:
        """The query's closed phase dict (sum == wall_ns exactly), or
        None when no ledger was attached."""
        if self._phase_ledger is None:
            return None
        return self._phase_ledger.snapshot()

    def phases_wall_ns(self) -> Optional[int]:
        """The wall-clock the phase dict partitions (ns), or None."""
        if self._phase_ledger is None:
            return None
        return self._phase_ledger.wall_ns

    def to_dict(self) -> Dict[str, Any]:
        out = {"summary": self.summary, "plan": self.tree}
        ph = self.phases()
        if ph is not None:
            out["phases"] = ph
            out["phases_wall_ns"] = self.phases_wall_ns()
        return out

    def statistics(self) -> Dict[str, Any]:
        """Runtime statistics: per-exchange distributions and skew (only
        for queries that shuffled), and per-operator cardinality and
        selectivity from the metric tree (rows out over rows in)."""
        out: Dict[str, Any] = {"exchanges": {}, "operators": []}
        if self._runtime_stats is not None:
            out["exchanges"] = \
                self._runtime_stats.to_dict()["exchanges"]

        def walk(node):
            rows_out = node["metrics"].get("numOutputRows", 0)
            rows_in = sum(c["metrics"].get("numOutputRows", 0)
                          for c in node["children"]) \
                if node["children"] else None
            out["operators"].append({
                "op": node["op"], "op_id": node["op_id"],
                "rows_out": rows_out, "rows_in": rows_in,
                "selectivity": (round(rows_out / rows_in, 6)
                                if rows_in else None)})
            for c in node["children"]:
                walk(c)

        walk(self.tree)
        return out

    def dispatch_summary(self) -> Dict[str, Any]:
        """Per compiled stage: the program-site calls it made (on the card
        a graph replay or an eager step each), its output batches, the
        calls per output batch and its programs (the sites it called). A
        fused chain is one row. `counters` are the dispatch ledger's
        process totals and the stage compiler's."""
        from ..exec import stage_compiler
        from . import dispatch as obs_dispatch
        stages: List[Dict[str, Any]] = []

        def walk(node):
            m = node["metrics"]
            d = m.get("numDispatches")
            if d is not None:
                batches = m.get("numOutputBatches", 0)
                stages.append({
                    "op": node["op"], "op_id": node["op_id"],
                    "desc": node["desc"], "dispatches": d,
                    "batches": batches,
                    "dispatches_per_batch": (round(d / batches, 4)
                                             if batches else None),
                    "programs": node.get("programs", 0)})
            for c in node["children"]:
                walk(c)

        walk(self.tree)
        return {"stages": stages, "counters": obs_dispatch.counters(),
                "stage": stage_compiler.counters()}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=str)

    def text(self) -> str:
        """Explain with the metrics inlined per node."""
        lines: List[str] = ["== TPU Query Profile =="]
        task_keys = [k for k in ("semWaitTimeNs", "retryCount",
                                 "splitAndRetryCount", "spilledDeviceBytes",
                                 "spilledHostBytes") if k in self.summary]
        if task_keys:
            parts = []
            for k in task_keys:
                v = self.summary[k]
                parts.append(f"{k}={_fmt_ns(v)}" if k.endswith("Ns")
                             else f"{k}={_fmt_bytes(v)}" if
                             k.endswith("Bytes") else f"{k}={v}")
            lines.append("task: " + " ".join(parts))

        def walk(node: Dict[str, Any], indent: int):
            lines.append("  " * indent + node["desc"])
            if node["metrics"]:
                body = ", ".join(
                    f"{n}: {_fmt_metric(n, v)}"
                    for n, v in sorted(node["metrics"].items()))
                lines.append("  " * indent + f"  + {body}")
            for c in node["children"]:
                walk(c, indent + 1)

        walk(self.tree, 0)
        return "\n".join(lines)

    def top_operators(self, n: int = 5,
                      by: str = "time") -> List[Dict[str, Any]]:
        """Top-N operator rows. by="time" ranks by the sum of the node's
        *Time metrics; any other metric name ranks by that metric.
        Pipelined stages carry `overlap`, 1 - pipelineWaitNs /
        pipelineWallNs: the share of the stage's life not stalled on its
        input."""
        rows: List[Dict[str, Any]] = []

        def walk(node):
            m = node["metrics"]
            time_ns = sum(v for k, v in m.items() if k.endswith("Time"))
            row = {"op": node["op"], "op_id": node["op_id"],
                   "time_ns": time_ns,
                   "rows": m.get("numOutputRows", 0),
                   "batches": m.get("numOutputBatches", 0),
                   "rank_key": time_ns if by == "time"
                   else m.get(by, 0)}
            if "pipelineWaitNs" in m:
                wait = m["pipelineWaitNs"]
                wall = m.get("pipelineWallNs", 0)
                row["pipeline_wait_ns"] = wait
                if wall > 0:
                    row["overlap"] = round(1.0 - min(wait, wall) / wall, 4)
            rows.append(row)
            for c in node["children"]:
                walk(c)

        walk(self.tree)
        rows.sort(key=lambda r: (-r["rank_key"], r["op"],
                                 r["op_id"] if r["op_id"] is not None
                                 else -1))
        for r in rows:
            r.pop("rank_key", None)
        return rows[:n]
