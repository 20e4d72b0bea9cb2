"""Cost-based placement — the counterpart of spark_rapids_tpu/plan/cost.py
(the reference's CostBasedOptimizer.scala:1-60: an optional pass that
decides device or host placement per section from operator cost
estimates; off by default, spark.rapids.sql.optimizer.enabled, as in the
reference).

A device operator pays a fixed launch cost (the host's Python and the
kernel launches of a small Project or Filter) plus a small cost per row;
the host row engine pays a large cost per row and no launch. The
transitions at a host/device boundary cost per row, each way. For a few
rows the launch dominates and the host wins: the sections the
reference's CBO keeps on the CPU.

The pass runs over the tagged PlanMeta tree and may flip a
device-eligible Project or Filter (the operators with a host
implementation, exec/fallback.py) to host placement when its modelled
host cost is lower. The constants are the card's own, measured by
`python3 chip_smoke.py` (phase 3i, "cost constants"); the JAX package's
model a TPU (one XLA program launch is 150 us there).
"""

from __future__ import annotations

from typing import Optional

from . import logical as L

# model constants (microseconds), measured by chip_smoke.py's phase 3i
# (measure_cost_constants, medians of 15 runs) on an NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit; coarse on purpose, the decision only
# needs to be right where the two engines differ by 10x
DEVICE_DISPATCH_US = 680.0     # a small device Project, built and run
DEVICE_ROW_US = 0.000038       # per row of a large one (6,001,215 rows)
HOST_ROW_US = 5.4              # the Python row engine, per row
TRANSITION_ROW_US = 0.31       # per row and side (0.45 down, 0.17 up)


def estimate_rows(plan: L.LogicalPlan) -> Optional[int]:
    """A row-count estimate threaded from scan statistics (Spark's
    sizeInBytes statistics analog; None = unknown)."""
    from .overrides import estimate_plan_size
    if isinstance(plan, L.LogicalRange):
        if plan.step > 0:
            return max(0, (plan.end - plan.start + plan.step - 1)
                       // plan.step)
        return max(0, (plan.start - plan.end - plan.step - 1)
                   // -plan.step)
    if isinstance(plan, L.LogicalScan):
        est = getattr(plan.source, "estimated_num_rows", None)
        if est is not None:
            n = est() if callable(est) else est
            if n is not None:
                return int(n)
        size = estimate_plan_size(plan)
        if size is None:
            return None
        width = max(8, 8 * len(plan.schema.fields))
        return max(1, size // width)
    if isinstance(plan, L.LogicalFilter):
        base = estimate_rows(plan.children[0])
        return None if base is None else max(1, int(base * 0.5))
    if isinstance(plan, (L.LogicalProject, L.LogicalSort, L.LogicalSample,
                         L.LogicalRepartition)):
        return estimate_rows(plan.children[0])
    if isinstance(plan, L.LogicalLimit):
        base = estimate_rows(plan.children[0])
        return plan.limit if base is None else min(plan.limit, base)
    if isinstance(plan, L.LogicalUnion):
        parts = [estimate_rows(c) for c in plan.children]
        if any(p is None for p in parts):
            return None
        return sum(parts)
    return None


def device_cost_us(rows: int) -> float:
    return DEVICE_DISPATCH_US + rows * DEVICE_ROW_US


def host_cost_us(rows: int, needs_transitions: bool) -> float:
    cost = rows * HOST_ROW_US
    if needs_transitions:
        cost += 2 * rows * TRANSITION_ROW_US
    return cost


class CostBasedOptimizer:
    """The optional placement pass (reference Optimizer trait /
    CostBasedOptimizer). Sets PlanMeta.host_fallback and its cost note."""

    def __init__(self, conf):
        self.conf = conf

    def optimize(self, meta) -> None:
        from ..exec.fallback import supports_host_eval
        for c in meta.children:
            self.optimize(c)
        p = meta.plan
        if not isinstance(p, (L.LogicalProject, L.LogicalFilter)):
            return
        if meta.host_fallback or not meta.can_run_on_tpu:
            return  # decided by capability tagging
        exprs = list(p.exprs) if isinstance(p, L.LogicalProject) \
            else [p.condition]
        if not all(supports_host_eval(e) for e in exprs):
            return
        rows = estimate_rows(p)
        if rows is None:
            return
        # a host node between device nodes pays both transitions; one
        # whose child is already on the host shares its boundary
        child_on_host = meta.children and meta.children[0].host_fallback
        dev = device_cost_us(rows)
        host = host_cost_us(rows, needs_transitions=not child_on_host)
        if host < dev:
            meta.host_fallback = True
            meta.cost_note = (
                f"cost optimizer: host {host:.0f}us < device {dev:.0f}us "
                f"for ~{rows} rows (reference CostBasedOptimizer)")
