"""TpuExec — base of the columnar operator tree, the counterpart of
spark_rapids_tpu/exec/base.py (lean: the metrics the ported execs record,
and no event log, lifecycle or dispatch plane yet).

Operators form a tree; `execute()` returns an iterator of ColumnarBatch.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Sequence

import torch

from ..columnar.batch import ColumnarBatch
from ..types import Schema

NUM_OUTPUT_ROWS = "numOutputRows"
AGG_TIME = "computeAggTime"


class TpuMetric:
    """Accumulating operator metric. Device-produced values (a row count
    on the card) accumulate lazily and are read only when the metric is,
    so the batch loop never waits for the device."""

    __slots__ = ("name", "_value", "_pending")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._pending: List[torch.Tensor] = []

    def add(self, v: int) -> None:
        self._value += v

    def add_device(self, scalar: torch.Tensor) -> None:
        self._pending.append(scalar)

    @property
    def value(self) -> int:
        if self._pending:
            pending, self._pending = self._pending, []
            self._value += int(torch.stack(
                [s.to(torch.int64).reshape(()) for s in pending]).sum())
        return self._value

    def ns_timer(self):
        return _NsTimer(self)


class _NsTimer:
    def __init__(self, metric: TpuMetric):
        self.metric = metric

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.metric.add(time.perf_counter_ns() - self._t0)


class TpuExec:
    """Base columnar operator."""

    def __init__(self, *children: "TpuExec"):
        self.children: List[TpuExec] = list(children)
        self.metrics: Dict[str, TpuMetric] = {
            NUM_OUTPUT_ROWS: TpuMetric(NUM_OUTPUT_ROWS)}
        for name in self.additional_metrics():
            self.metrics[name] = TpuMetric(name)

    @property
    def output_schema(self) -> Schema:
        raise NotImplementedError(type(self).__name__)

    def additional_metrics(self) -> Sequence[str]:
        return ()

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        raise NotImplementedError(type(self).__name__)

    def execute(self) -> Iterator[ColumnarBatch]:
        """Counts output rows around the operator's own iterator. When an
        exception or an abandoned consumer unwinds through this frame, the
        internal iterator is closed here, so its own finally blocks run
        now rather than whenever the garbage collector gets to them."""
        rows = self.metrics[NUM_OUTPUT_ROWS]
        it = self.internal_execute()
        try:
            for batch in it:
                if batch._host_rows is not None:
                    rows.add(batch._host_rows)
                else:
                    rows.add_device(batch.num_rows)
                yield batch
        finally:
            it.close()

    @property
    def child(self) -> "TpuExec":
        if len(self.children) != 1:
            raise ValueError(f"{type(self).__name__} has "
                             f"{len(self.children)} children")
        return self.children[0]

    def collect(self) -> List[tuple]:
        """Materialize results under a speculation scope. The exact tier
        is not ported, so a tripped overflow flag raises instead of
        re-running the plan exactly."""
        from .speculation import speculation_scope
        with speculation_scope() as scope:
            out: List[tuple] = []
            for batch in self.execute():
                out.extend(batch.to_pylist())
            if scope.tripped():
                raise RuntimeError(
                    "speculative aggregation overflowed its bucket table "
                    "and the exact tier is not ported yet")
        return out
