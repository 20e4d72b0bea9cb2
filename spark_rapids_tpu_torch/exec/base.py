"""TpuExec — base of the columnar operator tree, the counterpart of
spark_rapids_tpu/exec/base.py (lean: the metrics the ported execs record,
and no event log, lifecycle or dispatch plane yet).

Operators form a tree; `execute()` returns an iterator of ColumnarBatch.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, Iterator, List, Sequence

import torch

from ..columnar.batch import ColumnarBatch
from ..columnar.encoded import materialize_batch
from ..types import Schema

NUM_OUTPUT_ROWS = "numOutputRows"
AGG_TIME = "computeAggTime"
PIPELINE_WAIT = "pipelineWaitNs"
PIPELINE_FULL_WAIT = "pipelineFullWaitNs"
PIPELINE_WALL = "pipelineWallNs"
NUM_UPLOADS = "numUploads"
UPLOAD_PACK_TIME = "uploadPackTimeNs"

#: the metrics of an exec that runs a pipelined() input stage (bind them
#: with TpuExec.pipeline_stage)
PIPELINE_STAGE_METRICS = (PIPELINE_WAIT, PIPELINE_FULL_WAIT, PIPELINE_WALL)
#: the metrics of an exec that uploads batches (columnar/upload.metric_sink)
UPLOAD_METRICS = (NUM_UPLOADS, UPLOAD_PACK_TIME)

#: per-operator ids (the admission semaphore's task ids, stage labels)
_OP_IDS = itertools.count(1)


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

    #: True when this exec's kernels accept DictionaryColumn inputs from
    #: its children (code-space predicates, pass-through projections).
    #: Execs override it, usually with the eligibility walk over their
    #: bound expressions (expr/predicates.encoded_safe_predicate); the
    #: default False keeps an operator from misreading the encoded layout.
    consumes_encoded: bool = False

    #: stamped by the parent's execute() before this exec's first batch is
    #: pulled: whether encoded columns may cross this exec's output
    #: boundary. Where they may not, they decode there (late
    #: materialization, columnar/encoded.materialize_batch). The root of
    #: a plan is never stamped, so execute() at the root decodes; collect()
    #: lets its encoded batches out, since to_pylist decodes on the host.
    _encoded_ok_for_parent: bool = False

    def __init__(self, *children: "TpuExec"):
        self.children: List[TpuExec] = list(children)
        self._op_id = next(_OP_IDS)
        self.metrics: Dict[str, TpuMetric] = {
            NUM_OUTPUT_ROWS: TpuMetric(NUM_OUTPUT_ROWS)}
        for name in self.additional_metrics():
            self.metrics[name] = TpuMetric(name)

    @property
    def output_schema(self) -> Schema:
        raise NotImplementedError(type(self).__name__)

    def additional_metrics(self) -> Sequence[str]:
        return ()

    @property
    def output_grouped_by(self):
        """Grouping contract of this exec's output batches, or None.

        A tuple of frozensets of output column names: within every
        emitted batch, rows carrying equal values for (one representative
        of each class) are contiguous, and the columns inside one class
        are pairwise equal per row (the two sides of an equi-join key). A
        group-by whose keys pick a representative from every class, and
        nothing else, may skip its sort (ops/aggregate.groupby_aggregate
        `pre_grouped`)."""
        return None

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        raise NotImplementedError(type(self).__name__)

    @property
    def runs_own_pipeline_stage(self) -> bool:
        """True when this exec's execute() drives a pipelined() producer
        stage of its own: a consumer that would wrap its input in another
        stage skips it then."""
        return False

    def pipeline_stage(self, source, label: str, depth=None):
        """The one way an exec wraps an input in a pipelined() stage:
        binds the PIPELINE_STAGE_METRICS (which its additional_metrics()
        registers) and tags the label with the op id. Callers drive the
        stage inside try/finally with stage.close()."""
        from .pipeline import pipelined
        return pipelined(source, depth=depth,
                         label=f"{label}-{self._op_id}",
                         wait_metric=self.metrics[PIPELINE_WAIT],
                         full_metric=self.metrics[PIPELINE_FULL_WAIT],
                         wall_metric=self.metrics[PIPELINE_WALL])

    def encoded_inputs(self) -> Sequence["TpuExec"]:
        """The execs whose batches this exec's kernels read, and so the
        ones its `consumes_encoded` speaks for: its children, or the
        source of a chain it absorbs."""
        return self.children

    def stamp_inputs(self) -> None:
        """Tell each exec in `encoded_inputs` whether encoded columns may
        cross its output boundary; execute() does it before the first
        batch is pulled."""
        for c in self.encoded_inputs():
            c._encoded_ok_for_parent = self.consumes_encoded

    def execute(self) -> Iterator[ColumnarBatch]:
        """Counts output rows around the operator's own iterator, and
        decodes encoded columns at the boundary when the parent cannot
        take them. When an exception or an abandoned consumer unwinds
        through this frame, the internal iterator is closed here, so its
        own finally blocks run now rather than whenever the garbage
        collector gets to them."""
        return self._execute(self._encoded_ok_for_parent)

    def _execute(self, encoded_out: bool) -> Iterator[ColumnarBatch]:
        self.stamp_inputs()
        rows = self.metrics[NUM_OUTPUT_ROWS]
        it = self.internal_execute()
        try:
            for batch in it:
                if not encoded_out:
                    batch = materialize_batch(batch)
                if batch._host_rows is not None:
                    rows.add(batch._host_rows)
                else:
                    rows.add_device(batch.num_rows)
                yield batch
        finally:
            it.close()

    @property
    def device(self):
        """The device the plan's leaves name (None: the port's default)."""
        for c in self.children:
            if c.device is not None:
                return c.device
        return None

    @property
    def child(self) -> "TpuExec":
        if len(self.children) != 1:
            raise ValueError(f"{type(self).__name__} has "
                             f"{len(self.children)} children")
        return self.children[0]

    def collect(self) -> List[tuple]:
        """Materialize results. Opens a speculation scope: aggregates may
        run their masked-bucket tier and joins their cached candidate
        sizes, flagging overflow on the device; the flags cost one host
        read here, and a trip re-runs the plan with every operator on its
        exact tier."""
        from .speculation import force_exact, speculation_scope

        def run() -> List[tuple]:
            out: List[tuple] = []
            # to_pylist decodes dictionary columns on the host: the output
            # seam takes encoded root batches
            for batch in self._execute(encoded_out=True):
                out.extend(batch.to_pylist())
            return out

        with speculation_scope() as scope:
            out = run()
            if scope.tripped():
                with force_exact():
                    out = run()
        return out
