"""Basic execs — the counterpart of the scan, filter, project, range,
union, limit, expand and sample execs of spark_rapids_tpu/exec/basic.py.

Filter and project run each input batch as a SpillableBatch under
`with_retry(..., split_in_half_by_rows)` (memory/retry.py), as the JAX
package's filter and project do. They also offer `fused_step`: an AggregateExec absorbs the
chain above its source into its own per-batch step (whole-stage fusion),
where the filter becomes a row mask and no intermediate column is
compacted or materialized.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import torch

from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, bucket_capacity, resolve_device
from ..expr.core import Expression, output_name, resolve
from ..expr.predicates import encoded_safe_predicate, encoded_safe_projection
from ..memory.retry import split_in_half_by_rows, with_retry
from ..memory.spillable import SpillableBatch
from ..ops.basic import compact_columns, sanitize, slice_rows
from ..types import LONG, Schema, StructField
from .base import (NUM_UPLOADS, PIPELINE_STAGE_METRICS, UPLOAD_METRICS,
                   UPLOAD_PACK_TIME, TpuExec)


class InMemoryScanExec(TpuExec):
    """Leaf feeding pre-built device batches, DictionaryColumns as they
    are (its parent's `consumes_encoded` decides whether they may cross
    its output). `device` names the plan's device when there are no
    batches to take it from."""

    def __init__(self, batches: Sequence[ColumnarBatch], schema: Schema,
                 device=None):
        super().__init__()
        self._batches = list(batches)
        self._schema = schema
        self._device = device

    @property
    def output_schema(self) -> Schema:
        return self._schema

    @property
    def device(self):
        return self._batches[0].device if self._batches else self._device

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        yield from self._batches


class SourceScanExec(TpuExec):
    """Leaf driving a source's `batches()` stream: a source that builds
    host columns and uploads each batch (`columnar/upload.to_device_batch`,
    as io/parquet.ParquetSource does). Behind a pipeline stage (`depth`,
    default exec/pipeline.pipeline_depth()) the decode and upload of batch
    N+1 run on a producer thread while the operators above compute batch
    N, the upload on the card's upload stream; each batch is made safe on
    the consumer's stream before it leaves (`await_upload`). At depth 0 it
    is a synchronous drive of the same iterator, with the same output. The
    source names the device (its `device` attribute)."""

    def __init__(self, source, schema: Schema, depth=None):
        super().__init__()
        self._source = source
        self._schema = schema
        self._depth = depth

    @property
    def output_schema(self) -> Schema:
        return self._schema

    @property
    def device(self):
        return getattr(self._source, "device", None)

    def additional_metrics(self):
        return PIPELINE_STAGE_METRICS + UPLOAD_METRICS

    @property
    def runs_own_pipeline_stage(self) -> bool:
        return True

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        from ..columnar.upload import await_upload
        stage = self.pipeline_stage(self._produce(), "scan", self._depth)
        try:
            for batch in stage:
                yield await_upload(batch)
        finally:
            stage.close()

    def _produce(self) -> Iterator[ColumnarBatch]:
        """On the producer thread when pipelined: the decode and upload of
        a batch happen inside `next(it)`, under the admission semaphore.
        The permit is held only around one batch, so a scan idling on a
        full prefetch queue holds no permit."""
        from ..columnar.upload import metric_sink, on_upload_stream
        from ..memory.semaphore import tpu_semaphore
        from .pipeline import cancelled
        sem = tpu_semaphore()
        # a source that runs a plan of its own to build its data does so
        # before this scan holds a permit: that plan's scans take their
        # own, and nesting them deadlocks a one-permit semaphore
        prepare = getattr(self._source, "ensure_materialized", None)
        if prepare is not None:
            prepare()
        it = iter(self._source.batches())
        try:
            while True:
                if not sem.acquire_if_necessary(self._op_id,
                                                cancel=cancelled):
                    return  # the consumer closed the stage meanwhile
                try:
                    with metric_sink(self.metrics[NUM_UPLOADS],
                                     self.metrics[UPLOAD_PACK_TIME]), \
                            on_upload_stream(self.device):
                        batch = next(it)
                except StopIteration:
                    return
                finally:
                    sem.release_if_necessary(self._op_id)
                yield batch
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()


def bind_projection(exprs: Sequence[Expression], schema: Schema
                    ) -> List[Expression]:
    return [resolve(e, schema) for e in exprs]


def projection_schema(exprs: Sequence[Expression], schema: Schema) -> Schema:
    bound = bind_projection(exprs, schema)
    fields = [StructField(output_name(exprs[i], f"col{i}"), e.data_type,
                          e.nullable)
              for i, e in enumerate(bound)]
    return Schema(tuple(fields))


def eval_projection(bound: Sequence[Expression], batch: ColumnarBatch,
                    schema: Schema) -> ColumnarBatch:
    cols = [sanitize(e.columnar_eval(batch), batch.num_rows) for e in bound]
    return batch.with_columns(cols, schema)


def run_spillable(batch: ColumnarBatch, step) -> Iterator:
    """`step` over one input batch held as a SpillableBatch, retried and
    split in halves by rows under OOM; one result per (sub-)input. The
    aggregate and the sort drive their steps through it too."""
    spillable = SpillableBatch.from_batch(batch)

    def run(s: SpillableBatch) -> ColumnarBatch:
        b = s.get_batch()
        try:
            return step(b)
        finally:
            s.release()
    try:
        yield from with_retry(spillable, run,
                              split_policy=split_in_half_by_rows)
    finally:
        spillable.close()


class ProjectExec(TpuExec):
    def __init__(self, exprs: Sequence[Expression], child: TpuExec):
        super().__init__(child)
        self.exprs = list(exprs)
        self._schema = projection_schema(self.exprs, child.output_schema)
        self._bound = bind_projection(self.exprs, child.output_schema)

    @property
    def output_schema(self) -> Schema:
        return self._schema

    @property
    def consumes_encoded(self) -> bool:
        # every projection passes an encoded column through untouched or
        # touches strings only in code-space positions
        return all(encoded_safe_projection(e) for e in self._bound)

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute():
            yield from run_spillable(batch, lambda b: eval_projection(
                self._bound, b, self._schema))

    def fused_step(self):
        """Whole-stage fusion hook: this operator as a pure step a consumer
        inlines into its own per-batch step."""
        return ("project", self._bound, self._schema)


class FilterExec(TpuExec):
    def __init__(self, condition: Expression, child: TpuExec):
        super().__init__(child)
        self.condition = condition
        self._bound = resolve(condition, child.output_schema)

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    @property
    def consumes_encoded(self) -> bool:
        # equality / IN / null predicates evaluate in code space, and the
        # compaction gathers a dictionary column's codes
        return encoded_safe_predicate(self._bound)

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute():
            yield from run_spillable(batch, self._filter)

    def _filter(self, batch: ColumnarBatch) -> ColumnarBatch:
        pred = self._bound.columnar_eval(batch)
        # Spark: null predicate rows are dropped
        keep = pred.data & pred.validity
        cols, n = compact_columns(batch.columns, keep, batch.num_rows)
        return ColumnarBatch(cols, n, batch.schema)

    def fused_step(self):
        """Fusion hook: in a fused stage the filter contributes a row MASK
        (ANDed into the consumer's reductions) instead of a compaction."""
        return ("filter", self._bound)


class RangeExec(TpuExec):
    """Ids start, start + step, ... below end, generated on the device in
    batches of `batch_rows` (reference GpuRangeExec)."""

    def __init__(self, start: int, end: int, step: int = 1,
                 batch_rows: int = 1 << 20, name: str = "id", device=None):
        super().__init__()
        if step == 0:
            raise ValueError("a range's step must not be 0")
        self.start, self.end, self.step = start, end, step
        self.batch_rows = batch_rows
        self._schema = Schema((StructField(name, LONG, False),))
        self._device = resolve_device(device)

    @property
    def output_schema(self) -> Schema:
        return self._schema

    @property
    def device(self):
        return self._device

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        total = max(0, -(-(self.end - self.start) // self.step))
        emitted = 0
        while emitted < total:
            n = min(self.batch_rows, total - emitted)
            cap = bucket_capacity(n)
            base = self.start + emitted * self.step
            i = torch.arange(cap, dtype=torch.int64, device=self._device)
            act = i < n
            data = torch.where(act, base + i * self.step, 0)
            yield ColumnarBatch([Column(data, act, LONG)], n, self._schema)
            emitted += n


class UnionExec(TpuExec):
    """The children's batches one after another, under the first child's
    schema (reference GpuUnionExec). Batches pass through untouched, so
    encoded columns may too."""

    consumes_encoded = True

    def __init__(self, *children: TpuExec):
        super().__init__(*children)

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        for c in self.children:
            for batch in c.execute():
                yield ColumnarBatch(batch.columns, batch.num_rows,
                                    self.output_schema, batch._host_rows)


class LocalLimitExec(TpuExec):
    """The first `limit` rows (reference GpuLocalLimitExec): whole batches
    while they fit, the batch that crosses the limit sliced, one host read
    of each batch's row count."""

    #: slicing gathers a dictionary column's codes
    consumes_encoded = True

    def __init__(self, limit: int, child: TpuExec):
        super().__init__(child)
        self.limit = limit

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        remaining = self.limit
        for batch in self.child.execute():
            if remaining <= 0:
                break
            n = batch.num_rows_host
            if n <= remaining:
                remaining -= n
                yield batch
            else:
                cols = [slice_rows(c, 0, remaining, batch.capacity)
                        for c in batch.columns]
                yield ColumnarBatch(cols, remaining, batch.schema)
                remaining = 0


class GlobalLimitExec(LocalLimitExec):
    """The single-partition limit, with an optional offset: `offset` rows
    skipped, then at most `limit` kept."""

    def __init__(self, limit: int, child: TpuExec, offset: int = 0):
        super().__init__(limit, child)
        self.offset = offset

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        if self.offset == 0:
            yield from super().internal_execute()
            return
        to_skip, remaining = self.offset, self.limit
        for batch in self.child.execute():
            n = batch.num_rows_host
            if to_skip >= n:
                to_skip -= n
                continue
            start, to_skip = to_skip, 0
            take = min(n - start, remaining)
            if take <= 0:
                break
            cols = [slice_rows(c, start, take, batch.capacity)
                    for c in batch.columns]
            yield ColumnarBatch(cols, take, batch.schema)
            remaining -= take
            if remaining <= 0:
                break


class ExpandExec(TpuExec):
    """N projections of every input batch (reference GpuExpandExec, the
    operator of GROUPING SETS and rollups): one output batch per
    projection, in projection order, rather than the rows interleaved —
    the same multiset of rows. The schema is the first projection's."""

    def __init__(self, projections: Sequence[Sequence[Expression]],
                 child: TpuExec):
        super().__init__(child)
        self.projections = [list(p) for p in projections]
        self._schema = projection_schema(self.projections[0],
                                         child.output_schema)
        self._bound = [bind_projection(p, child.output_schema)
                       for p in self.projections]

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute():
            for bound in self._bound:
                yield eval_projection(bound, batch, self._schema)


class SampleExec(TpuExec):
    """Bernoulli row sampling (reference GpuSampleExec): each row survives
    with probability `fraction`, decided by JAX's threefry counter RNG
    (ops/threefry.py) as in the JAX package: batch i draws
    uniform(fold_in(key(seed), i), (capacity,), float32), so a seed keeps
    the same rows in both packages, every batch's draw independent."""

    #: compaction gathers a dictionary column's codes
    consumes_encoded = True

    def __init__(self, fraction: float, seed: int, child: TpuExec):
        super().__init__(child)
        self.fraction = float(fraction)
        self.seed = int(seed)

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    def keep_mask(self, batch: ColumnarBatch, batch_index: int
                  ) -> torch.Tensor:
        """The rows batch `batch_index` keeps (active rows only)."""
        from ..ops import threefry
        from ..ops.basic import active_mask
        k = threefry.fold_in(threefry.key(self.seed), batch_index)
        u = threefry.uniform(k, batch.capacity, batch.device)
        frac = torch.tensor(self.fraction, dtype=torch.float32,
                            device=batch.device)
        return (u < frac) & active_mask(batch.num_rows, batch.capacity)

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        for i, batch in enumerate(self.child.execute()):
            cols, n = compact_columns(batch.columns, self.keep_mask(batch, i),
                                      batch.num_rows)
            yield ColumnarBatch(cols, n, batch.schema)

    def node_description(self):
        return f"SampleExec[fraction={self.fraction}, seed={self.seed}]"
