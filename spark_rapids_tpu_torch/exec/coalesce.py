"""Batch coalescing — the counterpart of spark_rapids_tpu/exec/coalesce.py
(reference GpuCoalesceBatches.scala:875 / AbstractGpuCoalesceIterator:250).

Concatenates small batches up to the target batch size
(spark.rapids.sql.batchSizeBytes, read at construction), so that the
kernels downstream run over fewer, larger batches. Pending input is held
as SpillableBatches, so the coalesce window never pins more device memory
than the catalog allows, and the concat runs under `with_retry_no_split`.
A batch counts its bytes at capacity, every leaf included
(`ColumnarBatch.nbytes`, the JAX package's `device_size_bytes`).

After an OOM split the governed query's batch target is halved
(exec/adaptive.note_oom_split): each batch reads it
(`batch_target_override`, one context-pointer read) and flushes at the
smaller of it and the conf's. Its dispatches are the dispatch ledger's
exec scope (obs/dispatch.py), as every exec's are.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

from ..columnar.batch import ColumnarBatch
from ..columnar.column import bucket_capacity
from ..config import BATCH_SIZE_BYTES, active_conf
from ..memory.retry import with_retry_no_split
from ..memory.spillable import SpillableBatch
from ..ops.basic import concat_columns
from ..types import Schema
from .base import PIPELINE_STAGE_METRICS, TpuExec

CONCAT_TIME = "concatTime"
NUM_INPUT_ROWS = "numInputRows"
NUM_INPUT_BATCHES = "numInputBatches"
NUM_OUTPUT_BATCHES = "numOutputBatches"


def concat_batches(batches: Sequence[ColumnarBatch],
                   schema: Schema) -> ColumnarBatch:
    """Concatenate batches' active rows on the device: pairwise in a tree
    (each row copied O(log k) times), each pair into the tight bucket of
    its row count when both counts are known on the host, else into the
    bucket of its capacities (no host read)."""
    level = list(batches)
    while len(level) > 1:
        nxt = []
        for a, b in zip(level[0::2], level[1::2]):
            host = None if a._host_rows is None or b._host_rows is None \
                else a._host_rows + b._host_rows
            cap = bucket_capacity(host) if host is not None \
                else bucket_capacity(a.capacity + b.capacity)
            cols = [concat_columns(x, y, a.num_rows, b.num_rows, cap)
                    for x, y in zip(a.columns, b.columns)]
            nxt.append(ColumnarBatch(cols, a.num_rows + b.num_rows, schema,
                                     host))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


class CoalesceBatchesExec(TpuExec):
    #: dictionary-encoded batches flow through untouched on the
    #: single-batch path; a real concat decodes first inside flush()
    #: (per-batch dictionaries differ, and concat_columns needs one)
    consumes_encoded = True

    def __init__(self, child: TpuExec, target_bytes: Optional[int] = None):
        super().__init__(child)
        self.target_bytes = target_bytes or \
            active_conf().get(BATCH_SIZE_BYTES)

    def _fingerprint_extras(self):
        # its concat runs outside any stage body: the extras keep parent
        # subtrees cacheable
        return (self.target_bytes,)

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    def additional_metrics(self):
        return (CONCAT_TIME, NUM_INPUT_ROWS, NUM_INPUT_BATCHES,
                NUM_OUTPUT_BATCHES) + PIPELINE_STAGE_METRICS

    @property
    def runs_own_pipeline_stage(self) -> bool:
        # wraps its input in a stage of its own, or its child's stage
        # feeds it directly: a consumer must not stack another on it
        return True

    def _flush(self, pending: List[SpillableBatch]) -> ColumnarBatch:
        from ..columnar.encoded import materialize_batch
        self.metrics[NUM_OUTPUT_BATCHES].add(1)

        def do(items):
            batches = [s.get_batch() for s in items]
            try:
                if len(batches) > 1:
                    batches = [materialize_batch(b) for b in batches]
                return concat_batches(batches, self.output_schema)
            finally:
                for s in items:
                    s.release()
        try:
            with self.metrics[CONCAT_TIME].ns_timer():
                return with_retry_no_split(pending, do)
        finally:
            for s in pending:
                s.close()

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        from .adaptive import batch_target_override
        in_rows = self.metrics[NUM_INPUT_ROWS]
        in_batches = self.metrics[NUM_INPUT_BATCHES]
        pending: List[SpillableBatch] = []
        pending_bytes = 0
        # the input behind a stage of its own, unless the child already
        # runs one (a second on the same edge adds a thread for nothing)
        depth = 0 if self.child.runs_own_pipeline_stage else None
        stage = self.pipeline_stage(self.child.execute(), "coalesce",
                                    depth=depth)
        try:
            for batch in stage:
                in_batches.add(1)
                if batch._host_rows is not None:
                    in_rows.add(batch._host_rows)
                else:
                    in_rows.add_device(batch.num_rows)
                size = batch.nbytes
                target = self.target_bytes
                override = batch_target_override()
                if override is not None and override < target:
                    target = override
                if pending and pending_bytes + size > target:
                    flushed, pending, pending_bytes = pending, [], 0
                    yield self._flush(flushed)
                pending.append(SpillableBatch.from_batch(batch))
                pending_bytes += size
                if pending_bytes >= target:
                    flushed, pending, pending_bytes = pending, [], 0
                    yield self._flush(flushed)
            if pending:
                flushed, pending = pending, []
                yield self._flush(flushed)
        finally:
            stage.close()
            for s in pending:
                s.close()
