"""SortExec and TopNExec — the counterpart of spark_rapids_tpu/exec/sort.py
with in-memory runs.

Each input batch sorts with one stable lexicographic sort over its
order-key lanes (ops/sort.py) and one packed row gather; several runs
concatenate on the device and sort once more. With a `limit` each sorted
run keeps its first `limit` rows in a bucket of that size. The
out-of-core merge of spilled runs waits for ROADMAP A.4.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch

from ..columnar.batch import ColumnarBatch
from ..columnar.column import bucket_capacity
from ..expr.core import BoundReference, resolve
from ..ops.basic import sanitize, slice_rows
from ..ops.sort import SortOrder, sort_batch_columns
from ..types import Schema
from .base import TpuExec
from .joins import concat_batches

SORT_TIME = "sortTime"


def resolve_sort_orders(orders: Sequence, schema: Schema) -> List[SortOrder]:
    """Accepts SortOrder (ordinal-based) or (Expression, asc, nulls_first)
    with a bare column reference."""
    out = []
    for o in orders:
        if isinstance(o, SortOrder):
            out.append(o)
            continue
        expr, asc, nf = (o + (None,))[:3] if isinstance(o, tuple) \
            else (o, True, None)
        bound = resolve(expr, schema)
        if not isinstance(bound, BoundReference):
            raise NotImplementedError(
                "computed sort keys need a projection below the sort")
        out.append(SortOrder(bound.ordinal, asc, nf))
    return out


class SortExec(TpuExec):
    def __init__(self, orders: Sequence, child: TpuExec,
                 limit: Optional[int] = None):
        super().__init__(child)
        self.orders = resolve_sort_orders(orders, child.output_schema)
        self.limit = limit

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    def additional_metrics(self):
        return (SORT_TIME,)

    def _sort_one(self, batch: ColumnarBatch) -> ColumnarBatch:
        cols, _ = sort_batch_columns(batch.columns, self.orders,
                                     batch.num_rows, batch.capacity)
        out = ColumnarBatch(cols, batch.num_rows, batch.schema,
                            batch._host_rows)
        if self.limit is None:
            return out
        # min(rows, limit) on the device: no host read per batch
        n = torch.clamp(batch.num_rows, max=self.limit)
        small = bucket_capacity(self.limit)
        if batch.capacity > small:
            cols = [slice_rows(c, 0, n, small) for c in out.columns]
        else:
            cols = [sanitize(c, n) for c in out.columns]
        return ColumnarBatch(cols, n, batch.schema)

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        with self.metrics[SORT_TIME].ns_timer():
            runs = [self._sort_one(b) for b in self.child.execute()]
            if not runs:
                return
            out = runs[0] if len(runs) == 1 else self._sort_one(
                concat_batches(runs, self.output_schema))
        yield out


class TopNExec(SortExec):
    """Sort + limit per batch; the merge keeps `limit` rows."""

    def __init__(self, limit: int, orders: Sequence, child: TpuExec,
                 offset: int = 0):
        super().__init__(orders, child, limit=limit + offset)
        self.offset = offset

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        for batch in super().internal_execute():
            if self.offset:
                n = max(0, batch.num_rows_host - self.offset)
                cols = [slice_rows(c, self.offset, n, batch.capacity)
                        for c in batch.columns]
                batch = ColumnarBatch(cols, n, batch.schema)
            yield batch
