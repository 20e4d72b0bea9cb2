"""SortExec and TopNExec — the counterpart of spark_rapids_tpu/exec/sort.py
(reference GpuSortExec's per-batch sort, GpuOutOfCoreSortIterator's
spill-backed merge, and GpuTopN).

Each input batch sorts with one stable lexicographic sort over its
order-key lanes (ops/sort.py) and one packed row gather, under
`with_retry` (split in halves by rows), and the sorted run is held as a
SpillableBatch. A small merge concatenates the runs and sorts once more,
under `with_retry_no_split`. With more runs than MERGE_FAN_IN and no
limit the merge is out of core: the runs stay spillable, and a streamed
k-way merge keeps only one chunk per run on the device, emits every row
that is provably final (lexicographically <= the smallest last row of the
runs that still have chunks to load, compared on the sort's own order-key
lanes), and holds the merged chunks of an intermediate pass spillable.
The device footprint is bounded by the fan-in times the chunk size,
whatever the input size. With a `limit` (TopNExec) each sorted run keeps
its first `limit` rows, and the merge stays in memory.

String keys order by prefix lanes (ops/sort.string_order_lanes: the
prefix, then the length) at a word count that covers the batch's longest key (`string_words_for`, one
host read per string key and batch). The streamed merge compares lanes
across runs, so every head's lanes are built at one word count, the
largest any live head needs; a head that needs more rebuilds them all.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch

from ..columnar.batch import ColumnarBatch
from ..columnar.column import bucket_capacity
from ..config import SORT_OOC_ENABLED, active_conf
from ..expr.core import BoundReference, resolve
from ..memory.retry import with_retry_no_split
from ..memory.spillable import SpillableBatch
from ..ops.basic import active_mask, sanitize, slice_rows
from ..ops.sort import (SortOrder, order_key_lanes, sort_batch_columns,
                        string_words_for)
from ..types import Schema
from .base import TpuExec
from .basic import run_spillable
from .coalesce import concat_batches

SORT_TIME = "sortTime"
#: passes of the out-of-core merge, the last (streamed to the consumer)
#: included
MERGE_PASSES = "mergePasses"
#: host reads of the out-of-core merge: one per round of loaded chunks
MERGE_HOST_READS = "mergeHostReads"


def _lex_leq(lanes: List[torch.Tensor], bound: List[torch.Tensor]):
    """Per row: lane tuple <= bound tuple (lexicographic, on the device)."""
    less = torch.zeros(lanes[0].shape, dtype=torch.bool,
                       device=lanes[0].device)
    eq = torch.ones_like(less)
    for lane, b in zip(lanes, bound):
        less = less | (eq & (lane < b))
        eq = eq & (lane == b)
    return less | eq


def _lex_less_scalar(a: List[torch.Tensor], b: List[torch.Tensor]):
    less = torch.zeros((), dtype=torch.bool, device=a[0].device)
    eq = torch.ones_like(less)
    for x, y in zip(a, b):
        less = less | (eq & (x < y))
        eq = eq & (x == y)
    return less


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


def _close_all(spillables) -> None:
    for s in spillables:
        s.close()


def _take(s: SpillableBatch) -> ColumnarBatch:
    """The batch of `s` on the device, and `s` closed. The promotion runs
    under the retry lane: under the catalog lock an unspill cannot wait
    for the writer to free the budget, so it raises TpuRetryOOM until the
    writeback has landed (the JAX package loads without a retry here)."""
    def load(x: SpillableBatch) -> ColumnarBatch:
        b = x.get_batch()
        x.release()
        return b
    try:
        return with_retry_no_split(s, load)
    finally:
        s.close()


class SortExec(TpuExec):
    #: runs merged per streaming pass; the device holds about
    #: 2 x MERGE_FAN_IN chunks of the runs' capacity
    MERGE_FAN_IN = 8

    def __init__(self, orders: Sequence, child: TpuExec,
                 limit: Optional[int] = None):
        super().__init__(child)
        self.orders = resolve_sort_orders(orders, child.output_schema)
        self.limit = limit
        #: spark.rapids.sql.sort.outOfCore.enabled, read at construction
        self._ooc_enabled = active_conf().get(SORT_OOC_ENABLED)

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    def additional_metrics(self):
        return (SORT_TIME, MERGE_PASSES, MERGE_HOST_READS)

    def _string_words(self, batch: ColumnarBatch) -> int:
        return string_words_for(batch.columns,
                                [o.ordinal for o in self.orders])

    def _sort_one(self, batch: ColumnarBatch) -> ColumnarBatch:
        cols, _ = sort_batch_columns(batch.columns, self.orders,
                                     batch.num_rows, batch.capacity,
                                     self._string_words(batch))
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
        runs: List[SpillableBatch] = []
        try:
            with self.metrics[SORT_TIME].ns_timer():
                for batch in self.child.execute():
                    for sorted_batch in run_spillable(batch, self._sort_one):
                        runs.append(SpillableBatch.from_batch(sorted_batch))
            if not runs:
                return
            if len(runs) == 1:
                yield _take(runs.pop())
                return
            if (self.limit is None and len(runs) > self.MERGE_FAN_IN
                    and self._ooc_enabled):
                lists = [[r] for r in runs]
                runs.clear()
                yield from self._merge_out_of_core(lists)
                return
            merge, runs = runs, []
            with self.metrics[SORT_TIME].ns_timer():
                out = self._merge(merge)
            yield out
        finally:
            _close_all(runs)

    def _merge(self, runs: List[SpillableBatch]) -> ColumnarBatch:
        """Small merge: concatenate every run and sort once (a split
        escalates: the runs are already the split unit)."""
        def do(items):
            batches: List[ColumnarBatch] = []
            try:
                for s in items:
                    batches.append(s.get_batch())
                return self._sort_one(
                    concat_batches(batches, self.output_schema))
            finally:
                # an acquire that raised leaves the rest unpinned
                for s in items[:len(batches)]:
                    s.release()
        try:
            return with_retry_no_split(runs, do)
        finally:
            _close_all(runs)

    def _merge_out_of_core(self, run_lists: List[List[SpillableBatch]]
                           ) -> Iterator[ColumnarBatch]:
        """Multi-pass streamed merge: each pass merges groups of
        MERGE_FAN_IN runs into spillable chunks; the last pass streams to
        the consumer. On error, or when the consumer abandons the merge,
        every spillable left is closed."""
        fan = self.MERGE_FAN_IN
        passes = self.metrics[MERGE_PASSES]
        live: List[List[SpillableBatch]] = run_lists
        nxt: List[List[SpillableBatch]] = []
        try:
            while len(live) > fan:
                passes.add(1)
                nxt = []
                for g in range(0, len(live), fan):
                    group = live[g:g + fan]
                    if len(group) == 1:
                        nxt.append(group[0])
                        continue
                    merged: List[SpillableBatch] = []
                    nxt.append(merged)
                    for b in self._stream_merge(group):
                        merged.append(SpillableBatch.from_batch(b))
                live, nxt = nxt, []
            passes.add(1)
            if len(live) == 1:
                while live[0]:
                    yield _take(live[0].pop(0))
                return
            yield from self._stream_merge(live)
        finally:
            for r in live + nxt:
                _close_all(r)

    def _stream_merge(self, queues: List[List[SpillableBatch]]
                      ) -> Iterator[ColumnarBatch]:
        """Streamed k-way merge of sorted chunked runs.

        A row may be emitted once it is lexicographically <= the last
        loaded row of every run that still has chunks to load: any later
        row of such a run is >= its loaded last row. Each head keeps its
        unemitted suffix on the device; emptied heads load their run's
        next chunk. One host read (the heads' emit counts) per round.
        The run lists are consumed in place, so an abandoned or failed
        merge leaves exactly the unconsumed spillables to the caller."""
        reads = self.metrics[MERGE_HOST_READS]
        heads: List[Optional[ColumnarBatch]] = [None] * len(queues)
        # merged chunks are cut to the input chunk bucket, so the chunk
        # size (and the memory bound) stays the same across passes
        chunk_cap = max((bucket_capacity(max(s.num_rows, 1))
                         for q in queues for s in q), default=128)

        def emit(batch: ColumnarBatch) -> Iterator[ColumnarBatch]:
            n = batch.num_rows_host
            if n <= chunk_cap:
                yield batch
                return
            for start in range(0, n, chunk_cap):
                m = min(chunk_cap, n - start)
                yield ColumnarBatch([slice_rows(c, start, m, chunk_cap)
                                     for c in batch.columns], m,
                                    batch.schema)

        def lanes_of(h: ColumnarBatch, words: int):
            # without the activity lane
            return [lane for lane, _ in order_key_lanes(
                h.columns, self.orders, h.num_rows, h.capacity, words)[1:]]

        # lanes per head, rebuilt when the head changes or the common
        # string word count grows (lanes of two widths do not compare)
        lane_cache: dict = {}
        words_cache: dict = {}
        words = 1
        while True:
            for i, q in enumerate(queues):
                if heads[i] is None and q:
                    heads[i] = _take(q.pop(0))
                    lane_cache.pop(i, None)
                    words_cache[i] = self._string_words(heads[i])
            live = [i for i, h in enumerate(heads) if h is not None]
            if not live:
                return
            constrainers = [i for i in live if queues[i]]
            if not constrainers:
                # everything is loaded: one final merge of the heads
                batches = [heads[i] for i in live]
                merged = concat_batches(batches, self.output_schema) \
                    if len(batches) > 1 else batches[0]
                yield from emit(self._sort_one(merged))
                return
            need = max(words_cache[i] for i in live)
            if need > words:
                lane_cache.clear()
                words = need
            for i in live:
                if i not in lane_cache:
                    lane_cache[i] = lanes_of(heads[i], words)
            # the bound: the lexicographic min of the constrainers' last
            # rows
            bound = None
            for i in constrainers:
                last = heads[i].num_rows_host - 1
                b = [lane[last] for lane in lane_cache[i]]
                if bound is None:
                    bound = b
                else:
                    take = _lex_less_scalar(b, bound)
                    bound = [torch.where(take, x, y)
                             for x, y in zip(b, bound)]
            counts = []
            for i in live:
                h = heads[i]
                leq = _lex_leq(lane_cache[i], bound) \
                    & active_mask(h.num_rows, h.capacity)
                counts.append(torch.sum(leq, dtype=torch.int32))
            fetched = torch.stack(counts).tolist()  # the round's host read
            reads.add(1)
            parts: List[ColumnarBatch] = []
            for i, cnt in zip(live, fetched):
                h = heads[i]
                n = h.num_rows_host
                if cnt > 0:
                    cap = bucket_capacity(max(cnt, 1))
                    parts.append(ColumnarBatch(
                        [slice_rows(c, 0, cnt, cap) for c in h.columns],
                        cnt, h.schema))
                if cnt >= n:
                    heads[i] = None  # fully emitted: load the next chunk
                    lane_cache.pop(i, None)
                elif cnt > 0:
                    rest = n - cnt
                    cap = bucket_capacity(max(rest, 1))
                    heads[i] = ColumnarBatch(
                        [slice_rows(c, cnt, rest, cap) for c in h.columns],
                        rest, h.schema)
                    lane_cache.pop(i, None)
            if parts:
                merged = concat_batches(parts, self.output_schema) \
                    if len(parts) > 1 else parts[0]
                yield from emit(self._sort_one(merged))


class TopNExec(SortExec):
    """Sort + limit per batch; the merge keeps `limit` rows in memory."""

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


class PartitionWiseSortExec(TpuExec):
    """Per-partition sort over a range exchange (the reference's
    distributed sort: GpuRangePartitioner bounds and a GpuSortExec per
    partition): the child hands out one batch stream per partition
    (`execute_partitions`) in ascending bound order, so sorting each
    partition on its own yields a globally sorted stream. One inner
    SortExec serves every partition."""

    def __init__(self, orders: Sequence, child: TpuExec):
        super().__init__(child)
        from .basic import InMemoryScanExec
        self._scan = InMemoryScanExec([], child.output_schema)
        self._sort = SortExec(orders, self._scan)

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        for gen in self.child.execute_partitions():
            self._scan._batches = list(gen)
            if not self._scan._batches:
                continue
            yield from self._sort.execute()

    def node_description(self):
        return "PartitionWiseSortExec"
