"""WindowExec — the counterpart of spark_rapids_tpu/exec/window.py
(reference GpuWindowExec.scala:146 and its running, double-pass, bounded
and unbounded-to-unbounded specialisations). One exec: every frame shape
lowers to segmented scans over partition-sorted rows (ops/window.py).

The drive is the JAX package's: the pre-projected rows (the child's
columns, then the partition keys, the order keys and the functions'
inputs) stream through the port's SortExec on (partition, order) keys,
out of core when its runs outgrow the merge fan-in. Each sorted chunk is
windowed after holding back its last, possibly incomplete partition,
which is prepended to the next chunk: one host read a chunk
(`_last_partition_start`). A partition that grows past
TWO_PASS_THRESHOLD_ROWS while every expression is a whole-partition
aggregate takes the two-pass carry (`_PartitionCarry`): running
sum/count/min/max scalars and spillable row pieces, replayed with the
final values appended; each chunk it meets costs one more host read
(`_first_partition_len`). Without partition keys the input is one
partition, windowed as one concatenated batch.

The window's sort permutes every pre-projected column by one packed row
gather (ops/gather.gather_batch_columns: dma_row_gather on the card).
The metrics count the drive's host reads (`partitionHostReads`), the
partitions the carry took (`carriedPartitions`) and its pieces
(`carryPieces`).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import torch

from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, StringColumn, bucket_capacity
from ..expr.core import Expression, col
from ..expr.windowexprs import (DenseRank, FirstValue, Lag, LastValue, Rank,
                                RowNumber, WindowAgg, WindowExpression)
from ..memory.spillable import SpillableBatch
from ..ops.basic import active_mask, gather_column, sanitize, slice_rows
from ..ops.gather import gather_batch_columns
from ..ops.sort import (SortOrder, group_segment_ids, numeric_order_lanes,
                        order_key_lanes, sort_permutation,
                        string_prefix_lanes, string_words_for)
from ..ops.strings import string_lengths
from ..ops.window import (bounded_min_max, lag_lead, range_frame_bounds,
                          range_min_max, range_sum_count, rank_dense_rank,
                          row_number, run_ends, running_min_max,
                          segment_ends, segment_start_flags, segment_starts,
                          windowed_sum_count)
from ..types import (ByteType, DoubleType, FloatType, IntegerType, LongType,
                     Schema, ShortType, StructField)
from .base import TpuExec
from .basic import bind_projection, eval_projection, projection_schema
from .coalesce import concat_batches
from .sort import SortExec, _take

#: host reads of the partition-aligned drive (one a sorted chunk, one
#: more a chunk the carry meets)
PARTITION_HOST_READS = "partitionHostReads"
#: partitions that took the two-pass carry, and the pieces it held
CARRIED_PARTITIONS = "carriedPartitions"
CARRY_PIECES = "carryPieces"

_CARRY_TYPES = (ByteType, ShortType, IntegerType, LongType, FloatType,
                DoubleType)


class _StreamSourceExec(TpuExec):
    """Leaf yielding batches from a generator (keeps the window's sort
    input streaming)."""

    def __init__(self, schema: Schema, gen, device=None):
        super().__init__()
        self._schema = schema
        self._gen = gen
        self._device = device

    @property
    def output_schema(self) -> Schema:
        return self._schema

    @property
    def device(self):
        return self._device

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        yield from self._gen


def _slice_batch(batch: ColumnarBatch, start: int, n: int,
                 schema: Schema) -> ColumnarBatch:
    cap = bucket_capacity(max(n, 1))
    return ColumnarBatch([slice_rows(c, start, n, cap)
                          for c in batch.columns], n, schema)


class WindowExec(TpuExec):
    #: a partition past this many rows whose expressions are all
    #: whole-partition aggregates takes the two-pass carry
    TWO_PASS_THRESHOLD_ROWS = 1 << 21

    def __init__(self, window_exprs: Sequence[Tuple[WindowExpression, str]],
                 child: TpuExec):
        super().__init__(child)
        self.window_exprs = list(window_exprs)
        in_schema = child.output_schema
        # every expression of one exec shares partition and order (the
        # planner stacks WindowExecs for differing specs, as Spark does)
        spec0 = self.window_exprs[0][0].spec
        for we, _ in self.window_exprs:
            if we.spec.partition_by != spec0.partition_by \
                    or we.spec.order_by != spec0.order_by:
                raise ValueError("one WindowExec takes one partitioning and "
                                 "ordering")
        self.spec = spec0

        # pre-projection: child cols + partition keys + order keys + inputs
        self._pre_exprs: List[Expression] = [col(n) for n in in_schema.names]
        self._n_child = len(in_schema.fields)
        self._part_slots: List[int] = []
        for e in self.spec.partition_by:
            self._part_slots.append(len(self._pre_exprs))
            self._pre_exprs.append(e.alias(f"_wpart{len(self._part_slots)}"))
        self._order_slots: List[int] = []
        self._order_dirs = []
        for o in self.spec.order_by:
            e, asc = o[0], o[1] if len(o) > 1 else True
            nf = o[2] if len(o) > 2 else None
            self._order_slots.append(len(self._pre_exprs))
            self._order_dirs.append((asc, nf))
            self._pre_exprs.append(e.alias(f"_word{len(self._order_slots)}"))
        self._input_slots: List[List[int]] = []
        for we, _ in self.window_exprs:
            slots = []
            for e in we.fn.inputs:
                slots.append(len(self._pre_exprs))
                self._pre_exprs.append(e.alias(f"_win{len(self._pre_exprs)}"))
            self._input_slots.append(slots)
        self._pre_bound = bind_projection(self._pre_exprs, in_schema)
        self._pre_schema = projection_schema(self._pre_exprs, in_schema)

    @property
    def output_schema(self) -> Schema:
        fields = list(self.child.output_schema.fields)
        for i, (we, name) in enumerate(self.window_exprs):
            in_types = [self._pre_schema.fields[s].data_type
                        for s in self._input_slots[i]]
            fields.append(StructField(name, we.fn.result_type(in_types)))
        return Schema(tuple(fields))

    def additional_metrics(self):
        return (PARTITION_HOST_READS, CARRIED_PARTITIONS, CARRY_PIECES)

    def _sort_orders(self) -> List[SortOrder]:
        return [SortOrder(s) for s in self._part_slots] + [
            SortOrder(s, asc, nf) for s, (asc, nf)
            in zip(self._order_slots, self._order_dirs)]

    def _words(self, batch: ColumnarBatch) -> int:
        return string_words_for(batch.columns,
                                self._part_slots + self._order_slots)

    # -- kernel ------------------------------------------------------------
    def _window_batch(self, batch: ColumnarBatch, words: int
                      ) -> ColumnarBatch:
        cap = batch.capacity
        n = batch.num_rows
        perm = sort_permutation(batch.columns, self._sort_orders(), n, cap,
                                words)
        # the sort moves the whole batch: one packed row gather for the
        # fixed-width columns
        sorted_cols = gather_batch_columns(batch.columns, perm)
        sorted_parts = [sorted_cols[s] for s in self._part_slots]
        sorted_orders = [sorted_cols[s] for s in self._order_slots]
        if self._part_slots:
            seg, _ = group_segment_ids(sorted_parts, n, cap, words)
        else:
            seg = torch.where(active_mask(n, cap, batch.device), 0, cap) \
                .to(torch.int32)
        ob = group_last = None
        if self._order_slots:
            # order-key boundaries (the first row of each distinct order
            # key) and each row's last row of its order group (RANGE
            # frames with ties)
            lanes = order_key_lanes(
                sorted_orders, [SortOrder(i)
                                for i in range(len(sorted_orders))],
                n, cap, words)[1:]
            ob = torch.zeros(cap, dtype=torch.bool, device=batch.device)
            for lane, _ in lanes:
                ob |= lane != torch.roll(lane, 1)
            ob[0] = True
            group_last = run_ends(ob | segment_start_flags(seg), cap)
        out_cols = list(sorted_cols[: self._n_child])
        out_schema = self.output_schema
        for i, (we, _) in enumerate(self.window_exprs):
            res_type = out_schema.fields[self._n_child + i].data_type
            ins = [sorted_cols[s] for s in self._input_slots[i]]
            out = self._eval_fn(we.fn, we.spec.frame, ins, seg, ob,
                                group_last, n, cap, res_type, sorted_orders)
            out_cols.append(sanitize(out, n))
        return ColumnarBatch(out_cols, n, out_schema, batch._host_rows)

    def _eval_fn(self, fn, frame, ins, seg, order_boundary, group_last,
                 n, cap, res_type, sorted_orders) -> Column:
        ones = torch.ones(cap, dtype=torch.bool, device=seg.device)
        if isinstance(fn, RowNumber):
            return Column(row_number(seg, n, cap), ones, res_type)
        if isinstance(fn, Rank):  # and DenseRank
            rank, dense = rank_dense_rank(order_boundary, seg, n, cap)
            return Column(dense if isinstance(fn, DenseRank) else rank,
                          ones, res_type)
        if isinstance(fn, Lag):  # and Lead (a negated offset)
            out, same_seg = lag_lead(ins[0], seg, n, cap, fn.offset)
            if fn.default is None:
                return out
            # the default only where the offset row does NOT exist; an
            # existing null offset row stays NULL (Spark)
            data = torch.where(same_seg, out.data,
                               torch.full((), fn.default,
                                          dtype=out.data.dtype,
                                          device=seg.device))
            return Column(data, out.validity | ~same_seg, res_type)
        if isinstance(fn, LastValue):
            idx = group_last if group_last is not None \
                else segment_ends(seg, cap)
            return gather_column(ins[0], idx)
        if isinstance(fn, FirstValue):
            return gather_column(ins[0], segment_starts(seg, cap))
        if not isinstance(fn, WindowAgg):
            raise NotImplementedError(f"window function {fn!r}")
        ordered = bool(self._order_slots)
        # the default frame: RANGE UNBOUNDED..CURRENT (with ties) when
        # ordered, the whole partition otherwise
        range_ties = frame.kind == "default" and ordered
        if frame.kind == "default":
            preceding, following = (None, 0) if ordered else (None, None)
        else:
            preceding, following = frame.preceding, frame.following
        values = ins[0] if ins else None
        if values is None:
            data = torch.ones(cap, dtype=torch.int64, device=seg.device)
            valid = active_mask(n, cap, seg.device)
        else:
            data, valid = values.data, values.validity
        if frame.kind == "range" and not (preceding is None
                                          and following is None):
            # a bounded RANGE frame: value offsets over the single numeric
            # order key (Spark's analyzer enforces exactly one)
            if len(self._order_slots) != 1:
                raise ValueError("a bounded RANGE frame needs exactly one "
                                 "order expression")
            asc, nf = self._order_dirs[0]
            lo, hi = range_frame_bounds(sorted_orders[0], seg, n, cap,
                                        preceding, following, asc,
                                        asc if nf is None else nf)
            if fn.op in ("sum", "count", "avg"):
                s, c = range_sum_count(data, valid, seg, n, cap, lo, hi)
                return self._sum_result(fn.op, s, c, ones, res_type)
            out, ok = range_min_max(data, valid, n, cap, lo, hi,
                                    fn.op == "max")
            return Column(out.to(data.dtype), ok, res_type)
        if fn.op in ("sum", "count", "avg"):
            s, c = windowed_sum_count(data, valid, seg, n, cap, preceding,
                                      following)
            if range_ties:
                gl = group_last.long()
                s, c = s[gl], c[gl]
            return self._sum_result(fn.op, s, c, ones, res_type)
        # min / max
        is_max = fn.op == "max"
        if preceding is None and following in (0, None):
            out, ok = running_min_max(data, valid, seg, n, cap, is_max)
            # the whole partition: the running value at its last row
            last = segment_ends(seg, cap) if following is None else (
                group_last if range_ties else None)
            if last is not None:
                out, ok = out[last.long()], ok[last.long()]
            return Column(out.to(data.dtype), ok, res_type)
        # bounded frames: the sparse-table sliding extrema (reference
        # GpuBatchedBoundedWindowExec.scala:220)
        out, ok = bounded_min_max(data, valid, seg, n, cap, preceding,
                                  following, is_max)
        return Column(out.to(data.dtype), ok, res_type)

    @staticmethod
    def _sum_result(op: str, s, c, ones, res_type) -> Column:
        if op == "count":
            return Column(c.to(torch.int64), ones, res_type)
        ok = c > 0
        if op == "avg":
            d = s.to(torch.float64) / torch.where(ok, c, 1)
            return Column(torch.where(ok, d, 0.0), ok, res_type)
        return Column(s.to(res_type.torch_dtype), ok, res_type)

    # -- the giant-partition two-pass carry (reference
    # GpuUnboundedToUnboundedAggWindowExec.scala:1155) ---------------------
    def _whole_partition_aggs(self):
        """(op, input slot or None) per expression when EVERY window
        expression is a whole-partition numeric aggregate, else None."""
        out = []
        for i, (we, _) in enumerate(self.window_exprs):
            fn, fr = we.fn, we.spec.frame
            if not isinstance(fn, WindowAgg):
                return None
            whole = (fr.kind == "default" and not self._order_slots) or \
                (fr.kind in ("rows", "range") and fr.preceding is None
                 and fr.following is None)
            if not whole:
                return None
            slots = self._input_slots[i]
            if slots and not isinstance(
                    self._pre_schema.fields[slots[0]].data_type,
                    _CARRY_TYPES):
                return None
            out.append((fn.op, slots[0] if slots else None))
        return out

    class _PartitionCarry:
        """Running whole-partition aggregate state and spillable row
        pieces of ONE partition streaming through several chunks. Peak
        device memory: one chunk, not the partition."""

        def __init__(self, exec_: "WindowExec", aggs):
            self._exec = exec_
            self._aggs = aggs
            self._pieces: List[SpillableBatch] = []
            self._state = None  # per agg (sum, count, min, max) scalars

        def _zero_state(self, batch: ColumnarBatch):
            st = []
            dev = batch.device
            for _, slot in self._aggs:
                flt = slot is not None \
                    and batch.columns[slot].data.dtype.is_floating_point
                dt = torch.float64 if flt else torch.int64
                info = torch.iinfo(torch.int64)
                mn = float("inf") if flt else info.max
                mx = float("-inf") if flt else info.min
                st.append(tuple(torch.tensor(v, dtype=t, device=dev)
                                for v, t in ((0, dt), (0, torch.int64),
                                             (mn, dt), (mx, dt))))
            return st

        def _update(self, batch: ColumnarBatch) -> None:
            out = []
            act = active_mask(batch.num_rows, batch.capacity, batch.device)
            for (op, slot), (s, c, mn, mx) in zip(self._aggs, self._state):
                if slot is None:
                    out.append((s, c + act.sum(dtype=torch.int64), mn, mx))
                    continue
                column = batch.columns[slot]
                valid = column.validity & act
                # widen BEFORE the where: an i64 sentinel in an i32 lane
                # would truncate
                v = column.data.to(s.dtype)
                s = s + torch.where(valid, v, 0).sum()
                c = c + valid.sum(dtype=torch.int64)
                mn = torch.minimum(mn, torch.where(valid, v, mn).min())
                mx = torch.maximum(mx, torch.where(valid, v, mx).max())
                out.append((s, c, mn, mx))
            self._state = out

        def add(self, piece: ColumnarBatch) -> None:
            if self._state is None:
                self._state = self._zero_state(piece)
            self._update(piece)
            self._pieces.append(SpillableBatch.from_batch(piece))
            self._exec.metrics[CARRY_PIECES].add(1)

        def finalize(self) -> Iterator[ColumnarBatch]:
            ex = self._exec
            out_schema = ex.output_schema
            n_child = ex._n_child
            try:
                while self._pieces:
                    # a spilled piece comes back under the retry lane (an
                    # unspill waits for the async writer's writeback)
                    piece = _take(self._pieces.pop(0))
                    cap, n = piece.capacity, piece.num_rows
                    act = active_mask(n, cap, piece.device)
                    cols = list(piece.columns[:n_child])
                    for i, ((op, _), (s, c, mn, mx)) in enumerate(
                            zip(self._aggs, self._state)):
                        rt = out_schema.fields[n_child + i].data_type
                        if op == "count":
                            val, ok = c, torch.ones((), dtype=torch.bool,
                                                    device=act.device)
                        elif op == "avg":
                            val, ok = s.to(torch.float64) \
                                / torch.clamp(c, min=1), c > 0
                        else:
                            val = {"sum": s, "min": mn, "max": mx}[op]
                            ok = c > 0
                        data = val.to(rt.torch_dtype).expand(cap)
                        cols.append(sanitize(Column(data.contiguous(),
                                                    ok.expand(cap) & act,
                                                    rt), n))
                    yield ColumnarBatch(cols, n, out_schema, piece._host_rows)
            finally:
                for sp in self._pieces:
                    sp.close()
                self._pieces = []

        def close(self) -> None:
            for sp in self._pieces:
                sp.close()
            self._pieces = []

    def _part_key_match(self, columns, words: int, ref_cols, ref_idx: int):
        """(cap,) bool: the row's partition key equals ref_cols' key at
        ref_idx (ref_cols: one column per partition slot). A null key
        compares by validity alone; a string by its prefix lanes at
        `words` and its length."""
        cap = columns[self._part_slots[0]].capacity
        same = torch.ones(cap, dtype=torch.bool,
                          device=columns[0].validity.device)
        for c, r in zip((columns[s] for s in self._part_slots), ref_cols):
            if isinstance(c, StringColumn):
                pairs = list(zip(string_prefix_lanes(c, words),
                                 string_prefix_lanes(r, words)))
                pairs.append((string_lengths(c), string_lengths(r)))
            else:
                pairs = [(a, b) for (a, _), (b, _) in
                         zip(numeric_order_lanes(c), numeric_order_lanes(r))]
            for lane, rlane in pairs:
                lane = torch.where(c.validity, lane, 0)
                rlane = torch.where(r.validity, rlane, 0)
                same &= lane == rlane[ref_idx]
            same &= c.validity == r.validity[ref_idx]
        return same

    def _host_read(self, t: torch.Tensor) -> int:
        self.metrics[PARTITION_HOST_READS].add(1)
        return int(t)

    def _first_partition_len(self, batch: ColumnarBatch, words: int,
                             ref_cols) -> int:
        """Host int: the leading rows whose partition key equals the
        CARRY's key (ref_cols, 1-row columns), not the batch's own first
        key, which would fold a fresh partition into the carry when a
        chunk boundary lands on the giant partition's end."""
        n, cap = batch.num_rows, batch.capacity
        same = self._part_key_match(batch.columns, words, ref_cols, 0)
        act = active_mask(n, cap, batch.device)
        idx = torch.arange(cap, dtype=torch.int32, device=batch.device)
        nm = torch.where(act & ~same, idx, cap).min()
        return self._host_read(torch.minimum(nm, n))

    def _last_partition_start(self, batch: ColumnarBatch, words: int) -> int:
        """Host int: the first row of the LAST partition key of a
        (partition, order)-sorted batch: one small host read a chunk, the
        price of partition-aligned batching."""
        n, cap = batch.num_rows, batch.capacity
        last = torch.clamp(n - 1, 0, cap - 1).long()
        same = self._part_key_match(
            batch.columns, words,
            [batch.columns[s] for s in self._part_slots], last)
        act = active_mask(n, cap, batch.device)
        idx = torch.arange(cap, dtype=torch.int32, device=batch.device)
        return self._host_read(torch.where(act & ~same, idx, -1).max() + 1)

    # -- drive -------------------------------------------------------------
    def internal_execute(self) -> Iterator[ColumnarBatch]:
        pre = (eval_projection(self._pre_bound, b, self._pre_schema)
               for b in self.child.execute())
        source = _StreamSourceExec(self._pre_schema, pre, self.child.device)
        if not self._part_slots:
            batches = list(source.execute())
            if not batches:
                return
            merged = concat_batches(batches, self._pre_schema) \
                if len(batches) > 1 else batches[0]
            yield self._window_batch(merged, self._words(merged))
            return
        sorter = SortExec(self._sort_orders(), source)
        held = carry = None
        carry_ref, carry_words = None, 0
        two_pass_aggs = self._whole_partition_aggs()
        try:
            for chunk in sorter.execute():
                if carry is not None:
                    # rows continuing the giant partition fold into the
                    # carry; the first foreign key closes it
                    cw = max(self._words(chunk), carry_words)
                    flen = self._first_partition_len(chunk, cw, carry_ref)
                    nch = chunk.num_rows_host
                    if flen >= nch:
                        carry.add(chunk)
                        continue
                    if flen > 0:
                        carry.add(_slice_batch(chunk, 0, flen,
                                               self._pre_schema))
                    yield from carry.finalize()
                    carry = None
                    chunk = _slice_batch(chunk, flen, nch - flen,
                                         self._pre_schema)
                cur = concat_batches([held, chunk], self._pre_schema) \
                    if held is not None and held.num_rows_host > 0 \
                    else chunk
                n = cur.num_rows_host
                words = self._words(cur)
                split = self._last_partition_start(cur, words)
                if split <= 0:
                    # one partition so far: the carry when every
                    # expression is a whole-partition aggregate, else
                    # keep growing
                    if two_pass_aggs is not None \
                            and n > self.TWO_PASS_THRESHOLD_ROWS:
                        carry = self._PartitionCarry(self, two_pass_aggs)
                        self.metrics[CARRIED_PARTITIONS].add(1)
                        carry.add(cur)
                        # the carried partition's 1-row reference key
                        carry_ref = [slice_rows(cur.columns[s], 0, 1,
                                                bucket_capacity(1))
                                     for s in self._part_slots]
                        carry_words = words
                        held = None
                    else:
                        held = cur
                    continue
                ready = _slice_batch(cur, 0, split, self._pre_schema)
                held = _slice_batch(cur, split, n - split, self._pre_schema)
                # the word count stays exact for the prefix
                yield self._window_batch(ready, words)
            if carry is not None:
                c, carry = carry, None
                yield from c.finalize()
            elif held is not None and held.num_rows_host > 0:
                yield self._window_batch(held, self._words(held))
        finally:
            if carry is not None:
                carry.close()

    def node_description(self):
        return "WindowExec [" + ", ".join(
            f"{we!r} AS {name}" for we, name in self.window_exprs) + "]"
