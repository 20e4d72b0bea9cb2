"""AggregateExec — the counterpart of spark_rapids_tpu/exec/aggregate.py.

Modes, as in Spark's partial/final split: `complete` aggregates its
input and evaluates; `partial` stops before the evaluation and emits the
keys and aggregation buffers (it feeds an exchange); `final` takes such
keys+buffers batches (its input schema is its buffer schema), merges
them with the merge ops and evaluates, with result types from the
partial's `input_types`. Final mode never takes the fused kernel and
absorbs no chain: its child's batches are buffers already.

Speculative tier (inside a speculation scope, `_spec_enabled`: the conf
spark.rapids.tpu.agg.speculative.enabled read at construction with the
bucket settings and spark.rapids.tpu.fusion.enabled), one step
per source batch with no host synchronisation (`_streaming_step`):
  1. the absorbed filter/project chain and the pre-projection
     [group keys..., agg inputs...] run inside the fused scan-aggregate
     kernel (ops/fused_scan_agg.py) when the chain compiles to a spec;
     otherwise they run as torch ops feeding ops/maskedagg.masked_groupby;
  2. the small masked-bucket partial folds into an O(1)-size device state
     (concat + masked_groupby with the merge ops);
  3. dirty buckets raise a device-side speculation flag, recorded with
     the active speculation scope and read once with the results.

Exact tier (outside a scope, under force_exact, or `_spec_enabled`
False): each source batch aggregates through
ops/maskedagg.masked_groupby_exact (masked buckets, or the sort-based
group-by when rows are left over) into a full-capacity partial; partials
are held as SpillableBatches and merge pairwise on the device
(`_tree_merge_device`), MERGE_FAN_IN at a time, and big ones shrink to a
tight bucket after one host read.

String keys or buffers, and decimal128 ones such as every decimal sum's
buffer (`_masked_ok` False), have no masked buckets: the aggregate
absorbs no chain and runs the exact drive, each source batch
and each merge through the hash group-by (ops/hashagg.py) at 2 rounds,
then at 6, then the sort-based group-by with string lanes; the route
reads `leftover` on the host after each hash attempt, as the JAX package
does, and counts the route that produced the result (`hash_rounds_2`,
`hash_rounds_6`, `sort_fallback`). Its partials merge by one concat and
one re-aggregation.

Both tiers run each source batch as a SpillableBatch under
`with_retry(..., split_in_half_by_rows)`, and the merge of the held
partials under `with_retry` with a policy that splits the set of
partials (memory/retry.py), as the JAX package does. The aggregate takes
no dictionary-encoded input: its source decodes at its output boundary.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from ..columnar.batch import ColumnarBatch, empty_batch
from ..columnar.column import Column, Decimal128Column, bucket_capacity
from ..config import (AGG_GROUP_SLOTS, AGG_ROUNDS, AGG_SPECULATIVE,
                      FUSION_ENABLED, active_conf)
from ..expr.aggexprs import AggregateFunction
from ..expr.core import Expression
from ..memory.retry import split_in_half_by_rows, with_retry
from ..memory.spillable import SpillableBatch
from ..ops.aggregate import groupby_aggregate, groupby_aggregate_hash
from ..ops.basic import concat_columns, sanitize, slice_rows
from ..ops.fused_scan_agg import compile_scan_agg_spec, fused_scan_agg
from ..ops.maskedagg import (
    masked_groupby, masked_groupby_exact, masked_reduce,
)
from ..types import (BinaryType, DataType, DecimalType, Schema, StringType,
                     StructField)
from .base import AGG_TIME, TpuExec
from .basic import (bind_projection, eval_projection, projection_schema,
                    run_spillable)
from .coalesce import concat_batches
from .speculation import current_scope, speculation_allowed

#: the string-key routes, counted by the one that produced a result
HASH_ROUNDS = (2, 6)
HASH_ROUTE = "hash_rounds_{}"
SORT_FALLBACK = "sort_fallback"


MODES = ("complete", "partial", "final")


def _result_column(data, valid, dtype) -> Column:
    """A reduction's result lanes as a column: a (hi, lo) pair of limb
    lanes (a decimal sum's buffer) as a Decimal128Column."""
    if isinstance(data, tuple):
        return Decimal128Column.from_limbs(data[0], data[1], valid, dtype)
    return Column(data.to(dtype.torch_dtype), valid, dtype)


class AggregateExec(TpuExec):
    def __init__(self, group_exprs: Sequence[Expression],
                 aggregates: Sequence[Tuple[AggregateFunction, str]],
                 child: TpuExec, mode: str = "complete",
                 input_types: Optional[List[List[DataType]]] = None):
        """`input_types`: per aggregate, its original input types, which a
        final-mode instance takes from its partial (`_input_types`) so
        that its result types are the single-stage plan's; without them
        final mode derives them from the buffer types."""
        super().__init__(child)
        if mode not in MODES:
            raise ValueError(f"unknown aggregate mode {mode!r}")
        self.mode = mode
        self.group_exprs = list(group_exprs)
        self.aggregates = list(aggregates)
        in_schema = child.output_schema
        # the masked-bucket settings, read at construction as the JAX
        # package reads them
        conf = active_conf()
        self._slots = max(8, min(64, conf.get(AGG_GROUP_SLOTS)))
        self._rounds = max(1, conf.get(AGG_ROUNDS))
        # False pins the exact tier even inside a speculation scope (a
        # plan whose key cardinality is known to overflow the buckets)
        self._spec_enabled = conf.get(AGG_SPECULATIVE)
        self._fusion_enabled = conf.get(FUSION_ENABLED)
        self._key_count = len(group_exprs)
        self._fused_steps: list = []
        self._source: TpuExec = child
        self._scan_agg_spec = None

        if mode == "final":
            # the input is a partial's keys+buffers
            self._input_types = input_types
            self._buffer_schema = in_schema
            return

        # pre-projection: keys then the union of agg inputs
        self._pre_exprs = list(self.group_exprs)
        self._input_slots: List[List[int]] = []
        for fn, _ in self.aggregates:
            slots = []
            for e in fn.inputs:
                slot = len(self._pre_exprs)
                self._pre_exprs.append(e.alias(f"_aggin{slot}"))
                slots.append(slot)
            self._input_slots.append(slots)
        self._pre_bound = bind_projection(self._pre_exprs, in_schema)
        self._pre_schema = projection_schema(self._pre_exprs, in_schema)
        self._input_types = [
            [self._pre_schema.fields[s].data_type for s in slots]
            for slots in self._input_slots]
        self._buffer_schema = self._make_buffer_schema()

        # whole-stage fusion: inline the upstream filter/project chain
        # into this operator's per-batch step (masked buckets only: the
        # string route reads its child's batches)
        steps, node = [], child
        while self._fusion_enabled and self._masked_ok \
                and hasattr(node, "fused_step"):
            steps.append(node.fused_step())
            node = node.child
        self._fused_steps = list(reversed(steps))
        self._source = node

        # the fused scan-aggregate kernel, when every absorbed expression
        # is in its whitelist
        if self.group_exprs and self._masked_ok:
            agg_op_slots = []
            for i, (fn, _) in enumerate(self.aggregates):
                for op, slot in fn.update_ops():
                    agg_op_slots.append(
                        (op, self._input_slots[i][slot]
                         if slot is not None else None))
            self._scan_agg_spec = compile_scan_agg_spec(
                self._fused_steps, self._pre_bound, self._pre_schema,
                self._key_count, agg_op_slots, self._source.output_schema)

    def _make_buffer_schema(self) -> Schema:
        fields = list(self._pre_schema.fields[: self._key_count])
        for i, (fn, name) in enumerate(self.aggregates):
            for j, bt in enumerate(fn.buffer_types(self._input_types[i])):
                fields.append(StructField(f"{name}#buf{j}", bt, True))
        return Schema(tuple(fields))

    def _buffer_types(self, i: int) -> List[DataType]:
        """Aggregate i's buffer types, from the buffer schema."""
        pos = self._key_count + sum(len(fn.merge_ops())
                                    for fn, _ in self.aggregates[:i])
        n_buf = len(self.aggregates[i][0].merge_ops())
        return [f.data_type
                for f in self._buffer_schema.fields[pos: pos + n_buf]]

    @property
    def output_schema(self) -> Schema:
        if self.mode == "partial":
            return self._buffer_schema
        key_fields = list(self._buffer_schema.fields[: self._key_count])
        agg_fields = [StructField(name, fn.result_type(self._input_types[i])
                                  if self._input_types is not None else
                                  fn.result_type_from_buffer(
                                      self._buffer_types(i)))
                      for i, (fn, name) in enumerate(self.aggregates)]
        return Schema(tuple(key_fields + agg_fields))

    def additional_metrics(self):
        return (AGG_TIME, SORT_FALLBACK) + tuple(
            HASH_ROUTE.format(r) for r in HASH_ROUNDS)

    @property
    def _masked_ok(self) -> bool:
        """True when the masked-bucket tiers apply: every key and buffer is
        fixed-width and one lane wide (strings have no masked order lanes;
        a decimal128 key or buffer, every decimal sum's, takes the hash
        route, as in the JAX package)."""
        return not any(isinstance(f.data_type, (StringType, BinaryType))
                       or (isinstance(f.data_type, DecimalType)
                           and f.data_type.is_decimal128)
                       for f in self._buffer_schema.fields)

    @property
    def _hash_path_ok(self) -> bool:
        """The hash group-by serves every aggregate but min/max over a
        string buffer, which needs order lanes (update and merge both see
        them as min/max over the string buffer)."""
        pos = self._key_count
        for fn, _ in self.aggregates:
            for op in fn.merge_ops():
                bt = self._buffer_schema.fields[pos].data_type
                if op in ("min", "max") and isinstance(
                        bt, (StringType, BinaryType)):
                    return False
                pos += 1
        return True

    # -- per-batch step ----------------------------------------------------
    def _update_inputs(self, batch: ColumnarBatch):
        keys = list(batch.columns[: self._key_count])
        agg_inputs = []
        for i, (fn, _) in enumerate(self.aggregates):
            for op, slot in fn.update_ops():
                col = batch.columns[self._input_slots[i][slot]] \
                    if slot is not None else None
                agg_inputs.append((op, col))
        return keys, agg_inputs

    def _merge_inputs(self, batch: ColumnarBatch):
        keys = list(batch.columns[: self._key_count])
        agg_inputs = []
        pos = self._key_count
        for fn, _ in self.aggregates:
            for op in fn.merge_ops():
                agg_inputs.append((op, batch.columns[pos]))
                pos += 1
        return keys, agg_inputs

    def _apply_fused(self, batch: ColumnarBatch):
        """Run the absorbed chain as torch ops: filters become a row mask
        (no compaction), projections new columns."""
        mask = None
        cur = batch
        for step in self._fused_steps:
            if step[0] == "filter":
                pred = step[1].columnar_eval(cur)
                m = pred.data & pred.validity
                mask = m if mask is None else (mask & m)
            else:
                _, bound, schema = step
                cur = eval_projection(bound, cur, schema)
        return cur, mask

    def _small_cap(self) -> int:
        return bucket_capacity(self._slots * self._rounds)

    def _build_small_batch(self, out_keys, results, num_groups
                           ) -> ColumnarBatch:
        cols = list(out_keys)
        buf_fields = self._buffer_schema.fields[self._key_count:]
        for r, f in zip(results, buf_fields):
            if r[0] == "col":
                cols.append(r[1])
                continue
            data, valid = r[1]
            cols.append(_result_column(data, valid, f.data_type))
        return ColumnarBatch(cols, num_groups, self._buffer_schema)

    def _streaming_step(self, batch: ColumnarBatch, state: ColumnarBatch,
                        flag: torch.Tensor):
        """One step per source batch: fused chain -> masked-bucket partial
        -> fold into the O(1) running state -> evaluate (not in partial
        mode). In final mode the batch's buffers go through the masked
        buckets with the merge ops. Overflow only raises the device
        flag."""
        out_cap = self._small_cap()
        if self._scan_agg_spec is not None:
            # ONE fused kernel: scan -> filter -> project -> masked-bucket
            # partial, no intermediate column in device memory
            out_keys, results, num_groups, leftover = fused_scan_agg(
                self._scan_agg_spec, batch, min(32, self._slots), out_cap)
            flag = flag | leftover
            part = self._build_small_batch(out_keys, results, num_groups)
        else:
            if self.mode == "final":
                cur, mask = batch, None
                keys, agg_inputs = self._merge_inputs(batch)
            else:
                cur, mask = self._apply_fused(batch)
                cur = eval_projection(self._pre_bound, cur, self._pre_schema)
                keys, agg_inputs = self._update_inputs(cur)
            if not keys:
                results = [("raw", r) for r in masked_reduce(
                    agg_inputs, cur.num_rows, mask, out_cap)]
                part = self._build_small_batch(
                    [], results, torch.ones((), dtype=torch.int32,
                                            device=batch.device))
            else:
                out_keys, results, num_groups, leftover = masked_groupby(
                    keys, agg_inputs, cur.num_rows, cur.capacity, mask,
                    self._slots, self._rounds)
                flag = flag | leftover
                part = self._build_small_batch(out_keys, results, num_groups)

        # fold: concat state + part, re-aggregate with merge ops
        cat_cap = 2 * out_cap
        cols = [concat_columns(a, b, state.num_rows, part.num_rows, cat_cap)
                for a, b in zip(state.columns, part.columns)]
        both = ColumnarBatch(cols, state.num_rows + part.num_rows,
                             self._buffer_schema)
        mkeys, minputs = self._merge_inputs(both)
        if not mkeys:
            mres = [("raw", r) for r in masked_reduce(
                minputs, both.num_rows, None, out_cap)]
            new_state = self._build_small_batch(
                [], mres, torch.ones((), dtype=torch.int32,
                                     device=batch.device))
        else:
            mk, mres, mgroups, mleft = masked_groupby(
                mkeys, minputs, both.num_rows, cat_cap, None,
                self._slots, self._rounds)
            flag = flag | mleft
            new_state = self._build_small_batch(mk, mres, mgroups)
        evaluated = None if self.mode == "partial" \
            else self._evaluate(new_state)
        return new_state, flag, evaluated

    def _evaluate(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Final projection buffers -> results."""
        cols = list(batch.columns[: self._key_count])
        pos = self._key_count
        for i, (fn, _) in enumerate(self.aggregates):
            n_buf = len(fn.merge_ops())
            bufs = list(batch.columns[pos: pos + n_buf])
            input_types = self._input_types[i] \
                if self._input_types is not None else [b.dtype for b in bufs]
            col = fn.evaluate(bufs, input_types)
            cols.append(sanitize(col, batch.num_rows))
            pos += n_buf
        return ColumnarBatch(cols, batch.num_rows, self.output_schema,
                             batch._host_rows)

    # -- exact tier --------------------------------------------------------
    def _run_groupby(self, keys, agg_inputs, batch: ColumnarBatch,
                     row_mask=None) -> ColumnarBatch:
        """Exact group-by of one keys+inputs batch into a keys+buffers
        batch at the batch's capacity (one row for a grand aggregate)."""
        if not keys:
            results = masked_reduce(agg_inputs, batch.num_rows, row_mask,
                                    128)
            return self._build_small_batch(
                [], [("raw", r) for r in results],
                torch.ones((), dtype=torch.int32, device=batch.device))
        out_keys, results, num_groups = masked_groupby_exact(
            keys, agg_inputs, batch.num_rows, batch.capacity, row_mask,
            self._slots, self._rounds)
        return self._build_small_batch(out_keys, results, num_groups)

    def _merge_batch(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Re-aggregate a keys+buffers batch with the merge ops (the JAX
        package's auto path: masked buckets, sort-based when rows are left
        over; the string route without masked buckets)."""
        keys, agg_inputs = self._merge_inputs(batch)
        if self._masked_ok:
            return self._run_groupby(keys, agg_inputs, batch)
        return self._string_route(keys, agg_inputs, batch)

    def _update_and_aggregate(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Exact first pass of one source batch."""
        if self._masked_ok:
            return self._fused_update_exact(batch)
        pre = eval_projection(self._pre_bound, batch, self._pre_schema)
        keys, agg_inputs = self._update_inputs(pre)
        return self._string_route(keys, agg_inputs, pre)

    def _string_route(self, keys, agg_inputs, batch: ColumnarBatch
                      ) -> ColumnarBatch:
        """Group-by without masked buckets: the hash path at 2 rounds, then
        6, then the exact sort path with string lanes that cover the
        longest string key or min/max input. Each hash attempt costs one
        host read of its `leftover` flag."""
        if not keys:
            return self._run_groupby(keys, agg_inputs, batch)
        n, cap = batch.num_rows, batch.capacity
        if self._hash_path_ok:
            for rounds in HASH_ROUNDS:
                out_keys, results, num_groups, leftover = \
                    groupby_aggregate_hash(keys, agg_inputs, n, cap, rounds)
                if not bool(leftover):
                    self.metrics[HASH_ROUTE.format(rounds)].add(1)
                    return self._build_small_batch(out_keys, results,
                                                   num_groups)
        self.metrics[SORT_FALLBACK].add(1)
        out_keys, results, num_groups = groupby_aggregate(
            keys, agg_inputs, n, cap)
        return self._build_small_batch(out_keys, results, num_groups)

    def _fused_update_exact(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Exact tier, one source batch: fused steps -> pre-project ->
        masked buckets with the sort-based fallback."""
        cur, mask = self._apply_fused(batch)
        pre = eval_projection(self._pre_bound, cur, self._pre_schema)
        keys, agg_inputs = self._update_inputs(pre)
        return self._run_groupby(keys, agg_inputs, pre, mask)

    def _concat_merge_pair(self, a: ColumnarBatch, b: ColumnarBatch,
                           cap: int) -> ColumnarBatch:
        """Device-only merge of two keys+buffers partials: concat into one
        `cap`-capacity batch, then re-aggregate. Output groups <=
        a_groups + b_groups <= cap, so this is exact."""
        cols = [concat_columns(ca, cb, a.num_rows, b.num_rows, cap)
                for ca, cb in zip(a.columns, b.columns)]
        both = ColumnarBatch(cols, a.num_rows + b.num_rows,
                             self._buffer_schema)
        return self._merge_batch(both)

    def _tree_merge_device(self, batches: List[ColumnarBatch]
                           ) -> ColumnarBatch:
        """Pairwise merge levels, each pair concatenated into the bucket of
        its capacities and re-aggregated — no host reads."""
        level = list(batches)
        while len(level) > 1:
            nxt = [self._concat_merge_pair(
                level[i], level[i + 1],
                bucket_capacity(level[i].capacity + level[i + 1].capacity))
                for i in range(0, len(level) - 1, 2)]
            if len(level) % 2:
                nxt.append(level[-1])
            level = nxt
        return level[0]

    def _shrink(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Move the groups into the tightest bucket (one host read)."""
        rows = batch.num_rows_host
        small = bucket_capacity(max(rows, 1))
        if small >= batch.capacity:
            return batch
        cols = [slice_rows(c, 0, rows, small) for c in batch.columns]
        return ColumnarBatch(cols, rows, batch.schema)

    #: merge this many partials on the device before one host read shrinks
    #: the running result into a tight bucket
    MERGE_FAN_IN = 8

    #: partials at or above this capacity shrink eagerly (one host read
    #: each) instead of holding full-size buckets in device memory
    SHRINK_THRESHOLD_CAP = 1 << 16

    def _absorb_partial(self, aggregated: List[SpillableBatch],
                        out: ColumnarBatch) -> None:
        """Keep live partials bounded: big partials after the first shrink
        at once (the first is held as it is: a single-batch input pays no
        host read), every partial is held spillable, and every
        MERGE_FAN_IN partials merge into one."""
        if out.capacity >= self.SHRINK_THRESHOLD_CAP and aggregated:
            out = self._shrink(out)
        aggregated.append(SpillableBatch.from_batch(out))
        if len(aggregated) >= self.MERGE_FAN_IN:
            merged = self._shrink(self._merge_all(list(aggregated)))
            aggregated[:] = [SpillableBatch.from_batch(merged)]

    def _merge_all(self, aggregated: List[SpillableBatch]) -> ColumnarBatch:
        """Merge held partials on the device; under OOM the retry
        framework splits the set of partials (a single one by rows) and
        the halves' results merge again (merge ops are associative and
        commutative)."""
        extra_owned: List[SpillableBatch] = []

        def split_set(items: List[SpillableBatch]):
            if len(items) < 2:
                halves = split_in_half_by_rows(items[0])
                extra_owned.extend(halves)
                return [[h] for h in halves]
            half = len(items) // 2
            return [items[:half], items[half:]]

        def do(items: List[SpillableBatch]) -> ColumnarBatch:
            batches: List[ColumnarBatch] = []
            try:
                for s in items:
                    batches.append(s.get_batch())
                if self._masked_ok:
                    return self._tree_merge_device(batches)
                return self._merge_batch(concat_batches(
                    batches, self._buffer_schema))
            finally:
                # an acquire that raised leaves the rest unpinned
                for s in items[:len(batches)]:
                    s.release()

        try:
            outs = list(with_retry(aggregated, do, split_policy=split_set))
        finally:
            for s in aggregated + extra_owned:
                s.close()
        if len(outs) == 1:
            return outs[0]
        return self._merge_all([SpillableBatch.from_batch(b) for b in outs])

    def _execute_exact(self) -> Iterator[ColumnarBatch]:
        agg_time = self.metrics[AGG_TIME]
        aggregated: List[SpillableBatch] = []
        first_pass = self._merge_batch if self.mode == "final" \
            else self._update_and_aggregate
        try:
            with agg_time.ns_timer():
                for batch in self._source.execute():
                    for out in run_spillable(batch, first_pass):
                        self._absorb_partial(aggregated, out)
                if not aggregated:
                    if self.group_exprs or self.mode == "partial":
                        return  # no input, no groups
                    # a grand aggregate over empty input emits one row
                    if self.mode == "final":
                        yield self._evaluate(self._merge_batch(empty_batch(
                            self._buffer_schema, device=self.device)))
                        return
                    empty = empty_batch(self._source.output_schema,
                                        device=self._source.device)
                    yield self._evaluate(self._fused_update_exact(empty))
                    return
                if len(aggregated) == 1:
                    # a single partial already has unique keys
                    only = aggregated.pop()
                    merged = only.get_batch()
                    only.release()
                    only.close()
                else:
                    merged = self._merge_all(aggregated)
                    aggregated.clear()
            yield merged if self.mode == "partial" \
                else self._evaluate(merged)
        finally:
            for s in aggregated:
                s.close()

    # -- drive -------------------------------------------------------------
    def encoded_inputs(self) -> Sequence[TpuExec]:
        # the absorbed chain reads the source's batches directly
        return [self._source]

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        if self._masked_ok and self._spec_enabled and speculation_allowed():
            yield from self._execute_speculative()
        else:
            yield from self._execute_exact()

    def _execute_speculative(self) -> Iterator[ColumnarBatch]:
        """One step per source batch folds into an O(1)-size device state;
        the overflow flag is recorded with the active scope, never read
        here. A split input's halves fold one after the other; a retried
        step starts again from the state before it."""
        agg_time = self.metrics[AGG_TIME]
        state = flag = evaluated = None
        with agg_time.ns_timer():
            for batch in self._source.execute():
                if state is None:
                    state = empty_batch(self._buffer_schema,
                                        capacity=self._small_cap(),
                                        device=batch.device)
                    flag = torch.zeros((), dtype=torch.bool,
                                       device=batch.device)
                box = [state, flag, None]
                for out in run_spillable(batch, lambda b: self._streaming_step(
                        b, box[0], box[1])):
                    box[:] = out
                state, flag, evaluated = box
        if state is None:
            # no input: the exact tier gives the empty result (no groups,
            # or the one row of a grand aggregate)
            yield from self._execute_exact()
            return
        current_scope().record(flag)
        yield state if self.mode == "partial" else evaluated
