"""AggregateExec in complete mode — the counterpart of
spark_rapids_tpu/exec/aggregate.py on its speculative streaming tier.

Flow per source batch (`_streaming_step`, one step per batch, no host
synchronisation):
  1. the absorbed filter/project chain and the pre-projection
     [group keys..., agg inputs...] run inside the fused scan-aggregate
     kernel (ops/fused_scan_agg.py) when the chain compiles to a spec;
     otherwise they run as torch ops feeding ops/maskedagg.masked_groupby;
  2. the small masked-bucket partial folds into an O(1)-size device state
     (concat + masked_groupby with the merge ops);
  3. dirty buckets raise a device-side speculation flag, recorded with
     the active speculation scope and read once with the results.

Not ported yet: the exact tier (sort-based group-by and the in-program
fallback), partial/final modes, spill and retry. Outside a speculation
scope the exec raises rather than run a tier that does not exist.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import torch

from ..columnar.batch import ColumnarBatch, empty_batch
from ..columnar.column import Column, bucket_capacity
from ..expr.aggexprs import AggregateFunction
from ..expr.core import Expression
from ..ops.basic import concat_columns, sanitize
from ..ops.fused_scan_agg import compile_scan_agg_spec, fused_scan_agg
from ..ops.maskedagg import masked_groupby, masked_reduce
from ..types import Schema, StructField
from .base import AGG_TIME, TpuExec
from .basic import bind_projection, eval_projection, projection_schema
from .speculation import current_scope, speculation_allowed

#: buckets per round and rounds of the masked-bucket group-by (the JAX
#: package's defaults for the same settings)
GROUP_SLOTS = 32
ROUNDS = 2


def _result_column(data, valid, dtype) -> Column:
    return Column(data.to(dtype.torch_dtype), valid, dtype)


class AggregateExec(TpuExec):
    def __init__(self, group_exprs: Sequence[Expression],
                 aggregates: Sequence[Tuple[AggregateFunction, str]],
                 child: TpuExec):
        super().__init__(child)
        self.group_exprs = list(group_exprs)
        self.aggregates = list(aggregates)
        in_schema = child.output_schema
        self._slots = GROUP_SLOTS
        self._rounds = ROUNDS

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
        self._key_count = len(group_exprs)
        self._input_types = [
            [self._pre_schema.fields[s].data_type for s in slots]
            for slots in self._input_slots]
        self._buffer_schema = self._make_buffer_schema()

        # whole-stage fusion: inline the upstream filter/project chain
        # into this operator's per-batch step
        steps, node = [], child
        while hasattr(node, "fused_step"):
            steps.append(node.fused_step())
            node = node.child
        self._fused_steps = list(reversed(steps))
        self._source: TpuExec = node

        # the fused scan-aggregate kernel, when every absorbed expression
        # is in its whitelist
        self._scan_agg_spec = None
        if self.group_exprs:
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

    @property
    def output_schema(self) -> Schema:
        key_fields = list(self._buffer_schema.fields[: self._key_count])
        agg_fields = [StructField(name, fn.result_type(self._input_types[i]))
                      for i, (fn, name) in enumerate(self.aggregates)]
        return Schema(tuple(key_fields + agg_fields))

    def additional_metrics(self):
        return (AGG_TIME,)

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
            data, valid = r[1]
            cols.append(_result_column(data, valid, f.data_type))
        return ColumnarBatch(cols, num_groups, self._buffer_schema)

    def _streaming_step(self, batch: ColumnarBatch, state: ColumnarBatch,
                        flag: torch.Tensor):
        """One step per source batch: fused chain -> masked-bucket partial
        -> fold into the O(1) running state -> evaluate. Overflow only
        raises the device flag."""
        out_cap = self._small_cap()
        if self._scan_agg_spec is not None:
            # ONE fused kernel: scan -> filter -> project -> masked-bucket
            # partial, no intermediate column in device memory
            out_keys, results, num_groups, leftover = fused_scan_agg(
                self._scan_agg_spec, batch, min(32, self._slots), out_cap)
            flag = flag | leftover
            part = self._build_small_batch(out_keys, results, num_groups)
        else:
            cur, mask = self._apply_fused(batch)
            pre = eval_projection(self._pre_bound, cur, self._pre_schema)
            keys, agg_inputs = self._update_inputs(pre)
            if not keys:
                results = [("raw", r) for r in masked_reduce(
                    agg_inputs, pre.num_rows, mask, out_cap)]
                part = self._build_small_batch(
                    [], results, torch.ones((), dtype=torch.int32,
                                            device=batch.device))
            else:
                out_keys, results, num_groups, leftover = masked_groupby(
                    keys, agg_inputs, pre.num_rows, pre.capacity, mask,
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
        return new_state, flag, self._evaluate(new_state)

    def _evaluate(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Final projection buffers -> results."""
        cols = list(batch.columns[: self._key_count])
        pos = self._key_count
        for i, (fn, _) in enumerate(self.aggregates):
            n_buf = len(fn.merge_ops())
            bufs = list(batch.columns[pos: pos + n_buf])
            col = fn.evaluate(bufs, self._input_types[i])
            cols.append(sanitize(col, batch.num_rows))
            pos += n_buf
        return ColumnarBatch(cols, batch.num_rows, self.output_schema,
                             batch._host_rows)

    # -- drive -------------------------------------------------------------
    def internal_execute(self) -> Iterator[ColumnarBatch]:
        if not speculation_allowed():
            raise NotImplementedError(
                "the exact aggregation tier is not ported: run the plan "
                "under exec.speculation.speculation_scope()")
        yield from self._execute_speculative()

    def _execute_speculative(self) -> Iterator[ColumnarBatch]:
        """One step per source batch folds into an O(1)-size device state;
        the overflow flag is recorded with the active scope, never read
        here."""
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
                state, flag, evaluated = self._streaming_step(
                    batch, state, flag)
        if state is None:
            if self.group_exprs:
                return  # no input, no groups
            raise NotImplementedError(
                "a grand aggregate over empty input needs the exact tier")
        current_scope().record(flag)
        yield evaluated
