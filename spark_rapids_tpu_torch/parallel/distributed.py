"""Distributed query steps over the mesh — the counterpart of
spark_rapids_tpu/parallel/distributed.py (the reference's UCX shuffle
under the partial/final aggregate, GpuShuffleExchangeExecBase.scala:277
with GpuAggregateExec's partial/final modes).

The JAX package stacks the shards' batches along a leading device axis
and runs one SPMD program over the mesh. The port's "stacked" form is
the list of the shards' batches, each on its shard's device, aligned to
one row capacity and one byte capacity per string column
(`stack_batches`); a step runs each shard's local work in turn, with the
all-to-all between (parallel/exchange.exchange_columns).

`make_distributed_groupby` builds the group-by step: each shard's local
partial aggregate (ops/aggregate.groupby_aggregate), the exchange on the
group keys, each shard's final merge. String keys cross as fixed-width
lanes of `string_width` bytes: a longer key would be cut, so the step
reads the longest key once on the host and raises past the width
(`required_string_width` sizes it).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, StringColumn
from ..types import DataType, Schema
from .exchange import exchange_columns, string_columns
from .mesh import DATA_AXIS, Mesh, mesh_axis_size

__all__ = ["stack_batches", "unstack_batches", "required_string_width",
           "make_distributed_groupby", "batch_to_device"]


def batch_to_device(batch: ColumnarBatch, device) -> ColumnarBatch:
    """`batch` on `device` (itself when it is there already)."""
    device = torch.device(device)
    if batch.device == device:
        return batch
    leaves, treedef = batch.flatten()
    return ColumnarBatch.unflatten(
        treedef, [t.to(device, non_blocking=True) for t in leaves])


def _with_byte_capacity(col: StringColumn, byte_cap: int) -> StringColumn:
    if col.byte_capacity == byte_cap:
        return col
    pad = torch.zeros(byte_cap - col.byte_capacity, dtype=torch.uint8,
                      device=col.device)
    return StringColumn(torch.cat([col.data, pad]), col.offsets,
                        col.validity, col.dtype)


def stack_batches(batches: Sequence[ColumnarBatch]) -> List[ColumnarBatch]:
    """The shards' batches aligned to one row capacity (the largest) and,
    per string column, one byte capacity: the port's counterpart of the
    JAX package's stacked batch."""
    cap = max(b.capacity for b in batches)
    byte_caps = {}
    for b in batches:
        for i, c in enumerate(b.columns):
            if isinstance(c, StringColumn):
                byte_caps[i] = max(byte_caps.get(i, 0), c.byte_capacity)
    out = []
    for b in batches:
        cols = []
        for i, c in enumerate(b.columns):
            c = c.with_capacity(cap)
            if isinstance(c, StringColumn):
                c = _with_byte_capacity(c, byte_caps[i])
            cols.append(c)
        out.append(ColumnarBatch(cols, b.num_rows, b.schema, b._host_rows))
    return out


def unstack_batches(stacked: Sequence[ColumnarBatch],
                    n: int) -> List[ColumnarBatch]:
    return list(stacked[:n])


def _max_string_length(batches: Sequence[ColumnarBatch]) -> int:
    """The longest string of the batches' string columns, a struct's
    string children included, in one host read (0 without a string
    column)."""
    maxima = [torch.max(c.offsets[1:] - c.offsets[:-1]).to("cpu",
                                                             non_blocking=True)
              for b in batches for c in string_columns(b.columns)
              if c.capacity]
    if not maxima:
        return 0
    if any(m.device.type != "cpu" for m in maxima):
        torch.cuda.synchronize()
    return int(torch.stack(maxima).max())


def required_string_width(batches: Sequence[ColumnarBatch]) -> int:
    """The fixed-width byte size that exchanges these batches' string
    columns whole: the longest string rounded up to 8 (at least 8). The
    padded lane cuts a longer string."""
    return max(8, (_max_string_length(batches) + 7) // 8 * 8)


def _as_column(result, bt: DataType) -> Column:
    if result[0] == "col":
        return result[1]
    data, valid = result[1]
    return Column(data.to(bt.torch_dtype), valid, bt)


def make_distributed_groupby(mesh: Mesh, key_count: int,
                             update_inputs: Sequence[Tuple[str, int]],
                             merge_ops: Sequence[str],
                             buffer_types: Sequence[DataType],
                             out_schema: Schema, string_words: int = 4,
                             string_width: int = 64,
                             axis_name: str = DATA_AXIS
                             ) -> Callable[[Sequence[ColumnarBatch]],
                                           List[ColumnarBatch]]:
    """The group-by step over the mesh. update_inputs: (op, ordinal in
    the local batch; -1 for count_star) per buffer; merge_ops and
    buffer_types: one per buffer. The step takes the shards' batches (the
    keys first) and returns each shard's aggregated batch, holding the
    groups of its hash partition."""
    from ..ops.aggregate import groupby_aggregate
    n = mesh_axis_size(mesh, axis_name)
    devs = mesh.shard_devices
    # the sort lanes must cover the exchanged width for exact grouping
    string_words = max(string_words, string_width // 8)

    def step(batches: Sequence[ColumnarBatch]) -> List[ColumnarBatch]:
        if len(batches) != n:
            raise ValueError(f"{len(batches)} batches for {n} shards")
        longest = _max_string_length(batches)
        if longest > string_width:
            raise ValueError(
                f"string key of {longest} bytes exceeds the exchange width "
                f"{string_width}; size it with required_string_width("
                f"batches)")
        local = stack_batches([batch_to_device(b, devs[d])
                               for d, b in enumerate(batches)])
        cap = local[0].capacity
        partials, groups = [], []
        for b in local:
            keys = list(b.columns[:key_count])
            inputs = [(op, b.columns[o] if o >= 0 else None)
                      for op, o in update_inputs]
            pkeys, presults, pgroups = groupby_aggregate(
                keys, inputs, b.num_rows, cap, string_words)
            partials.append(list(pkeys) + [
                _as_column(r, bt) for r, bt in zip(presults, buffer_types)])
            groups.append(pgroups)
        recv, n_recv = exchange_columns(
            partials, list(range(key_count)), groups, cap, mesh, n,
            string_width=string_width)
        out = []
        for cols, rows in zip(recv, n_recv):
            fkeys, fresults, fgroups = groupby_aggregate(
                cols[:key_count], list(zip(merge_ops, cols[key_count:])),
                rows, cols[0].capacity, string_words)
            out.append(ColumnarBatch(list(fkeys) + [
                _as_column(r, bt) for r, bt in zip(fresults, buffer_types)],
                fgroups, out_schema))
        return out

    return step
