"""GenerateExec — explode and posexplode over a list or map column, outer
or not: the counterpart of spark_rapids_tpu/exec/generate.py (reference
GpuGenerateExec.scala:829 and its GpuExplode/GpuPosExplode generators).
A map explodes into (key, value) columns.

The output capacity is the list child's capacity bucket (every element
is at most one row) plus the input capacity for the outer variant. A
batch whose columns include strings or lists first measures each one's
payload need (explode repeats a row once per element: the input's byte
and element buckets would overflow), one host read a batch (the
`measureHostReads` metric). The payload columns then move by one gather
of the batch (ops/gather.gather_batch_columns: the fixed-width ones in
one packed row gather), the elements by one gather of the child (a map's
keys and values by one gather each).
"""

from __future__ import annotations

from typing import Iterator

import torch

from ..columnar.batch import ColumnarBatch
from ..columnar.column import (ArrayColumn, Column, MapColumn,
                               StringColumn, StructColumn, bucket_capacity)
from ..expr.core import Expression, resolve
from ..ops.basic import active_mask, compaction_order, gather_column
from ..ops.collection import array_lengths, row_of_element
from ..ops.gather import gather_batch_columns
from ..ops.strings import string_lengths
from ..types import ArrayType, IntegerType, MapType, Schema, StructField
from .base import TpuExec

#: host reads of the payload measurement, one a batch with varlen columns
MEASURE_HOST_READS = "measureHostReads"


def _varlen(c) -> bool:
    """A payload column whose rows vary in size."""
    from ..ops.join import is_varsize
    return isinstance(c, MapColumn) or is_varsize(c)


def _string_sides(c):
    """The string children of a list or map column."""
    sides = (c.child,) if isinstance(c, ArrayColumn) else (c.keys, c.values)
    return [s for s in sides if isinstance(s, StringColumn)]


class GenerateExec(TpuExec):
    def __init__(self, generator: Expression, child: TpuExec,
                 outer: bool = False, position: bool = False,
                 elem_name: str = "col", pos_name: str = "pos"):
        super().__init__(child)
        self.generator = generator
        self.outer = outer
        self.position = position
        self.elem_name = elem_name
        self.pos_name = pos_name
        self._bound = resolve(generator, child.output_schema)
        arr_t = self._bound.data_type
        self._is_map = isinstance(arr_t, MapType)
        if self._is_map:
            self._key_type = arr_t.key_type
            self._elem_type = arr_t.value_type
        elif isinstance(arr_t, ArrayType):
            self._elem_type = arr_t.element_type
        else:
            raise TypeError(f"explode needs an ARRAY or MAP input, got "
                            f"{arr_t}")

    @property
    def output_schema(self) -> Schema:
        fields = list(self.child.output_schema.fields)
        if self.position:
            fields.append(StructField(self.pos_name, IntegerType(),
                                      self.outer))
        if self._is_map:
            fields.append(StructField("key", self._key_type, self.outer))
            fields.append(StructField("value", self._elem_type, True))
        else:
            fields.append(StructField(self.elem_name, self._elem_type,
                                      True))
        return Schema(tuple(fields))

    def additional_metrics(self):
        return (MEASURE_HOST_READS,)

    def _copies(self, batch: ColumnarBatch, arr: ArrayColumn):
        """Per input row: how many output rows repeat it."""
        lens = array_lengths(arr).to(torch.int64)
        act = active_mask(batch.num_rows, batch.capacity, batch.device)
        copies = torch.where(act & arr.validity, lens, 0)
        if self.outer:
            empty = act & ((lens == 0) | ~arr.validity)
            copies = copies + empty.to(torch.int64)
        return copies, act

    def _payload_caps(self, batch: ColumnarBatch, arr: ArrayColumn) -> tuple:
        """The output bucket of each varlen payload column (None for the
        others): string bytes; list elements (with their child bytes for
        a list of strings); a map's entries with its key and value bytes
        where they are strings; a struct's one bucket over its string
        fields, from one host read of the exact needs."""
        if not any(_varlen(c) for c in batch.columns):
            return (None,) * len(batch.columns)
        copies, act = self._copies(batch, arr)

        def need(x):
            return torch.sum(copies * torch.where(act, x, 0).to(torch.int64))

        def span_bytes(side, offsets):
            # each row's byte span of a string child
            return side.offsets[offsets[1:].long()] \
                - side.offsets[offsets[:-1].long()]
        needs = []
        for c in batch.columns:
            if isinstance(c, StringColumn):
                needs.append(need(string_lengths(c)))
            elif isinstance(c, (ArrayColumn, MapColumn)):
                needs.append(need(array_lengths(c)))
                for side in _string_sides(c):
                    needs.append(need(span_bytes(side, c.offsets)))
            elif isinstance(c, StructColumn) and _varlen(c):
                from ..ops.join import var_lengths
                needs.append(need(var_lengths(c)))
        self.metrics[MEASURE_HOST_READS].add(1)
        fetched = iter(torch.stack(needs).tolist())

        def bucket():
            return bucket_capacity(max(next(fetched), 8))
        caps = []
        for c in batch.columns:
            if isinstance(c, StringColumn) \
                    or (isinstance(c, StructColumn) and _varlen(c)):
                caps.append(bucket())
            elif isinstance(c, ArrayColumn):
                elems = bucket()
                caps.append((elems, bucket())
                            if isinstance(c.child, StringColumn) else elems)
            elif isinstance(c, MapColumn):
                elems = bucket()
                kb = bucket() if isinstance(c.keys, StringColumn) else None
                vb = bucket() if isinstance(c.values, StringColumn) \
                    else None
                caps.append((elems, kb, vb))
            else:
                caps.append(None)
        return tuple(caps)

    def _explode(self, batch: ColumnarBatch) -> ColumnarBatch:
        arr = self._bound.columnar_eval(batch)
        map_col = None
        if isinstance(arr, MapColumn):
            from ..ops.maps import map_keys
            map_col, arr = arr, map_keys(arr)  # the offsets' vehicle
        caps = self._payload_caps(batch, arr)
        cap = batch.capacity
        dev = batch.device
        child_cap = arr.child_capacity
        lens = array_lengths(arr)
        act_rows = active_mask(batch.num_rows, cap, dev)
        # the elements to emit: inside the span of an ACTIVE, NON-NULL row
        # (a computed array holds element slots for the other rows too)
        e_all = torch.arange(child_cap, dtype=torch.int32, device=dev)
        row_all = row_of_element(arr.offsets, e_all, cap)
        keep = (e_all < arr.offsets[-1]) & act_rows[row_all] \
            & arr.validity[row_all]
        perm, total = compaction_order(keep, child_cap)
        out_cap = bucket_capacity(child_cap + (cap if self.outer else 0))
        slots = torch.arange(out_cap, dtype=torch.int32, device=dev)
        e = torch.clamp(perm[torch.clamp(slots, 0, child_cap - 1).long()],
                        0, child_cap - 1)
        src_row_of_elem = row_all[e.long()]
        intra = e - arr.offsets[src_row_of_elem]
        is_elem = slots < total
        if self.outer:
            empty = act_rows & ((lens == 0) | ~arr.validity)
            empty_perm, n_empty = compaction_order(empty, batch.num_rows)
            k = torch.clamp(slots - total, 0, cap - 1).long()
            outer_row = torch.where((slots >= total)
                                    & (slots < total + n_empty),
                                    empty_perm[k], -1)
            n_out = total + n_empty
        else:
            outer_row = torch.full((out_cap,), -1, dtype=torch.int32,
                                   device=dev)
            n_out = total
        act_out = active_mask(n_out, out_cap, dev)
        src_row = torch.where(is_elem, src_row_of_elem.to(torch.int32),
                              outer_row)
        src_row = torch.where(act_out, src_row, -1)
        cols = gather_batch_columns(batch.columns, src_row, byte_caps=caps)
        if self.position:
            pos_valid = is_elem & act_out
            cols.append(Column(torch.where(pos_valid, intra, 0),
                               pos_valid if self.outer else act_out,
                               IntegerType()))
        elem_idx = torch.where(is_elem & act_out, e, -1)
        if map_col is not None:
            cols.append(gather_column(map_col.keys, elem_idx))
            cols.append(gather_column(map_col.values, elem_idx))
        else:
            cols.append(gather_column(arr.child, elem_idx))
        return ColumnarBatch(cols, n_out, self.output_schema)

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute():
            yield self._explode(batch)

    def node_description(self):
        kind = "PosExplode" if self.position else "Explode"
        return (f"GenerateExec[{kind}{'Outer' if self.outer else ''}"
                f"({self.generator!r})]")
