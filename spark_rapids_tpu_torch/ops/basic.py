"""Core row-layout ops — the counterpart of spark_rapids_tpu/ops/basic.py.

Conventions carried over from the JAX package:
  * shapes stay at the capacity bucket while the row count lives in a
    device scalar, so no op here synchronises with the host;
  * rows with index >= num_rows are "inactive": validity False, data zero
    (a DictionaryColumn's code NULL_CODE); a dictionary column's gathers
    move its codes only, and its dictionary rides along untouched;
  * a StringColumn gathers through ops/strings.gather_string, into the
    caller's byte capacity;
  * a Decimal128Column moves its two limbs as two more 8-byte lanes of
    the packed row gather (ops/gather.py), never on its own;
  * an ArrayColumn gathers and concatenates its offsets' element spans
    (ops/collection.py), its child by the child's own path;
  * a StructColumn moves each child by the child's own path beside its
    validity (ops/gather.py packs its fixed-width children into the
    packed row gather), a MapColumn its keys and values as two lists
    over one offsets.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..columnar.column import (ArrayColumn, Column, Decimal128Column,
                               MapColumn, StringColumn, StructColumn)
from ..columnar.encoded import NULL_CODE, DictionaryColumn


def active_mask(num_rows, capacity: int, device=None) -> torch.Tensor:
    """Bool (capacity,): True for logical rows."""
    if isinstance(num_rows, torch.Tensor):
        device = num_rows.device
    return torch.arange(capacity, dtype=torch.int32, device=device) < num_rows


def sanitize(col: Column, num_rows) -> Column:
    """Force the inactive tail to (zero, invalid) so padded slots never leak."""
    act = active_mask(num_rows, col.capacity, col.device)
    if isinstance(col, DictionaryColumn):
        codes = torch.where(act, col.codes, NULL_CODE)
        return DictionaryColumn(codes, col.dict_data, col.dict_offsets,
                                col.validity & act, col.dtype)
    if isinstance(col, StringColumn):
        return StringColumn(col.data, col.offsets, col.validity & act,
                            col.dtype)
    if isinstance(col, ArrayColumn):
        return ArrayColumn(col.child, col.offsets, col.validity & act,
                           col.dtype)
    if isinstance(col, StructColumn):
        return StructColumn([sanitize(k, num_rows) for k in col.children],
                            col.validity & act, col.dtype)
    if isinstance(col, MapColumn):
        return MapColumn(col.keys, col.values, col.offsets,
                         col.validity & act, col.dtype)
    if isinstance(col, Decimal128Column):
        zero = torch.zeros((), dtype=torch.int64, device=col.device)
        return Decimal128Column.from_limbs(
            torch.where(act, col.hi.data, zero),
            torch.where(act, col.lo.data, zero), col.validity & act,
            col.dtype)
    data = torch.where(act, col.data, torch.zeros_like(col.data))
    return Column(data, col.validity & act, col.dtype)


def concat_columns(a: Column, b: Column, a_rows, b_rows,
                   out_capacity: int) -> Column:
    """Concatenate two columns' active rows (the coalesce primitive).

    out_capacity must be >= a_rows + b_rows in the worst case. Two
    dictionary columns concatenate only as views of one dictionary;
    distinct dictionaries are decoded first (`materialize_batch`)."""
    if isinstance(a, StringColumn):
        from .strings import concat_string
        return concat_string(a, b, a_rows, b_rows, out_capacity)
    if isinstance(a, ArrayColumn):
        from .collection import concat_arrays
        return concat_arrays(a, b, a_rows, b_rows, out_capacity)
    if isinstance(a, MapColumn):
        from .maps import map_keys, map_values
        from .collection import concat_arrays
        ck = concat_arrays(map_keys(a), map_keys(b), a_rows, b_rows,
                           out_capacity)
        cv = concat_arrays(map_values(a), map_values(b), a_rows, b_rows,
                           out_capacity)
        return MapColumn(ck.child, cv.child, ck.offsets, ck.validity,
                         a.dtype)
    idx = torch.arange(out_capacity, dtype=torch.int32, device=a.device)
    from_b = idx >= a_rows
    b_idx = idx - a_rows
    out_valid = idx < a_rows + b_rows

    def cat(x, y):
        x_safe = torch.where(idx < x.shape[0], idx, 0).long()
        y_safe = torch.clamp(b_idx, 0, y.shape[0] - 1).long()
        return torch.where(from_b, y[y_safe], x[x_safe])

    if isinstance(a, StructColumn):
        return StructColumn(
            [concat_columns(x, y, a_rows, b_rows, out_capacity)
             for x, y in zip(a.children, b.children)],
            cat(a.validity, b.validity) & out_valid, a.dtype)
    if isinstance(a, Decimal128Column):
        valid = cat(a.validity, b.validity) & out_valid
        zero = torch.zeros((), dtype=torch.int64, device=a.device)
        return Decimal128Column.from_limbs(
            torch.where(valid, cat(a.hi.data, b.hi.data), zero),
            torch.where(valid, cat(a.lo.data, b.lo.data), zero), valid,
            a.dtype)
    if isinstance(a, DictionaryColumn):
        if not (isinstance(b, DictionaryColumn)
                and a.dict_data is b.dict_data
                and a.dict_offsets is b.dict_offsets):
            raise ValueError("concat of distinct dictionaries: "
                             "materialize first")
        valid = cat(a.validity, b.validity) & out_valid
        codes = torch.where(out_valid, cat(a.codes, b.codes), NULL_CODE)
        return DictionaryColumn(codes, a.dict_data, a.dict_offsets, valid,
                                a.dtype)
    data = cat(a.data, b.data)
    valid = cat(a.validity, b.validity) & out_valid
    data = torch.where(out_valid, data, torch.zeros_like(data))
    return Column(data, valid, a.dtype)


def with_validity(col: Column, validity: torch.Tensor) -> Column:
    """`col` with `validity` in place of its own; its data, children,
    offsets and dictionary are shared (a struct's and a decimal's children
    keep their own validity)."""
    if isinstance(col, DictionaryColumn):
        return DictionaryColumn(col.codes, col.dict_data, col.dict_offsets,
                                validity, col.dtype)
    if isinstance(col, StringColumn):
        return StringColumn(col.data, col.offsets, validity, col.dtype)
    if isinstance(col, (Decimal128Column, StructColumn)):
        return type(col)(col.children, validity, col.dtype)
    if isinstance(col, ArrayColumn):
        return ArrayColumn(col.child, col.offsets, validity, col.dtype)
    if isinstance(col, MapColumn):
        return MapColumn(col.keys, col.values, col.offsets, validity,
                         col.dtype)
    return Column(col.data, validity, col.dtype)


def gather_column(col: Column, indices: torch.Tensor, out_valid=None,
                  out_byte_capacity=None) -> Column:
    """Gather rows by int32 indices; the index length is the output
    capacity. `out_valid` masks output rows; out-of-range indices give
    invalid rows. `out_byte_capacity` is a string column's output byte
    bucket (default: its input's), or a list column's element bucket (an
    (elements, bytes) pair for string elements), or a map's (entries,
    key bytes or None, value bytes or None); a struct passes it to each
    child."""
    if isinstance(col, StructColumn):
        in_range = (indices >= 0) & (indices < col.capacity)
        safe = torch.where(in_range, indices, 0).long()
        valid = col.validity[safe] & in_range
        if out_valid is not None:
            valid = valid & out_valid
        return StructColumn(
            [gather_column(k, indices, out_valid, out_byte_capacity)
             for k in col.children], valid, col.dtype)
    if isinstance(col, Decimal128Column):
        from .gather import gather_batch_columns
        midx = indices if out_valid is None \
            else torch.where(out_valid, indices, -1)
        return gather_batch_columns([col], midx)[0]
    from .gather import record
    encoded = isinstance(col, DictionaryColumn)
    record(1, nbytes=indices.shape[0]
           * (col.data.element_size() if type(col) is Column else 4))
    in_range = (indices >= 0) & (indices < col.capacity)
    safe = torch.where(in_range, indices, torch.zeros_like(indices)).long()
    valid = col.validity[safe] & in_range
    if out_valid is not None:
        valid = valid & out_valid
    if encoded:
        codes = torch.where(valid, col.codes[safe], NULL_CODE)
        return DictionaryColumn(codes, col.dict_data, col.dict_offsets,
                                valid, col.dtype)
    if isinstance(col, StringColumn):
        from .strings import gather_string
        return gather_string(col, safe, valid, out_byte_capacity)
    if isinstance(col, ArrayColumn):
        from .collection import gather_array
        return gather_array(col, safe, valid, out_byte_capacity)
    if isinstance(col, MapColumn):
        return _gather_map(col, safe, valid, out_byte_capacity)
    data = torch.where(valid, col.data[safe],
                       torch.zeros((), dtype=col.data.dtype,
                                   device=col.device))
    return Column(data, valid, col.dtype)


def _gather_map(col: MapColumn, safe, valid, caps) -> MapColumn:
    """A map's rows as its keys' and values' lists gathered by one index
    (the JAX package's formulation); a duplicating gather passes
    (entries, key bytes, value bytes)."""
    from .collection import gather_array
    from .maps import map_keys, map_values
    if isinstance(caps, tuple):
        elems, kb, vb = caps
        kcap = (elems, kb) if kb is not None else elems
        vcap = (elems, vb) if vb is not None else elems
    else:
        kcap = vcap = caps
    gk = gather_array(map_keys(col), safe, valid, kcap)
    gv = gather_array(map_values(col), safe, valid, vcap)
    return MapColumn(gk.child, gv.child, gk.offsets, valid, col.dtype)


def compaction_order(keep: torch.Tensor, num_rows):
    """Stable permutation (int32) moving kept active rows to the front, and
    the kept count: the engine's copy_if. Slots >= the count hold the
    DROPPED rows' indices: every caller masks the tail (or uses
    masked_compaction_order)."""
    cap = keep.shape[0]
    k = keep & active_mask(num_rows, cap, keep.device)
    _, perm = torch.sort((~k).to(torch.int32), stable=True)
    return perm.to(torch.int32), k.sum(dtype=torch.int32)


def masked_compaction_order(keep: torch.Tensor, num_rows):
    """compaction_order with the tail slots (>= the kept count) set to -1,
    so an unmasked gather yields invalid rows."""
    perm, new_rows = compaction_order(keep, num_rows)
    out_valid = active_mask(new_rows, keep.shape[0])
    return torch.where(out_valid, perm, -1), new_rows


def compact_columns(columns: Sequence[Column], keep: torch.Tensor, num_rows
                    ) -> Tuple[Tuple[Column, ...], torch.Tensor]:
    """Filter: keep rows where `keep` is True (the caller has AND-ed
    validity into it). The kept rows move to the front through the gather
    engine: two or more fixed-width columns ride one packed row gather,
    a dictionary column's codes the per-column path."""
    from .gather import gather_batch_columns
    perm, new_rows = compaction_order(keep, num_rows)
    out_valid = active_mask(new_rows, keep.shape[0])
    out = gather_batch_columns(columns, perm, out_valid=out_valid)
    return tuple(out), new_rows


def slice_rows(col: Column, start, length, out_capacity: int) -> Column:
    """Rows [start, start+length) moved to the front of a fresh column."""
    pos = torch.arange(out_capacity, dtype=torch.int32, device=col.device)
    return gather_column(col, pos + start, pos < length)
