"""Varlen (string/binary) ops over the (offsets, bytes) layout — the
counterpart of spark_rapids_tpu/ops/strings.py, as far as late
materialization and string keys need it: the row gather that decodes a
dictionary column, the concat of decoded build batches, and row-wise
string equality.

The gather and the concat are dense: for each byte, `torch.searchsorted`
on the offsets finds its row, so a row gather of strings is two gathers
over a static byte capacity (the caller's `out_byte_capacity`). Equality
compares byte spans through columnar/encoded._bytes_equal_spans, the
comparator that the join's verify and the hash group-by share.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..columnar.column import Column, StringColumn
from ..types import BOOLEAN


def string_lengths(col: StringColumn) -> torch.Tensor:
    """int32 (capacity,): byte length per row (0 for inactive rows)."""
    return col.offsets[1:] - col.offsets[:-1]


def _rebuild_offsets(lengths: torch.Tensor) -> torch.Tensor:
    """Exclusive scan of int32 lengths into (capacity + 1,) offsets."""
    return torch.cat([lengths.new_zeros(1),
                      torch.cumsum(lengths, 0, dtype=torch.int32)])


def _row_of_byte(offsets: torch.Tensor, byte_cap: int, rows: int):
    """(row, intra-row position) of each output byte: the last row whose
    start offset is <= the byte's position."""
    pos = torch.arange(byte_cap, dtype=torch.int32, device=offsets.device)
    row = torch.searchsorted(offsets, pos, right=True).to(torch.int32) - 1
    row = torch.clamp(row, 0, rows - 1)
    return pos, row, pos - offsets[row.long()]


def gather_string(col: StringColumn, indices: torch.Tensor,
                  out_valid: torch.Tensor,
                  out_byte_capacity: Optional[int] = None) -> StringColumn:
    """Gather rows of a string column by pre-clamped int32 `indices`.

    out_byte_capacity: the result's byte bucket. Defaults to the input's
    (enough for any permutation or filter; gathers that duplicate rows
    pass a larger one)."""
    byte_cap = out_byte_capacity or col.byte_capacity
    idx = indices.long()
    lengths = torch.where(out_valid, string_lengths(col)[idx], 0)
    new_offsets = _rebuild_offsets(lengths)
    src_starts = col.offsets[idx]
    pos, row, intra = _row_of_byte(new_offsets, byte_cap, indices.shape[0])
    src_pos = src_starts[row.long()] + intra
    in_use = pos < new_offsets[-1]
    src_pos = torch.where(in_use,
                          torch.clamp(src_pos, 0, col.byte_capacity - 1), 0)
    data = torch.where(in_use, col.data[src_pos.long()], 0).to(torch.uint8)
    return StringColumn(data, new_offsets, out_valid, col.dtype)


def concat_string(a: StringColumn, b: StringColumn, a_rows, b_rows,
                  out_capacity: int,
                  out_byte_capacity: Optional[int] = None) -> StringColumn:
    """Concatenate the active rows of two string columns."""
    byte_cap = out_byte_capacity or (a.byte_capacity + b.byte_capacity)
    idx = torch.arange(out_capacity, dtype=torch.int32, device=a.device)
    from_b = idx >= a_rows
    out_valid_slot = idx < a_rows + b_rows
    a_idx = torch.where(idx < a.capacity, idx, 0).long()
    b_idx = torch.clamp(idx - a_rows, 0, b.capacity - 1).long()
    lengths = torch.where(from_b, string_lengths(b)[b_idx],
                          string_lengths(a)[a_idx])
    lengths = torch.where(out_valid_slot, lengths, 0)
    validity = torch.where(from_b, b.validity[b_idx], a.validity[a_idx]) \
        & out_valid_slot
    new_offsets = _rebuild_offsets(lengths)
    src_starts = torch.where(from_b, b.offsets[b_idx], a.offsets[a_idx])
    pos, row, intra = _row_of_byte(new_offsets, byte_cap, out_capacity)
    rl = row.long()
    src_pos = src_starts[rl] + intra
    row_from_b = from_b[rl]
    in_use = pos < new_offsets[-1]
    a_pos = torch.where(in_use & ~row_from_b,
                        torch.clamp(src_pos, 0, a.byte_capacity - 1), 0)
    b_pos = torch.where(in_use & row_from_b,
                        torch.clamp(src_pos, 0, b.byte_capacity - 1), 0)
    data = torch.where(row_from_b, b.data[b_pos.long()], a.data[a_pos.long()])
    data = torch.where(in_use, data, 0).to(torch.uint8)
    return StringColumn(data, new_offsets, validity, a.dtype)


def string_equal(a: StringColumn, b: StringColumn) -> Column:
    """Row-wise string equality: equal lengths, then equal bytes
    (columnar/encoded.bytes_equal_rows). Null when either side is."""
    from ..columnar.encoded import bytes_equal_rows
    return Column(bytes_equal_rows(a, b), a.validity & b.validity, BOOLEAN)
