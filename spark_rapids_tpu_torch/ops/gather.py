"""The gather engine — the counterpart of spark_rapids_tpu/ops/gather.py:
one routing and accounting point for every materializing row gather.

- `gather_rows` is the packed row gather: the Hopper kernel
  (ops/row_gather.py) for CUDA tensors, the plain version
  (ops/rowpack.gather_rows) for CPU tensors. There is no tier selector:
  on the card the kernel always serves it.
- `gather_lane_matrix` reads a small index-lane matrix with a plain torch
  index, as the JAX package leaves it to XLA.
- `gather_batch_columns` gathers a batch's columns by an index map: two
  or more fixed-width columns ride one packed row gather, a
  Decimal128Column as its two limbs (two 8-byte lanes, so it always
  rides one), a single fixed-width column and every dictionary column
  (its codes; `rowpack.is_packable` refuses any subclass of Column) take
  the per-column path (ops/basic.gather_column).
- `GatherStats` counts the gathers, as `counters()` reports them.
"""

from __future__ import annotations

import threading
from typing import List, Sequence

import torch

__all__ = ["GatherStats", "gather_rows", "gather_lane_matrix",
           "gather_batch_columns", "pack_members", "rebuild_members",
           "record", "counters"]


class GatherStats:
    """Gather totals: materializing gathers, how many rode a packed row
    gather, how many the kernel served, and the bytes they wrote."""

    __slots__ = ("count", "packed_count", "kernel_count", "bytes")

    def __init__(self):
        self.count = self.packed_count = self.kernel_count = self.bytes = 0


_proc = GatherStats()
_proc_lock = threading.Lock()


def counters() -> dict:
    with _proc_lock:
        return {"count": _proc.count, "packed_count": _proc.packed_count,
                "kernel_count": _proc.kernel_count, "bytes": _proc.bytes}


def record(n: int = 1, packed: bool = False, kernel: bool = False,
           nbytes: int = 0) -> None:
    with _proc_lock:
        _proc.count += n
        _proc.packed_count += n if packed else 0
        _proc.kernel_count += n if kernel else 0
        _proc.bytes += nbytes


def gather_rows(plan, imat, fmat, idx):
    """Packed row gather (drop-in for rowpack.gather_rows)."""
    lanes = imat.shape[1] + (2 * fmat.shape[1] if fmat is not None else 0)
    on_card = imat.device.type == "cuda"
    record(1, packed=True, kernel=on_card, nbytes=idx.shape[0] * lanes * 4)
    if on_card:
        from .row_gather import pallas_gather_rows
        return pallas_gather_rows(plan, imat, fmat, idx.to(torch.int32))
    from .rowpack import gather_rows as plain_gather_rows
    return plain_gather_rows(plan, imat, fmat, idx)


def gather_lane_matrix(mat, idx):
    """Row gather of a small index-lane matrix: rows out of range read
    row 0 — callers mask by their own selection predicate."""
    record(1, packed=True, nbytes=idx.shape[0] * mat.shape[1] * 4)
    in_range = (idx >= 0) & (idx < mat.shape[0])
    return mat[torch.where(in_range, idx, torch.zeros_like(idx)).long()]


def pack_members(columns: Sequence):
    """The columns that ride a packed row gather: (member columns, per
    input column the indices of its members, or None for a column that
    takes the per-column path). A Decimal128Column is two members, its
    limbs, each with the column's validity."""
    from ..columnar.column import Column, Decimal128Column
    from ..types import LONG
    from .rowpack import is_packable
    members: List = []
    where: List = []
    for c in columns:
        if isinstance(c, Decimal128Column):
            where.append((len(members), len(members) + 1))
            members += [Column(c.hi.data, c.validity, LONG),
                        Column(c.lo.data, c.validity, LONG)]
        elif is_packable(c):
            where.append((len(members),))
            members.append(c)
        else:
            where.append(None)
    return members, where


def rebuild_members(columns: Sequence, where: Sequence, gathered: Sequence,
                    out: List) -> None:
    """Fill `out` with the gathered columns of `pack_members`."""
    from ..columnar.column import Decimal128Column
    for j, (c, w) in enumerate(zip(columns, where)):
        if w is None:
            continue
        if len(w) == 2:
            h, lo = gathered[w[0]], gathered[w[1]]
            out[j] = Decimal128Column.from_limbs(h.data, lo.data, h.validity,
                                                 c.dtype)
        else:
            out[j] = gathered[w[0]]


def gather_batch_columns(columns: Sequence, idx, num_rows=None,
                         out_valid=None, byte_caps=()) -> List:
    """Gather a batch's columns by an index map. `num_rows` masks output
    slots >= num_rows; `out_valid` masks by predicate; indices already
    -1-masked pass neither. `byte_caps` holds each string column's output
    byte bucket (None or absent: its input's)."""
    from .basic import active_mask, gather_column
    from .rowpack import pack_rows, unpack_rows
    midx = idx
    if num_rows is not None:
        midx = torch.where(active_mask(num_rows, idx.shape[0], idx.device),
                           idx, -1)
    elif out_valid is not None:
        midx = torch.where(out_valid, idx, -1)
    out: List = [None] * len(columns)
    members, where = pack_members(columns)
    if len(members) > 1:
        plan, imat, fmat = pack_rows(members)
        gi, gf = gather_rows(plan, imat, fmat, midx)
        rebuild_members(columns, where, unpack_rows(plan, gi, gf), out)
    o_idx = [j for j, c in enumerate(out) if c is None]
    for j in o_idx:
        out[j] = gather_column(columns[j], midx,
                               out_byte_capacity=byte_caps[j]
                               if byte_caps else None)
    return out
