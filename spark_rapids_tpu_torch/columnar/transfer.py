"""Packed device->host batch transfer — the counterpart of
spark_rapids_tpu/columnar/transfer.py.

Reading a result batch column by column pays one device round trip per
buffer. Here the batch is packed on the device into one contiguous uint8
buffer (one `torch.cat`) and crosses to the host in one copy; the host
side then takes views of it apart.

Layout, little-endian: the int32 row count, then every column's leaves in
`Column.leaves()` order (a fixed-width column's data and validity; a
StringColumn's bytes, offsets and validity; a DictionaryColumn's codes,
dictionary bytes, dictionary offsets and validity; a Decimal128Column's
hi limb, lo limb and validity). The row count and each
leaf start on an ALIGN-byte boundary, zero-padded, so that every leaf of
any dtype is a `Tensor.view` of the one buffer on either side. The JAX
package packs its blocks back to back (XLA's bitcasts need no alignment):
the wire bytes of the two packages differ, their columns do not. The packed
upload (columnar/upload.py) lays out the host pack the same way, and the
two are byte-identical (tests/test_torch_upload.py).

Nested column kinds wait for their slice (ROADMAP A.8). Not ported by
design: the TPU's double-double staging of f64 (`_dd_split`); the H100
moves f64 as it is.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .column import Column, Decimal128Column, StringColumn
from .encoded import DictionaryColumn

#: every block of the layout starts on this byte boundary
ALIGN = 16
#: the row count's block
HEADER_BYTES = ALIGN

_KINDS = (Column, StringColumn, DictionaryColumn, Decimal128Column)

_COUNTER_LOCK = threading.Lock()
_COUNTERS = {"d2h_copies": 0, "d2h_bytes": 0}


def note_d2h(nbytes: int) -> None:
    """One packed device->host copy landed."""
    with _COUNTER_LOCK:
        _COUNTERS["d2h_copies"] += 1
        _COUNTERS["d2h_bytes"] += int(nbytes)


def counters() -> Dict[str, int]:
    with _COUNTER_LOCK:
        return dict(_COUNTERS)


def padded(nbytes: int) -> int:
    return -(-nbytes // ALIGN) * ALIGN


def column_layout(col: Column) -> tuple:
    """(class, dtype, ((torch dtype, numel), ...)) of a column's leaves:
    what sizes a pack and rebuilds the column from one."""
    if type(col) not in _KINDS:
        raise NotImplementedError(
            f"{type(col).__name__} columns: nested kinds wait for their "
            f"slice (ROADMAP A.8)")
    return (type(col), col.dtype,
            tuple((t.dtype, t.numel()) for t in col.leaves()))


def layout_nbytes(layouts: Sequence[tuple]) -> int:
    """Bytes of the columns' blocks in a pack, padding included."""
    return sum(padded(n * dt.itemsize)
               for _, _, blocks in layouts for dt, n in blocks)


def leaf_bytes(t: torch.Tensor) -> torch.Tensor:
    """A leaf as a flat uint8 view (a copy only for a strided leaf)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def unpack_columns(buf: torch.Tensor, layouts: Sequence[tuple], pos: int
                   ) -> Tuple[List[Column], int]:
    """Rebuild columns as views of the uint8 `buf`, from offset `pos`."""
    cols = []
    for cls, dtype, blocks in layouts:
        leaves = []
        for dt, n in blocks:
            nbytes = n * dt.itemsize
            leaves.append(buf[pos: pos + nbytes].view(dt))
            pos += padded(nbytes)
        cols.append(cls.from_leaves(dtype, leaves))
    return cols, pos


def _pieces(head: torch.Tensor, columns: Sequence[Column]
            ) -> List[torch.Tensor]:
    """The uint8 pieces of a pack, zero padding included."""
    zeros = torch.zeros(ALIGN, dtype=torch.uint8, device=head.device)
    out = []
    for block in [head] + [t for c in columns for t in c.leaves()]:
        b = leaf_bytes(block)
        out.append(b)
        pad = padded(b.shape[0]) - b.shape[0]
        if pad:
            out.append(zeros[:pad])
    return out


def _pack_impl(batch) -> torch.Tensor:
    """The batch as one uint8 buffer on its device: the row count, then
    its columns (a torch.cat of views)."""
    for c in batch.columns:
        column_layout(c)
    head = batch.num_rows.to(torch.int32).reshape(1)
    return torch.cat(_pieces(head, batch.columns))


def fetch_batch_host(batch) -> Tuple[List[Column], int]:
    """A batch on the host in ONE device->host copy: (columns of CPU
    tensors, viewing the copied buffer; the row count). Dictionary
    columns come back encoded: `to_pylist` decodes them on the host."""
    layouts = [column_layout(c) for c in batch.columns]
    buf = _pack_impl(batch).cpu()  # the single transfer
    note_d2h(buf.shape[0])
    n = int(buf[:4].view(torch.int32)[0])
    cols, pos = unpack_columns(buf, layouts, HEADER_BYTES)
    if pos != buf.shape[0]:
        raise AssertionError(f"unpacked {pos} of {buf.shape[0]} bytes")
    return cols, n


def pack_split(counts: torch.Tensor, columns: Sequence[Column]
               ) -> torch.Tensor:
    """(per-partition int32 counts, partition-ordered columns) as one
    uint8 buffer: the count table's block (padded), then the columns.
    The exchange (ROADMAP A.6) fetches a shuffle split through it."""
    for c in columns:
        column_layout(c)
    return torch.cat(_pieces(counts.to(torch.int32).reshape(-1), columns))


def unpack_split_host(buf: torch.Tensor, template_columns,
                      n_parts: int) -> Tuple[np.ndarray, List[Column]]:
    """Host unpack of a pack_split buffer; the template columns give the
    layout only. Returns (counts as int64 numpy, host columns)."""
    counts = buf[: 4 * n_parts].view(torch.int32).numpy().astype(np.int64)
    layouts = [column_layout(c) for c in template_columns]
    cols, pos = unpack_columns(buf, layouts, padded(4 * n_parts))
    if pos != buf.shape[0]:
        raise AssertionError(f"unpacked {pos} of {buf.shape[0]} bytes")
    return counts, cols


def fetch_split_host(counts: torch.Tensor, columns: Sequence[Column]
                     ) -> Tuple[np.ndarray, List[Column]]:
    """The count table and the partition-ordered columns in ONE
    device->host copy."""
    buf = pack_split(counts, columns).cpu()
    note_d2h(buf.shape[0])
    return unpack_split_host(buf, columns, int(counts.shape[0]))
