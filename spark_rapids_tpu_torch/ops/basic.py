"""Core row-layout ops — the counterpart of spark_rapids_tpu/ops/basic.py.

Conventions carried over from the JAX package:
  * shapes stay at the capacity bucket while the row count lives in a
    device scalar, so no op here synchronises with the host;
  * rows with index >= num_rows are "inactive": validity False, data zero.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..columnar.column import Column


def active_mask(num_rows, capacity: int, device=None) -> torch.Tensor:
    """Bool (capacity,): True for logical rows."""
    if isinstance(num_rows, torch.Tensor):
        device = num_rows.device
    return torch.arange(capacity, dtype=torch.int32, device=device) < num_rows


def sanitize(col: Column, num_rows) -> Column:
    """Force the inactive tail to (zero, invalid) so padded slots never leak."""
    act = active_mask(num_rows, col.capacity, col.device)
    data = torch.where(act, col.data, torch.zeros_like(col.data))
    return Column(data, col.validity & act, col.dtype)


def concat_columns(a: Column, b: Column, a_rows, b_rows,
                   out_capacity: int) -> Column:
    """Concatenate two columns' active rows (the coalesce primitive).

    out_capacity must be >= a_rows + b_rows in the worst case."""
    idx = torch.arange(out_capacity, dtype=torch.int32, device=a.device)
    from_b = idx >= a_rows
    b_idx = idx - a_rows
    out_valid = idx < a_rows + b_rows

    def cat(x, y):
        x_safe = torch.where(idx < x.shape[0], idx, 0).long()
        y_safe = torch.clamp(b_idx, 0, y.shape[0] - 1).long()
        return torch.where(from_b, y[y_safe], x[x_safe])

    data = cat(a.data, b.data)
    valid = cat(a.validity, b.validity) & out_valid
    data = torch.where(out_valid, data, torch.zeros_like(data))
    return Column(data, valid, a.dtype)


def compact_columns(columns: Sequence[Column], keep: torch.Tensor, num_rows
                    ) -> Tuple[Tuple[Column, ...], torch.Tensor]:
    """Filter: move the kept active rows to the front, in order, without a
    host sync (a stable sort on the drop flag, as the JAX package's
    compaction_order does). The caller has AND-ed validity into `keep`."""
    cap = keep.shape[0]
    k = keep & active_mask(num_rows, cap, keep.device)
    _, perm = torch.sort((~k).to(torch.uint8), stable=True)
    new_rows = k.sum(dtype=torch.int32)
    out_valid = active_mask(new_rows, cap)
    out = []
    for c in columns:
        data = torch.where(out_valid, c.data[perm], torch.zeros_like(c.data))
        out.append(Column(data, c.validity[perm] & out_valid, c.dtype))
    return tuple(out), new_rows
