"""Device columns — the counterpart of spark_rapids_tpu/columnar/column.py
(fixed-width columns only).

Every column is padded to a power-of-two capacity bucket, exactly as in
the JAX package, and the logical row count rides beside the data as a
device scalar (columnar/batch.py). Static capacities keep the hot path
free of host synchronisation and make CUDA-graph capture possible in a
later slice. Validity is a dense bool tensor; rows at index >= num_rows
are always invalid.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..types import DataType

#: minimum capacity bucket (the JAX package's TPU lane width, kept so the
#: two packages pad identically)
MIN_BUCKET = 128


def resolve_device(device=None) -> torch.device:
    """The port's device policy: CUDA unless the caller names a device.

    There is no silent CPU fallback: without a card the caller has to
    ask for the CPU explicitly (device="cpu"), as the tests do."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU")
    return torch.device("cuda")


def bucket_capacity(n: int) -> int:
    """Round row counts up to a power-of-two bucket (>= MIN_BUCKET)."""
    if n <= MIN_BUCKET:
        return MIN_BUCKET
    return 1 << (int(n - 1).bit_length())


def _pad_np(arr: np.ndarray, capacity: int, fill=0) -> np.ndarray:
    if arr.shape[0] == capacity:
        return arr
    out = np.full((capacity,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


class Column:
    """Fixed-width device column: data (capacity,) + validity (capacity,)."""

    __slots__ = ("data", "validity", "dtype")

    def __init__(self, data: torch.Tensor, validity: torch.Tensor,
                 dtype: DataType):
        self.data = data
        self.validity = validity
        self.dtype = dtype

    @staticmethod
    def from_numpy(values: np.ndarray, dtype: DataType,
                   capacity: Optional[int] = None, device=None,
                   validity: Optional[np.ndarray] = None) -> "Column":
        dev = resolve_device(device)
        n = values.shape[0]
        cap = capacity or bucket_capacity(n)
        if validity is None:
            validity = np.ones(n, dtype=np.bool_)
        data = _pad_np(np.ascontiguousarray(values, dtype=dtype.np_dtype), cap)
        valid = _pad_np(validity.astype(np.bool_), cap, fill=False)
        return Column(torch.from_numpy(data).to(dev),
                      torch.from_numpy(valid).to(dev), dtype)

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def with_capacity(self, capacity: int) -> "Column":
        """Grow (never shrink) the padding bucket."""
        cap = self.capacity
        if capacity == cap:
            return self
        if capacity < cap:
            raise ValueError(f"cannot shrink capacity {cap} to {capacity}")
        extra = capacity - cap
        return Column(
            torch.cat([self.data, self.data.new_zeros(extra)]),
            torch.cat([self.validity, self.validity.new_zeros(extra)]),
            self.dtype)

    def to_pylist(self, num_rows: int) -> List:
        data = self.data[:num_rows].cpu().numpy()
        valid = self.validity[:num_rows].cpu().numpy()
        return [data[i].item() if valid[i] else None for i in range(num_rows)]

    def __repr__(self):
        return f"Column({self.dtype!r}, cap={self.capacity})"
