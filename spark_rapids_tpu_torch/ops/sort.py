"""Order-key lanes — the counterpart of the part of
spark_rapids_tpu/ops/sort.py that the masked-bucket group-by uses
(`_numeric_order_key`, `_float_order_bits`). Sort kernels wait for a
later slice.

The JAX package maps a column to an unsigned lane (u8/u16/u32/u64) that
sorts ascending in value order. PyTorch has no shifts, remainders or
min/max for unsigned 32- and 64-bit tensors on every device, so the port
carries the same lane in an int64 tensor ("signed order lane"):
  * lanes of at most 32 bits hold the unsigned value itself (0..2^w-1);
  * 64-bit lanes hold the unsigned value with its top bit flipped,
    which makes signed int64 order equal the unsigned order.
Both are exact encodings of the JAX lane: comparisons, min/max and the
bucket hash (ops/maskedagg._bucket_hash) give the same answers.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column

INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)


def lane_bits(torch_dtype: torch.dtype) -> int:
    """Width of the JAX package's unsigned order lane for a data dtype."""
    if torch_dtype == torch.bool:
        return 32
    return torch.empty((), dtype=torch_dtype).element_size() * 8


def lane_neutral_min(bits: int) -> int:
    """The lane's largest value (JAX: iinfo(lane dtype).max)."""
    return INT64_MAX if bits == 64 else (1 << bits) - 1


def lane_neutral_max(bits: int) -> int:
    """The lane's smallest value (JAX: zero of the lane dtype)."""
    return INT64_MIN if bits == 64 else 0


def _float_order_bits(data: torch.Tensor) -> torch.Tensor:
    """IEEE-754 total order with Spark semantics (all NaNs collapse to one
    value greater than +inf; -0.0 == 0.0) as a signed order lane."""
    nan = torch.full((), float("nan"), dtype=data.dtype, device=data.device)
    data = torch.where(torch.isnan(data), nan, data)
    data = torch.where(data == 0, torch.zeros_like(data), data)
    if data.dtype == torch.float64:
        bits = data.view(torch.int64)
        # u = bits as unsigned; order lane = neg ? ~u : u | sign, and its
        # signed form (lane ^ sign) is bits ^ INT64_MAX for negatives and
        # bits itself otherwise
        return torch.where(bits < 0, bits ^ INT64_MAX, bits)
    bits = data.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (bits >> 31) & 1
    return torch.where(neg == 1, ~bits & 0xFFFFFFFF, bits | 0x80000000)


def _numeric_order_key(col: Column) -> torch.Tensor:
    """Map one fixed-width column to its signed order lane (int64)."""
    data = col.data
    if data.dtype == torch.bool:
        return data.to(torch.int64)
    if data.dtype.is_floating_point:
        return _float_order_bits(data)
    bits = lane_bits(data.dtype)
    if bits == 64:
        # u = data ^ sign; signed lane = u ^ sign = data
        return data
    return data.to(torch.int64) + (1 << (bits - 1))
