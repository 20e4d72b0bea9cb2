"""Spark-compatible Murmur3_x86_32 (seed 42) — the counterpart of the
murmur3 half of spark_rapids_tpu/ops/hashing.py, for fixed-width columns.

A u32 hash lane is an int32 tensor holding the u32 bit pattern (the JAX
package's uint32 lane, bitcast). On CUDA tensors `murmur3_batch` and
`murmur3_column` launch the Hopper kernel of ops/murmur3_lanes.py once
(the chain, the null rule and the float normalisation inside it); on CPU
tensors they run the plain versions below. PyTorch's CPU has no shifts
or remainders on uint32, so the plain version computes in int64 holding
32-bit values and masks after every step (`_mul32` keeps products below
2^63).

Strings wait for a later slice (ROADMAP A.5), xxhash64 too (A.3).
"""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..types import (
    BooleanType, ByteType, DateType, DoubleType, FloatType, IntegerType,
    LongType, ShortType, TimestampType,
)
from .maskedagg import _M32, _mul32

_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def u32_of(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> its u32 value in int64."""
    return bits.to(torch.int64) & _M32


def i32_bits(u: torch.Tensor) -> torch.Tensor:
    """u32 value in int64 -> int32 holding the same bits (no overflow)."""
    return ((u ^ 0x80000000) - 0x80000000).to(torch.int32)


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return _mul32(_rotl32(_mul32(k1, _C1), 15), _C2)


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = _rotl32(h1 ^ k1, 13)
    return (_mul32(h1, 5) + 0xE6546B64) & _M32


def _fmix(h1: torch.Tensor, length: int) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def murmur3_int_plain(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark Murmur3_x86_32.hashInt of int32 lanes with u32 seeds (int32
    bits); the XLA formulation in plain PyTorch."""
    k1 = _mix_k1(u32_of(v))
    return i32_bits(_fmix(_mix_h1(u32_of(seed), k1), 4))


def murmur3_long_plain(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark Murmur3_x86_32.hashLong of int64 lanes with u32 seeds."""
    low = v & _M32
    high = (v >> 32) & _M32
    h1 = _mix_h1(u32_of(seed), _mix_k1(low))
    h1 = _mix_h1(h1, _mix_k1(high))
    return i32_bits(_fmix(h1, 8))


def _normalize_float(data: torch.Tensor) -> torch.Tensor:
    """Spark normalizes -0.0 to 0.0 before hashing."""
    return torch.where(data == 0, torch.zeros_like(data), data)


def _f64_bits_signed(data: torch.Tensor) -> torch.Tensor:
    """int64 IEEE-754 pattern with NaNs canonicalized to 0x7FF8...0, as
    the JAX package's f64_bits_signed gives it."""
    bits = data.view(torch.int64)
    return torch.where(torch.isnan(data),
                       torch.full_like(bits, 0x7FF8000000000000), bits)


def murmur3_column_plain(col: Column, seed: torch.Tensor) -> torch.Tensor:
    """Per-row murmur3 update in plain PyTorch: null rows leave the running
    hash unchanged (Spark semantics). seed is u32 lanes (the running
    hash)."""
    dt = col.dtype
    if isinstance(dt, (BooleanType, ByteType, ShortType, IntegerType,
                       DateType)):
        h = murmur3_int_plain(col.data.to(torch.int32), seed)
    elif isinstance(dt, (LongType, TimestampType)):
        h = murmur3_long_plain(col.data, seed)
    elif isinstance(dt, FloatType):
        h = murmur3_int_plain(_normalize_float(col.data).view(torch.int32),
                              seed)
    elif isinstance(dt, DoubleType):
        h = murmur3_long_plain(_f64_bits_signed(_normalize_float(col.data)),
                               seed)
    else:
        raise NotImplementedError(
            f"murmur3 of {dt} waits for a later slice (ROADMAP A.5)")
    return torch.where(col.validity, h, seed)


def murmur3_batch_plain(columns, seed: int = 42) -> torch.Tensor:
    """Spark Murmur3Hash(cols..., seed) -> int32 lanes in plain PyTorch:
    each column's hash is the next column's seed."""
    c0 = columns[0]
    h = torch.full((c0.capacity,), seed, dtype=torch.int64,
                   device=c0.device)
    h = i32_bits(h & _M32)
    for col in columns:
        h = murmur3_column_plain(col, h)
    return h


def murmur3_column(col: Column, seed: torch.Tensor) -> torch.Tensor:
    """Per-row murmur3 update of the running hash `seed` (u32 lanes) by
    one column; null rows leave it unchanged. One launch on CUDA
    tensors."""
    from .murmur3_lanes import murmur3_columns
    return murmur3_columns([col], [seed])[0]


def murmur3_batch(columns, seed: int = 42) -> torch.Tensor:
    """Spark Murmur3Hash(cols..., seed) -> int32 lanes: each column's hash
    is the next column's seed. One launch per four columns on CUDA
    tensors."""
    from .murmur3_lanes import murmur3_columns
    return murmur3_columns(list(columns), [seed])[0]
