"""Spark-compatible Murmur3_x86_32 (seed 42) and XxHash64 — the
counterpart of spark_rapids_tpu/ops/hashing.py.

A u32 hash lane is an int32 tensor holding the u32 bit pattern (the JAX
package's uint32 lane, bitcast). On CUDA tensors `murmur3_batch` and
`murmur3_column` launch the Hopper kernel of ops/murmur3_lanes.py once
for a run of fixed-width columns (the chain, the null rule and the float
normalisation inside it); on CPU tensors they run the plain versions
below. PyTorch's CPU has no shifts or remainders on uint32, so the plain
version computes in int64 holding 32-bit values and masks after every
step (`_mul32` keeps products below 2^63).

A decimal128 column hashes as the JAX package's struct of its hi and lo
limbs, a struct column by its fields (`hash_leaves`), so that partitions
agree with the JAX package's. String and dictionary columns hash in plain
torch on either device, over
(start, length) byte spans (`murmur3_bytes`, Spark's hashUnsafeBytes): a
dictionary column hashes each row's dictionary entry through its code, or
in `murmur3_batch`'s first position the dictionary once and each row's
hash by code (`dictionary_hashes` -> `dict_take`). A string and its
dictionary-encoded form give the same hash.

XxHash64 computes in int64 with wrapping arithmetic: the 64-bit products
and sums wrap as uint64 ones do, and a logical right shift is an
arithmetic one masked to its low 64 - r bits (`_lsr64`).

The JAX package loops over a string's words inside its program up to a
maximum it computes on the device. The loops here are Python loops whose
bound is one host read per string column and call: the longest row's
length (ROADMAP C.6, divergence (e)).
"""

from __future__ import annotations

import torch

from ..columnar.column import (Column, Decimal128Column, StringColumn,
                               StructColumn)
from ..types import (
    BooleanType, ByteType, DateType, DoubleType, FloatType, IntegerType,
    DecimalType, LongType, ShortType, TimestampNTZType, TimestampType,
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


def _max_length(lengths: torch.Tensor) -> int:
    """The loops' bound: the longest row's byte length (one host read)."""
    return int(lengths.max()) if lengths.numel() else 0


def _bytes_at(data: torch.Tensor, base: torch.Tensor, width: int):
    """(rows, width) int64 bytes at base + j, clipped into the buffer."""
    j = torch.arange(width, dtype=torch.int64, device=data.device)
    pos = torch.clamp(base.to(torch.int64)[:, None] + j[None, :], 0,
                      data.shape[0] - 1)
    return data[pos].to(torch.int64)


def _word32_at(data: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Little-endian 4-byte word at base per row (u32 value in int64)."""
    b = _bytes_at(data, base, 4)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def murmur3_bytes(lengths: torch.Tensor, starts: torch.Tensor,
                  data: torch.Tensor, seed) -> torch.Tensor:
    """Spark Murmur3_x86_32.hashUnsafeBytes over per-row (start, length)
    byte spans of a flat uint8 buffer, from u32 seeds (int32 bits, a
    tensor or an int): little-endian 4-byte words, then the trailing
    bytes one at a time, sign-extended. Returns int32 bits."""
    lengths = lengths.to(torch.int64)
    if isinstance(seed, int):
        h1 = torch.full(lengths.shape, seed & _M32, dtype=torch.int64,
                        device=lengths.device)
    else:
        h1 = u32_of(seed).expand(lengths.shape)
    for t in range(_max_length(lengths) // 4):
        active = 4 * (t + 1) <= lengths
        h_new = _mix_h1(h1, _mix_k1(_word32_at(data, starts + 4 * t)))
        h1 = torch.where(active, h_new, h1)
    aligned = (lengths // 4) * 4
    tail = _bytes_at(data, starts + aligned, 3)
    for j in range(3):
        byte = tail[:, j]
        k1 = torch.where(byte >= 0x80, byte | 0xFFFFFF00, byte)  # int8->i32
        active = (aligned + j) < lengths
        h1 = torch.where(active, _mix_h1(h1, _mix_k1(k1)), h1)
    return i32_bits(_fmix(h1, lengths))


def murmur3_string(col: StringColumn, seed) -> torch.Tensor:
    """Spark Murmur3_x86_32.hashUnsafeBytes over a string column."""
    from .strings import string_lengths
    return murmur3_bytes(string_lengths(col), col.offsets[:-1], col.data,
                         seed)


def _is_varlen(col: Column) -> bool:
    from ..columnar.encoded import DictionaryColumn
    return isinstance(col, (StringColumn, DictionaryColumn))


def hash_leaves(columns) -> list:
    """The columns murmur3 folds, in order: a decimal128 column as its hi
    then its lo limb, a struct as its fields' leaves, each leaf carrying
    its own validity ANDed with every enclosing column's. The JAX
    package's Decimal128Column is a StructColumn, and its struct hash
    folds the children and keeps the running hash on a null struct: the
    fold of these leaves gives the same hash, so partitions and buckets
    agree with it."""
    from .basic import with_validity
    out = []
    for c in columns:
        if isinstance(c, (Decimal128Column, StructColumn)):
            out += hash_leaves([with_validity(k, k.validity & c.validity)
                                for k in c.children])
        else:
            out.append(c)
    return out


def murmur3_column_plain(col: Column, seed: torch.Tensor) -> torch.Tensor:
    """Per-row murmur3 update in plain PyTorch: null rows leave the running
    hash unchanged (Spark semantics). seed is u32 lanes (the running
    hash)."""
    dt = col.dtype
    if isinstance(col, (Decimal128Column, StructColumn)):
        for leaf in hash_leaves([col]):
            seed = murmur3_column_plain(leaf, seed)
        return seed
    if _is_varlen(col):
        # a dictionary column hashes each row's entry through its code:
        # no decode (murmur3_batch owns the hash-the-dictionary-once path)
        from ..columnar.encoded import row_byte_lanes
        lengths, starts, data = row_byte_lanes(col)
        h = murmur3_bytes(lengths, starts, data, seed)
    elif isinstance(dt, (BooleanType, ByteType, ShortType, IntegerType,
                       DateType)):
        h = murmur3_int_plain(col.data.to(torch.int32), seed)
    elif isinstance(dt, (LongType, TimestampType, TimestampNTZType)) or (
            isinstance(dt, DecimalType) and not dt.is_decimal128):
        h = murmur3_long_plain(col.data, seed)
    elif isinstance(dt, FloatType):
        h = murmur3_int_plain(_normalize_float(col.data).view(torch.int32),
                              seed)
    elif isinstance(dt, DoubleType):
        h = murmur3_long_plain(_f64_bits_signed(_normalize_float(col.data)),
                               seed)
    else:
        raise NotImplementedError(
            f"murmur3 of {dt}: the JAX package has none, or it waits for "
            f"ROADMAP A.8")
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
    one column; null rows leave it unchanged. A fixed-width column is one
    launch on CUDA tensors; a string or dictionary column hashes its byte
    spans in plain torch; a decimal128 or struct column folds its leaves
    (`hash_leaves`) as `murmur3_batch` does."""
    if isinstance(col, (Decimal128Column, StructColumn)):
        return murmur3_batch([col], seed)
    if _is_varlen(col):
        return murmur3_column_plain(col, seed)
    from .murmur3_lanes import murmur3_columns
    return murmur3_columns([col], [seed])[0]


def murmur3_batch(columns, seed=42) -> torch.Tensor:
    """Spark Murmur3Hash(cols..., seed) -> int32 lanes: each column's hash
    is the next column's seed (an int, or u32 lanes of per-row running
    hashes). A decimal128 or struct column folds its leaves
    (`hash_leaves`). Every run of fixed-width columns is one launch per
    four columns on CUDA tensors; a string column hashes its bytes in
    plain torch, and a dictionary column in first position under an int
    seed hashes its dictionary once and takes each row's hash by code."""
    from .murmur3_lanes import murmur3_columns
    columns = hash_leaves(columns)
    if not any(_is_varlen(c) for c in columns):
        return murmur3_columns(columns, [seed])[0]
    from ..columnar.encoded import (DictionaryColumn, dict_take,
                                    dictionary_hashes)
    h = seed
    run: list = []
    for i, col in enumerate(columns):
        if not _is_varlen(col):
            run.append(col)
            continue
        if run:
            h = murmur3_columns(run, [h])[0]
            run = []
        if i == 0 and isinstance(col, DictionaryColumn) \
                and isinstance(seed, int):
            # the running hash is still the scalar seed: hash the
            # dictionary once, then take each row's hash by its code
            seed_lane = torch.full((col.capacity,), seed & _M32,
                                   dtype=torch.int64, device=col.device)
            h = torch.where(col.validity,
                            dict_take(dictionary_hashes(col, seed),
                                      col.codes),
                            i32_bits(seed_lane))
        else:
            if isinstance(h, int):
                h = i32_bits(torch.full((col.capacity,), h & _M32,
                                        dtype=torch.int64,
                                        device=col.device))
            h = murmur3_column_plain(col, h)
    if run:
        h = murmur3_columns(run, [h])[0]
    return h


# -- XxHash64 ------------------------------------------------------------------

def _s64(u: int) -> int:
    """A u64 constant as the int64 holding its bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_P1 = _s64(0x9E3779B185EBCA87)
_P2 = _s64(0xC2B2AE3D27D4EB4F)
_P3 = _s64(0x165667B19E3779F9)
_P4 = _s64(0x85EBCA77C2B2AE63)
_P5 = _s64(0x27D4EB2F165667C5)


def _lsr64(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 bits by 0 < r < 64."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _lsr64(x, 64 - r)


def _xx_fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _lsr64(h, 33)
    h = h * _P2
    h = h ^ _lsr64(h, 29)
    h = h * _P3
    return h ^ _lsr64(h, 32)


def xxhash64_int(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark XXH64.hashInt: the int's 4 bytes, zero-extended. `seed` and
    the result are int64 bits."""
    h = seed + _P5 + 4
    k = (v.to(torch.int64) & _M32) * _P1
    h = _rotl64(h ^ k, 23) * _P2 + _P3
    return _xx_fmix(h)


def xxhash64_long(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark XXH64.hashLong."""
    h = seed + _P5 + 8
    k = _rotl64(v.to(torch.int64) * _P2, 31) * _P1
    h = _rotl64(h ^ k, 27) * _P1 + _P4
    return _xx_fmix(h)


def _word64_at(data: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Little-endian 8-byte word at base per row (int64 bits)."""
    b = _bytes_at(data, base, 8)
    out = b[:, 0]
    for j in range(1, 8):
        out = out | (b[:, j] << (8 * j))
    return out


def xxhash64_bytes(lengths: torch.Tensor, starts: torch.Tensor,
                   data: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """XXH64 over per-row (start, length) byte spans (Spark
    XXH64.hashUnsafeBytes): 32-byte stripes, then 8-byte words, one
    4-byte word and the trailing bytes."""
    lengths = lengths.to(torch.int64)
    starts = starts.to(torch.int64)
    seed = seed.expand(lengths.shape)
    max_len = _max_length(lengths)
    stripes = lengths // 32
    v1 = seed + _P1 + _P2
    v2 = seed + _P2
    v3 = seed
    v4 = seed - _P1
    for s in range(max_len // 32):
        act = s < stripes
        base = starts + 32 * s
        acc = []
        for v, off in ((v1, 0), (v2, 8), (v3, 16), (v4, 24)):
            nv = _rotl64(v + _word64_at(data, base + off) * _P2, 31) * _P1
            acc.append(torch.where(act, nv, v))
        v1, v2, v3, v4 = acc
    big = _rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12) \
        + _rotl64(v4, 18)
    for v in (v1, v2, v3, v4):
        big = (big ^ (_rotl64(v * _P2, 31) * _P1)) * _P1 + _P4
    h = torch.where(lengths >= 32, big, seed + _P5) + lengths
    consumed = stripes * 32
    rem8 = (lengths - consumed) // 8
    # fewer than 32 bytes remain after the stripes: at most 3 words
    for t in range(min(3, max_len // 8)):
        act = t < rem8
        k = _rotl64(_word64_at(data, starts + consumed) * _P2, 31) * _P1
        h = torch.where(act, _rotl64(h ^ k, 27) * _P1 + _P4, h)
        consumed = torch.where(act, consumed + 8, consumed)
    has4 = (lengths - consumed) >= 4
    k4 = _word32_at(data, starts + consumed) * _P1
    h = torch.where(has4, _rotl64(h ^ k4, 23) * _P2 + _P3, h)
    consumed = torch.where(has4, consumed + 4, consumed)
    tail = _bytes_at(data, starts + consumed, 3)
    for j in range(3):
        act = (consumed + j) < lengths
        k1 = tail[:, j] * _P5
        h = torch.where(act, _rotl64(h ^ k1, 11) * _P1, h)
    return _xx_fmix(h)


def xxhash64_string(col: StringColumn, seed: torch.Tensor) -> torch.Tensor:
    """XXH64 over the UTF-8 bytes of each row of a string column."""
    from .strings import string_lengths
    return xxhash64_bytes(string_lengths(col), col.offsets[:-1], col.data,
                          seed)


def xxhash64_column(col: Column, seed: torch.Tensor) -> torch.Tensor:
    """Per-row XXH64 update of the running hash `seed` (int64 bits): null
    rows pass it on. A dictionary column hashes each row's entry through
    its code, so it hashes as its decoded strings."""
    dt = col.dtype
    if _is_varlen(col):
        from ..columnar.encoded import row_byte_lanes
        lengths, starts, data = row_byte_lanes(col)
        h = xxhash64_bytes(lengths, starts, data, seed)
    elif isinstance(dt, (BooleanType, ByteType, ShortType, IntegerType,
                         DateType)):
        h = xxhash64_int(col.data.to(torch.int32), seed)
    elif isinstance(dt, (LongType, TimestampType, TimestampNTZType)) or (
            isinstance(dt, DecimalType) and not dt.is_decimal128):
        h = xxhash64_long(col.data, seed)
    elif isinstance(col, Decimal128Column):
        # fold the limbs, as the JAX package folds a struct's children
        # (engine-internal bucketing; no cross-system parity is claimed)
        h = seed
        for kid in col.children:
            h = xxhash64_column(kid, h)
    elif isinstance(dt, FloatType):
        h = xxhash64_int(_normalize_float(col.data).view(torch.int32), seed)
    elif isinstance(dt, DoubleType):
        h = xxhash64_long(_f64_bits_signed(_normalize_float(col.data)), seed)
    else:
        raise NotImplementedError(
            f"xxhash64 of {dt} waits for ROADMAP A.8")
    return torch.where(col.validity, h, seed)


def xxhash64_batch(columns, seed: int = 42) -> torch.Tensor:
    """Spark XxHash64(cols..., seed) -> int64 lanes; null columns pass the
    running hash on."""
    c0 = columns[0]
    h = torch.full((c0.capacity,), _s64(seed % (1 << 64)),
                   dtype=torch.int64, device=c0.device)
    for col in columns:
        h = xxhash64_column(col, h)
    return h


def pmod(h: torch.Tensor, n: int) -> torch.Tensor:
    """Spark's positive modulo of hash partitioning."""
    r = h % n
    return torch.where(r < 0, r + n, r)
