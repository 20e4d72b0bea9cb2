"""Columnar batch wire format of the host shuffle — the counterpart of
spark_rapids_tpu/shuffle/serializer.py (the reference's
GpuColumnarBatchSerializer.scala:127 and JCudfSerialization's host-buffer
framing, with nvcomp LZ4 replaced by the native block codec,
csrc/blockcodec.cpp).

Frame layout (little-endian), byte for byte the JAX package's:

    magic "TPUSHUF1" | u8 version | u8 codec | u16 flags
    u64 num_rows | u64 schema_hash | u64 raw_len | u64 comp_len
    u64 checksum (xxh64 of the frame with this field zeroed)
    u32 nbuf | nbuf * u64 buffer byte lengths
    payload (concatenated buffers, possibly compressed)

The buffer structure follows from the schema, which the reader knows from
the plan, so the header carries only byte lengths and a fingerprint of
the schema (`schema_fingerprint`, over the types' `simple_name()`s).
Buffers per column, in order, trimmed to the logical row count (padding
never reaches the wire):

    fixed-width: validity bitmask (packbits, little bit order),
                 data[:num_rows]
    string:      validity bitmask, offsets[:num_rows+1] rebased to 0,
                 bytes[:total]
    decimal128:  validity bitmask, then the hi and lo limbs each as a
                 fixed-width LONG column (the JAX package's struct
                 children)
    array:       validity bitmask, offsets[:num_rows+1] rebased to 0,
                 then the child encoded over exactly the referenced
                 element span
    struct:      validity bitmask, then each child encoded over the same
                 rows, in field order
    map:         validity bitmask, offsets[:num_rows+1] rebased to 0,
                 then the keys and the values each encoded over exactly
                 the referenced entry span

Columns are encoded from host tensors (CPU): `serialize_batch` fetches a
batch on the card in one packed copy first (columnar/transfer.py), and
the exchange serializes slices of the host batch its split fetched.
`deserialize_batch` returns a host-backed batch (CPU tensors at their
capacity buckets, as `host_gather_column` makes them); the caller
promotes it at its own seam (columnar/upload.promote_stream). A
dictionary column decodes at the exchange's boundary before it gets
here.
DECIMAL(p<=18) crosses as its int64 lane.

A codec that fails to build raises (native/__init__.py): COPY is a codec
a caller asks for by name, never a fallback. LZ4 output that is not
smaller than its input is stored as COPY, as in the JAX package.
"""

from __future__ import annotations

import struct
import time
from typing import List, Tuple

import numpy as np
import torch

from ..columnar.batch import ColumnarBatch
from ..columnar.column import (ArrayColumn, Column, Decimal128Column,
                               MapColumn, StringColumn, StructColumn,
                               bucket_capacity)
from ..native import lz4_compress, lz4_decompress, xxh64
from ..types import (LONG, ArrayType, BinaryType, DecimalType, MapType,
                     NullType, Schema, StringType, StructType)

__all__ = [
    "MAGIC", "VERSION", "CODEC_COPY", "CODEC_LZ4", "CorruptFrameError",
    "schema_fingerprint", "serialize_batch", "serialize_batch_stats",
    "serialize_slice", "serialize_slice_stats",
    "deserialize_batch", "host_gather_column", "host_gather_batch",
    "host_slice_column", "host_slice_batch",
]

MAGIC = b"TPUSHUF1"
VERSION = 1
CODEC_COPY = 0  # reference CopyCompressionCodec
CODEC_LZ4 = 1   # reference NvcompLZ4CompressionCodec (host analog)


class CorruptFrameError(ValueError):
    """The frame's structure or checksum failed verification: the block
    is damaged (a torn write, bit rot)."""


_HEADER = struct.Struct("<8sBBHQQQQQI")


def schema_fingerprint(schema: Schema) -> int:
    return xxh64(repr([(f.name, f.data_type.simple_name())
                       for f in schema.fields]).encode())


# -- host column encode (host tensors -> trimmed numpy buffers) --------------

def _np(t: torch.Tensor) -> np.ndarray:
    if t.device.type != "cpu":
        raise ValueError(f"the serializer encodes host columns, not "
                         f"tensors on {t.device}")
    return t.numpy()


def _check_kind(col: Column) -> None:
    if type(col) not in (Column, StringColumn, Decimal128Column,
                         ArrayColumn, StructColumn, MapColumn):
        raise NotImplementedError(
            f"{type(col).__name__} columns do not cross the shuffle: "
            f"dictionary columns decode at the exchange's boundary")


def _rebase_offsets(off: np.ndarray, n: int, start: int = 0) -> np.ndarray:
    out = off[start: start + n + 1].astype(np.int32, copy=True)
    return out - out[0]


def _encode_column(col: Column, n: int, out: List[np.ndarray],
                   start: int = 0) -> None:
    """Encode rows [start, start+n) of a host column into trimmed
    buffers."""
    _check_kind(col)
    out.append(np.packbits(_np(col.validity)[start: start + n]
                           .astype(np.bool_), bitorder="little"))
    if isinstance(col, StringColumn):
        off = _np(col.offsets)
        out.append(_rebase_offsets(off, n, start))
        lo = int(off[start])
        hi = int(off[start + n]) if n else lo
        out.append(_np(col.data)[lo:hi].astype(np.uint8, copy=False))
    elif isinstance(col, Decimal128Column):
        for limb in col.children:
            _encode_column(limb, n, out, start)
    elif isinstance(col, ArrayColumn):
        off = _np(col.offsets)
        out.append(_rebase_offsets(off, n, start))
        # the child is encoded for exactly the referenced element span
        lo = int(off[start])
        hi = int(off[start + n]) if n else lo
        _encode_column(col.child, hi - lo, out, start=lo)
    elif isinstance(col, StructColumn):
        for ch in col.children:
            _encode_column(ch, n, out, start)
    elif isinstance(col, MapColumn):
        off = _np(col.offsets)
        out.append(_rebase_offsets(off, n, start))
        lo = int(off[start])
        hi = int(off[start + n]) if n else lo
        _encode_column(col.keys, hi - lo, out, start=lo)
        _encode_column(col.values, hi - lo, out, start=lo)
    else:
        out.append(np.ascontiguousarray(_np(col.data)[start: start + n]))


def _decode_column(dtype, n: int, bufs: List[bytes], pos: int,
                   capacity: int) -> Tuple[Column, int]:
    """One column's buffers -> a host column (CPU tensors) at `capacity`
    rows (a string's bytes at their own bucket)."""
    vbits = np.frombuffer(bufs[pos], dtype=np.uint8)
    pos += 1
    vpad = np.zeros(capacity, np.bool_)
    if n:
        vpad[:n] = np.unpackbits(vbits, count=n,
                                 bitorder="little").astype(np.bool_)
    if isinstance(dtype, (StringType, BinaryType)):
        off = np.frombuffer(bufs[pos], dtype=np.int32)
        data = np.frombuffer(bufs[pos + 1], dtype=np.uint8)
        pos += 2
        opad = np.zeros(capacity + 1, np.int32)
        opad[: n + 1] = off
        opad[n + 1:] = off[n] if n else 0
        dpad = np.zeros(bucket_capacity(max(len(data), 1)), np.uint8)
        dpad[: len(data)] = data
        return StringColumn(torch.from_numpy(dpad), torch.from_numpy(opad),
                            torch.from_numpy(vpad), dtype), pos
    if isinstance(dtype, StructType):
        kids = []
        for f in dtype.fields:
            k, pos = _decode_column(f.data_type, n, bufs, pos, capacity)
            kids.append(k)
        return StructColumn(kids, torch.from_numpy(vpad), dtype), pos
    if isinstance(dtype, (ArrayType, MapType)):
        off = np.frombuffer(bufs[pos], dtype=np.int32)
        pos += 1
        opad = np.zeros(capacity + 1, np.int32)
        opad[: n + 1] = off
        opad[n + 1:] = off[n] if n else 0
        child_n = int(off[n]) if n else 0
        child_cap = bucket_capacity(max(child_n, 1))
        if isinstance(dtype, MapType):
            keys, pos = _decode_column(dtype.key_type, child_n, bufs, pos,
                                       child_cap)
            vals, pos = _decode_column(dtype.value_type, child_n, bufs,
                                       pos, child_cap)
            return MapColumn(keys, vals, torch.from_numpy(opad),
                             torch.from_numpy(vpad), dtype), pos
        child, pos = _decode_column(dtype.element_type, child_n, bufs, pos,
                                    child_cap)
        return ArrayColumn(child, torch.from_numpy(opad),
                           torch.from_numpy(vpad), dtype), pos
    if isinstance(dtype, DecimalType) and dtype.is_decimal128:
        hi, pos = _decode_column(LONG, n, bufs, pos, capacity)
        lo, pos = _decode_column(LONG, n, bufs, pos, capacity)
        return Decimal128Column((hi, lo), torch.from_numpy(vpad),
                                dtype), pos
    # the null type's lane is int8 zeros under an all-null validity
    np_dtype = np.int8 if isinstance(dtype, NullType) else dtype.np_dtype
    data = np.frombuffer(bufs[pos], dtype=np_dtype)
    pos += 1
    dpad = np.zeros(capacity, np_dtype)
    dpad[:n] = data
    return Column(torch.from_numpy(dpad), torch.from_numpy(vpad),
                  dtype), pos


# -- frame encode/decode -----------------------------------------------------

def _frame_from_bufs(bufs: List[np.ndarray], n: int, schema: Schema,
                     codec: int = CODEC_LZ4) -> Tuple[bytes, int, int]:
    """Trimmed buffers -> (one self-checking frame, raw payload bytes,
    ns spent compressing): the byte layout both serialize_batch and
    serialize_slice produce."""
    if codec not in (CODEC_COPY, CODEC_LZ4):
        raise ValueError(f"unknown shuffle codec {codec!r}")
    raw_parts = [np.ascontiguousarray(b).tobytes() for b in bufs]
    raw = b"".join(raw_parts)
    compress_ns = 0
    if codec == CODEC_LZ4:
        t0 = time.perf_counter_ns()
        payload = lz4_compress(raw)
        compress_ns = time.perf_counter_ns() - t0
        if len(payload) >= len(raw):  # incompressible: store raw
            codec, payload = CODEC_COPY, raw
    else:
        payload = raw
    sizes = struct.pack(f"<{len(raw_parts)}Q", *map(len, raw_parts))
    # the checksum covers the whole frame (header with the checksum field
    # zeroed, size table and payload): a flipped header bit is a detected
    # corruption, not garbage buffers
    shash = schema_fingerprint(schema)
    hdr0 = _HEADER.pack(MAGIC, VERSION, codec, 0, n, shash,
                        len(raw), len(payload), 0, len(raw_parts))
    chk = xxh64(hdr0 + sizes + payload)
    header = _HEADER.pack(MAGIC, VERSION, codec, 0, n, shash,
                          len(raw), len(payload), chk, len(raw_parts))
    return header + sizes + payload, len(raw), compress_ns


def _host_columns(batch: ColumnarBatch) -> Tuple[List[Column], int]:
    """The batch's columns on the host: as they are when every leaf lies
    on the CPU, else fetched in one packed device->host copy."""
    if all(t.device.type == "cpu" for c in batch.columns
           for t in c.leaves()):
        return list(batch.columns), batch.num_rows_host
    from ..columnar.transfer import fetch_batch_host
    cols, n = fetch_batch_host(batch)
    batch._host_rows = n
    return cols, n


def serialize_batch_stats(batch: ColumnarBatch, codec: int = CODEC_LZ4
                          ) -> Tuple[bytes, int, int]:
    """serialize_batch with the frame's raw payload bytes and the ns its
    compression took: (frame, raw bytes, compress ns)."""
    cols, n = _host_columns(batch)
    bufs: List[np.ndarray] = []
    for col in cols:
        _encode_column(col, n, bufs)
    return _frame_from_bufs(bufs, n, batch.schema, codec)


def serialize_batch(batch: ColumnarBatch, codec: int = CODEC_LZ4) -> bytes:
    """Batch -> one self-checking frame. Padding is trimmed; a string
    column keeps only its referenced bytes."""
    return serialize_batch_stats(batch, codec)[0]


def serialize_slice_stats(batch: ColumnarBatch, lo: int, hi: int,
                          codec: int = CODEC_LZ4) -> Tuple[bytes, int, int]:
    """serialize_slice with the frame's raw payload bytes and the ns its
    compression took: (frame, raw bytes, compress ns)."""
    if not 0 <= lo <= hi:
        raise ValueError(f"bad row range [{lo}, {hi})")
    n = hi - lo
    bufs: List[np.ndarray] = []
    for col in batch.columns:
        _encode_column(col, n, bufs, start=lo)
    return _frame_from_bufs(bufs, n, batch.schema, codec)


def serialize_slice(batch: ColumnarBatch, lo: int, hi: int,
                    codec: int = CODEC_LZ4) -> bytes:
    """Rows [lo, hi) of a host batch as one frame: byte-identical to
    `serialize_batch(host_gather_batch(batch, arange(lo, hi)))` with no
    gather (offsets rebase in place; validity, data and bytes slice).
    The exchange's split lands a batch in partition order, so every
    partition is such a row range."""
    return serialize_slice_stats(batch, lo, hi, codec)[0]


def deserialize_batch(frame: bytes, schema: Schema) -> ColumnarBatch:
    """Frame -> host-backed batch (CPU tensors). Raises CorruptFrameError
    for a frame whose structure or checksum fails, ValueError for a
    checksummed frame of another schema."""
    if len(frame) < _HEADER.size:
        raise CorruptFrameError("truncated shuffle frame header")
    (magic, version, codec, flags, n, shash, raw_len, comp_len, chk,
     nbuf) = _HEADER.unpack_from(frame, 0)
    if magic != MAGIC or version != VERSION:
        raise CorruptFrameError("not a TPU shuffle frame")
    off = _HEADER.size
    if len(frame) < off + 8 * nbuf:
        raise CorruptFrameError("truncated shuffle frame size table")
    sizes = struct.unpack_from(f"<{nbuf}Q", frame, off)
    sizes_bytes = frame[off: off + 8 * nbuf]
    off += 8 * nbuf
    payload = frame[off: off + comp_len]
    hdr0 = _HEADER.pack(magic, version, codec, flags, n, shash,
                        raw_len, comp_len, 0, nbuf)
    if len(payload) != comp_len or \
            xxh64(hdr0 + sizes_bytes + payload) != chk:
        raise CorruptFrameError(
            "shuffle frame checksum mismatch (corrupt block)")
    # checksum verified: a fingerprint mismatch now is a real schema
    # disagreement (an engine bug), not bit rot
    if shash != schema_fingerprint(schema):
        raise ValueError("shuffle frame schema mismatch")
    if codec == CODEC_LZ4:
        raw = lz4_decompress(payload, raw_len)
    elif codec == CODEC_COPY:
        raw = payload
    else:
        raise CorruptFrameError(f"unknown shuffle codec {codec}")
    if sum(sizes) != len(raw):
        raise CorruptFrameError("shuffle frame sizes disagree with its "
                                "payload")
    bufs: List[bytes] = []
    p = 0
    for s in sizes:
        bufs.append(raw[p: p + s])
        p += s
    capacity = bucket_capacity(max(n, 1))
    cols: List[Column] = []
    pos = 0
    for f in schema.fields:
        c, pos = _decode_column(f.data_type, n, bufs, pos, capacity)
        cols.append(c)
    return ColumnarBatch(cols, n, schema)


# -- host row gather and slice (the range lane's partition split) -----------

def host_gather_column(col: Column, idx: np.ndarray) -> Column:
    """Row-gather a host column into a compact host column at the bucket
    of len(idx) (a string's bytes at their own bucket)."""
    _check_kind(col)
    k = len(idx)
    cap = bucket_capacity(max(k, 1))
    vpad = np.zeros(cap, np.bool_)
    vpad[:k] = _np(col.validity)[idx]
    if isinstance(col, StringColumn):
        off = _np(col.offsets)
        data = _np(col.data)
        starts = off[idx].astype(np.int64)
        lens = off[idx + 1].astype(np.int64) - starts
        total = int(lens.sum())
        new_off = np.zeros(cap + 1, np.int32)
        np.cumsum(lens, out=new_off[1: k + 1])
        new_off[k + 1:] = new_off[k]
        out = np.zeros(bucket_capacity(max(total, 1)), np.uint8)
        if total:
            cum = np.concatenate([[0], np.cumsum(lens)[:-1]])
            byte_idx = (np.repeat(starts, lens) + np.arange(total)
                        - np.repeat(cum, lens))
            out[:total] = data[byte_idx]
        return StringColumn(torch.from_numpy(out), torch.from_numpy(new_off),
                            torch.from_numpy(vpad), col.dtype)
    if isinstance(col, Decimal128Column):
        kids = tuple(host_gather_column(c, idx) for c in col.children)
        return Decimal128Column(kids, torch.from_numpy(vpad), col.dtype)
    if isinstance(col, StructColumn):
        kids = [host_gather_column(c, idx) for c in col.children]
        return StructColumn(kids, torch.from_numpy(vpad), col.dtype)
    if isinstance(col, (ArrayColumn, MapColumn)):
        off = _np(col.offsets)
        starts = off[idx].astype(np.int64)
        lens = off[idx + 1].astype(np.int64) - starts
        total = int(lens.sum())
        new_off = np.zeros(cap + 1, np.int32)
        np.cumsum(lens, out=new_off[1: k + 1])
        new_off[k + 1:] = new_off[k]
        elem_idx = np.zeros(0, np.int64)
        if total:
            cum = np.concatenate([[0], np.cumsum(lens)[:-1]])
            elem_idx = (np.repeat(starts, lens) + np.arange(total)
                        - np.repeat(cum, lens))
        if isinstance(col, MapColumn):
            return MapColumn(host_gather_column(col.keys, elem_idx),
                             host_gather_column(col.values, elem_idx),
                             torch.from_numpy(new_off),
                             torch.from_numpy(vpad), col.dtype)
        return ArrayColumn(host_gather_column(col.child, elem_idx),
                           torch.from_numpy(new_off),
                           torch.from_numpy(vpad), col.dtype)
    data = _np(col.data)
    dpad = np.zeros(cap, data.dtype)
    dpad[:k] = data[idx]
    return Column(torch.from_numpy(dpad), torch.from_numpy(vpad), col.dtype)


def host_gather_batch(batch: ColumnarBatch, idx: np.ndarray
                      ) -> ColumnarBatch:
    return ColumnarBatch([host_gather_column(c, idx) for c in batch.columns],
                         len(idx), batch.schema)


def host_slice_column(col: Column, lo: int, hi: int) -> Column:
    """Rows [lo, hi) of a host column as a compact column, equal to
    host_gather_column(col, arange(lo, hi)) (same buckets, same padding)
    with no gather."""
    _check_kind(col)
    n = hi - lo
    cap = bucket_capacity(max(n, 1))
    vpad = np.zeros(cap, np.bool_)
    vpad[:n] = _np(col.validity)[lo:hi]
    if isinstance(col, StringColumn):
        off = _np(col.offsets)
        base = int(off[lo])
        end = int(off[hi]) if n else base
        new_off = np.zeros(cap + 1, np.int32)
        new_off[: n + 1] = off[lo: hi + 1] - base
        new_off[n + 1:] = new_off[n]
        out = np.zeros(bucket_capacity(max(end - base, 1)), np.uint8)
        out[: end - base] = _np(col.data)[base:end]
        return StringColumn(torch.from_numpy(out), torch.from_numpy(new_off),
                            torch.from_numpy(vpad), col.dtype)
    if isinstance(col, Decimal128Column):
        kids = tuple(host_slice_column(c, lo, hi) for c in col.children)
        return Decimal128Column(kids, torch.from_numpy(vpad), col.dtype)
    if isinstance(col, StructColumn):
        kids = [host_slice_column(c, lo, hi) for c in col.children]
        return StructColumn(kids, torch.from_numpy(vpad), col.dtype)
    if isinstance(col, (ArrayColumn, MapColumn)):
        off = _np(col.offsets)
        base = int(off[lo])
        end = int(off[hi]) if n else base
        new_off = np.zeros(cap + 1, np.int32)
        new_off[: n + 1] = off[lo: hi + 1] - base
        new_off[n + 1:] = new_off[n]
        if isinstance(col, MapColumn):
            return MapColumn(host_slice_column(col.keys, base, end),
                             host_slice_column(col.values, base, end),
                             torch.from_numpy(new_off),
                             torch.from_numpy(vpad), col.dtype)
        return ArrayColumn(host_slice_column(col.child, base, end),
                           torch.from_numpy(new_off),
                           torch.from_numpy(vpad), col.dtype)
    data = _np(col.data)
    dpad = np.zeros(cap, data.dtype)
    dpad[:n] = data[lo:hi]
    return Column(torch.from_numpy(dpad), torch.from_numpy(vpad), col.dtype)


def host_slice_batch(batch: ColumnarBatch, lo: int, hi: int
                     ) -> ColumnarBatch:
    return ColumnarBatch([host_slice_column(c, lo, hi)
                          for c in batch.columns], hi - lo, batch.schema)
