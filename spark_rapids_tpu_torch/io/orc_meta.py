"""ORC footer and metadata parsing for stripe-statistics pruning — the
port's own copy of spark_rapids_tpu/io/orc_meta.py (pure Python).

pyarrow's ORC bindings expose stripe COUNTS but not the statistics
values, so this module reads them straight from the file: the ORC
physical layout (postscript -> footer -> metadata with per-stripe
ColumnStatistics) is defined by the public Apache ORC specification's
protobuf schema; the few message/field numbers used here are transcribed
from that spec. Reference analog: GpuOrcScan's use of the ORC reader's
StripeStatistics for predicate pushdown (GpuOrcScan.scala:1455-1546 —
behavior parity, independent implementation).

Only what pruning needs is decoded: varints, length-delimited submessages
and the int/double/string/date statistics kinds. Unknown fields are
skipped by wire type, unsupported compression codecs yield NO statistics
(callers must treat missing stats as unprunable — prove-absence only).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _zigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def _skip(buf: bytes, pos: int, wt: int) -> int:
    if wt == _WT_VARINT:
        _, pos = _read_varint(buf, pos)
        return pos
    if wt == _WT_I64:
        return pos + 8
    if wt == _WT_LEN:
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wt == _WT_I32:
        return pos + 4
    raise ValueError(f"unsupported wire type {wt}")


def _fields(buf: bytes):
    """Iterate (field_number, wire_type, value_or_bytes) over a message."""
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        fno, wt = tag >> 3, tag & 7
        if wt == _WT_VARINT:
            v, pos = _read_varint(buf, pos)
            yield fno, wt, v
        elif wt == _WT_LEN:
            n, pos = _read_varint(buf, pos)
            yield fno, wt, buf[pos:pos + n]
            pos += n
        elif wt == _WT_I64:
            yield fno, wt, buf[pos:pos + 8]
            pos += 8
        elif wt == _WT_I32:
            yield fno, wt, buf[pos:pos + 4]
            pos += 4
        else:
            pos = _skip(buf, pos, wt)


class ColumnStats:
    """Normalized per-stripe, per-column statistics with the same duck
    shape parquet stats expose (so io/parquet._stats_can_skip applies
    verbatim)."""

    __slots__ = ("num_values", "null_count", "min", "max", "has_min_max")

    def __init__(self, num_values=None, null_count=None,
                 mn=None, mx=None):
        self.num_values = num_values
        self.null_count = null_count
        self.min = mn
        self.max = mx
        self.has_min_max = mn is not None and mx is not None


def _parse_column_stats(buf: bytes, total_rows: Optional[int]
                        ) -> ColumnStats:
    num_values = None
    has_null = None
    mn = mx = None
    for fno, wt, v in _fields(buf):
        if fno == 1 and wt == _WT_VARINT:          # numberOfValues
            num_values = v
        elif fno == 10 and wt == _WT_VARINT:       # hasNull
            has_null = bool(v)
        elif fno == 2 and wt == _WT_LEN:           # intStatistics
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == _WT_VARINT:
                    mn = _zigzag(v2)
                elif f2 == 2 and w2 == _WT_VARINT:
                    mx = _zigzag(v2)
        elif fno == 3 and wt == _WT_LEN:           # doubleStatistics
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == _WT_I64:
                    mn = struct.unpack("<d", v2)[0]
                elif f2 == 2 and w2 == _WT_I64:
                    mx = struct.unpack("<d", v2)[0]
        elif fno == 4 and wt == _WT_LEN:           # stringStatistics
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == _WT_LEN:
                    mn = v2.decode("utf-8", "surrogateescape")
                elif f2 == 2 and w2 == _WT_LEN:
                    mx = v2.decode("utf-8", "surrogateescape")
        elif fno == 7 and wt == _WT_LEN:           # dateStatistics
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == _WT_VARINT:
                    mn = _zigzag(v2)
                elif f2 == 2 and w2 == _WT_VARINT:
                    mx = _zigzag(v2)
    null_count = None
    if has_null is False:
        null_count = 0
    elif has_null is True and num_values is not None \
            and total_rows is not None:
        null_count = max(total_rows - num_values, 1)
    return ColumnStats(num_values, null_count, mn, mx)


def _decompress_section(raw: bytes, codec: int) -> Optional[bytes]:
    """ORC compressed section: concatenated blocks with a 3-byte header
    (chunk_len << 1 | is_original). Codec 0 = NONE (raw bytes), 1 = ZLIB
    (raw deflate). Anything else -> None (caller skips pruning)."""
    if codec == 0:
        return raw
    if codec != 1:
        return None
    out = bytearray()
    pos = 0
    while pos + 3 <= len(raw):
        hdr = raw[pos] | (raw[pos + 1] << 8) | (raw[pos + 2] << 16)
        pos += 3
        n = hdr >> 1
        chunk = raw[pos:pos + n]
        pos += n
        if hdr & 1:  # original (stored uncompressed)
            out += chunk
        else:
            out += zlib.decompress(chunk, -15)
    return bytes(out)


class OrcFileMeta:
    """Parsed ORC tail: top-level column name -> stats index mapping,
    per-stripe row counts and per-stripe ColumnStats."""

    def __init__(self, path: str):
        self.stripe_stats: List[Dict[str, ColumnStats]] = []
        self.stripe_rows: List[int] = []
        self.ok = False
        try:
            self._parse(path)
            self.ok = True
        except Exception:  # noqa: BLE001 — any parse issue = no pruning
            self.stripe_stats = []

    def _parse(self, path: str) -> None:
        with open(path, "rb") as f:
            f.seek(0, 2)
            size = f.tell()
            tail_len = min(size, 1 << 18)
            f.seek(size - tail_len)
            tail = f.read(tail_len)
        ps_len = tail[-1]
        ps = tail[-1 - ps_len:-1]
        footer_len = metadata_len = 0
        codec = 0
        for fno, wt, v in _fields(ps):
            if fno == 1 and wt == _WT_VARINT:
                footer_len = v
            elif fno == 2 and wt == _WT_VARINT:
                codec = v
            elif fno == 5 and wt == _WT_VARINT:
                metadata_len = v
        need = 1 + ps_len + footer_len + metadata_len
        if need > len(tail):
            with open(path, "rb") as f:
                f.seek(size - need)
                tail = f.read(need)
        footer_raw = tail[-1 - ps_len - footer_len:-1 - ps_len]
        meta_raw = tail[-1 - ps_len - footer_len - metadata_len:
                        -1 - ps_len - footer_len]
        footer = _decompress_section(footer_raw, codec)
        meta = _decompress_section(meta_raw, codec)
        if footer is None or meta is None:
            raise ValueError("unsupported ORC compression codec")

        # footer: types (field 4, depth-first) give the name -> stats
        # column mapping; stripes (field 3) give per-stripe row counts
        types: List[Tuple[List[int], List[str]]] = []
        for fno, wt, v in _fields(footer):
            if fno == 4 and wt == _WT_LEN:     # Type
                subtypes: List[int] = []
                names: List[str] = []
                for f2, w2, v2 in _fields(v):
                    if f2 == 2 and w2 == _WT_VARINT:
                        subtypes.append(v2)
                    elif f2 == 2 and w2 == _WT_LEN:
                        # packed repeated uint32
                        p = 0
                        while p < len(v2):
                            u, p = _read_varint(v2, p)
                            subtypes.append(u)
                    elif f2 == 3 and w2 == _WT_LEN:
                        names.append(v2.decode("utf-8"))
                types.append((subtypes, names))
            elif fno == 3 and wt == _WT_LEN:   # StripeInformation
                for f2, w2, v2 in _fields(v):
                    if f2 == 5 and w2 == _WT_VARINT:
                        self.stripe_rows.append(v2)
        if not types:
            raise ValueError("no types in footer")
        root_subtypes, root_names = types[0]
        name_to_stat_idx = dict(zip(root_names, root_subtypes))

        idx = 0
        for fno, wt, v in _fields(meta):
            if fno != 1 or wt != _WT_LEN:      # StripeStatistics
                continue
            rows = self.stripe_rows[idx] if idx < len(self.stripe_rows) \
                else None
            cols: List[bytes] = [v2 for f2, w2, v2 in _fields(v)
                                 if f2 == 1 and w2 == _WT_LEN]
            per_name: Dict[str, ColumnStats] = {}
            for name, ci in name_to_stat_idx.items():
                if ci < len(cols):
                    per_name[name] = _parse_column_stats(cols[ci], rows)
            self.stripe_stats.append(per_name)
            idx += 1
