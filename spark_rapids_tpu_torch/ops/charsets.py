"""Charset encode and decode — the counterpart of
spark_rapids_tpu/ops/charsets.py (reference GpuEncode/GpuDecode: Java
String.getBytes / new String(bytes, charset), '?' for an unmappable
character on encode, U+FFFD on decode).

Engine strings are UTF-8 bytes, so:
  encode(s, 'UTF-8')        -> byte-identical BINARY (`recast_bytes`)
  encode(s, 'US-ASCII')     -> one byte per code point; > 0x7F -> '?'
  encode(s, 'ISO-8859-1')   -> code points <= 0xFF collapse to one byte
  decode(b, 'UTF-8')        -> byte-identical STRING (malformed input
                               passes through, the JAX package's
                               documented deviation)
  decode(b, 'ISO-8859-1')   -> bytes >= 0x80 expand to two UTF-8 bytes
  decode(b, 'US-ASCII')     -> bytes >= 0x80 expand to U+FFFD (3 bytes)
The UTF-16 variants are tagged off (the JAX package's host tier).
"""

from __future__ import annotations

import torch

from ..columnar.column import StringColumn
from ..types import BINARY, STRING
from .basic import active_mask, compaction_order
from .strings import _byte_table, _col_bytes, _rebuild_offsets, _segment


def encode_single_byte(col: StringColumn, charset: str) -> StringColumn:
    """UTF-8 -> US-ASCII / ISO-8859-1: one output byte per code point,
    compacted from the code points' lead bytes (input byte bucket)."""
    byte_cap = col.byte_capacity
    _, row, _, in_use = _col_bytes(col)
    b = col.data
    keep = in_use & ((b & 0xC0) != 0x80)
    nxt = torch.cat([b[1:], b.new_zeros(1)])
    q = torch.full_like(b, ord("?"))
    if charset == "US-ASCII":
        ch = torch.where(b < 0x80, b, q)
    else:  # ISO-8859-1
        ch = torch.where(b < 0x80, b, torch.where(
            b == 0xC2, nxt, torch.where(b == 0xC3, nxt + 0x40, q)))
    counts = _segment(keep.to(torch.int32), row, col.capacity, "sum")
    offsets = _rebuild_offsets(torch.where(col.validity, counts, 0))
    perm, total = compaction_order(keep, col.offsets[-1])
    out_use = active_mask(total, byte_cap)
    data = torch.where(out_use, ch[torch.clamp(perm, 0, byte_cap - 1).long()],
                       torch.zeros((), dtype=torch.uint8, device=b.device))
    return StringColumn(data, offsets, col.validity, BINARY)


def decode_single_byte(col: StringColumn, charset: str) -> StringColumn:
    """US-ASCII / ISO-8859-1 bytes -> a UTF-8 string; byte bucket: the
    input's times the widest expansion (3 or 2)."""
    byte_cap = col.byte_capacity
    b = col.data
    mult = 3 if charset == "US-ASCII" else 2
    per_len = torch.where(b >= 0x80, mult, 1).to(torch.int32)
    _, row, _, in_use = _col_bytes(col)
    per_len = torch.where(in_use, per_len, 0)
    out_counts = _segment(per_len, row, col.capacity, "sum")
    offsets = _rebuild_offsets(torch.where(col.validity, out_counts, 0))
    # each input byte's start within the output stream
    out_start = torch.cumsum(per_len, 0, dtype=torch.int32) - per_len
    opos = torch.arange(byte_cap * mult, dtype=torch.int32, device=b.device)
    src = torch.clamp(torch.searchsorted(out_start, opos, right=True)
                      .to(torch.int32) - 1, 0, byte_cap - 1).long()
    k = opos - out_start[src]      # 0..2 within the expansion
    sb = b[src]
    if charset == "US-ASCII":
        rep = _byte_table("\ufffd".encode(), b.device)
        ch = torch.where(sb < 0x80, sb, rep[torch.clamp(k, 0, 2).long()])
    else:
        ch = torch.where(sb < 0x80, sb, torch.where(
            k == 0, 0xC0 | (sb >> 6), 0x80 | (sb & 0x3F)).to(torch.uint8))
    data = torch.where(opos < offsets[-1], ch,
                       torch.zeros((), dtype=torch.uint8, device=b.device))
    return StringColumn(data, offsets, col.validity, STRING)


def recast_bytes(col: StringColumn, dtype) -> StringColumn:
    """UTF-8 passthrough: the same bytes under a new logical type."""
    return StringColumn(col.data, col.offsets, col.validity, dtype)
