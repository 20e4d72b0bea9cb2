"""Base64 and hex codecs over the (offsets, bytes) layout — the
counterpart of spark_rapids_tpu/ops/codecs.py (reference GpuBase64,
GpuUnBase64, GpuHex, GpuUnhex). Each OUTPUT byte computes its source
group arithmetically: no per-row loop, one gather per output byte lane.
The output byte buckets are the JAX package's static worst cases.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column, StringColumn, bucket_capacity
from ..types import BINARY, STRING
from .strings import (_byte_table, _col_bytes, _rebuild_offsets,
                      _row_of_byte, _segment, hex_digit_val, string_lengths)

_B64 = b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/"
_HEXU = b"0123456789ABCDEF"


def _zero(dev) -> torch.Tensor:
    return torch.zeros((), dtype=torch.uint8, device=dev)


def base64_encode(col: StringColumn) -> StringColumn:
    """base64(bin): 3 source bytes -> 4 output chars, '=' padded."""
    dev = col.device
    lens = string_lengths(col)
    out_lens = ((lens + 2) // 3) * 4
    new_off = _rebuild_offsets(torch.where(col.validity, out_lens, 0))
    # worst case: ceil(len / 3) * 4 <= 4 * len / 3 + 4 per row
    out_cap = bucket_capacity(
        max((col.byte_capacity * 4) // 3 + 4 * col.capacity, 1))
    opos, row, j = _row_of_byte(new_off, out_cap, col.capacity)
    rowl = row.long()
    g, k = j // 4, j % 4                 # 4-char group, char index
    src0 = col.offsets[rowl] + 3 * g
    rlen = lens[rowl]

    def byte_at(off: int):
        ok = (3 * g + off) < rlen
        p = torch.clamp(src0 + off, 0, col.byte_capacity - 1).long()
        return torch.where(ok, col.data[p].to(torch.int32), 0), ok

    b0, _ = byte_at(0)
    b1, ok1 = byte_at(1)
    b2, ok2 = byte_at(2)
    sextet = torch.where(
        k == 0, b0 >> 2, torch.where(
            k == 1, ((b0 & 3) << 4) | (b1 >> 4), torch.where(
                k == 2, ((b1 & 15) << 2) | (b2 >> 6), b2 & 63)))
    ch = _byte_table(_B64, dev)[torch.clamp(sextet, 0, 63).long()]
    # '=' padding: char 2 pads without byte 1, char 3 without byte 2
    pad = ((k == 2) & ~ok1) | ((k == 3) & ~ok2)
    ch = torch.where(pad, ord("="), ch).to(torch.uint8)
    in_use = opos < new_off[-1]
    return StringColumn(torch.where(in_use, ch, _zero(dev)), new_off,
                        col.validity, STRING)


def _b64_val(b: torch.Tensor) -> torch.Tensor:
    bi = b.to(torch.int32)
    v = torch.full_like(bi, -1)
    v = torch.where((bi >= 65) & (bi <= 90), bi - 65, v)
    v = torch.where((bi >= 97) & (bi <= 122), bi - 97 + 26, v)
    v = torch.where((bi >= 48) & (bi <= 57), bi - 48 + 52, v)
    v = torch.where(bi == ord("+"), 62, v)
    return torch.where(bi == ord("/"), 63, v)


def base64_decode(col: StringColumn) -> StringColumn:
    """unbase64(str) -> BINARY; null on malformed input (a non-alphabet
    char, one dangling data char, '=' other than at the tail). The tail is
    lenient as Spark's UnBase64: a final group of 2 or 3 data chars
    decodes with 0-2 trailing '='."""
    cap = col.capacity
    bcap = col.byte_capacity
    dev = col.device
    lens = string_lengths(col)
    data = col.data
    _, row, intra, in_use = _col_bytes(col)
    is_pad = (data == ord("=")) & in_use
    val = _b64_val(data)
    pad_cnt = _segment(is_pad.to(torch.int32), row, cap, "sum")
    # an empty row's maximum is the identity: clamp it to -1
    last_non_pad = torch.clamp(_segment(
        torch.where(in_use & ~is_pad, intra, -1), row, cap, "amax"), min=-1)
    pads_at_tail = last_non_pad + 1 + pad_cnt == lens
    bad_char = _segment((in_use & ~is_pad & (val < 0)).to(torch.int32), row,
                        cap, "amax") > 0
    rem = (lens - pad_cnt) % 4
    ok = col.validity & (rem != 1) & (pad_cnt <= 2) & pads_at_tail \
        & ~bad_char
    n_data = lens - pad_cnt
    out_lens = torch.where(ok, (n_data * 3) // 4, 0)
    new_off = _rebuild_offsets(out_lens)
    out_cap = bucket_capacity(max(bcap, 1))
    opos, orow, j = _row_of_byte(new_off, out_cap, cap)
    g, k = j // 3, j % 3
    src0 = col.offsets[orow.long()] + 4 * g

    def v_at(off: int):
        p = torch.clamp(src0 + off, 0, bcap - 1).long()
        return torch.clamp(_b64_val(data[p]), 0, 63)

    v0, v1, v2, v3 = v_at(0), v_at(1), v_at(2), v_at(3)
    byte = torch.where(k == 0, (v0 << 2) | (v1 >> 4), torch.where(
        k == 1, ((v1 & 15) << 4) | (v2 >> 2), ((v2 & 3) << 6) | v3))
    in_use_o = opos < new_off[-1]
    return StringColumn(torch.where(in_use_o, byte.to(torch.uint8),
                                    _zero(dev)), new_off, ok, BINARY)


def hex_encode(col: StringColumn) -> StringColumn:
    """hex(str/bin): two uppercase hex chars per byte."""
    dev = col.device
    lens = string_lengths(col)
    new_off = _rebuild_offsets(torch.where(col.validity, lens * 2, 0))
    out_cap = bucket_capacity(max(col.byte_capacity * 2, 1))
    opos, row, j = _row_of_byte(new_off, out_cap, col.capacity)
    src = torch.clamp(col.offsets[row.long()] + j // 2, 0,
                      col.byte_capacity - 1).long()
    b = col.data[src].to(torch.int32)
    nib = torch.where(j % 2 == 0, b >> 4, b & 15)
    ch = _byte_table(_HEXU, dev)[torch.clamp(nib, 0, 15).long()]
    in_use = opos < new_off[-1]
    return StringColumn(torch.where(in_use, ch, _zero(dev)), new_off,
                        col.validity, STRING)


def hex_encode_long(col: Column) -> StringColumn:
    """hex(long): minimal-width uppercase hex of the UNSIGNED 64-bit
    pattern (Spark: hex(-1) = 'FFFFFFFFFFFFFFFF'). The digit count is the
    highest non-zero nibble's index + 1 (a negative value has 16): the
    bits from nibble d-1 up, masked after the arithmetic shift."""
    dev = col.device
    cap = col.capacity
    u = col.data.to(torch.int64)
    ndig = torch.ones(cap, dtype=torch.int32, device=dev)
    for d in range(2, 17):
        nz = ((u >> (4 * (d - 1))) & ((1 << (4 * (17 - d))) - 1)) != 0
        ndig = torch.where(nz, d, ndig)
    new_off = _rebuild_offsets(torch.where(col.validity, ndig, 0))
    out_cap = bucket_capacity(max(cap * 16, 1))
    opos, row, j = _row_of_byte(new_off, out_cap, cap)
    rowl = row.long()
    shift = torch.clamp((ndig[rowl] - 1 - j) * 4, 0, 63).to(torch.int64)
    # an arithmetic shift, masked to the nibble: the same bits a logical
    # shift of the u64 pattern gives
    nib = (u[rowl] >> shift) & 15
    ch = _byte_table(_HEXU, dev)[nib]
    in_use = opos < new_off[-1]
    return StringColumn(torch.where(in_use, ch, _zero(dev)), new_off,
                        col.validity, STRING)


def hex_decode(col: StringColumn) -> StringColumn:
    """unhex(str) -> BINARY; an odd length gets an implicit leading 0;
    null on any non-hex character (Spark)."""
    cap = col.capacity
    bcap = col.byte_capacity
    dev = col.device
    lens = string_lengths(col)
    data = col.data
    _, row, _, in_use = _col_bytes(col)
    bad = _segment((in_use & (hex_digit_val(data) < 0)).to(torch.int32),
                   row, cap, "amax") > 0
    ok = col.validity & ~bad
    new_off = _rebuild_offsets(torch.where(ok, (lens + 1) // 2, 0))
    out_cap = bucket_capacity(max(bcap, 1))
    opos, orow, j = _row_of_byte(new_off, out_cap, cap)
    orowl = orow.long()
    odd = (lens[orowl] % 2) == 1
    # the source chars of output byte j: (2j-1, 2j) when odd (char -1 is
    # the implicit leading 0), else (2j, 2j+1)
    i_hi = torch.where(odd, 2 * j - 1, 2 * j)
    i_lo = torch.where(odd, 2 * j, 2 * j + 1)
    base = col.offsets[orowl]
    hi = torch.where(i_hi >= 0, torch.clamp(hex_digit_val(
        data[torch.clamp(base + i_hi, 0, bcap - 1).long()]), 0, 15), 0)
    lo = torch.clamp(hex_digit_val(
        data[torch.clamp(base + i_lo, 0, bcap - 1).long()]), 0, 15)
    byte = ((hi << 4) | lo).to(torch.uint8)
    in_use_o = opos < new_off[-1]
    return StringColumn(torch.where(in_use_o, byte, _zero(dev)), new_off, ok,
                        BINARY)
