"""Varlen (string/binary) ops over the (offsets, bytes) layout — the
counterpart of spark_rapids_tpu/ops/strings.py.

Every op is dense over a static byte capacity: for each output byte,
`torch.searchsorted` on the output offsets finds its row
(`_row_of_byte`), so a row gather of strings is two gathers, and every
elementwise string function is a handful of byte-parallel torch ops with
segment reductions (`scatter_reduce_`) per row. The output byte
capacities are the JAX package's static formulas (the input's bucket, or
its worst case for pad, repeat, replace and the concatenations), so a
column built here packs and frames exactly as the reference's does; no
output size reads the data.

The JAX package runs three loops whose trip count lives on the device
(`lax.while_loop`): the byte-wise compare of two string columns, and the
greedy selection of a self-overlapping literal's hits. Eager torch has no
device loop: each takes its bound from ONE host read per call (the
longest common prefix, the most raw hits in a row), counted in
`counters()["host_reads"]` as ops/hashing.py's string loops take theirs
(ROADMAP C.6). Equality compares byte spans through
columnar/encoded.bytes_equal_rows, with no loop and no read.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..columnar.column import Column, StringColumn, bucket_capacity
from ..types import BOOLEAN, INT, StringType

#: the sentinel of "no position" in segment minima (the JAX package's)
_BIG = 1 << 30
_I32_MAX = (1 << 31) - 1
_I32_MIN = -(1 << 31)

_COUNTS: Dict[str, int] = {"host_reads": 0}


def counters() -> Dict[str, int]:
    """Host reads taken by the string loops' bounds since the last reset."""
    return dict(_COUNTS)


def reset_counters() -> None:
    _COUNTS["host_reads"] = 0


def host_int(t: torch.Tensor) -> int:
    """One counted host read of a device scalar."""
    _COUNTS["host_reads"] += 1
    return int(t)


def string_lengths(col: StringColumn) -> torch.Tensor:
    """int32 (capacity,): byte length per row (0 for inactive rows)."""
    return col.offsets[1:] - col.offsets[:-1]


def _rebuild_offsets(lengths: torch.Tensor) -> torch.Tensor:
    """Exclusive scan of int32 lengths into (capacity + 1,) offsets."""
    return torch.cat([lengths.new_zeros(1, dtype=torch.int32),
                      torch.cumsum(lengths, 0, dtype=torch.int32)])


def _row_of_byte(offsets: torch.Tensor, byte_cap: int, rows: int):
    """(position, row, intra-row position) of each of `byte_cap` bytes laid
    out by `offsets`: the last row whose start is <= the byte's position,
    clipped into [0, rows)."""
    pos = torch.arange(byte_cap, dtype=torch.int32, device=offsets.device)
    row = torch.searchsorted(offsets, pos, right=True).to(torch.int32) - 1
    row = torch.clamp(row, 0, rows - 1)
    return pos, row, pos - offsets[row.long()]


def _col_bytes(col: StringColumn):
    """(position, row (int64), intra, in_use) of every byte of `col`."""
    pos, row, intra = _row_of_byte(col.offsets, col.byte_capacity,
                                   col.capacity)
    return pos, row.long(), intra, pos < col.offsets[-1]


def _segment(values: torch.Tensor, row: torch.Tensor, n: int,
             reduce: str) -> torch.Tensor:
    """jax.ops.segment_{sum,min,max} over int64 segment ids: a segment
    with no element keeps the identity (0, the int32 max, the int32
    min), as XLA's does."""
    init = {"sum": 0, "amin": _I32_MAX, "amax": _I32_MIN}[reduce]
    out = torch.full((n,), init, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, row, values, reduce=reduce)


def _u8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint8)


def _zero_u8(dev) -> torch.Tensor:
    return torch.zeros((), dtype=torch.uint8, device=dev)


def device_constant(arr: np.ndarray, device) -> torch.Tensor:
    """A small constant table (a pad, a byte map, a regex program's masks)
    on `device`, uploaded once per process and device: an upload from
    pageable memory synchronises the host. Callers never write to it."""
    return _constant(arr.tobytes(), arr.dtype.str, arr.shape, str(device))


@functools.lru_cache(maxsize=512)
def _constant(data: bytes, dtype: str, shape: tuple, device: str):
    arr = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(arr.copy()).to(device)


def _byte_table(b: bytes, dev) -> torch.Tensor:
    return device_constant(np.frombuffer(b or b"\0", np.uint8), dev)


def hex_digit_val(b: torch.Tensor) -> torch.Tensor:
    """Value of an ASCII hex digit byte; -1 for a non-hex byte."""
    bi = b.to(torch.int32)
    v = torch.full_like(bi, -1)
    v = torch.where((bi >= 48) & (bi <= 57), bi - 48, v)
    v = torch.where((bi >= 97) & (bi <= 102), bi - 97 + 10, v)
    return torch.where((bi >= 65) & (bi <= 70), bi - 65 + 10, v)


def seg_incl_cumsum(x: torch.Tensor, row_start_pos: torch.Tensor):
    """Per-row inclusive cumsum of int32 x over a flat byte buffer: the
    global cumsum minus the exclusive cumsum at each byte's row start."""
    c = torch.cumsum(x, 0, dtype=torch.int32)
    return c - (c - x)[row_start_pos.long()]


def gather_string(col: StringColumn, indices: torch.Tensor,
                  out_valid: torch.Tensor,
                  out_byte_capacity: Optional[int] = None) -> StringColumn:
    """Gather rows of a string column by pre-clamped int32 `indices`.

    out_byte_capacity: the result's byte bucket. Defaults to the input's
    (enough for any permutation or filter; gathers that duplicate rows
    pass a larger one)."""
    byte_cap = out_byte_capacity or col.byte_capacity
    idx = indices.long()
    lengths = torch.where(out_valid, string_lengths(col)[idx], 0)
    new_offsets = _rebuild_offsets(lengths)
    src_starts = col.offsets[idx]
    pos, row, intra = _row_of_byte(new_offsets, byte_cap, indices.shape[0])
    src_pos = src_starts[row.long()] + intra
    in_use = pos < new_offsets[-1]
    src_pos = torch.where(in_use,
                          torch.clamp(src_pos, 0, col.byte_capacity - 1), 0)
    data = torch.where(in_use, col.data[src_pos.long()], 0).to(torch.uint8)
    return StringColumn(data, new_offsets, out_valid, col.dtype)


def concat_string(a: StringColumn, b: StringColumn, a_rows, b_rows,
                  out_capacity: int,
                  out_byte_capacity: Optional[int] = None) -> StringColumn:
    """Concatenate the active rows of two string columns."""
    byte_cap = out_byte_capacity or (a.byte_capacity + b.byte_capacity)
    idx = torch.arange(out_capacity, dtype=torch.int32, device=a.device)
    from_b = idx >= a_rows
    out_valid_slot = idx < a_rows + b_rows
    a_idx = torch.where(idx < a.capacity, idx, 0).long()
    b_idx = torch.clamp(idx - a_rows, 0, b.capacity - 1).long()
    lengths = torch.where(from_b, string_lengths(b)[b_idx],
                          string_lengths(a)[a_idx])
    lengths = torch.where(out_valid_slot, lengths, 0)
    validity = torch.where(from_b, b.validity[b_idx], a.validity[a_idx]) \
        & out_valid_slot
    new_offsets = _rebuild_offsets(lengths)
    src_starts = torch.where(from_b, b.offsets[b_idx], a.offsets[a_idx])
    pos, row, intra = _row_of_byte(new_offsets, byte_cap, out_capacity)
    rl = row.long()
    src_pos = src_starts[rl] + intra
    row_from_b = from_b[rl]
    in_use = pos < new_offsets[-1]
    a_pos = torch.where(in_use & ~row_from_b,
                        torch.clamp(src_pos, 0, a.byte_capacity - 1), 0)
    b_pos = torch.where(in_use & row_from_b,
                        torch.clamp(src_pos, 0, b.byte_capacity - 1), 0)
    data = torch.where(row_from_b, b.data[b_pos.long()], a.data[a_pos.long()])
    data = torch.where(in_use, data, 0).to(torch.uint8)
    return StringColumn(data, new_offsets, validity, a.dtype)


# -- elementwise string functions ----------------------------------------

def str_length_bytes(col: StringColumn) -> Column:
    return Column(string_lengths(col), col.validity, INT)


def str_length_chars(col: StringColumn) -> Column:
    """UTF-8 character count (Spark `length`): the bytes that are not
    continuation bytes ((b & 0xC0) != 0x80), summed per row by a prefix
    sum read at the row bounds."""
    is_start = ((col.data & 0xC0) != 0x80).to(torch.int32)
    csum = torch.cat([is_start.new_zeros(1),
                      torch.cumsum(is_start, 0, dtype=torch.int32)])
    counts = csum[col.offsets[1:].long()] - csum[col.offsets[:-1].long()]
    return Column(counts, col.validity, INT)


def str_upper_ascii(col: StringColumn) -> StringColumn:
    lower = (col.data >= ord("a")) & (col.data <= ord("z"))
    data = torch.where(lower, col.data - 32, col.data)
    return StringColumn(data, col.offsets, col.validity, col.dtype)


def str_lower_ascii(col: StringColumn) -> StringColumn:
    upper = (col.data >= ord("A")) & (col.data <= ord("Z"))
    data = torch.where(upper, col.data + 32, col.data)
    return StringColumn(data, col.offsets, col.validity, col.dtype)


def substring(col: StringColumn, start: int,
              length: Optional[int]) -> StringColumn:
    """Spark substring over bytes: 1-based start, a negative start counts
    from the end, a start of 0 is the first byte."""
    lens = string_lengths(col)
    if start > 0:
        begin = torch.clamp(lens, max=start - 1)
    elif start == 0:
        begin = torch.zeros_like(lens)
    else:
        begin = torch.clamp(lens + start, min=0)
    if length is None:
        sub_len = lens - begin
    else:
        sub_len = torch.minimum(torch.full_like(lens, max(length, 0)),
                                lens - begin)
    return _substring_gather(col, col.offsets[:-1] + begin, sub_len)


def _substring_gather(col: StringColumn, src_starts: torch.Tensor,
                      lengths: torch.Tensor) -> StringColumn:
    """Each row's span [src_starts, src_starts + lengths) of `col`'s own
    bytes, into the input's byte bucket (a span never outgrows its
    row)."""
    lengths = torch.where(col.validity, lengths, 0)
    new_offsets = _rebuild_offsets(lengths)
    byte_cap = col.byte_capacity
    pos, row, intra = _row_of_byte(new_offsets, byte_cap, col.capacity)
    src_pos = src_starts[row.long()] + intra
    in_use = pos < new_offsets[-1]
    src_pos = torch.where(in_use, torch.clamp(src_pos, 0, byte_cap - 1), 0)
    data = torch.where(in_use, col.data[src_pos.long()], 0).to(torch.uint8)
    return StringColumn(data, new_offsets, col.validity, col.dtype)


def _match_at(col: StringColumn, needle: bytes,
              starts: torch.Tensor) -> torch.Tensor:
    """Bool per element of `starts`: the needle matches at that absolute
    byte position."""
    ok = torch.ones(starts.shape, dtype=torch.bool, device=col.device)
    for j, ch in enumerate(needle):
        p = torch.clamp(starts + j, 0, col.byte_capacity - 1).long()
        ok = ok & (col.data[p] == ch)
    return ok


def str_starts_with(col: StringColumn, prefix: bytes) -> Column:
    lens = string_lengths(col)
    ok = (lens >= len(prefix)) & _match_at(col, prefix, col.offsets[:-1])
    return Column(ok, col.validity, BOOLEAN)


def str_ends_with(col: StringColumn, suffix: bytes) -> Column:
    lens = string_lengths(col)
    ok = (lens >= len(suffix)) & _match_at(col, suffix,
                                           col.offsets[1:] - len(suffix))
    return Column(ok, col.validity, BOOLEAN)


def _window_hits(col: StringColumn, needle: bytes, pos, row):
    """Bool per byte: the needle starts there and ends inside its row."""
    hit = _match_at(col, needle, pos)
    return hit & ((pos + len(needle)) <= col.offsets[row + 1])


def str_contains(col: StringColumn, needle: bytes) -> Column:
    """Substring search: a needle-length window test at every byte, kept
    where the window stays inside its row, counted per row through a
    prefix sum. O(bytes * |needle|)."""
    if not needle:
        return Column(torch.ones(col.capacity, dtype=torch.bool,
                                 device=col.device), col.validity, BOOLEAN)
    pos, row, _, _ = _col_bytes(col)
    hit = _window_hits(col, needle, pos, row).to(torch.int32)
    csum = torch.cat([hit.new_zeros(1), torch.cumsum(hit, 0,
                                                     dtype=torch.int32)])
    cap = col.byte_capacity
    per_row = (csum[torch.clamp(col.offsets[1:], max=cap).long()]
               - csum[torch.clamp(col.offsets[:-1], max=cap).long()]) > 0
    return Column(per_row, col.validity, BOOLEAN)


def str_trim(col: StringColumn, side: str = "both",
             trim_chars: bytes = b" \t\n\r\x0b\x0c") -> StringColumn:
    """trim/ltrim/rtrim (reference GpuStringTrim): the span between the
    first and the last byte outside `trim_chars`."""
    if side not in ("both", "left", "right"):
        raise ValueError(f"trim side {side!r}")
    lens = string_lengths(col)
    _, row, intra, in_use = _col_bytes(col)
    is_trim = torch.zeros_like(in_use)
    for ch in trim_chars:
        is_trim = is_trim | (col.data == ch)
    non_trim = in_use & ~is_trim
    first_non = _segment(torch.where(non_trim, intra, _BIG), row,
                         col.capacity, "amin")
    last_non = _segment(torch.where(non_trim, intra, -1), row,
                        col.capacity, "amax")
    lead = torch.minimum(first_non, lens)
    # a byte-less row's max is the identity: clamp it to "all trimmed"
    end = torch.minimum(torch.clamp(last_non.to(torch.int64) + 1, min=0),
                        lens).to(torch.int32)
    if side == "left":
        start, new_len = lead, lens - lead
    elif side == "right":
        start, new_len = torch.zeros_like(lens), end
    else:
        start, new_len = lead, torch.clamp(end - lead, min=0)
    return _substring_gather(col, col.offsets[:-1] + start, new_len)


def str_pad(col: StringColumn, target: int, pad: bytes,
            side: str) -> StringColumn:
    """lpad/rpad with byte semantics (reference GpuStringLPad/RPad): rows
    longer than `target` truncate to it; an empty pad keeps short rows.
    Byte bucket: capacity x target, the JAX package's worst case."""
    if side not in ("left", "right"):
        raise ValueError(f"pad side {side!r}")
    target = max(target, 0)
    lens = string_lengths(col)
    if pad:
        out_lens = torch.full_like(lens, target)
    else:
        out_lens = torch.clamp(lens, max=target)
    out_lens = torch.where(col.validity, out_lens, 0)
    new_offsets = _rebuild_offsets(out_lens)
    byte_cap = bucket_capacity(max(col.capacity * max(target, 1), 1))
    pos, row, intra = _row_of_byte(new_offsets, byte_cap, col.capacity)
    rowl = row.long()
    in_use = pos < new_offsets[-1]
    rl = lens[rowl]
    pad_arr = _byte_table(pad, col.device)
    lp = max(len(pad), 1)
    if side == "left":
        pad_n = torch.clamp(target - rl, min=0) if pad \
            else torch.zeros_like(rl)
        from_pad = intra < pad_n
        src_intra = intra - pad_n
        pad_idx = intra % lp
    else:
        from_pad = (intra >= rl) if pad else torch.zeros_like(in_use)
        src_intra = intra
        pad_idx = (intra - rl) % lp
    pad_byte = pad_arr[torch.where(from_pad, pad_idx, 0).long()]
    src_pos = torch.clamp(col.offsets[rowl] + torch.clamp(src_intra, min=0),
                          0, col.byte_capacity - 1)
    data = torch.where(in_use, torch.where(from_pad, pad_byte,
                                           col.data[src_pos.long()]),
                       _zero_u8(col.device))
    return StringColumn(data, new_offsets, col.validity, col.dtype)


def str_repeat(col: StringColumn, n: int) -> StringColumn:
    """repeat(str, n) (reference GpuStringRepeat); byte bucket: the
    input's times n."""
    n = max(int(n), 0)
    lens = string_lengths(col)
    new_offsets = _rebuild_offsets(lens * n)
    byte_cap = bucket_capacity(max(col.byte_capacity * max(n, 1), 1))
    pos, row, intra = _row_of_byte(new_offsets, byte_cap, col.capacity)
    rowl = row.long()
    in_use = pos < new_offsets[-1]
    rl = torch.clamp(lens[rowl], min=1)
    src = torch.clamp(col.offsets[rowl] + intra % rl, 0,
                      col.byte_capacity - 1)
    data = torch.where(in_use, col.data[src.long()], _zero_u8(col.device))
    return StringColumn(data, new_offsets, col.validity, col.dtype)


def str_reverse(col: StringColumn) -> StringColumn:
    """reverse(str) in byte order: exact for ASCII; a multi-byte UTF-8
    character comes out byte-reversed, as in the JAX package (ROADMAP
    C.5)."""
    lens = string_lengths(col)
    _, row, intra, in_use = _col_bytes(col)
    src = torch.clamp(col.offsets[row] + lens[row] - 1 - intra, 0,
                      col.byte_capacity - 1)
    data = torch.where(in_use, col.data[src.long()], _zero_u8(col.device))
    return StringColumn(data, col.offsets, col.validity, col.dtype)


def str_initcap(col: StringColumn) -> StringColumn:
    """initcap: the first ASCII letter of each word (after a row start,
    space, tab, newline or carriage return) upper case, the rest lower."""
    cap = col.byte_capacity
    pos, row, _, _ = _col_bytes(col)
    at_start = pos == col.offsets[row]
    prev = col.data[torch.clamp(pos - 1, 0, cap - 1).long()]
    prev_is_space = (prev == 32) | (prev == 9) | (prev == 10) | (prev == 13)
    word_start = at_start | prev_is_space
    b = col.data
    up = torch.where((b >= 97) & (b <= 122), b - 32, b)
    low = torch.where((b >= 65) & (b <= 90), b + 32, b)
    return StringColumn(torch.where(word_start, up, low), col.offsets,
                        col.validity, col.dtype)


def str_locate(col: StringColumn, needle: bytes, start: int = 1) -> Column:
    """locate/instr/position: the 1-based byte index of the first
    occurrence at or after the 1-based `start`, 0 if absent (Java
    String.indexOf, which Spark delegates to)."""
    lens = string_lengths(col)
    start0 = max(int(start) - 1, 0)
    if not needle:
        # Java indexOf("", from) = min(max(from, 0), len)
        res = torch.clamp(lens, max=start0) + 1
        return Column(res.to(torch.int32), col.validity, INT)
    pos, row, intra, in_use = _col_bytes(col)
    ok = _window_hits(col, needle, pos, row) & (intra >= start0) & in_use
    first = _segment(torch.where(ok, intra, _BIG), row, col.capacity, "amin")
    res = torch.where(first >= _BIG, 0, first + 1)
    return Column(res.to(torch.int32), col.validity, INT)


def _needle_has_border(needle: bytes) -> bool:
    return any(needle[:k] == needle[len(needle) - k:]
               for k in range(1, len(needle)))


def greedy_select(col: StringColumn, hits: torch.Tensor, width: int,
                  row: torch.Tensor, intra: torch.Tensor) -> torch.Tensor:
    """Byte mask of Java's left-to-right non-overlapping choice among
    `hits` (matches of `width` bytes): per row, a cursor jumps to the next
    hit at or after it and past its match. The JAX package loops while any
    cursor moves; here the loop runs the most raw hits any row holds,
    taken by one counted host read (a row of k hits needs at most k
    jumps)."""
    byte_cap = col.byte_capacity
    cap = col.capacity
    per_row = _segment(hits.to(torch.int32), row, cap, "sum")
    trips = host_int(per_row.max()) if cap else 0
    cursor = torch.zeros(cap, dtype=torch.int32, device=col.device)
    sel = torch.zeros(byte_cap + 1, dtype=torch.bool, device=col.device)
    starts = col.offsets[:-1]
    for _ in range(trips):
        cand = torch.where(hits & (intra >= cursor[row]), intra, _BIG)
        nxt = _segment(cand, row, cap, "amin")
        found = nxt < _BIG
        # rows with no further hit write the spare slot (the JAX
        # package's dropped out-of-bounds scatter)
        sel_pos = torch.where(found, starts + nxt, byte_cap)
        sel[sel_pos.long()] = True
        cursor = torch.where(found, nxt + width, _BIG).to(torch.int32)
    return sel[:byte_cap] & hits


def select_literal_hits(col: StringColumn, search: bytes) -> torch.Tensor:
    """Byte mask of the greedy non-overlapping left-to-right occurrences
    of the literal `search` (Java String.split/replace). A needle with no
    proper border cannot overlap itself, so every raw hit is selected;
    a bordered needle (e.g. "aa") runs `greedy_select`."""
    pos, row, intra, in_use = _col_bytes(col)
    hit = _window_hits(col, search, pos, row) & in_use
    if _needle_has_border(search):
        return greedy_select(col, hit, len(search), row, intra)
    return hit


def _emit_gather(col: StringColumn, emit: torch.Tensor, row, out_lens,
                 out_byte_cap: int):
    """Shared tail of the byte-rewriting ops: source byte of every output
    byte when each input byte emits `emit` bytes. Returns (new offsets,
    source byte index, index within the emission, output in use)."""
    byte_cap = col.byte_capacity
    out_lens = torch.where(col.validity, out_lens, 0)
    new_offsets = _rebuild_offsets(out_lens)
    emit_start = torch.cat([emit.new_zeros(1),
                            torch.cumsum(emit, 0, dtype=torch.int32)])
    opos = torch.arange(out_byte_cap, dtype=torch.int32, device=col.device)
    src = torch.clamp(torch.searchsorted(emit_start, opos, right=True)
                      .to(torch.int32) - 1, 0, byte_cap - 1)
    k = opos - emit_start[src.long()]
    return new_offsets, src.long(), k, opos < new_offsets[-1]


def str_replace(col: StringColumn, search: bytes,
                replacement: bytes) -> StringColumn:
    """replace(str, search, replace): non-overlapping left-to-right literal
    replacement (reference GpuStringReplace). Byte bucket: the input's
    when the replacement is no longer than the search, else the JAX
    package's worst case ((bytes // |search| + 1) x |replacement|)."""
    if not search:
        return col
    ls, lr = len(search), len(replacement)
    byte_cap = col.byte_capacity
    pos, row, _, in_use = _col_bytes(col)
    selected = select_literal_hits(col, search)
    # emit: 1 per plain byte, lr at a match start, 0 inside a match
    sel_csum = torch.cumsum(selected.to(torch.int32), 0, dtype=torch.int32)
    lo = torch.clamp(pos - ls, 0, byte_cap - 1).long()
    prev = torch.clamp(pos - 1, 0, byte_cap - 1).long()
    covered_cnt = torch.where(pos >= 1, sel_csum[prev], 0) \
        - torch.where(pos >= ls, sel_csum[lo], 0)
    covered = (covered_cnt > 0) & ~selected
    emit = torch.where(in_use, 1, 0).to(torch.int32)
    emit = torch.where(selected, lr, emit)
    emit = torch.where(covered, 0, emit).to(torch.int32)
    out_lens = _segment(emit, row, col.capacity, "sum")
    out_byte_cap = byte_cap if lr <= ls else \
        bucket_capacity(max((byte_cap // ls + 1) * lr, byte_cap))
    new_offsets, src, k, out_in_use = _emit_gather(col, emit, row, out_lens,
                                                   out_byte_cap)
    repl = _byte_table(replacement, col.device)
    byte = torch.where(selected[src],
                       repl[torch.clamp(k, 0, max(lr - 1, 0)).long()],
                       col.data[src])
    data = torch.where(out_in_use, byte, _zero_u8(col.device))
    return StringColumn(data, new_offsets, col.validity, col.dtype)


def str_concat_pair(a: StringColumn, b: StringColumn) -> StringColumn:
    """concat(a, b): null if either side is; byte bucket: both inputs'."""
    la, lb = string_lengths(a), string_lengths(b)
    valid = a.validity & b.validity
    new_offsets = _rebuild_offsets(torch.where(valid, la + lb, 0))
    byte_cap = bucket_capacity(max(a.byte_capacity + b.byte_capacity, 1))
    pos, row, intra = _row_of_byte(new_offsets, byte_cap, a.capacity)
    rowl = row.long()
    in_use = pos < new_offsets[-1]
    from_a = intra < la[rowl]
    pa = torch.clamp(a.offsets[rowl] + intra, 0, a.byte_capacity - 1)
    pb = torch.clamp(b.offsets[rowl] + intra - la[rowl], 0,
                     b.byte_capacity - 1)
    data = torch.where(in_use, torch.where(from_a, a.data[pa.long()],
                                           b.data[pb.long()]),
                       _zero_u8(a.device))
    return StringColumn(data, new_offsets, valid, a.dtype)


def str_concat_ws(sep: bytes, cols: Sequence[StringColumn]) -> StringColumn:
    """concat_ws(sep, c1..ck): null children are skipped entirely, the
    separator stands only between present children, never null (Spark).
    Each row is a table of 2k-1 segments [c0, sep, c1, sep, ...]; each
    output byte finds its segment by counting segment ends."""
    k = len(cols)
    cap = cols[0].capacity
    dev = cols[0].device
    lsep = len(sep)
    lens = [torch.where(c.validity, string_lengths(c), 0) for c in cols]
    present = [c.validity for c in cols]
    seg_lens = [lens[0] * present[0]]
    any_before = present[0]
    for i in range(1, k):
        seg_lens.append(torch.where(any_before & present[i], lsep, 0)
                        .to(torch.int32))
        seg_lens.append(torch.where(present[i], lens[i], 0))
        any_before = any_before | present[i]
    seg = torch.stack(seg_lens, dim=1).to(torch.int32)     # (cap, 2k-1)
    seg_ends = torch.cumsum(seg, 1, dtype=torch.int32)
    new_offsets = _rebuild_offsets(seg_ends[:, -1])
    total_in = sum(c.byte_capacity for c in cols) + cap * lsep * (k - 1)
    byte_cap = bucket_capacity(max(total_in, 1))
    pos, row, intra = _row_of_byte(new_offsets, byte_cap, cap)
    rowl = row.long()
    in_use = pos < new_offsets[-1]
    ends = seg_ends[rowl]                                   # (bytes, 2k-1)
    seg_idx = torch.sum(intra[:, None] >= ends, dim=1)
    seg_idx = torch.clamp(seg_idx, 0, 2 * k - 2)
    sidx = seg_idx[:, None]
    seg_start = (torch.gather(ends, 1, sidx)
                 - torch.gather(seg[rowl], 1, sidx))[:, 0]
    local = intra - seg_start
    sep_arr = _byte_table(sep, dev)
    byte = sep_arr[torch.clamp(local, 0, max(lsep - 1, 0)).long()]
    for i, c in enumerate(cols):
        pi = torch.clamp(c.offsets[rowl] + local, 0, c.byte_capacity - 1)
        byte = torch.where(seg_idx == 2 * i, c.data[pi.long()], byte)
    data = torch.where(in_use, byte, _zero_u8(dev))
    return StringColumn(data, new_offsets,
                        torch.ones(cap, dtype=torch.bool, device=dev),
                        cols[0].dtype)


def str_translate(col: StringColumn, from_str: bytes,
                  to_str: bytes) -> StringColumn:
    """translate(str, from, to): a byte map; bytes of `from` past len(to)
    are deleted; the first occurrence in `from` wins (Java)."""
    lut = np.arange(256, dtype=np.uint8)
    keep = np.ones(256, dtype=bool)
    seen = set()
    for i, ch in enumerate(from_str):
        if ch in seen:
            continue
        seen.add(ch)
        if i < len(to_str):
            lut[ch] = to_str[i]
        else:
            keep[ch] = False
    lut_d = device_constant(lut, col.device)
    keep_d = device_constant(keep, col.device)
    _, row, _, in_use = _col_bytes(col)
    emit = (in_use & keep_d[col.data.long()]).to(torch.int32)
    out_lens = _segment(emit, row, col.capacity, "sum")
    new_offsets, src, _, out_in_use = _emit_gather(col, emit, row, out_lens,
                                                   col.byte_capacity)
    data = torch.where(out_in_use, lut_d[col.data[src].long()],
                       _zero_u8(col.device))
    return StringColumn(data, new_offsets, col.validity, col.dtype)


def str_ascii(col: StringColumn) -> Column:
    """ascii(str): the code of the first byte, 0 for an empty row (exact
    for ASCII, as in the JAX package)."""
    lens = string_lengths(col)
    first = col.data[torch.clamp(col.offsets[:-1], 0,
                                 col.byte_capacity - 1).long()]
    res = torch.where(lens > 0, first.to(torch.int32), 0)
    return Column(res.to(torch.int32), col.validity, INT)


def str_chr(codes: Column) -> StringColumn:
    """chr(n): the one-byte string of code n % 256; empty for n <= 0 or a
    code of 0 (Spark's Chr over the ASCII range)."""
    cap = codes.capacity
    n = codes.data.to(torch.int64)
    code = (n % 256).to(torch.int32)
    out_lens = torch.where(codes.validity & (n > 0) & (code > 0), 1, 0)
    new_offsets = _rebuild_offsets(out_lens.to(torch.int32))
    byte_cap = bucket_capacity(max(cap, 1))
    pos, row, _ = _row_of_byte(new_offsets, byte_cap, cap)
    in_use = pos < new_offsets[-1]
    data = torch.where(in_use, _u8(code[row.long()]), _zero_u8(codes.device))
    return StringColumn(data, new_offsets, codes.validity, StringType())


def string_compare_cols(a: StringColumn, b: StringColumn) -> torch.Tensor:
    """Row-wise lexicographic byte compare -> int32 sign (-1/0/1): the
    first differing byte within the common length, else the lengths. The
    loop runs over byte positions, vectorised across rows, up to the
    longest common length (one counted host read)."""
    la = string_lengths(a)
    lb = string_lengths(b)
    min_len = torch.minimum(la, lb)
    trips = host_int(min_len.max()) if min_len.numel() else 0
    sa, sb = a.offsets[:-1], b.offsets[:-1]
    res = torch.zeros(a.capacity, dtype=torch.int32, device=a.device)
    for t in range(trips):
        pa = torch.clamp(sa + t, 0, a.byte_capacity - 1).long()
        pb = torch.clamp(sb + t, 0, b.byte_capacity - 1).long()
        diff = torch.sign(a.data[pa].to(torch.int32)
                          - b.data[pb].to(torch.int32))
        active = (res == 0) & (t < min_len)
        res = torch.where(active, diff, res)
    return torch.where(res == 0, torch.sign(la - lb), res).to(torch.int32)


def string_equal(a: StringColumn, b: StringColumn) -> Column:
    """Row-wise string equality: equal lengths, then equal bytes
    (columnar/encoded.bytes_equal_rows). Null when either side is."""
    from ..columnar.encoded import bytes_equal_rows
    return Column(bytes_equal_rows(a, b), a.validity & b.validity, BOOLEAN)


def string_to_padded(col: StringColumn, width: int):
    """(lengths (cap,), bytes (cap, width)): the fixed-width row-major
    encoding of a string column; rows longer than `width` are cut."""
    lengths = torch.clamp(string_lengths(col), max=width)
    starts = col.offsets[:col.capacity]
    j = torch.arange(width, dtype=torch.int32, device=col.device)
    pos = starts[:, None] + j[None, :]
    in_str = j[None, :] < lengths[:, None]
    safe = torch.where(in_str, torch.clamp(pos, 0, col.byte_capacity - 1), 0)
    padded = torch.where(in_str, col.data[safe.long()], _zero_u8(col.device))
    return lengths, padded


def string_from_padded(lengths: torch.Tensor, padded: torch.Tensor,
                       validity: torch.Tensor, dtype=None) -> StringColumn:
    """Inverse of string_to_padded, into a byte bucket of cap x width."""
    cap, width = padded.shape
    offsets = _rebuild_offsets(torch.where(validity, lengths, 0)
                               .to(torch.int32))
    byte_cap = bucket_capacity(max(cap * width, 1))
    pos, row, intra = _row_of_byte(offsets, byte_cap, cap)
    in_use = pos < offsets[-1]
    safe_intra = torch.clamp(intra, 0, width - 1)
    data = torch.where(in_use, padded[row.long(), safe_intra.long()],
                       _zero_u8(padded.device))
    return StringColumn(data, offsets, validity, dtype or StringType())
