"""The delimiter-driven string family — the counterpart of
spark_rapids_tpu/ops/string_split.py: `find_in_set`, `substring_index`
and `split_literal` (reference stringFunctions.scala over cuDF string
kernels). Byte-parallel over the (offsets, bytes) layout: delimiter
occurrences are a byte mask (ops/strings.select_literal_hits), per-row
ranks come from segmented cumsums, and the result is a span gather
(split's, an array<string> ArrayColumn).
"""

from __future__ import annotations

import torch

from ..columnar.column import (ArrayColumn, Column, StringColumn,
                               bucket_capacity)
from ..types import INT, STRING, ArrayType
from .strings import (_BIG, _col_bytes, _rebuild_offsets, _segment,
                      _substring_gather, seg_incl_cumsum,
                      select_literal_hits, string_lengths)


def find_in_set(needle: StringColumn, sets: StringColumn) -> Column:
    """1-based index of `needle` among the comma-separated elements of
    `sets`; 0 when absent or when the needle contains a comma."""
    cap = sets.capacity
    byte_cap = sets.byte_capacity
    data = sets.data
    pos, row, _, in_use = _col_bytes(sets)
    row_start = sets.offsets[row]
    row_end = sets.offsets[row + 1]
    nlen = string_lengths(needle)
    nstart = needle.offsets[:-1]
    set_len = string_lengths(sets)

    comma = (data == ord(",")) & in_use
    comma_i = comma.to(torch.int32)
    # element index of each byte = the commas before it in its row
    elem_idx = seg_incl_cumsum(comma_i, row_start) - comma_i
    # start of the element owning each byte: after the last comma before
    last_comma = torch.cummax(torch.where(comma, pos, -1), 0).values
    last_comma = torch.cat([last_comma.new_full((1,), -1), last_comma[:-1]])
    elem_start = torch.maximum(row_start, last_comma + 1)
    off = pos - elem_start

    # per-byte compare against the row's needle at the same offset
    np_idx = torch.clamp(nstart[row] + off, 0, needle.byte_capacity - 1)
    nb = needle.data[np_idx.long()]
    in_nlen = off < nlen[row]
    bad = in_use & ~comma & (~in_nlen | (data != nb))
    bad_csum = torch.cat([bad.new_zeros(1, dtype=torch.int32),
                          torch.cumsum(bad.to(torch.int32), 0,
                                       dtype=torch.int32)])

    # element starts: a row's first byte, or the byte after a comma
    # (which for an empty element is the next comma itself)
    prev = torch.clamp(pos - 1, 0, byte_cap - 1).long()
    es = in_use & ((pos == row_start) | (comma[prev] & (pos > row_start)))
    non = torch.where(comma, pos, _BIG)
    next_comma = torch.flip(torch.cummin(torch.flip(non, [0]), 0).values,
                            [0])
    elem_end = torch.minimum(next_comma, row_end)
    elen = elem_end - pos
    ok = es & (elen == nlen[row]) \
        & (bad_csum[torch.clamp(elem_end, 0, byte_cap).long()]
           - bad_csum[torch.clamp(pos, 0, byte_cap).long()] == 0)
    best = _segment(torch.where(ok, elem_idx, _BIG), row, cap, "amin")

    # a trailing empty element ("a," holds a and ''): exists when the row
    # ends with a comma; its index is the row's comma count
    lastb = torch.clamp(sets.offsets[1:] - 1, 0, byte_cap - 1).long()
    ends_comma = (set_len > 0) & (sets.data[lastb] == ord(","))
    commas_per_row = _segment(comma_i, row, cap, "sum")
    best = torch.where((nlen == 0) & ends_comma,
                       torch.minimum(best, commas_per_row), best)
    # an empty set string holds exactly one empty element
    best = torch.where((set_len == 0) & (nlen == 0), 0, best)
    res = torch.where(best < _BIG, best + 1, 0).to(torch.int32)
    valid = needle.validity & sets.validity
    return Column(torch.where(valid, res, 0), valid, INT)


def substring_index(col: StringColumn, delim: bytes,
                    count: int) -> StringColumn:
    """substring_index(str, delim, count): the prefix before the count-th
    delimiter (count > 0) or the suffix after the |count|-th from the end
    (count < 0); the whole string when there are not enough."""
    cap = col.capacity
    byte_cap = col.byte_capacity
    if not delim or count == 0:
        return _substring_gather(col, col.offsets[:-1],
                                 torch.zeros(cap, dtype=torch.int32,
                                             device=col.device))
    ld = len(delim)
    pos, row, _, _ = _col_bytes(col)
    row_start = col.offsets[row]
    sel = select_literal_hits(col, delim)
    sel_i = sel.to(torch.int32)
    rank = seg_incl_cumsum(sel_i, row_start)  # 1-based
    m = _segment(sel_i, row, cap, "sum")
    starts = col.offsets[:-1]
    lens = string_lengths(col)
    if count > 0:
        cut = _segment(torch.where(sel & (rank == count), pos, _BIG), row,
                       cap, "amin")
        out_start = starts
        out_len = torch.where(m >= count, cut - starts, lens)
    else:
        want = m + count + 1  # 1-based rank of the delimiter to cut after
        cut = _segment(torch.where(sel & (rank == want[row]), pos, _BIG),
                       row, cap, "amin")
        enough = m >= -count
        out_start = torch.where(enough, torch.clamp(cut + ld, 0, byte_cap),
                                starts)
        out_len = torch.where(enough, col.offsets[1:] - out_start, lens)
    return _substring_gather(col, out_start.to(torch.int32),
                             out_len.to(torch.int32))


def split_literal(col: StringColumn, delim: bytes, limit: int) -> ArrayColumn:
    """split(str, delim, limit) for a literal delimiter, with Java's
    semantics: limit > 0 caps the part count, limit == 0 strips trailing
    empty parts, a negative limit keeps everything. The child's offsets
    take the JAX package's bucket (bytes + rows parts at most), its bytes
    the input's byte bucket."""
    cap = col.capacity
    byte_cap = col.byte_capacity
    dev = col.device
    out_t = ArrayType(STRING)
    if not delim or limit == 1:
        # no split: row i is the 1-element array of child row i
        return ArrayColumn(StringColumn(col.data, col.offsets, col.validity,
                                        col.dtype),
                           torch.arange(cap + 1, dtype=torch.int32,
                                        device=dev), col.validity, out_t)
    ld = len(delim)
    pos, row, _, _ = _col_bytes(col)
    row_start = col.offsets[row]
    sel = select_literal_hits(col, delim) & col.validity[row]
    rank = seg_incl_cumsum(sel.to(torch.int32), row_start)  # 1-based
    if limit > 0:
        sel = sel & (rank <= limit - 1)
        rank = torch.clamp(rank, max=limit - 1)
    m = _segment(sel.to(torch.int32), row, cap, "sum")
    n_parts = torch.where(col.validity, m + 1, 0).to(torch.int32)
    arr_off = _rebuild_offsets(n_parts)
    part_cap = byte_cap + cap  # m + 1 parts a row, m <= its bytes

    def scatter(gid, values):
        # gid == part_cap drops the write (the JAX package's mode="drop")
        out = torch.zeros(part_cap + 1, dtype=torch.int32, device=dev)
        out[gid.long()] = values.to(torch.int32)
        return out[:part_cap]

    # part k >= 1 starts after the k-th delimiter; part k - 1 ends at it;
    # part 0 starts at the row's start, the last part ends at its end
    starts = torch.where(col.validity, arr_off[:-1], part_cap)
    lasts = torch.where(col.validity, arr_off[:-1] + m, part_cap)
    hit_gid = torch.where(sel, arr_off[row] + rank, part_cap)
    prev_gid = torch.where(sel, arr_off[row] + rank - 1, part_cap)
    p_start = scatter(torch.cat([hit_gid, starts]),
                      torch.cat([pos + ld, col.offsets[:-1]]))
    p_end = scatter(torch.cat([prev_gid, lasts]),
                    torch.cat([pos, col.offsets[1:]]))
    p_len = torch.clamp(p_end - p_start, min=0)
    total_parts = arr_off[cap]
    if limit == 0:
        # strip each row's trailing empty parts
        pids = torch.arange(part_cap, dtype=torch.int32, device=dev)
        prow = torch.clamp(torch.searchsorted(arr_off, pids, right=True) - 1,
                           0, cap - 1)
        nonempty = (pids < total_parts) & (p_len > 0)
        last_ne = _segment(torch.where(nonempty, pids - arr_off[prow], -1),
                           prow, cap, "amax")
        n_parts = torch.where(col.validity, last_ne + 1, 0).to(torch.int32)
        new_off = _rebuild_offsets(n_parts)
        nrow = torch.clamp(torch.searchsorted(new_off, pids, right=True) - 1,
                           0, cap - 1)
        old_gid = torch.clamp(arr_off[nrow] + (pids - new_off[nrow]), 0,
                              part_cap - 1).long()
        p_start, p_len = p_start[old_gid], p_len[old_gid]
        arr_off = new_off
        total_parts = arr_off[cap]
    # the child's bytes: each part's span, in part order
    child_off = _rebuild_offsets(p_len)
    tp = torch.clamp(total_parts, 0, part_cap).long()
    opos = torch.arange(byte_cap, dtype=torch.int32, device=dev)
    src_part = torch.clamp(torch.searchsorted(child_off, opos, right=True)
                           - 1, 0, part_cap - 1)
    src = torch.clamp(p_start[src_part] + opos - child_off[src_part], 0,
                      byte_cap - 1)
    cdata = torch.where(opos < child_off[tp], col.data[src.long()], 0) \
        .to(torch.uint8)
    ccap = bucket_capacity(max(part_cap, 1))
    c_idx = torch.arange(ccap + 1, dtype=torch.int32, device=dev)
    c_off = torch.zeros(ccap + 1, dtype=torch.int32, device=dev)
    c_off[: part_cap + 1] = child_off
    c_off = torch.where(c_idx > total_parts, child_off[tp], c_off)
    child = StringColumn(cdata, c_off, c_idx[:ccap] < total_parts, STRING)
    return ArrayColumn(child, arr_off, col.validity, out_t)
