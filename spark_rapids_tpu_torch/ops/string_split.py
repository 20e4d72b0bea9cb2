"""The delimiter-driven string family — the counterpart of
spark_rapids_tpu/ops/string_split.py for `find_in_set` and
`substring_index` (reference stringFunctions.scala over cuDF string
kernels). Byte-parallel over the (offsets, bytes) layout: delimiter
occurrences are a byte mask (ops/strings.select_literal_hits), per-row
ranks come from segmented cumsums, and the result is a span gather.

`split_literal` returns an array<string>, which needs the port's
ArrayColumn: it comes with ROADMAP A.8 wave 3.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column, StringColumn
from ..types import INT
from .strings import (_BIG, _col_bytes, _segment, _substring_gather,
                      seg_incl_cumsum, select_literal_hits, string_lengths)


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
