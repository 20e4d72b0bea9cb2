"""Device get_json_object: byte-parallel JSONPath extraction over the
(offsets, bytes) string layout — the counterpart of spark_rapids_tpu/ops/
json_device.py (reference GpuGetJsonObject.scala over the
spark-rapids-jni JSON scanner).

No per-row state machine: whole-buffer structural masks,

  1. escape parity (the run length of backslashes) -> the real quotes;
  2. quote-count parity per row -> the in-string mask;
  3. the per-row cumsum of bracket deltas outside strings -> the depth;

then the (static, literal) path is walked by narrowing a per-row [lo, hi)
byte span: a `.field` step finds the first direct-child key at the right
depth whose text matches, an `[n]` step the n-th comma at element depth.

Semantics are the JAX package's device path, with its two documented
divergences from its host tier: a scalar number returns its RAW text
('1.00' stays '1.00'), and malformation is structural (unbalanced
brackets, an unterminated string). An object or array result is compacted
(whitespace outside strings dropped); a string result is unescaped,
\\uXXXX and surrogate pairs included, an unpaired surrogate as '?'.

Where the JAX package takes "the next j > i with a mask" by an
associative min-scan, a run's start by a max-scan, and a row's first,
last or n-th match by a segment reduction, the port counts the mask once
(a cumsum) and finds the position it needs by a search of that count
(`torch.searchsorted`): one pass, no scatter, no host read. Inside a
`shared_structures()` block (a projection's evaluation, exec/basic.py)
the masks of one column are built once and shared by every path over it,
and freed when the block ends; the walk's temporaries are freed as each
step ends.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import List, Union

import torch

from ..columnar.column import StringColumn
from .strings import (_BIG, _rebuild_offsets, _row_of_byte, count_set,
                      first_from, kth_set, last_before, span_sums,
                      string_lengths)
_WS = (0x20, 0x09, 0x0A, 0x0D)


def _is_ws(data: torch.Tensor) -> torch.Tensor:
    m = data == _WS[0]
    for w in _WS[1:]:
        m = m | (data == w)
    return m


def _next_pos(csum: torch.Tensor) -> torch.Tensor:
    """For each position i: the smallest j > i with the mask set, or
    _BIG (the JAX package's reverse min-scan)."""
    n = csum.shape[0] - 1
    nxt = kth_set(csum, csum[1:] + 1)
    return torch.where(nxt < n, nxt, _BIG)


def _hex0(b: torch.Tensor) -> torch.Tensor:
    """A hex digit's value, 0 for any other byte (the JAX package's
    `_hex_val`)."""
    bi = b.to(torch.int32)
    v = torch.where((bi >= 48) & (bi <= 57), bi - 48, 0)
    v = torch.where((bi >= 97) & (bi <= 102), bi - 87, v)
    return torch.where((bi >= 65) & (bi <= 70), bi - 55, v)


def _cp_at(data: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """The 4 hex digits at `at` as a code point."""
    cap = data.shape[0]
    cp = torch.zeros(at.shape, dtype=torch.int32, device=data.device)
    for j in range(4):
        cp = cp * 16 + _hex0(data[torch.clamp(at + j, 0, cap - 1)])
    return cp


_SCOPE = threading.local()


@contextmanager
def shared_structures():
    """Within the block each column's structure is built once, shared by
    every path evaluated over it, and freed at the block's end."""
    outer = getattr(_SCOPE, "cache", None)
    if outer is None:
        _SCOPE.cache = {}
    try:
        yield
    finally:
        if outer is None:
            _SCOPE.cache = None


class JsonStructure:
    """The structural masks of one string column of JSON documents."""

    @classmethod
    def of(cls, col: StringColumn) -> "JsonStructure":
        """The column's structure: the shared one inside a
        `shared_structures()` block, else a fresh one."""
        cache = getattr(_SCOPE, "cache", None)
        if cache is None:
            return cls(col)
        hit = cache.get(id(col))
        if hit is None or hit[0] is not col:
            hit = cache[id(col)] = (col, cls(col))
        return hit[1]

    def __init__(self, col: StringColumn):
        self.data = data = col.data
        self.offsets = col.offsets
        self.dtype = col.dtype
        cap = col.capacity
        byte_cap = col.byte_capacity
        pos, row, _ = _row_of_byte(col.offsets, byte_cap, cap)
        row_start = col.offsets[row]
        in_use = pos < col.offsets[-1]

        # escape parity: a byte is escaped iff an odd run of backslashes
        # ends just before it (runs do not cross a row's start)
        bs = (data == 0x5C) & in_use
        nb = count_set(~bs)
        # the last non-backslash at or before each position (-1: none)
        last_nb = torch.where(nb[1:] > 0, kth_set(nb, nb[1:]), -1)
        del nb
        last_stop = torch.cat([last_nb.new_full((1,), -1), last_nb[:-1]])
        del last_nb
        last_stop = torch.maximum(last_stop, row_start - 1)
        escaped = (((pos - 1) - last_stop) % 2) == 1
        del last_stop, bs

        quote_real = (data == 0x22) & ~escaped & in_use
        qc = count_set(quote_real)
        nq_before = qc[:-1] - qc[row_start]
        del qc
        in_string = (nq_before % 2) == 1     # the opening quote excluded
        del nq_before
        structural = ~in_string & ~quote_real & in_use
        opens = ((data == 0x7B) | (data == 0x5B)) & structural
        closes = ((data == 0x7D) | (data == 0x5D)) & structural
        delta = opens.to(torch.int32) - closes.to(torch.int32)
        del opens, closes
        dc = torch.cat([delta.new_zeros(1), torch.cumsum(delta, 0,
                                                         dtype=torch.int32)])
        depth_after = dc[1:] - dc[row_start]
        depth_before = depth_after - delta
        del row_start

        nonws = in_use & ~_is_ws(data)
        self.pos, self.row = pos, row
        self.escaped = escaped
        self.quote_real = quote_real
        self.in_string = in_string
        self.structural = structural
        self.depth_after = depth_after
        self.depth_before = depth_before
        self.nonws_count = count_set(nonws)
        self.next_quote = _next_pos(count_set(quote_real))
        self.next_nonws = _next_pos(self.nonws_count)
        del nonws

        # structural validity per row: the depth never negative, back to
        # 0 at the end, every string terminated (an even quote count)
        off = self.offsets
        lens = string_lengths(col)
        neg = span_sums((depth_after < 0) & in_use, off)[2]
        tot_delta = dc[torch.clamp(off[1:], max=byte_cap).long()] \
            - dc[torch.clamp(off[:-1], max=byte_cap).long()]
        tot_quotes = span_sums(quote_real, off)[2]
        self.doc_ok = col.validity & (lens > 0) & (neg == 0) \
            & (tot_delta == 0) & ((tot_quotes % 2) == 0)
        self.row_start = off[:-1]
        self.row_end = off[1:]

    @property
    def byte_capacity(self) -> int:
        return int(self.data.shape[0])

    def first_nonws_in(self, lo, hi):
        """(cap,) the first non-ws byte in [lo, hi); _BIG if none."""
        return first_from(self.nonws_count, lo, hi)

    def last_nonws_in(self, lo, hi):
        """(cap,) the last non-ws byte of the row in [lo, hi); -1 if
        none (the JAX package reduces by the bytes' row)."""
        return last_before(self.nonws_count,
                            torch.maximum(lo, self.row_start),
                            torch.minimum(hi, self.row_end))


def _first_flag_in_row(flag, st: JsonStructure, lo, hi):
    """Per row: the first flagged byte of the row in [lo, hi), or _BIG
    (the JAX package's segment_min by row)."""
    return first_from(count_set(flag), torch.maximum(lo, st.row_start),
                       torch.minimum(hi, st.row_end))


def json_extract(col: StringColumn,
                 steps: List[Union[str, int]]) -> StringColumn:
    """get_json_object for a literal path without wildcards ('$' +
    steps)."""
    st = JsonStructure.of(col)
    byte_cap = st.byte_capacity
    data = st.data
    pos, row = st.pos, st.row

    # the root span: the whole document, whitespace-trimmed
    lo = st.first_nonws_in(st.row_start, st.row_end)
    last = st.last_nonws_in(st.row_start, st.row_end)
    hi = torch.where(last >= 0, last + 1, 0)
    ok = st.doc_ok & (lo < _BIG)
    lo = torch.clamp(lo, 0, byte_cap - 1)

    for step in steps:
        at_lo = data[lo]
        d_elem = st.depth_before[lo] + 1
        # commas separating the container's direct children
        comma_m = (data == 0x2C) & st.structural \
            & (st.depth_after == d_elem[row]) \
            & (pos > lo[row]) & (pos < hi[row])
        if isinstance(step, int):
            ok = ok & (at_lo == 0x5B)
            if step == 0:
                start = st.first_nonws_in(lo + 1, hi - 1)
                exists = start < _BIG
            else:
                # the step-th comma of the row
                cc = count_set(comma_m)
                before = cc[st.row_start.long()]
                n_row = cc[torch.clamp(st.row_end, max=byte_cap).long()] \
                    - before
                nth = torch.where(n_row >= step, kth_set(cc, before + step),
                                  _BIG)
                del cc
                start = st.first_nonws_in(torch.clamp(nth + 1, 0, byte_cap),
                                          hi - 1)
                exists = (nth < _BIG) & (start < _BIG)
            ok = ok & exists
            # an element must exist ([] has none): its first byte may not
            # be the closing bracket
            ok = ok & (data[torch.clamp(start, 0, byte_cap - 1)] != 0x5D)
        else:
            key = step.encode("utf-8")
            ok = ok & (at_lo == 0x7B)
            # direct-child keys: real opening quotes at depth d_elem whose
            # string is followed (next non-ws after the closing quote) by
            # a ':'
            closing = st.next_quote
            after = st.next_nonws[torch.clamp(closing, 0, byte_cap - 1)]
            match = st.quote_real & ~st.in_string \
                & (st.depth_after == d_elem[row]) \
                & (pos > lo[row]) & (pos < hi[row]) & (closing < _BIG) \
                & (data[torch.clamp(after, 0, byte_cap - 1)] == 0x3A) \
                & ((closing - pos - 1) == len(key))
            del after
            for j, ch in enumerate(key):
                match = match & (data[torch.clamp(pos + 1 + j, 0,
                                                  byte_cap - 1)] == ch)
            q = _first_flag_in_row(match, st, lo, hi)
            del match
            ok = ok & (q < _BIG)
            q = torch.clamp(q, 0, byte_cap - 1)
            colon = st.next_nonws[torch.clamp(st.next_quote[q], 0,
                                              byte_cap - 1)]
            start = st.first_nonws_in(torch.clamp(colon + 1, 0, byte_cap),
                                      hi - 1)
            ok = ok & (start < _BIG)
        # the value ends before the next separating comma (or the
        # container's closing byte)
        nxt = _first_flag_in_row(comma_m, st, start, hi)
        del comma_m
        v_hi_raw = torch.minimum(nxt, hi - 1)
        # the value's span, whitespace-trimmed; a container ends at its
        # matching close, the last non-ws byte before the separator
        start = torch.clamp(start, 0, byte_cap - 1)
        last = st.last_nonws_in(start, v_hi_raw)
        lo = start
        hi = torch.where(last >= 0, last + 1, start)
        ok = ok & (last >= 0)

    return _render_spans(st, lo, hi, ok)


def _render_spans(st: JsonStructure, lo, hi, ok) -> StringColumn:
    """Emit the extracted spans: strings unquoted and unescaped,
    containers compacted, 'null' -> NULL, scalars raw."""
    byte_cap = st.byte_capacity
    data = st.data
    pos, row = st.pos, st.row
    dev = data.device

    def at(p):
        return data[torch.clamp(p, 0, byte_cap - 1)]

    first = at(lo)
    is_str = ok & (first == 0x22)
    is_container = ok & ((first == 0x7B) | (first == 0x5B))
    # a JSON null renders as SQL NULL ("null" in quotes is a string: its
    # first byte is the quote)
    is_null_lit = ok & ((hi - lo) == 4)
    for j, ch in enumerate(b"null"):
        is_null_lit = is_null_lit & (at(lo + j) == ch)
    valid = ok & ~is_null_lit
    eff_lo = torch.where(is_str, lo + 1, lo)
    eff_hi = torch.where(is_str, hi - 1, hi)
    in_span = (pos >= eff_lo[row]) & (pos < eff_hi[row]) & valid[row]

    # containers drop the whitespace outside strings
    ws_struct = _is_ws(data) & ~st.in_string & ~st.quote_real
    emit = (in_span & ~(is_container[row] & ws_struct)).to(torch.int32)
    del ws_struct

    # strings decode their escapes: an escape starts at a backslash that
    # is not itself escaped
    str_span = in_span & is_str[row]
    esc_start = str_span & (data == 0x5C) & ~st.escaped
    is_u = at(pos + 1) == 0x75
    cp = _cp_at(data, pos + 2)
    is_hi_sur = is_u & (cp >= 0xD800) & (cp <= 0xDBFF)
    is_lo_sur = is_u & (cp >= 0xDC00) & (cp <= 0xDFFF)
    # a high-surrogate escape followed at once by a low-surrogate escape
    # is one astral code point (12 source bytes, 4 out)
    nxt_cp = _cp_at(data, pos + 8)
    six = torch.clamp(pos + 6, 0, byte_cap - 1)
    paired = is_hi_sur & esc_start[six] & (at(pos + 7) == 0x75) \
        & (nxt_cp >= 0xDC00) & (nxt_cp <= 0xDFFF)
    del nxt_cp, six
    prev6 = torch.clamp(pos - 6, 0, byte_cap - 1)
    consumed = esc_start & is_lo_sur & paired[prev6] & esc_start[prev6]
    del prev6
    u_len = torch.where(cp < 0x80, 1, torch.where(cp < 0x800, 2, 3))
    u_len = torch.where(is_hi_sur | is_lo_sur, 1, u_len)
    u_len = torch.where(paired, 4, u_len)
    esc_len = torch.where(is_u, u_len, 1)
    del u_len
    live = esc_start & ~consumed & in_span
    del consumed
    # the bytes an escape covers (its span from its start) emit nothing;
    # its start emits the decoded length (spans are at most 12 bytes)
    span = torch.where(live, torch.where(is_u, torch.where(paired, 12, 6),
                                         2), 0).to(torch.uint8)
    covered = span > 0
    for j in range(1, 12):
        covered[j:] |= span[:-j] > j
    del span
    emit = torch.where(covered & str_span, 0, emit)
    emit = torch.where(live, esc_len, emit)
    del covered, str_span, live, esc_len, in_span

    out_lens = torch.where(valid, span_sums(emit, st.offsets)[2], 0)
    new_offsets = _rebuild_offsets(out_lens)
    emit_start = count_set(emit)
    del emit
    opos = torch.arange(byte_cap, dtype=torch.int32, device=dev)
    src = torch.clamp(torch.searchsorted(emit_start, opos, right=True,
                                         out_int32=True) - 1, 0,
                      byte_cap - 1)
    k = opos - emit_start[src]
    del emit_start
    out_in_use = opos < new_offsets[-1]
    del opos

    # the decoded bytes at escape positions
    e_ch = at(src + 1)
    src_cp = cp[src]
    lo_cp = _cp_at(data, src + 8)
    full_cp = torch.where(paired[src],
                          0x10000 + ((src_cp - 0xD800) << 10)
                          + (lo_cp - 0xDC00), src_cp)
    del lo_cp, src_cp
    full_cp = torch.where((is_hi_sur[src] | is_lo_sur[src]) & ~paired[src],
                          ord("?"), full_cp)
    esc_out = torch.where(e_ch == 0x75, _utf8_byte(full_cp, k),
                          _simple_escape_byte(e_ch))
    byte = torch.where(esc_start[src], esc_out, data[src])
    out = torch.where(out_in_use, byte, 0).to(torch.uint8)
    return StringColumn(out, new_offsets, valid, st.dtype)


def _simple_escape_byte(e: torch.Tensor) -> torch.Tensor:
    out = e  # \" \\ \/ and any unknown escape: the byte itself
    for c, r in ((b"b", 8), (b"f", 12), (b"n", 10), (b"r", 13), (b"t", 9)):
        out = torch.where(e == c[0], r, out)
    return out.to(torch.uint8)


def _utf8_byte(cp: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The k-th UTF-8 byte of code point cp (cp < 0x110000, k below its
    encoding's length): the lead byte carries the length's prefix and the
    top bits, each later byte 0x80 and the next six."""
    n = 1 + (cp >= 0x80).to(torch.int32) + (cp >= 0x800).to(torch.int32) \
        + (cp >= 0x10000).to(torch.int32)
    val = cp >> torch.clamp(6 * (n - 1 - k), min=0)
    lead = torch.where(n == 1, val, (0xF00 >> n) & 0xFF | val)
    return (torch.where(k == 0, lead, 0x80 | (val & 0x3F)) & 0xFF) \
        .to(torch.uint8)
