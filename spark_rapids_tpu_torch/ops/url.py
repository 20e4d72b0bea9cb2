"""Device parse_url: byte-parallel URL component spans — the counterpart
of spark_rapids_tpu/ops/url.py (reference GpuParseUrl.scala over the
spark-rapids-jni ParseURI kernel).

Per-row delimiter positions are the first or last match of a byte mask
in the row's span; components are span arithmetic over them; extraction
is the usual emit/gather. The JAX package takes those positions by
segment reductions over each byte's row and the "next '&'" by a reverse
min-scan; the port counts each mask once (a cumsum) and finds the
positions by a search of the count (ops/strings.first_from,
last_before), with no scatter and no host read.

Part semantics (the JAX package's, which follow its host tier's
urlparse on well-formed URLs; its exotic-input divergences are shared):
  PROTOCOL  scheme, lowercased, None when absent
  AUTHORITY raw netloc, None when absent/empty
  USERINFO  netloc before the last '@', None when no '@'
  HOST      hostname: after the last '@', the port stripped, brackets
            stripped, lowercased, None when empty
  PATH      path ('' when empty, never None)
  QUERY     raw query, None when absent/empty; with a key: the FIRST
            matching key's value, %XX and '+' decoded
  REF       fragment, None when absent/empty
  FILE      path + '?' + query (raw)
"""

from __future__ import annotations

import torch

from ..columnar.column import StringColumn, bucket_capacity
from ..types import STRING
from .strings import (_BIG, _rebuild_offsets, _row_of_byte, count_set,
                      first_from, hex_digit_val, kth_set, last_before,
                      span_sums, string_lengths)


def _in(b, lo: int, hi: int):
    return (b >= lo) & (b <= hi)


class _UrlSpans:
    """Per-row component spans of one URL column."""

    def __init__(self, col: StringColumn):
        bcap = col.byte_capacity
        b = col.data
        pos, row, _ = _row_of_byte(col.offsets, bcap, col.capacity)
        start = col.offsets[:-1]
        end = col.offsets[1:]
        in_use = pos < col.offsets[-1]

        def bounds(lo, hi):
            # the row's span, narrowed (the JAX package reduces by row)
            return (start if lo is None else torch.maximum(lo, start),
                    end if hi is None else torch.minimum(hi, end))

        def first_of(mask, lo=None, hi=None):
            return first_from(count_set(mask & in_use), *bounds(lo, hi))

        def last_of(mask, lo=None, hi=None):
            return last_before(count_set(mask & in_use), *bounds(lo, hi))

        hash_pos = first_of(b == 0x23)
        pre_frag_end = torch.minimum(hash_pos, end)
        q_pos = first_of(b == 0x3F, hi=pre_frag_end)

        # scheme: the first ':' strictly before any '/', '?', '#', after a
        # leading letter and only scheme characters
        is_colon = b == 0x3A
        is_slash = b == 0x2F
        colon = first_of(is_colon)
        slash = first_of(is_slash)
        alpha = _in(b, 0x61, 0x7A) | _in(b, 0x41, 0x5A)
        scheme_char = alpha | _in(b, 0x30, 0x39) | (b == 0x2B) \
            | (b == 0x2D) | (b == 0x2E)
        bad_csum = count_set(in_use & ~scheme_char)
        first_b = b[torch.clamp(start, 0, bcap - 1)]
        first_alpha = _in(first_b, 0x61, 0x7A) | _in(first_b, 0x41, 0x5A)
        scheme_clean = (bad_csum[torch.clamp(colon, 0, bcap)]
                        - bad_csum[torch.clamp(start, 0, bcap)]) == 0
        has_scheme = (colon < torch.minimum(torch.minimum(slash, q_pos),
                                            hash_pos)) \
            & (colon > start) & first_alpha & scheme_clean \
            & (string_lengths(col) > 0)
        after_scheme = torch.where(has_scheme, colon + 1, start)

        # netloc: '//' right after the scheme (or at the start)
        a0 = b[torch.clamp(after_scheme, 0, bcap - 1)]
        a1 = b[torch.clamp(after_scheme + 1, 0, bcap - 1)]
        has_netloc = (a0 == 0x2F) & (a1 == 0x2F) \
            & (after_scheme + 1 < pre_frag_end)
        net_start = torch.where(has_netloc, after_scheme + 2, after_scheme)
        net_end = torch.minimum(torch.minimum(
            first_of(is_slash, lo=net_start, hi=pre_frag_end), q_pos),
            pre_frag_end)
        net_end = torch.where(has_netloc, net_end, net_start)

        path_start = torch.where(has_netloc, net_end, after_scheme)
        path_end = torch.minimum(q_pos, pre_frag_end)

        at = last_of(b == 0x40, lo=net_start, hi=net_end)
        has_at = at >= 0
        host_start = torch.where(has_at, at + 1, net_start)
        bracketed = b[torch.clamp(host_start, 0, bcap - 1)] == 0x5B
        rb = first_of(b == 0x5D, lo=host_start, hi=net_end)
        # the port: the last ':' after the host part (and after any ']')
        port_colon = last_of(is_colon,
                             lo=torch.where(bracketed, rb, host_start),
                             hi=net_end)
        host_end = torch.where(port_colon >= 0, port_colon, net_end)
        # brackets stripped from the reported hostname
        h_lo = torch.where(bracketed, host_start + 1, host_start)
        h_hi = torch.where(bracketed & (rb < _BIG), rb, host_end)

        self.pos, self.row, self.in_use = pos, row, in_use
        self.start, self.end = start, end
        self.has_scheme = has_scheme
        self.scheme_span = (start, torch.where(has_scheme, colon, start))
        self.has_netloc = has_netloc
        self.netloc_span = (net_start, net_end)
        self.has_at = has_at
        self.userinfo_span = (net_start, torch.where(has_at, at, net_start))
        self.host_span = (h_lo, h_hi)
        self.path_span = (path_start, torch.maximum(path_end, path_start))
        self.has_q = q_pos < _BIG
        self.query_span = (torch.where(self.has_q, q_pos + 1, start),
                           torch.where(self.has_q, pre_frag_end, start))
        self.has_frag = hash_pos < _BIG
        self.ref_span = (torch.where(self.has_frag, hash_pos + 1, start),
                         torch.where(self.has_frag, end, start))
        # FILE drops a trailing '?' of an empty query (urlparse: path +
        # ('?' + query if query else ''))
        q_empty = self.has_q & (pre_frag_end == q_pos + 1)
        file_end = torch.where(q_empty, q_pos, pre_frag_end)
        self.file_span = (path_start, torch.maximum(file_end, path_start))


def _extract(col: StringColumn, lo, hi, valid,
             lowercase: bool = False) -> StringColumn:
    from .strings import _substring_gather
    lens = torch.where(valid, torch.clamp(hi - lo, min=0), 0)
    out = _substring_gather(col, lo.to(torch.int32), lens.to(torch.int32))
    data = out.data
    if lowercase:
        data = torch.where(_in(data, 0x41, 0x5A), data + 32, data)
    return StringColumn(data, out.offsets, valid & col.validity, STRING)


def parse_url(col: StringColumn, part: str, key=None) -> StringColumn:
    s = _UrlSpans(col)
    v = col.validity
    if part == "PROTOCOL":
        return _extract(col, *s.scheme_span, v & s.has_scheme,
                        lowercase=True)
    if part == "AUTHORITY":
        lo, hi = s.netloc_span
        return _extract(col, lo, hi, v & s.has_netloc & (hi > lo))
    if part == "USERINFO":
        return _extract(col, *s.userinfo_span, v & s.has_at)
    if part == "HOST":
        lo, hi = s.host_span
        return _extract(col, lo, hi, v & s.has_netloc & (hi > lo),
                        lowercase=True)
    if part == "PATH":
        return _extract(col, *s.path_span, v)
    if part == "REF":
        lo, hi = s.ref_span
        return _extract(col, lo, hi, v & s.has_frag & (hi > lo))
    if part == "FILE":
        return _extract(col, *s.file_span, v)
    if part == "QUERY" and key is None:
        lo, hi = s.query_span
        return _extract(col, lo, hi, v & s.has_q & (hi > lo))
    if part == "QUERY":
        return _query_value(col, s, key)
    # an unknown part name (Spark's names are case-sensitive): NULL rows
    dev = col.device
    return StringColumn(
        torch.zeros(bucket_capacity(1), dtype=torch.uint8, device=dev),
        torch.zeros(col.capacity + 1, dtype=torch.int32, device=dev),
        torch.zeros(col.capacity, dtype=torch.bool, device=dev), STRING)


def _query_value(col: StringColumn, s: _UrlSpans, key: str) -> StringColumn:
    """The value of the FIRST pair whose key is `key` (raw bytes), %XX and
    '+' decoded (parse_qs's rules)."""
    bcap = col.byte_capacity
    data = col.data
    pos, row = s.pos, s.row
    q_lo, q_hi = s.query_span
    q_lo_b, q_hi_b = q_lo[row], q_hi[row]
    in_q = s.in_use & (pos >= q_lo_b) & (pos < q_hi_b)
    amp = (data == 0x26) & in_q
    # pair starts: the query's start or the byte after a '&'
    ps = in_q & ((pos == q_lo_b) | amp[torch.clamp(pos - 1, 0, bcap - 1)])

    def next_at_or_after(mask):
        c = count_set(mask)
        nxt = kth_set(c, c[:-1] + 1)
        return torch.where(nxt < bcap, nxt, _BIG)
    pair_end = torch.minimum(next_at_or_after(amp), q_hi_b)
    del amp
    # the '=' of this pair (parse_qs splits once, on the first)
    key_end = torch.minimum(next_at_or_after((data == 0x3D) & in_q),
                            pair_end)
    del in_q, q_lo_b, q_hi_b
    kb = key.encode("utf-8")
    match = ps & ((key_end - pos) == len(kb))
    del ps
    for j, ch in enumerate(kb):
        match = match & (data[torch.clamp(pos + j, 0, bcap - 1)] == ch)
    first = first_from(count_set(match), s.start, s.end)
    del match
    has = (first < _BIG) & s.has_q & col.validity
    firstc = torch.clamp(first, 0, bcap - 1)
    # the value's span: after the '=' where there is one, else empty
    ke, pe = key_end[firstc], pair_end[firstc]
    del key_end, pair_end
    v_lo = torch.where(ke < pe, ke + 1, pe)
    v_hi_b = pe[row]

    # emit with %XX / '+' decoding
    in_val = s.in_use & (pos >= v_lo[row]) & (pos < v_hi_b) & has[row]
    h1 = hex_digit_val(data[torch.clamp(pos + 1, 0, bcap - 1)])
    h2 = hex_digit_val(data[torch.clamp(pos + 2, 0, bcap - 1)])
    pct_ok = in_val & (data == 0x25) & (h1 >= 0) & (h2 >= 0) \
        & (pos + 2 < v_hi_b)
    del h1, h2, v_hi_b
    # the two bytes a valid escape covers emit nothing; its '%' emits the
    # decoded byte
    covered = torch.zeros_like(pct_ok)
    covered[1:] |= pct_ok[:-1]
    covered[2:] |= pct_ok[:-2]
    covered[0] |= pct_ok[0]
    covered[1] |= pct_ok[0]
    emit = (in_val & ~covered).to(torch.int32)
    del covered, in_val
    out_lens = torch.where(has, span_sums(emit, col.offsets)[2], 0)
    new_off = _rebuild_offsets(out_lens)
    emit_start = count_set(emit)
    del emit
    opos = torch.arange(bcap, dtype=torch.int32, device=col.device)
    src = torch.clamp(torch.searchsorted(emit_start, opos, right=True,
                                         out_int32=True) - 1, 0, bcap - 1)
    del emit_start
    byte = data[src]
    dec = hex_digit_val(data[torch.clamp(src + 1, 0, bcap - 1)]) * 16 \
        + hex_digit_val(data[torch.clamp(src + 2, 0, bcap - 1)])
    byte = torch.where(pct_ok[src], torch.clamp(dec, 0, 255).to(torch.uint8),
                       torch.where(byte == 0x2B, 0x20, byte).to(torch.uint8))
    out = torch.where(opos < new_off[-1], byte, 0).to(torch.uint8)
    return StringColumn(out, new_off, has, STRING)
