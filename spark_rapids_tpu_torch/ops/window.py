"""Window kernels — the counterpart of spark_rapids_tpu/ops/window.py
(reference window/GpuWindowExec.scala:146, GpuRunningWindowExec.scala:220,
GpuUnboundedToUnboundedAggWindowExec.scala, BasicWindowCalc.scala).

Every frame lowers to segmented scans and prefix differences over rows
sorted by (partition, order), with segment ids from ops/sort.
group_segment_ids and the inactive rows at the tail, as in the JAX
package:
  * running frames -> segment-local inclusive scans;
  * whole-partition frames -> a scan read at the segment's last row and
    broadcast;
  * ROWS frames (sum/count/avg) -> prefix[i+b] - prefix[i-a-1] over the
    segment-local prefix;
  * RANGE frames -> row bounds from one stable merge sort each;
  * min/max over bounded frames -> a sparse (doubling) extrema table;
  * the rank family -> positions relative to segment starts and order
    boundaries; lag/lead -> a shifted gather guarded by the segment.

The JAX package's `associative_scan`s with a segment-reset combine become
`_segmented_scan`: ceil(log2(capacity)) doubling steps of shifted, masked
combines (a Hillis-Steele scan), static and free of host reads. The sums
stay segment-local: a global cumsum differenced at segment starts would
lose a small partition's sum to cancellation after 1e12-scale ones, the
failure the reference's reset guards against. Segment starts and ends
come from the boundary flags of the sorted segments (`run_bounds`: a
cumsum of the flags and one scatter to distinct slots), not from a
contended scatter reduction, nor from `torch.cummax`/`cummin`, whose CUDA
scans carry indices and are slow at these sizes.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..columnar.column import Column
from .basic import active_mask, gather_column


def _arange(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=dev)


def segment_start_flags(seg: torch.Tensor) -> torch.Tensor:
    """True at the first row of each segment (row 0 included)."""
    flag = torch.ones_like(seg, dtype=torch.bool)
    flag[1:] = seg[1:] != seg[:-1]
    return flag


def run_bounds(is_start: torch.Tensor):
    """(first row, last row) of each row's run, for runs given by their
    start flags (row 0 starts one): the run ids are a cumsum of the flags,
    each run's first row lands in a table by one scatter to distinct
    slots, and a row's last row is the next run's first, less one."""
    n = is_start.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=is_start.device)
    gid = torch.cumsum(is_start, 0, dtype=torch.int64) - 1
    # run g's first row at slot g; the other rows write past the table
    firsts = torch.full((2 * n + 1,), n, dtype=torch.int64,
                        device=is_start.device)
    firsts.scatter_(0, torch.where(is_start, gid, n + 1 + pos), pos)
    return firsts[gid].to(torch.int32), (firsts[gid + 1] - 1).to(torch.int32)


def segment_starts(seg: torch.Tensor, capacity: int) -> torch.Tensor:
    """The first row index of each row's segment (contiguous segments)."""
    return run_bounds(segment_start_flags(seg))[0]


def segment_ends(seg: torch.Tensor, capacity: int) -> torch.Tensor:
    """The last row index of each row's segment."""
    return run_bounds(segment_start_flags(seg))[1]


def run_ends(is_start: torch.Tensor, capacity: int) -> torch.Tensor:
    """The last row index of each row's run, for runs given by their
    start flags (an order group inside a segment)."""
    return run_bounds(is_start)[1]


def _segmented_scan(values, is_start: torch.Tensor, op):
    """Inclusive scan of `values` (a tensor or a tuple of tensors) with
    `op(earlier, later)`, restarting at every start flag: doubling steps,
    each combining a row with the row `d` before it unless a segment
    start lies between them."""
    single = isinstance(values, torch.Tensor)
    vals = (values,) if single else tuple(values)
    flag = is_start.clone()
    n = flag.shape[0]
    d = 1
    while d < n:
        prev = tuple(v[:-d] for v in vals)
        comb = op(prev if not single else prev[0],
                  tuple(v[d:] for v in vals) if not single else vals[0][d:])
        comb = (comb,) if single else comb
        keep = flag[d:]
        vals = tuple(torch.cat([v[:d], torch.where(keep, v[d:], c)])
                     for v, c in zip(vals, comb))
        flag = torch.cat([flag[:d], keep | flag[:-d]])
        d *= 2
    return vals[0] if single else vals


def _segmented_cumsum(v: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Inclusive per-segment cumsum: frames never cross partitions, so
    differencing THIS prefix keeps float window sums segment-local."""
    return _segmented_scan(v, segment_start_flags(seg),
                           lambda a, b: a + b)


def _sum_lanes(values, validity, num_rows, capacity: int):
    """(masked value lane in f64 or i64, int32 counts) of the active valid
    rows."""
    act = active_mask(num_rows, capacity, validity.device)
    ok = validity & act
    wide = torch.float64 if values.dtype.is_floating_point else torch.int64
    v = torch.where(ok, values.to(wide), torch.zeros((), dtype=wide,
                                                     device=values.device))
    return v, ok.to(torch.int32)


def _count_prefix(c: torch.Tensor) -> torch.Tensor:
    # counts are exact integers: the global prefix is fine
    return torch.cat([c.new_zeros(1),
                      torch.cumsum(c, 0, dtype=torch.int32)])


def windowed_sum_count(values, validity, seg, num_rows, capacity: int,
                       preceding: Optional[int], following: Optional[int]):
    """sum and count over a ROWS frame [i - preceding, i + following]
    clipped to the segment (None: unbounded on that side). Returns (sum
    f64/i64, count int32) per row: sum, count and avg for every frame
    shape by prefix differences."""
    v, c = _sum_lanes(values, validity, num_rows, capacity)
    incl = _segmented_cumsum(v, seg)
    excl = incl - v
    pc = _count_prefix(c)
    i = _arange(capacity, seg.device)
    start, end = segment_starts(seg, capacity), segment_ends(seg, capacity)
    lo = start if preceding is None else torch.maximum(start, i - preceding)
    hi = end if following is None else torch.minimum(end, i + following)
    nonempty = hi >= lo
    top = capacity - 1
    s = incl[torch.clamp(hi, 0, top).long()] \
        - excl[torch.clamp(lo, 0, top).long()]
    s = torch.where(nonempty, s, torch.zeros((), dtype=s.dtype,
                                             device=s.device))
    hi = torch.maximum(hi, lo - 1)
    n = pc[torch.clamp(hi + 1, 0, capacity).long()] \
        - pc[torch.clamp(lo, 0, capacity).long()]
    return s, n.to(torch.int32)


def _saturating_shift(data: torch.Tensor, delta) -> torch.Tensor:
    """data + delta, saturating instead of wrapping (ints): a RANGE
    bound's probe value; floats saturate to +-inf by themselves."""
    if data.dtype.is_floating_point:
        return data + delta
    info = torch.iinfo(data.dtype)
    res = (data.to(torch.int64) + int(delta)) if data.dtype != torch.int64 \
        else data + int(delta)
    if data.dtype != torch.int64:
        return torch.clamp(res, info.min, info.max).to(data.dtype)
    over = (delta > 0) & (res < data)
    under = (delta < 0) & (res > data)
    return torch.where(over, info.max, torch.where(under, info.min, res))


def _merge_rank(key_lanes, probe_lanes, capacity: int,
                probe_first: bool) -> torch.Tensor:
    """The count of key entries sorting strictly before (probe_first) or
    at-or-before (not) each probe, by ONE stable sort of the 2 x capacity
    entries. Keys and probes are each already sorted by the same lanes
    (the rows, and monotone shifts of them), so a probe's rank among the
    keys is its merged position minus its own index."""
    from .sort import lexsort
    kf, pf = (1, 0) if probe_first else (0, 1)
    dev = key_lanes[0][0].device
    merged = [(torch.cat([k, p]), bits)
              for (k, bits), (p, _) in zip(key_lanes, probe_lanes)]
    flags = torch.cat([torch.full((capacity,), kf, dtype=torch.int64,
                                  device=dev),
                       torch.full((capacity,), pf, dtype=torch.int64,
                                  device=dev)])
    perm = lexsort(merged + [(flags, 1)])
    pos_of = torch.empty(2 * capacity, dtype=torch.int64, device=dev)
    pos_of[perm] = torch.arange(2 * capacity, dtype=torch.int64, device=dev)
    return (pos_of[capacity:] - torch.arange(capacity, device=dev)) \
        .to(torch.int32)


def range_frame_bounds(order_col: Column, seg, num_rows, capacity: int,
                       preceding, following, ascending: bool,
                       nulls_first: bool):
    """Per-row [lo, hi) row bounds of a RANGE frame over ONE numeric
    order key (reference window/GpuWindowExpression.scala:111-179).

    preceding/following are VALUE offsets (None: unbounded); row i's frame
    is every row of its partition whose key lies in [key_i - preceding,
    key_i + following] (direction-adjusted for descending order). A row
    with a NULL key frames its partition's null run. Each bound is one
    stable sort of the (row lanes ++ shifted probe lanes) stack: the
    partition and null lanes keep every probe inside its own partition
    and null class."""
    from .sort import _numeric_order_key, lane_bits
    dev = seg.device
    act = active_mask(num_rows, capacity, dev)
    valid = order_col.validity & act
    lo = segment_starts(seg, capacity)
    hi = segment_ends(seg, capacity) + 1
    if preceding is None and following is None:
        return lo, torch.where(act, hi, 0)
    null_rank = (valid if nulls_first else ~valid).to(torch.int64)
    bits = lane_bits(order_col.data.dtype)
    zero = -(1 << 63) if bits == 64 else 0

    def lanes_for(data):
        lane = _numeric_order_key(Column(data, valid, order_col.dtype))
        if not ascending:
            lane = ~lane if bits == 64 else ((1 << bits) - 1) - lane
        lane = torch.where(valid, lane, torch.full((), zero,
                                                   dtype=torch.int64,
                                                   device=dev))
        return [((~act).to(torch.int64), 1), (seg.to(torch.int64), 32),
                (null_rank, 1), (lane, bits)]

    key_lanes = lanes_for(order_col.data)
    # for DESC order the "preceding" side holds LARGER keys
    sgn = 1 if ascending else -1
    if preceding is not None:
        lo = _merge_rank(key_lanes, lanes_for(_saturating_shift(
            order_col.data, -sgn * preceding)), capacity, probe_first=True)
    if following is not None:
        hi = _merge_rank(key_lanes, lanes_for(_saturating_shift(
            order_col.data, sgn * following)), capacity, probe_first=False)
    return lo, torch.where(act, hi, 0)


def range_sum_count(values, validity, seg, num_rows, capacity: int, lo, hi):
    """sum and count over per-row [lo, hi) row frames (range_frame_bounds)
    by prefix differences of the segment-local prefix."""
    v, c = _sum_lanes(values, validity, num_rows, capacity)
    incl = _segmented_cumsum(v, seg)
    excl = incl - v
    pc = _count_prefix(c)
    hi_c = torch.clamp(hi, 0, capacity)
    lo_c = torch.clamp(lo, 0, capacity)
    nonempty = hi_c > lo_c
    top = capacity - 1
    s = incl[torch.clamp(hi_c - 1, 0, top).long()] \
        - excl[torch.clamp(lo_c, 0, top).long()]
    s = torch.where(nonempty, s, torch.zeros((), dtype=v.dtype,
                                             device=v.device))
    n = torch.where(nonempty, pc[hi_c.long()] - pc[lo_c.long()], 0)
    return s, n.to(torch.int32)


def _neutral(dtype: torch.dtype, is_max: bool):
    if dtype.is_floating_point:
        return float("-inf") if is_max else float("inf")
    info = torch.iinfo(dtype)
    return info.min if is_max else info.max


def _floor_log2(length: torch.Tensor) -> torch.Tensor:
    """floor(log2(length)) of int32 lengths >= 1, exact."""
    k = torch.floor(torch.log2(length.to(torch.float64))).to(torch.int32)
    k = torch.where((1 << k.clamp(0, 30)) > length, k - 1, k)
    return torch.where((1 << (k + 1).clamp(0, 30)) <= length, k + 1, k)


def _extrema_over_ranges(values, validity, act, a, b, capacity: int,
                         is_max: bool):
    """min/max over per-row inclusive row ranges [a, b] by a sparse
    (doubling) extrema table: log2(capacity) levels, two gathers a row
    (the classic O(1) range-minimum query)."""
    valid = validity & act
    vals = values.to(torch.int8) if values.dtype == torch.bool else values
    neutral = torch.full((), _neutral(vals.dtype, is_max), dtype=vals.dtype,
                         device=vals.device)
    op = torch.maximum if is_max else torch.minimum
    v = torch.where(valid, vals, neutral)
    levels = [v]
    span = 1
    while span < capacity:
        prev = levels[-1]
        shifted = torch.cat([prev[span:], neutral.expand(span)])
        levels.append(op(prev, shifted))
        span *= 2
    tbl = torch.stack(levels).reshape(-1)
    length = torch.clamp(b - a + 1, min=1)
    k = torch.clamp(_floor_log2(length), 0, len(levels) - 1)
    top = capacity - 1
    right = torch.clamp(b + 1 - (1 << k), 0, top)
    base = k.to(torch.int64) * capacity
    res = op(tbl[base + torch.clamp(a, 0, top).long()],
             tbl[base + right.long()])
    # validity: any non-null value inside the frame
    cnt = _count_prefix(valid.to(torch.int32))
    has_val = (cnt[torch.clamp(b + 1, 0, capacity).long()]
               - cnt[torch.clamp(a, 0, capacity).long()]) > 0
    out_valid = act & has_val & (b >= a)
    res = torch.where(out_valid, res, torch.zeros((), dtype=res.dtype,
                                                  device=res.device))
    if values.dtype == torch.bool:
        res = res.to(torch.bool)
    return res, out_valid


def range_min_max(values, validity, num_rows, capacity: int, lo, hi,
                  is_max: bool):
    """min/max over per-row [lo, hi) frames (range_frame_bounds)."""
    act = active_mask(num_rows, capacity, values.device)
    return _extrema_over_ranges(values, validity, act, lo, hi - 1,
                                capacity, is_max)


def bounded_min_max(values, validity, seg, num_rows, capacity: int,
                    preceding: Optional[int], following: Optional[int],
                    is_max: bool):
    """min/max over a ROWS frame [i - preceding, i + following] clipped to
    the segment, nulls skipped (reference GpuBatchedBoundedWindowExec.
    scala:220's sliding frame), by the sparse extrema table."""
    act = active_mask(num_rows, capacity, values.device)
    i = _arange(capacity, seg.device)
    seg_a, seg_b = segment_starts(seg, capacity), segment_ends(seg, capacity)
    a = seg_a if preceding is None else torch.maximum(i - preceding, seg_a)
    b = seg_b if following is None else torch.minimum(i + following, seg_b)
    return _extrema_over_ranges(values, validity, act, a, b, capacity,
                                is_max)


def running_min_max(values, validity, seg, num_rows, capacity: int,
                    is_max: bool):
    """Segment-local running min/max (UNBOUNDED PRECEDING..CURRENT ROW)
    and whether the prefix holds a non-null value."""
    act = active_mask(num_rows, capacity, values.device)
    valid = validity & act
    if values.dtype == torch.bool:
        values = values.to(torch.int8)
        fill = 0 if is_max else 1
    else:
        fill = _neutral(values.dtype, is_max)
    v = torch.where(valid, values, torch.full((), fill, dtype=values.dtype,
                                              device=values.device))
    op = torch.maximum if is_max else torch.minimum
    out_v, out_c = _segmented_scan(
        (v, valid.to(torch.int32)), segment_start_flags(seg),
        lambda a, b: (op(a[0], b[0]), a[1] + b[1]))
    return out_v, out_c > 0


def row_number(seg, num_rows, capacity: int) -> torch.Tensor:
    return _arange(capacity, seg.device) - segment_starts(seg, capacity) + 1


def rank_dense_rank(order_boundary, seg, num_rows, capacity: int):
    """(rank, dense_rank) from the order-key boundary mask (True at the
    first row of each distinct order key within its segment)."""
    start = segment_starts(seg, capacity)
    boundary = order_boundary | segment_start_flags(seg)
    # rank: the position in its segment of the row's order group's first
    # row, + 1
    rank = run_bounds(boundary)[0] - start + 1
    # dense rank: the boundaries of the segment up to the row
    pb = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32)
    sl = start.long()
    dense = pb - (pb[sl] - boundary[sl].to(torch.int32))
    return rank, dense


def lag_lead(col: Column, seg, num_rows, capacity: int, offset: int):
    """lag (offset > 0 looks back) / lead (offset < 0) within the segment.
    Returns (the gathered column, same_seg): the mask tells "the offset
    row does not exist" (a default applies) from "it exists and is NULL"
    (the result stays NULL, Spark)."""
    i = _arange(capacity, seg.device)
    src = i - offset
    in_range = (src >= 0) & (src < capacity)
    safe = torch.clamp(src, 0, capacity - 1)
    same_seg = in_range & (seg[safe.long()] == seg)
    out = gather_column(col, torch.where(same_seg, safe, -1))
    return out, same_seg
