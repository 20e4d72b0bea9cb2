"""Percentile kernels over list aggregation buffers — the counterpart of
spark_rapids_tpu/ops/percentile.py (reference GpuPercentile /
GpuApproximatePercentile over cuDF's histogram and t-digest).

`percentile` buffers each group's values as a list (the collect
machinery); evaluation sorts every group's values once and picks its
interpolated ranks: exact. `approx_percentile` is the JAX package's
bounded sketch, not a t-digest: a group keeps at most K = 2 x accuracy
value points, each compress or merge resamples to K evenly spaced
weighted quantiles, and a group of K values or fewer stays exact. Rank
error per level is at most n / (2K), inside Spark's n / accuracy
contract for shallow merge trees. A sketch buffer row is one DOUBLE list
[v_0 .. v_{L-1}, n]: the true count rides as the trailing element, so
the points' weights (n / L) survive merges.

The JAX package's multi-key `lax.sort`s become ops/sort.lexsort, and its
segment-reset `associative_scan` of weights the segment-local doubling
scan of ops/window.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from ..columnar.column import ArrayColumn, Column, bucket_capacity
from ..types import DOUBLE, ArrayType
from .collection import row_of_element, row_sums
from .sort import lexsort, numeric_order_lanes
from .strings import _rebuild_offsets

_BIG_ROW = 1 << 30


def _arange(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=dev)


def _group_sorted_elements(arr: ArrayColumn, weights=None):
    """Each group's valid values sorted ascending (the dead elements after
    every group). Returns (sorted values f64, sorted weights f64, sorted
    group key: the row, or _BIG_ROW for a dead element)."""
    cap = arr.capacity
    ccap = arr.child.capacity
    epos = _arange(ccap, arr.device)
    erow = row_of_element(arr.offsets, epos, cap)
    in_use = (epos < arr.offsets[cap]) & arr.child.validity
    row_key = torch.where(in_use, erow, _BIG_ROW)
    perm = lexsort([(row_key, 31)] + numeric_order_lanes(arr.child))
    sorted_vals = arr.child.data[perm].to(torch.float64)
    w = weights if weights is not None else torch.ones(
        ccap, dtype=torch.float64, device=arr.device)
    return sorted_vals, w.to(torch.float64)[perm], row_key[perm]


def _valid_counts(arr: ArrayColumn):
    """(valid values per group, each group's first position among the
    sorted valid values)."""
    nvalid = row_sums(arr, arr.child.validity.to(torch.int32)) \
        .to(torch.int32)
    valid_start = _rebuild_offsets(nvalid)[:-1]
    return nvalid, valid_start


def _interleave(cols: Sequence[Column]) -> Column:
    """Row-major interleave of k same-type fixed-width columns: row
    r * k + j is cols[j][r], at the bucket of k x capacity."""
    k, cap = len(cols), cols[0].capacity
    out_cap = bucket_capacity(cap * k)
    data = torch.stack([c.data for c in cols], 1).reshape(-1)
    valid = torch.stack([c.validity for c in cols], 1).reshape(-1)
    pad = out_cap - cap * k
    if pad:
        data = torch.cat([data, data.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return Column(data, valid, cols[0].dtype)


def _result(outs, valids, out_t, scalar: bool, row_valid, cap: int):
    cols = [Column(torch.where(v, o, torch.zeros((), dtype=o.dtype,
                                                 device=o.device)), v, out_t)
            for o, v in zip(outs, valids)]
    if scalar:
        return cols[0]
    off = _arange(cap + 1, row_valid.device) * len(cols)
    return ArrayColumn(_interleave(cols), off, row_valid, ArrayType(out_t))


def percentile_of_arrays(arr: ArrayColumn,
                         percentages: Union[float, Sequence[float]],
                         interpolate: bool) -> Column:
    """Per row (group): the percentile(s) of its list's values.

    interpolate=True: Spark `percentile` (DOUBLE, linear interpolation at
    rank p * (n - 1)); False: the element at rank ceil(p * n) - 1 (input
    type). A scalar `percentages` gives a scalar column, a list an array
    column (one element per percentage; a group with no valid value gives
    a NULL array)."""
    scalar = not isinstance(percentages, (list, tuple))
    ps = [float(percentages)] if scalar else [float(p) for p in percentages]
    cap = arr.capacity
    ccap = arr.child.capacity
    sorted_vals = arr.child.data[lexsort(
        [(torch.where((_arange(ccap, arr.device) < arr.offsets[cap])
                      & arr.child.validity,
                      row_of_element(arr.offsets, _arange(ccap, arr.device),
                                     cap), _BIG_ROW), 31)]
        + numeric_order_lanes(arr.child))]
    nvalid, valid_start = _valid_counts(arr)
    has = nvalid > 0
    n = torch.clamp(nvalid, min=1)
    top = ccap - 1
    outs, valids = [], []
    for p in ps:
        if interpolate:
            rank = p * (n - 1).to(torch.float64)
            lo_k = torch.floor(rank).to(torch.int32)
            hi_k = torch.ceil(rank).to(torch.int32)
            frac = rank - lo_k.to(torch.float64)
            lo_v = sorted_vals[torch.clamp(valid_start + lo_k, 0, top)
                               .long()].to(torch.float64)
            hi_v = sorted_vals[torch.clamp(valid_start + hi_k, 0, top)
                               .long()].to(torch.float64)
            outs.append(lo_v + frac * (hi_v - lo_v))
        else:
            k = torch.ceil(p * n.to(torch.float64)).to(torch.int32) - 1
            k = torch.minimum(torch.clamp(k, min=0), n - 1)
            outs.append(sorted_vals[torch.clamp(valid_start + k, 0, top)
                                    .long()])
        valids.append(arr.validity & has)
    out_t = DOUBLE if interpolate else arr.dtype.element_type
    return _result(outs, valids, out_t, scalar, arr.validity & has, cap)


def sketch_compress(arr: ArrayColumn, k: int) -> ArrayColumn:
    """Per-group RAW value lists (weight 1 each) -> the sketch encoding:
    up to k points, then the count."""
    cap = arr.capacity
    ccap = arr.child.capacity
    dev = arr.device
    sorted_vals, _, _ = _group_sorted_elements(arr)
    nvalid, valid_start = _valid_counts(arr)
    out_len = torch.where(arr.validity, torch.clamp(nvalid, max=k) + 1, 0)
    offsets = _rebuild_offsets(out_len.to(torch.int32))
    out_cap = ccap + cap  # worst case: every group exact + its count
    opos = _arange(out_cap, dev)
    orow = row_of_element(offsets, opos, cap)
    o_use = opos < offsets[cap]
    j = opos - offsets[orow]
    m = nvalid[orow]
    L = torch.clamp(m, max=k)
    is_count = j == L
    # exact: element j; compressed: element floor((j + 0.5) * m / L)
    idx_comp = torch.floor((j.to(torch.float64) + 0.5)
                           * m.to(torch.float64)
                           / torch.clamp(L, min=1).to(torch.float64)
                           ).to(torch.int32)
    idx = torch.where(m <= k, j, idx_comp)
    idx = torch.minimum(torch.clamp(idx, min=0), torch.clamp(m - 1, min=0))
    src = torch.clamp(valid_start[orow] + idx, 0, ccap - 1).long()
    val = torch.where(is_count, m.to(torch.float64), sorted_vals[src])
    child = Column(torch.where(o_use, val, 0.0), o_use, DOUBLE)
    return ArrayColumn(child, offsets, arr.validity, ArrayType(DOUBLE))


def _merge_rank_1d(key_a, val_a, key_b, val_b) -> torch.Tensor:
    """The rank of each (key_b, val_b) probe among the (key_a, val_a)
    entries (the count sorting strictly before), by one stable sort; both
    sequences already sorted by (key, value)."""
    na, nb = key_a.shape[0], key_b.shape[0]
    dev = key_a.device
    vals = torch.cat([val_a, val_b])
    from .sort import _float_order_bits
    flag = torch.cat([torch.ones(na, dtype=torch.int64, device=dev),
                      torch.zeros(nb, dtype=torch.int64, device=dev)])
    perm = lexsort([(torch.cat([key_a, key_b]).to(torch.int64), 31),
                    (_float_order_bits(vals), 64), (flag, 1)])
    pos_of = torch.empty(na + nb, dtype=torch.int64, device=dev)
    pos_of[perm] = torch.arange(na + nb, dtype=torch.int64, device=dev)
    return (pos_of[na:] - torch.arange(nb, device=dev)).to(torch.int32)


def sketch_merge(flat: ArrayColumn, row_lens: torch.Tensor,
                 row_counts: torch.Tensor, k: int) -> ArrayColumn:
    """Merge partial sketches flattened per group.

    flat: per GROUP, the concatenation of its partial sketch rows'
    elements (their counts still inside); row_lens/row_counts: per element
    of flat.child, its sketch row's point count (0 for the count element)
    and true count. Resamples every group to min(points, k) points of
    equal weight and appends the merged count."""
    from .window import _segmented_cumsum
    cap = flat.capacity
    ccap = flat.child.capacity
    dev = flat.device
    epos = _arange(ccap, dev)
    in_use = (epos < flat.offsets[cap]) & flat.child.validity
    is_val = in_use & (row_lens > 0)
    w = torch.where(is_val, row_counts / torch.clamp(row_lens, min=1.0),
                    0.0)
    m = row_sums(flat, is_val.to(torch.int32)).to(torch.int32)
    erow = row_of_element(flat.offsets, epos, cap)
    n_total = torch.zeros(cap, dtype=torch.float64, device=dev) \
        .index_add_(0, erow, w)
    masked = ArrayColumn(Column(flat.child.data,
                                flat.child.validity & (row_lens > 0),
                                DOUBLE), flat.offsets, flat.validity,
                         flat.dtype)
    sorted_vals, sorted_w, sorted_row = _group_sorted_elements(masked, w)
    # cumulative weight WITHIN each group (a segment-local scan)
    cumw = _segmented_cumsum(sorted_w, sorted_row)
    valid_start = _rebuild_offsets(m)[:-1]
    out_len = torch.where(flat.validity, torch.clamp(m, max=k) + 1, 0)
    offsets = _rebuild_offsets(out_len.to(torch.int32))
    out_cap = ccap + cap
    opos = _arange(out_cap, dev)
    orow = row_of_element(offsets, opos, cap)
    o_use = opos < offsets[cap]
    j = opos - offsets[orow]
    L = torch.clamp(m, max=k)[orow]
    is_count = j == L
    # the weighted resample target of slot j of its group
    t = (j.to(torch.float64) + 0.5) * n_total[orow] \
        / torch.clamp(L, min=1).to(torch.float64)
    # the probe's rank among its group's cumulative weights (dead and
    # count elements carry the big group key from the sort): the first
    # cumulative weight >= t
    probe_key = torch.where(o_use & ~is_count, orow.to(torch.int32),
                            _BIG_ROW)
    rank = _merge_rank_1d(sorted_row, cumw, probe_key, t)
    mo = m[orow]
    idx = torch.minimum(torch.clamp(rank - valid_start[orow], min=0),
                        torch.clamp(mo - 1, min=0))
    src = torch.clamp(valid_start[orow] + idx, 0, ccap - 1).long()
    val = torch.where(is_count, n_total[orow], sorted_vals[src])
    child = Column(torch.where(o_use, val, 0.0), o_use, DOUBLE)
    return ArrayColumn(child, offsets, flat.validity, ArrayType(DOUBLE))


def approx_percentile_of_sketches(arr: ArrayColumn, percentages,
                                  result_type) -> Column:
    """The final evaluation over sketch buffers ([values..., n] a group):
    the point at weighted rank ceil(p * n) (Spark's approx_percentile
    pick)."""
    scalar = not isinstance(percentages, (list, tuple))
    ps = [float(percentages)] if scalar else [float(p) for p in percentages]
    cap = arr.capacity
    top = arr.child.capacity - 1
    lens = arr.offsets[1:] - arr.offsets[:-1]
    L = torch.clamp(lens - 1, min=0)  # value points a group
    last = torch.clamp(arr.offsets[1:] - 1, 0, top).long()
    n = torch.where(L > 0, arr.child.data[last], 0.0)  # the true counts
    has = (L > 0) & (n > 0)
    outs, valids = [], []
    for p in ps:
        # rank r = ceil(p * n) of n equal-weight values over L points:
        # point ceil(r * L / n) - 1
        r = torch.ceil(p * n)
        ci = torch.ceil(r * L.to(torch.float64)
                        / torch.clamp(n, min=1.0)) - 1
        ci = torch.minimum(torch.clamp(ci.to(torch.int32), min=0),
                           torch.clamp(L - 1, min=0))
        idx = torch.clamp(arr.offsets[:-1] + ci, 0, top).long()
        outs.append(arr.child.data[idx].to(result_type.torch_dtype))
        valids.append(arr.validity & has)
    return _result(outs, valids, result_type, scalar, arr.validity & has,
                   cap)
