"""Array (list) kernels over the (child, offsets) layout — the counterpart
of spark_rapids_tpu/ops/collection.py (reference collectionOperations.scala
over cuDF lists columns).

As in the JAX package, each child element maps to its owning row by a
searchsorted over the offsets, which turns per-row operations into
reductions over each row's element span and row gathers into two
vectorised gathers. Offsets are monotone, so a row's elements are
contiguous: per-row counts are differences of one cumsum over the
elements (exact, no scatter), and only min/max per row take a scatter
reduction (a row holds few elements). Fixed-width and string element
types; sorts and extrema over string elements are tagged off at plan
time, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..columnar.column import (ArrayColumn, Column, StringColumn,
                               bucket_capacity)
from ..types import BOOLEAN, INT, LONG, ArrayType, BooleanType
from .strings import _rebuild_offsets, string_lengths

_SIGN64 = -(1 << 63)
_SIGN32 = -(1 << 31)


def array_lengths(col: ArrayColumn) -> torch.Tensor:
    return col.offsets[1:] - col.offsets[:-1]


def _arange(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=dev)


def row_of_element(offsets: torch.Tensor, idx: torch.Tensor,
                   rows: int) -> torch.Tensor:
    """The row owning each element index: the last row whose start is <=
    it, clipped into [0, rows) (int64)."""
    row = torch.searchsorted(offsets, idx, right=True) - 1
    return torch.clamp(row, 0, rows - 1)


def _row_of_child(col: ArrayColumn, idx: torch.Tensor) -> torch.Tensor:
    return row_of_element(col.offsets, idx, col.capacity)


def _elem_grid(col: ArrayColumn):
    """(idx, row (int64), in_use, pos0): each child element's index, its
    owning row, whether it lies in a row's span, and its 0-based position
    in that row."""
    idx = _arange(col.child_capacity, col.device)
    row = _row_of_child(col, idx)
    in_use = idx < col.offsets[-1]
    pos0 = idx - col.offsets[row]
    return idx, row, in_use, pos0


def row_sums(col: ArrayColumn, x: torch.Tensor) -> torch.Tensor:
    """Per row, the sum of int `x` over its element span (x has one entry
    per child element; the difference of one inclusive cumsum)."""
    cs = torch.cat([x.new_zeros(1, dtype=torch.int64),
                    torch.cumsum(x, 0, dtype=torch.int64)])
    off = torch.clamp(col.offsets, 0, x.shape[0]).long()
    return cs[off[1:]] - cs[off[:-1]]


def _row_any(col: ArrayColumn, flag: torch.Tensor) -> torch.Tensor:
    return row_sums(col, flag.to(torch.int32)) > 0


def _float_bits(data: torch.Tensor) -> torch.Tensor:
    """The IEEE bits of a float tensor as a signed int of its width."""
    if data.dtype == torch.float64:
        return data.view(torch.int64)
    return data.to(torch.float32).view(torch.int32)


def _total_order_bits(data: torch.Tensor) -> torch.Tensor:
    """The JAX package's float total-order key: sign-flipped bits (-0.0
    before 0.0, NaN payloads apart), as a signed int of the width."""
    bits = _float_bits(data)
    sign = _SIGN64 if bits.dtype == torch.int64 else _SIGN32
    return torch.where(bits < 0, ~bits, bits | sign)


def _value_order_key(child: Column) -> torch.Tensor:
    """Total-order integer key over fixed-width element values (floats by
    the sign-flip bit trick), as int64."""
    data = child.data
    if isinstance(child.dtype, BooleanType):
        return data.to(torch.int64)
    if data.dtype.is_floating_point:
        return _total_order_bits(data).to(torch.int64)
    return data.to(torch.int64)


def _sort_key(child: Column) -> torch.Tensor:
    """An int64 key whose signed order is the elements' value order (the
    JAX package's sort_array key: floats by the sign-flip bit trick, -0.0
    before 0.0), a signed 64-bit order lane for ops/sort.lexsort."""
    data = child.data
    if data.dtype.is_floating_point:
        bits = _total_order_bits(data)
        sign = _SIGN64 if bits.dtype == torch.int64 else _SIGN32
        return (bits ^ sign).to(torch.int64)
    return data.to(torch.int64)


def gather_array(col: ArrayColumn, safe_indices: torch.Tensor,
                 out_valid: torch.Tensor,
                 out_child_capacity=None) -> ArrayColumn:
    """Row gather of a list column by pre-clamped indices.

    out_child_capacity: the result's element bucket, an int, or an
    (elements, child bytes) pair for string elements. Defaults to the
    input's buckets (enough for permutations and filters); a gather that
    duplicates rows (explode's payloads) passes measured needs."""
    in_child_cap = col.child_capacity
    child_byte_cap = None
    if isinstance(out_child_capacity, tuple):
        child_cap, child_byte_cap = out_child_capacity
    else:
        child_cap = out_child_capacity or in_child_cap
    if child_byte_cap is None and child_cap > in_child_cap \
            and isinstance(col.child, StringColumn):
        raise ValueError("a duplicating gather of array<string> needs its "
                         "child byte measurement")
    idx = safe_indices.long()
    lens = torch.where(out_valid, array_lengths(col)[idx], 0)
    new_offsets = _rebuild_offsets(lens)
    src_starts = col.offsets[idx]
    pos = _arange(child_cap, col.device)
    row = row_of_element(new_offsets, pos, safe_indices.shape[0])
    intra = pos - new_offsets[row]
    in_use = pos < new_offsets[-1]
    src = torch.where(in_use, torch.clamp(src_starts[row] + intra, 0,
                                          in_child_cap - 1), 0)
    from .basic import gather_column
    child = gather_column(col.child, torch.where(in_use, src, -1),
                          out_byte_capacity=child_byte_cap)
    return ArrayColumn(child, new_offsets, out_valid, col.dtype)


def concat_arrays(a: ArrayColumn, b: ArrayColumn, a_rows, b_rows,
                  out_capacity: int) -> ArrayColumn:
    """Concatenate two list columns' active rows (the coalesce
    primitive): the row lengths concatenate, and each side's elements
    gather into the combined child."""
    dev = a.device
    idx = _arange(out_capacity, dev)
    from_b = idx >= a_rows
    out_valid = idx < a_rows + b_rows

    def side_lens(col, rows):
        act = _arange(col.capacity, dev) < rows
        return torch.where(act, array_lengths(col), 0)

    la, lb = side_lens(a, a_rows), side_lens(b, b_rows)
    a_safe = torch.where(idx < a.capacity, idx, 0).long()
    b_safe = torch.clamp(idx - a_rows, 0, b.capacity - 1).long()
    out_lens = torch.where(out_valid,
                           torch.where(from_b, lb[b_safe], la[a_safe]), 0)
    new_offsets = _rebuild_offsets(out_lens)
    valid = torch.where(from_b, b.validity[b_safe], a.validity[a_safe]) \
        & out_valid

    child_cap = bucket_capacity(max(a.child_capacity + b.child_capacity, 1))
    pos = _arange(child_cap, dev)
    row = row_of_element(new_offsets, pos, out_capacity)
    intra = pos - new_offsets[row]
    in_use = pos < new_offsets[-1]
    elem_from_b = from_b[row]
    src_a = a.offsets[torch.clamp(row, 0, a.capacity - 1)] + intra
    src_b = b.offsets[torch.clamp(row - a_rows, 0, b.capacity - 1)] + intra
    from .basic import gather_column
    child_a = gather_column(
        a.child, torch.where(in_use & ~elem_from_b,
                             torch.clamp(src_a, 0, a.child_capacity - 1),
                             -1))
    child_b = gather_column(
        b.child, torch.where(in_use & elem_from_b,
                             torch.clamp(src_b, 0, b.child_capacity - 1),
                             -1))
    # merge the two gathers (disjoint slots)
    cvalid = torch.where(elem_from_b, child_b.validity, child_a.validity)
    if isinstance(a.child, StringColumn):
        lens_c = torch.where(elem_from_b, string_lengths(child_b),
                             string_lengths(child_a))
        off_c = _rebuild_offsets(torch.where(in_use, lens_c, 0))
        byte_cap = bucket_capacity(child_a.byte_capacity
                                   + child_b.byte_capacity)
        bpos = _arange(byte_cap, dev)
        brow = row_of_element(off_c, bpos, child_cap)
        bintra = bpos - off_c[brow]
        b_use = bpos < off_c[-1]
        eb = elem_from_b[brow]
        pa = torch.clamp(child_a.offsets[brow] + bintra, 0,
                         child_a.byte_capacity - 1).long()
        pb = torch.clamp(child_b.offsets[brow] + bintra, 0,
                         child_b.byte_capacity - 1).long()
        data = torch.where(b_use, torch.where(eb, child_b.data[pb],
                                              child_a.data[pa]), 0)
        child = StringColumn(data.to(torch.uint8), off_c, cvalid,
                             a.child.dtype)
    else:
        child = Column(torch.where(elem_from_b, child_b.data, child_a.data),
                       cvalid, a.child.dtype)
    return ArrayColumn(child, new_offsets, valid, a.dtype)


def array_size(col: ArrayColumn) -> Column:
    """size(arr) (spark.sql.legacy.sizeOfNull=false: null for null)."""
    return Column(array_lengths(col).to(torch.int32), col.validity, INT)


def array_contains(col: ArrayColumn, value) -> Column:
    """array_contains(arr, literal): Spark's 3-valued result — true if
    present, null if absent but the array holds a null, false otherwise."""
    child = col.child
    idx, _, in_use, _ = _elem_grid(col)
    if isinstance(child, StringColumn):
        from .strings import str_starts_with
        needle = value.encode("utf-8") if isinstance(value, str) else value
        eq = str_starts_with(child, needle).data \
            & (string_lengths(child) == len(needle))
        match = eq & child.validity & in_use
    else:
        match = (child.data == value) & child.validity & in_use
    has_match = _row_any(col, match)
    has_null = _row_any(col, ~child.validity & in_use)
    valid = col.validity & (has_match | ~has_null)
    return Column(has_match, valid, BOOLEAN)


def _take_element(col: ArrayColumn, pos: torch.Tensor,
                  ok: torch.Tensor) -> Column:
    from .basic import gather_column
    src = torch.where(ok, col.offsets[:-1] + pos, -1)
    return gather_column(col.child, src.to(torch.int32))


def element_at(col: ArrayColumn, index: int) -> Column:
    """element_at(arr, i): 1-based; negative from the end; null out of
    bounds (non-ANSI Spark)."""
    lens = array_lengths(col)
    if index >= 0:
        pos = torch.full_like(lens, index - 1)
    else:
        pos = lens + index
    ok = (pos >= 0) & (pos < lens) & col.validity
    return _take_element(col, pos, ok)


def element_at_col(col: ArrayColumn, idx: Column) -> Column:
    """element_at(arr, expr): a per-row 1-based index, negative from the
    end, null out of bounds or for a null index. A row whose index is 0
    gives NULL (the JAX package's documented deviation: Spark raises)."""
    lens = array_lengths(col)
    i = idx.data.to(torch.int32)
    pos = torch.where(i >= 0, i - 1, lens + i)
    ok = (pos >= 0) & (pos < lens) & col.validity & idx.validity
    return _take_element(col, pos, ok)


def get_array_item(col: ArrayColumn, index: int) -> Column:
    """arr[i]: 0-based, null out of bounds (GetArrayItem non-ANSI); a
    NULL literal index gives NULL rows."""
    lens = array_lengths(col)
    pos = torch.full_like(lens, -1 if index is None else index)
    ok = (pos >= 0) & (pos < lens) & col.validity
    return _take_element(col, pos, ok)


def get_array_item_col(col: ArrayColumn, idx: Column) -> Column:
    """arr[expr]: a per-row 0-based index, null for a negative or
    out-of-bounds index and for a null array or index (GetArrayItem,
    non-ANSI)."""
    lens = array_lengths(col).to(torch.int64)
    i = idx.data.to(torch.int64)
    ok = (i >= 0) & (i < lens) & col.validity & idx.validity
    return _take_element(col, torch.where(ok, i, 0).to(torch.int32), ok)


def _element_sort(lanes):
    from .sort import lexsort
    return lexsort(lanes).to(torch.int32)


def sort_array(col: ArrayColumn, ascending: bool = True) -> ArrayColumn:
    """sort_array over fixed-width elements: asc puts nulls first, desc
    last (Spark). One sort by (row, unused, null rank, value)."""
    child = col.child
    if isinstance(child, StringColumn):
        raise NotImplementedError(
            "sort_array over string elements needs sort lanes (tagged off "
            "at plan time)")
    idx, row, in_use, _ = _elem_grid(col)
    # bitwise-not reverses the order with no INT_MIN negation overflow
    key = _sort_key(child) if ascending else ~_sort_key(child)
    null_rank = child.validity if ascending else ~child.validity
    perm = _element_sort([(row, 32), ((~in_use).to(torch.int64), 1),
                          (null_rank.to(torch.int64), 1), (key, 64)])
    from .basic import gather_column
    return ArrayColumn(gather_column(child, perm), col.offsets,
                       col.validity, col.dtype)


def _extreme(dtype: torch.dtype, high: bool):
    if dtype.is_floating_point:
        return float("inf") if high else float("-inf")
    if dtype == torch.bool:
        return high
    info = torch.iinfo(dtype)
    return info.max if high else info.min


def array_min_max(col: ArrayColumn, op: str) -> Column:
    """array_min / array_max over fixed-width elements (nulls skipped;
    null when every element is null or the array is empty or null)."""
    child = col.child
    idx, row, in_use, _ = _elem_grid(col)
    ok = in_use & child.validity
    data = child.data
    wide = data.to(torch.int8) if data.dtype == torch.bool else data
    fill = _extreme(wide.dtype, op == "min")
    vals = torch.where(ok, wide, torch.full((), fill, dtype=wide.dtype,
                                            device=wide.device))
    res = torch.full((col.capacity,), fill, dtype=wide.dtype,
                     device=wide.device)
    res = res.scatter_reduce_(0, row, vals,
                              reduce="amin" if op == "min" else "amax")
    valid = col.validity & _row_any(col, ok)
    res = torch.where(valid, res, torch.zeros((), dtype=res.dtype,
                                              device=res.device))
    return Column(res.to(data.dtype), valid, col.dtype.element_type)


def create_array(cols, dtype: ArrayType) -> ArrayColumn:
    """array(c1..ck): k elements per row (fixed-width inputs)."""
    k = len(cols)
    cap = cols[0].capacity
    data = torch.stack([c.data for c in cols], 1).reshape(cap * k)
    valid = torch.stack([c.validity for c in cols], 1).reshape(cap * k)
    child = Column(data, valid, dtype.element_type)
    offsets = _arange(cap + 1, data.device) * k
    return ArrayColumn(child, offsets,
                       torch.ones(cap, dtype=torch.bool,
                                  device=data.device), dtype)


# -- the device kernels of the JAX package's former host-tier family -------
# (reference collectionOperations.scala: GpuArrayPosition, GpuArrayRemove,
# GpuArrayDistinct, GpuSlice, GpuFlatten, GpuArraysOverlap,
# GpuArrayRepeat, GpuSequence)

def _rebuild_with_keep(col: ArrayColumn, keep: torch.Tensor) -> ArrayColumn:
    """Keep only the flagged elements in use, each row's order kept (a
    stable compaction keeps the rows contiguous)."""
    from .basic import active_mask, compaction_order, gather_column
    _, _, in_use, _ = _elem_grid(col)
    k = keep & in_use
    new_offsets = _rebuild_offsets(row_sums(col, k.to(torch.int32))
                                   .to(torch.int32))
    perm, total = compaction_order(k, col.offsets[-1])
    new_child = gather_column(
        col.child, torch.where(active_mask(total, col.child_capacity),
                               perm, -1))
    return ArrayColumn(new_child, new_offsets, col.validity, col.dtype)


def _spark_value_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spark's ordering equality (Double.compare): NaN == NaN, but -0.0 !=
    0.0. Floats compare as f64 bit patterns with NaN canonicalised."""
    if a.dtype.is_floating_point:
        def bits(x):
            d = x.to(torch.float64)
            d = torch.where(torch.isnan(d), float("nan"), d)
            return d.view(torch.int64)
        return bits(a) == bits(b)
    return a == b


def array_position(col: ArrayColumn, value: Column) -> Column:
    """array_position(arr, v): the 1-based first index of v (a per-row
    value), 0 when absent, NULL when the array or v is NULL; null elements
    never match (Spark GpuArrayPosition)."""
    idx, row, in_use, pos0 = _elem_grid(col)
    child = col.child
    match = in_use & child.validity & value.validity[row] \
        & _spark_value_eq(child.data, value.data[row])
    big = (1 << 31) - 1
    first = torch.full((col.capacity,), big, dtype=torch.int32,
                       device=col.device)
    first.scatter_reduce_(0, row, torch.where(match, pos0 + 1, big),
                          reduce="amin")
    data = torch.where(first == big, 0, first).to(torch.int64)
    valid = col.validity & value.validity
    return Column(torch.where(valid, data, 0), valid, LONG)


def array_remove(col: ArrayColumn, value: Column) -> ArrayColumn:
    """array_remove(arr, v): drop the elements equal to v (nulls kept,
    Spark's ordering equality); NULL array or v gives NULL."""
    _, row, _, _ = _elem_grid(col)
    child = col.child
    drop = child.validity & value.validity[row] \
        & _spark_value_eq(child.data, value.data[row])
    out = _rebuild_with_keep(col, ~drop)
    return ArrayColumn(out.child, out.offsets,
                       out.validity & value.validity, out.dtype)


def array_distinct(col: ArrayColumn) -> ArrayColumn:
    """array_distinct: the first occurrence of each value in order; one
    NULL element survives (Spark GpuArrayDistinct). One stable sort by
    (row, unused, null, value) marks each run's first element."""
    idx, row, in_use, _ = _elem_grid(col)
    child = col.child
    nullflag = ~child.validity
    key = torch.where(child.validity, _value_order_key(child), 0)
    perm = _element_sort([(row, 32), ((~in_use).to(torch.int64), 1),
                          (nullflag.to(torch.int64), 1),
                          (key, 64)])
    p = perm.long()
    srow, snull, skey = row[p], nullflag[p], key[p]
    dup = (srow == torch.roll(srow, 1)) & (snull == torch.roll(snull, 1)) \
        & (skey == torch.roll(skey, 1))
    dup[0] = False
    keep = torch.zeros(col.child_capacity, dtype=torch.bool,
                       device=col.device)
    keep[p] = ~dup
    return _rebuild_with_keep(col, keep)


def array_slice(col: ArrayColumn, start: Column,
                length: Column) -> ArrayColumn:
    """slice(arr, start, length): 1-based start, negative from the end; a
    negative start past the front gives []. A row whose start is 0 or
    whose length is negative gives NULL (the JAX package's documented
    deviation: Spark raises)."""
    _, row, _, pos0 = _elem_grid(col)
    lens = array_lengths(col)
    s = start.data.to(torch.int32)
    ln = length.data.to(torch.int32)
    s0 = torch.where(s > 0, s - 1, lens + s)
    s0e = s0[row]
    keep = (pos0 >= s0e) & (pos0 < s0e + ln[row]) & (s0e >= 0)
    out = _rebuild_with_keep(col, keep)
    bad = ((s == 0) & start.validity) | ((ln < 0) & length.validity)
    valid = out.validity & start.validity & length.validity & ~bad
    return ArrayColumn(out.child, out.offsets, valid, out.dtype)


def flatten_array(col: ArrayColumn) -> ArrayColumn:
    """flatten(arr<arr<T>>) -> arr<T>: a composition of offsets (the
    nested layout is row-major contiguous); NULL when the row or any
    inner array in it is NULL (Spark GpuFlatten)."""
    inner = col.child
    if not isinstance(inner, ArrayColumn):
        raise TypeError("flatten needs nested arrays")
    o = torch.clamp(col.offsets, 0, inner.capacity).long()
    new_offsets = inner.offsets[o]
    idx, _, in_use, _ = _elem_grid(col)  # inner rows as elements
    inner_null = in_use & ~inner.validity[torch.clamp(
        idx, 0, inner.capacity - 1).long()]
    valid = col.validity & ~_row_any(col, inner_null)
    return ArrayColumn(inner.child, new_offsets, valid,
                       ArrayType(inner.dtype.element_type))


def arrays_overlap(a: ArrayColumn, b: ArrayColumn) -> Column:
    """arrays_overlap(a, b): TRUE when a non-null element is shared; NULL
    when none is but either side holds a NULL element and both are
    non-empty; FALSE otherwise; NULL when either array is NULL (Spark
    GpuArraysOverlap). One sort of both element sets by (row, bad,
    value, side): a shared value puts an a-entry beside a b-entry."""
    ca, cb = a.child, b.child
    na, nb = ca.capacity, cb.capacity
    _, row_a, use_a, _ = _elem_grid(a)
    _, row_b, use_b, _ = _elem_grid(b)
    rows = torch.cat([row_a, row_b])
    validc = torch.cat([ca.validity, cb.validity])
    key = torch.cat([_value_order_key(ca), _value_order_key(cb)])
    key = torch.where(validc, key, 0)
    side = torch.cat([torch.zeros(na, dtype=torch.int64, device=a.device),
                      torch.ones(nb, dtype=torch.int64, device=a.device)])
    bad = ~(torch.cat([use_a, use_b]) & validc)
    perm = _element_sort([(rows, 32), (bad.to(torch.int64), 1),
                          (key, 64), (side, 1)]).long()
    srow, sbad, skey, sside = rows[perm], bad[perm], key[perm], side[perm]
    adj = (srow == torch.roll(srow, 1)) & ~sbad & ~torch.roll(sbad, 1) \
        & (skey == torch.roll(skey, 1)) & (sside != torch.roll(sside, 1))
    adj[0] = False
    hit = torch.zeros(a.capacity, dtype=torch.int32, device=a.device)
    hit.scatter_reduce_(0, srow, adj.to(torch.int32), reduce="amax")
    hit = hit > 0
    has_null_a = _row_any(a, use_a & ~ca.validity)
    has_null_b = _row_any(b, use_b & ~cb.validity)
    null_out = ~hit & (has_null_a | has_null_b) \
        & (array_lengths(a) > 0) & (array_lengths(b) > 0)
    valid = a.validity & b.validity & ~null_out
    return Column(hit & valid, valid, BOOLEAN)


def _repeat_rows(offsets: torch.Tensor, child_capacity: int, rows: int):
    idx = _arange(child_capacity, offsets.device)
    row = row_of_element(offsets, idx, rows)
    return idx, row, idx < offsets[-1]


def array_repeat(elem: Column, count: Column,
                 child_capacity: int) -> ArrayColumn:
    """array_repeat(e, n): n copies of e a row; a negative n gives an
    empty array, a NULL n NULL (Spark GpuArrayRepeat). The caller sizes
    child_capacity."""
    cap = elem.capacity
    cnt = torch.where(count.validity, count.data.to(torch.int32), 0)
    offsets = _rebuild_offsets(torch.clamp(cnt, min=0))
    _, row, in_use = _repeat_rows(offsets, child_capacity, cap)
    data = torch.where(in_use, elem.data[row],
                       torch.zeros((), dtype=elem.data.dtype,
                                   device=elem.device))
    child = Column(data, in_use & elem.validity[row], elem.dtype)
    return ArrayColumn(child, offsets, count.validity, ArrayType(elem.dtype))


def sequence_array(start: Column, stop: Column, step: Column,
                   child_capacity: int) -> ArrayColumn:
    """sequence(start, stop, step) over integers (Spark GpuSequence); a
    row whose step is zero or points away from stop gives NULL (the JAX
    package's documented deviation: Spark raises). The caller sizes
    child_capacity."""
    cap = start.capacity
    s = start.data.to(torch.int64)
    e = stop.data.to(torch.int64)
    st = step.data.to(torch.int64)
    in_valid = start.validity & stop.validity & step.validity
    ok_dir = (st != 0) & torch.where(st > 0, e >= s, e <= s)
    # start == stop with any nonzero step gives [start]
    ok = in_valid & (ok_dir | (s == e))
    safe_st = torch.where(st == 0, 1, st)
    n = torch.where(ok, torch.abs(torch.where(
        st != 0, torch.div(e - s, safe_st, rounding_mode="floor"), 0)) + 1,
        0).to(torch.int32)
    offsets = _rebuild_offsets(n)
    idx, row, in_use = _repeat_rows(offsets, child_capacity, cap)
    pos = (idx - offsets[row]).to(torch.int64)
    data = s[row] + pos * st[row]
    child = Column(torch.where(in_use, data, 0).to(start.data.dtype),
                   in_use, start.dtype)
    return ArrayColumn(child, offsets, ok, ArrayType(start.dtype))
