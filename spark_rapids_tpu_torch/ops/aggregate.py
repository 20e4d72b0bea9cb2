"""Group-by kernels — the counterpart of `groupby_aggregate`,
`groupby_aggregate_hash`, `_aggregate_with_assignment`, `_collect_group`
and `collect_all` in spark_rapids_tpu/ops/aggregate.py, for fixed-width
and string keys and the sum, sum_sq, count, count_star, min, max and
first/last aggregates (min, max, first and last over strings too), and
the list buffers of collect_list, collect_set and the percentiles
(`collect`, `collect_set`, `collect_merge`, `psketch:K`,
`psketch_merge:K`), which only the sort path takes, as in the JAX
package: over key-sorted rows a group's list is its compacted values with
the group boundaries as offsets. first/last pick by row
position within the batch, as the JAX package's do: after the stable
sort on the sort path (or in input order when `pre_grouped`), in input
order on the hash path.

Sort-based: order-key lanes (ops/sort.py; a string key orders by its
prefix lanes, `string_words` of them, and its length) -> one stable sort
that moves keys and inputs together -> segment ids at key boundaries ->
one reduction per aggregate over the segments. Hash-based (`groupby_aggregate_hash`, the
primary path for string keys): the group slots of ops/hashagg.py, dense
ids in slot order, the same reductions, and a `leftover` flag that sends
the caller to the sort path. num_groups stays on the device and the
output keeps the input capacity, rows >= num_groups inactive.

The JAX package sums through a segment-local prefix scan read at each
group's last row, so that small groups keep their precision. The port
reduces each segment directly (ops/maskedagg.bucket_reduce with one
bucket per segment): the same per-group sums, taken in another order, so
f64 results agree to rtol 1e-9 (the tolerance the reference allows
between its own tiers), integers exactly.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar.column import Column, StringColumn
from .basic import active_mask, gather_column
from .maskedagg import FIRST_LAST_OPS, bucket_reduce, pick_position
from .sort import (SortOrder, group_segment_ids, lexsort,
                   sort_batch_columns, string_order_lanes, string_words_for)

#: first/last skip nulls (ignoreNulls=True); first_any/last_any take the
#: first/last row whatever its value (Spark's default ignoreNulls=False)
AGG_OPS = ("sum", "sum_sq", "count", "count_star", "min", "max", "first",
           "last", "first_any", "last_any")
#: the list-buffer ops (a psketch op carries its K after a colon)
COLLECT_OPS = ("collect", "collect_set", "collect_merge", "psketch",
               "psketch_merge")


def is_collect_op(op: str) -> bool:
    return op.split(":")[0] in COLLECT_OPS


def _segment_reduce(op: str, col: Optional[Column], seg, act,
                    capacity: int):
    """One aggregate over the segments of the active rows: (data,
    validity) per segment id."""
    if op not in AGG_OPS:
        raise ValueError(f"unknown aggregate op {op!r}")
    vals, has = bucket_reduce(op, col, seg.long(), capacity, act)
    if has is None:  # count / count_star: never null
        return vals.to(torch.int64), torch.ones_like(act)
    return vals, has  # a decimal sum's vals: its (hi, lo) limb lanes


def _reduce_result(op: str, col: Optional[Column], seg, act, group_act,
                   capacity: int):
    """One aggregate's tagged result over the segments: ("raw", (data,
    validity)), or for first/last over strings ("col", a StringColumn:
    the picked row of each segment, gathered)."""
    if isinstance(col, StringColumn) and op in FIRST_LAST_OPS:
        pick = pick_position(op, seg.long(), capacity, act,
                             col.validity & act)
        ok = (pick >= 0) & (pick < capacity) & group_act
        safe = torch.clamp(pick, 0, capacity - 1).to(torch.int32)
        return "col", gather_column(col, safe, out_valid=ok)
    if isinstance(col, StringColumn) and op != "count":
        raise NotImplementedError(
            f"{op} over strings takes the sort path (ops/aggregate."
            f"groupby_aggregate)")
    data, valid = _segment_reduce(op, col, seg, act, capacity)
    zero = torch.zeros((), dtype=torch.int64, device=seg.device)
    if isinstance(data, tuple):  # decimal128 (hi, lo) limbs
        data = tuple(torch.where(group_act, d, zero) for d in data)
    else:
        data = torch.where(group_act, data, zero.to(data.dtype))
    return "raw", (data, valid & group_act)


def groupby_aggregate(key_columns: Sequence[Column],
                      agg_inputs: Sequence[Tuple[str, Optional[Column]]],
                      num_rows, capacity: int,
                      string_words: Optional[int] = None,
                      pre_grouped: bool = False
                      ) -> Tuple[List[Column], List[Tuple], torch.Tensor]:
    """Sort-based group-by over one batch.

    agg_inputs: (op, input Column or None for count_star) pairs. Returns
    (grouped key columns, [("raw", (data, validity)) or ("col", column)],
    num_groups), all at the input capacity. String keys and min/max over
    strings order by `string_words` prefix lanes and their length (exact
    when the prefix covers the longest string; None: ops/sort.
    string_words_for the keys and the min/max inputs).

    pre_grouped: the caller guarantees equal keys are already contiguous
    (the inner join's key-grouped emission): the sort is skipped, since
    segment detection needs only adjacency."""
    all_cols = list(key_columns) + [c for _, c in agg_inputs
                                    if c is not None]
    if string_words is None:
        ordered = list(key_columns) + [c for op, c in agg_inputs
                                       if op in ("min", "max")]
        string_words = string_words_for(ordered, range(len(ordered)))
    if pre_grouped:
        sorted_all = all_cols
    else:
        orders = [SortOrder(i) for i in range(len(key_columns))]
        sorted_all, _ = sort_batch_columns(all_cols, orders, num_rows,
                                           capacity, string_words)
    k = len(key_columns)
    sorted_keys, sorted_in = sorted_all[:k], iter(sorted_all[k:])
    seg, num_groups = group_segment_ids(sorted_keys, num_rows, capacity,
                                        string_words)
    dev = seg.device
    act = active_mask(num_rows, capacity, dev)
    group_act = active_mask(num_groups, capacity)
    positions = torch.arange(capacity, dtype=torch.int32, device=dev)

    results = []
    for op, col in agg_inputs:
        g = next(sorted_in) if col is not None else None
        if is_collect_op(op):
            results.append(("col", _collect_group(op, g, seg, act, capacity,
                                                  group_act)))
            continue
        if isinstance(g, StringColumn) and op in ("min", "max",
                                                   *FIRST_LAST_OPS):
            lanes = string_order_lanes(g, string_words) \
                if op in ("min", "max") else ()
            pick = _pick_string_pos(op, lanes, g.validity, seg, capacity,
                                    positions)
            ok = pick < capacity
            results.append(("col", gather_column(
                g, torch.clamp(pick, 0, capacity - 1),
                out_valid=ok & group_act)))
            continue
        results.append(_reduce_result(op, g, seg, act, group_act,
                                      capacity))

    # representative key per group: the first row of each segment
    first = act & ((seg != torch.roll(seg, 1)) | (positions == 0))
    target = torch.where(first, seg, capacity).long()
    first_pos = torch.full((capacity + 1,), -1, dtype=torch.int32,
                           device=dev)
    first_pos[target] = positions
    from .gather import gather_batch_columns
    out_keys = gather_batch_columns(sorted_keys, first_pos[:capacity],
                                    out_valid=group_act)
    return out_keys, results, num_groups


def _pick_string_pos(op: str, lanes, valid, seg, capacity: int, positions):
    """Row of the min (max) valid string of each segment, or capacity for a
    segment without one: rows sorted by (segment, null last, the string's
    order lanes, inverted for max), then each segment's first valid
    row. first/last pick by position (`pick_position`)."""
    if op in FIRST_LAST_OPS:
        act = seg < capacity
        pick = pick_position(op, seg.long(), capacity, act, valid & act)
        ok = (pick >= 0) & (pick < capacity)
        return torch.where(ok, pick, capacity).to(torch.int32)
    key = [(seg.to(torch.int64), 32), ((~valid).to(torch.int64), 1)]
    for lane, bits in lanes:
        if op == "max":
            lane = ~lane if bits == 64 else ((1 << bits) - 1) - lane
        key.append((lane, bits))
    sorted_pos = lexsort(key)
    sorted_seg = seg[sorted_pos]
    cand = torch.where(valid[sorted_pos], positions, capacity)
    first = torch.full((capacity + 1,), capacity, dtype=torch.int32,
                       device=seg.device)
    first.scatter_reduce_(0, sorted_seg.long(), cand, reduce="amin")
    first = first[:capacity]
    ok = first < capacity
    picked = sorted_pos[torch.clamp(first, 0, capacity - 1).long()]
    return torch.where(ok, picked.to(torch.int32), capacity)


def groupby_aggregate_hash(key_columns: Sequence[Column],
                           agg_inputs: Sequence[Tuple[str, Optional[Column]]],
                           num_rows, capacity: int, rounds: int = 2):
    """Hash-path group-by (ops/hashagg.py), no sort: the same (keys,
    results, num_groups) as groupby_aggregate, plus the device flag
    `leftover`. When it is True some rows stayed unresolved and the caller
    must run the sort-based group-by instead. min/max over strings need
    order lanes: the exec sends such plans to the sort path."""
    from .hashagg import hash_group_assignment
    seg_slots, rep_row, leftover = hash_group_assignment(
        key_columns, num_rows, capacity, rounds)
    keys, results, num_groups = _aggregate_with_assignment(
        key_columns, agg_inputs, num_rows, capacity, rounds, seg_slots,
        rep_row)
    return keys, results, num_groups, leftover


def _aggregate_with_assignment(key_columns, agg_inputs, num_rows,
                               capacity: int, rounds: int, seg_slots,
                               rep_row):
    """Aggregate over a hash group assignment, groups in slot order."""
    from .hashagg import dense_group_ids
    seg, group_rep, num_groups = dense_group_ids(seg_slots, rep_row,
                                                 capacity, rounds)
    act = active_mask(num_rows, capacity, seg.device)
    group_act = active_mask(num_groups, capacity)
    results = [_reduce_result(op, col, seg, act, group_act, capacity)
               for op, col in agg_inputs]
    rep = torch.clamp(group_rep, 0, capacity - 1)
    out_keys = [gather_column(c, rep, out_valid=group_rep < capacity)
                for c in key_columns]
    return out_keys, results, num_groups


# -- list buffers: collect_list, collect_set and the percentiles -----------

def _group_offsets(sizes: torch.Tensor, seg: torch.Tensor, act,
                   capacity: int) -> torch.Tensor:
    """(capacity + 1,) int32 offsets of per-group lists over KEY-SORTED
    rows: group g's list starts at the sizes summed over the rows before
    its first row (groups are contiguous), so no scatter-add is needed;
    groups past the last one are empty."""
    dev = seg.device
    pos = torch.arange(capacity, dtype=torch.int64, device=dev)
    is_first = act & ((seg != torch.roll(seg, 1)) | (pos == 0))
    first = torch.full((capacity + 1,), capacity, dtype=torch.int64,
                       device=dev)
    first[torch.where(is_first, seg.long(), capacity)] = pos
    first[capacity] = capacity  # the dropped writes' slot: the total
    cs = torch.cat([sizes.new_zeros(1, dtype=torch.int64),
                    torch.cumsum(sizes, 0, dtype=torch.int64)])
    return cs[first].to(torch.int32)


def _dedup_lanes(col: Column):
    """A fixed-width value's dedup lane with Spark's equality: -0.0 equals
    0.0 and every NaN equals every other (a signed 64-bit lane)."""
    data = col.data
    if data.dtype.is_floating_point:
        d = data.to(torch.float64)
        d = torch.where(d == 0.0, 0.0, d)
        d = torch.where(torch.isnan(d), float("nan"), d)
        return [(d.view(torch.int64), 64)]
    return [(data.to(torch.int64), 64)]


def first_occurrence(col: Column, group_key: torch.Tensor,
                     keep: torch.Tensor) -> torch.Tensor:
    """The first kept row of each (group key, value) pair: the dedup of
    collect_set. A stable sort by (key, value) keeps the earliest row of
    each run."""
    n = keep.shape[0]
    gk = torch.where(keep, group_key.to(torch.int64), 1 << 30)
    perm = lexsort([(gk, 31)] + _dedup_lanes(col))
    sgk = gk[perm]
    diff = torch.ones(n, dtype=torch.bool, device=keep.device)
    diff[1:] = sgk[1:] != sgk[:-1]
    for lane, _ in _dedup_lanes(col):
        sl = lane[perm]
        diff[1:] |= sl[1:] != sl[:-1]
    out = torch.zeros(n, dtype=torch.bool, device=keep.device)
    out[perm] = diff & (sgk < (1 << 30))
    return out


def _compact_into_list(g: Column, keep, offsets, group_act, capacity: int):
    from ..columnar.column import ArrayColumn
    from ..types import ArrayType
    from .basic import compaction_order
    perm, n_kept = compaction_order(keep, capacity)
    child = gather_column(g, perm, active_mask(n_kept, capacity))
    return ArrayColumn(child, offsets, group_act, ArrayType(g.dtype))


def _collect_group(op: str, g: Column, seg, act, capacity: int,
                   group_act) -> Column:
    """collect_list/collect_set/percentile update and merge over
    key-sorted rows (reference GpuCollectList/GpuCollectSet): 'collect'
    the group's values in row order, nulls dropped; 'collect_set' also
    deduplicated; 'collect_merge' the concatenation of the group's
    partial lists; 'psketch:K' the collected values compressed into the
    sketch; 'psketch_merge:K' the group's partial sketches merged."""
    from ..columnar.column import ArrayColumn
    from .collection import array_lengths, row_of_element
    if op == "collect_merge" or op.startswith("psketch_merge"):
        # g is key-sorted: each group's lists are contiguous, so the
        # gathered child IS the concatenation
        lens = torch.where(act & g.validity, array_lengths(g), 0)
        offsets = _group_offsets(lens, seg, act, capacity)
        flat = ArrayColumn(g.child, offsets, group_act, g.dtype)
        if op == "collect_merge":
            return flat
        # each element's sketch row: its point count (0 for the row's
        # trailing count element) and true count
        from .percentile import sketch_merge
        rowlen = array_lengths(g)
        ccap = g.child.capacity
        epos = torch.arange(ccap, dtype=torch.int32, device=seg.device)
        prow = row_of_element(g.offsets, epos, capacity)
        last = torch.clamp(g.offsets[1:] - 1, 0, ccap - 1).long()
        counts_row = torch.where(rowlen > 0, g.child.data[last], 0.0)
        is_count = (epos - g.offsets[prow]) == (rowlen[prow] - 1)
        row_lens = torch.where(is_count, 0.0, torch.clamp(
            rowlen - 1, min=0)[prow].to(torch.float64))
        return sketch_merge(flat, row_lens,
                            counts_row[prow].to(torch.float64),
                            int(op.split(":")[1]))
    if op.startswith("psketch"):
        from .percentile import sketch_compress
        collected = _collect_group("collect", g, seg, act, capacity,
                                   group_act)
        return sketch_compress(collected, int(op.split(":")[1]))
    keep = act & g.validity  # Spark: collect_* drop nulls
    if op == "collect_set":
        keep = keep & first_occurrence(g, seg, keep)
    offsets = _group_offsets(keep.to(torch.int32), seg, act, capacity)
    return _compact_into_list(g, keep, offsets, group_act, capacity)


def collect_all(op: str, col: Column, num_rows, capacity: int) -> Column:
    """A grand aggregate's list buffer: ONE row holding every valid value
    (deduplicated for a set; for a merge, every partial list)."""
    dev = col.validity.device
    act = active_mask(num_rows, capacity, dev)
    seg = torch.where(act, 0, capacity).to(torch.int32)
    group_act = torch.zeros(capacity, dtype=torch.bool, device=dev)
    group_act[0] = True
    return _collect_group(op, col, seg, act, capacity, group_act)


def dedup_array(col) -> Column:
    """Remove duplicate elements within each list (collect_set's
    evaluation; fixed-width elements)."""
    from ..columnar.column import ArrayColumn
    from .collection import _elem_grid, row_sums
    from .strings import _rebuild_offsets
    child = col.child
    _, row, in_use, _ = _elem_grid(col)
    keep = in_use & child.validity
    keep = keep & first_occurrence(child, row, keep)
    counts = torch.where(col.validity, row_sums(col, keep.to(torch.int32)),
                         0).to(torch.int32)
    from .basic import compaction_order
    cap = child.capacity
    perm, n_kept = compaction_order(keep, cap)
    new_child = gather_column(child, perm, active_mask(n_kept, cap))
    return ArrayColumn(new_child, _rebuild_offsets(counts), col.validity,
                       col.dtype)
