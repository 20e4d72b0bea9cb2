"""Group-by kernels — the counterpart of `groupby_aggregate`,
`groupby_aggregate_hash` and `_aggregate_with_assignment` in
spark_rapids_tpu/ops/aggregate.py, for fixed-width and string keys and
the sum, sum_sq, count, count_star, min and max aggregates (min and max
over strings too).

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
from .maskedagg import bucket_reduce
from .sort import (SortOrder, group_segment_ids, lexsort,
                   sort_batch_columns, string_order_lanes, string_words_for)

AGG_OPS = ("sum", "sum_sq", "count", "count_star", "min", "max")


def _segment_reduce(op: str, col: Optional[Column], seg, act,
                    capacity: int):
    """One aggregate over the segments of the active rows: (data,
    validity) per segment id."""
    if op not in AGG_OPS:
        raise NotImplementedError(
            f"aggregate {op!r} waits for a later slice (ROADMAP A.2)")
    vals, has = bucket_reduce(op, col, seg.long(), capacity, act)
    if has is None:  # count / count_star: never null
        return vals.to(torch.int64), torch.ones_like(act)
    return vals, has  # a decimal sum's vals: its (hi, lo) limb lanes


def _reduce_result(op: str, col: Optional[Column], seg, act, group_act,
                   capacity: int):
    """One aggregate's tagged result over the segments: ("raw", (data,
    validity)), or for min/max over strings ("col", a StringColumn)."""
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
        if isinstance(g, StringColumn) and op in ("min", "max"):
            pick = _pick_string_pos(op, string_order_lanes(g, string_words),
                                    g.validity, seg, capacity, positions)
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
    row."""
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
