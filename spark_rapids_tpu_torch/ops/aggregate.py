"""Sort-based group-by — the counterpart of `groupby_aggregate` in
spark_rapids_tpu/ops/aggregate.py, for fixed-width keys and the sum,
sum_sq, count, count_star, min and max aggregates.

Order-key lanes (ops/sort.py) -> one stable sort that moves keys and
inputs together -> segment ids at key boundaries -> one reduction per
aggregate over the segments. num_groups stays on the device and the
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

from ..columnar.column import Column
from .basic import active_mask
from .maskedagg import bucket_reduce
from .sort import SortOrder, group_segment_ids, sort_batch_columns

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
    return vals, has


def groupby_aggregate(key_columns: Sequence[Column],
                      agg_inputs: Sequence[Tuple[str, Optional[Column]]],
                      num_rows, capacity: int, pre_grouped: bool = False
                      ) -> Tuple[List[Column], List[Tuple], torch.Tensor]:
    """Sort-based group-by over one batch.

    agg_inputs: (op, input Column or None for count_star) pairs. Returns
    (grouped key columns, [("raw", (data, validity))], num_groups), all at
    the input capacity.

    pre_grouped: the caller guarantees equal keys are already contiguous
    (the inner join's key-grouped emission): the sort is skipped, since
    segment detection needs only adjacency."""
    all_cols = list(key_columns) + [c for _, c in agg_inputs
                                    if c is not None]
    if pre_grouped:
        sorted_all = all_cols
    else:
        orders = [SortOrder(i) for i in range(len(key_columns))]
        sorted_all, _ = sort_batch_columns(all_cols, orders, num_rows,
                                           capacity)
    k = len(key_columns)
    sorted_keys, sorted_in = sorted_all[:k], iter(sorted_all[k:])
    seg, num_groups = group_segment_ids(sorted_keys, num_rows, capacity)
    dev = seg.device
    act = active_mask(num_rows, capacity, dev)
    group_act = active_mask(num_groups, capacity)

    results = []
    for op, col in agg_inputs:
        g = next(sorted_in) if col is not None else None
        data, valid = _segment_reduce(op, g, seg, act, capacity)
        data = torch.where(group_act, data,
                           torch.zeros((), dtype=data.dtype, device=dev))
        results.append(("raw", (data, valid & group_act)))

    # representative key per group: the first row of each segment
    positions = torch.arange(capacity, dtype=torch.int32, device=dev)
    first = act & ((seg != torch.roll(seg, 1)) | (positions == 0))
    target = torch.where(first, seg, capacity).long()
    first_pos = torch.full((capacity + 1,), -1, dtype=torch.int32,
                           device=dev)
    first_pos[target] = positions
    from .gather import gather_batch_columns
    out_keys = gather_batch_columns(sorted_keys, first_pos[:capacity],
                                    out_valid=group_act)
    return out_keys, results, num_groups
