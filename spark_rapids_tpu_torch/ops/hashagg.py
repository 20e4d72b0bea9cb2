"""Hash group assignment — the counterpart of spark_rapids_tpu/ops/hashagg.py:
the primary group-by for string keys, with the sort-based group-by as its
fallback (the reference's duality, GpuAggregateExec.scala:909).

No open addressing and no probing loop. R static rounds of a
collision-verified scatter; round r:
  1. bucket b = xxhash64(keys, seed=r) mod capacity (capacities are powers
     of two, so the modulo is a mask of the hash's bits);
  2. each bucket's representative is its smallest remaining row index
     (one scatter-min into a spare drop slot);
  3. rows whose keys equal their bucket's representative's resolve to
     slot r * capacity + b (a hash collision between distinct keys fails
     the compare);
  4. the rest go on to round r + 1 with another seed.
Equal keys share a bucket in every round, so a key resolves as a whole
group in the first round its bucket is not contested. `leftover` says
that some active row is still unresolved after R rounds: the caller reads
it on the host and runs the sort-based group-by instead.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..columnar.column import Column, Decimal128Column, StringColumn
from .basic import active_mask
from .hashing import xxhash64_batch
from .strings import string_lengths

#: re-hash rounds before the exec escalates (then 6, then the sort path)
DEFAULT_ROUNDS = 2


def _keys_equal_rows(key_cols: Sequence[Column], idx: torch.Tensor):
    """GROUP BY equality of row i with row idx[i] (idx in range): nulls
    equal each other, values compare exactly (a string byte for byte
    against the span of row idx[i], with no byte gather)."""
    from ..columnar.encoded import _bytes_equal_spans
    eq = None
    i = idx.long()
    for col in key_cols:
        bv = col.validity[i]
        if isinstance(col, StringColumn):
            lengths, starts = string_lengths(col), col.offsets[:-1]
            val_eq = _bytes_equal_spans(lengths, starts, col.data,
                                        lengths[i], starts[i], col.data)
        elif isinstance(col, Decimal128Column):
            val_eq = (col.hi.data == col.hi.data[i]) \
                & (col.lo.data == col.lo.data[i])
        else:
            val_eq = col.data == col.data[i]
        this_eq = (~col.validity & ~bv) | (col.validity & bv & val_eq)
        eq = this_eq if eq is None else eq & this_eq
    return eq if eq is not None else torch.ones_like(idx, dtype=torch.bool)


def hash_group_assignment(key_cols: Sequence[Column], num_rows,
                          capacity: int, rounds: int = DEFAULT_ROUNDS):
    """Group slots without a sort.

    Returns (seg (capacity,) int32 in [0, rounds * capacity), or the
    sentinel rounds * capacity for unresolved and inactive rows; rep_row
    (rounds * capacity,) int32, the representative row of each slot, or
    capacity for an empty slot; leftover, a device bool)."""
    if capacity & (capacity - 1):
        raise ValueError(f"capacity {capacity} is not a power of two")
    cap = capacity
    dev = key_cols[0].device
    iota = torch.arange(cap, dtype=torch.int32, device=dev)
    remaining = active_mask(num_rows, cap, dev)
    seg = torch.full((cap,), rounds * cap, dtype=torch.int32, device=dev)
    rep_rows: List[torch.Tensor] = []
    for r in range(rounds):
        h = xxhash64_batch(list(key_cols), seed=0x9E3779B9 + r)
        bucket = (h & (cap - 1)).to(torch.int32)
        rep = torch.full((cap + 1,), cap, dtype=torch.int32, device=dev)
        rep.scatter_reduce_(0, torch.where(remaining, bucket, cap).long(),
                            iota, reduce="amin")
        rep = rep[:cap]
        my_rep = rep[bucket.long()]
        same = _keys_equal_rows(key_cols, torch.clamp(my_rep, 0, cap - 1))
        resolved = remaining & (my_rep < cap) & same
        seg = torch.where(resolved, r * cap + bucket, seg)
        # a slot's representative resolves into its own slot (it equals
        # itself), so rep < cap is exactly "slot occupied"
        rep_rows.append(rep)
        remaining = remaining & ~resolved
    return seg, torch.cat(rep_rows), torch.any(remaining)


def dense_group_ids(seg, rep_row, capacity: int, rounds: int):
    """Occupied slots -> dense group ids [0, num_groups) in slot order.

    Returns (dense_seg (capacity,) int32 with the sentinel capacity for
    unresolved rows, group_rep (capacity,) int32 source row per dense
    group, num_groups)."""
    n_slots = rounds * capacity
    occupied = rep_row < capacity
    pos = torch.cumsum(occupied, 0, dtype=torch.int32) - 1
    num_groups = torch.sum(occupied, dtype=torch.int32)
    slot_to_dense = torch.where(occupied, pos, capacity)
    safe = torch.clamp(seg, 0, n_slots - 1).long()
    dense_seg = torch.where(seg < n_slots, slot_to_dense[safe], capacity)
    group_rep = torch.full((capacity + 1,), capacity, dtype=torch.int32,
                           device=seg.device)
    group_rep[torch.where(occupied, pos, capacity).long()] = rep_row
    return dense_seg.to(torch.int32), group_rep[:capacity], num_groups
