"""Masked-bucket group-by — the counterpart of
spark_rapids_tpu/ops/maskedagg.py.

Grouping is built from masked reductions only, exactly as in the JAX
package:

  round r in [0, R):
    bucket b = mix_r(keys) mod G
    per key column: masked min/max of its order lane over each bucket
      -> a bucket is CLEAN iff every key column is constant across it
         (min == max, and not a null/value mix)
    clean buckets resolve all their rows to slot r*G + b; the key value is
      the min (== max) itself, decoded from the order lane
    dirty buckets retry with a different mix next round
  leftover = any row still unresolved after R rounds

The bucket layout (hash, salt, slot order) matches the JAX package bit
for bit, so both packages emit groups in the same dense order.

PyTorch lacks shifts and remainders on uint32 tensors, so the hash runs
on int64 tensors holding 32-bit values with explicit masks, and order
lanes use the signed encoding of ops/sort.py. With rounds=1 this module
is also the plain version the fused scan-aggregate kernel is held to
(ops/fused_scan_agg.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..columnar.column import Column, bucket_capacity
from ..types import DataType, DecimalType
from .basic import active_mask
from .sort import (
    INT64_MAX, _numeric_order_key, lane_bits, lane_neutral_max,
    lane_neutral_min,
)

_M32 = 0xFFFFFFFF


def _unorder_bits(lane: torch.Tensor, dtype: DataType) -> torch.Tensor:
    """Invert ops/sort._numeric_order_key: signed order lane -> value."""
    tdt = dtype.torch_dtype
    if tdt == torch.bool:
        return lane != 0
    if tdt == torch.float64:
        return torch.where(lane < 0, lane ^ INT64_MAX, lane).view(
            torch.float64)
    if tdt == torch.float32:
        was_neg = (lane & 0x80000000) == 0
        bits = torch.where(was_neg, ~lane & _M32, lane ^ 0x80000000)
        bits = torch.where(bits >= (1 << 31), bits - (1 << 32), bits)
        return bits.to(torch.int32).view(torch.float32)
    bits = lane_bits(tdt)
    if bits == 64:
        return lane
    return (lane - (1 << (bits - 1))).to(tdt)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for 32-bit values held in int64, without int64
    overflow: split c into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _mix32(h: torch.Tensor, salt: int) -> torch.Tensor:
    """Cheap murmur3-finalizer mixing on 32-bit values held in int64
    (internal bucketing only, not Spark's murmur3)."""
    h = h ^ (salt & _M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _bucket_hash(key_cols: Sequence[Column], salt: int,
                 capacity: int) -> torch.Tensor:
    """Per-row bucket hash, bit-identical to the JAX package's u32 hash;
    returns int64 values in [0, 2^32)."""
    dev = key_cols[0].device
    h = torch.full((capacity,), 0x9E3779B9, dtype=torch.int64, device=dev)
    for c in key_cols:
        lane = _numeric_order_key(c)
        if lane_bits(c.data.dtype) == 64:
            lo = lane & _M32
            hi = ((lane >> 32) & _M32) ^ 0x80000000
            h = _mix32(h ^ lo, salt)
            h = _mix32(h ^ hi, salt + 0x51)
        else:
            h = _mix32(h ^ lane, salt)
        h = _mix32(h ^ c.validity.to(torch.int64), salt + 0xA3)
    return h


def _per_bucket_count(b: torch.Tensor, G: int, mask: torch.Tensor):
    """(G,) int32 count of `mask` rows per bucket id in `b`. Rows outside
    the mask land in a spare slot G that is dropped."""
    idx = torch.where(mask, b, G)
    out = torch.zeros(G + 1, dtype=torch.int32, device=b.device)
    out.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return out[:G]


def _per_bucket_any(b: torch.Tensor, G: int, mask: torch.Tensor):
    return _per_bucket_count(b, G, mask) > 0


def _per_bucket(b: torch.Tensor, G: int, mask: torch.Tensor,
                values: torch.Tensor, reduce: str, neutral):
    """(G,) masked reduction of `values` per bucket id in `b`; a bucket
    without mask rows keeps `neutral` (sums: 0). Float min/max propagate
    NaN, as jnp.min/jnp.max do."""
    idx = torch.where(mask, b, G)
    out = torch.full((G + 1,), neutral, dtype=values.dtype,
                     device=values.device)
    if reduce == "sum":
        out.index_add_(0, idx, values)
        return out[:G]
    out.scatter_reduce_(0, idx, values, reduce="a" + reduce)
    out = out[:G]
    if values.is_floating_point():
        nan = _per_bucket_any(b, G, mask & torch.isnan(values))
        out = torch.where(nan, torch.full_like(out, float("nan")), out)
    return out


def key_bucket_stats(key_cols: Sequence[Column], lanes, b, G: int, rows):
    """Per key column: (min lane, max lane, any valid, any null) over each
    bucket's `rows`."""
    out = []
    for c, lane in zip(key_cols, lanes):
        bits = lane_bits(c.data.dtype)
        mv = rows & c.validity
        mn = _per_bucket(b, G, mv, lane, "min", lane_neutral_min(bits))
        mx = _per_bucket(b, G, mv, lane, "max", lane_neutral_max(bits))
        out.append((mn, mx, _per_bucket_any(b, G, mv),
                    _per_bucket_any(b, G, rows & ~c.validity)))
    return out


def clean_buckets(kstats):
    """(clean, occupied) per bucket from key_bucket_stats."""
    G = kstats[0][0].shape[0]
    dev = kstats[0][0].device
    clean = torch.ones(G, dtype=torch.bool, device=dev)
    occupied = torch.zeros(G, dtype=torch.bool, device=dev)
    for mn, mx, av, an in kstats:
        clean = clean & ~(av & an) & (~av | (mn == mx))
        occupied = occupied | av | an
    return clean, occupied


def masked_group_assignment(key_cols: Sequence[Column], num_rows,
                            capacity: int, row_mask=None,
                            group_slots: int = 32, rounds: int = 2):
    """Scatter-free exact group assignment.

    Returns (seg (capacity,) int64 in [0, R*G) or sentinel R*G;
    slot_occupied (R*G,) bool; per key column (R*G,) order lanes + any
    valid; leftover device bool)."""
    G, R = group_slots, rounds
    if G > 64:
        raise ValueError("at most 64 buckets per round")
    act = active_mask(num_rows, capacity, key_cols[0].device)
    if row_mask is not None:
        act = act & row_mask
    unresolved = act
    seg = torch.full((capacity,), R * G, dtype=torch.int64, device=act.device)
    lanes = [_numeric_order_key(c) for c in key_cols]
    slot_occ, slot_keys = [], []
    dirty = None
    for r in range(R):
        # later rounds run unconditionally: when no row is left their
        # buckets are all unoccupied and they change nothing (the JAX
        # package skips them with a device-side cond; the result is equal)
        h = _bucket_hash(key_cols, 0x2545F491 + r * 0x9E37, capacity)
        b = h % G
        kstats = key_bucket_stats(key_cols, lanes, b, G, unresolved)
        clean, occupied = clean_buckets(kstats)
        resolved_bucket = clean & occupied
        dirty = torch.any(occupied & ~clean)
        resolved = unresolved & resolved_bucket[b]
        seg = torch.where(resolved, r * G + b, seg)
        unresolved = unresolved & ~resolved
        slot_occ.append(resolved_bucket)
        slot_keys.append([(mn, av) for mn, _, av, _ in kstats])
    occ = torch.cat(slot_occ)
    key_slots = []
    for ci in range(len(key_cols)):
        key_slots.append((torch.cat([slot_keys[r][ci][0] for r in range(R)]),
                          torch.cat([slot_keys[r][ci][1] for r in range(R)])))
    return seg, occ, key_slots, dirty


def acc_dtype(op: str, dtype: torch.dtype) -> torch.dtype:
    """Accumulator dtype of a masked aggregate (the JAX package's
    `_acc_dtype`: i32 counts, i64/f64 sums, the input dtype for min/max
    with bool on an int8 lane, and for first/last)."""
    if op in ("count", "count_star"):
        return torch.int32
    if op in ("sum", "sum_sq"):
        return torch.float64 if dtype.is_floating_point else torch.int64
    return torch.int8 if dtype == torch.bool else dtype


def minmax_neutral(op: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _decimal_limbs(col: Column):
    """(hi, lo) int64 lanes of a decimal column (either tier)."""
    from ..columnar.column import Decimal128Column
    from . import decimal128 as D
    if isinstance(col, Decimal128Column):
        return col.hi.data, col.lo.data
    return D.from_i64(col.data.to(torch.int64))


def bucket_reduce(op: str, col: Optional[Column], b, S: int, rows):
    """One aggregate over S buckets of `rows`: ((S,) values, (S,) has-a-
    valid-row or None for the counts). A decimal sum's values are its
    (hi, lo) limb lanes: the exact 128-bit sum of eight u16-limb int64
    sums (ops/decimal128.py), saturated past signed 128 bits."""
    if op == "count_star":
        return _per_bucket_count(b, S, rows), None
    v = rows & col.validity
    if op == "count":
        return _per_bucket_count(b, S, v), None
    if op == "sum" and isinstance(col.dtype, DecimalType):
        from .decimal128 import decimal_segment_sum
        return decimal_segment_sum(col, v, b, S)
    has = _per_bucket_any(b, S, v)
    data = col.data
    adt = acc_dtype(op, data.dtype)
    if op in ("sum", "sum_sq"):
        acc = data.to(adt)
        if op == "sum_sq":
            acc = acc * acc
        return _per_bucket(b, S, v, acc, "sum", 0), has
    if op in ("min", "max"):
        data = data.to(adt)
        return _per_bucket(b, S, v, data, op, minmax_neutral(op, adt)), has
    if op in FIRST_LAST_OPS:
        return pick_first_last(op, col, b, S, rows, v)
    raise ValueError(f"unsupported masked aggregate {op!r}")


#: first/last skip nulls (ignoreNulls=True); the _any forms take the
#: first/last active row whatever its value (Spark's default)
FIRST_LAST_OPS = ("first", "last", "first_any", "last_any")


def pick_position(op: str, b, S: int, rows, valid) -> torch.Tensor:
    """(S,) row position of each bucket's first (last) row: among its
    valid rows for first/last, among its active `rows` for the _any
    forms; capacity (-1 for last) when there is none. The JAX package's
    position semantics: rows count in batch order.

    A stable sort of the bucket ids keeps each bucket's rows in position
    order, so its first (last) row sits where a binary search for the
    bucket id starts (ends): no atomics, where a scatter-min into a few
    buckets serialises on them (PERF.md §5k, P24)."""
    cap = b.shape[0]
    mask = rows if op.endswith("_any") else valid
    last = op.startswith("last")
    if cap == 0:
        return torch.full((S,), -1 if last else 0, dtype=torch.int64,
                          device=b.device)
    key = torch.where(mask, b.long(), S)
    ids, order = torch.sort(key, stable=True)
    q = torch.arange(S, dtype=torch.int64, device=b.device)
    lo = torch.searchsorted(ids, q)
    hi = torch.searchsorted(ids, q, right=True)
    if last:
        return torch.where(hi > lo, order[torch.clamp(hi - 1, min=0)], -1)
    return torch.where(hi > lo, order[torch.clamp(lo, max=cap - 1)], cap)


def pick_first_last(op: str, col: Column, b, S: int, rows, valid):
    """((S,) values, (S,) validity) of first/last per bucket: the value
    at the picked position; an _any pick is null where that row is."""
    cap = b.shape[0]
    pick = pick_position(op, b, S, rows, valid)
    ok = (pick >= 0) & (pick < cap)
    safe = torch.clamp(pick, 0, cap - 1)
    if op.endswith("_any"):
        ok = ok & col.validity[safe]
    return col.data[safe], ok


def masked_groupby(key_columns: Sequence[Column],
                   agg_inputs: Sequence[Tuple[str, Optional[Column]]],
                   num_rows, capacity: int, row_mask=None,
                   group_slots: int = 32, rounds: int = 2):
    """Group-by into a SMALL output bucket (capacity bucket_capacity(R*G)).

    Returns (out_keys, tagged results, num_groups, leftover). When
    `leftover` is True the output is INCOMPLETE (rows of dirty buckets are
    dropped): the caller runs under a speculation scope and must not
    return the result."""
    seg, occ, key_slots, leftover = masked_group_assignment(
        key_columns, num_rows, capacity, row_mask, group_slots, rounds)
    out_keys, results, num_groups = _place_slots(
        key_columns, agg_inputs, seg, occ, key_slots,
        bucket_capacity(group_slots * rounds))
    return out_keys, results, num_groups, leftover


def _place_slots(key_columns, agg_inputs, seg, occ, key_slots,
                 out_cap: int):
    """Reduce each aggregate over the resolved slots and place the
    occupied slots densely in an `out_cap` bucket."""
    n_slots = occ.shape[0]
    act = seg < n_slots
    dense = torch.cumsum(occ.to(torch.int32), 0) - 1
    num_groups = torch.sum(occ, dtype=torch.int32)
    target = torch.where(occ, dense, torch.full_like(dense, out_cap))

    results = []
    for op, col in agg_inputs:
        vals, has = bucket_reduce(op, col, seg, n_slots, act)
        if has is None:
            vals = vals.to(torch.int64)
            has = torch.ones(n_slots, dtype=torch.bool, device=occ.device)
        results.append(("raw", place_dense(vals, has, occ, target, out_cap)))

    out_keys = []
    for (bits, valid), c in zip(key_slots, key_columns):
        d, v = place_dense(_unorder_bits(bits, c.dtype), valid, occ, target,
                           out_cap)
        out_keys.append(Column(torch.where(v, d, torch.zeros_like(d)), v,
                               c.dtype))
    return out_keys, results, num_groups


def masked_groupby_exact(key_columns: Sequence[Column],
                         agg_inputs: Sequence[Tuple[str, Optional[Column]]],
                         num_rows, capacity: int, row_mask=None,
                         group_slots: int = 32, rounds: int = 2):
    """Exact full-capacity group-by: the masked-bucket assignment, then
    either its dense placement or, when rows are left over, the exact
    sort-based group-by (ops/aggregate.groupby_aggregate). Output
    capacity == input capacity on both branches.

    The JAX package chooses the branch inside the program (lax.cond) and
    never synchronises; eager PyTorch has no in-graph branch, so this
    reads `leftover` on the host once per call."""
    from .aggregate import groupby_aggregate
    from .basic import compact_columns
    seg, occ, key_slots, leftover = masked_group_assignment(
        key_columns, num_rows, capacity, row_mask, group_slots, rounds)
    if not bool(leftover):
        return _place_slots(key_columns, agg_inputs, seg, occ, key_slots,
                            capacity)
    keys, aggs, n = list(key_columns), list(agg_inputs), num_rows
    if row_mask is not None:
        # the sort-based path needs the kept rows packed at the front
        inputs = [c for _, c in agg_inputs if c is not None]
        packed, n = compact_columns(keys + inputs, row_mask, num_rows)
        keys, rest = list(packed[: len(keys)]), iter(packed[len(keys):])
        aggs = [(op, next(rest) if c is not None else None)
                for op, c in agg_inputs]
    return groupby_aggregate(keys, aggs, n, capacity)


def place_dense(vals, valids, occ, target, out_cap: int):
    """Slot arrays -> dense-prefix (out_cap,) arrays; slots that are not
    occupied are dropped (their target is out_cap)."""
    d = torch.zeros(out_cap + 1, dtype=vals.dtype, device=vals.device)
    v = torch.zeros(out_cap + 1, dtype=torch.bool, device=vals.device)
    t = target.long()
    d[t] = vals
    v[t] = valids & occ
    return d[:out_cap], v[:out_cap]


def masked_reduce(agg_inputs: Sequence[Tuple[str, Optional[Column]]],
                  num_rows, row_mask=None, out_capacity: int = 128):
    """Grand aggregate (no GROUP BY): one masked full-array reduction per
    aggregate, one active output row at out_capacity."""
    out = []
    for op, col in agg_inputs:
        if col is None and row_mask is None:
            # count(*) with no filter mask: the row count is the answer
            val = num_rows.to(torch.int64).reshape(1)
            ok = torch.ones(1, dtype=torch.bool, device=val.device)
        else:
            cap = col.capacity if col is not None else row_mask.shape[0]
            act = active_mask(num_rows, cap)
            if row_mask is not None:
                act = act & row_mask
            zeros = torch.zeros(cap, dtype=torch.int64, device=act.device)
            val, ok = bucket_reduce(op, col, zeros, 1, act)
            if ok is None:
                val = val.to(torch.int64)
                ok = torch.ones(1, dtype=torch.bool, device=val.device)
        valid = torch.zeros(out_capacity, dtype=torch.bool, device=ok.device)
        valid[:1] = ok
        out.append((_first_row(val, out_capacity), valid))
    return out


def pick_string_row(op: str, col, num_rows, row_mask=None,
                    out_capacity: int = 128):
    """A grand first/last over a string column: the picked row as a
    one-row StringColumn at out_capacity (the JAX package's masked
    reduction returns the row's first byte here, ROADMAP C.5)."""
    from .basic import gather_column
    cap = col.capacity
    act = active_mask(num_rows, cap, col.device)
    if row_mask is not None:
        act = act & row_mask
    pick = pick_position(op, torch.zeros(cap, dtype=torch.int64,
                                         device=col.device), 1, act,
                         col.validity & act)
    idx = torch.full((out_capacity,), -1, dtype=torch.int64,
                     device=col.device)
    idx[:1] = torch.where((pick >= 0) & (pick < cap), pick, -1)
    return gather_column(col, idx.to(torch.int32))


def _first_row(val, out_capacity: int):
    """A (1,) result (or a (hi, lo) pair of them) at the head of an
    out_capacity lane."""
    if isinstance(val, tuple):
        return tuple(_first_row(v, out_capacity) for v in val)
    data = torch.zeros(out_capacity, dtype=val.dtype, device=val.device)
    data[:1] = val
    return data
