"""Hash partitioning and the mesh all-to-all exchange — the counterpart of
spark_rapids_tpu/parallel/exchange.py (the reference's UCX shuffle,
GpuShuffleExchangeExecBase.scala:277 device split plus the shuffle
plugin's transport).

`partition_ids` is Spark's HashPartitioning pid, pmod(murmur3(keys, 42),
n): fixed-width keys hash in one launch of the murmur3 chain kernel on the
card (ops/hashing.murmur3_batch), string keys in plain torch over their
byte spans. The pid is the JAX package's bit for bit, so a key lands in
the same partition on both sides of a shuffled join.

The mesh lane, driven by one process over a parallel/mesh.Mesh:

  * `partition_slots` maps each shard's active rows into an
    (n_parts, slot_cap) send grid: a stable sort by pid, the position in
    the pid's group, and a scatter of the kept slots (rows past slot_cap
    fall into a sentinel slot that is cut off, the JAX package's
    `.at[slot].set(mode="drop")`). No host read.
  * `all_to_all(per_shard, mesh)` is `jax.lax.all_to_all(x, axis, 0, 0,
    tiled=False)`: on shard d, row s of the output is shard s's block d,
    copied onto shard d's device (a peer copy between cards, a copy inside
    one card's memory when shards share it). Its bytes and host ns are
    counted (`counters()`).
  * `exchange_columns` gathers each shard's columns into its grid (one
    packed row gather, ops/gather), all-to-alls every lane — a
    fixed-width column's data and validity, a string column as (lengths,
    bytes padded to `string_width`, validity) through
    ops/strings.string_to_padded / string_from_padded (a longer string is
    cut, as in the JAX package), a struct's or decimal128's children
    recursively with its own validity as one more lane — then the
    occupancy lane, and compacts each shard's received slots in source
    order (ops/basic.compaction_order). The received rows, their order
    and `n_recv` are the JAX package's.

`negotiate_slot_cap` sizes the grid from the measured largest partition
(floored by a running hint, so later rounds keep one shape) instead of the
whole local capacity.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..columnar.column import (Column, Decimal128Column, StringColumn,
                               StructColumn, bucket_capacity)
from ..ops.basic import active_mask, compaction_order
from ..ops.hashing import murmur3_batch, pmod

__all__ = ["SHUFFLE_SEED", "partition_ids", "negotiate_slot_cap",
           "partition_slots", "all_to_all", "exchange_columns", "counters",
           "string_columns"]

#: seed of shuffle partitioning (Spark's HashPartitioning uses 42)
SHUFFLE_SEED = 42

_LOCK = threading.Lock()
#: process-cumulative all-to-all counters: calls (one a lane), the bytes
#: copied to the destination shards, and the host ns spent enqueueing them
_COUNTERS = {"calls": 0, "bytes": 0, "ns": 0}


def counters() -> Dict[str, int]:
    with _LOCK:
        return dict(_COUNTERS)


def string_columns(cols: Sequence[Column]):
    """The string columns among `cols`, a struct's children included:
    every column the padded string lane carries at one `string_width`,
    so every one a width measure must cover."""
    for c in cols:
        if isinstance(c, StringColumn):
            yield c
        elif isinstance(c, StructColumn):
            yield from string_columns(c.children)


def partition_ids(key_cols: Sequence[Column], num_rows, capacity: int,
                  n_parts: int) -> torch.Tensor:
    """Spark HashPartitioning: pmod(murmur3(keys, 42), n) as int32.
    Inactive rows get n_parts, so they land in no partition."""
    h = murmur3_batch(list(key_cols), seed=SHUFFLE_SEED)
    pid = pmod(h, n_parts)
    act = active_mask(num_rows, capacity, pid.device)
    return torch.where(act, pid, n_parts).to(torch.int32)


def negotiate_slot_cap(measured_max: int, capacity: int,
                       hint: int = 0) -> int:
    """The send grid's slots per partition: the measured largest partition
    (floored by `hint`, the running high-water mark of earlier rounds, so
    a smaller later round keeps the grid's shape), rounded up to its
    capacity bucket and clamped to the local capacity, the true worst
    case."""
    return min(bucket_capacity(max(int(measured_max), int(hint), 1)),
               capacity)


def partition_slots(pid: torch.Tensor, num_rows, capacity: int,
                    n_parts: int, slot_cap: int) -> torch.Tensor:
    """Each active row's slot in the (n_parts, slot_cap) send grid: int32
    (n_parts * slot_cap,), the source row of each slot, -1 for an empty
    slot. Rows past slot_cap in their partition are dropped: size slot_cap
    to the worst case (default: capacity)."""
    dev = pid.device
    iota = torch.arange(capacity, dtype=torch.int32, device=dev)
    # a stable sort by pid: each partition's rows in source order
    sorted_pid, perm = torch.sort(pid.to(torch.int32), stable=True)
    # the first index of each pid in sorted order (the JAX package's
    # segment_min of the iota)
    first_of = torch.searchsorted(
        sorted_pid, torch.arange(n_parts + 1, dtype=torch.int32, device=dev)
    ).to(torch.int32)
    pos = iota - first_of[torch.clamp(sorted_pid, 0, n_parts).long()]
    ok = (sorted_pid < n_parts) & (pos < slot_cap)
    grid = n_parts * slot_cap
    # dropped rows write the sentinel slot `grid`, cut off below
    slot = torch.where(ok, sorted_pid * slot_cap + pos, grid)
    send_idx = torch.full((grid + 1,), -1, dtype=torch.int32, device=dev)
    send_idx.scatter_(0, slot.long(), perm.to(torch.int32))
    return send_idx[:grid]


def all_to_all(per_shard: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """jax.lax.all_to_all(x, axis, 0, 0, tiled=False) over the mesh's
    shards: per_shard[s] is shard s's (n, ...) tensor on its device; the
    result's entry d is (n, ...) on shard d's device, its row s shard s's
    block d."""
    devs = mesh.shard_devices
    n = len(devs)
    if len(per_shard) != n:
        raise ValueError(f"{len(per_shard)} shards for a mesh of {n}")
    t0 = time.perf_counter_ns()
    out, moved = [], 0
    for d in range(n):
        blocks = [per_shard[s][d].to(devs[d], non_blocking=True)
                  for s in range(n)]
        r = torch.stack(blocks)
        moved += r.numel() * r.element_size()
        out.append(r)
    ns = time.perf_counter_ns() - t0
    with _LOCK:
        _COUNTERS["calls"] += 1
        _COUNTERS["bytes"] += moved
        _COUNTERS["ns"] += ns
    return out


def _exchange_lanes(cols: Sequence[Column], mesh, n: int, slot_cap: int,
                    width: int) -> List[Column]:
    """One column of every shard (its send grid gathered, capacity
    n * slot_cap) through the all-to-all: the received column of each
    shard, capacity n * slot_cap in source-shard order."""
    from ..ops.strings import string_from_padded, string_to_padded
    recv_cap = n * slot_cap
    c0 = cols[0]

    def xch(lanes, tail=()):
        got = all_to_all([x.reshape((n, slot_cap) + tuple(tail))
                          for x in lanes], mesh)
        return [g.reshape((recv_cap,) + tuple(tail)) for g in got]

    r_val = xch([c.validity for c in cols])
    if isinstance(c0, StringColumn):
        enc = [string_to_padded(c, width) for c in cols]
        r_len = xch([e[0] for e in enc])
        r_pad = xch([e[1] for e in enc], (width,))
        return [string_from_padded(l, p, v, c0.dtype)
                for l, p, v in zip(r_len, r_pad, r_val)]
    if isinstance(c0, (StructColumn, Decimal128Column)):
        # the children recursively, the column's own validity one lane
        kids = [_exchange_lanes([c.children[i] for c in cols], mesh, n,
                                slot_cap, width)
                for i in range(len(c0.children))]
        return [type(c0)([k[d] for k in kids], r_val[d], c0.dtype)
                for d in range(n)]
    if type(c0) is not Column:
        raise TypeError(f"{type(c0).__name__} has no slot-grid lane: the "
                        f"mesh exchange carries fixed-width, string, "
                        f"struct and decimal128 columns")
    r_data = xch([c.data for c in cols])
    return [Column(x, v, c0.dtype) for x, v in zip(r_data, r_val)]


def exchange_columns(shards: Sequence[Sequence[Column]],
                     key_ordinals: Sequence[int], num_rows: Sequence,
                     capacity, mesh, n_parts: int,
                     slot_cap: Optional[int] = None, string_width: int = 64,
                     pids: Optional[Sequence[torch.Tensor]] = None
                     ) -> Tuple[List[List[Column]], List[torch.Tensor]]:
    """Hash-partition every shard's rows and all-to-all them so partition
    p's rows land on shard p. `shards[d]` is shard d's columns (on its
    device, at `capacity`: one for every shard, or one a shard: unlike
    the JAX package's stacked program, the shards need not share one),
    `num_rows[d]` its row count. Partitioning comes from `pids` when given
    (one per shard), else from hashing the columns at `key_ordinals`.
    Returns (each shard's received columns at capacity n_parts *
    slot_cap, slot_cap defaulting to the largest capacity, rows compacted
    to the front in source order; each shard's received row count, a
    device int32)."""
    from ..columnar.encoded import materialize_column
    from ..ops.gather import gather_batch_columns
    n = len(shards)
    if n != n_parts:
        raise ValueError(f"{n} shards exchange into {n} partitions, not "
                         f"{n_parts}")
    caps = [capacity] * n if isinstance(capacity, int) else list(capacity)
    slot_cap = slot_cap or max(caps)
    shards = [[materialize_column(c) for c in cols] for cols in shards]
    sends, gathered = [], []
    for d, cols in enumerate(shards):
        pid = pids[d] if pids is not None else partition_ids(
            [cols[i] for i in key_ordinals], num_rows[d], caps[d], n_parts)
        send = partition_slots(pid, num_rows[d], caps[d], n_parts, slot_cap)
        sends.append(send)
        gathered.append(gather_batch_columns(cols, send))
    recv = [_exchange_lanes([g[j] for g in gathered], mesh, n, slot_cap,
                            string_width)
            for j in range(len(shards[0]))]
    # occupancy: a slot is occupied when its sender had a row there (a
    # null row's validity is False, so it is tracked apart)
    occ = all_to_all([(s >= 0).reshape(n, slot_cap) for s in sends], mesh)
    recv_cap = n * slot_cap
    out_cols, out_rows = [], []
    for d in range(n):
        perm, n_recv = compaction_order(occ[d].reshape(recv_cap), recv_cap)
        act = active_mask(n_recv, recv_cap, perm.device)
        out_cols.append(gather_batch_columns(
            [r[d] for r in recv], torch.where(act, perm, -1)))
        out_rows.append(n_recv)
    return out_cols, out_rows
