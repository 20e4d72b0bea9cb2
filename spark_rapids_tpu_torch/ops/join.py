"""Equi-join gather-map ops — the counterpart of spark_rapids_tpu/ops/join.py
for fixed-width, string, dictionary, decimal128 and struct keys.

No device hash table with collision chains: the build side sorts by a
pair of u32 murmur3 hashes, a top-B-bits bucket offsets table gives each
stream row its candidate range, candidates expand into (stream, build)
index pairs, and an exact key verify drops hash collisions (a collision
costs a false candidate, never a wrong row). Equi-keys never match null
keys.

Hash lanes are int32 tensors holding u32 bits (ops/hashing.py); wherever
their unsigned value matters (the bucket shift, the sort) they widen to
int64 with `u32_of`.

Integer-like keys hash through the murmur3 kernel's chain
(ops/murmur3_lanes.murmur3_columns) and verify in the probe kernel
(ops/probe_verify.py) against the build side's u32 key lanes. A key list
with a string or dictionary column hashes through ops/hashing's
murmur3_batch, a dictionary by its entries once (`dictionary_hashes`, then
a `dict_take` by code), so that a string and its encoded form land in the
same bucket; it expands its candidates (`expand_candidates`) and verifies
them here (`verify_pairs`), a varlen key byte for byte through spans into
both sides' own buffers (columnar/encoded.bytes_equal_at): the two sides'
dictionaries differ, and code equality means nothing across them. A
decimal128 or struct key hashes by its leaves (ops/hashing.hash_leaves,
the JAX package's struct hash) and verifies by `keys_equal_at`: both
limbs, or every field as Spark compares a key row.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..columnar.column import (ArrayColumn, Column, Decimal128Column,
                               StringColumn, StructColumn)
from ..columnar.encoded import DictionaryColumn, bytes_equal_at
from .basic import active_mask, compaction_order, gather_column
from .hashing import _is_varlen, hash_leaves, murmur3_batch, u32_of
from .murmur3_lanes import murmur3_columns
from .rowpack import pack_rows
from .sort import lexsort

JOIN_HASH_SEED = 0x5370_6172  # arbitrary fixed seed, 'Spar'
JOIN_HASH_SEED2 = 0x85EB_CA6B


def join_hash_pair(key_cols: Sequence[Column], lo_too: bool = True):
    """Internal join bucket hash: murmur3 chains of the keys from two
    independent seeds (u32 bits), the second only when `lo_too`. A
    decimal128 or struct key folds its leaves (ops/hashing.hash_leaves),
    as the JAX package's struct hash does. Fixed-width leaves hash both
    seeds from one read of the keys, one launch on a card; a key list
    with a string or dictionary leaf hashes each seed through
    murmur3_batch."""
    seeds = (JOIN_HASH_SEED, JOIN_HASH_SEED2) if lo_too else (JOIN_HASH_SEED,)
    leaves = hash_leaves(key_cols)
    if any(_is_varlen(c) for c in leaves):
        h = [murmur3_batch(leaves, seed) for seed in seeds]
    else:
        h = murmur3_columns(leaves, seeds)
    return h[0], (h[1] if lo_too else None)


def _keys_valid(key_cols: Sequence[Column], num_rows, capacity: int):
    v = active_mask(num_rows, capacity, key_cols[0].device)
    for c in key_cols:
        v = v & c.validity
    return v


def _bucket_bits(capacity: int) -> int:
    """Static bucket-count exponent: ~2 slots per build row, capped so
    the offsets table stays small."""
    return min(21, max(10, (capacity - 1).bit_length() + 1))


def int_key_lanes(key_cols: Sequence[Column]
                  ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Key columns as an int32 (capacity, L) matrix of u32 equality lanes
    plus a combined bool validity, or None when any key is not
    integer-like (float `==` and varlen compares are not bit equality).
    Up-to-32-bit types widen to one i32 lane (injective); 64-bit types
    split into (lo, hi) lanes. A single key needs no copy: an INT column
    is its own (cap, 1) matrix and a LONG column its own (cap, 2) view."""
    lanes = []
    valid = None
    for c in key_cols:
        if type(c) is not Column:
            return None
        d = c.data
        if d.dtype.is_floating_point:
            return None
        if d.dtype.itemsize == 8:
            lanes.append(d.contiguous().view(torch.int32).view(-1, 2))
        else:
            lanes.append(d.to(torch.int32).view(-1, 1))
        valid = c.validity if valid is None else (valid & c.validity)
    if valid is None:
        return None
    mat = lanes[0] if len(lanes) == 1 else torch.cat(lanes, dim=1)
    return mat, valid


def candidate_fill_inputs(lo, counts, out_capacity: int):
    """The candidate-expansion inputs of the cummax formulation: `seg`,
    each nonempty range's start slot carrying its owner row (disjoint by
    construction), and the (lo, start) 2-lane matrix."""
    n_rows = counts.shape[0]
    cum32 = torch.cumsum(counts, 0, dtype=torch.int32)   # inclusive
    start = cum32 - counts                                # exclusive
    pos = torch.where(counts > 0, torch.clamp(start, max=out_capacity),
                      out_capacity).long()
    j = torch.arange(n_rows, dtype=torch.int32, device=counts.device)
    seg = torch.zeros(out_capacity + 1, dtype=torch.int32,
                      device=counts.device)
    seg.scatter_reduce_(0, pos, j, reduce="amax")
    return seg[:out_capacity], torch.stack([lo, start], dim=1)


def is_varsize(c: Column) -> bool:
    """A column whose rows vary in size: strings (bytes), lists
    (elements) and structs with such a field, whose gathers need an
    output bucket measured for them."""
    if isinstance(c, StructColumn):
        return any(is_varsize(k) for k in c.children)
    return isinstance(c, (StringColumn, ArrayColumn))


def var_lengths(c: Column) -> torch.Tensor:
    """Per-row payload size of a variable-size column: bytes for a
    string, elements for a list; for a struct, the sum over its varying
    fields (one bucket that holds each field's need, passed to each)."""
    if isinstance(c, StructColumn):
        lens = [var_lengths(k) for k in c.children if is_varsize(k)]
        total = lens[0]
        for x in lens[1:]:
            total = total + x
        return total
    if isinstance(c, ArrayColumn):
        from .collection import array_lengths
        return array_lengths(c)
    from .strings import string_lengths
    return string_lengths(c)


class BuildTable:
    """Hash-bucketed build side: rows sorted by the u32 hash pair, a
    top-B-bits bucket offsets table, the payload packed in sorted order,
    and, for integer-like keys, their u32 equality lanes in sorted order
    for the probe kernel. (The JAX package also packs fixed-width keys in
    sorted order for its XLA verify route; the port's verify route, which
    the other keys take, compares the key columns by row.)"""

    #: what a stage site's graph keeps of a table (obs/dispatch.flatten)
    _site_fields = ("bucket_table", "perm", "valid_count", "num_rows",
                    "key_cols", "payload", "capacity", "pair_table", "pack",
                    "key_lanes", "payload_prefix")

    def __init__(self, bucket_table, perm, valid_count, num_rows,
                 key_cols: Sequence[Column], payload: Sequence[Column],
                 capacity: int, pair_table, pack, key_lanes,
                 payload_prefix=()):
        self.bucket_table = bucket_table  # (2^B + 1,) int32 offsets
        self.perm = perm                  # sorted position -> build row
        self.valid_count = valid_count
        self.num_rows = num_rows
        self.key_cols = list(key_cols)
        self.payload = list(payload)
        self.capacity = capacity
        self.pair_table = pair_table      # (2^B, 2) int32 [lo, hi)
        # (plan, u32 matrix, f64 matrix, pack members per payload column
        # (ops/gather.pack_members), other idx): the packable payload
        # columns (a decimal128 column as its two limbs) packed in sorted
        # order, gathered once per output batch; the others (string and
        # dictionary columns) are gathered by original build row
        self.pack = pack
        # (int32 (capacity, L) lanes, bool validity) in sorted order, or
        # None for keys that are not integer-like
        self.key_lanes = key_lanes
        # per string payload column: int64 (capacity + 1,) prefix sums of
        # its row byte lengths in sorted order (the join's byte needs)
        self.payload_prefix = tuple(payload_prefix)

    @staticmethod
    def build(key_cols: Sequence[Column], payload: Sequence[Column],
              num_rows, capacity: int) -> "BuildTable":
        from .gather import gather_rows, needs_rest, pack_members
        for c in key_cols:
            if not is_key_column(c):
                raise TypeError(f"the join hashes and compares no key of "
                                f"{c.dtype}, as the JAX package's does "
                                f"not")
        valid = _keys_valid(key_cols, num_rows, capacity)
        # invalid/inactive rows sort last (max hash, then the invalid
        # flag) and stay out of every range via the valid-count boundary
        h_hi, h_lo = join_hash_pair(key_cols)
        big = 0xFFFF_FFFF
        k_hi = torch.where(valid, u32_of(h_hi), big)
        k_lo = torch.where(valid, u32_of(h_lo), big)
        # (k_hi, k_lo) as one signed order lane of the u64 pair:
        # (hi * 2^32 + lo) - 2^63, computed without overflow
        word = (k_hi - 0x80000000) * (1 << 32) + k_lo
        perm = lexsort([(word, 64), ((~valid).to(torch.int64), 1)])
        sorted_hi = k_hi[perm]
        perm = perm.to(torch.int32)
        valid_count = torch.sum(valid, dtype=torch.int32)
        B = _bucket_bits(capacity)
        n_buckets = 1 << B
        iota = torch.arange(capacity, dtype=torch.int32, device=perm.device)
        seg = torch.where(iota < valid_count, sorted_hi >> (32 - B),
                          n_buckets)
        counts = torch.zeros(n_buckets + 1, dtype=torch.int32,
                             device=perm.device)
        counts.index_add_(0, seg, torch.ones_like(iota))
        bucket_table = torch.cat([
            torch.zeros(1, dtype=torch.int32, device=perm.device),
            torch.cumsum(counts[:n_buckets], 0, dtype=torch.int32)])
        pair_table = torch.stack([bucket_table[:-1], bucket_table[1:]],
                                 dim=1)
        members, where = pack_members(payload)
        # gathered by original build row: the unpacked columns and the
        # structs with an unpacked field
        poi = [i for i, w in enumerate(where)
               if w is None or needs_rest(w)]
        for i in (i for i in poi if where[i] is None):
            if not is_gatherable(payload[i]):
                raise NotImplementedError(
                    f"join payload columns of {type(payload[i]).__name__} "
                    f"are not gathered by the join (ROADMAP A.3)")
        plan_p, pmat, pfmat = pack_rows(members)
        pmat_s, pfmat_s = gather_rows(plan_p, pmat, pfmat, perm) \
            if members else (pmat, pfmat)
        pack = (plan_p, pmat_s, pfmat_s, tuple(where), tuple(poi))
        key_lanes = None
        kl = int_key_lanes(key_cols)
        if kl is not None:
            lanes, kvalid = kl
            p = perm.long()
            key_lanes = (lanes[p], kvalid[p])
        p = perm.long()
        prefix = [torch.cat([torch.zeros(1, dtype=torch.int64,
                                         device=perm.device),
                             torch.cumsum(var_lengths(c)[p], 0,
                                          dtype=torch.int64)])
                  for c in payload if is_varsize(c)]
        return BuildTable(bucket_table, perm, valid_count, num_rows,
                          key_cols, payload, capacity, pair_table, pack,
                          key_lanes, prefix)


def is_key_column(col: Column) -> bool:
    """A column the join hashes and verifies: fixed-width, a string or
    dictionary column, a decimal128 column, or a struct of such fields."""
    if isinstance(col, StructColumn):
        return all(is_key_column(k) for k in col.children)
    return type(col) is Column or isinstance(
        col, (DictionaryColumn, StringColumn, Decimal128Column))


def is_gatherable(col: Column) -> bool:
    """A column ops/basic.gather_column moves: fixed-width, a dictionary
    column (its codes), a string column or a list column."""
    return type(col) is Column or isinstance(col, (DictionaryColumn,
                                                   StringColumn,
                                                   ArrayColumn))


def probe_counts(build: BuildTable, stream_keys: Sequence[Column],
                 stream_rows, stream_cap: int):
    """Per-stream-row candidate range: (lo, counts, key validity). One
    gather of the bucket's [lo, hi) pair; bucket-mates with other keys
    are dropped by the key verify downstream."""
    valid = _keys_valid(stream_keys, stream_rows, stream_cap)
    h_hi, _ = join_hash_pair(stream_keys, lo_too=False)
    b = u32_of(h_hi) >> (32 - _bucket_bits(build.capacity))
    pair = build.pair_table[b]
    hi = torch.minimum(pair[:, 1], build.valid_count)
    lo = torch.minimum(pair[:, 0], hi)
    counts = torch.where(valid, hi - lo, 0)
    return lo, counts, valid


def expand_candidates(lo, counts, out_capacity: int):
    """Flatten candidate ranges into (stream_idx, build_pos) pairs, and the
    int64 total. Pair i belongs to the stream row whose cumulative count
    interval contains i: range starts scatter their owner row, a cummax
    forward-fills it, one 2-lane gather turns flat positions into build
    positions. Slots >= total have stream_idx -1."""
    if out_capacity >= (1 << 31):
        raise NotImplementedError(
            "candidate buckets of 2^31 or more: the join probes a larger "
            "candidate space in windows (exec/joins.WINDOW_SLOTS, "
            "ROADMAP A.3)")
    dev = counts.device
    total = torch.sum(counts, dtype=torch.int64)
    i = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    if counts.shape[0] == 0:
        return torch.full_like(i, -1), torch.zeros_like(i), total
    seg, ls = candidate_fill_inputs(lo, counts, out_capacity)
    row_f = torch.cummax(seg, 0).values
    g = ls[row_f.long()]
    stream_idx = torch.where(i.to(torch.int64) < total, row_f, -1)
    build_pos = g[:, 0] + (i - g[:, 1])
    return stream_idx, build_pos, total


def verify_pairs(build: BuildTable, stream_keys: Sequence[Column],
                 stream_idx, build_pos, pair_valid):
    """Exact key equality per candidate pair (nulls never match): a string
    or dictionary key byte for byte through spans into each side's own
    buffer, any mix of the two; a fixed-width key by value. Returns (ok,
    build_row)."""
    build_row = gather_column_indices(build.perm, build_pos)
    ok = pair_valid
    for bk, sk in zip(build.key_cols, stream_keys):
        ok = ok & keys_equal_at(bk, build_row, sk, stream_idx)
    return ok, build_row


def keys_equal_at(a: Column, a_idx, b: Column, b_idx,
                  null_equal: bool = False) -> torch.Tensor:
    """Per index pair: whether key a[a_idx] equals key b[b_idx]. A string
    or dictionary key compares byte for byte (spans into each side's
    buffers), a decimal128 key both limbs, a struct key every field as
    Spark's hash join compares the key row, and any other key by value
    (NaN never equal, -0.0 equal to 0.0). At the top (`null_equal`
    False) a null key, a null struct among them, matches nothing; inside
    a struct a null field equals a null field and nothing else.
    Indices out of range read as null."""
    kinds = [(_is_varlen(c), isinstance(c, StructColumn),
              isinstance(c, Decimal128Column)) for c in (a, b)]
    if kinds[0] != kinds[1]:
        raise TypeError(f"join keys {a!r} and {b!r} do not compare")
    va, vb = _valid_at(a, a_idx), _valid_at(b, b_idx)
    if _is_varlen(a):
        eq = bytes_equal_at(a, a_idx, b, b_idx)
    elif isinstance(a, StructColumn):
        if len(a.children) != len(b.children):
            raise TypeError(f"struct keys {a.dtype} and {b.dtype} do not "
                            f"compare")
        eq = va & vb
        for fa, fb in zip(a.children, b.children):
            eq = eq & keys_equal_at(fa, a_idx, fb, b_idx, null_equal=True)
    else:
        pairs = zip(a.children, b.children) \
            if isinstance(a, Decimal128Column) else ((a, b),)
        eq = va & vb
        for la, lb in pairs:
            eq = eq & (gather_column(la, a_idx).data
                       == gather_column(lb, b_idx).data)
    return eq | (~va & ~vb) if null_equal else eq


def _valid_at(col: Column, idx) -> torch.Tensor:
    in_range = (idx >= 0) & (idx < col.capacity)
    return col.validity[torch.where(in_range, idx, 0).long()] & in_range


def gather_column_indices(arr, idx):
    in_range = (idx >= 0) & (idx < arr.shape[0])
    safe = torch.where(in_range, idx, torch.zeros_like(idx)).long()
    return torch.where(in_range, arr[safe], -1)


def inner_gather_maps(verified, stream_idx, build_row, total):
    """Compact verified pairs to the front: (stream_map, build_map, rows)."""
    cap = verified.shape[0]
    perm, n = compaction_order(verified, total)
    act = active_mask(n, cap)
    p = perm.long()
    return (torch.where(act, stream_idx[p], -1),
            torch.where(act, build_row[p], -1), n)


def matched_flags(verified, idx, capacity: int):
    """bool (capacity,): whether any verified slot names each row (idx may
    repeat; slots with idx < 0 name none)."""
    safe = torch.clamp(idx, 0, max(capacity - 1, 0)).long()
    contrib = (verified & (idx >= 0)).to(torch.int32)
    flags = torch.zeros(capacity, dtype=torch.int32, device=idx.device)
    return flags.scatter_reduce_(0, safe, contrib, reduce="amax") > 0


def outer_extend_maps(s_map, b_map, n_pairs, unmatched_idx, n_unmatched,
                      null_on: str, out_capacity: int):
    """Append unmatched rows (the other side -1, so null) after the
    matched pairs. null_on: the side that is null on the appended rows
    ('build' for a left outer join, 'stream' for a right outer one)."""
    dev = s_map.device
    i = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    total = n_pairs + n_unmatched
    from_un = (i >= n_pairs) & (i < total)
    un_i = torch.clamp(i - n_pairs, 0, unmatched_idx.shape[0] - 1).long()
    pair_i = torch.clamp(i, 0, s_map.shape[0] - 1).long()
    in_pairs = i < n_pairs
    un = unmatched_idx[un_i]
    s_pairs = torch.where(in_pairs, s_map[pair_i], -1)
    b_pairs = torch.where(in_pairs, b_map[pair_i], -1)
    if null_on == "build":
        return (torch.where(from_un, un, s_pairs),
                torch.where(from_un, -1, b_pairs), total)
    return (torch.where(from_un, -1, s_pairs),
            torch.where(from_un, un, b_pairs), total)


def unmatched_indices(matched, num_rows, capacity: int):
    """Indices of the active rows whose flag is False, compacted in row
    order (-1 past their count), and the count."""
    act = active_mask(num_rows, capacity, matched.device)
    perm, n = compaction_order(act & ~matched, num_rows)
    return torch.where(active_mask(n, capacity), perm, -1), n


def cross_pairs(stream_rows: int, build_rows: int, chunk_start: int,
                out_capacity: int, device=None):
    """Nested-loop candidates on `device`: the (stream, build) pairs whose
    flat index stream * build_rows + build lies in [chunk_start,
    chunk_start + out_capacity), and how many there are. The row counts
    are host ints (the exec reads them once a batch). The flat index is
    int64: stream_rows * build_rows passes 2^31 well inside practical
    cartesian products."""
    dev = device
    i = torch.arange(out_capacity, dtype=torch.int64, device=dev) \
        + int(chunk_start)
    total = int(stream_rows) * int(build_rows)
    ok = i < total
    safe_build = max(int(build_rows), 1)
    s = torch.where(ok, i // safe_build, -1).to(torch.int32)
    b = torch.where(ok, i % safe_build, -1).to(torch.int32)
    n = min(max(total - int(chunk_start), 0), out_capacity)
    return s, b, torch.tensor(n, dtype=torch.int32, device=dev)
