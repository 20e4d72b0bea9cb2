"""HashJoinExec and NestedLoopJoinExec — the counterparts of
spark_rapids_tpu/exec/joins.py, for every join type the JAX package has:
inner, left/right/full outer, left semi, left anti and existence, each
with an optional residual condition.

HashJoinExec, per stream batch:
  1. `_counts_kernel`: the stream keys (an absorbed child filter ANDed
     into their validity), each row's candidate range in the bucketed
     build table (ops/join.probe_counts) and the int64 candidate total;
  2. the candidate bucket: measured (one host read of the total) or,
     inside a speculation scope, the bucket cached for this shape, with a
     device flag recorded with the scope in case the total outgrew it;
  3. `_probe_kernel`: for integer-like keys of equal lane widths the
     fused probe-verify kernel (ops/probe_verify.fused_probe_verify), for
     the others (a string or dictionary key, floating-point keys, keys of
     unequal widths) the candidate expansion and the key verify of
     ops/join.py (`expand_candidates`, `verify_pairs`: a varlen key byte
     for byte through spans into each side's own buffers, a fixed-width
     key by value, so NaN never matches and -0.0 matches 0.0); the
     residual condition over the candidate pairs (`_eval_condition`);
     then the emission by join type, as the JAX package emits:
       * inner with fixed-width keys: key-grouped (one sort puts verified
         pairs first with equal join keys contiguous), so a downstream
         group-by may skip its sort; otherwise candidate order;
       * semi, anti and existence: the per-stream-row matched flag
         (`matched_flags`), then the kept stream rows in row order
         (`compaction_order`), or the flag as a column;
       * a stream-preserving outer join: the verified pairs in candidate
         order, then the unmatched stream rows in row order, the build
         side null there;
       * a build-preserving outer join keeps one matched flag per build
         row in sorted build space across the stream batches, translates
         it once through `build.perm` and emits the unmatched build rows
         as one batch after the last stream batch;
     and one packed payload gather per side (ops/gather); string and
     dictionary columns ride the per-column path by row index.

An absorbed child filter becomes a key mask only where the rows it drops
would never be emitted: on the stream side of an inner or semi join, on
the build side where no build flags are kept. Elsewhere the filter stays
an operator of its own (an anti join must not see filtered rows as
unmatched). Semi, anti and existence joins build on the right.

Dictionary-encoded columns stay encoded through the join when the
absorbed filters and the condition evaluate in code space
(`consumes_encoded`). A build side of several batches decodes each batch
before the concat (distinct dictionaries do not concatenate), as the JAX
package does at its "concat" seam. Decoded string payloads gather into
byte buckets sized by their measured join need, read with the candidate
total.

NestedLoopJoinExec pairs every stream row with every build row in chunks
of `chunk_rows` flat pair indices (ops/join.cross_pairs), filters them by
the condition and emits each chunk's pairs through the packed row
gather; outer, semi, anti and existence reduce to the stream's matched
flags.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from ..columnar.batch import ColumnarBatch, empty_batch
from ..columnar.column import Column, StringColumn, bucket_capacity
from ..columnar.encoded import DictionaryColumn, materialize_batch
from ..expr.core import Expression, UnresolvedAttribute, resolve
from ..expr.predicates import encoded_safe_predicate, encoded_safe_projection
from ..ops import gather as G
from ..ops.basic import active_mask, compaction_order, gather_column
from ..ops.hashing import u32_of
from ..ops.join import (BuildTable, cross_pairs, expand_candidates,
                        inner_gather_maps, int_key_lanes, matched_flags,
                        outer_extend_maps, probe_counts, unmatched_indices,
                        verify_pairs)
from ..ops.probe_verify import fused_probe_verify
from ..ops.rowpack import unpack_rows
from ..ops.sort import _float_order_bits, lexsort
from ..ops.strings import string_lengths
from ..types import BOOLEAN, DecimalType, Schema, StructField
from .base import TpuExec
from .basic import FilterExec, bind_projection
from .coalesce import concat_batches

INNER, LEFT_OUTER, RIGHT_OUTER, FULL_OUTER = "inner", "left_outer", \
    "right_outer", "full_outer"
LEFT_SEMI, LEFT_ANTI, EXISTENCE, CROSS = "left_semi", "left_anti", \
    "existence", "cross"
#: the join types of HashJoinExec; semi, anti and existence build right
HASH_JOIN_TYPES = (INNER, LEFT_OUTER, RIGHT_OUTER, FULL_OUTER, LEFT_SEMI,
                   LEFT_ANTI, EXISTENCE)
RIGHT_BUILD_ONLY = (LEFT_SEMI, LEFT_ANTI, EXISTENCE)
#: the join types of NestedLoopJoinExec (its build side is the right)
NESTED_LOOP_JOIN_TYPES = (INNER, CROSS, LEFT_OUTER, LEFT_SEMI, LEFT_ANTI,
                          EXISTENCE)
BUILD_TIME = "buildTime"
JOIN_TIME = "joinTime"


def join_output_schema(left: Schema, right: Schema, join_type: str,
                       exists_name: str = "exists") -> Schema:
    """A join's output schema: the left side alone for semi and anti, the
    left side and the `exists_name` flag for existence, else both sides,
    the null-extended side nullable."""
    if join_type in (LEFT_SEMI, LEFT_ANTI):
        return left
    if join_type == EXISTENCE:
        return Schema(tuple(left.fields)
                      + (StructField(exists_name, BOOLEAN, False),))
    lf = [StructField(f.name, f.data_type, f.nullable or join_type in
                      (RIGHT_OUTER, FULL_OUTER)) for f in left.fields]
    rf = [StructField(f.name, f.data_type, f.nullable or join_type in
                      (LEFT_OUTER, FULL_OUTER)) for f in right.fields]
    return Schema(tuple(lf + rf))


def _string_byte_needs(stream_columns, build: BuildTable, lo, counts,
                       num_rows):
    """The exact byte need of each string column of the join output, on
    the device, in column order (stream side, then build payload). A
    stream row is emitted count_i times among the candidates plus at most
    once more (the outer join's unmatched tail); the build side's need is
    the byte prefix sum over each row's candidate range."""
    cnt = counts.to(torch.int64)
    act = active_mask(num_rows, counts.shape[0])
    needs = []
    for c in stream_columns:
        if isinstance(c, StringColumn):
            lens = torch.where(act, string_lengths(c), 0).to(torch.int64)
            needs.append(torch.sum(cnt * lens) + torch.sum(lens))
    lo64 = lo.long()
    for prefix in build.payload_prefix:
        needs.append(torch.sum(prefix[lo64 + cnt] - prefix[lo64]))
    return needs


def _byte_caps(columns, needs) -> tuple:
    """Per-column output byte bucket of the string columns (None for the
    others), from fetched needs in column order."""
    it = iter(needs)
    return tuple(bucket_capacity(max(int(next(it)), 8))
                 if isinstance(c, StringColumn) else None for c in columns)


def _key_sort_lanes(key_cols: Sequence[Column]):
    """The sort lanes of key-grouped emission for fixed-width keys off the
    probe kernel, as the JAX package sorts its packed key lanes: a DOUBLE
    key by value (its total order: -0.0 with 0.0, NaN last), a 64-bit
    integer as its (lo, hi) u32 halves, any other type as the u32 bits of
    its 32-bit lane (a FLOAT by its bits)."""
    lanes = []
    for c in key_cols:
        d = c.data
        if d.dtype == torch.float64:
            lanes.append((_float_order_bits(d), 64))
        elif d.dtype.itemsize == 8:
            halves = d.contiguous().view(torch.int32).view(-1, 2)
            lanes += [(u32_of(halves[:, 0]), 32), (u32_of(halves[:, 1]), 32)]
        elif d.dtype == torch.float32:
            lanes.append((u32_of(d.view(torch.int32)), 32))
        else:
            lanes.append((u32_of(d.to(torch.int32)), 32))
    return lanes


class HashJoinExec(TpuExec):
    #: speculative sizing-cache entries expire after this many uses so one
    #: pathological batch cannot inflate candidate buckets forever
    SPEC_REFRESH = 512

    def __init__(self, left: TpuExec, right: TpuExec,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 join_type: str = INNER, build_side: str = "right",
                 condition: Optional[Expression] = None,
                 exists_name: str = "exists"):
        super().__init__(left, right)
        if join_type not in HASH_JOIN_TYPES:
            raise ValueError(f"HashJoinExec joins {HASH_JOIN_TYPES}, not "
                             f"{join_type!r}")
        if build_side not in ("left", "right"):
            raise ValueError(f"build_side must be left or right, not "
                             f"{build_side!r}")
        if join_type in RIGHT_BUILD_ONLY and build_side != "right":
            raise ValueError(f"a {join_type} join preserves its stream "
                             f"side and builds on the right")
        self.join_type = join_type
        self.build_side = build_side
        self.condition = condition
        self.exists_name = exists_name
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        # (partition, stream_cap, build_cap, string columns) -> cand_cap:
        # lets a speculation scope skip the per-batch sizing read
        self._size_cache = {}
        # the inputs' partition, set by a caller that runs this join over
        # several partition pairs (ShuffledHashJoinExec): each pair sizes
        # its own buckets, never one cached from another pair
        self.partition = None
        self._spec_uses = {}
        # the same key -> the string columns' byte buckets
        self._caps_cache = {}
        self._stream_side = 0 if build_side == "right" else 1
        s, b = self._stream_side, 1 - self._stream_side
        # a child filter becomes a key-validity mask (an invalid key never
        # matches) where the rows it drops are never emitted
        absorb = [False, False]
        absorb[s] = join_type in (INNER, LEFT_SEMI)
        absorb[b] = not self._need_build_flags
        kids = list(self.children)
        self._filters: List[Optional[List[Expression]]] = [None, None]
        for side in (0, 1):
            preds = []
            while absorb[side] and isinstance(kids[side], FilterExec):
                preds.append(kids[side]._bound)
                kids[side] = kids[side].child
            self._filters[side] = preds or None
        self.children = kids
        keys = (self.left_keys, self.right_keys)
        self._stream_keys = bind_projection(keys[s],
                                            kids[s].output_schema)
        self._build_keys = bind_projection(keys[b], kids[b].output_schema)
        # the residual condition, bound to the pair schema (left columns
        # then right columns)
        self._pair_schema = Schema(tuple(kids[0].output_schema.fields)
                                   + tuple(kids[1].output_schema.fields))
        self._cond_bound = None if condition is None \
            else resolve(condition, self._pair_schema)

    @property
    def _need_build_flags(self) -> bool:
        """True when unmatched build rows are emitted."""
        jt, bs = self.join_type, self.build_side
        return ((jt in (RIGHT_OUTER, FULL_OUTER) and bs == "right")
                or (jt in (LEFT_OUTER, FULL_OUTER) and bs == "left"))

    @property
    def _stream_preserved(self) -> bool:
        """True when unmatched stream rows are emitted, null-extended."""
        jt, bs = self.join_type, self.build_side
        return (jt == LEFT_OUTER and bs == "right") or \
            (jt == RIGHT_OUTER and bs == "left") or jt == FULL_OUTER

    @property
    def consumes_encoded(self) -> bool:
        """Encoded inputs are fine when every key is a bare reference or
        string-reference-free and the absorbed filters and the residual
        condition pass the code-space walk."""
        keys = self._stream_keys + self._build_keys
        if not all(encoded_safe_projection(e) for e in keys):
            return False
        preds = [p for f in self._filters for p in (f or ())]
        if self._cond_bound is not None:
            preds.append(self._cond_bound)
        return all(encoded_safe_predicate(p) for p in preds)

    @property
    def output_schema(self) -> Schema:
        return join_output_schema(self.children[0].output_schema,
                                  self.children[1].output_schema,
                                  self.join_type, self.exists_name)

    def additional_metrics(self):
        return (BUILD_TIME, JOIN_TIME)

    @property
    def output_grouped_by(self):
        """Inner-join output batches of fixed-width keys are emitted
        key-grouped: one equivalence class per key pair (left key == right
        key on every emitted row), by the names the output schema carries
        once. Other joins, and string and decimal keys (not in the
        packed key lanes), emit in candidate order (None), as in the JAX
        package."""
        if self.join_type != INNER or not all(
                e.data_type.is_fixed_width
                and not isinstance(e.data_type, DecimalType)
                for e in self._stream_keys + self._build_keys):
            return None
        out_names = [f.name for f in self.output_schema.fields]
        classes = []
        for lk, rk in zip(self.left_keys, self.right_keys):
            names = {e.name for e in (lk, rk)
                     if isinstance(e, UnresolvedAttribute)
                     and out_names.count(e.name) == 1}
            if not names:
                return None
            classes.append(frozenset(names))
        return tuple(classes)

    @staticmethod
    def _mask_keys(key_cols, keep) -> List[Column]:
        """AND an absorbed filter's mask into key validity (an invalid key
        never matches, so the filtered rows vanish from the output)."""
        out = []
        for c in key_cols:
            v = c.validity & keep
            if isinstance(c, DictionaryColumn):
                out.append(DictionaryColumn(c.codes, c.dict_data,
                                            c.dict_offsets, v, c.dtype))
            elif isinstance(c, StringColumn):
                out.append(StringColumn(c.data, c.offsets, v, c.dtype))
            else:
                out.append(Column(c.data, v, c.dtype))
        return out

    @classmethod
    def _key_columns(cls, bound, preds, batch: ColumnarBatch) -> List[Column]:
        cols = [e.columnar_eval(batch) for e in bound]
        if preds:
            keep = None
            for p in preds:
                c = p.columnar_eval(batch)
                k = c.data & c.validity  # Spark: null predicate rows drop
                keep = k if keep is None else keep & k
            cols = cls._mask_keys(cols, keep)
        return cols

    # -- build -------------------------------------------------------------
    def _build(self):
        b = 1 - self._stream_side
        child = self.children[b]
        with self.metrics[BUILD_TIME].ns_timer():
            batches = list(child.execute())
            if len(batches) > 1:
                # distinct per-batch dictionaries do not concatenate:
                # decode first; a single batch stays encoded
                batches = [materialize_batch(b) for b in batches]
            batch = concat_batches(batches, child.output_schema) \
                if batches else empty_batch(child.output_schema,
                                            device=child.device)
            keys = self._key_columns(self._build_keys, self._filters[b],
                                     batch)
            return BuildTable.build(keys, list(batch.columns),
                                    batch.num_rows, batch.capacity)

    # -- probe -------------------------------------------------------------
    def internal_execute(self) -> Iterator[ColumnarBatch]:
        build = self._build()
        join_time = self.metrics[JOIN_TIME]
        # matched flags in sorted build space, across the stream batches
        build_matched = torch.zeros(
            build.capacity, dtype=torch.bool, device=build.perm.device) \
            if self._need_build_flags else None
        for stream_batch in self.children[self._stream_side].execute():
            with join_time.ns_timer():
                out, build_matched = self._probe_one(build, stream_batch,
                                                     build_matched)
            yield out
        if self._need_build_flags:
            with join_time.ns_timer():
                out = self._emit_build_unmatched(build, build_matched)
            yield out

    def _counts_kernel(self, build: BuildTable, stream_batch: ColumnarBatch):
        skey_cols = self._key_columns(self._stream_keys,
                                      self._filters[self._stream_side],
                                      stream_batch)
        lo, counts, _ = probe_counts(build, skey_cols,
                                     stream_batch.num_rows,
                                     stream_batch.capacity)
        return lo, counts, skey_cols, torch.sum(counts, dtype=torch.int64)

    def _candidate_capacity(self, key, total_dev, needs=(), columns=()):
        """The candidate bucket, and the byte buckets of the string
        columns in `columns` (stream side, then build payload) from their
        device `needs`: cached inside a speculation scope, with a device
        flag for outgrowing them; else measured by one host read."""
        from .speculation import current_scope, speculation_allowed
        cached = self._size_cache.get(key)
        if cached is not None and speculation_allowed():
            self._spec_uses[key] = self._spec_uses.get(key, 0) + 1
            if self._spec_uses[key] > self.SPEC_REFRESH:
                # expire: the next probe re-measures (no monotone max),
                # so buckets can shrink back
                del self._size_cache[key]
                self._spec_uses[key] = 0
                cached = None
        if cached is not None and speculation_allowed():
            # speculative sizing: reuse the buckets, let the scope re-run
            # the plan exactly if this batch outgrew them
            caps = self._caps_cache.get(key, ())
            flag = total_dev > cached
            for need, cap in zip(needs, [c for c in caps if c is not None]):
                flag = flag | (need > cap)
            current_scope().record(flag)
            return cached, caps
        # one host read of the total and the byte needs
        fetched = torch.stack([total_dev] + list(needs)).tolist() \
            if needs else [int(total_dev)]
        cand_cap = bucket_capacity(max(fetched[0], 1))
        caps = _byte_caps(columns, fetched[1:])
        if cached is not None:
            # monotone while cached
            cand_cap = max(cand_cap, cached)
            caps = tuple(None if c is None else max(c, o)
                         for c, o in zip(caps, self._caps_cache[key]))
        self._size_cache[key] = cand_cap
        self._caps_cache[key] = caps
        return cand_cap, caps

    def _probe_one(self, build: BuildTable, stream_batch: ColumnarBatch,
                   build_matched=None):
        lo, counts, skey_cols, total_dev = self._counts_kernel(
            build, stream_batch)
        columns = list(stream_batch.columns) + list(build.payload)
        needs = _string_byte_needs(stream_batch.columns, build, lo, counts,
                                   stream_batch.num_rows) \
            if any(isinstance(c, StringColumn) for c in columns) else []
        # the key names which columns are strings: an empty build side
        # (an empty dictionary) may differ there from the others
        key = (self.partition, stream_batch.capacity, build.capacity,
               tuple(isinstance(c, StringColumn) for c in columns))
        cand_cap, caps = self._candidate_capacity(key, total_dev, needs,
                                                  columns)
        n_s = len(stream_batch.columns)
        return self._probe_kernel(build, stream_batch, lo, counts,
                                  skey_cols, total_dev, cand_cap,
                                  caps[:n_s], caps[n_s:], build_matched)

    def _verify(self, build: BuildTable, lo, counts, skey_cols, cand_cap):
        """(fused, verified, s_idx, b_pos, b_row) over the candidate
        slots: b_pos is the sorted build position (-1 past the total),
        b_row the original build row."""
        sk = int_key_lanes(skey_cols)
        if build.key_lanes is not None and sk is not None \
                and sk[0].shape[1] == build.key_lanes[0].shape[1]:
            bk_lanes, bvalid = build.key_lanes
            sk_lanes, svalid = sk
            verified, s_idx, b_pos, b_row = fused_probe_verify(
                lo, counts, bk_lanes, bvalid, sk_lanes, svalid, build.perm,
                cand_cap)
            return True, verified, s_idx, b_pos, b_row
        s_idx, b_pos, _ = expand_candidates(lo, counts, cand_cap)
        pair_valid = s_idx >= 0
        b_pos = torch.where(pair_valid, b_pos, -1)
        verified, b_row = verify_pairs(build, skey_cols, s_idx, b_pos,
                                       pair_valid)
        return False, verified, s_idx, b_pos, b_row

    def _probe_kernel(self, build: BuildTable, stream_batch: ColumnarBatch,
                      lo, counts, skey_cols, total_dev, cand_cap: int,
                      s_caps=(), b_caps=(), build_matched=None):
        jt = self.join_type
        fused, verified, s_idx, b_pos, b_row = self._verify(
            build, lo, counts, skey_cols, cand_cap)
        if self._cond_bound is not None:
            verified = verified & self._eval_condition(
                build, stream_batch, s_idx, b_row, s_caps, b_caps)
        if build_matched is not None:
            build_matched = build_matched | matched_flags(
                verified, b_pos, build.capacity)
        scap = stream_batch.capacity
        if jt in RIGHT_BUILD_ONLY:
            return self._emit_stream_flags(
                stream_batch, matched_flags(verified, s_idx, scap)), \
                build_matched

        dev = verified.device
        plan_p, pmat_b, pfmat_b, members_of, poi = build.pack
        if jt == INNER and all(type(c) is Column
                               for c in skey_cols + build.key_cols):
            # key-grouped emission: verified pairs first, equal join keys
            # contiguous (any consistent total order over the key bits
            # groups them), so a downstream group-by may skip its sort
            kflag = verified & active_mask(total_dev, cand_cap, dev)
            if fused:
                bk_lanes = build.key_lanes[0]
                safe_c = torch.clamp(b_pos, 0, bk_lanes.shape[0] - 1).long()
                klanes = torch.where(kflag[:, None], bk_lanes[safe_c], 0)
                lanes = [(u32_of(klanes[:, j]), 32)
                         for j in range(klanes.shape[1])]
            else:
                lanes = _key_sort_lanes([gather_column(c, b_row)
                                         for c in build.key_cols])
            perm_c = lexsort([((~kflag).to(torch.int64), 1)] + lanes)
            n_pairs = torch.sum(kflag, dtype=torch.int32)
        else:
            # verified pairs first, in candidate order
            perm_c, n_pairs = compaction_order(verified, total_dev)

        # ONE index materialization of the compacted pairs, then one
        # packed payload gather per side; dictionary columns of the build
        # side gather their codes by original build row
        lane_mat = torch.stack([s_idx, b_pos] + ([b_row] if poi else []),
                               dim=1)
        from_pairs = active_mask(n_pairs, cand_cap, dev)
        g = G.gather_lane_matrix(
            lane_mat, torch.where(from_pairs, perm_c.to(torch.int32), -1))
        s_map = torch.where(from_pairs, g[:, 0], -1)
        b_pos_out = torch.where(from_pairs, g[:, 1], -1)
        b_map = torch.where(from_pairs, g[:, 2], -1) if poi else None
        n_out = n_pairs
        if self._stream_preserved:
            # the unmatched stream rows follow the pairs, in row order,
            # the build side null
            un_idx, n_un = unmatched_indices(
                matched_flags(verified, s_idx, scap),
                stream_batch.num_rows, scap)
            out_cap = bucket_capacity(cand_cap + scap)
            pairs_s = s_map
            s_map, b_pos_out, n_out = outer_extend_maps(
                pairs_s, b_pos_out, n_pairs, un_idx, n_un, "build", out_cap)
            if poi:
                b_map = outer_extend_maps(pairs_s, b_map, n_pairs, un_idx,
                                          n_un, "build", out_cap)[1]
        bcols: List[Optional[Column]] = [None] * len(build.payload)
        if plan_p.kinds:
            pmat_out, pfmat_out = G.gather_rows(plan_p, pmat_b, pfmat_b,
                                                b_pos_out)
            G.rebuild_members(build.payload, members_of,
                              unpack_rows(plan_p, pmat_out, pfmat_out),
                              bcols)
        for j in poi:
            bcols[j] = gather_column(
                build.payload[j], b_map,
                out_byte_capacity=b_caps[j] if b_caps else None)
        scols = G.gather_batch_columns(stream_batch.columns, s_map,
                                       num_rows=n_out, byte_caps=s_caps)
        left, right = (scols, bcols) if self.build_side == "right" \
            else (bcols, scols)
        return ColumnarBatch(left + right, n_out, self.output_schema), \
            build_matched

    def _emit_stream_flags(self, stream_batch: ColumnarBatch, smatched):
        """Semi, anti and existence: the stream rows with (or without) a
        verified pair, compacted in row order, or every stream row with
        the flag as a column."""
        if self.join_type == EXISTENCE:
            flag = Column(smatched, torch.ones_like(smatched), BOOLEAN)
            return ColumnarBatch(list(stream_batch.columns) + [flag],
                                 stream_batch.num_rows, self.output_schema,
                                 stream_batch._host_rows)
        keep = smatched if self.join_type == LEFT_SEMI else ~smatched
        perm, n = compaction_order(keep, stream_batch.num_rows)
        cols = G.gather_batch_columns(stream_batch.columns, perm, num_rows=n)
        return ColumnarBatch(cols, n, self.output_schema)

    def _emit_build_unmatched(self, build: BuildTable, build_matched
                              ) -> ColumnarBatch:
        """The build rows no stream batch matched, in build row order, the
        stream side null: the flags live in sorted build space and
        translate once to original rows (perm is a permutation)."""
        flags = torch.zeros(build.capacity, dtype=torch.int32,
                            device=build_matched.device)
        matched = flags.scatter_reduce_(0, build.perm.long(),
                                        build_matched.to(torch.int32),
                                        reduce="amax") > 0
        un_idx, n_un = unmatched_indices(matched, build.num_rows,
                                         build.capacity)
        bcols = G.gather_batch_columns(build.payload, un_idx, num_rows=n_un)
        # the stream side null, as the JAX package's empty batch gathered
        # at -1 (a string column as an empty dictionary)
        stream_schema = self.children[self._stream_side].output_schema
        scols = list(empty_batch(stream_schema, capacity=build.capacity,
                                 device=build_matched.device).columns)
        left, right = (scols, bcols) if self.build_side == "right" \
            else (bcols, scols)
        return ColumnarBatch(left + right, n_un, self.output_schema)

    def _eval_condition(self, build: BuildTable, stream_batch: ColumnarBatch,
                        s_idx, b_row, s_caps=(), b_caps=()) -> torch.Tensor:
        """The residual condition over the candidate pairs: a pair batch
        of both sides' columns gathered at (stream_idx, build_row), in
        candidate-slot order; slots past the total (-1) come out null and
        drop, as do pairs whose condition is null."""
        cand_cap = s_idx.shape[0]
        # per column, as the JAX package gathers them: a packed gather
        # would pack every stream row to move a bucket of candidates
        s_caps = s_caps or (None,) * len(stream_batch.columns)
        b_caps = b_caps or (None,) * len(build.payload)
        scols = [gather_column(c, s_idx, out_byte_capacity=bc)
                 for c, bc in zip(stream_batch.columns, s_caps)]
        bcols = [gather_column(c, b_row, out_byte_capacity=bc)
                 for c, bc in zip(build.payload, b_caps)]
        left, right = (scols, bcols) if self.build_side == "right" \
            else (bcols, scols)
        pair = ColumnarBatch(left + right, cand_cap, self._pair_schema)
        pred = self._cond_bound.columnar_eval(pair)
        return pred.data & pred.validity


class NestedLoopJoinExec(TpuExec):
    """Broadcast nested-loop / cartesian product join: every (stream,
    build) pair in chunks of `chunk_rows` flat pair indices, the condition
    filtering them. The build side is the right child, materialized once;
    the stream is the left. Inner and cross joins emit each chunk's pairs
    through one packed row gather a side; a left outer join appends each
    stream batch's unmatched rows, null-extended; semi, anti and existence
    reduce to the stream's matched flags. String columns size their
    output byte buckets from each side's longest row, read once a batch."""

    def __init__(self, left: TpuExec, right: TpuExec,
                 join_type: str = CROSS,
                 condition: Optional[Expression] = None,
                 chunk_rows: int = 1 << 16):
        super().__init__(left, right)
        if join_type not in NESTED_LOOP_JOIN_TYPES:
            raise ValueError(f"NestedLoopJoinExec joins "
                             f"{NESTED_LOOP_JOIN_TYPES}, not {join_type!r}")
        self.join_type = join_type
        self.condition = condition
        self.chunk_rows = chunk_rows
        self._pair_schema = Schema(
            tuple(left.output_schema.fields)
            + tuple(right.output_schema.fields))
        self._cond_bound = None if condition is None \
            else resolve(condition, self._pair_schema)

    @property
    def output_schema(self) -> Schema:
        jt = INNER if self.join_type == CROSS else self.join_type
        return join_output_schema(self.children[0].output_schema,
                                  self.children[1].output_schema, jt)

    def additional_metrics(self):
        return (BUILD_TIME,)

    @staticmethod
    def _max_lens(batch: ColumnarBatch, n_rows: int) -> List[Optional[int]]:
        """Longest string row per column (None for fixed-width), in one
        host read a batch."""
        maxes = []
        for c in batch.columns:
            if isinstance(c, StringColumn):
                act = active_mask(n_rows, c.capacity, c.validity.device)
                maxes.append(torch.max(torch.where(act, string_lengths(c),
                                                   0)))
        if not maxes:
            return [None] * len(batch.columns)
        fetched = iter(torch.stack(maxes).tolist())
        return [int(next(fetched)) if isinstance(c, StringColumn) else None
                for c in batch.columns]

    @staticmethod
    def _chunk_byte_caps(max_lens: List[Optional[int]], chunk_cap: int
                         ) -> Tuple:
        """A chunk repeats rows: each string column's output byte bucket
        is its longest row times the chunk's capacity."""
        return tuple(None if ml is None
                     else bucket_capacity(max(chunk_cap * ml, 8))
                     for ml in max_lens)

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        right = self.children[1]
        with self.metrics[BUILD_TIME].ns_timer():
            batches = list(right.execute())
            build = concat_batches(batches, right.output_schema) \
                if batches else empty_batch(right.output_schema,
                                            device=right.device)
            b_rows = build.num_rows_host
            b_lens = self._max_lens(build, b_rows)
        for stream in self.children[0].execute():
            yield from self._join_stream(stream, build, b_rows, b_lens)

    def _join_stream(self, stream: ColumnarBatch, build: ColumnarBatch,
                     b_rows: int, b_lens) -> Iterator[ColumnarBatch]:
        jt = self.join_type
        dev = stream.device
        s_rows = stream.num_rows_host
        s_lens = self._max_lens(stream, s_rows)
        total = s_rows * b_rows
        smatched = torch.zeros(stream.capacity, dtype=torch.bool, device=dev)
        start = 0
        while start < total:
            # the bucket may pass the nominal chunk: take a full bucket
            cap = bucket_capacity(max(min(self.chunk_rows, total - start),
                                      1))
            chunk = min(total - start, cap)
            s_idx, b_idx, n = cross_pairs(s_rows, b_rows, start, cap, dev)
            s_caps = self._chunk_byte_caps(s_lens, cap)
            b_caps = self._chunk_byte_caps(b_lens, cap)
            verified = s_idx >= 0
            if self._cond_bound is not None:
                verified = verified & self._condition_mask(
                    stream, build, s_idx, b_idx, cap, s_caps, b_caps)
            if jt in (LEFT_SEMI, LEFT_ANTI, EXISTENCE, LEFT_OUTER):
                smatched = smatched | matched_flags(verified, s_idx,
                                                    stream.capacity)
            if jt in (INNER, CROSS, LEFT_OUTER):
                s_map, b_map, n_pairs = inner_gather_maps(
                    verified, s_idx, b_idx, n)
                scols = G.gather_batch_columns(stream.columns, s_map,
                                               num_rows=n_pairs,
                                               byte_caps=s_caps)
                bcols = G.gather_batch_columns(build.columns, b_map,
                                               num_rows=n_pairs,
                                               byte_caps=b_caps)
                yield ColumnarBatch(scols + bcols, n_pairs,
                                    self.output_schema)
            start += chunk
        if jt == LEFT_OUTER:
            un_idx, n_un = unmatched_indices(smatched, stream.num_rows,
                                             stream.capacity)
            scols = G.gather_batch_columns(stream.columns, un_idx,
                                           num_rows=n_un)
            null_map = torch.full((stream.capacity,), -1, dtype=torch.int32,
                                  device=dev)
            bcols = [gather_column(c, null_map) for c in build.columns]
            yield ColumnarBatch(scols + bcols, n_un, self.output_schema)
        elif jt in (LEFT_SEMI, LEFT_ANTI):
            keep = smatched if jt == LEFT_SEMI else ~smatched
            perm, n_keep = compaction_order(keep, stream.num_rows)
            cols = G.gather_batch_columns(stream.columns, perm,
                                          num_rows=n_keep)
            yield ColumnarBatch(cols, n_keep, self.output_schema)
        elif jt == EXISTENCE:
            flag = Column(smatched, torch.ones_like(smatched), BOOLEAN)
            yield ColumnarBatch(list(stream.columns) + [flag],
                                stream.num_rows, self.output_schema,
                                stream._host_rows)

    def _condition_mask(self, stream, build, s_idx, b_idx, cap: int,
                        s_caps: Tuple = (), b_caps: Tuple = ()):
        scols = [gather_column(c, s_idx, out_byte_capacity=bc)
                 for c, bc in zip(stream.columns, s_caps)]
        bcols = [gather_column(c, b_idx, out_byte_capacity=bc)
                 for c, bc in zip(build.columns, b_caps)]
        pair = ColumnarBatch(scols + bcols, cap, self._pair_schema)
        pred = self._cond_bound.columnar_eval(pair)
        return pred.data & pred.validity
