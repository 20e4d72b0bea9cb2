"""HashJoinExec — the counterpart of spark_rapids_tpu/exec/joins.py for
INNER equi-joins, with an optional residual condition.

Per stream batch:
  1. `_counts_kernel`: the stream keys (an absorbed child filter ANDed
     into their validity), each row's candidate range in the bucketed
     build table (ops/join.probe_counts) and the int64 candidate total;
  2. the candidate bucket: measured (one host read of the total) or,
     inside a speculation scope, the bucket cached for this shape, with a
     device flag recorded with the scope in case the total outgrew it;
  3. `_probe_kernel`: for integer-like keys the fused probe-verify
     kernel (ops/probe_verify.fused_probe_verify), for key lists with a
     string or dictionary key the candidate expansion and the key verify of
     ops/join.py (`expand_candidates`, `verify_pairs`, a varlen key byte
     for byte through spans into each side's own buffers); the residual
     condition over the candidate pairs (`_eval_condition`); then the
     emission, key-grouped for integer-like keys (one sort puts verified
     pairs first with equal join keys contiguous), in candidate order
     otherwise (a stable compaction), as the JAX package emits; and one
     packed payload gather per side (ops/gather); string and dictionary
     columns ride the per-column path by row index.

Dictionary-encoded columns stay encoded through the join when the
absorbed filters and the condition evaluate in code space
(`consumes_encoded`). A build side of several batches decodes each batch
before the concat (distinct dictionaries do not concatenate), as the JAX
package does at its "concat" seam. Decoded string payloads gather into
byte buckets sized by their measured join need, read with the candidate
total. The JAX package picks between the fused route and its XLA
expand-then-verify route by measurement; the port takes the fused route
for integer-like keys of equal widths, the other for key lists with a
string or dictionary key. Other join types, and other fixed-width keys
(floating-point, unequal widths), raise NotImplementedError (ROADMAP
A.3).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch

from ..columnar.batch import ColumnarBatch, empty_batch
from ..columnar.column import Column, StringColumn, bucket_capacity
from ..columnar.encoded import DictionaryColumn, materialize_batch
from ..expr.core import Expression, UnresolvedAttribute, resolve
from ..expr.predicates import encoded_safe_predicate, encoded_safe_projection
from ..ops import gather as G
from ..ops.basic import active_mask, compaction_order, gather_column
from ..ops.hashing import u32_of
from ..ops.join import (BuildTable, expand_candidates, int_key_lanes,
                        probe_counts, verify_pairs)
from ..ops.probe_verify import fused_probe_verify
from ..ops.rowpack import unpack_rows
from ..ops.sort import lexsort
from ..ops.strings import string_lengths
from ..types import Schema
from .base import TpuExec
from .basic import FilterExec, bind_projection
from .coalesce import concat_batches

INNER = "inner"
BUILD_TIME = "buildTime"
JOIN_TIME = "joinTime"


def _string_byte_needs(stream_columns, build: BuildTable, lo, counts,
                       num_rows):
    """The exact byte need of each string column of the join output, on
    the device, in column order (stream side, then build payload). A
    stream row is emitted count_i times among the candidates (plus at
    most once more, the JAX package's outer-join tail); the build side's
    need is the byte prefix sum over each row's candidate range."""
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


class HashJoinExec(TpuExec):
    #: speculative sizing-cache entries expire after this many uses so one
    #: pathological batch cannot inflate candidate buckets forever
    SPEC_REFRESH = 512

    def __init__(self, left: TpuExec, right: TpuExec,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 join_type: str = INNER, build_side: str = "right",
                 condition: Optional[Expression] = None):
        super().__init__(left, right)
        if join_type != INNER:
            raise NotImplementedError(
                f"{join_type} joins wait for a later slice (ROADMAP A.3)")
        if build_side not in ("left", "right"):
            raise ValueError(f"build_side must be left or right, not "
                             f"{build_side!r}")
        self.join_type = join_type
        self.build_side = build_side
        self.condition = condition
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        # (stream_cap, build_cap) -> cand_cap: lets a speculation scope
        # skip the per-batch sizing read
        self._size_cache = {}
        self._spec_uses = {}
        # the same key -> the string columns' byte buckets
        self._caps_cache = {}
        # an inner join emits matched rows only, so a child filter on
        # either side becomes a key-validity mask (an invalid key never
        # matches) instead of a compaction
        kids = list(self.children)
        self._filters: List[Optional[List[Expression]]] = [None, None]
        for side in (0, 1):
            preds = []
            while isinstance(kids[side], FilterExec):
                preds.append(kids[side]._bound)
                kids[side] = kids[side].child
            self._filters[side] = preds or None
        self.children = kids
        self._stream_side = 0 if build_side == "right" else 1
        s, b = self._stream_side, 1 - self._stream_side
        keys = (self.left_keys, self.right_keys)
        self._stream_keys = bind_projection(keys[s],
                                            kids[s].output_schema)
        self._build_keys = bind_projection(keys[b], kids[b].output_schema)
        # the residual condition, bound to the pair schema (left columns
        # then right columns: the output schema)
        self._cond_bound = None if condition is None \
            else resolve(condition, self.output_schema)

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
        return Schema(tuple(self.children[0].output_schema.fields)
                      + tuple(self.children[1].output_schema.fields))

    def additional_metrics(self):
        return (BUILD_TIME, JOIN_TIME)

    @property
    def output_grouped_by(self):
        """Output batches of fixed-width keys are emitted key-grouped: one
        equivalence class per key pair (left key == right key on every
        emitted row), by the names the output schema carries once. String
        keys are emitted in candidate order (None)."""
        if not all(e.data_type.is_fixed_width
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
        for stream_batch in self.children[self._stream_side].execute():
            with join_time.ns_timer():
                out = self._probe_one(build, stream_batch)
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

    def _probe_one(self, build: BuildTable, stream_batch: ColumnarBatch
                   ) -> ColumnarBatch:
        lo, counts, skey_cols, total_dev = self._counts_kernel(
            build, stream_batch)
        columns = list(stream_batch.columns) + list(build.payload)
        needs = _string_byte_needs(stream_batch.columns, build, lo, counts,
                                   stream_batch.num_rows) \
            if any(isinstance(c, StringColumn) for c in columns) else []
        cand_cap, caps = self._candidate_capacity(
            (stream_batch.capacity, build.capacity), total_dev, needs,
            columns)
        n_s = len(stream_batch.columns)
        return self._probe_kernel(build, stream_batch, lo, counts,
                                  skey_cols, total_dev, cand_cap,
                                  caps[:n_s], caps[n_s:])

    def _probe_kernel(self, build: BuildTable, stream_batch: ColumnarBatch,
                      lo, counts, skey_cols, total_dev, cand_cap: int,
                      s_caps=(), b_caps=()) -> ColumnarBatch:
        plan_p, pmat_b, pfmat_b, ppi, poi = build.pack
        sk = int_key_lanes(skey_cols)
        fused = build.key_lanes is not None and sk is not None \
            and sk[0].shape[1] == build.key_lanes[0].shape[1]
        if fused:
            bk_lanes, bvalid = build.key_lanes
            sk_lanes, svalid = sk
            verified, s_idx, b_pos, b_row = fused_probe_verify(
                lo, counts, bk_lanes, bvalid, sk_lanes, svalid, build.perm,
                cand_cap)
        elif not any(isinstance(c, (StringColumn, DictionaryColumn))
                     for c in skey_cols):
            raise NotImplementedError(
                "join keys of unequal widths or floating-point types wait "
                "for a later slice (ROADMAP A.3)")
        else:
            s_idx, b_pos, _ = expand_candidates(lo, counts, cand_cap)
            pair_valid = s_idx >= 0
            b_pos = torch.where(pair_valid, b_pos, -1)
            verified, b_row = verify_pairs(build, skey_cols, s_idx, b_pos,
                                           pair_valid)
        if self._cond_bound is not None:
            verified = verified & self._eval_condition(
                build, stream_batch, s_idx, b_row, s_caps, b_caps)

        dev = verified.device
        if fused:
            # key-grouped emission: verified pairs first, equal join keys
            # contiguous (any consistent total order over the key bits
            # groups them), so a downstream group-by may skip its sort
            kflag = verified & active_mask(total_dev, cand_cap, dev)
            safe_c = torch.clamp(b_pos, 0, bk_lanes.shape[0] - 1).long()
            klanes = torch.where(kflag[:, None], bk_lanes[safe_c], 0)
            perm_c = lexsort([((~kflag).to(torch.int64), 1)]
                             + [(u32_of(klanes[:, j]), 32)
                                for j in range(klanes.shape[1])])
            n_pairs = torch.sum(kflag, dtype=torch.int32)
        else:
            # verified pairs first, in candidate order
            perm_c, n_pairs = compaction_order(verified, total_dev)

        # ONE index materialization of the compacted pairs, then one
        # packed payload gather per side; dictionary columns of the build
        # side gather their codes by original build row
        i = torch.arange(cand_cap, dtype=torch.int32, device=dev)
        from_pairs = i < n_pairs
        bsel = torch.where(from_pairs, perm_c.to(torch.int32), -1)
        lane_mat = torch.stack([s_idx, b_pos] + ([b_row] if poi else []),
                               dim=1)
        g = G.gather_lane_matrix(lane_mat, bsel)
        s_map = torch.where(from_pairs, g[:, 0], -1)
        b_pos_out = torch.where(from_pairs, g[:, 1], -1)
        bcols: List[Optional[Column]] = [None] * len(build.payload)
        if ppi:
            pmat_out, pfmat_out = G.gather_rows(plan_p, pmat_b, pfmat_b,
                                                b_pos_out)
            for j, c in zip(ppi, unpack_rows(plan_p, pmat_out, pfmat_out)):
                bcols[j] = c
        if poi:
            b_map = torch.where(from_pairs, g[:, 2], -1)
            for j in poi:
                bcols[j] = gather_column(
                    build.payload[j], b_map,
                    out_byte_capacity=b_caps[j] if b_caps else None)
        scols = G.gather_batch_columns(stream_batch.columns, s_map,
                                       num_rows=n_pairs, byte_caps=s_caps)
        left, right = (scols, bcols) if self.build_side == "right" \
            else (bcols, scols)
        return ColumnarBatch(left + right, n_pairs, self.output_schema)

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
        pair = ColumnarBatch(left + right, cand_cap, self.output_schema)
        pred = self._cond_bound.columnar_eval(pair)
        return pred.data & pred.validity
