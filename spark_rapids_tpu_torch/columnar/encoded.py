"""Dictionary-encoded string columns — the counterpart of
spark_rapids_tpu/columnar/encoded.py, as far as code-space predicates
and late materialization need it.

A `DictionaryColumn` carries a device int32 code lane plus the per-batch
dictionary (Arrow (offsets, bytes) layout, bucket-padded like every other
buffer). Equality and IN against a string literal compare the literal with
each dictionary entry once and take each row's answer from that per-entry
hit lane by its code (`encoded_equal_literal` -> `dict_take`), never
decoding a row. `dict_take` runs the Hopper kernel of ops/dict_gather.py
on CUDA tensors.

Null and inactive rows hold `NULL_CODE` (-1). The column carries
`data=None`, as in the JAX package, so an operator that was not taught the
encoded layout fails on `.data` instead of misreading codes as values.

Late materialization: where an operator's parent cannot consume encoded
columns, its output decodes at the batch boundary (exec/base.py,
`materialize_batch`): a dictionary decode is a row gather of the
dictionary by the code lane (ops/strings.gather_string), into a byte
bucket sized by one host read per column (`decoded_byte_bucket`).
`collect()` lets encoded root batches out, since `to_pylist` decodes on
the host.

Join keys: a hash join hashes a dictionary key's entries once
(`dictionary_hashes`, counted in `dict_hash_tables`) and takes each row's
hash by code; the key verify compares bytes through (start, length) spans
into the original buffers (`row_byte_lanes`, `bytes_equal_at`), since two
sides' dictionaries differ and code equality means nothing across them.

The scan builds a DictionaryColumn from an Arrow dictionary array
(`dictionary_from_arrow`, io/parquet.py) or from numpy
(`dictionary_from_numpy`).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..types import BOOLEAN, BinaryType, DataType, StringType
from .column import (Column, StringColumn, _pad_np, bucket_capacity,
                     resolve_device)

__all__ = ["NULL_CODE", "DictionaryColumn",
           "dictionary_from_numpy", "dictionary_from_arrow",
           "dict_take", "dictionary_hashes", "row_byte_lanes",
           "bytes_equal_rows", "bytes_equal_at", "literal_hits",
           "encoded_equal_literal",
           "batch_has_encoded", "decoded_byte_bucket", "materialize_column",
           "materialize_batch", "counters"]

#: sentinel code for null/inactive rows, out of range for every dictionary
NULL_CODE = -1

_COUNTER_LOCK = threading.Lock()
_COUNTERS = {
    "cols_encoded": 0,           # DictionaryColumns built at the scan seam
    "code_space_predicates": 0,  # predicates evaluated on int32 codes
    "materializations": 0,       # columns decoded (one host read each)
    "materialized_bytes": 0,     # byte buckets of the decoded columns
    "dict_hash_tables": 0,       # per-dictionary murmur3 tables
}


def _note(**deltas) -> None:
    with _COUNTER_LOCK:
        for k, v in deltas.items():
            _COUNTERS[k] += v


def counters() -> Dict[str, int]:
    with _COUNTER_LOCK:
        return dict(_COUNTERS)


class DictionaryColumn(Column):
    """Encoded varlen column: int32 codes into a per-batch dictionary.

    codes    — int32 (capacity,); NULL_CODE for null/inactive rows
    validity — bool (capacity,)
    dict_offsets / dict_data — the dictionary's Arrow (offsets, bytes)
        buffers, bucket-padded like a StringColumn's; padded dictionary
        slots are zero-length entries no valid code refers to
    """

    __slots__ = ("codes", "dict_data", "dict_offsets")

    def __init__(self, codes: torch.Tensor, dict_data: torch.Tensor,
                 dict_offsets: torch.Tensor, validity: torch.Tensor,
                 dtype: DataType = StringType()):
        super().__init__(None, validity, dtype)
        self.codes = codes
        self.dict_data = dict_data
        self.dict_offsets = dict_offsets

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def dict_capacity(self) -> int:
        return int(self.dict_offsets.shape[0]) - 1

    @property
    def dict_byte_capacity(self) -> int:
        return int(self.dict_data.shape[0])

    def leaves(self) -> tuple:
        return (self.codes, self.dict_data, self.dict_offsets, self.validity)

    def dict_view(self) -> StringColumn:
        """The dictionary itself as a StringColumn (every entry valid —
        padded slots are zero-length and unreferenced)."""
        return StringColumn(self.dict_data, self.dict_offsets,
                            torch.ones(self.dict_capacity, dtype=torch.bool,
                                       device=self.device), self.dtype)

    def with_capacity(self, capacity: int) -> "DictionaryColumn":
        """Grow (never shrink) the row bucket with NULL_CODE rows."""
        cap = self.capacity
        if capacity == cap:
            return self
        if capacity < cap:
            raise ValueError(f"cannot shrink capacity {cap} to {capacity}")
        extra = capacity - cap
        codes = torch.cat([self.codes,
                           self.codes.new_full((extra,), NULL_CODE)])
        validity = torch.cat([self.validity,
                              self.validity.new_zeros(extra)])
        return DictionaryColumn(codes, self.dict_data, self.dict_offsets,
                                validity, self.dtype)

    def to_pylist(self, num_rows: int) -> List:
        """Host decode of the first `num_rows` rows (the test and output
        surface)."""
        codes = self.codes[:num_rows].cpu().numpy()
        valid = self.validity[:num_rows].cpu().numpy()
        data = self.dict_data.cpu().numpy()
        off = self.dict_offsets.cpu().numpy()
        binary = isinstance(self.dtype, BinaryType)
        out: List = []
        for i in range(num_rows):
            c = int(codes[i])
            if not valid[i] or c < 0 or c >= self.dict_capacity:
                out.append(None)
                continue
            b = data[off[c]: off[c + 1]].tobytes()
            out.append(b if binary else b.decode("utf-8"))
        return out

    def __repr__(self):
        return (f"DictionaryColumn(cap={self.capacity}, "
                f"dict={self.dict_capacity}x{self.dict_byte_capacity}B)")


def dictionary_from_numpy(codes: np.ndarray, dict_data: np.ndarray,
                          dict_offsets: np.ndarray,
                          validity: Optional[np.ndarray] = None,
                          dtype: DataType = StringType(),
                          capacity: Optional[int] = None,
                          device=None) -> DictionaryColumn:
    """The scan seam: n int32 codes into a dictionary of m entries given
    as Arrow buffers (`dict_offsets` (m + 1,) from 0, `dict_data` the
    bytes), as `dictionary_from_arrow` builds it in the JAX package:
    invalid rows get NULL_CODE, codes pad to `capacity` (default the
    bucket of n) with NULL_CODE, the dictionary pads to the bucket of m
    entries with zero-length slots and its bytes to their own bucket."""
    dev = resolve_device(device)
    codes = np.array(codes, dtype=np.int32)
    n = codes.shape[0]
    valid = np.ones(n, dtype=np.bool_) if validity is None \
        else np.asarray(validity, dtype=np.bool_)
    np.putmask(codes, ~valid, NULL_CODE)
    m = int(np.asarray(dict_offsets).shape[0]) - 1
    view = StringColumn.from_numpy(dict_data, dict_offsets, None, dtype,
                                   bucket_capacity(m), dev)
    cap = capacity or bucket_capacity(n)
    col = DictionaryColumn(
        torch.from_numpy(_pad_np(codes, cap, fill=NULL_CODE)).to(dev),
        view.data, view.offsets,
        torch.from_numpy(_pad_np(valid, cap, fill=False)).to(dev), dtype)
    _note(cols_encoded=1)
    return col


def dictionary_from_arrow(arr, dt: DataType, device=None
                          ) -> Optional[DictionaryColumn]:
    """pyarrow DictionaryArray -> DictionaryColumn on `device`, or None
    when the array is not an encodable shape (values that are not
    strings or bytes, nulls inside the dictionary): the caller decodes it
    then."""
    import pyarrow as pa
    from .column import _string_from_arrow_buffers
    dic = arr.dictionary
    if not (pa.types.is_string(dic.type) or pa.types.is_large_string(dic.type)
            or pa.types.is_binary(dic.type)
            or pa.types.is_large_binary(dic.type)):
        return None
    if dic.null_count:
        return None
    dev = resolve_device(device)
    n = len(arr)
    validity = np.asarray(arr.is_valid(), dtype=np.bool_)
    idx = arr.indices
    if idx.null_count:
        idx = idx.fill_null(0)
    codes = np.asarray(idx).astype(np.int32, copy=True)
    np.putmask(codes, ~validity, NULL_CODE)
    cap = bucket_capacity(n)
    view = _string_from_arrow_buffers(dic, dt, len(dic), dev)
    _note(cols_encoded=1)
    return DictionaryColumn(
        torch.from_numpy(_pad_np(codes, cap, fill=NULL_CODE)).to(dev),
        view.data, view.offsets,
        torch.from_numpy(_pad_np(validity, cap, fill=False)).to(dev), dt)


def dict_take(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """out[i] = table[clip(codes[i], 0, n - 1)] for a per-dictionary table
    (a literal's hit mask, precomputed hashes): the one-lane case of the
    dictionary gather kernel, accounted on the gather engine (a
    code-indexed take is a row gather)."""
    from ..ops import gather as gather_engine
    from ..ops.dict_gather import dict_gather
    rows = int(codes.shape[0])
    gather_engine.record(1, kernel=table.device.type == "cuda",
                         nbytes=rows * table.element_size())
    return dict_gather(table.reshape(-1, 1),
                       codes.to(torch.int32).reshape(-1, 1)).reshape(rows)


def dictionary_hashes(col: DictionaryColumn, seed: int) -> torch.Tensor:
    """murmur3 of every dictionary entry, once (int32 bits,
    (dict_capacity,)): a join's per-row hashes are then one dict_take of
    this table by the code lane instead of a hash per row."""
    from ..ops.hashing import murmur3_string
    _note(dict_hash_tables=1)
    return murmur3_string(col.dict_view(), seed)


# -- byte spans: hashing and the join's key verify without a decode ---------

def row_byte_lanes(col):
    """(lengths, starts, data): each row's byte span in a flat buffer, for
    a StringColumn or a DictionaryColumn (whose rows point through their
    codes into the dictionary's bytes; null rows have length 0)."""
    if isinstance(col, DictionaryColumn):
        dlens = col.dict_offsets[1:] - col.dict_offsets[:-1]
        safe = torch.clamp(col.codes, 0, col.dict_capacity - 1).long()
        lengths = torch.where(col.validity, dlens[safe], 0)
        return lengths, col.dict_offsets[:-1][safe], col.dict_data
    from ..ops.strings import string_lengths
    return string_lengths(col), col.offsets[:-1], col.data


def _bytes_equal_spans(la, sa, da, lb, sb, db) -> torch.Tensor:
    """Byte equality of the spans (sa, la) of `da` and (sb, lb) of `db`,
    row by row, eight bytes a step up to the longest common length (one
    host read: the loop's bound). The port's one byte-span comparator:
    the join's key verify, the hash group-by's key check
    (ops/hashagg._keys_equal_rows) and ops/strings.string_equal."""
    ok = la == lb
    longest = torch.where(ok, la, 0)
    steps = -(-int(longest.max()) // 8) if longest.numel() else 0
    j = torch.arange(8, dtype=torch.int64, device=la.device)
    sa, sb, la = sa.to(torch.int64), sb.to(torch.int64), la.to(torch.int64)
    for step in range(steps):
        off = 8 * step
        pa = torch.clamp(sa[:, None] + off + j, 0, da.shape[0] - 1)
        pb = torch.clamp(sb[:, None] + off + j, 0, db.shape[0] - 1)
        same = (da[pa] == db[pb]) | ((off + j)[None, :] >= la[:, None])
        ok = ok & torch.all(same, dim=1)
    return ok


def bytes_equal_rows(a, b) -> torch.Tensor:
    """Row-wise byte equality of two varlen columns (string or dictionary,
    any mix), validity aside: callers AND it in."""
    return _bytes_equal_spans(*row_byte_lanes(a), *row_byte_lanes(b))


def _span_lanes_at(col, idx):
    """(lengths, starts, data, validity) of col[idx] as spans into col's
    own buffer, nothing gathered byte by byte; indices out of range give
    invalid rows of length 0."""
    lengths, starts, data = row_byte_lanes(col)
    in_range = (idx >= 0) & (idx < lengths.shape[0])
    safe = torch.where(in_range, idx, 0).long()
    valid = col.validity[safe] & in_range
    return torch.where(valid, lengths[safe], 0), starts[safe], data, valid


def bytes_equal_at(a, a_idx, b, b_idx) -> torch.Tensor:
    """The join's varlen key verify: a[a_idx] equals b[b_idx] byte for
    byte and both are valid. It compares spans into the original buffers:
    a gather of the candidates' bytes would need a byte bucket sized for
    the join's fan-out, not the batch's."""
    la, sa, da, va = _span_lanes_at(a, a_idx)
    lb, sb, db, vb = _span_lanes_at(b, b_idx)
    return _bytes_equal_spans(la, sa, da, lb, sb, db) & va & vb


def literal_hits(col: DictionaryColumn, value) -> torch.Tensor:
    """bool (dict_capacity,): which dictionary entries equal the string
    (or bytes) literal — dict_capacity byte compares, once per batch."""
    dev = col.device
    raw = value.encode("utf-8") if isinstance(value, str) else bytes(value)
    m = len(raw)
    dlens = col.dict_offsets[1:] - col.dict_offsets[:-1]
    if m == 0:
        return dlens == 0
    lit = torch.from_numpy(np.frombuffer(raw, np.uint8).copy()).to(dev)
    pos = col.dict_offsets[:-1, None].to(torch.int64) \
        + torch.arange(m, dtype=torch.int64, device=dev)[None, :]
    entry = col.dict_data[pos.clamp(0, col.dict_byte_capacity - 1)]
    return (dlens == m) & torch.all(entry == lit[None, :], dim=1)


def encoded_equal_literal(col: DictionaryColumn, value) -> Column:
    """EqualTo(dictionary column, string literal) in code space: compare
    the literal with every dictionary entry once, then take each row's
    answer from that hit lane by its code. Returns a BOOLEAN Column with
    Spark's three-valued logic (null rows stay null; a null literal gives
    null everywhere)."""
    _note(code_space_predicates=1)
    if value is None:
        zeros = torch.zeros(col.capacity, dtype=torch.bool,
                            device=col.device)
        return Column(zeros, zeros, BOOLEAN)
    row_hit = dict_take(literal_hits(col, value), col.codes)
    return Column(row_hit & col.validity, col.validity, BOOLEAN)


def batch_has_encoded(batch) -> bool:
    return any(isinstance(c, DictionaryColumn) for c in batch.columns)


# -- late materialization: the one decode chokepoint ------------------------

def decoded_byte_bucket(col: DictionaryColumn) -> int:
    """Byte bucket a full decode of `col` needs: one host read of the
    byte total, so the decoded buffer is sized tight."""
    dlens = col.dict_offsets[1:] - col.dict_offsets[:-1]
    safe = torch.clamp(col.codes, 0, col.dict_capacity - 1).long()
    total = torch.sum(torch.where(col.validity, dlens[safe], 0))
    return bucket_capacity(max(int(total), 1))


def materialize_column(col):
    """Decode a DictionaryColumn into a full-width StringColumn: a row
    gather of the dictionary by the code lane (NULL_CODE rows come out
    invalid by the gather's -1 masking). Other columns pass through."""
    if not isinstance(col, DictionaryColumn):
        return col
    byte_cap = decoded_byte_bucket(col)
    from ..ops.basic import gather_column
    out = gather_column(col.dict_view(), col.codes, out_valid=col.validity,
                        out_byte_capacity=byte_cap)
    _note(materializations=1, materialized_bytes=byte_cap)
    return out


def materialize_batch(batch):
    """Decode every encoded column of a batch (identity when none is): the
    JAX package's "boundary", "output" and "concat" seams."""
    if not batch_has_encoded(batch):
        return batch
    return batch.with_columns([materialize_column(c)
                               for c in batch.columns], batch.schema)
