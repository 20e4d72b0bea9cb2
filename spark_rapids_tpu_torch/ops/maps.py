"""Map-column kernels: build, lookup, keys/values views — the counterpart
of spark_rapids_tpu/ops/maps.py (reference GpuCreateMap / GpuGetMapValue
/ GpuMapKeys / GpuMapValues over cuDF LIST<STRUCT>,
collectionOperations.scala).

Maps are (offsets, keys, values) triplets (columnar/column.MapColumn); a
lookup is a flat compare over the keys child. A row's entries are
contiguous, so where the JAX package reduces the matches by each entry's
row (`segment_min`, `segment_max`), the port counts them with one cumsum
over the entries, differenced at the row bounds, and finds a row's first
match by a search of that cumsum: no scatter, no host read.

Duplicate keys stay in entry order and every consumer takes the FIRST
(`map_get`, `MapColumn.to_pylist`), as in the JAX package: Spark's
default dedup policy (EXCEPTION) raises instead, and both packages
diverge from it alike (ROADMAP C.5).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..columnar.column import (ArrayColumn, Column, MapColumn, StringColumn,
                               bucket_capacity)
from ..types import BOOLEAN, ArrayType, MapType
from .strings import (_BIG, _match_at, _rebuild_offsets, first_in_spans,
                      span_sums, string_lengths)


def _arange(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=dev)


def _entry_in_use(m: MapColumn) -> torch.Tensor:
    return _arange(m.entry_capacity, m.device) < m.offsets[m.capacity]


def map_keys(m: MapColumn) -> ArrayColumn:
    return ArrayColumn(m.keys, m.offsets, m.validity,
                       ArrayType(m.dtype.key_type, False))


def map_values(m: MapColumn) -> ArrayColumn:
    return ArrayColumn(m.values, m.offsets, m.validity,
                       ArrayType(m.dtype.value_type,
                                 m.dtype.value_contains_null))


def _entry_rows(m: MapColumn) -> torch.Tensor:
    """The map row of each entry (int64): the last row whose start is <=
    it, as the JAX package's searchsorted gives it."""
    from .collection import row_of_element
    return row_of_element(m.offsets, _arange(m.entry_capacity, m.device),
                          m.capacity)


def _string_key_match(keys: StringColumn, erow: torch.Tensor,
                      tgt: StringColumn) -> torch.Tensor:
    """Per entry: its key's bytes equal its row's target key's, compared
    byte for byte (each key byte against the same offset of the row's
    target), the mismatches counted per key by one cumsum."""
    from .strings import _col_bytes
    _, bent, boff, b_use = _col_bytes(keys)
    brow = erow[bent]
    tpos = torch.clamp(tgt.offsets[brow] + boff, 0,
                       tgt.byte_capacity - 1).long()
    bad = b_use & (keys.data != tgt.data[tpos])
    _, _, n_bad = span_sums(bad, keys.offsets)
    return (string_lengths(keys) == string_lengths(tgt)[erow]) \
        & (n_bad == 0) & tgt.validity[erow]


def _key_match(m: MapColumn, key) -> torch.Tensor:
    """(entry_capacity,) bool: the entry's key equals the lookup key: a
    host literal, or a per-row Column of the key type."""
    keys = m.keys
    if isinstance(key, Column):
        from ..columnar.encoded import materialize_column
        key = materialize_column(key)
    if isinstance(keys, StringColumn):
        if isinstance(key, Column):
            match = _string_key_match(keys, _entry_rows(m), key)
        else:
            kb = key.encode("utf-8") if isinstance(key, str) \
                else bytes(key)
            match = (string_lengths(keys) == len(kb)) \
                & _match_at(keys, kb, keys.offsets[:-1])
    elif isinstance(key, Column):
        erow = _entry_rows(m)
        match = (keys.data == key.data[erow]) & key.validity[erow]
    else:
        match = keys.data == torch.tensor(key, dtype=keys.data.dtype,
                                          device=keys.device)
    return match & keys.validity & _entry_in_use(m)


def _null_values(m: MapColumn) -> Column:
    vals = m.values
    invalid = torch.zeros(m.capacity, dtype=torch.bool, device=m.device)
    if isinstance(vals, StringColumn):
        from .strings import gather_string
        return gather_string(vals, torch.zeros(m.capacity, dtype=torch.int32,
                                               device=m.device), invalid)
    return Column(torch.zeros(m.capacity, dtype=vals.data.dtype,
                              device=m.device), invalid, vals.dtype)


def map_get(m: MapColumn, key) -> Column:
    """element_at(map, key) / map[key]: the value of the FIRST entry whose
    key equals `key`; NULL when absent or the key is NULL (non-ANSI)."""
    if key is None:
        return _null_values(m)
    first = first_in_spans(_key_match(m, key), m.offsets)
    has = (first < _BIG) & m.validity
    if isinstance(key, Column):
        has = has & key.validity
    idx = torch.clamp(first, 0, m.entry_capacity - 1)
    vals = m.values
    valid = has & vals.validity[idx.long()]
    if isinstance(vals, StringColumn):
        from .strings import gather_string
        return gather_string(vals, idx, valid)
    data = torch.where(valid, vals.data[idx.long()],
                       torch.zeros((), dtype=vals.data.dtype,
                                   device=m.device))
    return Column(data, valid, vals.dtype)


def map_contains_key(m: MapColumn, key) -> Column:
    if key is None:  # a NULL key literal: NULL rows
        z = torch.zeros(m.capacity, dtype=torch.bool, device=m.device)
        return Column(z, z, BOOLEAN)
    _, _, count = span_sums(_key_match(m, key), m.offsets)
    valid = m.validity
    if isinstance(key, Column):
        valid = valid & key.validity
    return Column((count > 0) & valid, valid, BOOLEAN)


def interleave_columns(cols: Sequence[Column]) -> Column:
    """Row-major interleave of k same-type columns into one column of
    k * cap rows (padded to its bucket): output row r * k + j is
    cols[j][r]. The CreateMap entry builder."""
    from ..columnar.encoded import materialize_column
    cols = [materialize_column(c) for c in cols]
    k = len(cols)
    cap = cols[0].capacity
    dev = cols[0].device
    out_cap = bucket_capacity(cap * k)
    pad = out_cap - cap * k
    valid = torch.stack([c.validity for c in cols], 1).reshape(-1)
    valid = torch.cat([valid, valid.new_zeros(pad)])
    if isinstance(cols[0], StringColumn):
        lens = torch.stack([string_lengths(c) for c in cols], 1).reshape(-1)
        new_off = _rebuild_offsets(torch.cat([lens, lens.new_zeros(pad)]))
        byte_cap = bucket_capacity(max(sum(c.byte_capacity for c in cols),
                                       1))
        from .strings import _row_of_byte
        bpos, orow, intra = _row_of_byte(new_off, byte_cap, out_cap)
        src_row = torch.clamp(orow // k, 0, cap - 1).long()
        src_col = orow % k
        byte = torch.zeros(byte_cap, dtype=torch.uint8, device=dev)
        for j, c in enumerate(cols):
            sp = torch.clamp(c.offsets[src_row] + intra, 0,
                             c.byte_capacity - 1).long()
            byte = torch.where(src_col == j, c.data[sp], byte)
        data = torch.where(bpos < new_off[-1], byte, 0).to(torch.uint8)
        return StringColumn(data, new_off, valid, cols[0].dtype)
    data = torch.stack([c.data for c in cols], 1).reshape(-1)
    data = torch.cat([data, data.new_zeros(pad)])
    return Column(data, valid, cols[0].dtype)


def create_map(key_cols: Sequence[Column], val_cols: Sequence[Column],
               num_rows, dtype: MapType) -> MapColumn:
    """map(k1, v1, k2, v2, ...): k pairs a row. Every row slot owns its k
    interleaved entries (padded rows too: their offsets stay aligned with
    the row-major layout, and they are invalid)."""
    from .basic import active_mask
    k = len(key_cols)
    cap = key_cols[0].capacity
    dev = key_cols[0].device
    keys = interleave_columns(key_cols)
    vals = interleave_columns(val_cols)
    off = _arange(cap + 1, dev) * k
    return MapColumn(keys, vals, off, active_mask(num_rows, cap, dev),
                     dtype)
