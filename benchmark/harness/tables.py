"""The port's batches of the generated tables, in a configuration's types,
cut as a Spark RAPIDS scan hands them over.

Money (a column of the kinds "money", "percent" and "quantity":
`l_extendedprice`, `l_discount`, `l_tax`, `l_quantity`) is DOUBLE (the
value itself, cents / 100) or DECIMAL(p, s) (the unscaled integer), as the
configuration's `money` says; a date is DATE; a string column named
in the configuration's `encoded` list is a DictionaryColumn (codes into a
dictionary built once per column), any other a StringColumn. Every column
is built from the generator's device tensors: nothing but the
dictionaries' few bytes crosses from the host.

Each table is cut into the fewest batches of equal row counts whose every
leaf, at its padded capacity, holds at most the session's
spark.rapids.sql.batchSizeBytes together (the port's default, 1 GiB,
unless the configuration's `confs` set it), so the scan's coalesce passes
each batch on as it is.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import torch

from . import tpch

#: the decimal digits of each money kind's exact integer form
MONEY_KINDS = {"money": 2, "percent": 2, "quantity": 0}


def parse_money(spec: str) -> Tuple[str, int, int]:
    """("DOUBLE", 0, 0) or ("DECIMAL", precision, scale)."""
    if spec == "DOUBLE":
        return "DOUBLE", 0, 0
    m = re.fullmatch(r"DECIMAL\((\d+),\s*(\d+)\)", spec)
    if not m:
        raise ValueError(f"money type {spec!r}: DOUBLE or DECIMAL(p,s)")
    return "DECIMAL", int(m.group(1)), int(m.group(2))


def column_type(t, kind: str, money: str):
    """The port's data type of a TPC-H column of `kind`."""
    if kind in MONEY_KINDS:
        base, p, s = parse_money(money)
        return t.DOUBLE if base == "DOUBLE" else t.DecimalType(p, s)
    return {"int": t.LONG, "int32": t.INT, "date": t.DATE,
            "string": t.STRING}[kind]


def money_values(kind: str, raw: torch.Tensor, money: str) -> torch.Tensor:
    """A money column's lanes from its exact integer form (cents, percent,
    units): the DOUBLE values, or the unscaled DECIMAL integers."""
    base, _, scale = parse_money(money)
    have = MONEY_KINDS[kind]
    if base == "DOUBLE":
        return raw.to(torch.float64) / (10 ** have) if have \
            else raw.to(torch.float64)
    if scale < have:
        raise ValueError(f"a {kind} column needs scale >= {have}")
    return raw.to(torch.int64) * (10 ** (scale - have))


def _padded(values: torch.Tensor, cap: int, fill=0) -> torch.Tensor:
    out = torch.full((cap,), fill, dtype=values.dtype, device=values.device)
    out[:values.shape[0]] = values
    return out


def _validity(n: int, cap: int, dev) -> torch.Tensor:
    v = torch.zeros(cap, dtype=torch.bool, device=dev)
    v[:n] = True
    return v


def row_bytes(name: str, kind: str, encoded, vocab: tpch.Vocab) -> int:
    """Bytes a row of the column holds at capacity (string bytes at the
    longest value's length: an upper bound)."""
    if kind == "string":
        return 5 if name in encoded else 5 + vocab.width
    if kind in MONEY_KINDS:
        return 9
    return {"int": 9, "int32": 5, "date": 5}[kind]


def batch_rows(n: int, per_row: int, batch_bytes: int) -> List[int]:
    """Row counts of the fewest equal batches whose padded capacity (the
    power-of-two bucket of its rows) times `per_row` is at most
    `batch_bytes`."""
    cap = 1 << max(int(batch_bytes // per_row).bit_length() - 1, 0)
    parts = max(math.ceil(n / cap), 1)
    size = math.ceil(n / parts)
    return [min(size, n - k * size) for k in range(parts)]


class TableBuilder:
    """Builds port batches of one configuration (`money`, `encoded`,
    `batch_bytes`) from a `tpch.Generator`."""

    def __init__(self, gen: tpch.Generator, money: str, encoded,
                 batch_bytes: int):
        from spark_rapids_tpu_torch import types as t
        self.gen, self.money, self.t = gen, money, t
        self.encoded = set(encoded)
        self.batch_bytes = batch_bytes
        self._dicts: Dict[str, object] = {}

    def _dictionary(self, name: str):
        """(dict_data, dict_offsets) of a column's vocabulary on the
        device, built once."""
        if name not in self._dicts:
            from spark_rapids_tpu_torch.columnar.column import (
                StringColumn, bucket_capacity, string_buffers)
            vocab = self.gen.vocab(name)
            values = [vocab[k] for k in range(len(vocab))]
            view = StringColumn.from_numpy(
                *string_buffers(values), None, self.t.STRING,
                bucket_capacity(len(values)), self.gen.device)
            self._dicts[name] = (view.data, view.offsets)
        return self._dicts[name]

    def column(self, name: str, raw: torch.Tensor):
        from spark_rapids_tpu_torch.columnar.column import (
            Column, StringColumn, bucket_capacity)
        from spark_rapids_tpu_torch.columnar.encoded import (
            NULL_CODE, DictionaryColumn)
        n, dev = raw.shape[0], raw.device
        cap = bucket_capacity(n)
        valid = _validity(n, cap, dev)
        kind = self.gen.kind(name)
        dt = column_type(self.t, kind, self.money)
        if kind != "string":
            if kind in MONEY_KINDS:
                raw = money_values(kind, raw, self.money)
            return Column(_padded(raw.to(dt.torch_dtype), cap), valid, dt)
        if name in self.encoded:
            data, offsets = self._dictionary(name)
            return DictionaryColumn(_padded(raw.to(torch.int32), cap,
                                            NULL_CODE),
                                    data, offsets, valid, dt)
        mat, lens = self.gen.vocab(name).byte_matrix(raw)
        keep = torch.arange(mat.shape[1], device=dev)[None, :] \
            < lens[:, None]
        data = mat[keep]
        offsets = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
        offsets[1:n + 1] = torch.cumsum(lens, 0).to(torch.int32)
        offsets[n + 1:] = offsets[n]
        buf = torch.zeros(bucket_capacity(max(int(data.shape[0]), 1)),
                          dtype=torch.uint8, device=dev)
        buf[:data.shape[0]] = data
        return StringColumn(buf, offsets, valid, dt)

    def schema(self, columns):
        t = self.t
        return t.Schema(tuple(
            t.StructField(c, column_type(t, self.gen.kind(c), self.money))
            for c in columns))

    def batches(self, table: str, columns: List[str]):
        """The table's batches (list of ColumnarBatch) and its schema."""
        from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
        n = self.gen.num_rows(table)
        per_row = sum(row_bytes(c, self.gen.kind(c), self.encoded,
                                self.gen.vocab(c) if self.gen.kind(c)
                                == "string" else None) for c in columns)
        schema = self.schema(columns)
        raws = {c: self.gen.column(c) for c in columns}
        out, start = [], 0
        for rows in batch_rows(n, per_row, self.batch_bytes):
            cols = [self.column(c, raws[c][start:start + rows])
                    for c in columns]
            out.append(ColumnarBatch(cols, rows, schema))
            start += rows
        return out, schema
