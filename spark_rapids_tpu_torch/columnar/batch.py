"""ColumnarBatch — the counterpart of spark_rapids_tpu/columnar/batch.py.

`num_rows` is a device int32 scalar, as on the JAX hot path: operators
that change the row count (filters, aggregates) keep it on the card, and
the host reads it only when results are materialized.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..types import Schema
from .column import Column, resolve_device


class ColumnarBatch:
    __slots__ = ("columns", "num_rows", "schema", "_host_rows")

    def __init__(self, columns: Sequence[Column], num_rows, schema: Schema,
                 host_rows: Optional[int] = None):
        self.columns = tuple(columns)
        if isinstance(num_rows, (int, np.integer)):
            host_rows = int(num_rows)
            if not self.columns:
                raise ValueError("a host row count needs a column to "
                                 "take the device from")
            num_rows = torch.tensor(host_rows, dtype=torch.int32,
                                    device=self.columns[0].device)
        self.num_rows = num_rows
        self.schema = schema
        self._host_rows = host_rows

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 0

    @property
    def device(self) -> torch.device:
        return self.num_rows.device

    @property
    def num_rows_host(self) -> int:
        """Logical row count as a host int; syncs if produced on device."""
        if self._host_rows is None:
            self._host_rows = int(self.num_rows)
        return self._host_rows

    def column(self, name_or_idx) -> Column:
        if isinstance(name_or_idx, str):
            return self.columns[self.schema.index_of(name_or_idx)]
        return self.columns[name_or_idx]

    @staticmethod
    def from_numpy_columns(columns: Sequence[Tuple[np.ndarray, np.ndarray]],
                           schema: Schema, num_rows: int,
                           device=None) -> "ColumnarBatch":
        """Build a batch from (data, validity) numpy pairs at capacity —
        the state-carry function: the tests hand the JAX batch's columns
        through it so both packages see identical bytes, padding and
        the data under null slots included."""
        dev = resolve_device(device)
        cols = []
        for (data, valid), f in zip(columns, schema.fields):
            data = np.array(data, dtype=f.data_type.np_dtype)
            valid = np.array(valid, dtype=np.bool_)
            cols.append(Column(torch.from_numpy(data).to(dev),
                               torch.from_numpy(valid).to(dev), f.data_type))
        return ColumnarBatch(cols, int(num_rows), schema)

    def to_pydict(self) -> dict:
        n = self.num_rows_host
        return {f.name: c.to_pylist(n)
                for f, c in zip(self.schema.fields, self.columns)}

    def to_pylist(self) -> List[tuple]:
        d = self.to_pydict()
        names = self.schema.names
        return [tuple(d[name][i] for name in names)
                for i in range(self.num_rows_host)]

    def with_columns(self, columns: Sequence[Column],
                     schema: Schema) -> "ColumnarBatch":
        return ColumnarBatch(columns, self.num_rows, schema, self._host_rows)

    def __repr__(self):
        rows = self._host_rows if self._host_rows is not None else "<device>"
        return (f"ColumnarBatch(rows={rows}, cap={self.capacity}, "
                f"schema={self.schema.names})")


def empty_batch(schema: Schema, capacity: int = 128,
                device=None) -> ColumnarBatch:
    dev = resolve_device(device)
    cols = [Column(torch.zeros(capacity, dtype=f.data_type.torch_dtype,
                               device=dev),
                   torch.zeros(capacity, dtype=torch.bool, device=dev),
                   f.data_type)
            for f in schema.fields]
    return ColumnarBatch(cols, torch.zeros((), dtype=torch.int32, device=dev),
                         schema, 0)
