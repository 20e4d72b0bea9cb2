"""ColumnarBatch — the counterpart of spark_rapids_tpu/columnar/batch.py.

`num_rows` is a device int32 scalar, as on the JAX hot path: operators
that change the row count (filters, aggregates) keep it on the card, and
the host reads it only when results are materialized.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..types import DecimalType, Schema
from .column import Column, bucket_capacity, resolve_device


class ColumnarBatch:
    __slots__ = ("columns", "num_rows", "schema", "_host_rows", "_upload")

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
        #: (event, device buffer) of an upload on a side stream that the
        #: consumer has not waited on yet (columnar/upload.await_upload)
        self._upload = None

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
    def from_pydict(data: dict, schema: Schema,
                    capacity: Optional[int] = None,
                    device=None) -> "ColumnarBatch":
        """Python lists by column name (None for null) -> a batch on
        `device` (default: the card) at one capacity bucket."""
        lengths = {len(v) for v in data.values()} or {0}
        if len(lengths) != 1:
            raise ValueError("ragged input columns")
        n = lengths.pop()
        cap = capacity or bucket_capacity(n)
        from .column import build_column
        dev = resolve_device(device)
        cols = [build_column(data[f.name], f.data_type, cap, dev)
                for f in schema.fields]
        return ColumnarBatch(cols, n, schema)

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

    @staticmethod
    def from_arrow(table, device=None, encoded=None) -> "ColumnarBatch":
        """pyarrow Table/RecordBatch -> batch on `device` (default: the
        card), one capacity bucket. The scan's ingest seam: the columns
        are built on the host (`arrow_host_columns`) and cross in one
        packed upload (columnar/upload.py)."""
        from .upload import to_device_batch
        cols, schema = arrow_host_columns(table, encoded)
        return to_device_batch(cols, table.num_rows, schema, device)

    def to_arrow(self):
        """The batch as a pyarrow Table, fetched in one packed copy."""
        import pyarrow as pa
        from .column import column_to_arrow
        from .transfer import fetch_batch_host
        cols, n = fetch_batch_host(self)
        self._host_rows = n
        return pa.table([column_to_arrow(c, n) for c in cols],
                        names=self.schema.names)

    def to_pydict(self) -> dict:
        """The batch's rows by column, fetched in one packed copy
        (columnar/transfer.py); dictionary columns decode on the host."""
        from .transfer import fetch_batch_host
        cols, n = fetch_batch_host(self)
        self._host_rows = n
        return {f.name: c.to_pylist(n)
                for f, c in zip(self.schema.fields, cols)}

    def to_pylist(self) -> List[tuple]:
        d = self.to_pydict()
        names = self.schema.names
        return [tuple(d[name][i] for name in names)
                for i in range(self.num_rows_host)]

    def flatten(self) -> Tuple[List[torch.Tensor], tuple]:
        """The batch as tensor leaves and a description to rebuild it
        from them (`unflatten`): each column's leaves in the JAX pytree's
        order, then the int32 row count, as the JAX package flattens a
        batch for its spill catalog. The description also keeps the host
        row count when it is known, so a batch back from a spill needs no
        host read for it."""
        leaves: List[torch.Tensor] = []
        kinds = []
        for c in self.columns:
            own = c.leaves()
            leaves.extend(own)
            kinds.append((type(c), c.dtype, len(own)))
        leaves.append(self.num_rows)
        return leaves, (self.schema, tuple(kinds), self._host_rows)

    @staticmethod
    def unflatten(treedef: tuple, leaves: Sequence[torch.Tensor]
                  ) -> "ColumnarBatch":
        schema, kinds, host_rows = treedef
        cols, pos = [], 0
        for cls, dtype, n in kinds:
            cols.append(cls.from_leaves(dtype, leaves[pos: pos + n]))
            pos += n
        return ColumnarBatch(cols, leaves[pos], schema, host_rows)

    @property
    def nbytes(self) -> int:
        """Bytes of every leaf at its padded size: the JAX catalog's
        `_leaf_nbytes` of the same batch (bool validity is one byte a
        row, the row count a 4-byte scalar)."""
        return sum(t.numel() * t.element_size() for t in self.flatten()[0])

    def with_columns(self, columns: Sequence[Column],
                     schema: Schema) -> "ColumnarBatch":
        return ColumnarBatch(columns, self.num_rows, schema, self._host_rows)

    def __repr__(self):
        rows = self._host_rows if self._host_rows is not None else "<device>"
        return (f"ColumnarBatch(rows={rows}, cap={self.capacity}, "
                f"schema={self.schema.names})")


def _empty_column(dtype, capacity: int, dev) -> Column:
    from ..types import ArrayType, MapType, StructType
    if isinstance(dtype, (ArrayType, StructType, MapType)):
        # as the JAX package's build_column([], ...): a list's or map's
        # children at their smallest bucket, a struct's at its capacity
        from .column import build_column
        return build_column([], dtype, capacity, dev)
    valid = torch.zeros(capacity, dtype=torch.bool, device=dev)
    if isinstance(dtype, DecimalType) and dtype.is_decimal128:
        from .column import Decimal128Column
        zero = torch.zeros(capacity, dtype=torch.int64, device=dev)
        return Decimal128Column.from_limbs(zero, zero.clone(), valid, dtype)
    if dtype.torch_dtype is None:
        # a string column: NULL_CODE rows into an empty dictionary (one
        # padded bucket of zero-length entries)
        from .encoded import NULL_CODE, DictionaryColumn
        return DictionaryColumn(
            torch.full((capacity,), NULL_CODE, dtype=torch.int32,
                       device=dev),
            torch.zeros(bucket_capacity(1), dtype=torch.uint8, device=dev),
            torch.zeros(bucket_capacity(1) + 1, dtype=torch.int32,
                        device=dev), valid, dtype)
    return Column(torch.zeros(capacity, dtype=dtype.torch_dtype, device=dev),
                  valid, dtype)


def empty_batch(schema: Schema, capacity: int = 128,
                device=None) -> ColumnarBatch:
    dev = resolve_device(device)
    cols = [_empty_column(f.data_type, capacity, dev) for f in schema.fields]
    return ColumnarBatch(cols, torch.zeros((), dtype=torch.int32, device=dev),
                         schema, 0)


def arrow_host_columns(table, encoded=None) -> Tuple[List[Column], Schema]:
    """A pyarrow Table/RecordBatch's columns built on the host at one
    capacity bucket (dictionary arrays as DictionaryColumns when
    `encoded`, default the scan.encoded conf), and their schema."""
    from ..types import StructField
    from .column import column_from_arrow
    cap = bucket_capacity(table.num_rows)
    fields, cols = [], []
    for name in table.column_names:
        col = column_from_arrow(table.column(name), device="cpu",
                                encoded=encoded)
        if col.capacity < cap:
            col = col.with_capacity(cap)
        cols.append(col)
        fields.append(StructField(name, col.dtype))
    return cols, Schema(tuple(fields))
