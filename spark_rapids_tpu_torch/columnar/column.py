"""Device columns — the counterpart of spark_rapids_tpu/columnar/column.py:
fixed-width columns, string columns, decimal128 columns
(`Decimal128Column`, two int64 limb children), list columns
(`ArrayColumn`, int32 offsets into a child column), struct columns
(`StructColumn`, a child a field) and map columns (`MapColumn`, int32
offsets into parallel keys and values children).

The JAX package's Decimal128Column subclasses its StructColumn; here the
two are siblings under Column: a decimal128 column is a value, not a
struct of fields, and every path that moves one takes its two limbs as
lanes of the packed row gather. So `isinstance(c, StructColumn)` never
holds for a decimal, and each seam has a branch for each.

Every column is padded to a power-of-two capacity bucket, exactly as in
the JAX package, and the logical row count rides beside the data as a
device scalar (columnar/batch.py). Static capacities keep the hot path
free of host synchronisation and make CUDA-graph capture possible in a
later slice. Validity is a dense bool tensor; rows at index >= num_rows
are always invalid.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..types import (ArrayType, BinaryType, DataType, DecimalType, MapType,
                     NullType, StringType, StructType)

#: minimum capacity bucket (the JAX package's TPU lane width, kept so the
#: two packages pad identically)
MIN_BUCKET = 128


def resolve_device(device=None) -> torch.device:
    """The port's device policy: CUDA unless the caller names a device.

    There is no silent CPU fallback: without a card the caller has to
    ask for the CPU explicitly (device="cpu"), as the tests do."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU")
    return torch.device("cuda")


def bucket_capacity(n: int) -> int:
    """Round row counts up to a power-of-two bucket (>= MIN_BUCKET)."""
    if n <= MIN_BUCKET:
        return MIN_BUCKET
    return 1 << (int(n - 1).bit_length())


def _logical_to_physical(dtype: DataType):
    """Value converter for host ingestion: the logical Python values
    Spark's rows carry (datetime.date, datetime.datetime, decimal.Decimal)
    beside the raw physical encodings (int days, int microseconds,
    unscaled ints)."""
    import datetime as _dt
    import decimal as _dec

    from ..types import DateType, TimestampNTZType, TimestampType
    if isinstance(dtype, DateType):
        epoch = _dt.date(1970, 1, 1)
        return lambda v: (v - epoch).days if isinstance(v, _dt.date) \
            and not isinstance(v, _dt.datetime) else v
    if isinstance(dtype, (TimestampType, TimestampNTZType)):
        epoch = _dt.datetime(1970, 1, 1)
        one_us = _dt.timedelta(microseconds=1)
        ntz = isinstance(dtype, TimestampNTZType)

        def conv_ts(v):
            if not isinstance(v, _dt.datetime):
                return v
            if v.tzinfo is not None:
                # NTZ keeps the wall clock; TIMESTAMP converts the instant
                v = v.replace(tzinfo=None) if ntz \
                    else v.astimezone(_dt.timezone.utc).replace(tzinfo=None)
            return (v - epoch) // one_us
        return conv_ts
    if isinstance(dtype, DecimalType):
        scale = dtype.scale
        ctx = _dec.Context(prec=_dec.MAX_PREC)   # no rounding to 28 digits
        return lambda v: int(v.scaleb(scale, ctx).to_integral_value(
            rounding=_dec.ROUND_HALF_UP, context=ctx)) \
            if isinstance(v, _dec.Decimal) else v
    return lambda v: v


def _pad_np(arr: np.ndarray, capacity: int, fill=0) -> np.ndarray:
    if arr.shape[0] == capacity:
        return arr
    out = np.full((capacity,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _offsets_np(values: Sequence, n: int, cap: int) -> np.ndarray:
    """int32 (cap + 1,) offsets of the rows' entry counts (None: 0)."""
    lengths = np.array([0 if v is None else len(v) for v in values],
                       np.int64)
    off = np.zeros(cap + 1, np.int32)
    off[1: n + 1] = np.cumsum(lengths)
    off[n + 1:] = off[n] if n else 0
    return off


class Column:
    """Fixed-width device column: data (capacity,) + validity (capacity,)."""

    __slots__ = ("data", "validity", "dtype")

    def __init__(self, data: torch.Tensor, validity: torch.Tensor,
                 dtype: DataType):
        self.data = data
        self.validity = validity
        self.dtype = dtype

    @staticmethod
    def from_numpy(values: np.ndarray, dtype: DataType,
                   capacity: Optional[int] = None, device=None,
                   validity: Optional[np.ndarray] = None) -> "Column":
        dev = resolve_device(device)
        n = values.shape[0]
        cap = capacity or bucket_capacity(n)
        if validity is None:
            validity = np.ones(n, dtype=np.bool_)
        data = _pad_np(np.ascontiguousarray(values, dtype=dtype.np_dtype), cap)
        valid = _pad_np(validity.astype(np.bool_), cap, fill=False)
        return Column(torch.from_numpy(data).to(dev),
                      torch.from_numpy(valid).to(dev), dtype)

    @staticmethod
    def from_pylist(values: Sequence, dtype: DataType,
                    capacity: Optional[int] = None,
                    device=None) -> "Column":
        """Python values (None for null) -> column on `device`."""
        validity = np.array([v is not None for v in values], dtype=np.bool_)
        fill = np.zeros((), dtype=dtype.np_dtype).item()
        conv = _logical_to_physical(dtype)
        dense = np.array([fill if v is None else conv(v) for v in values],
                         dtype=dtype.np_dtype)
        return Column.from_numpy(dense, dtype, capacity, device, validity)

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def leaves(self) -> tuple:
        """The column's tensors, in the JAX package's pytree order (the
        spill catalog moves them between tiers)."""
        return (self.data, self.validity)

    @classmethod
    def from_leaves(cls, dtype: DataType, leaves) -> "Column":
        return cls(*leaves, dtype)

    def with_capacity(self, capacity: int) -> "Column":
        """Grow (never shrink) the padding bucket."""
        cap = self.capacity
        if capacity == cap:
            return self
        if capacity < cap:
            raise ValueError(f"cannot shrink capacity {cap} to {capacity}")
        extra = capacity - cap
        return Column(
            torch.cat([self.data, self.data.new_zeros(extra)]),
            torch.cat([self.validity, self.validity.new_zeros(extra)]),
            self.dtype)

    def to_pylist(self, num_rows: int) -> List:
        data = self.data[:num_rows].cpu().numpy().tolist()
        valid = self.validity[:num_rows].cpu().numpy().tolist()
        return [v if ok else None for v, ok in zip(data, valid)]

    def __repr__(self):
        return f"Column({self.dtype!r}, cap={self.capacity})"


class StringColumn(Column):
    """Varlen column: uint8 byte buffer + int32 offsets (Arrow layout).

    offsets has shape (capacity + 1,) and repeats its last value over the
    padding rows, so their lengths are zero; the byte buffer is padded to
    its own bucket. A StringColumn is the dictionary of a
    DictionaryColumn (columnar/encoded.py) or a decoded one
    (`materialize_column`); ops/strings.py gathers and concatenates it."""

    __slots__ = ("offsets",)

    def __init__(self, data: torch.Tensor, offsets: torch.Tensor,
                 validity: torch.Tensor, dtype: DataType = StringType()):
        super().__init__(data, validity, dtype)
        self.offsets = offsets

    @staticmethod
    def from_numpy(data: np.ndarray, offsets: np.ndarray,
                   validity: Optional[np.ndarray] = None,
                   dtype: DataType = StringType(),
                   capacity: Optional[int] = None,
                   device=None) -> "StringColumn":
        """From Arrow-layout numpy buffers of n rows: `offsets` (n + 1,)
        int32 from 0, `data` the bytes. Pads rows to `capacity` (default
        the bucket of n) and bytes to their own bucket."""
        dev = resolve_device(device)
        offsets = np.asarray(offsets, dtype=np.int32)
        n = offsets.shape[0] - 1
        cap = capacity or bucket_capacity(n)
        total = int(offsets[n]) if n >= 0 else 0
        off = np.full(cap + 1, total, dtype=np.int32)
        off[: n + 1] = offsets
        buf = np.zeros(bucket_capacity(max(total, 1)), dtype=np.uint8)
        buf[:total] = np.asarray(data, dtype=np.uint8)[:total]
        if validity is None:
            validity = np.ones(n, dtype=np.bool_)
        valid = _pad_np(np.asarray(validity, dtype=np.bool_), cap,
                        fill=False)
        return StringColumn(torch.from_numpy(buf).to(dev),
                            torch.from_numpy(off).to(dev),
                            torch.from_numpy(valid).to(dev), dtype)

    @staticmethod
    def from_pylist(values: Sequence[Optional[str]],
                    capacity: Optional[int] = None,
                    dtype: DataType = StringType(),
                    device=None) -> "StringColumn":
        data, offsets = string_buffers(values)
        return StringColumn.from_numpy(
            data, offsets, np.array([v is not None for v in values],
                                    dtype=np.bool_),
            dtype, capacity, device)

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    @property
    def byte_capacity(self) -> int:
        return int(self.data.shape[0])

    def leaves(self) -> tuple:
        return (self.data, self.offsets, self.validity)

    def with_capacity(self, capacity: int) -> "StringColumn":
        """Grow (never shrink) the row bucket with zero-length rows."""
        cap = self.capacity
        if capacity == cap:
            return self
        if capacity < cap:
            raise ValueError(f"cannot shrink capacity {cap} to {capacity}")
        extra = capacity - cap
        offsets = torch.cat([self.offsets, self.offsets[-1:].expand(extra)])
        validity = torch.cat([self.validity,
                              self.validity.new_zeros(extra)])
        return StringColumn(self.data, offsets, validity, self.dtype)

    def to_pylist(self, num_rows: int) -> List:
        raw = self.data.cpu().numpy().tobytes()
        off = self.offsets[: num_rows + 1].cpu().numpy().tolist()
        valid = self.validity[:num_rows].cpu().numpy().tolist()
        binary = isinstance(self.dtype, BinaryType)
        out: List = []
        for i, ok in enumerate(valid):
            if not ok:
                out.append(None)
                continue
            b = raw[off[i]: off[i + 1]]
            out.append(b if binary else b.decode("utf-8"))
        return out

    def __repr__(self):
        return (f"StringColumn(cap={self.capacity}, "
                f"bytes={self.byte_capacity})")


class Decimal128Column(Column):
    """DECIMAL(p>18): the 128-bit unscaled value as two int64 limb
    children, `hi` with the sign and `lo` read as unsigned (ops/
    decimal128.py), sharing the column's validity. It has no `data`
    tensor: every path that moves rows takes the limbs (the gather
    engine packs them as two more 8-byte lanes of its row gather).
    `to_pylist` gives the unscaled Python ints, as the JAX package's
    does; `to_decimal_list` scales them."""

    __slots__ = ("children",)

    def __init__(self, children, validity: torch.Tensor,
                 dtype: DecimalType):
        if len(children) != 2:
            raise ValueError("a decimal128 column has two limbs")
        super().__init__(None, validity, dtype)
        self.children = tuple(children)

    @property
    def hi(self) -> Column:
        return self.children[0]

    @property
    def lo(self) -> Column:
        return self.children[1]

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    @property
    def device(self) -> torch.device:
        return self.validity.device

    @staticmethod
    def from_limbs(hi: torch.Tensor, lo: torch.Tensor,
                   validity: torch.Tensor,
                   dtype: DecimalType) -> "Decimal128Column":
        from ..types import LONG
        return Decimal128Column((Column(hi, validity, LONG),
                                 Column(lo, validity, LONG)), validity, dtype)

    @staticmethod
    def from_pylist(values: Sequence, dtype: DecimalType,
                    capacity: Optional[int] = None,
                    device=None) -> "Decimal128Column":
        """Unscaled ints or decimal.Decimal values (None for null)."""
        dev = resolve_device(device)
        n = len(values)
        cap = capacity or bucket_capacity(n)
        conv = _logical_to_physical(dtype)
        his = np.zeros(cap, np.int64)
        los = np.zeros(cap, np.int64)
        valid = np.zeros(cap, np.bool_)
        for i, v in enumerate(values):
            if v is None:
                continue
            u = int(conv(v)) & ((1 << 128) - 1)
            lo, hi = u & ((1 << 64) - 1), u >> 64
            los[i] = lo - (1 << 64) if lo >= (1 << 63) else lo
            his[i] = hi - (1 << 64) if hi >= (1 << 63) else hi
            valid[i] = True
        return Decimal128Column.from_limbs(
            torch.from_numpy(his).to(dev), torch.from_numpy(los).to(dev),
            torch.from_numpy(valid).to(dev), dtype)

    def leaves(self) -> tuple:
        return (self.hi.data, self.lo.data, self.validity)

    @classmethod
    def from_leaves(cls, dtype: DataType, leaves) -> "Decimal128Column":
        return cls.from_limbs(*leaves, dtype)

    def with_capacity(self, capacity: int) -> "Decimal128Column":
        cap = self.capacity
        if capacity == cap:
            return self
        if capacity < cap:
            raise ValueError(f"cannot shrink capacity {cap} to {capacity}")
        extra = capacity - cap
        return Decimal128Column.from_limbs(
            torch.cat([self.hi.data, self.hi.data.new_zeros(extra)]),
            torch.cat([self.lo.data, self.lo.data.new_zeros(extra)]),
            torch.cat([self.validity, self.validity.new_zeros(extra)]),
            self.dtype)

    def to_pylist(self, num_rows: int) -> List:
        """Unscaled 128-bit values as Python ints (None for null)."""
        hi = self.hi.data[:num_rows].cpu().numpy().tolist()
        lo = self.lo.data[:num_rows].cpu().numpy().tolist()
        valid = self.validity[:num_rows].cpu().numpy().tolist()
        # hi carries the sign; lo reads as unsigned
        return [(h << 64) + (l & ((1 << 64) - 1)) if ok else None
                for h, l, ok in zip(hi, lo, valid)]

    def to_decimal_list(self, num_rows: int) -> List:
        return to_decimals(self.to_pylist(num_rows), self.dtype)

    def __repr__(self):
        return f"Decimal128Column({self.dtype!r}, cap={self.capacity})"


class ArrayColumn(Column):
    """List column: int32 offsets (capacity + 1,) into a child column of
    the element type, and the rows' validity. Row i's elements are child
    rows [offsets[i], offsets[i + 1]); the child has its own capacity
    bucket. It has no `data` tensor: every path that moves rows gathers
    the offsets' spans (ops/collection.gather_array)."""

    __slots__ = ("offsets", "child")

    def __init__(self, child: Column, offsets: torch.Tensor,
                 validity: torch.Tensor, dtype: ArrayType):
        super().__init__(None, validity, dtype)
        self.child = child
        self.offsets = offsets

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    @property
    def child_capacity(self) -> int:
        return self.child.capacity

    @property
    def device(self) -> torch.device:
        return self.validity.device

    @staticmethod
    def from_pylist(values: Sequence, dtype: ArrayType,
                    capacity: Optional[int] = None,
                    device=None) -> "ArrayColumn":
        """Python lists (None for a null row) -> column on `device`."""
        dev = resolve_device(device)
        n = len(values)
        cap = capacity or bucket_capacity(n)
        validity = _pad_np(np.array([v is not None for v in values],
                                    np.bool_), cap, False)
        off = _offsets_np(values, n, cap)
        flat = [x for v in values if v is not None for x in v]
        child = build_column(flat, dtype.element_type, device=dev)
        return ArrayColumn(child, torch.from_numpy(off).to(dev),
                           torch.from_numpy(validity).to(dev), dtype)

    def leaves(self) -> tuple:
        """The child's leaves, then the offsets and the validity (the JAX
        package's pytree order)."""
        return tuple(self.child.leaves()) + (self.offsets, self.validity)

    @classmethod
    def from_leaves(cls, dtype: DataType, leaves) -> "ArrayColumn":
        leaves = tuple(leaves)
        child = column_class(dtype.element_type).from_leaves(
            dtype.element_type, leaves[:-2])
        return cls(child, leaves[-2], leaves[-1], dtype)

    def with_capacity(self, capacity: int) -> "ArrayColumn":
        """Grow (never shrink) the row bucket with empty rows."""
        cap = self.capacity
        if capacity == cap:
            return self
        if capacity < cap:
            raise ValueError(f"cannot shrink capacity {cap} to {capacity}")
        extra = capacity - cap
        offsets = torch.cat([self.offsets, self.offsets[-1:].expand(extra)])
        validity = torch.cat([self.validity,
                              self.validity.new_zeros(extra)])
        return ArrayColumn(self.child, offsets, validity, self.dtype)

    def to_pylist(self, num_rows: int) -> List:
        off = self.offsets[: num_rows + 1].cpu().numpy().tolist()
        valid = self.validity[:num_rows].cpu().numpy().tolist()
        kid = self.child.to_pylist(off[num_rows] if num_rows else 0)
        return [kid[off[i]: off[i + 1]] if ok else None
                for i, ok in enumerate(valid)]

    def __repr__(self):
        return (f"ArrayColumn({self.dtype!r}, cap={self.capacity}, "
                f"child={self.child!r})")


class StructColumn(Column):
    """Struct column: one child column a field, each at the struct's
    capacity, and the struct's own validity; no data tensor."""

    __slots__ = ("children",)

    def __init__(self, children, validity: torch.Tensor, dtype: StructType):
        super().__init__(None, validity, dtype)
        self.children = tuple(children)

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    @property
    def device(self) -> torch.device:
        return self.validity.device

    @staticmethod
    def from_pylist(values: Sequence, dtype: StructType,
                    capacity: Optional[int] = None,
                    device=None) -> "StructColumn":
        """dicts (or objects with the field names as attributes; None for
        a null row) -> column on `device`."""
        dev = resolve_device(device)
        n = len(values)
        cap = capacity or bucket_capacity(n)
        validity = _pad_np(np.array([v is not None for v in values],
                                    np.bool_), cap, False)
        kids = []
        for f in dtype.fields:
            fv = [None if v is None else
                  (v.get(f.name) if isinstance(v, dict)
                   else getattr(v, f.name)) for v in values]
            kids.append(build_column(fv, f.data_type, cap, dev))
        return StructColumn(kids, torch.from_numpy(validity).to(dev), dtype)

    def leaves(self) -> tuple:
        """Each child's leaves in field order, then the validity (the JAX
        package's pytree order)."""
        return tuple(t for c in self.children for t in c.leaves()) \
            + (self.validity,)

    @classmethod
    def from_leaves(cls, dtype: DataType, leaves) -> "StructColumn":
        leaves = tuple(leaves)
        kids, pos = [], 0
        for f in dtype.fields:
            n = leaf_count(f.data_type)
            kids.append(column_class(f.data_type).from_leaves(
                f.data_type, leaves[pos: pos + n]))
            pos += n
        return cls(kids, leaves[pos], dtype)

    def with_capacity(self, capacity: int) -> "StructColumn":
        """Grow (never shrink) the row bucket, the children with it."""
        cap = self.capacity
        if capacity == cap:
            return self
        if capacity < cap:
            raise ValueError(f"cannot shrink capacity {cap} to {capacity}")
        return StructColumn(
            [c.with_capacity(capacity) for c in self.children],
            torch.cat([self.validity,
                       self.validity.new_zeros(capacity - cap)]),
            self.dtype)

    def to_pylist(self, num_rows: int) -> List:
        valid = self.validity[:num_rows].cpu().numpy().tolist()
        kids = [c.to_pylist(num_rows) for c in self.children]
        names = [f.name for f in self.dtype.fields]
        return [{nm: k[i] for nm, k in zip(names, kids)} if ok else None
                for i, ok in enumerate(valid)]

    def __repr__(self):
        return f"StructColumn({self.dtype!r}, cap={self.capacity})"


class MapColumn(Column):
    """Map column: int32 offsets (capacity + 1,) into parallel `keys` and
    `values` child columns (the entries), and the rows' validity. The
    JAX package's layout: cuDF's list of structs with the struct
    unzipped, so a lookup is a flat compare over the keys child. A row
    may hold a key twice; every consumer takes the FIRST entry."""

    __slots__ = ("offsets", "keys", "values")

    def __init__(self, keys: Column, values: Column, offsets: torch.Tensor,
                 validity: torch.Tensor, dtype: MapType):
        super().__init__(None, validity, dtype)
        self.keys = keys
        self.values = values
        self.offsets = offsets

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    @property
    def entry_capacity(self) -> int:
        return self.keys.capacity

    @property
    def device(self) -> torch.device:
        return self.validity.device

    @staticmethod
    def from_pylist(values: Sequence, dtype: MapType,
                    capacity: Optional[int] = None,
                    device=None) -> "MapColumn":
        """dicts or lists of (key, value) pairs (None for a null row) ->
        column on `device`."""
        dev = resolve_device(device)
        n = len(values)
        cap = capacity or bucket_capacity(n)
        validity = _pad_np(np.array([v is not None for v in values],
                                    np.bool_), cap, False)
        off = _offsets_np(values, n, cap)
        items = [(k, x) for v in values if v is not None
                 for k, x in (v.items() if isinstance(v, dict) else v)]
        keys = build_column([k for k, _ in items], dtype.key_type,
                            device=dev)
        vals = build_column([x for _, x in items], dtype.value_type,
                            device=dev)
        return MapColumn(keys, vals, torch.from_numpy(off).to(dev),
                         torch.from_numpy(validity).to(dev), dtype)

    def leaves(self) -> tuple:
        """The keys' leaves, the values' leaves, the offsets and the
        validity (the JAX package's pytree order)."""
        return tuple(self.keys.leaves()) + tuple(self.values.leaves()) \
            + (self.offsets, self.validity)

    @classmethod
    def from_leaves(cls, dtype: DataType, leaves) -> "MapColumn":
        leaves = tuple(leaves)
        nk = leaf_count(dtype.key_type)
        nv = leaf_count(dtype.value_type)
        keys = column_class(dtype.key_type).from_leaves(dtype.key_type,
                                                        leaves[:nk])
        vals = column_class(dtype.value_type).from_leaves(
            dtype.value_type, leaves[nk: nk + nv])
        return cls(keys, vals, leaves[nk + nv], leaves[nk + nv + 1], dtype)

    def with_capacity(self, capacity: int) -> "MapColumn":
        """Grow (never shrink) the row bucket with empty rows."""
        cap = self.capacity
        if capacity == cap:
            return self
        if capacity < cap:
            raise ValueError(f"cannot shrink capacity {cap} to {capacity}")
        extra = capacity - cap
        offsets = torch.cat([self.offsets, self.offsets[-1:].expand(extra)])
        validity = torch.cat([self.validity,
                              self.validity.new_zeros(extra)])
        return MapColumn(self.keys, self.values, offsets, validity,
                         self.dtype)

    def to_pylist(self, num_rows: int) -> List:
        """dicts, the FIRST entry of a duplicated key winning (as map_get
        does)."""
        off = self.offsets[: num_rows + 1].cpu().numpy().tolist()
        valid = self.validity[:num_rows].cpu().numpy().tolist()
        n_entries = off[num_rows] if num_rows else 0
        ks = self.keys.to_pylist(n_entries)
        vs = self.values.to_pylist(n_entries)
        out: List = []
        for i, ok in enumerate(valid):
            if not ok:
                out.append(None)
                continue
            d = {}
            for k, v in zip(ks[off[i]: off[i + 1]], vs[off[i]: off[i + 1]]):
                if k not in d:
                    d[k] = v
            out.append(d)
        return out

    def __repr__(self):
        return f"MapColumn({self.dtype!r}, cap={self.capacity})"


def leaf_count(dtype: DataType) -> int:
    """How many tensors `column_class(dtype).leaves()` gives."""
    if isinstance(dtype, ArrayType):
        return leaf_count(dtype.element_type) + 2
    if isinstance(dtype, StructType):
        return sum(leaf_count(f.data_type) for f in dtype.fields) + 1
    if isinstance(dtype, MapType):
        return leaf_count(dtype.key_type) + leaf_count(dtype.value_type) + 2
    if (isinstance(dtype, DecimalType) and dtype.is_decimal128) \
            or dtype.torch_dtype is None:
        return 3
    return 2


def column_class(dtype: DataType) -> type:
    """The column class that holds `dtype` (a string as a plain
    StringColumn: a dictionary is a batch column's layout, never a
    child's)."""
    if isinstance(dtype, ArrayType):
        return ArrayColumn
    if isinstance(dtype, StructType):
        return StructColumn
    if isinstance(dtype, MapType):
        return MapColumn
    if isinstance(dtype, DecimalType) and dtype.is_decimal128:
        return Decimal128Column
    if dtype.torch_dtype is None:
        return StringColumn
    return Column


def to_decimals(unscaled: Sequence, dtype: DecimalType) -> List:
    """Unscaled ints of a decimal column as decimal.Decimal values."""
    import decimal as _d
    ctx = _d.Context(prec=_d.MAX_PREC)    # exact: no rounding to 28 digits
    return [None if v is None else _d.Decimal(v).scaleb(-dtype.scale, ctx)
            for v in unscaled]


def build_column(values: Sequence, dtype: DataType,
                 capacity: Optional[int] = None, device=None) -> Column:
    """Python values -> a column of the class for `dtype` on `device`."""
    if isinstance(dtype, ArrayType):
        return ArrayColumn.from_pylist(values, dtype, capacity, device)
    if isinstance(dtype, StructType):
        return StructColumn.from_pylist(values, dtype, capacity, device)
    if isinstance(dtype, MapType):
        return MapColumn.from_pylist(values, dtype, capacity, device)
    if isinstance(dtype, DecimalType) and dtype.is_decimal128:
        return Decimal128Column.from_pylist(values, dtype, capacity, device)
    if dtype.torch_dtype is None:
        return StringColumn.from_pylist(values, capacity, dtype, device)
    return Column.from_pylist(values, dtype, capacity, device)


def string_buffers(values: Sequence[Optional[object]]):
    """Python strings (or bytes; None as empty) -> Arrow-layout numpy
    (bytes uint8, offsets int32 (n + 1,))."""
    raw = [b"" if v is None else
           (v.encode("utf-8") if isinstance(v, str) else bytes(v))
           for v in values]
    offsets = np.zeros(len(raw) + 1, dtype=np.int32)
    offsets[1:] = np.cumsum(np.fromiter(map(len, raw), np.int64, len(raw)))
    return np.frombuffer(b"".join(raw), dtype=np.uint8), offsets


# -- the arrow seams (pyarrow is imported only inside these functions) ------

def _string_from_arrow_buffers(arr, dt: DataType, n: int,
                               device=None) -> StringColumn:
    """Arrow string/binary array -> StringColumn straight from its
    (validity bitmap, offsets, bytes) buffers, each copied once into its
    padded buffer (the JAX package's `_string_from_arrow_buffers`)."""
    import pyarrow as pa
    if pa.types.is_large_string(arr.type):
        arr = arr.cast(pa.string())
    elif pa.types.is_large_binary(arr.type):
        arr = arr.cast(pa.binary())
    bufs = arr.buffers()
    off_all = np.frombuffer(bufs[1], dtype=np.int32)
    cap = bucket_capacity(n)
    off = np.empty(cap + 1, dtype=np.int32)
    off[: n + 1] = off_all[arr.offset: arr.offset + n + 1]
    base = int(off[0]) if n else 0
    if base:
        off[: n + 1] -= base
    total = int(off[n]) if n else 0
    off[n + 1:] = total
    data = np.zeros(bucket_capacity(max(total, 1)), dtype=np.uint8)
    if total:
        data[:total] = np.frombuffer(bufs[2], dtype=np.uint8, count=total,
                                     offset=base)
    if bufs[0] is None:
        validity = np.ones(n, dtype=np.bool_)
    else:
        bits = np.frombuffer(bufs[0], dtype=np.uint8)
        validity = np.unpackbits(bits, bitorder="little")[
            arr.offset: arr.offset + n].astype(np.bool_)
    # Arrow lets null slots span bytes; the engine's lengths are 0 there
    if n and not validity.all():
        lens = np.diff(off[: n + 1])
        if (lens[~validity] != 0).any():
            return StringColumn.from_pylist(arr.to_pylist(), dtype=dt,
                                            device=device)
    dev = resolve_device(device)
    return StringColumn(torch.from_numpy(data).to(dev),
                        torch.from_numpy(off).to(dev),
                        torch.from_numpy(_pad_np(validity, cap, False))
                        .to(dev), dt)


def column_from_arrow(arr, dtype: Optional[DataType] = None, device=None,
                      encoded: Optional[bool] = None) -> Column:
    """pyarrow Array/ChunkedArray -> column on `device` (the scan builds
    host columns with device="cpu"). A dictionary array of strings stays
    a DictionaryColumn when `encoded` (default: the active conf's
    spark.rapids.tpu.scan.encoded.enabled), else
    it decodes. DECIMAL(p<=18) becomes its unscaled int64 lane, a wider
    decimal a Decimal128Column (two int64 limbs), a list array an
    ArrayColumn, a struct array a StructColumn, a map array a MapColumn,
    and a null array a column of the null type (int8 zeros, every row
    null), as in the JAX package."""
    import pyarrow as pa
    from ..types import BOOLEAN, from_arrow
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_dictionary(arr.type):
        from ..config import SCAN_ENCODED, active_conf
        from .encoded import dictionary_from_arrow
        if encoded is None:
            encoded = active_conf().get(SCAN_ENCODED)
        if encoded:
            dt = dtype or from_arrow(arr.type.value_type)
            if isinstance(dt, (StringType, BinaryType)):
                enc = dictionary_from_arrow(arr, dt, device)
                if enc is not None:
                    return enc
        arr = arr.dictionary_decode()
    dt = dtype or from_arrow(arr.type)
    n = len(arr)
    if isinstance(dt, (StringType, BinaryType)):
        return _string_from_arrow_buffers(arr, dt, n, device)
    validity = np.asarray(arr.is_valid(), dtype=np.bool_)
    if isinstance(dt, StructType):
        kids = [column_from_arrow(arr.field(i), f.data_type, device,
                                  encoded=False)
                for i, f in enumerate(dt.fields)]
        return StructColumn(kids, torch.from_numpy(_pad_np(
            validity, bucket_capacity(n), False)).to(resolve_device(device)),
            dt)
    if isinstance(dt, MapType):
        # the map's own offsets into its (unsliced) keys and items, as
        # the JAX package takes them
        cap = bucket_capacity(n)
        off = np.zeros(cap + 1, dtype=np.int32)
        off[: n + 1] = np.asarray(arr.offsets, dtype=np.int32)
        off[n + 1:] = off[n] if n else 0
        keys = column_from_arrow(arr.keys, dt.key_type, device,
                                 encoded=False)
        vals = column_from_arrow(arr.items, dt.value_type, device,
                                 encoded=False)
        dev = resolve_device(device)
        return MapColumn(keys, vals, torch.from_numpy(off).to(dev),
                         torch.from_numpy(_pad_np(validity, cap, False))
                         .to(dev), dt)
    if isinstance(dt, ArrayType):
        # the list's own offsets into its (unsliced) values, as the JAX
        # package takes them
        cap = bucket_capacity(n)
        off = np.zeros(cap + 1, dtype=np.int32)
        off[: n + 1] = np.asarray(arr.offsets, dtype=np.int32)
        off[n + 1:] = off[n] if n else 0
        child = column_from_arrow(arr.values, dt.element_type, device,
                                  encoded=False)
        dev = resolve_device(device)
        return ArrayColumn(child, torch.from_numpy(off).to(dev),
                           torch.from_numpy(_pad_np(validity, cap, False))
                           .to(dev), dt)
    if isinstance(dt, NullType):
        cap = bucket_capacity(max(n, 1))
        dev = resolve_device(device)
        return Column(torch.zeros(cap, dtype=torch.int8, device=dev),
                      torch.zeros(cap, dtype=torch.bool, device=dev), dt)
    if isinstance(dt, DecimalType):
        if pa.types.is_decimal128(arr.type) and arr.type.scale == dt.scale:
            # the unscaled values from the array's 16-byte words (low
            # word, then the high word that carries the sign), 0 under a
            # null, as the per-row conversion below gives them
            words = np.frombuffer(arr.buffers()[1], dtype=np.int64) \
                .reshape(-1, 2)[arr.offset: arr.offset + n]
            lo = np.where(validity, words[:, 0], 0)
            if not dt.is_decimal128:
                return Column.from_numpy(lo, dt, device=device,
                                         validity=validity)
            cap = bucket_capacity(n)
            dev = resolve_device(device)
            hi = np.where(validity, words[:, 1], 0)
            return Decimal128Column.from_limbs(
                *(torch.from_numpy(_pad_np(x, cap)).to(dev) for x in (hi, lo)),
                torch.from_numpy(_pad_np(validity, cap, False)).to(dev), dt)
        if dt.is_decimal128:
            return Decimal128Column.from_pylist(arr.to_pylist(), dt,
                                                device=device)
        conv = _logical_to_physical(dt)
        dense = np.array([0 if v is None else conv(v)
                          for v in arr.to_pylist()], dtype=np.int64)
        return Column.from_numpy(dense, dt, device=device, validity=validity)
    if dt == BOOLEAN:
        dense = np.asarray(arr.fill_null(False), dtype=np.bool_)
    else:
        dense = np.asarray(arr.fill_null(0)).astype(dt.np_dtype)
    return Column.from_numpy(dense, dt, device=device, validity=validity)


def column_to_arrow(col: Column, num_rows: int):
    """A host column's first `num_rows` rows as a pyarrow array: a flat
    column from its buffers (`_arrow_from_buffers`), a nested one from its
    Python rows (DECIMAL leaves as decimal.Decimal values), the null type
    as a null array."""
    import pyarrow as pa
    from ..types import to_arrow
    if isinstance(col.dtype, NullType):
        return pa.nulls(num_rows)
    if isinstance(col, (StructColumn, MapColumn)):
        return pa.array(_arrow_values(col, col.to_pylist(num_rows)),
                        type=to_arrow(col.dtype))
    if not isinstance(col, ArrayColumn):
        return _arrow_from_buffers(col, num_rows)
    vals = col.to_pylist(num_rows)
    if isinstance(col.dtype.element_type, DecimalType):
        vals = [None if v is None else to_decimals(v, col.dtype.element_type)
                for v in vals]
    return pa.array(vals, type=to_arrow(col.dtype))


def _arrow_from_buffers(col: Column, n: int):
    """A host column of a flat type (fixed-width, DECIMAL, string,
    dictionary-encoded string) as a pyarrow array built from its buffers:
    the rows' values and validity as the per-row conversion gives them,
    without a Python object a row."""
    import pyarrow as pa
    from ..types import BOOLEAN, to_arrow
    from .encoded import DictionaryColumn
    dt, at = col.dtype, to_arrow(col.dtype)
    valid = col.validity[:n].cpu().numpy().astype(np.bool_)
    nulls = int(n - valid.sum())
    bitmap = pa.py_buffer(np.packbits(valid, bitorder="little")) \
        if nulls else None
    if isinstance(col, DictionaryColumn):
        entries = pa.Array.from_buffers(at, col.dict_capacity, [
            None, pa.py_buffer(col.dict_offsets.cpu().numpy()
                               .astype(np.int32)),
            pa.py_buffer(col.dict_data.cpu().numpy())])
        codes = col.codes[:n].cpu().numpy()
        ok = valid & (codes >= 0) & (codes < col.dict_capacity)
        return entries.take(pa.array(np.where(ok, codes, 0), pa.int32(),
                                     mask=~ok))
    if isinstance(col, StringColumn):
        return pa.Array.from_buffers(at, n, [
            bitmap, pa.py_buffer(col.offsets[: n + 1].cpu().numpy()
                                 .astype(np.int32)),
            pa.py_buffer(col.data.cpu().numpy())], null_count=nulls)
    if isinstance(dt, DecimalType):
        # 16-byte little-endian words: the low limb, then the high one
        words = np.empty((n, 2), np.int64)
        if isinstance(col, Decimal128Column):
            words[:, 0] = col.lo.data[:n].cpu().numpy()
            words[:, 1] = col.hi.data[:n].cpu().numpy()
        else:
            words[:, 0] = col.data[:n].cpu().numpy()
            words[:, 1] = words[:, 0] >> 63
        data = words
    elif dt == BOOLEAN:
        data = np.packbits(col.data[:n].cpu().numpy().astype(np.bool_),
                           bitorder="little")
    else:
        data = np.ascontiguousarray(
            col.data[:n].cpu().numpy().astype(dt.np_dtype, copy=False))
    return pa.Array.from_buffers(at, n, [bitmap, pa.py_buffer(data)],
                                 null_count=nulls)


def _arrow_values(col: Column, vals: List) -> List:
    """A struct's or map's Python rows with DECIMAL leaves as
    decimal.Decimal values (what pyarrow takes), as lists of pairs for a
    map (a pyarrow map keeps a duplicated key)."""
    dt = col.dtype
    if isinstance(dt, DecimalType):
        return to_decimals(vals, dt)
    if isinstance(col, StructColumn):
        kids = [_arrow_values(c, [None if v is None else v[f.name]
                                  for v in vals])
                for c, f in zip(col.children, dt.fields)]
        return [None if v is None else
                {f.name: k[i] for f, k in zip(dt.fields, kids)}
                for i, v in enumerate(vals)]
    if isinstance(col, MapColumn):
        return [None if v is None else
                list(zip(_arrow_values(col.keys, list(v.keys())),
                         _arrow_values(col.values, list(v.values()))))
                for v in vals]
    return vals
