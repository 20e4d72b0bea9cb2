"""Device columns — the counterpart of spark_rapids_tpu/columnar/column.py:
fixed-width columns, string columns as far as a dictionary needs them
(columnar/encoded.py), and decimal128 columns (`Decimal128Column`, two
int64 limb children).

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

from ..types import BinaryType, DataType, DecimalType, StringType

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


def to_decimals(unscaled: Sequence, dtype: DecimalType) -> List:
    """Unscaled ints of a decimal column as decimal.Decimal values."""
    import decimal as _d
    ctx = _d.Context(prec=_d.MAX_PREC)    # exact: no rounding to 28 digits
    return [None if v is None else _d.Decimal(v).scaleb(-dtype.scale, ctx)
            for v in unscaled]


def build_column(values: Sequence, dtype: DataType,
                 capacity: Optional[int] = None, device=None) -> Column:
    """Python values -> a column of the class for `dtype` on `device`."""
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
    it decodes. DECIMAL(p<=18) becomes its unscaled int64 lane; decimal128
    arrays wait for ROADMAP A.5, nested and null types for A.8."""
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
    if isinstance(dt, DecimalType):
        if dt.is_decimal128:
            raise NotImplementedError(
                f"{dt!r} arrow arrays (decimal128) wait for ROADMAP A.5")
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
    """A host column's first `num_rows` rows as a pyarrow array (a
    DECIMAL(p<=18) as decimal.Decimal values; decimal128 waits for
    ROADMAP A.5)."""
    import pyarrow as pa
    from ..types import to_arrow
    if isinstance(col, Decimal128Column):
        raise NotImplementedError(
            f"{col.dtype!r} arrow arrays (decimal128) wait for ROADMAP A.5")
    vals = col.to_pylist(num_rows)
    if isinstance(col.dtype, DecimalType):
        vals = to_decimals(vals, col.dtype)
    return pa.array(vals, type=to_arrow(col.dtype))
