"""Avro container-file scan and write — the counterpart of
spark_rapids_tpu/io/avro.py (reference GpuAvroScan.scala with its own
AvroDataFileReader.scala block reader). The object-container framing and
the binary encoding are decoded here from the Avro 1.11 specification,
with no external library: this module is the port's own copy of the JAX
package's codec.

Supported: the null and deflate codecs, records of primitive fields,
nullable unions ([null, T] / [T, null]), enums (as strings), fixed (as
binary), arrays of primitives, and the common logical types (date,
timestamp-micros/millis). A file is one decode task on the shared decode
pool (io/multifile.py). The decode runs row by row in Python on the host;
each batch's host columns then cross to the source's device in one
packed upload (columnar/upload.py). `scan_stats` records the last
drive's rows, batches and its host decode, host build and upload ns.

The generic row codec (`read_avro_rows`, `write_avro_rows`) carries the
Iceberg metadata chain's nested records (io/iceberg.py).
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..columnar.batch import ColumnarBatch
from ..columnar.column import resolve_device
from ..config import MULTITHREADED_READ_NUM_THREADS, active_conf
from ..types import (BINARY, BOOLEAN, DATE, DOUBLE, FLOAT, INT, LONG,
                     STRING, TIMESTAMP, DataType, Schema, StructField)
from .multifile import expand_paths, host_batch_upload, threaded_chunks
from .parquet import DEFAULT_BATCH_ROWS

_MAGIC = b"Obj\x01"


# ---------------------------------------------------------------------------
# binary decoding primitives (Avro spec: zigzag varints, little-endian fp)
# ---------------------------------------------------------------------------

class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def long(self) -> int:
        buf, p = self.buf, self.pos
        shift = 0
        acc = 0
        while True:
            b = buf[p]
            p += 1
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        self.pos = p
        return (acc >> 1) ^ -(acc & 1)  # zigzag

    def bytes_(self) -> bytes:
        n = self.long()
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return out

    def fixed(self, n: int) -> bytes:
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return out

    def float_(self) -> float:
        (v,) = struct.unpack_from("<f", self.buf, self.pos)
        self.pos += 4
        return v

    def double(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.pos)
        self.pos += 8
        return v

    def boolean(self) -> bool:
        v = self.buf[self.pos] != 0
        self.pos += 1
        return v


def _read_meta_map(r: _Reader) -> Dict[str, bytes]:
    out: Dict[str, bytes] = {}
    while True:
        count = r.long()
        if count == 0:
            return out
        if count < 0:
            r.long()  # block byte size, unused
            count = -count
        for _ in range(count):
            k = r.bytes_().decode("utf-8")
            out[k] = r.bytes_()


# ---------------------------------------------------------------------------
# schema mapping
# ---------------------------------------------------------------------------

class _FieldDec:
    """One record field: engine type + (decoder, nullable, null_index)."""

    def __init__(self, name: str, dtype: DataType, kind: str,
                 nullable: bool, null_first: bool, size: int = 0,
                 scale_to_micros: int = 1):
        self.name = name
        self.dtype = dtype
        self.kind = kind            # long/int/float/double/boolean/string/
        #                             bytes/fixed/enum/array:<k>
        self.nullable = nullable
        self.null_first = null_first
        self.size = size            # for fixed
        self.symbols: List[str] = []  # for enum
        self.scale_to_micros = scale_to_micros
        self.elem: Optional["_FieldDec"] = None


def _map_avro_type(name: str, t) -> _FieldDec:
    nullable = False
    null_first = True
    if isinstance(t, list):  # union
        branches = [b for b in t if b != "null"]
        if len(branches) != 1 or len(t) > 2:
            raise ValueError(f"unsupported avro union for {name!r}: {t}")
        nullable = True
        null_first = t[0] == "null"
        t = branches[0]
    logical = t.get("logicalType") if isinstance(t, dict) else None
    base = t.get("type") if isinstance(t, dict) else t
    fd = None
    if logical == "date" and base == "int":
        fd = _FieldDec(name, DATE, "int", nullable, null_first)
    elif logical in ("timestamp-micros", "timestamp-millis") \
            and base == "long":
        fd = _FieldDec(name, TIMESTAMP, "long", nullable, null_first,
                       scale_to_micros=1 if logical.endswith("micros")
                       else 1000)
    elif base == "long":
        fd = _FieldDec(name, LONG, "long", nullable, null_first)
    elif base == "int":
        fd = _FieldDec(name, INT, "int", nullable, null_first)
    elif base == "float":
        fd = _FieldDec(name, FLOAT, "float", nullable, null_first)
    elif base == "double":
        fd = _FieldDec(name, DOUBLE, "double", nullable, null_first)
    elif base == "boolean":
        fd = _FieldDec(name, BOOLEAN, "boolean", nullable, null_first)
    elif base == "string":
        fd = _FieldDec(name, STRING, "string", nullable, null_first)
    elif base == "bytes":
        fd = _FieldDec(name, BINARY, "bytes", nullable, null_first)
    elif base == "fixed":
        fd = _FieldDec(name, BINARY, "fixed", nullable, null_first,
                       size=int(t["size"]))
    elif base == "enum":
        fd = _FieldDec(name, STRING, "enum", nullable, null_first)
        fd.symbols = list(t["symbols"])
    elif base == "array":
        elem = _map_avro_type(name + ".elem", t["items"])
        if elem.nullable or elem.kind.startswith("array"):
            raise ValueError(
                f"unsupported nested avro array for {name!r}")
        from ..types import ArrayType
        fd = _FieldDec(name, ArrayType(elem.dtype), "array", nullable,
                       null_first)
        fd.elem = elem
    if fd is None:
        raise ValueError(f"unsupported avro type for {name!r}: {t}")
    return fd


def _decode_scalar(r: _Reader, fd: _FieldDec):
    k = fd.kind
    if k in ("long", "int"):
        v = r.long()
        return v * fd.scale_to_micros if fd.scale_to_micros != 1 else v
    if k == "double":
        return r.double()
    if k == "float":
        return r.float_()
    if k == "boolean":
        return r.boolean()
    if k == "string":
        return r.bytes_().decode("utf-8")
    if k == "bytes":
        return r.bytes_()
    if k == "fixed":
        return r.fixed(fd.size)
    if k == "enum":
        return fd.symbols[r.long()]
    if k == "array":
        out = []
        while True:
            count = r.long()
            if count == 0:
                return out
            if count < 0:
                r.long()
                count = -count
            for _ in range(count):
                out.append(_decode_scalar(r, fd.elem))
    raise AssertionError(k)


def _decode_field(r: _Reader, fd: _FieldDec):
    if fd.nullable:
        idx = r.long()
        is_null = (idx == 0) if fd.null_first else (idx == 1)
        if is_null:
            return None
    return _decode_scalar(r, fd)


# ---------------------------------------------------------------------------
# source
# ---------------------------------------------------------------------------

class AvroSource:
    """Avro object-container scan (reference GpuAvroScan.scala +
    AvroDataFileReader.scala block reader); batches land on `device`
    (default: the card)."""

    def __init__(self, path, conf=None,
                 columns: Optional[Sequence[str]] = None,
                 num_threads: Optional[int] = None,
                 batch_rows: int = DEFAULT_BATCH_ROWS, device=None):
        self.paths = expand_paths(path)
        if not self.paths:
            raise FileNotFoundError(f"no avro files at {path!r}")
        conf = conf or active_conf()
        self.num_threads = conf.get(MULTITHREADED_READ_NUM_THREADS) \
            if num_threads is None else num_threads
        self.batch_rows = batch_rows
        self.device = resolve_device(device)
        self._codec, schema_json = self._read_header(self.paths[0])
        rec = json.loads(schema_json)
        self._schema_json = rec
        if rec.get("type") != "record":
            raise ValueError("top-level avro schema must be a record")
        self._fields = [_map_avro_type(f["name"], f["type"])
                        for f in rec["fields"]]
        if columns is not None:
            by_name = {fd.name: i for i, fd in enumerate(self._fields)}
            self._projected = [by_name[n] for n in columns]
        else:
            self._projected = list(range(len(self._fields)))
        self.schema = Schema(tuple(
            StructField(self._fields[i].name, self._fields[i].dtype,
                        self._fields[i].nullable)
            for i in self._projected))
        #: the last batches() drive: rows, batches, and the ns of the
        #: host decode (pool tasks, summed), the host columns' build and
        #: the uploads
        self.scan_stats = {"rows": 0, "batches": 0, "decode_ns": 0,
                           "build_ns": 0, "upload_ns": 0}

    @staticmethod
    def _read_header(path: str):
        """Parse only the header (metadata map + sync), reading the file
        in bounded chunks: construction does not pull a large data file
        into memory."""
        data = b""
        with open(path, "rb") as f:
            while True:
                chunk = f.read(1 << 16)
                data += chunk
                if data[:4] != _MAGIC[: min(4, len(data))]:
                    raise ValueError(
                        f"{path!r} is not an avro container file")
                try:
                    r = _Reader(data, 4)
                    meta = _read_meta_map(r)
                    r.fixed(16)  # the sync marker must be present too
                    if r.pos > len(data):
                        raise IndexError  # short slice: need more bytes
                    break
                except IndexError:
                    if not chunk:
                        raise ValueError(
                            f"truncated avro header in {path!r}")
        codec = meta.get("avro.codec", b"null").decode()
        if codec not in ("null", "deflate"):
            raise ValueError(f"unsupported avro codec {codec!r}")
        return codec, meta["avro.schema"]

    def estimated_size_bytes(self) -> int:
        return sum(os.path.getsize(p) for p in self.paths)

    def _file_blocks(self, path: str
                     ) -> Iterator[Tuple[int, bytes, str]]:
        """(row_count, raw block bytes, codec) per data block. Codec and
        schema are properties of each file: each file's own header is
        parsed, and a schema that differs from the scan's is rejected
        rather than misdecoded."""
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != _MAGIC:
            raise ValueError(f"{path!r} is not an avro container file")
        r = _Reader(data, 4)
        meta = _read_meta_map(r)
        codec = meta.get("avro.codec", b"null").decode()
        if codec not in ("null", "deflate"):
            raise ValueError(f"unsupported avro codec {codec!r} in {path!r}")
        if json.loads(meta["avro.schema"]) != self._schema_json:
            raise ValueError(
                f"avro schema mismatch: {path!r} differs from "
                f"{self.paths[0]!r}")
        sync = r.fixed(16)
        while r.pos < len(data):
            rows = r.long()
            nbytes = r.long()
            block = r.fixed(nbytes)
            marker = r.fixed(16)
            if marker != sync:
                raise ValueError(f"bad sync marker in {path!r}")
            yield rows, block, codec

    def _decode_block(self, rows: int, block: bytes, codec: str
                      ) -> List[List]:
        if codec == "deflate":
            block = zlib.decompress(block, wbits=-15)
        r = _Reader(block)
        cols: List[List] = [[] for _ in self._projected]
        slot_of = {fi: s for s, fi in enumerate(self._projected)}
        for _ in range(rows):
            for i, fd in enumerate(self._fields):
                v = _decode_field(r, fd)
                s = slot_of.get(i)
                if s is not None:
                    cols[s].append(v)
        return cols

    def _decode_file(self, path: str) -> Tuple[int, List[List], int]:
        """One file read and decoded inside its task (only `paths` live
        in the task closures, so the host holds one file per pool thread,
        not the whole dataset). Returns (rows, columns, decode ns)."""
        t0 = time.perf_counter_ns()
        total = 0
        cols: List[List] = [[] for _ in self._projected]
        for rows, block, codec in self._file_blocks(path):
            part = self._decode_block(rows, block, codec)
            for dst, src in zip(cols, part):
                dst.extend(src)
            total += rows
        return total, cols, time.perf_counter_ns() - t0

    def batches(self) -> Iterator[ColumnarBatch]:
        stats = self.scan_stats
        for k in stats:
            stats[k] = 0
        tasks = [lambda p=p: self._decode_file(p) for p in self.paths]
        pending: List[List] = [[] for _ in self._projected]
        pending_rows = 0
        for rows, cols, ns in threaded_chunks(tasks, self.num_threads):
            stats["decode_ns"] += ns
            for dst, src in zip(pending, cols):
                dst.extend(src)
            pending_rows += rows
            if pending_rows >= self.batch_rows:
                yield self._flush(pending)
                pending = [[] for _ in self._projected]
                pending_rows = 0
        if pending_rows or not tasks:
            yield self._flush(pending)

    def _flush(self, cols: List[List]) -> ColumnarBatch:
        data = {f.name: c for f, c in zip(self.schema.fields, cols)}
        return host_batch_upload(data, self.schema, self.device,
                                 self.scan_stats)


# ---------------------------------------------------------------------------
# writer (a test and tooling surface: the reference reads Avro only)
# ---------------------------------------------------------------------------

_WRITE_KINDS = {"bigint": ("long", "long"), "int": ("int", "int"),
                "smallint": ("int", "int"), "tinyint": ("int", "int"),
                "double": ("double", "double"), "float": ("float", "float"),
                "boolean": ("boolean", "boolean"),
                "string": ("string", "string"),
                "date": ({"type": "int", "logicalType": "date"}, "int"),
                "timestamp": ({"type": "long",
                               "logicalType": "timestamp-micros"}, "long")}


def _zigzag(v: int) -> bytes:
    acc = (v << 1) ^ (v >> 63) if v < 0 else (v << 1)
    out = bytearray()
    while True:
        b = acc & 0x7F
        acc >>= 7
        if acc:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def write_avro(df, path, codec: str = "deflate"):
    """DataFrame -> one avro container file of one data block, every
    field a [null, T] union (the rows come from `df.collect()`: one fetch
    from the device)."""
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported avro codec {codec!r}")
    schema = df.schema
    fields_json = []
    kinds = []
    for f in schema.fields:
        base, kind = _WRITE_KINDS.get(f.data_type.simple_name(),
                                      (None, None))
        if base is None:
            raise ValueError(
                f"avro write: unsupported type {f.data_type.simple_name()}")
        fields_json.append({"name": f.name, "type": ["null", base]})
        kinds.append(kind)
    schema_json = json.dumps({"type": "record", "name": "row",
                              "fields": fields_json})
    sync = os.urandom(16)
    rows = df.collect()
    body = bytearray()
    for row in rows:
        for v, kind in zip(row, kinds):
            if v is None:
                body += _zigzag(0)
                continue
            body += _zigzag(1)
            if kind in ("long", "int"):
                body += _zigzag(int(v))
            elif kind == "double":
                body += struct.pack("<d", float(v))
            elif kind == "float":
                body += struct.pack("<f", float(v))
            elif kind == "boolean":
                body.append(1 if v else 0)
            else:
                b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
                body += _zigzag(len(b)) + b
    payload = bytes(body)
    if codec == "deflate":
        payload = zlib.compress(payload)[2:-4]  # raw DEFLATE
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        meta = {"avro.schema": schema_json.encode(),
                "avro.codec": codec.encode()}
        f.write(_zigzag(len(meta)))
        for k, v in meta.items():
            kb = k.encode()
            f.write(_zigzag(len(kb)) + kb + _zigzag(len(v)) + v)
        f.write(_zigzag(0))
        f.write(sync)
        if rows:
            f.write(_zigzag(len(rows)) + _zigzag(len(payload)))
            f.write(payload)
            f.write(sync)


# ---------------------------------------------------------------------------
# the generic row codec (nested records, maps, arrays): Iceberg's manifest
# lists and manifests are avro files of nested records (io/iceberg.py),
# decoded row by row on the host like the reference's metadata paths.
# ---------------------------------------------------------------------------

def _decode_generic(r: _Reader, t):
    if isinstance(t, list):  # union
        idx = r.long()
        branch = t[idx]
        return None if branch == "null" else _decode_generic(r, branch)
    base = t.get("type") if isinstance(t, dict) else t
    if base == "record":
        return {f["name"]: _decode_generic(r, f["type"])
                for f in t["fields"]}
    if base == "array":
        out = []
        while True:
            c = r.long()
            if c == 0:
                return out
            if c < 0:
                r.long()
                c = -c
            for _ in range(c):
                out.append(_decode_generic(r, t["items"]))
    if base == "map":
        out = {}
        while True:
            c = r.long()
            if c == 0:
                return out
            if c < 0:
                r.long()
                c = -c
            for _ in range(c):
                k = r.bytes_().decode("utf-8")
                out[k] = _decode_generic(r, t["values"])
    if base in ("long", "int"):
        return r.long()
    if base == "double":
        return r.double()
    if base == "float":
        return r.float_()
    if base == "boolean":
        return r.boolean()
    if base == "string":
        return r.bytes_().decode("utf-8")
    if base == "bytes":
        return r.bytes_()
    if base == "fixed":
        return r.fixed(int(t["size"]))
    if base == "enum":
        return t["symbols"][r.long()]
    raise ValueError(f"unsupported avro type {t!r}")


def _encode_generic(out: bytearray, t, v):
    if isinstance(t, list):  # union: first matching branch
        if v is None and "null" in t:
            out += _zigzag(t.index("null"))
            return
        for i, b in enumerate(t):
            if b != "null":
                out += _zigzag(i)
                _encode_generic(out, b, v)
                return
        raise ValueError(f"no union branch for {v!r} in {t!r}")
    base = t.get("type") if isinstance(t, dict) else t
    if base == "record":
        for f in t["fields"]:
            _encode_generic(out, f["type"], v[f["name"]])
    elif base == "array":
        if v:
            out += _zigzag(len(v))
            for item in v:
                _encode_generic(out, t["items"], item)
        out += _zigzag(0)
    elif base == "map":
        if v:
            out += _zigzag(len(v))
            for k, item in v.items():
                kb = k.encode("utf-8")
                out += _zigzag(len(kb)) + kb
                _encode_generic(out, t["values"], item)
        out += _zigzag(0)
    elif base in ("long", "int"):
        out += _zigzag(int(v))
    elif base == "double":
        out += struct.pack("<d", float(v))
    elif base == "float":
        out += struct.pack("<f", float(v))
    elif base == "boolean":
        out.append(1 if v else 0)
    elif base == "string":
        b = v.encode("utf-8")
        out += _zigzag(len(b)) + b
    elif base == "bytes":
        out += _zigzag(len(v)) + bytes(v)
    else:
        raise ValueError(f"unsupported avro type {t!r}")


def read_avro_rows(path: str):
    """(schema_json_dict, rows as dicts) — full recursive decode."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != _MAGIC:
        raise ValueError(f"{path!r} is not an avro container file")
    r = _Reader(data, 4)
    meta = _read_meta_map(r)
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported avro codec {codec!r}")
    schema = json.loads(meta["avro.schema"])
    sync = r.fixed(16)
    rows = []
    while r.pos < len(data):
        n = r.long()
        nbytes = r.long()
        block = r.fixed(nbytes)
        if r.fixed(16) != sync:
            raise ValueError(f"bad sync marker in {path!r}")
        if codec == "deflate":
            block = zlib.decompress(block, wbits=-15)
        br = _Reader(block)
        for _ in range(n):
            rows.append(_decode_generic(br, schema))
    return schema, rows


def write_avro_rows(path: str, schema: dict, rows) -> None:
    """Rows (dicts) → one avro container file under `schema`."""
    body = bytearray()
    for row in rows:
        _encode_generic(body, schema, row)
    payload = zlib.compress(bytes(body))[2:-4]
    sync = os.urandom(16)
    schema_b = json.dumps(schema).encode()
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(_zigzag(2))
        for k, v in (("avro.schema", schema_b),
                     ("avro.codec", b"deflate")):
            kb = k.encode()
            f.write(_zigzag(len(kb)) + kb + _zigzag(len(v)) + v)
        f.write(_zigzag(0))
        f.write(sync)
        if rows:
            f.write(_zigzag(len(rows)) + _zigzag(len(payload)))
            f.write(payload)
            f.write(sync)
