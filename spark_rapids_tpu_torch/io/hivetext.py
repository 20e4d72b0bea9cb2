"""Hive delimited-text tables — the counterpart of
spark_rapids_tpu/io/hivetext.py (reference GpuHiveTableScanExec /
GpuHiveTextFileFormat): LazySimpleSerDe's defaults, field delimiter \\x01
(^A), row delimiter \\n, the NULL sentinel '\\N' and no quoting, with the
textual value formats Hive uses (lowercase true/false, plain decimal
floats).

The parse runs line by line in Python on the host, as in the JAX package:
a LONG, INT, DOUBLE, FLOAT or BOOLEAN field parses (a malformed one reads
as NULL), and a field of any other type, DATE and DECIMAL among them,
keeps its raw string (ROADMAP C.5 records that shared behaviour). Each
batch's host columns cross to the source's device in one packed upload;
`scan_stats` records the last drive's rows, batches and its host parse,
host build and upload ns.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, List

from ..columnar.batch import ColumnarBatch
from ..columnar.column import resolve_device
from ..types import (BooleanType, DataType, DoubleType, FloatType,
                     IntegerType, LongType, Schema)
from .multifile import expand_paths, host_batch_upload

NULL = r"\N"
FIELD_DELIM = "\x01"


def _parse(raw: str, dt: DataType):
    if raw == NULL:
        return None
    if isinstance(dt, (LongType, IntegerType)):
        try:
            return int(raw)
        except ValueError:
            return None  # Hive: a malformed number reads as NULL
    if isinstance(dt, (DoubleType, FloatType)):
        try:
            return float(raw)
        except ValueError:
            return None
    if isinstance(dt, BooleanType):
        return raw.lower() == "true" if raw.lower() in ("true", "false") \
            else None
    return raw


def _fmt(v, dt: DataType) -> str:
    if v is None:
        return NULL
    if isinstance(dt, BooleanType):
        return "true" if v else "false"
    if isinstance(dt, (DoubleType, FloatType)):
        return repr(float(v))
    return str(v)


class HiveTextSource:
    """A scan's source over Hive text files under `schema`; batches land
    on `device` (default: the card)."""

    def __init__(self, path, schema: Schema, conf=None,
                 field_delim: str = FIELD_DELIM,
                 batch_rows: int = 1 << 17, device=None):
        self.paths = expand_paths(path)
        if not self.paths:
            raise FileNotFoundError(f"no files at {path!r}")
        self.schema = schema
        self.field_delim = field_delim
        self.batch_rows = batch_rows
        self.device = resolve_device(device)
        self.scan_stats = {"rows": 0, "batches": 0, "decode_ns": 0,
                           "build_ns": 0, "upload_ns": 0}

    def estimated_size_bytes(self) -> int:
        return sum(os.path.getsize(p) for p in self.paths)

    def batches(self) -> Iterator[ColumnarBatch]:
        stats = self.scan_stats
        for k in stats:
            stats[k] = 0
        fields = self.schema.fields
        cols: List[List] = [[] for _ in fields]
        n = 0
        t0 = time.perf_counter_ns()
        for p in self.paths:
            with open(p, "r", encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").split(self.field_delim)
                    for i, fld in enumerate(fields):
                        raw = parts[i] if i < len(parts) else NULL
                        cols[i].append(_parse(raw, fld.data_type))
                    n += 1
                    if n >= self.batch_rows:
                        stats["decode_ns"] += time.perf_counter_ns() - t0
                        yield self._flush(cols)
                        cols = [[] for _ in fields]
                        n = 0
                        t0 = time.perf_counter_ns()
        stats["decode_ns"] += time.perf_counter_ns() - t0
        yield self._flush(cols)

    def _flush(self, cols: List[List]) -> ColumnarBatch:
        data = {f.name: c for f, c in zip(self.schema.fields, cols)}
        return host_batch_upload(data, self.schema, self.device,
                                 self.scan_stats)


def write_hive_text(df, path: str, field_delim: str = FIELD_DELIM) -> None:
    """DataFrame -> one Hive text file (the rows come from `df.collect()`:
    one fetch from the device)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    fields = df.schema.fields
    with open(path, "w", encoding="utf-8") as f:
        for row in df.collect():
            f.write(field_delim.join(
                _fmt(v, fld.data_type) for v, fld in zip(row, fields)))
            f.write("\n")
