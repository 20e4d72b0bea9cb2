"""JSON-lines scan and write — the counterpart of
spark_rapids_tpu/io/json.py (reference GpuJsonReadCommon.scala: host line
framing, then a device parse through JSONUtils). As in the JAX package,
pyarrow's C++ JSON reader parses each file on the shared decode pool; its
table crosses to the source's device in one packed upload a batch.

mode: PERMISSIVE (Spark's default) drops the lines pyarrow cannot parse by
framing the file line by line on the host and parsing only the
well-formed records (counted in `malformed_rows`); FAILFAST raises the
parse error.

pyarrow is imported when a source is built; without it the source raises
ImportError naming pyarrow. The writer is Python's json over
`df.to_pydict()`, as in the JAX package.
"""

from __future__ import annotations

import os
import threading
from typing import Iterator, Optional

from ..columnar.batch import ColumnarBatch
from ..columnar.column import resolve_device
from ..config import MULTITHREADED_READ_NUM_THREADS, active_conf
from ..types import Schema, StructField, from_arrow, to_arrow
from .multifile import (DRIVE_STATS, arrow_to_batches, expand_paths,
                        need_pyarrow, reset_drive_stats, threaded_chunks,
                        timed_tasks)
from .parquet import DEFAULT_BATCH_ROWS

MODES = ("PERMISSIVE", "DROPMALFORMED", "FAILFAST")


class JsonSource:
    """A scan's source over JSON-lines files; batches land on `device`
    (default: the card)."""

    def __init__(self, path, conf=None,
                 schema: Optional[Schema] = None,
                 mode: str = "PERMISSIVE",
                 num_threads: Optional[int] = None,
                 batch_rows: int = DEFAULT_BATCH_ROWS, device=None):
        need_pyarrow("the JSON reader", "pyarrow.json")
        self.paths = expand_paths(path)
        if not self.paths:
            raise FileNotFoundError(f"no json files at {path!r}")
        conf = conf or active_conf()
        self.mode = mode.upper()
        if self.mode not in MODES:
            raise ValueError(f"json mode {mode!r} not in {MODES}")
        self.num_threads = conf.get(MULTITHREADED_READ_NUM_THREADS) \
            if num_threads is None else num_threads
        self.batch_rows = batch_rows
        self.device = resolve_device(device)
        self._user_schema = schema
        #: lines dropped by PERMISSIVE mode in the last batches() drive
        #: (counted from the pool's threads, under a lock)
        self.malformed_rows = 0
        #: the last batches() drive's multifile.DRIVE_STATS
        self.scan_stats = dict.fromkeys(DRIVE_STATS, 0)
        self._count_lock = threading.Lock()
        if schema is not None:
            self.schema = schema
        else:
            table = self._read_one(self.paths[0])
            self.schema = Schema(tuple(
                StructField(f.name, from_arrow(f.type), f.nullable)
                for f in table.schema))

    def _parse_options(self):
        pajson = need_pyarrow("the JSON reader", "pyarrow.json")
        if self._user_schema is not None:
            import pyarrow as pa
            return pajson.ParseOptions(explicit_schema=pa.schema(
                [(f.name, to_arrow(f.data_type))
                 for f in self._user_schema.fields]))
        return None

    def _read_one(self, path):
        pajson = need_pyarrow("the JSON reader", "pyarrow.json")
        try:
            return pajson.read_json(path,
                                    parse_options=self._parse_options())
        except Exception:
            if self.mode == "FAILFAST":
                raise
            return self._read_permissive(path)

    def _read_permissive(self, path):
        """Line-framed recovery: each line parsed on its own and the
        malformed ones dropped (Spark's PERMISSIVE without a corrupt-record
        sink)."""
        import io
        import json as pyjson

        import pyarrow as pa
        import pyarrow.json as pajson

        good = []
        with open(path, "rb") as f:
            for line in f:
                s = line.strip()
                if not s:
                    continue
                try:
                    pyjson.loads(s)
                    good.append(s)
                except ValueError:
                    with self._count_lock:
                        self.malformed_rows += 1
        if not good:
            # every line malformed: zero rows, which needs an explicit
            # schema (nothing is left to infer one from)
            if self._user_schema is None:
                raise ValueError(
                    f"{path}: no parseable JSON lines and no explicit "
                    "schema to shape an empty result")
            return pa.table({f.name: pa.array([], to_arrow(f.data_type))
                             for f in self._user_schema.fields})
        buf = io.BytesIO(b"\n".join(good))
        return pajson.read_json(buf, parse_options=self._parse_options())

    def estimated_size_bytes(self) -> int:
        return sum(os.path.getsize(p) for p in self.paths)

    def batches(self) -> Iterator[ColumnarBatch]:
        self.malformed_rows = 0
        reset_drive_stats(self.scan_stats)
        tasks = timed_tasks([lambda p=p: self._read_one(p)
                             for p in self.paths], self.scan_stats)
        for table in threaded_chunks(tasks, self.num_threads):
            if self._user_schema is not None:
                table = table.select(list(self._user_schema.names))
            yield from arrow_to_batches(table, self.batch_rows, self.device,
                                        stats=self.scan_stats)


def write_json(df, path):
    """DataFrame -> one JSON-lines file (Spark's df.write.json): a null
    field is left out of its record."""
    import json as pyjson

    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    d = df.to_pydict()
    names = list(d.keys())
    n = len(d[names[0]]) if names else 0
    with open(path, "w") as f:
        for i in range(n):
            row = {k: d[k][i] for k in names if d[k][i] is not None}
            f.write(pyjson.dumps(row) + "\n")
