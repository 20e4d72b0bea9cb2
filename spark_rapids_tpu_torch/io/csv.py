"""CSV scan and write — the counterpart of spark_rapids_tpu/io/csv.py
(reference GpuCSVScan.scala / GpuTextBasedPartitionReader.scala: host line
framing, then a device parse). As in the JAX package, pyarrow's C++ CSV
reader frames and parses each file on the shared decode pool; its table
crosses to the source's device in one packed upload a batch.

Spark's options: header, sep/delimiter, quote, escape, comment (a raw-line
prefilter: only a line whose first character is the comment character is
a comment), nullValue, mode (PERMISSIVE and DROPMALFORMED skip the rows
pyarrow cannot parse, counted in `malformed_rows`; FAILFAST raises). There
is no columnNameOfCorruptRecord sink, so PERMISSIVE behaves as
DROPMALFORMED, as in the JAX package.

pyarrow is imported when a source or the writer is built; without it they
raise ImportError naming pyarrow (the card's machine has none: ROADMAP
records that these paths run on the CPU only until it does).
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


class CsvSource:
    """A scan's source over CSV files; batches land on `device` (default:
    the card)."""

    def __init__(self, path, conf=None,
                 schema: Optional[Schema] = None, header: bool = True,
                 delimiter: str = ",", quote: str = '"',
                 escape: Optional[str] = None, comment: Optional[str] = None,
                 null_value: str = "",
                 mode: str = "PERMISSIVE",
                 num_threads: Optional[int] = None,
                 batch_rows: int = DEFAULT_BATCH_ROWS, device=None):
        need_pyarrow("the CSV reader", "pyarrow.csv")
        self.paths = expand_paths(path)
        if not self.paths:
            raise FileNotFoundError(f"no csv files at {path!r}")
        conf = conf or active_conf()
        self.header = header
        self.delimiter = delimiter
        self.quote = quote
        self.escape = escape
        self.comment = comment
        self.null_value = null_value
        self.mode = mode.upper()
        if self.mode not in MODES:
            raise ValueError(f"csv mode {mode!r} not in {MODES}")
        self.num_threads = conf.get(MULTITHREADED_READ_NUM_THREADS) \
            if num_threads is None else num_threads
        self.batch_rows = batch_rows
        self.device = resolve_device(device)
        self._user_schema = schema
        #: rows skipped by PERMISSIVE/DROPMALFORMED in the last drive
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

    def _read_one(self, path):
        pacsv = need_pyarrow("the CSV reader", "pyarrow.csv")
        read_opts = pacsv.ReadOptions(
            autogenerate_column_names=not self.header,
            column_names=None if self.header else
            (list(self._user_schema.names) if self._user_schema else None))

        def on_invalid(row):
            with self._count_lock:
                self.malformed_rows += 1
            return "skip"

        parse_opts = pacsv.ParseOptions(
            delimiter=self.delimiter,
            quote_char=self.quote if self.quote else False,
            escape_char=self.escape if self.escape else False,
            invalid_row_handler=(on_invalid
                                 if self.mode != "FAILFAST" else None))
        # Spark's default nullValue is the empty string only: nulling the
        # words "null"/"NULL" would change real string data
        kw = dict(
            strings_can_be_null=True,  # Spark: an empty field is null
            null_values=[self.null_value],
            true_values=["true", "True", "TRUE"],
            false_values=["false", "False", "FALSE"],
        )
        if self._user_schema is not None:
            kw["column_types"] = {f.name: to_arrow(f.data_type)
                                  for f in self._user_schema.fields}
        convert = pacsv.ConvertOptions(**kw)
        src = path
        if self.comment:
            # pyarrow has no comment character: Spark (univocity) treats
            # only a raw line whose first character is it as a comment (a
            # quoted first field like "#tag" is data)
            import io
            comment_b = self.comment.encode()
            with open(path, "rb") as f:
                kept = [ln for ln in f if not ln.startswith(comment_b)]
            src = io.BytesIO(b"".join(kept))
        return pacsv.read_csv(src, read_options=read_opts,
                              parse_options=parse_opts,
                              convert_options=convert)

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


def write_csv(df, path, header: bool = True, delimiter: str = ","):
    """DataFrame -> one CSV file (reference GpuCSVFileFormat's writer;
    the table comes from `df.to_arrow()`: one fetch a batch)."""
    pacsv = need_pyarrow("the CSV writer", "pyarrow.csv")
    table = df.to_arrow()
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    pacsv.write_csv(table, path, write_options=pacsv.WriteOptions(
        include_header=header, delimiter=delimiter))
