"""Parquet scan — the counterpart of spark_rapids_tpu/io/parquet.py
(reference GpuParquetScan.scala).

Footer-driven row-group slicing (each row group one decode task), decoded
by pyarrow's reader on the shared decode pool (io/multifile.py) and
uploaded one packed copy per batch (ColumnarBatch.from_arrow). Column
pruning by `columns`. Row-group pruning evaluates pushed-down conjuncts
(column, op, literal) against the footer's min/max/null-count statistics:
pruned groups are never decoded, and `row_groups_read` /
`row_groups_pruned` record the effect. String columns come back as
dictionary arrays, kept as DictionaryColumns, when `encoded`. Reader
types: MULTITHREADED (the default:
`num_threads` decode threads), COALESCING (small row groups stitched into
one host table of about `batch_rows` before the upload) and PERFILE (the
same drive as MULTITHREADED, as in the JAX package).

The settings a caller leaves out are read from `conf` (default: the
active conf) when the source is built: `num_threads` from
spark.rapids.sql.multiThreadedRead.numThreads, `reader_type` from
spark.rapids.sql.format.parquet.reader.type and `encoded` from
spark.rapids.tpu.scan.encoded.enabled.

With spark.rapids.sql.format.parquet.datetimeRebaseModeInRead=LEGACY
(read when the source is built) the files are taken as written in the
hybrid Julian calendar: every DATE and TIMESTAMP column is rebased to proleptic
Gregorian on the device (ops/rebase.py), and footer statistics prune
nothing (they hold hybrid day numbers, the pushed literals proleptic
ones), as in the JAX package.

`write_parquet` writes `df.to_arrow()` (one fetch a batch) as one file,
or as a hive-partitioned directory by `partition_by`.

pyarrow is imported only when a reader or the writer is built, so the
package imports without it; building one without pyarrow raises
ImportError naming pyarrow.
"""

from __future__ import annotations

import datetime
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from ..columnar.batch import ColumnarBatch
from ..columnar.column import resolve_device
from ..types import Schema, StructField
from ..config import (MULTITHREADED_READ_NUM_THREADS,
                      PARQUET_READER_TYPE, PARQUET_REBASE_MODE_READ,
                      SCAN_ENCODED, active_conf)
from .multifile import (DRIVE_STATS, arrow_to_batches, expand_paths,
                        need_pyarrow, reset_drive_stats, threaded_chunks,
                        timed_tasks)

READER_TYPES = ("MULTITHREADED", "COALESCING", "PERFILE")
#: rows per emitted batch
DEFAULT_BATCH_ROWS = 1 << 20

_EPOCH_DATE = datetime.date(1970, 1, 1)
#: pushed predicate ops: (column name, op, literal)
_PRUNE_OPS = ("<", "<=", ">", ">=", "==", "is_null", "is_not_null")


def _parquet():
    return need_pyarrow("the Parquet reader", "pyarrow.parquet")


def _stat_value(v, value):
    """A footer statistic in the pushed literal's domain: a DATE
    statistic (pyarrow gives a datetime.date) as its day number where the
    literal is one, as the port's DATE literals are (ROADMAP C.24)."""
    if isinstance(v, datetime.date) and not isinstance(v, datetime.datetime) \
            and isinstance(value, int) and not isinstance(value, bool):
        return (v - _EPOCH_DATE).days
    return v


def _stats_can_skip(stats, op: str, value) -> bool:
    """True iff footer statistics prove that no row of the group can
    satisfy the predicate (missing or partial statistics never prune)."""
    if stats is None:
        return False
    if op == "is_null":
        return stats.null_count == 0 if stats.null_count is not None \
            else False
    if op == "is_not_null":
        nc, nv = stats.null_count, stats.num_values
        return nv == 0 if (nc is not None and nv is not None) else False
    if not stats.has_min_max:
        return False
    mn, mx = _stat_value(stats.min, value), _stat_value(stats.max, value)
    if mn is None or mx is None:
        return False
    try:
        if op == "==":
            return value < mn or value > mx
        if op == "<":
            return mn >= value
        if op == "<=":
            return mn > value
        if op == ">":
            return mx <= value
        if op == ">=":
            return mx < value
    except TypeError:
        return False  # incomparable (bytes statistics, a str literal)
    return False


class ParquetSource:
    """A scan's source over Parquet files (a path, directory, glob or a
    list of them); batches land on `device` (default: the card)."""

    def __init__(self, path, conf=None,
                 columns: Optional[Sequence[str]] = None,
                 num_threads: Optional[int] = None,
                 batch_rows: int = DEFAULT_BATCH_ROWS,
                 filters: Optional[Sequence[Tuple[str, str, object]]] = None,
                 reader_type: Optional[str] = None,
                 encoded: Optional[bool] = None, device=None):
        from ..types import from_arrow
        pq = _parquet()
        self.paths = expand_paths(path)
        if not self.paths:
            raise FileNotFoundError(f"no parquet files at {path!r}")
        conf = conf or active_conf()
        self.columns = list(columns) if columns is not None else None
        self.num_threads = conf.get(MULTITHREADED_READ_NUM_THREADS) \
            if num_threads is None else num_threads
        self.batch_rows = batch_rows
        self.filters = list(filters or [])
        self.reader_type = (reader_type
                            or conf.get(PARQUET_READER_TYPE)).upper()
        if self.reader_type not in READER_TYPES:
            raise ValueError(f"reader type {self.reader_type!r} not in "
                             f"{READER_TYPES}")
        self.encoded = conf.get(SCAN_ENCODED) if encoded is None \
            else encoded
        self.legacy_rebase = \
            conf.get(PARQUET_REBASE_MODE_READ).upper() == "LEGACY"
        self.device = resolve_device(device)
        arrow_schema = pq.read_schema(self.paths[0])
        fields = []
        for name in (self.columns or arrow_schema.names):
            f = arrow_schema.field(name)
            fields.append(StructField(f.name, from_arrow(f.type), f.nullable))
        self.schema = Schema(tuple(fields))
        #: set by the last batches() drive; shared with with_filters()
        #: copies, so the source the user holds sees the effect: the row
        #: groups read and pruned, and multifile.DRIVE_STATS (rows,
        #: batches, the host decode's ns summed over the pool's threads,
        #: the host build's and the uploads' ns)
        self.scan_stats = {"row_groups_read": 0, "row_groups_pruned": 0,
                           **dict.fromkeys(DRIVE_STATS, 0)}

    @property
    def row_groups_read(self) -> int:
        return self.scan_stats["row_groups_read"]

    @property
    def row_groups_pruned(self) -> int:
        return self.scan_stats["row_groups_pruned"]

    def with_filters(self, filters: Sequence[Tuple[str, str, object]]
                     ) -> "ParquetSource":
        """A copy that also prunes row groups with these conjuncts (the
        filter stays above the scan: statistics prove absence only). The
        footer is not read again."""
        out = ParquetSource.__new__(ParquetSource)
        out.__dict__.update(self.__dict__)
        out.filters = list(self.filters) + list(filters)
        return out

    def estimated_size_bytes(self) -> int:
        """Bytes on disk (compressed: an underestimate)."""
        return sum(os.path.getsize(p) for p in self.paths)

    def encoded_columns(self) -> List[str]:
        """The string columns a scan of this source passes on
        dictionary-encoded: with the encoded lane on, those of a source
        that reads as one batch (one row group of at most `batch_rows`;
        the coalesce above a scan of several decodes them to
        concatenate)."""
        names = self._read_dictionary()
        if not names:
            return []
        pq = _parquet()
        mds = [pq.ParquetFile(p).metadata for p in self.paths]
        groups = [md.row_group(i).num_rows for md in mds
                  for i in range(md.num_row_groups)]
        return names if len(groups) == 1 and groups[0] <= self.batch_rows \
            else []

    def _read_dictionary(self) -> Optional[List[str]]:
        """The string and binary columns pyarrow should return as
        dictionary arrays, when the encoded lane is on."""
        from ..types import BinaryType, StringType
        if not self.encoded:
            return None
        names = [f.name for f in self.schema.fields
                 if isinstance(f.data_type, (StringType, BinaryType))]
        return names or None

    def _group_pruned(self, md, rg: int, name_to_idx) -> bool:
        row_group = md.row_group(rg)
        for name, op, value in self.filters:
            ci = name_to_idx.get(name)
            if ci is not None and _stats_can_skip(
                    row_group.column(ci).statistics, op, value):
                return True
        return False

    def batches(self) -> Iterator[ColumnarBatch]:
        yield from self._maybe_rebase(self._decoded_batches())

    def _decoded_batches(self) -> Iterator[ColumnarBatch]:
        pq = _parquet()
        tasks = []
        self.scan_stats["row_groups_read"] = 0
        self.scan_stats["row_groups_pruned"] = 0
        reset_drive_stats(self.scan_stats)
        # LEGACY: the footer's statistics are hybrid-Julian day numbers
        # and the pushed literals proleptic-Gregorian, so comparing them
        # could prune a group whose rebased rows match: no pruning
        may_prune = bool(self.filters) and not self.legacy_rebase
        read_dict = self._read_dictionary()
        for p in self.paths:
            md = pq.ParquetFile(p).metadata
            name_to_idx = {md.schema.column(i).name: i
                           for i in range(md.num_columns)}
            for rg in range(md.num_row_groups):
                if may_prune and self._group_pruned(md, rg, name_to_idx):
                    self.scan_stats["row_groups_pruned"] += 1
                    continue
                self.scan_stats["row_groups_read"] += 1

                def decode(p=p, rg=rg):
                    # a handle per task: ParquetFile is not thread-safe
                    return pq.ParquetFile(
                        p, read_dictionary=read_dict).read_row_group(
                        rg, columns=self.columns)
                tasks.append(decode)
            if md.num_row_groups == 0:
                tasks.append(lambda p=p: pq.read_table(
                    p, columns=self.columns, read_dictionary=read_dict))
        tables = threaded_chunks(timed_tasks(tasks, self.scan_stats),
                                 self.num_threads)
        if self.reader_type == "COALESCING":
            yield from coalesced_batches(tables, self.batch_rows,
                                         self.device, self.scan_stats,
                                         self.encoded)
            return
        for table in tables:
            yield from arrow_to_batches(table, self.batch_rows, self.device,
                                        self.encoded, self.scan_stats)

    def _maybe_rebase(self, batches: Iterator[ColumnarBatch]
                      ) -> Iterator[ColumnarBatch]:
        """LEGACY datetimeRebaseModeInRead: files written in the hybrid
        Julian calendar get their DATE and TIMESTAMP columns rebased to
        proleptic Gregorian on the device (reference datetimeRebaseUtils
        and the JNI DateTimeRebase; ops/rebase.py). The same flag turned
        off the statistics pruning, so the two cannot disagree."""
        if not self.legacy_rebase:
            yield from batches
            return
        from ..columnar.column import Column
        from ..ops.rebase import (rebase_julian_to_gregorian_days,
                                  rebase_julian_to_gregorian_micros)
        from ..types import DateType, TimestampNTZType, TimestampType
        for b in batches:
            cols = []
            for c, f in zip(b.columns, b.schema.fields):
                if isinstance(f.data_type, DateType):
                    cols.append(Column(rebase_julian_to_gregorian_days(
                        c.data.to(torch.int64)).to(c.data.dtype),
                        c.validity, c.dtype))
                elif isinstance(f.data_type,
                                (TimestampType, TimestampNTZType)):
                    cols.append(Column(
                        rebase_julian_to_gregorian_micros(c.data),
                        c.validity, c.dtype))
                else:
                    cols.append(c)
            yield b.with_columns(cols, b.schema)


def coalesced_batches(tables, batch_rows: int, device, stats: dict,
                      encoded: Optional[bool] = None
                      ) -> Iterator[ColumnarBatch]:
    """Decoded row groups or stripes stitched on the host into tables of
    about `batch_rows` before the upload (the COALESCING readers of
    Parquet and ORC; reference GpuMultiFileReader.scala:830); the stitch
    adds to `stats["build_ns"]`."""
    import time
    import pyarrow as pa
    from .multifile import add_stat

    def flush(pending):
        t0 = time.perf_counter_ns()
        table = pa.concat_tables(pending)
        add_stat(stats, "build_ns", time.perf_counter_ns() - t0)
        return arrow_to_batches(table, batch_rows, device, encoded, stats)
    pending: List = []
    pending_rows = 0
    for table in tables:
        pending.append(table)
        pending_rows += table.num_rows
        if pending_rows >= batch_rows:
            yield from flush(pending)
            pending, pending_rows = [], 0
    if pending:
        yield from flush(pending)


def write_parquet(df, path, partition_by: Optional[Sequence[str]] = None):
    """DataFrame -> a Parquet file, or a directory when `path` is one or
    ends in "/", or a hive-partitioned directory by `partition_by`; the
    table comes from `df.to_arrow()` (one fetch a batch)."""
    pq = need_pyarrow("the Parquet writer", "pyarrow.parquet")
    table = df.to_arrow()
    if not partition_by:
        if os.path.isdir(path) or str(path).endswith("/"):
            os.makedirs(path, exist_ok=True)
            pq.write_table(table, os.path.join(path, "part-00000.parquet"))
        else:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            pq.write_table(table, path)
        return
    ds = need_pyarrow("the Parquet writer", "pyarrow.dataset")
    os.makedirs(path, exist_ok=True)
    ds.write_dataset(table, path, format="parquet",
                     partitioning=list(partition_by),
                     partitioning_flavor="hive",
                     existing_data_behavior="overwrite_or_ignore")
