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

pyarrow is imported only when a reader is built, so the package imports
without it; building one without pyarrow raises ImportError. Waiting for
their slices: the writer (`write_parquet`, ROADMAP A.5) and the LEGACY
datetime rebase on read (ROADMAP A.8).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

from ..columnar.batch import ColumnarBatch
from ..columnar.column import resolve_device
from ..types import Schema, StructField
from ..config import (MULTITHREADED_READ_NUM_THREADS, PARQUET_READER_TYPE,
                      SCAN_ENCODED, active_conf)
from .multifile import arrow_to_batches, expand_paths, threaded_chunks

READER_TYPES = ("MULTITHREADED", "COALESCING", "PERFILE")
#: rows per emitted batch
DEFAULT_BATCH_ROWS = 1 << 20

#: pushed predicate ops: (column name, op, literal)
_PRUNE_OPS = ("<", "<=", ">", ">=", "==", "is_null", "is_not_null")


def _parquet():
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError("the Parquet reader needs pyarrow, which is not "
                          "installed") from e
    return pq


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
    mn, mx = stats.min, stats.max
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
        self.device = resolve_device(device)
        arrow_schema = pq.read_schema(self.paths[0])
        fields = []
        for name in (self.columns or arrow_schema.names):
            f = arrow_schema.field(name)
            fields.append(StructField(f.name, from_arrow(f.type), f.nullable))
        self.schema = Schema(tuple(fields))
        #: set by the last batches() drive; shared with with_filters()
        #: copies, so the source the user holds sees the effect
        self.scan_stats = {"row_groups_read": 0, "row_groups_pruned": 0}

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
        pq = _parquet()
        tasks = []
        self.scan_stats["row_groups_read"] = 0
        self.scan_stats["row_groups_pruned"] = 0
        read_dict = self._read_dictionary()
        for p in self.paths:
            md = pq.ParquetFile(p).metadata
            name_to_idx = {md.schema.column(i).name: i
                           for i in range(md.num_columns)}
            for rg in range(md.num_row_groups):
                if self.filters and self._group_pruned(md, rg, name_to_idx):
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
        if self.reader_type == "COALESCING":
            yield from self._coalescing_drive(tasks)
            return
        for table in threaded_chunks(tasks, self.num_threads):
            yield from arrow_to_batches(table, self.batch_rows, self.device,
                                        self.encoded)

    def _coalescing_drive(self, tasks) -> Iterator[ColumnarBatch]:
        """Decoded row groups stitched on the host into tables of about
        batch_rows before the upload (reference COALESCING reader,
        GpuMultiFileReader.scala:830)."""
        import pyarrow as pa
        pending: List = []
        pending_rows = 0
        for table in threaded_chunks(tasks, self.num_threads):
            pending.append(table)
            pending_rows += table.num_rows
            if pending_rows >= self.batch_rows:
                yield from arrow_to_batches(pa.concat_tables(pending),
                                            self.batch_rows, self.device,
                                            self.encoded)
                pending, pending_rows = [], 0
        if pending:
            yield from arrow_to_batches(pa.concat_tables(pending),
                                        self.batch_rows, self.device,
                                        self.encoded)
