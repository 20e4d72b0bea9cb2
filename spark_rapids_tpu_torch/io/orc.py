"""ORC scan and write — the counterpart of spark_rapids_tpu/io/orc.py
(reference GpuOrcScan.scala:1455-1546 / GpuOrcFileFormat).

The scan prunes stripes with prove-absence semantics from each file's own
stripe statistics (parsed by io/orc_meta.py: pyarrow gives the stripe
count but not the statistics' values), prunes columns, and reports
`stripes_read` / `stripes_pruned`; it has ParquetSource's `with_filters`,
so the planner's pushdown (plan/overrides.py) treats both formats alike.
The decode is pyarrow's C++ ORC reader, one stripe a task on the shared
decode pool, its columns put in the order `columns` asks for (the JAX
package keeps the file's order under the asked names: ROADMAP C.5); each
table crosses to the source's device in one packed
upload a batch. Reader types: MULTITHREADED (the default) and COALESCING
(decoded stripes stitched into tables of about `batch_rows` first).

pyarrow is imported when a source or the writer is built; without it they
raise ImportError naming pyarrow.
"""

from __future__ import annotations

import datetime
import os
from typing import Iterator, Optional, Sequence, Tuple

from ..columnar.batch import ColumnarBatch
from ..columnar.column import resolve_device
from ..config import MULTITHREADED_READ_NUM_THREADS, active_conf
from ..types import Schema, StructField, from_arrow
from .multifile import (DRIVE_STATS, arrow_to_batches, expand_paths,
                        need_pyarrow, reset_drive_stats, threaded_chunks,
                        timed_tasks)
from .orc_meta import OrcFileMeta
from .parquet import DEFAULT_BATCH_ROWS, coalesced_batches, _stats_can_skip


def _orc():
    return need_pyarrow("the ORC reader", "pyarrow.orc")


def _to_stat_literal(value) -> object:
    """A pushed literal in the domain of ORC's statistics (a date as its
    day number; everything else compares as it is)."""
    if isinstance(value, datetime.date) \
            and not isinstance(value, datetime.datetime):
        return (value - datetime.date(1970, 1, 1)).days
    return value


class OrcSource:
    """A scan's source over ORC files; batches land on `device` (default:
    the card)."""

    def __init__(self, path, conf=None,
                 columns: Optional[Sequence[str]] = None,
                 num_threads: Optional[int] = None,
                 batch_rows: int = DEFAULT_BATCH_ROWS,
                 filters: Optional[Sequence[Tuple[str, str, object]]] = None,
                 reader_type: Optional[str] = None, device=None):
        paorc = _orc()
        self.paths = expand_paths(path)
        if not self.paths:
            raise FileNotFoundError(f"no orc files at {path!r}")
        conf = conf or active_conf()
        self.columns = list(columns) if columns is not None else None
        self.num_threads = conf.get(MULTITHREADED_READ_NUM_THREADS) \
            if num_threads is None else num_threads
        self.batch_rows = batch_rows
        self.filters = list(filters or [])
        self.reader_type = (reader_type or "MULTITHREADED").upper()
        self.device = resolve_device(device)
        arrow_schema = paorc.ORCFile(self.paths[0]).schema
        fields = []
        for name in (self.columns or arrow_schema.names):
            fld = arrow_schema.field(name)
            fields.append(StructField(fld.name, from_arrow(fld.type),
                                      fld.nullable))
        self.schema = Schema(tuple(fields))
        #: set by the last batches() drive; shared with with_filters()
        #: copies, as ParquetSource's is: the stripes read and pruned,
        #: and multifile.DRIVE_STATS
        self.scan_stats = {"stripes_read": 0, "stripes_pruned": 0,
                           **dict.fromkeys(DRIVE_STATS, 0)}

    @property
    def stripes_read(self) -> int:
        return self.scan_stats["stripes_read"]

    @property
    def stripes_pruned(self) -> int:
        return self.scan_stats["stripes_pruned"]

    def with_filters(self, filters: Sequence[Tuple[str, str, object]]
                     ) -> "OrcSource":
        """A copy that also prunes stripes with these conjuncts
        (statistics prove absence only: the filter stays above)."""
        out = OrcSource.__new__(OrcSource)
        out.__dict__.update(self.__dict__)
        out.filters = list(self.filters) + list(filters)
        return out

    def estimated_size_bytes(self) -> int:
        return sum(os.path.getsize(p) for p in self.paths)

    def _stripe_pruned(self, per_name) -> bool:
        for name, op, value in self.filters:
            stats = per_name.get(name)
            if stats is None:
                continue
            if _stats_can_skip(stats, op, _to_stat_literal(value)):
                return True
        return False

    def batches(self) -> Iterator[ColumnarBatch]:
        paorc = _orc()
        import pyarrow as pa
        tasks = []
        self.scan_stats["stripes_read"] = 0
        self.scan_stats["stripes_pruned"] = 0
        reset_drive_stats(self.scan_stats)
        may_prune = bool(self.filters)
        for p in self.paths:
            n = paorc.ORCFile(p).nstripes
            meta = OrcFileMeta(p) if may_prune and n > 0 else None
            stats = meta.stripe_stats if meta is not None and meta.ok \
                else []
            for s in range(n):
                if s < len(stats) and self._stripe_pruned(stats[s]):
                    self.scan_stats["stripes_pruned"] += 1
                    continue
                self.scan_stats["stripes_read"] += 1

                def decode(p=p, s=s):
                    # a handle per task: ORCFile is not thread-safe
                    return paorc.ORCFile(p).read_stripe(
                        s, columns=self.columns)
                tasks.append(decode)
            if n == 0:
                tasks.append(lambda p=p: paorc.ORCFile(p).read(
                    columns=self.columns))

        tasks = timed_tasks(tasks, self.scan_stats)

        def tables():
            for item in threaded_chunks(tasks, self.num_threads):
                table = pa.Table.from_batches([item]) \
                    if isinstance(item, pa.RecordBatch) else item
                # pyarrow's ORC reader keeps the file's column order:
                # put the columns in the order asked for (ROADMAP C.5)
                yield table.select(self.columns) if self.columns \
                    else table

        if self.reader_type == "COALESCING":
            yield from coalesced_batches(tables(), self.batch_rows,
                                         self.device, self.scan_stats)
        else:
            for table in tables():
                yield from arrow_to_batches(table, self.batch_rows,
                                            self.device,
                                            stats=self.scan_stats)


def write_orc(df, path, compression: Optional[str] = None,
              stripe_size: Optional[int] = None):
    """DataFrame -> one ORC file (reference GpuOrcFileFormat's writer;
    the table comes from `df.to_arrow()`: one fetch a batch)."""
    paorc = need_pyarrow("the ORC writer", "pyarrow.orc")
    table = df.to_arrow()
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    kw = {}
    if compression is not None:
        kw["compression"] = compression
    if stripe_size is not None:
        kw["stripe_size"] = stripe_size
    paorc.write_table(table, path, **kw)
