"""Delta table scan, write and DML commands — the counterpart of
spark_rapids_tpu/delta/table.py (reference delta-24x GpuDeltaCatalog /
GpuOptimisticTransaction.scala for writes with stats collection,
GpuDeleteCommand / GpuUpdateCommand / GpuMergeIntoCommand.scala for
copy-on-write DML, re-expressed over the engine's DataFrame planner).

Scan: the snapshot's files, each a Parquet read decoded on the host, its
partition values added as columns there, and the batch uploaded to the
session's device in one packed copy. File skipping takes partition values
and the add actions' min/max/nullCount stats through the `with_filters`
hook the planner uses for Parquet pushdown, so a `filter(...)` over a
delta scan prunes whole files.

DML is copy-on-write: only files with affected rows are rewritten, and
commits are optimistic (DeltaConcurrentModificationException on a lost
race). Each command's per-file rewrite is a named function from
DataFrames to the rewritten DataFrame, a device plan: `delete_rewrite`
(a filter), `update_rewrite` (an If projection), `merge_rewrite` (a left
outer join against the marked source, a filter and a projection) and
`zorder_rewrite` (a sort by InterleaveBits). The counts the commands
report come from device plans too: the JAX package turns a MERGE's target
rows into Python tuples to find the matched keys, the port counts them
with a left semi join (`merge_hit_count`) and finds the rows to insert
with a left anti join (`merge_insert_rows`); NULL keys never match.

The data files and checkpoints go through pyarrow (ImportError naming it
without), so Delta's file layer runs where pyarrow is installed.
Partition values cross as Delta's strings (`__HIVE_DEFAULT_PARTITION__`
for a NULL directory): a DATE or TIMESTAMP as its isoformat, a DECIMAL as
its digits, and the port reads all three back (ROADMAP C.5: the JAX
package reads neither a TIMESTAMP nor a DECIMAL one). A DECIMAL column's
stats keep its nullCount and no min/max (the JAX package cannot write a
DECIMAL column: its stats JSON raises on the Decimal value).
"""

from __future__ import annotations

import datetime as _dt
import decimal
import json
import os
import time
import uuid
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, build_column, resolve_device
from ..config import RapidsConf
from ..expr.core import Expression, col, lit
from ..expr.predicates import EqualNullSafe, IsNotNull, Not
from ..io.multifile import (DRIVE_STATS, add_stat, need_pyarrow,
                            reset_drive_stats, timed_upload)
from ..types import (BooleanType, ByteType, DataType, DateType, DecimalType,
                     DoubleType, FloatType, IntegerType, LongType, Schema,
                     ShortType, TimestampNTZType, TimestampType)
from .log import AddFile, DeltaLog, Snapshot

_MARKER = "__delta_src_match"
_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def _parse_partition_value(raw: Optional[str], dt: DataType):
    if raw is None:
        return None
    if isinstance(dt, (ByteType, IntegerType, LongType, ShortType)):
        return int(raw)
    if isinstance(dt, (DoubleType, FloatType)):
        return float(raw)
    if isinstance(dt, BooleanType):
        return raw.lower() == "true"
    if isinstance(dt, DateType):
        return (_dt.date.fromisoformat(raw) - _dt.date(1970, 1, 1)).days
    if isinstance(dt, (TimestampType, TimestampNTZType)):
        ts = _dt.datetime.fromisoformat(raw)
        if ts.tzinfo is None:
            ts = ts.replace(tzinfo=_dt.timezone.utc)
        return (ts - _EPOCH) // _dt.timedelta(microseconds=1)
    if isinstance(dt, DecimalType):
        return int(decimal.Decimal(raw).scaleb(dt.scale))
    return raw  # string


def _fmt_partition_value(v, dt: DataType) -> Optional[str]:
    if v is None:
        return None
    if isinstance(v, _dt.date):  # arrow's DATE and TIMESTAMP values
        return v.isoformat()
    if isinstance(dt, DateType):
        return (_dt.date(1970, 1, 1) + _dt.timedelta(days=int(v))
                ).isoformat()
    if isinstance(dt, BooleanType):
        return "true" if v else "false"
    return str(v)


class DeltaSource:
    """Scan source over one snapshot (plugs into LogicalScan; the planner
    pushes filter conjuncts through `with_filters` for file skipping);
    batches land on `device` (default: the card)."""

    def __init__(self, log: DeltaLog, snapshot: Snapshot,
                 conf: Optional[RapidsConf] = None,
                 filters: Optional[Sequence[Tuple[str, str, object]]] = None,
                 files: Optional[List[AddFile]] = None, device=None):
        self.log = log
        self.snap = snapshot
        self.schema = snapshot.schema
        self._conf = conf
        self.filters = list(filters or [])
        self._files = files  # an explicit file subset (DML rewrites)
        self.device = resolve_device(device)
        #: the last drive's files read and pruned, and
        #: multifile.DRIVE_STATS (the data files' host decode, the host
        #: build of their batches with the partition columns, the uploads)
        self.scan_stats = {"files_read": 0, "files_pruned": 0,
                           **dict.fromkeys(DRIVE_STATS, 0)}

    def with_filters(self, filters) -> "DeltaSource":
        out = DeltaSource(self.log, self.snap, self._conf,
                          list(self.filters) + list(filters), self._files,
                          self.device)
        out.scan_stats = self.scan_stats
        return out

    def estimated_size_bytes(self) -> int:
        return sum(f.size for f in (self._files or self.snap.files))

    # -- file skipping -----------------------------------------------------
    def _file_pruned(self, f: AddFile) -> bool:
        part_cols = set(self.snap.partition_columns)
        stats = f.parsed_stats()
        for (name, op, value) in self.filters:
            if name in part_cols:
                dt = self.schema.fields[self.schema.index_of(name)].data_type
                pv = _parse_partition_value(
                    f.partition_values.get(name), dt)
                if op == "is_null":
                    if pv is not None:
                        return True
                elif op == "is_not_null":
                    if pv is None:
                        return True
                elif pv is None:
                    return True  # a comparison with NULL is never true
                elif op == "==" and pv != value:
                    return True
                elif op == "<" and not (pv < value):
                    return True
                elif op == "<=" and not (pv <= value):
                    return True
                elif op == ">" and not (pv > value):
                    return True
                elif op == ">=" and not (pv >= value):
                    return True
            elif stats:
                mn = (stats.get("minValues") or {}).get(name)
                mx = (stats.get("maxValues") or {}).get(name)
                if name in self.schema.names and isinstance(
                        self.schema.fields[self.schema.index_of(name)]
                        .data_type, DateType) and isinstance(value, int):
                    # a DATE's stats are ISO strings, its literal a day
                    # number (ROADMAP C.24)
                    mn, mx = ((_dt.date.fromisoformat(v)
                               - _EPOCH.date()).days
                              if isinstance(v, str) else v
                              for v in (mn, mx))
                nc = (stats.get("nullCount") or {}).get(name)
                nr = stats.get("numRecords")
                if op == "is_null" and nc == 0:
                    return True
                if op == "is_not_null" and nc is not None \
                        and nc == nr:
                    return True
                if mn is None or mx is None:
                    continue
                try:
                    if op == "==" and (value < mn or value > mx):
                        return True
                    if op == "<" and mn >= value:
                        return True
                    if op == "<=" and mn > value:
                        return True
                    if op == ">" and mx <= value:
                        return True
                    if op == ">=" and mx < value:
                        return True
                except TypeError:
                    continue  # a DATE's ISO string against its day number
        return False

    # -- scan --------------------------------------------------------------
    def files_after_skipping(self) -> List[AddFile]:
        out = []
        self.scan_stats["files_read"] = 0
        self.scan_stats["files_pruned"] = 0
        reset_drive_stats(self.scan_stats)
        for f in (self._files if self._files is not None
                  else self.snap.files):
            if self.filters and self._file_pruned(f):
                self.scan_stats["files_pruned"] += 1
                continue
            self.scan_stats["files_read"] += 1
            out.append(f)
        return out

    def batches(self) -> Iterator[ColumnarBatch]:
        for f in self.files_after_skipping():
            yield from self._read_file(f)

    def _read_file(self, f: AddFile) -> Iterator[ColumnarBatch]:
        """One data file's batches: decoded on the host (row groups pruned
        by the data columns' pushed conjuncts), the partition columns
        built there, all uploaded in one packed copy a batch."""
        from ..io.parquet import ParquetSource
        path = os.path.join(self.log.table_path, f.path)
        part_cols = self.snap.partition_columns
        data_cols = [c for c in self.schema.names if c not in part_cols]
        src = ParquetSource(path, self._conf, columns=data_cols,
                            filters=[flt for flt in self.filters
                                     if flt[0] in data_cols], device="cpu")
        st = self.scan_stats
        for b in src.batches():
            t0 = time.perf_counter_ns()
            n = b.num_rows_host
            cols: List[Column] = []
            for fld in self.schema.fields:
                if fld.name in part_cols:
                    v = _parse_partition_value(
                        f.partition_values.get(fld.name), fld.data_type)
                    cols.append(build_column([v] * n, fld.data_type,
                                             b.capacity, "cpu"))
                else:
                    cols.append(b.column(fld.name))
            yield timed_upload(cols, n, self.schema, self.device, st, t0)
        # the file's own decode and its host batches' build
        inner = src.scan_stats
        add_stat(st, "decode_ns", inner["decode_ns"])
        add_stat(st, "build_ns", inner["build_ns"] + inner["upload_ns"])


# ---------------------------------------------------------------------------
# write path with stats collection
# ---------------------------------------------------------------------------

def _collect_stats(table) -> str:
    """Per-file stats JSON from a pyarrow table (reference
    GpuStatisticsCollection: numRecords/min/max/nullCount drive data
    skipping on later reads)."""
    pc = need_pyarrow("Delta's file stats", "pyarrow.compute")
    mins: Dict[str, object] = {}
    maxs: Dict[str, object] = {}
    nulls: Dict[str, int] = {}
    for name in table.column_names:
        column = table.column(name)
        nulls[name] = column.null_count
        if column.length() - column.null_count == 0:
            continue
        try:
            mn = pc.min(column).as_py()
            mx = pc.max(column).as_py()
        except Exception:  # noqa: BLE001 — a type with no order: no stats
            continue
        for out, v in ((mins, mn), (maxs, mx)):
            if isinstance(v, _dt.date):  # DATE and TIMESTAMP
                v = v.isoformat()
            elif isinstance(v, (bytes, decimal.Decimal)):
                continue
            out[name] = v
    return json.dumps({"numRecords": table.num_rows, "minValues": mins,
                       "maxValues": maxs, "nullCount": nulls})


def _write_parquet_file(table_path: str, rel_dir: str, sub,
                        pvals: Dict[str, Optional[str]],
                        data_change: bool = True) -> AddFile:
    pq = need_pyarrow("Delta's data files", "pyarrow.parquet")
    name = f"part-{uuid.uuid4().hex}.snappy.parquet"
    rel = os.path.join(rel_dir, name) if rel_dir else name
    full = os.path.join(table_path, rel)
    os.makedirs(os.path.dirname(full), exist_ok=True)
    pq.write_table(sub, full)
    return AddFile(rel.replace(os.sep, "/"), pvals, os.path.getsize(full),
                   _collect_stats(sub), int(os.path.getmtime(full) * 1000))


def _write_data_files(df, table_path: str, partition_by: List[str]
                      ) -> List[AddFile]:
    """A DataFrame as Parquet data files and their AddFile actions (one
    file a partition tuple, hive-style directories, or one file)."""
    need_pyarrow("Delta's data files")
    table = df.to_arrow()
    if not partition_by:
        return [_write_parquet_file(table_path, "", table, {})] \
            if table.num_rows else []
    schema = df.schema
    # rows grouped by their partition tuple on the host
    pcols = [table.column(c).to_pylist() for c in partition_by]
    data_cols = [c for c in table.column_names if c not in partition_by]
    groups: Dict[tuple, List[int]] = {}
    for i, key in enumerate(zip(*pcols)):
        groups.setdefault(key, []).append(i)
    adds = []
    for key, idxs in groups.items():
        pvals, parts = {}, []
        for c, v in zip(partition_by, key):
            dt = schema.fields[schema.index_of(c)].data_type
            sv = v if isinstance(v, str) else _fmt_partition_value(v, dt)
            pvals[c] = sv
            parts.append(
                f"{c}={'__HIVE_DEFAULT_PARTITION__' if sv is None else sv}")
        adds.append(_write_parquet_file(
            table_path, os.path.join(*parts),
            table.take(idxs).select(data_cols), pvals))
    return adds


def write_delta(df, path: str, mode: str = "append",
                partition_by: Optional[Sequence[str]] = None) -> None:
    """DataFrame -> delta table (append / overwrite / error-if-exists
    semantics of Spark's DataFrameWriter). A write into an existing table
    takes the table's partition columns, as Delta's writer does; naming
    others raises (ROADMAP C.26)."""
    need_pyarrow("write_delta")
    log = DeltaLog(path)
    partition_by = list(partition_by or [])
    exists = log.exists()
    if mode == "error" and exists:
        raise FileExistsError(f"delta table {path!r} already exists")
    if exists:
        table_parts = log.snapshot().partition_columns
        if partition_by and partition_by != table_parts:
            raise ValueError(
                f"partition columns {partition_by} do not match the "
                f"table's {table_parts}")
        partition_by = list(table_parts)
    os.makedirs(path, exist_ok=True)
    adds = _write_data_files(df, log.table_path, partition_by)
    actions: List[dict] = [DeltaLog.commit_info(
        "WRITE", mode=mode, partitionBy=json.dumps(partition_by))]
    if not exists:
        actions.append(DeltaLog.protocol_action())
        actions.append(log.metadata_action(df.schema, partition_by,
                                           str(uuid.uuid4())))
        version = 0
    else:
        snap = log.snapshot()
        if snap.schema.names != df.schema.names:
            raise ValueError(
                f"schema mismatch: table {snap.schema.names} "
                f"vs data {df.schema.names}")
        version = snap.version + 1
        if mode == "overwrite":
            for f in snap.files:
                actions.append({"remove": {
                    "path": f.path, "dataChange": True,
                    "deletionTimestamp": 0}})
    actions.extend(a.to_action() for a in adds)
    log.commit(actions, version)


def read_delta(session, path: str, version: Optional[int] = None):
    """The table at `version` (default: the latest) as a DataFrame whose
    scan lands on the session's device."""
    from ..plan import logical as L
    need_pyarrow("read_delta")
    log = DeltaLog(path)
    snap = log.snapshot(version)
    return session._df(L.LogicalScan(DeltaSource(
        log, snap, session.conf, device=session.device)))


# ---------------------------------------------------------------------------
# the per-file rewrites: device plans over DataFrames
# ---------------------------------------------------------------------------

def _is_true(cond: Expression) -> Expression:
    """cond IS TRUE: NULL and false are not."""
    return EqualNullSafe(cond, lit(True))


def delete_rewrite(file_df, cond: Expression):
    """DELETE's rows of a file: those where `cond` is not TRUE (NULL and
    false rows stay)."""
    return file_df.filter(Not(_is_true(cond)))


def match_count(file_df, cond: Expression) -> int:
    """The rows of a file where `cond` is TRUE."""
    return file_df.filter(_is_true(cond)).count()


def update_rewrite(file_df, schema: Schema, sets: Dict[str, Expression],
                   cond: Expression):
    """UPDATE's rows of a file: each column in `sets` takes its
    expression, cast to the column's type, where `cond` is TRUE."""
    from ..expr.conditional import If
    is_match = _is_true(cond)
    return file_df.select(*[
        If(is_match, sets[f.name].cast(f.data_type),
           col(f.name)).alias(f.name) if f.name in sets else col(f.name)
        for f in schema.fields])


def marked_source(source_df):
    """MERGE's source with its columns renamed `__s_<name>` (the update
    expressions name them so) and the match marker, TRUE on every row."""
    return source_df.select(*[
        col(c).alias(f"__s_{c}") for c in source_df.columns]).with_column(
        _MARKER, lit(True))


def merge_rewrite(file_df, marked, on: Sequence[str],
                  update: Optional[Dict[str, object]], delete: bool):
    """MERGE's rows of a file: a left outer join against the marked source
    on the keys, the matched rows dropped (`delete`) or their `update`
    columns set from expressions over the `__s_` columns, in the file's
    schema."""
    from ..api.session import _to_expr
    from ..expr.conditional import If
    schema = file_df.schema
    out = file_df.join(marked, left_on=list(on),
                       right_on=[f"__s_{k}" for k in on], how="left_outer")
    is_matched = IsNotNull(col(_MARKER))
    if delete:
        out = out.filter(Not(_is_true(is_matched)))
    exprs = []
    for f in schema.fields:
        if update and f.name in update:
            exprs.append(If(is_matched,
                            _to_expr(update[f.name]).cast(f.data_type),
                            col(f.name)).alias(f.name))
        else:
            exprs.append(col(f.name))
    return out.select(*exprs)


def merge_hit_count(file_df, marked, on: Sequence[str]) -> int:
    """The rows of a file whose keys match a source row (a left semi
    join against the marked source's keys: a NULL key never matches)."""
    keys = [f"__s_{k}" for k in on]
    return file_df.join(marked.select(*keys), left_on=list(on),
                        right_on=keys, how="left_semi").count()


def merge_insert_rows(source_df, target_df, on: Sequence[str],
                      schema: Schema):
    """MERGE's rows to insert: the source rows whose keys match no target
    row (a left anti join: a NULL key matches nothing, so its row is
    inserted; every row when there is no target), in the table's schema."""
    if target_df is not None:
        keys = target_df.select(*[col(k).alias(f"__t_{k}") for k in on])
        source_df = source_df.join(keys, left_on=list(on),
                                   right_on=[f"__t_{k}" for k in on],
                                   how="left_anti")
    return _in_schema(source_df, schema)


def _in_schema(df, schema: Schema):
    """df's columns as the table's: cast where the types differ, NULL for
    a column df lacks."""
    src = df.schema
    exprs = []
    for f in schema.fields:
        if f.name not in src.names:
            exprs.append(lit(None).cast(f.data_type).alias(f.name))
        elif src.fields[src.index_of(f.name)].data_type != f.data_type:
            exprs.append(col(f.name).cast(f.data_type).alias(f.name))
        else:
            exprs.append(col(f.name))
    return df.select(*exprs)


def zorder_rewrite(df, keys: Sequence[str], names: Sequence[str]):
    """OPTIMIZE ZORDER BY's rows: sorted by InterleaveBits of `keys`
    (reference zorder/ZOrderRules), in the columns `names`. InterleaveBits
    takes integral keys: a DATE key enters as its day number (ROADMAP
    C.5: the JAX package cannot plan a DATE key)."""
    from ..expr.core import Literal
    from ..expr.datetimeexprs import DateDiff
    from ..expr.zorder import InterleaveBits
    from ..types import DATE

    def rank(name):
        dt = df.schema.fields[df.schema.index_of(name)].data_type
        return DateDiff(col(name), Literal(0, DATE)) \
            if isinstance(dt, DateType) else col(name)
    code = InterleaveBits(*[rank(c) for c in keys])
    return (df.with_column("__zorder", code).sort("__zorder")
            .select(*[col(n) for n in names]))


# ---------------------------------------------------------------------------
# DML commands (copy-on-write)
# ---------------------------------------------------------------------------

class DeltaTable:
    """DML entry point (reference GpuDeleteCommand / GpuUpdateCommand /
    GpuMergeIntoCommand)."""

    def __init__(self, session, path: str):
        self.session = session
        self.log = DeltaLog(path)

    @staticmethod
    def for_path(session, path: str) -> "DeltaTable":
        return DeltaTable(session, path)

    def to_df(self):
        return read_delta(self.session, self.log.table_path)

    def history(self) -> List[dict]:
        out = []
        for v in range(self.log.latest_version() + 1):
            for a in self.log._read_version_actions(v):
                if "commitInfo" in a:
                    out.append({"version": v, **a["commitInfo"]})
        return out

    # -- shared rewrite machinery -----------------------------------------
    def _snapshot_df(self, snap: Snapshot,
                     files: Optional[List[AddFile]] = None):
        from ..plan import logical as L
        return self.session._df(L.LogicalScan(DeltaSource(
            self.log, snap, self.session.conf, files=files,
            device=self.session.device)))

    def _file_df(self, snap: Snapshot, f: AddFile):
        return self._snapshot_df(snap, [f])

    def _rewrite(self, snap: Snapshot, f: AddFile, new_df) -> List[dict]:
        """Remove the old file and add the rewritten rows, each in the
        partition its values now name: an UPDATE or MERGE that sets a
        partition column moves its rows, as Delta's copy-on-write writes
        them (ROADMAP C.25)."""
        actions = [{"remove": {"path": f.path, "dataChange": True,
                               "deletionTimestamp": 0}}]
        actions.extend(a.to_action() for a in _write_data_files(
            new_df, self.log.table_path, snap.partition_columns))
        return actions

    def _matching_files(self, snap: Snapshot, condition: Expression
                        ) -> List[AddFile]:
        """Candidate files by the same skipping stats the scan uses."""
        from ..plan.overrides import extract_pushable_filters
        src = DeltaSource(self.log, snap, self.session.conf,
                          device=self.session.device)
        pushed = extract_pushable_filters(condition, snap.schema)
        if pushed:
            src = src.with_filters(pushed)
        return src.files_after_skipping()

    # -- DELETE ------------------------------------------------------------
    def delete(self, condition) -> int:
        """DELETE FROM t WHERE cond (reference GpuDeleteCommand): rows
        where cond is TRUE are removed; NULL/false rows stay."""
        from ..api.session import _to_expr
        need_pyarrow("DeltaTable.delete")
        cond = _to_expr(condition)
        snap = self.log.snapshot()
        actions: List[dict] = [DeltaLog.commit_info("DELETE")]
        deleted = 0
        for f in self._matching_files(snap, cond):
            total = self._file_df(snap, f).count()
            kept_df = delete_rewrite(self._file_df(snap, f), cond)
            kept = kept_df.count()
            if kept == total:
                continue
            deleted += total - kept
            actions.extend(self._rewrite(snap, f, kept_df))
        if len(actions) > 1:
            self.log.commit(actions, snap.version + 1)
        return deleted

    # -- UPDATE ------------------------------------------------------------
    def update(self, set: Dict[str, object], condition=None) -> int:
        """UPDATE t SET col=expr [WHERE cond] (reference
        GpuUpdateCommand)."""
        from ..api.session import _to_expr
        need_pyarrow("DeltaTable.update")
        cond = _to_expr(condition) if condition is not None else lit(True)
        sets = {k: _to_expr(v) for k, v in set.items()}
        snap = self.log.snapshot()
        actions: List[dict] = [DeltaLog.commit_info("UPDATE")]
        updated = 0
        for f in self._matching_files(snap, cond):
            n_match = match_count(self._file_df(snap, f), cond)
            if n_match == 0:
                continue
            updated += n_match
            actions.extend(self._rewrite(snap, f, update_rewrite(
                self._file_df(snap, f), snap.schema, sets, cond)))
        if len(actions) > 1:
            self.log.commit(actions, snap.version + 1)
        return updated

    # -- OPTIMIZE ----------------------------------------------------------
    def optimize(self, zorder_by: Optional[Sequence[str]] = None) -> int:
        """OPTIMIZE [ZORDER BY cols]: the table's files rewritten as one
        compacted file a partition tuple, z-order-clustered when keys are
        given (reference delta-lake OPTIMIZE + zorder/ZOrderRules: sorted
        by InterleaveBits of the keys so that file min/max stats skip on
        those columns; ROADMAP C.5: over two or more keys below 2**32
        every row gets one code, so the order is the input's). Returns the
        number of files removed."""
        need_pyarrow("DeltaTable.optimize")
        snap = self.log.snapshot()
        if not snap.files:
            return 0
        df = self._snapshot_df(snap)
        if zorder_by:
            df = zorder_rewrite(df, zorder_by, snap.schema.names)
        adds = _write_data_files(df, self.log.table_path,
                                 snap.partition_columns)
        actions: List[dict] = [DeltaLog.commit_info(
            "OPTIMIZE", zOrderBy=json.dumps(list(zorder_by or [])))]
        for f in snap.files:
            actions.append({"remove": {"path": f.path, "dataChange": False,
                                       "deletionTimestamp": 0}})
        # a rearrangement only: the adds are dataChange=false too, or CDC
        # and streaming readers reprocess every compacted row (Delta's
        # OPTIMIZE contract)
        actions.extend(a.to_action(data_change=False) for a in adds)
        self.log.commit(actions, snap.version + 1)
        return len(snap.files)

    # -- MERGE -------------------------------------------------------------
    def merge(self, source_df, on: Sequence[str]) -> "_MergeBuilder":
        """MERGE INTO t USING source ON t.k = s.k (an equi-merge; reference
        GpuMergeIntoCommand / GpuRapidsProcessDeltaMergeJoinExec)."""
        return _MergeBuilder(self, source_df, list(on))


class _MergeBuilder:
    def __init__(self, table: DeltaTable, source_df, on: List[str]):
        self.table = table
        self.source = source_df
        self.on = on
        self._update: Optional[Dict[str, object]] = None
        self._delete = False
        self._insert: Optional[Dict[str, object]] = None

    def when_matched_update(self, set: Dict[str, object]
                            ) -> "_MergeBuilder":
        self._update = set
        return self

    def when_matched_delete(self) -> "_MergeBuilder":
        self._delete = True
        return self

    def when_not_matched_insert(self, values: Optional[Dict[str, object]]
                                = None) -> "_MergeBuilder":
        self._insert = values if values is not None else {}
        return self

    def execute(self) -> Dict[str, int]:
        need_pyarrow("MERGE")
        t = self.table
        snap = t.log.snapshot()
        # one source row a key, or the merge is ambiguous (Spark raises)
        if (key_rows_max(self.source, self.on).collect()[0][0] or 0) > 1:
            raise ValueError(
                "MERGE: multiple source rows match the same key")
        marked = marked_source(self.source)
        stats = {"updated": 0, "deleted": 0, "inserted": 0}
        actions: List[dict] = [DeltaLog.commit_info("MERGE")]
        for f in snap.files:
            n_hit_rows = merge_hit_count(t._file_df(snap, f), marked,
                                         self.on)
            if n_hit_rows == 0:
                continue
            if self._delete:
                stats["deleted"] += n_hit_rows
            if self._update:
                stats["updated"] += n_hit_rows
            actions.extend(t._rewrite(snap, f, merge_rewrite(
                t._file_df(snap, f), marked, self.on, self._update,
                self._delete)))

        if self._insert is not None:
            ins_df = merge_insert_rows(
                self.source, t._snapshot_df(snap) if snap.files else None,
                self.on, snap.schema)
            n_ins = ins_df.count()
            if n_ins:
                if self._insert:
                    raise ValueError(
                        "explicit insert expressions not supported;"
                        " use column-name mapping")
                adds = _write_data_files(ins_df, t.log.table_path,
                                         snap.partition_columns)
                actions.extend(a.to_action() for a in adds)
                stats["inserted"] = n_ins

        if len(actions) > 1:
            t.log.commit(actions, snap.version + 1)
        return stats


def key_rows_max(source_df, on: Sequence[str]):
    """The most source rows that share one key, as a one-row frame (NULL
    when there are no rows); NULL keys group together, as Spark groups
    them."""
    from ..expr.aggexprs import Count, Max
    per_key = source_df.group_by(*on).agg((Count(), "__c"))
    return per_key.agg((Max(col("__c")), "__m"))
