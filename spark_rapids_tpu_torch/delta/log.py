"""Delta transaction log — the counterpart of spark_rapids_tpu/delta/log.py:
JSON commit files, Parquet checkpoints and snapshot reconstruction (the
reference rides delta-core's Snapshot and wraps commits in
GpuOptimisticTransaction, delta-24x GpuOptimisticTransaction.scala; the
engine owns the log layer itself).

Log protocol (delta protocol spec, reader version 1 / writer version 2):
    <table>/_delta_log/00000000000000000000.json     one JSON action a line
    <table>/_delta_log/<v>.checkpoint.parquet        optional, actions
    <table>/_delta_log/_last_checkpoint              {"version": v, ...}

Actions handled: metaData, add, remove, protocol, commitInfo, txn.
Commits are atomic by an O_EXCL create of the next version file, the
filesystem contract delta's HDFSLogStore relies on: a writer that loses
the race gets DeltaConcurrentModificationException (optimistic
concurrency). Every CHECKPOINT_INTERVAL-th commit writes a checkpoint in
delta-spark's struct layout; replay reads it and the older one-JSON-
action-a-row layout.

The log is host work; only the checkpoints need pyarrow, imported when
one is written or read (ImportError naming pyarrow without it).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterator, List, Optional

from ..io.multifile import need_pyarrow
from ..types import (ArrayType, BinaryType, BooleanType, ByteType, DataType,
                     DateType, DecimalType, DoubleType, FloatType,
                     IntegerType, LongType, Schema, ShortType, StringType,
                     StructField, StructType, TimestampNTZType,
                     TimestampType)

CHECKPOINT_INTERVAL = 10


class DeltaConcurrentModificationException(Exception):
    pass


# ---------------------------------------------------------------------------
# Spark schema JSON <-> engine types (delta stores the Spark JSON format)
# ---------------------------------------------------------------------------

_PRIM = {
    "long": LongType(), "integer": IntegerType(), "short": ShortType(),
    "byte": ByteType(), "double": DoubleType(), "float": FloatType(),
    "boolean": BooleanType(), "string": StringType(),
    "binary": BinaryType(), "date": DateType(),
    "timestamp": TimestampType(), "timestamp_ntz": TimestampNTZType(),
}


def type_from_json(t) -> DataType:
    if isinstance(t, str):
        if t in _PRIM:
            return _PRIM[t]
        if t.startswith("decimal("):
            p, s = t[8:-1].split(",")
            return DecimalType(int(p), int(s))
        raise ValueError(f"unsupported delta type {t!r}")
    if t.get("type") == "struct":
        return StructType(tuple(
            StructField(f["name"], type_from_json(f["type"]),
                        f.get("nullable", True))
            for f in t["fields"]))
    if t.get("type") == "array":
        return ArrayType(type_from_json(t["elementType"]))
    raise ValueError(f"unsupported delta type {t!r}")


def type_to_json(dt: DataType):
    for name, t in _PRIM.items():
        if type(t) is type(dt):
            return name
    if isinstance(dt, DecimalType):
        return f"decimal({dt.precision},{dt.scale})"
    if isinstance(dt, StructType):
        return {"type": "struct", "fields": [
            {"name": f.name, "type": type_to_json(f.data_type),
             "nullable": f.nullable, "metadata": {}}
            for f in dt.fields]}
    if isinstance(dt, ArrayType):
        return {"type": "array", "elementType": type_to_json(dt.element_type),
                "containsNull": True}
    raise ValueError(f"unsupported type {dt!r}")


def schema_to_json(schema: Schema) -> str:
    return json.dumps({"type": "struct", "fields": [
        {"name": f.name, "type": type_to_json(f.data_type),
         "nullable": f.nullable, "metadata": {}} for f in schema.fields]})


def schema_from_json(s: str) -> Schema:
    st = type_from_json(json.loads(s))
    return Schema(tuple(st.fields))


# ---------------------------------------------------------------------------
# snapshot
# ---------------------------------------------------------------------------

class AddFile:
    __slots__ = ("path", "partition_values", "size", "stats",
                 "modification_time")

    def __init__(self, path: str, partition_values: Dict[str, str],
                 size: int, stats: Optional[str] = None,
                 modification_time: int = 0):
        self.path = path
        self.partition_values = partition_values or {}
        self.size = size
        self.stats = stats
        self.modification_time = modification_time

    def to_action(self, data_change: bool = True) -> dict:
        return {"add": {
            "path": self.path, "partitionValues": self.partition_values,
            "size": self.size, "modificationTime": self.modification_time,
            "dataChange": data_change,
            **({"stats": self.stats} if self.stats else {})}}

    def parsed_stats(self) -> Optional[dict]:
        if not self.stats:
            return None
        try:
            return json.loads(self.stats)
        except ValueError:
            return None


class Snapshot:
    def __init__(self, version: int, schema: Schema,
                 partition_columns: List[str], files: List[AddFile],
                 metadata: dict):
        self.version = version
        self.schema = schema
        self.partition_columns = partition_columns
        self.files = files
        self.metadata = metadata


class DeltaLog:
    """One table's _delta_log directory."""

    def __init__(self, table_path: str):
        self.table_path = os.path.abspath(table_path)
        self.log_path = os.path.join(self.table_path, "_delta_log")

    # -- paths -------------------------------------------------------------
    def _version_file(self, v: int) -> str:
        return os.path.join(self.log_path, f"{v:020d}.json")

    def _checkpoint_file(self, v: int) -> str:
        return os.path.join(self.log_path, f"{v:020d}.checkpoint.parquet")

    def exists(self) -> bool:
        return os.path.isdir(self.log_path) and (
            os.path.exists(self._version_file(0))
            or self.last_checkpoint() is not None)

    def latest_version(self) -> int:
        if not os.path.isdir(self.log_path):
            return -1
        best = -1
        for n in os.listdir(self.log_path):
            if n.endswith(".json") and n[:20].isdigit():
                best = max(best, int(n[:20]))
        return best

    def last_checkpoint(self) -> Optional[int]:
        p = os.path.join(self.log_path, "_last_checkpoint")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(json.load(f)["version"])

    # -- replay ------------------------------------------------------------
    def _read_version_actions(self, v: int) -> Iterator[dict]:
        with open(self._version_file(v)) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)

    def _read_checkpoint(self, v: int) -> Iterator[dict]:
        pq = need_pyarrow("a Delta checkpoint read", "pyarrow.parquet")
        table = pq.read_table(self._checkpoint_file(v))
        if "action" in table.column_names:
            # the older layout: one JSON action a row
            for s in table.column("action").to_pylist():
                yield json.loads(s)
            return
        for row in table.to_pylist():
            # delta-spark's checkpoint: one struct column per action type;
            # arrow map<string,string> cells come back as [(k, v), ...]
            for key in ("metaData", "add", "remove", "protocol", "txn"):
                val = row.get(key)
                if val is not None:
                    yield {key: _strip_nones(_maps_to_dicts(val))}

    def snapshot(self, version: Optional[int] = None) -> Snapshot:
        latest = self.latest_version()
        if latest < 0 and self.last_checkpoint() is None:
            raise FileNotFoundError(
                f"{self.table_path!r} is not a delta table")
        target = latest if version is None else version
        start = 0
        actions: List[dict] = []
        cp = self.last_checkpoint()
        if cp is not None and cp <= target \
                and os.path.exists(self._checkpoint_file(cp)):
            actions.extend(self._read_checkpoint(cp))
            start = cp + 1
        for v in range(start, target + 1):
            if not os.path.exists(self._version_file(v)):
                raise FileNotFoundError(
                    f"missing delta log version {v} for {self.table_path!r}")
            actions.extend(self._read_version_actions(v))

        schema: Optional[Schema] = None
        part_cols: List[str] = []
        metadata: dict = {}
        adds: Dict[str, AddFile] = {}
        for a in actions:
            if "metaData" in a:
                md = a["metaData"]
                metadata = md
                schema = schema_from_json(md["schemaString"])
                part_cols = list(md.get("partitionColumns", []))
            elif "add" in a:
                ad = a["add"]
                adds[ad["path"]] = AddFile(
                    ad["path"], dict(ad.get("partitionValues") or {}),
                    ad.get("size", 0), ad.get("stats"),
                    ad.get("modificationTime", 0))
            elif "remove" in a:
                adds.pop(a["remove"]["path"], None)
        if schema is None:
            raise ValueError(f"no metaData action in {self.table_path!r}")
        return Snapshot(target, schema, part_cols, list(adds.values()),
                        metadata)

    # -- commit ------------------------------------------------------------
    def commit(self, actions: List[dict], expected_version: int) -> int:
        """Atomically write version `expected_version`; raises
        DeltaConcurrentModificationException if another writer won."""
        os.makedirs(self.log_path, exist_ok=True)
        path = self._version_file(expected_version)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
        except FileExistsError:
            raise DeltaConcurrentModificationException(
                f"version {expected_version} was committed concurrently")
        with os.fdopen(fd, "w") as f:
            for a in actions:
                f.write(json.dumps(a) + "\n")
        if expected_version > 0 \
                and expected_version % CHECKPOINT_INTERVAL == 0:
            self._write_checkpoint(expected_version)
        return expected_version

    def _write_checkpoint(self, v: int) -> None:
        """The Delta protocol's struct-typed checkpoint: one Parquet file
        with nullable `protocol`/`metaData`/`add` struct columns, one
        action a row (delta-spark's classic checkpoint layout), so that
        another delta reader loads the table past the checkpoint
        (delta-core Checkpoints.writeCheckpoint)."""
        pa = need_pyarrow("a Delta checkpoint write")
        pq = need_pyarrow("a Delta checkpoint write", "pyarrow.parquet")
        snap = self.snapshot(v)
        strmap = pa.map_(pa.string(), pa.string())
        protocol_t = pa.struct([
            ("minReaderVersion", pa.int32()),
            ("minWriterVersion", pa.int32())])
        metadata_t = pa.struct([
            ("id", pa.string()),
            ("name", pa.string()),
            ("description", pa.string()),
            ("format", pa.struct([("provider", pa.string()),
                                  ("options", strmap)])),
            ("schemaString", pa.string()),
            ("partitionColumns", pa.list_(pa.string())),
            ("configuration", strmap),
            ("createdTime", pa.int64())])
        add_t = pa.struct([
            ("path", pa.string()),
            ("partitionValues", strmap),
            ("size", pa.int64()),
            ("modificationTime", pa.int64()),
            ("dataChange", pa.bool_()),
            ("stats", pa.string())])
        md = dict(snap.metadata)
        fmt = md.get("format") or {}
        md_row = {
            "id": md.get("id"),
            "name": md.get("name"),
            "description": md.get("description"),
            "format": {"provider": fmt.get("provider", "parquet"),
                       "options": dict(fmt.get("options") or {})},
            "schemaString": md.get("schemaString"),
            "partitionColumns": list(md.get("partitionColumns") or []),
            "configuration": dict(md.get("configuration") or {}),
            "createdTime": md.get("createdTime")}
        proto = self.protocol_action()["protocol"]
        n_actions = 2 + len(snap.files)
        protocol_col = [proto] + [None] * (n_actions - 1)
        metadata_col = [None, md_row] + [None] * len(snap.files)
        add_col: List[Optional[dict]] = [None, None]
        for f in snap.files:
            add_col.append({
                "path": f.path,
                "partitionValues": dict(f.partition_values or {}),
                "size": f.size,
                "modificationTime": f.modification_time,
                "dataChange": False,
                "stats": f.stats})
        table = pa.table({
            "protocol": pa.array(protocol_col, protocol_t),
            "metaData": pa.array(metadata_col, metadata_t),
            "add": pa.array(add_col, add_t)})
        pq.write_table(table, self._checkpoint_file(v))
        with open(os.path.join(self.log_path, "_last_checkpoint"),
                  "w") as f:
            json.dump({"version": v, "size": n_actions}, f)

    def metadata_action(self, schema: Schema, partition_columns: List[str],
                        table_id: str) -> dict:
        return {"metaData": {
            "id": table_id,
            "format": {"provider": "parquet", "options": {}},
            "schemaString": schema_to_json(schema),
            "partitionColumns": partition_columns,
            "configuration": {},
            "createdTime": int(time.time() * 1000)}}

    @staticmethod
    def protocol_action() -> dict:
        return {"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}}

    @staticmethod
    def commit_info(operation: str, **params) -> dict:
        return {"commitInfo": {
            "timestamp": int(time.time() * 1000),
            "operation": operation,
            "operationParameters": {k: str(v) for k, v in params.items()},
            "engineInfo": "spark-rapids-tpu"}}


def _strip_nones(d: dict) -> dict:
    return {k: v for k, v in d.items() if v is not None}


def _maps_to_dicts(v):
    """Arrow map cells ([(k, v), ...]) as dicts, recursively."""
    if isinstance(v, dict):
        return {k: _maps_to_dicts(x) for k, x in v.items()}
    if isinstance(v, list):
        if v and all(isinstance(e, tuple) and len(e) == 2 for e in v):
            return {k: _maps_to_dicts(x) for k, x in v}
        return [_maps_to_dicts(e) for e in v]
    return v
