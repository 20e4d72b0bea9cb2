"""Iceberg tables — the counterpart of spark_rapids_tpu/io/iceberg.py
(reference: sql-plugin's iceberg/ package and IcebergProvider.scala, a
DSv2 scan over Iceberg's metadata). The same subset: format-version-1
tables, a snapshot's scan through the metadata chain

    metadata/vN.metadata.json -> snapshot.manifest-list (avro)
      -> manifests (avro, nested data_file records) -> parquet data files

decoded with the port's own avro row codec (io/avro.py) and read through
ParquetSource on the source's device. An append or overwrite writer makes
the same chain, so a round trip needs no Iceberg library; positional and
equality deletes and schema evolution are out of scope (they raise).

The data files go through pyarrow: building a source or writing without
it raises ImportError naming pyarrow.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Iterator, List, Optional

from ..columnar.batch import ColumnarBatch
from ..columnar.column import resolve_device
from ..types import (BooleanType, DateType, DoubleType, FloatType,
                     IntegerType, LongType, Schema, StringType, StructField,
                     TimestampType)
from .avro import read_avro_rows, write_avro_rows
from .multifile import DRIVE_STATS, need_pyarrow

_TYPE_TO_ICE = {LongType: "long", IntegerType: "int", DoubleType: "double",
                FloatType: "float", BooleanType: "boolean",
                StringType: "string", DateType: "date",
                TimestampType: "timestamp"}
_ICE_TO_TYPE = {v: k() for k, v in _TYPE_TO_ICE.items()}


def _schema_from_iceberg(fields: List[dict]) -> Schema:
    out = []
    for f in fields:
        t = f["type"]
        if not isinstance(t, str) or t not in _ICE_TO_TYPE:
            raise ValueError(
                f"unsupported iceberg type {t!r} for {f['name']!r} "
                "(nested/decimal types pending)")
        out.append(StructField(f["name"], _ICE_TO_TYPE[t],
                               not f.get("required", False)))
    return Schema(tuple(out))


# the metadata chain's avro schemas (the required v1 subset)
_MANIFEST_LIST_SCHEMA = {
    "type": "record", "name": "manifest_file", "fields": [
        {"name": "manifest_path", "type": "string"},
        {"name": "manifest_length", "type": "long"},
        {"name": "partition_spec_id", "type": "int"},
        {"name": "added_snapshot_id", "type": ["null", "long"]},
    ]}

_MANIFEST_ENTRY_SCHEMA = {
    "type": "record", "name": "manifest_entry", "fields": [
        {"name": "status", "type": "int"},
        {"name": "snapshot_id", "type": ["null", "long"]},
        {"name": "data_file", "type": {
            "type": "record", "name": "r2", "fields": [
                {"name": "file_path", "type": "string"},
                {"name": "file_format", "type": "string"},
                {"name": "record_count", "type": "long"},
                {"name": "file_size_in_bytes", "type": "long"},
            ]}},
    ]}

_STATUS_ADDED = 1
_STATUS_DELETED = 2


class IcebergTable:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self.meta_dir = os.path.join(self.path, "metadata")

    # -- metadata chain ----------------------------------------------------
    def current_metadata_path(self) -> str:
        hint = os.path.join(self.meta_dir, "version-hint.text")
        if os.path.exists(hint):
            with open(hint) as f:
                v = int(f.read().strip())
            return os.path.join(self.meta_dir, f"v{v}.metadata.json")
        versions = sorted(
            int(n[1:].split(".")[0])
            for n in os.listdir(self.meta_dir)
            if n.startswith("v") and n.endswith(".metadata.json"))
        if not versions:
            raise FileNotFoundError(
                f"{self.path!r} has no iceberg metadata")
        return os.path.join(self.meta_dir,
                            f"v{versions[-1]}.metadata.json")

    def metadata(self) -> dict:
        with open(self.current_metadata_path()) as f:
            return json.load(f)

    def schema(self) -> Schema:
        md = self.metadata()
        if "schemas" in md:
            sid = md.get("current-schema-id", 0)
            fields = next(s for s in md["schemas"]
                          if s.get("schema-id", 0) == sid)["fields"]
        else:
            fields = md["schema"]["fields"]
        return _schema_from_iceberg(fields)

    def data_files(self, snapshot_id: Optional[int] = None) -> List[str]:
        md = self.metadata()
        snap_id = snapshot_id if snapshot_id is not None \
            else md.get("current-snapshot-id")
        if snap_id is None or snap_id == -1:
            return []
        snap = next(s for s in md.get("snapshots", [])
                    if s["snapshot-id"] == snap_id)
        _, manifests = read_avro_rows(self._local(snap["manifest-list"]))
        files: List[str] = []
        for m in manifests:
            _, entries = read_avro_rows(self._local(m["manifest_path"]))
            for e in entries:
                if e["status"] == _STATUS_DELETED:
                    continue
                df = e["data_file"]
                if df["file_format"].upper() != "PARQUET":
                    raise ValueError(
                        f"unsupported data file format "
                        f"{df['file_format']!r}")
                files.append(self._local(df["file_path"]))
        return files

    def _local(self, uri: str) -> str:
        return uri[len("file://"):] if uri.startswith("file://") else uri


class IcebergSource:
    """A scan's source over a snapshot (default: the current one);
    batches land on `device` (default: the card)."""

    def __init__(self, path: str, conf=None,
                 snapshot_id: Optional[int] = None, device=None):
        need_pyarrow("the Iceberg reader", "pyarrow.parquet")
        self.device = resolve_device(device)
        self.table = IcebergTable(path)
        self.schema = self.table.schema()
        self._conf = conf
        self._files = self.table.data_files(snapshot_id)
        self.filters: List = []
        #: the last batches() drive's, as its ParquetSource keeps them
        #: (row groups read and pruned, multifile.DRIVE_STATS); shared
        #: with with_filters() copies
        self.scan_stats = {"row_groups_read": 0, "row_groups_pruned": 0,
                           **dict.fromkeys(DRIVE_STATS, 0)}

    def with_filters(self, filters) -> "IcebergSource":
        out = IcebergSource.__new__(IcebergSource)
        out.__dict__.update(self.__dict__)
        out.filters = list(self.filters) + list(filters)
        return out

    def estimated_size_bytes(self) -> int:
        return sum(os.path.getsize(p) for p in self._files)

    def batches(self) -> Iterator[ColumnarBatch]:
        if not self._files:
            return
        from .parquet import ParquetSource
        src = ParquetSource(self._files, self._conf,
                            columns=list(self.schema.names),
                            filters=self.filters, device=self.device)
        src.scan_stats = self.scan_stats
        yield from src.batches()


def write_iceberg(df, path: str, mode: str = "append") -> None:
    """DataFrame -> an iceberg v1 table (append or overwrite): a parquet
    data file (from `df.to_arrow()`: one fetch a batch), a manifest, a
    manifest list, the next metadata.json and the version hint."""
    pq = need_pyarrow("the Iceberg writer", "pyarrow.parquet")
    path = os.path.abspath(path)
    meta_dir = os.path.join(path, "metadata")
    data_dir = os.path.join(path, "data")
    os.makedirs(meta_dir, exist_ok=True)
    os.makedirs(data_dir, exist_ok=True)

    tbl = IcebergTable(path)
    try:
        md = tbl.metadata()
        version = int(os.path.basename(tbl.current_metadata_path())
                      [1:].split(".")[0])
    except FileNotFoundError:
        md = None
        version = 0

    fields = []
    for i, f in enumerate(df.schema.fields):
        t = _TYPE_TO_ICE.get(type(f.data_type))
        if t is None:
            raise ValueError(
                f"iceberg write: unsupported type "
                f"{f.data_type.simple_name()}")
        fields.append({"id": i + 1, "name": f.name, "required": False,
                       "type": t})

    table = df.to_arrow()
    data_path = os.path.join(data_dir,
                             f"{uuid.uuid4().hex}.parquet")
    pq.write_table(table, data_path)

    snap_id = int(time.time() * 1000) + version
    manifest_path = os.path.join(meta_dir,
                                 f"{uuid.uuid4().hex}-m0.avro")
    write_avro_rows(manifest_path, _MANIFEST_ENTRY_SCHEMA, [{
        "status": _STATUS_ADDED, "snapshot_id": snap_id,
        "data_file": {
            "file_path": data_path, "file_format": "PARQUET",
            "record_count": table.num_rows,
            "file_size_in_bytes": os.path.getsize(data_path)}}])

    # carry forward prior manifests on append
    prior_manifests: List[dict] = []
    if md is not None and mode == "append":
        cur = md.get("current-snapshot-id")
        if cur is not None and cur != -1:
            snap = next(s for s in md["snapshots"]
                        if s["snapshot-id"] == cur)
            _, prior_manifests = read_avro_rows(
                tbl._local(snap["manifest-list"]))
    list_path = os.path.join(
        meta_dir, f"snap-{snap_id}-1-{uuid.uuid4().hex}.avro")
    write_avro_rows(list_path, _MANIFEST_LIST_SCHEMA, prior_manifests + [{
        "manifest_path": manifest_path,
        "manifest_length": os.path.getsize(manifest_path),
        "partition_spec_id": 0, "added_snapshot_id": snap_id}])

    snapshots = (md.get("snapshots", []) if md is not None
                 and mode == "append" else [])
    new_md = {
        "format-version": 1,
        "table-uuid": (md or {}).get("table-uuid", str(uuid.uuid4())),
        "location": path,
        "last-updated-ms": int(time.time() * 1000),
        "last-column-id": len(fields),
        "schema": {"type": "struct", "fields": fields},
        "partition-spec": [],
        "current-snapshot-id": snap_id,
        "snapshots": snapshots + [{
            "snapshot-id": snap_id,
            "timestamp-ms": int(time.time() * 1000),
            "manifest-list": list_path,
            "summary": {"operation": "append"}}],
    }
    version += 1
    with open(os.path.join(meta_dir, f"v{version}.metadata.json"),
              "w") as f:
        json.dump(new_md, f, indent=2)
    with open(os.path.join(meta_dir, "version-hint.text"), "w") as f:
        f.write(str(version))
