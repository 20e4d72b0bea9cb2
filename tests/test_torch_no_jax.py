"""The PyTorch port stands alone: in a fresh interpreter where `jax`,
`spark_rapids_tpu`, `pyarrow` and `pandas` cannot be imported (the
machine with the card has neither pyarrow nor pandas), every module of
the port and chip_smoke.py import, the Parquet, CSV, JSON, ORC, Iceberg
and Delta readers and writers raise a clear ImportError naming pyarrow
only when they are called, the pandas UDFs one naming pandas, Avro and
Hive text write and read, Delta's per-file rewrites plan and run, a
group-by and a shuffled join run over a mesh of CPU shards, and an
entry point asked for no device raises when there is no card instead of
falling back to the CPU."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "spark_rapids_tpu",
                                  "pyarrow", "pandas"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, _Blocked())
import spark_rapids_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
q3 = ["ops.hashing", "ops.murmur3_lanes", "ops.rowpack", "ops.row_gather",
      "ops.gather", "ops.aggregate", "ops.join", "ops.probe_verify",
      "exec.joins", "exec.sort"]
q19 = ["columnar.encoded", "ops.dict_gather"]
ingest = ["columnar.upload", "columnar.transfer", "exec.pipeline",
          "memory.semaphore", "memory.device_manager", "memory.host_alloc",
          "io.parquet", "io.multifile", "io.retrying"]
strings = ["ops.hashagg", "ops.strings"]
windows_arrays = ["ops.window", "expr.windowexprs", "exec.window",
                  "ops.collection", "expr.collectionexprs",
                  "ops.string_split", "exec.generate", "ops.percentile",
                  "exec.cache"]
nested = ["ops.maps", "expr.mapexprs", "ops.array_hof", "ops.json_device",
          "expr.jsonexprs", "ops.url", "expr.urlexprs", "expr.zorder"]
wave4 = ["exec.adaptive", "exec.fallback", "expr.udf", "udf_compiler",
         "plan.cost"]
governance = ["faults", "exec.task_retry", "exec.lifecycle",
              "exec.workload", "exec.task_metrics", "obs.events",
              "obs.phase", "obs.span", "obs.dispatch", "obs.stats",
              "obs.telemetry", "obs.profile", "utils.tracing"]
shield = ["exec.speculation_shield", "obs.history"]
formats = ["io.avro", "io.hivetext", "io.csv", "io.json", "io.orc",
           "io.orc_meta", "io.iceberg"]
delta_pandas = ["delta", "delta.log", "delta.table", "exec.python_udf"]
mesh = ["parallel.mesh", "parallel.exchange", "parallel.distributed",
        "parallel.multihost", "parallel.heartbeat"]
missing = [m for m in q3 + q19 + ingest + strings + windows_arrays + nested
           + wave4 + governance + shield + formats + delta_pandas + mesh
           if pkg.__name__ + "." + m not in mods]
assert not missing, missing
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "spark_rapids_tpu",
                                       "pyarrow", "pandas"))
assert not leaked, leaked
print("MODULES", len(mods))

from spark_rapids_tpu_torch.io.parquet import ParquetSource
try:
    ParquetSource("any.parquet", device="cpu")
except ImportError as e:
    assert "pyarrow" in str(e), e
    print("PARQUET", e)
else:
    raise AssertionError("ParquetSource without pyarrow must raise")

from spark_rapids_tpu_torch.io import csv, iceberg, json, orc
for make in (lambda: csv.CsvSource("any.csv", device="cpu"),
             lambda: json.JsonSource("any.json", device="cpu"),
             lambda: orc.OrcSource("any.orc", device="cpu"),
             lambda: iceberg.IcebergSource("any", device="cpu")):
    try:
        make()
    except ImportError as e:
        assert "pyarrow" in str(e), e
    else:
        raise AssertionError("a pyarrow reader without pyarrow must raise")
print("FORMATS pyarrow readers raise")

# Avro and Hive text are pure Python: they run without pyarrow
import os, tempfile
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.types import LONG, STRING, Schema, StructField
sch = Schema((StructField("k", LONG), StructField("s", STRING)))
sess = TpuSession(device="cpu")
df = sess.from_pydict({"k": [1, None], "s": ["a", None]}, sch)
with tempfile.TemporaryDirectory() as d:
    df.write_avro(os.path.join(d, "t.avro"))
    df.write_hive_text(os.path.join(d, "t.txt"))
    assert sess.read_avro(os.path.join(d, "t.avro")).collect() == \
        sess.read_hive_text(os.path.join(d, "t.txt"), sch).collect() == \
        [(1, "a"), (None, None)]
print("PURE avro and hive text")

# Delta's file layer needs pyarrow, the pandas UDFs pandas; Delta's
# per-file rewrites are device plans and run without either
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.delta import table as dtable
with tempfile.TemporaryDirectory() as d:
    for call in (lambda: df.write_delta(os.path.join(d, "t")),
                 lambda: sess.read_delta(os.path.join(d, "t")),
                 lambda: dtable.DeltaTable.for_path(sess, d).delete("k")):
        try:
            call()
        except ImportError as e:
            assert "pyarrow" in str(e), e
        else:
            raise AssertionError("Delta's files without pyarrow must raise")
print("DELTA files raise")
kept = dtable.delete_rewrite(df, F.col("k") == F.lit(1)).collect()
code = dtable.zorder_rewrite(df, ["k"], ["k", "s"]).collect()
assert kept == [(None, None)] and code == [(None, None), (1, "a")], \
    (kept, code)
print("DELTA rewrites run")
for make in (lambda: df.map_in_pandas(lambda f: f, sch),
             lambda: df.group_by("k").apply_in_pandas(lambda g: g, sch),
             lambda: df.group_by("k").agg_in_pandas(
                 (len, "n", LONG, "k")),
             lambda: df.window_in_pandas("k", (len, "n", LONG, "k")),
             lambda: df.group_by("k").cogroup(df.group_by("k"))
             .apply_in_pandas(lambda a, b: a, sch)):
    out = make()  # the plan builds without pandas
    try:
        out.collect()
    except ImportError as e:
        assert "pandas" in str(e), e
    else:
        raise AssertionError("a pandas UDF without pandas must raise")
print("PANDAS udfs raise")

# the mesh lane: a distributed group-by and join over two CPU shards
msess = TpuSession({"spark.rapids.sql.broadcastSizeThreshold": "-1"},
                   device="cpu", mesh_devices=2)
mdf = msess.from_pydict({"k": [1, 2, 1, 3], "s": ["a", "b", "c", None]},
                        sch)
got = sorted(mdf.join(mdf.select(F.col("k")), on="k").group_by("k").agg(
    (F.count(), "n")).collect())
assert got == [(1, 4), (2, 1), (3, 1)], got
print("MESH group-by and join")

import numpy as np
import torch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.types import INT
if not torch.cuda.is_available():
    try:
        Column.from_numpy(np.arange(3, dtype=np.int32), INT)
    except RuntimeError as e:
        print("RAISED", e)
    else:
        raise AssertionError("no device and no device='cpu' must raise")
"""


def test_port_imports_without_jax_and_refuses_implicit_cpu():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split("MODULES", 1)[1].split()[0])
    assert n >= 20, proc.stdout
    assert "RAISED" in proc.stdout
    assert "PARQUET the Parquet reader needs pyarrow" in proc.stdout
    assert "FORMATS pyarrow readers raise" in proc.stdout
    assert "PURE avro and hive text" in proc.stdout
    assert "DELTA files raise" in proc.stdout
    assert "DELTA rewrites run" in proc.stdout
    assert "PANDAS udfs raise" in proc.stdout
    assert "MESH group-by and join" in proc.stdout


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_to_run_without_a_card(tmp_path, alone):
    """Without CUDA, chip_smoke exits non-zero and prints no result line,
    from the repository root and from a directory that holds only the
    script."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke would run")
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    proc = subprocess.run([sys.executable, str(cwd / "chip_smoke.py")],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
