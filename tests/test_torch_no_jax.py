"""The PyTorch port stands alone: in a fresh interpreter where `jax`,
`spark_rapids_tpu` and `pyarrow` cannot be imported (the machine with the
card has no pyarrow), every module of the port and chip_smoke.py import,
the Parquet reader raises a clear ImportError only when it is called, and
an entry point asked for no device raises when there is no card instead
of falling back to the CPU."""

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
                                  "pyarrow"):
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
missing = [m for m in q3 + q19 + ingest + strings
           if pkg.__name__ + "." + m not in mods]
assert not missing, missing
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "spark_rapids_tpu",
                                       "pyarrow"))
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
