"""The PyTorch port stands alone: in a fresh interpreter where `jax` and
`spark_rapids_tpu` cannot be imported, every module of the port and
chip_smoke.py import, and an entry point asked for no device raises when
there is no card instead of falling back to the CPU."""

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
        if name.split(".")[0] in ("jax", "jaxlib", "spark_rapids_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, _Blocked())
import spark_rapids_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "spark_rapids_tpu"))
assert not leaked, leaked
print("MODULES", len(mods))

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
