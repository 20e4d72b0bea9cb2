"""Build and load the port's CUDA kernels.

Each kernel source is compiled by `nvcc` into a shared library with a
plain C interface and loaded with ctypes (no PyTorch headers: a build
takes seconds, not minutes). Libraries are cached in `_build/` beside the
package, named by the SHA-256 of source and flags, so a source is
compiled once per checkout. Builds happen at first use; `start` and
`wait` let a caller compile several sources at once, one nvcc each.

Usage:
    from spark_rapids_tpu_torch.kernels import build
    lib = build.load(build.build(source_text))
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # exact IEEE per operation, as the plain PyTorch version computes:
    # no fused multiply-add contraction
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit's bin directory on PATH")
    return found


def library_path(source: str) -> Path:
    digest = hashlib.sha256(
        (source + "\0" + " ".join(NVCC_FLAGS)).encode()).hexdigest()[:24]
    return BUILD_DIR / f"k_{digest}.so"


def start(source: str) -> Optional[Tuple[subprocess.Popen, Path, Path]]:
    """Start compiling `source` unless its library exists. Returns the
    running build (process, temporary output, final path) or None."""
    lib = library_path(source)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = lib.with_suffix(".cu")
    cu.write_text(source)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    log = open(lib.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(cu)], stdout=log,
                                stderr=subprocess.STDOUT)
    finally:
        log.close()
    return proc, tmp, lib


def wait(builds: List[Optional[Tuple[subprocess.Popen, Path, Path]]]
         ) -> None:
    """Wait for every started build; raise with the compiler's log on the
    first that failed (after all have stopped)."""
    failed = []
    for b in builds:
        if b is None:
            continue
        proc, tmp, lib = b
        if proc.wait() != 0:
            failed.append(lib.with_suffix(".log"))
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {p}\n{p.read_text()[-4000:]}" for p in failed))


def build(source: str) -> Path:
    """Compile `source` (if not cached) and return the library path."""
    wait([start(source)])
    return library_path(source)


def build_all(sources: List[str]) -> List[Path]:
    """Compile several sources at once, one nvcc process each."""
    wait([start(s) for s in dict.fromkeys(sources)])
    return [library_path(s) for s in sources]


def compiler_log(source: str) -> str:
    """nvcc's output for `source` (ptxas register and spill counts), if
    this checkout built it."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(path: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(path))
