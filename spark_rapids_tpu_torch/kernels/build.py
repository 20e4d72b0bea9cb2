"""Build and load the port's CUDA kernels and its host library.

Each kernel source is compiled by `nvcc` into a shared library with a
plain C interface and loaded with ctypes (no PyTorch headers: a build
takes seconds, not minutes). Libraries are cached in `_build/` beside the
package, named by the SHA-256 of source and flags, so a source is
compiled once per checkout. Builds happen at first use; `start` and
`wait` let a caller compile several sources at once, one nvcc each.
`build_host` compiles a host C++ source (the shuffle's block codec,
csrc/blockcodec.cpp) the same way with the host compiler (`cxx_path`).

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


def cxx_path() -> str:
    """The host C++ compiler: $CXX, else g++ or c++ on PATH."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no host C++ compiler: set CXX or put g++ on PATH")


HOST_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build_host(source: str) -> Path:
    """Compile the host C++ `source` (if not cached) with `cxx_path()`
    into `_build/`, named by the SHA-256 of source and flags, and return
    the library path. Raises with the compiler's output on failure."""
    digest = hashlib.sha256(
        (source + "\0" + " ".join(HOST_CXX_FLAGS)).encode()).hexdigest()[:24]
    lib = BUILD_DIR / f"h_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = lib.with_suffix(".cpp")
    tmp_src = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.cpp")
    tmp_src.write_text(source)
    os.replace(tmp_src, src)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([cxx_path(), *HOST_CXX_FLAGS, "-o", str(tmp),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx_path()} failed on {src}:\n"
                           f"{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, lib)
    return lib


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


CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"

#: libraries of the fixed sources under csrc/, loaded once per process
_csrc_libs = {}


def csrc_source(name: str) -> str:
    """The text of a fixed kernel source under csrc/."""
    return (CSRC_DIR / name).read_text()


def csrc_library(name: str, signatures) -> ctypes.CDLL:
    """Build (if needed) and load csrc/`name`, declaring each entry point's
    ctypes signature: `signatures` maps a function name to its argtypes
    (every entry point returns the launch's CUDA error as an int)."""
    lib = _csrc_libs.get(name)
    if lib is None:
        lib = load(build(csrc_source(name)))
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
        _csrc_libs[name] = lib
    return lib
