"""The host shuffle's native block codec — the counterpart of
spark_rapids_tpu/native/__init__.py: LZ4 block compression and xxhash64
from csrc/blockcodec.cpp (the port's own copy of the JAX package's
source), compiled with the host compiler into `_build/` at first use
(kernels/build.build_host, keyed by the source's digest) and called over
ctypes.

There is no fallback: a library that does not build or load raises, and
the caller sees the compiler's error. (The JAX package drops to codec
COPY and a pure-Python xxh64 when g++ is missing; here COPY is a codec a
caller asks for by name.) The functions are declared on a `ctypes.CDLL`,
which releases the GIL for the length of each call, so the shuffle's
writer and reader pools compress and decompress blocks in parallel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

__all__ = ["native_lib", "lz4_compress", "lz4_decompress", "xxh64"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    from ..kernels.build import build_host, csrc_source
    lib = ctypes.CDLL(str(build_host(csrc_source("blockcodec.cpp"))))
    i64, u64, ptr = ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p
    lib.tpu_lz4_compress_bound.restype = i64
    lib.tpu_lz4_compress_bound.argtypes = [i64]
    lib.tpu_lz4_compress.restype = i64
    lib.tpu_lz4_compress.argtypes = [ptr, i64, ptr, i64]
    lib.tpu_lz4_decompress.restype = i64
    lib.tpu_lz4_decompress.argtypes = [ptr, i64, ptr, i64]
    lib.tpu_xxh64.restype = u64
    lib.tpu_xxh64.argtypes = [ptr, i64, u64]
    return lib


def native_lib() -> ctypes.CDLL:
    """The loaded codec library, built at the first call."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _load()
    return _lib


def _bytes_view(data) -> np.ndarray:
    """A bytes-like object as a uint8 array over the same memory (no
    copy); the caller keeps `data` alive across the native call."""
    return np.frombuffer(data, dtype=np.uint8)


def lz4_compress(data) -> bytes:
    """LZ4 block format of the bytes-like `data`."""
    lib = native_lib()
    src = _bytes_view(data)
    bound = lib.tpu_lz4_compress_bound(src.shape[0])
    dst = np.empty(max(bound, 1), dtype=np.uint8)
    n = lib.tpu_lz4_compress(src.ctypes.data, src.shape[0], dst.ctypes.data,
                             bound)
    if n < 0:
        raise RuntimeError("LZ4 compression failed")
    return dst[:n].tobytes()


def lz4_decompress(data, raw_len: int) -> bytes:
    """The `raw_len` bytes an LZ4 block decodes to; ValueError when the
    block is malformed or decodes to another length."""
    lib = native_lib()
    src = _bytes_view(data)
    dst = np.empty(max(raw_len, 1), dtype=np.uint8)
    n = lib.tpu_lz4_decompress(src.ctypes.data, src.shape[0],
                               dst.ctypes.data, raw_len)
    if n != raw_len:
        raise ValueError("corrupt LZ4 block")
    return dst[:raw_len].tobytes()


def xxh64(data, seed: int = 0) -> int:
    """Canonical xxhash64 of the bytes-like `data`."""
    src = _bytes_view(data)
    return int(native_lib().tpu_xxh64(src.ctypes.data, src.shape[0],
                                      seed & ((1 << 64) - 1)))
