"""Per-row murmur3 of i64 and i32 lanes with per-row u32 seeds — the
counterpart of `murmur3_long_lanes` and `murmur3_int_lanes` in
spark_rapids_tpu/ops/pallas_kernels.py.

On CUDA tensors each wrapper launches its entry point of csrc/murmur3.cu
and adds one to its `launches` count; on CPU tensors it runs the plain
version (ops/hashing.murmur3_*_plain); any other device raises. Seeds and
results are int32 tensors holding u32 bit patterns.
"""

from __future__ import annotations

import ctypes

import torch

from .hashing import murmur3_int_plain, murmur3_long_plain

_SOURCE = "murmur3.cu"
_RUN = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p]
_SIGNATURES = {"m3_long_run": _RUN, "m3_int_run": _RUN}


def _check(data: torch.Tensor, seeds: torch.Tensor, dtype: torch.dtype):
    if data.dtype != dtype or seeds.dtype != torch.int32:
        raise TypeError(f"murmur3 lanes take {dtype} data and int32 seeds, "
                        f"got {data.dtype} and {seeds.dtype}")
    if data.dim() != 1 or seeds.shape != data.shape:
        raise ValueError("data and seeds must be 1-D of one length")
    if data.device != seeds.device:
        raise ValueError("data and seeds must be on one device")


def _launch(wrapper, entry: str, data: torch.Tensor, seeds: torch.Tensor
            ) -> torch.Tensor:
    """Launch `entry` and count it on `wrapper` (no rows: no launch)."""
    from ..kernels.build import csrc_library
    if data.device.type != "cuda":
        raise ValueError(f"murmur3 lanes run on cuda or cpu, not "
                         f"{data.device}")
    data, seeds = data.contiguous(), seeds.contiguous()
    out = torch.empty_like(seeds)
    if data.numel() == 0:
        return out
    lib = csrc_library(_SOURCE, _SIGNATURES)
    err = getattr(lib, entry)(
        data.data_ptr(), seeds.data_ptr(), out.data_ptr(), data.numel(),
        torch.cuda.current_stream(data.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return out


def murmur3_long_lanes(data_i64: torch.Tensor, seeds_u32: torch.Tensor
                       ) -> torch.Tensor:
    """Per-row murmur3 update over int64 lanes; seeds/result u32 bits."""
    _check(data_i64, seeds_u32, torch.int64)
    if data_i64.device.type == "cpu":
        return murmur3_long_plain(data_i64, seeds_u32)
    return _launch(murmur3_long_lanes, "m3_long_run", data_i64, seeds_u32)


def murmur3_int_lanes(data_i32: torch.Tensor, seeds_u32: torch.Tensor
                      ) -> torch.Tensor:
    """Per-row murmur3 update over int32 lanes; seeds/result u32 bits."""
    _check(data_i32, seeds_u32, torch.int32)
    if data_i32.device.type == "cpu":
        return murmur3_int_plain(data_i32, seeds_u32)
    return _launch(murmur3_int_lanes, "m3_int_run", data_i32, seeds_u32)


murmur3_long_lanes.launches = 0
murmur3_int_lanes.launches = 0
