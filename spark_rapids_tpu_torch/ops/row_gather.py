"""Packed row gather on Hopper — the counterpart of
spark_rapids_tpu/ops/pallas_gather.py (`dma_row_gather`,
`pallas_gather_rows`).

`dma_row_gather(mat, idx)` is out[i] = mat[idx[i]] over a u32 (int32
bits) matrix. `pallas_gather_rows(plan, imat, fmat, idx)` is the drop-in
for ops/rowpack.gather_rows: the f64 matrix rides the same launch as two
u32 lanes per column, and an out-of-range index (< 0 or >= capacity)
reads row 0 with its validity lanes zeroed — bit-identical to the plain
version. Both launch csrc/row_gather.cu on CUDA tensors and count each
launch in `dma_row_gather.launches`; on CPU tensors they run the plain
version (no launch); any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .rowpack import gather_rows as gather_rows_plain

_SOURCE = "row_gather.cu"
_SIGNATURES = {"row_gather_run": [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p]}


def _matrix(m: torch.Tensor, name: str) -> torch.Tensor:
    if m.dim() != 2:
        raise ValueError(f"{name} must be a 2-D matrix, got {tuple(m.shape)}")
    return m.contiguous()


def _launch(idx: torch.Tensor, a: torch.Tensor, b: Optional[torch.Tensor],
            nv: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One kernel launch gathering rows of `a` (int32 (cap, la)) and, when
    given, of `b` (int32 (cap, lb)) by `idx`."""
    from ..kernels.build import csrc_library
    dev = a.device
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError("the gather index must be a 1-D int32 tensor")
    if idx.device != dev or (b is not None and b.device != dev):
        raise ValueError("index and matrices must be on one device")
    if b is not None and b.shape[0] != a.shape[0]:
        raise ValueError("both matrices need the same row count")
    idx = idx.contiguous()
    n, cap = idx.shape[0], a.shape[0]
    oa = torch.empty((n, a.shape[1]), dtype=torch.int32, device=dev)
    lb = b.shape[1] if b is not None else 0
    ob = torch.empty((n, lb), dtype=torch.int32, device=dev) \
        if b is not None else None
    if n * (a.shape[1] + lb) == 0:
        return oa, ob   # nothing to copy: no launch
    lib = csrc_library(_SOURCE, _SIGNATURES)
    err = lib.row_gather_run(
        idx.data_ptr(), n, cap, a.data_ptr(), a.shape[1], oa.data_ptr(),
        b.data_ptr() if b is not None else None, lb,
        ob.data_ptr() if ob is not None else None, nv,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_gather kernel launch failed: CUDA error "
                           f"{err}")
    dma_row_gather.launches += 1
    return oa, ob


def dma_row_gather(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = mat[idx[i]] over an int32 (cap, L) matrix; an index
    outside [0, cap) reads row 0."""
    mat = _matrix(mat, "mat")
    if mat.dtype != torch.int32:
        raise TypeError(f"dma_row_gather takes an int32 matrix, not "
                        f"{mat.dtype}")
    if mat.device.type == "cpu":
        in_range = (idx >= 0) & (idx < mat.shape[0])
        return mat[torch.where(in_range, idx, torch.zeros_like(idx)).long()]
    if mat.device.type != "cuda":
        raise ValueError(f"dma_row_gather runs on cuda or cpu, not "
                         f"{mat.device}")
    return _launch(idx, mat, None, 0)[0]


dma_row_gather.launches = 0


def pallas_gather_rows(plan, imat: torch.Tensor,
                       fmat: Optional[torch.Tensor], idx: torch.Tensor
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Drop-in for ops/rowpack.gather_rows served by the kernel: ONE
    launch moves the validity bits, the u32 data lanes and the f64 lanes
    of every gathered row."""
    imat = _matrix(imat, "imat")
    if imat.device.type == "cpu":
        return gather_rows_plain(plan, imat, fmat, idx)
    if imat.device.type != "cuda":
        raise ValueError(f"the row gather runs on cuda or cpu, not "
                         f"{imat.device}")
    if imat.dtype != torch.int32:
        raise TypeError(f"imat must be int32, not {imat.dtype}")
    fbits = None
    if fmat is not None:
        fmat = _matrix(fmat, "fmat")
        if fmat.dtype != torch.float64:
            raise TypeError(f"fmat must be float64, not {fmat.dtype}")
        fbits = fmat.view(torch.int32)
    gi, gfb = _launch(idx, imat, fbits, plan.n_valid_lanes)
    gf = gfb.view(torch.float64) if gfb is not None else None
    return gi, gf
