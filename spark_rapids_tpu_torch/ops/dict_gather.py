"""Table-resident dictionary gather — the counterpart of the inline `dg`
kernel of tools/exp_gather.py (`jnp.take_along_axis(table, idx, axis=0)`
over a table held whole in VMEM), which is the engine of
columnar/encoded.dict_take in the JAX package (the `dict_gather` family).

`dict_gather(table, idx)` is out[i, l] = table[clamp(idx[i, l], 0, n-1), l]
for a contiguous (n, L) table of 1-byte (bool, int8, uint8) or 4-byte
(int32, float32) elements and (rows, L) int32 indices; the clamp is
dict_take's (`NULL_CODE` = -1 reads entry 0; callers mask by validity).
On CUDA tensors it launches csrc/dict_gather.cu and adds one to
`dict_gather.launches`; on CPU tensors it runs `dict_gather_plain`; any
other device raises. Empty inputs launch nothing.

The kernel stages `lanes_per_block(...)` lanes of the table per block in
shared memory when a lane's column fits the card's opt-in budget, and
reads the table from global memory otherwise (one kernel, a template
parameter; csrc/dict_gather.cu says why).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_SOURCE = "dict_gather.cu"
_SIGNATURES = {
    "dict_gather_run": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p],
    "dict_gather_smem_optin": [ctypes.POINTER(ctypes.c_int)],
}

#: element types the kernel copies (it moves their bits: 1 or 4 bytes)
_ELEMENT_TYPES = (torch.bool, torch.int8, torch.uint8, torch.int32,
                  torch.float32)

_smem_budget: Optional[int] = None


def lanes_per_block(n: int, lanes: int, elt: int, budget: int) -> int:
    """Lanes of an (n, lanes) table of `elt`-byte elements one block
    stages in `budget` bytes of shared memory: all of them when they fit,
    else the largest power of two that does; 0 when one lane does not
    fit (the kernel then reads the table from global memory)."""
    per_lane = n * elt
    if per_lane <= 0 or per_lane > budget:
        return 0
    lb = min(lanes, budget // per_lane)
    if lb < lanes:
        lb = 1 << (lb.bit_length() - 1)
    return lb


def smem_budget() -> int:
    """The current card's opt-in shared-memory budget of one block."""
    global _smem_budget
    if _smem_budget is None:
        from ..kernels.build import csrc_library
        lib = csrc_library(_SOURCE, _SIGNATURES)
        out = ctypes.c_int(0)
        err = lib.dict_gather_smem_optin(ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"dict_gather: cannot read the shared-memory "
                               f"budget: CUDA error {err}")
        _smem_budget = int(out.value)
    return _smem_budget


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"dict_gather takes a 2-D table and 2-D indices, "
                         f"got {tuple(table.shape)} and {tuple(idx.shape)}")
    if table.dtype not in _ELEMENT_TYPES:
        raise TypeError(f"dict_gather tables hold 1- or 4-byte elements "
                        f"{_ELEMENT_TYPES}, not {table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"dict_gather indices must be int32, not {idx.dtype}")
    if idx.shape[1] != table.shape[1]:
        raise ValueError(f"indices have {idx.shape[1]} lanes, the table "
                         f"{table.shape[1]}")
    if idx.device != table.device:
        raise ValueError("table and indices must be on one device")
    if table.shape[0] == 0 and idx.numel():
        raise ValueError("dict_gather needs a table with at least one entry")


def dict_gather_plain(table: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """The plain PyTorch version: clamp, then one flat index of the
    table by code * L + lane."""
    _check(table, idx)
    n, lanes = table.shape
    if idx.numel() == 0:
        return torch.empty(idx.shape, dtype=table.dtype, device=table.device)
    safe = idx.clamp(0, n - 1).to(torch.int64)
    lane = torch.arange(lanes, dtype=torch.int64, device=idx.device)
    return table.reshape(-1)[safe * lanes + lane]


def dict_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, l] = table[clamp(idx[i, l], 0, n - 1), l]."""
    _check(table, idx)
    if table.device.type == "cpu":
        return dict_gather_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"dict_gather runs on cuda or cpu, not "
                         f"{table.device}")
    from ..kernels.build import csrc_library
    table, idx = table.contiguous(), idx.contiguous()
    n, lanes = table.shape
    rows = idx.shape[0]
    out = torch.empty((rows, lanes), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out   # nothing to gather: no launch
    elt = table.element_size()
    lb = lanes_per_block(n, lanes, elt, smem_budget())
    lib = csrc_library(_SOURCE, _SIGNATURES)
    err = lib.dict_gather_run(
        table.data_ptr(), n, lanes, elt, idx.data_ptr(), rows,
        out.data_ptr(), lb, torch.cuda.current_stream(table.device)
        .cuda_stream)
    if err != 0:
        raise RuntimeError(f"dict_gather kernel launch failed: CUDA error "
                           f"{err}")
    dict_gather.launches += 1
    return out


dict_gather.launches = 0
