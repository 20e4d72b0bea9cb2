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

`plan` chooses, on the host, the kernel and its shape from the lane
count, the table's size, the index and output addresses and the card's SM
count (read once per process); its parts are pure functions:
`vector_width`, `align_split`, `staged` and `grid_shape`
(csrc/dict_gather.cu says why). `launcher` prepares one launch for timing
it alone.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

_SOURCE = "dict_gather.cu"
_SIGNATURES = {
    "dict_gather_run": [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "dict_gather_sms": [ctypes.POINTER(ctypes.c_int)],
}

#: element types the kernel copies (it moves their bits: 1 or 4 bytes)
_ELEMENT_TYPES = (torch.bool, torch.int8, torch.uint8, torch.int32,
                  torch.float32)

#: the kernels of csrc/dict_gather.cu (its KIND_* values)
SCALAR, FLAT = 0, 1

#: threads per block of both kernels; 8 blocks fill an SM's 2048 threads
THREADS = 256
BLOCKS_PER_SM = 2048 // THREADS
#: one-lane tables up to this size are staged whole by every block
STAGE_BYTES = 4096


class Plan(NamedTuple):
    kind: int       # SCALAR or FLAT
    staged: bool    # FLAT: the one-lane table staged in shared memory
    shift: int      # FLAT: log2 of the lanes
    head: int       # FLAT: elements before the first aligned quad
    nvec: int       # FLAT: quads of four elements
    grid: int       # blocks


def _pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def vector_width(lanes: int) -> int:
    """Elements a thread takes at a time: four (one 16-byte load of codes)
    when the lane count is a power of two, so an element's lane is its
    flat position masked, else one."""
    return 4 if _pow2(lanes) else 1


def align_split(idx_addr: int, out_addr: int, elt: int,
                total: int) -> Tuple[int, int, int]:
    """(head, quads, tail) of `total` elements: the scalar head up to the
    index pointer's first 16-byte boundary, the quads loaded 16 bytes and
    stored 4 * elt bytes at a time, the scalar tail. When the output's
    phase does not match the index pointer's, every element is scalar."""
    head = min(total, (-idx_addr % 16) // 4)
    if (out_addr + head * elt) % (4 * elt):
        return total, 0, 0
    quads = (total - head) // 4
    return head, quads, total - head - 4 * quads


def staged(n: int, lanes: int, elt: int) -> bool:
    """Whether every block stages an (n, lanes) table in shared memory:
    a one-lane table of up to STAGE_BYTES is; any other the kernel reads
    through the read-only path (it stays in L2)."""
    return lanes == 1 and n * elt <= STAGE_BYTES


def grid_shape(work: int, sms: int) -> int:
    """Blocks of one launch, a thread for each of `work` quads (or
    elements): one wave of the card, BLOCKS_PER_SM blocks on each of its
    `sms` SMs, fewer when the work does not fill it."""
    return max(1, min(-(-work // THREADS), sms * BLOCKS_PER_SM))


def plan(n: int, lanes: int, elt: int, rows: int, idx_addr: int,
         out_addr: int, sms: int) -> Plan:
    """The kernel and launch shape for an (n, lanes) table of `elt`-byte
    elements gathered by (rows, lanes) indices at the given addresses."""
    total = rows * lanes
    if vector_width(lanes) == 1:
        return Plan(SCALAR, False, 0, 0, 0, grid_shape(total, sms))
    head, quads, _ = align_split(idx_addr, out_addr, elt, total)
    return Plan(FLAT, staged(n, lanes, elt), lanes.bit_length() - 1, head,
                quads, grid_shape(max(quads, head, 1), sms))


_sms: Optional[int] = None


def sm_count() -> int:
    """The current card's SM count, read once per process."""
    global _sms
    if _sms is None:
        from ..kernels.build import csrc_library
        out = ctypes.c_int(0)
        err = csrc_library(_SOURCE, _SIGNATURES).dict_gather_sms(
            ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"dict_gather: cannot read the SM count: "
                               f"CUDA error {err}")
        _sms = int(out.value)
    return _sms


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


def _output(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The (rows, L) output, allocated at the index pointer's phase within
    16 bytes (a contiguous view into a buffer 3 elements longer), so that
    both reach their 16-byte boundary after the same head."""
    rows, lanes = idx.shape
    phase = idx.data_ptr() % 16 // 4
    buf = torch.empty(rows * lanes + 3, dtype=table.dtype,
                      device=table.device)
    return buf[phase: phase + rows * lanes].view(rows, lanes)


def _launch(table: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
            p: Plan) -> None:
    from ..kernels.build import csrc_library
    n, lanes = table.shape
    elt = table.element_size()
    lib = csrc_library(_SOURCE, _SIGNATURES)
    err = lib.dict_gather_run(
        p.kind, int(p.staged), table.data_ptr(), n, lanes, elt, p.shift,
        idx.data_ptr(), idx.shape[0], out.data_ptr(), p.head, p.nvec, p.grid,
        n * elt if p.staged else 0,
        torch.cuda.current_stream(table.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dict_gather kernel launch failed: CUDA error "
                           f"{err}")


def plan_for(table: torch.Tensor, idx: torch.Tensor,
             out: torch.Tensor) -> Plan:
    """`plan` for these tensors on the current card."""
    n, lanes = table.shape
    return plan(n, lanes, table.element_size(), idx.shape[0],
                idx.data_ptr(), out.data_ptr(), sm_count())


def launcher(table: torch.Tensor, idx: torch.Tensor):
    """One launch of the kernel on CUDA tensors, its output allocated and
    its plan made here. Returns (output, plan, a callable that launches
    the kernel alone into that output): for timing the launch apart from
    the wrapper's host work. It counts no launch."""
    table, idx = table.contiguous(), idx.contiguous()
    out = _output(table, idx)
    p = plan_for(table, idx, out)

    def launch():
        _launch(table, idx, out, p)

    return out, p, launch


def dict_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, l] = table[clamp(idx[i, l], 0, n - 1), l]."""
    _check(table, idx)
    if table.device.type == "cpu":
        return dict_gather_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"dict_gather runs on cuda or cpu, not "
                         f"{table.device}")
    if idx.numel() == 0:
        return _output(table, idx)   # nothing to gather: no launch
    from ..obs.dispatch import kernel_site
    with kernel_site("dict_gather", tuple(idx.shape), table.device,
                     counter=dict_gather) as site:
        out, _, launch = launcher(table, idx)
        launch()
        dict_gather.launches += 1
        site.count()
    return out


dict_gather.launches = 0
