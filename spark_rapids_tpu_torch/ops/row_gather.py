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

`plan` chooses, on the host, the kernel and its launch shape; its parts
are pure functions: `vector_words`, `kernel_kind`, `index_wide` and
`grid_shape` (csrc/row_gather.cu says why). `launcher` prepares one
launch for timing it alone.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .rowpack import gather_rows as gather_rows_plain

_SOURCE = "row_gather.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "row_gather_run": [_I, _I, _I, _P, ctypes.c_longlong,
                       ctypes.c_longlong, _P, _I, _P, _P, _I, _P, _I, _P],
    "row_gather_limits": [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
}

#: the kernels of csrc/row_gather.cu (its KIND_* values): any width, one
#: word at a time, or a fixed (la, lb) in vector pieces
ANY = 0
#: (la, words of a's pieces, lb, words of b's pieces) -> kind
FIXED = {(4, 4, 0, 1): 1, (4, 4, 4, 4): 2, (3, 1, 2, 2): 3, (3, 1, 6, 2): 4,
         (3, 1, 0, 1): 5, (3, 1, 4, 4): 6, (2, 2, 2, 2): 7}

#: threads per block and rows a thread takes per step (THREADS, ROWS)
THREADS = 256
ROWS = 4


class Plan(NamedTuple):
    kind: int       # ANY or one of FIXED's values
    wide: bool      # 64-bit offsets
    grid: int       # blocks


def kind_name(kind: int) -> str:
    """The name "la_lb" of a fixed-width kernel, "any" for the generic one."""
    return next((f"{k[0]}_{k[2]}" for k, v in FIXED.items() if v == kind),
                "any")


def vector_words(lanes: int, *addrs: int) -> int:
    """The widest piece (4, 2 or 1 words) that a row of `lanes` u32 words
    splits into with every row of the matrices at `addrs` aligned to it."""
    for v in (4, 2, 1):
        if lanes % v == 0 and all(a % (4 * v) == 0 for a in addrs):
            return v
    return 1


def kernel_kind(la: int, lb: int, a_addrs: Tuple[int, ...],
                b_addrs: Tuple[int, ...]) -> int:
    """The fixed-width kernel for (la, lb) at these matrix and output
    addresses, or ANY when none is compiled for them (another width, or a
    matrix off its pieces' alignment)."""
    va = vector_words(la, *a_addrs)
    vb = vector_words(lb, *b_addrs) if lb else 1
    return FIXED.get((la, va, lb, vb), ANY)


def index_wide(n: int, cap: int, lanes: int, grid: int) -> bool:
    """Whether the kernel needs 64-bit offsets: any word offset of either
    side, or a row the grid-stride loop reaches (its index prefetch runs
    one step ahead), at or past 2^31."""
    return (max(n, cap) * max(lanes, 1) >= 1 << 31
            or n + 2 * ROWS * grid * THREADS >= 1 << 31)


def grid_shape(n: int, sms: int, blocks_per_sm: int) -> int:
    """Blocks of one launch: one wave of the card, fewer when the rows do
    not fill it (ROWS a thread)."""
    return max(1, min(-(-n // (THREADS * ROWS)), sms * blocks_per_sm))


def plan(n: int, cap: int, la: int, lb: int, a_addrs: Tuple[int, ...],
         b_addrs: Tuple[int, ...], limits) -> Plan:
    """The kernel and launch shape for n indices into (cap, la) u32 rows
    and (cap, lb) f64-as-u32 rows; `limits(kind, wide)` gives (SMs, blocks
    per SM) of that kernel on the card."""
    kind = kernel_kind(la, lb, a_addrs, b_addrs)
    grid = grid_shape(n, *limits(kind, False))
    wide = index_wide(n, cap, max(la, lb), grid)
    if wide:
        grid = grid_shape(n, *limits(kind, True))
    return Plan(kind, wide, grid)


_limits: Dict[Tuple[int, int, bool], Tuple[int, int]] = {}


def card_limits(kind: int, wide: bool) -> Tuple[int, int]:
    """(SMs, blocks per SM) of a kernel on the current card, read once per
    process."""
    dev = torch.cuda.current_device()
    key = (dev, kind, wide)
    if key not in _limits:
        from ..kernels.build import csrc_library
        bps, sms = ctypes.c_int(0), ctypes.c_int(0)
        err = csrc_library(_SOURCE, _SIGNATURES).row_gather_limits(
            kind, int(wide), ctypes.byref(bps), ctypes.byref(sms))
        if err != 0 or bps.value < 1:
            raise RuntimeError(f"row_gather: cannot read the card's limits:"
                               f" CUDA error {err}")
        _limits[key] = (sms.value, bps.value)
    return _limits[key]


def _matrix(m: torch.Tensor, name: str) -> torch.Tensor:
    if m.dim() != 2:
        raise ValueError(f"{name} must be a 2-D matrix, got {tuple(m.shape)}")
    return m.contiguous()


def launcher(idx: torch.Tensor, a: torch.Tensor, b: Optional[torch.Tensor],
             nv: int):
    """One launch gathering rows of `a` (int32 (cap, la)) and, when given,
    of `b` (int32 (cap, lb)) by `idx`, its outputs allocated and its plan
    made here. Returns (oa, ob, plan, a callable that launches the kernel
    into them, or None when there is nothing to copy). It counts no
    launch."""
    dev = a.device
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError("the gather index must be a 1-D int32 tensor")
    if idx.device != dev or (b is not None and b.device != dev):
        raise ValueError("index and matrices must be on one device")
    if b is not None and b.shape[0] != a.shape[0]:
        raise ValueError("both matrices need the same row count")
    idx = idx.contiguous()
    n, cap, la = idx.shape[0], a.shape[0], a.shape[1]
    lb = b.shape[1] if b is not None else 0
    oa = torch.empty((n, la), dtype=torch.int32, device=dev)
    ob = torch.empty((n, lb), dtype=torch.int32, device=dev) \
        if b is not None else None
    if n * (la + lb) == 0:
        return oa, ob, None, None
    from ..kernels.build import csrc_library
    p = plan(n, cap, la, lb, (a.data_ptr(), oa.data_ptr()),
             (b.data_ptr(), ob.data_ptr()) if b is not None else (),
             card_limits)
    lib = csrc_library(_SOURCE, _SIGNATURES)
    args = (p.kind, int(p.wide), p.grid, idx.data_ptr(), n, cap,
            a.data_ptr(), la, oa.data_ptr(),
            b.data_ptr() if b is not None else None, lb,
            ob.data_ptr() if ob is not None else None, nv,
            torch.cuda.current_stream(dev).cuda_stream)

    def launch(keep=(idx, a, b, oa, ob)):
        # `keep` holds the tensors whose addresses `args` carries
        err = lib.row_gather_run(*args)
        if err != 0:
            raise RuntimeError(f"row_gather kernel launch failed: CUDA "
                               f"error {err}")

    return oa, ob, p, launch


def _launch(idx: torch.Tensor, a: torch.Tensor, b: Optional[torch.Tensor],
            nv: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    from ..obs.dispatch import kernel_site
    shape = (idx.shape[0], a.shape[1] + (b.shape[1] if b is not None else 0))
    with kernel_site("dma_row_gather", shape, a.device,
                     counter=dma_row_gather) as site:
        oa, ob, _, launch = launcher(idx, a, b, nv)
        if launch is not None:
            launch()
            dma_row_gather.launches += 1
            site.count()
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
    gi, gfb = _launch(idx, imat, _fbits(fmat), plan.n_valid_lanes)
    gf = gfb.view(torch.float64) if gfb is not None else None
    return gi, gf


def _fbits(fmat: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The f64 matrix as int32 (cap, 2 * lanes), the kernel's `b`."""
    if fmat is None:
        return None
    fmat = _matrix(fmat, "fmat")
    if fmat.dtype != torch.float64:
        raise TypeError(f"fmat must be float64, not {fmat.dtype}")
    return fmat.view(torch.int32)


def gather_launcher(plan, imat: torch.Tensor, fmat: Optional[torch.Tensor],
                    idx: torch.Tensor):
    """`launcher` for pallas_gather_rows' arguments on CUDA tensors:
    (oa, ob, plan, launch)."""
    return launcher(idx.to(torch.int32), _matrix(imat, "imat"),
                    _fbits(fmat), plan.n_valid_lanes)
