"""Spark murmur3 on Hopper — the counterpart of `murmur3_long_lanes` and
`murmur3_int_lanes` in spark_rapids_tpu/ops/pallas_kernels.py, and of the
chain that spark_rapids_tpu/ops/hashing.murmur3_batch builds around them.

Three wrappers launch the one kernel template of csrc/murmur3.cu:

- `murmur3_columns(columns, seeds)`: Spark's Murmur3Hash over a list of
  fixed-width key columns (h = seed; h = valid ? murmur3(value, h) : h
  per column), for one seed or two from one read of the keys. A seed is
  an int (the same initial hash for every row) or an int32 tensor of
  per-row running hashes. A list of up to MAX_COLS columns is one launch;
  a longer one continues in further launches, each taking the running
  hashes as per-row seeds.
- `murmur3_long_lanes(data, seeds)` and `murmur3_int_lanes(data, seeds)`:
  the TPU kernels' own interface, one int64 or int32 lane with a u32 seed
  per row and no validity.

On CUDA tensors each wrapper launches the kernel and adds one to its own
`launches` count per launch; on CPU tensors it runs the plain version
(`murmur3_columns_plain`, ops/hashing.murmur3_*_plain; no launch); any
other device raises. Seeds and results are int32 tensors holding u32 bit
patterns.

`plan` chooses each launch's head, vector pieces and grid on the host from
the tensors' addresses; its parts are pure functions (`vector_bytes`,
`aligned`, `head_rows`, `grid_shape`, `column_groups`).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..types import (
    BooleanType, ByteType, DateType, DecimalType, DoubleType, FloatType,
    IntegerType, LongType, ShortType, TimestampNTZType, TimestampType,
)
from .hashing import (
    murmur3_batch_plain, murmur3_column_plain, murmur3_int_plain,
    murmur3_long_plain,
)

_SOURCE = "murmur3.cu"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "m3_run": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _LL, _LL,
               _I, _P],
    "m3_limits": [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
}

#: csrc/murmur3.cu's THREADS, ROWS (a thread's rows per step) and
#: MAX_COLS (key columns per launch)
THREADS = 256
ROWS = 4
MAX_COLS = 4

#: element kinds (csrc/murmur3.cu's K_*), by torch dtype of the data
KINDS = {torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
         torch.float32: 4, torch.int64: 5, torch.float64: 6}

#: the data dtype each hashable type holds
_DTYPES = ((BooleanType, torch.bool), (ByteType, torch.int8),
           (ShortType, torch.int16), (IntegerType, torch.int32),
           (DateType, torch.int32), (LongType, torch.int64),
           (TimestampType, torch.int64), (TimestampNTZType, torch.int64),
           (FloatType, torch.float32), (DoubleType, torch.float64))

Seed = Union[int, torch.Tensor]


def _data_dtype(dt) -> torch.dtype:
    """The torch dtype the kernel hashes a column of `dt` as; raises for
    the types it does not take. A DECIMAL(p<=18) hashes as its unscaled
    long, as in the JAX package."""
    if isinstance(dt, DecimalType) and not dt.is_decimal128:
        return torch.int64
    for cls, dtype in _DTYPES:
        if isinstance(dt, cls):
            return dtype
    raise NotImplementedError(
        f"the murmur3 kernel hashes fixed-width columns, not {dt}: strings "
        f"hash through ops/hashing.murmur3_batch (ROADMAP A.5); the JAX "
        f"package hashes no decimal128 by murmur3")


# -- the launch plan (pure functions) -----------------------------------------

class Plan(NamedTuple):
    head: int               # rows before the body (one a thread)
    body_end: int           # [head, body_end) in chunks of ROWS
    vec: Tuple[int, ...]    # per column: bit 0 data, bit 1 validity
    vec_io: int             # bit s: seed plane s; bit 2 + s: output s
    grid: int               # blocks


def vector_bytes(width: int) -> int:
    """The piece a thread's ROWS elements of `width` bytes load in."""
    return min(16, ROWS * width)


def aligned(addr: int, width: int, head: int) -> bool:
    """Whether every chunk of the body starting at row `head` of a tensor
    at `addr` loads in whole pieces."""
    return (addr + head * width) % vector_bytes(width) == 0


def head_rows(n: int, pointers: Sequence[Tuple[int, int]]) -> int:
    """The body's first row: of 0 .. ROWS - 1 (every phase of a piece),
    the one that puts the most bytes a row of (addr, width) pointers in
    whole pieces, the smallest on a tie; never past n."""
    best = max(range(ROWS), key=lambda h: (
        sum(w for a, w in pointers if aligned(a, w, h)), -h))
    return min(best, n)


def grid_shape(work: int, sms: int, blocks_per_sm: int) -> int:
    """Blocks of one launch: one wave of the card, fewer when `work`
    threads do not fill it."""
    return max(1, min(-(-work // THREADS), sms * blocks_per_sm))


def column_groups(n_cols: int) -> List[slice]:
    """The key columns of each launch, in chain order."""
    return [slice(i, min(i + MAX_COLS, n_cols))
            for i in range(0, n_cols, MAX_COLS)]


def plan(n: int, keys: Sequence[Tuple[int, int, Optional[int]]],
         seed_in: Sequence[Optional[int]], outs: Sequence[int],
         limits: Tuple[int, int]) -> Plan:
    """The launch over n rows of `keys` ((data address, width, validity
    address or None) a column), per-row seed planes `seed_in` (address or
    None a seed) and outputs `outs`; `limits` is (SMs, blocks per SM)."""
    ptrs = [(a, w) for a, w, _ in keys]
    ptrs += [(v, 1) for _, _, v in keys if v is not None]
    ptrs += [(a, 4) for a in list(seed_in) + list(outs) if a is not None]
    head = head_rows(n, ptrs)
    body_end = head + (n - head) // ROWS * ROWS
    vec = tuple(int(aligned(a, w, head))
                | (2 * int(v is not None and aligned(v, 1, head)))
                for a, w, v in keys)
    vec_io = 0
    for s, a in enumerate(seed_in):
        if a is not None and aligned(a, 4, head):
            vec_io |= 1 << s
    for s, a in enumerate(outs):
        if aligned(a, 4, head):
            vec_io |= 1 << (2 + s)
    work = max((body_end - head) // ROWS, head + n - body_end)
    return Plan(head, body_end, vec, vec_io, grid_shape(work, *limits))


_limits: Dict[Tuple[int, int, int], Tuple[int, int]] = {}


def card_limits(ncols: int, nseeds: int) -> Tuple[int, int]:
    """(SMs, blocks per SM) of the (ncols, nseeds) kernel on the current
    card, read once per process."""
    key = (torch.cuda.current_device(), ncols, nseeds)
    if key not in _limits:
        from ..kernels.build import csrc_library
        bps, sms = ctypes.c_int(0), ctypes.c_int(0)
        err = csrc_library(_SOURCE, _SIGNATURES).m3_limits(
            ncols, nseeds, ctypes.byref(bps), ctypes.byref(sms))
        if err != 0 or bps.value < 1:
            raise RuntimeError(f"murmur3: cannot read the card's limits: "
                               f"CUDA error {err}")
        _limits[key] = (sms.value, bps.value)
    return _limits[key]


# -- launches -----------------------------------------------------------------

#: one key column of a launch: (data, validity or None)
Key = Tuple[torch.Tensor, Optional[torch.Tensor]]


def _launch(wrapper, keys: Sequence[Key], seeds: Sequence[Seed], n: int
            ) -> List[torch.Tensor]:
    """One launch hashing up to MAX_COLS `keys` of n rows on the card into
    one int32 output per seed, counted on `wrapper` (no rows: no
    launch)."""
    from ..kernels.build import csrc_library
    dev = keys[0][0].device
    outs = [torch.empty(n, dtype=torch.int32, device=dev) for _ in seeds]
    if n == 0:
        return outs
    planes = [s if isinstance(s, torch.Tensor) else None for s in seeds]
    p = plan(n, [(d.data_ptr(), d.element_size(),
                  v.data_ptr() if v is not None else None) for d, v in keys],
             [s.data_ptr() if s is not None else None for s in planes],
             [o.data_ptr() for o in outs],
             card_limits(len(keys), len(seeds)))
    nc = len(keys)
    data = (_P * nc)(*[d.data_ptr() for d, _ in keys])
    valid = (_P * nc)(*[v.data_ptr() if v is not None else None
                        for _, v in keys])
    kinds = (_I * nc)(*[KINDS[d.dtype] for d, _ in keys])
    vec = (_I * nc)(*p.vec)
    ns = len(seeds)
    seed_in = (_P * ns)(*[s.data_ptr() if s is not None else None
                          for s in planes])
    out = (_P * ns)(*[o.data_ptr() for o in outs])
    scalars = (ctypes.c_uint * ns)(*[0 if isinstance(s, torch.Tensor)
                                     else s & 0xFFFFFFFF for s in seeds])
    err = csrc_library(_SOURCE, _SIGNATURES).m3_run(
        nc, ns, ctypes.addressof(data), ctypes.addressof(valid),
        ctypes.addressof(kinds), ctypes.addressof(vec),
        ctypes.addressof(seed_in), ctypes.addressof(out),
        ctypes.addressof(scalars), p.vec_io, n, ROWS, p.head, p.body_end,
        p.grid, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"murmur3 kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return outs


def _check_seeds(seeds: Sequence[Seed], n: int, dev: torch.device):
    if not 1 <= len(seeds) <= 2:
        raise ValueError(f"murmur3 takes one seed or two, not {len(seeds)}")
    for s in seeds:
        if isinstance(s, torch.Tensor):
            if s.dtype != torch.int32 or s.shape != (n,):
                raise ValueError(f"a per-row seed must be int32 of shape "
                                 f"({n},), not {s.dtype} {tuple(s.shape)}")
            if s.device != dev:
                raise ValueError("seeds and keys must be on one device")


def murmur3_columns(columns: Sequence, seeds: Sequence[Seed]
                    ) -> List[torch.Tensor]:
    """Spark Murmur3Hash(columns..., seed) for each seed -> int32 lanes of
    u32 bits: each column's hash is the next column's seed, and a null
    row leaves it unchanged. The kernel on CUDA tensors (one launch per
    MAX_COLS columns, whatever the seeds), the plain version on CPU
    tensors."""
    if not columns:
        raise ValueError("murmur3 needs at least one column")
    n = columns[0].capacity
    dev = columns[0].validity.device
    keys = []
    for col in columns:
        want = _data_dtype(col.dtype)
        if col.data.dtype != want or col.validity.dtype != torch.bool:
            raise TypeError(f"a {col.dtype} column holds {want} data and "
                            f"bool validity, not {col.data.dtype} and "
                            f"{col.validity.dtype}")
        if col.data.shape != (n,) or col.validity.shape != (n,):
            raise ValueError("key columns must be 1-D of one capacity")
        if col.data.device != dev or col.validity.device != dev:
            raise ValueError("key columns must be on one device")
        keys.append((col.data.contiguous(), col.validity.contiguous()))
    _check_seeds(seeds, n, dev)
    if dev.type == "cpu":
        return murmur3_columns_plain(columns, seeds)
    if dev.type != "cuda":
        raise ValueError(f"murmur3 runs on cuda or cpu, not {dev}")
    h: Sequence[Seed] = [s.contiguous() if isinstance(s, torch.Tensor)
                         else int(s) for s in seeds]
    for group in column_groups(len(keys)):
        h = _launch(murmur3_columns, keys[group], h, n)
    return list(h)


def murmur3_columns_plain(columns: Sequence, seeds: Sequence[Seed]
                          ) -> List[torch.Tensor]:
    """The plain version of murmur3_columns, on any device."""
    out = []
    for h in seeds:
        if not isinstance(h, torch.Tensor):
            out.append(murmur3_batch_plain(columns, int(h)))
            continue
        for col in columns:
            h = murmur3_column_plain(col, h)
        out.append(h)
    return out


def _lanes(wrapper, data: torch.Tensor, seeds: torch.Tensor,
           dtype: torch.dtype, plain) -> torch.Tensor:
    if data.dtype != dtype or seeds.dtype != torch.int32:
        raise TypeError(f"murmur3 lanes take {dtype} data and int32 seeds, "
                        f"got {data.dtype} and {seeds.dtype}")
    if data.dim() != 1 or seeds.shape != data.shape:
        raise ValueError("data and seeds must be 1-D of one length")
    if data.device != seeds.device:
        raise ValueError("data and seeds must be on one device")
    if data.device.type == "cpu":
        return plain(data, seeds)
    if data.device.type != "cuda":
        raise ValueError(f"murmur3 lanes run on cuda or cpu, not "
                         f"{data.device}")
    return _launch(wrapper, [(data.contiguous(), None)], [seeds.contiguous()],
                   data.shape[0])[0]


def murmur3_long_lanes(data_i64: torch.Tensor, seeds_u32: torch.Tensor
                       ) -> torch.Tensor:
    """Per-row murmur3 update over int64 lanes; seeds/result u32 bits."""
    return _lanes(murmur3_long_lanes, data_i64, seeds_u32, torch.int64,
                  murmur3_long_plain)


def murmur3_int_lanes(data_i32: torch.Tensor, seeds_u32: torch.Tensor
                      ) -> torch.Tensor:
    """Per-row murmur3 update over int32 lanes; seeds/result u32 bits."""
    return _lanes(murmur3_int_lanes, data_i32, seeds_u32, torch.int32,
                  murmur3_int_plain)


murmur3_columns.launches = 0
murmur3_long_lanes.launches = 0
murmur3_int_lanes.launches = 0
