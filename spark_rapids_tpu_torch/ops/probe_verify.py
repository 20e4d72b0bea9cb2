"""Fused probe-verify-emit for the hash join — the counterpart of
spark_rapids_tpu/ops/pallas_join.py (`fused_probe_verify`).

One pass over the flat candidate layout of ops/join.expand_candidates:
the owner stream row of each slot, its build position, exact equality of
the u32 key lanes and both validities, and the original build row. On
CUDA tensors the wrapper runs csrc/probe_verify.cu (one launch scans the
counts and writes every slot; the wrapper runs no prefix sum) and adds
one to
`fused_probe_verify.launches`; on CPU tensors it runs the plain version
(expand_candidates + lane verification); any other device raises.

The launch shape is chosen on the host by pure functions: `tile_count`
and `grid` (csrc/probe_verify.cu says why). The kernel's scratch (two
tickets, the total, a count of finished blocks and one word per chunk of
tiles) is kept per device and stream, zeroed once when it is allocated;
each launch leaves it zero. `launcher` prepares the launch for timing it
alone.

Slots at or beyond the candidate total give (False, -1, -1, -1) on both
paths (the JAX package leaves build_pos there unspecified; every caller
masks those slots).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .join import expand_candidates

_SOURCE = "probe_verify.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "probe_verify_run": [_P, _P, _I, _I, _I, _P, _P, _I, _P, _P, _I, _P, _I,
                         _P, _P, _P, _P, _P, _P],
    "probe_verify_limits": [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]}

#: stream rows per tile and scratch words before the chunks' (TILE and
#: SCRATCH_HEAD of csrc/probe_verify.cu)
TILE = 4096
SCRATCH_HEAD = 4


def tile_count(n_stream: int) -> int:
    """Tiles of TILE stream rows."""
    return -(-n_stream // TILE)


def grid(n_tiles: int, sms: int, blocks_per_sm: int) -> Tuple[int, int]:
    """(tiles a block takes, blocks) of the launch: one wave of the card,
    each block a chunk of whole tiles, taken in the order of an atomic
    ticket; one block of one (empty) tile when there is no stream row, to
    write the slots."""
    per = -(-max(n_tiles, 1) // max(1, sms * blocks_per_sm))
    return per, -(-max(n_tiles, 1) // per)


_limits: Dict[Tuple[int, int], Tuple[int, int]] = {}
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def card_limits(dev: torch.device, n_lanes: int) -> Tuple[int, int]:
    """(SMs, blocks of the scan-and-emit kernel per SM) on the card, read
    once per process."""
    key = (dev.index, n_lanes if n_lanes in (1, 2) else 0)
    if key not in _limits:
        from ..kernels.build import csrc_library
        bps, sms = ctypes.c_int(0), ctypes.c_int(0)
        err = csrc_library(_SOURCE, _SIGNATURES).probe_verify_limits(
            n_lanes, ctypes.byref(bps), ctypes.byref(sms))
        if err != 0 or bps.value < 1:
            raise RuntimeError(f"probe_verify: cannot read the card's "
                               f"limits: CUDA error {err}")
        _limits[key] = (sms.value, bps.value)
    return _limits[key]


def scratch_for(dev: torch.device, stream: int, n_chunks: int
                ) -> torch.Tensor:
    """The zeroed scratch of launches on `stream`, at least SCRATCH_HEAD +
    n_chunks int64 words: allocated (and zeroed) when it must grow, else
    the one the last launch on that stream left zero."""
    key = (dev.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.shape[0] < SCRATCH_HEAD + n_chunks:
        buf = torch.zeros(SCRATCH_HEAD + max(n_chunks, 1), dtype=torch.int64,
                          device=dev)
        _scratch[key] = buf
    return buf


def fused_probe_verify_plain(lo, counts, bk_lanes, bvalid, sk_lanes, svalid,
                             perm, out_capacity: int):
    """The plain PyTorch version of the kernel, on any device."""
    s_idx, b_pos, _ = expand_candidates(lo, counts, out_capacity)
    in_range = s_idx >= 0
    if counts.shape[0] == 0:
        return in_range, s_idx, s_idx.clone(), s_idx.clone()
    cap = perm.shape[0]
    safe_b = torch.clamp(b_pos, 0, cap - 1).long()
    safe_s = torch.clamp(s_idx, min=0).long()
    ok = in_range & bvalid[safe_b] & svalid[safe_s]
    ok = ok & (bk_lanes[safe_b] == sk_lanes[safe_s]).all(dim=1)
    b_pos = torch.where(in_range, b_pos, -1)
    pos_ok = (b_pos >= 0) & (b_pos < cap)
    b_row = torch.where(pos_ok, perm[safe_b], -1)
    return ok, s_idx, b_pos, b_row


def _check(lo, counts, bk_lanes, bvalid, sk_lanes, svalid, perm):
    n, cap = counts.shape[0], perm.shape[0]
    for name, t, dt, shape in (
            ("lo", lo, torch.int32, (n,)),
            ("counts", counts, torch.int32, (n,)),
            ("bk_lanes", bk_lanes, torch.int32, (cap, bk_lanes.shape[1])),
            ("bvalid", bvalid, torch.bool, (cap,)),
            ("sk_lanes", sk_lanes, torch.int32, (n, bk_lanes.shape[1])),
            ("svalid", svalid, torch.bool, (n,)),
            ("perm", perm, torch.int32, (cap,))):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise TypeError(f"{name}: expected {dt} {shape}, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != perm.device:
            raise ValueError(f"{name} is on {t.device}, not {perm.device}")


def launcher(lo, counts, bk_lanes, bvalid, sk_lanes, svalid, perm,
             out_capacity: int):
    """One launch of the kernel on CUDA tensors, its outputs allocated and
    its grid chosen here. Returns ((verified, stream_idx, build_pos,
    build_row), a callable that launches the kernel into them, or None
    when there is no slot). It counts no launch."""
    _check(lo, counts, bk_lanes, bvalid, sk_lanes, svalid, perm)
    n, cap, n_lanes = counts.shape[0], perm.shape[0], bk_lanes.shape[1]
    if out_capacity >= (1 << 31):
        raise NotImplementedError(
            "candidate buckets of 2^31 or more wait for the int64 "
            "expansion (ROADMAP A.3)")
    dev = perm.device
    sms, bps = card_limits(dev, n_lanes) if out_capacity else (1, 1)
    per, n_chunks = grid(tile_count(n), sms, bps)
    if (n_chunks * per * TILE >= (1 << 31)
            or cap * max(n_lanes, 1) >= (1 << 31)):
        raise NotImplementedError(
            "probe sides of 2^31 rows or lanes wait for the int64 "
            "expansion (ROADMAP A.3)")
    verified = torch.empty(out_capacity, dtype=torch.bool, device=dev)
    s_idx, b_pos, b_row = (torch.empty(out_capacity, dtype=torch.int32,
                                       device=dev) for _ in range(3))
    outs = (verified, s_idx, b_pos, b_row)
    if out_capacity == 0:
        return outs, None
    from ..kernels.build import csrc_library
    lib = csrc_library(_SOURCE, _SIGNATURES)
    ins = [x.contiguous() for x in (counts, lo, bk_lanes, bvalid, sk_lanes,
                                    svalid, perm)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = scratch_for(dev, stream, n_chunks)
    c, l, bk, bv, sk, sv, pm = ins
    args = (c.data_ptr(), l.data_ptr(), n, per, n_chunks, bk.data_ptr(),
            bv.data_ptr(), cap, sk.data_ptr(), sv.data_ptr(), n_lanes,
            pm.data_ptr(), out_capacity, verified.data_ptr(),
            s_idx.data_ptr(), b_pos.data_ptr(), b_row.data_ptr(),
            scratch.data_ptr(), stream)

    def launch(keep=(ins, outs, scratch)):
        # `keep` holds the tensors whose addresses `args` carries
        err = lib.probe_verify_run(*args)
        if err != 0:
            raise RuntimeError(f"fused_probe_verify kernel launch failed: "
                               f"CUDA error {err}")

    return outs, launch


def fused_probe_verify(lo, counts, bk_lanes, bvalid, sk_lanes, svalid, perm,
                       out_capacity: int):
    """One-pass probe of a bucketed build side.

    lo/counts: per-stream-row candidate range (ops/join.probe_counts);
    bk_lanes/sk_lanes: int32 (rows, L) u32 equality lanes, the build side
    in SORTED order (BuildTable.key_lanes); bvalid/svalid: bool key
    validity; perm: sorted position -> original build row.

    Returns (verified bool, stream_idx, build_pos, build_row), int32 each,
    over `out_capacity` flat candidate slots."""
    _check(lo, counts, bk_lanes, bvalid, sk_lanes, svalid, perm)
    if out_capacity >= (1 << 31):
        raise NotImplementedError(
            "candidate buckets of 2^31 or more wait for the int64 "
            "expansion (ROADMAP A.3)")
    dev = perm.device
    if dev.type == "cpu":
        return fused_probe_verify_plain(lo, counts, bk_lanes, bvalid,
                                        sk_lanes, svalid, perm, out_capacity)
    if dev.type != "cuda":
        raise ValueError(f"fused_probe_verify runs on cuda or cpu, not {dev}")
    outs, launch = launcher(lo, counts, bk_lanes, bvalid, sk_lanes, svalid,
                            perm, out_capacity)
    if launch is not None:
        launch()
        fused_probe_verify.launches += 1
    return outs


fused_probe_verify.launches = 0
