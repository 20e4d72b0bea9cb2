"""Fused probe-verify-emit for the hash join — the counterpart of
spark_rapids_tpu/ops/pallas_join.py (`fused_probe_verify`).

One pass over the flat candidate layout of ops/join.expand_candidates:
the owner stream row of each slot, its build position, exact equality of
the u32 key lanes and both validities, and the original build row. On
CUDA tensors the wrapper launches csrc/probe_verify.cu and adds one to
`fused_probe_verify.launches`; on CPU tensors it runs the plain version
(expand_candidates + lane verification); any other device raises.

Slots at or beyond the candidate total give (False, -1, -1, -1) on both
paths (the JAX package leaves build_pos there unspecified; every caller
masks those slots).
"""

from __future__ import annotations

import ctypes

import torch

from .join import expand_candidates

_SOURCE = "probe_verify.cu"
_P, _N = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {"probe_verify_run": [
    _P, _P, _N, _P, _P, _P, _N, _P, _P, ctypes.c_int, _P, _N,
    _P, _P, _P, _P, _P]}


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
    from ..kernels.build import csrc_library
    cum = torch.cumsum(counts, 0, dtype=torch.int32)
    total = torch.sum(counts, dtype=torch.int64).reshape(1)
    bk, sk = bk_lanes.contiguous(), sk_lanes.contiguous()
    lo, bvalid, svalid = lo.contiguous(), bvalid.contiguous(), \
        svalid.contiguous()
    perm = perm.contiguous()
    verified = torch.empty(out_capacity, dtype=torch.bool, device=dev)
    s_idx, b_pos, b_row = (torch.empty(out_capacity, dtype=torch.int32,
                                       device=dev) for _ in range(3))
    if out_capacity == 0:
        return verified, s_idx, b_pos, b_row
    lib = csrc_library(_SOURCE, _SIGNATURES)
    err = lib.probe_verify_run(
        cum.data_ptr(), lo.data_ptr(), counts.shape[0], total.data_ptr(),
        bk.data_ptr(), bvalid.data_ptr(), perm.shape[0], sk.data_ptr(),
        svalid.data_ptr(), bk.shape[1], perm.data_ptr(), out_capacity,
        verified.data_ptr(), s_idx.data_ptr(), b_pos.data_ptr(),
        b_row.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_probe_verify kernel launch failed: CUDA "
                           f"error {err}")
    fused_probe_verify.launches += 1
    return verified, s_idx, b_pos, b_row


fused_probe_verify.launches = 0
