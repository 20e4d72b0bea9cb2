"""Packed rows — the counterpart of spark_rapids_tpu/ops/rowpack.py.

Every fixed-width column of a batch packs into one u32 matrix (int32
tensor holding the bits) plus one f64 matrix, so a whole-batch row gather
is one pass over one or two matrices regardless of column count. The
layout is bit-identical to the JAX package's:

  lane 0..nv-1   validity bits, column c -> bit (c % 32) of lane (c // 32)
  data lanes     per column: 1 lane (<=32-bit, bitcast; 8/16-bit ints
                 sign-extended, bool 0/1), 2 lanes (64-bit ints,
                 little-endian), or none (f64 data goes to the f64
                 matrix; its validity still rides the u32 bits)

`gather_rows` here is the plain version of the row gather: the gather
engine (ops/gather.py) routes CUDA tensors to the Hopper kernel
(ops/row_gather.py) instead.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..columnar.column import Column

__all__ = [
    "is_packable", "pack_rows", "gather_rows", "unpack_rows", "PackPlan",
]


class PackPlan(NamedTuple):
    """Static description of a pack: per-column (kind, lane), torch and
    engine dtypes."""

    kinds: Tuple                  # ('w1'|'w2'|'f64', lane_index)
    torch_dtypes: Tuple           # torch dtype per column
    dtypes: Tuple                 # engine DataType per column
    n_valid_lanes: int
    n_data_lanes: int
    n_f_lanes: int

    @property
    def n_ilanes(self) -> int:
        return self.n_valid_lanes + self.n_data_lanes


def is_packable(col: Column) -> bool:
    if type(col) is not Column:
        return False
    dt = col.data.dtype
    if dt.is_floating_point:
        return dt in (torch.float32, torch.float64)
    return dt.itemsize <= 8


def _plan(cols: Sequence[Column]) -> PackPlan:
    kinds: List = []
    n_data = n_f = 0
    for c in cols:
        dt = c.data.dtype
        if dt == torch.float64:
            kinds.append(("f64", n_f))
            n_f += 1
        elif dt.itemsize == 8:
            kinds.append(("w2", n_data))
            n_data += 2
        else:
            kinds.append(("w1", n_data))
            n_data += 1
    nv = max(1, -(-len(cols) // 32)) if cols else 0
    return PackPlan(tuple(kinds), tuple(c.data.dtype for c in cols),
                    tuple(c.dtype for c in cols), nv, n_data, n_f)


def pack_rows(cols: Sequence[Column]
              ) -> Tuple[PackPlan, torch.Tensor, Optional[torch.Tensor]]:
    """Pack columns into (plan, u32 matrix as int32, f64 matrix | None)."""
    plan = _plan(cols)
    cap = cols[0].capacity if cols else 0
    dev = cols[0].device if cols else None
    imat = torch.empty((cap, plan.n_ilanes), dtype=torch.int32, device=dev)
    fmat = torch.empty((cap, plan.n_f_lanes), dtype=torch.float64,
                       device=dev) if plan.n_f_lanes else None
    vlanes = [torch.zeros(cap, dtype=torch.int64, device=dev)
              for _ in range(plan.n_valid_lanes)]
    nv = plan.n_valid_lanes
    for ci, (c, (kind, lane)) in enumerate(zip(cols, plan.kinds)):
        vlanes[ci // 32] |= c.validity.to(torch.int64) << (ci % 32)
        d = c.data
        if kind == "f64":
            fmat[:, lane] = d
        elif kind == "w2":
            imat[:, nv + lane: nv + lane + 2] = d.view(torch.int32).view(
                cap, 2)
        elif d.dtype == torch.float32:
            imat[:, nv + lane] = d.view(torch.int32)
        else:
            imat[:, nv + lane] = d.to(torch.int32)
    for j, v in enumerate(vlanes):
        imat[:, j] = ((v ^ 0x80000000) - 0x80000000).to(torch.int32)
    return plan, imat, fmat


def gather_rows(plan: PackPlan, imat, fmat, idx):
    """Row gather with out-of-range masking: idx < 0 or >= capacity yields
    an all-invalid row (validity lanes zeroed; data lanes left as row 0)."""
    cap = imat.shape[0]
    in_range = (idx >= 0) & (idx < cap)
    safe = torch.where(in_range, idx, torch.zeros_like(idx)).long()
    g = imat[safe]
    nv = plan.n_valid_lanes
    if nv:
        g[:, :nv] = torch.where(in_range[:, None], g[:, :nv],
                                torch.zeros_like(g[:, :nv]))
    gf = fmat[safe] if fmat is not None else None
    return g, gf


def unpack_rows(plan: PackPlan, imat, fmat,
                only: Optional[Sequence[int]] = None) -> List[Column]:
    """Rebuild Columns from packed matrices (inverse of pack_rows).
    `only` restricts to a subset of column indices (plan order)."""
    out: List[Column] = []
    nv = plan.n_valid_lanes
    cols = range(len(plan.kinds)) if only is None else only
    for ci in cols:
        (kind, lane), tdt, edt = (plan.kinds[ci], plan.torch_dtypes[ci],
                                  plan.dtypes[ci])
        valid = ((imat[:, ci // 32] >> (ci % 32)) & 1) != 0
        if kind == "f64":
            d = fmat[:, lane]
        elif kind == "w2":
            d = imat[:, nv + lane: nv + lane + 2].contiguous().view(tdt)
            d = d.reshape(-1)
        else:
            u = imat[:, nv + lane]
            if tdt == torch.bool:
                d = u != 0
            elif tdt == torch.float32:
                d = u.contiguous().view(torch.float32)
            else:
                d = u.to(tdt)
        d = torch.where(valid, d, torch.zeros((), dtype=d.dtype,
                                              device=d.device))
        out.append(Column(d, valid, edt))
    return out
