"""Fused scan -> filter -> project -> masked-bucket partial aggregate — the
counterpart of spark_rapids_tpu/ops/pallas_fused.py (`ScanAggSpec`,
`compile_scan_agg_spec`, `fused_scan_agg_update`).

Structure:
- `compile_scan_agg_spec` accepts the operator chain an AggregateExec
  absorbs when every expression is in the whitelisted elementwise subset
  (the same eligibility rules as the JAX package), and translates the
  bound expressions into one CUDA `__device__` row function — Spark's
  whole-stage codegen idea. The TPU kernel calls the expressions'
  `columnar_eval` inside its body; here the emitter repeats those
  evaluation rules in C++, null rules included;
- the row function is pasted into csrc/fused_scan_agg.cu.in, which holds
  the hashing, bucketing and accumulation; one library is built per spec
  digest (kernels/build.py);
- `fused_scan_agg` is the wrapper: it launches the kernel for CUDA
  tensors and runs the plain version (`fused_scan_agg_plain`, plain
  PyTorch over ops/maskedagg.py) only for CPU tensors;
- the epilogue reduces nothing itself: it proves bucket cleanliness from
  the per-bucket statistics and dense-places the slots, returning
  ops/maskedagg.masked_groupby's (out_keys, results, num_groups, leftover)
  contract.

Bucketing is the round-0 bucket hash of masked_groupby, so with rounds=1
and the same G the plain version equals masked_groupby exactly.
"""

from __future__ import annotations

import ctypes
import math
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from ..columnar.column import Column
from ..types import LONG, DataType, numeric_promote
from .basic import active_mask
from .maskedagg import (
    _bucket_hash, _unorder_bits, acc_dtype, bucket_reduce, clean_buckets,
    key_bucket_stats, minmax_neutral, place_dense,
)
from .sort import INT64_MIN, _numeric_order_key, lane_bits

#: round-0 salt of ops/maskedagg.masked_group_assignment
_ROUND0_SALT = 0x2545F491

_SUPPORTED_EXPRS = {
    "BoundReference", "Literal", "Alias",
    "Add", "Subtract", "Multiply", "Divide", "UnaryMinus", "Abs",
    "EqualTo", "EqualNullSafe", "LessThan", "LessThanOrEqual",
    "GreaterThan", "GreaterThanOrEqual",
    "And", "Or", "Not", "IsNull", "IsNotNull",
}

_SUPPORTED_OPS = ("sum", "sum_sq", "count", "count_star", "min", "max")

_FUNCTIONS_MARK = "// @FUNCTIONS@\n"

TEMPLATE = Path(__file__).resolve().parents[1] / "csrc" / \
    "fused_scan_agg.cu.in"

#: threads per block of the two row kernels (the C side may use fewer when
#: the per-warp partials would not fit in shared memory)
BLOCK_THREADS = 256


@dataclass(eq=False)
class ScanAggSpec:
    steps: Tuple            # (("filter", bound) | ("project", bound, schema))*
    pre_bound: Tuple        # pre-projection expressions (keys + agg inputs)
    key_count: int
    agg_ops: Tuple          # ((op, pre-slot index | None), ...)
    key_dtypes: Tuple       # engine DataType per key
    agg_dtypes: Tuple       # input DataType per agg op (None for count_star)
    source_dtypes: Tuple    # DataType per source column
    cuda_source: str        # emitted spec part of the kernel (see emit_cuda)
    _lib: Optional[ctypes.CDLL] = field(default=None, repr=False)


def _expr_supported(expr) -> bool:
    name = type(expr).__name__
    if name not in _SUPPORTED_EXPRS:
        return False
    try:
        expr.data_type
    except (TypeError, NotImplementedError, ValueError):
        return False
    return all(_expr_supported(c) for c in getattr(expr, "children", ()))


def compile_scan_agg_spec(fused_steps, pre_bound, pre_schema, key_count: int,
                          agg_ops, source_schema) -> Optional[ScanAggSpec]:
    """Validate the absorbed operator chain for the fused kernel and emit
    its CUDA specialisation; None when any piece falls outside the
    whitelisted elementwise subset."""
    if key_count == 0 or not agg_ops:
        return None
    for f in source_schema.fields:
        if not f.data_type.is_fixed_width:
            return None
    for step in fused_steps:
        exprs = [step[1]] if step[0] == "filter" else list(step[1])
        if not all(_expr_supported(e) for e in exprs):
            return None
    if not all(_expr_supported(e) for e in pre_bound):
        return None
    key_dtypes = []
    for f in pre_schema.fields[:key_count]:
        tdt = f.data_type.torch_dtype
        # sub-32-bit keys keep the masked_groupby path, as in the JAX
        # package (their u8/u16 order lanes do not round-trip its u32
        # accumulator)
        if tdt is None or tdt == torch.bool or \
                torch.empty((), dtype=tdt).element_size() < 4:
            return None
        key_dtypes.append(f.data_type)
    agg_dtypes = []
    for op, slot in agg_ops:
        if op not in _SUPPORTED_OPS:
            return None
        if slot is None:
            if op != "count_star":
                return None
            agg_dtypes.append(None)
            continue
        dt = pre_schema.fields[slot].data_type
        if not dt.is_fixed_width:
            return None
        if op in ("sum", "sum_sq") and dt.torch_dtype == torch.bool:
            return None
        agg_dtypes.append(dt)
    spec = ScanAggSpec(tuple(fused_steps), tuple(pre_bound), key_count,
                       tuple(agg_ops), tuple(key_dtypes), tuple(agg_dtypes),
                       tuple(f.data_type for f in source_schema.fields), "")
    spec.cuda_source = emit_cuda(spec)
    return spec


# --------------------------------------------------------------------------
# plain version (PyTorch) and the shared epilogue
# --------------------------------------------------------------------------

class _TileBatch:
    """Minimal batch shim for columnar_eval: bound expressions only touch
    .columns, .capacity and .device."""

    def __init__(self, columns: List[Column], capacity: int, device):
        self.columns = columns
        self.capacity = capacity
        self.device = device


def _eval_pipeline(spec: ScanAggSpec, cols: List[Column], capacity: int,
                   device):
    """Run the absorbed filter/project chain + pre-projection. Returns
    (mask | None, key columns, agg input columns aligned with
    spec.agg_ops). Padding rows are not sanitized: the active mask keeps
    them out of every bucket and reduction."""
    cur = list(cols)
    mask = None
    for step in spec.steps:
        batch = _TileBatch(cur, capacity, device)
        if step[0] == "filter":
            pred = step[1].columnar_eval(batch)
            m = pred.data & pred.validity
            mask = m if mask is None else (mask & m)
        else:
            cur = [e.columnar_eval(batch) for e in step[1]]
    batch = _TileBatch(cur, capacity, device)
    pre = [e.columnar_eval(batch) for e in spec.pre_bound]
    keys = pre[: spec.key_count]
    agg_cols = [None if slot is None else pre[slot]
                for _, slot in spec.agg_ops]
    return mask, keys, agg_cols


def _partials_plain(spec: ScanAggSpec, batch, G: int):
    """Per-bucket statistics in plain PyTorch: per key (min lane, max lane,
    any valid, any null), per aggregate (accumulator, has-valid or None
    for the counts)."""
    cap = batch.capacity
    mask, keys, agg_cols = _eval_pipeline(spec, list(batch.columns), cap,
                                          batch.device)
    act = active_mask(batch.num_rows, cap)
    if mask is not None:
        act = act & mask
    b = _bucket_hash(keys, _ROUND0_SALT, cap) % G
    lanes = [_numeric_order_key(k) for k in keys]
    kstats = key_bucket_stats(keys, lanes, b, G, act)
    clean, occupied = clean_buckets(kstats)
    m1 = act & (clean & occupied)[b]
    astats = [bucket_reduce(op, c, b, G, m1)
              for (op, _), c in zip(spec.agg_ops, agg_cols)]
    return kstats, astats


def _finish(spec: ScanAggSpec, kstats, astats, out_cap: int):
    """Epilogue on G-element tensors: prove cleanliness, place dense."""
    clean, occupied = clean_buckets(kstats)
    resolved = clean & occupied
    leftover = torch.any(occupied & ~clean)
    num_groups = torch.sum(resolved, dtype=torch.int32)
    dense = torch.cumsum(resolved.to(torch.int32), 0) - 1
    target = torch.where(resolved, dense, torch.full_like(dense, out_cap))

    out_keys = []
    for (mn, _, av, _), dt in zip(kstats, spec.key_dtypes):
        d, v = place_dense(_unorder_bits(mn, dt), av, resolved, target,
                           out_cap)
        out_keys.append(Column(torch.where(v, d, torch.zeros_like(d)), v, dt))
    results = []
    for acc, has in astats:
        if has is None:  # count / count_star: never null
            acc = acc.to(torch.int64)
            has = torch.ones_like(resolved)
        results.append(("raw", place_dense(acc, has, resolved, target,
                                           out_cap)))
    return out_keys, results, num_groups, leftover


def fused_scan_agg_plain(spec: ScanAggSpec, batch, G: int, out_cap: int):
    """The plain PyTorch version of the kernel, on any device."""
    kstats, astats = _partials_plain(spec, batch, G)
    return _finish(spec, kstats, astats, out_cap)


# --------------------------------------------------------------------------
# the CUDA kernel
# --------------------------------------------------------------------------

def fused_scan_agg(spec: ScanAggSpec, batch, G: int, out_cap: int):
    """ONE fused pass over a source batch -> masked-bucket partial.

    Returns (out_keys, tagged results, num_groups, leftover), exactly
    ops/maskedagg.masked_groupby's contract, dense-placed into an
    `out_cap` bucket. CUDA tensors launch the kernel; CPU tensors take the
    plain version; any other device raises."""
    if G > 32:
        raise ValueError(f"the clean-bucket bitmask is u32: G={G} > 32")
    dev = batch.device
    if dev.type == "cpu":
        return fused_scan_agg_plain(spec, batch, G, out_cap)
    if dev.type != "cuda":
        raise ValueError(f"fused_scan_agg runs on cuda or cpu, not {dev}")
    kstats, astats = _partials_cuda(spec, batch, G)
    return _finish(spec, kstats, astats, out_cap)


fused_scan_agg.launches = 0


def kernel_source(spec: ScanAggSpec) -> str:
    """The full CUDA source of the spec's kernel: the template with the
    emitted specialisation pasted in."""
    sizes, functions = spec.cuda_source.split(_FUNCTIONS_MARK)
    return TEMPLATE.read_text().replace("// @SIZES@\n", sizes).replace(
        _FUNCTIONS_MARK, functions)


def _library(spec: ScanAggSpec) -> ctypes.CDLL:
    if spec._lib is None:
        from ..kernels import build
        lib = build.load(build.build(kernel_source(spec)))
        fn = lib.fsa_run
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + \
            [ctypes.c_void_p] * 6
        spec._lib = lib
    return spec._lib


def _slots(spec: ScanAggSpec) -> Tuple[int, int]:
    return 4 * spec.key_count, 2 * len(spec.agg_ops)


def _partials_cuda(spec: ScanAggSpec, batch, G: int):
    cols = batch.columns
    if len(cols) != len(spec.source_dtypes):
        raise ValueError(f"spec expects {len(spec.source_dtypes)} source "
                         f"columns, batch has {len(cols)}")
    dev = batch.device
    for c, dt in zip(cols, spec.source_dtypes):
        if c.data.dtype != dt.torch_dtype or c.validity.dtype != torch.bool:
            raise TypeError(f"column {c!r} does not match spec type {dt}")
        if c.data.device != dev or c.validity.device != dev:
            raise ValueError("all columns must be on the batch's device")
        if not (c.data.is_contiguous() and c.validity.is_contiguous()):
            raise ValueError("columns must be contiguous")
    nrows = batch.num_rows
    if nrows.dtype != torch.int32 or nrows.device != dev:
        raise TypeError("num_rows must be an int32 scalar on the device")
    lib = _library(spec)
    S0, S1 = _slots(spec)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_blocks = max(1, min(math.ceil(batch.capacity / BLOCK_THREADS),
                          4 * sms))
    u64 = torch.int64
    part0 = torch.empty(n_blocks * G * S0, dtype=u64, device=dev)
    kstat = torch.empty((G, S0), dtype=u64, device=dev)
    bits = torch.empty(1, dtype=torch.int32, device=dev)
    part1 = torch.empty(n_blocks * G * S1, dtype=u64, device=dev)
    aggout = torch.empty((G, S1), dtype=u64, device=dev)
    data_ptrs = (ctypes.c_void_p * len(cols))(
        *[c.data.data_ptr() for c in cols])
    valid_ptrs = (ctypes.c_void_p * len(cols))(
        *[c.validity.data_ptr() for c in cols])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fsa_run(ctypes.cast(data_ptrs, ctypes.c_void_p),
                      ctypes.cast(valid_ptrs, ctypes.c_void_p),
                      nrows.data_ptr(), batch.capacity, G, n_blocks,
                      part0.data_ptr(), kstat.data_ptr(), bits.data_ptr(),
                      part1.data_ptr(), aggout.data_ptr(), stream)
    fused_scan_agg.launches += 1
    if err != 0:
        raise RuntimeError(f"fused_scan_agg kernel launch failed: CUDA "
                           f"error {err}")
    return _unpack_partials(spec, kstat, aggout)


def _unpack_partials(spec: ScanAggSpec, kstat, aggout):
    """Kernel words -> the plain version's statistics layout."""
    kstats = []
    for k, dt in enumerate(spec.key_dtypes):
        mn, mx = kstat[:, 4 * k], kstat[:, 4 * k + 1]
        if lane_bits(dt.torch_dtype) == 64:  # u64 words -> signed lanes
            mn, mx = mn ^ INT64_MIN, mx ^ INT64_MIN
        kstats.append((mn, mx, kstat[:, 4 * k + 2] != 0,
                       kstat[:, 4 * k + 3] != 0))
    astats = []
    for a, ((op, _), dt) in enumerate(zip(spec.agg_ops, spec.agg_dtypes)):
        word = aggout[:, 2 * a].contiguous()
        if op in ("count", "count_star"):
            astats.append((word.to(torch.int32), None))
            continue
        adt = acc_dtype(op, dt.torch_dtype)
        vals = word.view(torch.float64).to(adt) if adt.is_floating_point \
            else word.to(adt)
        astats.append((vals, aggout[:, 2 * a + 1] != 0))
    return kstats, astats


# --------------------------------------------------------------------------
# the emitter: bound expressions -> CUDA C++
# --------------------------------------------------------------------------

_CTYPES = {
    torch.bool: "bool", torch.int8: "signed char", torch.int16: "short",
    torch.int32: "int", torch.int64: "long long", torch.float32: "float",
    torch.float64: "double",
}

_OP_CODES = {"sum": "OP_SUM", "sum_sq": "OP_SUM_SQ", "count": "OP_COUNT",
             "count_star": "OP_COUNT_STAR", "min": "OP_MIN", "max": "OP_MAX"}


def _ctype(dt: DataType) -> str:
    return _CTYPES[dt.torch_dtype]


def _is_float(dt: DataType) -> bool:
    return dt.torch_dtype.is_floating_point


def _utype(dt: DataType) -> str:
    """Unsigned type whose arithmetic wraps like the signed lane's."""
    return "unsigned long long" if dt.torch_dtype == torch.int64 \
        else "unsigned int"


def _c_literal(value, dt: DataType) -> str:
    tdt = dt.torch_dtype
    if tdt == torch.bool:
        return "true" if value else "false"
    if tdt == torch.float64:
        bits = struct.unpack("<q", struct.pack("<d", float(value)))[0]
        return f"__longlong_as_double({bits}LL)"
    if tdt == torch.float32:
        bits = struct.unpack("<i", struct.pack("<f", float(value)))[0]
        return f"__int_as_float({bits})"
    v = int(value)
    if tdt == torch.int64:
        # -2^63 has no literal form
        return f"({v + 1}LL - 1LL)" if v == INT64_MIN else f"{v}LL"
    return f"(({_ctype(dt)}){v})"


class _Emitter:
    """Translates bound expressions to straight-line C++ over one row.
    Each value is an (expression name, validity name, DataType) triple."""

    def __init__(self, source_dtypes):
        self.lines: List[str] = []
        self.n = 0
        self.source_dtypes = source_dtypes
        self.loaded = {}

    def tmp(self) -> str:
        self.n += 1
        return f"t{self.n}"

    def line(self, s: str) -> None:
        self.lines.append("    " + s)

    def source(self, ordinal: int):
        if ordinal not in self.loaded:
            dt = self.source_dtypes[ordinal]
            ct = _ctype(dt)
            x, v = f"c{ordinal}", f"c{ordinal}v"
            if dt.torch_dtype == torch.bool:
                self.line(f"const bool {x} = ((const unsigned char*)"
                          f"cols.data[{ordinal}])[row] != 0;")
            else:
                self.line(f"const {ct} {x} = ((const {ct}*)"
                          f"cols.data[{ordinal}])[row];")
            self.line(f"const bool {v} = cols.valid[{ordinal}][row] != 0;")
            self.loaded[ordinal] = (x, v, dt)
        return self.loaded[ordinal]

    def cast(self, x: str, frm: DataType, to: DataType) -> str:
        return x if frm == to else f"(({_ctype(to)}){x})"

    def emit(self, e, env):
        name = type(e).__name__
        fn = getattr(self, "_" + name, None)
        if fn is None:
            raise NotImplementedError(f"no CUDA emission for {name}")
        return fn(e, env)

    # -- leaves ------------------------------------------------------------
    def _BoundReference(self, e, env):
        return env[e.ordinal]

    def _Literal(self, e, env):
        return _c_literal(e.value, e.data_type), "true", e.data_type

    def _Alias(self, e, env):
        return self.emit(e.children[0], env)

    # -- arithmetic --------------------------------------------------------
    def _binary(self, e, env, op: str):
        lx, lv, lt = self.emit(e.left, env)
        rx, rv, rt = self.emit(e.right, env)
        out = e.data_type
        if out.torch_dtype == torch.bool:
            raise NotImplementedError("boolean arithmetic")
        a, b = self.cast(lx, lt, out), self.cast(rx, rt, out)
        if _is_float(out):
            val = f"{a} {op} {b}"
        else:
            u = _utype(out)
            val = f"({_ctype(out)})(({u}){a} {op} ({u}){b})"
        x, v = self.tmp(), self.tmp()
        self.line(f"const bool {v} = {lv} && {rv};")
        self.line(f"const {_ctype(out)} {x} = {v} ? ({val}) : "
                  f"({_ctype(out)})0;")
        return x, v, out

    def _Add(self, e, env):
        return self._binary(e, env, "+")

    def _Subtract(self, e, env):
        return self._binary(e, env, "-")

    def _Multiply(self, e, env):
        return self._binary(e, env, "*")

    def _Divide(self, e, env):
        lx, lv, lt = self.emit(e.left, env)
        rx, rv, rt = self.emit(e.right, env)
        out = e.data_type  # DOUBLE
        a, b = self.cast(lx, lt, out), self.cast(rx, rt, out)
        x, v = self.tmp(), self.tmp()
        self.line(f"const bool {v} = {lv} && {rv} && {b} != 0.0;")
        self.line(f"const double {x} = {v} ? {a} / {b} : 0.0;")
        return x, v, out

    def _UnaryMinus(self, e, env):
        cx, cv, ct = self.emit(e.children[0], env)
        x = self.tmp()
        if _is_float(ct):
            val = f"-{cx}"
        else:
            val = f"({_ctype(ct)})(({_utype(ct)})0 - ({_utype(ct)}){cx})"
        self.line(f"const {_ctype(ct)} {x} = {val};")
        return x, cv, ct

    def _Abs(self, e, env):
        cx, cv, ct = self.emit(e.children[0], env)
        x = self.tmp()
        if _is_float(ct):
            fn = "fabsf" if ct.torch_dtype == torch.float32 else "fabs"
            val = f"{fn}({cx})"
        else:
            neg = f"({_ctype(ct)})(({_utype(ct)})0 - ({_utype(ct)}){cx})"
            val = f"{cx} < 0 ? {neg} : {cx}"
        self.line(f"const {_ctype(ct)} {x} = {val};")
        return x, cv, ct

    # -- predicates --------------------------------------------------------
    def _compare(self, e, env, op: str):
        lx, lv, lt = self.emit(e.left, env)
        rx, rv, rt = self.emit(e.right, env)
        common = lt if lt == rt else numeric_promote(lt, rt)
        a, b = self.cast(lx, lt, common), self.cast(rx, rt, common)
        x, v = self.tmp(), self.tmp()
        self.line(f"const bool {v} = {lv} && {rv};")
        if _is_float(common):
            self.line(f"const bool {x} = spark_cmp({a}, {b}) {op} 0 "
                      f"&& {v};")
        else:
            self.line(f"const bool {x} = ({a} {op} {b}) && {v};")
        return x, v, e.data_type

    def _EqualTo(self, e, env):
        return self._compare(e, env, "==")

    def _LessThan(self, e, env):
        return self._compare(e, env, "<")

    def _LessThanOrEqual(self, e, env):
        return self._compare(e, env, "<=")

    def _GreaterThan(self, e, env):
        return self._compare(e, env, ">")

    def _GreaterThanOrEqual(self, e, env):
        return self._compare(e, env, ">=")

    def _EqualNullSafe(self, e, env):
        lx, lv, lt = self.emit(e.left, env)
        rx, rv, rt = self.emit(e.right, env)
        if _is_float(lt) or _is_float(rt):
            eq = f"spark_cmp((double){lx}, (double){rx}) == 0"
        else:
            eq = f"(long long){lx} == (long long){rx}"
        x = self.tmp()
        self.line(f"const bool {x} = ({lv} && {rv} && {eq}) || "
                  f"(!{lv} && !{rv});")
        return x, "true", e.data_type

    def _And(self, e, env):
        lx, lv, _ = self.emit(e.children[0], env)
        rx, rv, _ = self.emit(e.children[1], env)
        x, v = self.tmp(), self.tmp()
        self.line(f"const bool {v} = ({lv} && {rv}) || ({lv} && !{lx}) || "
                  f"({rv} && !{rx});")
        self.line(f"const bool {x} = {lx} && {lv} && {rx} && {rv} && {v};")
        return x, v, e.data_type

    def _Or(self, e, env):
        lx, lv, _ = self.emit(e.children[0], env)
        rx, rv, _ = self.emit(e.children[1], env)
        x, v = self.tmp(), self.tmp()
        self.line(f"const bool {x} = ({lv} && {lx}) || ({rv} && {rx});")
        self.line(f"const bool {v} = ({lv} && {rv}) || {x};")
        return x, v, e.data_type

    def _Not(self, e, env):
        cx, cv, _ = self.emit(e.children[0], env)
        x = self.tmp()
        self.line(f"const bool {x} = !{cx} && {cv};")
        return x, cv, e.data_type

    def _IsNull(self, e, env):
        _, cv, _ = self.emit(e.children[0], env)
        return f"(!{cv})", "true", e.data_type

    def _IsNotNull(self, e, env):
        _, cv, _ = self.emit(e.children[0], env)
        return cv, "true", e.data_type


def emit_cuda(spec: ScanAggSpec) -> str:
    """The spec's part of the kernel source: sizes, initial and combine
    kinds of the partial slots, and the per-row functions `scan_row` (the
    absorbed chain), `bucket_of`, `phase0_step` and `phase1_step`."""
    em = _Emitter(spec.source_dtypes)
    env = _LazySources(em)
    keep = []
    for step in spec.steps:
        if step[0] == "filter":
            x, v, _ = em.emit(step[1], env)
            keep.append(f"({x} && {v})")
        else:
            env = [em.emit(e, env) for e in step[1]]
    pre = [em.emit(e, env) for e in spec.pre_bound]
    em.line(f"r.keep = {' && '.join(keep) if keep else 'true'};")
    for k, (x, v, dt) in enumerate(pre[: spec.key_count]):
        em.line(f"r.kbits[{k}] = order_bits({x});")
        em.line(f"r.kvalid[{k}] = {v};")
    for a, ((op, slot), dt) in enumerate(zip(spec.agg_ops, spec.agg_dtypes)):
        if slot is None:
            continue
        x, v, xdt = pre[slot]
        field_ = "af" if _is_float(xdt) else "ai"
        cty = "double" if _is_float(xdt) else "long long"
        em.line(f"r.{field_}[{a}] = ({cty}){x};")
        em.line(f"r.avalid[{a}] = {v};")

    K, A = spec.key_count, len(spec.agg_ops)
    S0, S1 = _slots(spec)
    out = [
        f"#define N_COLS {len(spec.source_dtypes)}",
        f"#define N_KEYS {K}",
        f"#define N_AGGS {A}",
        f"#define S0 {S0}",
        f"#define S1 {S1}",
        "",
        _FUNCTIONS_MARK.rstrip("\n"),
    ]
    init0, kind0, steps0, hash_lines = [], [], [], []
    for k, dt in enumerate(spec.key_dtypes):
        bits = lane_bits(dt.torch_dtype)
        neutral = "0xFFFFFFFFFFFFFFFFull" if bits == 64 else "0xFFFFFFFFull"
        init0 += [neutral, "0ull", "0ull", "0ull"]
        kind0 += ["K_MIN_U", "K_MAX_U", "K_OR", "K_OR"]
        steps0.append(f"    key_step(mine, r.kvalid[{k}], r.kbits[{k}], "
                      f"{neutral}, g, lane, acc + {4 * k});")
        if bits == 64:
            hash_lines += [
                f"    h = mix32(h ^ (unsigned)r.kbits[{k}], SALT);",
                f"    h = mix32(h ^ (unsigned)(r.kbits[{k}] >> 32), "
                f"SALT + 0x51u);"]
        else:
            hash_lines.append(
                f"    h = mix32(h ^ (unsigned)r.kbits[{k}], SALT);")
        hash_lines.append(f"    h = mix32(h ^ (unsigned)r.kvalid[{k}], "
                          f"SALT + 0xA3u);")
    init1, kind1, steps1 = [], [], []
    for a, ((op, _), dt) in enumerate(zip(spec.agg_ops, spec.agg_dtypes)):
        acc = f"acc + {2 * a}"
        if op == "count_star":
            init1 += ["0ull", "0ull"]
            kind1 += ["K_SUM_I", "K_OR"]
            steps1.append(f"    count_star_step(peers, g, lane, {acc});")
            continue
        if op == "count":
            init1 += ["0ull", "0ull"]
            kind1 += ["K_SUM_I", "K_OR"]
            steps1.append(f"    count_step(mine, r.avalid[{a}], g, lane, "
                          f"{acc});")
            continue
        fl = _is_float(dt)
        sq = "true" if op == "sum_sq" else "false"
        if op in ("sum", "sum_sq"):
            init1 += ["0ull", "0ull"]
            kind1 += ["K_SUM_F" if fl else "K_SUM_I", "K_OR"]
            fn = "sum_f_step" if fl else "sum_i_step"
            val = f"r.af[{a}]" if fl else f"r.ai[{a}]"
            steps1.append(f"    {fn}(mine, r.avalid[{a}], {val}, {sq}, g, "
                          f"lane, {acc});")
            continue
        adt = acc_dtype(op, dt.torch_dtype)
        neutral = minmax_neutral(op, adt)
        if fl:
            init1 += ["DBITS_POS_INF" if op == "min" else "DBITS_NEG_INF",
                      "0ull"]
            kind1 += ["K_MIN_F" if op == "min" else "K_MAX_F", "K_OR"]
            steps1.append(f"    {op}_f_step(mine, r.avalid[{a}], r.af[{a}], "
                          f"g, lane, {acc});")
        else:
            lit_ = _c_literal(neutral, LONG)
            init1 += [f"(unsigned long long){lit_}", "0ull"]
            kind1 += ["K_MIN_I" if op == "min" else "K_MAX_I", "K_OR"]
            steps1.append(f"    {op}_i_step(mine, r.avalid[{a}], r.ai[{a}], "
                          f"{lit_}, g, lane, {acc});")

    out += [
        f"__device__ const int KIND0[S0] = {{{', '.join(kind0)}}};",
        f"__device__ const int KIND1[S1] = {{{', '.join(kind1)}}};",
        "",
        "__device__ __forceinline__ void init0(unsigned long long* acc) {",
        *[f"    acc[{s}] = {v};" for s, v in enumerate(init0)],
        "}",
        "",
        "__device__ __forceinline__ void init1(unsigned long long* acc) {",
        *[f"    acc[{s}] = {v};" for s, v in enumerate(init1)],
        "}",
        "",
        "__device__ __forceinline__ void scan_row(const Cols& cols, "
        "long long row, Row& r) {",
        *em.lines,
        "}",
        "",
        "__device__ __forceinline__ int bucket_of(const Row& r, int G) {",
        "    unsigned h = 0x9E3779B9u;",
        *hash_lines,
        "    return (int)(h % (unsigned)G);",
        "}",
        "",
        "__device__ __forceinline__ void phase0_step(const Row& r, bool mine, "
        "int g, int lane, unsigned long long* acc) {",
        *steps0,
        "}",
        "",
        "__device__ __forceinline__ void phase1_step(const Row& r, bool mine, "
        "unsigned peers, int g, int lane, unsigned long long* acc) {",
        *steps1,
        "}",
    ]
    return "\n".join(out) + "\n"


class _LazySources:
    """Source-column environment: a column's loads are emitted at its
    first reference, so the row function reads only what it uses."""

    def __init__(self, em: _Emitter):
        self.em = em

    def __getitem__(self, ordinal: int):
        return self.em.source(ordinal)
