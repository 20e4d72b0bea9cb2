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
  the hashing, bucketing and accumulation: one pass over the rows that
  accumulates each bucket's key statistics and aggregates together, and a
  fold of the block records (two launches); one library is built per spec
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

#: threads per block of the row kernel (the C side may use fewer when the
#: per-warp partials would not fit in shared memory)
BLOCK_THREADS = 256

#: consecutive rows a lane takes per step, with vector loads
RUN = 4


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
    _blocks_per_sm: dict = field(default_factory=dict, repr=False)


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
        lib.fsa_run.restype = ctypes.c_int
        lib.fsa_run.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + \
            [ctypes.c_void_p] * 3
        lib.fsa_blocks_per_sm.restype = ctypes.c_int
        lib.fsa_blocks_per_sm.argtypes = [ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
        spec._lib = lib
    return spec._lib


def _slots(spec: ScanAggSpec) -> Tuple[int, int]:
    """Words of a bucket: 4 per key (min and max order bits, any valid,
    any null), then 2 per aggregate (its accumulator, has-valid)."""
    return 4 * spec.key_count, 2 * len(spec.agg_ops)


def cache_entries(registers: int) -> int:
    """Buckets a lane caches, at `registers` 32-bit registers an entry:
    4 (q1's returnflag has 4 values) while that stays within 48 registers,
    fewer for wider entries (their registers would spill)."""
    return max(1, min(4, 48 // registers))


def grid_blocks(capacity: int, sms: int, per_sm: int) -> int:
    """Blocks of fsa_rows: one wave of the card (`per_sm` resident blocks
    on each of `sms` SMs), fewer when the rows do not fill it (a block
    takes BLOCK_THREADS * RUN rows a step)."""
    return max(1, min(math.ceil(capacity / (BLOCK_THREADS * RUN)),
                      sms * per_sm))


def _blocks_per_sm(spec: ScanAggSpec, G: int) -> int:
    """fsa_rows' resident blocks per SM at G buckets, asked of the card
    once per spec and G."""
    per_sm = spec._blocks_per_sm.get(G)
    if per_sm is None:
        out = ctypes.c_int(0)
        err = _library(spec).fsa_blocks_per_sm(G, ctypes.byref(out))
        if err != 0 or out.value < 1:
            raise RuntimeError(f"fused_scan_agg: no resident block at G={G}:"
                               f" CUDA error {err}")
        per_sm = spec._blocks_per_sm[G] = int(out.value)
    return per_sm


def _prepare(spec: ScanAggSpec, batch, G: int):
    """Check the batch against the spec and allocate the scratch and the
    output words. Returns (library, fsa_run's arguments, (scratch,
    words))."""
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
    S = sum(_slots(spec))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nb = grid_blocks(batch.capacity, sms, _blocks_per_sm(spec, G))
    part = torch.empty(nb * G * S, dtype=torch.int64, device=dev)
    words = torch.empty((G, S), dtype=torch.int64, device=dev)
    data_ptrs = (ctypes.c_void_p * len(cols))(
        *[c.data.data_ptr() for c in cols])
    valid_ptrs = (ctypes.c_void_p * len(cols))(
        *[c.validity.data_ptr() for c in cols])
    stream = torch.cuda.current_stream(dev).cuda_stream
    # (a cast keeps its pointer array alive)
    args = (ctypes.cast(data_ptrs, ctypes.c_void_p),
            ctypes.cast(valid_ptrs, ctypes.c_void_p), nrows.data_ptr(),
            batch.capacity, G, nb, part.data_ptr(), words.data_ptr(), stream)
    return lib, args, (part, words)


def _launch(lib: ctypes.CDLL, args) -> None:
    err = lib.fsa_run(*args)
    if err != 0:
        raise RuntimeError(f"fused_scan_agg kernel launch failed: CUDA "
                           f"error {err}")


def _partials_cuda(spec: ScanAggSpec, batch, G: int):
    lib, args, (_, words) = _prepare(spec, batch, G)
    _launch(lib, args)
    fused_scan_agg.launches += 1
    return _unpack_partials(spec, words)


def launcher(spec: ScanAggSpec, batch, G: int):
    """A callable that launches the kernel alone on `batch`, into scratch
    and output words allocated once here: for timing the launches apart
    from the wrapper's allocations. It counts no launch."""
    lib, args, buffers = _prepare(spec, batch, G)

    def launch():
        _launch(lib, args)
        return buffers   # the closure keeps the scratch alive

    return launch


def _unpack_partials(spec: ScanAggSpec, words):
    """Kernel words [G][S0 + S1] -> the plain version's statistics
    layout."""
    S0, _ = _slots(spec)
    kstats = []
    for k, dt in enumerate(spec.key_dtypes):
        mn, mx = words[:, 4 * k], words[:, 4 * k + 1]
        if lane_bits(dt.torch_dtype) == 64:  # u64 words -> signed lanes
            mn, mx = mn ^ INT64_MIN, mx ^ INT64_MIN
        kstats.append((mn, mx, words[:, 4 * k + 2] != 0,
                       words[:, 4 * k + 3] != 0))
    astats = []
    for a, ((op, _), dt) in enumerate(zip(spec.agg_ops, spec.agg_dtypes)):
        word = words[:, S0 + 2 * a].contiguous()
        if op in ("count", "count_star"):
            astats.append((word.to(torch.int32), None))
            continue
        adt = acc_dtype(op, dt.torch_dtype)
        vals = word.view(torch.float64).to(adt) if adt.is_floating_point \
            else word.to(adt)
        astats.append((vals, words[:, S0 + 2 * a + 1] != 0))
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
        self.loads: List[str] = []    # a run's loads, before the row loop
        self.lines: List[str] = []    # one row's evaluation, in the loop
        self.n = 0
        self.source_dtypes = source_dtypes
        self.loaded = {}

    def tmp(self) -> str:
        self.n += 1
        return f"t{self.n}"

    def line(self, s: str) -> None:
        self.lines.append("        " + s)

    def source(self, ordinal: int):
        """A source column's value and validity in row k of the run: its
        RUN values loaded into an array (RUN bytes of BOOLEAN data, and
        of validity, packed into one 32-bit word) at first reference."""
        if ordinal not in self.loaded:
            dt = self.source_dtypes[ordinal]
            x, v = f"c{ordinal}", f"c{ordinal}v"
            if dt.torch_dtype == torch.bool:
                self.loads.append(f"    const unsigned {x}_ = load_bytes("
                                  f"cols.data[{ordinal}], base, m);")
                self.line(f"const bool {x} = (({x}_ >> (8 * k)) & 0xFFu) "
                          f"!= 0u;")
            else:
                ct = _ctype(dt)
                self.loads += [
                    f"    {ct} {x}_[RUN];",
                    f"    load_run({x}_, cols.data[{ordinal}], base, m);"]
                self.line(f"const {ct} {x} = {x}_[k];")
            self.loads.append(f"    const unsigned {v}_ = load_bytes("
                              f"cols.valid[{ordinal}], base, m);")
            self.line(f"const bool {v} = (({v}_ >> (8 * k)) & 0xFFu) != 0u;")
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
    """The spec's part of the kernel source: sizes, the kind and initial
    value of each word of a bucket (`kind_of`, `init_word`), and the
    functions `scan_run` (a lane's run of RUN rows: the loads of the
    columns the chain reads, then the absorbed chain of each row, folded
    into the lane's accumulators), `bucket_of` and `row_step` (one row into
    a bucket's words)."""
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
    em.line(f"r.keep = {' && '.join(keep + ['k < m'])};")
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
    lay = _EntryLayout()
    init, kind, steps, hash_lines = [], [], [], []

    def word(k: str, v: str):
        """Add word s of kind k, initial value v: its storage in an Entry
        (a C lvalue), or for a flag its index s."""
        kind.append(k)
        init.append(v)
        return lay.place(len(kind) - 1, k)

    for k, dt in enumerate(spec.key_dtypes):
        wide = lane_bits(dt.torch_dtype) == 64
        if wide:
            mn = word("K_MIN_U", "0xFFFFFFFFFFFFFFFFull")
            mx = word("K_MAX_U", "0ull")
            x = f"r.kbits[{k}]"
            hash_lines += [
                f"    h = mix32(h ^ (unsigned)r.kbits[{k}], SALT);",
                f"    h = mix32(h ^ (unsigned)(r.kbits[{k}] >> 32), "
                f"SALT + 0x51u);"]
        else:
            mn = word("K_MIN_U32", "0xFFFFFFFFull")
            mx = word("K_MAX_U32", "0ull")
            x = f"(unsigned)r.kbits[{k}]"
            hash_lines.append(
                f"    h = mix32(h ^ (unsigned)r.kbits[{k}], SALT);")
        hash_lines.append(f"    h = mix32(h ^ (unsigned)r.kvalid[{k}], "
                          f"SALT + 0xA3u);")
        av, an = word("K_OR", "0ull"), word("K_OR", "0ull")
        steps += [f"    if (r.kvalid[{k}]) {{",
                  f"        {mn} = {x} < {mn} ? {x} : {mn};",
                  f"        {mx} = {x} > {mx} ? {x} : {mx};",
                  "    }",
                  f"    {lay.set_bit(av, f'r.kvalid[{k}]')}",
                  f"    {lay.set_bit(an, f'!r.kvalid[{k}]')}"]
    for a, ((op, _), dt) in enumerate(zip(spec.agg_ops, spec.agg_dtypes)):
        v = f"r.avalid[{a}]"
        if op in ("count_star", "count"):
            acc = word("K_CNT", "0ull")
            word("K_OR", "0ull")   # has-valid unused: counts are never null
            steps.append(f"    {acc} += 1u;" if op == "count_star"
                         else f"    {acc} += (unsigned){v};")
            continue
        fl = _is_float(dt)
        x = f"r.af[{a}]" if fl else f"r.ai[{a}]"
        if op in ("sum", "sum_sq"):
            acc = word("K_SUM_F" if fl else "K_SUM_I", "0ull")
            if fl:
                val = f"{x} * {x}" if op == "sum_sq" else x
                upd = f"{acc} = f64_word(as_f64({acc}) + {val});"
            else:
                u = f"(unsigned long long){x}"
                upd = f"{acc} += {u} * {u};" if op == "sum_sq" \
                    else f"{acc} += {u};"
        elif fl:
            acc = word("K_MIN_F" if op == "min" else "K_MAX_F",
                       "DBITS_POS_INF" if op == "min" else "DBITS_NEG_INF")
            upd = f"{acc} = f64_word({op}_nan(as_f64({acc}), {x}));"
        else:
            neutral = minmax_neutral(op, acc_dtype(op, dt.torch_dtype))
            acc = word("K_MIN_I" if op == "min" else "K_MAX_I",
                       f"(unsigned long long){_c_literal(neutral, LONG)}")
            cmp = "<" if op == "min" else ">"
            upd = (f"{acc} = {x} {cmp} (long long){acc} ? "
                   f"(unsigned long long){x} : {acc};")
        has = word("K_OR", "0ull")
        steps += [f"    if ({v}) {upd}", f"    {lay.set_bit(has, v)}"]

    out = [
        f"#define N_COLS {len(spec.source_dtypes)}",
        f"#define N_KEYS {K}",
        f"#define N_AGGS {A}",
        f"#define S0 {S0}",
        f"#define S1 {S1}",
        f"#define S {S0 + S1}",
        f"#define RUN {RUN}",
        f"#define CACHE {cache_entries(lay.registers())}",
        "",
        _FUNCTIONS_MARK.rstrip("\n"),
        "__device__ __forceinline__ int kind_of(int s) {",
        "    switch (s) {",
        *[f"    case {i}: return {k};" for i, k in enumerate(kind)],
        "    }",
        "    return 0;",
        "}",
        "",
        "__device__ __forceinline__ unsigned long long init_word(int s) {",
        "    switch (s) {",
        *[f"    case {i}: return {v};" for i, v in enumerate(init)],
        "    }",
        "    return 0ull;",
        "}",
        "",
        "// a bucket's words in a lane's cache: flag bits, 32-bit words,",
        "// 64-bit words",
        "struct Entry {",
        f"    unsigned f[{max(1, lay.n_flags)}];",
        f"    unsigned u[{max(1, len(lay.u))}];",
        f"    unsigned long long w[{max(1, len(lay.w))}];",
        "};",
        "",
        "__device__ __forceinline__ void init_entry(Entry& e) {",
        *[f"    e.f[{i}] = 0u;" for i in range(max(1, lay.n_flags))],
        *[f"    e.u[{i}] = (unsigned){init[s]};" for i, s in enumerate(lay.u)],
        *[f"    e.w[{i}] = {init[s]};" for i, s in enumerate(lay.w)],
        "}",
        "",
        "__device__ __forceinline__ unsigned long long entry_word("
        "const Entry& e, int s) {",
        "    switch (s) {",
        *[f"    case {i}: return {lay.read(i)};" for i in range(len(kind))],
        "    }",
        "    return 0ull;",
        "}",
        "",
        "__device__ __forceinline__ int bucket_of(const Row& r, int G) {",
        "    unsigned h = 0x9E3779B9u;",
        *hash_lines,
        "    return (int)(h % (unsigned)G);",
        "}",
        "",
        "__device__ __forceinline__ void row_step(const Row& r, Entry& e) {",
        *steps,
        "}",
        "",
        "template <typename LaneT>",
        "__device__ __forceinline__ void scan_run(const Cols& cols, "
        "long long base, int m, LaneT& lane) {",
        *em.loads,
        "#pragma unroll",
        "    for (int k = 0; k < RUN; ++k) {",
        "        Row r = {};",
        *em.lines,
        "        lane.fold(r);",
        "    }",
        "}",
    ]
    return "\n".join(out) + "\n"


class _EntryLayout:
    """Where each word of a bucket lives in a cache entry: OR words are
    bits of `f`, the 32-bit kinds (32-bit key order bits, counts) are `u`
    words, the rest 64-bit `w` words."""

    def __init__(self):
        self.where = {}          # flag word -> (f index, bit)
        self.reads = {}          # word -> C expression of its value
        self.u: List[int] = []
        self.w: List[int] = []
        self.n_bits = 0

    @property
    def n_flags(self) -> int:
        return -(-self.n_bits // 32)

    def place(self, s: int, kind: str):
        if kind == "K_OR":
            f, b = divmod(self.n_bits, 32)
            self.n_bits += 1
            self.where[s] = (f, b)
            self.reads[s] = f"(e.f[{f}] >> {b}) & 1u"
            return s
        if kind in ("K_MIN_U32", "K_MAX_U32", "K_CNT"):
            self.u.append(s)
            ref = f"e.u[{len(self.u) - 1}]"
        else:
            self.w.append(s)
            ref = f"e.w[{len(self.w) - 1}]"
        self.reads[s] = ref
        return ref

    def set_bit(self, s: int, cond: str) -> str:
        f, b = self.where[s]
        return f"e.f[{f}] |= (unsigned)({cond}) << {b};"

    def read(self, s: int) -> str:
        return self.reads[s]

    def registers(self) -> int:
        return self.n_flags + len(self.u) + 2 * len(self.w)


class _LazySources:
    """Source-column environment: a column's loads are emitted at its
    first reference, so the row function reads only what it uses."""

    def __init__(self, em: _Emitter):
        self.em = em

    def __getitem__(self, ordinal: int):
        return self.em.source(ordinal)
