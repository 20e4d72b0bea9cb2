#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME, /usr/local/cuda or PATH); runs
from the repository root and imports nothing of JAX. Phases, each of which
fails the run on error:

  1. builds every kernel of the q1, q3 and q19 paths (the fused
     scan-aggregate specs, csrc/murmur3.cu, csrc/probe_verify.cu,
     csrc/row_gather.cu, csrc/dict_gather.cu; one nvcc per source, all
     started together) and prints the build time and ptxas's register and
     spill counts;
  2. holds each kernel against its plain PyTorch version on the card:
     fused_scan_agg on three specs at sizes ragged against the block size,
     with nulls, a high-cardinality case whose leftover flag must trip and
     a case whose lanes see more buckets than their register cache holds;
     murmur3 of i64 and i32 lanes on ragged sizes with negative values and
     seeds chained over columns with nulls (exact); probe-verify on random
     lanes with duplicate build keys, buckets shared by several keys, empty
     ranges and a candidate bucket smaller than the total (exact on the
     slots below the total); the packed row gather with -1 and out-of-range
     indices, f64 lanes and NaN payloads (exact bits); the dictionary
     gather at the TPU kernel's own (4096, 128) x (16384, 128) shape and on
     1- and 4-byte tables of 1, 3, 5 and 128 lanes through both of its
     kernels (one-lane tables staged and not), with codes of -1, n
     and above on ragged row counts, aligned and as x[1:] views (exact);
     and every kernel on its main path's own inputs;
  3. drives bench.py's q1 plan (scan -> filter -> project -> aggregate) at
     16,777,216 rows, bench.py's q3 plan (two filtered scans -> inner hash
     join -> project -> exact aggregate -> TopN(10)) at 2,097,152 lineitems
     x 524,288 orders, a second time with the join's speculative size
     cache warm, q3 with INT order keys, and TPC-H Q19 at scale factor 1
     (6,001,215 lineitems x 200,000 parts, four dictionary-encoded string
     columns, code-space predicates, a join with a residual condition, a
     grand aggregate), all through the port's execs, with every launch
     counter set to 0 just before each path and read just after; checks q1
     against bench.numpy_oracle, q3 against bench.q3_oracle (integers and
     keys exact, f64 rtol 1e-9), q19 against q19_oracle (the qualifying
     row count exact, revenue rtol 1e-9) and the speculation flags (must
     stay False), and that q1 launched fused_scan_agg once and q19
     dict_gather 42 times;
  4. times the q1, q3 and q19 steady states (one synchronisation per run
     of iterations) and each kernel against its plain version, its bound
     and, for the row gather and the dictionary gather, the one PyTorch
     call that computes the same function; fused_scan_agg's and
     dict_gather's launches are timed apart from their wrappers' calls,
     and dict_gather at both of its shapes (q19's take and dg's). Kernel
     times are the device's, with the L2 cache flushed before each run
     (device_ms).

With --profile TRACE it also runs each steady state under torch.profiler,
prints the device's busy share and time by kernel, and writes the Chrome
traces to TRACE (q1) and TRACE with "_q3" or "_q19" before its suffix.

The last lines are a JSON line with one record per ported kernel (the
dictionary gather's holds its times at dg's shape under "dg_shape"), the
card as nvidia-smi names it, and {"ok": true, "device": {...}}.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROWS = 1 << 24          # bench.py ROWS: the q1 lane's size
ITERS = 30              # steady-state runs of the whole q1 plan
Q3_ORDERS = 1 << 19     # bench.py N_ORDERS
Q3_LINES = 1 << 21      # bench.py N_LINES
Q3_ITERS = 10           # steady-state runs of the whole q3 plan
KERNEL_REPS = 20        # timed launches per kernel measurement
RTOL = 1e-9

#: H100 SXM (NVIDIA's data sheet): HBM rate and the non-tensor-core
#: float32 rate, which also bounds the kernel's integer and f64 work here
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

DEVICE = "cuda"

#: device-side names of the ported kernels' __global__ functions
PORTED_KERNEL_PREFIXES = ("fsa_", "m3_long", "m3_int", "probe_verify",
                          "row_gather", "void dict_gather")

BUCKETS = 32            # G of the q1 lane (min(32, slots))
OUT_CAP = 128           # bucket_capacity(slots * rounds)


def q1_data():
    """bench.build_data: the same seed, the same arrays."""
    rng = np.random.default_rng(0)
    return {
        "returnflag": rng.integers(0, 4, ROWS, dtype=np.int32),
        "quantity": rng.integers(1, 51, ROWS, dtype=np.int64),
        "extendedprice": rng.random(ROWS) * 1000.0,
        "discount": rng.random(ROWS) * 0.1,
    }


def q1_oracle(d):
    """bench.numpy_oracle."""
    keep = d["quantity"] <= 45
    flag = d["returnflag"][keep]
    qty = d["quantity"][keep]
    dp = (d["extendedprice"] * (1.0 - d["discount"]))[keep]
    out = {}
    for k in np.unique(flag):
        m = flag == k
        out[int(k)] = (int(qty[m].sum()), float(dp[m].sum()), int(m.sum()))
    return out


def q1_schema(t):
    return t.Schema((t.StructField("returnflag", t.INT),
                     t.StructField("quantity", t.LONG),
                     t.StructField("extendedprice", t.DOUBLE),
                     t.StructField("discount", t.DOUBLE)))


def q1_plan(batch, schema):
    """bench.py make_plan, in the port."""
    from spark_rapids_tpu_torch.exec.aggregate import AggregateExec
    from spark_rapids_tpu_torch.exec.basic import (
        FilterExec, InMemoryScanExec, ProjectExec)
    from spark_rapids_tpu_torch.expr.aggexprs import Count, Sum
    from spark_rapids_tpu_torch.expr.core import col, lit
    scan = InMemoryScanExec([batch], schema)
    filt = FilterExec(col("quantity") <= lit(45), scan)
    proj = ProjectExec([
        col("returnflag"), col("quantity"),
        (col("extendedprice") * (lit(1.0) - col("discount")))
        .alias("disc_price")], filt)
    return AggregateExec(
        [col("returnflag")],
        [(Sum(col("quantity")), "sum_qty"),
         (Sum(col("disc_price")), "sum_disc"),
         (Count(), "cnt")], proj)


def minmax_spec():
    """A second spec covering min/max/sum_sq/count and a Divide: LONG key,
    INT and DOUBLE inputs, an Or/IsNull filter."""
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.expr.arithmetic import Abs, Divide
    from spark_rapids_tpu_torch.expr.core import col, lit, resolve
    from spark_rapids_tpu_torch.expr.predicates import GreaterThan, IsNull, Or
    from spark_rapids_tpu_torch.ops.fused_scan_agg import compile_scan_agg_spec
    src = t.Schema((t.StructField("k", t.LONG), t.StructField("w", t.INT),
                    t.StructField("v", t.DOUBLE)))
    filt = resolve(Or(GreaterThan(col("w"), lit(-40)), IsNull(col("v"))), src)
    pre = [col("k"), Abs(col("v")).alias("_a1"), col("w").alias("_a2"),
           Divide(col("v"), col("w")).alias("_a3")]
    pre_bound = [resolve(e, src) for e in pre]
    pre_schema = t.Schema(tuple(
        t.StructField(n, e.data_type)
        for n, e in zip(("k", "_a1", "_a2", "_a3"), pre_bound)))
    ops = [("min", 1), ("max", 1), ("min", 2), ("max", 2), ("sum_sq", 1),
           ("sum_sq", 2), ("count", 3), ("sum", 3), ("count_star", None)]
    return compile_scan_agg_spec([("filter", filt)], pre_bound, pre_schema,
                                 1, ops, src), src


def zoo_spec():
    """A spec that reaches the emitter's other branches: every whitelisted
    expression not in the q1 and min/max specs, FLOAT and INT keys (NaN and
    -0.0 among the float keys), FLOAT min/max and sum, INT sum."""
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.expr.arithmetic import Add, UnaryMinus
    from spark_rapids_tpu_torch.expr.core import col, lit, resolve
    from spark_rapids_tpu_torch.expr.predicates import (
        And, EqualNullSafe, EqualTo, GreaterThanOrEqual, IsNotNull, LessThan,
        Not, Or)
    from spark_rapids_tpu_torch.ops.fused_scan_agg import compile_scan_agg_spec
    src = t.Schema((t.StructField("k1", t.FLOAT), t.StructField("k2", t.INT),
                    t.StructField("x", t.DOUBLE), t.StructField("y", t.FLOAT),
                    t.StructField("z", t.LONG), t.StructField("w", t.INT)))
    filt = resolve(And(Not(EqualTo(col("w"), lit(7))),
                       Or(GreaterThanOrEqual(col("x"), lit(-50.0)),
                          IsNotNull(col("y")))), src)
    proj = [col("k1"), col("k2"), Add(col("z"), col("w")).alias("s"),
            UnaryMinus(col("y")).alias("ny"), col("x"),
            EqualNullSafe(col("w"), lit(3)).alias("e"),
            LessThan(col("y"), col("k1")).alias("lt")]
    proj_bound = [resolve(e, src) for e in proj]
    proj_schema = t.Schema(tuple(
        t.StructField(n, e.data_type)
        for n, e in zip(("k1", "k2", "s", "ny", "x", "e", "lt"), proj_bound)))
    filt2 = resolve(Or(col("e"), Not(col("lt"))), proj_schema)
    pre = [col("k1"), col("k2"), col("s").alias("_a2"),
           col("ny").alias("_a3"), col("x").alias("_a4"),
           col("k2").alias("_a5")]
    pre_bound = [resolve(e, proj_schema) for e in pre]
    pre_schema = t.Schema(tuple(
        t.StructField(n, e.data_type)
        for n, e in zip(("k1", "k2", "_a2", "_a3", "_a4", "_a5"), pre_bound)))
    ops = [("sum", 2), ("min", 3), ("max", 3), ("sum", 3), ("sum_sq", 4),
           ("count", 4), ("sum", 5), ("min", 2), ("count_star", None)]
    steps = [("filter", filt), ("project", proj_bound, proj_schema),
             ("filter", filt2)]
    return compile_scan_agg_spec(steps, pre_bound, pre_schema, 2, ops,
                                 src), src


def random_batch(schema, n, key_dom, device, seed):
    """Columns with ~15% nulls (data left under the null slots)."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column, bucket_capacity
    rng = np.random.default_rng(seed)
    cap = bucket_capacity(n)
    cols = []
    for f in schema.fields:
        if f.name in ("returnflag", "k", "k2"):
            vals = rng.integers(0, key_dom, n)
        elif f.name == "k1":
            vals = rng.choice([-0.0, 0.0, 1.5, np.nan, -2.25], n)
        elif f.name == "quantity":
            vals = rng.integers(1, 51, n)
        elif f.name in ("w", "z"):
            vals = rng.integers(-60, 60, n)
        elif f.name == "discount":
            vals = rng.random(n) * 0.1
        elif f.name == "y":
            vals = np.where(rng.random(n) < 0.05, np.nan,
                            rng.random(n) * 100.0 - 50.0)
        else:
            vals = rng.random(n) * 1000.0 - 100.0
        cols.append(Column.from_numpy(
            vals.astype(f.data_type.np_dtype), f.data_type, capacity=cap,
            device=device, validity=rng.random(n) > 0.15))
    return ColumnarBatch(cols, n, schema)


def _bits(x):
    """Float keys compare by bit pattern (both sides decode one canonical
    NaN from the order lanes), so a NaN group key is equal to itself."""
    import torch
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return x.view(ints[x.element_size()]) if x.is_floating_point() else x


def compare_outputs(got, want, label):
    """Kernel output against the plain version's: everything exact except
    f64 sums (rtol 1e-9). Returns (groups, leftover, max abs f64 error)."""
    import torch
    gk, gr, gn, gl = got
    wk, wr, wn, wl = want
    ng, left = int(wn), bool(wl)
    if int(gn) != ng or bool(gl) != left:
        raise AssertionError(f"{label}: groups/leftover {int(gn)}/{bool(gl)}"
                             f" != plain {ng}/{left}")
    for a, b in zip(gk, wk):
        if not (torch.equal(a.validity, b.validity)
                and torch.equal(_bits(a.data), _bits(b.data))):
            raise AssertionError(f"{label}: keys differ")
    err = 0.0
    for (_, (ad, av)), (_, (bd, bv)) in zip(gr, wr):
        if not torch.equal(av, bv):
            raise AssertionError(f"{label}: result validity differs")
        ad, bd = ad[av], bd[bv]
        if ad.dtype != bd.dtype:
            raise AssertionError(f"{label}: dtype {ad.dtype} != {bd.dtype}")
        if ad.is_floating_point():
            diff = (ad - bd).abs()
            both_nan = torch.isnan(ad) & torch.isnan(bd)
            lim = RTOL * bd.abs()
            if bool(((diff > lim) & ~both_nan).any()):
                raise AssertionError(f"{label}: f64 beyond rtol {RTOL}")
            if int((~both_nan).sum()):
                err = max(err, float(diff[~both_nan].max()))
        elif not torch.equal(ad, bd):
            raise AssertionError(f"{label}: integer results differ")
    return ng, left, err


#: bytes written before each timed launch: ten times the H100's 50 MB L2
FLUSH_BYTES = 512 << 20


def device_ms(fn, reps):
    """Mean device time of `fn`'s launches with the L2 cache cold, as the
    main path finds it: before each run a FLUSH_BYTES write evicts L2 and
    keeps the card busy while the host enqueues `fn` between two events,
    so the events bracket its device work and no host gap."""
    import torch
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    pairs = []
    for _ in range(reps):
        flush.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def cuda_ms(fn, reps):
    """Mean time of `reps` back-to-back runs of `fn` between two events:
    the device's time when it outruns the host, else the host's."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ops_per_row(spec):
    """Operations the fused pass performs per row, counted from the spec:
    each expression node, the bucket hash (6 per mix, 2 mixes per 32-bit
    key lane, 3 per 64-bit one, plus the modulo), and one fold per
    aggregate and per key statistic."""
    def nodes(e):
        return 1 + sum(nodes(c) for c in getattr(e, "children", ()))
    n = 0
    for step in spec.steps:
        for e in ([step[1]] if step[0] == "filter" else step[1]):
            n += nodes(e)
    n += sum(nodes(e) for e in spec.pre_bound)
    for dt in spec.key_dtypes:
        n += 6 * (3 if dt.torch_dtype.itemsize == 8 else 2) + 4
    return n + 1 + len(spec.agg_ops)


def profile_plan(label, plan, iters, trace_path):
    """Where an iteration's time goes: torch.profiler over `iters` runs of
    `plan` under one speculation scope. Prints the device's busy share of
    the profiled wall time (the union of kernel intervals), device
    activities per iteration, and device time by kernel name; writes the
    Chrome trace to `trace_path`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    with speculation_scope():
        list(plan.execute())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                list(plan.execute())
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    print(f"profile {label} ({iters} iterations under the profiler): "
          f"{wall_us / iters / 1e3:.3f} ms/iteration, device busy "
          f"{busy / iters / 1e3:.3f} ms/iteration = {busy / wall_us:.1%}, "
          f"{len(kernels) / iters:.0f} device activities/iteration")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]:
        print(f"  {t / iters / 1e3:9.4f} ms/it {n / iters:7.1f}x  {name[:90]}")
    ported = [(name, t, n) for name, (t, n) in by_name.items()
              if name.startswith(PORTED_KERNEL_PREFIXES)]
    print(f"  ported kernels: {sum(t for _, t, _ in ported) / iters / 1e3:.4f}"
          f" ms/it in {sum(n for _, _, n in ported) / iters:.0f} launches")
    for name, t, n in sorted(ported, key=lambda r: -r[1]):
        print(f"  {t / iters / 1e3:9.4f} ms/it {n / iters:7.1f}x  {name[:90]}")
    # the same device time by the PyTorch operator that launched it, with
    # its input shapes: which call of the plan each kernel belongs to
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.self_device_time_total > 0]
    print("  by operator and input shapes:")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / iters / 1e3:9.4f} ms/it "
              f"{e.count / iters:7.1f}x  {e.key} {e.input_shapes}"[:150])
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    print(f"trace: {trace_path}")


# -- q3 -------------------------------------------------------------------

def q3_data(key_dtype=np.int64):
    """bench.build_q3_data: the same seed, the same arrays; the order keys
    optionally narrowed to int32 (the INT-key variant)."""
    rng = np.random.default_rng(1)
    d = {
        "o_orderkey": np.arange(Q3_ORDERS, dtype=np.int64),
        "o_flag": rng.integers(0, 10, Q3_ORDERS, dtype=np.int32),
        "l_orderkey": rng.integers(0, Q3_ORDERS, Q3_LINES, dtype=np.int64),
        "l_price": rng.random(Q3_LINES) * 1000.0,
        "l_disc": rng.random(Q3_LINES) * 0.1,
        "l_flag": rng.integers(0, 4, Q3_LINES, dtype=np.int32),
    }
    for k in ("o_orderkey", "l_orderkey"):
        d[k] = d[k].astype(key_dtype)
    return d


def q3_oracle(d):
    """bench.q3_oracle."""
    keep_o = d["o_flag"] < 5
    keep_l = d["l_flag"] != 0
    okeys = d["o_orderkey"][keep_o]
    lkey = d["l_orderkey"][keep_l]
    rev = (d["l_price"] * (1.0 - d["l_disc"]))[keep_l]
    sel = np.isin(lkey, okeys)
    lkey, rev = lkey[sel], rev[sel]
    order = np.argsort(lkey, kind="stable")
    lkey, rev = lkey[order], rev[order]
    uk, starts = np.unique(lkey, return_index=True)
    sums = np.add.reduceat(rev, starts)
    top = np.argsort(-sums, kind="stable")[:10]
    return {int(uk[i]): float(sums[i]) for i in top}


def q3_plan(d, dev, key_type):
    """bench.py make_q3_plan, in the port (the operator tree)."""
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column, bucket_capacity
    from spark_rapids_tpu_torch.exec.aggregate import AggregateExec
    from spark_rapids_tpu_torch.exec.basic import (
        FilterExec, InMemoryScanExec, ProjectExec)
    from spark_rapids_tpu_torch.exec.joins import HashJoinExec
    from spark_rapids_tpu_torch.exec.sort import TopNExec
    from spark_rapids_tpu_torch.expr.aggexprs import Sum
    from spark_rapids_tpu_torch.expr.core import col, lit
    kt = getattr(t, key_type)
    o_schema = t.Schema((t.StructField("o_orderkey", kt),
                         t.StructField("o_flag", t.INT)))
    l_schema = t.Schema((t.StructField("l_orderkey", kt),
                         t.StructField("l_price", t.DOUBLE),
                         t.StructField("l_disc", t.DOUBLE),
                         t.StructField("l_flag", t.INT)))

    def mk(schema, n):
        cap = bucket_capacity(n)
        return ColumnarBatch([Column.from_numpy(d[f.name], f.data_type,
                                                capacity=cap, device=dev)
                              for f in schema.fields], n, schema)

    o_scan = FilterExec(col("o_flag") < lit(5),
                        InMemoryScanExec([mk(o_schema, Q3_ORDERS)], o_schema))
    l_scan = FilterExec(col("l_flag") != lit(0),
                        InMemoryScanExec([mk(l_schema, Q3_LINES)], l_schema))
    joined = HashJoinExec(l_scan, o_scan, [col("l_orderkey")],
                          [col("o_orderkey")], "inner", build_side="right")
    proj = ProjectExec([
        col("l_orderkey"),
        (col("l_price") * (lit(1.0) - col("l_disc"))).alias("rev")], joined)
    agg = AggregateExec([col("l_orderkey")], [(Sum(col("rev")), "revenue")],
                        proj)
    agg._spec_enabled = False  # as bench.py: the exact tier
    return TopNExec(10, [(col("revenue"), False)], agg)


def check_q3(rows, oracle, label):
    if len(rows) != 10 or {int(k) for k, _ in rows} != set(oracle):
        raise AssertionError(f"{label}: top-10 keys {rows} != oracle {oracle}")
    for k, v in rows:
        if abs(v - oracle[int(k)]) > RTOL * abs(oracle[int(k)]):
            raise AssertionError(f"{label}: key {k} revenue {v} != oracle "
                                 f"{oracle[int(k)]}")


# -- q19 --------------------------------------------------------------------

Q19_PARTS = 200_000      # TPC-H SF1 part rows (clause 4.2.5)
Q19_LINES = 6_001_215    # TPC-H SF1 lineitem rows
Q19_ITERS = 10           # steady-state runs of the whole q19 plan
#: clause 2.4.19.4's validation parameters, one disjunct each:
#: (brand, containers, quantity, largest p_size)
Q19_TERMS = (
    ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 5),
    ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10, 10),
    ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 15))
#: the query's text; the data hold 'REG AIR', so 'AIR REG' matches no row
Q19_SHIPMODES = ("AIR", "AIR REG")
Q19_INSTRUCT = "DELIVER IN PERSON"
Q19_QTY_SPAN = 10        # l_quantity between q and q + 10

#: clause 4.2.2.13's value lists
BRANDS = tuple(f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6))
CONTAINERS = tuple(f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
                   for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                             "CAN", "DRUM"))
SHIPINSTRUCTS = ("DELIVER IN PERSON", "COLLECT COD", "NONE",
                 "TAKE BACK RETURN")
SHIPMODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")

Q19_PART_FIELDS = (("p_partkey", "LONG"), ("p_brand", "STRING"),
                   ("p_size", "INT"), ("p_container", "STRING"))
Q19_LINE_FIELDS = (("l_partkey", "LONG"), ("l_quantity", "DOUBLE"),
                   ("l_extendedprice", "DOUBLE"), ("l_discount", "DOUBLE"),
                   ("l_shipinstruct", "STRING"), ("l_shipmode", "STRING"))


def q19_data(n_part=Q19_PARTS, n_line=Q19_LINES, seed=19):
    """part and lineitem columns by TPC-H's generation rules (clause
    4.2.3), from a fixed seed. A string column is (int32 codes, values):
    the values are its dictionary, as a Parquet dictionary page holds it."""
    rng = np.random.default_rng(seed)
    partkey = np.arange(1, n_part + 1, dtype=np.int64)
    retail = (90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)) / 100
    l_partkey = rng.integers(1, n_part + 1, n_line, dtype=np.int64)
    qty = rng.integers(1, 51, n_line).astype(np.float64)

    def codes(values, n):
        return rng.integers(0, len(values), n).astype(np.int32), values

    return {
        "p_partkey": partkey,
        "p_brand": codes(BRANDS, n_part),
        "p_size": rng.integers(1, 51, n_part).astype(np.int32),
        "p_container": codes(CONTAINERS, n_part),
        "l_partkey": l_partkey,
        "l_quantity": qty,
        "l_extendedprice": qty * retail[l_partkey - 1],
        "l_discount": rng.integers(0, 11, n_line) / 100.0,
        "l_shipinstruct": codes(SHIPINSTRUCTS, n_line),
        "l_shipmode": codes(SHIPMODES, n_line),
    }


def q19_oracle(d, terms=Q19_TERMS, span=Q19_QTY_SPAN,
               shipmodes=Q19_SHIPMODES):
    """Q19 in numpy: (revenue or None, qualifying lineitem rows). A
    string literal matches the rows whose value equals it (none when it
    is not among the values)."""
    def isin(name, literals, rows=slice(None)):
        c, values = d[name]
        return np.isin(c[rows], [values.index(x) for x in literals
                                 if x in values])

    p = d["l_partkey"] - 1
    qty = d["l_quantity"]
    size = d["p_size"][p]
    keep = isin("l_shipmode", shipmodes) & isin("l_shipinstruct",
                                                (Q19_INSTRUCT,))
    any_term = np.zeros_like(keep)
    for brand, containers, q, s in terms:
        any_term |= (isin("p_brand", (brand,), p)
                     & isin("p_container", containers, p)
                     & (qty >= q) & (qty <= q + span)
                     & (size >= 1) & (size <= s))
    keep &= any_term
    n = int(keep.sum())
    rev = float((d["l_extendedprice"] * (1.0 - d["l_discount"]))[keep].sum())
    return (rev if n else None), n


def port_modules():
    """The port's types, expressions and execs Q19 is built from."""
    from types import SimpleNamespace
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.exec import aggregate, basic, joins
    from spark_rapids_tpu_torch.expr import aggexprs, core, predicates
    return SimpleNamespace(t=t, core=core, pred=predicates, basic=basic,
                           joins=joins, agg=aggregate, aggexprs=aggexprs)


def q19_schemas(t):
    return [t.Schema(tuple(t.StructField(n, getattr(t, ty)) for n, ty in fs))
            for fs in (Q19_LINE_FIELDS, Q19_PART_FIELDS)]


def q19_batches(d, dev):
    """The port's lineitem and part batches: fixed-width columns and
    DictionaryColumns built from the same numpy arrays."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column, string_buffers
    from spark_rapids_tpu_torch.columnar.encoded import dictionary_from_numpy
    out = []
    for schema in q19_schemas(port_modules().t):
        cols = []
        for f in schema.fields:
            v = d[f.name]
            if isinstance(v, tuple):
                cols.append(dictionary_from_numpy(
                    v[0], *string_buffers(v[1]), device=dev))
            else:
                cols.append(Column.from_numpy(v, f.data_type, device=dev))
        out.append(ColumnarBatch(cols, d[schema.fields[0].name].shape[0],
                                 schema))
    return out


def q19_plan(m, l_batch, p_batch, terms=Q19_TERMS, span=Q19_QTY_SPAN,
             shipmodes=Q19_SHIPMODES):
    """TPC-H Q19 as Spark plans it, in the package whose modules `m`
    holds (`port_modules()`, or the JAX package's in the tests):

      l = Filter(l_shipmode IN (...) AND l_shipinstruct = '...', scan)
      p = Filter(p_size >= 1 AND (term 1 OR term 2 OR term 3), scan)
      j = HashJoin(l, p, l_partkey = p_partkey, inner, build right,
                   condition = the query's three-way OR)
      Aggregate(sum(l_extendedprice * (1 - l_discount)), Project(j))"""
    col, lit, pr = m.core.col, m.core.lit, m.pred
    l_schema, p_schema = l_batch.schema, p_batch.schema

    def all_of(*es):
        out = es[0]
        for e in es[1:]:
            out = pr.And(out, e)
        return out

    def any_of(*es):
        out = es[0]
        for e in es[1:]:
            out = pr.Or(out, e)
        return out

    ship = [pr.In(col("l_shipmode"), list(shipmodes)),
            pr.EqualTo(col("l_shipinstruct"), lit(Q19_INSTRUCT))]
    part_terms, terms_all = [], []
    for brand, containers, q, s in terms:
        part = [pr.EqualTo(col("p_brand"), lit(brand)),
                pr.In(col("p_container"), list(containers))]
        part_terms.append(all_of(*part, pr.LessThanOrEqual(col("p_size"),
                                                           lit(s))))
        terms_all.append(all_of(
            *part,
            pr.GreaterThanOrEqual(col("l_quantity"), lit(float(q))),
            pr.LessThanOrEqual(col("l_quantity"), lit(float(q + span))),
            pr.GreaterThanOrEqual(col("p_size"), lit(1)),
            pr.LessThanOrEqual(col("p_size"), lit(s)), *ship))
    b = m.basic
    lines = b.FilterExec(all_of(*ship), b.InMemoryScanExec([l_batch],
                                                           l_schema))
    parts = b.FilterExec(
        pr.And(pr.GreaterThanOrEqual(col("p_size"), lit(1)),
               any_of(*part_terms)),
        b.InMemoryScanExec([p_batch], p_schema))
    joined = m.joins.HashJoinExec(lines, parts, [col("l_partkey")],
                                  [col("p_partkey")], "inner",
                                  build_side="right",
                                  condition=any_of(*terms_all))
    proj = b.ProjectExec([col("l_extendedprice"), col("l_discount")], joined)
    return m.agg.AggregateExec(
        [], [(m.aggexprs.Sum(col("l_extendedprice")
                             * (lit(1.0) - col("l_discount"))), "revenue")],
        proj)


def check_q19(rows, pairs, oracle, label):
    want, want_pairs = oracle
    got = rows[0][0] if len(rows) == 1 else rows
    if pairs != want_pairs:
        raise AssertionError(f"{label}: {pairs} qualifying rows != oracle "
                             f"{want_pairs}")
    if want is None:
        if got is not None:
            raise AssertionError(f"{label}: revenue {got} != oracle None")
    elif got is None or abs(got - want) > RTOL * abs(want):
        raise AssertionError(f"{label}: revenue {got} != oracle {want}")


# -- launch counters --------------------------------------------------------

def kernel_wrappers():
    """Every ported kernel's wrapper, whose `launches` counts its launches
    (and nothing else)."""
    from spark_rapids_tpu_torch.ops import (
        dict_gather, fused_scan_agg, murmur3_lanes, probe_verify, row_gather)
    return {"fused_scan_agg": fused_scan_agg.fused_scan_agg,
            "murmur3_long_lanes": murmur3_lanes.murmur3_long_lanes,
            "murmur3_int_lanes": murmur3_lanes.murmur3_int_lanes,
            "fused_probe_verify": probe_verify.fused_probe_verify,
            "dma_row_gather": row_gather.dma_row_gather,
            "dict_gather": dict_gather.dict_gather}


def drive_counted(label, plan, need):
    """Run `plan` once under a speculation scope with every launch counter
    set to 0 just before and read just after; fail if the flag tripped or
    a kernel in `need` was not launched. Returns (rows, counts)."""
    import torch
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    with speculation_scope() as scope:
        out = list(plan.execute())
        torch.cuda.synchronize()
        counts = {name: w.launches for name, w in wrappers.items()}
        tripped = scope.tripped()
    if tripped:
        raise AssertionError(f"{label}: speculation flag tripped")
    idle = [k for k in need if counts[k] < 1]
    if idle:
        raise AssertionError(f"{label}: kernels not launched: {idle} "
                             f"(counts {counts})")
    return [r for b in out for r in b.to_pylist()], counts


# -- the q3 kernels against their plain versions ----------------------------

def _exact(label, got, want):
    import torch
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{label}: kernel != plain version")


def _random_ints(rng, n, np_dtype):
    info = np.iinfo(np_dtype)
    v = rng.integers(info.min, info.max, n, dtype=np_dtype, endpoint=True)
    edges = np.array([0, -1, info.min, info.max], dtype=np_dtype)
    v[: min(n, 4)] = edges[: min(n, 4)]
    return v


def _u32_seeds(rng, n):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
        np.uint32).view(np.int32)


def compare_murmur3(dev):
    import torch
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.ops import hashing, murmur3_lanes as m3
    for n in (1, 1000, 65537, (1 << 20) + 3):
        rng = np.random.default_rng(n)
        seeds = torch.from_numpy(_u32_seeds(rng, n)).to(dev)
        v64 = torch.from_numpy(_random_ints(rng, n, np.int64)).to(dev)
        v32 = torch.from_numpy(_random_ints(rng, n, np.int32)).to(dev)
        _exact(f"murmur3_long n={n}", [m3.murmur3_long_lanes(v64, seeds)],
               [hashing.murmur3_long_plain(v64, seeds)])
        _exact(f"murmur3_int n={n}", [m3.murmur3_int_lanes(v32, seeds)],
               [hashing.murmur3_int_plain(v32, seeds)])
    # seeds chained over columns with nulls: LONG, INT, DOUBLE (NaN, -0.0)
    rng = np.random.default_rng(11)
    n = 300_001
    dbl = rng.normal(0, 1e6, n)
    dbl[::7], dbl[::11] = np.nan, -0.0
    specs = [(_random_ints(rng, n, np.int64), t.LONG),
             (_random_ints(rng, n, np.int32), t.INT), (dbl, t.DOUBLE)]
    cols = {d: [Column.from_numpy(v, dt, device=d,
                                  validity=np.random.default_rng(i).random(n)
                                  > 0.2)
                for i, (v, dt) in enumerate(specs)]
            for d in (dev, "cpu")}
    _exact("murmur3_batch chained",
           [hashing.murmur3_batch(cols[dev]).cpu()],
           [hashing.murmur3_batch(cols["cpu"])])
    print("compare murmur3 long/int: 4 sizes and a 3-column chain, exact")


def _probe_case(rng, dev, n_stream, build_cap, n_lanes, dom, max_count,
                cand_cap):
    """Random probe inputs: build lanes from a small domain (duplicate
    keys), ranges of 0..max_count candidates (empty ones included) over
    rows holding other keys too, ~5% invalid keys on both sides."""
    import torch
    counts = rng.integers(0, max_count + 1, n_stream).astype(np.int32)
    counts[rng.random(n_stream) < 0.3] = 0
    lo = rng.integers(0, build_cap - max_count, n_stream).astype(np.int32)
    bk = rng.integers(0, dom, (build_cap, n_lanes)).astype(np.int32)
    sk = rng.integers(0, dom, (n_stream, n_lanes)).astype(np.int32)
    perm = rng.permutation(build_cap).astype(np.int32)
    args = [torch.from_numpy(x).to(dev) for x in (lo, counts, bk)] + [
        torch.from_numpy(rng.random(build_cap) > 0.05).to(dev),
        torch.from_numpy(sk).to(dev),
        torch.from_numpy(rng.random(n_stream) > 0.05).to(dev),
        torch.from_numpy(perm).to(dev)]
    return args, cand_cap, int(counts.astype(np.int64).sum())


def compare_probe(label, args, cand_cap, total):
    """Kernel against the plain version: exact below the candidate total;
    (False, -1, -1, -1) above it."""
    import torch
    from spark_rapids_tpu_torch.ops import probe_verify as pv
    got = pv.fused_probe_verify(*args, cand_cap)
    want = pv.fused_probe_verify_plain(*args, cand_cap)
    live = min(total, cand_cap)
    _exact(label, [x[:live] for x in got], [x[:live] for x in want])
    v, s, p, r = (x[live:] for x in got)
    if bool(v.any()) or not all(bool((x == -1).all()) for x in (s, p, r)):
        raise AssertionError(f"{label}: slots past the total not empty")
    return int(got[0].sum())


def compare_probe_cases(dev):
    rng = np.random.default_rng(21)
    cases = [("probe dup keys L=2", (300_000, 1 << 16, 2, 50, 6, 1 << 20)),
             ("probe L=1 cap<total", (100_003, 1 << 12, 1, 9, 9, 1 << 17)),
             ("probe sparse", (65_537, 1 << 20, 2, 1 << 30, 2, 1 << 16))]
    for label, shape in cases:
        args, cap, total = _probe_case(rng, dev, *shape)
        hits = compare_probe(label, args, cap, total)
        print(f"compare {label}: total={total} cand_cap={cap} "
              f"verified={hits}, exact")


def _gather_inputs(rng, dev, n_rows, n_out):
    import torch
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.ops.rowpack import pack_rows
    dbl = rng.normal(0, 1e3, n_rows)
    dbl[::5] = np.nan
    cols = [Column.from_numpy(v, dt, device=dev,
                              validity=rng.random(n_rows) > 0.1)
            for v, dt in ((_random_ints(rng, n_rows, np.int64), t.LONG),
                          (dbl, t.DOUBLE),
                          (_random_ints(rng, n_rows, np.int32), t.INT),
                          (rng.random(n_rows) > 0.5, t.BOOLEAN),
                          (rng.random(n_rows), t.DOUBLE))]
    plan, imat, fmat = pack_rows(cols)
    cap = imat.shape[0]
    idx = rng.integers(0, cap, n_out).astype(np.int32)
    idx[::9] = -1
    idx[::13] = cap + 5
    idx[::17] = np.iinfo(np.int32).min
    return plan, imat, fmat, torch.from_numpy(idx).to(dev)


def compare_gather(dev):
    import torch
    from spark_rapids_tpu_torch.ops import row_gather as rg
    from spark_rapids_tpu_torch.ops.rowpack import gather_rows
    rng = np.random.default_rng(31)
    for n_rows, n_out in ((1000, 1), (70_001, 65_537), (1 << 20, 3 << 19)):
        plan, imat, fmat, idx = _gather_inputs(rng, dev, n_rows, n_out)
        gi, gf = rg.pallas_gather_rows(plan, imat, fmat, idx)
        wi, wf = gather_rows(plan, imat, fmat, idx)
        _exact(f"row gather n_out={n_out}",
               [gi, gf.view(torch.int64)], [wi, wf.view(torch.int64)])
        safe = torch.where((idx >= 0) & (idx < imat.shape[0]), idx, 0)
        _exact(f"dma_row_gather n_out={n_out}",
               [rg.dma_row_gather(imat, idx)], [imat[safe.long()]])
    print("compare row gather: 3 shapes with -1/out-of-range indices and "
          "NaN f64 payloads, exact bits")


class JoinInputs:
    """The inputs a main path gives each join kernel, taken from the
    port's own join exec: its build table and stream keys, the candidate
    ranges and bucket, and the row gathers the path makes (the build
    permute of the packable payload, and both sides' payload gathers by
    the verified pairs, in slot order). Dictionary columns take the
    per-column path, so only the packable columns are packed."""

    def __init__(self, j):
        import torch
        from spark_rapids_tpu_torch.columnar.column import bucket_capacity
        from spark_rapids_tpu_torch.ops import hashing, join as oj
        from spark_rapids_tpu_torch.ops import probe_verify as pv
        from spark_rapids_tpu_torch.ops.rowpack import is_packable, pack_rows
        j.stamp_inputs()
        build = j._build()
        stream = next(iter(j.children[j._stream_side].execute()))
        lo, counts, skeys, total = j._counts_kernel(build, stream)
        self.total = int(total)
        self.cand_cap = bucket_capacity(max(self.total, 1))
        sk_lanes, svalid = oj.int_key_lanes(skeys)
        bk_lanes, bvalid = build.key_lanes
        self.probe = [lo, counts, bk_lanes, bvalid, sk_lanes, svalid,
                      build.perm]
        self.build_rows, self.stream_rows = build.capacity, counts.shape[0]
        self.n_lanes = bk_lanes.shape[1]
        key = skeys[0].data
        seed = hashing.i32_bits(torch.full_like(key, oj.JOIN_HASH_SEED,
                                                dtype=torch.int64))
        self.hash = (key, seed)
        verified, s_idx, b_pos, _ = pv.fused_probe_verify_plain(
            *self.probe, self.cand_cap)

        def by_pairs(lane):
            sel = lane[verified]
            out = torch.full((self.cand_cap,), -1, dtype=torch.int32,
                             device=key.device)
            out[: sel.shape[0]] = sel
            return out

        plan_b, pmat_b, pfmat_b, ppi, _ = build.pack
        self.gathers = {
            "stream payload": (*pack_rows([c for c in stream.columns
                                           if is_packable(c)]),
                               by_pairs(s_idx)),
            "build permute": (*pack_rows([build.payload[i] for i in ppi]),
                              build.perm),
            "build payload": (plan_b, pmat_b, pfmat_b, by_pairs(b_pos)),
        }


def compare_join_inputs(label, inputs):
    """Each join kernel against its plain version, exactly, on a main
    path's own inputs: the stream keys' hash, the probe and every row
    gather."""
    import torch
    from spark_rapids_tpu_torch.ops import hashing, murmur3_lanes as m3
    from spark_rapids_tpu_torch.ops import row_gather as rg
    from spark_rapids_tpu_torch.ops.rowpack import gather_rows
    key, seed = inputs.hash
    if key.dtype == torch.int64:
        name, fn, plain = ("murmur3_long", m3.murmur3_long_lanes,
                           hashing.murmur3_long_plain)
    else:
        name, fn, plain = ("murmur3_int", m3.murmur3_int_lanes,
                           hashing.murmur3_int_plain)
    _exact(f"{name} {label} stream keys", [fn(key, seed)], [plain(key, seed)])
    hits = compare_probe(f"probe {label}", inputs.probe, inputs.cand_cap,
                         inputs.total)
    shapes = []
    for what, (plan, imat, fmat, idx) in inputs.gathers.items():
        got = rg.pallas_gather_rows(plan, imat, fmat, idx)
        want = gather_rows(plan, imat, fmat, idx)
        if [x is None for x in got] != [x is None for x in want]:
            raise AssertionError(f"row gather {label} {what}: kernel != "
                                 f"plain version")
        _exact(f"row gather {label} {what}",
               *([x.view(torch.int64) if x.is_floating_point() else x
                  for x in out if x is not None] for out in (got, want)))
        shapes.append(f"{what} {idx.shape[0]} of {imat.shape[0]} rows")
    print(f"compare {label} main-path inputs: {name} of {key.shape[0]} "
          f"stream keys, probe of {inputs.stream_rows} stream rows into "
          f"{inputs.build_rows} build rows, candidate total {inputs.total} "
          f"in {inputs.cand_cap} slots, {hits} verified pairs; row gathers "
          f"{'; '.join(shapes)}; exact")


# -- bounds -----------------------------------------------------------------

#: integer operations a row of murmur3 costs (mix_k1: 2 multiplies and a
#: 3-op rotate per word; mix_h1: xor, rotate, multiply, add per word; fmix 7)
M3_OPS = {8: 2 * 5 + 2 * 6 + 7, 4: 5 + 6 + 7}


def bound(nbytes, nops):
    """(bound ms, what bounds it) at the H100's published rates."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = nops / PEAK_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def time_q3_kernels(inputs, int_inputs, counts, int_counts):
    """Each q3 kernel at its main-path shape: kernel, plain version, bound
    and (the gather) torch.index_select on the same matrix."""
    import torch
    from spark_rapids_tpu_torch.ops import hashing, murmur3_lanes as m3
    from spark_rapids_tpu_torch.ops import probe_verify as pv
    from spark_rapids_tpu_torch.ops import row_gather as rg
    from spark_rapids_tpu_torch.ops.rowpack import gather_rows
    reps, plain_reps = KERNEL_REPS, max(3, KERNEL_REPS // 4)
    records = []

    def rec(name, source, replaces, launches, ms, plain_ms, bnd, lib_ms):
        # max_abs_err is 0: phase 2 held every output of these kernels
        # bit for bit against the plain version, and fails otherwise
        b_ms, b_by = bnd
        print(f"{name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of the bound"
              + (f", library {lib_ms:.4f} ms" if lib_ms is not None else ""))
        records.append({"name": name, "route": "cuda",
                        "source": f"spark_rapids_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms})

    for name, inp, width, cnt, fn, plain, line in (
            ("murmur3_long_lanes", inputs, 8, counts, m3.murmur3_long_lanes,
             hashing.murmur3_long_plain, 70),
            ("murmur3_int_lanes", int_inputs, 4, int_counts,
             m3.murmur3_int_lanes, hashing.murmur3_int_plain, 78)):
        key, seed = inp.hash
        n = key.shape[0]
        hargs = (key, seed)
        rec(name, "murmur3.cu", f"spark_rapids_tpu/ops/pallas_kernels.py:"
            f"{line}", cnt[name],
            device_ms(lambda: fn(*hargs), reps),
            device_ms(lambda: plain(*hargs), plain_reps),
            bound(n * (width + 4 + 4), n * M3_OPS[width]), None)

    args, cap = inputs.probe, inputs.cand_cap
    n, b, L = inputs.stream_rows, inputs.build_rows, inputs.n_lanes
    live = min(inputs.total, cap)
    # inputs read once (lo, counts, build and stream lanes and validity,
    # perm) and the four outputs written once; per live slot a binary
    # search of log2(n) steps (3 operations each) and the lane compares
    probe_bytes = 8 * n + b * (4 * L + 1 + 4) + n * (4 * L + 1) + 13 * cap
    probe_ops = live * (3 * int(np.ceil(np.log2(n + 1))) + 8 + 2 * L) \
        + (cap - live) * 4
    rec("fused_probe_verify", "probe_verify.cu",
        "spark_rapids_tpu/ops/pallas_join.py:52",
        counts["fused_probe_verify"],
        device_ms(lambda: pv.fused_probe_verify(*args, cap), reps),
        device_ms(lambda: pv.fused_probe_verify_plain(*args, cap),
                  plain_reps),
        bound(probe_bytes, probe_ops), None)

    plan, imat, fmat, idx = inputs.gathers["stream payload"]
    lanes = imat.shape[1] + 2 * fmat.shape[1]
    mat = torch.cat([imat, fmat.view(torch.int32)], dim=1).contiguous()
    safe = torch.where((idx >= 0) & (idx < mat.shape[0]), idx, 0)
    rec("dma_row_gather", "row_gather.cu",
        "spark_rapids_tpu/ops/pallas_gather.py:101",
        counts["dma_row_gather"],
        device_ms(lambda: rg.pallas_gather_rows(plan, imat, fmat, idx),
                  reps),
        device_ms(lambda: gather_rows(plan, imat, fmat, idx), plain_reps),
        bound(4 * idx.shape[0] * (1 + 2 * lanes), 0),
        device_ms(lambda: torch.index_select(mat, 0, safe), reps))
    return records


# -- the dictionary gather ---------------------------------------------------

#: the TPU kernel's shape (tools/exp_gather.py:158-165): an int32 table of
#: DG_TABLE x 128 and DG_ROWS x 128 indices in [0, DG_TABLE)
DG_TABLE, DG_ROWS = 4096, 16384


def _dg_inputs(dev, seed=41):
    import torch
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 1 << 30, (DG_TABLE, 128), dtype=np.int32)
    idx = rng.integers(0, DG_TABLE, (DG_ROWS, 128), dtype=np.int32)
    return torch.from_numpy(table).to(dev), torch.from_numpy(idx).to(dev)


def compare_dict_gather(dev, q19_lines):
    """The kernel against dict_gather_plain, exactly: dg's own shape; 1-
    and 4-byte tables with 1, 3, 5 and 128 lanes, one lane at n = 7,
    4096, just over the staged size and 1,048,576, with codes of -1, n
    and above on row counts that are not multiples of four, each also
    with the index and table taken as x[1:] views (off the 16-byte
    alignment for one lane); a 128-lane index view off alignment; and
    q19's l_shipmode take."""
    import torch
    from spark_rapids_tpu_torch.columnar.encoded import dict_take, literal_hits
    from spark_rapids_tpu_torch.ops import dict_gather as dg
    table, idx = _dg_inputs(dev)
    want = dg.dict_gather_plain(table, idx)
    _exact("dict_gather dg shape", [dg.dict_gather(table, idx)], [want])
    rng = np.random.default_rng(43)
    plans = {}
    for elt, dtype in ((1, torch.bool), (4, torch.int32)):
        for lanes in (1, 3, 5, 128):
            if lanes == 1:
                ns = (7, 4096, dg.STAGE_BYTES // elt + 1, 1 << 20)
                row_counts = (1, 1000, 65537, (1 << 20) + 3)
            else:
                ns = (7, 4096) + ((1 << 14,) if lanes == 128 else ())
                row_counts = (1, 1001, 16387)
            for n in ns:
                for rows in row_counts:
                    for view in (0, 1):
                        shape = (n + view, lanes)
                        if dtype == torch.bool:
                            t = rng.random(shape) > 0.5
                        else:
                            t = _random_ints(rng, shape[0] * lanes,
                                             np.int32).reshape(shape)
                        c = rng.integers(-2, n + 2, (rows + view) * lanes)
                        c[::7] = -1
                        c[::11] = n
                        c[::13] = np.iinfo(np.int32).max
                        c[::17] = np.iinfo(np.int32).min
                        t = torch.from_numpy(t).to(dev)[view:]
                        c = torch.from_numpy(c.astype(np.int32)).to(
                            dev).reshape(rows + view, lanes)[view:]
                        label = (f"dict_gather n={n} L={lanes} elt={elt} "
                                 f"rows={rows} view={view}")
                        got = dg.dict_gather(t, c)
                        _exact(label, [got], [dg.dict_gather_plain(t, c)])
                        plan = dg.plan_for(t, c, got)
                        key = ("scalar", "flat")[plan.kind] + (
                            " staged" if plan.staged else "") + (
                            " head" if plan.head else "")
                        plans[key] = plans.get(key, 0) + 1
    for elt, dtype in ((1, torch.uint8), (4, torch.int32)):
        t = torch.from_numpy(_random_ints(rng, 4096 * 128, np.int32)
                             .reshape(4096, 128)).to(dev).to(dtype)
        flat = torch.from_numpy(rng.integers(-1, 4097, 1001 * 128 + 1)
                                .astype(np.int32)).to(dev)
        c = flat[1:].view(1001, 128)
        got, plan, launch = dg.launcher(t, c)
        launch()
        _exact(f"dict_gather 128 lanes elt={elt} index off alignment",
               [got], [dg.dict_gather_plain(t, c)])
        if plan.head != 3:
            raise AssertionError(f"index off alignment: plan {plan}")
    mode = q19_lines.column("l_shipmode")
    hit = literal_hits(mode, "AIR")
    _exact("dict_gather q19 l_shipmode take", [dict_take(hit, mode.codes)],
           [dg.dict_gather_plain(hit.reshape(-1, 1),
                                 mode.codes.reshape(-1, 1)).reshape(-1)])
    print(f"compare dict_gather: dg (4096, 128) x (16384, 128); 1- and "
          f"4-byte tables, L in (1, 3, 5, 128), aligned and x[1:] views, "
          f"plans {plans}; 128 lanes off alignment; q19 l_shipmode "
          f"{mode.capacity} codes; exact ({dg.sm_count()} SMs)")


def time_dict_gather(q19_lines, launches):
    """The dictionary gather at q19's 1-byte take over the l_shipmode
    codes and at dg's shape: the kernel's launches alone (its plan and
    output made once) on the device with L2 cold, the same back to back
    (as PR 3 timed its wrapper), the wrapper's whole call, the plain
    version, the byte bound and the one PyTorch call that computes the
    same function (a table index for one lane; torch.gather) on the same
    inputs, the indices clamped and widened to int64 beforehand (PyTorch
    indexes with int64). Returns the kernel's record at the q19 take (the
    main path's shape, with its `launches`) holding under "dg_shape" the
    same times at dg's shape, which no path launches (launches 0)."""
    import torch
    from spark_rapids_tpu_torch.columnar.encoded import literal_hits
    from spark_rapids_tpu_torch.ops import dict_gather as dg
    reps, plain_reps = KERNEL_REPS, max(3, KERNEL_REPS // 4)
    dev = q19_lines.device
    table, idx = _dg_inputs(dev)
    idx64 = idx.long()
    mode = q19_lines.column("l_shipmode")
    hit = literal_hits(mode, "AIR").reshape(-1, 1)
    codes = mode.codes.reshape(-1, 1)
    safe64 = codes.clamp(0, hit.shape[0] - 1).reshape(-1).long()
    flat = hit.reshape(-1)
    out = []
    for label, t, i, lib, n_launches in (
            (f"q19 l_shipmode take, {codes.shape[0]} codes into "
             f"{hit.shape[0]} bool entries", hit, codes,
             lambda: flat[safe64], launches),
            ("dg (4096, 128) x (16384, 128) int32", table, idx,
             lambda: torch.gather(table, 0, idx64), 0)):
        rows, lanes = i.shape
        n, elt = t.shape[0], t.element_size()
        _, plan, launch = dg.launcher(t, i)
        launch()
        ms = device_ms(launch, reps)
        b2b_ms = cuda_ms(launch, reps)
        call_ms = device_ms(lambda: dg.dict_gather(t, i), reps)
        plain_ms = device_ms(lambda: dg.dict_gather_plain(t, i), plain_reps)
        lib_ms = device_ms(lib, reps)
        b = bound(rows * lanes * (4 + elt) + n * lanes * elt, 0)
        print(f"dict_gather {label}: kernel {ms:.4f} ms on the device, L2 "
              f"cold ({('scalar', 'flat')[plan.kind]}"
              f"{' staged' if plan.staged else ''}, {plan.grid} blocks), "
              f"{b2b_ms:.4f} ms back to back; wrapper call {call_ms:.4f} ms;"
              f" plain {plain_ms:.4f} ms; bound {b[0]:.4f} ms ({b[1]}), "
              f"{b[0] / ms:.1%} of the bound; library {lib_ms:.4f} ms")
        out.append({"launches": n_launches, "max_abs_err": 0.0, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b[0],
                    "bound_by": b[1], "library_ms": lib_ms})
    take, dg_shape = out
    return {"name": "dict_gather", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/dict_gather.cu",
            "replaces": "tools/exp_gather.py:168", **take,
            "dg_shape": dg_shape}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--profile", metavar="TRACE", type=Path,
        help="also profile the q1, q3 and q19 steady states (device busy "
             "share, time by kernel) and write their Chrome traces to TRACE "
             "and TRACE with _q3 or _q19 before its suffix")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column, bucket_capacity
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    from spark_rapids_tpu_torch.kernels import build
    from spark_rapids_tpu_torch.ops import fused_scan_agg as fsa

    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # -- data and plans (host set-up) --------------------------------------
    t0 = time.perf_counter()
    d = q1_data()
    oracle = q1_oracle(d)
    schema = q1_schema(t)
    cap = bucket_capacity(ROWS)
    batch = ColumnarBatch([Column.from_numpy(d[f.name], f.data_type,
                                             capacity=cap, device=dev)
                           for f in schema.fields], ROWS, schema)
    plan = q1_plan(batch, schema)
    q1_spec = plan._scan_agg_spec
    if q1_spec is None:
        raise AssertionError("the q1 chain did not compile to a kernel spec")
    mm_spec, mm_schema = minmax_spec()
    zoo, zoo_schema = zoo_spec()
    if mm_spec is None or zoo is None:
        raise AssertionError("a comparison chain did not compile to a spec")
    d3, d3i = q3_data(), q3_data(np.int32)
    q3_want = q3_oracle(d3)
    q3 = q3_plan(d3, dev, "LONG")
    q3i = q3_plan(d3i, dev, "INT")
    d19 = q19_data()
    q19_want = q19_oracle(d19)
    l19, p19 = q19_batches(d19, dev)
    q19 = q19_plan(port_modules(), l19, p19)
    print(f"setup: {time.perf_counter() - t0:.1f} s (data, oracles, plans)")

    # -- phase 1: build every kernel at once -------------------------------
    t0 = time.perf_counter()
    sources = [fsa.kernel_source(s) for s in (q1_spec, mm_spec, zoo)] + [
        build.csrc_source(name)
        for name in ("murmur3.cu", "probe_verify.cu", "row_gather.cu",
                     "dict_gather.cu")]
    build.build_all(sources)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(sources)} "
          f"kernel sources")
    for src in sources:
        for line in build.compiler_log(src).splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    # -- phase 2: kernel against plain version ------------------------------
    cases = []
    for n in (1000, 65537, 1 << 20):
        cases.append((f"q1 n={n}", q1_spec, random_batch(schema, n, 4, dev,
                                                        n), BUCKETS))
        cases.append((f"minmax n={n}", mm_spec,
                      random_batch(mm_schema, n, 12, dev, n + 1), 16))
        cases.append((f"zoo n={n}", zoo,
                      random_batch(zoo_schema, n, 3, dev, n + 2), 32))
    cases.append(("minmax high-cardinality", mm_spec,
                  random_batch(mm_schema, 200_000, 5000, dev, 7), 8))
    # 32 keys over 32 buckets: each lane sees more buckets than its cache
    # holds (4 for q1's spec), so the warp flushes mid-run
    cases.append(("q1 cache overflow G=32 key domain 32", q1_spec,
                  random_batch(schema, 1 << 20, 32, dev, 9), 32))
    for label, spec, b, G in cases:
        ng, left, err = compare_outputs(
            fsa.fused_scan_agg(spec, b, G, OUT_CAP),
            fsa.fused_scan_agg_plain(spec, b, G, OUT_CAP), label)
        if label.endswith("high-cardinality") and not left:
            raise AssertionError("high-cardinality case must leave rows over")
        print(f"compare {label}: groups={ng} leftover={left} "
              f"max_abs_err={err:.3g}")
    _, _, main_err = compare_outputs(
        fsa.fused_scan_agg(q1_spec, batch, BUCKETS, OUT_CAP),
        fsa.fused_scan_agg_plain(q1_spec, batch, BUCKETS, OUT_CAP),
        "q1 main-path inputs")
    print(f"compare q1 main-path inputs: max_abs_err={main_err:.3g}")
    compare_murmur3(dev)
    compare_probe_cases(dev)
    compare_gather(dev)
    q3_in = JoinInputs(q3.child._source)
    q3i_in = JoinInputs(q3i.child._source)
    compare_join_inputs("q3", q3_in)
    compare_join_inputs("q3 INT keys", q3i_in)
    compare_join_inputs("q19", JoinInputs(q19._source))
    compare_dict_gather(dev, l19)
    torch.cuda.synchronize()

    # -- phase 3: the main paths, counted -----------------------------------
    rows, q1_counts = drive_counted("q1", plan, ["fused_scan_agg"])
    if q1_counts["fused_scan_agg"] != 1:
        raise AssertionError(f"q1: {q1_counts} (one fused_scan_agg launch)")
    if sorted(r[0] for r in rows) != sorted(oracle):
        raise AssertionError(f"q1 groups {rows} != oracle {oracle}")
    for k, qty, dp, cnt in rows:
        oq, odp, oc = oracle[k]
        if qty != oq or cnt != oc or abs(dp - odp) > RTOL * abs(odp):
            raise AssertionError(f"q1 group {k}: {(qty, dp, cnt)} != "
                                 f"oracle {oracle[k]}")
    print(f"q1 at {ROWS} rows: {len(rows)} groups equal to the numpy "
          f"oracle; launches {q1_counts}")
    q3_need = ["murmur3_long_lanes", "fused_probe_verify", "dma_row_gather"]
    rows, q3_counts = drive_counted("q3", q3, q3_need)
    check_q3(rows, q3_want, "q3")
    print(f"q3 at {Q3_LINES} x {Q3_ORDERS}: top 10 equal to the numpy "
          f"oracle; launches {q3_counts}")
    rows, warm_counts = drive_counted("q3 warm", q3, q3_need)
    check_q3(rows, q3_want, "q3 warm")
    print(f"q3 again, speculative size cache warm: equal to the oracle; "
          f"launches {warm_counts}")
    rows, q3i_counts = drive_counted(
        "q3 INT keys", q3i,
        ["murmur3_int_lanes", "fused_probe_verify", "dma_row_gather"])
    check_q3(rows, q3_want, "q3 INT keys")
    print(f"q3 with INT order keys: equal to the oracle; launches "
          f"{q3i_counts}")
    join_rows = q19._source.metrics["numOutputRows"]
    before = join_rows.value
    rows, q19_counts = drive_counted(
        "q19", q19, ["dict_gather", "murmur3_long_lanes",
                     "fused_probe_verify", "dma_row_gather"])
    pairs = join_rows.value - before
    check_q19(rows, pairs, q19_want, "q19")
    if q19_counts["dict_gather"] != 42:
        raise AssertionError(f"q19: {q19_counts} (42 dict_gather launches)")
    print(f"q19 at SF1 ({Q19_LINES} x {Q19_PARTS}): revenue {rows[0][0]!r} "
          f"over {pairs} qualifying rows, equal to the numpy oracle; "
          f"launches {q19_counts}")

    # -- phase 4: steady state and kernel timings ----------------------------
    in_bytes = sum(ROWS * (c.data.element_size() + 1) for c in batch.columns)
    with speculation_scope() as scope:
        list(plan.execute())  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            list(plan.execute())
        torch.cuda.synchronize()
        q1_ms = (time.perf_counter() - t0) * 1e3 / ITERS
        if scope.tripped():
            raise AssertionError("speculation flag tripped in steady state")
    print(f"q1 steady state: {q1_ms:.3f} ms/iteration, "
          f"{in_bytes / q1_ms / 1e6:.1f} GB/s of column data "
          f"({ITERS} iterations, one sync)")
    q3_bytes = sum(v.nbytes for v in d3.values())
    with speculation_scope() as scope:
        list(q3.execute())  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(Q3_ITERS):
            list(q3.execute())
        torch.cuda.synchronize()
        q3_ms = (time.perf_counter() - t0) * 1e3 / Q3_ITERS
        if scope.tripped():
            raise AssertionError("q3 speculation flag tripped in steady "
                                 "state")
    print(f"q3 steady state: {q3_ms:.3f} ms/iteration, "
          f"{q3_bytes / q3_ms / 1e6:.1f} GB/s of column data "
          f"({Q3_ITERS} iterations, one sync)")
    q19_bytes = sum(
        x.nbytes for b in (l19, p19) for c in b.columns
        for x in ((c.codes, c.validity, c.dict_data, c.dict_offsets)
                  if hasattr(c, "codes") else (c.data, c.validity)))
    with speculation_scope() as scope:
        list(q19.execute())  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(Q19_ITERS):
            list(q19.execute())
        torch.cuda.synchronize()
        q19_ms = (time.perf_counter() - t0) * 1e3 / Q19_ITERS
        if scope.tripped():
            raise AssertionError("q19 speculation flag tripped in steady "
                                 "state")
    print(f"q19 steady state: {q19_ms:.3f} ms/iteration, "
          f"{q19_bytes / q19_ms / 1e6:.1f} GB/s of column data "
          f"({q19_bytes} bytes, {Q19_ITERS} iterations, one sync)")
    if args.profile:
        profile_plan("q1", plan, 10, args.profile)
        profile_plan("q3", q3, Q3_ITERS, args.profile.with_name(
            args.profile.stem + "_q3" + args.profile.suffix))
        profile_plan("q19", q19, Q19_ITERS, args.profile.with_name(
            args.profile.stem + "_q19" + args.profile.suffix))

    launch = fsa.launcher(q1_spec, batch, BUCKETS)
    ms = device_ms(launch, KERNEL_REPS)
    b2b_ms = cuda_ms(launch, KERNEL_REPS)
    call_ms = device_ms(
        lambda: fsa._partials_cuda(q1_spec, batch, BUCKETS), KERNEL_REPS)
    plain_ms = device_ms(
        lambda: fsa._partials_plain(q1_spec, batch, BUCKETS),
        max(3, KERNEL_REPS // 4))
    out_bytes = BUCKETS * sum(fsa._slots(q1_spec)) * 8
    bound_ms, bound_by = bound(in_bytes + out_bytes,
                               ROWS * ops_per_row(q1_spec))
    print(f"fused_scan_agg: kernel launches {ms:.4f} ms on the device, "
          f"{b2b_ms:.4f} ms back to back; wrapper call with its "
          f"allocations {call_ms:.4f} ms; plain {plain_ms:.4f} ms; "
          f"bound {bound_ms:.4f} ms ({bound_by}), "
          f"{bound_ms / ms:.1%} of the bound")
    records = [{
        "name": "fused_scan_agg",
        "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/fused_scan_agg.cu.in",
        "replaces": "spark_rapids_tpu/ops/pallas_fused.py:215",
        "launches": q1_counts["fused_scan_agg"],
        "max_abs_err": main_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }] + time_q3_kernels(q3_in, q3i_in, q3_counts, q3i_counts) + [
        time_dict_gather(l19, q19_counts["dict_gather"])]
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
