#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME, /usr/local/cuda or PATH); runs
from the repository root and imports nothing of JAX. Phases, each of which
fails the run on error:

  1. builds every kernel of the q1 path from csrc/ (one nvcc per source,
     all started together) and prints the build time and ptxas's register
     counts;
  2. holds each kernel against its plain PyTorch version on the card, on
     the q1 spec, a min/max/sum_sq/count spec and a spec that reaches the
     rest of the expression whitelist (zoo_spec), at sizes ragged against
     the block size, with nulls, a high-cardinality case whose leftover
     flag must trip, and the main path's own 16M-row inputs (integers and
     flags exact, f64 rtol 1e-9);
  3. drives bench.py's q1 plan (scan -> filter -> project -> aggregate) at
     16,777,216 rows through the port's execs, with every launch counter
     set to 0 just before and read just after, and checks the result
     against bench.py's numpy oracle (integers exact, f64 rtol 1e-9) and
     the speculation flag (must stay False);
  4. times the steady state (ITERS runs, one synchronisation) and each
     kernel against its plain version and its bound.

With --profile TRACE it also runs the q1 steady state under torch.profiler,
prints the device's busy share and time by kernel, and writes the Chrome
trace to the file TRACE.

The last lines are the card as nvidia-smi names it, a JSON line with one
record per ported kernel, and {"ok": true, "device": {...}}.
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
KERNEL_REPS = 20        # timed launches per kernel measurement
RTOL = 1e-9

#: H100 SXM (NVIDIA's data sheet): HBM rate and the non-tensor-core
#: float32 rate, which also bounds the kernel's integer and f64 work here
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

DEVICE = "cuda"

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


def cuda_ms(fn, reps):
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


def profile_q1(plan, iters, trace_path):
    """Where a q1 iteration's time goes: torch.profiler over `iters` runs.
    Prints the device's busy share of the profiled wall time (the union
    of kernel intervals), kernels per iteration, and device time by kernel
    name; writes the Chrome trace to `trace_path`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    with speculation_scope():
        list(plan.execute())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
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
    print(f"profile q1 ({iters} iterations under the profiler): "
          f"{wall_us / iters / 1e3:.3f} ms/iteration, device busy "
          f"{busy / iters / 1e3:.3f} ms/iteration = {busy / wall_us:.1%}, "
          f"{len(kernels) / iters:.0f} device activities/iteration")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {t / iters / 1e3:9.4f} ms/it {n // iters:5d}x  {name[:90]}")
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    print(f"trace: {trace_path}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--profile", metavar="TRACE", type=Path,
        help="also profile the q1 steady state (device busy share, time by "
             "kernel) and write its Chrome trace to TRACE")
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

    # -- data and plan (host set-up) --------------------------------------
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
    print(f"setup: {time.perf_counter() - t0:.1f} s (data, oracle, plan)")

    # -- phase 1: build every kernel at once -------------------------------
    t0 = time.perf_counter()
    sources = [fsa.kernel_source(s) for s in (q1_spec, mm_spec, zoo)]
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
    torch.cuda.synchronize()

    # -- phase 3: the main path, counted ------------------------------------
    fsa.fused_scan_agg.launches = 0
    with speculation_scope() as scope:
        out = list(plan.execute())
        torch.cuda.synchronize()
        launches = fsa.fused_scan_agg.launches
        tripped = scope.tripped()
    if launches < 1:
        raise AssertionError("the q1 path did not launch fused_scan_agg")
    if tripped:
        raise AssertionError("speculation flag tripped on the q1 path")
    rows = [r for b in out for r in b.to_pylist()]
    if sorted(r[0] for r in rows) != sorted(oracle):
        raise AssertionError(f"q1 groups {rows} != oracle {oracle}")
    for k, qty, dp, cnt in rows:
        oq, odp, oc = oracle[k]
        if qty != oq or cnt != oc or abs(dp - odp) > RTOL * abs(odp):
            raise AssertionError(f"q1 group {k}: {(qty, dp, cnt)} != "
                                 f"oracle {oracle[k]}")
    print(f"q1 at {ROWS} rows: {len(rows)} groups equal to the numpy "
          f"oracle; fused_scan_agg launches={launches}")

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
    if args.profile:
        profile_q1(plan, 10, args.profile)

    ms = cuda_ms(lambda: fsa._partials_cuda(q1_spec, batch, BUCKETS),
                 KERNEL_REPS)
    plain_ms = cuda_ms(lambda: fsa._partials_plain(q1_spec, batch, BUCKETS),
                       max(3, KERNEL_REPS // 4))
    S0, S1 = fsa._slots(q1_spec)
    out_bytes = BUCKETS * (S0 + S1) * 8 + 4
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    ops_ms = ROWS * ops_per_row(q1_spec) / PEAK_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"fused_scan_agg: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'}), "
          f"{bound_ms / ms:.1%} of the bound")
    record = {"kernels": [{
        "name": "fused_scan_agg",
        "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/fused_scan_agg.cu.in",
        "replaces": "spark_rapids_tpu/ops/pallas_fused.py:215",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
