#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME, /usr/local/cuda or PATH); runs
from the repository root and imports nothing of JAX. Phases, each of which
fails the run on error:

  1. builds every kernel of the q1, q3 and q19 paths (the fused
     scan-aggregate specs, csrc/murmur3.cu, csrc/probe_verify.cu,
     csrc/row_gather.cu, csrc/dict_gather.cu), and the murmur3 kernel
     this one replaced, which phase 4 times against
     (REPLACED_MURMUR3_SOURCE); one nvcc per source,
     all started together; prints the build time and ptxas's register and
     spill counts; then the shuffle's host block codec
     (csrc/blockcodec.cpp) with the host compiler;
  2. holds each kernel against its plain PyTorch version on the card:
     fused_scan_agg on three specs at sizes ragged against the block size,
     with nulls, a high-cardinality case whose leftover flag must trip and
     a case whose lanes see more buckets than their register cache holds;
     the murmur3 chain over all nine key types with nulls, -0.0, NaNs and
     negative values, aligned and as x[1:] views, at 0 rows and row counts
     ragged around a thread's 4 rows and a block's 1,024, over 1 to 4
     columns in one launch and 5 and 9 in more, with one seed, two and
     per-row seed planes, and its i64 and i32 lanes with per-row seeds
     (exact); probe-verify on random
     lanes with duplicate build keys, buckets shared by several keys, empty
     ranges, one to three key lanes, a candidate bucket smaller than the
     total or equal to it, a total of 0, ranges longer than a tile, wholly
     empty tiles and over 1,000 tiles (exact on the slots below the
     total), its scratch left zero; the packed row gather at every width
     the main paths pack and at widths of its generic kernel, with -1,
     out-of-range and INT32_MIN indices or all of them out of range, f64
     lanes with NaN payloads and a matrix off alignment (exact bits); the
     dictionary
     gather at the TPU kernel's own (4096, 128) x (16384, 128) shape and on
     1- and 4-byte tables of 1, 3, 5 and 128 lanes through both of its
     kernels (one-lane tables staged and not), with codes of -1, n
     and above on ragged row counts, aligned and as x[1:] views (exact);
     and every kernel on its main path's own inputs (the murmur3 chain on
     each join's build keys with both seeds and its stream keys, every row
     gather of each path captured from a run of a fresh plan: q3, q19,
     P6's filter compaction and sort and P7's build permute and payloads;
     every dictionary gather of P7, its take of the ship-mode hash table
     by the stream's codes among them; every row gather of P9-P11, the
     exchanges' reorders among them, the murmur3 chain at the exchange's
     pid shape, and P11's join kernels at its first partition pair;
     every row gather of P13, its semi join's hash, probe and gathers,
     its anti join's probe and its dictionary gathers at the
     o_orderstatus and n_name filters; P12's join kernels and row
     gathers; P14's at a left outer join built on each side and a full
     outer join (the unmatched stream tail, the unmatched build rows);
     every row gather of P15's planned nested-loop join, its chunks
     among them; every row gather of P16's planned semi join and its
     join kernels at its first partition pair; P19's murmur3 chain and
     probe at both joins, every row gather (the TopN's sort moves the
     decimal128 revenue as two limb lanes) and its dictionary take);
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
     stay False), and the launches: fused_scan_agg once per q1,
     dict_gather 42 times per q19, murmur3_columns twice (one launch per
     join side, both build seeds in one) and the per-row-seed lanes never
     per q3, INT-key q3 and q19, fused_probe_verify once and dma_row_gather
     5 times per q3 (3 per q19);
  3b. drives the paths of late materialization and the memory runtime,
     each counted the same way, with its host reads (the synchronizing
     CUDA calls of the run): P1, Q19 again, whose join output decodes at
     the join -> aggregate boundary (the decode counters must move); P2,
     the q3 plan with its lineitems as 16 batches of 131,072 rows, once
     unconstrained and then under a device budget from that run's peak
     catalog bytes (a quarter of it, or the bytes the plan held in use at
     once where that is more) and a host limit of an eighth, with one
     injected split-and-retry OOM in the first aggregate update: it must
     spill to the host and the disk, unspill, split, equal q3's oracle
     and leave the catalog empty; P3, a SortExec over q3's lineitems as
     32 batches of 65,536 rows by l_orderkey ASC, l_price DESC, out of
     core in two merge passes under the same budget rule, equal to
     np.lexsort's order, catalog empty. Then the scan ingest path, read
     with collect() (its output fetched in one packed device->host copy
     a batch): P4, q3 from host data (HostSource: each step builds one
     batch of host columns from numpy and uploads it in one packed copy)
     through two SourceScanExecs, the lineitems as 16 batches of 131,072
     rows and the orders as 4, the admission semaphore at 2 permits, at
     pipeline depth 0 and 2: each equal to q3's oracle, the two depths'
     rows bit-identical, 20 uploads in 20 transfers and one fetch, the
     launches of the same plan over the same batches built on the card
     (counted in the same run), no permit held and the catalog
     empty after; P5, Q19 at SF1 from host data, one batch a table with
     its four DictionaryColumns packed as codes, validity, dictionary
     bytes and offsets, at depth 2: equal to q19_oracle, 2 uploads, one
     fetch, the launches of phase 3's q19. Then the string keys: P6,
     TPC-H Q1 at SF1 (clause 2.4.1, DELTA 90) over the 6,001,215
     lineitems, l_returnflag and l_linestatus DictionaryColumns that
     decode at the aggregate's boundary, grouped by the 2-round hash
     group-by and ordered by the two strings: 4 groups equal to
     tpch_q1_oracle in the order A/F, N/F, N/O, R/F, 2 row gathers; P7,
     the lineitems (l_shipmode encoded) joined to the 7 ship modes on the
     string key, once with the build key a StringColumn and once a
     DictionaryColumn in another order, then summed by mode: equal to
     shipmode_oracle, the dictionaries hashed once each (dict_gather 1
     and 3 times), 2 row gathers, no probe kernel; P8, count(*) by
     1,048,576 distinct c_name strings in one batch at capacity, its
     route printed, every count 1 and the keys the input's; and the
     card's xxhash64_batch and murmur3_string of those names and of
     random bytes and UTF-8 text of 0-70 bytes, bit for bit against
     numpy references of Spark's hashes (np_xxhash64_bytes,
     np_murmur3_bytes). Then the host shuffle, each path through 16
     partitions (Spark's default 200 cut for the run's time limit), read
     with collect()'s run and failing where collect() would re-run it:
     P9, bench q1 as 16 batches of 1,048,576 rows split into a partial
     aggregate (the fused kernel with the filter and project absorbed),
     a HostShuffleExchangeExec on the flag and a final aggregate, equal to
     bench.numpy_oracle; P10, TPC-H Q1 at SF1 with its string route split
     the same way over both flags, then the sort: 4 groups equal to
     tpch_q1_oracle in the order A/F, N/F, N/O, R/F; P11, q3 as 16
     lineitem and 4 order batches, both filtered sides exchanged on the
     order key into a ShuffledHashJoinExec, partial -> exchange -> final,
     TopN(10), LONG and INT keys, equal to bench.q3_oracle. Each path's
     launches equal what its plan implies (expect_p9, expect_p10,
     expect_p11: one murmur3 launch and one reorder gather a map batch
     with rows on fixed-width keys, none for P10's string keys, the probe
     once a stream batch of a partition pair with rows on both sides;
     P11's row gathers at least the floor its filters, reorders, join and
     TopN imply), every exchange reads each frame it wrote with one
     upload, the shuffle root is empty after, the catalog empty and no
     permit held;
  3c. builds the same queries again as DataFrame queries of the port's
     session (TpuSession(conf, "cuda"), api/functions) over the batches
     phase 3 built: q1, q3 with LONG and INT keys and the exact tier by
     conf (spark.rapids.tpu.agg.speculative.enabled=false), Q19, P6 and
     P11 (spark.rapids.sql.shuffle.partitions=16, broadcastSizeThreshold
     -1); prints each one's explain() text and its plan ms (wrap_and_tag
     and convert, timed apart), holds q1's, P6's and P11's converted trees
     to the hand-built plans' shapes, drives each converted tree counted
     as phase 3 does (the speculation flags must stay False) and holds it
     to its oracle, then collect()s it through the session, counted,
     which must launch the same; every launch count that differs from the
     hand-built plan's must be accounted for by a planned node, which is
     printed (a BroadcastExchangeExec over a FilterExec compacts the build
     side the hand-built join masks; a CoalesceBatchesExec that merged
     batches runs the operators above it fewer times); the catalog empty,
     no permit held and the shuffle root empty after each;
  3d. drives the join types, the nested-loop join and the basic operators
     over TPC-H data made by clause 4.2.3's rules at SF1
     (tpch_join_data: 1,500,000 orders, ~6.0 M lineitems, 10,000
     suppliers, 25 nations; o_orderstatus and n_name DictionaryColumns),
     each held to a numpy oracle with its launches counted and printed:
     P12, TPC-H Q4 (clause 2.4.4, a left semi join), hand-built and
     planned at the default confs; P13, TPC-H Q21 (clause 2.4.21, a left
     semi and a left anti join with residual conditions, three inner
     joins, TopN(100) by numwait DESC, s_name), hand-built and planned
     with broadcasts off (at the default confs the planner of either
     package takes the adaptive join there); P14, q3's filtered sides
     under every join type on both build sides where allowed (row count,
     both sides' key multisets and null counts); P15, 1,048,576
     lineitems left-outer-joined to 11 discount bands on a band condition
     (planned: a NestedLoopJoinExec over a broadcast), counted by band;
     P16, Q4's semi and anti joins through 16 partitions of the host
     shuffle (planned, broadcasts off, at the default tier); then a range
     of 2^24 ids summed, the union of the orders' two halves counted by
     priority, a limit of 100 at offset 1,000 and TPC-H Q1's count and
     sum over the grouping sets ((l_returnflag, l_linestatus), ())
     through an Expand, each planned from DataFrames;
  3e. drives the rest of A.8 wave 1 on the true TPC-H types, each planned
     from DataFrames and held to an exact oracle (every decimal to the
     last digit, as Python ints) with its launches counted: P17, TPC-H Q1
     (DELTA 90) over P6's 6,001,215 lineitems with DECIMAL(12, 2) money
     and a DATE ship date, l_shipdate <= date_sub(DATE '1998-12-01', 90),
     sums to DECIMAL(22, 2) and (36, 4) and count(*) by the two flags;
     P18, TPC-H Q6 over the same lines, a grand decimal128 sum; P19,
     TPC-H Q3 at SF1 (150,000 customers, c_mktsegment = 'BUILDING' on the
     codes, P12's orders and lineitems with o_custkey, o_shippriority and
     DECIMAL(12, 2) prices), a decimal128 revenue by three keys, TopN(10),
     broadcasts off; P20, the lineitems' sample(0.1, seed=7) (the rows
     the port's threefry keeps on the CPU) with a cast to string against
     Python's Decimal, round, bround, two shifts and from_utc_timestamp
     at +05:30; the orders sorted by (o_orderdate, o_orderkey) over 16
     host partitions (PartitionWiseSortExec) against np.lexsort; and
     count(*) by year(o_orderdate);
  4. times the q1, q3 and q19 steady states (one synchronisation per run
     of iterations) and each kernel against its plain version, its bound
     and, for the row gather and the dictionary gather, the one PyTorch
     call that computes the same function; the murmur3 lanes at q3's
     stream keys and the chain at the q3 build pair, q3 stream and q19
     stream, each in turns with what ran there before (the replaced lane
     kernel; its seed plane, lane kernel and select per seed);
     fused_scan_agg's,
     dict_gather's, fused_probe_verify's and dma_row_gather's launches are
     timed apart from their wrappers' calls too, dict_gather at three
     shapes (q19's take, P7's stream take and dg's), the probe at q3's and
     q19's and the row gather at every shape of q3, q19, P6 and P7 (summed
     per iteration). Kernel
     times are the device's, with the L2 cache flushed before each run
     (device_ms). Also P2's and P3's ms per iteration under their
     budgets, Q19's decode counters per iteration, and the spill lane's
     rates on the full lineitem batch: the copy into pinned memory, the
     disk write and read, and the packed copy back to the card
     (upload_leaves). Then P4's ms per iteration at depth 0 and 2 in
     turns (no staging-pool miss may follow P4's first iteration) and
     P5's; a fresh and a cached pinned allocation of Q19's staging
     bucket; and on one q3 lineitem batch and Q19's lineitem batch the
     host pack's GB/s, the copy's GB/s, the whole packed upload's ms and
     a per-buffer build's ms (from_numpy_columns, or the Q19 columns
     built on the card buffer by buffer). Then P6's and P7's ms per
     iteration in steady state (one synchronisation per run). Last, P9,
     P10 and P11 in steady state (3 runs each, one synchronisation a run)
     with each exchange's phase times per run from its metrics (write,
     split, the split's device->host copy, serialize, LZ4 summed over the
     writer pool, file IO, read wait, the read seam's upload) and P11's
     join build and probe time; the split's fetch of one q3 lineitem map
     batch in GB/s (fetch_split_host, and the copy alone); the murmur3
     chain at the pid shape (131,072 LONG and INT keys, seed 42); and
     dma_row_gather at every reorder shape beside index_select and, where
     a fixed-width kernel serves it, the generic kernel. Then q1, q3 and
     Q19 through the session (df.collect(), the plan included) and as
     their hand-built plans (plan.collect()), in turns, 5 runs each. Then
     P12-P16 (3 runs each, one synchronisation a run), and the probe at
     Q21's semi and anti joins and the row gather at every shape of Q21.
     Then P17-P20 (collect() of the planned tree, 3 runs each, one
     synchronisation a run) and rows 2, 4, 5 and 6 at every P19 shape
     (p19_kernel_shapes).

With --profile TRACE it also runs each steady state under torch.profiler
(after the kernel timings, which a profiled process perturbs),
prints the device's busy share and time by kernel, and writes the Chrome
traces to TRACE (q1) and TRACE with "_q3", "_q19", "_p6", "_p7",
"_p17", "_p18", "_p19", "_p20_sample", "_p20_sort" or "_p20_year" before
its suffix.

The last lines are a JSON line with the records of P1-P11, the spill
rates, the ingest rates, the split's fetch rates and the planned queries
of phase 3c (under "planned": plan ms, launches beside the hand-built
plan's, the differences and the session timings) and phase 3d's (under
"join_paths": launches, rows and ms) and phase 3e's (under
"types_paths"), a JSON line with one record per
ported kernel (the
dictionary gather's holds its times at dg's shape under "dg_shape", the
probe's Q19's under "q19_shape" and Q21's under "q21_shapes", the row
gather's every shape under "shapes", the reorders' under
"reorder_shapes" and Q21's under "q21_shapes", the murmur3 chain's
three sites under "sites" and the pid hash under "pid_shapes", and each
kernel's launches on P1-P20 and the planned queries under
"path_launches", and rows 2, 4, 5 and 6 at P19's shapes under
"p19_shapes"), the card as
nvidia-smi names it, and {"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import datetime
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
PORTED_KERNEL_PREFIXES = ("fsa_", "void m3_rows", "void probe_scan_emit",
                          "void row_gather", "void dict_gather")

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


def device_ms(fn, reps, flush_bytes=FLUSH_BYTES):
    """Mean device time of `fn`'s launches with the L2 cache cold, as the
    main path finds it: before each run a write of `flush_bytes` evicts L2
    and keeps the card busy while the host enqueues `fn` between two
    events, so the events bracket its device work and no host gap (a
    function of many launches needs a longer write to stay ahead)."""
    import torch
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
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


def q3_schemas(key_type):
    """(orders, lineitem) schemas of the q3 lane."""
    from spark_rapids_tpu_torch import types as t
    kt = getattr(t, key_type)
    return (t.Schema((t.StructField("o_orderkey", kt),
                      t.StructField("o_flag", t.INT))),
            t.Schema((t.StructField("l_orderkey", kt),
                      t.StructField("l_price", t.DOUBLE),
                      t.StructField("l_disc", t.DOUBLE),
                      t.StructField("l_flag", t.INT))))


def q3_batches(d, dev, schema, n, parts=1):
    """The first n rows of `schema`'s columns as `parts` batches of
    equal size."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column, bucket_capacity
    step = n // parts
    cap = bucket_capacity(step)
    return [ColumnarBatch([Column.from_numpy(
        d[f.name][i: i + step], f.data_type, capacity=cap, device=dev)
        for f in schema.fields], step, schema) for i in range(0, n, step)]


def q3_tree(m, orders, lines, n_parts=None):
    """bench.py make_q3_plan's operator tree above the two leaf execs, in
    the package whose modules `m` holds (`port_modules()`, or the JAX
    package's in the tests). With `n_parts`, the plan the JAX package's
    planner makes of it over the host shuffle (P11): each filtered side
    hash-exchanged on its order key into n_parts partitions, a
    ShuffledHashJoinExec, and the aggregate split into partial -> hash
    exchange -> final."""
    col, lit, b = m.core.col, m.core.lit, m.basic
    lines = b.FilterExec(col("l_flag") != lit(0), lines)
    orders = b.FilterExec(col("o_flag") < lit(5), orders)
    lk, ok = [col("l_orderkey")], [col("o_orderkey")]
    if n_parts is None:
        joined = m.joins.HashJoinExec(lines, orders, lk, ok, "inner",
                                      build_side="right")
    else:
        joined = m.exchange.ShuffledHashJoinExec(
            shuffle_of(m, lk, lines, n_parts),
            shuffle_of(m, ok, orders, n_parts), lk, ok, "inner",
            build_side="right")
    proj = b.ProjectExec([
        col("l_orderkey"),
        (col("l_price") * (lit(1.0) - col("l_disc"))).alias("rev")], joined)
    aggs = [(m.aggexprs.Sum(col("rev")), "revenue")]
    # as bench.py: the exact tier
    agg = m.agg.AggregateExec(lk, aggs, proj) if n_parts is None \
        else shuffled_aggregate(m, lk, aggs, proj, n_parts, exact=True)
    agg._spec_enabled = False
    return m.sort.TopNExec(10, [(col("revenue"), False)], agg)


def q3_plan(d, dev, key_type, line_batches=1, order_batches=1):
    """bench.py make_q3_plan in the port over batches built on `dev`; the
    lineitems fed as `line_batches` batches of equal size, the orders as
    `order_batches`."""
    m = port_modules()
    o_schema, l_schema = q3_schemas(key_type)
    return q3_tree(m, m.basic.InMemoryScanExec(
        q3_batches(d, dev, o_schema, Q3_ORDERS, order_batches), o_schema),
        m.basic.InMemoryScanExec(
            q3_batches(d, dev, l_schema, Q3_LINES, line_batches), l_schema))


class HostSource:
    """A scan's source of host data: each step of `batches()` builds one
    batch's host columns from numpy (CPU tensors at their capacity) and
    uploads them to `device` in one packed copy (to_device_batch).
    `parts` are zero-argument callables giving (columns, row count)."""

    def __init__(self, schema, parts, device):
        self.schema = schema
        self._parts = list(parts)
        self.device = device

    def batches(self):
        from spark_rapids_tpu_torch.columnar.upload import to_device_batch
        for make in self._parts:
            cols, n = make()
            yield to_device_batch(cols, n, self.schema, self.device)


def q3_host_parts(d, schema, n, parts):
    """The first n rows of `schema`'s columns as `parts` callables, each
    making one batch's host columns (equal sizes)."""
    from spark_rapids_tpu_torch.columnar.column import Column, bucket_capacity
    step = n // parts
    cap = bucket_capacity(step)

    def part(i):
        return lambda: ([Column.from_numpy(d[f.name][i: i + step],
                                           f.data_type, capacity=cap,
                                           device="cpu")
                         for f in schema.fields], step)
    return [part(i) for i in range(0, n, step)]


def q3_source_plan(d, dev, depth, line_batches, order_batches):
    """q3 over two SourceScanExecs of host data at pipeline `depth`."""
    m = port_modules()
    o_schema, l_schema = q3_schemas("LONG")

    def scan(schema, n, parts):
        return m.basic.SourceScanExec(
            HostSource(schema, q3_host_parts(d, schema, n, parts), dev),
            schema, depth)
    return q3_tree(m, scan(o_schema, Q3_ORDERS, order_batches),
                   scan(l_schema, Q3_LINES, line_batches))


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


#: clause 4.2.3: order dates run from STARTDATE to ENDDATE - 151 days,
#: CURRENTDATE splits returned from open lines (days since the epoch)
ORDER_DATE_FIRST = 8035          # 1992-01-01
ORDER_DATE_LAST = 10440          # 1998-08-02
CURRENT_DATE = 9298              # 1995-06-17
RETURNFLAGS = ("A", "N", "R")
LINESTATUSES = ("F", "O")


def q19_data(n_part=Q19_PARTS, n_line=Q19_LINES, seed=19):
    """part and lineitem columns by TPC-H's generation rules (clause
    4.2.3), from a fixed seed. A string column is (int32 codes, values):
    the values are its dictionary, as a Parquet dictionary page holds it.
    Q1's columns (l_tax, l_shipdate, l_returnflag, l_linestatus) are drawn
    after the others, so those are what they were without them; each line
    draws its own order date (Q1 reads no order column)."""
    rng = np.random.default_rng(seed)
    partkey = np.arange(1, n_part + 1, dtype=np.int64)
    retail = (90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)) / 100
    l_partkey = rng.integers(1, n_part + 1, n_line, dtype=np.int64)
    qty = rng.integers(1, 51, n_line).astype(np.float64)

    def codes(values, n):
        return rng.integers(0, len(values), n).astype(np.int32), values

    d = {
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
    d["l_tax"] = rng.integers(0, 9, n_line) / 100.0
    order = rng.integers(ORDER_DATE_FIRST, ORDER_DATE_LAST + 1, n_line)
    ship = order + rng.integers(1, 122, n_line)
    receipt = ship + rng.integers(1, 31, n_line)
    returned = np.where(rng.integers(0, 2, n_line) == 0,
                        RETURNFLAGS.index("R"), RETURNFLAGS.index("A"))
    d["l_shipdate"] = ship.astype(np.int32)
    d["l_returnflag"] = (np.where(receipt <= CURRENT_DATE, returned,
                                  RETURNFLAGS.index("N")).astype(np.int32),
                         RETURNFLAGS)
    d["l_linestatus"] = ((ship > CURRENT_DATE).astype(np.int32),
                         LINESTATUSES)
    return d


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
    from spark_rapids_tpu_torch.exec import (aggregate, basic, exchange,
                                             joins, sort)
    from spark_rapids_tpu_torch.expr import aggexprs, core, predicates
    return SimpleNamespace(t=t, core=core, pred=predicates, basic=basic,
                           joins=joins, agg=aggregate, aggexprs=aggexprs,
                           sort=sort, exchange=exchange)


def q19_schemas(t):
    return [t.Schema(tuple(t.StructField(n, getattr(t, ty)) for n, ty in fs))
            for fs in (Q19_LINE_FIELDS, Q19_PART_FIELDS)]


def q19_columns(d, schema, dev):
    """The port's columns of one Q19 table on `dev`, and its row count:
    fixed-width columns and DictionaryColumns from the numpy arrays."""
    from spark_rapids_tpu_torch.columnar.column import Column, string_buffers
    from spark_rapids_tpu_torch.columnar.encoded import dictionary_from_numpy
    cols = []
    for f in schema.fields:
        v = d[f.name]
        if isinstance(v, tuple):
            cols.append(dictionary_from_numpy(
                v[0], *string_buffers(v[1]), device=dev))
        else:
            cols.append(Column.from_numpy(v, f.data_type, device=dev))
    first = d[schema.fields[0].name]
    return cols, (first[0] if isinstance(first, tuple) else first).shape[0]


def q19_batches(d, dev):
    """The port's lineitem and part batches, built on `dev`."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    return [ColumnarBatch(*q19_columns(d, schema, dev), schema)
            for schema in q19_schemas(port_modules().t)]


def q19_source_plan(d, dev, depth):
    """Q19 over two SourceScanExecs, each one batch of host data."""
    m = port_modules()

    def scan(schema):
        return m.basic.SourceScanExec(HostSource(
            schema, [lambda: q19_columns(d, schema, "cpu")], dev), schema,
            depth)
    return q19_tree(m, *[scan(s) for s in q19_schemas(m.t)])


def q19_plan(m, l_batch, p_batch, terms=Q19_TERMS, span=Q19_QTY_SPAN,
             shipmodes=Q19_SHIPMODES):
    """q19_tree over one batch of each table."""
    b = m.basic
    return q19_tree(m, b.InMemoryScanExec([l_batch], l_batch.schema),
                    b.InMemoryScanExec([p_batch], p_batch.schema), terms,
                    span, shipmodes)


def q19_tree(m, line_scan, part_scan, terms=Q19_TERMS, span=Q19_QTY_SPAN,
             shipmodes=Q19_SHIPMODES):
    """TPC-H Q19 as Spark plans it above the two leaf execs, in the
    package whose modules `m` holds (`port_modules()`, or the JAX
    package's in the tests):

      l = Filter(l_shipmode IN (...) AND l_shipinstruct = '...', scan)
      p = Filter(p_size >= 1 AND (term 1 OR term 2 OR term 3), scan)
      j = HashJoin(l, p, l_partkey = p_partkey, inner, build right,
                   condition = the query's three-way OR)
      Aggregate(sum(l_extendedprice * (1 - l_discount)), Project(j))"""
    col, lit, pr = m.core.col, m.core.lit, m.pred

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
    lines = b.FilterExec(all_of(*ship), line_scan)
    parts = b.FilterExec(
        pr.And(pr.GreaterThanOrEqual(col("p_size"), lit(1)),
               any_of(*part_terms)), part_scan)
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
            "murmur3_columns": murmur3_lanes.murmur3_columns,
            "murmur3_long_lanes": murmur3_lanes.murmur3_long_lanes,
            "murmur3_int_lanes": murmur3_lanes.murmur3_int_lanes,
            "fused_probe_verify": probe_verify.fused_probe_verify,
            "dma_row_gather": row_gather.dma_row_gather,
            "dict_gather": dict_gather.dict_gather}


def drive_counted(label, plan, need):
    """Run `plan` once under a speculation scope with every launch counter
    set to 0 just before and read just after; fail if the flag tripped or
    a kernel in `need` was not launched. Returns (rows, counts)."""
    out, counts, _ = drive_batches(label, plan, need)
    return [r for b in out for r in b.to_pylist()], counts


def drive_batches(label, plan, need):
    """drive_counted's run, returning (batches, counts, host reads): the
    host reads are the synchronizing CUDA calls the run made (CUDA's sync
    debug mode warns on each), counted between the counter reset and the
    counter read."""
    import warnings
    import torch
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    with speculation_scope() as scope, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = list(plan.execute())
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        counts = {name: w.launches for name, w in wrappers.items()}
        tripped = scope.tripped()
    if tripped:
        raise AssertionError(f"{label}: speculation flag tripped")
    idle = [k for k in need if counts[k] < 1]
    if idle:
        raise AssertionError(f"{label}: kernels not launched: {idle} "
                             f"(counts {counts})")
    reads = sum("synchroniz" in str(w.message) for w in caught)
    return out, counts, reads


# -- slice 4: late materialization and the memory runtime -----------------

P2_LINE_BATCHES = 16     # q3's lineitems as 16 batches of 131,072 rows
P3_LINE_BATCHES = 32     # the sort's input: 32 batches of 65,536 rows
P_ITERS = 3              # timed runs of P2 and P3 each


def sort_plan(d, dev):
    """P3: SortExec over q3's lineitems in P3_LINE_BATCHES batches, by
    l_orderkey ASC, l_price DESC (out of core: more runs than the fan-in)."""
    from spark_rapids_tpu_torch.exec.basic import InMemoryScanExec
    from spark_rapids_tpu_torch.exec.sort import SortExec
    from spark_rapids_tpu_torch.expr.core import col
    schema = q3_schemas("LONG")[1]
    return SortExec([(col("l_orderkey"), True, None),
                     (col("l_price"), False, None)],
                    InMemoryScanExec(q3_batches(d, dev, schema, Q3_LINES,
                                                P3_LINE_BATCHES), schema))


def check_sort(batches, d, label):
    """Every row, in the order np.lexsort((-l_price, l_orderkey)) gives
    (the random f64 prices make ties practically absent)."""
    order = np.lexsort((-d["l_price"], d["l_orderkey"]))
    names = [f.name for f in q3_schemas("LONG")[1].fields]
    got = {n: [] for n in names}
    rows = 0
    for b in batches:
        n = b.num_rows_host
        rows += n
        for name, c in zip(names, b.columns):
            if not bool(c.validity[:n].all()):
                raise AssertionError(f"{label}: nulls in {name}")
            got[name].append(c.data[:n].cpu().numpy())
    if rows != Q3_LINES:
        raise AssertionError(f"{label}: {rows} rows, not {Q3_LINES}")
    for name in names:
        if not np.array_equal(np.concatenate(got[name]), d[name][order]):
            raise AssertionError(f"{label}: {name} out of order")


def drive_under_budget(label, make_plan, need, check, split):
    """P2 / P3: the plan once unconstrained, then under a device budget
    from that run's peak catalog bytes: a quarter of the peak, or what the
    plan held in use at once (no spill frees that) where that is more;
    the host limit an eighth of the peak. With `split`, one injected
    split-and-retry OOM in the first guarded step. Returns (the
    constrained plan, its counts, a record of the run)."""
    from spark_rapids_tpu_torch import memory as M

    def run(tag, limit, host_limit):
        cat = M.reset_buffer_catalog(host_limit=host_limit)
        budget = M.reset_memory_budget(limit)
        M.register_task(1)
        if split:
            M.force_split_and_retry_oom(1)
        plan = make_plan()
        t0 = time.perf_counter()
        out, counts, reads = drive_batches(f"{label} {tag}", plan, need)
        ms = (time.perf_counter() - t0) * 1e3
        check(out, f"{label} {tag}")
        cat.drain_writeback()
        return plan, cat, budget, counts, reads, ms
    _, cat, budget, free_counts, _, _ = run("unconstrained", None, None)
    peak, pinned = budget.peak, cat.peak_pinned_bytes
    limit, host_limit = max(peak // 4, pinned), peak // 8
    rule = "a quarter of the peak" if limit == peak // 4 \
        else "what it holds in use at once"
    print(f"{label}: unconstrained peak catalog {peak} bytes, in use at "
          f"once {pinned}; budget {limit} ({rule}), host limit "
          f"{host_limit}")
    plan, cat, budget, counts, reads, ms = run("under budget", limit,
                                               host_limit)
    # the later phases run under the default budget again
    M.reset_buffer_catalog()
    M.reset_memory_budget()
    c = cat.counters()
    retries, splits = M.task_retry_counts()
    if not (c["to_host"] and c["to_disk"] and c["to_device"]):
        raise AssertionError(f"{label}: spills {c} (host, disk and "
                             f"unspills must each be > 0)")
    if split and splits < 1:
        raise AssertionError(f"{label}: no split ({retries}, {splits})")
    if cat.num_entries() or cat.device_bytes():
        raise AssertionError(f"{label}: catalog left {cat.num_entries()} "
                             f"entries, {cat.device_bytes()} device bytes")
    rec = {"peak_bytes": peak, "pinned_bytes": pinned, "budget": limit,
           "host_limit": host_limit, "retries": retries, "splits": splits,
           "host_reads": reads, "first_run_ms": ms,
           "unconstrained_launches": free_counts, **c}
    print(f"{label}: equal to its oracle under the budget; spills {c}, "
          f"retries {retries}, splits {splits}, host reads {reads}; "
          f"launches {counts}; catalog empty")
    return plan, counts, rec


def time_under_budget(plan, rec):
    """ms per iteration of a budgeted plan (fresh catalog, same budget,
    no injection), one synchronisation per run."""
    import torch
    from spark_rapids_tpu_torch import memory as M
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    times = []
    for _ in range(P_ITERS):
        cat = M.reset_buffer_catalog(host_limit=rec["host_limit"])
        M.reset_memory_budget(rec["budget"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with speculation_scope():
            for _b in plan.execute():
                pass
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        cat.drain_writeback()
    M.reset_buffer_catalog()
    M.reset_memory_budget()
    return times


def spill_rates(batch):
    """GB/s of each hop of the spill lane on `batch`'s leaves, through the
    catalog's own functions: the copy into pinned memory (to its event),
    the CRC-stamped disk write (fsync'd) and read, and the packed copy
    back to the card (upload_leaves, as an unspill). One warm-up, then the
    mean of three."""
    import shutil
    import tempfile
    import torch
    from spark_rapids_tpu_torch.columnar.upload import upload_leaves
    from spark_rapids_tpu_torch.memory import catalog as C
    leaves, _ = batch.flatten()
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-spill-")
    path = f"{tmp}/rate.npz"
    try:
        def d2h():
            host, ev = C.copy_to_host(leaves)
            ev.synchronize()
            return host
        host = d2h()

        def h2d():
            upload_leaves(host, batch.device)
            torch.cuda.synchronize()
        hops = {"d2h_pinned": d2h,
                "disk_write": lambda: C.write_spill_file(path, host),
                "disk_read": lambda: C.read_spill_file(path),
                "h2d": h2d}
        out = {}
        for name, fn in hops.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            out[name] = nbytes * 3 / (time.perf_counter() - t0) / 1e9
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return nbytes, out


# -- slice 5: the scan ingest path -----------------------------------------

P4_ORDER_BATCHES = 4     # q3's orders as 4 host batches of 131,072 rows
P4_ITERS = 4             # timed runs of P4 at each depth, in turns
P5_ITERS = 3             # timed runs of P5


def io_counters():
    """The upload and fetch counters and the staging pool's misses."""
    from spark_rapids_tpu_torch.columnar import transfer, upload
    return dict(upload.counters(), **transfer.counters())


def drive_collect(label, plan, need):
    """`plan.collect()` with every launch counter set to 0 just before and
    read just after, and the upload and fetch counters' deltas over the
    run; fails if a kernel in `need` was not launched. collect() re-runs a
    plan whose speculation flag tripped, which doubles its launches: the
    callers compare the launches with a plain run's. Returns (rows,
    launches, io deltas, ms)."""
    import torch
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    before = io_counters()
    t0 = time.perf_counter()
    rows = plan.collect()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {name: w.launches for name, w in wrappers.items()}
    io = {k: v - before[k] for k, v in io_counters().items()}
    idle = [k for k in need if counts[k] < 1]
    if idle:
        raise AssertionError(f"{label}: kernels not launched: {idle} "
                             f"(counts {counts})")
    return rows, counts, io, ms


def check_scan_io(label, io, uploads, fetches):
    """One host->device transfer per scanned batch, one device->host
    transfer per collected batch."""
    if io["uploads"] != uploads or io["transfers"] != uploads:
        raise AssertionError(f"{label}: {io['uploads']} uploads in "
                             f"{io['transfers']} transfers, not {uploads}")
    if io["d2h_copies"] != fetches:
        raise AssertionError(f"{label}: {io['d2h_copies']} device->host "
                             f"copies, not {fetches}")


def check_idle(label):
    """No admission permit held, the catalog empty, after a path."""
    from spark_rapids_tpu_torch.memory import buffer_catalog, tpu_semaphore
    sem = tpu_semaphore()
    if sem.holders() or sem.available != sem.permits:
        raise AssertionError(f"{label}: {sem.holders()} tasks hold "
                             f"permits, {sem.available} of {sem.permits} "
                             f"free")
    if buffer_catalog().num_entries():
        raise AssertionError(f"{label}: catalog holds "
                             f"{buffer_catalog().num_entries()} entries")


def upload_rates(make_cols, n, schema, dev, per_buffer):
    """The packed upload of one batch, step by step: ms of building its
    host columns (`make_cols()`); of taking a staging buffer from the
    pool and freeing it (`acquire_ms`: for a batch larger than the pool
    keeps, a pinned allocation from PyTorch's caching host allocator);
    GB/s of the host pack into the buffer (acquire included) and of its
    one copy to the card (to a synchronisation); ms of the whole packed
    upload and of `per_buffer()`, a build of the same batch on the card
    one buffer at a time. One warm-up, then the mean of three, each
    between synchronisations."""
    import torch
    from spark_rapids_tpu_torch.columnar import upload
    pool = upload.staging_pool()
    cols = make_cols()

    def acquire():
        pool.release(pool.acquire(total))

    def pack():
        buf, _ = upload.pack_host_batch(cols, n, pool)
        pool.release(buf)

    def copy():
        buf, _ = upload.pack_host_batch(cols, n, pool)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf[:total].to(dev, non_blocking=True)
        torch.cuda.synchronize()
        pool.release(buf)
        return time.perf_counter() - t0

    def mean_ms(fn):
        fn()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sum(times) / 3 * 1e3

    total = upload.HEADER_BYTES + upload.layout_nbytes(
        [upload.column_layout(c) for c in cols])
    pack_ms = mean_ms(pack)
    copy()
    copy_s = sum(copy() for _ in range(3)) / 3
    return {"bytes": total, "build_ms": mean_ms(make_cols),
            "acquire_ms": mean_ms(acquire),
            "pack_gb_s": total / pack_ms / 1e6,
            "link_gb_s": total / copy_s / 1e9,
            "upload_ms": mean_ms(lambda: upload.to_device_batch(
                cols, n, schema, dev)),
            "per_buffer_ms": mean_ms(per_buffer)}


def pinned_alloc_ms(nbytes):
    """ms of a fresh pinned allocation of `nbytes` and of the same one
    again after it was freed (PyTorch's caching host allocator)."""
    import torch
    out = []
    for _ in range(2):
        t0 = time.perf_counter()
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        out.append((time.perf_counter() - t0) * 1e3)
        del buf
    return out


# -- slice 6: string keys ---------------------------------------------------

#: clause 2.4.1.3's validation DELTA = 90: l_shipdate <= 1998-12-01 - 90
Q1_SHIP_CUTOFF = datetime.date(1998, 9, 2)
Q1_LINE_FIELDS = (("l_quantity", "DOUBLE"), ("l_extendedprice", "DOUBLE"),
                  ("l_discount", "DOUBLE"), ("l_tax", "DOUBLE"),
                  ("l_shipdate", "DATE"), ("l_returnflag", "STRING"),
                  ("l_linestatus", "STRING"))
#: Q1's groups in its ORDER BY, and the route the aggregate must take
Q1_GROUPS = (("A", "F"), ("N", "F"), ("N", "O"), ("R", "F"))
P7_LINE_FIELDS = (("l_shipmode", "STRING"), ("l_extendedprice", "DOUBLE"))
P8_NAMES = 1 << 20       # distinct c_name keys of P8, one batch at capacity
P6_ITERS = 5             # timed runs of P6 and of each P7 build key
ROUTES = ("hash_rounds_2", "hash_rounds_6", "sort_fallback")


def tpch_q1_tree(m, line_scan, cutoff=None, n_parts=None):
    """TPC-H Q1 (clause 2.4.1) as Spark plans it above the lineitem scan,
    in the package whose modules `m` holds:

      Sort(l_returnflag, l_linestatus,
           Aggregate(group by l_returnflag, l_linestatus: sum(l_quantity),
                     sum(l_extendedprice), sum(price * (1 - discount)),
                     sum(price * (1 - discount) * (1 + tax)), avg(l_quantity),
                     avg(l_extendedprice), avg(l_discount), count(*),
                     Filter(l_shipdate <= cutoff, scan)))

    `cutoff` is the literal expression (default: a DATE literal of
    Q1_SHIP_CUTOFF). With `n_parts` the aggregate is split into partial
    -> hash exchange on both flags into n_parts partitions -> final
    (P10)."""
    col, lit, ax = m.core.col, m.core.lit, m.aggexprs
    cutoff = lit(Q1_SHIP_CUTOFF) if cutoff is None else cutoff
    lines = m.basic.FilterExec(
        m.pred.LessThanOrEqual(col("l_shipdate"), cutoff), line_scan)
    price, disc = col("l_extendedprice"), col("l_discount")
    disc_price = price * (lit(1.0) - disc)
    group = [col("l_returnflag"), col("l_linestatus")]
    aggs = [(ax.Sum(col("l_quantity")), "sum_qty"),
            (ax.Sum(price), "sum_base_price"),
            (ax.Sum(disc_price), "sum_disc_price"),
            (ax.Sum(disc_price * (lit(1.0) + col("l_tax"))), "sum_charge"),
            (ax.Average(col("l_quantity")), "avg_qty"),
            (ax.Average(price), "avg_price"),
            (ax.Average(disc), "avg_disc"),
            (ax.Count(), "count_order")]
    agg = m.agg.AggregateExec(group, aggs, lines) if n_parts is None \
        else shuffled_aggregate(m, group, aggs, lines, n_parts)
    return m.sort.SortExec([(col("l_returnflag"), True),
                            (col("l_linestatus"), True)], agg)


def tpch_q1_oracle(d, cutoff_days=None):
    """Q1 in numpy: one row per group in ORDER BY order."""
    cut = (Q1_SHIP_CUTOFF - datetime.date(1970, 1, 1)).days \
        if cutoff_days is None else cutoff_days
    keep = d["l_shipdate"] <= cut
    rf = np.asarray(d["l_returnflag"][1])[d["l_returnflag"][0]]
    ls = np.asarray(d["l_linestatus"][1])[d["l_linestatus"][0]]
    qty, price = d["l_quantity"], d["l_extendedprice"]
    disc, tax = d["l_discount"], d["l_tax"]
    rows = []
    for f, s in sorted(set(zip(rf[keep], ls[keep]))):
        g = keep & (rf == f) & (ls == s)
        n = int(g.sum())
        dp = price[g] * (1.0 - disc[g])
        rows.append((f, s, qty[g].sum(), price[g].sum(), dp.sum(),
                     (dp * (1.0 + tax[g])).sum(), qty[g].sum() / n,
                     price[g].sum() / n, disc[g].sum() / n, n))
    return rows


def check_rows(rows, oracle, label, exact=()):
    """Rows against the oracle's in order: the columns in `exact` and
    every str or int equal, floats to rtol 1e-9 (summation order)."""
    if len(rows) != len(oracle):
        raise AssertionError(f"{label}: {len(rows)} rows != oracle "
                             f"{len(oracle)}")
    for got, want in zip(rows, oracle):
        for i, (g, w) in enumerate(zip(got, want)):
            if isinstance(w, (str, int, np.integer)) or i in exact:
                ok = g == w
            else:
                ok = g is not None and abs(g - w) <= RTOL * abs(w)
            if not ok:
                raise AssertionError(f"{label}: row {got} != oracle {want}")


def tpch_q1_batch(d, dev):
    """Q1's lineitem batch on `dev`: the flags as DictionaryColumns."""
    m = port_modules()
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    schema = m.t.Schema(tuple(m.t.StructField(n, getattr(m.t, ty))
                              for n, ty in Q1_LINE_FIELDS))
    return ColumnarBatch(*q19_columns(d, schema, dev), schema)


def shipmode_table(seed=7):
    """P7's build side: clause 4.2.2.13's seven ship modes, each with a
    DOUBLE surcharge drawn from `seed`."""
    rng = np.random.default_rng(seed)
    return SHIPMODES, np.round(1.0 + rng.integers(1, 26, 7) / 100.0, 2)


def shipmode_join_tree(m, line_scan, mode_scan):
    """P7: the lineitems join the ship-mode table on the string key, then
    sum(l_extendedprice * surcharge) and count(*) by the build side's mode:

      Aggregate(group by sm_mode: sum(charge), count(*),
        Project(sm_mode, l_extendedprice * sm_surcharge as charge,
          HashJoin(lines, modes, l_shipmode = sm_mode, inner, build
                   right)))"""
    col = m.core.col
    joined = m.joins.HashJoinExec(line_scan, mode_scan, [col("l_shipmode")],
                                  [col("sm_mode")], "inner",
                                  build_side="right")
    proj = m.basic.ProjectExec(
        [col("sm_mode"),
         (col("l_extendedprice") * col("sm_surcharge")).alias("charge")],
        joined)
    return m.agg.AggregateExec(
        [col("sm_mode")], [(m.aggexprs.Sum(col("charge")), "surcharge"),
                           (m.aggexprs.Count(), "lines")], proj)


def shipmode_oracle(d, surcharge):
    """P7 in numpy: (mode, sum, count) for every mode, by mode."""
    codes, modes = d["l_shipmode"]
    price = d["l_extendedprice"]
    return [(modes[k], float((price[codes == k] * surcharge[k]).sum()),
             int((codes == k).sum())) for k in np.argsort(modes)]


def shipmode_batches(d, dev, encoded_build):
    """P7's (lineitem batch, ship-mode batch) on `dev`: the stream's
    l_shipmode dictionary-encoded; the build's mode a StringColumn, or
    with `encoded_build` a DictionaryColumn whose dictionary lists the
    modes in reverse order."""
    m = port_modules()
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import (Column, StringColumn,
                                                        string_buffers)
    from spark_rapids_tpu_torch.columnar.encoded import dictionary_from_numpy
    schema = m.t.Schema(tuple(m.t.StructField(n, getattr(m.t, ty))
                              for n, ty in P7_LINE_FIELDS))
    lines = ColumnarBatch(*q19_columns(d, schema, dev), schema)
    modes, surcharge = shipmode_table()
    if encoded_build:
        words = modes[::-1]
        mode_col = dictionary_from_numpy(
            np.array([words.index(x) for x in modes], np.int32),
            *string_buffers(words), device=dev)
    else:
        mode_col = StringColumn.from_pylist(list(modes), device=dev)
    mschema = m.t.Schema((m.t.StructField("sm_mode", m.t.STRING),
                          m.t.StructField("sm_surcharge", m.t.DOUBLE)))
    build = ColumnarBatch([mode_col, Column.from_numpy(
        surcharge, m.t.DOUBLE, device=dev)], len(modes), mschema)
    return lines, build


def customer_names(n, seed=8):
    """n distinct names in TPC-H's c_name form (clause 4.2.3,
    'Customer#%09d'), shuffled: a (n, 18) uint8 matrix."""
    keys = np.random.default_rng(seed).permutation(n) + 1
    mat = np.empty((n, 18), np.uint8)
    mat[:, :9] = np.frombuffer(b"Customer#", np.uint8)
    for i in range(9):
        mat[:, 17 - i] = ord("0") + (keys // 10 ** i) % 10
    return mat


def names_batch(mat, dev):
    """P8's batch: one StringColumn of the names at capacity rows."""
    m = port_modules()
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import StringColumn
    n, w = mat.shape
    col = StringColumn.from_numpy(mat.reshape(-1),
                                  np.arange(n + 1, dtype=np.int32) * w,
                                  device=dev)
    schema = m.t.Schema((m.t.StructField("c_name", m.t.STRING),))
    return ColumnarBatch([col], n, schema)


def names_count_tree(m, scan):
    """P8: count(*) grouped by c_name."""
    return m.agg.AggregateExec([m.core.col("c_name")],
                               [(m.aggexprs.Count(), "n")], scan)


def route_counts(agg):
    return {r: agg.metrics[r].value for r in ROUTES}


# numpy references of Spark's string hashes, on a padded (rows, width)
# uint8 matrix and the rows' lengths: written from Spark's
# Murmur3_x86_32.hashUnsafeBytes and XXH64.hashUnsafeBytes, independent
# of the port's torch code

def np_murmur3_bytes(mat, lengths, seed):
    """uint32 hashes, from one seed for every row."""
    c1, c2 = np.uint32(0xCC9E2D51), np.uint32(0x1B873593)

    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    def mix(h, k):
        k = rotl(k * c1, 15) * c2
        h = rotl(h ^ k, 13)
        return h * np.uint32(5) + np.uint32(0xE6546B64)

    n = mat.shape[0]
    rows = np.arange(n)
    m32 = mat.astype(np.uint32)
    lengths = np.asarray(lengths, np.int64)
    h = np.full(n, seed, np.uint32)
    nw = lengths // 4
    for t in range(int(nw.max(initial=0))):
        w = m32[:, 4 * t] | (m32[:, 4 * t + 1] << np.uint32(8)) \
            | (m32[:, 4 * t + 2] << np.uint32(16)) \
            | (m32[:, 4 * t + 3] << np.uint32(24))
        h = np.where(t < nw, mix(h, w), h)
    for j in range(3):
        pos = nw * 4 + j
        b = mat[rows, np.minimum(pos, mat.shape[1] - 1)].view(np.int8)
        h = np.where(pos < lengths, mix(h, b.astype(np.int32).view(
            np.uint32)), h)
    h = h ^ lengths.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def np_xxhash64_bytes(mat, lengths, seed):
    """uint64 hashes, from one seed for every row."""
    p1, p2 = np.uint64(0x9E3779B185EBCA87), np.uint64(0xC2B2AE3D27D4EB4F)
    p3, p4 = np.uint64(0x165667B19E3779F9), np.uint64(0x85EBCA77C2B2AE63)
    p5 = np.uint64(0x27D4EB2F165667C5)

    def rotl(x, r):
        return (x << np.uint64(r)) | (x >> np.uint64(64 - r))

    def rnd(acc, k):
        return rotl(acc + k * p2, 31) * p1

    n, width = mat.shape
    rows = np.arange(n)
    lengths = np.asarray(lengths, np.int64)
    m64 = np.zeros((n, width + 8), np.uint64)
    m64[:, :width] = mat

    def word(pos, nbytes):
        out = np.zeros(n, np.uint64)
        for j in range(nbytes):
            p = np.minimum(pos + j, width + 7)
            out |= m64[rows, p] << np.uint64(8 * j)
        return out

    s = np.full(n, seed, np.uint64)
    v = [s + p1 + p2, s + p2, s + 0, s - p1]
    stripes = lengths // 32
    for k in range(int(stripes.max(initial=0))):
        act = k < stripes
        for i in range(4):
            at = np.full(n, 32 * k + 8 * i, np.int64)
            v[i] = np.where(act, rnd(v[i], word(at, 8)), v[i])
    big = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)
    for i in range(4):
        big = (big ^ rnd(np.uint64(0), v[i])) * p1 + p4
    h = np.where(lengths >= 32, big, s + p5)
    h = h + lengths.astype(np.uint64)
    pos = stripes * 32
    while True:
        act = pos + 8 <= lengths
        if not act.any():
            break
        h = np.where(act, rotl(h ^ rnd(np.uint64(0), word(pos, 8)), 27)
                     * p1 + p4, h)
        pos = np.where(act, pos + 8, pos)
    act = pos + 4 <= lengths
    h = np.where(act, rotl(h ^ (word(pos, 4) * p1), 23) * p2 + p3, h)
    pos = np.where(act, pos + 4, pos)
    while True:
        act = pos < lengths
        if not act.any():
            break
        h = np.where(act, rotl(h ^ (word(pos, 1) * p5), 11) * p1, h)
        pos = np.where(act, pos + 1, pos)
    h ^= h >> np.uint64(33)
    h *= p2
    h ^= h >> np.uint64(29)
    h *= p3
    return h ^ (h >> np.uint64(32))


def hash_probe_strings(seed=9):
    """Strings of every length 0-70, of random bytes (many >= 0x80) and of
    multibyte UTF-8 text, as a padded matrix and lengths."""
    rng = np.random.default_rng(seed)
    rows = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
            for n in range(71) for _ in range(4)]
    rows += [("ü€𝄞" * k)[:k].encode() for k in range(30)]
    width = max(len(r) for r in rows)
    mat = np.zeros((len(rows), width), np.uint8)
    for i, r in enumerate(rows):
        mat[i, :len(r)] = np.frombuffer(r, np.uint8)
    return mat, np.array([len(r) for r in rows], np.int64)


def compare_string_hashes(mat, lengths, dev, label):
    """The card's xxhash64_batch and murmur3_string of the rows, seed 42,
    bit for bit against the numpy references."""
    import torch
    from spark_rapids_tpu_torch.columnar.column import StringColumn
    from spark_rapids_tpu_torch.ops import hashing
    n = len(lengths)
    offsets = np.zeros(n + 1, np.int32)
    offsets[1:] = np.cumsum(lengths)
    keep = np.arange(mat.shape[1])[None, :] < np.asarray(lengths)[:, None]
    col = StringColumn.from_numpy(mat[keep], offsets, capacity=n,
                                  device=dev)
    xx = hashing.xxhash64_batch([col], 42).cpu().numpy().view(np.uint64)
    m3 = hashing.murmur3_string(col, 42).cpu().numpy().view(np.uint32)
    torch.cuda.synchronize()
    want_xx = np_xxhash64_bytes(mat, lengths, 42)
    want_m3 = np_murmur3_bytes(mat, lengths, 42)
    bad = int((xx != want_xx).sum() + (m3 != want_m3).sum())
    if bad:
        raise AssertionError(f"{label}: {bad} string hashes differ from "
                             f"the numpy references")
    print(f"string hashes of {label} ({n} rows, up to {int(max(lengths))} "
          f"bytes): xxhash64_batch and murmur3_string equal to numpy's "
          f"bit for bit")


def scan_of(m, batch):
    return m.basic.InMemoryScanExec([batch], batch.schema)


def drive_string_paths(m, dev, q1t_batch, q1t_want, p7_batches, p7_want,
                       names):
    """Phase 3b's string-key paths, each counted with drive_batches and
    held to its numpy oracle: P6 (TPC-H Q1 over the dictionary-encoded
    flags, by the 2-round hash route), P7 (the ship-mode join on the
    string key, for each build key in `p7_batches`), P8 (count(*) by the
    distinct `names`), then the card's string hashes against numpy's.
    Returns P6's plan, and each path's launches and record."""
    from spark_rapids_tpu_torch.columnar import encoded
    p6 = tpch_q1_tree(m, scan_of(m, q1t_batch))
    before = encoded.counters()
    out, p6_counts, p6_reads = drive_batches("P6 TPC-H Q1", p6,
                                             ["dma_row_gather"])
    rows = [r for b in out for r in b.to_pylist()]
    check_rows(rows, q1t_want, "P6")
    if tuple(r[:2] for r in rows) != Q1_GROUPS:
        raise AssertionError(f"P6: groups {[r[:2] for r in rows]} != "
                             f"{Q1_GROUPS}")
    p6_rec = {"routes": route_counts(p6.child), "host_reads": p6_reads,
              "materializations": encoded.counters()["materializations"]
              - before["materializations"]}
    want_counts = {"dma_row_gather": 2, "dict_gather": 0,
                   "fused_probe_verify": 0, "murmur3_columns": 0}
    if p6_rec["routes"] != {"hash_rounds_2": 1, "hash_rounds_6": 0,
                            "sort_fallback": 0} \
            or any(p6_counts[k] != v for k, v in want_counts.items()):
        raise AssertionError(f"P6: routes {p6_rec['routes']}, launches "
                             f"{p6_counts} (one 2-round hash group-by; "
                             f"{want_counts})")
    print(f"P6 TPC-H Q1 ({q1t_batch.num_rows_host} lineitems): "
          f"{len(rows)} groups "
          f"{[r[:2] for r in rows]} equal to the numpy oracle; routes "
          f"{p6_rec['routes']}; {p6_rec['materializations']} boundary "
          f"decodes; host reads {p6_reads}; launches {p6_counts}")
    p7_counts, p7_rec = {}, {}
    for enc, (lines7, build7) in p7_batches.items():
        label = "P7 ship-mode join, build key " + (
            "a DictionaryColumn" if enc else "a StringColumn")
        plan7 = shipmode_join_tree(m, scan_of(m, lines7), scan_of(m, build7))
        before = encoded.counters()["dict_hash_tables"]
        out, counts, reads = drive_batches(
            label, plan7, ["dict_gather", "dma_row_gather"])
        tables = encoded.counters()["dict_hash_tables"] - before
        check_rows(sorted(r for b in out for r in b.to_pylist()), p7_want,
                   label)
        want_counts = {"dict_gather": 3 if enc else 1, "dma_row_gather": 2,
                       "fused_probe_verify": 0, "murmur3_columns": 0}
        if tables < 1 or any(counts[k] != v
                             for k, v in want_counts.items()):
            raise AssertionError(f"{label}: {tables} dictionary hash "
                                 f"tables, launches {counts} (want "
                                 f"{want_counts})")
        key = "dictionary_build" if enc else "string_build"
        p7_counts[key] = counts
        p7_rec[key] = {"routes": route_counts(plan7), "host_reads": reads,
                       "dict_hash_tables": tables}
        print(f"{label}: 7 groups equal to the numpy oracle; "
              f"{tables} dictionary hash tables; routes "
              f"{p7_rec[key]['routes']}; host reads {reads}; launches "
              f"{counts}")
    nb = names_batch(names, dev)
    p8 = names_count_tree(m, scan_of(m, nb))
    out, p8_counts, p8_reads = drive_batches("P8 count by c_name", p8, [])
    got = out[0]
    n8 = got.num_rows_host
    keys = got.columns[0]
    lens = (keys.offsets[1:n8 + 1] - keys.offsets[:n8]).cpu().numpy()
    key_bytes = keys.data[:n8 * names.shape[1]].cpu().numpy()
    cnt = got.columns[1].data[:n8].cpu().numpy()
    if len(out) != 1 or n8 != len(names) or (lens != names.shape[1]).any() \
            or (cnt != 1).any() or not np.array_equal(
                np.unique(key_bytes.reshape(n8, -1), axis=0),
                np.unique(names, axis=0)):
        raise AssertionError(f"P8: {n8} groups, counts {np.unique(cnt)}: "
                             f"not the {len(names)} names once each")
    p8_rec = {"routes": route_counts(p8), "host_reads": p8_reads,
              "groups": n8}
    print(f"P8 count(*) by {len(names)} distinct c_name keys in one batch: "
          f"{n8} groups, every count 1, the keys the input's; route "
          f"{p8_rec['routes']}; host reads {p8_reads}; launches "
          f"{p8_counts}")
    compare_string_hashes(names, np.full(len(names), names.shape[1]), dev,
                          "P8's c_name keys")
    compare_string_hashes(*hash_probe_strings(), dev,
                          "random bytes of 0-70 and UTF-8 text")
    return p6, p6_counts, p6_rec, p7_counts, p7_rec, p8_counts, p8_rec


# -- slice 7: the host shuffle and the partial/final aggregate --------------

#: partitions of P9-P11's exchanges: Spark's spark.sql.shuffle.partitions
#: is 200, cut to 16 for the run's time limit
P_PARTS = 16
P9_BATCHES = 16          # q1's rows as 16 batches of 1,048,576
P11_LINE_BATCHES = 16    # q3's lineitems as 16 batches of 131,072 (P2's)
P11_ORDER_BATCHES = 4    # q3's orders as 4 batches of 131,072 (P4's)
P_SHUFFLE_ITERS = 3      # timed runs of P9, P10 and P11 each
#: the exchange metrics P9-P11 record, per exchange
EXCHANGE_METRICS = (
    "numInputBatches", "numMapsWithRows", "numReorderGathers",
    "numFramesWritten", "numFramesRead", "numUploads", "shuffleRawBytes",
    "dataSize", "shuffleWriteTime", "shufflePackTimeNs",
    "shuffleFetchTimeNs", "shuffleFetchBytes", "shuffleSerializeTimeNs",
    "shuffleCompressTimeNs", "shuffleIoTimeNs", "shuffleReadTime",
    "uploadPackTimeNs", "pipelineWaitNs")


def shuffle_of(m, keys, child, n_parts, partitioning="hash"):
    """A HostShuffleExchangeExec in the package `m` holds, with its
    `exchange_kw` (the tests give the JAX package's its conf there)."""
    return m.exchange.HostShuffleExchangeExec(
        keys, child, n_parts, partitioning=partitioning,
        **getattr(m, "exchange_kw", {}))


def shuffled_aggregate(m, group, aggs, child, n_parts, exact=False):
    """partial -> hash exchange on the partial's keys into n_parts
    partitions -> final, as the JAX package's planner builds it
    (`_convert_host_shuffled_aggregate`); a grand aggregate goes through
    one single partition. `exact` pins both stages to the exact tier."""
    partial = m.agg.AggregateExec(group, aggs, child, mode="partial")
    keys = [m.core.col(n) for n in partial.output_schema.names[:len(group)]]
    exchange = shuffle_of(m, keys, partial, n_parts) if group \
        else shuffle_of(m, [], partial, 1, "single")
    final = m.agg.AggregateExec(group, aggs, exchange, mode="final",
                                input_types=partial._input_types)
    if exact:
        partial._spec_enabled = final._spec_enabled = False
    return final


def q1_tree(m, scan, n_parts):
    """bench.py's q1 plan (filter -> project -> aggregate) with the
    aggregate split over the host shuffle (P9): the partial absorbs the
    filter and project into the fused scan-aggregate kernel."""
    col, lit, b, ax = m.core.col, m.core.lit, m.basic, m.aggexprs
    filt = b.FilterExec(col("quantity") <= lit(45), scan)
    proj = b.ProjectExec([
        col("returnflag"), col("quantity"),
        (col("extendedprice") * (lit(1.0) - col("discount")))
        .alias("disc_price")], filt)
    return shuffled_aggregate(
        m, [col("returnflag")], [(ax.Sum(col("quantity")), "sum_qty"),
                                 (ax.Sum(col("disc_price")), "sum_disc"),
                                 (ax.Count(), "cnt")], proj, n_parts)


def check_q1(rows, oracle, label):
    """q1's groups against bench.numpy_oracle: counts and integer sums
    exact, the f64 sum to rtol 1e-9."""
    if sorted(r[0] for r in rows) != sorted(oracle):
        raise AssertionError(f"{label}: groups {rows} != oracle {oracle}")
    for k, qty, dp, cnt in rows:
        oq, odp, oc = oracle[k]
        if qty != oq or cnt != oc or abs(dp - odp) > RTOL * abs(odp):
            raise AssertionError(f"{label}: group {k}: {(qty, dp, cnt)} "
                                 f"!= oracle {oracle[k]}")


def exchanges_of(plan):
    """The plan's HostShuffleExchangeExecs, in tree order."""
    from spark_rapids_tpu_torch.exec.exchange import HostShuffleExchangeExec
    out, todo = [], [plan]
    while todo:
        node = todo.pop(0)
        if isinstance(node, HostShuffleExchangeExec):
            out.append(node)
        todo.extend(node.children)
    return out


def exchange_snapshot(plan):
    """Every exchange's EXCHANGE_METRICS, in tree order."""
    return [{k: ex.metrics[k].value for k in EXCHANGE_METRICS}
            for ex in exchanges_of(plan)]


def shuffle_root_empty(label):
    """No shuffle registered and no file under the shuffle root."""
    import os
    from spark_rapids_tpu_torch.shuffle.manager import shuffle_manager
    mgr = shuffle_manager()
    left = os.listdir(mgr.root_dir())
    if left or mgr.registered():
        raise AssertionError(f"{label}: {mgr.registered()} shuffles "
                             f"registered, files left {left}")


def drive_shuffled(label, plan, need, expect):
    """collect()'s run of `plan` (its speculation scope, its to_pylist
    fetch) with every launch counter set to 0 just before and read just
    after, failing where collect() would re-run it (a tripped flag).
    `expect(counts, exchanges, plan)` returns the launches the plan
    implies for each kernel it names; every count must equal it. Then
    each exchange's frames and uploads (one a frame read, all written
    frames read), the shuffle root (empty) and the catalog and permits
    (idle). Returns (rows, counts, per-exchange metrics, ms, the run's
    upload, fetch and staging-pool counters)."""
    import torch
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    wrappers = kernel_wrappers()
    before = exchange_snapshot(plan)
    io_before = io_counters()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    with speculation_scope() as scope:
        rows = [r for b in plan._execute(encoded_out=True)
                for r in b.to_pylist()]
        tripped = scope.tripped()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {name: w.launches for name, w in wrappers.items()}
    io = {k: v - io_before[k] for k, v in io_counters().items()}
    if tripped:
        raise AssertionError(f"{label}: speculation flag tripped")
    idle = [k for k in need if counts[k] < 1]
    if idle:
        raise AssertionError(f"{label}: kernels not launched: {idle} "
                             f"(counts {counts})")
    exs = [{k: v - b[k] for k, v in a.items()}
           for a, b in zip(exchange_snapshot(plan), before)]
    on_card = plan.device is not None and plan.device.type == "cuda"
    for i, e in enumerate(exs):
        # one upload a frame read on a card; on the CPU the read seam
        # passes the host batch through
        uploads = e["numFramesRead"] if on_card else 0
        if e["numFramesRead"] != e["numFramesWritten"] \
                or e["numUploads"] != uploads:
            raise AssertionError(f"{label}: exchange {i}: "
                                 f"{e['numFramesWritten']} frames written, "
                                 f"{e['numFramesRead']} read, "
                                 f"{e['numUploads']} uploads")
        if e["numReorderGathers"] != e["numMapsWithRows"]:
            raise AssertionError(f"{label}: exchange {i}: "
                                 f"{e['numReorderGathers']} reorder gathers "
                                 f"for {e['numMapsWithRows']} map batches "
                                 f"with rows")
    want = expect(counts, exs, plan)
    wrong = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if wrong:
        raise AssertionError(f"{label}: launches (counted, implied) "
                             f"{wrong}; all {counts}")
    shuffle_root_empty(label)
    check_idle(label)
    return rows, counts, exs, ms, io


def expect_p9(counts, exs, plan):
    """P9: fused_scan_agg once a source batch; one murmur3 launch and one
    row gather a map batch with rows (the partial's one state batch)."""
    maps = sum(e["numMapsWithRows"] for e in exs)
    return {"fused_scan_agg": P9_BATCHES, "murmur3_columns": maps,
            "dma_row_gather": maps, "fused_probe_verify": 0,
            "dict_gather": 0, "murmur3_long_lanes": 0,
            "murmur3_int_lanes": 0}


def expect_p10(counts, exs, plan):
    """P10: string keys hash in plain torch (no murmur3 launch); row
    gathers: the filter's compaction, one reorder a map batch with rows,
    the final sort."""
    maps = sum(e["numMapsWithRows"] for e in exs)
    return {"fused_scan_agg": 0, "murmur3_columns": 0, "dma_row_gather":
            1 + maps + 1, "fused_probe_verify": 0, "dict_gather": 0,
            "murmur3_long_lanes": 0, "murmur3_int_lanes": 0}


def p11_join(plan):
    """The ShuffledHashJoinExec of a q3_tree(n_parts=...) plan."""
    from spark_rapids_tpu_torch.exec.exchange import ShuffledHashJoinExec
    node = plan
    while not isinstance(node, ShuffledHashJoinExec):
        node = node.children[0]
    return node


def expect_p11(counts, exs, plan):
    """P11: murmur3 once a map batch with rows on each of the three
    exchanges, and in the join once a partition pair (the build keys,
    both seeds) and once a stream batch; the probe once a stream batch of
    a pair with rows on both sides. The row gathers the plan implies at
    least: each filter's compaction a batch, one reorder a map batch with
    rows, the join's build permute a pair and its two payload gathers a
    stream batch, the TopN's sort; the aggregates' sort-path group-bys
    add the rest (data-dependent: how many of their updates and merges
    leave rows over), which `p11_row_gathers` reports."""
    j = p11_join(plan)
    pairs = j.metrics["numPartitionPairs"].value - j._pairs_before
    stream = j.metrics["numStreamBatches"].value - j._stream_before
    maps = sum(e["numMapsWithRows"] for e in exs)
    floor = P11_LINE_BATCHES + P11_ORDER_BATCHES + maps + pairs \
        + 2 * stream + 1
    if counts["dma_row_gather"] < floor:
        raise AssertionError(f"P11: {counts['dma_row_gather']} row gathers, "
                             f"fewer than the {floor} the plan implies")
    plan._p11_row_gathers = {
        "filter_compactions": P11_LINE_BATCHES + P11_ORDER_BATCHES,
        "reorders": maps, "join_build_permutes": pairs,
        "join_payloads": 2 * stream, "topn_sort": 1,
        "aggregate_sort_paths": counts["dma_row_gather"] - floor}
    plan._p11_pairs = (pairs, stream)
    return {"fused_scan_agg": 0, "murmur3_columns": maps + pairs + stream,
            "fused_probe_verify": stream, "dict_gather": 0,
            "murmur3_long_lanes": 0, "murmur3_int_lanes": 0}


def p11_plan(d, dev, key_type):
    """q3 shuffled (P11) over 16 lineitem and 4 order batches on `dev`."""
    m = port_modules()
    o_schema, l_schema = q3_schemas(key_type)
    plan = q3_tree(m, m.basic.InMemoryScanExec(
        q3_batches(d, dev, o_schema, Q3_ORDERS, P11_ORDER_BATCHES), o_schema),
        m.basic.InMemoryScanExec(
            q3_batches(d, dev, l_schema, Q3_LINES, P11_LINE_BATCHES),
            l_schema), n_parts=P_PARTS)
    return plan


def drive_p11(label, plan, want):
    j = p11_join(plan)
    j._pairs_before = j.metrics["numPartitionPairs"].value
    j._stream_before = j.metrics["numStreamBatches"].value
    out = drive_shuffled(label, plan, ["murmur3_columns",
                                       "fused_probe_verify",
                                       "dma_row_gather"], expect_p11)
    check_q3(out[0], want, label)
    return out


def describe_exchanges(exs):
    return "; ".join(
        f"exchange {i}: {e['numMapsWithRows']} of {e['numInputBatches']} "
        f"map batches with rows, {e['numFramesWritten']} frames "
        f"({e['shuffleRawBytes']} raw bytes, {e['dataSize']} stored), "
        f"{e['numUploads']} uploads" for i, e in enumerate(exs))


def drive_shuffle_paths(dev, q1_batches, q1_want, q1t_batch, q1t_want, d3,
                        d3i, q3_want):
    """Phase 3b's shuffle paths, each counted with drive_shuffled and held
    to its oracle: P9 (bench q1 over 16 batches, partial -> exchange ->
    final), P10 (TPC-H Q1 at SF1, the string route split the same way,
    then the sort), P11 (q3 shuffled, LONG and INT order keys). Returns
    {path: (plan, launches, record)}."""
    m = port_modules()
    out = {}
    p9 = q1_tree(m, m.basic.InMemoryScanExec(q1_batches,
                                             q1_batches[0].schema), P_PARTS)
    if p9.child.child._scan_agg_spec is None:
        raise AssertionError("P9: the partial did not compile to a spec")
    rows, counts, exs, ms, io = drive_shuffled(
        "P9 q1 shuffled", p9, ["fused_scan_agg"], expect_p9)
    check_q1(rows, q1_want, "P9")
    out["P9"] = (p9, counts, {"first_run_ms": ms, "exchanges": exs,
                              "io": io})
    print(f"P9 q1 shuffled ({P9_BATCHES} batches of "
          f"{q1_batches[0].num_rows_host} rows, {P_PARTS} partitions): "
          f"{len(rows)} groups equal to the numpy oracle in {ms:.1f} ms "
          f"(first run); {describe_exchanges(exs)}; io {io}; launches "
          f"{counts}; shuffle root empty, catalog empty, no permit held")
    p10 = tpch_q1_tree(m, scan_of(m, q1t_batch), n_parts=P_PARTS)
    rows, counts, exs, ms, io = drive_shuffled(
        "P10 TPC-H Q1 shuffled", p10, ["dma_row_gather"], expect_p10)
    check_rows(rows, q1t_want, "P10")
    if tuple(r[:2] for r in rows) != Q1_GROUPS:
        raise AssertionError(f"P10: groups {[r[:2] for r in rows]} != "
                             f"{Q1_GROUPS}")
    final = p10.child
    partial = final.child.child
    routes = {"partial": route_counts(partial), "final": route_counts(final)}
    out["P10"] = (p10, counts, {"first_run_ms": ms, "exchanges": exs,
                                "routes": routes, "io": io})
    print(f"P10 TPC-H Q1 shuffled ({q1t_batch.num_rows_host} lineitems, "
          f"{P_PARTS} partitions): {len(rows)} groups "
          f"{[r[:2] for r in rows]} equal to the numpy oracle in "
          f"{ms:.1f} ms (first run); routes {routes}; "
          f"{describe_exchanges(exs)}; io {io}; launches {counts}")
    for key, data in (("LONG", d3), ("INT", d3i)):
        label = f"P11 q3 shuffled, {key} keys"
        plan = p11_plan(data, dev, key)
        rows, counts, exs, ms, io = drive_p11(label, plan, q3_want)
        pairs, stream = plan._p11_pairs
        rec = {"first_run_ms": ms, "exchanges": exs, "io": io,
               "pairs": pairs,
               "stream_batches": stream,
               "row_gathers": plan._p11_row_gathers}
        out["P11" if key == "LONG" else "P11_INT"] = (plan, counts, rec)
        print(f"{label} ({Q3_LINES} x {Q3_ORDERS}, {P11_LINE_BATCHES} + "
              f"{P11_ORDER_BATCHES} batches, {P_PARTS} partitions): top 10 "
              f"equal to the numpy oracle in {ms:.1f} ms (first run); "
              f"{pairs} partition pairs joined, {stream} stream batches "
              f"probed; row gathers {plan._p11_row_gathers}; "
              f"{describe_exchanges(exs)}; io {io}; launches {counts}")
    return out


def time_shuffle_paths(paths, q1_want, q1t_want, q3_want):
    """P9-P11 in steady state: P_SHUFFLE_ITERS runs each, one
    synchronisation a run, each checked against its oracle; the
    exchanges' phase times per run from their metrics (ms: write, split,
    the split's fetch, serialize (the writer pool's wall) and LZ4 (summed
    over its threads), file IO, read wait, the read seam's upload pack)
    and the fetch's GB/s."""
    import torch
    checks = {"P9": lambda r: check_q1(r, q1_want, "P9 timed"),
              "P10": lambda r: check_rows(r, q1t_want, "P10 timed"),
              "P11": lambda r: check_q3(r, q3_want, "P11 timed")}
    recs = {}
    for name, check in checks.items():
        plan = paths[name][0]
        before = exchange_snapshot(plan)
        join = p11_join(plan)._join if name == "P11" else None
        join_before = join and (join.metrics["buildTime"].value,
                                join.metrics["joinTime"].value)
        runs = []
        for _ in range(P_SHUFFLE_ITERS):
            t0 = time.perf_counter()
            rows = plan.collect()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
            check(rows)
        shuffle_root_empty(f"{name} timed")
        check_idle(f"{name} timed")
        phases = []
        for a, b in zip(exchange_snapshot(plan), before):
            e = {k: (v - b[k]) / P_SHUFFLE_ITERS for k, v in a.items()}
            ph = {k: e[m_] / 1e6 for k, m_ in (
                ("write_ms", "shuffleWriteTime"),
                ("split_ms", "shufflePackTimeNs"),
                ("fetch_ms", "shuffleFetchTimeNs"),
                ("serialize_ms", "shuffleSerializeTimeNs"),
                ("lz4_thread_ms", "shuffleCompressTimeNs"),
                ("io_ms", "shuffleIoTimeNs"),
                ("read_wait_ms", "shuffleReadTime"),
                ("upload_pack_ms", "uploadPackTimeNs"))}
            ph["fetch_gb_s"] = e["shuffleFetchBytes"] / max(
                e["shuffleFetchTimeNs"], 1)
            ph["frames"] = e["numFramesWritten"]
            ph["raw_bytes"] = e["shuffleRawBytes"]
            ph["stored_bytes"] = e["dataSize"]
            phases.append(ph)
        recs[name] = {"ms": runs, "exchanges": phases}
        if join is not None:
            # the inner join's own host clock per run: its builds and its
            # probes (the rest is the exchanges and the aggregates)
            recs[name]["join_build_ms"], recs[name]["join_probe_ms"] = (
                (join.metrics[k].value - b) / P_SHUFFLE_ITERS / 1e6
                for k, b in zip(("buildTime", "joinTime"), join_before))
        print(f"{name} steady state: ms per run {runs} "
              f"({P_SHUFFLE_ITERS} runs, one sync each)"
              + (f", the join's builds {recs[name]['join_build_ms']:.1f} ms "
                 f"and probes {recs[name]['join_probe_ms']:.1f} ms a run"
                 if join is not None else "")
              + "; per run, by exchange: " + "; ".join(
                  ", ".join(f"{k} {v:.3f}" for k, v in ph.items())
                  for ph in phases))
    return recs


def split_fetch_rates(dev, d3, reps=5):
    """The split's one device->host copy on a q3 lineitem map batch
    (131,072 rows): fetch_split_host whole (the pack and the copy into
    pageable memory) and the copy alone, GB/s over the packed bytes."""
    import torch
    from spark_rapids_tpu_torch.columnar import transfer
    m = port_modules()
    _, l_schema = q3_schemas("LONG")
    b = q3_batches(d3, dev, l_schema, Q3_LINES, P11_LINE_BATCHES)[0]
    ex = shuffle_of(m, [m.core.col("l_orderkey")],
                    m.basic.InMemoryScanExec([b], l_schema), P_PARTS)
    counts, cols = ex._split_kernel(b, 0)
    buf = transfer.pack_split(counts, cols)
    nbytes = buf.shape[0]
    out = {"bytes": nbytes}
    for key, fn in (("fetch_split_host", lambda: transfer.fetch_split_host(
            counts, cols)), ("copy", lambda: buf.cpu())):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        out[key] = {"ms": ms, "gb_s": nbytes / ms / 1e6}
    print(f"the split's fetch of a {Q3_LINES // P11_LINE_BATCHES}-row q3 "
          f"lineitem map batch ({nbytes} bytes): fetch_split_host "
          f"{out['fetch_split_host']['ms']:.3f} ms "
          f"({out['fetch_split_host']['gb_s']:.2f} GB/s), the copy alone "
          f"{out['copy']['ms']:.3f} ms ({out['copy']['gb_s']:.2f} GB/s)")
    return out


def compare_pid_hash(dev, d3, d3i):
    """The murmur3 chain against its plain version at the exchange's pid
    shape: one q3 lineitem map batch's order key, seed 42, LONG and INT.
    Returns {key type: [the key column]}."""
    from spark_rapids_tpu_torch.ops import murmur3_lanes as m3
    from spark_rapids_tpu_torch.parallel.exchange import SHUFFLE_SEED
    out = {}
    for key, data in (("LONG", d3), ("INT", d3i)):
        _, l_schema = q3_schemas(key)
        b = q3_batches(data, dev, l_schema, Q3_LINES, P11_LINE_BATCHES)[0]
        cols = out[key] = [b.columns[0]]
        _exact(f"murmur3 pid {key}", m3.murmur3_columns(cols, [SHUFFLE_SEED]),
               m3.murmur3_columns_plain(cols, [SHUFFLE_SEED]))
        print(f"compare murmur3_columns at the pid shape ({b.capacity} "
              f"{key} keys, seed {SHUFFLE_SEED}): exact")
    return out


def time_pid_hash(pid_cols):
    """The murmur3 chain at the exchange's pid shape
    (`compare_pid_hash`'s columns), L2 cold, beside the plain version and
    the bound."""
    from spark_rapids_tpu_torch.ops import murmur3_lanes as m3
    from spark_rapids_tpu_torch.parallel.exchange import SHUFFLE_SEED
    out = {}
    for key, cols in pid_cols.items():
        n, w = cols[0].capacity, cols[0].data.element_size()
        ms = device_ms(lambda: m3.murmur3_columns(cols, [SHUFFLE_SEED]),
                       KERNEL_REPS)
        plain_ms = device_ms(
            lambda: m3.murmur3_columns_plain(cols, [SHUFFLE_SEED]),
            max(3, KERNEL_REPS // 4))
        b_ms, b_by = bound(n * (w + 1 + 4), n * m3_ops(w, 1))
        out[key] = {"rows": n, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by}
        print(f"murmur3_columns at the pid shape ({n} {key} keys, seed "
              f"{SHUFFLE_SEED}): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of the bound")
    return out


def shuffled_join_inputs(j):
    """JoinInputs of a ShuffledHashJoinExec built on the right, at its
    first partition pair with rows on both sides (its first stream
    batch); the exchanges' files go when their outer streams close."""
    j.stamp_inputs()
    lit_ = j.children[0].execute_partitions()
    rit = j.children[1].execute_partitions()
    try:
        for lp, rp in zip(lit_, rit):
            build = [b for b in rp if b.num_rows_host]
            stream = [b for b in lp if b.num_rows_host]
            if build and stream:
                break
        j._rscan.set_batches(build)
        j._lscan.set_batches(stream[:1])
        return JoinInputs(j._join)
    finally:
        lit_.close()
        rit.close()


def reorder_gathers(captured):
    """The exchange reorders among captured row gathers, one per distinct
    shape: {path: [calls]}."""
    out = {}
    for path, calls in captured.items():
        seen = {}
        for call in calls:
            site, plan, imat, fmat, idx = call
            if site != "exchange reorder":
                continue
            lb = 2 * fmat.shape[1] if fmat is not None else 0
            seen.setdefault((idx.shape[0], imat.shape[0], imat.shape[1], lb),
                            call)
        out[path] = list(seen.values())
    return out


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


#: every key type the murmur3 kernel hashes
M3_TYPES = ("BOOLEAN", "BYTE", "SHORT", "INT", "DATE", "LONG", "TIMESTAMP",
            "FLOAT", "DOUBLE")


def _m3_values(rng, n, type_name):
    """Keys of a type: integers with their edges and negatives, floats with
    NaNs of several payloads and signs, -0.0, 0.0 and infinities."""
    from spark_rapids_tpu_torch import types as t
    dt = getattr(t, type_name)
    if type_name == "BOOLEAN":
        return rng.integers(0, 2, n).astype(np.bool_)
    if type_name in ("FLOAT", "DOUBLE"):
        v = rng.normal(0, 1e6, n)
        v[::7], v[::11], v[::13] = np.nan, -0.0, 0.0
        v[::17], v[::19] = np.inf, -np.inf
        v = v.astype(dt.np_dtype)
        bits = v.view(np.uint64 if type_name == "DOUBLE" else np.uint32)
        bits[3::23] = (0xFFF0000000000001 if type_name == "DOUBLE"
                       else 0xFFC00001)
        return v
    return _random_ints(rng, n, dt.np_dtype)


def _m3_column(rng, dev, n, type_name, view):
    """A key column of n rows with ~20% nulls; as x[1:] views of its data
    and validity when `view`."""
    import torch
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.columnar.column import Column
    m = n + int(view)
    data = torch.from_numpy(_m3_values(rng, m, type_name)).to(dev)
    valid = torch.from_numpy(rng.random(m) > 0.2).to(dev)
    if view:
        data, valid = data[1:], valid[1:]
    return Column(data, valid, getattr(t, type_name))


def compare_murmur3(dev):
    """The murmur3 kernel against its plain version, exactly: the chain
    over every key type with nulls, aligned and as x[1:] views, at row
    counts ragged around a thread's rows (4) and a block's (1,024), at 0
    rows, over 1 to 4 columns in one launch and 5 and 9 in two and three,
    with one seed, two, and per-row seed planes; and the per-row-seed
    lanes (the TPU kernels' interface) on views and ragged sizes."""
    import torch
    from spark_rapids_tpu_torch.ops import hashing, murmur3_lanes as m3
    sizes = (0, 1, 3, 4, 5, 7, 9, 1023, 1024, 1025, 2049, 65537,
             (1 << 20) + 3)
    cases = 0
    for n in sizes:
        rng = np.random.default_rng(n)
        for ncols in (1, 2, 3, 4, 5, 9):
            names = [M3_TYPES[(i * 5 + n) % len(M3_TYPES)]
                     for i in range(ncols)]
            for view in (False, True):
                cols = [_m3_column(rng, dev, n, name, view and i % 2 == 0)
                        for i, name in enumerate(names)]
                plane = torch.from_numpy(_u32_seeds(rng, n + 1)).to(dev)
                for seeds in ([42], [0x5370_6172, 0x85EB_CA6B], [plane[:n]],
                              [plane[1:], -5]):
                    before = m3.murmur3_columns.launches
                    got = m3.murmur3_columns(cols, seeds)
                    launches = m3.murmur3_columns.launches - before
                    if launches != (-(-ncols // m3.MAX_COLS) if n else 0):
                        raise AssertionError(
                            f"murmur3_columns n={n} {ncols} columns: "
                            f"{launches} launches")
                    _exact(f"murmur3_columns n={n} {names} view={view} "
                           f"{len(seeds)} seeds", got,
                           m3.murmur3_columns_plain(cols, seeds))
                    cases += 1
    # each kind alone, both seeds, aligned and as views, past two blocks
    for name in M3_TYPES:
        for view in (False, True):
            rng = np.random.default_rng(len(name))
            c = _m3_column(rng, dev, 2049, name, view)
            _exact(f"murmur3_columns {name} view={view}",
                   m3.murmur3_columns([c], [42, 7]),
                   m3.murmur3_columns_plain([c], [42, 7]))
            col_seed = torch.from_numpy(_u32_seeds(rng, 2049)).to(dev)
            _exact(f"murmur3_column {name} view={view}",
                   [hashing.murmur3_column(c, col_seed)],
                   [hashing.murmur3_column_plain(c, col_seed)])
            cases += 2
    for n in (1, 9, 1000, 65537, (1 << 20) + 3):
        rng = np.random.default_rng(n)
        seeds = torch.from_numpy(_u32_seeds(rng, n + 1)).to(dev)
        v64 = torch.from_numpy(_random_ints(rng, n + 1, np.int64)).to(dev)
        v32 = torch.from_numpy(_random_ints(rng, n + 1, np.int32)).to(dev)
        for a, b in ((slice(0, n), slice(0, n)), (slice(1, None),
                                                  slice(1, None)),
                     (slice(1, None), slice(0, n))):
            _exact(f"murmur3_long n={n}",
                   [m3.murmur3_long_lanes(v64[a], seeds[b])],
                   [hashing.murmur3_long_plain(v64[a], seeds[b])])
            _exact(f"murmur3_int n={n}",
                   [m3.murmur3_int_lanes(v32[a], seeds[b])],
                   [hashing.murmur3_int_plain(v32[a], seeds[b])])
            cases += 2
    print(f"compare murmur3: {cases} cases (the chain over the 9 key types "
          f"with nulls, aligned and x[1:] views, {len(sizes)} row counts "
          f"from 0 to {sizes[-1]}, 1 to 9 columns in up to 3 launches, one "
          f"seed, two and per-row seed planes; the long and int lanes), "
          f"exact")


def _probe_case(rng, dev, n_stream, build_cap, n_lanes, dom, max_count,
                cand_cap, long_rows=0, empty_tiles=False, zero=False):
    """Random probe inputs: build lanes from a small domain (duplicate
    keys), ranges of 0..max_count candidates (empty ones included) over
    rows holding other keys too, ~5% invalid keys on both sides;
    optionally `long_rows` ranges longer than a tile of the kernel, every
    third tile wholly empty, or no candidate at all. A `cand_cap` of None
    is the candidate total."""
    import torch
    from spark_rapids_tpu_torch.ops.probe_verify import TILE
    counts = rng.integers(0, max_count + 1, n_stream).astype(np.int32)
    counts[rng.random(n_stream) < 0.3] = 0
    if long_rows:
        counts[rng.integers(0, n_stream, long_rows)] = 3 * TILE + 7
    if empty_tiles:
        for t in range(0, n_stream, 3 * TILE):
            counts[t: t + TILE] = 0
    if zero:
        counts[:] = 0
    lo = rng.integers(0, build_cap - max_count, n_stream).astype(np.int32)
    bk = rng.integers(0, dom, (build_cap, n_lanes)).astype(np.int32)
    sk = rng.integers(0, dom, (n_stream, n_lanes)).astype(np.int32)
    perm = rng.permutation(build_cap).astype(np.int32)
    args = [torch.from_numpy(x).to(dev) for x in (lo, counts, bk)] + [
        torch.from_numpy(rng.random(build_cap) > 0.05).to(dev),
        torch.from_numpy(sk).to(dev),
        torch.from_numpy(rng.random(n_stream) > 0.05).to(dev),
        torch.from_numpy(perm).to(dev)]
    total = int(counts.astype(np.int64).sum())
    return args, total if cand_cap is None else cand_cap, total


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
    """The probe on random inputs: duplicate keys, one, two and three key
    lanes, a bucket below the total, ranges longer than a tile, wholly
    empty tiles, a total of 0, a total equal to the bucket, stream rows
    that are not a multiple of the tile, and over 1,000 tiles so that the
    look-back crosses many blocks; then the kernels' scratch must be
    zero again."""
    import torch
    from spark_rapids_tpu_torch.ops import probe_verify as pv
    rng = np.random.default_rng(21)
    cases = [
        ("probe dup keys L=2", (300_000, 1 << 16, 2, 50, 6, 1 << 20), {}),
        ("probe L=1 cap<total", (100_003, 1 << 12, 1, 9, 9, 1 << 17), {}),
        ("probe sparse", (65_537, 1 << 20, 2, 1 << 30, 2, 1 << 16), {}),
        ("probe L=3", (50_001, 1 << 12, 3, 4, 3, 1 << 17), {}),
        ("probe ranges longer than a tile",
         (300_000, 1 << 16, 2, 50, 3, 1 << 20), {"long_rows": 40}),
        ("probe empty tiles", (100_003, 1 << 14, 2, 50, 3, 1 << 18),
         {"empty_tiles": True}),
        ("probe total 0", (70_001, 1 << 12, 2, 50, 3, 1 << 12),
         {"zero": True}),
        ("probe total = bucket", (123_457, 1 << 14, 2, 50, 4, None), {}),
        ("probe 1,026 tiles L=1", (4_200_001, 1 << 18, 1, 1 << 16, 3,
                                   1 << 23), {}),
    ]
    for label, shape, opts in cases:
        args, cap, total = _probe_case(rng, dev, *shape, **opts)
        hits = compare_probe(label, args, cap, total)
        print(f"compare {label}: {args[1].shape[0]} stream rows "
              f"({pv.tile_count(args[1].shape[0])} tiles), total={total} "
              f"cand_cap={cap} verified={hits}, exact")
    torch.cuda.synchronize()
    if any(bool(b.any()) for b in pv._scratch.values()):
        raise AssertionError("probe: the kernel left its scratch non-zero")


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


def _width_case(rng, dev, la, lb, cap, n_out, out_of_range=False):
    """An int32 (cap, la) matrix of random bits and, when lb, an f64 (cap,
    lb / 2) matrix of random bits (NaN payloads among them), with indices
    in range but for -1, cap + 5 and INT32_MIN among them, or all out of
    range."""
    import torch
    from types import SimpleNamespace
    imat = torch.from_numpy(_random_ints(rng, cap * la, np.int32)
                            .reshape(cap, la)).to(dev)
    fmat = torch.from_numpy(_random_ints(rng, cap * lb // 2, np.int64)
                            .reshape(cap, lb // 2)).to(dev).view(
                                torch.float64) if lb else None
    idx = rng.integers(0, cap, n_out).astype(np.int32)
    idx[::9] = -1
    idx[::13] = cap + 5
    idx[::17] = np.iinfo(np.int32).min
    if out_of_range:
        idx = np.where(idx % 2 == 0, -1, cap + idx % 7).astype(np.int32)
    return (SimpleNamespace(n_valid_lanes=1), imat, fmat,
            torch.from_numpy(idx).to(dev))


def compare_gather(dev):
    """The packed row gather against the plain version, exact bits: every
    (la, lb) that the main paths pack and widths that take the generic
    kernel, lb = 0, all indices out of range, slot counts that are not a
    multiple of the rows a thread takes, a matrix off its 16-byte
    alignment, and the packed columns of five types."""
    import torch
    from spark_rapids_tpu_torch.ops import row_gather as rg
    from spark_rapids_tpu_torch.ops.rowpack import gather_rows
    rng = np.random.default_rng(31)
    kinds = {}

    def check(label, plan, imat, fmat, idx):
        gi, gf = rg.pallas_gather_rows(plan, imat, fmat, idx)
        wi, wf = gather_rows(plan, imat, fmat, idx)
        _exact(label, [gi] + ([gf.view(torch.int64)] if gf is not None
                              else []),
               [wi] + ([wf.view(torch.int64)] if wf is not None else []))
        k = rg.gather_launcher(plan, imat, fmat, idx)[2].kind
        kinds[k] = kinds.get(k, 0) + 1

    for la, lb in ((4, 0), (4, 4), (3, 2), (3, 6), (3, 0), (3, 4), (2, 2),
                   (6, 2), (9, 14), (5, 6), (2, 0)):
        for cap, n_out in ((1000, 1), (70_001, 65_537),
                           (1 << 20, 3 * (1 << 18) + 3)):
            for oor in (False, True):
                check(f"row gather ({la}, {lb}) {n_out} of {cap}"
                      f"{' all out of range' if oor else ''}",
                      *_width_case(rng, dev, la, lb, cap, n_out, oor))
    plan, imat, fmat, idx = _width_case(rng, dev, 4, 4, 4097, 10_001)
    flat = torch.empty(imat.numel() + 1, dtype=torch.int32, device=dev)
    off = flat[1:].view(imat.shape)
    off.copy_(imat)
    check("row gather (4, 4) matrix off alignment", plan, off, fmat, idx)
    for n_rows, n_out in ((1000, 1), (70_001, 65_537), (1 << 20, 3 << 19)):
        plan, imat, fmat, idx = _gather_inputs(rng, dev, n_rows, n_out)
        check(f"row gather packed n_out={n_out}", plan, imat, fmat, idx)
        safe = torch.where((idx >= 0) & (idx < imat.shape[0]), idx, 0)
        _exact(f"dma_row_gather n_out={n_out}",
               [rg.dma_row_gather(imat, idx)], [imat[safe.long()]])
    missing = (set(rg.FIXED.values()) | {rg.ANY}) - set(kinds)
    if missing:
        raise AssertionError(f"row gather: kernels not exercised {missing}")
    print(f"compare row gather: widths (4,0) (4,4) (3,2) (3,6) (3,0) (3,4) "
          f"(2,2) (6,2) (9,14) (5,6) (2,0) at 3 shapes, all out of range "
          f"too, a matrix "
          f"off alignment, packed columns of 5 types; kernels used "
          f"{ {rg.kind_name(k): v for k, v in kinds.items()} }; exact bits")


class JoinInputs:
    """The inputs a main path gives the join's hash and probe kernels,
    taken from the port's own join exec: its build table and stream keys,
    the candidate ranges and bucket."""

    def __init__(self, j):
        import torch
        from spark_rapids_tpu_torch.columnar.column import bucket_capacity
        from spark_rapids_tpu_torch.ops import hashing, join as oj
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
        # the murmur3 chain's inputs: the build pair's keys, the stream's
        self.build_keys, self.stream_keys = build.key_cols, list(skeys)
        # the lanes' (rows 2 and 3): the stream key with the join seed as
        # a per-row plane
        key = skeys[0].data
        seed = hashing.i32_bits(torch.full_like(key, oj.JOIN_HASH_SEED,
                                                dtype=torch.int64))
        self.hash = (key, seed)


#: which call of a main path a row gather is, by the functions on its
#: stack (the first rule whose functions are all there names it)
GATHER_SITES = (
    (("reorder_columns",), "exchange reorder"),
    (("groupby_aggregate", "sort_batch_columns"), "group-by sort"),
    (("sort_batch_columns",), "sort"),
    (("_filter", "compact_columns"), "filter compaction"),
    (("compact_columns",), "exact-tier compaction"),
    (("build",), "build permute"),
    (("_emit_stream_flags",), "semi/anti compaction"),
    (("_emit_build_unmatched",), "unmatched build rows"),
    (("_join_stream",), "nested-loop chunk"),
    (("_probe_kernel", "gather_batch_columns"), "stream payload"),
    (("_probe_kernel",), "build payload"),
)


def capture_row_gathers(plan):
    """Run `plan` once under a speculation scope and keep the inputs of
    every packed row gather it makes (each goes through the gather
    engine's `gather_rows`), in call order: [(site, pack plan, u32
    matrix, f64 matrix or None, int32 index)]."""
    import inspect
    import torch
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    from spark_rapids_tpu_torch.ops import gather as G
    calls, real = [], G.gather_rows

    def record(pack, imat, fmat, idx):
        names = {f.function for f in inspect.stack(0)[1:]}
        site = next((label for need, label in GATHER_SITES
                     if all(n in names for n in need)), "other")
        calls.append((site, pack, imat, fmat, idx.to(torch.int32).clone()))
        return real(pack, imat, fmat, idx)

    G.gather_rows = record
    try:
        with speculation_scope():
            list(plan.execute())
            torch.cuda.synchronize()
    finally:
        G.gather_rows = real
    return calls


def compare_join_inputs(label, inputs, gathers):
    """Each join kernel against its plain version, exactly, on a main
    path's own inputs: the stream keys' hash, the probe, and every row
    gather that the path makes (`capture_row_gathers`)."""
    from spark_rapids_tpu_torch.ops import join as oj, murmur3_lanes as m3
    pair = [oj.JOIN_HASH_SEED, oj.JOIN_HASH_SEED2]
    _exact(f"murmur3 {label} build pair",
           m3.murmur3_columns(inputs.build_keys, pair),
           m3.murmur3_columns_plain(inputs.build_keys, pair))
    _exact(f"murmur3 {label} stream keys",
           m3.murmur3_columns(inputs.stream_keys, pair[:1]),
           m3.murmur3_columns_plain(inputs.stream_keys, pair[:1]))
    hits = compare_probe(f"probe {label}", inputs.probe, inputs.cand_cap,
                         inputs.total)
    shapes = compare_row_gathers(label, gathers)
    print(f"compare {label} main-path inputs: murmur3 of "
          f"{inputs.build_rows} build keys (two seeds) and "
          f"{inputs.stream_rows} stream keys, probe of {inputs.stream_rows} "
          f"stream rows into {inputs.build_rows} build rows, candidate "
          f"total {inputs.total} in {inputs.cand_cap} slots, {hits} "
          f"verified pairs; row gathers "
          f"{'; '.join(shapes)}; exact")


def compare_row_gathers(label, gathers):
    """dma_row_gather against its plain version, exactly, at every row
    gather a main path made (`capture_row_gathers`); returns the shapes."""
    import torch
    from spark_rapids_tpu_torch.ops import row_gather as rg
    from spark_rapids_tpu_torch.ops.rowpack import gather_rows
    if not gathers:
        raise AssertionError(f"{label}: no row gather captured")
    shapes = {}
    for site, plan, imat, fmat, idx in gathers:
        got = rg.pallas_gather_rows(plan, imat, fmat, idx)
        want = gather_rows(plan, imat, fmat, idx)
        if [x is None for x in got] != [x is None for x in want]:
            raise AssertionError(f"row gather {label} {site}: kernel != "
                                 f"plain version")
        _exact(f"row gather {label} {site}",
               *([x.view(torch.int64) if x.is_floating_point() else x
                  for x in out if x is not None] for out in (got, want)))
        lb = 2 * fmat.shape[1] if fmat is not None else 0
        shape = (f"{site} {idx.shape[0]} of {imat.shape[0]} rows "
                 f"(la={imat.shape[1]}, lb={lb})")
        shapes[shape] = shapes.get(shape, 0) + 1
    # a shape met more than once (a nested-loop join's chunks, the
    # partitions of a shuffle) is printed once with its count
    return [s if n == 1 else f"{s} x{n}" for s, n in shapes.items()]


def capture_dict_gathers(plan):
    """Run `plan` once under a speculation scope and keep the inputs of
    every dictionary gather it launches (each `dict_take` goes through
    ops/dict_gather.dict_gather), in call order: [(table, index)]."""
    import torch
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    from spark_rapids_tpu_torch.ops import dict_gather as dg
    calls, real = [], dg.dict_gather

    def record(table, idx):
        calls.append((table.clone(), idx.clone()))
        return real(table, idx)

    # the wrapper counts its launches on the module's `dict_gather`, which
    # is `record` meanwhile; those launches are the capture's own
    record.launches = real.launches
    dg.dict_gather = record
    try:
        with speculation_scope():
            list(plan.execute())
            torch.cuda.synchronize()
    finally:
        dg.dict_gather = real
    return calls


def compare_dict_takes(label, takes):
    """dict_gather against dict_gather_plain, exactly, at every dictionary
    gather a main path made (`capture_dict_gathers`); returns the shapes
    (index rows x lanes into table entries, element bytes)."""
    from spark_rapids_tpu_torch.ops import dict_gather as dg
    if not takes:
        raise AssertionError(f"{label}: no dictionary gather captured")
    shapes = []
    for k, (t, i) in enumerate(takes):
        _exact(f"dict_gather {label} take {k}", [dg.dict_gather(t, i)],
               [dg.dict_gather_plain(t, i)])
        shapes.append(f"{i.shape[0]}x{i.shape[1]} codes into "
                      f"{t.shape[0]} entries of {t.element_size()} bytes")
    return shapes


# -- bounds -----------------------------------------------------------------

#: integer operations of murmur3 (mix_k1: 2 multiplies and a 3-op rotate
#: per 32-bit word, once a key whatever the seeds; mix_h1: xor, rotate,
#: multiply, add per word and seed; fmix 7 per seed)
M3_K1_OPS, M3_H1_OPS, M3_FMIX_OPS = 5, 6, 7


def m3_ops(width, seeds):
    """Operations of one key of `width` bytes into `seeds` running hashes,
    the null rule's select included."""
    words = 2 if width == 8 else 1
    return words * M3_K1_OPS + seeds * (words * M3_H1_OPS + M3_FMIX_OPS + 1)


def bound(nbytes, nops):
    """(bound ms, what bounds it) at the H100's published rates."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = nops / PEAK_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


# -- the murmur3 kernel against the composition it replaced -----------------

#: the murmur3 kernel that csrc/murmur3.cu replaced: one row a thread, a
#: u32 seed per row. Phase 4 times the murmur3 kernel against it and the
#: torch passes that murmur3_batch ran around it (`replaced_murmur3_batch`);
#: it is built here for that comparison and nothing else.
REPLACED_MURMUR3_SOURCE = r"""
#include <cuda_runtime.h>
#define C1 0xCC9E2D51u
#define C2 0x1B873593u
__device__ __forceinline__ unsigned rotl32(unsigned x, int r) {
    return (x << r) | (x >> (32 - r));
}
__device__ __forceinline__ unsigned mix_k1(unsigned k1) {
    return rotl32(k1 * C1, 15) * C2;
}
__device__ __forceinline__ unsigned mix_h1(unsigned h1, unsigned k1) {
    return rotl32(h1 ^ k1, 13) * 5u + 0xE6546B64u;
}
__device__ __forceinline__ unsigned fmix(unsigned h, unsigned length) {
    h ^= length; h ^= h >> 16; h *= 0x85EBCA6Bu; h ^= h >> 13;
    h *= 0xC2B2AE35u; return h ^ (h >> 16);
}
__global__ void replaced_m3_long(const unsigned long long* __restrict__ data,
                            const unsigned* __restrict__ seed,
                            unsigned* __restrict__ out, long long n) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += step) {
        const unsigned long long v = data[i];
        unsigned h = mix_h1(seed[i], mix_k1((unsigned)v));
        h = mix_h1(h, mix_k1((unsigned)(v >> 32)));
        out[i] = fmix(h, 8u);
    }
}
__global__ void replaced_m3_int(const unsigned* __restrict__ data,
                           const unsigned* __restrict__ seed,
                           unsigned* __restrict__ out, long long n) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += step) {
        out[i] = fmix(mix_h1(seed[i], mix_k1(data[i])), 4u);
    }
}
static int blocks_for(long long n, int threads) {
    long long b = (n + threads - 1) / threads;
    return (int)(b < 132 * 16 ? b : 132 * 16);
}
extern "C" int m3_long_run(const void* data, const void* seed, void* out,
                           long long n, void* stream) {
    if (n <= 0) return 0;
    replaced_m3_long<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)data, (const unsigned*)seed,
        (unsigned*)out, n);
    return (int)cudaGetLastError();
}
extern "C" int m3_int_run(const void* data, const void* seed, void* out,
                          long long n, void* stream) {
    if (n <= 0) return 0;
    replaced_m3_int<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (const unsigned*)data, (const unsigned*)seed, (unsigned*)out, n);
    return (int)cudaGetLastError();
}
"""


def replaced_lanes():
    """The replaced lane kernels, (data, seeds) -> out each: (long, int)."""
    import ctypes
    import torch
    from spark_rapids_tpu_torch.kernels import build
    lib = build.load(build.build(REPLACED_MURMUR3_SOURCE))

    def entry(name):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                               ctypes.c_void_p]

        def run(data, seeds):
            out = torch.empty_like(seeds)
            err = fn(data.data_ptr(), seeds.data_ptr(), out.data_ptr(),
                     data.numel(),
                     torch.cuda.current_stream(data.device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"replaced {name}: CUDA error {err}")
            return out
        return run
    return entry("m3_long_run"), entry("m3_int_run")


def replaced_murmur3_batch(lanes, columns, seed):
    """The replaced murmur3_batch over LONG or INT keys: the seed plane
    (full, & 0xFFFFFFFF, then ^, - and .to(int32) into int32 bits), then
    per column its lane kernel and the null rule's select."""
    import torch
    long_lanes, int_lanes = lanes
    c0 = columns[0]
    h = torch.full((c0.capacity,), seed, dtype=torch.int64,
                   device=c0.data.device)
    h = h & 0xFFFFFFFF
    h = ((h ^ 0x80000000) - 0x80000000).to(torch.int32)
    for col in columns:
        k = long_lanes if col.data.dtype == torch.int64 else int_lanes
        h = torch.where(col.validity, k(col.data, h), h)
    return h


def _m3_record(name, replaces, launches, ms, plain_ms, bnd, **extra):
    # max_abs_err is 0: phase 2 held every output of the murmur3 kernel
    # bit for bit against the plain version, and fails otherwise
    b_ms, b_by = bnd
    return {"name": name, "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/murmur3.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, **extra}


def in_turns(old, new, reps, old_flush=FLUSH_BYTES):
    """device_ms of two functions in turns (old, new, new, old, old, new,
    new, old): ([new's four runs], [old's four runs])."""
    olds, news = [], []
    for _ in range(2):
        olds.append(device_ms(old, reps, old_flush))
        news += [device_ms(new, reps) for _ in range(2)]
        olds.append(device_ms(old, reps, old_flush))
    return news, olds


def copy_ms(nbytes, reps):
    """A device copy moving `nbytes` (half read, half written): what this
    timing gives a pure stream of those bytes on this card."""
    import torch
    a = torch.ones(nbytes // 2, dtype=torch.uint8, device="cuda")
    b = torch.empty_like(a)
    return device_ms(lambda: b.copy_(a), reps)


def time_murmur3(inputs, int_inputs, q19_inputs, counts, int_counts):
    """The murmur3 kernel on the device, L2 cold, each time the median of
    four runs in turns with what it replaced. Rows 2 and 3 (the lanes with
    a per-row seed, the TPU kernels' interface) at q3's stream keys
    against the replaced kernel; then the chain (`murmur3_columns`) at the
    q3 build pair, the q3 stream and the Q19 stream against the
    composition it replaced (seed plane, lane kernel and select, once a
    seed; timed behind a 4x longer L2 flush so that the host enqueues its
    launches before the card reaches them); each beside the plain
    version, the bound and a copy of the same bytes. No one PyTorch call
    computes murmur3, so library_ms is null."""
    import statistics
    from spark_rapids_tpu_torch.ops import hashing, join as oj
    from spark_rapids_tpu_torch.ops import murmur3_lanes as m3
    reps, plain_reps = KERNEL_REPS, max(3, KERNEL_REPS // 4)
    med = statistics.median
    lanes = replaced_lanes()
    records = []
    for name, inp, cnt, width, fn, plain, old, line in (
            ("murmur3_long_lanes", inputs, counts, 8, m3.murmur3_long_lanes,
             hashing.murmur3_long_plain, lanes[0], 70),
            ("murmur3_int_lanes", int_inputs, int_counts, 4,
             m3.murmur3_int_lanes, hashing.murmur3_int_plain, lanes[1], 78)):
        key, seed = inp.hash
        n = key.shape[0]
        _exact(f"replaced {name}", [old(key, seed)], [plain(key, seed)])
        ms, old_ms = in_turns(lambda: old(key, seed), lambda: fn(key, seed),
                           reps)
        plain_ms = device_ms(lambda: plain(key, seed), plain_reps)
        nbytes = n * (width + 4 + 4)
        copy = copy_ms(nbytes, reps)
        b_ms, b_by = bound(nbytes, n * m3_ops(width, 1))
        print(f"{name} at {n} rows: {med(ms):.4f} ms (runs "
              f"{', '.join(f'{x:.4f}' for x in ms)}), the replaced kernel "
              f"{med(old_ms):.4f} ms (runs "
              f"{', '.join(f'{x:.4f}' for x in old_ms)})"
              f", plain {plain_ms:.4f} ms, a copy of its bytes {copy:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / med(ms):.1%} of "
              f"the bound")
        records.append(_m3_record(
            name, f"spark_rapids_tpu/ops/pallas_kernels.py:{line}",
            cnt[name], med(ms), plain_ms, (b_ms, b_by), ms_runs=ms,
            replaced_ms=med(old_ms), replaced_ms_runs=old_ms, copy_ms=copy))
    pair = (oj.JOIN_HASH_SEED, oj.JOIN_HASH_SEED2)
    sites = {}
    for site, cols, seeds in (
            ("q3 build pair", inputs.build_keys, pair),
            ("q3 stream", inputs.stream_keys, pair[:1]),
            ("q19 stream", q19_inputs.stream_keys, pair[:1])):
        n = cols[0].capacity
        _exact(f"replaced composition {site}",
               [replaced_murmur3_batch(lanes, cols, s) for s in seeds],
               m3.murmur3_columns(cols, seeds))

        def old(cols=cols, seeds=seeds):
            return [replaced_murmur3_batch(lanes, cols, s) for s in seeds]

        def new(cols=cols, seeds=seeds):
            return m3.murmur3_columns(cols, seeds)
        ms, old_ms = in_turns(old, new, reps, old_flush=4 * FLUSH_BYTES)
        plain_ms = device_ms(
            lambda: m3.murmur3_columns_plain(cols, seeds), plain_reps)
        widths = [c.data.element_size() for c in cols]
        nbytes = n * (sum(widths) + len(cols) + 4 * len(seeds))
        copy = copy_ms(nbytes, reps)
        b_ms, b_by = bound(nbytes,
                           n * sum(m3_ops(w, len(seeds)) for w in widths))
        print(f"murmur3_columns {site} ({n} rows, {len(cols)} column(s), "
              f"{len(seeds)} seed(s)): {med(ms):.4f} ms in one launch (runs "
              f"{', '.join(f'{x:.4f}' for x in ms)}), the replaced "
              f"composition {med(old_ms):.4f} ms (runs "
              f"{', '.join(f'{x:.4f}' for x in old_ms)})"
              f", plain {plain_ms:.4f} ms, a copy of its bytes {copy:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / med(ms):.1%} of "
              f"the bound")
        sites[site] = {"rows": n, "seeds": len(seeds), "ms": med(ms),
                       "ms_runs": ms, "replaced_ms": med(old_ms),
                       "replaced_ms_runs": old_ms,
                       "plain_ms": plain_ms, "copy_ms": copy,
                       "bound_ms": b_ms, "bound_by": b_by}
    q3s = sites["q3 stream"]
    records.append(_m3_record(
        "murmur3_columns", "spark_rapids_tpu/ops/pallas_kernels.py:70, "
        "spark_rapids_tpu/ops/pallas_kernels.py:78",
        counts["murmur3_columns"], q3s["ms"], q3s["plain_ms"],
        (q3s["bound_ms"], q3s["bound_by"]), ms_runs=q3s["ms_runs"],
        replaced_ms=q3s["replaced_ms"], sites=sites))
    return records


def probe_need(args, cap, total):
    """Bytes and operations the probe function needs on these inputs:
    every count read; lo, validity and key lanes of each stream row that
    owns a slot below `cap`; build lanes, validity and perm of each
    distinct build row a slot reads; 13 bytes written per slot; per live
    slot the build position, the clamp and the compares, 4 stores past
    the total."""
    import torch
    from spark_rapids_tpu_torch.ops import probe_verify as pv
    lo, counts = args[0], args[1]
    n, b, L = counts.shape[0], args[6].shape[0], args[2].shape[1]
    live = min(total, cap)
    _, s_idx, b_pos, _ = pv.fused_probe_verify_plain(*args, cap)
    owners = int(torch.unique(s_idx[:live]).numel())
    touched = int(torch.unique(b_pos[:live].clamp(0, b - 1)).numel())
    nbytes = 4 * n + owners * (4 + 1 + 4 * L) + touched * (4 * L + 1 + 4) \
        + 13 * cap
    return nbytes, live * (8 + 2 * L) + (cap - live) * 4


def time_probe_shape(label, inp):
    """fused_probe_verify at one join's inputs (JoinInputs): the wrapper's
    whole device work, its kernel launch alone, the plain version and the
    bound of what the function needs."""
    from spark_rapids_tpu_torch.ops import probe_verify as pv
    reps, plain_reps = KERNEL_REPS, max(3, KERNEL_REPS // 4)
    args, cap = inp.probe, inp.cand_cap
    _, launch = pv.launcher(*args, cap)
    launch()
    kernel_ms = device_ms(launch, reps)
    ms = device_ms(lambda: pv.fused_probe_verify(*args, cap), reps)
    plain_ms = device_ms(lambda: pv.fused_probe_verify_plain(*args, cap),
                         plain_reps)
    b_ms, b_by = bound(*probe_need(args, cap, inp.total))
    print(f"fused_probe_verify {label} ({inp.stream_rows} stream rows, "
          f"{pv.tile_count(inp.stream_rows)} tiles, {inp.build_rows} build "
          f"rows, total {inp.total} in {cap} slots): wrapper {ms:.4f} ms on "
          f"the device, kernel launch {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
          f"{b_ms / ms:.1%} of the bound")
    return {"max_abs_err": 0.0, "ms": ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "stream_rows": inp.stream_rows,
            "build_rows": inp.build_rows, "candidates": inp.total,
            "cand_cap": cap}


def time_probe(inputs, q19_inputs, launches):
    """fused_probe_verify at q3's and Q19's main-path inputs
    (time_probe_shape: comparable to the earlier records, which timed the
    wrapper). The record holds q3's shape with Q19's under "q19_shape"."""
    q3, q19 = (dict(time_probe_shape(label, inp), launches=launches[label])
               for label, inp in (("q3", inputs), ("q19", q19_inputs)))
    return {"name": "fused_probe_verify", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/probe_verify.cu",
            "replaces": "spark_rapids_tpu/ops/pallas_join.py:52", **q3,
            "q19_shape": q19}


def time_gather_call(path, site, plan, imat, fmat, idx, generic=True):
    """One captured row gather on the device, L2 cold: the kernel's
    launch alone, the wrapper's whole call, the plain version, the bound
    (the index, each distinct row an in-range index reads, row 0 once,
    every output row written) and the faster of the two PyTorch calls
    that compute the same function on the same matrix (index_select, a
    tensor index). With `generic`, a shape a fixed-width kernel serves is
    timed on the generic kernel too."""
    import torch
    from spark_rapids_tpu_torch.ops import row_gather as rg
    from spark_rapids_tpu_torch.ops.rowpack import gather_rows
    reps, plain_reps = KERNEL_REPS, max(3, KERNEL_REPS // 4)
    n, cap = idx.shape[0], imat.shape[0]
    lanes = imat.shape[1] + (2 * fmat.shape[1] if fmat is not None else 0)
    _, _, p, launch = rg.gather_launcher(plan, imat, fmat, idx)
    launch()
    kernel_ms = device_ms(launch, reps)
    ms = device_ms(lambda: rg.pallas_gather_rows(plan, imat, fmat, idx),
                   reps)
    plain_ms = device_ms(lambda: gather_rows(plan, imat, fmat, idx),
                         plain_reps)
    mat = torch.cat([imat] + ([fmat.view(torch.int32)]
                              if fmat is not None else []),
                    dim=1).contiguous()
    ok = (idx >= 0) & (idx < cap)
    safe = torch.where(ok, idx, 0).long()
    lib = {"index_select": device_ms(
               lambda: torch.index_select(mat, 0, safe), reps),
           "mat[idx]": device_ms(lambda: mat[safe], reps)}
    lib_name = min(lib, key=lib.get)
    rows_read = int(torch.unique(idx[ok]).numel())
    b_ms, b_by = bound(4 * n + 4 * lanes * (rows_read + 1 + n), 0)
    generic_ms = None
    if p.kind != rg.ANY and generic:
        # the generic kernel at the same shape: the matrices copied off
        # their pieces' alignment
        _, _, pg, launch_g = rg.launcher(
            idx, _off_aligned(imat), _off_aligned(fmat.view(torch.int32))
            if fmat is not None else None, plan.n_valid_lanes)
        if pg.kind != rg.ANY:
            raise AssertionError(f"{site}: the off-aligned copy still takes "
                                 f"{rg.kind_name(pg.kind)}")
        launch_g()
        generic_ms = device_ms(launch_g, reps)
    rec = {"path": path, "site": site, "n": n, "cap": cap,
           "la": imat.shape[1], "lb": lanes - imat.shape[1],
           "kernel": rg.kind_name(p.kind), "in_range": int(ok.sum()),
           "kernel_ms": kernel_ms, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib[lib_name], "library": lib_name,
           "index_select_ms": lib["index_select"],
           "generic_kernel_ms": generic_ms}
    print(f"dma_row_gather {path} {site} ({n} of {cap} rows, "
          f"{rec['in_range']} in range, la={rec['la']} lb={rec['lb']}, "
          f"kernel {rec['kernel']}): kernel {kernel_ms:.4f} ms, wrapper "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}), {b_ms / kernel_ms:.1%} of the bound; index_select "
          f"{lib['index_select']:.4f} ms, mat[idx] {lib['mat[idx]']:.4f} ms"
          + (f"; the generic kernel {generic_ms:.4f} ms"
             if generic_ms is not None else ""))
    return rec


def _off_aligned(m):
    """A copy of the int32 matrix `m` whose rows start 4 bytes past its
    allocation's 16-byte boundary."""
    import torch
    flat = torch.empty(m.numel() + 1, dtype=torch.int32, device=m.device)
    out = flat[1:].view(m.shape)
    out.copy_(m)
    return out


def time_row_gathers(paths, launches):
    """dma_row_gather at every shape the main paths give it (`paths`:
    {path: capture_row_gathers(plan)}): the kernel's launch alone, the
    wrapper's whole call, the plain version, the bound (the index, each
    distinct row an in-range index reads, row 0 once, every output row
    written) and the faster of the two PyTorch calls that compute the
    same function on the same matrix (index_select, a tensor index), all
    on the device with L2 cold. The record's own numbers are the q3
    stream payload's (the shape earlier records timed); "shapes" lists
    every shape and "per_iteration" sums each path's kernel time."""
    shapes, per_it, main = [], {}, None
    for path, calls in paths.items():
        per_it[path] = 0.0
        for call in calls:
            rec = time_gather_call(path, *call)
            per_it[path] += rec["kernel_ms"]
            shapes.append(rec)
            if path == "q3" and rec["site"] == "stream payload":
                main = rec
    print("dma_row_gather per iteration: " + ", ".join(
        f"{k} {v:.4f} ms in {len(paths[k])} launches"
        for k, v in per_it.items()))
    return {"name": "dma_row_gather", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/row_gather.cu",
            "replaces": "spark_rapids_tpu/ops/pallas_gather.py:101",
            "launches": launches, "max_abs_err": 0.0, "ms": main["ms"],
            "kernel_ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shapes": shapes,
            "per_iteration": per_it}


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


def time_dict_gather(q19_lines, launches, p7_take, p7_launches):
    """The dictionary gather at q19's 1-byte take over the l_shipmode
    codes, at P7's take of the ship-mode hash table by the stream's codes
    (`p7_take`: (table, index) as captured) and at dg's shape: the
    kernel's launches alone (its plan and
    output made once) on the device with L2 cold, the same back to back
    (as PR 3 timed its wrapper), the wrapper's whole call, the plain
    version, the byte bound and the one PyTorch call that computes the
    same function (a table index for one lane; torch.gather) on the same
    inputs, the indices clamped and widened to int64 beforehand (PyTorch
    indexes with int64). Returns the kernel's record at the q19 take (the
    main path's shape, with its `launches`) holding under "p7_take" the
    same times at P7's take (with `p7_launches`, one P7 run's) and under
    "dg_shape" at dg's shape, which no path launches (launches 0)."""
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
    p7_table, p7_codes = p7_take
    p7_flat = p7_table.reshape(-1)
    p7_safe64 = p7_codes.clamp(0, p7_table.shape[0] - 1).reshape(-1).long()
    out = []
    for label, t, i, lib, n_launches in (
            (f"q19 l_shipmode take, {codes.shape[0]} codes into "
             f"{hit.shape[0]} bool entries", hit, codes,
             lambda: flat[safe64], launches),
            (f"P7 ship-mode hash take, {p7_codes.shape[0]} codes into "
             f"{p7_table.shape[0]} int32 entries", p7_table, p7_codes,
             lambda: p7_flat[p7_safe64], p7_launches),
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
    take, p7, dg_shape = out
    return {"name": "dict_gather", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/dict_gather.cu",
            "replaces": "tools/exp_gather.py:168", **take, "p7_take": p7,
            "dg_shape": dg_shape}


# -- slice 8: the planner and the session (phase 3c) -------------------------

#: the confs of the planned paths: q3, Q19 and P11 pin their aggregates to
#: the exact tier as the hand-built plans do (`_spec_enabled = False`);
#: P11 plans its joins over the host shuffle into P_PARTS partitions
#: instead of broadcasting the orders
Q3_CONF = {"spark.rapids.tpu.agg.speculative.enabled": "false"}
P11_CONF = dict(Q3_CONF, **{"spark.rapids.sql.shuffle.partitions":
                            str(P_PARTS),
                            "spark.rapids.sql.broadcastSizeThreshold": "-1"})
SESSION_ITERS = 5        # phase 4's session-against-hand-built runs each


def session_modules():
    """The port's session API, functions, expressions and planner."""
    from types import SimpleNamespace
    from spark_rapids_tpu_torch.api import functions, session
    from spark_rapids_tpu_torch.expr import core, predicates
    from spark_rapids_tpu_torch.plan import overrides
    return SimpleNamespace(core=core, pred=predicates, F=functions,
                           session=session, overrides=overrides)


def q1_df(m, sess, batches):
    """bench.py's q1 as a DataFrame query: filter -> select(disc_price)
    -> group by returnflag: sum, sum, count."""
    col, lit, F = m.core.col, m.core.lit, m.F
    df = sess.from_batches(batches, batches[0].schema)
    return (df.filter(col("quantity") <= lit(45))
            .select(col("returnflag"), col("quantity"),
                    (col("extendedprice") * (lit(1.0) - col("discount")))
                    .alias("disc_price"))
            .group_by("returnflag")
            .agg((F.sum("quantity"), "sum_qty"),
                 (F.sum("disc_price"), "sum_disc"), (F.count(), "cnt")))


def q3_df(m, sess, order_batches, line_batches):
    """bench.py's q3 as a DataFrame query: both sides filtered, joined on
    the order key, revenue by order, its top 10."""
    col, lit, F = m.core.col, m.core.lit, m.F
    lines = sess.from_batches(line_batches, line_batches[0].schema) \
        .filter(col("l_flag") != lit(0))
    orders = sess.from_batches(order_batches, order_batches[0].schema) \
        .filter(col("o_flag") < lit(5))
    return (lines.join(orders, left_on="l_orderkey", right_on="o_orderkey")
            .select(col("l_orderkey"),
                    (col("l_price") * (lit(1.0) - col("l_disc")))
                    .alias("rev"))
            .group_by("l_orderkey").agg((F.sum("rev"), "revenue"))
            .sort((col("revenue"), False)).limit(10))


def q19_df(m, sess, l_batch, p_batch, terms=Q19_TERMS, span=Q19_QTY_SPAN,
           shipmodes=Q19_SHIPMODES):
    """TPC-H Q19 as a DataFrame query (q19_tree's predicates): the
    filtered lineitems joined to the filtered parts on the part key with
    the three-way OR as the join's condition, then the grand sum."""
    col, lit, pr, F = m.core.col, m.core.lit, m.pred, m.F

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
    lines = sess.from_batches([l_batch], l_batch.schema) \
        .filter(all_of(*ship))
    parts = sess.from_batches([p_batch], p_batch.schema).filter(
        pr.And(pr.GreaterThanOrEqual(col("p_size"), lit(1)),
               any_of(*part_terms)))
    return (lines.join(parts, left_on="l_partkey", right_on="p_partkey",
                       condition=any_of(*terms_all))
            .select(col("l_extendedprice"), col("l_discount"))
            .agg((F.sum(col("l_extendedprice")
                        * (lit(1.0) - col("l_discount"))), "revenue")))


def tpch_q1_df(m, sess, l_batch, cutoff=None):
    """TPC-H Q1 (P6) as a DataFrame query: tpch_q1_tree's filter, its
    eight aggregates by the two string flags, ordered by them."""
    col, lit, F = m.core.col, m.core.lit, m.F
    cutoff = lit(Q1_SHIP_CUTOFF) if cutoff is None else cutoff
    price, disc = col("l_extendedprice"), col("l_discount")
    disc_price = price * (lit(1.0) - disc)
    return (sess.from_batches([l_batch], l_batch.schema)
            .filter(m.pred.LessThanOrEqual(col("l_shipdate"), cutoff))
            .group_by("l_returnflag", "l_linestatus")
            .agg((F.sum("l_quantity"), "sum_qty"),
                 (F.sum(price), "sum_base_price"),
                 (F.sum(disc_price), "sum_disc_price"),
                 (F.sum(disc_price * (lit(1.0) + col("l_tax"))),
                  "sum_charge"),
                 (F.avg("l_quantity"), "avg_qty"), (F.avg(price), "avg_price"),
                 (F.avg(disc), "avg_disc"), (F.count(), "count_order"))
            .sort("l_returnflag", "l_linestatus"))


def planned(m, df):
    """df's plan through the session's planner, timed: (exec tree, ms of
    wrap_and_tag, ms of convert). A plan that cannot run raises with the
    explain text, and the execs are built under the session's conf, as
    apply() does."""
    m.session.set_active_conf(df.session.conf)
    overrides = m.overrides.TpuOverrides(df.session.conf)
    t0 = time.perf_counter()
    meta = overrides.wrap_and_tag(df.logical_plan())
    t1 = time.perf_counter()
    if not overrides._all_ok(meta):
        raise m.overrides.PlanNotSupported(meta.explain())
    tree = meta.convert()
    t2 = time.perf_counter()
    return tree, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def exec_nodes(node):
    out = [node]
    for c in node.children:
        out.extend(exec_nodes(c))
    return out


def plan_shape(node):
    """An exec tree's classes, nested, with the scan under a coalesce
    reduced to its leaf ("Scan"): the shape the planner and the
    hand-built plans share."""
    name = type(node).__name__
    if name in ("CoalesceBatchesExec", "SourceScanExec", "InMemoryScanExec"):
        return "Scan"
    return (name, tuple(plan_shape(c) for c in node.children))


def explain_launches(label, tree, counts, hand_counts):
    """Every kernel whose launches differ from the hand-built plan's, with
    the planned node that accounts for it; a difference no node accounts
    for raises. A FilterExec below a BroadcastExchangeExec compacts its
    batches (one packed row gather each), where the hand-built join masks
    its build side's keys instead; a CoalesceBatchesExec that merged its
    input batches runs the operators above it over fewer batches."""
    nodes = exec_nodes(tree)
    compacted = sum(
        n.child.child.metrics["numOutputBatches"].value
        for n in nodes if type(n).__name__ == "BroadcastExchangeExec"
        and type(n.child).__name__ == "FilterExec"
        and type(n.child.child).__name__ == "CoalesceBatchesExec")
    merges = [(n.metrics["numInputBatches"].value,
               n.metrics["numOutputBatches"].value) for n in nodes
              if type(n).__name__ == "CoalesceBatchesExec"
              and n.metrics["numInputBatches"].value
              > n.metrics["numOutputBatches"].value]
    notes = []
    for name in sorted(counts):
        d = counts[name] - hand_counts[name]
        if d == 0:
            continue
        if name == "dma_row_gather" and d == compacted and not merges:
            notes.append(f"{name} {counts[name]} (hand-built "
                         f"{hand_counts[name]}): BroadcastExchangeExec over "
                         f"FilterExec compacts {compacted} build batch(es) "
                         f"the hand-built join masks")
        elif d < 0 and merges:
            merged = " and ".join(f"{a} batches into {b}" for a, b in merges)
            notes.append(f"{name} {counts[name]} (hand-built "
                         f"{hand_counts[name]}): CoalesceBatchesExec merged "
                         f"{merged}")
        else:
            raise AssertionError(f"{label}: {name} launched {counts[name]} "
                                 f"times, the hand-built plan "
                                 f"{hand_counts[name]}, and no planned node "
                                 f"accounts for it")
    return notes


def drive_planned(label, m, df, need, hand_counts, check, hand_shape=None):
    """Phase 3c for one query: print its explain text, plan it (timed),
    check its shape against the hand-built plan's when given, drive it
    once counted (drive_batches: the speculation flags must stay False),
    hold its rows with `check`, explain every launch count that differs
    from the hand-built plan's (when there is one: `hand_counts`), then
    collect() it through the session once more, counted, which must
    launch the same. `check(rows, label, operator metrics)` raises on a
    wrong result. Returns a record."""
    print(f"{label} explain:\n{df.explain()}")
    tree, tag_ms, convert_ms = planned(m, df)
    shape = plan_shape(tree)
    if hand_shape is not None and shape != hand_shape:
        raise AssertionError(f"{label}: planned {shape} != hand-built "
                             f"{hand_shape}")
    out, counts, reads = drive_batches(label, tree, need)
    check([r for b in out for r in b.to_pylist()], label,
          m.session._operator_metrics(tree))
    notes = explain_launches(label, tree, counts, hand_counts) \
        if hand_counts is not None else []
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    rows = df.collect()
    collect_ms = (time.perf_counter() - t0) * 1e3
    again = {name: w.launches for name, w in wrappers.items()}
    check(rows, label + " collect()", df.session.last_query_metrics())
    if again != counts:
        raise AssertionError(f"{label}: collect() launched {again}, the "
                             f"counted run {counts}")
    check_idle(label)
    shuffle_root_empty(label)
    print(f"{label}: plan {tag_ms + convert_ms:.3f} ms (wrap_and_tag "
          f"{tag_ms:.3f}, convert {convert_ms:.3f}); collect() "
          f"{collect_ms:.3f} ms (its plan included, one run); launches "
          f"{counts}; hand-built {hand_counts}; host reads {reads}")
    for note in notes:
        print(f"  {label}: {note}")
    return {"plan_ms": tag_ms + convert_ms, "wrap_and_tag_ms": tag_ms,
            "convert_ms": convert_ms, "collect_ms": collect_ms,
            "launches": counts, "collect_launches": again,
            "hand_built_launches": hand_counts, "differences": notes,
            "host_reads": reads, "shape": repr(shape)}


def time_session_paths(paths):
    """Phase 4: each of q1, q3 and Q19 through the session (plan
    included: df.collect()) and as its hand-built plan (plan.collect()),
    in turns, SESSION_ITERS runs each, one synchronisation a run.
    `paths` maps a label to (df, hand-built plan, check(rows, label))."""
    import torch
    out = {}
    for label, (df, hand, check) in paths.items():
        ms = {"session": [], "hand_built": []}
        for i in range(SESSION_ITERS):
            order = ("hand_built", "session") if i % 2 == 0 \
                else ("session", "hand_built")
            for k in order:
                t0 = time.perf_counter()
                rows = df.collect() if k == "session" else hand.collect()
                torch.cuda.synchronize()
                ms[k].append((time.perf_counter() - t0) * 1e3)
                check(rows, f"{label} {k}")
        out[label] = ms
        print(f"{label} ms per run, in turns ({SESSION_ITERS} each): "
              f"session {[round(x, 3) for x in ms['session']]}, hand-built "
              f"{[round(x, 3) for x in ms['hand_built']]}")
    return out


# -- slice 9: the join types, the nested-loop join and the basic operators
# -- (phase 3d) -------------------------------------------------------------

TPCH_SF = 1.0            # P12, P13 and P16 at TPC-H SF1 (clause 4.2.3)
#: clause 4.2.3's order priorities and the 25 nations by n_nationkey
ORDER_PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                    "5-LOW")
NATIONS = ("ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
           "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN",
           "JORDAN", "KENYA", "MOROCCO", "PERU", "CHINA", "ROMANIA",
           "SAUDI ARABIA", "VIETNAM", "RUSSIA", "UNITED KINGDOM",
           "UNITED STATES", "MOZAMBIQUE")
ORDER_STATUSES = ("F", "O", "P")
Q4_DATE = datetime.date(1993, 7, 1)      # clause 2.4.4.3's DATE
Q4_END = datetime.date(1993, 10, 1)      # DATE + 3 months
Q21_NATION = "SAUDI ARABIA"              # clause 2.4.21.3's NATION
Q21_LIMIT = 100
P14_KINDS = (("inner", "right"), ("inner", "left"), ("left_outer", "right"),
             ("left_outer", "left"), ("right_outer", "right"),
             ("right_outer", "left"), ("full_outer", "right"),
             ("full_outer", "left"), ("left_semi", "right"),
             ("left_anti", "right"), ("existence", "right"))
P15_LINES = 1 << 20      # P15's lineitems
P15_BANDS = 11           # discount bands [k/100, (k+1)/100), k = 0..10
P_JOIN_ITERS = 3         # phase 4's timed runs of P12-P16 each
#: P13's conf: with a join's estimated size unknown (a join below it) the
#: planner of either package takes the adaptive join (AdaptiveJoinExec,
#: ROADMAP A.3 / A.9) unless broadcasts are off
Q21_CONF = dict(Q3_CONF, **{"spark.rapids.sql.broadcastSizeThreshold": "-1"})
#: P15's conf: the exact aggregate, as q3's (the chunks' band ranges
#: differ, and the speculative tier would trip and re-run)
P15_CONF = Q3_CONF
P16_CONF = P11_CONF


def days(date):
    return (date - datetime.date(1970, 1, 1)).days


def tpch_join_data(sf=TPCH_SF, seed=21):
    """orders, lineitem, supplier and nation by TPC-H's generation rules
    (clause 4.2.3) at scale factor `sf`, from a fixed seed: sparse order
    keys (8 of every 32), 1-7 lines an order, l_suppkey by the partsupp
    formula over a random part, the ship, commit and receipt dates off
    the order date, o_orderstatus from its lines' statuses, and suppliers
    spread over the 25 nations. A string column is (int32 codes, values)."""
    rng = np.random.default_rng(seed)
    n_orders, n_supp = int(sf * 1_500_000), max(int(sf * 10_000), 4)
    n_part = max(int(sf * 200_000), 1)
    i = np.arange(n_orders, dtype=np.int64)
    okey = (i // 8) * 32 + i % 8 + 1
    odate = rng.integers(ORDER_DATE_FIRST, ORDER_DATE_LAST + 1, n_orders)
    nlines = rng.integers(1, 8, n_orders)
    owner = np.repeat(i, nlines)
    n_line = owner.shape[0]
    part = rng.integers(1, n_part + 1, n_line)
    corner = rng.integers(0, 4, n_line)
    supp = (part + corner * (n_supp // 4 + (part - 1) // n_supp)) \
        % n_supp + 1
    od = odate[owner]
    ship = od + rng.integers(1, 122, n_line)
    commit = od + rng.integers(30, 91, n_line)
    receipt = ship + rng.integers(1, 31, n_line)
    shipped = np.bincount(owner, weights=ship <= CURRENT_DATE,
                          minlength=n_orders)
    status = np.where(shipped == nlines, 0, np.where(shipped == 0, 1, 2))
    return {
        "o_orderkey": okey, "o_orderdate": odate.astype(np.int32),
        "o_orderpriority": (rng.integers(0, 5, n_orders).astype(np.int32),
                            ORDER_PRIORITIES),
        "o_orderstatus": (status.astype(np.int32), ORDER_STATUSES),
        "l_orderkey": okey[owner], "l_suppkey": supp.astype(np.int64),
        "l_shipdate": ship.astype(np.int32),
        "l_commitdate": commit.astype(np.int32),
        "l_receiptdate": receipt.astype(np.int32),
        "l_discount": rng.integers(0, 11, n_line) / 100.0,
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
        "s_name": (np.arange(n_supp, dtype=np.int32),
                   tuple(f"Supplier#{k:09d}" for k in range(1, n_supp + 1))),
        "s_nationkey": rng.integers(0, 25, n_supp).astype(np.int32),
        "n_nationkey": np.arange(25, dtype=np.int32),
        "n_name": (np.arange(25, dtype=np.int32), NATIONS)}


#: the tables' columns: (name, type, encoded) — an encoded STRING column
#: is a DictionaryColumn, the others StringColumns (group and sort keys)
JOIN_TABLES = {
    "orders": (("o_orderkey", "LONG", False), ("o_orderdate", "DATE", False),
               ("o_orderpriority", "STRING", False),
               ("o_orderstatus", "STRING", True)),
    "lineitem": (("l_orderkey", "LONG", False), ("l_suppkey", "LONG", False),
                 ("l_shipdate", "DATE", False),
                 ("l_commitdate", "DATE", False),
                 ("l_receiptdate", "DATE", False),
                 ("l_discount", "DOUBLE", False)),
    "supplier": (("s_suppkey", "LONG", False), ("s_name", "STRING", False),
                 ("s_nationkey", "INT", False)),
    "nation": (("n_nationkey", "INT", False), ("n_name", "STRING", True))}


def join_table_spec(d, table, rows=None):
    """A table's columns as {name: (values, type name, None)}, the form
    the parity tests build both packages' batches from: an encoded column
    as (codes, values), a plain string column as a list of str."""
    out = {}
    for name, ty, encoded in JOIN_TABLES[table]:
        v = d[name]
        if isinstance(v, tuple):
            codes = v[0] if rows is None else v[0][rows]
            v = (codes, v[1]) if encoded else [v[1][c] for c in codes]
        elif rows is not None:
            v = v[rows]
        out[name] = (v, ty, None)
    return out


def string_column(codes, words, dev):
    """A StringColumn of words[codes], built without a Python loop over
    the rows."""
    from spark_rapids_tpu_torch.columnar.column import StringColumn
    enc = [w.encode("utf-8") for w in words]
    lens = np.array([len(b) for b in enc], np.int64)
    width = max(int(lens.max()), 1)
    mat = np.zeros((len(enc), width), np.uint8)
    for k, b in enumerate(enc):
        mat[k, :len(b)] = np.frombuffer(b, np.uint8)
    row_lens = lens[codes]
    keep = np.arange(width)[None, :] < row_lens[:, None]
    offsets = np.concatenate([[0], np.cumsum(row_lens)]).astype(np.int32)
    return StringColumn.from_numpy(mat[codes][keep], offsets, device=dev)


def join_batch(d, table, dev, rows=None):
    """One table of tpch_join_data as a port batch on `dev` (optionally
    the rows `rows` only)."""
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column, string_buffers
    from spark_rapids_tpu_torch.columnar.encoded import dictionary_from_numpy
    cols, n = [], None
    for name, ty, encoded in JOIN_TABLES[table]:
        v = d[name]
        if isinstance(v, tuple):
            codes = v[0] if rows is None else v[0][rows]
            cols.append(dictionary_from_numpy(
                codes, *string_buffers(v[1]), device=dev) if encoded
                else string_column(codes, v[1], dev))
            n = codes.shape[0]
        else:
            v = v if rows is None else v[rows]
            cols.append(Column.from_numpy(v, getattr(t, ty), device=dev))
            n = v.shape[0]
    schema = t.Schema(tuple(t.StructField(name, getattr(t, ty))
                            for name, ty, _ in JOIN_TABLES[table]))
    return ColumnarBatch(cols, n, schema)


def join_batches(d, dev):
    return {k: join_batch(d, k, dev) for k in JOIN_TABLES}


def date_lit(m, date):
    """A DATE literal as days since the epoch, in either package."""
    return m.core.Literal(days(date), m.t.DATE)


def q4_tree(m, orders_scan, lines_scan, anti=False, n_parts=None):
    """TPC-H Q4 (clause 2.4.4) as Spark plans it, in the package `m`
    holds: the orders of the quarter left-semi-joined (NOT EXISTS:
    left-anti) to the lineitems with l_commitdate < l_receiptdate on the
    order key, the lineitems built on the right; count(*) by
    o_orderpriority, ordered by it. With `n_parts` (P16) both sides are
    hash-exchanged on the order key into a ShuffledHashJoinExec and the
    count split into partial -> exchange -> final, without the sort."""
    col, pr = m.core.col, m.pred
    orders = m.basic.FilterExec(pr.And(
        pr.GreaterThanOrEqual(col("o_orderdate"), date_lit(m, Q4_DATE)),
        pr.LessThan(col("o_orderdate"), date_lit(m, Q4_END))), orders_scan)
    lines = m.basic.FilterExec(
        pr.LessThan(col("l_commitdate"), col("l_receiptdate")), lines_scan)
    ok, lk = [col("o_orderkey")], [col("l_orderkey")]
    jt = "left_anti" if anti else "left_semi"
    if n_parts is None:
        joined = m.joins.HashJoinExec(orders, lines, ok, lk, jt,
                                      build_side="right")
    else:
        joined = m.exchange.ShuffledHashJoinExec(
            shuffle_of(m, ok, orders, n_parts),
            shuffle_of(m, lk, lines, n_parts), ok, lk, jt,
            build_side="right")
    group = [col("o_orderpriority")]
    aggs = [(m.aggexprs.Count(), "order_count")]
    if n_parts is not None:
        return shuffled_aggregate(m, group, aggs, joined, n_parts)
    agg = m.agg.AggregateExec(group, aggs, joined)
    return m.sort.SortExec([(col("o_orderpriority"), True)], agg)


def q4_oracle(d, anti=False):
    """Q4 in numpy: (o_orderpriority, order_count) in priority order."""
    n_orders = d["o_orderkey"].shape[0]
    late = d["l_commitdate"] < d["l_receiptdate"]
    owner = order_index(d["l_orderkey"][late])
    has = np.bincount(owner, minlength=n_orders) > 0
    od = d["o_orderdate"]
    keep = (od >= days(Q4_DATE)) & (od < days(Q4_END)) \
        & (~has if anti else has)
    counts = np.bincount(d["o_orderpriority"][0][keep], minlength=5)
    return [(ORDER_PRIORITIES[k], int(counts[k])) for k in range(5)
            if counts[k]]


def order_index(keys):
    """Row of each sparse order key (clause 4.2.3's 8 of every 32)."""
    k = keys - 1
    return (k // 32) * 8 + k % 32


def ne(m, a, b):
    return m.pred.Not(m.pred.EqualTo(m.core.col(a), m.core.col(b)))


def q21_tree(m, lines_scan, l2_scan, l3_scan, supp_scan, orders_scan,
             nation_scan, nation=Q21_NATION):
    """TPC-H Q21 (clause 2.4.21) as Spark's optimizer plans it, in the
    package `m` holds: l1 (l_receiptdate > l_commitdate) left-semi-joined
    to l2 on the order key with l2_suppkey <> l_suppkey, left-anti-joined
    to l3 (late lines) with the same condition, then inner joins to the
    suppliers, the orders with o_orderstatus = 'F' and the nation
    `nation` (clause 2.4.21.3's 'SAUDI ARABIA'), each built on the right; count(*) by s_name,
    TopN(100) by numwait DESC, s_name. l2 and l3 are the lineitem scan
    under renaming projections."""
    col, lit, pr, b = m.core.col, m.core.lit, m.pred, m.basic
    l1 = b.FilterExec(pr.GreaterThan(col("l_receiptdate"),
                                     col("l_commitdate")), lines_scan)
    l3 = b.FilterExec(pr.GreaterThan(col("l3_receiptdate"),
                                     col("l3_commitdate")), l3_scan)
    semi = m.joins.HashJoinExec(
        l1, l2_scan, [col("l_orderkey")], [col("l2_orderkey")], "left_semi",
        build_side="right", condition=ne(m, "l2_suppkey", "l_suppkey"))
    anti = m.joins.HashJoinExec(
        semi, l3, [col("l_orderkey")], [col("l3_orderkey")], "left_anti",
        build_side="right", condition=ne(m, "l3_suppkey", "l_suppkey"))
    with_s = m.joins.HashJoinExec(anti, supp_scan, [col("l_suppkey")],
                                  [col("s_suppkey")], "inner")
    orders = b.FilterExec(pr.EqualTo(col("o_orderstatus"), lit("F")),
                          orders_scan)
    with_o = m.joins.HashJoinExec(with_s, orders, [col("l_orderkey")],
                                  [col("o_orderkey")], "inner")
    nation = b.FilterExec(pr.EqualTo(col("n_name"), lit(nation)),
                          nation_scan)
    with_n = m.joins.HashJoinExec(with_o, nation, [col("s_nationkey")],
                                  [col("n_nationkey")], "inner")
    agg = m.agg.AggregateExec([col("s_name")],
                              [(m.aggexprs.Count(), "numwait")], with_n)
    return m.sort.TopNExec(Q21_LIMIT, [(col("numwait"), False),
                                       (col("s_name"), True)], agg)


def l2_exprs(m):
    col = m.core.col
    return [col("l_orderkey").alias("l2_orderkey"),
            col("l_suppkey").alias("l2_suppkey")]


def l3_exprs(m):
    col = m.core.col
    return [col("l_orderkey").alias("l3_orderkey"),
            col("l_suppkey").alias("l3_suppkey"),
            col("l_commitdate").alias("l3_commitdate"),
            col("l_receiptdate").alias("l3_receiptdate")]


def q21_plan(m, batches, nation=Q21_NATION):
    """Q21 over in-memory scans of tpch_join_data's batches (a dict by
    table, of the package `m` holds)."""
    def scan(k):
        return m.basic.InMemoryScanExec([batches[k]], batches[k].schema)
    return q21_tree(m, scan("lineitem"),
                    m.basic.ProjectExec(l2_exprs(m), scan("lineitem")),
                    m.basic.ProjectExec(l3_exprs(m), scan("lineitem")),
                    scan("supplier"), scan("orders"), scan("nation"),
                    nation)


def q21_join(plan, depth):
    """The exec `depth` steps down q21_tree's left spine: 5 is the anti
    join, 6 the semi join."""
    for _ in range(depth):
        plan = plan.children[0]
    return plan


def q4_plan(m, batches, anti=False, n_parts=None):
    def scan(k):
        return m.basic.InMemoryScanExec([batches[k]], batches[k].schema)
    return q4_tree(m, scan("orders"), scan("lineitem"), anti, n_parts)


def q21_oracle(d, nation=Q21_NATION):
    """Q21 in numpy: (s_name, numwait), numwait descending then s_name,
    the first 100."""
    lok, supp = d["l_orderkey"], d["l_suppkey"]
    late = d["l_receiptdate"] > d["l_commitdate"]
    oi = order_index(lok)
    n_orders = d["o_orderkey"].shape[0]
    pair = oi * (supp.max() + 1) + supp

    def per_order(mask):
        return np.bincount(oi[mask], minlength=n_orders)

    def per_pair(mask):
        u, inv = np.unique(pair[mask], return_inverse=True)
        counts = np.bincount(inv, minlength=u.shape[0])
        pos = np.clip(np.searchsorted(u, pair), 0, max(u.shape[0] - 1, 0))
        return np.where(u[pos] == pair, counts[pos], 0) if u.shape[0] \
            else np.zeros_like(pair)
    everything = np.ones_like(late)
    other_lines = per_order(everything)[oi] - per_pair(everything)
    other_late = per_order(late)[oi] - per_pair(late)
    status = d["o_orderstatus"][0][oi]
    keep = late & (other_lines > 0) & (other_late == 0) \
        & (status == ORDER_STATUSES.index("F")) \
        & (d["s_nationkey"][supp - 1] == NATIONS.index(nation))
    counts = np.bincount(supp[keep] - 1, minlength=d["s_suppkey"].shape[0])
    names = d["s_name"][1]
    rows = [(names[k], int(counts[k])) for k in np.nonzero(counts)[0]]
    rows.sort(key=lambda r: (-r[1], r[0]))
    return rows[:Q21_LIMIT]


def q4_df(m, sess, batches, anti=False, sort=True):
    """Q4 as a DataFrame query (how="left_semi", or "left_anti")."""
    col, pr, F = m.core.col, m.pred, m.F
    orders = sess.from_batches([batches["orders"]],
                               batches["orders"].schema).filter(pr.And(
        pr.GreaterThanOrEqual(col("o_orderdate"), date_lit(m, Q4_DATE)),
        pr.LessThan(col("o_orderdate"), date_lit(m, Q4_END))))
    lines = sess.from_batches([batches["lineitem"]],
                              batches["lineitem"].schema).filter(
        pr.LessThan(col("l_commitdate"), col("l_receiptdate")))
    q = orders.join(lines, left_on="o_orderkey", right_on="l_orderkey",
                    how="left_anti" if anti else "left_semi") \
        .group_by("o_orderpriority").agg((F.count(), "order_count"))
    return q.sort("o_orderpriority") if sort else q


def q21_df(m, sess, batches, nation=Q21_NATION):
    """Q21 as a DataFrame query: the semi and anti joins with their
    conditions (how="left_semi", "left_anti"), then the inner joins."""
    col, lit, pr, F = m.core.col, m.core.lit, m.pred, m.F

    def df(k):
        return sess.from_batches([batches[k]], batches[k].schema)
    lines = df("lineitem")
    l1 = lines.filter(pr.GreaterThan(col("l_receiptdate"),
                                     col("l_commitdate")))
    l2 = lines.select(*l2_exprs(m))
    l3 = lines.select(*l3_exprs(m)).filter(
        pr.GreaterThan(col("l3_receiptdate"), col("l3_commitdate")))
    return (l1.join(l2, left_on="l_orderkey", right_on="l2_orderkey",
                    how="left_semi", condition=ne(m, "l2_suppkey",
                                                  "l_suppkey"))
            .join(l3, left_on="l_orderkey", right_on="l3_orderkey",
                  how="left_anti", condition=ne(m, "l3_suppkey",
                                                "l_suppkey"))
            .join(df("supplier"), left_on="l_suppkey", right_on="s_suppkey")
            .join(df("orders").filter(pr.EqualTo(col("o_orderstatus"),
                                                 lit("F"))),
                  left_on="l_orderkey", right_on="o_orderkey")
            .join(df("nation").filter(pr.EqualTo(col("n_name"),
                                                 lit(nation))),
                  left_on="s_nationkey", right_on="n_nationkey")
            .group_by("s_name").agg((F.count(), "numwait"))
            .sort((col("numwait"), False), "s_name").limit(Q21_LIMIT))


def p14_tree(m, orders_scan, lines_scan, jt, build):
    """P14: q3's filtered sides (lineitems l_flag != 0 on the left, orders
    o_flag < 5 on the right) joined on the order key under `jt`, built
    on `build`."""
    col, lit, b = m.core.col, m.core.lit, m.basic
    lines = b.FilterExec(col("l_flag") != lit(0), lines_scan)
    orders = b.FilterExec(col("o_flag") < lit(5), orders_scan)
    return m.joins.HashJoinExec(lines, orders, [col("l_orderkey")],
                                [col("o_orderkey")], jt, build_side=build)


def p14_plans(m, d3, dev):
    """P14's plans over q3's LONG-key batches, made once: a function of
    (join type, build side)."""
    o_schema, l_schema = q3_schemas("LONG")
    o_b = q3_batches(d3, dev, o_schema, Q3_ORDERS)
    l_b = q3_batches(d3, dev, l_schema, Q3_LINES)
    return lambda jt, build: p14_tree(
        m, m.basic.InMemoryScanExec(o_b, o_schema),
        m.basic.InMemoryScanExec(l_b, l_schema), jt, build)


def p14_oracle(d, jt):
    """P14 in numpy: (rows, sorted left keys, sorted right keys, left
    nulls, right nulls) — the keys of the non-null rows; existence's
    right "keys" are its flags."""
    lk = d["l_orderkey"][d["l_flag"] != 0]
    ok = d["o_orderkey"][d["o_flag"] < 5]
    hit = np.isin(lk, ok)
    o_hit = np.isin(ok, lk)
    if jt == "left_semi":
        return len(lk[hit]), np.sort(lk[hit]), None, 0, 0
    if jt == "left_anti":
        return len(lk[~hit]), np.sort(lk[~hit]), None, 0, 0
    if jt == "existence":
        return len(lk), np.sort(lk), np.sort(hit), 0, 0
    left = [lk[hit]]
    right = [lk[hit]]
    l_null = r_null = 0
    if jt in ("left_outer", "full_outer"):
        left.append(lk[~hit])
        r_null = int((~hit).sum())
    if jt in ("right_outer", "full_outer"):
        right.append(ok[~o_hit])
        l_null = int((~o_hit).sum())
    rows = int(hit.sum()) + r_null + l_null
    return (rows, np.sort(np.concatenate(left)),
            np.sort(np.concatenate(right)), l_null, r_null)


def p14_check(batches, d, jt, label):
    """P14's output against p14_oracle: the row count, both sides' key
    multisets and null counts, read from the device tensors."""
    n = [b.num_rows_host for b in batches]
    rows = sum(n)
    want = p14_oracle(d, jt)
    ncols = len(batches[0].columns) if batches else 0

    def side(i):
        if not batches:
            return np.zeros(0, np.int64), 0
        data = np.concatenate([b.columns[i].data[:k].cpu().numpy()
                               for b, k in zip(batches, n)])
        valid = np.concatenate([b.columns[i].validity[:k].cpu().numpy()
                                for b, k in zip(batches, n)])
        return np.sort(data[valid]), int((~valid).sum())
    lkeys, l_null = side(0)
    right = side(4) if jt not in ("left_semi", "left_anti") \
        and ncols > 4 else (None, 0)
    rkeys, r_null = right
    got = (rows, lkeys, rkeys, l_null, r_null)
    ok = rows == want[0] and np.array_equal(lkeys, want[1]) \
        and (want[2] is None or np.array_equal(rkeys, want[2])) \
        and l_null == want[3] and r_null == want[4]
    if not ok:
        raise AssertionError(f"{label}: rows {rows}, nulls ({l_null}, "
                             f"{r_null}) != oracle rows {want[0]}, nulls "
                             f"({want[3]}, {want[4]}), or the keys differ")
    return got


def p15_df(m, sess, lines, bands):
    """P15: the lineitems (l_discount, l_orderkey) left-outer-joined to
    the discount bands with no equi-key, on l_discount >= lo AND
    l_discount < hi (Spark's BroadcastNestedLoopJoin), then count(*) by
    band."""
    col, pr, F = m.core.col, m.pred, m.F
    cond = pr.And(pr.GreaterThanOrEqual(col("l_discount"), col("lo")),
                  pr.LessThan(col("l_discount"), col("hi")))
    return (sess.from_batches([lines], lines.schema)
            .join(sess.from_batches([bands], bands.schema),
                  how="left_outer", condition=cond)
            .group_by("band").agg((F.count(), "lines")))


def p15_batches(d, dev):
    """P15's inputs: the first P15_LINES lineitems' discount and order
    key, and the P15_BANDS bands."""
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column
    n = min(P15_LINES, d["l_discount"].shape[0])
    ls = t.Schema((t.StructField("l_discount", t.DOUBLE),
                   t.StructField("l_orderkey", t.LONG)))
    lines = ColumnarBatch([Column.from_numpy(d["l_discount"][:n], t.DOUBLE,
                                             device=dev),
                           Column.from_numpy(d["l_orderkey"][:n], t.LONG,
                                             device=dev)], n, ls)
    k = np.arange(P15_BANDS)
    bs = t.Schema((t.StructField("band", t.INT), t.StructField("lo", t.DOUBLE),
                   t.StructField("hi", t.DOUBLE)))
    bands = ColumnarBatch([Column.from_numpy(k.astype(np.int32), t.INT,
                                             device=dev),
                           Column.from_numpy(k / 100.0, t.DOUBLE, device=dev),
                           Column.from_numpy((k + 1) / 100.0, t.DOUBLE,
                                             device=dev)], P15_BANDS, bs)
    return lines, bands


def p15_oracle(d):
    n = min(P15_LINES, d["l_discount"].shape[0])
    disc = d["l_discount"][:n]
    band = np.floor(disc * 100 + 0.5).astype(np.int64)
    lo, hi = np.arange(P15_BANDS) / 100.0, (np.arange(P15_BANDS) + 1) / 100.0
    ok = (disc >= lo[band]) & (disc < hi[band])   # each line in its band
    if not ok.all():
        raise AssertionError("P15: a discount outside its band")
    counts = np.bincount(band, minlength=P15_BANDS)
    return sorted((int(k), int(c)) for k, c in enumerate(counts) if c)


def basic_dfs(m, sess, batches, q1t_batch):
    """The basic operators planned from DataFrames: a range summed, the
    union of the orders' two halves counted by priority, a limit with an
    offset, and TPC-H Q1's aggregate over the grouping sets
    ((l_returnflag, l_linestatus), ()) through an Expand."""
    col, lit, F, L = m.core.col, m.core.lit, m.F, m.L
    halves = [sess.from_batches([b], b.schema)
              for b in batches["orders_halves"]]
    t = m.t
    sets = [[col("l_returnflag"), col("l_linestatus"), col("l_quantity"),
             lit(0).alias("gid")],
            [m.core.Literal(None, t.STRING).alias("l_returnflag"),
             m.core.Literal(None, t.STRING).alias("l_linestatus"),
             col("l_quantity"), lit(3).alias("gid")]]
    lines = sess.from_batches([q1t_batch], q1t_batch.schema)
    expand = m.session.DataFrame(
        L.LogicalExpand(sets, lines.logical_plan()), sess)
    return {
        "range": sess.range(0, 1 << 24).agg((F.sum("id"), "total")),
        "union": halves[0].union(halves[1]).group_by("o_orderpriority")
        .agg((F.count(), "orders")),
        "limit": halves[0].select(col("o_orderkey"), col("o_orderdate"))
        .limit(100, offset=1000),
        "expand": expand.group_by("l_returnflag", "l_linestatus", "gid")
        .agg((F.sum("l_quantity"), "sum_qty"), (F.count(), "n"))}


def basic_oracles(d, d19):
    n_orders = d["o_orderkey"].shape[0]
    counts = np.bincount(d["o_orderpriority"][0], minlength=5)
    rf = np.asarray(d19["l_returnflag"][1])[d19["l_returnflag"][0]]
    ls = np.asarray(d19["l_linestatus"][1])[d19["l_linestatus"][0]]
    qty = d19["l_quantity"]
    expand = [(None, None, 3, float(qty.sum()), int(qty.shape[0]))]
    for f, s in sorted(set(zip(rf, ls))):
        g = (rf == f) & (ls == s)
        expand.append((str(f), str(s), 0, float(qty[g].sum()),
                       int(g.sum())))
    half = n_orders // 2
    return {
        "range": [((1 << 24) * ((1 << 24) - 1) // 2,)],
        "union": sorted((ORDER_PRIORITIES[k], int(counts[k]))
                        for k in range(5)),
        "limit": [(int(d["o_orderkey"][i]), int(d["o_orderdate"][i]))
                  for i in range(1000, 1100)],
        "expand": sorted(expand, key=repr), "half": half}


def check_basic(label, rows, want):
    """A basic operator's rows against its oracle: exact, the expand's
    sums to rtol 1e-9 (summation order)."""
    if label in ("union", "expand"):
        rows = sorted(rows, key=repr)
    ok = len(rows) == len(want)
    for got, w in zip(rows, want):
        for g, x in zip(got, w):
            if isinstance(x, float):
                ok = ok and g is not None and abs(g - x) <= RTOL * abs(x)
            else:
                ok = ok and g == x
    if not ok:
        raise AssertionError(f"{label}: {rows[:5]}... != oracle "
                             f"{want[:5]}...")


def join_session_modules():
    """session_modules() with the port's types and logical plans."""
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.plan import logical
    m = session_modules()
    m.t, m.L = t, logical
    return m


def exact_rows(want):
    def check(rows, label, _metrics=None):
        if rows != want:
            raise AssertionError(f"{label}: {rows[:8]} != oracle {want[:8]}")
    return check


def sorted_rows(want):
    def check(rows, label, _metrics=None):
        if sorted(rows, key=repr) != sorted(want, key=repr):
            raise AssertionError(f"{label}: {sorted(rows)[:8]} != oracle "
                                 f"{sorted(want)[:8]}")
    return check


Q_NEED = ["murmur3_columns", "fused_probe_verify", "dma_row_gather"]


def drive_join_paths(dev, d, batches, d3, d19, q1t_batch):
    """Phase 3d: P12 (Q4), P13 (Q21), P14 (q3's join under each join
    type), P15 (the nested-loop band join), P16 (Q4's semi and anti joins
    over the host shuffle) and the basic operators, each held to its
    numpy oracle with its launches counted. Returns (counts by path,
    records, the runs phase 4 times)."""
    pm, sm = port_modules(), join_session_modules()
    TpuSession = sm.session.TpuSession
    counts, recs, runs = {}, {}, {}
    q4_want, q4_anti_want = q4_oracle(d), q4_oracle(d, anti=True)
    q21_want = q21_oracle(d)
    print(f"P12-P16 data (TPC-H clause 4.2.3, SF{TPCH_SF:g}): "
          f"{d['o_orderkey'].shape[0]} orders, {d['l_orderkey'].shape[0]} "
          f"lineitems, {d['s_suppkey'].shape[0]} suppliers, 25 nations")

    # P12: Q4, hand-built then planned at the default confs
    q4 = q4_plan(pm, batches)
    rows, counts["P12"] = drive_counted("P12 Q4", q4, Q_NEED)
    exact_rows(q4_want)(rows, "P12 Q4")
    print(f"P12 TPC-H Q4 (left_semi): {rows} equal to the numpy oracle; "
          f"launches {counts['P12']}")
    recs["P12_planned"] = drive_planned(
        "P12 Q4 planned", sm, q4_df(sm, TpuSession(device=dev), batches),
        Q_NEED, counts["P12"], exact_rows(q4_want))
    runs["P12"] = (lambda: q4.collect(), exact_rows(q4_want))

    # P13: Q21, hand-built then planned with broadcasts off
    q21 = q21_plan(pm, batches)
    rows, counts["P13"] = drive_counted("P13 Q21", q21,
                                        ["dict_gather"] + Q_NEED)
    exact_rows(q21_want)(rows, "P13 Q21")
    semi = q21_join(q21, 6)
    print(f"P13 TPC-H Q21 (left_semi, left_anti, 3 inner joins, TopN by a "
          f"string): {len(rows)} rows equal to the numpy oracle, first "
          f"{rows[:3]}; launches {counts['P13']}; semi join output "
          f"{semi.metrics['numOutputRows'].value} rows")
    recs["P13_planned"] = drive_planned(
        "P13 Q21 planned", sm,
        q21_df(sm, TpuSession(Q21_CONF, dev), batches),
        ["dict_gather"] + Q_NEED, counts["P13"], exact_rows(q21_want))
    runs["P13"] = (lambda: q21.collect(), exact_rows(q21_want))

    # P14: q3's filtered sides under each join type
    p14 = p14_plans(pm, d3, dev)
    recs["P14"] = {}
    for jt, build in P14_KINDS:
        label = f"P14 {jt} build {build}"

        def tree(jt=jt, build=build):
            return p14(jt, build)
        need = Q_NEED if jt != "existence" else Q_NEED[:2]
        out, c, _ = drive_batches(label, tree(), need)
        rows_, _, _, ln, rn = p14_check(out, d3, jt, label)
        counts[f"P14_{jt}_{build}"] = c
        recs["P14"][f"{jt}_{build}"] = {"rows": rows_, "left_nulls": ln,
                                        "right_nulls": rn, "launches": c}
        runs[f"P14 {jt} {build}"] = (tree, None)
        print(f"{label}: {rows_} rows, nulls left {ln} right {rn}, keys "
              f"equal to the numpy oracle; launches {c}")

    # P15: the nested-loop band join, planned
    lines15, bands15 = p15_batches(d, dev)
    p15_want = p15_oracle(d)
    p15 = p15_df(sm, TpuSession(P15_CONF, dev), lines15, bands15)
    recs["P15"] = drive_planned("P15 band join planned", sm, p15,
                                ["dma_row_gather"], None,
                                sorted_rows(p15_want))
    counts["P15"] = recs["P15"]["launches"]
    if "NestedLoopJoinExec" not in recs["P15"]["shape"]:
        raise AssertionError(f"P15: planned {recs['P15']['shape']}")
    runs["P15"] = (p15.collect, sorted_rows(p15_want))

    # P16: Q4's semi and anti joins over the host shuffle, planned, at the
    # default tier (each partition pair sizes its own buckets)
    for anti, want in ((False, q4_want), (True, q4_anti_want)):
        key = "P16_anti" if anti else "P16_semi"
        p16 = q4_df(sm, TpuSession(P16_CONF, dev), batches, anti,
                    sort=False)
        recs[key] = drive_planned(f"{key} Q4 shuffled planned", sm, p16,
                                  Q_NEED, None, sorted_rows(want))
        counts[key] = recs[key]["launches"]
        if "ShuffledHashJoinExec" not in recs[key]["shape"]:
            raise AssertionError(f"{key}: planned {recs[key]['shape']}")
        runs[key] = (p16.collect, sorted_rows(want))

    # Range, Union, Limit and Expand, planned
    half = d["o_orderkey"].shape[0] // 2
    n_orders = d["o_orderkey"].shape[0]
    batches = dict(batches, orders_halves=[
        join_batch(d, "orders", dev, slice(0, half)),
        join_batch(d, "orders", dev, slice(half, n_orders))])
    dfs = basic_dfs(sm, TpuSession(device=dev), batches, q1t_batch)
    wants = basic_oracles(d, d19)
    recs["basic"] = {}
    for label, df in dfs.items():
        rec = drive_planned(
            f"{label} planned", sm, df, [], None,
            lambda r, lb, _m, label=label: check_basic(label, r,
                                                       wants[label]))
        recs["basic"][label] = rec
        counts[f"basic_{label}"] = rec["launches"]
    return counts, recs, runs


def time_join_paths(runs):
    """Phase 4: each path of phase 3d, P_JOIN_ITERS runs, one
    synchronisation a run: P12's and P13's hand-built plans collect()ed,
    P14's joins executed on the card, P15 and P16 through the session
    (df.collect(), the plan included)."""
    import torch
    out = {}
    for label, (run, check) in runs.items():
        ms = []
        for _ in range(P_JOIN_ITERS):
            t0 = time.perf_counter()
            if check is None:
                list(run().execute())
                torch.cuda.synchronize()
            else:
                rows = run()
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if check is not None:
                check(rows, f"{label} timed")
        out[label] = ms
        print(f"{label} ms per run ({P_JOIN_ITERS}): "
              f"{[round(x, 3) for x in ms]}")
    check_idle("phase 3d timed")
    return out


#: P14's joins whose kernels phase 2 holds to their plain versions: the
#: unmatched stream tail, the unmatched build rows, and both
P14_COMPARED = (("left_outer", "right"), ("left_outer", "left"),
                ("full_outer", "right"))
#: the join's row gather sites (GATHER_SITES) that phase 2 must reach
JOIN_GATHER_SITES = ("build permute", "semi/anti compaction",
                     "unmatched build rows", "nested-loop chunk",
                     "stream payload", "build payload")


def compare_join_paths(dev, d, batches, d3, sites):
    """Phase 2 for phase 3d's other paths, each kernel against its plain
    version, exactly, at the path's own inputs: P12's semi join (hash,
    probe, every row gather), P14's outer joins in P14_COMPARED, every
    row gather of P15's planned nested-loop join, and P16's planned semi
    join (every row gather, the join's kernels at its first partition
    pair). Fails unless every label of JOIN_GATHER_SITES was met here or
    in `sites` (the sites P13's capture met)."""
    from spark_rapids_tpu_torch.config import RapidsConf, set_active_conf
    pm, sm = port_modules(), join_session_modules()
    sites = set(sites)

    def compare(label, calls, inputs=None):
        sites.update(site for site, *_ in calls)
        if inputs is not None:
            compare_join_inputs(label, inputs, calls)
        else:
            print(f"compare {label} main-path row gathers: "
                  f"{'; '.join(compare_row_gathers(label, calls))}; exact")

    compare("P12 Q4 semi join", capture_row_gathers(q4_plan(pm, batches)),
            JoinInputs(find_exec(q4_plan(pm, batches), "HashJoinExec")))
    p14 = p14_plans(pm, d3, dev)
    for jt, build in P14_COMPARED:
        compare(f"P14 {jt} build {build}",
                capture_row_gathers(p14(jt, build)),
                JoinInputs(p14(jt, build)))
    sess15 = sm.session.TpuSession(P15_CONF, dev)
    compare("P15 band join planned", capture_row_gathers(planned(
        sm, p15_df(sm, sess15, *p15_batches(d, dev)))[0]))

    def p16():
        sess = sm.session.TpuSession(P16_CONF, dev)
        return planned(sm, q4_df(sm, sess, batches, sort=False))[0]
    compare("P16 Q4 shuffled semi join planned (its first partition pair)",
            capture_row_gathers(p16()),
            shuffled_join_inputs(find_exec(p16(), "ShuffledHashJoinExec")))
    set_active_conf(RapidsConf())     # the sessions' confs are not kept
    missing = [label for label in JOIN_GATHER_SITES if label not in sites]
    if missing:
        raise AssertionError(f"phase 2: no join row gather compared at "
                             f"{missing}")


def find_exec(tree, name):
    """The first exec of class `name` in `tree`, depth first."""
    return next(n for n in exec_nodes(tree) if type(n).__name__ == name)


def q21_kernel_shapes(batches, launches):
    """fused_probe_verify and dma_row_gather at Q21's shapes: the probe
    at the semi and the anti join's inputs (time_probe_shape), every row
    gather of a run of the plan (time_gather_call)."""
    pm = port_modules()
    probes = {}
    for key, depth in (("semi", 6), ("anti", 5)):
        j = q21_join(q21_plan(pm, batches), depth)
        probes[key] = dict(time_probe_shape(f"Q21 {key}", JoinInputs(j)),
                           launches=launches)
    gathers = [time_gather_call("P13", *call, generic=False)
               for call in capture_row_gathers(q21_plan(pm, batches))]
    return probes, gathers


# -- slice 10: decimals, dates and the rest of A.8 wave 1 (phase 3e) --------

#: TPC-H's substitution values: Q1 (clause 2.4.1.3), Q6 (2.4.6.3), Q3
#: (2.4.3.3); every money column is DECIMAL(12, 2), as the spec defines it
Q1_DATE, Q1_DELTA = datetime.date(1998, 12, 1), 90
Q6_DATE, Q6_DISCOUNT, Q6_QUANTITY = datetime.date(1994, 1, 1), 6, 24
Q3_SEGMENT, Q3_DATE = "BUILDING", datetime.date(1995, 3, 15)
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
MONEY = (12, 2)
P20_FRACTION, P20_SEED = 0.1, 7
P20_ZONE = "+05:30"
P20_ZONE_US = (5 * 3600 + 30 * 60) * 1_000_000
#: P19 and P20 plan with broadcasts off (a join whose side is a join
#: takes AdaptiveJoinExec at the default confs, ROADMAP A.3 / A.9); P20's
#: sort plans over P_PARTS host partitions
P19_CONF = Q21_CONF
P20_SORT_CONF = dict(Q3_CONF, **{"spark.rapids.sql.shuffle.partitions":
                                 str(P_PARTS)})
P_TYPES_ITERS = 3        # phase 4's timed runs of P17-P20 each
TYPES_NEED = {"P17": ["dma_row_gather"], "P18": ["dma_row_gather"],
              "P19": ["murmur3_columns", "fused_probe_verify",
                      "dma_row_gather", "dict_gather"],
              "P20 sample": ["dma_row_gather"],
              "P20 sort": ["dma_row_gather"], "P20 year": []}


def money(x):
    """Unscaled DECIMAL(12, 2) lanes (int64 cents) of a float column whose
    values are whole cents."""
    return np.rint(np.asarray(x) * 100).astype(np.int64)


def decimal_lines(d):
    """P17's and P18's lineitems on true types, from q19_data's draws (P6's
    6,001,215 lines at SF1): the money columns as unscaled DECIMAL(12, 2)
    (l_extendedprice from the integer quantity and clause 4.2.3's retail
    price in cents), l_shipdate a DATE, the flags as dictionaries."""
    pk = d["l_partkey"]
    retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    qty = d["l_quantity"].astype(np.int64)
    return {"l_quantity": qty * 100, "l_extendedprice": qty * retail,
            "l_discount": money(d["l_discount"]), "l_tax": money(d["l_tax"]),
            "l_shipdate": d["l_shipdate"],
            "l_returnflag": d["l_returnflag"],
            "l_linestatus": d["l_linestatus"]}


def types_batch(m, cols, dev):
    """A port batch of {name: numpy lane or (codes, values)}: an int64
    lane whose name is a money column is DECIMAL(12, 2), an int32 lane
    named *date a DATE, (codes, values) a DictionaryColumn."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column, string_buffers
    from spark_rapids_tpu_torch.columnar.encoded import dictionary_from_numpy
    t = m.t
    fields, out, n = [], [], None
    for name, v in cols.items():
        if isinstance(v, tuple):
            out.append(dictionary_from_numpy(v[0], *string_buffers(v[1]),
                                             device=dev))
            dt, n = t.STRING, v[0].shape[0]
        else:
            dt = t.DecimalType(*MONEY) if name.split("_")[-1] in (
                "quantity", "extendedprice", "discount", "tax") \
                else t.DATE if name.endswith("date") \
                else t.INT if v.dtype == np.int32 else t.LONG
            out.append(Column.from_numpy(v, dt, device=dev))
            n = v.shape[0]
        fields.append(t.StructField(name, dt))
    return ColumnarBatch(out, n, t.Schema(tuple(fields)))


def dec_lit(m, unscaled):
    return m.core.Literal(int(unscaled), m.t.DecimalType(*MONEY))


def q1_types_df(m, sess, batch):
    """P17: TPC-H Q1 (clause 2.4.1, DELTA 90) on DECIMAL and DATE columns:
    l_shipdate <= date_sub(DATE '1998-12-01', 90), grouped and ordered by
    the two flags, with sum_qty, sum_base_price, sum_disc_price and
    count(*). The three avg columns are left out (the JAX package's
    decimal avg raises) and sum_charge too (a decimal128 multiply, tagged
    off in both packages)."""
    col, lit, F = m.core.col, m.core.lit, m.F
    price, disc = col("l_extendedprice"), col("l_discount")
    cutoff = F.date_sub(date_lit(m, Q1_DATE), lit(Q1_DELTA))
    return (sess.from_batches([batch], batch.schema)
            .filter(m.pred.LessThanOrEqual(col("l_shipdate"), cutoff))
            .group_by("l_returnflag", "l_linestatus")
            .agg((F.sum("l_quantity"), "sum_qty"),
                 (F.sum(price), "sum_base_price"),
                 (F.sum(price * (lit(1) - disc)), "sum_disc_price"),
                 (F.count(), "count_order"))
            .sort("l_returnflag", "l_linestatus"))


def q1_types_oracle(dl):
    """P17 exactly: unscaled Python ints (DECIMAL(22, 2), (22, 2),
    (36, 4)) per group in ORDER BY order."""
    keep = dl["l_shipdate"] <= days(Q1_DATE) - Q1_DELTA
    rf = np.asarray(dl["l_returnflag"][1])[dl["l_returnflag"][0]]
    ls = np.asarray(dl["l_linestatus"][1])[dl["l_linestatus"][0]]
    dp = dl["l_extendedprice"] * (100 - dl["l_discount"])
    rows = []
    for f, s in sorted(set(zip(rf[keep], ls[keep]))):
        g = keep & (rf == f) & (ls == s)
        rows.append((f, s, int(dl["l_quantity"][g].sum()),
                     int(dl["l_extendedprice"][g].sum()),
                     int(dp[g].sum()), int(g.sum())))
    return rows


def q6_types_df(m, sess, batch):
    """P18: TPC-H Q6 (clause 2.4.6: DATE 1994-01-01, DISCOUNT 0.06,
    QUANTITY 24), the year's end through add_months: a grand
    sum(l_extendedprice * l_discount), DECIMAL(25, 4) summed to
    DECIMAL(35, 4)."""
    col, pr, F = m.core.col, m.pred, m.F
    start = date_lit(m, Q6_DATE)
    cond = pr.And(pr.And(
        pr.GreaterThanOrEqual(col("l_shipdate"), start),
        pr.LessThan(col("l_shipdate"), F.add_months(start, 12))), pr.And(
        pr.And(pr.GreaterThanOrEqual(col("l_discount"),
                                     dec_lit(m, Q6_DISCOUNT - 1)),
               pr.LessThanOrEqual(col("l_discount"),
                                  dec_lit(m, Q6_DISCOUNT + 1))),
        pr.LessThan(col("l_quantity"), dec_lit(m, Q6_QUANTITY * 100))))
    return (sess.from_batches([batch], batch.schema).filter(cond)
            .agg((F.sum(col("l_extendedprice") * col("l_discount")),
                  "revenue")))


def q6_types_oracle(dl):
    sd, disc = dl["l_shipdate"], dl["l_discount"]
    end = datetime.date(Q6_DATE.year + 1, Q6_DATE.month, Q6_DATE.day)
    keep = (sd >= days(Q6_DATE)) & (sd < days(end)) \
        & (disc >= Q6_DISCOUNT - 1) & (disc <= Q6_DISCOUNT + 1) \
        & (dl["l_quantity"] < Q6_QUANTITY * 100)
    rev = (dl["l_extendedprice"] * disc)[keep]
    return [(int(rev.sum()) if keep.any() else None,)]


def q3_types_data(dj, seed=23):
    """P19's columns beside tpch_join_data's (drawn from their own seed so
    that P12-P16's data stay as they were): clause 4.2.3's customers
    (c_custkey 1..150,000 x SF, c_mktsegment of five values), o_custkey
    (never a multiple of 3, as the spec's rule leaves a third of the
    customers without orders), o_shippriority (0), and the lines'
    l_extendedprice (quantity x retail price in cents, over a random
    part) and l_discount as DECIMAL(12, 2)."""
    rng = np.random.default_rng(seed)
    n_orders, n_line = dj["o_orderkey"].shape[0], dj["l_orderkey"].shape[0]
    n_cust = max(n_orders // 10, 3)
    cust = rng.integers(1, n_cust + 1, n_orders)
    cust = np.where(cust % 3 == 0, np.maximum(cust - 1, 1), cust)
    pk = rng.integers(1, max(n_orders // 7.5, 1) + 1, n_line)
    retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    qty = rng.integers(1, 51, n_line)
    return {"c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
            "c_mktsegment": (rng.integers(0, 5, n_cust).astype(np.int32),
                             SEGMENTS),
            "o_custkey": cust.astype(np.int64),
            "o_shippriority": np.zeros(n_orders, np.int32),
            "l_extendedprice": (qty * retail).astype(np.int64),
            "l_discount": money(dj["l_discount"])}


def q3_types_tables(dj, q3d):
    return {"customer": {k: q3d[k] for k in ("c_custkey", "c_mktsegment")},
            "orders": {"o_orderkey": dj["o_orderkey"],
                       "o_custkey": q3d["o_custkey"],
                       "o_orderdate": dj["o_orderdate"],
                       "o_shippriority": q3d["o_shippriority"]},
            "lineitem": {"l_orderkey": dj["l_orderkey"],
                         "l_extendedprice": q3d["l_extendedprice"],
                         "l_discount": q3d["l_discount"],
                         "l_shipdate": dj["l_shipdate"]}}


def q3_types_df(m, sess, b):
    """P19: TPC-H Q3 (clause 2.4.3: SEGMENT BUILDING, DATE 1995-03-15):
    customer x orders x lineitem, revenue = sum(l_extendedprice *
    (1 - l_discount)) as decimal128 by (l_orderkey, o_orderdate,
    o_shippriority), its top 10 by revenue desc, o_orderdate."""
    col, lit, pr, F = m.core.col, m.core.lit, m.pred, m.F

    def df(k):
        return sess.from_batches([b[k]], b[k].schema)
    cust = df("customer").filter(pr.EqualTo(col("c_mktsegment"),
                                            lit(Q3_SEGMENT)))
    orders = df("orders").filter(pr.LessThan(col("o_orderdate"),
                                             date_lit(m, Q3_DATE)))
    lines = df("lineitem").filter(pr.GreaterThan(col("l_shipdate"),
                                                 date_lit(m, Q3_DATE)))
    return (cust.join(orders, left_on="c_custkey", right_on="o_custkey")
            .join(lines, left_on="o_orderkey", right_on="l_orderkey")
            .group_by("l_orderkey", "o_orderdate", "o_shippriority")
            .agg((F.sum(col("l_extendedprice")
                        * (lit(1) - col("l_discount"))), "revenue"))
            .sort((col("revenue"), False), "o_orderdate").limit(10))


def q3_types_oracle(dj, q3d):
    """P19 exactly: (l_orderkey, o_orderdate, o_shippriority, revenue as
    unscaled DECIMAL(36, 4)) of the top 10."""
    seg = q3d["c_mktsegment"]
    building = np.zeros(q3d["c_custkey"].shape[0] + 1, bool)
    building[q3d["c_custkey"]] = np.asarray(seg[1])[seg[0]] == Q3_SEGMENT
    cut = days(Q3_DATE)
    o_ok = building[q3d["o_custkey"]] & (dj["o_orderdate"] < cut)
    pos = np.searchsorted(dj["o_orderkey"], dj["l_orderkey"])
    l_ok = o_ok[pos] & (dj["l_shipdate"] > cut)
    rev = q3d["l_extendedprice"] * (100 - q3d["l_discount"])
    n_orders = dj["o_orderkey"].shape[0]
    total = np.zeros(n_orders, np.int64)
    np.add.at(total, pos[l_ok], rev[l_ok])
    idx = np.nonzero(np.bincount(pos[l_ok], minlength=n_orders) > 0)[0]
    order = np.lexsort((dj["o_orderdate"][idx], -total[idx]))[:10]
    return [(int(dj["o_orderkey"][i]), int(dj["o_orderdate"][i]),
             int(q3d["o_shippriority"][i]), int(total[i]))
            for i in idx[order]]


def p20_lines(dj, q3d):
    """P20's lineitems: P19's, with l_orderkey, l_extendedprice and
    l_shipdate."""
    return {"l_orderkey": dj["l_orderkey"],
            "l_extendedprice": q3d["l_extendedprice"],
            "l_shipdate": dj["l_shipdate"]}


def p20_dfs(m, sess, sort_sess, lines, orders):
    """P20, each planned from DataFrames: the lineitems' sample(0.1,
    seed=7) with cast(l_extendedprice as string), round and bround of it,
    two shifts of l_orderkey and from_utc_timestamp at a fixed offset;
    the orders sorted by (o_orderdate, o_orderkey) over P_PARTS host
    partitions (PartitionWiseSortExec); count(*) by year(o_orderdate)
    (Q9's o_year)."""
    col, lit, F = m.core.col, m.core.lit, m.F
    mt, bw = m.math, m.bitwise
    price, key = col("l_extendedprice"), col("l_orderkey")
    sample = (sess.from_batches([lines], lines.schema)
              .sample(P20_FRACTION, seed=P20_SEED)
              .select(key, col("l_shipdate"),
                      price.cast(m.t.STRING).alias("price_str"),
                      mt.Round(price, 0).alias("price_round"),
                      mt.BRound(price, 1).alias("price_bround"),
                      F.shiftleft(key, lit(3)).alias("shl"),
                      F.shiftrightunsigned(-key, lit(60)).alias("ushr"),
                      F.from_utc_timestamp(col("l_shipdate").cast(
                          m.t.TIMESTAMP), P20_ZONE).alias("local")))
    sort = (sort_sess.from_batches([orders], orders.schema)
            .sort("o_orderdate", "o_orderkey"))
    year = (sess.from_batches([orders], orders.schema)
            .select(F.year("o_orderdate").alias("o_year"))
            .group_by("o_year").agg((F.count(), "n")).sort("o_year"))
    return {"P20 sample": sample, "P20 sort": sort, "P20 year": year}


def p20_oracles(lines_np, orders_np, keep):
    """P20's rows from numpy and Python: `keep` is the sample's mask, from
    the port's threefry on the CPU (tests/test_torch_sample_sort.py holds
    it to jax.random)."""
    import decimal
    k = lines_np["l_orderkey"][keep]
    p = lines_np["l_extendedprice"][keep]
    sd = lines_np["l_shipdate"][keep]

    def rnd(v, m, even):
        q, r = divmod(int(v), m)
        up = 2 * r > m or (2 * r == m and (q % 2 == 1 if even else True))
        return (q + up) * m

    def i64(v):
        return (v + 2**63) % 2**64 - 2**63

    ctx = decimal.Context(prec=40)
    sample = [(int(a), int(b), format(decimal.Decimal(int(c)).scaleb(
        -2, ctx), "f"), rnd(c, 100, False), rnd(c, 10, True),
        i64(int(a) << 3), (-int(a) % 2**64) >> 60,
        int(b) * 86_400_000_000 + P20_ZONE_US)
        for a, b, c in zip(k, sd, p)]
    okey, odate = orders_np["o_orderkey"], orders_np["o_orderdate"]
    order = np.lexsort((okey, odate))
    y = (np.datetime64("1970-01-01") + odate.astype("timedelta64[D]")) \
        .astype("datetime64[Y]").astype(np.int64) + 1970
    uy, cnt = np.unique(y, return_counts=True)
    return {"P20 sample": sample,
            "P20 sort": [(int(okey[i]), int(odate[i])) for i in order],
            "P20 year": [(int(a), int(b)) for a, b in zip(uy, cnt)]}


def sample_keep(n, capacity):
    """The rows SampleExec keeps of batch 0 (capacity rows, n active) for
    P20's fraction and seed, from the port's threefry on the CPU."""
    from spark_rapids_tpu_torch.ops import threefry
    k = threefry.fold_in(threefry.key(P20_SEED), 0)
    u = threefry.uniform(k, capacity).numpy()[:n]
    return u < np.float32(P20_FRACTION)


def types_modules():
    """join_session_modules() with the port's math and bitwise
    expressions."""
    from spark_rapids_tpu_torch.expr import bitwise, math
    m = join_session_modules()
    m.math, m.bitwise = math, bitwise
    return m


def types_inputs(dev, d19, dj, q3d):
    """P17-P20's batches on `dev` and their exact oracles."""
    m = types_modules()
    dl = decimal_lines(d19)
    l20np = p20_lines(dj, q3d)
    o20np = {"o_orderkey": dj["o_orderkey"], "o_orderdate": dj["o_orderdate"]}
    b = {"lines": types_batch(m, dl, dev),
         "q3": {k: types_batch(m, v, dev)
                for k, v in q3_types_tables(dj, q3d).items()},
         "l20": types_batch(m, l20np, dev), "o20": types_batch(m, o20np, dev)}
    wants = {"P17": q1_types_oracle(dl), "P18": q6_types_oracle(dl),
             "P19": q3_types_oracle(dj, q3d)}
    keep = sample_keep(b["l20"].num_rows_host, b["l20"].capacity)
    wants.update(p20_oracles(l20np, o20np, keep))
    return m, b, wants


def types_dfs(m, dev, b):
    TpuSession = m.session.TpuSession
    sess = TpuSession(device=dev)
    dfs = {"P17": q1_types_df(m, sess, b["lines"]),
           "P18": q6_types_df(m, sess, b["lines"]),
           "P19": q3_types_df(m, TpuSession(P19_CONF, dev), b["q3"])}
    dfs.update(p20_dfs(m, sess, TpuSession(P20_SORT_CONF, dev), b["l20"],
                       b["o20"]))
    return dfs


def drive_types_paths(dev, m, b, wants):
    """Phase 3e: P17-P20, each planned from DataFrames and held to its
    exact oracle (every decimal to the last digit) with its launches
    counted (drive_planned). Returns (counts, records, the runs phase 4
    times)."""
    dfs = types_dfs(m, dev, b)
    counts, recs, runs = {}, {}, {}
    for label, df in dfs.items():
        check = exact_rows(wants[label])
        recs[label] = drive_planned(f"{label} planned", m, df,
                                    TYPES_NEED[label], None, check)
        counts[label] = recs[label]["launches"]
        # phase 4 times collect() of the planned tree (its rows fetched
        # and turned into Python tuples); --profile traces its execute()
        runs[label] = (planned(m, df)[0].collect, check)
        print(f"{label}: {len(wants[label])} rows equal to the exact "
              f"oracle, first {wants[label][:2]}")
    if "PartitionWiseSortExec" not in recs["P20 sort"]["shape"]:
        raise AssertionError(f"P20 sort: planned {recs['P20 sort']['shape']}")
    if recs["P19"]["shape"].count("HashJoinExec") != 2:
        raise AssertionError(f"P19: planned {recs['P19']['shape']}")
    return counts, recs, runs


@contextlib.contextmanager
def default_conf_after():
    """Put the default conf back as the active one on exit: planning makes
    a session's conf active, and execs built later (P9's, phase 3b's)
    read theirs from the active conf at construction."""
    from spark_rapids_tpu_torch.config import RapidsConf, set_active_conf
    try:
        yield
    finally:
        set_active_conf(RapidsConf())


def p19_joins(m, dev, b):
    """A fresh planned P19 tree and its two hash joins (the upper one
    first)."""
    tree = planned(m, types_dfs(m, dev, b)["P19"])[0]
    return tree, [n for n in exec_nodes(tree)
                  if type(n).__name__ == "HashJoinExec"]


def compare_types_paths(dev, m, b):
    """Phase 2 at P17-P20's own shapes: the murmur3 chain and the probe
    at both of P19's joins' inputs, every row gather of a run of each
    path (P19's group-by and TopN move the decimal limbs as two lanes)
    and every dictionary take of P19 (c_mktsegment = 'BUILDING' on the
    codes), each kernel against its plain version, exactly."""
    from spark_rapids_tpu_torch.ops import join as oj, murmur3_lanes as m3
    pair = [oj.JOIN_HASH_SEED, oj.JOIN_HASH_SEED2]
    for k in range(2):
        inp = JoinInputs(p19_joins(m, dev, b)[1][k])
        _exact(f"murmur3 P19 join {k} build pair",
               m3.murmur3_columns(inp.build_keys, pair),
               m3.murmur3_columns_plain(inp.build_keys, pair))
        _exact(f"murmur3 P19 join {k} stream keys",
               m3.murmur3_columns(inp.stream_keys, pair[:1]),
               m3.murmur3_columns_plain(inp.stream_keys, pair[:1]))
        hits = compare_probe(f"probe P19 join {k}", inp.probe, inp.cand_cap,
                             inp.total)
        print(f"compare P19 join {k}: murmur3 of {inp.build_rows} build "
              f"keys (two seeds) and {inp.stream_rows} stream keys, probe "
              f"of {inp.stream_rows} stream rows into {inp.build_rows} "
              f"build rows, candidate total {inp.total} in {inp.cand_cap} "
              f"slots, {hits} verified pairs; exact")
    gathers = capture_row_gathers(p19_joins(m, dev, b)[0])
    print(f"compare P19 main-path row gathers: "
          f"{'; '.join(compare_row_gathers('P19', gathers))}; exact")
    takes = capture_dict_gathers(p19_joins(m, dev, b)[0])
    print(f"compare P19 main-path dictionary gathers: "
          f"{'; '.join(compare_dict_takes('P19', takes))}; exact")
    # the other paths of phase 3e launch only row gathers: P17's filter
    # compaction and sort (the decimal128 sum buffers as hi/lo lanes),
    # P18's, the sample's compaction, the 16 partitions' sorts, the count
    # by year's
    for label in ("P17", "P18", "P20 sample", "P20 sort", "P20 year"):
        gathers = capture_row_gathers(
            planned(m, types_dfs(m, dev, b)[label])[0])
        print(f"compare {label} main-path row gathers: "
              f"{'; '.join(compare_row_gathers(label, gathers))}; exact")
        del gathers


def p19_kernel_shapes(dev, m, b, counts):
    """Phase 4: each kernel at P19's shapes, L2 cold: the murmur3 chain at
    both joins' build pairs and stream keys, the probe at both joins
    (time_probe_shape), every row gather (time_gather_call) and every
    dictionary take of a run; each with its plain version, bound and
    launches in P19's counted run. Returns {kernel name: record}."""
    import torch
    from spark_rapids_tpu_torch.ops import dict_gather as dg
    from spark_rapids_tpu_torch.ops import join as oj, murmur3_lanes as m3
    reps, plain_reps = KERNEL_REPS, max(3, KERNEL_REPS // 4)
    pair = (oj.JOIN_HASH_SEED, oj.JOIN_HASH_SEED2)
    out = {"murmur3_columns": [], "fused_probe_verify": [],
           "dma_row_gather": [], "dict_gather": []}
    for k in range(2):
        inp = JoinInputs(p19_joins(m, dev, b)[1][k])
        out["fused_probe_verify"].append(
            time_probe_shape(f"P19 join {k}", inp))
        for site, cols, seeds in (("build pair", inp.build_keys, pair),
                                  ("stream", inp.stream_keys, pair[:1])):
            n = cols[0].capacity
            widths = [c.data.element_size() for c in cols]
            ms = device_ms(lambda: m3.murmur3_columns(cols, seeds), reps)
            plain_ms = device_ms(
                lambda: m3.murmur3_columns_plain(cols, seeds), plain_reps)
            b_ms, b_by = bound(n * (sum(w + 1 for w in widths)
                                    + 4 * len(seeds)),
                               n * sum(m3_ops(w, len(seeds))
                                       for w in widths))
            print(f"murmur3_columns P19 join {k} {site} ({n} rows, "
                  f"{len(cols)} columns, {len(seeds)} seeds): {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                  f"{b_ms / ms:.1%} of the bound")
            out["murmur3_columns"].append({
                "site": f"join {k} {site}", "rows": n, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None, "max_abs_err": 0.0})
    out["dma_row_gather"] = [
        time_gather_call("P19", *call, generic=False)
        for call in capture_row_gathers(p19_joins(m, dev, b)[0])]
    for t, i in capture_dict_gathers(p19_joins(m, dev, b)[0]):
        rows, lanes = i.shape
        flat = t.reshape(-1)
        safe = i.clamp(0, t.shape[0] - 1).reshape(-1).long()
        ms = device_ms(lambda: dg.dict_gather(t, i), reps)
        plain_ms = device_ms(lambda: dg.dict_gather_plain(t, i), plain_reps)
        lib_ms = device_ms(lambda: flat[safe], reps) if lanes == 1 \
            else device_ms(lambda: torch.gather(t, 0, i.long()), reps)
        b_ms, b_by = bound(rows * lanes * (4 + t.element_size())
                           + t.shape[0] * lanes * t.element_size(), 0)
        print(f"dict_gather P19 take ({rows}x{lanes} codes into "
              f"{t.shape[0]} entries of {t.element_size()} bytes): "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), library {lib_ms:.4f} ms")
        out["dict_gather"].append({
            "rows": rows, "lanes": lanes, "entries": t.shape[0], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "max_abs_err": 0.0})
    for name, recs in out.items():
        total = sum(r["ms"] for r in recs)
        print(f"{name} at P19's shapes: {counts.get(name, 0)} launches in "
              f"the counted run; {len(recs)} shapes timed, {total:.4f} ms "
              f"summed")
    return {name: {"launches": counts.get(name, 0), "shapes": recs}
            for name, recs in out.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--profile", metavar="TRACE", type=Path,
        help="also profile the q1, q3, q19, P6, P7 and P17-P20 steady "
             "states (device busy share, time by kernel) and write their "
             "Chrome traces to TRACE and TRACE with _q3, _q19, _p6, _p7, "
             "_p17 ... _p20_year before its suffix")
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
    q1t_batch = tpch_q1_batch(d19, dev)
    q1t_want = tpch_q1_oracle(d19)
    p7_want = shipmode_oracle(d19, shipmode_table()[1])
    p7_batches = {enc: shipmode_batches(d19, dev, enc)
                  for enc in (False, True)}
    names = customer_names(P8_NAMES)
    step = ROWS // P9_BATCHES
    p9_batches = [ColumnarBatch([Column.from_numpy(
        d[f.name][i: i + step], f.data_type, capacity=bucket_capacity(step),
        device=dev) for f in schema.fields], step, schema)
        for i in range(0, ROWS, step)]
    dj = tpch_join_data()
    jb = join_batches(dj, dev)
    tm, tb, types_want = types_inputs(dev, d19, dj, q3_types_data(dj))
    print(f"setup: {time.perf_counter() - t0:.1f} s (data, oracles, plans)")

    # -- phase 1: build every kernel at once -------------------------------
    t0 = time.perf_counter()
    sources = [fsa.kernel_source(s) for s in (q1_spec, mm_spec, zoo)] + [
        build.csrc_source(name)
        for name in ("murmur3.cu", "probe_verify.cu", "row_gather.cu",
                     "dict_gather.cu")] + [REPLACED_MURMUR3_SOURCE]
    build.build_all(sources)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(sources)} "
          f"kernel sources (the last is the replaced murmur3, phase 4's "
          f"yardstick)")
    t0 = time.perf_counter()
    from spark_rapids_tpu_torch import native
    native.native_lib()
    print(f"build: {time.perf_counter() - t0:.1f} s for the shuffle's host "
          f"block codec (csrc/blockcodec.cpp, {build.cxx_path()})")
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
    q19_in = JoinInputs(q19._source)
    # every row gather of each path, captured from a run of a fresh plan
    # (the counted runs below start with the join's size cache cold)
    gathers = {"q3": capture_row_gathers(q3_plan(d3, dev, "LONG")),
               "q3 INT keys": capture_row_gathers(q3_plan(d3i, dev, "INT")),
               "q19": capture_row_gathers(q19_plan(port_modules(), l19,
                                                   p19))}
    compare_join_inputs("q3", q3_in, gathers["q3"])
    compare_join_inputs("q3 INT keys", q3i_in, gathers["q3 INT keys"])
    compare_join_inputs("q19", q19_in, gathers["q19"])
    compare_dict_gather(dev, l19)
    # the string paths' own gathers (phase 3b drives them): P6's filter
    # compaction and sort, P7's build permute and payloads, and P7's
    # dictionary-hash takes by the stream's codes
    pm = port_modules()
    gathers["P6"] = capture_row_gathers(tpch_q1_tree(pm,
                                                     scan_of(pm, q1t_batch)))
    p7_takes = {}
    for enc, (lines7, build7) in p7_batches.items():
        key = "P7 dictionary build" if enc else "P7 string build"
        gathers[key] = capture_row_gathers(shipmode_join_tree(
            pm, scan_of(pm, lines7), scan_of(pm, build7)))
        p7_takes[key] = capture_dict_gathers(shipmode_join_tree(
            pm, scan_of(pm, lines7), scan_of(pm, build7)))
    for key in ("P6", "P7 string build", "P7 dictionary build"):
        print(f"compare {key} main-path row gathers: "
              f"{'; '.join(compare_row_gathers(key, gathers[key]))}; exact")
    for key, takes in p7_takes.items():
        if not any(i.shape[0] >= q1t_batch.num_rows_host for _, i in takes):
            raise AssertionError(f"{key}: no take by the stream's codes")
        print(f"compare {key} main-path dictionary gathers: "
              f"{'; '.join(compare_dict_takes(key, takes))}; exact")
    # the shuffle paths' own inputs (phase 3b drives them): every row
    # gather of P9-P11 (the exchanges' reorders among them), the pid
    # hash, and P11's join kernels at a partition pair
    gathers["P9"] = capture_row_gathers(q1_tree(pm, pm.basic.InMemoryScanExec(
        p9_batches, schema), P_PARTS))
    gathers["P10"] = capture_row_gathers(tpch_q1_tree(
        pm, scan_of(pm, q1t_batch), n_parts=P_PARTS))
    gathers["P11"] = capture_row_gathers(p11_plan(d3, dev, "LONG"))
    for key in ("P9", "P10"):
        print(f"compare {key} main-path row gathers: "
              f"{'; '.join(compare_row_gathers(key, gathers[key]))}; exact")
    compare_join_inputs("P11 (its first partition pair)",
                        shuffled_join_inputs(p11_join(p11_plan(d3, dev,
                                                               "LONG"))),
                        gathers["P11"])
    pid_cols = compare_pid_hash(dev, d3, d3i)
    # the join types' own inputs (phase 3d drives them): every row gather
    # of Q21, its semi join's hash, probe and gathers, its anti join's
    # probe, its dictionary gathers; then compare_join_paths
    gathers["P13"] = capture_row_gathers(q21_plan(pm, jb))
    compare_join_inputs("P13 Q21 semi join", JoinInputs(q21_join(
        q21_plan(pm, jb), 6)), gathers["P13"])
    anti_in = JoinInputs(q21_join(q21_plan(pm, jb), 5))
    hits = compare_probe("probe P13 Q21 anti join", anti_in.probe,
                         anti_in.cand_cap, anti_in.total)
    print(f"compare P13 Q21 anti join probe: {anti_in.stream_rows} stream "
          f"rows into {anti_in.build_rows} build rows, candidate total "
          f"{anti_in.total} in {anti_in.cand_cap} slots, {hits} verified "
          f"pairs; exact")
    q21_takes = capture_dict_gathers(q21_plan(pm, jb))
    if not any(i.shape[0] >= jb["orders"].num_rows_host
               for _, i in q21_takes):
        raise AssertionError("P13: no dictionary gather over o_orderstatus")
    print(f"compare P13 Q21 main-path dictionary gathers: "
          f"{'; '.join(compare_dict_takes('P13', q21_takes))}; exact")
    del q21_takes
    compare_join_paths(dev, dj, jb, d3,
                       {site for site, *_ in gathers["P13"]})
    # P17-P20's own inputs (phase 3e drives them): P19's hashes, probes
    # and dictionary takes, every row gather of each path (decimal limbs
    # among the payloads)
    with default_conf_after():
        compare_types_paths(dev, tm, tb)
    shuffle_root_empty("phase 2")
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
    q3_need = ["murmur3_columns", "fused_probe_verify", "dma_row_gather"]
    # launches per run of each path: every row gather and probe call, and
    # one murmur3 launch per join side (both seeds of the build in one);
    # the per-row-seed lanes are off the main paths
    want = {"dma_row_gather": (5, 3), "fused_probe_verify": (1, 1),
            "murmur3_columns": (2, 2), "murmur3_long_lanes": (0, 0),
            "murmur3_int_lanes": (0, 0)}
    rows, q3_counts = drive_counted("q3", q3, q3_need)
    check_q3(rows, q3_want, "q3")
    print(f"q3 at {Q3_LINES} x {Q3_ORDERS}: top 10 equal to the numpy "
          f"oracle; launches {q3_counts}")
    rows, warm_counts = drive_counted("q3 warm", q3, q3_need)
    check_q3(rows, q3_want, "q3 warm")
    print(f"q3 again, speculative size cache warm: equal to the oracle; "
          f"launches {warm_counts}")
    rows, q3i_counts = drive_counted("q3 INT keys", q3i, q3_need)
    check_q3(rows, q3_want, "q3 INT keys")
    print(f"q3 with INT order keys: equal to the oracle; launches "
          f"{q3i_counts}")
    join_rows = q19._source.metrics["numOutputRows"]
    before = join_rows.value
    rows, q19_counts = drive_counted(
        "q19", q19, ["dict_gather"] + q3_need)
    pairs = join_rows.value - before
    check_q19(rows, pairs, q19_want, "q19")
    if q19_counts["dict_gather"] != 42:
        raise AssertionError(f"q19: {q19_counts} (42 dict_gather launches)")
    for label, counts in (("q3", q3_counts), ("q3 warm", warm_counts),
                          ("q3 INT keys", q3i_counts), ("q19", q19_counts)):
        for name, (n3, n19) in want.items():
            need = n19 if label == "q19" else n3
            if counts[name] != need:
                raise AssertionError(f"{label}: {counts[name]} {name} "
                                     f"launches, not {need}")
    print(f"q19 at SF1 ({Q19_LINES} x {Q19_PARTS}): revenue {rows[0][0]!r} "
          f"over {pairs} qualifying rows, equal to the numpy oracle; "
          f"launches {q19_counts}")

    # -- phase 3b: late materialization and the memory runtime -------------
    from spark_rapids_tpu_torch.columnar import encoded
    before, rows_before = encoded.counters(), join_rows.value
    out, p1_counts, p1_reads = drive_batches(
        "P1 q19 decoded", q19, ["dict_gather"] + q3_need)
    dec = {k: encoded.counters()[k] - before[k]
           for k in ("materializations", "materialized_bytes")}
    check_q19([r for b in out for r in b.to_pylist()],
              join_rows.value - rows_before, q19_want, "P1")
    if dec["materializations"] < 1:
        raise AssertionError(f"P1: no decode at the boundary ({dec})")
    print(f"P1 q19 decoded at the join->aggregate boundary: equal to the "
          f"oracle; {dec} (one host read each); host reads in the run "
          f"{p1_reads}; launches {p1_counts}")
    p2, p2_counts, p2_rec = drive_under_budget(
        "P2 q3 under budget",
        lambda: q3_plan(d3, dev, "LONG", P2_LINE_BATCHES), q3_need,
        lambda out, label: check_q3([r for b in out for r in b.to_pylist()],
                                    q3_want, label), split=True)
    p3, p3_counts, p3_rec = drive_under_budget(
        "P3 out-of-core sort", lambda: sort_plan(d3, dev),
        ["dma_row_gather"], lambda out, label: check_sort(out, d3, label),
        split=False)
    p3_rec["merge_passes"] = p3.metrics["mergePasses"].value
    p3_rec["merge_host_reads"] = p3.metrics["mergeHostReads"].value
    if p3_rec["merge_passes"] != 2:
        raise AssertionError(f"P3: {p3_rec['merge_passes']} merge passes")
    print(f"P3: {p3_rec['merge_passes']} merge passes, "
          f"{p3_rec['merge_host_reads']} merge host reads")

    # -- phase 3b, slice 5: q3 and Q19 from host data ----------------------
    t_scan = time.perf_counter()
    from spark_rapids_tpu_torch.columnar import upload
    from spark_rapids_tpu_torch.memory import reset_tpu_semaphore
    reset_tpu_semaphore()  # spark.rapids.sql.concurrentGpuTasks permits
    upload.reset_staging_pool()
    p4_batches = P2_LINE_BATCHES + P4_ORDER_BATCHES
    # the yardstick: the same plan over the same batches built on the
    # card, with no injected split (which adds two row gathers to P2's
    # own unconstrained run)
    rows, p2_free, _, _ = drive_collect(
        "q3 over device batches", q3_plan(d3, dev, "LONG", P2_LINE_BATCHES,
                                          P4_ORDER_BATCHES), q3_need)
    check_q3(rows, q3_want, "q3 over device batches")
    print(f"q3 over {P2_LINE_BATCHES} lineitem and {P4_ORDER_BATCHES} "
          f"order batches built on the card, no injection: launches "
          f"{p2_free} (P2's unconstrained run with its injected split: "
          f"{p2_rec['unconstrained_launches']})")
    p4_rows, p4_counts, p4_io = {}, {}, {}
    for depth in (0, 2):
        label = f"P4 q3 from the host, depth {depth}"
        rows, counts, io, ms = drive_collect(
            label, q3_source_plan(d3, dev, depth, P2_LINE_BATCHES,
                                  P4_ORDER_BATCHES), q3_need)
        check_q3(rows, q3_want, label)
        check_scan_io(label, io, p4_batches, 1)
        if counts != p2_free:
            raise AssertionError(f"{label}: launches {counts} != those of "
                                 f"q3 over device batches {p2_free}")
        check_idle(label)
        p4_rows[depth], p4_counts[depth], p4_io[depth] = rows, counts, io
        print(f"{label}: equal to the oracle in {ms:.1f} ms (first run); "
              f"{io['uploads']} uploads in {io['transfers']} transfers, "
              f"{io['d2h_copies']} device->host copy, pool misses "
              f"{io['pool_misses']}; launches {counts}, as q3 over "
              f"device batches; no permit held, catalog empty")
    if [(k, np.float64(v).tobytes()) for k, v in p4_rows[0]] != \
            [(k, np.float64(v).tobytes()) for k, v in p4_rows[2]]:
        raise AssertionError(f"P4: depth 0 rows {p4_rows[0]} != depth 2 "
                             f"rows {p4_rows[2]}")
    print("P4: depth 0 and depth 2 rows bit-identical")
    q19_bucket = upload._byte_bucket(
        upload.HEADER_BYTES + upload.layout_nbytes(
            [upload.column_layout(c) for c in l19.columns]))
    pinned_ms = pinned_alloc_ms(q19_bucket)
    print(f"pinned allocation of Q19's {q19_bucket}-byte staging bucket: "
          f"{pinned_ms[0]:.2f} ms fresh, {pinned_ms[1]:.2f} ms from "
          f"PyTorch's caching host allocator")
    q19s = q19_source_plan(d19, dev, 2)
    join_rows = q19s._source.metrics["numOutputRows"]
    rows_before = join_rows.value
    rows, p5_counts, p5_io, p5_first_ms = drive_collect(
        "P5 q19 from the host", q19s, ["dict_gather"] + q3_need)
    check_q19(rows, join_rows.value - rows_before, q19_want, "P5")
    check_scan_io("P5", p5_io, 2, 1)
    if p5_counts != q19_counts:
        raise AssertionError(f"P5: launches {p5_counts} != phase 3's q19 "
                             f"{q19_counts}")
    check_idle("P5")
    print(f"P5 q19 from the host, depth 2: equal to the oracle in "
          f"{p5_first_ms:.1f} ms (first run); {p5_io['uploads']} uploads "
          f"in {p5_io['transfers']} transfers, {p5_io['d2h_copies']} "
          f"device->host copy, pool misses {p5_io['pool_misses']}; "
          f"launches {p5_counts} (phase 3's q19: {q19_counts})")
    print(f"P4 and P5 (phase 3b): {time.perf_counter() - t_scan:.1f} s")

    # -- phase 3b, slice 6: string keys ------------------------------------
    t_str = time.perf_counter()
    m = port_modules()
    strings = drive_string_paths(m, dev, q1t_batch, q1t_want, p7_batches,
                                 p7_want, names)
    p6, p6_counts, p6_rec, p7_counts, p7_rec, p8_counts, p8_rec = strings
    print(f"P6-P8 (phase 3b): {time.perf_counter() - t_str:.1f} s")

    # -- phase 3b, slice 7: the host shuffle --------------------------------
    t_shuf = time.perf_counter()
    shuffled = drive_shuffle_paths(dev, p9_batches, oracle, q1t_batch,
                                   q1t_want, d3, d3i, q3_want)
    print(f"P9-P11 (phase 3b): {time.perf_counter() - t_shuf:.1f} s")

    # -- phase 3c, slice 8: the same queries planned from DataFrames -------
    t_plan = time.perf_counter()
    sm = session_modules()
    TpuSession = sm.session.TpuSession
    sess, q3_sess = TpuSession(device=DEVICE), TpuSession(Q3_CONF, DEVICE)
    p11_sess = TpuSession(P11_CONF, DEVICE)

    def q3_side_batches(d_, key, n_lines=1, n_orders=1):
        o_schema, l_schema = q3_schemas(key)
        return (q3_batches(d_, dev, o_schema, Q3_ORDERS, n_orders),
                q3_batches(d_, dev, l_schema, Q3_LINES, n_lines))

    def q19_pairs(metrics):
        return next(v["numOutputRows"] for k, v in metrics.items()
                    if k.startswith("HashJoinExec#"))

    q3_need = ["murmur3_columns", "fused_probe_verify", "dma_row_gather"]
    session_dfs = {
        "q1": q1_df(sm, sess, [batch]),
        "q3": q3_df(sm, q3_sess, *q3_side_batches(d3, "LONG")),
        "q3 INT keys": q3_df(sm, q3_sess, *q3_side_batches(d3i, "INT")),
        "q19": q19_df(sm, sess, l19, p19),
        "P6": tpch_q1_df(sm, sess, q1t_batch),
        "P11": q3_df(sm, p11_sess, *q3_side_batches(
            d3, "LONG", P11_LINE_BATCHES, P11_ORDER_BATCHES))}
    planned_recs = {}
    for label, need, hand, check, hand_shape in (
            ("q1", ["fused_scan_agg"], q1_counts,
             lambda r, lb, _: check_q1(r, oracle, lb), plan_shape(plan)),
            ("q3", q3_need, q3_counts,
             lambda r, lb, _: check_q3(r, q3_want, lb), None),
            ("q3 INT keys", q3_need, q3i_counts,
             lambda r, lb, _: check_q3(r, q3_want, lb), None),
            ("q19", ["dict_gather"] + q3_need, q19_counts,
             lambda r, lb, mx: check_q19(r, q19_pairs(mx), q19_want, lb),
             None),
            ("P6", ["dma_row_gather"], p6_counts,
             lambda r, lb, _: check_rows(r, q1t_want, lb), plan_shape(p6)),
            ("P11", q3_need, shuffled["P11"][1],
             lambda r, lb, _: check_q3(r, q3_want, lb),
             plan_shape(shuffled["P11"][0]))):
        planned_recs[label] = drive_planned(
            f"{label} planned", sm, session_dfs[label], need, hand, check,
            hand_shape)
    print(f"phase 3c: {time.perf_counter() - t_plan:.1f} s")

    # -- phase 3d, slice 9: the join types and the basic operators --------
    t_join = time.perf_counter()
    join_counts, join_recs, join_runs = drive_join_paths(
        dev, dj, jb, d3, d19, q1t_batch)
    print(f"phase 3d: {time.perf_counter() - t_join:.1f} s")

    # -- phase 3e, slice 10: decimals, dates, sample and the range sort ----
    t_types = time.perf_counter()
    with default_conf_after():
        types_counts, types_recs, types_runs = drive_types_paths(
            dev, tm, tb, types_want)
    print(f"phase 3e: {time.perf_counter() - t_types:.1f} s")

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
        before = encoded.counters()
        t0 = time.perf_counter()
        for _ in range(Q19_ITERS):
            list(q19.execute())
        torch.cuda.synchronize()
        q19_ms = (time.perf_counter() - t0) * 1e3 / Q19_ITERS
        if scope.tripped():
            raise AssertionError("q19 speculation flag tripped in steady "
                                 "state")
    per_iter = {k: (encoded.counters()[k] - before[k]) / Q19_ITERS
                for k in ("materializations", "materialized_bytes")}
    print(f"q19 steady state, decoded at the boundary (P1): {q19_ms:.3f} "
          f"ms/iteration, {q19_bytes / q19_ms / 1e6:.1f} GB/s of column "
          f"data ({q19_bytes} bytes, {Q19_ITERS} iterations, one sync); "
          f"per iteration {per_iter}")
    for label, plan_, rec in (("P2 q3 under budget", p2, p2_rec),
                              ("P3 out-of-core sort", p3, p3_rec)):
        rec["ms"] = time_under_budget(plan_, rec)
        print(f"{label}: {rec['ms']} ms per iteration ({P_ITERS} runs, "
              f"budget {rec['budget']}, host limit {rec['host_limit']})")
    rate_bytes, rates = spill_rates(q3_batches(
        d3, dev, q3_schemas("LONG")[1], Q3_LINES)[0])
    print(f"spill lane on the {rate_bytes}-byte lineitem batch, GB/s: "
          f"{rates}")

    t_scan = time.perf_counter()
    # P4 in turns with its yardstick, the same plan over the same batches
    # built on the card ("device"), then P5; the pool's misses
    # after P4's first iteration (phase 3b) must stay 0
    misses = io_counters()["pool_misses"]
    p4_ms = {"device": [], 0: [], 2: []}
    plans = {k: q3_source_plan(d3, dev, k, P2_LINE_BATCHES,
                               P4_ORDER_BATCHES) for k in (0, 2)}
    plans["device"] = q3_plan(d3, dev, "LONG", P2_LINE_BATCHES,
                              P4_ORDER_BATCHES)
    for i in range(P4_ITERS):
        order = ("device", 0, 2) if i % 2 == 0 else (2, 0, "device")
        for k in order:
            t0 = time.perf_counter()
            check_q3(plans[k].collect(), q3_want, f"P4 {k}")
            torch.cuda.synchronize()
            p4_ms[k].append((time.perf_counter() - t0) * 1e3)
    p4_misses = io_counters()["pool_misses"] - misses
    if p4_misses:
        raise AssertionError(f"P4: {p4_misses} staging pool misses after "
                             f"the first iteration")
    check_idle("P4 timed")
    print(f"P4 ms per iteration ({P4_ITERS} each, in turns): depth 0 "
          f"{p4_ms[0]}, depth 2 {p4_ms[2]}; the same plan over batches "
          f"built on the card {p4_ms['device']}; pool misses after the "
          f"first iteration {p4_misses}")
    p5_ms = []
    misses = io_counters()["pool_misses"]
    for _ in range(P5_ITERS):
        t0 = time.perf_counter()
        q19s.collect()
        torch.cuda.synchronize()
        p5_ms.append((time.perf_counter() - t0) * 1e3)
    p5_misses = io_counters()["pool_misses"] - misses
    check_idle("P5 timed")
    print(f"P5 ms per iteration: {p5_ms}; pool misses {p5_misses} (the "
          f"lineitem bucket is larger than the pool keeps)")
    l_schema = q3_schemas("LONG")[1]
    step = Q3_LINES // P2_LINE_BATCHES
    q19_l_schema = q19_schemas(t)[0]

    def q3_per_buffer():
        ColumnarBatch.from_numpy_columns(
            [(d3[f.name][:step], np.ones(step, np.bool_))
             for f in l_schema.fields], l_schema, step, device=dev)

    first_part = q3_host_parts(d3, l_schema, Q3_LINES, P2_LINE_BATCHES)[0]
    ingest = {
        "q3_lineitem_batch": upload_rates(
            lambda: first_part()[0], step, l_schema, dev, q3_per_buffer),
        "q19_lineitem_batch": upload_rates(
            lambda: q19_columns(d19, q19_l_schema, "cpu")[0], Q19_LINES,
            q19_l_schema, dev, lambda: q19_columns(d19, q19_l_schema, dev))}
    for k, v in ingest.items():
        print(f"ingest of the {k} ({v['bytes']} packed bytes): host build "
              f"{v['build_ms']:.3f} ms, staging acquire "
              f"{v['acquire_ms']:.3f} ms, host pack {v['pack_gb_s']:.2f} "
              f"GB/s, copy {v['link_gb_s']:.2f} GB/s; packed upload "
              f"{v['upload_ms']:.3f} ms, per-buffer build "
              f"{v['per_buffer_ms']:.3f} ms")
    print(f"P4, P5 and the upload rates (phase 4): "
          f"{time.perf_counter() - t_scan:.1f} s")

    # P6 and P7 in steady state, as Q19 (one synchronisation per run of
    # iterations); each run reads its hash route's leftover flag
    def steady_ms(plan_):
        list(plan_.execute())  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(P6_ITERS):
            list(plan_.execute())
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / P6_ITERS

    p6_rec["ms"] = steady_ms(p6)
    print(f"P6 TPC-H Q1 steady state: {p6_rec['ms']:.3f} ms/iteration "
          f"({P6_ITERS} iterations, one sync)")
    for enc, (lines7, build7) in p7_batches.items():
        key = "dictionary_build" if enc else "string_build"
        p7_rec[key]["ms"] = steady_ms(
            shipmode_join_tree(m, scan_of(m, lines7), scan_of(m, build7)))
        print(f"P7 ship-mode join ({key}) steady state: "
              f"{p7_rec[key]['ms']:.3f} ms/iteration ({P6_ITERS} "
              f"iterations, one sync)")

    t_shuf = time.perf_counter()
    shuffle_recs = time_shuffle_paths(shuffled, oracle, q1t_want, q3_want)
    fetch_rates = split_fetch_rates(dev, d3)
    pid_recs = time_pid_hash(pid_cols)
    reorder_recs = [time_gather_call(path, *call) for path, calls in
                    reorder_gathers({k: gathers[k] for k in
                                     ("P9", "P10", "P11")}).items()
                    for call in calls]
    print(f"P9-P11 timings (phase 4): {time.perf_counter() - t_shuf:.1f} s")
    t_sess = time.perf_counter()
    session_ms = time_session_paths({
        "q1": (session_dfs["q1"], plan,
               lambda r, lb: check_q1(r, oracle, lb)),
        "q3": (session_dfs["q3"], q3, lambda r, lb: check_q3(r, q3_want, lb)),
        "q19": (session_dfs["q19"], q19, lambda r, lb: check_q19(
            r, q19_want[1], q19_want, lb))})
    print(f"session timings (phase 4): {time.perf_counter() - t_sess:.1f} s")
    t_join = time.perf_counter()
    join_ms = time_join_paths(join_runs)
    q21_probes, q21_gathers = q21_kernel_shapes(
        jb, join_counts["P13"]["fused_probe_verify"])
    print(f"P12-P16 timings and Q21's kernel shapes (phase 4): "
          f"{time.perf_counter() - t_join:.1f} s")
    t_types = time.perf_counter()
    types_ms = time_join_paths(types_runs)
    with default_conf_after():
        p19_shapes = p19_kernel_shapes(dev, tm, tb, types_counts["P19"])
    print(f"P17-P20 timings and P19's kernel shapes (phase 4): "
          f"{time.perf_counter() - t_types:.1f} s")

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
    }] + time_murmur3(q3_in, q3i_in, q19_in, q3_counts, q3i_counts) + [
        time_probe(q3_in, q19_in, {"q3": q3_counts["fused_probe_verify"],
                                   "q19": q19_counts["fused_probe_verify"]}),
        time_row_gathers({k: gathers[k] for k in (
            "q3", "q19", "P6", "P7 string build", "P7 dictionary build")},
            q3_counts["dma_row_gather"]),
        time_dict_gather(l19, q19_counts["dict_gather"],
                         max(p7_takes["P7 string build"],
                             key=lambda ti: ti[1].shape[0]),
                         p7_counts["string_build"]["dict_gather"])]
    # after the kernel timings: a profiled process times short launches
    # slower and less evenly
    if args.profile:
        profile_plan("q1", plan, 10, args.profile)
        profile_plan("q3", q3, Q3_ITERS, args.profile.with_name(
            args.profile.stem + "_q3" + args.profile.suffix))
        profile_plan("q19", q19, Q19_ITERS, args.profile.with_name(
            args.profile.stem + "_q19" + args.profile.suffix))
        profile_plan("P6", p6, P6_ITERS, args.profile.with_name(
            args.profile.stem + "_p6" + args.profile.suffix))
        lines7, build7 = p7_batches[False]
        profile_plan("P7", shipmode_join_tree(
            m, scan_of(m, lines7), scan_of(m, build7)), P6_ITERS,
            args.profile.with_name(args.profile.stem + "_p7"
                                   + args.profile.suffix))
        for label, (run, _) in types_runs.items():
            tag = label.lower().replace(" ", "_")
            profile_plan(label, run.__self__, P_TYPES_ITERS,
                         args.profile.with_name(
                             f"{args.profile.stem}_{tag}"
                             f"{args.profile.suffix}"))
    for r in records:
        r["path_launches"] = {
            "P1_q19_decoded": p1_counts.get(r["name"], 0),
            "P2_q3_budget": p2_counts.get(r["name"], 0),
            "P3_sort_out_of_core": p3_counts.get(r["name"], 0),
            "P4_q3_from_host": p4_counts[2].get(r["name"], 0),
            "P5_q19_from_host": p5_counts.get(r["name"], 0),
            "P6_tpch_q1": p6_counts.get(r["name"], 0),
            "P7_string_join": p7_counts["string_build"].get(r["name"], 0),
            "P7_dictionary_join": p7_counts["dictionary_build"].get(
                r["name"], 0),
            "P8_names_count": p8_counts.get(r["name"], 0),
            "P9_q1_shuffled": shuffled["P9"][1].get(r["name"], 0),
            "P10_tpch_q1_shuffled": shuffled["P10"][1].get(r["name"], 0),
            "P11_q3_shuffled": shuffled["P11"][1].get(r["name"], 0),
            "P11_q3_shuffled_int_keys": shuffled["P11_INT"][1].get(
                r["name"], 0),
            **{f"planned_{k.replace(' ', '_')}": v["launches"].get(
                r["name"], 0) for k, v in planned_recs.items()},
            **{k: v.get(r["name"], 0) for k, v in join_counts.items()},
            "P12_planned": join_recs["P12_planned"]["launches"].get(
                r["name"], 0),
            "P13_planned": join_recs["P13_planned"]["launches"].get(
                r["name"], 0),
            **{k.replace(" ", "_"): v.get(r["name"], 0)
               for k, v in types_counts.items()}}
        if r["name"] in p19_shapes:
            r["p19_shapes"] = p19_shapes[r["name"]]
        if r["name"] == "murmur3_columns":
            r["pid_shapes"] = pid_recs
        if r["name"] == "dma_row_gather":
            r["reorder_shapes"] = reorder_recs
            r["q21_shapes"] = q21_gathers
        if r["name"] == "fused_probe_verify":
            r["q21_shapes"] = q21_probes
    print(json.dumps({"paths": {
        "P1": dict(dec, host_reads=p1_reads, ms=q19_ms),
        "P2": p2_rec, "P3": p3_rec, "spill_gb_s": rates,
        "P4": {"ms": {("device_batches" if k == "device" else
                       f"depth_{k}"): v for k, v in p4_ms.items()},
               "io": {f"depth_{k}": v for k, v in p4_io.items()},
               "launches": p4_counts[2], "pool_misses_after_first": 0},
        "P5": {"ms": p5_ms, "first_run_ms": p5_first_ms, "io": p5_io,
               "launches": p5_counts, "pool_misses": p5_misses,
               "pinned_alloc_ms": pinned_ms},
        "ingest": ingest, "P6": p6_rec, "P7": p7_rec, "P8": p8_rec,
        **{k: dict(v[2], timed=shuffle_recs.get(k)) for k, v in
           shuffled.items()}, "split_fetch": fetch_rates,
        "planned": {k: dict(v, ms=session_ms.get(k)) for k, v in
                    planned_recs.items()},
        "join_paths": dict(join_recs, counts=join_counts, ms=join_ms),
        "types_paths": dict(types_recs, counts=types_counts,
                            ms=types_ms)}}))
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
