"""The PyTorch port's fused scan-aggregate module against the JAX package.

- its plain version against the TPU kernel run in Pallas interpret mode,
  on the q1 spec and on a spec using min/max/sum_sq/count (exact integers
  and flags, f64 sums to rtol 1e-12);
- its plain version against masked_groupby with one round (the equality
  the CUDA kernel is held to on the card), leftover case included;
- the CUDA source the emitter produces for the q1 spec (golden);
- the epilogue ignores the aggregate words of dirty buckets (the one-pass
  kernel accumulates them, the plain version and the TPU kernel do not);
- the host-side choices of the kernel's shape (pure functions);
- the wrapper on CPU tensors takes the plain version and counts no launch.
"""

import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (enables jax x64)
import jax.numpy as jnp
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import arithmetic as jarith
from spark_rapids_tpu.expr import predicates as jpred
from spark_rapids_tpu.ops.pallas_fused import (
    compile_scan_agg_spec as j_compile, fused_scan_agg_update)

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import arithmetic as tarith
from spark_rapids_tpu_torch.expr import predicates as tpred
from spark_rapids_tpu_torch.ops import fused_scan_agg as fsa
from spark_rapids_tpu_torch.ops.maskedagg import clean_buckets, masked_groupby


class _NS:
    def __init__(self, types, core, arith, pred):
        self.t = types
        for mod in (core, arith, pred):
            for k in dir(mod):
                if not k.startswith("_"):
                    setattr(self, k, getattr(mod, k))


J = _NS(jt, jcore, jarith, jpred)
T = _NS(tt, tcore, tarith, tpred)


def _q1_chain(x):
    """bench.py's q1: filter quantity <= 45, project disc_price, group by
    returnflag: sum(quantity), sum(disc_price), count(*)."""
    src = x.t.Schema((x.t.StructField("returnflag", x.t.INT),
                      x.t.StructField("quantity", x.t.LONG),
                      x.t.StructField("extendedprice", x.t.DOUBLE),
                      x.t.StructField("discount", x.t.DOUBLE)))
    filt = x.resolve(x.LessThanOrEqual(x.col("quantity"), x.lit(45)), src)
    proj_exprs = [x.col("returnflag"), x.col("quantity"),
                  x.Multiply(x.col("extendedprice"),
                             x.Subtract(x.lit(1.0), x.col("discount")))
                  .alias("disc_price")]
    proj_bound = [x.resolve(e, src) for e in proj_exprs]
    proj_schema = x.t.Schema(tuple(
        x.t.StructField(n, e.data_type) for n, e in
        zip(("returnflag", "quantity", "disc_price"), proj_bound)))
    pre = [x.col("returnflag"), x.col("quantity").alias("_aggin1"),
           x.col("disc_price").alias("_aggin2")]
    pre_bound = [x.resolve(e, proj_schema) for e in pre]
    pre_schema = x.t.Schema(tuple(
        x.t.StructField(n, e.data_type) for n, e in
        zip(("returnflag", "_aggin1", "_aggin2"), pre_bound)))
    steps = [("filter", filt), ("project", proj_bound, proj_schema)]
    ops = [("sum", 1), ("sum", 2), ("count_star", None)]
    return src, steps, pre_bound, pre_schema, ops


def _minmax_chain(x):
    """A LONG key over a filtered INT/DOUBLE source: min, max, sum_sq,
    count, and a derived DOUBLE key part."""
    src = x.t.Schema((x.t.StructField("k", x.t.LONG),
                      x.t.StructField("w", x.t.INT),
                      x.t.StructField("v", x.t.DOUBLE)))
    filt = x.resolve(x.Or(x.GreaterThan(x.col("w"), x.lit(-40)),
                          x.IsNull(x.col("v"))), src)
    pre = [x.col("k"), x.Abs(x.col("v")).alias("_a1"),
           x.col("w").alias("_a2"),
           x.Divide(x.col("v"), x.col("w")).alias("_a3")]
    pre_bound = [x.resolve(e, src) for e in pre]
    pre_schema = x.t.Schema(tuple(
        x.t.StructField(n, e.data_type) for n, e in
        zip(("k", "_a1", "_a2", "_a3"), pre_bound)))
    ops = [("min", 1), ("max", 1), ("min", 2), ("max", 2), ("sum_sq", 1),
           ("sum_sq", 2), ("count", 3), ("sum", 3), ("count_star", None)]
    return src, [("filter", filt)], pre_bound, pre_schema, ops


def _specs(chain):
    js, jsteps, jpre, jpre_schema, ops = chain(J)
    ts, tsteps, tpre, tpre_schema, _ = chain(T)
    jspec = j_compile(jsteps, jpre, jpre_schema, 1, ops, js)
    tspec = fsa.compile_scan_agg_spec(tsteps, tpre, tpre_schema, 1, ops, ts)
    assert jspec is not None and tspec is not None
    return jspec, tspec, js, ts


def _batches(jschema, tschema, n, cap, rng, key_dom, nulls=True):
    cols = []
    for f in jschema.fields:
        dt = f.data_type
        if f.name in ("returnflag", "k"):
            vals = rng.integers(0, key_dom, n)
        elif f.name == "quantity":
            vals = rng.integers(1, 51, n)
        elif f.name == "w":
            vals = rng.integers(-60, 60, n)
        elif f.name == "discount":
            vals = rng.random(n) * 0.1
        else:
            vals = rng.random(n) * 1000.0 - 100.0
        valid = rng.random(n) > (0.15 if nulls else -1.0)
        jc = JColumn.from_numpy(np.asarray(vals).astype(dt.jnp_dtype), dt,
                                validity=valid, capacity=cap)
        cols.append((np.asarray(jc.data).copy(),
                     np.asarray(jc.validity).copy()))
    jb = JBatch([JColumn(jnp.asarray(d), jnp.asarray(v), f.data_type)
                 for (d, v), f in zip(cols, jschema.fields)], n, jschema)
    tb = TBatch.from_numpy_columns(cols, tschema, n, device="cpu")
    return jb, tb


def _assert_same(jout, tout):
    jkeys, jres, jng, jleft = jout
    tkeys, tres, tng, tleft = tout
    ng = int(jng)
    assert ng == int(tng) and bool(jleft) == bool(tleft)
    for jk, tk in zip(jkeys, tkeys):
        np.testing.assert_array_equal(np.asarray(jk.validity),
                                      tk.validity.numpy())
        np.testing.assert_array_equal(np.asarray(jk.data), tk.data.numpy())
    for (_, (jd, jv)), (_, (td, tv)) in zip(jres, tres):
        jv, tv = np.asarray(jv), tv.numpy()
        np.testing.assert_array_equal(jv, tv)
        jd, td = np.asarray(jd)[jv], td.numpy()[tv]
        assert jd.dtype == td.dtype, (jd.dtype, td.dtype)
        if np.issubdtype(jd.dtype, np.floating):
            np.testing.assert_allclose(td, jd, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(td, jd)
    return ng


@pytest.mark.parametrize("chain,n,key_dom", [
    (_q1_chain, 8000, 4),
    (_minmax_chain, 3000, 6),
])
def test_plain_matches_tpu_kernel_interpret(chain, n, key_dom):
    jspec, tspec, js, ts = _specs(chain)
    jb, tb = _batches(js, ts, n, 8192, np.random.default_rng(5), key_dom)
    jout = fused_scan_agg_update(jspec, jb, 32, 128, interpret=True)
    tout = fsa.fused_scan_agg_plain(tspec, tb, 32, 128)
    assert _assert_same(jout, tout) > 0


@pytest.mark.parametrize("chain,key_dom,G", [
    (_q1_chain, 4, 32),
    (_minmax_chain, 12, 16),
    (_minmax_chain, 400, 8),     # high cardinality: leftover
])
def test_plain_equals_one_round_masked_groupby(chain, key_dom, G):
    """With rounds=1 and the same G the kernel's bucketing is
    masked_groupby's round 0: identical groups, order and leftover."""
    _, tspec, js, ts = _specs(chain)
    _, tb = _batches(js, ts, 5000, 8192, np.random.default_rng(9), key_dom)
    mask, keys, agg_cols = fsa._eval_pipeline(
        tspec, list(tb.columns), tb.capacity, tb.device)
    ref = masked_groupby(keys, [(op, c) for (op, _), c in
                                zip(tspec.agg_ops, agg_cols)],
                         tb.num_rows, tb.capacity, mask, G, 1)
    got = fsa.fused_scan_agg(tspec, tb, G, 128)
    assert bool(got[3]) == bool(ref[3])
    if key_dom == 400:
        assert bool(got[3]), "high cardinality must leave rows over"
    ng = int(ref[2])
    assert int(got[2]) == ng
    for a, b in zip(got[0], ref[0]):
        assert torch.equal(a.data[:ng], b.data[:ng])
        assert torch.equal(a.validity[:ng], b.validity[:ng])
    for (_, (ad, av)), (_, (bd, bv)) in zip(got[1], ref[1]):
        assert torch.equal(av[:ng], bv[:ng])
        if ad.is_floating_point():
            torch.testing.assert_close(ad[:ng][av[:ng]], bd[:ng][bv[:ng]],
                                       rtol=1e-12, atol=0)
        else:
            assert torch.equal(ad[:ng][av[:ng]], bd[:ng][bv[:ng]])


def test_wrapper_on_cpu_takes_plain_version_and_counts_no_launch():
    _, tspec, js, ts = _specs(_q1_chain)
    _, tb = _batches(js, ts, 1000, 1024, np.random.default_rng(1), 4)
    before = fsa.fused_scan_agg.launches
    got = fsa.fused_scan_agg(tspec, tb, 32, 128)
    want = fsa.fused_scan_agg_plain(tspec, tb, 32, 128)
    assert fsa.fused_scan_agg.launches == before == 0
    _assert_same(got, want)
    with pytest.raises(ValueError):
        fsa.fused_scan_agg(tspec, tb, 33, 128)


def test_ineligible_chains_have_no_spec():
    src, steps, pre, pre_schema, ops = _q1_chain(T)
    assert fsa.compile_scan_agg_spec(steps, pre, pre_schema, 0, ops,
                                     src) is None
    assert fsa.compile_scan_agg_spec(steps, pre, pre_schema, 1,
                                     [("first", 1)], src) is None
    short = tt.Schema((tt.StructField("s", tt.SHORT),))
    sref = [tcore.resolve(tcore.col("s"), short)]
    assert fsa.compile_scan_agg_spec([], sref, short, 1,
                                     [("count_star", None)], short) is None


Q1_GOLDEN = """\
#define N_COLS 4
#define N_KEYS 1
#define N_AGGS 3
#define S0 4
#define S1 6
#define S 10
#define RUN 4
#define CACHE 4

// @FUNCTIONS@
__device__ __forceinline__ int kind_of(int s) {
    switch (s) {
    case 0: return K_MIN_U32;
    case 1: return K_MAX_U32;
    case 2: return K_OR;
    case 3: return K_OR;
    case 4: return K_SUM_I;
    case 5: return K_OR;
    case 6: return K_SUM_F;
    case 7: return K_OR;
    case 8: return K_CNT;
    case 9: return K_OR;
    }
    return 0;
}

__device__ __forceinline__ unsigned long long init_word(int s) {
    switch (s) {
    case 0: return 0xFFFFFFFFull;
    case 1: return 0ull;
    case 2: return 0ull;
    case 3: return 0ull;
    case 4: return 0ull;
    case 5: return 0ull;
    case 6: return 0ull;
    case 7: return 0ull;
    case 8: return 0ull;
    case 9: return 0ull;
    }
    return 0ull;
}

// a bucket's words in a lane's cache: flag bits, 32-bit words,
// 64-bit words
struct Entry {
    unsigned f[1];
    unsigned u[3];
    unsigned long long w[2];
};

__device__ __forceinline__ void init_entry(Entry& e) {
    e.f[0] = 0u;
    e.u[0] = (unsigned)0xFFFFFFFFull;
    e.u[1] = (unsigned)0ull;
    e.u[2] = (unsigned)0ull;
    e.w[0] = 0ull;
    e.w[1] = 0ull;
}

__device__ __forceinline__ unsigned long long entry_word(const Entry& e, int s) {
    switch (s) {
    case 0: return e.u[0];
    case 1: return e.u[1];
    case 2: return (e.f[0] >> 0) & 1u;
    case 3: return (e.f[0] >> 1) & 1u;
    case 4: return e.w[0];
    case 5: return (e.f[0] >> 2) & 1u;
    case 6: return e.w[1];
    case 7: return (e.f[0] >> 3) & 1u;
    case 8: return e.u[2];
    case 9: return (e.f[0] >> 4) & 1u;
    }
    return 0ull;
}

__device__ __forceinline__ int bucket_of(const Row& r, int G) {
    unsigned h = 0x9E3779B9u;
    h = mix32(h ^ (unsigned)r.kbits[0], SALT);
    h = mix32(h ^ (unsigned)r.kvalid[0], SALT + 0xA3u);
    return (int)(h % (unsigned)G);
}

__device__ __forceinline__ void row_step(const Row& r, Entry& e) {
    if (r.kvalid[0]) {
        e.u[0] = (unsigned)r.kbits[0] < e.u[0] ? (unsigned)r.kbits[0] : e.u[0];
        e.u[1] = (unsigned)r.kbits[0] > e.u[1] ? (unsigned)r.kbits[0] : e.u[1];
    }
    e.f[0] |= (unsigned)(r.kvalid[0]) << 0;
    e.f[0] |= (unsigned)(!r.kvalid[0]) << 1;
    if (r.avalid[0]) e.w[0] += (unsigned long long)r.ai[0];
    e.f[0] |= (unsigned)(r.avalid[0]) << 2;
    if (r.avalid[1]) e.w[1] = f64_word(as_f64(e.w[1]) + r.af[1]);
    e.f[0] |= (unsigned)(r.avalid[1]) << 3;
    e.u[2] += 1u;
}

template <typename LaneT>
__device__ __forceinline__ void scan_run(const Cols& cols, long long base, int m, LaneT& lane) {
    long long c1_[RUN];
    load_run(c1_, cols.data[1], base, m);
    const unsigned c1v_ = load_bytes(cols.valid[1], base, m);
    int c0_[RUN];
    load_run(c0_, cols.data[0], base, m);
    const unsigned c0v_ = load_bytes(cols.valid[0], base, m);
    double c2_[RUN];
    load_run(c2_, cols.data[2], base, m);
    const unsigned c2v_ = load_bytes(cols.valid[2], base, m);
    double c3_[RUN];
    load_run(c3_, cols.data[3], base, m);
    const unsigned c3v_ = load_bytes(cols.valid[3], base, m);
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
        Row r = {};
        const long long c1 = c1_[k];
        const bool c1v = ((c1v_ >> (8 * k)) & 0xFFu) != 0u;
        const bool t2 = c1v && true;
        const bool t1 = (c1 <= ((long long)((int)45))) && t2;
        const int c0 = c0_[k];
        const bool c0v = ((c0v_ >> (8 * k)) & 0xFFu) != 0u;
        const double c2 = c2_[k];
        const bool c2v = ((c2v_ >> (8 * k)) & 0xFFu) != 0u;
        const double c3 = c3_[k];
        const bool c3v = ((c3v_ >> (8 * k)) & 0xFFu) != 0u;
        const bool t4 = true && c3v;
        const double t3 = t4 ? (__longlong_as_double(4607182418800017408LL) - c3) : (double)0;
        const bool t6 = c2v && t4;
        const double t5 = t6 ? (c2 * t3) : (double)0;
        r.keep = (t1 && t2) && k < m;
        r.kbits[0] = order_bits(c0);
        r.kvalid[0] = c0v;
        r.ai[0] = (long long)c1;
        r.avalid[0] = c1v;
        r.af[1] = (double)t5;
        r.avalid[1] = t6;
        lane.fold(r);
    }
}
"""


def test_q1_cuda_source_golden():
    _, tspec, _, _ = _specs(_q1_chain)
    assert tspec.cuda_source == Q1_GOLDEN
    full = fsa.kernel_source(tspec)
    assert "@SIZES@" not in full and "@FUNCTIONS@" not in full
    assert full.index("#define N_KEYS 1") < full.index("struct Row")
    assert full.index("struct Row") < full.index("void scan_run")
    assert full.index("#define CACHE 4") < full.index("struct Lane")
    assert "scan_run(cols, base, m, ln)" in full


@pytest.mark.parametrize("key_dom,G", [(10, 16), (12, 8), (400, 8)])
def test_finish_ignores_dirty_buckets_aggregate_words(key_dom, G):
    """The kernel accumulates every kept row into its bucket, dirty or
    not; the plain version (and the TPU kernel's phase 1) only the rows of
    clean buckets. _finish places only clean, occupied buckets, so any
    value in a dirty bucket's aggregate words gives the same output."""
    _, tspec, js, ts = _specs(_minmax_chain)
    _, tb = _batches(js, ts, 5000, 8192, np.random.default_rng(9), key_dom)
    kstats, astats = fsa._partials_plain(tspec, tb, G)
    clean, occupied = clean_buckets(kstats)
    dirty = occupied & ~clean
    assert bool(dirty.any())
    S = sum(fsa._slots(tspec))
    words = torch.from_numpy(np.random.default_rng(key_dom).integers(
        -2**63, 2**63 - 1, (G, S), dtype=np.int64, endpoint=True))
    _, arbitrary = fsa._unpack_partials(tspec, words)
    mixed = [(torch.where(dirty, b, a),
              None if ha is None else torch.where(dirty, hb, ha))
             for (a, ha), (b, hb) in zip(astats, arbitrary)]
    want = fsa._finish(tspec, kstats, astats, 128)
    got = fsa._finish(tspec, kstats, mixed, 128)
    assert int(got[2]) == int(want[2]) and bool(got[3]) == bool(want[3])
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a.data, b.data) and torch.equal(a.validity,
                                                           b.validity)
    for (_, (ad, av)), (_, (bd, bv)) in zip(got[1], want[1]):
        assert torch.equal(av, bv)
        if ad.is_floating_point():   # NaN results compare by their bits
            ad, bd = ad.view(torch.int64), bd.view(torch.int64)
        assert torch.equal(ad, bd)


@pytest.mark.parametrize("capacity,sms,per_sm,want", [
    (1 << 24, 132, 1, 132),       # q1: one wave, a block an SM
    (1 << 24, 132, 2, 264),
    (1024, 132, 2, 1),            # one block takes 1,024 rows a step
    (65_536, 132, 2, 64),
    (1 << 20, 132, 3, 396),
])
def test_grid_blocks(capacity, sms, per_sm, want):
    assert fsa.grid_blocks(capacity, sms, per_sm) == want


@pytest.mark.parametrize("chain,words,cache", [
    # 1 key x 4 + 3 aggregates x 2 words; an entry holds 5 flag bits, three
    # 32-bit words (min, max, count) and two 64-bit sums: 8 registers
    (_q1_chain, 10, 4),
    # 1 LONG key x 4 + 9 aggregates x 2 words: 21 registers
    (_minmax_chain, 22, 2),
])
def test_cache_entries(chain, words, cache):
    _, tspec, _, _ = _specs(chain)
    assert sum(fsa._slots(tspec)) == words
    assert f"#define CACHE {cache}" in tspec.cuda_source
    assert [fsa.cache_entries(r) for r in (8, 12, 13, 21, 24, 25, 48, 49)] \
        == [4, 4, 3, 2, 2, 1, 1, 1]
