"""WindowExec and the window functions (exec/window.py, ops/window.py,
expr/windowexprs.py) against the JAX package on the CPU.

Each reference WindowExec carries many expressions at once (the JAX
package compiles one program per exec and capacity): every function
(row_number, rank, dense_rank, lag and lead with and without a default,
first_value, last_value, sum/min/max/count/avg) over ROWS, RANGE (value
offsets, ascending and descending), unbounded and default frames, with
null inputs, null partition and order keys and ties; and the
giant-partition carry over chunked input, with TWO_PASS_THRESHOLD_ROWS
set low on both packages' instances. An unpartitioned window and
partitions spanning the out-of-core sort's chunks go against numpy
oracles. Integers, ranks and row order exact; f64 to rtol
1e-9. The segment-local sums are held to a numpy oracle with a tiny
partition after 1e12-scale ones.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu.exec import basic as jb
from spark_rapids_tpu.exec import window as jw
from spark_rapids_tpu.expr import core as jc
from spark_rapids_tpu.expr import windowexprs as jwe

from spark_rapids_tpu_torch.exec import basic as tb
from spark_rapids_tpu_torch.exec import window as tw
from spark_rapids_tpu_torch.expr import core as tc
from spark_rapids_tpu_torch.expr import windowexprs as twe
from spark_rapids_tpu_torch.ops import window as tops

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases, one_torch_thread

RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), one_torch_thread():
        yield


def assert_rows(got, want, ordered=True):
    """Rows equal: exact, floats to RTOL (NaN matches NaN)."""
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(y, float) and x is not None:
                assert x == pytest.approx(y, rel=RTOL, nan_ok=True), (g, w)
            else:
                assert x == y, (g, w)


def run_both(make_exprs, columns, n, batches=1, configure=None):
    """The same window expressions over the same batches in both packages:
    (JAX rows, port rows, the port's exec)."""
    pairs = [both_batch({k: (v[0][i::batches], v[1], v[2][i::batches])
                         if batches > 1 else v for k, v in columns.items()},
                        len(range(i, n, batches)))
             for i in range(batches)]
    jex = jw.WindowExec(make_exprs(jwe, jc), jb.InMemoryScanExec(
        [p[0] for p in pairs], pairs[0][0].schema))
    tex = tw.WindowExec(make_exprs(twe, tc), tb.InMemoryScanExec(
        [p[1] for p in pairs], pairs[0][1].schema))
    if configure is not None:
        configure(jex)
        configure(tex)
    jrows = [r for b in jex.execute() for r in b.to_pylist()]
    trows = [r for b in tex.execute() for r in b.to_pylist()]
    return jrows, trows, tex


def _columns(n, seed, key_card=7):
    rng = np.random.default_rng(seed)
    return {"k": (rng.integers(0, key_card, n).astype(np.int32), "INT",
                  rng.random(n) > 0.1),
            "v": (rng.integers(0, 10, n).astype(np.float64) / 2, "DOUBLE",
                  rng.random(n) > 0.1),
            "d": (rng.integers(0, 40, n).astype(np.int32), "INT",
                  rng.random(n) > 0.1),
            "x": (rng.random(n) * 100, "DOUBLE", rng.random(n) > 0.2),
            "i": (rng.integers(-5, 5, n).astype(np.int64), "LONG",
                  rng.random(n) > 0.2)}


def _window_exprs(we, c):
    """Every function over partition k (nulls a partition) ordered by the
    INT d DESC (nulls last, ties), under each frame kind: ROWS, RANGE with
    value offsets, unbounded and the default (RANGE to the current row's
    ties). (ASC orders with RANGE frames: P26 in
    test_torch_windows_slice.)"""
    W = we.WindowFrame
    spec = we.window([c.col("k")], [(c.col("d"), False)])

    def o(fn, name, fr=None):
        return (fn.over(spec.with_frame(fr) if fr else spec), name)
    x, i = c.col("x"), c.col("i")
    return [o(we.RowNumber(), "rn"), o(we.Rank(), "rk"),
            o(we.DenseRank(), "dr"), o(we.Lag(x, 1), "lag"),
            o(we.Lead(x, 2, 0.5), "lead"),
            o(we.FirstValue(x), "fv"), o(we.LastValue(x), "lv"),
            o(we.WindowAgg("sum", x), "s21", W.rows(2, 1)),
            o(we.WindowAgg("min", x), "runmin", W.rows(None, 0)),
            o(we.WindowAgg("max", x), "max11", W.rows(1, 1)),
            o(we.WindowAgg("count", None), "cnt"),
            o(we.WindowAgg("avg", x), "avg", W.unbounded()),
            o(we.WindowAgg("sum", i), "r31", W.range(3, 1)),
            o(we.WindowAgg("min", i), "rmin", W.range(None, 2)),
            o(we.WindowAgg("count", i), "rcnt", W.range(2, None)),
            o(we.WindowAgg("max", x), "wmax", W.unbounded()),
            o(we.WindowAgg("sum", i), "isum")]


def test_every_function_and_frame_matches_jax():
    jrows, trows, _ = run_both(_window_exprs, _columns(300, 0), 300)
    assert_rows(trows, jrows)


def test_unpartitioned_window_is_one_batch():
    """No partition keys: the batches concatenate into one partition.
    Against a numpy oracle (row order by x, nulls first; ties absent)."""
    n, parts = 200, 3
    cols = _columns(n, 2)
    x, xv = cols["x"][0], cols["x"][2]
    spec = twe.window([], [(tc.col("x"), True)])
    exprs = [(twe.RowNumber().over(spec), "rn"),
             (twe.WindowAgg("sum", tc.col("x")).over(spec), "run"),
             (twe.Lag(tc.col("x"), 1).over(spec), "lag"),
             (twe.WindowAgg("avg", tc.col("x")).over(
                 spec.with_frame(twe.WindowFrame.unbounded())), "avg")]
    pairs = [both_batch({c: (v[0][i::parts], v[1], v[2][i::parts])
                         for c, v in cols.items()}, len(range(i, n, parts)))
             for i in range(parts)]
    tex = tw.WindowExec(exprs, tb.InMemoryScanExec(
        [p[1] for p in pairs], pairs[0][1].schema))
    rows = [r for b in tex.execute() for r in b.to_pylist()]
    # the input order of the batches' rows, then sorted by x (nulls first)
    order = np.concatenate([np.arange(i, n, parts) for i in range(parts)])
    xs = np.where(xv, x, -np.inf)[order]
    idx = order[np.argsort(xs, kind="stable")]
    vals = [x[r] if xv[r] else None for r in idx]
    run = np.cumsum([v or 0.0 for v in vals])
    assert [r[5] for r in rows] == list(range(1, n + 1))
    np.testing.assert_allclose([r[6] if r[6] is not None else 0.0
                                for r in rows], run, rtol=RTOL)
    assert [r[7] for r in rows] == [None] + vals[:-1]
    mean = x[xv].mean()
    assert all(r[8] == pytest.approx(mean, rel=RTOL) for r in rows)


def test_partitions_spanning_sort_chunks():
    """Ten input batches: more sorted runs than the merge fan-in, so the
    sort emits chunks and each chunk holds back its last partition. Held
    to a numpy oracle (unique order keys fix the row order); the carry
    test below holds chunked input to the JAX package."""
    n, parts = 640, 10
    cols = _columns(n, 3, key_card=3)
    k = np.where(cols["k"][2], cols["k"][0], -1)
    x, xv = cols["x"][0], cols["x"][2]
    spec = twe.window([tc.col("k")], [(tc.col("x"), True)])
    exprs = [(twe.RowNumber().over(spec), "rn"),
             (twe.WindowAgg("sum", tc.col("x")).over(spec), "run")]
    pairs = [both_batch({c: (v[0][i::parts], v[1], v[2][i::parts])
                         for c, v in cols.items()}, len(range(i, n, parts)))
             for i in range(parts)]
    tex = tw.WindowExec(exprs, tb.InMemoryScanExec(
        [p[1] for p in pairs], pairs[0][1].schema))
    rows = [r for b in tex.execute() for r in b.to_pylist()]
    assert tex.metrics["partitionHostReads"].value > 1
    assert tex.metrics["carriedPartitions"].value == 0
    # the order: k (null first) ascending, then x (nulls first, distinct)
    xs = np.where(xv, x, -np.inf)
    want = []
    for kk in sorted(set(k.tolist())):
        idx = np.nonzero(k == kk)[0]
        idx = idx[np.argsort(xs[idx], kind="stable")]
        run = 0.0
        for j, r in enumerate(idx):
            run += x[r] if xv[r] else 0.0
            want.append((None if kk == -1 else kk, j + 1, run))
    got = [(r[0], r[5], r[6]) for r in rows]
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2] if g[2] is not None else 0.0
                                for g in got], [w[2] for w in want],
                               rtol=RTOL)


def _whole_partition_exprs(we, c):
    spec = we.window([c.col("k")]).with_frame(we.WindowFrame.unbounded())
    return [(we.WindowAgg("sum", c.col("x")).over(spec), "s"),
            (we.WindowAgg("avg", c.col("i")).over(spec), "a"),
            (we.WindowAgg("count", None).over(spec), "n"),
            (we.WindowAgg("min", c.col("i")).over(spec), "mn"),
            (we.WindowAgg("max", c.col("x")).over(spec), "mx")]


def test_giant_partition_takes_the_carry_like_jax():
    """A partition past TWO_PASS_THRESHOLD_ROWS (set to 100 on both
    instances) whose expressions are all whole-partition aggregates: the
    running state and spilled pieces, then the small partitions after
    it, each spanning the out-of-core sort's chunks."""
    rng = np.random.default_rng(4)
    cols = _columns(640, 4)
    k = np.where(rng.random(640) < 0.8, 0, rng.integers(1, 4, 640))
    cols["k"] = (k.astype(np.int32), "INT", np.ones(640, bool))

    def low(ex):
        ex.TWO_PASS_THRESHOLD_ROWS = 100
    jrows, trows, tex = run_both(_whole_partition_exprs, cols, 640,
                                 batches=10, configure=low)
    assert_rows(trows, jrows, ordered=False)
    assert tex.metrics["carriedPartitions"].value == 1
    assert tex.metrics["carryPieces"].value > 1
    assert tex.metrics["partitionHostReads"].value > 2


def test_sums_stay_segment_local():
    """A small partition sorted after 1e12-scale ones keeps its sums to
    rtol 1e-9: the prefix restarts at each segment (a global cumsum
    differenced at the segment start would lose them)."""
    rng = np.random.default_rng(5)
    big = rng.random(4000) * 1e12
    small = rng.random(40) * 1e-3
    v = np.concatenate([big, small])
    seg = np.concatenate([np.repeat(np.arange(40), 100),
                          np.full(40, 40)]).astype(np.int32)
    n = v.shape[0]
    cap = 4096 + 64
    vt = torch.zeros(cap, dtype=torch.float64)
    vt[:n] = torch.from_numpy(v)
    valid = torch.zeros(cap, dtype=torch.bool)
    valid[:n] = True
    st = torch.full((cap,), cap, dtype=torch.int32)
    st[:n] = torch.from_numpy(seg)
    nr = torch.tensor(n, dtype=torch.int32)
    s, c = tops.windowed_sum_count(vt, valid, st, nr, cap, None, 0)
    run = np.concatenate([np.cumsum(v[seg == g]) for g in range(41)])
    got = s[:n].numpy()
    np.testing.assert_allclose(got[-40:], run[-40:], rtol=RTOL)
    np.testing.assert_allclose(got, run, rtol=RTOL)
    assert c[:n].tolist() == [int(x) for g in range(41)
                              for x in np.arange(1, (seg == g).sum() + 1)]
    # the failure mode the reset guards against
    glob = np.cumsum(v)
    start = np.searchsorted(seg, seg)
    naive = glob - np.r_[0, glob][start]
    assert not np.allclose(naive[-40:], run[-40:], rtol=RTOL)


def test_segmented_scans_match_a_sequential_reference():
    """running min/max and the rank scan against a per-row loop, over
    random segments, nulls and a bool input."""
    rng = np.random.default_rng(6)
    n, cap = 300, 512
    seg = np.sort(rng.integers(0, 40, n)).astype(np.int32)
    vals = rng.integers(-50, 50, n).astype(np.int64)
    valid = rng.random(n) > 0.3
    st = torch.full((cap,), cap, dtype=torch.int32)
    st[:n] = torch.from_numpy(seg)
    vt = torch.zeros(cap, dtype=torch.int64)
    vt[:n] = torch.from_numpy(vals)
    ok = torch.zeros(cap, dtype=torch.bool)
    ok[:n] = torch.from_numpy(valid)
    nr = torch.tensor(n, dtype=torch.int32)
    mx, has = tops.running_min_max(vt, ok, st, nr, cap, True)
    for i in range(n):
        frame = [vals[j] for j in range(i + 1)
                 if seg[j] == seg[i] and valid[j]]
        assert bool(has[i]) == bool(frame)
        if frame:
            assert int(mx[i]) == max(frame)
    bnd = torch.zeros(cap, dtype=torch.bool)
    bnd[:n] = torch.from_numpy(rng.random(n) < 0.3)
    rank, dense = tops.rank_dense_rank(bnd, st, nr, cap)
    for i in range(n):
        s0 = int(np.argmax(seg == seg[i]))
        flags = [j == s0 or bool(bnd[j]) for j in range(s0, i + 1)]
        last = max(j for j, f in zip(range(s0, i + 1), flags) if f)
        assert int(rank[i]) == last - s0 + 1
        assert int(dense[i]) == sum(flags)
