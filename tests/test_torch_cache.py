"""DataFrame.cache / unpersist and exec/cache.CachedRelation on the CPU.

The JAX package's cache cannot be run here as a reference (its own test
fails under this jax at the dispatch plane's `trace_state_clean`), so a
cached frame is held to the same plan uncached and to a numpy oracle:
the first action materializes the plan once into LZ4 frames, later
actions and other queries over the frame scan them (no second run of the
plan), unpersist drops them and the next action materializes again. The
frames carry every column kind, lists and strings among them.
"""

import numpy as np

from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.expr.core import col, lit


def _frame(sess, n=500, seed=0):
    rng = np.random.default_rng(seed)
    data = {"k": rng.integers(0, 9, n).tolist(),
            "x": rng.random(n).tolist(),
            "s": [f"s{v}" for v in rng.integers(0, 5, n)]}
    schema = tt.Schema((tt.StructField("k", tt.LONG),
                        tt.StructField("x", tt.DOUBLE),
                        tt.StructField("s", tt.STRING)))
    return sess.from_pydict(data, schema), data


def test_cache_matches_the_uncached_plan_and_numpy():
    sess = tsession.TpuSession(device="cpu")
    df, data = _frame(sess)
    base = df.filter(col("x") > lit(0.25))
    cached = base.cache()
    rel = cached._cached_relation
    assert not rel.is_materialized
    assert rel.estimated_size_bytes() == 1 << 62   # never broadcast yet
    assert cached.collect() == base.collect()
    assert rel.materializations == 1 and rel.compressed_bytes > 0
    q = cached.group_by("k").agg((F.sum("x"), "sx"), (F.count(), "n"))
    k, x = np.array(data["k"]), np.array(data["x"])
    keep = x > 0.25
    want = {kk: (x[keep & (k == kk)].sum(), int((keep & (k == kk)).sum()))
            for kk in np.unique(k[keep])}
    rows = q.collect()
    assert {r[0] for r in rows} == set(want)
    for kk, sx, cnt in rows:
        assert cnt == want[kk][1]
        assert abs(sx - want[kk][0]) <= 1e-9 * abs(want[kk][0])
    assert rows == base.group_by("k").agg((F.sum("x"), "sx"),
                                          (F.count(), "n")).collect()
    # two more queries over the frame: still one run of the plan
    assert cached.select(col("s")).collect() == base.select(col("s")) \
        .collect()
    assert rel.materializations == 1
    assert rel.estimated_size_bytes() == rel.compressed_bytes


def test_unpersist_drops_the_frames_and_the_next_action_rebuilds():
    sess = tsession.TpuSession(device="cpu")
    df, _ = _frame(sess, seed=1)
    cached = df.cache()
    first = cached.collect()
    rel = cached._cached_relation
    assert cached.unpersist() is cached
    assert not rel.is_materialized and rel.compressed_bytes == 0
    assert cached.collect() == first
    assert rel.materializations == 2
    # unpersist of a frame that was never cached is a no-op
    assert df.unpersist() is df


def test_cached_lists_and_windows():
    """The cache's frames carry list columns (a collect_list's output),
    and two window specs over one cached frame scan it once."""
    from spark_rapids_tpu_torch.expr.windowexprs import window
    sess = tsession.TpuSession(device="cpu")
    df, data = _frame(sess, seed=2)
    lists = df.group_by("k").agg((F.collect_list("x"), "xs")).cache()
    got = sorted(lists.collect())
    assert got == sorted(df.group_by("k").agg(
        (F.collect_list("x"), "xs")).collect())
    assert sum(len(r[1]) for r in got) == len(data["x"])
    cached = df.cache()
    w = window(["k"], [("x", False)])
    a = cached.with_windows((F.rank().over(w), "r")).filter(
        col("r") <= lit(2)).collect()
    b = cached.with_windows((F.window_sum("x").over(w), "sx")).collect()
    assert cached._cached_relation.materializations == 1
    assert len(a) == 2 * len(set(data["k"]))
    assert len(b) == len(data["k"])
