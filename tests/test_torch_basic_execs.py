"""RangeExec, UnionExec, LocalLimitExec, GlobalLimitExec and ExpandExec of
the port (exec/basic.py) against the JAX package's, on the CPU: the same
batches, row counts and rows, exact. Range: ascending, descending, empty
and past one batch; limits of 0, inside a batch, on a batch boundary and
past the input, with offsets that skip whole batches; Expand: the
grouping sets of TPC-H Q1's aggregate over a string and an INT column,
typed null literals among the projections, and an aggregate over its
output against a numpy oracle.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.exec import aggregate as jagg
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.expr import aggexprs as jaggx
from spark_rapids_tpu.expr import core as jcore

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.exec import aggregate as tagg
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.expr import aggexprs as taggx
from spark_rapids_tpu_torch.expr import core as tcore

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases

JAX = SimpleNamespace(t=jt, core=jcore, basic=jbasic, agg=jagg, aggx=jaggx)
TORCH = SimpleNamespace(t=tt, core=tcore, basic=tbasic, agg=tagg,
                        aggx=taggx)


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _batches_out(plan):
    return [(b.num_rows_host, b.to_pylist()) for b in plan.execute()]


@pytest.mark.parametrize("start, end, step, batch_rows", [
    (0, 1000, 1, 256), (10, -7, -3, 4), (5, 5, 1, 8), (-3, 60, 7, 4)])
def test_range_matches_jax(start, end, step, batch_rows):
    j = jbasic.RangeExec(start, end, step, batch_rows=batch_rows, name="r")
    t = tbasic.RangeExec(start, end, step, batch_rows=batch_rows, name="r",
                         device="cpu")
    got, want = _batches_out(t), _batches_out(j)
    assert got == want
    assert [r[0] for _, rows in got for r in rows] == \
        list(range(start, end, step))
    assert [(f.name, f.nullable) for f in t.output_schema.fields] == \
        [(f.name, f.nullable) for f in j.output_schema.fields]


def _parts(sizes, seed=0):
    """Both packages' batches of the given sizes: an INT, a nullable
    DOUBLE and a string column."""
    rng = np.random.default_rng(seed)
    out = ([], [])
    for i, n in enumerate(sizes):
        pair = both_batch({
            "a": (np.arange(n, dtype=np.int32) + 100 * i, "INT", None),
            "b": (rng.random(n), "DOUBLE", rng.random(n) > 0.2),
            "s": ([f"s{i}-{k}" for k in range(n)], "STRING", None)}, n)
        out[0].append(pair[0])
        out[1].append(pair[1])
    return out


def _scan(m, batches):
    return m.basic.InMemoryScanExec(batches, batches[0].schema)


def test_union_matches_jax():
    jb, tb = _parts([5, 7, 9])
    j = jbasic.UnionExec(_scan(JAX, jb[:2]), _scan(JAX, jb[2:]))
    t = tbasic.UnionExec(_scan(TORCH, tb[:2]), _scan(TORCH, tb[2:]))
    assert _batches_out(t) == _batches_out(j)
    assert len(list(t.execute())) == 3


@pytest.mark.parametrize("limit, offset", [
    (0, 0), (3, 0), (5, 0), (12, 0), (100, 0), (3, 2), (6, 5), (10, 6),
    (4, 20), (100, 12)])
def test_limits_match_jax(limit, offset):
    jb, tb = _parts([5, 7, 9], seed=1)
    rows = [r for b in tb for r in b.to_pylist()]
    for cls in ("LocalLimitExec", "GlobalLimitExec"):
        if cls == "LocalLimitExec" and offset:
            continue
        kw = {"offset": offset} if cls == "GlobalLimitExec" else {}
        j = getattr(jbasic, cls)(limit, _scan(JAX, jb), **kw)
        t = getattr(tbasic, cls)(limit, _scan(TORCH, tb), **kw)
        got = _batches_out(t)
        assert got == _batches_out(j)
        assert [r for _, b in got for r in b] == rows[offset:offset + limit]


def _expand(m, batches):
    """TPC-H Q1's grouping sets ((returnflag, linestatus), ()) as an
    Expand: the keys and a grouping id, then sum(quantity) and count by
    (returnflag, linestatus, gid)."""
    col, Literal = m.core.col, m.core.Literal
    t = m.t
    sets = [[col("rf"), col("ls"), col("q"), Literal(0, t.INT).alias("gid")],
            [Literal(None, t.STRING).alias("rf"),
             Literal(None, t.INT).alias("ls"), col("q"),
             Literal(3, t.INT).alias("gid")]]
    expand = m.basic.ExpandExec(sets, _scan(m, batches))
    agg = m.agg.AggregateExec(
        [col("rf"), col("ls"), col("gid")],
        [(m.aggx.Sum(col("q")), "sum_q"), (m.aggx.Count(), "n")], expand)
    return expand, agg


def test_expand_grouping_sets_match_jax_and_numpy():
    rng = np.random.default_rng(2)
    n = 500
    flags = np.array(["A", "N", "R"])[rng.integers(0, 3, n)]
    status = rng.integers(0, 2, n).astype(np.int32)
    qty = rng.integers(1, 51, n).astype(np.int64)
    jb, tb = both_batch({"rf": (list(flags), "STRING", None),
                         "ls": (status, "INT", None),
                         "q": (qty, "LONG", None)}, n)
    (jx, ja), (tx, ta) = _expand(JAX, [jb]), _expand(TORCH, [tb])
    assert _batches_out(tx) == _batches_out(jx)
    assert [(f.name, f.nullable) for f in tx.output_schema.fields] == \
        [(f.name, f.nullable) for f in jx.output_schema.fields]
    got = sorted(ta.collect(), key=repr)
    assert got == sorted(ja.collect(), key=repr)
    want = [(None, None, 3, int(qty.sum()), n)]
    for f in "ANR":
        for s in (0, 1):
            m = (flags == f) & (status == s)
            want.append((f, s, 0, int(qty[m].sum()), int(m.sum())))
    assert got == sorted(want, key=repr)
