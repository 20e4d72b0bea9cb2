"""The port's NestedLoopJoinExec (exec/joins.py) against the JAX package's,
on the CPU: inner, cross, left outer, left semi, left anti and existence,
with a band condition and without, over a stream of two batches with a
string column on each side, in chunks smaller than one stream batch's
pairs (so a batch spans several chunks and a chunk's bucket passes its
nominal size). Rows and their order equal the JAX package's bit for bit,
and the rows equal a nested-loop oracle as a multiset. A build side with
no rows, and the join types the operator does not have, are covered too.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import joins as jjoins
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred

from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import joins as tjoins
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import predicates as tpred

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases

JAX = SimpleNamespace(core=jcore, pred=jpred, basic=jbasic, joins=jjoins)
TORCH = SimpleNamespace(core=tcore, pred=tpred, basic=tbasic, joins=tjoins)
N_S, N_B = 90, 11


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _data(seed=0, n_b=N_B):
    rng = np.random.default_rng(seed)
    stream = {"d": (np.round(rng.random(N_S) * 0.12, 4), "DOUBLE",
                    rng.random(N_S) > 0.1),
              "q": (rng.integers(1, 51, N_S).astype(np.int64), "LONG", None),
              "s": ([f"line{i}" * (i % 3) for i in range(N_S)], "STRING",
                    rng.random(N_S) > 0.1)}
    build = {"band": (np.arange(n_b, dtype=np.int32), "INT", None),
             "lo": (np.arange(n_b) / 100.0, "DOUBLE", None),
             "hi": ((np.arange(n_b) + 1) / 100.0, "DOUBLE", None),
             "name": ([f"band-{k}" for k in range(n_b)], "STRING", None)}
    half = N_S // 2
    sb = [both_batch({k: (v[a:b], ty, None if va is None else va[a:b])
                      for k, (v, ty, va) in stream.items()}, b - a)
          for a, b in ((0, half), (half, N_S))]
    return sb, both_batch(build, n_b), stream, build


def _plan(m, sbs, bb, jt, cond, chunk_rows):
    col = m.core.col
    condition = m.pred.And(m.pred.GreaterThanOrEqual(col("d"), col("lo")),
                           m.pred.LessThan(col("d"), col("hi"))) \
        if cond else None
    return m.joins.NestedLoopJoinExec(
        m.basic.InMemoryScanExec(sbs, sbs[0].schema),
        m.basic.InMemoryScanExec([bb], bb.schema), jt, condition,
        chunk_rows=chunk_rows)


def _rows(plan):
    return [r for b in plan.execute() for r in b.to_pylist()]


def _oracle(stream, build, n_b, jt, cond):
    def rows(side, n):
        cols = []
        for v, _, va in side.values():
            v = v.tolist() if isinstance(v, np.ndarray) else list(v)
            va = [True] * n if va is None else list(va)
            cols.append([x if ok else None for x, ok in zip(v, va)])
        return list(zip(*cols))
    out = []
    brows = rows(build, n_b)
    for s in rows(stream, N_S):
        hits = [b for b in brows if not cond or (
            s[0] is not None and b[1] <= s[0] < b[2])]
        if jt in ("inner", "cross", "left_outer"):
            out += [s + b for b in hits]
        if jt == "left_outer" and not hits:
            out.append(s + (None,) * 4)
        if jt == "left_semi" and hits:
            out.append(s)
        if jt == "left_anti" and not hits:
            out.append(s)
        if jt == "existence":
            out.append(s + (bool(hits),))
    return sorted(map(repr, out))


@pytest.mark.parametrize("cond", [True, False], ids=["band", "all pairs"])
@pytest.mark.parametrize("jt", ["inner", "cross", "left_outer", "left_semi",
                                "left_anti", "existence"])
def test_nested_loop_join_matches_jax(jt, cond):
    sbs, bb, stream, build = _data(seed=len(jt))
    trows = _rows(_plan(TORCH, [b[1] for b in sbs], bb[1], jt, cond, 100))
    jrows = _rows(_plan(JAX, [b[0] for b in sbs], bb[0], jt, cond, 100))
    assert [repr(r) for r in trows] == [repr(r) for r in jrows]
    assert sorted(map(repr, trows)) == _oracle(stream, build, N_B, jt, cond)


@pytest.mark.parametrize("jt", ["inner", "left_outer", "left_anti",
                                "existence"])
def test_nested_loop_join_empty_build_matches_jax(jt):
    sbs, bb, stream, build = _data(seed=3, n_b=0)
    trows = _rows(_plan(TORCH, [b[1] for b in sbs], bb[1], jt, True, 64))
    jrows = _rows(_plan(JAX, [b[0] for b in sbs], bb[0], jt, True, 64))
    assert [repr(r) for r in trows] == [repr(r) for r in jrows]
    assert sorted(map(repr, trows)) == _oracle(stream, build, 0, jt, True)


def test_nested_loop_join_schema_and_refusals():
    sbs, bb, _, _ = _data()
    for jt in ("left_outer", "existence", "left_semi"):
        j = _plan(JAX, [b[0] for b in sbs], bb[0], jt, True, 64)
        t = _plan(TORCH, [b[1] for b in sbs], bb[1], jt, True, 64)
        assert [(f.name, f.nullable) for f in t.output_schema.fields] == \
            [(f.name, f.nullable) for f in j.output_schema.fields]
    for jt in ("right_outer", "full_outer"):
        with pytest.raises(ValueError, match="NestedLoopJoinExec joins"):
            _plan(TORCH, [b[1] for b in sbs], bb[1], jt, True, 64)
