"""Every join type of the port's HashJoinExec (exec/joins.py) and the join
helpers of ops/join.py against the JAX package, on the CPU.

- `matched_flags`, `unmatched_indices`, `outer_extend_maps` and
  `cross_pairs` exact against the JAX functions (cross_pairs past 2^31
  flat pairs).
- HashJoinExec of inner, left/right/full outer, left semi, left anti and
  existence on the build sides the JAX package allows, with and without a
  residual condition, over LONG keys with duplicates and nulls on both
  sides and a stream of two batches: the output rows equal a nested-loop
  oracle as multisets, and with the condition their order equals the JAX
  package's bit for bit (pairs in candidate order, the unmatched stream
  rows after them in row order, the unmatched build rows after the last
  stream batch). The other key kinds over a few join types each against
  the JAX package and the rest against the oracle: INT keys, string and
  dictionary keys, DOUBLE keys with NaN and -0.0, and an INT key against
  a LONG key.
- ShuffledHashJoinExec of every join type against the oracle (four of
  them against the JAX package too), and each partition pair sizing its
  own candidate bucket under a speculation scope.
- The filter-absorption rule: a filter below the stream side of an anti
  join stays an operator (the filtered rows are not "unmatched").
- A group-by over the null-extended side of an outer join against a
  numpy oracle (the data under the null keys is zero in both packages).
- Semi, anti and existence joins refuse a build on the left.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.exec import aggregate as jagg
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import joins as jjoins
from spark_rapids_tpu.expr import aggexprs as jaggx
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred
from spark_rapids_tpu.ops import join as jj

from spark_rapids_tpu_torch.exec import aggregate as tagg
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import joins as tjoins
from spark_rapids_tpu_torch.expr import aggexprs as taggx
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import predicates as tpred
from spark_rapids_tpu_torch.ops import join as tj

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases

JAX = SimpleNamespace(core=jcore, pred=jpred, basic=jbasic, joins=jjoins,
                      agg=jagg, aggx=jaggx)
TORCH = SimpleNamespace(core=tcore, pred=tpred, basic=tbasic, joins=tjoins,
                        agg=tagg, aggx=taggx)
N_S, N_B = 300, 120       # stream rows (two batches), build rows
WORDS = ("REG AIR", "AIR", "RAIL", "SHIP", "", "a key past sixteen bytes")


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


# -- the helpers --------------------------------------------------------------

def test_matched_and_unmatched_match_jax():
    rng = np.random.default_rng(0)
    cap = 64
    idx = rng.integers(-1, 50, 200).astype(np.int32)
    verified = rng.random(200) > 0.5
    jm = jj.matched_flags(jnp.asarray(verified), jnp.asarray(idx), cap)
    tm = tj.matched_flags(torch.from_numpy(verified), torch.from_numpy(idx),
                          cap)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    for n in (0, 37, cap):
        ju, jn = jj.unmatched_indices(jm, jnp.int32(n), cap)
        tu, tn = tj.unmatched_indices(tm, torch.tensor(n), cap)
        assert int(tn) == int(jn)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


@pytest.mark.parametrize("null_on", ["build", "stream"])
def test_outer_extend_maps_match_jax(null_on):
    rng = np.random.default_rng(1)
    s_map = rng.integers(-1, 40, 64).astype(np.int32)
    b_map = rng.integers(-1, 40, 64).astype(np.int32)
    un = rng.integers(-1, 40, 32).astype(np.int32)
    for n_pairs, n_un in ((0, 0), (10, 5), (64, 32)):
        want = jj.outer_extend_maps(jnp.asarray(s_map), jnp.asarray(b_map),
                                    jnp.int32(n_pairs), jnp.asarray(un),
                                    jnp.int32(n_un), null_on, 128)
        got = tj.outer_extend_maps(torch.from_numpy(s_map),
                                   torch.from_numpy(b_map),
                                   torch.tensor(n_pairs),
                                   torch.from_numpy(un), torch.tensor(n_un),
                                   null_on, 128)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("s_rows, b_rows, start", [
    (7, 5, 0), (7, 5, 30), (7, 0, 0), (100_000, 30_000, (1 << 31) - 100)])
def test_cross_pairs_match_jax(s_rows, b_rows, start):
    cap = 256
    want = jj.cross_pairs(jnp.int32(s_rows), jnp.int32(b_rows),
                          jnp.int64(start), cap)
    got = tj.cross_pairs(s_rows, b_rows, start, cap, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got[0].dtype == torch.int32


# -- HashJoinExec -------------------------------------------------------------

def _keys(kind, rng, n, dom):
    """A key column spec {values, type, validity} of `kind`, ~10% null,
    drawn from `dom` distinct values (duplicates on both sides)."""
    valid = rng.random(n) > 0.1
    k = rng.integers(0, dom, n)
    if kind == "LONG":
        return (k.astype(np.int64) * 7919 - 10**12, "LONG", valid)
    if kind == "INT":
        return (k.astype(np.int32) * 31 - 500, "INT", valid)
    if kind == "DOUBLE":
        vals = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, np.inf, 3.0, 7.5])
        return (vals[k % len(vals)], "DOUBLE", valid)
    if kind == "dict":
        return ((k.astype(np.int32) % len(WORDS), WORDS), "STRING", valid)
    if kind == "str":
        return ([WORDS[i % len(WORDS)] for i in k], "STRING", valid)
    raise ValueError(kind)


def _sides(left_kind, right_kind, seed):
    rng = np.random.default_rng(seed)
    n_l, n_r = N_S, N_B
    left = {"lk": _keys(left_kind, rng, n_l, 40),
            "lv": (rng.random(n_l) * 100, "DOUBLE", rng.random(n_l) > 0.1),
            "li": (rng.integers(0, 9, n_l).astype(np.int32), "INT", None)}
    right = {"rk": _keys(right_kind, rng, n_r, 40),
             "rv": (rng.random(n_r) * 100, "DOUBLE", None),
             "rs": ([f"r{i}" * (i % 3) for i in range(n_r)], "STRING",
                    rng.random(n_r) > 0.1)}
    half = n_l // 2
    lb = [both_batch({k: (v[a:b] if not isinstance(v, tuple)
                          else (v[0][a:b], v[1]), ty,
                          None if va is None else va[a:b])
                      for k, (v, ty, va) in left.items()}, b - a)
          for a, b in ((0, half), (half, n_l))]
    rb = both_batch(right, n_r)
    return lb, rb, left, right


def _scan(m, batches):
    return m.basic.InMemoryScanExec(batches, batches[0].schema)


def _join(m, lbs, rb, jt, build, cond, left_filter=False):
    col, lit = m.core.col, m.core.lit
    left = _scan(m, lbs)
    if left_filter:
        left = m.basic.FilterExec(m.pred.GreaterThan(col("lv"), lit(30.0)),
                                  left)
    right = _scan(m, [rb])
    condition = m.pred.LessThan(col("lv"), col("rv")) if cond else None
    return m.joins.HashJoinExec(left, right, [col("lk")], [col("rk")], jt,
                                build_side=build, condition=condition)


def _rows(plan):
    plan._encoded_ok_for_parent = True
    return [r for b in plan.execute() for r in b.to_pylist()]


def _same_rows(got, want):
    assert [repr(r) for r in got] == [repr(r) for r in want]


def _value(x):
    return None if x is None else (0.0 if x == 0.0 and isinstance(x, float)
                                   else x)


def _multiset(rows):
    """Rows as a sorted list of reprs (NaN equal to NaN, -0.0 to 0.0)."""
    return sorted(repr(tuple(map(_value, r))) for r in rows)


def _oracle(left, right, n_l, n_r, jt, cond, left_filter=False):
    """The join by definition, as a multiset of rows."""
    return _multiset(_oracle_rows(left, right, n_l, n_r, jt, cond,
                                  left_filter))


def _oracle_rows(left, right, n_l, n_r, jt, cond, left_filter=False):
    """The join's rows by definition, in no particular order."""
    def rows(side, n):
        cols = []
        for v, ty, va in side.values():
            if isinstance(v, tuple):
                v = [v[1][c] for c in v[0]]
            v = v.tolist() if isinstance(v, np.ndarray) else list(v)
            va = [True] * n if va is None else list(va)
            cols.append([x if ok else None for x, ok in zip(v, va)])
        return list(zip(*cols))
    L_, R_ = rows(left, n_l), rows(right, n_r)
    if left_filter:
        L_ = [r for r in L_ if r[1] is not None and r[1] > 30.0]

    def match(lr, rr):
        a, b = lr[0], rr[0]
        if a is None or b is None or a != b:     # NaN != NaN
            return False
        return not cond or (lr[1] is not None and rr[1] is not None
                            and lr[1] < rr[1])
    out, r_hit = [], [False] * len(R_)
    for lr in L_:
        hits = [j for j, rr in enumerate(R_) if match(lr, rr)]
        for j in hits:
            r_hit[j] = True
        if jt in ("inner", "left_outer", "right_outer", "full_outer"):
            out += [lr + R_[j] for j in hits]
        if jt in ("left_outer", "full_outer") and not hits:
            out.append(lr + (None,) * len(R_[0]))
        if jt == "left_semi" and hits:
            out.append(lr)
        if jt == "left_anti" and not hits:
            out.append(lr)
        if jt == "existence":
            out.append(lr + (bool(hits),))
    if jt in ("right_outer", "full_outer"):
        out += [(None,) * len(L_[0]) + rr
                for rr, hit in zip(R_, r_hit) if not hit]
    return out


JOIN_SIDES = [(jt, b) for jt in ("inner", "left_outer", "right_outer",
                                 "full_outer")
              for b in ("right", "left")] + [
    ("left_semi", "right"), ("left_anti", "right"), ("existence", "right")]


@pytest.mark.parametrize("cond", [False, True], ids=["plain", "condition"])
@pytest.mark.parametrize("jt, build", JOIN_SIDES)
def test_join_type_matches_jax_long_keys(jt, build, cond):
    """With the condition, rows and order equal the JAX package's (each
    join type and build side once: its compile per case is what the test
    costs); with and without it, the rows equal the oracle's."""
    lbs, rb, left, right = _sides("LONG", "LONG", seed=3)
    trows = _rows(_join(TORCH, [b[1] for b in lbs], rb[1], jt, build, cond))
    if cond:
        jrows = _rows(_join(JAX, [b[0] for b in lbs], rb[0], jt, build,
                            cond))
        _same_rows(trows, jrows)
    want = _oracle(left, right, N_S, N_B, jt, cond)
    assert _multiset(trows) == want
    assert len(trows) > 20


#: key kinds: (left kind, right kind, join types held to the JAX package,
#: join types held to the oracle only)
KEY_CASES = {
    "INT keys": ("INT", "INT", ["left_anti"], ["left_outer", "full_outer"]),
    "string keys": ("str", "str", ["full_outer", "left_semi"],
                    ["existence"]),
    "dictionary keys": ("dict", "dict", ["right_outer"], ["left_anti"]),
    "dictionary stream, string build": ("dict", "str", ["left_outer"], []),
    "DOUBLE keys with NaN and -0.0": ("DOUBLE", "DOUBLE",
                                      ["inner", "full_outer"],
                                      ["left_semi"]),
    "INT against LONG": ("INT", "LONG", ["inner", "left_anti"],
                         ["left_outer"]),
}


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_join_types_match_jax_other_keys(case):
    """Each key kind on a few join types against the JAX package (rows
    and order) and on the rest against the oracle (rows)."""
    lk, rk, with_jax, oracle_only = KEY_CASES[case]
    lbs, rb, left, right = _sides(lk, rk, seed=len(case))
    for i, jt in enumerate(with_jax + oracle_only):
        build = "left" if jt in ("inner", "full_outer") and i % 2 else "right"
        cond = i % 2 == 1
        trows = _rows(_join(TORCH, [b[1] for b in lbs], rb[1], jt, build,
                            cond))
        if jt in with_jax:
            jrows = _rows(_join(JAX, [b[0] for b in lbs], rb[0], jt, build,
                                cond))
            _same_rows(trows, jrows)
        if lk == rk or case != "INT against LONG":
            assert _multiset(trows) == _oracle(left, right, N_S, N_B, jt,
                                               cond), jt


@pytest.mark.parametrize("jt", ["left_anti", "left_outer", "left_semi"])
def test_stream_filter_below_a_preserving_join(jt):
    """A filter under the stream side: absorbed as a key mask for semi,
    kept as an operator for anti and outer (its rows are not emitted as
    unmatched)."""
    lbs, rb, left, right = _sides("LONG", "LONG", seed=11)
    plan = _join(TORCH, [b[1] for b in lbs], rb[1], jt, "right", False,
                 left_filter=True)
    absorbed = plan._filters[0] is not None
    assert absorbed == (jt == "left_semi")
    trows = _rows(plan)
    jrows = _rows(_join(JAX, [b[0] for b in lbs], rb[0], jt, "right", False,
                        left_filter=True))
    _same_rows(trows, jrows)
    want = _oracle(left, right, N_S, N_B, jt, False, left_filter=True)
    assert _multiset(trows) == want


def test_group_by_over_the_null_extended_side_matches_numpy():
    """count and sum by the build side's key over a left outer join: the
    unmatched rows group under one null key in both packages, the same as
    a numpy oracle."""
    lbs, rb, left, right = _sides("LONG", "LONG", seed=5)
    out = []
    for m, k in ((JAX, 0), (TORCH, 1)):
        join = _join(m, [b[k] for b in lbs], rb[k], "left_outer", "right",
                     False)
        agg = m.agg.AggregateExec(
            [m.core.col("rk")], [(m.aggx.Count(), "n"),
                                 (m.aggx.Sum(m.core.col("li")), "s")], join)
        out.append(sorted(agg.collect(), key=repr))
    assert out[1] == out[0]
    rows = _oracle_rows(left, right, N_S, N_B, "left_outer", False)
    want = {}
    for r in rows:
        n, s = want.get(r[3], (0, 0))
        want[r[3]] = (n + 1, s + r[2])
    assert sorted(out[1], key=repr) == sorted(
        ((k, n, s) for k, (n, s) in want.items()), key=repr)
    assert any(r[0] is None for r in out[1])


def test_semi_anti_and_existence_build_right_only():
    lbs, rb, _, _ = _sides("LONG", "LONG", seed=2)
    for jt in ("left_semi", "left_anti", "existence"):
        with pytest.raises(ValueError, match="builds on the right"):
            _join(TORCH, [b[1] for b in lbs], rb[1], jt, "left", False)
    with pytest.raises(ValueError):
        _join(TORCH, [b[1] for b in lbs], rb[1], "cross", "right", False)


def test_existence_column_and_schema_match_jax():
    lbs, rb, _, _ = _sides("LONG", "LONG", seed=4)
    schemas = []
    for m, k in ((JAX, 0), (TORCH, 1)):
        col = m.core.col
        plan = m.joins.HashJoinExec(
            _scan(m, [b[k] for b in lbs]), _scan(m, [rb[k]]), [col("lk")],
            [col("rk")], "existence", exists_name="hit")
        schemas.append([(f.name, f.nullable, f.data_type.simple_name())
                        for f in plan.output_schema.fields])
    assert schemas[0] == schemas[1]
    assert schemas[1][-1] == ("hit", False, "boolean")


# -- ShuffledHashJoinExec -----------------------------------------------------

#: the shuffled joins held to the JAX package as well as the oracle: each
#: empty-partition rule once (an empty build side emitting unmatched
#: stream rows, an empty stream side emitting unmatched build rows, both)
SHUFFLED_WITH_JAX = {("right_outer", "left"), ("full_outer", "right"),
                     ("left_anti", "right"), ("existence", "right")}


@pytest.mark.parametrize("jt, build", [
    ("inner", "right"), ("left_outer", "right"), ("right_outer", "right"),
    ("right_outer", "left"), ("full_outer", "right"), ("full_outer", "left"),
    ("left_semi", "right"), ("left_anti", "right"), ("existence", "right")])
def test_shuffled_join_types_match_jax(jt, build):
    """Every join type over the host shuffle into 16 partitions, where
    many partitions hold rows on one side only: an empty build side still
    emits its stream rows as unmatched (outer, anti, existence), an empty
    stream side its build rows (a build-preserving outer join), and the
    build flags start over for each partition pair. The rows equal a
    nested-loop oracle's; in SHUFFLED_WITH_JAX, rows and order also equal
    the JAX package's ShuffledHashJoinExec."""
    from spark_rapids_tpu.config import RapidsConf
    from spark_rapids_tpu.exec import exchange as jexchange
    from spark_rapids_tpu_torch.exec import exchange as texchange
    conf = RapidsConf({"spark.rapids.tpu.adaptive.enabled": False,
                       "spark.rapids.tpu.task.partitionRecovery.enabled":
                       False})
    rng = np.random.default_rng(9)
    n_l, n_r = 60, 14
    left = {"lk": (rng.integers(0, 40, n_l).astype(np.int64), "LONG",
                   rng.random(n_l) > 0.1),
            "lv": (rng.random(n_l) * 100, "DOUBLE", None),
            "li": (rng.integers(0, 9, n_l).astype(np.int32), "INT", None)}
    right = {"rk": (rng.integers(20, 60, n_r).astype(np.int64), "LONG",
                    None),
             "rv": (rng.random(n_r) * 100, "DOUBLE", None),
             "rs": ([f"r{i}" for i in range(n_r)], "STRING", None)}
    lb, rb = both_batch(left, n_l), both_batch(right, n_r)
    out = []
    sides = [(TORCH, texchange, 1, {})]
    if (jt, build) in SHUFFLED_WITH_JAX:
        sides.insert(0, (JAX, jexchange, 0, {"conf": conf}))
    for m, ex, k, kw in sides:
        col = m.core.col
        lk, rk = [col("lk")], [col("rk")]
        plan = ex.ShuffledHashJoinExec(
            ex.HostShuffleExchangeExec(lk, _scan(m, [lb[k]]), 16, **kw),
            ex.HostShuffleExchangeExec(rk, _scan(m, [rb[k]]), 16, **kw),
            lk, rk, jt, build_side=build,
            condition=m.pred.LessThan(col("lv"), col("rv")))
        out.append([r for b in plan.execute() for r in b.to_pylist()])
    if len(out) == 2:
        _same_rows(out[1], out[0])
    assert _multiset(out[-1]) == _oracle(left, right, n_l, n_r, jt, True)



@pytest.mark.parametrize("jt", ["inner", "left_semi", "left_outer"])
def test_shuffled_join_sizes_each_partition_pair(jt):
    """Under a speculation scope each partition pair sizes its own
    candidate bucket. Every pair has the same row counts (64 build rows,
    16 stream rows, so the same capacities), but one pair, in turn each
    after the first, has 64 times the candidates of the others: no flag
    trips, and the rows equal the exact run's."""
    from spark_rapids_tpu_torch.exec import exchange as texchange
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.parallel.exchange import partition_ids
    from spark_rapids_tpu_torch.types import LONG
    col = tcore.col
    n_parts, n_b, n_s = 4, 64, 16
    pool = torch.arange(4000, dtype=torch.int64)
    pid = partition_ids([Column(pool, torch.ones(4000, dtype=torch.bool),
                                LONG)], 4000, 4000, n_parts).numpy()
    by_part = [pool.numpy()[pid == p] for p in range(n_parts)]
    for heavy in range(1, n_parts):
        build, stream = [], []
        for p, ks in enumerate(by_part):
            dup = n_b if p == heavy else 1
            build += [ks[0]] * dup + list(ks[1: 1 + n_b - dup])
            stream += [ks[0]] * n_s
        right = {"rk": (np.array(build, np.int64), "LONG", None)}
        left = {"lk": (np.array(stream, np.int64), "LONG", None),
                "lv": (np.arange(len(stream), dtype=np.int32), "INT", None)}
        lb = both_batch(left, len(stream))[1]
        rb = both_batch(right, len(build))[1]

        def plan():
            lk, rk = [col("lk")], [col("rk")]
            return texchange.ShuffledHashJoinExec(
                texchange.HostShuffleExchangeExec(lk, _scan(TORCH, [lb]),
                                                  n_parts),
                texchange.HostShuffleExchangeExec(rk, _scan(TORCH, [rb]),
                                                  n_parts),
                lk, rk, jt)
        want = _rows(plan())
        with speculation_scope() as scope:
            got = _rows(plan())
            assert not scope.tripped(), heavy
        _same_rows(got, want)
