"""Join keys and USING joins the port once refused, on the CPU.

- A left semi or left anti USING join (`df.join(other, on="k",
  how=...)`), whose sides share the key's name, equals the JAX package's
  rows; so does a nested-loop semi join of two sides with a shared name
  and no condition. (The pair schema of both sides is built only where a
  condition is bound to it.)
- DECIMAL(30,2) and DECIMAL(38,0) join keys, broadcast (HashJoinExec)
  and shuffled (ShuffledHashJoinExec over four host partitions), with
  and without a residual condition: rows and order equal the JAX
  package's. The join's bucket hash and Spark's partition hash of a
  decimal128 column equal the JAX package's (its decimal is a struct of
  the hi and lo limbs, hashed in that order).
- STRUCT join keys, held to a Python oracle of Spark's key-row equality
  (a null struct matches nothing; inside a struct a null field equals a
  null field and nothing else; a nested struct compares its fields, its
  own null included): keys that share a join bucket, a null field, a null
  struct and a nested struct, over inner, outer, semi and anti joins.
  The JAX package is kept off struct keys (ROADMAP C.5: its verify
  compares no field, so bucket-mates match); its murmur3 of a struct
  column, which the port's partition hash follows, is compared.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import exchange as jexchange
from spark_rapids_tpu.exec import joins as jjoins
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred
from spark_rapids_tpu.ops import hashing as jh

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import exchange as texchange
from spark_rapids_tpu_torch.exec import joins as tjoins
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import predicates as tpred
from spark_rapids_tpu_torch.ops import hashing as th
from spark_rapids_tpu_torch.ops import join as tj
from spark_rapids_tpu_torch.parallel.exchange import partition_ids

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs

JAX = SimpleNamespace(core=jcore, pred=jpred, basic=jbasic, joins=jjoins,
                      exchange=jexchange, t=jt, batch=jbatch,
                      session=jsession)
TORCH = SimpleNamespace(core=tcore, pred=tpred, basic=tbasic, joins=tjoins,
                        exchange=texchange, t=tt, batch=tbatch,
                        session=tsession)


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


def _batch(m, data, fields):
    """One batch of package `m`: {name: values}, fields [(name, type of
    m)]."""
    schema = m.t.Schema(tuple(m.t.StructField(n, ty) for n, ty in fields))
    kw = {"device": "cpu"} if m is TORCH else {}
    return m.batch.ColumnarBatch.from_pydict(data, schema, **kw)


def _scan(m, batch):
    return m.basic.InMemoryScanExec([batch], batch.schema)


def _rows(plan):
    plan._encoded_ok_for_parent = True
    return [r for b in plan.execute() for r in b.to_pylist()]


def _same_rows(got, want):
    assert [repr(r) for r in got] == [repr(r) for r in want]


# -- USING semi and anti joins -------------------------------------------------

@pytest.mark.parametrize("how", ["left_semi", "left_anti"])
def test_using_semi_and_anti_joins_match_jax(how):
    """Both sides carry `k`: the port used to raise 'duplicate column
    names' building the pair schema of a join with no condition."""
    rng = np.random.default_rng(3)
    k1 = [int(x) if x < 9 else None for x in rng.integers(0, 10, 50)]
    k2 = [int(x) for x in rng.integers(3, 12, 20)]
    out = []
    for m in (JAX, TORCH):
        t = m.t
        sess = m.session.TpuSession(device="cpu") if m is TORCH \
            else m.session.TpuSession()
        a = sess.from_pydict({"k": k1, "v": list(range(50))}, t.Schema((
            t.StructField("k", t.LONG), t.StructField("v", t.LONG))))
        b = sess.from_pydict({"k": k2, "w": list(range(20))}, t.Schema((
            t.StructField("k", t.LONG), t.StructField("w", t.LONG))))
        out.append(a.join(b, on="k", how=how).collect())
    _same_rows(out[1], out[0])
    keys = set(k2)
    want = [(k, v) for v, k in enumerate(k1)
            if (k in keys) == (how == "left_semi")]
    assert sorted(map(repr, out[1])) == sorted(map(repr, want))


def test_nested_loop_semi_join_of_shared_names_matches_jax():
    """A nested-loop semi join of two sides that share a name, with no
    condition: every stream row matches a nonempty build side."""
    out = []
    for m in (JAX, TORCH):
        left = _batch(m, {"k": [1, 2, 3]}, [("k", m.t.LONG)])
        right = _batch(m, {"k": [5, 6]}, [("k", m.t.LONG)])
        out.append(_rows(m.joins.NestedLoopJoinExec(
            _scan(m, left), _scan(m, right), "left_semi")))
    _same_rows(out[1], out[0])
    assert out[1] == [(1,), (2,), (3,)]


# -- DECIMAL(p>18) keys ----------------------------------------------------------

DECIMALS = {"30,2": (30, 2, 10 ** 24), "38,0": (38, 0, 10 ** 30)}


def _decimal_sides(m, spec, seed):
    p, s, scale = DECIMALS[spec]
    rng = np.random.default_rng(seed)
    dt = m.t.DecimalType(p, s)

    def keys(n, dom):
        k = rng.integers(-dom // 2, dom // 2, n)
        return [int(x) * scale + int(x) if x != 0 else None for x in k]
    left = _batch(m, {"lk": keys(90, 12), "lv": list(range(90))},
                  [("lk", dt), ("lv", m.t.LONG)])
    right = _batch(m, {"rk": keys(30, 10), "rv": list(range(0, 90, 3))},
                   [("rk", dt), ("rv", m.t.LONG)])
    return left, right


@pytest.mark.parametrize("spec", list(DECIMALS))
@pytest.mark.parametrize("jt_, cond", [("inner", False),
                                       ("left_outer", True),
                                       ("full_outer", False),
                                       ("left_anti", True)])
def test_decimal128_keys_broadcast_match_jax(spec, jt_, cond):
    """A broadcast hash join on DECIMAL(p>18) keys (both limbs and the
    validity compared): rows and order equal the JAX package's."""
    out = []
    for m in (JAX, TORCH):
        left, right = _decimal_sides(m, spec, seed=len(jt_))
        col = m.core.col
        c = m.pred.LessThan(col("lv"), col("rv")) if cond else None
        out.append(_rows(m.joins.HashJoinExec(
            _scan(m, left), _scan(m, right), [col("lk")], [col("rk")], jt_,
            condition=c)))
    _same_rows(out[1], out[0])
    assert len(out[1]) > 10


@pytest.mark.parametrize("spec", list(DECIMALS))
@pytest.mark.parametrize("jt_", ["inner", "left_semi"])
def test_decimal128_keys_shuffled_match_jax(spec, jt_):
    """Over four host partitions: the partition hash of a decimal128 key
    is the JAX package's, so each pair holds the same rows and the output
    order equals its."""
    from test_torch_exchange import JAX_CONF, PORT_CONF
    out = []
    for m, conf in ((JAX, JAX_CONF), (TORCH, PORT_CONF)):
        left, right = _decimal_sides(m, spec, seed=7)
        col = m.core.col
        lk, rk = [col("lk")], [col("rk")]
        out.append(_rows(m.exchange.ShuffledHashJoinExec(
            m.exchange.HostShuffleExchangeExec(lk, _scan(m, left), 4,
                                               conf=conf),
            m.exchange.HostShuffleExchangeExec(rk, _scan(m, right), 4,
                                               conf=conf),
            lk, rk, jt_)))
    _same_rows(out[1], out[0])
    assert len(out[1]) > 10


def _u32(h):
    return np.asarray(h).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("spec", list(DECIMALS))
def test_decimal128_hashes_match_jax(spec):
    """murmur3 (Spark's partition hash, seed 42) and the join's bucket
    hash pair of a decimal128 column with nulls, alone and after a LONG
    column, equal the JAX package's."""
    cols = []
    for m in (JAX, TORCH):
        left, _ = _decimal_sides(m, spec, seed=1)
        cols.append(left.columns)
    (jd, jl), (td, tl) = cols
    for jcols, tcols in (([jd], [td]), ([jl, jd], [tl, td])):
        np.testing.assert_array_equal(_u32(th.murmur3_batch(tcols, 42)),
                                      _u32(jh.murmur3_batch(jcols, 42)))
        from spark_rapids_tpu.ops import join as jj
        for g, w in zip(tj.join_hash_pair(tcols), jj.join_hash_pair(jcols)):
            np.testing.assert_array_equal(_u32(g), _u32(w))
    from spark_rapids_tpu.parallel.exchange import partition_ids as jpid
    np.testing.assert_array_equal(
        partition_ids([td], 90, td.capacity, 4).numpy(),
        np.asarray(jpid([jd], 90, jd.capacity, 4)))


# -- STRUCT keys -----------------------------------------------------------------

def _struct_type(m):
    t = m.t
    inner = t.StructType((t.StructField("x", t.INT),))
    return t.StructType((t.StructField("a", t.LONG),
                         t.StructField("b", t.STRING),
                         t.StructField("c", inner)))


def _bucket_mates(cap):
    """Two distinct non-null struct keys in one join bucket of a build
    side of capacity `cap` (found by hashing candidates)."""
    cands = [{"a": i % 5, "b": f"s{i}", "c": {"x": 1}} for i in range(4000)]
    col = tt_struct_column(cands, cap)
    h_hi, _ = tj.join_hash_pair([col])
    b = (th.u32_of(h_hi) >> (32 - tj._bucket_bits(cap)))[:len(cands)]
    seen = {}
    for i, v in enumerate(b.tolist()):
        if v in seen:
            return cands[seen[v]], cands[i]
        seen[v] = i
    raise AssertionError("no two keys share a bucket")


def tt_struct_column(values, cap):
    from spark_rapids_tpu_torch.columnar.column import StructColumn
    return StructColumn.from_pylist(values, _struct_type(TORCH),
                                    capacity=max(cap, len(values)),
                                    device="cpu")


def _struct_keys():
    """(stream keys, build keys): bucket-mates, a null field on one side
    or both, a null nested struct against a nested struct of a null field,
    a null struct, and ordinary repeats."""
    m1, m2 = _bucket_mates(128)
    base = [{"a": 1, "b": "x", "c": {"x": 2}},
            {"a": 1, "b": None, "c": {"x": 2}},
            {"a": None, "b": None, "c": None},
            {"a": 2, "b": "y", "c": {"x": None}},
            {"a": 2, "b": "y", "c": None},
            {"a": 0, "b": "s4", "c": {"x": 1}}]
    build = [m1, m1, base[0], base[1], base[2], base[3], base[4], None,
             base[5], {"a": 1, "b": "x", "c": {"x": 3}}]
    stream = [m2, m1, None, base[0], base[0], base[1], base[2], base[3],
              base[4], base[5], {"a": 1, "b": "z", "c": {"x": 2}}, m2, m1,
              {"a": 2, "b": None, "c": None}]
    return stream, build, (m1, m2)


def _struct_oracle(stream, build, jt_):
    """Spark's rows: a key matches an equal non-null key (None == None
    inside, so a null field equals a null field)."""
    out = []
    for i, s in enumerate(stream):
        hits = [j for j, b in enumerate(build)
                if s is not None and b is not None and s == b]
        if jt_ in ("inner", "left_outer"):
            out += [(s, i, build[j], j) for j in hits]
        if jt_ == "left_outer" and not hits:
            out.append((s, i, None, None))
        if jt_ == "left_semi" and hits:
            out.append((s, i))
        if jt_ == "left_anti" and not hits:
            out.append((s, i))
    return out


@pytest.mark.parametrize("jt_", ["inner", "left_outer", "left_semi",
                                 "left_anti"])
def test_struct_keys_match_spark_rows(jt_):
    stream, build, (m1, m2) = _struct_keys()
    st = _struct_type(TORCH)
    left = _batch(TORCH, {"lk": stream, "li": list(range(len(stream)))},
                  [("lk", st), ("li", tt.INT)])
    right = _batch(TORCH, {"rk": build, "ri": list(range(len(build)))},
                   [("rk", st), ("ri", tt.INT)])
    col = tcore.col
    plan = tjoins.HashJoinExec(_scan(TORCH, left), _scan(TORCH, right),
                               [col("lk")], [col("rk")], jt_)
    got = _rows(plan)
    want = _struct_oracle(stream, build, jt_)
    assert sorted(map(repr, got)) == sorted(map(repr, want))
    if jt_ == "inner":
        # stream row 0 (m2) has build rows 0 and 1 (m1, its bucket-mate)
        # among its candidates, and the verify dropped them
        build_t = plan.build_table_of([right], plan.children[1])
        counts = plan._counts_kernel(build_t, left)[1]
        assert m1 != m2 and int(counts[0]) >= 2
        assert not [r for r in got if r[1] == 0]
        assert len(got) == 11


def test_struct_key_hash_matches_jax():
    """murmur3 of a struct column (nulls at every level) equals the JAX
    package's struct hash: the port's partition hash of a struct key
    follows it."""
    stream, _, _ = _struct_keys()
    from spark_rapids_tpu.columnar.column import StructColumn as JStruct
    jcol = JStruct.from_pylist(stream, _struct_type(JAX))
    tcol = tt_struct_column(stream, jcol.capacity)
    np.testing.assert_array_equal(_u32(th.murmur3_batch([tcol], 42)),
                                  _u32(jh.murmur3_batch([jcol], 42)))
    seeds = torch.arange(tcol.capacity, dtype=torch.int32) * 7919
    np.testing.assert_array_equal(
        _u32(th.murmur3_column(tcol, seeds)),
        _u32(jh.murmur3_column(jcol, np.asarray(seeds.numpy()).view(
            np.uint32))))
