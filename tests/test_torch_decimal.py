"""The port's decimals against the JAX package's, on the CPU:
`DecimalType` (to 38 digits), `Decimal128Column` and its row movement
(gather, compaction, concat, slice, empty batch, the shuffle's frames),
decimal arithmetic with Spark's DecimalPrecision types and overflow to
null, the plan-time tag-offs of decimal128 multiply and divide and of a
decimal average, and decimal sums in both aggregate tiers, as a grand
aggregate and in partial/final mode over the host shuffle.

The same unscaled values (numpy seed) build both packages' columns;
every unscaled result, its validity and its type must match bit for bit,
and the sums equal Python ints. The JAX side runs eagerly on the CPU.
"""

import decimal
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.columnar.column import Decimal128Column as JDec
from spark_rapids_tpu.expr import arithmetic as jarith
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.shuffle import serializer as jser

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import functions as tF
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.columnar.batch import empty_batch
from spark_rapids_tpu_torch.columnar.column import Column as TColumn
from spark_rapids_tpu_torch.columnar.column import Decimal128Column as TDec
from spark_rapids_tpu_torch.expr import arithmetic as tarith
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.ops import basic as tbasic
from spark_rapids_tpu_torch.plan.overrides import PlanNotSupported
from spark_rapids_tpu_torch.shuffle import serializer

from test_torch_jax_ref import jax_aliases
from test_torch_planner import active_confs

JAX = SimpleNamespace(t=jt, core=jcore, ar=jarith, F=jF, session=jsession,
                      Batch=JBatch)
TORCH = SimpleNamespace(t=tt, core=tcore, ar=tarith, F=tF,
                        session=tsession, Batch=TBatch)
N = 300


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs():
        yield


def both_decimal(values, p, s, validity):
    """(JAX column, port column) of DECIMAL(p, s) from unscaled ints."""
    vals = [int(v) if ok else None for v, ok in zip(values, validity)]
    tc = TDec.from_pylist(vals, tt.DecimalType(p, s), device="cpu") \
        if p > 18 else TColumn.from_pylist(vals, tt.DecimalType(p, s),
                                           device="cpu")
    jdt = jt.DecimalType(p, s)
    if p > 18:
        v = jnp.asarray(tc.validity.numpy())
        jc = JDec((JColumn(jnp.asarray(tc.hi.data.numpy()), v, jt.LONG),
                   JColumn(jnp.asarray(tc.lo.data.numpy()), v, jt.LONG)),
                  v, jdt)
    else:
        jc = JColumn(jnp.asarray(tc.data.numpy()),
                     jnp.asarray(tc.validity.numpy()), jdt)
    return jc, tc


def both_int(values, type_name, validity):
    tc = TColumn.from_numpy(values, getattr(tt, type_name), validity=validity,
                            device="cpu")
    jc = JColumn(jnp.asarray(tc.data.numpy()),
                 jnp.asarray(tc.validity.numpy()), getattr(jt, type_name))
    return jc, tc


def _table(seed=0, n=N):
    """Columns of several decimal types with nulls, edges at the top of
    each precision, and a key and an INT column."""
    rng = np.random.default_rng(seed)

    def dec(p):
        top = 10 ** min(p, 18) - 1
        v = [int(x) for x in rng.integers(-top, top, n, endpoint=True)]
        if p > 18:
            v = [x * 10 ** (p - 18) + int(y) for x, y in
                 zip(v, rng.integers(0, 10 ** min(p - 18, 18), n))]
        v[:4] = [10 ** p - 1, -(10 ** p - 1), 0, 1]
        return v

    spec = {"a": (12, 2), "b": (10, 3), "c": (18, 0), "w": (30, 2),
            "x": (38, 4)}
    cols = {k: (dec(p), p, s, rng.random(n) > 0.1) for k, (p, s) in
            spec.items()}
    small = rng.integers(-50, 50, n).astype(np.int32)
    small[5:15] = 0                                    # divide by zero
    return cols, small, rng.integers(0, 5, n).astype(np.int32), \
        rng.random(n) > 0.1


def both_batches(seed=0, n=N):
    cols, small, keys, kvalid = _table(seed, n)
    pairs, fields_j, fields_t = [], [], []
    for name, (vals, p, s, valid) in cols.items():
        pairs.append(both_decimal(vals, p, s, valid))
        fields_j.append(jt.StructField(name, jt.DecimalType(p, s)))
        fields_t.append(tt.StructField(name, tt.DecimalType(p, s)))
    for name, vals, valid, ty in (("i", small, np.ones(n, bool), "INT"),
                                  ("k", keys, kvalid, "INT")):
        pairs.append(both_int(vals, ty, valid))
        fields_j.append(jt.StructField(name, getattr(jt, ty)))
        fields_t.append(tt.StructField(name, getattr(tt, ty)))
    jb = JBatch([p[0] for p in pairs], n, jt.Schema(tuple(fields_j)))
    tb = TBatch([p[1] for p in pairs], n, tt.Schema(tuple(fields_t)))
    return jb, tb, cols


def _same_column(jc, tc, n):
    assert repr(tc.dtype) == jc.dtype.simple_name()
    assert type(tc).__name__ == type(jc).__name__
    np.testing.assert_array_equal(tc.validity.numpy(),
                                  np.asarray(jc.validity))
    assert tc.to_pylist(n) == jc.to_pylist(n)
    if isinstance(tc, TDec):
        np.testing.assert_array_equal(tc.hi.data.numpy(),
                                      np.asarray(jc.hi.data))
        np.testing.assert_array_equal(tc.lo.data.numpy(),
                                      np.asarray(jc.lo.data))
    else:
        np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))


def test_decimal_type_matches_jax():
    for p, s in ((1, 0), (12, 2), (18, 18), (19, 2), (38, 10)):
        a, b = tt.DecimalType(p, s), jt.DecimalType(p, s)
        assert repr(a) == b.simple_name()
        assert a.is_decimal128 == b.is_decimal128
        assert a == tt.DecimalType(p, s) and a != tt.DecimalType(p, s - 1
                                                                 if s else 1)
    with pytest.raises(ValueError):
        tt.DecimalType(39, 0)
    with pytest.raises(TypeError, match="DecimalPrecision"):
        tt.numeric_promote(tt.DecimalType(10, 2), tt.DOUBLE)
    with pytest.raises(TypeError):
        tcore.lit(decimal.Decimal("1.5"))


def test_decimal128_column_round_trips_and_moves_rows():
    jb, tb, cols = both_batches()
    w_vals, p, s, w_valid = cols["w"]
    jw, tw = jb.columns[3], tb.columns[3]
    _same_column(jw, tw, N)
    want = [v if ok else None for v, ok in zip(w_vals, w_valid)]
    assert tw.to_pylist(N) == want
    i = int(np.argmax(w_valid))
    assert tw.to_decimal_list(N)[i] == decimal.Decimal(
        f"{w_vals[i]}E-{s}")
    # compaction through the packed row gather, the limbs as two lanes
    keep = torch.from_numpy(np.arange(tb.capacity) % 3 != 1)
    out, n = tbasic.compact_columns(list(tb.columns), keep, tb.num_rows)
    rows = [i for i in range(N) if i % 3 != 1]
    assert out[3].to_pylist(int(n)) == [want[i] for i in rows]
    assert out[0].to_pylist(int(n)) == [tb.columns[0].to_pylist(N)[i]
                                        for i in rows]
    cat = tbasic.concat_columns(tw, tw, N, N, 1024)
    assert cat.to_pylist(2 * N) == want + want
    sl = tbasic.slice_rows(tw, 7, 20, 128)
    assert sl.to_pylist(20) == want[7:27]
    assert tbasic.sanitize(tw, 10).to_pylist(12) == want[:10] + [None] * 2
    empty = empty_batch(tb.schema, device="cpu")
    assert isinstance(empty.columns[3], TDec)
    # the shuffle's frames carry the limbs as the JAX package's do
    back = serializer.deserialize_batch(serializer.serialize_batch(tb),
                                        tb.schema)
    for c, b in zip(tb.columns, back.columns):
        assert b.to_pylist(N) == c.to_pylist(N)


@pytest.mark.parametrize("codec", [serializer.CODEC_COPY,
                                   serializer.CODEC_LZ4])
def test_decimal_frames_are_byte_identical_to_jax(codec):
    """DECIMAL(p<=18) as its int64 lane and decimal128 as its validity and
    two limbs: the port's frame of a batch is the JAX package's, byte for
    byte, and each package decodes the other's to the same rows."""
    jb, tb, _ = both_batches(seed=4)
    frame = serializer.serialize_batch(tb, codec)
    assert frame == jser.serialize_batch(jb, codec)
    back = serializer.deserialize_batch(jser.serialize_batch(jb, codec),
                                        tb.schema)
    jback = jser.deserialize_batch(frame, jb.schema)
    for c, t, j in zip(tb.columns, back.columns, jback.columns):
        assert type(t) is type(c)
        assert t.to_pylist(N) == c.to_pylist(N) == j.to_pylist(N)


CASES = [
    ("Add", "a", "b"), ("Subtract", "b", "a"), ("Multiply", "a", "b"),
    ("Divide", "a", "b"), ("Remainder", "a", "b"), ("Pmod", "b", "a"),
    ("IntegralDivide", "a", "b"), ("Add", "a", "i"), ("Multiply", "c", "i"),
    ("Divide", "a", "i"), ("Add", "w", "a"), ("Subtract", "x", "w"),
    ("Add", "x", "x"), ("Multiply", "a", "c"), ("Multiply", "c", "c"),
    ("Divide", "c", "a"),
]


@pytest.mark.parametrize("op, left, right", CASES)
def test_decimal_arithmetic_matches_jax(op, left, right):
    """Result type, unscaled values and nulls (divide by zero, overflow
    past the result precision) bit for bit, one and two limbs."""
    jb, tb, _ = both_batches(seed=1)
    outs = []
    for m, b in ((JAX, jb), (TORCH, tb)):
        e = getattr(m.ar, op)(m.core.col(left), m.core.col(right))
        outs.append(m.core.resolve(e, b.schema).columnar_eval(b))
    _same_column(*outs, N)


def test_decimal_overflow_is_null():
    jb, tb, cols = both_batches(seed=2)
    t = tcore.resolve(tarith.Add(tcore.col("x"), tcore.col("x")),
                      tb.schema).columnar_eval(tb)
    got = t.to_pylist(N)
    assert got[0] is None and got[1] is None      # +-(10^38 - 1) doubled
    vals, _, _, valid = cols["x"]
    for i in range(4, N):
        want = 2 * vals[i] if valid[i] and abs(2 * vals[i]) < 10 ** 38 \
            else None
        assert got[i] == want


@pytest.mark.parametrize("expr, reason", [
    ("w * a", "decimal multiply with >18-digit inputs needs a 256-bit "
              "intermediate"),
    ("w / a", "decimal divide with >18-digit inputs has no device kernel"),
    ("avg(a)", "avg over a DECIMAL"),
])
def test_decimal128_tag_offs(expr, reason):
    """A multiply or divide with a >18-digit input is tagged off at plan
    time with the JAX package's reason; an average over a DECIMAL, whose
    evaluation raises in the JAX package, is tagged off too."""
    jb, tb, _ = both_batches(seed=3)
    reports = []
    for m, b, dev in ((JAX, jb, {}), (TORCH, tb, {"device": "cpu"})):
        sess = m.session.TpuSession(**dev)
        df = sess.from_batches([b], b.schema)
        col = m.core.col
        if expr == "avg(a)":
            q = df.group_by("k").agg((m.F.avg(col("a")), "v"))
        elif expr == "w * a":
            q = df.select((col("w") * col("a")).alias("v"))
        else:
            q = df.select(m.ar.Divide(col("w"), col("a")).alias("v"))
        reports.append(q)
    with pytest.raises(PlanNotSupported, match=reason):
        reports[1].collect()
    if expr != "avg(a)":
        assert reason in reports[0].explain()
    else:
        with pytest.raises(AttributeError, match="precision"):
            reports[0].collect()


def _sum_oracle(cols, keys, kvalid, name, rows=None):
    vals, p, s, valid = cols[name]
    out = {}
    for i, (v, ok) in enumerate(zip(vals, valid)):
        if rows is not None and not rows[i]:
            continue
        k = int(keys[i]) if kvalid[i] else None
        cur = out.setdefault(k, None)
        if ok:
            out[k] = v if cur is None else cur + v
    rp = min(p + 10, 38)
    return {k: (None if v is None or abs(v) >= 10 ** rp else v)
            for k, v in out.items()}


@pytest.mark.parametrize("tier", ["speculative", "exact", "grand",
                                  "partial/final"])
def test_decimal_sums_match_jax_and_python(tier):
    """sum() of each decimal type, grouped or grand, in the masked
    speculative tier, the exact tier and partial -> host shuffle ->
    final: equal to the JAX package's rows and to Python ints; a sum past
    the result precision (DECIMAL(38, 4) here) is NULL."""
    jb, tb, cols = both_batches(seed=4)
    _, _, keys, kvalid = _table(4)
    conf = {}
    if tier == "exact":
        conf = {"spark.rapids.tpu.agg.speculative.enabled": "false"}
    if tier == "partial/final":
        conf = {"spark.rapids.sql.shuffle.partitions": "4"}
    rows = []
    for m, b, dev in ((JAX, jb, {}), (TORCH, tb, {"device": "cpu"})):
        sess = m.session.TpuSession(conf, **dev)
        df = sess.from_batches([b], b.schema)
        aggs = [(m.F.sum(m.core.col(n)), f"s_{n}") for n in "abcwx"]
        q = df.agg(*aggs) if tier == "grand" else \
            df.group_by("k").agg(*aggs)
        rows.append(sorted(q.collect(), key=repr))
    assert rows[1] == rows[0]
    kk = np.zeros(N, np.int32) if tier == "grand" else keys
    kv = np.ones(N, bool) if tier == "grand" else kvalid
    want = {n: _sum_oracle(cols, kk, kv, n) for n in "abcwx"}
    for r in rows[1]:
        k = 0 if tier == "grand" else r[0]
        got = r if tier == "grand" else r[1:]
        assert list(got) == [want[n][k] for n in "abcwx"]
    assert any(v is None for v in want["x"].values())  # overflow to null


def test_fused_kernel_refuses_decimal_sources_and_buffers():
    """compile_scan_agg_spec refuses a decimal source column, key or sum
    buffer, as the JAX package's pallas_fused does: the kernel would sum
    unscaled lanes into a one-limb buffer."""
    from spark_rapids_tpu_torch.exec.aggregate import AggregateExec
    from spark_rapids_tpu_torch.exec.basic import InMemoryScanExec
    from spark_rapids_tpu_torch.expr.aggexprs import Sum
    _, tb, _ = both_batches(seed=5)
    scan = InMemoryScanExec([tb], tb.schema)
    col = tcore.col
    assert AggregateExec([col("k")], [(Sum(col("a")), "s")],
                         scan)._scan_agg_spec is None
    # a decimal source column, even unreferenced
    assert AggregateExec([col("k")], [(Sum(col("i")), "s")],
                         scan)._scan_agg_spec is None
    plain = TBatch([tb.columns[5], tb.columns[6]], N,
                   tt.Schema(tb.schema.fields[5:]))
    assert AggregateExec([col("k")], [(Sum(col("i")), "s")],
                         InMemoryScanExec([plain], plain.schema)
                         )._scan_agg_spec is not None
