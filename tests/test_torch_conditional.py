"""The conditional and null expressions of the port (expr/conditional.py)
and its null literals against the JAX package's, on the CPU: If,
CaseWhen (with and without ELSE, several branches, string results),
Coalesce (with a NullType literal), Nvl, Nvl2, NullIf (numbers and
strings), IsNaN and NaNvl, over columns with nulls, NaNs and -0.0. Each
result's data, validity and rows equal the JAX package's exactly (the
data under a null is zero in both). The functions when, coalesce, nvl,
ifnull, nvl2 and nullif run through both sessions' select() and a
full-outer USING join through both sessions' join().
"""

from types import SimpleNamespace

import numpy as np
import pytest

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.columnar.column import StringColumn as JString
from spark_rapids_tpu.expr import conditional as jcond
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import functions as tF
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.expr import conditional as tcond
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import predicates as tpred

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases
from test_torch_planner import active_confs

JAX = SimpleNamespace(t=jt, core=jcore, pred=jpred, cond=jcond, F=jF,
                      session=jsession)
TORCH = SimpleNamespace(t=tt, core=tcore, pred=tpred, cond=tcond, F=tF,
                        session=tsession)
N = 200


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs():
        yield


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random(N) * 10 - 5
    x[::7] = np.nan
    x[3::11] = -0.0
    y = rng.random(N) * 10 - 5
    y[::5] = np.nan
    words = ["", "ab", "abc", "x", "longer word here"]
    return {
        "x": (x, "DOUBLE", rng.random(N) > 0.15),
        "y": (y, "DOUBLE", rng.random(N) > 0.15),
        "i": (rng.integers(-3, 4, N).astype(np.int32), "INT",
              rng.random(N) > 0.2),
        "j": (rng.integers(-3, 4, N).astype(np.int32), "INT",
              rng.random(N) > 0.2),
        "s": ([words[k] for k in rng.integers(0, 5, N)], "STRING",
              rng.random(N) > 0.2),
        "u": ([words[k] for k in rng.integers(0, 5, N)], "STRING",
              rng.random(N) > 0.2),
        "p": (rng.random(N) > 0.5, "BOOLEAN", rng.random(N) > 0.2),
    }


def _expr(m, case):
    col, lit, c, pr = m.core.col, m.core.lit, m.cond, m.pred
    Literal, t = m.core.Literal, m.t
    return {
        "If": c.If(col("p"), col("x"), col("y")),
        "If strings": c.If(col("p"), col("s"), lit("fallback")),
        "CaseWhen": c.CaseWhen([(pr.GreaterThan(col("i"), lit(1)), col("x")),
                                (col("p"), col("y"))], lit(-1.0)),
        "CaseWhen no else": c.CaseWhen(
            [(pr.LessThan(col("i"), lit(0)), col("j"))]),
        "CaseWhen strings": c.CaseWhen(
            [(pr.GreaterThan(col("i"), lit(0)), col("s")),
             (col("p"), col("u"))]),
        "Coalesce": c.Coalesce(col("i"), col("j"), lit(7)),
        "Coalesce null literal": c.Coalesce(lit(None), col("x"), col("y")),
        "Coalesce strings": c.Coalesce(col("s"), col("u")),
        "Nvl": c.Nvl(col("x"), col("y")),
        "Nvl2": c.Nvl2(col("i"), col("x"), col("y")),
        "NullIf": c.NullIf(col("i"), col("j")),
        "NullIf strings": c.NullIf(col("s"), col("u")),
        "IsNaN": c.IsNaN(col("x")),
        "NaNvl": c.NaNvl(col("x"), col("y")),
        "typed null": Literal(None, t.LONG),
        "typed null string": Literal(None, t.STRING),
    }[case]


CASES = ["If", "If strings", "CaseWhen", "CaseWhen no else",
         "CaseWhen strings", "Coalesce", "Coalesce null literal",
         "Coalesce strings", "Nvl", "Nvl2", "NullIf", "NullIf strings",
         "IsNaN", "NaNvl", "typed null", "typed null string"]


@pytest.mark.parametrize("case", CASES)
def test_conditional_matches_jax(case):
    jb, tb = both_batch(_data(len(case)), N)
    je = jcore.resolve(_expr(JAX, case), jb.schema)
    te = tcore.resolve(_expr(TORCH, case), tb.schema)
    assert te.data_type.simple_name() == je.data_type.simple_name()
    assert te.nullable == je.nullable
    jc, tc = je.columnar_eval(jb), te.columnar_eval(tb)
    np.testing.assert_array_equal(tc.validity.numpy(),
                                  np.asarray(jc.validity))
    if isinstance(jc, JString):
        np.testing.assert_array_equal(tc.offsets.numpy(),
                                      np.asarray(jc.offsets))
        n_bytes = int(np.asarray(jc.offsets)[-1])
        np.testing.assert_array_equal(tc.data.numpy()[:n_bytes],
                                      np.asarray(jc.data)[:n_bytes])
    else:
        np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))
    assert repr(tc.to_pylist(N)) == repr(jc.to_pylist(N))


def _frames(m, sess, batch):
    F, col, lit = m.F, m.core.col, m.core.lit
    df = sess.from_batches([batch], batch.schema)
    return df.select(
        F.when(m.pred.GreaterThan(col("i"), lit(0)), col("x")).alias("w"),
        F.coalesce(col("i"), col("j")).alias("c"),
        F.nvl(col("x"), lit(0.0)).alias("n"),
        F.ifnull(col("s"), col("u")).alias("f"),
        F.nvl2(col("j"), col("i"), lit(9)).alias("n2"),
        F.nullif(col("i"), col("j")).alias("ni"))


def test_functions_through_the_session_match_jax():
    jb, tb = both_batch(_data(7), N)
    jdf = _frames(JAX, jsession.TpuSession(), jb)
    tdf = _frames(TORCH, tsession.TpuSession(device="cpu"), tb)
    assert repr(tdf.collect()) == repr(jdf.collect())
    assert [(f.name, f.data_type.simple_name()) for f in tdf.schema.fields] \
        == [(f.name, f.data_type.simple_name()) for f in jdf.schema.fields]


def test_full_outer_using_join_coalesces_the_key():
    rows = []
    for m, sess in ((JAX, jsession.TpuSession()),
                    (TORCH, tsession.TpuSession(device="cpu"))):
        t = m.t
        a = sess.from_pydict({"k": [1, 2, 3, None], "a": [10, 20, 30, 40]},
                             t.Schema((t.StructField("k", t.LONG),
                                       t.StructField("a", t.INT))))
        b = sess.from_pydict({"k": [2, 3, 4, 4], "b": [0.5, 1.5, 2.5, 3.5]},
                             t.Schema((t.StructField("k", t.LONG),
                                       t.StructField("b", t.DOUBLE))))
        rows.append(a.join(b, on="k", how="full_outer").collect())
    assert rows[1] == rows[0]
    assert sorted(rows[1], key=repr) == sorted(
        [(1, 10, None), (2, 20, 0.5), (3, 30, 1.5), (None, 40, None),
         (4, None, 2.5), (4, None, 3.5)], key=repr)
