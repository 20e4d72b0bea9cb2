"""The pandas UDF family (exec/python_udf.py: grouped map, grouped
aggregate, mapInPandas, cogrouped map, window-in-pandas) against the JAX
package, on the CPU.

Each case of tests/test_pandas_udf.py runs in both packages on the same
numpy-seeded rows and must give the same rows, and the JAX suite's
Python oracle's: NaN and NULL keys are distinct groups, groups span
input batches, an expression can be the key, an empty input gives no
rows. Then every pandas exec above a filter (ROADMAP C.18: a pandas
function must never see a row a filter below it dropped), at the default
confs (the filter and the projection above it compile to a map stage
that ends below the pandas exec), with whole-stage fusion off and with
the stage compiler off, held to Spark's rows. Integers exact; the float
results within 1e-9 relative (pandas' reduction order).
"""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import functions as tF
from spark_rapids_tpu_torch.api import session as tsession

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs

JAX = SimpleNamespace(t=jt, F=jF,
                      session=lambda conf=None: jsession.TpuSession(conf))
TORCH = SimpleNamespace(t=tt, F=tF, session=lambda conf=None:
                        tsession.TpuSession(conf, device="cpu"))
BOTH = (JAX, TORCH)


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


def _data(n=50):
    rng = np.random.default_rng(5)
    ks = [["a", "b", "c", None][i] for i in rng.integers(0, 4, n)]
    vs = [int(x) for x in rng.integers(-50, 50, n)]
    vs[3] = None
    return {"k": ks, "v": vs, "d": [float(x) for x in rng.normal(0, 5, n)]}


def _df(m, sess, data, batch_rows=16):
    t = m.t
    sch = t.Schema((t.StructField("k", t.STRING), t.StructField("v", t.LONG),
                    t.StructField("d", t.DOUBLE)))
    return sess.from_pydict(data, sch, batch_rows=batch_rows)


def _norm(v):
    if v is None or (isinstance(v, float) and np.isnan(v)):
        return None
    return round(v, 9) if isinstance(v, float) else v


def _counter(rows):
    return Counter(tuple(_norm(v) for v in r) for r in rows)


def both(case):
    return [case(m) for m in BOTH]


def test_apply_in_pandas_grouped_map():
    data = _data()

    def case(m):
        t = m.t
        out_sch = t.Schema((t.StructField("k", t.STRING),
                            t.StructField("v_centered", t.DOUBLE)))

        def center(g):
            return pd.DataFrame({"k": g["k"],
                                 "v_centered": g["v"] - g["v"].mean()})
        return _counter(_df(m, m.session(), data).group_by("k")
                        .apply_in_pandas(center, out_sch).collect())
    j, t = both(case)
    exp = []
    for key in set(data["k"]):
        vs = [v for k, v in zip(data["k"], data["v"]) if k == key]
        mean = np.nanmean([np.nan if v is None else v for v in vs])
        exp += [(key, None if v is None else v - mean) for v in vs]
    assert t == j == _counter(exp)


def test_apply_in_pandas_multi_batch_group_and_expr_key():
    def case(m):
        t = m.t
        sess = m.session()
        df = sess.from_pydict({"x": list(range(40))},
                              t.Schema((t.StructField("x", t.LONG),)),
                              batch_rows=8)
        out_sch = t.Schema((t.StructField("parity", t.LONG),
                            t.StructField("n", t.LONG),
                            t.StructField("s", t.LONG)))

        def summarize(g):
            return pd.DataFrame({"parity": [int(g["x"].iloc[0] % 2)],
                                 "n": [len(g)], "s": [int(g["x"].sum())]})
        return sorted(df.group_by(m.F.col("x") % m.F.lit(2))
                      .apply_in_pandas(summarize, out_sch).collect())
    j, t = both(case)
    assert t == j == [(0, 20, sum(range(0, 40, 2))),
                      (1, 20, sum(range(1, 40, 2)))]


def test_agg_in_pandas():
    data = _data()

    def wmean(v, d):
        w = d.abs() + 1.0
        keep = v.notna()
        return float((v[keep] * w[keep]).sum() / w[keep].sum())

    def case(m):
        col = m.F.col
        return dict(_df(m, m.session(), data).group_by("k").agg_in_pandas(
            (wmean, "wm", m.t.DOUBLE, [col("v"), col("d")])).collect())
    j, t = both(case)
    assert t.keys() == j.keys() == set(data["k"])
    for key in set(data["k"]):
        vs = [(v, d) for k, v, d in
              zip(data["k"], data["v"], data["d"]) if k == key]
        num = sum(v * (abs(d) + 1.0) for v, d in vs if v is not None)
        den = sum(abs(d) + 1.0 for v, d in vs if v is not None)
        assert t[key] == pytest.approx(num / den, rel=1e-9)
        assert t[key] == pytest.approx(j[key], rel=1e-9)


def test_map_in_pandas_streams_batches():
    def case(m):
        t = m.t
        sch = t.Schema((t.StructField("x", t.LONG),))
        df = m.session().from_pydict({"x": list(range(30))}, sch,
                                     batch_rows=10)
        seen = []

        def doubler(frames):
            for pdf in frames:
                seen.append(len(pdf))
                yield pd.DataFrame({"y": pdf["x"] * 2})
        got = sorted(r[0] for r in df.map_in_pandas(doubler, t.Schema(
            (t.StructField("y", t.LONG),))).collect())
        return got, sum(seen), len(seen) >= 1
    j, t = both(case)
    assert t == j == ([2 * x for x in range(30)], 30, True)


def test_cogrouped_apply_in_pandas():
    def case(m):
        t = m.t
        sess = m.session()
        left = sess.from_pydict(
            {"k": [1, 1, 2, 3], "v": [10, 11, 20, 30]},
            t.Schema((t.StructField("k", t.LONG), t.StructField("v", t.LONG))))
        right = sess.from_pydict(
            {"k": [1, 2, 2, 4], "w": [5, 6, 7, 8]},
            t.Schema((t.StructField("k", t.LONG), t.StructField("w", t.LONG))))
        out_sch = t.Schema((t.StructField("k", t.LONG),
                            t.StructField("lv", t.LONG),
                            t.StructField("rw", t.LONG)))

        def merge(lg, rg):
            k = lg["k"].iloc[0] if len(lg) else rg["k"].iloc[0]
            return pd.DataFrame({
                "k": [int(k)],
                "lv": [int(lg["v"].sum()) if len(lg) else 0],
                "rw": [int(rg["w"].sum()) if len(rg) else 0]})
        return sorted(left.group_by("k").cogroup(right.group_by("k"))
                      .apply_in_pandas(merge, out_sch).collect())
    j, t = both(case)
    assert t == j == [(1, 21, 5), (2, 20, 13), (3, 30, 0), (4, 0, 8)]


def test_window_in_pandas_broadcast():
    data = _data(30)

    def spread(v):
        return float(v.max() - v.min())

    def case(m):
        return _counter(_df(m, m.session(), data).window_in_pandas(
            "k", (spread, "sp", m.t.DOUBLE, m.F.col("v"))).collect())
    j, t = both(case)
    exp = {}
    for key in set(data["k"]):
        vs = [v for k, v in zip(data["k"], data["v"])
              if k == key and v is not None]
        exp[key] = float(max(vs) - min(vs))
    assert t == j == _counter(
        (k, v, d, exp[k]) for k, v, d in zip(data["k"], data["v"],
                                              data["d"]))


def test_apply_in_pandas_empty_input():
    def case(m):
        t = m.t
        sch = t.Schema((t.StructField("k", t.LONG),
                        t.StructField("v", t.LONG)))
        df = m.session().from_pydict({"k": [], "v": []}, sch)
        out_sch = t.Schema((t.StructField("k", t.LONG),
                            t.StructField("n", t.LONG)))
        return df.group_by("k").apply_in_pandas(
            lambda g: pd.DataFrame({"k": [g["k"].iloc[0]], "n": [len(g)]}),
            out_sch).collect()
    j, t = both(case)
    assert t == j == []


def test_nan_and_null_keys_are_distinct_groups():
    def case(m):
        t = m.t
        sch = t.Schema((t.StructField("k", t.DOUBLE),
                        t.StructField("v", t.LONG)))
        df = m.session().from_pydict(
            {"k": [1.0, float("nan"), None, float("nan"), None, 1.0],
             "v": [1, 2, 3, 4, 5, 6]}, sch)
        out_sch = t.Schema((t.StructField("n", t.LONG),
                            t.StructField("s", t.LONG)))
        return sorted(df.group_by("k").apply_in_pandas(
            lambda g: pd.DataFrame({"n": [len(g)],
                                    "s": [int(g["v"].sum())]}),
            out_sch).collect())
    j, t = both(case)
    # three groups: 1.0 -> {1, 6}, NaN -> {2, 4}, NULL -> {3, 5}
    assert t == j == [(2, 6), (2, 7), (2, 8)]


# -- C.18: a pandas exec above a filter sees only the rows it kept --------

XS = [0, 10, 5, 4, 2, 1, 0]
#: Spark's rows: 100 // x over the rows where x != 0
SPARK = sorted(100 // x for x in XS if x)
CONFS = {"default": {},
         "fusion off": {"spark.rapids.tpu.fusion.enabled": "false"},
         "stage compiler off": {
             "spark.rapids.tpu.stage.fusion.enabled": "false"}}


def _filtered(sess):
    """x != 0 then a projection: a chain of two the stage compiler
    compiles into one map stage at the default confs."""
    t, col, lit = tt, tF.col, tF.lit
    df = sess.from_pydict({"x": XS, "g": [1] * len(XS)},
                          t.Schema((t.StructField("x", t.LONG),
                                    t.StructField("g", t.LONG))))
    return df.filter(col("x") != lit(0)).with_column("x", col("x") * lit(1))


def _divide(g):
    return pd.DataFrame({"y": 100 // g["x"]})


EXECS = {
    "map_in_pandas": lambda df, sch: df.map_in_pandas(
        lambda frames: (_divide(f) for f in frames), sch),
    "apply_in_pandas": lambda df, sch: df.group_by("g").apply_in_pandas(
        _divide, sch),
    "agg_in_pandas": lambda df, sch: df.group_by("g").agg_in_pandas(
        (lambda x: int((100 // x).sum()), "y", tt.LONG, tF.col("x"))
    ).select(tF.col("y")),
    "window_in_pandas": lambda df, sch: df.window_in_pandas(
        "g", (lambda x: int((100 // x).min()), "y", tt.LONG, tF.col("x"))
    ).select(tF.col("y")),
    "cogroup": lambda df, sch: df.group_by("g").cogroup(
        df.group_by("g")).apply_in_pandas(
        lambda lg, rg: _divide(lg) if len(lg) else _divide(rg), sch),
}
#: Spark's rows for each exec
WANT = {"map_in_pandas": SPARK, "apply_in_pandas": SPARK,
        "agg_in_pandas": [sum(SPARK)], "window_in_pandas": [min(SPARK)] * 5,
        "cogroup": SPARK}


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("kind", list(EXECS))
def test_pandas_exec_above_a_filter(kind, conf):
    from spark_rapids_tpu_torch.exec.stage_compiler import CompiledStageExec
    sess = TORCH.session(CONFS[conf])
    out = EXECS[kind](_filtered(sess),
                      tt.Schema((tt.StructField("y", tt.LONG),)))
    assert sorted(r[0] for r in out.collect()) == WANT[kind]
    if conf == "default":
        # the chain below the pandas exec is a map stage of its own
        node = out._exec()
        while not type(node).__name__.endswith("InPandasExec") \
                and type(node).__name__ != "MapInBatchExec":
            node = node.children[0]
        stage = node.children[0]
        assert isinstance(stage, CompiledStageExec), type(stage)
        assert [type(o).__name__ for o in stage._absorbed] == \
            ["ProjectExec", "FilterExec"]
