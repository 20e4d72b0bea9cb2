"""Two wrong results against Spark, held to Python oracles with the JAX
package kept off them (ROADMAP C.18 and C.5):

- C.18: a Python UDF above a filter is called only on the rows the
  filter keeps. x = [0, 1, 2, 0, 5, 10, 0, 4] through
  `filter(x != 0).select(udf(100 // x))` gives Spark's [100, 50, 20, 10,
  25] at the default confs, with stage fusion off, under a group_by and
  with a filter above the UDF. The repair ends a fused chain below a step
  that holds a UDF: q1's chain, which holds none, still absorbs into one
  fused scan-aggregate, and a map stage still forms where no UDF is.
- An inner join on a STRING key emits each stream row once per match:
  97 distinct build keys "s0".."s96" and a stream of one repeated key
  give one row a stream row, as an exact pair count says (the JAX
  package emits some rows twice).

Integers and row order exact.
"""

import numpy as np
import pytest

import chip_smoke as cs
from spark_rapids_tpu_torch.exec import aggregate as tagg
from spark_rapids_tpu_torch.expr import udf as tudf

from test_torch_jax_ref import one_torch_thread
from test_torch_planner import (N_Q1, TORCH, active_confs, q1_columns,
                                split_batches)
from test_torch_stage_compiler import stages

X = [0, 1, 2, 0, 5, 10, 0, 4]
OFF = {"spark.rapids.tpu.stage.fusion.enabled": "false"}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    with active_confs(), one_torch_thread():
        yield


def _session(conf=None):
    return TORCH.session.TpuSession(dict(conf or {}), device="cpu")


def _frame(sess):
    t = TORCH.t
    return sess.from_pydict(
        {"x": X, "g": [i % 3 for i in range(len(X))]},
        t.Schema((t.StructField("x", t.LONG), t.StructField("g", t.LONG))))


def _inverse(x):
    return 100 // x


def _udf():
    return tudf.PythonUDF(_inverse, TORCH.t.LONG, TORCH.core.col("x"))


def _kept():
    return [(x, i % 3) for i, x in enumerate(X) if x != 0]


def _nonzero(df):
    col, lit, pr = TORCH.core.col, TORCH.core.lit, TORCH.pred
    return df.filter(pr.Not(pr.EqualTo(col("x"), lit(0))))


@pytest.mark.parametrize("conf", [{}, OFF], ids=["default", "fusion_off"])
@pytest.mark.parametrize("shape", ["select", "group_by", "filter_above"])
def test_python_udf_above_a_filter_sees_only_kept_rows(conf, shape):
    col, lit, pr, F = TORCH.core.col, TORCH.core.lit, TORCH.pred, TORCH.F
    before = tudf.counters()["rows"]
    df = _nonzero(_frame(_session(conf)))
    if shape == "select":
        got = df.select(_udf().alias("r")).collect()
        want = [(_inverse(x),) for x, _ in _kept()]
    elif shape == "group_by":
        got = sorted(df.select(col("g"), _udf().alias("r"))
                     .group_by("g").agg((F.sum(col("r")), "s"),
                                        (F.count(), "c")).collect())
        sums = {}
        for x, g in _kept():
            s, c = sums.get(g, (0, 0))
            sums[g] = (s + _inverse(x), c + 1)
        want = sorted((g, s, c) for g, (s, c) in sums.items())
    else:
        got = df.select(_udf().alias("r")).filter(
            pr.GreaterThan(col("r"), lit(15))).collect()
        want = [(_inverse(x),) for x, _ in _kept() if _inverse(x) > 15]
    assert got == want
    if shape == "select":
        assert [r[0] for r in got] == [100, 50, 20, 10, 25]
    # the function saw the five kept rows, never a dropped one
    assert tudf.counters()["rows"] - before == len(_kept())


def test_udf_ends_the_chains_and_q1_still_fuses(monkeypatch):
    col, lit, pr = TORCH.core.col, TORCH.core.lit, TORCH.pred
    # a map chain with a UDF in its middle: no stage reaches past it
    plan = _nonzero(_frame(_session())).select(_udf().alias("r")).filter(
        pr.GreaterThan(col("r"), lit(15)))._exec()
    assert all("ProjectExec" not in ops or kind != "map"
               for kind, ops in stages(plan)), stages(plan)
    # the same chain with a device expression in place of the UDF is one
    # map stage, as before
    plan = _nonzero(_frame(_session())).select(
        (col("x") * lit(2)).alias("r")).filter(
        pr.GreaterThan(col("r"), lit(15)))._exec()
    assert stages(plan) == [("map", ["FilterExec", "ProjectExec",
                                     "FilterExec"])]
    # q1's Aggregate+Project+Filter: one agg stage, the chain absorbed
    # into the fused scan-aggregate, one call of it for its one batch
    calls = []
    real = tagg.fused_scan_agg

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(tagg, "fused_scan_agg", counted)
    _, batches = split_batches(q1_columns(), N_Q1, 1)
    df = cs.q1_df(TORCH, _session(), batches)
    plan = df._exec()
    assert stages(plan) == [("agg", ["AggregateExec", "ProjectExec",
                                     "FilterExec"])]
    agg = plan._agg
    assert agg._scan_agg_spec is not None and len(agg._fused_steps) == 2
    df.collect()
    assert len(calls) == 1


@pytest.mark.parametrize("n_stream", [100, 200])
def test_inner_join_on_a_string_key_emits_each_pair_once(n_stream):
    t = TORCH.t
    sess = _session()
    keys = [f"s{i}" for i in range(97)]
    build = sess.from_pydict(
        {"k": keys, "b": list(range(97))},
        t.Schema((t.StructField("k", t.STRING), t.StructField("b", t.LONG))))
    rng = np.random.default_rng(5)
    stream_keys = ["s45"] * n_stream
    stream = sess.from_pydict(
        {"k": stream_keys, "v": rng.integers(0, 1000, n_stream).tolist()},
        t.Schema((t.StructField("k", t.STRING), t.StructField("v", t.LONG))))
    rows = stream.join(build, on="k").collect()
    # the oracle: every (stream row, build row) pair with equal keys
    want = sorted((k, v, b) for k, v in zip(stream_keys,
                                            stream.to_pydict()["v"])
                  for b, kb in enumerate(keys) if kb == k)
    assert len(want) == n_stream
    assert sorted(rows) == want
