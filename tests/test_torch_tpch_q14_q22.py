"""TPC-H Q14 and Q22 (P21 and P22 of chip_smoke.py) planned from
DataFrames in both packages at SF 0.002, against the JAX package's rows
and exact oracles (every decimal as a Python int); the string sweep
(P23) and the new aggregates (P24) against their oracles at a small size;
the pre-grouped aggregate over the lineitem x part join (P25) against its
oracle with its update sort skipped and taken; and TPC-H Q19 planned over a host shuffle of 4 partitions, which compares
decoded strings after the exchanges (ROADMAP C.10, tagged off until the
port compared decoded strings), against the oracle and the JAX package.

  * Q14: lineitem x part on the part key, l_shipdate in September 1995,
    sum(case when p_type like 'PROMO%' ...) and the total, both
    DECIMAL(36, 4); the ratio is formed from the two exact sums;
  * Q22: substring(c_phone, 1, 2) IN (seven codes) on decoded strings,
    c_acctbal above the average (its own query of sum and count, divided
    as Spark's avg(DECIMAL(12, 2)) would), NOT EXISTS over the orders (a
    left anti join), count and sum by the string cntrycode.
"""

import decimal
from types import SimpleNamespace

import pytest

import jax.numpy as jnp

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.columnar import encoded as jenc
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.columnar.column import StringColumn as JString
from spark_rapids_tpu.expr import conditional as jcond
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred

from spark_rapids_tpu_torch.columnar.column import StringColumn
from spark_rapids_tpu_torch.columnar.encoded import DictionaryColumn

import chip_smoke as cs
from test_torch_jax_ref import jax_aliases
from test_torch_planner import JAX as JAX_PLAN
from test_torch_planner import TORCH, active_confs, converted, tree

JAX = SimpleNamespace(t=jt, core=jcore, pred=jpred, F=jF, session=jsession,
                      cond=jcond)


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs():
        yield


def _jax_type(dt):
    if type(dt).__name__ == "DecimalType":
        return jt.DecimalType(dt.precision, dt.scale)
    return {"StringType": jt.STRING, "DateType": jt.DATE, "LongType": jt.LONG,
            "IntegerType": jt.INT, "DoubleType": jt.DOUBLE}[type(dt).__name__]


def jax_batch(tb):
    """The JAX package's batch of the same bytes as the port's `tb`."""
    cols = []
    for c in tb.columns:
        v = jnp.asarray(c.validity.numpy())
        if isinstance(c, DictionaryColumn):
            cols.append(jenc.DictionaryColumn(
                jnp.asarray(c.codes.numpy()), jnp.asarray(c.dict_data.numpy()),
                jnp.asarray(c.dict_offsets.numpy()), v, jt.STRING))
        elif isinstance(c, StringColumn):
            cols.append(JString(jnp.asarray(c.data.numpy()),
                                jnp.asarray(c.offsets.numpy()), v, jt.STRING))
        else:
            cols.append(JColumn(jnp.asarray(c.data.numpy()), v,
                                _jax_type(c.dtype)))
    schema = jt.Schema(tuple(jt.StructField(f.name, _jax_type(f.data_type))
                             for f in tb.schema.fields))
    return JBatch(cols, tb.num_rows_host, schema)


@pytest.fixture(scope="module")
def inputs():
    d19 = cs.q19_data(n_part=1024, n_line=6000, seed=5)
    dj = cs.tpch_join_data(sf=0.002, seed=6)
    q3d = cs.q3_types_data(dj)
    m, b, wants = cs.strings_inputs("cpu", dj, q3d, d19,
                                    cs.customer_names(2048))
    jb = {k: jax_batch(b[k]) for k in ("lineitem", "part", "customer",
                                       "orders")}
    return m, b, jb, wants


def test_q14_matches_jax_and_the_oracle(inputs):
    m, b, jb, wants = inputs
    rows = cs.q14_df(m, m.session.TpuSession(device="cpu"), b).collect()
    assert rows == wants["P21"]
    assert cs.q14_df(JAX, jsession.TpuSession(), jb).collect() == rows
    promo, total = rows[0]
    assert 0 < promo < total
    assert cs.q14_ratio(rows[0]) == decimal.Decimal(100) * decimal.Decimal(
        promo) / decimal.Decimal(total)


def test_q22_matches_jax_and_the_oracle(inputs):
    m, b, jb, wants = inputs
    tsess, jsess = m.session.TpuSession(device="cpu"), jsession.TpuSession()
    sub = cs.q22_avg_df(m, tsess, b).collect()
    assert sub == wants["P22 avg"]
    avg6, cents = cs.q22_threshold(sub[0])
    s, n = sub[0]
    assert avg6 == int((decimal.Decimal(s) * 10**4 / n).quantize(
        decimal.Decimal(1), rounding=decimal.ROUND_HALF_UP))
    assert cents == wants["P22 cents"]
    rows = cs.q22_df(m, tsess, b, cents).collect()
    assert rows == wants["P22"] and len(rows) > 3
    assert cs.q22_df(JAX, jsess, jb, cents).collect() == rows
    # the trees have the same classes: a left anti join, the string group-by
    df = cs.q22_df(m, tsess, b, cents)
    assert "left_anti" in repr(tree(converted(TORCH, df)))


def test_sweep_and_new_aggregates_follow_their_oracles(inputs):
    """P23 (every new device expression, columnwise) and P24 (the moments
    to rtol 1e-9, first/last by position) at a small size."""
    m, b, _, wants = inputs
    dfs = cs.strings_dfs(m, "cpu", b, wants)
    for table in cs.SWEEP:
        out = list(cs.planned(m, dfs[f"P23 {table}"])[0].execute())
        cs.sweep_check(table, wants["P23"])(out, f"P23 {table}")
    cs.check_close_rows(wants["P24"])(dfs["P24"].collect(), "P24")


def test_pre_grouped_aggregate_skips_its_sort_and_matches(inputs):
    """P25: max(p_type) by the join key over lineitem x part takes the
    string route's sort fallback over the inner join's key-grouped
    output, which skips the update's sort; the rows equal the oracle's
    with the sort skipped and with it taken."""
    m, b, _, wants = inputs
    df = cs.strings_dfs(m, "cpu", b, wants)["P25"]
    check = cs.sorted_rows(wants["P25"])
    for pre_grouped in (True, False):
        plan = cs.planned(m, df)[0]
        aggs = cs.pre_grouped_aggs(plan)
        assert len(aggs) == 1
        aggs[0]._pre_grouped = pre_grouped
        check(plan.collect(), f"P25 pre_grouped={pre_grouped}")
        assert cs.route_counts(aggs[0])["sort_fallback"] >= 1
    assert len(wants["P25"]) > 100


def test_q19_over_the_host_shuffle_plans_and_matches(inputs):
    """Q19 planned over 4 host partitions with broadcasts off: the
    exchanges decode the string columns and the join condition compares
    decoded strings; the tree equals the JAX package's and the revenue
    the oracle (tests/test_torch_session.py holds the same plan's rows
    to the JAX package's at a smaller size)."""
    d = cs.q19_data(n_part=2048, n_line=24576, seed=22)
    want = cs.q19_oracle(d)
    assert want[0] is not None and want[1] > 0
    conf = {"spark.rapids.sql.shuffle.partitions": "4",
            "spark.rapids.sql.broadcastSizeThreshold": "-1"}
    lines, parts = cs.q19_batches(d, "cpu")
    tdf = cs.q19_df(TORCH, TORCH.session.TpuSession(conf, device="cpu"),
                    lines, parts)
    jdf = cs.q19_df(JAX, jsession.TpuSession(conf), jax_batch(lines),
                    jax_batch(parts))
    t = converted(TORCH, tdf)
    assert tree(t) == tree(converted(JAX_PLAN, jdf))
    assert "ShuffledHashJoinExec" in repr(tree(t))
    rows = tdf.collect()
    pairs = next(v["numOutputRows"] for k, v in
                 tdf.session.last_query_metrics().items()
                 if k.startswith("ShuffledHashJoinExec#"))
    cs.check_q19(rows, pairs, want, "Q19 over 4 partitions")
