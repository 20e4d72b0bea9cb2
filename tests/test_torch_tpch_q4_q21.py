"""TPC-H Q4 and Q21 at SF 0.001 through both packages' TpuSessions and a
numpy oracle, on the CPU (chip_smoke.tpch_join_data: clause 4.2.3's
generation rules, the same arrays for both): Q4 planned as a left semi
join (and its NOT EXISTS form, a left anti join), Q21 as a left semi and a
left anti join with residual conditions followed by three inner joins and
a TopN by a string. The converted trees have the same classes in both
packages; the rows equal each other and the oracle exactly, in order.
Q4's semi and anti joins also run over the host shuffle into 8
partitions: the port's rows equal the oracle's and its converted tree the
JAX package's (test_torch_join_types holds the shuffled join's rows to
the JAX package's), and the hand-built Q21 of phase 3d (the port's)
equals the oracle. Q21 filters on the nation of the first
supplier: at 10 suppliers SAUDI ARABIA may have none.
"""

from types import SimpleNamespace

import pytest

import chip_smoke as cs
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred
from spark_rapids_tpu.plan import overrides as jover

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import functions as tF
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import predicates as tpred
from spark_rapids_tpu_torch.plan import overrides as tover

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases
from test_torch_planner import active_confs, converted, tree

JAX = SimpleNamespace(t=jt, core=jcore, pred=jpred, F=jF, session=jsession,
                      overrides=jover)
TORCH = SimpleNamespace(t=tt, core=tcore, pred=tpred, F=tF,
                        session=tsession, overrides=tover)
SF = 0.001


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs():
        yield


@pytest.fixture(scope="module")
def data():
    d = cs.tpch_join_data(sf=SF)
    batches = ({}, {})
    for table in cs.JOIN_TABLES:
        n = d[cs.JOIN_TABLES[table][0][0]].shape[0]
        jb, tb = both_batch(cs.join_table_spec(d, table), n)
        batches[0][table], batches[1][table] = jb, tb
    return d, batches


def _frames(make, conf=None):
    js = jsession.TpuSession(dict(conf or {}))
    ts = tsession.TpuSession(dict(conf or {}), device="cpu")
    return make(JAX, js, 0), make(TORCH, ts, 1)


@pytest.mark.parametrize("anti", [False, True], ids=["exists", "not exists"])
def test_q4_matches_jax_and_numpy(data, anti):
    d, batches = data
    jdf, tdf = _frames(lambda m, s, k: cs.q4_df(m, s, batches[k], anti))
    assert tree(converted(TORCH, tdf)) == tree(converted(JAX, jdf))
    want = cs.q4_oracle(d, anti)
    assert len(want) >= 3
    rows = tdf.collect()
    assert rows == jdf.collect() == want


def test_q21_matches_jax_and_numpy(data):
    d, batches = data
    nation = cs.NATIONS[int(d["s_nationkey"][0])]
    jdf, tdf = _frames(lambda m, s, k: cs.q21_df(m, s, batches[k], nation),
                       cs.Q21_CONF)
    classes = repr(tree(converted(TORCH, tdf)))
    assert classes == repr(tree(converted(JAX, jdf)))
    assert "left_semi" in tdf.explain() and "left_anti" in tdf.explain()
    want = cs.q21_oracle(d, nation)
    assert len(want) >= 1
    rows = tdf.collect()
    assert rows == jdf.collect() == want
    hand = cs.q21_plan(cs.port_modules(), batches[1], nation).collect()
    assert hand == want


@pytest.mark.parametrize("anti", [False, True], ids=["exists", "not exists"])
def test_q4_over_the_host_shuffle_matches_jax_and_numpy(data, anti):
    d, batches = data
    conf = dict(cs.Q3_CONF, **{"spark.rapids.sql.shuffle.partitions": "8",
                               "spark.rapids.sql.broadcastSizeThreshold":
                               "-1",
                               "spark.rapids.tpu.adaptive.enabled": "false"})
    jdf, tdf = _frames(lambda m, s, k: cs.q4_df(m, s, batches[k], anti,
                                                 sort=False), conf)
    classes = tree(converted(TORCH, tdf))
    assert classes == tree(converted(JAX, jdf))
    assert "ShuffledHashJoinExec" in repr(classes)
    assert sorted(tdf.collect()) == cs.q4_oracle(d, anti)
