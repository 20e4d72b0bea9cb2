"""AdaptiveJoinExec (exec/joins.py) against the JAX package's, strategy by
strategy, on the same seeded sides: the choice (`_choice`), the measured
bytes (`_measured`), the rows and adaptive.counters(). The strategies:
build_right under the broadcast threshold; build_left for an inner join
whose left side measures smaller; build_right, with no swap, for a left
outer join and for an inner join with a condition; subpartition past
join.subPartitionThreshold; the broadcast demotion past
adaptive.autoBroadcastMaxBytes (into build_left, and into subpartition);
and adaptive.enabled off. Then the planner: at the default threshold a
join whose side is a keyed aggregate plans AdaptiveJoinExec in both
packages.

The measured bytes are equal: the port's `ColumnarBatch.nbytes` counts
every leaf at its padded size, the bool validity a byte a row and the row
count a 4-byte scalar, as the JAX package's `device_size_bytes` does.
The thresholds sit far from the sides' sizes all the same, so that a
choice never hangs on a byte."""

import numpy as np
import pytest

from spark_rapids_tpu import config as jconfig
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.exec import adaptive as jadaptive
from spark_rapids_tpu.exec.basic import InMemoryScanExec as JScan
from spark_rapids_tpu.exec.joins import AdaptiveJoinExec as JAdaptive
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred

from spark_rapids_tpu_torch import config as tconfig
from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.exec import adaptive as tadaptive
from spark_rapids_tpu_torch.exec.basic import InMemoryScanExec as TScan
from spark_rapids_tpu_torch.exec.joins import AdaptiveJoinExec as TAdaptive
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import predicates as tpred
from spark_rapids_tpu_torch.memory import buffer_catalog

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs

N_LEFT, N_RIGHT = 300, 1200
THR = "spark.rapids.sql.broadcastSizeThreshold"
SUB = "spark.rapids.sql.join.subPartitionThreshold"
CAP = "spark.rapids.tpu.adaptive.autoBroadcastMaxBytes"
ON = "spark.rapids.tpu.adaptive.enabled"


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


def _sides(seed=7):
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, 400, N_LEFT)
    rk = rng.integers(0, 400, N_RIGHT)
    left = {"k": [None if i % 17 == 0 else int(v) for i, v in
                  enumerate(lk)],
            "v": [float(x) for x in rng.random(N_LEFT)]}
    right = {"k2": [None if i % 23 == 0 else int(v) for i, v in
                    enumerate(rk)],
             "w": [int(x) for x in rng.integers(-1000, 1000, N_RIGHT)]}
    return left, right


def _schemas(t):
    return (t.Schema((t.StructField("k", t.LONG),
                      t.StructField("v", t.DOUBLE))),
            t.Schema((t.StructField("k2", t.LONG),
                      t.StructField("w", t.LONG))))


def _joins(join_type, settings, condition=False):
    """(port join, JAX join) over the same sides, each with the settings
    as its conf."""
    left, right = _sides()
    out = []
    for t, batch, scan, core, pred, conf, cls, kw in (
            (tt, TBatch, TScan, tcore, tpred, tconfig, TAdaptive,
             {"device": "cpu"}),
            (jt, JBatch, JScan, jcore, jpred, jconfig, JAdaptive, {})):
        ls, rs = _schemas(t)
        lb = batch.from_pydict(left, ls, **kw)
        rb = batch.from_pydict(right, rs, **kw)
        cond = pred.GreaterThan(core.col("w"), core.col("v")) \
            if condition else None
        out.append(cls(scan([lb], ls), scan([rb], rs), [core.col("k")],
                       [core.col("k2")], join_type, cond,
                       conf.RapidsConf(settings)))
    return out


def _rows(j):
    return sorted((r for b in j.execute() for r in b.to_pylist()),
                  key=repr)


CASES = {
    # (join type, settings, condition, the choice, the counters' moves)
    "build_right": ("inner", {}, False, "build_right", 0),
    "build_left": ("inner", {THR: "100"}, False, "build_left", 0),
    "left_outer no swap": ("left_outer", {THR: "100"}, False,
                           "build_right", 0),
    "condition no swap": ("inner", {THR: "100"}, True, "build_right", 0),
    "subpartition": ("inner", {THR: "100", SUB: "2000"}, False,
                     "subpartition", 0),
    "demote to build_left": ("inner", {THR: str(1 << 30), CAP: "12000"},
                             False, "build_left", 1),
    "demote to subpartition": ("left_outer", {THR: str(1 << 30),
                                              CAP: "4000"}, False,
                               "subpartition", 1),
    "adaptive off": ("inner", {THR: str(1 << 30), CAP: "4000",
                               ON: "false"}, False, "build_right", 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_each_strategy_matches_jax(case):
    join_type, settings, condition, choice, demotes = CASES[case]
    tadaptive.reset_adaptive()
    jadaptive.reset_adaptive()
    tj, jj = _joins(join_type, settings, condition)
    got, want = _rows(tj), _rows(jj)
    assert got == want and len(got) > 0
    assert tj._choice == jj._choice == choice
    assert tj._measured == jj._measured
    size_r = tj._measured[1]
    # the thresholds sit far from the measured sides
    for key in (THR, SUB, CAP):
        if key in settings:
            assert abs(int(settings[key]) - size_r) > size_r // 4
    tc, jc = tadaptive.counters(), jadaptive.counters()
    assert tc["broadcast_demotes"] == demotes
    if choice == "subpartition":
        # the sub-partitioned join's exchanges and shuffled join consult
        # as well (and convert a build side under the cap, in both)
        assert tc["consults"] > 1
    else:
        assert tc["consults"] == (0 if ON in settings else 1)
    assert tc == jc
    assert buffer_catalog().num_entries() == 0


def test_measured_bytes_are_the_padded_leaves():
    """`_measured` is the sum of the padded leaf bytes of each side's
    batches: data and validity at capacity, the 4-byte row count."""
    tj, _ = _joins("inner", {THR: "100"})
    _rows(tj)
    size_l, size_r = tj._measured
    cap_l, cap_r = 512, 2048           # the sides' capacity buckets
    assert size_l == cap_l * (8 + 1 + 8 + 1) + 4
    assert size_r == cap_r * (8 + 1 + 8 + 1) + 4


def test_default_threshold_plans_adaptive_over_an_aggregate():
    """A join whose right side is a keyed aggregate (no size estimate)
    and whose left side is past the threshold plans AdaptiveJoinExec in
    both packages, and the rows agree."""
    from spark_rapids_tpu.api import session as jsession
    from spark_rapids_tpu_torch.api import functions as tF
    from spark_rapids_tpu.api import functions as jF
    from spark_rapids_tpu_torch.api import session as tsession
    from test_torch_planner import JAX, TORCH, converted, tree
    left, right = _sides()
    rows = []
    for sess, F, t, core in (
            (tsession.TpuSession({THR: "1000"}, device="cpu"), tF, tt,
             tcore),
            (jsession.TpuSession({THR: "1000"}), jF, jt, jcore)):
        ls, rs = _schemas(t)
        per = sess.from_pydict(right, rs).group_by("k2").agg(
            (F.count(), "n"))
        df = sess.from_pydict(left, ls).join(per, left_on="k",
                                             right_on="k2")
        rows.append((df, sorted(df.collect(), key=repr)))
    (tdf, trows), (jdf, jrows) = rows
    assert trows == jrows and trows
    assert tree(converted(TORCH, tdf)) == tree(converted(JAX, jdf))
    assert "AdaptiveJoinExec" in repr(tree(converted(TORCH, tdf)))
