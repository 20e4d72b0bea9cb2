"""The slice's paths P26-P28 of chip_smoke.py, planned from DataFrames at
a small size (TPC-H SF 0.002 by clause 4.2.3's rules, 16,384 Q1 lines),
against chip_smoke's own numpy oracles (`windows_inputs`, the checks
phase 3g runs on the card), and P26 B against the JAX package's plan:

  * P26: the orders cache()d once; spec A ranks each customer's orders by
    o_totalprice DESC and keeps the top 3 (row_number, rank, dense_rank,
    lag, lead); spec B by o_orderdate: a running sum, a 3-row sliding
    min/max, a RANGE 90-day sum, whole-partition avg and count,
    first/last_value;
  * P27: the (returnflag, linestatus) partition's revenue, average
    quantity, count and each line's share, over 16 uncoalesced batches
    (the out-of-core sort) with the carry threshold set low;
  * P28: collect_list/collect_set by order and the array expressions over
    them, explode and posexplode, percentile and approx_percentile by the
    two flags, split and explode of p_type counted by word.
Each operator is held to the JAX package in its own test file
(test_torch_window, _arrays, _generate, _percentile, _collect); a JAX
plan costs seconds of compiles, so this file compares one. Integers,
lists and row order exact; f64 to rtol 1e-9.
"""

import math
from types import SimpleNamespace

import pytest

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import windowexprs as jwin

from spark_rapids_tpu_torch.exec import window as twindow

import chip_smoke as cs
from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs
from test_torch_tpch_q14_q22 import jax_batch

RTOL = 1e-9
JAX = SimpleNamespace(t=jt, core=jcore, F=jF, session=jsession, win=jwin)


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


@pytest.fixture(scope="module")
def inputs():
    dj = cs.tpch_join_data(sf=0.002)
    q3d = cs.q3_types_data(dj)
    d19 = cs.q19_data(n_part=2048, n_line=16384)
    sd = cs.strings_data(dj, q3d)
    m, b, checks = cs.windows_inputs("cpu", dj, q3d, d19, sd)
    return m, b, checks


def close_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, float) and x is not None:
                assert math.isclose(x, y, rel_tol=RTOL), (g, w)
            else:
                assert x == y, (g, w)


def _plans(m, sess, b):
    dfs, orders = cs.p26_dfs(m, sess, b)
    dfs.update(cs.p28_dfs(m, sess, b))
    return dfs, orders


def test_p26_and_p28_match_their_oracles_and_jax(inputs):
    m, b, checks = inputs
    # the JAX package's batches of the same bytes (P26's orders, P28's
    # flags and lines)
    jb = {k: jax_batch(b[k]) for k in ("orders", "q1_lines", "lines",
                                       "part")}
    tdfs, torders = _plans(m, m.session.TpuSession(device="cpu"), b)
    jdfs, _ = _plans(JAX, jsession.TpuSession(), jb)
    for label in ("P26 B",):
        trows, jrows = tdfs[label].collect(), jdfs[label].collect()
        close_rows(trows, jrows)
    assert torders._cached_relation.materializations == 1
    for label in ("P26 A", "P26 B", "P28 collect", "P28 explode",
                  "P28 posexplode"):
        checks[label](list(cs.planned(m, tdfs[label])[0].execute()), label)
    for label in ("P28 percentile", "P28 split"):
        checks[label](tdfs[label].collect(), label)


def test_p27_takes_the_carry(inputs, monkeypatch):
    """P27 over 16 batches (more sorted runs than the merge fan-in: the
    sort goes out of core) with the carry threshold at 1,024 rows, so that
    the big partitions take the carry, against its oracle. (The carry is
    held to the JAX package's in test_torch_window.)"""
    m, b, checks = inputs
    monkeypatch.setattr(twindow.WindowExec, "TWO_PASS_THRESHOLD_ROWS", 1024)
    tdf = cs.p27_df(m, m.session.TpuSession(cs.p27_conf(b["p27"]),
                                            device="cpu"), b["p27"])
    tree = cs.planned(m, tdf)[0]
    checks["P27"](list(tree.execute()), "P27")
    drive = cs.window_metrics(tree)
    assert drive["carriedPartitions"] >= 1 and drive["carryPieces"] > 1
