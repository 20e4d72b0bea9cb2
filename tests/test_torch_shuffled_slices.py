"""The slice's three paths over the host shuffle (chip_smoke.py's P9-P11)
at a small size, built by chip_smoke's own plan functions in both
packages (both packages' exchanges with their adaptive and recovery
planes off: test_torch_adaptive_reads.py holds P11 with them on) from the
same numpy arrays, on the CPU:

- P9, bench q1 over 16 batches: partial (the absorbed filter and
  project) -> hash exchange on the flag into 16 partitions -> final;
- P10, TPC-H Q1: the string route split the same way over both flags,
  then the sort; 4 groups in the order A/F, N/F, N/O, R/F;
- P11, q3: both filtered sides hash-exchanged on the order key, the
  shuffled join, partial -> exchange -> final, TopN(10); LONG and INT
  keys (8 lineitem and 2 order batches into 8 partitions here).

Each equals the JAX plan's rows in order and its numpy oracle (integers
and keys exact, f64 to rtol 1e-9), keeps its speculation flags False,
leaves no shuffle file, and launches no kernel on CPU tensors.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as cs
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.exec import aggregate as jagg
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import exchange as jexchange
from spark_rapids_tpu.exec import joins as jjoins
from spark_rapids_tpu.exec import sort as jsort
from spark_rapids_tpu.expr import aggexprs as jaggexprs
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred

from spark_rapids_tpu_torch.exec import speculation as tspec
from spark_rapids_tpu_torch.shuffle import manager as tmanager

from test_torch_encoded import both_batch
from test_torch_exchange import JAX_CONF, PORT_CONF
from test_torch_jax_ref import jax_aliases
from test_torch_tpch_q1_slice import CUTOFF_DAYS, _assert_rows_close

JAX = SimpleNamespace(t=jt, core=jcore, pred=jpred, basic=jbasic,
                      joins=jjoins, agg=jagg, aggexprs=jaggexprs, sort=jsort,
                      exchange=jexchange, exchange_kw={"conf": JAX_CONF})
PARTS = 16
BATCH = 1024


def _port():
    """chip_smoke's port namespace, its exchanges on the static plan."""
    m = cs.port_modules()
    m.exchange_kw = {"conf": PORT_CONF}
    return m


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


@pytest.fixture(autouse=True)
def _manager(tmp_path):
    mgr = tmanager.reset_shuffle_manager(str(tmp_path))
    yield mgr
    assert mgr.registered() == 0 and os.listdir(mgr.root_dir()) == []


@pytest.fixture(autouse=True)
def _no_launches():
    wrappers = cs.kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    yield
    assert {k: w.launches for k, w in wrappers.items()} == \
        {k: 0 for k in wrappers}


def _spec_rows(plan):
    """collect()'s first run: the rows, and the flags must stay False."""
    with tspec.speculation_scope() as scope:
        rows = [r for b in plan._execute(encoded_out=True)
                for r in b.to_pylist()]
        assert not scope.tripped()
    return rows


def _scans(columns, n, parts):
    """Both packages' scans of `columns` ({name: (array, type)}) as
    `parts` batches of equal size."""
    step = n // parts
    js, ts = [], []
    for i in range(0, n, step):
        jb, tb = both_batch({k: (v[i: i + step], ty, None)
                             for k, (v, ty) in columns.items()}, step)
        js.append(jb)
        ts.append(tb)
    return (jbasic.InMemoryScanExec(js, js[0].schema),
            cs.port_modules().basic.InMemoryScanExec(ts, ts[0].schema))


def test_p9_q1_shuffled_matches_jax_and_the_oracle(monkeypatch):
    monkeypatch.setattr(cs, "ROWS", 16 * BATCH)
    d = cs.q1_data()
    cols = {"returnflag": (d["returnflag"], "INT"),
            "quantity": (d["quantity"], "LONG"),
            "extendedprice": (d["extendedprice"], "DOUBLE"),
            "discount": (d["discount"], "DOUBLE")}
    jscan, tscan = _scans(cols, cs.ROWS, 16)
    tplan = cs.q1_tree(cs.port_modules(), tscan, PARTS)
    jplan = cs.q1_tree(JAX, jscan, PARTS)
    partial = tplan.child.child
    assert partial.mode == "partial" and partial._scan_agg_spec is not None
    assert tplan.mode == "final" and tplan._scan_agg_spec is None
    rows = _spec_rows(tplan)
    cs.check_q1(rows, cs.q1_oracle(d), "P9")
    _assert_rows_close(rows, jplan.collect())
    ex = tplan.child
    assert ex.metrics["numMapsWithRows"].value == 1
    assert ex.metrics["numReorderGathers"].value == 1
    assert ex.metrics["numFramesRead"].value == \
        ex.metrics["numFramesWritten"].value


def test_p10_tpch_q1_shuffled_matches_jax_and_the_oracle():
    d = cs.q19_data(1 << 10, 6000)
    jb, tb = both_batch({name: (d[name], ty, None)
                         for name, ty in cs.Q1_LINE_FIELDS}, 6000)
    m = cs.port_modules()
    tplan = cs.tpch_q1_tree(m, cs.scan_of(m, tb), n_parts=PARTS)
    jplan = cs.tpch_q1_tree(JAX, cs.scan_of(JAX, jb),
                            cutoff=jcore.Literal(CUTOFF_DAYS, jt.DATE),
                            n_parts=PARTS)
    rows = _spec_rows(tplan)
    assert [r[:2] for r in rows] == list(cs.Q1_GROUPS)
    cs.check_rows(rows, cs.tpch_q1_oracle(d), "P10")
    _assert_rows_close(rows, jplan.collect())
    final = tplan.child
    assert final.mode == "final" and not final._masked_ok
    assert cs.route_counts(final.child.child)["hash_rounds_2"] == 1


@pytest.mark.parametrize("key", ["LONG", "INT"])
def test_p11_q3_shuffled_matches_jax_and_the_oracle(monkeypatch, key):
    monkeypatch.setattr(cs, "Q3_ORDERS", 1 << 11)
    monkeypatch.setattr(cs, "Q3_LINES", 1 << 13)
    d = cs.q3_data(np.int64 if key == "LONG" else np.int32)
    o_schema, l_schema = cs.q3_schemas(key)
    scans = [_scans({f.name: (d[f.name], key if f.name.endswith("orderkey")
                              else f.data_type.simple_name().upper()
                              .replace("BIGINT", "LONG"))
                     for f in schema.fields}, n, parts)
             for schema, n, parts in ((o_schema, cs.Q3_ORDERS, 2),
                                      (l_schema, cs.Q3_LINES, 8))]
    (jo, to), (jl, tl) = scans
    tplan = cs.q3_tree(_port(), to, tl, n_parts=8)
    jplan = cs.q3_tree(JAX, jo, jl, n_parts=8)
    rows = _spec_rows(tplan)
    cs.check_q3(rows, cs.q3_oracle(d), "P11")
    want = jplan.collect()
    assert [r[0] for r in rows] == [r[0] for r in want]
    _assert_rows_close(rows, want)
    join = cs.p11_join(tplan)
    assert join.metrics["numPartitionPairs"].value == 8
    assert join.metrics["numStreamBatches"].value <= 8 * 8
    exs = cs.exchanges_of(tplan)
    assert [e.metrics["numMapsWithRows"].value for e in exs] == [1, 8, 2]
