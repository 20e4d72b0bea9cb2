"""TPC-H Q1 as the spec writes it (clause 2.4.1: grouped and ordered by the
strings l_returnflag and l_linestatus), and the other string-key paths
of chip_smoke.py (P7, P8), built by the same functions in both packages
at a few thousand lineitems made by TPC-H's generation rules:

- Q1's rows, in order, equal the JAX package's and the numpy oracle's:
  keys and counts exact, sums and averages to rtol 1e-9 (summation
  order); the flags are DictionaryColumns that decode at the aggregate's
  boundary, the filter stays the aggregate's child (the string route
  absorbs nothing), and the aggregate takes the 2-round hash route;
- the DATE literal the port's plan uses (a `datetime.date`) selects what
  the JAX package's days-since-epoch literal selects; the JAX package's
  own `lit(datetime.date)` fails to evaluate (ROADMAP C.5);
- P7's join on the string key, with the build key a StringColumn and a
  DictionaryColumn in another order, equals the JAX package and the
  oracle;
- P8's count by 4,096 distinct c_name strings equals the JAX package.
"""

import datetime
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as cs
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.exec import aggregate as jagg
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import joins as jjoins
from spark_rapids_tpu.exec import sort as jsort
from spark_rapids_tpu.expr import aggexprs as jaggexprs
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred

from spark_rapids_tpu_torch.columnar import encoded as tenc

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases

RTOL = 1e-9
N_LINE = 6000
JAX = SimpleNamespace(t=jt, core=jcore, pred=jpred, basic=jbasic,
                      joins=jjoins, agg=jagg, aggexprs=jaggexprs, sort=jsort)
CUTOFF_DAYS = (cs.Q1_SHIP_CUTOFF - datetime.date(1970, 1, 1)).days


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


@pytest.fixture(scope="module")
def data():
    return cs.q19_data(1 << 10, N_LINE)


def _batch(d, fields, n):
    return both_batch({name: (d[name], ty, None) for name, ty in fields}, n)


def _scan(m, b):
    return m.basic.InMemoryScanExec([b], b.schema)


def _rows(plan):
    return [r for b in plan.execute() for r in b.to_pylist()]


def _assert_rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=RTOL, abs=0)
            else:
                assert a == b


def test_q1_data_follows_the_generation_rules(data):
    d = data
    ship = d["l_shipdate"]
    rf = np.asarray(cs.RETURNFLAGS)[d["l_returnflag"][0]]
    ls = np.asarray(cs.LINESTATUSES)[d["l_linestatus"][0]]
    assert ship.min() >= cs.ORDER_DATE_FIRST + 1
    assert ship.max() <= cs.ORDER_DATE_LAST + 121
    assert ((ls == "O") == (ship > cs.CURRENT_DATE)).all()
    assert (rf[ship > cs.CURRENT_DATE] == "N").all()
    assert set(rf[ship + 30 < cs.CURRENT_DATE]) == {"R", "A"}
    assert set(np.round(d["l_tax"] * 100)) == set(range(9))


def test_q1_matches_jax_and_the_oracle(data):
    jb, tb = _batch(data, cs.Q1_LINE_FIELDS, N_LINE)
    tplan = cs.tpch_q1_tree(cs.port_modules(), _scan(cs.port_modules(), tb))
    jplan = cs.tpch_q1_tree(JAX, _scan(JAX, jb),
                            cutoff=jcore.Literal(CUTOFF_DAYS, jt.DATE))
    trows = _rows(tplan)
    want = cs.tpch_q1_oracle(data)
    assert [r[:2] for r in trows] == list(cs.Q1_GROUPS)
    cs.check_rows(trows, want, "Q1 port")
    _assert_rows_close(trows, _rows(jplan))
    assert cs.route_counts(tplan.child) == {
        "hash_rounds_2": 1, "hash_rounds_6": 0, "sort_fallback": 0}


def test_q1_plan_shape_and_boundary_decode(data):
    _, tb = _batch(data, cs.Q1_LINE_FIELDS, N_LINE)
    assert all(isinstance(tb.columns[i], tenc.DictionaryColumn)
               for i in (5, 6))
    m = cs.port_modules()
    plan = cs.tpch_q1_tree(m, _scan(m, tb))
    agg = plan.child
    assert type(agg.child).__name__ == "FilterExec"
    assert not agg._masked_ok and agg._hash_path_ok
    assert agg._fused_steps == [] and agg._scan_agg_spec is None
    before = tenc.counters()["materializations"]
    rows = plan.collect()
    # the two flags decode once, at the filter -> aggregate boundary
    assert tenc.counters()["materializations"] - before == 2
    cs.check_rows(rows, cs.tpch_q1_oracle(data), "Q1 collect")


@pytest.mark.parametrize("cutoff", [CUTOFF_DAYS, 9000, 8036])
def test_date_literal_selects_as_days_since_epoch(data, cutoff):
    jb, tb = _batch(data, cs.Q1_LINE_FIELDS, N_LINE)
    m = cs.port_modules()
    date = datetime.date(1970, 1, 1) + datetime.timedelta(days=cutoff)
    lit = m.core.lit(date)
    assert lit.data_type == m.t.DATE and lit.value == cutoff
    trows = _rows(cs.tpch_q1_tree(m, _scan(m, tb), cutoff=lit))
    jrows = _rows(cs.tpch_q1_tree(JAX, _scan(JAX, jb),
                                  cutoff=jcore.Literal(cutoff, jt.DATE)))
    _assert_rows_close(trows, jrows)
    cs.check_rows(trows, cs.tpch_q1_oracle(data, cutoff), "Q1 cutoff")
    with pytest.raises(TypeError):
        _rows(cs.tpch_q1_tree(JAX, _scan(JAX, jb), cutoff=jcore.lit(date)))


@pytest.mark.parametrize("encoded_build", [False, True])
def test_shipmode_join_matches_jax_and_the_oracle(data, encoded_build):
    m = cs.port_modules()
    tl, tbuild = cs.shipmode_batches(data, "cpu", encoded_build)
    jl, _ = _batch(data, cs.P7_LINE_FIELDS, N_LINE)
    modes, surcharge = cs.shipmode_table()
    if encoded_build:
        words = modes[::-1]
        mode_spec = ((np.array([words.index(x) for x in modes], np.int32),
                      words), "STRING", None)
    else:
        mode_spec = (list(modes), "STRING", None)
    jbuild, tb2 = both_batch({"sm_mode": mode_spec,
                              "sm_surcharge": (surcharge, "DOUBLE", None)},
                             len(modes))
    assert tb2.columns[0].to_pylist(7) == tbuild.columns[0].to_pylist(7)
    before = tenc.counters()["dict_hash_tables"]
    tplan = cs.shipmode_join_tree(m, _scan(m, tl), _scan(m, tbuild))
    trows = _rows(tplan)
    # the stream's dictionary once, and the build's for both seeds
    assert tenc.counters()["dict_hash_tables"] - before == \
        (3 if encoded_build else 1)
    jrows = _rows(cs.shipmode_join_tree(JAX, _scan(JAX, jl),
                                        _scan(JAX, jbuild)))
    _assert_rows_close(trows, jrows)
    cs.check_rows(sorted(trows), cs.shipmode_oracle(data, surcharge), "P7")
    assert cs.route_counts(tplan)["hash_rounds_2"] == 1


def test_names_count_matches_jax():
    n = 1 << 12
    mat = cs.customer_names(n)
    m = cs.port_modules()
    tb = cs.names_batch(mat, "cpu")
    names = tb.columns[0].to_pylist(n)
    jb, _ = both_batch({"c_name": (names, "STRING", None)}, n)
    tplan = cs.names_count_tree(m, _scan(m, tb))
    trows = _rows(tplan)
    assert trows == _rows(cs.names_count_tree(JAX, _scan(JAX, jb)))
    assert len(trows) == n and {r[1] for r in trows} == {1}
    assert sorted(r[0] for r in trows) == sorted(names)
    assert sum(cs.route_counts(tplan).values()) == 1
