"""The q19 slice end to end: TPC-H Q19 over dictionary-encoded strings,
built by chip_smoke.q19_plan identically in both packages (two filtered
scans -> inner HashJoinExec with the build side on the right and the
query's three-way OR as its residual condition -> ProjectExec -> grand
AggregateExec), on data made by TPC-H's generation rules at 4,096 parts.

Revenue agrees with the JAX package and the numpy oracle to rtol 1e-9
(summation order); the qualifying row count (the join's output rows)
exactly. Cases: the query's validation parameters; quantity and size
ranges widened so that more than 100 rows qualify; and only the absent
literal 'AIR REG' for l_shipmode, where no row qualifies and the sum is
null.
"""

from types import SimpleNamespace

import pytest

import chip_smoke as cs
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.exec import aggregate as jagg
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import joins as jjoins
from spark_rapids_tpu.exec import speculation as jspec
from spark_rapids_tpu.expr import aggexprs as jaggexprs
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred

from spark_rapids_tpu_torch.columnar import encoded as tenc
from spark_rapids_tpu_torch.exec import speculation as tspec
from spark_rapids_tpu_torch.ops import (dict_gather, murmur3_lanes,
                                        probe_verify, row_gather)

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases

RTOL = 1e-9
N_PART = 1 << 12
JAX = SimpleNamespace(t=jt, core=jcore, pred=jpred, basic=jbasic,
                      joins=jjoins, agg=jagg, aggexprs=jaggexprs)
WIDE = tuple((b, c, 1, 50) for b, c, _, _ in cs.Q19_TERMS)

CASES = {
    "spec": (1 << 16, {}),
    "widened": (1 << 18, {"terms": WIDE, "span": 49}),
    "absent literal": (1 << 16, {"shipmodes": ("AIR REG",)}),
}


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _batches(d):
    """(JAX, port) lineitem and part batches from the same numpy arrays."""
    out = []
    for fields in (cs.Q19_LINE_FIELDS, cs.Q19_PART_FIELDS):
        cols = {name: (d[name], ty, None) for name, ty in fields}
        out.append(both_batch(cols, len(d[fields[0][0]])))
    (jl, tl), (jp, tp) = out
    return (jl, jp), (tl, tp)


def _run(plan, spec):
    """Rows of the plan under a speculation scope, and the join's output
    rows (the qualifying lineitem rows)."""
    with spec.speculation_scope() as scope:
        rows = [r for b in plan.execute() for r in b.to_pylist()]
        assert not scope.tripped()
    return rows, plan._source.metrics["numOutputRows"].value


#: the wrappers of the kernels on the q19 path
KERNELS = (dict_gather.dict_gather, murmur3_lanes.murmur3_columns,
           murmur3_lanes.murmur3_long_lanes, probe_verify.fused_probe_verify,
           row_gather.dma_row_gather)


@pytest.mark.parametrize("case", list(CASES))
def test_q19_slice_matches_jax_and_oracle(case):
    n_line, kw = CASES[case]
    d = cs.q19_data(N_PART, n_line)
    oracle = cs.q19_oracle(d, **kw)
    (jl, jp), (tl, tp) = _batches(d)
    jrows, jpairs = _run(cs.q19_plan(JAX, jl, jp, **kw), jspec)
    for f in KERNELS:
        f.launches = 0
    tplan = cs.q19_plan(cs.port_modules(), tl, tp, **kw)
    before = tenc.counters()["code_space_predicates"]
    trows, tpairs = _run(tplan, tspec)
    assert [f.launches for f in KERNELS] == [0] * len(KERNELS)  # plain
    # every string predicate ran in code space: 3 on lineitem, 15 on
    # part, 8 per disjunct of the residual condition
    assert tenc.counters()["code_space_predicates"] - before == \
        len(kw.get("shipmodes", cs.Q19_SHIPMODES)) + 1 + 15 \
        + 3 * (4 + len(kw.get("shipmodes", cs.Q19_SHIPMODES)) + 2)
    cs.check_q19(trows, tpairs, oracle, case)
    assert tpairs == jpairs
    assert len(jrows) == len(trows) == 1
    if oracle[0] is None:
        assert trows == jrows == [(None,)]
    else:
        assert trows[0][0] == pytest.approx(jrows[0][0], rel=RTOL, abs=0)
    if case == "widened":
        assert tpairs >= 100
    # the exact tier (no speculation scope) gives the same answer
    exact = [r for b in tplan.execute() for r in b.to_pylist()]
    cs.check_q19(exact, tpairs, oracle, case + " exact")


def test_q19_plan_shape():
    d = cs.q19_data(N_PART, 1 << 12)
    _, (tl, tp) = _batches(d)
    plan = cs.q19_plan(cs.port_modules(), tl, tp)
    join = plan._source
    # the join absorbed both filters as key masks and keeps the strings
    # encoded; the aggregate absorbed the projection and reads the join,
    # whose output decodes at the boundary, as in the JAX package
    assert type(join).__name__ == "HashJoinExec"
    assert [type(c).__name__ for c in join.children] == \
        ["InMemoryScanExec", "InMemoryScanExec"]
    assert [s[0] for s in plan._fused_steps] == ["project"]
    assert join.consumes_encoded and not plan.consumes_encoded
    before = tenc.counters()["materializations"]
    rows = plan.collect()
    assert not join._encoded_ok_for_parent
    # the four string columns of the join's one output batch
    assert tenc.counters()["materializations"] - before == 4
    rev = cs.q19_oracle(d)[0]
    if rev is None:
        assert rows == [(None,)]
    else:
        assert rows[0][0] == pytest.approx(rev, rel=RTOL, abs=0)


def test_q19_build_side_keeps_dictionary_payload():
    """The part side's dictionary columns ride the join by row index: the
    joined rows decode to the strings the numpy data hold."""
    d = cs.q19_data(N_PART, 1 << 12)
    _, (tl, tp) = _batches(d)
    kw = {"terms": WIDE, "span": 49, "shipmodes": cs.SHIPMODES}
    join = cs.q19_plan(cs.port_modules(), tl, tp, **kw)._source
    join._encoded_ok_for_parent = True      # as its aggregate stamps it
    batch, = list(join.execute())
    rows = batch.to_pylist()
    assert len(rows) == cs.q19_oracle(d, **kw)[1] > 0
    names = [f.name for f in batch.schema.fields]
    for r in rows:
        v = dict(zip(names, r))
        p = v["p_partkey"] - 1
        assert v["l_partkey"] == v["p_partkey"]
        assert v["p_brand"] == cs.BRANDS[d["p_brand"][0][p]]
        assert v["p_container"] == cs.CONTAINERS[d["p_container"][0][p]]
        assert v["p_size"] == d["p_size"][p]
        assert v["l_shipinstruct"] == cs.Q19_INSTRUCT
    assert isinstance(batch.columns[names.index("p_brand")],
                      tenc.DictionaryColumn)
    rev = sum(v[names.index("l_extendedprice")]
              * (1.0 - v[names.index("l_discount")]) for v in rows)
    assert rev == pytest.approx(cs.q19_oracle(d, **kw)[0], rel=RTOL, abs=0)


def test_q19_with_an_empty_part_side_gives_a_null_sum():
    """No part batch at all: the build side is an empty batch whose string
    columns are empty dictionaries; nothing qualifies and the grand
    aggregate emits its one null row, on both tiers."""
    d = cs.q19_data(N_PART, 1 << 12)
    _, (tl, tp) = _batches(d)
    m = cs.port_modules()
    plan = cs.q19_plan(m, tl, tp)
    parts = plan._source.children[1]
    parts._batches = []
    parts._device = "cpu"
    assert plan.collect() == [(None,)]
    assert [r for b in plan.execute() for r in b.to_pylist()] == [(None,)]
