"""A.2's scalar aggregates in the port against the JAX package, on the
CPU: the central moments (var_samp, var_pop, stddev_samp, stddev_pop,
from (count, sum, sum_sq) buffers, the clamp of m2 at 0, NaN for a group
of one row in the sample forms, null for an empty group), first and last
with and without ignore_nulls, and the pre-grouped update path over the
inner join's key-grouped emission.

Each aggregate is held to the JAX package once (partial -> host shuffle
-> final, whose merge takes the partials in partition order; first over
the pre-grouped path) and to a numpy oracle in every tier the reference
gives it: a grand aggregate, the masked buckets (inside a speculation scope whose
flag stays False), the exact tier (buckets that overflow, collect()'s
exact re-run), the hash route of a string key and the sort route (a min
over a string buffer keeps the hash path off). Keys, counts and
first/last values are exact; the f64 moments agree to rtol 1e-9
(reduction order); NaN matches NaN.
"""

import math

import numpy as np
import pytest

from spark_rapids_tpu.exec import aggregate as jagg
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import joins as jjoins
from spark_rapids_tpu.expr import aggexprs as jae
from spark_rapids_tpu.expr import core as jcore

from spark_rapids_tpu_torch.exec import aggregate as tagg
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import joins as tjoins
from spark_rapids_tpu_torch.exec import speculation as tspec
from spark_rapids_tpu_torch.expr import aggexprs as tae
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.ops import aggregate as tops_agg
from spark_rapids_tpu_torch.ops import fused_scan_agg, maskedagg

from test_torch_agg_modes import JAX, TORCH, _columns, _scans
from test_torch_encoded import both_batch
from test_torch_exchange import JAX_CONF
from test_torch_jax_ref import jax_aliases

RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _aggs(ae, core, ops=("moments", "first")):
    c = core.col
    out = []
    if "moments" in ops:
        out += [(ae.VarianceSamp(c("x")), "vs"), (ae.VariancePop(c("x")),
                                                  "vp"),
                (ae.StddevSamp(c("v")), "ss"), (ae.StddevPop(c("v")), "sp")]
    if "first" in ops:
        out += [(ae.First(c("v")), "f"), (ae.Last(c("x")), "l"),
                (ae.First(c("v"), ignore_nulls=True), "fi"),
                (ae.Last(c("x"), ignore_nulls=True), "li")]
    if "strings" in ops:
        out += [(ae.First(c("s")), "fs"), (ae.Last(c("s"), ignore_nulls=True),
                                           "ls")]
    if "min string" in ops:
        out += [(ae.Min(c("s")), "mins")]
    return out


def _same(a, b):
    if isinstance(b, float) and math.isnan(b):
        return isinstance(a, float) and math.isnan(a)
    if isinstance(b, float):
        return a == pytest.approx(b, rel=RTOL, abs=1e-12)
    return a == b and type(a) is type(b)


def _assert_rows(got, want, ordered=True):
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        assert all(_same(a, b) for a, b in zip(g, w)), (g, w)


def _np_moments(x, sample):
    """The reference's one-pass formula in numpy: None for no row."""
    n = x.shape[0]
    if n == 0:
        return None
    mean = x.sum() / n
    m2 = max((x * x).sum() - n * mean * mean, 0.0)
    if sample:
        return float("nan") if n == 1 else m2 / (n - 1)
    return m2 / n


def _oracle(sizes, key_dom, keys, ops, strings=False, key_nulls=True):
    """The rows of `_aggs(ops)` grouped by `keys` from the same numpy
    columns `_scans` builds, first/last by row position in the input
    (batch after batch), the moments by `_np_moments`."""
    cols = [_columns(n, i, key_dom, strings, key_nulls)
            for i, n in enumerate(sizes)]

    def lane(name):
        vals = [v for c in cols for v in (
            c[name][0].tolist() if isinstance(c[name][0], np.ndarray)
            else c[name][0])]
        valid = np.concatenate([c[name][2] for c in cols])
        return [v if ok else None for v, ok in zip(vals, valid)]
    v, x, k = lane("v"), lane("x"), lane("k")
    s = lane("s") if strings else None
    groups = {}
    for i in range(len(v)):
        key = tuple({"k": k, "s": s}[n][i] for n in keys)
        groups.setdefault(key, []).append(i)

    def first(lane_, idx, skip):
        vals = [lane_[i] for i in idx if not skip or lane_[i] is not None]
        return vals[0] if vals else None

    rows = []
    for key, idx in groups.items():
        row = list(key)
        if "moments" in ops:
            xs = np.array([x[i] for i in idx if x[i] is not None], float)
            vs = np.array([v[i] for i in idx if v[i] is not None], float)
            var = [_np_moments(xs, True), _np_moments(xs, False),
                   _np_moments(vs, True), _np_moments(vs, False)]
            row += var[:2] + [None if w is None else math.sqrt(w)
                              for w in var[2:]]
        if "first" in ops:
            row += [first(v, idx, False), first(x, idx[::-1], False),
                    first(v, idx, True), first(x, idx[::-1], True)]
        if "strings" in ops:
            row += [first(s, idx, False), first(s, idx[::-1], True)]
        if "min string" in ops:
            valid = [s[i].encode() for i in idx if s[i] is not None]
            row.append(min(valid).decode() if valid else None)
        rows.append(tuple(row))
    return rows


def _single(sizes, key_dom, keys, ops, strings=False, exact=False,
            key_nulls=True):
    """The port's complete aggregate over `_scans`' batches."""
    tscan = _scans(sizes, key_dom, strings, key_nulls=key_nulls)[1]
    agg = tagg.AggregateExec([tcore.col(k) for k in keys],
                             _aggs(tae, tcore, ops), tscan)
    if exact:
        agg._spec_enabled = False
    return agg


def _collect_spec(plan):
    with tspec.speculation_scope() as scope:
        rows = [r for b in plan.execute() for r in b.to_pylist()]
        return rows, scope.tripped()


SIZES = (300, 0, 211, 500)


def test_masked_tier_follows_the_oracle():
    """A few int keys, never null: the masked buckets, their fold taking
    each batch's partial after the running state (first = the earliest
    batch's row). A null key's rows bucket by the data under the null in
    both packages, so null keys stay out of this position check."""
    t = _single(SIZES, 4, ["k"], ("moments", "first"), key_nulls=False)
    assert t._masked_ok and t._scan_agg_spec is None  # first/last: no kernel
    rows, tripped = _collect_spec(t)
    assert not tripped
    _assert_rows(rows, _oracle(SIZES, 4, ["k"], ("moments", "first"),
                               key_nulls=False), ordered=False)


@pytest.mark.parametrize("spec", ["overflow", "exact"])
def test_exact_tier_follows_the_oracle(spec):
    """A thousand keys: the buckets overflow and collect() re-runs exactly
    (masked_groupby_exact's stable sort fallback keeps the input order
    within a group), or the exact tier outright."""
    t = _single(SIZES, 1000, ["k"], ("moments", "first"),
                exact=spec == "exact")
    if spec == "overflow":
        assert _collect_spec(t)[1]
    _assert_rows(t.collect(), _oracle(SIZES, 1000, ["k"],
                                      ("moments", "first")), ordered=False)


@pytest.mark.parametrize("ops", [("first", "strings"),
                                 ("moments", "strings", "min string")])
def test_string_routes_follow_the_oracle(ops):
    """A STRING key takes the hash route; a min over a string buffer keeps
    the hash path off, so the sort route runs (first/last over strings
    gather the picked row on both)."""
    t = _single(SIZES, 5, ["s", "k"], ops, strings=True)
    assert not t._masked_ok
    _assert_rows(t.collect(), _oracle(SIZES, 5, ["s", "k"], ops, True),
                 ordered=False)
    route = "sort_fallback" if "min string" in ops else "hash_rounds_2"
    assert t.metrics[route].value >= 1


def test_grand_aggregate_follows_the_oracle():
    t = _single((123, 0, 77), 3, [], ("moments", "first"))
    rows, tripped = _collect_spec(t)
    assert not tripped and len(rows) == 1
    want = _oracle((123, 0, 77), 3, [], ("moments", "first"))
    _assert_rows(rows, want)
    _assert_rows(t.collect(), want)


@pytest.mark.parametrize("keys", [["k"], ["s"]])
def test_partial_final_over_the_host_shuffle(keys):
    """partial -> HostShuffleExchangeExec -> final: the final merge takes
    each key's partials in partition order; by int keys the rows equal
    the JAX package's, by string keys the port's complete aggregate's
    (held to the oracle above)."""
    jscan, tscan = _scans((250, 0, 180, 90), 6, strings=True)
    ops = ("moments", "first", "strings")
    outs = []
    for m, ae, core, scan, conf in ((JAX, jae, jcore, jscan, JAX_CONF),
                                    (TORCH, tae, tcore, tscan, None)):
        if m is JAX and keys != ["k"]:
            continue
        aggs = _aggs(ae, core, ops)
        group = [core.col(k) for k in keys]
        partial = m.agg.AggregateExec(group, aggs, scan, mode="partial")
        kw = {"conf": conf} if conf is not None else {}
        ex = m.exchange.HostShuffleExchangeExec(
            [core.col(k) for k in keys], partial, 4, **kw)
        final = m.agg.AggregateExec(group, aggs, ex, mode="final",
                                    input_types=partial._input_types)
        outs.append(final.collect())
    want = outs[0] if keys == ["k"] else tagg.AggregateExec(
        [tcore.col(k) for k in keys], _aggs(tae, tcore, ops),
        tscan).collect()
    _assert_rows(outs[-1], want, ordered=False)
    _assert_rows(outs[-1], _oracle((250, 0, 180, 90), 6, keys, ops, True),
                 ordered=False)


@pytest.mark.parametrize("tier", ["masked", "exact"])
def test_moments_follow_numpy_and_their_edge_cases(tier):
    """Groups of 0 valid rows (null), of 1 row (NaN in the sample forms),
    of constant values (m2 clamped at 0: never negative, never NaN) and
    of mixed values, against the reference's one-pass formula in numpy."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.types import DOUBLE, INT, Schema, StructField
    rng = np.random.default_rng(5)
    k = np.repeat(np.arange(6, dtype=np.int32), [4, 1, 5, 30, 3, 2])
    x = rng.random(k.shape[0]) * 1e3
    x[k == 2] = 0.1 + 1e8   # constant: cancellation
    valid = np.ones(k.shape[0], bool)
    valid[k == 0] = False    # no valid row: null
    valid[k == 4] = [True, False, False]  # one valid row: NaN (sample)
    n = k.shape[0]
    b = ColumnarBatch([Column.from_numpy(k, INT, device="cpu"),
                       Column.from_numpy(x, DOUBLE, device="cpu",
                                         validity=valid)], n,
                      Schema((StructField("k", INT), StructField("x", DOUBLE))))
    c = tcore.col
    agg = tagg.AggregateExec([c("k")], [
        (tae.VarianceSamp(c("x")), "vs"), (tae.VariancePop(c("x")), "vp"),
        (tae.StddevSamp(c("x")), "ss"), (tae.StddevPop(c("x")), "sp")],
        tbasic.InMemoryScanExec([b], b.schema))
    if tier == "exact":
        agg._spec_enabled = False
    rows = {r[0]: r[1:] for r in agg.collect()}
    for g in range(6):
        xs = x[(k == g) & valid]
        vs, vp = _np_moments(xs, True), _np_moments(xs, False)
        want = (vs, vp, None if vs is None else math.sqrt(vs),
                None if vp is None else math.sqrt(vp))
        got = rows[g]
        for a, w in zip(got, want):
            if w is None:
                assert a is None
            else:
                assert _same(a, w), (g, got, want)
    assert rows[2][0] >= 0.0 and rows[2][1] >= 0.0


def test_first_last_positions_follow_the_input_order():
    """first/last (and their ignore-nulls forms) take each group's
    earliest/latest row of the input, across batches, held to numpy."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.types import INT, LONG, Schema, StructField
    rng = np.random.default_rng(11)
    n, parts = 600, 3
    k = rng.integers(0, 7, n).astype(np.int32)
    v = np.arange(n, dtype=np.int64) * 10
    valid = rng.random(n) > 0.4
    schema = Schema((StructField("k", INT), StructField("v", LONG)))
    batches = [ColumnarBatch([Column.from_numpy(k[i::parts], INT,
                                                device="cpu"),
                              Column.from_numpy(v[i::parts], LONG,
                                                device="cpu",
                                                validity=valid[i::parts])],
                             n // parts, schema) for i in range(parts)]
    order = np.concatenate([np.arange(n)[i::parts] for i in range(parts)])
    c = tcore.col
    for exact in (False, True):
        agg = tagg.AggregateExec([c("k")], [
            (tae.First(c("v")), "f"), (tae.Last(c("v")), "l"),
            (tae.First(c("v"), ignore_nulls=True), "fi"),
            (tae.Last(c("v"), ignore_nulls=True), "li")],
            tbasic.InMemoryScanExec(batches, schema))
        agg._spec_enabled = not exact
        rows = {r[0]: r[1:] for r in agg.collect()}
        for g in range(7):
            idx = order[k[order] == g]
            vi = idx[valid[idx]]
            want = (int(v[idx[0]]) if valid[idx[0]] else None,
                    int(v[idx[-1]]) if valid[idx[-1]] else None,
                    int(v[vi[0]]) if vi.size else None,
                    int(v[vi[-1]]) if vi.size else None)
            assert rows[g] == want, (exact, g)


def test_first_last_ops_reach_every_reduction():
    """The first/last family in the sort path's and the masked buckets'
    reductions: the same picks, and the fused kernel refuses them (the
    JAX package's Pallas tier has no first/last either)."""
    import torch
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.types import LONG
    v = torch.tensor([5, 6, 7, 8, 9], dtype=torch.int64)
    col = Column(v, torch.tensor([False, True, True, False, True]), LONG)
    seg = torch.tensor([0, 0, 1, 1, 1])
    act = torch.ones(5, dtype=torch.bool)
    want = {"first": ([6, 7], [True, True]), "last": ([6, 9], [True, True]),
            "first_any": ([5, 7], [False, True]),
            "last_any": ([6, 9], [True, True])}
    for op, (vals, ok) in want.items():
        assert op in tops_agg.AGG_OPS
        got, has = maskedagg.bucket_reduce(op, col, seg, 2, act)
        assert got.tolist() == vals and has.tolist() == ok, op
    assert "first" not in fused_scan_agg._SUPPORTED_OPS


# -- the pre-grouped update path ----------------------------------------------

def _join_plans(n_orders, line_batches, seed=3):
    """orders x lineitem (an inner hash join, the lineitem side streamed in
    batches whose keys repeat across batches) -> aggregate by l_orderkey
    with a min over a string, which sends the exact update to the sort
    path (`_hash_path_ok` False): the pre-grouped path skips its sort."""
    rng = np.random.default_rng(seed)
    words = ["a", "bb", "héllo", "", "zz top", "MAIL"]
    o = {"o_orderkey": (np.arange(n_orders, dtype=np.int64) * 3, "LONG",
                        None),
         "o_s": ([words[i] for i in rng.integers(0, 6, n_orders)], "STRING",
                 rng.random(n_orders) > 0.2)}
    jo, to = both_batch(o, n_orders)
    jl, tl = [], []
    for i, n in enumerate(line_batches):
        lk = rng.integers(0, n_orders, n).astype(np.int64) * 3
        lk[:: 7] += 1  # some keys without an order
        jb, tb = both_batch({"l_orderkey": (lk, "LONG", None),
                             "l_x": (rng.random(n) * 10, "DOUBLE",
                                     rng.random(n) > 0.1)}, n)
        jl.append(jb)
        tl.append(tb)
    out = []
    for joins, basic, agg, ae, core, lines, orders in (
            (jjoins, jbasic, jagg, jae, jcore, jl, jo),
            (tjoins, tbasic, tagg, tae, tcore, tl, to)):
        join = joins.HashJoinExec(
            basic.InMemoryScanExec(lines, lines[0].schema),
            basic.InMemoryScanExec([orders], orders.schema),
            [core.col("l_orderkey")], [core.col("o_orderkey")])
        c = core.col
        out.append(agg.AggregateExec([c("l_orderkey")], [
            (ae.Min(c("o_s")), "mn"), (ae.Count(), "n"),
            (ae.First(c("l_x")), "f")], join))
    return out


def test_pre_grouped_update_matches_jax_with_keys_across_batches():
    """The aggregate over the inner join's key-grouped output declares the
    pre-grouped path in both packages and skips its update sort; keys
    that repeat across stream batches merge in the partials' merge; the
    rows equal the JAX package's (same slot order of the groups) and a
    sorted update's."""
    j, t = _join_plans(64, (300, 257, 0, 199))
    assert t._pre_grouped and j._pre_grouped
    assert not t._masked_ok and not t._hash_path_ok
    calls = []
    real = tops_agg.sort_batch_columns

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    tops_agg.sort_batch_columns = spy
    try:
        got = t.collect()
    finally:
        tops_agg.sort_batch_columns = real
    want = j.collect()
    _assert_rows(got, want)
    # every update (one a join output batch) took the sort path and
    # skipped its sort; only the merge of the partials sorts
    assert len(calls) == 1
    assert t.metrics["sort_fallback"].value >= 4
    # the same aggregate with the contract withdrawn sorts every update
    t2 = _join_plans(64, (300, 257, 0, 199))[1]
    t2._pre_grouped = False
    _assert_rows(t2.collect(), got, ordered=False)


def test_contract_needs_every_class_and_bare_keys():
    """The aggregate takes the pre-grouped path only when its keys name
    every grouping class of the join, as bare columns."""
    j, t = _join_plans(16, (40,))
    join = t.children[0]
    assert join.output_grouped_by == (frozenset({"l_orderkey",
                                                 "o_orderkey"}),)
    c = tcore.col
    for keys, want in (([c("o_orderkey")], True),
                       ([c("l_orderkey"), c("o_s")], False),
                       ([c("l_orderkey") + 1], False)):
        agg = tagg.AggregateExec(keys, [(tae.Count(), "n")], join)
        assert agg._pre_grouped is want, keys
    proj = tbasic.ProjectExec([c("l_orderkey").alias("key"), c("l_x")], join)
    assert proj.output_grouped_by == (frozenset({"key"}),)


def test_grand_first_last_over_strings_return_the_row():
    """A grand first/last over a string column gives the picked row's
    string (the JAX package's masked reduction gives its first byte as a
    number, ROADMAP C.5), with and without ignore_nulls."""
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.session import TpuSession
    from spark_rapids_tpu_torch.types import DOUBLE, STRING, Schema, StructField
    rows = [None, "PROMO BRUSHED TIN", "héllo", None]
    df = TpuSession(device="cpu").from_pydict(
        {"s": rows, "x": [1.0, 2.0, 4.0, 5.0]},
        Schema((StructField("s", STRING), StructField("x", DOUBLE))))
    got = df.agg((F.first("s", True), "f"), (F.first("s"), "fa"),
                 (F.last("s", True), "l"), (F.last("s"), "la"),
                 (F.var_pop("x"), "v")).collect()
    assert got == [("PROMO BRUSHED TIN", None, "héllo", None,
                    pytest.approx(_np_moments(np.array([1.0, 2, 4, 5]),
                                              False), rel=RTOL))]
    only = df.filter(tcore.col("x") > tcore.lit(1.5)).agg(
        (F.first("s"), "f"), (F.last("s"), "l")).collect()
    assert only == [("PROMO BRUSHED TIN", None)]
