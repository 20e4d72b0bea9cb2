"""The aggregate's partial and final modes in the port
(exec/aggregate.py) over the host shuffle exchange, against the JAX
package's same plan (partial -> HostShuffleExchangeExec -> final, as
its planner's `_convert_host_shuffled_aggregate` builds it), on the CPU:

- the masked tier (a few keys, inside a speculation scope whose flags
  stay False), the exact tier (a thousand keys: the flag trips and
  collect() re-runs exactly), the string route (a STRING key), Average
  with all-null and empty groups, a grand aggregate through a single
  exchange, and final aggregates over partitions that are all empty;
- the final output equals the reference's row for row (keys, counts and
  integer sums exact, f64 sums to rtol 1e-9: reduction order) and the
  single-stage (complete) aggregate's result;
- the schemas by mode: partial emits keys and buffers, final the
  complete aggregate's result types.
"""

import numpy as np
import pytest

from spark_rapids_tpu.exec import aggregate as jagg
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import exchange as jexchange
from spark_rapids_tpu.expr import aggexprs as jaggexprs
from spark_rapids_tpu.expr import core as jcore

from spark_rapids_tpu_torch.exec import aggregate as tagg
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import exchange as texchange
from spark_rapids_tpu_torch.exec import speculation as tspec
from spark_rapids_tpu_torch.expr import aggexprs as taggexprs
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.ops import fused_scan_agg

from test_torch_encoded import both_batch
from test_torch_exchange import JAX_CONF
from test_torch_jax_ref import jax_aliases

RTOL = 1e-9
WORDS = ["", "a", "REG AIR", "héllo", "AIR", "x" * 40, "MAIL"]


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _columns(n, seed, key_dom, strings=False, key_nulls=True):
    rng = np.random.default_rng(seed)
    v = rng.integers(-100, 100, n).astype(np.int32)
    valid = rng.random(n) > 0.2
    k = rng.integers(0, key_dom, n).astype(np.int32)
    # key 3's inputs are all null: its sums, min, max and avg are null
    valid[k == 3] = False
    cols = {"k": (k, "INT", rng.random(n) > (0.05 if key_nulls else -1)),
            "v": (v, "INT", valid),
            "x": (rng.random(n) * 100, "DOUBLE", rng.random(n) > 0.1)}
    if strings:
        cols["s"] = ([WORDS[i] for i in rng.integers(0, len(WORDS), n)],
                     "STRING", rng.random(n) > 0.1)
    return cols


def _scans(sizes, key_dom, strings=False, seed=0, key_nulls=True):
    js, ts = [], []
    for i, n in enumerate(sizes):
        jb, tb = both_batch(_columns(n, seed + i, key_dom, strings,
                                     key_nulls), n)
        js.append(jb)
        ts.append(tb)
    return (jbasic.InMemoryScanExec(js, js[0].schema),
            tbasic.InMemoryScanExec(ts, ts[0].schema))


def _aggs(ae, core):
    c = core.col
    return [(ae.Sum(c("v")), "sv"), (ae.Sum(c("x")), "sx"),
            (ae.Count(c("v")), "cv"), (ae.Count(), "cnt"),
            (ae.Min(c("v")), "mn"), (ae.Max(c("x")), "mx"),
            (ae.Average(c("v")), "av"), (ae.Average(c("x")), "ax")]


def _shuffled(m, ae, core, scan, keys, n_parts, exact, conf):
    aggs = _aggs(ae, core)
    group = [core.col(k) for k in keys]
    partial = m.agg.AggregateExec(group, aggs, scan, mode="partial")
    kw = {"conf": conf} if conf is not None else {}
    if keys:
        exchange = m.exchange.HostShuffleExchangeExec(
            [core.col(k) for k in keys], partial, n_parts, **kw)
    else:
        exchange = m.exchange.HostShuffleExchangeExec(
            [], partial, 1, partitioning="single", **kw)
    final = m.agg.AggregateExec(group, aggs, exchange, mode="final",
                                input_types=partial._input_types)
    if exact:
        partial._spec_enabled = final._spec_enabled = False
    return partial, final


class _M:
    def __init__(self, agg, exchange):
        self.agg, self.exchange = agg, exchange


JAX = _M(jagg, jexchange)
TORCH = _M(tagg, texchange)


def _plans(sizes, key_dom, keys, n_parts=8, strings=False, exact=False,
           key_nulls=True):
    jscan, tscan = _scans(sizes, key_dom, strings, key_nulls=key_nulls)
    jp, jf = _shuffled(JAX, jaggexprs, jcore, jscan, keys, n_parts, exact,
                       JAX_CONF)
    tp, tf = _shuffled(TORCH, taggexprs, tcore, tscan, keys, n_parts, exact,
                       None)
    complete = tagg.AggregateExec([tcore.col(k) for k in keys],
                                  _aggs(taggexprs, tcore), tscan)
    return (jp, jf), (tp, tf), complete


def _assert_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=RTOL, abs=0), (g, w)
            else:
                assert a == b and type(a) is type(b), (g, w)


def _collect_spec(plan):
    """plan.collect()'s first run alone: one speculation scope, its flag
    read once (the rows and whether it tripped)."""
    with tspec.speculation_scope() as scope:
        rows = [r for b in plan.execute() for r in b.to_pylist()]
        return rows, scope.tripped()


def test_masked_tier_matches_jax_and_keeps_its_flags():
    # q1's keys: 0-3, never null (the fused kernel's one round of 32
    # buckets holds them apart; a null key collides with one of them)
    (jp, jf), (tp, tf), complete = _plans((700, 0, 333, 1000), 4, ["k"],
                                          key_nulls=False)
    fused_scan_agg.fused_scan_agg.launches = 0
    rows, tripped = _collect_spec(tf)
    assert not tripped
    _assert_rows(rows, jf.collect())
    assert sorted(rows, key=repr) == pytest.approx(
        sorted(complete.collect(), key=repr))
    # the partial took no fused kernel on CPU tensors, and the final
    # mode none at all
    assert fused_scan_agg.fused_scan_agg.launches == 0
    assert tf._scan_agg_spec is None and tf._fused_steps == []


@pytest.mark.parametrize("exact", [False, True])
def test_exact_tier_matches_jax(exact):
    (jp, jf), (tp, tf), complete = _plans((700, 500, 0, 900), 1000,
                                          ["k"], exact=exact)
    if not exact:
        assert _collect_spec(tf)[1]  # 1,000 keys overflow the buckets
    got = tf.collect()
    _assert_rows(got, jf.collect())
    assert len(got) == len({r[0] for r in got})


def test_string_route_matches_jax():
    (jp, jf), (tp, tf), complete = _plans((600, 0, 900), 5, ["s", "k"],
                                          n_parts=4, strings=True)
    assert not tp._masked_ok and not tf._masked_ok
    got = tf.collect()
    _assert_rows(got, jf.collect())
    assert tf.metrics["hash_rounds_2"].value >= 1


def test_average_with_all_null_and_empty_groups():
    (jp, jf), (tp, tf), complete = _plans((40, 0, 25), 6, ["k"], n_parts=16)
    got = tf.collect()
    _assert_rows(got, jf.collect())
    by_key = {r[0]: r for r in got}
    names = tf.output_schema.names
    assert by_key[3][names.index("av")] is None   # count 0: null
    assert by_key[3][names.index("cv")] == 0
    assert by_key[3][names.index("sv")] is None
    assert any(r[names.index("ax")] is not None for r in got)


def test_schemas_by_mode():
    (jp, jf), (tp, tf), complete = _plans((10,), 3, ["k"])
    assert [f.data_type.simple_name() for f in tp.output_schema.fields] == \
        [f.data_type.simple_name() for f in jp.output_schema.fields]
    assert tf.output_schema == complete.output_schema
    assert [str(f.data_type) for f in tf.output_schema.fields] == \
        [str(f.data_type) for f in jf.output_schema.fields]
    # without input_types, final derives the same result types
    bare = tagg.AggregateExec([tcore.col("k")], _aggs(taggexprs, tcore),
                              tf.child, mode="final")
    assert bare.output_schema == complete.output_schema


def test_grand_aggregate_through_a_single_exchange():
    (jp, jf), (tp, tf), complete = _plans((500, 0, 123), 7, [])
    got = tf.collect()
    assert len(got) == 1
    _assert_rows(got, jf.collect())
    _assert_rows(got, complete.collect())


@pytest.mark.parametrize("keys", [["k"], []])
def test_final_over_partitions_that_are_all_empty(keys):
    (jp, jf), (tp, tf), complete = _plans((0, 0), 4, keys, n_parts=4)
    got = tf.collect()
    _assert_rows(got, jf.collect())
    _assert_rows(got, complete.collect())
    assert len(got) == (0 if keys else 1)
