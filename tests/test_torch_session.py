"""The session: the same DataFrame queries through both packages'
TpuSession give equal rows (the port's on the CPU).

Queries: the phase 3c queries of chip_smoke (q1, q3 with LONG and INT
keys at the exact tier by conf, Q19, TPC-H Q1) in one partition and over
a host shuffle of 4 partitions, each against its numpy oracle and q1, q3
and Q19 against the JAX package's rows; and
the DataFrame surface: select, with_column, where, a USING join, sort
with limit (TopN), a grand aggregate, distinct, repartition,
coalesce(1), count, to_pydict, to_arrow, to_torch, and read_parquet with
its filter pushed down to the row groups. Keys, integers and row order
exact; f64 sums to rtol 1e-9 (summation order). Also: the session's
device rules, the methods that wait for their slices, and the names of
the JAX package's functions that the port does not have yet.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu_torch import functions as tF
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.plan import overrides as tover

from test_torch_jax_ref import jax_aliases
from test_torch_planner import (JAX, N_Q1, TORCH, active_confs, q1_columns,
                                q3_oracle, q19_batches, queries, sessions,
                                split_batches)

RTOL = 1e-9
EXACT_TIER = {"spark.rapids.tpu.agg.speculative.enabled": "false"}


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs():
        yield


def assert_rows_close(got, want, ordered=True):
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=RTOL, abs=0)
            else:
                assert a == b


def q1_oracle():
    d = {k: v for k, (v, _) in q1_columns().items()}
    return cs.q1_oracle(d)


SHUFFLED = dict(EXACT_TIER, **{
    "spark.rapids.sql.shuffle.partitions": "4",
    "spark.rapids.sql.broadcastSizeThreshold": "-1"})


@pytest.fixture(scope="module")
def planned_queries():
    """The phase 3c queries at the exact tier, in one partition (both
    packages) and over a host shuffle of 4 partitions (the port)."""
    return queries(EXACT_TIER), queries(SHUFFLED)


def _check_oracle(query, rows, metrics, label):
    if query == "q1":
        cs.check_q1(rows, q1_oracle(), label)
    elif query.startswith("q3"):
        cs.check_q3(rows, q3_oracle(np.int32 if "INT" in query
                                    else np.int64), label)
    elif query == "q19":
        pairs = next(v["numOutputRows"] for k, v in metrics.items()
                     if k.startswith(("HashJoinExec#",
                                      "ShuffledHashJoinExec#")))
        cs.check_q19(rows, pairs, cs.q19_oracle(q19_batches()[2]), label)
    else:
        cs.check_rows(rows, cs.tpch_q1_oracle(q19_batches()[2]), label)


@pytest.mark.parametrize("label", ["q1", "q3", "q3 INT keys", "q19", "P6"])
def test_phase3c_queries_match_jax_and_the_oracles(planned_queries, label):
    """The JAX package runs q1, q3 and Q19 once, in one partition; the
    port's rows in one partition and over 4 partitions equal them (q1's
    in any order) and every query's numpy oracle."""
    one, shuffled = planned_queries
    jdf, tdf = one[label]
    # INT-key q3 and P6: their trees equal the JAX package's (the planner
    # test) and the same trees' rows equal its (the q3 and TPC-H Q1 slice
    # tests); here the rows are held to the oracles, which keeps this
    # module's JAX compiles to three
    jrows = None if label in ("q3 INT keys", "P6") else jdf.collect()
    for conf, (_, df) in (("one partition", (None, tdf)),
                          ("4 partitions", shuffled[label])):
        # Q19's exchanges decode the part side: its string equalities
        # compare decoded strings there (A.8 wave 2); P6's unlimited sort
        # over 4 partitions is a range-partitioned sort (A.8 wave 1)
        rows = df.collect()
        if jrows is not None:
            assert_rows_close(rows, jrows, ordered=label != "q1")
        _check_oracle(label, rows, df.session.last_query_metrics(),
                      f"{label}, {conf}")


def _frames(conf=None, parts=2):
    """Both sessions' DataFrames of q1's columns in `parts` batches."""
    js, ts = sessions(conf)
    jb, tb = split_batches(q1_columns(), N_Q1, parts)
    return (js.from_batches(jb, jb[0].schema),
            ts.from_batches(tb, tb[0].schema))


SURFACE = {
    "select and with_column": lambda m, df: df.select(
        "returnflag", "quantity").with_column(
        "q2", m.core.col("quantity") * m.core.lit(2)).where(
        m.core.col("q2") > m.core.lit(60)),
    "sort and limit": lambda m, df: df.sort(
        ("extendedprice", False), "returnflag").limit(7, offset=2),
    "grand aggregate": lambda m, df: df.agg(
        m.F.sum("quantity"), m.F.min("discount"), m.F.max("extendedprice"),
        m.F.avg("quantity"), m.F.count()),
    "grouped abs and mean": lambda m, df: df.group_by("returnflag").agg(
        (m.F.sum(m.F.abs(m.core.col("discount") - m.core.lit(0.05))), "s"),
        (m.F.mean("extendedprice"), "avg")),
    "distinct": lambda m, df: df.select("returnflag").distinct(),
    "repartition": lambda m, df: df.repartition(3),
    "coalesce(1)": lambda m, df: df.coalesce(1).filter(
        m.core.col("quantity") < m.core.lit(5)),
}


@pytest.mark.parametrize("case", list(SURFACE))
def test_dataframe_surface_matches_jax(case):
    jdf, tdf = _frames()
    jq, tq = SURFACE[case](JAX, jdf), SURFACE[case](TORCH, tdf)
    assert tq.columns == jq.columns
    assert_rows_close(tq.collect(), jq.collect(),
                      ordered=case == "sort and limit")


def test_using_join_count_and_to_pydict_match_jax():
    js, ts = sessions(EXACT_TIER)
    out = []
    for m, sess in ((JAX, js), (TORCH, ts)):
        rng = np.random.default_rng(5)
        keys = rng.integers(0, 64, 300)
        left = sess.from_pydict(
            {"k": keys.tolist(), "v": rng.random(300).tolist()},
            m.t.Schema((m.t.StructField("k", m.t.LONG),
                        m.t.StructField("v", m.t.DOUBLE))), batch_rows=128)
        right = sess.from_pydict(
            {"k": list(range(0, 64, 2)), "name": [f"n{i}" for i in
                                                  range(0, 64, 2)]},
            m.t.Schema((m.t.StructField("k", m.t.LONG),
                        m.t.StructField("name", m.t.STRING))))
        joined = left.join(right, on="k")
        out.append((joined.columns, sorted(joined.collect()),
                    joined.count(), left.to_pydict()))
        if m is TORCH:
            assert left.to_arrow().to_pydict() == left.to_pydict()
    assert out[1][0] == out[0][0] == ["k", "v", "name"]
    assert_rows_close(out[1][1], out[0][1])
    assert out[1][2] == out[0][2] == len(out[0][1])
    assert out[1][3] == out[0][3]


def test_to_torch_returns_the_result_tensors():
    jdf, tdf = _frames()
    q = lambda m, df: df.filter(m.core.col("returnflag") == m.core.lit(2)) \
        .select("quantity", "discount")
    got = q(TORCH, tdf).to_torch()
    want = q(JAX, jdf).to_jax()
    for name in ("quantity", "discount"):
        data, valid = got[name]
        assert isinstance(data, torch.Tensor) and data.device.type == "cpu"
        np.testing.assert_array_equal(data.numpy(),
                                      np.asarray(want[name][0]))
        assert bool(valid.all())


def test_read_parquet_pushes_its_filter_down(tmp_path):
    pq = pytest.importorskip("pyarrow.parquet")
    import pyarrow as pa
    rng = np.random.default_rng(3)
    n = 4000
    table = pa.table({"k": np.sort(rng.integers(0, 1000, n)),
                      "v": rng.random(n),
                      "s": rng.choice(["x", "y", "z"], n)})
    path = tmp_path / "t.parquet"
    pq.write_table(table, path, row_group_size=500)
    js, ts = sessions()
    out = []
    for m, sess in ((JAX, js), (TORCH, ts)):
        df = sess.read_parquet(str(path))
        q = df.filter(m.core.col("k") >= m.core.lit(800)).group_by("s").agg(
            m.F.count(), m.F.sum("v"))
        rows = q.collect()
        scan = df.logical_plan().source
        out.append((rows, m.overrides.TpuOverrides(sess.conf).wrap_and_tag(
            q.logical_plan()).convert()))
    assert_rows_close(out[1][0], out[0][0], ordered=False)

    def source_of(node):
        while node.children:
            node = node.children[0]
        return node._source

    # the pushed conjunct prunes the same row groups in both packages
    jsrc, tsrc = source_of(out[0][1]), source_of(out[1][1])
    assert tsrc.filters == jsrc.filters == [("k", ">=", 800)]
    list(tsrc.batches())
    list(jsrc.batches())
    assert tsrc.row_groups_pruned == jsrc.row_groups_pruned >= 4
    assert scan.filters == []  # the user's source is left as it was


def test_session_device_rules():
    sess = tsession.TpuSession(device="cpu")
    assert sess.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsession.TpuSession()


@pytest.mark.parametrize("call, item", [
    (lambda s, df: df.unpersist(), "A.8 wave 3"),
    (lambda s, df: df.sample(0.5), "A.8 wave 1"),
    (lambda s, df: df.with_windows(), "A.8 wave 3"),
    (lambda s, df: df.explode("returnflag"), "A.8 wave 3"),
    (lambda s, df: df.cache(), "A.8 wave 3"),
    (lambda s, df: df.map_in_pandas(None, None), "A.8 wave 4"),
    (lambda s, df: df.group_by("returnflag").apply_in_pandas(None, None),
     "A.8 wave 4"),
    (lambda s, df: df.write_parquet("x"), "A.5"),
    (lambda s, df: df.write_csv("x"), "A.8 wave 5"),
    (lambda s, df: s.read_csv("x"), "A.8 wave 5"),
    (lambda s, df: s.health(), "A.9"),
    (lambda s, df: s.cancel_query(), "A.9"),
])
def test_methods_that_wait_for_their_slice_name_it(call, item):
    _, tdf = _frames()
    if item == "A.8 wave 1":
        # sample() waited for A.8 wave 1, which has landed: it plans now
        assert isinstance(call(tdf.session, tdf), tsession.DataFrame)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        call(tdf.session, tdf)


#: the JAX package's functions the port has (api/functions.py)
PORTED_FUNCTIONS = {"col", "lit", "sum", "count", "avg", "mean", "min",
                    "max", "abs", "when", "coalesce", "nvl", "ifnull",
                    "nvl2", "nullif",
                    # A.8 wave 1: dates, times, bitwise, format_number
                    "add_months", "date_add", "date_sub", "datediff",
                    "dayofmonth", "dayofweek", "dayofyear", "last_day",
                    "month", "quarter", "trunc", "year", "hour", "minute",
                    "second", "from_utc_timestamp", "to_utc_timestamp",
                    "bitwise_not", "shiftleft", "shiftright",
                    "shiftrightunsigned", "format_number",
                    # A.2's scalar aggregates (first_value and
                    # last_value are window functions: they raise
                    # naming wave 3, test_window_function_names_...)
                    "first", "first_value", "last", "last_value",
                    "stddev", "stddev_pop", "stddev_samp", "var_pop",
                    "var_samp", "variance",
                    # A.8 wave 2: strings, regex, codecs, hashes
                    "ascii", "base64", "bit_length", "chr", "concat",
                    "concat_ws", "contains", "decode", "encode",
                    "endswith", "find_in_set", "hash", "hex", "initcap",
                    "instr", "left", "length", "levenshtein", "like",
                    "locate", "lower", "lpad", "ltrim", "octet_length",
                    "regexp_extract", "regexp_replace", "repeat",
                    "replace", "reverse", "right", "rlike", "rpad",
                    "rtrim", "startswith", "substring", "substring_index",
                    "translate", "trim", "unbase64", "unhex", "upper",
                    "xxhash64"}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and callable(getattr(mod, n))
            and getattr(getattr(mod, n), "__module__", "").startswith(
                mod.__name__.rsplit(".api", 1)[0])}


def test_the_functions_gap_is_explicit():
    """Every function of the JAX package's api/functions that the port
    lacks is listed here; each comes with its expressions (ROADMAP A.8).
    A function ported later moves from MISSING_FUNCTIONS to
    PORTED_FUNCTIONS."""
    jax_names = {n for n in _public(jF)
                 if not isinstance(getattr(jF, n), type)}
    port_names = {n for n in _public(tF)
                  if not isinstance(getattr(tF, n), type)}
    assert port_names == PORTED_FUNCTIONS
    assert PORTED_FUNCTIONS <= jax_names
    assert jax_names - port_names == MISSING_FUNCTIONS


@pytest.mark.parametrize("name", ["first_value", "last_value"])
def test_window_function_names_wait_for_their_slice(name):
    """first_value and last_value build the JAX package's window functions
    (FirstValue, LastValue), not the first/last aggregates: the port's
    raise naming the window functions' slice rather than mean something
    else under the same name."""
    from spark_rapids_tpu.expr.windowexprs import WindowFunction
    assert isinstance(getattr(jF, name)("returnflag"), WindowFunction)
    with pytest.raises(NotImplementedError, match="ROADMAP A.8 wave 3"):
        getattr(tF, name)("returnflag")


#: the JAX package's functions that wait for their expressions (46):
#: the array, map and window functions and the aggregates that buffer
#: arrays (A.8 wave 3, A.2), the JSON, URL and higher-order functions,
#: udf and split (waves 3-4)
MISSING_FUNCTIONS = {
    'aggregate', 'approx_percentile', 'array', 'array_contains',
    'array_distinct', 'array_join', 'array_max', 'array_min',
    'array_position', 'array_remove', 'array_repeat', 'arrays_overlap',
    'collect_list', 'collect_set', 'create_map', 'dense_rank', 'element_at',
    'element_at_key', 'exists', 'filter_', 'flatten', 'forall',
    'get_array_item', 'get_json_object', 'get_map_value', 'lag', 'lead',
    'map_contains_key', 'map_keys', 'map_values', 'parse_url', 'percentile',
    'rank', 'row_number', 'sequence', 'size', 'slice', 'sort_array', 'split',
    'transform', 'udf', 'window_avg', 'window_count', 'window_max',
    'window_min', 'window_sum'}
