"""The dictionary-encoded string lane (columnar/encoded.py and its callers)
against the JAX package, on the CPU.

Both packages' columns are built from the same numpy arrays (`both_batch`:
the port's numpy constructor pads them; the JAX DictionaryColumn is
constructed directly from the port's padded codes, bytes and offsets), so
codes, padding and the data under null slots agree. Everything compared
here is boolean or integer: exact, no tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar import encoded as jenc
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.columnar.column import StringColumn as JString
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import sort as jsortexec
from spark_rapids_tpu.expr import arithmetic as jarith
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred
from spark_rapids_tpu.ops import basic as jops

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar import encoded as tenc
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.columnar.column import Column as TColumn
from spark_rapids_tpu_torch.columnar.column import StringColumn as TString
from spark_rapids_tpu_torch.columnar.column import string_buffers
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import sort as tsortexec
from spark_rapids_tpu_torch.expr import arithmetic as tarith
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import predicates as tpred
from spark_rapids_tpu_torch.ops import basic as tops
from spark_rapids_tpu_torch.ops import dict_gather

from test_torch_jax_ref import jax_aliases

SHIPMODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB", "")


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def both_column(values, type_name, validity=None, capacity=None):
    """(JAX column, port column) from one numpy column: an ndarray, a list
    of str, bytes or None for a plain string column, or (int32 codes,
    dictionary values) for a dictionary-encoded one."""
    if isinstance(values, list):
        valid = [v is not None for v in values] if validity is None \
            else list(validity)
        t = TString.from_pylist([v if ok else None
                                 for v, ok in zip(values, valid)],
                                capacity=capacity, device="cpu")
        j = JString(jnp.asarray(t.data.numpy()),
                    jnp.asarray(t.offsets.numpy()),
                    jnp.asarray(t.validity.numpy()), jt.StringType())
        return j, t
    if isinstance(values, tuple):
        codes, words = values
        t = tenc.dictionary_from_numpy(codes, *string_buffers(words),
                                       validity=validity, capacity=capacity,
                                       device="cpu")
        j = jenc.DictionaryColumn(
            jnp.asarray(t.codes.numpy()), jnp.asarray(t.dict_data.numpy()),
            jnp.asarray(t.dict_offsets.numpy()),
            jnp.asarray(t.validity.numpy()), jt.StringType())
        return j, t
    t = TColumn.from_numpy(values, getattr(tt, type_name), capacity=capacity,
                           validity=validity, device="cpu")
    j = JColumn(jnp.asarray(t.data.numpy()), jnp.asarray(t.validity.numpy()),
                getattr(jt, type_name))
    return j, t


def both_batch(columns, n, capacity=None):
    """(JAX batch, port batch) from {name: (values, type name, validity)}
    — the dictionary-aware companion of ColumnarBatch.from_numpy_columns."""
    pairs = [both_column(v, ty, valid, capacity)
             for v, ty, valid in columns.values()]
    out = []
    for t, k in ((jt, 0), (tt, 1)):
        schema = t.Schema(tuple(t.StructField(name, getattr(t, ty))
                                for name, (_, ty, _) in columns.items()))
        out.append((JBatch, TBatch)[k]([p[k] for p in pairs], n, schema))
    return out


def _sample(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    mode = rng.integers(0, len(SHIPMODES), n).astype(np.int32)
    inst = rng.integers(0, 4, n).astype(np.int32)
    return {
        "m": ((mode, SHIPMODES), "STRING", rng.random(n) > 0.1),
        "s": ((inst, ("DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE")),
              "STRING", rng.random(n) > 0.2),
        "q": (rng.integers(1, 51, n).astype(np.int32), "INT",
              rng.random(n) > 0.1),
    }


def _same(jcol, tcol):
    if isinstance(tcol, tenc.DictionaryColumn):
        np.testing.assert_array_equal(tcol.codes.numpy(),
                                      np.asarray(jcol.codes))
    else:
        np.testing.assert_array_equal(tcol.data.numpy(),
                                      np.asarray(jcol.data))
    np.testing.assert_array_equal(tcol.validity.numpy(),
                                  np.asarray(jcol.validity))


def test_dictionary_column_matches_jax_and_round_trips():
    jb, tb = both_batch(_sample(300), 300)
    for j, t in zip(jb.columns[:2], tb.columns[:2]):
        assert t.capacity == j.capacity == 512
        assert t.dict_capacity == j.dict_capacity == 128
        assert t.to_pylist(300) == j.to_pylist(300)
        assert t.dict_view().to_pylist(4) == j.dict_view().to_pylist(4)
        assert (t.codes.numpy()[300:] == tenc.NULL_CODE).all()
        grown = t.with_capacity(1024)
        assert grown.capacity == 1024 and grown.to_pylist(300) == \
            t.to_pylist(300)
        assert (grown.codes.numpy()[512:] == tenc.NULL_CODE).all()
        with pytest.raises(ValueError):
            t.with_capacity(256)
    # invalid rows carry NULL_CODE
    t = tb.columns[0]
    assert (t.codes.numpy()[~t.validity.numpy()] == tenc.NULL_CODE).all()
    assert tb.to_pylist() == [tuple(r) for r in jb.to_pylist()]


@pytest.mark.parametrize("values", [
    ["AIR", None, "", "grüße", "REG AIR"], [], [None, None], ["x" * 300]])
def test_string_column_matches_jax(values):
    t = TString.from_pylist(values, device="cpu")
    j = JString.from_pylist(values)
    np.testing.assert_array_equal(t.offsets.numpy(), np.asarray(j.offsets))
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    np.testing.assert_array_equal(t.validity.numpy(), np.asarray(j.validity))
    assert t.to_pylist(len(values)) == j.to_pylist(len(values)) == values
    g = t.with_capacity(2 * t.capacity)
    assert g.to_pylist(len(values)) == values
    assert (g.offsets.numpy()[t.capacity:] == t.offsets.numpy()[-1]).all()


@pytest.mark.parametrize("literal", ["AIR", "AIR REG", "REG AIR", "", None,
                                     "FOB", "AIRX"])
def test_encoded_equal_literal_matches_jax(literal):
    jb, tb = both_batch(_sample(), 1000)
    before = tenc.counters()["code_space_predicates"]
    got = tenc.encoded_equal_literal(tb.columns[0], literal)
    want = jenc.encoded_equal_literal(jb.columns[0], literal)
    _same(want, got)
    assert tenc.counters()["code_space_predicates"] == before + 1
    if literal == "AIR REG":          # absent from the dictionary
        assert not got.data.any()
    if literal is None:               # null literal: null everywhere
        assert not got.validity.any()


def _exprs(p):
    col, lit, pr = p["core"].col, p["core"].lit, p["pred"]
    return [
        pr.In(col("m"), ["AIR", "AIR REG"]),
        pr.In(col("m"), ["SHIP", None]),
        pr.In(col("m"), [None]),
        pr.Or(pr.EqualTo(col("m"), lit("AIR")),
              pr.EqualTo(lit("NONE"), col("s"))),
        pr.Not(pr.In(col("s"), ["DELIVER IN PERSON", "COLLECT COD"])),
        pr.And(pr.Not(pr.EqualTo(col("m"), lit(""))),
               pr.GreaterThanOrEqual(col("q"), lit(20))),
        pr.And(pr.IsNull(col("m")), pr.IsNotNull(col("s"))),
    ]


JP = {"core": jcore, "pred": jpred, "arith": jarith}
TP = {"core": tcore, "pred": tpred, "arith": tarith}


@pytest.mark.parametrize("i", range(7))
def test_code_space_predicates_match_jax(i):
    jb, tb = both_batch(_sample(seed=i), 1000)
    dict_gather.dict_gather.launches = 0
    want = jcore.resolve(_exprs(JP)[i], jb.schema).columnar_eval(jb)
    got = tcore.resolve(_exprs(TP)[i], tb.schema).columnar_eval(tb)
    _same(want, got)
    assert dict_gather.dict_gather.launches == 0   # CPU: the plain version


def _walk_cases(p):
    col, lit, pr, ar = p["core"].col, p["core"].lit, p["pred"], p["arith"]
    return [
        pr.EqualTo(col("m"), lit("AIR")),
        pr.EqualTo(lit("AIR"), col("m")),
        pr.In(col("m"), ["AIR"]),
        pr.LessThan(col("m"), lit("AIR")),
        pr.EqualTo(col("m"), col("s")),
        pr.Not(pr.Or(pr.IsNull(col("m")), pr.In(col("s"), ["NONE"]))),
        pr.And(pr.EqualTo(col("m"), lit("AIR")),
               pr.GreaterThan(ar.Add(col("q"), lit(1)), lit(3))),
        pr.Or(pr.LessThan(col("q"), lit(3)), pr.LessThan(col("s"), lit("B"))),
        ar.Add(col("q"), lit(1)),
        col("m"),
        col("m").alias("mm"),
        pr.In(col("q"), [1, 2]),
    ]


def test_encoded_safe_walks_match_jax():
    jb, tb = both_batch(_sample(10), 10)
    want = [(jpred.encoded_safe_predicate(jcore.resolve(e, jb.schema)),
             jpred.encoded_safe_projection(jcore.resolve(e, jb.schema)))
            for e in _walk_cases(JP)]
    got = [(tpred.encoded_safe_predicate(tcore.resolve(e, tb.schema)),
            tpred.encoded_safe_projection(tcore.resolve(e, tb.schema)))
           for e in _walk_cases(TP)]
    assert got == want
    assert [w[0] for w in got] == [True, True, True, False, False, True,
                                   True, False, True, False, False, True]
    assert [w[1] for w in got][9:11] == [True, True]   # pass-throughs
    # an unresolved name may be a string: the walk says no
    assert not tpred.encoded_safe_predicate(
        tpred.LessThan(tcore.col("q"), tcore.lit(3)))


@pytest.mark.parametrize("make", [
    lambda p: p["pred"].LessThan(p["core"].col("m"), p["core"].lit("AIR")),
    lambda p: p["pred"].EqualTo(p["core"].col("m"), p["core"].col("s")),
    lambda p: p["pred"].GreaterThanOrEqual(p["core"].lit("A"),
                                           p["core"].col("s")),
])
def test_non_code_space_comparison_raises_type_error(make):
    jb, tb = both_batch(_sample(50), 50)
    with pytest.raises(TypeError, match="dictionary-encoded"):
        jcore.resolve(make(JP), jb.schema).columnar_eval(jb)
    with pytest.raises(TypeError, match="dictionary-encoded"):
        tcore.resolve(make(TP), tb.schema).columnar_eval(tb)


def test_gather_sanitize_and_compact_match_jax():
    jb, tb = both_batch(_sample(700, seed=5), 700)
    rng = np.random.default_rng(9)
    idx = rng.integers(-2, 1100, 900).astype(np.int32)
    for j, t in zip(jb.columns, tb.columns):
        _same(jops.gather_column(j, jnp.asarray(idx)),
              tops.gather_column(t, torch.from_numpy(idx)))
        _same(jops.sanitize(j, 650), tops.sanitize(t, 650))
    keep = rng.random(1024) > 0.4
    jcols, jn = jops.compact_columns(jb.columns, jnp.asarray(keep), 700)
    tcols, tn = tops.compact_columns(tb.columns, torch.from_numpy(keep), 700)
    assert int(tn) == int(jn)
    for j, t in zip(jcols, tcols):
        _same(j, t)
    assert isinstance(tcols[0], tenc.DictionaryColumn)
    assert tcols[0].dict_data is tb.columns[0].dict_data


def test_scan_counts_encoded_columns():
    before = tenc.counters()["cols_encoded"]
    both_batch(_sample(20), 20)
    assert tenc.counters()["cols_encoded"] == before + 2


def test_filter_keeps_columns_encoded_and_collect_decodes():
    jb, tb = both_batch(_sample(1000, seed=3), 1000)

    def plan(b, p, basic):
        pr, col = p["pred"], p["core"].col
        return basic.FilterExec(
            pr.And(pr.In(col("m"), ["AIR", "RAIL"]),
                   pr.Not(pr.EqualTo(col("s"), p["core"].lit("NONE")))),
            basic.InMemoryScanExec([b], b.schema))

    tplan = plan(tb, TP, tbasic)
    out = list(tplan.collect())
    assert out == [tuple(r) for r in plan(jb, JP, jbasic).collect()]
    assert len(out) > 100
    # under a consumer that cannot take encoded columns both packages
    # decode at the filter's output boundary: the sort sees strings and
    # emits them in the same order (nulls first, ties by input order)
    def sort(b, p, basic, sortexec):
        return sortexec.SortExec([(p["core"].col("q"), True, None)],
                                 plan(b, p, basic))

    tsorted = list(sort(tb, TP, tbasic, tsortexec).execute())
    assert all(isinstance(c, TString) for c in tsorted[0].columns[:2])
    assert [r for b in tsorted for r in b.to_pylist()] == \
        [tuple(r) for b in sort(jb, JP, jbasic, jsortexec).execute()
         for r in b.to_pylist()]
    # a pass-through projection takes the filter's encoded output, and
    # so does collect(), which decodes on the host; execute() at the root
    # decodes at the boundary instead of handing encoded columns to an
    # unknown consumer
    proj = tbasic.ProjectExec([tcore.col("m")], tplan)
    assert proj.collect() == [(r[0],) for r in out]
    assert tplan._encoded_ok_for_parent
    root = list(tbasic.ProjectExec([tcore.col("m")], tplan).execute())
    assert isinstance(root[0].columns[0], TString)
    assert [r for b in root for r in b.to_pylist()] == [(r[0],) for r in out]
