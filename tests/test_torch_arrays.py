"""ArrayColumn and the collection expressions (columnar/column.py,
ops/collection.py, expr/collectionexprs.py, ops/string_split.py) against
the JAX package on the CPU.

ArrayColumn goes through every seam at which the JAX package carries one:
sanitize, the row gather, the concat, slice_rows, exec/coalesce.
concat_batches, the packed device<->host transfer and upload, the
shuffle's frames (byte for byte the JAX package's, fixed-width and string
elements, whole batches and row slices), host gathers and slices,
empty_batch, the arrow seams and a join's duplicating payload gather.
Each collection expression is held to the JAX package in one projection,
and the planner tags off what the JAX package runs on its host tier.
Everything here is integer, boolean or an exact f64 pick: no tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import ArrayColumn as JArray
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.columnar.column import StringColumn as JString
from spark_rapids_tpu.exec import basic as jb
from spark_rapids_tpu.exec import coalesce as jcoal
from spark_rapids_tpu.exec import joins as jjoins
from spark_rapids_tpu.expr import collectionexprs as jce
from spark_rapids_tpu.expr import core as jc
from spark_rapids_tpu.expr import stringexprs as jse
from spark_rapids_tpu.ops import basic as jops
from spark_rapids_tpu.plan.overrides import TpuOverrides as JOverrides
from spark_rapids_tpu.shuffle import serializer as jser

from spark_rapids_tpu_torch import functions as tF
from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.columnar import transfer, upload
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.columnar.batch import empty_batch
from spark_rapids_tpu_torch.columnar.column import (
    ArrayColumn, StringColumn, column_from_arrow, column_to_arrow)
from spark_rapids_tpu_torch.exec import basic as tb
from spark_rapids_tpu_torch.exec import coalesce as tcoal
from spark_rapids_tpu_torch.exec import joins as tjoins
from spark_rapids_tpu_torch.expr import collectionexprs as tce
from spark_rapids_tpu_torch.expr import core as tc
from spark_rapids_tpu_torch.expr import stringexprs as tse
from spark_rapids_tpu_torch.ops import basic as tops
from spark_rapids_tpu_torch.plan import overrides as tover
from spark_rapids_tpu_torch.shuffle import serializer as tser

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


INTS = [[3, 1, None, 2], [], None, [5, 5, 4], [7], [-1, 0]]
STRS = [["a", "bb"], None, [], ["ccc", None, ""], ["dd"], ["e", "f"]]
NESTED = [[[1, 2], [3]], [[4], None], None, [[]], [[5, 6, 7]], [[8], [9]]]


def _jax_type(dt):
    if isinstance(dt, tt.ArrayType):
        return jt.ArrayType(_jax_type(dt.element_type))
    return {"StringType": jt.STRING, "LongType": jt.LONG,
            "IntegerType": jt.INT, "DoubleType": jt.DOUBLE,
            "BooleanType": jt.BOOLEAN}[type(dt).__name__]


def jax_column(c):
    """The JAX package's column of the same buffers as the port's `c`."""
    v = jnp.asarray(c.validity.numpy())
    if isinstance(c, ArrayColumn):
        return JArray(jax_column(c.child), jnp.asarray(c.offsets.numpy()), v,
                      _jax_type(c.dtype))
    if isinstance(c, StringColumn):
        return JString(jnp.asarray(c.data.numpy()),
                       jnp.asarray(c.offsets.numpy()), v, jt.STRING)
    return JColumn(jnp.asarray(c.data.numpy()), v, _jax_type(c.dtype))


def both(data, types, capacity=None):
    """(JAX batch, port batch) of Python lists by column name."""
    schema = tt.Schema(tuple(tt.StructField(k, types[k]) for k in data))
    tbatch = TBatch.from_pydict(data, schema, capacity, device="cpu")
    jschema = jt.Schema(tuple(jt.StructField(f.name, _jax_type(f.data_type))
                              for f in schema.fields))
    return JBatch([jax_column(c) for c in tbatch.columns],
                  tbatch.num_rows_host, jschema), tbatch


AI, AS = tt.ArrayType(tt.LONG), tt.ArrayType(tt.STRING)


def _batch():
    return both({"k": [1, 2, 3, 4, 5, 6], "a": INTS, "s": STRS},
                {"k": tt.LONG, "a": AI, "s": AS})


def test_array_column_round_trips():
    col = ArrayColumn.from_pylist(INTS, AI, device="cpu")
    assert col.to_pylist(6) == INTS
    assert col.capacity == 128
    again = ArrayColumn.from_leaves(col.dtype, col.leaves())
    assert again.to_pylist(6) == INTS
    assert col.with_capacity(256).to_pylist(6) == INTS
    nested = ArrayColumn.from_pylist(NESTED, tt.ArrayType(AI), device="cpu")
    assert nested.to_pylist(6) == NESTED
    assert ArrayColumn.from_pylist(STRS, AS, device="cpu").to_pylist(6) \
        == STRS


@pytest.mark.parametrize("name", ["a", "s"])
def test_gather_concat_slice_sanitize_match_jax(name):
    """Fixed-width elements against the JAX package, string elements
    against Python (their frames are held byte for byte below)."""
    jbatch, tbatch = _batch()
    jcol, tcol = jbatch.column(name), tbatch.column(name)
    idx = np.array([5, 0, 0, 3, -1, 2, 9, 1], np.int32)
    tg = tops.gather_column(tcol, torch.from_numpy(idx))
    values = INTS if name == "a" else STRS
    picked = [values[i] if 0 <= i < 6 else None for i in idx]
    assert tg.to_pylist(8) == picked
    if name == "s":
        assert tops.concat_columns(tcol, tg, 6, 5, 16).to_pylist(11) == \
            values + picked[:5]
        assert tops.slice_rows(tcol, 2, 3, 128).to_pylist(3) == values[2:5]
        assert tops.sanitize(tcol, 3).to_pylist(6) == values[:3] + [None] * 3
        return
    jg = jops.gather_column(jcol, jnp.asarray(idx))
    assert tg.to_pylist(8) == jg.to_pylist(8)
    assert np.array_equal(tg.offsets.numpy(), np.asarray(jg.offsets))
    jcat = jops.concat_columns(jcol, jg, 6, 5, 16)
    tcat = tops.concat_columns(tcol, tg, 6, 5, 16)
    assert tcat.to_pylist(11) == jcat.to_pylist(11)
    assert np.array_equal(tcat.offsets.numpy(), np.asarray(jcat.offsets))
    assert tops.slice_rows(tcol, 2, 3, 128).to_pylist(3) == \
        jops.slice_rows(jcol, jnp.int32(2), jnp.int32(3), 128).to_pylist(3)
    assert tops.sanitize(tcol, 3).to_pylist(6) == \
        jops.sanitize(jcol, 3).to_pylist(6)


def test_coalesce_and_transfers_carry_arrays():
    jbatch, tbatch = _batch()
    jout = jcoal.concat_batches([jbatch, jbatch], jbatch.schema)
    tout = tcoal.concat_batches([tbatch, tbatch], tbatch.schema)
    assert tout.to_pylist() == jout.to_pylist()
    cols, n = transfer.fetch_batch_host(tout)
    assert n == 12 and cols[1].to_pylist(12) == INTS * 2
    up = upload.packed_upload_batch(cols, n, tout.schema, "cpu")
    assert up.to_pylist() == tout.to_pylist()
    assert up.columns[2].to_pylist(12) == STRS * 2
    e = empty_batch(tbatch.schema, device="cpu")
    assert e.num_rows_host == 0 and e.columns[1].child.capacity == 128
    assert e.to_pylist() == []


def test_shuffle_frames_are_byte_identical():
    jbatch, tbatch = _batch()
    for codec in (tser.CODEC_COPY, tser.CODEC_LZ4):
        assert tser.serialize_batch(tbatch, codec) == \
            jser.serialize_batch(jbatch, codec)
        assert tser.serialize_slice(tbatch, 1, 5, codec) == \
            jser.serialize_slice(jbatch, 1, 5, codec)
    frame = tser.serialize_batch(tbatch)
    back = tser.deserialize_batch(frame, tbatch.schema)
    assert back.to_pylist() == tbatch.to_pylist()
    idx = np.array([4, 0, 3, 3], np.int64)
    g = tser.host_gather_batch(tbatch, idx)
    assert g.to_pylist() == [tbatch.to_pylist()[i] for i in idx]
    sl = tser.host_slice_batch(tbatch, 2, 5)
    assert tser.serialize_batch(sl) == tser.serialize_batch(
        tser.host_gather_batch(tbatch, np.arange(2, 5)))
    assert tser.serialize_batch(sl) == jser.serialize_batch(
        jser.host_slice_batch(jbatch, 2, 5))


def test_arrow_list_arrays():
    pa = pytest.importorskip("pyarrow")
    arr = pa.array(INTS, type=pa.list_(pa.int64()))
    col = column_from_arrow(arr, device="cpu")
    assert isinstance(col, ArrayColumn) and col.to_pylist(6) == INTS
    assert column_to_arrow(col, 6).to_pylist() == INTS
    sarr = pa.array(STRS, type=pa.list_(pa.string()))
    assert column_from_arrow(sarr, device="cpu").to_pylist(6) == STRS


def test_join_duplicates_array_payloads_like_jax():
    """An inner join whose build rows match several stream rows repeats
    their list payloads (the measured element bucket)."""
    jl, tl = both({"k": [1, 2, 1, 3, 1, 2]}, {"k": tt.LONG})
    jr, tr = both({"rk": [1, 2, 4], "a": [[1, 2, 3], None, [9]]},
                  {"rk": tt.LONG, "a": AI})
    rows = []
    for ex, b, l, r, c in ((jjoins, jb, jl, jr, jc), (tjoins, tb, tl, tr,
                                                      tc)):
        j = ex.HashJoinExec(b.InMemoryScanExec([l], l.schema),
                            b.InMemoryScanExec([r], r.schema),
                            [c.col("k")], [c.col("rk")], "inner",
                            build_side="right")
        rows.append(sorted((r for x in j.execute() for r in x.to_pylist()),
                           key=repr))
    assert rows[1] == rows[0]
    assert len(rows[1]) == 5


def _exprs(ce, se, c):
    a, s = c.col("a"), c.col("s")
    lit = c.lit
    return [
        ce.Size(a).alias("size"), ce.ArrayContains(a, 5).alias("has5"),
        ce.ArrayContains(s, "bb").alias("hasbb"),
        ce.ElementAt(a, 1).alias("first"), ce.ElementAt(a, -1).alias("last"),
        ce.ElementAt(a, c.col("i")).alias("at_i"),
        ce.GetArrayItem(a, 2).alias("item2"),
        ce.ElementAt(s, 2).alias("s2"),
        ce.SortArray(a).alias("asc"), ce.SortArray(a, False).alias("desc"),
        ce.ArrayMin(a).alias("amin"), ce.ArrayMax(a).alias("amax"),
        ce.CreateArray(c.col("k"), c.col("i")).alias("made"),
        ce.ArrayPosition(a, c.col("i")).alias("pos"),
        ce.ArrayRemove(a, c.col("i")).alias("rm"),
        ce.ArrayDistinct(a).alias("dist"),
        ce.Slice(a, lit(2), lit(2)).alias("sl"),
        ce.Slice(a, lit(-2), lit(5)).alias("sl_neg"),
        ce.Flatten(c.col("nest")).alias("flat"),
        ce.ArraysOverlap(a, c.col("b")).alias("ovl"),
        ce.Sequence(lit(1), lit(7), lit(3)).alias("seq"),
        ce.ArrayRepeat(c.col("i"), lit(3)).alias("rep"),
        se.StringSplit(c.col("str"), ",").alias("split"),
        se.StringSplit(c.col("str"), ",", 2).alias("split2"),
        se.StringSplit(c.col("str"), ",", 0).alias("split0")]


def test_collection_expressions_match_jax():
    data = {"k": [1, 2, 3, 4, 5, 6], "i": [2, 5, None, 4, -1, 0],
            "a": INTS, "s": STRS, "nest": NESTED,
            "b": [[2, 9], [1], [], None, [7, None], [8]],
            "str": ["a,b,,", None, "", ",x", "one", "p,q,r"]}
    types = {"k": tt.LONG, "i": tt.LONG, "a": AI, "s": AS,
             "nest": tt.ArrayType(AI), "b": AI, "str": tt.STRING}
    jbatch, tbatch = both(data, types)
    jp = jb.ProjectExec(_exprs(jce, jse, jc),
                        jb.InMemoryScanExec([jbatch], jbatch.schema))
    tp = tb.ProjectExec(_exprs(tce, tse, tc),
                        tb.InMemoryScanExec([tbatch], tbatch.schema))
    jrows = [r for x in jp.execute() for r in x.to_pylist()]
    trows = [r for x in tp.execute() for r in x.to_pylist()]
    assert trows == jrows
    assert trows[0][list(tp.output_schema.names).index("split0")] == \
        ["a", "b"]


def _tagged_off(df):
    meta = tover.TpuOverrides(df.session.conf).wrap_and_tag(df.logical_plan())
    return not tover.TpuOverrides._all_ok(meta), meta.explain()


def test_planner_tags_off_the_host_tier_shapes():
    """What the JAX package runs on its host row engine runs there in the
    port too (`~`, the device tag-off's reason kept, the JAX package's
    rows): array_join, array_position over strings, a regex split, a
    sequence with a column bound, sort_array over strings. What it tags
    off is tagged off: collect_set over strings and a join payload of
    array<string>."""
    sess = tsession.TpuSession(device="cpu")
    jsess = jsession.TpuSession()
    data = {"k": [1, 2], "s": [["x", "y"], None], "str": ["a b", "c"]}
    df = sess.from_pydict(data, tt.Schema((
        tt.StructField("k", tt.LONG), tt.StructField("s", AS),
        tt.StructField("str", tt.STRING))))
    jdf = jsess.from_pydict(data, jt.Schema((
        jt.StructField("k", jt.LONG), jt.StructField("s", jt.ArrayType(
            jt.STRING)), jt.StructField("str", jt.STRING))))
    # (query, the port's reason, whether the JAX package plans it: a
    # projection onto its host row engine, the others tagged off)
    cases = [
        (lambda F, d: d.select(F.array_join("s", ",")), "host-tier", True),
        (lambda F, d: d.select(F.array_position("s", F.lit("x"))),
         "host-tier", True),
        (lambda F, d: d.select(F.split("str", "[ ]")), "host-tier", True),
        (lambda F, d: d.select(F.sequence("k", 5)), "host-tier", True),
        (lambda F, d: d.select(F.sort_array("s")), "fixed-width", True),
        (lambda F, d: d.group_by("k").agg((F.collect_set("str"), "c")),
         "collect_set", False),
        (lambda F, d: d.join(d.select(d.columns[0]).with_column(
            "k2", F.col("k")), left_on="k", right_on="k2"), "payload",
         False)]
    for make, why, jax_plans in cases:
        off, text = _tagged_off(make(tF, df))
        assert why in text, text
        assert off != jax_plans and text.startswith("~ ") == jax_plans
        jax_ok = JOverrides._all_ok(JOverrides(jsess.conf).wrap_and_tag(
            make(jF, jdf).logical_plan()))
        assert jax_ok == jax_plans, why
        if jax_plans:
            assert make(tF, df).collect() == make(jF, jdf).collect()
    ok, _ = _tagged_off(df.select(tF.split("str", " "), tF.size("s")))
    assert not ok
