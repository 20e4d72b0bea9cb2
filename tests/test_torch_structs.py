"""StructColumn and MapColumn through every seam of the port
(columnar/column.py, ops/basic.py, ops/gather.py, exec/coalesce.py,
columnar/transfer.py and upload.py, shuffle/serializer.py, exec/joins.py,
the arrow seams) against the JAX package on the CPU.

The port's Decimal128Column is a sibling of StructColumn (the JAX
package's subclasses it): its frames stay byte for byte the reference's,
checked here beside the struct's. A struct's fixed-width fields ride the
packed row gather beside its validity; a join that repeats build rows
measures the struct's string field (the JAX package does not, ROADMAP
C.5: the port is held to a Python oracle there). Everything is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar import column as jcol
from spark_rapids_tpu.exec import coalesce as jcoal
from spark_rapids_tpu.ops import basic as jops
from spark_rapids_tpu.shuffle import serializer as jser

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar import transfer, upload
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.columnar.batch import empty_batch
from spark_rapids_tpu_torch.columnar.column import (
    ArrayColumn, Decimal128Column, MapColumn, StringColumn, StructColumn,
    column_from_arrow, column_to_arrow)
from spark_rapids_tpu_torch.exec import basic as tb
from spark_rapids_tpu_torch.exec import coalesce as tcoal
from spark_rapids_tpu_torch.exec import joins as tjoins
from spark_rapids_tpu_torch.expr import core as tc
from spark_rapids_tpu_torch.ops import basic as tops
from spark_rapids_tpu_torch.ops import gather as tgather
from spark_rapids_tpu_torch.shuffle import serializer as tser

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


ST = tt.StructType((tt.StructField("s", tt.STRING),
                    tt.StructField("n", tt.INT),
                    tt.StructField("x", tt.DOUBLE)))
MT = tt.MapType(tt.STRING, tt.LONG)
DEC = tt.DecimalType(25, 4)
STRUCTS = [{"s": "ab", "n": 1, "x": 0.5}, None, {"s": None, "n": 3, "x": -1.0},
           {"s": "", "n": None, "x": 2.25}, {"s": "héllo", "n": -7, "x": 0.0},
           {"s": "z", "n": 9, "x": None}]
MAPS = [{"a": 1, "b": 2}, {}, None, [("k", 5), ("k", 6)], {"x": None},
        {"p": -1, "q": 2 ** 40}]
DECS = [12345678901234567890123, None, -5, 0, 10 ** 24, -(10 ** 20)]


def _jax_type(dt):
    if isinstance(dt, tt.StructType):
        return jt.StructType(tuple(jt.StructField(f.name,
                                                  _jax_type(f.data_type))
                                   for f in dt.fields))
    if isinstance(dt, tt.MapType):
        return jt.MapType(_jax_type(dt.key_type), _jax_type(dt.value_type))
    if isinstance(dt, tt.ArrayType):
        return jt.ArrayType(_jax_type(dt.element_type))
    if isinstance(dt, tt.DecimalType):
        return jt.DecimalType(dt.precision, dt.scale)
    return {"StringType": jt.STRING, "LongType": jt.LONG,
            "IntegerType": jt.INT, "DoubleType": jt.DOUBLE,
            "BooleanType": jt.BOOLEAN}[type(dt).__name__]


def jax_column(c):
    """The JAX package's column of the same buffers as the port's `c`."""
    v = jnp.asarray(c.validity.numpy())
    dt = _jax_type(c.dtype)
    if isinstance(c, Decimal128Column):
        return jcol.Decimal128Column((jax_column(c.hi), jax_column(c.lo)), v,
                                     dt)
    if isinstance(c, StructColumn):
        return jcol.StructColumn(tuple(jax_column(k) for k in c.children), v,
                                 dt)
    if isinstance(c, MapColumn):
        return jcol.MapColumn(jax_column(c.keys), jax_column(c.values),
                              jnp.asarray(c.offsets.numpy()), v, dt)
    if isinstance(c, ArrayColumn):
        return jcol.ArrayColumn(jax_column(c.child),
                                jnp.asarray(c.offsets.numpy()), v, dt)
    if isinstance(c, StringColumn):
        return jcol.StringColumn(jnp.asarray(c.data.numpy()),
                                 jnp.asarray(c.offsets.numpy()), v, dt)
    return jcol.Column(jnp.asarray(c.data.numpy()), v, dt)


def both(data, types, capacity=None):
    """(JAX batch, port batch) of Python lists by column name."""
    schema = tt.Schema(tuple(tt.StructField(k, types[k]) for k in data))
    tbatch = TBatch.from_pydict(data, schema, capacity, device="cpu")
    jschema = jt.Schema(tuple(jt.StructField(f.name, _jax_type(f.data_type))
                              for f in schema.fields))
    return JBatch([jax_column(c) for c in tbatch.columns],
                  tbatch.num_rows_host, jschema), tbatch


def _batch():
    return both({"k": [1, 2, 3, 4, 5, 6], "st": STRUCTS, "mp": MAPS,
                 "d": DECS}, {"k": tt.LONG, "st": ST, "mp": MT, "d": DEC})


def _first_wins(rows):
    out = []
    for v in rows:
        if v is None or isinstance(v, dict):
            out.append(v)
            continue
        d = {}
        for k, x in v:
            d.setdefault(k, x)
        out.append(d)
    return out


def test_struct_and_map_columns_round_trip():
    st = StructColumn.from_pylist(STRUCTS, ST, device="cpu")
    assert st.to_pylist(6) == STRUCTS and st.capacity == 128
    assert StructColumn.from_leaves(ST, st.leaves()).to_pylist(6) == STRUCTS
    assert st.with_capacity(256).to_pylist(6) == STRUCTS
    mp = MapColumn.from_pylist(MAPS, MT, device="cpu")
    assert mp.to_pylist(6) == _first_wins(MAPS)
    assert MapColumn.from_leaves(MT, mp.leaves()).to_pylist(6) == \
        _first_wins(MAPS)
    assert mp.with_capacity(512).to_pylist(6) == _first_wins(MAPS)
    # the port's decimal128 is a sibling of the struct, not a subclass
    assert not issubclass(Decimal128Column, StructColumn)
    nested = tt.StructType((tt.StructField("m", MT),
                            tt.StructField("st", ST)))
    rows = [{"m": {"a": 1}, "st": STRUCTS[0]}, None,
            {"m": None, "st": None}]
    col = StructColumn.from_pylist(rows, nested, device="cpu")
    assert StructColumn.from_leaves(nested, col.leaves()).to_pylist(3) \
        == rows


@pytest.mark.parametrize("name", ["st", "mp"])
def test_gather_concat_slice_sanitize_match_jax(name):
    jbatch, tbatch = _batch()
    jc, tcl = jbatch.column(name), tbatch.column(name)
    idx = np.array([5, 0, 0, 3, -1, 2, 9, 1], np.int32)
    tg = tops.gather_column(tcl, torch.from_numpy(idx))
    jg = jops.gather_column(jc, jnp.asarray(idx))
    assert tg.to_pylist(8) == jg.to_pylist(8)
    assert tops.slice_rows(tcl, 2, 3, 128).to_pylist(3) == \
        jops.slice_rows(jc, jnp.int32(2), jnp.int32(3), 128).to_pylist(3)
    assert tops.sanitize(tcl, 3).to_pylist(6) == \
        jops.sanitize(jc, 3).to_pylist(6)
    tcat = tops.concat_columns(tcl, tg, 6, 5, 16)
    values = STRUCTS if name == "st" else _first_wins(MAPS)
    assert tcat.to_pylist(11) == values + tg.to_pylist(5)
    if name == "st":  # the JAX package concatenates no map column
        assert tcat.to_pylist(11) == \
            jops.concat_columns(jc, jg, 6, 5, 16).to_pylist(11)


def test_struct_fields_ride_the_packed_row_gather():
    """The struct's fixed-width fields and its validity join the other
    fixed-width columns in one packed row gather; its string field takes
    the per-column path."""
    _, tbatch = _batch()
    before = tgather.counters()
    idx = torch.tensor([3, 3, 0, -1, 4], dtype=torch.int32)
    out = tgather.gather_batch_columns(tbatch.columns, idx)
    after = tgather.counters()
    assert after["packed_count"] - before["packed_count"] == 1
    want = tbatch.to_pylist()
    for j, c in enumerate(out):
        assert c.to_pylist(5) == [want[i][j] if i >= 0 else None
                                  for i in idx.tolist()]


def test_coalesce_transfers_and_empty_batch_carry_structs_and_maps():
    """The JAX package's concat has no map branch (it fails there, ROADMAP
    C.5): its batches are compared without the map, the map to Python."""
    jbatch, tbatch = _batch()
    keep = [0, 1, 3]
    jnomap = JBatch([jbatch.columns[i] for i in keep], 6, jt.Schema(tuple(
        jbatch.schema.fields[i] for i in keep)))
    jout = jcoal.concat_batches([jnomap, jnomap], jnomap.schema)
    tout = tcoal.concat_batches([tbatch, tbatch], tbatch.schema)
    rows = tout.to_pylist()
    assert [r[:2] + r[3:] for r in rows] == jout.to_pylist()
    assert [r[2] for r in rows] == _first_wins(MAPS) * 2
    cols, n = transfer.fetch_batch_host(tout)
    assert n == 12 and cols[1].to_pylist(12) == STRUCTS * 2
    up = upload.packed_upload_batch(cols, n, tout.schema, "cpu")
    assert up.to_pylist() == rows
    back = TBatch.unflatten(*reversed(tout.flatten()))
    assert back.to_pylist() == rows
    e = empty_batch(tbatch.schema, device="cpu")
    assert e.num_rows_host == 0 and e.to_pylist() == []
    assert isinstance(e.columns[1], StructColumn) \
        and isinstance(e.columns[2], MapColumn)


def test_shuffle_frames_are_byte_identical():
    """Struct, map and decimal128 frames, whole and sliced, equal the JAX
    package's byte for byte; deserialize, host gathers and slices round
    trip."""
    jbatch, tbatch = _batch()
    for codec in (tser.CODEC_COPY, tser.CODEC_LZ4):
        assert tser.serialize_batch(tbatch, codec) == \
            jser.serialize_batch(jbatch, codec)
        assert tser.serialize_slice(tbatch, 1, 5, codec) == \
            jser.serialize_slice(jbatch, 1, 5, codec)
    frame = tser.serialize_batch(tbatch)
    back = tser.deserialize_batch(frame, tbatch.schema)
    assert back.to_pylist() == tbatch.to_pylist()
    idx = np.array([4, 0, 3, 3, 5], np.int64)
    g = tser.host_gather_batch(tbatch, idx)
    assert g.to_pylist() == [tbatch.to_pylist()[i] for i in idx]
    assert tser.serialize_batch(g) == jser.serialize_batch(
        jser.host_gather_batch(jbatch, idx))
    sl = tser.host_slice_batch(tbatch, 2, 5)
    assert tser.serialize_batch(sl) == jser.serialize_batch(
        jser.host_slice_batch(jbatch, 2, 5))
    # decimal128 alone, as its frames were before structs landed
    jd, td = both({"d": DECS}, {"d": DEC})
    assert tser.serialize_batch(td) == jser.serialize_batch(jd)


def test_arrow_struct_and_map_arrays():
    pa = pytest.importorskip("pyarrow")
    arr = pa.array(STRUCTS, type=tt.to_arrow(ST))
    col = column_from_arrow(arr, device="cpu")
    assert isinstance(col, StructColumn) and col.to_pylist(6) == STRUCTS
    assert column_to_arrow(col, 6).to_pylist() == STRUCTS
    marr = pa.array(MAPS, type=tt.to_arrow(MT))
    mcol = column_from_arrow(marr, device="cpu")
    assert isinstance(mcol, MapColumn)
    assert mcol.to_pylist(6) == _first_wins(MAPS)
    assert [None if v is None else dict(v) for v in
            column_to_arrow(mcol, 6).to_pylist()] == _first_wins(MAPS)
    assert tt.from_arrow(arr.type) == ST and tt.from_arrow(marr.type) == MT


def test_join_repeats_a_struct_payload_with_its_strings():
    """An inner join whose build rows match several stream rows repeats
    their structs whole: the string field's bytes are measured. The JAX
    package cuts the repeated strings short here (ROADMAP C.5), so the
    port is held to Python."""
    long = "a" * 150
    lrows = [1, 2, 1, 3, 1, 2]
    build = {1: {"s": long, "n": 5, "x": 1.5}, 2: None,
             4: {"s": "z", "n": 7, "x": 0.0}}
    _, tl = both({"k": lrows}, {"k": tt.LONG})
    _, tr = both({"rk": list(build), "c": list(build.values())},
                 {"rk": tt.LONG, "c": ST})
    j = tjoins.HashJoinExec(tb.InMemoryScanExec([tl], tl.schema),
                            tb.InMemoryScanExec([tr], tr.schema),
                            [tc.col("k")], [tc.col("rk")], "inner",
                            build_side="right")
    rows = sorted((r for x in j.execute() for r in x.to_pylist()), key=repr)
    want = sorted(((k, k, build[k]) for k in lrows if k in build), key=repr)
    assert rows == want
