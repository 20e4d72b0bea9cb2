"""The file-backed TPC-H queries chip_smoke.py drives as P45 and P46, in
both packages on the CPU at about scale factor 0.01, and the faults the
pyarrow and pandas paths showed (ROADMAP C.24-C.26):

- each package writes the same numpy-seeded rows with its own writer
  (the port's Q1 lineitem as row-slice files and its Q3 orders as one
  file a span of order dates, each sorted by date; the JAX package's
  tables one file each) and runs TPC-H Q1 (by the string flags), Q3 on
  DECIMAL and DATE, Q19 and Q4 (over ORC) through its own session's
  reader; the rows equal the JAX package's and the numpy oracle's
  (integers, strings and order exact, f64 sums to rtol 1e-9), and the
  port reads the JAX package's files to the same rows;
- the MULTITHREADED and COALESCING readers give the same rows, and the
  row-group counters of a LONG conjunct equal the JAX package's; a DATE
  conjunct prunes row groups in the port only (C.24);
- the arrow seams: a host column becomes the pyarrow array its rows make,
  and a decimal array the columns the JAX package builds;
- a Delta UPDATE of a partition column moves the rows (C.25), and an
  append takes the table's partition columns (C.26), both against a
  Python oracle, the JAX package differing as recorded;
- the readers' and the pandas execs' timing counters.
"""

import datetime
import os
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import jax.numpy as jnp

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.columnar.column import StringColumn as JStringColumn
from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.columnar.column import column_from_arrow as jfrom_arrow
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred
from spark_rapids_tpu.io import parquet as jparquet

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar import column as tcol
from spark_rapids_tpu_torch.columnar import encoded as tenc
from spark_rapids_tpu_torch.delta import log as tlog
from spark_rapids_tpu_torch.delta.table import DeltaTable
from spark_rapids_tpu_torch.exec import python_udf
from spark_rapids_tpu_torch.exec.coalesce import concat_batches
from spark_rapids_tpu_torch.io import parquet as tparquet

import chip_smoke as cs
from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs

RTOL = 1e-9
N_PART, N_LINE, SF = 2000, 60_000, 0.01
JAX = SimpleNamespace(t=jt, core=jcore, pred=jpred, F=jF, session=jsession)
CUTOFF_DAYS = (cs.Q1_SHIP_CUTOFF - datetime.date(1970, 1, 1)).days
COALESCING = {"spark.rapids.sql.format.parquet.reader.type": "COALESCING"}


@pytest.fixture(scope="module", autouse=True)
def _env():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


def _sessions(conf=None):
    return (JAX.session.TpuSession(conf),
            cs.join_session_modules().session.TpuSession(conf, "cpu"))


def _jax_type(dt):
    if isinstance(dt, tt.DecimalType):
        return jt.DecimalType(dt.precision, dt.scale)
    return {"StringType": jt.STRING, "DateType": jt.DATE,
            "LongType": jt.LONG, "IntegerType": jt.INT,
            "DoubleType": jt.DOUBLE}[type(dt).__name__]


def jax_batch(tb):
    """The JAX package's batch of the same rows as the port's `tb`, its
    dictionary columns decoded (the JAX package's writer would decode
    them through a compiled gather)."""
    cols = []
    for c in tenc.materialize_batch(tb).columns:
        v = jnp.asarray(c.validity.numpy())
        if isinstance(c, tcol.StringColumn):
            cols.append(JStringColumn(jnp.asarray(c.data.numpy()),
                                      jnp.asarray(c.offsets.numpy()), v))
        else:
            cols.append(JColumn(jnp.asarray(c.data.numpy()), v,
                                _jax_type(c.dtype)))
    schema = jt.Schema(tuple(jt.StructField(f.name, _jax_type(f.data_type))
                             for f in tb.schema.fields))
    return JBatch(cols, tb.num_rows_host, schema)


def _close_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=RTOL, abs=0)
            else:
                assert a == b


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Both packages' batches of the same rows, and each package's files
    written by its own writer under {root}/jax and {root}/port."""
    d19 = cs.q19_data(N_PART, N_LINE, seed=5)
    dj = cs.tpch_join_data(sf=SF, seed=6)
    q3d = cs.q3_types_data(dj)
    tm, tb, wants = cs.types_inputs("cpu", d19, dj, q3d)
    q3np = cs.q3_types_tables(dj, q3d)
    port = {"q1": [cs.tpch_q1_batch(cs.rows_of(d19, lo, lo + N_LINE // 4),
                                    "cpu")
                   for lo in range(0, N_LINE, N_LINE // 4)],
            "customer": [tb["q3"]["customer"]],
            "lineitem3": [tb["q3"]["lineitem"]]}
    # the orders one file a span of order dates, each sorted by date
    o = q3np["orders"]
    order = np.argsort(o["o_orderdate"], kind="stable")
    edges = np.searchsorted(o["o_orderdate"][order], np.linspace(
        cs.ORDER_DATE_FIRST, cs.ORDER_DATE_LAST + 1, 9).astype(np.int64))
    port["orders"] = [cs.types_batch(tm, {k: v[order[lo:hi]]
                                          for k, v in o.items()}, "cpu")
                      for lo, hi in zip(edges[:-1], edges[1:])]
    l19, p19 = cs.q19_batches(d19, "cpu")
    port["lineitem19"], port["part"] = [l19], [p19]
    # the JAX package writes each table as one file of the same rows
    jax = {k: [jax_batch(concat_batches(
        [tenc.materialize_batch(b) for b in bs], bs[0].schema))]
        for k, bs in port.items()}
    q4 = {k: both_batch(cs.join_table_spec(dj, k),
                        dj["o_orderkey" if k == "orders"
                           else "l_orderkey"].shape[0])[1]
          for k in ("orders", "lineitem")}
    root = tmp_path_factory.mktemp("files")
    for name, batches, sess in (("jax", jax, _sessions()[0]),
                                ("port", port, _sessions()[1])):
        for k, bs in batches.items():
            for i, b in enumerate(bs):
                sess.from_batches([b], b.schema).write_parquet(
                    str(root / name / k / f"part-{i:05d}.parquet"))
        for k, b in q4.items():
            b = jax_batch(b) if name == "jax" else b
            sess.from_batches([b], b.schema).write_orc(
                str(root / name / f"{k}.orc"))
    wants.update(Q1=cs.tpch_q1_oracle(d19), Q19=cs.q19_oracle(d19),
                 Q4=cs.q4_oracle(dj))
    return SimpleNamespace(root=root, wants=wants, dj=dj, port=port)


def _frames(sess, root, names):
    return {k: sess.read_parquet(str(root / name)) for k, name in names}


def _query(m, sess, root, label):
    """The query `label` over the Parquet (ORC for Q4) files under
    `root`, in the package whose modules `m` holds."""
    if label == "Q1":
        cutoff = cs.date_lit(m, cs.Q1_SHIP_CUTOFF)
        return cs.tpch_q1_df(m, sess, None, cutoff=cutoff,
                             frame=sess.read_parquet(str(root / "q1")))
    if label == "Q3":
        return cs.q3_types_df(m, sess, {}, frames=_frames(
            sess, root, (("customer", "customer"), ("orders", "orders"),
                         ("lineitem", "lineitem3"))))
    if label == "Q19":
        return cs.q19_df(m, sess, None, None, frames=_frames(
            sess, root, (("lineitem", "lineitem19"), ("part", "part"))))
    return cs.q4_df(m, sess, {}, frames={
        k: sess.read_orc(str(root / f"{k}.orc"))
        for k in ("orders", "lineitem")})


def _check(label, rows, wants):
    if label == "Q1":
        cs.check_rows(rows, wants["Q1"], label)
    elif label == "Q3":
        assert rows == wants["P19"]
    elif label == "Q19":
        revenue, n = wants["Q19"]
        assert rows[0][0] == pytest.approx(revenue, rel=RTOL, abs=0)
        assert n > 0
    else:
        assert rows == wants["Q4"]


@pytest.mark.parametrize("label", ["Q1", "Q3", "Q19", "Q4"])
def test_file_backed_query_matches_jax_and_the_oracle(tables, label):
    jsess, tsess = _sessions()
    trows = _query(cs.join_session_modules(), tsess,
                   tables.root / "port", label).collect()
    jrows = _query(JAX, jsess, tables.root / "jax", label).collect()
    _check(label, trows, tables.wants)
    _close_rows(trows, jrows)
    # the port reads the files the JAX package wrote to the same rows
    other = _query(cs.join_session_modules(), _sessions()[1],
                   tables.root / "jax", label).collect()
    _close_rows(other, trows)


def test_coalescing_reader_gives_the_multithreaded_rows(tables):
    m = cs.join_session_modules()
    rows = {}
    for conf in (None, COALESCING):
        sess = _sessions(conf)[1]
        df = _query(m, sess, tables.root / "port", "Q1")
        rows[bool(conf)] = df.collect()
        src = df.logical_plan()
        while not hasattr(src, "source"):
            src = src.children[0]
        st = src.source.scan_stats
        assert st["row_groups_read"] == 4 and st["rows"] == N_LINE
        assert st["batches"] == (1 if conf else 4)
    assert rows[True] == rows[False]
    cs.check_rows(rows[True], tables.wants["Q1"], "Q1 coalescing")


def test_row_group_counters_equal_jax_and_date_pruning(tables):
    """A LONG conjunct prunes the same row groups in both packages; a DATE
    conjunct prunes in the port only (C.24: the footer's date statistics
    against the literal's day number), to the same rows."""
    key = tables.port["lineitem3"][0].columns[0].data.numpy()
    n = tables.port["lineitem3"][0].num_rows_host
    path = str(tables.root / "sliced.parquet")
    pq.write_table(pq.read_table(str(tables.root / "port" / "lineitem3")),
                   path, row_group_size=n // 8)
    for filters in ([("l_orderkey", "<", int(key[n // 3]))],
                    [("l_orderkey", ">=", int(key[n - n // 5]))]):
        j = jparquet.ParquetSource(path, filters=filters)
        t = tparquet.ParquetSource(path, filters=filters, device="cpu")
        trows = [r for b in t.batches() for r in b.to_pylist()]
        assert trows == [r for b in j.batches() for r in b.to_pylist()]
        assert (t.row_groups_read, t.row_groups_pruned) == \
            (j.row_groups_read, j.row_groups_pruned)
        assert t.row_groups_pruned >= 4
    orders = str(tables.root / "port" / "orders")
    cutoff = (cs.Q3_DATE - datetime.date(1970, 1, 1)).days
    dates = [b.columns[2].data[: b.num_rows_host].numpy()
             for b in tables.port["orders"]]
    want_pruned = sum(int(d.min() >= cutoff) for d in dates)
    t = tparquet.ParquetSource(orders, filters=[("o_orderdate", "<", cutoff)],
                               device="cpu")
    j = jparquet.ParquetSource(orders, filters=[("o_orderdate", "<", cutoff)])
    # the rows the conjunct keeps are the same; the port decodes fewer
    trows = [r for b in t.batches() for r in b.to_pylist()]
    jrows = [r for b in j.batches() for r in b.to_pylist()]
    assert sorted(r for r in trows if r[2] < cutoff) == \
        sorted(r for r in jrows if r[2] < cutoff)
    assert len(trows) < len(jrows)
    assert (t.row_groups_pruned, j.row_groups_pruned) == (want_pruned, 0)
    assert want_pruned == 4
    # the DataFrame query prunes them through the planner's pushdown
    df = _query(cs.join_session_modules(), _sessions()[1],
                tables.root / "port", "Q3")
    assert df.collect() == tables.wants["P19"]
    srcs = cs.plan_sources(df.logical_plan())
    assert [s.scan_stats["row_groups_pruned"] for s in srcs] == [0, 4, 0]


def _flat_columns(n=700, seed=3):
    """A host column of each flat kind, with nulls, and the arrow array
    its rows make."""
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.2
    out = []
    for dt, values in (
            (tt.BOOLEAN, rng.random(n) > 0.5),
            (tt.BYTE, rng.integers(-128, 128, n).astype(np.int8)),
            (tt.SHORT, rng.integers(-2**15, 2**15, n).astype(np.int16)),
            (tt.INT, rng.integers(-2**31, 2**31, n).astype(np.int32)),
            (tt.LONG, rng.integers(-2**63, 2**63, n, dtype=np.int64)),
            (tt.FLOAT, rng.standard_normal(n).astype(np.float32)),
            (tt.DOUBLE, np.where(rng.random(n) > 0.9, np.nan,
                                 rng.standard_normal(n))),
            (tt.DATE, rng.integers(-20000, 30000, n).astype(np.int32)),
            (tt.TIMESTAMP, rng.integers(-2**50, 2**50, n, dtype=np.int64)),
            (tt.DecimalType(12, 2), rng.integers(-10**11, 10**11, n)),
            (tt.DecimalType(18, 4), rng.integers(-10**17, 10**17, n))):
        out.append(tcol.Column.from_numpy(np.asarray(values), dt,
                                          device="cpu", validity=valid))
    words = ["", "a", "héllo", "SHIP", "x" * 40]
    strs = [words[i] if ok else None
            for i, ok in zip(rng.integers(0, 5, n), valid)]
    out.append(tcol.StringColumn.from_pylist(strs, device="cpu"))
    codes = rng.integers(0, 5, n).astype(np.int32)
    out.append(tenc.dictionary_from_numpy(
        codes, *tcol.string_buffers(words), validity=valid, device="cpu"))
    big = [None if not ok else int(v) * 10**20 + 7
           for v, ok in zip(rng.integers(-10**15, 10**15, n), valid)]
    out.append(tcol.Decimal128Column.from_pylist(
        big, tt.DecimalType(38, 3), device="cpu"))
    return n, out


def test_arrow_seams_build_the_arrays_the_rows_make():
    """column_to_arrow builds each flat column from its buffers: the same
    array pyarrow makes of its rows; a decimal array (both lanes) comes
    back as the columns the JAX package builds of it."""
    n, cols = _flat_columns()
    for c in cols:
        got = tcol.column_to_arrow(c, n)
        want = pa.array(c.to_pylist(n), type=tt.to_arrow(c.dtype)) \
            if not isinstance(c.dtype, tt.DecimalType) else pa.array(
                tcol.to_decimals(c.to_pylist(n), c.dtype),
                type=tt.to_arrow(c.dtype))
        # as text: a NaN equals itself
        assert got.type == want.type and got.null_count == want.null_count
        assert repr(got.to_pylist()) == repr(want.to_pylist()), c
    for c in cols[-5:-3] + cols[-1:]:
        arr = tcol.column_to_arrow(c, n).slice(3)
        t = tcol.column_from_arrow(arr, device="cpu")
        j = jfrom_arrow(arr)
        assert t.to_pylist(n - 3) == c.to_pylist(n)[3:]
        if isinstance(t, tcol.Decimal128Column):
            # the per-row conversion's limbs (the JAX package scales each
            # Decimal in the default 28-digit context and rounds a
            # DECIMAL(38) value's low digits: ROADMAP C.5)
            slow = tcol.Decimal128Column.from_pylist(arr.to_pylist(),
                                                     t.dtype, device="cpu")
            for a, b in ((t.lo, slow.lo), (t.hi, slow.hi)):
                np.testing.assert_array_equal(a.data.numpy(), b.data.numpy())
            np.testing.assert_array_equal(t.validity.numpy(),
                                          slow.validity.numpy())
            continue
        else:
            np.testing.assert_array_equal(t.data.numpy(),
                                          np.asarray(j.data))
        np.testing.assert_array_equal(t.validity.numpy(),
                                      np.asarray(j.validity))


def _orders_frame(sess, rows):
    keys, prio, dates = zip(*rows)
    return sess.from_pydict(
        {"k": list(keys), "p": list(prio), "d": list(dates)},
        tt.Schema((tt.StructField("k", tt.LONG),
                   tt.StructField("p", tt.STRING),
                   tt.StructField("d", tt.DATE))))


#: (key, partition string, DATE as days since the epoch, as it collects)
ROWS = [(i, ("HIGH", "LOW", "MID")[i % 3], 8035 + 40 * i) for i in range(30)]


def test_delta_update_of_a_partition_column_moves_the_rows(tmp_path):
    """C.25: UPDATE and MERGE rewrite the rows into the partition their
    new values name (the JAX package keeps the old partition value, so
    its rows read back unchanged)."""
    sess = _sessions()[1]
    path = str(tmp_path / "t")
    _orders_frame(sess, ROWS).write_delta(path, partition_by=["p"])
    col, lit = cs.join_session_modules().core.col, \
        cs.join_session_modules().core.lit
    dt = DeltaTable.for_path(sess, path)
    assert dt.update({"p": lit("URGENT")}, col("k") < lit(10)) == 10
    want = sorted((k, "URGENT" if k < 10 else p, d) for k, p, d in ROWS)
    assert sorted(sess.read_delta(path).collect()) == want
    snap = tlog.DeltaLog(path).snapshot()
    assert {f.partition_values["p"] for f in snap.files} == {
        "URGENT", "HIGH", "LOW", "MID"}
    src = _orders_frame(sess, [(3, "LOW", 11000), (99, "NEW", 11400)])
    stats = dt.merge(src, on=["k"]).when_matched_update(
        {"p": col("__s_p")}).when_not_matched_insert().execute()
    assert stats == {"updated": 1, "deleted": 0, "inserted": 1}
    want = sorted([(k, "LOW" if k == 3 else p, d) for k, p, d in want]
                  + [(99, "NEW", 11400)])
    assert sorted(sess.read_delta(path).collect()) == want


def test_delta_append_takes_the_tables_partitioning(tmp_path):
    """C.26: an append without partition_by writes the table's partition
    directories (before, its files had none and the partition column read
    back NULL); naming other partition columns raises."""
    sess = _sessions()[1]
    path = str(tmp_path / "t")
    _orders_frame(sess, ROWS[:12]).write_delta(path, partition_by=["p"])
    _orders_frame(sess, ROWS[12:]).write_delta(path, mode="append")
    assert sorted(sess.read_delta(path).collect()) == sorted(ROWS)
    snap = tlog.DeltaLog(path).snapshot()
    assert all(f.partition_values.get("p") for f in snap.files)
    assert all(os.path.dirname(f.path).startswith("p=") for f in snap.files)
    with pytest.raises(ValueError, match="partition columns"):
        _orders_frame(sess, ROWS[:3]).write_delta(path, mode="append",
                                                  partition_by=["k"])


def test_delta_date_stats_skip_files(tmp_path):
    """C.24 in Delta's file skipping: a DATE conjunct against the add
    actions' ISO min/max stats skips the files it excludes."""
    sess = _sessions()[1]
    path = str(tmp_path / "t")
    _orders_frame(sess, ROWS[:10]).write_delta(path)
    _orders_frame(sess, ROWS[10:]).write_delta(path, mode="append")
    col, lit = cs.join_session_modules().core.col, \
        cs.join_session_modules().core.lit
    df = sess.read_delta(path)
    src = df.logical_plan().source
    cutoff = datetime.date(1992, 1, 1) + datetime.timedelta(days=40 * 5)
    rows = df.filter(col("d") < lit(cutoff)).collect()
    assert sorted(r[0] for r in rows) == list(range(5))
    assert (src.scan_stats["files_read"], src.scan_stats["files_pruned"]) \
        == (1, 1)


def test_readers_and_pandas_execs_keep_their_times(tables):
    sess = _sessions()[1]
    src = sess.read_orc(str(tables.root / "port" / "orders.orc")) \
        .logical_plan().source
    rows = sum(b.num_rows_host for b in src.batches())
    st = src.scan_stats
    assert st["rows"] == rows == tables.dj["o_orderkey"].shape[0]
    assert st["batches"] == 1 and st["stripes_read"] >= 1
    assert all(st[k] > 0 for k in ("decode_ns", "build_ns", "upload_ns"))
    before = python_udf.counters()
    df = sess.read_orc(str(tables.root / "port" / "orders.orc"))
    out = df.group_by("o_orderpriority").agg_in_pandas(
        (lambda s: int(len(s)), "n", tt.LONG, "o_orderkey")).collect()
    assert sum(r[1] for r in out) == rows
    after = python_udf.counters()
    assert after["rows_fetched"] - before["rows_fetched"] == rows
    assert after["rows_uploaded"] - before["rows_uploaded"] == len(out)
    assert all(after[k] > before[k]
               for k in ("fetch_ns", "python_ns", "upload_ns"))


def test_map_in_pandas_frame_of_none_raises_and_times_its_own_fetch():
    """A map function that yields None is an error, not the end of its
    stream; the exec's Python time leaves out the fetches it pulled."""
    sess = _sessions()[1]
    df = _orders_frame(sess, ROWS)
    schema = tt.Schema((tt.StructField("k", tt.LONG),))

    def yields_none(frames):
        for f in frames:
            yield None
            yield f[["k"]]
    with pytest.raises(TypeError):
        df.map_in_pandas(yields_none, schema).collect()
    before = python_udf.counters()
    rows = df.map_in_pandas(lambda frames: (f[["k"]] for f in frames),
                            schema).collect()
    after = python_udf.counters()
    assert sorted(r[0] for r in rows) == [r[0] for r in ROWS]
    assert after["python_ns"] >= before["python_ns"]
    assert after["fetch_ns"] > before["fetch_ns"]
