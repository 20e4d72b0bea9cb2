"""The file formats (io/avro, hivetext, csv, json, orc, orc_meta, iceberg,
parquet's writer and LEGACY rebase), the arrow seams and the two upload
lanes against the JAX package, on the CPU.

For each of Avro, Hive text, CSV, JSON, ORC, Parquet and Iceberg the same
numpy-seeded rows are written once by each package; each file is read
back by both packages' sources, and all four reads must give the same
rows and schema (and, for the formats that keep every value, the input
rows). Column pruning (Avro, ORC, Parquet) and PERMISSIVE mode (CSV,
JSON) are held to the JAX package too. The seams: decimal128 and the null
type cross `column_from_arrow` / `column_to_arrow` as in the JAX package
and the shuffle frames back to their input; the packed and per-buffer
upload lanes give the same batches. Without pyarrow, each reader and
writer that needs it raises ImportError naming pyarrow. A Hive text DATE
or DECIMAL field fails in both packages (ROADMAP C.5). Every value
exact: a codec does no arithmetic (floats compared by repr, so -0.0 and
inf count).
"""

import decimal
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.config import RapidsConf as JConf
from spark_rapids_tpu.io import (avro as javro, csv as jcsv,
                                 hivetext as jhive, iceberg as jice,
                                 json as jjson, orc as jorc,
                                 parquet as jparquet)
from spark_rapids_tpu_torch.columnar import upload
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.columnar.column import (column_from_arrow,
                                                    column_to_arrow)
from spark_rapids_tpu_torch.config import RapidsConf as TConf
from spark_rapids_tpu_torch.io import (avro as tavro, csv as tcsv,
                                       hivetext as thive, iceberg as tice,
                                       json as tjson, orc as torc,
                                       parquet as tparquet)
from spark_rapids_tpu_torch.shuffle import serializer as tser

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import JAX, TORCH, active_confs

N = 300
COLUMNS = (("k", "LONG"), ("i", "INT"), ("v", "DOUBLE"), ("s", "STRING"),
           ("b", "BOOLEAN"), ("dt", "DATE"))
#: the columns each format's test carries (Hive text parses no DATE, and
#: the JSON writer leaves a date as its day number)
FORMAT_COLUMNS = {"avro": "k i v s b dt", "hive": "k i v s b",
                  "csv": "k i v s b dt", "json": "k i v s b",
                  "orc": "k i v s b dt", "parquet": "k i v s b dt",
                  "iceberg": "k i v s b dt"}
#: formats whose read gives the input back (CSV reads "" as null)
KEEPS_INPUT = ("avro", "hive", "json", "orc", "parquet", "iceberg")
FILE_NAME = {"avro": "t.avro", "hive": "t.txt", "csv": "t.csv",
             "json": "t.jsonl", "orc": "t.orc", "parquet": "t.parquet",
             "iceberg": "ice"}


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


def _data(names, n=N, seed=3):
    """{name: Python values} from a seed: nulls in every column, large
    and negative longs, -0.0 and inf, unicode and empty strings."""
    rng = np.random.default_rng(seed)
    null = rng.random((len(COLUMNS), n)) < 0.1
    words = ["", "x", "värde", "a,b", "日本", "plain text"]
    cols = {
        "k": rng.integers(-(1 << 40), 1 << 40, n).tolist(),
        "i": rng.integers(-(1 << 31), (1 << 31) - 1, n).tolist(),
        "v": [float(x) for x in rng.choice(
            [-0.0, 1.5, float("inf"), -2.25, 1e300, 0.1], n)],
        "s": [words[j] for j in rng.integers(0, len(words), n)],
        "b": [bool(x) for x in rng.integers(0, 2, n)],
        "dt": rng.integers(-800, 20000, n).tolist(),
    }
    out = {}
    for j, (name, _) in enumerate(COLUMNS):
        if name in names:
            out[name] = [None if null[j, r] else cols[name][r]
                         for r in range(n)]
    return out


def _schema(m, names):
    t = m.t
    return t.Schema(tuple(t.StructField(n, getattr(t, ty))
                          for n, ty in COLUMNS if n in names))


def _frames(fmt):
    names = FORMAT_COLUMNS[fmt].split()
    data = _data(names)
    jdf = JAX.session.TpuSession().from_pydict(data, _schema(JAX, names))
    tdf = TORCH.session.TpuSession(device="cpu").from_pydict(
        data, _schema(TORCH, names))
    return data, names, jdf, tdf


def _sources(fmt, path, names):
    """(the JAX package's source, the port's) over `path`."""
    js, ts = _schema(JAX, names), _schema(TORCH, names)
    if fmt == "avro":
        return javro.AvroSource(path), tavro.AvroSource(path, device="cpu")
    if fmt == "hive":
        return (jhive.HiveTextSource(path, js),
                thive.HiveTextSource(path, ts, device="cpu"))
    if fmt == "csv":
        return (jcsv.CsvSource(path, schema=js),
                tcsv.CsvSource(path, schema=ts, device="cpu"))
    if fmt == "json":
        return (jjson.JsonSource(path, schema=js),
                tjson.JsonSource(path, schema=ts, device="cpu"))
    if fmt == "orc":
        return jorc.OrcSource(path), torc.OrcSource(path, device="cpu")
    if fmt == "parquet":
        return (jparquet.ParquetSource(path),
                tparquet.ParquetSource(path, device="cpu"))
    return jice.IcebergSource(path), tice.IcebergSource(path, device="cpu")


def _write(fmt, df, path):
    getattr(df, "write_hive_text" if fmt == "hive" else f"write_{fmt}")(path)


def _rows(src):
    out = []
    for b in src.batches():
        out.extend(b.to_pylist())
    return out


def _schema_of(src):
    return [(f.name, f.data_type.simple_name(), f.nullable)
            for f in src.schema.fields]


@pytest.mark.parametrize("fmt", list(FORMAT_COLUMNS))
def test_each_package_reads_the_others_file_to_the_same_rows(fmt, tmp_path):
    """The same files read by both packages give the same rows and
    schema; a file the port writes reads back in the JAX package to the
    rows of the JAX package's own file, and the reverse."""
    data, names, jdf, tdf = _frames(fmt)
    jpath = str(tmp_path / "jax" / FILE_NAME[fmt])
    tpath = str(tmp_path / "port" / FILE_NAME[fmt])
    _write(fmt, jdf, jpath)
    _write(fmt, tdf, tpath)
    reads = {}
    for writer, path in (("jax", jpath), ("port", tpath)):
        jsrc, tsrc = _sources(fmt, path, names)
        assert _schema_of(tsrc) == _schema_of(jsrc)
        reads[writer] = (repr(_rows(jsrc)), repr(_rows(tsrc)))
    assert reads["jax"][0] == reads["jax"][1] == reads["port"][0] \
        == reads["port"][1]
    if fmt in KEEPS_INPUT:
        want = list(zip(*(data[n] for n in names)))
        assert reads["port"][1] == repr(want)


@pytest.mark.parametrize("fmt", ["avro", "orc", "parquet"])
def test_column_pruning_matches_jax(fmt, tmp_path):
    data, names, jdf, tdf = _frames(fmt)
    path = str(tmp_path / FILE_NAME[fmt])
    _write(fmt, tdf, path)
    cls = {"avro": (javro.AvroSource, tavro.AvroSource),
           "orc": (jorc.OrcSource, torc.OrcSource),
           "parquet": (jparquet.ParquetSource, tparquet.ParquetSource)}[fmt]
    for columns in (["k", "s"], ["s", "k"]):
        jsrc = cls[0](path, columns=columns)
        tsrc = cls[1](path, columns=columns, device="cpu")
        assert _schema_of(tsrc) == _schema_of(jsrc)
        assert [f.name for f in tsrc.schema.fields] == columns
        got = _rows(tsrc)
        assert got == list(zip(*(data[c] for c in columns)))
        if fmt == "orc" and columns == ["s", "k"]:
            # the JAX package's ORC reader keeps the file's column order
            # under the asked names (ROADMAP C.5): held to the oracle only
            assert _rows(jsrc) == list(zip(data["k"], data["s"]))
            continue
        assert repr(got) == repr(_rows(jsrc))


@pytest.mark.parametrize("fmt", ["csv", "json"])
@pytest.mark.parametrize("mode", ["PERMISSIVE", "DROPMALFORMED", "FAILFAST"])
def test_permissive_modes_match_jax(fmt, mode, tmp_path):
    path = tmp_path / FILE_NAME[fmt]
    if fmt == "csv":
        path.write_text("a,s\n1,x\n2,y,EXTRA,COLS\n3,z\n#4,w\n5,\n")
    else:
        path.write_text('{"a": 1, "s": "x"}\nNOT JSON\n{"a": 2, "s": null}\n'
                        '{"a": 3\n{"a": 4, "s": "w"}\n')
    names = {"a": "LONG", "s": "STRING"}

    def schema(m):
        return m.t.Schema(tuple(m.t.StructField(n, getattr(m.t, ty))
                                for n, ty in names.items()))
    jcls, tcls = (jcsv.CsvSource, tcsv.CsvSource) if fmt == "csv" \
        else (jjson.JsonSource, tjson.JsonSource)
    kw = {"comment": "#"} if fmt == "csv" else {}
    jsrc = jcls(str(path), schema=schema(JAX), mode=mode, **kw)
    tsrc = tcls(str(path), schema=schema(TORCH), mode=mode, device="cpu",
                **kw)
    if mode == "FAILFAST":
        for src in (jsrc, tsrc):
            with pytest.raises(Exception):
                _rows(src)
        return
    got = _rows(tsrc)
    assert repr(got) == repr(_rows(jsrc))
    assert tsrc.malformed_rows == jsrc.malformed_rows >= 1
    assert got == ([(1, "x"), (3, "z"), (5, None)] if fmt == "csv"
                   else [(1, "x"), (2, None), (4, "w")])


def test_legacy_rebase_matches_jax_and_prunes_nothing(tmp_path):
    """datetimeRebaseModeInRead=LEGACY rebases DATE and TIMESTAMP columns
    as the JAX package does, and footer statistics prune no row group
    under it; CORRECTED passes the values through and prunes."""
    days = [-150000, -141428, -141427, -1, 0, 19000, None]
    micros = [None if d is None else d * 86_400_000_000 + 123_456
              for d in days]
    table = pa.table({"d": pa.array(days, pa.int32()).cast(pa.date32()),
                      "ts": pa.array(micros, pa.timestamp("us")),
                      "k": pa.array(range(len(days)), pa.int64())})
    path = str(tmp_path / "legacy.parquet")
    pq.write_table(table, path, row_group_size=2)
    key = "spark.rapids.sql.format.parquet.datetimeRebaseModeInRead"
    for mode in ("LEGACY", "CORRECTED"):
        jsrc = jparquet.ParquetSource(path, JConf({key: mode}),
                                      filters=[("k", ">=", 4)])
        tsrc = tparquet.ParquetSource(path, TConf({key: mode}),
                                      filters=[("k", ">=", 4)],
                                      device="cpu")
        got = _rows(tsrc)
        assert got == _rows(jsrc)
        assert tsrc.row_groups_pruned == jsrc.row_groups_pruned \
            == (0 if mode == "LEGACY" else 2)
        if mode == "CORRECTED":
            assert [r[0] for r in got] == days[4:]
    rows = TORCH.session.TpuSession({key: "LEGACY"}, device="cpu") \
        .read_parquet(path).collect()
    assert rows == JAX.session.TpuSession({key: "LEGACY"}) \
        .read_parquet(path).collect()


def _seam_table():
    big = decimal.Decimal("12345678901234567890.12")
    return pa.table({
        "n": pa.nulls(3),
        "k": pa.array([1, 2, 3], pa.int64()),
        "d": pa.array([big, None, -big], pa.decimal128(22, 2)),
        "e": pa.array([decimal.Decimal("-1.0000000001"), None,
                       decimal.Decimal("99999999999999999999999999.9")],
                      pa.decimal128(38, 10))})


def test_arrow_seams_carry_decimal128_and_null_as_jax():
    table = _seam_table()
    jb, tb = JBatch.from_arrow(table), TBatch.from_arrow(table, "cpu")
    assert [f.data_type.simple_name() for f in tb.schema.fields] == \
        [f.data_type.simple_name() for f in jb.schema.fields]
    assert repr(tb.to_pylist()) == repr(jb.to_pylist())
    assert tb.to_pylist()[1] == (None, 2, None, None)
    assert tb.to_arrow().equals(jb.to_arrow())
    assert tb.to_arrow().equals(table)
    # ROADMAP's scratch case: a null column beside a long
    two = pa.table({"n": pa.nulls(2), "x": pa.array([1, 2], pa.int64())})
    assert TBatch.from_arrow(two, "cpu").to_pylist() == \
        JBatch.from_arrow(two).to_pylist() == [(None, 1), (None, 2)]
    for name in table.column_names:
        col = column_from_arrow(table.column(name), device="cpu")
        assert column_to_arrow(col, 3).equals(
            table.column(name).combine_chunks())


def test_shuffle_frames_carry_null_and_decimal128():
    """A frame of a null, a decimal128 and a long column decodes to its
    input (the JAX package's frame fails to decode a null column: ROADMAP
    C.5); a frame without the null column equals the JAX package's."""
    from spark_rapids_tpu.shuffle import serializer as jser
    table = _seam_table()
    tb = TBatch.from_arrow(table, "cpu")
    back = tser.deserialize_batch(tser.serialize_batch(tb), tb.schema)
    assert back.to_pylist() == tb.to_pylist()
    assert back.to_arrow().equals(table)
    rest = table.drop_columns(["n"])
    jb, tb = JBatch.from_arrow(rest), TBatch.from_arrow(rest, "cpu")
    jback = jser.deserialize_batch(jser.serialize_batch(jb), jb.schema)
    tback = tser.deserialize_batch(tser.serialize_batch(tb), tb.schema)
    assert repr(tback.to_pylist()) == repr(jback.to_pylist())


def _lane_table():
    return pa.table({
        "k": pa.array([1, None, 3, 4, 5], pa.int64()),
        "s": pa.array(["a", None, "värde", "", "z"]),
        "d": pa.array([decimal.Decimal("1.5"), None, None,
                       decimal.Decimal("-12345678901234567890.5"),
                       decimal.Decimal("0.1")], pa.decimal128(25, 1)),
        "l": pa.array([[1, 2], None, [], [3], [None]],
                      pa.list_(pa.int32())),
        "st": pa.array([{"x": 1, "y": "p"}, None, {"x": None, "y": "q"},
                        {"x": 4, "y": None}, {"x": 5, "y": "r"}]),
        "m": pa.array([[("a", 1)], None, [], [("b", 2), ("c", 3)],
                       [("d", None)]], pa.map_(pa.string(), pa.int64())),
        "n": pa.nulls(5)})


def test_packed_and_per_buffer_lanes_give_identical_batches():
    host = TBatch.from_arrow(_lane_table(), "cpu")
    cols, n, schema = list(host.columns), host.num_rows_host, host.schema
    before = upload.counters()
    packed = upload.packed_upload_batch(cols, n, schema, "cpu")
    per = upload.per_buffer_upload_batch(cols, n, schema, "cpu")
    after = upload.counters()
    assert after["packed"] - before["packed"] == 1
    assert after["per_buffer"] - before["per_buffer"] == 1
    leaves = sum(len(c.leaves()) for c in cols)
    assert after["transfers"] - before["transfers"] == 1 + leaves
    assert packed.to_pylist() == per.to_pylist() == host.to_pylist()
    for a, b in zip(packed.columns, per.columns):
        assert type(a) is type(b)
        for x, y in zip(a.leaves(), b.leaves()):
            assert torch.equal(x, y)


def test_packed_upload_off_takes_the_per_buffer_lane_in_both(tmp_path):
    """transfer.packedUpload.enabled=false: the scan's batches cross on
    the per-buffer lane and give the rows of the packed lane and of the
    JAX package under the same conf."""
    path = str(tmp_path / "t.parquet")
    pq.write_table(_lane_table().drop_columns(["m", "n"]), path,
                   row_group_size=2)
    off = {"spark.rapids.tpu.transfer.packedUpload.enabled": "false"}
    rows = {}
    for label, conf in (("on", {}), ("off", off)):
        before = upload.counters()
        rows[label] = TORCH.session.TpuSession(conf, device="cpu") \
            .read_parquet(path).collect()
        after = upload.counters()
        lane = "per_buffer" if label == "off" else "packed"
        other = "packed" if label == "off" else "per_buffer"
        assert after[lane] - before[lane] == 3  # one a row group
        assert after[other] == before[other]
    assert rows["on"] == rows["off"] == \
        JAX.session.TpuSession(off).read_parquet(path).collect()


#: the module each pyarrow-backed reader or writer needs
_PYARROW = ("pyarrow", "pyarrow.csv", "pyarrow.json", "pyarrow.orc",
            "pyarrow.parquet", "pyarrow.dataset")


@pytest.mark.parametrize("call", [
    lambda tdf, p: tcsv.CsvSource(p, device="cpu"),
    lambda tdf, p: tjson.JsonSource(p, device="cpu"),
    lambda tdf, p: torc.OrcSource(p, device="cpu"),
    lambda tdf, p: tparquet.ParquetSource(p, device="cpu"),
    lambda tdf, p: tice.IcebergSource(p, device="cpu"),
    lambda tdf, p: tdf.write_csv(p),
    lambda tdf, p: tdf.write_orc(p),
    lambda tdf, p: tdf.write_parquet(p),
    lambda tdf, p: tdf.write_parquet(p, partition_by=["k"]),
    lambda tdf, p: tdf.write_iceberg(p),
], ids=["csv", "json", "orc", "parquet", "iceberg", "write_csv",
        "write_orc", "write_parquet", "write_parquet_partitioned",
        "write_iceberg"])
def test_without_pyarrow_each_pyarrow_lane_raises_naming_it(call, tmp_path,
                                                           monkeypatch):
    _, _, _, tdf = _frames("hive")
    for name in _PYARROW:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="pyarrow"):
        call(tdf, str(tmp_path / "x"))
    assert not (tmp_path / "x").exists()


def test_without_pyarrow_avro_hive_text_and_json_writes_still_run(
        tmp_path, monkeypatch):
    data, names, _, tdf = _frames("hive")
    for name in _PYARROW:
        monkeypatch.setitem(sys.modules, name, None)
    want = list(zip(*(data[n] for n in names)))
    tdf.write_avro(str(tmp_path / "t.avro"))
    tdf.write_hive_text(str(tmp_path / "t.txt"))
    tdf.write_json(str(tmp_path / "t.jsonl"))
    assert _rows(tavro.AvroSource(str(tmp_path / "t.avro"),
                                  device="cpu")) == want
    assert _rows(thive.HiveTextSource(str(tmp_path / "t.txt"),
                                      _schema(TORCH, names),
                                      device="cpu")) == want


def test_every_reader_places_its_batches_on_the_session_device(tmp_path):
    """The session hands its device to each source; the batches' tensors
    lie there (with a card, tests below check `cuda`)."""
    _, names, _, tdf = _frames("avro")
    sess = tdf.session
    paths = {}
    for fmt in ("avro", "csv", "orc", "parquet", "iceberg"):
        paths[fmt] = str(tmp_path / FILE_NAME[fmt])
        _write(fmt, tdf, paths[fmt])
    hive = str(tmp_path / "t.txt")
    tdf.select(*names[:5]).write_hive_text(hive)
    json_path = str(tmp_path / "t.jsonl")
    tdf.select(*names[:5]).write_json(json_path)
    five = _schema(TORCH, names[:5])
    dfs = [sess.read_avro(paths["avro"]),
           sess.read_csv(paths["csv"], schema=_schema(TORCH, names)),
           sess.read_orc(paths["orc"]), sess.read_parquet(paths["parquet"]),
           sess.read_iceberg(paths["iceberg"]),
           sess.read_hive_text(hive, five),
           sess.read_json(json_path, schema=five)]
    for df in dfs:
        src = df._plan.source
        assert src.device == sess.device == torch.device("cpu")
        for b in src.batches():
            assert {t.device for c in b.columns for t in c.leaves()} == \
                {sess.device}


@pytest.mark.parametrize("dtype", ["date", "decimal"])
def test_hive_text_keeps_date_and_decimal_fields_raw_as_jax(dtype,
                                                            tmp_path):
    """A DATE or DECIMAL field is not parsed: its raw string reaches the
    column build, which raises for it, in both packages (Spark parses
    both: ROADMAP C.5)."""
    path = str(tmp_path / "t.hivetxt")
    with open(path, "w") as f:
        f.write("1\x012020-01-02\n2\x01\\N\n")
    for m, sess in ((TORCH, TORCH.session.TpuSession(device="cpu")),
                    (JAX, JAX.session.TpuSession())):
        t = m.t
        x = t.DATE if dtype == "date" else t.DecimalType(10, 2)
        sch = t.Schema((t.StructField("k", t.LONG), t.StructField("x", x)))
        with pytest.raises((ValueError, TypeError)):
            sess.read_hive_text(path, sch).collect()
