"""The JAX package's format tests, mirrored on the port (on the CPU):
tests/test_io_formats.py (CSV and JSON options, ORC and Avro round trips,
Avro against hand-built spec bytes, the schema mismatch across files),
tests/test_io.py (Parquet reads, writes and partitioned writes, CSV and
JSON reads, the multi-file order), tests/test_orc_advanced.py (stripe
pruning, pruned against full scans, statistics of each kind, the
planner's pushdown, the COALESCING reader, zlib and unsupported codecs,
column pruning and write options), tests/test_integrations.py (Iceberg
and Hive text) and tests/test_timezone_rebase.py's LEGACY Parquet
rebase. Each case keeps the reference's data and expected rows, held
exactly. One test needs the card (marked `cuda`, skipped without one):
the Avro and Hive text readers build their batches there.
"""

import datetime as dt
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.orc as paorc
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession as _Session
from spark_rapids_tpu_torch.expr.core import col, lit
from spark_rapids_tpu_torch.io.avro import write_avro
from spark_rapids_tpu_torch.io.iceberg import IcebergTable
from spark_rapids_tpu_torch.io.orc import OrcSource, write_orc
from spark_rapids_tpu_torch.types import (BOOLEAN, DATE, DOUBLE, INT, LONG,
                                          STRING, TIMESTAMP, Schema,
                                          StructField)

from test_torch_jax_ref import one_torch_thread
from test_torch_planner import active_confs

SCH = Schema((StructField("a", LONG), StructField("s", STRING)))


@pytest.fixture(scope="module", autouse=True)
def _threads():
    with active_confs(), one_torch_thread():
        yield


def TpuSession(conf=None):
    return _Session(conf, device="cpu")


# -- tests/test_io_formats.py ------------------------------------------------

def test_csv_options_quote_null_sep(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text('a|s\n1|"x|y"\n2|NA\n3|plain\n')
    df = TpuSession().read_csv(str(p), schema=SCH, delimiter="|",
                               null_value="NA")
    assert df.collect() == [(1, "x|y"), (2, None), (3, "plain")]


def test_csv_permissive_skips_malformed(tmp_path):
    p = tmp_path / "bad.csv"
    p.write_text("a,s\n1,x\n2,y,EXTRA,COLS\n3,z\n")
    sess = TpuSession()
    df = sess.read_csv(str(p), schema=SCH)
    src = df._plan.source
    assert df.collect() == [(1, "x"), (3, "z")]
    assert src.malformed_rows == 1
    with pytest.raises(Exception):
        sess.read_csv(str(p), schema=SCH, mode="FAILFAST").collect()


def test_csv_comment_lines(tmp_path):
    p = tmp_path / "c.csv"
    p.write_text("s,a\n#skip me,0\nx,1\n")
    sch = Schema((StructField("s", STRING), StructField("a", LONG)))
    df = TpuSession().read_csv(str(p), schema=sch, comment="#")
    assert df.collect() == [("x", 1)]


@pytest.mark.parametrize("fmt", ["csv", "json"])
def test_csv_and_json_roundtrip_write(fmt, tmp_path):
    sess = TpuSession()
    data = {"a": [1, 2, None], "s": ["x", None, "z"]} if fmt == "csv" \
        else {"a": [1, None], "s": ["x", "y"]}
    df = sess.from_pydict(data, SCH)
    p = str(tmp_path / f"w.{fmt}")
    getattr(df, f"write_{fmt}")(p)
    back = getattr(sess, f"read_{fmt}")(p, schema=SCH)
    assert back.collect() == list(zip(data["a"], data["s"]))


def test_json_permissive_drops_bad_lines(tmp_path):
    p = tmp_path / "t.jsonl"
    p.write_text('{"a": 1, "s": "x"}\nTHIS IS NOT JSON\n'
                 '{"a": 2, "s": null}\n')
    sess = TpuSession()
    df = sess.read_json(str(p), schema=SCH)
    src = df._plan.source
    assert df.collect() == [(1, "x"), (2, None)]
    assert src.malformed_rows == 1
    with pytest.raises(Exception):
        sess.read_json(str(p), schema=SCH, mode="FAILFAST").collect()


def test_orc_roundtrip(tmp_path):
    sess = TpuSession()
    sch = Schema((StructField("a", LONG), StructField("s", STRING),
                  StructField("d", DOUBLE)))
    data = {"a": [1, 2, None, 4], "s": ["x", None, "zz", ""],
            "d": [1.5, -2.0, 0.0, None]}
    df = sess.from_pydict(data, sch)
    p = str(tmp_path / "t.orc")
    df.write_orc(p)
    assert sess.read_orc(p).collect() == \
        list(zip(data["a"], data["s"], data["d"]))
    assert sess.read_orc(p, columns=["s"]).collect() == \
        [(v,) for v in data["s"]]


def test_avro_roundtrip(tmp_path):
    sch = Schema((StructField("l", LONG), StructField("d", DOUBLE),
                  StructField("s", STRING), StructField("dt", DATE),
                  StructField("ts", TIMESTAMP)))
    data = {
        "l": [1, None, -(1 << 40), 7],
        "d": [1.5, float("inf"), None, -0.0],
        "s": ["a", None, "värde", ""],
        "dt": [0, 19000, None, -141427],
        "ts": [0, None, 1_700_000_000_000_000, -1],
    }
    sess = TpuSession()
    df = sess.from_pydict(data, sch)
    path = str(tmp_path / "t.avro")
    write_avro(df, path)
    assert sess.read_avro(path).collect() == df.collect()
    assert sess.read_avro(path, columns=["s", "l"]).collect() == \
        [(s, v) for v, s in zip(data["l"], data["s"])]


def test_avro_reader_against_hand_built_spec_bytes(tmp_path):
    """The reader against a file whose bytes are written out from the
    Avro 1.11 specification with no shared encoder."""
    schema = {"type": "record", "name": "r", "fields": [
        {"name": "i", "type": ["null", "int"]},
        {"name": "s", "type": "string"},
    ]}
    schema_b = json.dumps(schema).encode()
    sync = bytes(range(16))

    def zz(v):  # a zigzag varint, written from the specification
        u = (v << 1) ^ (v >> 63) if v < 0 else v << 1
        out = b""
        while True:
            if u < 0x80:
                return out + bytes([u])
            out += bytes([(u & 0x7F) | 0x80])
            u >>= 7

    header = (b"Obj\x01" + zz(2)
              + zz(len(b"avro.schema")) + b"avro.schema"
              + zz(len(schema_b)) + schema_b
              + zz(len(b"avro.codec")) + b"avro.codec"
              + zz(len(b"null")) + b"null"
              + zz(0) + sync)
    # rows: (7, "hi"), (None, "x"), (-3, "")
    body = (zz(1) + zz(7) + zz(2) + b"hi"
            + zz(0) + zz(1) + b"x"
            + zz(1) + zz(-3) + zz(0))
    path = str(tmp_path / "spec.avro")
    with open(path, "wb") as f:
        f.write(header + zz(3) + zz(len(body)) + body + sync)
    assert TpuSession().read_avro(path).collect() == \
        [(7, "hi"), (None, "x"), (-3, "")]


def test_avro_schema_mismatch_across_files_rejected(tmp_path):
    sess = TpuSession()
    d1 = sess.from_pydict({"i": [1]}, Schema((StructField("i", INT),)))
    d2 = sess.from_pydict({"j": [2]}, Schema((StructField("j", LONG),)))
    write_avro(d1, str(tmp_path / "a.avro"))
    write_avro(d2, str(tmp_path / "b.avro"))
    with pytest.raises(ValueError, match="schema mismatch"):
        sess.read_avro(str(tmp_path)).collect()


# -- tests/test_io.py ---------------------------------------------------------

@pytest.fixture
def pq_dir(tmp_path):
    t1 = pa.table({"k": ["a", "b", None, "a"], "v": [1, 2, 3, 4],
                   "d": [1.5, None, 2.5, 3.5]})
    t2 = pa.table({"k": ["c", "b"], "v": [5, 6], "d": [4.5, 5.5]})
    d = tmp_path / "data"
    d.mkdir()
    pq.write_table(t1, d / "part-0.parquet", row_group_size=2)
    pq.write_table(t2, d / "part-1.parquet")
    return str(d)


def test_parquet_read_directory(pq_dir):
    df = TpuSession().read_parquet(pq_dir)
    assert set(df.columns) == {"k", "v", "d"}
    got = sorted(df.collect(), key=repr)
    assert len(got) == 6
    assert ("a", 1, 1.5) in got and ("c", 5, 4.5) in got \
        and (None, 3, 2.5) in got


def test_parquet_query_pipeline(pq_dir):
    got = (TpuSession().read_parquet(pq_dir)
           .filter(F.col("v") > 1)
           .group_by("k").agg((F.sum("v"), "s"))
           .sort("k").collect())
    assert got == [(None, 3), ("a", 4), ("b", 8), ("c", 5)]


def test_parquet_roundtrip_write(pq_dir, tmp_path):
    sess = TpuSession()
    out = str(tmp_path / "out.parquet")
    sess.read_parquet(pq_dir).filter(F.col("v") <= 4).write_parquet(out)
    assert sess.read_parquet(out).count() == 4


def test_parquet_partitioned_write(pq_dir, tmp_path):
    sess = TpuSession()
    out = str(tmp_path / "parted")
    sess.read_parquet(pq_dir).filter(
        F.col("k") == F.lit("b")).write_parquet(out, partition_by=["k"])
    assert os.path.isdir(os.path.join(out, "k=b"))
    assert sorted(pq.read_table(out).to_pylist(), key=repr) == [
        {"v": 2, "d": None, "k": "b"}, {"v": 6, "d": 5.5, "k": "b"}]


def test_csv_read(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("a,b,c\n1,x,1.5\n2,y,2.5\n3,,3.5\n")
    assert TpuSession().read_csv(str(p)).collect() == \
        [(1, "x", 1.5), (2, "y", 2.5), (3, None, 3.5)]


def test_csv_read_with_schema(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("a,b\n1,10\n2,20\n")
    schema = Schema((StructField("a", LONG), StructField("b", DOUBLE)))
    df = TpuSession().read_csv(str(p), schema=schema)
    assert df.collect() == [(1, 10.0), (2, 20.0)]
    assert df.schema.fields[1].data_type.simple_name() == "double"


def test_json_read(tmp_path):
    p = tmp_path / "t.jsonl"
    rows = [{"a": 1, "s": "x"}, {"a": 2, "s": None}, {"a": 3, "s": "z"}]
    p.write_text("\n".join(json.dumps(r) for r in rows))
    assert TpuSession().read_json(str(p)).collect() == \
        [(1, "x"), (2, None), (3, "z")]


def test_multifile_order_preserved(tmp_path):
    d = tmp_path / "many"
    d.mkdir()
    for i in range(5):
        pq.write_table(pa.table({"i": [i * 10 + j for j in range(3)]}),
                       d / f"f{i}.parquet")
    got = [r[0] for r in TpuSession().read_parquet(str(d)).collect()]
    assert got == sorted(got) and len(got) == 15


# -- tests/test_orc_advanced.py -----------------------------------------------

@pytest.fixture(scope="module")
def orc_file(tmp_path_factory):
    # ~8 stripes of 1024 rows each, `a` monotone so that min/max prune
    path = str(tmp_path_factory.mktemp("orc") / "t.orc")
    n = 8192
    t = pa.table({
        "a": pa.array(range(n), pa.int64()),
        "d": pa.array([float(i) * 0.5 for i in range(n)], pa.float64()),
        "s": pa.array([f"k{i:06d}" for i in range(n)]),
        "dt": pa.array([dt.date(2020, 1, 1) + dt.timedelta(days=i // 100)
                        for i in range(n)]),
        "nul": pa.array([None if i % 2 else i for i in range(n)],
                        pa.int64()),
    })
    paorc.write_table(t, path, stripe_size=1)
    nstripes = paorc.ORCFile(path).nstripes
    assert nstripes >= 4, nstripes
    return path, n, nstripes


def _scan(src):
    return sum(b.num_rows_host for b in src.batches())


def _orc(path, **kw):
    return OrcSource(path, device="cpu", **kw)


def test_stripe_pruning_int_predicate(orc_file):
    path, n, nstripes = orc_file
    src = _orc(path, filters=[("a", "<", 1000)])
    rows = _scan(src)
    assert src.stripes_pruned > 0
    assert src.stripes_read + src.stripes_pruned == nstripes
    assert rows >= 1000  # prove-absence: every matching row survives


def test_pruned_scan_equals_full_scan(orc_file):
    path, n, _ = orc_file

    def values(src):
        return sorted(v for b in src.batches()
                      for v in b.columns[0].to_pylist(b.num_rows_host))
    vals_full = values(_orc(path))
    pruned = _orc(path, filters=[("a", ">=", 5000)])
    vals_pruned = values(pruned)
    assert pruned.stripes_pruned > 0
    assert set(v for v in vals_full if v >= 5000) <= set(vals_pruned)
    assert set(vals_pruned) <= set(vals_full)
    assert vals_full == list(range(n))


@pytest.mark.parametrize("name, op, value", [
    ("s", ">", "k999999"), ("d", "<", 0.0),
    ("dt", ">", dt.date(2021, 1, 1)), ("a", "is_null", None)])
def test_string_double_date_and_null_stats_prune_every_stripe(
        orc_file, name, op, value):
    path, n, nstripes = orc_file
    src = _orc(path, filters=[(name, op, value)])
    assert _scan(src) == 0
    assert src.stripes_pruned == nstripes


def test_null_stats(orc_file):
    # `nul` has nulls in every stripe: IS NULL prunes nothing
    path, n, nstripes = orc_file
    src = _orc(path, filters=[("nul", "is_null", None)])
    assert _scan(src) == n
    assert src.stripes_pruned == 0 and src.stripes_read == nstripes


def test_planner_pushes_filters_to_orc(orc_file):
    path, n, _ = orc_file
    df = TpuSession().read_orc(path).filter(col("a") < lit(512))
    got = sorted(r[0] for r in df.select(col("a")).collect())
    assert got == list(range(512))
    from spark_rapids_tpu_torch.exec.basic import SourceScanExec
    plan = df._exec()
    scans = [nd for nd in _walk(plan) if isinstance(nd, SourceScanExec)]
    assert len(scans) == 1 and scans[0]._source.filters == [("a", "<", 512)]


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def test_coalescing_reader_type(orc_file):
    path, n, _ = orc_file
    src = _orc(path, reader_type="COALESCING", batch_rows=1 << 14)
    assert _scan(src) == n


def test_zlib_file_stats_parse(tmp_path):
    path = str(tmp_path / "z.orc")
    paorc.write_table(pa.table({"x": pa.array(range(4096), pa.int64())}),
                      path, stripe_size=1, compression="zlib")
    nstripes = paorc.ORCFile(path).nstripes
    src = _orc(path, filters=[("x", ">", 10 ** 9)])
    assert _scan(src) == 0
    assert src.stripes_pruned == nstripes


def test_unsupported_codec_degrades_to_no_pruning(tmp_path):
    path = str(tmp_path / "zstd.orc")
    paorc.write_table(pa.table({"x": pa.array(range(4096), pa.int64())}),
                      path, stripe_size=1, compression="zstd")
    src = _orc(path, filters=[("x", ">", 10 ** 9)])
    assert _scan(src) == 4096  # nothing pruned; the Filter above is exact
    assert src.stripes_pruned == 0


def test_column_pruning_and_write_options(tmp_path, orc_file):
    path, n, _ = orc_file
    src = _orc(path, columns=["s", "a"])
    assert [f.name for f in src.schema.fields] == ["s", "a"]
    b = next(iter(src.batches()))
    assert len(b.columns) == 2
    assert b.to_pylist()[:2] == [("k000000", 0), ("k000001", 1)]
    df = TpuSession().read_orc(path, columns=["a"])
    out = str(tmp_path / "out.orc")
    write_orc(df, out, compression="zlib", stripe_size=64 * 1024)
    assert _scan(_orc(out)) == n


# -- tests/test_integrations.py: Iceberg and Hive text ------------------------

ISCH = Schema((StructField("k", LONG), StructField("v", DOUBLE),
               StructField("s", STRING), StructField("b", BOOLEAN)))


def _df(sess, n=50, seed=0):
    rng = np.random.default_rng(seed)
    return sess.from_pydict({
        "k": [int(x) for x in rng.integers(0, 100, n)],
        "v": [None if x % 9 == 0 else float(x) / 3
              for x in rng.integers(0, 100, n)],
        "s": [None if x % 7 == 0 else f"röw-{x}"
              for x in rng.integers(0, 100, n)],
        "b": [None if x % 5 == 0 else bool(x % 2)
              for x in rng.integers(0, 100, n)],
    }, ISCH)


def _sorted(rows):
    return sorted(rows, key=repr)


def test_iceberg_write_read_roundtrip(tmp_path):
    sess = TpuSession()
    path = str(tmp_path / "ice")
    df = _df(sess)
    df.write_iceberg(path)
    assert _sorted(sess.read_iceberg(path).collect()) == \
        _sorted(df.collect())
    names = os.listdir(os.path.join(path, "metadata"))
    assert any(n.endswith(".metadata.json") for n in names)
    assert any(n.startswith("snap-") for n in names)
    assert any(n.endswith("-m0.avro") for n in names)


def test_iceberg_append_overwrite_and_snapshot_isolation(tmp_path):
    sess = TpuSession()
    path = str(tmp_path / "ice")
    _df(sess, 10, seed=1).write_iceberg(path)
    snap1 = IcebergTable(path).metadata()["current-snapshot-id"]
    _df(sess, 5, seed=2).write_iceberg(path, mode="append")
    assert len(sess.read_iceberg(path).collect()) == 15
    assert len(sess.read_iceberg(path, snapshot_id=snap1).collect()) == 10
    _df(sess, 3, seed=9).write_iceberg(path, mode="overwrite")
    assert len(sess.read_iceberg(path).collect()) == 3


def test_iceberg_filter_pushdown_through_planner(tmp_path):
    sess = TpuSession()
    path = str(tmp_path / "ice")
    df = _df(sess, 100)
    df.write_iceberg(path)
    got = sess.read_iceberg(path).filter(col("k") < lit(50)).collect()
    assert _sorted(got) == _sorted([r for r in df.collect() if r[0] < 50])


@pytest.mark.parametrize("delim", [None, "|"])
def test_hive_text_roundtrip(delim, tmp_path):
    sess = TpuSession()
    path = str(tmp_path / "t.hivetxt")
    df = _df(sess, 40)
    kw = {} if delim is None else {"field_delim": delim}
    df.write_hive_text(path, **kw)
    got = sess.read_hive_text(path, ISCH, **kw).collect()
    assert _sorted(got) == _sorted(df.collect())
    raw = open(path, encoding="utf-8").read()
    assert (delim or "\x01") in raw and r"\N" in raw


def test_hive_text_malformed_numeric_reads_null(tmp_path):
    path = str(tmp_path / "bad.hivetxt")
    with open(path, "w") as f:
        f.write("12\x01notanumber\n\\N\x013.5\n")
    sch = Schema((StructField("a", LONG), StructField("b", DOUBLE)))
    assert TpuSession().read_hive_text(path, sch).collect() == \
        [(12, None), (None, 3.5)]


# -- tests/test_timezone_rebase.py --------------------------------------------

def test_parquet_legacy_rebase_mode(tmp_path):
    """LEGACY datetimeRebaseModeInRead rebases DATE columns on the scan."""
    from spark_rapids_tpu_torch.ops.rebase import _hybrid_to_proleptic
    hybrid_days = [-150000, -141428, -141427, 0, 19000]
    table = pa.table({"d": pa.array(hybrid_days, pa.int32()).cast(
        pa.date32())})
    path = str(tmp_path / "legacy.parquet")
    pq.write_table(table, path)
    legacy = TpuSession({
        "spark.rapids.sql.format.parquet.datetimeRebaseModeInRead":
            "LEGACY"})
    rows = [r[0] for r in legacy.read_parquet(path).collect()]
    assert rows == [_hybrid_to_proleptic(d) for d in hybrid_days]
    assert [r[0] for r in TpuSession().read_parquet(path).collect()] == \
        hybrid_days


@pytest.mark.cuda
def test_file_lanes_build_their_batches_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sess = _Session()
    df = _df(sess, 40)
    df.write_avro(str(tmp_path / "t.avro"))
    df.write_hive_text(str(tmp_path / "t.txt"))
    for df in (sess.read_avro(str(tmp_path / "t.avro")),
               sess.read_hive_text(str(tmp_path / "t.txt"), ISCH)):
        for b in df._plan.source.batches():
            assert {t.device.type for c in b.columns
                    for t in c.leaves()} == {"cuda"}
