"""Delta Lake (delta/log.py, delta/table.py) against the JAX package, on
the CPU.

Each case of tests/test_delta.py runs in both packages on the same
numpy-seeded rows, each package writing its own table: the rows read
back, the counts the DML commands return, the file skipping, the
checkpoint and the history must be equal, and equal to the JAX suite's
expected values. Also: OPTIMIZE ZORDER as tests/test_zorder.py runs it; a
table the port writes, partitioned and past its first checkpoint, read by
the JAX package (snapshot, rows, history) and the reverse; the older
checkpoint layout (JSON actions) replayed by both; each per-file rewrite
(`delete_rewrite`, `update_rewrite`, `merge_rewrite` with
`merge_insert_rows`, `zorder_rewrite`) against the command that uses it;
a MERGE on a STRING key held to a Python pair-count oracle (ROADMAP C.5:
the JAX package's inner join on a STRING key repeats stream rows); a
MERGE with NULL keys on both sides; DELETE's condition kept in code space
over a dictionary column; and what the port reads or plans and the JAX
package does not (ROADMAP C.5): DATE, TIMESTAMP and DECIMAL partition
values, a DECIMAL data column, OPTIMIZE ZORDER BY a DATE. Rows exact (a
DML command does no float arithmetic but the update's product, the same
op in both).
"""

import json
import os
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.delta import log as jlog, table as jtable
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import functions as tF
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.delta import log as tlog, table as ttable
from spark_rapids_tpu_torch.expr import core as tcore

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs

JAX = SimpleNamespace(name="jax", t=jt, F=jF, core=jcore, log=jlog,
                      table=jtable,
                      session=lambda: jsession.TpuSession())
TORCH = SimpleNamespace(name="torch", t=tt, F=tF, core=tcore, log=tlog,
                        table=ttable,
                        session=lambda: tsession.TpuSession(device="cpu"))
BOTH = (JAX, TORCH)


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


def _sorted(rows):
    return sorted(rows, key=repr)


def schema(m):
    t = m.t
    return t.Schema((t.StructField("k", t.LONG),
                     t.StructField("v", t.DOUBLE),
                     t.StructField("s", t.STRING)))


def frame(m, sess, ks, vs=None, ss=None):
    n = len(ks)
    return sess.from_pydict({
        "k": ks,
        "v": vs if vs is not None else [float(x) for x in range(n)],
        "s": ss if ss is not None else [f"s{x}" for x in range(n)],
    }, schema(m))


def seeded(n, seed):
    """(keys, values, strings) from a seed, with nulls in v and s."""
    rng = np.random.default_rng(seed)
    ks = [int(x) for x in rng.permutation(n * 3)[:n] + 1]
    vs = [None if rng.random() < 0.2 else float(x)
          for x in rng.integers(-50, 50, n)]
    ss = [None if rng.random() < 0.2 else f"w{int(x)}"
          for x in rng.integers(0, 9, n)]
    return ks, vs, ss


def both(tmp_path, case):
    """case(m, path) in each package, each on its own table path."""
    out = []
    for m in BOTH:
        out.append(case(m, str(tmp_path / m.name)))
    return out


def test_write_read_roundtrip(tmp_path):
    def case(m, path):
        sess = m.session()
        df = frame(m, sess, *seeded(40, 1))
        df.write_delta(path)
        assert os.path.exists(os.path.join(path, "_delta_log",
                                           f"{0:020d}.json"))
        got = sess.read_delta(path).collect()
        assert _sorted(got) == _sorted(df.collect())
        return _sorted(got)
    j, t = both(tmp_path, case)
    assert t == j


def test_append_and_overwrite(tmp_path):
    def case(m, path):
        sess = m.session()
        frame(m, sess, [1]).write_delta(path)
        frame(m, sess, [2]).write_delta(path, mode="append")
        appended = sorted(r[0] for r in sess.read_delta(path).collect())
        frame(m, sess, [9]).write_delta(path, mode="overwrite")
        with pytest.raises(FileExistsError):
            frame(m, sess, [3]).write_delta(path, mode="error")
        return appended, [r[0] for r in sess.read_delta(path).collect()]
    j, t = both(tmp_path, case)
    assert t == j == ([1, 2], [9])


def test_time_travel(tmp_path):
    def case(m, path):
        sess = m.session()
        frame(m, sess, [1]).write_delta(path)
        frame(m, sess, [2]).write_delta(path, mode="append")
        return ([r[0] for r in sess.read_delta(path, version=0).collect()],
                sorted(r[0] for r in sess.read_delta(path, version=1)
                       .collect()))
    j, t = both(tmp_path, case)
    assert t == j == ([1], [1, 2])


def test_partitioned_write_and_pruning(tmp_path):
    def case(m, path):
        sess = m.session()
        frame(m, sess, [1, 1, 2, 2, 3, None], [0.0, 1.0, 2.0, 3.0, 4.0, 5.0],
              ["a", "b", "c", "d", "e", "f"]).write_delta(
            path, partition_by=["k"])
        assert os.path.isdir(os.path.join(path, "k=1"))
        assert os.path.isdir(os.path.join(path,
                                          "k=__HIVE_DEFAULT_PARTITION__"))
        df = sess.read_delta(path)
        got = df.filter(m.F.col("k") == m.core.lit(2)).collect()
        log = m.log.DeltaLog(path)
        kw = {"device": "cpu"} if m is TORCH else {}
        src = m.table.DeltaSource(log, log.snapshot(), sess.conf,
                                  filters=[("k", "==", 2)], **kw)
        files = src.files_after_skipping()
        nulls = m.table.DeltaSource(log, log.snapshot(), sess.conf,
                                    filters=[("k", "is_null", None)], **kw)
        return (_sorted((r[1], r[2]) for r in got), len(files),
                src.scan_stats["files_pruned"],
                len(nulls.files_after_skipping()),
                _sorted(df.collect()))
    j, t = both(tmp_path, case)
    assert t == j
    assert t[:4] == ([(2.0, "c"), (3.0, "d")], 1, 3, 1)


def test_stats_file_skipping_non_partition(tmp_path):
    def case(m, path):
        sess = m.session()
        frame(m, sess, [1, 2, 3], [1.5, None, -2.0],
              ["b", None, "a"]).write_delta(path)
        frame(m, sess, [100, 200]).write_delta(path, mode="append")
        log = m.log.DeltaLog(path)
        kw = {"device": "cpu"} if m is TORCH else {}
        src = m.table.DeltaSource(log, log.snapshot(), sess.conf,
                                  filters=[("k", ">", 50)], **kw)
        files = src.files_after_skipping()
        stats = [f.parsed_stats() for f in log.snapshot().files]
        return len(files), src.scan_stats["files_pruned"], stats
    j, t = both(tmp_path, case)
    assert t == j
    assert t[:2] == (1, 1)
    assert t[2][0] == {"numRecords": 3,
                       "minValues": {"k": 1, "v": -2.0, "s": "a"},
                       "maxValues": {"k": 3, "v": 1.5, "s": "b"},
                       "nullCount": {"k": 0, "v": 1, "s": 1}}


def test_delete(tmp_path):
    def case(m, path):
        sess = m.session()
        ks, vs, ss = seeded(30, 2)
        frame(m, sess, ks, vs, ss).write_delta(path)
        n = m.table.DeltaTable.for_path(sess, path).delete(
            m.F.col("v") >= m.core.lit(0.0))
        return (n, _sorted(sess.read_delta(path).collect()),
                len(sess.read_delta(path, version=0).collect()))
    j, t = both(tmp_path, case)
    assert t == j
    ks, vs, ss = seeded(30, 2)
    assert t[0] == sum(v is not None and v >= 0 for v in vs)
    assert t[1] == _sorted((k, v, s) for k, v, s in zip(ks, vs, ss)
                           if v is None or v < 0)
    assert t[2] == 30


def test_update(tmp_path):
    def case(m, path):
        sess = m.session()
        ks, vs, ss = seeded(30, 3)
        frame(m, sess, ks, vs, ss).write_delta(path)
        n = m.table.DeltaTable.for_path(sess, path).update(
            {"v": m.F.col("v") * m.core.lit(10.0), "s": m.core.lit("upd")},
            m.F.col("k") > m.core.lit(40))
        return n, _sorted(sess.read_delta(path).collect())
    j, t = both(tmp_path, case)
    assert t == j
    ks, vs, ss = seeded(30, 3)
    want = [(k, None if v is None else v * 10.0, "upd") if k > 40
            else (k, v, s) for k, v, s in zip(ks, vs, ss)]
    assert t == (sum(k > 40 for k in ks), _sorted(want))


def test_merge_upsert(tmp_path):
    def case(m, path):
        sess = m.session()
        frame(m, sess, [1, 2, 3], [1.0, 2.0, 3.0],
              ["a", "b", "c"]).write_delta(path)
        source = sess.from_pydict(
            {"k": [2, 3, 4], "v": [20.0, 30.0, 40.0], "s": ["B", "C", "D"]},
            schema(m))
        col = m.F.col
        stats = (m.table.DeltaTable.for_path(sess, path)
                 .merge(source, on=["k"])
                 .when_matched_update({"v": col("__s_v"), "s": col("__s_s")})
                 .when_not_matched_insert()
                 .execute())
        return stats, _sorted(sess.read_delta(path).collect())
    j, t = both(tmp_path, case)
    assert t == j
    assert t == ({"updated": 2, "deleted": 0, "inserted": 1},
                 [(1, 1.0, "a"), (2, 20.0, "B"), (3, 30.0, "C"),
                  (4, 40.0, "D")])


def test_merge_delete(tmp_path):
    def case(m, path):
        sess = m.session()
        frame(m, sess, [1, 2, 3]).write_delta(path)
        source = sess.from_pydict({"k": [2], "v": [0.0], "s": ["x"]},
                                  schema(m))
        stats = (m.table.DeltaTable.for_path(sess, path)
                 .merge(source, on=["k"]).when_matched_delete().execute())
        return stats, sorted(r[0] for r in sess.read_delta(path).collect())
    j, t = both(tmp_path, case)
    assert t == j
    assert t == ({"updated": 0, "deleted": 1, "inserted": 0}, [1, 3])


def test_merge_ambiguous_source_rejected(tmp_path):
    def case(m, path):
        sess = m.session()
        frame(m, sess, [1]).write_delta(path)
        for keys in ([1, 1], [None, None]):
            source = sess.from_pydict({"k": keys, "v": [0.0, 1.0],
                                       "s": ["x", "y"]}, schema(m))
            with pytest.raises(ValueError, match="multiple source rows"):
                (m.table.DeltaTable.for_path(sess, path)
                 .merge(source, on=["k"])
                 .when_matched_update({"v": m.F.col("__s_v")}).execute())
        return m.log.DeltaLog(path).latest_version()
    j, t = both(tmp_path, case)
    assert t == j == 0


def test_concurrent_commit_conflict(tmp_path):
    def case(m, path):
        sess = m.session()
        frame(m, sess, [1]).write_delta(path)
        log = m.log.DeltaLog(path)
        v = log.latest_version() + 1
        log.commit([m.log.DeltaLog.commit_info("WRITE")], v)
        with pytest.raises(m.log.DeltaConcurrentModificationException):
            log.commit([m.log.DeltaLog.commit_info("WRITE")], v)
        return log.latest_version()
    j, t = both(tmp_path, case)
    assert t == j == 1


def test_checkpoint_roundtrip(tmp_path):
    def case(m, path):
        sess = m.session()
        frame(m, sess, [0]).write_delta(path)
        for i in range(1, 12):
            frame(m, sess, [i]).write_delta(path, mode="append")
        log = m.log.DeltaLog(path)
        snap = log.snapshot()
        return (log.last_checkpoint(), snap.version, len(snap.files),
                sorted(r[0] for r in sess.read_delta(path).collect()))
    j, t = both(tmp_path, case)
    assert t == j == (10, 11, 12, list(range(12)))


def test_history(tmp_path):
    def case(m, path):
        sess = m.session()
        frame(m, sess, [1, 2]).write_delta(path)
        dt = m.table.DeltaTable.for_path(sess, path)
        dt.delete(m.F.col("k") == m.core.lit(1))
        dt.delete(m.F.col("k") == m.core.lit(7))  # no row: no commit
        dt.update({"v": 5.0}, m.F.col("k") == m.core.lit(2))
        return [(h["version"], h["operation"]) for h in dt.history()]
    j, t = both(tmp_path, case)
    assert t == j == [(0, "WRITE"), (1, "DELETE"), (2, "UPDATE")]


def test_optimize_zorder(tmp_path):
    """tests/test_zorder.py::test_delta_optimize_zorder in both packages:
    four files compacted to one, the rows kept, the same row order (two
    keys below 2**32 give every row one code, ROADMAP C.5, so the order
    is the snapshot's)."""
    def case(m, path):
        sess = m.session()
        t = m.t
        sch = t.Schema((t.StructField("x", t.LONG),
                        t.StructField("y", t.LONG)))
        rng = np.random.default_rng(1)
        for _ in range(4):
            sess.from_pydict(
                {"x": [int(v) for v in rng.integers(0, 100, 50)],
                 "y": [int(v) for v in rng.integers(0, 100, 50)]},
                sch).write_delta(path, mode="append")
        dt = m.table.DeltaTable.for_path(sess, path)
        rows_before = sorted(sess.read_delta(path).collect())
        removed = dt.optimize(zorder_by=["x", "y"])
        after = dt.log.snapshot()
        got = sess.read_delta(path).collect()
        assert sorted(got) == rows_before
        adds = [a for a in dt.log._read_version_actions(after.version)
                if "add" in a or "remove" in a]
        return (removed, len(after.files), got,
                dt.history()[-1]["operation"],
                {next(iter(a)): a[next(iter(a))]["dataChange"]
                 for a in adds})
    j, t = both(tmp_path, case)
    assert t == j
    assert t[0] == 4 and t[1] == 1 and t[3] == "OPTIMIZE"
    assert t[4] == {"add": False, "remove": False}


def _snapshot_view(m, path):
    sess = m.session()
    log = m.log.DeltaLog(path)
    snap = log.snapshot()
    return {"version": snap.version, "checkpoint": log.last_checkpoint(),
            "schema": [(f.name, f.data_type.simple_name())
                       for f in snap.schema.fields],
            "partitions": snap.partition_columns,
            "files": sorted((f.path, json.dumps(f.partition_values),
                             f.stats) for f in snap.files),
            "rows": _sorted(sess.read_delta(path).collect()),
            "v3": _sorted(sess.read_delta(path, version=3).collect()),
            "history": [(h["version"], h["operation"])
                        for h in m.table.DeltaTable.for_path(
                            sess, path).history()]}


@pytest.mark.parametrize("writer, reader", [(TORCH, JAX), (JAX, TORCH)],
                         ids=["port-writes", "jax-writes"])
def test_cross_read(tmp_path, writer, reader):
    """A table one package writes (partitioned, DML commits, past the
    checkpoint at version 10) reads the same in the other."""
    path = str(tmp_path / "t")
    sess = writer.session()
    ks, vs, ss = seeded(60, 4)
    frame(writer, sess, ks[:20], vs[:20], ss[:20]).write_delta(
        path, partition_by=["s"])
    for i in range(1, 10):
        lo = 20 + 4 * (i - 1)
        frame(writer, sess, ks[lo: lo + 4], vs[lo: lo + 4],
              ss[lo: lo + 4]).write_delta(path, mode="append")
    dt = writer.table.DeltaTable.for_path(sess, path)
    dt.delete(writer.F.col("v") < writer.core.lit(-30.0))   # version 10
    dt.update({"v": 0.0}, writer.F.col("k") < writer.core.lit(20))
    mine, theirs = _snapshot_view(writer, path), _snapshot_view(reader, path)
    assert theirs == mine
    assert mine["checkpoint"] == 10 and mine["version"] == 11
    assert len(mine["rows"]) == 56 - sum(
        v is not None and v < -30 for v in vs[:56])


# -- each rewrite function against its command ----------------------------

def _rows_after(kind, sess, path):
    """The command `kind` on a one-file table at `path`: (its result, the
    table's rows after)."""
    col, lit = tF.col, tcore.lit
    dt = ttable.DeltaTable.for_path(sess, path)
    if kind == "delete":
        out = dt.delete(col("v") < lit(0.0))
    elif kind == "update":
        out = dt.update({"s": lit("upd")}, col("v") < lit(0.0))
    elif kind == "merge":
        out = dt.merge(_merge_source(sess), on=["k"]).when_matched_update(
            {"v": col("__s_v")}).when_not_matched_insert().execute()
    else:
        out = dt.optimize(zorder_by=["k"])
    return out, sess.read_delta(path).collect()


def _merge_source(sess):
    ks, vs, ss = seeded(30, 5)
    return frame(TORCH, sess, ks[:10] + [1000, 1001], vs[:12], ss[:12])


@pytest.mark.parametrize("kind", ["delete", "update", "merge", "optimize"])
def test_rewrite_function_equals_its_command(tmp_path, kind):
    sess = TORCH.session()
    path = str(tmp_path / "t")
    ks, vs, ss = seeded(40, 6)
    frame(TORCH, sess, ks, vs, ss).write_delta(path)
    file_df = sess.read_delta(path)
    col, lit = tF.col, tcore.lit
    if kind == "delete":
        got = ttable.delete_rewrite(file_df, col("v") < lit(0.0)).collect()
    elif kind == "update":
        got = ttable.update_rewrite(file_df, file_df.schema,
                                    {"s": lit("upd")},
                                    col("v") < lit(0.0)).collect()
    elif kind == "merge":
        src = _merge_source(sess)
        got = ttable.merge_rewrite(file_df, ttable.marked_source(src),
                                   ["k"], {"v": col("__s_v")},
                                   False).collect()
        got += ttable.merge_insert_rows(src, file_df, ["k"],
                                        file_df.schema).collect()
    else:
        got = ttable.zorder_rewrite(file_df, ["k"],
                                    file_df.schema.names).collect()
    _, after = _rows_after(kind, sess, path)
    if kind == "optimize":
        assert got == after  # the order is the rewrite's
        assert [r[0] for r in got] == sorted(ks)
    else:
        assert _sorted(got) == _sorted(after)


def test_merge_string_key_pair_count_oracle(tmp_path):
    """MERGE on a STRING key with many target rows a key, held to a
    Python oracle (ROADMAP C.5: the JAX package's inner join on a STRING
    key repeats stream rows; MERGE's left outer join must not): every
    target row comes back once, each matched row updated, each unmatched
    source key inserted once."""
    rng = np.random.default_rng(45)
    n_t = 300
    t_keys = ["s45"] * 100 + ["s46"] * 120 + [
        f"s{int(x)}" for x in rng.integers(0, 400, n_t - 220)]
    t_vals = [float(x) for x in rng.integers(0, 1000, n_t)]
    s_keys = sorted({f"s{int(x)}" for x in rng.integers(0, 400, 97)}
                    | {"s45", "s46"})
    s_vals = [float(1000 + i) for i in range(len(s_keys))]
    src_of = dict(zip(s_keys, s_vals))
    want = Counter([(k, src_of.get(k, v)) for k, v in zip(t_keys, t_vals)]
                   + [(k, src_of[k]) for k in s_keys if k not in t_keys])
    want_stats = {"updated": sum(k in src_of for k in t_keys), "deleted": 0,
                  "inserted": sum(k not in t_keys for k in s_keys)}

    sch = tt.Schema((tt.StructField("s", tt.STRING),
                     tt.StructField("v", tt.DOUBLE)))
    sess = TORCH.session()
    path = str(tmp_path / "t")
    sess.from_pydict({"s": t_keys, "v": t_vals}, sch).write_delta(path)
    source = sess.from_pydict({"s": s_keys, "v": s_vals}, sch)
    stats = (ttable.DeltaTable.for_path(sess, path).merge(source, on=["s"])
             .when_matched_update({"v": tF.col("__s_v")})
             .when_not_matched_insert().execute())
    rows = Counter(sess.read_delta(path).collect())
    assert stats == want_stats and want_stats["updated"] >= 220
    assert rows == want


def test_merge_null_keys(tmp_path):
    """NULL keys never match: a target row with a NULL key stays, a source
    row with one is inserted (as in the JAX package)."""
    def case(m, path):
        sess = m.session()
        frame(m, sess, [1, None, 3], [1.0, 2.0, 3.0],
              ["a", "b", "c"]).write_delta(path)
        source = sess.from_pydict({"k": [None, 3, 5], "v": [9.0, 30.0, 50.0],
                                   "s": ["n", "C", "E"]}, schema(m))
        stats = (m.table.DeltaTable.for_path(sess, path)
                 .merge(source, on=["k"])
                 .when_matched_update({"s": m.F.col("__s_s")})
                 .when_not_matched_insert().execute())
        return stats, _sorted(sess.read_delta(path).collect())
    j, t = both(tmp_path, case)
    assert t == j
    assert t == ({"updated": 1, "deleted": 0, "inserted": 2},
                 _sorted([(1, 1.0, "a"), (None, 2.0, "b"), (3, 3.0, "C"),
                          (None, 9.0, "n"), (5, 50.0, "E")]))


def _typed(m, with_decimal):
    t = m.t
    fields = [("k", t.LONG), ("dt", t.DATE), ("ts", t.TIMESTAMP)] + (
        [("m", t.DecimalType(12, 2))] if with_decimal else [])
    data = {"k": [1, 2, 3, 4], "dt": [10, 20, None, 10],
            "ts": [1_000_000, 2_500_000, None, 1_000_000],
            "m": [123, -5, None, 123]}
    sess = m.session()
    return sess, sess.from_pydict(
        {n: data[n] for n, _ in fields},
        t.Schema(tuple(t.StructField(n, ty) for n, ty in fields)))


@pytest.mark.parametrize("part", ["dt", "ts", "m", None])
def test_partition_values_and_decimal_stats(tmp_path, part):
    """DATE, TIMESTAMP and DECIMAL partition values and a DECIMAL data
    column: the port writes and reads each back, and reads the JAX
    package's table. The JAX package reads a DATE partition back, and
    raises on the other three (ROADMAP C.5: a TIMESTAMP or DECIMAL
    partition value is parsed as an int, and a DECIMAL data column's
    stats JSON meets a Decimal)."""
    by = [part] if part else None
    path = str(tmp_path / "torch")
    sess, df = _typed(TORCH, True)
    df.write_delta(path, partition_by=by)
    assert _sorted(sess.read_delta(path).collect()) == _sorted(df.collect())
    stats = tlog.DeltaLog(path).snapshot().files[0].parsed_stats()
    assert "m" not in stats["minValues"] and "m" not in stats["maxValues"]
    if part is None:
        with pytest.raises(TypeError, match="Decimal"):
            _typed(JAX, True)[1].write_delta(str(tmp_path / "jax_m"))
    jpath = str(tmp_path / "jax")
    jsess, jdf = _typed(JAX, part == "m")
    jdf.write_delta(jpath, partition_by=by)
    if part in ("ts", "m"):
        with pytest.raises(ValueError, match="invalid literal for int"):
            jsess.read_delta(jpath).collect()
    else:
        assert _sorted(jsess.read_delta(jpath).collect()) == \
            _sorted(jdf.collect())
    assert _sorted(sess.read_delta(jpath).collect()) == _sorted(jdf.collect())


def test_optimize_zorder_by_date(tmp_path):
    """OPTIMIZE ZORDER BY a DATE column: the port ranks each row by its
    day number, so the file comes out in date order; the JAX package
    cannot plan InterleaveBits over a DATE (ROADMAP C.5)."""
    def make(m, path):
        t = m.t
        sess = m.session()
        rng = np.random.default_rng(7)
        days = [None if x < 2 else int(x) - 5000
                for x in rng.integers(0, 10000, 40)]
        sess.from_pydict({"k": list(range(40)), "dt": days}, t.Schema((
            t.StructField("k", t.LONG), t.StructField("dt", t.DATE)))
        ).write_delta(path)
        return sess, days
    path = str(tmp_path / "torch")
    sess, days = make(TORCH, path)
    assert ttable.DeltaTable.for_path(sess, path).optimize(["dt"]) == 1
    got = [r[1] for r in sess.read_delta(path).collect()]
    assert got == [None] * days.count(None) + sorted(
        d for d in days if d is not None)
    jpath = str(tmp_path / "jax")
    jsess, _ = make(JAX, jpath)
    with pytest.raises(Exception, match="InterleaveBits"):
        jtable.DeltaTable.for_path(jsess, jpath).optimize(["dt"])


def test_delete_condition_stays_in_code_space():
    """DELETE's `NOT (cond IS TRUE)` over a dictionary-encoded string
    column filters by code, as the bare condition does (the IS TRUE
    wrapper keeps its predicate's walk); its rows equal numpy's."""
    import chip_smoke as cs
    from spark_rapids_tpu_torch.expr import predicates as tpred
    dj = cs.tpch_join_data(sf=0.001)
    batch = cs.join_batch(dj, "orders", "cpu")
    df = TORCH.session().from_batches([batch], batch.schema)
    kept = ttable.delete_rewrite(df, tF.col("o_orderstatus")
                                 == tcore.lit("F"))
    assert tpred.encoded_safe_predicate(
        tcore.resolve(kept.logical_plan().condition, batch.schema))
    assert not tpred.encoded_safe_predicate(tcore.resolve(
        tpred.EqualNullSafe(tF.col("o_orderstatus"), tcore.lit("F")),
        batch.schema))
    want = dj["o_orderkey"][dj["o_orderstatus"][0] != 0]
    assert sorted(r[0] for r in kept.collect()) == sorted(want.tolist())


def test_checkpoint_of_json_actions_replays(tmp_path):
    """The older checkpoint layout, one JSON action a row in an `action`
    column, replays in both packages as the struct layout does."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    path = str(tmp_path / "t")
    sess = TORCH.session()
    frame(TORCH, sess, [1, 2]).write_delta(path)
    frame(TORCH, sess, [3]).write_delta(path, mode="append")
    log = tlog.DeltaLog(path)
    actions = [a for v in (0, 1) for a in log._read_version_actions(v)
               if "commitInfo" not in a]
    pq.write_table(pa.table({"action": [json.dumps(a) for a in actions]}),
                   log._checkpoint_file(1))
    with open(os.path.join(log.log_path, "_last_checkpoint"), "w") as f:
        json.dump({"version": 1}, f)
    os.remove(log._version_file(0))
    for m in BOTH:
        snap = m.log.DeltaLog(path).snapshot()
        assert (snap.version, len(snap.files)) == (1, 2)
        assert sorted(r[0] for r in m.session().read_delta(path)
                      .collect()) == [1, 2, 3]
