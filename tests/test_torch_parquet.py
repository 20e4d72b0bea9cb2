"""The Parquet reader (io/parquet.py), the multi-file machinery
(io/multifile.py, io/retrying.py) and the arrow seams against the JAX
package's, on the CPU, over files written with pyarrow.

Every comparison is exact: integers, floats by their bits, validity,
strings, dictionary codes, row order, and the row-group counters.
"""

import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.io import parquet as jparquet

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar import encoded as tenc
from spark_rapids_tpu_torch.columnar import upload
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.columnar.column import column_from_arrow
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.io import multifile, parquet, retrying

from test_torch_jax_ref import jax_aliases

SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _table(n, seed):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.15
    key = np.arange(seed * 10_000, seed * 10_000 + n, dtype=np.int64)
    return pa.table({
        "k": pa.array(key),
        "q": pa.array(rng.integers(1, 51, n).astype(np.int32), mask=~valid),
        "p": pa.array(rng.random(n) * 1000.0),
        "f": pa.array(rng.random(n) > 0.5, pa.bool_(),
                      mask=rng.random(n) > 0.9),
        "mode": pa.array([SHIPMODES[i] for i in
                          rng.integers(0, len(SHIPMODES), n)],
                         pa.string(), mask=rng.random(n) > 0.8),
        "note": pa.array([f"n{i % 13}" for i in range(n)], pa.string()),
    })


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Three files of 700, 1300 and 90 rows in row groups of 256: 3, 6
    and 1 groups."""
    root = tmp_path_factory.mktemp("pq")
    for i, n in enumerate((700, 1300, 90)):
        pq.write_table(_table(n, i + 1), root / f"part-{i}.parquet",
                       row_group_size=256)
    (root / "_SUCCESS").write_text("")
    return root


def _rows(batches):
    """Rows of a batch list as text (so a NaN equals itself)."""
    return [repr(r) for b in batches for r in b.to_pylist()]


def _both(files, **kw):
    j = jparquet.ParquetSource(str(files), **kw)
    t = parquet.ParquetSource(str(files), device="cpu", **kw)
    return j, t


@pytest.mark.parametrize("reader", ["MULTITHREADED", "COALESCING",
                                    "PERFILE"])
def test_parquet_source_equals_jax(files, reader):
    j, t = _both(files, reader_type=reader, batch_rows=500)
    jb, tb = list(j.batches()), list(t.batches())
    assert [b.num_rows_host for b in tb] == [b.num_rows_host for b in jb]
    assert _rows(tb) == _rows(jb)
    assert t.schema.names == j.schema.names
    assert [repr(x) for x in t.schema.types] == \
        [repr(x) for x in j.schema.types]
    assert (t.row_groups_read, t.row_groups_pruned) == \
        (j.row_groups_read, j.row_groups_pruned) == (10, 0)


def test_dictionary_encoded_strings_equal_jax(files):
    j, t = _both(files, batch_rows=1 << 20)
    for jb, tb in zip(j.batches(), t.batches()):
        for name in ("mode", "note"):
            jc, tc = jb.column(name), tb.column(name)
            assert isinstance(tc, tenc.DictionaryColumn)
            np.testing.assert_array_equal(tc.codes.numpy(),
                                          np.asarray(jc.codes))
            np.testing.assert_array_equal(tc.validity.numpy(),
                                          np.asarray(jc.validity))
            np.testing.assert_array_equal(tc.dict_data.numpy(),
                                          np.asarray(jc.dict_data))
            np.testing.assert_array_equal(tc.dict_offsets.numpy(),
                                          np.asarray(jc.dict_offsets))
    plain = parquet.ParquetSource(str(files), device="cpu", encoded=False)
    b = next(plain.batches())
    assert not any(isinstance(c, tenc.DictionaryColumn) for c in b.columns)
    assert _rows([b]) == _rows([next(t.batches())])


@pytest.mark.parametrize("filters,pruned", [
    ([("k", ">=", 20_500)], 4),          # the first file and 1 of 6
    ([("k", "==", 30_050)], 9),          # one row group survives
    ([("q", "<", 0)], 10),               # every group proven empty
    ([("mode", "is_null", None)], 0),    # nulls in every group
])
def test_row_group_pruning_equals_jax(files, filters, pruned):
    j, t = _both(files, filters=filters, columns=["k", "q", "mode"])
    assert _rows(list(t.batches())) == _rows(list(j.batches()))
    assert (t.row_groups_read, t.row_groups_pruned) == \
        (j.row_groups_read, j.row_groups_pruned)
    assert t.row_groups_pruned == pruned
    copy = parquet.ParquetSource(str(files), device="cpu").with_filters(
        filters)
    list(copy.batches())
    assert copy.row_groups_pruned == pruned


def test_scan_of_parquet_equals_jax(files):
    j, t = _both(files, batch_rows=400)
    jrows = jbasic.SourceScanExec(j, j.schema).collect()
    before = upload.counters()["uploads"]
    trows = tbasic.SourceScanExec(t, t.schema, depth=2).collect()
    assert repr(trows) == repr(jrows)
    # one upload a batch (a row group of up to 256 rows each)
    assert upload.counters()["uploads"] - before == 10


@pytest.mark.parametrize("n", [0, 1, 300])
def test_from_arrow_to_arrow_equal_jax(n):
    table = _table(n, 7)
    jb, tb = JBatch.from_arrow(table), TBatch.from_arrow(table, "cpu")
    assert repr(tb.to_pylist()) == repr(jb.to_pylist())
    assert tb.to_arrow().equals(jb.to_arrow())
    assert tb.to_arrow().to_pylist() == \
        table.cast(tb.to_arrow().schema).to_pylist()


def test_arrow_types_the_port_lacks_raise():
    # A.8 wave 1 brought DECIMAL(p<=18) (its unscaled lane); decimal128
    # arrays wait for A.5
    col = column_from_arrow(pa.array([decimal.Decimal("1.5")],
                                     pa.decimal128(10, 2)), device="cpu")
    assert col.to_pylist(1) == [150]
    with pytest.raises(NotImplementedError, match="A.5"):
        column_from_arrow(pa.array([decimal.Decimal("1.5")],
                                   pa.decimal128(20, 2)), device="cpu")
    with pytest.raises(NotImplementedError, match="A.8"):
        tt.to_arrow(object.__new__(tt.DataType))


def test_expand_paths_and_threaded_chunks(files, tmp_path):
    paths = multifile.expand_paths(str(files))
    assert [p.rsplit("/", 1)[1] for p in paths] == \
        ["part-0.parquet", "part-1.parquet", "part-2.parquet"]
    assert multifile.expand_paths([str(files / "part-1.parquet"),
                                   str(files / "part-*.parquet")])[1:] \
        == paths
    tasks = [lambda i=i: i * i for i in range(40)]
    assert list(multifile.threaded_chunks(tasks, 4, window=3)) == \
        [i * i for i in range(40)]
    assert list(multifile.threaded_chunks(tasks, 1)) == \
        [i * i for i in range(40)]


def test_io_retry_retries_transient_errors_only():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"
    before = retrying.io_retry_recoveries()
    assert retrying.with_io_retry(flaky, "t", backoff_ms=1) == "ok"
    assert len(calls) == 3 and retrying.io_retry_recoveries() == before + 1
    with pytest.raises(FileNotFoundError):
        retrying.with_io_retry(lambda: open("/nonexistent/x"), "t")
    with pytest.raises(OSError):
        retrying.with_io_retry(lambda: (_ for _ in ()).throw(OSError("x")),
                               "t", retries=1, backoff_ms=1)
    a = retrying.backoff_s("w", "1", 3, 50)
    assert 0.2 <= a <= 0.25 and a == retrying.backoff_s("w", "1", 3, 50)
    assert retrying.backoff_s("w", "1", 10, 50) <= 2.5


def test_parquet_source_needs_a_device(files):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            parquet.ParquetSource(str(files))
    with pytest.raises(ValueError, match="reader type"):
        parquet.ParquetSource(str(files), device="cpu", reader_type="X")
