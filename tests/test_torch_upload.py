"""The packed upload and fetch (columnar/upload.py, columnar/transfer.py)
against the JAX package's, on the CPU.

Both packages upload host columns built from the same seeded numpy arrays
(every fixed-width type with nulls, a StringColumn and a DictionaryColumn)
at 0 rows, 1 row, a ragged count and at capacity. Values, validity, the
row count, string bytes and offsets and dictionary codes are compared
exactly (f64 and f32 bit for bit): no tolerance. The port's wire bytes
differ from the JAX package's (its blocks sit on 16-byte boundaries), so
the port's own host pack is held byte for byte against its own device
pack instead.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar import encoded as jenc
from spark_rapids_tpu.columnar import transfer as jtransfer
from spark_rapids_tpu.columnar import upload as jupload
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.columnar.column import StringColumn as JString

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar import encoded as tenc
from spark_rapids_tpu_torch.columnar import transfer, upload
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.columnar.column import Column as TColumn
from spark_rapids_tpu_torch.columnar.column import StringColumn as TString
from spark_rapids_tpu_torch.columnar.column import (bucket_capacity,
                                                    string_buffers)

from test_torch_jax_ref import jax_aliases

FIXED = (("b", "BOOLEAN", np.bool_), ("t", "BYTE", np.int8),
         ("h", "SHORT", np.int16), ("i", "INT", np.int32),
         ("l", "LONG", np.int64), ("f", "FLOAT", np.float32),
         ("d", "DOUBLE", np.float64), ("dt", "DATE", np.int32),
         ("ts", "TIMESTAMP", np.int64))
WORDS = ("", "a", "bb", "Brand#12", "LG CASE", "DELIVER IN PERSON")
CAP = 512
ROW_COUNTS = (0, 1, 300, CAP)  # empty, one row, ragged, at capacity


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _pad(a, cap, fill=0):
    out = np.full(cap, fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def host_data(n, seed=0):
    """{name: (type name, leaves as padded numpy arrays)} for n rows at
    capacity bucket_capacity(max(n, CAP if n else 0))."""
    rng = np.random.default_rng(seed + n)
    cap = bucket_capacity(n) if n != CAP else CAP
    valid = rng.random(n) > 0.2
    out = {}
    for name, ty, dt in FIXED:
        if dt == np.bool_:
            v = rng.random(n) > 0.5
        elif np.issubdtype(dt, np.floating):
            v = (rng.standard_normal(n) * 1e3).astype(dt)
            v[::7] = np.nan
            v[1::11] = -0.0
        else:
            info = np.iinfo(dt)
            v = rng.integers(info.min, info.max, n, dtype=dt,
                             endpoint=True)
        out[name] = (ty, [_pad(v, cap), _pad(valid, cap, False)])
    picks = [WORDS[k] for k in rng.integers(0, len(WORDS), n)]
    raw, off = string_buffers(picks)
    data = np.zeros(bucket_capacity(max(int(off[-1]), 1)), np.uint8)
    data[: raw.shape[0]] = raw
    offs = np.full(cap + 1, off[-1], np.int32)
    offs[: n + 1] = off
    out["s"] = ("STRING", [data, offs, _pad(valid, cap, False)])
    ddata, doff = string_buffers(WORDS)
    dcap = bucket_capacity(len(WORDS))
    dbytes = np.zeros(bucket_capacity(int(doff[-1])), np.uint8)
    dbytes[: ddata.shape[0]] = ddata
    dofs = np.full(dcap + 1, doff[-1], np.int32)
    dofs[: len(WORDS) + 1] = doff
    codes = rng.integers(0, len(WORDS), n).astype(np.int32)
    codes[~valid] = tenc.NULL_CODE
    out["c"] = ("STRING", [_pad(codes, cap, tenc.NULL_CODE), dbytes, dofs,
                           _pad(valid, cap, False)])
    return out


def torch_columns(data):
    cols = []
    for name, (ty, leaves) in data.items():
        t = [torch.from_numpy(a.copy()) for a in leaves]
        dt = getattr(tt, ty)
        if name == "s":
            cols.append(TString(t[0], t[1], t[2], dt))
        elif name == "c":
            cols.append(tenc.DictionaryColumn(*t, dt))
        else:
            cols.append(TColumn(t[0], t[1], dt))
    return cols


def jax_columns(data):
    """The JAX package's host columns (numpy leaves) of the same data;
    its DictionaryColumn takes (codes, bytes, offsets, validity) too."""
    cols = []
    for name, (ty, leaves) in data.items():
        a = [x.copy() for x in leaves]
        dt = getattr(jt, ty)
        if name == "s":
            cols.append(JString(a[0], a[1], a[2], dt))
        elif name == "c":
            cols.append(jenc.DictionaryColumn(*a, dt))
        else:
            cols.append(JColumn(a[0], a[1], dt))
    return cols


def schemas(data):
    return [t.Schema(tuple(t.StructField(name, getattr(t, ty))
                           for name, (ty, _) in data.items()))
            for t in (jt, tt)]


def _leaves_of_jax(col):
    if isinstance(col, jenc.DictionaryColumn):
        return (col.codes, col.dict_data, col.dict_offsets, col.validity)
    if isinstance(col, JString):
        return (col.data, col.offsets, col.validity)
    return (col.data, col.validity)


def assert_same_columns(jcols, tcols):
    """Leaf for leaf, exactly (floats by their bits)."""
    for j, t in zip(jcols, tcols):
        jl, tl = _leaves_of_jax(j), t.leaves()
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape and a.dtype == b.dtype
            if a.dtype.kind == "f":
                a, b = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", ROW_COUNTS)
def test_upload_equals_jax(n):
    data = host_data(n)
    jschema, tschema = schemas(data)
    jb = jupload.to_device_batch(jax_columns(data), n, jschema)
    tb = upload.to_device_batch(torch_columns(data), n, tschema, "cpu")
    assert tb.num_rows_host == int(jb.num_rows) == int(tb.num_rows) == n
    assert tb.num_rows.dtype == torch.int32 and tb.num_rows.shape == ()
    assert_same_columns(jb.columns, tb.columns)
    assert [type(c) for c in tb.columns] == \
        [TColumn] * len(FIXED) + [TString, tenc.DictionaryColumn]


@pytest.mark.parametrize("n", ROW_COUNTS)
def test_host_pack_is_the_device_pack_and_aligned(n):
    data = host_data(n)
    _, tschema = schemas(data)
    cols = torch_columns(data)
    pool = upload.StagingPool(pinned=False)
    buf, total = upload.pack_host_batch(cols, n, pool)
    dev = transfer._pack_impl(TBatch(cols, n, tschema))
    assert dev.dtype == torch.uint8 and dev.shape[0] == total
    assert torch.equal(buf[:total], dev)
    # every block starts on a 16-byte boundary, so every leaf of the
    # unpacked batch is a view at an offset aligned for its dtype
    tb = upload.to_device_batch(cols, n, tschema, "cpu")
    base = tb.num_rows.data_ptr()
    for c in tb.columns:
        for leaf in c.leaves():
            off = leaf.data_ptr() - base
            assert off % transfer.ALIGN == 0 and off % leaf.element_size() \
                == 0
            assert leaf.untyped_storage().data_ptr() == \
                tb.num_rows.untyped_storage().data_ptr()


def test_upload_leaves_round_trip():
    data = host_data(300)
    _, tschema = schemas(data)
    batch = TBatch(torch_columns(data), 300, tschema)
    leaves, treedef = batch.flatten()
    out = upload.upload_leaves(leaves, "cpu")
    assert len(out) == len(leaves)
    for a, b in zip(leaves, out):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                           b.view(torch.uint8) if b.dim() else b)
    back = TBatch.unflatten(treedef, out)
    # NaN rows compare by their text
    assert repr(back.to_pylist()) == repr(batch.to_pylist())


@pytest.mark.parametrize("n", ROW_COUNTS)
def test_fetch_equals_jax(n):
    data = host_data(n)
    jschema, tschema = schemas(data)
    jb = jupload.to_device_batch(jax_columns(data), n, jschema)
    tb = upload.to_device_batch(torch_columns(data), n, tschema, "cpu")
    before = transfer.counters()["d2h_copies"]
    tcols, tn = transfer.fetch_batch_host(tb)
    assert transfer.counters()["d2h_copies"] == before + 1
    jcols, jn = jtransfer.fetch_batch_host(jb)
    assert tn == jn == n
    # the JAX fetch decodes dictionary columns first (its output seam);
    # the port fetches them encoded and decodes on the host
    assert_same_columns(jcols[:-1], tcols[:-1])
    assert tcols[-1].to_pylist(n) == jcols[-1].to_pylist(n)
    assert repr(tb.to_pylist()) == repr(jb.to_pylist())


def test_fetch_split_equals_jax():
    data = host_data(CAP)
    del data["c"]  # the JAX split pack has no dictionary branch
    counts = np.array([3, 0, 250, 259], np.int32)
    jcounts, jcols = jtransfer.fetch_split_host(
        np.asarray(counts), jupload.to_device_batch(
            jax_columns(data), CAP, schemas(data)[0]).columns)
    tcounts, tcols = transfer.fetch_split_host(
        torch.from_numpy(counts), torch_columns(data))
    np.testing.assert_array_equal(jcounts, tcounts)
    assert tcounts.dtype == np.int64
    assert_same_columns(jcols, tcols)


def test_unsupported_column_kind_raises():
    class Other(TColumn):
        pass
    col = Other(torch.zeros(128, dtype=torch.int32),
                torch.zeros(128, dtype=torch.bool), tt.INT)
    schema = tt.Schema((tt.StructField("x", tt.INT),))
    with pytest.raises(NotImplementedError, match="A.8"):
        upload.to_device_batch([col], 0, schema, "cpu")
    assert upload.staging_pool().outstanding_bytes() == 0


class _Event:
    """A copy's event that completes when told to."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


def test_staging_pool_reuses_only_after_the_copy_lands():
    pool = upload.StagingPool(pool_bytes=4096, pinned=False)
    a = pool.acquire(1000)
    assert a.shape[0] == 1024 and pool.misses == 1
    ev = _Event()
    pool.release_when_ready(a, ev)
    b = pool.acquire(1000)  # the copy has not landed: a fresh buffer
    assert b.data_ptr() != a.data_ptr() and pool.misses == 2
    ev.done = True
    pool.release(b)
    assert pool.outstanding_bytes() == 0  # the sweep returned `a`
    c = pool.acquire(600)
    assert pool.hits == 1 and c.data_ptr() in (a.data_ptr(), b.data_ptr())
    pool.discard(c)
    # past pool_bytes the least recently returned buffers go
    bufs = [pool.acquire(2048) for _ in range(3)]
    for buf in bufs:
        pool.release(buf)
    assert pool.pooled_bytes() <= 4096 and pool.trims >= 1
    ev2 = _Event()
    pool.release_when_ready(pool.acquire(100), ev2)
    pool.settle()
    assert ev2.done and pool.outstanding_bytes() == 0


def test_cpu_upload_is_an_alias_and_single_use():
    """On the CPU the copy returns the staging buffer itself: the pool
    must not hand it out again."""
    data = host_data(300)
    _, tschema = schemas(data)
    pool = upload.reset_staging_pool()
    before = pool.stats()
    upload.to_device_batch(torch_columns(data), 300, tschema, "cpu")
    after = pool.stats()
    assert after["misses"] == before["misses"] + 1
    assert after["pooled_bytes"] == 0 and after["outstanding_bytes"] == 0


def test_upload_requires_host_columns_and_names_its_device():
    data = host_data(1)
    _, tschema = schemas(data)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            upload.to_device_batch(torch_columns(data), 1, tschema)
    before = upload.counters()
    tb = upload.to_device_batch(torch_columns(data), 1, tschema, "cpu")
    after = upload.counters()
    assert after["uploads"] == before["uploads"] + 1
    assert after["transfers"] == before["transfers"] + 1
    assert upload.promote_batch(tb, "cpu") is tb


def test_packed_host_leaves_ship_without_a_host_pack():
    """Leaves laid out as the spill catalog lays them (one buffer, each
    on a 16-byte boundary) cross as they are: no staging buffer."""
    data = host_data(300)
    _, tschema = schemas(data)
    leaves, _ = TBatch(torch_columns(data), 300, tschema).flatten()
    host = upload.packed_host_leaves(leaves, pinned=False)
    for h, t in zip(host, leaves):
        h.copy_(t)
    total = sum(transfer.padded(t.numel() * t.element_size())
                for t in leaves)
    assert upload._packed_buffer(host, total) is not None
    assert upload._packed_buffer(leaves, total) is None
    pool = upload.reset_staging_pool()
    out = upload.upload_leaves(host, "cpu")
    assert pool.stats()["misses"] == pool.stats()["hits"] == 0
    for a, b in zip(leaves, out):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


def test_promote_stream_closes_its_source():
    """promote_stream hands host batches to promote_batch one by one and
    closing it closes its source. On the CPU the host is the device, so
    each batch passes through with no upload."""
    from spark_rapids_tpu_torch.exec.base import TpuMetric
    closed = []
    _, tschema = schemas(host_data(1))
    batches = [TBatch(torch_columns(host_data(n)), n, tschema)
               for n in (1, 300, 0)]

    def source():
        try:
            yield from batches
        finally:
            closed.append(True)
    num, ns = TpuMetric("numUploads"), TpuMetric("uploadPackTimeNs")
    before = upload.counters()["uploads"]
    stream = upload.promote_stream(source(), "cpu", num, ns)
    out = [next(stream), next(stream)]
    stream.close()
    assert closed == [True]
    assert out[0] is batches[0] and out[1] is batches[1]
    assert upload.counters()["uploads"] == before and num.value == 0
