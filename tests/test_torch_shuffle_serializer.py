"""The host shuffle's wire format and block codec in the port
(shuffle/serializer.py, native/, csrc/blockcodec.cpp) against the JAX
package, on the CPU:

- frames are byte-identical to the JAX package's for the same batch, with
  codec COPY and LZ4: every fixed-width type with nulls, strings with
  empty and non-ASCII values, binary, a batch of 0 rows, and
  `serialize_slice` row ranges;
- a frame of either package decodes in the other to the same rows, and
  the decoded batch lies on the host at the JAX package's buckets;
- a flipped byte anywhere raises CorruptFrameError; a checksummed frame
  read with another schema raises the schema mismatch;
- xxh64 on the canonical vectors and against the JAX package's pure
  Python one; LZ4 round trips, the JAX package's bytes, and a malformed
  block refused;
- the host gather and slice helpers equal the JAX package's; a
  dictionary column is refused; a source that does not compile raises.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu import native as jnative
from spark_rapids_tpu.shuffle import serializer as jser

from spark_rapids_tpu_torch import native as tnative
from spark_rapids_tpu_torch.columnar.column import StringColumn
from spark_rapids_tpu_torch.kernels import build
from spark_rapids_tpu_torch.shuffle import serializer as tser

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases

WORDS = ["", "a", "héllo wörld", "日本語", "x" * 70, "end"]


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _columns(n, seed=0):
    rng = np.random.default_rng(seed)

    def valid():
        return rng.random(n) > 0.25
    strs = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
    # bytes a string column's to_pylist decodes (both_batch builds it as
    # one; the schema says BINARY)
    raw = [bytes(rng.integers(32, 127, rng.integers(0, 9)).astype(np.uint8))
           for _ in range(n)]
    return {
        "b": (rng.random(n) > 0.5, "BOOLEAN", valid()),
        "i8": (rng.integers(-128, 128, n).astype(np.int8), "BYTE", valid()),
        "i16": (rng.integers(-999, 999, n).astype(np.int16), "SHORT",
                valid()),
        "i": (rng.integers(-2**31, 2**31, n).astype(np.int32), "INT",
              valid()),
        "l": (rng.integers(-2**62, 2**62, n), "LONG", valid()),
        "f": (rng.standard_normal(n).astype(np.float32), "FLOAT", valid()),
        "d": (np.where(rng.random(n) < 0.1, np.nan,
                       rng.standard_normal(n)), "DOUBLE", valid()),
        "dt": (rng.integers(0, 20000, n).astype(np.int32), "DATE", valid()),
        "ts": (rng.integers(0, 2**50, n), "TIMESTAMP", valid()),
        "s": (strs, "STRING", valid()),
        "bin": (raw, "BINARY", valid()),
    }


def _batches(n, seed=0, capacity=None):
    return both_batch(_columns(n, seed), n, capacity)


@pytest.mark.parametrize("codec", [tser.CODEC_COPY, tser.CODEC_LZ4])
@pytest.mark.parametrize("n", [0, 1, 7, 300, 1000])
def test_frames_are_byte_identical_to_jax(codec, n):
    jb, tb = _batches(n, seed=n)
    tf = tser.serialize_batch(tb, codec)
    assert tf == jser.serialize_batch(jb, codec)
    assert tf[:8] == tser.MAGIC


@pytest.mark.parametrize("codec", [tser.CODEC_COPY, tser.CODEC_LZ4])
def test_slices_are_byte_identical_to_jax_and_to_a_gathered_batch(codec):
    n = 500
    jb, tb = _batches(n, seed=3)
    for lo, hi in ((0, 0), (0, n), (3, 17), (n - 1, n), (250, 250),
                   (100, 400)):
        tf = tser.serialize_slice(tb, lo, hi, codec)
        assert tf == jser.serialize_slice(jb, lo, hi, codec), (lo, hi)
        idx = np.arange(lo, hi)
        assert tf == tser.serialize_batch(
            tser.host_gather_batch(tb, idx), codec)


def test_repetitive_data_is_stored_lz4_and_noise_as_copy():
    n = 4096
    rep = both_batch({"k": (np.zeros(n, np.int64), "LONG", None)}, n)[1]
    frame = tser.serialize_batch(rep, tser.CODEC_LZ4)
    assert frame[9] == tser.CODEC_LZ4 and len(frame) < n
    rng = np.random.default_rng(5)
    noise = both_batch({"k": (rng.integers(-2**62, 2**62, n), "LONG",
                              rng.random(n) > 0.5)}, n)[1]
    # incompressible: stored raw, flagged COPY, as in the JAX package
    assert tser.serialize_batch(noise, tser.CODEC_LZ4)[9] == tser.CODEC_COPY


def _rows_equal(a, b):
    """Rows equal value for value and type for type (NaN equal to NaN;
    a BINARY value's bytes against the str of both_batch's string
    column)."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if isinstance(x, bytes):
                x = x.decode()
            if isinstance(x, float) and x != x:
                assert y != y
            else:
                assert x == y and type(x) is type(y), (x, y)


@pytest.mark.parametrize("codec", [tser.CODEC_COPY, tser.CODEC_LZ4])
def test_frames_decode_across_packages(codec):
    n = 777
    jb, tb = _batches(n, seed=11)
    want = tb.to_pylist()
    # the JAX package's frame in the port
    got = tser.deserialize_batch(jser.serialize_batch(jb, codec), tb.schema)
    assert got.num_rows_host == n and got.capacity == 1024
    assert all(t.device.type == "cpu" for c in got.columns
               for t in c.leaves())
    _rows_equal(got.to_pylist(), want)
    # the port's frame in the JAX package, host-backed
    jgot = jser.deserialize_batch(tser.serialize_batch(tb, codec),
                                  jb.schema, device=False)
    _rows_equal(jgot.to_pylist(), want)
    # and the decoded buffers match the JAX package's decode, padding too
    jdec = jser.deserialize_batch(jser.serialize_batch(jb, codec),
                                  jb.schema, device=False)
    for jc, tc in zip(jdec.columns, got.columns):
        for jl, tl in zip((jc.data, jc.validity) + (
                (jc.offsets,) if isinstance(tc, StringColumn) else ()),
                (tc.data, tc.validity) + (
                (tc.offsets,) if isinstance(tc, StringColumn) else ())):
            np.testing.assert_array_equal(np.asarray(jl), tl.numpy())


def test_empty_frame_decodes_to_an_empty_host_batch():
    jb, tb = _batches(0)
    got = tser.deserialize_batch(tser.serialize_batch(tb), tb.schema)
    assert got.num_rows_host == 0 and got.capacity == 128
    assert got.to_pylist() == []


def test_every_flipped_byte_is_detected():
    jb, tb = _batches(40, seed=2)
    frame = bytearray(tser.serialize_batch(tb))
    for pos in range(0, len(frame), max(1, len(frame) // 97)):
        bad = bytearray(frame)
        bad[pos] ^= 0x10
        with pytest.raises(tser.CorruptFrameError):
            tser.deserialize_batch(bytes(bad), tb.schema)
    with pytest.raises(tser.CorruptFrameError):
        tser.deserialize_batch(bytes(frame[:20]), tb.schema)
    with pytest.raises(tser.CorruptFrameError):
        tser.deserialize_batch(bytes(frame[:-1]), tb.schema)


def test_a_frame_read_with_another_schema_is_a_mismatch():
    jb, tb = _batches(40, seed=2)
    other = both_batch({"x": (np.arange(3), "LONG", None)}, 3)[1].schema
    frame = tser.serialize_batch(tb)
    with pytest.raises(ValueError, match="schema mismatch") as e:
        tser.deserialize_batch(frame, other)
    assert not isinstance(e.value, tser.CorruptFrameError)
    assert tser.schema_fingerprint(tb.schema) == \
        jser.schema_fingerprint(jb.schema)


def test_xxh64_vectors_and_jax_reference():
    assert tnative.xxh64(b"") == 0xEF46DB3751D8E999
    assert tnative.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert tnative.xxh64(b"abc") == 0x44BC2CF5AD770999
    rng = np.random.default_rng(1)
    for n in list(range(0, 70)) + [255, 1024, 4099]:
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        for seed in (0, 42, 2**64 - 1):
            assert tnative.xxh64(data, seed) == jnative._xxh64_py(data, seed)


def _lz4_cases():
    rng = np.random.default_rng(4)
    return [b"", b"a", b"abcabcabcabcabc", b"\0" * 100_000,
            rng.integers(0, 256, 70_000).astype(np.uint8).tobytes(),
            (b"spark shuffle block " * 5000)[:99_999],
            rng.integers(0, 3, 200_000).astype(np.uint8).tobytes()]


def test_lz4_round_trips_and_equals_the_jax_codec():
    for data in _lz4_cases():
        c = tnative.lz4_compress(data)
        assert tnative.lz4_decompress(c, len(data)) == data
        assert c == jnative.lz4_compress(data)
        assert jnative.lz4_decompress(c, len(data)) == data


def test_a_malformed_lz4_block_is_refused():
    c = tnative.lz4_compress(b"spark shuffle block " * 100)
    with pytest.raises(ValueError, match="corrupt LZ4"):
        tnative.lz4_decompress(c, 1999)
    with pytest.raises(ValueError, match="corrupt LZ4"):
        tnative.lz4_decompress(c[:-3], 2000)
    with pytest.raises(ValueError, match="corrupt LZ4"):
        tnative.lz4_decompress(b"\xf0", 100)


def test_host_gather_and_slice_equal_jax():
    jb, tb = _batches(300, seed=9)
    idx = np.random.default_rng(2).permutation(300)[:123]
    pairs = [(jser.host_gather_batch(jb, idx), tser.host_gather_batch(tb, idx)),
             (jser.host_slice_batch(jb, 40, 200),
              tser.host_slice_batch(tb, 40, 200)),
             (jser.host_slice_batch(jb, 5, 5), tser.host_slice_batch(tb, 5, 5))]
    for j, t in pairs:
        assert j.num_rows_host == t.num_rows_host
        for jc, tc in zip(j.columns, t.columns):
            np.testing.assert_array_equal(np.asarray(jc.validity),
                                          tc.validity.numpy())
            np.testing.assert_array_equal(np.asarray(jc.data), tc.data.numpy())
            if isinstance(tc, StringColumn):
                np.testing.assert_array_equal(np.asarray(jc.offsets),
                                              tc.offsets.numpy())


def test_a_dictionary_column_is_refused():
    _, tb = both_batch({"m": ((np.array([0, 1, 0], np.int32), ("A", "B")),
                              "STRING", None)}, 3)
    with pytest.raises(NotImplementedError, match="boundary"):
        tser.serialize_batch(tb)


def test_a_source_that_does_not_compile_raises():
    with pytest.raises(RuntimeError, match="failed"):
        build.build_host("this is not C++ {")


def test_device_tensors_are_not_encoded_in_place():
    _, tb = _batches(5)
    with pytest.raises(ValueError, match="host columns"):
        tser._np(torch.empty(3, device="meta"))
    assert isinstance(tser.serialize_batch(tb), bytes)
