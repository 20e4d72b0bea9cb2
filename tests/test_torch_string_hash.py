"""String hashing in the port (ops/hashing.py, columnar/encoded.py) against
the JAX package, bit for bit, on the CPU:

- `murmur3_bytes` and `murmur3_string` (Spark's hashUnsafeBytes) with a
  seed per row, `murmur3_column` and `murmur3_batch` over string,
  dictionary and fixed-width columns mixed, the dictionary in first
  position through `dictionary_hashes` -> `dict_take`;
- `xxhash64_int`, `xxhash64_long`, `xxhash64_string`, `xxhash64_column`
  and `xxhash64_batch` over mixed columns, and `pmod`;
- rows of every length 0-70 (past the 32-byte stripe and the 8- and
  4-byte tails), random bytes (many >= 0x80, whose trailing bytes
  murmur3 sign-extends), multibyte UTF-8, nulls, padded capacities;
- the numpy references that chip_smoke.py holds the card's hashes to,
  against the JAX package.

A dictionary column hashes as its decoded strings; the JAX package's
xxhash64 takes no dictionary column, so there the reference is its hash
of the decoded column.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.columnar import encoded as jenc
from spark_rapids_tpu.ops import hashing as jh

from spark_rapids_tpu_torch.columnar import encoded as tenc
from spark_rapids_tpu_torch.ops import hashing as th
from spark_rapids_tpu_torch.ops import murmur3_lanes

import chip_smoke as cs
from test_torch_encoded import both_column
from test_torch_jax_ref import jax_aliases


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def probe_values(seed, nulls=True):
    """Rows of every length 0-70 of random bytes, UTF-8 text with 2-, 3-
    and 4-byte characters, and (with `nulls`) None every 7th row."""
    rng = np.random.default_rng(seed)
    vals = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
            for n in range(71) for _ in range(3)]
    vals += ["ü€𝄞 Straße"[: k % 10] * (k // 10 + 1) for k in range(60)]
    vals += [b"\x80", b"\xff\xfe", b"\x7f\x80\x81", "é"]
    if nulls:
        vals = [None if i % 7 == 3 else v for i, v in enumerate(vals)]
    return vals


def _u32(x):
    return np.asarray(x).view(np.uint32)


def _u64(x):
    return np.asarray(x).view(np.uint64)


@pytest.mark.parametrize("seed", [0, 1])
def test_murmur3_string_with_row_seeds(seed):
    j, t = both_column(probe_values(seed), "STRING")
    rng = np.random.default_rng(seed + 10)
    seeds = rng.integers(0, 1 << 32, t.capacity, dtype=np.uint64) \
        .astype(np.uint32)
    want = _u32(jh.murmur3_string(j, jnp.asarray(seeds)))
    got = th.murmur3_string(t, torch.from_numpy(seeds.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got.numpy()), want)
    # one scalar seed: the same as a plane of it
    got42 = th.murmur3_string(t, 42)
    want42 = _u32(jh.murmur3_string(
        j, jnp.full((t.capacity,), 42, jnp.uint32)))
    np.testing.assert_array_equal(_u32(got42.numpy()), want42)


def test_murmur3_bytes_over_spans():
    """Spans that point anywhere into a buffer (a dictionary's rows by
    code), overlapping and out of order."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 600, dtype=np.uint8)
    n = 1000
    lengths = rng.integers(0, 71, n).astype(np.int32)
    starts = rng.integers(0, 600 - 70, n).astype(np.int32)
    seeds = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    want = _u32(jh.murmur3_bytes(jnp.asarray(lengths), jnp.asarray(starts),
                                 jnp.asarray(data), 600, jnp.asarray(seeds)))
    got = th.murmur3_bytes(torch.from_numpy(lengths),
                           torch.from_numpy(starts), torch.from_numpy(data),
                           torch.from_numpy(seeds.view(np.int32)))
    np.testing.assert_array_equal(_u32(got.numpy()), want)


def _mixed_columns(seed, n=400):
    """Columns of every hashable kind with nulls, as (JAX, port) pairs:
    a string, a dictionary, int, long, double (-0.0, NaN), float, bool,
    short and date."""
    rng = np.random.default_rng(seed)
    words = ["", "a", "ab", "REG AIR", "Brand#12", "x" * 33, "é€", "\x80"]
    strs = [words[i] for i in rng.integers(0, len(words), n)]
    dbl = rng.normal(size=n) * 1e6
    dbl[:4] = [0.0, -0.0, np.nan, -np.inf]
    cols = {
        "s": (strs, "STRING", rng.random(n) > 0.1),
        "d": ((rng.integers(0, len(words), n).astype(np.int32),
               tuple(words)), "STRING", rng.random(n) > 0.1),
        "i": (rng.integers(-2**31, 2**31, n).astype(np.int32), "INT",
              rng.random(n) > 0.1),
        "l": (rng.integers(-2**63, 2**63, n, dtype=np.int64), "LONG",
              rng.random(n) > 0.1),
        "f64": (dbl, "DOUBLE", rng.random(n) > 0.1),
        "f32": (dbl.astype(np.float32), "FLOAT", rng.random(n) > 0.1),
        "b": (rng.random(n) > 0.5, "BOOLEAN", rng.random(n) > 0.1),
        "h": (rng.integers(-2**15, 2**15, n).astype(np.int16), "SHORT",
              rng.random(n) > 0.1),
        "dt": (rng.integers(-1000, 20000, n).astype(np.int32), "DATE",
               rng.random(n) > 0.1),
    }
    return {k: both_column(v, ty, valid) for k, (v, ty, valid)
            in cols.items()}


def _decoded(jcol):
    """The JAX package's StringColumn of a JAX DictionaryColumn."""
    return jenc.materialize_column(jcol) \
        if isinstance(jcol, jenc.DictionaryColumn) else jcol


@pytest.mark.parametrize("order", [
    ("s", "i", "l"), ("d", "s", "f64"), ("i", "d", "f32", "b"),
    ("l", "f64", "s", "h", "dt"), ("s",), ("d",)])
def test_xxhash64_batch_over_mixed_columns(order):
    cols = _mixed_columns(len(order))
    want = np.asarray(jh.xxhash64_batch([_decoded(cols[k][0])
                                         for k in order], 42))
    got = th.xxhash64_batch([cols[k][1] for k in order], 42)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # another seed, and the per-column update from a running hash
    want7 = np.asarray(jh.xxhash64_batch([_decoded(cols[k][0])
                                          for k in order], 7))
    np.testing.assert_array_equal(
        th.xxhash64_batch([cols[k][1] for k in order], 7).numpy(), want7)


@pytest.mark.parametrize("order", [
    ("s", "i"), ("d", "s", "l"), ("i", "d", "f64"), ("d",), ("s",),
    ("f32", "d", "b", "s", "h", "dt")])
def test_murmur3_batch_over_mixed_columns(order):
    """murmur3_batch with string and dictionary columns anywhere: a
    dictionary in first position hashes its dictionary once."""
    cols = _mixed_columns(10 + len(order))
    want = _u32(jh.murmur3_batch([cols[k][0] for k in order], 42))
    before = tenc.counters()["dict_hash_tables"]
    murmur3_lanes.murmur3_columns.launches = 0
    got = th.murmur3_batch([cols[k][1] for k in order], 42)
    np.testing.assert_array_equal(_u32(got.numpy()), want)
    assert tenc.counters()["dict_hash_tables"] - before == \
        (1 if order[0] == "d" else 0)
    assert murmur3_lanes.murmur3_columns.launches == 0   # CPU: plain


def test_murmur3_column_of_a_dictionary_hashes_its_strings():
    cols = _mixed_columns(5)
    jd, td = cols["d"]
    rng = np.random.default_rng(5)
    seeds = rng.integers(0, 1 << 32, td.capacity, dtype=np.uint64) \
        .astype(np.uint32)
    want = _u32(jh.murmur3_column(jd, jnp.asarray(seeds)))
    got = th.murmur3_column(td, torch.from_numpy(seeds.view(np.int32)))
    np.testing.assert_array_equal(_u32(got.numpy()), want)
    # the same as the decoded column's hash
    dec = _u32(th.murmur3_column(tenc.materialize_column(td),
                                 torch.from_numpy(seeds.view(np.int32))))
    np.testing.assert_array_equal(dec, want)


def test_dictionary_hashes_then_dict_take_equal_row_hashes():
    words = tuple(v if isinstance(v, str) else v.decode("latin-1")
                  for v in probe_values(4, nulls=False)[::5])
    rng = np.random.default_rng(4)
    codes = rng.integers(0, len(words), 3000).astype(np.int32)
    valid = rng.random(3000) > 0.2
    jd, td = both_column((codes, words), "STRING", valid)
    before = tenc.counters()["dict_hash_tables"]
    table = tenc.dictionary_hashes(td, 42)
    assert tenc.counters()["dict_hash_tables"] == before + 1
    np.testing.assert_array_equal(
        _u32(table.numpy()), _u32(jenc.dictionary_hashes(jd, 42)))
    per_row = tenc.dict_take(table, td.codes)
    dec = tenc.materialize_column(td)
    row_hash = th.murmur3_string(dec, 42)
    ok = td.validity.numpy()
    np.testing.assert_array_equal(_u32(per_row.numpy())[ok],
                                  _u32(row_hash.numpy())[ok])


def test_xxhash64_string_with_row_seeds_and_fixed_lanes():
    j, t = both_column(probe_values(6), "STRING")
    rng = np.random.default_rng(6)
    seeds = rng.integers(0, 2**64, t.capacity, dtype=np.uint64)
    want = _u64(jh.xxhash64_string(j, jnp.asarray(seeds)))
    got = th.xxhash64_string(t, torch.from_numpy(seeds.view(np.int64)))
    np.testing.assert_array_equal(_u64(got.numpy()), want)
    ints = rng.integers(-2**31, 2**31, 500).astype(np.int32)
    longs = rng.integers(-2**63, 2**63, 500, dtype=np.int64)
    s = seeds[:500]
    np.testing.assert_array_equal(
        _u64(th.xxhash64_int(torch.from_numpy(ints),
                             torch.from_numpy(s.view(np.int64))).numpy()),
        _u64(jh.xxhash64_int(jnp.asarray(ints), jnp.asarray(s))))
    np.testing.assert_array_equal(
        _u64(th.xxhash64_long(torch.from_numpy(longs),
                              torch.from_numpy(s.view(np.int64))).numpy()),
        _u64(jh.xxhash64_long(jnp.asarray(longs), jnp.asarray(s))))


@pytest.mark.parametrize("n", [1, 7, 200, 1 << 10])
def test_pmod_matches_jax(n):
    rng = np.random.default_rng(n)
    h = rng.integers(-2**63, 2**63, 3000, dtype=np.int64)
    h[:3] = [-1, 0, np.iinfo(np.int64).min]
    np.testing.assert_array_equal(th.pmod(torch.from_numpy(h), n).numpy(),
                                  np.asarray(jh.pmod(jnp.asarray(h), n)))


def test_padded_capacity_rows_pass_the_seed():
    """Rows past the logical count are invalid: both hashes leave the
    running hash there, as for nulls."""
    j, t = both_column(["abc", None, "é"], "STRING", capacity=256)
    np.testing.assert_array_equal(th.xxhash64_batch([t], 42).numpy(),
                                  np.asarray(jh.xxhash64_batch([j], 42)))
    got = th.xxhash64_batch([t], 42).numpy()
    assert (got[3:] == 42).all() and got[1] == 42


@pytest.mark.parametrize("source", ["probe strings", "customer names"])
def test_chip_smoke_numpy_references_match_jax(source):
    """The host references chip_smoke.py holds the card to are Spark's
    hashes: equal to the JAX package's on the same rows."""
    if source == "probe strings":
        mat, lengths = cs.hash_probe_strings()
    else:
        mat = cs.customer_names(3000)
        lengths = np.full(len(mat), mat.shape[1], np.int64)
    values = [bytes(mat[i, :lengths[i]]) for i in range(len(lengths))]
    j, t = both_column(values, "STRING")
    n = len(values)
    np.testing.assert_array_equal(
        cs.np_xxhash64_bytes(mat, lengths, 42),
        _u64(jh.xxhash64_batch([j], 42))[:n])
    np.testing.assert_array_equal(
        cs.np_murmur3_bytes(mat, lengths, 42),
        _u32(jh.murmur3_string(j, jnp.full((t.capacity,), 42,
                                           jnp.uint32)))[:n])
