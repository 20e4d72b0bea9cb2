"""Parity of the port's murmur3 (ops/hashing.py, ops/murmur3_lanes.py)
with the JAX package, bit for bit:

- the plain per-lane hashes against the JAX package's XLA formulation and
  against its Pallas kernels `murmur3_long_lanes` / `murmur3_int_lanes`
  run in interpret mode;
- `murmur3_column` for every fixed-width type (negative values, NaN,
  -0.0, nulls) and `murmur3_batch` chaining columns;
- the join bucket hash pair;
- key lists of mixed kinds (every fixed-width type, nulls, -0.0, NaN,
  negative values) through `murmur3_batch` and the chain wrapper
  `murmur3_columns`: chains of 1 and 4 columns and longer than one
  launch, capacity 0 and ragged capacities, two seeds against two one-seed
  calls, per-row seed planes;
- the kernel's launch plan (`plan` and its parts) on the host.

On CPU tensors the wrappers run their plain versions and count no launch;
on a device other than cuda or cpu they raise instead of falling back.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.ops import hashing as jh
from spark_rapids_tpu.ops import join as jjoin
from spark_rapids_tpu.ops import pallas_kernels as jpk

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar.column import Column as TColumn
from spark_rapids_tpu_torch.ops import hashing as th
from spark_rapids_tpu_torch.ops import join as tjoin
from spark_rapids_tpu_torch.ops import murmur3_lanes as tml

from test_torch_jax_ref import jax_aliases

CAP = 2048


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _u32(x):
    """Any 32-bit lane (JAX uint32 or torch int32 bits) as numpy uint32."""
    return np.asarray(x).view(np.uint32) if np.asarray(x).dtype.itemsize \
        == 4 else np.asarray(x).astype(np.uint32)


def _values(rng, n, dtype):
    info = np.iinfo(dtype)
    v = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    edges = np.array([0, -1, info.min, info.max], dtype=dtype)
    v[: min(n, 4)] = edges[: min(n, 4)]
    return v


@pytest.mark.parametrize("n", [1, 1000, 70_001])
def test_long_lanes_plain_matches_xla_and_interpret_kernel(n):
    rng = np.random.default_rng(n)
    data = _values(rng, n, np.int64)
    seeds = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    want = _u32(jh.murmur3_long(jnp.asarray(data), jnp.asarray(seeds)))
    kern = _u32(jpk.murmur3_long_lanes(jnp.asarray(data), jnp.asarray(seeds),
                                       interpret=True))
    got = tml.murmur3_long_lanes(torch.from_numpy(data),
                                 torch.from_numpy(seeds.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got.numpy()), want)
    np.testing.assert_array_equal(kern, want)


@pytest.mark.parametrize("n", [1, 1000, 70_001])
def test_int_lanes_plain_matches_xla_and_interpret_kernel(n):
    rng = np.random.default_rng(n + 1)
    data = _values(rng, n, np.int32)
    seeds = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    want = _u32(jh.murmur3_int(jnp.asarray(data), jnp.asarray(seeds)))
    kern = _u32(jpk.murmur3_int_lanes(jnp.asarray(data), jnp.asarray(seeds),
                                      interpret=True))
    got = tml.murmur3_int_lanes(torch.from_numpy(data),
                                torch.from_numpy(seeds.view(np.int32)))
    np.testing.assert_array_equal(_u32(got.numpy()), want)
    np.testing.assert_array_equal(kern, want)


def _column_values(rng, n, type_name):
    if type_name == "BOOLEAN":
        return rng.integers(0, 2, n).astype(np.bool_)
    if type_name in ("FLOAT", "DOUBLE"):
        v = rng.normal(0, 1e6, n)
        v[::7] = np.nan
        v[::11] = -0.0
        v[::13] = 0.0
        v[::17] = np.inf
        v[::19] = -np.inf
        return v.astype(np.float32 if type_name == "FLOAT" else np.float64)
    np_dtype = getattr(tt, type_name).np_dtype
    return _values(rng, n, np_dtype)


def _pair(values, type_name, valid):
    jc = JColumn.from_numpy(values, getattr(jt, type_name), validity=valid,
                            capacity=CAP)
    tc = TColumn(torch.from_numpy(np.asarray(jc.data).copy()),
                 torch.from_numpy(np.asarray(jc.validity).copy()),
                 getattr(tt, type_name))
    return jc, tc


TYPES = ["BOOLEAN", "BYTE", "SHORT", "INT", "DATE", "LONG", "TIMESTAMP",
         "FLOAT", "DOUBLE"]


@pytest.mark.parametrize("type_name", TYPES)
def test_murmur3_column_matches_jax(type_name):
    rng = np.random.default_rng(len(type_name))
    n = 1500
    vals = _column_values(rng, n, type_name)
    jc, tc = _pair(vals, type_name, rng.random(n) > 0.2)
    seeds = rng.integers(0, 1 << 32, CAP, dtype=np.uint64).astype(np.uint32)
    want = _u32(jh.murmur3_column(jc, jnp.asarray(seeds)))
    got = th.murmur3_column(tc, torch.from_numpy(seeds.view(np.int32)))
    np.testing.assert_array_equal(_u32(got.numpy()), want)


def test_murmur3_batch_chains_columns_like_jax():
    rng = np.random.default_rng(5)
    n = 1800
    jcols, tcols = [], []
    for type_name in ("LONG", "INT", "DOUBLE", "FLOAT", "SHORT"):
        jc, tc = _pair(_column_values(rng, n, type_name), type_name,
                       rng.random(n) > 0.1)
        jcols.append(jc)
        tcols.append(tc)
    for seed in (42, jjoin.JOIN_HASH_SEED, jjoin.JOIN_HASH_SEED2):
        want = np.asarray(jh.murmur3_batch(jcols, seed=seed))
        got = th.murmur3_batch(tcols, seed=seed)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("type_name", ["LONG", "INT"])
def test_join_hash_pair_matches_jax(type_name):
    rng = np.random.default_rng(9)
    jc, tc = _pair(_column_values(rng, 1200, type_name), type_name,
                   rng.random(1200) > 0.05)
    jhi, jlo = jjoin.join_hash_pair([jc])
    thi, tlo = tjoin.join_hash_pair([tc])
    np.testing.assert_array_equal(_u32(thi.numpy()), _u32(jhi))
    np.testing.assert_array_equal(_u32(tlo.numpy()), _u32(jlo))
    only_hi, none = tjoin.join_hash_pair([tc], lo_too=False)
    assert none is None
    assert torch.equal(only_hi, thi)


def test_plain_helpers_hold_32_bit_arithmetic():
    """Products and rotations stay in [0, 2^32) on int64 tensors, and the
    u32 <-> int32-bits conversions are inverse."""
    u = torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                     dtype=torch.int64)
    assert torch.equal(th.u32_of(th.i32_bits(u)), u)
    for r in (13, 15):
        x = th._rotl32(u, r)
        assert bool(((x >= 0) & (x <= 0xFFFFFFFF)).all())
        want = [((int(v) << r) | (int(v) >> (32 - r))) & 0xFFFFFFFF
                for v in u]
        assert x.tolist() == want


def test_cpu_wrappers_count_no_launch():
    tml.murmur3_long_lanes.launches = 0
    tml.murmur3_int_lanes.launches = 0
    tml.murmur3_columns.launches = 0
    v = torch.arange(300, dtype=torch.int64)
    s = torch.zeros(300, dtype=torch.int32)
    tml.murmur3_long_lanes(v, s)
    tml.murmur3_int_lanes(v.to(torch.int32), s)
    col = TColumn(v, torch.ones(300, dtype=torch.bool), tt.LONG)
    th.murmur3_batch([col])
    th.murmur3_column(col, s)
    tml.murmur3_columns([col] * 6, [1, 2])
    tjoin.join_hash_pair([col])
    assert tml.murmur3_long_lanes.launches == 0
    assert tml.murmur3_int_lanes.launches == 0
    assert tml.murmur3_columns.launches == 0


def test_wrappers_check_inputs_and_refuse_other_devices():
    v = torch.arange(8, dtype=torch.int64)
    s = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        tml.murmur3_long_lanes(v.to(torch.int32), s)
    with pytest.raises(ValueError):
        tml.murmur3_int_lanes(v.to(torch.int32), s[:4])
    with pytest.raises(ValueError):
        tml.murmur3_long_lanes(v.to("meta"), s.to("meta"))

    class Opaque(tt.DataType):
        pass

    with pytest.raises(NotImplementedError):
        th.murmur3_column(TColumn(torch.zeros(4, dtype=torch.int32),
                                  torch.ones(4, dtype=torch.bool),
                                  Opaque()), s[:4])


# -- the chain over mixed key lists -------------------------------------------

def _ragged_pair(rng, type_name, cap):
    """A column of exactly `cap` rows (any capacity, 0 included) in both
    packages, ~20% nulls."""
    vals = _column_values(rng, cap, type_name)
    valid = rng.random(cap) > 0.2
    jc = JColumn(jnp.asarray(vals), jnp.asarray(valid), getattr(jt, type_name))
    tc = TColumn(torch.from_numpy(vals.copy()), torch.from_numpy(valid),
                 getattr(tt, type_name))
    return jc, tc


#: key lists: one column, four (one launch), six and nine (more than one
#: launch of at most MAX_COLS columns), every kind among them
KEY_LISTS = {
    "one": ["LONG"],
    "four": ["BOOLEAN", "DOUBLE", "SHORT", "INT"],
    "six": ["BYTE", "FLOAT", "TIMESTAMP", "DATE", "DOUBLE", "LONG"],
    "nine": TYPES,
}


@pytest.mark.parametrize("cap", [0, 1, 9, 2049])
@pytest.mark.parametrize("keys", list(KEY_LISTS))
def test_murmur3_batch_of_mixed_key_lists_matches_jax(keys, cap):
    rng = np.random.default_rng(cap + len(keys))
    pairs = [_ragged_pair(rng, name, cap) for name in KEY_LISTS[keys]]
    jcols, tcols = [p[0] for p in pairs], [p[1] for p in pairs]
    for seed in (42, jjoin.JOIN_HASH_SEED2):
        want = np.asarray(jh.murmur3_batch(jcols, seed=seed))
        got = th.murmur3_batch(tcols, seed=seed)
        assert got.dtype == torch.int32 and got.shape == (cap,)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("keys", ["one", "six"])
def test_two_seeds_equal_two_one_seed_calls(keys):
    rng = np.random.default_rng(17)
    pairs = [_ragged_pair(rng, name, 3001) for name in KEY_LISTS[keys]]
    tcols = [p[1] for p in pairs]
    seeds = (jjoin.JOIN_HASH_SEED, jjoin.JOIN_HASH_SEED2)
    both = tml.murmur3_columns(tcols, seeds)
    for h, seed in zip(both, seeds):
        assert torch.equal(h, th.murmur3_batch(tcols, seed=seed))
        np.testing.assert_array_equal(
            h.numpy(), np.asarray(jh.murmur3_batch([p[0] for p in pairs],
                                                   seed=seed)))


def test_per_row_seed_planes_chain_like_jax_columns():
    """Seeds given as per-row running hashes: the chain continues them as
    the JAX package's murmur3_column does, column after column."""
    rng = np.random.default_rng(23)
    pairs = [_ragged_pair(rng, name, 1500) for name in KEY_LISTS["six"]]
    planes = [rng.integers(0, 1 << 32, 1500, dtype=np.uint64)
              .astype(np.uint32) for _ in range(2)]
    got = tml.murmur3_columns([p[1] for p in pairs],
                              [torch.from_numpy(x.view(np.int32))
                               for x in planes])
    for h, plane in zip(got, planes):
        want = jnp.asarray(plane)
        for jc, _ in pairs:
            want = jh.murmur3_column(jc, want)
        np.testing.assert_array_equal(_u32(h.numpy()), _u32(want))


def test_a_long_chain_continues_from_per_row_seeds():
    """What the kernel does past MAX_COLS columns: the next launch takes
    the running hashes as per-row seeds. The groups cover the list in
    order, and the continued chain equals the whole one."""
    assert [(g.start, g.stop) for g in tml.column_groups(9)] == \
        [(0, 4), (4, 8), (8, 9)]
    assert [(g.start, g.stop) for g in tml.column_groups(4)] == [(0, 4)]
    rng = np.random.default_rng(29)
    tcols = [_ragged_pair(rng, name, 777)[1] for name in TYPES]
    h = [42, 7]
    for g in tml.column_groups(len(tcols)):
        h = tml.murmur3_columns(tcols[g], h)
    whole = tml.murmur3_columns(tcols, [42, 7])
    assert all(torch.equal(a, b) for a, b in zip(h, whole))


def test_float_keys_normalise_like_jax():
    """-0.0 hashes as 0.0; a NaN f64 of any payload or sign as the
    canonical NaN; a NaN f32 keeps its bits, as in the JAX package."""
    d = np.array([0.0, -0.0, np.nan, 1.5, -2.0], dtype=np.float64)
    d.view(np.uint64)[2] = 0xFFF0000000000001
    f = np.array([0.0, -0.0, np.nan, 1.5, -2.0], dtype=np.float32)
    f.view(np.uint32)[2] = 0xFFC00001
    valid = np.ones(5, dtype=np.bool_)
    for vals, name in ((d, "DOUBLE"), (f, "FLOAT")):
        jc = JColumn(jnp.asarray(vals), jnp.asarray(valid), getattr(jt, name))
        tc = TColumn(torch.from_numpy(vals.copy()), torch.from_numpy(valid),
                     getattr(tt, name))
        got = th.murmur3_batch([tc]).numpy()
        np.testing.assert_array_equal(got,
                                      np.asarray(jh.murmur3_batch([jc])))
        assert got[0] == got[1]
    canon = np.array([np.nan], dtype=np.float64)
    assert canon.view(np.uint64)[0] == 0x7FF8000000000000
    tc = TColumn(torch.from_numpy(np.concatenate([d[2:3], canon])),
                 torch.ones(2, dtype=torch.bool), tt.DOUBLE)
    h = th.murmur3_batch([tc])
    assert int(h[0]) == int(h[1])


def test_chain_refuses_bad_inputs_and_other_devices():
    col = TColumn(torch.arange(8, dtype=torch.int64),
                  torch.ones(8, dtype=torch.bool), tt.LONG)
    with pytest.raises(ValueError):
        tml.murmur3_columns([], [42])
    with pytest.raises(ValueError):
        tml.murmur3_columns([col], [1, 2, 3])
    with pytest.raises(ValueError):
        tml.murmur3_columns([col], [torch.zeros(7, dtype=torch.int32)])
    with pytest.raises(TypeError):
        tml.murmur3_columns([TColumn(col.data.to(torch.int32), col.validity,
                                     tt.LONG)], [42])
    with pytest.raises(ValueError):
        tml.murmur3_columns([col, TColumn(col.data[:4], col.validity[:4],
                                          tt.LONG)], [42])
    meta = TColumn(col.data.to("meta"), col.validity.to("meta"), tt.LONG)
    for call in (lambda: th.murmur3_batch([meta]),
                 lambda: th.murmur3_column(
                     meta, torch.zeros(8, dtype=torch.int32, device="meta")),
                 lambda: tjoin.join_hash_pair([meta])):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(NotImplementedError, match="A.5"):
        tml.murmur3_columns([TColumn(col.data, col.validity, tt.STRING)],
                            [42])


# -- the launch plan ----------------------------------------------------------

def test_plan_pieces_and_head_follow_alignment():
    R = tml.ROWS
    assert tml.vector_bytes(1) == min(16, R) and tml.vector_bytes(8) == 16
    # aligned tensors: no head, the body up to the last whole chunk
    p = tml.plan(1003, [(4096, 8, 8192)], [None], [12288], (132, 6))
    assert p.head == 0 and p.body_end == 1003 // R * R
    assert p.vec == (3,) and p.vec_io == 4
    # x[1:] views of i64 data and validity: the head aligns the data (the
    # widest pointer) and the validity, the output loads element-wise
    p = tml.plan(1003, [(4096 + 8, 8, 8192 + 1)], [None], [12288], (132, 6))
    assert (4096 + 8 + 8 * p.head) % 16 == 0
    assert p.vec[0] & 1 and (p.body_end - p.head) % R == 0
    assert p.head < R and p.body_end <= 1003 < p.body_end + R
    # a seed plane and two outputs: their bits follow their alignment
    p = tml.plan(64, [(0, 4, None)], [16, 4], [32, 36], (132, 6))
    assert p.head == 0 and p.vec == (1,)
    assert p.vec_io == (1 | 4)
    # fewer rows than the head: everything is head
    p = tml.plan(2, [(4096 + 8, 8, None)], [None], [12288 + 4], (132, 6))
    assert p.head <= 2 and p.body_end == p.head


@pytest.mark.parametrize("n", [0, 1, 5, 4 * 256, 4 * 256 * 3 + 7,
                               8_388_608])
def test_plan_grid_is_one_wave_covering_every_row(n):
    sms, bps = 132, 6
    p = tml.plan(n, [(0, 8, 0)], [None], [0], (sms, bps))
    chunks = (p.body_end - p.head) // tml.ROWS
    edge = p.head + n - p.body_end
    threads = p.grid * tml.THREADS
    assert 1 <= p.grid <= sms * bps
    assert threads >= edge
    # head, body chunks and tail partition the rows
    assert p.head + chunks * tml.ROWS + (n - p.body_end) == n
    assert 0 <= n - p.body_end < tml.ROWS or n < tml.ROWS
    if chunks >= sms * bps * tml.THREADS:
        assert p.grid == sms * bps
    else:
        assert p.grid == max(1, -(-max(chunks, edge) // tml.THREADS))
