"""Parity of the port's murmur3 (ops/hashing.py, ops/murmur3_lanes.py)
with the JAX package, bit for bit:

- the plain per-lane hashes against the JAX package's XLA formulation and
  against its Pallas kernels `murmur3_long_lanes` / `murmur3_int_lanes`
  run in interpret mode;
- `murmur3_column` for every fixed-width type (negative values, NaN,
  -0.0, nulls) and `murmur3_batch` chaining columns;
- the join bucket hash pair.

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
    v = torch.arange(300, dtype=torch.int64)
    s = torch.zeros(300, dtype=torch.int32)
    tml.murmur3_long_lanes(v, s)
    tml.murmur3_int_lanes(v.to(torch.int32), s)
    th.murmur3_batch([TColumn(v, torch.ones(300, dtype=torch.bool), tt.LONG)])
    assert tml.murmur3_long_lanes.launches == 0
    assert tml.murmur3_int_lanes.launches == 0


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
