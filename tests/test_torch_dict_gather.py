"""The dictionary gather (ops/dict_gather.py) against the TPU kernel it
replaces and the JAX package's dict_take.

`dg` is inline in tools/exp_gather.py's main() (lines 160-182: the body
`kern` is `jnp.take_along_axis` over a table held whole in VMEM, the
`pallas_call` at :170); it is rebuilt here as written there, at a reduced
table of R = 256 rows instead of 4096, and run in interpret mode. The
plain version must equal it, `jnp.take_along_axis` and the JAX
`dict_take` exactly (integers and bools: no tolerance). The kernel itself
runs only on a card: chip_smoke.py holds it against the plain version.
The host-side choices of its launch (`plan` and its parts) are pure
functions, tested here at the shapes chip_smoke.py gives them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from spark_rapids_tpu.columnar import encoded as jenc
from spark_rapids_tpu_torch.columnar import encoded as tenc
from spark_rapids_tpu_torch.ops import dict_gather as dg

from test_torch_jax_ref import jax_aliases

#: an H100's SM count
H100_SMS = 132


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _dg(R, S):
    """tools/exp_gather.py's `dg` (lines 158-182) at R table rows and S
    index rows, in interpret mode."""
    def kern(t_ref, i_ref, o_ref):
        o_ref[:] = jnp.take_along_axis(t_ref[:], i_ref[:], axis=0)

    BLK = R

    def run(tbl, ii):
        with jax.enable_x64(False):
            return pl.pallas_call(
                kern,
                out_shape=jax.ShapeDtypeStruct((S, 128), jnp.int32),
                grid=(S // BLK,),
                in_specs=[
                    pl.BlockSpec((R, 128), lambda i: (0, 0),
                                 memory_space=pltpu.VMEM),
                    pl.BlockSpec((BLK, 128), lambda i: (i, 0),
                                 memory_space=pltpu.VMEM),
                ],
                out_specs=pl.BlockSpec((BLK, 128), lambda i: (i, 0),
                                       memory_space=pltpu.VMEM),
                interpret=True,
            )(tbl, ii)
    return run


def test_plain_equals_dg_pallas_kernel():
    R, S = 256, 1024
    rng = np.random.default_rng(0)
    table = rng.integers(0, 1 << 30, (R, 128), dtype=np.int32)
    idx = rng.integers(0, R, (S, 128), dtype=np.int32)
    want = np.asarray(_dg(R, S)(jnp.asarray(table), jnp.asarray(idx)))
    got = dg.dict_gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,lanes,dtype", [
    (4096, 128, np.int32), (7, 1, np.bool_), (300, 5, np.int8),
    (1000, 3, np.float32), (1, 2, np.uint8)])
def test_plain_equals_take_along_axis_with_clamp(n, lanes, dtype):
    rng = np.random.default_rng(n + lanes)
    if dtype == np.bool_:
        table = rng.random((n, lanes)) > 0.5
    elif dtype == np.float32:
        table = rng.normal(0, 1e3, (n, lanes)).astype(np.float32)
    else:
        info = np.iinfo(dtype)
        table = rng.integers(info.min, info.max, (n, lanes), dtype=dtype,
                             endpoint=True)
    idx = rng.integers(-3, n + 3, (777, lanes)).astype(np.int32)
    idx[::5] = -1                            # NULL_CODE
    idx[::7] = np.iinfo(np.int32).max
    idx[::11] = np.iinfo(np.int32).min
    want = np.asarray(jnp.take_along_axis(
        jnp.asarray(table), jnp.clip(jnp.asarray(idx), 0, n - 1), axis=0))
    got = dg.dict_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.from_numpy(table).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.bool_, np.int32])
def test_dict_take_equals_jax_dict_take(dtype):
    rng = np.random.default_rng(3)
    n = 128
    table = (rng.random(n) > 0.7) if dtype == np.bool_ else \
        rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    codes = rng.integers(-1, n + 2, 5000).astype(np.int32)
    want = np.asarray(jenc.dict_take(jnp.asarray(table), jnp.asarray(codes)))
    got = tenc.dict_take(torch.from_numpy(table), torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_runs_the_plain_version_and_empty_inputs_launch_nothing():
    dg.dict_gather.launches = 0
    table = torch.arange(10, dtype=torch.int32).reshape(5, 2)
    idx = torch.tensor([[4, -1], [9, 0]], dtype=torch.int32)
    # 9 clamps to entry 4 and -1 to entry 0, each in its own lane
    assert dg.dict_gather(table, idx).tolist() == [[8, 1], [8, 1]]
    empty = dg.dict_gather(table, torch.empty((0, 2), dtype=torch.int32))
    assert empty.shape == (0, 2) and empty.dtype == torch.int32
    # a table with no entry cannot answer a row, but no row needs none
    assert dg.dict_gather(torch.empty((0, 1), dtype=torch.bool),
                          torch.empty((0, 1), dtype=torch.int32)).numel() == 0
    assert dg.dict_gather.launches == 0


@pytest.mark.parametrize("table,idx,err", [
    (torch.zeros((4, 2), dtype=torch.int64),
     torch.zeros((3, 2), dtype=torch.int32), TypeError),
    (torch.zeros((4, 2), dtype=torch.int32),
     torch.zeros((3, 2), dtype=torch.int64), TypeError),
    (torch.zeros((4, 2), dtype=torch.int32),
     torch.zeros((3, 3), dtype=torch.int32), ValueError),
    (torch.zeros(4, dtype=torch.int32),
     torch.zeros(3, dtype=torch.int32), ValueError),
    (torch.zeros((0, 1), dtype=torch.int32),
     torch.zeros((3, 1), dtype=torch.int32), ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(table, idx, err):
    with pytest.raises(err):
        dg.dict_gather(table, idx)


@pytest.mark.parametrize("n,lanes,elt,want", [
    (128, 1, 1, True),          # a hit mask: staged whole
    (150, 1, 1, True),          # Q19's largest dictionary
    (4096, 1, 1, True),         # exactly STAGE_BYTES
    (1024, 1, 4, True),
    (4097, 1, 1, False),        # one byte over: read through L2
    (1 << 20, 1, 4, False),
    (4096, 128, 4, False),      # dg: 2 MB, read through L2
    (7, 128, 1, False),         # multi-lane tables are never staged
    (300, 5, 1, False),
])
def test_lanes_per_block(n, lanes, elt, want):
    # the staging decision: a block holds the whole one-lane table or none
    staged = dg.staged(n, lanes, elt)
    assert staged is want
    assert not staged or n * elt <= dg.STAGE_BYTES


@pytest.mark.parametrize("lanes,want", [
    (1, 4), (2, 4), (4, 4), (128, 4), (3, 1), (5, 1), (12, 1)])
def test_vector_width(lanes, want):
    assert dg.vector_width(lanes) == want


@pytest.mark.parametrize("elt", [1, 4])
@pytest.mark.parametrize("offset,total,want", [
    (0, 1000, (0, 250, 0)),     # aligned, a multiple of four
    (0, 1003, (0, 250, 3)),     # a scalar tail
    (1, 1000, (3, 249, 1)),     # x[1:] of a one-lane index: 3 to the boundary
    (2, 1000, (2, 249, 2)),
    (3, 1000, (1, 249, 3)),
    (1, 2, (2, 0, 0)),          # shorter than the head
    (0, 0, (0, 0, 0)),
])
def test_align_split_with_the_output_at_the_index_phase(elt, offset, total,
                                                         want):
    # the wrapper allocates the output `offset` elements into a buffer
    # whose base is aligned, as the index pointer is `offset` int32s past
    # a 16-byte boundary
    base = 1 << 20
    assert dg.align_split(base + 4 * offset, base + elt * offset, elt,
                          total) == want


def test_align_split_with_mismatched_phases_is_all_scalar():
    assert dg.align_split(4, 0, 4, 1000) == (1000, 0, 0)
    assert dg.align_split(0, 1, 1, 1000) == (1000, 0, 0)


@pytest.mark.parametrize("work,want", [
    (2_097_152, 1056),          # Q19's take over 8,388,608 codes: one wave
    (524_288, 1056),            # dg's 2,097,152 elements
    (65_536, 256),              # the 262,144-code takes
    (256, 1),                   # the 1,024-slot candidate bucket
    (3000, 12),                 # a scalar launch over 3,000 elements
    (0, 1),
])
def test_grid_shape(work, want):
    assert dg.grid_shape(work, H100_SMS) == want


@pytest.mark.parametrize("n,lanes,elt,rows,offset,want", [
    # Q19's 1-byte takes: the flat kernel, the hit mask staged
    (150, 1, 1, 8_388_608, 0, (dg.FLAT, True, 0, 0, 2_097_152, 1056)),
    (150, 1, 1, 262_144, 0, (dg.FLAT, True, 0, 0, 65_536, 256)),
    (150, 1, 1, 1024, 1, (dg.FLAT, True, 0, 3, 255, 1)),
    # a one-lane table over STAGE_BYTES stays in global memory
    (1 << 20, 1, 4, 65_537, 0, (dg.FLAT, False, 0, 0, 16_384, 64)),
    # dg's shape: the table in L2, lanes by mask
    (4096, 128, 4, 16_384, 0, (dg.FLAT, False, 7, 0, 524_288, 1056)),
    # an unaligned multi-lane view: a head of 3 elements
    (4096, 128, 4, 100, 1, (dg.FLAT, False, 7, 3, 3199, 13)),
    (4096, 3, 4, 1000, 0, (dg.SCALAR, False, 0, 0, 0, 12)),
])
def test_plan(n, lanes, elt, rows, offset, want):
    base = 1 << 20
    assert tuple(dg.plan(n, lanes, elt, rows, base + 4 * offset,
                         base + elt * offset, H100_SMS)) == want
