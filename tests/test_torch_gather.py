"""Parity of the port's packed rows and row gathers with the JAX package:

- `rowpack.pack_rows` builds the same u32 and f64 matrices bit for bit,
  and `unpack_rows` inverts it;
- the plain row gather (`rowpack.gather_rows`, also what
  `row_gather.pallas_gather_rows` and `dma_row_gather` run on CPU tensors)
  against the JAX XLA formulation and the JAX Pallas kernel in interpret
  mode, with -1 and out-of-range indices, f64 lanes and NaN payloads;
- the gather engine (`gather_batch_columns`) and the compaction helpers of
  ops/basic.py against their JAX counterparts.

Everything here is exact: gathers move bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.ops import basic as jbasic
from spark_rapids_tpu.ops import gather as jgather
from spark_rapids_tpu.ops import pallas_gather as jpg
from spark_rapids_tpu.ops import rowpack as jrp

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar.column import Column as TColumn
from spark_rapids_tpu_torch.ops import basic as tbasic
from spark_rapids_tpu_torch.ops import gather as tgather
from spark_rapids_tpu_torch.ops import row_gather as trg
from spark_rapids_tpu_torch.ops import rowpack as trp

from test_torch_jax_ref import jax_aliases

CAP = 1024
TYPES = ["LONG", "DOUBLE", "INT", "BOOLEAN", "SHORT", "FLOAT", "DOUBLE",
         "BYTE", "TIMESTAMP", "DATE"]


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _values(rng, n, type_name):
    if type_name == "BOOLEAN":
        return rng.integers(0, 2, n).astype(np.bool_)
    if type_name in ("FLOAT", "DOUBLE"):
        v = rng.normal(0, 1e3, n)
        v[::9] = np.nan
        v[::10] = -0.0
        return v.astype(np.float32 if type_name == "FLOAT" else np.float64)
    np_dtype = getattr(tt, type_name).np_dtype
    info = np.iinfo(np_dtype)
    return rng.integers(info.min, info.max, n, dtype=np_dtype)


def _columns(seed, types=TYPES, n=CAP - 100):
    rng = np.random.default_rng(seed)
    jcols, tcols = [], []
    for type_name in types:
        jc = JColumn.from_numpy(_values(rng, n, type_name),
                                getattr(jt, type_name),
                                validity=rng.random(n) > 0.2, capacity=CAP)
        jcols.append(jc)
        tcols.append(TColumn(torch.from_numpy(np.asarray(jc.data).copy()),
                             torch.from_numpy(np.asarray(jc.validity).copy()),
                             getattr(tt, type_name)))
    return jcols, tcols


def _indices(seed, n_out):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, CAP, n_out).astype(np.int32)
    idx[::5] = -1
    idx[::7] = CAP + rng.integers(0, 50)
    idx[::11] = np.iinfo(np.int32).min
    return idx


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def _assert_columns_equal(tcols, jcols):
    assert len(tcols) == len(jcols)
    for tc, jc in zip(tcols, jcols):
        np.testing.assert_array_equal(tc.validity.numpy(),
                                      np.asarray(jc.validity))
        np.testing.assert_array_equal(_bits(tc.data.numpy()),
                                      _bits(jc.data))


def test_pack_rows_bit_identical_and_unpack_inverts():
    jcols, tcols = _columns(1)
    jplan, jimat, jfmat = jrp.pack_rows(jcols)
    tplan, timat, tfmat = trp.pack_rows(tcols)
    assert tplan.kinds == jplan.kinds
    assert (tplan.n_valid_lanes, tplan.n_data_lanes, tplan.n_f_lanes) == \
        (jplan.n_valid_lanes, jplan.n_data_lanes, jplan.n_f_lanes)
    assert timat.dtype == torch.int32
    np.testing.assert_array_equal(timat.numpy().view(np.uint32),
                                  np.asarray(jimat))
    np.testing.assert_array_equal(_bits(tfmat.numpy()), _bits(jfmat))
    _assert_columns_equal(trp.unpack_rows(tplan, timat, tfmat),
                          jrp.unpack_rows(jplan, jimat, jfmat))
    only = [0, 3, 6]
    _assert_columns_equal(trp.unpack_rows(tplan, timat, tfmat, only=only),
                          jrp.unpack_rows(jplan, jimat, jfmat, only=only))


def test_pack_rows_more_than_32_columns():
    jcols, tcols = _columns(2, types=["INT", "DOUBLE"] * 20)
    jplan, jimat, jfmat = jrp.pack_rows(jcols)
    tplan, timat, tfmat = trp.pack_rows(tcols)
    assert tplan.n_valid_lanes == jplan.n_valid_lanes == 2
    np.testing.assert_array_equal(timat.numpy().view(np.uint32),
                                  np.asarray(jimat))


@pytest.mark.parametrize("n_out", [1, 777, 2 * CAP])
def test_plain_gather_matches_xla_and_interpret_kernel(n_out):
    jcols, tcols = _columns(n_out)
    jplan, jimat, jfmat = jrp.pack_rows(jcols)
    tplan, timat, tfmat = trp.pack_rows(tcols)
    idx = _indices(n_out, n_out)
    jx, jxf = jrp.gather_rows(jplan, jimat, jfmat, jnp.asarray(idx))
    jk, jkf = jpg.pallas_gather_rows(jplan, jimat, jfmat, jnp.asarray(idx),
                                     interpret=True)
    np.testing.assert_array_equal(np.asarray(jk), np.asarray(jx))
    np.testing.assert_array_equal(_bits(jkf), _bits(jxf))
    for fn in (trp.gather_rows, trg.pallas_gather_rows, tgather.gather_rows):
        ti, tf = fn(tplan, timat, tfmat, torch.from_numpy(idx))
        np.testing.assert_array_equal(ti.numpy().view(np.uint32),
                                      np.asarray(jx))
        np.testing.assert_array_equal(_bits(tf.numpy()), _bits(jxf))


def test_dma_row_gather_matches_interpret_kernel():
    rng = np.random.default_rng(3)
    mat = rng.integers(0, 1 << 32, (CAP, 5), dtype=np.uint64) \
        .astype(np.uint32)
    idx = rng.integers(0, CAP, 900).astype(np.int32)
    want = np.asarray(jpg.dma_row_gather(jnp.asarray(mat), jnp.asarray(idx),
                                         interpret=True))
    got = trg.dma_row_gather(torch.from_numpy(mat.view(np.int32)),
                             torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # outside [0, cap) reads row 0, as the kernel's contract says
    bad = torch.tensor([-1, CAP, 2 ** 31 - 1], dtype=torch.int32)
    got = trg.dma_row_gather(torch.from_numpy(mat.view(np.int32)), bad)
    assert (got.numpy().view(np.uint32) == mat[0]).all()


def test_gather_batch_columns_matches_jax():
    jcols, tcols = _columns(4)
    idx = _indices(4, 1500)
    n = 1200
    want = jgather.gather_batch_columns(jcols, jnp.asarray(idx),
                                        num_rows=jnp.int32(n))
    got = tgather.gather_batch_columns(tcols, torch.from_numpy(idx),
                                       num_rows=torch.tensor(n))
    _assert_columns_equal(got, want)
    keep = np.random.default_rng(5).random(1500) > 0.5
    want = jgather.gather_batch_columns(jcols[:1], jnp.asarray(idx),
                                        out_valid=jnp.asarray(keep))
    got = tgather.gather_batch_columns(tcols[:1], torch.from_numpy(idx),
                                       out_valid=torch.from_numpy(keep))
    _assert_columns_equal(got, want)


def test_gather_lane_matrix_and_column_match_jax():
    rng = np.random.default_rng(6)
    mat = rng.integers(-100, 100, (CAP, 3)).astype(np.int32)
    idx = _indices(6, 600)
    np.testing.assert_array_equal(
        tgather.gather_lane_matrix(torch.from_numpy(mat),
                                   torch.from_numpy(idx)).numpy(),
        np.asarray(jgather.gather_lane_matrix(jnp.asarray(mat),
                                              jnp.asarray(idx))))
    jcols, tcols = _columns(7, types=["DOUBLE", "SHORT"])
    keep = rng.random(600) > 0.3
    for jc, tc in zip(jcols, tcols):
        _assert_columns_equal(
            [tbasic.gather_column(tc, torch.from_numpy(idx),
                                  torch.from_numpy(keep))],
            [jbasic.gather_column(jc, jnp.asarray(idx), jnp.asarray(keep))])


@pytest.mark.parametrize("num_rows", [0, 500, CAP])
def test_compaction_matches_jax(num_rows):
    rng = np.random.default_rng(num_rows)
    keep = rng.random(CAP) > 0.4
    jperm, jn = jbasic.compaction_order(jnp.asarray(keep),
                                        jnp.int32(num_rows))
    tperm, tn = tbasic.compaction_order(torch.from_numpy(keep),
                                        torch.tensor(num_rows))
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    jm, _ = jbasic.masked_compaction_order(jnp.asarray(keep),
                                           jnp.int32(num_rows))
    tm, _ = tbasic.masked_compaction_order(torch.from_numpy(keep),
                                           torch.tensor(num_rows))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    jcols, tcols = _columns(num_rows + 1)
    jout, jn = jbasic.compact_columns(jcols, jnp.asarray(keep),
                                      jnp.int32(num_rows))
    tout, tn = tbasic.compact_columns(tcols, torch.from_numpy(keep),
                                      torch.tensor(num_rows))
    assert int(tn) == int(jn)
    _assert_columns_equal(tout, jout)


def test_slice_rows_matches_jax():
    jcols, tcols = _columns(8, types=["LONG", "FLOAT"])
    for start, length, cap in ((0, 10, 128), (100, 300, 512), (900, 300, 256)):
        for jc, tc in zip(jcols, tcols):
            _assert_columns_equal(
                [tbasic.slice_rows(tc, start, length, cap)],
                [jbasic.slice_rows(jc, start, length, cap)])


def test_cpu_gathers_count_no_launch_and_engine_counts_gathers():
    trg.dma_row_gather.launches = 0
    before = tgather.counters()
    _, tcols = _columns(9)
    tbasic.compact_columns(tcols, torch.ones(CAP, dtype=torch.bool),
                           torch.tensor(CAP))
    after = tgather.counters()
    assert after["count"] == before["count"] + 1
    assert after["packed_count"] == before["packed_count"] + 1
    assert after["kernel_count"] == before["kernel_count"]
    assert trg.dma_row_gather.launches == 0


def test_gather_wrappers_check_inputs_and_refuse_other_devices():
    mat = torch.zeros((16, 2), dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        trg.dma_row_gather(mat.to(torch.int64), idx)
    with pytest.raises(ValueError):
        trg.dma_row_gather(mat[:, 0], idx)
    with pytest.raises(ValueError):
        trg.dma_row_gather(mat.to("meta"), idx.to("meta"))


# -- the kernel's host-side choices (ops/row_gather.plan) -------------------

@pytest.mark.parametrize("lanes, addrs, words", [
    (4, (0, 16), 4), (4, (0, 8), 2), (4, (0, 4), 1), (8, (32, 64), 4),
    (3, (0, 16), 1), (2, (0, 8), 2), (6, (0, 16), 2), (6, (4, 16), 1),
    (1, (4,), 1)])
def test_row_gather_vector_words(lanes, addrs, words):
    assert trg.vector_words(lanes, *addrs) == words


# every (la, lb) that q3 (LONG or INT keys) and q19 pack: the build
# permute and payload, the stream payload, the group-by and TopN sorts
MAIN_PATH_WIDTHS = [(4, 0), (4, 4), (3, 2), (3, 6), (3, 0), (3, 4), (2, 2)]


@pytest.mark.parametrize("la, lb", MAIN_PATH_WIDTHS)
def test_row_gather_main_path_widths_take_a_fixed_kernel(la, lb):
    kind = trg.kernel_kind(la, lb, (256, 4096), (512, 8192) if lb else ())
    assert kind != trg.ANY and trg.kind_name(kind) == f"{la}_{lb}"
    # off the pieces' alignment a width goes to the generic kernel unless
    # its pieces are single words anyway
    off = trg.kernel_kind(la, lb, (260, 4096), (516, 8192) if lb else ())
    assert off == (kind if la == 3 and lb in (0,) else trg.ANY)


@pytest.mark.parametrize("la, lb", [(5, 6), (2, 0), (1, 0), (4, 2), (8, 0)])
def test_row_gather_other_widths_take_the_generic_kernel(la, lb):
    kind = trg.kernel_kind(la, lb, (0, 0), (0, 0) if lb else ())
    assert kind == trg.ANY and trg.kind_name(kind) == "any"


def test_row_gather_offsets_widen_only_past_int32():
    grid = 1056
    assert not trg.index_wide(1 << 21, 1 << 21, 8, grid)
    assert trg.index_wide(1 << 28, 1 << 10, 8, grid)      # n * lanes
    assert trg.index_wide(1 << 10, 1 << 28, 8, grid)      # cap * lanes
    # the index prefetch runs a step past the last row
    n = (1 << 31) - trg.ROWS * grid * trg.THREADS
    assert trg.index_wide(n, 1, 1, grid)


@pytest.mark.parametrize("n, grid", [(1, 1), (1000, 1), (70_001, 69),
                                     (3 * (1 << 18) + 3, 132 * 8)])
def test_row_gather_grid_stride_visits_every_row_once(n, grid):
    """The kernel's loop: thread t of block b takes rows r0 + k * stride
    (k < ROWS) and steps r0 by ROWS * stride while r0 < n."""
    stride = grid * trg.THREADS
    r0 = torch.arange(stride, dtype=torch.int64)
    seen = []
    while bool((r0 < n).any()):
        live = r0 < n
        for k in range(trg.ROWS):
            r = r0[live] + k * stride
            seen.append(r[r < n])
        r0 = r0 + trg.ROWS * stride
    rows = torch.cat(seen).sort().values
    assert torch.equal(rows, torch.arange(n, dtype=torch.int64))
    assert trg.grid_shape(n, 132, 8) == min(-(-n // (trg.THREADS * trg.ROWS)),
                                            132 * 8)


def test_row_gather_plan_uses_the_card_limits():
    seen = []

    def limits(kind, wide):
        seen.append((kind, wide))
        return 132, 8

    p = trg.plan(2_097_152, 524_288, 4, 0, (0, 0), (), limits)
    assert p == trg.Plan(trg.FIXED[(4, 4, 0, 1)], False, 132 * 8)
    assert seen == [(p.kind, False)]
    p = trg.plan(100, 5000, 5, 6, (0, 0), (0, 0), limits)
    assert p == trg.Plan(trg.ANY, False, 1)
