"""The port's two-limb decimal128 arithmetic (ops/decimal128.py) against
the JAX package's module and against Python ints, on the CPU.

The same random 128-bit values from a numpy seed (with the edges: 0, +-1,
the int64 bounds, the carries at 2^63 and 2^64, 10^18) go through both
modules; every limb, remainder and overflow flag must match bit for bit.
The port computes in int64 only (torch has no uint64 add, compare or
shift on the CPU), the JAX module in uint64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.ops import decimal128 as J
from spark_rapids_tpu_torch.ops import decimal128 as T

N = 2000
M64 = (1 << 64) - 1


def _edges():
    return np.array([0, 1, -1, 2**63 - 1, -2**63, 2**32, -2**32, 2**32 - 1,
                     10**18, -10**18, 2**62, -2**62], np.int64)


def _rand(rng, n=N):
    v = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
    e = _edges()
    v[: len(e)] = e
    rng.shuffle(v)
    return v


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(128)
    return {k: _rand(rng) for k in ("h1", "l1", "h2", "l2")}


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _same(j_out, t_out):
    j_out = j_out if isinstance(j_out, (tuple, list)) else (j_out,)
    t_out = t_out if isinstance(t_out, (tuple, list)) else (t_out,)
    assert len(j_out) == len(t_out)
    for a, b in zip(j_out, t_out):
        a = np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        np.testing.assert_array_equal(a.astype(b.dtype), b)


def _int128(h, l):
    u = ((int(h) & M64) << 64) | (int(l) & M64)
    return u - (1 << 128) if u >= (1 << 127) else u


@pytest.mark.parametrize("op", ["add128", "sub128", "cmp128"])
def test_binary_limb_ops_match_jax(lanes, op):
    args = [lanes[k] for k in ("h1", "l1", "h2", "l2")]
    _same(getattr(J, op)(*_j(*args)), getattr(T, op)(*_t(*args)))


@pytest.mark.parametrize("op", ["neg128", "abs128", "fits_i64", "to_f64"])
def test_unary_limb_ops_match_jax(lanes, op):
    args = [lanes["h1"], lanes["l1"]]
    _same(getattr(J, op)(*_j(*args)), getattr(T, op)(*_t(*args)))


def test_add_and_multiply_match_python_ints(lanes):
    h1, l1, h2, l2 = (lanes[k] for k in ("h1", "l1", "h2", "l2"))
    rh, rl = T.add128(*_t(h1, l1, h2, l2))
    ph, pl = T.mul_i64_i64(*_t(l1, l2))
    jh, jl = J.mul_i64_i64(*_j(l1, l2))
    _same((jh, jl), (ph, pl))
    for i in range(0, N, 7):
        want = (_int128(h1[i], l1[i]) + _int128(h2[i], l2[i])) \
            % (1 << 128)
        got = _int128(rh[i], rl[i]) % (1 << 128)
        assert got == want
        assert _int128(ph[i], pl[i]) == int(l1[i]) * int(l2[i])


@pytest.mark.parametrize("k", [0, 1, 5, 9, 10, 18, 19, 20, 38])
def test_rescale_and_fits_precision_match_jax(lanes, k):
    h1, l1 = lanes["h1"], lanes["l1"]
    rng = np.random.default_rng(k)
    small = h1 >> rng.integers(0, 64, N)       # values that may fit
    _same(J.rescale(*_j(small, l1), 0, k), T.rescale(*_t(small, l1), 0, k))
    _same(J.rescale(*_j(h1, l1), k, 0), T.rescale(*_t(h1, l1), k, 0))
    _same(J.divmod_pow10(*_j(h1, l1), k)[:3],
          T.divmod_pow10(*_t(h1, l1), k)[:3])
    p = max(k, 1)
    _same(J.fits_precision(*_j(h1, l1), p), T.fits_precision(*_t(h1, l1), p))


def test_rescale_down_rounds_half_up_like_python():
    import decimal
    vals = [0, 5, -5, 15, -15, 149, -150, 10**30 + 5, -(10**37) - 50,
            (1 << 126) + 12345]
    h = np.array([v >> 64 for v in vals], np.int64)
    l = np.array([(v & M64) - (1 << 64) if v & M64 >= 1 << 63 else v & M64
                  for v in vals], np.int64)
    for k in (1, 2, 19):
        rh, rl, over = T.rescale(*_t(h, l), k, 0)
        assert not over.any()
        with decimal.localcontext() as ctx:
            ctx.prec = 60
            for i, v in enumerate(vals):
                want = int(decimal.Decimal(v).scaleb(-k).to_integral_value(
                    rounding=decimal.ROUND_HALF_UP))
                assert _int128(rh[i], rl[i]) == want


def test_divide_round_half_up_matches_jax(lanes):
    h = lanes["h1"] >> 40          # |value| well inside 127 bits
    d = lanes["l2"].copy()
    d[d == 0] = 7
    d[d == -2**63] = 3
    _same(J.div128_round_half_up(*_j(h, lanes["l1"], d)),
          T.div128_round_half_up(*_t(h, lanes["l1"], d)))


@pytest.mark.parametrize("k", [1, 13, 32, 63])
def test_shift_and_limb_lanes_match_jax(lanes, k):
    h, l = lanes["h1"], lanes["l1"]
    _same(J.shl128(*_j(h, l), k), T.shl128(*_t(h, l), k))
    _same(tuple(J.limb16_lanes(*_j(h, l))), tuple(T.limb16_lanes(*_t(h, l))))


def test_combine_limb_sums_detects_overflow_like_jax():
    rng = np.random.default_rng(5)
    sums = [rng.integers(0, 2**46, N) for _ in range(8)]
    sums[7][:10] = 2**47          # tops past signed 128 bits
    negs = rng.integers(0, 2**20, N)
    _same(J.combine_limb_sums_checked(_j(*sums), jnp.asarray(negs)),
          T.combine_limb_sums_checked(_t(*sums), torch.from_numpy(negs)))
    _same(J.combine_limb_sums(_j(*sums)), T.combine_limb_sums(_t(*sums)))


def test_segment_sum_is_exact_and_saturates():
    """Sums by segment match Python ints; a segment past signed 128 bits
    or holding a saturated input pins to the sentinel, which then fails
    every precision."""
    from spark_rapids_tpu_torch.columnar.column import Decimal128Column
    from spark_rapids_tpu_torch.types import DecimalType
    rng = np.random.default_rng(9)
    n, segs = 600, 7
    vals = [int(x) * 10**20 + int(y) for x, y in
            zip(rng.integers(-10**17, 10**17, n), rng.integers(0, 10**18, n))]
    vals[0] = (1 << 127) - 1       # segment 0 overflows
    vals[1] = (1 << 127) - 1
    seg = rng.integers(0, segs, n)
    seg[:2] = 0
    valid = rng.random(n) > 0.1
    valid[:2] = True
    col = Decimal128Column.from_pylist(vals, DecimalType(38, 0), n,
                                       device="cpu")
    (rh, rl), has = T.decimal_segment_sum(
        col, torch.from_numpy(valid), torch.from_numpy(seg), segs)
    for s in range(segs):
        rows = (seg == s) & valid
        want = sum(v for v, r in zip(vals, rows) if r)
        got = _int128(rh[s], rl[s])
        if s == 0:
            assert (int(rh[0]), int(rl[0])) == (T.SAT_HI, T.SAT_LO)
            assert not bool(T.fits_precision(rh[:1], rl[:1], 38)[0])
        else:
            assert got == want
        assert bool(has[s]) == bool(rows.any())
