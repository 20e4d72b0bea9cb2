"""The port's math, bitwise and shift expressions (expr/math.py,
expr/bitwise.py) and its non-decimal IntegralDivide, Remainder, Pmod,
Least and Greatest against the JAX package's, on the CPU.

Integer, rounding, bitwise and shift results match bit for bit. The
transcendentals are torch's and XLA's own: the test holds each to the
ulp bound measured between the two on these inputs (XLA's exp, sinh and
cosh are the loose ones; sqrt, the logs but log1p, the trigonometric
functions, pow and atan2 agree within one ulp), subnormal results aside
(XLA flushes them to zero). Rounding a DECIMAL
(round, bround, floor, ceil) is held to Python's decimal module: the
JAX package rounds the unscaled lane as if it were the value (ROADMAP
C.5), which the port does not copy.
"""

import decimal
from types import SimpleNamespace

import numpy as np
import pytest

from spark_rapids_tpu.expr import arithmetic as jarith
from spark_rapids_tpu.expr import bitwise as jbit
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import math as jmath

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.columnar.column import Column as TColumn
from spark_rapids_tpu_torch.expr import arithmetic as tarith
from spark_rapids_tpu_torch.expr import bitwise as tbit
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import math as tmath

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases

JAX = SimpleNamespace(core=jcore, math=jmath, bit=jbit, ar=jarith)
TORCH = SimpleNamespace(core=tcore, math=tmath, bit=tbit, ar=tarith)
N = 2048

#: max |ulp| between the port and the JAX package on these inputs
ULPS = {"Sqrt": 1, "Exp": 256, "Expm1": 4, "Log": 1, "Log2": 1, "Log10": 2,
        "Log1p": 128, "Sin": 1, "Cos": 1, "Tan": 1, "Asin": 1, "Acos": 1,
        "Atan": 1, "Sinh": 512, "Cosh": 512, "Tanh": 8, "Asinh": 2,
        "Acosh": 4, "Atanh": 128, "Cbrt": 8, "ToDegrees": 0,
        "ToRadians": 0, "Signum": 0, "Rint": 0, "Pow": 1, "Atan2": 1}


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.random(N // 2) * 20 - 10,
                        np.exp(rng.random(N // 2) * 80 - 40)
                        * np.sign(rng.random(N // 2) - 0.5)])
    x[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 2.5, -2.5, 0.5]
    i64 = rng.integers(-2**63, 2**63 - 1, N, dtype=np.int64)
    i64[:4] = [-2**63, -1, 0, 2**63 - 1]
    i32 = rng.integers(-2**31, 2**31, N).astype(np.int32)
    i32[:4] = [-2**31, -1, 0, 2**31 - 1]
    small = rng.integers(-9, 10, N).astype(np.int32)
    small[:4] = [-1, -1, 0, 7]
    cols = {
        "x": (x, "DOUBLE", rng.random(N) > 0.05),
        "y": (rng.random(N) * 6 - 3, "DOUBLE", rng.random(N) > 0.05),
        "f": (x.astype(np.float32), "FLOAT", rng.random(N) > 0.05),
        "l": (i64, "LONG", rng.random(N) > 0.05),
        "i": (i32, "INT", rng.random(N) > 0.05),
        "n": (small, "INT", rng.random(N) > 0.05),
        "b": (rng.integers(-128, 128, N).astype(np.int8), "BYTE",
              rng.random(N) > 0.05),
        "d": (rng.integers(-70, 70, N).astype(np.int32), "INT",
              np.ones(N, bool)),
    }
    return both_batch(cols, N)


def _pair(batches, build):
    return [m.core.resolve(build(m), b.schema).columnar_eval(b)
            for m, b in zip((JAX, TORCH), batches)]


def _exact(j, t):
    np.testing.assert_array_equal(t.validity.numpy(), np.asarray(j.validity))
    jd, td = np.asarray(j.data), t.data.numpy()
    assert jd.dtype == td.dtype
    if td.dtype.kind == "f":
        jd, td = jd.view(f"i{jd.itemsize}"), td.view(f"i{td.itemsize}")
    np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("name", sorted(ULPS))
def test_math_functions_within_their_ulp_bound(batches, name):
    def build(m):
        c = m.core.col
        args = (c("x"), c("y")) if name in ("Pow", "Atan2") else (c("x"),)
        return getattr(m.math, name)(*args)
    j, t = _pair(batches, build)
    np.testing.assert_array_equal(t.validity.numpy(), np.asarray(j.validity))
    jd, td = np.asarray(j.data), t.data.numpy()
    ok = t.validity.numpy()
    np.testing.assert_array_equal(np.isnan(jd)[ok], np.isnan(td)[ok])
    # XLA flushes subnormal results to zero; torch keeps them
    tiny = np.finfo(np.float64).tiny
    sub = ((np.abs(jd) < tiny) & (jd != 0)) | ((np.abs(td) < tiny)
                                               & (td != 0))
    cmp = ok & ~sub & ~np.isnan(jd)
    fin = cmp & np.isfinite(jd) & np.isfinite(td)
    np.testing.assert_array_equal(jd[cmp & ~fin], td[cmp & ~fin])
    diff = np.abs(jd.view(np.int64)[fin] - td.view(np.int64)[fin])
    assert diff.max(initial=0) <= ULPS[name], (name, diff.max())


@pytest.mark.parametrize("name, src, scale", [
    ("Floor", "x", None), ("Ceil", "x", None), ("Floor", "f", None),
    ("Ceil", "i", None), ("Round", "x", 0), ("Round", "x", 2),
    ("Round", "x", -1), ("Round", "f", 1), ("Round", "i", -2),
    ("Round", "l", 0), ("BRound", "x", 0), ("BRound", "x", 2),
    ("BRound", "i", -1), ("BRound", "l", 3)])
def test_rounding_matches_jax(batches, name, src, scale):
    def build(m):
        cls = getattr(m.math, name)
        c = m.core.col(src)
        return cls(c) if scale is None else cls(c, scale)
    _exact(*_pair(batches, build))


@pytest.mark.parametrize("name, scale", [("Round", 0), ("Round", 1),
                                         ("BRound", 1), ("BRound", 0),
                                         ("Floor", None), ("Ceil", None),
                                         ("Round", 3)])
def test_decimal_rounding_matches_python(name, scale):
    vals = [12345, -12345, 12350, -12350, 12250, -12250, 5, -5, 0, 99999,
            -99999, None, 150, 250, -150]
    dt = tt.DecimalType(5, 2)
    col = TColumn.from_pylist(vals, dt, device="cpu")
    b = TBatch([col], len(vals), tt.Schema((tt.StructField("a", dt),)))
    cls = getattr(tmath, name)
    e = cls(tcore.col("a")) if scale is None else cls(tcore.col("a"), scale)
    got = tcore.resolve(e, b.schema).columnar_eval(b).to_pylist(len(vals))
    mode = {"Round": decimal.ROUND_HALF_UP, "BRound": decimal.ROUND_HALF_EVEN,
            "Floor": decimal.ROUND_FLOOR, "Ceil": decimal.ROUND_CEILING}[name]
    places = 0 if scale is None else scale
    for v, g in zip(vals, got):
        if v is None:
            assert g is None
            continue
        r = decimal.Decimal(v).scaleb(-2).quantize(
            decimal.Decimal(1).scaleb(-places), rounding=mode)
        want = int(r) if scale is None else int(r.scaleb(2))
        if scale is not None and abs(want) >= 10 ** 5:
            want = None        # past DECIMAL(5, 2): NULL, as an overflow
        assert g == want, (name, scale, v, g, want)


@pytest.mark.parametrize("name, left, right", [
    ("BitwiseAnd", "l", "i"), ("BitwiseOr", "i", "b"), ("BitwiseXor", "l",
                                                        "l"),
    ("ShiftLeft", "i", "d"), ("ShiftLeft", "l", "d"), ("ShiftRight", "l",
                                                       "d"),
    ("ShiftRight", "b", "d"), ("ShiftRightUnsigned", "l", "d"),
    ("ShiftRightUnsigned", "i", "d"), ("ShiftRightUnsigned", "b", "n")])
def test_bitwise_and_shifts_match_jax(batches, name, left, right):
    _exact(*_pair(batches, lambda m: getattr(m.bit, name)(
        m.core.col(left), m.core.col(right))))


@pytest.mark.parametrize("src", ["l", "i", "b"])
def test_bitwise_not_matches_jax(batches, src):
    _exact(*_pair(batches, lambda m: m.bit.BitwiseNot(m.core.col(src))))


@pytest.mark.parametrize("name, left, right", [
    ("IntegralDivide", "l", "n"), ("IntegralDivide", "i", "n"),
    ("Remainder", "l", "n"), ("Remainder", "x", "y"),
    ("Remainder", "i", "n"), ("Pmod", "l", "n"), ("Pmod", "x", "y"),
    ("Pmod", "n", "d")])
def test_integral_divide_remainder_pmod_match_jax(batches, name, left,
                                                  right):
    _exact(*_pair(batches, lambda m: getattr(m.ar, name)(
        m.core.col(left), m.core.col(right))))


@pytest.mark.parametrize("name", ["Least", "Greatest"])
@pytest.mark.parametrize("cols", [("x", "y"), ("l", "l"), ("i", "n", "d")])
def test_least_greatest_match_jax(batches, name, cols):
    _exact(*_pair(batches, lambda m: getattr(m.ar, name)(
        *[m.core.col(c) for c in cols])))
