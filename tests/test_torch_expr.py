"""Parity of the PyTorch port's expressions with the JAX package: every
expression the fused scan-aggregate kernel accepts, over random columns
with nulls, NaN, +-0.0, infinities, integer overflow and zero divisors.

Data and validity must be identical at every slot (the data under null
slots included, since the bucket hash reads it); floats may differ by at
most one ulp.
"""

import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (enables jax x64)
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import arithmetic as jarith
from spark_rapids_tpu.expr import predicates as jpred

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import arithmetic as tarith
from spark_rapids_tpu_torch.expr import predicates as tpred

N, CAP = 900, 1024

COLUMNS = [("i", "INT"), ("i2", "INT"), ("l", "LONG"), ("f", "FLOAT"),
           ("f2", "FLOAT"), ("d", "DOUBLE"), ("d2", "DOUBLE"),
           ("b", "BOOLEAN"), ("b2", "BOOLEAN"), ("dt", "DATE")]


def _values(rng, kind):
    if kind in ("INT", "DATE"):
        v = rng.integers(-(1 << 31), 1 << 31, N, dtype=np.int64)
        v[::7] = 0                      # zero divisors
        v[::29] = rng.integers(-3, 3, v[::29].shape)
        return v.astype(np.int32)
    if kind == "LONG":
        v = rng.integers(-(1 << 62), 1 << 62, N, dtype=np.int64)
        v[::5] = rng.integers(-9, 9, v[::5].shape)
        v[::11] = 0
        return v
    if kind == "BOOLEAN":
        return rng.integers(0, 2, N).astype(np.bool_)
    v = (rng.standard_normal(N) * 100).astype(np.float64)
    v[::6] = 0.0
    v[::10] = -0.0
    v[::13] = np.nan
    v[::17] = np.inf
    v[::19] = -np.inf
    return v.astype(np.float32 if kind == "FLOAT" else np.float64)


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(2024)
    fields_j, fields_t, cols = [], [], []
    for name, kind in COLUMNS:
        vals = _values(rng, kind)
        valid = rng.random(N) > 0.2
        jc = JColumn.from_numpy(vals, getattr(jt, kind), validity=valid,
                                capacity=CAP)
        # garbage under the null slots, the same bytes in both packages
        data = np.asarray(jc.data).copy()
        cols.append((data, np.asarray(jc.validity).copy()))
        fields_j.append(jt.StructField(name, getattr(jt, kind)))
        fields_t.append(tt.StructField(name, getattr(tt, kind)))
    jschema, tschema = jt.Schema(tuple(fields_j)), tt.Schema(tuple(fields_t))
    import jax.numpy as jnp
    jb = JBatch([JColumn(jnp.asarray(d), jnp.asarray(v), f.data_type)
                 for (d, v), f in zip(cols, fields_j)], N, jschema)
    tb = TBatch.from_numpy_columns(cols, tschema, N, device="cpu")
    return jb, tb


class _NS:
    def __init__(self, core, arith, pred):
        self.col, self.lit = core.col, core.lit
        for mod in (core, arith, pred):
            for k in dir(mod):
                if k[0].isupper():
                    setattr(self, k, getattr(mod, k))


JNS = _NS(jcore, jarith, jpred)
TNS = _NS(tcore, tarith, tpred)

EXPRS = {
    "add_int_wrap": lambda x: x.Add(x.col("i"), x.col("i2")),
    "sub_long_int": lambda x: x.Subtract(x.col("l"), x.col("i")),
    "mul_int_wrap": lambda x: x.Multiply(x.col("i"), x.col("i2")),
    "mul_long_wrap": lambda x: x.Multiply(x.col("l"), x.col("l")),
    "add_float_double": lambda x: x.Add(x.col("f"), x.col("d")),
    "mul_float": lambda x: x.Multiply(x.col("f"), x.col("f2")),
    "sub_double_lit": lambda x: x.Subtract(x.col("d"), x.lit(1.5)),
    "q1_disc_price": lambda x: x.Multiply(
        x.col("d"), x.Subtract(x.lit(1.0), x.col("d2"))),
    "div_double_zero": lambda x: x.Divide(x.col("d"), x.col("d2")),
    "div_int_long": lambda x: x.Divide(x.col("i"), x.col("l")),
    "div_float": lambda x: x.Divide(x.col("f"), x.col("f2")),
    "neg_int": lambda x: x.UnaryMinus(x.col("i")),
    "neg_double": lambda x: x.UnaryMinus(x.col("d")),
    "abs_long": lambda x: x.Abs(x.col("l")),
    "abs_float": lambda x: x.Abs(x.col("f")),
    "eq_double_nan": lambda x: x.EqualTo(x.col("d"), x.col("d2")),
    "eq_int_long": lambda x: x.EqualTo(x.col("i"), x.col("l")),
    "lt_float": lambda x: x.LessThan(x.col("f"), x.col("f2")),
    "le_long_lit": lambda x: x.LessThanOrEqual(x.col("l"), x.lit(45)),
    "gt_double_zero": lambda x: x.GreaterThan(x.col("d"), x.lit(0.0)),
    "ge_int_double": lambda x: x.GreaterThanOrEqual(x.col("i"),
                                                    x.col("d")),
    "lt_date": lambda x: x.LessThan(x.col("dt"), x.col("dt")),
    "eq_bool": lambda x: x.EqualTo(x.col("b"), x.col("b2")),
    "eqns_double": lambda x: x.EqualNullSafe(x.col("d"), x.col("d2")),
    "eqns_int_long": lambda x: x.EqualNullSafe(x.col("i"), x.col("l")),
    "and": lambda x: x.And(x.col("b"), x.col("b2")),
    "or": lambda x: x.Or(x.col("b"), x.col("b2")),
    "not": lambda x: x.Not(x.col("b")),
    "is_null": lambda x: x.IsNull(x.col("d")),
    "is_not_null": lambda x: x.IsNotNull(x.col("i")),
    "and_of_compares": lambda x: x.And(
        x.LessThan(x.col("i"), x.lit(5)), x.Not(x.IsNull(x.col("d")))),
    "or_of_compares": lambda x: x.Or(
        x.GreaterThan(x.col("f"), x.col("f2")),
        x.EqualTo(x.col("l"), x.lit(0))),
    "alias_nested": lambda x: x.Alias(x.Abs(x.UnaryMinus(
        x.Add(x.col("l"), x.lit(3)))), "n"),
}


def _ulp_equal(a: np.ndarray, b: np.ndarray) -> None:
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    np.testing.assert_array_equal(nan_a, nan_b)
    ok = ~nan_a
    a, b = a[ok], b[ok]
    same = (a == b) & (np.signbit(a) == np.signbit(b))
    with np.errstate(invalid="ignore"):
        ulp = np.abs(a.astype(np.float64) - b.astype(np.float64)) \
            <= np.spacing(np.abs(a)).astype(np.float64)
    assert np.all(same | ulp), (a[~(same | ulp)], b[~(same | ulp)])


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_columnar_eval_matches_jax(batches, name):
    jb, tb = batches
    jexpr = jcore.resolve(EXPRS[name](JNS), jb.schema)
    texpr = tcore.resolve(EXPRS[name](TNS), tb.schema)
    assert repr(texpr.data_type) == repr(jexpr.data_type)
    jc, tc = jexpr.columnar_eval(jb), texpr.columnar_eval(tb)
    jv, tv = np.asarray(jc.validity), tc.validity.numpy()
    np.testing.assert_array_equal(jv, tv)
    jd, td = np.asarray(jc.data), tc.data.numpy()
    assert jd.dtype == td.dtype
    if np.issubdtype(jd.dtype, np.floating):
        _ulp_equal(jd, td)
    else:
        np.testing.assert_array_equal(jd, td)
