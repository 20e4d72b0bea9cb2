"""Parity of the PyTorch port's masked-bucket group-by with the JAX
package: the bucket hash bit for bit, and masked_groupby with one and two
rounds on low- and high-cardinality keys (leftover included).

Keys, counts, integer sums and min/max and the leftover flag must be
exact and in the same dense order; f64 sums may differ only by summation
order (rtol 1e-12).
"""

import numpy as np
import pytest
import torch

import spark_rapids_tpu  # noqa: F401  (enables jax x64)
import jax.numpy as jnp
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.ops import maskedagg as jm
from spark_rapids_tpu import types as jt

from spark_rapids_tpu_torch.columnar.column import Column as TColumn
from spark_rapids_tpu_torch.ops import maskedagg as tm
from spark_rapids_tpu_torch import types as tt

CAP = 4096


def _pair(values, type_name, null_every=0):
    """The same column in both packages (data under nulls included)."""
    jdt, tdt = getattr(jt, type_name), getattr(tt, type_name)
    valid = np.ones(len(values), np.bool_)
    if null_every:
        valid[::null_every] = False
    jc = JColumn.from_numpy(values, jdt, validity=valid, capacity=CAP)
    tc = TColumn(torch.from_numpy(np.asarray(jc.data).copy()),
                 torch.from_numpy(np.asarray(jc.validity).copy()), tdt)
    return jc, tc


def _keys(rng, n, kind, dom):
    if kind == "INT":
        return rng.integers(-dom, dom, n).astype(np.int32)
    if kind == "LONG":
        return (rng.integers(-dom, dom, n) * 1_000_003).astype(np.int64)
    if kind == "SHORT":
        return rng.integers(-dom, dom, n).astype(np.int16)
    if kind == "BOOLEAN":
        return rng.integers(0, 2, n).astype(np.bool_)
    vals = rng.integers(-dom, dom, n).astype(np.float64) / 4.0
    vals[::11] = np.nan
    vals[::13] = -0.0
    vals[::17] = 0.0
    return vals.astype(np.float32 if kind == "FLOAT" else np.float64)


@pytest.mark.parametrize("kind", ["INT", "LONG", "FLOAT", "DOUBLE",
                                  "BOOLEAN", "SHORT"])
@pytest.mark.parametrize("salt", [0x2545F491, 0x2545F491 + 0x9E37])
def test_bucket_hash_bit_exact(kind, salt):
    rng = np.random.default_rng(7)
    n = 3000
    jk, tk = _pair(_keys(rng, n, kind, 1 << 20), kind, null_every=5)
    jk2, tk2 = _pair(_keys(rng, n, "LONG", 1 << 30), "LONG", null_every=7)
    jh = np.asarray(jm._bucket_hash([jk, jk2], salt, CAP)).astype(np.int64)
    th = tm._bucket_hash([tk, tk2], salt, CAP).numpy()
    np.testing.assert_array_equal(jh, th)


def _assert_groupby_equal(jout, tout):
    jkeys, jres, jng, jleft = jout
    tkeys, tres, tng, tleft = tout
    ng = int(jng)
    assert ng == int(tng)
    assert bool(jleft) == bool(tleft)
    for jk, tk in zip(jkeys, tkeys):
        np.testing.assert_array_equal(np.asarray(jk.validity)[:ng],
                                      tk.validity.numpy()[:ng])
        jd, td = np.asarray(jk.data)[:ng], tk.data.numpy()[:ng]
        np.testing.assert_array_equal(jd.view(np.uint8), td.view(np.uint8))
    for (_, (jd, jv)), (_, (td, tv)) in zip(jres, tres):
        jv, tv = np.asarray(jv)[:ng], tv.numpy()[:ng]
        np.testing.assert_array_equal(jv, tv)
        jd, td = np.asarray(jd)[:ng][jv], td.numpy()[:ng][tv]
        if np.issubdtype(jd.dtype, np.floating):
            np.testing.assert_allclose(td, jd, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(td, jd)


def _agg_inputs(rng, n, mod):
    v, tv = _pair(rng.random(n) * 1000 - 500, "DOUBLE", null_every=3)
    w, tw = _pair(rng.integers(-1 << 40, 1 << 40, n).astype(np.int64),
                  "LONG", null_every=4)
    i, ti = _pair(rng.integers(-1000, 1000, n).astype(np.int32), "INT")
    ops = [("sum", 0), ("sum", 1), ("sum_sq", 0), ("count", 0),
           ("count_star", None), ("min", 0), ("max", 1), ("min", 2),
           ("max", 2)]
    jcols, tcols = [v, w, i], [tv, tw, ti]
    return ([(op, None if s is None else jcols[s]) for op, s in ops],
            [(op, None if s is None else tcols[s]) for op, s in ops])


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("key_kind,dom,n_keys", [
    ("INT", 6, 1),         # low cardinality: every bucket clean
    ("DOUBLE", 5, 1),      # NaN / +-0.0 keys collapse as Spark's order says
    ("LONG", 40, 2),       # two key columns, some buckets dirty
    ("LONG", 1500, 1),     # high cardinality: leftover must trip
])
def test_masked_groupby_matches_jax(rounds, key_kind, dom, n_keys):
    rng = np.random.default_rng(11 + dom)
    n = 3000
    jkeys, tkeys = [], []
    for k in range(n_keys):
        jk, tk = _pair(_keys(rng, n, key_kind if k == 0 else "INT", dom),
                       key_kind if k == 0 else "INT", null_every=9)
        jkeys.append(jk)
        tkeys.append(tk)
    jaggs, taggs = _agg_inputs(rng, n, dom)
    mask = rng.random(CAP) < 0.8
    jout = jm.masked_groupby(jkeys, jaggs, jnp.int32(n), CAP,
                             jnp.asarray(mask), 32, rounds)
    tout = tm.masked_groupby(tkeys, taggs, torch.tensor(n, dtype=torch.int32),
                             CAP, torch.from_numpy(mask), 32, rounds)
    _assert_groupby_equal(jout, tout)
    if dom == 1500:
        assert bool(tout[3]), "high cardinality must leave rows over"


def test_masked_reduce_matches_jax():
    rng = np.random.default_rng(3)
    n = 2000
    jaggs, taggs = _agg_inputs(rng, n, 0)
    mask = rng.random(CAP) < 0.5
    jout = jm.masked_reduce(jaggs, jnp.int32(n), jnp.asarray(mask), 128)
    tout = tm.masked_reduce(taggs, torch.tensor(n, dtype=torch.int32),
                            torch.from_numpy(mask), 128)
    for (jd, jv), (td, tv) in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        jd, td = np.asarray(jd)[:1], td.numpy()[:1]
        if np.issubdtype(jd.dtype, np.floating):
            np.testing.assert_allclose(td, jd, rtol=1e-12)
        else:
            np.testing.assert_array_equal(td, jd)
