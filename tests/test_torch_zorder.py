"""InterleaveBits (expr/zorder.py) against the JAX package on the CPU: 1 to
8 INT and LONG keys at their extremes, nulls, and chip_smoke's numpy
oracle written from the rule (bit b of the code from the top is bit
63 - b // n of key b % n, each key's sign bit flipped, the code's top bit
flipped), which P30 is held to on the card. Codes are exact, bit for
bit. Then P30's z-order step at a small size: the codes of
(l_partkey, l_suppkey) and a sort by them, planned, against a stable
numpy argsort."""

import numpy as np
import pytest

import jax.numpy as jnp
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.expr import core as jc
from spark_rapids_tpu.expr.zorder import InterleaveBits as JInterleave

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.expr import core as tc
from spark_rapids_tpu_torch.expr.zorder import InterleaveBits, interleave_bits

from chip_smoke import zorder_codes as zorder_oracle
from test_torch_jax_ref import jax_aliases, one_torch_thread

I64 = np.iinfo(np.int64)
I32 = np.iinfo(np.int32)
LONGS = np.array([I64.min, I64.max, 0, -1, 1, 123456789012345, -98765,
                  I64.min + 1], np.int64)
INTS = np.array([I32.min, I32.max, 0, -1, 1, 77, -5, I32.min + 1], np.int32)
VALID = np.array([1, 1, 1, 1, 1, 1, 0, 1], bool)


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), one_torch_thread():
        yield


def _keys(n):
    return [LONGS if i % 2 == 0 else INTS for i in range(n)]


@pytest.mark.parametrize("n", range(1, 9))
def test_interleave_bits_matches_jax_and_the_oracle(n):
    keys = _keys(n)
    names = [f"k{i}" for i in range(n)]
    types = [tt.LONG if k.dtype == np.int64 else tt.INT for k in keys]
    schema = tt.Schema(tuple(tt.StructField(nm, t)
                             for nm, t in zip(names, types)))
    cols = [Column.from_numpy(k, t, device="cpu", validity=VALID)
            for k, t in zip(keys, types)]
    tbatch = TBatch(cols, len(VALID), schema)
    jcols = [JColumn(jnp.asarray(c.data.numpy()),
                     jnp.asarray(c.validity.numpy()),
                     jt.LONG if k.dtype == np.int64 else jt.INT)
             for c, k in zip(cols, keys)]
    jbatch = JBatch(jcols, len(VALID), jt.Schema(tuple(
        jt.StructField(nm, c.dtype) for nm, c in zip(names, jcols))))
    got = InterleaveBits(*[tc.BoundReference(i, t) for i, t in
                           enumerate(types)]).columnar_eval(tbatch)
    want = JInterleave(*[jc.BoundReference(i, c.dtype) for i, c in
                         enumerate(jcols)]).columnar_eval(jbatch)
    m = len(VALID)
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))
    assert np.array_equal(got.validity.numpy(), np.asarray(want.validity))
    oracle = zorder_oracle(keys)
    assert np.array_equal(got.data.numpy()[:m][VALID], oracle[VALID])
    assert (got.data.numpy()[:m][~VALID] == 0).all()


def test_codes_keep_each_keys_order():
    """With one key the code sorts as the key; with two keys spread over
    their top 32 bits, rows close in both keys get close codes (a z-curve
    over a 4 x 4 grid). The rule keeps only each key's top 64 // n bits
    of its 64-bit rank, so two keys below 2**32 all share one code: a
    defect of the JAX package that the port shares, bit for bit (ROADMAP
    C.5)."""
    one = zorder_oracle([LONGS])
    assert np.array_equal(np.argsort(one, kind="stable"),
                          np.argsort(LONGS, kind="stable"))
    x, y = np.meshgrid(np.arange(4), np.arange(4))
    xs, ys = x.ravel().astype(np.int64), y.ravel().astype(np.int64)
    codes = zorder_oracle([xs << 32, ys << 32])
    order = np.argsort(codes, kind="stable")
    assert [(int(xs[i]), int(ys[i])) for i in order[:4]] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    small = interleave_bits([Column.from_numpy(xs, tt.LONG, device="cpu"),
                             Column.from_numpy(ys, tt.LONG, device="cpu")])
    assert len(set(small.data.numpy()[:16].tolist())) == 1
    assert np.array_equal(small.data.numpy()[:16], zorder_oracle([xs, ys]))


def test_p30_zorder_path_plans_and_matches_the_oracle():
    """P30's z-order step at a small size: the planned codes and sort
    equal chip_smoke's numpy oracle (a stable argsort of the codes)."""
    import chip_smoke as cs
    dj = cs.tpch_join_data(sf=0.002)
    q3d = cs.q3_types_data(dj)
    d19 = cs.q19_data(n_part=2048, n_line=16384)
    m, b, checks = cs.nested_inputs("cpu", dj, q3d, d19)
    dfs = cs.nested_dfs(m, "cpu", b)
    out = list(cs.planned(m, dfs["P30 zorder"])[0].execute())
    checks["P30 zorder"](out, "P30 zorder")
