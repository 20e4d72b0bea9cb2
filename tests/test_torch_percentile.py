"""percentile and approx_percentile (ops/percentile.py, expr/aggexprs.py)
against the JAX package on the CPU.

The input arrives as several batches whose groups hold more values than
the sketch's K at a small accuracy, so every partial sketch compresses and
the final merge resamples (`psketch:K`, `psketch_merge:K`); scalar and
list percentages. Grouped, the results are exact against the JAX package
(a sketch picks values; the interpolation is the same f64 formula);
grand, the exact percentiles match numpy's. The sketch's answers lie
within Spark's n / accuracy rank contract of numpy's exact quantiles; a
group of K values or fewer is exact.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu.exec import aggregate as ja
from spark_rapids_tpu.exec import basic as jb
from spark_rapids_tpu.expr import aggexprs as jae
from spark_rapids_tpu.expr import core as jc

from spark_rapids_tpu_torch.columnar.column import ArrayColumn
from spark_rapids_tpu_torch.exec import aggregate as ta
from spark_rapids_tpu_torch.exec import basic as tb
from spark_rapids_tpu_torch.expr import aggexprs as tae
from spark_rapids_tpu_torch.expr import core as tc
from spark_rapids_tpu_torch.ops import percentile as tp
from spark_rapids_tpu_torch.types import ArrayType, DOUBLE

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases, one_torch_thread

ACCURACY = 8    # K = 16 points a group
N = 600


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), one_torch_thread():
        yield


def _aggs(ae, c):
    return [(ae.Percentile(c.col("x"), 0.5), "med"),
            (ae.Percentile(c.col("i"), [0.0, 0.3, 1.0]), "pi"),
            (ae.ApproxPercentile(c.col("x"), [0.1, 0.5, 0.9], ACCURACY),
             "ax"),
            (ae.ApproxPercentile(c.col("i"), 0.75, ACCURACY), "ai")]


def _data(seed):
    rng = np.random.default_rng(seed)
    return {"k": (rng.integers(0, 3, N).astype(np.int32), "INT",
                  rng.random(N) > 0.05),
            "x": (rng.normal(50, 20, N), "DOUBLE", rng.random(N) > 0.1),
            "i": (rng.integers(-1000, 1000, N).astype(np.int64), "LONG",
                  rng.random(N) > 0.1)}


def _run(keys, packages):
    pairs = [both_batch(_data(s), N) for s in range(3)]
    out = []
    for ex, b, ae, c, k in packages:
        node = ex.AggregateExec([c.col("k")] if keys else [], _aggs(ae, c),
                                b.InMemoryScanExec([p[k] for p in pairs],
                                                   pairs[0][k].schema))
        out.append(sorted((r for x in node.execute()
                           for r in x.to_pylist()), key=repr))
    return out


JAX = (ja, jb, jae, jc, 0)
TORCH = (ta, tb, tae, tc, 1)


@pytest.mark.parametrize("keys", [True, False])
def test_percentiles_match_jax_through_compress_and_merge(keys):
    """Grouped: against the JAX package; grand (every value one group):
    the exact percentiles against numpy. Both: the approx answers within
    n / accuracy in rank."""
    if keys:
        jrows, trows = _run(keys, (JAX, TORCH))
        assert trows == jrows
    else:
        (trows,) = _run(keys, (TORCH,))
    data = [_data(s) for s in range(3)]
    allk = np.concatenate([d["k"][0] for d in data])
    kv = np.concatenate([d["k"][2] for d in data])
    x = np.concatenate([d["x"][0] for d in data])
    xv = np.concatenate([d["x"][2] for d in data])
    i = np.concatenate([d["i"][0] for d in data])
    iv = np.concatenate([d["i"][2] for d in data])
    for row in trows:
        if not keys:
            assert row[0] == pytest.approx(np.percentile(x[xv], 50),
                                           rel=1e-9)
            assert row[1] == pytest.approx(
                np.percentile(i[iv], [0, 30, 100]).tolist(), rel=1e-9)
        at = xv & ((allk == row[0]) & kv if keys else True)
        if keys and row[0] is None:
            at = xv & ~kv
        s = np.sort(x[at])
        n = s.shape[0]
        for p, v in zip((0.1, 0.5, 0.9), row[-2]):
            lo = np.searchsorted(s, v, "left")
            hi = np.searchsorted(s, v, "right")
            assert lo - n / ACCURACY <= p * n <= hi + n / ACCURACY


def test_small_groups_are_exact():
    """A group of K values or fewer keeps every value: the sketch's pick
    is the exact rank ceil(p * n) - 1."""
    vals = [[3.0, 1.0, 2.0], [5.0], [], None, [9.0, 7.0, 8.0, 6.0]]
    arr = ArrayColumn.from_pylist(vals, ArrayType(DOUBLE), device="cpu")
    sk = tp.sketch_compress(arr, 16)
    got = tp.approx_percentile_of_sketches(sk, [0.0, 0.5, 1.0], DOUBLE)
    assert got.to_pylist(5) == [[1.0, 2.0, 3.0], [5.0, 5.0, 5.0], None,
                                None, [6.0, 7.0, 9.0]]
    exact = tp.percentile_of_arrays(arr, 0.5, True).to_pylist(5)
    assert exact == [2.0, 5.0, None, None, 7.5]
    assert torch.equal(sk.offsets[:6].to(torch.int64),
                       torch.tensor([0, 4, 6, 7, 7, 12]))
