"""SampleExec and PartitionWiseSortExec of the port against the JAX
package's, on the CPU.

The port's threefry (ops/threefry.py) is held to jax.random bit for bit:
key(seed), fold_in(batch), the partitionable counter layout and the
float32 uniform. A seed keeps exactly the JAX package's rows, batch by
batch, through the exec and through DataFrame.sample. The sort over a
range exchange (PartitionWiseSortExec, planned when the host shuffle has
partitions) returns the JAX package's rows in its order, which is the
order of Python's sort on the keys.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.expr import core as jcore

from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.ops import threefry

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases
from test_torch_planner import active_confs, converted, tree

JAX = SimpleNamespace(core=jcore, basic=jbasic, session=jsession)
TORCH = SimpleNamespace(core=tcore, basic=tbasic, session=tsession)


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs():
        yield


@pytest.mark.parametrize("seed", [0, 7, 42, -5, 2**40 + 3])
def test_threefry_bits_and_uniform_match_jax_random(seed):
    assert jax.config.jax_threefry_partitionable
    for b in (0, 1, 1000):
        k = jax.random.fold_in(jax.random.key(seed), jnp.uint32(b))
        tk = threefry.fold_in(threefry.key(seed), b)
        assert tk == tuple(int(v) for v in jax.random.key_data(k))
        for n in (1, 128, 4097):
            want = np.asarray(jax.random.bits(k, (n,), jnp.uint32))
            np.testing.assert_array_equal(
                threefry.random_bits(tk, n).numpy(), want.astype(np.int64))
            u = np.asarray(jax.random.uniform(k, (n,), jnp.float32))
            np.testing.assert_array_equal(
                threefry.uniform(tk, n).numpy().view(np.int32),
                u.view(np.int32))


def _batches(n_batches=3, n=700, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        cols = {"k": (rng.integers(0, 50, n).astype(np.int64), "LONG",
                      rng.random(n) > 0.1),
                "v": (rng.random(n), "DOUBLE", rng.random(n) > 0.1),
                "s": ([f"w{x}" for x in rng.integers(0, 9, n)], "STRING",
                      rng.random(n) > 0.1)}
        out.append(both_batch(cols, n))
    return [b[0] for b in out], [b[1] for b in out]


@pytest.mark.parametrize("fraction, seed", [(0.1, 7), (0.5, 42), (0.0, 1),
                                            (1.0, 3)])
def test_sample_exec_keeps_the_jax_rows(fraction, seed):
    jbs, tbs = _batches()
    rows = []
    for m, bs in ((JAX, jbs), (TORCH, tbs)):
        scan = m.basic.InMemoryScanExec(bs, bs[0].schema)
        rows.append([b.to_pylist() for b in
                     m.basic.SampleExec(fraction, seed, scan).execute()])
    assert rows[1] == rows[0]


def test_dataframe_sample_matches_jax():
    jbs, tbs = _batches(2, 500, seed=4)
    rows = []
    for m, bs, dev in ((JAX, jbs, {}), (TORCH, tbs, {"device": "cpu"})):
        df = m.session.TpuSession(**dev).from_batches(bs, bs[0].schema)
        rows.append(df.sample(0.3, seed=11).collect())
    assert rows[1] == rows[0] and 0 < len(rows[1]) < 1000


@pytest.mark.parametrize("orders", [(("k", True), ("v", True)),
                                    (("v", False),), (("s", True),
                                                      ("k", False))])
def test_partition_wise_sort_matches_jax_and_lexsort(orders):
    """The same rows in the same order as the JAX package's, in the keys'
    order (nulls first ascending, last descending)."""
    jbs, tbs = _batches(3, 600, seed=6)
    conf = {"spark.rapids.sql.shuffle.partitions": "4"}
    dfs = []
    for m, bs, dev in ((JAX, jbs, {}), (TORCH, tbs, {"device": "cpu"})):
        df = m.session.TpuSession(conf, **dev).from_batches(bs, bs[0].schema)
        dfs.append(df.sort(*[(m.core.col(c), asc) for c, asc in orders]))
    from spark_rapids_tpu.plan import overrides as jover
    from spark_rapids_tpu_torch.plan import overrides as tover
    t_tree = tree(converted(SimpleNamespace(session=tsession,
                                            overrides=tover), dfs[1]))
    assert t_tree == tree(converted(SimpleNamespace(
        session=jsession, overrides=jover), dfs[0]))
    assert "PartitionWiseSortExec" in repr(t_tree)
    jrows, trows = dfs[0].collect(), dfs[1].collect()
    assert trows == jrows
    # rows equal on every key may come in any order: compare the keys
    allrows = [r for b in tbs for r in b.to_pylist()]
    names = ["k", "v", "s"]

    def key(r):
        out = []
        for c, asc in orders:
            v = r[names.index(c)]
            if asc:
                out.append((v is not None, v if v is not None else 0))
            else:
                out.append((v is None, (-v if not isinstance(v, str)
                                        else v) if v is not None else 0))
        return out
    want = sorted(allrows, key=key) if all(
        asc or c != "s" for c, asc in orders) else None
    if want is not None:
        assert [key(r) for r in trows] == [key(r) for r in want]
    assert sorted(trows, key=repr) == sorted(allrows, key=repr)
