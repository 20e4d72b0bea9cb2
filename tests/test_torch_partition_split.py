"""The shuffle's partition ids and device split in the port
(parallel/exchange.partition_ids, ops/partition_split.py) against the JAX
package, on the CPU:

- `partition_ids` equals the reference's bit for bit over INT, LONG,
  DOUBLE (with -0.0, 0.0, NaN), DATE and STRING keys with nulls, alone
  and in combinations, for several partition counts, with inactive rows
  past num_rows mapped to n;
- `partition_table`'s counts and permutation equal the reference's
  (stable within a partition, inactive rows last), ids out of range
  included;
- `reorder_columns` gives the reference's columns, row for row;
- on CPU tensors no kernel launches.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.ops import partition_split as jsplit
from spark_rapids_tpu.parallel import exchange as jexchange

from spark_rapids_tpu_torch.ops import murmur3_lanes, partition_split as tsplit
from spark_rapids_tpu_torch.ops import row_gather
from spark_rapids_tpu_torch.parallel import exchange as texchange

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases

N = 1000
CAP = 1024


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _keys(seed=0):
    rng = np.random.default_rng(seed)

    def valid():
        return rng.random(N) > 0.15
    d = rng.standard_normal(N)
    d[rng.random(N) < 0.1] = -0.0
    d[rng.random(N) < 0.1] = 0.0
    d[rng.random(N) < 0.1] = np.nan
    words = ["", "a", "REG AIR", "héllo", "x" * 40]
    return {
        "i": (rng.integers(-50, 50, N).astype(np.int32), "INT", valid()),
        "l": (rng.integers(-2**40, 2**40, N), "LONG", valid()),
        "d": (d, "DOUBLE", valid()),
        "dt": (rng.integers(0, 20000, N).astype(np.int32), "DATE", valid()),
        "s": ([words[i] for i in rng.integers(0, len(words), N)], "STRING",
              valid()),
    }


KEY_SETS = [("i",), ("l",), ("d",), ("dt",), ("s",), ("l", "i"),
            ("s", "i"), ("i", "d", "dt"), ("d", "s", "l")]


@pytest.mark.parametrize("names", KEY_SETS, ids="+".join)
@pytest.mark.parametrize("n_parts", [1, 3, 8, 16, 200])
def test_partition_ids_match_jax_bit_for_bit(names, n_parts):
    keys = _keys(len(names) + n_parts)
    jb, tb = both_batch({k: keys[k] for k in names}, N, CAP)
    rows = N - 37  # rows past it are inactive
    want = np.asarray(jexchange.partition_ids(
        list(jb.columns), jnp.int32(rows), CAP, n_parts))
    got = texchange.partition_ids(list(tb.columns), torch.tensor(rows),
                                  CAP, n_parts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[rows:] == n_parts).all()
    assert texchange.SHUFFLE_SEED == jexchange.SHUFFLE_SEED == 42


@pytest.mark.parametrize("n_parts", [1, 3, 8, 16])
def test_partition_table_matches_jax(n_parts):
    rng = np.random.default_rng(n_parts)
    pid = rng.integers(-2, n_parts + 3, CAP).astype(np.int32)
    for rows in (0, 1, 500, CAP):
        jc, jo = jsplit.partition_table(jnp.asarray(pid), jnp.int32(rows),
                                        CAP, n_parts)
        tc, to = tsplit.partition_table(torch.from_numpy(pid),
                                        torch.tensor(rows), CAP, n_parts)
        assert tc.dtype == to.dtype == torch.int32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        # stable within a partition, every active row in exactly once
        order = to.numpy()
        bounds = np.concatenate([[0], np.cumsum(tc.numpy())])
        for p in range(n_parts):
            seg = order[bounds[p]: bounds[p + 1]]
            assert (np.diff(seg) > 0).all()


def test_reorder_columns_match_jax():
    keys = _keys(7)
    cols = dict(keys, v=(np.arange(N, dtype=np.int64), "LONG", None))
    jb, tb = both_batch(cols, N, CAP)
    rows = N - 11
    jpid = jexchange.partition_ids([jb.columns[0], jb.columns[4]],
                                   jnp.int32(rows), CAP, 8)
    _, jo = jsplit.partition_table(jpid, jnp.int32(rows), CAP, 8)
    want = jsplit.reorder_columns(list(jb.columns), jo, jnp.int32(rows))
    tpid = texchange.partition_ids([tb.columns[0], tb.columns[4]],
                                   torch.tensor(rows), CAP, 8)
    _, to = tsplit.partition_table(tpid, torch.tensor(rows), CAP, 8)
    got = tsplit.reorder_columns(list(tb.columns), to, torch.tensor(rows))
    for j, t in zip(want, got):
        valid = t.validity.numpy()
        np.testing.assert_array_equal(valid, np.asarray(j.validity))
        assert not valid[rows:].any()
        tl = t.to_pylist(rows)
        jl = j.to_pylist(rows)
        assert [x if x == x else "nan" for x in tl] == \
            [x if x == x else "nan" for x in jl]


def test_no_kernel_launches_on_cpu_tensors():
    keys = _keys(3)
    _, tb = both_batch({k: keys[k] for k in ("i", "l", "d")}, N, CAP)
    for fn in (murmur3_lanes.murmur3_columns, row_gather.dma_row_gather):
        fn.launches = 0
    pid = texchange.partition_ids(list(tb.columns), torch.tensor(N), CAP, 4)
    _, order = tsplit.partition_table(pid, torch.tensor(N), CAP, 4)
    tsplit.reorder_columns(list(tb.columns), order, torch.tensor(N))
    assert murmur3_lanes.murmur3_columns.launches == 0
    assert row_gather.dma_row_gather.launches == 0
