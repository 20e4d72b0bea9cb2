"""The mesh exchange's primitives (parallel/exchange.py,
parallel/distributed.py) and ShuffleExchangeExec in the port against the
JAX package's, on the CPU. The JAX side runs over the first 4 of
conftest's 8 virtual devices (shard_map), the port over 4 "cpu" shards:

- negotiate_slot_cap and partition_slots equal the reference's;
- exchange_columns over LONG, DOUBLE, STRING with nulls and decimal128
  columns, with an empty partition, a grid below the worst case and a
  string width that cuts the longest strings: every shard's received
  rows, their order, its row count and capacity equal the reference's;
- all_to_all moves block d of shard s to row s of shard d and counts its
  bytes;
- make_distributed_groupby over string keys equals the reference shard
  by shard, and raises past its string width;
- ShuffleExchangeExec: each row on its hash partition, every row once,
  rounds bounded by sql.exchange.roundBytes with one host read each,
  staged pieces that spill and come back, an early close that releases
  them, a struct<string> field longer than every top-level string
  crossing whole, and the identity without a mesh.
"""

import decimal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.parallel import distributed as jdist
from spark_rapids_tpu.parallel import exchange as jx
from spark_rapids_tpu.parallel import mesh as jmesh

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import exchange as texchange
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.memory import (buffer_catalog,
                                           reset_buffer_catalog)
from spark_rapids_tpu_torch.parallel import distributed as tdist
from spark_rapids_tpu_torch.parallel import exchange as tx
from spark_rapids_tpu_torch.parallel.mesh import (Mesh, device_mesh,
                                                  set_active_mesh)

from test_torch_jax_ref import jax_aliases, one_torch_thread

N = 4


@pytest.fixture(scope="module", autouse=True)
def _env():
    with jax_aliases(), one_torch_thread():
        yield
    set_active_mesh(None)


def _schema(t):
    return t.Schema((t.StructField("k", t.LONG), t.StructField("v", t.DOUBLE),
                     t.StructField("s", t.STRING),
                     t.StructField("dec", t.DecimalType(30, 2))))


def _shard_data(sizes, seed, keys=9, word=11):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        out.append({
            "k": [int(x) for x in rng.integers(0, keys, n)],
            "v": [None if x % 5 == 0 else float(x) * 0.25
                  for x in rng.integers(0, 100, n)],
            "s": [None if x % 7 == 0 else "wörd" * (x % word)
                  for x in rng.integers(0, 100, n)],
            "dec": [None if x % 6 == 0
                    else decimal.Decimal(int(x) * 123456789123).scaleb(-2)
                    for x in rng.integers(0, 10 ** 6, n)]})
    return out


def _jax_exchange(batches, slot_cap, width):
    """The reference's exchange over the first N virtual devices."""
    stacked = jdist.stack_batches(batches)
    schema = batches[0].schema

    def spmd(sb):
        local = jax.tree_util.tree_map(lambda x: x[0], sb)
        cols, n = jx.exchange_columns(
            list(local.columns), [0], local.num_rows, local.capacity,
            jmesh.DATA_AXIS, N, slot_cap=slot_cap, string_width=width)
        out = JBatch(cols, n, schema)
        return jax.tree_util.tree_map(lambda x: x[None], out)

    step = jax.jit(jmesh.shard_map_compat(
        spmd, mesh=jmesh.device_mesh(N), in_specs=P(jmesh.DATA_AXIS),
        out_specs=P(jmesh.DATA_AXIS)))
    return jdist.unstack_batches(step(stacked), N)


def test_negotiate_slot_cap_matches_jax():
    for measured in (0, 1, 3, 100, 127, 129, 5000):
        for cap in (128, 1024, 4096):
            for hint in (0, 7, 300):
                assert tx.negotiate_slot_cap(measured, cap, hint) == \
                    jx.negotiate_slot_cap(measured, cap, hint)


@pytest.mark.parametrize("n_parts, cap, rows, slot_cap", [
    (4, 128, 100, 128), (4, 128, 128, 16), (3, 512, 0, 512),
    (8, 256, 200, 32), (1, 128, 77, 128)])
def test_partition_slots_match_jax(n_parts, cap, rows, slot_cap):
    rng = np.random.default_rng(cap + rows)
    pid = rng.integers(0, n_parts, cap).astype(np.int32)
    pid[rows:] = n_parts                      # inactive rows
    want = np.asarray(jx.partition_slots(jnp.asarray(pid), jnp.int32(rows),
                                         cap, n_parts, slot_cap))
    got = tx.partition_slots(torch.from_numpy(pid), rows, cap, n_parts,
                             slot_cap).numpy()
    np.testing.assert_array_equal(got, want)
    placed = got[got >= 0]
    assert len(set(placed.tolist())) == len(placed)


def test_all_to_all_moves_block_d_of_shard_s_to_row_s_of_shard_d():
    mesh = device_mesh(N, device="cpu")
    per_shard = [torch.arange(N * 3, dtype=torch.int64).reshape(N, 3)
                 + 100 * s for s in range(N)]
    c0 = tx.counters()
    out = tx.all_to_all(per_shard, mesh)
    for d in range(N):
        for s in range(N):
            assert torch.equal(out[d][s], per_shard[s][d])
    c1 = tx.counters()
    assert c1["calls"] - c0["calls"] == 1
    assert c1["bytes"] - c0["bytes"] == N * N * 3 * 8
    with pytest.raises(ValueError):
        tx.all_to_all(per_shard[:2], mesh)


@pytest.mark.parametrize("case", ["mixed", "empty partition",
                                  "grid below worst case", "cut strings"])
def test_exchange_columns_matches_jax(case):
    sizes, keys, slot_cap, width = (40, 0, 17, 64), 9, None, 64
    if case == "empty partition":
        keys = 2                          # two keys over four partitions
    elif case == "grid below worst case":
        slot_cap = 8                      # rows past 8 a partition drop
    elif case == "cut strings":
        width = 8                         # the longest words are 40 bytes
    data = _shard_data(sizes, seed=len(case), keys=keys)
    jb = [JBatch.from_pydict(d, _schema(jt)) for d in data]
    tb = tdist.stack_batches([TBatch.from_pydict(d, _schema(tt),
                                                 device="cpu")
                              for d in data])
    want = _jax_exchange(jb, slot_cap, width)
    cols, n_recv = tx.exchange_columns(
        [b.columns for b in tb], [0], [b.num_rows for b in tb],
        tb[0].capacity, device_mesh(N, device="cpu"), N,
        slot_cap=slot_cap, string_width=width)
    empty = 0
    for d in range(N):
        got = TBatch(cols[d], n_recv[d], _schema(tt))
        assert int(n_recv[d]) == int(want[d].num_rows)
        assert cols[d][0].capacity == want[d].capacity
        assert got.to_pylist() == want[d].to_pylist()
        np.testing.assert_array_equal(cols[d][0].data.numpy(),
                                      np.asarray(want[d].columns[0].data))
        np.testing.assert_array_equal(
            cols[d][1].validity.numpy(),
            np.asarray(want[d].columns[1].validity))
        empty += int(n_recv[d]) == 0
    if case == "empty partition":
        assert empty >= 1
    total = sum(int(r) for r in n_recv)
    if case == "grid below worst case":
        assert total < sum(sizes)
    else:
        assert total == sum(sizes)


def test_distributed_groupby_matches_jax_by_shard():
    rng = np.random.default_rng(7)
    words = ["alpha", "bravo", "charlie", "delta", None]
    data = [{"k": [words[i] for i in rng.integers(0, 5, 32)],
             "v": rng.integers(0, 50, 32).tolist()} for _ in range(N)]

    def schema(t):
        return t.Schema((t.StructField("k", t.STRING),
                         t.StructField("v", t.LONG)))

    def out_schema(t):
        return t.Schema((t.StructField("k", t.STRING),
                         t.StructField("s", t.LONG)))
    jstep = jdist.make_distributed_groupby(
        jmesh.device_mesh(N), 1, [("sum", 1)], ["sum"], [jt.LONG],
        out_schema(jt))
    want = jdist.unstack_batches(jstep(jdist.stack_batches(
        [JBatch.from_pydict(d, schema(jt)) for d in data])), N)
    tstep = tdist.make_distributed_groupby(
        device_mesh(N, device="cpu"), 1, [("sum", 1)], ["sum"], [tt.LONG],
        out_schema(tt))
    batches = [TBatch.from_pydict(d, schema(tt), device="cpu")
               for d in data]
    got = tstep(batches)
    assert [b.to_pylist() for b in got] == [b.to_pylist() for b in want]
    oracle = {}
    for d in data:
        for k, v in zip(d["k"], d["v"]):
            oracle[k] = oracle.get(k, 0) + v
    assert dict(r for b in got for r in b.to_pylist()) == oracle
    # a key longer than the width would be cut: the step raises
    assert tdist.required_string_width(batches) == \
        jdist.required_string_width(
            [JBatch.from_pydict(d, schema(jt)) for d in data]) == 8
    narrow = tdist.make_distributed_groupby(
        device_mesh(N, device="cpu"), 1, [("sum", 1)], ["sum"], [tt.LONG],
        out_schema(tt), string_width=4)
    with pytest.raises(ValueError, match="required_string_width"):
        narrow(batches)


def test_stack_batches_aligns_capacities_and_byte_buckets():
    data = _shard_data((3, 200, 0, 90), seed=5)
    stacked = tdist.stack_batches([TBatch.from_pydict(d, _schema(tt),
                                                      device="cpu")
                                   for d in data])
    assert len({b.capacity for b in stacked}) == 1
    assert len({b.columns[2].byte_capacity for b in stacked}) == 1
    assert [b.to_pylist() for b in stacked] == [
        TBatch.from_pydict(d, _schema(tt), device="cpu").to_pylist()
        for d in data]
    assert tdist.unstack_batches(stacked, 2) == stacked[:2]


# -- ShuffleExchangeExec ------------------------------------------------------

def _scan(batches):
    return tbasic.InMemoryScanExec(batches, batches[0].schema)


def _port_batches(n_batches=6, rows=150, seed=9):
    data = _shard_data([rows] * n_batches, seed=seed, keys=40)
    return [TBatch.from_pydict(d, _schema(tt), device="cpu")
            for d in data], data


def _pid_of(key):
    b = TBatch.from_pydict({"k": [key]}, tt.Schema((tt.StructField(
        "k", tt.LONG),)), device="cpu")
    return int(tx.partition_ids([b.columns[0]], 1, b.capacity, N)[0])


@pytest.mark.parametrize("round_bytes", [1 << 28, 1])
def test_shuffle_exchange_places_every_row_once(round_bytes):
    batches, data = _port_batches()
    conf = RapidsConf({"spark.rapids.sql.exchange.roundBytes":
                       str(round_bytes)})
    ex = texchange.ShuffleExchangeExec(
        [tcore.col("k")], _scan(batches), device_mesh(N, device="cpu"),
        conf)
    parts = [[r for b in part for r in b.to_pylist()]
             for part in ex.execute_partitions()]
    want = sorted((r for b in batches for r in b.to_pylist()), key=repr)
    assert sorted((r for p in parts for r in p), key=repr) == want
    for p, rows in enumerate(parts):
        assert all(_pid_of(r[0]) == p for r in rows)
    # one round of all six batches, or one round a batch
    assert ex.rounds == (1 if round_bytes > 1 else len(batches))
    assert ex.metrics[texchange.NUM_HOST_READS].value == ex.rounds
    assert buffer_catalog().num_entries() == 0


def test_shuffle_exchange_staged_pieces_spill_and_come_back():
    reset_buffer_catalog()
    batches, data = _port_batches()
    ex = texchange.ShuffleExchangeExec(
        [tcore.col("k")], _scan(batches), device_mesh(N, device="cpu"),
        RapidsConf({"spark.rapids.sql.exchange.roundBytes": "1"}))
    parts = ex.execute_partitions()
    first = [r for b in next(parts) for r in b.to_pylist()]
    assert buffer_catalog().num_entries() > 0
    assert buffer_catalog().synchronous_spill(None) > 0
    rows = first + [r for part in parts for b in part for r in b.to_pylist()]
    assert sorted(rows, key=repr) == sorted(
        (r for b in batches for r in b.to_pylist()), key=repr)
    assert buffer_catalog().counters()["to_device"] > 0
    assert buffer_catalog().num_entries() == 0


def test_shuffle_exchange_early_close_releases_the_staged_pieces():
    import gc
    batches, _ = _port_batches()
    ex = texchange.ShuffleExchangeExec(
        [tcore.col("k")], _scan(batches), device_mesh(N, device="cpu"))
    parts = ex.execute_partitions()
    p0 = next(parts)                          # never started
    p1 = next(parts)
    next(p1)                                  # partly drained
    assert buffer_catalog().num_entries() > 0
    del p0
    p1.close()
    parts.close()                             # partitions 2, 3 never handed
    gc.collect()
    assert buffer_catalog().num_entries() == 0


@pytest.mark.parametrize("top_string", [True, False])
def test_shuffle_exchange_carries_a_long_struct_string_whole(top_string):
    rng = np.random.default_rng(31)
    n = 150
    fields = [tt.StructField("k", tt.LONG), tt.StructField("st", tt.StructType(
        (tt.StructField("name", tt.STRING), tt.StructField("n", tt.LONG))))]
    data = {"k": [int(x) for x in rng.integers(0, 30, n)],
            "st": [None if i % 8 == 0 else
                   {"name": None if i % 5 == 0 else "é" + "y" * (20 + i % 41),
                    "n": i} for i in range(n)]}
    if top_string:
        fields.append(tt.StructField("s", tt.STRING))
        data["s"] = ["c" * (i % 4) for i in range(n)]
    schema = tt.Schema(tuple(fields))
    batches = [TBatch.from_pydict({k: v[i:i + 50] for k, v in data.items()},
                                  schema, device="cpu")
               for i in range(0, n, 50)]
    ex = texchange.ShuffleExchangeExec(
        [tcore.col("k")], _scan(batches), device_mesh(N, device="cpu"))
    parts = [[r for b in part for r in b.to_pylist()]
             for part in ex.execute_partitions()]
    want = sorted((r for b in batches for r in b.to_pylist()), key=repr)
    assert sorted((r for p in parts for r in p), key=repr) == want
    assert tdist.required_string_width(batches) == 64


def test_shuffle_exchange_is_the_identity_without_a_mesh():
    batches, _ = _port_batches(n_batches=2)
    set_active_mesh(None)
    for mesh in (None, Mesh(["cpu"])):
        ex = texchange.ShuffleExchangeExec([tcore.col("k")],
                                           _scan(batches), mesh)
        assert ex.n_partitions == 1
        out = list(ex.execute())
        assert [b.to_pylist() for b in out] == \
            [b.to_pylist() for b in batches]
