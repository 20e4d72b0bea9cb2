"""The host shuffle exchange in the port (exec/exchange.py over
shuffle/manager.py) against the JAX package's, on the CPU:

- hash, roundrobin, single and range partitioning into 1, 3 and 8
  partitions, over several map batches with an empty one among them:
  every partition's rows, in order, equal the reference's static plan
  (the reference with its adaptive and partition-recovery planes off,
  which the port does not have);
- the flat stream is the partitions in order; the output stays on the
  child's device (the CPU here) and every frame is one upload seam;
- no file is left under the shuffle root after the partitions are
  drained, after a consumer closes early, or after the write raises;
- ShuffledHashJoinExec (inner; integer keys, string keys, a residual
  condition, the build on either side) equals a nested-loop oracle and
  the reference's rows in order (a string-key join built on the left is
  held to the oracle alone: the reference drops rows there, ROADMAP
  C.5); BroadcastExchangeExec equals the reference's rows.
"""

import os

import numpy as np
import pytest

from spark_rapids_tpu.config import RapidsConf
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import exchange as jexchange
from spark_rapids_tpu.expr import core as jcore

from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import exchange as texchange
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.shuffle import manager as tmanager
from spark_rapids_tpu_torch.shuffle.serializer import CODEC_COPY

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases

#: the reference's static plan: no adaptive replanning, no lineage
JAX_CONF = RapidsConf({"spark.rapids.tpu.adaptive.enabled": False,
                       "spark.rapids.tpu.task.partitionRecovery.enabled":
                       False})
WORDS = ["", "a", "REG AIR", "héllo", "AIR", "x" * 40]
SIZES = (300, 0, 517, 1)


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


@pytest.fixture(autouse=True)
def _fresh_manager(tmp_path):
    mgr = tmanager.reset_shuffle_manager(str(tmp_path))
    yield mgr
    assert mgr.registered() == 0
    assert os.listdir(mgr.root_dir()) == []


def _columns(n, seed):
    rng = np.random.default_rng(seed)

    def valid():
        return rng.random(n) > 0.15
    d = rng.standard_normal(n)
    d[rng.random(n) < 0.05] = np.nan
    d[rng.random(n) < 0.05] = -0.0
    return {
        "k": (rng.integers(-20, 20, n).astype(np.int32), "INT", valid()),
        "l": (rng.integers(-2**40, 2**40, n), "LONG", valid()),
        "d": (d, "DOUBLE", valid()),
        "s": ([WORDS[i] for i in rng.integers(0, len(WORDS), n)], "STRING",
              valid()),
        "v": (np.arange(n, dtype=np.int64) + 1000 * seed, "LONG", None),
    }


def _scans(sizes=SIZES, seed=0, columns=_columns):
    js, ts = [], []
    for i, n in enumerate(sizes):
        jb, tb = both_batch(columns(n, seed + i), n)
        js.append(jb)
        ts.append(tb)
    return (jbasic.InMemoryScanExec(js, js[0].schema),
            tbasic.InMemoryScanExec(ts, ts[0].schema))


def _norm(rows):
    return [tuple("NaN" if isinstance(x, float) and x != x else x
                  for x in r) for r in rows]


def _parts(exchange):
    return [_norm(r for b in g for r in b.to_pylist())
            for g in exchange.execute_partitions()]


def _pair(partitioning, n_parts, keys=("k",), range_order=None, sizes=SIZES,
          seed=0):
    jscan, tscan = _scans(sizes, seed)
    jex = jexchange.HostShuffleExchangeExec(
        [jcore.col(k) for k in keys] if partitioning == "hash" else [],
        jscan, n_parts, JAX_CONF, partitioning=partitioning,
        range_order=range_order)
    tex = texchange.HostShuffleExchangeExec(
        [tcore.col(k) for k in keys] if partitioning == "hash" else [],
        tscan, n_parts, partitioning=partitioning, range_order=range_order)
    return jex, tex


CASES = {
    "hash int": ("hash", ("k",), None),
    "hash long+string": ("hash", ("l", "s"), None),
    "hash double": ("hash", ("d",), None),
    "roundrobin": ("roundrobin", (), None),
    "single": ("single", (), None),
    "range int asc nulls first": ("range", (), (0, True, True)),
    "range double desc nulls last": ("range", (), (2, False, False)),
    "range string asc": ("range", (), (3, True, False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n_parts", [1, 3, 8])
def test_partitions_match_jax_in_order(case, n_parts):
    partitioning, keys, order = CASES[case]
    if partitioning == "single" and n_parts != 1:
        n_parts = 1
    jex, tex = _pair(partitioning, n_parts, keys, order)
    want = _parts(jex)
    got = _parts(tex)
    assert len(got) == n_parts
    assert got == want
    assert sum(map(len, got)) == sum(SIZES)


def test_flat_stream_is_the_partitions_in_order():
    jex, tex = _pair("hash", 8, ("k",))
    parts = _parts(tex)
    flat = _norm(r for b in tex.execute() for r in b.to_pylist())
    assert flat == [r for p in parts for r in p]
    assert flat == _norm(r for b in jex.execute() for r in b.to_pylist())
    m = tex.metrics
    assert m["numInputBatches"].value == 2 * len(SIZES)
    assert m["numMapsWithRows"].value == 2 * 3
    assert m["numReorderGathers"].value == 2 * 3
    assert m["numFramesWritten"].value > 0
    assert m["numOutputRows"].value == sum(SIZES)


def test_output_lies_on_the_childs_device_and_copy_codec_reads_back():
    jscan, tscan = _scans()
    tex = texchange.HostShuffleExchangeExec([tcore.col("k")], tscan, 3,
                                            codec=CODEC_COPY)
    batches = list(tex.execute())
    assert all(t.device.type == "cpu" for b in batches for c in b.columns
               for t in c.leaves())
    jex = jexchange.HostShuffleExchangeExec([jcore.col("k")], jscan, 3,
                                            JAX_CONF)
    assert _norm(r for b in batches for r in b.to_pylist()) == \
        _norm(r for b in jex.execute() for r in b.to_pylist())


def test_empty_partitions_yield_one_empty_batch_each():
    _, tscan = _scans(sizes=(50,))
    tex = texchange.HostShuffleExchangeExec([], tscan, 4,
                                            partitioning="single")
    gens = list(tex.execute_partitions())
    counts = [[b.num_rows_host for b in g] for g in gens]
    assert counts == [[50], [0], [0], [0]]


def test_no_file_is_left_after_an_early_close(_fresh_manager):
    mgr = _fresh_manager
    _, tex = _pair("hash", 8, ("k",))
    outer = tex.execute_partitions()
    first = next(outer)
    next(first)
    assert os.listdir(mgr.root_dir())  # the map outputs exist
    outer.close()
    assert os.listdir(mgr.root_dir()) == []
    first.close()
    # the flat stream closed after one batch
    _, tex = _pair("roundrobin", 3)
    flat = tex.execute()
    next(flat)
    flat.close()
    assert os.listdir(mgr.root_dir()) == []
    # partitions dropped unread
    _, tex = _pair("hash", 3, ("s",))
    parts = list(tex.execute_partitions())
    del parts
    assert os.listdir(mgr.root_dir()) == []


def test_no_file_is_left_when_the_child_raises(_fresh_manager):
    class Boom(tbasic.InMemoryScanExec):
        def internal_execute(self):
            yield from self._batches[:2]
            raise RuntimeError("boom")
    _, tscan = _scans()
    boom = Boom(tscan._batches, tscan.output_schema)
    tex = texchange.HostShuffleExchangeExec([tcore.col("k")], boom, 3)
    with pytest.raises(RuntimeError, match="boom"):
        list(tex.execute())
    assert os.listdir(_fresh_manager.root_dir()) == []


def _join_columns(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "k": (rng.integers(0, 60, n).astype(np.int32), "INT",
              rng.random(n) > 0.1),
        "s": ([WORDS[i] for i in rng.integers(0, len(WORDS), n)], "STRING",
              rng.random(n) > 0.1),
        "x": (rng.random(n) * 100, "DOUBLE", None),
    }


def _join_pair(keys, build_side, condition, n_parts=4):
    def rename(cols, suffix):
        return lambda n, seed: {k + suffix: v
                                for k, v in cols(n, seed).items()}
    sides = []
    for suffix, sizes, seed in (("", (400, 0, 333), 0), ("_b", (90, 71), 50)):
        sides.append(_scans(sizes, seed, rename(_join_columns, suffix)))
    (jl, tl), (jr, tr) = sides
    plans = []
    for m, core, l, r, kw in (
            (jexchange, jcore, jl, jr, {"conf": JAX_CONF}),
            (texchange, tcore, tl, tr, {})):
        lk = [core.col(k) for k in keys]
        rk = [core.col(k + "_b") for k in keys]
        cond = None if not condition else \
            core.col("x") < core.col("x_b")
        lex = m.HostShuffleExchangeExec(lk, l, n_parts, **kw)
        rex = m.HostShuffleExchangeExec(rk, r, n_parts, **kw)
        plans.append(m.ShuffledHashJoinExec(lex, rex, lk, rk, "inner",
                                            build_side=build_side,
                                            condition=cond))
    return plans


def _join_oracle(tplan, keys, condition):
    """The inner join's rows by nested loops over the two exchanges'
    input batches."""
    def rows(exchange):
        return [r for b in exchange.child._batches for r in b.to_pylist()]
    left, right = rows(tplan.children[0]), rows(tplan.children[1])
    names = tplan.children[0].output_schema.names
    pos = [names.index(k) for k in keys]
    xpos = names.index("x")
    out = []
    for a in left:
        for b in right:
            if all(a[i] is not None and a[i] == b[i] for i in pos) and \
                    (not condition or a[xpos] < b[xpos]):
                out.append(a + b)
    return sorted(_norm(out), key=repr)


@pytest.mark.parametrize("keys", [("k",), ("s",), ("k", "s")],
                         ids="+".join)
@pytest.mark.parametrize("build_side", ["right", "left"])
@pytest.mark.parametrize("condition", [False, True])
def test_shuffled_hash_join_matches_jax(keys, build_side, condition):
    jplan, tplan = _join_pair(keys, build_side, condition)
    got = _norm(r for b in tplan.execute() for r in b.to_pylist())
    assert len(got) > 0
    assert sorted(got, key=repr) == _join_oracle(tplan, keys, condition)
    if build_side == "left" and "s" in keys:
        # the reference drops rows of a string-key join built on the left
        # (ROADMAP C.5): the port is held to the oracle above alone
        return
    want = _norm(r for b in jplan.execute() for r in b.to_pylist())
    assert got == want


def test_broadcast_exchange_matches_jax_and_replays():
    jscan, tscan = _scans()
    jb = jexchange.BroadcastExchangeExec(jscan)
    tb = texchange.BroadcastExchangeExec(tscan)
    want = _norm(r for b in jb.execute() for r in b.to_pylist())
    first = list(tb.execute())
    assert len(first) == 1
    assert _norm(first[0].to_pylist()) == want
    assert list(tb.execute())[0] is first[0]
