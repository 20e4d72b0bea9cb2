"""String ordering in the port (ops/sort.py, exec/sort.py) against the JAX
package, on the CPU:

- `string_prefix_lanes` bit for bit (the port's signed lane is the JAX
  package's u64 lane with its top bit flipped) and `string_words_for`;
- `sort_permutation` over string and integer keys, ascending and
  descending, nulls first and last, exact;
- SortExec and TopNExec over strings that order "a" < "ab" < "b", strings
  past 8 and 16 bytes, bytes >= 0x80 and the empty string, against the
  JAX package's rows and Python's byte order;
- the out-of-core merge of runs whose strings need different word
  counts, against the JAX package's rows and Python's order;
- strings that differ only by trailing NUL bytes ("ab", "ab\\0"): the
  port's length lane orders them as Python's byte order does, and keeps
  them apart as groups on the hash and the sort route and in min/max.
  The JAX package's lanes tie them (ROADMAP C.5), so Python is the
  reference there.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import sort as jsortexec
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.ops import sort as jsort

from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import sort as tsortexec
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.ops import aggregate as topagg
from spark_rapids_tpu_torch.ops import sort as tsort

from test_torch_encoded import both_batch, both_column
from test_torch_jax_ref import jax_aliases

JAX = SimpleNamespace(core=jcore, basic=jbasic, sortexec=jsortexec)
TORCH = SimpleNamespace(core=tcore, basic=tbasic, sortexec=tsortexec)

#: strings whose byte order tests the prefix lanes' edges
EDGE = ["a", "ab", "b", "", "abcdefgh", "abcdefghi",
        "abcdefghijklmnop", "abcdefghijklmnopq", "abcdefghijklmnoz",
        "\x7f", "\x80", "é", "ü€", "𝄞", "Z", "aa", "a b", "REG AIR", "AIR"]


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _words(seed, n, longest=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, longest + 1))
        out.append("".join(chr(c) for c in rng.integers(0x20, 0x250, k)))
    return out


@pytest.mark.parametrize("words", [4, 8])
def test_prefix_lanes_and_word_count_match_jax(words):
    vals = EDGE + _words(1, 300, longest=70)
    j, t = both_column(vals, "STRING")
    assert tsort.string_words_for([t], [0]) == \
        jsort.string_words_for([j], [0]) >= 16     # up to 140 bytes
    jl = jsort.string_prefix_lanes(j, words)
    tl = tsort.string_prefix_lanes(t, words)
    assert len(tl) == len(jl) == words
    for a, b in zip(tl, jl):
        want = (np.asarray(b) ^ np.uint64(1 << 63)).view(np.int64)
        np.testing.assert_array_equal(a.numpy(), want)
    _, short = both_column(["abc", "é"], "STRING")
    assert tsort.string_words_for([t, short], [1]) == 4


@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("nulls_first", [True, False])
def test_sort_permutation_with_string_keys_matches_jax(asc, nulls_first):
    rng = np.random.default_rng(2)
    n = 600
    vals = [EDGE[i] for i in rng.integers(0, len(EDGE), n)]
    js, ts = both_column(vals, "STRING", rng.random(n) > 0.1)
    ji, ti = both_column(rng.integers(0, 3, n).astype(np.int32), "INT",
                         rng.random(n) > 0.1)
    jo = [jsort.SortOrder(0, asc, nulls_first), jsort.SortOrder(1)]
    to = [tsort.SortOrder(0, asc, nulls_first), tsort.SortOrder(1)]
    cap = js.capacity
    want = np.asarray(jsort.sort_permutation([js, ji], jo, jnp.int32(n),
                                             cap, 4))
    got = tsort.sort_permutation([ts, ti], to, torch.tensor(n), cap, 4)
    np.testing.assert_array_equal(got.numpy()[:n], want[:n])


def _py_order(vals, asc, nulls_first):
    present = sorted((v for v in vals if v is not None), key=str.encode,
                     reverse=not asc)
    nulls = [None] * sum(v is None for v in vals)
    return nulls + present if nulls_first else present + nulls


def _rows(plan):
    return [r for b in plan.execute() for r in b.to_pylist()]


@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("nulls_first", [True, False])
@pytest.mark.parametrize("limit", [None, 7])
def test_sort_and_topn_exec_order_strings(asc, nulls_first, limit):
    vals = EDGE + [None, None] + _words(3, 40)
    n = len(vals)
    cols = {"s": (vals, "STRING", [v is not None for v in vals]),
            "i": (np.arange(n, dtype=np.int64), "LONG", None)}
    jb, tb = both_batch(cols, n)

    def plan(p, b):
        order = [(p.core.col("s"), asc, nulls_first)]
        scan = p.basic.InMemoryScanExec([b], b.schema)
        if limit is None:
            return p.sortexec.SortExec(order, scan)
        return p.sortexec.TopNExec(limit, order, scan)

    trows = _rows(plan(TORCH, tb))
    assert trows == _rows(plan(JAX, jb))
    want = _py_order(vals, asc, nulls_first)
    assert [r[0] for r in trows] == want[:limit]


def test_out_of_core_merge_with_runs_of_different_word_counts():
    """12 runs (fan-in 8: two merge passes): the even runs hold strings of
    at most 16 characters, the odd ones up to 60, so the runs' heads need
    different lane counts; the merged order is exact, as in the JAX
    package and Python."""
    rng = np.random.default_rng(4)
    batches, all_vals = [], []
    for r in range(12):
        longest = 16 if r % 2 == 0 else 60
        vals = [f"{w}" for w in _words(10 + r, 50, longest)]
        vals = [v + f"#{r:02d}{i:03d}" if len(v) > 8 else v
                for i, v in enumerate(vals)]
        vals[rng.integers(0, 50)] = None
        all_vals += vals
        cols = {"s": (vals, "STRING", [v is not None for v in vals]),
                "r": (np.full(50, r, np.int32), "INT", None)}
        batches.append(both_batch(cols, 50))

    def plan(p, k):
        scan = p.basic.InMemoryScanExec([b[k] for b in batches],
                                        batches[0][k].schema)
        return p.sortexec.SortExec([(p.core.col("s"), True, False)], scan)

    assert len({tsort.string_words_for(b[1].columns, [0])
                for b in batches}) > 1
    tplan = plan(TORCH, 1)
    trows = _rows(tplan)
    assert tplan.metrics["mergePasses"].value == 2
    assert trows == _rows(plan(JAX, 0))
    assert [r[0] for r in trows] == _py_order(all_vals, True, False)


#: each pair in both input orders, so a tie kept in input order is wrong
#: ascending and descending alike
NULS = ["ab\0", "ab", "ab\0", "a", "a\0", "a", "ab\0\0", "", "\0",
        "", "x" * 20 + "\0", "x" * 20, "x" * 20 + "\0"]


@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("nulls_first", [True, False])
def test_trailing_nul_strings_order_apart(asc, nulls_first):
    vals = NULS + [None]
    n = len(vals)
    cols = {"s": (vals, "STRING", [v is not None for v in vals])}
    _, tb = both_batch(cols, n)
    scan = TORCH.basic.InMemoryScanExec([tb], tb.schema)
    plan = TORCH.sortexec.SortExec([(TORCH.core.col("s"), asc,
                                     nulls_first)], scan)
    assert [r[0] for r in _rows(plan)] == _py_order(vals, asc, nulls_first)


@pytest.mark.parametrize("route", ["hash", "sort"])
def test_trailing_nul_strings_group_apart(route):
    _, tk = both_column(NULS, "STRING")
    n, cap = len(NULS), tk.capacity
    aggs = [("count_star", None)]
    if route == "hash":
        keys, res, ng, left = topagg.groupby_aggregate_hash(
            [tk], aggs, torch.tensor(n), cap, 2)
        assert not bool(left)
    else:
        keys, res, ng = topagg.groupby_aggregate([tk], aggs,
                                                 torch.tensor(n), cap)
    ng = int(ng)
    got = dict(zip(keys[0].to_pylist(ng), res[0][1][0].numpy()[:ng]))
    assert got == {v: NULS.count(v) for v in NULS}


def test_trailing_nul_strings_min_max():
    """min/max over strings (the sort path's `_pick_string_pos`): the
    shorter string is the smaller."""
    _, tk = both_column(["g"] * 4, "STRING")
    _, tw = both_column(["ab\0", "ab", "ab\0", "ab"], "STRING")
    keys, res, ng = topagg.groupby_aggregate(
        [tk], [("min", tw), ("max", tw)], torch.tensor(4), tk.capacity)
    assert int(ng) == 1
    assert [r[1].to_pylist(1) for r in res] == [["ab"], ["ab\0"]]
