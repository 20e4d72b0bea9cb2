"""Late materialization in the port against the JAX package, on the CPU:
the dictionary decode (`materialize_column`, `decoded_byte_bucket`), the
string row gather and concat it rides on, a build side of several
encoded batches (decoded at the join's concat seam), and a root
`execute()` that emits decoded strings.

Both packages get the same numpy arrays; the JAX columns are built from
the port's padded buffers. Everything compared is bytes, offsets,
validity, byte buckets or rows: exact, no tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar import encoded as jenc
from spark_rapids_tpu.columnar.column import StringColumn as JString
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import joins as jjoins
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred
from spark_rapids_tpu.ops import basic as jops

from spark_rapids_tpu_torch.columnar import encoded as tenc
from spark_rapids_tpu_torch.columnar.column import StringColumn as TString
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import joins as tjoins
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import predicates as tpred
from spark_rapids_tpu_torch.ops import basic as tops

from test_torch_encoded import both_batch, both_column
from test_torch_jax_ref import jax_aliases

WORDS = ("", "AIR", "REG AIR", "DELIVER IN PERSON", "x", "TAKE BACK RETURN",
         "MED PACK", "unused one", "unused two")


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _same_string(j, t):
    assert isinstance(t, TString) and isinstance(j, JString)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    np.testing.assert_array_equal(t.offsets.numpy(), np.asarray(j.offsets))
    np.testing.assert_array_equal(t.validity.numpy(), np.asarray(j.validity))


def _dictionary(seed, n, capacity=None):
    """A dictionary column in both packages: empty strings, nulls, codes
    only into the first 7 entries (the last two unused), and some valid
    rows whose code is NULL_CODE."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 7, n).astype(np.int32)
    valid = rng.random(n) > 0.15
    j, t = both_column((codes, WORDS), "STRING", valid, capacity)
    stray = rng.random(t.capacity) < 0.05
    t.codes[torch.from_numpy(stray)] = tenc.NULL_CODE
    j = jenc.DictionaryColumn(jnp.asarray(t.codes.numpy()), j.dict_data,
                              j.dict_offsets, j.validity, jt.StringType())
    return j, t


@pytest.mark.parametrize("seed,n,capacity",
                         [(0, 1000, None), (1, 1, None), (2, 129, 4096),
                          (3, 5000, None), (4, 64, 128)])
def test_materialize_column_matches_jax(seed, n, capacity):
    j, t = _dictionary(seed, n, capacity)
    assert tenc.decoded_byte_bucket(t) == jenc.decoded_byte_bucket(j)
    before = tenc.counters()
    out = tenc.materialize_column(t)
    _same_string(jenc.materialize_column(j), out)
    after = tenc.counters()
    assert after["materializations"] == before["materializations"] + 1
    assert after["materialized_bytes"] == before["materialized_bytes"] \
        + out.byte_capacity
    # a plain column passes through
    plain = both_column(np.arange(5, dtype=np.int32), "INT")[1]
    assert tenc.materialize_column(plain) is plain


@pytest.mark.parametrize("seed", range(4))
def test_gather_string_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 300
    vals = [None if rng.random() < 0.1 else
            WORDS[rng.integers(0, len(WORDS))] * int(rng.integers(1, 4))
            for _ in range(n)]
    t = TString.from_pylist(vals, device="cpu")
    j = JString(jnp.asarray(t.data.numpy()), jnp.asarray(t.offsets.numpy()),
                jnp.asarray(t.validity.numpy()), jt.StringType())
    idx = rng.integers(-3, t.capacity + 20, 700).astype(np.int32)
    for cap in (None, 1 << 14):
        _same_string(jops.gather_column(j, jnp.asarray(idx),
                                        out_byte_capacity=cap),
                     tops.gather_column(t, torch.from_numpy(idx),
                                        out_byte_capacity=cap))
    # sanitize and concat of two string columns
    _same_string(jops.sanitize(j, 250), tops.sanitize(t, 250))
    _same_string(jops.concat_columns(j, j, 250, 200, 1024),
                 tops.concat_columns(t, t, 250, 200, 1024))


def _join_plans(seed, n_parts=600, n_lines=3000, part_batches=3):
    """lineitems (one batch, an encoded ship mode) join parts given as
    `part_batches` batches, each with its own dictionaries; part keys are
    unique, so both packages emit the same rows in the same order."""
    rng = np.random.default_rng(seed)
    keys = rng.permutation(n_parts).astype(np.int64)
    brands = tuple(f"Brand#{i}{'!' * (i % 5)}" for i in range(25))
    lines = {
        "l_key": (rng.integers(0, n_parts + 50, n_lines).astype(np.int64),
                  "LONG", rng.random(n_lines) > 0.05),
        "l_mode": ((rng.integers(0, 3, n_lines).astype(np.int32),
                    ("AIR", "REG AIR", "")), "STRING", None),
        "l_qty": (rng.integers(1, 50, n_lines).astype(np.int32), "INT",
                  None),
    }
    jl, tl = both_batch(lines, n_lines)
    parts_j, parts_t = [], []
    step = n_parts // part_batches
    for b in range(part_batches):
        sl = slice(b * step, (b + 1) * step)
        # each batch draws its own dictionary: a shuffled subset
        words = tuple(rng.permutation(brands)[: 10 + b])
        jb, tb = both_batch({
            "p_key": (keys[sl], "LONG", None),
            "p_brand": ((rng.integers(0, len(words), step).astype(np.int32),
                         words), "STRING", rng.random(step) > 0.1),
            "p_size": (rng.integers(1, 50, step).astype(np.int32), "INT",
                       None)}, step)
        parts_j.append(jb)
        parts_t.append(tb)

    def plan(basic, joins, core, pred, lb, pbs):
        col, lit = core.col, core.lit
        ln = basic.FilterExec(pred.In(col("l_mode"), ["AIR", "REG AIR"]),
                              basic.InMemoryScanExec([lb], lb.schema))
        pt = basic.FilterExec(col("p_size") < lit(40),
                              basic.InMemoryScanExec(pbs, pbs[0].schema))
        return joins.HashJoinExec(ln, pt, [col("l_key")], [col("p_key")],
                                  "inner", build_side="right")

    return (plan(jbasic, jjoins, jcore, jpred, jl, parts_j),
            plan(tbasic, tjoins, tcore, tpred, tl, parts_t))


@pytest.mark.parametrize("seed", range(3))
def test_multi_batch_encoded_build_side_matches_jax(seed):
    jplan, tplan = _join_plans(seed)
    before = tenc.counters()["materializations"]
    tout = list(tplan.execute())
    # the three part batches decode at the concat seam (one column
    # each), then the root decodes the stream side's ship mode
    assert tenc.counters()["materializations"] - before == 3 + len(tout)
    assert all(isinstance(c, TString) for c in
               (tout[0].columns[1], tout[0].columns[4]))
    trows = [r for b in tout for r in b.to_pylist()]
    jrows = [tuple(r) for b in jplan.execute() for r in b.to_pylist()]
    assert len(trows) > 500
    assert trows == jrows
    # duplicated build rows need more bytes than the build's own bucket
    brand = tout[0].columns[4]
    assert brand.byte_capacity >= int(brand.offsets[-1])


def test_root_execute_emits_decoded_strings():
    rng = np.random.default_rng(11)
    n = 900
    jb, tb = both_batch({
        "m": ((rng.integers(0, 5, n).astype(np.int32), WORDS[:5]), "STRING",
              rng.random(n) > 0.1),
        "s": ((rng.integers(0, 4, n).astype(np.int32), WORDS[3:7]),
              "STRING", None),
        "q": (rng.integers(0, 9, n).astype(np.int32), "INT", None)}, n)

    def plan(basic, core, pred, b):
        return basic.FilterExec(pred.Not(pred.EqualTo(core.col("s"),
                                                      core.lit("x"))),
                                basic.InMemoryScanExec([b], b.schema))

    before = tenc.counters()["materializations"]
    tout = list(plan(tbasic, tcore, tpred, tb).execute())
    jout = list(plan(jbasic, jcore, jpred, jb).execute())
    assert tenc.counters()["materializations"] - before == 2
    assert len(tout) == len(jout) == 1
    assert tout[0].num_rows_host == jout[0].num_rows_host > 500
    for j, t in zip(jout[0].columns[:2], tout[0].columns[:2]):
        _same_string(j, t)
    np.testing.assert_array_equal(tout[0].columns[2].data.numpy(),
                                  np.asarray(jout[0].columns[2].data))
    # collect() takes the encoded batch and decodes on the host instead
    assert plan(tbasic, tcore, tpred, tb).collect() == \
        [tuple(r) for r in jout[0].to_pylist()]
