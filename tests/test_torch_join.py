"""Parity of the port's hash join (ops/join.py, ops/probe_verify.py,
exec/joins.py) with the JAX package.

- `BuildTable.build`: bucket offsets, the valid count and the sorted key
  lanes exact; the sort permutation and the sorted payload exact where
  build keys are unique, and equal as multisets within each run of equal
  hashes where they repeat (the reference's sort leaves that order open).
- `probe_counts`, `candidate_fill_inputs`, `expand_candidates` and
  `inner_gather_maps` exact.
- The plain `fused_probe_verify` against the JAX Pallas kernel in
  interpret mode and against the JAX XLA expand-then-verify: exact on the
  slots below the candidate total, (False, -1, -1, -1) above it. Cases
  with duplicate build keys, buckets shared by several keys, empty ranges,
  nulls on both sides and a candidate bucket smaller than the total.
- `HashJoinExec` (inner, filters absorbed as key validity) row for row
  against the JAX exec.
- The bucket hash pair (`join_hash_pair`, both seeds from one chain) over
  key lists of mixed kinds with nulls, longer than one launch of the
  murmur3 kernel, and a build table and probe over two key columns.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import joins as jjoins
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.ops import join as jj
from spark_rapids_tpu.ops import pallas_join as jpj

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.columnar.column import Column as TColumn
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import joins as tjoins
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.ops import join as tj
from spark_rapids_tpu_torch.ops import probe_verify as tpv

from test_torch_jax_ref import jax_aliases

BUILD_CAP = 4096
STREAM_CAP = 8192


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


def _pair(values, type_name, valid, cap):
    jc = JColumn.from_numpy(values, getattr(jt, type_name), validity=valid,
                            capacity=cap)
    tc = TColumn(torch.from_numpy(np.asarray(jc.data).copy()),
                 torch.from_numpy(np.asarray(jc.validity).copy()),
                 getattr(tt, type_name))
    return jc, tc


def _sides(seed, key_type="LONG", dup=False, build_rows=3000,
           stream_rows=7000, key_dom=6000):
    """Build keys (unique, or each repeated up to 3 times), a DOUBLE
    payload, stream keys drawn from twice the build domain (so many have
    empty ranges); ~5% nulls on both sides."""
    rng = np.random.default_rng(seed)
    np_dtype = getattr(tt, key_type).np_dtype
    if dup:
        bkeys = rng.integers(0, build_rows // 2, build_rows)
    else:
        bkeys = rng.permutation(key_dom)[:build_rows]
    bkeys = (bkeys * 7919 - 10_000).astype(np_dtype)
    skeys = (rng.integers(0, key_dom * 2, stream_rows) * 7919 - 10_000) \
        .astype(np_dtype)
    skeys[::3] = bkeys[rng.integers(0, build_rows, len(skeys[::3]))]
    bk = _pair(bkeys, key_type, rng.random(build_rows) > 0.05, BUILD_CAP)
    bp = _pair(rng.random(build_rows) * 100.0, "DOUBLE",
               rng.random(build_rows) > 0.1, BUILD_CAP)
    sk = _pair(skeys, key_type, rng.random(stream_rows) > 0.05, STREAM_CAP)
    return bk, bp, sk, build_rows, stream_rows


def _build_both(bk, bp, build_rows):
    jb = jj.BuildTable.build([bk[0]], [bk[0], bp[0]], jnp.int32(build_rows),
                             BUILD_CAP)
    tb = tj.BuildTable.build([bk[1]], [bk[1], bp[1]],
                             torch.tensor(build_rows), BUILD_CAP)
    return jb, tb


def _hash_runs(tb):
    """Runs of equal (k_hi, k_lo, valid) in the port's sorted order."""
    hi, lo = tj.join_hash_pair(tb.key_cols)
    valid = tj._keys_valid(tb.key_cols, tb.num_rows, tb.capacity)
    p = tb.perm.long()
    key = np.stack([hi[p].numpy(), lo[p].numpy(),
                    valid[p].numpy().astype(np.int32)], axis=1)
    change = np.any(key[1:] != key[:-1], axis=1)
    return np.split(np.arange(len(p)), np.nonzero(change)[0] + 1)


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("key_type", ["LONG", "INT"])
def test_build_table_matches_jax(key_type, dup):
    bk, bp, _, build_rows, _ = _sides(1, key_type, dup)
    jb, tb = _build_both(bk, bp, build_rows)
    assert int(tb.valid_count) == int(jb.valid_count)
    np.testing.assert_array_equal(tb.bucket_table.numpy(),
                                  np.asarray(jb.bucket_table))
    np.testing.assert_array_equal(tb.pair_table.numpy(),
                                  np.asarray(jb.pair_table))
    jlanes = np.stack([np.asarray(x) for x in jb.key_lanes[0]], axis=1)
    np.testing.assert_array_equal(tb.key_lanes[0].numpy().view(np.uint32),
                                  jlanes)
    np.testing.assert_array_equal(tb.key_lanes[1].numpy(),
                                  np.asarray(jb.key_lanes[1]) != 0)
    jperm, tperm = np.asarray(jb.perm), tb.perm.numpy()
    jpmat = np.asarray(jb.pack[4])
    tpmat = tb.pack[1].numpy().view(np.uint32)
    np.testing.assert_array_equal(tb.pack[2].numpy(), np.asarray(jb.pack[5]))
    if not dup:
        np.testing.assert_array_equal(tperm, jperm)
        np.testing.assert_array_equal(tpmat, jpmat)
        return
    assert sorted(tperm) == list(range(BUILD_CAP))
    for run in _hash_runs(tb):
        assert sorted(tperm[run]) == sorted(jperm[run])
        assert sorted(map(tuple, tpmat[run])) == \
            sorted(map(tuple, jpmat[run]))


def _probe_inputs(seed, key_type="LONG", dup=False):
    bk, bp, sk, build_rows, stream_rows = _sides(seed, key_type, dup)
    jb, tb = _build_both(bk, bp, build_rows)
    jlo, jcounts, jvalid = jj.probe_counts(jb, [sk[0]],
                                           jnp.int32(stream_rows), STREAM_CAP)
    tlo, tcounts, tvalid = tj.probe_counts(tb, [sk[1]],
                                           torch.tensor(stream_rows),
                                           STREAM_CAP)
    return (jb, tb, sk, (jlo, jcounts, jvalid), (tlo, tcounts, tvalid))


@pytest.mark.parametrize("key_type", ["LONG", "INT"])
def test_probe_counts_and_expansion_match_jax(key_type):
    _, _, _, (jlo, jcounts, jvalid), (tlo, tcounts, tvalid) = \
        _probe_inputs(2, key_type)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    total = int(np.asarray(jcounts).sum())
    assert 0 < total
    assert (np.asarray(jcounts) == 0).sum() > 1000  # empty ranges
    for cap in (1 << (total - 1).bit_length(), 128):  # fits; overflows
        jseg, jls = jj.candidate_fill_inputs(jlo, jcounts, cap)
        tseg, tls = tj.candidate_fill_inputs(tlo, tcounts, cap)
        np.testing.assert_array_equal(tseg.numpy(), np.asarray(jseg))
        np.testing.assert_array_equal(tls.numpy(), np.asarray(jls))
        js, jp, jt_ = jj.expand_candidates(jlo, jcounts, cap)
        ts, tp, tt_ = tj.expand_candidates(tlo, tcounts, cap)
        assert int(tt_) == int(jt_) == total
        live = np.arange(cap) < total
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tp.numpy()[live], np.asarray(jp)[live])


def _assert_probe_equal(got, want, total):
    """Exact below the candidate total; (False, -1) above it, where the
    reference's build_pos/build_row are unspecified."""
    gv, gs, gp, gr = (x.numpy() for x in got)
    wv, ws, wp, wr = (np.asarray(x) for x in want)
    live = np.arange(len(gv)) < total
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gp[live], wp[live])
    np.testing.assert_array_equal(gr[live], wr[live])
    assert not gv[~live].any() and (gs[~live] == -1).all()
    assert (gp[~live] == -1).all() and (gr[~live] == -1).all()


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("key_type", ["LONG", "INT"])
def test_probe_verify_plain_matches_interpret_kernel_and_xla(key_type, dup):
    jb, tb, sk, (jlo, jcounts, _), (tlo, tcounts, _) = \
        _probe_inputs(3, key_type, dup)
    total = int(np.asarray(jcounts).sum())
    jsl, jsv = jj.int_key_lanes([sk[0]])
    tsl, tsv = tj.int_key_lanes([sk[1]])
    for cap in (1 << (total - 1).bit_length(), 1 << (total // 2).bit_length()
                ):  # the second is smaller than the total
        want = jpj.fused_probe_verify(jlo, jcounts, *jb.key_lanes, jsl, jsv,
                                      jb.perm, cap, interpret=True)
        got = tpv.fused_probe_verify(tlo, tcounts, *tb.key_lanes, tsl, tsv,
                                     tb.perm, cap)
        assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
        _assert_probe_equal(got, want, min(total, cap))
        # the JAX XLA expand-then-verify gives the same verified pairs
        js, jp, _ = jj.expand_candidates(jlo, jcounts, cap)
        ok, brow = jj.verify_pairs(jb, [sk[0]], js, jp, js >= 0)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ok))
        live = np.arange(cap) < total
        np.testing.assert_array_equal(got[3].numpy()[live],
                                      np.asarray(brow)[live])
        tok, tbrow = tj.verify_pairs(tb, [sk[1]], got[1], got[2],
                                     got[1] >= 0)
        assert torch.equal(tok, got[0])


def test_probe_verify_empty_stream_and_wrapper_checks():
    empty = torch.zeros(0, dtype=torch.int32)
    lanes = torch.zeros((128, 2), dtype=torch.int32)
    v, s, p, r = tpv.fused_probe_verify(
        empty, empty, lanes, torch.ones(128, dtype=torch.bool),
        torch.zeros((0, 2), dtype=torch.int32),
        torch.zeros(0, dtype=torch.bool),
        torch.arange(128, dtype=torch.int32), 128)
    assert not v.any() and (s == -1).all() and (p == -1).all()
    with pytest.raises(TypeError):
        tpv.fused_probe_verify(empty, empty, lanes,
                               torch.ones(128, dtype=torch.bool),
                               torch.zeros((0, 1), dtype=torch.int32),
                               torch.zeros(0, dtype=torch.bool),
                               torch.arange(128, dtype=torch.int32), 128)
    meta = [x.to("meta") for x in (empty, empty, lanes)]
    with pytest.raises(ValueError):
        tpv.fused_probe_verify(
            *meta, torch.ones(128, dtype=torch.bool, device="meta"),
            torch.zeros((0, 2), dtype=torch.int32, device="meta"),
            torch.zeros(0, dtype=torch.bool, device="meta"),
            torch.arange(128, dtype=torch.int32, device="meta"), 128)


def test_inner_gather_maps_match_jax():
    jb, tb, sk, (jlo, jcounts, _), (tlo, tcounts, _) = _probe_inputs(4)
    total = int(np.asarray(jcounts).sum())
    cap = 1 << (total - 1).bit_length()
    js, jp, jtot = jj.expand_candidates(jlo, jcounts, cap)
    jok, jbrow = jj.verify_pairs(jb, [sk[0]], js, jp, js >= 0)
    ts, tp, ttot = tj.expand_candidates(tlo, tcounts, cap)
    tok, tbrow = tj.verify_pairs(tb, [sk[1]], ts, tp, ts >= 0)
    want = jj.inner_gather_maps(jok, js, jbrow, jtot)
    got = tj.inner_gather_maps(tok, ts, tbrow, ttot)
    assert int(got[2]) == int(want[2]) > 0
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


#: join key lists of mixed kinds: two columns, five (more than one
#: launch of the murmur3 kernel), all nine fixed-width kinds
MIXED_KEYS = {
    "two": ["INT", "LONG"],
    "five": ["SHORT", "DOUBLE", "BOOLEAN", "TIMESTAMP", "FLOAT"],
    "nine": ["BOOLEAN", "BYTE", "SHORT", "INT", "DATE", "LONG", "TIMESTAMP",
             "FLOAT", "DOUBLE"],
}


def _mixed_key(rng, type_name, cap):
    """Exactly `cap` rows of a key type: negative values, NaN and -0.0
    among the floats, ~10% nulls."""
    if type_name == "BOOLEAN":
        vals = rng.integers(0, 2, cap).astype(np.bool_)
    elif type_name in ("FLOAT", "DOUBLE"):
        vals = rng.normal(0, 100, cap)
        vals[::5], vals[::7] = np.nan, -0.0
        vals = vals.astype(getattr(tt, type_name).np_dtype)
    else:
        vals = rng.integers(-500, 500, cap).astype(
            getattr(tt, type_name).np_dtype)
    valid = rng.random(cap) > 0.1
    jc = JColumn(jnp.asarray(vals), jnp.asarray(valid), getattr(jt, type_name))
    tc = TColumn(torch.from_numpy(vals.copy()), torch.from_numpy(valid),
                 getattr(tt, type_name))
    return jc, tc


@pytest.mark.parametrize("cap", [0, 13, 2048])
@pytest.mark.parametrize("keys", list(MIXED_KEYS))
def test_join_hash_pair_of_mixed_key_lists_matches_jax(keys, cap):
    rng = np.random.default_rng(cap + 3 * len(keys))
    pairs = [_mixed_key(rng, name, cap) for name in MIXED_KEYS[keys]]
    jhi, jlo = jj.join_hash_pair([p[0] for p in pairs])
    thi, tlo = tj.join_hash_pair([p[1] for p in pairs])
    assert thi.shape == tlo.shape == (cap,)
    np.testing.assert_array_equal(thi.numpy().view(np.uint32),
                                  np.asarray(jhi))
    np.testing.assert_array_equal(tlo.numpy().view(np.uint32),
                                  np.asarray(jlo))
    only_hi, none = tj.join_hash_pair([p[1] for p in pairs], lo_too=False)
    assert none is None and torch.equal(only_hi, thi)


def test_build_and_probe_over_two_key_columns_match_jax():
    rng = np.random.default_rng(31)
    n_b, n_s = 3000, 7000
    b_int = rng.integers(0, 60, n_b).astype(np.int32)
    b_long = (rng.permutation(n_b) * 7919 - 5000).astype(np.int64)
    s_idx = rng.integers(0, n_b, n_s)
    s_int = np.where(rng.random(n_s) < 0.7, b_int[s_idx],
                     rng.integers(0, 60, n_s)).astype(np.int32)
    s_long = b_long[s_idx]
    bk = [_pair(b_int, "INT", rng.random(n_b) > 0.05, BUILD_CAP),
          _pair(b_long, "LONG", rng.random(n_b) > 0.05, BUILD_CAP)]
    sk = [_pair(s_int, "INT", rng.random(n_s) > 0.05, STREAM_CAP),
          _pair(s_long, "LONG", rng.random(n_s) > 0.05, STREAM_CAP)]
    jb = jj.BuildTable.build([k[0] for k in bk], [bk[1][0]],
                             jnp.int32(n_b), BUILD_CAP)
    tb = tj.BuildTable.build([k[1] for k in bk], [bk[1][1]],
                             torch.tensor(n_b), BUILD_CAP)
    assert int(tb.valid_count) == int(jb.valid_count)
    np.testing.assert_array_equal(tb.bucket_table.numpy(),
                                  np.asarray(jb.bucket_table))
    np.testing.assert_array_equal(tb.perm.numpy(), np.asarray(jb.perm))
    jlo, jcounts, jvalid = jj.probe_counts(jb, [k[0] for k in sk],
                                           jnp.int32(n_s), STREAM_CAP)
    tlo, tcounts, tvalid = tj.probe_counts(tb, [k[1] for k in sk],
                                           torch.tensor(n_s), STREAM_CAP)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert int(np.asarray(jcounts).sum()) > 0


def test_cpu_probe_counts_no_launch():
    tpv.fused_probe_verify.launches = 0
    _, tb, sk, _, (tlo, tcounts, _) = _probe_inputs(5)
    tsl, tsv = tj.int_key_lanes([sk[1]])
    tpv.fused_probe_verify(tlo, tcounts, *tb.key_lanes, tsl, tsv, tb.perm,
                           1 << 14)
    assert tpv.fused_probe_verify.launches == 0


# -- the exec ---------------------------------------------------------------

def _join_plans(seed, build_side, dup=False, key_type="LONG"):
    rng = np.random.default_rng(seed)
    n_o, n_l = 1500, 6000
    np_dtype = getattr(tt, key_type).np_dtype
    okeys = (rng.permutation(n_o) if not dup
             else rng.integers(0, n_o // 2, n_o)).astype(np_dtype)
    data = {
        "o_key": okeys,
        "o_flag": rng.integers(0, 10, n_o).astype(np.int32),
        "l_key": rng.integers(0, n_o + 300, n_l).astype(np_dtype),
        "l_price": rng.random(n_l) * 1000.0,
        "l_flag": rng.integers(0, 4, n_l).astype(np.int32),
    }
    valid = {name: rng.random(len(v)) > 0.03 for name, v in data.items()}

    def plan(t, Batch, Column, basic, joins, core, device):
        o_schema = t.Schema((t.StructField("o_key", getattr(t, key_type)),
                             t.StructField("o_flag", t.INT)))
        l_schema = t.Schema((t.StructField("l_key", getattr(t, key_type)),
                             t.StructField("l_price", t.DOUBLE),
                             t.StructField("l_flag", t.INT)))

        def batch(schema, n):
            kw = {"device": device} if device else {}
            cols = [Column.from_numpy(data[f.name], f.data_type,
                                      validity=valid[f.name], **kw)
                    for f in schema.fields]
            return Batch(cols, n, schema)

        col, lit = core.col, core.lit
        o = basic.FilterExec(col("o_flag") < lit(5), basic.InMemoryScanExec(
            [batch(o_schema, n_o)], o_schema))
        ln = basic.FilterExec(col("l_flag") != lit(0),
                              basic.InMemoryScanExec([batch(l_schema, n_l)],
                                                     l_schema))
        left, right = (ln, o) if build_side == "right" else (o, ln)
        lk, rk = (("l_key", "o_key") if build_side == "right"
                  else ("o_key", "l_key"))
        return joins.HashJoinExec(left, right, [col(lk)], [col(rk)],
                                  "inner", build_side=build_side)

    jplan = plan(jt, JBatch, JColumn, jbasic, jjoins, jcore, None)
    tplan = plan(tt, TBatch, TColumn, tbasic, tjoins, tcore, "cpu")
    return jplan, tplan


def _rows(plan):
    return [r for b in plan.execute() for r in b.to_pylist()]


@pytest.mark.parametrize("build_side", ["right", "left"])
@pytest.mark.parametrize("key_type", ["LONG", "INT"])
def test_hash_join_exec_matches_jax_row_for_row(build_side, key_type):
    jplan, tplan = _join_plans(6, build_side, key_type=key_type)
    assert tplan.output_grouped_by == jplan.output_grouped_by
    assert [type(c).__name__ for c in tplan.children] == \
        ["InMemoryScanExec", "InMemoryScanExec"]
    want, got = _rows(jplan), _rows(tplan)
    assert len(want) > 1000
    assert got == want


def test_hash_join_exec_duplicate_build_keys_match_as_multisets():
    jplan, tplan = _join_plans(7, "right", dup=True)
    want, got = _rows(jplan), _rows(tplan)
    assert len(want) > 1000
    assert sorted(got, key=repr) == sorted(want, key=repr)
    # key-grouped emission: equal join keys are contiguous
    keys = [r[0] for r in got]
    seen, prev = set(), object()
    for k in keys:
        if k != prev:
            assert k not in seen
            seen.add(k)
            prev = k


def test_hash_join_exec_refuses_what_it_does_not_port():
    """What the JAX package refuses, the port refuses at construction: a
    semi join built on the left, a join type HashJoinExec does not have.
    A key the probe kernel does not take (DOUBLE against LONG) runs the
    expand-and-verify route and matches the JAX package row for row."""
    jplan, tplan = _join_plans(8, "right")
    left, right = tplan.children
    with pytest.raises(ValueError, match="builds on the right"):
        tjoins.HashJoinExec(left, right, [tcore.col("l_key")],
                            [tcore.col("o_key")], "left_semi",
                            build_side="left")
    with pytest.raises(ValueError, match="not 'cross'"):
        tjoins.HashJoinExec(left, right, [tcore.col("l_key")],
                            [tcore.col("o_key")], "cross")
    jl, jr = jplan.children
    got = _rows(tjoins.HashJoinExec(left, right, [tcore.col("l_price")],
                                    [tcore.col("o_key")], "inner"))
    want = _rows(jjoins.HashJoinExec(jl, jr, [jcore.col("l_price")],
                                     [jcore.col("o_key")], "inner"))
    assert got == want


# -- the kernel's grid and its tiled arithmetic -----------------------------

@pytest.mark.parametrize("n_stream, tiles", [
    (0, 0), (1, 1), (tpv.TILE, 1), (tpv.TILE + 1, 2),
    (2_097_152, 2_097_152 // tpv.TILE), (8_388_608, 8_388_608 // tpv.TILE)])
def test_probe_tile_count(n_stream, tiles):
    assert tpv.tile_count(n_stream) == tiles


@pytest.mark.parametrize("n_tiles, sms, bps", [
    (0, 132, 8), (1, 132, 8), (512, 132, 8), (1056, 132, 8), (1057, 132, 8),
    (2048, 132, 8), (2048, 132, 3), (5, 1, 1), (100_000, 132, 8),
    (512, 132, 4), (2048, 132, 4), (1026, 132, 4), (3, 132, 4), (0, 1, 1),
    (8448, 132, 4), (8449, 132, 4)])
def test_probe_grid_is_one_wave_of_whole_chunks(n_tiles, sms, bps):
    per, chunks = tpv.grid(n_tiles, sms, bps)
    tiles = max(n_tiles, 1)                        # no row: one empty tile
    assert 1 <= chunks <= sms * bps                # one wave
    assert (chunks - 1) * per < tiles <= chunks * per
    assert per == -(-tiles // (sms * bps))         # fewest tiles a block


def _look_back(aggs, rng, window=32):
    """Each chunk's exclusive offset by the kernel's look-back: walk the
    predecessors a window at a time, each word holding its aggregate or
    (at random, as a race would leave it) its inclusive prefix, summing up
    to and including the nearest inclusive word."""
    incl = np.cumsum(aggs)
    out = []
    for c in range(len(aggs)):
        off, pred = 0, c - 1
        while pred >= 0:
            t = np.arange(pred, pred - window, -1)
            words = [(True, 0) if x < 0 else
                     ((True, incl[x]) if x == 0 or rng.random() < 0.2
                      else (False, aggs[x])) for x in t]
            stop = next((i for i, (f, _) in enumerate(words) if f),
                        window - 1)
            off += sum(v for _, v in words[:stop + 1])
            if any(f for f, _ in words):
                break
            pred -= window
        out.append(off)
    return np.array(out, dtype=np.int64)


def _tiled_expand(lo, counts, cap, tile, per, rng):
    """csrc/probe_verify.cu's arithmetic in torch: chunks of `per` tiles,
    their offsets by look-back, each tile's exclusive scan (a tile with no
    candidate skipped), and each slot's owner by the kernel's binary
    search of the tile prefix. Returns (stream_idx, build_pos) over `cap`
    slots, -1 where no slot was emitted."""
    n = counts.shape[0]
    n_tiles = -(-n // tile)
    chunks = -(-n_tiles // per)
    padded = torch.zeros(max(chunks * per * tile, 1), dtype=torch.int64)
    padded[:n] = counts.to(torch.int64)
    aggs = padded[:chunks * per * tile].view(chunks, -1).sum(1).numpy()
    offsets = _look_back(aggs, rng)
    s_idx = torch.full((cap,), -1, dtype=torch.int64)
    b_pos = torch.full((cap,), -1, dtype=torch.int64)
    for c in range(chunks):
        e = int(offsets[c])
        if aggs[c] == 0 or e >= cap:
            continue
        for k in range(per):
            if e >= cap:
                break
            base = (c * per + k) * tile
            cnt = padded[base: base + tile]
            excl = torch.cat([torch.zeros(1, dtype=torch.int64),
                              torch.cumsum(cnt, 0)])
            tile_sum = int(excl[-1])
            if tile_sum == 0:
                continue
            emit = min(tile_sum, cap - e)
            p = torch.arange(emit, dtype=torch.int64)
            r = torch.zeros(emit, dtype=torch.int64)
            step = tile // 2
            while step >= 1:
                r = torch.where(excl[r + step] <= p, r + step, r)
                step //= 2
            j = base + r
            s_idx[e: e + emit] = j
            b_pos[e: e + emit] = lo.to(torch.int64)[j] + (p - excl[r])
            e += tile_sum
    return s_idx, b_pos


def _counts_case(seed, n, kind):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 4, n).astype(np.int32)
    counts[rng.random(n) < 0.4] = 0
    if kind == "long ranges":
        counts[rng.integers(0, n, 5)] = 3 * 64 + 7
    elif kind == "empty tiles":
        for t in range(0, n, 3 * 64):
            counts[t: t + 64] = 0
    elif kind == "total 0":
        counts[:] = 0
    lo = rng.integers(0, 1 << 20, n).astype(np.int32)
    return torch.from_numpy(lo), torch.from_numpy(counts)


@pytest.mark.parametrize("kind", ["mixed", "long ranges", "empty tiles",
                                  "total 0"])
@pytest.mark.parametrize("n, per", [(64 * 170 + 13, 1), (64 * 170 + 13, 3),
                                    (77, 2)])
@pytest.mark.parametrize("cap_of", ["fits", "equal", "below"])
def test_tiled_probe_arithmetic_equals_expand_candidates(kind, n, per,
                                                         cap_of):
    lo, counts = _counts_case(n + per, n, kind)
    total = int(counts.to(torch.int64).sum())
    cap = {"fits": total + 100, "equal": max(total, 1),
           "below": max(total // 3, 1)}[cap_of]
    want_s, want_p, want_total = tj.expand_candidates(lo, counts, cap)
    assert int(want_total) == total
    got_s, got_p = _tiled_expand(lo, counts, cap, 64, per,
                                 np.random.default_rng(n))
    live = min(total, cap)
    assert torch.equal(got_s[:live], want_s[:live].to(torch.int64))
    assert torch.equal(got_p[:live], want_p[:live].to(torch.int64))
    assert (got_s[live:] == -1).all() and (want_s[live:] == -1).all()
