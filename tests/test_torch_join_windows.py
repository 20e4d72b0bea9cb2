"""The join's windowed probe (exec/joins.HashJoinExec.probe_windows)
against the JAX package's one-pass probe, on the CPU.

A stream batch whose candidate total passes `WINDOW_SLOTS` (2^30 on the
card) is probed in windows of at most that many slots. Here the constant
is lowered to a few dozen slots (monkeypatched), so that batches of a few
hundred candidates take several windows, and each case is held to the
JAX package, which probes the whole candidate space in one pass:

- every join type (inner, left/right/full outer, left semi, left anti,
  existence; inner and outer joins on both build sides over LONG keys),
  with and without a
  residual condition, over LONG keys (the probe kernel's route, its plain
  version here), STRING keys and DECIMAL(30,2) keys: rows and order equal
  the JAX package's bit for bit;
- a window that cuts inside one stream row (a hot key whose rows each
  span several windows);
- a ShuffledHashJoinExec over four host partitions, an AdaptiveJoinExec,
  and a join over a four-shard mesh (held to its own one pass);
- a join_agg stage whose probe takes windows: its steps run the windowed
  route, counted in the stage's `windowed_steps` and named by the step
  sites as CAUSE_WINDOWED (the eager cause on the card), the rows equal
  the JAX package's compiled plan's;
- a total at or under the window takes one pass: the same probe calls
  and gathers as with the default window, no window counted;
- the output's int32 bound raises, naming it, and the window shrinks to
  what the device budget holds.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import exchange as jexchange
from spark_rapids_tpu.exec import joins as jjoins
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred

from spark_rapids_tpu_torch.api import functions as tF
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import exchange as texchange
from spark_rapids_tpu_torch.exec import joins as tjoins
from spark_rapids_tpu_torch.exec import stage_compiler as tstage
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import predicates as tpred
from spark_rapids_tpu_torch.memory import budget as tbudget
from spark_rapids_tpu_torch.obs import dispatch as tdispatch

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs

JAX = SimpleNamespace(core=jcore, pred=jpred, basic=jbasic, joins=jjoins,
                      exchange=jexchange, t=jt, batch=jbatch,
                      session=jsession, F=jF)
TORCH = SimpleNamespace(core=tcore, pred=tpred, basic=tbasic, joins=tjoins,
                        exchange=texchange, t=tt, batch=tbatch,
                        session=tsession, F=tF)
#: the lowered window: a few dozen slots
WINDOW = 40
N_S, N_B = 160, 48         # stream rows (two batches), build rows
KEY_KINDS = ("LONG", "STRING", "DECIMAL")


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


@pytest.fixture
def window(monkeypatch):
    monkeypatch.setattr(tjoins, "WINDOW_SLOTS", WINDOW)
    return WINDOW


def _key_type(m, kind):
    return m.t.DecimalType(30, 2) if kind == "DECIMAL" \
        else getattr(m.t, kind)


def _key_values(kind, rng, n, dom, null_share=0.1):
    """n keys of `kind` from `dom` distinct values (duplicates on both
    sides), about `null_share` of them null."""
    k = rng.integers(0, dom, n)
    valid = rng.random(n) >= null_share
    if kind == "LONG":
        vals = [int(x) * 7919 - 10 ** 12 for x in k]
    elif kind == "STRING":
        vals = [f"key-{x}" + "x" * int(x % 5) for x in k]
    else:  # DECIMAL(30,2): unscaled values past 2^64
        vals = [int(x) * 10 ** 25 - 3 * int(x) for x in k]
    return [v if ok else None for v, ok in zip(vals, valid)]


def _batches(m, cols, types, splits):
    """Batches of package `m` from Python lists: one per (start, end)."""
    schema = m.t.Schema(tuple(m.t.StructField(name, ty(m))
                              for name, ty in types.items()))
    kw = {"device": "cpu"} if m is TORCH else {}
    return [m.batch.ColumnarBatch.from_pydict(
        {k: v[a:b] for k, v in cols.items()}, schema, **kw)
        for a, b in splits]


def _sides(kind, seed, n_s=N_S, n_b=N_B, dom=8):
    """(stream columns, stream types, build columns, build types): the
    stream keys from two more values than the build keys, so that some
    non-null stream keys match nothing."""
    rng = np.random.default_rng(seed)
    left = {"lk": _key_values(kind, rng, n_s, dom + 2),
            "lv": [float(x) for x in rng.random(n_s) * 100],
            "ls": [f"l{i % 7}" * (i % 3) for i in range(n_s)]}
    right = {"rk": _key_values(kind, rng, n_b, dom),
             "rv": [float(x) for x in rng.random(n_b) * 100],
             "rs": [f"r{i}" for i in range(n_b)]}
    ltypes = {"lk": lambda m: _key_type(m, kind),
              "lv": lambda m: m.t.DOUBLE, "ls": lambda m: m.t.STRING}
    rtypes = {"rk": lambda m: _key_type(m, kind),
              "rv": lambda m: m.t.DOUBLE, "rs": lambda m: m.t.STRING}
    return left, ltypes, right, rtypes


def _scan(m, batches):
    return m.basic.InMemoryScanExec(batches, batches[0].schema)


def _join(m, sides, jt_, build, cond, n_s=N_S):
    left, ltypes, right, rtypes = sides
    half = n_s // 2
    lbs = _batches(m, left, ltypes, ((0, half), (half, n_s)))
    rbs = _batches(m, right, rtypes, ((0, len(right["rk"])),))
    col = m.core.col
    condition = m.pred.LessThan(col("lv"), col("rv")) if cond else None
    return m.joins.HashJoinExec(_scan(m, lbs), _scan(m, rbs), [col("lk")],
                                [col("rk")], jt_, build_side=build,
                                condition=condition)


def _rows(plan):
    plan._encoded_ok_for_parent = True
    return [r for b in plan.execute() for r in b.to_pylist()]


def _same_rows(got, want):
    assert [repr(r) for r in got] == [repr(r) for r in want]


JOIN_TYPES = ("inner", "left_outer", "right_outer", "full_outer",
              "left_semi", "left_anti", "existence")
#: every join type built on the right over each key kind, and the types
#: that may build on the left over LONG keys
JOIN_CASES = [(jt_, "right", kind) for jt_ in JOIN_TYPES
              for kind in KEY_KINDS] + [(jt_, "left", "LONG")
                                        for jt_ in JOIN_TYPES[:4]]


@pytest.mark.parametrize("cond", [False, True], ids=["plain", "condition"])
@pytest.mark.parametrize("jt_, build, kind", JOIN_CASES)
def test_windowed_join_matches_jax_one_pass(window, jt_, build, kind, cond):
    """Rows and order of the windowed probe equal the JAX package's one
    pass bit for bit; every stream batch took several windows."""
    sides = _sides(kind, seed=len(jt_) + 3 * cond)
    port = _join(TORCH, sides, jt_, build, cond)
    got = _rows(port)
    _same_rows(got, _rows(_join(JAX, sides, jt_, build, cond)))
    assert port.window_counters["batches"] == \
        (2 if build == "right" else 1)
    assert port.window_counters["windows"] > 4
    assert port.window_counters["slots"] == window
    assert len(got) > 20


@pytest.mark.parametrize("kind", KEY_KINDS)
def test_window_cut_inside_a_stream_row(monkeypatch, kind):
    """One hot key: 60 build rows share it, so each of its stream rows
    owns 60 candidates and most windows of 16 slots start inside one of
    them. Inner (key-grouped) and left outer joins equal the JAX
    package's rows and order over LONG and DECIMAL keys. Over STRING
    keys the reference drops matches of this shape (ROADMAP C.5: 331 of
    the inner join's 485 rows), so there the windows are held to the
    port's one pass (rows and order) and to a Python count of the
    pairs."""
    rng = np.random.default_rng(7)
    hot = _key_values(kind, rng, 1, 1, null_share=0)[0]
    others = _key_values(kind, np.random.default_rng(8), 30, 1000, 0)
    n_s = 24
    left = {"lk": [hot if i % 3 == 0 else others[i] for i in range(n_s)],
            "lv": [float(i) for i in range(n_s)],
            "ls": [f"s{i}" for i in range(n_s)]}
    right = {"rk": [hot] * 60 + others[:8],
             "rv": [float(i % 50) for i in range(68)],
             "rs": [f"r{i}" for i in range(68)]}
    ltypes = {"lk": lambda m: _key_type(m, kind),
              "lv": lambda m: m.t.DOUBLE, "ls": lambda m: m.t.STRING}
    rtypes = {"rk": lambda m: _key_type(m, kind),
              "rv": lambda m: m.t.DOUBLE, "rs": lambda m: m.t.STRING}
    sides = (left, ltypes, right, rtypes)
    for jt_, cond in (("inner", False), ("left_outer", True)):
        if kind == "STRING":
            want = _rows(_join(TORCH, sides, jt_, "right", cond, n_s=n_s))
        monkeypatch.setattr(tjoins, "WINDOW_SLOTS", 16)
        port = _join(TORCH, sides, jt_, "right", cond, n_s=n_s)
        got = _rows(port)
        if kind != "STRING":
            want = _rows(_join(JAX, sides, jt_, "right", cond, n_s=n_s))
        elif jt_ == "inner":
            assert len(got) == sum(a == b for a in left["lk"]
                                   for b in right["rk"]) == 485
        _same_rows(got, want)
        monkeypatch.setattr(tjoins, "WINDOW_SLOTS", 1 << 30)
        # each half holds four hot rows of 60 candidates each, and the
        # rest's bucket-mates: more than 240 / 16 windows a batch
        assert port.window_counters["windows"] >= 2 * 240 // 16
        assert port.window_counters["slots"] == 16


def test_shuffled_join_takes_windows(window):
    """A ShuffledHashJoinExec over four host partitions (the static plan:
    one join a partition pair) reaches the windowed route through its
    HashJoinExec: rows and order equal the JAX package's."""
    from test_torch_exchange import JAX_CONF, PORT_CONF
    sides = _sides("LONG", seed=11, n_s=200, n_b=60, dom=5)
    left, ltypes, right, rtypes = sides
    out = []
    for m, conf in ((JAX, JAX_CONF), (TORCH, PORT_CONF)):
        col = m.core.col
        lb = _batches(m, left, ltypes, ((0, 200),))
        rb = _batches(m, right, rtypes, ((0, 60),))
        lk, rk = [col("lk")], [col("rk")]
        plan = m.exchange.ShuffledHashJoinExec(
            m.exchange.HostShuffleExchangeExec(lk, _scan(m, lb), 4,
                                               conf=conf),
            m.exchange.HostShuffleExchangeExec(rk, _scan(m, rb), 4,
                                               conf=conf),
            lk, rk, "left_outer", build_side="right",
            condition=m.pred.LessThan(col("lv"), col("rv")))
        out.append(_rows(plan))
        if m is TORCH:
            assert plan._join.window_counters["windows"] > 4
    _same_rows(out[1], out[0])


def test_adaptive_and_mesh_joins_take_windows(window):
    """An AdaptiveJoinExec (its measured strategy builds one side) equals
    the JAX package's rows and order; a ShuffledHashJoinExec over two
    ShuffleExchangeExecs of a four-shard mesh (the planner's distributed
    join) equals its own one pass in rows and order and took windows."""
    from spark_rapids_tpu.config import RapidsConf as JConf
    from spark_rapids_tpu_torch.config import RapidsConf as TConf
    from spark_rapids_tpu_torch.parallel.mesh import device_mesh
    sides = _sides("LONG", seed=13)
    left, ltypes, right, rtypes = sides
    out = []
    for m, conf in ((JAX, JConf()), (TORCH, TConf())):
        col = m.core.col
        lb = _batches(m, left, ltypes, ((0, N_S // 2), (N_S // 2, N_S)))
        rb = _batches(m, right, rtypes, ((0, N_B),))
        plan = m.joins.AdaptiveJoinExec(
            _scan(m, lb), _scan(m, rb), [col("lk")], [col("rk")],
            "full_outer", m.pred.LessThan(col("lv"), col("rv")), conf)
        out.append(_rows(plan))
    _same_rows(out[1], out[0])

    def mesh_join():
        col = tcore.col
        mesh = device_mesh(4, device="cpu")
        lb = _batches(TORCH, left, ltypes, ((0, N_S),))
        rb = _batches(TORCH, right, rtypes, ((0, N_B),))
        lk, rk = [col("lk")], [col("rk")]
        return texchange.ShuffledHashJoinExec(
            texchange.ShuffleExchangeExec(lk, _scan(TORCH, lb), mesh),
            texchange.ShuffleExchangeExec(rk, _scan(TORCH, rb), mesh),
            lk, rk, "inner", condition=tpred.LessThan(col("lv"), col("rv")))
    windowed = mesh_join()
    got = _rows(windowed)
    assert windowed._join.window_counters["windows"] > 1
    tjoins.WINDOW_SLOTS = 1 << 30
    _same_rows(got, _rows(mesh_join()))


def _ja_query(m, sess, n=600):
    """A join under a group-by of LONG sums (a join_agg stage; integer
    sums, so rows compare exactly)."""
    rng = np.random.default_rng(5)
    col, lit, F = m.core.col, m.core.lit, m.F
    t = m.t
    orders = sess.from_pydict(
        {"o": [int(v) for v in rng.integers(0, n // 4, n // 2)],
         "d": rng.integers(0, 100, n // 2).tolist()},
        t.Schema((t.StructField("o", t.LONG), t.StructField("d", t.LONG))))
    lines = sess.from_pydict(
        {"o": [int(v) for v in rng.integers(0, n // 4, n)],
         "x": rng.integers(0, 1000, n).tolist()},
        t.Schema((t.StructField("o", t.LONG), t.StructField("x", t.LONG))))
    return (orders.filter(col("d") < lit(70))
                  .join(lines, on="o")
                  .group_by("o").agg((F.sum(col("x")), "rev"),
                                     (F.count(), "n")))


JA_CONF = {"spark.rapids.sql.broadcastSizeThreshold": "-1",
           "spark.rapids.tpu.agg.speculative.enabled": "false"}


@pytest.mark.parametrize("conf", [JA_CONF, {}], ids=["exact", "speculative"])
def test_join_agg_stage_probes_in_windows(window, conf):
    """A join_agg stage whose probe passes the window: each step takes
    the windowed route (the stage's `windowed_steps`), its step sites
    name CAUSE_WINDOWED for such a call (the cause it runs eagerly under
    on the card) and none for a one-pass call, and the rows equal the
    JAX package's compiled plan's."""
    tstage.reset_stage_counters()
    tdispatch.reset_site_cache()
    sess = tsession.TpuSession(dict(conf), device="cpu")
    q = _ja_query(TORCH, sess)
    plan = q._exec()
    stage = next(n for n in _walk(plan)
                 if type(n).__name__ == "CompiledStageExec")
    assert stage._kind == "join_agg"
    got = sorted(q.collect())
    assert tstage.counters()["windowed_steps"] >= 1
    want = sorted(_ja_query(JAX, jsession.TpuSession(dict(conf))).collect())
    assert got == want
    for site in (stage._step_site, stage._probe_site):
        assert site.graph
        # (table, stream batch, [state, flag,] bucket None, total)
        assert site.cause_of(None, None, None, 7) == tstage.CAUSE_WINDOWED


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def test_at_or_under_the_window_takes_one_pass(monkeypatch):
    """A window equal to the larger batch's candidate total: each batch
    takes one pass, with the same probe calls, candidate buckets and
    gathers as at the default window, and no window counted. One slot
    less and that batch takes two windows: two more probe calls."""
    from spark_rapids_tpu_torch.ops import gather as tgather
    calls = []
    real = tjoins.fused_probe_verify

    def counted(*a, **k):
        calls.append(a[-1])            # the call's candidate bucket
        return real(*a, **k)
    monkeypatch.setattr(tjoins, "fused_probe_verify", counted)
    sides = _sides("LONG", seed=4)

    def run():
        calls.clear()
        g0 = tgather.counters()
        plan = _join(TORCH, sides, "inner", "right", False)
        rows = _rows(plan)
        g1 = tgather.counters()
        return rows, list(calls), {k: g1[k] - g0[k] for k in g1}, plan
    want, default_calls, default_gathers, plan = run()
    build = plan.build_table_of(list(plan.children[1].execute()),
                                plan.children[1])
    totals = [int(plan._counts_kernel(build, b)[3])
              for b in plan.children[0].execute()]
    assert len(default_calls) == 2 and max(totals) > 2 * WINDOW
    monkeypatch.setattr(tjoins, "WINDOW_SLOTS", max(totals))
    rows, at_calls, at_gathers, plan = run()
    _same_rows(rows, want)
    assert at_calls == default_calls and at_gathers == default_gathers
    assert plan.window_counters["windows"] == 0
    assert plan.window_counters["slots"] == 0
    monkeypatch.setattr(tjoins, "WINDOW_SLOTS", max(totals) - 1)
    rows, past_calls, _, plan = run()
    _same_rows(rows, want)
    assert len(past_calls) == 3
    assert plan.window_counters["windows"] == 2
    assert plan.window_counters["batches"] == 1


def test_output_bound_raises_naming_it(window, monkeypatch):
    """More verified pairs in one stream batch than the output's int32
    bound allows (lowered here with the window) raise, naming it."""
    monkeypatch.setattr(tjoins, "MAX_BATCH_PAIRS", 30)
    plan = _join(TORCH, _sides("LONG", seed=2), "inner", "right", False)
    with pytest.raises(NotImplementedError, match="int32"):
        _rows(plan)


def test_window_shrinks_to_the_device_budget(monkeypatch):
    """The window is WINDOW_SLOTS or the largest power of two of slots
    whose working set (13 bytes a slot, and with a condition every
    column's bytes a slot) the device budget still holds."""
    plain = _join(TORCH, _sides("LONG", seed=1), "inner", "right", False)
    cond = _join(TORCH, _sides("LONG", seed=1), "inner", "right", True)
    build = plain.build_table_of(list(plain.children[1].execute()),
                                 plain.children[1])
    stream = next(iter(plain.children[0].execute()))
    try:
        tbudget.reset_memory_budget(13 * 1000)
        assert plain.window_slots(build, stream) == 512
        per_slot = 13 + sum(tjoins._row_bytes(c) for c in
                            list(stream.columns) + list(build.payload))
        tbudget.reset_memory_budget(per_slot * 100)
        assert cond.window_slots(build, stream) == 64
        tbudget.reset_memory_budget(1 << 40)
        assert plain.window_slots(build, stream) == tjoins.WINDOW_SLOTS
    finally:
        tbudget.reset_memory_budget()
