"""Each query's port result against the benchmark's plain reference, through
a whole run of a cell (tables, session, warm-up, window, comparison) at a
tiny scale factor on the CPU, for both configurations and both mixes: the
two cells of BENCHMARK.json and the two its Open questions name next."""

import copy
import json

import pytest

from harness import bench

SF = 0.002
CELLS = [("tpch-sf10-dbl", "join"), ("tpch-sf10-dec", "pricing"),
         ("tpch-sf10-dec", "join"), ("tpch-sf10-dbl", "pricing")]


def spec_with_cells():
    """BENCHMARK.json with the four cells, each listed by the metrics that
    list the committed cell of its mix."""
    spec = bench.Spec()
    b = copy.deepcopy(spec.bench)
    b["workloads"] = [{"name": f"{c}.{m}", "config": c, "traffic": m,
                       "chips": 1, "why": "test"} for c, m in CELLS]
    committed = {w["traffic"]: w["name"] for w in spec.bench["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [f"{c}.{mix}" for c, mix in CELLS
                              if committed[mix] in m["workloads"]]
    return bench.Spec(spec.root, b)


def tiny(spec, cfg_name, batch_bytes=None):
    cfg = spec.config(cfg_name)
    cfg["scale_factor"] = SF
    if batch_bytes:
        cfg["confs"]["spark.rapids.sql.batchSizeBytes"] = str(batch_bytes)
    return cfg


@pytest.mark.parametrize("cfg_name,traffic", CELLS)
def test_cell_is_correct_on_the_cpu(cfg_name, traffic):
    spec = spec_with_cells()
    out = bench.run_cell(spec, f"{cfg_name}.{traffic}", 2**31 + 99, 0.5,
                         False, device="cpu", config=tiny(spec, cfg_name))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 2
    cell = f"{cfg_name}.{traffic}"
    assert set(out["metrics"]) == {m["name"]
                                   for m in spec.metrics(cell, False)}
    assert {f"rows_per_s.{traffic}", "setup_s"} <= set(out["metrics"])
    json.dumps(out)


def test_tables_in_several_batches_are_correct():
    """Tables cut into several batches, as SF10's lineitem is."""
    spec = spec_with_cells()
    out = bench.run_cell(spec, "tpch-sf10-dbl.join", 5, 0.2, False,
                         device="cpu",
                         config=tiny(spec, "tpch-sf10-dbl", 1 << 18))
    assert out["correct"], out["checks"]


def test_every_query_of_a_round_is_compared(monkeypatch):
    spec = spec_with_cells()
    seen = []
    real = bench.query_module

    def spy(name):
        mod = real(name)
        compare = mod.compare

        def counted(got, want, r, out):
            seen.append(name)
            return compare(got, want, r, out)
        mod.compare = counted
        return mod
    monkeypatch.setattr(bench, "query_module", spy)
    out = bench.run_cell(spec, "tpch-sf10-dbl.join", 3, 1e-6, False,
                         device="cpu", config=tiny(spec, "tpch-sf10-dbl"))
    assert sorted(seen) == ["q19", "q21", "q3", "q4"]
    assert out["attempted"] == 4


def test_the_window_draws_fresh_parameters_for_every_query():
    """Every query of the window has parameters of its own drawn from the
    seed, apart from the warm-up's; the same seed draws the same stream."""
    queries = {q: bench.query_module(q) for q in ("q3", "q4", "q19", "q21")}
    a, b = bench.Schedule(7, queries), bench.Schedule(7, queries)
    rounds_a = [a.round() for _ in range(8)]
    assert rounds_a == [b.round() for _ in range(8)]
    assert a.warm == b.warm
    drawn = [json.dumps(p, sort_keys=True) for r in rounds_a for q, p in r
             if q == "q19"]
    assert len(set(drawn)) == len(drawn) == 8
    other = bench.Schedule(8, queries)
    assert [other.round() for _ in range(8)] != rounds_a


def test_a_mix_option_reaches_every_draw():
    queries = {"q1": bench.query_module("q1")}
    s = bench.Schedule(3, queries, {"q1": {"aggregates": "all"}})
    assert all(p["aggregates"] == "all" for _, p in s.warm + s.round())


def test_scans_left_unpruned_are_correct():
    """The configuration's prune_scans off: every scan hands the plan all
    of its table's resident columns."""
    spec = spec_with_cells()
    cfg = tiny(spec, "tpch-sf10-dbl")
    cfg["prune_scans"] = False
    out = bench.run_cell(spec, "tpch-sf10-dbl.join", 11, 1e-6, False,
                         device="cpu", config=cfg)
    assert out["correct"], out["checks"]


def test_full_q1_reference_on_decimal_against_python_decimals():
    """Q1 with all eight aggregates on DECIMAL(12,2), as the reference
    holds it for a mix that asks for it: against the same sums in Python's
    decimal module, with Spark's types (sum_charge at scale 6, each avg at
    scale 6 rounded half up)."""
    from decimal import ROUND_HALF_UP, Decimal

    from harness import reference, tpch
    q1 = bench.query_module("q1")
    cfg = bench.Spec().config("tpch-sf10-dec")
    gen = tpch.Generator(13, 0.001, "cpu")
    r = reference.RefContext(gen, cfg["money"])
    params = {"delta": 75, "aggregates": "all"}
    got = q1.reference(r, params)
    cols = {c: gen.column(c).tolist() for c in q1.TABLES["lineitem"]}
    groups = {}
    for i, ship in enumerate(cols["l_shipdate"]):
        if ship > q1.END - 75:
            continue
        key = (tpch.RETURNFLAGS[cols["l_returnflag"][i]],
               tpch.LINESTATUSES[cols["l_linestatus"][i]])
        qty = Decimal(cols["l_quantity"][i])
        price = Decimal(cols["l_extendedprice"][i]) / 100
        disc = Decimal(cols["l_discount"][i]) / 100
        tax = Decimal(cols["l_tax"][i]) / 100
        g = groups.setdefault(key, [Decimal(0)] * 6 + [0])
        for k, v in enumerate((qty, price, price * (1 - disc),
                               price * (1 - disc) * (1 + tax), disc)):
            g[k] += v
        g[6] += 1
    want = []
    for key in sorted(groups):
        qty, price, dp, charge, disc, _, n = groups[key]

        def avg(total):
            return int((total / n).quantize(Decimal("0.000001"),
                                            rounding=ROUND_HALF_UP)
                       * 10 ** 6)
        want.append(key + (int(qty * 100), int(price * 100), int(dp * 10**4),
                           int(charge * 10**6), avg(qty), avg(price),
                           avg(disc), n))
    assert got == want
