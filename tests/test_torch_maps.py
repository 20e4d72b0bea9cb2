"""The map expressions (ops/maps.py, expr/mapexprs.py, ElementAt over a
map) and explode/posexplode of a map (exec/generate.py) against the JAX
package on the CPU: null maps, empty maps, duplicate keys (the FIRST
entry wins in both packages, ROADMAP C.5), STRING and LONG keys, literal
and column keys, in one projection a package. Then the planner's map
payload tag-off, and P29's plans at a small size against chip_smoke's
oracles (the join with a struct payload, the map's lookups, group-by,
explode, collect, and the collect over 16 host shuffle partitions, where
the struct and the map cross the frames). Everything is exact but the
group sums (rtol 1e-9)."""

import pytest

from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.exec import basic as jb
from spark_rapids_tpu.exec import generate as jgen
from spark_rapids_tpu.expr import collectionexprs as jce
from spark_rapids_tpu.expr import core as jc
from spark_rapids_tpu.expr import mapexprs as jme
from spark_rapids_tpu.plan.overrides import TpuOverrides as JOverrides

from spark_rapids_tpu_torch import functions as tF
from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.exec import basic as tb
from spark_rapids_tpu_torch.exec import generate as tgen
from spark_rapids_tpu_torch.expr import collectionexprs as tce
from spark_rapids_tpu_torch.expr import core as tc
from spark_rapids_tpu_torch.expr import mapexprs as tme
from spark_rapids_tpu_torch.plan import overrides as tover

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs
from test_torch_structs import both

SMAP = tt.MapType(tt.STRING, tt.LONG)
LMAP = tt.MapType(tt.LONG, tt.STRING)
SMAPS = [{"a": 1, "b": 2}, {}, None, [("k", 5), ("k", 6), ("a", 9)],
         {"x": None}, {"bb": -1, "b": 2 ** 40}, {"": 3}]
LMAPS = [{1: "x", 2: "yy"}, None, {}, [(7, "p"), (7, "q")], {-3: None},
         {2 ** 62: "big"}, {0: ""}]


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


def _batch():
    return both({"k": [1, 2, 3, 4, 5, 6, 7],
                 "sk": ["b", "a", None, "k", "x", "bb", ""],
                 "lk": [2, 1, 3, 7, None, 2 ** 62, 0],
                 "v": ["p", None, "r", "s", "t", "u", "w"],
                 "sm": SMAPS, "lm": LMAPS},
                {"k": tt.LONG, "sk": tt.STRING, "lk": tt.LONG,
                 "v": tt.STRING, "sm": SMAP, "lm": LMAP})


def _exprs(me, ce, c):
    col, lit = c.col, c.lit
    sm, lm = col("sm"), col("lm")
    return [
        me.GetMapValue(sm, "a").alias("sa"),
        me.GetMapValue(sm, "k").alias("sdup"),
        me.GetMapValue(sm, col("sk")).alias("scol"),
        me.GetMapValue(lm, 2).alias("l2"),
        me.GetMapValue(lm, col("lk")).alias("lcol"),
        me.GetMapValue(lm, lit(7)).alias("ldup"),
        ce.ElementAt(sm, "b").alias("ea"),
        ce.ElementAt(lm, col("lk")).alias("ecol"),
        me.MapContainsKey(sm, "x").alias("hx"),
        me.MapContainsKey(lm, 2 ** 62).alias("hbig"),
        me.MapKeys(sm).alias("ks"), me.MapValues(lm).alias("vs"),
        ce.Size(sm).alias("n"),
        me.CreateMap(lit("p"), col("k"), lit("q"), col("lk"),
                     lit("p"), col("k")).alias("made"),
        me.CreateMap(col("sk"), col("v")).alias("made_s"),
        me.GetMapValue(me.CreateMap(lit("p"), col("v"), lit("p"),
                                    col("sk")), "p").alias("made_dup")]


def test_map_expressions_match_jax():
    jbatch, tbatch = _batch()
    jp = jb.ProjectExec(_exprs(jme, jce, jc),
                        jb.InMemoryScanExec([jbatch], jbatch.schema))
    tp = tb.ProjectExec(_exprs(tme, tce, tc),
                        tb.InMemoryScanExec([tbatch], tbatch.schema))
    jrows = [r for x in jp.execute() for r in x.to_pylist()]
    trows = [r for x in tp.execute() for r in x.to_pylist()]
    assert trows == jrows
    names = list(tp.output_schema.names)
    # the FIRST duplicate wins, in both packages
    assert trows[3][names.index("sdup")] == 5
    assert trows[3][names.index("ldup")] == "p"
    assert trows[0][names.index("made")] == {"p": 1, "q": 2}


def test_map_contains_key_of_a_column_key_matches_python():
    """The JAX package's rule sends a column key of map_contains_key to its
    host tier; the port runs it on the device, held to Python."""
    _, tbatch = _batch()
    tp = tb.ProjectExec([tme.MapContainsKey(tc.col("sm"), tc.col("sk"))
                         .alias("h")],
                        tb.InMemoryScanExec([tbatch], tbatch.schema))
    got = [r[0] for x in tp.execute() for r in x.to_pylist()]
    keys = ["b", "a", None, "k", "x", "bb", ""]
    want = []
    for m, k in zip(SMAPS, keys):
        if m is None or k is None:
            want.append(None)
        else:
            items = m.items() if isinstance(m, dict) else m
            want.append(any(kk == k for kk, _ in items))
    assert got == want


@pytest.mark.parametrize("position", [False, True])
@pytest.mark.parametrize("outer", [False, True])
def test_explode_of_a_map_matches_jax(position, outer):
    jbatch, tbatch = _batch()
    rows = []
    for gen, b, c, batch in ((jgen, jb, jc, jbatch), (tgen, tb, tc, tbatch)):
        g = gen.GenerateExec(c.col("sm"), b.InMemoryScanExec(
            [batch], batch.schema), outer=outer, position=position)
        rows.append(([r for x in g.execute() for r in x.to_pylist()],
                     g.output_schema.names))
    assert rows[1] == rows[0]
    assert rows[1][1][-2:] == ["key", "value"]


def test_planner_tags_off_a_map_join_payload_like_jax():
    data = {"k": [1, 2], "m": [{"a": 1}, None]}
    tdf = tsession.TpuSession(device="cpu").from_pydict(
        data, tt.Schema((tt.StructField("k", tt.LONG),
                         tt.StructField("m", SMAP))))
    from spark_rapids_tpu import types as jt
    jdf = jsession.TpuSession().from_pydict(
        data, jt.Schema((jt.StructField("k", jt.LONG),
                         jt.StructField("m", jt.MapType(jt.STRING,
                                                        jt.LONG)))))
    tq = tdf.join(tdf.select(tc.col("k").alias("k2")), left_on="k",
                  right_on="k2")
    jq = jdf.join(jdf.select(jc.col("k").alias("k2")), left_on="k",
                  right_on="k2")
    with pytest.raises(tover.PlanNotSupported) as e:
        tq.collect()
    assert "map payloads" in str(e.value)
    assert not JOverrides._all_ok(JOverrides(jdf.session.conf).wrap_and_tag(
        jq.logical_plan()))
    # the map's own queries plan and run
    assert tdf.select(tF.map_keys("m")).collect() == [(["a"],), (None,)]
    assert jdf.select(jF.map_keys("m")).collect() == [(["a"],), (None,)]


P29_LABELS = ("P29 lookups", "P29 group", "P29 explode", "P29 collect",
              "P29 shuffled", "P29 shuffled group")


@pytest.fixture(scope="module")
def p29():
    import chip_smoke as cs
    dj = cs.tpch_join_data(sf=0.002)
    q3d = cs.q3_types_data(dj)
    d19 = cs.q19_data(n_part=2048, n_line=16384)
    m, b, checks = cs.nested_inputs("cpu", dj, q3d, d19)
    return cs, m, b, checks, cs.nested_dfs(m, "cpu", b)


@pytest.mark.parametrize("label", P29_LABELS)
def test_p29_plans_and_matches_the_oracle(p29, label):
    """P29 at a small size as phase 3h plans it; over 16 partitions the
    customers' struct and the map cross the host shuffle's frames."""
    cs, m, b, checks, dfs = p29
    tree = cs.planned(m, dfs[label])[0]
    out = list(tree.execute())
    if label in cs.NESTED_COLLECTED:
        checks[label]([r for x in out for r in x.to_pylist()], label)
    else:
        checks[label](out, label)
    carried = cs.shuffle_carried(tree)
    if label == "P29 shuffled":
        assert any(c.startswith("m:map") for c in carried), carried
        assert any(c.startswith("c_info:struct") for c in carried), carried
    elif label == "P29 shuffled group":
        assert any(c.startswith("c_info:struct") for c in carried), carried
    else:
        assert not carried
