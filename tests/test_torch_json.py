"""get_json_object (ops/json_device.py, expr/jsonexprs.py) against the JAX
package's device path on the CPU: escapes, surrogate pairs and unpaired
surrogates, nesting, arrays, whitespace, raw numbers, the null literal,
duplicate keys, quoted keys, malformed documents (unbalanced, unterminated)
and null rows, many documents a call (the reference's JSON path compiles
for about 10 s). A projection of several paths builds one column's masks
once. Wildcard paths and from_json run on the host row engine in both
packages, with the same rows. Then P31's JSON path at a
small size against chip_smoke's oracle (Python's json under the device's
rules). Strings are compared exactly."""

import numpy as np
import pytest

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.columnar.column import StringColumn as JString
from spark_rapids_tpu.expr.jsonexprs import parse_json_path as jparse
from spark_rapids_tpu.ops.json_device import json_extract as jextract
from spark_rapids_tpu.plan.overrides import TpuOverrides as JOverrides

from spark_rapids_tpu_torch import functions as tF
from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.columnar.column import StringColumn
from spark_rapids_tpu_torch.expr import jsonexprs
from spark_rapids_tpu_torch.expr.core import col
from spark_rapids_tpu_torch.ops import json_device

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs

DOCS = [
    '{"a": 1, "b": {"c": "x\\"y"}, "d": [1, {"e": 2}, "s"]}',
    '{"a":"\\u00e9\\ud83d\\ude00\\n\\\\\\/", "b": null, "d": []}',
    '  {"a" : 12.50 , "b": {"c": [ 1 , 2 ]}}  ', '{"a": {', '{"a": "open}',
    None, '', '[1,2,3]', '{"d": [ {"e": "z"} , 7 ]}', '{"a":1,"a":2}',
    '{"b": {"c": {"q": "w", "r": [1, 2]}}, "a": "\\ud800x"}',
    '{"a": true}', '{"a": "null"}', '{"a": null}', '{"a": "]},{"}',
    '{"x\\"y": 1, "a": [[1, [2]], {"k": "v"}]}', '{"a": -0.5e+3}',
    '{"a b": 7, "a": "\\udc00\\ud83d"}', '  ', '{}', '{"a": ""}',
    '{"b": {"c": "\\t\\u0041\\u00"}}', '{"d": [1, 2, 3, 4, 5, 6]}',
    '{"a": {"b": {"c": {"d": {"e": [0, [1, [2, {"f": "deep"}]]]}}}}}',
    '{"a": 1}}', '{"a": [1, 2}', '{"a": "\\\\"}', '{"d": [ ]}']
PATHS = ["$.a", "$.b.c", "$.d[1]", "$.d[0]", "$.d[1].e", "$.b", "$.x",
         "$[1]", "$.b.c.r[1]", "$['a']", "$.a b", "$.a[1][1][0]",
         "$.d[5]", "$.a.b.c.d.e[1][1][1].f", "$.b.c.q"]


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


def test_json_paths_match_jax():
    jcol = JString.from_pylist(DOCS)
    tcol = StringColumn.from_pylist(DOCS, device="cpu")
    n = len(DOCS)
    for path in PATHS:
        steps = jsonexprs.parse_json_path(path)
        assert steps == jparse(path)
        got = json_device.json_extract(tcol, steps)
        want = jextract(jcol, steps)
        assert got.to_pylist(n) == want.to_pylist(n), path
    # a few rows by hand: raw numbers, decoded escapes, compact containers
    got = {p: json_device.json_extract(
        tcol, jsonexprs.parse_json_path(p)).to_pylist(n) for p in PATHS}
    assert got["$.a"][2] == "12.50" and got["$.a"][1] == "é😀\n\\/"
    assert got["$.b"][2] == '{"c":[1,2]}'
    assert got["$.a"][3] is None and got["$.a"][4] is None
    assert got["$.a"][13] is None and got["$.a"][12] == "null"
    assert got["$.a"][9] == "1"          # the first duplicate wins
    assert got["$.a.b.c.d.e[1][1][1].f"][23] == "deep"


def test_paths_of_one_projection_share_the_column_structure(monkeypatch):
    built = []
    real = json_device.JsonStructure.__init__

    def counting(self, col):
        built.append(col)
        real(self, col)
    monkeypatch.setattr(json_device.JsonStructure, "__init__", counting)
    sess = tsession.TpuSession(device="cpu")
    df = sess.from_pydict({"j": DOCS}, tt.Schema((tt.StructField(
        "j", tt.STRING),)))
    rows = df.select(*[tF.get_json_object("j", p).alias(f"p{k}")
                       for k, p in enumerate(PATHS[:5])]).collect()
    assert len(built) == 1 and len(rows) == len(DOCS)
    assert rows[0][:2] == ("1", 'x"y')


def test_malformed_path_gives_null_rows():
    tcol = StringColumn.from_pylist(DOCS, device="cpu")
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.expr.core import BoundReference
    batch = ColumnarBatch([tcol], len(DOCS), tt.Schema((tt.StructField(
        "j", tt.STRING),)))
    out = jsonexprs.GetJsonObject(BoundReference(0, tt.STRING), "a.b") \
        .columnar_eval(batch)
    assert out.to_pylist(len(DOCS)) == [None] * len(DOCS)


def test_wildcards_and_from_json_tag_off_naming_wave_4():
    """A wildcard path and from_json have no device path: both packages
    plan them on the host row engine (`~`), with the same rows."""
    from spark_rapids_tpu.expr import core as jc
    from spark_rapids_tpu.expr.jsonexprs import JsonToStructsField as JJson
    data = {"j": ['{"a": [1, 2]}', None]}
    tdf = tsession.TpuSession(device="cpu").from_pydict(
        data, tt.Schema((tt.StructField("j", tt.STRING),)))
    jdf = jsession.TpuSession().from_pydict(
        data, jt.Schema((jt.StructField("j", jt.STRING),)))
    cases = [(tF.get_json_object("j", "$.a[*]"),
              jF.get_json_object("j", "$.a[*]")),
             (jsonexprs.JsonToStructsField(col("j"), "a", tt.LONG),
              JJson(jc.col("j"), "a", jt.LONG))]
    for texpr, jexpr in cases:
        tq = tdf.select(texpr.alias("r"))
        assert tq.explain().startswith("~ ")
        jq = jdf.select(jexpr.alias("r"))
        assert JOverrides._all_ok(JOverrides(jdf.session.conf).wrap_and_tag(
            jq.logical_plan()))
        assert tq.collect() == jq.collect()


def test_p31_json_path_plans_and_matches_the_oracle():
    import chip_smoke as cs
    cd = cs.clickstream_data(n=512)
    m = cs.nested_modules()
    b = {"json": cs.batch_of(m, "cpu", [
        ("row", np.arange(512, dtype=np.int64), m.t.LONG),
        ("doc", StringColumn.from_numpy(*cd["docs"], cd["docs_valid"],
                                        device="cpu"), m.t.STRING)])}
    df = cs.p31_dfs(m, m.session.TpuSession(device="cpu"),
                    dict(b, url=b["json"]))["P31 json"]
    out = list(cs.planned(m, df)[0].execute())
    want = cs.json_oracle(cd["docs_list"])
    cs.p31_check(want, lambda k: cs.P31_PATHS[k])(out, "P31 json")
    # the data holds what the path means to cover
    assert any(d is not None and "\\ud83c" in d for d in cd["docs_list"])
    assert any(v is None for v in want[0])
    assert sum(d is None for d in cd["docs_list"]) < 20
