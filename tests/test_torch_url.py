"""parse_url (ops/url.py, expr/urlexprs.py) against the JAX package's device
path on the CPU, every part and a query key, over ordinary and exotic
URLs alike (userinfo, IPv6 literals, ports, empty queries and fragments,
scheme-less strings with stray delimiters, %-escapes good and bad, '+',
unknown and lowercase part names): the port equals the reference on all
of them. A non-literal part runs on the host row engine in both
packages, with the same rows. Then P31's URL paths at a small size
against chip_smoke's oracle (urllib.parse, as the JAX package's host
tier). Strings are compared exactly."""

import numpy as np
import pytest

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.columnar.column import StringColumn as JString
from spark_rapids_tpu.expr import core as jc
from spark_rapids_tpu.expr.urlexprs import ParseUrl as JParseUrl
from spark_rapids_tpu.ops.url import parse_url as jparse
from spark_rapids_tpu.plan.overrides import TpuOverrides as JOverrides

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.columnar.column import StringColumn
from spark_rapids_tpu_torch.expr.core import col
from spark_rapids_tpu_torch.expr.urlexprs import ParseUrl
from spark_rapids_tpu_torch.ops.url import parse_url

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs

URLS = [
    "http://user:pw@Example.COM:8080/a/b.html?x=1&y=a%20b+c&x=2#frag",
    "https://[::1]:443/p?q", "ftp://h/", None, "", "mailto:x@y",
    "//host/path?k=v", "http://h?a&b=&c=%zz", "HTTP://h.com/%41?k=%41%2",
    "http://h.com/?", "http://h.com#", "http://h.com?#", "no/scheme?q=1",
    "a:b/c", "1http://bad", "http://h.com/x?q=a&q=b&qq=c", "http://@h/",
    "http://u@[2001:db8::1]/x", "http://h:/p", "file:///etc/passwd",
    "http://h.com/p;params?q=%7E+x", "http://H.COM/UPPER?Q=Up#Frag",
    "javascript:alert(1)", "http://h.com//double//slash",
    "http://a@b@c/d", "http://h.com/p?q", "http://h.com/p?q=",
    "  http://space.com/ ", "http://h.com/%E2%82%AC?q=%E2%82%AC"]
PARTS = [("PROTOCOL", None), ("HOST", None), ("PATH", None),
         ("QUERY", None), ("REF", None), ("FILE", None),
         ("AUTHORITY", None), ("USERINFO", None), ("QUERY", "x"),
         ("QUERY", "q"), ("QUERY", "b"), ("QUERY", "k"), ("host", None),
         ("Query", "q")]


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


def test_parse_url_matches_jax_on_every_part():
    jcol = JString.from_pylist(URLS)
    tcol = StringColumn.from_pylist(URLS, device="cpu")
    n = len(URLS)
    for part, key in PARTS:
        got = parse_url(tcol, part, key).to_pylist(n)
        assert got == jparse(jcol, part, key).to_pylist(n), (part, key)
    host = parse_url(tcol, "HOST").to_pylist(n)
    assert host[0] == "example.com" and host[1] == "::1"
    assert parse_url(tcol, "QUERY", "y").to_pylist(1) == ["a b c"]


def test_non_literal_part_tags_off_naming_wave_4():
    data = {"u": ["http://h/p"], "p": ["HOST"]}
    tdf = tsession.TpuSession(device="cpu").from_pydict(
        data, tt.Schema((tt.StructField("u", tt.STRING),
                         tt.StructField("p", tt.STRING))))
    jdf = jsession.TpuSession().from_pydict(
        data, jt.Schema((jt.StructField("u", jt.STRING),
                         jt.StructField("p", jt.STRING))))
    tq = tdf.select(ParseUrl(col("u"), col("p")).alias("r"))
    assert tq.explain().startswith("~ ")
    jq = jdf.select(JParseUrl(jc.col("u"), jc.col("p")).alias("r"))
    assert JOverrides._all_ok(JOverrides(jdf.session.conf).wrap_and_tag(
        jq.logical_plan()))
    assert tq.collect() == jq.collect() == [("h",)]
    assert tdf.select(ParseUrl(col("u"), "HOST").alias("h")).collect() \
        == [("h",)]


@pytest.mark.parametrize("label", ["P31 url", "P31 hosts"])
def test_p31_url_paths_plan_and_match_the_oracle(label):
    import chip_smoke as cs
    n = 2048
    cd = cs.clickstream_data(n=n)
    m = cs.nested_modules()
    b = {"url": cs.batch_of(m, "cpu", [
        ("row", np.arange(n, dtype=np.int64), m.t.LONG),
        ("url", StringColumn.from_numpy(*cd["urls"], cd["urls_valid"],
                                        device="cpu"), m.t.STRING)])}
    df = cs.p31_dfs(m, m.session.TpuSession(device="cpu"),
                    dict(b, json=b["url"]))[label]
    out = list(cs.planned(m, df)[0].execute())
    want = cs.url_oracle(cd["urls_list"])
    if label == "P31 url":
        cs.p31_check(want, lambda k: str(cs.P31_PARTS[k]))(out, label)
        assert any(u and "@" in u for u in cd["urls_list"])
        assert any(u and "[" in u for u in cd["urls_list"])
        return
    hosts = {}
    for h in want[1]:
        hosts[h] = hosts.get(h, 0) + 1
    cs.sorted_rows(list(hosts.items()))(
        [r for x in out for r in x.to_pylist()], label)
