"""The port's test harness (testing/: datagen, asserts) and its version,
held to the JAX package's on the CPU:

- gen_pydict gives the JAX package's values bit for bit for every
  generator at three seeds (NaN positions and -0.0 by their bits,
  Decimals, dates, timestamps) and the same schema;
- the asserts accept and reject the same row pairs;
- assert_consistent_across_configs(device="cpu") over three of
  tests/test_fuzz.py's query shapes at n=256 — every CONFIG_TIERS tier
  and the mesh tiers over eight CPU shards, as the JAX package runs them
  over conftest's eight CPU devices — gives the JAX package's rows:
  integers exact, f64 sums to rtol 1e-9;
- the mesh tiers over an explicit mesh; a mesh that cannot be built
  raises, nothing is skipped silently;
- `__version__` equals the JAX package's, and pyproject.toml names the
  port's optional dependencies.
"""

import collections
import datetime
import math
import re
import struct
from decimal import Decimal
from pathlib import Path

import pytest
import torch

import spark_rapids_tpu
from spark_rapids_tpu import testing as jtesting
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import functions as JF

import spark_rapids_tpu_torch
from spark_rapids_tpu_torch import testing as ttesting
from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.parallel import mesh as tmesh
from spark_rapids_tpu_torch.testing import asserts as tasserts

from test_torch_jax_ref import jax_aliases, one_torch_thread

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _env():
    from spark_rapids_tpu.parallel.mesh import set_active_mesh as jset
    with jax_aliases(), one_torch_thread():
        yield
    tmesh.set_active_mesh(None)
    jset(None)


# -- datagen -----------------------------------------------------------------

def gens(m, types):
    """Every generator of package `m` (its testing module) and `types`,
    with the arguments tests/test_fuzz.py uses and their defaults."""
    return [
        ("bool", m.BooleanGen()),
        ("byte", m.ByteGen()),
        ("short", m.ShortGen(nullable=False)),
        ("int", m.IntegerGen()),
        ("long", m.LongGen(min_val=-1 << 40, max_val=1 << 40)),
        ("long_full", m.LongGen()),
        ("float", m.FloatGen()),
        ("double", m.DoubleGen()),
        ("double_nonan", m.DoubleGen(no_nans=True)),
        ("str", m.StringGen(max_length=12)),
        ("ascii", m.StringGen(ascii_only=True, min_length=1)),
        ("date", m.DateGen()),
        ("ts", m.TimestampGen()),
        ("dec", m.DecimalGen(precision=10, scale=2)),
        ("dec_wide", m.DecimalGen(precision=18, scale=0, null_prob=0.3)),
        ("set_long", m.SetValuesGen(types.LONG, [0, 1, 2, 3, 4, None])),
        ("set_str", m.SetValuesGen(types.STRING, ["a", "bb", "ccc"])),
        ("seq", m.RepeatSeqGen(types.INT, [3, 1, 2])),
    ]


def bits(v):
    """A value's identity, floats by their IEEE bits."""
    if isinstance(v, float):
        return ("f", struct.pack("<d", v))
    return (type(v).__name__, v)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gen_pydict_is_the_jax_packages_bit_for_bit(seed):
    got, tschema = ttesting.gen_pydict(gens(ttesting, tt), 400, seed=seed)
    want, jschema = jtesting.gen_pydict(gens(jtesting, jt), 400, seed=seed)
    assert list(got) == list(want)
    for name in want:
        assert [bits(v) for v in got[name]] == \
            [bits(v) for v in want[name]], name
    assert [(f.name, f.data_type.simple_name(), f.nullable)
            for f in tschema.fields] == \
        [(f.name, f.data_type.simple_name(), f.nullable)
         for f in jschema.fields]
    # the special values do reach the data
    flat = [v for col in got.values() for v in col]
    assert any(isinstance(v, float) and math.isnan(v) for v in flat)
    assert any(bits(v) == bits(-0.0) for v in flat)
    assert (1 << 63) - 1 in got["long_full"] or \
        -(1 << 63) in got["long_full"]
    assert "" in got["str"]
    assert datetime.date(1970, 1, 1) in got["date"]
    assert any(isinstance(v, Decimal) for v in got["dec"])
    assert None in got["int"]


def test_generators_keep_their_state_as_the_jax_packages():
    """RepeatSeqGen cycles across calls; with_special_case extends the
    pool; gen_df builds the session's DataFrame."""
    tg = ttesting.RepeatSeqGen(tt.INT, [1, 2, 3])
    jg = jtesting.RepeatSeqGen(jt.INT, [1, 2, 3])
    for n in (2, 5, 1):
        assert ttesting.gen_pydict([("a", tg)], n)[0] == \
            jtesting.gen_pydict([("a", jg)], n)[0]
    t = ttesting.IntegerGen().with_special_case(7)
    j = jtesting.IntegerGen().with_special_case(7)
    assert t._specials == j._specials
    from spark_rapids_tpu_torch.api.session import TpuSession
    df = ttesting.gen_df(TpuSession(device="cpu"),
                         [("a", ttesting.LongGen())], n=100, seed=3,
                         batch_rows=32)
    data, _ = ttesting.gen_pydict([("a", ttesting.LongGen())], 100, seed=3)
    assert [r[0] for r in df.collect()] == data["a"]


# -- the asserts -------------------------------------------------------------

NAN, INF = float("nan"), float("inf")

ROW_PAIRS = [
    # (got, expected, kwargs)
    ([(1, 2.0)], [(1, 2.0)], {}),
    ([(1, 2.0), (0, None)], [(0, None), (1, 2.0)], {}),
    ([(0, None), (1, 2.0)], [(1, 2.0), (0, None)], {"ordered": True}),
    ([(1, NAN)], [(1, NAN)], {}),
    ([(1, NAN)], [(1, 0.0)], {}),
    ([(1, INF)], [(1, INF)], {}),
    ([(1, INF)], [(1, -INF)], {}),
    ([(1, 1.0 + 1e-12)], [(1, 1.0)], {}),
    ([(1, 1.0 + 1e-6)], [(1, 1.0)], {}),
    ([(1, 1.0 + 1e-6)], [(1, 1.0)], {"rel_tol": 1e-5}),
    ([(1, -0.0)], [(1, 0.0)], {}),
    ([(Decimal("1.50"),)], [(Decimal("1.5"),)], {}),
    ([(Decimal("1.50"),)], [(Decimal("1.51"),)], {}),
    ([(1, None)], [(1, 0)], {}),
    ([(1,)], [(1, 2)], {}),
    ([(1,), (2,)], [(1,)], {}),
    ([("a", 1)], [("a", 1)], {}),
    ([("a", 1)], [("b", 1)], {}),
    ([], [], {}),
]


def verdict(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
        return True
    except AssertionError:
        return False


@pytest.mark.parametrize("i", range(len(ROW_PAIRS)))
def test_asserts_accept_and_reject_as_the_jax_packages(i):
    got, want, kw = ROW_PAIRS[i]
    for t_fn, j_fn in ((ttesting.assert_rows_equal,
                        jtesting.assert_rows_equal),
                       (ttesting.assert_equal_with_tolerance,
                        jtesting.assert_equal_with_tolerance)):
        if "ordered" in kw and t_fn is ttesting.assert_equal_with_tolerance:
            continue
        assert verdict(t_fn, got, want, **kw) == \
            verdict(j_fn, got, want, **kw)
    assert ttesting.CONFIG_TIERS == jtesting.asserts.CONFIG_TIERS


# -- the tier matrix against the JAX package --------------------------------

def fuzz_groupby_sum_count(m, types, F, seed=0, n=256):
    gens = [("k", m.SetValuesGen(types.LONG, [0, 1, 2, 3, 4, None])),
            ("v", m.LongGen(min_val=-1 << 40, max_val=1 << 40))]
    data, sch = m.gen_pydict(gens, n, seed=seed)
    acc = collections.defaultdict(lambda: [0, 0])
    for k, v in zip(data["k"], data["v"]):
        if v is not None:
            acc[k][0] += v
            acc[k][1] += 1
        else:
            acc[k]
    oracle = [(k, (s if c else None), c) for k, (s, c) in acc.items()]

    def build(sess):
        df = sess.from_pydict(data, sch, batch_rows=64)
        return df.group_by("k").agg((F.sum("v"), "s"), (F.count("v"), "c"))
    return build, oracle


def fuzz_string_minmax(m, types, F, seed=3, n=256):
    gens = [("k", m.SetValuesGen(types.STRING, ["a", "bb", "ccc", None])),
            ("v", m.DoubleGen(no_nans=True))]
    data, sch = m.gen_pydict(gens, n, seed=seed)
    acc = collections.defaultdict(list)
    for k, v in zip(data["k"], data["v"]):
        if v is not None:
            acc[k].append(v)
        else:
            acc[k]
    oracle = [(k, (min(vs) if vs else None), (max(vs) if vs else None))
              for k, vs in acc.items()]

    def build(sess):
        df = sess.from_pydict(data, sch, batch_rows=50)
        return df.group_by("k").agg((F.min("v"), "mn"), (F.max("v"), "mx"))
    return build, oracle


def fuzz_join(m, types, F, seed=7, n=256):
    lgens = [("k", m.SetValuesGen(types.LONG, list(range(20)) + [None])),
             ("lv", m.LongGen())]
    rgens = [("k", m.SetValuesGen(types.LONG, list(range(10, 30)) + [None])),
             ("rv", m.StringGen(max_length=30))]
    ldata, lsch = m.gen_pydict(lgens, n, seed=seed)
    rdata, rsch = m.gen_pydict(rgens, n // 2, seed=seed + 100)
    rmap = collections.defaultdict(list)
    for k, v in zip(rdata["k"], rdata["rv"]):
        if k is not None:
            rmap[k].append(v)
    oracle = []
    for k, lv in zip(ldata["k"], ldata["lv"]):
        matches = rmap.get(k, []) if k is not None else []
        if matches:
            oracle.extend((k, lv, rv) for rv in matches)
        else:
            oracle.append((k, lv, None))

    def build(sess):
        left = sess.from_pydict(ldata, lsch, batch_rows=64)
        right = sess.from_pydict(rdata, rsch, batch_rows=64)
        return left.join(right, on="k", how="left_outer")
    return build, oracle


SHAPES = {"groupby_sum_count": fuzz_groupby_sum_count,
          "string_minmax": fuzz_string_minmax,
          "join": fuzz_join}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tier_matrix_gives_the_jax_packages_rows(shape):
    tbuild, toracle = SHAPES[shape](ttesting, tt, TF)
    jbuild, joracle = SHAPES[shape](jtesting, jt, JF)
    assert toracle == joracle
    got = ttesting.assert_consistent_across_configs(
        tbuild, expected=toracle, device="cpu")
    want = jtesting.assert_consistent_across_configs(jbuild,
                                                     expected=joracle)
    ttesting.assert_rows_equal(got, want, rel_tol=1e-9)


def test_mesh_tiers_over_an_explicit_mesh_and_the_tiers_run(monkeypatch):
    """`mesh=` runs the mesh tiers over that mesh: five collects in all,
    two of them over its four shards."""
    build, oracle = fuzz_groupby_sum_count(ttesting, tt, TF, seed=1)
    seen = []
    real = tasserts.collect_with_conf

    def spy(b, conf=None, **kw):
        seen.append((dict(conf or {}), kw.get("mesh"),
                     kw.get("mesh_devices")))
        return real(b, conf, **kw)

    monkeypatch.setattr(tasserts, "collect_with_conf", spy)
    mesh = tmesh.Mesh([torch.device("cpu")] * 4)
    ttesting.assert_consistent_across_configs(build, expected=oracle,
                                              device="cpu", mesh=mesh)
    assert [s[0] for s in seen] == ttesting.CONFIG_TIERS + [
        {}, {"spark.rapids.tpu.agg.speculative.enabled": False}]
    assert [s[1] for s in seen] == [None] * 3 + [mesh, mesh]
    assert [s[2] for s in seen] == [None] * 5


def test_a_mesh_that_cannot_be_built_raises(monkeypatch):
    """With no card (as here; the check is forced so that it holds on a
    machine with one too), the default device's mesh tiers need cards and
    raise; on the CPU mesh_devices=None runs the three tiers alone."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    build, oracle = fuzz_groupby_sum_count(ttesting, tt, TF)
    with pytest.raises(RuntimeError, match="need 8 cards, have 0"):
        ttesting.assert_consistent_across_configs(build)
    with pytest.raises(RuntimeError, match="need 2 cards, have 0"):
        ttesting.assert_consistent_across_configs(build, mesh_devices=2,
                                                  device="cuda")
    rows = ttesting.assert_consistent_across_configs(
        build, mesh_devices=None, device="cpu", expected=oracle)
    assert len(rows) == len(oracle)


# -- the version -------------------------------------------------------------

def test_version_equals_the_jax_packages():
    from spark_rapids_tpu.version import __version__ as jversion
    from spark_rapids_tpu_torch.version import __version__ as tversion
    assert spark_rapids_tpu_torch.__version__ == tversion == jversion
    assert re.fullmatch(r"\d+\.\d+\.\d+", tversion)
    assert spark_rapids_tpu is not None


def test_pyproject_names_the_port():
    text = (ROOT / "pyproject.toml").read_text()
    assert re.search(r'^torch = \[.*"torch>=', text, re.MULTILINE)
    assert 'version = { attr = "spark_rapids_tpu.version.__version__" }' \
        in text
    assert '"spark_rapids_tpu_torch*"' in text
