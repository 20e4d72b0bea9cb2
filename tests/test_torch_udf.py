"""Python UDFs (expr/udf.py), the UDF compiler (udf_compiler) and the
cost-based placement (plan/cost.py) against the JAX package's.

A PythonUDF over numeric, boolean and string inputs with nulls gives the
reference's rows, one host round trip a batch (`udf.counters()`).
`compile_udf` builds the reference's tree (node by node: class, literal,
cast target, IN list; the two packages' reprs of Cast and In differ) for
branches, comparisons, arithmetic, None checks, closures, locals,
builtins and string methods, and the planned query gives the reference's
rows with no round trip; it raises UdfCompileError where the reference
does. The cost model places the same nodes on the host as the
reference's when the reference's constants stand in for the card's, and
its crossover moves with the constants."""

import math
import os
from types import SimpleNamespace

import pytest

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.plan import cost as jcost
from spark_rapids_tpu.udf_compiler import UdfCompileError as JError
from spark_rapids_tpu.udf_compiler import compile_udf as jcompile

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import functions as tF
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import udf as tudf
from spark_rapids_tpu_torch.plan import cost as tcost
from spark_rapids_tpu_torch.udf_compiler import UdfCompileError as TError
from spark_rapids_tpu_torch.udf_compiler import compile_udf as tcompile

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs

JAX = SimpleNamespace(t=jt, F=jF, session=jsession, core=jcore,
                      compile=jcompile, Error=JError, cost=jcost)
TORCH = SimpleNamespace(t=tt, F=tF, session=tsession, core=tcore,
                        compile=tcompile, Error=TError, cost=tcost)
COMPILE = "spark.rapids.sql.udfCompiler.enabled"
CBO = "spark.rapids.sql.optimizer.enabled"


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


DATA = {"x": [1, -2, None, 7, 2**40, 0], "y": [3, 3, 5, None, -1, 0],
        "d": [1.5, -0.0, None, float("nan"), 2.0, 1e300],
        "b": [True, False, None, True, False, True],
        "s": ["apple", " Banana ", None, "avocado", "", "a,b"]}


def _frame(m, settings=None, device=None):
    t = m.t
    schema = t.Schema((t.StructField("x", t.LONG),
                       t.StructField("y", t.LONG),
                       t.StructField("d", t.DOUBLE),
                       t.StructField("b", t.BOOLEAN),
                       t.StructField("s", t.STRING)))
    kw = {} if m is JAX else {"device": "cpu"}
    return m.session.TpuSession(settings or {}, **kw).from_pydict(DATA,
                                                                  schema)


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
    return a == b


def _rows_equal(a, b):
    return len(a) == len(b) and all(
        len(x) == len(y) and all(_same(u, v) for u, v in zip(x, y))
        for x, y in zip(a, b))


UDFS = {
    # name -> (function, argument columns, return type)
    "numeric": (lambda x, y: None if x is None or y is None
                else x * 2 + y, ("x", "y"), "LONG"),
    "double": (lambda d: -1.0 if d is None else d / 2.0, ("d",), "DOUBLE"),
    "boolean": (lambda b, x: b is True and x is not None and x > 0,
                ("b", "x"), "BOOLEAN"),
    "string": (lambda s: -1 if s is None else len(s.strip()), ("s",),
               "INT"),
    "string and number": (lambda s, y: None if s is None or y is None
                          else s.count("a") + y, ("s", "y"), "LONG"),
}


@pytest.mark.parametrize("name", list(UDFS))
def test_python_udf_matches_jax(name):
    fn, args, rt = UDFS[name]
    rows = []
    before = tudf.counters()
    for m in (TORCH, JAX):
        f = m.F.udf(fn, return_type=getattr(m.t, rt))
        df = _frame(m).select(m.core.col("x"), f(*args).alias("u"))
        rows.append(df.collect())
    after = tudf.counters()
    assert _rows_equal(rows[0], rows[1])
    assert after["round_trips"] - before["round_trips"] == 1
    assert after["rows"] - before["rows"] == len(DATA["x"])


def test_udf_surface_matches_jax():
    """A str argument names a column; the return type is required and
    fixed-width; the decorator form builds the same expression."""
    for m in (TORCH, JAX):
        with pytest.raises(TypeError, match="return_type"):
            m.F.udf(lambda x: x)
        with pytest.raises((ValueError, AssertionError)):
            m.F.udf(lambda x: str(x), return_type=m.t.STRING)("x")

        @m.F.udf(return_type=m.t.LONG)
        def inc(x):
            return None if x is None else x + 1
        assert repr(inc("x")).startswith("udf:inc(col('x'))")


def _closure(k):
    return lambda x: x + k


def _local(x, y):
    z = x * 3
    if z > y:
        z = z - y
    return z


COMPILED = {
    # name -> (function, argument columns)
    "arithmetic": (lambda x, y: (x + y) * 2 - x // 3 + x % 5, ("x", "y")),
    "true division": (lambda d, x: d / 2 + x, ("d", "x")),
    "branch": (lambda x, y: x if x > y else y, ("x", "y")),
    "nested branches": (lambda x, y: 1 if x > 0 else (2 if y < 0 else 3),
                        ("x", "y")),
    "comparisons": (lambda x, y: x >= y and x != 0 or y == 3, ("x", "y")),
    "none check": (lambda x, y: -1 if x is None else x, ("x", "y")),
    "not none": (lambda x: x is not None and x < 5, ("x",)),
    "membership": (lambda x: x in (1, 7, 9), ("x",)),
    "negation": (lambda x: -x if not x > 0 else x, ("x",)),
    "builtins": (lambda x, y: min(abs(x), y) + max(x, y), ("x", "y")),
    "cast": (lambda x: float(x) * 0.5, ("x",)),
    "closure": (_closure(10), ("x",)),
    "local": (_local, ("x", "y")),
    "string methods": (lambda s: s.strip().upper() if s.startswith("a")
                       else s.lower(), ("s",)),
    "string replace": (lambda s: s.replace("a", "o") + "!", ("s",)),
    "string suffix": (lambda s: s.endswith("o") or s == "", ("s",)),
    "string length": (lambda s: len(s) * 2, ("s",)),
}


def _tree(e):
    """An expression tree by class, literal value, cast target and IN
    list: the packages' reprs differ for Cast and In."""
    extra = ()
    if type(e).__name__ == "Literal":
        extra = (e.value,)
    elif type(e).__name__ == "Cast":
        extra = (e.data_type.simple_name(),)
    elif type(e).__name__ == "In":
        extra = tuple(e.items)
    elif hasattr(e, "name") and not e.children:
        extra = (e.name,)
    for attr in ("needle", "search", "replacement"):
        if hasattr(e, attr):
            v = getattr(e, attr)
            extra += (v.decode() if isinstance(v, bytes) else v,)
    return (type(e).__name__, extra, tuple(_tree(c) for c in e.children))


@pytest.mark.parametrize("name", list(COMPILED))
def test_compile_udf_tree_and_rows_match_jax(name):
    fn, args = COMPILED[name]
    trees = [_tree(m.compile(fn, [m.core.col(a) for a in args]))
             for m in (TORCH, JAX)]
    assert trees[0] == trees[1]
    rows = []
    before = tudf.counters()
    for m in (TORCH, JAX):
        e = m.compile(fn, [m.core.col(a) for a in args])
        rows.append(_frame(m).select(e.alias("c")).collect())
    assert _rows_equal(rows[0], rows[1])
    assert tudf.counters() == before


def _throws(x, y):
    raise ValueError(x)


def _loop(x, y):
    t = 0
    for i in range(3):
        t += x
    return t


ERRORS = {
    "loop": _loop,
    "unknown call": lambda x, y: os.getpid() + x,
    "round (banker's)": lambda x, y: round(x) + y,
    "in an unresolved string": lambda x, y: "an" in x,
    "raise": _throws,
    "generator": lambda x, y: (i for i in (x, y)),
    "builtin function": abs,
    "wrong arity": lambda x: x,
    "is a value": lambda x, y: 1 if x is y else 2,
    "method on a number": lambda x, y: x.bit_length(),
    "non-literal startswith": lambda x, y: x.startswith(y),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_compile_errors_match_jax(name):
    fn = ERRORS[name]
    msgs = []
    for m in (TORCH, JAX):
        with pytest.raises(m.Error) as e:
            m.compile(fn, [m.core.col("x"), m.core.col("y")])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("compiled", [False, True])
def test_planned_udf_compiles_under_its_conf(compiled):
    """With udfCompiler.enabled the planner replaces the UDF by its
    compiled tree (no round trip) and gives the interpreted UDF's rows;
    one that cannot compile keeps its round trip."""
    settings = {COMPILE: str(compiled).lower()}
    rows = []
    before = tudf.counters()
    for m in (TORCH, JAX):
        f = m.F.udf(lambda x, y: (x * 2 if x > y else y)
                    if x is not None and y is not None else None,
                    return_type=m.t.LONG)
        g = m.F.udf(lambda x, y: math.gcd(x, y) if x is not None
                    and y is not None else None, return_type=m.t.LONG)
        df = _frame(m, settings).select(f("x", "y").alias("f"),
                                        g("x", "y").alias("g"))
        rows.append(df.collect())
    trips = tudf.counters()["round_trips"] - before["round_trips"]
    assert _rows_equal(rows[0], rows[1])
    assert trips == (1 if compiled else 2)


def _cbo_frames(m, n_small, n_large):
    t = m.t
    kw = {} if m is JAX else {"device": "cpu"}
    sess = m.session.TpuSession({CBO: "true"}, **kw)
    schema = t.Schema((t.StructField("k", t.LONG),))
    out = {}
    for label, n in (("small", n_small), ("large", n_large)):
        df = sess.from_pydict({"k": list(range(n))}, schema)
        out[label] = df.select(m.core.col("k"), (m.core.col("k")
                                                 * m.core.lit(3))
                               .alias("k3")).filter(
            m.core.col("k3") > m.core.lit(6))
    return out


def _placements(df):
    return [ln.strip()[:1] for ln in df.explain().splitlines()
            if ln.strip()[:2] in ("~ ", "* ", "! ")]


REFERENCE = {"DEVICE_DISPATCH_US": 150.0, "DEVICE_ROW_US": 0.00002,
             "HOST_ROW_US": 1.0, "TRANSITION_ROW_US": 0.5}


@pytest.mark.parametrize("n_small, n_large", [(25, 4000), (80, 120),
                                              (5, 100000)])
def test_cbo_placements_match_jax_under_its_constants(monkeypatch, n_small,
                                                      n_large):
    for k, v in REFERENCE.items():
        assert getattr(jcost, k) == v
        monkeypatch.setattr(tcost, k, v)
    got, want = _cbo_frames(TORCH, n_small, n_large), \
        _cbo_frames(JAX, n_small, n_large)
    for label in got:
        assert _placements(got[label]) == _placements(want[label])
        assert sorted(got[label].collect()) == sorted(want[label].collect())
        notes = [ln.strip() for ln in got[label].explain().splitlines()
                 if "cost optimizer" in ln]
        jnotes = [ln.strip() for ln in want[label].explain().splitlines()
                  if "cost optimizer" in ln]
        assert notes == jnotes


def test_cbo_crossover_follows_the_constants(monkeypatch):
    """A Project over n rows goes to the host while n * (host row + two
    transitions) stays under the launch cost plus n device rows: the
    crossover moves with each constant."""
    def placed(n):
        return _placements(_cbo_frames(TORCH, n, n)["small"])[1]
    for dispatch, host, trans in ((150.0, 1.0, 0.5), (40.0, 4.0, 0.5),
                                  (1000.0, 0.25, 0.1)):
        monkeypatch.setattr(tcost, "DEVICE_DISPATCH_US", dispatch)
        monkeypatch.setattr(tcost, "DEVICE_ROW_US", 0.0)
        monkeypatch.setattr(tcost, "HOST_ROW_US", host)
        monkeypatch.setattr(tcost, "TRANSITION_ROW_US", trans)
        cross = dispatch / (host + 2 * trans)
        below, above = max(1, int(cross * 0.8)), int(cross * 1.25) + 1
        assert placed(below) == "~", (dispatch, host, trans, below)
        assert placed(above) == "*", (dispatch, host, trans, above)
    assert tcost.device_cost_us(10) == 1000.0
    assert tcost.host_cost_us(10, True) == 10 * (0.25 + 0.2)
    assert tcost.host_cost_us(10, False) == 2.5


def test_cbo_off_by_default_and_estimates_match_jax():
    """Without optimizer.enabled nothing moves; estimate_rows agrees with
    the reference's on the plans above."""
    for m in (TORCH, JAX):
        t = m.t
        kw = {} if m is JAX else {"device": "cpu"}
        df = m.session.TpuSession(**kw).from_pydict(
            {"k": [1, 2, 3]}, t.Schema((t.StructField("k", t.LONG),))) \
            .select((m.core.col("k") + m.core.lit(1)).alias("j"))
        assert _placements(df) == ["*", "*"]
    got = [tcost.estimate_rows(df.logical_plan())
           for df in _cbo_frames(TORCH, 25, 4000).values()]
    want = [jcost.estimate_rows(df.logical_plan())
            for df in _cbo_frames(JAX, 25, 4000).values()]
    assert got == want == [12, 2000]
