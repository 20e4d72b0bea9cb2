"""The host row engine (exec/fallback.py) against the JAX package's.

`row_eval` of every `_EVALS` entry, every special form and every class
with a `host_eval_row` or `host_eval_with_row` is held to the reference's
`row_eval` on the same rows (nulls, NaN, ±0.0, the int64 extremes,
non-ASCII text); a raise must be the same exception type. `supports_host_eval`
gives the reference's answer on every tree here and on a list of trees it
rejects. Each shape of ROADMAP A.8 wave 4's former tag-off list plans on
the row engine (`~` in explain()) and collects the JAX package's rows;
the lambda over nested arrays, which raises in the JAX package's host
tier (ROADMAP C.5), is held to a Python oracle, and so is GetArrayItem
with a column index, whose host rows are Spark's (C.5, C.12)."""

import math
from types import SimpleNamespace

import pytest

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.exec import fallback as jfallback
from spark_rapids_tpu.expr import arithmetic as jA
from spark_rapids_tpu.expr import cast as jcast
from spark_rapids_tpu.expr import collectionexprs as jCE
from spark_rapids_tpu.expr import conditional as jC
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import jsonexprs as jJE
from spark_rapids_tpu.expr import mapexprs as jME
from spark_rapids_tpu.expr import predicates as jP
from spark_rapids_tpu.expr import stringexprs as jS
from spark_rapids_tpu.expr import urlexprs as jUE

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import functions as tF
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.exec import fallback as tfallback
from spark_rapids_tpu_torch.expr import arithmetic as tA
from spark_rapids_tpu_torch.expr import cast as tcast
from spark_rapids_tpu_torch.expr import collectionexprs as tCE
from spark_rapids_tpu_torch.expr import conditional as tC
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import jsonexprs as tJE
from spark_rapids_tpu_torch.expr import mapexprs as tME
from spark_rapids_tpu_torch.expr import predicates as tP
from spark_rapids_tpu_torch.expr import stringexprs as tS
from spark_rapids_tpu_torch.expr import urlexprs as tUE

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs

JAX = SimpleNamespace(A=jA, C=jC, P=jP, S=jS, CE=jCE, ME=jME, JE=jJE,
                      UE=jUE, Cast=jcast.Cast, core=jcore, t=jt, F=jF,
                      fb=jfallback, session=jsession)
TORCH = SimpleNamespace(A=tA, C=tC, P=tP, S=tS, CE=tCE, ME=tME, JE=tJE,
                        UE=tUE, Cast=tcast.Cast, core=tcore, t=tt, F=tF,
                        fb=tfallback, session=tsession)


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


NAN, INF = float("nan"), float("inf")
INTS = [0, 1, -1, 7, -7, 2**63 - 1, -2**63, None]
SMALL = [0, 1, -1, 3, -3, 2**31 - 1, None]
DOUBLES = [0.0, -0.0, NAN, INF, -INF, 1.5, -2.25, 1e300, None]
STRS = ["", "abc", "ABC def", "héllo wörld", "a,b,c", "Clerk#000000951",
        "1-URGENT", "  pad  ", None]
ARRS = [[1, 2, 2, None], [], None, [3, -1, 3], [None], [2**63 - 1, 0]]
SARRS = [["x", None, "y"], [], None, ["a", "a", "b"], [None]]
NESTED = [[[1], [2, 3]], [], None, [[4], None], [[], [5]]]
DARRS = [[0.0, -0.0, NAN], [NAN, 1.5], [], None, [-0.0]]
JSON = ['{"a": 1, "b": [1, 2, {"c": "x"}], "a": 2}', '{"a": "s\\u00e9"}',
        '[1, 2]', "not json", '{"b": [{"c": 1}, {"c": true}]}', None,
        '{"a": null}']
URLS = ["http://u:p@Example.com:80/a/b?x=1&y=2#frag", "https://h/p?q",
        "no scheme", None, "ftp://h/", "http://h?x=&x=3"]


def _pairs(xs, ys=None):
    ys = xs if ys is None else ys
    return [(a, b) for a in xs for b in ys]


def _t(m, ty):
    return ty(m.t) if callable(ty) else getattr(m.t, ty)


def _c(m, name):
    return m.core.col(name)


def _lit(m, v, ty=None):
    return m.core.Literal(v, None if ty is None else _t(m, ty))


# name -> (the expression of a namespace, schema [(name, type)], rows)
L2 = [("a", "LONG"), ("b", "LONG")]
D2 = [("a", "DOUBLE"), ("b", "DOUBLE")]
I1 = [("a", "INT")]
S1 = [("s", "STRING")]
S2 = [("s", "STRING"), ("u", "STRING")]
AL = [("l", lambda t: t.ArrayType(t.LONG))]
AS = [("l", lambda t: t.ArrayType(t.STRING))]
AN = [("l", lambda t: t.ArrayType(t.ArrayType(t.LONG)))]
AD = [("l", lambda t: t.ArrayType(t.DOUBLE))]
ALI = AL + [("i", "INT")]
MSL = [("m", lambda t: t.MapType(t.STRING, t.LONG)), ("k", "STRING")]
B2 = [("p", "BOOLEAN"), ("q", "BOOLEAN")]
LONG_ROWS = [(r,) for r in INTS]
STR_ROWS = [(r,) for r in STRS]
DBL_ROWS = [(r,) for r in DOUBLES]
MAPS = [{"a": 1, "b": None}, {}, None, {"x": -2**63}]

CASES = {}


def _binary(cls_name, ns, spec, rows):
    CASES[cls_name + ("" if spec is L2 else " double")] = (
        lambda m: getattr(getattr(m, ns), cls_name)(_c(m, "a"), _c(m, "b")),
        spec, rows)


for _name in ("Add", "Subtract", "Multiply", "Divide", "IntegralDivide",
              "Remainder", "Pmod"):
    _binary(_name, "A", L2, _pairs(INTS))
for _name in ("Add", "Subtract", "Multiply", "Divide", "Remainder",
              "Pmod"):
    _binary(_name, "A", D2, _pairs(DOUBLES))
for _name in ("EqualTo", "LessThan", "LessThanOrEqual", "GreaterThan",
              "GreaterThanOrEqual", "EqualNullSafe"):
    _binary(_name, "P", L2, _pairs(INTS))
    _binary(_name, "P", D2, _pairs(DOUBLES))
CASES.update({
    "UnaryMinus": (lambda m: m.A.UnaryMinus(_c(m, "a")), [("a", "LONG")],
                   LONG_ROWS),
    "Abs": (lambda m: m.A.Abs(_c(m, "a")), [("a", "LONG")], LONG_ROWS),
    "Abs double": (lambda m: m.A.Abs(_c(m, "a")), [("a", "DOUBLE")],
                   DBL_ROWS),
    "Least": (lambda m: m.A.Least(_c(m, "a"), _c(m, "b"), _lit(m, 5)),
              L2, _pairs(INTS)),
    "Greatest": (lambda m: m.A.Greatest(_c(m, "a"), _c(m, "b")), D2,
                 _pairs([1.0, -0.0, None, 2.5])),
    "And": (lambda m: m.P.And(_c(m, "p"), _c(m, "q")), B2,
            _pairs([True, False, None])),
    "Or": (lambda m: m.P.Or(_c(m, "p"), _c(m, "q")), B2,
           _pairs([True, False, None])),
    "Not": (lambda m: m.P.Not(_c(m, "p")), B2, _pairs([True, False, None])),
    "IsNull": (lambda m: m.P.IsNull(_c(m, "a")), L2, _pairs(INTS[-3:])),
    "IsNotNull": (lambda m: m.P.IsNotNull(_c(m, "a")), L2,
                  _pairs(INTS[-3:])),
    "If": (lambda m: m.C.If(_c(m, "p"), _lit(m, 1), _lit(m, 2)), B2,
           _pairs([True, False, None])),
    "Coalesce": (lambda m: m.C.Coalesce(_c(m, "a"), _c(m, "b"), _lit(m, 9)),
                 L2, _pairs(INTS[-3:])),
    "Nvl": (lambda m: m.C.Nvl(_c(m, "a"), _c(m, "b")), L2,
            _pairs(INTS[-3:])),
    "Nvl2": (lambda m: m.C.Nvl2(_c(m, "a"), _c(m, "b"), _lit(m, 0)), L2,
             _pairs(INTS[-3:])),
    "NullIf": (lambda m: m.C.NullIf(_c(m, "a"), _c(m, "b")), D2,
               _pairs([1.0, NAN, -0.0, 0.0, None])),
    "IsNaN": (lambda m: m.C.IsNaN(_c(m, "a")), [("a", "DOUBLE")], DBL_ROWS),
    "NaNvl": (lambda m: m.C.NaNvl(_c(m, "a"), _c(m, "b")), D2,
              _pairs(DOUBLES[:4])),
    "CaseWhen": (lambda m: m.C.CaseWhen(
        [(m.P.LessThan(_c(m, "a"), _lit(m, 0)), _lit(m, -1)),
         (m.P.GreaterThan(_c(m, "a"), _lit(m, 0)), _lit(m, 1))],
        _lit(m, 0)), L2, _pairs(INTS, [0])),
    "CaseWhen no else": (lambda m: m.C.CaseWhen(
        [(m.P.EqualTo(_c(m, "a"), _lit(m, 7)), _c(m, "b"))]), L2,
        _pairs(INTS, [5, None])),
    "In": (lambda m: m.P.In(_c(m, "a"), [1, 7, None]), L2,
           _pairs(INTS, [0])),
    "In no null": (lambda m: m.P.In(_c(m, "a"), [1, -7]), L2,
                   _pairs(INTS, [0])),
    "Length": (lambda m: m.S.Length(_c(m, "s")), S1, STR_ROWS),
    "OctetLength": (lambda m: m.S.OctetLength(_c(m, "s")), S1, STR_ROWS),
    "BitLength": (lambda m: m.S.BitLength(_c(m, "s")), S1, STR_ROWS),
    "Upper": (lambda m: m.S.Upper(_c(m, "s")), S1, STR_ROWS),
    "Lower": (lambda m: m.S.Lower(_c(m, "s")), S1, STR_ROWS),
    "Reverse": (lambda m: m.S.Reverse(_c(m, "s")), S1, STR_ROWS),
    "InitCap": (lambda m: m.S.InitCap(_c(m, "s")), S1, STR_ROWS),
    "Concat": (lambda m: m.S.Concat(_c(m, "s"), _c(m, "u")), S2,
               _pairs(STRS[:4] + [None])),
    "ConcatWs": (lambda m: m.S.ConcatWs("-", _c(m, "s"), _c(m, "u")), S2,
                 _pairs(STRS[:4] + [None])),
    "Ascii": (lambda m: m.S.Ascii(_c(m, "s")), S1, STR_ROWS),
    "Chr": (lambda m: m.S.Chr(_c(m, "a")), [("a", "LONG")],
            [(v,) for v in (65, 0, -1, 321, 256 + 97, None)]),
    "Substring": (lambda m: m.S.Substring(_c(m, "s"), 2, 3), S1, STR_ROWS),
    "Substring negative": (lambda m: m.S.Substring(_c(m, "s"), -3), S1,
                           STR_ROWS),
    "Substring zero": (lambda m: m.S.Substring(_c(m, "s"), 0, 2), S1,
                       STR_ROWS),
    "StartsWith": (lambda m: m.S.StartsWith(_c(m, "s"), "ab"), S1,
                   STR_ROWS),
    "EndsWith": (lambda m: m.S.EndsWith(_c(m, "s"), "ld"), S1, STR_ROWS),
    "Contains": (lambda m: m.S.Contains(_c(m, "s"), ","), S1, STR_ROWS),
    "RLike": (lambda m: m.S.RLike(_c(m, "s"), "[a-c]+"), S1, STR_ROWS),
    "Like": (lambda m: m.S.Like(_c(m, "s"), "%b_c%"), S1, STR_ROWS),
    "Like escape": (lambda m: m.S.Like(_c(m, "s"), "1!-%", "!"), S1,
                    STR_ROWS),
    "Cast long to string": (lambda m: m.Cast(_c(m, "a"), m.t.STRING),
                            [("a", "LONG")], LONG_ROWS),
    "Cast double to string": (lambda m: m.Cast(_c(m, "a"), m.t.STRING),
                              [("a", "DOUBLE")],
                              [(v,) for v in DOUBLES + [1e7, 1e-4, 0.1,
                                                         123.456, 5e-324]]),
    "Cast float to string": (lambda m: m.Cast(_c(m, "a"), m.t.STRING),
                             [("a", "FLOAT")],
                             [(v,) for v in (0.1, -0.0, 1e10, 3.4e38,
                                             1.401298464324817e-45, NAN,
                                             None)]),
    "Cast timestamp to string": (lambda m: m.Cast(_c(m, "a"), m.t.STRING),
                                 [("a", "TIMESTAMP")],
                                 [(v,) for v in (0, 1_500_000, -1,
                                                 86_400_123_000, None)]),
    "Cast string to int": (lambda m: m.Cast(_c(m, "s"), m.t.INT), S1,
                           [(v,) for v in (" 12 ", "x", "2147483648",
                                           "-7", None)]),
    "Cast double to long": (lambda m: m.Cast(_c(m, "a"), m.t.LONG),
                            [("a", "DOUBLE")], DBL_ROWS),
    "Cast string to double": (lambda m: m.Cast(_c(m, "s"), m.t.DOUBLE),
                              S1, [(v,) for v in ("1.5", " -2e3", "nan",
                                                  "x", None)]),
    "Cast string to boolean": (lambda m: m.Cast(_c(m, "s"), m.t.BOOLEAN),
                               S1, [(v,) for v in ("T", " yes", "0", "no",
                                                   "maybe", None)]),
    "Cast long to boolean": (lambda m: m.Cast(_c(m, "a"), m.t.BOOLEAN),
                             [("a", "LONG")], LONG_ROWS),
    # the host-tier string classes
    "StringSplit regex": (lambda m: m.S.StringSplit(_c(m, "s"), "#0+|,"),
                          S1, STR_ROWS),
    "StringSplit limit": (lambda m: m.S.StringSplit(_c(m, "s"), "[, ]", 2),
                          S1, STR_ROWS),
    "StringSplit limit 0": (lambda m: m.S.StringSplit(_c(m, "s"), "c", 0),
                            S1, [(v,) for v in ("acc", "cc", "a", None)]),
    "SubstringIndex": (lambda m: m.S.SubstringIndex(_c(m, "s"), ",", 2),
                       S1, STR_ROWS),
    "SubstringIndex negative": (lambda m: m.S.SubstringIndex(
        _c(m, "s"), ",", -1), S1, STR_ROWS),
    "FindInSet": (lambda m: m.S.FindInSet(_c(m, "s"), _c(m, "u")), S2,
                  _pairs(["b", "a,b", "", None], ["a,b,c", "", None])),
    "RegExpExtract": (lambda m: m.S.RegExpExtract(_c(m, "s"),
                                                  "([a-z]+)(#?)", 1),
                      S1, STR_ROWS),
    "RegExpExtract bad group": (lambda m: m.S.RegExpExtract(
        _c(m, "s"), "(a)", 3), S1, STR_ROWS),
    "RegExpReplace": (lambda m: m.S.RegExpReplace(_c(m, "s"), "([a-c])",
                                                  "<$1>\\$"), S1,
                      STR_ROWS),
    "FormatNumber": (lambda m: m.S.FormatNumber(_c(m, "a"), 2),
                     [("a", "DOUBLE")], [(v,) for v in (1234567.891, -0.5,
                                                        0.0, None)]),
    "Levenshtein": (lambda m: m.S.Levenshtein(_c(m, "s"), _c(m, "u")), S2,
                    _pairs(STRS[:7] + [None], ["", "kitten", "abd"])),
    "Base64Encode": (lambda m: m.S.Base64Encode(_c(m, "s")), S1, STR_ROWS),
    "UnBase64": (lambda m: m.S.UnBase64(_c(m, "s")), S1,
                 [(v,) for v in ("YWJj", "YWI", "!!", "", None)]),
    "Hex string": (lambda m: m.S.Hex(_c(m, "s")), S1, STR_ROWS),
    "Hex long": (lambda m: m.S.Hex(_c(m, "a")), [("a", "LONG")], LONG_ROWS),
    "Unhex": (lambda m: m.S.Unhex(_c(m, "s")), S1,
              [(v,) for v in ("4142", "abc", "zz", "4 1", "", None)]),
    "Encode UTF-16": (lambda m: m.S.Encode(_c(m, "s"), "UTF-16"), S1,
                      STR_ROWS),
    "Encode US-ASCII": (lambda m: m.S.Encode(_c(m, "s"), "US-ASCII"), S1,
                        STR_ROWS),
    "Decode UTF-16LE": (lambda m: m.S.Decode(_c(m, "s"), "UTF-16LE"), S1,
                        [(v,) for v in ("ab", "abc", "", None)]),
    # collections
    "CreateArray": (lambda m: m.CE.CreateArray(_c(m, "a"), _c(m, "b")), L2,
                    _pairs(INTS[-3:])),
    "Size": (lambda m: m.CE.Size(_c(m, "l")), AL, [(v,) for v in ARRS]),
    "ArrayContains": (lambda m: m.CE.ArrayContains(_c(m, "l"), 2), AL,
                      [(v,) for v in ARRS]),
    "SortArray": (lambda m: m.CE.SortArray(_c(m, "l")), AL,
                  [(v,) for v in ARRS]),
    "SortArray desc": (lambda m: m.CE.SortArray(_c(m, "l"), False), AL,
                       [(v,) for v in ARRS]),
    "ArrayMin": (lambda m: m.CE.ArrayMin(_c(m, "l")), AL,
                 [(v,) for v in ARRS]),
    "ArrayMax": (lambda m: m.CE.ArrayMax(_c(m, "l")), AL,
                 [(v,) for v in ARRS]),
    "ElementAt": (lambda m: m.CE.ElementAt(_c(m, "l"), -1), AL,
                  [(v,) for v in ARRS]),
    "ElementAt column": (lambda m: m.CE.ElementAt(_c(m, "l"), _c(m, "i")),
                         ALI, _pairs(ARRS, [1, -1, 0, 9, None])),
    "ElementAt map": (lambda m: m.CE.ElementAt(_c(m, "m"), "a"), MSL,
                      _pairs(MAPS, [None])),
    "GetArrayItem": (lambda m: m.CE.GetArrayItem(_c(m, "l"), 1), AL,
                     [(v,) for v in ARRS]),
    "ArrayPosition": (lambda m: m.CE.ArrayPosition(_c(m, "l"),
                                                   _lit(m, "a")), AS,
                      [(v,) for v in SARRS]),
    "ArrayPosition double": (lambda m: m.CE.ArrayPosition(
        _c(m, "l"), _lit(m, -0.0)), AD, [(v,) for v in DARRS]),
    "ArrayRemove": (lambda m: m.CE.ArrayRemove(_c(m, "l"), _lit(m, NAN)),
                    AD, [(v,) for v in DARRS]),
    "ArrayDistinct": (lambda m: m.CE.ArrayDistinct(_c(m, "l")), AS,
                      [(v,) for v in SARRS]),
    "Slice": (lambda m: m.CE.Slice(_c(m, "l"), _lit(m, -2), _lit(m, 5)),
              AL, [(v,) for v in ARRS]),
    "Slice zero start": (lambda m: m.CE.Slice(_c(m, "l"), _lit(m, 0),
                                              _lit(m, 1)), AL,
                         [(v,) for v in ARRS]),
    "Flatten": (lambda m: m.CE.Flatten(_c(m, "l")), AN,
                [(v,) for v in NESTED]),
    "ArraysOverlap": (lambda m: m.CE.ArraysOverlap(_c(m, "l"), _c(m, "l")),
                      AS, [(v,) for v in SARRS]),
    "ArrayJoin": (lambda m: m.CE.ArrayJoin(_c(m, "l"), "|", "?"), AS,
                  [(v,) for v in SARRS]),
    "ArrayJoin skip nulls": (lambda m: m.CE.ArrayJoin(_c(m, "l"), ","), AL,
                             [(v,) for v in ARRS]),
    "Sequence": (lambda m: m.CE.Sequence(_c(m, "a"), _lit(m, 3)),
                 [("a", "INT")], [(v,) for v in (0, 3, 7, -2, None)]),
    "Sequence step": (lambda m: m.CE.Sequence(_lit(m, 10), _c(m, "a"),
                                              _lit(m, -4)),
                      [("a", "INT")], [(v,) for v in (0, 10, 11, None)]),
    "ArrayRepeat": (lambda m: m.CE.ArrayRepeat(_lit(m, "x"), _c(m, "a")),
                    [("a", "INT")], [(v,) for v in (0, 2, -1, None)]),
    "transform": (lambda m: m.F.transform("l", lambda x: x * m.core.lit(2)),
                  AL, [(v,) for v in ARRS[:3]]),
    "filter": (lambda m: m.F.filter_("l", lambda x: x > m.core.lit(1)), AL,
               [(v,) for v in ARRS]),
    "exists": (lambda m: m.F.exists("l", lambda x: x > m.core.lit(2)), AL,
               [(v,) for v in ARRS]),
    "forall": (lambda m: m.F.forall("l", lambda x: x > m.core.lit(0)), AL,
               [(v,) for v in ARRS]),
    "aggregate": (lambda m: m.F.aggregate(
        "l", m.core.lit(0), lambda acc, x: m.C.Coalesce(x, m.core.lit(0))
        + acc, lambda acc: acc * m.core.lit(10)), AL,
        [(v,) for v in ARRS[:4]]),
    # maps
    "CreateMap": (lambda m: m.ME.CreateMap(_c(m, "s"), _lit(m, 1),
                                           _c(m, "s"), _lit(m, 2)), S1,
                  STR_ROWS[:3]),
    "GetMapValue": (lambda m: m.ME.GetMapValue(_c(m, "m"), "a"), MSL,
                    _pairs(MAPS, [None])),
    "GetMapValue column": (lambda m: m.ME.GetMapValue(_c(m, "m"),
                                                      _c(m, "k")), MSL,
                           _pairs(MAPS, ["b", "x", None])),
    "MapKeys": (lambda m: m.ME.MapKeys(_c(m, "m")), MSL,
                _pairs(MAPS, [None])),
    "MapValues": (lambda m: m.ME.MapValues(_c(m, "m")), MSL,
                  _pairs(MAPS, [None])),
    "MapContainsKey": (lambda m: m.ME.MapContainsKey(_c(m, "m"),
                                                     _c(m, "k")), MSL,
                       _pairs(MAPS, ["a", None])),
    # JSON and URL
    "GetJsonObject": (lambda m: m.JE.GetJsonObject(_c(m, "s"), "$.b[2].c"),
                      S1, [(v,) for v in JSON]),
    "GetJsonObject wildcard": (lambda m: m.JE.GetJsonObject(
        _c(m, "s"), "$.b[*].c"), S1, [(v,) for v in JSON]),
    "GetJsonObject root": (lambda m: m.JE.GetJsonObject(_c(m, "s"), "$.a"),
                           S1, [(v,) for v in JSON]),
    "JsonToStructsField": (lambda m: m.JE.JsonToStructsField(
        _c(m, "s"), "a", m.t.LONG), S1, [(v,) for v in JSON]),
    "JsonToStructsField string": (lambda m: m.JE.JsonToStructsField(
        _c(m, "s"), "b", m.t.STRING), S1, [(v,) for v in JSON]),
    "ParseUrl": (lambda m: m.UE.ParseUrl(_c(m, "s"), "QUERY", "x"), S1,
                 [(v,) for v in URLS]),
})
for _part in ("HOST", "PATH", "QUERY", "REF", "PROTOCOL", "FILE",
              "AUTHORITY", "USERINFO", "host"):
    CASES[f"ParseUrl {_part}"] = (
        lambda m, p=_part: m.UE.ParseUrl(_c(m, "s"), p), S1,
        [(v,) for v in URLS])


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b and math.copysign(1, a) == math.copysign(1, b)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def _bound(m, case):
    make, spec, _ = CASES[case]
    schema = m.t.Schema(tuple(m.t.StructField(n, _t(m, ty))
                              for n, ty in spec))
    return m.core.resolve(make(m), schema)


def _eval(m, e, rows):
    out = []
    for r in rows:
        try:
            out.append(("ok", m.fb.row_eval(e, r)))
        except Exception as ex:  # noqa: BLE001 — compared by type
            out.append(("raise", type(ex).__name__))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_row_eval_matches_jax(case):
    rows = CASES[case][2]
    te, je = _bound(TORCH, case), _bound(JAX, case)
    got, want = _eval(TORCH, te, rows), _eval(JAX, je, rows)
    bad = [(r, g, w) for r, g, w in zip(rows, got, want)
           if g[0] != w[0] or not _same(g[1], w[1])]
    assert not bad, bad[:4]
    assert tfallback.supports_host_eval(te) \
        == jfallback.supports_host_eval(je)


def test_every_evaluator_is_exercised():
    """Every `_EVALS` entry and every class with a host evaluator of the
    reference has its counterpart in the port, and a case above."""
    assert sorted(c.__name__ for c in tfallback._EVALS) \
        == sorted(c.__name__ for c in jfallback._EVALS)
    met = set()
    for case in CASES:
        e = _bound(TORCH, case)

        def walk(n):
            met.add(type(n).__name__)
            for c in n.children:
                walk(c)
        walk(e)
    names = {c.__name__ for c in tfallback._EVALS}
    for mod in (tS, tCE, tME, tJE, tUE):
        names |= {n for n, c in vars(mod).items() if isinstance(c, type)
                  and (hasattr(c, "host_eval_row")
                       or hasattr(c, "host_eval_with_row"))}
    names |= {c.__name__ for c in tfallback._SPECIAL}
    names -= {"ArrayMax"} if "ArrayMax" in met else set()
    assert names - met == set(), names - met


def _rejected(m):
    """Trees the row engine must not take: a decimal, a regex Python's re
    rejects, a cast to a type it cannot cast to, a node without a host
    evaluator."""
    c, t = m.core.col, m.t
    dec = t.Schema((t.StructField("d", t.DecimalType(12, 2)),
                    t.StructField("s", t.STRING),
                    t.StructField("a", t.LONG)))
    return [m.core.resolve(e, dec) for e in (
        m.A.Add(c("d"), c("d")),
        m.S.RLike(c("s"), "(unclosed"),
        m.S.RegExpReplace(c("s"), "[z-a]", "x"),
        m.S.StringSplit(c("s"), "*"),
        m.Cast(c("a"), t.DATE),
        m.Cast(c("s"), t.DecimalType(10, 2)),
        m.core.Alias(m.A.Add(c("a"), m.Cast(c("d"), t.LONG)), "x"))]


def test_supports_host_eval_rejects_as_jax_does():
    got = [tfallback.supports_host_eval(e) for e in _rejected(TORCH)]
    assert got == [jfallback.supports_host_eval(e) for e in _rejected(JAX)]
    assert not any(got)


def _frame(m, sess, data, spec):
    schema = m.t.Schema(tuple(m.t.StructField(n, _t(m, ty))
                              for n, ty in spec))
    return sess.from_pydict(data, schema)


WAVE4 = {
    # shape -> (query, data, schema)
    "levenshtein": (lambda m, d: d.select(m.F.levenshtein("s", "u")),
                    {"s": STRS, "u": STRS[::-1]}, S2),
    "encode UTF-16": (lambda m, d: d.select(m.F.encode("s", "UTF-16")),
                      {"s": STRS}, S1),
    "decode UTF-16BE": (lambda m, d: d.select(m.F.decode(
        m.F.encode("s", "UTF-8"), "UTF-16BE")), {"s": STRS}, S1),
    "array_join": (lambda m, d: d.select(m.F.array_join("l", "+", "~")),
                   {"l": SARRS}, AS),
    "array_position of strings": (lambda m, d: d.select(
        m.F.array_position("l", m.core.lit("b"))), {"l": SARRS}, AS),
    "array_distinct of strings": (lambda m, d: d.select(
        m.F.array_distinct("l")), {"l": SARRS}, AS),
    "sequence column bound": (lambda m, d: d.select(
        m.F.sequence("a", m.core.lit(4))), {"a": [1, 6, None, 4]},
        [("a", "INT")]),
    "array_repeat column count": (lambda m, d: d.select(
        m.F.array_repeat("a", "a")), {"a": [1, 3, None, 0]},
        [("a", "INT")]),
    "regex split": (lambda m, d: d.select(m.F.split("s", "#0+|[, ]")),
                    {"s": STRS}, S1),
    "aggregate()": (lambda m, d: d.select(m.F.aggregate(
        "l", m.core.lit(0), lambda acc, x: acc + x)),
        {"l": [[1, 2], [], None, [5]]}, AL),
    "lambda over an outer column": (lambda m, d: d.select(m.F.transform(
        "l", lambda x: x + m.core.col("a"))),
        {"l": [[1, 2], [], None, [5]], "a": [1, 2, 3, None]},
        AL + [("a", "LONG")]),
    "wildcard JSON path": (lambda m, d: d.select(m.F.get_json_object(
        "s", "$.b[*].c")), {"s": JSON}, S1),
    "from_json": (lambda m, d: d.select(m.JE.JsonToStructsField(
        m.core.col("s"), "a", m.t.LONG).alias("a")), {"s": JSON}, S1),
    "parse_url non-literal part": (lambda m, d: d.select(m.UE.ParseUrl(
        m.core.col("s"), m.core.col("u")).alias("p")),
        {"s": URLS, "u": ["HOST", "PATH", "QUERY", "HOST", "REF", "x"]},
        S2),
    "filter on the host": (lambda m, d: d.filter(m.P.GreaterThan(
        m.S.Levenshtein(m.core.col("s"), m.core.lit("abc")),
        m.core.lit(3))), {"s": STRS}, S1),
}


@pytest.mark.parametrize("shape", list(WAVE4))
def test_wave4_shapes_plan_on_the_row_engine_and_match_jax(shape):
    make, data, spec = WAVE4[shape]
    rows, texts = [], []
    for m, sess in ((TORCH, tsession.TpuSession(device="cpu")),
                    (JAX, jsession.TpuSession())):
        df = make(m, _frame(m, sess, data, spec))
        texts.append(df.explain())
        rows.append(df.collect())
    assert texts[0].startswith("~ ") and texts[1].startswith("~ ")
    assert "will run on CPU" in texts[0]
    assert _same(rows[0], rows[1]) and len(rows[0]) > 0


def test_lambda_over_nested_arrays_matches_python():
    """The JAX package's host tier raises TypeError here (its lambda binds
    the element list as an untyped literal: ROADMAP C.5); the port binds
    it as a literal of the element type and gives Python's rows."""
    data = {"n": NESTED}
    df = _frame(TORCH, tsession.TpuSession(device="cpu"), data, [
        ("n", lambda t: t.ArrayType(t.ArrayType(t.LONG)))])
    q = df.select(tF.transform("n", lambda x: tF.size(x)).alias("r"),
                  tF.filter_("n", lambda x: tF.size(x) > tcore.lit(0))
                  .alias("f"))
    assert q.explain().startswith("~ ")
    want = [(None if n is None else [None if x is None else len(x)
                                     for x in n],
             None if n is None else [x for x in n
                                     if x is not None and len(x) > 0])
            for n in NESTED]
    assert q.collect() == want
    jdf = _frame(JAX, jsession.TpuSession(), data, [
        ("n", lambda t: t.ArrayType(t.ArrayType(t.LONG)))])
    with pytest.raises(TypeError):
        jdf.select(jF.transform("n", lambda x: jF.size(x)).alias("r")) \
            .collect()


def test_get_array_item_with_a_column_index_on_the_host_gives_spark_rows():
    """ROADMAP C.5: the JAX package's host tier gives NULL on every row
    for a column index; the port's row engine gives Spark's rows, as its
    device path does (C.12): 0-based, NULL for a negative or
    out-of-bounds index and for a null array or index. A Levenshtein in
    the same projection puts it on the row engine."""
    arrays = [[10, 20, 30], [1], None, [5, None], [], [7, 8]]
    index = [0, 1, 1, 1, 0, -1]
    df = _frame(TORCH, tsession.TpuSession(device="cpu"),
                {"l": arrays, "i": index, "s": ["a"] * 6},
                [("l", lambda t: t.ArrayType(t.LONG)), ("i", "INT"),
                 ("s", "STRING")])
    q = df.select(tCE.GetArrayItem(tcore.col("l"), tcore.col("i"))
                  .alias("x"), tF.levenshtein("s", "s").alias("d"))
    assert q.explain().startswith("~ ")
    want = [(a[i] if a is not None and 0 <= i < len(a) else None, 0)
            for a, i in zip(arrays, index)]
    assert q.collect() == want
    device = df.select(tCE.GetArrayItem(tcore.col("l"), tcore.col("i"))
                       .alias("x"))
    assert device.explain().startswith("* ")
    assert [r[0] for r in device.collect()] == [w[0] for w in want]
