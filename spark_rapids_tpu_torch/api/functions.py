"""Column functions — the counterpart of spark_rapids_tpu/api/functions.py
(the pyspark.sql.functions analog), for the expressions and aggregates
the port has: `col`, `lit`, the aggregates (`sum`, `count`, `avg`/`mean`,
`min`, `max`, `first`, `last`, the variances and standard deviations),
`abs`, the conditionals, the date and time functions, the bitwise ones,
the string functions, `hash` and `xxhash64`, the collection functions,
the list aggregates (`collect_list`, `collect_set`, `percentile`,
`approx_percentile`) and the window functions (`row_number`, `rank`,
`dense_rank`, `lag`, `lead`, `first_value`, `last_value` and the
`window_*` aggregates; `.over(expr.windowexprs.window(...))` places
them), the maps, the higher-order array functions (lambdas over
`LambdaVar` placeholders), JSON and URL parsing and `udf` (a Python
function as an expression, expr/udf.py), with the JAX package's names
and signatures (z-order's InterleaveBits is an expression class,
expr/zorder.py, as in the JAX package).
"""

from __future__ import annotations

from ..expr import (arithmetic, bitwise, collectionexprs, conditional,
                    datetimeexprs, hashexprs, jsonexprs, mapexprs,
                    stringexprs, urlexprs, windowexprs)
from ..expr.aggexprs import (
    ApproxPercentile, Average, CollectList, CollectSet, Count, First, Last,
    Max, Min, Percentile, StddevPop, StddevSamp, Sum, VariancePop,
    VarianceSamp,
)
from ..expr.core import Expression, col, lit  # noqa: F401


def _e(x) -> Expression:
    return x if isinstance(x, Expression) else (col(x) if isinstance(x, str)
                                                else lit(x))


def udf(fn=None, *, return_type=None):
    from ..expr.udf import udf as _udf
    return _udf(fn, return_type=return_type)


# aggregates ---------------------------------------------------------------
def sum(x):  # noqa: A001
    return Sum(_e(x))


def count(x=None):
    return Count(_e(x)) if x is not None else Count()


def avg(x):
    return Average(_e(x))


mean = avg


def min(x):  # noqa: A001
    return Min(_e(x))


def max(x):  # noqa: A001
    return Max(_e(x))


def first(x, ignore_nulls=False):
    return First(_e(x), ignore_nulls=ignore_nulls)


def last(x, ignore_nulls=False):
    return Last(_e(x), ignore_nulls=ignore_nulls)


def percentile(x, percentage):
    return Percentile(_e(x), percentage)


def approx_percentile(x, percentage, accuracy=None):
    return ApproxPercentile(_e(x), percentage, accuracy)


def collect_list(x):
    return CollectList(_e(x))


def collect_set(x):
    return CollectSet(_e(x))


# window functions ------------------------------------------------------------
def row_number():
    return windowexprs.RowNumber()


def rank():
    return windowexprs.Rank()


def dense_rank():
    return windowexprs.DenseRank()


def lag(x, offset=1, default=None):
    return windowexprs.Lag(_e(x), offset, default)


def lead(x, offset=1, default=None):
    return windowexprs.Lead(_e(x), offset, default)


def window_sum(x):
    return windowexprs.WindowAgg("sum", _e(x))


def window_min(x):
    return windowexprs.WindowAgg("min", _e(x))


def window_max(x):
    return windowexprs.WindowAgg("max", _e(x))


def window_count(x=None):
    return windowexprs.WindowAgg("count", _e(x) if x is not None else None)


def window_avg(x):
    return windowexprs.WindowAgg("avg", _e(x))


def first_value(x):
    return windowexprs.FirstValue(_e(x))


def last_value(x):
    return windowexprs.LastValue(_e(x))


# collections ------------------------------------------------------------------
def size(x):
    return collectionexprs.Size(_e(x))


def array_contains(x, value):
    return collectionexprs.ArrayContains(_e(x), value)


def element_at(x, index):
    return collectionexprs.ElementAt(_e(x), index)


def get_array_item(x, index):
    return collectionexprs.GetArrayItem(_e(x), index)


# maps -----------------------------------------------------------------------
def create_map(*cols):
    return mapexprs.CreateMap(*[_e(c) for c in cols])


def map_keys(x):
    return mapexprs.MapKeys(_e(x))


def map_values(x):
    return mapexprs.MapValues(_e(x))


def map_contains_key(x, key):
    return mapexprs.MapContainsKey(_e(x), key)


def get_map_value(x, key):
    k = _e(key) if not isinstance(key, (str, int, float)) else key
    return mapexprs.GetMapValue(_e(x), k)


def element_at_key(x, key):
    """element_at over a MAP with a non-literal (column) key."""
    return get_map_value(x, key)


# higher-order functions ----------------------------------------------------
def _lambda_body(fn, *var_names):
    """The body expression of a Python lambda over LambdaVar placeholders:
    F.transform(c, lambda x: x + 1)."""
    return fn(*[collectionexprs.LambdaVar(n) for n in var_names])


def transform(x, fn):
    return collectionexprs.ArrayTransform(_e(x), _lambda_body(fn, "x"), "x")


def filter_(x, fn):
    return collectionexprs.ArrayFilter(_e(x), _lambda_body(fn, "x"), "x")


def exists(x, fn):
    return collectionexprs.ArrayExists(_e(x), _lambda_body(fn, "x"), "x")


def forall(x, fn):
    return collectionexprs.ArrayForAll(_e(x), _lambda_body(fn, "x"), "x")


def aggregate(x, zero, merge, finish=None):
    LambdaVar = collectionexprs.LambdaVar
    merge_body = merge(LambdaVar("acc"), LambdaVar("x"))
    finish_body = finish(LambdaVar("acc")) if finish is not None else None
    return collectionexprs.ArrayAggregate(_e(x), _e(zero), merge_body,
                                          finish_body)


# JSON and URL ---------------------------------------------------------------
def get_json_object(x, path):
    return jsonexprs.GetJsonObject(_e(x), path)


def parse_url(x, part, key=None):
    return urlexprs.ParseUrl(_e(x), part, key)


def sort_array(x, asc=True):
    return collectionexprs.SortArray(_e(x), asc)


def array_min(x):
    return collectionexprs.ArrayMin(_e(x))


def array_max(x):
    return collectionexprs.ArrayMax(_e(x))


def array(*xs):
    return collectionexprs.CreateArray(*[_e(x) for x in xs])


def array_position(x, v):
    return collectionexprs.ArrayPosition(_e(x), _e(v))


def array_remove(x, v):
    return collectionexprs.ArrayRemove(_e(x), _e(v))


def array_distinct(x):
    return collectionexprs.ArrayDistinct(_e(x))


def slice(x, start, length):  # noqa: A001 - Spark name
    return collectionexprs.Slice(_e(x), _e(start), _e(length))


def flatten(x):
    return collectionexprs.Flatten(_e(x))


def arrays_overlap(a, b):
    return collectionexprs.ArraysOverlap(_e(a), _e(b))


def array_join(x, delim, null_replacement=None):
    return collectionexprs.ArrayJoin(_e(x), delim, null_replacement)


def sequence(start, stop, step=None):
    return collectionexprs.Sequence(_e(start), _e(stop),
                                    _e(step) if step is not None else None)


def array_repeat(x, n):
    return collectionexprs.ArrayRepeat(_e(x), _e(n))


def stddev(x):
    return StddevSamp(_e(x))


stddev_samp = stddev


def stddev_pop(x):
    return StddevPop(_e(x))


def variance(x):
    return VarianceSamp(_e(x))


var_samp = variance


def var_pop(x):
    return VariancePop(_e(x))


# arithmetic ---------------------------------------------------------------
def abs(x):  # noqa: A001
    return arithmetic.Abs(_e(x))


# conditionals -------------------------------------------------------------
def coalesce(*xs):
    return conditional.Coalesce(*[_e(x) for x in xs])


def when(cond, value):
    """CASE WHEN cond THEN value END (null elsewhere); a CaseWhen with more
    branches or an ELSE is built directly."""
    return conditional.CaseWhen([(_e(cond), _e(value))], None)


def nvl(a, b):
    return conditional.Nvl(_e(a), _e(b))


ifnull = nvl


def nvl2(a, b, c):
    return conditional.Nvl2(_e(a), _e(b), _e(c))


def nullif(a, b):
    return conditional.NullIf(_e(a), _e(b))


# datetime functions -------------------------------------------------------
def year(x):
    return datetimeexprs.Year(_e(x))


def month(x):
    return datetimeexprs.Month(_e(x))


def dayofmonth(x):
    return datetimeexprs.DayOfMonth(_e(x))


def dayofweek(x):
    return datetimeexprs.DayOfWeek(_e(x))


def dayofyear(x):
    return datetimeexprs.DayOfYear(_e(x))


def quarter(x):
    return datetimeexprs.Quarter(_e(x))


def hour(x):
    return datetimeexprs.Hour(_e(x))


def minute(x):
    return datetimeexprs.Minute(_e(x))


def second(x):
    return datetimeexprs.Second(_e(x))


def date_add(x, n):
    return datetimeexprs.DateAdd(_e(x), _e(n))


def date_sub(x, n):
    return datetimeexprs.DateAdd(_e(x), _e(n), negate=True)


def datediff(end, start):
    return datetimeexprs.DateDiff(_e(end), _e(start))


def add_months(x, n):
    return datetimeexprs.AddMonths(_e(x), _e(n))


def last_day(x):
    return datetimeexprs.LastDay(_e(x))


def trunc(x, unit):
    return datetimeexprs.TruncDate(_e(x), unit)


def from_utc_timestamp(x, tz):
    return datetimeexprs.FromUTCTimestamp(_e(x), tz)


def to_utc_timestamp(x, tz):
    return datetimeexprs.ToUTCTimestamp(_e(x), tz)


# bitwise / shifts ---------------------------------------------------------
def shiftleft(x, n):
    return bitwise.ShiftLeft(_e(x), _e(n))


def shiftright(x, n):
    return bitwise.ShiftRight(_e(x), _e(n))


def shiftrightunsigned(x, n):
    return bitwise.ShiftRightUnsigned(_e(x), _e(n))


def bitwise_not(x):
    return bitwise.BitwiseNot(_e(x))


# strings --------------------------------------------------------------------
def length(x):
    return stringexprs.Length(_e(x))


def upper(x):
    return stringexprs.Upper(_e(x))


def lower(x):
    return stringexprs.Lower(_e(x))


def substring(x, pos, length_):
    return stringexprs.Substring(_e(x), pos, length_)


def trim(x, trim_str=None):
    return stringexprs.StringTrim(_e(x), trim_str)


def ltrim(x, trim_str=None):
    return stringexprs.StringTrimLeft(_e(x), trim_str)


def rtrim(x, trim_str=None):
    return stringexprs.StringTrimRight(_e(x), trim_str)


def lpad(x, length_, pad=" "):
    return stringexprs.StringLPad(_e(x), length_, pad)


def rpad(x, length_, pad=" "):
    return stringexprs.StringRPad(_e(x), length_, pad)


def repeat(x, n):
    return stringexprs.StringRepeat(_e(x), n)


def reverse(x):
    return stringexprs.Reverse(_e(x))


def initcap(x):
    return stringexprs.InitCap(_e(x))


def locate(substr, x, pos=1):
    return stringexprs.StringLocate(substr, _e(x), pos)


def instr(x, substr):
    return stringexprs.StringLocate(substr, _e(x), 1)


def replace(x, search, replacement=""):
    return stringexprs.StringReplace(_e(x), search, replacement)


def concat(*xs):
    return stringexprs.Concat(*[_e(x) for x in xs])


def concat_ws(sep, *xs):
    return stringexprs.ConcatWs(sep, *[_e(x) for x in xs])


def translate(x, from_str, to_str):
    return stringexprs.StringTranslate(_e(x), from_str, to_str)


def ascii(x):  # noqa: A001
    return stringexprs.Ascii(_e(x))


def chr(x):  # noqa: A001
    return stringexprs.Chr(_e(x))


def left(x, n):
    return stringexprs.Left(_e(x), n)


def right(x, n):
    return stringexprs.Right(_e(x), n)


def octet_length(x):
    return stringexprs.OctetLength(_e(x))


def bit_length(x):
    return stringexprs.BitLength(_e(x))


def contains(x, needle):
    return stringexprs.Contains(_e(x), needle)


def startswith(x, prefix):
    return stringexprs.StartsWith(_e(x), prefix)


def endswith(x, suffix):
    return stringexprs.EndsWith(_e(x), suffix)


def rlike(x, pattern):
    return stringexprs.RLike(_e(x), pattern)


def like(x, pattern, escape_char="\\"):
    return stringexprs.Like(_e(x), pattern, escape_char)


def split(x, pattern, limit=-1):
    return stringexprs.StringSplit(_e(x), pattern, limit)


def substring_index(x, delim, count):
    return stringexprs.SubstringIndex(_e(x), delim, count)


def find_in_set(needle, s):
    return stringexprs.FindInSet(_e(needle), _e(s))


def regexp_extract(x, pattern, idx=1):
    return stringexprs.RegExpExtract(_e(x), pattern, idx)


def regexp_replace(x, pattern, replacement):
    return stringexprs.RegExpReplace(_e(x), pattern, replacement)


def format_number(x, d):
    return stringexprs.FormatNumber(_e(x), d)


def levenshtein(a, b):
    return stringexprs.Levenshtein(_e(a), _e(b))


def base64(x):
    return stringexprs.Base64Encode(_e(x))


def unbase64(x):
    return stringexprs.UnBase64(_e(x))


def hex(x):  # noqa: A001
    return stringexprs.Hex(_e(x))


def unhex(x):
    return stringexprs.Unhex(_e(x))


def encode(x, charset):
    return stringexprs.Encode(_e(x), charset)


def decode(x, charset):
    return stringexprs.Decode(_e(x), charset)


# hashes -------------------------------------------------------------------
def hash(*xs):  # noqa: A001
    return hashexprs.Murmur3Hash(*[_e(x) for x in xs])


def xxhash64(*xs):
    return hashexprs.XxHash64(*[_e(x) for x in xs])
