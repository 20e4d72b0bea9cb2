"""Override rule tables and plan conversion — the counterpart of
spark_rapids_tpu/plan/overrides.py (the reference's GpuOverrides.scala:
rule tables :919/:3838, wrapAndTagPlan :4421, doConvertPlan :4427; and
GpuTransitionOverrides' coalesce insertion :322).

As in the JAX package, a node that can run neither on the card nor on
the host row engine makes `apply` raise PlanNotSupported with the whole
explain report. The rules cover what the port has: the expressions of
expr/{core,arithmetic,predicates,conditional,cast,math,bitwise,
datetimeexprs,hashexprs,stringexprs,collectionexprs,mapexprs,jsonexprs,
urlexprs,zorder,udf}, the aggregate and window functions of
expr/{aggexprs,windowexprs}, and the scan, project, filter, range, union,
limit, expand, sample, aggregate (single-stage, or partial -> host
exchange -> final), hash join of every join type (broadcast,
host-shuffled, single-partition or, when a side's size is unknown, the
adaptive join that measures its sides at run time), nested-loop join of
a keyless join (over a broadcast when the right side fits), sort (over a
range exchange and PartitionWiseSortExec when the host shuffle has
partitions), TopN, repartition, window and generate operators, and
the pandas UDF family's five (exec/python_udf.py).

A Project or Filter whose expressions lack a device path runs on the
host row engine (exec/fallback.py) when every one of them has a host
evaluator (`_can_host_fallback`): `convert` wraps it in the transitions
and explain() marks it `~` with the reason. Under
spark.rapids.sql.optimizer.enabled the cost model (plan/cost.py) may
place a device-eligible one there too; under
spark.rapids.sql.udfCompiler.enabled `apply` first compiles the plan's
Python UDFs into expressions (udf_compiler). Other nodes tag off, as in
the JAX package: an expression the device and the host both lack
(decimal128 multiply and divide, casts without a kernel to a type the
host cannot cast to, unknown time zones, a regex Python's re rejects),
an average over a DECIMAL, whose evaluation raises in the JAX package
(C.5), and its plan-level tag-offs (collect_set over strings, a join
whose payload holds an array of strings).

Over the session's mesh (parallel/mesh.active_mesh, of more than one
shard, with tpu.shuffle.planExchange on: `_plan_mesh`) a grouped
aggregate plans partial -> ShuffleExchangeExec -> final and an equi-join
that broadcasts neither side a ShuffledHashJoinExec over two
ShuffleExchangeExecs, as the JAX package's planner does; the host
shuffle's sub-partitioned join, shuffled join and range sort are planned
only without a mesh. `apply` ends, as the JAX package's does, in
the stage compiler (exec/stage_compiler.compile_stages), which groups
whitelisted chains into CompiledStageExec nodes: one CUDA graph per stage
step on the card, the same bodies run eagerly on the CPU; with
spark.rapids.tpu.stage.fusion.enabled=false the tree is returned as it
was converted. The plan's
decisions are events (`_emit_plan_decisions`): one `plan_fallback` per
host-row-engine node and one `plan_not_on_tpu` per tag-off reason.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Type

from ..config import (ADAPTIVE_AUTO_BROADCAST_MAX_BYTES, ADAPTIVE_ENABLED,
                      BROADCAST_SIZE_THRESHOLD, CPU_FALLBACK_ENABLED,
                      JOIN_SUBPARTITION_THRESHOLD, OPTIMIZER_ENABLED,
                      PARQUET_PUSHDOWN_ENABLED, SHUFFLE_MODE,
                      SHUFFLE_PARTITIONS, SHUFFLE_PLAN_EXCHANGE,
                      SQL_ENABLED, RapidsConf,
                      active_conf, set_active_conf)
from ..exec.aggregate import AggregateExec
from ..exec.base import TpuExec
from ..exec.basic import (ExpandExec, FilterExec, GlobalLimitExec,
                          ProjectExec, RangeExec, SampleExec, SourceScanExec,
                          UnionExec, bind_projection)
from ..exec.coalesce import CoalesceBatchesExec
from ..exec.fallback import (ColumnarToRowExec, HostFilterExec,
                             HostProjectExec, RowToColumnarExec,
                             supports_host_eval)
from ..exec.generate import GenerateExec
from ..exec.exchange import (BroadcastExchangeExec, HostShuffleExchangeExec,
                             ShuffledHashJoinExec, ShuffleExchangeExec)
from ..exec.joins import (NESTED_LOOP_JOIN_TYPES, AdaptiveJoinExec,
                          HashJoinExec, NestedLoopJoinExec)
from ..exec.sort import (PartitionWiseSortExec, SortExec, TopNExec,
                         resolve_sort_orders)
from ..exec.window import WindowExec
from ..expr import (aggexprs, arithmetic, bitwise, cast, collectionexprs,
                    conditional, datetimeexprs, hashexprs, jsonexprs,
                    mapexprs, predicates, stringexprs, urlexprs,
                    windowexprs, zorder)
from ..expr import math as emath
from ..expr.core import (
    Alias, BoundReference, Expression, Literal, UnresolvedAttribute, resolve,
)
from ..types import ArrayType, DecimalType, MapType, StringType, StructType
from . import logical as L
from .meta import BaseMeta, ExprMeta, ExprRule
from .typesig import (
    BOOLEAN, TypeSig, all_types, commonly_supported, comparable, fp,
    integral, numeric, numeric_and_decimal, orderable, stringlike,
)

class PlanNotSupported(Exception):
    def __init__(self, report: str):
        super().__init__(
            "plan cannot run on TPU:\n" + report)
        self.report = report


# ---------------------------------------------------------------------------
# expression rule table (the JAX package's rules for the classes the port
# has; later waves register theirs)
# ---------------------------------------------------------------------------

_EXPR_RULES: Optional[Dict[Type[Expression], ExprRule]] = None


def _r(rules, cls, desc, input_sig=commonly_supported,
       output_sig=commonly_supported, tag_fn=None):
    rules[cls] = ExprRule(cls, desc, input_sig, output_sig, tag_fn)


def expression_rules() -> Dict[Type[Expression], ExprRule]:
    global _EXPR_RULES
    if _EXPR_RULES is not None:
        return _EXPR_RULES
    rules: Dict[Type[Expression], ExprRule] = {}
    num = numeric_and_decimal
    # leaves: pass through whatever the column holds — the consuming
    # expression's input signature is what gates support
    _r(rules, Literal, "literal value")
    _r(rules, BoundReference, "column reference", all_types, all_types)
    _r(rules, UnresolvedAttribute, "column reference", all_types, all_types)
    _r(rules, Alias, "named expression", all_types, all_types)
    # arithmetic. decimal128: add/sub at any precision, multiply only
    # from <=18-digit inputs (a wider input would need a 256-bit
    # intermediate), div/mod past 18 digits need a 128/64 long division:
    # tagged off at plan time, as in the JAX package
    for c in (arithmetic.Add, arithmetic.Subtract, arithmetic.Multiply):
        _r(rules, c, f"{c.__name__.lower()}", num, num,
           tag_fn=_tag_decimal128)
    _r(rules, arithmetic.Divide, "division", num, fp + TypeSig.of("DECIMAL"),
       tag_fn=_tag_decimal128)
    _r(rules, arithmetic.IntegralDivide, "integral division", num, integral,
       tag_fn=_tag_decimal128)
    _r(rules, arithmetic.Remainder, "remainder", num, num,
       tag_fn=_tag_decimal128)
    _r(rules, arithmetic.Pmod, "positive modulo", num, num,
       tag_fn=_tag_decimal128)
    _r(rules, arithmetic.UnaryMinus, "negation", num, num)
    _r(rules, arithmetic.Abs, "absolute value", num, num)
    _r(rules, arithmetic.Least, "least of arguments", orderable, orderable)
    _r(rules, arithmetic.Greatest, "greatest of arguments", orderable,
       orderable)
    # predicates
    for c in (predicates.EqualTo, predicates.EqualNullSafe,
              predicates.LessThan, predicates.LessThanOrEqual,
              predicates.GreaterThan, predicates.GreaterThanOrEqual):
        _r(rules, c, "comparison", comparable, BOOLEAN)
    for c in (predicates.And, predicates.Or, predicates.Not):
        _r(rules, c, "boolean logic", BOOLEAN, BOOLEAN)
    _r(rules, predicates.IsNull, "null check", commonly_supported, BOOLEAN)
    _r(rules, predicates.IsNotNull, "non-null check", commonly_supported,
       BOOLEAN)
    _r(rules, predicates.In, "IN list", comparable, BOOLEAN)
    # conditional
    _r(rules, conditional.If, "if/else", commonly_supported)
    _r(rules, conditional.CaseWhen, "case/when", commonly_supported)
    _r(rules, conditional.Coalesce, "first non-null", commonly_supported)
    _r(rules, conditional.IsNaN, "NaN check", fp, BOOLEAN)
    _r(rules, conditional.NaNvl, "NaN replacement", fp, fp)
    _r(rules, conditional.Nvl, "nvl/ifnull")
    _r(rules, conditional.Nvl2, "nvl2")
    _r(rules, conditional.NullIf, "nullif")
    # cast: the pairs without a device kernel are tagged off
    _r(rules, cast.Cast, "type cast", tag_fn=_tag_cast)
    # datetime
    dtsig = TypeSig.of("DATE", "TIMESTAMP", "TIMESTAMP_NTZ")
    tssig = TypeSig.of("TIMESTAMP", "TIMESTAMP_NTZ")
    for c in (datetimeexprs.Year, datetimeexprs.Month,
              datetimeexprs.DayOfMonth, datetimeexprs.DayOfWeek,
              datetimeexprs.DayOfYear, datetimeexprs.Quarter):
        _r(rules, c, "date part extraction", dtsig, integral)
    for c in (datetimeexprs.Hour, datetimeexprs.Minute,
              datetimeexprs.Second):
        _r(rules, c, "time part extraction", tssig, integral)
    _r(rules, datetimeexprs.DateAdd, "date_add/date_sub", dtsig + integral,
       dtsig)
    _r(rules, datetimeexprs.DateDiff, "datediff", dtsig, integral)
    _r(rules, datetimeexprs.AddMonths, "add_months", dtsig + integral, dtsig)
    _r(rules, datetimeexprs.LastDay, "last_day", dtsig, dtsig)
    _r(rules, datetimeexprs.TruncDate, "trunc", dtsig, dtsig)
    _r(rules, datetimeexprs.FromUTCTimestamp,
       "UTC -> zone wall clock (device tz transition tables)", tssig, tssig,
       tag_fn=_tag_timezone)
    _r(rules, datetimeexprs.ToUTCTimestamp,
       "zone wall clock -> UTC (device tz transition tables)", tssig, tssig,
       tag_fn=_tag_timezone)
    # math: one rule per Spark expression, as the reference's table is
    for c in (emath.Sqrt, emath.Exp, emath.Expm1, emath.Log, emath.Log2,
              emath.Log10, emath.Log1p, emath.Sin, emath.Cos, emath.Tan,
              emath.Asin, emath.Acos, emath.Atan, emath.Sinh, emath.Cosh,
              emath.Tanh, emath.Asinh, emath.Acosh, emath.Atanh,
              emath.Cbrt, emath.ToDegrees, emath.ToRadians, emath.Signum,
              emath.Rint, emath.Pow, emath.Atan2, emath.Floor, emath.Ceil,
              emath.Round, emath.BRound):
        _r(rules, c, f"math function {c.__name__.lower()}", num, num,
           tag_fn=_tag_decimal128_input)
    _r(rules, emath.UnaryMath, "math function (family base)", num, num)
    # bitwise and shifts
    for c, d in ((bitwise.BitwiseAnd, "bitwise AND"),
                 (bitwise.BitwiseOr, "bitwise OR"),
                 (bitwise.BitwiseXor, "bitwise XOR"),
                 (bitwise.BitwiseNot, "bitwise NOT"),
                 (bitwise.ShiftLeft, "left shift"),
                 (bitwise.ShiftRight, "arithmetic right shift"),
                 (bitwise.ShiftRightUnsigned, "logical right shift")):
        _r(rules, c, d, integral, integral)
    # hash
    _r(rules, hashexprs.Murmur3Hash, "murmur3 hash", commonly_supported,
       integral)
    _r(rules, hashexprs.XxHash64, "xxhash64", commonly_supported, integral)
    # strings
    se = stringexprs
    _r(rules, se.Length, "string length", stringlike, integral)
    _r(rules, se.Upper, "uppercase (ASCII)", stringlike, stringlike)
    _r(rules, se.Lower, "lowercase (ASCII)", stringlike, stringlike)
    _r(rules, se.Substring, "substring", stringlike, stringlike)
    _r(rules, se.StartsWith, "prefix match", stringlike, BOOLEAN)
    _r(rules, se.EndsWith, "suffix match", stringlike, BOOLEAN)
    _r(rules, se.Contains, "substring match", stringlike, BOOLEAN)
    for c, d in ((se.StringTrim, "trim"), (se.StringTrimLeft, "ltrim"),
                 (se.StringTrimRight, "rtrim"), (se.StringLPad, "lpad"),
                 (se.StringRPad, "rpad"), (se.StringRepeat, "repeat"),
                 (se.Reverse, "reverse (byte order)"),
                 (se.InitCap, "initcap"),
                 (se.StringReplace, "literal replace"),
                 (se.Concat, "string concatenation"),
                 (se.ConcatWs, "concat with separator"),
                 (se.StringTranslate, "character translation"),
                 (se.Left, "left substring"), (se.Right, "right substring")):
        _r(rules, c, d, stringlike, stringlike)
    _r(rules, se.StringLocate, "substring position", stringlike, integral)
    _r(rules, se.Ascii, "first byte code", stringlike, integral)
    _r(rules, se.Chr, "code point to string", integral, stringlike)
    _r(rules, se.OctetLength, "byte length", stringlike, integral)
    _r(rules, se.BitLength, "bit length", stringlike, integral)
    _r(rules, se.RLike,
       "regex match (device Glushkov automaton; unsupported constructs "
       "tag off, reference RegexParser.scala:687)",
       stringlike, BOOLEAN, tag_fn=_tag_regex)
    _r(rules, se.Like, "SQL LIKE pattern", stringlike, BOOLEAN,
       tag_fn=_tag_regex)
    # the JAX package's host-tier family: device kernels where
    # `device_supported`, tagged off elsewhere
    _r(rules, se.SubstringIndex, "substring_index", stringlike, stringlike,
       tag_fn=_tag_device_when_supported)
    _r(rules, se.FindInSet, "find_in_set", stringlike, integral)
    _r(rules, se.RegExpExtract, "regex group extract", stringlike,
       stringlike, tag_fn=_tag_device_when_supported)
    _r(rules, se.RegExpReplace, "regex replace", stringlike, stringlike,
       tag_fn=_tag_device_when_supported)
    _r(rules, se.FormatNumber,
       "format_number (device digit emission; decimal inputs host tier)",
       numeric, stringlike, tag_fn=_tag_device_when_supported)
    _r(rules, se.Levenshtein, "edit distance (host tier)", stringlike,
       integral, tag_fn=_tag_device_when_supported)
    for c, d, in_sig in (
            (se.Base64Encode, "base64 encode", stringlike),
            (se.UnBase64, "base64 decode", stringlike),
            (se.Hex, "hex encode", stringlike + integral),
            (se.Unhex, "hex decode", stringlike)):
        _r(rules, c, d, in_sig, stringlike)
    for c, d, in_sig in (
            (se.Encode, "charset encode", TypeSig.of("STRING")),
            (se.Decode, "charset decode", stringlike)):
        _r(rules, c,
           d + " (device UTF-8/ASCII/Latin-1 byte maps; UTF-16 host tier)",
           in_sig, stringlike, tag_fn=_tag_device_when_supported)
    arr = TypeSig.of("ARRAY")
    _r(rules, se.StringSplit, "string split", stringlike, arr,
       tag_fn=_tag_device_when_supported)
    ce = collectionexprs
    mapsig = TypeSig.of("MAP")
    _r(rules, ce.Size, "array/map size", arr + mapsig, integral)
    _r(rules, ce.ArrayContains, "array membership", arr, BOOLEAN)
    _r(rules, ce.ElementAt, "element access (array/map)",
       arr + mapsig + commonly_supported, commonly_supported)
    # a column index too: the port gives Spark's rows where the JAX
    # package's host tier gives NULL (ROADMAP C.5, C.12)
    _r(rules, ce.GetArrayItem, "0-based element access", arr + integral,
       commonly_supported)
    # maps (reference GpuCreateMap/GpuGetMapValue/GpuMapKeys/
    # GpuMapValues); a column key of map_contains_key runs on the device
    # too, where the JAX package's rule sends it to its host tier
    me = mapexprs
    _r(rules, me.CreateMap, "map constructor", commonly_supported, mapsig)
    _r(rules, me.GetMapValue, "map value lookup",
       mapsig + commonly_supported, commonly_supported)
    _r(rules, me.MapKeys, "map_keys", mapsig, arr)
    _r(rules, me.MapValues, "map_values", mapsig, arr)
    _r(rules, me.MapContainsKey, "map_contains_key",
       mapsig + commonly_supported, BOOLEAN)
    # higher-order functions: lambdas over the variable and literals run
    # as one flat pass over the child column, the others (and
    # aggregate()) on the host row engine
    for c, d in ((ce.ArrayTransform, "transform() HOF"),
                 (ce.ArrayFilter, "filter() HOF"),
                 (ce.ArrayExists, "exists() HOF"),
                 (ce.ArrayForAll, "forall() HOF"),
                 (ce.ArrayAggregate, "aggregate() HOF (host tier)")):
        _r(rules, c, d, commonly_supported + arr, commonly_supported + arr,
           tag_fn=_tag_device_when_supported)
    # JSON and URL: literal wildcard-free paths and literal parts run the
    # byte-parallel kernels; from_json is host tier
    _r(rules, jsonexprs.GetJsonObject, "JSON path extraction", stringlike,
       stringlike, tag_fn=_tag_device_when_supported)
    _r(rules, jsonexprs.JsonToStructsField,
       "from_json single field (host tier)", stringlike, commonly_supported,
       tag_fn=_tag_device_when_supported)
    _r(rules, urlexprs.ParseUrl, "URL part extraction", stringlike,
       stringlike, tag_fn=_tag_device_when_supported)
    _r(rules, zorder.InterleaveBits,
       "z-order bit interleave (reference GpuInterleaveBits)", integral,
       integral)
    from ..expr.udf import PythonUDF
    # the types the host boundary converts (a DECIMAL, DATE or TIMESTAMP
    # would arrive as its physical int)
    _r(rules, PythonUDF,
       "Python UDF (host round trip: one packed copy down and one up a "
       "batch, the reference's Arrow-batched Python worker)",
       numeric + BOOLEAN + TypeSig.of("STRING"), numeric + BOOLEAN)
    _r(rules, ce.SortArray, "in-array sort", arr, arr,
       tag_fn=_tag_fixed_width_elements)
    _r(rules, ce.ArrayMin, "array minimum", arr, numeric_and_decimal,
       tag_fn=_tag_fixed_width_elements)
    _r(rules, ce.ArrayMax, "array maximum", arr, numeric_and_decimal,
       tag_fn=_tag_fixed_width_elements)
    # fixed-width inputs only: the interleave has no string element path
    _r(rules, ce.CreateArray, "array constructor",
       numeric_and_decimal + TypeSig.of("BOOLEAN", "DATE", "TIMESTAMP",
                                        "TIMESTAMP_NTZ"), arr)
    # the JAX package's host-tier family: device kernels where
    # `device_supported` (array_join has none)
    for c, d in ((ce.ArrayPosition, "array_position"),
                 (ce.ArrayRemove, "array_remove"),
                 (ce.ArrayDistinct, "array_distinct"),
                 (ce.Slice, "slice"),
                 (ce.Flatten, "flatten"),
                 (ce.ArraysOverlap, "arrays_overlap"),
                 (ce.ArrayRepeat, "array_repeat (literal count)"),
                 (ce.Sequence, "sequence (literal bounds)"),
                 (ce.ArrayJoin, "array_join (host tier)")):
        _r(rules, c, d, commonly_supported + arr, commonly_supported + arr,
           tag_fn=_tag_device_when_supported)
    _EXPR_RULES = rules
    return rules


def _tag_fixed_width_elements(meta) -> None:
    """Sort, min and max kernels need fixed-width elements (no string sort
    lanes in arrays): tagged off at plan time, as in the JAX package."""
    for c in meta.children:
        try:
            dt = c.expr.data_type
        except TypeError:
            continue
        if isinstance(dt, ArrayType) and not dt.element_type.is_fixed_width:
            meta.will_not_work_on_tpu(
                f"array<{dt.element_type.simple_name()}> elements are not "
                "fixed-width (string sort lanes in arrays planned)")


def _tag_decimal128(meta) -> None:
    """Tag off a decimal multiply, divide or modulo with a >18-digit
    input, with the JAX package's reasons."""
    e = meta.expr
    try:
        out_t = e.data_type
        in_ts = [c.data_type for c in e.children]
    except (TypeError, NotImplementedError):
        return
    name = type(e).__name__
    if not (isinstance(out_t, DecimalType)
            or any(isinstance(t, DecimalType) for t in in_ts)):
        return
    big_in = any(isinstance(t, DecimalType) and t.precision > 18
                 for t in in_ts)
    if name == "Multiply" and big_in:
        meta.will_not_work_on_tpu(
            "decimal multiply with >18-digit inputs needs a 256-bit "
            "intermediate")
    if name in ("Divide", "IntegralDivide", "Remainder", "Pmod") \
            and big_in:
        meta.will_not_work_on_tpu(
            f"decimal {name.lower()} with >18-digit inputs has no "
            "device kernel")


def _tag_decimal128_input(meta) -> None:
    """Math reads a DECIMAL input's one unscaled lane: a decimal128 input
    has no device path in either package."""
    try:
        in_ts = [c.data_type for c in meta.expr.children]
    except (TypeError, NotImplementedError):
        return
    if any(isinstance(t, DecimalType) and t.is_decimal128 for t in in_ts):
        meta.will_not_work_on_tpu(
            f"{type(meta.expr).__name__} of a decimal128 input has no "
            "device kernel")


def _tag_cast(meta) -> None:
    """The cast pairs without a device kernel, tagged off the device at
    plan time (to a host-castable type, the node runs on the host row
    engine, as in the JAX package)."""
    from ..types import DoubleType, FloatType, TimestampType
    c = meta.expr
    try:
        src = c.children[0].data_type
        dst = c.data_type
    except (TypeError, NotImplementedError):
        return  # unresolved; re-checked post-bind
    off = (isinstance(dst, StringType)
           and isinstance(src, (FloatType, DoubleType, TimestampType))) \
        or (isinstance(src, StringType)
            and isinstance(dst, (TimestampType, DecimalType))) \
        or (isinstance(src, DecimalType) and src.precision > 18) \
        or (isinstance(dst, DecimalType) and dst.precision > 18)
    if off:
        meta.will_not_work_on_tpu(
            f"cast {src.simple_name()} -> {dst.simple_name()} has no "
            "device kernel")


def _tag_timezone(meta) -> None:
    """Resolve the zone at plan time: an unknown zone or a corrupt tzdata
    file tags the expression off instead of failing mid-kernel."""
    import struct as _struct

    from ..ops.timezone import timezone_db
    try:
        timezone_db().tables(meta.expr.tz)
    except (ValueError, OSError, AssertionError, IndexError, TypeError,
            _struct.error) as e:
        meta.will_not_work_on_tpu(f"timezone: {e}")


def _tag_device_when_supported(meta) -> None:
    """An expression with a partial device kernel: the shapes it does not
    take run on the host row engine, with the JAX package's reason."""
    if not getattr(meta.expr, "device_supported", True):
        meta.will_not_work_on_tpu(
            f"{type(meta.expr).__name__} is a host-tier expression "
            "(runs via CPU fallback; no device kernel)")


def _tag_regex(meta) -> None:
    """Compile the pattern at tag time: a construct the automaton cannot
    run tags the expression off instead of raising mid-run (reference
    RegexParser.scala:687 transpile-or-fallback), with the compiler's
    message as the JAX package gives it."""
    from ..regex import RegexUnsupported
    try:
        meta.expr.program
    except RegexUnsupported as e:
        meta.will_not_work_on_tpu(str(e))


_AGG_RULES = None


def aggregate_window_rules() -> Dict[type, ExprRule]:
    """Aggregate and window functions as rules, in a table of their own as
    in the JAX package (neither is an Expression: their tagging runs at
    the LogicalAggregate and LogicalWindow nodes)."""
    global _AGG_RULES
    if _AGG_RULES is not None:
        return _AGG_RULES
    rules: Dict[type, ExprRule] = {}
    for c, d in ((aggexprs.Sum, "sum aggregate"),
                 (aggexprs.Count, "count aggregate"),
                 (aggexprs.Min, "min aggregate"),
                 (aggexprs.Max, "max aggregate"),
                 (aggexprs.First, "first aggregate"),
                 (aggexprs.Last, "last aggregate"),
                 (aggexprs.Average, "average aggregate"),
                 (aggexprs.StddevPop, "stddev_pop aggregate"),
                 (aggexprs.StddevSamp, "stddev_samp aggregate"),
                 (aggexprs.VariancePop, "var_pop aggregate"),
                 (aggexprs.VarianceSamp, "var_samp aggregate"),
                 (aggexprs.CollectList, "collect_list aggregate"),
                 (aggexprs.CollectSet, "collect_set aggregate"),
                 (aggexprs.Percentile, "percentile aggregate"),
                 (aggexprs.ApproxPercentile,
                  "approx_percentile aggregate (bounded sketch)")):
        _r(rules, c, d, commonly_supported, commonly_supported)
    win = windowexprs
    for c, d in ((win.RowNumber, "row_number window function"),
                 (win.Rank, "rank window function"),
                 (win.DenseRank, "dense_rank window function"),
                 (win.Lag, "lag window function"),
                 (win.Lead, "lead window function"),
                 (win.FirstValue, "first_value window function"),
                 (win.LastValue, "last_value window function"),
                 (win.WindowAgg, "aggregate over window frame")):
        _r(rules, c, d, commonly_supported, commonly_supported)
    _AGG_RULES = rules
    return rules


# ---------------------------------------------------------------------------
# plan metas
# ---------------------------------------------------------------------------

def extract_pushable_filters(condition: Expression, schema) -> List[tuple]:
    """Split a filter condition into (name, op, literal) conjuncts a scan
    can prune row groups with (the reference's predicate pushdown feeding
    GpuParquetScan). Non-extractable conjuncts simply don't push — the
    Filter stays above the scan either way."""
    out: List[tuple] = []

    def name_of(e) -> Optional[str]:
        if isinstance(e, (UnresolvedAttribute, BoundReference)) \
                and e.name in schema.names:
            return e.name
        return None

    def visit(e: Expression):
        if isinstance(e, predicates.And):
            visit(e.children[0])
            visit(e.children[1])
            return
        ops = {predicates.LessThan: "<", predicates.LessThanOrEqual: "<=",
               predicates.GreaterThan: ">",
               predicates.GreaterThanOrEqual: ">=",
               predicates.EqualTo: "=="}
        op = ops.get(type(e))
        if op is not None:
            l, r = e.children
            if name_of(l) is not None and isinstance(r, Literal) \
                    and r.value is not None:
                out.append((name_of(l), op, r.value))
            elif name_of(r) is not None and isinstance(l, Literal) \
                    and l.value is not None:
                flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                        "==": "=="}
                out.append((name_of(r), flip[op], l.value))
            return
        if isinstance(e, predicates.IsNull):
            n = name_of(e.children[0])
            if n is not None:
                out.append((n, "is_null", None))
        if isinstance(e, predicates.IsNotNull):
            n = name_of(e.children[0])
            if n is not None:
                out.append((n, "is_not_null", None))

    visit(condition)
    return out


def estimate_plan_size(plan: L.LogicalPlan) -> Optional[int]:
    """Best-effort bytes estimate for broadcast planning (the analog of
    Spark's logical-plan statistics feeding autoBroadcastJoinThreshold).
    None = unknown (never broadcast)."""
    if isinstance(plan, L.LogicalScan):
        est = getattr(plan.source, "estimated_size_bytes", None)
        return est() if callable(est) else None
    if isinstance(plan, L.LogicalRange):
        if plan.step > 0:
            n = max(0, (plan.end - plan.start + plan.step - 1) // plan.step)
        else:
            n = max(0, (plan.start - plan.end - plan.step - 1) // -plan.step)
        return n * 8
    if isinstance(plan, (L.LogicalProject, L.LogicalFilter, L.LogicalLimit,
                         L.LogicalSort)):
        # conservative: assume no reduction (Spark sizes filters the same
        # way without column stats)
        return estimate_plan_size(plan.children[0])
    if isinstance(plan, L.LogicalUnion):
        sizes = [estimate_plan_size(c) for c in plan.children]
        if any(s is None for s in sizes):
            return None
        return sum(sizes)
    if isinstance(plan, L.LogicalAggregate):
        if not plan.group_exprs:
            return 256  # grand aggregate: exactly one tiny row
        # keyed aggregates shrink to the key cardinality — unknown here
        return None
    return None


class PlanMeta(BaseMeta):
    def __init__(self, plan: L.LogicalPlan, conf: RapidsConf):
        super().__init__()
        self.plan = plan
        self.conf = conf
        self.host_fallback = False  # convert on the host row engine
        self.children = [PlanMeta(c, conf) for c in plan.children]
        self.expr_metas: List[ExprMeta] = [
            ExprMeta.wrap(e, conf, sch)
            for e, sch in self._expression_pairs()]

    def _expression_pairs(self):
        """(expression, input schema) pairs — the schema lets tagging bind
        column references so type checks see real types."""
        p = self.plan
        child_sch = p.children[0].schema if p.children else None
        if isinstance(p, L.LogicalProject):
            return [(e, child_sch) for e in p.exprs]
        if isinstance(p, L.LogicalFilter):
            return [(p.condition, child_sch)]
        if isinstance(p, L.LogicalAggregate):
            out = [(e, child_sch) for e in p.group_exprs]
            for fn, _ in p.aggregates:
                out.extend((e, child_sch) for e in fn.inputs)
            return out
        if isinstance(p, L.LogicalJoin):
            lsch = p.children[0].schema
            rsch = p.children[1].schema
            out = [(e, lsch) for e in p.left_keys]
            out += [(e, rsch) for e in p.right_keys]
            if p.condition is not None:
                out.append((p.condition, None))  # pair-scope, binds later
            return out
        if isinstance(p, L.LogicalGroupedMapInPandas):
            return [(k, child_sch) for k in p.keys]
        if isinstance(p, L.LogicalAggregateInPandas):
            return [(k, child_sch) for k in p.keys] + [
                (e, child_sch) for _, _, _, ins in p.aggs for e in ins]
        if isinstance(p, L.LogicalCoGroupedMapInPandas):
            return [(k, p.children[0].schema) for k in p.left_keys] + \
                [(k, p.children[1].schema) for k in p.right_keys]
        if isinstance(p, L.LogicalWindowInPandas):
            return [(e, child_sch) for e in p.part_exprs] + [
                (e, child_sch) for _, _, _, ins in p.wins for e in ins]
        if isinstance(p, L.LogicalExpand):
            return [(e, child_sch) for proj in p.projections for e in proj]
        if isinstance(p, L.LogicalSort):
            out = []
            for o in p.orders:
                e = o[0] if isinstance(o, tuple) else o
                if isinstance(e, Expression):
                    out.append((e, child_sch))
            return out
        if isinstance(p, L.LogicalGenerate):
            return [(p.generator, child_sch)]
        if isinstance(p, L.LogicalWindow):
            out = []
            for we, _ in p.window_exprs:
                out.extend((e, child_sch) for e in we.fn.inputs)
                out.extend((e, child_sch) for e in we.spec.partition_by)
                out.extend((o[0], child_sch) for o in we.spec.order_by)
            return out
        return []

    def tag_for_tpu(self):
        """Bottom-up tagging (reference RapidsMeta.tagForGpu:291)."""
        for c in self.children:
            c.tag_for_tpu()
            if not c.can_run_on_tpu:
                self.will_not_work_on_tpu("child plan cannot run on TPU")
        self._tag_unported()
        for em in self.expr_metas:
            em.tag_for_tpu()
        if any(not em.can_run_on_tpu for em in self.expr_metas):
            if self._can_host_fallback():
                # reference GpuOverrides.scala:4427 convertToCpu: the node
                # runs on the host row engine and the plan stays viable
                self.host_fallback = True
            else:
                for em in self.expr_metas:
                    if not em.can_run_on_tpu:
                        self.will_not_work_on_tpu(
                            f"expression {type(em.expr).__name__} "
                            "cannot run on TPU")
        name = self.plan.node_name()
        key = f"spark.rapids.sql.exec.{name}"
        if str(self.conf._settings.get(key, "true")).lower() == "false":
            # a disabled operator runs nowhere, the host included
            self.host_fallback = False
            self.will_not_work_on_tpu(f"operator {name} disabled by {key}")
        if not self.conf.get(SQL_ENABLED):
            self.will_not_work_on_tpu(
                "spark.rapids.sql.enabled is false")

    def _tag_unported(self) -> None:
        """Tag off the nodes whose operators the port lacks, naming the
        ROADMAP item that brings each."""
        p = self.plan
        if isinstance(p, L.LogicalWindow):
            rules = aggregate_window_rules()
            for we, _ in p.window_exprs:
                if type(we.fn) not in rules:
                    self.will_not_work_on_tpu(
                        f"window function {type(we.fn).__name__} has no "
                        "rule")
        elif isinstance(p, L.LogicalAggregate):
            rules = aggregate_window_rules()
            for fn, _ in p.aggregates:
                if type(fn) not in rules:
                    self.will_not_work_on_tpu(
                        f"aggregate {type(fn).__name__} has no rule")
                elif isinstance(fn, aggexprs.CollectSet) \
                        and self._non_fixed_width_input(fn, p):
                    # the dedup lanes exist for fixed-width values only
                    self.will_not_work_on_tpu(
                        "collect_set over a string needs string dedup "
                        "lanes (planned, as in the JAX package)")
                elif isinstance(fn, aggexprs.Average) \
                        and self._decimal_input(fn, p):
                    self.will_not_work_on_tpu(
                        "avg over a DECIMAL: the JAX package's evaluation "
                        "raises there (ROADMAP C.5), and the port adds no "
                        "decimal average it lacks")
        elif isinstance(p, L.LogicalJoin):
            # a join duplicates payload rows; the duplicating gather of an
            # array<string> has no child byte measurement (JAX package)
            for child in p.children:
                for f in child.schema.fields:
                    self._tag_join_payload(f.name, f.data_type)
            strategy = self._join_strategy(p)[0]
            if strategy.endswith("nested_loop") \
                    and p.join_type not in NESTED_LOOP_JOIN_TYPES:
                self.will_not_work_on_tpu(
                    f"a keyless {p.join_type} join: NestedLoopJoinExec "
                    f"joins {', '.join(NESTED_LOOP_JOIN_TYPES)}, as in the "
                    "JAX package")

    def _tag_join_payload(self, name: str, dt) -> None:
        """The JAX package's join payload tag-offs (a list of strings, a
        map), and the same inside a struct, whose string fields the port
        measures."""
        if isinstance(dt, ArrayType) and not dt.element_type.is_fixed_width:
            self.will_not_work_on_tpu(
                f"join payload column {name!r}: {dt.simple_name()} "
                "elements are not fixed-width (the duplicating gather lacks "
                "their byte measurement)")
        elif isinstance(dt, MapType):
            self.will_not_work_on_tpu(
                f"join payload column {name!r}: map payloads lack the "
                "join-side duplicating byte measurement")
        elif isinstance(dt, StructType):
            for f in dt.fields:
                self._tag_join_payload(f"{name}.{f.name}", f.data_type)

    @staticmethod
    def _non_fixed_width_input(fn, p: L.LogicalAggregate) -> bool:
        schema = p.children[0].schema
        try:
            return not resolve(fn.inputs[0], schema).data_type \
                .is_fixed_width
        except (KeyError, TypeError, IndexError):
            return False

    @staticmethod
    def _decimal_input(fn, p: L.LogicalAggregate) -> bool:
        schema = p.children[0].schema
        for e in fn.inputs:
            try:
                if isinstance(resolve(e, schema).data_type, DecimalType):
                    return True
            except (KeyError, TypeError):
                continue
        return False

    def _can_host_fallback(self) -> bool:
        """True when every expression of this node can run on the host row
        engine instead (reference convertToCpu; only Project and Filter
        have host operators, as in the JAX package)."""
        if not self.conf.get(CPU_FALLBACK_ENABLED):
            return False
        p = self.plan
        if isinstance(p, L.LogicalProject):
            exprs = list(p.exprs)
        elif isinstance(p, L.LogicalFilter):
            exprs = [p.condition]
        else:
            return False
        # bound first: the type checks (a decimal, a cast target) need the
        # column types
        child_schema = p.children[0].schema
        bound = []
        for e in exprs:
            try:
                bound.append(resolve(e, child_schema))
            except (KeyError, TypeError):
                bound.append(e)
        return all(supports_host_eval(e) for e in bound)

    def explain(self, indent: int = 0, lines: Optional[List[str]] = None
                ) -> str:
        """The reference's explain output (GpuOverrides.scala:4764); `~`
        marks a node on the host row engine."""
        lines = [] if lines is None else lines
        mark = "*" if self.can_run_on_tpu else "!"
        if self.host_fallback:
            mark = "~"
        lines.append("  " * indent + f"{mark} {self.plan.describe()}")
        if self.host_fallback:
            note = getattr(self, "cost_note", None) \
                or ("host row engine fallback: expression lacks a "
                    "device kernel")
            lines.append("  " * indent + f"    @ will run on CPU ({note})")
        for r in self._reasons:
            lines.append("  " * indent + f"    @ {r}")
        expr_reasons: List[str] = []
        for em in self.expr_metas:
            em.collect_reasons(expr_reasons)
        for r in expr_reasons:
            lines.append("  " * indent + f"    ! {r}")
        for c in self.children:
            c.explain(indent + 1, lines)
        return "\n".join(lines)

    # -- conversion --------------------------------------------------------
    def _plan_mesh(self):
        """The active mesh of more than one shard, or None when the plan
        stays single-partition (no mesh, a one-shard mesh, or
        tpu.shuffle.planExchange off)."""
        from ..parallel.mesh import active_mesh, mesh_axis_size
        mesh = active_mesh()
        if mesh is None or mesh_axis_size(mesh) <= 1:
            return None
        if not self.conf.get(SHUFFLE_PLAN_EXCHANGE):
            return None
        return mesh

    def _host_shuffle_partitions(self) -> int:
        """Partition count for the MULTITHREADED host shuffle, or 1 when
        host-shuffled planning is off (it is the no-mesh fallback: the
        always-works mode of the reference's shuffle manager)."""
        if self.conf.get(SHUFFLE_MODE).upper() != "MULTITHREADED":
            return 1
        return max(1, self.conf.get(SHUFFLE_PARTITIONS))

    @staticmethod
    def _range_sort_order(p: L.LogicalSort):
        """The first sort key as an order on the child's schema, or None
        when it is not a plain column (then a single-partition sort is
        planned, as in the JAX package)."""
        try:
            return resolve_sort_orders(p.orders, p.children[0].schema)[0]
        except (AssertionError, KeyError, TypeError, NotImplementedError):
            return None

    def _convert_split_aggregate(self, p, child: TpuExec,
                                 exchange_of) -> TpuExec:
        """partial → exchange_of(group keys, partial) → final: over the
        mesh's ShuffleExchangeExec (Spark's partial/final split over
        GpuShuffleExchangeExecBase), or the host shuffle's partition
        files (device memory bounded per partition; reference
        MULTITHREADED shuffle under partial/final agg)."""
        partial = AggregateExec(p.group_exprs, p.aggregates, child,
                                mode="partial")
        if any(isinstance(f.data_type, ArrayType)
               for f in partial.output_schema.fields):
            # list buffers (collect_*, the percentiles): the JAX package
            # keeps these aggregates single-partition
            return AggregateExec(p.group_exprs, p.aggregates, child)
        key_names = partial.output_schema.names[: len(p.group_exprs)]
        exchange = exchange_of([UnresolvedAttribute(n) for n in key_names],
                               partial)
        return AggregateExec(p.group_exprs, p.aggregates, exchange,
                             mode="final",
                             input_types=partial._input_types)

    def _convert_host_shuffled_join(self, p, left: TpuExec, right: TpuExec,
                                    n_parts: int) -> TpuExec:
        lex = HostShuffleExchangeExec(p.left_keys, left, n_parts, self.conf)
        rex = HostShuffleExchangeExec(p.right_keys, right, n_parts,
                                      self.conf)
        return ShuffledHashJoinExec(lex, rex, p.left_keys, p.right_keys,
                                    p.join_type, condition=p.condition)

    def _join_strategy(self, p: L.LogicalJoin):
        """The JAX package's join strategy (`_convert_join`), in its
        preference order: broadcast when a side's estimated size is under
        the threshold, else over a mesh the distributed join (both sides
        through ShuffleExchangeExec), else the host-shuffled hash join
        (without a mesh; partitions from
        shuffle.partitions, raised by the sub-partition split of a big
        build side), else the adaptive join when a size is unknown, else
        the single-partition hash join; keyless joins go to the
        nested-loop join, over a broadcast of the right side when it fits.
        Returns (kind, n_parts)."""
        thr = self.conf.get(BROADCAST_SIZE_THRESHOLD)
        # adaptive cap: an estimate past adaptive.autoBroadcastMaxBytes
        # must not plan a broadcast the runtime replanner would demote
        if thr >= 0 and self.conf.get(ADAPTIVE_ENABLED):
            cap = self.conf.get(ADAPTIVE_AUTO_BROADCAST_MAX_BYTES)
            if cap >= 0:
                thr = min(thr, cap)
        jt = p.join_type
        size_l = estimate_plan_size(p.children[0])
        size_r = estimate_plan_size(p.children[1])
        can_bcast_r = thr >= 0 and size_r is not None and size_r <= thr \
            and jt in ("inner", "left_outer", "left_semi", "left_anti",
                       "existence", "cross")
        can_bcast_l = thr >= 0 and size_l is not None and size_l <= thr \
            and jt in ("inner", "right_outer")
        if not p.left_keys:
            return ("broadcast_nested_loop" if can_bcast_r
                    else "nested_loop"), 1
        # prefer broadcasting the smaller eligible side
        if can_bcast_r and can_bcast_l and size_l < size_r:
            can_bcast_r = False
        if can_bcast_r:
            return "broadcast_right", 1
        if can_bcast_l:
            return "broadcast_left", 1
        mesh = self._plan_mesh()
        if mesh is not None and self._shuffle_keys_match(p):
            return "distributed", 1
        n_parts = self._host_shuffle_partitions()
        # sub-partitioned join (reference GpuSubPartitionHashJoin.scala
        # :547): a build side past the threshold splits into hash
        # sub-partitions, folded into the host-shuffle partition count
        thr_sub = self.conf.get(JOIN_SUBPARTITION_THRESHOLD)
        if mesh is None and thr_sub >= 0 and size_r is not None \
                and size_r > thr_sub \
                and self.conf.get(SHUFFLE_MODE).upper() == "MULTITHREADED":
            n_parts = max(n_parts, min(256, int(-(-size_r
                                                  // max(thr_sub, 1)))))
        if mesh is None and n_parts > 1 and self._shuffle_keys_match(p):
            return "shuffled", n_parts
        if thr >= 0 and (size_r is None or size_l is None):
            # unknown sizes: both sides measured at run time, the build
            # side chosen by the measured bytes (reference
            # GpuShuffledSymmetricHashJoinExec:354)
            return "adaptive", 1
        return "hash", 1

    @staticmethod
    def _shuffle_keys_match(p: L.LogicalJoin) -> bool:
        """Both sides' keys hash alike only when their types agree."""
        try:
            lb = bind_projection(p.left_keys, p.children[0].schema)
            rb = bind_projection(p.right_keys, p.children[1].schema)
        except (KeyError, TypeError):
            return False
        return all(l.data_type == r.data_type for l, r in zip(lb, rb))

    def _convert_join(self, p, kids) -> TpuExec:
        kind, n_parts = self._join_strategy(p)
        if kind == "broadcast_right":
            return HashJoinExec(kids[0], BroadcastExchangeExec(kids[1]),
                                p.left_keys, p.right_keys, p.join_type,
                                build_side="right", condition=p.condition)
        if kind == "broadcast_left":
            return HashJoinExec(BroadcastExchangeExec(kids[0]), kids[1],
                                p.left_keys, p.right_keys, p.join_type,
                                build_side="left", condition=p.condition)
        if kind == "shuffled":
            return self._convert_host_shuffled_join(p, kids[0], kids[1],
                                                    n_parts)
        if kind == "distributed":
            # both sides exchanged over the mesh, then a hash join per
            # shard (reference GpuShuffledHashJoinExec)
            mesh = self._plan_mesh()
            return ShuffledHashJoinExec(
                ShuffleExchangeExec(p.left_keys, kids[0], mesh, self.conf),
                ShuffleExchangeExec(p.right_keys, kids[1], mesh, self.conf),
                p.left_keys, p.right_keys, p.join_type,
                condition=p.condition)
        if kind == "hash":
            return HashJoinExec(kids[0], kids[1], p.left_keys, p.right_keys,
                                p.join_type, condition=p.condition)
        if kind == "adaptive":
            return AdaptiveJoinExec(kids[0], kids[1], p.left_keys,
                                    p.right_keys, p.join_type, p.condition,
                                    self.conf)
        if kind == "broadcast_nested_loop":
            return NestedLoopJoinExec(kids[0], BroadcastExchangeExec(kids[1]),
                                      p.join_type, p.condition)
        if kind == "nested_loop":
            return NestedLoopJoinExec(kids[0], kids[1], p.join_type,
                                      p.condition)
        raise PlanNotSupported(f"no conversion for a {kind} join")

    def _convert_host_node(self, p, child: TpuExec) -> TpuExec:
        """ColumnarToRow -> the host row operator -> RowToColumnar
        (reference transition insertion, GpuTransitionOverrides.scala:50)."""
        rows_in = ColumnarToRowExec(child)
        if isinstance(p, L.LogicalProject):
            host: TpuExec = HostProjectExec(p.exprs, rows_in)
        else:
            host = HostFilterExec(p.condition, rows_in)
        return RowToColumnarExec(host, host.output_schema)

    def convert(self) -> TpuExec:
        p = self.plan
        if isinstance(p, L.LogicalFilter) and not self.host_fallback \
                and isinstance(p.children[0], L.LogicalScan):
            # predicate pushdown: hand simple conjuncts to the source for
            # footer-stats row-group pruning; the Filter stays for
            # exactness (stats prove absence, never presence). A source
            # without `with_filters` (an in-memory one) is left alone.
            scan = p.children[0]
            src = scan.source
            if self.conf.get(PARQUET_PUSHDOWN_ENABLED) \
                    and hasattr(src, "with_filters"):
                pushed = extract_pushable_filters(p.condition, scan.schema)
                if pushed:
                    src = src.with_filters(pushed)
            scan_exec = CoalesceBatchesExec(
                SourceScanExec(src, scan.schema))
            return FilterExec(p.condition, scan_exec)
        kids = [c.convert() for c in self.children]
        if isinstance(p, L.LogicalScan):
            return CoalesceBatchesExec(SourceScanExec(p.source, p.schema))
        if isinstance(p, L.LogicalRange):
            return RangeExec(p.start, p.end, p.step, name=p.name,
                             device=p.device)
        if isinstance(p, (L.LogicalProject, L.LogicalFilter)) \
                and self.host_fallback:
            return self._convert_host_node(p, kids[0])
        if isinstance(p, L.LogicalProject):
            return ProjectExec(p.exprs, kids[0])
        if isinstance(p, L.LogicalFilter):
            return FilterExec(p.condition, kids[0])
        if isinstance(p, L.LogicalAggregate):
            mesh = self._plan_mesh()
            if mesh is not None and p.group_exprs:
                return self._convert_split_aggregate(
                    p, kids[0], lambda keys, partial: ShuffleExchangeExec(
                        keys, partial, mesh, self.conf))
            n_parts = self._host_shuffle_partitions()
            if n_parts > 1 and p.group_exprs:
                return self._convert_split_aggregate(
                    p, kids[0], lambda keys, partial: HostShuffleExchangeExec(
                        keys, partial, n_parts, self.conf))
            return AggregateExec(p.group_exprs, p.aggregates, kids[0])
        if isinstance(p, L.LogicalSort):
            if p.limit is None:
                n_parts = self._host_shuffle_partitions()
                first = self._range_sort_order(p)
                if n_parts > 1 and first is not None \
                        and self._plan_mesh() is None:
                    # distributed global sort: a range exchange on the
                    # first key (sampled bounds), then a sort per
                    # partition, streamed in partition order
                    exchange = HostShuffleExchangeExec(
                        [], kids[0], n_parts, self.conf,
                        partitioning="range",
                        range_order=(first.ordinal, first.ascending,
                                     first.nulls_first))
                    return PartitionWiseSortExec(p.orders, exchange)
                return SortExec(p.orders, kids[0])
            return TopNExec(p.limit, p.orders, kids[0], offset=p.offset)
        if isinstance(p, L.LogicalSample):
            return SampleExec(p.fraction, p.seed, kids[0])
        if isinstance(p, L.LogicalRepartition):
            return HostShuffleExchangeExec(
                [], kids[0], p.n_partitions, self.conf,
                partitioning=p.mode)
        if isinstance(p, L.LogicalJoin):
            return self._convert_join(p, kids)
        if isinstance(p, L.LogicalLimit):
            return GlobalLimitExec(p.limit, kids[0], offset=p.offset)
        if isinstance(p, L.LogicalUnion):
            return UnionExec(*kids)
        if isinstance(p, L.LogicalExpand):
            return ExpandExec(p.projections, kids[0])
        if isinstance(p, L.LogicalWindow):
            return WindowExec(p.window_exprs, kids[0])
        if isinstance(p, L.LogicalGenerate):
            return GenerateExec(p.generator, kids[0], p.outer, p.position,
                                p.elem_name, p.pos_name)
        if isinstance(p, L.LogicalGroupedMapInPandas):
            from ..exec.python_udf import GroupedMapInPandasExec
            return GroupedMapInPandasExec(p.keys, p.fn, p.out_schema,
                                          kids[0])
        if isinstance(p, L.LogicalAggregateInPandas):
            from ..exec.python_udf import AggregateInPandasExec
            return AggregateInPandasExec(p.keys, p.aggs, p.key_names,
                                         kids[0])
        if isinstance(p, L.LogicalMapInBatch):
            from ..exec.python_udf import MapInBatchExec
            return MapInBatchExec(p.fn, p.out_schema, kids[0])
        if isinstance(p, L.LogicalCoGroupedMapInPandas):
            from ..exec.python_udf import CoGroupedMapInPandasExec
            return CoGroupedMapInPandasExec(p.left_keys, p.right_keys,
                                            p.fn, p.out_schema, kids[0],
                                            kids[1])
        if isinstance(p, L.LogicalWindowInPandas):
            from ..exec.python_udf import WindowInPandasExec
            return WindowInPandasExec(p.part_exprs, p.wins, kids[0])
        raise PlanNotSupported(f"no conversion for {type(p).__name__}")


class TpuOverrides:
    """Entry point (reference `case class GpuOverrides` apply :4624)."""

    def __init__(self, conf: Optional[RapidsConf] = None):
        self.conf = conf or active_conf()

    def wrap_and_tag(self, plan: L.LogicalPlan) -> PlanMeta:
        meta = PlanMeta(plan, self.conf)
        meta.tag_for_tpu()
        if self.conf.get(OPTIMIZER_ENABLED):
            from .cost import CostBasedOptimizer
            CostBasedOptimizer(self.conf).optimize(meta)
        self._emit_plan_decisions(meta)
        return meta

    @staticmethod
    def _emit_plan_decisions(meta: "PlanMeta") -> None:
        """Plan-time why-not records (the reference's "will not run on
        GPU because ..." explain lines) as events: one `plan_fallback`
        per host-row-engine node, one `plan_not_on_tpu` per tag-off
        reason. One pointer check when logging is off."""
        from ..obs import events as obs_events
        if obs_events.active_bus() is None:
            return

        def walk(m: "PlanMeta"):
            node = m.plan.node_name()
            if m.host_fallback:
                reasons: List[str] = []
                for em in m.expr_metas:
                    em.collect_reasons(reasons)
                obs_events.emit("plan_fallback", node=node,
                                reasons=reasons)
            for r in m.reasons:
                obs_events.emit("plan_not_on_tpu", node=node, reason=r)
            for c in m.children:
                walk(c)

        walk(meta)

    def apply(self, plan: L.LogicalPlan) -> TpuExec:
        from ..udf_compiler import maybe_compile_plan_udfs
        plan = maybe_compile_plan_udfs(plan, self.conf)
        meta = self.wrap_and_tag(plan)
        if not self._all_ok(meta):
            raise PlanNotSupported(meta.explain())
        # the execs read their confs at construction, from the active one
        set_active_conf(self.conf)
        try:
            tree = meta.convert()
        except NotImplementedError as e:
            # an operator's own limit (a key type its join lacks): the
            # same report, with the operator's reason
            raise PlanNotSupported(f"{meta.explain()}\n    @ {e}") from e
        # whole-stage compilation: whitelisted chains become
        # CompiledStageExec nodes (one CUDA graph per stage step on the
        # card); a no-op with stage.fusion off
        from ..exec.stage_compiler import compile_stages
        return compile_stages(tree, self.conf)

    def explain(self, plan: L.LogicalPlan) -> str:
        return self.wrap_and_tag(plan).explain()

    @staticmethod
    def _all_ok(meta: PlanMeta) -> bool:
        if not meta.can_run_on_tpu:
            return False
        return all(TpuOverrides._all_ok(c) for c in meta.children)
