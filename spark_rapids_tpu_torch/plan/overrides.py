"""Override rule tables and plan conversion — the counterpart of
spark_rapids_tpu/plan/overrides.py (the reference's GpuOverrides.scala:
rule tables :919/:3838, wrapAndTagPlan :4421, doConvertPlan :4427; and
GpuTransitionOverrides' coalesce insertion :322).

As in the JAX package, the engine has no host engine underneath: a node
that cannot run on the card makes `apply` raise PlanNotSupported with the
whole explain report. The rules cover what the port has: the expressions
of expr/{core,arithmetic,predicates,conditional,cast,math,bitwise,
datetimeexprs,aggexprs} and `stringexprs.FormatNumber`, and the scan,
project, filter, range, union, limit, expand, sample, aggregate
(single-stage, or partial -> host exchange -> final), hash join of every
join type (broadcast, host-shuffled or single-partition), nested-loop
join of a keyless join (over a broadcast when the right side fits),
sort (over a range exchange and PartitionWiseSortExec when the host
shuffle has partitions), TopN and repartition operators. Each node or
branch whose operator is not ported yet is tagged off during tagging,
with a reason naming its ROADMAP item, so nothing raises mid-run:

- the adaptive join the JAX package plans when a side's size is unknown
  (AdaptiveJoinExec): A.3 and A.9;
- aggregate functions the port lacks: A.2; an average over a DECIMAL,
  whose evaluation raises in the JAX package (C.5);
- a node the JAX package would run on its host row engine
  (`_can_host_fallback`), the cost-based placement and the UDF compiler:
  A.8 wave 4 (their confs raise in config.RapidsConf). The expressions
  the JAX package tags off its device (decimal128 multiply and divide,
  casts without a kernel, unknown time zones, format_number of a
  DECIMAL) are tagged off with its reasons;
- a string comparison the port cannot run: its string predicates run in
  code space only, as equality or IN of a dictionary-encoded column
  against literals (A.8 wave 2 brings comparisons of decoded strings).
  The planner follows which string columns reach each node encoded
  (`encoded_out`: a source's `encoded_columns()`, through the filters,
  projections and joins that keep them encoded; an aggregate, sort or
  exchange decodes them, and an aggregate whose keys and buffers are
  fixed-width reads its absorbed filter and projection over decoded
  columns).

Also waiting for their items: the mesh (`_plan_mesh` and the
distributed aggregate and join over it, A.6: with no mesh the JAX
package plans the same host lane as the port), the plan-decision events
(`_emit_plan_decisions`, A.9), and the stage compiler (`compile_stages`), whose counterpart on the
card is a CUDA graph per stage (A.1.4): `apply` returns the converted
tree as it is.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Type

from ..config import (ADAPTIVE_AUTO_BROADCAST_MAX_BYTES, ADAPTIVE_ENABLED,
                      BROADCAST_SIZE_THRESHOLD, CPU_FALLBACK_ENABLED,
                      JOIN_SUBPARTITION_THRESHOLD, PARQUET_PUSHDOWN_ENABLED,
                      SHUFFLE_MODE, SHUFFLE_PARTITIONS, SQL_ENABLED,
                      RapidsConf, active_conf, set_active_conf)
from ..exec.aggregate import AggregateExec
from ..exec.base import TpuExec
from ..exec.basic import (ExpandExec, FilterExec, GlobalLimitExec,
                          ProjectExec, RangeExec, SampleExec, SourceScanExec,
                          UnionExec, bind_projection)
from ..exec.coalesce import CoalesceBatchesExec
from ..exec.exchange import (BroadcastExchangeExec, HostShuffleExchangeExec,
                             ShuffledHashJoinExec)
from ..exec.joins import (NESTED_LOOP_JOIN_TYPES, HashJoinExec,
                          NestedLoopJoinExec)
from ..exec.sort import (PartitionWiseSortExec, SortExec, TopNExec,
                         resolve_sort_orders)
from ..expr import (aggexprs, arithmetic, bitwise, cast, conditional,
                    datetimeexprs, predicates, stringexprs)
from ..expr import math as emath
from ..expr.core import (
    Alias, BoundReference, Expression, Literal, UnresolvedAttribute,
    output_name, resolve,
)
from ..types import BinaryType, DecimalType, Schema, StringType
from . import logical as L
from .meta import BaseMeta, ExprMeta, ExprRule
from .typesig import (
    BOOLEAN, TypeSig, all_types, commonly_supported, comparable, fp,
    integral, numeric, numeric_and_decimal, orderable, stringlike,
)

#: the reasons of nodes that are not ported, by ROADMAP item
JOINS = "waits for ROADMAP A.3 and A.9"
HOST_TIER = "waits for ROADMAP A.8 wave 4"
STRINGS = "waits for ROADMAP A.8 wave 2"


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
    _r(rules, stringexprs.FormatNumber,
       "format_number (device digit emission; decimal inputs host tier)",
       numeric, stringlike, tag_fn=_tag_device_when_supported)
    _EXPR_RULES = rules
    return rules


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
    """The cast pairs without a device kernel (the JAX package runs some
    on its host row tier, ROADMAP A.8 wave 4), tagged off at plan time."""
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
    take run on the JAX package's host row tier (ROADMAP A.8 wave 4)."""
    if not getattr(meta.expr, "device_supported", True):
        meta.will_not_work_on_tpu(
            f"{type(meta.expr).__name__} is a host-tier expression "
            "(runs via CPU fallback; no device kernel)")


_AGG_RULES = None


def aggregate_window_rules() -> Dict[type, ExprRule]:
    """Aggregate functions as rules, in a table of their own as in the
    JAX package (AggregateFunction is not an Expression: its tagging runs
    at the LogicalAggregate node). The window functions come with A.8
    wave 3."""
    global _AGG_RULES
    if _AGG_RULES is not None:
        return _AGG_RULES
    rules: Dict[type, ExprRule] = {}
    for c, d in ((aggexprs.Sum, "sum aggregate"),
                 (aggexprs.Count, "count aggregate"),
                 (aggexprs.Min, "min aggregate"),
                 (aggexprs.Max, "max aggregate"),
                 (aggexprs.Average, "average aggregate")):
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


def _string_typed(e: Expression) -> bool:
    try:
        return isinstance(e.data_type, (StringType, BinaryType))
    except TypeError:
        return False


def _bare_name(e: Expression) -> Optional[str]:
    while isinstance(e, Alias):
        e = e.children[0]
    if isinstance(e, (BoundReference, UnresolvedAttribute)):
        return e.name
    return None


def code_space_ok(e: Expression, encoded) -> bool:
    """True when every string comparison in the bound expression `e` has
    a code-space lane over the columns named in `encoded`: equality of a
    bare encoded reference with a literal, or its IN list."""
    if isinstance(e, (predicates.BinaryComparison, predicates.In)) \
            and any(_string_typed(c) for c in e.children):
        kids = e.children
        ref = None
        if isinstance(e, predicates.In):
            ref = kids[0]
        elif type(e) is predicates.EqualTo:
            if isinstance(kids[1], Literal):
                ref = kids[0]
            elif isinstance(kids[0], Literal):
                ref = kids[1]
        return ref is not None and _bare_name(ref) in encoded
    return all(code_space_ok(c, encoded) for c in e.children)


def _strings_ok(e: Expression, schema, encoded) -> bool:
    try:
        bound = resolve(e, schema)
    except (KeyError, TypeError):
        return True  # unresolvable: the expression tags say so
    return code_space_ok(bound, encoded)


def _pair_schema(p: L.LogicalJoin) -> Schema:
    """The schema a join's condition binds to: left columns, then right."""
    return Schema(tuple(p.children[0].schema.fields)
                  + tuple(p.children[1].schema.fields))


class PlanMeta(BaseMeta):
    def __init__(self, plan: L.LogicalPlan, conf: RapidsConf):
        super().__init__()
        self.plan = plan
        self.conf = conf
        self.children = [PlanMeta(c, conf) for c in plan.children]
        self.expr_metas: List[ExprMeta] = [
            ExprMeta.wrap(e, conf, sch)
            for e, sch in self._expression_pairs()]
        self._encoded = None

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
        if isinstance(p, L.LogicalExpand):
            return [(e, child_sch) for proj in p.projections for e in proj]
        if isinstance(p, L.LogicalSort):
            out = []
            for o in p.orders:
                e = o[0] if isinstance(o, tuple) else o
                if isinstance(e, Expression):
                    out.append((e, child_sch))
            return out
        return []

    def tag_for_tpu(self):
        """Bottom-up tagging (reference RapidsMeta.tagForGpu:291)."""
        for c in self.children:
            c.tag_for_tpu()
            if not c.can_run_on_tpu:
                self.will_not_work_on_tpu("child plan cannot run on TPU")
        self._tag_unported()
        self._tag_strings()
        for em in self.expr_metas:
            em.tag_for_tpu()
        if any(not em.can_run_on_tpu for em in self.expr_metas):
            if self._can_host_fallback():
                self.will_not_work_on_tpu(
                    "the JAX package runs this node on its host row "
                    f"engine, which {HOST_TIER}")
            else:
                for em in self.expr_metas:
                    if not em.can_run_on_tpu:
                        self.will_not_work_on_tpu(
                            f"expression {type(em.expr).__name__} "
                            "cannot run on TPU")
        name = self.plan.node_name()
        key = f"spark.rapids.sql.exec.{name}"
        if str(self.conf._settings.get(key, "true")).lower() == "false":
            self.will_not_work_on_tpu(f"operator {name} disabled by {key}")
        if not self.conf.get(SQL_ENABLED):
            self.will_not_work_on_tpu(
                "spark.rapids.sql.enabled is false")

    def _tag_unported(self) -> None:
        """Tag off the nodes whose operators the port lacks, naming the
        ROADMAP item that brings each."""
        p = self.plan
        if isinstance(p, L.LogicalAggregate):
            rules = aggregate_window_rules()
            for fn, _ in p.aggregates:
                if type(fn) not in rules:
                    self.will_not_work_on_tpu(
                        f"aggregate {type(fn).__name__} waits for ROADMAP "
                        "A.2")
                elif isinstance(fn, aggexprs.Average) \
                        and self._decimal_input(fn, p):
                    self.will_not_work_on_tpu(
                        "avg over a DECIMAL: the JAX package's evaluation "
                        "raises there (ROADMAP C.5), and the port adds no "
                        "decimal average it lacks")
        elif isinstance(p, L.LogicalJoin):
            strategy = self._join_strategy(p)[0]
            if strategy.endswith("nested_loop") \
                    and p.join_type not in NESTED_LOOP_JOIN_TYPES:
                self.will_not_work_on_tpu(
                    f"a keyless {p.join_type} join: NestedLoopJoinExec "
                    f"joins {', '.join(NESTED_LOOP_JOIN_TYPES)}, as in the "
                    "JAX package")
            elif strategy == "adaptive":
                self.will_not_work_on_tpu(
                    "a join with a side of unknown size (AdaptiveJoinExec) "
                    f"{JOINS}")

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

    def encoded_out(self) -> frozenset:
        """The string columns that leave this node dictionary-encoded
        (when its parent takes encoded input)."""
        if self._encoded is None:
            self._encoded = frozenset(self._encoded_out())
        return self._encoded

    def _encoded_out(self):
        p = self.plan
        if isinstance(p, L.LogicalScan):
            cols = getattr(p.source, "encoded_columns", None)
            return cols() if callable(cols) else ()
        if isinstance(p, (L.LogicalFilter, L.LogicalProject)):
            enc = self.children[0].encoded_out()
            exprs = [p.condition] if isinstance(p, L.LogicalFilter) \
                else p.exprs
            if not all(_strings_ok(e, p.children[0].schema, enc)
                       for e in exprs):
                return ()
            if isinstance(p, L.LogicalFilter):
                return enc
            return [output_name(e, f"col{i}") for i, e in enumerate(exprs)
                    if _bare_name(e) in enc]
        if isinstance(p, L.LogicalJoin) and self._join_strategy(p)[0] in (
                "broadcast_right", "broadcast_left", "hash"):
            enc = self.children[0].encoded_out() \
                | self.children[1].encoded_out()
            if p.condition is None \
                    or _strings_ok(p.condition, _pair_schema(p), enc):
                if p.join_type in ("left_semi", "left_anti", "existence"):
                    return self.children[0].encoded_out()
                return enc
        if isinstance(p, L.LogicalUnion):
            return frozenset.intersection(*(c.encoded_out()
                                            for c in self.children))
        if isinstance(p, L.LogicalLimit):
            return self.children[0].encoded_out()
        return ()

    def _tag_strings(self) -> None:
        """Tag off a string comparison that would meet decoded strings."""
        p = self.plan
        checks = []  # (expression, schema, encoded columns)
        if isinstance(p, L.LogicalFilter):
            checks.append((p.condition, p.children[0].schema,
                           self.children[0].encoded_out()))
        elif isinstance(p, L.LogicalProject):
            checks += [(e, p.children[0].schema,
                        self.children[0].encoded_out()) for e in p.exprs]
        elif isinstance(p, L.LogicalJoin) and p.condition is not None:
            enc = self.children[0].encoded_out() \
                | self.children[1].encoded_out() \
                if self._join_strategy(p)[0] in (
                    "broadcast_right", "broadcast_left", "hash") \
                else frozenset()
            checks.append((p.condition, _pair_schema(p), enc))
        elif isinstance(p, L.LogicalExpand):
            checks += [(e, p.children[0].schema, frozenset())
                       for proj in p.projections for e in proj]
        elif isinstance(p, L.LogicalAggregate):
            child = p.children[0]
            checks += [(e, child.schema, frozenset()) for e in
                       p.group_exprs + [e for fn, _ in p.aggregates
                                        for e in fn.inputs]]
            # fixed-width keys and buffers: the aggregate absorbs the
            # filter/project chain below it and reads its source decoded
            if all(f.data_type.is_fixed_width for f in p.schema.fields):
                while isinstance(child, (L.LogicalFilter, L.LogicalProject)):
                    exprs = [child.condition] \
                        if isinstance(child, L.LogicalFilter) else child.exprs
                    checks += [(e, child.children[0].schema, frozenset())
                               for e in exprs]
                    child = child.children[0]
        for e, schema, enc in checks:
            if not _strings_ok(e, schema, enc):
                self.will_not_work_on_tpu(
                    f"a comparison of decoded strings in {e!r} {STRINGS} "
                    "(the port compares strings as dictionary codes "
                    "only)")

    def _can_host_fallback(self) -> bool:
        """True where the JAX package would run this node on its host row
        engine (only Project/Filter have host operators there)."""
        return bool(self.conf.get(CPU_FALLBACK_ENABLED)) and isinstance(
            self.plan, (L.LogicalProject, L.LogicalFilter))

    def explain(self, indent: int = 0, lines: Optional[List[str]] = None
                ) -> str:
        """The reference's explain output (GpuOverrides.scala:4764)."""
        lines = [] if lines is None else lines
        mark = "*" if self.can_run_on_tpu else "!"
        lines.append("  " * indent + f"{mark} {self.plan.describe()}")
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

    def _convert_host_shuffled_aggregate(self, p, child: TpuExec,
                                         n_parts: int) -> TpuExec:
        """partial → host shuffle exchange → final over partition files
        (device memory bounded per partition; reference MULTITHREADED
        shuffle under partial/final agg)."""
        partial = AggregateExec(p.group_exprs, p.aggregates, child,
                                mode="partial")
        key_names = partial.output_schema.names[: len(p.group_exprs)]
        part_keys = [UnresolvedAttribute(n) for n in key_names]
        exchange = HostShuffleExchangeExec(part_keys, partial, n_parts,
                                           self.conf)
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
        the threshold, else the host-shuffled hash join (partitions from
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
        n_parts = self._host_shuffle_partitions()
        # sub-partitioned join (reference GpuSubPartitionHashJoin.scala
        # :547): a build side past the threshold splits into hash
        # sub-partitions, folded into the host-shuffle partition count
        thr_sub = self.conf.get(JOIN_SUBPARTITION_THRESHOLD)
        if thr_sub >= 0 and size_r is not None and size_r > thr_sub \
                and self.conf.get(SHUFFLE_MODE).upper() == "MULTITHREADED":
            n_parts = max(n_parts, min(256, int(-(-size_r
                                                  // max(thr_sub, 1)))))
        if n_parts > 1 and self._shuffle_keys_match(p):
            return "shuffled", n_parts
        if thr >= 0 and (size_r is None or size_l is None):
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
        if kind == "hash":
            return HashJoinExec(kids[0], kids[1], p.left_keys, p.right_keys,
                                p.join_type, condition=p.condition)
        if kind == "broadcast_nested_loop":
            return NestedLoopJoinExec(kids[0], BroadcastExchangeExec(kids[1]),
                                      p.join_type, p.condition)
        if kind == "nested_loop":
            return NestedLoopJoinExec(kids[0], kids[1], p.join_type,
                                      p.condition)
        raise PlanNotSupported(f"no conversion for a {kind} join")

    def convert(self) -> TpuExec:
        p = self.plan
        if isinstance(p, L.LogicalFilter) \
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
        if isinstance(p, L.LogicalProject):
            return ProjectExec(p.exprs, kids[0])
        if isinstance(p, L.LogicalFilter):
            return FilterExec(p.condition, kids[0])
        if isinstance(p, L.LogicalAggregate):
            n_parts = self._host_shuffle_partitions()
            if n_parts > 1 and p.group_exprs:
                return self._convert_host_shuffled_aggregate(
                    p, kids[0], n_parts)
            return AggregateExec(p.group_exprs, p.aggregates, kids[0])
        if isinstance(p, L.LogicalSort):
            if p.limit is None:
                n_parts = self._host_shuffle_partitions()
                first = self._range_sort_order(p)
                if n_parts > 1 and first is not None:
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
        raise PlanNotSupported(f"no conversion for {type(p).__name__}")


class TpuOverrides:
    """Entry point (reference `case class GpuOverrides` apply :4624)."""

    def __init__(self, conf: Optional[RapidsConf] = None):
        self.conf = conf or active_conf()

    def wrap_and_tag(self, plan: L.LogicalPlan) -> PlanMeta:
        meta = PlanMeta(plan, self.conf)
        meta.tag_for_tpu()
        return meta

    def apply(self, plan: L.LogicalPlan) -> TpuExec:
        meta = self.wrap_and_tag(plan)
        if not self._all_ok(meta):
            raise PlanNotSupported(meta.explain())
        # the execs read their confs at construction, from the active one
        set_active_conf(self.conf)
        try:
            return meta.convert()
        except NotImplementedError as e:
            # an operator's own limit (a key type its join lacks): the
            # same report, with the operator's reason
            raise PlanNotSupported(f"{meta.explain()}\n    @ {e}") from e

    def explain(self, plan: L.LogicalPlan) -> str:
        return self.wrap_and_tag(plan).explain()

    @staticmethod
    def _all_ok(meta: PlanMeta) -> bool:
        if not meta.can_run_on_tpu:
            return False
        return all(TpuOverrides._all_ok(c) for c in meta.children)
