"""Declarative aggregate functions — the counterpart of
spark_rapids_tpu/expr/aggexprs.py: Sum, Count, Min, Max, First, Last,
Average, the central moments (VarianceSamp, VariancePop, StddevSamp,
StddevPop), CollectList, CollectSet, Percentile and ApproxPercentile.
Each function declares its buffer ops for the group-by (ops/maskedagg.py,
ops/fused_scan_agg.py, ops/aggregate.py) and a final `evaluate`; list
buffers (collect_*, the percentiles) take the sort path.

Spark semantics:
  * sum(int*) -> long, sum(float|double) -> double; all-null group -> null
  * sum(decimal(p, s)) -> decimal(min(p + 10, 38), s), summed exactly in
    a two-limb buffer; past the result precision -> null (CheckOverflow)
  * count(x) counts non-null, count(*) counts rows; never null
  * avg -> double, from (sum, count) buffers; null when the count is 0;
    avg over a DECIMAL is tagged off at plan time (the JAX package's
    raises, ROADMAP C.5)
  * min/max ignore nulls; null for all-null groups
  * first/last: the group's first/last row in the input's order (the
    batch order, partials merged in partition order), skipping nulls
    with ignore_nulls; null for a group without one
  * var_samp, var_pop, stddev_samp, stddev_pop -> double, from (count,
    sum, sum_sq) buffers with the JAX package's formula: m2 = sum_sq -
    n * mean^2 clamped at 0; NaN for n == 1 in the sample forms; null
    for an empty group
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar.column import Column
from ..types import (DataType, DecimalType, DoubleType, FloatType,
                     LongType)
from .core import Expression


class AggregateFunction:
    """Base: subclasses define inputs, buffer ops and final evaluation."""

    inputs: Tuple[Expression, ...] = ()
    name = "agg"

    def __init__(self, *inputs: Expression):
        self.inputs = tuple(inputs)

    @property
    def child(self) -> Expression:
        return self.inputs[0]

    def update_ops(self) -> List[Tuple[str, Optional[int]]]:
        """[(kernel op, input index or None for count_star)] — one per buffer."""
        raise NotImplementedError

    def merge_ops(self) -> List[str]:
        """Kernel op per buffer when re-aggregating partial buffers."""
        raise NotImplementedError

    def buffer_types(self, input_types: Sequence[DataType]) -> List[DataType]:
        raise NotImplementedError

    def result_type(self, input_types: Sequence[DataType]) -> DataType:
        raise NotImplementedError

    def result_type_from_buffer(self, buffer_types: Sequence[DataType]
                                ) -> DataType:
        """The result type in final mode when only the buffer types are
        known: the buffer types taken as the input types, which every
        aggregate here maps to the same result."""
        return self.result_type(buffer_types)

    def evaluate(self, buffers: List[Column],
                 input_types: Sequence[DataType]) -> Column:
        """Final projection from merged buffer columns to the result."""
        raise NotImplementedError

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.inputs))})"


def _sum_buffer_type(dt: DataType) -> DataType:
    if isinstance(dt, (DoubleType, FloatType)):
        return DoubleType()
    if isinstance(dt, DecimalType):
        # always two limbs (precision > 18): a one-limb partial could
        # overflow int64 across merges, and a nulled partial would be
        # skipped by the next merge; overflow surfaces only at evaluate
        return DecimalType(min(max(dt.precision + 10, 19), 38), dt.scale)
    return LongType()


def _sum_result_type(dt: DataType) -> DataType:
    if isinstance(dt, DecimalType):
        return DecimalType(min(dt.precision + 10, 38), dt.scale)
    return _sum_buffer_type(dt)


class Sum(AggregateFunction):
    name = "sum"

    def update_ops(self):
        return [("sum", 0)]

    def merge_ops(self):
        return ["sum"]

    def buffer_types(self, input_types):
        return [_sum_buffer_type(input_types[0])]

    def result_type(self, input_types):
        return _sum_result_type(input_types[0])

    def result_type_from_buffer(self, buffer_types):
        # final mode cannot recover the input precision from the
        # two-limb decimal buffer: the buffer type is the result type
        return buffer_types[0]

    def evaluate(self, buffers, input_types):
        b = buffers[0]
        if not isinstance(b.dtype, DecimalType):
            return b
        # Spark CheckOverflow: a sum past the RESULT precision is NULL;
        # a result of at most 18 digits folds to one limb
        from ..columnar.column import Decimal128Column
        from ..ops import decimal128 as D
        in_t = input_types[0] if input_types else b.dtype
        rt = b.dtype if in_t == b.dtype else _sum_result_type(in_t)
        if isinstance(b, Decimal128Column):
            hi, lo = b.hi.data, b.lo.data
        else:
            hi, lo = D.from_i64(b.data)
        v = b.validity & D.fits_precision(hi, lo, rt.precision)
        zero = torch.zeros((), dtype=torch.int64, device=hi.device)
        if rt.precision > 18:
            return Decimal128Column.from_limbs(
                torch.where(v, hi, zero), torch.where(v, lo, zero), v, rt)
        return Column(torch.where(v, lo, zero), v, rt)


class Count(AggregateFunction):
    """count(expr); Count() with no input is count(*)."""
    name = "count"

    def update_ops(self):
        return [("count", 0) if self.inputs else ("count_star", None)]

    def merge_ops(self):
        return ["sum"]

    def buffer_types(self, input_types):
        return [LongType()]

    def result_type(self, input_types):
        return LongType()

    def evaluate(self, buffers, input_types):
        b = buffers[0]
        # count is never null: all-null/empty groups are 0
        data = torch.where(b.validity, b.data, torch.zeros_like(b.data))
        return Column(data, torch.ones_like(b.validity), LongType())


class Min(AggregateFunction):
    name = "min"

    def update_ops(self):
        return [("min", 0)]

    def merge_ops(self):
        return ["min"]

    def buffer_types(self, input_types):
        return [input_types[0]]

    def result_type(self, input_types):
        return input_types[0]

    def evaluate(self, buffers, input_types):
        return buffers[0]


class Max(Min):
    name = "max"

    def update_ops(self):
        return [("max", 0)]

    def merge_ops(self):
        return ["max"]


class First(AggregateFunction):
    """first(expr[, ignoreNulls]): Spark's default ignoreNulls=False takes
    the first row's value even when null; deterministic only over an
    ordered input."""
    name = "first"
    _OPS = ("first", "first_any")

    def __init__(self, *inputs, ignore_nulls: bool = False):
        super().__init__(*inputs)
        self.ignore_nulls = ignore_nulls

    def _op(self) -> str:
        return self._OPS[0] if self.ignore_nulls else self._OPS[1]

    def update_ops(self):
        return [(self._op(), 0)]

    def merge_ops(self):
        return [self._op()]

    def buffer_types(self, input_types):
        return [input_types[0]]

    def result_type(self, input_types):
        return input_types[0]

    def evaluate(self, buffers, input_types):
        return buffers[0]


class Last(First):
    name = "last"
    _OPS = ("last", "last_any")


class Average(AggregateFunction):
    name = "avg"

    def update_ops(self):
        return [("sum", 0), ("count", 0)]

    def merge_ops(self):
        return ["sum", "sum"]

    def buffer_types(self, input_types):
        return [DoubleType(), LongType()]

    def result_type(self, input_types):
        return DoubleType()

    def evaluate(self, buffers, input_types):
        s, c = buffers
        cnt = torch.where(c.validity, c.data, torch.zeros_like(c.data))
        ok = (cnt > 0) & s.validity
        denom = torch.where(cnt > 0, cnt, torch.ones_like(cnt))
        data = s.data.to(torch.float64) / denom.to(torch.float64)
        return Column(torch.where(ok, data, torch.zeros_like(data)), ok,
                      DoubleType())


class _CentralMoment(AggregateFunction):
    """The (count, sum, sum_sq) buffers of variance and stddev, and the JAX
    package's one-pass formula (not Welford's: the last bits follow the
    reference)."""

    sample = True
    sqrt = False

    def update_ops(self):
        return [("count", 0), ("sum", 0), ("sum_sq", 0)]

    def merge_ops(self):
        return ["sum", "sum", "sum"]

    def buffer_types(self, input_types):
        return [LongType(), DoubleType(), DoubleType()]

    def result_type(self, input_types):
        return DoubleType()

    def evaluate(self, buffers, input_types):
        c, s, sq = buffers
        n = torch.where(c.validity, c.data, torch.zeros_like(c.data)) \
            .to(torch.float64)
        has = n > 0
        safe_n = torch.where(has, n, torch.ones_like(n))
        mean = s.data.to(torch.float64) / safe_n
        m2 = sq.data.to(torch.float64) - n * mean * mean
        m2 = torch.clamp(m2, min=0.0)  # catastrophic cancellation
        if self.sample:
            denom = n - 1.0
            var = torch.where(denom > 0,
                              m2 / torch.where(denom > 0, denom,
                                               torch.ones_like(denom)),
                              torch.full_like(m2, float("nan")))  # n == 1
        else:
            var = m2 / safe_n
        out = torch.sqrt(var) if self.sqrt else var
        return Column(torch.where(has, out, torch.zeros_like(out)), has,
                      DoubleType())


class VarianceSamp(_CentralMoment):
    name = "var_samp"
    sample = True


class VariancePop(_CentralMoment):
    name = "var_pop"
    sample = False


class StddevSamp(_CentralMoment):
    name = "stddev_samp"
    sample, sqrt = True, True


class StddevPop(_CentralMoment):
    name = "stddev_pop"
    sample, sqrt = False, True


class CollectList(AggregateFunction):
    """collect_list(expr): the group's values as an array, nulls dropped
    (reference GpuCollectList)."""
    name = "collect_list"
    _UPDATE = "collect"

    def update_ops(self):
        return [(self._UPDATE, 0)]

    def merge_ops(self):
        return ["collect_merge"]

    def buffer_types(self, input_types):
        from ..types import ArrayType
        return [ArrayType(input_types[0])]

    def result_type(self, input_types):
        from ..types import ArrayType
        return ArrayType(input_types[0])

    def result_type_from_buffer(self, buffer_types):
        # final mode: the buffer already is the list type
        return buffer_types[0]

    def evaluate(self, buffers, input_types):
        return buffers[0]


class CollectSet(CollectList):
    """collect_set(expr): the deduplicated values (reference
    GpuCollectSet). Partials merge by concatenation; evaluate dedups."""
    name = "collect_set"
    _UPDATE = "collect_set"

    def evaluate(self, buffers, input_types):
        from ..ops.aggregate import dedup_array
        return dedup_array(buffers[0])


class Percentile(AggregateFunction):
    """percentile(col, p [, ...]): the exact interpolated percentile
    (reference GpuPercentile) over the group's values collected as a
    list."""
    name = "percentile"
    _INTERPOLATE = True

    def __init__(self, child, percentage):
        super().__init__(child)
        from .core import Literal
        if isinstance(percentage, Literal):
            percentage = percentage.value
        self.percentage = percentage

    def update_ops(self):
        return [("collect", 0)]

    def merge_ops(self):
        return ["collect_merge"]

    def buffer_types(self, input_types):
        from ..types import ArrayType
        return [ArrayType(input_types[0])]

    def _scalar_result(self, elem_t):
        return DoubleType() if self._INTERPOLATE else elem_t

    def result_type(self, input_types):
        from ..types import ArrayType
        rt = self._scalar_result(input_types[0])
        return ArrayType(rt) if isinstance(self.percentage, (list, tuple)) \
            else rt

    def result_type_from_buffer(self, buffer_types):
        return self.result_type([buffer_types[0].element_type])

    def evaluate(self, buffers, input_types):
        from ..ops.percentile import percentile_of_arrays
        return percentile_of_arrays(buffers[0], self.percentage,
                                    self._INTERPOLATE)


class ApproxPercentile(Percentile):
    """approx_percentile(col, p [, accuracy]): the JAX package's bounded
    sketch (ops/percentile.py), at most K = 2 x accuracy value points a
    group, exact for groups of K values or fewer. Values ride f64 points,
    so integral inputs beyond 2^53 lose low bits."""
    name = "approx_percentile"
    _INTERPOLATE = False
    DEFAULT_ACCURACY = 10000

    def __init__(self, child, percentage, accuracy=None):
        super().__init__(child, percentage)
        from .core import Literal
        if isinstance(accuracy, Literal):
            accuracy = accuracy.value
        self.accuracy = int(accuracy) if accuracy else self.DEFAULT_ACCURACY

    @property
    def _k(self) -> int:
        return 2 * self.accuracy

    def update_ops(self):
        return [(f"psketch:{self._k}", 0)]

    def merge_ops(self):
        return [f"psketch_merge:{self._k}"]

    def buffer_types(self, input_types):
        from ..types import DOUBLE, ArrayType
        return [ArrayType(DOUBLE)]

    def result_type_from_buffer(self, buffer_types):
        return self.result_type([DoubleType()])

    def evaluate(self, buffers, input_types):
        from ..ops.percentile import approx_percentile_of_sketches
        return approx_percentile_of_sketches(
            buffers[0], self.percentage, self._scalar_result(input_types[0]))
