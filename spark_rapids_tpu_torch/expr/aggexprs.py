"""Declarative aggregate functions — the counterpart of
spark_rapids_tpu/expr/aggexprs.py for Sum, Count, Min, Max and Average. Each
function declares its buffer ops for the masked-bucket group-by
(ops/maskedagg.py, ops/fused_scan_agg.py) and a final `evaluate`.

Spark semantics:
  * sum(int*) -> long, sum(float|double) -> double; all-null group -> null
  * sum(decimal(p, s)) -> decimal(min(p + 10, 38), s), summed exactly in
    a two-limb buffer; past the result precision -> null (CheckOverflow)
  * count(x) counts non-null, count(*) counts rows; never null
  * avg -> double, from (sum, count) buffers; null when the count is 0;
    avg over a DECIMAL is tagged off at plan time (the JAX package's
    raises, ROADMAP C.5)
  * min/max ignore nulls; null for all-null groups
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
