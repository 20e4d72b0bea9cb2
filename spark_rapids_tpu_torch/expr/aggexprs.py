"""Declarative aggregate functions — the counterpart of
spark_rapids_tpu/expr/aggexprs.py for Sum, Count, Min and Max. Each
function declares its buffer ops for the masked-bucket group-by
(ops/maskedagg.py, ops/fused_scan_agg.py) and a final `evaluate`.

Spark semantics:
  * sum(int*) -> long, sum(float|double) -> double; all-null group -> null
  * count(x) counts non-null, count(*) counts rows; never null
  * min/max ignore nulls; null for all-null groups
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar.column import Column
from ..types import DataType, DoubleType, FloatType, LongType
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

    def evaluate(self, buffers: List[Column],
                 input_types: Sequence[DataType]) -> Column:
        """Final projection from merged buffer columns to the result."""
        raise NotImplementedError

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.inputs))})"


def _sum_buffer_type(dt: DataType) -> DataType:
    if isinstance(dt, (DoubleType, FloatType)):
        return DoubleType()
    return LongType()


class Sum(AggregateFunction):
    name = "sum"

    def update_ops(self):
        return [("sum", 0)]

    def merge_ops(self):
        return ["sum"]

    def buffer_types(self, input_types):
        return [_sum_buffer_type(input_types[0])]

    def result_type(self, input_types):
        return _sum_buffer_type(input_types[0])

    def evaluate(self, buffers, input_types):
        return buffers[0]


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
