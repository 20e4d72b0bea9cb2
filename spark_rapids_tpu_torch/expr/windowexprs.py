"""Window expressions — the counterpart of spark_rapids_tpu/expr/
windowexprs.py (reference GpuWindowExpression.scala and the window
functions of window/). A WindowExpression pairs a window function with a
WindowSpec; WindowExec lowers them onto the segmented-scan kernels of
ops/window.py."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

from ..types import DataType, DoubleType, IntegerType, LongType
from .core import Expression


#: frame bound: None = UNBOUNDED, 0 = CURRENT ROW, n>0 = n rows
@dataclass(frozen=True)
class WindowFrame:
    kind: str = "default"  # 'default' | 'rows' | 'range'
    preceding: Optional[int] = None
    following: Optional[int] = 0

    @staticmethod
    def rows(preceding: Optional[int], following: Optional[int]
             ) -> "WindowFrame":
        return WindowFrame("rows", preceding, following)

    @staticmethod
    def range(preceding, following) -> "WindowFrame":
        """RANGE frame with VALUE offsets over the single numeric order
        key (None = unbounded; 0 = CURRENT ROW incl. ties). Reference
        window/GpuWindowExpression.scala:111-179."""
        return WindowFrame("range", preceding, following)

    @staticmethod
    def unbounded() -> "WindowFrame":
        return WindowFrame("rows", None, None)


@dataclass
class WindowSpec:
    partition_by: Tuple[Expression, ...] = ()
    order_by: Tuple = ()  # (Expression, ascending, nulls_first?) tuples
    frame: WindowFrame = field(default_factory=WindowFrame)

    def with_frame(self, frame: WindowFrame) -> "WindowSpec":
        return WindowSpec(self.partition_by, self.order_by, frame)


def window(partition_by: Sequence = (), order_by: Sequence = (),
           frame: Optional[WindowFrame] = None) -> WindowSpec:
    from .core import col
    pb = tuple(col(p) if isinstance(p, str) else p for p in partition_by)
    ob = []
    for o in order_by:
        if isinstance(o, tuple):
            e = col(o[0]) if isinstance(o[0], str) else o[0]
            ob.append((e,) + tuple(o[1:]))
        else:
            ob.append((col(o) if isinstance(o, str) else o, True))
    return WindowSpec(pb, tuple(ob), frame or WindowFrame())


class WindowFunction:
    """Marker base; `inputs` are expressions evaluated pre-sort."""
    inputs: Tuple[Expression, ...] = ()
    needs_order = False
    name = "window_fn"

    def result_type(self, input_types) -> DataType:
        raise NotImplementedError

    def over(self, spec: WindowSpec) -> "WindowExpression":
        return WindowExpression(self, spec)

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.inputs))})"


class RowNumber(WindowFunction):
    name, needs_order = "row_number", True

    def result_type(self, input_types):
        return IntegerType()


class Rank(WindowFunction):
    name, needs_order = "rank", True

    def result_type(self, input_types):
        return IntegerType()


class DenseRank(Rank):
    name = "dense_rank"


class Lag(WindowFunction):
    name, needs_order = "lag", True

    def __init__(self, child: Expression, offset: int = 1, default=None):
        self.inputs = (child,)
        self.offset = offset
        self.default = default

    def result_type(self, input_types):
        return input_types[0]


class Lead(Lag):
    name = "lead"

    def __init__(self, child: Expression, offset: int = 1, default=None):
        super().__init__(child, -offset, default)


class WindowAgg(WindowFunction):
    """sum/min/max/count/avg over a frame."""

    def __init__(self, op: str, child: Optional[Expression]):
        assert op in ("sum", "min", "max", "count", "avg")
        self.op = op
        self.name = op
        self.inputs = (child,) if child is not None else ()

    def result_type(self, input_types):
        if self.op == "count":
            return LongType()
        if self.op == "avg":
            return DoubleType()
        dt = input_types[0]
        if self.op == "sum":
            from .aggexprs import _sum_buffer_type
            return _sum_buffer_type(dt)
        return dt


class FirstValue(WindowFunction):
    name = "first_value"

    def __init__(self, child: Expression):
        self.inputs = (child,)

    def result_type(self, input_types):
        return input_types[0]


class LastValue(FirstValue):
    name = "last_value"


class WindowExpression:
    def __init__(self, fn: WindowFunction, spec: WindowSpec):
        self.fn = fn
        self.spec = spec

    def __repr__(self):
        return f"{self.fn!r} OVER {self.spec!r}"
