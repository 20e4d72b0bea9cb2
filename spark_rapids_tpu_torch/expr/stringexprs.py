"""String expressions — the counterpart of
spark_rapids_tpu/expr/stringexprs.py, so far only `FormatNumber`, whose
kernel is a cast (ops/cast_strings.format_number_string). The rest of
the module comes with ROADMAP A.8 wave 2.
"""

from __future__ import annotations

from ..types import STRING, DecimalType
from .core import Expression, Literal


class FormatNumber(Expression):
    """format_number(x, d): thousands separators and d decimals (HALF_EVEN),
    reference GpuFormatNumber. The JAX package runs a DECIMAL input or a
    d past 18 on its host row tier; the planner tags those off
    (`device_supported`), since that tier waits for ROADMAP A.8 wave 4."""

    def __init__(self, child: Expression, decimals):
        self.children = (child,)
        self.decimals = decimals.value if isinstance(decimals, Literal) \
            else decimals

    def with_children(self, cs):
        return FormatNumber(cs[0], self.decimals)

    @property
    def device_supported(self) -> bool:
        if not isinstance(self.decimals, int) \
                or not 0 <= self.decimals <= 18:
            return False
        try:
            return not isinstance(self.children[0].data_type, DecimalType)
        except TypeError:
            return False

    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        from ..ops.cast_strings import format_number_string
        return format_number_string(self.children[0].columnar_eval(batch),
                                    int(self.decimals))
