"""Expression layer: the fixed-width subset the q1 slice runs."""

from .core import (  # noqa: F401
    Alias, BoundReference, Expression, Literal, UnresolvedAttribute, col, lit,
    output_name, resolve,
)
from .arithmetic import (  # noqa: F401
    Abs, Add, Divide, Multiply, Subtract, UnaryMinus,
)
from .predicates import (  # noqa: F401
    And, EqualNullSafe, EqualTo, GreaterThan, GreaterThanOrEqual, IsNotNull,
    IsNull, LessThan, LessThanOrEqual, Not, Or,
)
