"""Expression layer: the fixed-width subset and the code-space string
predicates the ported slices run."""

from .core import (  # noqa: F401
    Alias, BoundReference, Expression, Literal, UnresolvedAttribute, col, lit,
    output_name, resolve,
)
from .arithmetic import (  # noqa: F401
    Abs, Add, Divide, Multiply, Subtract, UnaryMinus,
)
from .predicates import (  # noqa: F401
    And, EqualNullSafe, EqualTo, GreaterThan, GreaterThanOrEqual, IsNotNull,
    In, IsNull, LessThan, LessThanOrEqual, Not, Or,
)
