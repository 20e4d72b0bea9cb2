"""Column functions — the counterpart of spark_rapids_tpu/api/functions.py
(the pyspark.sql.functions analog), for the expressions and aggregates
the port has: `col`, `lit`, `sum`, `count`, `avg` (`mean`), `min`, `max`,
`abs`, and the conditionals `when`, `coalesce`, `nvl` (`ifnull`), `nvl2`
and `nullif`, with the JAX package's names and signatures. The rest of the
JAX package's functions come with their expressions (ROADMAP A.8), each
wave adding its own here.
"""

from __future__ import annotations

from ..expr import arithmetic, conditional
from ..expr.aggexprs import Average, Count, Max, Min, Sum
from ..expr.core import Expression, col, lit  # noqa: F401


def _e(x) -> Expression:
    return x if isinstance(x, Expression) else (col(x) if isinstance(x, str)
                                                else lit(x))


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
