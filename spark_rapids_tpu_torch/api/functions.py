"""Column functions — the counterpart of spark_rapids_tpu/api/functions.py
(the pyspark.sql.functions analog), for the expressions and aggregates
the port has: `col`, `lit`, `sum`, `count`, `avg` (`mean`), `min`, `max`,
`abs`, the conditionals `when`, `coalesce`, `nvl` (`ifnull`), `nvl2` and
`nullif`, the date and time functions, the bitwise ones and
`format_number`, with the JAX package's names and signatures. The rest of
the JAX package's functions come with their expressions (ROADMAP A.8),
each wave adding its own here.
"""

from __future__ import annotations

from ..expr import arithmetic, bitwise, conditional, datetimeexprs
from ..expr.aggexprs import Average, Count, Max, Min, Sum
from ..expr.core import Expression, col, lit  # noqa: F401
from ..expr.stringexprs import FormatNumber


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


# datetime functions -------------------------------------------------------
def year(x):
    return datetimeexprs.Year(_e(x))


def month(x):
    return datetimeexprs.Month(_e(x))


def dayofmonth(x):
    return datetimeexprs.DayOfMonth(_e(x))


def dayofweek(x):
    return datetimeexprs.DayOfWeek(_e(x))


def dayofyear(x):
    return datetimeexprs.DayOfYear(_e(x))


def quarter(x):
    return datetimeexprs.Quarter(_e(x))


def hour(x):
    return datetimeexprs.Hour(_e(x))


def minute(x):
    return datetimeexprs.Minute(_e(x))


def second(x):
    return datetimeexprs.Second(_e(x))


def date_add(x, n):
    return datetimeexprs.DateAdd(_e(x), _e(n))


def date_sub(x, n):
    return datetimeexprs.DateAdd(_e(x), _e(n), negate=True)


def datediff(end, start):
    return datetimeexprs.DateDiff(_e(end), _e(start))


def add_months(x, n):
    return datetimeexprs.AddMonths(_e(x), _e(n))


def last_day(x):
    return datetimeexprs.LastDay(_e(x))


def trunc(x, unit):
    return datetimeexprs.TruncDate(_e(x), unit)


def from_utc_timestamp(x, tz):
    return datetimeexprs.FromUTCTimestamp(_e(x), tz)


def to_utc_timestamp(x, tz):
    return datetimeexprs.ToUTCTimestamp(_e(x), tz)


# bitwise / shifts ---------------------------------------------------------
def shiftleft(x, n):
    return bitwise.ShiftLeft(_e(x), _e(n))


def shiftright(x, n):
    return bitwise.ShiftRight(_e(x), _e(n))


def shiftrightunsigned(x, n):
    return bitwise.ShiftRightUnsigned(_e(x), _e(n))


def bitwise_not(x):
    return bitwise.BitwiseNot(_e(x))


# strings --------------------------------------------------------------------
def format_number(x, d):
    return FormatNumber(_e(x), d)
