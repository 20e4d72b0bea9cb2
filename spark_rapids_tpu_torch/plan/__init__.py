"""Planning engine: logical plans, the meta wrap -> tag -> convert
framework, TypeSig checks and the override rule tables that decide what
runs on the card."""

from .logical import (  # noqa: F401
    LogicalAggregate, LogicalFilter, LogicalJoin, LogicalLimit, LogicalPlan,
    LogicalProject, LogicalRange, LogicalScan, LogicalSort, LogicalUnion,
)
from .overrides import PlanNotSupported, TpuOverrides  # noqa: F401
