"""Columnar execution operators (the q1 slice: scan, filter, project,
aggregate)."""

from .base import TpuExec, TpuMetric  # noqa: F401
