"""User API: TpuSession / DataFrame over the logical planner, and the
column functions."""

from .session import DataFrame, TpuSession  # noqa: F401
from . import functions  # noqa: F401
