"""Structured observability — the counterpart of spark_rapids_tpu/obs/:

  * `events` — the process-wide JSONL event bus, gated by
    spark.rapids.tpu.eventLog.{enabled,dir,level,maxBytes};
  * `span` — op_span(), a profiler range, a metric scope and an event;
  * `phase` — the closed wall-clock phase ledger of a governed query;
  * `dispatch` — the dispatch ledger over the kernel wrappers and the
    execs' batch steps;
  * `stats` — per-exchange runtime statistics;
  * `telemetry` — the sampled metrics registry and the SLO latency ring;
  * `profile` — QueryProfile, surfaced as TpuSession.last_query_profile();
  * `history` — one JSONL capsule per governed query, gated by
    spark.rapids.tpu.history.{enabled,dir,maxBytes}.
"""

from . import events  # noqa: F401
from .profile import QueryProfile  # noqa: F401
from .span import op_span  # noqa: F401
