"""Adaptive runtime replanner — the counterpart of
spark_rapids_tpu/exec/adaptive.py: the part that joins and exchanges
consult, every decision from measured bytes, never estimates.

The five decisions (`DECISIONS`) and where they are taken:

  * ``skew_split`` and ``partition_coalesce``: the host exchange's read
    plan (exec/exchange.HostShuffleExchangeExec._adaptive_read_plan),
    from `skew_threshold` and `coalesce_groups` over the write phase's
    measured per-partition bytes;
  * ``single_build_convert``: ShuffledHashJoinExec, when its build
    exchange measures at or under ``adaptive.autoBroadcastMaxBytes``;
  * ``broadcast_demote``: AdaptiveJoinExec, a join whose build side fits
    the broadcast threshold but MEASURES over the cap;
  * ``batch_right_size``: `note_oom_split`, called by with_retry's split
    branch (memory/retry.py), halves the governed query's batch target,
    which CoalesceBatchesExec reads (`batch_target_override`).

`consult` is gated by the conf and by the `adaptive` breaker domain
(exec/lifecycle.py): a breaker refusal is counted and emitted as an
`adaptive_demote`. An applied decision is an `adaptive_replan` event and
engages the domain for the attempt; a consult-path failure counts
against it. `demote_cap` takes the tighter of the conf's cap and the
workload governor's quota share of the admitting query.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

#: decision slug -> what it does / its evidence (the JAX package's table)
DECISIONS: Dict[str, str] = {
    "skew_split": "reducer partition over factor x median bytes read "
                  "as map-granular sub-reads, one probe stream each",
    "broadcast_demote": "measured-oversized build side (conf cap or "
                        "quota share) demoted to sub-partitioned "
                        "strategy before any OOM retry",
    "single_build_convert": "shuffle join whose build side measured "
                            "small converted to a single-build probe "
                            "pass (probe-side exchange skipped)",
    "partition_coalesce": "adjacent reducer partitions under the "
                          "target merged into one read (flat "
                          "consumers only)",
    "batch_right_size": "query batch target halved after an OOM "
                        "split, consumed by CoalesceBatchesExec",
}

#: decision slug -> counter key
_DECISION_COUNTER = {
    "skew_split": "skew_splits",
    "broadcast_demote": "broadcast_demotes",
    "single_build_convert": "single_build_converts",
    "partition_coalesce": "partition_coalesces",
    "batch_right_size": "batch_right_sizes",
}

_COUNTER_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = {
    "consults": 0,
    "skew_splits": 0,
    "broadcast_demotes": 0,
    "single_build_converts": 0,
    "partition_coalesces": 0,
    "batch_right_sizes": 0,
    "breaker_demotions": 0,
    "errors": 0,
}


def _note(**deltas: int) -> None:
    with _COUNTER_LOCK:
        for k, v in deltas.items():
            _COUNTERS[k] = _COUNTERS.get(k, 0) + v


def counters() -> Dict[str, int]:
    """Cumulative process-wide decision counters."""
    with _COUNTER_LOCK:
        return dict(_COUNTERS)


def reset_adaptive() -> None:
    """Zero the counters (test isolation)."""
    with _COUNTER_LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0


# -- gate --------------------------------------------------------------------

def consult(conf, op: str = "", op_id: int = -1) -> bool:
    """May adaptive decisions apply here? The conf on and the `adaptive`
    breaker closed; a breaker refusal is a demotion, counted and
    emitted."""
    from ..config import ADAPTIVE_ENABLED
    if not conf.get(ADAPTIVE_ENABLED):
        return False
    from . import lifecycle
    if not lifecycle.breaker_allows("adaptive"):
        _note(breaker_demotions=1)
        from ..obs import events as obs_events
        obs_events.emit("adaptive_demote", exec=op, op_id=op_id,
                        decision="lane", reason="breaker_open")
        return False
    _note(consults=1)
    return True


def note_error(op: str = "", op_id: int = -1, error: str = "") -> None:
    """A consult-path failure: the replanner must never take a query
    down, so callers fall back to the static plan and record the
    failure against the `adaptive` breaker domain here."""
    _note(errors=1)
    from . import lifecycle
    lifecycle.record_domain_failure("adaptive")
    from ..obs import events as obs_events
    obs_events.emit("adaptive_demote", exec=op, op_id=op_id,
                    decision="lane", reason="error",
                    error=str(error)[:200])


def note_decision(decision: str, op: str = "", op_id: int = -1,
                  **evidence) -> None:
    """One applied decision: counted, emitted with its evidence, and the
    breaker domain engaged for the attempt."""
    _note(**{_DECISION_COUNTER[decision]: 1})
    from ..obs import events as obs_events
    obs_events.emit("adaptive_replan", exec=op, op_id=op_id,
                    decision=decision, **evidence)
    from . import lifecycle
    lifecycle.engage_domain("adaptive")


def note_demote(decision: str, op: str = "", op_id: int = -1,
                **evidence) -> None:
    """A strategy demotion: a planned cheap strategy measured
    unaffordable and the safe one was chosen. Counted and emitted."""
    _note(**{_DECISION_COUNTER[decision]: 1})
    from ..obs import events as obs_events
    obs_events.emit("adaptive_demote", exec=op, op_id=op_id,
                    decision=decision, **evidence)
    from . import lifecycle
    lifecycle.engage_domain("adaptive")


# -- decision 1: skewed-reducer splitting ------------------------------------

def skew_threshold(per_part_bytes: Sequence[int], factor: float,
                   min_bytes: int) -> Optional[Tuple[int, int]]:
    """(threshold_bytes, median_bytes) above which a partition is skewed,
    or None when splitting is off or undecidable. The median is over the
    nonzero partitions (empty partitions of a sparse key space would drag
    it to zero and flag everything). `factor` and `min_bytes` are
    adaptive.skewedPartitionFactor and skewedPartitionMinBytes, which the
    JAX package reads here from the conf: in the port the exchange reads
    them at its construction, as every conf the port honours is read."""
    if factor <= 0:
        return None
    nz = sorted(b for b in per_part_bytes if b > 0)
    if len(nz) < 2:
        return None
    median = nz[len(nz) // 2]
    return max(int(factor * median), max(0, min_bytes)), median


# -- decision 2: measured build-side caps ------------------------------------

def auto_broadcast_max(conf) -> int:
    """The conf cap for measured single-build/broadcast decisions (-1 =
    conversions off)."""
    from ..config import ADAPTIVE_AUTO_BROADCAST_MAX_BYTES
    return conf.get(ADAPTIVE_AUTO_BROADCAST_MAX_BYTES)


def demote_cap(conf) -> Optional[Tuple[int, str]]:
    """(cap_bytes, basis) a measured build side must stay under to keep a
    single-build plan: the tighter of adaptive.autoBroadcastMaxBytes
    (basis "conf") and the admitting ticket's workload quota share
    (basis "quota"); None when neither bound applies."""
    cap = auto_broadcast_max(conf)
    bound = (cap, "conf") if cap >= 0 else None
    from ..memory.budget import memory_budget
    from . import workload
    share = workload.quota_bytes(memory_budget().limit)
    if share is not None and (bound is None or share < bound[0]):
        bound = (share, "quota")
    return bound


# -- decision 3: tiny-partition coalescing -----------------------------------

def coalesce_groups(per_part_bytes: Sequence[int], target: int,
                    exclude: Optional[Set[int]] = None,
                    ) -> Optional[List[List[int]]]:
    """Greedy adjacent grouping of reducer partitions whose measured
    bytes fit `target` together; `exclude`d partitions always stand
    alone. Returns the full partition cover in order, or None when no
    group would merge anything."""
    exclude = exclude or set()
    groups: List[List[int]] = []
    cur: List[int] = []
    cur_b = 0
    for p, b in enumerate(per_part_bytes):
        if p in exclude or b > target:
            if cur:
                groups.append(cur)
                cur, cur_b = [], 0
            groups.append([p])
            continue
        if cur and cur_b + b > target:
            groups.append(cur)
            cur, cur_b = [], 0
        cur.append(p)
        cur_b += b
    if cur:
        groups.append(cur)
    if all(len(g) == 1 for g in groups):
        return None
    return groups


# -- decision 5: OOM-feedback batch right-sizing ------------------------------

#: the batch target never shrinks below this: a cascade of splits must
#: not degenerate to row-at-a-time batches
MIN_BATCH_TARGET = 4 * 1024


def note_oom_split() -> None:
    """with_retry's split branch: halve the governed query's batch target
    (floored), so CoalesceBatchesExec stops building batches the card
    just proved it cannot hold. A no-op outside a governed query or with
    adaptive off (read from the splitting thread's active conf, as
    with_retry reads its own)."""
    from . import lifecycle
    ctx = lifecycle.current_context()
    if ctx is None:
        return
    from ..config import ADAPTIVE_ENABLED, BATCH_SIZE_BYTES, active_conf
    conf = active_conf()
    if not conf.get(ADAPTIVE_ENABLED):
        return
    cur = ctx.adaptive_batch_target
    if cur is None:
        cur = conf.get(BATCH_SIZE_BYTES)
    new = max(MIN_BATCH_TARGET, cur // 2)
    if new >= cur:
        return
    ctx.adaptive_batch_target = new
    note_decision("batch_right_size", op="with_retry",
                  prev_target=cur, new_target=new)


def batch_target_override() -> Optional[int]:
    """The governed query's shrunken batch target, or None: one
    context-pointer read and one attribute read, no conf access."""
    from . import lifecycle
    ctx = lifecycle.current_context()
    if ctx is None:
        return None
    return ctx.adaptive_batch_target
