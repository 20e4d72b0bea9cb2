"""Runtime statistics collection — the counterpart of
spark_rapids_tpu/obs/stats.py: per-exchange map-output and partition
row/byte distributions, recorded into a per-query `RuntimeStats`
reachable during execution (from the governing QueryContext,
`stats.current()`) and after it through `QueryProfile.statistics()`.

Nothing here touches the per-row path, reads the device or syncs it.
The distributions are built from counts the exchange already holds
(exec/exchange.HostShuffleExchangeExec): the split's per-partition count
table, which its one device->host copy brought over with the reordered
batch, and the serializer's per-partition byte offsets. They are kept as
fixed-bucket log2 histograms (`Log2Hist`): O(1) per sample, O(64) per
percentile. Per-partition byte sums are exact (the serializer's offset
table), so `sum(per_partition_bytes) == bytes_written` to the byte; only
the percentile estimates are bucket-quantized (an upper bound within
2x).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

#: fixed bucket count: bucket b holds values v with v.bit_length() == b,
#: i.e. [2^(b-1), 2^b) for b >= 1 and {0} for b == 0 — enough for any
#: int64 byte/row count
N_BUCKETS = 64


class Log2Hist:
    """Fixed-bucket log2 histogram of non-negative integers: O(1) add,
    exact count/sum/min/max, bucket-quantized percentiles. The
    percentile estimate is the UPPER edge of the bucket holding the
    rank-q sample (clamped to the observed max), so for any true
    percentile t >= 1 the estimate lies in [t, 2t) — a one-sided bound
    an AQE consumer can size buffers against safely."""

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        self.counts = [0] * N_BUCKETS
        self.count = 0
        self.sum = 0
        self.min: Optional[int] = None
        self.max: Optional[int] = None

    def add(self, v: int, n: int = 1) -> None:
        v = int(v)
        if v < 0 or n <= 0:
            return
        self.counts[min(v.bit_length(), N_BUCKETS - 1)] += n
        self.count += n
        self.sum += v * n
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def percentile(self, q: float) -> int:
        """Upper-bound estimate of the q-th percentile (q in [0, 100])
        at bucket resolution; 0 for an empty histogram."""
        if self.count == 0:
            return 0
        rank = max(1, -(-int(q * self.count) // 100))  # ceil(q/100 * n)
        seen = 0
        for b, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                upper = 0 if b == 0 else (1 << b) - 1
                return max(self.min, min(upper, self.max))
        return self.max  # unreachable with count > 0

    def merge(self, other: "Log2Hist") -> None:
        for b in range(N_BUCKETS):
            self.counts[b] += other.counts[b]
        self.count += other.count
        self.sum += other.sum
        if other.min is not None:
            self.min = other.min if self.min is None else min(self.min, other.min)
        if other.max is not None:
            self.max = other.max if self.max is None else max(self.max, other.max)

    def summary(self) -> Dict[str, int]:
        return {"count": self.count, "sum": self.sum,
                "min": self.min or 0, "max": self.max or 0,
                "p50": self.percentile(50), "p95": self.percentile(95)}


def _median(values: Sequence[int]) -> float:
    s = sorted(values)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return float(s[mid]) if n % 2 else (s[mid - 1] + s[mid]) / 2.0


class ExchangeStats:
    """One exchange execution's runtime statistics: per-map-output and
    per-partition row/byte distributions plus exact per-partition
    totals. Thread-safe (a second exchange in the same plan may record
    from a different pipeline thread)."""

    __slots__ = ("op", "op_id", "partitions", "maps", "rows", "bytes",
                 "map_bytes", "part_rows", "part_bytes",
                 "per_partition_rows", "per_partition_bytes", "_lock")

    def __init__(self, op: str, op_id: Optional[int], partitions: int):
        self.op = op
        self.op_id = op_id
        self.partitions = partitions
        self.maps = 0
        self.rows = 0
        self.bytes = 0
        #: one sample per map output (total serialized bytes)
        self.map_bytes = Log2Hist()
        #: one sample per (map output, partition) — incl. empty
        #: partitions: a skewed key set SHOWS as a mass of zeros plus a
        #: heavy tail, which is the signal AQE splits on
        self.part_rows = Log2Hist()
        self.part_bytes = Log2Hist()
        #: exact cumulative totals across maps (the skew surface)
        self.per_partition_rows = [0] * partitions
        self.per_partition_bytes = [0] * partitions
        self._lock = threading.Lock()

    def record_map(self, rows_per_part: Optional[Sequence[int]],
                   bytes_per_part: Optional[Sequence[int]],
                   total_bytes: int = 0) -> None:
        with self._lock:
            self.maps += 1
            self.bytes += int(total_bytes)
            if total_bytes:
                self.map_bytes.add(int(total_bytes))
            if rows_per_part is not None:
                for p, r in enumerate(rows_per_part):
                    r = int(r)
                    self.rows += r
                    self.per_partition_rows[p] += r
                    self.part_rows.add(r)
            if bytes_per_part is not None:
                for p, b in enumerate(bytes_per_part):
                    b = int(b)
                    self.per_partition_bytes[p] += b
                    self.part_bytes.add(b)

    def skew(self) -> Dict[str, Any]:
        """max/median partition ratio over the exact per-partition
        totals — bytes when the exchange measured them, rows otherwise.
        A zero median (most partitions empty) falls back to the median
        of the NON-empty partitions, so the ratio stays finite and the
        all-in-one-partition case still reads as extreme skew."""
        with self._lock:
            totals = self.per_partition_bytes \
                if any(self.per_partition_bytes) else self.per_partition_rows
            basis = "bytes" if any(self.per_partition_bytes) else "rows"
            totals = list(totals)
        mx = max(totals, default=0)
        med = _median(totals)
        if med == 0:
            med = _median([t for t in totals if t])
        ratio = round(mx / med, 4) if med else 0.0
        return {"basis": basis, "max": mx, "median": med, "ratio": ratio}

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "op": self.op, "op_id": self.op_id,
                "partitions": self.partitions, "maps": self.maps,
                "rows": self.rows, "bytes": self.bytes,
                "map_output_bytes": self.map_bytes.summary(),
                "partition_rows": self.part_rows.summary(),
                "partition_bytes": self.part_bytes.summary(),
                "per_partition_rows": list(self.per_partition_rows),
                "per_partition_bytes": list(self.per_partition_bytes),
            }
        out["skew"] = self.skew()
        return out


class RuntimeStats:
    """Per-query statistics container, created per task attempt by
    `DataFrame._collect_once` and carried on the governing
    `QueryContext` (producer threads adopt the context, so exchange
    writes running behind a pipeline boundary record into the same
    object). Reachable mid-flight via `stats.current()`; snapshotted
    into `QueryProfile.statistics()` at query end."""

    def __init__(self):
        self._lock = threading.Lock()
        self._exchanges: Dict[Any, ExchangeStats] = {}

    def exchange(self, op: str, op_id: Optional[int],
                 partitions: int) -> ExchangeStats:
        key = (op, op_id)
        with self._lock:
            st = self._exchanges.get(key)
            if st is None:
                st = self._exchanges[key] = ExchangeStats(op, op_id,
                                                          partitions)
            return st

    def exchanges(self) -> List[ExchangeStats]:
        with self._lock:
            return list(self._exchanges.values())

    def to_dict(self) -> Dict[str, Any]:
        return {"exchanges": {f"{st.op}#{st.op_id}": st.summary()
                              for st in self.exchanges()}}


def current() -> Optional[RuntimeStats]:
    """The RuntimeStats of this thread's governed query (None outside
    one — a single pointer check, the obs cost discipline)."""
    from ..exec import lifecycle
    ctx = lifecycle.current_context()
    if ctx is None:
        return None
    return ctx.runtime_stats


# ---------------------------------------------------------------------------
# process-wide collector
# ---------------------------------------------------------------------------

_global_lock = threading.Lock()
_global_map_bytes = Log2Hist()
_global_maps = 0
_global_last_skew = 0.0
#: ring of the most recent exchanges' skew summaries — the
#: TpuSession.health() "stats" surface: operators see skew
#: pressure per exchange without reading the event log
_RECENT_MAX = 8
_global_recent: List[Dict[str, Any]] = []


class ExchangeRecorder:
    """The write-path hook the exchanges call once per map task: fans
    each record into the per-query RuntimeStats (when a governed query
    is running on this thread) AND the process-wide collector that
    counters() reads. `finish()` returns the exchange's summary (for the
    `exchange_stats` event) and publishes the skew ratio."""

    __slots__ = ("_per_query", "_local")

    def __init__(self, op: str, op_id: Optional[int], partitions: int):
        rs = current()
        self._per_query = rs.exchange(op, op_id, partitions) \
            if rs is not None else None
        self._local = ExchangeStats(op, op_id, partitions)

    def record_map(self, rows_per_part, bytes_per_part,
                   total_bytes: int = 0) -> None:
        global _global_maps
        self._local.record_map(rows_per_part, bytes_per_part, total_bytes)
        if self._per_query is not None:
            self._per_query.record_map(rows_per_part, bytes_per_part,
                                       total_bytes)
        with _global_lock:
            _global_maps += 1
            if total_bytes:
                _global_map_bytes.add(int(total_bytes))

    def partition_bytes(self) -> Optional[List[int]]:
        """The exact per-partition byte totals measured so far (the
        serializer's offsets), or None when no map recorded bytes: the
        adaptive read plan's evidence. A copy."""
        st = self._local
        with st._lock:
            if st.maps == 0 or not any(st.per_partition_bytes):
                return None
            return list(st.per_partition_bytes)

    def total_bytes(self) -> int:
        """Total serialized bytes measured so far."""
        with self._local._lock:
            return self._local.bytes

    def finish(self) -> Optional[Dict[str, Any]]:
        global _global_last_skew
        if self._local.maps == 0:
            return None
        out = self._local.summary()
        with _global_lock:
            _global_last_skew = out["skew"]["ratio"]
            sk = out["skew"]
            _global_recent.append({
                "op": f"{out['op']}#{out['op_id']}",
                "partitions": out["partitions"], "maps": out["maps"],
                "bytes": out["bytes"], "basis": sk["basis"],
                "max": sk["max"], "median": sk["median"],
                "ratio": sk["ratio"]})
            del _global_recent[:-_RECENT_MAX]
        return out

    def finish_and_emit(self) -> Optional[Dict[str, Any]]:
        """finish() plus THE one `exchange_stats` event — both exchange
        lanes emit through here, so the record schema cannot drift
        between them."""
        out = self.finish()
        if out is not None:
            from . import events as obs_events
            sk = out["skew"]
            obs_events.emit(
                "exchange_stats", exec=out["op"], op_id=out["op_id"],
                partitions=out["partitions"], maps=out["maps"],
                rows=out["rows"], bytes=out["bytes"],
                skew_ratio=sk["ratio"], skew_basis=sk["basis"],
                max_partition=sk["max"], median_partition=sk["median"],
                p95_partition_bytes=out["partition_bytes"]["p95"],
                p95_map_output_bytes=out["map_output_bytes"]["p95"])
        return out


def counters() -> Dict[str, int]:
    """Flat process-cumulative statistics counters (the chaos-delta
    pattern: a caller deltas `maps`/`bytes` per run;
    `p95_map_output_bytes` and `skew_ratio_x1000` are point-in-time
    reads a round interprets directly, not deltas)."""
    with _global_lock:
        return {
            "maps": _global_maps,
            "bytes": _global_map_bytes.sum,
            "p95_map_output_bytes": _global_map_bytes.percentile(95),
            "skew_ratio_x1000": int(_global_last_skew * 1000),
        }


def health_section() -> Dict[str, Any]:
    """The TpuSession.health() "stats" block:
    recent per-exchange max/median skew plus the adaptive decisions
    taken — the skew-pressure surface operators read instead of the
    event log."""
    from ..exec import adaptive
    with _global_lock:
        recent = [dict(r) for r in _global_recent]
        last = _global_last_skew
    return {"recent_exchanges": recent,
            "last_skew_ratio": last,
            "adaptive": adaptive.counters()}


def reset_stats() -> None:
    """Test isolation for the process-wide collector."""
    global _global_map_bytes, _global_maps, _global_last_skew
    with _global_lock:
        _global_map_bytes = Log2Hist()
        _global_maps = 0
        _global_last_skew = 0.0
        del _global_recent[:]
