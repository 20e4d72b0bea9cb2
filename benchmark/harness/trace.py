"""The reduction of a `torch.profiler` trace of the window to device busy
time, kernel times by name, and idle gaps named by what the host was
doing.

Events come from the profiler's kineto results (no trace file is
written): device operations are the events of kinds `kernel`,
`gpu_memcpy` and `gpu_memset`; host ranges the `user_annotation` ranges
(the port's `annotate_op`, the benchmark's `bench.window` and
`bench.query.<name>`) and `cpu_op`s of the thread that ran the window.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_RANGE = "bench.window"

Interval = Tuple[int, int]


class Trace:
    """Device operations (name, start ns, end ns, kind) and host ranges
    (name, start ns, end ns, kind) inside the traced window."""

    def __init__(self, device_ops, host_ranges, window: Interval):
        self.window = window
        lo, hi = window
        self.device_ops = [op for op in device_ops
                           if op[2] > lo and op[1] < hi]
        self.host_ranges = host_ranges

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self):
        return [op for op in self.device_ops if op[3] == "kernel"]

    def busy_intervals(self) -> List[Interval]:
        """The union of the device operations' intervals, clipped to the
        window, in order."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e, _ in
                       self.device_ops)
        out: List[Interval] = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1] = (out[-1][0], e)
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_gaps(self) -> List[Interval]:
        lo, hi = self.window
        gaps, at = [], lo
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        return gaps

    def device_time_by_name(self) -> Dict[str, float]:
        """Seconds of device operations by name, clipped to the window."""
        lo, hi = self.window
        out: Dict[str, float] = defaultdict(float)
        for name, s, e, _ in self.device_ops:
            out[name] += (min(e, hi) - max(s, lo)) / 1e9
        return dict(out)

    def idle_by_host(self) -> Dict[str, float]:
        """Seconds of device idle time by what the host was doing at each
        gap's midpoint: the innermost annotation open then, and the
        innermost operator inside it."""
        gaps = self.idle_gaps()
        mids = [(s + e) // 2 for s, e in gaps]
        ann = innermost(mids, [r for r in self.host_ranges
                               if r[3] == "user_annotation"
                               and r[0] != WINDOW_RANGE])
        ops = innermost(mids, [r for r in self.host_ranges
                               if r[3] == "cpu_op"])
        out: Dict[str, float] = defaultdict(float)
        for (s, e), a, o in zip(gaps, ann, ops):
            name = (a or "-") + " / " + (o or "-")
            out[name] += (e - s) / 1e9
        return dict(out)


def innermost(points: Sequence[int], ranges) -> List[Optional[str]]:
    """For each point (ascending), the name of the latest-starting range
    (name, start, end, ...) that contains it. Ranges of one thread nest,
    so a stack sweep finds it."""
    order = sorted(ranges, key=lambda r: (r[1], -r[2]))
    out: List[Optional[str]] = []
    stack: List[tuple] = []
    k = 0
    for p in points:
        while k < len(order) and order[k][1] <= p:
            r = order[k]
            while stack and stack[-1][2] <= r[1]:
                stack.pop()
            stack.append(r)
            k += 1
        while stack and stack[-1][2] <= p:
            stack.pop()
        # a range that ended may sit under one still open: look down
        found = None
        for r in reversed(stack):
            if r[1] <= p < r[2]:
                found = r[0]
                break
        out.append(found)
    return out


def short_name(name: str, limit: int = 100) -> str:
    """A kernel's name without its return type, at most `limit`
    characters."""
    if name.startswith("void "):
        name = name[5:]
    return name if len(name) <= limit else name[:limit - 3] + "..."


def top(named: Dict[str, float], n: int = 10, short: bool = False
        ) -> List[list]:
    """The n largest entries as [name, seconds]; with `short`, names
    shortened (entries that then share a name are added together)."""
    if short:
        merged: Dict[str, float] = defaultdict(float)
        for k, v in named.items():
            merged[short_name(k)] += v
        named = merged
    return [[k, v] for k, v in sorted(named.items(), key=lambda kv: -kv[1])
            [:n]]


def kind_of(ev) -> str:
    """The event's kineto activity kind; where this torch's events do not
    carry it, inferred from the device and the name."""
    f = getattr(ev, "activity_type", None)
    if f is not None:
        return f()
    annotation = getattr(ev, "is_user_annotation", lambda: False)()
    if str(ev.device_type()).endswith("CUDA"):
        name = ev.name()
        if annotation or name.startswith("bench."):
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "user_annotation" if annotation else "cpu_op"


def from_profiler(prof) -> Optional[Trace]:
    """The Trace of a finished torch.profiler.profile, or None when it
    holds no window range."""
    events = prof.profiler.kineto_results.events()
    window, thread = None, None
    for ev in events:
        if ev.name() == WINDOW_RANGE and kind_of(ev) == "user_annotation":
            window = (ev.start_ns(), ev.start_ns() + ev.duration_ns())
            thread = ev.start_thread_id()
    if window is None:
        return None
    device_ops, host = [], []
    kinds = [kind_of(ev) for ev in events]
    # a range's projection onto the device timeline is no operation
    ranges = {ev.name() for ev, k in zip(events, kinds)
              if k == "user_annotation"}
    for ev, kind in zip(events, kinds):
        if kind in DEVICE_KINDS and ev.name() not in ranges:
            s = ev.start_ns()
            device_ops.append((ev.name(), s, s + ev.duration_ns(), kind))
        elif kind in ("user_annotation", "cpu_op") \
                and ev.start_thread_id() == thread:
            s = ev.start_ns()
            host.append((ev.name(), s, s + ev.duration_ns(), kind))
    return Trace(device_ops, host, window)
