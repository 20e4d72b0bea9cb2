"""Process-wide dispatch ledger — the counterpart of
spark_rapids_tpu/obs/dispatch.py.

The JAX package's ledger wraps `jax.jit`: every compiled program is a
dispatch, its first trace a compile. The port compiles nothing at run
time but its CUDA kernel libraries, so its ledger wraps the port's own
dispatch sites:

  * the six kernel wrappers (`kernel_site`: fused_scan_agg, the murmur3
    chain and lanes, fused_probe_verify, dma_row_gather, dict_gather),
    one ledger call per kernel launch, so a label's calls equal its
    wrapper's `launches` counter;
  * each exec's batch step (`exec_scope`, entered by TpuExec's drive
    loop around every pull of a batch).

A program key is (label, log2 shape bucket, device type). Per key the
ledger records the calls, the first call's wall ns (for a kernel, the
library's build and load at first use) against the later calls', the
wall ns of all of them and the build ns inside them. An exec scope's
wall ns is its SELF time: the pulls of its children, the waits and the
builds nested in it are not counted. `program_compile` is emitted once
per kernel library built (kernels/build.py reports each build through
`note_build`), and `recompile_storm` when one label builds more than
spark.rapids.tpu.dispatch.storm.traces libraries inside
storm.windowMs (the fused kernel builds one library per aggregate spec).
Donated bytes have no counterpart: the port hands no buffer to a
program to reuse in place, so `donated_bytes` is 0 in every record.

Phases (obs/phase.py): an exec scope is a `device-compute` span on its
thread; a kernel site outside any span is one too; a build inside either
is `compile` and is excluded from the enclosing span.

Hang bound: with spark.rapids.tpu.dispatch.timeoutMs > 0 (read by
`configure`), a kernel site, after its body's launches, and an exec
scope, after its pull, record a CUDA event on the current stream and
poll it on the calling thread until the deadline
(exec/speculation_shield.await_ready): a wedged kernel raises
DispatchTimeoutError instead of hanging the query, and never changes a
kernel's route. The JAX package blocks on a helper thread instead; here
no thread is left behind. Off, the cost is the ledger's one attribute
check.

`metric_scope(num, time)` keeps the JAX package's surface: kernel
launches inside the block add to an exec's (numDispatches,
compileTimeNs) metric pair.

Cost discipline: spark.rapids.tpu.dispatch.ledger.enabled defaults on;
explicitly false makes `active_ledger()` None and every site one pointer
check.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "DispatchLedger", "kernel_site", "exec_scope", "note_build",
    "active_ledger", "configure", "reset_dispatch_ledger", "counters",
    "programs", "calls_by_label", "health_section", "metric_scope",
    "shape_bucket",
]

#: the canonical per-exec metric names the JAX package's execs carry
NUM_DISPATCHES = "numDispatches"
COMPILE_TIME = "compileTimeNs"

_tls = threading.local()


def shape_bucket(shape) -> Tuple[int, ...]:
    """Each dimension rounded up to a power of two (0 stays 0): one key
    covers every call of one program shape."""
    return tuple(0 if int(d) <= 0 else 1 << (int(d) - 1).bit_length()
                 for d in shape)


class ProgramStats:
    """Cumulative ledger record of one program key."""

    __slots__ = ("label", "kind", "bucket", "device_type", "calls",
                 "builds", "first_ns", "later_ns", "build_ns")

    def __init__(self, label: str, kind: str, bucket, device_type: str):
        self.label = label
        self.kind = kind
        self.bucket = bucket
        self.device_type = device_type
        self.calls = 0
        self.builds = 0
        self.first_ns = 0
        self.later_ns = 0
        self.build_ns = 0

    @property
    def wall_ns(self) -> int:
        return self.first_ns + self.later_ns

    def to_dict(self) -> Dict[str, Any]:
        return {"label": self.label, "kind": self.kind,
                "bucket": list(self.bucket),
                "device_type": self.device_type, "calls": self.calls,
                "builds": self.builds, "first_ns": self.first_ns,
                "later_ns": self.later_ns, "wall_ns": self.wall_ns,
                "build_ns": self.build_ns, "donated_bytes": 0}


class DispatchLedger:
    """The process-wide program registry. Mutation under one leaf lock;
    events are emitted after it drops."""

    def __init__(self, storm_traces: int = 8,
                 storm_window_ms: int = 10_000, timeout_ms: int = 0):
        self.storm_traces = max(1, int(storm_traces))
        self.storm_window_ms = max(1, int(storm_window_ms))
        #: the hang bound of a site's device work (0 = off)
        self.timeout_ms = max(0, int(timeout_ms))
        self._lock = threading.Lock()
        self._programs: Dict[Tuple, ProgramStats] = {}
        self._calls = 0
        self._builds = 0
        self._build_ns = 0
        self._wall_ns = 0
        self._storms = 0
        #: label -> monotonic ns of its recent builds (storm window)
        self._label_builds: Dict[str, deque] = {}
        self._label_storm_until: Dict[str, int] = {}

    def record(self, label: str, kind: str, bucket, device_type: str,
               calls: int, wall_ns: int, build_ns: int) -> None:
        key = (label, bucket, device_type)
        with self._lock:
            prog = self._programs.get(key)
            if prog is None:
                prog = self._programs[key] = ProgramStats(
                    label, kind, bucket, device_type)
            if prog.calls == 0:
                prog.first_ns += wall_ns
            else:
                prog.later_ns += wall_ns
            prog.calls += calls
            if build_ns:
                prog.builds += 1
                prog.build_ns += build_ns
            self._calls += calls
            self._wall_ns += wall_ns
            self._build_ns += build_ns

    def note_build(self, label: str, ns: int) -> Optional[tuple]:
        """One library built and loaded for `label`; returns the storm
        event to emit, or None."""
        now = time.monotonic_ns()
        window_ns = self.storm_window_ms * 1_000_000
        with self._lock:
            self._builds += 1
            times = self._label_builds.setdefault(label, deque())
            times.append(now)
            while times and times[0] < now - window_ns:
                times.popleft()
            if len(times) <= self.storm_traces \
                    or now < self._label_storm_until.get(label, 0):
                return None
            self._storms += 1
            self._label_storm_until[label] = now + window_ns
            return ("recompile_storm",
                    dict(label=label, traces_in_window=len(times),
                         window_ms=self.storm_window_ms,
                         threshold=self.storm_traces))

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {"programs": len(self._programs),
                    "dispatches": self._calls,
                    "traces": self._builds,
                    "cache_hits": max(0, self._calls - self._builds),
                    "compile_ns": self._build_ns,
                    "wall_ns": self._wall_ns,
                    "donated_bytes": 0,
                    "storms": self._storms}

    def programs(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [p.to_dict() for p in self._programs.values()]

    def calls_by_label(self, kind: Optional[str] = None) -> Dict[str, int]:
        out: Dict[str, int] = {}
        with self._lock:
            for p in self._programs.values():
                if kind is None or p.kind == kind:
                    out[p.label] = out.get(p.label, 0) + p.calls
        return out


_ledger: Optional[DispatchLedger] = DispatchLedger()
_ledger_lock = threading.Lock()


def active_ledger() -> Optional[DispatchLedger]:
    """The process ledger, or None when disabled."""
    return _ledger


def configure(conf=None) -> Optional[DispatchLedger]:
    """(Re)configure from a RapidsConf. Process-wide and default on: a
    default session (re)creates the ledger, only an explicit
    dispatch.ledger.enabled=false tears it down."""
    global _ledger
    from ..config import (DISPATCH_LEDGER_ENABLED, DISPATCH_STORM_TRACES,
                          DISPATCH_STORM_WINDOW_MS, DISPATCH_TIMEOUT_MS,
                          active_conf)
    conf = conf if conf is not None else active_conf()
    enabled = conf.get(DISPATCH_LEDGER_ENABLED)
    traces = conf.get(DISPATCH_STORM_TRACES)
    window = conf.get(DISPATCH_STORM_WINDOW_MS)
    timeout = conf.get(DISPATCH_TIMEOUT_MS)
    with _ledger_lock:
        if not enabled:
            _ledger = None
            return None
        if _ledger is None:
            _ledger = DispatchLedger(traces, window, timeout)
        else:
            _ledger.storm_traces = max(1, int(traces))
            _ledger.storm_window_ms = max(1, int(window))
            _ledger.timeout_ms = max(0, int(timeout))
        return _ledger


def reset_dispatch_ledger() -> None:
    """A fresh default-enabled ledger (test isolation)."""
    global _ledger
    with _ledger_lock:
        _ledger = DispatchLedger()


def counters() -> Dict[str, int]:
    led = _ledger
    if led is None:
        return {"programs": 0, "dispatches": 0, "traces": 0,
                "cache_hits": 0, "compile_ns": 0, "wall_ns": 0,
                "donated_bytes": 0, "storms": 0}
    return led.counters()


def programs() -> List[Dict[str, Any]]:
    led = _ledger
    return led.programs() if led is not None else []


def calls_by_label(kind: Optional[str] = None) -> Dict[str, int]:
    """Calls per label (kernel labels are the wrappers' names)."""
    led = _ledger
    return led.calls_by_label(kind) if led is not None else {}


def health_section() -> Dict[str, Any]:
    """`TpuSession.health()["dispatch"]`: the enabled flag, the counters
    and the programs whose first call cost most."""
    led = _ledger
    out: Dict[str, Any] = {"enabled": led is not None}
    out.update(counters())
    if led is not None:
        progs = led.programs()
        progs.sort(key=lambda p: -p["first_ns"])
        out["top_programs"] = progs[:5]
    return out


@contextmanager
def metric_scope(num_metric, time_metric=None):
    """Attribute the kernel launches inside the block to an exec's
    (numDispatches, compileTimeNs) metric pair."""
    prev = getattr(_tls, "sink", None)
    _tls.sink = (num_metric, time_metric)
    try:
        yield
    finally:
        _tls.sink = prev


# ---------------------------------------------------------------------------
# the sites
# ---------------------------------------------------------------------------

def note_build(label: str, ns: int) -> None:
    """kernels/build.py: a kernel library was built (or found built) and
    loaded at first use, taking `ns`. Accrues `compile`, joins the
    enclosing site's build time and emits `program_compile`."""
    from . import phase as obs_phase
    obs_phase.add("compile", ns)
    frames = getattr(_tls, "frames", None)
    if frames:
        frames[-1].build_ns += ns
    sink = getattr(_tls, "sink", None)
    if sink is not None and sink[1] is not None:
        sink[1].add(ns)
    led = _ledger
    storm = led.note_build(label, ns) if led is not None else None
    from . import events as obs_events
    if obs_events.active_bus() is not None:
        obs_events.emit("program_compile", label=label, compile_ns=ns,
                        donated_bytes=0)
        if storm is not None:
            obs_events.emit(storm[0], **storm[1])


class _Frame:
    __slots__ = ("calls", "build_ns", "bucket")

    def __init__(self):
        self.calls = 0
        self.build_ns = 0
        self.bucket = ()

    def count(self, n: int = 1) -> None:
        """The site launched `n` kernels (call after each launch)."""
        self.calls += n


class _Off:
    __slots__ = ()

    def count(self, n: int = 1) -> None:
        pass


_OFF = _Off()


def _push() -> "_Frame":
    frames = getattr(_tls, "frames", None)
    if frames is None:
        frames = _tls.frames = []
    f = _Frame()
    frames.append(f)
    return f


def _pop(f: "_Frame") -> None:
    frames = _tls.frames
    frames.pop()
    if frames:
        frames[-1].build_ns += f.build_ns


def _bound(led: DispatchLedger, label: str, device) -> None:
    """Wait for the site's device work under the ledger's hang bound."""
    from ..exec import speculation_shield as shield
    shield.await_ready(shield.cuda_ready(device), led.timeout_ms,
                       shield.current_dispatch_domain(), label)


@contextmanager
def kernel_site(label: str, shape, device):
    """Wrap one kernel wrapper's CUDA branch; the body calls `.count()`
    on the yielded frame after each launch. Records one ledger call per
    counted launch when the body completes; a body that raises records
    nothing (its wrapper counted no launch either)."""
    led = _ledger
    if led is None:
        yield _OFF
        return
    from ..exec import lifecycle
    from . import phase as obs_phase
    lifecycle.note_engagement(label)
    f = _push()
    t0 = time.perf_counter_ns()
    ok = False
    try:
        if obs_phase.in_span():
            yield f
            if led.timeout_ms:
                _bound(led, label, device)
        else:
            with obs_phase.span("device-compute"):
                yield f
                if led.timeout_ms:
                    _bound(led, label, device)
        ok = True
    finally:
        wall = time.perf_counter_ns() - t0
        _pop(f)
        if ok and f.calls:
            led.record(label, "kernel", shape_bucket(shape),
                       getattr(device, "type", str(device)), f.calls,
                       wall, f.build_ns)
            sink = getattr(_tls, "sink", None)
            if sink is not None:
                sink[0].add(f.calls)


@contextmanager
def exec_scope(label: str, device_type: str):
    """Wrap one batch pull of an exec: a `device-compute` span whose self
    time (children's pulls, waits and builds excluded) is the ledger
    call's wall. The body sets `.bucket` on the yielded frame from the
    batch it produced; a pull that ended the stream records nothing."""
    led = _ledger
    if led is None:
        yield None
        return
    from . import phase as obs_phase
    f = _push()
    t0 = time.perf_counter_ns()
    stack = obs_phase._stack()
    try:
        with obs_phase.span("device-compute"):
            frame = stack[-1]
            yield f
            if led.timeout_ms and device_type == "cuda":
                _bound(led, label, "cuda")
            nested = frame[1]
    finally:
        _pop(f)
    if f.calls:
        self_ns = time.perf_counter_ns() - t0 - nested
        led.record(label, "exec", f.bucket, device_type,
                   f.calls, max(0, self_ns), f.build_ns)
