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

Program sites (`ProgramSite`, built by `instrument` through
`TpuExec._site`) are the counterpart of the JAX package's
`InstrumentedJit`: a compiled stage's body (exec/stage_compiler.py) and,
on the card, one CUDA graph per static key (the arguments' shapes and
scalar values), captured after the key's first, eager call and replayed
after. A graph records the kernel sites its capture saw and adds their
launches and ledger calls on each replay, so a label's calls still equal
its wrapper's `launches`; a capture records no call (the wrappers'
counts made while it recorded are taken back). Each site call is one
ledger call of kind "stage"; a capture is a build (`note_build`: the
`compile` phase, `traces`, `program_compile`). The
process-wide site cache, keyed by (label, plan fingerprint) and bounded
by spark.rapids.tpu.stage.programCache.maxSites (least recently used
first), hands a later collect()'s rebuilt stage the sites and graphs an
equal plan built (`site_cache_counters`: sites, hits, misses). A
graph's bytes (the segments of its private pool, found by pool id in
the allocator's snapshot, and its static inputs) count against the
device budget; the budget's pressure path drops the graphs no run holds
(`drop_cached_graphs`). The kernel wrappers name themselves to their
sites (`kernel_site(..., counter=)`), so this module imports none of
them.

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
    "shape_bucket", "ProgramSite", "SiteRun", "instrument",
    "site_cache_counters", "reset_site_cache", "graph_counters",
    "drop_cached_graphs", "clone_value", "launch_tally",
    "cached_graphs",
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
    loaded at first use, taking `ns`; or a program site captured a CUDA
    graph. Accrues `compile`, joins the enclosing site's build time and
    emits `program_compile`."""
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
def kernel_site(label: str, shape, device, counter=None):
    """Wrap one kernel wrapper's CUDA branch; the body calls `.count()`
    on the yielded frame after each launch. Records one ledger call per
    counted launch when the body completes; a body that raises records
    nothing (its wrapper counted no launch either). `counter` is the
    wrapper whose `launches` the body counts on: a graph capture takes
    back what the body counted there and each replay adds it again."""
    led = _ledger
    capture = getattr(_tls, "capture", None)
    if capture is not None:
        # inside a graph capture nothing launches: the graph records the
        # site's launches and adds them on each replay (ProgramSite)
        f = _Frame()
        yield f
        if f.calls:
            capture.kernels.append((label, shape_bucket(shape),
                                    getattr(device, "type", str(device)),
                                    f.calls, counter))
        return
    tally = getattr(_tls, "tally", None)
    if led is None:
        if tally is None:
            yield _OFF
            return
        f = _Frame()
        yield f
        _tally(label, f.calls)
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
            _tally(label, f.calls)
            led.record(label, "kernel", shape_bucket(shape),
                       getattr(device, "type", str(device)), f.calls,
                       wall, f.build_ns)
            sink = getattr(_tls, "sink", None)
            if sink is not None:
                sink[0].add(f.calls)


def _tally(label: str, calls: int) -> None:
    tally = getattr(_tls, "tally", None)
    if tally is not None and calls:
        tally[label] = tally.get(label, 0) + calls


@contextmanager
def launch_tally():
    """The kernel launches made on this thread inside the block, by site
    label (a replayed graph's included), in the yielded dict; tallies
    nest."""
    prev = getattr(_tls, "tally", None)
    tally: Dict[str, int] = {}
    _tls.tally = tally
    try:
        yield tally
    finally:
        _tls.tally = prev
        if prev is not None:
            for k, v in tally.items():
                prev[k] = prev.get(k, 0) + v


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


# ---------------------------------------------------------------------------
# program sites: one CUDA graph per site and static key, cached by plan
# fingerprint (the counterpart of the JAX package's InstrumentedJit and
# its plan-fingerprint site cache)
# ---------------------------------------------------------------------------

class _Capture:
    """The kernel launches a capture recorded (kernel_site, on this
    thread): (label, bucket, device type, calls, counter) each."""

    __slots__ = ("kernels",)

    def __init__(self):
        self.kernels: List[Tuple[str, Tuple, str, int, Any]] = []


def flatten(value, leaves: List) -> Any:
    """The tensors of `value` appended to `leaves`; returns the static
    structure, hashable, that `unflatten` rebuilds the value from with
    other tensors. Only what crosses a stage site's boundary flattens:
    tensors; host scalars and strings (part of the structure: capacities,
    byte buckets, the candidate bucket); tuples (named ones too), lists
    and dicts; schemas and types, by signature; batches (their columns
    and device row count: a rebuilt batch counts its rows on the device);
    columns (their `leaves()`); and objects whose class names its fields
    in `_site_fields` (a join's build table). Anything else raises
    TypeError."""
    import torch
    from ..columnar.batch import ColumnarBatch
    from ..columnar.column import Column
    from ..types import DataType, Schema
    if isinstance(value, torch.Tensor):
        leaves.append(value)
        return ("T", tuple(value.shape), value.dtype, value.device.type)
    if value is None or isinstance(value, (bool, int, float, str,
                                           torch.dtype)):
        return ("V", value)
    if isinstance(value, (tuple, list)):
        return (type(value), tuple(flatten(v, leaves) for v in value))
    if isinstance(value, dict):
        return (dict, tuple((k, flatten(v, leaves))
                            for k, v in value.items()))
    if isinstance(value, (Schema, DataType)):
        return ("S", value)
    if isinstance(value, ColumnarBatch):
        return (ColumnarBatch,
                tuple(flatten(c, leaves) for c in value.columns),
                flatten(value.num_rows, leaves), ("S", value.schema))
    if isinstance(value, Column):
        return ("C", type(value), value.dtype,
                tuple(flatten(t, leaves) for t in value.leaves()))
    fields = getattr(type(value), "_site_fields", None)
    if fields is None:
        raise TypeError(f"a stage site's argument or result holds a "
                        f"{type(value).__name__}, which does not flatten")
    return ("O", type(value),
            tuple((n, flatten(getattr(value, n), leaves)) for n in fields))


def unflatten(spec, leaves) -> Any:
    """flatten's inverse over the tensors `leaves` (an iterator)."""
    from ..columnar.batch import ColumnarBatch
    tag = spec[0]
    if tag == "T":
        return next(leaves)
    if tag in ("V", "S"):
        return spec[1]
    if isinstance(tag, type) and issubclass(tag, (tuple, list)):
        items = [unflatten(s, leaves) for s in spec[1]]
        # a named tuple rebuilds from its fields
        return tag._make(items) if hasattr(tag, "_make") else tag(items)
    if tag is dict:
        return {k: unflatten(s, leaves) for k, s in spec[1]}
    if tag is ColumnarBatch:
        cols = [unflatten(s, leaves) for s in spec[1]]
        return ColumnarBatch(cols, unflatten(spec[2], leaves), spec[3][1])
    if tag == "C":
        return spec[1].from_leaves(spec[2], [unflatten(s, leaves)
                                             for s in spec[3]])
    out = object.__new__(spec[1])
    for name, s in spec[2]:
        setattr(out, name, unflatten(s, leaves))
    return out


def _tensors(value):
    """The tensors of `value` in flatten's order, other objects skipped
    (a site that is never captured may take an exec): where such a call
    runs, and its ledger shape, without flattening it."""
    import torch
    from ..columnar.batch import ColumnarBatch
    from ..columnar.column import Column
    if isinstance(value, torch.Tensor):
        yield value
        return
    if isinstance(value, (tuple, list)):
        items = value
    elif isinstance(value, dict):
        items = value.values()
    elif isinstance(value, ColumnarBatch):
        items = list(value.columns) + [value.num_rows]
    elif isinstance(value, Column):
        items = value.leaves()
    else:
        items = [getattr(value, n)
                 for n in getattr(type(value), "_site_fields", ())]
    for v in items:
        yield from _tensors(v)


def _key_of(spec) -> Any:
    """The hashable cache key of a flattened structure: schemas and types
    by their signatures, classes by name."""
    from ..types import DataType, Schema
    if isinstance(spec, tuple):
        return tuple(_key_of(s) for s in spec)
    if isinstance(spec, Schema):
        return tuple((f.name, f.data_type.simple_name(), f.nullable)
                     for f in spec.fields)
    if isinstance(spec, DataType):
        return spec.simple_name()
    if isinstance(spec, type):
        return spec.__name__
    return spec


def clone_value(value):
    """`value` with every tensor cloned: what outlives a graph's next
    replay (an output a consumer keeps) is cloned first."""
    leaves: List = []
    spec = flatten(value, leaves)
    return unflatten(spec, iter([t.clone() for t in leaves]))


class _Graph:
    """One captured graph of a site: its static inputs, its outputs (in
    its private memory pool) and the kernel launches each replay makes."""

    __slots__ = ("graph", "static_in", "out_spec", "static_out", "kernels",
                 "gathers", "pool_bytes", "budget", "site", "key",
                 "fixed_seen")

    #: pool_bytes: the segments of the graph's private pool and its
    #: static inputs, counted against the device budget

    def __init__(self, site, key):
        self.site = site
        self.key = key
        self.graph = None
        self.static_in: List = []
        self.out_spec = None
        self.static_out: List = []
        self.kernels: List[Tuple[str, Tuple, str, int, Any]] = []
        #: the gather engine's counts one run of the body adds
        self.gathers: Dict[str, int] = {}
        self.pool_bytes = 0
        #: the device budget the pool's bytes were reserved in
        self.budget = None
        #: per fixed argument position, the tensors copied in this run
        self.fixed_seen: Dict[int, List] = {}


_graph_lock = threading.Lock()
#: id(graph) -> graph: graphs not held by a run, least recently used first
_free_graphs: "Dict[int, _Graph]" = {}
_graph_counters = {"captures": 0, "replays": 0, "eager_steps": 0,
                   "eager_calls": 0, "dropped": 0, "pool_bytes": 0,
                   "capture_ns": 0, "over_budget": 0}
#: the eager cause of a step whose graph the device budget cannot hold
OVER_BUDGET = "graph pool over the device budget"


def graph_counters() -> Dict[str, int]:
    """Process counters of the program sites: graphs captured and
    replayed, steps run eagerly on the card (`eager_steps`: a body that
    reads the host, or a graph the budget cannot hold), calls on the CPU
    (`eager_calls`), graphs dropped under memory pressure, graphs not kept
    because the device budget could not hold them (`over_budget`), the
    bytes the live graphs' pools hold."""
    with _graph_lock:
        return dict(_graph_counters)


def _note_graph(**deltas) -> None:
    with _graph_lock:
        for k, v in deltas.items():
            _graph_counters[k] += v


def drop_cached_graphs(nbytes: Optional[int] = None, budget=None) -> int:
    """Drop graphs that no run holds, least recently used first, until
    `nbytes` of their pools are freed (None: all of them); with `budget`,
    only the graphs whose pools were reserved in it. Their bytes leave the
    budget they were reserved in. Returns the bytes freed."""
    freed = 0
    while nbytes is None or freed < nbytes:
        with _graph_lock:
            g = next((g for g in _free_graphs.values()
                      if budget is None or g.budget is budget), None)
            if g is None:
                break
            _free_graphs.pop(id(g))
        freed += g.site._discard(g)
    return freed


class ProgramSite:
    """One stage body and, on the card, one CUDA graph per static key.

    The key is the structure of the call's arguments (their tensors'
    shapes and types, and every other value: capacities, byte buckets,
    the candidate bucket). Calls go through a `SiteRun` (`run()`), one per
    stage execution, which holds the graphs it replays: a graph's outputs
    and state stay its run's until the run closes, so two executions of
    one plan never replay one graph in turns.

    A call with a CUDA tensor and a graphable body: the first call of a
    key in the process runs the body eagerly on the current stream (that
    call's result: real launches, counted as launched) and then captures
    it into a graph on a side stream (`capture_error_mode="thread_local"`:
    the scan's producer and the upload stream keep running). Later calls
    copy their tensors into the graph's static inputs and replay it: one
    replay, whose kernel launches are added to each wrapper's `launches`
    and to the ledger as the capture recorded them. A body that reads the
    host is not graphable (`graph=False`, with its `cause`), nor is a call
    whose inputs make it read the host (`cause_of(*args)` names why): it
    runs eagerly on the card, one composed step, counted in `eager_steps`. A
    capture that fails raises; nothing carries on eagerly. On the CPU
    every call runs the body (`eager_calls`).

    The graph's bytes (its private pool's segments and its static
    inputs) count against the device budget until the graph is dropped (memory pressure, the site cache's bound, a reset);
    an OOM during a capture discards the partial graph and raises into
    the retry lane. A graph the budget cannot hold after its spills is
    not kept: that key's steps run eagerly (`OVER_BUDGET`) while the
    budget has no room for its pool."""

    def __init__(self, fn, label: str, owner=None, graph: bool = True,
                 cause: Optional[str] = None, cause_of=None):
        self.label = label
        self._fn = fn
        self._owner = owner
        self.graph = graph
        self.cause = cause
        #: args -> None, or why this call's body reads the host (a
        #: property of its inputs, such as a string column that arrived
        #: decoded); such a call runs eagerly
        self.cause_of = cause_of
        self._lock = threading.Lock()
        #: key -> graphs of that key no run holds
        self._free: Dict[Any, List[_Graph]] = {}
        #: key -> pool bytes of a graph the device budget could not hold
        self._over_budget: Dict[Any, int] = {}
        self.captures = 0
        self.replays = 0
        #: calls through any run (replays, eager steps, CPU calls)
        self.calls = 0

    def rebind(self, owner, fn, cause_of=None) -> None:
        """A cached site handed to a rebuilt exec of an equal plan: its
        calls count on the new owner's metrics, through its own body."""
        self._owner = owner
        self._fn = fn
        self.cause_of = cause_of

    def run(self) -> "SiteRun":
        return SiteRun(self)

    # -- graphs ---------------------------------------------------------
    def _budget_room(self, key) -> bool:
        """False while this key's last graph did not fit the device
        budget and the budget still has no room for its pool."""
        with self._lock:
            need = self._over_budget.get(key)
        if need is None:
            return True
        from ..memory.budget import memory_budget
        budget = memory_budget()
        return budget.limit - budget.used >= need

    def _checkout(self, key) -> Optional[_Graph]:
        with self._lock:
            free = self._free.get(key)
            g = free.pop() if free else None
        if g is not None:
            with _graph_lock:
                _free_graphs.pop(id(g), None)
            g.fixed_seen = {}
        return g

    def _checkin(self, g: _Graph) -> None:
        # an idle graph keeps no reference to its last run's constants
        g.fixed_seen = {}
        with self._lock:
            self._free.setdefault(g.key, []).append(g)
        with _graph_lock:
            _free_graphs[id(g)] = g

    def _discard(self, g: _Graph) -> int:
        """Drop a graph no run holds (one a run checked out meanwhile is
        left alone: 0 freed); its pool leaves the budget."""
        with self._lock:
            free = self._free.get(g.key)
            if free is None or g not in free:
                return 0
            free.remove(g)
        with _graph_lock:
            _free_graphs.pop(id(g), None)
        g.fixed_seen = {}
        freed = g.pool_bytes
        if g.graph is not None:
            g.graph.reset()
            g.graph = None
            g.static_in, g.static_out = [], []
            if g.budget is not None:
                g.budget.release(freed)
            _note_graph(dropped=1, pool_bytes=-freed)
        return freed

    def drop_graphs(self) -> None:
        with self._lock:
            graphs = [g for gs in self._free.values() for g in gs]
        for g in graphs:
            self._discard(g)

    def _capture(self, key, spec, leaves, dev) -> _Graph:
        import torch
        g = _Graph(self, key)
        static = [torch.empty_like(t) for t in leaves]
        args = unflatten(spec, iter(static))
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        rec = _Capture()
        prev = getattr(_tls, "capture", None)
        _tls.capture = rec
        from ..ops import gather as ops_gather
        graph = torch.cuda.CUDAGraph()
        gathers0 = ops_gather.counters()
        t0 = time.perf_counter_ns()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = self._fn(*args)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is invalid: the body's error raises
                    raise
                graph.capture_end()
        except BaseException:
            graph.reset()
            raise
        finally:
            _tls.capture = prev
            # the capture launched nothing: take back what the wrappers
            # counted while it recorded
            for _l, _b, _d, calls, counter in rec.kernels:
                if counter is not None:
                    counter.launches -= calls
        cur.wait_stream(side)
        g.graph = graph
        g.static_in = static
        g.kernels = rec.kernels
        g.gathers = {k: v - gathers0[k]
                     for k, v in ops_gather.counters().items()}
        outs: List = []
        g.out_spec = flatten(out, outs)
        g.static_out = outs
        g.pool_bytes = _graph_pool_bytes(graph) + sum(
            t.untyped_storage().nbytes() for t in static)
        ns = time.perf_counter_ns() - t0
        from ..memory.budget import memory_budget
        from ..memory.retry import TpuRetryOOM
        budget = memory_budget()
        try:
            budget.reserve(g.pool_bytes)
            g.budget = budget
        except TpuRetryOOM:
            # the budget spilled what it could and still cannot hold the
            # graph's pool (a pool takes whole allocator segments, so even
            # a small step's can pass a small budget): the graph is not
            # kept, and this key's steps run eagerly while the budget has
            # no room for it. This call's result came from its eager run.
            graph.reset()
            with self._lock:
                self._over_budget[key] = g.pool_bytes
            _note_graph(over_budget=1)
            return None
        except BaseException:
            graph.reset()
            raise
        with self._lock:
            self._over_budget.pop(key, None)
        self.captures += 1
        _note_graph(captures=1, pool_bytes=g.pool_bytes, capture_ns=ns)
        note_build(self.label, ns)
        return g

    def _replay(self, g: _Graph, leaves, fixed) -> Any:
        for i, (s, t) in enumerate(zip(g.static_in, leaves)):
            if i in fixed:
                seen = g.fixed_seen.get(i)
                if seen is not None and seen[0] is t:
                    continue
                g.fixed_seen[i] = [t]
            if t is not s:
                s.copy_(t)
        g.graph.replay()
        self.replays += 1
        _note_graph(replays=1)
        from ..ops import gather as ops_gather
        ops_gather.add_counts(g.gathers)
        led = _ledger
        sink = getattr(_tls, "sink", None)
        from ..exec import lifecycle
        for label, bucket, dev_type, calls, counter in g.kernels:
            if counter is not None:
                counter.launches += calls
            _tally(label, calls)
            lifecycle.note_engagement(label)
            if led is not None:
                led.record(label, "kernel", bucket, dev_type, calls, 0, 0)
                if sink is not None:
                    sink[0].add(calls)
        if led is not None and led.timeout_ms:
            _bound(led, self.label, g.static_in[0].device)
        return unflatten(g.out_spec, iter(g.static_out))


def _graph_pool_bytes(graph) -> int:
    """The bytes of the allocator segments in `graph`'s private pool."""
    import torch
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == pool)


class SiteRun:
    """One execution's calls of a site (ProgramSite.run): the graphs it
    captured or checked out stay its own until `close()`. Arguments at the
    positions in `fixed` are the run's constants (a join's build table):
    a graph copies them in on its first replay of the run only."""

    def __init__(self, site: ProgramSite):
        self.site = site
        self._held: Dict[Any, _Graph] = {}
        #: whether the last call replayed a graph (its outputs are the
        #: graph's buffers until the next call or close)
        self.replayed = False
        #: why the last call ran eagerly on the card (None: it did not)
        self.eager_cause: Optional[str] = None

    def __enter__(self) -> "SiteRun":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        held, self._held = self._held, {}
        for g in held.values():
            self.site._checkin(g)

    def __call__(self, *args, fixed: Tuple[int, ...] = ()):
        site = self.site
        site.calls += 1
        owner = site._owner
        if owner is not None:
            m = owner.metrics.get(NUM_DISPATCHES)
            if m is not None:
                m.add(1)
        t0 = time.perf_counter_ns()
        self.replayed = False
        self.eager_cause = None
        leaves: List = []
        fixed_leaves = set()
        if site.graph:
            specs = []
            for i, a in enumerate(args):
                start = len(leaves)
                specs.append(flatten(a, leaves))
                if i in fixed:
                    fixed_leaves.update(range(start, len(leaves)))
            spec = (tuple, tuple(specs))
            tensors = leaves
        else:
            tensors = _tensors(args)  # never captured: not flattened
        first = dev = None
        for t in tensors:
            first = t if first is None else first
            if t.is_cuda:
                dev = t.device
                break
        cause = None
        if dev is not None:
            cause = site.cause if not site.graph else (
                site.cause_of(*args) if site.cause_of is not None else None)
        if dev is None or cause is not None:
            out = site._fn(*args)
            if dev is None:
                _note_graph(eager_calls=1)
            else:
                _note_graph(eager_steps=1)
                self.eager_cause = cause
            self._record(first, dev, t0, 0)
            return out
        key = _key_of(spec)
        g = self._held.get(key)
        if g is None:
            if not site._budget_room(key):
                out = site._fn(*args)
                _note_graph(eager_steps=1)
                self.eager_cause = OVER_BUDGET
                self._record(first, dev, t0, 0)
                return out
            g = site._checkout(key)
            if g is None:
                # the first call of this key: its result comes from the
                # eager run, then the body is captured for the later calls
                out = site._fn(*args)
                g = site._capture(key, spec, leaves, dev)
                if g is not None:
                    self._held[key] = g
                self._record(first, dev, t0, time.perf_counter_ns() - t0)
                return out
            self._held[key] = g
        out = site._replay(g, leaves, fixed_leaves)
        self.replayed = True
        self._record(first, dev, t0, 0)
        return out

    def _record(self, first, dev, t0: int, build_ns: int) -> None:
        led = _ledger
        if led is None:
            return
        shape = tuple(first.shape[:1]) if first is not None else ()
        led.record(self.site.label, "stage", shape_bucket(shape),
                   dev.type if dev is not None else "cpu", 1,
                   time.perf_counter_ns() - t0, build_ns)


_site_cache_lock = threading.Lock()
#: (label, cache key) -> ProgramSite, least recently used first
_site_cache: Dict[Tuple[str, Any], ProgramSite] = {}
_site_cache_hits = 0
_site_cache_misses = 0


def _site_cache_max() -> int:
    from ..config import STAGE_PROGRAM_CACHE_ENTRIES, active_conf
    return max(0, int(active_conf().get(STAGE_PROGRAM_CACHE_ENTRIES)))


def instrument(fn, label: str, owner=None, cache_key=None,
               graph: bool = True, cause: Optional[str] = None,
               cause_of=None) -> ProgramSite:
    """A program site for `fn` (TpuExec._site): with a `cache_key` (the
    owner's plan fingerprint) the process-wide cache hands a rebuilt exec
    of an equal plan the site, and its graphs, an earlier one built;
    bounded by spark.rapids.tpu.stage.programCache.maxSites, least
    recently used first (an evicted site's graphs are dropped)."""
    global _site_cache_hits, _site_cache_misses
    limit = _site_cache_max()
    if cache_key is None or limit <= 0:
        return ProgramSite(fn, label, owner, graph, cause, cause_of)
    key = (label, cache_key)
    with _site_cache_lock:
        site = _site_cache.pop(key, None)
        if site is not None:
            _site_cache[key] = site  # re-append: most recently used
            _site_cache_hits += 1
    if site is not None:
        site.rebind(owner, fn, cause_of)
        return site
    site = ProgramSite(fn, label, owner, graph, cause, cause_of)
    evicted = []
    with _site_cache_lock:
        _site_cache_misses += 1
        _site_cache[key] = site
        while len(_site_cache) > limit:
            evicted.append(_site_cache.pop(next(iter(_site_cache))))
    for s in evicted:
        s.drop_graphs()
    return site


def site_cache_counters() -> Dict[str, int]:
    """The program-site cache's activity: sites held, hits, misses."""
    with _site_cache_lock:
        return {"sites": len(_site_cache), "hits": _site_cache_hits,
                "misses": _site_cache_misses}


def cached_graphs() -> List[Dict[str, Any]]:
    """The idle graphs of the cached sites: per graph its site's label,
    its pool bytes and the kernel launches one replay makes, by label."""
    with _site_cache_lock:
        sites = list(_site_cache.values())
    out = []
    for site in sites:
        with site._lock:
            graphs = [g for gs in site._free.values() for g in gs]
        for g in graphs:
            kernels: Dict[str, int] = {}
            for label, _b, _d, calls, _c in g.kernels:
                kernels[label] = kernels.get(label, 0) + calls
            out.append({"label": site.label, "pool_bytes": g.pool_bytes,
                        "kernels": kernels})
    return out


def reset_site_cache() -> None:
    """Drop every cached site and its idle graphs (test isolation; exec
    trees already built keep the sites they hold). The ledger's reset
    leaves them: a cached graph's replays count into a fresh ledger."""
    global _site_cache_hits, _site_cache_misses
    with _site_cache_lock:
        sites = list(_site_cache.values())
        _site_cache.clear()
        _site_cache_hits = 0
        _site_cache_misses = 0
    for s in sites:
        s.drop_graphs()
