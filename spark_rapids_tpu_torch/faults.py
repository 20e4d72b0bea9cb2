"""Cross-layer fault subsystem — the counterpart of
spark_rapids_tpu/faults.py: one registry of named fault points, one
seeded deterministic injection surface, and one error taxonomy for
everything that can die at runtime besides OOM.

* **Fault points** (`FAULT_POINTS`) name the async and IO seams the
  engine crosses: spill byte movement, shuffle fetch and decode,
  multi-file reads, the guarded device sections, pipeline producers.
  Each call site runs `apply(point)` / `apply(point, data)`; with
  injection off that is one module-global pointer check.

* **Injection** is driven by one conf
  (`spark.rapids.tpu.test.faults = "<point>:prob=P,seed=S,kind=K[,max=N][,ms=N][;...]"`,
  kind in io|device|corrupt|delay) and keyed on (task id, work-item key,
  per-sequence call index): the decision is a pure hash of
  (seed, point, task, key, index), the JAX package's exactly, so one
  spec injects at the same calls in both packages. Sites on pool or
  producer threads pass their work item as the key (a chunk index, a
  map-file:partition pair, a stage label, a spill entry's registration
  ordinal).

* **Taxonomy.** `classify()` maps an exception into "oom" | "task" |
  "fatal":
  - "oom": the retry framework's TpuOOMError family and the card's
    allocator failure (`torch.OutOfMemoryError`);
  - "task": TpuTaskRetryError (integrity failures among them) and the
    injected io and device look-alikes — a re-execution from the
    sources is expected to clear them (exec/task_retry.py);
  - "fatal": everything else, CUDA runtime errors included. The JAX
    package retries any non-OOM XLA runtime error; the port does not
    (ROADMAP C): an illegal address or a failed launch leaves a sticky
    error that poisons the CUDA context for the rest of the process, so
    an in-process retry cannot clear it, and retrying a kernel that
    fails to build or load would only hide a broken kernel.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, Optional

#: the closed registry: point name -> (site, what an injected fault means)
FAULT_POINTS: Dict[str, str] = {
    "spill.d2h_copy": "device->host copy of a spilling buffer "
                      "(memory/catalog.py, sync + async writeback)",
    "spill.disk_write": "host->disk spill file write "
                        "(memory/catalog.py write_spill_file)",
    "spill.disk_read": "disk->host spill file read "
                       "(memory/catalog.py read_spill_file)",
    "shuffle.fetch": "shuffle block segment fetch "
                     "(shuffle/manager.py HostShuffleReader)",
    "shuffle.decode": "shuffle frame decode "
                      "(shuffle/manager.py read_partition)",
    "io.multifile_read": "multi-file decode task "
                         "(io/multifile.py threaded_chunks)",
    "device.dispatch": "guarded device section (memory/retry.py "
                       "oom_guard), the packed upload's one copy "
                       "(columnar/upload.py) and a compiled stage's step "
                       "(exec/base.TpuExec.batch_harness)",
    "pipeline.produce": "pipeline producer step "
                        "(exec/pipeline.py PipelinedIterator)",
    "shuffle.skew_split": "adaptive skew-split sub-read frame "
                          "(shuffle/manager.py read_partition_maps)",
    "shuffle.ici_exchange": "a round of the host exchange's device lane "
                            "(exec/exchange.py _ici_exchange_round)",
}

KINDS = ("io", "device", "corrupt", "delay")


# ---------------------------------------------------------------------------
# error taxonomy
# ---------------------------------------------------------------------------

class TpuTaskRetryError(RuntimeError):
    """Transient non-OOM failure: the current task attempt is lost but a
    re-execution from the sources is expected to succeed (the engine
    analog of a Spark task-attempt failure)."""

    #: what was lost ({"kind": "spill_file", "handle"}, ...) or None
    provenance = None


class IntegrityError(TpuTaskRetryError):
    """Checksum mismatch on a spill file or shuffle block: the bytes are
    quarantined, the only recovery is recomputation (task retry)."""


class QueryStalledError(TpuTaskRetryError):
    """The progress watchdog (exec/speculation_shield.py) declared this
    attempt's driving seam stalled under `stall.action=retry-seam`: the
    attempt is abandoned at its next cancellation checkpoint and re-runs
    on the bounded task-retry lane."""


class DispatchTimeoutError(TpuTaskRetryError):
    """A launched kernel was not done inside `dispatch.timeoutMs`
    (exec/speculation_shield.timed_call): the attempt re-runs on the
    task-retry lane. The kernel keeps its stream busy, so the retry
    queues behind it (ROADMAP C.16)."""


class InjectedIOError(OSError):
    """Injected `kind=io` fault (a transient OSError look-alike)."""

    def __init__(self, point: str):
        import errno
        super().__init__(errno.EIO, f"injected io fault at {point}")
        self.fault_point = point


class InjectedDeviceError(RuntimeError):
    """Injected `kind=device` fault (a transient device-error
    look-alike)."""

    def __init__(self, point: str):
        super().__init__(f"injected device fault at {point}")
        self.fault_point = point


def is_task_transient(exc: BaseException) -> bool:
    """Errors a task re-execution is expected to clear: the injected
    look-alikes (an io one that escaped a site with no io-retry lane of
    its own, such as pipeline.produce) and TpuTaskRetryError (integrity
    failures). A real OSError stays fatal: it already exhausted the
    bounded IO retry or names a non-transient condition. A CUDA error
    stays fatal (module docstring)."""
    return isinstance(exc, (TpuTaskRetryError, InjectedDeviceError,
                            InjectedIOError))


def classify(exc: BaseException) -> str:
    """"oom" | "task" | "fatal" — the one classification the OOM-retry
    loop (memory/retry.py) and the task-attempt layer
    (exec/task_retry.py) consult."""
    from .memory.retry import TpuOOMError, is_oom_error
    if isinstance(exc, TpuOOMError) or is_oom_error(exc):
        return "oom"
    if is_task_transient(exc):
        return "task"
    return "fatal"


# ---------------------------------------------------------------------------
# injection plan
# ---------------------------------------------------------------------------

class _PointSpec:
    __slots__ = ("point", "prob", "seed", "kind", "max_injections",
                 "delay_ms")

    def __init__(self, point: str, prob: float, seed: int, kind: str,
                 max_injections: Optional[int], delay_ms: int = 0):
        self.point = point
        self.prob = prob
        self.seed = seed
        self.kind = kind
        self.max_injections = max_injections
        #: kind=delay only: injected latency per firing (ms)
        self.delay_ms = delay_ms


class FaultPlan:
    """Parsed injection plan. Decisions are pure in (seed, point,
    task_id, key, call_index); the per-(point, task, key) call counters
    live here so the k-th guarded call of a task draws the same verdict
    on every replay."""

    def __init__(self, specs: Dict[str, _PointSpec], spec_string: str = ""):
        self.specs = specs
        #: the conf string this plan was parsed from: configure() keeps
        #: ONE plan alive across task re-executions of the same run
        self.spec_string = spec_string
        self._lock = threading.Lock()
        self._calls: Dict[tuple, int] = {}
        #: injections actually fired, per point
        self.injected: Dict[str, int] = {}

    def _task_id(self) -> int:
        from .memory.retry import current_task_id
        tid = current_task_id()
        return 0 if tid is None else int(tid)

    def decide(self, point: str, corruptible: bool = True,
               key: Optional[str] = None) -> Optional[str]:
        """The armed kind if this call injects, else None. Always
        consumes one call index for (point, task, key), but an armed
        `corrupt` kind at a call with no bytes flowing
        (`corruptible=False`) is not fired: it would perturb nothing, so
        it consumes no budget and emits nothing."""
        spec = self.specs.get(point)
        if spec is None:
            return None
        task = self._task_id()
        with self._lock:
            ckey = (point, task, key)
            idx = self._calls.get(ckey, 0)
            self._calls[ckey] = idx + 1
            if spec.kind == "corrupt" and not corruptible:
                return None
            fired = self.injected.get(point, 0)
            if spec.max_injections is not None \
                    and fired >= spec.max_injections:
                return None
            draw = zlib.crc32(
                f"{spec.seed}:{point}:{task}:{key or ''}:{idx}"
                .encode()) / 2 ** 32
            if draw >= spec.prob:
                return None
            self.injected[point] = fired + 1
        from .obs import events as obs_events
        obs_events.emit("fault_inject", point=point, fault_kind=spec.kind,
                        task_id=task, call_index=idx, seed=spec.seed,
                        key=key)
        return spec.kind

    def apply(self, point: str, data: Optional[bytes] = None,
              key: Optional[str] = None) -> Optional[bytes]:
        kind = self.decide(
            point, corruptible=data is not None and len(data) > 0,
            key=key)
        if kind is None:
            return data
        if kind == "io":
            raise InjectedIOError(point)
        if kind == "device":
            raise InjectedDeviceError(point)
        if kind == "delay":
            # a deterministic straggler: the call blocks for the armed
            # ms and proceeds with its data untouched
            import time
            time.sleep(self.specs[point].delay_ms / 1000.0)
            return data
        pos = zlib.crc32(f"pos:{point}:{len(data)}".encode()) % len(data)
        out = bytearray(data)
        out[pos] ^= 0xFF
        return bytes(out)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.injected)


def parse_faults(spec: str) -> Optional[FaultPlan]:
    """Parse the conf grammar:
    `<point>:prob=P,seed=S,kind=io|device|corrupt|delay[,max=N][,ms=N]
    [;<point>:...]`. Unknown points, kinds or options fail loudly."""
    spec = (spec or "").strip()
    if not spec:
        return None
    specs: Dict[str, _PointSpec] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        point, _, kvs = part.partition(":")
        point = point.strip()
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r}; known: "
                             f"{sorted(FAULT_POINTS)}")
        prob, seed, kind, max_inj, delay_ms = 1.0, 0, "io", None, 0
        for kv in kvs.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            k, v = k.strip(), v.strip()
            if k == "prob":
                prob = float(v)
            elif k == "seed":
                seed = int(v)
            elif k == "kind":
                if v not in KINDS:
                    raise ValueError(f"unknown fault kind {v!r} for "
                                     f"{point}; known: {KINDS}")
                kind = v
            elif k == "max":
                max_inj = int(v)
            elif k == "ms":
                delay_ms = int(v)
            else:
                raise ValueError(f"unknown fault option {k!r} for {point}")
        if kind == "delay" and delay_ms <= 0:
            raise ValueError(f"kind=delay for {point} requires ms=N > 0")
        specs[point] = _PointSpec(point, prob, seed, kind, max_inj,
                                  delay_ms=delay_ms)
    return FaultPlan(specs, spec) if specs else None


# ---------------------------------------------------------------------------
# process-wide activation (the one-pointer-check fast path)
# ---------------------------------------------------------------------------

_PLAN: Optional[FaultPlan] = None
_plan_lock = threading.Lock()


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def install(spec: Optional[str]) -> Optional[FaultPlan]:
    """Install (or with None/empty, clear) the process fault plan from a
    spec string."""
    global _PLAN
    plan = parse_faults(spec) if spec else None
    with _plan_lock:
        _PLAN = plan
    return plan


def configure(conf=None) -> Optional[FaultPlan]:
    """(Re)configure injection from a RapidsConf — the session and
    collect hook. A conf that does not mention spark.rapids.tpu.test.faults
    leaves the current plan alone (a default-conf session must not disarm
    another session's run); an explicit empty value clears it. The same
    spec keeps the armed plan: re-installing would reset the call
    counters and budgets, so every task re-execution would replay the
    faults that killed the previous attempt."""
    from .config import TEST_FAULTS, active_conf
    conf = conf if conf is not None else active_conf()
    if TEST_FAULTS.key not in conf._settings:
        return _PLAN
    spec = (conf.get(TEST_FAULTS) or "").strip()
    cur = _PLAN
    if cur is not None and cur.spec_string == spec:
        return cur
    return install(spec)


def apply(point: str, data: Optional[bytes] = None,
          key: Optional[str] = None) -> Optional[bytes]:
    """The one call every fault-point site makes. Injection off =
    exactly this pointer check."""
    plan = _PLAN
    if plan is None:
        return data
    return plan.apply(point, data, key=key)


def check(point: str, key: Optional[str] = None) -> None:
    """apply() for data-free sites."""
    plan = _PLAN
    if plan is not None:
        plan.apply(point, key=key)


def stats() -> Dict[str, int]:
    """Per-point injection counts of the active plan ({} when off)."""
    plan = _PLAN
    return plan.stats() if plan is not None else {}


def backoff_s(attempt: int, base_ms: int, cap_ms: int,
              jitter_key: str) -> float:
    """Capped exponential backoff with deterministic jitter, shared by
    the retry lanes: min(base * 2^(attempt-1), cap) plus up to 25%
    jitter that is a pure hash of `jitter_key`."""
    ms = min(base_ms * (1 << (attempt - 1)), cap_ms)
    frac = zlib.crc32(jitter_key.encode()) / 2 ** 32
    return ms * (1.0 + 0.25 * frac) / 1000.0


def uniform_spec(prob: float, seed: int, points=None) -> str:
    """A spec arming every (or the given) fault point at one probability
    with the JAX package's per-point kinds: corruption where checksums
    guard the read path, device faults at the device sections, io
    everywhere else."""
    default_kind = {
        "device.dispatch": "device",
        "spill.d2h_copy": "device",
        "pipeline.produce": "io",
        "spill.disk_read": "io",
        "spill.disk_write": "corrupt",
        "shuffle.decode": "corrupt",
        "shuffle.fetch": "io",
        "shuffle.ici_exchange": "device",
        "shuffle.skew_split": "corrupt",
        "io.multifile_read": "io",
    }
    parts = []
    for point in (points or sorted(FAULT_POINTS)):
        parts.append(f"{point}:prob={prob},seed={seed},"
                     f"kind={default_kind.get(point, 'io')}")
    return ";".join(parts)
