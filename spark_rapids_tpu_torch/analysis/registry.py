"""THE rule registry of the port's contract analyzer — the counterpart of
spark_rapids_tpu/analysis/registry.py: rule metadata plus the engine
contract data the rules check against — named locks with reentrancy and
a declared partial order, the thread-local adopt helpers, the
cross-query entry points whose call paths must not read `active_conf`,
the paired accounting calls that must stay symmetric, and the calls that
block or read the card from the host.

The data names the PORT's modules (`scope_prefix` is
"spark_rapids_tpu_torch/"). One registry, lint-checked three ways by
tests/test_torch_contract_check.py: README's port rule table lists
exactly RULES, every lock/entry/pair spec names a real port module, and
every rule fires on a fixture.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, List, Optional, Tuple


class LockSpec:
    """One named engine lock. `expr` is the acquisition expression as
    written at the hold sites (`with self._lock:`), `cls` scopes it to
    a class (None = module-global name)."""

    __slots__ = ("name", "module", "cls", "expr", "reentrant", "note")

    def __init__(self, name: str, module: str, cls: Optional[str],
                 expr: str, reentrant: bool, note: str):
        self.name = name
        self.module = module
        self.cls = cls
        self.expr = expr
        self.reentrant = reentrant
        self.note = note


class EntrySpec:
    """A function that runs on a producer/cross-query thread (or on an
    arbitrary caller's thread servicing OTHER queries' state): conf
    reads along its module-local call paths must ride a captured
    conf/Ticket, never the executing thread's `active_conf`."""

    __slots__ = ("module", "cls", "func", "note")

    def __init__(self, module: str, cls: Optional[str], func: str,
                 note: str):
        self.module = module
        self.cls = cls
        self.func = func
        self.note = note


class PairSpec:
    """Registry-declared paired accounting calls. `escrow` maps a
    function qualname to the justification for holding the obligation
    open past its own frame (ownership transfer)."""

    __slots__ = ("name", "open_attr", "close_attr", "receiver_hint",
                 "modules", "escrow")

    def __init__(self, name: str, open_attr: str, close_attr: str,
                 receiver_hint: str, modules: Tuple[str, ...],
                 escrow: Dict[str, str]):
        self.name = name
        self.open_attr = open_attr
        self.close_attr = close_attr
        self.receiver_hint = receiver_hint
        self.modules = modules
        self.escrow = escrow


class ContractRegistry:
    """The data half of the registry. Tests run rules against a fixture
    instance; the CLI and tier-1 use DEFAULT_REGISTRY."""

    def __init__(self, locks: List[LockSpec], lock_order: List[str],
                 cross_query_entries: List[EntrySpec],
                 pairs: List[PairSpec],
                 adopt_helpers: Iterable[str],
                 extra_blocking_calls: Dict[str, str],
                 scope_prefix: str = "spark_rapids_tpu_torch/"):
        #: path substring gating the package-wide rules (thread/trace/
        #: stage): chip_smoke.py is a script — module scope IS its main —
        #: so the engine registry scopes those rules to the package;
        #: fixture registries pass "" to run them anywhere
        self.scope_prefix = scope_prefix
        self.locks = locks
        #: outermost-first acquisition order; acquiring a lock that
        #: sorts EARLIER than one already held is a lock-order finding
        self.lock_order = lock_order
        self.cross_query_entries = cross_query_entries
        self.pairs = pairs
        self.adopt_helpers = frozenset(adopt_helpers)
        #: cross-module calls known to block (module-level walks cannot
        #: see into them): callable name -> why it blocks
        self.extra_blocking_calls = dict(extra_blocking_calls)

    def locks_for(self, relpath: str) -> List[LockSpec]:
        return [s for s in self.locks if relpath.endswith(s.module)]

    def entries_for(self, relpath: str) -> List[EntrySpec]:
        return [e for e in self.cross_query_entries
                if relpath.endswith(e.module)]

    def pairs_for(self, relpath: str) -> List[PairSpec]:
        return [p for p in self.pairs
                if any(relpath.endswith(m) for m in p.modules)]


#: attribute calls that block (or do IO, or read the card from the host)
#: regardless of receiver
BLOCKING_ATTRS = frozenset({
    "wait", "join", "sleep", "fsync", "savez", "result",
    "synchronize", "item", "tolist", "cpu", "numpy",
})
#: .get()/.put() block only on queue-like receivers (dict.get is not IO)
QUEUE_BLOCKING_ATTRS = frozenset({"get", "put"})
QUEUE_RECEIVER_RE = re.compile(r"(^|\.)_?(write_)?q(ueue)?$")
#: bare-name calls that do IO
BLOCKING_NAMES = frozenset({"open"})
#: `.emit(...)` on an event-bus-ish receiver: the bus takes its own lock
#: and writes a file, never do that under an engine lock
EMIT_RECEIVER_HINTS = ("events", "bus")

#: thread-local capture/adopt helpers a spawned target must route
#: through (conf, query id, speculation scope, task attempt, lifecycle
#: context, breaker engagement)
ADOPT_HELPERS = frozenset({
    "set_active_conf", "adopt_query_id", "adopt_context",
    "adopt_attempt", "adopt_engagement", "query_scope",
    # pool-thread wrapper (obs.events): submit(with_query_id, qid, fn, ...)
    "with_query_id",
})

#: host reads of the card: a body captured into a CUDA graph must make
#: none (attribute calls on a tensor or a module)
HOST_SYNC_ATTRS = frozenset({
    "item", "tolist", "cpu", "numpy", "synchronize",
})
#: the port's packed host copies (columnar/transfer.py), by name
HOST_SYNC_NAMES = frozenset({
    "fetch_batch_host", "fetch_split_host",
})

#: torch calls that build a tensor (the module-scope rule's targets)
TENSOR_FACTORIES = frozenset({
    "tensor", "as_tensor", "asarray", "from_numpy", "frombuffer",
    "zeros", "ones", "empty", "full", "arange", "range", "linspace",
    "logspace", "eye", "rand", "randn", "randint", "randperm",
    "zeros_like", "ones_like", "empty_like", "full_like",
    "empty_strided",
})


class RuleMeta:
    __slots__ = ("id", "family", "bug_class", "origin", "example",
                 "checker")

    def __init__(self, id: str, family: str, bug_class: str, origin: str,
                 example: str, checker: Optional[Callable]):
        self.id = id
        self.family = family
        self.bug_class = bug_class
        self.origin = origin
        self.example = example
        self.checker = checker


def _build_rules() -> Dict[str, RuleMeta]:
    from . import (rules_accounting, rules_bounded, rules_conf,
                   rules_dispatch, rules_locks, rules_registry,
                   rules_stage, rules_threads, rules_trace)
    rules = [
        RuleMeta(
            "lock-blocking-call", "lock-discipline",
            "blocking call (IO, wait, queue op, event emit, a host read "
            "of the card, a copy across the link) reachable while a "
            "registered engine lock is held",
            "the JAX package's review rounds (admission events under the "
            "manager condition; the writer drain under the catalog lock)",
            "obs_events.emit(...) inside `with self._lock:`",
            rules_locks.check_blocking),
        RuleMeta(
            "lock-reacquire", "lock-discipline",
            "re-acquisition of a non-reentrant lock along a "
            "module-local call path",
            "the heartbeat manager's register-under-its-own-lock deadlock",
            "method holding self._lock calls a method that takes it",
            rules_locks.check_reacquire),
        RuleMeta(
            "lock-order", "lock-discipline",
            "acquiring a lock that sorts EARLIER in the declared "
            "partial order than one already held",
            "declared order (registry.lock_order), the writer/catalog "
            "deadlock analysis",
            "taking the catalog lock while holding the event-bus lock",
            rules_locks.check_order),
        RuleMeta(
            "bounded-wait", "lock-discipline",
            "unbounded blocking rendezvous — wait/get/result/sleep "
            "with no positional args and no timeout= keyword parks "
            "its thread beyond every watchdog, deadline and "
            "cancellation poll",
            "the straggler and stall shield: stalls it cannot observe "
            "cannot be mitigated",
            "self._done.wait() / fut.result() with no timeout",
            rules_bounded.check),
        RuleMeta(
            "thread-adopt", "thread-propagation",
            "threading.Thread / pool submit whose target never routes "
            "through the thread-local capture/adopt helpers",
            "conf, query id, speculation, attempt and engagement "
            "adoption at every producer boundary",
            "threading.Thread(target=self._loop) with no adopt_* in "
            "_loop",
            rules_threads.check),
        RuleMeta(
            "trace-module-tensor", "trace-purity",
            "module-level torch.<factory>(...) binding in the package — "
            "builds a tensor at import, on the device the import picked "
            "rather than the caller's explicit one (and a CUDA context "
            "on a card)",
            "the JAX package's trace-module-jnp (module-level constants "
            "capturing a tracer), in the port's idiom: the explicit-"
            "device rule",
            "_C1 = torch.tensor(0xcc9e2d51) at module scope",
            rules_trace.check_module_tensor),
        RuleMeta(
            "trace-host-sync", "trace-purity",
            "host read (.item(), .tolist(), .cpu(), .numpy(), "
            "synchronize, a packed host copy) inside a body handed to "
            "instrument()/_site() for capture into a CUDA graph",
            "the stage compiler's runtime trap (a graphed body reads "
            "nothing on the host), checked statically",
            "int(flag.item()) inside a fn passed to self._site(...)",
            rules_trace.check_host_sync),
        RuleMeta(
            "conf-provenance", "conf-provenance",
            "active_conf() read reachable from a producer-thread or "
            "cross-query entry point — the value must ride a captured "
            "conf or the admitting Ticket",
            "the JAX package's release cap, quota fraction and breaker "
            "consult, which all read the CALLING thread's conf",
            "active_conf().get(...) inside the spill-writer's reach",
            rules_conf.check),
        RuleMeta(
            "accounting-symmetry", "accounting-symmetry",
            "registry-declared paired calls (reserve/release, "
            "charge/discharge) unbalanced: open with no close on any "
            "path, or an exception edge that drops the close",
            "budget counters left asymmetric on failure branches, quota "
            "charge/discharge mirrors",
            "memory_budget().reserve(n) with no release on the raise "
            "path",
            rules_accounting.check),
        RuleMeta(
            "conf-key-registered", "registry-drift",
            "full spark.rapids.* conf-key literal not present in the "
            "port's config registry",
            "the docs lint, folded into the analyzer",
            '"spark.rapids.tpu.sucht.nicht" anywhere in code',
            rules_registry.check_conf_keys),
        RuleMeta(
            "event-kind-registered", "registry-drift",
            "emit() with a literal event kind missing from the port's "
            "obs.events.EVENT_LEVELS (it would silently default to "
            "MODERATE and never reach the schema table)",
            "the docs lint (EVENT_LEVELS registry)",
            'obs_events.emit("not_a_kind", ...)',
            rules_registry.check_event_kinds),
        RuleMeta(
            "dispatch-ledger", "dispatch-discipline",
            "kernel launch (a wrapper's `launches +=`, a `*_run` entry "
            "point of a library kernels/build.py loaded, a launcher) "
            "outside a `with kernel_site(...)` block that counts it, or "
            "a torch.cuda.CUDAGraph / torch.cuda.graph outside "
            "obs/dispatch.py — the ledger's calls stop equalling the "
            "launches",
            "the dispatch and compile observability plane, retargeted "
            "from jax.jit / pallas_call sites to kernel launches and "
            "graph captures",
            "lib.m3_run(...) in a wrapper with no kernel_site",
            rules_dispatch.check),
        RuleMeta(
            "stage-governance", "dispatch-discipline",
            "per-batch governance hook (lifecycle tick, chaos fault "
            "point, metric timer, event emit, gather observe, breaker "
            "engagement) inside a stage body handed to the program-site "
            "chokepoint — it runs at the graph capture, not on a "
            "replay, so it is silently dead on a warm stage; hooks "
            "belong in the stage-boundary harness",
            "whole-stage compilation: governance extracted to the stage "
            "boundary",
            "faults.check(...) inside a fn passed to instrument()",
            rules_stage.check),
        RuleMeta(
            "suppression-empty", "analyzer-meta",
            "a `# contract: ok` suppression with no justification, or "
            "naming a rule that does not exist",
            "justification required, linted non-empty",
            "# contract: ok lock-blocking-call —",
            None),
        RuleMeta(
            "baseline-invalid", "analyzer-meta",
            "a baseline entry with an empty/UNREVIEWED justification "
            "or a non-positive count",
            "baselined findings carry a why, like suppressions",
            '{"count": 0, "why": ""}',
            None),
    ]
    return {r.id: r for r in rules}


RULES: Dict[str, RuleMeta] = _build_rules()

#: rule families (README's port rule table groups by these)
FAMILIES = tuple(dict.fromkeys(r.family for r in RULES.values()))


DEFAULT_REGISTRY = ContractRegistry(
    locks=[
        LockSpec("catalog", "memory/catalog.py", "BufferCatalog",
                 "self._lock", reentrant=True,
                 note="3-tier spill store registry (RLock: the writer's "
                 "finalize re-enters via _recover_dead_writer_locked)"),
        LockSpec("budget-cond", "memory/budget.py", "MemoryBudget",
                 "self._lock", reentrant=False,
                 note="device budget state (reserve/release/waiters; a "
                 "plain Lock in the port, where the JAX package's is a "
                 "Condition)"),
        LockSpec("workload-cond", "exec/workload.py", "WorkloadManager",
                 "self._cond", reentrant=True,
                 note="admission queue + quota accounting condition"),
        LockSpec("semaphore-cond", "memory/semaphore.py", "_FairPermits",
                 "self._cond", reentrant=True,
                 note="fair permit registry condition"),
        LockSpec("semaphore", "memory/semaphore.py", "TpuSemaphore",
                 "self._lock", reentrant=False,
                 note="per-task hold table"),
        LockSpec("breaker", "exec/lifecycle.py", None, "_breaker_lock",
                 reentrant=False,
                 note="circuit-breaker domain state"),
        LockSpec("heartbeat", "parallel/heartbeat.py",
                 "HeartbeatManager", "self._lock", reentrant=False,
                 note="peer table (the register deadlock class lived "
                 "here in the JAX package)"),
        LockSpec("telemetry", "obs/telemetry.py", "TelemetryRegistry",
                 "self._lock", reentrant=False,
                 note="counter + ring-buffer state"),
        LockSpec("telemetry-config", "obs/telemetry.py", None,
                 "_registry_lock", reentrant=False,
                 note="registry singleton install/teardown"),
        LockSpec("stats", "obs/stats.py", "ExchangeStats", "self._lock",
                 reentrant=False, note="per-exchange distribution state"),
        LockSpec("stats-global", "obs/stats.py", None, "_global_lock",
                 reentrant=False, note="process-wide stats collector"),
        LockSpec("dispatch-ledger", "obs/dispatch.py", "DispatchLedger",
                 "self._lock", reentrant=False,
                 note="program-stats registry (events buffered under "
                 "it, emitted after it drops)"),
        LockSpec("dispatch-config", "obs/dispatch.py", None,
                 "_ledger_lock", reentrant=False,
                 note="ledger singleton install/teardown"),
        LockSpec("phase-global", "obs/phase.py", None, "_global_lock",
                 reentrant=False,
                 note="process-cumulative per-phase ns counters"),
        LockSpec("phase-ledger", "obs/phase.py", "PhaseLedger",
                 "self._lock", reentrant=False,
                 note="per-query phase books (direct/folded maps)"),
        LockSpec("event-bus-config", "obs/events.py", None, "_bus_lock",
                 reentrant=False, note="bus singleton install/teardown"),
        LockSpec("event-bus", "obs/events.py", "EventBus", "self._lock",
                 reentrant=False,
                 note="JSONL sink write serialization (leaf lock: nothing "
                 "may be acquired under it)"),
        LockSpec("history-config", "obs/history.py", None, "_store_lock",
                 reentrant=False,
                 note="history store singleton install/teardown"),
        LockSpec("history", "obs/history.py", "HistoryStore",
                 "self._lock", reentrant=False,
                 note="capsule JSONL sink write serialization (leaf "
                 "lock, the event-bus pattern)"),
        # -- the port's own engine locks (no JAX counterpart) -----------
        LockSpec("site-cache", "obs/dispatch.py", None, "_site_cache_lock",
                 reentrant=False,
                 note="the plan-fingerprint program-site cache"),
        LockSpec("program-site", "obs/dispatch.py", "ProgramSite",
                 "self._lock", reentrant=False,
                 note="one site's captured graphs by static key"),
        LockSpec("graph", "obs/dispatch.py", None, "_graph_lock",
                 reentrant=False,
                 note="process-wide graph counters and pool bytes"),
        LockSpec("cache", "exec/cache.py", "CachedRelation", "self._lock",
                 reentrant=False,
                 note="a cached relation's single materialization"),
        LockSpec("stage-counters", "exec/stage_compiler.py", None,
                 "_COUNTER_LOCK", reentrant=False,
                 note="stage compiler counters and shared sizing caches"),
        LockSpec("adaptive-counters", "exec/adaptive.py", None,
                 "_COUNTER_LOCK", reentrant=False,
                 note="adaptive join decision counters"),
        LockSpec("shield-counters", "exec/speculation_shield.py", None,
                 "_counter_lock", reentrant=False,
                 note="speculation-shield counters (leaf lock)"),
        LockSpec("shield-slot", "exec/speculation_shield.py", None,
                 "_slot_lock", reentrant=False,
                 note="the watchdog's progress slot and dispatch domain"),
        LockSpec("read-speculation", "exec/speculation_shield.py",
                 "ReadSpeculation", "self._lock", reentrant=False,
                 note="per-reader fetch-latency histograms"),
        LockSpec("task-retry", "exec/task_retry.py", None, "_retry_lock",
                 reentrant=False, note="task-retry counters"),
        LockSpec("lifecycle-registry", "exec/lifecycle.py", None,
                 "_reg_lock", reentrant=False,
                 note="the live QueryContext registry"),
        LockSpec("lifecycle-counters", "exec/lifecycle.py", None,
                 "_counter_lock", reentrant=False,
                 note="lifecycle counters (leaf lock)"),
        LockSpec("workload-config", "exec/workload.py", None,
                 "_manager_lock", reentrant=False,
                 note="workload manager singleton install/teardown"),
        LockSpec("staging-pool", "columnar/upload.py", "StagingPool",
                 "self._lock", reentrant=False,
                 note="the pinned staging buffers by byte bucket"),
        LockSpec("staging-pool-config", "columnar/upload.py", None,
                 "_POOL_LOCK", reentrant=False,
                 note="staging pool singleton install/resize"),
        LockSpec("upload-stream", "columnar/upload.py", None,
                 "_STREAM_LOCK", reentrant=False,
                 note="the per-device upload side streams"),
        LockSpec("upload-counters", "columnar/upload.py", None,
                 "_COUNTER_LOCK", reentrant=False,
                 note="upload counters (leaf lock)"),
        LockSpec("shuffle-manager", "shuffle/manager.py",
                 "HostShuffleManager", "self._lock", reentrant=False,
                 note="registered shuffles and their map outputs"),
        LockSpec("shuffle-manager-config", "shuffle/manager.py", None,
                 "_MANAGER_LOCK", reentrant=False,
                 note="shuffle manager singleton install/teardown"),
        LockSpec("shuffle-counters", "shuffle/manager.py", None,
                 "_COUNTER_LOCK", reentrant=False,
                 note="shuffle counters (leaf lock)"),
        LockSpec("exchange-counters", "parallel/exchange.py", None,
                 "_LOCK", reentrant=False,
                 note="all-to-all counters (leaf lock)"),
    ],
    # outermost-first: a lock may only be acquired while holding locks
    # that sort strictly BEFORE it
    lock_order=[
        "catalog", "workload-config", "workload-cond", "budget-cond",
        "semaphore-cond", "semaphore", "heartbeat", "cache",
        "shuffle-manager-config", "shuffle-manager",
        "staging-pool-config", "staging-pool", "upload-stream",
        "read-speculation", "shield-slot", "breaker",
        "lifecycle-registry", "task-retry", "site-cache", "program-site",
        "graph", "telemetry-config", "telemetry", "stats", "stats-global",
        "dispatch-config", "dispatch-ledger", "phase-global",
        "phase-ledger", "stage-counters", "adaptive-counters",
        "shield-counters", "lifecycle-counters", "upload-counters",
        "shuffle-counters", "exchange-counters", "event-bus-config",
        "event-bus", "history-config", "history",
    ],
    cross_query_entries=[
        EntrySpec("memory/catalog.py", "BufferCatalog", "_writer_loop",
                  "spill-writer thread serves every query's hops"),
        EntrySpec("memory/catalog.py", "BufferCatalog",
                  "_recover_dead_writer_locked",
                  "drains OTHER queries' stranded hops on the "
                  "detecting thread"),
        EntrySpec("memory/catalog.py", "BufferCatalog",
                  "synchronous_spill",
                  "a neighbor's reserve pressure spills THIS query's "
                  "entries on the neighbor's thread"),
        EntrySpec("memory/semaphore.py", "TpuSemaphore", "__init__",
                  "process singleton sized by whichever thread "
                  "constructs it first"),
        EntrySpec("exec/workload.py", "WorkloadManager", "release",
                  "releasing thread pumps grants for OTHER queries "
                  "(the release-cap bug class lived here)"),
        EntrySpec("exec/workload.py", "WorkloadManager", "charge",
                  "mirrors catalog accounting from any spilling thread"),
        EntrySpec("exec/workload.py", "WorkloadManager", "discharge",
                  "mirrors catalog accounting from any spilling thread"),
        EntrySpec("obs/telemetry.py", "TelemetryRegistry", "_loop",
                  "sampler thread carries no query context"),
        EntrySpec("parallel/heartbeat.py", "HeartbeatEndpoint", "_loop",
                  "heartbeat daemon carries no query context"),
        EntrySpec("io/multifile.py", None, "retrying",
                  "shared decode-pool worker (conf must ride the "
                  "captured closure, never the pool thread's TLS)"),
    ],
    pairs=[
        PairSpec(
            # add() is deliberately NOT escrowed here: its reserve has
            # no release in-frame AND no guarding except — the window
            # between reserve and registration is accepted debt,
            # carried in the baseline with its justification
            "hbm-budget", "reserve", "release", receiver_hint="budget",
            modules=("memory/catalog.py",),
            escrow={}),
        PairSpec(
            "workload-quota", "charge", "discharge",
            receiver_hint="workload",
            modules=("memory/catalog.py",),
            escrow={
                "BufferCatalog.add":
                    "quota charge mirrors the entry's budget reserve; "
                    "remove()/writeback discharges it",
                "BufferCatalog._unspill_locked":
                    "the promotion's last fallible step: the DEVICE-tier "
                    "entry owns the charge from there, and remove()/a "
                    "spill discharges it",
            }),
    ],
    adopt_helpers=ADOPT_HELPERS,
    extra_blocking_calls={
        "upload_leaves": "host->device copy through pinned staging",
        "to_device_batch": "host columns -> one packed upload",
        "fetch_batch_host": "device->host packed copy of a batch",
        "fetch_split_host": "device->host packed copy of a split",
        "with_io_retry": "file IO with bounded retry + backoff sleeps",
        "synchronous_spill": "spill pass: d2h copies / disk writes (or "
                             "writer-queue hand-off) per victim",
        "shutdown": "joins a worker/sampler thread on teardown",
    },
)
