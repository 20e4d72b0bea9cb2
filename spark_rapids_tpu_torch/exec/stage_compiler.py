"""Whole-stage compilation — the counterpart of
spark_rapids_tpu/exec/stage_compiler.py: one CUDA graph per compiled stage
and static shape, with a plan-fingerprint program cache.

The JAX package jits one program per pipeline stage. Its counterpart here
is a program site (obs/dispatch.ProgramSite) per stage body: on the card
the first call of a static key runs the body eagerly and captures it into
a `torch.cuda.CUDAGraph`, and every later call copies its tensors into
the graph's static inputs and replays it, so a step of many launches is
one replay. On the CPU a site calls the body: the same bodies, eagerly.

1. **The stage planner.** `compile_stages(root)` walks the converted
   TpuExec tree top-down and groups maximal chains of `FUSABLE_OPS` into
   CompiledStageExec nodes, with the JAX package's three kinds:

   * ``map``: a Filter/Project/Expand chain of two or more ops. One step
     per input batch evaluates every projection, ANDs every filter into
     one row mask and compacts once (a string column keeps its input's
     byte bucket, which a filter never outgrows: no host read). Its
     outputs live in the graph's buffers and are cloned before they
     leave the stage.
   * ``agg``: an AggregateExec that absorbed a filter/project chain. The
     speculative step (`AggregateExec._streaming_step`, the fused
     scan-aggregate kernel inside it on q1) reads nothing on the host: one
     graph replay per input batch, its running state carried from replay
     to replay in the graph's own buffers (the counterpart of
     donate_argnums). The exact step keeps C.2's host read of `leftover`
     and runs eagerly, the same composed step.
   * ``join_agg``: an inner HashJoinExec's probe and the aggregate above
     it as one step per stream batch. The build table is computed on the
     first step (eagerly: its sort and pack read the host) and carried.
     Candidate sizing follows the join's speculative size cache, shared
     process-wide by fingerprint: a cold step makes one sizing read and
     then calls the step site, a warm step reads nothing and is one
     replay; the step's overflow flag goes to the speculation scope at
     the stage boundary. With the exact aggregate the probe is the
     graphed step and the aggregate's update runs eagerly after it.

   Other operators break a stage and keep their execs, and so does a
   filter, projection or expand that holds a Python UDF (ROADMAP C.18):
   folded into a chain, the UDF would be called on the rows an earlier
   filter only masked. It runs as its own exec over its child's
   compacted output, and no chain reaches past it; the aggregate's
   absorption stops there too (`AggregateExec`).

2. **The program cache.** Sites are built through `TpuExec._site` with
   the owner's plan fingerprint (`fingerprint_node`: class x semantic
   extras x output schema x children's fingerprints x the trace-affecting
   conf digest), so a later collect()'s rebuilt stage gets the same site
   and replays the graphs the first one captured: a second collect()
   captures nothing.

Governance lives at the stage boundary (`TpuExec.batch_harness`), never
inside a captured body: the cancel check and the `device.dispatch` fault
point per step; the site adds the dispatch metric, the replayed launches
and gathers, and the hang bound after each replay. An open
`device_dispatch` breaker demotes a stage to per-operator execution over
the same sources (`fallbacks`): those execs launch the same hand-written
kernels on the card; nothing goes to a plain version.

A body that reads the host cannot be captured; it runs eagerly, one
composed step, counted under `graph_ineligible` by its cause (ROADMAP C.17
lists them). A capture that fails raises.
"""

from __future__ import annotations

import functools
import hashlib
import re
import threading
import time
import types
from typing import Dict, List, Optional, Tuple

import torch

from ..columnar.batch import ColumnarBatch, empty_batch
from ..types import (ArrayType, BinaryType, DataType, MapType, Schema,
                     StringType, StructType)
from .base import AGG_TIME, NUM_DISPATCHES, TpuExec
from .basic import run_spillable

NUM_OUTPUT_BATCHES = "numOutputBatches"

__all__ = [
    "CompiledStageExec", "compile_stages", "fingerprint_node",
    "trace_conf_digest", "schema_sig", "semantic_key", "counters",
    "reset_stage_counters", "FUSABLE_OPS",
]

#: the fusion whitelist: operator class -> how it fuses into a stage step.
#: Everything else breaks the stage.
FUSABLE_OPS: Dict[str, str] = {
    "FilterExec": "row mask ANDed into the stage step (one compaction per "
                  "stage, not one gather per filter)",
    "ProjectExec": "expression evaluation inlined into the stage step",
    "ExpandExec": "all projections emitted from one step per input batch "
                  "(grouping sets)",
    "HashJoinExec": "inner-join probe fused into the consuming aggregate's "
                    "per-stream-batch step; the build table is computed "
                    "on the first step and carried",
    "AggregateExec": "masked-bucket update folded into state carried in "
                     "the graph's buffers (complete/partial modes), "
                     "evaluated in the step",
}

# -- bodies that read the host: the causes counted under graph_ineligible --

CAUSE_EXACT = "exact-tier group-by reads leftover (C.2)"
CAUSE_BUILD = "join build: sort and pack read the host"
CAUSE_VARWIDTH = "string or nested columns: host-bounded loops (C.6)"
CAUSE_DECODE = "decode of an encoded column the aggregate reads"
CAUSE_SIZING = "cold join sizing reads the candidate total"
CAUSE_UDF = "a Python UDF evaluates on the host"
CAUSE_WINDOWED = "a probe past one pass reads its window edges (C.20)"


# ---------------------------------------------------------------------------
# process counters
# ---------------------------------------------------------------------------

_COUNTER_LOCK = threading.Lock()
_COUNTERS = {"stages_fused": 0, "ops_fused": 0, "executions": 0,
             "fallbacks": 0, "dispatches": 0, "batches": 0,
             "cold_sizings": 0, "windowed_steps": 0}
#: cause -> eager steps run on the card for it
_INELIGIBLE: Dict[str, int] = {}
#: kernel label -> launches made by cold sizing passes (a step that
#: measures its candidates runs the counts once more than per-operator)
_SIZING_LAUNCHES: Dict[str, int] = {}


def _note(**deltas) -> None:
    with _COUNTER_LOCK:
        for k, v in deltas.items():
            _COUNTERS[k] += v


def counters() -> Dict:
    """Stage-fusion process counters, the program-site cache's activity
    and the graphs': `graph_captures`, `graph_replays`, `eager_steps` (on
    the card, by cause in `graph_ineligible`), `graph_pool_bytes` (held
    by live graphs), `cold_sizings` and the kernel launches of those
    sizing passes (`sizing_launches`), and `windowed_steps`: join_agg
    steps whose probe took windows (HashJoinExec.probe_windows), eager
    under CAUSE_WINDOWED on the card."""
    from ..obs import dispatch as obs_dispatch
    with _COUNTER_LOCK:
        out: Dict = dict(_COUNTERS)
        out["graph_ineligible"] = dict(_INELIGIBLE)
        out["sizing_launches"] = dict(_SIZING_LAUNCHES)
    sc = obs_dispatch.site_cache_counters()
    out["cache_sites"] = sc["sites"]
    out["cache_hits"] = sc["hits"]
    out["cache_misses"] = sc["misses"]
    g = obs_dispatch.graph_counters()
    out["graph_captures"] = g["captures"]
    out["graph_replays"] = g["replays"]
    out["eager_steps"] = g["eager_steps"]
    out["graph_pool_bytes"] = g["pool_bytes"]
    out["graph_drops"] = g["dropped"]
    return out


def reset_stage_counters() -> None:
    with _COUNTER_LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0
        _INELIGIBLE.clear()
        _SIZING_LAUNCHES.clear()
        _SIZE_CACHES.clear()


#: fingerprint -> {sizing key: [cand_cap, caps, uses]}: the join sizing
#: caches shared by rebuilt equal plans, least recently used first
_SIZE_CACHES: Dict[str, Dict] = {}
_SIZE_CACHE_MAX = 128


def _shared_size_cache(fp: Optional[str]) -> Dict:
    if fp is None:
        return {}
    with _COUNTER_LOCK:
        cache = _SIZE_CACHES.pop(fp, None)
        if cache is None:
            cache = {}
        _SIZE_CACHES[fp] = cache  # re-append: most recently used
        while len(_SIZE_CACHES) > _SIZE_CACHE_MAX:
            _SIZE_CACHES.pop(next(iter(_SIZE_CACHES)))
        return cache


# ---------------------------------------------------------------------------
# plan fingerprints (the program-cache key contract)
# ---------------------------------------------------------------------------

def schema_sig(schema: Schema) -> Tuple:
    """Hashable signature of a schema: name, full type, nullability."""
    return tuple((f.name, f.data_type.simple_name(), bool(f.nullable))
                 for f in schema.fields)


class _Unkeyable(Exception):
    """A value a fingerprint cannot name (a Python function, a large
    tensor): the subtree opts out of the program cache."""


def semantic_key(value):
    """A value-complete, hashable key of an expression (or an aggregate
    function, or a value inside one): its class and every attribute,
    recursively. The JAX package keys expressions by `semantic_key()`
    methods per class; the port walks the attributes, so no parameter can
    be left out. A Python callable (a UDF) or a large tensor raises
    _Unkeyable: such a plan never shares a site."""
    if value is None or isinstance(value, (bool, int, float, str, bytes)):
        return value
    if isinstance(value, (tuple, list)):
        return tuple(semantic_key(v) for v in value)
    if isinstance(value, (set, frozenset)):
        return ("set", tuple(sorted(repr(semantic_key(v)) for v in value)))
    if isinstance(value, dict):
        return ("dict", tuple(sorted((repr(k), repr(semantic_key(v)))
                                     for k, v in value.items())))
    if isinstance(value, DataType):
        return ("type", value.simple_name())
    if isinstance(value, Schema):
        return ("schema", schema_sig(value))
    if isinstance(value, torch.Tensor):
        if value.numel() > 4096:
            raise _Unkeyable("a large tensor constant")
        return ("tensor", str(value.dtype), tuple(value.shape),
                tuple(value.detach().cpu().reshape(-1).tolist()))
    if isinstance(value, (torch.dtype, torch.device)):
        return str(value)
    if isinstance(value, re.Pattern):
        return ("re", value.pattern, value.flags)
    if isinstance(value, type):
        return ("class", value.__module__, value.__qualname__)
    if isinstance(value, _FUNCTION_TYPES):
        raise _Unkeyable(f"a callable {value!r}")
    import numpy as np
    if isinstance(value, np.ndarray):
        if value.size > 4096:
            raise _Unkeyable("a large array constant")
        return ("ndarray", str(value.dtype), value.shape, value.tobytes())
    if isinstance(value, np.generic):
        return value.item()
    cls = type(value)
    items = []
    for c in cls.__mro__:
        for s in getattr(c, "__slots__", ()):
            if s not in ("__weakref__", "__dict__") and hasattr(value, s):
                items.append((s, getattr(value, s)))
    if hasattr(value, "__dict__"):
        items.extend(vars(value).items())
    return (cls.__module__, cls.__qualname__,
            tuple((n, semantic_key(v)) for n, v in items))


_FUNCTION_TYPES = (types.FunctionType, types.MethodType,
                   types.BuiltinFunctionType, functools.partial)


def keys_of(values) -> Optional[Tuple]:
    """semantic_key over values, or None when one cannot be keyed."""
    try:
        return tuple(semantic_key(v) for v in values)
    except _Unkeyable:
        return None


#: conf entries whose values a body can depend on (read at construction
#: by an exec, or at run time by a kernel wrapper): two plans built under
#: different values never share a site
def _digest_entries():
    from .. import config as C
    return (C.FUSION_ENABLED, C.STAGE_FUSION_ENABLED, C.AGG_SPECULATIVE,
            C.AGG_GROUP_SLOTS, C.AGG_ROUNDS, C.BATCH_SIZE_BYTES,
            C.SCAN_ENCODED, C.DECIMAL_ENABLED, C.SORT_OOC_ENABLED)


def trace_conf_digest(conf=None) -> Optional[Tuple]:
    """The body-affecting slice of the active conf as a hashable tuple.
    None when the stage.fusion gate is off (no fingerprints: per-instance
    sites)."""
    from ..config import STAGE_FUSION_ENABLED, active_conf
    conf = conf if conf is not None else active_conf()
    if not conf.get(STAGE_FUSION_ENABLED):
        return None
    return tuple(str(conf.get(e)) for e in _digest_entries())


def fingerprint_node(node: TpuExec, extras) -> Optional[str]:
    """Canonical fingerprint of `node`'s subtree: class name, the node's
    semantic extras, its output-schema signature, every child's
    fingerprint, the conf digest and the device type. Equal fingerprints
    must imply equal bodies: that is the program cache's soundness
    contract."""
    digest = trace_conf_digest()
    if digest is None:
        return None
    child_fps = []
    for c in node.children:
        fp = c.plan_fingerprint()
        if fp is None:
            return None
        child_fps.append(fp)
    dev = node.device
    payload = repr((type(node).__name__, extras,
                    schema_sig(node.output_schema), tuple(child_fps),
                    digest, torch.device(dev).type if dev is not None
                    else "cuda"))
    return hashlib.sha1(payload.encode()).hexdigest()


def _varwidth(dt) -> bool:
    from ..types import DecimalType
    return isinstance(dt, (StringType, BinaryType, ArrayType, MapType,
                           StructType)) or (isinstance(dt, DecimalType)
                                            and dt.is_decimal128)


def _exprs_cause(exprs) -> Optional[str]:
    """Why evaluating `exprs` reads the host, or None: a Python UDF, or a
    node of a string or nested type (the host-bounded loops of C.6)."""
    from ..expr.udf import PythonUDF

    def walk(e) -> Optional[str]:
        if isinstance(e, PythonUDF):
            return CAUSE_UDF
        if _varwidth(e.data_type):
            return CAUSE_VARWIDTH
        for c in e.children:
            got = walk(c)
            if got is not None:
                return got
        return None
    for e in exprs:
        got = walk(e)
        if got is not None:
            return got
    return None


def _refs(e, out: set) -> set:
    from ..expr.core import BoundReference
    if isinstance(e, BoundReference):
        out.add(e.ordinal)
    for c in e.children:
        _refs(c, out)
    return out


def _host_expression(e) -> bool:
    """An expression evaluated through the host (a Python UDF's round
    trip), anywhere in the tree."""
    from ..expr.udf import PythonUDF
    if isinstance(e, PythonUDF):
        return True
    return any(_host_expression(c) for c in e.children)


def holds_python_udf(node) -> bool:
    """True when a fusable operator's step evaluates a Python UDF: such a
    node ends every chain below it (ROADMAP C.18), since a chain masks its
    filters and compacts only at its end."""
    def flat(x):
        return [e for y in x for e in flat(y)] \
            if isinstance(x, (list, tuple)) else [x]
    return any(_host_expression(e) for e in flat(node.stage_step()[1]))


def _note_ineligible(cause: str) -> None:
    with _COUNTER_LOCK:
        _INELIGIBLE[cause] = _INELIGIBLE.get(cause, 0) + 1


# ---------------------------------------------------------------------------
# the fused stage operator
# ---------------------------------------------------------------------------

class CompiledStageExec(TpuExec):
    """One compiled pipeline stage: a whitelisted operator chain whose
    per-batch body is one program-site call (one graph replay on the
    card).

    `children` are the stage's sources (the first non-whitelisted execs
    below the chain); the absorbed operators are kept (`_absorbed`,
    outermost first) for the output schema and the grouping contract, and
    as the per-operator fallback: a demotion (an open `device_dispatch`
    breaker, the empty-input corner) re-drives the original chain root
    over the same sources, so results never depend on the stage engaging.
    Each fused execution emits one `stage_fused` event."""

    def __init__(self, kind: str, absorbed: List[TpuExec],
                 sources: List[TpuExec], join=None, agg=None):
        self._kind = kind
        self._absorbed = list(absorbed)
        self._terminal = absorbed[0]
        self._join = join
        self._agg = agg
        super().__init__(*sources)
        #: sizing key -> [cand_cap, caps, uses]: the join's speculative
        #: sizing, shared by fingerprint so that a rebuilt equal plan
        #: (every collect) stays warm
        self._size_cache = _shared_size_cache(
            self.plan_fingerprint() if kind == "join_agg" else None)
        if kind == "map":
            self._steps = [op.stage_step()
                           for op in reversed(self._absorbed)]
            cause = self._map_cause()
            self._map_site = self._site(
                self._map_body, label="CompiledStageExec.map",
                graph=cause is None, cause=cause)
        elif kind == "agg":
            cause = _exprs_cause(self._agg_exprs())
            self._step_site = self._site(
                self._agg._streaming_step, label="CompiledStageExec.step",
                graph=cause is None, cause=cause)
            self._exact_site = self._site(
                self._agg._update_and_aggregate,
                label="CompiledStageExec.step_exact", graph=False,
                cause=CAUSE_EXACT)
        else:  # join_agg
            self._decode = self._agg_reads_strings()
            cause = self._join_cause()
            self._build_site = self._site(
                self._join.build_table_of, label="CompiledStageExec.build",
                graph=False, cause=CAUSE_BUILD)
            self._sizing_site = self._site(
                self._sizing_body, label="CompiledStageExec.sizing",
                graph=False, cause=CAUSE_SIZING)
            self._step_site = self._site(
                self._ja_spec_body, label="CompiledStageExec.probe_step",
                graph=cause is None, cause=cause,
                cause_of=self._encoded_cause)
            self._probe_site = self._site(
                self._ja_probe_body, label="CompiledStageExec.probe",
                graph=cause is None, cause=cause,
                cause_of=self._encoded_cause)
            self._exact_site = self._site(
                self._agg._update_and_aggregate,
                label="CompiledStageExec.step_exact", graph=False,
                cause=CAUSE_EXACT)
        _note(stages_fused=1, ops_fused=len(self._absorbed))

    # -- TpuExec surface ---------------------------------------------------
    @property
    def output_schema(self) -> Schema:
        return self._terminal.output_schema

    def additional_metrics(self):
        return (AGG_TIME, NUM_DISPATCHES, NUM_OUTPUT_BATCHES)

    @property
    def output_grouped_by(self):
        return self._terminal.output_grouped_by

    @property
    def consumes_encoded(self) -> bool:
        # a map stage runs the absorbed operators' own evaluation; a
        # join_agg stage reads its sources where the join did; an agg
        # stage folds values into state and takes decoded input, as the
        # aggregate does
        if self._kind == "map":
            return all(op.consumes_encoded for op in self._absorbed)
        if self._kind == "join_agg":
            return self._join.consumes_encoded
        return False

    def _fingerprint_extras(self):
        term_fp = self._terminal.plan_fingerprint()
        if term_fp is None:
            return None
        return (self._kind, term_fp)

    def node_description(self) -> str:
        ops = "+".join(type(op).__name__ for op in self._absorbed)
        return f"CompiledStageExec[{self._kind}: {ops}]"

    @property
    def _stage_label(self) -> str:
        return f"{self._kind}:" + \
            "+".join(type(op).__name__ for op in self._absorbed)

    def stage_sites(self) -> List:
        """The stage's program sites (the dispatch summary's programs)."""
        names = {"map": ("_map_site",),
                 "agg": ("_step_site", "_exact_site"),
                 "join_agg": ("_build_site", "_sizing_site", "_step_site",
                              "_probe_site", "_exact_site")}[self._kind]
        return [getattr(self, n) for n in names]

    # -- graph eligibility -------------------------------------------------
    def _map_cause(self) -> Optional[str]:
        schemas = [self.children[0].output_schema] + \
            [op.output_schema for op in self._absorbed]
        if any(_varwidth(f.data_type) for s in schemas for f in s.fields):
            return CAUSE_VARWIDTH
        exprs = []
        for step in self._steps:
            if step[0] == "filter":
                exprs.append(step[1])
            elif step[0] == "project":
                exprs.extend(step[1])
            else:
                exprs.extend(e for bound in step[1] for e in bound)
        return _exprs_cause(exprs)

    def _agg_exprs(self) -> List:
        """The expressions the aggregate evaluates per batch: its absorbed
        chain and its pre-projection."""
        agg = self._agg
        exprs = []
        for step in agg._fused_steps:
            exprs.extend([step[1]] if step[0] == "filter" else step[1])
        return exprs + list(agg._pre_bound)

    def _join_cause(self) -> Optional[str]:
        """Why the probe step reads the host whatever its inputs, or None.
        String keys verify byte spans with a host-bounded loop; predicates
        over string columns must evaluate in code space (their columns
        arriving dictionary-encoded is checked per call,
        `_encoded_cause`); an aggregate that reads a string column of the
        probe's output needs its decode."""
        from ..expr.predicates import encoded_safe_predicate
        join = self._join
        if any(_varwidth(e.data_type)
               for e in join._stream_keys + join._build_keys):
            return CAUSE_VARWIDTH
        preds = [p for p in (join._filters[join._stream_side] or ())]
        if join._cond_bound is not None:
            preds.append(join._cond_bound)
        for p in preds:
            if _host_expression(p):
                return CAUSE_UDF
            if not encoded_safe_predicate(p):
                return _exprs_cause([p])
        if self._decode:
            return CAUSE_DECODE
        steps = self._agg._fused_steps
        first_project = next((i for i, st in enumerate(steps)
                              if st[0] == "project"), None)
        # from the first projection on, the chain reads fixed-width columns
        # only (`_agg_reads_strings` checked what it reads before)
        later = self._agg_exprs() if first_project is None else \
            [e for st in steps[first_project + 1:]
             for e in ([st[1]] if st[0] == "filter" else st[1])] \
            + list(self._agg._pre_bound)
        return _exprs_cause(later)

    def _encoded_cause(self, table, stream_batch, *rest) -> Optional[str]:
        """Per call: a step whose probe takes windows (its candidate bucket
        None) reads their edges; the string columns the stream filters
        and the residual condition read must arrive dictionary-encoded
        (code-space predicates read nothing on the host); a decoded one
        compares byte spans under a host-bounded loop."""
        from ..columnar.encoded import DictionaryColumn
        if rest[-2] is None:
            return CAUSE_WINDOWED
        join = self._join
        s = join._stream_side
        for p in join._filters[s] or ():
            for i in _refs(p, set()):
                c = stream_batch.columns[i]
                if _varwidth(c.dtype) and not isinstance(c, DictionaryColumn):
                    return CAUSE_VARWIDTH
        if join._cond_bound is not None:
            n_left = len(join.children[0].output_schema.fields)
            sides = {s: list(stream_batch.columns),
                     1 - s: list(table.payload)}
            for i in _refs(join._cond_bound, set()):
                side, j = (0, i) if i < n_left else (1, i - n_left)
                c = sides[side][j]
                if _varwidth(c.dtype) and not isinstance(c, DictionaryColumn):
                    return CAUSE_VARWIDTH
        return None

    def _agg_reads_strings(self) -> bool:
        """Whether the aggregate's chain reads a var-width column of the
        probe's output (which may still be dictionary-encoded there, and a
        decode reads the host). Unread columns are dropped by the chain's
        projection and never decode."""
        from ..expr.core import BoundReference
        agg, schema = self._agg, self._join.output_schema
        exprs = []
        for step in agg._fused_steps:
            if step[0] == "filter":
                exprs.append(step[1])
            else:
                exprs.extend(step[1])
                break
        else:
            exprs.extend(agg._pre_bound)
        refs = set()

        def walk(e):
            if isinstance(e, BoundReference):
                refs.add(e.ordinal)
            for c in e.children:
                walk(c)
        for e in exprs:
            walk(e)
        return any(_varwidth(schema.fields[i].data_type) for i in refs)

    # -- engagement / fallback --------------------------------------------
    def _stage_engaged(self) -> bool:
        """An open `device_dispatch` breaker demotes this stage to
        per-operator execution until its cooldown probe closes it; an
        engaged stage notes the domain so that this attempt's transient
        failures count against it."""
        from . import lifecycle
        if not lifecycle.breaker_allows("device_dispatch"):
            return False
        lifecycle.engage_domain("device_dispatch")
        return True

    def _drive_fallback(self):
        _note(fallbacks=1)
        yield from self._terminal.execute()

    def internal_execute(self):
        if not self._stage_engaged():
            yield from self._drive_fallback()
            return
        disp = self.metrics[NUM_DISPATCHES]
        d0 = disp.value
        t0 = time.perf_counter_ns()
        #: [input batches, carried-state bytes], updated as the drive
        #: goes: a consumer that stops early still sees the true counts
        live = self._live_stats = [0, 0]
        if self._kind == "map":
            gen = self._execute_map()
        elif self._kind == "agg":
            gen = self._execute_agg()
        else:
            gen = self._execute_join_agg()
        fell_back = False
        try:
            for item in gen:
                if item is _FALLBACK:
                    # the empty-input corner: the per-operator chain owns
                    # the empty-aggregate semantics
                    fell_back = True
                    yield from self._drive_fallback()
                    return
                self.metrics[NUM_OUTPUT_BATCHES].add(1)
                yield item
        finally:
            gen.close()
            if not fell_back:
                n_in, state_bytes = live
                wall = time.perf_counter_ns() - t0
                if self._kind != "map":
                    self.metrics[AGG_TIME].add(wall)
                d = disp.value - d0
                _note(executions=1, batches=n_in, dispatches=d)
                from ..obs import events as obs_events
                obs_events.emit(
                    "stage_fused", stage=self._kind,
                    label=self._stage_label, ops=len(self._absorbed),
                    batches=n_in, dispatches=d, donated_bytes=state_bytes,
                    wall_ns=wall)

    def _call(self, run, fault_key: str, *args, fixed=()):
        """One step through a site run, under the stage-boundary harness;
        an eager step on the card of a body that reads the host is counted
        under its cause."""
        with self.batch_harness(fault_key=fault_key):
            out = run(*args, fixed=fixed)
        if run.eager_cause is not None:
            _note_ineligible(run.eager_cause)
        return out

    # -- map stage ---------------------------------------------------------
    def _map_body(self, batch: ColumnarBatch):
        """Every projection evaluated, every filter ANDed into one mask, one
        compaction at the end of each output path. Expand fans out: all
        its projections of one input batch come from this one step."""
        from ..ops.basic import compact_columns
        from .basic import eval_projection
        outs: List[ColumnarBatch] = []

        def run(cur, mask, steps):
            for i, step in enumerate(steps):
                if step[0] == "filter":
                    pred = step[1].columnar_eval(cur)
                    m = pred.data & pred.validity
                    mask = m if mask is None else (mask & m)
                elif step[0] == "project":
                    cur = eval_projection(step[1], cur, step[2])
                else:  # expand: fan out over its projections
                    for bound in step[1]:
                        run(eval_projection(bound, cur, step[2]), mask,
                            steps[i + 1:])
                    return
            if mask is None:
                outs.append(cur)
            else:
                cols, n = compact_columns(cur.columns, mask, cur.num_rows)
                outs.append(ColumnarBatch(cols, n, cur.schema))

        run(batch, None, self._steps)
        return tuple(outs)

    def _execute_map(self):
        from ..obs.dispatch import clone_value
        live = self._live_stats
        with self._map_site.run() as run:
            for batch in self.children[0].execute():
                live[0] += 1
                key = f"stage:map:{live[0]}"
                for outs in run_spillable(
                        batch, lambda b: self._call(run, key, b)):
                    if run.replayed:
                        # the graph's buffers: the next replay overwrites
                        # them, and a consumer may hold a batch longer
                        outs = clone_value(outs)
                    yield from outs

    # -- agg stage ---------------------------------------------------------
    def _spec_allowed(self) -> bool:
        from .speculation import speculation_allowed
        agg = self._agg
        return agg._masked_ok and agg._spec_enabled \
            and speculation_allowed()

    def _fresh_state(self, device):
        """A fresh initial state (never a cached one: the graph's carried
        state is overwritten in place replay after replay)."""
        agg = self._agg
        return (empty_batch(agg._buffer_schema, capacity=agg._small_cap(),
                            device=device),
                torch.zeros((), dtype=torch.bool, device=device))

    def _spec_steps(self, run, batches, step_args, kind: str):
        """The speculative drive over (batch, extra args) pairs: one site
        call per input batch folding into the carried state. Returns the
        final (state, flag, evaluated), cloned out of the graph's buffers,
        or None when there was no input."""
        from ..obs.dispatch import clone_value
        live = self._live_stats
        box = None
        for batch in batches:
            live[0] += 1
            if box is None:
                box = list(self._fresh_state(batch.device)) + [None]
            live[1] = _nbytes_of(box[:2])
            key = f"stage:{kind}:{live[0]}"
            for out in run_spillable(batch, lambda b: self._call(
                    run, key, *step_args(b, box[0], box[1]),
                    fixed=(0,) if kind == "join" else ())):
                box[:] = out[:3]
                if len(out) > 3:
                    self._note_join_rows(out[3], run.replayed)
        if box is None:
            return None
        return clone_value(tuple(box)) if run.replayed else tuple(box)

    def _execute_agg(self):
        agg = self._agg
        if self._spec_allowed():
            with self._step_site.run() as run:
                final = self._spec_steps(
                    run, self.children[0].execute(),
                    lambda b, state, flag: (b, state, flag), "agg")
            if final is None:
                yield _FALLBACK
                return
            state, flag, ev = final
            from .speculation import current_scope
            current_scope().record(flag)
            yield state if agg.mode == "partial" else ev
            return
        parts: List = []
        live = self._live_stats
        try:
            with self._exact_site.run() as run:
                for batch in self.children[0].execute():
                    live[0] += 1
                    key = f"stage:agg:{live[0]}"
                    for part in run_spillable(
                            batch, lambda b: self._call(run, key, b)):
                        # the aggregate's own shrink + MERGE_FAN_IN window:
                        # live partials stay bounded under a spill budget
                        agg._absorb_partial(parts, part)
            if not parts:
                yield _FALLBACK
                return
            merged = self._merge_parts(parts)
            parts = []
        finally:
            for p in parts:
                p.close()
        yield merged if agg.mode == "partial" else agg._evaluate(merged)

    def _merge_parts(self, parts):
        """The exact tail: one partial already has unique keys; several go
        through the aggregate's own merge (the per-operator merge path)."""
        if len(parts) == 1:
            only = parts[0]
            merged = only.get_batch()
            only.release()
            only.close()
            return merged
        return self._agg._merge_all(parts)

    # -- join_agg stage ----------------------------------------------------
    def _sizing_body(self, table, stream_batch):
        """The cold sizing pass: the probe's candidate total and the
        string columns' byte needs, read on the host in one copy."""
        from .joins import _string_byte_needs, is_varsize
        join = self._join
        lo, counts, _sk, total = join._counts_kernel(table, stream_batch)
        columns = list(stream_batch.columns) + list(table.payload)
        needs = _string_byte_needs(stream_batch.columns, table, lo, counts,
                                   stream_batch.num_rows) \
            if any(is_varsize(c) for c in columns) else []
        return torch.stack([total] + list(needs)).tolist()

    def _sizing(self, run, table, stream_batch, n_in: int):
        """(cand_cap, caps, warm): a warm key takes the cached buckets (the
        step's flag reports an outgrown one); a cold one runs the sizing
        pass. After HashJoinExec.SPEC_REFRESH warm uses an entry expires
        and the next step measures again, with no monotone max, so one
        pathological batch cannot keep the buckets large. A measured
        total past the join's WINDOW_SLOTS gives (None, total, False):
        that step probes in windows, eagerly, and nothing is cached."""
        from ..columnar.column import bucket_capacity
        from . import joins
        from .joins import HashJoinExec, _byte_caps, is_varsize
        from .speculation import speculation_allowed
        columns = list(stream_batch.columns) + list(table.payload)
        key = (stream_batch.capacity, table.capacity,
               tuple(is_varsize(c) for c in columns))
        cached = self._size_cache.get(key)
        if cached is not None and speculation_allowed():
            cached[2] += 1
            if cached[2] > HashJoinExec.SPEC_REFRESH:
                del self._size_cache[key]
                cached = None
            else:
                return cached[0], cached[1], True
        from ..obs.dispatch import launch_tally
        with launch_tally() as launched:
            fetched = self._call(run, f"stage:sizing:{n_in}", table,
                                 stream_batch)
        with _COUNTER_LOCK:
            _COUNTERS["cold_sizings"] += 1
            for k, v in launched.items():
                _SIZING_LAUNCHES[k] = _SIZING_LAUNCHES.get(k, 0) + v
        if fetched[0] > joins.WINDOW_SLOTS:
            return None, int(fetched[0]), False
        cand_cap = bucket_capacity(max(int(fetched[0]), 1))
        caps = _byte_caps(columns, fetched[1:])
        if cached is not None:
            # monotone while cached, so the steady state keeps its graph
            cand_cap = max(cand_cap, cached[0])
            caps = tuple(None if c is None else max(c, o)
                         for c, o in zip(caps, cached[1]))
        self._size_cache[key] = [cand_cap, caps, 0]
        return cand_cap, caps, False

    def _probe_in_stage(self, table, stream_batch, cand_cap, caps):
        """Counts + probe + emission, and the speculative-sizing overflow
        flag (the join's _candidate_capacity contract, inside the step).
        `cand_cap` None marks a step whose measured candidate total
        (`caps`, then) passes the window: the join's windowed probe, with
        no flag to raise."""
        from ..columnar.encoded import materialize_batch
        from .joins import _string_byte_needs, is_varsize
        join = self._join
        lo, counts, skey_cols, total = join._counts_kernel(table,
                                                           stream_batch)
        if cand_cap is None:
            _note(windowed_steps=1)
            out, _ = join.probe_windows(table, stream_batch, lo, counts,
                                        skey_cols, caps)
            if self._decode:
                out = materialize_batch(out)
            return out, torch.zeros((), dtype=torch.bool,
                                    device=counts.device)
        columns = list(stream_batch.columns) + list(table.payload)
        flag = total > cand_cap
        if any(is_varsize(c) for c in columns):
            needs = _string_byte_needs(stream_batch.columns, table, lo,
                                       counts, stream_batch.num_rows)
            for need, cap in zip(needs, [c for c in caps if c is not None]):
                flag = flag | (need > cap)
        n_s = len(stream_batch.columns)
        out, _ = join._probe_kernel(table, stream_batch, lo, counts,
                                    skey_cols, total, cand_cap, caps[:n_s],
                                    caps[n_s:], None)
        if self._decode:
            out = materialize_batch(out)
        return out, flag

    def _ja_spec_body(self, table, stream_batch, state, flag, cand_cap,
                      caps):
        out, size_flag = self._probe_in_stage(table, stream_batch, cand_cap,
                                              caps)
        return self._agg._streaming_step(out, state, flag | size_flag) \
            + (out.num_rows,)

    def _note_join_rows(self, rows, replayed: bool) -> None:
        """The absorbed join's output rows (its numOutputRows, as the
        per-operator plan counts them), out of the graph's buffers."""
        from .base import NUM_OUTPUT_ROWS
        self._join.metrics[NUM_OUTPUT_ROWS].add_device(
            rows.clone() if replayed else rows)

    def _ja_probe_body(self, table, stream_batch, cand_cap, caps):
        return self._probe_in_stage(table, stream_batch, cand_cap, caps)

    def _execute_join_agg(self):
        join, agg = self._join, self._agg
        bi = 1 if join.build_side == "right" else 0
        build_child, stream_child = self.children[bi], self.children[1 - bi]
        with self._build_site.run() as brun:
            table = self._call(brun, "stage:build:1",
                               list(build_child.execute()), build_child)
        with self._sizing_site.run() as zrun:
            if self._spec_allowed():
                out = self._join_agg_spec(zrun, table, stream_child)
            else:
                out = self._join_agg_exact(zrun, table, stream_child)
        yield out

    def _join_agg_spec(self, zrun, table, stream_child):
        from .speculation import current_scope
        live = self._live_stats
        with self._step_site.run() as run:
            def args(b, state, flag):
                cand_cap, caps, _warm = self._sizing(zrun, table, b,
                                                     live[0])
                return (table, b, state, flag, cand_cap, caps)
            final = self._spec_steps(run, stream_child.execute(), args,
                                     "join")
        if final is None:
            return _FALLBACK
        state, flag, ev = final
        scope = current_scope()
        if scope is not None:
            scope.record(flag)
        return state if self._agg.mode == "partial" else ev

    def _join_agg_exact(self, zrun, table, stream_child):
        from .speculation import current_scope
        agg = self._agg
        scope = current_scope()
        parts: List = []
        live = self._live_stats
        try:
            with self._probe_site.run() as prun, \
                    self._exact_site.run() as erun:
                for stream_batch in stream_child.execute():
                    live[0] += 1
                    n_in = live[0]

                    def step(b):
                        cand_cap, caps, _warm = self._sizing(zrun, table,
                                                             b, n_in)
                        out, size_flag = self._call(
                            prun, f"stage:join:{n_in}", table, b, cand_cap,
                            caps, fixed=(0,))
                        self._note_join_rows(out.num_rows, prun.replayed)
                        if scope is not None:
                            # the replayed flag leaves the graph's buffers
                            # before the next replay overwrites it
                            scope.record(size_flag.clone()
                                         if prun.replayed else size_flag)
                        return self._call(erun, f"stage:agg:{n_in}", out)

                    for part in run_spillable(stream_batch, step):
                        agg._absorb_partial(parts, part)
            if not parts:
                return _FALLBACK
            merged = self._merge_parts(parts)
            parts = []
        finally:
            for p in parts:
                p.close()
        return merged if agg.mode == "partial" else agg._evaluate(merged)


#: sentinel: the fused drive hit a corner the per-operator chain owns
_FALLBACK = object()


def _nbytes_of(values) -> int:
    """Bytes of the tensors in `values`, from their shapes (the
    stage_fused event's carried-state field)."""
    from ..obs.dispatch import flatten
    leaves: List = []
    flatten(values, leaves)
    return sum(t.numel() * t.element_size() for t in leaves)


# ---------------------------------------------------------------------------
# the stage planner
# ---------------------------------------------------------------------------

def compile_stages(root: TpuExec, conf=None) -> TpuExec:
    """Rewrite a converted TpuExec tree: whitelisted chains become
    CompiledStageExec nodes; everything else is untouched. With
    stage.fusion off it returns `root` as it is."""
    from ..config import STAGE_FUSION_ENABLED, active_conf
    conf = conf if conf is not None else active_conf()
    if not conf.get(STAGE_FUSION_ENABLED):
        return root
    return _rewrite(root)


def _rewrite(node: TpuExec) -> TpuExec:
    stage = _try_stage(node)
    target = stage if stage is not None else node
    kids = list(target.children)
    changed = False
    for i, c in enumerate(kids):
        new = _rewrite(c)
        if new is not c:
            kids[i] = new
            changed = True
            # an absorbing aggregate's streaming source may bypass the
            # children chain: keep it pointing at the live node
            if getattr(target, "_source", None) is c:
                target._source = new
    if changed:
        target.children = kids
    return target


def _agg_eligible(agg) -> bool:
    return (agg.mode in ("complete", "partial") and agg._masked_ok
            and agg._fusion_enabled)


def _join_eligible(join) -> bool:
    from .joins import INNER, HashJoinExec
    # inner only: no build flags, no stream-preserved tails — the probe's
    # one output batch per stream batch that the step composes with the
    # aggregate's update
    return type(join) is HashJoinExec and join.join_type == INNER \
        and not join._need_build_flags and join.partition is None


def _try_stage(node: TpuExec) -> Optional[CompiledStageExec]:
    from .aggregate import AggregateExec
    from .basic import ExpandExec, FilterExec, ProjectExec
    if isinstance(node, CompiledStageExec):
        return None
    if type(node) is AggregateExec and _agg_eligible(node):
        src = node._source
        if _join_eligible(src):
            return CompiledStageExec(
                "join_agg", absorbed=[node] + _chain_between(node, src)
                + [src], sources=list(src.children), join=src, agg=node)
        if node._fused_steps:
            # a real chain: a bare group-by is already one step per batch
            return CompiledStageExec(
                "agg", absorbed=[node] + _chain_between(node, src),
                sources=[src], agg=node)
        return None
    fusable = (FilterExec, ProjectExec, ExpandExec)
    if type(node) in fusable and not holds_python_udf(node):
        chain = [node]
        cur = node
        while type(cur.children[0]) in fusable \
                and not holds_python_udf(cur.children[0]):
            cur = cur.children[0]
            chain.append(cur)
        if len(chain) >= 2:
            return CompiledStageExec("map", absorbed=chain,
                                     sources=[cur.children[0]])
    return None


def _chain_between(agg, src) -> List[TpuExec]:
    """The operators the aggregate absorbed between itself and its
    streaming source."""
    out = []
    cur = agg.children[0] if agg.children else None
    while cur is not None and cur is not src:
        out.append(cur)
        cur = cur.children[0] if cur.children else None
    return out
