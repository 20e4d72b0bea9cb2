"""TpuExec — base of the columnar operator tree, the counterpart of
spark_rapids_tpu/exec/base.py.

Operators form a tree; `execute()` returns an iterator of ColumnarBatch.
Every pull of a batch runs under the governance planes, each one pointer
check when off: the governed query's cancellation tick
(exec/lifecycle.py), a profiler range of the operator's name
(utils/tracing.annotate_op), the dispatch ledger's exec scope, which is
the operator's `device-compute` phase span (obs/dispatch.py), and the
event log's op_open / op_batch / op_close / op_error records
(obs/events.py). Metrics carry the JAX package's visibility levels
(ESSENTIAL / MODERATE / DEBUG, by name: `METRIC_LEVELS`), cut by
spark.rapids.sql.metrics.level in `all_metrics()` and the query profile.

The stage compiler's surface (exec/stage_compiler.py) is here too, as in
the JAX package: `plan_fingerprint` (from each node's
`_fingerprint_extras`; None opts a subtree out), `_site` (a program site
keyed by it: one CUDA graph per static shape on the card) and
`batch_harness` (the per-step hooks at the stage boundary).
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from ..columnar.batch import ColumnarBatch
from ..columnar.encoded import materialize_batch
from ..types import Schema

# the three-level scale of obs/events.py
ESSENTIAL = 0
MODERATE = 1
DEBUG = 2

NUM_OUTPUT_ROWS = "numOutputRows"
AGG_TIME = "computeAggTime"
NUM_DISPATCHES = "numDispatches"
PIPELINE_WAIT = "pipelineWaitNs"
PIPELINE_FULL_WAIT = "pipelineFullWaitNs"
PIPELINE_WALL = "pipelineWallNs"
NUM_UPLOADS = "numUploads"
UPLOAD_PACK_TIME = "uploadPackTimeNs"

#: the metrics of an exec that runs a pipelined() input stage (bind them
#: with TpuExec.pipeline_stage)
PIPELINE_STAGE_METRICS = (PIPELINE_WAIT, PIPELINE_FULL_WAIT, PIPELINE_WALL)
#: the metrics of an exec that uploads batches (columnar/upload.metric_sink)
UPLOAD_METRICS = (NUM_UPLOADS, UPLOAD_PACK_TIME)

#: per-operator ids (the admission semaphore's task ids, stage labels)
_OP_IDS = itertools.count(1)

#: metric name -> its visibility level where it is not MODERATE (the
#: levels the JAX package's execs register these names at)
METRIC_LEVELS = {NUM_OUTPUT_ROWS: ESSENTIAL, "numOutputBatches": ESSENTIAL,
                 "partitionSize": ESSENTIAL, "numInputRows": DEBUG,
                 "numInputBatches": DEBUG}


def metrics_level_from_conf(conf=None) -> int:
    """spark.rapids.sql.metrics.level as an int (unknown: MODERATE)."""
    from ..config import METRICS_LEVEL, active_conf
    from ..obs.events import parse_level
    conf = conf if conf is not None else active_conf()
    return parse_level(conf.get(METRICS_LEVEL))


class TpuMetric:
    """Accumulating operator metric. Device-produced values (a row count
    on the card) accumulate lazily and are read only when the metric is,
    so the batch loop never waits for the device."""

    __slots__ = ("name", "level", "_value", "_pending")

    def __init__(self, name: str, level: Optional[int] = None):
        self.name = name
        self.level = METRIC_LEVELS.get(name, MODERATE) if level is None \
            else level
        self._value = 0
        self._pending: List[torch.Tensor] = []

    def add(self, v: int) -> None:
        self._value += v

    def add_device(self, scalar: torch.Tensor) -> None:
        self._pending.append(scalar)

    @property
    def value(self) -> int:
        if self._pending:
            pending, self._pending = self._pending, []
            self._value += int(torch.stack(
                [s.to(torch.int64).reshape(()) for s in pending]).sum())
        return self._value

    def ns_timer(self):
        return _NsTimer(self)


class _NsTimer:
    def __init__(self, metric: TpuMetric):
        self.metric = metric

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.metric.add(time.perf_counter_ns() - self._t0)


class TpuExec:
    """Base columnar operator."""

    #: True when this exec's kernels accept DictionaryColumn inputs from
    #: its children (code-space predicates, pass-through projections).
    #: Execs override it, usually with the eligibility walk over their
    #: bound expressions (expr/predicates.encoded_safe_predicate); the
    #: default False keeps an operator from misreading the encoded layout.
    consumes_encoded: bool = False

    #: stamped by the parent's execute() before this exec's first batch is
    #: pulled: whether encoded columns may cross this exec's output
    #: boundary. Where they may not, they decode there (late
    #: materialization, columnar/encoded.materialize_batch). The root of
    #: a plan is never stamped, so execute() at the root decodes; collect()
    #: lets its encoded batches out, since to_pylist decodes on the host.
    _encoded_ok_for_parent: bool = False

    def __init__(self, *children: "TpuExec"):
        self.children: List[TpuExec] = list(children)
        self._op_id = next(_OP_IDS)
        self.metrics: Dict[str, TpuMetric] = {
            NUM_OUTPUT_ROWS: TpuMetric(NUM_OUTPUT_ROWS)}
        for spec in self.additional_metrics():
            name, level = spec if isinstance(spec, tuple) else (spec, None)
            self.metrics[name] = TpuMetric(name, level)

    @property
    def output_schema(self) -> Schema:
        raise NotImplementedError(type(self).__name__)

    def additional_metrics(self) -> Sequence[str]:
        return ()

    @property
    def output_grouped_by(self):
        """Grouping contract of this exec's output batches, or None.

        A tuple of frozensets of output column names: within every
        emitted batch, rows carrying equal values for (one representative
        of each class) are contiguous, and the columns inside one class
        are pairwise equal per row (the two sides of an equi-join key). A
        group-by whose keys pick a representative from every class, and
        nothing else, may skip its sort (ops/aggregate.groupby_aggregate
        `pre_grouped`)."""
        return None

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        raise NotImplementedError(type(self).__name__)

    @property
    def runs_own_pipeline_stage(self) -> bool:
        """True when this exec's execute() drives a pipelined() producer
        stage of its own: a consumer that would wrap its input in another
        stage skips it then."""
        return False

    def pipeline_stage(self, source, label: str, depth=None):
        """The one way an exec wraps an input in a pipelined() stage:
        binds the PIPELINE_STAGE_METRICS (which its additional_metrics()
        registers) and tags the label with the op id. Callers drive the
        stage inside try/finally with stage.close()."""
        from .pipeline import pipelined
        return pipelined(source, depth=depth,
                         label=f"{label}-{self._op_id}",
                         wait_metric=self.metrics[PIPELINE_WAIT],
                         full_metric=self.metrics[PIPELINE_FULL_WAIT],
                         wall_metric=self.metrics[PIPELINE_WALL])

    def encoded_inputs(self) -> Sequence["TpuExec"]:
        """The execs whose batches this exec's kernels read, and so the
        ones its `consumes_encoded` speaks for: its children, or the
        source of a chain it absorbs."""
        return self.children

    def stamp_inputs(self) -> None:
        """Tell each exec in `encoded_inputs` whether encoded columns may
        cross its output boundary; execute() does it before the first
        batch is pulled."""
        for c in self.encoded_inputs():
            c._encoded_ok_for_parent = self.consumes_encoded

    def execute(self) -> Iterator[ColumnarBatch]:
        """Counts output rows around the operator's own iterator, and
        decodes encoded columns at the boundary when the parent cannot
        take them. When an exception or an abandoned consumer unwinds
        through this frame, the internal iterator is closed here, so its
        own finally blocks run now rather than whenever the garbage
        collector gets to them."""
        return self._execute(self._encoded_ok_for_parent)

    def _execute(self, encoded_out: bool) -> Iterator[ColumnarBatch]:
        from ..obs import events as obs_events
        from . import lifecycle
        self.stamp_inputs()
        it = self.internal_execute()
        try:
            yield from self._drive(it, encoded_out,
                                   obs_events.active_bus(),
                                   lifecycle.current_context())
        finally:
            it.close()

    def _drive(self, it, encoded_out: bool, bus, qctx
               ) -> Iterator[ColumnarBatch]:
        from ..obs import dispatch as obs_dispatch
        from ..utils.tracing import annotate_op
        rows = self.metrics[NUM_OUTPUT_ROWS]
        name = type(self).__name__
        dev = self.device
        dev_type = torch.device(dev).type if dev is not None else "cuda"
        total_ns = nbatches = 0
        if bus is not None:
            bus.emit("op_open", op=name, op_id=self._op_id)
            rows_at_open = rows.value
            emit_batches = bus.level >= DEBUG
        try:
            while True:
                if qctx is not None:
                    # the governed query's cancellation tick
                    qctx.tick()
                t0 = time.perf_counter_ns()
                with annotate_op(name), \
                        obs_dispatch.exec_scope(name, dev_type) as scope:
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    except Exception:
                        if bus is not None:
                            bus.emit("op_error", op=name, op_id=self._op_id)
                        raise
                    if not encoded_out:
                        batch = materialize_batch(batch)
                    if scope is not None:
                        scope.count()
                        scope.bucket = obs_dispatch.shape_bucket(
                            (batch.capacity,))
                step_ns = time.perf_counter_ns() - t0
                total_ns += step_ns
                nbatches += 1
                if batch._host_rows is not None:
                    rows.add(batch._host_rows)
                else:
                    rows.add_device(batch.num_rows)
                if qctx is not None:
                    qctx.note_batch(name, self._op_id, batch._host_rows)
                if bus is not None and emit_batches:
                    bus.emit("op_batch", op=name, op_id=self._op_id,
                             wall_ns=step_ns, rows=batch._host_rows)
                yield batch
        finally:
            if bus is not None:
                try:
                    out_rows = rows.value - rows_at_open
                except Exception:  # noqa: BLE001 — close is best-effort
                    out_rows = None
                bus.emit("op_close", op=name, op_id=self._op_id,
                         wall_ns=total_ns, batches=nbatches, rows=out_rows)

    @property
    def device(self):
        """The device the plan's leaves name (None: the port's default)."""
        for c in self.children:
            if c.device is not None:
                return c.device
        return None

    def node_description(self) -> str:
        return type(self).__name__

    # -- the plan fingerprint and the stage boundary ----------------------
    def _fingerprint_extras(self):
        """Semantic parameters of this node beyond its class, output schema
        and children: everything its bodies depend on (bound expressions,
        modes, confs read at construction). None, the default, opts the
        subtree out of the plan-fingerprint program cache: an exec whose
        semantics are not all captured here never shares a program site
        (and its CUDA graphs) with another instance."""
        return None

    def plan_fingerprint(self) -> Optional[str]:
        """The canonical fingerprint of this subtree
        (exec/stage_compiler.fingerprint_node): equal fingerprints promise
        equal bodies, so the process-wide site cache (obs/dispatch.py) may
        hand a later collect()'s rebuilt exec the sites, and the graphs,
        an equal plan built. None when a node of the subtree opted out or
        the stage.fusion gate is off. Memoized per instance: compute it
        only once the node's semantic fields are final."""
        memo = self.__dict__.get("_plan_fp", False)
        if memo is not False:
            return memo
        fp = None
        extras = self._fingerprint_extras()
        if extras is not None:
            from .stage_compiler import fingerprint_node
            fp = fingerprint_node(self, extras)
        self.__dict__["_plan_fp"] = fp
        return fp

    def _site(self, fn, label: str, key_salt=None, graph: bool = True,
              cause: Optional[str] = None, cause_of=None):
        """One of this exec's program sites (obs/dispatch.instrument),
        keyed by the plan fingerprint when there is one, so that an equal
        exec of a later collect() replays the same graphs. `key_salt`
        tells apart several sites of one label on one exec; `graph=False`
        names a body that reads the host (`cause`), and `cause_of(*args)`
        a call whose inputs make it read the host: those run eagerly."""
        from ..obs.dispatch import instrument
        fp = self.plan_fingerprint()
        key = None if fp is None else \
            (fp if key_salt is None else (fp, key_salt))
        return instrument(fn, label=label, owner=self, cache_key=key,
                          graph=graph, cause=cause, cause_of=cause_of)

    @contextlib.contextmanager
    def batch_harness(self, fault_key: Optional[str] = None,
                      fault_point: str = "device.dispatch"):
        """The per-batch hooks of a stage step, around its one site call
        and never inside a captured body: the governed query's cancel
        check, and the fault point (`device.dispatch`, or the mesh round's
        `shuffle.ici_exchange`) keyed by the step. The program site adds
        the dispatch metric, the kernel launches and gathers of a replay
        and the hang bound after it (obs/dispatch.py)."""
        from .. import faults
        from . import lifecycle
        qctx = lifecycle.current_context()
        if qctx is not None:
            qctx.tick()
        faults.check(fault_point, key=fault_key)
        yield

    def all_metrics(self, level: Optional[int] = None) -> Dict[str, int]:
        """Flat per-operator metric values (`<Exec>[i]/.../<Exec>.<name>`,
        the child ordinal disambiguating siblings of one class), cut to
        entries at or below `level` (None: spark.rapids.sql.metrics.level
        of the active conf)."""
        if level is None:
            level = metrics_level_from_conf()
        out: Dict[str, int] = {}

        def walk(node, path, label):
            for name, m in node.metrics.items():
                if m.level <= level:
                    out[f"{path}{label}.{name}"] = m.value
            for i, c in enumerate(node.children):
                walk(c, f"{path}{label}/", f"{type(c).__name__}[{i}]")

        walk(self, "", type(self).__name__)
        return out

    @property
    def child(self) -> "TpuExec":
        if len(self.children) != 1:
            raise ValueError(f"{type(self).__name__} has "
                             f"{len(self.children)} children")
        return self.children[0]

    def collect(self) -> List[tuple]:
        """Materialize results. Opens a speculation scope: aggregates may
        run their masked-bucket tier and joins their cached candidate
        sizes, flagging overflow on the device; the flags cost one host
        read here, and a trip re-runs the plan with every operator on its
        exact tier."""
        from .speculation import force_exact, speculation_scope

        def run() -> List[tuple]:
            out: List[tuple] = []
            # to_pylist decodes dictionary columns on the host: the output
            # seam takes encoded root batches
            for batch in self._execute(encoded_out=True):
                out.extend(batch.to_pylist())
            return out

        with speculation_scope() as scope:
            out = run()
            if scope.tripped():
                with force_exact():
                    out = run()
        return out
