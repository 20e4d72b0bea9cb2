"""TpuSession and DataFrame — the counterpart of
spark_rapids_tpu/api/session.py, the engine's user surface: build a
logical plan, run it through TpuOverrides (wrap -> tag -> convert), and
execute the TpuExec tree on the card.

    sess = TpuSession({"spark.rapids.sql.shuffle.partitions": "4"})
    df = sess.from_pydict({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]}, schema)
    df.filter(col("v") > lit(1.5)).group_by("k").agg(F.sum("v")).collect()

The session runs on `cuda` unless it is given `device="cpu"` (the tests
do); without a card it raises. Its conf is a RapidsConf, made active on
the calling thread when the session is built and again at every action,
so the execs built for a query read it at construction; the same calls
(re)configure the process planes it names: the event log, telemetry,
the dispatch ledger (and its hang bound, dispatch.timeoutMs), the query
history store and the fault plan.

A session given `mesh_devices=n` or `mesh=` plans over that mesh
(parallel/mesh.py): it is the active mesh from construction and at every
action, so the planner's `_plan_mesh` sees it and the history capsule
records its shard count. `TpuSession(device="cpu", mesh_devices=4)` plans
over four CPU shards; on the card `mesh_devices=4` takes the first four
cards (fewer raise), and `mesh=Mesh([torch.device("cuda", 0)] * 4)` puts
four shards on one card.

`collect()` is the governed drive, as the JAX package's:

  * `lifecycle.governed` — one QueryContext for the whole drive, so
    spark.rapids.tpu.query.timeoutMs bounds its wall-clock and
    `cancel_query()` unwinds it from another thread;
  * `workload.admitted` — fair admission when
    spark.rapids.tpu.workload.enabled;
  * `with_task_retry` — a transient failure re-runs the plan from the
    sources, up to spark.rapids.tpu.task.maxAttempts attempts;
  * the phase ledger (spark.rapids.tpu.phases.enabled) over all of it;
  * the progress watchdog when spark.rapids.tpu.stall.timeoutMs > 0
    (exec/speculation_shield.py), stopped in the same finally;
  * one history capsule per query when spark.rapids.tpu.history.enabled
    (obs/history.py), written in that finally, failed queries included;
  * per attempt (`_collect_once`), the events plane's `query_scope`,
    a fresh RuntimeStats, the plan's `exec/base.collect` (its exact
    re-run when a speculative tier trips), and the QueryProfile built
    from the executed plan even when the attempt fails.

The health surfaces: `cancel_query()`, `health()` (breakers, the
lifecycle counters, the workload governor, telemetry, the dispatch
ledger, the SLO percentiles, skew), `active_queries()` and
`last_query_profile()`. `last_query_metrics()` is the executed plan's
operator metrics; the task-level roll-up (semaphore wait, retries, spill
volumes) is the profile's `summary`.

The readers (`read_parquet`, `read_csv`, `read_json`, `read_orc`,
`read_iceberg`, `read_avro`, `read_hive_text`) put their batches on the
session's device; the writers (`write_*`) fetch the result once (Avro,
Hive text and JSON through `collect()` or `to_pydict()`, the others
through `to_arrow()`). Parquet, CSV, JSON, ORC, Iceberg and Delta
(`read_delta`, `write_delta`, delta/) go through pyarrow (the machine with
the card has none: they run on the CPU until it does); Avro and Hive text
are pure Python. Delta's DML (delta/table.DeltaTable) rewrites a file's
rows with device plans.

The pandas UDFs (`map_in_pandas`, `window_in_pandas`, and
`apply_in_pandas`, `agg_in_pandas` and `cogroup` on grouped data) build
the five pandas nodes; their operators (exec/python_udf.py) go through
pandas and pyarrow, imported when they run.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..columnar.batch import ColumnarBatch
from ..columnar.column import resolve_device
from ..config import RapidsConf, set_active_conf
from ..expr.aggexprs import AggregateFunction
from ..expr.core import Expression, col, lit
from ..plan import logical as L
from ..plan.overrides import TpuOverrides
from ..types import Schema


def _configure_planes(conf: RapidsConf) -> None:
    """(Re)configure the process-wide planes a conf names: the event
    log, telemetry, the dispatch ledger, the history store and the fault
    plan."""
    from .. import faults
    from ..obs import dispatch as obs_dispatch
    from ..obs import events as obs_events
    from ..obs import history as obs_history
    from ..obs import telemetry
    obs_events.configure(conf)
    telemetry.configure(conf)
    obs_dispatch.configure(conf)
    obs_history.configure(conf)
    faults.configure(conf)


class _InMemorySource:
    """A scan source over batches already on the session's device."""

    def __init__(self, batches: List[ColumnarBatch], schema: Schema,
                 device):
        self._batches = batches
        self.schema = schema
        self.device = device

    def batches(self):
        return list(self._batches)

    def estimated_size_bytes(self) -> int:
        """Bytes at capacity, every leaf counted, as the JAX package's
        `device_size_bytes` counts them (ColumnarBatch.nbytes): the
        broadcast threshold sees the same size in both packages."""
        return sum(b.nbytes for b in self._batches)

    def estimated_num_rows(self) -> int:
        return sum(b.num_rows_host for b in self._batches)

    def encoded_columns(self) -> List[str]:
        """The dictionary-encoded columns a scan of this source passes on:
        those of its one batch (the coalesce above a scan of several
        decodes them to concatenate)."""
        from ..columnar.encoded import DictionaryColumn
        if len(self._batches) != 1:
            return []
        return [f.name for f, c in zip(self.schema.fields,
                                       self._batches[0].columns)
                if isinstance(c, DictionaryColumn)]


class TpuSession:
    def __init__(self, conf: Optional[Dict] = None, device=None,
                 mesh_devices: Optional[int] = None, mesh=None):
        """`mesh_devices` (a shard count) or `mesh` (a parallel/mesh.Mesh)
        turn on distributed planning: grouped aggregates and equi-joins
        run as partial -> all-to-all exchange -> final over the mesh's
        shards. `mesh_devices` builds the mesh on the session's device:
        the first n cards (fewer raise), or n CPU shards with
        device="cpu". A mesh whose devices are not of the session's type
        raises. Default: the single-partition plan."""
        from ..columnar import upload
        from ..parallel.mesh import device_mesh, set_active_mesh
        self.conf = RapidsConf(conf or {})
        self.device = resolve_device(device)
        if mesh is None and mesh_devices is not None:
            mesh = device_mesh(mesh_devices, device=self.device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh in a "
                             f"{self.device.type} session: every shard "
                             f"runs on the session's device type")
        self.mesh = mesh
        set_active_mesh(mesh)
        set_active_conf(self.conf)
        _configure_planes(self.conf)
        # pre-size the upload staging pool's buckets from batchSizeBytes
        upload.configure(self.conf)
        #: the operator metrics of the last collect()
        self._last_query_metrics = None
        #: the QueryProfile of the last collect() (obs/profile.py)
        self._last_query_profile = None
        #: lifecycle ownership token: every governed collect registers
        #: its QueryContext under it, so cancel_query() (from any
        #: thread) finds this session's queries
        self._lifecycle_owner = object()

    def last_query_metrics(self) -> Optional[Dict[str, Dict[str, int]]]:
        """Per operator of the last collect()'s executed plan
        ("<Exec>#<id>"), its metrics. The JAX package's task-level
        roll-up (semaphore wait, retries, spill volumes) is
        `last_query_profile().summary` (exec/task_metrics.py)."""
        return self._last_query_metrics

    # -- ingestion ---------------------------------------------------------
    def from_pydict(self, data: Dict, schema: Schema,
                    batch_rows: Optional[int] = None) -> "DataFrame":
        n = len(next(iter(data.values()))) if data else 0
        rows = batch_rows or max(n, 1)
        batches = []
        for s in range(0, max(n, 1), rows):
            chunk = {k: v[s:s + rows] for k, v in data.items()}
            batches.append(ColumnarBatch.from_pydict(chunk, schema,
                                                     device=self.device))
        return self.from_batches(batches, schema)

    def from_arrow(self, table) -> "DataFrame":
        batch = ColumnarBatch.from_arrow(table, self.device)
        return self.from_batches([batch], batch.schema)

    def from_batches(self, batches: Sequence[ColumnarBatch],
                     schema: Schema) -> "DataFrame":
        return self._df(L.LogicalScan(
            _InMemorySource(list(batches), schema, self.device)))

    def range(self, start: int, end: Optional[int] = None,
              step: int = 1) -> "DataFrame":
        if end is None:
            start, end = 0, start
        return self._df(L.LogicalRange(start, end, step,
                                       device=self.device))

    def read_parquet(self, path) -> "DataFrame":
        from ..io.parquet import ParquetSource
        return self._df(L.LogicalScan(
            ParquetSource(path, self.conf, device=self.device)))

    def read_csv(self, path, schema: Optional[Schema] = None,
                 header: bool = True, **options) -> "DataFrame":
        from ..io.csv import CsvSource
        return self._df(L.LogicalScan(CsvSource(
            path, self.conf, schema=schema, header=header,
            device=self.device, **options)))

    def read_json(self, path, schema: Optional[Schema] = None,
                  **options) -> "DataFrame":
        from ..io.json import JsonSource
        return self._df(L.LogicalScan(JsonSource(
            path, self.conf, schema=schema, device=self.device, **options)))

    def read_orc(self, path, columns=None) -> "DataFrame":
        from ..io.orc import OrcSource
        return self._df(L.LogicalScan(OrcSource(
            path, self.conf, columns=columns, device=self.device)))

    def read_iceberg(self, path, snapshot_id=None) -> "DataFrame":
        from ..io.iceberg import IcebergSource
        return self._df(L.LogicalScan(IcebergSource(
            path, self.conf, snapshot_id, device=self.device)))

    def read_hive_text(self, path, schema, **options) -> "DataFrame":
        from ..io.hivetext import HiveTextSource
        return self._df(L.LogicalScan(HiveTextSource(
            path, schema, self.conf, device=self.device, **options)))

    def read_delta(self, path, version=None) -> "DataFrame":
        from ..delta import read_delta
        return read_delta(self, path, version)

    def read_avro(self, path, **options) -> "DataFrame":
        from ..io.avro import AvroSource
        return self._df(L.LogicalScan(AvroSource(
            path, self.conf, device=self.device, **options)))

    def cancel_query(self) -> int:
        """Cooperatively cancel every query this session is running: each
        blocked or computing thread raises QueryCancelledError at its
        next batch boundary or wait-loop poll, and the query unwinds
        through its try/finally chains. Returns the number of queries
        cancelled (0: none running)."""
        from ..exec import lifecycle
        return lifecycle.cancel_owner(self._lifecycle_owner)

    def health(self) -> Dict:
        """Engine health: the breaker states (with the JAX package's
        domains the port does not have marked), kernel-family failure
        counts, governed-query count, the lifecycle counters, the
        workload governor's queue, telemetry's state and newest sample,
        the dispatch ledger, the per-priority-class latency percentiles
        (`slo`), the recent exchanges' skew (`stats`) and the installed
        heartbeat manager's peers (`peers`: live and dead peers, purges,
        blacklisted slots; {"enabled": False} without a manager)."""
        from ..exec import lifecycle
        from ..obs import dispatch, telemetry
        from ..obs import stats as obs_stats
        from ..parallel import heartbeat
        out = lifecycle.health()
        out["telemetry"] = telemetry.health_section()
        out["dispatch"] = dispatch.health_section()
        out["peers"] = heartbeat.health_section()
        out["slo"] = telemetry.slo_section()
        out["stats"] = obs_stats.health_section()
        return out

    def active_queries(self) -> List[Dict]:
        """One row per in-flight governed query (engine-wide): phase,
        the operator yielding batches, root batches and rows so far,
        elapsed and deadline-remaining ms, attempt, spills, and the
        workload quota when governed; `mine` marks this session's."""
        from ..exec import lifecycle
        return lifecycle.active_queries(owner=self._lifecycle_owner)

    def last_query_profile(self):
        """QueryProfile of the most recent collect(): the executed plan
        annotated with its metrics, `.text()`, `.to_json()`,
        `.top_operators()`, `.statistics()` and `.phases()`. None before
        the first collect."""
        return self._last_query_profile

    def _df(self, plan: L.LogicalPlan) -> "DataFrame":
        return DataFrame(plan, self)


def _to_expr(x) -> Expression:
    if isinstance(x, Expression):
        return x
    if isinstance(x, str):
        return col(x)
    return lit(x)


def _operator_metrics(root) -> Dict[str, Dict[str, int]]:
    out: Dict[str, Dict[str, int]] = {}
    stack = [root]
    while stack:
        node = stack.pop()
        out[f"{type(node).__name__}#{node._op_id}"] = {
            name: m.value for name, m in node.metrics.items()}
        stack.extend(node.children)
        # a compiled stage's absorbed operators (exec/stage_compiler.py)
        stack.extend(getattr(node, "_absorbed", ()))
    return out


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session: TpuSession):
        self._plan = plan
        self.session = session

    @property
    def schema(self) -> Schema:
        return self._plan.schema

    @property
    def columns(self) -> List[str]:
        return list(self.schema.names)

    # -- transformations ---------------------------------------------------
    def select(self, *exprs) -> "DataFrame":
        return self._with(L.LogicalProject([_to_expr(e) for e in exprs],
                                           self._plan))

    def with_column(self, name: str, expr) -> "DataFrame":
        exprs = [col(n) for n in self.columns if n != name]
        exprs.append(_to_expr(expr).alias(name))
        return self._with(L.LogicalProject(exprs, self._plan))

    def filter(self, condition) -> "DataFrame":
        return self._with(L.LogicalFilter(_to_expr(condition), self._plan))

    where = filter

    def group_by(self, *keys) -> "GroupedData":
        return GroupedData([_to_expr(k) for k in keys], self)

    groupBy = group_by

    def agg(self, *aggs: Tuple[AggregateFunction, str]) -> "DataFrame":
        return GroupedData([], self).agg(*aggs)

    def join(self, other: "DataFrame", on=None, how: str = "inner",
             left_on=None, right_on=None, condition=None) -> "DataFrame":
        if on is not None:
            names = [on] if isinstance(on, str) else list(on)
            if how not in ("left_semi", "left_anti", "existence"):
                # USING-join semantics (Spark): ONE output column per key
                return self._using_join(other, names, how, condition)
            lkeys = [col(n) for n in names]
            rkeys = [col(n) for n in names]
        elif left_on is not None:
            lk = [left_on] if not isinstance(left_on, (list, tuple)) \
                else left_on
            rk = [right_on] if not isinstance(right_on, (list, tuple)) \
                else right_on
            lkeys = [_to_expr(k) for k in lk]
            rkeys = [_to_expr(k) for k in rk]
        else:
            lkeys, rkeys = [], []
        return self._with(L.LogicalJoin(self._plan, other._plan, lkeys,
                                        rkeys, how, condition))

    def _using_join(self, other: "DataFrame", names: List[str], how: str,
                    condition) -> "DataFrame":
        """Rename the right keys, join, project the duplicate away; the
        surviving key is left's (right's for right_outer, coalesce(left,
        right) for full_outer)."""
        from ..expr.conditional import Coalesce
        tmp = {n: f"__using_r_{n}" for n in names}
        rproj = other.select(*[col(n).alias(tmp[n]) if n in tmp else col(n)
                               for n in other.columns])
        joined = L.LogicalJoin(self._plan, rproj._plan,
                               [col(n) for n in names],
                               [col(tmp[n]) for n in names], how, condition)
        out: List[Expression] = []
        for n in names:
            if how == "right_outer":
                out.append(col(tmp[n]).alias(n))
            elif how == "full_outer":
                out.append(Coalesce(col(n), col(tmp[n])).alias(n))
            else:
                out.append(col(n))
        out += [col(n) for n in self.columns if n not in names]
        out += [col(n) for n in other.columns if n not in names]
        return self._with(L.LogicalProject(out, joined))

    def sort(self, *orders) -> "DataFrame":
        norm = []
        for o in orders:
            if isinstance(o, tuple):
                e = _to_expr(o[0])
                norm.append((e,) + tuple(o[1:]))
            else:
                norm.append((_to_expr(o), True))
        return self._with(L.LogicalSort(norm, self._plan))

    order_by = sort
    orderBy = sort

    def limit(self, n: int, offset: int = 0) -> "DataFrame":
        if isinstance(self._plan, L.LogicalSort) and self._plan.limit is None:
            # sort+limit collapses to TopN (reference GpuTopN, limit.scala:351)
            return self._with(L.LogicalSort(self._plan.orders,
                                            self._plan.children[0],
                                            limit=n, offset=offset))
        return self._with(L.LogicalLimit(n, self._plan, offset))

    def distinct(self) -> "DataFrame":
        return self._with(L.LogicalAggregate(
            [col(n) for n in self.columns], [], self._plan))

    def repartition(self, n_partitions: int) -> "DataFrame":
        """Round-robin repartition through the host shuffle (Spark
        df.repartition(n); reference GpuRoundRobinPartitioning)."""
        return self._with(L.LogicalRepartition(n_partitions, self._plan,
                                               mode="roundrobin"))

    def coalesce(self, n_partitions: int = 1) -> "DataFrame":
        """Collapse to a single partition (Spark df.coalesce(1);
        reference GpuSinglePartitioning)."""
        if n_partitions != 1:
            raise ValueError("only coalesce(1) is supported")
        return self._with(L.LogicalRepartition(1, self._plan,
                                               mode="single"))

    def union(self, other: "DataFrame") -> "DataFrame":
        return self._with(L.LogicalUnion(self._plan, other._plan))

    def sample(self, fraction: float, seed: int = 42) -> "DataFrame":
        """Bernoulli sample (Spark df.sample; reference GpuSampleExec):
        the rows the JAX package keeps for the same seed."""
        return self._with(L.LogicalSample(fraction, seed, self._plan))

    def with_windows(self, *window_exprs) -> "DataFrame":
        """Append window-function columns: (WindowExpression, name) pairs
        (pyspark's F.xxx().over(w)); an unnamed one is `<function>_<i>`."""
        named = [we if isinstance(we, tuple) else (we, f"{we.fn.name}_{i}")
                 for i, we in enumerate(window_exprs)]
        return self._with(L.LogicalWindow(named, self._plan))

    def explode(self, column, alias: str = "col",
                outer: bool = False) -> "DataFrame":
        """One output row per array element, the other columns kept; an
        empty or null array drops its row (outer=True keeps it with a null
        element)."""
        return self._with(L.LogicalGenerate(_to_expr(column), self._plan,
                                            outer=outer, elem_name=alias))

    def posexplode(self, column, alias: str = "col", pos_name: str = "pos",
                   outer: bool = False) -> "DataFrame":
        return self._with(L.LogicalGenerate(_to_expr(column), self._plan,
                                            outer=outer, position=True,
                                            elem_name=alias,
                                            pos_name=pos_name))

    def cache(self) -> "DataFrame":
        """A materialize-once columnar cache (reference
        ParquetCachedBatchSerializer / GpuInMemoryTableScanExec,
        exec/cache.py): the first action on the returned frame runs this
        plan into compressed host frames; later actions scan them. Call
        `unpersist()` on the returned frame to drop them."""
        from ..exec.cache import CachedRelation
        rel = CachedRelation(self._exec, self.schema, self.session.device)
        out = self._with(L.LogicalScan(rel))
        out._cached_relation = rel
        return out

    def unpersist(self) -> "DataFrame":
        rel = getattr(self, "_cached_relation", None)
        if rel is not None:
            rel.unpersist()
        return self

    def map_in_pandas(self, fn, schema) -> "DataFrame":
        """Spark df.mapInPandas(fn, schema): fn(iterator of pandas
        DataFrames) -> iterator of DataFrames (reference
        GpuMapInBatchExec.scala)."""
        return self._with(L.LogicalMapInBatch(fn, _to_schema(schema),
                                              self._plan))

    mapInPandas = map_in_pandas

    def window_in_pandas(self, partition_by, *wins) -> "DataFrame":
        """Whole-partition pandas window UDFs: each win is (fn, name,
        result_type, input columns...); fn(series...) -> scalar broadcast
        over its partition (reference GpuWindowInPandasExecBase)."""
        parts = [_to_expr(p) for p in (
            partition_by if isinstance(partition_by, (list, tuple))
            else [partition_by])]
        return self._with(L.LogicalWindowInPandas(
            parts, _named_pandas_fns(wins), self._plan))

    # -- actions -----------------------------------------------------------
    def _exec(self):
        """The converted plan, under the session's conf and mesh."""
        from ..columnar import upload
        from ..parallel.mesh import set_active_mesh
        set_active_conf(self.session.conf)
        set_active_mesh(self.session.mesh)
        _configure_planes(self.session.conf)
        upload.configure(self.session.conf)
        return TpuOverrides(self.session.conf).apply(self._plan)

    def collect(self) -> List[tuple]:
        """Materialize the results under the governance planes (module
        docstring): the whole drive — admission, every attempt and its
        backoff — under one QueryContext and one phase ledger."""
        import time as _time

        from ..config import PHASES_ENABLED
        from ..exec import lifecycle, speculation_shield, workload
        from ..exec.task_retry import with_task_retry
        from ..obs import history as obs_history
        from ..obs import phase as obs_phase
        with lifecycle.governed(self.session.conf,
                                owner=self.session._lifecycle_owner) as ctx:
            if self.session.conf.get(PHASES_ENABLED):
                obs_phase.attach(ctx)
            # after the ledger: a stall event names the dominant phase
            watchdog = speculation_shield.watchdog_for(ctx,
                                                       self.session.conf)
            store = obs_history.active_store()
            before = obs_history.process_counters() \
                if store is not None else None
            if store is not None:
                # a query that fails before its harvest must not write
                # the previous query's profile into its capsule
                self.session._last_query_metrics = None
                self.session._last_query_profile = None
            t0 = _time.perf_counter_ns()
            ok = False
            try:
                with workload.admitted(self.session.conf, ctx):
                    out = with_task_retry(
                        lambda attempt: self._collect_once(),
                        conf=self.session.conf)
                    ok = True
                    return out
            finally:
                if watchdog is not None:
                    watchdog.stop()
                self._finish_query(ctx, ok, store, before,
                                   _time.perf_counter_ns() - t0)

    def _finish_query(self, ctx, ok: bool, store, before,
                      fallback_wall_ns: int) -> None:
        """Query-end observability, inside collect's finally chain: close
        the phase ledger, emit `query_phases`, feed the SLO latency ring,
        append the history capsule. Never raises (it would mask the
        query's exception)."""
        from ..config import WORKLOAD_PRIORITY
        from ..exec.workload import PRIORITIES
        from ..obs import events as obs_events
        from ..obs import history as obs_history
        from ..obs import telemetry
        try:
            priority = str(self.session.conf.get(
                WORKLOAD_PRIORITY)).strip().lower()
            if priority not in PRIORITIES:
                priority = "interactive"
            ledger = ctx.phase_ledger
            wall_ns = fallback_wall_ns
            phases = None
            if ledger is not None:
                wall_ns = ledger.finish()
                phases = ledger.snapshot()
                obs_events.emit(
                    "query_phases", query=ctx.events_qid or ctx.ctx_id,
                    ok=ok, wall_ns=wall_ns, attempts=ctx.attempt_no,
                    priority=priority, phases=phases)
            if ok:
                # only completed queries feed the percentiles: a shed or
                # failed arrival returns in microseconds
                telemetry.note_query_latency(priority, wall_ns)
            if store is not None:
                profile = self.session._last_query_profile
                mesh = self.session.mesh
                store.append(obs_history.build_capsule(
                    query_id=ctx.ctx_id,
                    mesh_devices=1 if mesh is None else mesh.devices.size,
                    fingerprint=getattr(profile, "fingerprint", None),
                    ok=ok, priority=priority, attempts=ctx.attempt_no,
                    wall_ns=wall_ns, phases=phases,
                    stats=ctx.runtime_stats,
                    summary=getattr(profile, "summary", None),
                    deltas=obs_history.counters_delta(
                        before, obs_history.process_counters())))
        except Exception:  # noqa: BLE001 — observability never masks
            pass

    def _collect_once(self) -> List[tuple]:
        """One attempt: a fresh plan, RuntimeStats and events query id;
        the profile and metrics are harvested even when it fails."""
        import time as _time

        from ..exec import lifecycle
        from ..exec.task_metrics import query_snapshot, query_summary
        from ..obs import events as obs_events
        from ..obs.profile import QueryProfile
        from ..obs.stats import RuntimeStats
        with obs_events.query_scope() as qid:
            # conversion inside the scope: planning events carry the id
            plan = self._exec()
            ctx = lifecycle.current_context()
            stats = RuntimeStats()
            if ctx is not None:
                ctx.runtime_stats = stats
                ctx.root_op_id = plan._op_id
                ctx.events_qid = qid
            before = query_snapshot()
            obs_events.emit("query_start", root=type(plan).__name__)
            t0 = _time.perf_counter_ns()
            ok = False
            try:
                out = plan.collect()
                ok = True
                return out
            finally:
                try:
                    self.session._last_query_metrics = \
                        _operator_metrics(plan)
                    self.session._last_query_profile = QueryProfile(
                        plan, query_summary(plan, before),
                        statistics=stats,
                        phases=ctx.phase_ledger if ctx is not None
                        else None)
                except Exception:  # noqa: BLE001 — must never mask
                    pass
                obs_events.emit(
                    "query_end", root=type(plan).__name__, ok=ok,
                    wall_ns=_time.perf_counter_ns() - t0)

    def _batches(self) -> List[ColumnarBatch]:
        return list(self._exec().execute())

    def to_arrow(self):
        import pyarrow as pa
        tables = [b.to_arrow() for b in self._batches()]
        if not tables:
            from ..types import to_arrow as t2a
            return pa.table({f.name: pa.array([], t2a(f.data_type))
                             for f in self.schema.fields})
        return pa.concat_tables(tables)

    def to_pydict(self) -> Dict:
        out: Dict[str, list] = {n: [] for n in self.columns}
        for b in self._batches():
            for name, values in b.to_pydict().items():
                out[name].extend(values)
        return out

    def to_torch(self) -> Dict:
        """The result on the card as {name: (data, validity)} tensors,
        trimmed to the row count (the JAX package's `to_jax`): no host
        round trip. Fixed-width columns only."""
        from ..columnar.batch import empty_batch
        from ..exec.coalesce import concat_batches
        batches = self._batches()
        if not batches:
            merged = empty_batch(self.schema, device=self.session.device)
        elif len(batches) == 1:
            merged = batches[0]
        else:
            merged = concat_batches(batches, self.schema)
        n = merged.num_rows_host
        out: Dict = {}
        for f, c in zip(self.schema.fields, merged.columns):
            if not f.data_type.is_fixed_width:
                raise TypeError(f"to_torch needs fixed-width columns, "
                                f"{f.name} is {f.data_type.simple_name()}")
            out[f.name] = (c.data[:n], c.validity[:n])
        return out

    def count(self) -> int:
        from ..expr.aggexprs import Count
        rows = self._with(L.LogicalAggregate([], [(Count(), "count")],
                                             self._plan)).collect()
        return rows[0][0]

    def explain(self) -> str:
        return TpuOverrides(self.session.conf).explain(self._plan)

    def logical_plan(self) -> L.LogicalPlan:
        return self._plan

    def write_parquet(self, path,
                      partition_by: Optional[Sequence[str]] = None):
        from ..io.parquet import write_parquet
        write_parquet(self, path, partition_by=partition_by)

    def write_csv(self, path, header: bool = True, delimiter: str = ","):
        from ..io.csv import write_csv
        write_csv(self, path, header=header, delimiter=delimiter)

    def write_json(self, path):
        from ..io.json import write_json
        write_json(self, path)

    def write_orc(self, path):
        from ..io.orc import write_orc
        write_orc(self, path)

    def write_avro(self, path, codec: str = "deflate"):
        from ..io.avro import write_avro
        write_avro(self, path, codec=codec)

    def write_delta(self, path, mode: str = "append",
                    partition_by: Optional[Sequence[str]] = None):
        from ..delta import write_delta
        write_delta(self, path, mode=mode, partition_by=partition_by)

    def write_iceberg(self, path, mode: str = "append"):
        from ..io.iceberg import write_iceberg
        write_iceberg(self, path, mode=mode)

    def write_hive_text(self, path, **options):
        from ..io.hivetext import write_hive_text
        write_hive_text(self, path, **options)

    def _with(self, plan: L.LogicalPlan) -> "DataFrame":
        return DataFrame(plan, self.session)


def _to_schema(schema) -> Schema:
    if not isinstance(schema, Schema):
        raise TypeError("pandas UDF output schema must be a Schema")
    return schema


def _named_pandas_fns(specs):
    """Normalize (fn, name, result_type, inputs...) pandas-UDF specs: the
    inputs may be varargs or one list/tuple."""
    named = []
    for fn, name, rt, *ins in specs:
        exprs = [_to_expr(e) for e in
                 (ins[0] if len(ins) == 1
                  and isinstance(ins[0], (list, tuple)) else ins)]
        named.append((fn, name, rt, exprs))
    return named


class CoGroupedData:
    def __init__(self, left: "GroupedData", right: "GroupedData"):
        self.left = left
        self.right = right

    def apply_in_pandas(self, fn, schema) -> DataFrame:
        """fn(left_group_df, right_group_df) -> DataFrame per key in
        either input (reference GpuFlatMapCoGroupsInPandasExec)."""
        return self.left.df._with(L.LogicalCoGroupedMapInPandas(
            self.left.keys, self.right.keys, fn, _to_schema(schema),
            self.left.df._plan, self.right.df._plan))

    applyInPandas = apply_in_pandas


class GroupedData:
    def __init__(self, keys: List[Expression], df: DataFrame):
        self.keys = keys
        self.df = df

    def agg(self, *aggs) -> DataFrame:
        named: List[Tuple[AggregateFunction, str]] = []
        for a in aggs:
            if isinstance(a, tuple):
                named.append(a)
            else:
                if not isinstance(a, AggregateFunction):
                    raise TypeError(f"not an aggregate function: {a!r}")
                default = f"{a.name}({', '.join(map(repr, a.inputs))})" \
                    if a.inputs else f"{a.name}(*)"
                named.append((a, default))
        return self.df._with(L.LogicalAggregate(self.keys, named,
                                                self.df._plan))

    def apply_in_pandas(self, fn, schema) -> DataFrame:
        """Spark df.groupBy(...).applyInPandas(fn, schema): fn receives
        each group as a pandas DataFrame and returns a DataFrame matching
        `schema` (reference GpuFlatMapGroupsInPandasExec.scala:79)."""
        return self.df._with(L.LogicalGroupedMapInPandas(
            self.keys, fn, _to_schema(schema), self.df._plan))

    applyInPandas = apply_in_pandas

    def agg_in_pandas(self, *aggs) -> DataFrame:
        """Grouped pandas aggregates: each agg is (fn, name, result_type,
        input columns/exprs...); fn receives one pandas Series per input
        and returns a scalar (reference GpuAggregateInPandasExec)."""
        key_names = [getattr(k, "name", f"key_{i}")
                     for i, k in enumerate(self.keys)]
        return self.df._with(L.LogicalAggregateInPandas(
            self.keys, key_names, _named_pandas_fns(aggs), self.df._plan))

    def cogroup(self, other: "GroupedData") -> CoGroupedData:
        """Spark df.groupBy(k).cogroup(other.groupBy(k))."""
        return CoGroupedData(self, other)
