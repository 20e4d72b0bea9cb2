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
so the execs built for a query read it at construction.

`collect()` is `TpuOverrides(conf).apply(plan).collect()`, with the exact
re-run of exec/base.collect. Left out with the governance planes (ROADMAP
A.9): the lifecycle and workload governors, task retry, phase attribution,
the query history, telemetry, the faults and the health surfaces
(`cancel_query`, `health`, `active_queries`, `last_query_profile`).
`last_query_metrics()` is the executed plan's operator metrics. The other
methods raise NotImplementedError naming their items: the pandas UDFs
(A.8 wave 4), windows, explode and cache (A.8 wave 3), the other
readers (A.8 wave 5) and the writers (Parquet's with A.5, the others with
A.8 wave 5).
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


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} waits for its slice (ROADMAP {item})")


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
    def __init__(self, conf: Optional[Dict] = None, device=None):
        from ..columnar import upload
        self.conf = RapidsConf(conf or {})
        self.device = resolve_device(device)
        set_active_conf(self.conf)
        # pre-size the upload staging pool's buckets from batchSizeBytes
        upload.configure(self.conf)
        #: the operator metrics of the last collect()
        self._last_query_metrics = None

    def last_query_metrics(self) -> Optional[Dict[str, Dict[str, int]]]:
        """Per operator of the last collect()'s executed plan
        ("<Exec>#<id>"), its metrics. The JAX package's task-level
        roll-up (semaphore wait, retries, spill volumes) waits for A.9."""
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

    def read_csv(self, path, *args, **options) -> "DataFrame":
        _not_ported("read_csv", "A.8 wave 5")

    def read_json(self, path, *args, **options) -> "DataFrame":
        _not_ported("read_json", "A.8 wave 5")

    def read_orc(self, path, *args, **options) -> "DataFrame":
        _not_ported("read_orc", "A.8 wave 5")

    def read_iceberg(self, path, *args, **options) -> "DataFrame":
        _not_ported("read_iceberg", "A.8 wave 5")

    def read_hive_text(self, path, *args, **options) -> "DataFrame":
        _not_ported("read_hive_text", "A.8 wave 5")

    def read_delta(self, path, *args, **options) -> "DataFrame":
        _not_ported("read_delta", "A.8 wave 5")

    def read_avro(self, path, *args, **options) -> "DataFrame":
        _not_ported("read_avro", "A.8 wave 5")

    def cancel_query(self) -> int:
        _not_ported("cancel_query", "A.9")

    def health(self) -> Dict:
        _not_ported("health", "A.9")

    def active_queries(self) -> List[Dict]:
        _not_ported("active_queries", "A.9")

    def last_query_profile(self):
        _not_ported("last_query_profile", "A.9")

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
        _not_ported("with_windows", "A.8 wave 3")

    def explode(self, column, *args, **kwargs) -> "DataFrame":
        _not_ported("explode", "A.8 wave 3")

    def posexplode(self, column, *args, **kwargs) -> "DataFrame":
        _not_ported("posexplode", "A.8 wave 3")

    def cache(self) -> "DataFrame":
        _not_ported("cache", "A.8 wave 3")

    def unpersist(self) -> "DataFrame":
        _not_ported("unpersist", "A.8 wave 3")

    def map_in_pandas(self, fn, schema) -> "DataFrame":
        _not_ported("map_in_pandas", "A.8 wave 4")

    mapInPandas = map_in_pandas

    def window_in_pandas(self, partition_by, *wins) -> "DataFrame":
        _not_ported("window_in_pandas", "A.8 wave 4")

    # -- actions -----------------------------------------------------------
    def _exec(self):
        """The converted plan, under the session's conf."""
        from ..columnar import upload
        set_active_conf(self.session.conf)
        upload.configure(self.session.conf)
        return TpuOverrides(self.session.conf).apply(self._plan)

    def collect(self) -> List[tuple]:
        plan = self._exec()
        try:
            return plan.collect()
        finally:
            self.session._last_query_metrics = _operator_metrics(plan)

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

    def write_parquet(self, path, partition_by=None):
        _not_ported("write_parquet", "A.5")

    def write_csv(self, path, *args, **options):
        _not_ported("write_csv", "A.8 wave 5")

    def write_json(self, path, *args, **options):
        _not_ported("write_json", "A.8 wave 5")

    def write_orc(self, path, *args, **options):
        _not_ported("write_orc", "A.8 wave 5")

    def write_avro(self, path, *args, **options):
        _not_ported("write_avro", "A.8 wave 5")

    def write_delta(self, path, *args, **options):
        _not_ported("write_delta", "A.8 wave 5")

    def write_iceberg(self, path, *args, **options):
        _not_ported("write_iceberg", "A.8 wave 5")

    def write_hive_text(self, path, *args, **options):
        _not_ported("write_hive_text", "A.8 wave 5")

    def _with(self, plan: L.LogicalPlan) -> "DataFrame":
        return DataFrame(plan, self.session)


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
        _not_ported("apply_in_pandas", "A.8 wave 4")

    applyInPandas = apply_in_pandas

    def agg_in_pandas(self, *aggs) -> DataFrame:
        _not_ported("agg_in_pandas", "A.8 wave 4")

    def cogroup(self, other: "GroupedData"):
        _not_ported("cogroup", "A.8 wave 4")
