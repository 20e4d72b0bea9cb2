"""Logical plan nodes — the counterpart of spark_rapids_tpu/plan/logical.py,
the engine's Catalyst analog: a small logical algebra that the override
layer (overrides.py) wraps, tags and converts to TpuExec trees (reference
GpuOverrides.scala wrap/tag/convert over SparkPlan).

These are the nodes the ported DataFrame methods build, the expand
node of grouping sets, and the pandas UDF family's five nodes (their
operators are exec/python_udf.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..expr.aggexprs import AggregateFunction
from ..expr.core import Expression
from ..types import LongType, Schema, StructField


class LogicalPlan:
    children: Tuple["LogicalPlan", ...] = ()

    @property
    def schema(self) -> Schema:
        raise NotImplementedError(type(self).__name__)

    def node_name(self) -> str:
        return type(self).__name__.removeprefix("Logical")

    def describe(self) -> str:
        return self.node_name()

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.describe()]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)


class LogicalScan(LogicalPlan):
    """In-memory or datasource scan. `source` is any object with
    `.schema` and `.batches()` (io/ readers provide these)."""

    def __init__(self, source):
        self.source = source

    @property
    def schema(self) -> Schema:
        return self.source.schema

    def describe(self):
        return f"Scan {type(self.source).__name__}"


class LogicalRange(LogicalPlan):
    """`device` is the session's: a range has no batches to take it from."""

    def __init__(self, start: int, end: int, step: int = 1, name: str = "id",
                 device=None):
        self.start, self.end, self.step, self.name = start, end, step, name
        self.device = device

    @property
    def schema(self) -> Schema:
        return Schema((StructField(self.name, LongType(), False),))

    def describe(self):
        return f"Range({self.start}, {self.end}, {self.step})"


class LogicalProject(LogicalPlan):
    def __init__(self, exprs: Sequence[Expression], child: LogicalPlan):
        self.exprs = list(exprs)
        self.children = (child,)

    @property
    def schema(self) -> Schema:
        from ..exec.basic import projection_schema
        return projection_schema(self.exprs, self.children[0].schema)

    def describe(self):
        return f"Project [{', '.join(map(repr, self.exprs))}]"


class LogicalFilter(LogicalPlan):
    def __init__(self, condition: Expression, child: LogicalPlan):
        self.condition = condition
        self.children = (child,)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def describe(self):
        return f"Filter [{self.condition!r}]"


class LogicalAggregate(LogicalPlan):
    def __init__(self, group_exprs: Sequence[Expression],
                 aggregates: Sequence[Tuple[AggregateFunction, str]],
                 child: LogicalPlan):
        self.group_exprs = list(group_exprs)
        self.aggregates = list(aggregates)
        self.children = (child,)

    @property
    def schema(self) -> Schema:
        from ..exec.aggregate import AggregateExec
        from ..exec.basic import InMemoryScanExec
        probe = AggregateExec(self.group_exprs, self.aggregates,
                              InMemoryScanExec([], self.children[0].schema))
        return probe.output_schema

    def describe(self):
        aggs = ", ".join(f"{fn!r} AS {n}" for fn, n in self.aggregates)
        return f"Aggregate keys={self.group_exprs!r} [{aggs}]"


class LogicalJoin(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 join_type: str = "inner",
                 condition: Optional[Expression] = None):
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.join_type = join_type
        self.condition = condition
        self.children = (left, right)

    @property
    def schema(self) -> Schema:
        from ..exec.joins import join_output_schema
        return join_output_schema(self.children[0].schema,
                                  self.children[1].schema, self.join_type)

    def describe(self):
        return (f"Join {self.join_type} lkeys={self.left_keys!r} "
                f"rkeys={self.right_keys!r}")


class LogicalSort(LogicalPlan):
    def __init__(self, orders: Sequence, child: LogicalPlan,
                 limit: Optional[int] = None, offset: int = 0):
        self.orders = list(orders)
        self.limit = limit
        self.offset = offset
        self.children = (child,)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def describe(self):
        return f"Sort {self.orders!r} limit={self.limit} offset={self.offset}"


class LogicalLimit(LogicalPlan):
    def __init__(self, limit: int, child: LogicalPlan, offset: int = 0):
        self.limit = limit
        self.offset = offset
        self.children = (child,)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def describe(self):
        return f"Limit {self.limit} offset={self.offset}"


class LogicalUnion(LogicalPlan):
    def __init__(self, *children: LogicalPlan):
        self.children = tuple(children)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema


class LogicalExpand(LogicalPlan):
    def __init__(self, projections: Sequence[Sequence[Expression]],
                 child: LogicalPlan):
        self.projections = [list(p) for p in projections]
        self.children = (child,)

    @property
    def schema(self) -> Schema:
        from ..exec.basic import projection_schema
        return projection_schema(self.projections[0],
                                 self.children[0].schema)


class LogicalSample(LogicalPlan):
    """Bernoulli row sample (Spark df.sample; reference GpuSampleExec /
    GpuPoissonSampler)."""

    def __init__(self, fraction: float, seed: int, child: LogicalPlan):
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"sample fraction {fraction} outside [0, 1]")
        self.fraction = fraction
        self.seed = seed
        self.children = (child,)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def describe(self):
        return f"Sample[fraction={self.fraction}, seed={self.seed}]"


class LogicalRepartition(LogicalPlan):
    """Explicit repartition (Spark df.repartition/coalesce(1); reference
    GpuRoundRobinPartitioning / GpuSinglePartitioning exchanges)."""

    def __init__(self, n_partitions: int, child: LogicalPlan,
                 mode: str = "roundrobin"):
        self.n_partitions = n_partitions
        self.mode = mode  # roundrobin | single
        self.children = (child,)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def describe(self):
        return f"Repartition[{self.mode}, n={self.n_partitions}]"


class LogicalGenerate(LogicalPlan):
    """explode/posexplode of an array expression (reference
    GpuGenerateExec.scala:829)."""

    def __init__(self, generator: Expression, child: LogicalPlan,
                 outer: bool = False, position: bool = False,
                 elem_name: str = "col", pos_name: str = "pos"):
        self.generator = generator
        self.outer = outer
        self.position = position
        self.elem_name = elem_name
        self.pos_name = pos_name
        self.children = (child,)

    @property
    def schema(self) -> Schema:
        from ..expr.core import resolve
        from ..types import ArrayType, IntegerType, MapType
        arr_t = resolve(self.generator, self.children[0].schema).data_type
        if not isinstance(arr_t, (ArrayType, MapType)):
            raise TypeError(f"explode needs an ARRAY or MAP input, got "
                            f"{arr_t.simple_name()}")
        fields = list(self.children[0].schema.fields)
        if self.position:
            fields.append(StructField(self.pos_name, IntegerType(),
                                      self.outer))
        if isinstance(arr_t, MapType):
            # explode(map) emits (key, value) pairs, as Spark does
            fields.append(StructField("key", arr_t.key_type, self.outer))
            fields.append(StructField("value", arr_t.value_type, True))
        else:
            fields.append(StructField(self.elem_name, arr_t.element_type,
                                      True))
        return Schema(tuple(fields))

    def describe(self):
        kind = "PosExplode" if self.position else "Explode"
        return f"Generate {kind}{' outer' if self.outer else ''} " \
            f"{self.generator!r}"


class LogicalWindow(LogicalPlan):
    def __init__(self, window_exprs, child: LogicalPlan):
        self.window_exprs = list(window_exprs)
        self.children = (child,)

    @property
    def schema(self) -> Schema:
        from ..exec.basic import InMemoryScanExec
        from ..exec.window import WindowExec
        probe = WindowExec(self.window_exprs,
                           InMemoryScanExec([], self.children[0].schema))
        return probe.output_schema

    def describe(self):
        return "Window [" + ", ".join(
            f"{we!r} AS {n}" for we, n in self.window_exprs) + "]"


class LogicalGroupedMapInPandas(LogicalPlan):
    """df.groupBy(keys).applyInPandas(fn, schema) — reference
    GpuFlatMapGroupsInPandasExec.scala:79."""

    def __init__(self, keys, fn, out_schema: Schema, child: LogicalPlan):
        self.keys = list(keys)
        self.fn = fn
        self.out_schema = out_schema
        self.children = (child,)

    @property
    def schema(self) -> Schema:
        return self.out_schema

    def describe(self):
        return f"GroupedMapInPandas[{getattr(self.fn, '__name__', 'fn')}]"


class LogicalAggregateInPandas(LogicalPlan):
    """df.groupBy(keys).agg(pandas_udf...) — reference
    GpuAggregateInPandasExec.scala."""

    def __init__(self, keys, key_names, aggs, child: LogicalPlan):
        self.keys = list(keys)
        self.key_names = list(key_names)
        self.aggs = list(aggs)  # (fn, name, result type, [input exprs])
        self.children = (child,)

    @property
    def schema(self) -> Schema:
        from ..expr.core import resolve
        child = self.children[0].schema
        fields = [StructField(n, resolve(k, child).data_type)
                  for n, k in zip(self.key_names, self.keys)]
        fields += [StructField(name, rt) for _, name, rt, _ in self.aggs]
        return Schema(tuple(fields))

    def describe(self):
        return f"AggregateInPandas[{len(self.aggs)} aggs]"


class LogicalMapInBatch(LogicalPlan):
    """df.mapInPandas(fn, schema) — reference GpuMapInBatchExec.scala."""

    def __init__(self, fn, out_schema: Schema, child: LogicalPlan):
        self.fn = fn
        self.out_schema = out_schema
        self.children = (child,)

    @property
    def schema(self) -> Schema:
        return self.out_schema

    def describe(self):
        return f"MapInPandas[{getattr(self.fn, '__name__', 'fn')}]"


class LogicalCoGroupedMapInPandas(LogicalPlan):
    """cogroup(...).applyInPandas(fn, schema) — reference
    GpuFlatMapCoGroupsInPandasExec.scala."""

    def __init__(self, left_keys, right_keys, fn, out_schema: Schema,
                 left: LogicalPlan, right: LogicalPlan):
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.fn = fn
        self.out_schema = out_schema
        self.children = (left, right)

    @property
    def schema(self) -> Schema:
        return self.out_schema

    def describe(self):
        return "CoGroupedMapInPandas"


class LogicalWindowInPandas(LogicalPlan):
    """Whole-partition pandas window UDF — reference
    GpuWindowInPandasExecBase.scala."""

    def __init__(self, part_exprs, wins, child: LogicalPlan):
        self.part_exprs = list(part_exprs)
        self.wins = list(wins)  # (fn, name, result type, [input exprs])
        self.children = (child,)

    @property
    def schema(self) -> Schema:
        fields = list(self.children[0].schema.fields)
        fields += [StructField(name, rt) for _, name, rt, _ in self.wins]
        return Schema(tuple(fields))

    def describe(self):
        return f"WindowInPandas[{len(self.wins)} fns]"
