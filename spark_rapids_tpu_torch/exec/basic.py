"""Basic execs — the counterpart of the scan, filter and project execs of
spark_rapids_tpu/exec/basic.py.

Filter and project also offer `fused_step`: an AggregateExec absorbs the
chain above its source into its own per-batch step (whole-stage fusion),
where the filter becomes a row mask and no intermediate column is
compacted or materialized.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

from ..columnar.batch import ColumnarBatch
from ..expr.core import Expression, output_name, resolve
from ..ops.basic import compact_columns, sanitize
from ..types import Schema, StructField
from .base import TpuExec


class InMemoryScanExec(TpuExec):
    """Leaf feeding pre-built device batches."""

    def __init__(self, batches: Sequence[ColumnarBatch], schema: Schema):
        super().__init__()
        self._batches = list(batches)
        self._schema = schema

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        yield from self._batches


def bind_projection(exprs: Sequence[Expression], schema: Schema
                    ) -> List[Expression]:
    return [resolve(e, schema) for e in exprs]


def projection_schema(exprs: Sequence[Expression], schema: Schema) -> Schema:
    bound = bind_projection(exprs, schema)
    fields = [StructField(output_name(exprs[i], f"col{i}"), e.data_type,
                          e.nullable)
              for i, e in enumerate(bound)]
    return Schema(tuple(fields))


def eval_projection(bound: Sequence[Expression], batch: ColumnarBatch,
                    schema: Schema) -> ColumnarBatch:
    cols = [sanitize(e.columnar_eval(batch), batch.num_rows) for e in bound]
    return batch.with_columns(cols, schema)


class ProjectExec(TpuExec):
    def __init__(self, exprs: Sequence[Expression], child: TpuExec):
        super().__init__(child)
        self.exprs = list(exprs)
        self._schema = projection_schema(self.exprs, child.output_schema)
        self._bound = bind_projection(self.exprs, child.output_schema)

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute():
            yield eval_projection(self._bound, batch, self._schema)

    def fused_step(self):
        """Whole-stage fusion hook: this operator as a pure step a consumer
        inlines into its own per-batch step."""
        return ("project", self._bound, self._schema)


class FilterExec(TpuExec):
    def __init__(self, condition: Expression, child: TpuExec):
        super().__init__(child)
        self.condition = condition
        self._bound = resolve(condition, child.output_schema)

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute():
            pred = self._bound.columnar_eval(batch)
            # Spark: null predicate rows are dropped
            keep = pred.data & pred.validity
            cols, n = compact_columns(batch.columns, keep, batch.num_rows)
            yield ColumnarBatch(cols, n, batch.schema)

    def fused_step(self):
        """Fusion hook: in a fused stage the filter contributes a row MASK
        (ANDed into the consumer's reductions) instead of a compaction."""
        return ("filter", self._bound)
