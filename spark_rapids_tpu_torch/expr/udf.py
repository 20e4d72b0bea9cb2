"""Python UDFs — the counterpart of spark_rapids_tpu/expr/udf.py, the
engine's analog of Spark's Arrow-batched Python UDF path (reference
GpuPythonUDF / GpuArrowEvalPythonExec: the data stays columnar across the
worker boundary).

The JAX package splices the host round trip into its compiled program
with `jax.pure_callback`. Here a batch makes it explicitly: one packed
device->host copy of the children's leaves and the row count
(columnar/transfer.fetch_batch_host), the Python function run row by row
over the decoded values (None for a null), and one packed upload of the
result (columnar/upload.to_device_batch). `counters()` counts the round
trips and the rows, as the port counts its other host reads.

Numeric, boolean and string inputs; a numeric or boolean result (a
string result would need dynamic byte buckets). The planner's rule
(plan/overrides.py) tags off other types, as the JAX package's does.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

import numpy as np
import torch

from ..columnar.column import Column
from ..types import DataType, Schema, StructField
from .core import Expression

_LOCK = threading.Lock()
_COUNTERS = {"round_trips": 0, "rows": 0}


def counters() -> Dict[str, int]:
    """Host round trips made by Python UDFs (one a batch) and the rows
    they carried."""
    with _LOCK:
        return dict(_COUNTERS)


def _note(rows: int) -> None:
    with _LOCK:
        _COUNTERS["round_trips"] += 1
        _COUNTERS["rows"] += rows


class PythonUDF(Expression):
    def __init__(self, fn: Callable, return_type: DataType,
                 *children: Expression, name: str = None):
        if not return_type.is_fixed_width:
            raise ValueError("Python UDFs return fixed-width types (string "
                             "outputs need dynamic byte buckets)")
        self.fn = fn
        self.return_type = return_type
        self.children = tuple(children)
        self.fn_name = name or getattr(fn, "__name__", "udf")

    def with_children(self, children):
        return PythonUDF(self.fn, self.return_type, *children,
                         name=self.fn_name)

    @property
    def data_type(self):
        return self.return_type

    def columnar_eval(self, batch) -> Column:
        from ..columnar.batch import ColumnarBatch
        from ..columnar.transfer import fetch_batch_host
        from ..columnar.upload import to_device_batch
        cols = [c.columnar_eval(batch) for c in self.children]
        schema = Schema(tuple(StructField(f"c{i}", c.dtype)
                              for i, c in enumerate(cols)))
        args = ColumnarBatch(cols, batch.num_rows, schema)
        host, n = fetch_batch_host(args)          # the one copy down
        vals = [c.to_pylist(n) for c in host]
        cap = batch.capacity
        out = np.zeros(cap, dtype=self.return_type.np_dtype)
        ok = np.zeros(cap, dtype=np.bool_)
        fn = self.fn
        for r in range(n):
            res = fn(*(v[r] for v in vals))
            if res is not None:
                out[r] = res
                ok[r] = True
        _note(n)
        col = Column(torch.from_numpy(out), torch.from_numpy(ok),
                     self.return_type)
        dev = batch.device
        if dev.type == "cpu":
            return col
        up = to_device_batch([col], n, Schema((StructField(
            "udf", self.return_type),)), dev)   # the one copy up
        return up.columns[0]

    def __repr__(self):
        return f"udf:{self.fn_name}({', '.join(map(repr, self.children))})"


def udf(fn: Callable = None, *, return_type: DataType = None):
    """Spark's F.udf surface: `udf(lambda x: ..., return_type=LONG)` or
    `@udf(return_type=LONG)`. Returns a function that makes PythonUDF
    expressions over its column arguments (a str argument names a
    column)."""
    from .core import col, lit

    if return_type is None:
        raise TypeError(
            "udf(...) requires return_type= (a fixed-width DataType); "
            "e.g. F.udf(lambda x: x + 1, return_type=LONG)")

    def wrap(f):
        def build(*args):
            exprs = [a if isinstance(a, Expression)
                     else col(a) if isinstance(a, str) else lit(a)
                     for a in args]
            return PythonUDF(f, return_type, *exprs)
        build.__name__ = getattr(f, "__name__", "udf")
        return build

    if fn is not None:
        return wrap(fn)
    return wrap
