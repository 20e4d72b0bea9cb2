"""Device higher-order functions over array columns — the counterpart of
spark_rapids_tpu/ops/array_hof.py (reference higherOrderFunctions.scala,
GpuArrayTransform etc.).

A lambda over elements is the body expression evaluated on the CHILD
column, one flat pass over every element of every row. The per-row
reductions (filter's counts, exists/forall) count flags over each row's
contiguous element span with one cumsum (ops/strings.span_sums), where the
JAX package reduces by each element's row (`segment_sum`,
`segment_max`); filter's compaction finds each kept element's source by
a search of that cumsum, where the JAX package scatters.

Scope, as in the JAX package: bodies whose leaves are the lambda
variable and literals, over arrays that are not nested. The other shapes
run on the host row engine (exec/fallback.py), placed there by the planner
(expr/collectionexprs._HostHOF.device_supported).
"""

from __future__ import annotations

import torch

from ..columnar.column import ArrayColumn, Column
from ..expr.core import LeafExpression
from ..types import BOOLEAN, ArrayType
from .strings import kth_set, span_sums


class _ElemBatch:
    """The batch facade a lambda body evaluates over: the child column's
    element count and capacity, and its device. Expressions read no
    columns of it (the body's only column is the bound variable)."""

    def __init__(self, num_rows, capacity: int, device):
        self.num_rows = num_rows
        self.capacity = capacity
        self.device = device


class _BoundElem(LeafExpression):
    """Expression leaf yielding the child column (the bound lambda var)."""

    def __init__(self, col: Column):
        self._col = col

    @property
    def data_type(self):
        return self._col.dtype

    def columnar_eval(self, batch):
        return self._col


def _in_use(arr: ArrayColumn) -> torch.Tensor:
    return torch.arange(arr.child_capacity, dtype=torch.int32,
                        device=arr.device) < arr.offsets[arr.capacity]


def eval_lambda(body, var: str, arr: ArrayColumn) -> Column:
    """Evaluate `body` (over LambdaVar `var`) elementwise on the child."""
    from ..expr.collectionexprs import LambdaVar
    child = arr.child
    leaf = _BoundElem(child)
    bound = body.transform_up(
        lambda n: leaf if isinstance(n, LambdaVar) and n.name == var
        else n)
    return bound.columnar_eval(_ElemBatch(arr.offsets[arr.capacity],
                                          child.capacity, arr.device))


def array_transform(arr: ArrayColumn, body, var: str) -> ArrayColumn:
    out = eval_lambda(body, var, arr)
    return ArrayColumn(out, arr.offsets, arr.validity, ArrayType(out.dtype))


def array_filter(arr: ArrayColumn, body, var: str) -> ArrayColumn:
    """filter(arr, x -> p): the elements whose predicate is TRUE, in
    order. As in the JAX package, every in-use element takes part in the
    compaction and a null row's count is zero."""
    from .basic import gather_column
    from .strings import _rebuild_offsets
    pred = eval_lambda(body, var, arr)
    keep = pred.data & pred.validity & _in_use(arr)
    csum, _, counts = span_sums(keep, arr.offsets)
    counts = torch.where(arr.validity, counts, 0)
    new_off = _rebuild_offsets(counts)
    ccap = arr.child_capacity
    k = torch.arange(ccap, dtype=torch.int32, device=arr.device)
    # kept element k (in order) comes from the position where the
    # count of kept elements reaches k + 1
    src = kth_set(csum, k + 1)
    out_valid = k < new_off[arr.capacity]
    child = gather_column(arr.child, torch.where(out_valid, src, -1))
    return ArrayColumn(child, new_off, arr.validity, arr.dtype)


def _exists_forall(arr: ArrayColumn, body, var: str,
                   forall: bool) -> Column:
    pred = eval_lambda(body, var, arr)
    in_use = _in_use(arr)

    def any_of(flag):
        return span_sums(flag, arr.offsets)[2] > 0
    if forall:
        # false if any false; else null if any null; else true
        hit = any_of(~pred.data & pred.validity & in_use)
        result = ~hit
    else:
        # true if any true; else null if any null; else false
        hit = any_of(pred.data & pred.validity & in_use)
        result = hit
    known = hit | ~any_of(~pred.validity & in_use)
    valid = arr.validity & known
    return Column(result & valid, valid, BOOLEAN)


def array_exists(arr: ArrayColumn, body, var: str) -> Column:
    return _exists_forall(arr, body, var, forall=False)


def array_forall(arr: ArrayColumn, body, var: str) -> Column:
    return _exists_forall(arr, body, var, forall=True)
