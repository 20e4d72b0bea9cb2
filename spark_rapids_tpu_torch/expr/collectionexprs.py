"""Collection (array) expressions — the counterpart of spark_rapids_tpu/
expr/collectionexprs.py (reference collectionOperations.scala: GpuSize,
GpuArrayContains, GpuElementAt (arrays and maps), GpuGetArrayItem,
GpuSortArray, GpuArrayMin/Max, GpuCreateArray, and the device kernels of
GpuArrayPosition, GpuArrayRemove, GpuArrayDistinct, GpuSlice, GpuFlatten,
GpuArraysOverlap, GpuArrayRepeat and GpuSequence; higherOrderFunctions.
scala: the lambdas transform, filter, exists, forall and aggregate).

Some shapes of the second family and of the lambdas run on the host row
engine (exec/fallback.py), as in the JAX package: string elements,
per-row counts and bounds, all of ArrayJoin and ArrayAggregate, and
lambda bodies that read an outer column or run over nested arrays. Each
class says whether an instance has a device path (`device_supported`);
the planner places the others on the host, where `host_eval_row` (or
`host_eval_with_row`, for a lambda) gives one row's value.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column, MapColumn, bucket_capacity
from ..ops import collection as C
from ..types import (BOOLEAN, INT, LONG, NULL, STRING, ArrayType, ByteType,
                     IntegerType, LongType, MapType, ShortType)
from .core import Expression, Literal


def _value(x):
    return x.value if isinstance(x, Literal) else x


class Size(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, children):
        return Size(children[0])

    @property
    def data_type(self):
        return INT

    def columnar_eval(self, batch):
        return C.array_size(self.children[0].columnar_eval(batch))


class ArrayContains(Expression):
    def __init__(self, child: Expression, value):
        self.children = (child,)
        self.value = _value(value)

    def with_children(self, children):
        return ArrayContains(children[0], self.value)

    @property
    def data_type(self):
        return BOOLEAN

    def columnar_eval(self, batch):
        return C.array_contains(self.children[0].columnar_eval(batch),
                                self.value)


class ElementAt(Expression):
    """element_at(arr, i): 1-based, negative from the end, null out of
    bounds (non-ANSI); an expression index is read per row."""

    def __init__(self, child: Expression, index):
        if isinstance(index, Expression) and not isinstance(index, Literal):
            self.children = (child, index)
            self.index = None
        else:
            self.children = (child,)
            self.index = _value(index)

    def with_children(self, children):
        return type(self)(children[0],
                          children[1] if len(children) == 2 else self.index)

    @property
    def data_type(self):
        ct = self.children[0].data_type
        if isinstance(ct, MapType):
            return ct.value_type
        return ct.element_type

    def columnar_eval(self, batch):
        c = self.children[0].columnar_eval(batch)
        key = self.children[1].columnar_eval(batch) \
            if len(self.children) == 2 else self.index
        if isinstance(c, MapColumn):
            from ..ops.maps import map_get
            return map_get(c, key)
        if len(self.children) == 2:
            return C.element_at_col(c, key)
        if self.index == 0:
            # Spark raises even in non-ANSI mode; the per-row index path
            # gives NULL (ops/collection.element_at_col)
            raise ValueError("SQL array indices start at 1")
        return C.element_at(c, self.index)

    def host_eval_row(self, *vals):
        v = vals[0]
        i = vals[1] if len(self.children) == 2 else self.index
        if len(self.children) == 1 and i == 0 \
                and not isinstance(self.children[0].data_type, MapType):
            # a literal 0 raises before the null check, as on the device
            raise ValueError("SQL array indices start at 1")
        if v is None or i is None:
            return None
        if isinstance(v, dict):
            return v.get(i)
        if i == 0 or abs(i) > len(v):
            # a per-row 0 gives NULL, as ops/collection.element_at_col
            return None
        return v[i - 1] if i > 0 else v[i]


class GetArrayItem(ElementAt):
    """arr[i]: 0-based, null out of bounds, for a negative index or a null
    array or index (non-ANSI). A column index is read per row. The JAX
    package gives NULL on every row for a column index (ROADMAP C.5);
    the port gives Spark's rows, a deliberate change of scope."""

    def columnar_eval(self, batch):
        c = self.children[0].columnar_eval(batch)
        if len(self.children) == 2:
            return C.get_array_item_col(
                c, self.children[1].columnar_eval(batch))
        return C.get_array_item(c, self.index)

    def host_eval_row(self, *vals):
        v = vals[0]
        i = vals[1] if len(self.children) == 2 else self.index
        if v is None or i is None or not 0 <= i < len(v):
            return None
        return v[i]


class SortArray(Expression):
    def __init__(self, child: Expression, ascending: bool = True):
        self.children = (child,)
        self.ascending = _value(ascending)

    def with_children(self, children):
        return SortArray(children[0], self.ascending)

    @property
    def data_type(self):
        return self.children[0].data_type

    def columnar_eval(self, batch):
        return C.sort_array(self.children[0].columnar_eval(batch),
                            self.ascending)


class ArrayMin(Expression):
    OP = "min"

    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, children):
        return type(self)(children[0])

    @property
    def data_type(self):
        return self.children[0].data_type.element_type

    def columnar_eval(self, batch):
        return C.array_min_max(self.children[0].columnar_eval(batch),
                               self.OP)


class ArrayMax(ArrayMin):
    OP = "max"


class CreateArray(Expression):
    def __init__(self, *children: Expression):
        self.children = tuple(children)

    def with_children(self, children):
        return CreateArray(*children)

    @property
    def data_type(self):
        return ArrayType(self.children[0].data_type)

    @property
    def nullable(self):
        return False

    def columnar_eval(self, batch):
        return C.create_array([c.columnar_eval(batch)
                               for c in self.children], self.data_type)


# -- the JAX package's host-tier family: device kernels where
# `device_supported` -------------------------------------------------------

class _HostCollection(Expression):
    """Base of the collection expressions that run on the host row engine
    where they have no device kernel."""

    device_supported = True

    def columnar_eval(self, batch):
        raise NotImplementedError(
            f"{type(self).__name__} runs on the host row engine "
            "(exec/fallback.py)")


def _host_spark_eq(a, b) -> bool:
    """Spark's ordering equality on the host: NaN equals NaN, -0.0 is not
    0.0 (java.lang.Double.compare)."""
    import math
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) and math.isnan(b):
            return True
        if a == 0.0 and b == 0.0:
            return math.copysign(1.0, a) == math.copysign(1.0, b)
    return a == b


def _fixed_width_elems(expr) -> bool:
    """The device gate: an array of fixed-width (not nested, not string)
    elements."""
    try:
        dt = expr.data_type
    except TypeError:
        return False
    return isinstance(dt, ArrayType) and dt.element_type.is_fixed_width


class ArrayPosition(_HostCollection):
    """array_position(arr, v): the 1-based first index, 0 if absent."""

    def __init__(self, child: Expression, value: Expression):
        self.children = (child, value)

    def with_children(self, cs):
        return ArrayPosition(cs[0], cs[1])

    @property
    def device_supported(self):
        return _fixed_width_elems(self.children[0])

    @property
    def data_type(self):
        return LONG

    def columnar_eval(self, batch):
        return C.array_position(self.children[0].columnar_eval(batch),
                                self.children[1].columnar_eval(batch))

    def host_eval_row(self, arr, v):
        if arr is None or v is None:
            return None
        for i, item in enumerate(arr):
            if item is not None and _host_spark_eq(item, v):
                return i + 1
        return 0


class ArrayRemove(_HostCollection):
    def __init__(self, child: Expression, value: Expression):
        self.children = (child, value)

    def with_children(self, cs):
        return ArrayRemove(cs[0], cs[1])

    @property
    def device_supported(self):
        return _fixed_width_elems(self.children[0])

    @property
    def data_type(self):
        return self.children[0].data_type

    def columnar_eval(self, batch):
        return C.array_remove(self.children[0].columnar_eval(batch),
                              self.children[1].columnar_eval(batch))

    def host_eval_row(self, arr, v):
        if arr is None or v is None:
            return None
        return [x for x in arr if x is None or not _host_spark_eq(x, v)]


class ArrayDistinct(_HostCollection):
    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, cs):
        return ArrayDistinct(cs[0])

    @property
    def device_supported(self):
        return _fixed_width_elems(self.children[0])

    @property
    def data_type(self):
        return self.children[0].data_type

    def columnar_eval(self, batch):
        return C.array_distinct(self.children[0].columnar_eval(batch))

    def host_eval_row(self, arr):
        if arr is None:
            return None
        out, saw_null = [], False
        for x in arr:
            if x is None:
                if not saw_null:
                    out.append(None)
                    saw_null = True
            elif x not in out:
                out.append(x)
        return out


class Slice(_HostCollection):
    """slice(arr, start, length): 1-based; a negative start from the
    end."""

    def __init__(self, child: Expression, start: Expression,
                 length: Expression):
        self.children = (child, start, length)

    def with_children(self, cs):
        return Slice(cs[0], cs[1], cs[2])

    @property
    def device_supported(self):
        return _fixed_width_elems(self.children[0])

    @property
    def data_type(self):
        return self.children[0].data_type

    def columnar_eval(self, batch):
        return C.array_slice(*[c.columnar_eval(batch)
                               for c in self.children])

    def host_eval_row(self, arr, start, length):
        if arr is None or start is None or length is None:
            return None
        if start == 0:
            raise ValueError("slice(): start must not be 0")
        if length < 0:
            raise ValueError("slice(): length must be >= 0")
        i = start - 1 if start > 0 else len(arr) + start
        if i < 0:
            return []
        return arr[i: i + length]


class Flatten(_HostCollection):
    """flatten(arr<arr<T>>): a composition of offsets for any element
    type."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, cs):
        return Flatten(cs[0])

    @property
    def device_supported(self):
        try:
            dt = self.children[0].data_type
        except TypeError:
            return False
        return isinstance(dt, ArrayType) \
            and isinstance(dt.element_type, ArrayType)

    @property
    def data_type(self):
        dt = self.children[0].data_type
        return dt.element_type if isinstance(dt, ArrayType) else dt

    def columnar_eval(self, batch):
        return C.flatten_array(self.children[0].columnar_eval(batch))

    def host_eval_row(self, arr):
        if arr is None:
            return None
        out = []
        for sub in arr:
            if sub is None:
                return None  # Spark: a null inner array gives null
            out.extend(sub)
        return out


class ArraysOverlap(_HostCollection):
    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def with_children(self, cs):
        return ArraysOverlap(cs[0], cs[1])

    @property
    def device_supported(self):
        return _fixed_width_elems(self.children[0]) \
            and _fixed_width_elems(self.children[1])

    @property
    def data_type(self):
        return BOOLEAN

    def columnar_eval(self, batch):
        return C.arrays_overlap(self.children[0].columnar_eval(batch),
                                self.children[1].columnar_eval(batch))

    def host_eval_row(self, a, b):
        if a is None or b is None:
            return None
        bs = {x for x in b if x is not None}
        if any(x in bs for x in a if x is not None):
            return True
        # Spark: NULL only when both arrays are non-empty and either holds
        # a null element; an empty side gives false
        if a and b and (None in a or None in b):
            return None
        return False


class ArrayJoin(_HostCollection):
    """array_join: per-row string assembly, on the host row engine only,
    as in the JAX package."""

    device_supported = False

    def __init__(self, child: Expression, delim, null_replacement=None):
        self.children = (child,)
        self.delim = _value(delim)
        self.null_replacement = _value(null_replacement)

    def with_children(self, cs):
        return ArrayJoin(cs[0], self.delim, self.null_replacement)

    @property
    def data_type(self):
        return STRING

    def host_eval_row(self, arr):
        if arr is None:
            return None
        parts = []
        for x in arr:
            if x is None:
                if self.null_replacement is not None:
                    parts.append(self.null_replacement)
            else:
                parts.append(str(x))
        return self.delim.join(parts)


_INTEGRAL = (ByteType, ShortType, IntegerType, LongType)


class Sequence(_HostCollection):
    """sequence(start, stop[, step]): a device kernel when every bound is
    a literal (a static child capacity)."""

    def __init__(self, start: Expression, stop: Expression,
                 step: Expression = None):
        self.children = (start, stop) + ((step,) if step is not None
                                         else ())

    def with_children(self, cs):
        return Sequence(*cs)

    @property
    def device_supported(self):
        if not all(isinstance(c, Literal) and c.value is not None
                   for c in self.children):
            return False
        try:
            return all(isinstance(c.data_type, _INTEGRAL)
                       for c in self.children)
        except TypeError:
            return False

    @property
    def data_type(self):
        return ArrayType(self.children[0].data_type)

    def columnar_eval(self, batch):
        start, stop = self.children[0].value, self.children[1].value
        step = self.children[2].value if len(self.children) > 2 \
            else (1 if stop >= start else -1)
        if step == 0:
            raise ValueError("sequence(): step must not be 0")
        n = max((stop - start) // step + 1, 0) \
            if (stop - start) * step >= 0 else 0
        cols = [c.columnar_eval(batch) for c in self.children]
        cap = cols[0].capacity
        if len(cols) < 3:
            cols.append(Column(torch.full((cap,), step,
                                          dtype=cols[0].data.dtype,
                                          device=cols[0].device),
                               torch.ones(cap, dtype=torch.bool,
                                          device=cols[0].device),
                               cols[0].dtype))
        return C.sequence_array(cols[0], cols[1], cols[2],
                                bucket_capacity(max(int(n) * cap, 1)))

    def host_eval_row(self, start, stop, step=None):
        if start is None or stop is None:
            return None
        if step is None:
            step = 1 if stop >= start else -1
        if step == 0:
            raise ValueError("sequence(): step must not be 0")
        out, v = [], start
        while (v <= stop) if step > 0 else (v >= stop):
            out.append(v)
            v += step
        return out


class ArrayRepeat(_HostCollection):
    """array_repeat(e, n): a device kernel when the count is a literal (a
    static child capacity)."""

    def __init__(self, elem: Expression, count: Expression):
        self.children = (elem, count)

    def with_children(self, cs):
        return ArrayRepeat(cs[0], cs[1])

    @property
    def device_supported(self):
        c = self.children[1]
        if not (isinstance(c, Literal) and c.value is not None):
            return False
        try:
            return self.children[0].data_type.is_fixed_width
        except TypeError:
            return False

    @property
    def data_type(self):
        return ArrayType(self.children[0].data_type)

    def columnar_eval(self, batch):
        elem = self.children[0].columnar_eval(batch)
        count = self.children[1].columnar_eval(batch)
        n = max(int(self.children[1].value), 0)
        return C.array_repeat(elem, count,
                              bucket_capacity(max(n * elem.capacity, 1)))

    def host_eval_row(self, v, n):
        if n is None:
            return None
        return [v] * max(n, 0)


# -- higher-order functions (reference higherOrderFunctions.scala) --------
# Lambdas are expression trees over LambdaVar placeholders, mirroring
# Catalyst's LambdaFunction/NamedLambdaVariable.

class LambdaVar(Expression):
    """Catalyst NamedLambdaVariable analog: a placeholder the function
    binds per element at evaluation time."""

    children = ()

    def __init__(self, name: str = "x"):
        self.name = name

    def with_children(self, cs):
        return self

    @property
    def data_type(self):
        raise TypeError(f"unbound lambda variable {self.name!r}")

    def __repr__(self):
        return f"λ{self.name}"


def _subst(body: Expression, mapping, types=None) -> Expression:
    """`body` with the lambda variables of `mapping` bound to literals of
    their values (typed by `types` where given)."""
    def fn(node):
        if isinstance(node, LambdaVar) and node.name in mapping:
            return Literal(mapping[node.name],
                           (types or {}).get(node.name))
        return node
    return body.transform_up(fn)


class _HostHOF(Expression):
    """Base: children = (array,); `body` is the lambda expression over
    LambdaVar(var)."""

    #: device kernel per subclass (ops/array_hof.py)
    _device_kernel = None

    def __init__(self, child: Expression, body: Expression,
                 var: str = "x"):
        self.children = (child,)
        self.body = body
        self.var = var

    def with_children(self, cs):
        return type(self)(cs[0], self.body, self.var)

    def transform_up(self, fn):
        # the body sees tree rewrites too (column resolution binds outer
        # references inside it; LambdaVars pass through untouched)
        child = self.children[0].transform_up(fn)
        return fn(type(self)(child, self.body.transform_up(fn), self.var))

    @property
    def device_supported(self) -> bool:
        """Bodies whose leaves are the lambda variable and literals, and
        whose every interior operator has a device path, over an array
        that is not nested: one flat pass over the child column."""
        try:
            arr_t = self.children[0].data_type
        except (TypeError, NotImplementedError):
            return False
        if not isinstance(arr_t, ArrayType) \
                or isinstance(arr_t.element_type, ArrayType):
            return False

        def node_ok(node) -> bool:
            if isinstance(node, LambdaVar):
                return node.name == self.var
            if isinstance(node, Literal):
                return True
            try:
                if getattr(node, "device_supported", True) is False:
                    return False
            except (TypeError, NotImplementedError):
                return False
            kids = getattr(node, "children", ())
            return bool(kids) and all(node_ok(c) for c in kids)
        return node_ok(self.body)

    def columnar_eval(self, batch):
        from ..ops import array_hof
        if not self.device_supported:
            raise NotImplementedError(
                f"{type(self).__name__} of this lambda runs on the host "
                "row engine (exec/fallback.py)")
        arr = self.children[0].columnar_eval(batch)
        return getattr(array_hof, self._device_kernel)(arr, self.body,
                                                       self.var)

    def _elem(self, row, eval_fn, v):
        """The body's value with the variable bound to `v`, typed by the
        array's element type (a nested array's element is a list)."""
        arr_t = self.children[0].data_type
        elem = arr_t.element_type if isinstance(arr_t, ArrayType) else None
        return eval_fn(_subst(self.body, {self.var: v}, {self.var: elem}),
                       row)

    def _host_values(self, row, eval_fn):
        arr = eval_fn(self.children[0], row)
        return None if arr is None else \
            [(v, self._elem(row, eval_fn, v)) for v in arr]

    def _body_type(self):
        """The body's type with the variable bound to the element type
        (Catalyst's bind step)."""
        arr_t = self.children[0].data_type
        elem = arr_t.element_type if isinstance(arr_t, ArrayType) else arr_t
        return _subst(self.body, {self.var: None},
                      {self.var: elem}).data_type


class ArrayTransform(_HostHOF):
    """transform(arr, x -> expr)"""

    _device_kernel = "array_transform"

    @property
    def data_type(self):
        try:
            return ArrayType(self._body_type())
        except TypeError:
            return ArrayType(NULL)

    def host_eval_with_row(self, row, eval_fn):
        vals = self._host_values(row, eval_fn)
        return None if vals is None else [r for _, r in vals]


class ArrayFilter(_HostHOF):
    """filter(arr, x -> predicate)"""

    _device_kernel = "array_filter"

    @property
    def data_type(self):
        return self.children[0].data_type

    def host_eval_with_row(self, row, eval_fn):
        vals = self._host_values(row, eval_fn)
        return None if vals is None else [v for v, r in vals if r is True]


class ArrayExists(_HostHOF):
    """exists(arr, x -> predicate): Spark's 3-valued result."""

    _device_kernel = "array_exists"
    #: the element result that decides the row (exists: a true one)
    _decides = True

    @property
    def data_type(self):
        return BOOLEAN

    def host_eval_with_row(self, row, eval_fn):
        arr = eval_fn(self.children[0], row)
        if arr is None:
            return None
        saw_null = False
        for v in arr:
            r = self._elem(row, eval_fn, v)
            if r is self._decides:
                return self._decides
            if r is None:
                saw_null = True
        return None if saw_null else not self._decides


class ArrayForAll(ArrayExists):
    """forall(arr, x -> predicate)"""

    _device_kernel = "array_forall"
    _decides = False


class ArrayAggregate(Expression):
    """aggregate(arr, zero, (acc, x) -> merge[, acc -> finish]): a fold
    with no static-shape device formulation, on the host row engine only,
    as in the JAX package."""

    device_supported = False

    def __init__(self, child: Expression, zero: Expression,
                 merge: Expression, finish: Expression = None,
                 acc_var: str = "acc", var: str = "x"):
        self.children = (child, zero)
        self.merge = merge
        self.finish = finish
        self.acc_var = acc_var
        self.var = var

    def with_children(self, cs):
        return ArrayAggregate(cs[0], cs[1], self.merge, self.finish,
                              self.acc_var, self.var)

    def transform_up(self, fn):
        cs = [c.transform_up(fn) for c in self.children]
        finish = self.finish.transform_up(fn) \
            if self.finish is not None else None
        return fn(ArrayAggregate(cs[0], cs[1], self.merge.transform_up(fn),
                                 finish, self.acc_var, self.var))

    @property
    def data_type(self):
        try:
            zero_t = self.children[1].data_type
            arr_t = self.children[0].data_type
            elem = arr_t.element_type if isinstance(arr_t, ArrayType) \
                else arr_t
            merged_t = _subst(self.merge, {self.acc_var: None, self.var: None},
                              {self.acc_var: zero_t, self.var: elem}
                              ).data_type
            if self.finish is None:
                return merged_t
            return _subst(self.finish, {self.acc_var: None},
                          {self.acc_var: merged_t}).data_type
        except TypeError:
            return self.children[1].data_type

    def columnar_eval(self, batch):
        raise NotImplementedError(
            "aggregate() runs on the host row engine (exec/fallback.py)")

    def host_eval_with_row(self, row, eval_fn):
        arr = eval_fn(self.children[0], row)
        if arr is None:
            return None
        arr_t = self.children[0].data_type
        elem = arr_t.element_type if isinstance(arr_t, ArrayType) else None
        acc = eval_fn(self.children[1], row)
        for v in arr:
            acc = eval_fn(_subst(self.merge, {self.acc_var: acc,
                                              self.var: v},
                                 {self.var: elem}), row)
        if self.finish is not None:
            acc = eval_fn(_subst(self.finish, {self.acc_var: acc}), row)
        return acc
