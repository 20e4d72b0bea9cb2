"""Map expressions — the counterpart of spark_rapids_tpu/expr/mapexprs.py
(reference collectionOperations.scala GpuCreateMap / GpuGetMapValue /
GpuMapKeys / GpuMapValues; GpuElementAt over a map is
collectionexprs.ElementAt). A host row holds a map as a dict, in the
order of its entries (`host_eval_row` and `host_eval_with_row` serve the
host row engine)."""

from __future__ import annotations

from ..ops import maps as M
from ..types import BOOLEAN, ArrayType, MapType
from .core import Expression, Literal


def _key_args(child: Expression, key):
    """(children, literal key): a literal key rides as a host value, an
    expression key as the second child."""
    if isinstance(key, Literal):
        key = key.value
    if isinstance(key, Expression):
        return (child, key), None
    return (child,), key


class CreateMap(Expression):
    """map(k1, v1, k2, v2, ...)"""

    def __init__(self, *children: Expression):
        if not children or len(children) % 2:
            raise ValueError("map() takes key/value pairs")
        self.children = tuple(children)

    def with_children(self, cs):
        return CreateMap(*cs)

    @property
    def data_type(self):
        return MapType(self.children[0].data_type,
                       self.children[1].data_type)

    @property
    def nullable(self):
        return False

    def columnar_eval(self, batch):
        cols = [c.columnar_eval(batch) for c in self.children]
        return M.create_map(cols[0::2], cols[1::2], batch.num_rows,
                            self.data_type)

    def host_eval_with_row(self, row, eval_fn):
        vals = [eval_fn(c, row) for c in self.children]
        d = {}
        for k, v in zip(vals[0::2], vals[1::2]):
            if k not in d:  # the first duplicate wins, as on the device
                d[k] = v
        return d


class _KeyedLookup(Expression):
    """A lookup of a map by a literal key or a per-row key column."""

    def __init__(self, child: Expression, key):
        self.children, self.key = _key_args(child, key)

    def with_children(self, cs):
        return type(self)(cs[0], cs[1] if len(cs) == 2 else self.key)

    def _eval(self, batch):
        m = self.children[0].columnar_eval(batch)
        key = self.key if len(self.children) == 1 \
            else self.children[1].columnar_eval(batch)
        return m, key

    def _host_args(self, vals):
        """(map, key) of one row, or None when either is null."""
        m = vals[0]
        k = self.key if len(self.children) == 1 else vals[1]
        return None if m is None or k is None else (m, k)


class GetMapValue(_KeyedLookup):
    """map[key] / element_at(map, key): NULL when absent (non-ANSI)."""

    @property
    def data_type(self):
        return self.children[0].data_type.value_type

    def columnar_eval(self, batch):
        return M.map_get(*self._eval(batch))

    def host_eval_row(self, *vals):
        mk = self._host_args(vals)
        return None if mk is None else mk[0].get(mk[1])


class MapContainsKey(_KeyedLookup):
    """map_contains_key(map, key)"""

    @property
    def data_type(self):
        return BOOLEAN

    def columnar_eval(self, batch):
        return M.map_contains_key(*self._eval(batch))

    def host_eval_row(self, *vals):
        mk = self._host_args(vals)
        return None if mk is None else mk[1] in mk[0]


class MapKeys(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, cs):
        return type(self)(cs[0])

    @property
    def data_type(self):
        return ArrayType(self.children[0].data_type.key_type, False)

    def columnar_eval(self, batch):
        return M.map_keys(self.children[0].columnar_eval(batch))

    def host_eval_row(self, m):
        return None if m is None else list(m.keys())


class MapValues(MapKeys):
    @property
    def data_type(self):
        mt = self.children[0].data_type
        return ArrayType(mt.value_type, mt.value_contains_null)

    def columnar_eval(self, batch):
        return M.map_values(self.children[0].columnar_eval(batch))

    def host_eval_row(self, m):
        return None if m is None else list(m.values())
