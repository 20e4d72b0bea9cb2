"""JSON expressions — the counterpart of spark_rapids_tpu/expr/jsonexprs.py
(reference GpuGetJsonObject.scala + JNI JSONUtils; GpuJsonToStructs).

JSONPath subset (Spark's get_json_object): `$` root, `.field`,
`['field']`, `[n]` array index, `[*]` wildcard over arrays. A literal path
without wildcards runs the byte-parallel device scanner
(ops/json_device.py); a wildcard path and from_json run on the host row
engine (`host_eval_row`, exec/fallback.py), as in the JAX package.
"""

from __future__ import annotations

import json
import re
from typing import List, Optional

import torch

from ..types import STRING
from .core import Expression, Literal

_TOKEN = re.compile(r"""
    \.(?P<field>[A-Za-z_][A-Za-z0-9_\- ]*)   |
    \[\s*'(?P<qfield>[^']*)'\s*\]            |
    \[\s*(?P<index>\d+)\s*\]                 |
    \[\s*\*\s*\](?P<star>)
""", re.X)


def parse_json_path(path: str) -> Optional[List]:
    """'$.a.b[0]' -> ['a', 'b', 0]; None for a malformed path (Spark
    returns NULL for it)."""
    if not path or path[0] != "$":
        return None
    out: List = []
    pos = 1
    while pos < len(path):
        m = _TOKEN.match(path, pos)
        if m is None:
            return None
        if m.group("field") is not None:
            out.append(m.group("field"))
        elif m.group("qfield") is not None:
            out.append(m.group("qfield"))
        elif m.group("index") is not None:
            out.append(int(m.group("index")))
        else:
            out.append("*")
        pos = m.end()
    return out


def _first_key_wins(pairs):
    d = {}
    for k, v in pairs:
        if k not in d:
            d[k] = v
    return d


def _walk(node, steps, i):
    if i == len(steps):
        yield node
        return
    step = steps[i]
    if step == "*":
        if isinstance(node, list):
            for item in node:
                yield from _walk(item, steps, i + 1)
        return
    if isinstance(step, int):
        if isinstance(node, list) and 0 <= step < len(node):
            yield from _walk(node[step], steps, i + 1)
        return
    if isinstance(node, dict) and step in node:
        yield from _walk(node[step], steps, i + 1)


def _render(v) -> Optional[str]:
    """Spark's scalar rendering: a string bare, the rest as JSON text."""
    if v is None:
        return None
    if isinstance(v, str):
        return v
    return json.dumps(v, separators=(",", ":"))


class GetJsonObject(Expression):
    """get_json_object(json, path)."""

    def __init__(self, child: Expression, path):
        self.children = (child,)
        self.path = path.value if isinstance(path, Literal) else path
        # the constant path is parsed once, not per batch
        self._steps = parse_json_path(self.path) \
            if isinstance(self.path, str) else None

    def with_children(self, cs):
        return GetJsonObject(cs[0], self.path)

    @property
    def data_type(self):
        return STRING

    @property
    def device_supported(self) -> bool:
        """Literal paths without '[*]' run on the device."""
        return self._steps is None or "*" not in [
            s for s in self._steps if isinstance(s, str)]

    def host_eval_row(self, s):
        steps = self._steps
        if s is None or steps is None:
            return None
        try:
            # the first duplicate key wins, as in Jackson's streaming
            # get_json_object and the device scanner
            doc = json.loads(s, object_pairs_hook=_first_key_wins)
        except ValueError:
            return None
        hits = list(_walk(doc, steps, 0))
        if not hits:
            return None
        if len(hits) == 1:
            return _render(hits[0])
        # a wildcard with several matches renders as a JSON array
        return json.dumps(hits, separators=(",", ":"))

    def columnar_eval(self, batch):
        from ..columnar.column import StringColumn
        from ..columnar.encoded import materialize_column
        from ..ops.json_device import json_extract
        c = materialize_column(self.children[0].columnar_eval(batch))
        if self._steps is None:
            # a malformed or non-literal path: NULL on every row
            dev = c.device
            return StringColumn(
                torch.zeros(1, dtype=torch.uint8, device=dev),
                torch.zeros(c.capacity + 1, dtype=torch.int32, device=dev),
                torch.zeros(c.capacity, dtype=torch.bool, device=dev),
                STRING)
        if not self.device_supported:
            raise NotImplementedError(
                "wildcard JSON paths run on the host row engine "
                "(exec/fallback.py)")
        return json_extract(c, self._steps)


class JsonToStructsField(Expression):
    """from_json limited to extracting ONE typed field (the common
    `from_json(col, schema).field` shape), on the host row engine only,
    as in the JAX package."""

    device_supported = False

    def __init__(self, child: Expression, field: str, dtype):
        self.children = (child,)
        self.field = field
        self._dtype = dtype

    def with_children(self, cs):
        return JsonToStructsField(cs[0], self.field, self._dtype)

    @property
    def data_type(self):
        return self._dtype

    def host_eval_row(self, s):
        from ..types import (BooleanType, DoubleType, FloatType,
                             IntegerType, LongType, StringType)
        if s is None:
            return None
        try:
            doc = json.loads(s)
        except ValueError:
            return None
        if not isinstance(doc, dict) or self.field not in doc:
            return None
        v = doc[self.field]
        try:
            if isinstance(self._dtype, (LongType, IntegerType)):
                return int(v)
            if isinstance(self._dtype, (DoubleType, FloatType)):
                return float(v)
            if isinstance(self._dtype, BooleanType):
                return bool(v)
            if isinstance(self._dtype, StringType):
                return v if isinstance(v, str) else json.dumps(v)
        except (TypeError, ValueError):
            return None
        return None

    def columnar_eval(self, batch):
        raise NotImplementedError(
            "from_json runs on the host row engine (exec/fallback.py)")
