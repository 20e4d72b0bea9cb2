"""JSON expressions — the counterpart of spark_rapids_tpu/expr/jsonexprs.py
(reference GpuGetJsonObject.scala + JNI JSONUtils; GpuJsonToStructs).

JSONPath subset (Spark's get_json_object): `$` root, `.field`,
`['field']`, `[n]` array index, `[*]` wildcard over arrays. A literal path
without wildcards runs the byte-parallel device scanner
(ops/json_device.py); a wildcard path and from_json run on the JAX
package's host row tier, which the port's planner tags off (ROADMAP A.8
wave 4).
"""

from __future__ import annotations

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
                "wildcard JSON paths run on the JAX package's host tier, "
                "which waits for ROADMAP A.8 wave 4")
        return json_extract(c, self._steps)


class JsonToStructsField(Expression):
    """from_json limited to extracting ONE typed field (the common
    `from_json(col, schema).field` shape). Host tier in the JAX package:
    the planner tags it off."""

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

    def columnar_eval(self, batch):
        raise NotImplementedError(
            "from_json runs on the JAX package's host tier, which waits "
            "for ROADMAP A.8 wave 4")
