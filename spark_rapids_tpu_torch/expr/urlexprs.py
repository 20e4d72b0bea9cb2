"""URL expressions — the counterpart of spark_rapids_tpu/expr/urlexprs.py
(reference GpuParseUrl.scala + JNI ParseURI). A literal part and key run
the byte-parallel device kernel (ops/url.py); a non-literal part runs on
the JAX package's host row tier, which the port's planner tags off
(ROADMAP A.8 wave 4)."""

from __future__ import annotations

from ..types import STRING
from .core import Expression, Literal


class ParseUrl(Expression):
    """parse_url(url, part[, key]) with Spark's part names (case-sensitive:
    'host' is an unknown part and gives NULL)."""

    def __init__(self, child: Expression, part, key=None):
        self.children = (child,)
        self.part = part.value if isinstance(part, Literal) else part
        self.key = key.value if isinstance(key, Literal) else key

    def with_children(self, cs):
        return ParseUrl(cs[0], self.part, self.key)

    @property
    def data_type(self):
        return STRING

    @property
    def device_supported(self) -> bool:
        return isinstance(self.part, str) and (
            self.key is None or isinstance(self.key, str))

    def columnar_eval(self, batch):
        from ..columnar.encoded import materialize_column
        from ..ops.url import parse_url
        if not self.device_supported:
            raise NotImplementedError(
                "parse_url with a non-literal part runs on the JAX "
                "package's host tier, which waits for ROADMAP A.8 wave 4")
        c = materialize_column(self.children[0].columnar_eval(batch))
        return parse_url(c, self.part, self.key)
