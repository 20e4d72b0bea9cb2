"""URL expressions — the counterpart of spark_rapids_tpu/expr/urlexprs.py
(reference GpuParseUrl.scala + JNI ParseURI). A literal part and key run
the byte-parallel device kernel (ops/url.py); a non-literal part runs on
the host row engine (`host_eval_row`, exec/fallback.py), as in the JAX
package."""

from __future__ import annotations

from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..types import STRING
from .core import Expression, Literal

_PARTS = ("HOST", "PATH", "QUERY", "REF", "PROTOCOL", "FILE",
          "AUTHORITY", "USERINFO")


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

    def host_eval_row(self, url) -> Optional[str]:
        if url is None or self.part not in _PARTS:
            return None
        try:
            p = urlparse(url)
        except ValueError:
            return None
        part = self.part
        if part == "HOST":
            return p.hostname
        if part == "PROTOCOL":
            return p.scheme or None
        if part == "PATH":
            return p.path
        if part == "QUERY":
            if self.key is not None:
                vals = parse_qs(p.query, keep_blank_values=True
                                ).get(self.key)
                return vals[0] if vals else None
            return p.query or None
        if part == "REF":
            return p.fragment or None
        if part == "FILE":
            return p.path + ("?" + p.query if p.query else "")
        if part == "AUTHORITY":
            return p.netloc or None
        if p.username is None:  # USERINFO
            return None
        return p.username + (f":{p.password}"
                             if p.password is not None else "")

    def columnar_eval(self, batch):
        from ..columnar.encoded import materialize_column
        from ..ops.url import parse_url
        if not self.device_supported:
            raise NotImplementedError(
                "parse_url with a non-literal part runs on the host row "
                "engine (exec/fallback.py)")
        c = materialize_column(self.children[0].columnar_eval(batch))
        return parse_url(c, self.part, self.key)
