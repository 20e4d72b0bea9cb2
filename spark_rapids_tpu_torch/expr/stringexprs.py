"""String expressions — the counterpart of
spark_rapids_tpu/expr/stringexprs.py (reference stringFunctions.scala),
every class but StringSplit, whose array<string> result waits for the
port's ArrayColumn (ROADMAP A.8 wave 3).

The device classes (Length through Like) evaluate through ops/strings.py
and the regex automaton (regex/). The JAX package's `_HostString`
classes run on its host row tier unless `device_supported`; the port has
no host tier (ROADMAP A.8 wave 4), so the planner tags off the shapes
without a device path (a regex pattern the span finder rejects, a UTF-16
charset, Levenshtein) and the rest run on the card: SubstringIndex,
FindInSet, RegExpExtract, RegExpReplace, the base64 and hex codecs,
Encode, Decode and FormatNumber.

Character semantics follow the JAX package, not Python's `str`: Length
counts UTF-8 characters, Substring, Left, Right, Locate and Reverse work
in bytes (exact for ASCII), Upper, Lower and InitCap change ASCII letters
only (ROADMAP C.5 lists where this differs from Spark).
"""

from __future__ import annotations

from typing import Optional

from ..columnar.column import Column, StringColumn
from ..ops import strings as S
from ..types import BINARY, BOOLEAN, INT, STRING, DecimalType
from .core import Expression, Literal


def _value(v):
    return v.value if isinstance(v, Literal) else v


def _as_bytes(v) -> bytes:
    v = _value(v)
    return v.encode("utf-8") if isinstance(v, str) else bytes(v)


class _UnaryString(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, children):
        return type(self)(children[0])


class Length(_UnaryString):
    @property
    def data_type(self):
        return INT

    def columnar_eval(self, batch):
        return S.str_length_chars(self.children[0].columnar_eval(batch))


class Upper(_UnaryString):
    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        return S.str_upper_ascii(self.children[0].columnar_eval(batch))


class Lower(_UnaryString):
    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        return S.str_lower_ascii(self.children[0].columnar_eval(batch))


class Substring(Expression):
    """Spark substring(str, pos, len): 1-based, a negative pos counts from
    the end."""

    def __init__(self, child: Expression, pos: int,
                 length: Optional[int] = None):
        self.children = (child,)
        self.pos = pos
        self.length = length

    def with_children(self, children):
        return Substring(children[0], self.pos, self.length)

    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        return S.substring(self.children[0].columnar_eval(batch),
                           self.pos, self.length)


class _LiteralNeedle(Expression):
    def __init__(self, child: Expression, needle):
        self.children = (child,)
        self.needle = _as_bytes(needle)

    def with_children(self, children):
        return type(self)(children[0], self.needle)

    @property
    def data_type(self):
        return BOOLEAN


class StartsWith(_LiteralNeedle):
    def columnar_eval(self, batch):
        return S.str_starts_with(self.children[0].columnar_eval(batch),
                                 self.needle)


class EndsWith(_LiteralNeedle):
    def columnar_eval(self, batch):
        return S.str_ends_with(self.children[0].columnar_eval(batch),
                               self.needle)


class Contains(_LiteralNeedle):
    def columnar_eval(self, batch):
        return S.str_contains(self.children[0].columnar_eval(batch),
                              self.needle)


class StringTrim(_UnaryString):
    """trim/ltrim/rtrim with an optional literal trim set (reference
    GpuStringTrim/TrimLeft/TrimRight); the default set is a space."""

    SIDE = "both"

    def __init__(self, child: Expression, trim_str=None):
        super().__init__(child)
        self.trim_str = None if trim_str is None else _as_bytes(trim_str)

    def with_children(self, children):
        return type(self)(children[0], self.trim_str)

    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        chars = self.trim_str if self.trim_str is not None else b" "
        return S.str_trim(self.children[0].columnar_eval(batch),
                          self.SIDE, chars)


class StringTrimLeft(StringTrim):
    SIDE = "left"


class StringTrimRight(StringTrim):
    SIDE = "right"


class _PadBase(Expression):
    SIDE = "left"

    def __init__(self, child: Expression, length, pad=" "):
        self.children = (child,)
        self.length = _value(length)
        self.pad = _as_bytes(pad)

    def with_children(self, children):
        return type(self)(children[0], self.length, self.pad)

    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        return S.str_pad(self.children[0].columnar_eval(batch),
                         self.length, self.pad, self.SIDE)


class StringLPad(_PadBase):
    SIDE = "left"


class StringRPad(_PadBase):
    SIDE = "right"


class StringRepeat(Expression):
    def __init__(self, child: Expression, n):
        self.children = (child,)
        self.n = _value(n)

    def with_children(self, children):
        return StringRepeat(children[0], self.n)

    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        return S.str_repeat(self.children[0].columnar_eval(batch), self.n)


class Reverse(_UnaryString):
    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        return S.str_reverse(self.children[0].columnar_eval(batch))


class InitCap(_UnaryString):
    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        return S.str_initcap(self.children[0].columnar_eval(batch))


class StringLocate(Expression):
    """locate(substr, str, start) / instr (reference GpuStringLocate)."""

    def __init__(self, substr, child: Expression, start=1):
        self.children = (child,)
        self.needle = _as_bytes(substr)
        self.start = _value(start)

    def with_children(self, children):
        return StringLocate(self.needle, children[0], self.start)

    @property
    def data_type(self):
        return INT

    def columnar_eval(self, batch):
        return S.str_locate(self.children[0].columnar_eval(batch),
                            self.needle, self.start)


class StringReplace(Expression):
    def __init__(self, child: Expression, search, replacement):
        self.children = (child,)
        self.search = _as_bytes(search)
        self.replacement = _as_bytes(replacement)

    def with_children(self, children):
        return StringReplace(children[0], self.search, self.replacement)

    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        return S.str_replace(self.children[0].columnar_eval(batch),
                             self.search, self.replacement)


class Concat(Expression):
    """concat(...): null if any child is (reference GpuConcat). Two
    children take the pairwise kernel; more take concat_ws's segment
    table with an empty separator in one pass (a pairwise fold would copy
    the earlier children's bytes k times)."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    def with_children(self, children):
        return Concat(*children)

    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        cols = [c.columnar_eval(batch) for c in self.children]
        if len(cols) == 1:
            return cols[0]
        if len(cols) == 2:
            return S.str_concat_pair(cols[0], cols[1])
        joined = S.str_concat_ws(b"", cols)
        valid = cols[0].validity
        for c in cols[1:]:
            valid = valid & c.validity
        return StringColumn(joined.data, joined.offsets, valid,
                            cols[0].dtype)


class ConcatWs(Expression):
    """concat_ws(sep, ...): skips nulls, never null (reference
    GpuConcatWs)."""

    def __init__(self, sep, *children: Expression):
        self.children = tuple(children)
        self.sep = _as_bytes(sep)

    def with_children(self, children):
        return ConcatWs(self.sep, *children)

    @property
    def data_type(self):
        return STRING

    @property
    def nullable(self):
        return False

    def columnar_eval(self, batch):
        return S.str_concat_ws(self.sep, [c.columnar_eval(batch)
                                          for c in self.children])


class StringTranslate(Expression):
    def __init__(self, child: Expression, from_str, to_str):
        self.children = (child,)
        self.from_str = _as_bytes(from_str)
        self.to_str = _as_bytes(to_str)

    def with_children(self, children):
        return StringTranslate(children[0], self.from_str, self.to_str)

    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        return S.str_translate(self.children[0].columnar_eval(batch),
                               self.from_str, self.to_str)


class Ascii(_UnaryString):
    @property
    def data_type(self):
        return INT

    def columnar_eval(self, batch):
        return S.str_ascii(self.children[0].columnar_eval(batch))


class Chr(_UnaryString):
    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        return S.str_chr(self.children[0].columnar_eval(batch))


class OctetLength(_UnaryString):
    @property
    def data_type(self):
        return INT

    def columnar_eval(self, batch):
        return S.str_length_bytes(self.children[0].columnar_eval(batch))


class BitLength(_UnaryString):
    @property
    def data_type(self):
        return INT

    def columnar_eval(self, batch):
        c = S.str_length_bytes(self.children[0].columnar_eval(batch))
        return Column(c.data * 8, c.validity, INT)


class Left(Expression):
    def __init__(self, child: Expression, n):
        self.children = (child,)
        self.n = _value(n)

    def with_children(self, children):
        return type(self)(children[0], self.n)

    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        return S.substring(self.children[0].columnar_eval(batch), 1,
                           max(self.n, 0))


class Right(Left):
    def columnar_eval(self, batch):
        c = self.children[0].columnar_eval(batch)
        if self.n <= 0:
            return S.substring(c, 1, 0)
        return S.substring(c, -self.n, None)


class RLike(Expression):
    """rlike/regexp (reference GpuRLike and its RegexParser.scala
    transpiler): the literal pattern compiles lazily to a Glushkov
    program; an unsupported construct raises RegexUnsupported, which the
    planner's rule turns into a tag at plan time (building the expression
    never raises)."""

    def __init__(self, child: Expression, pattern):
        self.children = (child,)
        self.pattern = _value(pattern)
        self._program = None

    @property
    def program(self):
        if self._program is None:
            from ..regex import RegexUnsupported, compile_regex
            if not isinstance(self.pattern, str):
                raise RegexUnsupported(
                    "only literal regex patterns are supported "
                    f"(got {type(self.pattern).__name__})")
            self._program = compile_regex(self.pattern)
        return self._program

    def with_children(self, children):
        return RLike(children[0], self.pattern)

    @property
    def data_type(self):
        return BOOLEAN

    def columnar_eval(self, batch):
        from ..regex import regex_find
        return regex_find(self.children[0].columnar_eval(batch),
                          self.program)


class Like(Expression):
    """SQL LIKE ... ESCAPE (reference GpuLike): translated lazily to an
    anchored Glushkov program, tagged as RLike is."""

    def __init__(self, child: Expression, pattern, escape_char="\\"):
        self.children = (child,)
        self.pattern = _value(pattern)
        self.escape_char = escape_char
        self._program = None

    @property
    def program(self):
        if self._program is None:
            from ..regex import RegexUnsupported, like_to_program
            if not isinstance(self.pattern, str):
                raise RegexUnsupported(
                    "only literal LIKE patterns are supported "
                    f"(got {type(self.pattern).__name__})")
            self._program = like_to_program(self.pattern, self.escape_char)
        return self._program

    def with_children(self, children):
        return Like(children[0], self.pattern, self.escape_char)

    @property
    def data_type(self):
        return BOOLEAN

    def columnar_eval(self, batch):
        from ..regex import regex_find
        return regex_find(self.children[0].columnar_eval(batch),
                          self.program)


# ---------------------------------------------------------------------------
# the JAX package's host-tier family: a device kernel where
# `device_supported`, its host row tier otherwise (tagged off here)
# ---------------------------------------------------------------------------

class _HostString(Expression):
    """Base of the string expressions the JAX package runs on its host row
    tier where they have no device kernel. `device_supported` says whether
    this instance has one; the planner tags off the others (the port's
    host tier waits for ROADMAP A.8 wave 4)."""

    device_supported = True

    def columnar_eval(self, batch):
        raise NotImplementedError(
            f"{type(self).__name__} runs on the JAX package's host tier, "
            "which waits for ROADMAP A.8 wave 4")


class SubstringIndex(_HostString):
    """substring_index(str, delim, count) (reference GpuSubstringIndex)."""

    def __init__(self, child: Expression, delim, count):
        self.children = (child,)
        self.delim = _value(delim)
        self.count = _value(count)

    def with_children(self, cs):
        return SubstringIndex(cs[0], self.delim, self.count)

    @property
    def data_type(self):
        return STRING

    @property
    def device_supported(self) -> bool:
        return isinstance(self.delim, str) and isinstance(self.count, int)

    def columnar_eval(self, batch):
        from ..ops.string_split import substring_index
        if not self.device_supported:
            return super().columnar_eval(batch)
        return substring_index(self.children[0].columnar_eval(batch),
                               self.delim.encode("utf-8"), self.count)


class FindInSet(_HostString):
    """find_in_set(str, comma_list) -> 1-based index or 0."""

    def __init__(self, needle: Expression, set_col: Expression):
        self.children = (needle, set_col)

    def with_children(self, cs):
        return FindInSet(cs[0], cs[1])

    @property
    def data_type(self):
        return INT

    def columnar_eval(self, batch):
        from ..ops.string_split import find_in_set
        return find_in_set(self.children[0].columnar_eval(batch),
                           self.children[1].columnar_eval(batch))


class RegExpExtract(_HostString):
    """regexp_extract(str, pattern, idx) (reference GpuRegExpExtract): the
    span finder's shapes on the card (regex/spans.py)."""

    def __init__(self, child: Expression, pattern, idx=1):
        self.children = (child,)
        self.pattern = _value(pattern)
        self.idx = _value(idx)
        self._span_plan = False

    def with_children(self, cs):
        return RegExpExtract(cs[0], self.pattern, self.idx)

    @property
    def data_type(self):
        return STRING

    def _device_plan(self):
        """The span plan of the constant (pattern, idx), compiled and
        checked for a fixed group window once; None without one."""
        if self._span_plan is False:
            from ..regex import RegexUnsupported
            from ..regex.spans import compile_spans, extract_window
            plan = None
            if isinstance(self.pattern, str) and isinstance(self.idx, int):
                try:
                    p = compile_spans(self.pattern)
                    if 0 <= self.idx <= p.n_groups:
                        extract_window(p, self.idx)
                        plan = p
                except RegexUnsupported:
                    plan = None
            self._span_plan = plan
        return self._span_plan

    @property
    def device_supported(self) -> bool:
        return self._device_plan() is not None

    def columnar_eval(self, batch):
        from ..regex.spans import regexp_extract_device
        plan = self._device_plan()
        if plan is None:
            return super().columnar_eval(batch)
        return regexp_extract_device(self.children[0].columnar_eval(batch),
                                     plan, self.idx)


class RegExpReplace(_HostString):
    """regexp_replace(str, pattern, replacement) (reference
    GpuRegExpReplace): the span finder's shapes with a literal replacement
    ($n group references and escapes keep the host tier)."""

    def __init__(self, child: Expression, pattern, replacement):
        self.children = (child,)
        self.pattern = _value(pattern)
        self.replacement = _value(replacement)
        self._span_plan = False

    def with_children(self, cs):
        return RegExpReplace(cs[0], self.pattern, self.replacement)

    @property
    def data_type(self):
        return STRING

    def _device_plan(self):
        if self._span_plan is False:
            from ..regex import RegexUnsupported
            from ..regex.spans import compile_spans
            plan = None
            if isinstance(self.pattern, str) \
                    and isinstance(self.replacement, str) \
                    and "$" not in self.replacement \
                    and "\\" not in self.replacement:
                try:
                    plan = compile_spans(self.pattern)
                except RegexUnsupported:
                    plan = None
            self._span_plan = plan
        return self._span_plan

    @property
    def device_supported(self) -> bool:
        return self._device_plan() is not None

    def columnar_eval(self, batch):
        from ..regex.spans import regexp_replace_device
        plan = self._device_plan()
        if plan is None:
            return super().columnar_eval(batch)
        return regexp_replace_device(self.children[0].columnar_eval(batch),
                                     plan, self.replacement.encode("utf-8"))


class FormatNumber(_HostString):
    """format_number(x, d): thousands separators and d decimals (HALF_EVEN),
    reference GpuFormatNumber. The JAX package runs a DECIMAL input or a
    d past 18 on its host row tier; the planner tags those off."""

    def __init__(self, child: Expression, decimals):
        self.children = (child,)
        self.decimals = _value(decimals)

    def with_children(self, cs):
        return FormatNumber(cs[0], self.decimals)

    @property
    def device_supported(self) -> bool:
        if not isinstance(self.decimals, int) \
                or not 0 <= self.decimals <= 18:
            return False
        try:
            return not isinstance(self.children[0].data_type, DecimalType)
        except TypeError:
            return False

    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        from ..ops.cast_strings import format_number_string
        return format_number_string(self.children[0].columnar_eval(batch),
                                    int(self.decimals))


class Levenshtein(_HostString):
    """levenshtein(a, b) edit distance (reference GpuLevenshtein): host
    tier only in the JAX package, so tagged off here (ROADMAP A.8 wave
    4)."""

    device_supported = False

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def with_children(self, cs):
        return Levenshtein(cs[0], cs[1])

    @property
    def data_type(self):
        return INT


class Base64Encode(_HostString):
    """base64(bin) (reference GpuBase64); a string input is its UTF-8."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, cs):
        return Base64Encode(cs[0])

    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        from ..ops.codecs import base64_encode
        return base64_encode(self.children[0].columnar_eval(batch))


class UnBase64(_HostString):
    """unbase64(str) -> binary (reference GpuUnBase64)."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, cs):
        return UnBase64(cs[0])

    @property
    def data_type(self):
        return BINARY

    def columnar_eval(self, batch):
        from ..ops.codecs import base64_decode
        return base64_decode(self.children[0].columnar_eval(batch))


class Hex(_HostString):
    """hex(long | str): upper-case hex, Spark's minimal-width long form."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, cs):
        return Hex(cs[0])

    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        from ..ops.codecs import hex_encode, hex_encode_long
        c = self.children[0].columnar_eval(batch)
        if isinstance(c, StringColumn):
            return hex_encode(c)
        return hex_encode_long(c)


class Unhex(_HostString):
    """unhex(str) -> binary; null on malformed input (an odd length gets
    a leading 0, as in Spark)."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def with_children(self, cs):
        return Unhex(cs[0])

    @property
    def data_type(self):
        return BINARY

    def columnar_eval(self, batch):
        from ..ops.codecs import hex_decode
        return hex_decode(self.children[0].columnar_eval(batch))


class Encode(_HostString):
    """encode(str, charset) -> binary."""

    _CHARSETS = ("US-ASCII", "ISO-8859-1", "UTF-8", "UTF-16BE",
                 "UTF-16LE", "UTF-16")

    def __init__(self, child: Expression, charset):
        self.children = (child,)
        self.charset = _value(charset)
        # Spark raises for an unknown charset at analysis time
        if isinstance(self.charset, str) \
                and self.charset.upper() not in self._CHARSETS:
            raise ValueError(f"unsupported charset {self.charset!r}")

    def with_children(self, cs):
        return Encode(cs[0], self.charset)

    @property
    def device_supported(self) -> bool:
        # byte maps (ops/charsets.py); UTF-16 needs the host tier's
        # surrogate and BOM state machine
        return isinstance(self.charset, str) and self.charset.upper() in (
            "UTF-8", "US-ASCII", "ISO-8859-1")

    @property
    def data_type(self):
        return BINARY

    def columnar_eval(self, batch):
        from ..ops.charsets import encode_single_byte, recast_bytes
        if not self.device_supported:
            return super().columnar_eval(batch)
        c = self.children[0].columnar_eval(batch)
        cs = self.charset.upper()
        if cs == "UTF-8":
            return recast_bytes(c, BINARY)
        return encode_single_byte(c, cs)


class Decode(_HostString):
    """decode(bin, charset) -> string."""

    def __init__(self, child: Expression, charset):
        self.children = (child,)
        self.charset = _value(charset)
        if isinstance(self.charset, str) \
                and self.charset.upper() not in Encode._CHARSETS:
            raise ValueError(f"unsupported charset {self.charset!r}")

    def with_children(self, cs):
        return Decode(cs[0], self.charset)

    @property
    def device_supported(self) -> bool:
        # UTF-8 decode passes malformed bytes through (no U+FFFD), the
        # JAX package's documented deviation (ops/charsets.py)
        return isinstance(self.charset, str) and self.charset.upper() in (
            "UTF-8", "US-ASCII", "ISO-8859-1")

    @property
    def data_type(self):
        return STRING

    def columnar_eval(self, batch):
        from ..ops.charsets import decode_single_byte, recast_bytes
        if not self.device_supported:
            return super().columnar_eval(batch)
        c = self.children[0].columnar_eval(batch)
        cs = self.charset.upper()
        if cs == "UTF-8":
            return recast_bytes(c, STRING)
        return decode_single_byte(c, cs)
