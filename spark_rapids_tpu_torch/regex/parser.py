r"""Java-regex subset parser — a copy of spark_rapids_tpu/regex/parser.py
(pure Python and numpy; the port imports nothing of the JAX package).
Reference RegexParser.scala:687 takes the same approach: parse what the
device engine can run, reject the rest loudly.

Grammar (byte semantics, exact for ASCII):
  literal chars and escapes  \\ \. \* \+ \? \( \) \[ \] \{ \} \| \^ \$
                             \t \n \r \f \a \e \0
  .                          any byte except \n
  [abc] [a-z0-9] [^...]      char classes (ranges, escapes, negation)
  \d \D \w \W \s \S          predefined classes (also inside [...])
  X* X+ X? X{m} X{m,} X{m,n} greedy quantifiers (counted repeats expand;
                             m,n <= 16)
  X|Y                        alternation
  (X) (?:X)                  groups (capturing == non-capturing for match)
  ^ $                        anchors at pattern start/end only

Rejected with RegexUnsupported: backreferences, lookaround, lazy/possessive
quantifiers, \b \B boundaries, \p{...} unicode classes, named groups,
inline flags, anchors mid-pattern, {m,} with m>0 beyond expansion budget.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class RegexUnsupported(Exception):
    """Pattern uses a construct the device engine cannot run; the planner
    tags the expression for fallback (reference: transpiler rejection)."""


# -- AST --------------------------------------------------------------------

class Node:
    pass


class Lit(Node):
    """One byte-class position: 256-entry bool mask."""

    def __init__(self, mask: np.ndarray):
        self.mask = mask


class Seq(Node):
    def __init__(self, parts: List[Node]):
        self.parts = parts


class Alt(Node):
    def __init__(self, options: List[Node]):
        self.options = options


class Star(Node):
    """Zero-or-more of child."""

    def __init__(self, child: Node):
        self.child = child


class Empty(Node):
    pass


class Group(Node):
    """Capturing group marker: transparent for matching, consumed by the
    span analyzer (regex/spans.py) for regexp_extract group offsets."""

    def __init__(self, child: Node, idx: int):
        self.child = child
        self.idx = idx


def _mask_of(*bytes_) -> np.ndarray:
    m = np.zeros(256, dtype=bool)
    for b in bytes_:
        m[b] = True
    return m


def _range_mask(lo: int, hi: int) -> np.ndarray:
    m = np.zeros(256, dtype=bool)
    m[lo:hi + 1] = True
    return m


_DIGIT = _range_mask(ord("0"), ord("9"))
_WORD = _range_mask(ord("a"), ord("z")) | _range_mask(ord("A"), ord("Z")) \
    | _DIGIT | _mask_of(ord("_"))
_SPACE = _mask_of(ord(" "), ord("\t"), ord("\n"), ord("\r"),
                  0x0B, 0x0C)
_ANY = np.ones(256, dtype=bool) & ~_mask_of(ord("\n"))

_CLASS_ESCAPES = {
    "d": _DIGIT, "D": ~_DIGIT,
    "w": _WORD, "W": ~_WORD,
    "s": _SPACE, "S": ~_SPACE,
}

_CHAR_ESCAPES = {
    "t": ord("\t"), "n": ord("\n"), "r": ord("\r"), "f": ord("\f"),
    "a": 0x07, "e": 0x1B, "0": 0,
}

_META = set("\\.[]{}()*+?|^$")

MAX_COUNTED_REPEAT = 16


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.anchored_start = False
        self.anchored_end = False
        self.n_groups = 0

    def error(self, msg: str):
        raise RegexUnsupported(
            f"regex {self.p!r} at position {self.i}: {msg}")

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    # -- entry -------------------------------------------------------------
    def parse(self) -> Node:
        if self.peek() == "^":
            self.next()
            self.anchored_start = True
        node = self.alternation()
        if self.i < len(self.p):
            self.error(f"unexpected {self.p[self.i]!r}")
        if (self.anchored_start or self.anchored_end) \
                and isinstance(node, Alt):
            # Java binds anchors tighter than top-level '|' ('a|b$' anchors
            # only the second branch); whole-pattern flags would mis-match
            self.i = 0
            self.error("anchors with top-level alternation not supported")
        return node

    def alternation(self) -> Node:
        opts = [self.sequence()]
        while self.peek() == "|":
            self.next()
            opts.append(self.sequence())
        return opts[0] if len(opts) == 1 else Alt(opts)

    def sequence(self) -> Node:
        parts: List[Node] = []
        while True:
            ch = self.peek()
            if ch is None or ch in ")|":
                break
            if ch == "$":
                # only valid at the very end of the whole pattern
                if self.i == len(self.p) - 1:
                    self.next()
                    self.anchored_end = True
                    break
                self.error("'$' only supported at the end of the pattern")
            if ch == "^":
                self.error("'^' only supported at the start of the pattern")
            parts.append(self.quantified())
        if not parts:
            return Empty()
        return parts[0] if len(parts) == 1 else Seq(parts)

    def quantified(self) -> Node:
        atom = self.atom()
        ch = self.peek()
        if ch not in ("*", "+", "?", "{"):
            return atom
        if ch == "{":
            lo, hi = self.counted()
        else:
            self.next()
            lo, hi = {"*": (0, None), "+": (1, None), "?": (0, 1)}[ch]
        nxt = self.peek()
        if nxt in ("?", "+"):
            self.error("lazy/possessive quantifiers not supported")
        return self._repeat(atom, lo, hi)

    def counted(self) -> Tuple[int, Optional[int]]:
        assert self.next() == "{"
        spec = ""
        while self.peek() is not None and self.peek() != "}":
            spec += self.next()
        if self.peek() != "}":
            self.error("unterminated {...}")
        self.next()
        try:
            if "," not in spec:
                n = int(spec)
                return n, n
            lo_s, hi_s = spec.split(",", 1)
            lo = int(lo_s)
            hi = None if hi_s == "" else int(hi_s)
            return lo, hi
        except ValueError:
            self.error(f"bad counted repeat {{{spec}}}")

    def _repeat(self, atom: Node, lo: int, hi: Optional[int]) -> Node:
        if lo > MAX_COUNTED_REPEAT or (hi is not None
                                       and hi > MAX_COUNTED_REPEAT):
            self.error(f"counted repeat beyond expansion budget "
                       f"{MAX_COUNTED_REPEAT}")
        parts: List[Node] = [_clone(atom) for _ in range(lo)]
        if hi is None:
            parts.append(Star(_clone(atom)))
        else:
            for _ in range(hi - lo):
                parts.append(Alt([_clone(atom), Empty()]))
        if not parts:
            return Empty()
        return parts[0] if len(parts) == 1 else Seq(parts)

    def atom(self) -> Node:
        ch = self.next()
        if ch == "(":
            return self.group()
        if ch == "[":
            return Lit(self.char_class())
        if ch == ".":
            return Lit(_ANY.copy())
        if ch == "\\":
            return Lit(self.escape(in_class=False))
        if ch in "*+?{":
            self.error(f"dangling quantifier {ch!r}")
        b = ch.encode("utf-8")
        if len(b) > 1:
            # multi-byte char -> byte sequence (exact only unquantified)
            return Seq([Lit(_mask_of(x)) for x in b])
        return Lit(_mask_of(b[0]))

    def group(self) -> Node:
        capturing = True
        if self.peek() == "?":
            self.next()
            nxt = self.peek()
            if nxt == ":":
                self.next()
                capturing = False
            else:
                self.error("only (?:...) groups supported "
                           "(no lookaround/named groups/flags)")
        if capturing:
            self.n_groups += 1
            idx = self.n_groups
        node = self.alternation()
        if self.peek() != ")":
            self.error("unterminated group")
        self.next()
        return Group(node, idx) if capturing else node

    def escape(self, in_class: bool) -> np.ndarray:
        ch = self.peek()
        if ch is None:
            self.error("dangling backslash")
        self.next()
        if ch in _CLASS_ESCAPES:
            return _CLASS_ESCAPES[ch].copy()
        if ch in _CHAR_ESCAPES and ch != "0":
            return _mask_of(_CHAR_ESCAPES[ch])
        if ch == "0":
            return _mask_of(0)
        if ch in "123456789":
            self.error("backreferences not supported")
        if ch in ("b", "B", "A", "Z", "z", "G"):
            self.error(f"\\{ch} boundaries not supported")
        if ch in ("p", "P"):
            self.error("unicode classes not supported")
        if ch == "x":
            h = self.p[self.i:self.i + 2]
            if len(h) == 2:
                self.i += 2
                return _mask_of(int(h, 16))
            self.error("bad \\x escape")
        # escaped literal (covers metacharacters and anything else ASCII)
        b = ch.encode("utf-8")
        if len(b) > 1:
            self.error("escaped multi-byte character")
        return _mask_of(b[0])

    def char_class(self) -> np.ndarray:
        neg = False
        if self.peek() == "^":
            self.next()
            neg = True
        mask = np.zeros(256, dtype=bool)
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                self.error("unterminated character class")
            if ch == "]" and not first:
                self.next()
                break
            first = False
            if ch == "\\":
                self.next()
                mask |= self.escape(in_class=True)
                continue
            self.next()
            b = ch.encode("utf-8")
            if len(b) > 1:
                self.error("multi-byte character in class")
            lo = b[0]
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self.next()
                hi_ch = self.next()
                if hi_ch == "\\":
                    hi_mask = self.escape(in_class=True)
                    hid = np.nonzero(hi_mask)[0]
                    if len(hid) != 1:
                        self.error("bad range end")
                    hi = int(hid[0])
                else:
                    hb = hi_ch.encode("utf-8")
                    if len(hb) > 1:
                        self.error("multi-byte character in class")
                    hi = hb[0]
                if hi < lo:
                    self.error("reversed range")
                mask |= _range_mask(lo, hi)
            else:
                mask[lo] = True
        if neg:
            mask = ~mask
            mask[ord("\n")] = mask[ord("\n")]  # Java negated classes DO
            # match newline; keep as-is
        return mask


def _clone(node: Node) -> Node:
    if isinstance(node, Lit):
        return Lit(node.mask.copy())
    if isinstance(node, Seq):
        return Seq([_clone(p) for p in node.parts])
    if isinstance(node, Alt):
        return Alt([_clone(o) for o in node.options])
    if isinstance(node, Star):
        return Star(_clone(node.child))
    if isinstance(node, Group):
        # clones from counted-repeat expansion share the group index;
        # span analysis only supports groups outside repeats anyway
        return Group(_clone(node.child), node.idx)
    return Empty()


def parse_regex(pattern: str):
    """-> (ast, anchored_start, anchored_end); raises RegexUnsupported."""
    p = _Parser(pattern)
    ast = p.parse()
    return ast, p.anchored_start, p.anchored_end
