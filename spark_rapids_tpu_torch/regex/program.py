"""Glushkov position-automaton construction: regex AST -> RegexProgram
(first/last/follow bit sets + per-byte position masks) — a copy of
spark_rapids_tpu/regex/program.py (pure Python and numpy).

The Glushkov automaton has one state per literal *position* in the regex —
no epsilon transitions, which is what makes the device step a pure bitwise
operation: next = (follow(state) | inject) & byte_class_mask[byte]. The
reference reaches the same endpoint via cuDF's regex VM; the
bit-parallel formulation vectorizes across the whole column
(regex/kernel.py holds the masks in int64 lanes).
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

import numpy as np

from .parser import (
    Alt, Empty, Lit, Node, RegexUnsupported, Seq, Star, parse_regex,
)

#: state mask is a uint32 — positions beyond this reject at plan time
MAX_POSITIONS = 32


class _Info:
    __slots__ = ("nullable", "first", "last")

    def __init__(self, nullable: bool, first: Set[int], last: Set[int]):
        self.nullable = nullable
        self.first = first
        self.last = last


class RegexProgram:
    """Compiled pattern, ready for the device kernel."""

    def __init__(self, pattern: str, n_pos: int, byte_table: np.ndarray,
                 follow_rows: np.ndarray, first_mask: int, last_mask: int,
                 nullable: bool, anchored_start: bool, anchored_end: bool):
        self.pattern = pattern
        self.n_pos = n_pos
        #: (256,) uint32: positions whose byte class contains each byte
        self.byte_table = byte_table
        #: (n_pos,) uint32: follow set of each position
        self.follow_rows = follow_rows
        self.first_mask = first_mask
        self.last_mask = last_mask
        self.nullable = nullable
        self.anchored_start = anchored_start
        self.anchored_end = anchored_end

    def __repr__(self):
        return (f"RegexProgram({self.pattern!r}, states={self.n_pos}, "
                f"^={self.anchored_start}, $={self.anchored_end})")


def _build(node: Node, positions: List[np.ndarray],
           follow: List[Set[int]]) -> _Info:
    if isinstance(node, Empty):
        return _Info(True, set(), set())
    if isinstance(node, Lit):
        idx = len(positions)
        if idx >= MAX_POSITIONS:
            raise RegexUnsupported(
                f"pattern needs more than {MAX_POSITIONS} positions")
        positions.append(node.mask)
        follow.append(set())
        return _Info(False, {idx}, {idx})
    if isinstance(node, Seq):
        info = _build(node.parts[0], positions, follow)
        for part in node.parts[1:]:
            nxt = _build(part, positions, follow)
            for l in info.last:
                follow[l] |= nxt.first
            first = info.first | nxt.first if info.nullable else info.first
            last = nxt.last | info.last if nxt.nullable else nxt.last
            info = _Info(info.nullable and nxt.nullable, first, last)
        return info
    if isinstance(node, Alt):
        infos = [_build(o, positions, follow) for o in node.options]
        return _Info(any(i.nullable for i in infos),
                     set().union(*(i.first for i in infos)),
                     set().union(*(i.last for i in infos)))
    if isinstance(node, Star):
        inner = _build(node.child, positions, follow)
        for l in inner.last:
            follow[l] |= inner.first
        return _Info(True, inner.first, inner.last)
    from .parser import Group
    if isinstance(node, Group):
        return _build(node.child, positions, follow)
    raise RegexUnsupported(f"unknown node {type(node).__name__}")


def _mask_of_set(s: Set[int]) -> int:
    m = 0
    for i in s:
        m |= 1 << i
    return m


def _compile(ast: Node, pattern: str, anchored_start: bool,
             anchored_end: bool) -> RegexProgram:
    positions: List[np.ndarray] = []
    follow: List[Set[int]] = []
    info = _build(ast, positions, follow)
    n = len(positions)
    byte_table = np.zeros(256, dtype=np.uint32)
    for i, mask in enumerate(positions):
        byte_table[mask] |= np.uint32(1 << i)
    follow_rows = np.array([_mask_of_set(f) for f in follow],
                           dtype=np.uint32) if n else \
        np.zeros(0, dtype=np.uint32)
    return RegexProgram(pattern, n, byte_table, follow_rows,
                        _mask_of_set(info.first), _mask_of_set(info.last),
                        info.nullable, anchored_start, anchored_end)


def compile_regex(pattern: str) -> RegexProgram:
    """Java-regex subset -> device program; RegexUnsupported on rejects
    (the planner turns that into an off-TPU tag, reference behavior)."""
    ast, a_start, a_end = parse_regex(pattern)
    return _compile(ast, pattern, a_start, a_end)


def like_to_program(pattern: str, escape: str = "\\") -> RegexProgram:
    """SQL LIKE -> device program: % = any run, _ = any one byte, escape
    char per Spark's LIKE ... ESCAPE (anchored both ends)."""
    from .parser import Lit as PLit, Seq as PSeq, Star as PStar, Empty as PEmpty
    any_byte = np.ones(256, dtype=bool)
    parts: List[Node] = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == escape:
            if i + 1 >= len(pattern):
                raise RegexUnsupported(
                    f"LIKE pattern {pattern!r} ends with escape")
            nxt = pattern[i + 1]
            for b in nxt.encode("utf-8"):
                m = np.zeros(256, dtype=bool)
                m[b] = True
                parts.append(PLit(m))
            i += 2
            continue
        if ch == "%":
            parts.append(PStar(PLit(any_byte.copy())))
        elif ch == "_":
            parts.append(PLit(any_byte.copy()))
        else:
            for b in ch.encode("utf-8"):
                m = np.zeros(256, dtype=bool)
                m[b] = True
                parts.append(PLit(m))
        i += 1
    ast: Node = PSeq(parts) if len(parts) > 1 else \
        (parts[0] if parts else PEmpty())
    return _compile(ast, f"LIKE:{pattern}", True, True)
