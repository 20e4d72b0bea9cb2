"""Match spans for regexp_replace and regexp_extract — the counterpart of
spark_rapids_tpu/regex/spans.py.

The Glushkov matcher (regex/kernel.py) answers *whether* a row matches;
replace and extract need *where*. Bit-parallel simulation cannot recover
Java's backtracking-preferred extents in general, so the device handles
the two shapes where the preferred extent is derivable byte-parallel:

  FIXED      every match has the same byte length L (class sequences,
             equal-length alternations, counted repeats {m}): a match
             starting at byte b is a window test, and Java's preference
             plays no role because all extents are equal.
  CLASSPLUS  one character class under + ([0-9]+, \\s+, a+): matches are
             exactly the maximal runs of class bytes.

Any other pattern raises RegexUnsupported from `compile_spans`, and the
planner tags the expression off (the JAX package runs it on its host row
tier, ROADMAP A.8 wave 4). The pattern analysis is the JAX module's,
copied; the span finding is torch ops. Non-overlapping fixed-length
matches come from ops/strings.greedy_select, whose loop bound is one
counted host read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..columnar.column import StringColumn
from ..ops.strings import _byte_table, device_constant
from .parser import (Alt, Empty, Group, Lit, Node, RegexUnsupported, Seq,
                     Star, parse_regex)

_BIG = 1 << 30


# -- pattern analysis -------------------------------------------------------

def _fixed_len(node: Node) -> Optional[int]:
    if isinstance(node, Empty):
        return 0
    if isinstance(node, Lit):
        return 1
    if isinstance(node, Group):
        return _fixed_len(node.child)
    if isinstance(node, Seq):
        total = 0
        for p in node.parts:
            l = _fixed_len(p)
            if l is None:
                return None
            total += l
        return total
    if isinstance(node, Alt):
        lens = [_fixed_len(o) for o in node.options]
        if any(l is None for l in lens) or len(set(lens)) != 1:
            return None
        return lens[0]
    return None  # Star


def _strip_groups(node: Node) -> Node:
    if isinstance(node, Group):
        return _strip_groups(node.child)
    if isinstance(node, Seq):
        return Seq([_strip_groups(p) for p in node.parts])
    if isinstance(node, Alt):
        return Alt([_strip_groups(o) for o in node.options])
    if isinstance(node, Star):
        return Star(_strip_groups(node.child))
    return node


def _classplus_mask(node: Node) -> Optional[np.ndarray]:
    """X+ (parsed as Seq([X, Star(X)])) for a single byte class X."""
    node = _strip_groups(node)
    if isinstance(node, Seq) and len(node.parts) == 2:
        a, b = node.parts
        a = _strip_groups(a)
        b = _strip_groups(b)
        if isinstance(a, Lit) and isinstance(b, Star):
            inner = _strip_groups(b.child)
            if isinstance(inner, Lit) and np.array_equal(a.mask,
                                                         inner.mask):
                return a.mask
    return None


def _group_window(node: Node, idx: int) -> Optional[Tuple[int, int]]:
    """(byte offset, byte length) of capture group `idx` within a FIXED
    match, when that offset is itself fixed; None otherwise."""

    def walk(n: Node, off: int) -> Tuple[Optional[Tuple[int, int]], int]:
        if isinstance(n, Group):
            l = _fixed_len(n.child)
            if n.idx == idx:
                return ((off, l), off + l) if l is not None else (None,
                                                                  -1)
            return walk(n.child, off)
        if isinstance(n, Seq):
            found = None
            for p in n.parts:
                got, off = walk(p, off)
                if off < 0:
                    return None, -1
                if got is not None:
                    found = got
            return found, off
        if isinstance(n, Alt):
            # group inside an alternation has no fixed offset
            for o in n.options:
                if _contains_group(o, idx):
                    return None, -1
            l = _fixed_len(n)
            return None, off + l if l is not None else -1
        l = _fixed_len(n)
        return None, (off + l) if l is not None else -1

    got, off = walk(node, 0)
    return got if off >= 0 else None


def _contains_group(n: Node, idx: int) -> bool:
    if isinstance(n, Group):
        return n.idx == idx or _contains_group(n.child, idx)
    if isinstance(n, Seq):
        return any(_contains_group(p, idx) for p in n.parts)
    if isinstance(n, Alt):
        return any(_contains_group(o, idx) for o in n.options)
    if isinstance(n, Star):
        return _contains_group(n.child, idx)
    return False


class SpanPlan:
    """Compiled span finder: kind 'fixed' (window tree, length L) or
    'classplus' (byte-class runs)."""

    def __init__(self, kind: str, tree: Node, L: Optional[int],
                 cls: Optional[np.ndarray], anchored_start: bool,
                 anchored_end: bool, n_groups: int):
        self.kind = kind
        self.tree = tree
        self.L = L
        self.cls = cls
        self.anchored_start = anchored_start
        self.anchored_end = anchored_end
        self.n_groups = n_groups


def compile_spans(pattern: str) -> SpanPlan:
    """Raises RegexUnsupported when the pattern fits neither shape."""
    tree, a_start, a_end = parse_regex(pattern)
    n_groups = _count_groups(tree)
    L = _fixed_len(tree)
    if L is not None and L >= 1:
        return SpanPlan("fixed", tree, L, None, a_start, a_end, n_groups)
    cls = _classplus_mask(tree)
    if cls is not None:
        return SpanPlan("classplus", tree, None, cls, a_start, a_end,
                        n_groups)
    raise RegexUnsupported(
        f"pattern {pattern!r}: match spans are only derivable for "
        "fixed-length patterns and single-class X+ on device")


def _count_groups(n: Node) -> int:
    if isinstance(n, Group):
        return max(n.idx, _count_groups(n.child))
    if isinstance(n, Seq):
        return max([_count_groups(p) for p in n.parts], default=0)
    if isinstance(n, Alt):
        return max([_count_groups(o) for o in n.options], default=0)
    if isinstance(n, Star):
        return _count_groups(n.child)
    return 0


# -- device span finding ----------------------------------------------------

def _window_hits(node: Node, col: StringColumn, base: torch.Tensor,
                 off: int) -> Tuple[torch.Tensor, int]:
    """(hits, consumed): hits[b] = the subtree matches starting at byte
    base[b] + off. Only fixed-length subtrees reach here."""
    if isinstance(node, Empty):
        return torch.ones(base.shape, dtype=torch.bool,
                          device=base.device), off
    if isinstance(node, Group):
        return _window_hits(node.child, col, base, off)
    if isinstance(node, Lit):
        table = device_constant(node.mask, col.device)
        p = torch.clamp(base + off, 0, col.byte_capacity - 1).long()
        return table[col.data[p].long()], off + 1
    if isinstance(node, Seq):
        ok = torch.ones(base.shape, dtype=torch.bool, device=base.device)
        for part in node.parts:
            h, off = _window_hits(part, col, base, off)
            ok = ok & h
        return ok, off
    if isinstance(node, Alt):
        ok = torch.zeros(base.shape, dtype=torch.bool, device=base.device)
        out_off = off
        for o in node.options:
            h, out_off = _window_hits(o, col, base, off)
            ok = ok | h
        return ok, out_off
    raise RegexUnsupported("variable-length subtree in fixed plan")


def find_spans(col: StringColumn, plan: SpanPlan):
    """-> (byte mask of match starts, int32 (byte_cap,) span lengths valid
    at the starts): Java's non-overlapping find() sequence."""
    from ..ops.strings import _col_bytes
    byte_cap = col.byte_capacity
    pos, row, intra, in_use = _col_bytes(col)
    row_start = col.offsets[row]
    row_end = col.offsets[row + 1]

    if plan.kind == "fixed":
        L = plan.L
        hits, _ = _window_hits(plan.tree, col, pos, 0)
        hits = hits & in_use & (pos + L <= row_end)
        if plan.anchored_start:
            hits = hits & (pos == row_start)
        if plan.anchored_end:
            hits = hits & (pos + L == row_end)
        if L > 1:
            hits = _greedy_nonoverlap(col, hits, L)
        return hits, torch.full((byte_cap,), L, dtype=torch.int32,
                                device=col.device)

    table = device_constant(plan.cls, col.device)
    isc = table[col.data.long()] & in_use
    prev = torch.clamp(pos - 1, 0, byte_cap - 1).long()
    run_start = isc & (~isc[prev] | (pos == row_start))
    # each run ends at the next byte outside the class (or its row's end):
    # a reversed running minimum of the non-class positions
    non = torch.where(~isc, pos, _BIG)
    nxt_non = torch.flip(torch.cummin(torch.flip(non, [0]), 0).values, [0])
    run_len = torch.minimum(nxt_non, row_end) - pos
    if plan.anchored_start:
        run_start = run_start & (pos == row_start)
    if plan.anchored_end:
        run_start = run_start & (pos + run_len == row_end)
    return run_start, run_len.to(torch.int32)


def _greedy_nonoverlap(col: StringColumn, hits: torch.Tensor, L: int):
    """Left-to-right non-overlapping selection of fixed-length-L hits (the
    cursor loop of ops/strings.select_literal_hits)."""
    from ..ops.strings import _col_bytes, greedy_select
    _, row, intra, _ = _col_bytes(col)
    return greedy_select(col, hits, L, row, intra)


# -- replace / extract ------------------------------------------------------

def regexp_replace_device(col: StringColumn, plan: SpanPlan,
                          replacement: bytes) -> StringColumn:
    """Every match of the plan replaced by the literal `replacement`. Byte
    bucket: the input's when the replacement is at most one byte, else
    the JAX package's worst case (every byte a match): bytes x |repl|."""
    from ..columnar.column import bucket_capacity
    from ..ops.strings import _col_bytes, _emit_gather, _segment
    byte_cap = col.byte_capacity
    pos, row, _, in_use = _col_bytes(col)
    sel, span_len = find_spans(col, plan)
    sel = sel & col.validity[row]
    lr = len(replacement)
    # coverage by a difference array (the spans' lengths vary)
    diff = torch.zeros(byte_cap + 1, dtype=torch.int32, device=col.device)
    s_idx = torch.where(sel, pos, byte_cap).long()
    e_idx = torch.where(sel, torch.clamp(pos + span_len, 0, byte_cap),
                        byte_cap).long()
    one = torch.ones_like(s_idx, dtype=torch.int32)
    diff.index_add_(0, s_idx, torch.where(sel, one, 0))
    diff.index_add_(0, e_idx, torch.where(sel, -one, 0))
    # the spare slot byte_cap takes the JAX package's dropped updates
    covered = torch.cumsum(diff[:-1], 0, dtype=torch.int32) > 0
    emit = torch.where(in_use, 1, 0).to(torch.int32)
    emit = torch.where(covered, 0, emit)
    emit = torch.where(sel, lr, emit).to(torch.int32)
    out_lens = _segment(emit, row, col.capacity, "sum")
    out_byte_cap = byte_cap if lr <= 1 else bucket_capacity(byte_cap * lr)
    new_offsets, src, k, out_in_use = _emit_gather(col, emit, row, out_lens,
                                                   out_byte_cap)
    repl = _byte_table(replacement, col.device)
    byte = torch.where(sel[src], repl[torch.clamp(k, 0, max(lr - 1, 0))
                                      .long()], col.data[src])
    data = torch.where(out_in_use, byte,
                       torch.zeros((), dtype=torch.uint8, device=col.device))
    return StringColumn(data, new_offsets, col.validity, col.dtype)


def extract_window(plan: SpanPlan, idx: int):
    """(offset, length or None for "to the match's end") of group `idx`
    within a match; RegexUnsupported when it has no fixed window."""
    if idx < 0 or idx > plan.n_groups:
        raise RegexUnsupported(f"group {idx} out of range")
    if idx == 0:
        return 0, None  # the whole match
    if plan.kind == "classplus":
        # only a group around the whole X+ ("([0-9]+)"); a group under the
        # repeat ("([0-9])+", Java's last iteration) parses as a Seq
        if not (isinstance(plan.tree, Group) and plan.tree.idx == idx):
            raise RegexUnsupported(
                "classplus extract needs the group around the whole X+")
        return 0, None
    win = _group_window(plan.tree, idx)
    if win is None:
        raise RegexUnsupported(
            f"group {idx} has no fixed offset inside the match")
    return win


def regexp_extract_device(col: StringColumn, plan: SpanPlan,
                          idx: int) -> StringColumn:
    """The first match's group `idx` per row; "" when the row has no match
    (Java), null only for a null input. Raises RegexUnsupported when the
    group has no fixed window inside the match."""
    from ..ops.strings import _col_bytes, _segment, _substring_gather
    g_off, g_len = extract_window(plan, idx)
    byte_cap = col.byte_capacity
    pos, row, _, _ = _col_bytes(col)
    sel, span_len = find_spans(col, plan)
    first = _segment(torch.where(sel, pos, _BIG), row, col.capacity, "amin")
    has = first < _BIG
    firstc = torch.clamp(first, 0, byte_cap - 1)
    mlen = span_len[firstc.long()]
    start = torch.where(has, firstc + g_off, 0)
    length = torch.where(has, mlen - g_off if g_len is None
                         else torch.full_like(mlen, g_len), 0)
    length = torch.clamp(length, min=0)
    return _substring_gather(col, start.to(torch.int32),
                             length.to(torch.int32))
