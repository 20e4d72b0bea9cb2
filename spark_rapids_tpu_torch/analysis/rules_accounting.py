"""Accounting-symmetry rule — the counterpart of
spark_rapids_tpu/analysis/rules_accounting.py.

Registry-declared paired calls — budget ``reserve``/``release``, quota
``charge``/``discharge`` — must stay balanced on every exception edge:
the JAX package's review history fixed counters left asymmetric on a
failure branch again and again (a failed writeback keeping freed bytes
counted, a quota charge surviving its entry's death). Two shapes are
flagged:

* **one-sided** — a function opens (reserves/charges) but contains no
  close at all, and is not a registry-declared escrow function (one
  whose obligation transfers to an object by design);
* **exception-edge** — opens and closes exist, but no close sits in a
  ``finally``/``except`` and calls that may raise run between the open
  and the close, so an unwind leaks the obligation.
"""

from __future__ import annotations

import ast
from typing import List

from .callgraph import ModuleGraph, unparse
from .core import Finding, ModuleInfo


def _match(call: ast.Call, attr: str, hint: str) -> bool:
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr == attr:
        return hint in unparse(func.value)
    return False


def _guarded(fnode: ast.FunctionDef, pair) -> bool:
    """A close inside any finally/except body of the function."""
    for node in ast.walk(fnode):
        if not isinstance(node, ast.Try):
            continue
        guard_stmts: List[ast.stmt] = list(node.finalbody)
        for h in node.handlers:
            guard_stmts.extend(h.body)
        for stmt in guard_stmts:
            for call in ast.walk(stmt):
                if isinstance(call, ast.Call) and _match(
                        call, pair.close_attr, pair.receiver_hint):
                    return True
    return False


def check(module: ModuleInfo, graph: ModuleGraph, reg):
    pairs = reg.pairs_for(module.path)
    if not pairs:
        return []
    out = []
    for qual, cls, fnode in graph.scopes():
        for pair in pairs:
            if qual in pair.escrow:
                continue
            opens = []
            closes = []
            for node in ast.walk(fnode):
                if isinstance(node, ast.Call):
                    if _match(node, pair.open_attr, pair.receiver_hint):
                        opens.append(node)
                    elif _match(node, pair.close_attr,
                                pair.receiver_hint):
                        closes.append(node)
            if not opens:
                continue
            if not closes:
                out.append(Finding(
                    "accounting-symmetry", module.path, opens[0].lineno,
                    qual, f"{pair.name}:one-sided",
                    f"`{pair.open_attr}` ({pair.name}) with no "
                    f"`{pair.close_attr}` on any path of `{qual}` — "
                    "declare the escrow in the registry if ownership "
                    "transfers, else close on every edge"))
                continue
            if _guarded(fnode, pair):
                continue
            open_line = min(o.lineno for o in opens)
            close_line = max(c.lineno for c in closes)
            risky = False
            skip = {id(n) for n in opens} | {id(n) for n in closes}
            for node in ast.walk(fnode):
                if isinstance(node, (ast.Call, ast.Raise)) and \
                        id(node) not in skip and \
                        open_line < getattr(node, "lineno", 0) < \
                        close_line:
                    risky = True
                    break
            if risky:
                out.append(Finding(
                    "accounting-symmetry", module.path, open_line, qual,
                    f"{pair.name}:exception-edge",
                    f"`{pair.open_attr}`/`{pair.close_attr}` "
                    f"({pair.name}) in `{qual}` balance only on the "
                    "straight-line path — calls between them can "
                    "raise and leak the obligation; close in a "
                    "finally/except"))
    return out
