"""Thread-local propagation rule — the counterpart of
spark_rapids_tpu/analysis/rules_threads.py.

Every `threading.Thread(target=...)` and pool `submit`/`map` in the
package spawns work on a thread with EMPTY thread-locals: active conf,
event-log query id, speculation scope, task attempt, lifecycle context
and breaker engagement are all gone unless the target routes through
the capture/adopt helpers. The rule resolves
the spawn target module-locally and requires an adopt-helper call
somewhere in its reachable body — or an explicit justified suppression
at the spawn site (e.g. a process-wide daemon that carries no per-query
context by design).
"""

from __future__ import annotations

import ast
from typing import Optional

from .callgraph import ModuleGraph, unparse
from .core import Finding, ModuleInfo

_MAX_DEPTH = 8


def _spawn_target(call: ast.Call) -> Optional[ast.AST]:
    """The callable a spawn site runs, or None if not a spawn."""
    func = call.func
    if isinstance(func, (ast.Name, ast.Attribute)) and \
            unparse(func).endswith("Thread"):
        for kw in call.keywords:
            if kw.arg == "target":
                return kw.value
        return None
    if isinstance(func, ast.Attribute) and func.attr == "submit" and \
            call.args:
        return call.args[0]
    if isinstance(func, ast.Attribute) and func.attr == "map" and \
            "pool" in unparse(func.value) and call.args:
        return call.args[0]
    return None


def _target_adopts(graph: ModuleGraph, target: ast.AST,
                   cls: Optional[str], reg) -> Optional[bool]:
    """True/False when the target resolves module-locally; None when it
    cannot be resolved (cross-module / lambda / partial)."""
    if isinstance(target, ast.Call):  # functools.partial(fn, ...)
        if target.args:
            return _target_adopts(graph, target.args[0], cls, reg)
        return None
    if isinstance(target, ast.Lambda):
        # a lambda wrapper adopts if its body routes through a helper
        # (e.g. lambda p: obs_events.with_query_id(qid, fn, p))
        for node in ast.walk(target.body):
            if isinstance(node, ast.Call):
                fn = node.func
                cname = fn.id if isinstance(fn, ast.Name) else (
                    fn.attr if isinstance(fn, ast.Attribute) else None)
                if cname in reg.adopt_helpers:
                    return True
        return None
    # the target IS an adopt helper (obs_events.with_query_id wrapper)
    terminal = target.id if isinstance(target, ast.Name) else (
        target.attr if isinstance(target, ast.Attribute) else None)
    if terminal in reg.adopt_helpers:
        return True
    name = None
    if isinstance(target, ast.Name):
        name = target.id
    elif isinstance(target, ast.Attribute) and isinstance(
            target.value, ast.Name) and target.value.id in ("self", "cls"):
        name = target.attr
    if name is None:
        return None
    resolved = graph.resolve_name(name, cls)
    if resolved is None:
        return None
    seen = set()

    def reach(fnode, fcls, depth) -> bool:
        for node in ast.walk(fnode):
            if isinstance(node, ast.Call):
                fn = node.func
                cname = fn.id if isinstance(fn, ast.Name) else (
                    fn.attr if isinstance(fn, ast.Attribute) else None)
                if cname in reg.adopt_helpers:
                    return True
                if depth < _MAX_DEPTH:
                    sub = graph.resolve_call(node, fcls)
                    if sub is not None and sub[0] not in seen:
                        seen.add(sub[0])
                        (scls, _), snode = sub
                        if reach(snode, scls or fcls, depth + 1):
                            return True
        return False

    (tcls, _), tnode = resolved
    return reach(tnode, tcls or cls, 0)


def check(module: ModuleInfo, graph: ModuleGraph, reg):
    if reg.scope_prefix not in module.path:
        return []
    out = []
    for qual, cls, fnode in graph.scopes():
        for node in ast.walk(fnode):
            if not isinstance(node, ast.Call):
                continue
            target = _spawn_target(node)
            if target is None:
                continue
            adopts = _target_adopts(graph, target, cls, reg)
            if adopts:
                continue
            tdesc = unparse(target)
            how = ("never calls a capture/adopt helper"
                   if adopts is False else
                   "is not module-locally resolvable (adoption cannot "
                   "be verified)")
            out.append(Finding(
                "thread-adopt", module.path, node.lineno, qual, tdesc,
                f"spawn target `{tdesc}` {how} — thread-locals (conf, "
                "query id, attempt, speculation, engagement) will not "
                "propagate; adopt them or suppress with the why"))
    return out
