"""Lock-discipline rules — the counterpart of
spark_rapids_tpu/analysis/rules_locks.py.

One shared walk per module: every `with <registered-lock>:` region is
entered, module-local calls are followed (the engine's `_locked` helper
convention lives in-file), and three findings fall out:

* ``lock-blocking-call`` — a blocking call (IO, wait/join/sleep, queue
  get/put, event emit, a host read of the card or a copy across the
  link, budget reserve-with-drain)
  reachable while the lock is held;
* ``lock-reacquire``     — re-acquisition of a non-reentrant lock along
  the path (the heartbeat's register-under-its-own-lock deadlock class);
* ``lock-order``         — acquiring a lock that sorts EARLIER in the
  registry's declared outermost-first order than one already held.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from . import registry as reg_mod
from .callgraph import ModuleGraph, unparse
from .core import Finding, ModuleInfo

_MAX_DEPTH = 8


def _match_lock(expr: ast.AST, cls: Optional[str], specs) -> Optional[
        reg_mod.LockSpec]:
    text = unparse(expr)
    for spec in specs:
        if spec.expr != text:
            continue
        if spec.cls is None or spec.cls == cls or cls is None:
            # cls None at the call site happens when a module function
            # handles an instance — accept, the expr text is specific
            return spec
    return None


def _blocking_reason(call: ast.Call, reg, held) -> Optional[str]:
    func = call.func
    if isinstance(func, ast.Name):
        if func.id in reg_mod.BLOCKING_NAMES:
            return f"file IO `{func.id}(...)`"
        if func.id in reg.extra_blocking_calls:
            return (f"`{func.id}(...)` — "
                    f"{reg.extra_blocking_calls[func.id]}")
        return None
    if not isinstance(func, ast.Attribute):
        return None
    attr = func.attr
    recv = unparse(func.value)
    if attr == "wait" and any(s.expr == recv for s in held):
        # waiting on the HELD lock's own condition variable releases it
        # atomically — the canonical CV pattern, not a blocked hold
        return None
    if attr == "join" and ("path" in recv or
                           isinstance(func.value, ast.Constant)):
        return None  # os.path.join / ", ".join — not a thread join
    if attr == "reserve" and "budget" in recv:
        for kw in call.keywords:
            if kw.arg == "wait_for_writeback" and isinstance(
                    kw.value, ast.Constant) and kw.value.value is False:
                return None  # the documented lock-safe form
        return "budget reserve (may drain spill writebacks)"
    if attr in reg_mod.BLOCKING_ATTRS:
        return f"blocking `{recv}.{attr}(...)`"
    if attr in reg_mod.QUEUE_BLOCKING_ATTRS and \
            reg_mod.QUEUE_RECEIVER_RE.search(recv):
        return f"queue `{recv}.{attr}(...)`"
    if attr == "emit" and any(h in recv for h in
                              reg_mod.EMIT_RECEIVER_HINTS):
        return f"event emit `{recv}.emit(...)` (bus lock + file write)"
    if attr == "acquire":
        return f"acquire of unregistered lock `{recv}`"
    if attr in reg.extra_blocking_calls:
        return f"`{recv}.{attr}(...)` — {reg.extra_blocking_calls[attr]}"
    return None


class _Walker:
    def __init__(self, module: ModuleInfo, graph: ModuleGraph, reg):
        self.module = module
        self.graph = graph
        self.reg = reg
        self.specs = reg.locks_for(module.path)
        self.blocking: List[Finding] = []
        self.reacquire: List[Finding] = []
        self.order: List[Finding] = []
        self._visited = set()

    def run(self) -> None:
        if not self.specs:
            return
        for qual, cls, fnode in self.graph.scopes():
            for stmt in fnode.body:
                self._scan(stmt, (), cls, qual, (qual,), 0)

    # -- events ------------------------------------------------------------
    def _on_acquire(self, spec, node, held, scope, path) -> Tuple:
        held_names = [s.name for s in held]
        if spec.name in held_names and not spec.reentrant:
            self.reacquire.append(Finding(
                "lock-reacquire", self.module.path, node.lineno, scope,
                spec.name,
                f"non-reentrant lock `{spec.name}` ({spec.expr}) "
                f"re-acquired along {' -> '.join(path)}"))
        order = self.reg.lock_order
        if spec.name in order:
            for h in held:
                if h.name in order and h.name != spec.name and \
                        order.index(spec.name) < order.index(h.name):
                    self.order.append(Finding(
                        "lock-order", self.module.path, node.lineno,
                        scope, f"{h.name}->{spec.name}",
                        f"lock `{spec.name}` acquired while holding "
                        f"`{h.name}` — declared order says "
                        f"`{spec.name}` is the outer lock"))
        if spec.name in held_names:
            return held
        return held + (spec,)

    def _on_call(self, call: ast.Call, held, cls, scope, path,
                 depth) -> None:
        # registered-lock .acquire() without a with-scope
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr == "acquire":
            spec = _match_lock(func.value, cls, self.specs)
            if spec is not None:
                self._on_acquire(spec, call, held, scope, path)
                return
        if held:
            reason = _blocking_reason(call, self.reg, held)
            if reason is not None:
                inner = held[-1].name
                via = (f" (via {' -> '.join(path)})"
                       if len(path) > 1 else "")
                self.blocking.append(Finding(
                    "lock-blocking-call", self.module.path, call.lineno,
                    scope, f"{inner}::{_call_key(call)}",
                    f"{reason} while holding lock `{inner}`{via}"))
        # follow module-local targets with the held set
        resolved = self.graph.resolve_call(call, cls)
        if resolved is not None and depth < _MAX_DEPTH:
            (tcls, tname), tnode = resolved
            tqual = f"{tcls}.{tname}" if tcls else tname
            vkey = (tqual, tuple(sorted(s.name for s in held)))
            if tqual not in path and vkey not in self._visited:
                self._visited.add(vkey)
                for stmt in tnode.body:
                    self._scan(stmt, held, tcls if tcls else cls, tqual,
                               path + (tqual,), depth + 1)

    # -- recursion ---------------------------------------------------------
    def _scan(self, node, held, cls, scope, path, depth) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return  # nested defs run later, not under this hold
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in node.items:
                spec = _match_lock(item.context_expr, cls, self.specs)
                if spec is not None:
                    new_held = self._on_acquire(spec, node, new_held,
                                                scope, path)
                else:
                    self._scan(item.context_expr, held, cls, scope,
                               path, depth)
            for b in node.body:
                self._scan(b, new_held, cls, scope, path, depth)
            return
        if isinstance(node, ast.Call):
            self._on_call(node, held, cls, scope, path, depth)
        for child in ast.iter_child_nodes(node):
            self._scan(child, held, cls, scope, path, depth)


def _call_key(call: ast.Call) -> str:
    return unparse(call.func)


def _walk(module: ModuleInfo, graph: ModuleGraph, reg) -> _Walker:
    cached = getattr(graph, "_lock_walk", None)
    if cached is not None:
        return cached
    w = _Walker(module, graph, reg)
    w.run()
    graph._lock_walk = w
    return w


def check_blocking(module, graph, reg):
    return list(_walk(module, graph, reg).blocking)


def check_reacquire(module, graph, reg):
    return list(_walk(module, graph, reg).reacquire)


def check_order(module, graph, reg):
    return list(_walk(module, graph, reg).order)
