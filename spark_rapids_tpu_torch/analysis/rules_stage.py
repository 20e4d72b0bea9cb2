"""Stage-governance rule — the counterpart of
spark_rapids_tpu/analysis/rules_stage.py.

``stage-governance``: a function handed to the program-site chokepoint
(``obs.dispatch.instrument`` / ``TpuExec._site``) is a STAGE BODY — on
the card each static shape of it is captured once into a CUDA graph and
replayed after that. Per-batch governance hooks inside such a body are
latent bugs of two shapes:

* **silently dead**: the hook runs at the capture, not on a replay — a
  lifecycle ``tick()``, a chaos ``faults.check`` or a metric timer
  inside a captured body fires once per captured shape instead of once
  per batch, so cancellation latency, fault coverage and metric totals
  all lie;
* **replay-impure**: hooks that mutate host state (event ``emit``,
  gather ``observe``, engagement notes) from inside a capture record
  nothing a replay repeats.

They belong in the stage-boundary harness (``TpuExec.batch_harness``
and the ``TpuExec._drive`` batch loop). The walk resolves the function
object handed to the chokepoint (a local def, ``self._method``, a
lambda, a ``partial(...)`` wrapper or an ``@instrument``/``@partial(
instrument, ...)`` decorator) and flags governance calls in its body
and in module-local calls one hop down. ``handed_bodies`` is the same
resolution, shared with the ``trace-host-sync`` rule.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from .callgraph import ModuleGraph, attr_root
from .core import Finding, ModuleInfo

#: attribute calls that are per-batch governance hooks, never stage
#: dataflow (names chosen to not collide with tensor attributes)
_HOOK_ATTRS = frozenset({
    "tick",            # lifecycle cancellation check
    "note_batch",      # lifecycle live progress
    "ns_timer",        # metric wall timers
    "add_device",      # metric device accumulation
    "observe",         # GatherTracker scopes
    "emit",            # event-bus records
    "batch_harness",   # the harness itself must wrap, not be captured
})

#: bare-name governance calls
_HOOK_NAMES = frozenset({
    "note_engagement", "engage_domain", "record_domain_failure",
    "breaker_allows",
})

#: roots whose .check(...) is the chaos fault-point hook (scoping by root
#: keeps tensor methods clean)
_FAULT_ROOTS = frozenset({"faults"})


def _hook_calls(fn: ast.AST) -> List[Tuple[int, str]]:
    out: List[Tuple[int, str]] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in _HOOK_ATTRS:
                out.append((node.lineno, f.attr))
            elif f.attr == "check" and attr_root(f) in _FAULT_ROOTS:
                out.append((node.lineno, "faults.check"))
            elif f.attr in _HOOK_NAMES:
                out.append((node.lineno, f.attr))
        elif isinstance(f, ast.Name) and f.id in _HOOK_NAMES:
            out.append((node.lineno, f.id))
    return out


def _unwrap_fn_arg(arg: ast.AST) -> Optional[ast.AST]:
    """The function expression inside an instrument() argument:
    a Name, self._method attribute, lambda, or partial(fn, ...)."""
    if isinstance(arg, (ast.Name, ast.Attribute, ast.Lambda)):
        return arg
    if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name) \
            and arg.func.id == "partial" and arg.args:
        return _unwrap_fn_arg(arg.args[0])
    return None


def _is_chokepoint(func: ast.AST) -> bool:
    """instrument / _instrument aliases and the TpuExec._site helper."""
    if isinstance(func, ast.Name):
        return func.id.endswith("instrument")
    if isinstance(func, ast.Attribute):
        return func.attr in ("instrument", "_site")
    return False


def _resolve_body(expr: ast.AST, graph: ModuleGraph,
                  cls: Optional[str]) -> Optional[ast.AST]:
    if isinstance(expr, ast.Lambda):
        return expr
    if isinstance(expr, ast.Name):
        hit = graph.resolve_name(expr.id, cls)
        return hit[1] if hit else None
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name) and \
            expr.value.id in ("self", "cls") and cls:
        key = (cls, expr.attr)
        fn = graph.functions.get(key)
        if fn is None:
            fn = graph.by_name.get(expr.attr)
        return fn
    return None


def handed_bodies(module: ModuleInfo, graph: ModuleGraph
                  ) -> Iterator[Tuple[ast.AST, Optional[str], int,
                                      Optional[ast.Call]]]:
    """(body, class, chokepoint line, chokepoint call or None for a
    decorator) for every module-locally resolvable function handed to the
    chokepoint."""
    out: List[Tuple[ast.AST, Optional[str], int, Optional[ast.Call]]] = []

    def walk_scope(nodes, cls: Optional[str]):
        for node in nodes:
            if isinstance(node, ast.ClassDef):
                walk_scope(node.body, node.name)
                continue
            for call in ast.walk(node):
                if not isinstance(call, ast.Call) \
                        or not _is_chokepoint(call.func):
                    continue
                # positional fn (instrument(fn, ...) / _site(fn, ...));
                # the decorator-factory form has no fn argument here, the
                # decorated def is handled below
                for a in call.args:
                    fexpr = _unwrap_fn_arg(a)
                    if fexpr is None:
                        continue
                    body = _resolve_body(fexpr, graph, cls)
                    if body is not None:
                        out.append((body, cls, call.lineno, call))
            # decorated defs: @instrument(label=...) / @partial(
            # instrument, ...) / @partial(self._site, ...)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if isinstance(dec, ast.Call) and (
                            _is_chokepoint(dec.func)
                            or (isinstance(dec.func, ast.Name)
                                and dec.func.id == "partial"
                                and dec.args
                                and _is_chokepoint(dec.args[0]))):
                        out.append((node, cls, dec.lineno, None))
                walk_scope(node.body, cls)

    walk_scope(module.tree.body, None)
    # a def's calls are walked from the def and again from its statements
    seen = set()
    for item in out:
        if (id(item[0]), item[2]) not in seen:
            seen.add((id(item[0]), item[2]))
            yield item


def check(module: ModuleInfo, graph: ModuleGraph, reg):
    if reg.scope_prefix not in module.path:
        return []
    out: List[Finding] = []
    #: (body node id, hook line, hook) already reported — a body handed
    #: to two sites (tier dicts) must not double-report
    seen: Set[Tuple[int, int, str]] = set()
    for body, cls, site_line, _call in handed_bodies(module, graph):
        hooks = list(_hook_calls(body))
        # one hop into module-local callees: a hook moved into a local
        # helper is the same bug
        for call in ast.walk(body):
            if not isinstance(call, ast.Call):
                continue
            hit = graph.resolve_call(call, cls)
            if hit is not None and hit[1] is not body:
                hooks.extend(_hook_calls(hit[1]))
        name = getattr(body, "name", "<lambda>")
        for line, hook in hooks:
            key = (id(body), line, hook)
            if key in seen:
                continue
            seen.add(key)
            out.append(Finding(
                "stage-governance", module.path, line,
                name, hook,
                f"governance hook `{hook}` inside the stage body handed "
                f"to the program-site chokepoint at line {site_line} — "
                "per-batch hooks run at the graph capture, not on a "
                "replay (silently dead on a warm stage); move it to the "
                "stage-boundary harness (TpuExec.batch_harness / the "
                "_drive batch loop)"))
    return out
