"""Conf-provenance rule — the counterpart of
spark_rapids_tpu/analysis/rules_conf.py.

The JAX package's review rounds found the same bug three times: state
shared across queries (admission slots, quota fractions, breaker
consults) was parameterized from the CALLING thread's `active_conf()`,
which on a cross-query path belongs to an unrelated query (or to no
query at all — a bench lane, the spill writer). The registry declares
the engine's cross-query/producer entry points; any `active_conf()`
call on a module-local path from one of them is flagged — the value
must ride a captured conf, the admitting Ticket, or a job argument.
"""

from __future__ import annotations

import ast

from .callgraph import ModuleGraph, unparse
from .core import Finding, ModuleInfo

_MAX_DEPTH = 8


def _is_active_conf(call: ast.Call) -> bool:
    func = call.func
    if isinstance(func, ast.Name):
        return func.id == "active_conf"
    if isinstance(func, ast.Attribute):
        return func.attr == "active_conf"
    return False


def check(module: ModuleInfo, graph: ModuleGraph, reg):
    entries = reg.entries_for(module.path)
    if not entries:
        return []
    out = []
    seen_findings = set()
    for entry in entries:
        resolved = None
        if (entry.cls, entry.func) in graph.functions:
            resolved = ((entry.cls, entry.func),
                        graph.functions[(entry.cls, entry.func)])
        else:
            resolved = graph.resolve_name(entry.func, entry.cls)
        if resolved is None:
            continue
        visited = set()

        def walk(fnode, fcls, qual, path, depth):
            for node in ast.walk(fnode):
                if not isinstance(node, ast.Call):
                    continue
                if _is_active_conf(node):
                    fkey = (qual, node.lineno)
                    if fkey in seen_findings:
                        continue
                    seen_findings.add(fkey)
                    via = (f" via {' -> '.join(path)}"
                           if len(path) > 1 else "")
                    out.append(Finding(
                        "conf-provenance", module.path, node.lineno,
                        qual, "active_conf",
                        "active_conf() read on a cross-query path "
                        f"(entry `{path[0]}`: {entry.note}){via} — the "
                        "executing thread's conf may belong to an "
                        "unrelated query; pass a captured conf/Ticket"))
                elif depth < _MAX_DEPTH:
                    sub = graph.resolve_call(node, fcls)
                    if sub is not None and sub[0] not in visited:
                        visited.add(sub[0])
                        (scls, sname), snode = sub
                        squal = f"{scls}.{sname}" if scls else sname
                        walk(snode, scls or fcls, squal,
                             path + (squal,), depth + 1)

        (ecls, ename), enode = resolved
        equal = f"{ecls}.{ename}" if ecls else ename
        visited.add((ecls, ename))
        walk(enode, ecls, equal, (equal,), 0)
    return out
