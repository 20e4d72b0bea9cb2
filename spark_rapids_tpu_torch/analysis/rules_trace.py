"""Trace-purity rules, retargeted at the port's idiom — the counterpart
of spark_rapids_tpu/analysis/rules_trace.py.

``trace-module-tensor`` (in place of the JAX package's
``trace-module-jnp``): a module-level ``torch.<factory>(...)`` binding in
the package builds a tensor when the module is first imported. Its
device is whatever the import picked, never the caller's explicit one
(the port's entry points take an explicit device, and the tests import
every module on a machine with no card); on a card the import also
creates the CUDA context. Constants belong as Python ints or numpy
scalars, turned into tensors on the caller's device where they are
used; bare attribute references (``torch.int64``, ``torch.float64``) and
non-tensor calls (``torch.iinfo``, ``torch.device``) are fine and not
flagged.

``trace-host-sync``: a host read (``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``synchronize()``, or a registry-declared
host copy such as ``upload_leaves``) inside a body handed to the
program-site chokepoint (``obs.dispatch.instrument`` /
``TpuExec._site``) for capture. On the card such a body becomes a CUDA
graph: a host read there either fails the capture or reads the value
once, at the capture, and never again on a replay — the static twin of
the stage compiler's runtime trap (a graphed body reads nothing on the
host). A body handed with ``graph=False`` runs eagerly by declaration
and is exempt; the walk covers the body and module-local calls one hop
down.
"""

from __future__ import annotations

import ast
from typing import List, Set, Tuple

from .callgraph import ModuleGraph, attr_root, unparse
from .core import Finding, ModuleInfo
from .registry import HOST_SYNC_ATTRS, HOST_SYNC_NAMES, TENSOR_FACTORIES
from .rules_stage import handed_bodies


def _tensor_call(call: ast.Call, aliases) -> bool:
    func = call.func
    return isinstance(func, ast.Attribute) and \
        attr_root(func) in aliases and func.attr in TENSOR_FACTORIES


def check_module_tensor(module: ModuleInfo, graph: ModuleGraph, reg):
    if reg.scope_prefix not in module.path:
        return []  # scripts: module scope IS their main
    aliases = set(graph.torch_aliases)
    if not aliases:
        return []
    out = []
    for stmt in module.tree.body:
        if not isinstance(stmt, (ast.Assign, ast.AnnAssign,
                                 ast.AugAssign)):
            continue
        value = stmt.value
        if value is None:
            continue
        for call in ast.walk(value):
            if isinstance(call, ast.Call) and _tensor_call(call, aliases):
                target = stmt.targets[0] if isinstance(
                    stmt, ast.Assign) else stmt.target
                out.append(Finding(
                    "trace-module-tensor", module.path, stmt.lineno,
                    "<module>", unparse(target),
                    f"module-level `{unparse(call)[:60]}` builds a tensor "
                    "at import time — on whatever device the import "
                    "picked, not the caller's (and a CUDA context on a "
                    "card); keep a Python int / numpy scalar and build "
                    "the tensor on the caller's device"))
                break  # one finding per binding
    return out


def _eager_by_declaration(call) -> bool:
    """The chokepoint call says `graph=False`: the body runs eagerly."""
    if call is None:
        return False
    for kw in call.keywords:
        if kw.arg == "graph" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return True
    return False


def _host_reads(fn: ast.AST, reg) -> List[Tuple[int, str]]:
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in HOST_SYNC_ATTRS:
            out.append((node.lineno, f.attr))
        else:
            name = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else None)
            if name in HOST_SYNC_NAMES or \
                    name in reg.extra_blocking_calls:
                out.append((node.lineno, name))
    return out


def check_host_sync(module: ModuleInfo, graph: ModuleGraph, reg):
    if reg.scope_prefix not in module.path:
        return []
    out = []
    seen: Set[Tuple[int, int, str]] = set()
    for body, cls, site_line, call in handed_bodies(module, graph):
        if _eager_by_declaration(call):
            continue
        reads = list(_host_reads(body, reg))
        for sub in ast.walk(body):
            if not isinstance(sub, ast.Call):
                continue
            hit = graph.resolve_call(sub, cls)
            if hit is not None and hit[1] is not body:
                reads.extend(_host_reads(hit[1], reg))
        name = getattr(body, "name", "<lambda>")
        for line, what in reads:
            key = (id(body), line, what)
            if key in seen:
                continue
            seen.add(key)
            out.append(Finding(
                "trace-host-sync", module.path, line, name, what,
                f"host read `{what}` inside the body handed for capture "
                f"at line {site_line} — a CUDA graph reads it once, at "
                "the capture, never on a replay; read at the stage "
                "boundary, or hand the body with graph=False and its "
                "cause"))
    return out
