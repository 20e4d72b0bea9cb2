"""Dispatch-ledger rule, retargeted at the port's kernel launches — the
counterpart of spark_rapids_tpu/analysis/rules_dispatch.py.

``dispatch-ledger`` flags two things.

* **A kernel launch outside the ledger.** A launch is a wrapper's
  counter bump (``<wrapper>.launches += n``), a call of a launch entry
  point (``<lib>.<name>_run(...)``) of a library that kernels/build.py
  loaded (``csrc_library(...)``, ``build.load(...)``, or a ``lib``
  parameter handed one), or a call of a ``launcher``/``*_launcher``,
  which hands out an uncounted launch for timing. Every launch must run
  inside a ``with kernel_site(...) as site:`` block whose body calls
  ``site.count()`` — lexically, or through module-local calls made from
  that block (the wrapper's one hop down to its launch helper, as
  ``fused_scan_agg`` reaches ``_partials_cuda``). The ledger's calls
  equal the launches only through that chokepoint: a launch outside it
  is invisible to the dispatch ledger, the phase ledger and the hang
  bound. The chokepoint module (obs/dispatch.py) owns the one sanctioned
  bump: a graph replay adds back its recorded sites' launches.
* **A CUDA graph outside the chokepoint.** ``torch.cuda.CUDAGraph`` and
  ``torch.cuda.graph`` belong to obs/dispatch.ProgramSite alone, where a
  capture takes back the launches its body counted and each replay adds
  them again.

Accepted suppressions by construction: a timing script's launchers,
outside the ledger so that the launches it compares count nothing.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .callgraph import ModuleGraph, attr_root, unparse
from .core import Finding, ModuleInfo

#: the calls whose value is a library kernels/build.py loaded
_LOADERS = frozenset({"csrc_library", "load"})
#: the transitive depth of module-local calls followed from a site block
_MAX_DEPTH = 4


def _call_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _lib_names(fn: ast.AST) -> Set[str]:
    """Names that hold a loaded library inside `fn`: assigned from a loader
    call, or a parameter called `lib`."""
    names = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call) and \
                _call_name(node.value.func) in _LOADERS:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        elif isinstance(node, ast.arg) and node.arg == "lib":
            names.add("lib")
    return names


def _launches(scope: ast.AST, libs: Set[str]) -> List[ast.AST]:
    """The launch nodes lexically inside `scope`."""
    out = []
    for node in ast.walk(scope):
        if isinstance(node, ast.AugAssign) and \
                isinstance(node.target, ast.Attribute) and \
                node.target.attr == "launches":
            out.append(node)
        elif isinstance(node, ast.Call):
            f = node.func
            name = _call_name(f)
            if name is None:
                continue
            if name == "launcher" or name.endswith("_launcher"):
                out.append(node)
            elif isinstance(f, ast.Attribute) and name.endswith("_run") \
                    and not name.startswith("_"):
                recv = f.value
                if (isinstance(recv, ast.Name) and recv.id in libs) or (
                        isinstance(recv, ast.Call)
                        and _call_name(recv.func) in _LOADERS):
                    out.append(node)
    return out


def _site_blocks(fn: ast.AST) -> List[ast.With]:
    """`with kernel_site(...) as site:` blocks whose body calls
    `site.count()`."""
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        for item in node.items:
            ctx = item.context_expr
            if not (isinstance(ctx, ast.Call)
                    and _call_name(ctx.func) == "kernel_site"
                    and isinstance(item.optional_vars, ast.Name)):
                continue
            frame = item.optional_vars.id
            counted = any(
                isinstance(c, ast.Call)
                and isinstance(c.func, ast.Attribute)
                and c.func.attr == "count"
                and isinstance(c.func.value, ast.Name)
                and c.func.value.id == frame
                for b in node.body for c in ast.walk(b))
            if counted:
                out.append(node)
    return out


def _covered(module: ModuleInfo, graph: ModuleGraph) -> Set[int]:
    """ids of the launch nodes a counted kernel site reaches."""
    covered: Set[int] = set()
    visited: Set[int] = set()

    def reach(node: ast.AST, fn: ast.AST, cls, depth: int) -> None:
        covered.update(id(n) for n in _launches(node, _lib_names(fn)))
        if depth >= _MAX_DEPTH:
            return
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            hit = graph.resolve_call(call, cls)
            if hit is None or id(hit[1]) in visited:
                continue
            visited.add(id(hit[1]))
            (tcls, _), tnode = hit
            reach(tnode, tnode, tcls or cls, depth + 1)

    for _qual, cls, fnode in graph.scopes():
        for block in _site_blocks(fnode):
            for stmt in block.body:
                reach(stmt, fnode, cls, 0)
    return covered


def _graph_refs(module: ModuleInfo) -> List[ast.Attribute]:
    out = []
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Attribute) and \
                node.attr in ("CUDAGraph", "graph") and \
                isinstance(node.value, ast.Attribute) and \
                node.value.attr == "cuda" and \
                attr_root(node) is not None:
            out.append(node)
    return out


def check(module: ModuleInfo, graph: ModuleGraph, reg):
    if module.path.endswith("obs/dispatch.py"):
        return []  # THE chokepoint: the replay's bump, the graphs
    out = []
    covered = _covered(module, graph)
    # the enclosing top-level scope of each launch, for the finding
    owner: Dict[int, str] = {}
    for qual, _cls, fnode in graph.scopes():
        for node in ast.walk(fnode):
            owner.setdefault(id(node), qual)
    for node in _launches(module.tree, _lib_names(module.tree)):
        if id(node) in covered:
            continue
        what = unparse(node.target if isinstance(node, ast.AugAssign)
                       else node.func)
        key = f"{what} +=" if isinstance(node, ast.AugAssign) else what
        out.append(Finding(
            "dispatch-ledger", module.path, node.lineno,
            owner.get(id(node), "<module>"), key,
            f"kernel launch `{key}` outside a counted kernel site — run "
            "it inside `with kernel_site(...) as site:` with "
            "`site.count()` (directly or through a module-local call) so "
            "the ledger's calls equal the launches, or suppress with the "
            "why"))
    for node in _graph_refs(module):
        out.append(Finding(
            "dispatch-ledger", module.path, node.lineno,
            owner.get(id(node), "<module>"), unparse(node),
            f"`{unparse(node)}` outside obs/dispatch.py — CUDA graphs "
            "belong to ProgramSite, where a capture takes back its "
            "body's launches and a replay adds them again"))
    return out
