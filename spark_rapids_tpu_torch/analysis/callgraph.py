"""Per-module call-graph resolution shared by the contract rules — the
counterpart of spark_rapids_tpu/analysis/callgraph.py.

The rules are deliberately MODULE-level: a walk
follows calls to functions and methods defined in the same file —
`self.foo()`, bare `foo()`, nested defs — which is exactly where the
engine's lock-hold regions and producer-thread entry points live.
Cross-module effects (e.g. `upload_leaves` doing a host->device copy) are
declared data in the registry instead of being chased interprocedurally.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Tuple

FuncKey = Tuple[Optional[str], str]  # (class name or None, function name)


def unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 — diagnostics only
        return "<expr>"


class ModuleGraph:
    """Index of every function/method in one module plus call
    resolution. Nested defs are indexed by bare name as a fallback so
    `pool.submit(worker, ...)` can resolve a closure target."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.functions: Dict[FuncKey, ast.FunctionDef] = {}
        self.by_name: Dict[str, ast.FunctionDef] = {}
        self.torch_aliases = _torch_aliases(tree)
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[(None, node.name)] = node
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self.functions[(node.name, sub.name)] = sub
        # bare-name fallback index (includes nested defs)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.by_name.setdefault(node.name, node)

    def resolve_call(self, call: ast.Call, current_class: Optional[str]
                     ) -> Optional[Tuple[FuncKey, ast.FunctionDef]]:
        """Resolve a call to a module-local target, or None."""
        func = call.func
        if isinstance(func, ast.Name):
            return self.resolve_name(func.id, current_class)
        if isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name) and \
                func.value.id in ("self", "cls") and current_class:
            key = (current_class, func.attr)
            if key in self.functions:
                return key, self.functions[key]
        return None

    def resolve_name(self, name: str, current_class: Optional[str]
                     ) -> Optional[Tuple[FuncKey, ast.FunctionDef]]:
        if (None, name) in self.functions:
            return (None, name), self.functions[(None, name)]
        if current_class and (current_class, name) in self.functions:
            return (current_class, name), self.functions[(current_class,
                                                          name)]
        fn = self.by_name.get(name)
        if fn is not None:
            return (current_class, name), fn
        return None

    def scopes(self) -> Iterator[Tuple[str, Optional[str],
                                       ast.FunctionDef]]:
        """(qualname, class name, node) for every indexed function."""
        for (cls, name), node in self.functions.items():
            qual = f"{cls}.{name}" if cls else name
            yield qual, cls, node


def qualname(key: FuncKey) -> str:
    cls, name = key
    return f"{cls}.{name}" if cls else name


def _torch_aliases(tree: ast.Module) -> List[str]:
    """Names `torch` is imported under at this module's top level
    (usually ['torch']) — the module-scope tensor rule matches against
    these. A function-local import cannot run at import time."""
    aliases = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch":
                    aliases.append(a.asname or "torch")
    return aliases


def iter_calls(node: ast.AST) -> Iterator[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            yield sub


def attr_root(node: ast.AST) -> Optional[str]:
    """The leftmost Name of an attribute chain (`torch.cuda.foo` ->
    'torch')."""
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None
