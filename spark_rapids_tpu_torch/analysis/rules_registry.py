"""Registry-drift rules — the counterpart of
spark_rapids_tpu/analysis/rules_registry.py, reading the PORT's
registries.

``conf-key-registered``: every full ``spark.rapids.*`` string literal
must resolve in the port's config registry (dynamic prefixes exempt) —
an unregistered key is a typo or a missing ConfEntry.

``event-kind-registered``: every ``emit("<literal kind>", ...)`` must
be in the port's obs.events.EVENT_LEVELS — an unregistered kind silently
defaults to MODERATE and never reaches the schema table.

Both lazily import their registries (config.py and obs/events.py are
stdlib-only).
"""

from __future__ import annotations

import ast

from .callgraph import ModuleGraph, unparse
from .core import Finding, ModuleInfo
from .scan import conf_key_literals


def _conf_registry():
    from ..config import RapidsConf, _REGISTRY
    return _REGISTRY, RapidsConf._DYNAMIC_PREFIXES


def check_conf_keys(module: ModuleInfo, graph: ModuleGraph, reg):
    out = []
    registry = prefixes = None
    for key, lineno in conf_key_literals(module.tree):
        if registry is None:
            registry, prefixes = _conf_registry()
        if key in registry or key.startswith(prefixes):
            continue
        out.append(Finding(
            "conf-key-registered", module.path, lineno, "<module>", key,
            f"conf key {key!r} is not in the config registry — add a "
            "ConfEntry or fix the typo"))
    return out


def check_event_kinds(module: ModuleInfo, graph: ModuleGraph, reg):
    if module.path.endswith("obs/events.py"):
        return []  # the registry module itself emits via variables
    out = []
    levels = None
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        func = node.func
        name = func.id if isinstance(func, ast.Name) else (
            func.attr if isinstance(func, ast.Attribute) else None)
        if name != "emit":
            continue
        arg = node.args[0]
        if not (isinstance(arg, ast.Constant) and
                isinstance(arg.value, str)):
            continue
        if levels is None:
            from ..obs.events import EVENT_LEVELS
            levels = EVENT_LEVELS
        if arg.value not in levels:
            out.append(Finding(
                "event-kind-registered", module.path, node.lineno,
                "<module>", arg.value,
                f"event kind {arg.value!r} is not registered in "
                "obs.events.EVENT_LEVELS — it would silently default "
                "to MODERATE and miss the schema table"))
    return out
