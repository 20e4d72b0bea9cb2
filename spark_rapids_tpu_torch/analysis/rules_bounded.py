"""Bounded-wait rule (lock-discipline family) — the counterpart of
spark_rapids_tpu/analysis/rules_bounded.py.

Every blocking rendezvous in the engine must carry a timeout: the
straggler shield can only mitigate stalls it can OBSERVE, and a bare
`Event.wait()` / `Condition.wait()` / `Queue.get()` / `future.result()`
parks its thread beyond the reach of every watchdog, deadline and
cancellation poll the engine has (the cooperative-cancel contract polls
BETWEEN bounded waits). The rule flags attribute calls
named ``wait`` / ``get`` / ``result`` / ``sleep`` that are provably
unbounded: zero positional arguments AND no ``timeout=`` keyword.

That predicate is deliberately shaped so the common non-blocking forms
pass without receiver modeling:

* ``d.get(key)`` / ``conf.get(KEY)`` — positional args (a zero-arg
  ``dict.get()`` is a TypeError, so a zero-arg ``.get()`` can only be a
  queue-like receiver);
* ``ev.wait(5)`` / ``fut.result(timeout=bound)`` — bounded;
* ``time.sleep(x)`` — the duration IS positional (a zero-arg sleep is
  a TypeError; the name stays in the family so a suppression naming it
  reads naturally).

A call through ``*args`` / ``**kwargs`` is skipped — the bound may ride
the splat, and an unprovable site must not force a suppression. Sites
that are unbounded BY DESIGN (a worker parked on its feed queue, a
result future whose producer owns the deadline) carry the standard
justified ``# contract: ok bounded-wait — <why>`` suppression or a
baseline entry.
"""

from __future__ import annotations

import ast
from typing import List

from .callgraph import ModuleGraph, unparse
from .core import Finding, ModuleInfo

#: the blocking-rendezvous method family (registry.BLOCKING_ATTRS is
#: wider — it also holds IO like fsync; this rule is about WAITS)
WAIT_ATTRS = frozenset({"wait", "get", "result", "sleep"})


def _unbounded(call: ast.Call) -> bool:
    """Provably no timeout: zero positionals, no `timeout=` kwarg, and
    no splat that could carry either."""
    if call.args:
        return False
    for kw in call.keywords:
        if kw.arg is None or kw.arg == "timeout":
            return False
    return True


def check(module: ModuleInfo, graph: ModuleGraph, reg) -> List[Finding]:
    if reg.scope_prefix not in module.path:
        return []
    out: List[Finding] = []
    for qual, _cls, fnode in graph.scopes():
        for node in ast.walk(fnode):
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Attribute):
                continue
            attr = node.func.attr
            if attr not in WAIT_ATTRS or not _unbounded(node):
                continue
            recv = unparse(node.func.value)
            out.append(Finding(
                "bounded-wait", module.path, node.lineno, qual,
                f"{recv}.{attr}",
                f"unbounded `{recv}.{attr}()` — no timeout: the thread "
                "parks beyond every watchdog/cancellation poll; pass "
                "timeout= (poll-loop if needed) or suppress with the "
                "why"))
    return out
