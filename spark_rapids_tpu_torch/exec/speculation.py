"""Plan-level speculative execution scope — the counterpart of
spark_rapids_tpu/exec/speculation.py.

The masked-bucket aggregate (ops/maskedagg.py, ops/fused_scan_agg.py)
emits small partials plus a device `leftover` flag instead of paying for
an exact fallback on every batch. Inside a speculation scope the flag is
never read per batch (a device-to-host sync costs more than the kernel);
it is recorded as a device scalar and checked once when results are
materialized.

The exact tier is not ported yet, so a tripped flag cannot re-run the plan
exactly: the code that materializes results (TpuExec.collect, the
tests, chip_smoke.py) raises instead of returning the incomplete result.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import List, Optional

import torch


class SpeculationScope:
    def __init__(self):
        self.flags: List[torch.Tensor] = []  # device bool scalars

    def record(self, flag: torch.Tensor) -> None:
        self.flags.append(flag)

    def drain(self) -> List[torch.Tensor]:
        out, self.flags = self.flags, []
        return out

    def tripped(self) -> bool:
        """ONE host sync over all recorded flags."""
        if not self.flags:
            return False
        flags = self.drain()
        return bool(torch.stack([f.reshape(()) for f in flags]).any())


class _State(threading.local):
    def __init__(self):
        self.scope: Optional[SpeculationScope] = None
        self.forced_exact = False


_state = _State()


def current_scope() -> Optional[SpeculationScope]:
    return _state.scope


def speculation_allowed() -> bool:
    return _state.scope is not None and not _state.forced_exact


@contextmanager
def speculation_scope():
    prev = _state.scope
    scope = SpeculationScope()
    _state.scope = scope
    try:
        yield scope
    finally:
        _state.scope = prev


@contextmanager
def force_exact():
    prev = _state.forced_exact
    _state.forced_exact = True
    try:
        yield
    finally:
        _state.forced_exact = prev
