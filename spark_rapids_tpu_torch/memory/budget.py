"""Device memory budget — the counterpart of
spark_rapids_tpu/memory/budget.py (the RMM-pool analog, reference
GpuDeviceManager.initializeRmm + DeviceMemoryEventHandler).

PyTorch's caching allocator owns the card's memory; this layer does
accounting. Batches registered with the spill catalog reserve their bytes
here. When a reservation would pass the limit, idle catalog entries spill
(lowest priority first) until it fits, else TpuRetryOOM is raised for the
retry framework. A spill frees budget, not allocator blocks: the caching
allocator keeps freed blocks reserved for reuse, so
`torch.cuda.memory_reserved` never shows a spill.

The private memory pools of the compiled stages' CUDA graphs
(obs/dispatch.ProgramSite) reserve their bytes here when captured and
release them when dropped; on pressure, after the catalog's spill, the
graphs no run holds are dropped, least recently used first.

Per-query quota: under the workload governor (exec/workload.py), a
query past its soft share of the budget that hits the pressure path
spills its OWN catalog entries (a quota_spill event) and raises its own
TpuRetryOOM when that is not enough: it never pushes a neighbour's
working set down a tier. The quota is consulted on the pressure path
only, so a lone or ungoverned query pays nothing.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from ..config import HBM_BUDGET_BYTES, HBM_POOL_FRACTION, active_conf
from .retry import TpuRetryOOM

#: device memory assumed when no card is present (the budget then only
#: accounts CPU tensors, as in the tests); the reference's TPU default
_DEFAULT_DEVICE_BYTES = 16 << 30


class MemoryBudget:
    """`limit_bytes` defaults to spark.rapids.memory.tpu.budgetBytes of
    the active conf, else its allocFraction of the card's memory."""

    def __init__(self, limit_bytes: Optional[int] = None):
        if limit_bytes is None:
            conf = active_conf()
            limit_bytes = conf.get(HBM_BUDGET_BYTES) or int(
                _detect_hbm() * conf.get(HBM_POOL_FRACTION))
        self.limit = limit_bytes
        self.used = 0
        self._lock = threading.Lock()
        self.peak = 0

    def _try_take(self, nbytes: int) -> bool:
        with self._lock:
            if self.used + nbytes <= self.limit:
                self.used += nbytes
                self.peak = max(self.peak, self.used)
                return True
            return False

    def reserve(self, nbytes: int, wait_for_writeback: bool = True):
        """Reserve accounting space; spill-then-raise on pressure.

        `wait_for_writeback=False` is required when the caller holds the
        catalog lock (an unspill): waiting on the writer, which needs that
        lock to finish a hop, would deadlock. Pressure then surfaces as
        TpuRetryOOM and the retry loop waits the writebacks out."""
        if self._try_take(nbytes):
            return
        from ..exec import workload
        from .catalog import buffer_catalog
        with self._lock:
            needed = nbytes - (self.limit - self.used)
        hops: list = []
        ticket = workload.current_ticket()
        quota = workload.quota_bytes(self.limit) \
            if ticket is not None else None
        over_quota = quota is not None \
            and ticket.device_bytes + nbytes > quota
        if over_quota:
            # the offender spills the offender: only this query's entries
            freed = buffer_catalog().synchronous_spill(
                needed, events_out=hops, owner=ticket)
            workload.note_quota_spill(ticket, nbytes, quota, freed)
        else:
            freed = buffer_catalog().synchronous_spill(needed,
                                                       events_out=hops)
        if self._try_take(nbytes):
            return
        # the pools of CUDA graphs no stage run holds (obs/dispatch.py)
        # count against the budget too: drop them, least recently used
        # first (a later step of their stage captures again)
        from ..obs.dispatch import drop_cached_graphs
        with self._lock:
            short = nbytes - (self.limit - self.used)
        if drop_cached_graphs(short, budget=self) \
                and self._try_take(nbytes):
            return
        # an asynchronous spill frees the budget only when each copy to
        # the host lands: wait the hops this spill queued, then the rest
        # (an over-quota query does not wait out its neighbours' hops to
        # take the bytes they freed: its retry lane settles instead)
        if wait_for_writeback:
            for ev in hops:
                ev.wait()
            if self._try_take(nbytes):
                return
            if not over_quota:
                buffer_catalog().drain_writeback()
                if self._try_take(nbytes):
                    return
        raise TpuRetryOOM(
            f"device budget exhausted: need {nbytes}, used {self.used} of "
            f"{self.limit} (freed {freed} by spill)")

    def release(self, nbytes: int):
        with self._lock:
            self.used = max(0, self.used - nbytes)


def _detect_hbm() -> int:
    """The card's memory (the reference reads the TPU's bytes_limit)."""
    if torch.cuda.is_available():
        dev = torch.cuda.current_device()
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return _DEFAULT_DEVICE_BYTES


_budget: Optional[MemoryBudget] = None
_budget_lock = threading.Lock()


def memory_budget() -> MemoryBudget:
    global _budget
    with _budget_lock:
        if _budget is None:
            _budget = MemoryBudget()
        return _budget


def reset_memory_budget(limit_bytes: Optional[int] = None) -> MemoryBudget:
    """Install a fresh (possibly tiny) budget — the analog of the
    reference's 512 MiB test RMM pool."""
    global _budget
    with _budget_lock:
        _budget = MemoryBudget(limit_bytes)
    return _budget


def spill_for_retry():
    """Between OOM retries, push every idle device entry down a tier and
    wait for the writebacks to land (no catalog lock is held between
    attempts, so this is the one safe place to wait the writer out)."""
    from ..exec import workload
    from .catalog import buffer_catalog
    cat = buffer_catalog()
    hops: list = []
    ticket = workload.current_ticket()
    if ticket is not None:
        # while this query is over its quota share, only its own entries
        # spill and only its own hops are waited
        quota = workload.quota_bytes(memory_budget().limit)
        if quota is not None and ticket.device_bytes > quota:
            cat.synchronous_spill(None, events_out=hops, owner=ticket)
            for ev in hops:
                ev.wait()
            return
    cat.synchronous_spill(None, events_out=hops)
    for ev in hops:
        ev.wait()
    cat.drain_writeback()
