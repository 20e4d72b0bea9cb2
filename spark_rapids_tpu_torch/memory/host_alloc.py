"""Bounded host allocator — the counterpart of
spark_rapids_tpu/memory/host_alloc.py (the reference's HostAlloc.scala:24:
a pinned pool preferred, a bounded pageable overflow, blocking until
memory frees).

Host staging buffers must not grow without bound just because device
memory is budgeted. The pool has two lanes: a pinned lane
(`torch.empty(..., pin_memory=True)`, page-locked memory the copy engines
read directly) of `pinned_bytes`, and a general lane of pageable memory
for the rest of `limit_bytes`. A request takes the pinned lane first when
it fits there. Allocation blocks (with a timeout) rather than failing at
once; a timeout raises HostOOM, which the caller's retry machinery treats
like a device OOM (memory/retry.py).

Without a card there is no pinned memory: `host_alloc()` then sizes the
pinned lane to 0, and a pool built with a pinned lane raises when it
allocates there.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import torch


class HostOOM(MemoryError):
    pass


class HostAllocation:
    """A tracked host buffer (uint8 tensor); release with close() or a
    `with` block."""

    __slots__ = ("buffer", "nbytes", "pinned", "_pool", "_closed")

    def __init__(self, buffer: torch.Tensor, nbytes: int, pinned: bool,
                 pool: "HostAlloc"):
        self.buffer = buffer
        self.nbytes = nbytes
        self.pinned = pinned
        self._pool = pool
        self._closed = False

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._pool._release(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class HostAlloc:
    """Bounded two-lane host memory pool (reference HostAlloc.scala:24,
    :103-111, the pinned-first policy)."""

    def __init__(self, limit_bytes: int, pinned_bytes: int = 0):
        if not 0 <= pinned_bytes <= limit_bytes:
            raise ValueError(f"pinned_bytes {pinned_bytes} must lie in "
                             f"[0, {limit_bytes}]")
        self.limit_bytes = limit_bytes
        self.pinned_bytes = pinned_bytes
        self._lock = threading.Condition()
        self._used = 0          # general lane
        self._pinned_used = 0   # pinned lane

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used + self._pinned_used

    @property
    def free_bytes(self) -> int:
        return self.limit_bytes - self.used_bytes

    def _try_reserve(self, nbytes: int, prefer_pinned: bool
                     ) -> Optional[bool]:
        """The lane taken (True: pinned), or None if nothing fits now."""
        if prefer_pinned \
                and self._pinned_used + nbytes <= self.pinned_bytes:
            self._pinned_used += nbytes
            return True
        if self._used + nbytes <= self.limit_bytes - self.pinned_bytes:
            self._used += nbytes
            return False
        return None

    def _allocation(self, nbytes: int, pinned: bool) -> HostAllocation:
        try:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)
        except BaseException:
            with self._lock:
                if pinned:
                    self._pinned_used -= nbytes
                else:
                    self._used -= nbytes
                self._lock.notify_all()
            raise
        return HostAllocation(buf, nbytes, pinned, self)

    def try_alloc(self, nbytes: int, prefer_pinned: bool = True
                  ) -> Optional[HostAllocation]:
        """Non-blocking (reference HostAlloc.tryAlloc): None when neither
        lane has room."""
        with self._lock:
            lane = self._try_reserve(nbytes, prefer_pinned)
        if lane is None:
            return None
        return self._allocation(nbytes, lane)

    def alloc(self, nbytes: int, prefer_pinned: bool = True,
              timeout_s: float = 30.0) -> HostAllocation:
        """Blocking: waits for releases; HostOOM after `timeout_s`, or at
        once for a request larger than any lane it may use."""
        general_cap = self.limit_bytes - self.pinned_bytes
        serveable = max(general_cap,
                        self.pinned_bytes if prefer_pinned else 0)
        if nbytes > serveable:
            raise HostOOM(
                f"request {nbytes} exceeds the largest host lane "
                f"({serveable} of {self.limit_bytes} total)")
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while True:
                lane = self._try_reserve(nbytes, prefer_pinned)
                if lane is not None:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._lock.wait(remaining):
                    raise HostOOM(
                        f"host allocation of {nbytes} bytes timed out "
                        f"({self._used + self._pinned_used}/"
                        f"{self.limit_bytes} in use)")
        return self._allocation(nbytes, lane)

    def _release(self, a: HostAllocation) -> None:
        with self._lock:
            if a.pinned:
                self._pinned_used -= a.nbytes
            else:
                self._used -= a.nbytes
            self._lock.notify_all()


_DEFAULT: Optional[HostAlloc] = None
_DEFAULT_LOCK = threading.Lock()


def host_alloc() -> HostAlloc:
    """The process-wide pool: the host spill limit
    (spark.rapids.memory.host.spillStorageSize of the active conf when
    the pool is made), a quarter of it pinned where there is a card."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            from ..config import HOST_SPILL_LIMIT, active_conf
            limit = active_conf().get(HOST_SPILL_LIMIT)
            pinned = limit // 4 if torch.cuda.is_available() else 0
            _DEFAULT = HostAlloc(limit, pinned_bytes=pinned)
        return _DEFAULT
