"""Device manager — executor start-up, the counterpart of
spark_rapids_tpu/memory/device_manager.py (reference GpuDeviceManager.scala
:115 setGpuDeviceAndAcquire, :150 initializeGpuAndMemory).

`initialize()` picks the card (`cuda:<ordinal>`, or the CPU when the caller
asks for it, as the tests do), sizes the device memory budget against what
`torch.cuda.mem_get_info` reports, and resets the admission semaphore. The
JAX package can also build a device mesh here for its collective shuffle;
that waits for the port's exchange (ROADMAP A.6).
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from ..config import HBM_BUDGET_BYTES, HBM_POOL_FRACTION, active_conf
from .budget import reset_memory_budget
from .semaphore import reset_tpu_semaphore


class DeviceManager:
    def __init__(self):
        self.initialized = False
        self.device: Optional[torch.device] = None
        self._lock = threading.Lock()

    def initialize(self, device_ordinal: int = 0,
                   mesh_axes: Optional[dict] = None, device=None
                   ) -> "DeviceManager":
        """Executor init (reference Plugin.scala:484): pick the card, size
        the budget, arm the semaphore. `device="cpu"` runs on the CPU with
        the budget's default size."""
        if mesh_axes:
            raise NotImplementedError(
                "a device mesh waits for the exchange (ROADMAP A.6)")
        with self._lock:
            if self.initialized:
                return self
            if device is not None and torch.device(device).type == "cpu":
                self.device = torch.device("cpu")
                reset_memory_budget()
            else:
                if not torch.cuda.is_available():
                    raise RuntimeError("no CUDA device: pass device='cpu' "
                                       "to run the port on the CPU")
                ordinal = min(device_ordinal, torch.cuda.device_count() - 1)
                self.device = torch.device("cuda", ordinal)
                torch.cuda.set_device(self.device)
                free, total = torch.cuda.mem_get_info(self.device)
                conf = active_conf()
                reset_memory_budget(conf.get(HBM_BUDGET_BYTES) or int(
                    min(free, total * conf.get(HBM_POOL_FRACTION))))
            reset_tpu_semaphore()
            self.initialized = True
            return self

    def shutdown(self) -> None:
        with self._lock:
            self.initialized = False
            self.device = None


_manager: Optional[DeviceManager] = None
_mgr_lock = threading.Lock()


def device_manager() -> DeviceManager:
    global _manager
    with _mgr_lock:
        if _manager is None:
            _manager = DeviceManager()
        return _manager
