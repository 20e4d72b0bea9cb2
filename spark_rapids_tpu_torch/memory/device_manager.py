"""Device manager — executor start-up, the counterpart of
spark_rapids_tpu/memory/device_manager.py (reference GpuDeviceManager.scala
:115 setGpuDeviceAndAcquire, :150 initializeGpuAndMemory).

`initialize()` picks the card (`cuda:<ordinal>`, or the CPU when the caller
asks for it, as the tests do), sizes the device memory budget against what
`torch.cuda.mem_get_info` reports, and resets the admission semaphore.
With `mesh_axes` ({axis name: size}, the data axis) it also builds the
device mesh of the collective shuffle on the manager's device
(parallel/mesh.device_mesh). The JAX package's branch imports a
`build_mesh` its parallel/mesh.py does not define, so it raises there
(ROADMAP C.5); the port builds the mesh that branch meant.
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
        #: the mesh built from `mesh_axes`, None without
        self.mesh = None
        self._lock = threading.Lock()

    def initialize(self, device_ordinal: int = 0,
                   mesh_axes: Optional[dict] = None, device=None
                   ) -> "DeviceManager":
        """Executor init (reference Plugin.scala:484): pick the card, size
        the budget, arm the semaphore, and build the mesh `mesh_axes`
        names ({"data": n}: n shards on the manager's device type, the
        first n cards on the card). `device="cpu"` runs on the CPU with
        the budget's default size."""
        if mesh_axes:
            from ..parallel.mesh import DATA_AXIS
            unknown = set(mesh_axes) - {DATA_AXIS}
            if unknown:
                raise ValueError(f"mesh axes {sorted(unknown)}: the mesh "
                                 f"has the one axis {DATA_AXIS!r}")
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
            if mesh_axes:
                from ..parallel.mesh import DATA_AXIS, device_mesh
                self.mesh = device_mesh(
                    mesh_axes[DATA_AXIS], device=self.device
                    if self.device.type == "cpu" else None)
            self.initialized = True
            return self

    def shutdown(self) -> None:
        with self._lock:
            self.initialized = False
            self.device = None
            self.mesh = None


_manager: Optional[DeviceManager] = None
_mgr_lock = threading.Lock()


def device_manager() -> DeviceManager:
    global _manager
    with _mgr_lock:
        if _manager is None:
            _manager = DeviceManager()
        return _manager
