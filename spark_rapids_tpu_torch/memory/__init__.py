"""Memory and OOM-retry runtime — the counterpart of
spark_rapids_tpu/memory/: the device budget, the three-tier spill
catalog, spillable batches, the retry/split discipline with its injection
API, the admission semaphore, the device manager and the bounded host
allocator.
"""

from .budget import MemoryBudget, memory_budget, reset_memory_budget
from .catalog import (
    ACTIVE_BATCHING_PRIORITY, ACTIVE_ON_DECK_PRIORITY, BufferCatalog,
    SpillFileCorruption, SpillWriteError, StorageTier, buffer_catalog,
    reset_buffer_catalog,
)
from .retry import (
    CpuRetryOOM, TpuOOMError, TpuRetryOOM, TpuSplitAndRetryOOM,
    current_task_id, force_retry_oom, force_split_and_retry_oom,
    is_oom_error, oom_guard, register_task, split_in_half_by_rows,
    task_retry_counts, unregister_task, with_retry, with_retry_no_split,
)
from .device_manager import DeviceManager, device_manager
from .host_alloc import HostAlloc, HostAllocation, HostOOM, host_alloc
from .semaphore import (SemaphoreTimeout, TpuSemaphore, reset_tpu_semaphore,
                        tpu_semaphore)
from .spillable import SpillableBatch

__all__ = [
    "MemoryBudget", "memory_budget", "reset_memory_budget",
    "ACTIVE_BATCHING_PRIORITY", "ACTIVE_ON_DECK_PRIORITY", "BufferCatalog",
    "SpillFileCorruption", "SpillWriteError", "StorageTier",
    "buffer_catalog", "reset_buffer_catalog", "CpuRetryOOM", "TpuOOMError",
    "TpuRetryOOM", "TpuSplitAndRetryOOM", "current_task_id",
    "force_retry_oom", "force_split_and_retry_oom", "is_oom_error",
    "oom_guard", "register_task", "split_in_half_by_rows",
    "task_retry_counts", "unregister_task", "with_retry",
    "with_retry_no_split", "SpillableBatch", "DeviceManager",
    "device_manager", "HostAlloc", "HostAllocation", "HostOOM", "host_alloc",
    "SemaphoreTimeout", "TpuSemaphore", "reset_tpu_semaphore",
    "tpu_semaphore",
]
