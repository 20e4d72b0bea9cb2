"""Memory and OOM-retry runtime — the counterpart of
spark_rapids_tpu/memory/: the device budget, the three-tier spill
catalog, spillable batches and the retry/split discipline with its
injection API.

Not ported yet: `semaphore.py`, `device_manager.py` and `host_alloc.py`
(ROADMAP A.5, with the source scan and the packed upload that use them).
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
    "with_retry_no_split", "SpillableBatch",
]
