"""Multi-process bootstrap and the (dcn, ici) mesh — the counterpart of
spark_rapids_tpu/parallel/multihost.py (the reference's executor-side
distributed init in Plugin.scala, and the split between the fast
peer-to-peer plane and the always-works host plane).

`initialize_distributed()` brings up torch.distributed from the JAX
package's environment names (COORDINATOR_ADDRESS, NUM_PROCESSES,
PROCESS_ID) or arguments: `nccl` for the card, `gloo` for the CPU. It is
idempotent and a no-op for a single process, so the same engine code
runs everywhere. A mesh step itself is driven by one process over its
shards (parallel/mesh.py); the processes of a multi-host run each drive
their own host's devices.

`build_query_mesh(devices)` is the 2-D ("dcn", "data") grid: the inner
axis spans each host's devices (the all-to-all exchange rides it), the
outer axis spans hosts. Exchange planning keys on the inner axis's size,
so a shuffle never crosses hosts implicitly: that movement goes through
the host shuffle (shuffle/manager.py).
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence, Tuple

log = logging.getLogger("spark_rapids_tpu_torch.multihost")

DCN_AXIS = "dcn"
ICI_AXIS = "data"  # the name the single-host mesh uses (mesh.DATA_AXIS)

_initialized = False


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> bool:
    """torch.distributed.init_process_group from the arguments or the
    environment. Returns True when a multi-process group is up, False for
    a single process (both are valid engine states). `coordinator` is
    host:port (or a tcp:// URL); `device` "cpu" picks gloo, else nccl
    when a card is visible. Idempotent."""
    global _initialized
    import torch
    import torch.distributed as dist
    if _initialized or (dist.is_available() and dist.is_initialized()):
        _initialized = True
        return True
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    num_processes = num_processes or _int_env("NUM_PROCESSES")
    process_id = process_id if process_id is not None \
        else _int_env("PROCESS_ID")
    if coordinator is None or (num_processes or 1) <= 1:
        return False  # a single process (no coordinator configured)
    if process_id is None:
        raise ValueError("a multi-process run needs PROCESS_ID")
    cpu = device is not None and torch.device(device).type == "cpu"
    backend = "gloo" if cpu or not torch.cuda.is_available() else "nccl"
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))
    _initialized = True
    log.info("distributed runtime up: process %s of %s via %s (%s)",
             process_id, num_processes, coordinator, backend)
    return True


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def group_devices_by_host(devices: Sequence) -> List[List]:
    """Stable grouping by process index (each process is one host); a
    device without one belongs to process 0."""
    hosts: dict = {}
    for d in devices:
        hosts.setdefault(getattr(d, "process_index", 0), []).append(d)
    return [hosts[k] for k in sorted(hosts)]


def topology_shape(devices: Sequence) -> Tuple[int, int]:
    """(hosts, devices per host); raises on a ragged topology (a host
    down mid-allocation: fail fast, task retry is the recovery model)."""
    groups = group_devices_by_host(devices)
    per_host = {len(g) for g in groups}
    if len(per_host) != 1:
        raise RuntimeError(
            f"ragged device topology: {sorted(len(g) for g in groups)} "
            "devices per host — refusing to build a mesh")
    return len(groups), per_host.pop()


def build_query_mesh(devices: Optional[Sequence] = None):
    """The ("dcn", "data") mesh: the inner axis a host's devices, the outer
    axis the hosts. One host gives (1, n). Default: every visible card."""
    from .mesh import Mesh, device_mesh
    devices = list(devices) if devices is not None \
        else list(device_mesh().shard_devices)
    n_hosts, per_host = topology_shape(devices)
    return Mesh([list(g) for g in group_devices_by_host(devices)],
                (DCN_AXIS, ICI_AXIS))


def ici_axis_size(mesh) -> int:
    return mesh.shape[ICI_AXIS]


def dcn_axis_size(mesh) -> int:
    return mesh.shape.get(DCN_AXIS, 1)
