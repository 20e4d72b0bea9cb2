"""The device mesh — the counterpart of spark_rapids_tpu/parallel/mesh.py
(the reference's GpuDeviceManager.scala:115 device acquisition, grown
into a mesh).

The JAX package's distributed step is one program over a
`jax.sharding.Mesh`, driven by one process. The port keeps that design:
a `Mesh` is an ordered grid of torch devices with named axes, one shard
per entry, and one process drives every shard. A shard's batch lives on
its device; the exchange's all-to-all (parallel/exchange.all_to_all)
copies each shard's blocks to their destination shard's device — a peer
copy between cards, a copy inside one card's memory when shards share it.

A mesh may repeat a device: four shards on `cuda:0` run the four-way
exchange on a machine with one card, as four shards on `"cpu"` do in the
tests (the counterpart of the JAX tests' virtual host devices). Every
device of a mesh has one type: a mesh never mixes the CPU and a card.

`shard_map_compat` is not ported: the port has no shard_map, its mesh
steps are loops over the shards (ROADMAP A, not ported by design).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["DATA_AXIS", "Mesh", "device_mesh", "mesh_axis_size",
           "set_active_mesh", "active_mesh"]

DATA_AXIS = "data"


class Mesh:
    """An n-dimensional grid of torch devices with one name per axis, as
    `jax.sharding.Mesh(np.array(devices), axis_names)`: `devices` is the
    grid (a numpy object array, so `.size`, `.shape` and `.flat` read as
    the JAX mesh's), `shape` maps each axis name to its size."""

    def __init__(self, devices, axis_names: Sequence[str] = (DATA_AXIS,)):
        grid = np.empty(np.shape(np.asarray(devices, dtype=object)),
                        dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[idx] = torch.device(d)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D device grid needs "
                             f"{grid.ndim} axis names, not {axis_names}")
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in grid.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh's devices share one type, not "
                             f"{sorted(kinds)}")
        self.devices = grid
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, grid.shape))

    @property
    def device_type(self) -> str:
        """"cuda" or "cpu": the one type of every device of the mesh."""
        return self.devices.flat[0].type

    @property
    def shard_devices(self) -> Tuple[torch.device, ...]:
        """The devices in shard order (the grid flattened row-major)."""
        return tuple(self.devices.flat)

    def _key(self) -> tuple:
        # two meshes with one key place every shard alike
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, {list(map(str, self.devices.flat))})"


def device_mesh(n_devices: Optional[int] = None,
                axis_name: str = DATA_AXIS, device=None) -> Mesh:
    """1-D mesh of n shards along `axis_name`. On the card (the default
    device) the shards are the first n visible cards (default: all), and
    fewer cards than n raise, as the JAX package asserts; with
    `device="cpu"` the n shards (default 1) all sit on the CPU. A mesh of
    several shards on one card is an explicit device list:
    `Mesh([torch.device("cuda", 0)] * 4)`."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cpu":
        return Mesh([dev] * (n_devices or 1), (axis_name,))
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build a "
                           "mesh of CPU shards")
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if n > have:
        raise RuntimeError(f"need {n} devices, have {have}")
    return Mesh([torch.device("cuda", i) for i in range(n)], (axis_name,))


def mesh_axis_size(mesh: Mesh, axis_name: str = DATA_AXIS) -> int:
    return mesh.shape[axis_name]


# -- the active mesh (the planner's seam) ------------------------------------
# The session installs its mesh here at construction and at each action;
# TpuOverrides reads it to decide whether to plan distributed stages, and
# the host shuffle exchange whether its device lane may run.

_ACTIVE_MESH: Optional[Mesh] = None


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH
