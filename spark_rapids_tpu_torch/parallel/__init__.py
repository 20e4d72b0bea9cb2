"""Distributed execution over a device mesh — the counterpart of
spark_rapids_tpu/parallel/ (the reference's layer L5: the shuffle
transport and data parallelism). One process drives every shard of a
`mesh.Mesh`; the all-to-all (`exchange.all_to_all`) copies each shard's
blocks onto its destination shard's device. `multihost` keeps the process
bootstrap (torch.distributed) and the (dcn, ici) grid; `heartbeat` the
peers' liveness."""

from .mesh import device_mesh, mesh_axis_size  # noqa: F401
