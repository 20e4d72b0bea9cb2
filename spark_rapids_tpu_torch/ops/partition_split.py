"""The shuffle's partition split on the device — the counterpart of
spark_rapids_tpu/ops/partition_split.py: given each row's partition id,
the per-partition count table and a permutation stable in the pid, so
the whole batch lands in partition order in ONE reorder (the reference's
GpuHashPartitioning pid kernel and `contiguous_split`).

  1. `partition_table`: the counts (a bincount) and a stable sort of the
     rows by pid, inactive rows last; the count table is the only value
     the host reads.
  2. `reorder_columns`: the partition-major reorder through the gather
     engine (ops/gather.gather_batch_columns), so two or more
     fixed-width columns ride ONE packed row gather, the `dma_row_gather`
     kernel on the card; a string column takes the per-column path.

The exchange then fetches the reordered batch and the count table in one
device->host copy (columnar/transfer.fetch_split_host), and each
partition serializes straight from its row range
(shuffle/serializer.serialize_slice).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .basic import active_mask

__all__ = ["partition_table", "reorder_columns"]


def partition_table(pid: torch.Tensor, num_rows, capacity: int,
                    n_partitions: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-partition counts and a pid-stable permutation.

    `pid` is the per-row partition id (any integer dtype; values >=
    n_partitions and rows >= num_rows count as inactive, values below 0
    clip to 0, as in the JAX package). Returns
    (counts (n_partitions,) int32, order (capacity,) int32): `order`
    lists source rows in partition-major order, the input order kept
    within a partition, inactive rows last."""
    act = active_mask(num_rows, capacity, pid.device)
    key = torch.where(act, pid.to(torch.int64),
                      n_partitions).clamp(0, n_partitions)
    counts = torch.bincount(key, minlength=n_partitions + 1)
    _, order = torch.sort(key, stable=True)
    return (counts[:n_partitions].to(torch.int32),
            order.to(torch.int32))


def reorder_columns(columns: Sequence, order: torch.Tensor, num_rows
                    ) -> List:
    """The partition-major reorder of a batch's columns by the
    `partition_table` permutation, through the gather engine (one packed
    row gather for the fixed-width columns). Output slots >= num_rows
    are invalid."""
    from .gather import gather_batch_columns
    return gather_batch_columns(columns, order, num_rows=num_rows)
