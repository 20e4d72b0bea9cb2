"""Hash partitioning of the exchanges — the counterpart of
spark_rapids_tpu/parallel/exchange.py, as far as the host shuffle needs
it: Spark's HashPartitioning pid, pmod(murmur3(keys, 42), n).

The keys hash through ops/hashing.murmur3_batch: fixed-width keys in one
launch of the murmur3 chain kernel on the card (a null key leaves the
running hash unchanged, -0.0 and NaN are normalised inside it), string
keys in plain torch over their byte spans. The pid is the JAX package's
bit for bit, so a key lands in the same partition on both sides of a
shuffled join.

The mesh lane waits for ROADMAP A.6: `negotiate_slot_cap`,
`partition_slots` and `exchange_columns` (an NCCL all_to_all through
torch.distributed).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..columnar.column import Column
from ..ops.basic import active_mask
from ..ops.hashing import murmur3_batch, pmod

__all__ = ["SHUFFLE_SEED", "partition_ids"]

#: hash seed of shuffle partitioning (Spark's HashPartitioning uses 42)
SHUFFLE_SEED = 42


def partition_ids(key_cols: Sequence[Column], num_rows, capacity: int,
                  n_parts: int) -> torch.Tensor:
    """Spark HashPartitioning: pmod(murmur3(keys, 42), n) as int32.
    Inactive rows get n_parts, so they land in no partition."""
    h = murmur3_batch(list(key_cols), seed=SHUFFLE_SEED)
    pid = pmod(h, n_parts)
    act = active_mask(num_rows, capacity, pid.device)
    return torch.where(act, pid, n_parts).to(torch.int32)
