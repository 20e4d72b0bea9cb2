"""Columnar in-memory table cache — the counterpart of spark_rapids_tpu/
exec/cache.py (reference ParquetCachedBatchSerializer and
GpuInMemoryTableScanExec): a cached DataFrame materializes ONCE into
compressed host frames, the shuffle's LZ4 wire format
(shuffle/serializer.py), and every scan of it rebuilds device batches
from them, one packed upload a frame (columnar/upload.py).

Host-resident by design: device memory stays free for the running query,
and a scan costs one decompress and one upload a batch. `materializations`
counts the runs of the cached plan.
"""

from __future__ import annotations

import threading
from typing import Iterator, List, Optional

from ..columnar.batch import ColumnarBatch
from ..types import Schema


class CachedRelation:
    """A materialize-once scan source (a LogicalScan's source like any
    other); `device` is where its scans put their batches."""

    def __init__(self, child_exec_factory, schema: Schema, device=None):
        self._factory = child_exec_factory
        self.schema = schema
        self.device = device
        self._lock = threading.Lock()
        self._frames: Optional[List[bytes]] = None
        self.compressed_bytes = 0
        self.raw_bytes = 0
        self.materializations = 0

    @property
    def is_materialized(self) -> bool:
        return self._frames is not None

    def _materialize(self) -> None:
        from ..shuffle.serializer import serialize_batch
        frames: List[bytes] = []
        raw = 0
        for b in self._factory().execute():
            frames.append(serialize_batch(b))
            raw += b.nbytes
        self._frames = frames
        self.compressed_bytes = sum(map(len, frames))
        self.raw_bytes = raw
        self.materializations += 1

    def ensure_materialized(self) -> None:
        """A scan calls this BEFORE it takes its admission permit: the
        materialization drives a plan whose own scan takes a permit, and
        nesting them would deadlock a one-permit semaphore."""
        with self._lock:
            if self._frames is None:
                self._materialize()

    def batches(self) -> Iterator[ColumnarBatch]:
        from ..columnar.upload import promote_batch
        from ..shuffle.serializer import deserialize_batch
        self.ensure_materialized()
        with self._lock:
            frames = self._frames  # a snapshot: unpersist may run meanwhile
        for fr in frames:
            yield promote_batch(deserialize_batch(fr, self.schema),
                                self.device)

    def estimated_size_bytes(self) -> int:
        if self._frames is not None:
            return self.compressed_bytes
        return 1 << 62  # unknown until materialized: never broadcast

    def unpersist(self) -> None:
        with self._lock:
            self._frames = None
            self.compressed_bytes = 0
            self.raw_bytes = 0
