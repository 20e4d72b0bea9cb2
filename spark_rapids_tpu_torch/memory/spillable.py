"""SpillableBatch — the counterpart of spark_rapids_tpu/memory/spillable.py
(reference SpillableColumnarBatch): a handle that lets operator state
spill while it is not in use. Operators hold these between steps instead
of device batches, so the catalog can take their memory under pressure.
Any ColumnarBatch registers, StringColumn and DictionaryColumn leaves
included."""

from __future__ import annotations

from ..columnar.batch import ColumnarBatch
from .catalog import ACTIVE_BATCHING_PRIORITY, buffer_catalog


class SpillableBatch:
    def __init__(self, handle: str, num_rows):
        self._handle = handle
        self._num_rows = num_rows  # host int or device scalar (lazy)
        self._closed = False

    @staticmethod
    def from_batch(batch: ColumnarBatch,
                   priority: int = ACTIVE_BATCHING_PRIORITY,
                   origin=None) -> "SpillableBatch":
        handle = buffer_catalog().add(batch, priority, origin)
        # the row count stays lazy: only split paths need it on the host
        rows = batch._host_rows if batch._host_rows is not None \
            else batch.num_rows
        return SpillableBatch(handle, rows)

    @property
    def num_rows(self) -> int:
        if not isinstance(self._num_rows, int):
            self._num_rows = int(self._num_rows)
        return self._num_rows

    def size_bytes(self) -> int:
        return buffer_catalog().size_of(self._handle)

    def get_batch(self) -> ColumnarBatch:
        """Bring the batch to the device and pin it (unspillable) until
        `release()` / `close()`."""
        assert not self._closed, "use after close"
        return buffer_catalog().acquire(self._handle)

    def release(self):
        buffer_catalog().release(self._handle)

    def close(self):
        if not self._closed:
            self._closed = True
            buffer_catalog().remove(self._handle)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
