"""Three-tier spill store, DEVICE -> HOST -> DISK — the counterpart of
spark_rapids_tpu/memory/catalog.py (the contract of the reference's
RapidsBufferCatalog and its device, host and disk stores).

The catalog is the one registry; SpillableBatch handles point into it. An
entry holds a batch's tensor leaves (`ColumnarBatch.flatten`) on one tier:
DEVICE holds the CUDA tensors, HOST pinned CPU tensors, DISK a file with a
CRC32 that is checked on read (a mismatch raises SpillFileCorruption).
Spill policy: idle (not in-use) entries, lowest priority first, move one
tier down until the requested bytes are freed; past the host limit, host
entries move on to disk, lowest priority first.

Background writeback (spill.asyncWrite, on by default): a spill queues
the copy of each leaf into pinned memory on the calling thread's stream
and records a CUDA event after it, marks the entry's target tier under
the catalog lock, and hands the rest of the hop to one writer thread. The
writer waits on the event, then finishes the hop; the budget is released
only when the copy has landed. A disk hop goes through the same FIFO, so
it always follows the entry's host hop. A reader (`acquire`) of an entry
whose writeback is still in flight waits for it to land first, so results
are the same with the writer on or off. The writer takes the catalog lock
only to finish a hop.

A failed disk write raises: on the spilling thread in the synchronous
lane, and at the entry's next `acquire` (and at `drain_writeback`) when
the writer failed.

An unspill promotes an entry's host leaves in one packed copy
(`columnar/upload.upload_leaves`), as the reference does: the leaves are
views of one device buffer. A spill to the host already lays the leaves
out packed in one pinned buffer, which the unspill copies as it is; leaves
read back from disk are packed into a pooled staging buffer first, which
returns to its pool when the copy's event completes. Nothing here waits on
the card.

Left out with the modules they belong to (ROADMAP A.9): the workload
quota's owners, fault points, spill events and phase attribution.
"""

from __future__ import annotations

import io
import os
import queue
import struct
import tempfile
import threading
import uuid
import zlib
from enum import IntEnum
from typing import Dict, List, Optional

import numpy as np
import torch

from ..columnar.upload import packed_host_leaves, upload_leaves
from ..config import (HOST_SPILL_LIMIT, SPILL_ASYNC_WRITE, SPILL_DIR,
                      active_conf)


class StorageTier(IntEnum):
    DEVICE = 0
    HOST = 1
    DISK = 2


# reference SpillPriorities.scala
ACTIVE_ON_DECK_PRIORITY = 100
ACTIVE_BATCHING_PRIORITY = 50


class SpillFileCorruption(IOError):
    """Spill file failed its CRC32 / structure check at read."""


class SpillWriteError(IOError):
    """A spill writeback to the host or the disk failed."""


def _nbytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves)


def copy_to_host(leaves):
    """Queue the copy of each leaf into host memory: for CUDA tensors a
    non-blocking copy on the current stream into views of one pinned
    buffer, laid out as the packed upload packs them (so the unspill is
    one copy of that buffer, with no host pack), and a CUDA event recorded
    after the copies; CPU tensors are copied at once (event None). The
    host tensors are valid once the event has completed."""
    if not any(t.is_cuda for t in leaves):
        return [t.clone() for t in leaves], None
    host = packed_host_leaves(leaves, pinned=True)
    for h, t in zip(host, leaves):
        h.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


#: spill file container: magic | u32 crc32 | u64 payload length | npz
_SPILL_MAGIC = b"SRTPUSP1"
_SPILL_HEADER = struct.Struct("<8sIQ")


def write_spill_file(path: str, host_leaves) -> None:
    """CRC32-stamped container, fsync'd before the hop counts."""
    buf = io.BytesIO()
    np.savez(buf, **{str(i): t.numpy() for i, t in enumerate(host_leaves)})
    payload = buf.getvalue()
    crc = zlib.crc32(payload)
    with open(path, "wb") as f:
        f.write(_SPILL_HEADER.pack(_SPILL_MAGIC, crc, len(payload)))
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())


def read_spill_file(path: str) -> List[torch.Tensor]:
    """Verified read: a structural or checksum failure raises
    SpillFileCorruption."""
    with open(path, "rb") as f:
        header = f.read(_SPILL_HEADER.size)
        if len(header) < _SPILL_HEADER.size:
            raise SpillFileCorruption(f"truncated spill header: {path}")
        magic, crc, length = _SPILL_HEADER.unpack(header)
        if magic != _SPILL_MAGIC:
            raise SpillFileCorruption(f"bad spill magic: {path}")
        payload = f.read(length)
    if len(payload) != length or zlib.crc32(payload) != crc:
        raise SpillFileCorruption(f"spill file checksum mismatch: {path}")
    with np.load(io.BytesIO(payload)) as z:
        return [torch.from_numpy(z[str(i)]) for i in range(len(z.files))]


class _Entry:
    __slots__ = ("handle_id", "tier", "batch", "host_leaves", "treedef",
                 "device", "disk_path", "nbytes", "priority", "in_use",
                 "closed", "writeback", "pending", "error")

    def __init__(self, handle_id, batch, priority):
        self.handle_id = handle_id
        self.tier = StorageTier.DEVICE
        self.batch = batch
        self.host_leaves = None
        leaves, self.treedef = batch.flatten()
        self.device = leaves[-1].device
        self.nbytes = _nbytes(leaves)
        self.disk_path = None
        self.priority = priority
        self.in_use = 0
        self.closed = False
        #: event of the in-flight asynchronous tier hop, None when settled
        self.writeback: Optional[threading.Event] = None
        #: (device leaves, host leaves, CUDA event) of a host hop in flight
        self.pending = None
        #: a failed writeback, raised at the next acquire
        self.error: Optional[BaseException] = None


class BufferCatalog:
    """`host_limit`, `spill_dir` and `async_write` default to the active
    conf's host.spillStorageSize, spillDirectory ("": the temporary
    directory) and spill.asyncWrite, read here."""

    def __init__(self, host_limit: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 async_write: Optional[bool] = None):
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.RLock()
        conf = active_conf()
        self.host_limit = conf.get(HOST_SPILL_LIMIT) if host_limit is None \
            else host_limit
        self.async_write = conf.get(SPILL_ASYNC_WRITE) \
            if async_write is None else async_write
        self._spill_dir: Optional[str] = \
            spill_dir or conf.get(SPILL_DIR) or None
        self._own_dir = False
        self._write_q: Optional["queue.Queue"] = None
        self._writer: Optional[threading.Thread] = None
        self._writer_errors: List[BaseException] = []
        #: bytes moved per hop (the reference's spilled_*_bytes) and the
        #: number of hops, for the spill lane's counters
        self.spilled_device_bytes = 0
        self.spilled_host_bytes = 0
        self.stats = {"to_host": 0, "to_disk": 0, "from_disk": 0,
                      "to_device": 0, "unspilled_bytes": 0}
        #: bytes of the entries in use now, and the most the device had to
        #: hold at once that no spill could free: the entries in use plus
        #: the one being added or promoted. A budget below it raises
        #: TpuRetryOOM whatever spills.
        self._pinned_bytes = 0
        self.peak_pinned_bytes = 0

    # -- registration ------------------------------------------------------
    def add(self, batch, priority: int = ACTIVE_BATCHING_PRIORITY) -> str:
        """Register a device batch; returns a handle id. Accounts its
        footprint against the device budget."""
        from .budget import memory_budget
        handle = uuid.uuid4().hex
        entry = _Entry(handle, batch, priority)
        with self._lock:
            self.peak_pinned_bytes = max(self.peak_pinned_bytes,
                                         self._pinned_bytes + entry.nbytes)
        memory_budget().reserve(entry.nbytes)
        with self._lock:
            self._entries[handle] = entry
        return handle

    def acquire(self, handle: str):
        """Return the device batch, promoting it back up the tiers if it
        was spilled, and mark it in use (unspillable) until `release`. An
        entry whose writeback is in flight is waited for outside the lock
        (the writer needs the lock to finish the hop)."""
        while True:
            with self._lock:
                entry = self._entries[handle]
                assert not entry.closed, "acquire after close"
                if entry.error is not None:
                    raise SpillWriteError(
                        f"spill writeback failed: {entry.error}") \
                        from entry.error
                ev = entry.writeback
                if ev is None or ev.is_set():
                    entry.writeback = None
                    if not entry.in_use:
                        self.peak_pinned_bytes = max(
                            self.peak_pinned_bytes,
                            self._pinned_bytes + entry.nbytes)
                    if entry.tier != StorageTier.DEVICE:
                        self._unspill_locked(entry)
                    if not entry.in_use:
                        self._pinned_bytes += entry.nbytes
                    entry.in_use += 1
                    return entry.batch
            if not ev.wait(timeout=1.0):
                self._writer_ok()

    def release(self, handle: str):
        with self._lock:
            entry = self._entries.get(handle)
            if entry is not None and entry.in_use:
                entry.in_use -= 1
                if not entry.in_use:
                    self._pinned_bytes -= entry.nbytes

    def remove(self, handle: str):
        from .budget import memory_budget
        with self._lock:
            entry = self._entries.pop(handle, None)
            if entry is None or entry.closed:
                return
            if entry.in_use:
                self._pinned_bytes -= entry.nbytes
            entry.closed = True  # an in-flight writeback discards its
            # result when it sees this (a just-written file included)
        if entry.tier == StorageTier.DEVICE:
            memory_budget().release(entry.nbytes)
        if entry.disk_path and os.path.exists(entry.disk_path):
            os.unlink(entry.disk_path)

    def tier_of(self, handle: str) -> StorageTier:
        with self._lock:
            return self._entries[handle].tier

    def size_of(self, handle: str) -> int:
        with self._lock:
            return self._entries[handle].nbytes

    # -- spilling ----------------------------------------------------------
    def synchronous_spill(self, target_bytes: Optional[int],
                          events_out: Optional[List[threading.Event]] = None
                          ) -> int:
        """Move idle DEVICE entries to HOST, lowest priority first, until
        target_bytes are freed (None: everything idle), then hold the host
        tier to its limit. Returns the bytes freed from the device. With
        async_write the copies land on the writer thread and this returns
        once they are queued; `events_out` collects each queued host hop's
        completion event."""
        from .budget import memory_budget
        freed = 0
        while target_bytes is None or freed < target_bytes:
            with self._lock:
                candidates = [e for e in self._entries.values()
                              if e.tier == StorageTier.DEVICE and
                              e.in_use == 0 and not e.closed]
                if not candidates:
                    break
                victim = min(candidates, key=lambda e: e.priority)
                self._spill_to_host_locked(victim)
                if self.async_write and events_out is not None:
                    events_out.append(victim.writeback)
                freed += victim.nbytes
            if not self.async_write:
                # asynchronous: the device leaves stay alive in
                # entry.pending until the copy lands; the writer releases
                # the budget then
                memory_budget().release(victim.nbytes)
        self._enforce_host_limit()
        return freed

    def _spill_to_host_locked(self, entry: _Entry):
        leaves, _ = entry.batch.flatten()
        host, ev = copy_to_host(leaves)
        entry.batch = None
        entry.tier = StorageTier.HOST
        if self.async_write:
            entry.pending = (leaves, host, ev)
            entry.writeback = threading.Event()
            self._enqueue_writeback("to_host", entry, None, entry.writeback)
        else:
            if ev is not None:
                ev.synchronize()
            entry.host_leaves = host
        self.spilled_device_bytes += entry.nbytes
        self.stats["to_host"] += 1

    def _enforce_host_limit(self):
        with self._lock:
            host_entries = [e for e in self._entries.values()
                            if e.tier == StorageTier.HOST and not e.closed]
            host_total = sum(e.nbytes for e in host_entries)
            for e in sorted(host_entries, key=lambda x: x.priority):
                if host_total <= self.host_limit:
                    break
                if e.in_use:
                    continue  # being promoted (_unspill_locked)
                self._spill_to_disk_locked(e)
                host_total -= e.nbytes

    def _spill_to_disk_locked(self, entry: _Entry):
        path = os.path.join(self._spill_dir_path(),
                            f"spill-{entry.handle_id}.npz")
        entry.tier = StorageTier.DISK
        in_flight = entry.writeback is not None \
            and not entry.writeback.is_set()
        if self.async_write or in_flight:
            # FIFO on the one writer thread: the entry's host hop, if
            # still in flight, lands before this job runs
            entry.writeback = threading.Event()
            self._enqueue_writeback("to_disk", entry, path, entry.writeback)
        else:
            try:
                write_spill_file(path, entry.host_leaves)
            except BaseException:
                entry.tier = StorageTier.HOST
                try:
                    os.unlink(path)
                except OSError:
                    pass
                raise
            entry.host_leaves = None
            entry.disk_path = path
        self.spilled_host_bytes += entry.nbytes
        self.stats["to_disk"] += 1

    def _unspill_locked(self, entry: _Entry):
        from .budget import memory_budget
        if entry.tier == StorageTier.DISK:
            entry.host_leaves = read_spill_file(entry.disk_path)
            os.unlink(entry.disk_path)
            entry.disk_path = None
            entry.tier = StorageTier.HOST
            self.stats["from_disk"] += 1
        if entry.tier == StorageTier.HOST:
            # the caller holds the catalog lock: no waiting on the writer.
            # The spill pass a reservation under pressure runs must not
            # move this entry back to disk: it counts as in use meanwhile
            # (the JAX package's catalog lacks this guard: there the pass
            # can take the entry's host leaves away mid-promotion)
            entry.in_use += 1
            try:
                memory_budget().reserve(entry.nbytes,
                                        wait_for_writeback=False)
            finally:
                entry.in_use -= 1
            try:
                leaves = upload_leaves(entry.host_leaves, entry.device)
            except BaseException:
                memory_budget().release(entry.nbytes)
                raise
            from ..columnar.batch import ColumnarBatch
            entry.batch = ColumnarBatch.unflatten(entry.treedef, leaves)
            entry.host_leaves = None
            entry.tier = StorageTier.DEVICE
            self.stats["to_device"] += 1
            self.stats["unspilled_bytes"] += entry.nbytes

    def _spill_dir_path(self) -> str:
        if self._spill_dir is None:
            self._spill_dir = tempfile.mkdtemp(prefix="srtpu-spill-")
            self._own_dir = True
        os.makedirs(self._spill_dir, exist_ok=True)
        return self._spill_dir

    # -- background writer -------------------------------------------------
    def _enqueue_writeback(self, kind: str, entry: _Entry,
                           path: Optional[str], ev: threading.Event):
        """Queue one hop (the caller holds the lock; `ev` is this hop's
        completion event). A writer that died is replaced, its stranded
        jobs run here first."""
        if self._writer is not None and not self._writer.is_alive():
            self._recover_dead_writer_locked()
        if self._write_q is None:
            self._write_q = queue.Queue()
            self._writer = threading.Thread(
                target=self._writer_loop, args=(self._write_q,),
                name="spill-writer", daemon=True)
            self._writer.start()
        self._write_q.put((kind, entry, path, ev))

    def _run_job(self, job) -> None:
        kind, entry, path, ev = job
        try:
            self._run_writeback(kind, entry, path)
        except BaseException as e:  # noqa: BLE001 — surfaced at acquire
            with self._lock:
                entry.error = e
                self._writer_errors.append(e)
        finally:
            ev.set()

    def _recover_dead_writer_locked(self):
        q, self._write_q, self._writer = self._write_q, None, None
        while q is not None:
            try:
                job = q.get_nowait()
            except queue.Empty:
                return
            if job is not None:
                self._run_job(job)
            q.task_done()

    def _writer_ok(self):
        with self._lock:
            if self._writer is not None and not self._writer.is_alive():
                self._recover_dead_writer_locked()

    def _writer_loop(self, q: "queue.Queue"):
        while True:
            job = q.get()
            if job is None:
                q.task_done()
                return
            try:
                self._run_job(job)
            finally:
                q.task_done()

    def _run_writeback(self, kind: str, entry: _Entry,
                       path: Optional[str]) -> None:
        """One hop's data movement, outside the catalog lock; only the
        state change takes it."""
        from .budget import memory_budget
        if kind == "to_host":
            with self._lock:
                pending, entry.pending = entry.pending, None
            if pending is None:
                return
            leaves, host, ev = pending
            if ev is not None:
                # a thread that touches CUDA sets its device itself
                torch.cuda.set_device(leaves[-1].device)
                ev.synchronize()
            with self._lock:
                if not entry.closed:
                    entry.host_leaves = host
            # the device leaves drop here, after the copy landed: only
            # now is the memory free
            del leaves
            memory_budget().release(entry.nbytes)
            return
        # to_disk: by the FIFO the host hop has landed
        with self._lock:
            host = entry.host_leaves
            closed = entry.closed
        if closed or host is None:
            return
        try:
            write_spill_file(path, host)
        except BaseException:
            try:
                os.unlink(path)
            except OSError:
                pass
            raise
        with self._lock:
            unlink = entry.closed
            if not unlink:
                entry.host_leaves = None
                entry.disk_path = path
        if unlink:
            try:
                os.unlink(path)
            except OSError:
                pass

    def drain_writeback(self) -> None:
        """Block until every queued writeback has landed; raise the first
        writeback failure not yet raised."""
        self._writer_ok()
        with self._lock:
            q = self._write_q
        if q is not None:
            q.join()
        with self._lock:
            errors, self._writer_errors = self._writer_errors, []
        if errors:
            raise SpillWriteError(f"spill writeback failed: {errors[0]}") \
                from errors[0]

    def shutdown_writer(self) -> None:
        """Stop the writer after draining it (test isolation)."""
        self._writer_ok()
        with self._lock:
            q, writer = self._write_q, self._writer
            self._write_q = None
            self._writer = None
        if q is not None:
            q.join()
            q.put(None)
            writer.join()
        if self._own_dir:
            try:
                os.rmdir(self._spill_dir)
            except OSError:
                pass

    # -- introspection -------------------------------------------------------
    def device_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values()
                       if e.tier == StorageTier.DEVICE and not e.closed)

    def num_entries(self) -> int:
        with self._lock:
            return len(self._entries)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.stats,
                        spilled_device_bytes=self.spilled_device_bytes,
                        spilled_host_bytes=self.spilled_host_bytes)


_catalog: Optional[BufferCatalog] = None
_catalog_lock = threading.Lock()


def buffer_catalog() -> BufferCatalog:
    global _catalog
    with _catalog_lock:
        if _catalog is None:
            _catalog = BufferCatalog()
        return _catalog


def reset_buffer_catalog(host_limit: Optional[int] = None,
                         spill_dir: Optional[str] = None,
                         async_write: Optional[bool] = None
                         ) -> BufferCatalog:
    """Install a fresh catalog (the old one's writer drains and stops)."""
    global _catalog
    with _catalog_lock:
        old, _catalog = _catalog, BufferCatalog(host_limit, spill_dir,
                                                async_write)
    if old is not None:
        old.shutdown_writer()
    return _catalog
