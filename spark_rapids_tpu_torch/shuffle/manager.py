"""Host shuffle manager, MULTITHREADED mode — the counterpart of
spark_rapids_tpu/shuffle/manager.py (the reference's
RapidsShuffleInternalManagerBase.scala:238 threaded writers and :569
threaded readers over Spark's file-based sort shuffle).

Disk layout follows Spark's sort-shuffle contract: one data file and one
index per map task. Partition blocks serialize and LZ4-compress in
parallel on the writer pool (the codec's ctypes calls release the GIL),
then are written in partition order; the index records the partitions'
byte ranges. A reader fetches a partition's segment of every map output
on the reader pool, in map order, and decodes its frames there.

Both files of a map output are written under temporary names and renamed
into place, data first, index last; only then is the output registered
with its handle, so a reader never sees a partial shard. `unregister`
removes the files.

The pool sizes are spark.rapids.shuffle.multiThreaded.{writer,reader}.threads
and the root directory a fresh directory under `root`, else under
spark.rapids.memory.spillDirectory, else under the temporary directory;
each is read, from the conf the exchange captured at its construction,
when the pool or the directory is made (first use), as the JAX package
reads them. A writer or reader is built on the exchange's thread, never
on a pool thread.
A reader's segment fetch runs under the bounded IO retry
(io/retrying.py) with the `shuffle.fetch` fault point inside each
attempt, keyed by map file and partition; each frame's decode is the
`shuffle.decode` fault point, keyed by partition and frame ordinal. A
corrupt frame is quarantined — an `integrity_fail` event — and raises
faults.IntegrityError, so the task-retry lane recomputes the query.
The pool's work items run with the submitting thread's query id.
Left out with their planes (ROADMAP A.9b): partition-granular recovery
from captured lineage (`_refresh_invalidated`, `_recover_block`, the
dead-peer bookkeeping `bind_peer_output`/`invalidate_peer_outputs`), the
adaptive map groups (`plan_map_groups`, `read_partition_maps`) and the
speculative sub-reads.
"""

from __future__ import annotations

import os
import struct
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import faults
from ..columnar.batch import ColumnarBatch
from ..config import (IO_RETRIES, IO_RETRY_BACKOFF_MS,
                      SHUFFLE_READER_THREADS, SHUFFLE_WRITER_THREADS,
                      SPILL_DIR, RapidsConf, active_conf)
from ..types import Schema
from .serializer import (CODEC_LZ4, CorruptFrameError, deserialize_batch,
                         host_gather_batch,
                         host_slice_batch, serialize_batch_stats,
                         serialize_slice_stats)

__all__ = ["HostShuffleHandle", "HostShuffleWriter", "HostShuffleReader",
           "HostShuffleManager", "shuffle_manager", "reset_shuffle_manager",
           "partition_batch_host", "counters"]

_COUNTER_LOCK = threading.Lock()
#: process-cumulative shuffle counters: map batches written per lane,
#: frames and bytes written (file bytes, and the frames' raw payload),
#: frames and bytes read, and the time of each step (compress and decode
#: summed over the pool threads)
_COUNTERS = {"batches": 0, "device_batches": 0, "host_batches": 0,
             "frames": 0, "bytes": 0, "raw_bytes": 0, "pack_ns": 0,
             "serialize_ns": 0, "compress_ns": 0, "io_ns": 0,
             "frames_read": 0, "bytes_read": 0, "fetch_ns": 0,
             "decode_ns": 0}


def note_shuffle(**deltas) -> None:
    with _COUNTER_LOCK:
        for k, v in deltas.items():
            _COUNTERS[k] += v


def counters() -> Dict[str, int]:
    with _COUNTER_LOCK:
        return dict(_COUNTERS)


class HostShuffleHandle:
    """Registration record (Spark's ShuffleHandle analog)."""

    def __init__(self, shuffle_id: int, n_partitions: int, schema: Schema):
        self.shuffle_id = shuffle_id
        self.n_partitions = n_partitions
        self.schema = schema
        self.map_outputs: List[str] = []  # data file per completed map task


class HostShuffleWriter:
    """Writes one map task's partitioned blocks (reference
    RapidsShuffleThreadedWriterBase)."""

    def __init__(self, handle: HostShuffleHandle, map_id: int,
                 manager: "HostShuffleManager", codec: int = CODEC_LZ4,
                 conf: Optional[RapidsConf] = None):
        conf = conf or active_conf()
        self.handle = handle
        self.map_id = map_id
        self.manager = manager
        self.codec = codec
        self._pool = manager.writer_pool(conf)
        manager.root_dir(conf)
        self.bytes_written = 0
        self.frames_written = 0
        self.raw_bytes = 0
        self.serialize_ns = 0
        self.compress_ns = 0
        self.io_ns = 0
        #: per-partition written bytes (the index's offset differences)
        self.partition_bytes: List[int] = []

    def write(self, partitioned: Sequence[List[ColumnarBatch]]) -> None:
        """partitioned[p] = the host batches of partition p. Each batch
        serializes on the writer pool; the file is written in partition
        order, so the index stays a flat range table."""
        n = self.handle.n_partitions
        if len(partitioned) != n:
            raise ValueError(f"{len(partitioned)} partitions, not {n}")
        t0 = time.perf_counter_ns()
        jobs = [(p, self._pool.submit(serialize_batch_stats, b,
                                      self.codec))
                for p in range(n) for b in partitioned[p]]
        self._collect(jobs, t0, lane="host")

    def write_slices(self, packed: ColumnarBatch, bounds) -> None:
        """Write one map task from a partition-ordered host batch:
        `bounds[p]..bounds[p+1]` is partition p's row range, and each
        non-empty partition serializes straight from its slice on the
        writer pool (no gather). One frame per non-empty partition, as
        write() makes."""
        n = self.handle.n_partitions
        if len(bounds) != n + 1:
            raise ValueError(f"{len(bounds)} bounds, not {n + 1}")
        t0 = time.perf_counter_ns()
        jobs = [(p, self._pool.submit(serialize_slice_stats, packed,
                                      int(bounds[p]), int(bounds[p + 1]),
                                      self.codec))
                for p in range(n) if bounds[p + 1] > bounds[p]]
        self._collect(jobs, t0, lane="device")

    def _collect(self, jobs, t0: int, lane: str) -> None:
        """Wait for the serialize jobs ((partition, future) pairs, started
        at `t0`), then commit their frames."""
        frames_by_part: List[List[bytes]] = [
            [] for _ in range(self.handle.n_partitions)]
        for p, fut in jobs:
            frame, raw, cns = fut.result()
            frames_by_part[p].append(frame)
            self.raw_bytes += raw
            self.compress_ns += cns
        self.serialize_ns = time.perf_counter_ns() - t0
        self._commit(frames_by_part, lane)

    def _commit(self, frames_by_part: Sequence[List[bytes]],
                lane: str) -> None:
        """Write the frames in partition order under temporary names,
        rename data then index into place, then register the output."""
        n = self.handle.n_partitions
        data_path = self.manager.map_data_path(self.handle.shuffle_id,
                                               self.map_id)
        tag = f".{os.getpid()}.{threading.get_ident()}.tmp"
        tmp_data, tmp_index = data_path + tag, data_path + ".index" + tag
        offsets = [0] * (n + 1)
        t0 = time.perf_counter_ns()
        try:
            with open(tmp_data, "wb") as f:
                pos = 0
                for p in range(n):
                    for frame in frames_by_part[p]:
                        f.write(struct.pack("<Q", len(frame)))
                        f.write(frame)
                        pos += 8 + len(frame)
                    offsets[p + 1] = pos
            with open(tmp_index, "wb") as f:
                f.write(struct.pack(f"<{n + 1}Q", *offsets))
            os.replace(tmp_data, data_path)
            os.replace(tmp_index, data_path + ".index")
        except BaseException:
            for t in (tmp_data, tmp_index, data_path, data_path + ".index"):
                try:
                    os.unlink(t)
                except OSError:
                    pass
            raise
        self.io_ns = time.perf_counter_ns() - t0
        self.bytes_written = offsets[n]
        self.partition_bytes = [offsets[p + 1] - offsets[p]
                                for p in range(n)]
        self.frames_written = sum(len(fs) for fs in frames_by_part)
        note_shuffle(batches=1, frames=self.frames_written,
                     bytes=self.bytes_written, raw_bytes=self.raw_bytes,
                     serialize_ns=self.serialize_ns,
                     compress_ns=self.compress_ns, io_ns=self.io_ns,
                     **({"device_batches": 1} if lane == "device"
                        else {"host_batches": 1}))
        self.handle.map_outputs.append(data_path)


class HostShuffleReader:
    """Reads one partition across all map outputs (reference
    RapidsShuffleThreadedReaderBase)."""

    def __init__(self, handle: HostShuffleHandle,
                 manager: "HostShuffleManager",
                 conf: Optional[RapidsConf] = None):
        conf = conf or active_conf()
        self.handle = handle
        self.manager = manager
        self._pool = manager.reader_pool(conf)
        #: the IO retry settings, read here (the fetches run on the pool)
        self._retries = conf.get(IO_RETRIES)
        self._backoff_ms = conf.get(IO_RETRY_BACKOFF_MS)
        #: one parse of each map output's index table
        self._index_cache: Dict[str, Tuple[int, ...]] = {}
        self._index_lock = threading.Lock()

    def _index(self, data_path: str) -> Tuple[int, ...]:
        with self._index_lock:
            cached = self._index_cache.get(data_path)
        if cached is None:
            n = self.handle.n_partitions
            with open(data_path + ".index", "rb") as f:
                cached = struct.unpack(f"<{n + 1}Q", f.read(8 * (n + 1)))
            with self._index_lock:
                self._index_cache[data_path] = cached
        return cached

    def _fetch_segment(self, data_path: str, partition: int) -> List[bytes]:
        """One partition's frames from one map output, under the bounded
        IO retry (the index read too: a flaky mount fails its open as
        readily)."""
        from ..io.retrying import with_io_retry
        t0 = time.perf_counter_ns()

        def fetch() -> List[bytes]:
            offsets = self._index(data_path)
            lo, hi = offsets[partition], offsets[partition + 1]
            frames: List[bytes] = []
            if hi > lo:
                with open(data_path, "rb") as f:
                    f.seek(lo)
                    seg = f.read(hi - lo)
                if len(seg) != hi - lo:
                    raise OSError(f"short read of {data_path}: {len(seg)} "
                                  f"of {hi - lo} bytes")
                p = 0
                while p < len(seg):
                    (ln,) = struct.unpack_from("<Q", seg, p)
                    frames.append(seg[p + 8: p + 8 + ln])
                    p += 8 + ln
            return frames

        frames = with_io_retry(
            fetch, "shuffle.fetch", self._retries, self._backoff_ms,
            salt=f"{os.path.basename(data_path)}:{partition}",
            fault_point="shuffle.fetch")
        note_shuffle(fetch_ns=time.perf_counter_ns() - t0,
                     bytes_read=sum(8 + len(f) for f in frames))
        return frames

    def _decode(self, frame: bytes, key: str = "") -> ColumnarBatch:
        """Checksum-verified decode into a host-backed batch: the device
        promotion happens at the exchange's read seam, not on this pool
        thread. A corrupt block is quarantined and raises IntegrityError
        (the query recomputes)."""
        t0 = time.perf_counter_ns()
        frame = faults.apply("shuffle.decode", frame, key=key or None)
        try:
            batch = deserialize_batch(frame, self.handle.schema)
        except CorruptFrameError as e:
            from ..obs import events as obs_events
            obs_events.emit("integrity_fail", what="shuffle_block",
                            shuffle_id=self.handle.shuffle_id,
                            bytes=len(frame), error=str(e)[:200])
            raise faults.IntegrityError(
                f"corrupt shuffle block (shuffle {self.handle.shuffle_id}):"
                f" {e}") from e
        note_shuffle(frames_read=1, decode_ns=time.perf_counter_ns() - t0)
        return batch

    def read_partition(self, partition: int) -> Iterator[ColumnarBatch]:
        """Partition `partition`'s blocks, in map order: the segments are
        fetched and the frames decoded on the reader pool, and yielded in
        order. Closing the iterator cancels the decodes not yet started."""
        from ..obs import events as obs_events
        qid = obs_events.current_query_id()
        paths = list(self.handle.map_outputs)
        segs = list(self._pool.map(
            lambda path: obs_events.with_query_id(
                qid, self._fetch_segment, path, partition), paths))
        # the decode key: partition and the frame's ordinal in map order,
        # so a verdict follows the frame, not the pool's scheduling
        futs = [self._pool.submit(obs_events.with_query_id, qid,
                                  self._decode, fr, f"p{partition}:{i}")
                for i, fr in enumerate(fr for frames in segs
                                       for fr in frames)]
        del segs
        try:
            for fut in futs:
                yield fut.result()
        finally:
            for fut in futs:
                fut.cancel()


class HostShuffleManager:
    """Registry and block file manager (Spark's ShuffleManager SPI and
    RapidsDiskBlockManager)."""

    def __init__(self, root: Optional[str] = None):
        self._lock = threading.Lock()
        self._next_id = 0
        self._handles: Dict[int, HostShuffleHandle] = {}
        self._base = root
        self._root: Optional[str] = None
        self._writer_pool: Optional[ThreadPoolExecutor] = None
        self._reader_pool: Optional[ThreadPoolExecutor] = None

    # -- dirs & pools ------------------------------------------------------
    def root_dir(self, conf: Optional[RapidsConf] = None) -> str:
        """The directory of this manager's map outputs, made at first
        use (under `root`, else the spill directory of `conf`, else the
        temporary directory)."""
        with self._lock:
            if self._root is None:
                base = self._base or (conf or active_conf()).get(SPILL_DIR)
                self._root = tempfile.mkdtemp(
                    prefix="tpu-shuffle-",
                    dir=base or tempfile.gettempdir())
            return self._root

    def map_data_path(self, shuffle_id: int, map_id: int) -> str:
        return os.path.join(self.root_dir(),
                            f"shuffle_{shuffle_id}_{map_id}.data")

    def writer_pool(self, conf: RapidsConf) -> ThreadPoolExecutor:
        with self._lock:
            if self._writer_pool is None:
                self._writer_pool = ThreadPoolExecutor(
                    max_workers=max(1, conf.get(SHUFFLE_WRITER_THREADS)),
                    thread_name_prefix="shuffle-writer")
            return self._writer_pool

    def reader_pool(self, conf: RapidsConf) -> ThreadPoolExecutor:
        with self._lock:
            if self._reader_pool is None:
                self._reader_pool = ThreadPoolExecutor(
                    max_workers=max(1, conf.get(SHUFFLE_READER_THREADS)),
                    thread_name_prefix="shuffle-reader")
            return self._reader_pool

    # -- lifecycle ---------------------------------------------------------
    def register(self, n_partitions: int, schema: Schema
                 ) -> HostShuffleHandle:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            h = HostShuffleHandle(sid, n_partitions, schema)
            self._handles[sid] = h
            return h

    def unregister(self, handle: HostShuffleHandle) -> None:
        """Forget the shuffle and remove its map outputs' files."""
        with self._lock:
            self._handles.pop(handle.shuffle_id, None)
        for path in handle.map_outputs:
            for p in (path, path + ".index"):
                try:
                    os.unlink(p)
                except FileNotFoundError:
                    pass
        handle.map_outputs.clear()

    def registered(self) -> int:
        """Shuffles registered and not yet unregistered."""
        with self._lock:
            return len(self._handles)

    def close(self) -> None:
        """Stop the pools and remove the root directory, which must be
        empty (every shuffle unregistered)."""
        with self._lock:
            pools = (self._writer_pool, self._reader_pool)
            self._writer_pool = self._reader_pool = None
            root, self._root = self._root, None
        for pool in pools:
            if pool is not None:
                pool.shutdown(wait=True)
        if root is not None:
            os.rmdir(root)


_MANAGER: Optional[HostShuffleManager] = None
_MANAGER_LOCK = threading.Lock()


def shuffle_manager() -> HostShuffleManager:
    """The process's shuffle manager."""
    global _MANAGER
    with _MANAGER_LOCK:
        if _MANAGER is None:
            _MANAGER = HostShuffleManager()
        return _MANAGER


def reset_shuffle_manager(root: Optional[str] = None) -> HostShuffleManager:
    """Close the process's manager (if any) and start a new one."""
    global _MANAGER
    with _MANAGER_LOCK:
        old, _MANAGER = _MANAGER, HostShuffleManager(root)
    if old is not None:
        old.close()
    return _MANAGER


def partition_batch_host(batch: ColumnarBatch, pid: np.ndarray,
                         n_partitions: int) -> List[ColumnarBatch]:
    """Split a host batch into per-partition compact host batches by the
    per-row partition id; rows keep their order within a partition. One
    stable argsort by pid and one gather, then each partition is a row
    range of the gathered batch (host_slice_batch)."""
    order = np.argsort(pid, kind="stable")
    sorted_pid = pid[order]
    bounds = np.searchsorted(sorted_pid, np.arange(n_partitions + 1))
    packed = host_gather_batch(batch, order[: bounds[n_partitions]])
    return [host_slice_batch(packed, int(bounds[p]), int(bounds[p + 1]))
            for p in range(n_partitions)]
