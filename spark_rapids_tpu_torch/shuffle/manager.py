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
`shuffle.decode` fault point, keyed by partition and the frame's global
ordinal in map order. A corrupt frame is quarantined — an
`integrity_fail` event — and raises faults.IntegrityError. The pool's
work items run with the submitting thread's query id.

Partition-granular recovery: the exchange captures a lineage for each
map output (`handle.lineage`: data path -> a zero-argument recompute that
re-runs only the exchange's child and rewrites that one output in place,
`register=False`). A corrupt block recomputes its map output once
(`_recover_block`: one `partition_recompute` event, then a re-fetch and
re-decode under a fresh fault key); with no lineage, with
`task.partitionRecovery.enabled` off, on a second corruption of one
output or a corrupt rewrite, the IntegrityError escalates to the
task-retry lane with its provenance. A dead peer's outputs
(`invalidate_peer_outputs`) recompute before the next read trusts them
(`_refresh_invalidated`).

The adaptive read plan (exec/exchange.py) reads a skewed partition as
map-granular sub-reads: `plan_map_groups` groups the map outputs under a
byte target from the index tables alone, and `read_partition_maps` reads
one group, its decode keys numbered on from the previous group's (a
shared `ordinal`), so a seeded `shuffle.decode` fault draws the same
verdicts split or not. Each sub-read frame is the `shuffle.skew_split`
fault point, keyed shuffle_id:partition:sub.

With `shuffle.speculation.enabled` a reader races one duplicate of a
fetch or decode that runs past its straggler bound
(exec/speculation_shield.ReadSpeculation), under `spec:` keys.
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
           "partition_batch_host", "counters", "note_ici_exchange",
           "ici_counters"]

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


#: process-cumulative counters of the host exchange's device lane
#: (exec/exchange.py): collective rounds and map batches exchanged shard
#: to shard, the bytes received, the rounds' wall ns on the host, the
#: measure's host reads, and exchanges that stood down or degraded to the
#: host serialize lane
_ICI_COUNTERS = {"rounds": 0, "batches": 0, "bytes": 0,
                 "collective_ns": 0, "host_reads": 0, "fallbacks": 0}


def note_ici_exchange(**deltas) -> None:
    with _COUNTER_LOCK:
        for k, v in deltas.items():
            _ICI_COUNTERS[k] += v


def ici_counters() -> Dict[str, int]:
    """The device lane's counters. counters()'s frames and bytes stay
    flat while this lane carries the data."""
    with _COUNTER_LOCK:
        return dict(_ICI_COUNTERS)


class HostShuffleHandle:
    """Registration record (Spark's ShuffleHandle analog)."""

    def __init__(self, shuffle_id: int, n_partitions: int, schema: Schema):
        self.shuffle_id = shuffle_id
        self.n_partitions = n_partitions
        self.schema = schema
        self.map_outputs: List[str] = []  # data file per completed map task
        #: data path -> zero-argument recompute of that map output (the
        #: exchange's lineage capture); empty when recovery is off
        self.lineage: Dict[str, object] = {}
        #: map outputs recomputed once: a second corruption escalates
        self.recovered: set = set()
        #: map outputs a dead peer held: the next read recomputes them
        self.invalidated: set = set()
        #: serializes recomputes: concurrent partition streams that meet
        #: one damaged output recompute it once
        self.recover_lock = threading.Lock()


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

    def write(self, partitioned: Sequence[List[ColumnarBatch]],
              register: bool = True) -> None:
        """partitioned[p] = the host batches of partition p. Each batch
        serializes on the writer pool; the file is written in partition
        order, so the index stays a flat range table. `register=False`
        rewrites an output already registered (a recovery)."""
        n = self.handle.n_partitions
        if len(partitioned) != n:
            raise ValueError(f"{len(partitioned)} partitions, not {n}")
        t0 = time.perf_counter_ns()
        # contract: ok thread-adopt — serialize_batch_stats is a pure
        # function of its batch and codec: no conf/event/attempt reads on
        # the pool thread (fault keys ride the frame ordinals at decode)
        jobs = [(p, self._pool.submit(serialize_batch_stats, b,
                                      self.codec))
                for p in range(n) for b in partitioned[p]]
        self._collect(jobs, t0, "host", register)

    def write_slices(self, packed: ColumnarBatch, bounds,
                     register: bool = True) -> None:
        """Write one map task from a partition-ordered host batch:
        `bounds[p]..bounds[p+1]` is partition p's row range, and each
        non-empty partition serializes straight from its slice on the
        writer pool (no gather). One frame per non-empty partition, as
        write() makes."""
        n = self.handle.n_partitions
        if len(bounds) != n + 1:
            raise ValueError(f"{len(bounds)} bounds, not {n + 1}")
        t0 = time.perf_counter_ns()
        # contract: ok thread-adopt — serialize_slice_stats is a pure
        # function of (packed batch, row range, codec): no thread-local
        # reads on the pool
        jobs = [(p, self._pool.submit(serialize_slice_stats, packed,
                                      int(bounds[p]), int(bounds[p + 1]),
                                      self.codec))
                for p in range(n) if bounds[p + 1] > bounds[p]]
        self._collect(jobs, t0, "device", register)

    def _collect(self, jobs, t0: int, lane: str, register: bool) -> None:
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
        self._commit(frames_by_part, lane, register)

    def _commit(self, frames_by_part: Sequence[List[bytes]],
                lane: str, register: bool) -> None:
        """Write the frames in partition order under temporary names,
        rename data then index into place, then register the output (a
        rewrite's renames replace the registered files in place)."""
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
            # a failed first write leaves no half of the pair behind; a
            # failed rewrite leaves the registered files to the reader,
            # whose checksums decide
            finals = (data_path, data_path + ".index") if register else ()
            for t in (tmp_data, tmp_index) + finals:
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
        if register:
            self.handle.map_outputs.append(data_path)


class HostShuffleReader:
    """Reads one partition across all map outputs (reference
    RapidsShuffleThreadedReaderBase)."""

    def __init__(self, handle: HostShuffleHandle,
                 manager: "HostShuffleManager",
                 conf: Optional[RapidsConf] = None):
        from ..config import PARTITION_RECOVERY_ENABLED
        from ..exec import speculation_shield
        conf = conf or active_conf()
        self.handle = handle
        self.manager = manager
        self._pool = manager.reader_pool(conf)
        #: the IO retry settings, read here (the fetches run on the pool)
        self._retries = conf.get(IO_RETRIES)
        self._backoff_ms = conf.get(IO_RETRY_BACKOFF_MS)
        self._recovery = bool(conf.get(PARTITION_RECOVERY_ENABLED))
        #: the speculative sub-read policy, None when speculation is off
        self._spec = speculation_shield.reader_speculation(conf)
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

    def _forget_index(self, data_path: str) -> None:
        with self._index_lock:
            self._index_cache.pop(data_path, None)

    def _fetch_segment(self, data_path: str, partition: int,
                       salt_prefix: str = "") -> List[bytes]:
        """One partition's frames from one map output, under the bounded
        IO retry (the index read too: a flaky mount fails its open as
        readily). `salt_prefix` ("spec:") gives a speculative duplicate
        its own fault verdicts."""
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
            salt=f"{salt_prefix}{os.path.basename(data_path)}:{partition}",
            fault_point="shuffle.fetch")
        note_shuffle(fetch_ns=time.perf_counter_ns() - t0,
                     bytes_read=sum(8 + len(f) for f in frames))
        return frames

    def _decode(self, frame: bytes, key: str = "") -> ColumnarBatch:
        """Checksum-verified decode into a host-backed batch: the device
        promotion happens at the exchange's read seam, not on this pool
        thread. A corrupt block is quarantined and raises IntegrityError."""
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

    def _submit(self, qid, fn, *args):
        from ..obs import events as obs_events
        return self._pool.submit(obs_events.with_query_id, qid, fn, *args)

    def read_partition(self, partition: int) -> Iterator[ColumnarBatch]:
        """Partition `partition`'s blocks, in map order: the segments are
        fetched and the frames decoded on the reader pool, and yielded in
        order. A corrupt block recovers through its map output's lineage.
        Closing the iterator cancels the decodes not yet started."""
        from ..obs import events as obs_events
        qid = obs_events.current_query_id()
        paths = list(self.handle.map_outputs)
        if self.handle.invalidated:
            for path in paths:
                self._refresh_invalidated(path, partition)
        spec = self._spec
        if spec is None:
            segs = list(self._pool.map(
                lambda path: obs_events.with_query_id(
                    qid, self._fetch_segment, path, partition), paths))
        else:
            # one future per map output, so that a straggling fetch races
            # one duplicate under a `spec:` key
            futs = [self._submit(qid, spec.timed, "fetch",
                                 self._fetch_segment, path, partition)
                    for path in paths]
            segs = [spec.resolve(
                "fetch", fut,
                launch=lambda p=path: self._submit(
                    qid, spec.timed, "fetch", self._fetch_segment, p,
                    partition, "spec:"),
                key=f"{os.path.basename(path)}:{partition}")
                for path, fut in zip(paths, futs)]
        # the decode key: partition and the frame's global ordinal in map
        # order, so a verdict follows the frame, not the pool's scheduling
        jobs = []
        ordinal = 0
        for path, frames in zip(paths, segs):
            for i, fr in enumerate(frames):
                dkey = f"p{partition}:{ordinal}"
                if spec is None:
                    fut = self._submit(qid, self._decode, fr, dkey)
                    fr = None  # the plain path keeps no frame copies
                else:
                    fut = self._submit(qid, spec.timed, "decode",
                                       self._decode, fr, dkey)
                jobs.append((path, i, fr, dkey, fut))
                ordinal += 1
        del segs
        try:
            for path, frame_idx, fr, dkey, fut in jobs:
                try:
                    if spec is None:
                        yield fut.result()
                    else:
                        yield spec.resolve(
                            "decode", fut,
                            launch=lambda f=fr, k=dkey: self._submit(
                                qid, spec.timed, "decode", self._decode,
                                f, f"spec:{k}"),
                            key=dkey)
                except faults.IntegrityError as e:
                    yield self._recover_block(path, partition, frame_idx, e)
        finally:
            for job in jobs:
                job[-1].cancel()

    # -- the adaptive skew split's sub-reads --------------------------------
    def plan_map_groups(self, partition: int, target_bytes: int
                        ) -> List[Tuple[List[str], int]]:
        """Greedy grouping of one partition's map outputs, in map order,
        so that each group stays under `target_bytes` (an oversized
        output is a group of its own: maps are the split's granularity).
        The groups' frames in order are the unsplit read's. Index tables
        only, no data read."""
        groups: List[Tuple[List[str], int]] = []
        cur: List[str] = []
        cur_b = 0
        for path in list(self.handle.map_outputs):
            offsets = self._index(path)
            b = offsets[partition + 1] - offsets[partition]
            if cur and cur_b + b > target_bytes:
                groups.append((cur, cur_b))
                cur, cur_b = [], 0
            cur.append(path)
            cur_b += b
        if cur:
            groups.append((cur, cur_b))
        return groups

    def read_partition_maps(self, partition: int, paths: Sequence[str],
                            sub: int, ordinal: List[int]
                            ) -> Iterator[ColumnarBatch]:
        """One sub-read of a split partition: `partition` restricted to
        the map outputs `paths`, its decode window one sub-read.
        `ordinal` is a one-element counter shared by the partition's
        sub-reads, so the decode keys are numbered as the unsplit read
        numbers them. Each frame passes the `shuffle.skew_split` fault
        point; a corrupt one recovers through its output's lineage."""
        from ..obs import events as obs_events
        qid = obs_events.current_query_id()
        key = f"{self.handle.shuffle_id}:{partition}:{sub}"
        paths = list(paths)
        if self.handle.invalidated:
            for path in paths:
                self._refresh_invalidated(path, partition)
        segs = list(self._pool.map(
            lambda path: obs_events.with_query_id(
                qid, self._fetch_segment, path, partition), paths))
        jobs = []
        for path, frames in zip(paths, segs):
            for i, fr in enumerate(frames):
                fr = faults.apply("shuffle.skew_split", fr, key=key)
                jobs.append((path, i, self._submit(
                    qid, self._decode, fr, f"p{partition}:{ordinal[0]}")))
                ordinal[0] += 1
        del segs
        try:
            for path, frame_idx, fut in jobs:
                try:
                    yield fut.result()
                except faults.IntegrityError as e:
                    yield self._recover_block(path, partition, frame_idx, e)
        finally:
            for job in jobs:
                job[-1].cancel()

    # -- recovery ------------------------------------------------------------
    def _run_recompute(self, path: str, partition: int, recompute,
                       trigger: str) -> None:
        """Run one lineage recompute (the caller holds recover_lock),
        then count and emit it."""
        from ..exec import lifecycle
        from ..obs import events as obs_events
        t0 = time.perf_counter_ns()
        recompute()
        # the file changed under us: parse its index again
        self._forget_index(path)
        lifecycle.note_partition_recompute()
        extra = {"trigger": trigger} if trigger else {}
        obs_events.emit("partition_recompute",
                        shuffle_id=self.handle.shuffle_id,
                        partition=partition,
                        map_path=os.path.basename(path),
                        wall_ns=time.perf_counter_ns() - t0, **extra)

    def _refresh_invalidated(self, path: str, partition: int) -> None:
        """Consume one dead-peer invalidation: re-run the output's
        lineage before any fetch trusts it, once (the marker goes under
        recover_lock). Without lineage the marker clears and the
        committed file is read as it is."""
        handle = self.handle
        if path not in handle.invalidated:
            return
        with handle.recover_lock:
            if path not in handle.invalidated:
                return  # another stream refreshed it
            handle.invalidated.discard(path)
            recompute = handle.lineage.get(path)
            if recompute is None:
                return
            self._run_recompute(path, partition, recompute, "dead_peer")
            # the refreshed output may recover from corruption again
            handle.recovered.discard(path)

    def _recover_block(self, path: str, partition: int, frame_idx: int,
                       err: "faults.IntegrityError") -> ColumnarBatch:
        """Recover one quarantined block: recompute its map output from
        the lineage (once per output, under recover_lock: a concurrent
        stream that met the same damage waits, then re-fetches), then
        re-fetch and re-decode it under a fresh fault key. Escalates with
        provenance when there is no lineage, recovery is off, the output
        was recovered once already, the recompute fails or the rewrite
        is corrupt too."""
        recompute = self.handle.lineage.get(path)
        if recompute is None or not self._recovery:
            raise self._with_provenance(err, path, partition)
        with self.handle.recover_lock:
            if path not in self.handle.recovered:
                self.handle.recovered.add(path)
                try:
                    self._run_recompute(path, partition, recompute, "")
                except Exception:  # noqa: BLE001 — the task-retry lane
                    # should see the integrity error, not the recompute's
                    raise self._with_provenance(err, path, partition)
        try:
            frames = self._fetch_segment(path, partition)
            if frame_idx >= len(frames):
                raise self._with_provenance(err, path, partition)
            return self._decode(frames[frame_idx],
                                key=f"recover:p{partition}:{frame_idx}")
        except faults.IntegrityError as e2:
            raise self._with_provenance(e2, path, partition)

    def _with_provenance(self, err: "faults.IntegrityError", path: str,
                         partition: int) -> "faults.IntegrityError":
        err.provenance = {"kind": "shuffle_block",
                          "shuffle_id": self.handle.shuffle_id,
                          "partition": partition,
                          "map_path": os.path.basename(path)}
        return err


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
        #: executor id -> [(shuffle id, data path)] of the map outputs a
        #: peer holds, consumed once by invalidate_peer_outputs
        self._peer_outputs: Dict[str, List[Tuple[int, str]]] = {}

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

    # -- dead-peer map-output invalidation ---------------------------------
    def bind_peer_output(self, executor_id: str,
                         handle: HostShuffleHandle, path: str) -> None:
        """Attribute one registered map output to the peer that holds it.
        One card has no peers: nothing binds unless a caller does."""
        with self._lock:
            self._peer_outputs.setdefault(executor_id, []).append(
                (handle.shuffle_id, path))

    def invalidate_peer_outputs(self, executor_id: str) -> int:
        """Mark every map output bound to a dead peer invalidated, once
        (the bindings go with the call): the next read of each recomputes
        it from its lineage. Returns how many were marked; emits one
        `map_output_invalidated` each, outside the registry lock."""
        with self._lock:
            bound = self._peer_outputs.pop(executor_id, [])
            handles = {sid: self._handles.get(sid) for sid, _ in bound}
        from ..obs import events as obs_events
        n = 0
        for sid, path in bound:
            h = handles.get(sid)
            if h is None:
                continue  # unregistered since
            with h.recover_lock:
                if path in h.invalidated:
                    continue
                h.invalidated.add(path)
            n += 1
            obs_events.emit(
                "map_output_invalidated", executor_id=executor_id,
                shuffle_id=sid, map_path=os.path.basename(path),
                has_lineage=path in h.lineage)
        return n

    def unregister(self, handle: HostShuffleHandle) -> None:
        """Forget the shuffle, its peer bindings and its map outputs'
        files."""
        with self._lock:
            self._handles.pop(handle.shuffle_id, None)
            sid = handle.shuffle_id
            for eid in list(self._peer_outputs):
                kept = [b for b in self._peer_outputs[eid] if b[0] != sid]
                if kept:
                    self._peer_outputs[eid] = kept
                else:
                    del self._peer_outputs[eid]
        for path in handle.map_outputs:
            for p in (path, path + ".index"):
                try:
                    os.unlink(p)
                except FileNotFoundError:
                    pass
        handle.map_outputs.clear()
        handle.lineage.clear()

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
