"""Packed host->device batch upload — the counterpart of
spark_rapids_tpu/columnar/upload.py, the ingest mirror of the packed fetch
(columnar/transfer.py).

Building a batch on the card one buffer at a time pays one host->device
copy per data, validity and offsets buffer of every column. Here a batch
of host columns (CPU tensors, at their capacity) crosses in one copy:

  1. the host pack lays the row count and every column's leaves into ONE
     uint8 staging buffer, in transfer.py's layout (each block on a
     16-byte boundary, zero-padded): byte for byte what transfer's device
     pack makes of the same batch. It copies on one thread with the GIL
     released, leaving the host's other cores to the consumer;
  2. ONE `staging.to(device, non_blocking=True)` copies it, with a CUDA
     event recorded after it;
  3. the device unpack is views of that one buffer (`Tensor.view` per
     leaf, which the alignment allows): no kernel, no second copy.

Staging buffers come from a pool of power-of-two buckets (`StagingPool`):
pinned memory where there is a card, grown on a miss, at most
spark.rapids.tpu.transfer.packedUpload.poolBytes of idle buffers kept
(read when the pool is made). `configure(conf)`, which the session calls,
pre-sizes the pool's ladder of buckets up to the bucket of
spark.rapids.sql.batchSizeBytes, within the pool's bytes, as the JAX
package does. A copied buffer goes back to the
pool only once its copy's event has completed (`release_when_ready`): the
upload path never synchronizes, since the catalog's unspill runs it under
the catalog lock. On the CPU `.to("cpu")` returns the staging tensor
itself (the zero-copy alias of the JAX package's CPU backend): such a
buffer is single-use and the pool discards it.

Streams: an upload runs on the caller's current stream. A pipelined scan
uploads on a side stream (`upload_stream`) so that its copies overlap the
consumer's kernels; the batch then carries the copy's event, and the
consumer calls `await_upload` before its first use: its stream waits on
the event, and the one device buffer is recorded on its stream for the
caching allocator.

Every failure raises: there is no per-buffer lane to fall back to.
Column, StringColumn, DictionaryColumn and Decimal128Column pack (a
decimal128 column as its two limbs); nested kinds wait for their slice
(ROADMAP A.8). Not ported by design: the TPU's double-double
f64 staging (`_host_bytes` with `dd`) and PJRT's zero-copy probe
(`_put_aliased`): the port compares the copy's pointer with the staging
buffer's. Left out with their modules (ROADMAP A.9): the
`device.dispatch` fault point and the upload events.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import BATCH_SIZE_BYTES, UPLOAD_POOL_BYTES, active_conf
from .column import Column, resolve_device
from .transfer import (HEADER_BYTES, column_layout, layout_nbytes,
                       leaf_bytes, padded, unpack_columns)

__all__ = [
    "StagingPool", "staging_pool", "reset_staging_pool", "configure",
    "counters", "pack_host_batch", "packed_upload_batch", "to_device_batch",
    "promote_batch", "promote_stream", "upload_leaves", "metric_sink",
    "upload_stream", "await_upload",
]

_COUNTER_LOCK = threading.Lock()
_COUNTERS = {"uploads": 0, "transfers": 0, "bytes": 0, "pack_ns": 0,
             "pool_hits": 0, "pool_misses": 0}


def _note(**deltas) -> None:
    with _COUNTER_LOCK:
        for k, v in deltas.items():
            _COUNTERS[k] += v


def counters() -> Dict[str, int]:
    with _COUNTER_LOCK:
        return dict(_COUNTERS)


# -- staging-buffer pool ----------------------------------------------------

def _byte_bucket(n: int) -> int:
    """A staging size rounded up to a power of two (at least 256 bytes),
    so buffers are reused across batches of similar shape."""
    if n <= 256:
        return 256
    return 1 << int(n - 1).bit_length()


class StagingPool:
    """Reusable host staging buffers (uint8 tensors, pinned when `pinned`,
    by default where there is a card). acquire() takes the bucket's most
    recently returned buffer or allocates one on a miss; release() returns
    it and trims the least recently used idle buffers past `pool_bytes`
    (default: packedUpload.poolBytes of the active conf). Buffers in
    flight are counted but never capped."""

    def __init__(self, pool_bytes: Optional[int] = None,
                 pinned: Optional[bool] = None):
        self.pool_bytes = active_conf().get(UPLOAD_POOL_BYTES) \
            if pool_bytes is None else pool_bytes
        self.pinned = torch.cuda.is_available() if pinned is None \
            else pinned
        self._lock = threading.Lock()
        #: bucket -> [(tick, buffer)] in tick order: reuse pops the tail,
        #: the trim the head
        self._free: Dict[int, List[Tuple[int, torch.Tensor]]] = {}
        #: (buffer, event) whose copy may still be reading the buffer
        self._pending: List[Tuple[torch.Tensor, object]] = []
        self._tick = 0
        self._pooled = 0
        self._outstanding = 0
        self.hits = 0
        self.misses = 0
        self.trims = 0

    def release_when_ready(self, buf: torch.Tensor, event) -> None:
        """Return `buf` once `event` (the copy's) has completed, without
        blocking: later acquire() and outstanding_bytes() calls sweep;
        `settle()` waits. A buffer the pool would not keep anyway goes at
        once: PyTorch's caching host allocator does not hand pinned memory
        out again before the copies that read it have completed."""
        if event is None or buf.shape[0] > self.pool_bytes:
            self.release(buf)
            return
        with self._lock:
            self._pending.append((buf, event))
        self._sweep()

    def _sweep(self, block: bool = False) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        still = []
        for buf, ev in pending:
            if block:
                ev.synchronize()
            if ev.query():
                self.release(buf)
            else:
                still.append((buf, ev))
        if still:
            with self._lock:
                self._pending.extend(still)

    def settle(self) -> None:
        """Wait for every deferred release (tests, the end of a run)."""
        self._sweep(block=True)

    def acquire(self, nbytes: int) -> torch.Tensor:
        self._sweep()
        bucket = _byte_bucket(nbytes)
        with self._lock:
            lst = self._free.get(bucket)
            if lst:
                _, buf = lst.pop()
                self._pooled -= bucket
                self._outstanding += bucket
                self.hits += 1
                _note(pool_hits=1)
                return buf
            self.misses += 1
            self._outstanding += bucket
        _note(pool_misses=1)
        try:
            return torch.empty(bucket, dtype=torch.uint8,
                               pin_memory=self.pinned)
        except BaseException:
            with self._lock:
                self._outstanding -= bucket
            raise

    def release(self, buf: torch.Tensor) -> None:
        """Return a buffer; one larger than `pool_bytes` is dropped (to
        PyTorch's caching host allocator, for pinned memory) rather than
        emptying the pool of every other buffer to make room."""
        bucket = int(buf.shape[0])
        with self._lock:
            self._outstanding -= bucket
            if bucket > self.pool_bytes:
                self.trims += 1
                return
            self._tick += 1
            self._free.setdefault(bucket, []).append((self._tick, buf))
            self._pooled += bucket
            while self._pooled > self.pool_bytes:
                oldest = min((b for b, lst in self._free.items() if lst),
                             key=lambda b: self._free[b][0][0])
                self._free[oldest].pop(0)
                self._pooled -= oldest
                self.trims += 1

    def presize(self, target_bytes: int, pool_cap: int) -> int:
        """Pre-populate one idle buffer per power-of-two bucket from 256
        bytes up to the bucket of `target_bytes`, while the pooled bytes
        stay within `pool_cap`; a bucket that already has an idle buffer
        is skipped. Returns the bytes allocated."""
        top = _byte_bucket(max(int(target_bytes), 256))
        added = 0
        bucket = 256
        while bucket <= top:
            with self._lock:
                have = bool(self._free.get(bucket))
                room = self._pooled + bucket <= pool_cap
            if not have and room:
                buf = torch.empty(bucket, dtype=torch.uint8,
                                  pin_memory=self.pinned)
                with self._lock:
                    self._tick += 1
                    self._free.setdefault(bucket, []).append(
                        (self._tick, buf))
                    self._pooled += bucket
                added += bucket
            bucket <<= 1
        return added

    def discard(self, buf: torch.Tensor) -> None:
        """Drop an acquired buffer without pooling it: an aliased upload
        (the device tensors are the buffer) or a failed one."""
        with self._lock:
            self._outstanding -= int(buf.shape[0])

    def outstanding_bytes(self) -> int:
        self._sweep()
        with self._lock:
            return self._outstanding

    def pooled_bytes(self) -> int:
        with self._lock:
            return self._pooled

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"pooled_bytes": self._pooled,
                    "outstanding_bytes": self._outstanding,
                    "hits": self.hits, "misses": self.misses,
                    "trims": self.trims}


_POOL: Optional[StagingPool] = None
_POOL_LOCK = threading.Lock()


def staging_pool() -> StagingPool:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = StagingPool()
        return _POOL


def reset_staging_pool() -> StagingPool:
    global _POOL, _PRESIZED_FOR
    with _POOL_LOCK:
        _POOL = StagingPool()
        _PRESIZED_FOR = None
        return _POOL


#: (batchSizeBytes, poolBytes) the process pool was last pre-sized for
_PRESIZED_FOR: Optional[Tuple[int, int]] = None


def configure(conf=None) -> None:
    """Pre-size the process pool's ladder of buckets from
    spark.rapids.sql.batchSizeBytes within packedUpload.poolBytes, once
    per pair of values (poolBytes 0: no pool, nothing to do)."""
    global _PRESIZED_FOR
    conf = conf if conf is not None else active_conf()
    cap = max(int(conf.get(UPLOAD_POOL_BYTES)), 0)
    if cap <= 0:
        return
    key = (int(conf.get(BATCH_SIZE_BYTES)), cap)
    with _POOL_LOCK:
        if _PRESIZED_FOR == key:
            return
        _PRESIZED_FOR = key
    staging_pool().presize(*key)


# -- streams ------------------------------------------------------------------

_STREAMS: Dict[int, "torch.cuda.Stream"] = {}
_STREAM_LOCK = threading.Lock()


def upload_stream(device) -> "torch.cuda.Stream":
    """The side stream a pipelined scan uploads on (one per card)."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _STREAM_LOCK:
        s = _STREAMS.get(index)
        if s is None:
            s = _STREAMS[index] = torch.cuda.Stream(index)
        return s


@contextmanager
def on_upload_stream(device):
    """Run the block's uploads on `device`'s upload stream (a no-op off
    the card)."""
    if device is None or torch.device(device).type != "cuda":
        yield
        return
    with torch.cuda.stream(upload_stream(device)):
        yield


def await_upload(batch):
    """Make a batch uploaded on a side stream safe on the current stream:
    wait on its copy's event and record its buffer on this stream. A
    no-op for every other batch."""
    pending = batch._upload
    if pending is None:
        return batch
    batch._upload = None
    event, buf = pending
    cur = torch.cuda.current_stream(buf.device)
    cur.wait_event(event)
    buf.record_stream(cur)
    return batch


# -- the host pack ------------------------------------------------------------

def _put_block(buf: np.ndarray, pos: int, leaf: torch.Tensor) -> int:
    """Copy a leaf's bytes into the staging buffer's numpy view at `pos`
    and zero its padding; the next offset. One thread, the GIL released:
    a pipelined scan's pack leaves the other cores to the consumer (a
    copy on torch's intra-op threads takes them all)."""
    b = leaf_bytes(leaf).numpy()
    n = b.shape[0]
    buf[pos: pos + n] = b
    end = padded(n)
    buf[pos + n: pos + end] = 0
    return pos + end


def _host_columns(cols: Sequence[Column]) -> List[tuple]:
    """The columns' layouts; raises for a column kind the port lacks or a
    column whose leaves are not on the host."""
    layouts = [column_layout(c) for c in cols]
    for c in cols:
        if any(t.device.type != "cpu" for t in c.leaves()):
            raise ValueError(f"{c!r} is not a host column (its leaves are "
                             f"on {c.device})")
    return layouts


def pack_host_batch(cols: Sequence[Column], n: int,
                    pool: Optional[StagingPool] = None
                    ) -> Tuple[torch.Tensor, int]:
    """Lay (row count + columns) into one pooled staging buffer. Returns
    (buffer, used bytes); the buffer is bucket-sized and its tail past the
    used bytes is not part of the pack. The caller releases or discards
    the buffer."""
    total = HEADER_BYTES + layout_nbytes(_host_columns(cols))
    pool = pool or staging_pool()
    buf = pool.acquire(total)
    try:
        view = buf.numpy()
        pos = _put_block(view, 0, torch.tensor([n], dtype=torch.int32))
        for c in cols:
            for leaf in c.leaves():
                pos = _put_block(view, pos, leaf)
    except BaseException:
        pool.discard(buf)
        raise
    if pos != total:
        raise AssertionError(f"packed {pos} of {total} bytes")
    return buf, total


# -- the upload ---------------------------------------------------------------

_TLS = threading.local()


@contextmanager
def metric_sink(num_metric, time_metric):
    """Attribute the uploads inside the block to an exec's (numUploads,
    uploadPackTimeNs) metric pair."""
    prev = getattr(_TLS, "sink", None)
    _TLS.sink = (num_metric, time_metric)
    try:
        yield
    finally:
        _TLS.sink = prev


def _record(nbytes: int, pack_ns: int) -> None:
    _note(uploads=1, transfers=1, bytes=nbytes, pack_ns=pack_ns)
    sink = getattr(_TLS, "sink", None)
    if sink is not None:
        sink[0].add(1)
        sink[1].add(pack_ns)


def _one_transfer(pool: StagingPool, buf: torch.Tensor, total: int,
                  device: torch.device):
    """The single host->device copy of the used bytes. Returns (device
    buffer, the copy's event or None); the staging buffer goes back to
    the pool once the event completes (discarded if the copy aliased
    it, or if the copy failed)."""
    src = buf[:total]
    try:
        out = src.to(device, non_blocking=True)
        event = None
        if out.is_cuda:
            event = torch.cuda.Event()
            event.record()
    except BaseException:
        pool.discard(buf)
        raise
    if out.data_ptr() == src.data_ptr():
        pool.discard(buf)  # the device tensors are the staging buffer
    else:
        pool.release_when_ready(buf, event)
    return out, event


def packed_upload_batch(cols: Sequence[Column], n: int, schema,
                        device=None):
    """ONE staging pack, ONE copy, an unpack of views: host columns as a
    batch on `device` (default: the card)."""
    from .batch import ColumnarBatch
    t0 = time.perf_counter_ns()
    dev = resolve_device(device)
    pool = staging_pool()
    buf, total = pack_host_batch(cols, n, pool)
    layouts = [column_layout(c) for c in cols]
    out, event = _one_transfer(pool, buf, total, dev)
    out_cols, _ = unpack_columns(out, layouts, HEADER_BYTES)
    batch = ColumnarBatch(out_cols, out[:4].view(torch.int32).reshape(()),
                          schema, host_rows=n)
    if event is not None and torch.cuda.current_stream(out.device) \
            != torch.cuda.default_stream(out.device):
        batch._upload = (event, out)
    _record(total, time.perf_counter_ns() - t0)
    return batch


#: the JAX package's name for the conf-gated entry; the port has one lane
to_device_batch = packed_upload_batch


def promote_batch(batch, device=None):
    """A batch of host columns on `device`; a batch already there passes
    through."""
    dev = resolve_device(device)
    on_host = any(t.device.type == "cpu"
                  for c in batch.columns for t in c.leaves())
    if not on_host or dev.type == "cpu":
        return batch
    return to_device_batch(list(batch.columns), batch.num_rows_host,
                           batch.schema, dev)


def promote_stream(it, device=None, num_metric=None,
                   time_metric=None):
    """A host-batch iterator with each batch promoted (one upload each),
    attributed to an exec's metric pair when given. On a card the copies
    run on the card's upload stream, so each promoted batch carries its
    copy's event: the consumer calls `await_upload` before using it.
    Closing the iterator closes the wrapped one."""
    dev = resolve_device(device)
    try:
        for b in it:
            # promote inside the sink, yield outside it: a generator
            # suspends at yield with its thread-locals in place
            with on_upload_stream(dev):
                if num_metric is not None:
                    with metric_sink(num_metric, time_metric):
                        out = promote_batch(b, dev)
                else:
                    out = promote_batch(b, dev)
            yield out
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def _leaves_nbytes(leaves: Sequence[torch.Tensor]) -> int:
    return sum(padded(t.numel() * t.element_size()) for t in leaves)


def _leaf_views(buf: torch.Tensor, like: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    """Views of the uint8 `buf` shaped as `like`, packed: each on a
    16-byte boundary, in order."""
    out, pos = [], 0
    for t in like:
        nbytes = t.numel() * t.element_size()
        out.append(buf[pos: pos + nbytes].view(t.dtype).reshape(t.shape))
        pos += padded(nbytes)
    return out


def packed_host_leaves(like: Sequence[torch.Tensor], pinned: bool
                       ) -> List[torch.Tensor]:
    """Empty host tensors shaped as `like`, laid out as upload_leaves
    packs them: views of ONE uint8 buffer (pinned when `pinned`). The
    spill catalog copies a batch into them, so that its unspill is one
    copy with no host pack."""
    return _leaf_views(torch.empty(max(_leaves_nbytes(like), 1),
                                   dtype=torch.uint8, pin_memory=pinned),
                       like)


def _packed_buffer(leaves: Sequence[torch.Tensor], total: int
                   ) -> Optional[torch.Tensor]:
    """The uint8 buffer the leaves already lie in, packed (as
    packed_host_leaves lays them out), or None."""
    storage = leaves[0].untyped_storage()
    base, pos = storage.data_ptr(), 0
    for t in leaves:
        if t.untyped_storage().data_ptr() != base or \
                t.data_ptr() != base + pos or not t.is_contiguous():
            return None
        pos += padded(t.numel() * t.element_size())
    if storage.nbytes() < total:
        return None
    return torch.empty(0, dtype=torch.uint8).set_(storage)[:total]


def upload_leaves(host_leaves: Sequence[torch.Tensor], device
                  ) -> List[torch.Tensor]:
    """A flat list of host tensors (a spilled batch's leaves) on `device`
    in ONE copy: packed as the batch pack's blocks, and each returned
    tensor a view of the one device buffer, in the leaf's shape. Leaves
    that already lie packed in one buffer (packed_host_leaves) are
    copied as they are."""
    t0 = time.perf_counter_ns()
    leaves = list(host_leaves)
    if not leaves:
        raise ValueError("upload_leaves needs at least one leaf")
    dev = torch.device(device)
    total = _leaves_nbytes(leaves)
    packed = _packed_buffer(leaves, total)
    if packed is not None:
        out = packed.to(dev, non_blocking=True)
    else:
        pool = staging_pool()
        buf = pool.acquire(total)
        try:
            view, pos = buf.numpy(), 0
            for t in leaves:
                pos = _put_block(view, pos, t)
        except BaseException:
            pool.discard(buf)
            raise
        out, _ = _one_transfer(pool, buf, total, dev)
    _record(total, time.perf_counter_ns() - t0)
    return _leaf_views(out, leaves)
