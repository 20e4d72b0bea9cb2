"""Exchange execs on the host shuffle lane — the counterpart of
HostShuffleExchangeExec, BroadcastExchangeExec and ShuffledHashJoinExec
in spark_rapids_tpu/exec/exchange.py (the reference's MULTITHREADED
shuffle under GpuShuffleExchangeExecBase.scala:167, its
GpuBroadcastExchangeExec and GpuShuffledHashJoinExec).

HostShuffleExchangeExec writes each map batch of its child as one map
output of the shuffle manager (shuffle/manager.py), then reads the
partitions back in partition order:

  * hash, roundrobin and single partitioning split on the batch's device
    (`_device_split`): the pid (the murmur3 chain kernel for fixed-width
    keys, parallel/exchange.partition_ids), the count table and a
    pid-stable permutation (ops/partition_split.partition_table), the
    partition-major reorder through the gather engine (one packed row
    gather, `dma_row_gather` on the card), then ONE device->host copy of
    the count table and the reordered batch
    (columnar/transfer.fetch_split_host), at capacity; each non-empty
    partition serializes from its row range on the writer pool;
  * range partitioning takes the host lane: the input is held as
    SpillableBatches while the first sort key's sample streams by, the
    split bounds come from the sample, and each batch splits on the host
    (`_pid_for`, shuffle/manager.partition_batch_host).

The read seam (`_read_partition`) decodes a partition's frames on the
reader pool and promotes each on the pipeline's producer thread, one
packed upload a frame (columnar/upload.promote_stream), onto the device
the map batches came from: a CPU child gives CPU output, a CUDA child
CUDA output. A partition with no block yields one empty batch. The files
go once every partition stream is done and the outer stream is
exhausted, or at once when the write phase raises or the outer stream is
closed early.

Left out: the mesh exchange ShuffleExchangeExec and the ICI lane (ROADMAP
A.6); the lineage capture and partition recompute, the adaptive read
plan (skew splits, coalescing) and ShuffledHashJoinExec's single-build
conversion, the runtime statistics and the `obs` events (ROADMAP A.9).
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..columnar.batch import ColumnarBatch, empty_batch
from ..columnar.column import Column, StringColumn
from ..expr.core import Expression
from ..ops import gather as G
from ..types import Schema
from .base import PIPELINE_STAGE_METRICS, UPLOAD_METRICS, NUM_UPLOADS, \
    UPLOAD_PACK_TIME, TpuExec
from .basic import bind_projection

NUM_INPUT_BATCHES = "numInputBatches"
NUM_INPUT_ROWS = "numInputRows"
NUM_OUTPUT_BATCHES = "numOutputBatches"
PARTITION_SIZE = "dataSize"
SHUFFLE_WRITE_TIME = "shuffleWriteTime"
SHUFFLE_READ_TIME = "shuffleReadTime"
SHUFFLE_PACK_TIME = "shufflePackTimeNs"
#: the writer pool's wall time of a map's frames, and the LZ4 time in
#: them summed over the pool's threads
SHUFFLE_SERIALIZE_TIME = "shuffleSerializeTimeNs"
SHUFFLE_COMPRESS_TIME = "shuffleCompressTimeNs"
#: the map output files' write
SHUFFLE_IO_TIME = "shuffleIoTimeNs"
#: the split's device->host copy (host clock) and its bytes
SHUFFLE_FETCH_TIME = "shuffleFetchTimeNs"
SHUFFLE_FETCH_BYTES = "shuffleFetchBytes"
#: frames written and their raw (uncompressed) payload bytes; frames
#: read back (each one upload at the read seam on a card)
NUM_FRAMES = "numFramesWritten"
RAW_BYTES = "shuffleRawBytes"
NUM_FRAMES_READ = "numFramesRead"
#: map batches with rows, and the packed row gathers their reorders made
NUM_MAPS_WITH_ROWS = "numMapsWithRows"
NUM_REORDER_GATHERS = "numReorderGathers"
BROADCAST_TIME = "broadcastTime"
#: partition pairs a shuffled join joined (both sides with rows), and the
#: stream side's batches it probed
NUM_PARTITION_PAIRS = "numPartitionPairs"
NUM_STREAM_BATCHES = "numStreamBatches"

PARTITIONINGS = ("hash", "roundrobin", "single", "range")


def _host_key_array(col: Column, n: int, idx=None) -> np.ndarray:
    """A range-partition sort key's first n rows as an object array of
    host values (None for nulls; floats as python floats, strings
    decoded, a decimal as its unscaled int), restricted to the rows `idx`
    when given."""
    from ..types import BinaryType
    if type(col) is Column:
        data = col.data[:n].cpu().numpy()
        valid = col.validity[:n].cpu().numpy()
        if idx is not None:
            data, valid = data[idx], valid[idx]
        if data.dtype.kind == "f":
            data = data.astype(np.float64)
        out = data.astype(object)
        out[~valid] = None
        return out
    if type(col) is StringColumn:
        offsets = col.offsets.cpu().numpy()
        valid = col.validity.cpu().numpy()
        buf = col.data.cpu().numpy().tobytes()
        binary = isinstance(col.dtype, BinaryType)
        rows = range(n) if idx is None else idx
        out = np.empty(len(rows), dtype=object)
        for j, i in enumerate(rows):
            if valid[i]:
                raw = buf[offsets[i]: offsets[i + 1]]
                out[j] = raw if binary else raw.decode("utf-8")
        return out
    from ..columnar.column import Decimal128Column
    if type(col) is Decimal128Column:
        vals = np.array(col.to_pylist(n) + [None], dtype=object)[:n]
        return vals if idx is None else vals[idx]
    raise NotImplementedError(
        f"range partitioning on {type(col).__name__} keys waits for its "
        f"slice (ROADMAP A.8)")


def _empty_output(schema: Schema, device) -> ColumnarBatch:
    """A zero-row batch of `schema` on `device`, string columns as
    StringColumns (what a decoded frame holds)."""
    batch = empty_batch(schema, device=device)
    cols = []
    for c, f in zip(batch.columns, schema.fields):
        if f.data_type.torch_dtype is None:
            c = StringColumn(
                torch.zeros(128, dtype=torch.uint8, device=device),
                torch.zeros(c.capacity + 1, dtype=torch.int32,
                            device=device), c.validity, f.data_type)
        cols.append(c)
    return ColumnarBatch(cols, batch.num_rows, schema, 0)


class _PartitionStream:
    """One partition's batch stream: opened at the first next(), and
    done (`on_done` called once) when it is exhausted, raises, is closed
    or is dropped unstarted."""

    def __init__(self, open_fn: Callable[[], Iterator[ColumnarBatch]],
                 on_done: Callable[[], None]):
        self._open = open_fn
        self._on_done = on_done
        self._it: Optional[Iterator[ColumnarBatch]] = None
        self._done = False

    def __iter__(self):
        return self

    def __next__(self) -> ColumnarBatch:
        if self._done:
            raise StopIteration
        try:
            if self._it is None:
                self._it = self._open()
            return next(self._it)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        if self._done:
            return
        self._done = True
        it, self._it = self._it, None
        try:
            if it is not None:
                it.close()
        finally:
            self._on_done()

    def __del__(self):
        self.close()


class HostShuffleExchangeExec(TpuExec):
    """Repartition the child's rows through the host shuffle manager
    (the reference's MULTITHREADED shuffle). The flat stream yields each
    partition's decoded blocks in partition order, unconcatenated;
    partition-aware consumers take the boundaries from
    `execute_partitions()`."""

    def __init__(self, partition_exprs: Sequence[Expression], child: TpuExec,
                 n_partitions: int, conf=None, partitioning: str = "hash",
                 range_order=None, codec: Optional[int] = None):
        """partitioning is hash, roundrobin, single or range (the
        reference's GpuHashPartitioningBase, GpuRoundRobinPartitioning,
        GpuSinglePartitioning, GpuRangePartitioner). Range mode takes
        `range_order` = (ordinal, ascending, nulls_first) on the child's
        schema. `codec` is the frames' (shuffle/serializer CODEC_LZ4 by
        default, or CODEC_COPY). `conf` (default: the active conf, read
        here) sizes the shuffle manager's pools and places its files."""
        super().__init__(child)
        from ..config import active_conf
        from ..shuffle.serializer import CODEC_LZ4
        self._conf = conf or active_conf()
        if partitioning not in PARTITIONINGS:
            raise ValueError(f"unknown partitioning {partitioning!r}")
        if int(n_partitions) < 1:
            raise ValueError(f"n_partitions must be >= 1, not "
                             f"{n_partitions}")
        self.partition_exprs = list(partition_exprs or [])
        self.n_partitions = int(n_partitions)
        self.partitioning = partitioning
        self.range_order = range_order
        self.codec = CODEC_LZ4 if codec is None else codec
        if partitioning == "hash":
            if not self.partition_exprs:
                raise ValueError("hash partitioning needs keys")
            self._bound = bind_projection(self.partition_exprs,
                                          child.output_schema)
        if partitioning == "range" and range_order is None:
            raise ValueError("range partitioning needs range_order")
        self._rr_offset = 0
        #: the device of the map batches (the read seam promotes there)
        self._map_device = None

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    @property
    def device(self):
        return self._map_device or self.child.device

    def additional_metrics(self):
        return (NUM_INPUT_BATCHES, NUM_INPUT_ROWS, NUM_OUTPUT_BATCHES,
                PARTITION_SIZE, SHUFFLE_WRITE_TIME, SHUFFLE_READ_TIME,
                SHUFFLE_PACK_TIME, SHUFFLE_SERIALIZE_TIME,
                SHUFFLE_COMPRESS_TIME, SHUFFLE_IO_TIME, SHUFFLE_FETCH_TIME,
                SHUFFLE_FETCH_BYTES, NUM_FRAMES, RAW_BYTES, NUM_FRAMES_READ,
                NUM_MAPS_WITH_ROWS, NUM_REORDER_GATHERS) \
            + UPLOAD_METRICS + PIPELINE_STAGE_METRICS

    @property
    def runs_own_pipeline_stage(self) -> bool:
        # _read_partition prefetches the decode and the upload through
        # its own pipelined() stage
        return True

    # -- partition ids and the device split --------------------------------
    def _pid_kernel(self, batch: ColumnarBatch) -> torch.Tensor:
        from ..parallel.exchange import partition_ids
        keys = [e.columnar_eval(batch) for e in self._bound]
        return partition_ids(keys, batch.num_rows, batch.capacity,
                             self.n_partitions)

    def _split_kernel(self, batch: ColumnarBatch, rr_offset: int):
        """pid -> per-partition counts and a pid-stable permutation ->
        the partition-major reorder through the gather engine
        (ops/partition_split.py)."""
        from ..ops.basic import active_mask
        from ..ops.partition_split import partition_table, reorder_columns
        n = self.n_partitions
        if self.partitioning == "hash":
            pid = self._pid_kernel(batch)
        else:  # roundrobin
            iota = torch.arange(batch.capacity, dtype=torch.int64,
                                device=batch.device)
            pid = torch.where(
                active_mask(batch.num_rows, batch.capacity),
                (iota + rr_offset) % n, n)
        counts, order = partition_table(pid, batch.num_rows,
                                        batch.capacity, n)
        before = G.counters()["packed_count"]
        cols = reorder_columns(batch.columns, order, batch.num_rows)
        self.metrics[NUM_REORDER_GATHERS].add(
            G.counters()["packed_count"] - before)
        return counts, cols

    def _device_split(self, b: ColumnarBatch, n: int):
        """Split one batch on its device: (host columns in
        partition-major order, bounds (n_partitions + 1,)). The count
        table and the reordered batch cross in ONE device->host copy."""
        from ..columnar import transfer
        if self.partitioning == "single":
            t0 = time.perf_counter_ns()
            cols, _n = transfer.fetch_batch_host(b)
            fetch_ns = time.perf_counter_ns() - t0
            nbytes = sum(t.numel() * t.element_size()
                         for c in cols for t in c.leaves())
            counts = np.zeros(self.n_partitions, np.int64)
            counts[0] = n
        else:
            off = self._rr_offset
            if self.partitioning == "roundrobin":
                self._rr_offset = (self._rr_offset + n) % self.n_partitions
            counts_dev, cols_dev = self._split_kernel(b, off)
            nbytes = transfer.padded(4 * self.n_partitions) + \
                transfer.layout_nbytes([transfer.column_layout(c)
                                        for c in cols_dev])
            t0 = time.perf_counter_ns()
            counts, cols = transfer.fetch_split_host(counts_dev, cols_dev)
            fetch_ns = time.perf_counter_ns() - t0
        self.metrics[SHUFFLE_FETCH_TIME].add(fetch_ns)
        self.metrics[SHUFFLE_FETCH_BYTES].add(nbytes)
        bounds = np.zeros(self.n_partitions + 1, np.int64)
        np.cumsum(counts, out=bounds[1:])
        return cols, bounds

    def _write_map(self, b: ColumnarBatch, n: int, range_bounds, handle,
                   mgr, map_id: int):
        """Partition, serialize and write one map task's output on its
        lane. Returns the writer."""
        from ..shuffle.manager import (HostShuffleWriter, note_shuffle,
                                       partition_batch_host)
        writer = HostShuffleWriter(handle, map_id, mgr, self.codec,
                                   self._conf)
        if not n:
            # an empty batch: zero frames, no partitioning work
            writer.write([[] for _ in range(self.n_partitions)])
            return writer
        self.metrics[NUM_MAPS_WITH_ROWS].add(1)
        if self.partitioning != "range":
            t0 = time.perf_counter_ns()
            cols, bounds = self._device_split(b, n)
            pack_ns = time.perf_counter_ns() - t0
            self.metrics[SHUFFLE_PACK_TIME].add(pack_ns)
            note_shuffle(pack_ns=pack_ns)
            writer.write_slices(ColumnarBatch(cols, n, self.output_schema),
                                bounds)
            return writer
        from ..columnar.transfer import fetch_batch_host
        cols, _ = fetch_batch_host(b)
        host = ColumnarBatch(cols, n, self.output_schema)
        pid = self._pid_for(host, n, range_bounds)
        parts = partition_batch_host(host, pid, self.n_partitions)
        writer.write([[p] if p.num_rows_host else [] for p in parts])
        return writer

    # -- the range lane ----------------------------------------------------
    def _host_keys(self, batch: ColumnarBatch, n: int, stride: int = 1):
        """The first sort key's values as host objects (None for nulls),
        every `stride`-th row."""
        ordinal = self.range_order[0]
        idx = np.arange(0, n, stride, dtype=np.int64) if stride > 1 \
            else None
        return _host_key_array(batch.columns[ordinal], n, idx)

    @staticmethod
    def _is_nan(k) -> bool:
        return isinstance(k, float) and k != k

    def _range_bounds(self, key_samples):
        """Sampled split bounds over the first sort key (reference
        GpuRangePartitioner: sample, sort, n-1 evenly spaced bounds). NaN
        keys are left out (they go to the greatest partition, as Spark's
        NaN sorts last); all-equal keys collapse into one partition."""
        sample = [k for k in key_samples
                  if k is not None and not self._is_nan(k)]
        sample.sort()
        if not sample:
            return []
        idx = [len(sample) * (i + 1) // self.n_partitions
               for i in range(self.n_partitions - 1)]
        return [sample[min(i, len(sample) - 1)] for i in idx]

    def _pid_for(self, batch: ColumnarBatch, n: int, bounds) -> np.ndarray:
        """Range pids of a host batch's first n rows."""
        keys = self._host_keys(batch, n)
        _ordinal, asc, nulls_first = self.range_order
        null_pid = 0 if nulls_first else self.n_partitions - 1
        null_mask = np.array([k is None for k in keys], np.bool_)
        nan_mask = np.array([self._is_nan(k) for k in keys], np.bool_)
        if bounds:
            safe = np.array([bounds[0] if (k is None or self._is_nan(k))
                             else k for k in keys], dtype=object)
            idx = np.searchsorted(np.array(bounds, dtype=object), safe,
                                  side="left").astype(np.int64)
        else:
            idx = np.zeros(n, np.int64)
        idx[nan_mask] = self.n_partitions - 1
        if not asc:
            idx = self.n_partitions - 1 - idx
        idx[null_mask] = null_pid
        return idx

    def _range_source(self):
        """The range lane's input: every batch held as a SpillableBatch
        while the key sample streams by; returns (source, bounds)."""
        from ..memory.spillable import SpillableBatch
        spillables: List[SpillableBatch] = []
        key_samples: list = []
        try:
            for b in self.child.execute():
                nb = b.num_rows_host
                if nb:
                    key_samples.extend(self._host_keys(
                        b, nb, stride=max(1, nb // 512)))
                spillables.append(SpillableBatch.from_batch(b))
        except BaseException:
            for sp in spillables:
                sp.close()
            raise
        bounds = self._range_bounds(key_samples)

        def drain():
            try:
                while spillables:
                    sp = spillables.pop(0)
                    try:
                        batch = sp.get_batch()
                        try:
                            yield batch
                        finally:
                            sp.release()
                    finally:
                        sp.close()
            finally:
                for sp in spillables:
                    sp.close()
        return drain(), bounds

    # -- drive -------------------------------------------------------------
    def internal_execute(self) -> Iterator[ColumnarBatch]:
        parts = self.execute_partitions()
        try:
            for part in parts:
                yield from part
        finally:
            parts.close()

    def execute_partitions(self) -> Iterator[Iterator[ColumnarBatch]]:
        """One lazy batch stream per partition, in partition order:
        decoded blocks stream without concatenation. The map side runs
        in full before the first stream is handed out."""
        from ..shuffle.manager import HostShuffleReader, shuffle_manager
        self.stamp_inputs()
        mgr = shuffle_manager()
        handle = mgr.register(self.n_partitions, self.output_schema)
        state = {"done": 0, "outer_done": False, "closed": False}

        def unregister():
            if not state["closed"]:
                state["closed"] = True
                mgr.unregister(handle)

        def cleanup_if_finished():
            if state["outer_done"] and state["done"] >= self.n_partitions:
                unregister()

        def mark_done():
            state["done"] += 1
            cleanup_if_finished()

        try:
            self._rr_offset = 0
            if self.partitioning == "range":
                source, bounds = self._range_source()
            else:
                source, bounds = self.child.execute(), None
            self._write_phase(source, bounds, handle, mgr)
            reader = HostShuffleReader(handle, mgr, self._conf)
            dev = self.device
            try:
                for p in range(self.n_partitions):
                    yield _PartitionStream(
                        lambda p=p: self._read_partition(reader, p, dev),
                        mark_done)
            finally:
                state["outer_done"] = True
                cleanup_if_finished()
        except BaseException:
            # a write-phase failure or an outer stream closed early: the
            # files go now
            unregister()
            raise

    def _write_phase(self, source, bounds, handle, mgr) -> None:
        in_batches = self.metrics[NUM_INPUT_BATCHES]
        in_rows = self.metrics[NUM_INPUT_ROWS]
        map_id = 0
        try:
            for b in source:
                if self._map_device is None:
                    self._map_device = b.device
                in_batches.add(1)
                n = b.num_rows_host
                in_rows.add(n)
                # time the shuffle's own work, not the child's compute
                with self.metrics[SHUFFLE_WRITE_TIME].ns_timer():
                    writer = self._write_map(b, n, bounds, handle, mgr,
                                             map_id)
                self.metrics[PARTITION_SIZE].add(writer.bytes_written)
                self.metrics[SHUFFLE_SERIALIZE_TIME].add(writer.serialize_ns)
                self.metrics[SHUFFLE_COMPRESS_TIME].add(writer.compress_ns)
                self.metrics[SHUFFLE_IO_TIME].add(writer.io_ns)
                self.metrics[NUM_FRAMES].add(writer.frames_written)
                self.metrics[RAW_BYTES].add(writer.raw_bytes)
                map_id += 1
        finally:
            close = getattr(source, "close", None)
            if close is not None:
                close()

    def _read_partition(self, reader, p: int, dev
                        ) -> Iterator[ColumnarBatch]:
        """Stream one partition's decoded blocks, pipelined: the fetch and
        LZ4 decode (on the reader pool) and the upload of block k+1 run on
        the producer thread while the consumer computes on block k;
        shuffleReadTime counts only the time this operator blocked
        waiting for a block."""
        from ..columnar.upload import await_upload, promote_stream
        read_time = self.metrics[SHUFFLE_READ_TIME]
        out_batches = self.metrics[NUM_OUTPUT_BATCHES]
        frames_read = self.metrics[NUM_FRAMES_READ]
        stage = self.pipeline_stage(
            promote_stream(reader.read_partition(p), dev,
                           num_metric=self.metrics[NUM_UPLOADS],
                           time_metric=self.metrics[UPLOAD_PACK_TIME]),
            "shuffle-read")
        saw = False
        try:
            while True:
                with read_time.ns_timer():
                    try:
                        b = next(stage)
                    except StopIteration:
                        break
                saw = True
                out_batches.add(1)
                frames_read.add(1)
                yield await_upload(b)
        finally:
            stage.close()
        if not saw:
            out_batches.add(1)
            yield _empty_output(self.output_schema, dev)


class BroadcastExchangeExec(TpuExec):
    """Materialize the child once as a single batch on its device and
    replay it to every execution (reference
    GpuBroadcastExchangeExec.scala:352).

    Dictionary-encoded columns cross it as they are when the child gives
    one batch; several batches decode before their concat (their
    dictionaries differ), as CoalesceBatchesExec does. The JAX package
    decodes at this boundary always; the port keeps a broadcast build side
    encoded because its string predicates run in code space only (ROADMAP
    C.9): a planned Q19's join condition reads the part side's codes, as
    the hand-built plan's does."""

    consumes_encoded = True

    def __init__(self, child: TpuExec):
        super().__init__(child)
        self._materialized: Optional[ColumnarBatch] = None

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    def additional_metrics(self):
        return (BROADCAST_TIME, PARTITION_SIZE)

    def materialize(self) -> ColumnarBatch:
        if self._materialized is None:
            from .coalesce import concat_batches
            self.stamp_inputs()
            with self.metrics[BROADCAST_TIME].ns_timer():
                batches = list(self.child.execute())
                if not batches:
                    out = _empty_output(self.output_schema,
                                        self.child.device)
                elif len(batches) == 1:
                    out = batches[0]
                else:
                    from ..columnar.encoded import materialize_batch
                    out = concat_batches([materialize_batch(b)
                                          for b in batches],
                                         self.output_schema)
            self.metrics[PARTITION_SIZE].add(out.nbytes)
            self._materialized = out
        return self._materialized

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        yield self.materialize()


class ShuffledHashJoinExec(TpuExec):
    """Per-partition hash join over two host shuffle exchanges that
    partition both sides the same way (reference
    GpuShuffledHashJoinExec.scala): rows with equal keys land in one
    partition, so the union of the per-partition joins is the join.

    One HashJoinExec is reused across partitions, for every join type it
    has; each partition pair runs it afresh, so its build flags start
    over, and under its own partition index, so its candidate and byte
    buckets are sized for that pair (a bucket cached from one pair would
    be outgrown by a larger one). The build side's partition is materialized (as any hash build
    must be); the stream side's blocks flow through the join one at a
    time. A pair is skipped only where it can emit nothing: an empty
    build side where no unmatched stream row is emitted (inner, semi, a
    build-preserving outer join), an empty stream side where no unmatched
    build row is (everything but a build-preserving outer join). No
    kernel launches on zero rows there. Left out: the adaptive
    single-build conversion (ROADMAP A.9)."""

    def __init__(self, left: TpuExec, right: TpuExec,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 join_type: str = "inner", build_side: str = "right",
                 condition: Optional[Expression] = None):
        super().__init__(left, right)
        from .joins import HashJoinExec
        for side in (left, right):
            if not hasattr(side, "execute_partitions"):
                raise TypeError(f"a shuffled join's children are "
                                f"exchanges, not {type(side).__name__}")
        self.join_type = join_type
        self._lscan = _ReplayScanExec(left)
        self._rscan = _ReplayScanExec(right)
        self._join = HashJoinExec(self._lscan, self._rscan, left_keys,
                                  right_keys, join_type,
                                  build_side=build_side, condition=condition)

    @property
    def output_schema(self) -> Schema:
        return self._join.output_schema

    def additional_metrics(self):
        return (NUM_PARTITION_PAIRS, NUM_STREAM_BATCHES)

    def _counted(self, first: ColumnarBatch, rows) -> Iterator[ColumnarBatch]:
        """The stream side's batches of one pair, counted as the join
        takes them."""
        stream_batches = self.metrics[NUM_STREAM_BATCHES]
        it = _chain(first, rows)
        try:
            for b in it:
                stream_batches.add(1)
                yield b
        finally:
            it.close()

    @staticmethod
    def _nonempty(stream) -> Iterator[ColumnarBatch]:
        try:
            for b in stream:
                if b.num_rows_host:
                    yield b
        finally:
            stream.close()

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        from .joins import EXISTENCE, LEFT_ANTI
        join = self._join
        build_right = join.build_side == "right"
        # does an empty side still leave rows to emit?
        stream_unmatched = join._stream_preserved \
            or join.join_type in (LEFT_ANTI, EXISTENCE)
        build_unmatched = join._need_build_flags
        lit_ = self.children[0].execute_partitions()
        rit = self.children[1].execute_partitions()
        try:
            for pid in itertools.count():
                lp = next(lit_, None)
                rp = next(rit, None)
                if (lp is None) != (rp is None):
                    raise AssertionError(
                        "both sides must use the same partitioning")
                if lp is None:
                    return
                stream, build = (lp, rp) if build_right else (rp, lp)
                batches = list(self._nonempty(build))
                rows = self._nonempty(stream)
                first = None
                if batches or stream_unmatched:
                    first = next(rows, None)
                if (not batches and not stream_unmatched) or (
                        first is None and not build_unmatched):
                    rows.close()
                    stream.close()
                    continue
                scan_s, scan_b = (self._lscan, self._rscan) if build_right \
                    else (self._rscan, self._lscan)
                scan_b.set_batches(batches)
                scan_s.set_stream(self._counted(first, rows)
                                  if first is not None else _no_batches())
                self.metrics[NUM_PARTITION_PAIRS].add(1)
                join.partition = pid
                yield from join.execute()
        finally:
            lit_.close()
            rit.close()


def _no_batches() -> Iterator[ColumnarBatch]:
    yield from ()


def _chain(first: ColumnarBatch, rest) -> Iterator[ColumnarBatch]:
    try:
        yield first
        yield from rest
    finally:
        rest.close()


class _ReplayScanExec(TpuExec):
    """Leaf fed per partition by ShuffledHashJoinExec: a materialized
    batch list (the build side) or a one-shot stream (the stream side).
    `source` is the exchange it stands for (its schema and device)."""

    def __init__(self, source: TpuExec):
        super().__init__()
        self._source = source
        self._batches: List[ColumnarBatch] = []
        self._stream = None

    def set_batches(self, batches: List[ColumnarBatch]) -> None:
        self._batches, self._stream = batches, None

    def set_stream(self, stream) -> None:
        self._batches, self._stream = [], stream

    @property
    def output_schema(self) -> Schema:
        return self._source.output_schema

    @property
    def device(self):
        return self._source.device

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        if self._stream is not None:
            stream, self._stream = self._stream, None
            try:
                yield from stream
            finally:
                stream.close()
            return
        yield from self._batches
