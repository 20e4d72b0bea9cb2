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

Each map write's wall is the `host-pack-serialize` phase but for the
writer's file IO, which is `shuffle-io`; its per-partition row counts
(the split's count table, already on the host) and byte counts (the
serializer's offsets) feed the query's RuntimeStats through an
ExchangeRecorder (obs/stats.py), with no new host read; each map task is
an `exchange` and a `shuffle_write` event, and the execution one
`exchange_stats` event.

Partition-granular recovery: unless partitioning is range (its bounds
come from a sample of a buffer the write consumes) or
task.partitionRecovery.enabled is off, each map output's lineage is
captured as it is written (`_make_recompute`: re-run the child, replay
the round-robin cursor from zero, rewrite that one output in place);
the reader recomputes a corrupt block's output from it
(shuffle/manager.py).

The adaptive read plan (`_adaptive_read_plan`, exec/adaptive.py) is
consulted after the write, from its measured per-partition bytes:

  * skew split, for any consumer: a partition over
    max(skewedPartitionFactor x the median of the non-empty partitions,
    skewedPartitionMinBytes) with more than one map output is read as
    map-granular sub-reads (`_read_partition` over
    HostShuffleReader.plan_map_groups), each its own pipelined stage, so
    a probe never holds the whole hot partition's decode window;
  * coalescing, for the flat stream only (`internal_execute`): adjacent
    partitions that fit adaptive.coalesceTargetBytes together are read
    as one stream. A partition-aware consumer always sees the static
    boundaries.

ShuffledHashJoinExec converts to one single-build pass when its build
exchange measures at or under adaptive.autoBroadcastMaxBytes (the
stream side's exchange is skipped), and flags its stream-side host
exchange (`_adaptive_probe_split`): a skew split needs the host lane's
map-granular files, so that exchange stands down from the device lane.

`tpu.shuffle.devicePartition.enabled=false` splits hash, roundrobin and
single partitioning on the host instead (`_write_map`'s host lane: the
pid on the device for hash keys, then the batch fetched and partitioned
by numpy), as the JAX package does; the user asks for it, so it is a plan
and not a fallback.

The mesh lane (parallel/, ROADMAP A.6), over the session's active mesh:

  * ShuffleExchangeExec, the planner's exchange over a mesh
    (`_plan_mesh`): the identity with no mesh or a one-shard mesh, else
    rounds bounded by sql.exchange.roundBytes, each grouping its batches
    one group a shard, measuring every shard's partition histogram and
    longest string in one host read, and running the all-to-all
    (parallel/exchange.exchange_columns) on a grid sized to the measure;
    each shard's received rows are staged as SpillableBatches, drained
    per partition one piece at a time.
  * The host exchange's device lane (`_ici_eligible`, with
    tpu.shuffle.ici.enabled): when the active mesh's shard count equals
    the partition count, each round takes one map batch a shard in map
    order, so each partition receives its rows in the host lane's order,
    bit for bit; the round robin cursor is the host lane's. It stands
    down to the host lane for range partitioning, an array or map
    payload, a mesh of another size, an open `ici_exchange` breaker and
    an armed skew split (`adaptive_skew_split`, counted and emitted as
    a fallback). A failing round (the `shuffle.ici_exchange` fault point)
    counts against the breaker and the rest of the stream takes the host
    lane; each partition then drains its staged pieces first and the host
    lane's stream after (`_drain_staged`). Staged shards are catalog
    entries tagged `ici_exchange`: they count against the device budget,
    spill, and are released when their partition stream is closed,
    dropped unstarted, or never handed out.
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
from ..types import BinaryType, Schema, StringType
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
        if isinstance(f.data_type, (StringType, BinaryType)):
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


NUM_HOST_READS = "numHostReads"
NUM_ROUNDS = "numRounds"


def _measure(shards: Sequence[ColumnarBatch], pids, n: int) -> np.ndarray:
    """Every shard's rows per partition and its longest active string (a
    struct's string children included: the padded lane carries them at
    the same width), in one host read: an (shards, n + 1) int64 array,
    the length last."""
    from ..ops.basic import active_mask
    from ..ops.strings import string_lengths
    from ..parallel.exchange import string_columns
    rows = []
    home = shards[0].device
    for b, pid in zip(shards, pids):
        counts = torch.zeros(n + 1, dtype=torch.int64, device=b.device)
        counts = counts.scatter_add_(0, pid.long(),
                                     torch.ones_like(pid, dtype=torch.int64))[:n]
        longest = torch.zeros((), dtype=torch.int64, device=b.device)
        act = active_mask(b.num_rows, b.capacity, b.device)
        for c in string_columns(b.columns):
            lens = torch.where(act, string_lengths(c), 0)
            longest = torch.maximum(longest, lens.max().to(torch.int64))
        rows.append(torch.cat([counts.to(torch.int64), longest.reshape(1)])
                    .to(home, non_blocking=True))
    return torch.stack(rows).cpu().numpy()


def _shard_inputs(batches, schema: Schema, devs) -> List[ColumnarBatch]:
    """One batch a shard (an empty one where there is none), each on its
    shard's device at its own capacity: the JAX package pads every shard
    to the largest for its stacked program; the port's loop over the
    shards needs no padding, so an empty shard hashes, sorts and gathers
    a 128-row bucket, not the largest shard's."""
    from ..parallel.distributed import batch_to_device
    out = []
    for d, dev in enumerate(devs):
        b = batches[d] if d < len(batches) else None
        out.append(_empty_output(schema, dev) if b is None
                   else batch_to_device(b, dev))
    return out


def _unspill(pieces) -> Iterator[ColumnarBatch]:
    """Staged shard pieces one at a time, each closed once handed out; a
    failed promotion closes its own piece, and an early close drops the
    staged rest."""
    it = iter(pieces)
    try:
        for sp in it:
            try:
                b = sp.get_batch()
                sp.release()
            except BaseException:
                sp.close()
                raise
            sp.close()
            yield b
    finally:
        for sp in it:
            sp.close()


def _close_pieces(pieces) -> None:
    for sp in pieces:
        sp.close()


def _release(pieces, host) -> None:
    """A mesh partition stream is done: its staged pieces go, and the
    host lane's stream it chains, when there is one."""
    _close_pieces(pieces)
    if host is not None:
        host.close()


def _chain_rest(pending: List[ColumnarBatch], source
                ) -> Iterator[ColumnarBatch]:
    """The batches in hand, then the rest of `source`; closing it closes
    `source`."""
    try:
        yield from pending
        yield from source
    finally:
        source.close()


def _mesh_round(mesh, groups, schema: Schema, pid_of, hints=None):
    """One all-to-all round over `mesh`: groups[d] (a batch, or None for
    none) is shard d's input and pid_of(d, local) its pids. One host read
    measures every shard's rows per partition and its longest string, so
    the grid fits the largest partition and the string lanes the longest
    string. `hints` ([rows, width], raised in place) are running
    high-water marks that keep later, smaller rounds on one grid. Returns
    (the received shard batches, the (shards, partitions) rows, the slot
    cap, the string width)."""
    from ..parallel.exchange import exchange_columns, negotiate_slot_cap
    devs = mesh.shard_devices
    n = len(devs)
    local = _shard_inputs(groups, schema, devs)
    caps = [b.capacity for b in local]
    pids = [pid_of(d, b) for d, b in enumerate(local)]
    stats = _measure(local, pids, n)
    per_map = stats[:, :n]
    largest = int(per_map.max())
    width = max(8, (int(stats[:, n].max()) + 7) // 8 * 8)
    if hints is not None:
        hints[0] = largest = max(hints[0], largest)
        hints[1] = width = max(hints[1], width)
    slot_cap = negotiate_slot_cap(largest, max(caps))
    cols, n_recv = exchange_columns(
        [b.columns for b in local], (), [b.num_rows for b in local], caps,
        mesh, n, slot_cap=slot_cap, string_width=width, pids=pids)
    totals = per_map.sum(axis=0)
    shards = [ColumnarBatch(c, r, schema, int(t))
              for c, r, t in zip(cols, n_recv, totals)]
    return shards, per_map, slot_cap, width


def _stage(staged: List[list], shards, origin=None) -> None:
    """A round's received shards onto each partition's staged pieces."""
    from ..memory.spillable import SpillableBatch
    for d, shard in enumerate(shards):
        staged[d].append(SpillableBatch.from_batch(shard, origin=origin))


def _staged_partitions(op: TpuExec, staged, devs, stage_name: str,
                       host_parts=None) -> Iterator[Iterator[ColumnarBatch]]:
    """A mesh exchange's partition streams, one a shard's staged pieces
    (with `host_parts`, each chained with the host lane's stream of its
    partition). A stream closed, or dropped unstarted, releases its
    staged pieces; so does the outer stream, closed early, for those it
    never handed out."""
    handed = 0
    try:
        for p in range(len(staged)):
            host = next(host_parts) if host_parts is not None else None
            handed += 1
            yield _PartitionStream(
                lambda p=p, host=host: _drain_staged(
                    op, staged[p], devs[p], stage_name, host),
                lambda p=p, host=host: _release(staged[p], host))
    finally:
        for q in range(handed, len(staged)):
            _close_pieces(staged[q])
        if host_parts is not None:
            host_parts.close()


def _drain_staged(op: TpuExec, pieces, dev, stage_name: str, host=None
                  ) -> Iterator[ColumnarBatch]:
    """One partition: its staged pieces (pipelined: the unspill of piece
    k + 1 overlaps the consumer's work on k), then the host lane's stream
    when there is one (it yields at least an empty batch, so the staged
    side adds none); with neither, one empty batch on `dev`."""
    out_batches = op.metrics[NUM_OUTPUT_BATCHES]
    try:
        if pieces:
            stage = op.pipeline_stage(_unspill(pieces), stage_name)
            try:
                for b in stage:
                    out_batches.add(1)
                    yield b
            finally:
                stage.close()
        elif host is None:
            out_batches.add(1)
            yield _empty_output(op.output_schema, dev)
        if host is not None:
            yield from host
    finally:
        if host is not None:
            host.close()


class ShuffleExchangeExec(TpuExec):
    """Hash-repartition the child's rows across the mesh so equal
    partition keys meet on one shard (the reference's
    GpuShuffleExchangeExecBase over its UCX transport). With no mesh or a
    one-shard mesh it is the identity. The flat stream yields each
    shard's staged pieces in partition order; partition-aware consumers
    take the boundaries from `execute_partitions()`."""

    def __init__(self, partition_exprs: Sequence[Expression], child: TpuExec,
                 mesh=None, conf=None):
        super().__init__(child)
        from ..config import EXCHANGE_ROUND_BYTES, active_conf
        from ..parallel.mesh import active_mesh
        self.partition_exprs = list(partition_exprs)
        self._mesh = mesh if mesh is not None else active_mesh()
        if self._mesh is not None and \
                self._mesh.devices.size != self.n_partitions:
            raise ValueError(f"the exchange runs over the mesh's "
                             f"{self.n_partitions}-shard data axis, not "
                             f"{self._mesh.devices.size} devices")
        self._bound = bind_projection(self.partition_exprs,
                                      child.output_schema)
        self._round_bytes = (conf or active_conf()).get(EXCHANGE_ROUND_BYTES)
        self.rounds = 0

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    @property
    def n_partitions(self) -> int:
        from ..parallel.mesh import mesh_axis_size
        return 1 if self._mesh is None else mesh_axis_size(self._mesh)

    def additional_metrics(self):
        return (NUM_INPUT_BATCHES, NUM_INPUT_ROWS, NUM_OUTPUT_BATCHES,
                PARTITION_SIZE, SHUFFLE_WRITE_TIME, NUM_HOST_READS,
                NUM_ROUNDS) + PIPELINE_STAGE_METRICS

    @property
    def runs_own_pipeline_stage(self) -> bool:
        # _drain_staged prefetches the staged pieces through its own
        # pipelined() stage
        return True

    def _local_pid(self, local: ColumnarBatch, n: int) -> torch.Tensor:
        from ..parallel.exchange import partition_ids
        keys = [e.columnar_eval(local) for e in self._bound]
        return partition_ids(keys, local.num_rows, local.capacity, n)

    def _exchange_round(self, batches: List[ColumnarBatch]):
        """One all-to-all over a bounded group of input batches (shard d
        takes batches d, d + n, ..., concatenated). Returns (the n
        received shard batches, the partitions' row totals)."""
        from .coalesce import concat_batches
        n = self.n_partitions
        schema = self.output_schema
        groups = []
        for d in range(n):
            g = batches[d::n]
            groups.append(None if not g else g[0] if len(g) == 1
                          else concat_batches(g, schema))
        shards, per_map, _, _ = _mesh_round(
            self._mesh, groups, schema, lambda d, b: self._local_pid(b, n))
        self.metrics[NUM_HOST_READS].add(1)
        return shards, per_map.sum(axis=0)

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        parts = self.execute_partitions()
        try:
            for part in parts:
                yield from part
        finally:
            parts.close()

    def execute_partitions(self) -> Iterator[Iterator[ColumnarBatch]]:
        """One lazy batch stream per partition, in partition order; the
        rounds run in full before the first is handed out. A stream
        closed or dropped undrained releases its staged pieces."""
        self.stamp_inputs()
        if self.n_partitions == 1:
            yield self._stream_single()
            return
        staged = self._run_rounds()
        yield from _staged_partitions(self, staged, self._mesh.shard_devices,
                                      "exchange-read")

    def _stream_single(self) -> Iterator[ColumnarBatch]:
        in_batches = self.metrics[NUM_INPUT_BATCHES]
        in_rows = self.metrics[NUM_INPUT_ROWS]
        src = self.child.execute()
        try:
            for b in src:
                in_batches.add(1)
                if b._host_rows is not None:
                    in_rows.add(b._host_rows)
                else:
                    in_rows.add_device(b.num_rows)
                yield b
        finally:
            src.close()

    def _run_rounds(self):
        """The child's batches through the all-to-all in rounds of at most
        sql.exchange.roundBytes of input; each round's received shards
        are staged as SpillableBatches. Returns the staged pieces of each
        partition."""
        from ..obs import events as obs_events
        from ..obs import phase as obs_phase
        from ..obs import stats as obs_stats
        n = self.n_partitions
        in_batches = self.metrics[NUM_INPUT_BATCHES]
        in_rows = self.metrics[NUM_INPUT_ROWS]
        staged: List[list] = [[] for _ in range(n)]
        pending: List[ColumnarBatch] = []
        pending_bytes = 0
        part_totals = None
        self.rounds = 0
        # the mesh exchange measures rows per partition, not bytes: its
        # skew basis is rows
        stats_rec = obs_stats.ExchangeRecorder(type(self).__name__,
                                               self._op_id, n)

        def flush():
            nonlocal pending, pending_bytes, part_totals
            if not pending:
                return
            with self.metrics[SHUFFLE_WRITE_TIME].ns_timer(), \
                    obs_phase.span("ici-collective"):
                shards, totals = self._exchange_round(pending)
            part_totals = totals if part_totals is None \
                else part_totals + totals
            stats_rec.record_map(totals.tolist(), None, 0)
            _stage(staged, shards)
            pending, pending_bytes = [], 0
            self.rounds += 1
            self.metrics[NUM_ROUNDS].add(1)

        src = self.child.execute()
        try:
            for b in src:
                in_batches.add(1)
                if b._host_rows is not None:
                    in_rows.add(b._host_rows)
                else:
                    in_rows.add_device(b.num_rows)
                pending.append(b)
                pending_bytes += b.nbytes
                if pending_bytes >= self._round_bytes:
                    flush()
            flush()
        except BaseException:
            for pieces in staged:
                _close_pieces(pieces)
            raise
        finally:
            src.close()
        if part_totals is not None:
            max_part = int(part_totals.max())
            self.metrics[PARTITION_SIZE].add(max_part)
            obs_events.emit("exchange", exec=type(self).__name__,
                            op_id=self._op_id, partitions=n,
                            rounds=self.rounds,
                            max_partition_rows=max_part)
            stats_rec.finish_and_emit()
        return staged

    def node_description(self):
        return (f"ShuffleExchangeExec[n={self.n_partitions}, "
                f"keys={self.partition_exprs!r}]")


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
        from ..config import (ADAPTIVE_COALESCE_TARGET_BYTES,
                              ADAPTIVE_ENABLED, ADAPTIVE_SKEW_FACTOR,
                              ADAPTIVE_SKEW_MIN_BYTES,
                              PARTITION_RECOVERY_ENABLED,
                              SHUFFLE_DEVICE_PARTITION, SHUFFLE_ICI_ENABLED)
        #: lineage capture (never for range: see the module docstring)
        self._capture_lineage = partitioning != "range" and bool(
            self._conf.get(PARTITION_RECOVERY_ENABLED))
        #: the skew split's factor and floor, and the coalesce target
        self._skew_factor = self._conf.get(ADAPTIVE_SKEW_FACTOR)
        self._skew_min_bytes = self._conf.get(ADAPTIVE_SKEW_MIN_BYTES)
        self._coalesce_target = self._conf.get(
            ADAPTIVE_COALESCE_TARGET_BYTES)
        #: the last write's measured bytes (single-build conversion)
        self._adaptive_write_bytes: Optional[int] = None
        self._adaptive_enabled = bool(self._conf.get(ADAPTIVE_ENABLED))
        #: hash, roundrobin and single split on the device unless
        #: tpu.shuffle.devicePartition.enabled is false
        self._device_partition = partitioning != "range" and bool(
            self._conf.get(SHUFFLE_DEVICE_PARTITION))
        #: the device lane (tpu.shuffle.ici.enabled), the mesh it runs
        #: over (the active mesh when eligible), and the running
        #: high-water marks [rows, string width] that keep later rounds
        #: on one grid
        self._ici_enabled = bool(self._conf.get(SHUFFLE_ICI_ENABLED))
        self._ici_mesh = None
        self._ici_hints = [0, 8]
        #: set by a ShuffledHashJoinExec on its stream-side exchange: an
        #: armed skew split needs the host lane's map-granular files
        self._adaptive_probe_split = False

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
                NUM_MAPS_WITH_ROWS, NUM_REORDER_GATHERS, NUM_HOST_READS,
                NUM_ROUNDS) + UPLOAD_METRICS + PIPELINE_STAGE_METRICS

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
                   mgr, map_id: int, register: bool = True):
        """Partition, serialize and write one map task's output on its
        lane (`register=False`: a recovery's rewrite of a registered
        output). Returns (the writer, the lane, the split's ns, the rows
        of each partition)."""
        from ..shuffle.manager import (HostShuffleWriter, note_shuffle,
                                       partition_batch_host)
        writer = HostShuffleWriter(handle, map_id, mgr, self.codec,
                                   self._conf)
        if not n:
            # an empty batch: zero frames, no partitioning work
            writer.write([[] for _ in range(self.n_partitions)], register)
            return writer, "host", 0, [0] * self.n_partitions
        self.metrics[NUM_MAPS_WITH_ROWS].add(1)
        if self._device_partition:
            t0 = time.perf_counter_ns()
            cols, bounds = self._device_split(b, n)
            pack_ns = time.perf_counter_ns() - t0
            self.metrics[SHUFFLE_PACK_TIME].add(pack_ns)
            note_shuffle(pack_ns=pack_ns)
            writer.write_slices(ColumnarBatch(cols, n, self.output_schema),
                                bounds, register)
            return writer, "device", pack_ns, np.diff(bounds).tolist()
        from ..columnar.transfer import fetch_batch_host
        dev_pid = self._pid_kernel(b) if self.partitioning == "hash" \
            else None
        cols, _ = fetch_batch_host(b)
        host = ColumnarBatch(cols, n, self.output_schema)
        pid = self._pid_for(host, n, range_bounds, dev_pid)
        parts = partition_batch_host(host, pid, self.n_partitions)
        writer.write([[p] if p.num_rows_host else [] for p in parts],
                     register)
        return writer, "host", 0, [p.num_rows_host for p in parts]

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

    def _pid_for(self, batch: ColumnarBatch, n: int, bounds,
                 dev_pid=None) -> np.ndarray:
        """The pids of a host batch's first n rows: a hash batch's from
        its device pid (`dev_pid`), round robin's from the cursor, range's
        from the sampled bounds."""
        if self.partitioning == "hash":
            return dev_pid[:n].cpu().numpy().astype(np.int64)
        if self.partitioning == "single":
            return np.zeros(n, np.int64)
        if self.partitioning == "roundrobin":
            pid = (np.arange(n, dtype=np.int64) + self._rr_offset) \
                % self.n_partitions
            self._rr_offset = (self._rr_offset + n) % self.n_partitions
            return pid
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
        # the flat stream: the one consumer whose tiny partitions may
        # coalesce into one read
        parts = self.execute_partitions(flat=True)
        try:
            for part in parts:
                yield from part
        finally:
            parts.close()

    def execute_partitions(self, flat: bool = False
                           ) -> Iterator[Iterator[ColumnarBatch]]:
        """One lazy batch stream per partition, in partition order:
        decoded blocks stream without concatenation. The map side runs
        in full before the first stream is handed out. `flat` marks a
        partition-oblivious consumer: only then may adjacent small
        partitions come as one stream (a zipped pair of exchanges must
        keep the static boundaries). The device lane runs when eligible
        (`_ici_eligible`), else the host lane."""
        self.stamp_inputs()
        self._adaptive_write_bytes = None
        if self._ici_eligible():
            yield from self._execute_partitions_ici()
        else:
            yield from self._execute_partitions_host(flat)

    def _execute_partitions_host(self, flat: bool = False,
                                 override_source=None, stats_rec=None
                                 ) -> Iterator[Iterator[ColumnarBatch]]:
        """The host serialize lane, and the device lane's fallback:
        `override_source` is then the rest of the stream after a failed
        round (the round's batches still in hand, then the child's
        unread batches), written with no lineage (a recompute would
        replay the child from its first batch), the round robin cursor
        going on from the rounds, `stats_rec` carrying the rounds' maps
        and no adaptive read plan."""
        from ..shuffle.manager import HostShuffleReader, shuffle_manager
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

        def mark_done(k: int):
            state["done"] += k
            cleanup_if_finished()

        try:
            if override_source is not None:
                source, bounds = override_source, None
            elif self.partitioning == "range":
                self._rr_offset = 0
                source, bounds = self._range_source()
            else:
                self._rr_offset = 0
                source, bounds = self.child.execute(), None
            stats_rec = self._write_phase(source, bounds, handle, mgr,
                                          stats_rec,
                                          override_source is None)
            self._adaptive_write_bytes = stats_rec.total_bytes() or None
            reader = HostShuffleReader(handle, mgr, self._conf)
            split_plan, flat_groups = ({}, None) \
                if override_source is not None \
                else self._adaptive_read_plan(stats_rec, reader, handle,
                                              flat)
            dev = self.device
            if flat_groups is None:
                flat_groups = [[p] for p in range(self.n_partitions)]
            try:
                for ps in flat_groups:
                    yield _PartitionStream(
                        lambda ps=ps: self._read_group(reader, ps,
                                                       split_plan, dev),
                        lambda k=len(ps): mark_done(k))
            finally:
                state["outer_done"] = True
                cleanup_if_finished()
        except BaseException:
            # a write-phase failure or an outer stream closed early: the
            # files go now
            unregister()
            raise

    def _write_phase(self, source, bounds, handle, mgr, stats_rec=None,
                     capture: bool = True):
        """Write every map batch of `source`; returns the exchange's
        ExchangeRecorder (its measured bytes feed the read plan): a new
        one, or `stats_rec` holding earlier maps. `capture` False writes
        no lineage."""
        from ..obs import events as obs_events
        from ..obs import phase as obs_phase
        from ..obs import stats as obs_stats
        from ..obs import telemetry
        in_batches = self.metrics[NUM_INPUT_BATCHES]
        in_rows = self.metrics[NUM_INPUT_ROWS]
        name = type(self).__name__
        if stats_rec is None:
            stats_rec = obs_stats.ExchangeRecorder(name, self._op_id,
                                                   self.n_partitions)
        map_id = 0
        try:
            for b in source:
                if self._map_device is None:
                    self._map_device = b.device
                in_batches.add(1)
                n = b.num_rows_host
                in_rows.add(n)
                # time the shuffle's own work, not the child's compute;
                # the writer's file IO is carved out of the span
                with self.metrics[SHUFFLE_WRITE_TIME].ns_timer(), \
                        obs_phase.span("host-pack-serialize"):
                    writer, lane, pack_ns, rows_pp = self._write_map(
                        b, n, bounds, handle, mgr, map_id)
                    obs_phase.add("shuffle-io", writer.io_ns)
                stats_rec.record_map(rows_pp, writer.partition_bytes,
                                     writer.bytes_written)
                telemetry.add("exchange.write_bytes", writer.bytes_written)
                if self._capture_lineage and capture:
                    handle.lineage[mgr.map_data_path(
                        handle.shuffle_id, map_id)] = \
                        self._make_recompute(handle, mgr, map_id)
                obs_events.emit("exchange", exec=name, op_id=self._op_id,
                                map_id=map_id,
                                partitions=self.n_partitions,
                                bytes=writer.bytes_written,
                                partitioning=self.partitioning)
                obs_events.emit("shuffle_write", exec=name,
                                op_id=self._op_id, map_id=map_id,
                                lane=lane, bytes=writer.bytes_written,
                                frames=writer.frames_written,
                                pack_ns=pack_ns,
                                serialize_ns=writer.serialize_ns,
                                io_ns=writer.io_ns)
                self.metrics[PARTITION_SIZE].add(writer.bytes_written)
                self.metrics[SHUFFLE_SERIALIZE_TIME].add(writer.serialize_ns)
                self.metrics[SHUFFLE_COMPRESS_TIME].add(writer.compress_ns)
                self.metrics[SHUFFLE_IO_TIME].add(writer.io_ns)
                self.metrics[NUM_FRAMES].add(writer.frames_written)
                self.metrics[RAW_BYTES].add(writer.raw_bytes)
                map_id += 1
            stats_rec.finish_and_emit()
        finally:
            close = getattr(source, "close", None)
            if close is not None:
                close()
        return stats_rec

    def _make_recompute(self, handle, mgr, map_id: int):
        """The lineage of map output `map_id`: a zero-argument closure
        that re-runs the child from its sources and rewrites only that
        output, in place and on its original lane, so the frame layout
        and the fault keys stay valid. The round-robin cursor replays
        from zero over the skipped batches (hash and single pids are
        stateless). The reader calls it under the handle's recover_lock,
        so two recomputes never share the cursor."""

        def recompute() -> None:
            saved_rr = self._rr_offset
            self._rr_offset = 0
            try:
                src = self.child.execute()
                try:
                    for i, b in enumerate(src):
                        n = b.num_rows_host
                        if i < map_id:
                            if self.partitioning == "roundrobin":
                                self._rr_offset = \
                                    (self._rr_offset + n) % self.n_partitions
                            continue
                        self._write_map(b, n, None, handle, mgr, map_id,
                                        register=False)
                        return
                    raise RuntimeError(
                        f"partition recovery: the child gave no batch "
                        f"{map_id} on re-execution")
                finally:
                    src.close()
            finally:
                self._rr_offset = saved_rr

        return recompute

    # -- the device lane over the mesh -------------------------------------
    def _ici_eligible(self) -> bool:
        """May this execution take the device lane? The conf, a partitioning
        the device computes (range bounds are host objects), no array or
        map payload (the lane carries fixed-width, string, struct and
        decimal128 columns), an active mesh whose shards are the
        partitions, a closed `ici_exchange` breaker, and no armed skew
        split (a stand-down counted and emitted as a fallback). No is
        the host lane, which is always right."""
        from ..parallel.mesh import active_mesh, mesh_axis_size
        from ..types import ArrayType, MapType, StructType
        if not self._ici_enabled or self.n_partitions <= 1:
            return False
        if self.partitioning not in ("hash", "roundrobin", "single"):
            return False

        def collective_ok(dt) -> bool:
            if isinstance(dt, (ArrayType, MapType)):
                return False
            if isinstance(dt, StructType):
                return all(collective_ok(f.data_type) for f in dt.fields)
            return True

        if not all(collective_ok(f.data_type)
                   for f in self.output_schema.fields):
            return False
        mesh = active_mesh()
        if mesh is None or mesh_axis_size(mesh) != self.n_partitions \
                or mesh.devices.size != self.n_partitions:
            return False
        from . import lifecycle
        if not lifecycle.breaker_allows("ici_exchange"):
            return False
        if self._adaptive_probe_split and self._adaptive_enabled \
                and self._skew_factor > 0:
            from ..obs import events as obs_events
            from ..shuffle.manager import note_ici_exchange
            note_ici_exchange(fallbacks=1)
            obs_events.emit("ici_exchange", exec=type(self).__name__,
                            op_id=self._op_id, fallback=True,
                            reason="adaptive_skew_split")
            return False
        self._ici_mesh = mesh
        return True

    def _ici_pid(self, local: ColumnarBatch, rr_off: int) -> torch.Tensor:
        """A shard's pids: the hash of its keys, or round robin from the
        cursor at its batch's first row (the host lane's assignment), or
        partition 0; inactive rows get n."""
        from ..ops.basic import active_mask
        n = self.n_partitions
        if self.partitioning == "hash":
            return self._pid_kernel(local)
        act = active_mask(local.num_rows, local.capacity, local.device)
        if self.partitioning == "roundrobin":
            iota = torch.arange(local.capacity, dtype=torch.int64,
                                device=local.device)
            return torch.where(act, (iota + rr_off) % n, n).to(torch.int32)
        return torch.where(act, 0, n).to(torch.int32)

    def _ici_exchange_round(self, batches, rr_offs, round_idx: int):
        """One round: one map batch a shard, in map order (empty batches
        pad the rest), so partition p receives its rows in the host lane's
        map order. Returns (the n received shard batches, the
        (shards, partitions) rows of each map batch)."""
        from ..obs import events as obs_events
        from ..obs import phase as obs_phase
        from ..shuffle.manager import note_ici_exchange
        from . import lifecycle, speculation_shield
        n = self.n_partitions
        rr = list(rr_offs) + [0] * (n - len(rr_offs))
        lifecycle.engage_domain("ici_exchange")
        t0 = time.perf_counter_ns()
        # the round is the fault seam (key: its ordinal) and the
        # ici-collective phase; a hang-bounded dispatch inside it names
        # the ici_exchange domain
        with obs_phase.span("ici-collective"), \
                speculation_shield.dispatch_domain("ici_exchange"), \
                self.batch_harness(fault_key=f"r{round_idx}",
                                   fault_point="shuffle.ici_exchange"):
            shards, per_map, slot_cap, width = _mesh_round(
                self._ici_mesh, list(batches), self.output_schema,
                lambda d, b: self._ici_pid(b, rr[d]), self._ici_hints)
        collective_ns = time.perf_counter_ns() - t0
        moved = sum(b.nbytes for b in shards)
        rows = int(per_map.sum())
        self.metrics[SHUFFLE_PACK_TIME].add(collective_ns)
        self.metrics[NUM_HOST_READS].add(1)
        self.metrics[NUM_ROUNDS].add(1)
        note_ici_exchange(rounds=1, batches=len(batches), bytes=moved,
                          collective_ns=collective_ns, host_reads=1)
        obs_events.emit("ici_exchange", exec=type(self).__name__,
                        op_id=self._op_id, round=round_idx, partitions=n,
                        batches=len(batches), rows=rows, bytes=moved,
                        slot_cap=slot_cap, width=width,
                        fill=round(rows / float(n * n * slot_cap), 4),
                        collective_ns=collective_ns)
        return shards, per_map

    def _execute_partitions_ici(self) -> Iterator[Iterator[ColumnarBatch]]:
        """The device lane: the child's batches in rounds of one a shard,
        each round measured and exchanged, its received shards staged as
        SpillableBatches tagged `ici_exchange`. A classified-transient
        failure of the round itself (not of the child's stream, which
        propagates as on the host lane: a generator that raised is
        finished, and its unread batches would be lost) counts against
        the breaker, and the rest of the stream takes the host lane."""
        from .. import faults
        from ..obs import events as obs_events
        from ..obs import stats as obs_stats
        from ..shuffle.manager import note_ici_exchange
        from . import lifecycle
        n = self.n_partitions
        devs = self._ici_mesh.shard_devices
        in_batches = self.metrics[NUM_INPUT_BATCHES]
        in_rows = self.metrics[NUM_INPUT_ROWS]
        self._rr_offset = 0
        self._ici_hints = [0, 8]
        staged: List[list] = [[] for _ in range(n)]
        pending: List[ColumnarBatch] = []
        rr_offs: List[int] = []
        state = {"rows": 0, "round": 0, "fell_back": False, "totals": None}
        stats_rec = obs_stats.ExchangeRecorder(type(self).__name__,
                                               self._op_id, n)

        def try_flush() -> bool:
            # only the round itself is inside the degradation seam: once
            # its shards are in hand they are staged (replaying the
            # batches on the host lane after that would duplicate rows)
            try:
                with self.metrics[SHUFFLE_WRITE_TIME].ns_timer():
                    shards, per_map = self._ici_exchange_round(
                        pending, rr_offs, state["round"])
            except Exception as e:  # noqa: BLE001 — the degradation seam
                if not faults.is_task_transient(e):
                    raise
                lifecycle.record_domain_failure("ici_exchange")
                note_ici_exchange(fallbacks=1)
                obs_events.emit("ici_exchange", exec=type(self).__name__,
                                op_id=self._op_id, round=state["round"],
                                fallback=True, error=str(e)[:200])
                # the failed round's batches replay on the host lane from
                # the cursor at its first batch
                if rr_offs:
                    self._rr_offset = rr_offs[0]
                state["fell_back"] = True
                return False
            _stage(staged, shards, origin="ici_exchange")
            totals = per_map.sum(axis=0)
            state["totals"] = totals if state["totals"] is None \
                else state["totals"] + totals
            # one stats record a map batch (the host lane's granularity)
            for d in range(len(pending)):
                stats_rec.record_map(per_map[d].tolist(), None, 0)
            in_batches.add(len(pending))
            in_rows.add(state["rows"])
            state["round"] += 1
            state["rows"] = 0
            del pending[:], rr_offs[:]
            return True

        source = self.child.execute()
        try:
            for b in source:
                if self._map_device is None:
                    self._map_device = b.device
                rows = b.num_rows_host
                rr_offs.append(self._rr_offset)
                if self.partitioning == "roundrobin":
                    self._rr_offset = (self._rr_offset + rows) % n
                pending.append(b)
                state["rows"] += rows
                if len(pending) == n and not try_flush():
                    break
            if not state["fell_back"] and pending:
                try_flush()
        except BaseException:
            source.close()
            for pieces in staged:
                _close_pieces(pieces)
            raise
        if state["totals"] is not None:
            max_part = int(state["totals"].max())
            self.metrics[PARTITION_SIZE].add(max_part)
            obs_events.emit("exchange", exec=type(self).__name__,
                            op_id=self._op_id, partitions=n,
                            rounds=state["round"], lane="ici",
                            max_partition_rows=max_part,
                            partitioning=self.partitioning)
        if not state["fell_back"]:
            source.close()
            stats_rec.finish_and_emit()
            lifecycle.record_domain_success("ici_exchange")
            yield from _staged_partitions(self, staged, devs, "ici-read")
            return
        # the hybrid drain: the staged rounds hold the earlier map
        # batches, the host lane the rest; the recorder rides into the
        # host lane, which emits the execution's one exchange_stats
        host_parts = self._execute_partitions_host(
            override_source=_chain_rest(list(pending), source),
            stats_rec=stats_rec)
        yield from _staged_partitions(self, staged, devs, "ici-read",
                                      host_parts)

    # -- the adaptive read plan --------------------------------------------
    def _adaptive_read_plan(self, stats_rec, reader, handle, flat: bool):
        """({partition: map groups} to skew-split, the flat stream's
        partition groups or None), from the write's measured bytes. Never
        raises: a failure counts against the `adaptive` breaker domain
        and the static plan runs."""
        from . import adaptive
        op = type(self).__name__
        try:
            per_part = stats_rec.partition_bytes()
            if self.n_partitions <= 1 or per_part is None:
                return {}, None
            if not adaptive.consult(self._conf, op=op, op_id=self._op_id):
                return {}, None
            split_plan = {}
            thr = adaptive.skew_threshold(per_part, self._skew_factor,
                                          self._skew_min_bytes)
            if thr is not None and len(handle.map_outputs) > 1:
                threshold, median = thr
                for p, b in enumerate(per_part):
                    if b <= threshold:
                        continue
                    groups = reader.plan_map_groups(p, threshold)
                    if len(groups) <= 1:
                        continue
                    split_plan[p] = groups
                    adaptive.note_decision(
                        "skew_split", op=op, op_id=self._op_id,
                        partition=p, bytes=b, threshold=threshold,
                        median_bytes=median, subs=len(groups),
                        max_sub_bytes=max(g[1] for g in groups))
            flat_groups = None
            if flat and self._coalesce_target > 0:
                flat_groups = adaptive.coalesce_groups(
                    per_part, self._coalesce_target,
                    exclude=set(split_plan))
                if flat_groups is not None:
                    adaptive.note_decision(
                        "partition_coalesce", op=op, op_id=self._op_id,
                        partitions=self.n_partitions,
                        reads=len(flat_groups),
                        target_bytes=self._coalesce_target)
            return split_plan, flat_groups
        except Exception as e:  # noqa: BLE001 — a replan must not kill
            adaptive.note_error(op=op, op_id=self._op_id, error=e)
            return {}, None

    def _read_group(self, reader, ps: Sequence[int], split_plan, dev
                    ) -> Iterator[ColumnarBatch]:
        """The stream of partitions `ps` (one, or a coalesced run), each
        read whole or as its skew split's sub-reads."""
        for p in ps:
            yield from self._read_partition(reader, p, dev,
                                            split_plan.get(p))

    def _read_partition(self, reader, p: int, dev, groups=None
                        ) -> Iterator[ColumnarBatch]:
        """Stream one partition's decoded blocks, pipelined: the fetch and
        LZ4 decode (on the reader pool) and the upload of block k+1 run on
        the producer thread while the consumer computes on block k;
        shuffleReadTime counts only the time this operator blocked
        waiting for a block. A skew-split partition (`groups`) reads its
        sub-reads one after another, each its own stage, so the decode
        window is one sub-read; their blocks in order are the unsplit
        read's."""
        from ..columnar.upload import await_upload, promote_stream
        read_time = self.metrics[SHUFFLE_READ_TIME]
        out_batches = self.metrics[NUM_OUTPUT_BATCHES]
        frames_read = self.metrics[NUM_FRAMES_READ]
        if groups is None:
            sources = [lambda: reader.read_partition(p)]
        else:
            ordinal = [0]
            sources = [lambda sub=sub, paths=paths:
                       reader.read_partition_maps(p, paths, sub, ordinal)
                       for sub, (paths, _b) in enumerate(groups)]
        saw = False
        for open_source in sources:
            stage = self.pipeline_stage(
                promote_stream(open_source(), dev,
                               num_metric=self.metrics[NUM_UPLOADS],
                               time_metric=self.metrics[UPLOAD_PACK_TIME]),
                "shuffle-read")
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

    def _fingerprint_extras(self):
        # a pass-through at the body level: the extras keep parent
        # subtrees over a broadcast build side cacheable
        return ()

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
    kernel launches on zero rows there.

    Adaptive (exec/adaptive.py, when both children are host exchanges
    and adaptive.autoBroadcastMaxBytes >= 0): the build exchange runs
    first, and when its write measures at or under the cap the join
    converts to one single-build pass: the whole build against the
    stream exchange's child, read straight (that exchange is skipped),
    sized once (partition -1). The union of the pairs' joins is the
    join, so only the row order changes. Otherwise the pairs run as
    above, and the stream exchange's skewed partitions arrive as
    sub-reads, each a run of probe windows against the pair's build."""

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
        stream_child, build_child = (self.children[0], self.children[1]) \
            if build_right else (self.children[1], self.children[0])
        if isinstance(stream_child, HostShuffleExchangeExec):
            # the skew split may cut the stream side's partitions into
            # map-granular sub-reads, which need the host lane's files
            stream_child._adaptive_probe_split = True
        build_parts = self._measured_build(stream_child, build_child)
        if build_parts is None:
            lit_ = self.children[0].execute_partitions()
            rit = self.children[1].execute_partitions()
        else:
            if build_parts[0]:
                yield from self._single_build(
                    build_parts[1], stream_child, stream_unmatched,
                    build_unmatched)
                return
            build_it = _streams_of(build_parts[1])
            stream_it = stream_child.execute_partitions()
            lit_, rit = (stream_it, build_it) if build_right \
                else (build_it, stream_it)
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
                yield from self._pair(stream, build, pid, stream_unmatched,
                                      build_unmatched)
        finally:
            lit_.close()
            rit.close()

    def _measured_build(self, stream_child, build_child):
        """None, or (convert?, the build exchange's partition streams)
        once the build side was written and measured against
        adaptive.autoBroadcastMaxBytes."""
        if not (isinstance(stream_child, HostShuffleExchangeExec)
                and isinstance(build_child, HostShuffleExchangeExec)):
            return None
        from . import adaptive
        from ..config import ADAPTIVE_ENABLED
        conf = build_child._conf
        cap = adaptive.auto_broadcast_max(conf) \
            if conf.get(ADAPTIVE_ENABLED) else -1
        if cap < 0 or not adaptive.consult(conf, op=type(self).__name__,
                                           op_id=self._op_id):
            return None
        parts = list(build_child.execute_partitions())
        measured = build_child._adaptive_write_bytes
        convert = measured is not None and measured <= cap
        if convert:
            adaptive.note_decision(
                "single_build_convert", op=type(self).__name__,
                op_id=self._op_id, measured_bytes=measured, threshold=cap)
        return convert, parts

    def _pair(self, stream, build, pid, stream_unmatched: bool,
              build_unmatched: bool) -> Iterator[ColumnarBatch]:
        """Join one partition pair (or, from `_single_build`, the whole
        build against the whole stream), skipping it where it can emit
        nothing."""
        join = self._join
        batches = list(self._nonempty(build))
        rows = self._nonempty(stream)
        first = None
        if batches or stream_unmatched:
            first = next(rows, None)
        if (not batches and not stream_unmatched) or (
                first is None and not build_unmatched):
            rows.close()
            stream.close()
            return
        scan_s, scan_b = (self._lscan, self._rscan) \
            if join.build_side == "right" else (self._rscan, self._lscan)
        scan_b.set_batches(batches)
        scan_s.set_stream(self._counted(first, rows)
                          if first is not None else _no_batches())
        self.metrics[NUM_PARTITION_PAIRS].add(1)
        join.partition = pid
        yield from join.execute()

    def _single_build(self, build_streams, stream_child,
                      stream_unmatched: bool, build_unmatched: bool
                      ) -> Iterator[ColumnarBatch]:
        """The converted pass: every build partition's blocks as one
        build, the stream exchange's child as the stream."""
        build = _chain_streams(build_streams)
        stream = stream_child.child.execute()
        try:
            yield from self._pair(stream, build, -1, stream_unmatched,
                                  build_unmatched)
        finally:
            build.close()
            stream.close()


def _streams_of(streams) -> Iterator:
    """A list of partition streams as a closable iterator: closing it
    closes the streams not handed out."""
    pending = list(streams)
    try:
        while pending:
            yield pending.pop(0)
    finally:
        for st in pending:
            st.close()


def _chain_streams(streams) -> Iterator[ColumnarBatch]:
    """The batches of several partition streams, in order; closing it
    closes them all."""
    pending = list(streams)
    try:
        while pending:
            st = pending.pop(0)
            try:
                yield from st
            finally:
                st.close()
    finally:
        for st in pending:
            st.close()


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
