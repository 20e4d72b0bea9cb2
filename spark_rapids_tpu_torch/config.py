"""Typed config registry — the counterpart of spark_rapids_tpu/config.py
(the reference's RapidsConf.scala).

Every entry of the JAX package is registered here with its key, default,
doc and converter, so the port accepts and rejects the same keys:
`RapidsConf` raises KeyError on an unknown `spark.rapids.*` key, and the
dynamic `spark.rapids.sql.{exec,expression,input,format}.` prefixes are
allowed. `generate_docs()` renders the same table as the JAX package's.

An entry the port reads is read where the JAX package reads it: at
construction of the object it configures (the aggregate's bucket
settings, a shuffle exchange's conf, a pipeline stage's close timeout),
never on a pool or producer thread, because `active_conf()` is
thread-local. The entries with no reader in the port yet are below, each
with the ROADMAP item whose module will read it and the values the port
honours today. The default is always honoured: it is what the port does.
A value outside that set would change what a query computes, where it
runs or what it reports, and `RapidsConf` raises NotImplementedError
naming the item (`_UNREAD`); nothing is ignored silently.

| Key (`spark.rapids.` omitted) | Item | Honoured |
| --- | --- | --- |
| `sql.explain`, `sql.reader.batchSizeRows`, `sql.stableSort.enabled`, `sql.improvedFloatOps.enabled` | none: the JAX package reads them in no operator either | any |
| `tpu.pallas.enabled` | not ported by design (ROADMAP A: the port has no tier switch) | true |
| `tpu.pallas.fusedTier` | not ported by design | auto, on |
| `tpu.pallas.fusedTier.benchFile` | not ported by design | default |

The ingest reads `tpu.transfer.packedUpload.enabled` at each upload
(columnar/upload.to_device_batch: false selects the per-buffer lane) and
`sql.format.parquet.datetimeRebaseModeInRead` when a Parquet source is
built (io/parquet.ParquetSource: LEGACY rebases its dates and
timestamps), as the JAX package does.

The stage compiler reads `tpu.stage.fusion.enabled` (TpuOverrides.apply,
and the plan fingerprint's conf digest) and the program-site cache reads
`tpu.stage.programCache.maxSites` (obs/dispatch.instrument), as the JAX
package does: on the card a compiled stage's step is a CUDA graph.

The governance planes read their entries where the JAX package does:
`tpu.test.faults` (faults.configure), `tpu.eventLog.*`
(obs/events.configure), `tpu.telemetry.*` (obs/telemetry.configure),
`tpu.dispatch.ledger.enabled` and `tpu.dispatch.storm.*`
(obs/dispatch.configure), `tpu.profile.*` (utils/tracing.profile_trace),
`sql.metrics.level` (TpuExec.all_metrics and the query profile),
`tpu.phases.enabled`, `tpu.task.*`, `tpu.query.*`, `tpu.breaker.*` and
`tpu.workload.*` (the governed `DataFrame.collect()`: exec/lifecycle.py,
exec/workload.py, exec/task_retry.py), `tpu.history.*`
(obs/history.configure), `tpu.stall.*` (speculation_shield.watchdog_for,
at each collect), `tpu.shuffle.speculation.*` and
`tpu.task.partitionRecovery.enabled` (the shuffle reader, at its
construction), `tpu.dispatch.timeoutMs` (obs/dispatch.configure).

The planner reads `tpu.adaptive.enabled` and
`adaptive.autoBroadcastMaxBytes` for the broadcast cap, as the JAX
package's `_convert_join` does, and AdaptiveJoinExec reads them for its
measured demotion (exec/adaptive.py); the host exchange reads
`adaptive.{skewedPartitionFactor,skewedPartitionMinBytes,
coalesceTargetBytes}` at its construction (skew splits, coalesced reads)
and ShuffledHashJoinExec the cap for its single-build conversion. The planner
reads `sql.cpuFallback.enabled` (a Project or Filter without a device
path runs on the host row engine), `sql.optimizer.enabled` (the
cost-based placement, plan/cost.py) and `sql.udfCompiler.enabled` (the
UDF compiler, udf_compiler).

The mesh lane reads its entries where the JAX package does: the planner
`tpu.shuffle.planExchange` (`_plan_mesh`), ShuffleExchangeExec
`sql.exchange.roundBytes` (its rounds), the host exchange
`tpu.shuffle.ici.enabled` and `tpu.shuffle.devicePartition.enabled` at
its construction, and the heartbeat's dead-peer hook
`tpu.shuffle.deadPeerInvalidation.enabled`
(exec/speculation_shield.on_peer_dead).

The failure dump reads `sql.debug.dumpPath` where the JAX package does:
TpuExec.execute retains each operator's last output only while it is
set, and a failing child pull dumps them (exec/base.py, utils/dump.py).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple


class ConfEntry:
    def __init__(self, key: str, default, doc: str, conv: Callable[[str], Any],
                 internal: bool = False, startup_only: bool = False,
                 commonly_used: bool = False):
        self.key = key
        self.default = default
        self.doc = doc
        self.conv = conv
        self.internal = internal
        self.startup_only = startup_only
        self.commonly_used = commonly_used

    def get(self, conf: "RapidsConf"):
        raw = conf._settings.get(self.key)
        if raw is None:
            return self.default
        if isinstance(raw, str):
            return self.conv(raw)
        return raw


_REGISTRY: Dict[str, ConfEntry] = {}


def _register(entry: ConfEntry) -> ConfEntry:
    assert entry.key not in _REGISTRY, f"duplicate conf {entry.key}"
    _REGISTRY[entry.key] = entry
    return entry


def _bool(s: str) -> bool:
    return s.strip().lower() in ("true", "1", "yes")


def _bytes(s: str) -> int:
    s = s.strip().lower()
    mult = 1
    for suffix, m in (("k", 1 << 10), ("m", 1 << 20), ("g", 1 << 30),
                      ("t", 1 << 40)):
        if s.endswith(suffix + "b"):
            s, mult = s[:-2], m
            break
        if s.endswith(suffix):
            s, mult = s[:-1], m
            break
    return int(float(s) * mult)


def conf_bool(key, default, doc, **kw):
    return _register(ConfEntry(key, default, doc, _bool, **kw))


def conf_int(key, default, doc, **kw):
    return _register(ConfEntry(key, default, doc, int, **kw))


def conf_float(key, default, doc, **kw):
    return _register(ConfEntry(key, default, doc, float, **kw))


def conf_str(key, default, doc, **kw):
    return _register(ConfEntry(key, default, doc, str, **kw))


def conf_bytes(key, default, doc, **kw):
    return _register(ConfEntry(key, default, doc, _bytes, **kw))



# --- core entries (mirroring the reference's most load-bearing keys) ------

SQL_ENABLED = conf_bool(
    "spark.rapids.sql.enabled", True,
    "Master toggle: when false every operator stays on the CPU path "
    "(reference RapidsConf.scala SQL_ENABLED).", commonly_used=True)

EXPLAIN = conf_str(
    "spark.rapids.sql.explain", "NOT_ON_GPU",
    "Explain mode: NONE, NOT_ON_GPU (log why operators fell back), ALL "
    "(reference sql.explain).", commonly_used=True)

BATCH_SIZE_BYTES = conf_bytes(
    "spark.rapids.sql.batchSizeBytes", 1 << 30,
    "Target output batch size; on TPU this is the target *padded capacity "
    "bucket* footprint (reference RapidsConf.scala:559).", commonly_used=True)

EXCHANGE_ROUND_BYTES = conf_bytes(
    "spark.rapids.sql.exchange.roundBytes", 1 << 28,
    "Per-round input budget for the mesh shuffle exchange: child batches "
    "stream through the ICI collective in fixed-size rounds with "
    "spillable staging instead of materializing the whole stage input "
    "(round-2 verdict item 6; reference bounds the same path with "
    "spillable shuffle buffers).")

MAX_READER_BATCH_SIZE_ROWS = conf_int(
    "spark.rapids.sql.reader.batchSizeRows", 1 << 20,
    "Soft cap on rows per scan batch (reference reader.batchSizeRows).")

CONCURRENT_TPU_TASKS = conf_int(
    "spark.rapids.sql.concurrentGpuTasks", 2,
    "Admission-semaphore width: concurrent tasks allowed to issue device "
    "work (reference RapidsConf.scala:544 concurrentGpuTasks; on TPU this "
    "gates enqueue into the per-chip executor).", commonly_used=True)

HBM_POOL_FRACTION = conf_float(
    "spark.rapids.memory.tpu.allocFraction", 0.9,
    "Fraction of device HBM the engine budget manager may use (reference "
    "rmm allocFraction).", startup_only=True)

HBM_BUDGET_BYTES = conf_bytes(
    "spark.rapids.memory.tpu.budgetBytes", 0,
    "Absolute HBM budget override; 0 = derive from allocFraction and "
    "detected device memory.", startup_only=True)

HOST_SPILL_LIMIT = conf_bytes(
    "spark.rapids.memory.host.spillStorageSize", 4 << 30,
    "Bytes of host memory for spilled buffers before overflowing to disk "
    "(reference host.spillStorageSize).")

SPILL_DIR = conf_str(
    "spark.rapids.memory.spillDirectory", "",
    "Directory for disk-tier spill files; empty = system temp.")

RETRY_MAX_ATTEMPTS = conf_int(
    "spark.rapids.sql.retry.maxAttempts", 10,
    "Upper bound on OOM-retry attempts before surfacing the failure "
    "(guards the withRetry loop, reference RmmRapidsRetryIterator).")

SHUFFLE_MODE = conf_str(
    "spark.rapids.shuffle.mode", "MULTITHREADED",
    "Shuffle mode: MULTITHREADED (host, works everywhere), ICI (resident "
    "mesh all-to-all over interconnect), CACHE_ONLY (reference "
    "RapidsShuffleManagerMode).", commonly_used=True)

BROADCAST_SIZE_THRESHOLD = conf_bytes(
    "spark.rapids.sql.broadcastSizeThreshold", 10 << 20,
    "Max estimated build-side bytes for planning a broadcast hash join "
    "instead of exchanging both sides (Spark's "
    "spark.sql.autoBroadcastJoinThreshold; reference "
    "GpuBroadcastHashJoinExecBase). -1 disables broadcast planning.",
    commonly_used=True)

SHUFFLE_PLAN_EXCHANGE = conf_bool(
    "spark.rapids.tpu.shuffle.planExchange", True,
    "Plan distributed stages when a multi-device mesh is active (session "
    "mesh_devices / parallel.mesh.set_active_mesh): group-bys become "
    "partial → ICI all-to-all exchange → final, equi-joins become "
    "exchange-both-sides → per-partition shuffled hash join (reference "
    "GpuShuffleExchangeExecBase planning).", commonly_used=True)

OPTIMIZER_ENABLED = conf_bool(
    "spark.rapids.sql.optimizer.enabled", False,
    "Cost-based device-vs-host placement: device-eligible Project/Filter "
    "sections whose modeled host cost (row interpreter + transitions) "
    "beats the device cost (program dispatch + bandwidth) run on the "
    "host row engine — tiny inputs, mainly (reference "
    "CostBasedOptimizer.scala, also default-off).")

PALLAS_ENABLED = conf_bool(
    "spark.rapids.tpu.pallas.enabled", True,
    "Use hand-written Pallas TPU kernels for hash hotspots (murmur3 "
    "partition/join/group-by hashing) instead of the fused-XLA path "
    "when running on real TPU hardware (SURVEY §2.9 Pallas tier; "
    "reference analog: spark-rapids-jni hand-tuned CUDA Hash kernels). "
    "Off-TPU backends always use the XLA path; tests drive the kernel "
    "via the Pallas interpreter for bit-exactness.")

PALLAS_FUSED_TIER = conf_str(
    "spark.rapids.tpu.pallas.fusedTier", "auto",
    "Fused Pallas kernel tier for the join-probe and scan-aggregate hot "
    "paths: 'off' keeps the XLA formulations, 'on' forces the fused "
    "kernels (interpret-mode off-TPU — the correctness/test setting), "
    "'auto' (default) consults the per-shape-bucket XLA-vs-Pallas "
    "timings recorded by tools/kern_bench.py and picks the measured "
    "winner; with no recorded measurement for a shape the XLA tier "
    "stays — the tier choice is a measurement, not a guess.",
    commonly_used=True)

PALLAS_FUSED_BENCH_FILE = conf_str(
    "spark.rapids.tpu.pallas.fusedTier.benchFile", "",
    "Path of the kernel-microbenchmark record file driving "
    "fusedTier=auto (written by tools/kern_bench.py). Empty = "
    "tools/kern_bench.json next to the package if present.")

DEBUG_DUMP_PATH = conf_str(
    "spark.rapids.sql.debug.dumpPath", "",
    "When set, operators wrapped in dump_on_error write their input "
    "batches (parquet + metadata) and a repro script there on failure "
    "(reference DumpUtils.scala / spark.rapids.sql.debug dump hooks). "
    "Empty disables dumping.")

UDF_COMPILER_ENABLED = conf_bool(
    "spark.rapids.sql.udfCompiler.enabled", False,
    "Decompile Python UDF bytecode into device expressions when possible "
    "(the reference's udf-compiler module / "
    "spark.rapids.sql.udfCompiler.enabled). Compiled UDFs use SQL null "
    "semantics (NULL propagates) rather than raising on None — opt-in, "
    "like the reference.", commonly_used=True)

CPU_FALLBACK_ENABLED = conf_bool(
    "spark.rapids.sql.cpuFallback.enabled", True,
    "Run Project/Filter nodes whose expressions have no device kernel on "
    "the host row engine (ColumnarToRow → host operator → RowToColumnar), "
    "instead of failing the whole plan — the reference's per-operator "
    "convertToCpu fallback (GpuOverrides.scala:4427). Only expressions "
    "the host interpreter implements fall back; others still fail with "
    "the full explain report.", commonly_used=True)

JOIN_SUBPARTITION_THRESHOLD = conf_bytes(
    "spark.rapids.sql.join.subPartitionThreshold", 1 << 30,
    "When a join BUILD side's estimated size exceeds this, the planner "
    "splits the join into hash sub-partitions via the host shuffle so "
    "each sub-partition's build side fits device memory — the "
    "reference's GpuSubPartitionHashJoin.scala:547 big-build-side "
    "strategy. Requires shuffle mode MULTITHREADED; raises (never "
    "lowers) spark.rapids.sql.shuffle.partitions. -1 disables.",
    commonly_used=True)

SHUFFLE_PARTITIONS = conf_int(
    "spark.rapids.sql.shuffle.partitions", 1,
    "Partition count for host-shuffled stages (Spark's "
    "spark.sql.shuffle.partitions). With no multi-device mesh, a value "
    "> 1 plans group-bys and equi-joins through the MULTITHREADED host "
    "shuffle (partial → host exchange → final), bounding device memory "
    "per partition — the out-of-core repartition path.",
    commonly_used=True)

SHUFFLE_DEVICE_PARTITION = conf_bool(
    "spark.rapids.tpu.shuffle.devicePartition.enabled", True,
    "Device-side shuffle partition split for the MULTITHREADED host "
    "shuffle writer (exec/exchange.py + ops/partition_split.py): the "
    "hash/roundrobin/single lanes compute per-partition counts and a "
    "pid-stable permutation on device, reorder the batch into "
    "partition-major order through the gather engine (ops/gather.py — "
    "tier-aware: the Pallas DMA gather when the `gather` family has a "
    "recorded win, the XLA packed row gather otherwise), land it on the "
    "host as ONE packed D2H copy (columnar/transfer.py) and serialize "
    "each partition directly from a row-range slice "
    "(shuffle/serializer.serialize_slice) — zero host-side row gathers "
    "per written batch (the reference's GpuHashPartitioning + "
    "contiguous_split + JCudfSerialization shape). Range partitioning "
    "keeps the host lane (its sampled split bounds are host objects). "
    "Off restores the host argsort-and-slice partitioner.",
    commonly_used=True)

SHUFFLE_ICI_ENABLED = conf_bool(
    "spark.rapids.tpu.shuffle.ici.enabled", False,
    "ICI-native device-resident shuffle lane for the host shuffle "
    "exchange (exec/exchange.py + parallel/exchange.py, ISSUE 16): when "
    "an active mesh's axis size equals the exchange's partition count, "
    "map output is hash-partitioned, packed into a measured "
    "(partitions, slot_cap) send grid and exchanged device-to-device "
    "with jax.lax.all_to_all over the mesh axis — zero host "
    "serialize/deserialize and zero per-batch D2H/H2D on the hot path "
    "(the reference's UCX/NVLink shuffle transport as an ICI "
    "collective). Received shards stage as spillable catalog entries, "
    "so the spill/quota contracts hold. The host serialize/LZ4 lane "
    "remains the fallback tier: range partitioning, mismatched "
    "partition counts, single-device runs, an open `ici_exchange` "
    "breaker, or a failed collective round degrade per exchange to the "
    "always-works host path. Default off: behavior is byte-identical "
    "to the host lane either way.",
    commonly_used=True)

UPLOAD_PACKED = conf_bool(
    "spark.rapids.tpu.transfer.packedUpload.enabled", True,
    "Packed host->device batch upload (columnar/upload.py — the ingest "
    "mirror of the packed D2H fetch): a decoded batch's row count and "
    "every column buffer are laid into ONE contiguous uint8 staging "
    "buffer drawn from a reusable capacity-bucketed pool, cross the "
    "host->device boundary as ONE transfer, and a jitted device program "
    "slices/bitcasts them back into column arrays — byte-identical to "
    "the per-buffer jnp.asarray lane. Wired at every ingest seam: scan "
    "batch upload, shuffle-read decode promotion, and spill unspill "
    "(the reference's JCudfSerialization / HostConcatResult one-copy "
    "table shape). Off, or for column trees the packer does not "
    "recognize, each buffer uploads individually (2-3 transfers per "
    "column).",
    commonly_used=True)

UPLOAD_POOL_BYTES = conf_bytes(
    "spark.rapids.tpu.transfer.packedUpload.poolBytes", 256 * 1024 * 1024,
    "Total bytes of IDLE staging buffers the packed-upload pool may "
    "retain (the pinned-host-memory analog). Buffers are "
    "capacity-bucketed powers of two, reused LIFO (cache-warm) and "
    "trimmed least-recently-used past this cap; in-flight buffers are "
    "never capped. 0 disables pooling (every upload allocates).")

SHUFFLE_WRITER_THREADS = conf_int(
    "spark.rapids.shuffle.multiThreaded.writer.threads", 8,
    "Writer-side serialization threads (reference "
    "RapidsShuffleInternalManagerBase.scala:238).")

SHUFFLE_READER_THREADS = conf_int(
    "spark.rapids.shuffle.multiThreaded.reader.threads", 8,
    "Reader-side fetch/decode threads (reference :569).")

PARQUET_READER_TYPE = conf_str(
    "spark.rapids.sql.format.parquet.reader.type", "MULTITHREADED",
    "Parquet reader strategy: MULTITHREADED (prefetch pool, one device "
    "upload per row group) or COALESCING (stitch small row groups "
    "host-side into ~batchSize tables before upload; reference "
    "GpuMultiFileReader.scala:830).")

PARQUET_REBASE_MODE_READ = conf_str(
    "spark.rapids.sql.format.parquet.datetimeRebaseModeInRead", "CORRECTED",
    "Datetime rebase for parquet reads: CORRECTED (values are proleptic "
    "Gregorian, pass through) or LEGACY (file was written by Spark < 3.0 "
    "in the hybrid Julian calendar; DATE/TIMESTAMP are rebased on device "
    "— reference datetimeRebaseUtils.scala + JNI DateTimeRebase).")

PARQUET_PUSHDOWN_ENABLED = conf_bool(
    "spark.rapids.sql.format.parquet.filterPushdown.enabled", True,
    "Push simple comparison conjuncts from a Filter into the parquet scan "
    "for footer min/max row-group pruning (reference "
    "GpuParquetScan predicate pushdown).")

SCAN_ENCODED = conf_bool(
    "spark.rapids.tpu.scan.encoded.enabled", True,
    "Dictionary-encoded execution (columnar/encoded.py, ISSUE 18): the "
    "parquet scan requests Arrow dictionary arrays for string columns "
    "and keeps them encoded as a DictionaryColumn — a device-resident "
    "i32 code lane plus the per-batch dictionary payload — instead of "
    "eagerly decoding to full-width strings at scan time. Codes + "
    "dictionary ride the packed H2D upload and spill/unspill as-is "
    "(typically a >=2x byte shrink on string-heavy scans), equality / "
    "IN / null predicates compare i32 codes on device, and hash joins "
    "hash the dictionary once then gather precomputed hashes by code. "
    "Operators that cannot consume encoded input trigger a "
    "materialize-at-boundary decode through the gather engine, so "
    "results are byte-identical with the lane on or off. Off restores "
    "eager decode at StringColumn.from_arrow.",
    commonly_used=True)

MULTITHREADED_READ_NUM_THREADS = conf_int(
    "spark.rapids.sql.multiThreadedRead.numThreads", 8,
    "Threads for the cloud multi-file readers (reference "
    "GpuMultiFileReader.scala:345). Sizes the ONE process-wide decode "
    "pool shared by every scan (io/multifile.py): concurrent scans and "
    "pipeline producer threads draw from it instead of multiplying "
    "thread counts with per-call pools.")

MULTITHREADED_READ_FETCH_AHEAD = conf_int(
    "spark.rapids.sql.multiThreadedRead.fetchAheadWindow", 0,
    "Decode tasks a multi-file reader may have in flight ahead of the "
    "consumer (the fetch-ahead window of the multithreaded cloud "
    "reader). 0 (default) = 2 x the reader's own thread count (its "
    "num_threads argument, not multiThreadedRead.numThreads).")

PIPELINE_ENABLED = conf_bool(
    "spark.rapids.tpu.pipeline.enabled", True,
    "Asynchronous pipelined execution (exec/pipeline.py): bounded "
    "producer threads overlap file decode + host->device transfer, "
    "shuffle-partition deserialization and coalesce accumulation with "
    "downstream device compute — the engine analog of the reference's "
    "multithreaded reader / async shuffle overlap. Results are "
    "bit-identical with pipelining on or off (tier-1 asserted); off "
    "degrades every boundary to the plain synchronous iterator.",
    commonly_used=True)

PIPELINE_DEPTH = conf_int(
    "spark.rapids.tpu.pipeline.depth", 2,
    "Batches a pipeline producer may queue ahead of its consumer at "
    "each pipelined stage boundary (the bounded prefetch window). "
    "Higher overlaps more at the cost of holding more batches live; "
    "0 behaves like pipeline.enabled=false.")

SPILL_ASYNC_WRITE = conf_bool(
    "spark.rapids.tpu.spill.asyncWrite", True,
    "Background spill writeback (memory/catalog.py): a tier hop hands "
    "the buffer to a single writer thread and releases the triggering "
    "operator immediately (device->host copy and host->disk write+fsync "
    "run behind the operator); readers of an in-flight buffer block "
    "until its writeback completes, so results are identical with the "
    "writer on or off. False restores fully synchronous spilling.")

PROFILE_ENABLED = conf_bool(
    "spark.rapids.tpu.profile.enabled", False,
    "Capture jax profiler traces (xprof/TensorBoard) around driven "
    "queries; operator names appear as trace annotations over their XLA "
    "ops (reference spark.rapids.profile.* NVTX integration).")

PROFILE_DIR = conf_str(
    "spark.rapids.tpu.profile.dir", "",
    "Output directory for captured profiler traces; empty = "
    "/tmp/spark_rapids_tpu_trace.")

METRICS_LEVEL = conf_str(
    "spark.rapids.sql.metrics.level", "MODERATE",
    "ESSENTIAL | MODERATE | DEBUG (reference GpuExec.scala:36-47): "
    "metric registries report only entries at or below this level — "
    "TpuExec.all_metrics(), last_query_metrics() and the query profile "
    "all honor it, so DEBUG metrics (per-operator input row/batch "
    "counts) stay out of summaries unless asked for.")

EVENT_LOG_ENABLED = conf_bool(
    "spark.rapids.tpu.eventLog.enabled", False,
    "Write the structured JSONL query event log (obs/events.py): query "
    "begin/end, per-operator open/batch/close spans with wall-ns and "
    "row/byte counts, semaphore waits, spill and OOM-retry events, "
    "Pallas tier decisions, plan fallback reasons, exchange transfer "
    "volumes. Off (default) costs one pointer check per batch — the "
    "analog of the reference's Spark-event/NVTX metric stream.",
    commonly_used=True)

EVENT_LOG_DIR = conf_str(
    "spark.rapids.tpu.eventLog.dir", "",
    "Directory for event-log files (one events-<pid>-<n>.jsonl per "
    "configured bus); empty = /tmp/spark_rapids_tpu_events. Render a "
    "log with tools/profile_report.py.")

EVENT_LOG_LEVEL = conf_str(
    "spark.rapids.tpu.eventLog.level", "MODERATE",
    "ESSENTIAL | MODERATE | DEBUG: event kinds above this level are "
    "dropped at emit time. ESSENTIAL = query begin/end only; MODERATE "
    "adds operator close spans, spills, retries, semaphore waits, tier "
    "and plan decisions, exchange volumes; DEBUG adds per-batch "
    "operator spans and span-API records.")

EVENT_LOG_MAX_BYTES = conf_bytes(
    "spark.rapids.tpu.eventLog.maxBytes", 0,
    "Rotate the JSONL event-log sink once the current file reaches this "
    "many bytes: the file closes and writing continues in "
    "events-<pid>-<n>.<rot>.jsonl (rot = 1, 2, ...), so a long soak or "
    "bench storm never grows one unbounded file. "
    "tools/profile_report.py reads a rotated set in order when given "
    "any member. 0 (default) = unbounded, no rotation.")

DISPATCH_LEDGER_ENABLED = conf_bool(
    "spark.rapids.tpu.dispatch.ledger.enabled", True,
    "Process-wide jit dispatch ledger (obs/dispatch.py): every engine "
    "program dispatch is counted per stable program key (owning "
    "exec/family x arg-shape bucket x platform) with first-trace vs "
    "cache-hit discrimination, trace/compile wall-ns and donated vs "
    "retained argument bytes; wired execs accumulate numDispatches / "
    "compileTimeNs metrics and QueryProfile.dispatch_summary() reads "
    "them as the whole-stage-compilation baseline. On (default) costs "
    "host-side bookkeeping per dispatch (noise against jit dispatch "
    "overhead); explicitly false = one pointer check per dispatch and "
    "no records. Results are byte-identical either way.")

DISPATCH_STORM_TRACES = conf_int(
    "spark.rapids.tpu.dispatch.storm.traces", 8,
    "Recompile-storm threshold: when one program key (see "
    "dispatch.ledger.enabled) is RE-traced this many times inside "
    "dispatch.storm.windowMs, the ledger emits one `recompile_storm` "
    "event (ESSENTIAL) — the shape-bucket-churn failure mode where "
    "every batch arrives with a new exact shape and every dispatch "
    "pays a fresh XLA compile. A program site's FIRST trace of a "
    "bucket is a new program, not churn, and never counts.")

DISPATCH_STORM_WINDOW_MS = conf_int(
    "spark.rapids.tpu.dispatch.storm.windowMs", 10000,
    "Sliding window for the recompile-storm detector. After a storm "
    "fires, the same program key stays quiet for one window (a storm "
    "is one incident, not one event per churning batch).")

TELEMETRY_ENABLED = conf_bool(
    "spark.rapids.tpu.telemetry.enabled", False,
    "Live telemetry registry + sampler (obs/telemetry.py): a "
    "`telemetry-sampler` thread snapshots per-owner HBM attribution, "
    "link bytes (H2D uploads / packed D2H fetches), admission queue "
    "depth, semaphore wait, breaker states and spill volumes every "
    "telemetry.intervalMs into bounded ring-buffer series, and flushes "
    "each snapshot to the event log (when enabled) as a "
    "`telemetry_sample` record — render with tools/telemetry_export.py "
    "(Prometheus text format). Off (default) costs one pointer check "
    "per push-counter site and no sampling thread.",
    commonly_used=True)

TELEMETRY_INTERVAL_MS = conf_int(
    "spark.rapids.tpu.telemetry.intervalMs", 1000,
    "Sampling period of the telemetry registry's exporter thread "
    "(min 10ms). Each tick reads every gauge source once — lock-light "
    "snapshots, no device syncs.")

TELEMETRY_HISTORY_SIZE = conf_int(
    "spark.rapids.tpu.telemetry.historySize", 120,
    "Samples each telemetry series retains in its in-memory ring "
    "buffer (TpuSession.health()['telemetry'] reads the newest; older "
    "samples survive only in the event log).")

PHASES_ENABLED = conf_bool(
    "spark.rapids.tpu.phases.enabled", True,
    "Per-query wall-clock phase attribution (obs/phase.py): every "
    "governed collect() carries a ledger partitioning its total "
    "wall-clock into the closed phase set (admission-wait, compile, "
    "device-compute, host-pack/serialize, shuffle-io, ici-collective, "
    "spill-wait, semaphore-wait, pipeline-stall, retry-backoff, other) "
    "with sum(phases) == wall_ns exactly. Surfaced via "
    "QueryProfile.phases(), the query_phases event (ESSENTIAL) and the "
    "query-history capsule. Explicitly false = one pointer check per "
    "accrual site, no ledger; results are byte-identical either way. "
    "The process-cumulative phase counters bench.py deltas stay on "
    "regardless (the runtime-statistics discipline).")

HISTORY_ENABLED = conf_bool(
    "spark.rapids.tpu.history.enabled", False,
    "Persistent query history (obs/history.py): at the end of every "
    "collect() append ONE self-describing JSONL capsule — plan "
    "fingerprint, phase ledger, essential metrics, statistics skew "
    "summary, dispatch/shuffle/upload deltas, outcome/priority/attempts "
    "— to history-<pid>-<n>.jsonl under history.dir. Capsules from "
    "different sessions and processes in one dir never collide and "
    "survive restarts; aggregate/diff/advise over a dir with "
    "tools/history_report.py. Off (default) costs one pointer check "
    "per collect.", commonly_used=True)

HISTORY_DIR = conf_str(
    "spark.rapids.tpu.history.dir", "",
    "Directory for query-history capsule files (one "
    "history-<pid>-<n>.jsonl per configured store); empty = "
    "/tmp/spark_rapids_tpu_history. Render with "
    "tools/history_report.py (aggregate per plan fingerprint, "
    "--diff BASE for phase-ranked regressions, advisor rules).")

HISTORY_MAX_BYTES = conf_bytes(
    "spark.rapids.tpu.history.maxBytes", 0,
    "Rotate the history capsule file once it reaches this many bytes: "
    "the file closes and writing continues in "
    "history-<pid>-<n>.<rot>.jsonl (the eventLog.maxBytes pattern); "
    "tools/history_report.py reads a rotated set in order. 0 (default) "
    "= unbounded, no rotation.")

SORT_OOC_ENABLED = conf_bool(
    "spark.rapids.sql.sort.outOfCore.enabled", True,
    "Bounded-memory streamed run merge for big sorts: runs stay spilled, "
    "only MERGE_FAN_IN chunks are device-resident at a time, and output "
    "batches emit as soon as they are globally final (reference "
    "GpuOutOfCoreSortIterator, GpuSortExec.scala:281).")

STABLE_SORT = conf_bool(
    "spark.rapids.sql.stableSort.enabled", False,
    "Force fully stable sorts (reference stableSort.enabled).")

IMPROVED_FLOAT_OPS = conf_bool(
    "spark.rapids.sql.improvedFloatOps.enabled", True,
    "Allow float results that differ from Spark in last-ulp ways — on TPU "
    "f64 is double-float emulated so this also gates f64-heavy plans "
    "(reference improvedFloatOps).")

TEST_RETRY_OOM_INJECTION_MODE = conf_str(
    "spark.rapids.sql.test.injectRetryOOM", "",
    "Fault injection: 'retry:N' / 'split:N' throws TpuRetryOOM / "
    "TpuSplitAndRetryOOM on the Nth guarded device call of each task "
    "(reference RmmSpark fault injection, RmmSparkRetrySuiteBase).",
    internal=True)

TEST_FAULTS = conf_str(
    "spark.rapids.tpu.test.faults", "",
    "Seeded chaos injection at the registered fault points (faults.py): "
    "'<point>:prob=P,seed=S,kind=io|device|corrupt|delay[,max=N]"
    "[,ms=N][;...]'. "
    "Decisions are a pure hash of (seed, point, task_id, call_index), "
    "so any chaos failure replays exactly. Empty (default) = injection "
    "off, one pointer check per site.", internal=True)

IO_RETRIES = conf_int(
    "spark.rapids.tpu.io.retries", 3,
    "Bounded retries on transient OSErrors in the multi-file readers "
    "and the shuffle block fetch (io/retrying.py) before the failure "
    "surfaces; each retry sleeps retryBackoffMs * 2^attempt plus "
    "deterministic jitter and emits a structured io_retry event. "
    "0 disables IO retry.")

IO_RETRY_BACKOFF_MS = conf_int(
    "spark.rapids.tpu.io.retryBackoffMs", 50,
    "Base backoff between IO retry attempts (doubled per attempt, "
    "capped at 2000ms, plus up to 25% deterministic jitter).")

TASK_MAX_ATTEMPTS = conf_int(
    "spark.rapids.tpu.task.maxAttempts", 3,
    "Attempts a task (one driven query) gets before a transient "
    "failure — TpuTaskRetryError, an injected device fault, a non-OOM "
    "XLA runtime error, a checksum-quarantined buffer — becomes fatal "
    "(exec/task_retry.py; the engine analog of Spark's "
    "task-attempt re-execution). 1 disables task retry.")

TASK_RETRY_BACKOFF_MS = conf_int(
    "spark.rapids.tpu.task.retryBackoffMs", 100,
    "Base backoff between task attempts (doubled per attempt, capped "
    "at 5000ms, plus deterministic jitter).")

OOM_RETRY_BACKOFF_MS = conf_int(
    "spark.rapids.tpu.retry.backoffMs", 5,
    "Base sleep between OOM-retry attempts in with_retry (doubled per "
    "attempt, capped at 200ms): gives in-flight spill writebacks and "
    "concurrent tasks time to actually free memory instead of "
    "re-spinning through all attempts in microseconds. 0 restores "
    "immediate retry.")

PIPELINE_CLOSE_TIMEOUT_MS = conf_int(
    "spark.rapids.tpu.pipeline.closeTimeoutMs", 10000,
    "Watchdog on pipeline stage close(): how long to wait for a "
    "producer thread to join before giving up, emitting a "
    "pipeline_stuck event and detaching the (daemon) thread instead of "
    "hanging the query teardown / interpreter exit.")

QUERY_TIMEOUT_MS = conf_int(
    "spark.rapids.tpu.query.timeoutMs", 0,
    "Per-query deadline for session-driven collects (exec/lifecycle.py "
    "query lifecycle governor): a query still running after this many "
    "ms is cooperatively cancelled — the cancellation token is checked "
    "at every batch boundary and inside semaphore / pipeline / spill-"
    "writeback waits, and the query unwinds with QueryCancelledError "
    "(a query_cancelled event records the phase that noticed it). The "
    "deadline spans ALL task re-execution attempts, so one query's "
    "wall-clock is bounded even under chaos. 0 (default) disables the "
    "deadline; TpuSession.cancel_query() works either way.",
    commonly_used=True)

QUERY_CANCEL_CHECK_BATCHES = conf_int(
    "spark.rapids.tpu.query.cancelCheckBatches", 8,
    "How many operator batch boundaries pass between cancellation/"
    "deadline checks of a governed query (exec/lifecycle.py). 1 checks "
    "every batch (lowest cancellation latency); higher values shave "
    "the already-tiny per-batch cost. Outside a governed query each "
    "boundary pays exactly one pointer check.")

PARTITION_RECOVERY_ENABLED = conf_bool(
    "spark.rapids.tpu.task.partitionRecovery.enabled", True,
    "Partition-granular recovery for host-shuffle block corruption "
    "(exec/lifecycle.py + shuffle/manager.py): the exchange captures "
    "per-map-output lineage at write time, and a checksum-quarantined "
    "shuffle block re-executes ONLY the producing sub-plan (the "
    "exchange child) to rewrite that one map output, instead of "
    "re-running the whole query through the task-retry lane. Ambiguous "
    "provenance (spill files, missing lineage, repeated corruption of "
    "one map output) still falls back to whole-plan re-execution.")

STALL_TIMEOUT_MS = conf_int(
    "spark.rapids.tpu.stall.timeoutMs", 0,
    "Progress watchdog for governed queries (exec/speculation_shield.py "
    "— distinct from the total-wall query.timeoutMs deadline): a query "
    "whose driving seam advances no root-output batches or rows for "
    "this many ms emits one query_stalled event (ESSENTIAL, with the "
    "ledger phase the time went into and the stalled operator) and "
    "takes stall.action. 0 (default) disables the watchdog — no "
    "monitor thread, one conf read per collect.")

STALL_ACTION = conf_str(
    "spark.rapids.tpu.stall.action", "report",
    "What the progress watchdog does when a governed query stalls past "
    "stall.timeoutMs: 'report' only emits the query_stalled event; "
    "'retry-seam' additionally fails the stalled attempt with a "
    "transient TpuTaskRetryError at its next cancellation checkpoint, "
    "routing it onto the bounded task-retry lane; 'cancel' cancels the "
    "query cooperatively (QueryCancelledError, reason 'stalled').")

SHUFFLE_SPECULATION_ENABLED = conf_bool(
    "spark.rapids.tpu.shuffle.speculation.enabled", False,
    "Speculative shuffle sub-reads (exec/speculation_shield.py + "
    "shuffle/manager.py): when one per-(map,frame) fetch or decode "
    "future exceeds a latency bound derived from the reader's own "
    "measured distribution (Log2Hist p95 x speculation.multiplier, "
    "floored at speculation.minMs), launch ONE duplicate attempt under "
    "a 'spec:' work-item key — first result wins, the loser is "
    "cancelled or discarded. Bounded by speculation.maxInFlight per "
    "query; each resolution emits a speculative_fetch event. Off "
    "(default) keeps the plain unbounded-wait read path, one conf read "
    "per reader.")

SHUFFLE_SPECULATION_MULTIPLIER = conf_float(
    "spark.rapids.tpu.shuffle.speculation.multiplier", 3.0,
    "Latency-bound factor for speculative shuffle sub-reads: a fetch/"
    "decode is considered straggling once it exceeds multiplier x the "
    "reader's measured p95 for that stage (Spark's "
    "spark.speculation.multiplier analog, against measured quantiles "
    "instead of task medians).")

SHUFFLE_SPECULATION_MIN_MS = conf_int(
    "spark.rapids.tpu.shuffle.speculation.minMs", 100,
    "Floor on the speculative-read latency bound: a fetch/decode is "
    "never speculated before this many ms regardless of how fast the "
    "measured p95 says the stage usually is — cold histograms and "
    "microsecond-fast local reads must not trigger duplicate work.")

SHUFFLE_SPECULATION_MAX_INFLIGHT = conf_int(
    "spark.rapids.tpu.shuffle.speculation.maxInFlight", 2,
    "Speculative duplicate attempts one query may have in flight at "
    "once. A straggling future past the bound with no free slot keeps "
    "waiting on its primary (counted speculative_denied) — duplicates "
    "ride the existing bounded reader pool and are never free "
    "admission-path work.")

DISPATCH_TIMEOUT_MS = conf_int(
    "spark.rapids.tpu.dispatch.timeoutMs", 0,
    "Hang bound on guarded device dispatch (obs/dispatch.py chokepoint "
    "and the ICI collective seam): a dispatched program not ready "
    "after this many ms emits dispatch_timeout, records a "
    "device_dispatch (or ici_exchange) breaker failure, and raises a "
    "transient task-lane error — the wedged call is abandoned on its "
    "watchdog thread instead of hanging the process. 0 (default) "
    "disables the bound: dispatch runs inline with no helper thread.")

DEAD_PEER_INVALIDATION_ENABLED = conf_bool(
    "spark.rapids.tpu.shuffle.deadPeerInvalidation.enabled", True,
    "Dead-peer map-output invalidation (parallel/heartbeat.py + "
    "shuffle/manager.py): a peer_dead transition invalidates the map "
    "outputs registered to that peer, so the next read of one routes "
    "through the partition-granular recompute lane (lineage re-executes "
    "only the producing sub-plan) instead of trusting a dead "
    "executor's shards — Spark's fetch-failure map-output invalidation, "
    "single-process edition. The peer's slot stays blacklisted until "
    "it re-registers. Requires an installed heartbeat manager; without "
    "one (the default single-process session) nothing changes.")

ADAPTIVE_ENABLED = conf_bool(
    "spark.rapids.tpu.adaptive.enabled", True,
    "Adaptive runtime replanning (exec/adaptive.py): consult the "
    "MEASURED per-partition map-output sizes the exchange recorder "
    "already captures and replan at exchange-read boundaries — split a "
    "skewed reducer partition into map-granular sub-reads "
    "(adaptive.skewedPartitionFactor), demote a measured-oversized "
    "broadcast/single-build join to the sub-partitioned strategy "
    "before its first OOM retry (adaptive.autoBroadcastMaxBytes and "
    "the workload governor's quota share), convert a shuffle join "
    "whose build side measured small to single-build, coalesce "
    "adjacent tiny reducer partitions (adaptive.coalesceTargetBytes), "
    "and shrink the query's batch target after an OOM split. CPU "
    "results are unchanged: integer paths stay byte-exact; float "
    "deltas are limited to the documented OOM-split reduction-order "
    "class. A misfiring replan lane demotes itself to the static plan "
    "through the `adaptive` circuit-breaker domain.",
    commonly_used=True)

ADAPTIVE_SKEW_FACTOR = conf_float(
    "spark.rapids.tpu.adaptive.skewedPartitionFactor", 4.0,
    "A reducer partition whose measured bytes exceed this factor times "
    "the median partition size (and adaptive.skewedPartitionMinBytes) "
    "is read as map-output-granular sub-reads, each a separate probe "
    "stream against the replicated build side, so no single hash-join "
    "window holds the whole hot key. <= 0 disables skew splitting.")

ADAPTIVE_SKEW_MIN_BYTES = conf_bytes(
    "spark.rapids.tpu.adaptive.skewedPartitionMinBytes", 16 * 1024 * 1024,
    "Floor below which a reducer partition is never treated as skewed "
    "regardless of its ratio to the median — small exchanges are "
    "cheaper to read whole than to split.")

ADAPTIVE_AUTO_BROADCAST_MAX_BYTES = conf_bytes(
    "spark.rapids.tpu.adaptive.autoBroadcastMaxBytes", 64 * 1024 * 1024,
    "Measured build-side cap for adaptive join strategy changes: a "
    "planned broadcast/single-build join whose build side MEASURES "
    "larger than this (or the admitting ticket's quota share) demotes "
    "to the sub-partitioned strategy before the first OOM retry, and a "
    "shuffle join whose build side measures at most this converts to "
    "single-build. -1 disables both conversions.")

ADAPTIVE_COALESCE_TARGET_BYTES = conf_bytes(
    "spark.rapids.tpu.adaptive.coalesceTargetBytes", 1024 * 1024,
    "Adjacent reducer partitions whose measured bytes sum to no more "
    "than this merge into one read on flat (partition-oblivious) "
    "consumers, killing per-partition dispatch overhead on thousand-"
    "partition plans. Partition-aware consumers (shuffled joins, "
    "partition-wise sort) always see the static boundaries. "
    "0 disables coalescing.")

BREAKER_ENABLED = conf_bool(
    "spark.rapids.tpu.breaker.enabled", False,
    "Degradation circuit breakers (exec/lifecycle.py): track classified-"
    "transient failures per fault domain (pallas_fused / pallas_join / "
    "device_dispatch); after breaker.threshold failures inside "
    "breaker.windowMs a domain's breaker opens and the domain is "
    "demoted to its safe path (the XLA kernel tier) for "
    "breaker.cooldownMs, then half-opens for one probe. Off (default): "
    "failure recording is skipped entirely and every tier consult is "
    "one empty-dict check.")

BREAKER_THRESHOLD = conf_int(
    "spark.rapids.tpu.breaker.threshold", 3,
    "Classified-transient failures of one fault domain inside "
    "breaker.windowMs that open its circuit breaker.")

BREAKER_WINDOW_MS = conf_int(
    "spark.rapids.tpu.breaker.windowMs", 60000,
    "Sliding failure-count window per fault domain for the degradation "
    "circuit breakers; failures older than this no longer count toward "
    "breaker.threshold.")

BREAKER_COOLDOWN_MS = conf_int(
    "spark.rapids.tpu.breaker.cooldownMs", 30000,
    "How long an open breaker keeps its domain demoted before "
    "half-opening for one probe (probe success closes the breaker, "
    "probe failure re-opens it for another cooldown).")

WORKLOAD_ENABLED = conf_bool(
    "spark.rapids.tpu.workload.enabled", False,
    "Concurrent workload governor (exec/workload.py): gate query start "
    "through a bounded admission queue (at most "
    "workload.maxConcurrentQueries admitted, workload.queueDepth "
    "queued), carve the device budget into soft per-admitted-query "
    "shares (workload.memoryQuotaFraction), and shed work fast — "
    "QueryAdmissionError with a retry-after hint — when the queue is "
    "full or the device is known-degraded (an open device_dispatch "
    "circuit breaker). Off (default): collect() pays one conf read and "
    "admission is a no-op, exactly the single-tenant behavior.",
    commonly_used=True)

WORKLOAD_MAX_CONCURRENT = conf_int(
    "spark.rapids.tpu.workload.maxConcurrentQueries", 4,
    "Queries allowed to run concurrently under the workload governor; "
    "further arrivals queue (up to workload.queueDepth) in weighted-"
    "fair priority order (exec/workload.py).")

WORKLOAD_QUEUE_DEPTH = conf_int(
    "spark.rapids.tpu.workload.queueDepth", 16,
    "Queries that may wait in the admission queue; an arrival past this "
    "bound is shed immediately with QueryAdmissionError (reason "
    "queue_full) instead of piling onto an already-saturated engine.")

WORKLOAD_ADMISSION_TIMEOUT_MS = conf_int(
    "spark.rapids.tpu.workload.admissionTimeoutMs", 0,
    "Longest a query may wait in the admission queue before it is shed "
    "with QueryAdmissionError (reason timeout). 0 (default) waits "
    "indefinitely — still bounded by the query's own "
    "spark.rapids.tpu.query.timeoutMs deadline, which spans queue wait "
    "(phase admission-wait).")

WORKLOAD_MEMORY_QUOTA_FRACTION = conf_float(
    "spark.rapids.tpu.workload.memoryQuotaFraction", 0.5,
    "Soft per-admitted-query share of the device budget under the "
    "workload governor: a query over max(fraction * budget, budget / "
    "admitted_count) that hits budget pressure spills ITS OWN buffers "
    "first (a quota_spill event) and surfaces pressure on its own "
    "OOM-retry lane, instead of pushing a neighbor's buffers down a "
    "tier. Shares rebalance as queries finish; a lone admitted query "
    "always gets the whole budget.")

WORKLOAD_PRIORITY = conf_str(
    "spark.rapids.tpu.workload.priority", "interactive",
    "Priority class of this session's queries under the workload "
    "governor: 'interactive' is preferred by admission and semaphore "
    "ordering, 'batch' yields to it — but ages: every few grants the "
    "oldest waiter wins regardless of class, so batch never starves "
    "(exec/workload.py PRIORITIES).")

DECIMAL_ENABLED = conf_bool(
    "spark.rapids.sql.decimalType.enabled", True,
    "Enable decimal offload (decimal128 columns stay on CPU until the "
    "two-limb kernels land; reference decimalType.enabled).")

FUSION_ENABLED = conf_bool(
    "spark.rapids.tpu.fusion.enabled", True,
    "Whole-stage fusion: compose chains of narrow operators "
    "(filter/project) into the consuming operator's single XLA program — "
    "the TPU analog of Spark's whole-stage codegen. One program per batch "
    "instead of one per operator; filters become reduction masks instead "
    "of gathers.", commonly_used=True)

STAGE_FUSION_ENABLED = conf_bool(
    "spark.rapids.tpu.stage.fusion.enabled", True,
    "Whole-stage compilation (exec/stage_compiler.py): after plan "
    "conversion a stage planner walks the TpuExec tree and groups "
    "maximal chains of whitelisted operators (filter -> project -> "
    "expand -> inner-join probe -> partial/complete masked aggregate) "
    "into CompiledStageExec nodes whose per-batch body is ONE "
    "dispatch-ledger-routed jitted program with buffer donation "
    "(carried aggregate state reuses HBM in place), per-batch "
    "governance hooks (cancellation, chaos fault points, dispatch "
    "metrics, breaker engagement) at the stage boundary, and program "
    "sites drawn from the plan-fingerprint program cache so a reused "
    "plan's second collect() is all jit cache hits. Non-whitelisted "
    "operators (exchanges, sorts, UDFs, windows) break the stage and "
    "keep their per-operator execs. An open device_dispatch / "
    "pallas_fused circuit breaker demotes a stage back to per-operator "
    "execution. Off: the converted tree runs unchanged and exec "
    "program sites stay per-instance — CPU results are identical "
    "either way (tier-1 asserted).", commonly_used=True)

STAGE_PROGRAM_CACHE_ENTRIES = conf_int(
    "spark.rapids.tpu.stage.programCache.maxSites", 512,
    "Upper bound on program sites the process-wide plan-fingerprint "
    "program cache retains (obs/dispatch.py). Each entry keys one "
    "(site label x canonical plan-subtree fingerprint) to its compiled "
    "program wrapper, so rebuilding the exec tree for an identical "
    "plan — every DataFrame.collect() does — reuses the already-traced "
    "programs instead of recompiling the whole plan. Past the bound "
    "the least recently used site is evicted (its programs recompile "
    "on next use). 0 disables the cache (every exec instance traces "
    "fresh programs, the pre-stage-fusion behavior).")

AGG_SPECULATIVE = conf_bool(
    "spark.rapids.tpu.agg.speculative.enabled", True,
    "Speculative masked-bucket aggregation: emit small partials plus a "
    "device overflow flag; the plan re-runs exactly if the flag ever trips "
    "(checked once at result materialization). Active only inside a "
    "speculation scope (collect / session queries).")

AGG_GROUP_SLOTS = conf_int(
    "spark.rapids.tpu.agg.bucketSlots", 32,
    "Buckets per round of the masked-bucket group-by kernel (max 64). "
    "Fast-path group cardinality is bucketSlots * bucketRounds; higher "
    "cardinality falls back to the exact sort path.")

AGG_ROUNDS = conf_int(
    "spark.rapids.tpu.agg.bucketRounds", 2,
    "Re-hash rounds of the masked-bucket group-by kernel.")


# --- what the port honours of the entries it does not read yet -----------

_ANY = None
_BY_DESIGN = "ROADMAP A, not ported by design: the port has no tier switch"

#: key -> (item, honoured values besides the default; _ANY = every value)
_UNREAD: Dict[str, Tuple[str, Optional[tuple]]] = {
    EXPLAIN.key: ("none", _ANY),
    MAX_READER_BATCH_SIZE_ROWS.key: ("none", _ANY),
    STABLE_SORT.key: ("none", _ANY),
    IMPROVED_FLOAT_OPS.key: ("none", _ANY),
    PALLAS_ENABLED.key: (_BY_DESIGN, ()),
    PALLAS_FUSED_TIER.key: (_BY_DESIGN, ("on",)),
    PALLAS_FUSED_BENCH_FILE.key: (_BY_DESIGN, ()),
}


def _norm(v):
    return v.strip().upper() if isinstance(v, str) else v


def _check_honoured(entry: ConfEntry, value) -> None:
    item, allowed = _UNREAD[entry.key]
    if allowed is _ANY or _norm(value) in \
            {_norm(v) for v in (entry.default,) + allowed}:
        return
    raise NotImplementedError(
        f"{entry.key}={value!r}: the port cannot honour this value yet "
        f"({item})")


class RapidsConf:
    """Immutable snapshot of settings; construct from a dict of
    spark-style key->string/typed values."""

    #: dynamic per-operator keys (reference registers one conf per rule:
    #: spark.rapids.sql.exec.<Exec> / .expression.<Expr> etc.)
    _DYNAMIC_PREFIXES = ("spark.rapids.sql.exec.",
                         "spark.rapids.sql.expression.",
                         "spark.rapids.sql.input.",
                         "spark.rapids.sql.format.")

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings = dict(settings or {})
        for k in self._settings:
            if (k.startswith("spark.rapids.") and k not in _REGISTRY
                    and not k.startswith(self._DYNAMIC_PREFIXES)):
                raise KeyError(f"unknown config {k!r}; see docs/configs.md")
            if k in _UNREAD:
                _check_honoured(_REGISTRY[k], _REGISTRY[k].get(self))

    def get(self, entry: ConfEntry):
        return entry.get(self)

    def with_overrides(self, **kv) -> "RapidsConf":
        s = dict(self._settings)
        s.update(kv)
        return RapidsConf(s)

    # convenience properties for hot entries
    @property
    def sql_enabled(self):
        return self.get(SQL_ENABLED)

    @property
    def batch_size_bytes(self):
        return self.get(BATCH_SIZE_BYTES)

    @property
    def concurrent_tpu_tasks(self):
        return self.get(CONCURRENT_TPU_TASKS)

    @property
    def retry_max_attempts(self):
        return self.get(RETRY_MAX_ATTEMPTS)


_active = threading.local()


def active_conf() -> RapidsConf:
    """This thread's conf (the default conf where none was set)."""
    conf = getattr(_active, "conf", None)
    if conf is None:
        conf = RapidsConf()
        _active.conf = conf
    return conf


def set_active_conf(conf: RapidsConf):
    _active.conf = conf


def generate_docs() -> str:
    """Render docs/configs.md from the registry (reference RapidsConf.help)."""
    lines = [
        "# spark_rapids_tpu_torch configuration",
        "",
        "Generated from the config registry (`spark_rapids_tpu_torch/config.py`), "
        "mirroring the reference's RapidsConf-generated docs/configs.md.",
        "",
        "| Key | Default | Meaning |",
        "|---|---|---|",
    ]
    for key in sorted(_REGISTRY):
        e = _REGISTRY[key]
        if e.internal:
            continue
        lines.append(f"| `{e.key}` | `{e.default}` | {e.doc} |")
    lines.append("")
    return "\n".join(lines)
