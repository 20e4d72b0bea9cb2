#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME, /usr/local/cuda or PATH); runs
from the repository root and imports nothing of JAX. Phases, each of which
fails the run on error:

  1. builds every kernel of the q1, q3 and q19 paths (the fused
     scan-aggregate specs, csrc/murmur3.cu, csrc/probe_verify.cu,
     csrc/row_gather.cu, csrc/dict_gather.cu), and the murmur3 kernel
     this one replaced, which phase 4 times against
     (REPLACED_MURMUR3_SOURCE); one nvcc per source,
     all started together; prints the build time and ptxas's register and
     spill counts; then the shuffle's host block codec
     (csrc/blockcodec.cpp) with the host compiler;
  2. holds each kernel against its plain PyTorch version on the card:
     fused_scan_agg on three specs at sizes ragged against the block size,
     with nulls, a high-cardinality case whose leftover flag must trip and
     a case whose lanes see more buckets than their register cache holds;
     the murmur3 chain over all nine key types with nulls, -0.0, NaNs and
     negative values, aligned and as x[1:] views, at 0 rows and row counts
     ragged around a thread's 4 rows and a block's 1,024, over 1 to 4
     columns in one launch and 5 and 9 in more, with one seed, two and
     per-row seed planes, and its i64 and i32 lanes with per-row seeds
     (exact); probe-verify on random
     lanes with duplicate build keys, buckets shared by several keys, empty
     ranges, one to three key lanes, a candidate bucket smaller than the
     total or equal to it, a total of 0, ranges longer than a tile, wholly
     empty tiles and over 1,000 tiles (exact on the slots below the
     total), its scratch left zero; the packed row gather at every width
     the main paths pack and at widths of its generic kernel, with -1,
     out-of-range and INT32_MIN indices or all of them out of range, f64
     lanes with NaN payloads and a matrix off alignment (exact bits); the
     dictionary
     gather at the TPU kernel's own (4096, 128) x (16384, 128) shape and on
     1- and 4-byte tables of 1, 3, 5 and 128 lanes through both of its
     kernels (one-lane tables staged and not), with codes of -1, n
     and above on ragged row counts, aligned and as x[1:] views (exact);
     and every kernel on its main path's own inputs (the murmur3 chain on
     each join's build keys with both seeds and its stream keys, every row
     gather of each path captured from a run of a fresh plan: q3, q19,
     P6's filter compaction and sort and P7's build permute and payloads;
     every dictionary gather of P7, its take of the ship-mode hash table
     by the stream's codes among them; every row gather of P9-P11, the
     exchanges' reorders among them, the murmur3 chain at the exchange's
     pid shape, and P11's join kernels at its single build and (its
     static twin's, under STATIC_CONF) at its first partition pair;
     every row gather of P13, its semi join's hash, probe and gathers,
     its anti join's probe and its dictionary gathers at the
     o_orderstatus and n_name filters; P12's join kernels and row
     gathers; P14's at a left outer join built on each side and a full
     outer join (the unmatched stream tail, the unmatched build rows);
     every row gather of P15's planned nested-loop join, its chunks
     among them; every row gather of P16's planned semi join and its
     join kernels at its single build, and its static twin's at its
     first partition pair; P19's murmur3 chain and
     probe at both joins, every row gather (the TopN's sort moves the
     decimal128 revenue as two limb lanes) and its dictionary take;
     every launch of a run of P21-P25: each join's murmur3 chain, probe
     and row gathers (P21, P22, P25), every murmur3 launch of P23's hash
     of a long, every row gather of P24's group-by and sort; every row
     gather (and dictionary gather, none so far) of a run of P26-P28:
     the window's sorts, P26's filter compaction, P27's out-of-core
     sort runs and merges, P28's group-by sorts and the explode's
     payload; every row gather and dictionary gather of a run of P29
     and P30: P29's join (the build permute, the build payload with the
     customers' struct's fixed-width leaves and validity, the stream
     payload), its filter and sort, the exchanges' reorders over 16
     partitions (and as the static twin), P30's group-by sort and z-order sort); every murmur3
     chain, probe and row gather launch of a run of P32 (Q21 and P19
     through their adaptive joins, P20's sort, P32 sub's sub-partitioned
     join over 16 partitions and its static twin, P32 demote); every
     murmur3 chain, probe and row gather launch of a run of each P40
     query over its file's table as read back (phase 3m's shapes); every
     row gather of each P41 command's plans, and the murmur3 chains and
     probes of MERGE's semi, left outer and anti joins (phase 3n's
     shapes); every murmur3 chain, probe and row gather launch of a run of
     P42 mesh q3 and P42 ici q3 (the exchanges' pids and grids over the
     four shards, the per-shard joins and aggregates) and every row
     gather of P42 mesh Q1 (phase 3o's shapes);
  3. drives bench.py's q1 plan (scan -> filter -> project -> aggregate) at
     16,777,216 rows, bench.py's q3 plan (two filtered scans -> inner hash
     join -> project -> exact aggregate -> TopN(10)) at 2,097,152 lineitems
     x 524,288 orders, a second time with the join's speculative size
     cache warm, q3 with INT order keys, and TPC-H Q19 at scale factor 1
     (6,001,215 lineitems x 200,000 parts, four dictionary-encoded string
     columns, code-space predicates, a join with a residual condition, a
     grand aggregate), all through the port's execs, with every launch
     counter set to 0 just before each path and read just after; checks q1
     against bench.numpy_oracle, q3 against bench.q3_oracle (integers and
     keys exact, f64 rtol 1e-9), q19 against q19_oracle (the qualifying
     row count exact, revenue rtol 1e-9) and the speculation flags (must
     stay False), and the launches: fused_scan_agg once per q1,
     dict_gather 42 times per q19, murmur3_columns twice (one launch per
     join side, both build seeds in one) and the per-row-seed lanes never
     per q3, INT-key q3 and q19, fused_probe_verify once and dma_row_gather
     5 times per q3 (3 per q19);
  3b. drives the paths of late materialization and the memory runtime,
     each counted the same way, with its host reads (the synchronizing
     CUDA calls of the run): P1, Q19 again, whose join output decodes at
     the join -> aggregate boundary (the decode counters must move); P2,
     the q3 plan with its lineitems as 16 batches of 131,072 rows, once
     unconstrained and then under a device budget from that run's peak
     catalog bytes (a quarter of it, or the bytes the plan held in use at
     once where that is more) and a host limit of an eighth, with one
     injected split-and-retry OOM in the first aggregate update: it must
     spill to the host and the disk, unspill, split, equal q3's oracle
     and leave the catalog empty; P3, a SortExec over q3's lineitems as
     32 batches of 65,536 rows by l_orderkey ASC, l_price DESC, out of
     core in two merge passes under the same budget rule, equal to
     np.lexsort's order, catalog empty. Then the scan ingest path, read
     with collect() (its output fetched in one packed device->host copy
     a batch): P4, q3 from host data (HostSource: each step builds one
     batch of host columns from numpy and uploads it in one packed copy)
     through two SourceScanExecs, the lineitems as 16 batches of 131,072
     rows and the orders as 4, the admission semaphore at 2 permits, at
     pipeline depth 0 and 2: each equal to q3's oracle, the two depths'
     rows bit-identical, 20 uploads in 20 transfers and one fetch, the
     launches of the same plan over the same batches built on the card
     (counted in the same run), no permit held and the catalog
     empty after; P5, Q19 at SF1 from host data, one batch a table with
     its four DictionaryColumns packed as codes, validity, dictionary
     bytes and offsets, at depth 2: equal to q19_oracle, 2 uploads, one
     fetch, the launches of phase 3's q19. Then the string keys: P6,
     TPC-H Q1 at SF1 (clause 2.4.1, DELTA 90) over the 6,001,215
     lineitems, l_returnflag and l_linestatus DictionaryColumns that
     decode at the aggregate's boundary, grouped by the 2-round hash
     group-by and ordered by the two strings: 4 groups equal to
     tpch_q1_oracle in the order A/F, N/F, N/O, R/F, 2 row gathers; P7,
     the lineitems (l_shipmode encoded) joined to the 7 ship modes on the
     string key, once with the build key a StringColumn and once a
     DictionaryColumn in another order, then summed by mode: equal to
     shipmode_oracle, the dictionaries hashed once each (dict_gather 1
     and 3 times), 2 row gathers, no probe kernel; P8, count(*) by
     1,048,576 distinct c_name strings in one batch at capacity, its
     route printed, every count 1 and the keys the input's; and the
     card's xxhash64_batch and murmur3_string of those names and of
     random bytes and UTF-8 text of 0-70 bytes, bit for bit against
     numpy references of Spark's hashes (np_xxhash64_bytes,
     np_murmur3_bytes). Then the host shuffle, each path through 16
     partitions (Spark's default 200 cut for the run's time limit), read
     with collect()'s run and failing where collect() would re-run it:
     P9, bench q1 as 16 batches of 1,048,576 rows split into a partial
     aggregate (the fused kernel with the filter and project absorbed),
     a HostShuffleExchangeExec on the flag and a final aggregate, equal to
     bench.numpy_oracle; P10, TPC-H Q1 at SF1 with its string route split
     the same way over both flags, then the sort: 4 groups equal to
     tpch_q1_oracle in the order A/F, N/F, N/O, R/F; P11, q3 as 16
     lineitem and 4 order batches, both filtered sides exchanged on the
     order key into a ShuffledHashJoinExec, partial -> exchange -> final,
     TopN(10), LONG and INT keys, equal to bench.q3_oracle, each at the
     default confs (the join converts to one single-build pass) and as
     its static twin (STATIC_CONF: the adaptive read plan off, one join
     a partition pair with rows on both sides). Each path's
     launches equal what its plan implies (expect_p9, expect_p10,
     expect_p11: one murmur3 launch and one reorder gather a map batch
     with rows on fixed-width keys, none for P10's string keys, the probe
     once a stream batch of a partition pair with rows on both sides;
     P11's row gathers at least the floor its filters, reorders, join and
     TopN imply), every exchange reads each frame it wrote with one
     upload, the shuffle root is empty after, the catalog empty and no
     permit held;
  3c. builds the same queries again as DataFrame queries of the port's
     session (TpuSession(conf, "cuda"), api/functions) over the batches
     phase 3 built: q1, q3 with LONG and INT keys and the exact tier by
     conf (spark.rapids.tpu.agg.speculative.enabled=false), Q19, P6 and
     P11 (spark.rapids.sql.shuffle.partitions=16, broadcastSizeThreshold
     -1) and its static twin; prints each one's explain() text and its plan ms (wrap_and_tag
     and convert, timed apart), holds q1's, P6's and P11's converted trees
     to the hand-built plans' shapes, drives each converted tree counted
     as phase 3 does (the speculation flags must stay False) and holds it
     to its oracle, then collect()s it through the session, counted,
     which must launch the same; every launch count that differs from the
     hand-built plan's must be accounted for by a planned node, which is
     printed (a BroadcastExchangeExec over a FilterExec compacts the build
     side the hand-built join masks; a CoalesceBatchesExec that merged
     batches runs the operators above it fewer times); the catalog empty,
     no permit held and the shuffle root empty after each;
  3d. drives the join types, the nested-loop join and the basic operators
     over TPC-H data made by clause 4.2.3's rules at SF1
     (tpch_join_data: 1,500,000 orders, ~6.0 M lineitems, 10,000
     suppliers, 25 nations; o_orderstatus and n_name DictionaryColumns),
     each held to a numpy oracle with its launches counted and printed:
     P12, TPC-H Q4 (clause 2.4.4, a left semi join), hand-built and
     planned at the default confs; P13, TPC-H Q21 (clause 2.4.21, a left
     semi and a left anti join with residual conditions, three inner
     joins, TopN(100) by numwait DESC, s_name), hand-built and planned
     with broadcasts off (phase 3i plans it at the default confs,
     through the adaptive join); P14, q3's filtered sides
     under every join type on both build sides where allowed (row count,
     both sides' key multisets and null counts); P15, 1,048,576
     lineitems left-outer-joined to 11 discount bands on a band condition
     (planned: a NestedLoopJoinExec over a broadcast), counted by band;
     P16, Q4's semi and anti joins through 16 partitions of the host
     shuffle (planned, broadcasts off, at the default tier), each also
     as its static twin (untimed); then a range
     of 2^24 ids summed, the union of the orders' two halves counted by
     priority, a limit of 100 at offset 1,000 and TPC-H Q1's count and
     sum over the grouping sets ((l_returnflag, l_linestatus), ())
     through an Expand, each planned from DataFrames;
  3e. drives the rest of A.8 wave 1 on the true TPC-H types, each planned
     from DataFrames and held to an exact oracle (every decimal to the
     last digit, as Python ints) with its launches counted: P17, TPC-H Q1
     (DELTA 90) over P6's 6,001,215 lineitems with DECIMAL(12, 2) money
     and a DATE ship date, l_shipdate <= date_sub(DATE '1998-12-01', 90),
     sums to DECIMAL(22, 2) and (36, 4) and count(*) by the two flags;
     P18, TPC-H Q6 over the same lines, a grand decimal128 sum; P19,
     TPC-H Q3 at SF1 (150,000 customers, c_mktsegment = 'BUILDING' on the
     codes, P12's orders and lineitems with o_custkey, o_shippriority and
     DECIMAL(12, 2) prices), a decimal128 revenue by three keys, TopN(10),
     broadcasts off; P20, the lineitems' sample(0.1, seed=7) (the rows
     the port's threefry keeps on the CPU) with a cast to string against
     Python's Decimal, round, bround, two shifts and from_utc_timestamp
     at +05:30; the orders sorted by (o_orderdate, o_orderkey) over 16
     host partitions (PartitionWiseSortExec) against np.lexsort; and
     count(*) by year(o_orderdate);
  3f. drives A.8 wave 2 and A.2's scalar aggregates, planned from
     DataFrames at SF1 with plain StringColumns (as a Parquet page without
     a dictionary gives them): P21, TPC-H Q14 (lineitem x part on the
     part key, p_type LIKE 'PROMO%', its two DECIMAL sums exact; the
     ratio formed from the two sums); P22, TPC-H Q22 (its average as its own
     query of sum and count, then substring(c_phone, 1, 2) IN (...) on
     decoded strings, c_acctbal above the average, NOT EXISTS as a left
     anti join, count and sum by the string cntrycode); P23, every new
     device expression over 200,000 p_type, 150,000 c_phone and P8's
     1,048,576 names, checked columnwise against Python and numpy
     oracles (the hashes against np_murmur3_bytes / np_xxhash64_bytes);
     P24, the moments and first/last by the two flags over P6's lines;
     P25, count(*) and max(p_type) by the part key over lineitem x part,
     whose aggregate takes the string route's sort fallback over the
     inner join's key-grouped output and skips its update sort (the
     pre-grouped path); with the regex loop's evaluations, steps and
     host reads;
  3g. drives A.8 wave 3a, planned from DataFrames at SF1 and held to
     numpy oracles columnwise, with launches, host reads and each
     path's input bound: P26, P12's 1,500,000 orders with o_custkey
     (about 100,000 customers) and o_totalprice (its lines' price x
     (1 - discount)), cache()d once (one materialization for both
     specs): spec A ranks each customer's orders by o_totalprice DESC
     (row_number, rank, dense_rank, lag, lead) and keeps rank <= 3,
     spec B by o_orderdate a running sum, a 3-row sliding min/max, a
     RANGE 90-day sum, whole-partition avg and count and
     first/last_value; P27, P6's 6,001,215 lines as 16 batches (more
     sorted runs than the sort's merge fan-in) windowed by the two flags
     (sum, avg, count, each line's share of its group's revenue) under
     a device budget (drive_under_budget): the sort goes out of core,
     the N/O partition takes the two-pass carry (its counters printed),
     the catalog empty after; P28, the lines' parts and suppliers
     collected by order (collect_list, collect_set, size, sort_array,
     array_contains, element_at, array_max), exploded and posexploded
     back to the lines, percentile and approx_percentile by the flags
     (within n/accuracy in rank of numpy's quantiles) and P21's 200,000
     p_type split into words, exploded and counted by word; the
     collect over 16 shuffle partitions is planned and printed as
     single-partition (list buffers never cross the host shuffle in
     either package);
  3h. drives A.8 wave 3b, planned from DataFrames at SF1 and held to
     numpy and Python oracles, with launches, host reads, each path's
     input bound and its peak device memory: P29, the 1,500,000 orders
     joined to 150,000 customers whose STRUCT c_info (c_mktsegment,
     c_nationkey, c_acctbal; built from its leaves) rides the join's
     build payload, the map of priority, status and clerk over the join
     (4,500,000 entries) and its lookups (get_map_value,
     element_at_key by a key column, map_contains_key,
     size(map_keys), map_values), grouped by priority, exploded and
     counted by (key, value), the first 1,000 orders collected with
     the struct and the map, and the collect and the group-by over 16
     host shuffle partitions with broadcasts off (the struct and the
     map cross the frames: printed), the collect also as its static twin
     (untimed); P30, P28's lines' l_quantity
     collected by order and the four device lambdas (transform,
     filter_ and its size, exists, forall) over 5,999,580 elements,
     InterleaveBits(l_partkey, l_suppkey) and a sort by it, and the
     host-tier aggregate() and outer-column lambda planned only (on the
     host row engine: the `~` reason printed); P31, 1,048,576 event documents (drawn
     from 131,072 distinct ones: nested objects, item arrays, decimal
     prices, escapes and surrogate pairs, whitespace, 1 % malformed) by
     five get_json_object paths, 1,048,576 URLs by seven parse_url parts
     and counted by host;
  3i. drives the adaptive join, the host row engine, Python UDFs and the
     cost model: P32, TPC-H Q21 (P13), Q3 on the true types (P19) and
     P20's sort planned at the default confs with the exact aggregate
     (the twins' confs but for the broadcast threshold), Q21 and P19
     through AdaptiveJoinExec, each held to its oracle (q21_oracle,
     q3_types_oracle, p20_oracles) with each adaptive join's choice and
     measured bytes and adaptive.counters(); P32 sub, the planned Q21
     whose adaptive joins decide under shuffle.partitions 16 and
     join.subPartitionThreshold one byte under the largest side P32 Q21
     built (a sub-partitioned join, k = 16), and as its static twin
     (untimed, one join a partition pair); P32 demote, Q21 planned with
     broadcastSizeThreshold 1 GiB, a right side measuring past
     adaptive.autoBroadcastMaxBytes demoted (the cap lowered under the
     largest right side if none does); P33 host, a month of P29's
     1,500,000 orders (a device filter) through a Project on the host
     row engine (levenshtein, a regex split, array_join) into a device
     aggregate by priority, held to a Python oracle; P33 udf, a Python
     UDF with a branch over every order as the host round trip and
     compiled (udfCompiler.enabled), held to each other and to numpy,
     with the round trips and the compiled tree; P33 cbo, a Project and
     Filter over the 25 nations (placed on the host) and over the lines
     (on the device) under optimizer.enabled; and the cost model's four
     constants measured on the card (measure_cost_constants);
  3j. drives the governed collect() (drive_governed_paths): P34, q3, Q19
     and P19 collected through the governed drive with the phase ledger,
     the event log at MODERATE, telemetry every 100 ms and the dispatch
     ledger, P34_RUNS times in turns with exec/base.collect of the same
     plan, converted and its stages compiled (the ungoverned twin), each
     run held to its oracle, its phases summing to its wall to the ns and
     the ledger's calls per kernel label equal to the wrappers' launches,
     then one governed run under torch.profiler whose device kernels
     equal those launches (traced_check), with the events by kind, the
     telemetry samples and the profile's top operators; P35,
     P16 (Q4's semi join over 16 host partitions) under a shuffle.fetch
     io fault and a one-shot device.dispatch fault, and P3 (the
     out-of-core sort at P3's device budget and host limit; P2, q3 at
     P2's, when P3 writes no spill file to disk) under a spill.disk_write
     corrupt fault, task.maxAttempts 3: rows equal to q4_oracle and
     np.lexsort (or q3_oracle), more than one attempt, the faults'
     stats, the catalog empty, no permit held, the shuffle root empty;
     P36, P11 timed twice, then cancelled by cancel_query() from a
     second thread after 0.3 of the faster run and run again under a
     query.timeoutMs of half of it: the latency to the
     raise, where it was noticed, no catalog entry, permit or pipeline
     thread left and torch.cuda.memory_allocated() back at its level;
     P37, four sessions on four threads under workload.enabled,
     maxConcurrentQueries 2, queueDepth 4 (two interactive on Q19, two
     batch on P19, 3 rounds): every result equal to its oracle, the
     grant order equal to pick_fair replayed on the recorded arrivals,
     active_queries() read mid-flight, health()["slo"];
  3k. drives the adaptive read plan and the robustness paths
     (drive_a9b_paths): P38, tpch_join_data's 5,999,580 SF1 lines (their
     lineitem columns and an l_quantity of 1-50, 80 % moved onto one order
     key from seed 38) as 16 host map batches, inner-joined to the
     1,500,000 orders over 16 host partitions (broadcasts off), then
     count(*) and sum(l_quantity) by o_orderpriority, held bit for bit
     to p38_oracle: static (adaptive off), split (the defaults but
     adaptive.autoBroadcastMaxBytes -1: the hot partition read as
     map-granular sub-reads) and convert (the defaults: the orders side
     measured under 64 MiB, one single-build pass), in turns (static
     once, split and convert 3 times each: P38_RUNS), with their decisions and measured bytes, launches and peak
     device memory (over the run, and over the read: from the join's first
     partition pair); P9 at the default confs (its partitions read as one
     coalesced stream); P16 at the default confs (its decision); P35's
     P16 under one shuffle.decode corrupt fault (one attempt, one
     partition_recompute); P38 split under one shuffle.skew_split corrupt
     fault (one map output recomputed) and with speculation on and one
     500 ms shuffle.fetch straggler (the duplicate wins, the straggling
     fetch resolves within half the delay, no plan retry);
     P11 under a pipeline.produce delay past stall.timeoutMs with each
     watchdog action (report: one query_stalled; retry-seam: two
     attempts; cancel: cancelled, memory back to its level); q3 with
     dispatch.timeoutMs 10,000 against none, in turns (no timeout); P2's
     injected split inside a governed query (the batch target halves);
     one history capsule per governed query of the phase;
  3l. drives the stage compiler (drive_stage_paths): P39, planned q1 (an
     agg stage), q3 (join_agg), Q19 (join_agg) and a Filter/Project/Filter
     chain under a TopN (map), each at the default confs beside its twin
     with stage.fusion.enabled false: the stages' kinds and absorbed
     operators; a cold collect() (one CUDA graph captured per stage step),
     the twin's and a warm one (0 captures, each graph step replayed),
     each held to its oracle with its launches and host reads; a warm
     collect() under torch.profiler whose device kernels equal the
     launches the counters recorded (traced_check); P39_PAIRS timed warm
     pairs and P39_COLD_PAIRS cold ones (the site cache and the join
     sizes emptied before each), in turns; then q3 under P2's budget;
  3m. drives the file lane (drive_file_paths): P40. In the set-up the
     port's writers write P12's SF1 orders (1,500,000 rows, all four
     columns) with write_avro(codec="deflate") and P19's 150,000
     customers with write_hive_text under the run's temporary directory,
     and the session's readers read each back once on the card (write
     ms and file bytes; read ms split into the host decode, the host
     build of the columns and the upload), equal to its input column for
     column. Phase 3m plans TPC-H Q4 over the orders from read_avro and
     P12's 5,999,580 lines as host numpy batches (P40 avro), and P19's
     Q3 over the customers from read_hive_text and P19's orders and lines
     as host numpy batches (P40 hive): one collect() each, counted, from
     an emptied site cache, the file read inside the query, held to
     q4_oracle and q3_types_oracle, beside its numpy-built twin (P12,
     P19) counted the same way, every launch difference named; then the
     query over the table read back against the twin, P40_RUNS runs in
     turns, one synchronisation a run;
  3n. drives Delta's DML plans (drive_delta_paths): P41. P12's SF1
     orders (1,500,000 rows, o_orderstatus a dictionary column) as one
     data file's rows through delta/table.py's four per-file rewrites:
     DELETE o_orderstatus = 'F', UPDATE o_orderpriority where o_orderdate
     < 1993-01-01, MERGE on o_orderkey against 150,000 source rows
     (100,000 orders' keys chosen by seed, 50,000 new; the ambiguity
     check, the matched count by a semi join, the left outer join's
     rewrite, the rows to insert by an anti join) and OPTIMIZE ZORDER BY
     o_orderdate. Each once counted (launches, host reads) beside the
     plain filter, filter, left outer join or sort it is built from, then
     P41_RUNS runs of the four in turns, one synchronisation a run; every
     run held to p41_oracles (the stats dict, the rows as a multiset,
     OPTIMIZE's z-order codes not decreasing);
  3o. drives the mesh lane (drive_mesh_paths): P42, four shards of one
     mesh on cuda:0 (the machine has one card: the all-to-all is a copy
     inside its memory). q3 (LONG keys, 2,097,152 x 524,288, its
     aggregate exact and broadcasts off) planned over the mesh: a
     ShuffledHashJoinExec over two ShuffleExchangeExecs, partial ->
     ShuffleExchangeExec -> final, TopN(10); TPC-H Q1 at SF1 by its two
     string flags over the mesh (the keys through the padded string
     lane); q3 through the host exchange's device lane (planExchange
     off, 4 partitions) with adaptive off, at the default confs (the
     skew shield stands the join's stream side down) and on the host
     lane; each beside its single-partition twin. Each path once counted
     (launches, host reads, the lane's counters, the all-to-all's bytes
     and host ns, frames, device peak), held to q3_oracle or
     tpch_q1_oracle, its launches to its plan's shape (p42_expect: a
     probe a stream batch over a pair a shard; a pid hash a shard and
     round, the build and each stream batch hashed a pair), the lane's
     rounds > 0 with no fallback and no frame with adaptive off, one
     stand-down a shuffled join at the defaults; then P42_RUNS runs of
     every path in turns, one synchronisation a run;
  3p. drives the tooling (drive_tooling_paths): P43. The tier matrix:
     P6, q3 and Q19 planned, each through the port's own harness,
     testing.assert_consistent_across_configs, over its three
     CONFIG_TIERS (speculative, exact, exact unfused) and its mesh and
     mesh+exact tiers over P42's mesh (four shards on cuda:0), every
     tier equal to the others and to tpch_q1_oracle, q3_oracle or
     q19_oracle; each tier's first collect counted (ms, launches, host
     reads), then P43_RUNS runs of every tier in turns. The fuzz:
     tests/test_fuzz.py's shapes (group-by sum/count, string-key
     min/max, filter-project, a left outer join, sort-limit, a group-by
     on DOUBLE keys with NaN, +-inf and -0.0) over the port's datagen
     tables of 262,144 rows (the join's build side 16,384) at the
     default special-value and null weights, made by worker processes
     while the earlier phases run, each across the three CONFIG_TIERS
     (testing.collect_with_conf) and held to its Python oracle, with
     each tier's launches. The
     dump: planned q3 under sql.debug.dumpPath with one injected device
     fault and task retry off raises the injected error and leaves
     error.txt, repro.py and one record per retained input batch in
     each dump directory (a .FAILED naming pyarrow where it is missing);
     then q3 with the path set beside the path empty, P43_RUNS runs in
     turns, each with its device peak;
  4. times the q1, q3 and q19 steady states (one synchronisation per run
     of iterations) and each kernel against its plain version, its bound
     and, for the row gather and the dictionary gather, the one PyTorch
     call that computes the same function; the murmur3 lanes at q3's
     stream keys and the chain at the q3 build pair, q3 stream and q19
     stream, each in turns with what ran there before (the replaced lane
     kernel; its seed plane, lane kernel and select per seed);
     fused_scan_agg's,
     dict_gather's, fused_probe_verify's and dma_row_gather's launches are
     timed apart from their wrappers' calls too, dict_gather at three
     shapes (q19's take, P7's stream take and dg's), the probe at q3's and
     q19's and the row gather at every shape of q3, q19, P6 and P7 (summed
     per iteration). Kernel
     times are the device's, with the L2 cache flushed before each run
     (device_ms). Also P2's and P3's ms per iteration under their
     budgets, Q19's decode counters per iteration, and the spill lane's
     rates on the full lineitem batch: the copy into pinned memory, the
     disk write and read, and the packed copy back to the card
     (upload_leaves). Then P4's ms per iteration at depth 0 and 2 in
     turns (no staging-pool miss may follow P4's first iteration) and
     P5's; a fresh and a cached pinned allocation of Q19's staging
     bucket; and on one q3 lineitem batch and Q19's lineitem batch the
     host pack's GB/s, the copy's GB/s, the whole packed upload's ms and
     a per-buffer build's ms (from_numpy_columns, or the Q19 columns
     built on the card buffer by buffer). Then P6's and P7's ms per
     iteration in steady state (one synchronisation per run). Last, P9,
     P10 and P11 in steady state (3 runs each, one synchronisation a run)
     with each exchange's phase times per run from its metrics (write,
     split, the split's device->host copy, serialize, LZ4 summed over the
     writer pool, file IO, read wait, the read seam's upload) and P11's
     join build and probe time; the split's fetch of one q3 lineitem map
     batch in GB/s (fetch_split_host, and the copy alone); the murmur3
     chain at the pid shape (131,072 LONG and INT keys, seed 42); and
     dma_row_gather at every reorder shape beside index_select and, where
     a fixed-width kernel serves it, the generic kernel. Then q1, q3 and
     Q19 through the session (df.collect(), the plan included) and as
     their hand-built plans (plan.collect()), in turns, 5 runs each. Then
     P12-P16 (3 runs each, one synchronisation a run), and the probe at
     Q21's semi and anti joins and the row gather at every shape of Q21.
     Then P17-P20 (collect() of the planned tree, 3 runs each, one
     synchronisation a run) and rows 2, 4, 5 and 6 at every P19 shape
     (p19_kernel_shapes). Then P21-P25 and P25 with its update sort
     taken (3 runs each, in turns, one synchronisation a run; P23's
     execute() checked columnwise) and
     rows 2+3, 4 and 5 at every P21 and P22 shape
     (strings_kernel_shapes). Then P26 and P28 in turns with P27's
     unconstrained twin (3 runs each, one synchronisation a run), P27
     under its budget (3 runs), and dma_row_gather at every distinct
     shape of P26-P28 beside index_select (windows_gather_shapes). Then
     P29-P31 in turns (3 runs each, one synchronisation a run) and
     dma_row_gather at every distinct shape of P29's join and P30's
     sorts beside index_select (nested_gather_shapes). Then P32's three
     default-conf plans beside their twins (P13's, P19's and P20's sort),
     P32 sub and demote, P33 host and P33 udf compiled, in turns (3 runs
     each, one synchronisation a run).

With --profile TRACE it also runs each steady state under torch.profiler
(after the kernel timings, which a profiled process perturbs),
prints the device's busy share and time by kernel, and writes the Chrome
traces to TRACE (q1) and TRACE with "_q3", "_q19", "_p6", "_p7",
"_p17", "_p18", "_p19", "_p20_sample", "_p20_sort", "_p20_year", "_p21",
"_p22", "_p23_part", "_p23_customer", "_p23_names", "_p24", "_p25",
"_p26_a", "_p26_b", "_p28_collect", "_p28_explode", "_p28_posexplode",
"_p28_percentile", "_p28_split", "_p27_unconstrained", "_p29_lookups",
"_p29_group", "_p29_explode", "_p29_collect", "_p29_shuffled",
"_p29_shuffled_group", "_p30_lambdas", "_p30_zorder", "_p31_json",
"_p31_url" or "_p31_hosts" before its suffix.

The last lines are a JSON line with the records of P1-P11, the spill
rates, the ingest rates, the split's fetch rates and the planned queries
of phase 3c (under "planned": plan ms, launches beside the hand-built
plan's, the differences and the session timings) and phase 3d's (under
"join_paths": launches, rows and ms), phase 3e's (under
"types_paths"), phase 3f's (under "strings_paths"), phase 3g's (under
"windows_paths"), phase 3h's (under "nested_paths") and phase 3i's
(under "adaptive_paths": choices, counters, round trips, placements,
the cost constants, ms), phase 3j's (under "governed_paths"), phase
3l's (under "stage_paths"), phase 3m's (under "file_paths") and phase
3n's (under "delta_paths"), phase 3o's (under "mesh_paths", with the
card's name and power limit) and phase 3p's (under "tooling_paths", with
the card's name and power limit), before
it a JSON line {"adaptive_paths": ...} with phase 3k's records, a JSON
line
with one record per
ported kernel (the
dictionary gather's holds its times at dg's shape under "dg_shape", the
probe's Q19's under "q19_shape" and Q21's under "q21_shapes", the row
gather's every shape under "shapes", the reorders' under
"reorder_shapes" and Q21's under "q21_shapes", the murmur3 chain's
three sites under "sites" and the pid hash under "pid_shapes", and each
kernel's launches on P1-P25 and the planned queries under
"path_launches", rows 2, 4, 5 and 6 at P19's, P21's and P22's
shapes under "p19_shapes", "p21_shapes" and "p22_shapes", and the row
gather at P26-P28's under "windows_shapes" and at P29's and P30's under
"nested_shapes"), the card as
nvidia-smi names it, and {"ok": true, "device": {...}}.
"""

import argparse
import base64
import contextlib
import datetime
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROWS = 1 << 24          # bench.py ROWS: the q1 lane's size
ITERS = 30              # steady-state runs of the whole q1 plan
Q3_ORDERS = 1 << 19     # bench.py N_ORDERS
Q3_LINES = 1 << 21      # bench.py N_LINES
Q3_ITERS = 10           # steady-state runs of the whole q3 plan
KERNEL_REPS = 20        # timed launches per kernel measurement
RTOL = 1e-9

#: H100 SXM (NVIDIA's data sheet): HBM rate and the non-tensor-core
#: float32 rate, which also bounds the kernel's integer and f64 work here
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

DEVICE = "cuda"

#: device-side names of the ported kernels' __global__ functions
PORTED_KERNEL_PREFIXES = ("fsa_", "void m3_rows", "void probe_scan_emit",
                          "void row_gather", "void dict_gather")

BUCKETS = 32            # G of the q1 lane (min(32, slots))
OUT_CAP = 128           # bucket_capacity(slots * rounds)


def q1_data():
    """bench.build_data: the same seed, the same arrays."""
    rng = np.random.default_rng(0)
    return {
        "returnflag": rng.integers(0, 4, ROWS, dtype=np.int32),
        "quantity": rng.integers(1, 51, ROWS, dtype=np.int64),
        "extendedprice": rng.random(ROWS) * 1000.0,
        "discount": rng.random(ROWS) * 0.1,
    }


def q1_oracle(d):
    """bench.numpy_oracle."""
    keep = d["quantity"] <= 45
    flag = d["returnflag"][keep]
    qty = d["quantity"][keep]
    dp = (d["extendedprice"] * (1.0 - d["discount"]))[keep]
    out = {}
    for k in np.unique(flag):
        m = flag == k
        out[int(k)] = (int(qty[m].sum()), float(dp[m].sum()), int(m.sum()))
    return out


def q1_schema(t):
    return t.Schema((t.StructField("returnflag", t.INT),
                     t.StructField("quantity", t.LONG),
                     t.StructField("extendedprice", t.DOUBLE),
                     t.StructField("discount", t.DOUBLE)))


def q1_plan(batch, schema):
    """bench.py make_plan, in the port."""
    from spark_rapids_tpu_torch.exec.aggregate import AggregateExec
    from spark_rapids_tpu_torch.exec.basic import (
        FilterExec, InMemoryScanExec, ProjectExec)
    from spark_rapids_tpu_torch.expr.aggexprs import Count, Sum
    from spark_rapids_tpu_torch.expr.core import col, lit
    scan = InMemoryScanExec([batch], schema)
    filt = FilterExec(col("quantity") <= lit(45), scan)
    proj = ProjectExec([
        col("returnflag"), col("quantity"),
        (col("extendedprice") * (lit(1.0) - col("discount")))
        .alias("disc_price")], filt)
    return AggregateExec(
        [col("returnflag")],
        [(Sum(col("quantity")), "sum_qty"),
         (Sum(col("disc_price")), "sum_disc"),
         (Count(), "cnt")], proj)


def minmax_spec():
    """A second spec covering min/max/sum_sq/count and a Divide: LONG key,
    INT and DOUBLE inputs, an Or/IsNull filter."""
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.expr.arithmetic import Abs, Divide
    from spark_rapids_tpu_torch.expr.core import col, lit, resolve
    from spark_rapids_tpu_torch.expr.predicates import GreaterThan, IsNull, Or
    from spark_rapids_tpu_torch.ops.fused_scan_agg import compile_scan_agg_spec
    src = t.Schema((t.StructField("k", t.LONG), t.StructField("w", t.INT),
                    t.StructField("v", t.DOUBLE)))
    filt = resolve(Or(GreaterThan(col("w"), lit(-40)), IsNull(col("v"))), src)
    pre = [col("k"), Abs(col("v")).alias("_a1"), col("w").alias("_a2"),
           Divide(col("v"), col("w")).alias("_a3")]
    pre_bound = [resolve(e, src) for e in pre]
    pre_schema = t.Schema(tuple(
        t.StructField(n, e.data_type)
        for n, e in zip(("k", "_a1", "_a2", "_a3"), pre_bound)))
    ops = [("min", 1), ("max", 1), ("min", 2), ("max", 2), ("sum_sq", 1),
           ("sum_sq", 2), ("count", 3), ("sum", 3), ("count_star", None)]
    return compile_scan_agg_spec([("filter", filt)], pre_bound, pre_schema,
                                 1, ops, src), src


def zoo_spec():
    """A spec that reaches the emitter's other branches: every whitelisted
    expression not in the q1 and min/max specs, FLOAT and INT keys (NaN and
    -0.0 among the float keys), FLOAT min/max and sum, INT sum."""
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.expr.arithmetic import Add, UnaryMinus
    from spark_rapids_tpu_torch.expr.core import col, lit, resolve
    from spark_rapids_tpu_torch.expr.predicates import (
        And, EqualNullSafe, EqualTo, GreaterThanOrEqual, IsNotNull, LessThan,
        Not, Or)
    from spark_rapids_tpu_torch.ops.fused_scan_agg import compile_scan_agg_spec
    src = t.Schema((t.StructField("k1", t.FLOAT), t.StructField("k2", t.INT),
                    t.StructField("x", t.DOUBLE), t.StructField("y", t.FLOAT),
                    t.StructField("z", t.LONG), t.StructField("w", t.INT)))
    filt = resolve(And(Not(EqualTo(col("w"), lit(7))),
                       Or(GreaterThanOrEqual(col("x"), lit(-50.0)),
                          IsNotNull(col("y")))), src)
    proj = [col("k1"), col("k2"), Add(col("z"), col("w")).alias("s"),
            UnaryMinus(col("y")).alias("ny"), col("x"),
            EqualNullSafe(col("w"), lit(3)).alias("e"),
            LessThan(col("y"), col("k1")).alias("lt")]
    proj_bound = [resolve(e, src) for e in proj]
    proj_schema = t.Schema(tuple(
        t.StructField(n, e.data_type)
        for n, e in zip(("k1", "k2", "s", "ny", "x", "e", "lt"), proj_bound)))
    filt2 = resolve(Or(col("e"), Not(col("lt"))), proj_schema)
    pre = [col("k1"), col("k2"), col("s").alias("_a2"),
           col("ny").alias("_a3"), col("x").alias("_a4"),
           col("k2").alias("_a5")]
    pre_bound = [resolve(e, proj_schema) for e in pre]
    pre_schema = t.Schema(tuple(
        t.StructField(n, e.data_type)
        for n, e in zip(("k1", "k2", "_a2", "_a3", "_a4", "_a5"), pre_bound)))
    ops = [("sum", 2), ("min", 3), ("max", 3), ("sum", 3), ("sum_sq", 4),
           ("count", 4), ("sum", 5), ("min", 2), ("count_star", None)]
    steps = [("filter", filt), ("project", proj_bound, proj_schema),
             ("filter", filt2)]
    return compile_scan_agg_spec(steps, pre_bound, pre_schema, 2, ops,
                                 src), src


def random_batch(schema, n, key_dom, device, seed):
    """Columns with ~15% nulls (data left under the null slots)."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column, bucket_capacity
    rng = np.random.default_rng(seed)
    cap = bucket_capacity(n)
    cols = []
    for f in schema.fields:
        if f.name in ("returnflag", "k", "k2"):
            vals = rng.integers(0, key_dom, n)
        elif f.name == "k1":
            vals = rng.choice([-0.0, 0.0, 1.5, np.nan, -2.25], n)
        elif f.name == "quantity":
            vals = rng.integers(1, 51, n)
        elif f.name in ("w", "z"):
            vals = rng.integers(-60, 60, n)
        elif f.name == "discount":
            vals = rng.random(n) * 0.1
        elif f.name == "y":
            vals = np.where(rng.random(n) < 0.05, np.nan,
                            rng.random(n) * 100.0 - 50.0)
        else:
            vals = rng.random(n) * 1000.0 - 100.0
        cols.append(Column.from_numpy(
            vals.astype(f.data_type.np_dtype), f.data_type, capacity=cap,
            device=device, validity=rng.random(n) > 0.15))
    return ColumnarBatch(cols, n, schema)


def _bits(x):
    """Float keys compare by bit pattern (both sides decode one canonical
    NaN from the order lanes), so a NaN group key is equal to itself."""
    import torch
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return x.view(ints[x.element_size()]) if x.is_floating_point() else x


def compare_outputs(got, want, label):
    """Kernel output against the plain version's: everything exact except
    f64 sums (rtol 1e-9). Returns (groups, leftover, max abs f64 error)."""
    import torch
    gk, gr, gn, gl = got
    wk, wr, wn, wl = want
    ng, left = int(wn), bool(wl)
    if int(gn) != ng or bool(gl) != left:
        raise AssertionError(f"{label}: groups/leftover {int(gn)}/{bool(gl)}"
                             f" != plain {ng}/{left}")
    for a, b in zip(gk, wk):
        if not (torch.equal(a.validity, b.validity)
                and torch.equal(_bits(a.data), _bits(b.data))):
            raise AssertionError(f"{label}: keys differ")
    err = 0.0
    for (_, (ad, av)), (_, (bd, bv)) in zip(gr, wr):
        if not torch.equal(av, bv):
            raise AssertionError(f"{label}: result validity differs")
        ad, bd = ad[av], bd[bv]
        if ad.dtype != bd.dtype:
            raise AssertionError(f"{label}: dtype {ad.dtype} != {bd.dtype}")
        if ad.is_floating_point():
            diff = (ad - bd).abs()
            both_nan = torch.isnan(ad) & torch.isnan(bd)
            lim = RTOL * bd.abs()
            if bool(((diff > lim) & ~both_nan).any()):
                raise AssertionError(f"{label}: f64 beyond rtol {RTOL}")
            if int((~both_nan).sum()):
                err = max(err, float(diff[~both_nan].max()))
        elif not torch.equal(ad, bd):
            raise AssertionError(f"{label}: integer results differ")
    return ng, left, err


#: bytes written before each timed launch: ten times the H100's 50 MB L2
FLUSH_BYTES = 512 << 20


def device_ms(fn, reps, flush_bytes=FLUSH_BYTES):
    """Mean device time of `fn`'s launches with the L2 cache cold, as the
    main path finds it: before each run a write of `flush_bytes` evicts L2
    and keeps the card busy while the host enqueues `fn` between two
    events, so the events bracket its device work and no host gap (a
    function of many launches needs a longer write to stay ahead)."""
    import torch
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    fn()
    pairs = []
    for _ in range(reps):
        flush.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def cuda_ms(fn, reps):
    """Mean time of `reps` back-to-back runs of `fn` between two events:
    the device's time when it outruns the host, else the host's."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ops_per_row(spec):
    """Operations the fused pass performs per row, counted from the spec:
    each expression node, the bucket hash (6 per mix, 2 mixes per 32-bit
    key lane, 3 per 64-bit one, plus the modulo), and one fold per
    aggregate and per key statistic."""
    def nodes(e):
        return 1 + sum(nodes(c) for c in getattr(e, "children", ()))
    n = 0
    for step in spec.steps:
        for e in ([step[1]] if step[0] == "filter" else step[1]):
            n += nodes(e)
    n += sum(nodes(e) for e in spec.pre_bound)
    for dt in spec.key_dtypes:
        n += 6 * (3 if dt.torch_dtype.itemsize == 8 else 2) + 4
    return n + 1 + len(spec.agg_ops)


def profile_plan(label, plan, iters, trace_path):
    """Where an iteration's time goes: torch.profiler over `iters` runs of
    `plan` under one speculation scope. Prints the device's busy share of
    the profiled wall time (the union of kernel intervals), device
    activities per iteration, and device time by kernel name; writes the
    Chrome trace to `trace_path`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    with speculation_scope():
        list(plan.execute())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                list(plan.execute())
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    print(f"profile {label} ({iters} iterations under the profiler): "
          f"{wall_us / iters / 1e3:.3f} ms/iteration, device busy "
          f"{busy / iters / 1e3:.3f} ms/iteration = {busy / wall_us:.1%}, "
          f"{len(kernels) / iters:.0f} device activities/iteration")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]:
        print(f"  {t / iters / 1e3:9.4f} ms/it {n / iters:7.1f}x  {name[:90]}")
    ported = [(name, t, n) for name, (t, n) in by_name.items()
              if name.startswith(PORTED_KERNEL_PREFIXES)]
    print(f"  ported kernels: {sum(t for _, t, _ in ported) / iters / 1e3:.4f}"
          f" ms/it in {sum(n for _, _, n in ported) / iters:.0f} launches")
    for name, t, n in sorted(ported, key=lambda r: -r[1]):
        print(f"  {t / iters / 1e3:9.4f} ms/it {n / iters:7.1f}x  {name[:90]}")
    # the same device time by the PyTorch operator that launched it, with
    # its input shapes: which call of the plan each kernel belongs to
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.self_device_time_total > 0]
    print("  by operator and input shapes:")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / iters / 1e3:9.4f} ms/it "
              f"{e.count / iters:7.1f}x  {e.key} {e.input_shapes}"[:150])
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    print(f"trace: {trace_path}")


# -- q3 -------------------------------------------------------------------

def q3_data(key_dtype=np.int64):
    """bench.build_q3_data: the same seed, the same arrays; the order keys
    optionally narrowed to int32 (the INT-key variant)."""
    rng = np.random.default_rng(1)
    d = {
        "o_orderkey": np.arange(Q3_ORDERS, dtype=np.int64),
        "o_flag": rng.integers(0, 10, Q3_ORDERS, dtype=np.int32),
        "l_orderkey": rng.integers(0, Q3_ORDERS, Q3_LINES, dtype=np.int64),
        "l_price": rng.random(Q3_LINES) * 1000.0,
        "l_disc": rng.random(Q3_LINES) * 0.1,
        "l_flag": rng.integers(0, 4, Q3_LINES, dtype=np.int32),
    }
    for k in ("o_orderkey", "l_orderkey"):
        d[k] = d[k].astype(key_dtype)
    return d


def q3_oracle(d):
    """bench.q3_oracle."""
    keep_o = d["o_flag"] < 5
    keep_l = d["l_flag"] != 0
    okeys = d["o_orderkey"][keep_o]
    lkey = d["l_orderkey"][keep_l]
    rev = (d["l_price"] * (1.0 - d["l_disc"]))[keep_l]
    sel = np.isin(lkey, okeys)
    lkey, rev = lkey[sel], rev[sel]
    order = np.argsort(lkey, kind="stable")
    lkey, rev = lkey[order], rev[order]
    uk, starts = np.unique(lkey, return_index=True)
    sums = np.add.reduceat(rev, starts)
    top = np.argsort(-sums, kind="stable")[:10]
    return {int(uk[i]): float(sums[i]) for i in top}


def q3_schemas(key_type):
    """(orders, lineitem) schemas of the q3 lane."""
    from spark_rapids_tpu_torch import types as t
    kt = getattr(t, key_type)
    return (t.Schema((t.StructField("o_orderkey", kt),
                      t.StructField("o_flag", t.INT))),
            t.Schema((t.StructField("l_orderkey", kt),
                      t.StructField("l_price", t.DOUBLE),
                      t.StructField("l_disc", t.DOUBLE),
                      t.StructField("l_flag", t.INT))))


def q3_batches(d, dev, schema, n, parts=1):
    """The first n rows of `schema`'s columns as `parts` batches of
    equal size."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column, bucket_capacity
    step = n // parts
    cap = bucket_capacity(step)
    return [ColumnarBatch([Column.from_numpy(
        d[f.name][i: i + step], f.data_type, capacity=cap, device=dev)
        for f in schema.fields], step, schema) for i in range(0, n, step)]


def q3_tree(m, orders, lines, n_parts=None):
    """bench.py make_q3_plan's operator tree above the two leaf execs, in
    the package whose modules `m` holds (`port_modules()`, or the JAX
    package's in the tests). With `n_parts`, the plan the JAX package's
    planner makes of it over the host shuffle (P11): each filtered side
    hash-exchanged on its order key into n_parts partitions, a
    ShuffledHashJoinExec, and the aggregate split into partial -> hash
    exchange -> final."""
    col, lit, b = m.core.col, m.core.lit, m.basic
    lines = b.FilterExec(col("l_flag") != lit(0), lines)
    orders = b.FilterExec(col("o_flag") < lit(5), orders)
    lk, ok = [col("l_orderkey")], [col("o_orderkey")]
    if n_parts is None:
        joined = m.joins.HashJoinExec(lines, orders, lk, ok, "inner",
                                      build_side="right")
    else:
        joined = m.exchange.ShuffledHashJoinExec(
            shuffle_of(m, lk, lines, n_parts),
            shuffle_of(m, ok, orders, n_parts), lk, ok, "inner",
            build_side="right")
    proj = b.ProjectExec([
        col("l_orderkey"),
        (col("l_price") * (lit(1.0) - col("l_disc"))).alias("rev")], joined)
    aggs = [(m.aggexprs.Sum(col("rev")), "revenue")]
    # as bench.py: the exact tier
    agg = m.agg.AggregateExec(lk, aggs, proj) if n_parts is None \
        else shuffled_aggregate(m, lk, aggs, proj, n_parts, exact=True)
    agg._spec_enabled = False
    return m.sort.TopNExec(10, [(col("revenue"), False)], agg)


def q3_plan(d, dev, key_type, line_batches=1, order_batches=1):
    """bench.py make_q3_plan in the port over batches built on `dev`; the
    lineitems fed as `line_batches` batches of equal size, the orders as
    `order_batches`."""
    m = port_modules()
    o_schema, l_schema = q3_schemas(key_type)
    return q3_tree(m, m.basic.InMemoryScanExec(
        q3_batches(d, dev, o_schema, Q3_ORDERS, order_batches), o_schema),
        m.basic.InMemoryScanExec(
            q3_batches(d, dev, l_schema, Q3_LINES, line_batches), l_schema))


class HostSource:
    """A scan's source of host data: each step of `batches()` builds one
    batch's host columns from numpy (CPU tensors at their capacity) and
    uploads them to `device` in one packed copy (to_device_batch).
    `parts` are zero-argument callables giving (columns, row count)."""

    def __init__(self, schema, parts, device):
        self.schema = schema
        self._parts = list(parts)
        self.device = device

    def batches(self):
        from spark_rapids_tpu_torch.columnar.upload import to_device_batch
        for make in self._parts:
            cols, n = make()
            yield to_device_batch(cols, n, self.schema, self.device)


def q3_host_parts(d, schema, n, parts):
    """The first n rows of `schema`'s columns as `parts` callables, each
    making one batch's host columns (equal sizes)."""
    from spark_rapids_tpu_torch.columnar.column import Column, bucket_capacity
    step = n // parts
    cap = bucket_capacity(step)

    def part(i):
        return lambda: ([Column.from_numpy(d[f.name][i: i + step],
                                           f.data_type, capacity=cap,
                                           device="cpu")
                         for f in schema.fields], step)
    return [part(i) for i in range(0, n, step)]


def q3_source_plan(d, dev, depth, line_batches, order_batches):
    """q3 over two SourceScanExecs of host data at pipeline `depth`."""
    m = port_modules()
    o_schema, l_schema = q3_schemas("LONG")

    def scan(schema, n, parts):
        return m.basic.SourceScanExec(
            HostSource(schema, q3_host_parts(d, schema, n, parts), dev),
            schema, depth)
    return q3_tree(m, scan(o_schema, Q3_ORDERS, order_batches),
                   scan(l_schema, Q3_LINES, line_batches))


def check_q3(rows, oracle, label):
    if len(rows) != 10 or {int(k) for k, _ in rows} != set(oracle):
        raise AssertionError(f"{label}: top-10 keys {rows} != oracle {oracle}")
    for k, v in rows:
        if abs(v - oracle[int(k)]) > RTOL * abs(oracle[int(k)]):
            raise AssertionError(f"{label}: key {k} revenue {v} != oracle "
                                 f"{oracle[int(k)]}")


# -- q19 --------------------------------------------------------------------

Q19_PARTS = 200_000      # TPC-H SF1 part rows (clause 4.2.5)
Q19_LINES = 6_001_215    # TPC-H SF1 lineitem rows
Q19_ITERS = 10           # steady-state runs of the whole q19 plan
#: clause 2.4.19.4's validation parameters, one disjunct each:
#: (brand, containers, quantity, largest p_size)
Q19_TERMS = (
    ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 5),
    ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10, 10),
    ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 15))
#: the query's text; the data hold 'REG AIR', so 'AIR REG' matches no row
Q19_SHIPMODES = ("AIR", "AIR REG")
Q19_INSTRUCT = "DELIVER IN PERSON"
Q19_QTY_SPAN = 10        # l_quantity between q and q + 10

#: clause 4.2.2.13's value lists
BRANDS = tuple(f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6))
CONTAINERS = tuple(f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
                   for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                             "CAN", "DRUM"))
SHIPINSTRUCTS = ("DELIVER IN PERSON", "COLLECT COD", "NONE",
                 "TAKE BACK RETURN")
SHIPMODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")

Q19_PART_FIELDS = (("p_partkey", "LONG"), ("p_brand", "STRING"),
                   ("p_size", "INT"), ("p_container", "STRING"))
Q19_LINE_FIELDS = (("l_partkey", "LONG"), ("l_quantity", "DOUBLE"),
                   ("l_extendedprice", "DOUBLE"), ("l_discount", "DOUBLE"),
                   ("l_shipinstruct", "STRING"), ("l_shipmode", "STRING"))


#: clause 4.2.3: order dates run from STARTDATE to ENDDATE - 151 days,
#: CURRENTDATE splits returned from open lines (days since the epoch)
ORDER_DATE_FIRST = 8035          # 1992-01-01
ORDER_DATE_LAST = 10440          # 1998-08-02
CURRENT_DATE = 9298              # 1995-06-17
RETURNFLAGS = ("A", "N", "R")
LINESTATUSES = ("F", "O")


def q19_data(n_part=Q19_PARTS, n_line=Q19_LINES, seed=19):
    """part and lineitem columns by TPC-H's generation rules (clause
    4.2.3), from a fixed seed. A string column is (int32 codes, values):
    the values are its dictionary, as a Parquet dictionary page holds it.
    Q1's columns (l_tax, l_shipdate, l_returnflag, l_linestatus) are drawn
    after the others, so those are what they were without them; each line
    draws its own order date (Q1 reads no order column)."""
    rng = np.random.default_rng(seed)
    partkey = np.arange(1, n_part + 1, dtype=np.int64)
    retail = (90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)) / 100
    l_partkey = rng.integers(1, n_part + 1, n_line, dtype=np.int64)
    qty = rng.integers(1, 51, n_line).astype(np.float64)

    def codes(values, n):
        return rng.integers(0, len(values), n).astype(np.int32), values

    d = {
        "p_partkey": partkey,
        "p_brand": codes(BRANDS, n_part),
        "p_size": rng.integers(1, 51, n_part).astype(np.int32),
        "p_container": codes(CONTAINERS, n_part),
        "l_partkey": l_partkey,
        "l_quantity": qty,
        "l_extendedprice": qty * retail[l_partkey - 1],
        "l_discount": rng.integers(0, 11, n_line) / 100.0,
        "l_shipinstruct": codes(SHIPINSTRUCTS, n_line),
        "l_shipmode": codes(SHIPMODES, n_line),
    }
    d["l_tax"] = rng.integers(0, 9, n_line) / 100.0
    order = rng.integers(ORDER_DATE_FIRST, ORDER_DATE_LAST + 1, n_line)
    ship = order + rng.integers(1, 122, n_line)
    receipt = ship + rng.integers(1, 31, n_line)
    returned = np.where(rng.integers(0, 2, n_line) == 0,
                        RETURNFLAGS.index("R"), RETURNFLAGS.index("A"))
    d["l_shipdate"] = ship.astype(np.int32)
    d["l_returnflag"] = (np.where(receipt <= CURRENT_DATE, returned,
                                  RETURNFLAGS.index("N")).astype(np.int32),
                         RETURNFLAGS)
    d["l_linestatus"] = ((ship > CURRENT_DATE).astype(np.int32),
                         LINESTATUSES)
    return d


def q19_oracle(d, terms=Q19_TERMS, span=Q19_QTY_SPAN,
               shipmodes=Q19_SHIPMODES):
    """Q19 in numpy: (revenue or None, qualifying lineitem rows). A
    string literal matches the rows whose value equals it (none when it
    is not among the values)."""
    def isin(name, literals, rows=slice(None)):
        c, values = d[name]
        return np.isin(c[rows], [values.index(x) for x in literals
                                 if x in values])

    p = d["l_partkey"] - 1
    qty = d["l_quantity"]
    size = d["p_size"][p]
    keep = isin("l_shipmode", shipmodes) & isin("l_shipinstruct",
                                                (Q19_INSTRUCT,))
    any_term = np.zeros_like(keep)
    for brand, containers, q, s in terms:
        any_term |= (isin("p_brand", (brand,), p)
                     & isin("p_container", containers, p)
                     & (qty >= q) & (qty <= q + span)
                     & (size >= 1) & (size <= s))
    keep &= any_term
    n = int(keep.sum())
    rev = float((d["l_extendedprice"] * (1.0 - d["l_discount"]))[keep].sum())
    return (rev if n else None), n


def port_modules():
    """The port's types, expressions and execs Q19 is built from."""
    from types import SimpleNamespace
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.exec import (aggregate, basic, exchange,
                                             joins, sort)
    from spark_rapids_tpu_torch.expr import aggexprs, core, predicates
    return SimpleNamespace(t=t, core=core, pred=predicates, basic=basic,
                           joins=joins, agg=aggregate, aggexprs=aggexprs,
                           sort=sort, exchange=exchange)


def q19_schemas(t):
    return [t.Schema(tuple(t.StructField(n, getattr(t, ty)) for n, ty in fs))
            for fs in (Q19_LINE_FIELDS, Q19_PART_FIELDS)]


def q19_columns(d, schema, dev):
    """The port's columns of one Q19 table on `dev`, and its row count:
    fixed-width columns and DictionaryColumns from the numpy arrays."""
    from spark_rapids_tpu_torch.columnar.column import Column, string_buffers
    from spark_rapids_tpu_torch.columnar.encoded import dictionary_from_numpy
    cols = []
    for f in schema.fields:
        v = d[f.name]
        if isinstance(v, tuple):
            cols.append(dictionary_from_numpy(
                v[0], *string_buffers(v[1]), device=dev))
        else:
            cols.append(Column.from_numpy(v, f.data_type, device=dev))
    first = d[schema.fields[0].name]
    return cols, (first[0] if isinstance(first, tuple) else first).shape[0]


def q19_batches(d, dev):
    """The port's lineitem and part batches, built on `dev`."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    return [ColumnarBatch(*q19_columns(d, schema, dev), schema)
            for schema in q19_schemas(port_modules().t)]


def q19_source_plan(d, dev, depth):
    """Q19 over two SourceScanExecs, each one batch of host data."""
    m = port_modules()

    def scan(schema):
        return m.basic.SourceScanExec(HostSource(
            schema, [lambda: q19_columns(d, schema, "cpu")], dev), schema,
            depth)
    return q19_tree(m, *[scan(s) for s in q19_schemas(m.t)])


def q19_plan(m, l_batch, p_batch, terms=Q19_TERMS, span=Q19_QTY_SPAN,
             shipmodes=Q19_SHIPMODES):
    """q19_tree over one batch of each table."""
    b = m.basic
    return q19_tree(m, b.InMemoryScanExec([l_batch], l_batch.schema),
                    b.InMemoryScanExec([p_batch], p_batch.schema), terms,
                    span, shipmodes)


def q19_tree(m, line_scan, part_scan, terms=Q19_TERMS, span=Q19_QTY_SPAN,
             shipmodes=Q19_SHIPMODES):
    """TPC-H Q19 as Spark plans it above the two leaf execs, in the
    package whose modules `m` holds (`port_modules()`, or the JAX
    package's in the tests):

      l = Filter(l_shipmode IN (...) AND l_shipinstruct = '...', scan)
      p = Filter(p_size >= 1 AND (term 1 OR term 2 OR term 3), scan)
      j = HashJoin(l, p, l_partkey = p_partkey, inner, build right,
                   condition = the query's three-way OR)
      Aggregate(sum(l_extendedprice * (1 - l_discount)), Project(j))"""
    col, lit, pr = m.core.col, m.core.lit, m.pred

    def all_of(*es):
        out = es[0]
        for e in es[1:]:
            out = pr.And(out, e)
        return out

    def any_of(*es):
        out = es[0]
        for e in es[1:]:
            out = pr.Or(out, e)
        return out

    ship = [pr.In(col("l_shipmode"), list(shipmodes)),
            pr.EqualTo(col("l_shipinstruct"), lit(Q19_INSTRUCT))]
    part_terms, terms_all = [], []
    for brand, containers, q, s in terms:
        part = [pr.EqualTo(col("p_brand"), lit(brand)),
                pr.In(col("p_container"), list(containers))]
        part_terms.append(all_of(*part, pr.LessThanOrEqual(col("p_size"),
                                                           lit(s))))
        terms_all.append(all_of(
            *part,
            pr.GreaterThanOrEqual(col("l_quantity"), lit(float(q))),
            pr.LessThanOrEqual(col("l_quantity"), lit(float(q + span))),
            pr.GreaterThanOrEqual(col("p_size"), lit(1)),
            pr.LessThanOrEqual(col("p_size"), lit(s)), *ship))
    b = m.basic
    lines = b.FilterExec(all_of(*ship), line_scan)
    parts = b.FilterExec(
        pr.And(pr.GreaterThanOrEqual(col("p_size"), lit(1)),
               any_of(*part_terms)), part_scan)
    joined = m.joins.HashJoinExec(lines, parts, [col("l_partkey")],
                                  [col("p_partkey")], "inner",
                                  build_side="right",
                                  condition=any_of(*terms_all))
    proj = b.ProjectExec([col("l_extendedprice"), col("l_discount")], joined)
    return m.agg.AggregateExec(
        [], [(m.aggexprs.Sum(col("l_extendedprice")
                             * (lit(1.0) - col("l_discount"))), "revenue")],
        proj)


def check_q19(rows, pairs, oracle, label):
    want, want_pairs = oracle
    got = rows[0][0] if len(rows) == 1 else rows
    if pairs != want_pairs:
        raise AssertionError(f"{label}: {pairs} qualifying rows != oracle "
                             f"{want_pairs}")
    if want is None:
        if got is not None:
            raise AssertionError(f"{label}: revenue {got} != oracle None")
    elif got is None or abs(got - want) > RTOL * abs(want):
        raise AssertionError(f"{label}: revenue {got} != oracle {want}")


# -- launch counters --------------------------------------------------------

def kernel_wrappers():
    """Every ported kernel's wrapper, whose `launches` counts its launches
    (and nothing else)."""
    from spark_rapids_tpu_torch.ops import (
        dict_gather, fused_scan_agg, murmur3_lanes, probe_verify, row_gather)
    return {"fused_scan_agg": fused_scan_agg.fused_scan_agg,
            "murmur3_columns": murmur3_lanes.murmur3_columns,
            "murmur3_long_lanes": murmur3_lanes.murmur3_long_lanes,
            "murmur3_int_lanes": murmur3_lanes.murmur3_int_lanes,
            "fused_probe_verify": probe_verify.fused_probe_verify,
            "dma_row_gather": row_gather.dma_row_gather,
            "dict_gather": dict_gather.dict_gather}


#: each ported kernel's device functions (a substring of the traced
#: name) and the launch counter family it counts on: each counted launch
#: is one launch of one of them
KERNEL_FAMILIES = (("fsa_rows", "fused_scan_agg"), ("m3_rows", "murmur3"),
                   ("probe_scan_emit", "fused_probe_verify"),
                   ("row_gather_", "dma_row_gather"),
                   ("dict_gather_", "dict_gather"))
MURMUR3_LABELS = ("murmur3_columns", "murmur3_long_lanes",
                  "murmur3_int_lanes")


def family_counts(counts):
    """Launch counts by wrapper label, summed by KERNEL_FAMILIES' family
    (the three murmur3 wrappers launch one device function)."""
    out = {}
    for k, v in counts.items():
        if v:
            fam = "murmur3" if k in MURMUR3_LABELS else k
            out[fam] = out.get(fam, 0) + v
    return out


def traced_launches(fn):
    """fn() under torch.profiler, whose CUPTI trace reports every kernel
    the device ran, each kernel node of a CUDA graph replay included:
    (fn's result, the ported kernels' launches by family)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        fam = next((f for sub, f in KERNEL_FAMILIES if sub in e.name), None)
        if fam is not None:
            counts[fam] = counts.get(fam, 0) + 1
    return out, counts


def traced_check(label, fn):
    """fn() traced with every launch counter at 0 just before: fails
    unless the kernels the device ran equal, by family, the launches the
    counters recorded (a graph replay adds its capture's). Returns
    (fn's result, the counters' launches, the traced ones by label: the
    counters' own split of the murmur3 family, which one device function
    serves)."""
    wrappers = zero_launches()
    out, traced = traced_launches(fn)
    counts = {k: w.launches for k, w in wrappers.items()}
    if family_counts(counts) != traced:
        raise AssertionError(f"{label}: the device ran {traced}, the "
                             f"counters recorded {family_counts(counts)}")
    by_label = {k: (v if k in MURMUR3_LABELS else traced.get(k, 0))
                for k, v in counts.items()}
    return out, counts, by_label


def drive_counted(label, plan, need):
    """Run `plan` once under a speculation scope with every launch counter
    set to 0 just before and read just after; fail if the flag tripped or
    a kernel in `need` was not launched. Returns (rows, counts)."""
    out, counts, _ = drive_batches(label, plan, need)
    return [r for b in out for r in b.to_pylist()], counts


def drive_batches(label, plan, need):
    """drive_counted's run, returning (batches, counts, host reads): the
    host reads are the synchronizing CUDA calls the run made (CUDA's sync
    debug mode warns on each), counted between the counter reset and the
    counter read."""
    import warnings
    import torch
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    with speculation_scope() as scope, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = list(plan.execute())
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        counts = {name: w.launches for name, w in wrappers.items()}
        tripped = scope.tripped()
    if tripped:
        raise AssertionError(f"{label}: speculation flag tripped")
    idle = [k for k in need if counts[k] < 1]
    if idle:
        raise AssertionError(f"{label}: kernels not launched: {idle} "
                             f"(counts {counts})")
    reads = sum("synchroniz" in str(w.message) for w in caught)
    return out, counts, reads


# -- slice 4: late materialization and the memory runtime -----------------

P2_LINE_BATCHES = 16     # q3's lineitems as 16 batches of 131,072 rows
P3_LINE_BATCHES = 32     # the sort's input: 32 batches of 65,536 rows
P_ITERS = 3              # timed runs of P2 and P3 each


def sort_plan(d, dev):
    """P3: SortExec over q3's lineitems in P3_LINE_BATCHES batches, by
    l_orderkey ASC, l_price DESC (out of core: more runs than the fan-in)."""
    from spark_rapids_tpu_torch.exec.basic import InMemoryScanExec
    from spark_rapids_tpu_torch.exec.sort import SortExec
    from spark_rapids_tpu_torch.expr.core import col
    schema = q3_schemas("LONG")[1]
    return SortExec([(col("l_orderkey"), True, None),
                     (col("l_price"), False, None)],
                    InMemoryScanExec(q3_batches(d, dev, schema, Q3_LINES,
                                                P3_LINE_BATCHES), schema))


def check_sort(batches, d, label):
    """Every row, in the order np.lexsort((-l_price, l_orderkey)) gives
    (the random f64 prices make ties practically absent)."""
    order = np.lexsort((-d["l_price"], d["l_orderkey"]))
    names = [f.name for f in q3_schemas("LONG")[1].fields]
    got = {n: [] for n in names}
    rows = 0
    for b in batches:
        n = b.num_rows_host
        rows += n
        for name, c in zip(names, b.columns):
            if not bool(c.validity[:n].all()):
                raise AssertionError(f"{label}: nulls in {name}")
            got[name].append(c.data[:n].cpu().numpy())
    if rows != Q3_LINES:
        raise AssertionError(f"{label}: {rows} rows, not {Q3_LINES}")
    for name in names:
        if not np.array_equal(np.concatenate(got[name]), d[name][order]):
            raise AssertionError(f"{label}: {name} out of order")


def drive_under_budget(label, make_plan, need, check, split):
    """P2 / P3: the plan once unconstrained, then under a device budget
    from that run's peak catalog bytes: a quarter of the peak, or what the
    plan held in use at once (no spill frees that) where that is more;
    the host limit an eighth of the peak. With `split`, one injected
    split-and-retry OOM in the first guarded step. Returns (the
    constrained plan, its counts, a record of the run)."""
    from spark_rapids_tpu_torch import memory as M

    def run(tag, limit, host_limit):
        cat = M.reset_buffer_catalog(host_limit=host_limit)
        budget = M.reset_memory_budget(limit)
        M.register_task(1)
        if split:
            M.force_split_and_retry_oom(1)
        plan = make_plan()
        t0 = time.perf_counter()
        out, counts, reads = drive_batches(f"{label} {tag}", plan, need)
        ms = (time.perf_counter() - t0) * 1e3
        check(out, f"{label} {tag}")
        cat.drain_writeback()
        return plan, cat, budget, counts, reads, ms
    _, cat, budget, free_counts, _, _ = run("unconstrained", None, None)
    peak, pinned = budget.peak, cat.peak_pinned_bytes
    limit, host_limit = max(peak // 4, pinned), peak // 8
    rule = "a quarter of the peak" if limit == peak // 4 \
        else "what it holds in use at once"
    print(f"{label}: unconstrained peak catalog {peak} bytes, in use at "
          f"once {pinned}; budget {limit} ({rule}), host limit "
          f"{host_limit}")
    plan, cat, budget, counts, reads, ms = run("under budget", limit,
                                               host_limit)
    # the later phases run under the default budget again
    M.reset_buffer_catalog()
    M.reset_memory_budget()
    c = cat.counters()
    retries, splits = M.task_retry_counts()
    if not (c["to_host"] and c["to_disk"] and c["to_device"]):
        raise AssertionError(f"{label}: spills {c} (host, disk and "
                             f"unspills must each be > 0)")
    if split and splits < 1:
        raise AssertionError(f"{label}: no split ({retries}, {splits})")
    if cat.num_entries() or cat.device_bytes():
        raise AssertionError(f"{label}: catalog left {cat.num_entries()} "
                             f"entries, {cat.device_bytes()} device bytes")
    rec = {"peak_bytes": peak, "pinned_bytes": pinned, "budget": limit,
           "host_limit": host_limit, "retries": retries, "splits": splits,
           "host_reads": reads, "first_run_ms": ms,
           "unconstrained_launches": free_counts, **c}
    print(f"{label}: equal to its oracle under the budget; spills {c}, "
          f"retries {retries}, splits {splits}, host reads {reads}; "
          f"launches {counts}; catalog empty")
    return plan, counts, rec


def time_under_budget(plan, rec):
    """ms per iteration of a budgeted plan (fresh catalog, same budget,
    no injection), one synchronisation per run."""
    import torch
    from spark_rapids_tpu_torch import memory as M
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    times = []
    for _ in range(P_ITERS):
        cat = M.reset_buffer_catalog(host_limit=rec["host_limit"])
        M.reset_memory_budget(rec["budget"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with speculation_scope():
            for _b in plan.execute():
                pass
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        cat.drain_writeback()
    M.reset_buffer_catalog()
    M.reset_memory_budget()
    return times


def spill_rates(batch):
    """GB/s of each hop of the spill lane on `batch`'s leaves, through the
    catalog's own functions: the copy into pinned memory (to its event),
    the CRC-stamped disk write (fsync'd) and read, and the packed copy
    back to the card (upload_leaves, as an unspill). One warm-up, then the
    mean of three."""
    import shutil
    import tempfile
    import torch
    from spark_rapids_tpu_torch.columnar.upload import upload_leaves
    from spark_rapids_tpu_torch.memory import catalog as C
    leaves, _ = batch.flatten()
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-spill-")
    path = f"{tmp}/rate.npz"
    try:
        def d2h():
            host, ev = C.copy_to_host(leaves)
            ev.synchronize()
            return host
        host = d2h()

        def h2d():
            upload_leaves(host, batch.device)
            torch.cuda.synchronize()
        hops = {"d2h_pinned": d2h,
                "disk_write": lambda: C.write_spill_file(path, host),
                "disk_read": lambda: C.read_spill_file(path),
                "h2d": h2d}
        out = {}
        for name, fn in hops.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            out[name] = nbytes * 3 / (time.perf_counter() - t0) / 1e9
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return nbytes, out


# -- slice 5: the scan ingest path -----------------------------------------

P4_ORDER_BATCHES = 4     # q3's orders as 4 host batches of 131,072 rows
P4_ITERS = 4             # timed runs of P4 at each depth, in turns
P5_ITERS = 3             # timed runs of P5


def io_counters():
    """The upload and fetch counters and the staging pool's misses."""
    from spark_rapids_tpu_torch.columnar import transfer, upload
    return dict(upload.counters(), **transfer.counters())


def drive_collect(label, plan, need):
    """`plan.collect()` with every launch counter set to 0 just before and
    read just after, and the upload and fetch counters' deltas over the
    run; fails if a kernel in `need` was not launched. collect() re-runs a
    plan whose speculation flag tripped, which doubles its launches: the
    callers compare the launches with a plain run's. Returns (rows,
    launches, io deltas, ms)."""
    import torch
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    before = io_counters()
    t0 = time.perf_counter()
    rows = plan.collect()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {name: w.launches for name, w in wrappers.items()}
    io = {k: v - before[k] for k, v in io_counters().items()}
    idle = [k for k in need if counts[k] < 1]
    if idle:
        raise AssertionError(f"{label}: kernels not launched: {idle} "
                             f"(counts {counts})")
    return rows, counts, io, ms


def check_scan_io(label, io, uploads, fetches):
    """One host->device transfer per scanned batch, one device->host
    transfer per collected batch."""
    if io["uploads"] != uploads or io["transfers"] != uploads:
        raise AssertionError(f"{label}: {io['uploads']} uploads in "
                             f"{io['transfers']} transfers, not {uploads}")
    if io["d2h_copies"] != fetches:
        raise AssertionError(f"{label}: {io['d2h_copies']} device->host "
                             f"copies, not {fetches}")


def check_idle(label):
    """No admission permit held, the catalog empty, after a path."""
    from spark_rapids_tpu_torch.memory import buffer_catalog, tpu_semaphore
    sem = tpu_semaphore()
    if sem.holders() or sem.available != sem.permits:
        raise AssertionError(f"{label}: {sem.holders()} tasks hold "
                             f"permits, {sem.available} of {sem.permits} "
                             f"free")
    if buffer_catalog().num_entries():
        raise AssertionError(f"{label}: catalog holds "
                             f"{buffer_catalog().num_entries()} entries")


def upload_rates(make_cols, n, schema, dev, per_buffer):
    """The packed upload of one batch, step by step: ms of building its
    host columns (`make_cols()`); of taking a staging buffer from the
    pool and freeing it (`acquire_ms`: for a batch larger than the pool
    keeps, a pinned allocation from PyTorch's caching host allocator);
    GB/s of the host pack into the buffer (acquire included) and of its
    one copy to the card (to a synchronisation); ms of the whole packed
    upload and of `per_buffer()`, a build of the same batch on the card
    one buffer at a time. One warm-up, then the mean of three, each
    between synchronisations."""
    import torch
    from spark_rapids_tpu_torch.columnar import upload
    pool = upload.staging_pool()
    cols = make_cols()

    def acquire():
        pool.release(pool.acquire(total))

    def pack():
        buf, _ = upload.pack_host_batch(cols, n, pool)
        pool.release(buf)

    def copy():
        buf, _ = upload.pack_host_batch(cols, n, pool)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf[:total].to(dev, non_blocking=True)
        torch.cuda.synchronize()
        pool.release(buf)
        return time.perf_counter() - t0

    def mean_ms(fn):
        fn()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sum(times) / 3 * 1e3

    total = upload.HEADER_BYTES + upload.layout_nbytes(
        [upload.column_layout(c) for c in cols])
    pack_ms = mean_ms(pack)
    copy()
    copy_s = sum(copy() for _ in range(3)) / 3
    return {"bytes": total, "build_ms": mean_ms(make_cols),
            "acquire_ms": mean_ms(acquire),
            "pack_gb_s": total / pack_ms / 1e6,
            "link_gb_s": total / copy_s / 1e9,
            "upload_ms": mean_ms(lambda: upload.to_device_batch(
                cols, n, schema, dev)),
            "per_buffer_ms": mean_ms(per_buffer)}


def pinned_alloc_ms(nbytes):
    """ms of a fresh pinned allocation of `nbytes` and of the same one
    again after it was freed (PyTorch's caching host allocator)."""
    import torch
    out = []
    for _ in range(2):
        t0 = time.perf_counter()
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        out.append((time.perf_counter() - t0) * 1e3)
        del buf
    return out


# -- slice 6: string keys ---------------------------------------------------

#: clause 2.4.1.3's validation DELTA = 90: l_shipdate <= 1998-12-01 - 90
Q1_SHIP_CUTOFF = datetime.date(1998, 9, 2)
Q1_LINE_FIELDS = (("l_quantity", "DOUBLE"), ("l_extendedprice", "DOUBLE"),
                  ("l_discount", "DOUBLE"), ("l_tax", "DOUBLE"),
                  ("l_shipdate", "DATE"), ("l_returnflag", "STRING"),
                  ("l_linestatus", "STRING"))
#: Q1's groups in its ORDER BY, and the route the aggregate must take
Q1_GROUPS = (("A", "F"), ("N", "F"), ("N", "O"), ("R", "F"))
P7_LINE_FIELDS = (("l_shipmode", "STRING"), ("l_extendedprice", "DOUBLE"))
P8_NAMES = 1 << 20       # distinct c_name keys of P8, one batch at capacity
P6_ITERS = 5             # timed runs of P6 and of each P7 build key
ROUTES = ("hash_rounds_2", "hash_rounds_6", "sort_fallback")


def tpch_q1_tree(m, line_scan, cutoff=None, n_parts=None):
    """TPC-H Q1 (clause 2.4.1) as Spark plans it above the lineitem scan,
    in the package whose modules `m` holds:

      Sort(l_returnflag, l_linestatus,
           Aggregate(group by l_returnflag, l_linestatus: sum(l_quantity),
                     sum(l_extendedprice), sum(price * (1 - discount)),
                     sum(price * (1 - discount) * (1 + tax)), avg(l_quantity),
                     avg(l_extendedprice), avg(l_discount), count(*),
                     Filter(l_shipdate <= cutoff, scan)))

    `cutoff` is the literal expression (default: a DATE literal of
    Q1_SHIP_CUTOFF). With `n_parts` the aggregate is split into partial
    -> hash exchange on both flags into n_parts partitions -> final
    (P10)."""
    col, lit, ax = m.core.col, m.core.lit, m.aggexprs
    cutoff = lit(Q1_SHIP_CUTOFF) if cutoff is None else cutoff
    lines = m.basic.FilterExec(
        m.pred.LessThanOrEqual(col("l_shipdate"), cutoff), line_scan)
    price, disc = col("l_extendedprice"), col("l_discount")
    disc_price = price * (lit(1.0) - disc)
    group = [col("l_returnflag"), col("l_linestatus")]
    aggs = [(ax.Sum(col("l_quantity")), "sum_qty"),
            (ax.Sum(price), "sum_base_price"),
            (ax.Sum(disc_price), "sum_disc_price"),
            (ax.Sum(disc_price * (lit(1.0) + col("l_tax"))), "sum_charge"),
            (ax.Average(col("l_quantity")), "avg_qty"),
            (ax.Average(price), "avg_price"),
            (ax.Average(disc), "avg_disc"),
            (ax.Count(), "count_order")]
    agg = m.agg.AggregateExec(group, aggs, lines) if n_parts is None \
        else shuffled_aggregate(m, group, aggs, lines, n_parts)
    return m.sort.SortExec([(col("l_returnflag"), True),
                            (col("l_linestatus"), True)], agg)


def tpch_q1_oracle(d, cutoff_days=None):
    """Q1 in numpy: one row per group in ORDER BY order."""
    cut = (Q1_SHIP_CUTOFF - datetime.date(1970, 1, 1)).days \
        if cutoff_days is None else cutoff_days
    keep = d["l_shipdate"] <= cut
    rf = np.asarray(d["l_returnflag"][1])[d["l_returnflag"][0]]
    ls = np.asarray(d["l_linestatus"][1])[d["l_linestatus"][0]]
    qty, price = d["l_quantity"], d["l_extendedprice"]
    disc, tax = d["l_discount"], d["l_tax"]
    rows = []
    for f, s in sorted(set(zip(rf[keep], ls[keep]))):
        g = keep & (rf == f) & (ls == s)
        n = int(g.sum())
        dp = price[g] * (1.0 - disc[g])
        rows.append((f, s, qty[g].sum(), price[g].sum(), dp.sum(),
                     (dp * (1.0 + tax[g])).sum(), qty[g].sum() / n,
                     price[g].sum() / n, disc[g].sum() / n, n))
    return rows


def check_rows(rows, oracle, label, exact=()):
    """Rows against the oracle's in order: the columns in `exact` and
    every str or int equal, floats to rtol 1e-9 (summation order)."""
    if len(rows) != len(oracle):
        raise AssertionError(f"{label}: {len(rows)} rows != oracle "
                             f"{len(oracle)}")
    for got, want in zip(rows, oracle):
        for i, (g, w) in enumerate(zip(got, want)):
            if isinstance(w, (str, int, np.integer)) or i in exact:
                ok = g == w
            else:
                ok = g is not None and abs(g - w) <= RTOL * abs(w)
            if not ok:
                raise AssertionError(f"{label}: row {got} != oracle {want}")


def tpch_q1_batch(d, dev):
    """Q1's lineitem batch on `dev`: the flags as DictionaryColumns."""
    m = port_modules()
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    schema = m.t.Schema(tuple(m.t.StructField(n, getattr(m.t, ty))
                              for n, ty in Q1_LINE_FIELDS))
    return ColumnarBatch(*q19_columns(d, schema, dev), schema)


def shipmode_table(seed=7):
    """P7's build side: clause 4.2.2.13's seven ship modes, each with a
    DOUBLE surcharge drawn from `seed`."""
    rng = np.random.default_rng(seed)
    return SHIPMODES, np.round(1.0 + rng.integers(1, 26, 7) / 100.0, 2)


def shipmode_join_tree(m, line_scan, mode_scan):
    """P7: the lineitems join the ship-mode table on the string key, then
    sum(l_extendedprice * surcharge) and count(*) by the build side's mode:

      Aggregate(group by sm_mode: sum(charge), count(*),
        Project(sm_mode, l_extendedprice * sm_surcharge as charge,
          HashJoin(lines, modes, l_shipmode = sm_mode, inner, build
                   right)))"""
    col = m.core.col
    joined = m.joins.HashJoinExec(line_scan, mode_scan, [col("l_shipmode")],
                                  [col("sm_mode")], "inner",
                                  build_side="right")
    proj = m.basic.ProjectExec(
        [col("sm_mode"),
         (col("l_extendedprice") * col("sm_surcharge")).alias("charge")],
        joined)
    return m.agg.AggregateExec(
        [col("sm_mode")], [(m.aggexprs.Sum(col("charge")), "surcharge"),
                           (m.aggexprs.Count(), "lines")], proj)


def shipmode_oracle(d, surcharge):
    """P7 in numpy: (mode, sum, count) for every mode, by mode."""
    codes, modes = d["l_shipmode"]
    price = d["l_extendedprice"]
    return [(modes[k], float((price[codes == k] * surcharge[k]).sum()),
             int((codes == k).sum())) for k in np.argsort(modes)]


def shipmode_batches(d, dev, encoded_build):
    """P7's (lineitem batch, ship-mode batch) on `dev`: the stream's
    l_shipmode dictionary-encoded; the build's mode a StringColumn, or
    with `encoded_build` a DictionaryColumn whose dictionary lists the
    modes in reverse order."""
    m = port_modules()
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import (Column, StringColumn,
                                                        string_buffers)
    from spark_rapids_tpu_torch.columnar.encoded import dictionary_from_numpy
    schema = m.t.Schema(tuple(m.t.StructField(n, getattr(m.t, ty))
                              for n, ty in P7_LINE_FIELDS))
    lines = ColumnarBatch(*q19_columns(d, schema, dev), schema)
    modes, surcharge = shipmode_table()
    if encoded_build:
        words = modes[::-1]
        mode_col = dictionary_from_numpy(
            np.array([words.index(x) for x in modes], np.int32),
            *string_buffers(words), device=dev)
    else:
        mode_col = StringColumn.from_pylist(list(modes), device=dev)
    mschema = m.t.Schema((m.t.StructField("sm_mode", m.t.STRING),
                          m.t.StructField("sm_surcharge", m.t.DOUBLE)))
    build = ColumnarBatch([mode_col, Column.from_numpy(
        surcharge, m.t.DOUBLE, device=dev)], len(modes), mschema)
    return lines, build


def customer_names(n, seed=8):
    """n distinct names in TPC-H's c_name form (clause 4.2.3,
    'Customer#%09d'), shuffled: a (n, 18) uint8 matrix."""
    keys = np.random.default_rng(seed).permutation(n) + 1
    mat = np.empty((n, 18), np.uint8)
    mat[:, :9] = np.frombuffer(b"Customer#", np.uint8)
    for i in range(9):
        mat[:, 17 - i] = ord("0") + (keys // 10 ** i) % 10
    return mat


def names_batch(mat, dev):
    """P8's batch: one StringColumn of the names at capacity rows."""
    m = port_modules()
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import StringColumn
    n, w = mat.shape
    col = StringColumn.from_numpy(mat.reshape(-1),
                                  np.arange(n + 1, dtype=np.int32) * w,
                                  device=dev)
    schema = m.t.Schema((m.t.StructField("c_name", m.t.STRING),))
    return ColumnarBatch([col], n, schema)


def names_count_tree(m, scan):
    """P8: count(*) grouped by c_name."""
    return m.agg.AggregateExec([m.core.col("c_name")],
                               [(m.aggexprs.Count(), "n")], scan)


def route_counts(agg):
    return {r: agg.metrics[r].value for r in ROUTES}


# numpy references of Spark's string hashes, on a padded (rows, width)
# uint8 matrix and the rows' lengths: written from Spark's
# Murmur3_x86_32.hashUnsafeBytes and XXH64.hashUnsafeBytes, independent
# of the port's torch code

def np_murmur3_bytes(mat, lengths, seed):
    """uint32 hashes, from one seed for every row."""
    c1, c2 = np.uint32(0xCC9E2D51), np.uint32(0x1B873593)

    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    def mix(h, k):
        k = rotl(k * c1, 15) * c2
        h = rotl(h ^ k, 13)
        return h * np.uint32(5) + np.uint32(0xE6546B64)

    n = mat.shape[0]
    rows = np.arange(n)
    m32 = mat.astype(np.uint32)
    lengths = np.asarray(lengths, np.int64)
    h = np.full(n, seed, np.uint32)
    nw = lengths // 4
    for t in range(int(nw.max(initial=0))):
        w = m32[:, 4 * t] | (m32[:, 4 * t + 1] << np.uint32(8)) \
            | (m32[:, 4 * t + 2] << np.uint32(16)) \
            | (m32[:, 4 * t + 3] << np.uint32(24))
        h = np.where(t < nw, mix(h, w), h)
    for j in range(3):
        pos = nw * 4 + j
        b = mat[rows, np.minimum(pos, mat.shape[1] - 1)].view(np.int8)
        h = np.where(pos < lengths, mix(h, b.astype(np.int32).view(
            np.uint32)), h)
    h = h ^ lengths.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def np_xxhash64_bytes(mat, lengths, seed):
    """uint64 hashes, from one seed for every row."""
    p1, p2 = np.uint64(0x9E3779B185EBCA87), np.uint64(0xC2B2AE3D27D4EB4F)
    p3, p4 = np.uint64(0x165667B19E3779F9), np.uint64(0x85EBCA77C2B2AE63)
    p5 = np.uint64(0x27D4EB2F165667C5)

    def rotl(x, r):
        return (x << np.uint64(r)) | (x >> np.uint64(64 - r))

    def rnd(acc, k):
        return rotl(acc + k * p2, 31) * p1

    n, width = mat.shape
    rows = np.arange(n)
    lengths = np.asarray(lengths, np.int64)
    m64 = np.zeros((n, width + 8), np.uint64)
    m64[:, :width] = mat

    def word(pos, nbytes):
        out = np.zeros(n, np.uint64)
        for j in range(nbytes):
            p = np.minimum(pos + j, width + 7)
            out |= m64[rows, p] << np.uint64(8 * j)
        return out

    s = np.full(n, seed, np.uint64)
    v = [s + p1 + p2, s + p2, s + 0, s - p1]
    stripes = lengths // 32
    for k in range(int(stripes.max(initial=0))):
        act = k < stripes
        for i in range(4):
            at = np.full(n, 32 * k + 8 * i, np.int64)
            v[i] = np.where(act, rnd(v[i], word(at, 8)), v[i])
    big = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)
    for i in range(4):
        big = (big ^ rnd(np.uint64(0), v[i])) * p1 + p4
    h = np.where(lengths >= 32, big, s + p5)
    h = h + lengths.astype(np.uint64)
    pos = stripes * 32
    while True:
        act = pos + 8 <= lengths
        if not act.any():
            break
        h = np.where(act, rotl(h ^ rnd(np.uint64(0), word(pos, 8)), 27)
                     * p1 + p4, h)
        pos = np.where(act, pos + 8, pos)
    act = pos + 4 <= lengths
    h = np.where(act, rotl(h ^ (word(pos, 4) * p1), 23) * p2 + p3, h)
    pos = np.where(act, pos + 4, pos)
    while True:
        act = pos < lengths
        if not act.any():
            break
        h = np.where(act, rotl(h ^ (word(pos, 1) * p5), 11) * p1, h)
        pos = np.where(act, pos + 1, pos)
    h ^= h >> np.uint64(33)
    h *= p2
    h ^= h >> np.uint64(29)
    h *= p3
    return h ^ (h >> np.uint64(32))


def hash_probe_strings(seed=9):
    """Strings of every length 0-70, of random bytes (many >= 0x80) and of
    multibyte UTF-8 text, as a padded matrix and lengths."""
    rng = np.random.default_rng(seed)
    rows = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
            for n in range(71) for _ in range(4)]
    rows += [("ü€𝄞" * k)[:k].encode() for k in range(30)]
    width = max(len(r) for r in rows)
    mat = np.zeros((len(rows), width), np.uint8)
    for i, r in enumerate(rows):
        mat[i, :len(r)] = np.frombuffer(r, np.uint8)
    return mat, np.array([len(r) for r in rows], np.int64)


def compare_string_hashes(mat, lengths, dev, label):
    """The card's xxhash64_batch and murmur3_string of the rows, seed 42,
    bit for bit against the numpy references."""
    import torch
    from spark_rapids_tpu_torch.columnar.column import StringColumn
    from spark_rapids_tpu_torch.ops import hashing
    n = len(lengths)
    offsets = np.zeros(n + 1, np.int32)
    offsets[1:] = np.cumsum(lengths)
    keep = np.arange(mat.shape[1])[None, :] < np.asarray(lengths)[:, None]
    col = StringColumn.from_numpy(mat[keep], offsets, capacity=n,
                                  device=dev)
    xx = hashing.xxhash64_batch([col], 42).cpu().numpy().view(np.uint64)
    m3 = hashing.murmur3_string(col, 42).cpu().numpy().view(np.uint32)
    torch.cuda.synchronize()
    want_xx = np_xxhash64_bytes(mat, lengths, 42)
    want_m3 = np_murmur3_bytes(mat, lengths, 42)
    bad = int((xx != want_xx).sum() + (m3 != want_m3).sum())
    if bad:
        raise AssertionError(f"{label}: {bad} string hashes differ from "
                             f"the numpy references")
    print(f"string hashes of {label} ({n} rows, up to {int(max(lengths))} "
          f"bytes): xxhash64_batch and murmur3_string equal to numpy's "
          f"bit for bit")


def scan_of(m, batch):
    return m.basic.InMemoryScanExec([batch], batch.schema)


def drive_string_paths(m, dev, q1t_batch, q1t_want, p7_batches, p7_want,
                       names):
    """Phase 3b's string-key paths, each counted with drive_batches and
    held to its numpy oracle: P6 (TPC-H Q1 over the dictionary-encoded
    flags, by the 2-round hash route), P7 (the ship-mode join on the
    string key, for each build key in `p7_batches`), P8 (count(*) by the
    distinct `names`), then the card's string hashes against numpy's.
    Returns P6's plan, and each path's launches and record."""
    from spark_rapids_tpu_torch.columnar import encoded
    p6 = tpch_q1_tree(m, scan_of(m, q1t_batch))
    before = encoded.counters()
    out, p6_counts, p6_reads = drive_batches("P6 TPC-H Q1", p6,
                                             ["dma_row_gather"])
    rows = [r for b in out for r in b.to_pylist()]
    check_rows(rows, q1t_want, "P6")
    if tuple(r[:2] for r in rows) != Q1_GROUPS:
        raise AssertionError(f"P6: groups {[r[:2] for r in rows]} != "
                             f"{Q1_GROUPS}")
    p6_rec = {"routes": route_counts(p6.child), "host_reads": p6_reads,
              "materializations": encoded.counters()["materializations"]
              - before["materializations"]}
    want_counts = {"dma_row_gather": 2, "dict_gather": 0,
                   "fused_probe_verify": 0, "murmur3_columns": 0}
    if p6_rec["routes"] != {"hash_rounds_2": 1, "hash_rounds_6": 0,
                            "sort_fallback": 0} \
            or any(p6_counts[k] != v for k, v in want_counts.items()):
        raise AssertionError(f"P6: routes {p6_rec['routes']}, launches "
                             f"{p6_counts} (one 2-round hash group-by; "
                             f"{want_counts})")
    print(f"P6 TPC-H Q1 ({q1t_batch.num_rows_host} lineitems): "
          f"{len(rows)} groups "
          f"{[r[:2] for r in rows]} equal to the numpy oracle; routes "
          f"{p6_rec['routes']}; {p6_rec['materializations']} boundary "
          f"decodes; host reads {p6_reads}; launches {p6_counts}")
    p7_counts, p7_rec = {}, {}
    for enc, (lines7, build7) in p7_batches.items():
        label = "P7 ship-mode join, build key " + (
            "a DictionaryColumn" if enc else "a StringColumn")
        plan7 = shipmode_join_tree(m, scan_of(m, lines7), scan_of(m, build7))
        before = encoded.counters()["dict_hash_tables"]
        out, counts, reads = drive_batches(
            label, plan7, ["dict_gather", "dma_row_gather"])
        tables = encoded.counters()["dict_hash_tables"] - before
        check_rows(sorted(r for b in out for r in b.to_pylist()), p7_want,
                   label)
        want_counts = {"dict_gather": 3 if enc else 1, "dma_row_gather": 2,
                       "fused_probe_verify": 0, "murmur3_columns": 0}
        if tables < 1 or any(counts[k] != v
                             for k, v in want_counts.items()):
            raise AssertionError(f"{label}: {tables} dictionary hash "
                                 f"tables, launches {counts} (want "
                                 f"{want_counts})")
        key = "dictionary_build" if enc else "string_build"
        p7_counts[key] = counts
        p7_rec[key] = {"routes": route_counts(plan7), "host_reads": reads,
                       "dict_hash_tables": tables}
        print(f"{label}: 7 groups equal to the numpy oracle; "
              f"{tables} dictionary hash tables; routes "
              f"{p7_rec[key]['routes']}; host reads {reads}; launches "
              f"{counts}")
    nb = names_batch(names, dev)
    p8 = names_count_tree(m, scan_of(m, nb))
    out, p8_counts, p8_reads = drive_batches("P8 count by c_name", p8, [])
    got = out[0]
    n8 = got.num_rows_host
    keys = got.columns[0]
    lens = (keys.offsets[1:n8 + 1] - keys.offsets[:n8]).cpu().numpy()
    key_bytes = keys.data[:n8 * names.shape[1]].cpu().numpy()
    cnt = got.columns[1].data[:n8].cpu().numpy()
    if len(out) != 1 or n8 != len(names) or (lens != names.shape[1]).any() \
            or (cnt != 1).any() or not np.array_equal(
                np.unique(key_bytes.reshape(n8, -1), axis=0),
                np.unique(names, axis=0)):
        raise AssertionError(f"P8: {n8} groups, counts {np.unique(cnt)}: "
                             f"not the {len(names)} names once each")
    p8_rec = {"routes": route_counts(p8), "host_reads": p8_reads,
              "groups": n8}
    print(f"P8 count(*) by {len(names)} distinct c_name keys in one batch: "
          f"{n8} groups, every count 1, the keys the input's; route "
          f"{p8_rec['routes']}; host reads {p8_reads}; launches "
          f"{p8_counts}")
    compare_string_hashes(names, np.full(len(names), names.shape[1]), dev,
                          "P8's c_name keys")
    compare_string_hashes(*hash_probe_strings(), dev,
                          "random bytes of 0-70 and UTF-8 text")
    return p6, p6_counts, p6_rec, p7_counts, p7_rec, p8_counts, p8_rec


# -- slice 7: the host shuffle and the partial/final aggregate --------------

#: partitions of P9-P11's exchanges: Spark's spark.sql.shuffle.partitions
#: is 200, cut to 16 for the run's time limit
P_PARTS = 16
P9_BATCHES = 16          # q1's rows as 16 batches of 1,048,576
P11_LINE_BATCHES = 16    # q3's lineitems as 16 batches of 131,072 (P2's)
P11_ORDER_BATCHES = 4    # q3's orders as 4 batches of 131,072 (P4's)
P_SHUFFLE_ITERS = 3      # timed runs of P9, P10 and P11 each
#: a shuffled join's static twin: the adaptive read plan off, so that the
#: join reads every partition pair as written (no skew split, coalesced
#: read or single-build conversion); each shuffled join that converts at
#: the default confs runs its twin too, which keeps the per-pair join
#: (its empty-pair skips, one sizing a pair) on the card
STATIC_CONF = {"spark.rapids.tpu.adaptive.enabled": "false"}
#: the exchange metrics P9-P11 record, per exchange
EXCHANGE_METRICS = (
    "numInputBatches", "numMapsWithRows", "numReorderGathers",
    "numFramesWritten", "numFramesRead", "numUploads", "shuffleRawBytes",
    "dataSize", "shuffleWriteTime", "shufflePackTimeNs",
    "shuffleFetchTimeNs", "shuffleFetchBytes", "shuffleSerializeTimeNs",
    "shuffleCompressTimeNs", "shuffleIoTimeNs", "shuffleReadTime",
    "uploadPackTimeNs", "pipelineWaitNs")


def shuffle_of(m, keys, child, n_parts, partitioning="hash"):
    """A HostShuffleExchangeExec in the package `m` holds, with its
    `exchange_kw` (the tests give the JAX package's its conf there)."""
    return m.exchange.HostShuffleExchangeExec(
        keys, child, n_parts, partitioning=partitioning,
        **getattr(m, "exchange_kw", {}))


def shuffled_aggregate(m, group, aggs, child, n_parts, exact=False):
    """partial -> hash exchange on the partial's keys into n_parts
    partitions -> final, as the JAX package's planner builds it
    (`_convert_host_shuffled_aggregate`); a grand aggregate goes through
    one single partition. `exact` pins both stages to the exact tier."""
    partial = m.agg.AggregateExec(group, aggs, child, mode="partial")
    keys = [m.core.col(n) for n in partial.output_schema.names[:len(group)]]
    exchange = shuffle_of(m, keys, partial, n_parts) if group \
        else shuffle_of(m, [], partial, 1, "single")
    final = m.agg.AggregateExec(group, aggs, exchange, mode="final",
                                input_types=partial._input_types)
    if exact:
        partial._spec_enabled = final._spec_enabled = False
    return final


def q1_tree(m, scan, n_parts):
    """bench.py's q1 plan (filter -> project -> aggregate) with the
    aggregate split over the host shuffle (P9): the partial absorbs the
    filter and project into the fused scan-aggregate kernel."""
    col, lit, b, ax = m.core.col, m.core.lit, m.basic, m.aggexprs
    filt = b.FilterExec(col("quantity") <= lit(45), scan)
    proj = b.ProjectExec([
        col("returnflag"), col("quantity"),
        (col("extendedprice") * (lit(1.0) - col("discount")))
        .alias("disc_price")], filt)
    return shuffled_aggregate(
        m, [col("returnflag")], [(ax.Sum(col("quantity")), "sum_qty"),
                                 (ax.Sum(col("disc_price")), "sum_disc"),
                                 (ax.Count(), "cnt")], proj, n_parts)


def check_q1(rows, oracle, label):
    """q1's groups against bench.numpy_oracle: counts and integer sums
    exact, the f64 sum to rtol 1e-9."""
    if sorted(r[0] for r in rows) != sorted(oracle):
        raise AssertionError(f"{label}: groups {rows} != oracle {oracle}")
    for k, qty, dp, cnt in rows:
        oq, odp, oc = oracle[k]
        if qty != oq or cnt != oc or abs(dp - odp) > RTOL * abs(odp):
            raise AssertionError(f"{label}: group {k}: {(qty, dp, cnt)} "
                                 f"!= oracle {oracle[k]}")


def exchanges_of(plan):
    """The plan's HostShuffleExchangeExecs, in tree order."""
    from spark_rapids_tpu_torch.exec.exchange import HostShuffleExchangeExec
    out, todo = [], [plan]
    while todo:
        node = todo.pop(0)
        if isinstance(node, HostShuffleExchangeExec):
            out.append(node)
        todo.extend(node.children)
    return out


def exchange_snapshot(plan):
    """Every exchange's EXCHANGE_METRICS, in tree order."""
    return [{k: ex.metrics[k].value for k in EXCHANGE_METRICS}
            for ex in exchanges_of(plan)]


def shuffle_root_empty(label):
    """No shuffle registered and no file under the shuffle root."""
    import os
    from spark_rapids_tpu_torch.shuffle.manager import shuffle_manager
    mgr = shuffle_manager()
    left = os.listdir(mgr.root_dir())
    if left or mgr.registered():
        raise AssertionError(f"{label}: {mgr.registered()} shuffles "
                             f"registered, files left {left}")


def drive_shuffled(label, plan, need, expect):
    """collect()'s run of `plan` (its speculation scope, its to_pylist
    fetch) with every launch counter set to 0 just before and read just
    after, failing where collect() would re-run it (a tripped flag).
    `expect(counts, exchanges, plan)` returns the launches the plan
    implies for each kernel it names; every count must equal it. Then
    each exchange's frames and uploads (one a frame read, all written
    frames read), the shuffle root (empty) and the catalog and permits
    (idle). The run's adaptive decisions are left on `plan._adaptive`.
    Returns (rows, counts, per-exchange metrics, ms, the run's upload,
    fetch and staging-pool counters)."""
    import torch
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    wrappers = kernel_wrappers()
    before = exchange_snapshot(plan)
    io_before = io_counters()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    with event_spy(("adaptive_replan",)) as seen, \
            speculation_scope() as scope:
        rows = [r for b in plan._execute(encoded_out=True)
                for r in b.to_pylist()]
        tripped = scope.tripped()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    # the adaptive read plan's decisions (exec/adaptive.py), which the
    # launch expectations derive from
    plan._adaptive = decisions_of(seen)
    counts = {name: w.launches for name, w in wrappers.items()}
    io = {k: v - io_before[k] for k, v in io_counters().items()}
    if tripped:
        raise AssertionError(f"{label}: speculation flag tripped")
    idle = [k for k in need if counts[k] < 1]
    if idle:
        raise AssertionError(f"{label}: kernels not launched: {idle} "
                             f"(counts {counts})")
    exs = [{k: v - b[k] for k, v in a.items()}
           for a, b in zip(exchange_snapshot(plan), before)]
    on_card = plan.device is not None and plan.device.type == "cuda"
    for i, e in enumerate(exs):
        # one upload a frame read on a card; on the CPU the read seam
        # passes the host batch through
        uploads = e["numFramesRead"] if on_card else 0
        if e["numFramesRead"] != e["numFramesWritten"] \
                or e["numUploads"] != uploads:
            raise AssertionError(f"{label}: exchange {i}: "
                                 f"{e['numFramesWritten']} frames written, "
                                 f"{e['numFramesRead']} read, "
                                 f"{e['numUploads']} uploads")
        if e["numReorderGathers"] != e["numMapsWithRows"]:
            raise AssertionError(f"{label}: exchange {i}: "
                                 f"{e['numReorderGathers']} reorder gathers "
                                 f"for {e['numMapsWithRows']} map batches "
                                 f"with rows")
    want = expect(counts, exs, plan)
    wrong = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if wrong:
        raise AssertionError(f"{label}: launches (counted, implied) "
                             f"{wrong}; all {counts}")
    shuffle_root_empty(label)
    check_idle(label)
    return rows, counts, exs, ms, io


def expect_p9(counts, exs, plan):
    """P9: fused_scan_agg once a source batch; one murmur3 launch and one
    row gather a map batch with rows (the partial's one state batch)."""
    maps = sum(e["numMapsWithRows"] for e in exs)
    return {"fused_scan_agg": P9_BATCHES, "murmur3_columns": maps,
            "dma_row_gather": maps, "fused_probe_verify": 0,
            "dict_gather": 0, "murmur3_long_lanes": 0,
            "murmur3_int_lanes": 0}


def expect_p10(counts, exs, plan):
    """P10: string keys hash in plain torch (no murmur3 launch); row
    gathers: the filter's compaction, one reorder a map batch with rows,
    the final sort."""
    maps = sum(e["numMapsWithRows"] for e in exs)
    return {"fused_scan_agg": 0, "murmur3_columns": 0, "dma_row_gather":
            1 + maps + 1, "fused_probe_verify": 0, "dict_gather": 0,
            "murmur3_long_lanes": 0, "murmur3_int_lanes": 0}


def p11_join(plan):
    """The ShuffledHashJoinExec of a q3_tree(n_parts=...) plan."""
    from spark_rapids_tpu_torch.exec.exchange import ShuffledHashJoinExec
    node = plan
    while not isinstance(node, ShuffledHashJoinExec):
        node = node.children[0]
    return node


def expect_p11(counts, exs, plan):
    """P11: murmur3 once a map batch with rows on each of the three
    exchanges, and in the join once a partition pair (the build keys,
    both seeds) and once a stream batch; the probe once a stream batch of
    a pair with rows on both sides. The row gathers the plan implies at
    least: each filter's compaction a batch, one reorder a map batch with
    rows, the join's build permute a pair and its two payload gathers a
    stream batch, the TopN's sort; the aggregates' sort-path group-bys
    add the rest (data-dependent: how many of their updates and merges
    leave rows over), which `p11_row_gathers` reports. At the default
    confs the orders side measures under adaptive.autoBroadcastMaxBytes:
    the join converts to one single-build pass (one pair; the lines'
    exchange skipped, no map of it written; a probe a filtered lineitem
    batch), else one pair a partition at most."""
    j = p11_join(plan)
    pairs = j.metrics["numPartitionPairs"].value - j._pairs_before
    stream = j.metrics["numStreamBatches"].value - j._stream_before
    maps = sum(e["numMapsWithRows"] for e in exs)
    if any(d["decision"] == "single_build_convert" for d in plan._adaptive):
        if pairs != 1 or stream != P11_LINE_BATCHES:
            raise AssertionError(f"P11: converted, yet {pairs} pairs and "
                                 f"{stream} stream batches")
    elif pairs > P_PARTS:
        raise AssertionError(f"P11: {pairs} pairs over {P_PARTS} partitions")
    floor = P11_LINE_BATCHES + P11_ORDER_BATCHES + maps + pairs \
        + 2 * stream + 1
    if counts["dma_row_gather"] < floor:
        raise AssertionError(f"P11: {counts['dma_row_gather']} row gathers, "
                             f"fewer than the {floor} the plan implies")
    plan._p11_row_gathers = {
        "filter_compactions": P11_LINE_BATCHES + P11_ORDER_BATCHES,
        "reorders": maps, "join_build_permutes": pairs,
        "join_payloads": 2 * stream, "topn_sort": 1,
        "aggregate_sort_paths": counts["dma_row_gather"] - floor}
    plan._p11_pairs = (pairs, stream)
    return {"fused_scan_agg": 0, "murmur3_columns": maps + pairs + stream,
            "fused_probe_verify": stream, "dict_gather": 0,
            "murmur3_long_lanes": 0, "murmur3_int_lanes": 0}


def p11_plan(d, dev, key_type, settings=None):
    """q3 shuffled (P11) over 16 lineitem and 4 order batches on `dev`,
    its exchanges under `settings` (default: the active conf)."""
    from spark_rapids_tpu_torch.config import RapidsConf
    m = port_modules()
    if settings is not None:
        m.exchange_kw = {"conf": RapidsConf(settings)}
    o_schema, l_schema = q3_schemas(key_type)
    plan = q3_tree(m, m.basic.InMemoryScanExec(
        q3_batches(d, dev, o_schema, Q3_ORDERS, P11_ORDER_BATCHES), o_schema),
        m.basic.InMemoryScanExec(
            q3_batches(d, dev, l_schema, Q3_LINES, P11_LINE_BATCHES),
            l_schema), n_parts=P_PARTS)
    return plan


def drive_p11(label, plan, want):
    j = p11_join(plan)
    j._pairs_before = j.metrics["numPartitionPairs"].value
    j._stream_before = j.metrics["numStreamBatches"].value
    out = drive_shuffled(label, plan, ["murmur3_columns",
                                       "fused_probe_verify",
                                       "dma_row_gather"], expect_p11)
    check_q3(out[0], want, label)
    return out


def describe_exchanges(exs):
    return "; ".join(
        f"exchange {i}: {e['numMapsWithRows']} of {e['numInputBatches']} "
        f"map batches with rows, {e['numFramesWritten']} frames "
        f"({e['shuffleRawBytes']} raw bytes, {e['dataSize']} stored), "
        f"{e['numUploads']} uploads" for i, e in enumerate(exs))


def drive_shuffle_paths(dev, q1_batches, q1_want, q1t_batch, q1t_want, d3,
                        d3i, q3_want):
    """Phase 3b's shuffle paths, each counted with drive_shuffled and held
    to its oracle: P9 (bench q1 over 16 batches, partial -> exchange ->
    final), P10 (TPC-H Q1 at SF1, the string route split the same way,
    then the sort), P11 (q3 shuffled, LONG and INT order keys, each at
    the default confs and as its static twin under STATIC_CONF, one pair
    a partition). Returns {path: (plan, launches, record)}."""
    m = port_modules()
    out = {}
    p9 = q1_tree(m, m.basic.InMemoryScanExec(q1_batches,
                                             q1_batches[0].schema), P_PARTS)
    if p9.child.child._scan_agg_spec is None:
        raise AssertionError("P9: the partial did not compile to a spec")
    rows, counts, exs, ms, io = drive_shuffled(
        "P9 q1 shuffled", p9, ["fused_scan_agg"], expect_p9)
    check_q1(rows, q1_want, "P9")
    out["P9"] = (p9, counts, {"first_run_ms": ms, "exchanges": exs,
                              "io": io, "decisions": p9._adaptive})
    print(f"P9 q1 shuffled ({P9_BATCHES} batches of "
          f"{q1_batches[0].num_rows_host} rows, {P_PARTS} partitions): "
          f"{len(rows)} groups equal to the numpy oracle in {ms:.1f} ms "
          f"(first run); adaptive decisions {p9._adaptive}; "
          f"{describe_exchanges(exs)}; io {io}; launches {counts}; shuffle "
          f"root empty, catalog empty, no permit held")
    p10 = tpch_q1_tree(m, scan_of(m, q1t_batch), n_parts=P_PARTS)
    rows, counts, exs, ms, io = drive_shuffled(
        "P10 TPC-H Q1 shuffled", p10, ["dma_row_gather"], expect_p10)
    check_rows(rows, q1t_want, "P10")
    if tuple(r[:2] for r in rows) != Q1_GROUPS:
        raise AssertionError(f"P10: groups {[r[:2] for r in rows]} != "
                             f"{Q1_GROUPS}")
    final = p10.child
    partial = final.child.child
    routes = {"partial": route_counts(partial), "final": route_counts(final)}
    out["P10"] = (p10, counts, {"first_run_ms": ms, "exchanges": exs,
                                "routes": routes, "io": io})
    print(f"P10 TPC-H Q1 shuffled ({q1t_batch.num_rows_host} lineitems, "
          f"{P_PARTS} partitions): {len(rows)} groups "
          f"{[r[:2] for r in rows]} equal to the numpy oracle in "
          f"{ms:.1f} ms (first run); routes {routes}; "
          f"{describe_exchanges(exs)}; io {io}; launches {counts}")
    for (key, data), static in itertools.product(
            (("LONG", d3), ("INT", d3i)), (False, True)):
        label = f"P11 q3 shuffled, {key} keys" + (", static" if static
                                                  else "")
        plan = p11_plan(data, dev, key, STATIC_CONF if static else None)
        rows, counts, exs, ms, io = drive_p11(label, plan, q3_want)
        pairs, stream = plan._p11_pairs
        if static and (plan._adaptive or pairs < 2):
            raise AssertionError(f"{label}: decisions {plan._adaptive}, "
                                 f"{pairs} partition pairs")
        rec = {"first_run_ms": ms, "exchanges": exs, "io": io,
               "decisions": plan._adaptive, "pairs": pairs,
               "stream_batches": stream,
               "row_gathers": plan._p11_row_gathers}
        out[("P11" if key == "LONG" else "P11_INT")
            + ("_static" if static else "")] = (plan, counts, rec)
        print(f"{label} ({Q3_LINES} x {Q3_ORDERS}, {P11_LINE_BATCHES} + "
              f"{P11_ORDER_BATCHES} batches, {P_PARTS} partitions): top 10 "
              f"equal to the numpy oracle in {ms:.1f} ms (first run); "
              f"{pairs} partition pairs joined, {stream} stream batches "
              f"probed; adaptive decisions {plan._adaptive}; row gathers "
              f"{plan._p11_row_gathers}; "
              f"{describe_exchanges(exs)}; io {io}; launches {counts}")
    return out


def time_shuffle_paths(paths, q1_want, q1t_want, q3_want):
    """P9-P11 in steady state: P_SHUFFLE_ITERS runs each, one
    synchronisation a run, each checked against its oracle; the
    exchanges' phase times per run from their metrics (ms: write, split,
    the split's fetch, serialize (the writer pool's wall) and LZ4 (summed
    over its threads), file IO, read wait, the read seam's upload pack)
    and the fetch's GB/s."""
    import torch
    checks = {"P9": lambda r: check_q1(r, q1_want, "P9 timed"),
              "P10": lambda r: check_rows(r, q1t_want, "P10 timed"),
              "P11": lambda r: check_q3(r, q3_want, "P11 timed")}
    recs = {}
    for name, check in checks.items():
        plan = paths[name][0]
        before = exchange_snapshot(plan)
        join = p11_join(plan)._join if name == "P11" else None
        join_before = join and (join.metrics["buildTime"].value,
                                join.metrics["joinTime"].value)
        runs = []
        for _ in range(P_SHUFFLE_ITERS):
            t0 = time.perf_counter()
            rows = plan.collect()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
            check(rows)
        shuffle_root_empty(f"{name} timed")
        check_idle(f"{name} timed")
        phases = []
        for a, b in zip(exchange_snapshot(plan), before):
            e = {k: (v - b[k]) / P_SHUFFLE_ITERS for k, v in a.items()}
            ph = {k: e[m_] / 1e6 for k, m_ in (
                ("write_ms", "shuffleWriteTime"),
                ("split_ms", "shufflePackTimeNs"),
                ("fetch_ms", "shuffleFetchTimeNs"),
                ("serialize_ms", "shuffleSerializeTimeNs"),
                ("lz4_thread_ms", "shuffleCompressTimeNs"),
                ("io_ms", "shuffleIoTimeNs"),
                ("read_wait_ms", "shuffleReadTime"),
                ("upload_pack_ms", "uploadPackTimeNs"))}
            ph["fetch_gb_s"] = e["shuffleFetchBytes"] / max(
                e["shuffleFetchTimeNs"], 1)
            ph["frames"] = e["numFramesWritten"]
            ph["raw_bytes"] = e["shuffleRawBytes"]
            ph["stored_bytes"] = e["dataSize"]
            phases.append(ph)
        recs[name] = {"ms": runs, "exchanges": phases}
        if join is not None:
            # the inner join's own host clock per run: its builds and its
            # probes (the rest is the exchanges and the aggregates)
            recs[name]["join_build_ms"], recs[name]["join_probe_ms"] = (
                (join.metrics[k].value - b) / P_SHUFFLE_ITERS / 1e6
                for k, b in zip(("buildTime", "joinTime"), join_before))
        print(f"{name} steady state: ms per run {runs} "
              f"({P_SHUFFLE_ITERS} runs, one sync each)"
              + (f", the join's builds {recs[name]['join_build_ms']:.1f} ms "
                 f"and probes {recs[name]['join_probe_ms']:.1f} ms a run"
                 if join is not None else "")
              + "; per run, by exchange: " + "; ".join(
                  ", ".join(f"{k} {v:.3f}" for k, v in ph.items())
                  for ph in phases))
    return recs


def split_fetch_rates(dev, d3, reps=5):
    """The split's one device->host copy on a q3 lineitem map batch
    (131,072 rows): fetch_split_host whole (the pack and the copy into
    pageable memory) and the copy alone, GB/s over the packed bytes."""
    import torch
    from spark_rapids_tpu_torch.columnar import transfer
    m = port_modules()
    _, l_schema = q3_schemas("LONG")
    b = q3_batches(d3, dev, l_schema, Q3_LINES, P11_LINE_BATCHES)[0]
    ex = shuffle_of(m, [m.core.col("l_orderkey")],
                    m.basic.InMemoryScanExec([b], l_schema), P_PARTS)
    counts, cols = ex._split_kernel(b, 0)
    buf = transfer.pack_split(counts, cols)
    nbytes = buf.shape[0]
    out = {"bytes": nbytes}
    for key, fn in (("fetch_split_host", lambda: transfer.fetch_split_host(
            counts, cols)), ("copy", lambda: buf.cpu())):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        out[key] = {"ms": ms, "gb_s": nbytes / ms / 1e6}
    print(f"the split's fetch of a {Q3_LINES // P11_LINE_BATCHES}-row q3 "
          f"lineitem map batch ({nbytes} bytes): fetch_split_host "
          f"{out['fetch_split_host']['ms']:.3f} ms "
          f"({out['fetch_split_host']['gb_s']:.2f} GB/s), the copy alone "
          f"{out['copy']['ms']:.3f} ms ({out['copy']['gb_s']:.2f} GB/s)")
    return out


def compare_pid_hash(dev, d3, d3i):
    """The murmur3 chain against its plain version at the exchange's pid
    shape: one q3 lineitem map batch's order key, seed 42, LONG and INT.
    Returns {key type: [the key column]}."""
    from spark_rapids_tpu_torch.ops import murmur3_lanes as m3
    from spark_rapids_tpu_torch.parallel.exchange import SHUFFLE_SEED
    out = {}
    for key, data in (("LONG", d3), ("INT", d3i)):
        _, l_schema = q3_schemas(key)
        b = q3_batches(data, dev, l_schema, Q3_LINES, P11_LINE_BATCHES)[0]
        cols = out[key] = [b.columns[0]]
        _exact(f"murmur3 pid {key}", m3.murmur3_columns(cols, [SHUFFLE_SEED]),
               m3.murmur3_columns_plain(cols, [SHUFFLE_SEED]))
        print(f"compare murmur3_columns at the pid shape ({b.capacity} "
              f"{key} keys, seed {SHUFFLE_SEED}): exact")
    return out


def time_pid_hash(pid_cols):
    """The murmur3 chain at the exchange's pid shape
    (`compare_pid_hash`'s columns), L2 cold, beside the plain version and
    the bound."""
    from spark_rapids_tpu_torch.ops import murmur3_lanes as m3
    from spark_rapids_tpu_torch.parallel.exchange import SHUFFLE_SEED
    out = {}
    for key, cols in pid_cols.items():
        n, w = cols[0].capacity, cols[0].data.element_size()
        ms = device_ms(lambda: m3.murmur3_columns(cols, [SHUFFLE_SEED]),
                       KERNEL_REPS)
        plain_ms = device_ms(
            lambda: m3.murmur3_columns_plain(cols, [SHUFFLE_SEED]),
            max(3, KERNEL_REPS // 4))
        b_ms, b_by = bound(n * (w + 1 + 4), n * m3_ops(w, 1))
        out[key] = {"rows": n, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by}
        print(f"murmur3_columns at the pid shape ({n} {key} keys, seed "
              f"{SHUFFLE_SEED}): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of the bound")
    return out


def shuffled_join_inputs(j):
    """JoinInputs of a ShuffledHashJoinExec built on the right, at its
    first partition pair with rows on both sides (its first stream
    batch); the exchanges' files go when their outer streams close."""
    j.stamp_inputs()
    lit_ = j.children[0].execute_partitions()
    rit = j.children[1].execute_partitions()
    try:
        for lp, rp in zip(lit_, rit):
            build = [b for b in rp if b.num_rows_host]
            stream = [b for b in lp if b.num_rows_host]
            if build and stream:
                break
        j._rscan.set_batches(build)
        j._lscan.set_batches(stream[:1])
        return JoinInputs(j._join)
    finally:
        lit_.close()
        rit.close()


def single_build_inputs(j):
    """JoinInputs of a ShuffledHashJoinExec built on the right, at its
    converted pass: every build partition's batches as one build, and the
    first batch with rows of the stream exchange's child (the exchange the
    pass skips). The build exchange's files go when its stream closes."""
    j.stamp_inputs()
    parts = j.children[1].execute_partitions()
    try:
        build = [b for part in parts for b in part if b.num_rows_host]
    finally:
        parts.close()
    src = j.children[0].child.execute()
    try:
        stream = next(b for b in src if b.num_rows_host)
    finally:
        src.close()
    j._rscan.set_batches(build)
    j._lscan.set_batches([stream])
    return JoinInputs(j._join)


def reorder_gathers(captured):
    """The exchange reorders among captured row gathers, one per distinct
    shape: {path: [calls]}."""
    out = {}
    for path, calls in captured.items():
        seen = {}
        for call in calls:
            site, plan, imat, fmat, idx = call
            if site != "exchange reorder":
                continue
            lb = 2 * fmat.shape[1] if fmat is not None else 0
            seen.setdefault((idx.shape[0], imat.shape[0], imat.shape[1], lb),
                            call)
        out[path] = list(seen.values())
    return out


# -- the q3 kernels against their plain versions ----------------------------

def _exact(label, got, want):
    import torch
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{label}: kernel != plain version")


def _random_ints(rng, n, np_dtype):
    info = np.iinfo(np_dtype)
    v = rng.integers(info.min, info.max, n, dtype=np_dtype, endpoint=True)
    edges = np.array([0, -1, info.min, info.max], dtype=np_dtype)
    v[: min(n, 4)] = edges[: min(n, 4)]
    return v


def _u32_seeds(rng, n):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
        np.uint32).view(np.int32)


#: every key type the murmur3 kernel hashes
M3_TYPES = ("BOOLEAN", "BYTE", "SHORT", "INT", "DATE", "LONG", "TIMESTAMP",
            "FLOAT", "DOUBLE")


def _m3_values(rng, n, type_name):
    """Keys of a type: integers with their edges and negatives, floats with
    NaNs of several payloads and signs, -0.0, 0.0 and infinities."""
    from spark_rapids_tpu_torch import types as t
    dt = getattr(t, type_name)
    if type_name == "BOOLEAN":
        return rng.integers(0, 2, n).astype(np.bool_)
    if type_name in ("FLOAT", "DOUBLE"):
        v = rng.normal(0, 1e6, n)
        v[::7], v[::11], v[::13] = np.nan, -0.0, 0.0
        v[::17], v[::19] = np.inf, -np.inf
        v = v.astype(dt.np_dtype)
        bits = v.view(np.uint64 if type_name == "DOUBLE" else np.uint32)
        bits[3::23] = (0xFFF0000000000001 if type_name == "DOUBLE"
                       else 0xFFC00001)
        return v
    return _random_ints(rng, n, dt.np_dtype)


def _m3_column(rng, dev, n, type_name, view):
    """A key column of n rows with ~20% nulls; as x[1:] views of its data
    and validity when `view`."""
    import torch
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.columnar.column import Column
    m = n + int(view)
    data = torch.from_numpy(_m3_values(rng, m, type_name)).to(dev)
    valid = torch.from_numpy(rng.random(m) > 0.2).to(dev)
    if view:
        data, valid = data[1:], valid[1:]
    return Column(data, valid, getattr(t, type_name))


def compare_murmur3(dev):
    """The murmur3 kernel against its plain version, exactly: the chain
    over every key type with nulls, aligned and as x[1:] views, at row
    counts ragged around a thread's rows (4) and a block's (1,024), at 0
    rows, over 1 to 4 columns in one launch and 5 and 9 in two and three,
    with one seed, two, and per-row seed planes; and the per-row-seed
    lanes (the TPU kernels' interface) on views and ragged sizes."""
    import torch
    from spark_rapids_tpu_torch.ops import hashing, murmur3_lanes as m3
    sizes = (0, 1, 3, 4, 5, 7, 9, 1023, 1024, 1025, 2049, 65537,
             (1 << 20) + 3)
    cases = 0
    for n in sizes:
        rng = np.random.default_rng(n)
        for ncols in (1, 2, 3, 4, 5, 9):
            names = [M3_TYPES[(i * 5 + n) % len(M3_TYPES)]
                     for i in range(ncols)]
            for view in (False, True):
                cols = [_m3_column(rng, dev, n, name, view and i % 2 == 0)
                        for i, name in enumerate(names)]
                plane = torch.from_numpy(_u32_seeds(rng, n + 1)).to(dev)
                for seeds in ([42], [0x5370_6172, 0x85EB_CA6B], [plane[:n]],
                              [plane[1:], -5]):
                    before = m3.murmur3_columns.launches
                    got = m3.murmur3_columns(cols, seeds)
                    launches = m3.murmur3_columns.launches - before
                    if launches != (-(-ncols // m3.MAX_COLS) if n else 0):
                        raise AssertionError(
                            f"murmur3_columns n={n} {ncols} columns: "
                            f"{launches} launches")
                    _exact(f"murmur3_columns n={n} {names} view={view} "
                           f"{len(seeds)} seeds", got,
                           m3.murmur3_columns_plain(cols, seeds))
                    cases += 1
    # each kind alone, both seeds, aligned and as views, past two blocks
    for name in M3_TYPES:
        for view in (False, True):
            rng = np.random.default_rng(len(name))
            c = _m3_column(rng, dev, 2049, name, view)
            _exact(f"murmur3_columns {name} view={view}",
                   m3.murmur3_columns([c], [42, 7]),
                   m3.murmur3_columns_plain([c], [42, 7]))
            col_seed = torch.from_numpy(_u32_seeds(rng, 2049)).to(dev)
            _exact(f"murmur3_column {name} view={view}",
                   [hashing.murmur3_column(c, col_seed)],
                   [hashing.murmur3_column_plain(c, col_seed)])
            cases += 2
    for n in (1, 9, 1000, 65537, (1 << 20) + 3):
        rng = np.random.default_rng(n)
        seeds = torch.from_numpy(_u32_seeds(rng, n + 1)).to(dev)
        v64 = torch.from_numpy(_random_ints(rng, n + 1, np.int64)).to(dev)
        v32 = torch.from_numpy(_random_ints(rng, n + 1, np.int32)).to(dev)
        for a, b in ((slice(0, n), slice(0, n)), (slice(1, None),
                                                  slice(1, None)),
                     (slice(1, None), slice(0, n))):
            _exact(f"murmur3_long n={n}",
                   [m3.murmur3_long_lanes(v64[a], seeds[b])],
                   [hashing.murmur3_long_plain(v64[a], seeds[b])])
            _exact(f"murmur3_int n={n}",
                   [m3.murmur3_int_lanes(v32[a], seeds[b])],
                   [hashing.murmur3_int_plain(v32[a], seeds[b])])
            cases += 2
    print(f"compare murmur3: {cases} cases (the chain over the 9 key types "
          f"with nulls, aligned and x[1:] views, {len(sizes)} row counts "
          f"from 0 to {sizes[-1]}, 1 to 9 columns in up to 3 launches, one "
          f"seed, two and per-row seed planes; the long and int lanes), "
          f"exact")


def _probe_case(rng, dev, n_stream, build_cap, n_lanes, dom, max_count,
                cand_cap, long_rows=0, empty_tiles=False, zero=False):
    """Random probe inputs: build lanes from a small domain (duplicate
    keys), ranges of 0..max_count candidates (empty ones included) over
    rows holding other keys too, ~5% invalid keys on both sides;
    optionally `long_rows` ranges longer than a tile of the kernel, every
    third tile wholly empty, or no candidate at all. A `cand_cap` of None
    is the candidate total."""
    import torch
    from spark_rapids_tpu_torch.ops.probe_verify import TILE
    counts = rng.integers(0, max_count + 1, n_stream).astype(np.int32)
    counts[rng.random(n_stream) < 0.3] = 0
    if long_rows:
        counts[rng.integers(0, n_stream, long_rows)] = 3 * TILE + 7
    if empty_tiles:
        for t in range(0, n_stream, 3 * TILE):
            counts[t: t + TILE] = 0
    if zero:
        counts[:] = 0
    lo = rng.integers(0, build_cap - max_count, n_stream).astype(np.int32)
    bk = rng.integers(0, dom, (build_cap, n_lanes)).astype(np.int32)
    sk = rng.integers(0, dom, (n_stream, n_lanes)).astype(np.int32)
    perm = rng.permutation(build_cap).astype(np.int32)
    args = [torch.from_numpy(x).to(dev) for x in (lo, counts, bk)] + [
        torch.from_numpy(rng.random(build_cap) > 0.05).to(dev),
        torch.from_numpy(sk).to(dev),
        torch.from_numpy(rng.random(n_stream) > 0.05).to(dev),
        torch.from_numpy(perm).to(dev)]
    total = int(counts.astype(np.int64).sum())
    return args, total if cand_cap is None else cand_cap, total


def compare_probe(label, args, cand_cap, total):
    """Kernel against the plain version: exact below the candidate total;
    (False, -1, -1, -1) above it."""
    import torch
    from spark_rapids_tpu_torch.ops import probe_verify as pv
    got = pv.fused_probe_verify(*args, cand_cap)
    want = pv.fused_probe_verify_plain(*args, cand_cap)
    live = min(total, cand_cap)
    _exact(label, [x[:live] for x in got], [x[:live] for x in want])
    v, s, p, r = (x[live:] for x in got)
    if bool(v.any()) or not all(bool((x == -1).all()) for x in (s, p, r)):
        raise AssertionError(f"{label}: slots past the total not empty")
    return int(got[0].sum())


def compare_probe_cases(dev):
    """The probe on random inputs: duplicate keys, one, two and three key
    lanes, a bucket below the total, ranges longer than a tile, wholly
    empty tiles, a total of 0, a total equal to the bucket, stream rows
    that are not a multiple of the tile, and over 1,000 tiles so that the
    look-back crosses many blocks; then the kernels' scratch must be
    zero again."""
    import torch
    from spark_rapids_tpu_torch.ops import probe_verify as pv
    rng = np.random.default_rng(21)
    cases = [
        ("probe dup keys L=2", (300_000, 1 << 16, 2, 50, 6, 1 << 20), {}),
        ("probe L=1 cap<total", (100_003, 1 << 12, 1, 9, 9, 1 << 17), {}),
        ("probe sparse", (65_537, 1 << 20, 2, 1 << 30, 2, 1 << 16), {}),
        ("probe L=3", (50_001, 1 << 12, 3, 4, 3, 1 << 17), {}),
        ("probe ranges longer than a tile",
         (300_000, 1 << 16, 2, 50, 3, 1 << 20), {"long_rows": 40}),
        ("probe empty tiles", (100_003, 1 << 14, 2, 50, 3, 1 << 18),
         {"empty_tiles": True}),
        ("probe total 0", (70_001, 1 << 12, 2, 50, 3, 1 << 12),
         {"zero": True}),
        ("probe total = bucket", (123_457, 1 << 14, 2, 50, 4, None), {}),
        ("probe 1,026 tiles L=1", (4_200_001, 1 << 18, 1, 1 << 16, 3,
                                   1 << 23), {}),
    ]
    for label, shape, opts in cases:
        args, cap, total = _probe_case(rng, dev, *shape, **opts)
        hits = compare_probe(label, args, cap, total)
        print(f"compare {label}: {args[1].shape[0]} stream rows "
              f"({pv.tile_count(args[1].shape[0])} tiles), total={total} "
              f"cand_cap={cap} verified={hits}, exact")
    torch.cuda.synchronize()
    if any(bool(b.any()) for b in pv._scratch.values()):
        raise AssertionError("probe: the kernel left its scratch non-zero")


def _gather_inputs(rng, dev, n_rows, n_out):
    import torch
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.columnar.column import Column
    from spark_rapids_tpu_torch.ops.rowpack import pack_rows
    dbl = rng.normal(0, 1e3, n_rows)
    dbl[::5] = np.nan
    cols = [Column.from_numpy(v, dt, device=dev,
                              validity=rng.random(n_rows) > 0.1)
            for v, dt in ((_random_ints(rng, n_rows, np.int64), t.LONG),
                          (dbl, t.DOUBLE),
                          (_random_ints(rng, n_rows, np.int32), t.INT),
                          (rng.random(n_rows) > 0.5, t.BOOLEAN),
                          (rng.random(n_rows), t.DOUBLE))]
    plan, imat, fmat = pack_rows(cols)
    cap = imat.shape[0]
    idx = rng.integers(0, cap, n_out).astype(np.int32)
    idx[::9] = -1
    idx[::13] = cap + 5
    idx[::17] = np.iinfo(np.int32).min
    return plan, imat, fmat, torch.from_numpy(idx).to(dev)


def _width_case(rng, dev, la, lb, cap, n_out, out_of_range=False):
    """An int32 (cap, la) matrix of random bits and, when lb, an f64 (cap,
    lb / 2) matrix of random bits (NaN payloads among them), with indices
    in range but for -1, cap + 5 and INT32_MIN among them, or all out of
    range."""
    import torch
    from types import SimpleNamespace
    imat = torch.from_numpy(_random_ints(rng, cap * la, np.int32)
                            .reshape(cap, la)).to(dev)
    fmat = torch.from_numpy(_random_ints(rng, cap * lb // 2, np.int64)
                            .reshape(cap, lb // 2)).to(dev).view(
                                torch.float64) if lb else None
    idx = rng.integers(0, cap, n_out).astype(np.int32)
    idx[::9] = -1
    idx[::13] = cap + 5
    idx[::17] = np.iinfo(np.int32).min
    if out_of_range:
        idx = np.where(idx % 2 == 0, -1, cap + idx % 7).astype(np.int32)
    return (SimpleNamespace(n_valid_lanes=1), imat, fmat,
            torch.from_numpy(idx).to(dev))


def compare_gather(dev):
    """The packed row gather against the plain version, exact bits: every
    (la, lb) that the main paths pack and widths that take the generic
    kernel, lb = 0, all indices out of range, slot counts that are not a
    multiple of the rows a thread takes, a matrix off its 16-byte
    alignment, and the packed columns of five types."""
    import torch
    from spark_rapids_tpu_torch.ops import row_gather as rg
    from spark_rapids_tpu_torch.ops.rowpack import gather_rows
    rng = np.random.default_rng(31)
    kinds = {}

    def check(label, plan, imat, fmat, idx):
        gi, gf = rg.pallas_gather_rows(plan, imat, fmat, idx)
        wi, wf = gather_rows(plan, imat, fmat, idx)
        _exact(label, [gi] + ([gf.view(torch.int64)] if gf is not None
                              else []),
               [wi] + ([wf.view(torch.int64)] if wf is not None else []))
        # contract: ok dispatch-ledger — reads the plan's kernel kind; launches nothing here
        k = rg.gather_launcher(plan, imat, fmat, idx)[2].kind
        kinds[k] = kinds.get(k, 0) + 1

    for la, lb in ((4, 0), (4, 4), (3, 2), (3, 6), (3, 0), (3, 4), (2, 2),
                   (6, 2), (9, 14), (5, 6), (2, 0)):
        for cap, n_out in ((1000, 1), (70_001, 65_537),
                           (1 << 20, 3 * (1 << 18) + 3)):
            for oor in (False, True):
                check(f"row gather ({la}, {lb}) {n_out} of {cap}"
                      f"{' all out of range' if oor else ''}",
                      *_width_case(rng, dev, la, lb, cap, n_out, oor))
    plan, imat, fmat, idx = _width_case(rng, dev, 4, 4, 4097, 10_001)
    flat = torch.empty(imat.numel() + 1, dtype=torch.int32, device=dev)
    off = flat[1:].view(imat.shape)
    off.copy_(imat)
    check("row gather (4, 4) matrix off alignment", plan, off, fmat, idx)
    for n_rows, n_out in ((1000, 1), (70_001, 65_537), (1 << 20, 3 << 19)):
        plan, imat, fmat, idx = _gather_inputs(rng, dev, n_rows, n_out)
        check(f"row gather packed n_out={n_out}", plan, imat, fmat, idx)
        safe = torch.where((idx >= 0) & (idx < imat.shape[0]), idx, 0)
        _exact(f"dma_row_gather n_out={n_out}",
               [rg.dma_row_gather(imat, idx)], [imat[safe.long()]])
    missing = (set(rg.FIXED.values()) | {rg.ANY}) - set(kinds)
    if missing:
        raise AssertionError(f"row gather: kernels not exercised {missing}")
    print(f"compare row gather: widths (4,0) (4,4) (3,2) (3,6) (3,0) (3,4) "
          f"(2,2) (6,2) (9,14) (5,6) (2,0) at 3 shapes, all out of range "
          f"too, a matrix "
          f"off alignment, packed columns of 5 types; kernels used "
          f"{ {rg.kind_name(k): v for k, v in kinds.items()} }; exact bits")


class JoinInputs:
    """The inputs a main path gives the join's hash and probe kernels,
    taken from the port's own join exec: its build table and stream keys,
    the candidate ranges and bucket."""

    def __init__(self, j):
        import torch
        from spark_rapids_tpu_torch.columnar.column import bucket_capacity
        from spark_rapids_tpu_torch.ops import hashing, join as oj
        j.stamp_inputs()
        build = j._build()
        stream = next(iter(j.children[j._stream_side].execute()))
        lo, counts, skeys, total = j._counts_kernel(build, stream)
        self.total = int(total)
        self.cand_cap = bucket_capacity(max(self.total, 1))
        sk_lanes, svalid = oj.int_key_lanes(skeys)
        bk_lanes, bvalid = build.key_lanes
        self.probe = [lo, counts, bk_lanes, bvalid, sk_lanes, svalid,
                      build.perm]
        self.build_rows, self.stream_rows = build.capacity, counts.shape[0]
        self.n_lanes = bk_lanes.shape[1]
        # the murmur3 chain's inputs: the build pair's keys, the stream's
        self.build_keys, self.stream_keys = build.key_cols, list(skeys)
        # the lanes' (rows 2 and 3): the stream key with the join seed as
        # a per-row plane
        key = skeys[0].data
        seed = hashing.i32_bits(torch.full_like(key, oj.JOIN_HASH_SEED,
                                                dtype=torch.int64))
        self.hash = (key, seed)


#: which call of a main path a row gather is, by the functions on its
#: stack (the first rule whose functions are all there names it)
GATHER_SITES = (
    (("reorder_columns",), "exchange reorder"),
    (("groupby_aggregate", "sort_batch_columns"), "group-by sort"),
    (("sort_batch_columns",), "sort"),
    (("_filter", "compact_columns"), "filter compaction"),
    (("compact_columns",), "exact-tier compaction"),
    (("build",), "build permute"),
    (("_emit_stream_flags",), "semi/anti compaction"),
    (("_emit_build_unmatched",), "unmatched build rows"),
    (("_join_stream",), "nested-loop chunk"),
    (("_probe_kernel", "gather_batch_columns"), "stream payload"),
    (("_probe_kernel",), "build payload"),
    (("_window_batch",), "window sort"),
    (("_explode",), "explode payload"),
)


def capture_row_gathers(plan):
    """Run `plan` once under a speculation scope and keep the inputs of
    every packed row gather it makes (each goes through the gather
    engine's `gather_rows`), in call order: [(site, pack plan, u32
    matrix, f64 matrix or None, int32 index)]."""
    import inspect
    import torch
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    from spark_rapids_tpu_torch.ops import gather as G
    calls, real = [], G.gather_rows

    def record(pack, imat, fmat, idx):
        names = {f.function for f in inspect.stack(0)[1:]}
        site = next((label for need, label in GATHER_SITES
                     if all(n in names for n in need)), "other")
        calls.append((site, pack, imat, fmat, idx.to(torch.int32).clone()))
        return real(pack, imat, fmat, idx)

    G.gather_rows = record
    try:
        with speculation_scope():
            list(plan.execute())
            torch.cuda.synchronize()
    finally:
        G.gather_rows = real
    return calls


def compare_join_inputs(label, inputs, gathers):
    """Each join kernel against its plain version, exactly, on a main
    path's own inputs: the stream keys' hash, the probe, and every row
    gather that the path makes (`capture_row_gathers`)."""
    from spark_rapids_tpu_torch.ops import join as oj, murmur3_lanes as m3
    pair = [oj.JOIN_HASH_SEED, oj.JOIN_HASH_SEED2]
    _exact(f"murmur3 {label} build pair",
           m3.murmur3_columns(inputs.build_keys, pair),
           m3.murmur3_columns_plain(inputs.build_keys, pair))
    _exact(f"murmur3 {label} stream keys",
           m3.murmur3_columns(inputs.stream_keys, pair[:1]),
           m3.murmur3_columns_plain(inputs.stream_keys, pair[:1]))
    hits = compare_probe(f"probe {label}", inputs.probe, inputs.cand_cap,
                         inputs.total)
    shapes = compare_row_gathers(label, gathers)
    print(f"compare {label} main-path inputs: murmur3 of "
          f"{inputs.build_rows} build keys (two seeds) and "
          f"{inputs.stream_rows} stream keys, probe of {inputs.stream_rows} "
          f"stream rows into {inputs.build_rows} build rows, candidate "
          f"total {inputs.total} in {inputs.cand_cap} slots, {hits} "
          f"verified pairs; row gathers "
          f"{'; '.join(shapes)}; exact")


def compare_row_gathers(label, gathers):
    """dma_row_gather against its plain version, exactly, at every row
    gather a main path made (`capture_row_gathers`); returns the shapes."""
    import torch
    from spark_rapids_tpu_torch.ops import row_gather as rg
    from spark_rapids_tpu_torch.ops.rowpack import gather_rows
    if not gathers:
        raise AssertionError(f"{label}: no row gather captured")
    shapes = {}
    for site, plan, imat, fmat, idx in gathers:
        got = rg.pallas_gather_rows(plan, imat, fmat, idx)
        want = gather_rows(plan, imat, fmat, idx)
        if [x is None for x in got] != [x is None for x in want]:
            raise AssertionError(f"row gather {label} {site}: kernel != "
                                 f"plain version")
        _exact(f"row gather {label} {site}",
               *([x.view(torch.int64) if x.is_floating_point() else x
                  for x in out if x is not None] for out in (got, want)))
        lb = 2 * fmat.shape[1] if fmat is not None else 0
        shape = (f"{site} {idx.shape[0]} of {imat.shape[0]} rows "
                 f"(la={imat.shape[1]}, lb={lb})")
        shapes[shape] = shapes.get(shape, 0) + 1
    # a shape met more than once (a nested-loop join's chunks, the
    # partitions of a shuffle) is printed once with its count
    return [s if n == 1 else f"{s} x{n}" for s, n in shapes.items()]


def capture_dict_gathers(plan):
    """Run `plan` once under a speculation scope and keep the inputs of
    every dictionary gather it launches (each `dict_take` goes through
    ops/dict_gather.dict_gather), in call order: [(table, index)]."""
    import torch
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    from spark_rapids_tpu_torch.ops import dict_gather as dg
    calls, real = [], dg.dict_gather

    def record(table, idx):
        calls.append((table.clone(), idx.clone()))
        return real(table, idx)

    # the wrapper counts its launches on the module's `dict_gather`, which
    # is `record` meanwhile; those launches are the capture's own
    record.launches = real.launches
    dg.dict_gather = record
    try:
        with speculation_scope():
            list(plan.execute())
            torch.cuda.synchronize()
    finally:
        dg.dict_gather = real
    return calls


def compare_dict_takes(label, takes):
    """dict_gather against dict_gather_plain, exactly, at every dictionary
    gather a main path made (`capture_dict_gathers`); returns the shapes
    (index rows x lanes into table entries, element bytes)."""
    from spark_rapids_tpu_torch.ops import dict_gather as dg
    if not takes:
        raise AssertionError(f"{label}: no dictionary gather captured")
    shapes = []
    for k, (t, i) in enumerate(takes):
        _exact(f"dict_gather {label} take {k}", [dg.dict_gather(t, i)],
               [dg.dict_gather_plain(t, i)])
        shapes.append(f"{i.shape[0]}x{i.shape[1]} codes into "
                      f"{t.shape[0]} entries of {t.element_size()} bytes")
    return shapes


# -- bounds -----------------------------------------------------------------

#: integer operations of murmur3 (mix_k1: 2 multiplies and a 3-op rotate
#: per 32-bit word, once a key whatever the seeds; mix_h1: xor, rotate,
#: multiply, add per word and seed; fmix 7 per seed)
M3_K1_OPS, M3_H1_OPS, M3_FMIX_OPS = 5, 6, 7


def m3_ops(width, seeds):
    """Operations of one key of `width` bytes into `seeds` running hashes,
    the null rule's select included."""
    words = 2 if width == 8 else 1
    return words * M3_K1_OPS + seeds * (words * M3_H1_OPS + M3_FMIX_OPS + 1)


def bound(nbytes, nops):
    """(bound ms, what bounds it) at the H100's published rates."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = nops / PEAK_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


# -- the murmur3 kernel against the composition it replaced -----------------

#: the murmur3 kernel that csrc/murmur3.cu replaced: one row a thread, a
#: u32 seed per row. Phase 4 times the murmur3 kernel against it and the
#: torch passes that murmur3_batch ran around it (`replaced_murmur3_batch`);
#: it is built here for that comparison and nothing else.
REPLACED_MURMUR3_SOURCE = r"""
#include <cuda_runtime.h>
#define C1 0xCC9E2D51u
#define C2 0x1B873593u
__device__ __forceinline__ unsigned rotl32(unsigned x, int r) {
    return (x << r) | (x >> (32 - r));
}
__device__ __forceinline__ unsigned mix_k1(unsigned k1) {
    return rotl32(k1 * C1, 15) * C2;
}
__device__ __forceinline__ unsigned mix_h1(unsigned h1, unsigned k1) {
    return rotl32(h1 ^ k1, 13) * 5u + 0xE6546B64u;
}
__device__ __forceinline__ unsigned fmix(unsigned h, unsigned length) {
    h ^= length; h ^= h >> 16; h *= 0x85EBCA6Bu; h ^= h >> 13;
    h *= 0xC2B2AE35u; return h ^ (h >> 16);
}
__global__ void replaced_m3_long(const unsigned long long* __restrict__ data,
                            const unsigned* __restrict__ seed,
                            unsigned* __restrict__ out, long long n) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += step) {
        const unsigned long long v = data[i];
        unsigned h = mix_h1(seed[i], mix_k1((unsigned)v));
        h = mix_h1(h, mix_k1((unsigned)(v >> 32)));
        out[i] = fmix(h, 8u);
    }
}
__global__ void replaced_m3_int(const unsigned* __restrict__ data,
                           const unsigned* __restrict__ seed,
                           unsigned* __restrict__ out, long long n) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += step) {
        out[i] = fmix(mix_h1(seed[i], mix_k1(data[i])), 4u);
    }
}
static int blocks_for(long long n, int threads) {
    long long b = (n + threads - 1) / threads;
    return (int)(b < 132 * 16 ? b : 132 * 16);
}
extern "C" int m3_long_run(const void* data, const void* seed, void* out,
                           long long n, void* stream) {
    if (n <= 0) return 0;
    replaced_m3_long<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)data, (const unsigned*)seed,
        (unsigned*)out, n);
    return (int)cudaGetLastError();
}
extern "C" int m3_int_run(const void* data, const void* seed, void* out,
                          long long n, void* stream) {
    if (n <= 0) return 0;
    replaced_m3_int<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (const unsigned*)data, (const unsigned*)seed, (unsigned*)out, n);
    return (int)cudaGetLastError();
}
"""


def replaced_lanes():
    """The replaced lane kernels, (data, seeds) -> out each: (long, int)."""
    import ctypes
    import torch
    from spark_rapids_tpu_torch.kernels import build
    lib = build.load(build.build(REPLACED_MURMUR3_SOURCE))

    def entry(name):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                               ctypes.c_void_p]

        def run(data, seeds):
            out = torch.empty_like(seeds)
            err = fn(data.data_ptr(), seeds.data_ptr(), out.data_ptr(),
                     data.numel(),
                     torch.cuda.current_stream(data.device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"replaced {name}: CUDA error {err}")
            return out
        return run
    return entry("m3_long_run"), entry("m3_int_run")


def replaced_murmur3_batch(lanes, columns, seed):
    """The replaced murmur3_batch over LONG or INT keys: the seed plane
    (full, & 0xFFFFFFFF, then ^, - and .to(int32) into int32 bits), then
    per column its lane kernel and the null rule's select."""
    import torch
    long_lanes, int_lanes = lanes
    c0 = columns[0]
    h = torch.full((c0.capacity,), seed, dtype=torch.int64,
                   device=c0.data.device)
    h = h & 0xFFFFFFFF
    h = ((h ^ 0x80000000) - 0x80000000).to(torch.int32)
    for col in columns:
        k = long_lanes if col.data.dtype == torch.int64 else int_lanes
        h = torch.where(col.validity, k(col.data, h), h)
    return h


def _m3_record(name, replaces, launches, ms, plain_ms, bnd, **extra):
    # max_abs_err is 0: phase 2 held every output of the murmur3 kernel
    # bit for bit against the plain version, and fails otherwise
    b_ms, b_by = bnd
    return {"name": name, "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/murmur3.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, **extra}


def in_turns(old, new, reps, old_flush=FLUSH_BYTES):
    """device_ms of two functions in turns (old, new, new, old, old, new,
    new, old): ([new's four runs], [old's four runs])."""
    olds, news = [], []
    for _ in range(2):
        olds.append(device_ms(old, reps, old_flush))
        news += [device_ms(new, reps) for _ in range(2)]
        olds.append(device_ms(old, reps, old_flush))
    return news, olds


def copy_ms(nbytes, reps):
    """A device copy moving `nbytes` (half read, half written): what this
    timing gives a pure stream of those bytes on this card."""
    import torch
    a = torch.ones(nbytes // 2, dtype=torch.uint8, device="cuda")
    b = torch.empty_like(a)
    return device_ms(lambda: b.copy_(a), reps)


def time_murmur3(inputs, int_inputs, q19_inputs, counts, int_counts):
    """The murmur3 kernel on the device, L2 cold, each time the median of
    four runs in turns with what it replaced. Rows 2 and 3 (the lanes with
    a per-row seed, the TPU kernels' interface) at q3's stream keys
    against the replaced kernel; then the chain (`murmur3_columns`) at the
    q3 build pair, the q3 stream and the Q19 stream against the
    composition it replaced (seed plane, lane kernel and select, once a
    seed; timed behind a 4x longer L2 flush so that the host enqueues its
    launches before the card reaches them); each beside the plain
    version, the bound and a copy of the same bytes. No one PyTorch call
    computes murmur3, so library_ms is null."""
    import statistics
    from spark_rapids_tpu_torch.ops import hashing, join as oj
    from spark_rapids_tpu_torch.ops import murmur3_lanes as m3
    reps, plain_reps = KERNEL_REPS, max(3, KERNEL_REPS // 4)
    med = statistics.median
    lanes = replaced_lanes()
    records = []
    for name, inp, cnt, width, fn, plain, old, line in (
            ("murmur3_long_lanes", inputs, counts, 8, m3.murmur3_long_lanes,
             hashing.murmur3_long_plain, lanes[0], 70),
            ("murmur3_int_lanes", int_inputs, int_counts, 4,
             m3.murmur3_int_lanes, hashing.murmur3_int_plain, lanes[1], 78)):
        key, seed = inp.hash
        n = key.shape[0]
        _exact(f"replaced {name}", [old(key, seed)], [plain(key, seed)])
        ms, old_ms = in_turns(lambda: old(key, seed), lambda: fn(key, seed),
                           reps)
        plain_ms = device_ms(lambda: plain(key, seed), plain_reps)
        nbytes = n * (width + 4 + 4)
        copy = copy_ms(nbytes, reps)
        b_ms, b_by = bound(nbytes, n * m3_ops(width, 1))
        print(f"{name} at {n} rows: {med(ms):.4f} ms (runs "
              f"{', '.join(f'{x:.4f}' for x in ms)}), the replaced kernel "
              f"{med(old_ms):.4f} ms (runs "
              f"{', '.join(f'{x:.4f}' for x in old_ms)})"
              f", plain {plain_ms:.4f} ms, a copy of its bytes {copy:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / med(ms):.1%} of "
              f"the bound")
        records.append(_m3_record(
            name, f"spark_rapids_tpu/ops/pallas_kernels.py:{line}",
            cnt[name], med(ms), plain_ms, (b_ms, b_by), ms_runs=ms,
            replaced_ms=med(old_ms), replaced_ms_runs=old_ms, copy_ms=copy))
    pair = (oj.JOIN_HASH_SEED, oj.JOIN_HASH_SEED2)
    sites = {}
    for site, cols, seeds in (
            ("q3 build pair", inputs.build_keys, pair),
            ("q3 stream", inputs.stream_keys, pair[:1]),
            ("q19 stream", q19_inputs.stream_keys, pair[:1])):
        n = cols[0].capacity
        _exact(f"replaced composition {site}",
               [replaced_murmur3_batch(lanes, cols, s) for s in seeds],
               m3.murmur3_columns(cols, seeds))

        def old(cols=cols, seeds=seeds):
            return [replaced_murmur3_batch(lanes, cols, s) for s in seeds]

        def new(cols=cols, seeds=seeds):
            return m3.murmur3_columns(cols, seeds)
        ms, old_ms = in_turns(old, new, reps, old_flush=4 * FLUSH_BYTES)
        plain_ms = device_ms(
            lambda: m3.murmur3_columns_plain(cols, seeds), plain_reps)
        widths = [c.data.element_size() for c in cols]
        nbytes = n * (sum(widths) + len(cols) + 4 * len(seeds))
        copy = copy_ms(nbytes, reps)
        b_ms, b_by = bound(nbytes,
                           n * sum(m3_ops(w, len(seeds)) for w in widths))
        print(f"murmur3_columns {site} ({n} rows, {len(cols)} column(s), "
              f"{len(seeds)} seed(s)): {med(ms):.4f} ms in one launch (runs "
              f"{', '.join(f'{x:.4f}' for x in ms)}), the replaced "
              f"composition {med(old_ms):.4f} ms (runs "
              f"{', '.join(f'{x:.4f}' for x in old_ms)})"
              f", plain {plain_ms:.4f} ms, a copy of its bytes {copy:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / med(ms):.1%} of "
              f"the bound")
        sites[site] = {"rows": n, "seeds": len(seeds), "ms": med(ms),
                       "ms_runs": ms, "replaced_ms": med(old_ms),
                       "replaced_ms_runs": old_ms,
                       "plain_ms": plain_ms, "copy_ms": copy,
                       "bound_ms": b_ms, "bound_by": b_by}
    q3s = sites["q3 stream"]
    records.append(_m3_record(
        "murmur3_columns", "spark_rapids_tpu/ops/pallas_kernels.py:70, "
        "spark_rapids_tpu/ops/pallas_kernels.py:78",
        counts["murmur3_columns"], q3s["ms"], q3s["plain_ms"],
        (q3s["bound_ms"], q3s["bound_by"]), ms_runs=q3s["ms_runs"],
        replaced_ms=q3s["replaced_ms"], sites=sites))
    return records


def probe_need(args, cap, total):
    """Bytes and operations the probe function needs on these inputs:
    every count read; lo, validity and key lanes of each stream row that
    owns a slot below `cap`; build lanes, validity and perm of each
    distinct build row a slot reads; 13 bytes written per slot; per live
    slot the build position, the clamp and the compares, 4 stores past
    the total."""
    import torch
    from spark_rapids_tpu_torch.ops import probe_verify as pv
    lo, counts = args[0], args[1]
    n, b, L = counts.shape[0], args[6].shape[0], args[2].shape[1]
    live = min(total, cap)
    _, s_idx, b_pos, _ = pv.fused_probe_verify_plain(*args, cap)
    owners = int(torch.unique(s_idx[:live]).numel())
    touched = int(torch.unique(b_pos[:live].clamp(0, b - 1)).numel())
    nbytes = 4 * n + owners * (4 + 1 + 4 * L) + touched * (4 * L + 1 + 4) \
        + 13 * cap
    return nbytes, live * (8 + 2 * L) + (cap - live) * 4


def time_probe_shape(label, inp):
    """fused_probe_verify at one join's inputs (JoinInputs): the wrapper's
    whole device work, its kernel launch alone, the plain version and the
    bound of what the function needs."""
    from spark_rapids_tpu_torch.ops import probe_verify as pv
    reps, plain_reps = KERNEL_REPS, max(3, KERNEL_REPS // 4)
    args, cap = inp.probe, inp.cand_cap
    # contract: ok dispatch-ledger — times the kernel alone; the compared launches count nothing
    _, launch = pv.launcher(*args, cap)
    launch()
    kernel_ms = device_ms(launch, reps)
    ms = device_ms(lambda: pv.fused_probe_verify(*args, cap), reps)
    plain_ms = device_ms(lambda: pv.fused_probe_verify_plain(*args, cap),
                         plain_reps)
    b_ms, b_by = bound(*probe_need(args, cap, inp.total))
    print(f"fused_probe_verify {label} ({inp.stream_rows} stream rows, "
          f"{pv.tile_count(inp.stream_rows)} tiles, {inp.build_rows} build "
          f"rows, total {inp.total} in {cap} slots): wrapper {ms:.4f} ms on "
          f"the device, kernel launch {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
          f"{b_ms / ms:.1%} of the bound")
    return {"max_abs_err": 0.0, "ms": ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "stream_rows": inp.stream_rows,
            "build_rows": inp.build_rows, "candidates": inp.total,
            "cand_cap": cap}


def time_probe(inputs, q19_inputs, launches):
    """fused_probe_verify at q3's and Q19's main-path inputs
    (time_probe_shape: comparable to the earlier records, which timed the
    wrapper). The record holds q3's shape with Q19's under "q19_shape"."""
    q3, q19 = (dict(time_probe_shape(label, inp), launches=launches[label])
               for label, inp in (("q3", inputs), ("q19", q19_inputs)))
    return {"name": "fused_probe_verify", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/probe_verify.cu",
            "replaces": "spark_rapids_tpu/ops/pallas_join.py:52", **q3,
            "q19_shape": q19}


def time_gather_call(path, site, plan, imat, fmat, idx, generic=True):
    """One captured row gather on the device, L2 cold: the kernel's
    launch alone, the wrapper's whole call, the plain version, the bound
    (the index, each distinct row an in-range index reads, row 0 once,
    every output row written) and the faster of the two PyTorch calls
    that compute the same function on the same matrix (index_select, a
    tensor index). With `generic`, a shape a fixed-width kernel serves is
    timed on the generic kernel too."""
    import torch
    from spark_rapids_tpu_torch.ops import row_gather as rg
    from spark_rapids_tpu_torch.ops.rowpack import gather_rows
    reps, plain_reps = KERNEL_REPS, max(3, KERNEL_REPS // 4)
    n, cap = idx.shape[0], imat.shape[0]
    lanes = imat.shape[1] + (2 * fmat.shape[1] if fmat is not None else 0)
    # contract: ok dispatch-ledger — times the kernel alone; the compared launches count nothing
    _, _, p, launch = rg.gather_launcher(plan, imat, fmat, idx)
    launch()
    kernel_ms = device_ms(launch, reps)
    ms = device_ms(lambda: rg.pallas_gather_rows(plan, imat, fmat, idx),
                   reps)
    plain_ms = device_ms(lambda: gather_rows(plan, imat, fmat, idx),
                         plain_reps)
    mat = torch.cat([imat] + ([fmat.view(torch.int32)]
                              if fmat is not None else []),
                    dim=1).contiguous()
    ok = (idx >= 0) & (idx < cap)
    safe = torch.where(ok, idx, 0).long()
    lib = {"index_select": device_ms(
               lambda: torch.index_select(mat, 0, safe), reps),
           "mat[idx]": device_ms(lambda: mat[safe], reps)}
    lib_name = min(lib, key=lib.get)
    rows_read = int(torch.unique(idx[ok]).numel())
    b_ms, b_by = bound(4 * n + 4 * lanes * (rows_read + 1 + n), 0)
    generic_ms = None
    if p.kind != rg.ANY and generic:
        # the generic kernel at the same shape: the matrices copied off
        # their pieces' alignment
        # contract: ok dispatch-ledger — times the generic kernel beside the specialised one, uncounted
        _, _, pg, launch_g = rg.launcher(
            idx, _off_aligned(imat), _off_aligned(fmat.view(torch.int32))
            if fmat is not None else None, plan.n_valid_lanes)
        if pg.kind != rg.ANY:
            raise AssertionError(f"{site}: the off-aligned copy still takes "
                                 f"{rg.kind_name(pg.kind)}")
        launch_g()
        generic_ms = device_ms(launch_g, reps)
    rec = {"path": path, "site": site, "n": n, "cap": cap,
           "la": imat.shape[1], "lb": lanes - imat.shape[1],
           "kernel": rg.kind_name(p.kind), "in_range": int(ok.sum()),
           "kernel_ms": kernel_ms, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib[lib_name], "library": lib_name,
           "index_select_ms": lib["index_select"],
           "generic_kernel_ms": generic_ms}
    print(f"dma_row_gather {path} {site} ({n} of {cap} rows, "
          f"{rec['in_range']} in range, la={rec['la']} lb={rec['lb']}, "
          f"kernel {rec['kernel']}): kernel {kernel_ms:.4f} ms, wrapper "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}), {b_ms / kernel_ms:.1%} of the bound; index_select "
          f"{lib['index_select']:.4f} ms, mat[idx] {lib['mat[idx]']:.4f} ms"
          + (f"; the generic kernel {generic_ms:.4f} ms"
             if generic_ms is not None else ""))
    return rec


def _off_aligned(m):
    """A copy of the int32 matrix `m` whose rows start 4 bytes past its
    allocation's 16-byte boundary."""
    import torch
    flat = torch.empty(m.numel() + 1, dtype=torch.int32, device=m.device)
    out = flat[1:].view(m.shape)
    out.copy_(m)
    return out


def time_row_gathers(paths, launches):
    """dma_row_gather at every shape the main paths give it (`paths`:
    {path: capture_row_gathers(plan)}): the kernel's launch alone, the
    wrapper's whole call, the plain version, the bound (the index, each
    distinct row an in-range index reads, row 0 once, every output row
    written) and the faster of the two PyTorch calls that compute the
    same function on the same matrix (index_select, a tensor index), all
    on the device with L2 cold. The record's own numbers are the q3
    stream payload's (the shape earlier records timed); "shapes" lists
    every shape and "per_iteration" sums each path's kernel time."""
    shapes, per_it, main = [], {}, None
    for path, calls in paths.items():
        per_it[path] = 0.0
        for call in calls:
            rec = time_gather_call(path, *call)
            per_it[path] += rec["kernel_ms"]
            shapes.append(rec)
            if path == "q3" and rec["site"] == "stream payload":
                main = rec
    print("dma_row_gather per iteration: " + ", ".join(
        f"{k} {v:.4f} ms in {len(paths[k])} launches"
        for k, v in per_it.items()))
    return {"name": "dma_row_gather", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/row_gather.cu",
            "replaces": "spark_rapids_tpu/ops/pallas_gather.py:101",
            "launches": launches, "max_abs_err": 0.0, "ms": main["ms"],
            "kernel_ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shapes": shapes,
            "per_iteration": per_it}


# -- the dictionary gather ---------------------------------------------------

#: the TPU kernel's shape (tools/exp_gather.py:158-165): an int32 table of
#: DG_TABLE x 128 and DG_ROWS x 128 indices in [0, DG_TABLE)
DG_TABLE, DG_ROWS = 4096, 16384


def _dg_inputs(dev, seed=41):
    import torch
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 1 << 30, (DG_TABLE, 128), dtype=np.int32)
    idx = rng.integers(0, DG_TABLE, (DG_ROWS, 128), dtype=np.int32)
    return torch.from_numpy(table).to(dev), torch.from_numpy(idx).to(dev)


def compare_dict_gather(dev, q19_lines):
    """The kernel against dict_gather_plain, exactly: dg's own shape; 1-
    and 4-byte tables with 1, 3, 5 and 128 lanes, one lane at n = 7,
    4096, just over the staged size and 1,048,576, with codes of -1, n
    and above on row counts that are not multiples of four, each also
    with the index and table taken as x[1:] views (off the 16-byte
    alignment for one lane); a 128-lane index view off alignment; and
    q19's l_shipmode take."""
    import torch
    from spark_rapids_tpu_torch.columnar.encoded import dict_take, literal_hits
    from spark_rapids_tpu_torch.ops import dict_gather as dg
    table, idx = _dg_inputs(dev)
    want = dg.dict_gather_plain(table, idx)
    _exact("dict_gather dg shape", [dg.dict_gather(table, idx)], [want])
    rng = np.random.default_rng(43)
    plans = {}
    for elt, dtype in ((1, torch.bool), (4, torch.int32)):
        for lanes in (1, 3, 5, 128):
            if lanes == 1:
                ns = (7, 4096, dg.STAGE_BYTES // elt + 1, 1 << 20)
                row_counts = (1, 1000, 65537, (1 << 20) + 3)
            else:
                ns = (7, 4096) + ((1 << 14,) if lanes == 128 else ())
                row_counts = (1, 1001, 16387)
            for n in ns:
                for rows in row_counts:
                    for view in (0, 1):
                        shape = (n + view, lanes)
                        if dtype == torch.bool:
                            t = rng.random(shape) > 0.5
                        else:
                            t = _random_ints(rng, shape[0] * lanes,
                                             np.int32).reshape(shape)
                        c = rng.integers(-2, n + 2, (rows + view) * lanes)
                        c[::7] = -1
                        c[::11] = n
                        c[::13] = np.iinfo(np.int32).max
                        c[::17] = np.iinfo(np.int32).min
                        t = torch.from_numpy(t).to(dev)[view:]
                        c = torch.from_numpy(c.astype(np.int32)).to(
                            dev).reshape(rows + view, lanes)[view:]
                        label = (f"dict_gather n={n} L={lanes} elt={elt} "
                                 f"rows={rows} view={view}")
                        got = dg.dict_gather(t, c)
                        _exact(label, [got], [dg.dict_gather_plain(t, c)])
                        plan = dg.plan_for(t, c, got)
                        key = ("scalar", "flat")[plan.kind] + (
                            " staged" if plan.staged else "") + (
                            " head" if plan.head else "")
                        plans[key] = plans.get(key, 0) + 1
    for elt, dtype in ((1, torch.uint8), (4, torch.int32)):
        t = torch.from_numpy(_random_ints(rng, 4096 * 128, np.int32)
                             .reshape(4096, 128)).to(dev).to(dtype)
        flat = torch.from_numpy(rng.integers(-1, 4097, 1001 * 128 + 1)
                                .astype(np.int32)).to(dev)
        c = flat[1:].view(1001, 128)
        # contract: ok dispatch-ledger — holds the kernel to its plain version, uncounted
        got, plan, launch = dg.launcher(t, c)
        launch()
        _exact(f"dict_gather 128 lanes elt={elt} index off alignment",
               [got], [dg.dict_gather_plain(t, c)])
        if plan.head != 3:
            raise AssertionError(f"index off alignment: plan {plan}")
    mode = q19_lines.column("l_shipmode")
    hit = literal_hits(mode, "AIR")
    _exact("dict_gather q19 l_shipmode take", [dict_take(hit, mode.codes)],
           [dg.dict_gather_plain(hit.reshape(-1, 1),
                                 mode.codes.reshape(-1, 1)).reshape(-1)])
    print(f"compare dict_gather: dg (4096, 128) x (16384, 128); 1- and "
          f"4-byte tables, L in (1, 3, 5, 128), aligned and x[1:] views, "
          f"plans {plans}; 128 lanes off alignment; q19 l_shipmode "
          f"{mode.capacity} codes; exact ({dg.sm_count()} SMs)")


def time_dict_gather(q19_lines, launches, p7_take, p7_launches):
    """The dictionary gather at q19's 1-byte take over the l_shipmode
    codes, at P7's take of the ship-mode hash table by the stream's codes
    (`p7_take`: (table, index) as captured) and at dg's shape: the
    kernel's launches alone (its plan and
    output made once) on the device with L2 cold, the same back to back
    (as PR 3 timed its wrapper), the wrapper's whole call, the plain
    version, the byte bound and the one PyTorch call that computes the
    same function (a table index for one lane; torch.gather) on the same
    inputs, the indices clamped and widened to int64 beforehand (PyTorch
    indexes with int64). Returns the kernel's record at the q19 take (the
    main path's shape, with its `launches`) holding under "p7_take" the
    same times at P7's take (with `p7_launches`, one P7 run's) and under
    "dg_shape" at dg's shape, which no path launches (launches 0)."""
    import torch
    from spark_rapids_tpu_torch.columnar.encoded import literal_hits
    from spark_rapids_tpu_torch.ops import dict_gather as dg
    reps, plain_reps = KERNEL_REPS, max(3, KERNEL_REPS // 4)
    dev = q19_lines.device
    table, idx = _dg_inputs(dev)
    idx64 = idx.long()
    mode = q19_lines.column("l_shipmode")
    hit = literal_hits(mode, "AIR").reshape(-1, 1)
    codes = mode.codes.reshape(-1, 1)
    safe64 = codes.clamp(0, hit.shape[0] - 1).reshape(-1).long()
    flat = hit.reshape(-1)
    p7_table, p7_codes = p7_take
    p7_flat = p7_table.reshape(-1)
    p7_safe64 = p7_codes.clamp(0, p7_table.shape[0] - 1).reshape(-1).long()
    out = []
    for label, t, i, lib, n_launches in (
            (f"q19 l_shipmode take, {codes.shape[0]} codes into "
             f"{hit.shape[0]} bool entries", hit, codes,
             lambda: flat[safe64], launches),
            (f"P7 ship-mode hash take, {p7_codes.shape[0]} codes into "
             f"{p7_table.shape[0]} int32 entries", p7_table, p7_codes,
             lambda: p7_flat[p7_safe64], p7_launches),
            ("dg (4096, 128) x (16384, 128) int32", table, idx,
             lambda: torch.gather(table, 0, idx64), 0)):
        rows, lanes = i.shape
        n, elt = t.shape[0], t.element_size()
        # contract: ok dispatch-ledger — times the kernel alone; the compared launches count nothing
        _, plan, launch = dg.launcher(t, i)
        launch()
        ms = device_ms(launch, reps)
        b2b_ms = cuda_ms(launch, reps)
        call_ms = device_ms(lambda: dg.dict_gather(t, i), reps)
        plain_ms = device_ms(lambda: dg.dict_gather_plain(t, i), plain_reps)
        lib_ms = device_ms(lib, reps)
        b = bound(rows * lanes * (4 + elt) + n * lanes * elt, 0)
        print(f"dict_gather {label}: kernel {ms:.4f} ms on the device, L2 "
              f"cold ({('scalar', 'flat')[plan.kind]}"
              f"{' staged' if plan.staged else ''}, {plan.grid} blocks), "
              f"{b2b_ms:.4f} ms back to back; wrapper call {call_ms:.4f} ms;"
              f" plain {plain_ms:.4f} ms; bound {b[0]:.4f} ms ({b[1]}), "
              f"{b[0] / ms:.1%} of the bound; library {lib_ms:.4f} ms")
        out.append({"launches": n_launches, "max_abs_err": 0.0, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b[0],
                    "bound_by": b[1], "library_ms": lib_ms})
    take, p7, dg_shape = out
    return {"name": "dict_gather", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/dict_gather.cu",
            "replaces": "tools/exp_gather.py:168", **take, "p7_take": p7,
            "dg_shape": dg_shape}


# -- slice 8: the planner and the session (phase 3c) -------------------------

#: the confs of the planned paths: q3, Q19 and P11 pin their aggregates to
#: the exact tier as the hand-built plans do (`_spec_enabled = False`);
#: P11 plans its joins over the host shuffle into P_PARTS partitions
#: instead of broadcasting the orders
Q3_CONF = {"spark.rapids.tpu.agg.speculative.enabled": "false"}
P11_CONF = dict(Q3_CONF, **{"spark.rapids.sql.shuffle.partitions":
                            str(P_PARTS),
                            "spark.rapids.sql.broadcastSizeThreshold": "-1"})
SESSION_ITERS = 5        # phase 4's session-against-hand-built runs each


def session_modules():
    """The port's session API, functions, expressions and planner."""
    from types import SimpleNamespace
    from spark_rapids_tpu_torch.api import functions, session
    from spark_rapids_tpu_torch.expr import core, predicates
    from spark_rapids_tpu_torch.plan import overrides
    return SimpleNamespace(core=core, pred=predicates, F=functions,
                           session=session, overrides=overrides)


def q1_df(m, sess, batches):
    """bench.py's q1 as a DataFrame query: filter -> select(disc_price)
    -> group by returnflag: sum, sum, count."""
    col, lit, F = m.core.col, m.core.lit, m.F
    df = sess.from_batches(batches, batches[0].schema)
    return (df.filter(col("quantity") <= lit(45))
            .select(col("returnflag"), col("quantity"),
                    (col("extendedprice") * (lit(1.0) - col("discount")))
                    .alias("disc_price"))
            .group_by("returnflag")
            .agg((F.sum("quantity"), "sum_qty"),
                 (F.sum("disc_price"), "sum_disc"), (F.count(), "cnt")))


def q3_df(m, sess, order_batches, line_batches):
    """bench.py's q3 as a DataFrame query: both sides filtered, joined on
    the order key, revenue by order, its top 10."""
    col, lit, F = m.core.col, m.core.lit, m.F
    lines = sess.from_batches(line_batches, line_batches[0].schema) \
        .filter(col("l_flag") != lit(0))
    orders = sess.from_batches(order_batches, order_batches[0].schema) \
        .filter(col("o_flag") < lit(5))
    return (lines.join(orders, left_on="l_orderkey", right_on="o_orderkey")
            .select(col("l_orderkey"),
                    (col("l_price") * (lit(1.0) - col("l_disc")))
                    .alias("rev"))
            .group_by("l_orderkey").agg((F.sum("rev"), "revenue"))
            .sort((col("revenue"), False)).limit(10))


def q19_df(m, sess, l_batch, p_batch, terms=Q19_TERMS, span=Q19_QTY_SPAN,
           shipmodes=Q19_SHIPMODES):
    """TPC-H Q19 as a DataFrame query (q19_tree's predicates): the
    filtered lineitems joined to the filtered parts on the part key with
    the three-way OR as the join's condition, then the grand sum."""
    col, lit, pr, F = m.core.col, m.core.lit, m.pred, m.F

    def all_of(*es):
        out = es[0]
        for e in es[1:]:
            out = pr.And(out, e)
        return out

    def any_of(*es):
        out = es[0]
        for e in es[1:]:
            out = pr.Or(out, e)
        return out

    ship = [pr.In(col("l_shipmode"), list(shipmodes)),
            pr.EqualTo(col("l_shipinstruct"), lit(Q19_INSTRUCT))]
    part_terms, terms_all = [], []
    for brand, containers, q, s in terms:
        part = [pr.EqualTo(col("p_brand"), lit(brand)),
                pr.In(col("p_container"), list(containers))]
        part_terms.append(all_of(*part, pr.LessThanOrEqual(col("p_size"),
                                                           lit(s))))
        terms_all.append(all_of(
            *part,
            pr.GreaterThanOrEqual(col("l_quantity"), lit(float(q))),
            pr.LessThanOrEqual(col("l_quantity"), lit(float(q + span))),
            pr.GreaterThanOrEqual(col("p_size"), lit(1)),
            pr.LessThanOrEqual(col("p_size"), lit(s)), *ship))
    lines = sess.from_batches([l_batch], l_batch.schema) \
        .filter(all_of(*ship))
    parts = sess.from_batches([p_batch], p_batch.schema).filter(
        pr.And(pr.GreaterThanOrEqual(col("p_size"), lit(1)),
               any_of(*part_terms)))
    return (lines.join(parts, left_on="l_partkey", right_on="p_partkey",
                       condition=any_of(*terms_all))
            .select(col("l_extendedprice"), col("l_discount"))
            .agg((F.sum(col("l_extendedprice")
                        * (lit(1.0) - col("l_discount"))), "revenue")))


def tpch_q1_df(m, sess, l_batch, cutoff=None):
    """TPC-H Q1 (P6) as a DataFrame query: tpch_q1_tree's filter, its
    eight aggregates by the two string flags, ordered by them."""
    col, lit, F = m.core.col, m.core.lit, m.F
    cutoff = lit(Q1_SHIP_CUTOFF) if cutoff is None else cutoff
    price, disc = col("l_extendedprice"), col("l_discount")
    disc_price = price * (lit(1.0) - disc)
    return (sess.from_batches([l_batch], l_batch.schema)
            .filter(m.pred.LessThanOrEqual(col("l_shipdate"), cutoff))
            .group_by("l_returnflag", "l_linestatus")
            .agg((F.sum("l_quantity"), "sum_qty"),
                 (F.sum(price), "sum_base_price"),
                 (F.sum(disc_price), "sum_disc_price"),
                 (F.sum(disc_price * (lit(1.0) + col("l_tax"))),
                  "sum_charge"),
                 (F.avg("l_quantity"), "avg_qty"), (F.avg(price), "avg_price"),
                 (F.avg(disc), "avg_disc"), (F.count(), "count_order"))
            .sort("l_returnflag", "l_linestatus"))


def planned(m, df):
    """df's plan through the session's planner, timed: (exec tree, ms of
    wrap_and_tag, ms of convert). A plan that cannot run raises with the
    explain text, and the execs are built under the session's conf, as
    apply() does."""
    m.session.set_active_conf(df.session.conf)
    if hasattr(df.session, "mesh"):
        # the planner and the exchanges read the session's mesh
        import importlib
        importlib.import_module(m.session.__name__.split(".")[0]
                                + ".parallel.mesh").set_active_mesh(
            df.session.mesh)
    overrides = m.overrides.TpuOverrides(df.session.conf)
    t0 = time.perf_counter()
    meta = overrides.wrap_and_tag(df.logical_plan())
    t1 = time.perf_counter()
    if not overrides._all_ok(meta):
        raise m.overrides.PlanNotSupported(meta.explain())
    tree = meta.convert()
    t2 = time.perf_counter()
    return tree, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def exec_nodes(node):
    out = [node]
    for c in node.children:
        out.extend(exec_nodes(c))
    return out


def plan_shape(node):
    """An exec tree's classes, nested, with the scan under a coalesce
    reduced to its leaf ("Scan"): the shape the planner and the
    hand-built plans share."""
    name = type(node).__name__
    if name in ("CoalesceBatchesExec", "SourceScanExec", "InMemoryScanExec"):
        return "Scan"
    return (name, tuple(plan_shape(c) for c in node.children))


def explain_launches(label, tree, counts, hand_counts):
    """Every kernel whose launches differ from the hand-built plan's, with
    the planned node that accounts for it; a difference no node accounts
    for raises. A FilterExec below a BroadcastExchangeExec compacts its
    batches (one packed row gather each), where the hand-built join masks
    its build side's keys instead; a CoalesceBatchesExec that merged its
    input batches runs the operators above it over fewer batches."""
    nodes = exec_nodes(tree)
    compacted = sum(
        n.child.child.metrics["numOutputBatches"].value
        for n in nodes if type(n).__name__ == "BroadcastExchangeExec"
        and type(n.child).__name__ == "FilterExec"
        and type(n.child.child).__name__ == "CoalesceBatchesExec")
    merges = [(n.metrics["numInputBatches"].value,
               n.metrics["numOutputBatches"].value) for n in nodes
              if type(n).__name__ == "CoalesceBatchesExec"
              and n.metrics["numInputBatches"].value
              > n.metrics["numOutputBatches"].value]
    notes = []
    for name in sorted(counts):
        d = counts[name] - hand_counts[name]
        if d == 0:
            continue
        if name == "dma_row_gather" and d == compacted and not merges:
            notes.append(f"{name} {counts[name]} (hand-built "
                         f"{hand_counts[name]}): BroadcastExchangeExec over "
                         f"FilterExec compacts {compacted} build batch(es) "
                         f"the hand-built join masks")
        elif d < 0 and merges:
            merged = " and ".join(f"{a} batches into {b}" for a, b in merges)
            notes.append(f"{name} {counts[name]} (hand-built "
                         f"{hand_counts[name]}): CoalesceBatchesExec merged "
                         f"{merged}")
        else:
            raise AssertionError(f"{label}: {name} launched {counts[name]} "
                                 f"times, the hand-built plan "
                                 f"{hand_counts[name]}, and no planned node "
                                 f"accounts for it")
    return notes


def drive_planned(label, m, df, need, hand_counts, check, hand_shape=None):
    """Phase 3c for one query: print its explain text, plan it (timed),
    check its shape against the hand-built plan's when given, drive it
    once counted (drive_batches: the speculation flags must stay False),
    hold its rows with `check`, explain every launch count that differs
    from the hand-built plan's (when there is one: `hand_counts`), then
    collect() it through the session once more, counted, which must
    launch the same. `check(rows, label, operator metrics)` raises on a
    wrong result. Returns a record."""
    print(f"{label} explain:\n{df.explain()}")
    tree, tag_ms, convert_ms = planned(m, df)
    shape = plan_shape(tree)
    if hand_shape is not None and shape != hand_shape:
        raise AssertionError(f"{label}: planned {shape} != hand-built "
                             f"{hand_shape}")
    out, counts, reads = drive_batches(label, tree, need)
    check([r for b in out for r in b.to_pylist()], label,
          m.session._operator_metrics(tree))
    notes = explain_launches(label, tree, counts, hand_counts) \
        if hand_counts is not None else []
    from spark_rapids_tpu_torch.exec import stage_compiler
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    sized0 = stage_compiler.counters()["sizing_launches"]
    t0 = time.perf_counter()
    rows = df.collect()
    collect_ms = (time.perf_counter() - t0) * 1e3
    again = {name: w.launches for name, w in wrappers.items()}
    check(rows, label + " collect()", df.session.last_query_metrics())
    # collect() runs the plan's compiled stages (the tree counted above is
    # the converted one): a join_agg stage's cold sizing pass runs the
    # probe's counts once more than the per-operator join
    sized = {k: v - sized0.get(k, 0) for k, v in
             stage_compiler.counters()["sizing_launches"].items()}
    if again != {k: v + sized.get(k, 0) for k, v in counts.items()}:
        raise AssertionError(f"{label}: collect() launched {again}, the "
                             f"counted run {counts} and the stages' "
                             f"sizing passes {sized}")
    if any(sized.values()):
        notes.append(f"collect() launched {again}: the counted run's plus "
                     f"a join_agg stage's cold sizing pass {sized}")
    check_idle(label)
    shuffle_root_empty(label)
    print(f"{label}: plan {tag_ms + convert_ms:.3f} ms (wrap_and_tag "
          f"{tag_ms:.3f}, convert {convert_ms:.3f}); collect() "
          f"{collect_ms:.3f} ms (its plan included, one run); launches "
          f"{counts}; hand-built {hand_counts}; host reads {reads}")
    for note in notes:
        print(f"  {label}: {note}")
    return {"plan_ms": tag_ms + convert_ms, "wrap_and_tag_ms": tag_ms,
            "convert_ms": convert_ms, "collect_ms": collect_ms,
            "launches": counts, "collect_launches": again,
            "hand_built_launches": hand_counts, "differences": notes,
            "host_reads": reads, "shape": repr(shape)}


def time_session_paths(paths):
    """Phase 4: each of q1, q3 and Q19 through the session (plan
    included: df.collect()) and as its hand-built plan (plan.collect()),
    in turns, SESSION_ITERS runs each, one synchronisation a run.
    `paths` maps a label to (df, hand-built plan, check(rows, label))."""
    import torch
    out = {}
    for label, (df, hand, check) in paths.items():
        ms = {"session": [], "hand_built": []}
        for i in range(SESSION_ITERS):
            order = ("hand_built", "session") if i % 2 == 0 \
                else ("session", "hand_built")
            for k in order:
                t0 = time.perf_counter()
                rows = df.collect() if k == "session" else hand.collect()
                torch.cuda.synchronize()
                ms[k].append((time.perf_counter() - t0) * 1e3)
                check(rows, f"{label} {k}")
        out[label] = ms
        print(f"{label} ms per run, in turns ({SESSION_ITERS} each): "
              f"session {[round(x, 3) for x in ms['session']]}, hand-built "
              f"{[round(x, 3) for x in ms['hand_built']]}")
    return out


# -- slice 9: the join types, the nested-loop join and the basic operators
# -- (phase 3d) -------------------------------------------------------------

TPCH_SF = 1.0            # P12, P13 and P16 at TPC-H SF1 (clause 4.2.3)
#: clause 4.2.3's order priorities and the 25 nations by n_nationkey
ORDER_PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                    "5-LOW")
NATIONS = ("ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
           "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN",
           "JORDAN", "KENYA", "MOROCCO", "PERU", "CHINA", "ROMANIA",
           "SAUDI ARABIA", "VIETNAM", "RUSSIA", "UNITED KINGDOM",
           "UNITED STATES", "MOZAMBIQUE")
ORDER_STATUSES = ("F", "O", "P")
Q4_DATE = datetime.date(1993, 7, 1)      # clause 2.4.4.3's DATE
Q4_END = datetime.date(1993, 10, 1)      # DATE + 3 months
Q21_NATION = "SAUDI ARABIA"              # clause 2.4.21.3's NATION
Q21_LIMIT = 100
P14_KINDS = (("inner", "right"), ("inner", "left"), ("left_outer", "right"),
             ("left_outer", "left"), ("right_outer", "right"),
             ("right_outer", "left"), ("full_outer", "right"),
             ("full_outer", "left"), ("left_semi", "right"),
             ("left_anti", "right"), ("existence", "right"))
P15_LINES = 1 << 20      # P15's lineitems
P15_BANDS = 11           # discount bands [k/100, (k+1)/100), k = 0..10
P_JOIN_ITERS = 3         # phase 4's timed runs of P12-P16 each
#: P13's conf, broadcasts off: every join a hash join the plan builds as
#: it stands. At the default confs a join whose side has no size estimate
#: (a join below it) takes AdaptiveJoinExec, which phase 3i drives (P32)
Q21_CONF = dict(Q3_CONF, **{"spark.rapids.sql.broadcastSizeThreshold": "-1"})
#: P15's conf: the exact aggregate, as q3's (the chunks' band ranges
#: differ, and the speculative tier would trip and re-run)
P15_CONF = Q3_CONF
P16_CONF = P11_CONF


def days(date):
    return (date - datetime.date(1970, 1, 1)).days


def tpch_join_data(sf=TPCH_SF, seed=21):
    """orders, lineitem, supplier and nation by TPC-H's generation rules
    (clause 4.2.3) at scale factor `sf`, from a fixed seed: sparse order
    keys (8 of every 32), 1-7 lines an order, l_suppkey by the partsupp
    formula over a random part, the ship, commit and receipt dates off
    the order date, o_orderstatus from its lines' statuses, and suppliers
    spread over the 25 nations. A string column is (int32 codes, values)."""
    rng = np.random.default_rng(seed)
    n_orders, n_supp = int(sf * 1_500_000), max(int(sf * 10_000), 4)
    n_part = max(int(sf * 200_000), 1)
    i = np.arange(n_orders, dtype=np.int64)
    okey = (i // 8) * 32 + i % 8 + 1
    odate = rng.integers(ORDER_DATE_FIRST, ORDER_DATE_LAST + 1, n_orders)
    nlines = rng.integers(1, 8, n_orders)
    owner = np.repeat(i, nlines)
    n_line = owner.shape[0]
    part = rng.integers(1, n_part + 1, n_line)
    corner = rng.integers(0, 4, n_line)
    supp = (part + corner * (n_supp // 4 + (part - 1) // n_supp)) \
        % n_supp + 1
    od = odate[owner]
    ship = od + rng.integers(1, 122, n_line)
    commit = od + rng.integers(30, 91, n_line)
    receipt = ship + rng.integers(1, 31, n_line)
    shipped = np.bincount(owner, weights=ship <= CURRENT_DATE,
                          minlength=n_orders)
    status = np.where(shipped == nlines, 0, np.where(shipped == 0, 1, 2))
    return {
        "o_orderkey": okey, "o_orderdate": odate.astype(np.int32),
        "o_orderpriority": (rng.integers(0, 5, n_orders).astype(np.int32),
                            ORDER_PRIORITIES),
        "o_orderstatus": (status.astype(np.int32), ORDER_STATUSES),
        "l_orderkey": okey[owner], "l_suppkey": supp.astype(np.int64),
        "l_shipdate": ship.astype(np.int32),
        "l_commitdate": commit.astype(np.int32),
        "l_receiptdate": receipt.astype(np.int32),
        "l_discount": rng.integers(0, 11, n_line) / 100.0,
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
        "s_name": (np.arange(n_supp, dtype=np.int32),
                   tuple(f"Supplier#{k:09d}" for k in range(1, n_supp + 1))),
        "s_nationkey": rng.integers(0, 25, n_supp).astype(np.int32),
        "n_nationkey": np.arange(25, dtype=np.int32),
        "n_name": (np.arange(25, dtype=np.int32), NATIONS)}


#: the tables' columns: (name, type, encoded) — an encoded STRING column
#: is a DictionaryColumn, the others StringColumns (group and sort keys)
JOIN_TABLES = {
    "orders": (("o_orderkey", "LONG", False), ("o_orderdate", "DATE", False),
               ("o_orderpriority", "STRING", False),
               ("o_orderstatus", "STRING", True)),
    "lineitem": (("l_orderkey", "LONG", False), ("l_suppkey", "LONG", False),
                 ("l_shipdate", "DATE", False),
                 ("l_commitdate", "DATE", False),
                 ("l_receiptdate", "DATE", False),
                 ("l_discount", "DOUBLE", False)),
    "supplier": (("s_suppkey", "LONG", False), ("s_name", "STRING", False),
                 ("s_nationkey", "INT", False)),
    "nation": (("n_nationkey", "INT", False), ("n_name", "STRING", True))}


def join_table_spec(d, table, rows=None):
    """A table's columns as {name: (values, type name, None)}, the form
    the parity tests build both packages' batches from: an encoded column
    as (codes, values), a plain string column as a list of str."""
    out = {}
    for name, ty, encoded in JOIN_TABLES[table]:
        v = d[name]
        if isinstance(v, tuple):
            codes = v[0] if rows is None else v[0][rows]
            v = (codes, v[1]) if encoded else [v[1][c] for c in codes]
        elif rows is not None:
            v = v[rows]
        out[name] = (v, ty, None)
    return out


def string_column(codes, words, dev):
    """A StringColumn of words[codes], built without a Python loop over
    the rows."""
    from spark_rapids_tpu_torch.columnar.column import StringColumn
    enc = [w.encode("utf-8") for w in words]
    lens = np.array([len(b) for b in enc], np.int64)
    width = max(int(lens.max()), 1)
    mat = np.zeros((len(enc), width), np.uint8)
    for k, b in enumerate(enc):
        mat[k, :len(b)] = np.frombuffer(b, np.uint8)
    row_lens = lens[codes]
    keep = np.arange(width)[None, :] < row_lens[:, None]
    offsets = np.concatenate([[0], np.cumsum(row_lens)]).astype(np.int32)
    return StringColumn.from_numpy(mat[codes][keep], offsets, device=dev)


def join_batch(d, table, dev, rows=None):
    """One table of tpch_join_data as a port batch on `dev` (optionally
    the rows `rows` only)."""
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column, string_buffers
    from spark_rapids_tpu_torch.columnar.encoded import dictionary_from_numpy
    cols, n = [], None
    for name, ty, encoded in JOIN_TABLES[table]:
        v = d[name]
        if isinstance(v, tuple):
            codes = v[0] if rows is None else v[0][rows]
            cols.append(dictionary_from_numpy(
                codes, *string_buffers(v[1]), device=dev) if encoded
                else string_column(codes, v[1], dev))
            n = codes.shape[0]
        else:
            v = v if rows is None else v[rows]
            cols.append(Column.from_numpy(v, getattr(t, ty), device=dev))
            n = v.shape[0]
    schema = t.Schema(tuple(t.StructField(name, getattr(t, ty))
                            for name, ty, _ in JOIN_TABLES[table]))
    return ColumnarBatch(cols, n, schema)


def join_batches(d, dev):
    return {k: join_batch(d, k, dev) for k in JOIN_TABLES}


def date_lit(m, date):
    """A DATE literal as days since the epoch, in either package."""
    return m.core.Literal(days(date), m.t.DATE)


def q4_tree(m, orders_scan, lines_scan, anti=False, n_parts=None):
    """TPC-H Q4 (clause 2.4.4) as Spark plans it, in the package `m`
    holds: the orders of the quarter left-semi-joined (NOT EXISTS:
    left-anti) to the lineitems with l_commitdate < l_receiptdate on the
    order key, the lineitems built on the right; count(*) by
    o_orderpriority, ordered by it. With `n_parts` (P16) both sides are
    hash-exchanged on the order key into a ShuffledHashJoinExec and the
    count split into partial -> exchange -> final, without the sort."""
    col, pr = m.core.col, m.pred
    orders = m.basic.FilterExec(pr.And(
        pr.GreaterThanOrEqual(col("o_orderdate"), date_lit(m, Q4_DATE)),
        pr.LessThan(col("o_orderdate"), date_lit(m, Q4_END))), orders_scan)
    lines = m.basic.FilterExec(
        pr.LessThan(col("l_commitdate"), col("l_receiptdate")), lines_scan)
    ok, lk = [col("o_orderkey")], [col("l_orderkey")]
    jt = "left_anti" if anti else "left_semi"
    if n_parts is None:
        joined = m.joins.HashJoinExec(orders, lines, ok, lk, jt,
                                      build_side="right")
    else:
        joined = m.exchange.ShuffledHashJoinExec(
            shuffle_of(m, ok, orders, n_parts),
            shuffle_of(m, lk, lines, n_parts), ok, lk, jt,
            build_side="right")
    group = [col("o_orderpriority")]
    aggs = [(m.aggexprs.Count(), "order_count")]
    if n_parts is not None:
        return shuffled_aggregate(m, group, aggs, joined, n_parts)
    agg = m.agg.AggregateExec(group, aggs, joined)
    return m.sort.SortExec([(col("o_orderpriority"), True)], agg)


def q4_oracle(d, anti=False):
    """Q4 in numpy: (o_orderpriority, order_count) in priority order."""
    n_orders = d["o_orderkey"].shape[0]
    late = d["l_commitdate"] < d["l_receiptdate"]
    owner = order_index(d["l_orderkey"][late])
    has = np.bincount(owner, minlength=n_orders) > 0
    od = d["o_orderdate"]
    keep = (od >= days(Q4_DATE)) & (od < days(Q4_END)) \
        & (~has if anti else has)
    counts = np.bincount(d["o_orderpriority"][0][keep], minlength=5)
    return [(ORDER_PRIORITIES[k], int(counts[k])) for k in range(5)
            if counts[k]]


def order_index(keys):
    """Row of each sparse order key (clause 4.2.3's 8 of every 32)."""
    k = keys - 1
    return (k // 32) * 8 + k % 32


def ne(m, a, b):
    return m.pred.Not(m.pred.EqualTo(m.core.col(a), m.core.col(b)))


def q21_tree(m, lines_scan, l2_scan, l3_scan, supp_scan, orders_scan,
             nation_scan, nation=Q21_NATION):
    """TPC-H Q21 (clause 2.4.21) as Spark's optimizer plans it, in the
    package `m` holds: l1 (l_receiptdate > l_commitdate) left-semi-joined
    to l2 on the order key with l2_suppkey <> l_suppkey, left-anti-joined
    to l3 (late lines) with the same condition, then inner joins to the
    suppliers, the orders with o_orderstatus = 'F' and the nation
    `nation` (clause 2.4.21.3's 'SAUDI ARABIA'), each built on the right; count(*) by s_name,
    TopN(100) by numwait DESC, s_name. l2 and l3 are the lineitem scan
    under renaming projections."""
    col, lit, pr, b = m.core.col, m.core.lit, m.pred, m.basic
    l1 = b.FilterExec(pr.GreaterThan(col("l_receiptdate"),
                                     col("l_commitdate")), lines_scan)
    l3 = b.FilterExec(pr.GreaterThan(col("l3_receiptdate"),
                                     col("l3_commitdate")), l3_scan)
    semi = m.joins.HashJoinExec(
        l1, l2_scan, [col("l_orderkey")], [col("l2_orderkey")], "left_semi",
        build_side="right", condition=ne(m, "l2_suppkey", "l_suppkey"))
    anti = m.joins.HashJoinExec(
        semi, l3, [col("l_orderkey")], [col("l3_orderkey")], "left_anti",
        build_side="right", condition=ne(m, "l3_suppkey", "l_suppkey"))
    with_s = m.joins.HashJoinExec(anti, supp_scan, [col("l_suppkey")],
                                  [col("s_suppkey")], "inner")
    orders = b.FilterExec(pr.EqualTo(col("o_orderstatus"), lit("F")),
                          orders_scan)
    with_o = m.joins.HashJoinExec(with_s, orders, [col("l_orderkey")],
                                  [col("o_orderkey")], "inner")
    nation = b.FilterExec(pr.EqualTo(col("n_name"), lit(nation)),
                          nation_scan)
    with_n = m.joins.HashJoinExec(with_o, nation, [col("s_nationkey")],
                                  [col("n_nationkey")], "inner")
    agg = m.agg.AggregateExec([col("s_name")],
                              [(m.aggexprs.Count(), "numwait")], with_n)
    return m.sort.TopNExec(Q21_LIMIT, [(col("numwait"), False),
                                       (col("s_name"), True)], agg)


def l2_exprs(m):
    col = m.core.col
    return [col("l_orderkey").alias("l2_orderkey"),
            col("l_suppkey").alias("l2_suppkey")]


def l3_exprs(m):
    col = m.core.col
    return [col("l_orderkey").alias("l3_orderkey"),
            col("l_suppkey").alias("l3_suppkey"),
            col("l_commitdate").alias("l3_commitdate"),
            col("l_receiptdate").alias("l3_receiptdate")]


def q21_plan(m, batches, nation=Q21_NATION):
    """Q21 over in-memory scans of tpch_join_data's batches (a dict by
    table, of the package `m` holds)."""
    def scan(k):
        return m.basic.InMemoryScanExec([batches[k]], batches[k].schema)
    return q21_tree(m, scan("lineitem"),
                    m.basic.ProjectExec(l2_exprs(m), scan("lineitem")),
                    m.basic.ProjectExec(l3_exprs(m), scan("lineitem")),
                    scan("supplier"), scan("orders"), scan("nation"),
                    nation)


def q21_join(plan, depth):
    """The exec `depth` steps down q21_tree's left spine: 5 is the anti
    join, 6 the semi join."""
    for _ in range(depth):
        plan = plan.children[0]
    return plan


def q4_plan(m, batches, anti=False, n_parts=None):
    def scan(k):
        return m.basic.InMemoryScanExec([batches[k]], batches[k].schema)
    return q4_tree(m, scan("orders"), scan("lineitem"), anti, n_parts)


def q21_oracle(d, nation=Q21_NATION):
    """Q21 in numpy: (s_name, numwait), numwait descending then s_name,
    the first 100."""
    lok, supp = d["l_orderkey"], d["l_suppkey"]
    late = d["l_receiptdate"] > d["l_commitdate"]
    oi = order_index(lok)
    n_orders = d["o_orderkey"].shape[0]
    pair = oi * (supp.max() + 1) + supp

    def per_order(mask):
        return np.bincount(oi[mask], minlength=n_orders)

    def per_pair(mask):
        u, inv = np.unique(pair[mask], return_inverse=True)
        counts = np.bincount(inv, minlength=u.shape[0])
        pos = np.clip(np.searchsorted(u, pair), 0, max(u.shape[0] - 1, 0))
        return np.where(u[pos] == pair, counts[pos], 0) if u.shape[0] \
            else np.zeros_like(pair)
    everything = np.ones_like(late)
    other_lines = per_order(everything)[oi] - per_pair(everything)
    other_late = per_order(late)[oi] - per_pair(late)
    status = d["o_orderstatus"][0][oi]
    keep = late & (other_lines > 0) & (other_late == 0) \
        & (status == ORDER_STATUSES.index("F")) \
        & (d["s_nationkey"][supp - 1] == NATIONS.index(nation))
    counts = np.bincount(supp[keep] - 1, minlength=d["s_suppkey"].shape[0])
    names = d["s_name"][1]
    rows = [(names[k], int(counts[k])) for k in np.nonzero(counts)[0]]
    rows.sort(key=lambda r: (-r[1], r[0]))
    return rows[:Q21_LIMIT]


def q4_df(m, sess, batches, anti=False, sort=True, frames=None):
    """Q4 as a DataFrame query (how="left_semi", or "left_anti"); a table
    in `frames` ({name: DataFrame}) replaces its batch."""
    col, pr, F = m.core.col, m.pred, m.F

    def df(k):
        if frames and k in frames:
            return frames[k]
        return sess.from_batches([batches[k]], batches[k].schema)
    orders = df("orders").filter(pr.And(
        pr.GreaterThanOrEqual(col("o_orderdate"), date_lit(m, Q4_DATE)),
        pr.LessThan(col("o_orderdate"), date_lit(m, Q4_END))))
    lines = df("lineitem").filter(
        pr.LessThan(col("l_commitdate"), col("l_receiptdate")))
    q = orders.join(lines, left_on="o_orderkey", right_on="l_orderkey",
                    how="left_anti" if anti else "left_semi") \
        .group_by("o_orderpriority").agg((F.count(), "order_count"))
    return q.sort("o_orderpriority") if sort else q


def q21_df(m, sess, batches, nation=Q21_NATION):
    """Q21 as a DataFrame query: the semi and anti joins with their
    conditions (how="left_semi", "left_anti"), then the inner joins."""
    col, lit, pr, F = m.core.col, m.core.lit, m.pred, m.F

    def df(k):
        return sess.from_batches([batches[k]], batches[k].schema)
    lines = df("lineitem")
    l1 = lines.filter(pr.GreaterThan(col("l_receiptdate"),
                                     col("l_commitdate")))
    l2 = lines.select(*l2_exprs(m))
    l3 = lines.select(*l3_exprs(m)).filter(
        pr.GreaterThan(col("l3_receiptdate"), col("l3_commitdate")))
    return (l1.join(l2, left_on="l_orderkey", right_on="l2_orderkey",
                    how="left_semi", condition=ne(m, "l2_suppkey",
                                                  "l_suppkey"))
            .join(l3, left_on="l_orderkey", right_on="l3_orderkey",
                  how="left_anti", condition=ne(m, "l3_suppkey",
                                                "l_suppkey"))
            .join(df("supplier"), left_on="l_suppkey", right_on="s_suppkey")
            .join(df("orders").filter(pr.EqualTo(col("o_orderstatus"),
                                                 lit("F"))),
                  left_on="l_orderkey", right_on="o_orderkey")
            .join(df("nation").filter(pr.EqualTo(col("n_name"),
                                                 lit(nation))),
                  left_on="s_nationkey", right_on="n_nationkey")
            .group_by("s_name").agg((F.count(), "numwait"))
            .sort((col("numwait"), False), "s_name").limit(Q21_LIMIT))


def p14_tree(m, orders_scan, lines_scan, jt, build):
    """P14: q3's filtered sides (lineitems l_flag != 0 on the left, orders
    o_flag < 5 on the right) joined on the order key under `jt`, built
    on `build`."""
    col, lit, b = m.core.col, m.core.lit, m.basic
    lines = b.FilterExec(col("l_flag") != lit(0), lines_scan)
    orders = b.FilterExec(col("o_flag") < lit(5), orders_scan)
    return m.joins.HashJoinExec(lines, orders, [col("l_orderkey")],
                                [col("o_orderkey")], jt, build_side=build)


def p14_plans(m, d3, dev):
    """P14's plans over q3's LONG-key batches, made once: a function of
    (join type, build side)."""
    o_schema, l_schema = q3_schemas("LONG")
    o_b = q3_batches(d3, dev, o_schema, Q3_ORDERS)
    l_b = q3_batches(d3, dev, l_schema, Q3_LINES)
    return lambda jt, build: p14_tree(
        m, m.basic.InMemoryScanExec(o_b, o_schema),
        m.basic.InMemoryScanExec(l_b, l_schema), jt, build)


def p14_oracle(d, jt):
    """P14 in numpy: (rows, sorted left keys, sorted right keys, left
    nulls, right nulls) — the keys of the non-null rows; existence's
    right "keys" are its flags."""
    lk = d["l_orderkey"][d["l_flag"] != 0]
    ok = d["o_orderkey"][d["o_flag"] < 5]
    hit = np.isin(lk, ok)
    o_hit = np.isin(ok, lk)
    if jt == "left_semi":
        return len(lk[hit]), np.sort(lk[hit]), None, 0, 0
    if jt == "left_anti":
        return len(lk[~hit]), np.sort(lk[~hit]), None, 0, 0
    if jt == "existence":
        return len(lk), np.sort(lk), np.sort(hit), 0, 0
    left = [lk[hit]]
    right = [lk[hit]]
    l_null = r_null = 0
    if jt in ("left_outer", "full_outer"):
        left.append(lk[~hit])
        r_null = int((~hit).sum())
    if jt in ("right_outer", "full_outer"):
        right.append(ok[~o_hit])
        l_null = int((~o_hit).sum())
    rows = int(hit.sum()) + r_null + l_null
    return (rows, np.sort(np.concatenate(left)),
            np.sort(np.concatenate(right)), l_null, r_null)


def p14_check(batches, d, jt, label):
    """P14's output against p14_oracle: the row count, both sides' key
    multisets and null counts, read from the device tensors."""
    n = [b.num_rows_host for b in batches]
    rows = sum(n)
    want = p14_oracle(d, jt)
    ncols = len(batches[0].columns) if batches else 0

    def side(i):
        if not batches:
            return np.zeros(0, np.int64), 0
        data = np.concatenate([b.columns[i].data[:k].cpu().numpy()
                               for b, k in zip(batches, n)])
        valid = np.concatenate([b.columns[i].validity[:k].cpu().numpy()
                                for b, k in zip(batches, n)])
        return np.sort(data[valid]), int((~valid).sum())
    lkeys, l_null = side(0)
    right = side(4) if jt not in ("left_semi", "left_anti") \
        and ncols > 4 else (None, 0)
    rkeys, r_null = right
    got = (rows, lkeys, rkeys, l_null, r_null)
    ok = rows == want[0] and np.array_equal(lkeys, want[1]) \
        and (want[2] is None or np.array_equal(rkeys, want[2])) \
        and l_null == want[3] and r_null == want[4]
    if not ok:
        raise AssertionError(f"{label}: rows {rows}, nulls ({l_null}, "
                             f"{r_null}) != oracle rows {want[0]}, nulls "
                             f"({want[3]}, {want[4]}), or the keys differ")
    return got


def p15_df(m, sess, lines, bands):
    """P15: the lineitems (l_discount, l_orderkey) left-outer-joined to
    the discount bands with no equi-key, on l_discount >= lo AND
    l_discount < hi (Spark's BroadcastNestedLoopJoin), then count(*) by
    band."""
    col, pr, F = m.core.col, m.pred, m.F
    cond = pr.And(pr.GreaterThanOrEqual(col("l_discount"), col("lo")),
                  pr.LessThan(col("l_discount"), col("hi")))
    return (sess.from_batches([lines], lines.schema)
            .join(sess.from_batches([bands], bands.schema),
                  how="left_outer", condition=cond)
            .group_by("band").agg((F.count(), "lines")))


def p15_batches(d, dev):
    """P15's inputs: the first P15_LINES lineitems' discount and order
    key, and the P15_BANDS bands."""
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column
    n = min(P15_LINES, d["l_discount"].shape[0])
    ls = t.Schema((t.StructField("l_discount", t.DOUBLE),
                   t.StructField("l_orderkey", t.LONG)))
    lines = ColumnarBatch([Column.from_numpy(d["l_discount"][:n], t.DOUBLE,
                                             device=dev),
                           Column.from_numpy(d["l_orderkey"][:n], t.LONG,
                                             device=dev)], n, ls)
    k = np.arange(P15_BANDS)
    bs = t.Schema((t.StructField("band", t.INT), t.StructField("lo", t.DOUBLE),
                   t.StructField("hi", t.DOUBLE)))
    bands = ColumnarBatch([Column.from_numpy(k.astype(np.int32), t.INT,
                                             device=dev),
                           Column.from_numpy(k / 100.0, t.DOUBLE, device=dev),
                           Column.from_numpy((k + 1) / 100.0, t.DOUBLE,
                                             device=dev)], P15_BANDS, bs)
    return lines, bands


def p15_oracle(d):
    n = min(P15_LINES, d["l_discount"].shape[0])
    disc = d["l_discount"][:n]
    band = np.floor(disc * 100 + 0.5).astype(np.int64)
    lo, hi = np.arange(P15_BANDS) / 100.0, (np.arange(P15_BANDS) + 1) / 100.0
    ok = (disc >= lo[band]) & (disc < hi[band])   # each line in its band
    if not ok.all():
        raise AssertionError("P15: a discount outside its band")
    counts = np.bincount(band, minlength=P15_BANDS)
    return sorted((int(k), int(c)) for k, c in enumerate(counts) if c)


def basic_dfs(m, sess, batches, q1t_batch):
    """The basic operators planned from DataFrames: a range summed, the
    union of the orders' two halves counted by priority, a limit with an
    offset, and TPC-H Q1's aggregate over the grouping sets
    ((l_returnflag, l_linestatus), ()) through an Expand."""
    col, lit, F, L = m.core.col, m.core.lit, m.F, m.L
    halves = [sess.from_batches([b], b.schema)
              for b in batches["orders_halves"]]
    t = m.t
    sets = [[col("l_returnflag"), col("l_linestatus"), col("l_quantity"),
             lit(0).alias("gid")],
            [m.core.Literal(None, t.STRING).alias("l_returnflag"),
             m.core.Literal(None, t.STRING).alias("l_linestatus"),
             col("l_quantity"), lit(3).alias("gid")]]
    lines = sess.from_batches([q1t_batch], q1t_batch.schema)
    expand = m.session.DataFrame(
        L.LogicalExpand(sets, lines.logical_plan()), sess)
    return {
        "range": sess.range(0, 1 << 24).agg((F.sum("id"), "total")),
        "union": halves[0].union(halves[1]).group_by("o_orderpriority")
        .agg((F.count(), "orders")),
        "limit": halves[0].select(col("o_orderkey"), col("o_orderdate"))
        .limit(100, offset=1000),
        "expand": expand.group_by("l_returnflag", "l_linestatus", "gid")
        .agg((F.sum("l_quantity"), "sum_qty"), (F.count(), "n"))}


def basic_oracles(d, d19):
    n_orders = d["o_orderkey"].shape[0]
    counts = np.bincount(d["o_orderpriority"][0], minlength=5)
    rf = np.asarray(d19["l_returnflag"][1])[d19["l_returnflag"][0]]
    ls = np.asarray(d19["l_linestatus"][1])[d19["l_linestatus"][0]]
    qty = d19["l_quantity"]
    expand = [(None, None, 3, float(qty.sum()), int(qty.shape[0]))]
    for f, s in sorted(set(zip(rf, ls))):
        g = (rf == f) & (ls == s)
        expand.append((str(f), str(s), 0, float(qty[g].sum()),
                       int(g.sum())))
    half = n_orders // 2
    return {
        "range": [((1 << 24) * ((1 << 24) - 1) // 2,)],
        "union": sorted((ORDER_PRIORITIES[k], int(counts[k]))
                        for k in range(5)),
        "limit": [(int(d["o_orderkey"][i]), int(d["o_orderdate"][i]))
                  for i in range(1000, 1100)],
        "expand": sorted(expand, key=repr), "half": half}


def check_basic(label, rows, want):
    """A basic operator's rows against its oracle: exact, the expand's
    sums to rtol 1e-9 (summation order)."""
    if label in ("union", "expand"):
        rows = sorted(rows, key=repr)
    ok = len(rows) == len(want)
    for got, w in zip(rows, want):
        for g, x in zip(got, w):
            if isinstance(x, float):
                ok = ok and g is not None and abs(g - x) <= RTOL * abs(x)
            else:
                ok = ok and g == x
    if not ok:
        raise AssertionError(f"{label}: {rows[:5]}... != oracle "
                             f"{want[:5]}...")


def join_session_modules():
    """session_modules() with the port's types and logical plans."""
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.plan import logical
    m = session_modules()
    m.t, m.L = t, logical
    return m


def exact_rows(want):
    def check(rows, label, _metrics=None):
        if rows != want:
            raise AssertionError(f"{label}: {rows[:8]} != oracle {want[:8]}")
    return check


def sorted_rows(want):
    def check(rows, label, _metrics=None):
        if sorted(rows, key=repr) != sorted(want, key=repr):
            raise AssertionError(f"{label}: {sorted(rows)[:8]} != oracle "
                                 f"{sorted(want)[:8]}")
    return check


Q_NEED = ["murmur3_columns", "fused_probe_verify", "dma_row_gather"]


def drive_join_paths(dev, d, batches, d3, d19, q1t_batch):
    """Phase 3d: P12 (Q4), P13 (Q21), P14 (q3's join under each join
    type), P15 (the nested-loop band join), P16 (Q4's semi and anti joins
    over the host shuffle) and the basic operators, each held to its
    numpy oracle with its launches counted. Returns (counts by path,
    records, the runs phase 4 times)."""
    pm, sm = port_modules(), join_session_modules()
    TpuSession = sm.session.TpuSession
    counts, recs, runs = {}, {}, {}
    q4_want, q4_anti_want = q4_oracle(d), q4_oracle(d, anti=True)
    q21_want = q21_oracle(d)
    print(f"P12-P16 data (TPC-H clause 4.2.3, SF{TPCH_SF:g}): "
          f"{d['o_orderkey'].shape[0]} orders, {d['l_orderkey'].shape[0]} "
          f"lineitems, {d['s_suppkey'].shape[0]} suppliers, 25 nations")

    # P12: Q4, hand-built then planned at the default confs
    q4 = q4_plan(pm, batches)
    rows, counts["P12"] = drive_counted("P12 Q4", q4, Q_NEED)
    exact_rows(q4_want)(rows, "P12 Q4")
    print(f"P12 TPC-H Q4 (left_semi): {rows} equal to the numpy oracle; "
          f"launches {counts['P12']}")
    recs["P12_planned"] = drive_planned(
        "P12 Q4 planned", sm, q4_df(sm, TpuSession(device=dev), batches),
        Q_NEED, counts["P12"], exact_rows(q4_want))
    runs["P12"] = (lambda: q4.collect(), exact_rows(q4_want))

    # P13: Q21, hand-built then planned with broadcasts off
    q21 = q21_plan(pm, batches)
    rows, counts["P13"] = drive_counted("P13 Q21", q21,
                                        ["dict_gather"] + Q_NEED)
    exact_rows(q21_want)(rows, "P13 Q21")
    semi = q21_join(q21, 6)
    print(f"P13 TPC-H Q21 (left_semi, left_anti, 3 inner joins, TopN by a "
          f"string): {len(rows)} rows equal to the numpy oracle, first "
          f"{rows[:3]}; launches {counts['P13']}; semi join output "
          f"{semi.metrics['numOutputRows'].value} rows")
    recs["P13_planned"] = drive_planned(
        "P13 Q21 planned", sm,
        q21_df(sm, TpuSession(Q21_CONF, dev), batches),
        ["dict_gather"] + Q_NEED, counts["P13"], exact_rows(q21_want))
    runs["P13"] = (lambda: q21.collect(), exact_rows(q21_want))

    # P14: q3's filtered sides under each join type
    p14 = p14_plans(pm, d3, dev)
    recs["P14"] = {}
    for jt, build in P14_KINDS:
        label = f"P14 {jt} build {build}"

        def tree(jt=jt, build=build):
            return p14(jt, build)
        need = Q_NEED if jt != "existence" else Q_NEED[:2]
        out, c, _ = drive_batches(label, tree(), need)
        rows_, _, _, ln, rn = p14_check(out, d3, jt, label)
        counts[f"P14_{jt}_{build}"] = c
        recs["P14"][f"{jt}_{build}"] = {"rows": rows_, "left_nulls": ln,
                                        "right_nulls": rn, "launches": c}
        runs[f"P14 {jt} {build}"] = (tree, None)
        print(f"{label}: {rows_} rows, nulls left {ln} right {rn}, keys "
              f"equal to the numpy oracle; launches {c}")

    # P15: the nested-loop band join, planned
    lines15, bands15 = p15_batches(d, dev)
    p15_want = p15_oracle(d)
    p15 = p15_df(sm, TpuSession(P15_CONF, dev), lines15, bands15)
    recs["P15"] = drive_planned("P15 band join planned", sm, p15,
                                ["dma_row_gather"], None,
                                sorted_rows(p15_want))
    counts["P15"] = recs["P15"]["launches"]
    if "NestedLoopJoinExec" not in recs["P15"]["shape"]:
        raise AssertionError(f"P15: planned {recs['P15']['shape']}")
    runs["P15"] = (p15.collect, sorted_rows(p15_want))

    # P16: Q4's semi and anti joins over the host shuffle, planned, at the
    # default tier: at the default confs (the join converts to one
    # single-build pass) and as the static twin (each partition pair sizes
    # its own buckets; pairs without rows skipped), the twin untimed
    for (anti, want), static in itertools.product(
            ((False, q4_want), (True, q4_anti_want)), (False, True)):
        key = ("P16_anti" if anti else "P16_semi") \
            + ("_static" if static else "")
        conf = dict(P16_CONF, **STATIC_CONF) if static else P16_CONF
        p16 = q4_df(sm, TpuSession(conf, dev), batches, anti, sort=False)
        recs[key] = drive_planned(f"{key} Q4 shuffled planned", sm, p16,
                                  Q_NEED, None, sorted_rows(want))
        counts[key] = recs[key]["launches"]
        if "ShuffledHashJoinExec" not in recs[key]["shape"]:
            raise AssertionError(f"{key}: planned {recs[key]['shape']}")
        if static and counts[key]["fused_probe_verify"] < 2:
            raise AssertionError(f"{key}: {counts[key]['fused_probe_verify']}"
                                 f" probes, one pass")
        if not static:
            runs[key] = (p16.collect, sorted_rows(want))

    # Range, Union, Limit and Expand, planned
    half = d["o_orderkey"].shape[0] // 2
    n_orders = d["o_orderkey"].shape[0]
    batches = dict(batches, orders_halves=[
        join_batch(d, "orders", dev, slice(0, half)),
        join_batch(d, "orders", dev, slice(half, n_orders))])
    dfs = basic_dfs(sm, TpuSession(device=dev), batches, q1t_batch)
    wants = basic_oracles(d, d19)
    recs["basic"] = {}
    for label, df in dfs.items():
        rec = drive_planned(
            f"{label} planned", sm, df, [], None,
            lambda r, lb, _m, label=label: check_basic(label, r,
                                                       wants[label]))
        recs["basic"][label] = rec
        counts[f"basic_{label}"] = rec["launches"]
    return counts, recs, runs


def time_join_paths(runs):
    """Phase 4: each path of phase 3d, P_JOIN_ITERS runs, one
    synchronisation a run: P12's and P13's hand-built plans collect()ed,
    P14's joins executed on the card, P15 and P16 through the session
    (df.collect(), the plan included)."""
    import torch
    out = {}
    for label, (run, check) in runs.items():
        ms = []
        for _ in range(P_JOIN_ITERS):
            t0 = time.perf_counter()
            if check is None:
                list(run().execute())
                torch.cuda.synchronize()
            else:
                rows = run()
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if check is not None:
                check(rows, f"{label} timed")
        out[label] = ms
        print(f"{label} ms per run ({P_JOIN_ITERS}): "
              f"{[round(x, 3) for x in ms]}")
    check_idle("phase 3d timed")
    return out


#: P14's joins whose kernels phase 2 holds to their plain versions: the
#: unmatched stream tail, the unmatched build rows, and both
P14_COMPARED = (("left_outer", "right"), ("left_outer", "left"),
                ("full_outer", "right"))
#: the join's row gather sites (GATHER_SITES) that phase 2 must reach
JOIN_GATHER_SITES = ("build permute", "semi/anti compaction",
                     "unmatched build rows", "nested-loop chunk",
                     "stream payload", "build payload")


def compare_join_paths(dev, d, batches, d3, sites):
    """Phase 2 for phase 3d's other paths, each kernel against its plain
    version, exactly, at the path's own inputs: P12's semi join (hash,
    probe, every row gather), P14's outer joins in P14_COMPARED, every
    row gather of P15's planned nested-loop join, and P16's planned semi
    join (every row gather, the join's kernels at its single build) and
    its static twin's (at its first partition pair). Fails unless every label of JOIN_GATHER_SITES was met here or
    in `sites` (the sites P13's capture met)."""
    from spark_rapids_tpu_torch.config import RapidsConf, set_active_conf
    pm, sm = port_modules(), join_session_modules()
    sites = set(sites)

    def compare(label, calls, inputs=None):
        sites.update(site for site, *_ in calls)
        if inputs is not None:
            compare_join_inputs(label, inputs, calls)
        else:
            print(f"compare {label} main-path row gathers: "
                  f"{'; '.join(compare_row_gathers(label, calls))}; exact")

    compare("P12 Q4 semi join", capture_row_gathers(q4_plan(pm, batches)),
            JoinInputs(find_exec(q4_plan(pm, batches), "HashJoinExec")))
    p14 = p14_plans(pm, d3, dev)
    for jt, build in P14_COMPARED:
        compare(f"P14 {jt} build {build}",
                capture_row_gathers(p14(jt, build)),
                JoinInputs(p14(jt, build)))
    sess15 = sm.session.TpuSession(P15_CONF, dev)
    compare("P15 band join planned", capture_row_gathers(planned(
        sm, p15_df(sm, sess15, *p15_batches(d, dev)))[0]))

    def p16(settings):
        sess = sm.session.TpuSession(settings, dev)
        return planned(sm, q4_df(sm, sess, batches, sort=False))[0]
    compare("P16 Q4 shuffled semi join planned (its single build)",
            capture_row_gathers(p16(P16_CONF)),
            single_build_inputs(find_exec(p16(P16_CONF),
                                          "ShuffledHashJoinExec")))
    static = dict(P16_CONF, **STATIC_CONF)
    compare("P16 static Q4 shuffled semi join planned (its first partition "
            "pair)", capture_row_gathers(p16(static)),
            shuffled_join_inputs(find_exec(p16(static),
                                           "ShuffledHashJoinExec")))
    set_active_conf(RapidsConf())     # the sessions' confs are not kept
    missing = [label for label in JOIN_GATHER_SITES if label not in sites]
    if missing:
        raise AssertionError(f"phase 2: no join row gather compared at "
                             f"{missing}")


def find_exec(tree, name):
    """The first exec of class `name` in `tree`, depth first."""
    return next(n for n in exec_nodes(tree) if type(n).__name__ == name)


def q21_kernel_shapes(batches, launches):
    """fused_probe_verify and dma_row_gather at Q21's shapes: the probe
    at the semi and the anti join's inputs (time_probe_shape), every row
    gather of a run of the plan (time_gather_call)."""
    pm = port_modules()
    probes = {}
    for key, depth in (("semi", 6), ("anti", 5)):
        j = q21_join(q21_plan(pm, batches), depth)
        probes[key] = dict(time_probe_shape(f"Q21 {key}", JoinInputs(j)),
                           launches=launches)
    gathers = [time_gather_call("P13", *call, generic=False)
               for call in capture_row_gathers(q21_plan(pm, batches))]
    return probes, gathers


# -- slice 10: decimals, dates and the rest of A.8 wave 1 (phase 3e) --------

#: TPC-H's substitution values: Q1 (clause 2.4.1.3), Q6 (2.4.6.3), Q3
#: (2.4.3.3); every money column is DECIMAL(12, 2), as the spec defines it
Q1_DATE, Q1_DELTA = datetime.date(1998, 12, 1), 90
Q6_DATE, Q6_DISCOUNT, Q6_QUANTITY = datetime.date(1994, 1, 1), 6, 24
Q3_SEGMENT, Q3_DATE = "BUILDING", datetime.date(1995, 3, 15)
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
MONEY = (12, 2)
P20_FRACTION, P20_SEED = 0.1, 7
P20_ZONE = "+05:30"
P20_ZONE_US = (5 * 3600 + 30 * 60) * 1_000_000
#: P19 plans with broadcasts off (phase 3i plans it at the default confs,
#: its upper join through AdaptiveJoinExec); P20's sort plans over P_PARTS
#: host partitions
P19_CONF = Q21_CONF
P20_SORT_CONF = dict(Q3_CONF, **{"spark.rapids.sql.shuffle.partitions":
                                 str(P_PARTS)})
P_TYPES_ITERS = 3        # phase 4's timed runs of P17-P20 each
TYPES_NEED = {"P17": ["dma_row_gather"], "P18": ["dma_row_gather"],
              "P19": ["murmur3_columns", "fused_probe_verify",
                      "dma_row_gather", "dict_gather"],
              "P20 sample": ["dma_row_gather"],
              "P20 sort": ["dma_row_gather"], "P20 year": []}


def money(x):
    """Unscaled DECIMAL(12, 2) lanes (int64 cents) of a float column whose
    values are whole cents."""
    return np.rint(np.asarray(x) * 100).astype(np.int64)


def decimal_lines(d):
    """P17's and P18's lineitems on true types, from q19_data's draws (P6's
    6,001,215 lines at SF1): the money columns as unscaled DECIMAL(12, 2)
    (l_extendedprice from the integer quantity and clause 4.2.3's retail
    price in cents), l_shipdate a DATE, the flags as dictionaries."""
    pk = d["l_partkey"]
    retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    qty = d["l_quantity"].astype(np.int64)
    return {"l_quantity": qty * 100, "l_extendedprice": qty * retail,
            "l_discount": money(d["l_discount"]), "l_tax": money(d["l_tax"]),
            "l_shipdate": d["l_shipdate"],
            "l_returnflag": d["l_returnflag"],
            "l_linestatus": d["l_linestatus"]}


def types_batch(m, cols, dev):
    """A port batch of {name: numpy lane or (codes, values)}: an int64
    lane whose name is a money column is DECIMAL(12, 2), an int32 lane
    named *date a DATE, (codes, values) a DictionaryColumn."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column, string_buffers
    from spark_rapids_tpu_torch.columnar.encoded import dictionary_from_numpy
    t = m.t
    fields, out, n = [], [], None
    for name, v in cols.items():
        if isinstance(v, tuple):
            out.append(dictionary_from_numpy(v[0], *string_buffers(v[1]),
                                             device=dev))
            dt, n = t.STRING, v[0].shape[0]
        else:
            dt = t.DecimalType(*MONEY) if name.split("_")[-1] in (
                "quantity", "extendedprice", "discount", "tax") \
                else t.DATE if name.endswith("date") \
                else t.INT if v.dtype == np.int32 else t.LONG
            out.append(Column.from_numpy(v, dt, device=dev))
            n = v.shape[0]
        fields.append(t.StructField(name, dt))
    return ColumnarBatch(out, n, t.Schema(tuple(fields)))


def dec_lit(m, unscaled):
    return m.core.Literal(int(unscaled), m.t.DecimalType(*MONEY))


def q1_types_df(m, sess, batch):
    """P17: TPC-H Q1 (clause 2.4.1, DELTA 90) on DECIMAL and DATE columns:
    l_shipdate <= date_sub(DATE '1998-12-01', 90), grouped and ordered by
    the two flags, with sum_qty, sum_base_price, sum_disc_price and
    count(*). The three avg columns are left out (the JAX package's
    decimal avg raises) and sum_charge too (a decimal128 multiply, tagged
    off in both packages)."""
    col, lit, F = m.core.col, m.core.lit, m.F
    price, disc = col("l_extendedprice"), col("l_discount")
    cutoff = F.date_sub(date_lit(m, Q1_DATE), lit(Q1_DELTA))
    return (sess.from_batches([batch], batch.schema)
            .filter(m.pred.LessThanOrEqual(col("l_shipdate"), cutoff))
            .group_by("l_returnflag", "l_linestatus")
            .agg((F.sum("l_quantity"), "sum_qty"),
                 (F.sum(price), "sum_base_price"),
                 (F.sum(price * (lit(1) - disc)), "sum_disc_price"),
                 (F.count(), "count_order"))
            .sort("l_returnflag", "l_linestatus"))


def q1_types_oracle(dl):
    """P17 exactly: unscaled Python ints (DECIMAL(22, 2), (22, 2),
    (36, 4)) per group in ORDER BY order."""
    keep = dl["l_shipdate"] <= days(Q1_DATE) - Q1_DELTA
    rf = np.asarray(dl["l_returnflag"][1])[dl["l_returnflag"][0]]
    ls = np.asarray(dl["l_linestatus"][1])[dl["l_linestatus"][0]]
    dp = dl["l_extendedprice"] * (100 - dl["l_discount"])
    rows = []
    for f, s in sorted(set(zip(rf[keep], ls[keep]))):
        g = keep & (rf == f) & (ls == s)
        rows.append((f, s, int(dl["l_quantity"][g].sum()),
                     int(dl["l_extendedprice"][g].sum()),
                     int(dp[g].sum()), int(g.sum())))
    return rows


def q6_types_df(m, sess, batch):
    """P18: TPC-H Q6 (clause 2.4.6: DATE 1994-01-01, DISCOUNT 0.06,
    QUANTITY 24), the year's end through add_months: a grand
    sum(l_extendedprice * l_discount), DECIMAL(25, 4) summed to
    DECIMAL(35, 4)."""
    col, pr, F = m.core.col, m.pred, m.F
    start = date_lit(m, Q6_DATE)
    cond = pr.And(pr.And(
        pr.GreaterThanOrEqual(col("l_shipdate"), start),
        pr.LessThan(col("l_shipdate"), F.add_months(start, 12))), pr.And(
        pr.And(pr.GreaterThanOrEqual(col("l_discount"),
                                     dec_lit(m, Q6_DISCOUNT - 1)),
               pr.LessThanOrEqual(col("l_discount"),
                                  dec_lit(m, Q6_DISCOUNT + 1))),
        pr.LessThan(col("l_quantity"), dec_lit(m, Q6_QUANTITY * 100))))
    return (sess.from_batches([batch], batch.schema).filter(cond)
            .agg((F.sum(col("l_extendedprice") * col("l_discount")),
                  "revenue")))


def q6_types_oracle(dl):
    sd, disc = dl["l_shipdate"], dl["l_discount"]
    end = datetime.date(Q6_DATE.year + 1, Q6_DATE.month, Q6_DATE.day)
    keep = (sd >= days(Q6_DATE)) & (sd < days(end)) \
        & (disc >= Q6_DISCOUNT - 1) & (disc <= Q6_DISCOUNT + 1) \
        & (dl["l_quantity"] < Q6_QUANTITY * 100)
    rev = (dl["l_extendedprice"] * disc)[keep]
    return [(int(rev.sum()) if keep.any() else None,)]


def q3_types_data(dj, seed=23):
    """P19's columns beside tpch_join_data's (drawn from their own seed so
    that P12-P16's data stay as they were): clause 4.2.3's customers
    (c_custkey 1..150,000 x SF, c_mktsegment of five values), o_custkey
    (never a multiple of 3, as the spec's rule leaves a third of the
    customers without orders), o_shippriority (0), and the lines'
    l_extendedprice (quantity x retail price in cents, over a random
    part, l_partkey) and l_discount as DECIMAL(12, 2)."""
    rng = np.random.default_rng(seed)
    n_orders, n_line = dj["o_orderkey"].shape[0], dj["l_orderkey"].shape[0]
    n_cust = max(n_orders // 10, 3)
    cust = rng.integers(1, n_cust + 1, n_orders)
    cust = np.where(cust % 3 == 0, np.maximum(cust - 1, 1), cust)
    pk = rng.integers(1, max(n_orders // 7.5, 1) + 1, n_line)
    retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    qty = rng.integers(1, 51, n_line)
    return {"c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
            "c_mktsegment": (rng.integers(0, 5, n_cust).astype(np.int32),
                             SEGMENTS),
            "o_custkey": cust.astype(np.int64),
            "o_shippriority": np.zeros(n_orders, np.int32),
            "l_extendedprice": (qty * retail).astype(np.int64),
            "l_discount": money(dj["l_discount"]),
            "l_partkey": pk.astype(np.int64)}


def q3_types_tables(dj, q3d):
    return {"customer": {k: q3d[k] for k in ("c_custkey", "c_mktsegment")},
            "orders": {"o_orderkey": dj["o_orderkey"],
                       "o_custkey": q3d["o_custkey"],
                       "o_orderdate": dj["o_orderdate"],
                       "o_shippriority": q3d["o_shippriority"]},
            "lineitem": {"l_orderkey": dj["l_orderkey"],
                         "l_extendedprice": q3d["l_extendedprice"],
                         "l_discount": q3d["l_discount"],
                         "l_shipdate": dj["l_shipdate"]}}


def q3_types_df(m, sess, b, frames=None):
    """P19: TPC-H Q3 (clause 2.4.3: SEGMENT BUILDING, DATE 1995-03-15):
    customer x orders x lineitem, revenue = sum(l_extendedprice *
    (1 - l_discount)) as decimal128 by (l_orderkey, o_orderdate,
    o_shippriority), its top 10 by revenue desc, o_orderdate. A table in
    `frames` ({name: DataFrame}) replaces its batch."""
    col, lit, pr, F = m.core.col, m.core.lit, m.pred, m.F

    def df(k):
        if frames and k in frames:
            return frames[k]
        return sess.from_batches([b[k]], b[k].schema)
    cust = df("customer").filter(pr.EqualTo(col("c_mktsegment"),
                                            lit(Q3_SEGMENT)))
    orders = df("orders").filter(pr.LessThan(col("o_orderdate"),
                                             date_lit(m, Q3_DATE)))
    lines = df("lineitem").filter(pr.GreaterThan(col("l_shipdate"),
                                                 date_lit(m, Q3_DATE)))
    return (cust.join(orders, left_on="c_custkey", right_on="o_custkey")
            .join(lines, left_on="o_orderkey", right_on="l_orderkey")
            .group_by("l_orderkey", "o_orderdate", "o_shippriority")
            .agg((F.sum(col("l_extendedprice")
                        * (lit(1) - col("l_discount"))), "revenue"))
            .sort((col("revenue"), False), "o_orderdate").limit(10))


def q3_types_oracle(dj, q3d):
    """P19 exactly: (l_orderkey, o_orderdate, o_shippriority, revenue as
    unscaled DECIMAL(36, 4)) of the top 10."""
    seg = q3d["c_mktsegment"]
    building = np.zeros(q3d["c_custkey"].shape[0] + 1, bool)
    building[q3d["c_custkey"]] = np.asarray(seg[1])[seg[0]] == Q3_SEGMENT
    cut = days(Q3_DATE)
    o_ok = building[q3d["o_custkey"]] & (dj["o_orderdate"] < cut)
    pos = np.searchsorted(dj["o_orderkey"], dj["l_orderkey"])
    l_ok = o_ok[pos] & (dj["l_shipdate"] > cut)
    rev = q3d["l_extendedprice"] * (100 - q3d["l_discount"])
    n_orders = dj["o_orderkey"].shape[0]
    total = np.zeros(n_orders, np.int64)
    np.add.at(total, pos[l_ok], rev[l_ok])
    idx = np.nonzero(np.bincount(pos[l_ok], minlength=n_orders) > 0)[0]
    order = np.lexsort((dj["o_orderdate"][idx], -total[idx]))[:10]
    return [(int(dj["o_orderkey"][i]), int(dj["o_orderdate"][i]),
             int(q3d["o_shippriority"][i]), int(total[i]))
            for i in idx[order]]


def p20_lines(dj, q3d):
    """P20's lineitems: P19's, with l_orderkey, l_extendedprice and
    l_shipdate."""
    return {"l_orderkey": dj["l_orderkey"],
            "l_extendedprice": q3d["l_extendedprice"],
            "l_shipdate": dj["l_shipdate"]}


def p20_dfs(m, sess, sort_sess, lines, orders):
    """P20, each planned from DataFrames: the lineitems' sample(0.1,
    seed=7) with cast(l_extendedprice as string), round and bround of it,
    two shifts of l_orderkey and from_utc_timestamp at a fixed offset;
    the orders sorted by (o_orderdate, o_orderkey) over P_PARTS host
    partitions (PartitionWiseSortExec); count(*) by year(o_orderdate)
    (Q9's o_year)."""
    col, lit, F = m.core.col, m.core.lit, m.F
    mt, bw = m.math, m.bitwise
    price, key = col("l_extendedprice"), col("l_orderkey")
    sample = (sess.from_batches([lines], lines.schema)
              .sample(P20_FRACTION, seed=P20_SEED)
              .select(key, col("l_shipdate"),
                      price.cast(m.t.STRING).alias("price_str"),
                      mt.Round(price, 0).alias("price_round"),
                      mt.BRound(price, 1).alias("price_bround"),
                      F.shiftleft(key, lit(3)).alias("shl"),
                      F.shiftrightunsigned(-key, lit(60)).alias("ushr"),
                      F.from_utc_timestamp(col("l_shipdate").cast(
                          m.t.TIMESTAMP), P20_ZONE).alias("local")))
    sort = (sort_sess.from_batches([orders], orders.schema)
            .sort("o_orderdate", "o_orderkey"))
    year = (sess.from_batches([orders], orders.schema)
            .select(F.year("o_orderdate").alias("o_year"))
            .group_by("o_year").agg((F.count(), "n")).sort("o_year"))
    return {"P20 sample": sample, "P20 sort": sort, "P20 year": year}


def p20_oracles(lines_np, orders_np, keep):
    """P20's rows from numpy and Python: `keep` is the sample's mask, from
    the port's threefry on the CPU (tests/test_torch_sample_sort.py holds
    it to jax.random)."""
    import decimal
    k = lines_np["l_orderkey"][keep]
    p = lines_np["l_extendedprice"][keep]
    sd = lines_np["l_shipdate"][keep]

    def rnd(v, m, even):
        q, r = divmod(int(v), m)
        up = 2 * r > m or (2 * r == m and (q % 2 == 1 if even else True))
        return (q + up) * m

    def i64(v):
        return (v + 2**63) % 2**64 - 2**63

    ctx = decimal.Context(prec=40)
    sample = [(int(a), int(b), format(decimal.Decimal(int(c)).scaleb(
        -2, ctx), "f"), rnd(c, 100, False), rnd(c, 10, True),
        i64(int(a) << 3), (-int(a) % 2**64) >> 60,
        int(b) * 86_400_000_000 + P20_ZONE_US)
        for a, b, c in zip(k, sd, p)]
    okey, odate = orders_np["o_orderkey"], orders_np["o_orderdate"]
    order = np.lexsort((okey, odate))
    y = (np.datetime64("1970-01-01") + odate.astype("timedelta64[D]")) \
        .astype("datetime64[Y]").astype(np.int64) + 1970
    uy, cnt = np.unique(y, return_counts=True)
    return {"P20 sample": sample,
            "P20 sort": [(int(okey[i]), int(odate[i])) for i in order],
            "P20 year": [(int(a), int(b)) for a, b in zip(uy, cnt)]}


def sample_keep(n, capacity):
    """The rows SampleExec keeps of batch 0 (capacity rows, n active) for
    P20's fraction and seed, from the port's threefry on the CPU."""
    from spark_rapids_tpu_torch.ops import threefry
    k = threefry.fold_in(threefry.key(P20_SEED), 0)
    u = threefry.uniform(k, capacity).numpy()[:n]
    return u < np.float32(P20_FRACTION)


def types_modules():
    """join_session_modules() with the port's math and bitwise
    expressions."""
    from spark_rapids_tpu_torch.expr import bitwise, math
    m = join_session_modules()
    m.math, m.bitwise = math, bitwise
    return m


def types_inputs(dev, d19, dj, q3d):
    """P17-P20's batches on `dev` and their exact oracles."""
    m = types_modules()
    dl = decimal_lines(d19)
    l20np = p20_lines(dj, q3d)
    o20np = {"o_orderkey": dj["o_orderkey"], "o_orderdate": dj["o_orderdate"]}
    b = {"lines": types_batch(m, dl, dev),
         "q3": {k: types_batch(m, v, dev)
                for k, v in q3_types_tables(dj, q3d).items()},
         "l20": types_batch(m, l20np, dev), "o20": types_batch(m, o20np, dev)}
    wants = {"P17": q1_types_oracle(dl), "P18": q6_types_oracle(dl),
             "P19": q3_types_oracle(dj, q3d)}
    keep = sample_keep(b["l20"].num_rows_host, b["l20"].capacity)
    wants.update(p20_oracles(l20np, o20np, keep))
    return m, b, wants


def types_dfs(m, dev, b):
    TpuSession = m.session.TpuSession
    sess = TpuSession(device=dev)
    dfs = {"P17": q1_types_df(m, sess, b["lines"]),
           "P18": q6_types_df(m, sess, b["lines"]),
           "P19": q3_types_df(m, TpuSession(P19_CONF, dev), b["q3"])}
    dfs.update(p20_dfs(m, sess, TpuSession(P20_SORT_CONF, dev), b["l20"],
                       b["o20"]))
    return dfs


def drive_types_paths(dev, m, b, wants):
    """Phase 3e: P17-P20, each planned from DataFrames and held to its
    exact oracle (every decimal to the last digit) with its launches
    counted (drive_planned). Returns (counts, records, the runs phase 4
    times)."""
    dfs = types_dfs(m, dev, b)
    counts, recs, runs = {}, {}, {}
    for label, df in dfs.items():
        check = exact_rows(wants[label])
        recs[label] = drive_planned(f"{label} planned", m, df,
                                    TYPES_NEED[label], None, check)
        counts[label] = recs[label]["launches"]
        # phase 4 times collect() of the planned tree (its rows fetched
        # and turned into Python tuples); --profile traces its execute()
        runs[label] = (planned(m, df)[0].collect, check)
        print(f"{label}: {len(wants[label])} rows equal to the exact "
              f"oracle, first {wants[label][:2]}")
    if "PartitionWiseSortExec" not in recs["P20 sort"]["shape"]:
        raise AssertionError(f"P20 sort: planned {recs['P20 sort']['shape']}")
    if recs["P19"]["shape"].count("HashJoinExec") != 2:
        raise AssertionError(f"P19: planned {recs['P19']['shape']}")
    return counts, recs, runs


@contextlib.contextmanager
def default_conf_after():
    """Put the default conf back as the active one on exit, and no mesh:
    planning makes a session's conf and mesh active, and execs built later
    (P9's, phase 3b's) read theirs at construction."""
    from spark_rapids_tpu_torch.config import RapidsConf, set_active_conf
    from spark_rapids_tpu_torch.parallel.mesh import set_active_mesh
    try:
        yield
    finally:
        set_active_conf(RapidsConf())
        set_active_mesh(None)


def p19_joins(m, dev, b):
    """A fresh planned P19 tree and its two hash joins (the upper one
    first)."""
    tree = planned(m, types_dfs(m, dev, b)["P19"])[0]
    return tree, [n for n in exec_nodes(tree)
                  if type(n).__name__ == "HashJoinExec"]


def compare_types_paths(dev, m, b):
    """Phase 2 at P17-P20's own shapes: the murmur3 chain and the probe
    at both of P19's joins' inputs, every row gather of a run of each
    path (P19's group-by and TopN move the decimal limbs as two lanes)
    and every dictionary take of P19 (c_mktsegment = 'BUILDING' on the
    codes), each kernel against its plain version, exactly."""
    from spark_rapids_tpu_torch.ops import join as oj, murmur3_lanes as m3
    pair = [oj.JOIN_HASH_SEED, oj.JOIN_HASH_SEED2]
    for k in range(2):
        inp = JoinInputs(p19_joins(m, dev, b)[1][k])
        _exact(f"murmur3 P19 join {k} build pair",
               m3.murmur3_columns(inp.build_keys, pair),
               m3.murmur3_columns_plain(inp.build_keys, pair))
        _exact(f"murmur3 P19 join {k} stream keys",
               m3.murmur3_columns(inp.stream_keys, pair[:1]),
               m3.murmur3_columns_plain(inp.stream_keys, pair[:1]))
        hits = compare_probe(f"probe P19 join {k}", inp.probe, inp.cand_cap,
                             inp.total)
        print(f"compare P19 join {k}: murmur3 of {inp.build_rows} build "
              f"keys (two seeds) and {inp.stream_rows} stream keys, probe "
              f"of {inp.stream_rows} stream rows into {inp.build_rows} "
              f"build rows, candidate total {inp.total} in {inp.cand_cap} "
              f"slots, {hits} verified pairs; exact")
    gathers = capture_row_gathers(p19_joins(m, dev, b)[0])
    print(f"compare P19 main-path row gathers: "
          f"{'; '.join(compare_row_gathers('P19', gathers))}; exact")
    takes = capture_dict_gathers(p19_joins(m, dev, b)[0])
    print(f"compare P19 main-path dictionary gathers: "
          f"{'; '.join(compare_dict_takes('P19', takes))}; exact")
    # the other paths of phase 3e launch only row gathers: P17's filter
    # compaction and sort (the decimal128 sum buffers as hi/lo lanes),
    # P18's, the sample's compaction, the 16 partitions' sorts, the count
    # by year's
    for label in ("P17", "P18", "P20 sample", "P20 sort", "P20 year"):
        gathers = capture_row_gathers(
            planned(m, types_dfs(m, dev, b)[label])[0])
        print(f"compare {label} main-path row gathers: "
              f"{'; '.join(compare_row_gathers(label, gathers))}; exact")
        del gathers


def join_kernel_shapes(label, joins_of, counts):
    """Phase 4: each kernel at a planned join path's shapes, L2 cold: the
    murmur3 chain at every hash join's build pair and stream keys, the
    probe at each join (time_probe_shape), every row gather
    (time_gather_call) and every dictionary take of a run; each with its
    plain version, bound and launches in the path's counted run.
    `joins_of()` plans a fresh tree: (tree, its hash joins). Returns
    {kernel name: record}."""
    import torch
    from spark_rapids_tpu_torch.ops import dict_gather as dg
    from spark_rapids_tpu_torch.ops import join as oj, murmur3_lanes as m3
    reps, plain_reps = KERNEL_REPS, max(3, KERNEL_REPS // 4)
    pair = (oj.JOIN_HASH_SEED, oj.JOIN_HASH_SEED2)
    out = {"murmur3_columns": [], "fused_probe_verify": [],
           "dma_row_gather": [], "dict_gather": []}
    for k in range(len(joins_of()[1])):
        inp = JoinInputs(joins_of()[1][k])
        out["fused_probe_verify"].append(
            time_probe_shape(f"{label} join {k}", inp))
        for site, cols, seeds in (("build pair", inp.build_keys, pair),
                                  ("stream", inp.stream_keys, pair[:1])):
            n = cols[0].capacity
            widths = [c.data.element_size() for c in cols]
            ms = device_ms(lambda: m3.murmur3_columns(cols, seeds), reps)
            plain_ms = device_ms(
                lambda: m3.murmur3_columns_plain(cols, seeds), plain_reps)
            b_ms, b_by = bound(n * (sum(w + 1 for w in widths)
                                    + 4 * len(seeds)),
                               n * sum(m3_ops(w, len(seeds))
                                       for w in widths))
            print(f"murmur3_columns {label} join {k} {site} ({n} rows, "
                  f"{len(cols)} columns, {len(seeds)} seeds): {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                  f"{b_ms / ms:.1%} of the bound")
            out["murmur3_columns"].append({
                "site": f"join {k} {site}", "rows": n, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None, "max_abs_err": 0.0})
    out["dma_row_gather"] = [
        time_gather_call(label, *call, generic=False)
        for call in capture_row_gathers(joins_of()[0])]
    for t, i in capture_dict_gathers(joins_of()[0]):
        rows, lanes = i.shape
        flat = t.reshape(-1)
        safe = i.clamp(0, t.shape[0] - 1).reshape(-1).long()
        ms = device_ms(lambda: dg.dict_gather(t, i), reps)
        plain_ms = device_ms(lambda: dg.dict_gather_plain(t, i), plain_reps)
        lib_ms = device_ms(lambda: flat[safe], reps) if lanes == 1 \
            else device_ms(lambda: torch.gather(t, 0, i.long()), reps)
        b_ms, b_by = bound(rows * lanes * (4 + t.element_size())
                           + t.shape[0] * lanes * t.element_size(), 0)
        print(f"dict_gather {label} take ({rows}x{lanes} codes into "
              f"{t.shape[0]} entries of {t.element_size()} bytes): "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), library {lib_ms:.4f} ms")
        out["dict_gather"].append({
            "rows": rows, "lanes": lanes, "entries": t.shape[0], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "max_abs_err": 0.0})
    for name, recs in out.items():
        total = sum(r["ms"] for r in recs)
        print(f"{name} at {label}'s shapes: {counts.get(name, 0)} launches "
              f"in the counted run; {len(recs)} shapes timed, {total:.4f} "
              f"ms summed")
    return {name: {"launches": counts.get(name, 0), "shapes": recs}
            for name, recs in out.items()}


def p19_kernel_shapes(dev, m, b, counts):
    """Phase 4: each kernel at P19's shapes (join_kernel_shapes)."""
    return join_kernel_shapes("P19", lambda: p19_joins(m, dev, b), counts)


# -- slice 11: strings, regex and A.2's scalar aggregates (phase 3f) --------

#: TPC-H's substitution values: Q14 (clause 2.4.14.3), Q22 (clause
#: 2.4.22.3, I1-I7); clause 4.2.2.13's p_type syllables
Q14_DATE = datetime.date(1995, 9, 1)
Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")
TYPE_SYLLABLES = (("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY",
                   "PROMO"),
                  ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"),
                  ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
P_TYPES = tuple(f"{a} {b} {c}" for a in TYPE_SYLLABLES[0]
                for b in TYPE_SYLLABLES[1] for c in TYPE_SYLLABLES[2])
P24_NULL_SEED = 25       # l_shipdate's nulls in P24 (about a tenth)
P_STRING_ITERS = 3       # phase 4's timed runs of P21-P24 each
#: P21 and P22 plan at the default confs; the kernels each path launches
STRINGS_NEED = {"P21": Q_NEED, "P22": Q_NEED, "P22 avg": [],
                "P23": ["murmur3_columns"], "P24": ["dma_row_gather"],
                "P25": Q_NEED}


def digits_into(mat, col, values, width):
    """Write `values` as `width` decimal digits into mat[:, col:col+width]."""
    for i in range(width):
        mat[:, col + width - 1 - i] = ord("0") + (values // 10 ** i) % 10


def strings_data(dj, q3d, seed=24):
    """P21-P22's new columns, from their own seed (P12-P20's data stay as
    they were): the parts q3_types_data's lines draw (its l_partkey) with
    clause 4.2.2.13's p_type (three syllables drawn uniformly), and the
    customers' c_nationkey (uniform over 0-24), c_phone (clause 4.2.2.9:
    'CC-LLL-LLL-LLLL', CC = c_nationkey + 10) and c_acctbal (DECIMAL(12,
    2) cents, uniform over [-999.99, 9999.99])."""
    rng = np.random.default_rng(seed)
    n_part = int(max(dj["o_orderkey"].shape[0] // 7.5, 1))
    n_cust = q3d["c_custkey"].shape[0]
    syl = [rng.integers(0, len(s), n_part) for s in TYPE_SYLLABLES]
    nation = rng.integers(0, 25, n_cust)
    phone = np.full((n_cust, 15), ord("-"), np.uint8)
    digits_into(phone, 0, nation + 10, 2)
    for col, lo, hi in ((3, 100, 1000), (7, 100, 1000), (11, 1000, 10000)):
        digits_into(phone, col, rng.integers(lo, hi, n_cust), len(str(lo)))
    return {"p_partkey": np.arange(1, n_part + 1, dtype=np.int64),
            "p_type": (((syl[0] * 5 + syl[1]) * 5 + syl[2]).astype(np.int32),
                       P_TYPES),
            "c_nationkey": nation.astype(np.int32),
            "c_phone": phone,
            "c_acctbal": rng.integers(-99999, 1000000, n_cust)}


def fixed_strings(mat, dev):
    """A StringColumn of the rows of a (n, w) uint8 matrix."""
    from spark_rapids_tpu_torch.columnar.column import StringColumn
    n, w = mat.shape
    return StringColumn.from_numpy(np.ascontiguousarray(mat).reshape(-1),
                                   np.arange(n + 1, dtype=np.int32) * w,
                                   device=dev)


def batch_of(m, dev, cols):
    """A port batch of [(name, numpy lane or a built column, type)]."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column
    out = [v if not isinstance(v, np.ndarray) else
           Column.from_numpy(v, dt, device=dev) for _, v, dt in cols]
    n = cols[0][1].shape[0] if isinstance(cols[0][1], np.ndarray) \
        else out[0].capacity
    return ColumnarBatch(out, n, m.t.Schema(tuple(
        m.t.StructField(name, dt) for name, _, dt in cols)))


def strings_batches(m, dev, dj, q3d, sd, d19, names):
    """P21-P24's batches on `dev`. A string column here is a plain
    StringColumn, as a Parquet page without a dictionary gives it (the
    flags of P24 stay dictionaries, as P6's)."""
    from spark_rapids_tpu_torch.columnar.column import Column
    t = m.t
    dec = t.DecimalType(*MONEY)
    n_names = names.shape[0]
    ptype = string_column(*sd["p_type"], dev)
    lines24, n24 = q19_columns(d19, t.Schema(tuple(
        t.StructField(n, getattr(t, ty)) for n, ty in Q1_LINE_FIELDS)), dev)
    valid = np.random.default_rng(P24_NULL_SEED).random(n24) > 0.1
    names24 = [n for n, _ in Q1_LINE_FIELDS]
    k = names24.index("l_shipdate")
    lines24[k] = Column.from_numpy(d19["l_shipdate"], t.DATE, device=dev,
                                   validity=valid)
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    return {
        "lineitem": batch_of(m, dev, [
            ("l_partkey", q3d["l_partkey"], t.LONG),
            ("l_extendedprice", q3d["l_extendedprice"], dec),
            ("l_discount", q3d["l_discount"], dec),
            ("l_shipdate", dj["l_shipdate"], t.DATE)]),
        "part": batch_of(m, dev, [("p_partkey", sd["p_partkey"], t.LONG),
                                  ("p_type", ptype, t.STRING)]),
        "customer": batch_of(m, dev, [
            ("c_custkey", q3d["c_custkey"], t.LONG),
            ("c_nationkey", sd["c_nationkey"], t.INT),
            ("c_phone", fixed_strings(sd["c_phone"], dev), t.STRING),
            ("c_acctbal", sd["c_acctbal"], dec)]),
        "orders": batch_of(m, dev, [("o_custkey", q3d["o_custkey"],
                                     t.LONG)]),
        "names": batch_of(m, dev, [
            ("c_custkey", np.arange(1, n_names + 1, dtype=np.int64), t.LONG),
            ("c_name", fixed_strings(names, dev), t.STRING)]),
        "p24": ColumnarBatch(lines24, n24, t.Schema(tuple(
            t.StructField(n, getattr(t, ty)) for n, ty in Q1_LINE_FIELDS))),
        "p24_valid": valid}


def q14_df(m, sess, b):
    """P21: TPC-H Q14 (clause 2.4.14, DATE 1995-09-01) on DECIMAL(12, 2)
    money, its two sums: sum(case when p_type like 'PROMO%' then
    l_extendedprice * (1 - l_discount) else 0 end), written as (case when
    ... then l_extendedprice else 0 end) * (1 - l_discount), and the sum
    of the same product over every line. The query's 100.00 * a / b
    multiplies a decimal128 sum, tagged off in both packages (as P17's
    sum_charge), so q14_ratio forms the ratio from the two sums."""
    col, lit, F = m.core.col, m.core.lit, m.F
    start = date_lit(m, Q14_DATE)
    lines = sess.from_batches([b["lineitem"]], b["lineitem"].schema).filter(
        m.pred.And(m.pred.GreaterThanOrEqual(col("l_shipdate"), start),
                   m.pred.LessThan(col("l_shipdate"),
                                   F.add_months(start, 1))))
    part = sess.from_batches([b["part"]], b["part"].schema)
    joined = lines.join(part, left_on="l_partkey", right_on="p_partkey")
    price, disc = col("l_extendedprice"), lit(1) - col("l_discount")
    # the CASE picks the DECIMAL(12, 2) price, not the DECIMAL(26, 4)
    # product: a CASE over a decimal128 value raises in the JAX package
    # (ROADMAP C.5); the sum is the same
    promo = m.cond.CaseWhen([(F.like(col("p_type"), "PROMO%"), price)],
                            dec_lit(m, 0)) * disc
    return joined.agg((F.sum(promo), "promo_revenue"),
                      (F.sum(price * disc), "revenue"))


def q14_oracle(dj, q3d, sd):
    """P21 exactly: the two sums as unscaled DECIMAL(36, 4) ints."""
    sdate = dj["l_shipdate"]
    end = datetime.date(1995, 10, 1)
    keep = (sdate >= days(Q14_DATE)) & (sdate < days(end))
    rev = (q3d["l_extendedprice"] * (100 - q3d["l_discount"]))[keep]
    ptype = np.asarray(P_TYPES)[sd["p_type"][0]]
    promo = np.char.startswith(ptype, "PROMO")[q3d["l_partkey"][keep] - 1]
    return [(int(rev[promo].sum()), int(rev.sum()))]


def q14_ratio(row):
    """100.00 * promo / total, as Python decimals (28 digits)."""
    import decimal
    promo, total = (decimal.Decimal(v).scaleb(-4) for v in row)
    return decimal.Decimal(100) * promo / total


def _code_in(m, col):
    code = m.F.substring(col("c_phone"), 1, 2)
    return m.pred.In(code, list(Q22_CODES))


def q22_avg_df(m, sess, b):
    """P22's subquery as its own query: sum and count of c_acctbal over the
    customers with a positive balance in the seven country codes (a
    decimal avg raises in the JAX package, ROADMAP C.5)."""
    col = m.core.col
    return (sess.from_batches([b["customer"]], b["customer"].schema)
            .filter(m.pred.And(m.pred.GreaterThan(col("c_acctbal"),
                                                  dec_lit(m, 0)),
                               _code_in(m, col)))
            .agg((m.F.sum("c_acctbal"), "s"), (m.F.count(), "n")))


def q22_threshold(row):
    """(Spark's avg(DECIMAL(12, 2)) as DECIMAL(16, 6), HALF_UP, unscaled;
    the DECIMAL(12, 2) cents c_acctbal must exceed): c > avg holds for a
    two-decimal c exactly when c > floor(avg to two decimals)."""
    s, n = row
    q, r = divmod(s * 10 ** 4, n)
    avg6 = q + (1 if 2 * r >= n else 0)
    return avg6, avg6 // 10 ** 4


def q22_df(m, sess, b, cents):
    """P22: TPC-H Q22 (clause 2.4.22, I1-I7 = 13, 31, 23, 29, 30, 18, 17):
    the customers in the seven country codes (substring of the decoded
    c_phone) whose balance exceeds the average (`cents`, from
    q22_avg_df) and who placed no order (NOT EXISTS: a left anti join),
    counted and summed by the string cntrycode, ordered by it."""
    col, F = m.core.col, m.F
    cust = (sess.from_batches([b["customer"]], b["customer"].schema)
            .filter(m.pred.And(_code_in(m, col), m.pred.GreaterThan(
                col("c_acctbal"), dec_lit(m, cents)))))
    orders = sess.from_batches([b["orders"]], b["orders"].schema)
    return (cust.join(orders, left_on="c_custkey", right_on="o_custkey",
                      how="left_anti")
            .select(F.substring(col("c_phone"), 1, 2).alias("cntrycode"),
                    col("c_acctbal"))
            .group_by("cntrycode")
            .agg((F.count(), "numcust"), (F.sum("c_acctbal"), "totacctbal"))
            .sort("cntrycode"))


def q22_oracle(q3d, sd):
    """P22 exactly: (the subquery's (sum, count), the threshold's cents,
    the rows (cntrycode, numcust, totacctbal as unscaled cents))."""
    code = (sd["c_nationkey"] + 10).astype(np.int64)
    in_set = np.isin(code, [int(c) for c in Q22_CODES])
    bal = sd["c_acctbal"]
    pos = in_set & (bal > 0)
    sub = (int(bal[pos].sum()), int(pos.sum()))
    _, cents = q22_threshold(sub)
    has_order = np.zeros(q3d["c_custkey"].shape[0] + 1, bool)
    has_order[q3d["o_custkey"]] = True
    keep = in_set & (bal > cents) & ~has_order[q3d["c_custkey"]]
    rows = [(str(c), int(np.sum(keep & (code == c))),
             int(bal[keep & (code == c)].sum()))
            for c in sorted(set(code[keep].tolist()))]
    return sub, cents, rows


# P23: every new device expression once, as planned projections over the
# part's p_type, the customers' c_phone and P8's names; each entry is
# (output name, make(m, col, lit, F), oracle of one row's inputs)
def _initcap(s):
    return " ".join(w[:1].upper() + w[1:].lower() for w in s.split(" "))


def _lpad(s, n, p):
    return s[:n] if len(s) >= n else (p * n)[:n - len(s)] + s


SWEEP = {
    "part": (("p_type",), [
        ("length", lambda m, c, lit, F: F.length(c("p_type")), len),
        ("upper", lambda m, c, lit, F: F.upper(c("p_type")), str.upper),
        ("lower", lambda m, c, lit, F: F.lower(c("p_type")), str.lower),
        ("initcap", lambda m, c, lit, F: F.initcap(c("p_type")), _initcap),
        ("substring", lambda m, c, lit, F: F.substring(c("p_type"), 1, 5),
         lambda s: s[:5]),
        ("left", lambda m, c, lit, F: F.left(c("p_type"), 3),
         lambda s: s[:3]),
        ("right", lambda m, c, lit, F: F.right(c("p_type"), 4),
         lambda s: s[-4:]),
        ("startswith", lambda m, c, lit, F: F.startswith(c("p_type"),
                                                         "PROMO"),
         lambda s: s.startswith("PROMO")),
        ("endswith", lambda m, c, lit, F: F.endswith(c("p_type"), "TIN"),
         lambda s: s.endswith("TIN")),
        ("contains", lambda m, c, lit, F: F.contains(c("p_type"),
                                                     "BRUSHED"),
         lambda s: "BRUSHED" in s),
        ("trim", lambda m, c, lit, F: F.trim(c("p_type"), "SNTL"),
         lambda s: s.strip("SNTL")),
        ("ltrim", lambda m, c, lit, F: F.ltrim(c("p_type"), "SE"),
         lambda s: s.lstrip("SE")),
        ("rtrim", lambda m, c, lit, F: F.rtrim(c("p_type"), "RL"),
         lambda s: s.rstrip("RL")),
        ("rpad", lambda m, c, lit, F: F.rpad(c("p_type"), 30, "*"),
         lambda s: (s + "*" * 30)[:30]),
        ("lpad", lambda m, c, lit, F: F.lpad(c("p_type"), 12, "."),
         lambda s: _lpad(s, 12, ".")),
        ("repeat", lambda m, c, lit, F: F.repeat(c("p_type"), 2),
         lambda s: s * 2),
        ("reverse", lambda m, c, lit, F: F.reverse(c("p_type")),
         lambda s: s[::-1]),
        ("locate", lambda m, c, lit, F: F.locate("ED", c("p_type")),
         lambda s: s.find("ED") + 1),
        ("instr", lambda m, c, lit, F: F.instr(c("p_type"), "L"),
         lambda s: s.find("L") + 1),
        ("replace", lambda m, c, lit, F: F.replace(c("p_type"), " ", "_"),
         lambda s: s.replace(" ", "_")),
        ("translate", lambda m, c, lit, F: F.translate(c("p_type"),
                                                       "AEIOU", "aei"),
         lambda s: s.translate(str.maketrans("AEI", "aei", "OU"))),
        ("like", lambda m, c, lit, F: F.like(c("p_type"), "%BRASS"),
         lambda s: s.endswith("BRASS")),
        ("like_promo", lambda m, c, lit, F: F.like(c("p_type"), "PROMO%"),
         lambda s: s.startswith("PROMO")),
        ("rlike", lambda m, c, lit, F: F.rlike(c("p_type"),
                                               "^(STANDARD|SMALL) "),
         lambda s: re.search("^(STANDARD|SMALL) ", s) is not None),
        ("rlike_plated", lambda m, c, lit, F: F.rlike(c("p_type"),
                                                      "[A-Z]+ PLATED"),
         lambda s: re.search("[A-Z]+ PLATED", s) is not None),
        ("regexp_extract", lambda m, c, lit, F: F.regexp_extract(
            c("p_type"), "([A-Z]+)$", 1),
         lambda s: re.search("([A-Z]+)$", s).group(1)),
        ("regexp_replace", lambda m, c, lit, F: F.regexp_replace(
            c("p_type"), "[AEIOU]", ""),
         lambda s: re.sub("[AEIOU]", "", s)),
        ("substring_index", lambda m, c, lit, F: F.substring_index(
            c("p_type"), " ", 2), lambda s: " ".join(s.split(" ")[:2])),
        ("concat_ws", lambda m, c, lit, F: F.concat_ws("-", c("p_type"),
                                                       c("p_type")),
         lambda s: s + "-" + s),
        ("concat", lambda m, c, lit, F: F.concat(c("p_type"), lit("!"),
                                                 c("p_type")),
         lambda s: s + "!" + s),
        ("octet_length", lambda m, c, lit, F: F.octet_length(c("p_type")),
         len),
        ("bit_length", lambda m, c, lit, F: F.bit_length(c("p_type")),
         lambda s: 8 * len(s)),
        ("ascii", lambda m, c, lit, F: F.ascii(c("p_type")),
         lambda s: ord(s[0])),
    ]),
    "customer": (("c_phone", "c_nationkey"), [
        ("cntrycode", lambda m, c, lit, F: F.substring(c("c_phone"), 1, 2),
         lambda s, n: s[:2]),
        ("find_in_set", lambda m, c, lit, F: F.find_in_set(
            F.substring(c("c_phone"), 1, 2), lit(",".join(Q22_CODES))),
         lambda s, n: (Q22_CODES.index(s[:2]) + 1) if s[:2] in Q22_CODES
         else 0),
        ("regexp_extract", lambda m, c, lit, F: F.regexp_extract(
            c("c_phone"), "([0-9]{3})-([0-9]{4})", 2),
         lambda s, n: re.search("([0-9]{3})-([0-9]{4})", s).group(2)),
        ("regexp_replace", lambda m, c, lit, F: F.regexp_replace(
            c("c_phone"), "-", ""), lambda s, n: s.replace("-", "")),
        ("rlike", lambda m, c, lit, F: F.rlike(c("c_phone"), "^(13|31)-"),
         lambda s, n: s[:3] in ("13-", "31-")),
        ("like", lambda m, c, lit, F: F.like(c("c_phone"), "1_-%"),
         lambda s, n: s[0] == "1" and s[2] == "-"),
        ("base64", lambda m, c, lit, F: F.base64(c("c_phone")),
         lambda s, n: base64.b64encode(s.encode()).decode()),
        ("unbase64", lambda m, c, lit, F: F.unbase64(F.base64(
            c("c_phone"))), lambda s, n: s.encode()),
        ("hex", lambda m, c, lit, F: F.hex(c("c_phone")),
         lambda s, n: s.encode().hex().upper()),
        ("unhex", lambda m, c, lit, F: F.unhex(F.hex(c("c_phone"))),
         lambda s, n: s.encode()),
        ("encode", lambda m, c, lit, F: F.encode(c("c_phone"), "US-ASCII"),
         lambda s, n: s.encode("ascii")),
        ("decode", lambda m, c, lit, F: F.decode(F.encode(
            c("c_phone"), "ISO-8859-1"), "ISO-8859-1"), lambda s, n: s),
        ("chr", lambda m, c, lit, F: F.chr(c("c_nationkey") + lit(65)),
         lambda s, n: chr(n + 65)),
        ("locate", lambda m, c, lit, F: F.locate("-", c("c_phone"), 4),
         lambda s, n: s.find("-", 3) + 1),
    ]),
    "names": (("c_name",), [
        ("like", lambda m, c, lit, F: F.like(c("c_name"), "Customer#0000%"),
         None),
        ("rlike", lambda m, c, lit, F: F.rlike(c("c_name"), "[13579]$"),
         None),
        ("reverse", lambda m, c, lit, F: F.reverse(c("c_name")), None),
        ("substring_index", lambda m, c, lit, F: F.substring_index(
            c("c_name"), "#", -1), None),
    ]),
}
#: hash and xxhash64 over a string and a long of each table
SWEEP_HASHES = {"part": ("p_type", "p_partkey"),
                "customer": ("c_phone", "c_custkey"),
                "names": ("c_name", "c_custkey")}


def sweep_dfs(m, sess, b):
    """P23: one planned projection per input table, each output column
    one expression of SWEEP, then hash and xxhash64 of a string and a
    long column."""
    col, lit, F = m.core.col, m.core.lit, m.F
    out = {}
    for table, (_, exprs) in SWEEP.items():
        s, k = SWEEP_HASHES[table]
        sel = [build(m, col, lit, F).alias(name)
               for name, build, _ in exprs] + [
            F.hash(col(s)).alias("hash_s"), F.xxhash64(col(s)).alias("xx_s"),
            F.hash(col(k)).alias("hash_l"), F.xxhash64(col(k)).alias("xx_l")]
        out[f"P23 {table}"] = sess.from_batches(
            [b[table]], b[table].schema).select(*sel)
    return out


def _le_bytes(values):
    """(n, 8) uint8: the little-endian bytes of int64 values."""
    return np.ascontiguousarray(values.astype("<i8")).view(np.uint8) \
        .reshape(-1, 8)


def sweep_oracles(sd, q3d, names):
    """P23's expected columns per table: a list of Python values (str,
    bytes, bool or int) per output, or for the names a (matrix, lengths)
    of bytes; the hashes from np_murmur3_bytes / np_xxhash64_bytes."""
    out = {}
    codes = sd["p_type"][0]
    per_type = [[f(w) for w in P_TYPES] for _, _, f in SWEEP["part"][1]]
    out["part"] = [[vals[c] for c in codes.tolist()] for vals in per_type]
    phones = [bytes(r).decode() for r in sd["c_phone"]]
    nations = sd["c_nationkey"].tolist()
    out["customer"] = [[f(s, n) for s, n in zip(phones, nations)]
                       for _, _, f in SWEEP["customer"][1]]
    n, w = names.shape
    digits = names[:, 9:]
    out["names"] = [
        np.all(names[:, 9:13] == ord("0"), axis=1).tolist(),
        ((names[:, -1] - ord("0")) % 2 == 1).tolist(),
        (names[:, ::-1], np.full(n, w)),
        (digits, np.full(n, digits.shape[1]))]
    ptype_mat = np.zeros((len(P_TYPES), max(map(len, P_TYPES))), np.uint8)
    plens = np.array([len(p) for p in P_TYPES])
    for i, p in enumerate(P_TYPES):
        ptype_mat[i, :len(p)] = np.frombuffer(p.encode(), np.uint8)
    strings = {"part": (ptype_mat[codes], plens[codes]),
               "customer": (sd["c_phone"], np.full(len(phones), 15)),
               "names": (names, np.full(n, w))}
    longs = {"part": sd["p_partkey"], "customer": q3d["c_custkey"],
             "names": np.arange(1, n + 1, dtype=np.int64)}
    for table in out:
        mat, lens = strings[table]
        le = _le_bytes(longs[table])
        eight = np.full(le.shape[0], 8)
        # the numpy references give u32 / u64: as the port's int32 and
        # int64 lanes hold them
        out[table] += [np_murmur3_bytes(mat, lens, 42).view(np.int32),
                       np_xxhash64_bytes(mat, lens, 42).view(np.int64),
                       np_murmur3_bytes(le, eight, 42).view(np.int32),
                       np_xxhash64_bytes(le, eight, 42).view(np.int64)]
    return out


def _to_bytes(v):
    return v if isinstance(v, bytes) else v.encode() \
        if isinstance(v, str) else None


def check_sweep_column(label, col, n, want):
    """One P23 output column against its oracle, columnwise: a string
    column's offsets and bytes, a fixed-width column's values."""
    from spark_rapids_tpu_torch.columnar.column import StringColumn
    valid = col.validity[:n].cpu().numpy()
    if not valid.all():
        raise AssertionError(f"{label}: {int((~valid).sum())} null rows")
    if isinstance(col, StringColumn):
        off = col.offsets[:n + 1].cpu().numpy().astype(np.int64)
        data = col.data[:int(off[-1])].cpu().numpy()
        if isinstance(want, tuple):
            mat, lens = want
            keep = np.arange(mat.shape[1])[None, :] < lens[:, None]
            exp_data, exp_lens = mat[keep], lens
        else:
            enc = [_to_bytes(v) for v in want]
            exp_lens = np.array([len(b) for b in enc])
            exp_data = np.frombuffer(b"".join(enc), np.uint8)
        if not (np.array_equal(np.diff(off), exp_lens)
                and np.array_equal(data, exp_data)):
            raise AssertionError(f"{label}: bytes differ from the oracle")
        return
    got = col.data[:n].cpu().numpy()
    exp = np.asarray(want)
    if got.dtype == np.bool_ or exp.dtype == np.bool_:
        ok = np.array_equal(got.astype(bool), exp.astype(bool))
    else:
        ok = np.array_equal(got.astype(np.int64), exp.astype(np.int64))
    if not ok:
        bad = np.nonzero(got.astype(np.int64) != exp.astype(np.int64))[0]
        raise AssertionError(f"{label}: {bad.shape[0]} rows differ from the "
                             f"oracle, first {bad[:3]}")


def sweep_check(table, wants):
    """check(batches, label): every P23 output column of `table`."""
    names = [name for name, _, _ in SWEEP[table][1]] + [
        "hash_s", "xx_s", "hash_l", "xx_l"]

    def check(batches, label):
        if len(batches) != 1:
            raise AssertionError(f"{label}: {len(batches)} batches")
        b = batches[0]
        n = b.num_rows_host
        for name, col, want in zip(names, b.columns, wants[table]):
            check_sweep_column(f"{label} {name}", col, n, want)
    return check


def p24_df(m, sess, batch):
    """P24: the new aggregates over P6's 6,001,215 lineitems by
    (l_returnflag, l_linestatus): stddev_samp, stddev_pop, var_samp and
    var_pop of l_quantity and l_extendedprice, first and last of the
    nullable l_shipdate with and without ignoreNulls."""
    F = m.F
    aggs = []
    for c in ("l_quantity", "l_extendedprice"):
        aggs += [(F.stddev_samp(c), f"ss_{c}"), (F.stddev_pop(c), f"sp_{c}"),
                 (F.var_samp(c), f"vs_{c}"), (F.var_pop(c), f"vp_{c}")]
    aggs += [(F.first("l_shipdate"), "first"),
             (F.first("l_shipdate", True), "first_nn"),
             (F.last("l_shipdate"), "last"),
             (F.last("l_shipdate", True), "last_nn")]
    return (sess.from_batches([batch], batch.schema)
            .group_by("l_returnflag", "l_linestatus").agg(*aggs)
            .sort("l_returnflag", "l_linestatus"))


def p24_oracle(d, valid):
    """P24's rows: the moments by the reference's one-pass formula in
    numpy (f64 to rtol 1e-9 of the port's sums), first/last by position in
    the batch (the hash route's semantics in the JAX package)."""
    rf = np.asarray(RETURNFLAGS)[d["l_returnflag"][0]]
    ls = np.asarray(LINESTATUSES)[d["l_linestatus"][0]]
    sdate = d["l_shipdate"]
    rows = []
    for f, s in sorted(set(zip(rf.tolist(), ls.tolist()))):
        idx = np.nonzero((rf == f) & (ls == s))[0]
        row = [f, s]
        for c in ("l_quantity", "l_extendedprice"):
            x = d[c][idx]
            n = x.shape[0]
            mean = x.sum() / n
            m2 = max((x * x).sum() - n * mean * mean, 0.0)
            vs, vp = m2 / (n - 1), m2 / n
            row += [float(np.sqrt(vs)), float(np.sqrt(vp)), float(vs),
                    float(vp)]
        vi = idx[valid[idx]]
        row += [int(sdate[idx[0]]) if valid[idx[0]] else None,
                int(sdate[vi[0]]),
                int(sdate[idx[-1]]) if valid[idx[-1]] else None,
                int(sdate[vi[-1]])]
        rows.append(tuple(row))
    return rows


def p25_df(m, sess, b):
    """P25: the pre-grouped update path. P21's lineitem x part on the part
    key, without Q14's date filter, grouped by that key: count(*) and
    max(p_type). max over a string buffer sends the aggregate down the
    string route's sort fallback, and the inner join's key-grouped
    emission lets that update skip its sort
    (exec/aggregate._input_pre_grouped)."""
    lines = sess.from_batches([b["lineitem"]], b["lineitem"].schema)
    part = sess.from_batches([b["part"]], b["part"].schema)
    return (lines.join(part, left_on="l_partkey", right_on="p_partkey")
            .group_by("l_partkey")
            .agg((m.F.count(), "n"), (m.F.max("p_type"), "p_type")))


def p25_oracle(q3d, sd):
    """P25's rows in numpy: (part key, its lines, its p_type)."""
    keys, n = np.unique(q3d["l_partkey"], return_counts=True)
    types = np.asarray(P_TYPES)[sd["p_type"][0]][keys - 1]
    return [(int(k), int(c), str(t)) for k, c, t in zip(keys, n, types)]


def pre_grouped_aggs(tree):
    """The AggregateExecs of `tree` that take the pre-grouped path."""
    return [n for n in exec_nodes(tree)
            if type(n).__name__ == "AggregateExec" and n._pre_grouped]


def check_close_rows(want):
    """check(rows, label): keys and ints exact, floats to RTOL."""
    def check(rows, label, _metrics=None):
        if len(rows) != len(want):
            raise AssertionError(f"{label}: {len(rows)} rows != oracle "
                                 f"{len(want)}")
        for g, w in zip(rows, want):
            for a, b in zip(g, w):
                ok = abs(a - b) <= RTOL * abs(b) if isinstance(b, float) \
                    else a == b
                if not ok:
                    raise AssertionError(f"{label}: {g} != oracle {w}")
    return check


def strings_modules():
    """types_modules() with the conditional expressions."""
    from spark_rapids_tpu_torch.expr import conditional
    m = types_modules()
    m.cond = conditional
    return m


def strings_inputs(dev, dj, q3d, d19, names):
    """P21-P24's batches on `dev` and their oracles."""
    m = strings_modules()
    sd = strings_data(dj, q3d)
    b = strings_batches(m, dev, dj, q3d, sd, d19, names)
    sub, cents, q22_rows = q22_oracle(q3d, sd)
    wants = {"P21": q14_oracle(dj, q3d, sd), "P22 avg": [sub],
             "P22": q22_rows, "P22 cents": cents,
             "P23": sweep_oracles(sd, q3d, names),
             "P24": p24_oracle(d19, b["p24_valid"]),
             "P25": p25_oracle(q3d, sd)}
    return m, b, wants


#: each path's input tables (strings_batches' keys)
STRINGS_INPUTS = {"P21": ("lineitem", "part"), "P22 avg": ("customer",),
                  "P22": ("customer", "orders"), "P23 part": ("part",),
                  "P23 customer": ("customer",), "P23 names": ("names",),
                  "P24": ("p24",), "P25": ("lineitem", "part")}


def input_bound(b, label):
    """(bytes, ms): one read of the path's input columns at capacity (every
    tensor of each column) at PEAK_BYTES_PER_S."""
    nbytes = sum(x.numel() * x.element_size()
                 for t in STRINGS_INPUTS[label] for c in b[t].columns
                 for x in c.leaves())
    return nbytes, nbytes / PEAK_BYTES_PER_S * 1e3


def strings_dfs(m, dev, b, wants):
    sess = m.session.TpuSession(device=dev)
    dfs = {"P21": q14_df(m, sess, b), "P22 avg": q22_avg_df(m, sess, b),
           "P22": q22_df(m, sess, b, wants["P22 cents"]),
           "P24": p24_df(m, sess, b["p24"]), "P25": p25_df(m, sess, b)}
    dfs.update(sweep_dfs(m, sess, b))
    return dfs


def drive_strings_paths(dev, m, b, wants):
    """Phase 3f: P21 (Q14), P22 (Q22 and its subquery), P23 (the string
    sweep, checked columnwise on the card's output) and P24 (the new
    aggregates), planned from DataFrames, counted; the regex loop's
    evaluations, steps and host reads for P21 and P23. Returns (counts,
    records, the runs phase 4 times, the planned trees --profile
    traces)."""
    from spark_rapids_tpu_torch.regex import kernel as rk
    from spark_rapids_tpu_torch.ops import strings as ostr
    dfs = strings_dfs(m, dev, b, wants)
    counts, recs, runs, trees = {}, {}, {}, {}
    for label in ("P21", "P22 avg", "P22", "P24", "P25"):
        check = check_close_rows(wants[label]) if label == "P24" \
            else sorted_rows(wants[label]) if label == "P25" \
            else exact_rows(wants[label])
        rk.reset_counters()
        ostr.reset_counters()
        recs[label] = drive_planned(f"{label} planned", m, dfs[label],
                                    STRINGS_NEED[label], None, check)
        recs[label]["regex"] = rk.counters()
        recs[label]["string_loop_reads"] = ostr.counters()["host_reads"]
        counts[label] = recs[label]["launches"]
        trees[label] = planned(m, dfs[label])[0]
        runs[label] = (trees[label].collect, check)
        recs[label]["input_bytes"], recs[label]["bound_ms"] = \
            input_bound(b, label)
        print(f"{label}: reads {recs[label]['input_bytes']} bytes at "
              f"capacity, bound {recs[label]['bound_ms']:.4f} ms")
        print(f"{label}: {len(wants[label])} rows equal to the oracle, "
              f"first {wants[label][:2]}; regex loop {recs[label]['regex']} "
              f"(two drives)")
    # P25 again with its aggregates' update sorting (the pre-grouped
    # path off), the yardstick phase 4 times in turns with it
    aggs = pre_grouped_aggs(trees["P25"])
    p25_check = runs["P25"][1]
    p25_check(trees["P25"].collect(), "P25 routes")
    if not aggs or not all(a.metrics["sort_fallback"].value for a in aggs):
        raise AssertionError(f"P25: {len(aggs)} pre-grouped aggregates, "
                             f"routes {[route_counts(a) for a in aggs]}")
    recs["P25"]["routes"] = [route_counts(a) for a in aggs]
    sorting = planned(m, dfs["P25"])[0]
    for a in pre_grouped_aggs(sorting):
        a._pre_grouped = False
    # timed as execute(): collect() of 200,000 rows would build tuples
    # for longer than the sort it skips takes

    def check_batches(out, label):
        p25_check([r for batch in out for r in batch.to_pylist()], label)
    runs["P25"] = (lambda: list(trees["P25"].execute()), check_batches)
    runs["P25 sorting"] = (lambda: list(sorting.execute()), check_batches)
    print(f"P25: {len(aggs)} pre-grouped aggregates, routes "
          f"{recs['P25']['routes']}")
    print(f"P21 promo_revenue = {q14_ratio(wants['P21'][0])} % (100.00 * "
          f"the two exact sums, formed on the host)")
    avg6, cents = q22_threshold(wants["P22 avg"][0])
    print(f"P22 avg(c_acctbal) = {avg6} x 10^-6 (DECIMAL(16, 6), HALF_UP); "
          f"c_acctbal > {cents} x 10^-2")
    for table in SWEEP:
        label = f"P23 {table}"
        tree = planned(m, dfs[label])[0]
        rk.reset_counters()
        ostr.reset_counters()
        out, cnt, reads = drive_batches(label, tree, STRINGS_NEED["P23"])
        sweep_check(table, wants["P23"])(out, label)
        counts[label] = cnt
        recs[label] = {"launches": cnt, "host_reads": reads,
                       "regex": rk.counters(),
                       "string_loop_reads": ostr.counters()["host_reads"],
                       "rows": out[0].num_rows_host,
                       "columns": len(out[0].columns)}
        recs[label]["input_bytes"], recs[label]["bound_ms"] = \
            input_bound(b, label)
        trees[label] = tree
        runs[label] = (lambda t=tree: list(t.execute()),
                       lambda out, label, t=table:
                       sweep_check(t, wants["P23"])(out, label))
        print(f"{label}: {recs[label]['columns']} columns of "
              f"{recs[label]['rows']} rows equal to their oracles "
              f"(reads {recs[label]['input_bytes']} bytes at capacity, "
              f"bound {recs[label]['bound_ms']:.4f} ms); "
              f"launches {cnt}; host reads {reads}; regex loop "
              f"{recs[label]['regex']}; string loop reads "
              f"{recs[label]['string_loop_reads']}")
    return counts, recs, runs, trees


def strings_tree(m, dev, b, wants, label):
    """A fresh planned tree of one of P21-P25 (phase 2 captures its
    kernels' inputs from a run of it)."""
    return planned(m, strings_dfs(m, dev, b, wants)[label])[0]


def capture_murmur3(plan):
    """Run `plan` once and keep the inputs of every murmur3 chain launch
    (ops/murmur3_lanes.murmur3_columns, which ops/join.py imports by
    name for the join's hash), in call order: [(columns, seeds)]."""
    import torch
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    from spark_rapids_tpu_torch.ops import join as oj, murmur3_lanes as m3
    calls, real = [], m3.murmur3_columns

    def record(columns, seeds):
        calls.append((list(columns), [s.clone() if hasattr(s, "clone")
                                      else s for s in seeds]))
        return real(columns, seeds)
    record.launches = real.launches
    m3.murmur3_columns = oj.murmur3_columns = record
    try:
        with speculation_scope():
            list(plan.execute())
            torch.cuda.synchronize()
    finally:
        m3.murmur3_columns = oj.murmur3_columns = real
    return calls


def compare_strings_paths(dev, m, b, wants):
    """Phase 2 at P21-P25's own inputs: every launch of a run of each path,
    held exactly to its plain version: the murmur3 chain (each join's
    build pair and stream keys; P23's hash of a long), the probe of each
    join, every row gather (P24's group-by and sort too) and every
    dictionary take."""
    from spark_rapids_tpu_torch.ops import murmur3_lanes as m3

    def tree(label):
        return strings_tree(m, dev, b, wants, label)
    for label in ("P21", "P22", "P25"):
        joins = [n for n in exec_nodes(tree(label))
                 if type(n).__name__ == "HashJoinExec"]
        if len(joins) != 1:
            raise AssertionError(f"{label}: {len(joins)} hash joins")
        gathers = capture_row_gathers(tree(label))
        compare_join_inputs(label, JoinInputs(joins[0]), gathers)
        takes = capture_dict_gathers(tree(label))
        if takes:
            print(f"compare {label} main-path dictionary gathers: "
                  f"{'; '.join(compare_dict_takes(label, takes))}; exact")
    gathers = capture_row_gathers(tree("P24"))
    print(f"compare P24 main-path row gathers: "
          f"{'; '.join(compare_row_gathers('P24', gathers))}; exact")
    del gathers
    for table in SWEEP:
        label = f"P23 {table}"
        calls = capture_murmur3(tree(label))
        if not calls:
            raise AssertionError(f"{label}: no murmur3 launch captured")
        for k, (cols, seeds) in enumerate(calls):
            _exact(f"murmur3 {label} call {k}", m3.murmur3_columns(cols,
                                                                   seeds),
                   m3.murmur3_columns_plain(cols, seeds))
        print(f"compare {label} murmur3 launches: {len(calls)} of "
              f"{calls[0][0][0].capacity} rows; exact")


def strings_kernel_shapes(dev, m, b, wants, counts):
    """Phase 4: each kernel at P21's and P22's shapes (join_kernel_shapes).
    Returns {path: {kernel name: record}}."""
    def joins_of(label):
        def fresh():
            tree = strings_tree(m, dev, b, wants, label)
            return tree, [n for n in exec_nodes(tree)
                          if type(n).__name__ == "HashJoinExec"]
        return fresh
    return {label: join_kernel_shapes(label, joins_of(label), counts[label])
            for label in ("P21", "P22")}


def time_strings_paths(runs):
    """Phase 4: P21-P25 and P25 with its update sorting, in turns (the
    order reversed every other round), P_STRING_ITERS runs each, one
    synchronisation a run: collect() of the planned tree (P23 and P25:
    its execute(), checked afterwards)."""
    import torch
    out = {label: [] for label in runs}
    for i in range(P_STRING_ITERS):
        for label in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
            run, check = runs[label]
            t0 = time.perf_counter()
            rows = run()
            torch.cuda.synchronize()
            out[label].append((time.perf_counter() - t0) * 1e3)
            check(rows, f"{label} timed")
    for label, ms in out.items():
        print(f"{label} ms per run ({P_STRING_ITERS} runs, in turns): "
              f"{[round(x, 3) for x in ms]}")
    return out


# -- slice 12: windows, arrays, split, the list aggregates and the cache
# -- (phase 3g) -------------------------------------------------------------

#: P27's lineitems as 16 batches: more sorted runs than the sort's merge
#: fan-in (8), so the sort goes out of core and emits chunks of its runs'
#: bucket (524,288 rows)
P27_BATCHES = 16
P28_PART = 7             # array_contains' literal part key
P_WINDOW_ITERS = 3       # phase 4's timed runs of P26-P28 each
#: the kernels each path must launch
WINDOW_NEED = {"P26 A": ["dma_row_gather"], "P26 B": ["dma_row_gather"],
               "P27": ["dma_row_gather"], "P28 collect": ["dma_row_gather"],
               "P28 explode": ["dma_row_gather"],
               "P28 posexplode": ["dma_row_gather"],
               "P28 percentile": ["dma_row_gather"], "P28 split": []}
#: each path's input tables (windows_batches' keys)
WINDOW_INPUTS = {"P26 A": ("orders",), "P26 B": ("orders",),
                 "P27": ("p27",), "P28 collect": ("lines",),
                 "P28 explode": ("lines",), "P28 posexplode": ("lines",),
                 "P28 percentile": ("q1_lines",), "P28 split": ("part",)}
P27_FIELDS = (("l_quantity", "DOUBLE"), ("l_extendedprice", "DOUBLE"),
              ("l_returnflag", "STRING"), ("l_linestatus", "STRING"))
P28_QUANTILES = [0.25, 0.5, 0.75]


def windows_modules():
    """strings_modules() with the port's window expressions."""
    from spark_rapids_tpu_torch.expr import windowexprs
    m = strings_modules()
    m.win = windowexprs
    return m


def windows_data(dj, q3d):
    """P26's orders (tpch_join_data's, with q3_types_data's o_custkey: about
    100,000 customers of about 15 orders each) and their o_totalprice, the
    sum of the order's lines' l_extendedprice x (1 - l_discount) in
    dollars; P28's lines (l_orderkey, l_partkey, l_suppkey)."""
    n_orders = dj["o_orderkey"].shape[0]
    okey = dj["l_orderkey"] - 1
    owner = (okey // 32) * 8 + okey % 32
    price = q3d["l_extendedprice"] / 100.0 * (1.0 - dj["l_discount"])
    return {"o_orderkey": dj["o_orderkey"], "o_custkey": q3d["o_custkey"],
            "o_orderdate": dj["o_orderdate"],
            "o_totalprice": np.bincount(owner, weights=price,
                                        minlength=n_orders),
            "l_orderkey": dj["l_orderkey"], "l_partkey": q3d["l_partkey"],
            "l_suppkey": dj["l_suppkey"]}


def windows_batches(m, dev, wd, d19, sd):
    """P26-P28's batches on `dev`: the orders, P27's lines (P6's, the flags
    DictionaryColumns) as P27_BATCHES batches and as one, P28's lines and
    P21's parts (p_type a plain StringColumn)."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    t = m.t
    schema = t.Schema(tuple(t.StructField(n, getattr(t, ty))
                            for n, ty in P27_FIELDS))
    n19 = d19["l_quantity"].shape[0]
    step = -(-n19 // P27_BATCHES)
    p27 = []
    for lo in range(0, n19, step):
        part = {n: (d19[n][0][lo: lo + step], d19[n][1])
                if isinstance(d19[n], tuple) else d19[n][lo: lo + step]
                for n, _ in P27_FIELDS}
        p27.append(ColumnarBatch(*q19_columns(part, schema, dev), schema))
    return {
        "orders": batch_of(m, dev, [
            ("o_orderkey", wd["o_orderkey"], t.LONG),
            ("o_custkey", wd["o_custkey"], t.LONG),
            ("o_orderdate", wd["o_orderdate"], t.DATE),
            ("o_totalprice", wd["o_totalprice"], t.DOUBLE)]),
        "p27": p27,
        "q1_lines": ColumnarBatch(*q19_columns(d19, schema, dev), schema),
        "lines": batch_of(m, dev, [
            ("l_orderkey", wd["l_orderkey"], t.LONG),
            ("l_partkey", wd["l_partkey"], t.LONG),
            ("l_suppkey", wd["l_suppkey"], t.LONG)]),
        "part": batch_of(m, dev, [("p_partkey", sd["p_partkey"], t.LONG),
                                  ("p_type", string_column(*sd["p_type"],
                                                           dev), t.STRING)])}


def p26_dfs(m, sess, b):
    """P26 over one cache()d orders frame: spec A (partition by o_custkey,
    order by o_totalprice DESC) ranks the orders and keeps each
    customer's top 3; spec B (order by o_orderdate) takes running, sliding,
    RANGE and whole-partition aggregates and first/last_value."""
    F, col, lit, W = m.F, m.core.col, m.core.lit, m.win
    Fr = W.WindowFrame
    orders = sess.from_batches([b["orders"]], b["orders"].schema).cache()
    a = W.window(["o_custkey"], [("o_totalprice", False)])
    p26a = orders.with_windows(
        (F.row_number().over(a), "rn"), (F.rank().over(a), "rk"),
        (F.dense_rank().over(a), "drk"),
        (F.lag("o_totalprice", 1).over(a), "prev_price"),
        (F.lead("o_orderdate", 1).over(a), "next_date")) \
        .filter(col("rk") <= lit(3))
    spec = W.window(["o_custkey"], [("o_orderdate", True)])

    def over(fn, frame=None):
        return fn.over(spec.with_frame(frame) if frame else spec)
    price = "o_totalprice"
    p26b = orders.with_windows(
        (over(F.window_sum(price), Fr.rows(None, 0)), "run_sum"),
        (over(F.window_min(price), Fr.rows(2, 0)), "min3"),
        (over(F.window_max(price), Fr.rows(2, 0)), "max3"),
        (over(F.window_sum(price), Fr.range(90, 0)), "sum90"),
        (over(F.window_avg(price), Fr.unbounded()), "avg_all"),
        (over(F.window_count(price), Fr.unbounded()), "cnt"),
        (over(F.first_value(price)), "first"),
        (over(F.last_value(price)), "last"))
    return {"P26 A": p26a, "P26 B": p26b}, orders


def p27_df(m, sess, batches):
    """P27: the whole (returnflag, linestatus) partition's revenue, average
    quantity and count, then each line's share of its group's revenue."""
    F, col, W = m.F, m.core.col, m.win
    part = W.window(["l_returnflag", "l_linestatus"])
    return sess.from_batches(batches, batches[0].schema).with_windows(
        (F.window_sum("l_extendedprice").over(part), "rev"),
        (F.window_avg("l_quantity").over(part), "avg_qty"),
        (F.window_count().over(part), "cnt")).select(
        col("l_returnflag"), col("l_linestatus"), col("l_extendedprice"),
        col("rev"), col("avg_qty"), col("cnt"),
        (col("l_extendedprice") / col("rev")).alias("share"))


def p28_dfs(m, sess, b):
    """P28: the lines' parts and suppliers collected by order and the
    array expressions over them; the lists exploded and posexploded back
    to lines; the exact and approximate percentiles of Q1's lines by the
    two flags; p_type split into words, exploded and counted by word."""
    F, col = m.F, m.core.col
    lines = sess.from_batches([b["lines"]], b["lines"].schema)
    coll = lines.group_by("l_orderkey").agg(
        (F.collect_list("l_partkey"), "parts"),
        (F.collect_set("l_suppkey"), "supps"))
    keep = coll.select(col("l_orderkey"), F.size("parts").alias("n"),
                       col("parts"))
    q1 = sess.from_batches([b["q1_lines"]], b["q1_lines"].schema)
    part = sess.from_batches([b["part"]], b["part"].schema)
    return {
        "P28 collect": coll.select(
            col("l_orderkey"), col("parts"), col("supps"),
            F.size("parts").alias("n"), F.sort_array("parts").alias("sorted"),
            F.array_contains("parts", P28_PART).alias("has"),
            F.element_at("parts", 1).alias("first"),
            F.array_max("parts").alias("top")),
        "P28 explode": keep.explode("parts", "pk"),
        "P28 posexplode": keep.posexplode("parts", "pk", "pos"),
        "P28 percentile": q1.group_by("l_returnflag", "l_linestatus").agg(
            (F.percentile("l_quantity", 0.5), "median_qty"),
            (F.approx_percentile("l_extendedprice", P28_QUANTILES),
             "price_q")),
        "P28 split": part.select(F.split("p_type", " ").alias("words"))
        .explode("words", "word").group_by("word").agg((F.count(), "n"))}


def p27_conf(batches):
    """A coalesce target of one input batch: P27's scan keeps its batches
    apart (the default target would merge them into one sorted run)."""
    return {"spark.rapids.sql.batchSizeBytes":
            str(max(x.nbytes for x in batches))}


def windows_dfs(m, dev, b):
    sess = m.session.TpuSession(device=dev)
    dfs, orders = p26_dfs(m, sess, b)
    dfs["P27"] = p27_df(m, m.session.TpuSession(p27_conf(b["p27"]),
                                                device=dev), b["p27"])
    dfs.update(p28_dfs(m, sess, b))
    return dfs, orders


# -- P26-P28's oracles (numpy), checked columnwise on the output batches ----

def fetch_columns(out):
    """Concatenated host arrays of result batches: per column (data,
    validity), or (offsets from 0, child data, child validity) for a list
    column, or (the first byte of each row, validity) for a string column
    of one-byte rows."""
    from spark_rapids_tpu_torch.columnar.column import (ArrayColumn,
                                                        StringColumn)
    from spark_rapids_tpu_torch.columnar.transfer import fetch_batch_host
    cols = None
    for b in out:
        host, n = fetch_batch_host(b)
        got = []
        for c in host:
            if isinstance(c, ArrayColumn):
                off = c.offsets[: n + 1].numpy().astype(np.int64)
                k = int(off[-1]) if n else 0
                got.append(("array", off, c.child.data[:k].numpy(),
                            c.child.validity[:k].numpy()))
            elif isinstance(c, StringColumn):
                off = c.offsets[: n + 1].numpy().astype(np.int64)
                raw = c.data.numpy()
                got.append(("string", off, raw, c.validity[:n].numpy()))
            else:
                got.append(("fixed", c.data[:n].numpy(),
                            c.validity[:n].numpy()))
        if cols is None:
            cols = [[g] for g in got]
        else:
            for acc, g in zip(cols, got):
                acc.append(g)
    merged = []
    for parts in cols or []:
        kind = parts[0][0]
        if kind == "fixed":
            merged.append((np.concatenate([p[1] for p in parts]),
                           np.concatenate([p[2] for p in parts])))
        elif kind == "array":
            offs, base = [], 0
            for p in parts:
                offs.append(p[1][:-1] + base)
                base += int(p[1][-1])
            merged.append((np.concatenate(offs + [np.array([base])]),
                           np.concatenate([p[2] for p in parts]),
                           np.concatenate([p[3] for p in parts])))
        else:
            first = np.concatenate([p[2][np.minimum(p[1][:-1],
                                                    p[2].shape[0] - 1)]
                                    for p in parts])
            merged.append((first, np.concatenate([p[3] for p in parts])))
    return merged


def _close(label, got, want, valid=None):
    want = np.asarray(want, np.float64)
    ok = np.abs(got - want) <= RTOL * np.maximum(np.abs(want), 1e-300)
    if valid is not None:
        ok = ok | ~valid
    if not ok.all():
        i = int(np.argmin(ok))
        raise AssertionError(f"{label}: row {i} {got[i]!r} != {want[i]!r}")


def _equal(label, got, want):
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"{label}: {got[:8]} != oracle {want[:8]}")


def _groups(keys):
    """(start flags, each row's group start) of sorted key columns."""
    n = keys[0].shape[0]
    start = np.zeros(n, bool)
    start[:1] = True
    for k in keys:
        start[1:] |= k[1:] != k[:-1]
    first = np.maximum.accumulate(np.where(start, np.arange(n), 0))
    return start, first


def _window_sums(v, lo, hi):
    """Sum of v[lo:hi] a row, in order (every frame spans few rows)."""
    out = np.zeros(v.shape[0])
    width = hi - lo
    for j in range(int(width.max(initial=0))):
        use = j < width
        out[use] += v[lo[use] + j]
    return out


def p26_oracles(wd):
    """Spec A's kept rows and spec B's rows, as numpy columns in the
    window's output order."""
    cust, price = wd["o_custkey"], wd["o_totalprice"]
    date, okey = wd["o_orderdate"], wd["o_orderkey"]
    n = cust.shape[0]
    idx = np.arange(n)
    a = np.lexsort((idx, -price, cust))
    c, p, d = cust[a], price[a], date[a]
    start, first = _groups([c])
    rn = idx - first + 1
    tie = start | np.r_[True, p[1:] != p[:-1]]
    rk = np.maximum.accumulate(np.where(tie, idx, 0)) - first + 1
    cs = np.cumsum(tie)
    drk = cs - cs[first] + 1
    end = np.r_[start[1:], True]
    keep = rk <= 3
    want_a = {"o_orderkey": okey[a], "o_custkey": c, "o_orderdate": d,
              "o_totalprice": p, "rn": rn, "rk": rk, "drk": drk,
              "prev_price": (np.r_[0.0, p[:-1]], ~start),
              "next_date": (np.r_[d[1:], 0], ~end)}
    want_a = {k: ((v[0][keep], v[1][keep]) if isinstance(v, tuple)
                  else v[keep]) for k, v in want_a.items()}
    b = np.lexsort((idx, date, cust))
    c, p, d = cust[b], price[b], date[b]
    start, first = _groups([c])
    last = np.r_[np.nonzero(start)[0][1:], n] - 1
    glast = last[np.cumsum(start) - 1]
    key = (c.astype(np.int64) << 16) | d.astype(np.int64)
    lo90 = np.searchsorted(key, key - 90, "left")
    hi90 = np.searchsorted(key, key, "right")
    total = _window_sums(p, first, glast + 1)
    cnt = glast - first + 1
    lo3 = np.maximum(idx - 2, first)
    mins = np.minimum.reduce([p[np.maximum(idx - j, lo3)]
                              for j in range(3)])
    maxs = np.maximum.reduce([p[np.maximum(idx - j, lo3)]
                              for j in range(3)])
    want_b = {"o_orderkey": okey[b], "o_custkey": c, "o_orderdate": d,
              "o_totalprice": p, "run_sum": _window_sums(p, first, idx + 1),
              "min3": mins, "max3": maxs,
              "sum90": _window_sums(p, lo90, hi90), "avg_all": total / cnt,
              "cnt": cnt, "first": p[first], "last": p[hi90 - 1]}
    return want_a, want_b


def check_columns(names, want, close=()):
    """A check of output batches against numpy columns: exact, f64 in
    `close` to RTOL; a (values, validity) want checks both."""
    def check(out, label):
        got = fetch_columns(out)
        if len(got) != len(names):
            raise AssertionError(f"{label}: {len(got)} columns")
        for name, g in zip(names, got):
            w = want[name]
            data, valid = g[0], g[-1]
            if isinstance(w, tuple):
                _equal(f"{label} {name} validity", valid, w[1])
                w = np.where(w[1], w[0], 0)
                data = np.where(valid, data, 0)
            elif not valid.all():
                raise AssertionError(f"{label}: nulls in {name}")
            if name in close:
                _close(f"{label} {name}", data, w)
            else:
                _equal(f"{label} {name}", data, np.asarray(w).astype(
                    data.dtype))
    return check


def p27_check(d19):
    """Every line once, with its (returnflag, linestatus) group's revenue,
    average quantity and count, and its share of the revenue."""
    flags = [d19[n] for n in ("l_returnflag", "l_linestatus")]
    gid = flags[0][0].astype(np.int64) * 8 + flags[1][0]
    price, qty = d19["l_extendedprice"], d19["l_quantity"]
    groups = {g: (math.fsum(price[gid == g]), qty[gid == g].mean(),
                  int((gid == g).sum())) for g in np.unique(gid)}
    codes = [{ord(w): k for k, w in enumerate(f[1])} for f in flags]

    def check(out, label):
        rf, ls, pr, rev, avg, cnt, share = fetch_columns(out)
        g = np.array([codes[0][x] for x in rf[0].tolist()]) * 8 \
            + np.array([codes[1][x] for x in ls[0].tolist()])
        _equal(f"{label} lines", np.sort(g * 1e9 + pr[0]),
               np.sort(gid * 1e9 + price))
        for k, (s, q, c) in groups.items():
            at = g == k
            _close(f"{label} revenue {k}", rev[0][at], np.full(at.sum(), s))
            _close(f"{label} avg_qty {k}", avg[0][at], np.full(at.sum(), q))
            _equal(f"{label} cnt {k}", cnt[0][at], np.full(at.sum(), c))
        _close(f"{label} share", share[0], pr[0] / rev[0])
        # a group's rows are one contiguous run (partition order)
        if (np.diff(g) != 0).sum() != len(groups) - 1:
            raise AssertionError(f"{label}: a group is not contiguous")
    return check


def p28_oracles(wd):
    """Per order in l_orderkey order: its parts in line order, its distinct
    suppliers, and the lines in (order, line) order."""
    order = np.lexsort((np.arange(wd["l_orderkey"].shape[0]),
                        wd["l_orderkey"]))
    ok, pk, sk = (wd[n][order] for n in ("l_orderkey", "l_partkey",
                                         "l_suppkey"))
    start, _ = _groups([ok])
    starts = np.nonzero(start)[0]
    counts = np.diff(np.r_[starts, ok.shape[0]])
    row = np.repeat(np.arange(starts.shape[0]), counts)
    sorted_pk = pk[np.lexsort((pk, row))]
    return {"keys": ok[starts], "counts": counts, "row": row, "parts": pk,
            "supps": np.unique(row.astype(np.int64) << 32 | sk),
            "sorted": sorted_pk,
            "has": np.bincount(row, weights=pk == P28_PART) > 0,
            "first": pk[starts], "top": np.maximum.reduceat(pk, starts)}


def p28_collect_check(w):
    def check(out, label):
        key, parts, supps, n, srt, has, first, top = fetch_columns(out)
        _equal(f"{label} keys", key[0], w["keys"])
        offs = np.r_[0, np.cumsum(w["counts"])]
        for name, got, child in (("parts", parts, w["parts"]),
                                 ("sorted", srt, w["sorted"])):
            _equal(f"{label} {name} offsets", got[0], offs)
            _equal(f"{label} {name}", got[1], child)
        srow = np.repeat(np.arange(supps[0].shape[0] - 1), np.diff(supps[0]))
        _equal(f"{label} supps", np.sort(srow.astype(np.int64) << 32
                                         | supps[1]), w["supps"])
        _equal(f"{label} n", n[0], w["counts"].astype(np.int32))
        _equal(f"{label} has", has[0], w["has"])
        _equal(f"{label} first", first[0], w["first"])
        _equal(f"{label} top", top[0], w["top"])
    return check


def p28_explode_check(w, position):
    def check(out, label):
        cols = fetch_columns(out)
        key, n, pk = cols[0][0], cols[1][0], cols[-1][0]
        _equal(f"{label} keys", key, np.repeat(w["keys"], w["counts"]))
        _equal(f"{label} n", n, np.repeat(w["counts"], w["counts"])
               .astype(np.int32))
        _equal(f"{label} parts", pk, w["parts"])
        if position:
            starts = np.r_[0, np.cumsum(w["counts"])[:-1]]
            _equal(f"{label} pos", cols[3][0], (np.arange(key.shape[0])
                   - np.repeat(starts, w["counts"])).astype(np.int32))
    return check


def p28_percentile_check(d19):
    flags = [d19[n] for n in ("l_returnflag", "l_linestatus")]
    gid = flags[0][0].astype(np.int64) * 8 + flags[1][0]
    acc = 10000  # approx_percentile's default accuracy

    def check(rows, label, _metrics=None):
        if len(rows) != len(np.unique(gid)):
            raise AssertionError(f"{label}: {len(rows)} groups")
        for rf, ls, median, qs in rows:
            at = gid == (flags[0][1].index(rf) * 8 + flags[1][1].index(ls))
            _close(f"{label} median {rf}{ls}", np.array([median]),
                   [np.percentile(d19["l_quantity"][at], 50)])
            s = np.sort(d19["l_extendedprice"][at])
            n = s.shape[0]
            for p, v in zip(P28_QUANTILES, qs):
                lo = np.searchsorted(s, v, "left")
                hi = np.searchsorted(s, v, "right")
                if not (lo - n / acc <= p * n <= hi + n / acc):
                    raise AssertionError(
                        f"{label}: {rf}{ls} p={p}: {v} ranks {lo}-{hi} of "
                        f"{n}, beyond n/accuracy of {p * n}")
    return check


def p28_split_oracle(sd):
    codes, types = sd["p_type"]
    per_type = np.bincount(codes, minlength=len(types))
    tally = {}
    for k, t in enumerate(types):
        for word in t.split(" "):
            tally[word] = tally.get(word, 0) + int(per_type[k])
    return sorted(tally.items())


def windows_inputs(dev, dj, q3d, d19, sd):
    """P26-P28's batches on `dev` and their checks."""
    m = windows_modules()
    wd = windows_data(dj, q3d)
    b = windows_batches(m, dev, wd, d19, sd)
    want_a, want_b = p26_oracles(wd)
    w28 = p28_oracles(wd)
    checks = {
        "P26 A": check_columns(list(want_a), want_a, ("o_totalprice",)),
        "P26 B": check_columns(list(want_b), want_b,
                               ("run_sum", "sum90", "avg_all")),
        "P27": p27_check(d19),
        "P28 collect": p28_collect_check(w28),
        "P28 explode": p28_explode_check(w28, False),
        "P28 posexplode": p28_explode_check(w28, True),
        "P28 percentile": p28_percentile_check(d19),
        "P28 split": sorted_rows(p28_split_oracle(sd))}
    return m, b, checks


def window_bound(b, label):
    """(bytes, ms): one read of the path's input columns at capacity at
    PEAK_BYTES_PER_S (as input_bound)."""
    batches = [x for t in WINDOW_INPUTS[label]
               for x in (b[t] if isinstance(b[t], list) else [b[t]])]
    nbytes = sum(x.numel() * x.element_size() for bb in batches
                 for c in bb.columns for x in c.leaves())
    return nbytes, nbytes / PEAK_BYTES_PER_S * 1e3


def window_metrics(tree):
    """The drive's host reads and the carry's counters of a planned tree
    (WindowExec and GenerateExec metrics)."""
    out = {}
    for node in exec_nodes(tree):
        for k in ("partitionHostReads", "carriedPartitions", "carryPieces",
                  "measureHostReads"):
            if k in node.metrics:
                out[k] = out.get(k, 0) + node.metrics[k].value
    return out


def drive_window_path(label, m, df, need, check):
    """One of P26-P28 planned from its DataFrame and driven once counted
    (drive_batches); checked with `check` on the output batches, or on
    collect()'s rows for the small outputs. Returns (tree, record)."""
    tree, tag_ms, convert_ms = planned(m, df)
    out, counts, reads = drive_batches(label, tree, need)
    if label in ("P28 percentile", "P28 split"):
        check([r for b in out for r in b.to_pylist()], label)
    else:
        check(out, label)
    rec = {"plan_ms": tag_ms + convert_ms, "launches": counts,
           "host_reads": reads, "rows": sum(b.num_rows_host for b in out),
           **window_metrics(tree)}
    del out
    check_idle(label)
    print(f"{label}: {rec['rows']} rows equal to the oracle; launches "
          f"{counts}; host reads {reads}; drive {window_metrics(tree)}")
    return tree, rec


def drive_windows_paths(dev, m, b, checks):
    """Phase 3g: P26 (spec A and B over one cached orders frame, one
    materialization), P27 under a device budget (the out-of-core sort's
    chunks, the carry on the N/O partition), P28's five steps (the fifth
    planned with 16 shuffle partitions: single-partition in both packages,
    list buffers never cross the host shuffle). Returns (counts, records,
    runs, trees)."""
    from spark_rapids_tpu_torch import memory as M
    dfs, orders = windows_dfs(m, dev, b)
    counts, recs, runs, trees = {}, {}, {}, {}
    for label in ("P26 A", "P26 B", "P28 collect", "P28 explode",
                  "P28 posexplode", "P28 percentile", "P28 split"):
        tree, rec = drive_window_path(label, m, dfs[label],
                                      WINDOW_NEED[label], checks[label])
        rec["input_bytes"], rec["bound_ms"] = window_bound(b, label)
        counts[label], recs[label], trees[label] = rec["launches"], rec, tree
        small = label in ("P28 percentile", "P28 split")
        runs[label] = ((lambda t=tree: t.collect()) if small else
                       (lambda t=tree: list(t.execute())), checks[label])
    mat = orders._cached_relation.materializations
    if mat != 1:
        raise AssertionError(f"P26: the cache materialized {mat} times")
    recs["P26 A"]["cache_materializations"] = mat
    print(f"P26: the orders cache materialized {mat} time for both specs "
          f"({orders._cached_relation.compressed_bytes} bytes of frames)")
    # P27 under a budget: its 16 sorted runs spill, the sort merges them
    # out of core, the N/O partition takes the carry
    plan, p27_counts, p27_rec = drive_under_budget(
        "P27", lambda: planned(m, dfs["P27"])[0], WINDOW_NEED["P27"],
        checks["P27"], False)
    drive = window_metrics(plan)
    if not drive.get("carriedPartitions"):
        raise AssertionError(f"P27: no partition took the carry ({drive})")
    if M.buffer_catalog().num_entries():
        raise AssertionError("P27: the catalog is not empty")
    p27_rec.update(drive, launches=p27_counts)
    p27_rec["input_bytes"], p27_rec["bound_ms"] = window_bound(b, "P27")
    counts["P27"], recs["P27"], trees["P27"] = p27_counts, p27_rec, plan
    runs["P27"] = (plan, p27_rec)
    # the yardstick: the same plan with no budget, in turns with the rest
    trees["P27 unconstrained"] = planned(m, dfs["P27"])[0]
    runs["P27 unconstrained"] = (
        lambda t=trees["P27 unconstrained"]: list(t.execute()),
        checks["P27"])
    print(f"P27: carried partitions {drive['carriedPartitions']}, pieces "
          f"{drive['carryPieces']}, partition host reads "
          f"{drive['partitionHostReads']}; catalog empty")
    # step 5: the collect over 16 partitions of the host shuffle
    sess16 = m.session.TpuSession(
        {"spark.rapids.sql.shuffle.partitions": "16"}, device=dev)
    df16 = p28_dfs(m, sess16, b)["P28 collect"]
    names = {type(n).__name__ for n in exec_nodes(planned(m, df16)[0])}
    if "HostShuffleExchangeExec" in names:
        raise AssertionError("P28 step 5: list buffers crossed a shuffle")
    recs["P28 collect"]["shuffled_16"] = "skipped: planned single-partition"
    print("P28 step 5 (16 shuffle partitions): skipped, the planner keeps "
          "the list aggregate single-partition, as the JAX package does")
    for label, rec in recs.items():
        print(f"{label}: reads {rec['input_bytes']} bytes at capacity, "
              f"bound {rec['bound_ms']:.4f} ms")
    return counts, recs, runs, trees


def windows_tree(m, dev, b, label):
    """A fresh planned tree of one of P26-P28 (phase 2 captures its
    kernels' inputs from a run of it)."""
    return planned(m, windows_dfs(m, dev, b)[0][label])[0]


def compare_windows_paths(dev, m, b):
    """Phase 2 at P26-P28's own inputs: every row gather of a run of each
    path (the window's sort, the filter's compaction, the group-by's sort,
    the explode's payload) and every dictionary take (P27 and P28's
    percentiles decode the flags), held exactly to the plain versions."""
    shapes = {}
    for label in ("P26 A", "P26 B", "P27", "P28 collect", "P28 explode",
                  "P28 percentile"):
        gathers = capture_row_gathers(windows_tree(m, dev, b, label))
        shapes[label] = compare_row_gathers(label, gathers)
        print(f"compare {label} main-path row gathers: "
              f"{'; '.join(shapes[label])}; exact")
        del gathers
        if label in ("P27", "P28 percentile"):
            takes = capture_dict_gathers(windows_tree(m, dev, b, label))
            if takes:
                print(f"compare {label} main-path dictionary gathers: "
                      f"{'; '.join(compare_dict_takes(label, takes))}; "
                      f"exact")
    return shapes


def windows_gather_shapes(dev, m, b):
    """Phase 4: dma_row_gather at every distinct shape of P26, P27 and
    P28's collect (time_gather_call: the kernel, the plain version, the
    bound and index_select), the generic kernel among them where a row is
    wider than the fixed-width kinds (ROADMAP B.3)."""
    out = []
    for label in ("P26 A", "P26 B", "P27", "P28 collect", "P28 explode"):
        seen = set()
        for call in capture_row_gathers(windows_tree(m, dev, b, label)):
            site, plan, imat, fmat, idx = call
            key = (site, idx.shape[0], imat.shape, None if fmat is None
                   else fmat.shape)
            if key in seen:
                continue
            seen.add(key)
            out.append(time_gather_call(label, *call))
    return out


def time_windows_paths(runs):
    """Phase 4: P26 and P28 in turns (the order reversed every other
    round), P_WINDOW_ITERS runs each, one synchronisation a run; then P27
    under its budget (time_under_budget, P_ITERS runs)."""
    import torch
    runs = dict(runs)
    p27 = runs.pop("P27")
    out = {label: [] for label in runs}
    for i in range(P_WINDOW_ITERS):
        for label in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
            run, check = runs[label]
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            out[label].append((time.perf_counter() - t0) * 1e3)
            check(res, f"{label} timed")
            del res
    out["P27"] = time_under_budget(*p27)
    for label, ms in out.items():
        print(f"{label} ms per run ({P_WINDOW_ITERS} runs, in turns): "
              f"{[round(x, 3) for x in ms]}")
    return out


# -- slice 13: structs, maps, lambdas, JSON, URL and z-order (phase 3h) -----

P_NESTED_ITERS = 3       # phase 4's timed runs of P29-P31 each
CLERKS = tuple(f"Clerk#{k:09d}" for k in range(1, 1001))  # clause 4.2.3
P29_LOOKUP = ("status", "clerk", "none")   # element_at_key's key column
P29_COLLECT = 1000       # P29 step 4: the rows collect() brings back
P31_ROWS = 1 << 20       # P31's event documents and URLs
#: P31's rows draw from this many distinct documents and URLs (the host
#: builds them and their oracles in Python, a row at a time)
P31_POOL = 1 << 17
P31_DOMAINS = 10_000
P31_PATHS = ("$.user.id", "$.user.geo.country", "$.items[0].sku",
             "$.items[1]", "$.ts")
P31_PARTS = (("PROTOCOL", None), ("HOST", None), ("PATH", None),
             ("QUERY", None), ("REF", None), ("FILE", None), ("QUERY", "q"))
#: the kernels each path must launch (P29's join: murmur3, the probe and
#: the row gather of its build payload, the c_info struct's leaves)
NESTED_NEED = {
    "P29 lookups": ["murmur3_columns", "fused_probe_verify",
                    "dma_row_gather"],
    "P29 group": ["murmur3_columns", "fused_probe_verify", "dma_row_gather"],
    "P29 explode": ["murmur3_columns", "fused_probe_verify",
                    "dma_row_gather"],
    "P29 collect": ["murmur3_columns", "fused_probe_verify",
                    "dma_row_gather"],
    "P29 shuffled": ["murmur3_columns", "dma_row_gather"],
    "P29 shuffled static": ["murmur3_columns", "fused_probe_verify",
                            "dma_row_gather"],
    "P29 shuffled group": ["murmur3_columns", "dma_row_gather"],
    "P30 lambdas": ["dma_row_gather"], "P30 zorder": ["dma_row_gather"],
    "P31 json": [], "P31 url": [], "P31 hosts": []}
#: each path's input tables (nested_batches' keys)
NESTED_INPUTS = {"P29 lookups": ("orders", "customer"),
                 "P29 group": ("orders", "customer"),
                 "P29 explode": ("orders", "customer"),
                 "P29 collect": ("orders", "customer"),
                 "P29 shuffled": ("orders", "customer"),
                 "P29 shuffled static": ("orders", "customer"),
                 "P29 shuffled group": ("orders", "customer"),
                 "P30 lambdas": ("lines",), "P30 zorder": ("lines",),
                 "P31 json": ("json",), "P31 url": ("url",),
                 "P31 hosts": ("url",)}
#: P29 step 5: 16 host partitions, broadcasts off (the customers cross
#: the shuffle's frames with their struct)
P29_SHUFFLED_CONF = {"spark.rapids.sql.shuffle.partitions": "16",
                     "spark.rapids.sql.broadcastSizeThreshold": "-1"}


def nested_modules():
    """windows_modules() with the z-order expression (the maps, lambdas,
    JSON and URL come through `functions`)."""
    from spark_rapids_tpu_torch.expr import zorder
    m = windows_modules()
    m.zorder = zorder
    return m


def nested_data(dj, q3d, wd, seed=29):
    """P29's orders and customers: tpch_join_data's orders with
    q3_types_data's o_custkey, windows_data's o_totalprice, the order
    priority and status (derived from the lines, clause 4.2.3) as they
    are, o_clerk (Clerk#000000001-Clerk#000001000) drawn from `seed`, and
    the lookup key column cycling P29_LOOKUP; the customers with c_info's
    fields c_mktsegment (q3_types_data's), c_nationkey and c_acctbal (in
    cents) drawn from `seed`, a hundredth of the structs null. P30's
    lines are windows_data's with l_quantity (1-50) from seed + 1."""
    rng = np.random.default_rng(seed)
    n_orders = dj["o_orderkey"].shape[0]
    n_cust = q3d["c_custkey"].shape[0]
    clerk = rng.integers(0, len(CLERKS), n_orders).astype(np.int32)
    nation = rng.integers(0, 25, n_cust).astype(np.int32)
    acctbal = rng.integers(-99_999, 1_000_000, n_cust).astype(np.int64)
    info_valid = rng.random(n_cust) >= 0.01
    qty = np.random.default_rng(seed + 1).integers(
        1, 51, wd["l_orderkey"].shape[0]).astype(np.float64)
    return {"o_orderkey": dj["o_orderkey"], "o_custkey": q3d["o_custkey"],
            "o_totalprice": wd["o_totalprice"],
            "o_orderpriority": dj["o_orderpriority"][0],
            "o_orderstatus": dj["o_orderstatus"][0], "o_clerk": clerk,
            "o_lookup": (np.arange(n_orders) % 3).astype(np.int32),
            "c_custkey": q3d["c_custkey"],
            "c_mktsegment": q3d["c_mktsegment"][0], "c_nationkey": nation,
            "c_acctbal": acctbal, "c_info_valid": info_valid,
            "l_orderkey": wd["l_orderkey"], "l_partkey": wd["l_partkey"],
            "l_suppkey": wd["l_suppkey"], "l_quantity": qty}


def c_info_type(t):
    return t.StructType((t.StructField("c_mktsegment", t.STRING),
                         t.StructField("c_nationkey", t.INT),
                         t.StructField("c_acctbal", t.LONG)))


def c_info_column(m, nd, dev):
    """The customers' STRUCT<c_mktsegment, c_nationkey, c_acctbal>,
    built from its leaves (the card's machine has no pyarrow)."""
    import torch
    from spark_rapids_tpu_torch.columnar.column import Column, StructColumn
    t = m.t
    valid = nd["c_info_valid"]
    seg = string_column(nd["c_mktsegment"], SEGMENTS, dev)
    cap = seg.capacity
    vpad = torch.from_numpy(np.pad(valid, (0, cap - valid.shape[0]))
                            ).to(dev)
    seg.validity = vpad
    kids = [seg] + [Column.from_numpy(nd[n], dt, capacity=cap, device=dev,
                                      validity=valid)
                    for n, dt in (("c_nationkey", t.INT),
                                  ("c_acctbal", t.LONG))]
    return StructColumn(kids, vpad, c_info_type(t))


def nested_batches(m, dev, nd, cd):
    """P29-P31's batches on `dev`: the orders and customers, P30's lines,
    and P31's event documents and URLs as StringColumns."""
    t = m.t
    from spark_rapids_tpu_torch.columnar.column import StringColumn
    lookup = string_column(nd["o_lookup"], P29_LOOKUP, dev)

    def strings(values, dev):
        data, off = cd[values]
        return StringColumn.from_numpy(data, off, cd[values + "_valid"],
                                       device=dev)
    return {
        "orders": batch_of(m, dev, [
            ("o_orderkey", nd["o_orderkey"], t.LONG),
            ("o_custkey", nd["o_custkey"], t.LONG),
            ("o_totalprice", nd["o_totalprice"], t.DOUBLE),
            ("o_orderpriority", string_column(
                nd["o_orderpriority"], ORDER_PRIORITIES, dev), t.STRING),
            ("o_orderstatus", string_column(nd["o_orderstatus"],
                                            ORDER_STATUSES, dev), t.STRING),
            ("o_clerk", string_column(nd["o_clerk"], CLERKS, dev),
             t.STRING),
            ("o_lookup", lookup, t.STRING)]),
        "customer": batch_of(m, dev, [
            ("c_custkey", nd["c_custkey"], t.LONG),
            ("c_info", c_info_column(m, nd, dev), c_info_type(t))]),
        "lines": batch_of(m, dev, [
            ("l_orderkey", nd["l_orderkey"], t.LONG),
            ("l_partkey", nd["l_partkey"], t.LONG),
            ("l_suppkey", nd["l_suppkey"], t.LONG),
            ("l_quantity", nd["l_quantity"], t.DOUBLE)]),
        "json": batch_of(m, dev, [
            ("row", np.arange(cd["n"], dtype=np.int64), t.LONG),
            ("doc", strings("docs", dev), t.STRING)]),
        "url": batch_of(m, dev, [
            ("row", np.arange(cd["n"], dtype=np.int64), t.LONG),
            ("url", strings("urls", dev), t.STRING)])}


def p29_dfs(m, sess, b):
    """P29: orders x customer on the customer key with c_info as build
    payload; the map of three entries a row over the join; the lookups,
    grouped by priority; the map exploded and counted by (key, value);
    the first P29_COLLECT orders with c_info and the map, sorted."""
    F, col, lit = m.F, m.core.col, m.core.lit
    orders = sess.from_batches([b["orders"]], b["orders"].schema)
    cust = sess.from_batches([b["customer"]], b["customer"].schema)
    joined = orders.join(cust, left_on="o_custkey", right_on="c_custkey")
    mp = F.create_map(lit("priority"), col("o_orderpriority"),
                      lit("status"), col("o_orderstatus"),
                      lit("clerk"), col("o_clerk"))
    with_m = joined.select(col("o_orderkey"), col("o_totalprice"),
                           col("o_lookup"), col("c_info"), mp.alias("m"))
    lookups = with_m.select(
        col("o_orderkey"), col("o_totalprice"), col("c_info"),
        F.get_map_value("m", "priority").alias("pri"),
        F.element_at_key("m", col("o_lookup")).alias("ek"),
        F.map_contains_key("m", "clerk").alias("has_clerk"),
        F.size(F.map_keys("m")).alias("nk"),
        F.map_values("m").alias("vals"))
    last_key = int(b["orders"].columns[0].data[P29_COLLECT - 1])
    return {
        "P29 lookups": lookups,
        "P29 group": lookups.group_by("pri").agg(
            (F.count(), "n"), (F.sum("o_totalprice"), "rev")),
        "P29 explode": with_m.select(col("m")).explode("m").group_by(
            "key", "value").agg((F.count(), "n")),
        "P29 collect": with_m.filter(col("o_orderkey") <= lit(last_key))
        .select(col("o_orderkey"), col("c_info"), col("m"))
        .sort("o_orderkey")}


def p30_dfs(m, sess, b):
    """P30: the lines' quantities collected by order, the four device
    lambdas over them; the z-order codes of (l_partkey, l_suppkey) and a
    sort by them; and the two host-tier shapes, planned only."""
    F, col, lit = m.F, m.core.col, m.core.lit
    lines = sess.from_batches([b["lines"]], b["lines"].schema)
    lists = lines.group_by("l_orderkey").agg(
        (F.collect_list("l_quantity"), "qs"))
    return {
        "P30 lambdas": lists.select(
            col("l_orderkey"),
            F.transform("qs", lambda x: x * lit(2.0) + lit(1.0)).alias("t"),
            F.filter_("qs", lambda x: x > lit(25.0)).alias("f"),
            F.size(F.filter_("qs", lambda x: x > lit(25.0))).alias("nf"),
            F.exists("qs", lambda x: x > lit(49.0)).alias("e"),
            F.forall("qs", lambda x: x >= lit(1.0)).alias("fa")),
        "P30 zorder": lines.select(
            col("l_partkey"), col("l_suppkey"),
            m.zorder.InterleaveBits(col("l_partkey"), col("l_suppkey"))
            .alias("z")).sort("z"),
        "P30 aggregate": lists.select(F.aggregate(
            "qs", lit(0.0), lambda acc, x: acc + x).alias("total")),
        "P30 outer column": lists.select(F.transform(
            "qs", lambda x: x + col("l_orderkey")).alias("shifted"))}


def p31_dfs(m, sess, b):
    """P31: the five JSON paths over the event documents; the seven URL
    parts; the URLs counted by host."""
    F, col = m.F, m.core.col
    docs = sess.from_batches([b["json"]], b["json"].schema)
    urls = sess.from_batches([b["url"]], b["url"].schema)
    return {
        "P31 json": docs.select(col("row"), *[
            F.get_json_object("doc", p).alias(f"j{k}")
            for k, p in enumerate(P31_PATHS)]),
        "P31 url": urls.select(col("row"), *[
            F.parse_url("url", part, key).alias(f"u{k}")
            for k, (part, key) in enumerate(P31_PARTS)]),
        "P31 hosts": urls.select(F.parse_url("url", "HOST").alias("host"))
        .group_by("host").agg((F.count(), "n"))}


def nested_dfs(m, dev, b):
    sess = m.session.TpuSession(device=dev)
    dfs = p29_dfs(m, sess, b)
    dfs.update(p30_dfs(m, sess, b))
    dfs.update(p31_dfs(m, sess, b))
    shuffled = p29_dfs(m, m.session.TpuSession(P29_SHUFFLED_CONF,
                                               device=dev), b)
    dfs["P29 shuffled"] = shuffled["P29 collect"]
    dfs["P29 shuffled group"] = shuffled["P29 group"]
    dfs["P29 shuffled static"] = p29_dfs(m, m.session.TpuSession(
        dict(P29_SHUFFLED_CONF, **STATIC_CONF), device=dev), b)["P29 collect"]
    return dfs


# -- P31's data: event documents and URLs from one seed ----------------------

#: country names as JSON text: \uXXXX escapes, a surrogate pair, escaped
#: quotes and backslashes
P31_COUNTRIES = (
    "France", "C\\u00f4te d'Ivoire", "Espa\\u00f1a", "T\\u00fcrkiye",
    "\\ud83c\\uddef\\ud83c\\uddf5 Japan", 'The \\"Bahamas\\"',
    "Back\\\\slash", "\\u65e5\\u672c", "Brazil", "Kenya")
P31_WS = ("", " ", "  ", "\n  ", "\t")
P31_PARAMS = ("q", "lang", "ref", "page", "utm_source")
P31_VALUES = ("a+b", "x%20y", "caf%C3%A9", "1", "hello+world%21", "",
              "a%2Fb")


def _sku(rng_val):
    """An item's sku as JSON text: plain or with escaped quotes and
    backslashes (what json.dumps writes for them)."""
    k = int(rng_val)
    if k % 7 == 0:
        return f'SKU-\\"{k:05d}\\"'
    if k % 11 == 0:
        return f"SKU\\\\{k:05d}"
    return f"SKU-{k:05d}"


def clickstream_data(n=P31_ROWS, seed=31):
    """P31's columns from `seed`: event documents (a nested user object,
    1-4 item objects with decimal prices, escapes and surrogate pairs,
    whitespace, about 1 % structurally malformed, 0.5 % null) and URLs
    (hosts Zipf-like over P31_DOMAINS domains; 1 % userinfo, 1 % IPv6, 5 %
    a port; 1-5 path segments; 0-4 query pairs with %XX and '+'; 10 % a
    fragment; 0.5 % null). Rows past P31_POOL draw uniformly from the
    first P31_POOL distinct documents and URLs (`idx`); each column as
    (bytes, offsets) with validity, and the pools as Python lists."""
    pool = min(n, P31_POOL)
    rng = np.random.default_rng(seed)
    idx = np.arange(n) if n == pool else rng.integers(0, pool, n)
    n = pool
    uid = rng.integers(1, 10_000_000, n)
    country = rng.integers(0, len(P31_COUNTRIES), n)
    n_items = rng.integers(1, 5, n)
    sku = rng.integers(1, 100_000, (n, 4))
    cents = rng.integers(100, 100_000, (n, 4))
    qty = rng.integers(1, 10, (n, 4))
    ts = 1_700_000_000_000 + rng.integers(0, 10**9, n)
    ws = rng.integers(0, len(P31_WS), (n, 4))
    bad = rng.random(n)
    null_doc = rng.random(n) < 0.005
    docs = []
    for i in range(n):
        w = [P31_WS[k] for k in ws[i]]
        items = ",".join(
            f'{{"sku":{w[0]}"{_sku(sku[i, j])}",{w[1]}"qty":{qty[i, j]},'
            f'"price":{w[2]}{cents[i, j] // 100}.{cents[i, j] % 100:02d}}}'
            for j in range(n_items[i]))
        doc = (f'{w[3]}{{"event":"view",{w[0]}"user":{{"id":{uid[i]},'
               f'"name":"u{uid[i] % 977}",{w[1]}"geo":{{"country":'
               f'{w[2]}"{P31_COUNTRIES[country[i]]}","city":"c'
               f'{uid[i] % 89}"}}}},"items":{w[1]}[{items}],'
               f'{w[0]}"ts":{ts[i]}}}{w[3]}')
        if bad[i] < 0.005:
            doc = doc.rstrip()[:-1]                # unbalanced
        elif bad[i] < 0.01:
            doc = doc.replace('"sku":', '"sku:', 1)  # unterminated
        docs.append(None if null_doc[i] else doc)

    host_rank = np.minimum(rng.zipf(1.3, n), P31_DOMAINS) - 1
    kind = rng.random((n, 4))
    n_seg = rng.integers(1, 6, n)
    seg = rng.integers(0, 1 << 20, (n, 5))
    n_par = rng.integers(0, 5, n)
    par = rng.integers(0, len(P31_PARAMS), (n, 4))
    val = rng.integers(0, len(P31_VALUES), (n, 4))
    null_url = rng.random(n) < 0.005
    urls = []
    for i in range(n):
        h = int(host_rank[i])
        host = (f"[2001:db8::{h:x}]" if kind[i, 1] < 0.01 else
                f"{'WWW' if h % 5 == 0 else 'www'}.site{h}.example.com")
        auth = ("user:pw@" if kind[i, 0] < 0.01 else "") + host \
            + (f":{8000 + h % 100}" if kind[i, 2] < 0.05 else "")
        path = "".join(f"/p{seg[i, j]:x}" for j in range(n_seg[i]))
        query = "&".join(f"{P31_PARAMS[par[i, j]]}={P31_VALUES[val[i, j]]}"
                         for j in range(n_par[i]))
        url = f"{'https' if h % 3 else 'http'}://{auth}{path}" \
            + (f"?{query}" if query else "") \
            + (f"#sec{h % 7}" if kind[i, 3] < 0.1 else "")
        urls.append(None if null_url[i] else url)
    out = {"n": idx.shape[0], "idx": idx, "docs_pool": docs,
           "urls_pool": urls}
    for name, vals in (("docs", docs), ("urls", urls)):
        out[name], out[name + "_valid"] = pool_buffers(vals, idx)
        out[name + "_list"] = [vals[i] for i in idx]
    return out


def pool_buffers(pool, idx):
    """((bytes, offsets), validity) of the column whose row r is
    pool[idx[r]] (a str or None)."""
    enc = [b"" if v is None else v.encode("utf-8") for v in pool]
    lens = np.fromiter(map(len, enc), np.int64, len(enc))[idx]
    off = np.zeros(idx.shape[0] + 1, np.int32)
    np.cumsum(lens, out=off[1:])
    data = np.frombuffer(b"".join([enc[i] for i in idx]), np.uint8)
    valid = np.array([v is not None for v in pool], bool)[idx]
    return (data, off), valid


def word_buffers(codes, words, valid):
    """((bytes, offsets), validity) of the column whose row r is
    words[codes[r]], NULL where not valid[r]."""
    enc = [w.encode("utf-8") for w in words]
    lens = np.array([len(b) for b in enc], np.int64)
    width = max(int(lens.max()), 1)
    mat = np.zeros((len(enc), width), np.uint8)
    for k, b in enumerate(enc):
        mat[k, :len(b)] = np.frombuffer(b, np.uint8)
    row_lens = np.where(valid, lens[codes], 0)
    off = np.zeros(codes.shape[0] + 1, np.int32)
    np.cumsum(row_lens, out=off[1:])
    keep = np.arange(width)[None, :] < row_lens[:, None]
    return (mat[codes][keep], off), np.asarray(valid, bool)




class _RawNumber(str):
    """A JSON number kept as its source text (the device's rule)."""


def _render_compact(v):
    """A JSON value as the device renders a container: compact, strings
    as json.dumps writes them, numbers raw."""
    import json
    if isinstance(v, _RawNumber):
        return str(v)
    if isinstance(v, str):
        return json.dumps(v, ensure_ascii=False)
    if isinstance(v, dict):
        return "{" + ",".join(json.dumps(k, ensure_ascii=False) + ":"
                              + _render_compact(x)
                              for k, x in v.items()) + "}"
    if isinstance(v, list):
        return "[" + ",".join(_render_compact(x) for x in v) + "]"
    return json.dumps(v)


def json_oracle(docs):
    """get_json_object of P31_PATHS by Python's json, following the
    device's rules (ops/json_device.py): scalar numbers as their raw
    text, containers compact, strings decoded, 'null' -> None, and a
    document json rejects -> None (P31's malformed documents are
    structural)."""
    import json
    from spark_rapids_tpu_torch.expr.jsonexprs import parse_json_path
    steps = [parse_json_path(p) for p in P31_PATHS]
    out = [[] for _ in P31_PATHS]
    for d in docs:
        try:
            doc = None if d is None else json.loads(
                d, parse_int=_RawNumber, parse_float=_RawNumber)
        except ValueError:
            doc = None
        for k, st in enumerate(steps):
            v = doc
            for s in st:
                if isinstance(s, int):
                    v = v[s] if isinstance(v, list) and s < len(v) else None
                else:
                    v = v.get(s) if isinstance(v, dict) else None
            out[k].append(None if v is None else
                          v if isinstance(v, str)
                          and not isinstance(v, _RawNumber)
                          else _render_compact(v))
    return out


def url_oracle(urls):
    """parse_url of P31_PARTS by urllib.parse, as the JAX package's host
    tier takes them (expr/urlexprs.py)."""
    from urllib.parse import parse_qs, urlparse
    out = [[] for _ in P31_PARTS]
    for u in urls:
        p = None if u is None else urlparse(u)
        for k, (part, key) in enumerate(P31_PARTS):
            if p is None:
                v = None
            elif part == "PROTOCOL":
                v = p.scheme or None
            elif part == "HOST":
                v = p.hostname
            elif part == "PATH":
                v = p.path
            elif part == "REF":
                v = p.fragment or None
            elif part == "FILE":
                v = p.path + ("?" + p.query if p.query else "")
            elif key is None:
                v = p.query or None
            else:
                vals = parse_qs(p.query, keep_blank_values=True).get(key)
                v = vals[0] if vals else None
            out[k].append(v)
    return out


# -- P29-P31's oracles, checked on the output batches -------------------------

def _check_strings(label, col, n, want):
    """A host string column's first n rows against the expected
    ((bytes, offsets), validity) (`pool_buffers`, `word_buffers`) or a
    list of str/None: validity, lengths and bytes, compared as arrays."""
    if isinstance(want, list):
        want = pool_buffers(want, np.arange(len(want)))
    (data, off), wvalid = want
    valid = col.validity[:n].numpy()
    _equal(f"{label} validity", valid, wvalid)
    got_off = col.offsets[: n + 1].numpy().astype(np.int64)
    _equal(f"{label} lengths", np.diff(got_off), np.diff(off).astype(
        np.int64))
    total = int(off[-1])
    _equal(f"{label} bytes", col.data[int(got_off[0]):
                                     int(got_off[0]) + total].numpy(), data)


def _host_batch(out):
    """The one output batch of a path on the host."""
    from spark_rapids_tpu_torch.columnar.transfer import fetch_batch_host
    if len(out) != 1:
        raise AssertionError(f"{len(out)} output batches, expected one")
    return fetch_batch_host(out[0])


def p29_oracles(nd):
    """Per order (in o_orderkey order): its lookups, and the group and
    explode counts."""
    prio, status, clerk = (nd[k] for k in ("o_orderpriority",
                                           "o_orderstatus", "o_clerk"))
    price = nd["o_totalprice"]
    cust = nd["o_custkey"] - 1
    groups = sorted(((ORDER_PRIORITIES[p], int(c), float(s)) for p, c, s in
                     zip(range(5), np.bincount(prio, minlength=5),
                         np.bincount(prio, weights=price, minlength=5))),
                    key=repr)
    explode = [("priority", ORDER_PRIORITIES[k], int(c)) for k, c in
               enumerate(np.bincount(prio, minlength=5)) if c]
    explode += [("status", ORDER_STATUSES[k], int(c)) for k, c in
                enumerate(np.bincount(status, minlength=3)) if c]
    explode += [("clerk", CLERKS[k], int(c)) for k, c in
                enumerate(np.bincount(clerk, minlength=len(CLERKS))) if c]
    return {"groups": groups, "explode": sorted(explode), "cust": cust}


def _c_info_rows(nd, cust):
    return [{"c_mktsegment": SEGMENTS[nd["c_mktsegment"][c]],
             "c_nationkey": int(nd["c_nationkey"][c]),
             "c_acctbal": int(nd["c_acctbal"][c])}
            if nd["c_info_valid"][c] else None for c in cust]


def p29_lookups_check(nd):
    prio, status, clerk, lookup = (nd[k] for k in (
        "o_orderpriority", "o_orderstatus", "o_clerk", "o_lookup"))

    def check(out, label):
        cols, n = _host_batch(out)
        okey = cols[0].data[:n].numpy()
        i = np.searchsorted(nd["o_orderkey"], okey)
        _equal(f"{label} keys", nd["o_orderkey"][i], okey)
        _equal(f"{label} rows", np.sort(i), np.arange(i.shape[0]))
        _equal(f"{label} price", cols[1].data[:n].numpy(),
               nd["o_totalprice"][i])
        cust = nd["o_custkey"][i] - 1
        info = cols[2]
        _equal(f"{label} c_info validity", info.validity[:n].numpy(),
               nd["c_info_valid"][cust])
        ok = nd["c_info_valid"][cust]
        _check_strings(f"{label} c_info.c_mktsegment", info.children[0], n,
                       word_buffers(nd["c_mktsegment"][cust], SEGMENTS, ok))
        for k, name in ((1, "c_nationkey"), (2, "c_acctbal")):
            _equal(f"{label} c_info.{name}",
                   info.children[k].data[:n].numpy()[ok], nd[name][cust][ok])
        _check_strings(f"{label} pri", cols[3], n, word_buffers(
            prio[i], ORDER_PRIORITIES, np.ones(n, bool)))
        # element_at_key: the status, the clerk, or NULL for 'none'
        ek = np.where(lookup[i] == 0, status[i],
                      len(ORDER_STATUSES) + clerk[i])
        _check_strings(f"{label} element_at_key", cols[4], n, word_buffers(
            ek, ORDER_STATUSES + CLERKS, lookup[i] != 2))
        _equal(f"{label} map_contains_key", cols[5].data[:n].numpy(),
               np.ones(n, bool))
        _equal(f"{label} size(map_keys)", cols[6].data[:n].numpy(),
               np.full(n, 3, np.int32))
        vals = cols[7]
        _equal(f"{label} map_values offsets",
               vals.offsets[: n + 1].numpy(), np.arange(n + 1) * 3)
        words = ORDER_PRIORITIES + ORDER_STATUSES + CLERKS
        entries = np.stack([prio[i], len(ORDER_PRIORITIES) + status[i],
                            len(ORDER_PRIORITIES) + len(ORDER_STATUSES)
                            + clerk[i]], axis=1).reshape(-1)
        _check_strings(f"{label} map_values", vals.child, 3 * n,
                       word_buffers(entries, words, np.ones(3 * n, bool)))
    return check


def p29_collect_check(nd):
    okey = nd["o_orderkey"][:P29_COLLECT]
    cust = nd["o_custkey"][:P29_COLLECT] - 1
    want = [(int(k), info, {"priority": ORDER_PRIORITIES[p],
                            "status": ORDER_STATUSES[s], "clerk": CLERKS[c]})
            for k, info, p, s, c in zip(
                okey, _c_info_rows(nd, cust),
                nd["o_orderpriority"][:P29_COLLECT],
                nd["o_orderstatus"][:P29_COLLECT], nd["o_clerk"][:P29_COLLECT])]
    return exact_rows(want)


def p30_oracles(nd):
    """Per order (in l_orderkey order): its quantities in line order, and
    the lambdas' results."""
    okey = nd["l_orderkey"]
    order = np.lexsort((np.arange(okey.shape[0]), okey))
    ok, q = okey[order], nd["l_quantity"][order]
    start, _ = _groups([ok])
    starts = np.nonzero(start)[0]
    counts = np.diff(np.r_[starts, ok.shape[0]])
    row = np.repeat(np.arange(starts.shape[0]), counts)
    keep = q > 25.0
    pk, sk = nd["l_partkey"], nd["l_suppkey"]
    z = zorder_codes([pk, sk])
    zperm = np.argsort(z, kind="stable")
    return {"keys": ok[starts], "counts": counts, "q": q, "keep": keep,
            "nf": np.bincount(row, weights=keep, minlength=starts.shape[0]),
            "e": np.bincount(row, weights=q > 49.0,
                             minlength=starts.shape[0]) > 0,
            "fa": np.bincount(row, weights=q < 1.0,
                              minlength=starts.shape[0]) == 0,
            "row": row, "z": z[zperm], "pk": pk[zperm], "sk": sk[zperm]}


def zorder_codes(keys):
    """InterleaveBits' rule (expr/zorder.py) in numpy uint64: bit b of
    the code from the top is bit 63 - b // n of key b % n's rank (its sign
    bit flipped), the code's top bit flipped. Each key's top 64 // n bits
    spread to every n-th bit a byte at a time by a table."""
    n = len(keys)
    bits = 64 // n
    spread = np.zeros(256, np.uint64)
    for v in range(256):
        spread[v] = sum(((v >> i) & 1) << (i * n) for i in range(8))
    out = np.zeros(keys[0].shape[0], np.uint64)
    for j, k in enumerate(keys):
        rank = k.astype(np.int64).view(np.uint64) ^ np.uint64(1 << 63)
        top = rank >> np.uint64(64 - bits)
        for c in range(0, bits, 8):
            byte = (top >> np.uint64(c)) & np.uint64(0xFF)
            out |= spread[byte.astype(np.intp)] \
                << np.uint64(c * n + n - 1 - j)
    return (out ^ np.uint64(1 << 63)).view(np.int64)


def p30_lambdas_check(w):
    def check(out, label):
        key, t, f, nf, e, fa = fetch_columns(out)
        _equal(f"{label} keys", key[0], w["keys"])
        offs = np.r_[0, np.cumsum(w["counts"])]
        _equal(f"{label} transform offsets", t[0], offs)
        _equal(f"{label} transform", t[1], w["q"] * 2.0 + 1.0)
        _equal(f"{label} filter offsets", f[0],
               np.r_[0, np.cumsum(w["nf"])].astype(np.int64))
        _equal(f"{label} filter", f[1], w["q"][w["keep"]])
        _equal(f"{label} size(filter)", nf[0], w["nf"].astype(np.int32))
        _equal(f"{label} exists", e[0], w["e"])
        _equal(f"{label} forall", fa[0], w["fa"])
    return check


def p30_zorder_check(w):
    def check(out, label):
        pk, sk, z = fetch_columns(out)
        _equal(f"{label} codes", z[0], w["z"])
        _equal(f"{label} l_partkey", pk[0], w["pk"])
        _equal(f"{label} l_suppkey", sk[0], w["sk"])
    return check


def p31_check(want, label_of):
    def check(out, label):
        cols, n = _host_batch(out)
        _equal(f"{label} rows", cols[0].data[:n].numpy(), np.arange(n))
        for k, w in enumerate(want):
            _check_strings(f"{label} {label_of(k)}", cols[k + 1], n, w)
    return check


def nested_inputs(dev, dj, q3d, d19):
    """P29-P31's batches on `dev` and their checks."""
    m = nested_modules()
    wd = windows_data(dj, q3d)
    nd = nested_data(dj, q3d, wd)
    cd = clickstream_data(n=min(P31_ROWS, dj["o_orderkey"].shape[0]))
    b = nested_batches(m, dev, nd, cd)
    w29, w30 = p29_oracles(nd), p30_oracles(nd)
    idx = cd["idx"]
    jw = [pool_buffers(w, idx) for w in json_oracle(cd["docs_pool"])]
    uw_pool = url_oracle(cd["urls_pool"])
    uw = [pool_buffers(w, idx) for w in uw_pool]
    hosts = {}
    for i in idx:
        h = uw_pool[1][i]
        hosts[h] = hosts.get(h, 0) + 1
    checks = {
        "P29 lookups": p29_lookups_check(nd),
        "P29 group": lambda rows, label: check_rows(
            sorted(rows, key=repr), w29["groups"], label),
        "P29 explode": sorted_rows(w29["explode"]),
        "P29 collect": p29_collect_check(nd),
        "P29 shuffled": p29_collect_check(nd),
        "P29 shuffled static": p29_collect_check(nd),
        "P29 shuffled group": lambda rows, label: check_rows(
            sorted(rows, key=repr), w29["groups"], label),
        "P30 lambdas": p30_lambdas_check(w30),
        "P30 zorder": p30_zorder_check(w30),
        "P31 json": p31_check(jw, lambda k: P31_PATHS[k]),
        "P31 url": p31_check(uw, lambda k: "/".join(
            x for x in P31_PARTS[k] if x)),
        "P31 hosts": sorted_rows(list(hosts.items()))}
    return m, b, checks


#: the paths whose results collect() reads (small outputs, or rows)
NESTED_COLLECTED = ("P29 group", "P29 explode", "P29 collect",
                    "P29 shuffled", "P29 shuffled static",
                    "P29 shuffled group", "P31 hosts")
#: the host-tier shapes of P30, planned only (the row engine would take
#: minutes over 1,500,000 lists of quantities)
NESTED_PLANNED_ONLY = ("P30 aggregate", "P30 outer column")


def nested_bound(b, label):
    """(bytes, ms): one read of the path's input columns at capacity at
    PEAK_BYTES_PER_S (as input_bound)."""
    nbytes = sum(x.numel() * x.element_size() for t in NESTED_INPUTS[label]
                 for c in b[t].columns for x in c.leaves())
    return nbytes, nbytes / PEAK_BYTES_PER_S * 1e3


def nested_tree(m, dev, b, label):
    """A fresh planned tree of one of P29-P31 (phase 2 captures its
    kernels' inputs from a run of it)."""
    return planned(m, nested_dfs(m, dev, b)[label])[0]


def shuffle_carried(tree):
    """The types that cross a host shuffle's frames in a planned tree:
    the names of the struct and map fields of every exchange's output."""
    out = []
    for node in exec_nodes(tree):
        if type(node).__name__ != "HostShuffleExchangeExec":
            continue
        for f in node.output_schema.fields:
            name = type(f.data_type).__name__
            if name in ("StructType", "MapType"):
                out.append(f"{f.name}:{f.data_type.simple_name()}")
    return out


def drive_nested_paths(dev, m, b, checks):
    """Phase 3h: P29 (the join with a struct payload, the map's lookups,
    group-by, explode and collect, and the collect over 16 host shuffle
    partitions, with its static twin under STATIC_CONF, untimed), P30 (the lambdas and the z-order sort; the host-tier
    shapes planned only, their tag-off reasons printed) and P31 (the
    JSON paths, the URL parts, the count by host; the peak device memory
    of each). Returns (counts, records, runs, trees)."""
    import torch
    dfs = nested_dfs(m, dev, b)
    counts, recs, runs, trees = {}, {}, {}, {}
    for label in ("P29 lookups", "P29 group", "P29 explode", "P29 collect",
                  "P29 shuffled", "P29 shuffled static",
                  "P29 shuffled group", "P30 lambdas", "P30 zorder",
                  "P31 json", "P31 url", "P31 hosts"):
        tree, tag_ms, convert_ms = planned(m, dfs[label])
        need = NESTED_NEED[label]
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, cnt, reads = drive_batches(label, tree, need)
        peak = torch.cuda.max_memory_allocated() - base
        if label in NESTED_COLLECTED:
            checks[label]([r for x in out for r in x.to_pylist()], label)
        else:
            checks[label](out, label)
        rows = sum(x.num_rows_host for x in out)
        del out
        check_idle(label)
        rec = {"plan_ms": tag_ms + convert_ms, "launches": cnt,
               "host_reads": reads, "rows": rows, "peak_bytes": peak,
               **window_metrics(tree)}
        rec["input_bytes"], rec["bound_ms"] = nested_bound(b, label)
        carried = shuffle_carried(tree)
        if label.startswith("P29 shuffled"):
            rec["shuffle_carries"] = carried
        counts[label], recs[label], trees[label] = cnt, rec, tree
        small = label in NESTED_COLLECTED
        if label.endswith("static") and cnt["fused_probe_verify"] < 2:
            raise AssertionError(f"{label}: launches {cnt}, one pass")
        if not label.endswith("static"):
            runs[label] = ((lambda t=tree: t.collect()) if small else
                           (lambda t=tree: list(t.execute())), rec["rows"])
        print(f"{label}: {rows} rows equal to the oracle; launches {cnt}; "
              f"host reads {reads}; peak device memory {peak} bytes above "
              f"the inputs; reads {rec['input_bytes']} bytes at capacity, "
              f"bound {rec['bound_ms']:.4f} ms"
              + (f"; through the shuffle's frames: {carried}"
                 if label.startswith("P29 shuffled") else ""))
    for label in NESTED_PLANNED_ONLY:
        planned(m, dfs[label])
        text = dfs[label].explain()
        if not text.startswith("~ Project"):
            raise AssertionError(f"{label}: not placed on the host row "
                                 f"engine:\n{text}")
        reason = [ln.strip() for ln in text.splitlines()
                  if "host-tier expression" in ln]
        recs[label] = {"host_placement": reason[-1]}
        print(f"{label}: planned only, on the host row engine: "
              f"{reason[-1]}")
    return counts, recs, runs, trees


def compare_nested_paths(dev, m, b):
    """Phase 2 at P29-P31's own inputs: every row gather of a run of each
    path that makes one (the join's build payload with the struct's
    leaves, the sorts, the group-bys, the exchanges' reorders; P31 makes
    none) and every dictionary take, held exactly to the plain
    versions."""
    shapes = {}
    for label in ("P29 lookups", "P29 explode", "P29 collect",
                  "P29 shuffled", "P29 shuffled static", "P30 lambdas",
                  "P30 zorder"):
        tree = nested_tree(m, dev, b, label)
        gathers = capture_row_gathers(tree)
        shapes[label] = compare_row_gathers(label, gathers)
        print(f"compare {label} main-path row gathers: "
              f"{'; '.join(shapes[label])}; exact")
        del gathers
        takes = capture_dict_gathers(nested_tree(m, dev, b, label))
        if takes:
            print(f"compare {label} main-path dictionary gathers: "
                  f"{'; '.join(compare_dict_takes(label, takes))}; exact")
    return shapes


def nested_gather_shapes(dev, m, b):
    """Phase 4: dma_row_gather at every distinct shape of P29's join and
    P30's sort and group-by (time_gather_call: the kernel, the plain
    version, the bound and index_select)."""
    out = []
    for label in ("P29 lookups", "P30 lambdas", "P30 zorder"):
        seen = set()
        for call in capture_row_gathers(nested_tree(m, dev, b, label)):
            site, plan, imat, fmat, idx = call
            key = (site, idx.shape[0], imat.shape, None if fmat is None
                   else fmat.shape)
            if key in seen:
                continue
            seen.add(key)
            out.append(time_gather_call(label, *call))
    return out


def time_nested_paths(runs):
    """Phase 4: P29-P31 in turns (the order reversed every other round),
    P_NESTED_ITERS runs each, one synchronisation a run; each run's row
    count held to the counted run's."""
    import torch
    out = {label: [] for label in runs}
    for i in range(P_NESTED_ITERS):
        for label in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
            run, rows = runs[label]
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            out[label].append((time.perf_counter() - t0) * 1e3)
            got = len(res) if label in NESTED_COLLECTED \
                else sum(x.num_rows_host for x in res)
            if got != rows:
                raise AssertionError(f"{label} timed: {got} rows != {rows}")
            del res
    for label, ms in out.items():
        print(f"{label} ms per run ({P_NESTED_ITERS} runs, in turns): "
              f"{[round(x, 3) for x in ms]}")
    return out


# -- slice 14: the adaptive join, the host row engine, Python UDFs and the
# -- cost model (phase 3i) ---------------------------------------------------

#: P32 demote's broadcastSizeThreshold: past every measured side, so that
#: the adaptive cap (adaptive.autoBroadcastMaxBytes, 64 MB by default)
#: decides the broadcast
P32_DEMOTE_THRESHOLD = 1 << 30
#: P32 sub's runtime shuffle.partitions (the sub-partitioned join's k)
P32_SUB_PARTS = 16
P_ADAPTIVE_ITERS = 3     # phase 4's timed runs of P32 (and twins) and P33
#: P33 host's month of o_orderdate (about 18,000 of the 1,500,000 orders)
P33_FROM, P33_TO = datetime.date(1995, 3, 1), datetime.date(1995, 4, 1)
P33_PRIORITY, P33_PATTERN, P33_JOIN = "1-URGENT", "#0+", "-"
P33_COST_ROWS = 1 << 16  # rows of the row engine's and transitions' costs
P33_COST_REPS = 15       # runs of each cost measurement (the median kept)
P33_CBO_BELOW = 31       # P33 cbo keeps the rows with k * 3 + 1 below it
#: the kernels each path must launch
ADAPTIVE_NEED = {"P32 Q21": ["dict_gather"] + Q_NEED, "P32 P19": Q_NEED,
                 "P32 P20 sort": ["dma_row_gather"],
                 "P32 sub": ["dict_gather"] + Q_NEED,
                 "P32 demote": ["dict_gather"] + Q_NEED}


def p33_discount(price, key):
    """P33 udf's function: a branch on the order key, arithmetic on the
    price."""
    if key % 7 == 0:
        return price * 0.9
    return price + 1.0


def adaptive_nodes(tree):
    return [n for n in exec_nodes(tree)
            if type(n).__name__ == "AdaptiveJoinExec"]


def adaptive_choices(tree):
    """Each AdaptiveJoinExec's last decision: (join type, choice, measured
    left bytes or None, measured right bytes)."""
    return [(n.join_type, n._choice, *n._measured)
            for n in adaptive_nodes(tree)]


def built_bytes(choices):
    """The largest side an adaptive join built."""
    return max(r if c == "build_right" or l is None else
               (l if c == "build_left" else min(l, r))
               for _, c, l, r in choices)


def with_runtime_conf(tree, settings):
    """`tree` with its adaptive joins deciding under `settings` added to
    their conf. At plan time shuffle.partitions > 1 makes the planner of
    either package take the static shuffled join (`_join_strategy`:
    "shuffled" precedes "adaptive"), so P32 sub gives its partitions to
    the planned adaptive nodes at run time."""
    from spark_rapids_tpu_torch.config import RapidsConf
    for n in adaptive_nodes(tree):
        n._conf = RapidsConf(dict(n._conf._settings, **settings))
    return tree


def adaptive_dfs(sm, tm, dev, jb, tb, settings=None):
    """P32's queries planned from DataFrames at the default confs (with
    `settings`): Q21 (P13), Q3 on the true types (P19) and P20's sort by
    (o_orderdate, o_orderkey); and their twins as phases 3d and 3e plan
    them (broadcasts off; the sort over P_PARTS partitions). Each takes
    its twin's exact aggregate (Q3_CONF), so P32 and its twin differ by
    the broadcast threshold alone."""
    settings = dict(Q3_CONF, **(settings or {}))
    sess = sm.session.TpuSession(settings, dev)
    tsess = tm.session.TpuSession(settings, dev)
    return {
        "P32 Q21": q21_df(sm, sess, jb),
        "P32 P19": q3_types_df(tm, tsess, tb["q3"]),
        "P32 P20 sort": p20_dfs(tm, tsess, tsess, tb["l20"],
                                tb["o20"])["P20 sort"],
        "P13 twin": q21_df(sm, sm.session.TpuSession(Q21_CONF, dev), jb),
        "P19 twin": q3_types_df(tm, tm.session.TpuSession(P19_CONF, dev),
                                tb["q3"]),
        "P20 sort twin": types_dfs(tm, dev, tb)["P20 sort"]}


def p33_orders(m, dev, dj, q3d):
    """P33's orders: P29's 1,500,000 (nested_data: o_orderpriority,
    o_clerk, o_totalprice) with their o_orderdate."""
    nd = nested_data(dj, q3d, windows_data(dj, q3d))
    t = m.t
    b = batch_of(m, dev, [
        ("o_orderkey", nd["o_orderkey"], t.LONG),
        ("o_orderdate", dj["o_orderdate"], t.DATE),
        ("o_orderpriority", string_column(nd["o_orderpriority"],
                                          ORDER_PRIORITIES, dev), t.STRING),
        ("o_clerk", string_column(nd["o_clerk"], CLERKS, dev), t.STRING),
        ("o_totalprice", nd["o_totalprice"], t.DOUBLE)])
    return b, nd


def _edit_distance(a, b):
    """Levenshtein's distance by the full (len(a)+1) x (len(b)+1) table,
    the oracle of P33 host."""
    d = [[i + j if i * j == 0 else 0 for j in range(len(b) + 1)]
         for i in range(len(a) + 1)]
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            d[i][j] = min(d[i - 1][j] + 1, d[i][j - 1] + 1,
                          d[i - 1][j - 1] + (a[i - 1] != b[j - 1]))
    return d[-1][-1]


def p33_host_df(m, sess, orders):
    """P33 host: a device filter keeps a month of o_orderdate; a Project
    on the host row engine computes levenshtein(o_orderpriority,
    '1-URGENT'), split(o_clerk, '#0+') (a regex split) and array_join of
    the split; a device aggregate counts each priority's orders, sums
    their distance and keeps the largest joined clerk."""
    col, lit, pr, F = m.core.col, m.core.lit, m.pred, m.F
    o = sess.from_batches([orders], orders.schema)
    month = o.filter(pr.And(
        pr.GreaterThanOrEqual(col("o_orderdate"), date_lit(m, P33_FROM)),
        pr.LessThan(col("o_orderdate"), date_lit(m, P33_TO))))
    host = month.select(
        col("o_orderpriority"),
        F.levenshtein("o_orderpriority", lit(P33_PRIORITY)).alias("dist"),
        F.array_join(F.split("o_clerk", P33_PATTERN), P33_JOIN)
        .alias("clerk"))
    return host.group_by("o_orderpriority").agg(
        (F.count(), "n"), (F.sum("dist"), "dist"),
        (F.max("clerk"), "clerk")).sort("o_orderpriority")


def p33_host_oracle(dj, nd):
    keep = (dj["o_orderdate"] >= days(P33_FROM)) \
        & (dj["o_orderdate"] < days(P33_TO))
    groups = {}
    for p, c in zip(nd["o_orderpriority"][keep], nd["o_clerk"][keep]):
        pri = ORDER_PRIORITIES[p]
        joined = P33_JOIN.join(re.split(P33_PATTERN, CLERKS[c]))
        n, dist, top = groups.get(pri, (0, 0, ""))
        groups[pri] = (n + 1, dist + _edit_distance(pri, P33_PRIORITY),
                       max(top, joined))
    return [(k, *v) for k, v in sorted(groups.items())], int(keep.sum())


def p33_udf_df(m, dev, orders, compiled):
    """P33 udf: p33_discount over all the orders' (o_totalprice,
    o_orderkey), as the host round trip or compiled."""
    col = m.core.col
    sess = m.session.TpuSession(
        {"spark.rapids.sql.udfCompiler.enabled": str(compiled).lower()}, dev)
    fn = m.F.udf(p33_discount, return_type=m.t.DOUBLE)
    return sess.from_batches([orders], orders.schema).select(
        col("o_orderkey"), fn("o_totalprice", "o_orderkey").alias("adj"))


def p33_cbo_dfs(m, dev, jb):
    """P33 cbo under optimizer.enabled: a Project and Filter over the 25
    nations (the cost model must place them on the host) and over the
    6,001,215 lines (on the device)."""
    col, lit, pr = m.core.col, m.core.lit, m.pred
    sess = m.session.TpuSession({"spark.rapids.sql.optimizer.enabled":
                                 "true"}, dev)

    def q(table, key):
        df = sess.from_batches([jb[table]], jb[table].schema)
        return df.select(col(key), (col(key) * lit(3) + lit(1)).alias("k3")) \
            .filter(pr.LessThan(col("k3"), lit(P33_CBO_BELOW)))
    return {"P33 cbo nations": q("nation", "n_nationkey"),
            "P33 cbo lines": q("lineitem", "l_orderkey")}


def udf_round_trips():
    """expr/udf.counters(): the host round trips and their rows."""
    from spark_rapids_tpu_torch.expr import udf
    return udf.counters()


def check_udf_columns(out, okey, price, label):
    cols = fetch_columns(out)
    want = np.where(okey % 7 == 0, price * 0.9, price + 1.0)
    if not (np.array_equal(cols[0][0], okey) and cols[1][1].all()
            and np.array_equal(cols[1][0], want)):
        raise AssertionError(f"{label}: != numpy")
    return cols[1][0]


class _RowSource:
    """A row-engine input of prepared host rows (the cost measurement's
    leaf)."""

    def __init__(self, rows, schema, device):
        self._rows, self.output_schema, self.device = rows, schema, device
        self.children = []

    def rows(self):
        return iter(self._rows)


def _median_us(fn, reps=P33_COST_REPS):
    import torch
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(ts))


def measure_cost_constants(m, dev, jb, orders):
    """The cost model's four constants on this card (plan/cost.py), each
    the median of P33_COST_REPS runs: the launch cost of a small device
    Project (ProjectExec of `k * 3 + 1` over the 25 nations, to the
    synchronisation), the device cost per row of a large one (the same
    over the 6,001,215 lines, less the small one, per row), the row
    engine's cost per row (HostProjectExec of the same expression over
    P33_COST_ROWS prepared rows) and the transitions' per row, each way
    (ColumnarToRowExec over a P33_COST_ROWS-row batch; RowToColumnarExec
    of its rows)."""
    from spark_rapids_tpu_torch.exec.basic import InMemoryScanExec, ProjectExec
    from spark_rapids_tpu_torch.exec.fallback import (
        ColumnarToRowExec, HostProjectExec, RowToColumnarExec)
    col, lit, t = m.core.col, m.core.lit, m.t

    def project(batch, key):
        return ProjectExec([(col(key) * lit(3) + lit(1)).alias("k3")],
                           InMemoryScanExec([batch], batch.schema))
    small, large = jb["nation"], jb["lineitem"]
    dispatch = _median_us(lambda: list(project(small, "n_nationkey")
                                       .execute()))
    big = _median_us(lambda: list(project(large, "l_orderkey").execute()))
    n_large = large.num_rows_host
    rows_batch = batch_of(m, dev, [("k", orders.columns[0].data[
        :P33_COST_ROWS].cpu().numpy(), t.LONG)])
    scan = InMemoryScanExec([rows_batch], rows_batch.schema)
    down = _median_us(lambda: list(ColumnarToRowExec(scan).rows()))
    rows = list(ColumnarToRowExec(scan).rows())
    src = _RowSource(rows, rows_batch.schema, dev)
    host = _median_us(lambda: list(HostProjectExec(
        [(col("k") * lit(3) + lit(1)).alias("k3")], src).rows()))
    up = _median_us(lambda: list(RowToColumnarExec(
        src, rows_batch.schema).execute()))
    n = P33_COST_ROWS
    return {"DEVICE_DISPATCH_US": dispatch,
            "DEVICE_ROW_US": max(big - dispatch, 0.0) / n_large,
            "HOST_ROW_US": host / n,
            "TRANSITION_ROW_US": (down + up) / 2 / n,
            "transition_down_row_us": down / n,
            "transition_up_row_us": up / n,
            "large_project_us": big, "rows": n, "large_rows": n_large}


def sub_partitions(choices, threshold):
    """Each subpartition choice's k, as AdaptiveJoinExec sizes it from
    the side it builds (the right side unless an inner join without a
    condition: `built_bytes`)."""
    return [min(256, max(P32_SUB_PARTS, -(-built_bytes([c]) // threshold)))
            for c in choices if c[1] == "subpartition"]


def drive_adaptive(label, tree, need, check, exact=False):
    """One phase 3i path, counted (drive_batches; with `exact`, on the
    exact tier, as collect() re-runs a plan whose flag tripped), its rows
    held with `check`; the catalog empty and no permit held after.
    Returns a record with each adaptive join's decision."""
    from spark_rapids_tpu_torch.exec import adaptive
    from spark_rapids_tpu_torch.exec.speculation import force_exact
    before = adaptive.counters()
    with (force_exact() if exact else contextlib.nullcontext()):
        out, cnt, reads = drive_batches(label, tree, need)
    check([r for b in out for r in b.to_pylist()], label)
    del out
    check_idle(label)
    shuffle_root_empty(label)
    after = adaptive.counters()
    return {"launches": cnt, "host_reads": reads,
            "choices": adaptive_choices(tree),
            "adaptive_counters": {k: after[k] - before[k] for k in after},
            "shape": repr(plan_shape(tree))}


def drive_adaptive_paths(dev, sm, tm, jb, tb, dj, q3d, types_want,
                         card="not read"):
    """Phase 3i: P32 (Q21, P19 and P20's sort planned at the default
    confs, each held to its oracle, with each adaptive join's choice and
    measured bytes and adaptive.counters(); P32 sub: the Q21 tree whose
    adaptive joins decide under shuffle.partitions = 16 and
    join.subPartitionThreshold one byte under the largest side P32 Q21
    built; P32 demote: Q21 planned with broadcastSizeThreshold 1 GiB,
    whose right side measuring past adaptive.autoBroadcastMaxBytes is
    demoted) and P33 (host: the row engine between a device filter and a
    device aggregate; udf: the host round trip and the compiled tree over
    every order; cbo: the placements under optimizer.enabled; and the
    cost model's constants). Returns (counts, records, runs)."""
    from spark_rapids_tpu_torch.udf_compiler import compile_udf
    counts, recs, runs = {}, {}, {}
    q21_want = q21_oracle(dj)
    wants = {"P32 Q21": q21_want, "P32 P19": types_want["P19"],
             "P32 P20 sort": types_want["P20 sort"],
             "P13 twin": q21_want, "P19 twin": types_want["P19"],
             "P20 sort twin": types_want["P20 sort"]}
    dfs = adaptive_dfs(sm, tm, dev, jb, tb)

    def module(label):
        return sm if "Q21" in label or "P13" in label else tm
    for label in ("P32 Q21", "P32 P19", "P32 P20 sort"):
        print(f"{label} explain:\n{dfs[label].explain()}")
        tree, tag_ms, convert_ms = planned(module(label), dfs[label])
        rec = drive_adaptive(label, tree, ADAPTIVE_NEED[label],
                             exact_rows(wants[label]))
        rec["plan_ms"] = tag_ms + convert_ms
        if (label != "P32 P20 sort") != bool(rec["choices"]):
            raise AssertionError(f"{label}: adaptive joins "
                                 f"{rec['choices']}")
        counts[label], recs[label] = rec["launches"], rec
        print(f"{label}: {len(wants[label])} rows equal to the oracle; "
              f"AdaptiveJoinExec (join type, choice, measured left bytes, "
              f"right bytes) {rec['choices']}; adaptive.counters() moved "
              f"{rec['adaptive_counters']}; launches {rec['launches']}; "
              f"host reads {rec['host_reads']}")
    for label in ("P32 Q21", "P13 twin", "P32 P19", "P19 twin",
                  "P32 P20 sort", "P20 sort twin"):
        tree = planned(module(label), dfs[label])[0]
        runs[label] = (tree.collect, exact_rows(wants[label]))

    # P32 sub: the planned Q21, its adaptive joins under the sub conf
    largest = built_bytes(recs["P32 Q21"]["choices"])
    sub_conf = {"spark.rapids.sql.shuffle.partitions": str(P32_SUB_PARTS),
                "spark.rapids.sql.join.subPartitionThreshold":
                    str(largest - 1)}

    def sub_tree():
        return with_runtime_conf(planned(sm, dfs["P32 Q21"])[0], sub_conf)
    # the exact tier: a partition's later stream blocks would reuse its
    # first block's candidate bucket, and a trip re-runs the plan
    rec = drive_adaptive("P32 sub", sub_tree(), ADAPTIVE_NEED["P32 sub"],
                         exact_rows(q21_want), exact=True)
    rec["runtime_conf"] = sub_conf
    rec["k"] = sub_partitions(rec["choices"], largest - 1)
    if not rec["k"]:
        raise AssertionError(f"P32 sub: no subpartition {rec['choices']}")
    counts["P32 sub"], recs["P32 sub"] = rec["launches"], rec
    runs["P32 sub"] = (lambda: sub_tree().collect(), exact_rows(q21_want))
    # its static twin: the same k-way sub-partitioned join, read a
    # partition pair at a time (untimed)
    static_conf = dict(sub_conf, **STATIC_CONF)
    rec = drive_adaptive("P32 sub static", with_runtime_conf(
        planned(sm, dfs["P32 Q21"])[0], static_conf),
        ADAPTIVE_NEED["P32 sub"], exact_rows(q21_want), exact=True)
    rec["runtime_conf"] = static_conf
    rec["k"] = sub_partitions(rec["choices"], largest - 1)
    if not rec["k"] or rec["adaptive_counters"]["single_build_converts"] \
            or rec["launches"]["fused_probe_verify"] < P32_SUB_PARTS:
        raise AssertionError(f"P32 sub static: {rec['choices']}, launches "
                             f"{rec['launches']}")
    counts["P32 sub static"], recs["P32 sub static"] = rec["launches"], rec

    # P32 demote: a broadcast threshold past every side; the cap lowered
    # below the largest measured right side only if no side measures past
    # the default cap at this scale factor
    demote_conf = dict(Q3_CONF, **{"spark.rapids.sql.broadcastSizeThreshold":
                                   str(P32_DEMOTE_THRESHOLD)})

    def demote_tree(conf):
        return planned(sm, q21_df(sm, sm.session.TpuSession(conf, dev),
                                  jb))[0]
    rec = drive_adaptive("P32 demote", demote_tree(demote_conf),
                         ADAPTIVE_NEED["P32 demote"], exact_rows(q21_want),
                         exact=True)
    if not rec["adaptive_counters"]["broadcast_demotes"]:
        cap = max(r for *_, r in recs["P32 Q21"]["choices"]) - 1
        print(f"P32 demote: no right side measured past the default cap "
              f"{rec['choices']}; the cap lowered to {cap} bytes, one "
              f"under P32 Q21's largest measured right side")
        demote_conf = dict(demote_conf, **{
            "spark.rapids.tpu.adaptive.autoBroadcastMaxBytes": str(cap)})
        rec = dict(drive_adaptive("P32 demote", demote_tree(demote_conf),
                                  ADAPTIVE_NEED["P32 demote"],
                                  exact_rows(q21_want), exact=True),
                   lowered_cap=cap)
    if not rec["adaptive_counters"]["broadcast_demotes"]:
        raise AssertionError(f"P32 demote: no broadcast_demote "
                             f"{rec['choices']}")
    rec["conf"] = demote_conf
    counts["P32 demote"], recs["P32 demote"] = rec["launches"], rec
    runs["P32 demote"] = (lambda: demote_tree(demote_conf).collect(),
                          exact_rows(q21_want))
    for label in ("P32 sub", "P32 sub static", "P32 demote"):
        rec = recs[label]
        print(f"{label}: {len(q21_want)} rows equal to q21_oracle; "
              f"AdaptiveJoinExec {rec['choices']}"
              + (f" (k {rec['k']})" if "sub" in label else "")
              + f"; adaptive.counters() moved {rec['adaptive_counters']}; "
              f"conf {rec.get('runtime_conf', rec.get('conf'))}; launches "
              f"{rec['launches']}; host reads {rec['host_reads']}")

    # P33 host: the row engine between a device filter and aggregate
    orders, nd = p33_orders(tm, dev, dj, q3d)
    want, month_rows = p33_host_oracle(dj, nd)
    host_df = p33_host_df(tm, tm.session.TpuSession(device=dev), orders)
    text = host_df.explain()
    print(f"P33 host explain:\n{text}")
    if "~ Project" not in text:
        raise AssertionError("P33 host: the Project is not on the host")
    tree, tag_ms, convert_ms = planned(tm, host_df)
    t0 = time.perf_counter()
    rec = drive_adaptive("P33 host", tree, [], exact_rows(want))
    rec.update(ms=(time.perf_counter() - t0) * 1e3, month_rows=month_rows,
               plan_ms=tag_ms + convert_ms)
    counts["P33 host"], recs["P33 host"] = rec["launches"], rec
    runs["P33 host"] = (tree.collect, exact_rows(want))
    print(f"P33 host: {month_rows} orders of {orders.num_rows_host} in the "
          f"month through the row engine; {want} equal to the Python "
          f"oracle; one run {rec['ms']:.3f} ms (counted, sync debug on); "
          f"launches {rec['launches']}; host reads {rec['host_reads']}")

    # P33 udf: the host round trip, then compiled
    okey, price = nd["o_orderkey"], nd["o_totalprice"]
    adj = {}
    for compiled in (False, True):
        label = "P33 udf compiled" if compiled else "P33 udf host"
        df = p33_udf_df(tm, dev, orders, compiled)

        def tree_of(df=df):
            # apply() runs the UDF compiler when its conf is on
            return tm.overrides.TpuOverrides(df.session.conf).apply(
                df.logical_plan())
        trips = udf_round_trips()
        t0 = time.perf_counter()
        out, cnt, reads = drive_batches(label, tree_of(), [])
        ms = (time.perf_counter() - t0) * 1e3
        after = udf_round_trips()
        adj[label] = check_udf_columns(out, okey, price, label)
        del out
        check_idle(label)
        moved = {k: after[k] - trips[k] for k in after}
        if compiled != (moved["round_trips"] == 0):
            raise AssertionError(f"{label}: host round trips {moved}")
        recs[label] = {"launches": cnt, "host_reads": reads, "ms": ms,
                       "round_trips": moved, "rows": int(okey.shape[0])}
        counts[label] = cnt
        if compiled:
            runs[label] = (lambda tree_of=tree_of: tree_of().execute(),
                           lambda out, lb: check_udf_columns(
                               out, okey, price, lb))
        print(f"{label}: {okey.shape[0]} rows equal to numpy; host round "
              f"trips {moved}; one run {ms:.3f} ms (counted, sync debug "
              f"on); launches {cnt}; host reads {reads}")
    if not np.array_equal(adj["P33 udf host"], adj["P33 udf compiled"]):
        raise AssertionError("P33 udf: host round trip != compiled")
    compiled_tree = compile_udf(p33_discount, [tm.core.col("o_totalprice"),
                                               tm.core.col("o_orderkey")])
    recs["P33 udf compiled"]["tree"] = repr(compiled_tree)
    print(f"P33 udf compiled tree: {compiled_tree!r}")

    # P33 cbo: the placements under optimizer.enabled
    for label, df in p33_cbo_dfs(tm, dev, jb).items():
        text = df.explain()
        marks = [ln.strip()[:1] for ln in text.splitlines()
                 if ln.strip()[:2] in ("~ ", "* ", "! ")]
        on_host = marks[:2] == ["~", "~"]
        if on_host != (label == "P33 cbo nations"):
            raise AssertionError(f"{label}: placed {marks}:\n{text}")
        notes = [ln.strip() for ln in text.splitlines()
                 if "cost optimizer" in ln]
        table = jb["nation" if "nations" in label else "lineitem"]
        k = table.columns[0].data[:table.num_rows_host].cpu().numpy()
        want = sorted((int(a), int(a) * 3 + 1) for a in k
                      if int(a) * 3 + 1 < P33_CBO_BELOW)
        rows = df.collect()
        if sorted(rows) != want:
            raise AssertionError(f"{label}: {sorted(rows)[:4]} != numpy "
                                 f"{want[:4]}")
        check_idle(label)
        recs[label] = {"placement": marks, "cost_notes": notes,
                       "rows": len(rows)}
        print(f"{label}: placed {marks} (Filter, Project, Scan); "
              f"{notes}; {len(rows)} rows equal to numpy")

    # the cost model's constants on this card
    consts = measure_cost_constants(tm, dev, jb, orders)
    recs["cost_constants"] = consts
    print(f"cost constants (plan/cost.py, microseconds) on {card}: "
          f"{json.dumps(consts)}")
    return counts, recs, runs


def compare_adaptive_paths(dev, sm, tm, jb, tb):
    """Phase 2 at P32's own inputs: every murmur3 chain, probe and row
    gather launch of a run of P32 Q21, P32 P19, P32 P20's sort, P32 sub,
    its static twin and P32 demote (at 1 GiB, the default cap), each held
    exactly to its plain version."""
    from spark_rapids_tpu_torch.ops import murmur3_lanes as m3
    dfs = adaptive_dfs(sm, tm, dev, jb, tb)
    probe = planned(sm, dfs["P32 Q21"])[0]
    probe.collect()
    sub_conf = {"spark.rapids.sql.shuffle.partitions": str(P32_SUB_PARTS),
                "spark.rapids.sql.join.subPartitionThreshold":
                    str(built_bytes(adaptive_choices(probe)) - 1)}
    del probe

    def fresh(label):
        if label == "P32 demote":
            sess = sm.session.TpuSession(dict(Q3_CONF, **{
                "spark.rapids.sql.broadcastSizeThreshold":
                    str(P32_DEMOTE_THRESHOLD)}), dev)
            return planned(sm, q21_df(sm, sess, jb))[0]
        sub = label.startswith("P32 sub")
        m = sm if "Q21" in label or sub else tm
        tree = planned(m, dfs["P32 Q21" if sub else label])[0]
        if label == "P32 sub":
            with_runtime_conf(tree, sub_conf)
        elif label == "P32 sub static":
            with_runtime_conf(tree, dict(sub_conf, **STATIC_CONF))
        return tree
    for label in ("P32 Q21", "P32 P19", "P32 P20 sort", "P32 sub",
                  "P32 sub static", "P32 demote"):
        gathers = capture_row_gathers(fresh(label))
        print(f"compare {label} main-path row gathers: "
              f"{'; '.join(compare_row_gathers(label, gathers))}; exact")
        del gathers
        if label == "P32 P20 sort":
            continue
        calls = capture_murmur3(fresh(label))
        for k, (cols, seeds) in enumerate(calls):
            _exact(f"murmur3 {label} call {k}",
                   m3.murmur3_columns(cols, seeds),
                   m3.murmur3_columns_plain(cols, seeds))
        probes = capture_probes(fresh(label))
        hits = [compare_probe(f"probe {label} call {k}", args, cap, total)
                for k, (args, cap, total) in enumerate(probes)]
        if not calls or not probes:
            raise AssertionError(f"{label}: {len(calls)} murmur3 and "
                                 f"{len(probes)} probe launches captured")
        print(f"compare {label} main-path murmur3 launches ({len(calls)}) "
              f"and probes ({len(probes)}, {sum(hits)} verified pairs); "
              f"exact")


def capture_probes(plan):
    """Run `plan` once and keep the inputs of every fused probe-verify
    launch (exec/joins' fused_probe_verify), in call order: [(its seven
    input tensors, the candidate bucket, the candidate total)]."""
    import torch
    from spark_rapids_tpu_torch.exec import joins
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    calls, real = [], joins.fused_probe_verify

    def record(*args):
        *ins, cap = args
        total = int(ins[1].to(torch.int64).sum())
        calls.append(([x.clone() for x in ins], cap, total))
        return real(*args)
    joins.fused_probe_verify = record
    try:
        with speculation_scope():
            list(plan.execute())
            torch.cuda.synchronize()
    finally:
        joins.fused_probe_verify = real
    return calls


def time_adaptive_paths(runs):
    """Phase 4: P32's default-conf plans beside their twins, P32 sub and
    demote, P33 host and P33 udf compiled, in turns (the order reversed
    every other round), P_ADAPTIVE_ITERS runs each, one synchronisation a
    run; each run held to its oracle."""
    import torch
    out = {label: [] for label in runs}
    for i in range(P_ADAPTIVE_ITERS):
        for label in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
            run, check = runs[label]
            t0 = time.perf_counter()
            res = run()
            if not isinstance(res, list):
                res = list(res)
            torch.cuda.synchronize()
            out[label].append((time.perf_counter() - t0) * 1e3)
            check(res, f"{label} timed")
            del res
    for label, ms in out.items():
        print(f"{label} ms per run ({P_ADAPTIVE_ITERS} runs, in turns): "
              f"{[round(x, 3) for x in ms]}")
    return out


# -- slice 15: the governed collect (phase 3j) --------------------------------

P34_RUNS = 3             # governed runs and ungoverned twin runs, in turns
#: P36: cancel_query() and the deadline at these shares of a measured
#: uncancelled run (at the default confs P11 converts to one single-build
#: pass and can finish within a fixed 0.3 s)
P36_CANCEL_SHARE = 0.3
P36_TIMEOUT_SHARE = 0.5
P37_ROUNDS = 3           # P37: queries per session
P35_FAULTS = ("shuffle.fetch:prob=0.25,seed=35,kind=io,max=3;"
              "device.dispatch:prob=1,seed=35,kind=device,max=1")
P35_SPILL_FAULT = "spill.disk_write:prob=1,seed=35,kind=corrupt,max=1"


def governed_conf(event_dir):
    """P34's planes: phases, the event log at MODERATE, telemetry every
    100 ms and the dispatch ledger."""
    return {"spark.rapids.tpu.phases.enabled": "true",
            "spark.rapids.tpu.eventLog.enabled": "true",
            "spark.rapids.tpu.eventLog.dir": event_dir,
            "spark.rapids.tpu.eventLog.level": "MODERATE",
            "spark.rapids.tpu.telemetry.enabled": "true",
            "spark.rapids.tpu.telemetry.intervalMs": "100",
            "spark.rapids.tpu.dispatch.ledger.enabled": "true"}


def join_pairs(metrics):
    return next(v["numOutputRows"] for k, v in metrics.items()
                if k.startswith("HashJoinExec#"))


def engine_threads():
    """The threads a query starts and must stop: pipeline producers."""
    import threading
    return [t for t in threading.enumerate()
            if t.name.startswith("pipeline-")]


def wait_engine_threads(label, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while engine_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    left = [t.name for t in engine_threads()]
    if left:
        raise AssertionError(f"{label}: engine threads alive: {left}")


def zero_launches():
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def governed_run(label, df, check):
    """One governed collect() with every launch counter and the dispatch
    ledger reset just before: (ms, launches, ledger calls per kernel
    label, the phase split, its wall)."""
    import torch
    from spark_rapids_tpu_torch.obs import dispatch
    wrappers = zero_launches()
    dispatch.reset_dispatch_ledger()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = df.collect()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {k: w.launches for k, w in wrappers.items()}
    calls = dispatch.calls_by_label("kernel")
    check(rows, label, df.session.last_query_metrics())
    prof = df.session.last_query_profile()
    phases, wall = prof.phases(), prof.phases_wall_ns()
    if sum(phases.values()) != wall:
        raise AssertionError(f"{label}: phases sum to {sum(phases.values())}"
                             f" ns, not the wall {wall}")
    if calls != {k: v for k, v in counts.items() if v}:
        raise AssertionError(f"{label}: ledger calls {calls} != launches "
                             f"{counts}")
    return ms, counts, calls, phases, wall


def drive_p34(dev, sm, tm, dfs_of, checks):
    """P34: q3, Q19 and P19 collected through the governed drive, P34_RUNS
    times in turns with exec/base.collect of the same plan, converted and
    its stages compiled as apply() does (the ungoverned twin); then one
    governed run traced, whose device kernels must equal its ledger calls
    and launches. Returns a record per query."""
    import tempfile
    import torch
    from spark_rapids_tpu_torch.exec.stage_compiler import compile_stages
    from spark_rapids_tpu_torch.obs import events, telemetry
    event_dir = tempfile.mkdtemp(prefix="p34-events-")
    conf = governed_conf(event_dir)
    recs = {}
    for label, (m, make_df) in dfs_of.items():
        df = make_df(conf)
        check = checks[label]
        twin = compile_stages(planned(m, df)[0], df.session.conf)
        bus = events.active_bus() or events.configure(df.session.conf)
        n_before = len(events.read_events(bus)) if bus.paths else 0
        reg = telemetry.active_registry()
        samples0 = reg.samples_taken if reg is not None else 0
        gov_ms, twin_ms, last = [], [], None
        for i in range(P34_RUNS):
            order = ("gov", "twin") if i % 2 == 0 else ("twin", "gov")
            for which in order:
                if which == "gov":
                    last = governed_run(f"{label} governed", df, check)
                    gov_ms.append(last[0])
                else:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    rows = twin.collect()
                    twin_ms.append((time.perf_counter() - t0) * 1e3)
                    check(rows, f"{label} twin", None)
        ms, counts, calls, phases, wall = last
        _, _, traced = traced_check(f"{label} governed", lambda: governed_run(
            f"{label} governed, traced", df, check))
        bus = events.active_bus()
        kinds = {}
        for r in events.read_events(bus)[n_before:]:
            kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
        reg = telemetry.active_registry()
        samples = (reg.samples_taken if reg is not None else 0) - samples0
        top = df.session.last_query_profile().top_operators()
        if kinds.get("query_phases") != P34_RUNS + 1 or not samples:
            raise AssertionError(f"{label}: events {kinds}, telemetry "
                                 f"samples {samples}")
        recs[label] = {"governed_ms": gov_ms, "twin_ms": twin_ms,
                       "phases": phases, "wall_ns": wall,
                       "launches": counts, "ledger_calls": calls,
                       "launches_traced": traced, "events": kinds, "telemetry_samples": samples,
                       "top_operators": top}
        print(f"P34 {label}: governed ms {[round(x, 3) for x in gov_ms]}, "
              f"ungoverned twin ms {[round(x, 3) for x in twin_ms]}; "
              f"phases (sum == wall {wall} ns) {phases}; ledger calls "
              f"{calls} == launches == the traced device kernels; "
              f"events {kinds}; telemetry samples "
              f"{samples}; top operators "
              f"{[(r['op'], r['time_ns']) for r in top]}")
    telemetry.reset_telemetry()
    events.reset_event_bus()
    return recs


def p3_session_df(sm, dev, d3, conf):
    """P3 through the session: q3's lineitems in P3_LINE_BATCHES batches
    sorted by l_orderkey ASC, l_price DESC, one partition, each input
    batch its own coalesce target (as the hand-built SortExec sees them)."""
    schema = q3_schemas("LONG")[1]
    batches = q3_batches(d3, dev, schema, Q3_LINES, P3_LINE_BATCHES)
    nbytes = batches[0].nbytes
    sess = sm.session.TpuSession(dict(conf, **{
        "spark.rapids.sql.shuffle.partitions": "1",
        "spark.rapids.sql.batchSizeBytes": str(nbytes)}), dev)
    return sess.from_batches(batches, schema).sort(
        ("l_orderkey", True), ("l_price", False))


def p2_session_df(sm, dev, d3, conf):
    """P2 through the session: q3 over P2_LINE_BATCHES lineitem batches,
    each its own coalesce target."""
    o_schema, l_schema = q3_schemas("LONG")
    lines = q3_batches(d3, dev, l_schema, Q3_LINES, P2_LINE_BATCHES)
    sess = sm.session.TpuSession(dict(conf, **{
        "spark.rapids.sql.batchSizeBytes": str(lines[0].nbytes)}), dev)
    return q3_df(sm, sess, q3_batches(d3, dev, o_schema, Q3_ORDERS), lines)


def check_sort_rows(rows, d, label):
    order = np.lexsort((-d["l_price"], d["l_orderkey"]))
    names = [f.name for f in q3_schemas("LONG")[1].fields]
    if len(rows) != Q3_LINES:
        raise AssertionError(f"{label}: {len(rows)} rows, not {Q3_LINES}")
    for i, name in enumerate(names):
        got = np.fromiter((r[i] for r in rows), d[name].dtype, len(rows))
        if not np.array_equal(got, d[name][order]):
            raise AssertionError(f"{label}: {name} out of order")


def retry_run(label, df, check):
    """One collect() under an armed fault plan; the plan disarmed after.
    Returns a record: attempts, the faults' stats, launches, ms."""
    from spark_rapids_tpu_torch import faults
    from spark_rapids_tpu_torch.exec import task_retry
    wrappers = zero_launches()
    before = task_retry.task_retry_total()
    t0 = time.perf_counter()
    try:
        rows = df.collect()
    finally:
        stats = faults.stats()
        faults.install(None)
    ms = (time.perf_counter() - t0) * 1e3
    check(rows, label)
    attempts = task_retry.task_retry_total() - before + 1
    wait_engine_threads(label)
    check_idle(label)
    shuffle_root_empty(label)
    return {"attempts": attempts, "faults": stats, "ms": ms,
            "launches": {k: w.launches for k, w in wrappers.items()}}


def drive_p35(dev, sm, jb, d3, q3_want, q4_want, p2_rec, p3_rec):
    """P35: P16 (Q4's semi join over 16 host partitions) under a
    `shuffle.fetch` io fault and a one-shot `device.dispatch` device
    fault, then P3 (the out-of-core sort, at its device budget and host
    limit) under a `spill.disk_write` corrupt fault — or P2 (q3 under its
    budget) when P3 writes no spill file to disk — each with
    task.maxAttempts 3."""
    from spark_rapids_tpu_torch import memory as M
    from spark_rapids_tpu_torch.config import RapidsConf, set_active_conf
    recs = {}
    conf = dict(P16_CONF, **{"spark.rapids.tpu.task.maxAttempts": "3",
                             "spark.rapids.tpu.test.faults": P35_FAULTS})
    df = q4_df(sm, sm.session.TpuSession(conf, dev), jb, False, sort=False)
    recs["P16"] = retry_run("P35 P16", df, sorted_rows(q4_want))
    for label, rec, make in (
            ("P3", p3_rec, lambda c: p3_session_df(sm, dev, d3, c)),
            ("P2", p2_rec, lambda c: p2_session_df(sm, dev, d3, c))):
        c = dict(Q3_CONF, **{
            "spark.rapids.tpu.task.maxAttempts": "3",
            "spark.rapids.tpu.test.faults": P35_SPILL_FAULT,
            "spark.rapids.memory.tpu.budgetBytes": str(rec["budget"]),
            "spark.rapids.memory.host.spillStorageSize":
                str(rec["host_limit"])})
        df = make(c)
        # the budget and the catalog read the session's conf when made
        M.reset_memory_budget()
        M.reset_buffer_catalog()
        check = ((lambda r, lb: check_sort_rows(r, d3, lb)) if label == "P3"
                 else (lambda r, lb: check_q3(r, q3_want, lb)))
        try:
            run = retry_run(f"P35 {label}", df, check)
            cat = M.buffer_catalog().counters()
        finally:
            # the later paths run under the default budget again
            set_active_conf(RapidsConf())
            M.reset_buffer_catalog()
            M.reset_memory_budget()
        run.update(budget=rec["budget"], host_limit=rec["host_limit"],
                   spills=cat)
        recs[label] = run
        if run["faults"].get("spill.disk_write"):
            break
        print(f"P35 {label}: no spill file written to disk ({cat}); "
              f"the next path takes the fault")
    for label, run in recs.items():
        print(f"P35 {label}: rows equal to the oracle after "
              f"{run['attempts']} attempts; faults {run['faults']}; "
              f"{run['ms']:.1f} ms; launches {run['launches']}; catalog "
              f"empty, no permit held, shuffle root empty")
    last = list(recs)[-1]
    if recs["P16"]["attempts"] < 2 or recs[last]["attempts"] < 2 \
            or not recs[last]["faults"].get("spill.disk_write"):
        raise AssertionError(f"P35: {recs}")
    return recs


def drive_p36(dev, sm, d3, q3_want):
    """P36: P11 (q3 over 16 host partitions) timed twice uncancelled, then
    cancelled with cancel_query() from a second thread after
    P36_CANCEL_SHARE of the faster run, then run under a query.timeoutMs
    of P36_TIMEOUT_SHARE of it: where each was noticed, the latency to the
    raise, and the catalog, permits, engine threads and device memory
    after."""
    import gc
    import threading
    import torch
    from spark_rapids_tpu_torch.exec.lifecycle import QueryCancelledError
    o_schema, l_schema = q3_schemas("LONG")
    orders = q3_batches(d3, dev, o_schema, Q3_ORDERS, P11_ORDER_BATCHES)
    lines = q3_batches(d3, dev, l_schema, Q3_LINES, P11_LINE_BATCHES)
    recs = {}
    runs = []
    for _ in range(2):
        t0 = time.monotonic()
        check_q3(q3_df(sm, sm.session.TpuSession(P11_CONF, dev), orders,
                       lines).collect(), q3_want, "P36 uncancelled")
        runs.append(time.monotonic() - t0)
    full_s = min(runs)
    cancel_s = full_s * P36_CANCEL_SHARE
    timeout_ms = max(1, int(full_s * P36_TIMEOUT_SHARE * 1000))
    recs["uncancelled_ms"] = full_s * 1e3
    for label, extra in (("cancel", {}), ("deadline", {
            "spark.rapids.tpu.query.timeoutMs": str(timeout_ms)})):
        sess = sm.session.TpuSession(dict(P11_CONF, **extra), dev)
        df = q3_df(sm, sess, orders, lines)
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        cancel_at = {}

        def cancel():
            time.sleep(cancel_s)
            cancel_at["t"] = time.monotonic()
            cancel_at["n"] = sess.cancel_query()

        canceller = threading.Thread(target=cancel, name="p36-cancel")
        t0 = time.monotonic()
        if label == "cancel":
            canceller.start()
        try:
            df.collect()
            raise AssertionError(f"P36 {label}: the query finished")
        except QueryCancelledError as e:
            t_raise = time.monotonic()
            noticed, reason = e.phase, e.reason
        if label == "cancel":
            canceller.join(timeout=30)
            if canceller.is_alive() or cancel_at.get("n") != 1:
                raise AssertionError(f"P36: cancel_query() {cancel_at}")
            start = cancel_at["t"]
        else:
            start = t0 + timeout_ms / 1000.0
        wait_engine_threads(f"P36 {label}")
        check_idle(f"P36 {label}")
        shuffle_root_empty(f"P36 {label}")
        del df
        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        if mem1 != mem0:
            raise AssertionError(f"P36 {label}: memory_allocated {mem1} "
                                 f"after, {mem0} before")
        recs[label] = {"latency_ms": (t_raise - start) * 1e3,
                       "noticed": noticed, "reason": reason,
                       "ran_ms": (t_raise - t0) * 1e3,
                       "at_ms": (cancel_s * 1e3 if label == "cancel"
                                 else timeout_ms),
                       "memory_allocated": [mem0, mem1]}
        print(f"P36 {label}: QueryCancelledError ({reason}) noticed in "
              f"{noticed} {recs[label]['latency_ms']:.1f} ms after the "
              f"{'cancel' if label == 'cancel' else 'deadline'}, "
              f"{recs[label]['ran_ms']:.1f} ms after the start; catalog "
              f"empty, no permit held, no pipeline thread alive, "
              f"memory_allocated {mem0} before and after")
    return recs


def drive_p37(dev, sm, tm, l19, p19, tb, q19_want, p19_want):
    """P37: four sessions on four threads under workload.enabled,
    maxConcurrentQueries 2, queueDepth 4: two interactive sessions run
    Q19, two batch sessions P19, P37_ROUNDS each. Every result equals its
    oracle, the grant order equals pick_fair replayed on the recorded
    arrivals, active_queries() is read mid-flight and health()["slo"]
    gives the percentiles."""
    import threading
    from spark_rapids_tpu_torch.exec import workload
    from spark_rapids_tpu_torch.obs import telemetry
    workload.reset_workload()
    base = {"spark.rapids.tpu.workload.enabled": "true",
            "spark.rapids.tpu.workload.maxConcurrentQueries": "2",
            "spark.rapids.tpu.workload.queueDepth": "4",
            "spark.rapids.tpu.telemetry.enabled": "true",
            "spark.rapids.tpu.telemetry.intervalMs": "100"}
    jobs = []
    for i, prio in enumerate(("interactive", "interactive", "batch",
                              "batch")):
        conf = dict(base, **{"spark.rapids.tpu.workload.priority": prio})
        if prio == "interactive":
            df = q19_df(sm, sm.session.TpuSession(conf, dev), l19, p19)
            check = (lambda r, lb: check_q19(r, q19_want[1], q19_want, lb))
        else:
            df = q3_types_df(tm, tm.session.TpuSession(
                dict(P19_CONF, **conf), dev), tb["q3"])
            check = exact_rows(p19_want)
        jobs.append((f"{prio}-{i}", df, check))
    errors, done, seen = [], [], []
    wrappers = zero_launches()

    def run(tag, df, check):
        try:
            for r in range(P37_ROUNDS):
                check(df.collect(), f"P37 {tag} round {r}")
                done.append(tag)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append((tag, e))

    threads = [threading.Thread(target=run, args=j, name=f"p37-{j[0]}")
               for j in jobs]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        rows = jobs[0][1].session.active_queries()
        if len(rows) > len(seen):
            seen = rows
        time.sleep(0.005)
    for t in threads:
        t.join(timeout=60)
    ms = (time.perf_counter() - t0) * 1e3
    if errors:
        raise AssertionError(f"P37: {errors}")
    log = workload.admission_log()
    grants = [rec[1] for rec in log if rec[0] == "grant"]
    if grants != workload.replay_grants(log) or \
            len(grants) != 4 * P37_ROUNDS:
        raise AssertionError(f"P37: grants {grants} != pick_fair's "
                             f"{workload.replay_grants(log)}")
    slo = jobs[0][1].session.health()["slo"]
    counts = {k: w.launches for k, w in wrappers.items()}
    snap = workload.snapshot()
    telemetry.reset_telemetry()
    check_idle("P37")
    if snap["admitted"] or snap["queue_depth"] or not seen:
        raise AssertionError(f"P37: {snap}, mid-flight {seen}")
    print(f"P37: {len(done)} queries in {ms:.1f} ms, every result equal to "
          f"its oracle; grant order {grants} equals pick_fair replayed on "
          f"the arrivals; counters {snap['counters']}; most queries seen "
          f"mid-flight {len(seen)}: "
          f"{[(r['query'], r['phase'], r['current_op']) for r in seen]}; "
          f"slo {slo}; launches {counts}")
    return {"ms": ms, "grants": grants, "counters": snap["counters"],
            "mid_flight": seen, "slo": slo, "launches": counts}


def drive_governed_paths(dev, sm, tm, d3, q3_want, l19, p19, q19_want, jb,
                         tb, types_want, q4_want, p2_rec, p3_rec):
    """Phase 3j: P34-P37. Returns (records, launches per path)."""
    o_schema, l_schema = q3_schemas("LONG")
    orders = q3_batches(d3, dev, o_schema, Q3_ORDERS)
    lines = q3_batches(d3, dev, l_schema, Q3_LINES)

    def q19_check(rows, label, _metrics=None):
        check_q19(rows, q19_want[1], q19_want, label)

    dfs_of = {
        "q3": (sm, lambda c: q3_df(sm, sm.session.TpuSession(
            dict(Q3_CONF, **c), dev), orders, lines)),
        "Q19": (sm, lambda c: q19_df(sm, sm.session.TpuSession(c, dev),
                                     l19, p19)),
        "P19": (tm, lambda c: q3_types_df(tm, tm.session.TpuSession(
            dict(Q3_CONF, **c), dev), tb["q3"]))}
    checks = {"q3": lambda r, lb, _m=None: check_q3(r, q3_want, lb),
              "Q19": q19_check, "P19": exact_rows(types_want["P19"])}
    recs = {"P34": drive_p34(dev, sm, tm, dfs_of, checks)}
    recs["P35"] = drive_p35(dev, sm, jb, d3, q3_want, q4_want, p2_rec,
                            p3_rec)
    recs["P36"] = drive_p36(dev, sm, d3, q3_want)
    recs["P37"] = drive_p37(dev, sm, tm, l19, p19, tb, q19_want,
                            types_want["P19"])
    launches = {f"P34_{k}": v["launches_traced"]
                for k, v in recs["P34"].items()}
    launches.update({f"P35_{k}": v["launches"]
                     for k, v in recs["P35"].items()})
    launches["P37"] = recs["P37"]["launches"]
    return recs, launches


# -- phase 3k: the adaptive read plan and the robustness paths (A.9b) --------

P38_HOT = 0.8            # P38: the lines' share on one order key (the JAX
#                          package's zipf shape, tests/test_adaptive.py)
P38_SEED = 38
P38_MAP_BATCHES = 16     # P38's lines as 16 host map batches
#: P38's runs of each plan, in turns: static once (its 256 partition-pair
#: reads take 8-11 s a run on an H100), split and convert 3 each
P38_RUNS = {"static": 1, "split": 3, "convert": 3}
#: P38's three plans, all over 16 partitions with broadcasts off: static
#: (adaptive off), split (the defaults but the conversion cap, as the JAX
#: package's skew test BASE sets it) and convert (the defaults)
P38_CONFS = {
    "static": STATIC_CONF,
    "split": {"spark.rapids.tpu.adaptive.autoBroadcastMaxBytes": "-1"},
    "convert": {}}
P38_SKEW_FAULT = "shuffle.skew_split:prob=1,seed=38,kind=corrupt,max=1"
P38_SPEC_DELAY_MS = 500  # one shuffle.fetch straggler under speculation
P38_DECODE_FAULT = "shuffle.decode:prob=1,seed=35,kind=corrupt,max=1"
#: P11 under the watchdog: the root yields nothing until the end (~1 s),
#: so the window is longer than the run and the delay longer than the
#: window, and shorter than two: one episode
P38_STALL_MS = 2000
P38_STALL_DELAY_MS = 2300
P38_TIMEOUT_MS = 10000   # q3's dispatch hang bound
P38_Q3_RUNS = 5          # q3 with and without the bound, in turns
STALL_ACTIONS = ("report", "retry-seam", "cancel")


#: P38's lines: tpch_join_data's lineitem columns and an l_quantity, each
#: carried through the shuffle as a query without column pruning carries
#: it (the join reads l_orderkey, the aggregate l_quantity)
P38_LINE_FIELDS = tuple((n, t) for n, t, _ in JOIN_TABLES["lineitem"]) \
    + (("l_quantity", "LONG"),)


def p38_data(dj, seed=P38_SEED):
    """tpch_join_data's lines with P38_HOT of them moved onto one existing
    order key (both from `seed`) and an l_quantity of 1-50 (clause
    4.2.3)."""
    rng = np.random.default_rng(seed)
    lkey = dj["l_orderkey"].copy()
    hot = rng.random(lkey.shape[0]) < P38_HOT
    key = int(dj["o_orderkey"][rng.integers(0, dj["o_orderkey"].shape[0])])
    lkey[hot] = key
    out = {name: dj[name] for name, _ in P38_LINE_FIELDS[1:-1]}
    out.update(l_orderkey=lkey,
               l_quantity=rng.integers(1, 51, lkey.shape[0]),
               hot_key=key, hot_rows=int(hot.sum()))
    return out


def p38_oracle(dj, pd):
    """count(*) and sum(l_quantity) by o_orderpriority of the lines joined
    to their orders, in numpy (every line has its order)."""
    prio = dj["o_orderpriority"][0][order_index(pd["l_orderkey"])]
    counts = np.bincount(prio, minlength=5)
    sums = np.zeros(5, np.int64)
    np.add.at(sums, prio, pd["l_quantity"])
    return [(ORDER_PRIORITIES[k], int(counts[k]), int(sums[k]))
            for k in range(5) if counts[k]]


def p38_lines_scan(m, pd, dev):
    """P38's lines as a SourceScanExec of P38_MAP_BATCHES host batches."""
    from spark_rapids_tpu_torch.columnar.column import Column, bucket_capacity
    schema = m.t.Schema(tuple(m.t.StructField(name, getattr(m.t, ty))
                              for name, ty in P38_LINE_FIELDS))
    bounds = np.linspace(0, pd["l_orderkey"].shape[0], P38_MAP_BATCHES + 1,
                         dtype=np.int64)

    def part(lo, hi):
        cap = bucket_capacity(hi - lo)
        return lambda: ([Column.from_numpy(pd[f.name][lo:hi], f.data_type,
                                           capacity=cap, device="cpu")
                         for f in schema.fields], hi - lo)
    return m.basic.SourceScanExec(
        HostSource(schema, [part(int(a), int(b)) for a, b in
                            zip(bounds[:-1], bounds[1:])], dev), schema, 0)


def p38_plan(pd, orders, dev, settings):
    """P38: the lines hash-exchanged on l_orderkey and the orders
    (o_orderkey, o_orderpriority) on o_orderkey into a ShuffledHashJoinExec
    built on the orders, then count(*) and sum(l_quantity) by
    o_orderpriority, partial -> exchange -> final, every exchange over
    P_PARTS partitions under `settings`."""
    from spark_rapids_tpu_torch.config import RapidsConf
    m = port_modules()
    m.exchange_kw = {"conf": RapidsConf(settings)}
    col = m.core.col
    lines = p38_lines_scan(m, pd, dev)
    orders = m.basic.ProjectExec(
        [col("o_orderkey"), col("o_orderpriority")],
        m.basic.InMemoryScanExec([orders], orders.schema))
    join = m.exchange.ShuffledHashJoinExec(
        shuffle_of(m, [col("l_orderkey")], lines, P_PARTS),
        shuffle_of(m, [col("o_orderkey")], orders, P_PARTS),
        [col("l_orderkey")], [col("o_orderkey")], "inner",
        build_side="right")
    return shuffled_aggregate(
        m, [col("o_orderpriority")],
        [(m.aggexprs.Count(), "cnt"),
         (m.aggexprs.Sum(col("l_quantity")), "qty")], join, P_PARTS)


@contextlib.contextmanager
def event_spy(kinds):
    """The port's events of `kinds` emitted inside the block (whether or
    not a bus is on), as (kind, fields) pairs."""
    from spark_rapids_tpu_torch.obs import events
    seen, real = [], events.emit

    def emit(kind, **fields):
        if kind in kinds:
            seen.append((kind, dict(fields)))
        return real(kind, **fields)
    events.emit = emit
    try:
        yield seen
    finally:
        events.emit = real


def decisions_of(seen):
    """The adaptive_replan records among spied events, without op ids."""
    return [{k: v for k, v in f.items() if k not in ("op_id", "exec")}
            for kind, f in seen if kind == "adaptive_replan"]


def row_counts(counts):
    """Rows 2+3, 4 and 5 of the kernel table, from the wrappers' counts."""
    return {"murmur3": counts["murmur3_columns"]
            + counts["murmur3_long_lanes"] + counts["murmur3_int_lanes"],
            "probe": counts["fused_probe_verify"],
            "row_gather": counts["dma_row_gather"]}


def drive_p38(label, plan, want):
    """One run of a P38 plan as collect() runs it (its speculation scope,
    the exact re-run when a flag trips), counted: (record, rows). The
    launches and `peak_bytes` cover the whole run, the decisions, the
    join's pairs and `read_peak_bytes` the execution whose rows are kept.
    A peak is torch.cuda.max_memory_allocated above what was allocated
    when it started: the run's start, or (the read's) the join's first
    partition pair, once both exchanges are written."""
    import torch
    from spark_rapids_tpu_torch.exec import lifecycle
    from spark_rapids_tpu_torch.exec.speculation import (force_exact,
                                                         speculation_scope)
    wrappers = zero_launches()
    rec0 = lifecycle.counters()["partition_recompute"]
    join = p11_join(plan)
    read, pair = {}, join._pair

    def first_pair(*args):
        if not read:
            torch.cuda.synchronize()
            read["base"] = torch.cuda.memory_allocated()
            read["peak0"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        return pair(*args)
    join._pair = first_pair
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with event_spy(("adaptive_replan", "partition_recompute",
                    "speculative_fetch")) as seen:
        with speculation_scope() as scope:
            rows = [r for b in plan._execute(encoded_out=True)
                    for r in b.to_pylist()]
            tripped = scope.tripped()
        if tripped:
            # the decisions and the read of the exact re-run alone
            seen[:] = [x for x in seen if x[0] != "adaptive_replan"]
            read.clear()
            pairs0 = join.metrics["numPartitionPairs"].value
            stream0 = join.metrics["numStreamBatches"].value
            with force_exact():
                rows = [r for b in plan._execute(encoded_out=True)
                        for r in b.to_pylist()]
        else:
            pairs0 = stream0 = 0
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    read_peak = torch.cuda.max_memory_allocated() - read["base"]
    peak = max(read["peak0"], torch.cuda.max_memory_allocated()) - base
    rows = sorted(rows)
    if rows != want:
        raise AssertionError(f"{label}: rows {rows} != oracle {want}")
    check_idle(label)
    shuffle_root_empty(label)
    counts = {k: w.launches for k, w in wrappers.items()}
    return {"ms": ms, "decisions": decisions_of(seen),
            "recomputes": lifecycle.counters()["partition_recompute"] - rec0,
            "spec_events": [f for k, f in seen if k == "speculative_fetch"],
            "launches": row_counts(counts), "all_launches": counts,
            "peak_bytes": peak, "read_peak_bytes": read_peak,
            "tripped": tripped,
            "pairs": join.metrics["numPartitionPairs"].value - pairs0,
            "stream_batches": join.metrics["numStreamBatches"].value
            - stream0,
            "build_bytes": join.children[1]._adaptive_write_bytes}, rows


def p38_expect(label, kind, rec):
    """What each P38 plan must have decided: static nothing; split a skew
    split of the hot partition (its sub-reads under the threshold) and no
    conversion; convert the single build when the orders side measured
    under the cap (the split otherwise)."""
    kinds = [d["decision"] for d in rec["decisions"]]
    splits = [d for d in rec["decisions"] if d["decision"] == "skew_split"]
    if kind == "static" and kinds:
        raise AssertionError(f"{label}: decisions {kinds} with adaptive off")
    if kind == "split":
        if not splits or "single_build_convert" in kinds:
            raise AssertionError(f"{label}: decisions {rec['decisions']}")
    for d in splits:
        if not (d["bytes"] > d["threshold"] >= d["max_sub_bytes"]
                and d["subs"] >= 2):
            raise AssertionError(f"{label}: split {d}")
    if kind == "convert":
        cap = 64 << 20
        if rec["build_bytes"] is not None and rec["build_bytes"] <= cap:
            if "single_build_convert" not in kinds or rec["pairs"] != 1:
                raise AssertionError(f"{label}: {rec['decisions']}, "
                                     f"{rec['pairs']} pairs")
        elif "single_build_convert" in kinds:
            raise AssertionError(f"{label}: converted over the cap")


def drive_p38_runs(pd, orders, dev, want):
    """P38 static, split and convert, P38_RUNS of each in turns."""
    recs = {k: [] for k in P38_CONFS}
    kinds = list(P38_CONFS)
    for i in range(max(P38_RUNS.values())):
        for kind in [k for k in kinds[i:] + kinds[:i] if i < P38_RUNS[k]]:
            label = f"P38 {kind} run {i + 1}"
            rec, _ = drive_p38(label, p38_plan(pd, orders, dev,
                                               P38_CONFS[kind]), want)
            p38_expect(label, kind, rec)
            recs[kind].append(rec)
    out = {}
    for kind, runs in recs.items():
        last = runs[-1]
        out[kind] = {"ms": [r["ms"] for r in runs],
                     "peak_bytes": [r["peak_bytes"] for r in runs],
                     "read_peak_bytes": [r["read_peak_bytes"] for r in runs],
                     **{k: last[k] for k in ("decisions", "launches",
                                             "all_launches", "pairs",
                                             "stream_batches", "build_bytes",
                                             "tripped")}}
        print(f"P38 {kind}: rows equal to the oracle; ms {[round(r['ms'], 1) for r in runs]}; "
              f"peak device memory over the read "
              f"{[r['read_peak_bytes'] for r in runs]} bytes (over the run "
              f"{[r['peak_bytes'] for r in runs]}); decisions "
              f"{last['decisions']}; orders side measured "
              f"{last['build_bytes']} bytes; {last['pairs']} partition "
              f"pairs, {last['stream_batches']} stream batches; launches "
              f"{last['launches']}")
    if out["convert"]["build_bytes"] > 64 << 20:
        print(f"P38 convert: the orders side measured "
              f"{out['convert']['build_bytes']} bytes, over "
              f"adaptive.autoBroadcastMaxBytes (64 MiB): no conversion, the "
              f"split plan ran")
    return out


def a9b_conf(base, history_dir, **extra):
    """A phase 3k session's conf: `base`, the history store on, `extra`."""
    return dict(base, **{"spark.rapids.tpu.history.enabled": "true",
                         "spark.rapids.tpu.history.dir": history_dir},
                **extra)


def drive_p11_stalls(dev, sm, d3, q3_want, history_dir):
    """P11 (planned, 16 partitions) under a `pipeline.produce` delay of
    P38_STALL_DELAY_MS past a stall window of P38_STALL_MS, once per
    action: report (one query_stalled, rows right), retry-seam (two
    attempts, rows right), cancel (QueryCancelledError, memory back to
    its level)."""
    import gc
    import torch
    from spark_rapids_tpu_torch import faults
    from spark_rapids_tpu_torch.exec import task_retry
    from spark_rapids_tpu_torch.exec.lifecycle import QueryCancelledError
    o_schema, l_schema = q3_schemas("LONG")
    orders = q3_batches(d3, dev, o_schema, Q3_ORDERS, P11_ORDER_BATCHES)
    lines = q3_batches(d3, dev, l_schema, Q3_LINES, P11_LINE_BATCHES)
    recs = {}
    for action in STALL_ACTIONS:
        label = f"P11 stalled, {action}"
        conf = a9b_conf(P11_CONF, history_dir, **{
            "spark.rapids.tpu.stall.timeoutMs": str(P38_STALL_MS),
            "spark.rapids.tpu.stall.action": action,
            "spark.rapids.tpu.task.retryBackoffMs": "1",
            "spark.rapids.tpu.test.faults":
                f"pipeline.produce:prob=1,seed=11,kind=delay,"
                f"ms={P38_STALL_DELAY_MS},max=1"})
        df = q3_df(sm, sm.session.TpuSession(conf, dev), orders, lines)
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        before = task_retry.task_retry_total()
        t0 = time.perf_counter()
        err = None
        with event_spy(("query_stalled",)) as seen:
            try:
                rows = df.collect()
            except QueryCancelledError as e:
                err = e
            finally:
                faults.install(None)
        ms = (time.perf_counter() - t0) * 1e3
        attempts = task_retry.task_retry_total() - before + 1
        stalls = [f for _, f in seen]
        wait_engine_threads(label)
        check_idle(label)
        shuffle_root_empty(label)
        del df
        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        if action == "cancel":
            if err is None or err.reason != "stalled" or mem1 != mem0:
                raise AssertionError(f"{label}: {err!r}, memory_allocated "
                                     f"{mem0} before, {mem1} after")
        else:
            if err is not None:
                raise err
            check_q3(rows, q3_want, label)
            want_attempts = 2 if action == "retry-seam" else 1
            if len(stalls) != 1 or attempts != want_attempts:
                raise AssertionError(f"{label}: {len(stalls)} stalls, "
                                     f"{attempts} attempts")
        recs[action] = {"ms": ms, "attempts": attempts, "stalls": stalls,
                        "memory_allocated": [mem0, mem1],
                        "cancelled": err is not None}
        print(f"{label}: {len(stalls)} query_stalled "
              f"{[(s['seam'], s['phase'], s['stalled_ms']) for s in stalls]}"
              f"; {attempts} attempt(s); "
              + ("QueryCancelledError (stalled)" if err is not None
                 else "top 10 equal to the oracle")
              + f" in {ms:.1f} ms; memory_allocated {mem0} before, {mem1} "
              f"after; catalog empty, no permit, no pipeline thread")
    return recs


def drive_a9b_paths(dev, sm, dj, jb, p9_batches, q1_want, d3, q3_want,
                    q4_want, pd, p38_want):
    """Phase 3k: P38 (static, split, convert), then the earlier paths
    under A.9b: P9's coalesced read, P16's decision, P35's P16 under a
    shuffle.decode corrupt fault, P38 split under a skew-split fault and
    under speculation with a fetch straggler, P11 under the watchdog's
    three actions, q3 under the dispatch hang bound against none, P2's
    injected split's right-sizing, with one history capsule per governed
    query, written to a temporary directory that goes after. Returns
    (records, launches by path)."""
    import shutil
    import tempfile
    from spark_rapids_tpu_torch.obs import history
    history_dir = tempfile.mkdtemp(prefix="p38-history-")
    try:
        return a9b_paths(dev, sm, jb, p9_batches, q1_want, d3, q3_want,
                         q4_want, pd, p38_want, history_dir)
    finally:
        history.reset_history()
        shutil.rmtree(history_dir, ignore_errors=True)


def a9b_paths(dev, sm, jb, p9_batches, q1_want, d3, q3_want, q4_want, pd,
              p38_want, history_dir):
    """drive_a9b_paths' body, its capsules under `history_dir`."""
    import os
    import torch
    from spark_rapids_tpu_torch import faults
    from spark_rapids_tpu_torch import memory as M
    from spark_rapids_tpu_torch.config import RapidsConf, set_active_conf
    from spark_rapids_tpu_torch.exec import (adaptive, lifecycle,
                                             speculation_shield, task_retry)
    from spark_rapids_tpu_torch.obs import history
    governed = 0
    recs, launches = {}, {}
    orders = jb["orders"]

    # P38 itself
    recs["P38"] = drive_p38_runs(pd, orders, dev, p38_want)
    for kind, rec in recs["P38"].items():
        launches[f"P38_{kind}"] = rec.pop("all_launches")

    # P9 at the default confs: the final aggregate reads its tiny
    # partitions as one coalesced stream
    pm = port_modules()
    p9 = q1_tree(pm, pm.basic.InMemoryScanExec(p9_batches,
                                               p9_batches[0].schema), P_PARTS)
    with event_spy(("adaptive_replan",)) as seen:
        rows, counts, exs, ms, _ = drive_shuffled(
            "P9 default confs", p9, ["fused_scan_agg"], expect_p9)
    check_q1(rows, q1_want, "P9 default confs")
    dec = decisions_of(seen)
    reads = [d["reads"] for d in dec if d["decision"] == "partition_coalesce"]
    if reads != [1]:
        raise AssertionError(f"P9: decisions {dec}")
    recs["P9"] = {"decisions": dec, "reads": reads[0], "ms": ms}
    launches["P9_default"] = counts
    print(f"P9 at the default confs: {P_PARTS} partitions read as "
          f"{reads[0]} coalesced stream(s) ({dec}); {ms:.1f} ms; launches "
          f"{counts}")

    # P16 at the default confs: its decision and the measured build bytes
    sess = sm.session.TpuSession(a9b_conf(P16_CONF, history_dir), dev)
    df = q4_df(sm, sess, jb, False, sort=False)
    wrappers = zero_launches()
    t0 = time.perf_counter()
    with event_spy(("adaptive_replan",)) as seen:
        rows = df.collect()
    ms = (time.perf_counter() - t0) * 1e3
    governed += 1
    sorted_rows(q4_want)(rows, "P16 default confs")
    dec = decisions_of(seen)
    recs["P16"] = {"decisions": dec, "ms": ms,
                   "launches": {k: w.launches for k, w in wrappers.items()}}
    launches["P16_default"] = recs["P16"]["launches"]
    conv = [d for d in dec if d["decision"] == "single_build_convert"]
    print(f"P16 at the default confs: rows equal to q4_oracle in {ms:.1f} ms;"
          f" decisions {dec}"
          + (f"; single build, the lines measured "
             f"{conv[0]['measured_bytes']} bytes under "
             f"{conv[0]['threshold']}" if conv else
             "; no conversion (the lines measured over the cap)")
          + f"; launches {recs['P16']['launches']}")

    # P35's P16 under one shuffle.decode corrupt fault: recovered in place
    rec0 = lifecycle.counters()["partition_recompute"]
    conf = a9b_conf(P16_CONF, history_dir, **{
        "spark.rapids.tpu.task.maxAttempts": "3",
        "spark.rapids.tpu.test.faults": P38_DECODE_FAULT})
    df = q4_df(sm, sm.session.TpuSession(conf, dev), jb, False, sort=False)
    with event_spy(("partition_recompute",)) as seen:
        run = retry_run("P35 P16 decode fault", df, sorted_rows(q4_want))
    governed += 1
    run["recomputes"] = lifecycle.counters()["partition_recompute"] - rec0
    if run["attempts"] != 1 or run["recomputes"] != 1 \
            or run["faults"].get("shuffle.decode") != 1:
        raise AssertionError(f"P35 P16 decode fault: {run}")
    recs["P35_P16_decode"] = run
    launches["P35_P16_decode"] = run["launches"]
    print(f"P35 P16 under one shuffle.decode corrupt fault: rows equal to "
          f"q4_oracle after {run['attempts']} attempt, "
          f"{run['recomputes']} partition_recompute "
          f"({[f['map_path'] for _, f in seen]}); {run['ms']:.1f} ms; "
          f"launches {run['launches']}")

    # P38 split under one skew-split sub-read fault
    faults.install(P38_SKEW_FAULT)
    try:
        rec, _ = drive_p38("P38 split, skew_split fault",
                           p38_plan(pd, orders, dev, P38_CONFS["split"]),
                           p38_want)
        fired = faults.stats()
    finally:
        faults.install(None)
    if rec["recomputes"] != 1 or fired.get("shuffle.skew_split") != 1:
        raise AssertionError(f"P38 split fault: {rec}, {fired}")
    recs["P38_split_fault"] = {k: rec[k] for k in (
        "ms", "recomputes", "launches", "decisions")}
    launches["P38_split_fault"] = rec["all_launches"]
    print(f"P38 split under one shuffle.skew_split corrupt fault: rows equal "
          f"to the oracle, {rec['recomputes']} map output recomputed; "
          f"{rec['ms']:.1f} ms; launches {rec['launches']}")

    # P38 split under speculation with one fetch straggler: its duplicate
    # must win, and the straggling fetch must resolve well inside the delay
    # (its wait: the bound, then the race past it)
    before = speculation_shield.counters()
    retries0 = task_retry.task_retry_total()
    faults.install(f"shuffle.fetch:prob=1,seed=38,kind=delay,"
                   f"ms={P38_SPEC_DELAY_MS},max=1")
    try:
        rec, _ = drive_p38("P38 split, speculation",
                           p38_plan(pd, orders, dev, dict(
                               P38_CONFS["split"], **{
                                   "spark.rapids.tpu.shuffle.speculation."
                                   "enabled": "true"})), p38_want)
        fired = faults.stats()
    finally:
        faults.install(None)
    shield = {k: v - before[k]
              for k, v in speculation_shield.counters().items()}
    waits = [e["bound_ms"] + e["wait_ms"] for e in rec["spec_events"]
             if e["winner"] == "spec"]
    if not waits or shield["spec_wins"] < 1 \
            or task_retry.task_retry_total() != retries0 \
            or fired.get("shuffle.fetch") != 1 \
            or max(waits) >= P38_SPEC_DELAY_MS // 2:
        raise AssertionError(f"P38 speculation: {shield}, {fired}, events "
                             f"{rec['spec_events']}")
    recs["P38_speculation"] = {"ms": rec["ms"], "shield": shield,
                               "straggler_wait_ms": waits,
                               "events": rec["spec_events"],
                               "launches": rec["launches"]}
    launches["P38_speculation"] = rec["all_launches"]
    print(f"P38 split under speculation, one {P38_SPEC_DELAY_MS} ms fetch "
          f"straggler: rows equal to the oracle in {rec['ms']:.1f} ms; the "
          f"straggling fetch resolved in {waits} ms (the duplicate won); "
          f"shield {shield}; events {rec['spec_events']}; 0 plan retries")

    # P11 under the watchdog
    recs["P11_stalls"] = drive_p11_stalls(dev, sm, d3, q3_want, history_dir)
    governed += len(STALL_ACTIONS)

    # q3 under the dispatch hang bound, against none, in turns
    o_schema, l_schema = q3_schemas("LONG")
    q3o = q3_batches(d3, dev, o_schema, Q3_ORDERS)
    q3l = q3_batches(d3, dev, l_schema, Q3_LINES)
    dfs = {on: q3_df(sm, sm.session.TpuSession(a9b_conf(
        Q3_CONF, history_dir, **({"spark.rapids.tpu.dispatch.timeoutMs":
                                  str(P38_TIMEOUT_MS)} if on else {})),
        dev), q3o, q3l) for on in (True, False)}
    before = speculation_shield.counters()["dispatch_timeouts"]
    q3_ms = {True: [], False: []}
    for i in range(P38_Q3_RUNS):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = dfs[on].collect()
            q3_ms[on].append((time.perf_counter() - t0) * 1e3)
            governed += 1
            check_q3(rows, q3_want, f"q3 dispatch bound {on}")
    timeouts = speculation_shield.counters()["dispatch_timeouts"] - before
    if timeouts:
        raise AssertionError(f"q3: {timeouts} dispatch timeouts")
    recs["q3_dispatch_bound"] = {"timeout_ms": P38_TIMEOUT_MS,
                                 "bounded_ms": q3_ms[True],
                                 "unbounded_ms": q3_ms[False],
                                 "timeouts": timeouts}
    print(f"q3 with dispatch.timeoutMs {P38_TIMEOUT_MS}: ms "
          f"{[round(x, 2) for x in q3_ms[True]]}, without "
          f"{[round(x, 2) for x in q3_ms[False]]} (in turns); 0 timeouts")

    # P2's injected split under a governed query: the batch target halves
    conf = RapidsConf(Q3_CONF)
    set_active_conf(conf)
    before = adaptive.counters()["batch_right_sizes"]
    try:
        with lifecycle.governed(conf) as ctx:
            M.register_task(1)
            M.force_split_and_retry_oom(1)
            rows = q3_plan(d3, dev, "LONG", P2_LINE_BATCHES).collect()
            target = ctx.adaptive_batch_target
    finally:
        set_active_conf(RapidsConf())
    check_q3(rows, q3_want, "P2 injected split")
    _, splits = M.task_retry_counts()
    from spark_rapids_tpu_torch.config import BATCH_SIZE_BYTES
    full = conf.get(BATCH_SIZE_BYTES)
    sizes = adaptive.counters()["batch_right_sizes"] - before
    if sizes != 1 or target != full // 2:
        raise AssertionError(f"P2: {sizes} right-sizings, target {target}")
    check_idle("P2 injected split")
    recs["P2_right_size"] = {"batch_right_sizes": sizes,
                             "target_bytes": [full, target]}
    print(f"P2 with one injected split in a governed query: rows equal to "
          f"the oracle; 1 batch_right_size, the coalesce target {full} -> "
          f"{target} bytes")

    # one capsule per governed query of the phase
    caps = []
    for name in sorted(os.listdir(history_dir)):
        with open(os.path.join(history_dir, name)) as f:
            caps.extend(json.loads(line) for line in f if line.strip())
    history.reset_history()
    if len(caps) != governed:
        raise AssertionError(f"history: {len(caps)} capsules for "
                             f"{governed} governed queries")
    recs["history"] = {"capsules": len(caps),
                       "fingerprints": len({c["fingerprint"] for c in caps}),
                       "ok": sum(1 for c in caps if c["ok"])}
    print(f"history: {len(caps)} capsules for {governed} governed queries "
          f"({recs['history']['fingerprints']} plan fingerprints, "
          f"{recs['history']['ok']} ok)")
    return recs, launches


def p38_join_inputs(plan, convert):
    """JoinInputs of a P38 plan's join: with `convert`, the converted
    pass's one build over every orders partition and the lines' first
    batch; else the split's hot probe window (the first sub-read batch of
    the partition with the most stream rows, against that partition's
    build). The exchanges' files go when their streams close."""
    j = p11_join(plan)
    if convert:
        return single_build_inputs(j)
    j.stamp_inputs()
    lit_ = j.children[0].execute_partitions()
    rit = j.children[1].execute_partitions()
    best = (0, None, None)
    try:
        for lp, rp in zip(lit_, rit):
            first, n = None, 0
            for b in lp:
                if first is None and b.num_rows_host:
                    first = b
                n += b.num_rows_host
            if n > best[0]:
                best = (n, [b for b in rp if b.num_rows_host], first)
            else:
                rp.close()
    finally:
        lit_.close()
        rit.close()
    _, build, stream = best
    j._rscan.set_batches(build)
    j._lscan.set_batches([stream])
    return JoinInputs(j._join)


def compare_p38(pd, orders, dev):
    """Phase 2 for P38: every row gather of a run of the split and the
    converted plans, and the join's kernels (murmur3 chain, probe) at the
    split's hot probe window and at the converted pass's one build over
    the whole orders side, each against its plain version."""
    for kind in ("split", "convert"):
        gathers = capture_row_gathers(p38_plan(pd, orders, dev,
                                               P38_CONFS[kind]))
        inputs = p38_join_inputs(p38_plan(pd, orders, dev, P38_CONFS[kind]),
                                 kind == "convert")
        compare_join_inputs(f"P38 {kind}", inputs, gathers)
        del inputs, gathers
    shuffle_root_empty("P38 phase 2")


# -- phase 3l: the stage compiler, one CUDA graph per stage step (P39) --------

#: P39's timed pairs per path: fusion on and off in turns, one
#: synchronisation a run
P39_PAIRS = 5
#: P39's timed cold pairs per path, each run from an emptied site cache
P39_COLD_PAIRS = 3
#: the map path's second filter keeps l_price * (1 - l_disc) above this
P39_REV_FLOOR = 900.0
FUSION_OFF = {"spark.rapids.tpu.stage.fusion.enabled": "false"}
#: the stage counters a P39 run reports as deltas
STAGE_DELTAS = ("executions", "fallbacks", "graph_captures", "graph_replays",
                "eager_steps", "cold_sizings", "cache_hits", "cache_misses",
                "batches")


def map_path_df(m, sess, line_batches):
    """P39's map path: q3's lineitems filtered on l_flag, projected to
    (l_orderkey, rev), filtered on rev, the top 10 by rev: a
    Filter/Project/Filter chain under a TopN (a sort), one map stage."""
    col, lit = m.core.col, m.core.lit
    return (sess.from_batches(line_batches, line_batches[0].schema)
            .filter(col("l_flag") != lit(0))
            .select(col("l_orderkey"),
                    (col("l_price") * (lit(1.0) - col("l_disc")))
                    .alias("rev"))
            .filter(col("rev") > lit(P39_REV_FLOOR))
            .sort((col("rev"), False)).limit(10))


def map_path_oracle(d):
    """numpy's top 10 of the map path: (l_orderkey, rev), rev descending."""
    rev = d["l_price"] * (1.0 - d["l_disc"])
    sel = (d["l_flag"] != 0) & (rev > P39_REV_FLOOR)
    keys, revs = d["l_orderkey"][sel], rev[sel]
    top = np.argsort(-revs, kind="stable")[:10]
    return [(int(keys[i]), float(revs[i])) for i in top]


def check_map_path(rows, want, label):
    """Keys and revenues exact: one multiply and one subtract per row, in
    the same order as numpy's."""
    got = [(int(k), v) for k, v in rows]
    if got != want:
        raise AssertionError(f"{label}: top 10 {got} != oracle {want}")


def stage_shapes(tree):
    """A plan's compiled stages in tree order: (kind, absorbed classes)."""
    return [(n._kind, [type(o).__name__ for o in n._absorbed])
            for n in exec_nodes(tree)
            if type(n).__name__ == "CompiledStageExec"]


def counted_run(fn):
    """fn() with every launch counter at 0 just before and read just
    after, and the host reads it made (CUDA's sync debug mode warns on
    each): (fn's result, launches, host reads)."""
    import warnings
    import torch
    wrappers = zero_launches()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counts = {k: w.launches for k, w in wrappers.items()}
    return out, counts, sum("synchroniz" in str(w.message) for w in caught)


def p39_collect(label, df, check):
    """One df.collect() counted: every launch counter at 0 just before,
    the host reads (CUDA's sync debug mode warns on each), the stage
    compiler's counters as deltas. Returns (launches, host reads, stage
    deltas)."""
    from spark_rapids_tpu_torch.exec import stage_compiler
    c0 = stage_compiler.counters()
    rows, counts, reads = counted_run(df.collect)
    c1 = stage_compiler.counters()
    check(rows, label, df.session.last_query_metrics())
    delta = {k: c1[k] - c0[k] for k in STAGE_DELTAS}
    for k in ("graph_ineligible", "sizing_launches"):
        delta[k] = {n: v - c0[k].get(n, 0) for n, v in c1[k].items()
                    if v != c0[k].get(n, 0)}
    delta["graph_pool_bytes"] = c1["graph_pool_bytes"]
    return counts, reads, delta


def drive_stage_paths(paths):
    """Phase 3l (P39): each path planned at the default confs (fusion on)
    beside its twin with stage.fusion.enabled=false. Per path: its stages
    (kind and absorbed operators); a cold collect() (the graphs captured),
    the twin's, a warm collect() (no capture: every graph step replayed),
    each against its oracle with its launches and host reads; the warm
    run's launches equal the twin's (a map stage's one compaction per
    input batch less, where the twin's filters each compacted), the cold
    run's exceed the warm run's by exactly its sizing passes' launches;
    a warm collect() traced, whose device kernels must equal the launches
    the counters recorded (the graph replays' included); then P39_PAIRS
    timed warm pairs in turns, and P39_COLD_PAIRS cold pairs, each run
    after the site cache and the join sizes were emptied (fusion on pays
    its sizing pass and its captures: `capture_ns`).
    Each path starts with the site cache and the join size caches empty.
    `paths` maps a label to (make_df(conf), check, need, kind). Returns
    (records, launches by run)."""
    import torch
    from spark_rapids_tpu_torch.exec import stage_compiler
    from spark_rapids_tpu_torch.obs import dispatch
    recs, launches = {}, {}
    for label, (make, check, need, kind) in paths.items():
        # cold for this path: the earlier phases' collects of equal plans
        # left their sites, graphs and join sizes cached
        dispatch.reset_site_cache()
        stage_compiler.reset_stage_counters()
        on, off = make({}), make(FUSION_OFF)
        print(f"P39 {label} explain:\n{on.explain()}")
        shapes = stage_shapes(on._exec())
        if kind not in [k for k, _ in shapes] or stage_shapes(off._exec()):
            raise AssertionError(f"P39 {label}: stages {shapes}, want a "
                                 f"{kind} stage with fusion on only")
        cold, cold_reads, cold_st = p39_collect(f"P39 {label} cold", on,
                                                check)
        twin, twin_reads, twin_st = p39_collect(f"P39 {label} off", off,
                                                check)
        warm, warm_reads, warm_st = p39_collect(f"P39 {label} warm", on,
                                                check)
        _, traced_rec, traced = traced_check(
            f"P39 {label} warm", lambda: check(
                on.collect(), f"P39 {label} traced",
                on.session.last_query_metrics()))
        if traced_rec != warm:
            raise AssertionError(f"P39 {label}: the traced warm run "
                                 f"launched {traced_rec}, the warm run "
                                 f"{warm}")
        idle = [k for k in need if warm[k] < 1 or twin[k] < 1]
        if idle:
            raise AssertionError(f"P39 {label}: kernels not launched: "
                                 f"{idle} (on {warm}, off {twin})")
        # a map stage compacts once where each of the chain's filters
        # compacted (one packed row gather each, per input batch)
        saved = (len([op for op in shapes[0][1] if op == "FilterExec"]) - 1) \
            * warm_st["batches"] if kind == "map" else 0
        if warm != dict(twin, dma_row_gather=twin["dma_row_gather"] - saved):
            raise AssertionError(f"P39 {label}: warm launches {warm} != "
                                 f"the per-operator twin's {twin} less "
                                 f"{saved} compactions")
        sized = {k: warm[k] + cold_st["sizing_launches"].get(k, 0)
                 for k in warm}
        if cold != sized:
            raise AssertionError(f"P39 {label}: cold launches {cold} != "
                                 f"the twin's plus its sizing passes' "
                                 f"{cold_st['sizing_launches']}")
        if twin_st["executions"] or not cold_st["executions"]:
            raise AssertionError(f"P39 {label}: fused executions on "
                                 f"{cold_st['executions']}, off "
                                 f"{twin_st['executions']}")
        if warm_st["graph_captures"] or warm_st["cache_misses"] \
                or not warm_st["graph_replays"]:
            raise AssertionError(f"P39 {label}: the second collect() "
                                 f"captured {warm_st['graph_captures']}, "
                                 f"built {warm_st['cache_misses']} sites, "
                                 f"replayed {warm_st['graph_replays']}")
        ms = {"on": [], "off": []}
        for i in range(P39_PAIRS):
            for k in (("on", "off") if i % 2 == 0 else ("off", "on")):
                df = on if k == "on" else off
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rows = df.collect()
                torch.cuda.synchronize()
                ms[k].append((time.perf_counter() - t0) * 1e3)
                check(rows, f"P39 {label} timed {k}",
                      df.session.last_query_metrics())
        graphs = dispatch.cached_graphs()
        cold_ms = {"on": [], "off": []}
        capture_ms = []
        for i in range(P39_COLD_PAIRS):
            for k in (("on", "off") if i % 2 == 0 else ("off", "on")):
                df = on if k == "on" else off
                dispatch.reset_site_cache()
                stage_compiler.reset_stage_counters()
                g0 = dispatch.graph_counters()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rows = df.collect()
                torch.cuda.synchronize()
                cold_ms[k].append((time.perf_counter() - t0) * 1e3)
                check(rows, f"P39 {label} timed cold {k}",
                      df.session.last_query_metrics())
                if k == "on":
                    capture_ms.append((dispatch.graph_counters()[
                        "capture_ns"] - g0["capture_ns"]) / 1e6)
        check_idle(f"P39 {label}")
        per_replay = [(g["label"], g["kernels"], g["pool_bytes"])
                      for g in graphs]
        recs[label] = {
            "stages": shapes, "compactions_saved": saved, "graphs": graphs,
            "launches_cold": cold, "launches_warm": warm,
            "launches_off": twin, "host_reads_cold": cold_reads,
            "host_reads_warm": warm_reads, "host_reads_off": twin_reads,
            "stage_cold": cold_st, "stage_warm": warm_st, "ms": ms,
            "launches_traced": traced, "cold_ms": cold_ms,
            "capture_ms": capture_ms}
        launches[f"P39_{label}_warm"] = traced
        launches[f"P39_{label}_off"] = twin
        print(f"P39 {label}: stages {shapes}; rows equal to the oracle on "
              f"and off; launches warm {warm} == off; cold {cold} (its "
              f"sizing passes {cold_st['sizing_launches']}); cold: "
              f"captures {cold_st['graph_captures']}, replays "
              f"{cold_st['graph_replays']}, eager steps "
              f"{cold_st['graph_ineligible']}; warm (second collect): "
              f"captures {warm_st['graph_captures']}, replays "
              f"{warm_st['graph_replays']}, eager steps "
              f"{warm_st['graph_ineligible']}; graph pools "
              f"{warm_st['graph_pool_bytes']} bytes; launches a replay "
              f"(site, launches, pool bytes) {per_replay}; host reads cold "
              f"{cold_reads}, warm {warm_reads}, off {twin_reads}; ms on "
              f"{[round(x, 3) for x in ms['on']]}, off "
              f"{[round(x, 3) for x in ms['off']]}; traced warm run's "
              f"device kernels {traced} == its counters; cold ms on "
              f"{[round(x, 3) for x in cold_ms['on']]} (captures "
              f"{[round(x, 3) for x in capture_ms]} ms of them), off "
              f"{[round(x, 3) for x in cold_ms['off']]}" + (
                  f"; the stage compacted once where the twin's filters "
                  f"made {saved} more packed row gathers" if saved else ""))
    return recs, launches


def drive_stage_budget(sm, dev, d3, q3_want, rec):
    """P39 q3 under P2's device budget and host limit (16 lineitem
    batches, the exact tier, through the session): the graphs' pools
    count against the budget, so a graph the budget cannot hold after its
    spills is not kept and its key's steps run eagerly ("graph pool over
    the device budget"). Rows equal to the oracle; every graph step either
    captured and kept within the budget or counted over it; prints the
    captures, replays, the steps over the budget, the pools and the
    catalog's hops. Returns a record."""
    from spark_rapids_tpu_torch import memory as M
    from spark_rapids_tpu_torch.config import RapidsConf, set_active_conf
    from spark_rapids_tpu_torch.exec import stage_compiler
    from spark_rapids_tpu_torch.obs import dispatch
    dispatch.reset_site_cache()
    stage_compiler.reset_stage_counters()
    df = p2_session_df(sm, dev, d3, dict(Q3_CONF, **{
        "spark.rapids.memory.tpu.budgetBytes": str(rec["budget"]),
        "spark.rapids.memory.host.spillStorageSize": str(rec["host_limit"])}))
    # the budget and the catalog read the session's conf when made
    M.reset_memory_budget()
    M.reset_buffer_catalog()
    try:
        retries0, splits0 = M.task_retry_counts()
        graphs0 = dispatch.graph_counters()
        t0 = time.perf_counter()
        rows = df.collect()
        ms = (time.perf_counter() - t0) * 1e3
        check_q3(rows, q3_want, "P39 q3 under P2's budget")
        retries, splits = (n - n0 for n, n0 in zip(M.task_retry_counts(),
                                                   (retries0, splits0)))
        st = stage_compiler.counters()
        cat = M.buffer_catalog().counters()
        graphs = {k: v - graphs0[k]
                  for k, v in dispatch.graph_counters().items()}
    finally:
        set_active_conf(RapidsConf())
        M.reset_buffer_catalog()
        M.reset_memory_budget()
        dispatch.reset_site_cache()
    over = st["graph_ineligible"].get(dispatch.OVER_BUDGET, 0)
    if graphs["pool_bytes"] > rec["budget"] or not (
            graphs["captures"] or over):
        raise AssertionError(f"P39 q3 under P2's budget: graphs {graphs}, "
                             f"steps over the budget {over}")
    out = {"budget": rec["budget"], "ms": ms, "retries": retries,
           "splits": splits, "graphs": graphs, "over_budget_steps": over,
           "spills": cat, "eager_steps": st["graph_ineligible"]}
    print(f"P39 q3 under P2's budget ({rec['budget']} bytes): rows equal to "
          f"the oracle in {ms:.1f} ms; {splits} split(s), {retries} "
          f"retries; graphs captured {graphs['captures']}, not kept (over "
          f"the budget) {graphs['over_budget']}, replayed "
          f"{graphs['replays']}, dropped {graphs['dropped']}; eager steps "
          f"{st['graph_ineligible']}; catalog {cat}")
    return out


# -- slice 18 (phase 3m): the file lane, P40 ---------------------------------

P40_RUNS = 3             # timed runs of each P40 query and its twin, in turns
P40_PATHS = ("P40 avro", "P40 hive")


class SizedHostSource(HostSource):
    """A HostSource with a planner estimate: the bytes of the same batch
    on the card, so that the planner sizes a join side of host data as it
    sizes the twin's in-memory batch."""

    def __init__(self, schema, parts, device, nbytes):
        super().__init__(schema, parts, device)
        self._nbytes = nbytes

    def estimated_size_bytes(self):
        return self._nbytes


def numpy_scan_df(sess, cols, twin, dev):
    """A DataFrame over one host batch of the numpy columns `cols`, typed
    and sized as the device batch `twin`: its scan builds the host columns
    and uploads them in one packed copy each run."""
    from spark_rapids_tpu_torch.columnar.column import Column, bucket_capacity
    from spark_rapids_tpu_torch.plan import logical as L
    schema, n = twin.schema, twin.num_rows_host
    cap = bucket_capacity(n)

    def part():
        return ([Column.from_numpy(np.asarray(cols[f.name]), f.data_type,
                                   capacity=cap, device="cpu")
                 for f in schema.fields], n)
    return sess._df(L.LogicalScan(SizedHostSource(schema, [part], dev,
                                                  twin.nbytes)))


def same_table(label, got, want):
    """The batches read back from a file, concatenated, against the batch
    that was written, column for column on the card: every validity bit,
    every valid fixed-width value, every string's offsets and bytes (the
    written batch's dictionary columns decoded first)."""
    import torch
    from spark_rapids_tpu_torch.columnar.encoded import materialize_batch
    from spark_rapids_tpu_torch.exec.coalesce import concat_batches
    got = got[0] if len(got) == 1 else concat_batches(got, want.schema)
    want = materialize_batch(want)
    n = want.num_rows_host
    if got.num_rows_host != n or got.schema.names != want.schema.names:
        raise AssertionError(f"{label}: read back {got.num_rows_host} rows "
                             f"of {got.schema.names}, wrote {n} of "
                             f"{want.schema.names}")
    for f, a, b in zip(want.schema.fields, got.columns, want.columns):
        va, vb = a.validity[:n], b.validity[:n]
        same = torch.equal(va, vb)
        if hasattr(b, "offsets"):
            oa, ob = a.offsets[: n + 1].long(), b.offsets[: n + 1].long()
            la, lb = int(oa[0]), int(ob[0])
            same = same and torch.equal(oa - la, ob - lb) and torch.equal(
                a.data[la: int(oa[n])], b.data[lb: int(ob[n])])
        else:
            same = same and torch.equal(
                torch.where(va, a.data[:n], torch.zeros_like(a.data[:n])),
                torch.where(vb, b.data[:n], torch.zeros_like(b.data[:n])))
        if not same:
            raise AssertionError(f"{label}: column {f.name} read back "
                                 f"differs from the batch written")


def file_inputs(dev, sm, dj, jb, q3d, tb, workdir):
    """P40's files, written by the port's writers under `workdir` and read
    back once through the session's readers on the card (set-up: phase 2
    holds the kernels at the read-back tables' shapes): P40 avro, P12's
    SF1 orders (all four columns) by `write_avro(path, codec="deflate")`;
    P40 hive, P19's 150,000 customers by `write_hive_text`. Each read-back
    equals its input column for column. Returns {path: record}, each with
    the write ms and file bytes, the read ms split into the host decode,
    the host build of the columns and the upload (the rest of the read's
    wall, its copy waited for), and the read-back batches."""
    import os
    import torch
    TpuSession = sm.session.TpuSession
    sess = TpuSession(device=dev)
    t = sm.t
    cust = tb["q3"]["customer"]
    tables = {
        "P40 avro": (jb["orders"], os.path.join(workdir, "orders.avro"),
                     lambda df, p: df.write_avro(p, codec="deflate"),
                     lambda p: sess.read_avro(p)),
        "P40 hive": (cust, os.path.join(workdir, "customer.txt"),
                     lambda df, p: df.write_hive_text(p),
                     lambda p: sess.read_hive_text(p, t.Schema(tuple(
                         t.StructField(f.name, f.data_type)
                         for f in cust.schema.fields))))}
    out = {}
    for label, (batch, path, write, read) in tables.items():
        df = sess.from_batches([batch], batch.schema)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        write(df, path)
        write_ms = (time.perf_counter() - t0) * 1e3
        src = read(path)._plan.source
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = list(src.batches())
        torch.cuda.synchronize()
        read_ms = (time.perf_counter() - t0) * 1e3
        st = dict(src.scan_stats)
        same_table(label, back, batch)
        places = {t.device.type for b in back for c in b.columns
                  for t in c.leaves()}
        if places != {torch.device(dev).type}:
            raise AssertionError(f"{label}: read-back leaves on {places}, "
                                 f"the session's device is {dev}")
        decode_ms, build_ms = st["decode_ns"] / 1e6, st["build_ns"] / 1e6
        rec = {"path": path, "rows": st["rows"], "batches": st["batches"],
               "write_ms": write_ms, "file_bytes": os.path.getsize(path),
               "read_ms": read_ms, "decode_ms": decode_ms,
               "build_ms": build_ms,
               "upload_ms": read_ms - decode_ms - build_ms,
               "upload_enqueue_ms": st["upload_ns"] / 1e6,
               "back": back, "schema": back[0].schema}
        print(f"{label}: wrote {batch.num_rows_host} rows "
              f"({', '.join(batch.schema.names)}) in {write_ms:.1f} ms, "
              f"{rec['file_bytes']} bytes; read back {st['rows']} rows in "
              f"{st['batches']} batch(es) in {read_ms:.1f} ms (host decode "
              f"{decode_ms:.1f}, host build {build_ms:.1f}, upload "
              f"{rec['upload_ms']:.1f}); equal to the input column for "
              f"column")
        out[label] = rec
    return out


def file_dfs(sm, dev, fi, dj, jb, q3d, tb):
    """{P40 path: make(kind)} of the P40 queries. Kind "file" reads the
    file through the session's reader (P40 avro's orders, P40 hive's
    customers) beside the other tables as host numpy batches; "back" takes
    the file's table as read back once (file_inputs) beside the same host
    batches (phase 2 captures its kernels' inputs: the file's shapes,
    without a second decode); "read" takes it beside the twin's device
    batches; "twin" is the numpy-built twin (P12, P19), every table a
    device batch."""
    TpuSession = sm.session.TpuSession
    q3 = tb["q3"]
    q3np = q3_types_tables(dj, q3d)
    lines = {k: dj[k] for k, _, _ in JOIN_TABLES["lineitem"]}

    def table(sess, label, kind):
        rec = fi[label]
        if kind == "file":
            return sess.read_avro(rec["path"]) if label == "P40 avro" \
                else sess.read_hive_text(rec["path"], rec["schema"])
        return sess.from_batches(rec["back"], rec["schema"])

    def avro(kind):
        sess = TpuSession(device=dev)
        if kind == "twin":
            return q4_df(sm, sess, jb)
        frames = {"orders": table(sess, "P40 avro", kind)}
        if kind != "read":
            frames["lineitem"] = numpy_scan_df(sess, lines, jb["lineitem"],
                                               dev)
        return q4_df(sm, sess, jb, frames=frames)

    def hive(kind):
        sess = TpuSession(P19_CONF, dev)
        if kind == "twin":
            return q3_types_df(sm, sess, q3)
        frames = {"customer": table(sess, "P40 hive", kind)}
        if kind != "read":
            frames.update({k: numpy_scan_df(sess, q3np[k], q3[k], dev)
                           for k in ("orders", "lineitem")})
        return q3_types_df(sm, sess, q3, frames=frames)
    return {"P40 avro": avro, "P40 hive": hive}


def compare_file_paths(dev, sm, fi, dj, jb, q3d, tb):
    """Phase 2 at P40's own inputs: every murmur3 chain, probe and row
    gather launch of a run of each P40 query (its file's table as read
    back, the other tables as host numpy batches: phase 3m's shapes), each
    held exactly to its plain version."""
    from spark_rapids_tpu_torch.ops import murmur3_lanes as m3
    dfs = file_dfs(sm, dev, fi, dj, jb, q3d, tb)
    for label in P40_PATHS:
        def fresh():
            return planned(sm, dfs[label]("back"))[0]
        gathers = capture_row_gathers(fresh())
        print(f"compare {label} main-path row gathers: "
              f"{'; '.join(compare_row_gathers(label, gathers))}; exact")
        del gathers
        calls = capture_murmur3(fresh())
        for k, (cols, seeds) in enumerate(calls):
            _exact(f"murmur3 {label} call {k}",
                   m3.murmur3_columns(cols, seeds),
                   m3.murmur3_columns_plain(cols, seeds))
        probes = capture_probes(fresh())
        hits = [compare_probe(f"probe {label} call {k}", args, cap, total)
                for k, (args, cap, total) in enumerate(probes)]
        if not calls or not probes:
            raise AssertionError(f"{label}: {len(calls)} murmur3 and "
                                 f"{len(probes)} probe launches captured")
        print(f"compare {label} main-path murmur3 launches ({len(calls)}) "
              f"and probes ({len(probes)}, {sum(hits)} verified pairs); "
              f"exact")


def file_launch_notes(label, file_counts, twin_counts, batches):
    """Each kernel whose launches on the file's run differ from the twin's,
    named with what the file's table changes: its strings arrive as plain
    StringColumns (the twin's dictionary columns take by code through
    dict_gather), and its read's batches."""
    notes = []
    for name in sorted(file_counts):
        a, b = file_counts[name], twin_counts[name]
        if a == b:
            continue
        if name == "dict_gather" and a < b:
            why = ("the twin's dictionary-encoded string filter takes by "
                   "code; the file's plain strings compare bytes")
        else:
            why = (f"the file's table arrives as {batches} batch(es), the "
                   f"twin's as one")
        notes.append(f"{name} {a} (twin {b}): {why}")
    return notes


def drive_file_paths(dev, sm, fi, dj, jb, q3d, tb, wants):
    """Phase 3m (P40): each P40 query planned at its twin's confs. The
    twin's collect() and then the file query's, each from an emptied site
    cache (cold: a join_agg stage pays its sizing pass in both), counted
    (every launch counter at 0 just before, read just after, the host
    reads by CUDA's sync debug mode), each held to its oracle; the file's
    run reads its file inside the query. Then P40_RUNS timed pairs in
    turns of the query over the table read back once ("read") against the
    twin, one synchronisation a run. Returns (records, launches by
    run)."""
    import torch
    from spark_rapids_tpu_torch.columnar import encoded
    from spark_rapids_tpu_torch.exec import stage_compiler
    from spark_rapids_tpu_torch.obs import dispatch
    dfs = file_dfs(sm, dev, fi, dj, jb, q3d, tb)
    recs, launches = {}, {}
    for label in P40_PATHS:
        want = wants[label]
        make = dfs[label]
        counted = {}
        for kind in ("twin", "file"):
            dispatch.reset_site_cache()
            stage_compiler.reset_stage_counters()
            df = make(kind)
            if kind == "file":
                print(f"{label} explain:\n{df.explain()}")
            m0 = encoded.counters()["materializations"]
            t0 = time.perf_counter()
            c, reads, st = p39_collect(f"{label} {kind}",
                                       df, exact_rows(want))
            ms = (time.perf_counter() - t0) * 1e3
            st["materializations"] = \
                encoded.counters()["materializations"] - m0
            counted[kind] = (c, reads, st, ms, df)
        fc, freads, fst, fms, fdf = counted["file"]
        tc, treads, tst, tms, _ = counted["twin"]
        idle = [k for k in Q_NEED if fc[k] < 1]
        if idle:
            raise AssertionError(f"{label}: kernels not launched: {idle} "
                                 f"(counts {fc})")
        src = fdf._plan
        while not hasattr(src, "source"):
            src = src.children[0]
        scan = dict(src.source.scan_stats)
        notes = file_launch_notes(label, fc, tc, scan["batches"])
        launches[label.replace(" ", "_")] = fc
        launches[label.replace(" ", "_") + "_twin"] = tc
        ms = {"read": [], "twin": []}
        runs = {"read": make("read"), "twin": make("twin")}
        for i in range(P40_RUNS):
            for kind in (("read", "twin") if i % 2 == 0
                         else ("twin", "read")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rows = runs[kind].collect()
                torch.cuda.synchronize()
                ms[kind].append((time.perf_counter() - t0) * 1e3)
                exact_rows(want)(rows, f"{label} timed {kind}")
        recs[label] = {
            "rows": want, "file_run_ms": fms, "twin_run_ms": tms,
            "file_scan": {k: scan[k] for k in ("rows", "batches")},
            "file_scan_ms": {k.replace("_ns", "_ms"): scan[k] / 1e6
                             for k in ("decode_ns", "build_ns",
                                       "upload_ns")},
            "launches": fc, "twin_launches": tc, "differences": notes,
            "host_reads": freads, "twin_host_reads": treads,
            "stages": fst, "twin_stages": tst, "ms": ms,
            **{k: v for k, v in fi[label].items()
               if k not in ("back", "schema")}}
        print(f"{label}: rows equal to the oracle {want[:3]}...; the file's "
              f"collect() {fms:.1f} ms (its read: {scan['rows']} rows in "
              f"{scan['batches']} batch(es), host decode "
              f"{scan['decode_ns'] / 1e6:.1f} ms, host build "
              f"{scan['build_ns'] / 1e6:.1f} ms), the twin's {tms:.1f} ms; "
              f"launches {fc}, twin {tc}; host reads {freads}, twin "
              f"{treads}; dictionary columns decoded at a boundary "
              f"{fst['materializations']}, twin "
              f"{tst['materializations']}")
        for note in notes:
            print(f"  {label}: {note}")
        print(f"{label} timed, the table read back against the twin, in "
              f"turns: read {['%.2f' % v for v in ms['read']]} ms, twin "
              f"{['%.2f' % v for v in ms['twin']]} ms")
    return recs, launches


# -- slice 19 (phase 3n): Delta's DML plans, P41 -----------------------------

P41_RUNS = 3             # timed runs of each P41 command, in turns
P41_MATCHED = 100_000    # MERGE source rows with an order's o_orderkey
P41_NEW = 50_000         # MERGE source rows with a key above every order's
P41_SEED = 41
P41_UPDATE_BEFORE = datetime.date(1993, 1, 1)   # UPDATE where o_orderdate <
P41_URGENT = "1-URGENT"                          # ... SET o_orderpriority =
P41_COMMANDS = ("P41 delete", "P41 update", "P41 merge", "P41 optimize")
#: the ported kernels each command's run must launch: DELETE's compaction
#: gather, MERGE's join (the murmur3 chain, the probe, the gathers) and
#: OPTIMIZE's sort permutation gather; UPDATE's filter count and If
#: projection have none of the port's kernels on their path
P41_NEED = {"P41 delete": ["dma_row_gather"], "P41 update": [],
            "P41 merge": Q_NEED, "P41 optimize": ["dma_row_gather"]}


def p41_source(dj, matched=P41_MATCHED, new=P41_NEW, seed=P41_SEED):
    """MERGE's source in tpch_join_data's form: `matched` o_orderkeys of
    the orders chosen by seed and `new` keys above the largest, shuffled,
    each with a random date, priority and status."""
    rng = np.random.default_rng(seed)
    okey = dj["o_orderkey"]
    keys = np.concatenate([
        okey[rng.choice(okey.shape[0], matched, replace=False)],
        okey.max() + 1 + np.arange(new, dtype=np.int64)])
    keys = keys[rng.permutation(keys.shape[0])]
    n = keys.shape[0]
    return {"o_orderkey": keys,
            "o_orderdate": rng.integers(ORDER_DATE_FIRST, ORDER_DATE_LAST + 1,
                                        n).astype(np.int32),
            "o_orderpriority": (rng.integers(0, 5, n).astype(np.int32),
                                ORDER_PRIORITIES),
            "o_orderstatus": (rng.integers(0, 3, n).astype(np.int32),
                              ORDER_STATUSES)}


def first_bytes(column):
    """A (codes, words) string column as each row's first byte (P41's
    words differ in their first byte)."""
    codes, words = column
    return np.array([w.encode()[0] for w in words], np.uint8)[codes]


def p41_table(key, date, prio, status):
    """Rows as columns sorted by key (P41's keys are unique): the order
    of a multiset."""
    o = np.argsort(key, kind="stable")
    return tuple(np.asarray(a)[o] for a in (key, date, prio, status))


def p41_oracles(d, src):
    """{command: {"stats", "rows"[, "inserted"]}} by numpy."""
    k, dt = d["o_orderkey"], d["o_orderdate"]
    pb, sb = first_bytes(d["o_orderpriority"]), first_bytes(d["o_orderstatus"])
    keep = d["o_orderstatus"][0] != ORDER_STATUSES.index("F")
    hit = dt < days(P41_UPDATE_BEFORE)
    sk, sdt = src["o_orderkey"], src["o_orderdate"]
    spb = first_bytes(src["o_orderpriority"])
    ssb = first_bytes(src["o_orderstatus"])
    so = np.argsort(sk)
    pos = np.minimum(np.searchsorted(sk[so], k), sk.shape[0] - 1)
    matched = sk[so][pos] == k
    at = so[pos[matched]]
    m_dt, m_pb = dt.copy(), pb.copy()
    m_dt[matched], m_pb[matched] = sdt[at], spb[at]
    ins = ~np.isin(sk, k)
    return {
        "P41 delete": {"stats": {"deleted": int((~keep).sum())},
                       "rows": p41_table(k[keep], dt[keep], pb[keep],
                                         sb[keep])},
        "P41 update": {"stats": {"updated": int(hit.sum())},
                       "rows": p41_table(k, dt, np.where(
                           hit, np.uint8(P41_URGENT.encode()[0]), pb), sb)},
        "P41 merge": {"stats": {"updated": int(matched.sum()), "deleted": 0,
                                "inserted": int(ins.sum())},
                      "rows": p41_table(k, m_dt, m_pb, sb),
                      "inserted": p41_table(sk[ins], sdt[ins], spb[ins],
                                            ssb[ins])},
        "P41 optimize": {"stats": {"rows": int(k.shape[0])},
                         "rows": p41_table(k, dt, pb, sb)}}


def p41_frames(sm, dev, orders, source):
    """{command: run()} and {command: twin()} of P41 over the card's
    orders batch (phase 3m's P12 table) and MERGE's source batch. A run
    is the command's per-file device work through delta/table.py: DELETE
    the rows `delete_rewrite` keeps (its count from them), UPDATE
    `match_count` and `update_rewrite`, MERGE the ambiguity check
    (`key_rows_max`), `merge_hit_count`, `merge_rewrite` (SET
    o_orderdate and o_orderpriority from the source) and
    `merge_insert_rows`, OPTIMIZE `zorder_rewrite` by o_orderdate; each
    returns (its stats, {"rows": batches[, "inserted": batches]}). A twin
    is the plain filter, filter, left outer join or sort it is built
    from."""
    from spark_rapids_tpu_torch.delta import table as T
    sess = sm.session.TpuSession(device=dev)
    col, lit = sm.core.col, sm.core.lit
    df = sess.from_batches([orders], orders.schema)
    src = sess.from_batches([source], source.schema)
    marked = T.marked_source(src)
    n, on = orders.num_rows_host, ["o_orderkey"]
    gone = col("o_orderstatus") == lit("F")
    early = col("o_orderdate") < date_lit(sm, P41_UPDATE_BEFORE)
    sets = {"o_orderpriority": lit(P41_URGENT)}
    upd = {"o_orderdate": col("__s_o_orderdate"),
           "o_orderpriority": col("__s_o_orderpriority")}

    def rows(batches):
        return sum(b.num_rows_host for b in batches)

    def delete():
        kept = T.delete_rewrite(df, gone)._batches()
        return {"deleted": n - rows(kept)}, {"rows": kept}

    def update():
        hits = T.match_count(df, early)
        return {"updated": hits}, {
            "rows": T.update_rewrite(df, df.schema, sets, early)._batches()}

    def merge():
        if (T.key_rows_max(src, on).collect()[0][0] or 0) > 1:
            raise AssertionError("P41 merge: an ambiguous source")
        hits = T.merge_hit_count(df, marked, on)
        out = T.merge_rewrite(df, marked, on, upd, False)._batches()
        ins = T.merge_insert_rows(src, df, on, df.schema)._batches()
        return {"updated": hits, "deleted": 0, "inserted": rows(ins)}, {
            "rows": out, "inserted": ins}

    def optimize():
        out = T.zorder_rewrite(df, ["o_orderdate"], df.columns)._batches()
        return {"rows": rows(out)}, {"rows": out}
    runs = dict(zip(P41_COMMANDS, (delete, update, merge, optimize)))
    twins = {
        "P41 delete": lambda: df.filter(gone)._batches(),
        "P41 update": lambda: df.filter(early)._batches(),
        "P41 merge": lambda: df.join(
            marked, left_on=on, right_on=["__s_o_orderkey"],
            how="left_outer")._batches(),
        "P41 optimize": lambda: df.sort("o_orderdate")._batches()}
    plans = {
        "P41 delete": [T.delete_rewrite(df, gone)],
        "P41 update": [df.filter(early),
                       T.update_rewrite(df, df.schema, sets, early)],
        "P41 merge": [T.key_rows_max(src, on),
                      df.join(marked.select(col("__s_o_orderkey")),
                              left_on=on, right_on=["__s_o_orderkey"],
                              how="left_semi"),
                      T.merge_rewrite(df, marked, on, upd, False),
                      T.merge_insert_rows(src, df, on, df.schema)],
        "P41 optimize": [T.zorder_rewrite(df, ["o_orderdate"],
                                          df.columns)]}
    return runs, twins, plans


def p41_check(label, want, got):
    """A P41 run's (stats, parts) against its oracle: the stats dict, the
    rows and inserted rows as multisets (every value valid), and
    OPTIMIZE's rows in order of their z-order codes."""
    stats, parts = got
    if stats != want["stats"]:
        raise AssertionError(f"{label}: stats {stats} != oracle "
                             f"{want['stats']}")
    for part, batches in parts.items():
        cols = fetch_columns(batches)
        if not all(c[1].all() for c in cols):
            raise AssertionError(f"{label} {part}: a NULL in the output")
        if label == "P41 optimize":
            code = zorder_codes([cols[1][0]])
            if not (code[1:] >= code[:-1]).all():
                raise AssertionError(f"{label}: z-order codes decrease")
        table = p41_table(*(c[0] for c in cols))
        for name, a, b in zip(("o_orderkey", "o_orderdate",
                               "o_orderpriority", "o_orderstatus"),
                              table, want[part]):
            _equal(f"{label} {part} {name}", a, b)


def compare_delta_paths(dev, sm, orders, source):
    """Phase 2 at P41's own inputs: every row gather of each command's
    plans, MERGE's murmur3 chains and probes (the ambiguity check's
    group-by, the semi join, the left outer join, the anti join) and
    DELETE's dictionary gathers, each held exactly to its plain
    version."""
    from spark_rapids_tpu_torch.ops import murmur3_lanes as m3
    _, _, plans = p41_frames(sm, dev, orders, source)
    for label in P41_COMMANDS:
        n_gathers = 0
        for k, df in enumerate(plans[label]):
            def fresh():
                return planned(sm, df)[0]
            gathers = capture_row_gathers(fresh())
            n_gathers += len(gathers)
            if gathers:
                print(f"compare {label} plan {k} row gathers: "
                      f"{'; '.join(compare_row_gathers(label, gathers))}; "
                      f"exact")
            del gathers
            if label == "P41 merge" and k > 0:
                calls = capture_murmur3(fresh())
                for j, (cols, seeds) in enumerate(calls):
                    _exact(f"murmur3 {label} plan {k} call {j}",
                           m3.murmur3_columns(cols, seeds),
                           m3.murmur3_columns_plain(cols, seeds))
                probes = capture_probes(fresh())
                hits = [compare_probe(f"probe {label} plan {k} call {j}",
                                      args, cap, total)
                        for j, (args, cap, total) in enumerate(probes)]
                if not calls or not probes:
                    raise AssertionError(
                        f"{label} plan {k}: {len(calls)} murmur3 and "
                        f"{len(probes)} probe launches captured")
                print(f"compare {label} plan {k} murmur3 launches "
                      f"({len(calls)}) and probes ({len(probes)}, "
                      f"{sum(hits)} verified pairs); exact")
            if label == "P41 delete":
                takes = capture_dict_gathers(fresh())
                if takes:
                    print(f"compare {label} dictionary gathers: "
                          f"{'; '.join(compare_dict_takes(label, takes))}; "
                          f"exact")
        if "dma_row_gather" in P41_NEED[label] and not n_gathers:
            raise AssertionError(f"{label}: no row gather captured")


def drive_delta_paths(dev, sm, orders, source, wants):
    """Phase 3n (P41): each command's run once counted (launches, host
    reads) beside its twin counted the same way, each held to its numpy
    oracle, then P41_RUNS runs of the four in turns, one synchronisation
    a run, each held to its oracle after its time is taken. Returns
    (records, launches by run)."""
    import torch
    runs, twins, _ = p41_frames(sm, dev, orders, source)
    recs, launches, ms = {}, {}, {k: [] for k in P41_COMMANDS}
    for label in P41_COMMANDS:
        t0 = time.perf_counter()
        out, counts, reads = counted_run(runs[label])
        first_ms = (time.perf_counter() - t0) * 1e3
        p41_check(label, wants[label], out)
        idle = [k for k in P41_NEED[label] if counts[k] < 1]
        if idle:
            raise AssertionError(f"{label}: kernels not launched: {idle} "
                                 f"(counts {counts})")
        _, tcounts, treads = counted_run(twins[label])
        key = label.replace(" ", "_")
        launches[key], launches[key + "_twin"] = counts, tcounts
        recs[label] = {"stats": out[0], "first_run_ms": first_ms,
                       "launches": counts, "twin_launches": tcounts,
                       "host_reads": reads, "twin_host_reads": treads}
        print(f"{label}: stats {out[0]} equal to the oracle, rows equal as "
              f"a multiset; first run {first_ms:.1f} ms; launches "
              f"{family_counts(counts)} (the plain twin's "
              f"{family_counts(tcounts)}); host reads {reads} (twin "
              f"{treads})")
    for i in range(P41_RUNS):
        order = P41_COMMANDS if i % 2 == 0 else P41_COMMANDS[::-1]
        for label in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = runs[label]()
            torch.cuda.synchronize()
            ms[label].append((time.perf_counter() - t0) * 1e3)
            p41_check(f"{label} timed", wants[label], out)
    for label in P41_COMMANDS:
        recs[label]["ms"] = ms[label]
        print(f"{label} timed, {P41_RUNS} runs in turns: "
              f"{['%.2f' % v for v in ms[label]]} ms")
    return recs, launches


# -- slice 20 (phase 3o): the mesh lane, P42 ---------------------------------

P42_SHARDS = 4
P42_RUNS = 3             # timed runs of each P42 path, in turns
#: q3 over the mesh: the aggregate on its exact tier, as phases 3c and 3l
#: pin it (its speculative tier would trip at q3's cardinality and re-run
#: the plan), and broadcasts off: at the default 10 MiB threshold the
#: planner broadcasts q3's filtered orders (7.3 MB estimated), and only
#: the aggregate would cross the mesh
P42_Q3_CONF = dict(Q3_CONF, **{"spark.rapids.sql.broadcastSizeThreshold":
                               "-1"})
#: the host exchange's device lane: the planner keeps its host exchanges
#: (planExchange off) over shuffle.partitions = the mesh's shards
P42_ICI_CONF = dict(P42_Q3_CONF, **{
    "spark.rapids.tpu.shuffle.planExchange": "false",
    "spark.rapids.sql.shuffle.partitions": str(P42_SHARDS),
    "spark.rapids.tpu.shuffle.ici.enabled": "true"})
P42_ADAPTIVE_OFF = {"spark.rapids.tpu.adaptive.enabled": "false"}
#: each twin first: the paths after it are held to its launches
P42_PATHS = ("P42 mesh q3 twin", "P42 mesh q3", "P42 mesh Q1 twin",
             "P42 mesh Q1", "P42 ici q3", "P42 ici q3 defaults",
             "P42 host q3")


def p42_mesh(dev):
    """P42_SHARDS shards on one device: on the card, all on cuda:0."""
    import torch
    from spark_rapids_tpu_torch.parallel.mesh import Mesh
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return Mesh([dev] * P42_SHARDS)


def p42_frames(sm, dev, d3, q1t_batch, order_batches, line_batches):
    """{label: DataFrame} of P42, each in a session of its own: q3 and
    TPC-H Q1 planned over the mesh (ShuffleExchangeExec) and without it
    (the twins), and q3 through the host exchange's device lane with
    adaptive off, at its default confs (the skew shield's stand-down) and
    on the host lane (ici off)."""
    Session = sm.session.TpuSession
    mesh = p42_mesh(dev)
    ici_off = dict(P42_ICI_CONF, **P42_ADAPTIVE_OFF)
    sessions = {
        "P42 mesh q3": Session(P42_Q3_CONF, dev, mesh=mesh),
        "P42 mesh q3 twin": Session(P42_Q3_CONF, dev),
        "P42 mesh Q1": Session({}, dev, mesh=mesh),
        "P42 mesh Q1 twin": Session({}, dev),
        "P42 ici q3": Session(ici_off, dev, mesh=mesh),
        "P42 ici q3 defaults": Session(P42_ICI_CONF, dev, mesh=mesh),
        "P42 host q3": Session(dict(ici_off, **{
            "spark.rapids.tpu.shuffle.ici.enabled": "false"}), dev,
            mesh=mesh)}
    return {label: (tpch_q1_df(sm, sess, q1t_batch) if "Q1" in label
                    else q3_df(sm, sess, order_batches, line_batches))
            for label, sess in sessions.items()}


def exec_metrics(metrics, name):
    """The operator metrics of every `name` exec of a collect()."""
    return [v for k, v in metrics.items() if k.startswith(name + "#")]


def p42_expect(label, counts, metrics, twin):
    """Each P42 path's launches against its plan's shape, from its
    operators' metrics: a shuffled join probes once a stream batch, over
    one pair a shard; each exchange round hashes each shard's pid once,
    and the host lane each map batch with rows (fixed-width keys: q3's
    order key and its aggregate's keys; Q1's string flags hash in plain
    torch, so Q1 hashes as its twin does), and each pair's join hashes
    its build keys (both seeds in one launch) and each stream batch (the
    twin's one join adds its compiled stage's cold sizing pass); each
    round gathers each shard twice (its send grid, its received slots)
    and the host lane once a map's reorder, a floor under the row
    gathers. Returns the shape it read; raises on a mismatch."""
    rounds = sum(m["numRounds"] for name in ("ShuffleExchangeExec",
                                             "HostShuffleExchangeExec")
                 for m in exec_metrics(metrics, name))
    host_x = exec_metrics(metrics, "HostShuffleExchangeExec")
    maps = sum(m["numMapsWithRows"] for m in host_x)
    reorders = sum(m["numReorderGathers"] for m in host_x)
    joins = exec_metrics(metrics, "ShuffledHashJoinExec")
    pairs = sum(m["numPartitionPairs"] for m in joins)
    stream = sum(m["numStreamBatches"] for m in joins)
    want = {}
    if "q3" in label:
        if pairs != P42_SHARDS:
            raise AssertionError(f"{label}: {pairs} partition pairs joined, "
                                 f"not one a shard ({P42_SHARDS})")
        want["fused_probe_verify"] = stream
        want["murmur3_columns"] = P42_SHARDS * rounds + maps + pairs + stream
    else:
        want["murmur3_columns"] = twin["murmur3_columns"]
    bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if bad:
        raise AssertionError(f"{label}: launches (got, want) {bad}; rounds "
                             f"{rounds}, host maps {maps}, pairs {pairs}, "
                             f"stream batches {stream}")
    floor = 2 * P42_SHARDS * rounds + reorders
    if counts["dma_row_gather"] < floor:
        raise AssertionError(f"{label}: {counts['dma_row_gather']} row "
                             f"gathers, below {floor}")
    return {"rounds": rounds, "host_maps": maps, "pairs": pairs,
            "stream_batches": stream, "want": want,
            "row_gather_floor": floor}


def compare_mesh_paths(dev, sm, d3, q1t_batch, order_batches, line_batches):
    """Phase 2 at P42's own inputs: every murmur3 chain launch (the
    exchange pids over each shard or map batch and the per-shard joins'
    hashes), every probe of the per-shard joins and every row gather (the
    send grids, the received slots, the host lane's reorders, the joins'
    and aggregates') of a run of each P42 q3 path over the mesh, and the
    row gathers of P42 mesh Q1, each held exactly to its plain
    version."""
    from spark_rapids_tpu_torch.ops import murmur3_lanes as m3
    frames = p42_frames(sm, dev, d3, q1t_batch, order_batches, line_batches)
    for label in ("P42 mesh q3", "P42 ici q3", "P42 ici q3 defaults",
                  "P42 host q3", "P42 mesh Q1"):
        def fresh():
            return planned(sm, frames[label])[0]
        gathers = capture_row_gathers(fresh())
        print(f"compare {label} row gathers: "
              f"{'; '.join(compare_row_gathers(label, gathers))}; exact")
        del gathers
        if "q3" not in label:
            continue
        calls = capture_murmur3(fresh())
        for j, (cols, seeds) in enumerate(calls):
            _exact(f"murmur3 {label} call {j}",
                   m3.murmur3_columns(cols, seeds),
                   m3.murmur3_columns_plain(cols, seeds))
        probes = capture_probes(fresh())
        hits = [compare_probe(f"probe {label} call {j}", args, cap, total)
                for j, (args, cap, total) in enumerate(probes)]
        if len(probes) < P42_SHARDS or not calls:
            raise AssertionError(f"{label}: {len(calls)} murmur3 and "
                                 f"{len(probes)} probe launches captured")
        print(f"compare {label} murmur3 launches ({len(calls)}) and probes "
              f"({len(probes)}, {sum(hits)} verified pairs); exact")


def drive_mesh_paths(dev, sm, d3, q3_want, q1t_batch, q1t_want,
                     order_batches, line_batches):
    """Phase 3o (P42): each path's collect() once counted (launches,
    host reads, the lane's counters, the all-to-all's bytes and host ns,
    the shuffle's frames, the device memory peak, the phase ledger),
    held to its oracle and
    its launches to its plan's shape (p42_expect); the device lane's
    rounds > 0 with no fallback and no frame with adaptive off, the skew
    shield's one stand-down a shuffled join at the default confs; then
    P42_RUNS runs of every path in turns, one synchronisation a run, each
    held to its oracle. Returns (records, launches by path)."""
    import torch
    from spark_rapids_tpu_torch.parallel import exchange as px
    from spark_rapids_tpu_torch.shuffle import manager as shuffle_mgr
    frames = p42_frames(sm, dev, d3, q1t_batch, order_batches, line_batches)

    def check(label, rows):
        if "Q1" in label:
            check_rows(rows, q1t_want, label)
        else:
            check_q3(rows, q3_want, label)

    recs, launches = {}, {}
    for label in P42_PATHS:
        df = frames[label]
        i0, s0, a0 = (shuffle_mgr.ici_counters(), shuffle_mgr.counters(),
                      px.counters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        rows, counts, reads = counted_run(df.collect)
        first_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        check(label, rows)
        ici = {k: v - i0[k] for k, v in shuffle_mgr.ici_counters().items()}
        frames_w = shuffle_mgr.counters()["frames"] - s0["frames"]
        a2a = {k: v - a0[k] for k, v in px.counters().items()}
        metrics = df.session.last_query_metrics()
        # the governed collect()'s phase ledger: the rounds' share is
        # ici-collective, the host lane's host-pack-serialize and
        # shuffle-io
        phases = {k: round(v / 1e6, 3) for k, v in
                  df.session.last_query_profile().phases().items() if v}
        twin = launches.get(label.replace(" defaults", "").replace(
            "ici", "mesh").replace("host", "mesh") + " twin") \
            if "twin" not in label else None
        shape = p42_expect(label, counts, metrics, twin) \
            if twin is not None else None
        if label == "P42 ici q3":
            if ici["rounds"] < 1 or ici["fallbacks"] or frames_w:
                raise AssertionError(f"{label}: the device lane must carry "
                                     f"every exchange: {ici}, {frames_w} "
                                     f"frames")
        if label == "P42 ici q3 defaults":
            joins = len(exec_metrics(metrics, "ShuffledHashJoinExec"))
            if ici["fallbacks"] != joins or ici["rounds"] < 1 \
                    or not frames_w:
                raise AssertionError(
                    f"{label}: the skew shield stands down once a shuffled "
                    f"join ({joins}), its build side and the aggregate "
                    f"take the lane: {ici}, {frames_w} frames")
        if label == "P42 host q3" and (ici["rounds"] or not frames_w):
            raise AssertionError(f"{label}: {ici}, {frames_w} frames")
        if "mesh" in label and "twin" not in label and not a2a["calls"]:
            raise AssertionError(f"{label}: no all-to-all")
        launches[label] = counts
        recs[label] = {"first_run_ms": first_ms, "launches": counts,
                       "families": family_counts(counts),
                       "host_reads": reads, "ici": ici,
                       "frames_written": frames_w, "all_to_all": a2a,
                       "peak_bytes": peak, "shape": shape,
                       "phases_ms": phases}
        print(f"{label}: equal to the oracle; first run {first_ms:.1f} ms; "
              f"launches {family_counts(counts)}; host reads {reads}; ici "
              f"{ici}; frames {frames_w}; all-to-all {a2a['calls']} lanes, "
              f"{a2a['bytes']} bytes, {a2a['ns']} host ns; device peak "
              f"{peak} bytes; plan shape {shape}; phases ms {phases}")
    ms = {k: [] for k in P42_PATHS}
    for i in range(P42_RUNS):
        for label in (P42_PATHS if i % 2 == 0 else P42_PATHS[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = frames[label].collect()
            torch.cuda.synchronize()
            ms[label].append((time.perf_counter() - t0) * 1e3)
            check(f"{label} timed", rows)
    for label in P42_PATHS:
        recs[label]["ms"] = ms[label]
        print(f"{label} timed, {P42_RUNS} runs in turns: "
              f"{['%.2f' % v for v in ms[label]]} ms")
    check_idle("P42")
    shuffle_root_empty("P42")
    return recs, {k.replace(" ", "_"): v for k, v in launches.items()}


# -- slice 21 (phase 3p): the tooling, P43 -----------------------------------

P43_RUNS = 3             # timed runs of each P43 tier, in turns
P43_FUZZ_ROWS = 262_144  # each fuzz fact table's rows
P43_FUZZ_BATCH = 65_536  # its batches' rows (four, as test_fuzz's shapes)
#: the fuzz join's build side: a dimension table whose keys repeat about
#: once, so the left outer join's output stays near its fact side
P43_JOIN_BUILD_ROWS = 16_384
P43_FUZZ_SHAPES = ("groupby_sum_count", "string_minmax", "filter_project",
                   "join", "sort_limit", "double_specials")
P43_DUMP_KEY = "spark.rapids.sql.debug.dumpPath"
#: one device fault at the first `device.dispatch` check q3 reaches
P43_FAULT = {"spark.rapids.tpu.test.faults":
             "device.dispatch:prob=1.0,seed=43,kind=device,max=1",
             "spark.rapids.tpu.task.maxAttempts": "1"}


def _wrap64(x):
    """Spark's non-ANSI long arithmetic: two's-complement wrap."""
    return (x + (1 << 63)) % (1 << 64) - (1 << 63)


def _float_key(k):
    """Spark's group key of a double: NaNs one group, -0.0 with 0.0."""
    if k is None:
        return None
    if math.isnan(k):
        return "nan"
    return 0.0 if k == 0.0 else k


def p43_fuzz_case(name, n, br, build_rows):
    """One fuzz shape's tables and Python oracle (tests/test_fuzz.py's
    shapes at n rows in batches of br, the join's build side build_rows;
    the port's datagen at its default special-value and null weights):
    ([(data, schema, batch rows)], oracle, seconds). Pure Python: it runs
    in a worker process while the earlier phases run."""
    import collections
    from spark_rapids_tpu_torch import testing as T
    from spark_rapids_tpu_torch import types as t
    t0 = time.perf_counter()
    if name == "groupby_sum_count":
        data, sch = T.gen_pydict(
            [("k", T.SetValuesGen(t.LONG, [0, 1, 2, 3, 4, None])),
             ("v", T.LongGen(min_val=-1 << 40, max_val=1 << 40))], n, 0)
        acc = collections.defaultdict(lambda: [0, 0])
        for k, v in zip(data["k"], data["v"]):
            acc[k][0] += v or 0
            acc[k][1] += v is not None
        oracle = [(k, (s if c else None), c) for k, (s, c) in acc.items()]
        tables = [(data, sch, br)]
    elif name == "string_minmax":
        data, sch = T.gen_pydict(
            [("k", T.SetValuesGen(t.STRING, ["a", "bb", "ccc", None])),
             ("v", T.DoubleGen(no_nans=True))], n, 3)
        acc = collections.defaultdict(list)
        for k, v in zip(data["k"], data["v"]):
            acc[k].extend(() if v is None else (v,))
        oracle = [(k, min(vs, default=None), max(vs, default=None))
                  for k, vs in acc.items()]
        tables = [(data, sch, br)]
    elif name == "filter_project":
        data, sch = T.gen_pydict(
            [("a", T.IntegerGen()), ("b", T.LongGen()),
             ("s", T.StringGen(max_length=12))], n, 5)
        oracle = [(a, None if b is None else _wrap64(b + 1), s)
                  for a, b, s in zip(data["a"], data["b"], data["s"])
                  if a is not None and a > 0]
        tables = [(data, sch, br)]
    elif name == "join":
        keys = build_rows
        ldata, lsch = T.gen_pydict(
            [("k", T.SetValuesGen(t.LONG, list(range(keys)) + [None])),
             ("lv", T.LongGen())], n, 7)
        rdata, rsch = T.gen_pydict(
            [("k", T.SetValuesGen(t.LONG, list(range(keys // 2,
                                                     keys // 2 + keys))
                                  + [None])),
             ("rv", T.StringGen(max_length=30))], build_rows, 107)
        rmap = collections.defaultdict(list)
        for k, v in zip(rdata["k"], rdata["rv"]):
            if k is not None:
                rmap[k].append(v)
        oracle = []
        for k, lv in zip(ldata["k"], ldata["lv"]):
            matches = rmap.get(k, []) if k is not None else []
            oracle.extend([(k, lv, rv) for rv in matches] or [(k, lv, None)])
        tables = [(ldata, lsch, br), (rdata, rsch, br)]
    elif name == "sort_limit":
        data, sch = T.gen_pydict(
            [("a", T.IntegerGen()), ("s", T.StringGen(max_length=8))], n, 9)
        # Spark's ascending default is NULLS FIRST
        key = [(a is not None, a if a is not None else 0, s is not None,
                s or "") for a, s in zip(data["a"], data["s"])]
        order = sorted(range(n), key=lambda i: key[i])
        oracle = [(data["a"][i], data["s"][i]) for i in order[:25]]
        tables = [(data, sch, br)]
    else:  # double_specials: NaN, +-inf, -0.0 among the keys
        data, sch = T.gen_pydict(
            [("k", T.DoubleGen()),
             ("v", T.LongGen(min_val=-1 << 40, max_val=1 << 40))], n, 11)
        acc = collections.defaultdict(lambda: [0, 0])
        for k, v in zip(data["k"], data["v"]):
            g = acc[_float_key(k)]
            g[0] += v or 0
            g[1] += v is not None
        oracle = {k: (s if c else None, c) for k, (s, c) in acc.items()}
        tables = [(data, sch, br)]
    return tables, oracle, time.perf_counter() - t0


def p43_start_fuzz_data():
    """P43's fuzz tables and oracles, made in worker processes (spawned,
    no CUDA) while the earlier phases run: {shape: future}, and the pool
    to shut down once they are read."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(max_workers=3,
                               mp_context=multiprocessing.get_context(
                                   "spawn"))
    return pool, {name: pool.submit(p43_fuzz_case, name, P43_FUZZ_ROWS,
                                    P43_FUZZ_BATCH, P43_JOIN_BUILD_ROWS)
                  for name in P43_FUZZ_SHAPES}


def p43_fuzz_df(sm, sess, name, tables):
    """The fuzz shape's DataFrame query (tests/test_fuzz.py:45-177)."""
    F, col = sm.F, sm.core.col
    dfs = [sess.from_pydict(d, s, batch_rows=br) for d, s, br in tables]
    df = dfs[0]
    if name == "groupby_sum_count":
        return df.group_by("k").agg((F.sum("v"), "s"), (F.count("v"), "c"))
    if name == "string_minmax":
        return df.group_by("k").agg((F.min("v"), "mn"), (F.max("v"), "mx"))
    if name == "filter_project":
        return df.filter(col("a") > 0).select(
            col("a"), (col("b") + 1).alias("b1"), col("s"))
    if name == "join":
        return df.join(dfs[1], on="k", how="left_outer")
    if name == "sort_limit":
        return df.sort("a", "s").limit(25)
    return df.group_by("k").agg((F.sum("v"), "s"), (F.count("v"), "c"))


def p43_tier_name(conf, mesh):
    from spark_rapids_tpu_torch.testing import CONFIG_TIERS
    exact = "+exact" if conf else ""
    if mesh is not None:
        return f"mesh{exact}"
    return ("speculative", "exact", "exact unfused")[
        CONFIG_TIERS.index(dict(conf or {}))]


@contextlib.contextmanager
def p43_recorded(recs):
    """Every collect the harness makes (testing.asserts.collect_with_conf,
    the harness's own) counted: the tier, the first run's ms (session and
    plan included), the launches, the host reads and the rows; the
    DataFrame is kept for the timed runs."""
    from spark_rapids_tpu_torch.testing import asserts
    real = asserts.collect_with_conf

    def collect(build, conf=None, mesh_devices=None, device=None,
                mesh=None):
        kept = []

        def keep(sess):
            kept.append(build(sess))
            return kept[-1]

        t0 = time.perf_counter()
        rows, counts, reads = counted_run(lambda: real(
            keep, conf, mesh_devices=mesh_devices, device=device,
            mesh=mesh))
        recs[p43_tier_name(conf, mesh or mesh_devices)] = {
            "first_run_ms": (time.perf_counter() - t0) * 1e3,
            "launches": counts, "families": family_counts(counts),
            "host_reads": reads, "rows": len(rows), "df": kept[0],
            "result": rows}
        return rows

    asserts.collect_with_conf = collect
    try:
        yield
    finally:
        asserts.collect_with_conf = real


def p43_tiers(sm, dev, mesh, label, build, expected, check):
    """P43's tier matrix for one planned query: the harness over the three
    CONFIG_TIERS and the mesh tiers over `mesh`, every tier equal to the
    others and to `expected` (rtol 1e-9), and each tier's rows to `check`
    (the query's own oracle check); then P43_RUNS timed runs of every tier
    in turns, one synchronisation a run, each checked. Returns
    {tier: record}."""
    import torch
    from spark_rapids_tpu_torch import testing
    recs = {}
    with p43_recorded(recs):
        testing.assert_consistent_across_configs(
            build, device=dev, mesh=mesh, expected=expected, rel_tol=RTOL)
    for tier, rec in recs.items():
        check(rec.pop("result"), f"P43 {label} {tier}")
    names = list(recs)
    for tier in names:
        recs[tier]["ms"] = []
    for i in range(P43_RUNS):
        for tier in (names if i % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = recs[tier]["df"].collect()
            torch.cuda.synchronize()
            recs[tier]["ms"].append((time.perf_counter() - t0) * 1e3)
            check(rows, f"P43 {label} {tier} timed")
    for tier in names:
        rec = recs[tier]
        del rec["df"]
        print(f"P43 {label} {tier}: equal to the oracle and the other "
              f"tiers; first run {rec['first_run_ms']:.1f} ms, timed "
              f"{['%.2f' % v for v in rec['ms']]} ms; launches "
              f"{rec['families']}; host reads {rec['host_reads']}")
    return recs


def p43_fuzz(sm, dev, name, tables, oracle):
    """One fuzz shape across the three CONFIG_TIERS on the card (each
    tier's collect through the harness's testing.collect_with_conf), each
    tier held to its Python oracle as tests/test_fuzz.py holds it:
    integers and strings exact (the rows as a multiset; one pass, where
    the harness's sorted comparison of 300,000 rows takes seconds), f64
    to rtol 1e-9 (string_minmax through testing.assert_rows_equal),
    sort-limit in order, the DOUBLE keys by Spark's grouping (NaNs one
    group, -0.0 with 0.0). Returns {tier: record}."""
    import collections
    from spark_rapids_tpu_torch import testing
    from spark_rapids_tpu_torch.testing import asserts

    def build(sess):
        return p43_fuzz_df(sm, sess, name, tables)

    recs = {}
    with p43_recorded(recs):
        for conf in testing.CONFIG_TIERS:
            asserts.collect_with_conf(build, conf, device=dev)
    for tier, rec in recs.items():
        rows = rec.pop("result")
        rec.pop("df")
        label = f"P43 fuzz {name} {tier}"
        if name == "string_minmax":
            testing.assert_rows_equal(rows, oracle, rel_tol=RTOL)
        elif name == "sort_limit":
            testing.assert_rows_equal(rows, oracle, rel_tol=RTOL,
                                      ordered=True)
        elif name == "double_specials":
            by_key = {_float_key(k): (s, c) for k, s, c in rows}
            if len(by_key) != len(rows) or by_key != oracle:
                raise AssertionError(f"{label}: {len(rows)} groups, oracle "
                                     f"{len(oracle)}; they differ")
        elif collections.Counter(rows) != collections.Counter(oracle):
            raise AssertionError(f"{label}: {len(rows)} rows, oracle "
                                 f"{len(oracle)}; the multisets differ")
        print(f"{label}: equal to the Python oracle; {rec['rows']} rows; "
              f"first run {rec['first_run_ms']:.1f} ms; launches "
              f"{rec['families']}; host reads {rec['host_reads']}")
    return recs


def p43_dump(sm, dev, order_batches, line_batches, q3_want):
    """P43's dump: planned q3 under sql.debug.dumpPath (a temporary
    directory) with one injected device fault and task retry off:
    collect() must raise the injected error; each dump directory must hold
    error.txt with it, a repro.py naming the port and no jax, and one
    record per input batch its operator retained (.parquet + .meta.json,
    or .FAILED naming pyarrow's absence where it is missing). Then q3
    with the path set and no fault beside the path empty, P43_RUNS runs
    in turns, one synchronisation a run, each run's device peak above
    what was allocated before it. Returns the record."""
    import importlib.util
    import os
    import torch
    from spark_rapids_tpu_torch import faults
    from spark_rapids_tpu_torch.faults import InjectedDeviceError
    from spark_rapids_tpu_torch.utils import dump
    Session = sm.session.TpuSession
    root = tempfile.mkdtemp(prefix="chip_smoke_p43_")
    retained = {}
    real_exit = dump.dump_on_error.__exit__

    def exit_noting(self, *exc):
        out = real_exit(self, *exc)
        if self.out_dir is not None:
            retained[os.path.basename(self.out_dir)] = len(self._batches)
        return out

    faults.install(None)
    dump.dump_on_error.__exit__ = exit_noting
    try:
        df = q3_df(sm, Session(dict(Q3_CONF, **P43_FAULT,
                                    **{P43_DUMP_KEY: root}), dev),
                   order_batches, line_batches)
        try:
            df.collect()
        except InjectedDeviceError as e:
            err = e
        else:
            raise AssertionError("P43 dump: q3 ran through its injected "
                                 "fault")
    finally:
        dump.dump_on_error.__exit__ = real_exit
        faults.install(None)
    no_pyarrow = importlib.util.find_spec("pyarrow") is None
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("pyarrow", "pandas")}
    dirs = sorted(os.listdir(root))
    if not dirs or set(dirs) != set(retained) or not sum(retained.values()):
        raise AssertionError(f"P43 dump: directories {dirs}, retained "
                             f"batches {retained}")
    files = {}
    for d in dirs:
        names = sorted(os.listdir(os.path.join(root, d)))
        files[d] = names

        def text(f):
            return Path(root, d, f).read_text()

        if "InjectedDeviceError" not in text("error.txt") or \
                str(err) not in text("error.txt"):
            raise AssertionError(f"P43 dump {d}: error.txt lacks {err!r}")
        repro = text("repro.py")
        if "spark_rapids_tpu_torch" not in repro or "jax" in repro:
            raise AssertionError(f"P43 dump {d}: repro.py names the wrong "
                                 f"package")
        parquet = [f for f in names if f.endswith(".parquet")]
        failed = [f for f in names if f.endswith(".FAILED")]
        metas = [f for f in names if f.endswith(".meta.json")]
        if len(parquet) + len(failed) != retained[d] or \
                metas != [f + ".meta.json" for f in parquet]:
            raise AssertionError(f"P43 dump {d}: {names} for "
                                 f"{retained[d]} retained batches")
        if no_pyarrow and (parquet or any(
                "pyarrow" not in text(f) for f in failed)):
            raise AssertionError(f"P43 dump {d}: without pyarrow each "
                                 f"record is a .FAILED naming it: {names}")
    shutil.rmtree(root)
    print(f"P43 dump: collect() raised {type(err).__name__}: {err}; "
          f"{files}; retained batches {retained}; importable on this "
          f"machine: {found}")
    root = tempfile.mkdtemp(prefix="chip_smoke_p43_")
    frames = {"path set": q3_df(sm, Session(dict(Q3_CONF, **{
        P43_DUMP_KEY: root}), dev), order_batches, line_batches),
              "path empty": q3_df(sm, Session(Q3_CONF, dev), order_batches,
                                  line_batches)}
    ms = {k: [] for k in frames}
    peaks = {k: [] for k in frames}
    for i in range(P43_RUNS):
        for label in (list(frames) if i % 2 == 0 else list(frames)[::-1]):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            rows = frames[label].collect()
            torch.cuda.synchronize()
            ms[label].append((time.perf_counter() - t0) * 1e3)
            peaks[label].append(torch.cuda.max_memory_allocated() - base)
            check_q3(rows, q3_want, f"P43 dump q3, {label}")
    if os.listdir(root):
        raise AssertionError(f"P43 dump: a run with no fault dumped "
                             f"{os.listdir(root)}")
    shutil.rmtree(root)
    for label in frames:
        print(f"P43 dump q3, {label}, {P43_RUNS} runs in turns: "
              f"{['%.2f' % v for v in ms[label]]} ms; device peak "
              f"{peaks[label]} bytes")
    return {"error": repr(err), "files": files, "retained": retained,
            "importable": found, "ms": ms, "peak_bytes": peaks}


def drive_tooling_paths(dev, sm, fuzz_futures, d3, q3_want, order_batches,
                        line_batches, l19, p19, q19_want, q1t_batch,
                        q1t_want):
    """Phase 3p (P43): the tier matrix (P6, q3, Q19 through
    testing.assert_consistent_across_configs over CONFIG_TIERS and the
    mesh tiers on P42's mesh), the fuzz shapes on the card across
    CONFIG_TIERS, and the failure dump. Returns (records, launches by
    path)."""
    mesh = p42_mesh(dev)
    recs = {"tiers": {}, "fuzz": {}}

    def q19_check(rows, label):
        got, want = (rows[0][0] if len(rows) == 1 else rows), q19_want[0]
        if (got is None) != (want is None) or (
                want is not None and abs(got - want) > RTOL * abs(want)):
            raise AssertionError(f"{label}: revenue {got} != oracle {want}")

    tier_cases = {
        "P6": (lambda s: tpch_q1_df(sm, s, q1t_batch),
               [tuple(r) for r in q1t_want],
               lambda r, lb: check_rows(r, q1t_want, lb)),
        "q3": (lambda s: q3_df(sm, s, order_batches, line_batches),
               list(q3_want.items()),
               lambda r, lb: check_q3(r, q3_want, lb)),
        "Q19": (lambda s: q19_df(sm, s, l19, p19), [(q19_want[0],)],
                q19_check)}
    for label, (build, expected, check) in tier_cases.items():
        with default_conf_after():
            recs["tiers"][label] = p43_tiers(sm, dev, mesh, label, build,
                                             expected, check)
    t0 = time.perf_counter()
    fuzz_data = {k: f.result(timeout=600) for k, f in fuzz_futures.items()}
    recs["fuzz_data_wait_s"] = time.perf_counter() - t0
    recs["fuzz_data_s"] = {k: v[2] for k, v in fuzz_data.items()}
    for name, (tables, oracle, _) in fuzz_data.items():
        with default_conf_after():
            recs["fuzz"][name] = p43_fuzz(sm, dev, name, tables, oracle)
    del fuzz_data
    with default_conf_after():
        recs["dump"] = p43_dump(sm, dev, order_batches, line_batches,
                                q3_want)
    check_idle("P43")
    launches = {f"P43_{q}_{t.replace(' ', '_').replace('+', '_')}":
                r["launches"] for q, ts in recs["tiers"].items()
                for t, r in ts.items()}
    launches.update({
        f"P43_fuzz_{q}_{t.replace(' ', '_')}": r["launches"]
        for q, ts in recs["fuzz"].items() for t, r in ts.items()})
    return recs, launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--profile", metavar="TRACE", type=Path,
        help="also profile the q1, q3, q19, P6, P7 and P17-P31 steady "
             "states (device busy share, time by kernel) and write their "
             "Chrome traces to TRACE and TRACE with _q3, _q19, _p6, _p7, "
             "_p17 ... _p31_hosts before its suffix")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import Column, bucket_capacity
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.exec.speculation import speculation_scope
    from spark_rapids_tpu_torch.kernels import build
    from spark_rapids_tpu_torch.ops import fused_scan_agg as fsa

    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    # P43's fuzz tables and oracles (phase 3p) are pure Python: worker
    # processes make them while the phases before 3p run
    fuzz_pool, fuzz_futures = p43_start_fuzz_data()

    # -- data and plans (host set-up) --------------------------------------
    t0 = time.perf_counter()
    d = q1_data()
    oracle = q1_oracle(d)
    schema = q1_schema(t)
    cap = bucket_capacity(ROWS)
    batch = ColumnarBatch([Column.from_numpy(d[f.name], f.data_type,
                                             capacity=cap, device=dev)
                           for f in schema.fields], ROWS, schema)
    plan = q1_plan(batch, schema)
    q1_spec = plan._scan_agg_spec
    if q1_spec is None:
        raise AssertionError("the q1 chain did not compile to a kernel spec")
    mm_spec, mm_schema = minmax_spec()
    zoo, zoo_schema = zoo_spec()
    if mm_spec is None or zoo is None:
        raise AssertionError("a comparison chain did not compile to a spec")
    d3, d3i = q3_data(), q3_data(np.int32)
    q3_want = q3_oracle(d3)
    q3 = q3_plan(d3, dev, "LONG")
    q3i = q3_plan(d3i, dev, "INT")
    d19 = q19_data()
    q19_want = q19_oracle(d19)
    l19, p19 = q19_batches(d19, dev)
    q19 = q19_plan(port_modules(), l19, p19)
    q1t_batch = tpch_q1_batch(d19, dev)
    q1t_want = tpch_q1_oracle(d19)
    p7_want = shipmode_oracle(d19, shipmode_table()[1])
    p7_batches = {enc: shipmode_batches(d19, dev, enc)
                  for enc in (False, True)}
    names = customer_names(P8_NAMES)
    step = ROWS // P9_BATCHES
    p9_batches = [ColumnarBatch([Column.from_numpy(
        d[f.name][i: i + step], f.data_type, capacity=bucket_capacity(step),
        device=dev) for f in schema.fields], step, schema)
        for i in range(0, ROWS, step)]
    dj = tpch_join_data()
    jb = join_batches(dj, dev)
    pd38 = p38_data(dj)
    p38_want = p38_oracle(dj, pd38)
    q3d = q3_types_data(dj)
    tm, tb, types_want = types_inputs(dev, d19, dj, q3d)
    str_m, str_b, strings_want = strings_inputs(dev, dj, q3d, d19, names)
    win_m, win_b, win_checks = windows_inputs(dev, dj, q3d, d19,
                                              strings_data(dj, q3d))
    t_nested = time.perf_counter()
    nest_m, nest_b, nest_checks = nested_inputs(dev, dj, q3d, d19)
    t_files = time.perf_counter()
    print(f"setup: {t_files - t0:.1f} s (data, oracles, plans; "
          f"P29-P31's {t_files - t_nested:.1f} s)")
    # P40's files (phase 3m drives the file lane): written by the port's
    # writers under the run's temporary directory and read back once
    workdir = tempfile.mkdtemp(prefix="chip_smoke_p40_")
    with default_conf_after():
        files = file_inputs(dev, join_session_modules(), dj, jb, q3d, tb,
                            workdir)
    print(f"setup: P40's files written and read back in "
          f"{time.perf_counter() - t_files:.1f} s")
    # P41's MERGE source (phase 3n drives Delta's DML plans): 150,000
    # orders rows built on the card, and the four commands' oracles
    t0 = time.perf_counter()
    p41_src = p41_source(dj)
    p41_batch = join_batch(p41_src, "orders", dev)
    p41_want = p41_oracles(dj, p41_src)
    print(f"setup: P41's source and oracles in "
          f"{time.perf_counter() - t0:.1f} s")
    # P42's q3 sides (phase 3o drives the mesh lane over them and Q1's
    # lineitems): one batch each, built on the card
    o_schema42, l_schema42 = q3_schemas("LONG")
    p42_o = q3_batches(d3, dev, o_schema42, Q3_ORDERS)
    p42_l = q3_batches(d3, dev, l_schema42, Q3_LINES)

    # -- phase 1: build every kernel at once -------------------------------
    t0 = time.perf_counter()
    sources = [fsa.kernel_source(s) for s in (q1_spec, mm_spec, zoo)] + [
        build.csrc_source(name)
        for name in ("murmur3.cu", "probe_verify.cu", "row_gather.cu",
                     "dict_gather.cu")] + [REPLACED_MURMUR3_SOURCE]
    build.build_all(sources)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(sources)} "
          f"kernel sources (the last is the replaced murmur3, phase 4's "
          f"yardstick)")
    t0 = time.perf_counter()
    from spark_rapids_tpu_torch import native
    native.native_lib()
    print(f"build: {time.perf_counter() - t0:.1f} s for the shuffle's host "
          f"block codec (csrc/blockcodec.cpp, {build.cxx_path()})")
    for src in sources:
        for line in build.compiler_log(src).splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    # -- phase 2: kernel against plain version ------------------------------
    cases = []
    for n in (1000, 65537, 1 << 20):
        cases.append((f"q1 n={n}", q1_spec, random_batch(schema, n, 4, dev,
                                                        n), BUCKETS))
        cases.append((f"minmax n={n}", mm_spec,
                      random_batch(mm_schema, n, 12, dev, n + 1), 16))
        cases.append((f"zoo n={n}", zoo,
                      random_batch(zoo_schema, n, 3, dev, n + 2), 32))
    cases.append(("minmax high-cardinality", mm_spec,
                  random_batch(mm_schema, 200_000, 5000, dev, 7), 8))
    # 32 keys over 32 buckets: each lane sees more buckets than its cache
    # holds (4 for q1's spec), so the warp flushes mid-run
    cases.append(("q1 cache overflow G=32 key domain 32", q1_spec,
                  random_batch(schema, 1 << 20, 32, dev, 9), 32))
    for label, spec, b, G in cases:
        ng, left, err = compare_outputs(
            fsa.fused_scan_agg(spec, b, G, OUT_CAP),
            fsa.fused_scan_agg_plain(spec, b, G, OUT_CAP), label)
        if label.endswith("high-cardinality") and not left:
            raise AssertionError("high-cardinality case must leave rows over")
        print(f"compare {label}: groups={ng} leftover={left} "
              f"max_abs_err={err:.3g}")
    _, _, main_err = compare_outputs(
        fsa.fused_scan_agg(q1_spec, batch, BUCKETS, OUT_CAP),
        fsa.fused_scan_agg_plain(q1_spec, batch, BUCKETS, OUT_CAP),
        "q1 main-path inputs")
    print(f"compare q1 main-path inputs: max_abs_err={main_err:.3g}")
    compare_murmur3(dev)
    compare_probe_cases(dev)
    compare_gather(dev)
    q3_in = JoinInputs(q3.child._source)
    q3i_in = JoinInputs(q3i.child._source)
    q19_in = JoinInputs(q19._source)
    # every row gather of each path, captured from a run of a fresh plan
    # (the counted runs below start with the join's size cache cold)
    gathers = {"q3": capture_row_gathers(q3_plan(d3, dev, "LONG")),
               "q3 INT keys": capture_row_gathers(q3_plan(d3i, dev, "INT")),
               "q19": capture_row_gathers(q19_plan(port_modules(), l19,
                                                   p19))}
    compare_join_inputs("q3", q3_in, gathers["q3"])
    compare_join_inputs("q3 INT keys", q3i_in, gathers["q3 INT keys"])
    compare_join_inputs("q19", q19_in, gathers["q19"])
    compare_dict_gather(dev, l19)
    # the string paths' own gathers (phase 3b drives them): P6's filter
    # compaction and sort, P7's build permute and payloads, and P7's
    # dictionary-hash takes by the stream's codes
    pm = port_modules()
    gathers["P6"] = capture_row_gathers(tpch_q1_tree(pm,
                                                     scan_of(pm, q1t_batch)))
    p7_takes = {}
    for enc, (lines7, build7) in p7_batches.items():
        key = "P7 dictionary build" if enc else "P7 string build"
        gathers[key] = capture_row_gathers(shipmode_join_tree(
            pm, scan_of(pm, lines7), scan_of(pm, build7)))
        p7_takes[key] = capture_dict_gathers(shipmode_join_tree(
            pm, scan_of(pm, lines7), scan_of(pm, build7)))
    for key in ("P6", "P7 string build", "P7 dictionary build"):
        print(f"compare {key} main-path row gathers: "
              f"{'; '.join(compare_row_gathers(key, gathers[key]))}; exact")
    for key, takes in p7_takes.items():
        if not any(i.shape[0] >= q1t_batch.num_rows_host for _, i in takes):
            raise AssertionError(f"{key}: no take by the stream's codes")
        print(f"compare {key} main-path dictionary gathers: "
              f"{'; '.join(compare_dict_takes(key, takes))}; exact")
    # the shuffle paths' own inputs (phase 3b drives them): every row
    # gather of P9-P11 (the exchanges' reorders among them), the pid
    # hash, and P11's join kernels at a partition pair
    gathers["P9"] = capture_row_gathers(q1_tree(pm, pm.basic.InMemoryScanExec(
        p9_batches, schema), P_PARTS))
    gathers["P10"] = capture_row_gathers(tpch_q1_tree(
        pm, scan_of(pm, q1t_batch), n_parts=P_PARTS))
    gathers["P11"] = capture_row_gathers(p11_plan(d3, dev, "LONG"))
    gathers["P11 static"] = capture_row_gathers(p11_plan(d3, dev, "LONG",
                                                         STATIC_CONF))
    for key in ("P9", "P10"):
        print(f"compare {key} main-path row gathers: "
              f"{'; '.join(compare_row_gathers(key, gathers[key]))}; exact")
    compare_join_inputs("P11 (its single build)",
                        single_build_inputs(p11_join(p11_plan(d3, dev,
                                                              "LONG"))),
                        gathers["P11"])
    compare_join_inputs("P11 static (its first partition pair)",
                        shuffled_join_inputs(p11_join(p11_plan(
                            d3, dev, "LONG", STATIC_CONF))),
                        gathers["P11 static"])
    pid_cols = compare_pid_hash(dev, d3, d3i)
    # the join types' own inputs (phase 3d drives them): every row gather
    # of Q21, its semi join's hash, probe and gathers, its anti join's
    # probe, its dictionary gathers; then compare_join_paths
    gathers["P13"] = capture_row_gathers(q21_plan(pm, jb))
    compare_join_inputs("P13 Q21 semi join", JoinInputs(q21_join(
        q21_plan(pm, jb), 6)), gathers["P13"])
    anti_in = JoinInputs(q21_join(q21_plan(pm, jb), 5))
    hits = compare_probe("probe P13 Q21 anti join", anti_in.probe,
                         anti_in.cand_cap, anti_in.total)
    print(f"compare P13 Q21 anti join probe: {anti_in.stream_rows} stream "
          f"rows into {anti_in.build_rows} build rows, candidate total "
          f"{anti_in.total} in {anti_in.cand_cap} slots, {hits} verified "
          f"pairs; exact")
    q21_takes = capture_dict_gathers(q21_plan(pm, jb))
    if not any(i.shape[0] >= jb["orders"].num_rows_host
               for _, i in q21_takes):
        raise AssertionError("P13: no dictionary gather over o_orderstatus")
    print(f"compare P13 Q21 main-path dictionary gathers: "
          f"{'; '.join(compare_dict_takes('P13', q21_takes))}; exact")
    del q21_takes
    compare_join_paths(dev, dj, jb, d3,
                       {site for site, *_ in gathers["P13"]})
    # P17-P20's own inputs (phase 3e drives them): P19's hashes, probes
    # and dictionary takes, every row gather of each path (decimal limbs
    # among the payloads)
    with default_conf_after():
        compare_types_paths(dev, tm, tb)
    # P21-P23's own inputs (phase 3f drives them): every launch of a run
    with default_conf_after():
        compare_strings_paths(dev, str_m, str_b, strings_want)
    # P26-P28's own inputs (phase 3g drives them): every row gather and
    # dictionary take of a run of each path
    with default_conf_after():
        compare_windows_paths(dev, win_m, win_b)
    # P29-P31's own inputs (phase 3h drives them): every row gather and
    # dictionary take of a run of each path
    with default_conf_after():
        compare_nested_paths(dev, nest_m, nest_b)
    # P32's own inputs (phase 3i drives them): every murmur3 chain, probe
    # and row gather launch of a run of each path
    with default_conf_after():
        compare_adaptive_paths(dev, join_session_modules(), tm, jb, tb)
    # P38's own inputs (phase 3k drives it): every row gather of its split
    # and converted plans, the join's kernels at the split's hot probe
    # window and at the converted pass's one build
    with default_conf_after():
        compare_p38(pd38, jb["orders"], dev)
    # P40's own inputs (phase 3m drives them): every murmur3 chain, probe
    # and row gather launch of a run of each query over its file's table
    with default_conf_after():
        compare_file_paths(dev, join_session_modules(), files, dj, jb, q3d,
                           tb)
    # P41's own inputs (phase 3n drives them): every row gather of each
    # command's plans, MERGE's murmur3 chains and probes, DELETE's
    # dictionary gathers
    with default_conf_after():
        compare_delta_paths(dev, join_session_modules(), jb["orders"],
                            p41_batch)
    # P42's own inputs (phase 3o drives them): every murmur3 chain, probe
    # and row gather launch of a run of q3 over the mesh and through the
    # host exchange's device lane, and Q1's row gathers over the mesh
    with default_conf_after():
        compare_mesh_paths(dev, session_modules(), d3, q1t_batch, p42_o,
                           p42_l)
    shuffle_root_empty("phase 2")
    torch.cuda.synchronize()

    # -- phase 3: the main paths, counted -----------------------------------
    rows, q1_counts = drive_counted("q1", plan, ["fused_scan_agg"])
    if q1_counts["fused_scan_agg"] != 1:
        raise AssertionError(f"q1: {q1_counts} (one fused_scan_agg launch)")
    if sorted(r[0] for r in rows) != sorted(oracle):
        raise AssertionError(f"q1 groups {rows} != oracle {oracle}")
    for k, qty, dp, cnt in rows:
        oq, odp, oc = oracle[k]
        if qty != oq or cnt != oc or abs(dp - odp) > RTOL * abs(odp):
            raise AssertionError(f"q1 group {k}: {(qty, dp, cnt)} != "
                                 f"oracle {oracle[k]}")
    print(f"q1 at {ROWS} rows: {len(rows)} groups equal to the numpy "
          f"oracle; launches {q1_counts}")
    q3_need = ["murmur3_columns", "fused_probe_verify", "dma_row_gather"]
    # launches per run of each path: every row gather and probe call, and
    # one murmur3 launch per join side (both seeds of the build in one);
    # the per-row-seed lanes are off the main paths
    want = {"dma_row_gather": (5, 3), "fused_probe_verify": (1, 1),
            "murmur3_columns": (2, 2), "murmur3_long_lanes": (0, 0),
            "murmur3_int_lanes": (0, 0)}
    rows, q3_counts = drive_counted("q3", q3, q3_need)
    check_q3(rows, q3_want, "q3")
    print(f"q3 at {Q3_LINES} x {Q3_ORDERS}: top 10 equal to the numpy "
          f"oracle; launches {q3_counts}")
    rows, warm_counts = drive_counted("q3 warm", q3, q3_need)
    check_q3(rows, q3_want, "q3 warm")
    print(f"q3 again, speculative size cache warm: equal to the oracle; "
          f"launches {warm_counts}")
    rows, q3i_counts = drive_counted("q3 INT keys", q3i, q3_need)
    check_q3(rows, q3_want, "q3 INT keys")
    print(f"q3 with INT order keys: equal to the oracle; launches "
          f"{q3i_counts}")
    join_rows = q19._source.metrics["numOutputRows"]
    before = join_rows.value
    rows, q19_counts = drive_counted(
        "q19", q19, ["dict_gather"] + q3_need)
    pairs = join_rows.value - before
    check_q19(rows, pairs, q19_want, "q19")
    if q19_counts["dict_gather"] != 42:
        raise AssertionError(f"q19: {q19_counts} (42 dict_gather launches)")
    for label, counts in (("q3", q3_counts), ("q3 warm", warm_counts),
                          ("q3 INT keys", q3i_counts), ("q19", q19_counts)):
        for name, (n3, n19) in want.items():
            need = n19 if label == "q19" else n3
            if counts[name] != need:
                raise AssertionError(f"{label}: {counts[name]} {name} "
                                     f"launches, not {need}")
    print(f"q19 at SF1 ({Q19_LINES} x {Q19_PARTS}): revenue {rows[0][0]!r} "
          f"over {pairs} qualifying rows, equal to the numpy oracle; "
          f"launches {q19_counts}")

    # -- phase 3b: late materialization and the memory runtime -------------
    from spark_rapids_tpu_torch.columnar import encoded
    before, rows_before = encoded.counters(), join_rows.value
    out, p1_counts, p1_reads = drive_batches(
        "P1 q19 decoded", q19, ["dict_gather"] + q3_need)
    dec = {k: encoded.counters()[k] - before[k]
           for k in ("materializations", "materialized_bytes")}
    check_q19([r for b in out for r in b.to_pylist()],
              join_rows.value - rows_before, q19_want, "P1")
    if dec["materializations"] < 1:
        raise AssertionError(f"P1: no decode at the boundary ({dec})")
    print(f"P1 q19 decoded at the join->aggregate boundary: equal to the "
          f"oracle; {dec} (one host read each); host reads in the run "
          f"{p1_reads}; launches {p1_counts}")
    p2, p2_counts, p2_rec = drive_under_budget(
        "P2 q3 under budget",
        lambda: q3_plan(d3, dev, "LONG", P2_LINE_BATCHES), q3_need,
        lambda out, label: check_q3([r for b in out for r in b.to_pylist()],
                                    q3_want, label), split=True)
    p3, p3_counts, p3_rec = drive_under_budget(
        "P3 out-of-core sort", lambda: sort_plan(d3, dev),
        ["dma_row_gather"], lambda out, label: check_sort(out, d3, label),
        split=False)
    p3_rec["merge_passes"] = p3.metrics["mergePasses"].value
    p3_rec["merge_host_reads"] = p3.metrics["mergeHostReads"].value
    if p3_rec["merge_passes"] != 2:
        raise AssertionError(f"P3: {p3_rec['merge_passes']} merge passes")
    print(f"P3: {p3_rec['merge_passes']} merge passes, "
          f"{p3_rec['merge_host_reads']} merge host reads")

    # -- phase 3b, slice 5: q3 and Q19 from host data ----------------------
    t_scan = time.perf_counter()
    from spark_rapids_tpu_torch.columnar import upload
    from spark_rapids_tpu_torch.memory import reset_tpu_semaphore
    reset_tpu_semaphore()  # spark.rapids.sql.concurrentGpuTasks permits
    upload.reset_staging_pool()
    p4_batches = P2_LINE_BATCHES + P4_ORDER_BATCHES
    # the yardstick: the same plan over the same batches built on the
    # card, with no injected split (which adds two row gathers to P2's
    # own unconstrained run)
    rows, p2_free, _, _ = drive_collect(
        "q3 over device batches", q3_plan(d3, dev, "LONG", P2_LINE_BATCHES,
                                          P4_ORDER_BATCHES), q3_need)
    check_q3(rows, q3_want, "q3 over device batches")
    print(f"q3 over {P2_LINE_BATCHES} lineitem and {P4_ORDER_BATCHES} "
          f"order batches built on the card, no injection: launches "
          f"{p2_free} (P2's unconstrained run with its injected split: "
          f"{p2_rec['unconstrained_launches']})")
    p4_rows, p4_counts, p4_io = {}, {}, {}
    for depth in (0, 2):
        label = f"P4 q3 from the host, depth {depth}"
        rows, counts, io, ms = drive_collect(
            label, q3_source_plan(d3, dev, depth, P2_LINE_BATCHES,
                                  P4_ORDER_BATCHES), q3_need)
        check_q3(rows, q3_want, label)
        check_scan_io(label, io, p4_batches, 1)
        if counts != p2_free:
            raise AssertionError(f"{label}: launches {counts} != those of "
                                 f"q3 over device batches {p2_free}")
        check_idle(label)
        p4_rows[depth], p4_counts[depth], p4_io[depth] = rows, counts, io
        print(f"{label}: equal to the oracle in {ms:.1f} ms (first run); "
              f"{io['uploads']} uploads in {io['transfers']} transfers, "
              f"{io['d2h_copies']} device->host copy, pool misses "
              f"{io['pool_misses']}; launches {counts}, as q3 over "
              f"device batches; no permit held, catalog empty")
    if [(k, np.float64(v).tobytes()) for k, v in p4_rows[0]] != \
            [(k, np.float64(v).tobytes()) for k, v in p4_rows[2]]:
        raise AssertionError(f"P4: depth 0 rows {p4_rows[0]} != depth 2 "
                             f"rows {p4_rows[2]}")
    print("P4: depth 0 and depth 2 rows bit-identical")
    q19_bucket = upload._byte_bucket(
        upload.HEADER_BYTES + upload.layout_nbytes(
            [upload.column_layout(c) for c in l19.columns]))
    pinned_ms = pinned_alloc_ms(q19_bucket)
    print(f"pinned allocation of Q19's {q19_bucket}-byte staging bucket: "
          f"{pinned_ms[0]:.2f} ms fresh, {pinned_ms[1]:.2f} ms from "
          f"PyTorch's caching host allocator")
    q19s = q19_source_plan(d19, dev, 2)
    join_rows = q19s._source.metrics["numOutputRows"]
    rows_before = join_rows.value
    rows, p5_counts, p5_io, p5_first_ms = drive_collect(
        "P5 q19 from the host", q19s, ["dict_gather"] + q3_need)
    check_q19(rows, join_rows.value - rows_before, q19_want, "P5")
    check_scan_io("P5", p5_io, 2, 1)
    if p5_counts != q19_counts:
        raise AssertionError(f"P5: launches {p5_counts} != phase 3's q19 "
                             f"{q19_counts}")
    check_idle("P5")
    print(f"P5 q19 from the host, depth 2: equal to the oracle in "
          f"{p5_first_ms:.1f} ms (first run); {p5_io['uploads']} uploads "
          f"in {p5_io['transfers']} transfers, {p5_io['d2h_copies']} "
          f"device->host copy, pool misses {p5_io['pool_misses']}; "
          f"launches {p5_counts} (phase 3's q19: {q19_counts})")
    print(f"P4 and P5 (phase 3b): {time.perf_counter() - t_scan:.1f} s")

    # -- phase 3b, slice 6: string keys ------------------------------------
    t_str = time.perf_counter()
    m = port_modules()
    strings = drive_string_paths(m, dev, q1t_batch, q1t_want, p7_batches,
                                 p7_want, names)
    p6, p6_counts, p6_rec, p7_counts, p7_rec, p8_counts, p8_rec = strings
    print(f"P6-P8 (phase 3b): {time.perf_counter() - t_str:.1f} s")

    # -- phase 3b, slice 7: the host shuffle --------------------------------
    t_shuf = time.perf_counter()
    shuffled = drive_shuffle_paths(dev, p9_batches, oracle, q1t_batch,
                                   q1t_want, d3, d3i, q3_want)
    print(f"P9-P11 (phase 3b): {time.perf_counter() - t_shuf:.1f} s")

    # -- phase 3c, slice 8: the same queries planned from DataFrames -------
    t_plan = time.perf_counter()
    sm = session_modules()
    TpuSession = sm.session.TpuSession
    sess, q3_sess = TpuSession(device=DEVICE), TpuSession(Q3_CONF, DEVICE)
    p11_sess = TpuSession(P11_CONF, DEVICE)

    def q3_side_batches(d_, key, n_lines=1, n_orders=1):
        o_schema, l_schema = q3_schemas(key)
        return (q3_batches(d_, dev, o_schema, Q3_ORDERS, n_orders),
                q3_batches(d_, dev, l_schema, Q3_LINES, n_lines))

    def q19_pairs(metrics):
        return next(v["numOutputRows"] for k, v in metrics.items()
                    if k.startswith("HashJoinExec#"))

    q3_need = ["murmur3_columns", "fused_probe_verify", "dma_row_gather"]
    session_dfs = {
        "q1": q1_df(sm, sess, [batch]),
        "q3": q3_df(sm, q3_sess, *q3_side_batches(d3, "LONG")),
        "q3 INT keys": q3_df(sm, q3_sess, *q3_side_batches(d3i, "INT")),
        "q19": q19_df(sm, sess, l19, p19),
        "P6": tpch_q1_df(sm, sess, q1t_batch),
        "P11": q3_df(sm, p11_sess, *q3_side_batches(
            d3, "LONG", P11_LINE_BATCHES, P11_ORDER_BATCHES)),
        "P11 static": q3_df(sm, TpuSession(dict(P11_CONF, **STATIC_CONF),
                                           DEVICE), *q3_side_batches(
            d3, "LONG", P11_LINE_BATCHES, P11_ORDER_BATCHES))}
    planned_recs = {}
    for label, need, hand, check, hand_shape in (
            ("q1", ["fused_scan_agg"], q1_counts,
             lambda r, lb, _: check_q1(r, oracle, lb), plan_shape(plan)),
            ("q3", q3_need, q3_counts,
             lambda r, lb, _: check_q3(r, q3_want, lb), None),
            ("q3 INT keys", q3_need, q3i_counts,
             lambda r, lb, _: check_q3(r, q3_want, lb), None),
            ("q19", ["dict_gather"] + q3_need, q19_counts,
             lambda r, lb, mx: check_q19(r, q19_pairs(mx), q19_want, lb),
             None),
            ("P6", ["dma_row_gather"], p6_counts,
             lambda r, lb, _: check_rows(r, q1t_want, lb), plan_shape(p6)),
            ("P11", q3_need, shuffled["P11"][1],
             lambda r, lb, _: check_q3(r, q3_want, lb),
             plan_shape(shuffled["P11"][0])),
            ("P11 static", q3_need, shuffled["P11_static"][1],
             lambda r, lb, _: check_q3(r, q3_want, lb),
             plan_shape(shuffled["P11_static"][0]))):
        planned_recs[label] = drive_planned(
            f"{label} planned", sm, session_dfs[label], need, hand, check,
            hand_shape)
    print(f"phase 3c: {time.perf_counter() - t_plan:.1f} s")

    # -- phase 3d, slice 9: the join types and the basic operators --------
    t_join = time.perf_counter()
    join_counts, join_recs, join_runs = drive_join_paths(
        dev, dj, jb, d3, d19, q1t_batch)
    print(f"phase 3d: {time.perf_counter() - t_join:.1f} s")

    # -- phase 3e, slice 10: decimals, dates, sample and the range sort ----
    t_types = time.perf_counter()
    with default_conf_after():
        types_counts, types_recs, types_runs = drive_types_paths(
            dev, tm, tb, types_want)
    print(f"phase 3e: {time.perf_counter() - t_types:.1f} s")

    # -- phase 3f, slice 11: strings, regex and the new aggregates ---------
    t_strings = time.perf_counter()
    with default_conf_after():
        str_counts, str_recs, str_runs, str_trees = drive_strings_paths(
            dev, str_m, str_b, strings_want)
    print(f"phase 3f: {time.perf_counter() - t_strings:.1f} s")

    # -- phase 3g, slice 12: windows, arrays, split, the list aggregates
    # and the cache ----------------------------------------------------------
    t_windows = time.perf_counter()
    with default_conf_after():
        win_counts, win_recs, win_runs, win_trees = drive_windows_paths(
            dev, win_m, win_b, win_checks)
    print(f"phase 3g: {time.perf_counter() - t_windows:.1f} s")

    # -- phase 3h, slice 13: structs, maps, lambdas, JSON, URL, z-order ----
    t_nested = time.perf_counter()
    with default_conf_after():
        nest_counts, nest_recs, nest_runs, nest_trees = drive_nested_paths(
            dev, nest_m, nest_b, nest_checks)
    print(f"phase 3h: {time.perf_counter() - t_nested:.1f} s")

    # -- phase 3i, slice 14: the adaptive join, the host row engine, UDFs
    # and the cost model ------------------------------------------------------
    t_adaptive = time.perf_counter()
    with default_conf_after():
        ad_counts, ad_recs, ad_runs = drive_adaptive_paths(
            dev, join_session_modules(), tm, jb, tb, dj, q3d, types_want,
            card=smi)
    print(f"phase 3i: {time.perf_counter() - t_adaptive:.1f} s")

    # -- phase 3j, slice 15: the governed collect -------------------------
    t_gov = time.perf_counter()
    with default_conf_after():
        gov_recs, gov_launches = drive_governed_paths(
            dev, join_session_modules(), tm, d3, q3_want, l19, p19,
            q19_want, jb, tb, types_want, q4_oracle(dj), p2_rec, p3_rec)
    print(f"phase 3j: {time.perf_counter() - t_gov:.1f} s")

    # -- phase 3k, slice 16: the adaptive read plan and the robustness
    # paths ------------------------------------------------------------------
    t_a9b = time.perf_counter()
    with default_conf_after():
        a9b_recs, a9b_launches = drive_a9b_paths(
            dev, join_session_modules(), dj, jb, p9_batches, oracle, d3,
            q3_want, q4_oracle(dj), pd38, p38_want)
    print(f"phase 3k: {time.perf_counter() - t_a9b:.1f} s")

    # -- phase 3l, slice 17: the stage compiler, a CUDA graph per stage
    # step (P39) -------------------------------------------------------------
    t_stage = time.perf_counter()
    map_want = map_path_oracle(d3)
    stage_paths = {
        "q1": (lambda c: q1_df(sm, TpuSession(c, DEVICE), [batch]),
               lambda r, lb, _: check_q1(r, oracle, lb), ["fused_scan_agg"],
               "agg"),
        "q3": (lambda c: q3_df(sm, TpuSession(dict(Q3_CONF, **c), DEVICE),
                               *q3_side_batches(d3, "LONG")),
               lambda r, lb, _: check_q3(r, q3_want, lb), q3_need,
               "join_agg"),
        "q19": (lambda c: q19_df(sm, TpuSession(c, DEVICE), l19, p19),
                lambda r, lb, mx: check_q19(r, q19_pairs(mx), q19_want, lb),
                ["dict_gather"] + q3_need, "join_agg"),
        "map": (lambda c: map_path_df(sm, TpuSession(c, DEVICE), q3_batches(
            d3, dev, q3_schemas("LONG")[1], Q3_LINES, P11_LINE_BATCHES)),
            lambda r, lb, _: check_map_path(r, map_want, lb),
            ["dma_row_gather"], "map")}
    with default_conf_after():
        stage_recs, stage_launches = drive_stage_paths(stage_paths)
        stage_recs["q3 under P2's budget"] = drive_stage_budget(
            sm, dev, d3, q3_want, p2_rec)
    print(f"phase 3l: {time.perf_counter() - t_stage:.1f} s")

    # -- phase 3m, slice 18: the file lane (P40) ----------------------------
    t_files = time.perf_counter()
    with default_conf_after():
        file_recs, file_launches = drive_file_paths(
            dev, join_session_modules(), files, dj, jb, q3d, tb,
            {"P40 avro": q4_oracle(dj), "P40 hive": types_want["P19"]})
    shutil.rmtree(workdir)
    print(f"phase 3m: {time.perf_counter() - t_files:.1f} s")

    # -- phase 3n, slice 19: Delta's DML plans (P41) ------------------------
    t_delta = time.perf_counter()
    with default_conf_after():
        delta_recs, delta_launches = drive_delta_paths(
            dev, join_session_modules(), jb["orders"], p41_batch, p41_want)
    print(f"phase 3n: {time.perf_counter() - t_delta:.1f} s")

    # -- phase 3o, slice 20: the mesh lane (P42) ----------------------------
    t_mesh = time.perf_counter()
    with default_conf_after():
        mesh_recs, mesh_launches = drive_mesh_paths(
            dev, session_modules(), d3, q3_want, q1t_batch, q1t_want, p42_o,
            p42_l)
    print(f"phase 3o: {time.perf_counter() - t_mesh:.1f} s")

    # -- phase 3p, slice 21: the tooling (P43) -------------------------------
    t_tool = time.perf_counter()
    with default_conf_after():
        tool_recs, tool_launches = drive_tooling_paths(
            dev, session_modules(), fuzz_futures, d3, q3_want, p42_o,
            p42_l, l19, p19, q19_want, q1t_batch, q1t_want)
    fuzz_pool.shutdown()
    print(f"phase 3p: {time.perf_counter() - t_tool:.1f} s (fuzz data made "
          f"in the workers in {tool_recs['fuzz_data_s']} s, waited "
          f"{tool_recs['fuzz_data_wait_s']:.1f} s)")

    # -- phase 4: steady state and kernel timings ----------------------------
    in_bytes = sum(ROWS * (c.data.element_size() + 1) for c in batch.columns)
    with speculation_scope() as scope:
        list(plan.execute())  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            list(plan.execute())
        torch.cuda.synchronize()
        q1_ms = (time.perf_counter() - t0) * 1e3 / ITERS
        if scope.tripped():
            raise AssertionError("speculation flag tripped in steady state")
    print(f"q1 steady state: {q1_ms:.3f} ms/iteration, "
          f"{in_bytes / q1_ms / 1e6:.1f} GB/s of column data "
          f"({ITERS} iterations, one sync)")
    q3_bytes = sum(v.nbytes for v in d3.values())
    with speculation_scope() as scope:
        list(q3.execute())  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(Q3_ITERS):
            list(q3.execute())
        torch.cuda.synchronize()
        q3_ms = (time.perf_counter() - t0) * 1e3 / Q3_ITERS
        if scope.tripped():
            raise AssertionError("q3 speculation flag tripped in steady "
                                 "state")
    print(f"q3 steady state: {q3_ms:.3f} ms/iteration, "
          f"{q3_bytes / q3_ms / 1e6:.1f} GB/s of column data "
          f"({Q3_ITERS} iterations, one sync)")
    q19_bytes = sum(
        x.nbytes for b in (l19, p19) for c in b.columns
        for x in ((c.codes, c.validity, c.dict_data, c.dict_offsets)
                  if hasattr(c, "codes") else (c.data, c.validity)))
    with speculation_scope() as scope:
        list(q19.execute())  # warm
        torch.cuda.synchronize()
        before = encoded.counters()
        t0 = time.perf_counter()
        for _ in range(Q19_ITERS):
            list(q19.execute())
        torch.cuda.synchronize()
        q19_ms = (time.perf_counter() - t0) * 1e3 / Q19_ITERS
        if scope.tripped():
            raise AssertionError("q19 speculation flag tripped in steady "
                                 "state")
    per_iter = {k: (encoded.counters()[k] - before[k]) / Q19_ITERS
                for k in ("materializations", "materialized_bytes")}
    print(f"q19 steady state, decoded at the boundary (P1): {q19_ms:.3f} "
          f"ms/iteration, {q19_bytes / q19_ms / 1e6:.1f} GB/s of column "
          f"data ({q19_bytes} bytes, {Q19_ITERS} iterations, one sync); "
          f"per iteration {per_iter}")
    for label, plan_, rec in (("P2 q3 under budget", p2, p2_rec),
                              ("P3 out-of-core sort", p3, p3_rec)):
        rec["ms"] = time_under_budget(plan_, rec)
        print(f"{label}: {rec['ms']} ms per iteration ({P_ITERS} runs, "
              f"budget {rec['budget']}, host limit {rec['host_limit']})")
    rate_bytes, rates = spill_rates(q3_batches(
        d3, dev, q3_schemas("LONG")[1], Q3_LINES)[0])
    print(f"spill lane on the {rate_bytes}-byte lineitem batch, GB/s: "
          f"{rates}")

    t_scan = time.perf_counter()
    # P4 in turns with its yardstick, the same plan over the same batches
    # built on the card ("device"), then P5; the pool's misses
    # after P4's first iteration (phase 3b) must stay 0
    misses = io_counters()["pool_misses"]
    p4_ms = {"device": [], 0: [], 2: []}
    plans = {k: q3_source_plan(d3, dev, k, P2_LINE_BATCHES,
                               P4_ORDER_BATCHES) for k in (0, 2)}
    plans["device"] = q3_plan(d3, dev, "LONG", P2_LINE_BATCHES,
                              P4_ORDER_BATCHES)
    for i in range(P4_ITERS):
        order = ("device", 0, 2) if i % 2 == 0 else (2, 0, "device")
        for k in order:
            t0 = time.perf_counter()
            check_q3(plans[k].collect(), q3_want, f"P4 {k}")
            torch.cuda.synchronize()
            p4_ms[k].append((time.perf_counter() - t0) * 1e3)
    p4_misses = io_counters()["pool_misses"] - misses
    if p4_misses:
        raise AssertionError(f"P4: {p4_misses} staging pool misses after "
                             f"the first iteration")
    check_idle("P4 timed")
    print(f"P4 ms per iteration ({P4_ITERS} each, in turns): depth 0 "
          f"{p4_ms[0]}, depth 2 {p4_ms[2]}; the same plan over batches "
          f"built on the card {p4_ms['device']}; pool misses after the "
          f"first iteration {p4_misses}")
    p5_ms = []
    misses = io_counters()["pool_misses"]
    for _ in range(P5_ITERS):
        t0 = time.perf_counter()
        q19s.collect()
        torch.cuda.synchronize()
        p5_ms.append((time.perf_counter() - t0) * 1e3)
    p5_misses = io_counters()["pool_misses"] - misses
    check_idle("P5 timed")
    print(f"P5 ms per iteration: {p5_ms}; pool misses {p5_misses} (the "
          f"lineitem bucket is larger than the pool keeps)")
    l_schema = q3_schemas("LONG")[1]
    step = Q3_LINES // P2_LINE_BATCHES
    q19_l_schema = q19_schemas(t)[0]

    def q3_per_buffer():
        ColumnarBatch.from_numpy_columns(
            [(d3[f.name][:step], np.ones(step, np.bool_))
             for f in l_schema.fields], l_schema, step, device=dev)

    first_part = q3_host_parts(d3, l_schema, Q3_LINES, P2_LINE_BATCHES)[0]
    ingest = {
        "q3_lineitem_batch": upload_rates(
            lambda: first_part()[0], step, l_schema, dev, q3_per_buffer),
        "q19_lineitem_batch": upload_rates(
            lambda: q19_columns(d19, q19_l_schema, "cpu")[0], Q19_LINES,
            q19_l_schema, dev, lambda: q19_columns(d19, q19_l_schema, dev))}
    for k, v in ingest.items():
        print(f"ingest of the {k} ({v['bytes']} packed bytes): host build "
              f"{v['build_ms']:.3f} ms, staging acquire "
              f"{v['acquire_ms']:.3f} ms, host pack {v['pack_gb_s']:.2f} "
              f"GB/s, copy {v['link_gb_s']:.2f} GB/s; packed upload "
              f"{v['upload_ms']:.3f} ms, per-buffer build "
              f"{v['per_buffer_ms']:.3f} ms")
    print(f"P4, P5 and the upload rates (phase 4): "
          f"{time.perf_counter() - t_scan:.1f} s")

    # P6 and P7 in steady state, as Q19 (one synchronisation per run of
    # iterations); each run reads its hash route's leftover flag
    def steady_ms(plan_):
        list(plan_.execute())  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(P6_ITERS):
            list(plan_.execute())
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / P6_ITERS

    p6_rec["ms"] = steady_ms(p6)
    print(f"P6 TPC-H Q1 steady state: {p6_rec['ms']:.3f} ms/iteration "
          f"({P6_ITERS} iterations, one sync)")
    for enc, (lines7, build7) in p7_batches.items():
        key = "dictionary_build" if enc else "string_build"
        p7_rec[key]["ms"] = steady_ms(
            shipmode_join_tree(m, scan_of(m, lines7), scan_of(m, build7)))
        print(f"P7 ship-mode join ({key}) steady state: "
              f"{p7_rec[key]['ms']:.3f} ms/iteration ({P6_ITERS} "
              f"iterations, one sync)")

    t_shuf = time.perf_counter()
    shuffle_recs = time_shuffle_paths(shuffled, oracle, q1t_want, q3_want)
    fetch_rates = split_fetch_rates(dev, d3)
    pid_recs = time_pid_hash(pid_cols)
    reorder_recs = [time_gather_call(path, *call) for path, calls in
                    reorder_gathers({k: gathers[k] for k in
                                     ("P9", "P10", "P11")}).items()
                    for call in calls]
    print(f"P9-P11 timings (phase 4): {time.perf_counter() - t_shuf:.1f} s")
    t_sess = time.perf_counter()
    session_ms = time_session_paths({
        "q1": (session_dfs["q1"], plan,
               lambda r, lb: check_q1(r, oracle, lb)),
        "q3": (session_dfs["q3"], q3, lambda r, lb: check_q3(r, q3_want, lb)),
        "q19": (session_dfs["q19"], q19, lambda r, lb: check_q19(
            r, q19_want[1], q19_want, lb))})
    print(f"session timings (phase 4): {time.perf_counter() - t_sess:.1f} s")
    t_join = time.perf_counter()
    join_ms = time_join_paths(join_runs)
    q21_probes, q21_gathers = q21_kernel_shapes(
        jb, join_counts["P13"]["fused_probe_verify"])
    print(f"P12-P16 timings and Q21's kernel shapes (phase 4): "
          f"{time.perf_counter() - t_join:.1f} s")
    t_types = time.perf_counter()
    types_ms = time_join_paths(types_runs)
    with default_conf_after():
        p19_shapes = p19_kernel_shapes(dev, tm, tb, types_counts["P19"])
    print(f"P17-P20 timings and P19's kernel shapes (phase 4): "
          f"{time.perf_counter() - t_types:.1f} s")
    t_strings = time.perf_counter()
    strings_ms = time_strings_paths(str_runs)
    with default_conf_after():
        str_shapes = strings_kernel_shapes(dev, str_m, str_b, strings_want,
                                           str_counts)
    print(f"P21-P25 timings and P21's and P22's kernel shapes (phase 4): "
          f"{time.perf_counter() - t_strings:.1f} s")
    t_windows = time.perf_counter()
    with default_conf_after():
        windows_ms = time_windows_paths(win_runs)
        win_gathers = windows_gather_shapes(dev, win_m, win_b)
    print(f"P26-P28 timings and their row gather shapes (phase 4): "
          f"{time.perf_counter() - t_windows:.1f} s")
    t_nested = time.perf_counter()
    with default_conf_after():
        nested_ms = time_nested_paths(nest_runs)
        nest_gathers = nested_gather_shapes(dev, nest_m, nest_b)
    print(f"P29-P31 timings and their row gather shapes (phase 4): "
          f"{time.perf_counter() - t_nested:.1f} s")
    t_adaptive = time.perf_counter()
    with default_conf_after():
        adaptive_ms = time_adaptive_paths(ad_runs)
    print(f"P32 and P33 timings (phase 4): "
          f"{time.perf_counter() - t_adaptive:.1f} s")

    # contract: ok dispatch-ledger — times the kernel alone; the compared launches count nothing
    launch = fsa.launcher(q1_spec, batch, BUCKETS)
    ms = device_ms(launch, KERNEL_REPS)
    b2b_ms = cuda_ms(launch, KERNEL_REPS)
    call_ms = device_ms(
        lambda: fsa._partials_cuda(q1_spec, batch, BUCKETS), KERNEL_REPS)
    plain_ms = device_ms(
        lambda: fsa._partials_plain(q1_spec, batch, BUCKETS),
        max(3, KERNEL_REPS // 4))
    out_bytes = BUCKETS * sum(fsa._slots(q1_spec)) * 8
    bound_ms, bound_by = bound(in_bytes + out_bytes,
                               ROWS * ops_per_row(q1_spec))
    print(f"fused_scan_agg: kernel launches {ms:.4f} ms on the device, "
          f"{b2b_ms:.4f} ms back to back; wrapper call with its "
          f"allocations {call_ms:.4f} ms; plain {plain_ms:.4f} ms; "
          f"bound {bound_ms:.4f} ms ({bound_by}), "
          f"{bound_ms / ms:.1%} of the bound")
    records = [{
        "name": "fused_scan_agg",
        "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/fused_scan_agg.cu.in",
        "replaces": "spark_rapids_tpu/ops/pallas_fused.py:215",
        "launches": q1_counts["fused_scan_agg"],
        "max_abs_err": main_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }] + time_murmur3(q3_in, q3i_in, q19_in, q3_counts, q3i_counts) + [
        time_probe(q3_in, q19_in, {"q3": q3_counts["fused_probe_verify"],
                                   "q19": q19_counts["fused_probe_verify"]}),
        time_row_gathers({k: gathers[k] for k in (
            "q3", "q19", "P6", "P7 string build", "P7 dictionary build")},
            q3_counts["dma_row_gather"]),
        time_dict_gather(l19, q19_counts["dict_gather"],
                         max(p7_takes["P7 string build"],
                             key=lambda ti: ti[1].shape[0]),
                         p7_counts["string_build"]["dict_gather"])]
    # after the kernel timings: a profiled process times short launches
    # slower and less evenly
    if args.profile:
        profile_plan("q1", plan, 10, args.profile)
        profile_plan("q3", q3, Q3_ITERS, args.profile.with_name(
            args.profile.stem + "_q3" + args.profile.suffix))
        profile_plan("q19", q19, Q19_ITERS, args.profile.with_name(
            args.profile.stem + "_q19" + args.profile.suffix))
        profile_plan("P6", p6, P6_ITERS, args.profile.with_name(
            args.profile.stem + "_p6" + args.profile.suffix))
        lines7, build7 = p7_batches[False]
        profile_plan("P7", shipmode_join_tree(
            m, scan_of(m, lines7), scan_of(m, build7)), P6_ITERS,
            args.profile.with_name(args.profile.stem + "_p7"
                                   + args.profile.suffix))
        profiled = [(label, run.__self__, P_TYPES_ITERS)
                    for label, (run, _) in types_runs.items()] + [
            (label, tree, P_STRING_ITERS)
            for label, tree in str_trees.items()] + [
            (label, tree, P_WINDOW_ITERS)
            for label, tree in win_trees.items() if label != "P27"] + [
            (label, tree, P_NESTED_ITERS)
            for label, tree in nest_trees.items()]
        for label, tree, iters in profiled:
            tag = label.lower().replace(" ", "_")
            profile_plan(label, tree, iters, args.profile.with_name(
                f"{args.profile.stem}_{tag}{args.profile.suffix}"))
    for r in records:
        r["path_launches"] = {
            "P1_q19_decoded": p1_counts.get(r["name"], 0),
            "P2_q3_budget": p2_counts.get(r["name"], 0),
            "P3_sort_out_of_core": p3_counts.get(r["name"], 0),
            "P4_q3_from_host": p4_counts[2].get(r["name"], 0),
            "P5_q19_from_host": p5_counts.get(r["name"], 0),
            "P6_tpch_q1": p6_counts.get(r["name"], 0),
            "P7_string_join": p7_counts["string_build"].get(r["name"], 0),
            "P7_dictionary_join": p7_counts["dictionary_build"].get(
                r["name"], 0),
            "P8_names_count": p8_counts.get(r["name"], 0),
            "P9_q1_shuffled": shuffled["P9"][1].get(r["name"], 0),
            "P10_tpch_q1_shuffled": shuffled["P10"][1].get(r["name"], 0),
            "P11_q3_shuffled": shuffled["P11"][1].get(r["name"], 0),
            "P11_q3_shuffled_int_keys": shuffled["P11_INT"][1].get(
                r["name"], 0),
            "P11_q3_shuffled_static": shuffled["P11_static"][1].get(
                r["name"], 0),
            "P11_q3_shuffled_int_keys_static": shuffled["P11_INT_static"][
                1].get(r["name"], 0),
            **{f"planned_{k.replace(' ', '_')}": v["launches"].get(
                r["name"], 0) for k, v in planned_recs.items()},
            **{k: v.get(r["name"], 0) for k, v in join_counts.items()},
            "P12_planned": join_recs["P12_planned"]["launches"].get(
                r["name"], 0),
            "P13_planned": join_recs["P13_planned"]["launches"].get(
                r["name"], 0),
            **{k.replace(" ", "_"): v.get(r["name"], 0)
               for k, v in types_counts.items()},
            **{k.replace(" ", "_"): v.get(r["name"], 0)
               for k, v in str_counts.items()},
            **{k.replace(" ", "_"): v.get(r["name"], 0)
               for k, v in win_counts.items()},
            **{k.replace(" ", "_"): v.get(r["name"], 0)
               for k, v in nest_counts.items()},
            **{k.replace(" ", "_"): v.get(r["name"], 0)
               for k, v in ad_counts.items()},
            **{k: v.get(r["name"], 0) for k, v in gov_launches.items()},
            **{k: v.get(r["name"], 0) for k, v in a9b_launches.items()},
            **{k: v.get(r["name"], 0) for k, v in stage_launches.items()},
            **{k: v.get(r["name"], 0) for k, v in file_launches.items()},
            **{k: v.get(r["name"], 0) for k, v in delta_launches.items()},
            **{k: v.get(r["name"], 0) for k, v in mesh_launches.items()},
            **{k: v.get(r["name"], 0) for k, v in tool_launches.items()}}
        if r["name"] in p19_shapes:
            r["p19_shapes"] = p19_shapes[r["name"]]
        for label, shapes in str_shapes.items():
            if r["name"] in shapes:
                r[f"{label.lower()}_shapes"] = shapes[r["name"]]
        if r["name"] == "murmur3_columns":
            r["pid_shapes"] = pid_recs
        if r["name"] == "dma_row_gather":
            r["windows_shapes"] = win_gathers
            r["nested_shapes"] = nest_gathers
            r["reorder_shapes"] = reorder_recs
            r["q21_shapes"] = q21_gathers
        if r["name"] == "fused_probe_verify":
            r["q21_shapes"] = q21_probes
    print(json.dumps({"adaptive_paths": dict(a9b_recs, phase="3k")},
                     default=str))
    print(json.dumps({"paths": {
        "P1": dict(dec, host_reads=p1_reads, ms=q19_ms),
        "P2": p2_rec, "P3": p3_rec, "spill_gb_s": rates,
        "P4": {"ms": {("device_batches" if k == "device" else
                       f"depth_{k}"): v for k, v in p4_ms.items()},
               "io": {f"depth_{k}": v for k, v in p4_io.items()},
               "launches": p4_counts[2], "pool_misses_after_first": 0},
        "P5": {"ms": p5_ms, "first_run_ms": p5_first_ms, "io": p5_io,
               "launches": p5_counts, "pool_misses": p5_misses,
               "pinned_alloc_ms": pinned_ms},
        "ingest": ingest, "P6": p6_rec, "P7": p7_rec, "P8": p8_rec,
        **{k: dict(v[2], timed=shuffle_recs.get(k)) for k, v in
           shuffled.items()}, "split_fetch": fetch_rates,
        "planned": {k: dict(v, ms=session_ms.get(k)) for k, v in
                    planned_recs.items()},
        "join_paths": dict(join_recs, counts=join_counts, ms=join_ms),
        "types_paths": dict(types_recs, counts=types_counts,
                            ms=types_ms),
        "strings_paths": dict(str_recs, counts=str_counts,
                              ms=strings_ms),
        "windows_paths": dict(win_recs, counts=win_counts,
                              ms=windows_ms),
        "nested_paths": dict(nest_recs, counts=nest_counts,
                             ms=nested_ms),
        "adaptive_paths": dict(ad_recs, counts=ad_counts,
                               ms=adaptive_ms),
        "governed_paths": gov_recs, "stage_paths": stage_recs,
        "file_paths": file_recs, "delta_paths": delta_recs,
        "mesh_paths": dict(mesh_recs, card=smi),
        "tooling_paths": dict(tool_recs, card=smi)}},
        default=str))
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
