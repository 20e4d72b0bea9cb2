"""Multi-file reader base — the counterpart of
spark_rapids_tpu/io/multifile.py (the reference's multithreaded reader,
GpuMultiFileReader.scala:345).

A thread pool decodes the next chunks on the host while the device
consumes the current batch, emitting in order. The pool's size
(spark.rapids.sql.multiThreadedRead.numThreads), the look-ahead window
(fetchAheadWindow) and the IO retry settings are read from the active
conf on the thread that drives the reader, never on a pool thread. Each
decode task is the `io.multifile_read` fault point (keyed by its chunk
index) inside its IO retry, and runs with the driving thread's query id,
so its io_retry events are attributed to the query.
"""

from __future__ import annotations

import glob
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence

from ..columnar.batch import ColumnarBatch
from ..config import (IO_RETRIES, IO_RETRY_BACKOFF_MS,
                      MULTITHREADED_READ_FETCH_AHEAD,
                      MULTITHREADED_READ_NUM_THREADS, active_conf)


def expand_paths(path) -> List[str]:
    """A file, directory, glob or list of those -> an ordered file list
    (hidden and underscore files of a directory left out)."""
    if isinstance(path, (list, tuple)):
        out: List[str] = []
        for p in path:
            out.extend(expand_paths(p))
        return out
    path = os.fspath(path)
    if os.path.isdir(path):
        return sorted(os.path.join(path, f) for f in os.listdir(path)
                      if not f.startswith((".", "_")))
    if any(ch in path for ch in "*?["):
        return sorted(glob.glob(path))
    return [path]


#: one process-wide decode pool for every scan, created at first use and
#: grown (never shrunk) when a reader asks for more threads
_pool: Optional[ThreadPoolExecutor] = None
_pool_size = 0
_pool_lock = threading.Lock()
#: pools replaced by a larger one, kept alive for their in-flight drives
_retired: list = []


def shared_read_pool(num_threads: Optional[int] = None
                     ) -> ThreadPoolExecutor:
    """The process-wide decode pool."""
    global _pool, _pool_size
    if num_threads is None:
        num_threads = active_conf().get(MULTITHREADED_READ_NUM_THREADS)
    num_threads = max(1, int(num_threads))
    with _pool_lock:
        if _pool is None or num_threads > _pool_size:
            # a running drive still submits to the pool it captured, so
            # the old pool is retired, never shut down
            if _pool is not None:
                _retired.append(_pool)
            # named apart from the JAX package's pool, whose tests count
            # its threads by name in a process that may hold both
            _pool = ThreadPoolExecutor(
                max_workers=num_threads,
                thread_name_prefix="port-multifile-read")
            _pool_size = num_threads
        return _pool


def fetch_ahead_window(num_threads: int) -> int:
    """Decode tasks a reader keeps in flight ahead of its consumer
    (fetchAheadWindow of the active conf; 0: twice the threads)."""
    window = active_conf().get(MULTITHREADED_READ_FETCH_AHEAD)
    return window if window > 0 else 2 * max(1, num_threads)


def threaded_chunks(tasks: Sequence[Callable[[], object]],
                    num_threads: int,
                    window: Optional[int] = None) -> Iterator[object]:
    """Run the decode `tasks` on the shared pool with a bounded
    look-ahead window, yielding their results in order; each under
    bounded IO retry (io/retrying.py). One thread, or one task, runs them
    on the caller's thread."""
    from .retrying import with_io_retry
    conf = active_conf()
    retries, backoff_ms = conf.get(IO_RETRIES), conf.get(IO_RETRY_BACKOFF_MS)

    from ..obs import events as obs_events
    qid = obs_events.current_query_id()

    def retrying(t: Callable[[], object], i: int) -> object:
        return obs_events.with_query_id(
            qid, with_io_retry, t, "multifile_read", retries, backoff_ms,
            salt=str(i), fault_point="io.multifile_read")

    if num_threads <= 1 or len(tasks) <= 1:
        for i, t in enumerate(tasks):
            yield retrying(t, i)
        return
    pool = shared_read_pool(max(num_threads,
                                conf.get(MULTITHREADED_READ_NUM_THREADS)))
    if window is None:
        window = fetch_ahead_window(num_threads)
    futures = [pool.submit(retrying, t, i)
               for i, t in enumerate(tasks[:window])]
    next_submit = window
    try:
        for i in range(len(tasks)):
            yield futures[i].result()
            futures[i] = None
            if next_submit < len(tasks):
                futures.append(pool.submit(retrying, tasks[next_submit],
                                           next_submit))
                next_submit += 1
    finally:
        # abandoned mid-drive: cancel what never started
        for f in futures:
            if f is not None:
                f.cancel()


#: the keys a reader's `scan_stats` gains from its drive: rows and
#: batches emitted, and the ns of the host decode (pool tasks, summed over
#: the threads), the host build of the columns and the uploads
DRIVE_STATS = ("rows", "batches", "decode_ns", "build_ns", "upload_ns")
_stats_lock = threading.Lock()


def reset_drive_stats(stats: dict) -> None:
    """Zero the DRIVE_STATS keys of a reader's `scan_stats`, keeping its
    other keys (row-group or stripe counts)."""
    for k in DRIVE_STATS:
        stats[k] = 0


def add_stat(stats: Optional[dict], key: str, value: int) -> None:
    """stats[key] += value under a lock (pool threads add their decode
    ns to one reader's stats)."""
    if stats is not None:
        with _stats_lock:
            stats[key] = stats.get(key, 0) + value


def timed_tasks(tasks: Sequence[Callable[[], object]],
                stats: Optional[dict]) -> List[Callable[[], object]]:
    """The decode `tasks`, each adding its ns on its pool thread to
    `stats["decode_ns"]`."""
    import time

    def timed(t):
        def run():
            t0 = time.perf_counter_ns()
            try:
                return t()
            finally:
                add_stat(stats, "decode_ns", time.perf_counter_ns() - t0)
        return run
    return [timed(t) for t in tasks]


def timed_upload(cols, n: int, schema, device, stats: Optional[dict],
                 t0: int) -> ColumnarBatch:
    """Host columns whose build began at `t0` (perf_counter_ns) as one
    batch on `device`, in one packed upload (columnar/upload.
    to_device_batch). `stats`, when given, gains the rows, one batch, and
    the host build's and the upload's ns (`build_ns`, `upload_ns`)."""
    import time
    from ..columnar.upload import to_device_batch
    t1 = time.perf_counter_ns()
    batch = to_device_batch(cols, n, schema, device)
    for k, v in (("rows", n), ("batches", 1), ("build_ns", t1 - t0),
                 ("upload_ns", time.perf_counter_ns() - t1)):
        add_stat(stats, k, v)
    return batch


def arrow_to_batches(table, target_rows: int, device=None,
                     encoded: Optional[bool] = None,
                     stats: Optional[dict] = None
                     ) -> Iterator[ColumnarBatch]:
    """A host arrow table as batches of at most `target_rows` rows on
    `device`, one packed upload each (`timed_upload`)."""
    import time
    from ..columnar.batch import arrow_host_columns
    n = table.num_rows
    for start in range(0, max(n, 1), target_rows):
        t0 = time.perf_counter_ns()
        part = table.slice(start, target_rows)
        cols, schema = arrow_host_columns(part, encoded)
        yield timed_upload(cols, part.num_rows, schema, device, stats, t0)


def host_batch_upload(data: dict, schema, device, stats: Optional[dict] = None
                      ) -> ColumnarBatch:
    """Python lists by column name (None for null) as one batch on
    `device`: the columns are built on the host at one capacity bucket
    and cross in one packed upload (`timed_upload`), as an arrow table's
    do."""
    import time
    from ..columnar.column import bucket_capacity, build_column
    t0 = time.perf_counter_ns()
    lengths = {len(v) for v in data.values()} or {0}
    if len(lengths) != 1:
        raise ValueError("ragged input columns")
    n = lengths.pop()
    cap = bucket_capacity(n)
    cols = [build_column(data[f.name], f.data_type, cap, "cpu")
            for f in schema.fields]
    return timed_upload(cols, n, schema, device, stats, t0)


def need_pyarrow(what: str, module: str = "pyarrow"):
    """`module` imported, or ImportError naming pyarrow: the readers and
    writers that go through pyarrow have no other lane."""
    import importlib
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{what} needs pyarrow ({module}), which is not "
                          f"installed") from e
