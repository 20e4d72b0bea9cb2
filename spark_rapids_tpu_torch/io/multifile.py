"""Multi-file reader base — the counterpart of
spark_rapids_tpu/io/multifile.py (the reference's multithreaded reader,
GpuMultiFileReader.scala:345).

A thread pool decodes the next chunks on the host while the device
consumes the current batch, emitting in order. The pool's size
(spark.rapids.sql.multiThreadedRead.numThreads), the look-ahead window
(fetchAheadWindow) and the IO retry settings are read from the active
conf on the thread that drives the reader, never on a pool thread. Left out with their module
(ROADMAP A.9): the query id carried onto the pool's threads.
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
            _pool = ThreadPoolExecutor(max_workers=num_threads,
                                       thread_name_prefix="multifile-read")
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

    def retrying(t: Callable[[], object], i: int) -> object:
        return with_io_retry(t, "multifile_read", retries, backoff_ms,
                             salt=str(i))

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


def arrow_to_batches(table, target_rows: int, device=None,
                     encoded: Optional[bool] = None
                     ) -> Iterator[ColumnarBatch]:
    """A host arrow table as batches of at most `target_rows` rows on
    `device`, one packed upload each (ColumnarBatch.from_arrow)."""
    n = table.num_rows
    if n == 0:
        yield ColumnarBatch.from_arrow(table, device, encoded)
        return
    for start in range(0, n, target_rows):
        yield ColumnarBatch.from_arrow(table.slice(start, target_rows),
                                       device, encoded)
