"""Bounded IO retry with exponential backoff — the counterpart of
spark_rapids_tpu/io/retrying.py.

Transient OSErrors in the multi-file readers get spark.rapids.tpu.io.retries
more chances before the failure surfaces, the first sleep between them
spark.rapids.tpu.io.retryBackoffMs (doubled per attempt). A caller on a
pool thread passes both, read on the thread that owns the drive
(io/multifile.threaded_chunks): the active conf is thread-local. Only transient-looking errors retry: a
missing file, a directory in a file's place or a permission wall fail the
same way on every attempt. Left out with their module (ROADMAP A.9): the
`io.multifile_read` fault point and the `io_retry` events.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, Optional, TypeVar

from ..config import IO_RETRIES, IO_RETRY_BACKOFF_MS, active_conf

T = TypeVar("T")

_BACKOFF_CAP_MS = 2000

#: OSError subclasses no retry can fix
_NON_TRANSIENT = (FileNotFoundError, IsADirectoryError, NotADirectoryError,
                  PermissionError)

_recoveries = 0
_recoveries_lock = threading.Lock()


def io_retry_recoveries() -> int:
    """Reads that succeeded after a retry, in this process."""
    return _recoveries


def backoff_s(what: str, salt: str, attempt: int, base_ms: int) -> float:
    """min(base * 2^(attempt-1), cap) plus up to 25 % jitter that is a
    pure hash of (what, salt, attempt), as the reference's faults.backoff_s:
    concurrent readers of one flaky mount do not retry in lockstep."""
    ms = min(base_ms * (1 << (attempt - 1)), _BACKOFF_CAP_MS)
    frac = zlib.crc32(f"io:{what}:{salt}:{attempt}".encode()) / 2 ** 32
    return ms * (1.0 + 0.25 * frac) / 1000.0


def with_io_retry(fn: Callable[[], T], what: str,
                  retries: Optional[int] = None,
                  backoff_ms: Optional[int] = None, salt: str = "") -> T:
    """Run `fn`, retrying transient OSErrors up to `retries` times
    (default: the active conf's io.retries; `backoff_ms` its
    io.retryBackoffMs). `salt` names the work item (a chunk index) so
    that concurrent callers back off differently."""
    if retries is None or backoff_ms is None:
        conf = active_conf()
        retries = conf.get(IO_RETRIES) if retries is None else retries
        backoff_ms = conf.get(IO_RETRY_BACKOFF_MS) if backoff_ms is None \
            else backoff_ms
    retries = max(0, retries)
    base_ms = max(1, backoff_ms)
    attempt = 0
    while True:
        attempt += 1
        try:
            result = fn()
        except OSError as e:
            if isinstance(e, _NON_TRANSIENT) or attempt > retries:
                raise
            time.sleep(backoff_s(what, salt, attempt, base_ms))
            continue
        if attempt > 1:
            global _recoveries
            with _recoveries_lock:
                _recoveries += 1
        return result
