"""Device timezone database — the counterpart of
spark_rapids_tpu/ops/timezone.py (the reference's GpuTimeZoneDB and
TimeZoneDB.scala:61): a zone's transition tables are loaded once onto
the device, and from_utc_timestamp / to_utc_timestamp become a
searchsorted and an add over them, with no host round trip per row.

The tables come from the system tzdata (IANA TZif files under `TZDIR`,
default /usr/share/zoneinfo), parsed here by the port's own copy of the
JAX package's parser. Fixed-offset zones (UTC+HH:MM, +HH:MM) need no
file. A host without zoneinfo knows only the fixed offsets; a named zone
then raises ValueError, which the planner turns into a tag-off.

Semantics: wall-clock conversions use fold=0 (earlier offset) for
ambiguous local times during DST overlaps, matching Java's
ZonedDateTime.of / Spark's zoneId rules for the overlap case.
"""

from __future__ import annotations

import os
import re
import struct
import threading
from typing import Dict, Tuple

import numpy as np
import torch

MICROS = 1_000_000
_TZDIR = os.environ.get("TZDIR", "/usr/share/zoneinfo")

# sentinel transition far before any real data so searchsorted never
# lands at -1 (covers the pre-first-transition LMT era)
_NEG_INF = -(1 << 62)


def _parse_tzif(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """TZif v1/v2/v3 → (transition instants [utc seconds], utc offsets
    [seconds]) with a leading era entry. RFC 8536."""
    with open(path, "rb") as f:
        data = f.read()

    def parse_block(buf, off, time_size, time_fmt):
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt
         ) = struct.unpack_from(">6I", buf, off + 20)
        p = off + 44
        trans = np.frombuffer(buf, dtype=time_fmt, count=timecnt, offset=p
                              ).astype(np.int64)
        p += timecnt * time_size
        idx = np.frombuffer(buf, dtype=np.uint8, count=timecnt, offset=p)
        p += timecnt
        ttinfo = []
        isdst_flags = []
        for i in range(typecnt):
            utoff, isdst, abbrind = struct.unpack_from(">iBB", buf, p)
            ttinfo.append(utoff)
            isdst_flags.append(bool(isdst))
            p += 6
        p += charcnt + leapcnt * (time_size + 4) + isstdcnt + isutcnt
        return trans, idx, np.array(ttinfo, np.int64), isdst_flags, p

    assert data[:4] == b"TZif", path
    version = data[4:5]
    trans, idx, ttinfo, isdst, end = parse_block(data, 0, 4, ">i4")
    if version in (b"2", b"3"):
        # v2+ block follows with 64-bit times; prefer it
        assert data[end:end + 4] == b"TZif"
        trans, idx, ttinfo, isdst, _ = parse_block(data, end, 8, ">i8")

    if len(ttinfo) == 0:
        return (np.array([_NEG_INF], np.int64), np.array([0], np.int64))
    # era entry (pre-first-transition): RFC 8536 §3.2 — the first
    # STANDARD-time type (usually LMT), not the first transition's target
    first = next((off for off, dst in zip(ttinfo, isdst) if not dst),
                 int(ttinfo[0]))
    instants = np.concatenate([[_NEG_INF], trans])
    offsets = np.concatenate([[first],
                              ttinfo[idx] if len(idx) else []]).astype(
        np.int64)
    return instants, offsets


_FIXED = re.compile(r"^(?:UTC|GMT)?([+-])(\d{1,2})(?::?(\d{2}))?$")


class TimeZoneDB:
    """Process-wide cache of transition tables: numpy per zone, and
    their tensors per (zone, device)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cache: Dict[str, tuple] = {}
        self._dev: Dict[tuple, tuple] = {}

    def _load(self, tz: str):
        m = _FIXED.match(tz)
        if tz.upper() in ("UTC", "GMT", "Z") or tz == "+00:00":
            inst = np.array([_NEG_INF], np.int64)
            offs = np.array([0], np.int64)
        elif m:
            sign = 1 if m.group(1) == "+" else -1
            secs = sign * (int(m.group(2)) * 3600 + int(m.group(3) or 0) * 60)
            inst = np.array([_NEG_INF], np.int64)
            offs = np.array([secs], np.int64)
        else:
            path = os.path.join(_TZDIR, tz)
            if not os.path.isfile(path) or ".." in tz:
                raise ValueError(f"unknown timezone {tz!r}")
            inst, offs = _parse_tzif(path)
        # micros-domain tables; clamp sentinel to stay in int64 micros
        inst_us = np.where(inst <= _NEG_INF, np.int64(-(1 << 62)),
                           inst * MICROS)
        # wall-time interval ENDS under each interval's own offset —
        # first-containing-interval search = fold=0 (earlier offset wins
        # in overlaps)
        ends = np.empty_like(inst_us)
        ends[:-1] = inst_us[1:] + offs[:-1] * MICROS
        ends[-1] = (1 << 62)
        return inst_us, offs * MICROS, ends

    def tables(self, tz: str):
        """(instants, offsets, wall-clock interval ends) in micros, as
        numpy int64 arrays; raises ValueError for an unknown zone."""
        got = self._cache.get(tz)
        if got is None:
            with self._lock:
                got = self._cache.get(tz)
                if got is None:
                    got = self._load(tz)
                    self._cache[tz] = got
        return got

    def device_tables(self, tz: str, device):
        key = (tz, str(device))
        got = self._dev.get(key)
        if got is None:
            got = tuple(torch.from_numpy(a).to(device)
                        for a in self.tables(tz))
            with self._lock:
                self._dev[key] = got
        return got


_DB = TimeZoneDB()


def timezone_db() -> TimeZoneDB:
    return _DB


def utc_to_local(ts_micros, tz: str):
    """from_utc_timestamp kernel: shift UTC instants to wall clock in
    `tz` (stays TIMESTAMP_NTZ-like micros)."""
    inst, offs, _ = _DB.device_tables(tz, ts_micros.device)
    i = torch.searchsorted(inst, ts_micros, right=True) - 1
    i = torch.clamp(i, 0, inst.shape[0] - 1)
    return ts_micros + offs[i]


def local_to_utc(ts_micros, tz: str):
    """to_utc_timestamp kernel: wall clock in `tz` → UTC instants
    (fold=0: the earlier offset for ambiguous overlap times; nonexistent
    gap times follow Java's ZonedDateTime rule — shift forward by the
    gap, i.e. resolve with the PRE-transition offset)."""
    inst, offs, ends = _DB.device_tables(tz, ts_micros.device)
    i = torch.searchsorted(ends, ts_micros, right=True)
    i = torch.clamp(i, 0, offs.shape[0] - 1)
    # A wall time earlier than the matched interval's own wall start is in
    # a DST gap: no interval contains it. Java resolves it with the offset
    # BEFORE the transition (local − offsetBefore shifts forward by the gap).
    in_gap = ts_micros < inst[i] + offs[i]
    prev = torch.clamp(i - 1, 0, offs.shape[0] - 1)
    off = torch.where(in_gap, offs[prev], offs[i])
    return ts_micros - off
