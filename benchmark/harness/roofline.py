"""The yardstick a kernel's roofline share will be read against: the card's
published peaks, the least time a call could take, and a cold-L2 device
timing. No metric reads it yet: a kernel's bytes cannot be read from
outside the program (a graph replay runs no Python wrapper), so
`<kernel>_roofline` waits for the program to report them (PERF.md, Open
questions). Copied from chip_smoke.py (`PEAK_*`, `bound`, `device_ms`),
which later PRs may change.
"""

from __future__ import annotations

#: NVIDIA's data sheet, H100 SXM at 700 W: HBM3 bytes/s, and float32
#: operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
#: bytes written before each timed launch: ten times the H100's 50 MB L2
FLUSH_BYTES = 512 << 20


def bound(nbytes: float, nops: float):
    """(least ms, what bounds it) at the published rates."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = nops / PEAK_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def device_ms(fn, reps: int, flush_bytes: int = FLUSH_BYTES) -> float:
    """Mean device time of `fn`'s launches with the L2 cache cold: before
    each run a write of `flush_bytes` evicts L2 and keeps the card busy
    while the host enqueues `fn` between two events."""
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
