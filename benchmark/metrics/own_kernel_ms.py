"""own_kernel_ms: device milliseconds a query in the port's hand-written
CUDA kernels (csrc/: the murmur3 chain, fused_probe_verify, the row
gathers, the dictionary gathers, the fused scan-aggregate), by kernel name
from the profiler's trace of the window, divided by its completed
queries. None where no such kernel ran."""

#: the kernels' names in csrc/*.cu and csrc/fused_scan_agg.cu.in
OWN = ("m3_rows", "probe_scan_emit", "row_gather_fixed", "row_gather_any",
       "dict_gather_flat", "dict_gather_scalar", "fsa_rows", "fsa_final")


def own(name):
    return any(k in name for k in OWN)


def read(obs, name):
    done = obs.completed
    if obs.trace is None or not done:
        return None
    ks = [(n, s, e) for n, s, e, _ in obs.trace.kernels() if own(n)]
    if not ks:
        return None
    return sum(e - s for _, s, e in ks) / 1e6 / len(done)
