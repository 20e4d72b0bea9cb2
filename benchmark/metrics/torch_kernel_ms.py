"""torch_kernel_ms.<mix>: device milliseconds a query in every CUDA kernel that
is not one of the port's own (PyTorch's: index_add_, sorts, scatters,
elementwise), from the profiler's trace of the window, divided by its
completed queries."""

from harness.bench import metric_module


def read(obs, name):
    done = obs.completed
    if obs.trace is None or not done:
        return None
    own = metric_module("own_kernel_ms").own
    ks = [(s, e) for n, s, e, _ in obs.trace.kernels() if not own(n)]
    if not ks:
        return None
    return sum(e - s for s, e in ks) / 1e6 / len(done)
