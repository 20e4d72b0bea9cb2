"""launches_per_query.<mix>: kernels the device ran in the traced window (graph
replays counted kernel by kernel), divided by its completed queries."""


def read(obs, name):
    done = obs.completed
    if obs.trace is None or not done:
        return None
    n = len(obs.trace.kernels())
    return n / len(done) if n else None
