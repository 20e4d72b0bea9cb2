"""host_syncs_per_query.<mix>: the device-to-host synchronisations of the
traced window (each a warning of torch.cuda.set_sync_debug_mode("warn"),
from every thread), divided by its completed queries."""

import warnings

KEY = "host_syncs"


def install(obs):
    import torch
    if not torch.cuda.is_available():
        return None
    caught = warnings.catch_warnings(record=True)
    log = caught.__enter__()
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")

    def finish():
        torch.cuda.set_sync_debug_mode(0)
        caught.__exit__(None, None, None)
        obs.state[KEY] = sum(1 for w in log
                             if "synchroniz" in str(w.message))
    return finish


def read(obs, name):
    done = obs.completed
    if not done or KEY not in obs.state:
        return None
    return obs.state[KEY] / len(done)
