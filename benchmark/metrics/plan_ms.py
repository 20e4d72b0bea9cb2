"""plan_ms: milliseconds a query spends in the planner (`TpuOverrides.apply`:
wrap, tag and convert), summed over the traced window and divided by its
completed queries. The span is the benchmark's own, installed around the
method for the traced run."""

import time

KEY = "plan_ms"


def install(obs):
    from spark_rapids_tpu_torch.plan.overrides import TpuOverrides
    original = TpuOverrides.apply
    obs.state[KEY] = 0

    def apply(self, *args, **kwargs):
        t0 = time.perf_counter_ns()
        try:
            return original(self, *args, **kwargs)
        finally:
            obs.state[KEY] += time.perf_counter_ns() - t0

    TpuOverrides.apply = apply

    def finish():
        TpuOverrides.apply = original
    return finish


def read(obs, name):
    done = obs.completed
    if not done or KEY not in obs.state:
        return None
    return obs.state[KEY] / 1e6 / len(done)
