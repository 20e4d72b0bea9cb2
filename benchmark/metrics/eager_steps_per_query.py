"""eager_steps_per_query.<mix>: the stage compiler's eager steps (steps run op
by op instead of replayed from a CUDA graph;
`exec/stage_compiler.counters()`) over the traced window, divided by its
completed queries."""

KEY = "eager_steps"


def _count():
    from spark_rapids_tpu_torch.exec import stage_compiler
    return int(stage_compiler.counters()["eager_steps"])


def install(obs):
    before = _count()

    def finish():
        obs.state[KEY] = _count() - before
    return finish


def read(obs, name):
    done = obs.completed
    if not done or KEY not in obs.state:
        return None
    return obs.state[KEY] / len(done)
