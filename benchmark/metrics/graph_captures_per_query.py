"""graph_captures_per_query.<mix>: the CUDA graphs the stage compiler
captured in the traced window (`exec/stage_compiler.counters()`: a stage
whose static key holds a literal captures one for each fresh parameter),
divided by its completed queries."""

KEY = "graph_captures"


def _count():
    from spark_rapids_tpu_torch.exec import stage_compiler
    return int(stage_compiler.counters()["graph_captures"])


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
