"""query_ms.<query>: the mean milliseconds of the window's completed
queries of that name (`query_ms.q3` for Q3), from the DataFrame's build to
collect()'s return, on the host's clock: their summed time over their
count, so the reading spans every run of the query in the window."""


def read(obs, name):
    query = name.split(".", 1)[1]
    secs = [q.seconds for q in obs.completed if q.name == query]
    if not secs:
        return None
    return 1e3 * sum(secs) / len(secs)
