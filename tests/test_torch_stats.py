"""obs/stats.py: `Log2Hist` percentiles and summaries over seeded data,
and the `ExchangeStats` rows and bytes of a 4-partition exchange
(df.repartition(4) over the same batches: the frames are byte-identical
across the packages), are the JAX package's exactly. Port-only: the
per-partition bytes sum to the bytes written, and the health section
lists the exchange."""

import numpy as np
import pytest

from spark_rapids_tpu.obs import stats as jstats
from spark_rapids_tpu_torch.obs import stats as tstats

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import (N_Q1, active_confs, q1_columns, sessions,
                                split_batches)


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield


@pytest.mark.parametrize("seed", range(4))
def test_log2hist_matches_jax(seed):
    rng = np.random.default_rng(seed)
    values = np.concatenate([rng.integers(0, 1 << int(rng.integers(1, 40)),
                                          int(rng.integers(1, 200)))
                             for _ in range(5)])
    th, jh = tstats.Log2Hist(), jstats.Log2Hist()
    for v in values:
        th.add(int(v))
        jh.add(int(v))
    th.add(7, n=3)
    jh.add(7, n=3)
    for q in (0, 1, 25, 50, 90, 95, 99, 100):
        assert th.percentile(q) == jh.percentile(q)
    assert th.summary() == jh.summary()
    other_t, other_j = tstats.Log2Hist(), jstats.Log2Hist()
    for v in values[:10]:
        other_t.add(int(v) * 3)
        other_j.add(int(v) * 3)
    th.merge(other_t)
    jh.merge(other_j)
    assert th.summary() == jh.summary()


def test_exchange_stats_of_a_repartition_match_jax():
    conf = {"spark.rapids.sql.shuffle.partitions": "4"}
    js, ts = sessions(conf)
    jb, tb = split_batches(q1_columns(), N_Q1, 2)
    schema_j, schema_t = jb[0].schema, tb[0].schema
    out = []
    for sess, batches, schema in ((js, jb, schema_j), (ts, tb, schema_t)):
        df = sess.from_batches(batches, schema).repartition(4)
        rows = df.collect()
        ex = sess.last_query_profile().statistics()["exchanges"]
        (st,) = ex.values()
        out.append((sorted(rows), {k: st[k] for k in (
            "partitions", "maps", "rows", "bytes", "per_partition_rows",
            "per_partition_bytes", "partition_rows", "partition_bytes",
            "map_output_bytes", "skew")}))
    (jrows, jst), (trows, tst) = out
    assert trows == jrows and len(trows) == N_Q1
    assert tst == jst
    assert tst["partitions"] == 4 and tst["maps"] >= 1
    assert sum(tst["per_partition_bytes"]) == tst["bytes"]
    assert sum(tst["per_partition_rows"]) == N_Q1
    recent = tstats.health_section()["recent_exchanges"]
    assert recent and recent[-1]["partitions"] == 4
