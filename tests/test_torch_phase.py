"""obs/phase.py: the closed phase set is the JAX package's; the ledger's
books close exactly. Exact against the JAX package: `PHASES` and, for
one accrual script (nested spans, direct adds, producer-thread adds
folded into the pipeline-stall budget) with its wall pinned, the
snapshot. Port-only: `sum(phases) == wall` to the ns for governed
collects (one partition, a 4-partition shuffle, a task retry with its
backoff), a kernel library's build is `compile` and is carved out of the
enclosing span, and nested spans never double-count."""

import threading
import time

import pytest

from spark_rapids_tpu.obs import phase as jphase
from spark_rapids_tpu_torch import faults as tfaults
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.obs import dispatch as tdispatch
from spark_rapids_tpu_torch.obs import phase as tphase
from spark_rapids_tpu_torch.types import DOUBLE, LONG, Schema, StructField

from test_torch_jax_ref import one_torch_thread
from test_torch_planner import active_confs

SCHEMA = Schema([StructField("k", LONG), StructField("v", DOUBLE)])


@pytest.fixture(scope="module", autouse=True)
def _confs():
    with active_confs(), one_torch_thread():
        yield
    tfaults.install(None)


def test_phases_match_jax():
    assert tphase.PHASES == jphase.PHASES
    assert tphase.ACCRUABLE == jphase.ACCRUABLE


def _script(m):
    """The same accruals into a ledger of module `m`, wall pinned."""
    led = m.PhaseLedger()
    led.add("device-compute", 700)
    led.add("pipeline-stall", 500)
    led.add("semaphore-wait", 40)

    def producer():
        led.add("host-pack-serialize", 300)
        led.add("shuffle-io", 900)

    t = threading.Thread(target=producer)
    t.start()
    t.join(timeout=10)
    led._wall = 5000
    return led.snapshot()


def test_the_snapshot_of_a_script_matches_jax():
    got = _script(tphase)
    assert got == _script(jphase)
    assert sum(got.values()) == 5000
    assert got["pipeline-stall"] == 0  # the producers' 1200 > 500 budget


def test_nested_spans_and_compile_never_double_count():
    t0 = dict(tphase.counters())
    with tphase.span("host-pack-serialize"):
        time.sleep(0.01)
        with tphase.span("device-compute"):
            time.sleep(0.01)
            tdispatch.note_build("a_kernel", 5_000_000)
        tphase.add("shuffle-io", 2_000_000)
    d = {k: v - t0[k] for k, v in tphase.counters().items()}
    assert d["compile"] == 5_000_000 and d["shuffle-io"] == 2_000_000
    assert d["device-compute"] >= 10_000_000 - 5_000_000 - 1_000_000
    assert d["host-pack-serialize"] >= 10_000_000 - 2_000_000 - 1_000_000
    assert not tphase.in_span()


@pytest.mark.parametrize("conf", [
    {}, {"spark.rapids.sql.shuffle.partitions": "4",
         "spark.rapids.sql.broadcastSizeThreshold": "-1"},
    {"spark.rapids.tpu.test.faults":
     "device.dispatch:prob=1,seed=2,kind=device,max=1",
     "spark.rapids.tpu.task.retryBackoffMs": "5"}])
def test_governed_collects_sum_to_their_wall(conf):
    tfaults.install(None)
    sess = TpuSession(conf, device="cpu")
    df = sess.from_pydict({"k": [1, 2, 1, 3] * 16,
                           "v": [1.0, 2.0, 3.0, 4.0] * 16}, SCHEMA,
                          batch_rows=16)
    rows = sorted(df.group_by("k").agg(F.sum("v")).collect())
    assert rows == [(1, 64.0), (2, 32.0), (3, 64.0)]
    p = sess.last_query_profile()
    ph = p.phases()
    assert set(ph) == set(tphase.PHASES)
    assert sum(ph.values()) == p.phases_wall_ns()
    assert min(ph.values()) >= 0
    assert ph["device-compute"] > 0
    if "spark.rapids.tpu.test.faults" in conf:
        assert ph["retry-backoff"] > 0
    if "spark.rapids.sql.shuffle.partitions" in conf:
        assert ph["host-pack-serialize"] > 0 and ph["shuffle-io"] > 0
    tfaults.install(None)


def test_phases_off_attaches_no_ledger():
    sess = TpuSession({"spark.rapids.tpu.phases.enabled": "false"},
                      device="cpu")
    df = sess.from_pydict({"k": [1], "v": [1.0]}, SCHEMA)
    assert df.collect() == [(1, 1.0)]
    assert sess.last_query_profile().phases() is None
