"""exec/task_retry.py: the same planned query in both packages under one
injected `device.dispatch` fault gives the same rows (keys and order
exact, f64 sums to 1e-9) and the same number of attempts (exact). Port-only: a transient failure re-runs up to
task.maxAttempts, a fatal one (a CUDA error among them) surfaces at
once, the backoff accrues to `retry-backoff`, the attempt number is
thread-local and is carried to a producer, and a cancelled query burns
no further attempt."""

import json
import threading

import numpy as np
import pytest

import chip_smoke as cs
from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu.obs import events as jevents
from spark_rapids_tpu_torch import faults as tfaults
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec import lifecycle, task_retry
from spark_rapids_tpu_torch.obs import events as tevents
from spark_rapids_tpu_torch.obs import phase as tphase

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import (JAX, N_LINES, N_ORDERS, TORCH, active_confs,
                                q3_columns, q3_oracle, sessions,
                                split_batches)

FAULT = "device.dispatch:prob=1,seed=5,kind=device,max=1"


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield
    jfaults.install(None)
    tfaults.install(None)
    jevents.reset_event_bus()
    tevents.reset_event_bus()


def _q3(conf):
    js, ts = sessions(conf)
    orders, lines = q3_columns()
    (oj, ot), (lj, lt) = (split_batches(orders, N_ORDERS, 1),
                          split_batches(lines, N_LINES, 2))
    return cs.q3_df(JAX, js, oj, lj), cs.q3_df(TORCH, ts, ot, lt)


def test_rows_and_attempts_under_a_device_fault_match_jax(tmp_path):
    conf = {"spark.rapids.tpu.agg.speculative.enabled": "false",
            "spark.rapids.tpu.test.faults": FAULT,
            "spark.rapids.tpu.task.maxAttempts": "3",
            "spark.rapids.tpu.task.retryBackoffMs": "1",
            "spark.rapids.tpu.eventLog.enabled": "true"}
    # one directory per package: both name their files events-<pid>-<n>
    jdf, _ = _q3(dict(conf, **{"spark.rapids.tpu.eventLog.dir":
                               str(tmp_path / "jax")}))
    _, tdf = _q3(dict(conf, **{"spark.rapids.tpu.eventLog.dir":
                               str(tmp_path / "torch")}))
    got = {}
    for name, df, faults_mod, events_mod in (
            ("jax", jdf, jfaults, jevents), ("torch", tdf, tfaults,
                                             tevents)):
        faults_mod.install(None)
        rows = df.collect()
        with open(events_mod.active_bus().path) as f:
            recs = [json.loads(line) for line in f]
        phases = [r for r in recs if r["kind"] == "query_phases"]
        got[name] = (rows, phases[-1]["attempts"],
                     sum(r["kind"] == "task_retry" for r in recs),
                     faults_mod.stats())
        faults_mod.install(None)
        events_mod.reset_event_bus()
    assert got["torch"][1:] == got["jax"][1:] == (2, 1,
                                                  {"device.dispatch": 1})
    # keys and order exact, the f64 sums to 1e-9 (summation order)
    (tr, jr) = got["torch"][0], got["jax"][0]
    assert [r[0] for r in tr] == [r[0] for r in jr]
    assert [r[1] for r in tr] == pytest.approx([r[1] for r in jr],
                                               rel=1e-9, abs=0)
    cs.check_q3(got["torch"][0], q3_oracle(), "q3 under a device fault")


def _conf(attempts=3):
    return RapidsConf({"spark.rapids.tpu.task.maxAttempts": str(attempts),
                       "spark.rapids.tpu.task.retryBackoffMs": "1"})


def test_transient_failures_retry_up_to_max_attempts():
    seen = []

    def run(attempt):
        seen.append((attempt, task_retry.task_attempt()))
        if attempt < 3:
            raise tfaults.InjectedDeviceError("device.dispatch")
        return "done"

    before = task_retry.task_retry_total()
    t0 = tphase.counters()["retry-backoff"]
    assert task_retry.with_task_retry(run, _conf(3)) == "done"
    assert seen == [(1, 1), (2, 2), (3, 3)]
    assert task_retry.task_retry_total() - before == 2
    assert tphase.counters()["retry-backoff"] > t0
    assert task_retry.task_attempt() == 1  # restored outside the scope
    seen.clear()
    with pytest.raises(tfaults.IntegrityError):
        task_retry.with_task_retry(
            lambda a: seen.append(a) or (_ for _ in ()).throw(
                tfaults.IntegrityError("crc")), _conf(2))
    assert seen == [1, 2]


@pytest.mark.parametrize("exc", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("dma_row_gather kernel launch failed: CUDA error 719"),
    ValueError("a bug"), lifecycle.QueryCancelledError("gone")])
def test_fatal_failures_surface_at_once(exc):
    calls = []

    def run(attempt):
        calls.append(attempt)
        raise exc

    with pytest.raises(type(exc)):
        task_retry.with_task_retry(run, _conf(3))
    assert calls == [1]


def test_a_cancelled_query_burns_no_further_attempt():
    calls = []
    with lifecycle.governed(RapidsConf(), owner="t") as ctx:
        def run(attempt):
            calls.append(attempt)
            ctx.cancel()
            raise tfaults.InjectedIOError("pipeline.produce")
        with pytest.raises(lifecycle.QueryCancelledError) as e:
            task_retry.with_task_retry(run, _conf(3))
    assert calls == [1] and e.value.phase == "task-retry"


def test_the_attempt_is_carried_to_a_producer_thread():
    out = []

    def run(attempt):
        cap = task_retry.capture_attempt()

        def producer():
            task_retry.adopt_attempt(cap)
            out.append(task_retry.task_attempt())

        t = threading.Thread(target=producer)
        t.start()
        t.join(timeout=10)
        if attempt == 1:
            raise tfaults.InjectedIOError("pipeline.produce")
        return np.int64(attempt)

    assert task_retry.with_task_retry(run, _conf(2)) == 2
    assert out == [1, 2]
    assert task_retry.capture_attempt() is None
