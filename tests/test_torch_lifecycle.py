"""exec/lifecycle.py: cancellation and deadlines of a governed collect()
from a second thread, and the breakers. Exact against the JAX package:
the cancel phases, breaker states and the surviving domain's name.
Port-only: a cancel or a deadline raises QueryCancelledError soon, and
leaves an empty catalog, no permit held and no engine thread alive;
`active_queries()` shows the query mid-flight; the `adaptive` and
`device_dispatch` (compiled stages) and `ici_exchange` (the mesh lane)
domains have breakers, and a kernel family's
transient failures are counted, never routed. Every thread joins with a
timeout.
"""

import threading
import time

import numpy as np
import pytest

from spark_rapids_tpu.exec import lifecycle as jlifecycle
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec import lifecycle
from spark_rapids_tpu_torch.memory import buffer_catalog, tpu_semaphore
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.types import DOUBLE, LONG, Schema, StructField

from test_torch_jax_ref import one_torch_thread
from test_torch_planner import active_confs

SCHEMA = Schema([StructField("k", LONG), StructField("v", DOUBLE)])
JOIN_S = 20.0  # every thread joins within this


@pytest.fixture(scope="module", autouse=True)
def _confs():
    with active_confs(), one_torch_thread():
        yield
    lifecycle.reset_lifecycle()


class SlowSource:
    """A scan source that sleeps before each of its batches: a query over
    it runs for `n * delay_s` unless cancelled."""

    def __init__(self, n=400, delay_s=0.01, rows=64):
        rng = np.random.default_rng(3)
        self.schema = SCHEMA
        self.device = "cpu"
        self.n, self.delay_s = n, delay_s
        self._batch = ColumnarBatch.from_pydict(
            {"k": rng.integers(0, 8, rows).tolist(),
             "v": rng.random(rows).tolist()}, SCHEMA, device="cpu")

    def batches(self):
        for _ in range(self.n):
            time.sleep(self.delay_s)
            yield self._batch

    def estimated_size_bytes(self):
        return self.n * self._batch.nbytes

    def estimated_num_rows(self):
        return self.n * 64

    def encoded_columns(self):
        return []


def _slow_df(conf=None, **kw):
    sess = tsession.TpuSession(dict(conf or {}), device="cpu")
    df = tsession.DataFrame(L.LogicalScan(SlowSource(**kw)), sess)
    return sess, df.group_by("k").agg(F.sum("v"))


def _engine_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("pipeline-", "telemetry-"))]


def _settled():
    assert buffer_catalog().num_entries() == 0
    assert tpu_semaphore().holders() == 0
    deadline = time.monotonic() + JOIN_S
    while _engine_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _engine_threads() == []


def test_names_match_jax():
    assert lifecycle.CANCEL_PHASES == jlifecycle.CANCEL_PHASES
    assert lifecycle.BREAKER_STATES == jlifecycle.BREAKER_STATES
    assert set(lifecycle.BREAKER_DOMAINS) <= set(jlifecycle.BREAKER_DOMAINS)
    assert set(lifecycle.BREAKER_DOMAINS) == {"adaptive", "device_dispatch",
                                              "ici_exchange"}


def test_cancel_from_a_second_thread():
    sess, df = _slow_df()
    result, rows = {}, []

    def run():
        try:
            df.collect()
        except BaseException as e:  # noqa: BLE001 — asserted below
            result["exc"] = e

    t = threading.Thread(target=run)
    t.start()
    deadline = time.monotonic() + JOIN_S
    while not sess.active_queries() and time.monotonic() < deadline:
        time.sleep(0.005)
    time.sleep(0.2)
    rows = sess.active_queries()
    t_cancel = time.monotonic()
    assert sess.cancel_query() == 1
    t.join(timeout=JOIN_S)
    latency = time.monotonic() - t_cancel
    assert not t.is_alive()
    assert isinstance(result.get("exc"), lifecycle.QueryCancelledError)
    assert result["exc"].reason == "user"
    assert latency < 2.0
    assert len(rows) == 1 and rows[0]["mine"] and \
        rows[0]["phase"] == "executing" and rows[0]["elapsed_ms"] >= 100
    assert sess.active_queries() == []
    assert sess.health()["counters"]["cancelled"] >= 1
    _settled()


def test_deadline_raises_timeout():
    sess, df = _slow_df({"spark.rapids.tpu.query.timeoutMs": "150"})
    t0 = time.monotonic()
    with pytest.raises(lifecycle.QueryCancelledError) as e:
        df.collect()
    assert e.value.reason == "timeout"
    assert time.monotonic() - t0 < 3.0
    _settled()


def test_an_uncancelled_query_still_finishes():
    sess, df = _slow_df(n=12, delay_s=0.001)
    rows = sorted(df.collect())
    assert [k for k, _ in rows] == sorted({k for k, _ in rows})
    assert sess.cancel_query() == 0
    _settled()


def _breaker_conf():
    return RapidsConf({"spark.rapids.tpu.breaker.enabled": "true",
                       "spark.rapids.tpu.breaker.threshold": "2",
                       "spark.rapids.tpu.breaker.cooldownMs": "50"})


def test_the_adaptive_breaker_opens_and_recovers():
    from spark_rapids_tpu_torch.config import set_active_conf
    lifecycle.reset_lifecycle()
    set_active_conf(_breaker_conf())
    assert lifecycle.breaker_allows("adaptive")
    lifecycle.record_domain_failure("adaptive")
    lifecycle.record_domain_failure("adaptive")
    assert lifecycle.open_breakers() == ["adaptive"]
    assert not lifecycle.breaker_allows("adaptive")
    time.sleep(0.08)
    assert lifecycle.breaker_allows("adaptive")  # the half-open probe
    lifecycle.begin_attempt(1)
    lifecycle.engage_domain("adaptive")
    lifecycle.attempt_succeeded()
    assert lifecycle.open_breakers() == []
    # the mesh lane's domain opens as the JAX package's does
    lifecycle.record_domain_failure("ici_exchange")
    lifecycle.record_domain_failure("ici_exchange")
    assert lifecycle.open_breakers() == ["ici_exchange"]
    assert not lifecycle.breaker_allows("ici_exchange")
    # the compiled stages' domain opens as the JAX package's does
    lifecycle.record_domain_failure("device_dispatch")
    lifecycle.record_domain_failure("device_dispatch")
    assert lifecycle.open_breakers() == ["device_dispatch", "ici_exchange"]
    h = lifecycle.health()
    assert h["breakers"]["adaptive"]["trips"] == 1
    assert h["breakers"]["device_dispatch"]["state"] == "open"
    assert h["breakers"]["ici_exchange"]["state"] == "open"
    assert all(b["state"] != "not ported" for b in h["breakers"].values())
    lifecycle.reset_lifecycle()


def test_kernel_family_failures_are_counted_never_routed():
    lifecycle.reset_lifecycle()
    lifecycle.begin_attempt(1)
    lifecycle.note_engagement("dma_row_gather")
    lifecycle.note_engagement("fused_probe_verify")
    from spark_rapids_tpu_torch.faults import InjectedDeviceError
    lifecycle.attempt_failed(InjectedDeviceError("device.dispatch"))
    assert lifecycle.kernel_failures() == {"dma_row_gather": 1,
                                           "fused_probe_verify": 1}
    assert lifecycle.open_breakers() == []
    assert lifecycle.health()["kernel_failures"]["dma_row_gather"] == 1
    lifecycle.reset_lifecycle()
    assert lifecycle.kernel_failures() == {}
