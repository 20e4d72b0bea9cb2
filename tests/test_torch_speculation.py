"""The straggler and stall shield (exec/speculation_shield.py), on the
CPU, with timeouts in tens of ms:

- ReadSpeculation: the bound is the JAX package's for the same latencies
  (its floor on a cold histogram, p95 x multiplier as they grow); a fast
  primary never speculates; a straggler's duplicate wins; a denied
  straggler waits on its primary; both attempts failing raise the
  primary's error; a shuffle read under a `shuffle.fetch` delay fault
  with speculation on gives the static rows with a speculative win;
- the progress watchdog: off by default; `report` emits one
  `query_stalled` and re-arms for the next episode, `retry-seam` makes
  the next checkpoint raise QueryStalledError (a governed query then
  takes two attempts), `cancel` cancels the query;
- timed_call: results and errors pass through; past the bound it raises
  DispatchTimeoutError ("task"), counts and emits it, and no breaker or
  kernel route changes; a wedged call retried by the task-retry lane
  surfaces after maxAttempts (ROADMAP C.16); the dispatch ledger reads
  the bound from its conf.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from spark_rapids_tpu.exec import speculation_shield as jshield

from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec import lifecycle
from spark_rapids_tpu_torch.exec import speculation_shield as shield
from spark_rapids_tpu_torch.exec import task_retry
from spark_rapids_tpu_torch.obs import dispatch
from spark_rapids_tpu_torch.obs import events
from spark_rapids_tpu_torch.shuffle import manager as tmanager

from test_torch_jax_ref import one_torch_thread
from test_torch_planner import active_confs


@pytest.fixture(scope="module", autouse=True)
def _confs():
    with active_confs(), one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def _fresh(tmp_path):
    tmanager.reset_shuffle_manager(str(tmp_path))
    shield.reset_shield()
    lifecycle.reset_lifecycle()
    faults.install(None)
    yield
    faults.install(None)
    shield.reset_shield()
    dispatch.reset_dispatch_ledger()


@pytest.fixture
def spy(monkeypatch):
    seen = []
    real = events.emit

    def emit(kind, **fields):
        seen.append((kind, fields))
        return real(kind, **fields)
    monkeypatch.setattr(events, "emit", emit)
    return seen


@pytest.fixture
def pool():
    with ThreadPoolExecutor(4) as p:
        yield p


def _later(value, seconds):
    time.sleep(seconds)
    return value


# -- ReadSpeculation -----------------------------------------------------------

def test_bound_floor_and_growth_match_jax():
    port = shield.ReadSpeculation(2.0, 40, 4)
    ref = jshield.ReadSpeculation(2.0, 40, 4)
    assert port.bound_ms("fetch") == ref.bound_ms("fetch") == 40
    for ms in (1, 3, 30, 60, 90, 120, 200):
        for s in (port, ref):
            s._hists["fetch"].add(ms)
        assert port.bound_ms("fetch") == ref.bound_ms("fetch")
    assert port.bound_ms("fetch") > 200
    assert port.bound_ms("decode") == 40


def test_fast_primary_never_speculates(pool):
    spec = shield.ReadSpeculation(1.0, 50, 4)
    fut = pool.submit(spec.timed, "fetch", _later, "a", 0.0)
    launched = []
    assert spec.resolve("fetch", fut, lambda: launched.append(1),
                        "k") == "a"
    assert not launched and shield.counters()["spec_launched"] == 0


def test_straggler_duplicate_wins(pool, spy):
    spec = shield.ReadSpeculation(1.0, 20, 4)
    primary = pool.submit(_later, "slow", 0.5)
    out = spec.resolve("fetch", primary,
                       lambda: pool.submit(_later, "fast", 0.0), "m:0")
    c = shield.counters()
    assert out == "fast" and c["spec_wins"] == 1 and c["spec_launched"] == 1
    assert c["spec_wait_ns"] > 0
    ev = [f for k, f in spy if k == "speculative_fetch"]
    assert ev == [dict(ev[0], stage="fetch", key="m:0", winner="spec")]


def test_denied_straggler_waits_for_its_primary(pool):
    spec = shield.ReadSpeculation(1.0, 10, 1)
    assert shield._take_slot(1)          # the query's one slot is taken
    try:
        primary = pool.submit(_later, "primary", 0.08)
        out = spec.resolve("decode", primary,
                           lambda: pytest.fail("no slot, no duplicate"),
                           "p0:0")
    finally:
        shield._release_slot()
    c = shield.counters()
    assert out == "primary" and c["spec_denied"] == 1
    assert c["spec_launched"] == 0


def test_both_attempts_failing_raise_the_primarys_error(pool):
    def fail(msg, seconds):
        time.sleep(seconds)
        raise OSError(msg)
    spec = shield.ReadSpeculation(1.0, 10, 4)
    primary = pool.submit(fail, "primary", 0.05)
    with pytest.raises(OSError, match="primary"):
        spec.resolve("fetch", primary,
                     lambda: pool.submit(fail, "duplicate", 0.0), "k")
    assert shield.counters()["spec_wins"] == 0


def test_speculative_shuffle_read_under_a_fetch_delay(spy):
    from test_torch_recovery import _read
    clean, _, _ = _read("port", {})
    settings = {"spark.rapids.tpu.shuffle.speculation.enabled": "true",
                "spark.rapids.tpu.shuffle.speculation.minMs": "20"}
    got = _read("port", settings,
                "shuffle.fetch:prob=1,seed=1,kind=delay,ms=300,max=1")
    assert got == (clean, 1, 0)
    assert shield.counters()["spec_wins"] >= 1
    assert any(k == "speculative_fetch" and f["winner"] == "spec"
               for k, f in spy)


# -- the progress watchdog -----------------------------------------------------

def test_watchdog_is_off_by_default():
    with lifecycle.governed(RapidsConf()) as ctx:
        assert shield.watchdog_for(ctx, RapidsConf()) is None


def _stall(action, windows):
    conf = RapidsConf({"spark.rapids.tpu.stall.timeoutMs": "30",
                       "spark.rapids.tpu.stall.action": action})
    with lifecycle.governed(conf) as ctx:
        dog = shield.watchdog_for(ctx, conf)
        try:
            time.sleep(0.03 * windows)
        finally:
            dog.stop()
        return ctx


def test_watchdog_report_fires_once_an_episode_and_rearms(spy):
    ctx = _stall("report", 5)
    stalls = [f for k, f in spy if k == "query_stalled"]
    # one a full frozen window: at most 5 in 5 windows, and a second
    # episode after the first
    assert 2 <= len(stalls) <= 5
    assert stalls[0]["action"] == "report" and stalls[0]["timeout_ms"] == 30
    assert shield.counters()["stalls"] == len(stalls)
    assert not ctx.cancelled() and not ctx.stall_retry


def test_watchdog_retry_seam_raises_at_the_next_checkpoint():
    ctx = _stall("retry-seam", 2)
    assert ctx.stall_retry
    with pytest.raises(faults.QueryStalledError):
        ctx.check("pipeline-wait")
    ctx.check("compute")                 # consumed: the retry starts clean
    assert faults.classify(faults.QueryStalledError("x")) == "task"


def test_watchdog_cancel_cancels_the_query():
    ctx = _stall("cancel", 2)
    assert ctx.cancelled() and ctx.reason == "stalled"
    with pytest.raises(lifecycle.QueryCancelledError):
        ctx.check("compute")
    # one cancel an episode (a frozen query fires again each window)
    c = shield.counters()
    assert c["stall_cancels"] == c["stalls"] >= 1


def test_governed_query_retries_a_stalled_seam(spy):
    from spark_rapids_tpu_torch import TpuSession, functions as F
    from spark_rapids_tpu_torch.types import LONG, Schema, StructField
    sess = TpuSession({
        "spark.rapids.sql.shuffle.partitions": "2",
        "spark.rapids.tpu.stall.timeoutMs": "500",
        "spark.rapids.tpu.stall.action": "retry-seam",
        "spark.rapids.tpu.task.retryBackoffMs": "1",
        # longer than the window, shorter than two: one episode, and the
        # stalled attempt unwinds before the re-armed window ends
        "spark.rapids.tpu.test.faults":
            "pipeline.produce:prob=1,seed=1,kind=delay,ms=700,max=1"},
        device="cpu")
    schema = Schema((StructField("k", LONG), StructField("v", LONG)))
    df = sess.from_pydict({"k": [i % 5 for i in range(200)],
                           "v": list(range(200))}, schema)
    before = task_retry.task_retry_total()
    try:
        rows = sorted(df.group_by("k").agg(F.sum("v")).collect())
    finally:
        faults.install(None)
    assert rows == [(k, sum(v for v in range(200) if v % 5 == k))
                    for k in range(5)]
    assert task_retry.task_retry_total() - before == 1
    assert [f["action"] for k, f in spy if k == "query_stalled"][:1] == \
        ["retry-seam"]


# -- the dispatch hang bound ---------------------------------------------------

def test_timed_call_passes_results_and_errors_through():
    assert shield.timed_call(lambda: 7, 50, "device_dispatch", "x",
                             ready=lambda: (lambda: True)) == 7
    def boom():
        raise ValueError("boom")
    with pytest.raises(ValueError, match="boom"):
        shield.timed_call(boom, 50, "device_dispatch", "x")
    assert shield.counters()["dispatch_timeouts"] == 0


def test_timed_call_timeout_raises_and_never_reroutes(spy):
    health0 = lifecycle.health()
    done = threading.Event()
    with pytest.raises(faults.DispatchTimeoutError) as err:
        shield.timed_call(lambda: 3, 30, "device_dispatch",
                          "dma_row_gather", ready=lambda: done.is_set)
    assert faults.classify(err.value) == "task"
    assert shield.counters()["dispatch_timeouts"] == 1
    ev = [f for k, f in spy if k == "dispatch_timeout"]
    assert ev == [{"domain": "device_dispatch", "what": "dma_row_gather",
                   "timeout_ms": 30}]
    # no breaker opened, no kernel family failed over: the route stays
    assert lifecycle.health() == health0
    assert lifecycle.kernel_failures() == {}
    done.set()
    assert shield.timed_call(lambda: 4, 30, "device_dispatch", "x",
                             ready=lambda: done.is_set) == 4


def test_a_wedged_kernel_surfaces_after_the_task_retry_lane():
    """ROADMAP C.16: the wedged kernel keeps its stream busy, so every
    retry times out behind it and the bounded lane raises."""
    wedged = threading.Event()
    conf = RapidsConf({"spark.rapids.tpu.task.maxAttempts": "3",
                       "spark.rapids.tpu.task.retryBackoffMs": "1"})
    calls = []

    def attempt(n):
        calls.append(n)
        return shield.timed_call(lambda: n, 20, "device_dispatch", "k",
                                 ready=lambda: wedged.is_set)
    with pytest.raises(faults.DispatchTimeoutError):
        task_retry.with_task_retry(attempt, conf=conf)
    assert calls == [1, 2, 3]
    assert shield.counters()["dispatch_timeouts"] == 3


def test_the_ledger_reads_the_bound_and_the_cpu_pays_nothing():
    led = dispatch.configure(RapidsConf(
        {"spark.rapids.tpu.dispatch.timeoutMs": "10000"}))
    assert led.timeout_ms == 10000
    with dispatch.kernel_site("dma_row_gather", (4,), "cpu") as s:
        s.count()
    assert shield.counters()["dispatch_timeouts"] == 0
    assert dispatch.configure(RapidsConf()).timeout_ms == 0
    assert shield.dispatch_timeout_ms(RapidsConf(
        {"spark.rapids.tpu.dispatch.timeoutMs": "5"})) == 5
    with shield.dispatch_domain("ici_exchange"):
        assert shield.current_dispatch_domain() == "ici_exchange"
    assert shield.current_dispatch_domain() == "device_dispatch"
