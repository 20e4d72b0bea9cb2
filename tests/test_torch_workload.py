"""exec/workload.py against the JAX package's: `pick_fair` over random
waiter sets and the grant order of one scripted arrival sequence are
exact; the priority table and admission states are the same. Port-only:
concurrent sessions admitted through the governor are granted in the
order `replay_grants` (pick_fair replayed on the recorded arrivals)
gives, a full queue sheds, and the quotas follow the admitted count.
Every thread joins with a timeout."""

import threading
import time

import numpy as np
import pytest

from spark_rapids_tpu.exec import workload as jworkload
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.exec import workload as tworkload

from test_torch_jax_ref import one_torch_thread
from test_torch_lifecycle import SlowSource
from test_torch_planner import active_confs

JOIN_S = 30.0


@pytest.fixture(scope="module", autouse=True)
def _confs():
    with active_confs(), one_torch_thread():
        yield
    tworkload.reset_workload()


def test_tables_match_jax():
    assert tworkload.PRIORITIES == jworkload.PRIORITIES
    assert tworkload.ADMISSION_STATES == jworkload.ADMISSION_STATES
    assert tworkload.AGING_EVERY == jworkload.AGING_EVERY


@pytest.mark.parametrize("seed", range(6))
def test_pick_fair_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        items = [(int(rng.integers(0, 2)), int(s)) for s in
                 rng.permutation(40)[:int(rng.integers(0, 12))]]
        grants = int(rng.integers(0, 20))
        args = (items, grants, lambda w: w[0], lambda w: w[1])
        assert tworkload.pick_fair(*args) == jworkload.pick_fair(*args)


def _scripted_grants(m, script):
    """Drive a manager through `script` — ("arrive", priority) queues a
    ticket, ("release",) frees the oldest admitted slot — on one thread,
    with one slot; returns the granted tickets' seqs in order."""
    granted = []
    with m._cond:
        m._max_concurrent = 1
    for step in script:
        with m._cond:
            if step[0] == "arrive":
                tk = (tworkload.Ticket if m.__class__ is
                      tworkload.WorkloadManager else jworkload.Ticket)(
                    step[1], seq=next(m._seq))
                m._queued.append(tk)
                if hasattr(m, "_log"):
                    m._log.append(("arrive", tk.seq, tk.rank))
            before = list(m._admitted)
            if step[0] == "release" and m._admitted:
                m._admitted.pop(0)
            m._pump_locked(1, [])
            granted += [t.seq for t in m._admitted if t not in before]
    return granted


SCRIPT = ([("arrive", "batch")] + [("arrive", p) for p in
          ["batch", "interactive", "batch", "batch", "interactive",
           "batch", "interactive", "batch", "batch"]]
          + [("release",)] * 10)


def test_grant_order_of_a_script_matches_jax():
    tm, jm = tworkload.WorkloadManager(), jworkload.WorkloadManager()
    got = _scripted_grants(tm, SCRIPT)
    assert got == _scripted_grants(jm, SCRIPT)
    assert len(got) == 10
    assert tworkload.replay_grants(tm.admission_log()) == got


def _session(priority, depth=4):
    conf = {"spark.rapids.tpu.workload.enabled": "true",
            "spark.rapids.tpu.workload.maxConcurrentQueries": "1",
            "spark.rapids.tpu.workload.queueDepth": str(depth),
            "spark.rapids.tpu.workload.priority": priority}
    return tsession.TpuSession(conf, device="cpu")


def _query(sess, n=6, delay_s=0.02):
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.plan import logical as L
    df = tsession.DataFrame(L.LogicalScan(SlowSource(n=n, delay_s=delay_s)),
                            sess)
    return df.group_by("k").agg(F.sum("v"))


def test_concurrent_admission_follows_the_fairness_rule():
    tworkload.reset_workload()
    blocker = _query(_session("batch"), n=40)
    results, errors = [], []

    def run(df, tag):
        try:
            results.append((tag, sorted(df.collect())))
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    first = threading.Thread(target=run, args=(blocker, "blocker"))
    first.start()
    deadline = time.monotonic() + JOIN_S
    while tworkload.snapshot()["admitted"] == 0 \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    threads = []
    for i, prio in enumerate(["batch", "interactive", "batch",
                              "interactive"]):
        t = threading.Thread(target=run, args=(_query(_session(prio), n=2),
                                               prio))
        t.start()
        threads.append(t)
        while tworkload.snapshot()["queue_depth"] < i + 1 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
    assert tworkload.snapshot()["queue_depth"] == 4
    # the queue is full: a fifth arrival sheds at once
    with pytest.raises(tworkload.QueryAdmissionError) as shed:
        _query(_session("batch")).collect()
    assert shed.value.reason == "queue_full"
    for t in [first] + threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
    assert errors == [] and len(results) == 5
    log = tworkload.admission_log()
    grants = [rec[1] for rec in log if rec[0] == "grant"]
    assert grants == tworkload.replay_grants(log)
    order = [tag for tag, _ in results]
    assert order[0] == "blocker"
    assert order[1:3] == ["interactive", "interactive"]
    c = tworkload.counters()
    assert c["shed"] == 1 and c["admitted"] == 5
    snap = tworkload.snapshot()
    assert snap["queue_depth"] == 0 and snap["admitted"] == 0


def test_quota_shares_match_jax():
    tm, jm = tworkload.WorkloadManager(), jworkload.WorkloadManager()
    for m, mod in ((tm, tworkload), (jm, jworkload)):
        for prio in ("interactive", "batch", "batch"):
            with m._cond:
                m._admitted.append(mod.Ticket(prio, seq=next(m._seq)))
    for limit, frac in ((1 << 30, 0.5), (1 << 30, 0.1), (12345, 0.2)):
        assert tm.quota_bytes(limit, frac) == jm.quota_bytes(limit, frac)
