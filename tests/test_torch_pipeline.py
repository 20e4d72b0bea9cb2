"""The prefetch pipeline (exec/pipeline.py), the admission semaphore
(memory/semaphore.py), SourceScanExec, the host allocator and the device
manager, on the CPU; the q3 slice read from a host source against the JAX
package's SourceScanExec plan.

Rows and their order are exact at every depth; q3's revenue agrees with
the JAX package's to rtol 1e-9 (summation order), its keys exactly.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar import upload as jupload
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.exec import aggregate as jagg
from spark_rapids_tpu.exec import basic as jbasic
from spark_rapids_tpu.exec import joins as jjoins
from spark_rapids_tpu.exec import sort as jsort
from spark_rapids_tpu.expr import aggexprs as jaggexprs
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred

import chip_smoke as cs
from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar import upload
from spark_rapids_tpu_torch.columnar.column import Column as TColumn
from spark_rapids_tpu_torch.columnar.column import bucket_capacity
from spark_rapids_tpu_torch.exec import basic as tbasic
from spark_rapids_tpu_torch.exec import pipeline, speculation
from spark_rapids_tpu_torch.memory import (
    DeviceManager, HostAlloc, HostOOM, SemaphoreTimeout, TpuSemaphore,
    memory_budget, reset_tpu_semaphore, retry, tpu_semaphore)

from test_torch_jax_ref import jax_aliases

N_ORDERS = 1 << 12
N_LINES = 1 << 14
RTOL = 1e-9

JAX = SimpleNamespace(t=jt, core=jcore, pred=jpred, basic=jbasic,
                      joins=jjoins, agg=jagg, aggexprs=jaggexprs, sort=jsort)


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


@pytest.fixture(autouse=True)
def _fresh_semaphore():
    reset_tpu_semaphore()
    yield
    sem = tpu_semaphore()
    assert sem.holders() == 0 and sem.available == sem.permits
    reset_tpu_semaphore()


def _threads():
    return {t for t in threading.enumerate() if t.name.startswith("pipeline")}


# -- the pipeline -------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 1, 2, 5])
def test_stage_keeps_order_at_every_depth(depth):
    stage = pipeline.pipelined(iter(range(50)), depth)
    try:
        assert list(stage) == list(range(50))
    finally:
        stage.close()
    assert stage.batches == 50
    assert isinstance(stage, pipeline._SyncStage) == (depth == 0)


def test_close_when_the_consumer_stops_early():
    closed = threading.Event()

    def source():
        try:
            for i in range(1000):
                yield i
        finally:
            closed.set()
    before = _threads()
    stage = pipeline.pipelined(source(), 2, label="early")
    assert [next(stage) for _ in range(3)] == [0, 1, 2]
    stage.close()
    assert closed.wait(5) and not stage.stuck
    assert not stage._thread.is_alive()
    assert _threads() <= before
    with pytest.raises(StopIteration):
        next(stage)


def test_producer_error_reaches_the_consumer_after_its_items():
    def source():
        yield 1
        yield 2
        raise ValueError("decode failed")
    stage = pipeline.pipelined(source(), 2)
    got = [next(stage), next(stage)]
    with pytest.raises(ValueError, match="decode failed"):
        next(stage)
    stage.close()
    assert got == [1, 2]


def test_producer_takes_over_the_consumers_thread_state():
    seen = {}

    def source():
        seen["scope"] = speculation.current_scope()
        seen["exact"] = speculation._state.forced_exact
        seen["task"] = retry.capture_task_state()
        seen["cancelled"] = pipeline.cancelled()
        seen["thread"] = threading.current_thread().name
        yield 1
    retry.register_task(77)
    retry.force_retry_oom(2)
    try:
        with speculation.speculation_scope() as scope, \
                speculation.force_exact():
            want = retry.capture_task_state()
            stage = pipeline.pipelined(source(), 2, label="ctx")
            assert list(stage) == [1]
            stage.close()
    finally:
        retry.unregister_task()
    assert seen["scope"] is scope and seen["exact"] is True
    assert seen["task"] == want and want["task_id"] == 77
    assert want["inject_mode"] == "retry" and want["inject_remaining"] == 2
    assert seen["cancelled"] is False
    assert seen["thread"].startswith("pipeline-ctx")


def test_stage_metrics_are_bound():
    scan = tbasic.SourceScanExec(_IntSource(5), _INT_SCHEMA, depth=2)
    assert [b.num_rows_host for b in scan.execute()] == [1] * 5
    assert scan.metrics["numUploads"].value == 5
    assert scan.metrics["pipelineWallNs"].value > 0
    assert scan.runs_own_pipeline_stage


# -- the admission semaphore ----------------------------------------------

def _wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("condition not reached")
        time.sleep(0.005)


def test_semaphore_serves_waiters_first_in_first_out():
    sem = TpuSemaphore(1)
    assert sem.acquire_if_necessary(0)
    order = []

    def wait(task):
        assert sem.acquire_if_necessary(task)
        order.append(task)
        sem.release_if_necessary(task)
    threads = []
    for task in (1, 2, 3):
        th = threading.Thread(target=wait, args=(task,))
        th.start()
        threads.append(th)
        _wait_for(lambda: len(sem._pool._waiters) == task)
    sem.release_if_necessary(0)
    for th in threads:
        th.join(5)
        assert not th.is_alive()
    assert order == [1, 2, 3]
    assert sem.available == 1 and sem.total_wait_ns > 0


def test_semaphore_reentry_costs_nothing_from_any_thread():
    sem = TpuSemaphore(2)
    assert sem.acquire_if_necessary(5)
    assert sem.acquire_if_necessary(5)
    other = []
    th = threading.Thread(
        target=lambda: other.append(sem.acquire_if_necessary(5)))
    th.start()
    th.join(5)
    assert other == [True] and sem.available == 1 and sem.holders() == 1
    sem.release_if_necessary(5)  # task end releases the whole hold
    assert sem.available == 2 and not sem.held_by(5)


def test_semaphore_cancel_returns_false_without_the_permit():
    sem = TpuSemaphore(1)
    assert sem.acquire_if_necessary(1)
    flag = threading.Event()
    out = []
    th = threading.Thread(target=lambda: out.append(
        sem.acquire_if_necessary(2, cancel=flag.is_set)))
    th.start()
    _wait_for(lambda: sem._pool._waiters)
    flag.set()
    th.join(5)
    assert out == [False] and not sem.held_by(2)
    sem.release_if_necessary(1)
    assert sem.available == 1 and not sem._pool._waiters


def test_semaphore_release_at_task_end_of_a_blocked_first_acquire():
    sem = TpuSemaphore(1)
    assert sem.acquire_if_necessary(1)
    out = []
    th = threading.Thread(target=lambda: out.append(
        sem.acquire_if_necessary(2)))
    th.start()
    _wait_for(lambda: sem._pool._waiters)
    sem.release_if_necessary(2)  # task 2 ends while its acquire waits
    sem.release_if_necessary(1)
    th.join(5)
    assert out == [False]
    assert sem.available == 1 and sem.holders() == 0


def test_semaphore_never_admits_more_tasks_than_permits():
    """16 tasks on 16 threads (more than the cores), the switch interval
    shortened: the tasks inside never outnumber the permits, and every
    permit comes back."""
    import sys
    sem = TpuSemaphore(2)
    lock = threading.Lock()
    inside = [0]
    peak = [0]

    def work(task):
        for _ in range(30):
            assert sem.acquire_if_necessary(task)
            with lock:
                inside[0] += 1
                peak[0] = max(peak[0], inside[0])
            with lock:
                inside[0] -= 1
            sem.release_if_necessary(task)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert 1 <= peak[0] <= 2
    assert sem.available == 2 and sem.holders() == 0


def test_semaphore_timeout_raises():
    sem = TpuSemaphore(1, timeout_s=0.1)
    assert sem.acquire_if_necessary(1)
    with pytest.raises(SemaphoreTimeout):
        sem.acquire_if_necessary(2)
    assert not sem.held_by(2) and not sem._pool._waiters
    sem.release_if_necessary(1)
    assert sem.available == 1


# -- SourceScanExec -----------------------------------------------------------

_INT_SCHEMA = tt.Schema((tt.StructField("x", tt.INT),))


class _IntSource:
    """`n` one-row host batches; each step checks that its scan holds
    the admission permit while it uploads, and `fail_at` makes the
    upload of that batch raise."""

    device = "cpu"

    def __init__(self, n, fail_at=None, raise_at=None):
        self.n, self.fail_at, self.raise_at = n, fail_at, raise_at
        self.scan = None
        self.held = []

    def batches(self):
        for i in range(self.n):
            if i == self.raise_at:
                raise OSError("the source broke")
            sem = tpu_semaphore()
            self.held.append((self.scan is None
                              or sem.held_by(self.scan._op_id),
                              sem.holders()))
            col = TColumn.from_numpy(np.array([i], np.int32), tt.INT,
                                     device="cpu")
            if i == self.fail_at:
                col = _Unsupported(col.data, col.validity, tt.INT)
            yield upload.to_device_batch([col], 1, _INT_SCHEMA, "cpu")


class _Unsupported(TColumn):
    pass


@pytest.mark.parametrize("depth", [0, 2])
def test_scan_holds_one_permit_per_scan(depth):
    sources = [_IntSource(6), _IntSource(6)]
    scans = [tbasic.SourceScanExec(s, _INT_SCHEMA, depth) for s in sources]
    for s, scan in zip(sources, scans):
        s.scan = scan
    reset_tpu_semaphore(2)
    it = [scan.execute() for scan in scans]
    rows = []
    for _ in range(6):
        for i in it:
            rows.append(next(i).to_pylist()[0][0])
    for i in it:
        assert next(i, None) is None
    assert rows == [k for k in range(6) for _ in range(2)]
    for s in sources:
        assert all(held for held, _ in s.held)
        assert all(holders <= 2 for _, holders in s.held)


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("kind", ["upload", "producer"])
def test_failure_raises_through_collect_with_the_permit_released(depth,
                                                                 kind):
    src = _IntSource(5, fail_at=3) if kind == "upload" \
        else _IntSource(5, raise_at=3)
    scan = tbasic.SourceScanExec(src, _INT_SCHEMA, depth)
    err = NotImplementedError if kind == "upload" else OSError
    with pytest.raises(err):
        scan.collect()
    sem = tpu_semaphore()
    assert sem.holders() == 0 and sem.available == sem.permits
    assert upload.staging_pool().outstanding_bytes() == 0


class _JaxHostSource:
    """The JAX package's counterpart of chip_smoke.HostSource: host
    numpy columns uploaded by its to_device_batch, one per step."""

    def __init__(self, d, schema, n, parts):
        self.d, self.schema, self.n, self.parts = d, schema, n, parts

    def batches(self):
        step = self.n // self.parts
        cap = bucket_capacity(step)
        for i in range(0, self.n, step):
            cols = []
            for f in self.schema.fields:
                data = np.zeros(cap, self.d[f.name].dtype)
                data[:step] = self.d[f.name][i: i + step]
                valid = np.zeros(cap, np.bool_)
                valid[:step] = True
                cols.append(JColumn(data, valid, f.data_type))
            yield jupload.to_device_batch(cols, step, self.schema,
                                          seam="scan")


def _jax_q3_source_plan(d):
    o_schema = jt.Schema((jt.StructField("o_orderkey", jt.LONG),
                          jt.StructField("o_flag", jt.INT)))
    l_schema = jt.Schema((jt.StructField("l_orderkey", jt.LONG),
                          jt.StructField("l_price", jt.DOUBLE),
                          jt.StructField("l_disc", jt.DOUBLE),
                          jt.StructField("l_flag", jt.INT)))
    return cs.q3_tree(
        JAX, jbasic.SourceScanExec(_JaxHostSource(d, o_schema, N_ORDERS, 4),
                                   o_schema),
        jbasic.SourceScanExec(_JaxHostSource(d, l_schema, N_LINES, 16),
                              l_schema))


@pytest.fixture(scope="module")
def q3_small():
    old = cs.Q3_ORDERS, cs.Q3_LINES
    cs.Q3_ORDERS, cs.Q3_LINES = N_ORDERS, N_LINES
    try:
        yield cs.q3_data()
    finally:
        cs.Q3_ORDERS, cs.Q3_LINES = old


def test_q3_from_a_host_source_equals_the_jax_scan_plan(q3_small):
    d = q3_small
    jrows = _jax_q3_source_plan(d).collect()
    before = upload.counters()
    rows = {}
    for depth in (0, 2):
        rows[depth] = cs.q3_source_plan(d, "cpu", depth, 16, 4).collect()
    after = upload.counters()
    assert after["uploads"] - before["uploads"] == 2 * (16 + 4)
    assert after["transfers"] - before["transfers"] == 2 * (16 + 4)
    assert [(k, np.float64(v).tobytes()) for k, v in rows[0]] == \
        [(k, np.float64(v).tobytes()) for k, v in rows[2]]
    assert [int(k) for k, _ in rows[2]] == [int(k) for k, _ in jrows]
    for (_, v), (_, w) in zip(rows[2], jrows):
        assert abs(v - w) <= RTOL * abs(w)
    cs.check_q3(rows[2], cs.q3_oracle(d), "q3 from the host")


# -- host allocator and device manager --------------------------------------

def test_host_alloc_lanes_and_blocking():
    pool = HostAlloc(1000, pinned_bytes=0)
    a = pool.alloc(600)
    assert not a.pinned and a.buffer.shape[0] == 600
    assert pool.try_alloc(500) is None
    with pytest.raises(HostOOM):
        pool.alloc(2000)  # larger than any lane: at once
    with pytest.raises(HostOOM):
        pool.alloc(500, timeout_s=0.05)
    got = []
    th = threading.Thread(target=lambda: got.append(pool.alloc(500)))
    th.start()
    time.sleep(0.05)
    a.close()  # the release wakes the waiter
    th.join(5)
    assert got and pool.used_bytes == 500
    got[0].close()
    assert pool.used_bytes == 0 and pool.free_bytes == 1000


def test_host_alloc_pinned_lane_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: pinned memory is allocatable")
    pool = HostAlloc(1000, pinned_bytes=400)
    with pytest.raises(RuntimeError):
        pool.alloc(300)  # the pinned lane first: no silent fallback
    assert pool.used_bytes == 0
    with pool.alloc(300, prefer_pinned=False) as a:
        assert not a.pinned and pool.used_bytes == 300
    assert pool.used_bytes == 0


def test_device_manager_on_the_cpu():
    old = tpu_semaphore()
    m = DeviceManager()
    with pytest.raises(NotImplementedError, match="A.6"):
        m.initialize(mesh_axes={"data": 2}, device="cpu")
    assert m.initialize(device="cpu").device == torch.device("cpu")
    assert tpu_semaphore() is not old and memory_budget().limit > 0
    assert m.initialize() is m  # once initialized, it stays
    m.shutdown()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeviceManager().initialize()
