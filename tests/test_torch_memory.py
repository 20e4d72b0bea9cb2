"""The memory runtime of the port (memory/: budget, spill catalog,
spillable batches, retry and split) on the CPU: every case of the JAX
package's tests/test_memory.py for these modules, a corrupted spill file,
and parity with the JAX package's runtime on the same inputs — a batch's
byte count, the tier of every handle after the same adds under the same
budget, and the row counts of a split. Everything compared is an integer
or a tier: exact, no tolerance."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_tpu import config as jconf
from spark_rapids_tpu import memory as jmem
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.columnar.column import StringColumn as JString
from spark_rapids_tpu.memory import catalog as jcatalog

from spark_rapids_tpu_torch import memory as tmem
from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch as TBatch
from spark_rapids_tpu_torch.columnar.column import Column as TColumn
from spark_rapids_tpu_torch.columnar.column import StringColumn as TString
from spark_rapids_tpu_torch.memory import catalog as tcatalog
from spark_rapids_tpu_torch.memory import (
    SpillableBatch, SpillFileCorruption, StorageTier, TpuRetryOOM,
    TpuSplitAndRetryOOM, buffer_catalog, force_retry_oom,
    force_split_and_retry_oom, memory_budget, register_task,
    reset_buffer_catalog, reset_memory_budget, split_in_half_by_rows,
    task_retry_counts, with_retry, with_retry_no_split,
)

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


@pytest.fixture(autouse=True)
def small_pool():
    """512 KiB budget and a fresh catalog per test (the JAX package's
    test_memory fixture)."""
    reset_buffer_catalog()
    reset_memory_budget(512 * 1024)
    register_task(1)
    yield
    reset_buffer_catalog()
    reset_memory_budget()


def batch_of(n, start=0):
    a = np.arange(start, start + n, dtype=np.int64)
    return TBatch([TColumn.from_numpy(a, tt.LONG, device="cpu"),
                   TColumn.from_numpy(a * 10, tt.LONG, device="cpu")], n,
                  tt.Schema((tt.StructField("a", tt.LONG),
                             tt.StructField("b", tt.LONG))))


def jax_batch(t: TBatch) -> JBatch:
    """The JAX package's batch of the same tensors (fixed-width and
    string columns)."""
    cols = []
    for c, f in zip(t.columns, t.schema.fields):
        dt = getattr(jt, type(f.data_type).__name__)()
        if isinstance(c, TString):
            cols.append(JString(jnp.asarray(c.data.numpy()),
                                jnp.asarray(c.offsets.numpy()),
                                jnp.asarray(c.validity.numpy()),
                                dt))
        else:
            cols.append(JColumn(jnp.asarray(c.data.numpy()),
                                jnp.asarray(c.validity.numpy()), dt))
    schema = jt.Schema(tuple(jt.StructField(f.name, col.dtype)
                             for f, col in zip(t.schema.fields, cols)))
    return JBatch(cols, t.num_rows_host, schema)


# -- the JAX package's test_memory cases -------------------------------------

def test_spillable_roundtrip():
    sb = SpillableBatch.from_batch(batch_of(100))
    got = sb.get_batch()
    assert got.to_pydict()["a"][:3] == [0, 1, 2]
    sb.release()
    sb.close()
    assert buffer_catalog().num_entries() == 0


def test_spill_to_host_and_back():
    sb = SpillableBatch.from_batch(batch_of(64))
    cat = buffer_catalog()
    freed = cat.synchronous_spill(None)
    assert freed > 0
    assert cat.tier_of(sb._handle) == StorageTier.HOST
    got = sb.get_batch()  # acquire unspills transparently
    assert got.to_pydict()["b"][3] == 30
    assert cat.tier_of(sb._handle) == StorageTier.DEVICE
    sb.release()
    sb.close()


@pytest.mark.parametrize("async_write", [True, False])
def test_spill_to_disk(tmp_path, async_write):
    cat = reset_buffer_catalog(host_limit=1024, spill_dir=str(tmp_path),
                               async_write=async_write)
    sb = SpillableBatch.from_batch(batch_of(64))
    cat.synchronous_spill(None)  # device -> host -> (limit 1k) -> disk
    assert cat.tier_of(sb._handle) == StorageTier.DISK
    cat.drain_writeback()
    assert list(tmp_path.glob("spill-*.npz"))
    got = sb.get_batch()
    assert got.to_pydict()["a"][5] == 5
    assert got.num_rows_host == 64 and got._host_rows == 64
    sb.release()
    sb.close()
    assert not list(tmp_path.glob("spill-*.npz"))
    assert cat.counters()["from_disk"] == 1


def test_in_use_entries_are_not_spilled():
    sb = SpillableBatch.from_batch(batch_of(32))
    sb.get_batch()  # pinned
    cat = buffer_catalog()
    cat.synchronous_spill(None)
    assert cat.tier_of(sb._handle) == StorageTier.DEVICE
    sb.release()
    cat.synchronous_spill(None)
    assert cat.tier_of(sb._handle) == StorageTier.HOST
    sb.close()


def test_budget_pressure_triggers_spill():
    """Reserving past the limit spills idle spillables instead of
    failing."""
    budget = memory_budget()
    sb = SpillableBatch.from_batch(batch_of(1000))
    assert budget.used > 0
    budget.reserve(budget.limit - budget.used + 1)  # forces a spill
    assert buffer_catalog().tier_of(sb._handle) == StorageTier.HOST
    sb.close()


def test_budget_oom_when_nothing_spillable():
    budget = memory_budget()
    with pytest.raises(TpuRetryOOM):
        budget.reserve(budget.limit + 1)


def test_with_retry_recovers_from_injected_oom():
    attempts = []

    def body(b):
        attempts.append(1)
        return b.num_rows_host

    force_retry_oom()
    out = list(with_retry(batch_of(10), body))
    assert out == [10]
    assert task_retry_counts() == (1, 0)


def test_with_retry_split_halves_batch():
    force_split_and_retry_oom()
    out = list(with_retry(batch_of(10), lambda b: b.num_rows_host,
                          split_policy=split_in_half_by_rows))
    assert out == [5, 5]
    assert task_retry_counts()[1] == 1


def test_with_retry_split_preserves_rows():
    force_split_and_retry_oom()
    seen = []
    for b in with_retry(batch_of(9), lambda b: b.to_pydict()["a"],
                        split_policy=split_in_half_by_rows):
        seen.extend(b)
    assert seen == list(range(9))


def test_split_halves_keep_the_parent_capacity():
    force_split_and_retry_oom()
    caps = list(with_retry(batch_of(300), lambda b: b.capacity,
                           split_policy=split_in_half_by_rows))
    assert caps == [512, 512]


def test_with_retry_no_split_escalates():
    force_split_and_retry_oom()
    with pytest.raises(TpuSplitAndRetryOOM):
        with_retry_no_split(batch_of(4), lambda b: b)


def test_retry_gives_up_after_max_attempts(monkeypatch):
    from spark_rapids_tpu_torch import config as tconf
    monkeypatch.setattr(tconf._active, "conf", tconf.RapidsConf({
        "spark.rapids.sql.retry.maxAttempts": "3",
        "spark.rapids.tpu.retry.backoffMs": "0"}), raising=False)
    register_task(2)
    calls = []

    def always_oom(b):
        calls.append(1)
        raise TpuRetryOOM("persistent")

    with pytest.raises(TpuRetryOOM):
        list(with_retry(batch_of(4), always_oom))
    assert len(calls) == 3


def test_spilled_split_inputs_are_closed_by_with_retry():
    """Split products of a SpillableBatch belong to with_retry: every
    half is closed once its result is out, and the catalog ends empty."""
    force_split_and_retry_oom(2)
    sb = SpillableBatch.from_batch(batch_of(40))

    def run(s):
        b = s.get_batch()
        try:
            return b.to_pydict()["a"]
        finally:
            s.release()

    seen = [x for part in with_retry(sb, run,
                                     split_policy=split_in_half_by_rows)
            for x in part]
    assert seen == list(range(40))
    assert buffer_catalog().num_entries() == 0


@pytest.mark.parametrize("async_write", [True, False])
def test_corrupted_spill_file_raises(tmp_path, async_write):
    cat = reset_buffer_catalog(host_limit=0, spill_dir=str(tmp_path),
                               async_write=async_write)
    sb = SpillableBatch.from_batch(batch_of(64))
    cat.synchronous_spill(None)
    cat.drain_writeback()
    path, = tmp_path.glob("spill-*.npz")
    raw = bytearray(path.read_bytes())
    raw[-10] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(SpillFileCorruption, match="checksum"):
        sb.get_batch()
    sb.close()


@pytest.mark.parametrize("async_write", [True, False])
def test_failed_disk_write_raises(tmp_path, monkeypatch, async_write):
    """A disk spill that fails raises — on the spilling thread, or at the
    entry's next acquire and at drain_writeback when the writer failed —
    and leaves no file behind."""
    def full(path, leaves):
        open(path, "wb").close()
        raise OSError("no space left on device")

    monkeypatch.setattr(tcatalog, "write_spill_file", full)
    cat = reset_buffer_catalog(host_limit=0, spill_dir=str(tmp_path),
                               async_write=async_write)
    sb = SpillableBatch.from_batch(batch_of(64))
    if not async_write:
        with pytest.raises(OSError, match="no space"):
            cat.synchronous_spill(None)
        assert cat.tier_of(sb._handle) == StorageTier.HOST
    else:
        cat.synchronous_spill(None)
        with pytest.raises(tmem.SpillWriteError):
            cat.drain_writeback()
        with pytest.raises(tmem.SpillWriteError):
            sb.get_batch()
    assert not list(tmp_path.glob("spill-*"))
    sb.close()


# -- parity with the JAX package's runtime ------------------------------------

def _string_batch(n, seed):
    rng = np.random.default_rng(seed)
    words = ["", "a", "bb", "cccc", "dddddddd"]
    vals = [None if rng.random() < 0.2 else words[rng.integers(0, 5)]
            for _ in range(n)]
    s = TString.from_pylist(vals, device="cpu")
    x = TColumn.from_numpy(rng.integers(0, 9, n).astype(np.int32), tt.INT,
                           device="cpu")
    return TBatch([x, s], n, tt.Schema((tt.StructField("x", tt.INT),
                                        tt.StructField("s", tt.STRING))))


@pytest.mark.parametrize("kind", ["long", "string", "dictionary", "empty"])
def test_batch_nbytes_equals_the_reference(kind):
    if kind == "dictionary":
        words = ("REG AIR", "AIR", "")
        rng = np.random.default_rng(3)
        jb, tb = both_batch({
            "m": ((rng.integers(0, 3, 300).astype(np.int32), words),
                  "STRING", rng.random(300) > 0.1),
            "q": (rng.integers(0, 50, 300).astype(np.int64), "LONG",
                  None)}, 300)
    else:
        tb = {"long": lambda: batch_of(1000, 7),
              "string": lambda: _string_batch(700, 1),
              "empty": lambda: batch_of(0)}[kind]()
        jb = jax_batch(tb)
    assert tb.nbytes == jcatalog._leaf_nbytes(jb) > 0


def _both_runtimes(tmp_path, limit, host_limit, async_write):
    jconf.set_active_conf(jconf.RapidsConf({
        "spark.rapids.memory.host.spillStorageSize": str(host_limit),
        "spark.rapids.memory.spillDirectory": str(tmp_path / "jax"),
        "spark.rapids.tpu.spill.asyncWrite": str(async_write).lower()}))
    jmem.reset_buffer_catalog()
    jmem.reset_memory_budget(limit)
    reset_buffer_catalog(host_limit=host_limit,
                         spill_dir=str(tmp_path / "torch"),
                         async_write=async_write)
    reset_memory_budget(limit)


def _outcome(fn):
    """fn()'s result, or the name of the OOM it raised."""
    try:
        return fn()
    except (jmem.TpuRetryOOM, TpuRetryOOM) as e:
        return type(e).__name__


@pytest.mark.parametrize("async_write", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_tiers_match_the_reference_under_the_same_budget(tmp_path, seed,
                                                         async_write):
    """The same adds, acquires and releases under the same budget and
    host limit leave every handle on the same tier in both packages, and
    an acquire that cannot unspill raises in both. With the background
    writer, both drain it before an acquire, so that the budget each
    unspill sees does not depend on thread timing."""
    rng = np.random.default_rng(seed)
    _both_runtimes(tmp_path, 48 * 1024, 24 * 1024, async_write)
    try:
        jlive, tlive, seen = [], [], set()
        for step in range(24):
            n = int(rng.integers(50, 700))
            prio = int(rng.choice([tmem.ACTIVE_BATCHING_PRIORITY,
                                   tmem.ACTIVE_ON_DECK_PRIORITY]))
            tb = batch_of(n, step) if rng.random() < 0.7 \
                else _string_batch(n, step)
            jlive.append(jmem.SpillableBatch.from_batch(jax_batch(tb),
                                                        prio))
            tlive.append(SpillableBatch.from_batch(tb, prio))
            op = rng.random()
            if op < 0.3 and len(tlive) > 1:
                i = int(rng.integers(0, len(tlive) - 1))
                jlive.pop(i).close()
                tlive.pop(i).close()
            elif op < 0.5:
                # an entry the JAX catalog can promote: on the device, or
                # with room for it (an unspill whose reservation must
                # spill can lose its host leaves to the disk pass there;
                # test_unspill_under_host_pressure covers the port)
                room = jmem.memory_budget().limit - jmem.memory_budget().used
                ok = [k for k, s in enumerate(jlive)
                      if jmem.buffer_catalog().tier_of(s._handle).name
                      == "DEVICE" or s.size_bytes() <= room]
                if not ok:
                    continue
                i = ok[int(rng.integers(0, len(ok)))]
                jmem.buffer_catalog().drain_writeback()
                buffer_catalog().drain_writeback()
                jb = _outcome(jlive[i].get_batch)
                tb2 = _outcome(tlive[i].get_batch)
                if isinstance(tb2, str):
                    assert tb2 == jb
                else:
                    assert tb2.to_pylist() == [tuple(r)
                                               for r in jb.to_pylist()]
                    jlive[i].release()
                    tlive[i].release()
            jt_tiers = [jmem.buffer_catalog().tier_of(s._handle).name
                        for s in jlive]
            tt_tiers = [buffer_catalog().tier_of(s._handle).name
                        for s in tlive]
            assert tt_tiers == jt_tiers, step
            seen |= set(tt_tiers)
        assert seen == {"DEVICE", "HOST", "DISK"}
        assert memory_budget().used == jmem.memory_budget().used
        for s in jlive + tlive:
            s.close()
        assert buffer_catalog().num_entries() == 0
    finally:
        jmem.reset_buffer_catalog()
        jmem.reset_memory_budget()
        jconf.set_active_conf(jconf.RapidsConf())


@pytest.mark.parametrize("async_write", [False, True])
def test_unspill_under_host_pressure(tmp_path, async_write):
    """An unspill whose reservation spills others past the host limit
    keeps its own host copy: the batch comes back whole."""
    cat = reset_buffer_catalog(host_limit=10000, spill_dir=str(tmp_path),
                               async_write=async_write)
    reset_memory_budget(10000)
    a = SpillableBatch.from_batch(batch_of(200, 0))   # 4,612 bytes each
    b = SpillableBatch.from_batch(batch_of(200, 1))
    cat.synchronous_spill(None)
    cat.drain_writeback()
    c = SpillableBatch.from_batch(batch_of(200, 2))
    d = SpillableBatch.from_batch(batch_of(200, 3))
    assert cat.tier_of(a._handle) == StorageTier.HOST
    # the promotion must spill c, and a keeps its host copy meanwhile;
    # with the writer, the budget frees only when c's copy lands, so the
    # first attempt raises (the retry lane waits the writer out)
    if async_write:
        with pytest.raises(TpuRetryOOM):
            a.get_batch()
        cat.drain_writeback()
    got = a.get_batch()
    assert got.to_pydict()["a"] == list(range(200))
    a.release()
    cat.drain_writeback()
    assert [cat.tier_of(s._handle) for s in (a, b, c, d)] == [
        StorageTier.DEVICE, StorageTier.DISK, StorageTier.HOST,
        StorageTier.DEVICE]
    for s in (a, b, c, d):
        s.close()
    assert cat.num_entries() == 0


@pytest.mark.parametrize("n,ooms", [(11, 2), (40, 3), (7, 1), (100, 4)])
def test_split_row_counts_match_the_reference(n, ooms):
    jmem.register_task(1)
    tb = batch_of(n)
    jmem.force_split_and_retry_oom(ooms)
    jrows = list(jmem.with_retry(jax_batch(tb), lambda b: b.num_rows_host,
                                 split_policy=jmem.split_in_half_by_rows))
    force_split_and_retry_oom(ooms)
    trows = list(with_retry(tb, lambda b: b.num_rows_host,
                            split_policy=split_in_half_by_rows))
    assert trows == jrows
    assert sum(trows) == n
    assert task_retry_counts() == jmem.task_retry_counts()


@pytest.mark.parametrize("inject", [("split", 1), ("split", 3),
                                    ("retry", 2)])
def test_speculative_step_under_injected_oom_matches_the_reference(inject):
    """q1's aggregate folds each batch into its running state under
    with_retry: a split batch's halves fold one after the other from the
    state the previous half left, and a retried step starts again from
    the state before it. Both packages, the same injection, the same
    groups (counts exact, sums to rtol 1e-9 against the reference and
    bench's oracle)."""
    import bench
    import test_torch_q1_slice as q1
    from spark_rapids_tpu.exec import aggregate as jagg
    from spark_rapids_tpu.exec import basic as jbasic
    from spark_rapids_tpu.expr import aggexprs as jaggexprs
    from spark_rapids_tpu.expr import core as jcore
    from spark_rapids_tpu_torch.exec import aggregate as tagg
    from spark_rapids_tpu_torch.exec import basic as tbasic
    from spark_rapids_tpu_torch.expr import aggexprs as taggexprs
    from spark_rapids_tpu_torch.expr import core as tcore
    rng = np.random.default_rng(0)
    n = q1.ROWS
    data = {"returnflag": rng.integers(0, 4, n, dtype=np.int32),
            "quantity": rng.integers(1, 51, n, dtype=np.int64),
            "extendedprice": rng.random(n) * 1000.0,
            "discount": rng.random(n) * 0.1}
    jb, jschema, tb, tschema = q1._batches(data)
    mode, count = inject
    reset_memory_budget(1 << 30)
    jmem.register_task(1)
    (jmem.force_split_and_retry_oom if mode == "split"
     else jmem.force_retry_oom)(count)
    jrows = q1._run_jax(q1._q1_plan(jbasic, jagg, jaggexprs, jcore, jb,
                                    jschema))
    (force_split_and_retry_oom if mode == "split"
     else force_retry_oom)(count)
    trows = q1._run_torch(q1._q1_plan(tbasic, tagg, taggexprs, tcore, tb,
                                      tschema))
    assert task_retry_counts() == jmem.task_retry_counts()
    assert task_retry_counts()[0 if mode == "retry" else 1] == count
    oracle = bench.numpy_oracle(data)
    assert sorted(r[0] for r in trows) == sorted(r[0] for r in jrows) \
        == sorted(oracle)
    for k, qty, dp, cnt in trows:
        assert (qty, cnt) == (oracle[k][0], oracle[k][2])
        assert dp == pytest.approx(oracle[k][1], rel=1e-9, abs=0)
    assert buffer_catalog().num_entries() == 0
