"""obs/dispatch.py, the port's dispatch ledger over its own sites (the
kernel wrappers and the execs' batch steps). Port-only (the JAX
package's ledger wraps jax.jit): a program key is (label, log2 shape
bucket, device type); an exec scope's calls are the batches the exec
yielded; a kernel site records one call per counted launch, its first
call's ns (the library's build) apart from the later calls', nothing
when its body raises; builds emit `program_compile` and, past the storm
threshold, one `recompile_storm`; donated bytes are 0; a disabled
ledger records nothing. On the card, each kernel label's calls equal
its wrapper's `launches` (marked `cuda`, skipped here: the CPU tensors
take the plain versions, which launch nothing)."""

import pytest
import torch

from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.exec.base import TpuMetric
from spark_rapids_tpu_torch.obs import dispatch, events
from spark_rapids_tpu_torch.types import DOUBLE, LONG, Schema, StructField

from test_torch_jax_ref import one_torch_thread
from test_torch_planner import active_confs

SCHEMA = Schema([StructField("k", LONG), StructField("v", DOUBLE)])


@pytest.fixture(autouse=True)
def _fresh():
    with active_confs(), one_torch_thread():
        dispatch.reset_dispatch_ledger()
        yield
        dispatch.reset_dispatch_ledger()
        events.reset_event_bus()


def test_shape_buckets():
    assert dispatch.shape_bucket((0, 1, 2, 3, 1000, 1024)) == \
        (0, 1, 2, 4, 1024, 1024)


def test_exec_scopes_count_the_batches_each_exec_yields(tmp_path):
    sess = TpuSession({"spark.rapids.tpu.eventLog.enabled": "true",
                       "spark.rapids.tpu.eventLog.dir": str(tmp_path)},
                      device="cpu")
    df = sess.from_pydict({"k": list(range(40)), "v": [1.0] * 40}, SCHEMA,
                          batch_rows=10)
    assert len(df.filter(F.col("k") >= F.lit(5)).collect()) == 35
    closes = {}
    for r in events.read_events(events.active_bus()):
        if r["kind"] == "op_close":
            closes[r["op"]] = closes.get(r["op"], 0) + r["batches"]
    assert dispatch.calls_by_label("exec") == \
        {k: v for k, v in closes.items() if v}
    progs = dispatch.programs()
    assert all(p["device_type"] == "cpu" and p["kind"] == "exec"
               and p["donated_bytes"] == 0 for p in progs)
    c = dispatch.counters()
    assert c["dispatches"] == sum(closes.values()) and c["traces"] == 0
    h = dispatch.health_section()
    assert h["enabled"] and len(h["top_programs"]) <= 5


def test_kernel_sites_record_launches_and_builds(tmp_path):
    bus = events.enable(str(tmp_path))
    num, comp = TpuMetric("numDispatches"), TpuMetric("compileTimeNs")
    with dispatch.metric_scope(num, comp):
        for i in range(3):
            with dispatch.kernel_site("dma_row_gather", (1000, 6),
                                      torch.device("cpu")) as site:
                if i == 0:
                    dispatch.note_build("row_gather.cu", 2_000_000)
                site.count()
        with dispatch.kernel_site("dict_gather", (8, 1), "cpu"):
            pass  # no launch: nothing recorded
        with pytest.raises(RuntimeError):
            with dispatch.kernel_site("dict_gather", (8, 1), "cpu") as s:
                s.count()
                raise RuntimeError("dict_gather kernel launch failed")
    assert dispatch.calls_by_label("kernel") == {"dma_row_gather": 3}
    (p,) = dispatch.programs()
    assert p["bucket"] == [1024, 8] and p["builds"] == 1
    assert p["build_ns"] == 2_000_000 and p["calls"] == 3
    assert p["first_ns"] > 0 and p["later_ns"] > 0
    assert num.value == 3 and comp.value == 2_000_000
    kinds = [r["kind"] for r in events.read_events(bus)]
    assert kinds.count("program_compile") == 1


def test_storms_and_the_off_switch():
    led = dispatch.configure(RapidsConf(
        {"spark.rapids.tpu.dispatch.storm.traces": "2"}))
    got = [led.note_build("fused_scan_agg", 1) for _ in range(4)]
    assert got[:2] == [None, None] and got[3] is None  # one per window
    assert got[2] == ("recompile_storm", {
        "label": "fused_scan_agg", "traces_in_window": 3,
        "window_ms": led.storm_window_ms, "threshold": 2})
    assert dispatch.counters()["storms"] == 1
    assert dispatch.configure(RapidsConf(
        {"spark.rapids.tpu.dispatch.ledger.enabled": "false"})) is None
    with dispatch.kernel_site("dma_row_gather", (4,), "cpu") as s:
        s.count()
    assert dispatch.counters()["dispatches"] == 0
    assert dispatch.health_section() == dict(
        enabled=False, **dispatch.counters())


@pytest.mark.cuda
def test_kernel_calls_equal_launches_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("the kernel sites launch only on a CUDA card")
    import chip_smoke as cs
    from spark_rapids_tpu_torch.ops import row_gather
    wrappers = cs.kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    mat = torch.arange(4096, dtype=torch.int32, device="cuda").view(-1, 4)
    idx = torch.arange(1024, dtype=torch.int32, device="cuda")
    for _ in range(3):
        row_gather.dma_row_gather(mat, idx)
    assert dispatch.calls_by_label("kernel") == {
        k: w.launches for k, w in wrappers.items() if w.launches}
