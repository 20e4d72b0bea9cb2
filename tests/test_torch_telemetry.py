"""obs/telemetry.py: the series names are the JAX package's (the `ici.*`
series read the mesh lane's counters). Port-only: a sample's
per-owner device bytes sum to its device total, the sampler thread
samples at its interval and is gone after reset_telemetry(), the SLO
section reports per-priority percentiles of finished governed queries,
and configure() keeps or replaces the registry as the JAX package's
does."""

import threading
import time

import pytest

from spark_rapids_tpu.obs import telemetry as jtelemetry
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.memory import SpillableBatch, reset_buffer_catalog
from spark_rapids_tpu_torch.obs import telemetry
from spark_rapids_tpu_torch.types import DOUBLE, LONG, Schema, StructField

from test_torch_jax_ref import one_torch_thread
from test_torch_planner import active_confs

SCHEMA = Schema([StructField("k", LONG), StructField("v", DOUBLE)])


@pytest.fixture(autouse=True)
def _reset():
    with active_confs(), one_torch_thread():
        telemetry.reset_telemetry()
        yield
        telemetry.reset_telemetry()


def _samplers():
    return [t for t in threading.enumerate()
            if t.name == "telemetry-sampler"]


def test_series_match_jax():
    assert list(telemetry.SERIES) == list(jtelemetry.SERIES)
    s = telemetry.collect_sample()
    assert set(telemetry.SERIES) <= set(s)
    from spark_rapids_tpu_torch.shuffle import manager as shuffle_manager
    ici = shuffle_manager.ici_counters()
    assert (s["ici.rounds"], s["ici.bytes"], s["ici.fallbacks"]) == (
        ici["rounds"], ici["bytes"], ici["fallbacks"])


def test_owner_attribution_sums_to_the_totals():
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    reset_buffer_catalog()
    sb = SpillableBatch.from_batch(ColumnarBatch.from_pydict(
        {"k": [1, 2, 3], "v": [1.0, 2.0, 3.0]}, SCHEMA, device="cpu"))
    try:
        s = telemetry.collect_sample()
        assert s["hbm.device_bytes"] > 0
        assert sum(s["hbm_by_owner"]["device"].values()) == \
            s["hbm.device_bytes"]
        assert set(s["hbm_by_owner"]["device"]) == {"unowned"}
    finally:
        sb.close()
        reset_buffer_catalog()


def test_the_sampler_runs_and_stops_on_reset():
    reg = telemetry.configure(RapidsConf(
        {"spark.rapids.tpu.telemetry.enabled": "true",
         "spark.rapids.tpu.telemetry.intervalMs": "20",
         "spark.rapids.tpu.telemetry.historySize": "4"}))
    assert len(_samplers()) == 1
    deadline = time.monotonic() + 10
    while reg.samples_taken < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert reg.samples_taken >= 3
    assert len(reg.series("queries.active")) <= 4
    assert telemetry.configure(RapidsConf()) is reg  # unset: kept
    h = telemetry.health_section()
    assert h["enabled"] and h["interval_ms"] == 20 and h["last"]
    telemetry.add("exchange.write_bytes", 5)
    assert telemetry.counters()["exchange_write_bytes"] == 5
    telemetry.reset_telemetry()
    assert _samplers() == []
    assert telemetry.health_section() == {"enabled": False}


def test_slo_percentiles_of_governed_queries():
    conf = {"spark.rapids.tpu.telemetry.enabled": "true",
            "spark.rapids.tpu.telemetry.intervalMs": "1000"}
    sess = TpuSession(conf, device="cpu")
    df = sess.from_pydict({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]}, SCHEMA)
    for _ in range(3):
        assert sorted(df.group_by("k").agg(F.sum("v")).collect()) == \
            [(1, 4.0), (2, 2.0)]
    slo = sess.health()["slo"]
    row = slo["classes"]["interactive"]
    assert slo["enabled"] and row["queries"] == 3 and row["window"] == 3
    assert 0 < row["p50_ns"] <= row["p95_ns"] <= row["p99_ns"]
    telemetry.reset_telemetry()
    assert _samplers() == []
