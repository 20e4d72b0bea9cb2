"""obs/history.py, the query history capsules, on the CPU:

- one capsule per governed collect() (a failed query's too), with the
  JAX package's keys for the same query and the same keys in each
  counter family (`ici` the mesh lane's counters, no round for a query
  without a mesh, and `mesh_devices` 1); one plan shape, one fingerprint;
- the store rotates past history.maxBytes, keeps its file when a conf
  repeats it, and a conf that sets history.enabled=false tears it down;
- a failed write warns once and uninstalls the store;
- the JAX package's stdlib-only tools/history_report reads the port's
  capsules (read_capsules, aggregate, build_summary).
"""

import json
import logging
import os
import sys

import pytest

from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JSession
from spark_rapids_tpu.obs import history as jhistory
from spark_rapids_tpu.types import LONG as JLONG
from spark_rapids_tpu.types import Schema as JSchema
from spark_rapids_tpu.types import StructField as JField

from spark_rapids_tpu_torch import TpuSession, functions as F
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.obs import history
from spark_rapids_tpu_torch.types import LONG, Schema, StructField

from test_torch_jax_ref import jax_aliases, one_torch_thread
from test_torch_planner import active_confs

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import history_report  # noqa: E402

DATA = {"k": [i % 7 for i in range(300)], "v": list(range(300))}


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs(), one_torch_thread():
        yield
    history.reset_history()
    jhistory.reset_history()


@pytest.fixture(autouse=True)
def _fresh():
    history.reset_history()
    yield
    history.reset_history()


def _conf(directory, **extra):
    return dict({"spark.rapids.tpu.history.enabled": "true",
                 "spark.rapids.tpu.history.dir": str(directory)}, **extra)


def _port_df(sess):
    schema = Schema((StructField("k", LONG), StructField("v", LONG)))
    return sess.from_pydict(DATA, schema).group_by("k").agg(F.sum("v"))


def _capsules(directory):
    return history_report.read_capsules(str(directory))


def test_one_capsule_per_collect_with_the_jax_packages_keys(tmp_path):
    sess = TpuSession(_conf(tmp_path / "port"), device="cpu")
    df = _port_df(sess)
    rows = sorted(df.collect())
    df.collect()
    caps = _capsules(tmp_path / "port")
    assert len(caps) == 2 == history.active_store().records
    assert caps[0]["fingerprint"] == caps[1]["fingerprint"]
    assert caps[0]["ok"] and caps[0]["attempts"] == 1
    assert caps[0]["ici"]["rounds"] == caps[0]["ici"]["fallbacks"] == 0
    assert caps[0]["mesh_devices"] == 1
    assert sum(caps[0]["phases"].values()) == caps[0]["wall_ns"]

    jsess = JSession(_conf(tmp_path / "jax"))
    jschema = JSchema((JField("k", JLONG), JField("v", JLONG)))
    jdf = jsess.from_pydict(DATA, schema=jschema).group_by("k").agg(
        (JF.sum(JF.col("v")), "sum(v)"))
    assert sorted(jdf.collect()) == rows
    jcap = _capsules(tmp_path / "jax")[0]
    jhistory.reset_history()
    assert set(caps[0]) == set(jcap)
    for fam in ("shuffle", "upload", "dispatch", "workload", "encoded",
                "adaptive", "speculation"):
        assert isinstance(caps[0][fam], dict), fam
    for fam in ("adaptive", "speculation", "workload"):
        assert set(caps[0][fam]) == set(jcap[fam]), fam
    # the port's ici family adds the measure's host reads
    assert set(caps[0]["ici"]) == set(jcap["ici"]) | {"host_reads"}


def test_a_failed_query_writes_its_capsule(tmp_path):
    sess = TpuSession(_conf(tmp_path, **{
        "spark.rapids.tpu.test.faults":
            "device.dispatch:prob=1,seed=1,kind=device",
        "spark.rapids.tpu.task.maxAttempts": "2",
        "spark.rapids.tpu.task.retryBackoffMs": "1"}), device="cpu")
    from spark_rapids_tpu_torch import faults
    try:
        with pytest.raises(Exception):
            _port_df(sess).collect()
    finally:
        faults.install(None)
    (cap,) = _capsules(tmp_path)
    assert cap["ok"] is False and cap["attempts"] == 2


def test_rotation_and_reconfiguration(tmp_path):
    sess = TpuSession(_conf(tmp_path, **{
        "spark.rapids.tpu.history.maxBytes": "100"}), device="cpu")
    store = history.active_store()
    for _ in range(3):
        _port_df(sess).collect()
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 3 and store.records == 3
    assert all(len(open(tmp_path / n).readlines()) == 1 for n in names)
    assert len(_capsules(tmp_path)) == 3
    # the same settings keep the store; an explicit false tears it down
    assert history.configure(RapidsConf(_conf(tmp_path, **{
        "spark.rapids.tpu.history.maxBytes": "100"}))) is store
    assert history.configure(RapidsConf()) is store
    assert history.configure(RapidsConf(
        {"spark.rapids.tpu.history.enabled": "false"})) is None


def test_a_failed_write_warns_once_and_uninstalls(tmp_path, caplog):
    blocker = tmp_path / "file"
    blocker.write_text("")
    store = history.enable(str(blocker / "sub"))
    with caplog.at_level(logging.WARNING):
        store.append({"query": 1})
        store.append({"query": 2})
    warnings = [r for r in caplog.records
                if "query history disabled" in r.getMessage()]
    assert len(warnings) == 1
    assert history.active_store() is None and store.records == 0


def test_history_report_reads_the_ports_capsules(tmp_path):
    sess = TpuSession(_conf(tmp_path), device="cpu")
    for _ in range(2):
        _port_df(sess).collect()
    caps = _capsules(tmp_path)
    agg = history_report.aggregate(caps)
    (fp,) = agg
    assert fp == caps[0]["fingerprint"] and agg[fp]["count"] == 2
    assert agg[fp]["p50_wall_ns"] > 0
    summary = history_report.build_summary(str(tmp_path))
    json.dumps(summary)
