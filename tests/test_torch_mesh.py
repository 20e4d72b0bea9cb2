"""The device mesh (parallel/mesh.py), its session and planner seams and
the multi-process bootstrap (parallel/multihost.py) in the port, on the
CPU:

- a Mesh is an ordered grid of torch devices with named axes; a mesh
  repeats a device freely but never mixes device types; device_mesh
  gives n CPU shards or the first n cards, and fewer cards raise;
- TpuSession(device="cpu", mesh_devices=4) plans a grouped aggregate as
  partial -> ShuffleExchangeExec -> final and an equi-join over two
  ShuffleExchangeExecs, and the rows, their order and the plan's shape
  equal the JAX package's on 4 of conftest's virtual devices; a CPU
  session refuses a CUDA mesh; planExchange=false keeps the host plan;
- the history capsule records the mesh's shard count;
- DeviceManager.initialize(mesh_axes=...) builds the data-axis mesh,
  where the JAX package's branch raises (ROADMAP C.5);
- multihost: the single-process no-op, the (dcn, data) grid, fake
  multi-host groupings, a ragged topology refused, and a two-process gloo
  bootstrap through initialize_distributed.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JSession

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.parallel import mesh as tmesh
from spark_rapids_tpu_torch.parallel import multihost

from test_torch_jax_ref import jax_aliases, one_torch_thread

N = 4
ROOT = Path(__file__).resolve().parents[1]
WORDS = ["alpha", "bravo", "charlie", "delta", None]


@pytest.fixture(scope="module", autouse=True)
def _env():
    from spark_rapids_tpu.parallel.mesh import set_active_mesh as jset
    with jax_aliases(), one_torch_thread():
        yield
    tmesh.set_active_mesh(None)
    jset(None)


class _FakeDev:
    def __init__(self, pid, i):
        self.process_index = pid
        self.id = i


def test_mesh_grid_axes_and_identity():
    m = tmesh.Mesh(["cpu"] * N)
    assert m.shape == {"data": N} and m.devices.size == N
    assert m.shard_devices == (torch.device("cpu"),) * N
    assert tmesh.mesh_axis_size(m) == N and m.device_type == "cpu"
    assert m == tmesh.device_mesh(N, device="cpu")
    assert m != tmesh.Mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="axis names"):
        tmesh.Mesh(["cpu"] * 2, ("dcn", "data"))
    with pytest.raises(ValueError, match="one type"):
        tmesh.Mesh(["cpu", "cuda:0"])
    assert tmesh.device_mesh(device="cpu").shape == {"data": 1}


def test_device_mesh_on_the_card_takes_the_first_n_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = tmesh.device_mesh(2)
    assert m.shard_devices == (torch.device("cuda", 0),
                               torch.device("cuda", 1))
    assert tmesh.device_mesh().devices.size == 2
    with pytest.raises(RuntimeError, match="need 4 devices, have 2"):
        tmesh.device_mesh(4)
    # a session on the card asks for the same mesh
    with pytest.raises(RuntimeError, match="need 4 devices"):
        TpuSession(mesh_devices=4)


def test_a_session_refuses_a_mesh_of_another_device_type():
    with pytest.raises(ValueError, match="cuda mesh in a cpu session"):
        TpuSession(device="cpu", mesh=tmesh.Mesh(["cuda:0"] * N))
    sess = TpuSession(device="cpu", mesh_devices=N)
    assert sess.mesh.shard_devices == (torch.device("cpu"),) * N
    assert tmesh.active_mesh() is sess.mesh
    TpuSession(device="cpu")
    assert tmesh.active_mesh() is None


def _frames(sess, t, lines, refs):
    lschema = t.Schema((t.StructField("k", t.LONG),
                        t.StructField("v", t.DOUBLE),
                        t.StructField("s", t.STRING)))
    rschema = t.Schema((t.StructField("k", t.LONG),
                        t.StructField("w", t.STRING)))
    return (sess.from_pydict(lines, lschema, batch_rows=128),
            sess.from_pydict(refs, rschema))


def _data():
    rng = np.random.default_rng(7)
    lines = {"k": rng.integers(0, 30, 400).tolist(),
             "v": rng.random(400).tolist(),
             "s": [WORDS[i] for i in rng.integers(0, 5, 400)]}
    refs = {"k": list(range(25)), "w": [f"w{i}" for i in range(25)]}
    return lines, refs


def _classes(node):
    out = {type(node).__name__}
    for c in node.children:
        out |= _classes(c)
    return out


def test_planned_mesh_join_and_aggregate_match_jax():
    conf = {"spark.rapids.sql.broadcastSizeThreshold": "-1"}
    lines, refs = _data()
    out = {}
    for label, sess, t, F in (
            ("jax", JSession(conf, mesh_devices=N), jt, JF),
            ("port", TpuSession(conf, device="cpu", mesh_devices=N), tt,
             TF)):
        left, right = _frames(sess, t, lines, refs)
        joined = left.join(right, on="k")
        agg = joined.group_by("w", "s").agg((F.sum(F.col("v")), "sv"),
                                            (F.count(), "c"))
        out[label] = (joined.collect(), agg.collect(), agg._exec())
    jj, ja, jplan = out["jax"]
    tj, ta, tplan = out["port"]
    assert tj == jj                     # the shards' join rows in order
    assert [r[:2] + r[3:] for r in ta] == [r[:2] + r[3:] for r in ja]
    np.testing.assert_allclose([r[2] for r in ta], [r[2] for r in ja],
                               rtol=1e-12)
    classes = _classes(tplan)
    assert {"ShuffleExchangeExec", "ShuffledHashJoinExec"} <= classes
    assert "HostShuffleExchangeExec" not in classes
    assert _classes(jplan) >= {"ShuffleExchangeExec", "ShuffledHashJoinExec"}


def test_plan_exchange_off_keeps_the_host_plan_and_history_counts_shards(
        tmp_path):
    from spark_rapids_tpu_torch.obs import history
    lines, refs = _data()
    conf = {"spark.rapids.sql.broadcastSizeThreshold": "-1",
            "spark.rapids.sql.shuffle.partitions": "3",
            "spark.rapids.tpu.history.enabled": "true",
            "spark.rapids.tpu.history.dir": str(tmp_path)}
    plain = TpuSession(dict(conf, **{
        "spark.rapids.tpu.shuffle.planExchange": "false"}), device="cpu",
        mesh_devices=N)
    left, right = _frames(plain, tt, lines, refs)
    df = left.join(right, on="k").group_by("w").agg((TF.count(), "c"))
    classes = _classes(df._exec())
    assert "ShuffleExchangeExec" not in classes
    assert "HostShuffleExchangeExec" in classes
    rows = sorted(df.collect())
    meshed = TpuSession(conf, device="cpu", mesh_devices=N)
    left, right = _frames(meshed, tt, lines, refs)
    assert sorted(left.join(right, on="k").group_by("w").agg(
        (TF.count(), "c")).collect()) == rows
    from tools import history_report
    caps = history_report.read_capsules(str(tmp_path))
    assert [c["mesh_devices"] for c in caps] == [N, N]
    history.reset_history()


def test_device_manager_builds_the_data_axis_mesh_the_jax_branch_lacks():
    from spark_rapids_tpu.memory.device_manager import \
        DeviceManager as JManager
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    # the JAX package imports a build_mesh its parallel/mesh.py lacks
    with pytest.raises(ImportError, match="build_mesh"):
        JManager().initialize(mesh_axes={"data": 2})
    m = DeviceManager().initialize(mesh_axes={"data": N}, device="cpu")
    assert m.mesh == tmesh.device_mesh(N, device="cpu")
    m.shutdown()
    assert m.mesh is None


def test_single_process_initialize_is_a_noop(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize_distributed() is False
    assert multihost.initialize_distributed("localhost:1", 1, 0) is False
    assert not torch.distributed.is_initialized()


def test_query_mesh_grids_and_fake_hosts():
    mesh = multihost.build_query_mesh([torch.device("cpu")] * N)
    assert mesh.axis_names == (multihost.DCN_AXIS, multihost.ICI_AXIS)
    assert multihost.dcn_axis_size(mesh) == 1
    assert multihost.ici_axis_size(mesh) == N
    assert tmesh.mesh_axis_size(mesh) == N       # planning keys on ici
    devs = [_FakeDev(pid, i) for pid in (1, 0, 2) for i in range(4)]
    groups = multihost.group_devices_by_host(devs)
    assert [g[0].process_index for g in groups] == [0, 1, 2]
    assert multihost.topology_shape(devs) == (3, 4)
    with pytest.raises(RuntimeError, match="ragged"):
        multihost.topology_shape([_FakeDev(0, 0), _FakeDev(0, 1),
                                  _FakeDev(1, 0)])


_WORKER = r"""
import sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from spark_rapids_tpu_torch.parallel import multihost
assert multihost.initialize_distributed(device="cpu")
rank, world = dist.get_rank(), dist.get_world_size()
send = torch.arange(world, dtype=torch.int64) + 10 * rank
recv = torch.empty(world, dtype=torch.int64)
dist.all_to_all_single(recv, send)
assert recv.tolist() == [10 * s + rank for s in range(world)], recv
assert multihost.initialize_distributed(device="cpu")   # idempotent
dist.destroy_process_group()
print("RANK", rank, "OK")
"""


def test_two_process_gloo_bootstrap_through_initialize_distributed():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}",
                   NUM_PROCESSES="2", PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(ROOT)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err
        assert f"RANK {rank} OK" in out
