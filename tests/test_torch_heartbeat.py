"""The heartbeats (parallel/heartbeat.py) and their seams in the port,
against the JAX package's manager, on the CPU:

- one script of registrations, beats, expiries and purges gives the same
  peers, live and dead sets, blacklisted slots, recycled slots and
  health section in both packages;
- `install` wires the manager's dead-peer emit to
  exec/speculation_shield.on_peer_dead, which invalidates the dead
  peer's map outputs only when tpu.shuffle.deadPeerInvalidation.enabled;
- the executor plugin registers with its driver's manager, learns its
  peers and stops its endpoint thread at shutdown;
- TpuSession.health()["peers"] reads the installed manager.
"""

import threading
import time

import pytest

from spark_rapids_tpu.parallel import heartbeat as jheartbeat

from spark_rapids_tpu_torch.config import RapidsConf, set_active_conf
from spark_rapids_tpu_torch.exec import speculation_shield as shield
from spark_rapids_tpu_torch.parallel import heartbeat
from spark_rapids_tpu_torch.shuffle import manager as shuffle_manager


@pytest.fixture(autouse=True)
def _clean():
    heartbeat.install(None)
    shield.reset_shield()
    yield
    heartbeat.install(None)
    set_active_conf(RapidsConf())


def _script(mod):
    """Registrations, beats, an expiry and a purge against `mod`'s
    manager; returns what each step observed."""
    m = mod.HeartbeatManager(timeout_s=0.2, purge_timeout_s=0.8)
    seen = []
    seen.append([p.executor_id for p in m.register("e0")])
    seen.append(sorted(p.executor_id for p in m.register("e1")))
    seen.append(sorted(p.slot for p in m.register("e2")))
    seen.append(sorted(m.live_peers()))
    time.sleep(0.3)
    m.heartbeat("e0")
    seen.append(sorted(m.dead_peers()))
    seen.append(dict(m.blacklisted_slots()))
    seen.append(sorted(p.executor_id for p in m.heartbeat("e1")))
    seen.append(dict(m.blacklisted_slots()))          # e1 came back
    time.sleep(0.9)
    m.heartbeat("e0")
    health = m.health_section()                       # e1, e2 purged
    seen.append({k: health[k] for k in ("live", "dead", "purged",
                                        "blacklisted_slots")})
    seen.append([p.slot for p in m.register("e3")] + [
        m._peers["e3"].slot])                        # a recycled slot
    seen.append(sorted(m.live_peers()))
    return seen


def test_the_manager_matches_jax_step_by_step():
    assert _script(heartbeat) == _script(jheartbeat)


def _dead_peer(enabled):
    """A peer expires under a manager installed with the conf's gate;
    returns the executors whose outputs were invalidated."""
    calls = []
    set_active_conf(RapidsConf({
        "spark.rapids.tpu.shuffle.deadPeerInvalidation.enabled":
            str(enabled).lower()}))
    mgr = shuffle_manager.shuffle_manager()
    real = mgr.invalidate_peer_outputs
    mgr.invalidate_peer_outputs = lambda e: (calls.append(e), real(e))[1]
    try:
        hb = heartbeat.HeartbeatManager(timeout_s=0.03)
        heartbeat.install(hb)
        assert hb.on_peer_dead is shield.on_peer_dead
        hb.register("exec-1")
        time.sleep(0.06)
        assert hb.dead_peers() == ["exec-1"]
        assert hb.dead_peers() == ["exec-1"]          # one transition
        assert hb.blacklisted_slots() == {"exec-1": 0}
    finally:
        del mgr.invalidate_peer_outputs
    return calls


def test_expiry_invalidates_map_outputs_only_when_the_gate_is_on():
    assert _dead_peer(True) == ["exec-1"]
    assert _dead_peer(False) == []
    # a replaced manager is unwired, and an uninstall leaves no manager
    first = heartbeat.HeartbeatManager()
    heartbeat.install(first)
    heartbeat.install(heartbeat.HeartbeatManager())
    assert first.on_peer_dead is None
    heartbeat.install(None)
    assert heartbeat.active_manager() is None
    assert heartbeat.health_section()["enabled"] is False


def test_a_failing_hook_does_not_kill_the_poller():
    hb = heartbeat.HeartbeatManager(timeout_s=0.01)
    hb.on_peer_dead = lambda e: 1 / 0
    hb.register("x")
    time.sleep(0.03)
    assert hb.dead_peers() == ["x"]


def test_the_executor_plugin_beats_to_its_driver(monkeypatch):
    from spark_rapids_tpu_torch import plugin
    driver = plugin.TpuDriverPlugin().init()
    assert isinstance(driver.heartbeat_manager, heartbeat.HeartbeatManager)
    # the endpoint alone (init() validates a card the CPU lacks)
    ex0 = plugin.TpuExecutorPlugin(driver=driver, executor_id="exec-0")
    ex1 = plugin.TpuExecutorPlugin(driver=driver, executor_id="exec-1")
    monkeypatch.setattr(heartbeat.HeartbeatEndpoint, "__init__",
                        _fast_endpoint(heartbeat.HeartbeatEndpoint.__init__))
    ex0._init_heartbeats()
    ex1._init_heartbeats()
    try:
        assert ex1.peers == ["exec-0"]
        deadline = time.monotonic() + 5
        while "exec-1" not in ex0.peers and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ex0.peers == ["exec-1"]
        assert sorted(driver.heartbeat_manager.live_peers()) == [
            "exec-0", "exec-1"]
    finally:
        for ex in (ex0, ex1):
            ex.heartbeat_endpoint.stop()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("heartbeat-")]
    lone = plugin.TpuExecutorPlugin()
    lone._init_heartbeats()
    assert lone.heartbeat_endpoint is None


def _fast_endpoint(init):
    def fast(self, manager, executor_id, interval_s=1.0, on_new_peer=None):
        init(self, manager, executor_id, 0.01, on_new_peer)
    return fast


def test_session_health_reads_the_installed_manager():
    from spark_rapids_tpu_torch.api.session import TpuSession
    sess = TpuSession(device="cpu")
    assert sess.health()["peers"]["enabled"] is False
    hb = heartbeat.HeartbeatManager(timeout_s=10)
    heartbeat.install(hb)
    hb.register("exec-7")
    peers = sess.health()["peers"]
    assert peers == {"enabled": True, "live": ["exec-7"], "dead": [],
                     "purged": 0, "blacklisted_slots": {}}
    assert peers == jheartbeat.HeartbeatManager(timeout_s=10) \
        .health_section() | {"live": ["exec-7"]}
