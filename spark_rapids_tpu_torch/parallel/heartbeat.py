"""Heartbeat-based peer discovery and liveness — the counterpart of
spark_rapids_tpu/parallel/heartbeat.py (the reference's
RapidsShuffleHeartbeatManager on the driver and
RapidsShuffleHeartbeatEndpoint on each executor, which bootstrap peer
identity through the driver before any shuffle data moves,
Plugin.scala:417-437).

The mesh exchange needs every participant alive before a step runs,
the problem the reference's heartbeats solve for UCX. The manager is the
driver-side registry; each executor runs an endpoint thread that
heartbeats on an interval. A peer missing `timeout` seconds of beats is
declared dead, and `live_peers()` feeds the exchange planner (a dead peer
means: fail fast and let task retry reschedule, the reference's recovery
model: no elastic re-sharding).
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Callable, Dict, List, Optional


class PeerInfo:
    __slots__ = ("executor_id", "host", "slot", "registered_at",
                 "last_beat")

    def __init__(self, executor_id: str, host: str, slot: int, now: float):
        self.executor_id = executor_id
        self.host = host
        self.slot = slot
        self.registered_at = now
        self.last_beat = now


class HeartbeatManager:
    """Driver-side registry (reference RapidsShuffleHeartbeatManager).

    Bounded: a peer silent past `purge_timeout_s`
    (default 6x the dead timeout) is PURGED — its registry entry dropped
    and its slot recycled for the next registration — so a long-lived
    driver under executor churn cannot grow the registry without bound.
    A purged executor's next beat registers cleanly (first-beat ==
    registration, per the `_register_locked` contract)."""

    def __init__(self, timeout_s: float = 10.0,
                 purge_timeout_s: Optional[float] = None):
        self.timeout_s = timeout_s
        self.purge_timeout_s = (purge_timeout_s if purge_timeout_s
                                is not None else 6.0 * timeout_s)
        self._lock = threading.Lock()
        self._peers: Dict[str, PeerInfo] = {}
        self._next_slot = 0
        #: slots of purged peers, recycled lowest-first
        self._free_slots: List[int] = []
        #: peers already reported dead (one peer_dead event per
        #: live->dead transition; a returning beat re-arms it)
        self._reported_dead: set = set()
        #: reported-dead peers' slots: withheld from the
        #: exchange/planner surfaces until the peer re-registers (the
        #: returning beat clears the entry) or is purged (the peer is
        #: forgotten entirely and its slot recycles, the
        #: bounded-registry contract)
        self._blacklist: Dict[str, int] = {}
        #: peers purged over this manager's lifetime (health surface)
        self._purged = 0
        #: dead-peer transition hook: called OUTSIDE the
        #: lock, once per live->dead transition, with the executor id —
        #: parallel.heartbeat.install wires it to the speculation
        #: shield's map-output invalidation. None = no glue (the
        #: default for a bare test manager).
        self.on_peer_dead: Optional[Callable[[str], None]] = None

    def _purge_locked(self, now: float,
                      keep: Optional[str] = None) -> List[tuple]:
        """Drop peers silent past purge_timeout_s — caller holds
        self._lock. Their slots go back on the free list. Returns
        (executor_id, silent_s) for purged peers whose death was never
        reported: the caller emits their one peer_dead event OUTSIDE
        the lock, so a peer that crosses the purge threshold between
        dead_peers() polls does not vanish without its transition.
        `keep` is the executor currently beating/registering — it just
        proved alive and is about to be refreshed; purging it here
        would emit a peer_dead for a live peer."""
        unreported = []
        doomed = [e for e, p in self._peers.items()
                  if now - p.last_beat > self.purge_timeout_s
                  and e != keep]
        for executor_id in doomed:
            peer = self._peers.pop(executor_id)
            heapq.heappush(self._free_slots, peer.slot)
            if executor_id not in self._reported_dead:
                unreported.append((executor_id, now - peer.last_beat))
            self._reported_dead.discard(executor_id)
            # the purge forgets the peer entirely: its blacklist entry
            # goes with it (the recycled slot belongs to nobody)
            self._blacklist.pop(executor_id, None)
            self._purged += 1
        return unreported

    def _emit_dead(self, fresh) -> None:
        """One peer_dead event per live->dead transition — emitted
        outside the lock, then the on_peer_dead hook (the
        speculation shield invalidates the dead peer's map outputs
        here). A hook failure must not kill the poller that happened
        to notice the transition."""
        for executor_id, silent_s in fresh:
            from ..obs import events as obs_events
            obs_events.emit("peer_dead", executor_id=executor_id,
                            silent_ms=int(silent_s * 1000),
                            timeout_ms=int(self.timeout_s * 1000))
            hook = self.on_peer_dead
            if hook is not None:
                try:
                    hook(executor_id)
                except Exception:  # noqa: BLE001 — see docstring
                    import logging
                    logging.getLogger(
                        "spark_rapids_tpu_torch.parallel").warning(
                        "on_peer_dead hook failed for %s", executor_id,
                        exc_info=True)

    def _register_locked(self, executor_id: str,
                         host: str = "local") -> List[PeerInfo]:
        """Registration body — caller holds self._lock. Extracted so
        heartbeat() can register an unknown executor WITHOUT re-taking
        the non-reentrant lock (heartbeat() used to
        call register() while already holding it, so an unregistered
        executor's first beat deadlocked forever)."""
        now = time.monotonic()
        if executor_id not in self._peers:
            if self._free_slots:
                slot = heapq.heappop(self._free_slots)
            else:
                slot = self._next_slot
                self._next_slot += 1
            self._peers[executor_id] = PeerInfo(
                executor_id, host, slot, now)
        else:
            self._peers[executor_id].last_beat = now
        self._reported_dead.discard(executor_id)
        # the returning peer re-registers: its slot comes off the
        # blacklist (the dead-peer quarantine ends here)
        self._blacklist.pop(executor_id, None)
        return [p for p in self._peers.values()
                if p.executor_id != executor_id]

    def register(self, executor_id: str, host: str = "local") -> List[PeerInfo]:
        """Executor start: returns all currently-known peers (the
        reference's RegisterExecutor reply carries peer identities so
        clients can connect eagerly)."""
        with self._lock:
            purged = self._purge_locked(time.monotonic(),
                                        keep=executor_id)
            peers = self._register_locked(executor_id, host)
        self._emit_dead(purged)
        return peers

    def heartbeat(self, executor_id: str) -> List[PeerInfo]:
        """Periodic beat: refreshes liveness, returns peers registered
        since this executor last heard (delta updates, like the
        reference's ExecutorHeartbeat reply)."""
        now = time.monotonic()
        with self._lock:
            purged = self._purge_locked(now, keep=executor_id)
            me = self._peers.get(executor_id)
            if me is None:
                peers = self._register_locked(executor_id)
            else:
                prev = me.last_beat
                me.last_beat = now
                self._reported_dead.discard(executor_id)
                self._blacklist.pop(executor_id, None)
                peers = [p for p in self._peers.values()
                         if p.executor_id != executor_id
                         and p.registered_at > prev]
        self._emit_dead(purged)
        return peers

    def live_peers(self) -> List[str]:
        now = time.monotonic()
        with self._lock:
            purged = self._purge_locked(now)
            live = [p.executor_id for p in self._peers.values()
                    if now - p.last_beat <= self.timeout_s]
        self._emit_dead(purged)
        return live

    def dead_peers(self) -> List[str]:
        """Peers past the dead timeout but not yet purged (a purged
        peer is forgotten entirely — neither live nor dead; its
        transition event, if still unreported, fires on the purge)."""
        now = time.monotonic()
        with self._lock:
            purged = self._purge_locked(now)
            dead = [p.executor_id for p in self._peers.values()
                    if now - p.last_beat > self.timeout_s]
            fresh = [(e, now - self._peers[e].last_beat) for e in dead
                     if e not in self._reported_dead]
            self._reported_dead.update(e for e, _ in fresh)
            # a freshly dead peer's slot is blacklisted: withheld from
            # every planning surface until it re-registers (or the
            # purge forgets the peer and recycles the slot)
            for e, _ in fresh:
                self._blacklist[e] = self._peers[e].slot
        # liveness is observable: one peer_dead
        # event per live->dead transition — emitted outside the lock
        self._emit_dead(purged + fresh)
        return dead

    def blacklisted_slots(self) -> Dict[str, int]:
        """executor_id -> slot for peers currently dead-and-quarantined
       : withheld from planning until re-registration."""
        with self._lock:
            return dict(self._blacklist)

    def health_section(self) -> Dict[str, object]:
        """The TpuSession.health()["peers"] payload: live/dead peer
        ids, lifetime purge count and the blacklisted slots. Polls the
        registry (so stale transitions report), like dead_peers()."""
        now = time.monotonic()
        with self._lock:
            purged = self._purge_locked(now)
            live, dead = [], []
            for p in self._peers.values():
                (dead if now - p.last_beat > self.timeout_s
                 else live).append(p.executor_id)
            out = {"enabled": True, "live": sorted(live),
                   "dead": sorted(dead), "purged": self._purged,
                   "blacklisted_slots": dict(self._blacklist)}
        self._emit_dead(purged)
        return out


# ---------------------------------------------------------------------------
# process-wide manager registry: the session health surface
# and the dead-peer -> map-output-invalidation glue need ONE nominated
# manager; a bare test manager stays un-wired unless installed.
# ---------------------------------------------------------------------------

_ACTIVE: Optional[HeartbeatManager] = None
_active_lock = threading.Lock()


def install(manager: Optional[HeartbeatManager]) -> None:
    """Nominate `manager` as the process's heartbeat registry (None =
    clear, test isolation). Wires its on_peer_dead hook to the
    speculation shield's map-output invalidation — the conf gate
    (`shuffle.deadPeerInvalidation.enabled`) is consulted inside the
    hook at transition time, so installing is unconditional."""
    global _ACTIVE
    with _active_lock:
        prev, _ACTIVE = _ACTIVE, manager
    if prev is not None and prev is not manager:
        prev.on_peer_dead = None
    if manager is not None:
        from ..exec import speculation_shield
        manager.on_peer_dead = speculation_shield.on_peer_dead


def active_manager() -> Optional[HeartbeatManager]:
    return _ACTIVE


def health_section() -> Dict[str, object]:
    """`TpuSession.health()["peers"]`: the installed manager's liveness
    surface, or the explicit disabled shape when no manager runs (the
    default single-process session)."""
    mgr = _ACTIVE
    if mgr is None:
        return {"enabled": False, "live": [], "dead": [], "purged": 0,
                "blacklisted_slots": {}}
    return mgr.health_section()


class HeartbeatEndpoint:
    """Executor-side beat thread (reference
    RapidsShuffleHeartbeatEndpoint with its scheduled executor)."""

    def __init__(self, manager: HeartbeatManager, executor_id: str,
                 interval_s: float = 1.0,
                 on_new_peer: Optional[Callable[[PeerInfo], None]] = None):
        self.manager = manager
        self.executor_id = executor_id
        self.interval_s = interval_s
        self.on_new_peer = on_new_peer
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        for p in self.manager.register(self.executor_id):
            if self.on_new_peer:
                self.on_new_peer(p)
        # contract: ok thread-adopt — engine-global liveness daemon: it
        # beats the peer table and emits peer_dead transitions, none of
        # which belong to a query; there is no context to adopt
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"heartbeat-{self.executor_id}")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            for p in self.manager.heartbeat(self.executor_id):
                if self.on_new_peer:
                    self.on_new_peer(p)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
