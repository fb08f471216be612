"""Fault-injection harness for the coordination subsystem.

The port's copy of the reference package's `coordination/chaos.py`: host
code over the port's modules.

The harness builds LeaderParticipants whose lease-store traffic routes
through per-node fault gates, then injects the three canonical control-
plane faults:

  kill_leader()      — process death: heartbeats halt, lease NOT released
  drop_heartbeats(n) — the node runs but its renewals are lost in flight
  partition(n)       — the node is cut off from the lease store entirely
                       (every store op raises), the registry-partition case

Tests drive time with ManualClock + tick_all() so failover bounds are
asserted in LEASE INTERVALS, not wall seconds — deterministic under any
scheduler. await_leader() returns how many intervals promotion took,
which is the bounded-failover assertion.

Reference analog: none 1:1 — Druid leans on Curator's TestingCluster for
ZK chaos (server/.../CuratorDruidLeaderSelectorTest); this plays that
role for the lease latch.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from druid_tpu_torch.coordination.latch import (LeaderParticipant, LeaseStore,
                                                MetadataLeaseStore)


class ManualClock:
    """Deterministic ms clock shared by every participant and the store
    checks (tests advance it explicitly)."""

    def __init__(self, start_ms: int = 1_000_000):
        self._now = int(start_ms)
        self._lock = threading.Lock()

    def __call__(self) -> int:
        with self._lock:
            return self._now

    def advance(self, ms: int) -> int:
        with self._lock:
            self._now += int(ms)
            return self._now


class PartitionedError(ConnectionError):
    """The injected fault: this node cannot reach the lease store."""


class _FaultGateStore(LeaseStore):
    """Per-node view of the shared store; consults the harness's fault
    table on every call so partitions can be injected/healed live."""

    def __init__(self, inner: LeaseStore, node_id: str,
                 partitioned: Dict[str, bool]):
        self.inner = inner
        self.node_id = node_id
        self._partitioned = partitioned

    def _check(self):
        if self._partitioned.get(self.node_id):
            raise PartitionedError(
                f"[{self.node_id}] partitioned from the lease store")

    def try_acquire(self, service, holder, now_ms, lease_ms, meta=None):
        self._check()
        return self.inner.try_acquire(service, holder, now_ms, lease_ms,
                                      meta)

    def read(self, service):
        self._check()
        return self.inner.read(service)

    def release(self, service, holder):
        self._check()
        return self.inner.release(service, holder)


class ChaosHarness:
    """Builds and faults a fleet of latch participants over one store."""

    def __init__(self, store: LeaseStore, service: str,
                 lease_ms: int = 1_000,
                 clock: Optional[ManualClock] = None):
        self.store = store
        self.service = service
        self.lease_ms = int(lease_ms)
        self.clock = clock or ManualClock()
        self.participants: List[LeaderParticipant] = []
        self._partitioned: Dict[str, bool] = {}

    @classmethod
    def over_metadata(cls, metadata, service: str, lease_ms: int = 1_000,
                      clock: Optional[ManualClock] = None) -> "ChaosHarness":
        return cls(MetadataLeaseStore(metadata), service, lease_ms, clock)

    def participant(self, node_id: str, meta: Optional[dict] = None,
                    emitter=None) -> LeaderParticipant:
        gated = _FaultGateStore(self.store, node_id, self._partitioned)
        p = LeaderParticipant(gated, self.service, node_id,
                              lease_ms=self.lease_ms, meta=meta,
                              clock=self.clock, emitter=emitter)
        self.participants.append(p)
        return p

    # ---- fault injection -------------------------------------------------
    def leader(self) -> Optional[LeaderParticipant]:
        for p in self.participants:
            if p.is_leader():
                return p
        return None

    def kill_leader(self) -> LeaderParticipant:
        p = self.leader()
        if p is None:
            raise AssertionError("no leader to kill")
        p.kill()
        return p

    def kill(self, node_id: str) -> None:
        self._by_id(node_id).kill()

    def drop_heartbeats(self, node_id: str) -> None:
        self._by_id(node_id).drop_heartbeats = True

    def partition(self, node_id: str) -> None:
        self._partitioned[node_id] = True

    def heal(self, node_id: str) -> None:
        self._partitioned.pop(node_id, None)
        self._by_id(node_id).drop_heartbeats = False

    def _by_id(self, node_id: str) -> LeaderParticipant:
        for p in self.participants:
            if p.node_id == node_id:
                return p
        raise KeyError(node_id)

    # ---- deterministic driving -------------------------------------------
    def tick_all(self) -> Optional[LeaderParticipant]:
        """One heartbeat round for every live participant; returns the
        leader after the round (None mid-election)."""
        for p in self.participants:
            p.tick()
        return self.leader()

    def await_leader(self, max_intervals: int = 5,
                     ticks_per_interval: int = 3,
                     exclude: Optional[LeaderParticipant] = None) -> tuple:
        """Advance time + heartbeats until some participant OTHER than
        `exclude` leads, failing after `max_intervals` lease intervals —
        the bounded-failover assertion (exclude the deposed leader for
        heartbeat-drop/partition faults, where it legitimately stays
        leader until its lease lapses). Returns (leader,
        intervals_elapsed) with intervals a float in lease units."""
        step = self.lease_ms // ticks_per_interval or 1
        for i in range(max_intervals * ticks_per_interval + 1):
            self.tick_all()
            for p in self.participants:
                if p.is_leader() and p is not exclude:
                    return p, i * step / self.lease_ms
            self.clock.advance(step)
        raise AssertionError(
            f"no leader for [{self.service}] within {max_intervals} lease "
            f"intervals")
