"""Lease-based leader latch with fencing terms.

The port's copy of the reference package's `coordination/latch.py`: host
code over the port's modules.

Reference analogs:
  discovery/DruidLeaderSelector.java        — the latch SPI: isLeader,
    localTerm, registerListener(becomeLeader/stopBeingLeader)
  curator/discovery/CuratorDruidLeaderSelector.java — the Curator
    LeaderLatch-backed impl; here the latch is a lease row in the SQL
    metadata store (no ZK in this stack), which doubles as the fencing
    authority: every ownership change mints a new monotonically increasing
    term, and metadata writes carrying an old term are rejected
    (MetadataStore.check_fence) even if the deposed leader still runs.

Safety model (TiLT-style: control plane off the query hot path):
  - liveness: a standby's heartbeat takes the lease over once it EXPIRES,
    so failover is bounded by lease_ms + one heartbeat period;
  - safety: leadership is advisory — is_leader() self-fences on the LOCAL
    clock the moment the last successful renewal is older than the lease,
    and the metadata store's term check is the hard backstop for the
    clock-skew/zombie window in between.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

# StaleTermError is re-exported
from druid_tpu_torch.cluster.metadata import (MetadataStore,  # noqa: F401
                                              StaleTermError)
from druid_tpu_torch.utils.emitter import ServiceEmitter

log = logging.getLogger(__name__)


class NotLeaderError(RuntimeError):
    """An operation that only the leader may perform reached a non-leader;
    carries the current leader's advertised location for redirect."""

    def __init__(self, message: str, leader_url: Optional[str] = None):
        super().__init__(message)
        self.leader_url = leader_url


@dataclass(frozen=True)
class LeaderLease:
    """One service's lease row: who leads, under which fencing term,
    until when (store clock), and where to reach them (advertised meta)."""
    service: str
    holder: str
    term: int
    expires_ms: int
    meta: Optional[dict] = None

    @property
    def url(self) -> Optional[str]:
        return (self.meta or {}).get("url")


class LeaseStore:
    """Pluggable lease backend (the Curator role). All methods may raise
    (store down / partition); callers treat that as a failed heartbeat."""

    def try_acquire(self, service: str, holder: str, now_ms: int,
                    lease_ms: int, meta: Optional[dict] = None
                    ) -> Optional[LeaderLease]:
        raise NotImplementedError

    def read(self, service: str) -> Optional[LeaderLease]:
        raise NotImplementedError

    def release(self, service: str, holder: str) -> bool:
        raise NotImplementedError


class MetadataLeaseStore(LeaseStore):
    """Lease rows in the SQL metadata store — the same transactional
    authority that fences writes, so term checks and lease state can never
    disagree."""

    def __init__(self, metadata: MetadataStore):
        self.metadata = metadata

    def try_acquire(self, service, holder, now_ms, lease_ms, meta=None):
        got = self.metadata.try_acquire_lease(service, holder, now_ms,
                                              lease_ms, meta)
        if got is None:
            return None
        term, expires = got
        return LeaderLease(service, holder, term, expires, meta)

    def read(self, service):
        row = self.metadata.read_lease(service)
        if row is None:
            return None
        return LeaderLease(service, row["holder"], row["term"],
                           row["expiresMs"], row["meta"])

    def release(self, service, holder):
        return self.metadata.release_lease(service, holder)


class LeaderParticipant:
    """One node's handle on a leader latch (DruidLeaderSelector analog).

    tick() is one heartbeat: acquire-or-renew the lease and fire
    become/stop listeners on transitions. start() drives tick() from a
    daemon thread at lease_ms/3; tests drive tick() manually against an
    injected clock. is_leader() self-fences on the local clock between
    ticks — an expired local lease reads as non-leader immediately, no
    store round-trip."""

    def __init__(self, store: LeaseStore, service: str, node_id: str,
                 lease_ms: int = 3_000, meta: Optional[dict] = None,
                 clock: Optional[Callable[[], int]] = None,
                 emitter: Optional[ServiceEmitter] = None):
        self.store = store
        self.service = service
        self.node_id = node_id
        self.lease_ms = int(lease_ms)
        self.meta = dict(meta or {})
        self.clock = clock or (lambda: int(time.time() * 1000))
        self.emitter = emitter
        self.transitions = 0           # becomeLeader + stopBeingLeader count
        self._lease: Optional[LeaderLease] = None
        self._last_renew_ms: Optional[int] = None
        self._leading = False
        self._dead = False             # chaos kill: simulated process death
        self.drop_heartbeats = False   # chaos: ticks run, renewals are lost
        self._listeners: List[tuple] = []
        self._lock = threading.RLock()
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- listener SPI (DruidLeaderSelector.Listener) -------------------
    def register_listener(self, on_become: Optional[Callable[[int], None]] = None,
                          on_stop: Optional[Callable[[], None]] = None) -> None:
        self._listeners.append((on_become, on_stop))

    # ---- state ----------------------------------------------------------
    @property
    def term(self) -> int:
        """Local term (DruidLeaderSelector.localTerm): the fencing token
        of the currently/most recently held lease; -1 before first win."""
        with self._lock:
            return self._lease.term if self._lease is not None else -1

    def fence(self) -> Optional[tuple]:
        """(service, term, holder) for fenced metadata writes — None until
        this node has ever won the latch."""
        with self._lock:
            if self._lease is None:
                return None
            return (self.service, self._lease.term, self.node_id)

    def is_leader(self) -> bool:
        """Self-fencing read: leading AND the last successful renewal is
        younger than the lease, by the LOCAL clock. Needs no store call,
        so duty loops can gate on it per-cycle for free."""
        with self._lock:
            if self._dead or not self._leading:
                return False
            if self._last_renew_ms is None:
                return False
            return self.clock() < self._last_renew_ms + self.lease_ms

    def lease_age_ms(self) -> Optional[int]:
        """Time since the last successful renewal (None if never renewed)
        — the coordination/lease/ageMs observable; age past lease_ms on a
        leader means it is about to (or already did) self-fence."""
        with self._lock:
            if self._last_renew_ms is None:
                return None
            return max(0, self.clock() - self._last_renew_ms)

    def transition_count(self) -> int:
        """Locked read of the become/stop transition counter — monitor
        ticks run on the scheduler thread while the heartbeat thread
        writes it."""
        with self._lock:
            return self.transitions

    # ---- one heartbeat ---------------------------------------------------
    def tick(self) -> bool:
        """Acquire-or-renew once; returns is_leader() after the attempt.
        A failed renewal (store unreachable, heartbeat dropped, lease taken)
        steps down as soon as the local lease expires."""
        with self._lock:
            if self._dead:
                return False
            now = self.clock()
            # pre-renew age: how stale the lease had grown by this beat —
            # the coordination/lease/ageMs observable (0 is uninteresting;
            # a value near lease_ms means renewals are being missed)
            age = None if self._last_renew_ms is None \
                else max(0, now - self._last_renew_ms)
            got: Optional[LeaderLease] = None
            if not self.drop_heartbeats:
                try:
                    got = self.store.try_acquire(
                        self.service, self.node_id, now, self.lease_ms,
                        self.meta)
                except Exception:
                    got = None        # partitioned from the lease store
                    log.warning("lease store unreachable for [%s] from "
                                "[%s]; treating as lost heartbeat",
                                self.service, self.node_id, exc_info=True)
            if got is not None:
                self._lease = got
                self._last_renew_ms = now
                if not self._leading:
                    self._leading = True
                    self._fire_transition("become", got.term)
            elif self._leading and \
                    now >= (self._last_renew_ms or 0) + self.lease_ms:
                # could not renew for a whole lease: someone may hold it now
                self._leading = False
                self._fire_transition("stop", self.term)
            if self.emitter is not None and age is not None:
                self.emitter.metric(
                    "coordination/lease/ageMs", age,
                    service=self.service, node=self.node_id,
                    leader=self._leading)
            return self.is_leader()

    def _fire_transition(self, event: str, term: int) -> None:
        # called under _lock; listener exceptions must not kill heartbeats
        self.transitions += 1
        log.info("[%s] %s %s leader (term %d)", self.service, self.node_id,
                 "became" if event == "become" else "stopped being", term)
        if self.emitter is not None:
            self.emitter.metric("coordination/leader/transitions",
                                self.transitions, service=self.service,
                                node=self.node_id, event=event, term=term)
        for on_become, on_stop in list(self._listeners):
            fn = on_become if event == "become" else on_stop
            if fn is None:
                continue
            try:
                fn(term) if event == "become" else fn()
            except Exception:
                log.exception("leader listener failed (%s)", event)

    # ---- lifecycle -------------------------------------------------------
    def start(self, period_s: Optional[float] = None) -> "LeaderParticipant":
        """Spawn the heartbeat thread (default period lease_ms/3 — two
        missable beats before the lease lapses)."""
        if self._thread is not None:
            return self
        period = period_s if period_s is not None else self.lease_ms / 3000.0
        with self._lock:
            self._dead = False        # restart after stop() rejoins
        self._stop_event.clear()

        def loop():
            self.tick()
            while not self._stop_event.wait(period):
                self.tick()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"leader-{self.service}-{self.node_id}")
        self._thread.start()
        return self

    def stop(self, release: bool = True) -> None:
        """Graceful shutdown: leave the latch (no more heartbeats, manual
        ticks no-op until start() rejoins), fire stop listeners, and (by
        default) release the lease so a standby takes over on its next
        heartbeat instead of waiting out the expiry."""
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._lock:
            was_leading = self._leading
            self._leading = False
            self._dead = True
            if was_leading:
                self._fire_transition("stop", self.term)
        if release and was_leading:
            try:
                self.store.release(self.service, self.node_id)
            except Exception:
                # store down: expiry handles it
                log.debug("lease release for [%s] failed; standbys take "
                          "over on expiry", self.service, exc_info=True)

    def kill(self) -> None:
        """Simulated process death (chaos): heartbeats halt WITHOUT
        releasing the lease — exactly what a crashed leader leaves behind.
        No stop listeners fire; a dead process runs nothing."""
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._lock:
            self._dead = True
            self._leading = False


class LeaderMonitor:
    """MonitorScheduler-compatible monitor: emits the participant's
    transition count and lease age each monitoring period (the
    coordination observables)."""

    def __init__(self, participant: LeaderParticipant):
        self.participant = participant

    def do_monitor(self, emitter) -> None:
        p = self.participant
        emitter.metric("coordination/leader/transitions",
                       p.transition_count(),
                       service=p.service, node=p.node_id,
                       leader=p.is_leader())
        age = p.lease_age_ms()
        if age is not None:
            emitter.metric("coordination/lease/ageMs", age,
                           service=p.service, node=p.node_id,
                           leader=p.is_leader())
