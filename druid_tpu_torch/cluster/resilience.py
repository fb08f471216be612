"""Broker-side data-plane fault tolerance (the port's own copy of the
reference package's `cluster/resilience.py`).

Three mechanisms, one policy surface:

  * Per-server CIRCUIT BREAKERS — consecutive failures (connection errors,
    capacity sheds, timeouts) OPEN the circuit; replica selection skips an
    open server, so a sick replica stops being rediscovered by paying its
    full timeout on every query. After a jittered cooldown the breaker
    goes HALF_OPEN and lets exactly ONE probe query through; success
    closes it, failure re-opens with a fresh cooldown. When EVERY replica
    of a segment is open, selection falls back to an open server anyway
    (tagged as a probe) — a guaranteed MissingSegmentsError is worse than
    one fail-fast attempt.
  * HEDGED REQUESTS — when a scatter wave's straggler exceeds a hedge
    delay derived from the view's per-server latency EWMA (the broker
    feeds its broker/node span times back into the view), the pending
    segment set is speculatively re-issued on one other replica. The
    first complete response wins; the loser's response is dropped whole
    (AggregatePartials over a fused segment set cannot be split, so
    claim-or-drop is what makes "a hedge-won segment is never
    double-merged" a structural invariant, not a hope) and its in-flight
    work is cancelled through the same remote-cancel hook the query
    token uses.
  * GRACEFUL DEGRADATION — context `allowPartialResults: true` lets a
    query whose replicas are exhausted (or whose deadline is nearly
    spent) return a typed PartialResult carrying a missingSegments
    report instead of a 500/504 — exactly once, never silently: the
    report rides the result object, the HTTP response context header,
    and the SQL surface.

Reference analogs: RetryQueryRunner + QueryContexts.allowPartialResults
(the reference reports unserved segments in the response context), and
the hedged-request/breaker vocabulary of The Tail at Scale. Every knob
lives in ResiliencePolicy so a test can force each mechanism
deterministically.

Beyond the reference, CircuitRegistry keeps each server's cumulative
failure count (`failures_by_server`): a caller can tell a failover that
hid a fault on one node from a clean run.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from druid_tpu_torch.utils.emitter import Monitor


@dataclass(frozen=True)
class ResiliencePolicy:
    """Every fault-tolerance knob of the broker's data plane."""

    # ---- circuit breakers ----------------------------------------------
    #: master switch for per-server breakers
    circuit_enabled: bool = True
    #: consecutive failures (errors/sheds/timeouts) that OPEN a circuit
    circuit_failure_threshold: int = 3
    #: base OPEN → HALF_OPEN cooldown; the actual cooldown is
    #: decorrelated-jittered in [base, cap] so a fleet of brokers does not
    #: re-probe a recovering server in lockstep
    circuit_cooldown_s: float = 5.0
    circuit_cooldown_cap_s: float = 30.0

    # ---- hedged requests -----------------------------------------------
    #: master switch (context {"hedge": false} opts a query out)
    hedge_enabled: bool = True
    #: hedge delay = max(min_delay, multiplier * per-server latency EWMA);
    #: with no EWMA yet (first contact) the min delay alone applies
    hedge_latency_multiplier: float = 3.0
    hedge_min_delay_ms: float = 50.0
    #: speculative re-issues allowed per query (not per wave) — hedging is
    #: a tail-latency tool, not a second scatter
    hedge_max_per_query: int = 4

    # ---- partial results -----------------------------------------------
    #: with allowPartialResults set, degrade to a partial instead of
    #: starting another retry round once the remaining deadline fraction
    #: drops below this (a round that cannot finish only converts a
    #: partial into a 504)
    partial_deadline_fraction: float = 0.1

    # ---- latency EWMA ---------------------------------------------------
    #: smoothing for the view's per-server latency estimate
    latency_alpha: float = 0.2


def decorrelated_jitter(rng: random.Random, base_s: float, prev_s: float,
                        cap_s: float) -> float:
    """Decorrelated jitter (the AWS backoff variant): next sleep is
    uniform in [base, prev * 3], capped. Feeding each sleep back as
    `prev` makes successive sleeps spread out instead of re-synchronizing
    every client onto the same retry instant — the failure mode of both a
    429 storm's Retry-After and a fleet's half-open probes."""
    base_s = max(0.0, min(base_s, cap_s))
    hi = max(base_s, min(cap_s, prev_s * 3.0))
    return base_s + rng.random() * (hi - base_s)


# ---------------------------------------------------------------------------
# Circuit breakers
# ---------------------------------------------------------------------------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """One server's breaker. Not thread-safe on its own — the registry's
    lock covers every transition."""

    def __init__(self, policy: ResiliencePolicy, rng: random.Random,
                 clock=time.monotonic):
        self.policy = policy
        self._rng = rng
        self._clock = clock
        self.state = CLOSED
        self.consecutive_failures = 0
        self._cooldown_until = 0.0
        self._prev_cooldown_s = policy.circuit_cooldown_s

    def cooled_down(self) -> bool:
        return self._clock() >= self._cooldown_until

    def trip(self) -> None:
        self.state = OPEN
        self._prev_cooldown_s = decorrelated_jitter(
            self._rng, self.policy.circuit_cooldown_s,
            self._prev_cooldown_s, self.policy.circuit_cooldown_cap_s)
        self._cooldown_until = self._clock() + self._prev_cooldown_s

    def on_success(self) -> None:
        self.state = CLOSED
        self.consecutive_failures = 0
        self._prev_cooldown_s = self.policy.circuit_cooldown_s

    def on_failure(self) -> bool:
        """Record one failure; True when this one tripped the circuit."""
        self.consecutive_failures += 1
        if self.state == HALF_OPEN:
            # the probe failed: straight back to OPEN, fresh cooldown
            self.trip()
            return True
        if self.state == CLOSED and self.consecutive_failures >= \
                self.policy.circuit_failure_threshold:
            self.trip()
            return True
        return False


class CircuitRegistry:
    """Per-server breakers + the selection/outcome surface the broker and
    ReplicaSet.pick talk to. All state transitions run under one lock;
    the seeded rng keeps cooldown jitter deterministic in tests."""

    def __init__(self, policy: Optional[ResiliencePolicy] = None,
                 seed: int = 0, clock=time.monotonic):
        self.policy = policy or ResiliencePolicy()
        self._rng = random.Random(seed)
        self._clock = clock
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._failures: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.trips = 0
        self.probes = 0

    def _breaker(self, server: str) -> CircuitBreaker:
        b = self._breakers.get(server)
        if b is None:
            b = self._breakers[server] = CircuitBreaker(
                self.policy, self._rng, self._clock)
        return b

    # ---- selection surface (ReplicaSet.pick) ---------------------------
    def closed(self, server: str) -> bool:
        """Selection may route here freely (CLOSED, or never seen)."""
        if not self.policy.circuit_enabled:
            return True
        with self._lock:
            b = self._breakers.get(server)
            return b is None or b.state == CLOSED

    def probe_candidate(self, server: str) -> bool:
        """OPEN with its cooldown elapsed — the half-open transition is
        waiting for exactly one query to ride through."""
        with self._lock:
            b = self._breakers.get(server)
            return b is not None and b.state == OPEN and b.cooled_down()

    def begin_probe(self, server: str) -> None:
        """Selection chose an open server: mark the half-open probe (one
        in flight — further selections skip it until it resolves)."""
        with self._lock:
            b = self._breakers.get(server)
            if b is not None and b.state != CLOSED:
                b.state = HALF_OPEN
                self.probes += 1

    # ---- outcome surface (broker scatter) ------------------------------
    def on_success(self, server: str) -> None:
        with self._lock:
            b = self._breakers.get(server)
            if b is not None:
                b.on_success()

    def on_failure(self, server: str) -> None:
        with self._lock:
            self._failures[server] = self._failures.get(server, 0) + 1
            if self._breaker(server).on_failure():
                self.trips += 1

    # ---- observation ----------------------------------------------------
    def state_of(self, server: str) -> str:
        with self._lock:
            b = self._breakers.get(server)
            return CLOSED if b is None else b.state

    def failures_by_server(self) -> Dict[str, int]:
        """{server: failed calls since this registry was made}, whatever
        the breaker state (a success does not reset it)."""
        with self._lock:
            return dict(self._failures)

    def open_count(self) -> int:
        with self._lock:
            return sum(1 for b in self._breakers.values()
                       if b.state != CLOSED)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"open": sum(1 for b in self._breakers.values()
                                if b.state != CLOSED),
                    "trips": self.trips, "probes": self.probes}


# ---------------------------------------------------------------------------
# Typed partial results
# ---------------------------------------------------------------------------

class PartialResult(list):
    """Result rows that are knowingly incomplete: a list (every existing
    merge/serialization caller keeps working) that TYPES the degradation
    and carries the missing-segment report — a partial can never be
    mistaken for a full result by anyone who checks, and the HTTP/SQL
    surfaces stamp the report onto the response exactly once."""

    def __init__(self, rows: Sequence, missing_segments: Sequence[str]):
        super().__init__(rows)
        # deduped: UNION arms (and hedge retries) may report one segment
        # several times — the report counts holes, not sightings
        self.missing_segments: List[str] = sorted(
            {str(s) for s in missing_segments})

    def response_context(self) -> dict:
        """The X-Druid-Response-Context payload (the reference broker
        reports unserved segments the same way)."""
        return {"partial": True, "missingSegments": self.missing_segments}


def missing_segments_of(rows) -> Optional[List[str]]:
    """The missing-segment report of a (possibly partial) result — None
    for a complete result. Duck-typed so shaped SQL rows re-wrapped as
    PartialResult and broker-native rows answer identically."""
    return getattr(rows, "missing_segments", None)


def allows_partial(query) -> bool:
    """Context `allowPartialResults` — the degradation opt-in (never the
    default: silent partials are the one unforgivable failure mode)."""
    return bool(query.context_map.get("allowPartialResults"))


def hedging_enabled(policy: ResiliencePolicy, query) -> bool:
    """Hedging is policy-on by default; a query opts out with
    {"hedge": false} (e.g. side-effectful extensions)."""
    v = query.context_map.get("hedge")
    return policy.hedge_enabled and (v is None or bool(v))


# ---------------------------------------------------------------------------
# Stats + monitor
# ---------------------------------------------------------------------------

class ResilienceStats:
    """Broker-wide counters for the fault-tolerance layer (cumulative;
    the monitor emits per-period deltas for the countable events and the
    live open-circuit gauge)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.hedges_issued = 0
        self.hedges_won = 0
        self.hedges_cancelled = 0
        self.partial_queries = 0
        self.partial_missing_segments = 0

    def note_hedge_issued(self, n: int = 1) -> None:
        with self._lock:
            self.hedges_issued += n

    def note_hedge_won(self) -> None:
        with self._lock:
            self.hedges_won += 1

    def note_hedge_cancelled(self) -> None:
        with self._lock:
            self.hedges_cancelled += 1

    def note_partial(self, missing: int) -> None:
        with self._lock:
            self.partial_queries += 1
            self.partial_missing_segments += missing

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"hedges_issued": self.hedges_issued,
                    "hedges_won": self.hedges_won,
                    "hedges_cancelled": self.hedges_cancelled,
                    "partial_queries": self.partial_queries,
                    "partial_missing_segments":
                        self.partial_missing_segments}


class BrokerResilience:
    """The broker's fault-tolerance state bundle: one policy, one circuit
    registry, one stats block. Owned by the Broker; the view's replica
    selection reads the registry through it."""

    def __init__(self, policy: Optional[ResiliencePolicy] = None,
                 seed: int = 0):
        self.policy = policy or ResiliencePolicy()
        self.circuits = CircuitRegistry(self.policy, seed=seed)
        self.stats = ResilienceStats()

    def hedge_delay_s(self, view, server: str) -> float:
        """How long a wave waits on `server` before hedging its pending
        segments: the per-server latency EWMA (fed back from broker/node
        call times) scaled by the policy multiplier, floored at the
        policy minimum."""
        ewma = view.latency_ms(server)
        delay_ms = self.policy.hedge_min_delay_ms if ewma is None else max(
            self.policy.hedge_min_delay_ms,
            self.policy.hedge_latency_multiplier * ewma)
        return delay_ms / 1000.0

    def deadline_nearly_spent(self, deadline, total_ms: Optional[float]
                              ) -> bool:
        """True when another retry round is pointless: the remaining
        budget is below the policy fraction of the query's total."""
        remaining = deadline.remaining_ms()
        if remaining is None or total_ms is None:
            return False
        return remaining < total_ms * self.policy.partial_deadline_fraction


class ResilienceMetricsMonitor(Monitor):
    """broker/circuit/* + query/hedge/* + query/partial/* per tick."""

    def __init__(self, resilience: BrokerResilience):
        self.resilience = resilience
        self._last: Dict[str, int] = {}

    def _delta(self, key: str, value: int) -> int:
        d = value - self._last.get(key, 0)
        self._last[key] = value
        return d

    def do_monitor(self, emitter):
        circuits = self.resilience.circuits.snapshot()
        stats = self.resilience.stats.snapshot()
        emitter.metric("broker/circuit/open", circuits["open"])
        emitter.metric("broker/circuit/trips",
                       self._delta("trips", circuits["trips"]))
        emitter.metric("broker/circuit/probes",
                       self._delta("probes", circuits["probes"]))
        emitter.metric("query/hedge/issued",
                       self._delta("issued", stats["hedges_issued"]))
        emitter.metric("query/hedge/won",
                       self._delta("won", stats["hedges_won"]))
        emitter.metric("query/hedge/cancelled",
                       self._delta("cancelled", stats["hedges_cancelled"]))
        emitter.metric("query/partial/missingSegments",
                       self._delta("missing",
                                   stats["partial_missing_segments"]))
