"""Deterministic fault-injection harness for the query DATA plane — the
peer of coordination/chaos.py (which faults the control plane's lease
store). Where that harness proves bounded leader failover, this one
proves the broker's fault-tolerance contract: under any injected data-node
fault, every query either returns EXACT results (bit-identical to the
fault-free oracle), a TYPED partial (allowPartialResults, with an accurate
missingSegments report), or a TYPED error — within its deadline, never a
hang, never a silently wrong answer.

Data-node clients wrap in seeded fault gates covering the canonical
data-plane failure modes:

  dead   — every call raises ConnectionError (process death / partition)
  slow   — fixed latency plus a seeded heavy tail (the straggler the
           hedging layer exists for)
  flap   — alternates reachable/unreachable every `flap_period` calls
           (a GC-thrashing or link-flapping server)
  error  — every call fails with a server error (the HTTP-500 storm)
  shed   — every call answers a capacity shed (the 429 storm)
  hang   — calls block until the query is CANCELLED on this node (the
           loser-cancellation path) or a hard cap elapses; the cap is
           what keeps the harness itself deterministic and hang-free

All randomness (heavy-tail draws) comes from per-node seeded rngs, so a
scenario replays identically. Reference analog: none 1:1 — the reference
leans on integration chaos (e.g. Druid's RetryQueryRunnerTest fakes
missing segments); this plays that role as a first-class harness.

The port's copy of the reference package's `cluster/chaos.py`, over the
port's broker, data nodes and executor. The harness takes the `device` its
nodes, broker and oracle run on (None: CUDA; the tests pass "cpu").
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from druid_tpu_torch.cluster.broker import Broker, MissingSegmentsError
from druid_tpu_torch.cluster.dataserver import RemoteQueryError
from druid_tpu_torch.cluster.resilience import ResiliencePolicy
from druid_tpu_torch.cluster.view import (DataNode, InventoryView,
                                          descriptor_for)
from druid_tpu_torch.server.querymanager import (QueryCapacityError,
                                                 QueryInterruptedError,
                                                 QueryTimeoutError)


class ChaosError(RuntimeError):
    """The injected server-error fault (the HTTP-500 class)."""


#: the error types the contract counts as TYPED — anything else escaping
#: the broker under chaos is a harness failure
TYPED_ERRORS = (QueryCapacityError, QueryTimeoutError,
                QueryInterruptedError, MissingSegmentsError,
                RemoteQueryError, ConnectionError, ChaosError)


@dataclass(frozen=True)
class FaultSpec:
    """One node's injected fault."""
    mode: str                       # dead|slow|flap|error|shed|hang
    delay_ms: float = 100.0         # slow: fixed latency
    heavy_tail_ms: float = 0.0      # slow: extra tail latency...
    tail_prob: float = 0.1          # ...drawn with this probability
    flap_period: int = 2            # flap: calls per up/down half-cycle
    retry_after_s: float = 0.05     # shed: the 429's drain estimate
    max_hang_s: float = 5.0         # hang: hard cap (determinism bound)

    def __post_init__(self):
        if self.mode not in ("dead", "slow", "flap", "error", "shed",
                             "hang"):
            raise ValueError(f"unknown fault mode {self.mode!r}")


class ChaosDataNode:
    """A data-node client behind a seeded fault gate. Exposes the same
    surface the broker and InventoryView touch (run_partials / run_rows /
    cancel / ping / segments / load_segment ...), so it registers into
    the view exactly like the node it wraps."""

    segment_replicatable = True

    def __init__(self, inner: DataNode, seed: int = 0):
        self.inner = inner
        self._rng = random.Random(seed)
        self._spec: Optional[FaultSpec] = None
        self._calls = 0
        self._lock = threading.Lock()
        #: qid → event set by cancel(); how a hang releases
        self._hang_cancels: Dict[str, threading.Event] = {}
        #: every cancel(qid) observed — the loser-cancellation witness
        self.cancel_calls: List[str] = []

    # ---- proxied identity ----------------------------------------------
    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def tier(self) -> str:
        return self.inner.tier

    @property
    def alive(self) -> bool:
        return self.inner.alive

    def ping(self) -> bool:
        with self._lock:
            spec = self._spec
        if spec is not None and spec.mode == "dead":
            return False
        return self.inner.ping()

    def segments(self):
        return self.inner.segments()

    def served_segment_ids(self):
        return self.inner.served_segment_ids()

    def served_descriptors(self):
        return self.inner.served_descriptors()

    def load_segment(self, segment, descriptor=None):
        return self.inner.load_segment(segment, descriptor)

    # ---- fault control ---------------------------------------------------
    def fault(self, spec: Optional[FaultSpec]) -> None:
        with self._lock:
            self._spec = spec
            self._calls = 0

    def heal(self) -> None:
        self.fault(None)

    # ---- the gate --------------------------------------------------------
    def _gate(self, query) -> None:
        """Applied before every inner call; raises or delays per spec.
        Deterministic: latency draws come from the node's seeded rng (the
        draw happens under the lock; the sleep does not)."""
        with self._lock:
            spec = self._spec
            n = self._calls
            self._calls += 1
            draw = self._rng.random() if spec is not None else 0.0
        if spec is None:
            return
        if spec.mode == "dead":
            raise ConnectionError(f"chaos: [{self.name}] is dead")
        if spec.mode == "flap" and (n // max(1, spec.flap_period)) % 2:
            raise ConnectionError(f"chaos: [{self.name}] is flapping")
        if spec.mode == "error":
            raise ChaosError(f"chaos: [{self.name}] error storm")
        if spec.mode == "shed":
            raise QueryCapacityError(
                f"chaos: [{self.name}] 429 storm",
                retry_after_s=spec.retry_after_s, server=self.name)
        if spec.mode == "slow":
            delay = spec.delay_ms
            if spec.heavy_tail_ms > 0 and draw < spec.tail_prob:
                delay += spec.heavy_tail_ms
            time.sleep(delay / 1000.0)
            return
        if spec.mode == "hang":
            qid = query.context_map.get("queryId") or ""
            with self._lock:
                ev = self._hang_cancels.setdefault(qid,
                                                   threading.Event())
            if ev.wait(spec.max_hang_s):
                # released by the broker's loser/abandon cancellation —
                # answer the way a cancelled node would
                raise QueryInterruptedError(
                    f"chaos: [{self.name}] hang cancelled")
            raise ConnectionError(
                f"chaos: [{self.name}] hang cap elapsed")

    # ---- query surface ---------------------------------------------------
    def run_partials(self, query, segment_ids, check=None):
        self._gate(query)
        if check is None:
            # remote clients (RemoteDataNodeClient) take no check kwarg —
            # forwarding None would TypeError the wrapped HTTP node
            return self.inner.run_partials(query, segment_ids)
        return self.inner.run_partials(query, segment_ids, check=check)

    def run_rows(self, query, segment_ids):
        self._gate(query)
        return self.inner.run_rows(query, segment_ids)

    def cancel(self, query_id: str) -> None:
        """The remote-cancel hook the broker fires at hedge losers and
        deadline-abandoned calls; releases a hanging gate and is recorded
        so tests can observe the cancellation."""
        with self._lock:
            self.cancel_calls.append(query_id)
            ev = self._hang_cancels.setdefault(query_id,
                                               threading.Event())
        ev.set()
        cancel = getattr(self.inner, "cancel", None)
        if cancel is not None:
            cancel(query_id)


@dataclass
class Outcome:
    """One classified query run: kind is 'exact' | 'partial' | 'error'."""
    kind: str
    rows: Optional[list]
    error: Optional[BaseException]
    elapsed_s: float
    missing: List[str] = field(default_factory=list)


class DataPlaneChaosHarness:
    """A broker over chaos-wrapped data nodes plus the fault-free oracle,
    with outcome classification — the scenario suite's one entry point.

    Segments spread round-robin at the given replication factor; every
    node wraps in a ChaosDataNode whose seed derives from the harness
    seed, so a scenario is replayable bit-for-bit."""

    def __init__(self, segments: Sequence, n_nodes: int = 3,
                 replication: int = 2, seed: int = 0,
                 policy: Optional[ResiliencePolicy] = None,
                 max_retries: int = 2, device=None):
        self.segments = list(segments)
        self.device = device
        self.view = InventoryView()
        self.nodes: Dict[str, ChaosDataNode] = {}
        for i in range(n_nodes):
            node = ChaosDataNode(DataNode(f"chaos{i}", device=device),
                                 seed=seed * 1000 + i)
            self.nodes[node.name] = node
            self.view.register(node)
        names = sorted(self.nodes)
        for i, s in enumerate(self.segments):
            for j in range(replication):
                node = self.nodes[names[(i + j) % n_nodes]]
                node.load_segment(s)
                self.view.announce(node.name, descriptor_for(s))
        self.broker = Broker(self.view, seed=seed, max_retries=max_retries,
                             resilience_policy=policy, device=device)
        self._by_id = {str(s.id): s for s in self.segments}

    # ---- fault control ---------------------------------------------------
    def fault(self, name: str, spec: FaultSpec) -> None:
        self.nodes[name].fault(spec)

    def heal(self, name: Optional[str] = None) -> None:
        for node in ([self.nodes[name]] if name else self.nodes.values()):
            node.heal()

    def stop(self) -> None:
        self.broker.stop()

    # ---- oracle + classification ----------------------------------------
    def oracle(self, query, exclude: Sequence[str] = ()) -> list:
        """Fault-free single-process execution over all segments (or all
        but `exclude` — the surviving set of a partial result)."""
        from druid_tpu_torch.engine.executor import QueryExecutor
        keep = [s for sid, s in self._by_id.items() if sid not in
                set(str(x) for x in exclude)]
        return QueryExecutor(keep, device=self.device).run(query)

    def run_classified(self, query) -> Outcome:
        """Run through the broker and classify: exact rows, typed partial
        (with its report), or a typed error. Anything else propagates —
        an UNtyped escape is precisely what the suite must catch."""
        t0 = time.monotonic()
        try:
            rows = self.broker.run(query)
        except TYPED_ERRORS as e:
            return Outcome("error", None, e, time.monotonic() - t0)
        elapsed = time.monotonic() - t0
        missing = getattr(rows, "missing_segments", None)
        if missing is not None:
            return Outcome("partial", list(rows), None, elapsed,
                           missing=list(missing))
        return Outcome("exact", rows, None, elapsed)

    def verify(self, query, outcome: Outcome) -> None:
        """The bit-parity gate on every surviving path: exact results
        must equal the full oracle; a partial's rows must equal the
        oracle over exactly the segments its report says survived (an
        inaccurate missingSegments report fails here)."""
        if outcome.kind == "exact":
            assert outcome.rows == self.oracle(query), \
                "exact result diverged from the fault-free oracle"
        elif outcome.kind == "partial":
            assert outcome.missing, "partial without a missing report"
            assert set(outcome.missing) <= set(self._by_id), \
                f"report names unknown segments: {outcome.missing}"
            expect = self.oracle(query, exclude=outcome.missing) \
                if len(outcome.missing) < len(self._by_id) else []
            assert outcome.rows == expect, \
                "partial rows diverged from the oracle over the " \
                "surviving segment set — the report is inaccurate " \
                "or a partial was double-merged"
