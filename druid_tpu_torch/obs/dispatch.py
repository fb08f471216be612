"""Device-dispatch accounting: one counter per device-callable invocation.

A "dispatch" is one device run on the query path — a per-segment
grouped-aggregate run ("segment"), a run-space run ("runDomain"), a
batched multi-segment run ("batched"), a bitmap-algebra fill wave
("filterFill"). The count
is the engine's dispatch-amortization scoreboard: the megakernel's
contract (a cold query's filter fused into its one run —
engine/megakernel.py) can be asserted against deltas of this counter, and
`query/dispatch/count` makes
the same number a tick-window metric so a planner regression that
reintroduces a fill wave or splits a fused program shows up on dashboards,
not just in tests.

Deliberately NOT derived from qtrace spans: spans are off for
{"trace": false} queries and the witness must count every dispatch.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from druid_tpu_torch.utils.emitter import Monitor


class DispatchStats:
    """Thread-safe per-kind dispatch counters (BatchStats discipline)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total = 0
        self._by_kind: Dict[str, int] = {}

    def record(self, kind: str) -> None:
        with self._lock:
            self._total += 1
            self._by_kind[kind] = self._by_kind.get(kind, 0) + 1

    def count(self) -> int:
        with self._lock:
            return self._total

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._by_kind)
            out["total"] = self._total
            return out


_STATS = DispatchStats()


def record(kind: str) -> None:
    """Count one device dispatch of `kind` ("segment", "runDomain",
    "batched", "filterFill") — called where the run was issued, never
    speculatively."""
    _STATS.record(kind)


def count() -> int:
    """Total dispatches this process has issued (test/bench delta basis)."""
    return _STATS.count()


def stats() -> DispatchStats:
    return _STATS


class DispatchMonitor(Monitor):
    """Emits `query/dispatch/count` per tick: dispatches since the last
    tick (delta, the FilterBitmapMonitor discipline)."""

    def __init__(self, source: Optional[DispatchStats] = None):
        self.source = source or _STATS
        self._last = self.source.count()

    def do_monitor(self, emitter):
        now = self.source.count()
        last, self._last = self._last, now
        emitter.metric("query/dispatch/count", now - last)
