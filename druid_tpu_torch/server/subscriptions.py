"""Broker-side subscription fan-out over standing queries.

The port's own copy of the reference package's `server/subscriptions.py`.
The hub's standing programs fold on the hub's device (`device=None`: CUDA,
through device.resolve; "cpu" runs the plain PyTorch versions).

A million dashboards watching the same handful of queries must cost a
handful of device programs, not a million re-scans. The `SubscriptionHub`
dedupes structurally identical subscriptions (the existing query-structure
signature, cluster/cache.query_cache_key — the query minus context) onto
ONE `StandingQuery` (engine/standing.py) per structure, and fans results
out via long-poll:

  * subscribe(query) -> (subscription id, etag). N identical dashboards
    share one refcounted standing program; the Nth subscribe is a dict
    bump, not a compile.
  * poll(sub_id, etag, timeout_s): blocks the caller (the HTTP handler
    thread — ThreadingHTTPServer's per-connection threads ARE the fan-out
    pool) until the program's version moves past the presented etag or
    the timeout lapses — the long-poll twin of the server's existing
    If-None-Match machinery (server/http.py): an unchanged window is a
    304, a changed one ships rows + the new X-Druid-ETag.
  * unsubscribe (or a client that silently disconnected and stopped
    polling, swept after `idle_timeout_s`) decrements the refcount; the
    last reference tears the standing program down — listeners detach,
    folded state drops, waiters wake.

Ticking: `drive_with(scheduler)` hangs the hub's tick on the data-node
scheduler's flush loop (server/scheduler.py tick hooks — the natural tick
driver); `start()` runs a dedicated daemon tick thread instead
(joined in stop()) for broker-only deployments.
"""
from __future__ import annotations

import logging
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from druid_tpu_torch import device as device_mod
from druid_tpu_torch.engine.standing import StandingQuery
from druid_tpu_torch.query.model import Query
from druid_tpu_torch.server.deadline import Deadline
from druid_tpu_torch.utils.emitter import Monitor

log = logging.getLogger(__name__)


class UnknownSubscriptionError(KeyError):
    """The subscription id is not (or no longer) registered — the client
    re-subscribes (its state may have been swept as idle)."""


class SubscriptionStats:
    """Counters behind subscription/{active,fanout,ticks}."""

    def __init__(self):
        self._lock = threading.Lock()
        self.ticks = 0
        self.fanout = 0
        self.subscribed = 0
        self.unsubscribed = 0

    def record_tick(self) -> None:
        with self._lock:
            self.ticks += 1

    def record_fanout(self) -> None:
        with self._lock:
            self.fanout += 1

    def record_subscribe(self) -> None:
        with self._lock:
            self.subscribed += 1

    def record_unsubscribe(self) -> None:
        with self._lock:
            self.unsubscribed += 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"ticks": self.ticks, "fanout": self.fanout,
                    "subscribed": self.subscribed,
                    "unsubscribed": self.unsubscribed}


@dataclass
class _Program:
    """One standing program + its subscriber refcount."""
    standing: StandingQuery
    refs: int = 0


@dataclass
class _Subscription:
    """One client's handle onto a shared program."""
    sub_id: str
    sig: str
    program: _Program
    last_poll: float = field(default_factory=time.monotonic)


class SubscriptionHub:
    """Refcounted dedupe of dashboard subscriptions onto standing
    programs, with long-poll fan-out (see module docstring)."""

    def __init__(self, emitter=None, idle_timeout_s: float = 300.0,
                 tick_period_s: float = 0.05, device=None):
        self.device = device_mod.resolve(device)
        self.stats = SubscriptionStats()
        self.emitter = emitter
        self.idle_timeout_s = float(idle_timeout_s)
        self.tick_period_s = float(tick_period_s)
        self._cond = threading.Condition(threading.Lock())
        self._programs: Dict[str, _Program] = {}
        self._subs: Dict[str, _Subscription] = {}
        self._apps: List[object] = []
        self._scheduler = None
        self._thread: Optional[threading.Thread] = None
        self._stopping = False

    # ---- wiring --------------------------------------------------------
    def attach(self, appenderator) -> None:
        """Register a live datasource; existing programs on the same
        datasource start standing over it too."""
        with self._cond:
            self._apps.append(appenderator)
            progs = list(self._programs.values())
        for p in progs:
            if p.standing.query.datasource == appenderator.datasource:
                p.standing.attach(appenderator)

    def drive_with(self, scheduler) -> "SubscriptionHub":
        """Tick on the data-node scheduler's flush loop instead of an own
        thread (the scheduler's flush loop is the natural tick driver)."""
        with self._cond:
            self._scheduler = scheduler
        scheduler.add_tick_hook(self.tick)
        return self

    def start(self) -> "SubscriptionHub":
        with self._cond:
            self._stopping = False
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._tick_loop, daemon=True,
                    name="subscription-hub")
                self._thread.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._stopping = True
            sched, self._scheduler = self._scheduler, None
            t = self._thread
            self._cond.notify_all()
        if sched is not None:
            sched.remove_tick_hook(self.tick)
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=5.0)
        # tear down every program: waiters wake, listeners detach
        with self._cond:
            subs = list(self._subs)
        for sid in subs:
            self.unsubscribe(sid)

    def _tick_loop(self) -> None:
        while True:
            with self._cond:
                if self._stopping:
                    return
            self.tick()
            with self._cond:
                if self._stopping:
                    return
                self._cond.wait(self.tick_period_s)

    # ---- subscription lifecycle ----------------------------------------
    def subscribe(self, query: Query) -> Tuple[str, str]:
        """Register one subscriber; returns (subscription id, etag of the
        program's current version). Structurally identical queries share
        one standing program — the dedupe key is the structure signature
        (query minus context) PLUS the resolved emission policy, since
        standingEmit lives in the context but changes what a program
        delivers (StandingIneligible propagates for shapes that cannot
        stand)."""
        from druid_tpu_torch.cluster.cache import query_cache_key
        from druid_tpu_torch.engine.standing import resolve_emit
        sig = f"{query_cache_key(query)}|emit={resolve_emit(query)}"
        while True:
            with self._cond:
                if self._stopping:
                    raise RuntimeError("subscription hub stopped")
                prog = self._programs.get(sig)
                apps = [a for a in self._apps
                        if a.datasource == query.datasource]
            if prog is None:
                # build OUTSIDE the lock (attaches listeners); a
                # concurrent duplicate build loses the insert race and is
                # closed below
                built = _Program(standing=StandingQuery(
                    query, apps, device=self.device))
                missing = []
                with self._cond:
                    prog = self._programs.get(sig)
                    if prog is None:
                        # the program key is query structure by design;
                        # an attach() that races the build retro-wires
                        # through the missing re-check below, so the
                        # apps snapshot cannot alias a subscriber set
                        prog = self._programs[sig] = built
                        built = None
                        # an attach() that raced the build (retro-wiring
                        # ran before our insert) would leave this program
                        # permanently blind to that datasource — re-check
                        missing = [a for a in self._apps
                                   if a.datasource == query.datasource
                                   and a not in apps]
                if built is not None:
                    built.standing.close()
                for a in missing:
                    prog.standing.attach(a)
            sub_id = uuid.uuid4().hex
            with self._cond:
                # the program may have been torn down between the lookup
                # and here (last unsubscribe raced us): registering
                # against the closed, unmapped program would long-poll a
                # dead world forever — retry against the live registry
                if self._programs.get(sig) is not prog:
                    continue
                prog.refs += 1
                self._subs[sub_id] = _Subscription(sub_id=sub_id, sig=sig,
                                                   program=prog)
            self.stats.record_subscribe()
            return sub_id, prog.standing.etag()

    def unsubscribe(self, sub_id: str) -> bool:
        """Drop one subscriber; the last reference tears the standing
        program down. Returns whether the id was registered."""
        with self._cond:
            sub = self._subs.pop(sub_id, None)
            if sub is None:
                return False
            sub.program.refs -= 1
            dead = None
            if sub.program.refs <= 0 \
                    and self._programs.get(sub.sig) is sub.program:
                dead = self._programs.pop(sub.sig)
            self._cond.notify_all()       # wake this client's poll waiters
        if dead is not None:
            dead.standing.close()
        self.stats.record_unsubscribe()
        return True

    def active_subscriptions(self) -> int:
        with self._cond:
            return len(self._subs)

    def active_programs(self) -> int:
        with self._cond:
            return len(self._programs)

    #: server-side ceiling on one long-poll hold: a client-supplied
    #: timeout (timeoutMs=inf, or merely huge) must never park a handler
    #: thread indefinitely — the parked poll refreshes the idle clock, so
    #: an unbounded hold would also defeat the idle sweep forever
    MAX_POLL_TIMEOUT_S = 60.0

    # ---- fan-out -------------------------------------------------------
    def poll(self, sub_id: str, etag: Optional[str] = None,
             timeout_s: float = 0.0):
        """Long-poll one subscription. Returns (rows, etag, changed):
        changed=False (rows None) when the program's version still matches
        the presented etag after `timeout_s` (clamped to
        MAX_POLL_TIMEOUT_S — clients re-poll) — the 304 path. Touches the
        subscription's idle clock."""
        timeout_s = float(timeout_s)
        if not (timeout_s > 0):             # NaN/negative -> immediate
            timeout_s = 0.0
        timeout_s = min(timeout_s, self.MAX_POLL_TIMEOUT_S)
        deadline = Deadline.after_s(timeout_s)
        while True:
            with self._cond:
                sub = self._subs.get(sub_id)
                if sub is None:
                    raise UnknownSubscriptionError(sub_id)
                sub.last_poll = time.monotonic()
                prog = sub.program
                current = prog.standing.etag()
                if etag is not None and current == etag:
                    if deadline.expired():
                        return None, current, False
                    self._cond.wait(deadline.clamp(0.25))
                    continue
            # changed (or unconditional): the merge runs OUTSIDE the hub
            # lock; rows/etag are read as one consistent snapshot
            snap = prog.standing.snapshot()
            self.stats.record_fanout()
            return snap.rows, snap.etag, True

    # ---- the tick ------------------------------------------------------
    def tick(self) -> int:
        """Advance every standing program one tick and wake waiters whose
        program emitted; sweeps idle subscriptions. Returns the number of
        programs that emitted."""
        with self._cond:
            if self._stopping:
                return 0
            progs = list(self._programs.values())
        emitted = 0
        for p in progs:
            try:
                if p.standing.tick() is not None:
                    emitted += 1
            except Exception:
                log.exception("standing tick failed")
        if emitted:
            with self._cond:
                self._cond.notify_all()
        self._sweep_idle()
        self.stats.record_tick()
        return emitted

    def _sweep_idle(self) -> None:
        """Tear down subscriptions whose client stopped polling (silent
        disconnects must not pin standing programs forever)."""
        if self.idle_timeout_s <= 0:
            return
        cutoff = time.monotonic() - self.idle_timeout_s
        with self._cond:
            idle = [s.sub_id for s in self._subs.values()
                    if s.last_poll < cutoff]
        for sid in idle:
            self.unsubscribe(sid)


class SubscriptionMetricsMonitor(Monitor):
    """subscription/active gauge + per-tick fanout/ticks deltas."""

    def __init__(self, hub: SubscriptionHub):
        self.hub = hub
        self._last = hub.stats.snapshot()

    def do_monitor(self, emitter):
        s = self.hub.stats.snapshot()
        last, self._last = self._last, s
        emitter.metric("subscription/active",
                       self.hub.active_subscriptions())
        emitter.metric("subscription/fanout", s["fanout"] - last["fanout"])
        emitter.metric("subscription/ticks", s["ticks"] - last["ticks"])
