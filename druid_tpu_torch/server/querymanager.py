"""Query cancellation + timeout bookkeeping (the port's own copy of the
reference package's `server/querymanager.py`).

Reference analogs:
  server/QueryResource.java:126 — DELETE /druid/v2/{id} → QueryManager.cancel
  query/QueryContexts.java — timeout / priority context keys and defaults
  query/QueryInterruptedException.java — the wire-visible cancel/timeout error

A QueryToken is registered per running query id; cancel() trips the token and
fans out to any registered remote-cancel hooks (the broker propagates the
DELETE to data nodes it has in-flight requests on, like DirectDruidClient
does). Execution layers call token.check() at their natural yield points
(between scatter rounds, between segment batches) — device programs
themselves are uninterruptible once launched, exactly like a Java hot loop
between two Yielder steps.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional

from druid_tpu_torch.server.deadline import (Deadline, # noqa: F401 (re-export)
                                       context_timeout_ms)


class QueryInterruptedError(RuntimeError):
    """Query was cancelled (reference: QueryInterruptedException CANCELLED)."""


class QueryTimeoutError(RuntimeError):
    """Query exceeded its context timeout (QueryInterruptedException
    TIMED_OUT; HTTP 504 at the resource layer)."""


class QueryCapacityError(RuntimeError):
    """The query was shed at admission — bounded scheduler queue, lane cap,
    or a deadline the queue cannot meet (reference:
    QueryCapacityExceededException). HTTP 429 with a Retry-After header at
    the resource layer; the broker surfaces it as a clear shed error
    instead of an opaque per-segment failure."""

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 server: str = ""):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.server = server

    def retry_after_header(self) -> str:
        """The Retry-After header value (whole seconds, floor 1) — the one
        place the wire contract's rounding lives; the broker resource and
        the data-node handler must answer identically."""
        return str(max(1, round(self.retry_after_s)))


DEFAULT_TIMEOUT_MS = 300_000


def cancel_path_id(path: str) -> Optional[str]:
    """The query id from an exact DELETE /druid/v2/{id} path, else None.
    Reserved sub-resources (datasources, sql, partials, rows) and bare
    /druid/v2 are not query ids."""
    parts = path.rstrip("/").split("/")
    if len(parts) != 4 or parts[:3] != ["", "druid", "v2"]:
        return None
    qid = parts[3]
    return qid if qid and qid not in ("datasources", "sql", "partials",
                                      "rows") else None


def context_priority(query) -> int:
    """Context "priority" (QueryContexts.getPriority) — tagged on query
    metrics/request logs; lane scheduling can build on it."""
    try:
        return int(query.context_map.get("priority", 0))
    except (TypeError, ValueError):
        return 0


class QueryToken:
    def __init__(self, query_id: str):
        self.query_id = query_id
        self.refcount = 1
        self._cancelled = threading.Event()
        self._remote_cancels: Dict[object, Callable[[], None]] = {}
        self._lock = threading.Lock()

    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def check(self) -> None:
        if self.cancelled():
            raise QueryInterruptedError(
                f"query [{self.query_id}] was cancelled")

    def add_remote_cancel(self, fn: Callable[[], None],
                          key: object = None) -> None:
        """Register a propagation hook (e.g. DELETE to a data node), one per
        key — re-registering the same server across retry rounds is a no-op.
        Runs immediately (in the background) if the token already tripped."""
        run_now = False
        with self._lock:
            if self._cancelled.is_set():
                run_now = True
            else:
                # one hook per key by contract: re-registering the same
                # server across retry rounds is an equivalent no-op
                self._remote_cancels.setdefault(
                    key if key is not None else object(), fn)
        if run_now:
            self._fire([fn])

    @staticmethod
    def _fire(hooks: List[Callable[[], None]]) -> None:
        """Best-effort propagation off the caller's thread: a DELETE at the
        resource layer must answer 202 immediately, not block on slow or
        dead data nodes (each hook has its own connect timeout)."""
        def run():
            for fn in hooks:
                try:
                    fn()
                except Exception:
                    logging.getLogger(__name__).exception(
                        "cancel propagation hook failed")
        threading.Thread(target=run, daemon=True).start()

    def cancel(self) -> None:
        with self._lock:
            self._cancelled.set()
            hooks = list(self._remote_cancels.values())
            self._remote_cancels = {}
        if hooks:
            self._fire(hooks)


class QueryScheduler:
    """Bounded, priority-ordered admission of queries.

    Reference analog: query/PrioritizedExecutorService.java (per-segment
    work ordered by query priority on a bounded pool) + the laning idea of
    DruidProcessingConfig — here admission happens once per query, because
    a query is ONE fused device program, not thousands of per-segment
    tasks. `total_slots` bounds concurrent queries; waiting queries are
    admitted highest-priority-first (FIFO within a priority); an optional
    per-lane cap (context "lane") keeps one class of queries from
    saturating the node."""

    def __init__(self, total_slots: int = 8,
                 lanes: Optional[Dict[str, int]] = None):
        self.total_slots = total_slots
        self.lane_caps = dict(lanes or {})
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._running = 0
        self._lane_running: Dict[str, int] = {}
        self._waiters: List[tuple] = []   # (-priority, seq, event, lane)
        self._seq = 0

    #: longest single park while queued without a caller timeout: the wait
    #: re-arms after each quantum, so a lost wakeup degrades to one poll
    #: period instead of a handler thread parked forever
    MAX_ADMISSION_POLL_S = 30.0

    def _admissible(self, lane: Optional[str]) -> bool:
        if self._running >= self.total_slots:
            return False
        if lane is not None and lane in self.lane_caps:
            return self._lane_running.get(lane, 0) < self.lane_caps[lane]
        return True

    def acquire(self, priority: int = 0, lane: Optional[str] = None,
                timeout: Optional[float] = None,
                should_abort: Optional[Callable[[], None]] = None) -> bool:
        """Block until admitted (priority order). False on timeout.
        `should_abort` (e.g. QueryToken.check) is polled while queued and
        may raise to abandon the wait — a DELETE on a queued query must
        free the waiter, not let it run later."""
        deadline = Deadline.after_s(timeout)
        with self._cond:
            if not self._waiters and self._admissible(lane):
                self._admit(lane)
                return True
            ev = threading.Event()
            entry = (-priority, self._seq, ev, lane)
            self._seq += 1
            self._waiters.append(entry)
            self._waiters.sort(key=lambda w: (w[0], w[1]))
            # a lane-blocked head must not stall an admissible newcomer
            self._wake_admissible()
            got_slot = False
            try:
                # the caller's timeout IS the query's own admitted budget
                # (context timeoutMs, already defaulted/validated at the
                # edge), not a raw wire value; each park re-arms within
                # MAX_ADMISSION_POLL_S and the cancel token is polled, so
                # an unlimited budget still cannot orphan the waiter
                while True:
                    if should_abort is not None:
                        # BEFORE honoring admission: a cancel that raced a
                        # release must win, or the cancelled query runs
                        should_abort()
                    if ev.is_set():
                        got_slot = True
                        return True
                    if deadline.expired():
                        return False
                    if should_abort is not None:
                        # no notification on cancel: poll the token
                        self._cond.wait(deadline.clamp(0.1))
                    else:
                        self._cond.wait(
                            deadline.clamp(self.MAX_ADMISSION_POLL_S))
            finally:
                if entry in self._waiters:
                    self._waiters.remove(entry)
                if ev.is_set() and not got_slot:
                    # admitted concurrently with a timeout/abort: give the
                    # slot back or it leaks forever, and wake the waiter
                    # it now belongs to (it may be in an untimed wait)
                    self._running -= 1
                    if lane is not None and lane in self._lane_running:
                        self._lane_running[lane] -= 1
                    self._wake_admissible()
                    self._cond.notify_all()

    def _admit(self, lane: Optional[str]) -> None:
        self._running += 1
        if lane is not None:
            self._lane_running[lane] = self._lane_running.get(lane, 0) + 1

    def _wake_admissible(self) -> None:
        # admit the best-priority waiters whose lane has room
        admitted = []
        for entry in self._waiters:
            _, _, ev, lane = entry
            if self._running >= self.total_slots:
                break
            if lane is not None and lane in self.lane_caps and \
                    self._lane_running.get(lane, 0) >= self.lane_caps[lane]:
                continue          # lane full: try the next waiter
            self._admit(lane)
            ev.set()
            admitted.append(entry)
        for entry in admitted:
            self._waiters.remove(entry)

    def release(self, lane: Optional[str] = None) -> None:
        with self._cond:
            self._running -= 1
            if lane is not None and lane in self._lane_running:
                self._lane_running[lane] -= 1
            self._wake_admissible()
            self._cond.notify_all()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"running": self._running,
                    "waiting": len(self._waiters)}


class QueryManager:
    """Registry of in-flight queries (server/QueryManager analog)."""

    def __init__(self):
        self._tokens: Dict[str, QueryToken] = {}
        self._lock = threading.Lock()

    def register(self, query_id: str) -> QueryToken:
        """Refcounted: two in-flight queries reusing one id share a token
        that survives until the LAST unregister (a retry reusing its
        queryId stays cancellable after the first attempt finishes)."""
        with self._lock:
            tok = self._tokens.get(query_id)
            if tok is None:
                tok = self._tokens[query_id] = QueryToken(query_id)
            else:
                tok.refcount += 1
            return tok

    def unregister(self, query_id: str) -> None:
        with self._lock:
            tok = self._tokens.get(query_id)
            if tok is None:
                return
            tok.refcount -= 1
            if tok.refcount <= 0:
                del self._tokens[query_id]

    def token(self, query_id: Optional[str]) -> Optional[QueryToken]:
        if query_id is None:
            return None
        with self._lock:
            return self._tokens.get(query_id)

    def cancel(self, query_id: str) -> bool:
        """True if the query was in flight. Cancelling an unknown id is a
        no-op success=false (the reference returns 202 either way)."""
        tok = self.token(query_id)
        if tok is None:
            return False
        tok.cancel()
        return True

    def active_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._tokens)
