"""Data-node query scheduler: cross-query batched execution behind
admission control (the port's own copy of the reference package's
`server/scheduler.py`, over the port's DataNode).

Production traffic is thousands of small concurrent queries hammering the
same hot datasource — and each one used to pay its own device dispatch even
when its program was identical to its neighbor's. This module is the
batching/admission/fallback triad of the Tailwind query-accelerator design
(PAPERS.md) at the data node:

  * BATCHING — arriving queries are held for a short window
    (`batch_window_ms`, a few ms) and flushed as ONE group through
    DataNode.run_partials_group, where plan-compatible segment work fuses
    across queries into shared device dispatches
    (engine/batching.py). While a flush executes,
    new arrivals accumulate — the batch size self-tunes to the service
    rate, the window only pays off when the node is idle.
  * ADMISSION — a bounded queue (`max_queue_depth`) with priority lanes:
    context `lane` (or derived from context `priority`: < 0 means
    "background") caps how much of the queue background work may occupy
    (`lane_depths`), so a background flood sheds background queries while
    interactive admission — and hence interactive p99 — stays bounded.
    Per-query cost (segment row counts) feeds an EWMA service rate; a
    query whose context deadline the queue provably cannot meet is shed
    immediately rather than timed out late.
  * FALLBACK — shedding raises QueryCapacityError (HTTP 429 + Retry-After
    at DataNodeServer); cached/row work routes through the normal
    per-query path inside the same flush, so nothing changes semantics.

Observability: the request thread wraps its hold in a `queue/wait` qtrace
span (nested under the per-request `datanode/query` root) and emits
`query/queue/wait` directly — metrics flow even for {"trace": false}
queries. The dispatcher attaches the flush leader's span so engine
dispatch/compile spans land in a real request trace. SchedulerMetricsMonitor
emits `query/queue/depth`, `query/shed/count`, and per-fused-dispatch
`query/crossBatch/{queries,segments,fillRatio}` (declared in obs/catalog.py).
"""
from __future__ import annotations

import collections
import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from druid_tpu_torch.obs import trace as qtrace
from druid_tpu_torch.server.querymanager import (Deadline, QueryCapacityError,
                                                 context_priority,
                                                 context_timeout_ms)
from druid_tpu_torch.utils.emitter import Monitor

log = logging.getLogger(__name__)

#: lane assigned when the context names none and priority >= 0
INTERACTIVE_LANE = "interactive"
#: the low-priority lane (context {"lane": "background"} or priority < 0)
BACKGROUND_LANE = "background"


def lane_of(query) -> str:
    """The query's priority lane: explicit context `lane`, else derived
    from context `priority` (< 0 = background, the reference's HiLo laning
    convention)."""
    lane = query.context_map.get("lane")
    if lane:
        return str(lane)
    return BACKGROUND_LANE if context_priority(query) < 0 \
        else INTERACTIVE_LANE


@dataclass
class SchedulerConfig:
    """Admission/batching knobs (see README 'Cross-query batching &
    admission control')."""
    #: how long the dispatcher holds the first arrival for batch-mates
    batch_window_ms: float = 3.0
    #: bounded queue: arrivals beyond this depth shed with 429
    max_queue_depth: int = 64
    #: per-lane queue-depth caps; None derives {background: depth // 4} so
    #: a background flood can never occupy the whole queue
    lane_depths: Optional[Dict[str, int]] = None
    #: at most this many queries per flush group
    max_batch_queries: int = 64
    #: Retry-After seconds when no service-rate estimate exists yet
    retry_after_s: float = 1.0
    #: shed queries whose context deadline the queue provably cannot meet
    shed_on_deadline: bool = True

    def effective_lane_depths(self) -> Dict[str, int]:
        if self.lane_depths is not None:
            return dict(self.lane_depths)
        return {BACKGROUND_LANE: max(1, self.max_queue_depth // 4)}


class SchedulerStats:
    """Counters + bounded per-dispatch event queue the monitor drains
    (the BatchStats discipline)."""

    EVENT_CAP = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = 0
        self.shed = 0
        self.executed = 0
        self.flushes = 0
        self.cross_batches = 0
        self._shed_since_drain = 0
        self.dropped_events = 0
        self._events: "collections.deque[Tuple[int, int, float]]" = \
            collections.deque(maxlen=self.EVENT_CAP)

    def record_submit(self) -> None:
        with self._lock:
            self.submitted += 1

    def record_shed(self) -> None:
        with self._lock:
            self.shed += 1
            self._shed_since_drain += 1

    def record_flush(self, n_items: int) -> None:
        with self._lock:
            self.flushes += 1
            self.executed += n_items

    def record_cross_batch(self, n_queries: int, n_segments: int,
                           fill: float) -> None:
        """on_batch hook: one event per fused device dispatch."""
        with self._lock:
            if n_queries > 1:
                self.cross_batches += 1
            if len(self._events) == self.EVENT_CAP:
                self.dropped_events += 1
            self._events.append((n_queries, n_segments, fill))

    def drain_events(self):
        """Returns (events, shed-since-last-drain, dropped-since-drain)."""
        with self._lock:
            out = list(self._events)
            self._events.clear()
            shed, self._shed_since_drain = self._shed_since_drain, 0
            dropped, self.dropped_events = self.dropped_events, 0
            return out, shed, dropped

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"submitted": self.submitted, "shed": self.shed,
                    "executed": self.executed, "flushes": self.flushes,
                    "crossBatches": self.cross_batches}


class SchedulerMetricsMonitor(Monitor):
    """query/queue/depth gauge + query/shed/count delta + one
    query/crossBatch/{queries,segments,fillRatio} triple per fused
    dispatch recorded since the last tick."""

    def __init__(self, scheduler: "DataNodeScheduler"):
        self.scheduler = scheduler

    def do_monitor(self, emitter):
        emitter.metric("query/queue/depth", self.scheduler.depth())
        events, shed, dropped = self.scheduler.stats.drain_events()
        emitter.metric("query/shed/count", shed)
        for n_queries, n_segments, fill in events:
            emitter.metric("query/crossBatch/queries", n_queries)
            emitter.metric("query/crossBatch/segments", n_segments)
            emitter.metric("query/crossBatch/fillRatio", fill)
        if dropped:
            # no silent caps: >EVENT_CAP dispatches between ticks means
            # the crossBatch series above undercounts — say by how much
            emitter.metric("query/crossBatch/droppedEvents", dropped)


class _Item:
    """One queued query. `result`/`error` are written by the dispatcher and
    read by the submitting thread, both under the scheduler lock; `done`
    orders the handoff."""

    __slots__ = ("query", "segment_ids", "check", "lane", "priority",
                 "cost_rows", "seq", "enq_t", "started", "done", "result",
                 "error", "abandoned", "parent_span")

    def __init__(self, query, segment_ids, check, lane, priority,
                 cost_rows, seq):
        self.query = query
        self.segment_ids = list(segment_ids)
        self.check = check
        self.lane = lane
        self.priority = priority
        self.cost_rows = cost_rows
        self.seq = seq
        self.enq_t = time.monotonic()
        self.started = threading.Event()   # left the queue, flush running
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.abandoned = False
        self.parent_span = qtrace.current_span()


class DataNodeScheduler:
    """The admission-controlled batching scheduler fronting one DataNode's
    aggregate-partials path. submit() blocks the (HTTP handler) request
    thread until its query's flush completes; a dedicated dispatcher
    thread drains the queue in priority order and executes each group via
    DataNode.run_partials_group."""

    def __init__(self, node, config: Optional[SchedulerConfig] = None,
                 emitter=None):
        self.node = node
        self.config = config or SchedulerConfig()
        self.emitter = emitter
        self.stats = SchedulerStats()
        self._lane_depths = self.config.effective_lane_depths()
        self._cond = threading.Condition(threading.Lock())
        self._queue: List[_Item] = []
        self._seq = 0
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        #: EWMA service rate (rows/s) measured over completed flushes;
        #: None until the first flush lands
        self._rate_rows_per_s: Optional[float] = None
        #: tick hooks the flush loop drives between flushes (standing-query
        #: / subscription-hub ticks — server/subscriptions.py); fired
        #: OUTSIDE the lock, exception-isolated
        self._tick_hooks: List = []

    # ---- lifecycle -----------------------------------------------------
    def start(self) -> "DataNodeScheduler":
        with self._cond:
            if self._thread is None or not self._thread.is_alive():
                self._stopping = False
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="datanode-scheduler")
                self._thread.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._stopping = True
            # fail waiters HERE, not only in the dispatcher loop: a
            # submit that raced stop() when no dispatcher is alive (e.g.
            # constructed but never started) has nothing else to fail it
            # and would strand its waiter until the query's own timeout
            self._fail_queued_locked(RuntimeError("scheduler stopped"))
            self._cond.notify_all()
            t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=5.0)

    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

    # ---- tick hooks (the standing-query tick driver) --------------------
    def add_tick_hook(self, fn) -> None:
        """Register a callable the dispatcher loop invokes between flushes
        (and roughly every wait period when idle). Hooks run on the
        dispatcher thread, outside the scheduler lock; exceptions are
        logged, never fatal."""
        with self._cond:
            if fn not in self._tick_hooks:
                self._tick_hooks.append(fn)

    def remove_tick_hook(self, fn) -> None:
        with self._cond:
            try:
                self._tick_hooks.remove(fn)
            except ValueError:
                pass

    def _fire_tick_hooks(self) -> None:
        with self._cond:
            hooks = list(self._tick_hooks)
        for fn in hooks:
            try:
                fn()
            except Exception:
                log.exception("scheduler tick hook failed")

    # ---- admission + hold (request thread) -----------------------------
    def submit(self, query, segment_ids, check=None):
        """Admit, queue, and wait for this query's flush. Returns
        (AggregatePartials, served); raises QueryCapacityError when shed,
        or whatever the query's own cancel/timeout probe raised."""
        self.stats.record_submit()
        lane = lane_of(query)
        priority = context_priority(query)
        cost = self._estimate_rows(segment_ids)
        deadline = Deadline.for_query(query)
        with self._cond:
            if self._stopping:
                raise RuntimeError("scheduler stopped")
            self._admit_locked(query, lane, cost)
            self._seq += 1
            item = _Item(query, segment_ids, check, lane, priority, cost,
                         self._seq)
            self._queue.append(item)
            depth = len(self._queue)
            self._cond.notify_all()
        self._ensure_dispatcher()
        # phase 1 — the HOLD: queued until the dispatcher starts our
        # flush. This is what queue/wait (span AND metric) measures;
        # execution time shows up as engine spans, not queue time. The
        # metric emits even when tracing is off ({"trace": false}).
        t0 = time.monotonic()
        try:
            with qtrace.span("queue/wait", lane=lane, depth=depth,
                             priority=priority):
                self._await(item, deadline, item.started)
        finally:
            waited_ms = (time.monotonic() - t0) * 1000.0
            if self.emitter is not None:
                self.emitter.metric(
                    "query/queue/wait", waited_ms,
                    dataSource=query.datasource, type=query.query_type,
                    id=query.context_map.get("queryId", ""), lane=lane)
        # phase 2 — the flush itself
        self._await(item, deadline, item.done)
        with self._cond:
            if item.error is not None:
                raise item.error
            return item.result

    def _estimate_rows(self, segment_ids) -> int:
        try:
            segs, _ = self.node._select(segment_ids)
        except Exception:
            log.debug("cost estimate failed; admitting at zero cost",
                      exc_info=True)
            return 0
        return sum(s.n_rows for s in segs)

    def _admit_locked(self, query, lane: str, cost_rows: int) -> None:
        """Shed checks, called with the lock held. Raising here is the
        429: bounded total depth, per-lane depth, and (when a service-rate
        estimate exists) a deadline the queue provably cannot meet."""
        cfg = self.config
        depth = len(self._queue)
        if depth >= cfg.max_queue_depth:
            self.stats.record_shed()
            raise QueryCapacityError(
                f"query queue full ({depth}/{cfg.max_queue_depth})",
                retry_after_s=self._drain_estimate_s(),
                server=getattr(self.node, "name", ""))
        cap = self._lane_depths.get(lane)
        if cap is not None \
                and sum(1 for it in self._queue if it.lane == lane) >= cap:
            self.stats.record_shed()
            raise QueryCapacityError(
                f"lane [{lane}] queue full ({cap})",
                retry_after_s=self._drain_estimate_s(),
                server=getattr(self.node, "name", ""))
        if cfg.shed_on_deadline and self._rate_rows_per_s:
            tmo = context_timeout_ms(query)
            if tmo is not None:
                queued = sum(it.cost_rows for it in self._queue) + cost_rows
                est_ms = queued / self._rate_rows_per_s * 1000.0
                if est_ms > tmo:
                    self.stats.record_shed()
                    raise QueryCapacityError(
                        f"deadline infeasible: ~{est_ms:.0f}ms of queued "
                        f"work against a {tmo:.0f}ms timeout",
                        retry_after_s=max(est_ms / 1000.0,
                                          cfg.retry_after_s),
                        server=getattr(self.node, "name", ""))

    def _drain_estimate_s(self) -> float:
        """Retry-After: the time the current queue needs to drain at the
        measured service rate (floor: the configured default)."""
        rate = self._rate_rows_per_s
        if not rate:
            return self.config.retry_after_s
        queued = sum(it.cost_rows for it in self._queue)
        return max(queued / rate, self.config.retry_after_s)

    def _await(self, item: _Item, deadline: Deadline,
               event: threading.Event) -> None:
        """Block until `event` fires; polls the query's cancel/timeout
        probe (no notification reaches a queued waiter on cancel) and
        abandons the slot on abort so the dispatcher skips still-queued
        dead work (an already-running flush is uninterruptible — its
        late result is simply discarded)."""
        while True:
            if event.wait(0.05):
                return
            try:
                if item.check is not None:
                    item.check()
                deadline.check()
            except BaseException:
                with self._cond:
                    item.abandoned = True
                    if item in self._queue:
                        self._queue.remove(item)
                raise

    def _ensure_dispatcher(self) -> None:
        with self._cond:
            if self._stopping:
                # a submit racing stop(): the item was (or will be)
                # failed by _fail_queued_locked — do NOT resurrect the
                # dispatcher; only an explicit start() restarts
                return
            t = self._thread
        if t is None or not t.is_alive():
            self.start()

    # ---- dispatch (scheduler thread) -----------------------------------
    def _loop(self) -> None:
        while True:
            with self._cond:
                if not self._queue and not self._stopping:
                    # single-shot wait (submit notifies): the loop exits
                    # the lock each period so tick hooks fire while idle
                    self._cond.wait(0.2)
                if self._stopping:
                    self._fail_queued_locked(
                        RuntimeError("scheduler stopped"))
                    return
                oldest = min((it.enq_t for it in self._queue), default=None)
            # the flush loop doubles as the standing-query tick driver:
            # hooks fire between flushes, outside the lock
            self._fire_tick_hooks()
            if oldest is None:
                continue
            # the batching window: give the oldest arrival's batch-mates
            # time to land before flushing (outside the lock; stop() stays
            # responsive via the post-sleep re-check). The window anchors
            # at the oldest enqueue, so the hold is its remaining budget.
            window = Deadline.until(
                oldest + self.config.batch_window_ms / 1000.0)
            hold = window.remaining()
            if hold > 0:
                time.sleep(hold)
            with self._cond:
                if self._stopping:
                    self._fail_queued_locked(
                        RuntimeError("scheduler stopped"))
                    return
                group = self._drain_locked()
            if group:
                self._execute(group)

    def _drain_locked(self) -> List[_Item]:
        """Priority-ordered flush group: interactive lanes ahead of
        background, higher context priority first, FIFO within — capped at
        max_batch_queries (the rest stays queued for the next flush)."""
        live = [it for it in self._queue if not it.abandoned]
        live.sort(key=lambda it: (it.lane == BACKGROUND_LANE,
                                  -it.priority, it.seq))
        group = live[:self.config.max_batch_queries]
        taken = set(map(id, group))
        self._queue = [it for it in self._queue if id(it) not in taken
                       and not it.abandoned]
        return group

    def _fail_queued_locked(self, err: BaseException) -> None:
        for it in self._queue:
            it.error = err
            it.started.set()
            it.done.set()
        self._queue.clear()

    def _execute(self, group: List[_Item]) -> None:
        """Run one flush group through the node's cross-query path. Engine
        spans land under the flush leader's request trace (the other
        queries' traces still carry their own queue/wait hold)."""
        leader = next((it.parent_span for it in group
                       if it.parent_span is not None), None)
        for it in group:
            it.started.set()             # ends every member's queue/wait
        t0 = time.monotonic()
        rows = sum(it.cost_rows for it in group)
        try:
            from druid_tpu_torch.obs import dispatch as dispatch_mod
            d0 = dispatch_mod.count()
            with qtrace.attach(leader), \
                    qtrace.span("sched/flush", queries=len(group),
                                segments=sum(len(it.segment_ids)
                                             for it in group)) as fsp:
                results = self.node.run_partials_group(
                    [(it.query, it.segment_ids, it.check) for it in group],
                    on_batch=self.stats.record_cross_batch)
                if fsp is not None:
                    # the flush's whole-group dispatch bill: the megakernel
                    # + cross-query fusion story in one span attribute
                    fsp.attrs["dispatches"] = dispatch_mod.count() - d0
        except Exception as e:
            # run_partials_group isolates per-query failures; reaching
            # here is a scheduler-level defect — fail the group, keep
            # serving
            log.exception("scheduler flush failed")
            results = [e] * len(group)
        self.stats.record_flush(len(group))
        dt = time.monotonic() - t0
        if rows and dt > 0:
            inst = rows / dt
            with self._cond:
                self._rate_rows_per_s = inst if self._rate_rows_per_s \
                    is None else 0.7 * self._rate_rows_per_s + 0.3 * inst
        with self._cond:
            for it, res in zip(group, results):
                if isinstance(res, BaseException):
                    it.error = res
                else:
                    it.result = res
                it.done.set()
