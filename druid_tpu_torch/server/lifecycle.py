"""Per-query lifecycle: initialize → authorize → execute → emit logs/metrics
(the port's own copy of the reference package's `server/lifecycle.py`).

Reference analogs:
  server/QueryLifecycle.java:61-69,120-133 — the four-phase lifecycle every
    query goes through, emitting query/time metrics and request logs
  processing/.../query/QueryMetrics.java + MetricsEmittingQueryRunner —
    per-query timing dims (query id, type, datasource, success)
  server/log/FileRequestLogger.java / EmittingRequestLogger — request logs
  server/security/Authenticator/Authorizer — pluggable auth SPI chain
    (allow-all default, like the reference's AllowAllAuthorizer)
"""
from __future__ import annotations

import json
import time
import uuid
from typing import Callable, Optional

from druid_tpu_torch.obs import trace as qtrace
from druid_tpu_torch.query.model import Query, query_from_json
from druid_tpu_torch.utils.emitter import ServiceEmitter


class Unauthorized(PermissionError):
    pass


class RequestLogger:
    """NDJSON request log (FileRequestLogger pattern); None path = memory,
    bounded to the most recent `max_entries` so long-running servers don't
    grow without bound."""

    def __init__(self, path: Optional[str] = None, max_entries: int = 10_000):
        from collections import deque
        self.path = path
        self.entries = deque(maxlen=max_entries)
        self._fh = open(path, "a") if path else None

    def log(self, entry: dict) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(entry) + "\n")
            self._fh.flush()
        else:
            self.entries.append(entry)


class QueryLifecycle:
    """Wraps any runner (QueryExecutor / Broker) with auth, metrics,
    request logging, and query-id bookkeeping."""

    def __init__(self, runner,
                 emitter: Optional[ServiceEmitter] = None,
                 request_logger: Optional[RequestLogger] = None,
                 authorizer: Optional[Callable[[Optional[str], Query], bool]] = None,
                 on_result: Optional[Callable[[bool], None]] = None,
                 query_manager=None, scheduler=None,
                 slow_query_ms: Optional[float] = None):
        """slow_query_ms: queries slower than this emit an ALERT carrying
        the full qtrace phase breakdown (the slow-query log); None = off."""
        self.runner = runner
        self.emitter = emitter
        self.request_logger = request_logger
        self.authorizer = authorizer          # (identity, query) → allowed
        self.on_result = on_result            # QueryCountStatsMonitor hook
        self.slow_query_ms = slow_query_ms
        #: optional QueryScheduler: bounded priority-ordered admission
        #: (the PrioritizedExecutorService role, per query not per segment)
        self.scheduler = scheduler
        # share the runner's manager so a DELETE at this resource trips the
        # same token the broker's scatter is checking
        self.query_manager = query_manager \
            if query_manager is not None \
            else getattr(runner, "query_manager", None)

    def _admit(self, query: Query, qid: str):
        """Acquire a scheduler slot (priority/lane from the query context).
        Returns (query, release): the context timeout is rewritten to the
        budget REMAINING after the queue wait — timeout means total query
        time, not per-phase — and a DELETE on the queued id aborts the
        wait via the token. Without a scheduler: (query, no-op)."""
        if self.scheduler is None:
            return query, (lambda: None)
        from druid_tpu_torch.server.querymanager import (
            QueryTimeoutError, context_priority, context_timeout_ms)
        lane = query.context_map.get("lane")
        tmo = context_timeout_ms(query)
        token = self.query_manager.token(qid) \
            if self.query_manager is not None else None
        t0 = time.monotonic()
        with qtrace.span("queue/wait", lane=lane or "",
                         priority=context_priority(query)):
            ok = self.scheduler.acquire(
                priority=context_priority(query), lane=lane,
                timeout=None if tmo is None else tmo / 1000.0,
                should_abort=token.check if token is not None else None)
        if not ok:
            raise QueryTimeoutError(
                "query timed out waiting for an execution slot")
        waited_ms = (time.monotonic() - t0) * 1000
        if self.emitter is not None:
            # time queued before execution (reference: query/wait/time)
            self.emitter.metric("query/wait/time", waited_ms,
                                dataSource=query.datasource,
                                type=query.query_type, id=qid)
        if tmo is not None and waited_ms > 1.0:
            from dataclasses import replace
            remaining = max(1, int(tmo - waited_ms))
            query = replace(query, context=tuple(sorted(
                {**query.context_map, "timeout": remaining}.items())))
        return query, (lambda: self.scheduler.release(lane))

    def cancel(self, query_id: str) -> bool:
        """DELETE /druid/v2/{id} (QueryResource.cancelQuery)."""
        if self.query_manager is None:
            return False
        return self.query_manager.cancel(query_id)

    def run_json(self, payload: dict, identity: Optional[str] = None):
        try:
            query = query_from_json(payload)
        except (ValueError, KeyError, TypeError):
            # malformed queries count as failures at the resource layer
            if self.on_result:
                self.on_result(False)
            raise
        return self.run(query, identity)

    def _prepare(self, query: Query, identity):
        """Shared security-sensitive prologue of run()/run_streaming:
        authorize, stamp the queryId so cancel/timeout plumbing sees it,
        register with the query manager. Returns (query, qid)."""
        qid = query.context_map.get("queryId") or str(uuid.uuid4())
        if self.authorizer is not None \
                and not self.authorizer(identity, query):
            self._log(query, qid, 0.0, False, error="unauthorized")
            raise Unauthorized(f"identity {identity!r} denied on "
                               f"[{query.datasource}]")
        if qid != query.context_map.get("queryId"):
            from dataclasses import replace
            query = replace(query, context=tuple(sorted(
                {**query.context_map, "queryId": qid}.items())))
        if self.query_manager is not None:
            self.query_manager.register(qid)
        return query, qid

    def etag(self, query: Query, identity: Optional[str] = None):
        """Authorization-gated result-set identity (X-Druid-ETag): raises
        Unauthorized exactly like run() would — a 304 must never leak
        whether forbidden data changed. None when the runner has no etag
        surface or the query has none."""
        if self.authorizer is not None \
                and not self.authorizer(identity, query):
            raise Unauthorized(f"identity {identity!r} denied on "
                               f"[{query.datasource}]")
        fn = getattr(self.runner, "etag", None)
        return fn(query) if fn is not None else None

    def log_conditional_hit(self, query: Query, etag: str) -> None:
        """A 304 served off If-None-Match still counts: request log entry
        and success tick, zero rows."""
        self._log(query, f"etag:{etag[:12]}", 0.0, True, n_rows=0)
        if self.on_result:
            self.on_result(True)

    def run(self, query: Query, identity: Optional[str] = None):
        query, qid = self._prepare(query, identity)
        t0 = time.monotonic()
        release = lambda: None
        root = None
        try:
            # the trace root (trace id = queryId): queue wait, broker
            # phases, engine dispatches, and remote nodes' spans all
            # assemble under it; {"trace": false} makes it a no-op
            with qtrace.root_span(
                    "query", query,
                    service=self.emitter.service if self.emitter is not None
                    else "druid/query") as root:
                query, release = self._admit(query, qid)
                rows = self.runner.run(query)
        except Exception as e:
            ms = (time.monotonic() - t0) * 1000
            self._log(query, qid, ms, False, error=str(e))
            self._finish_trace(query, qid, ms, root)
            if self.on_result:
                self.on_result(False)
            raise
        finally:
            release()
            if self.query_manager is not None:
                self.query_manager.unregister(qid)
        ms = (time.monotonic() - t0) * 1000
        self._log(query, qid, ms, True, n_rows=_count_rows(rows))
        self._finish_trace(query, qid, ms, root)
        if self.on_result:
            self.on_result(True)
        return rows

    def _finish_trace(self, query: Query, qid: str, ms: float,
                      root) -> None:
        """Phase-attributed per-query metrics from the assembled trace
        (query/stage/h2d/time and query/node/time, `emit_trace_metrics`;
        the port emits no query/compile/time: nothing compiles per query)
        and the slow-query log: a threshold breach emits an alert with the
        full phase breakdown, so 'where did the 40 ms go' is answerable
        from the metrics stream alone."""
        if self.emitter is None:
            return
        # restrict to THIS run's subtree: a client-reused queryId lands
        # several runs in one store entry, and summing across them would
        # report phantom compile/node time on a cache-hit rerun
        spans = qtrace.spans_under(root._store.spans(root.trace_id),
                                   root.span_id) \
            if root is not None and root._store is not None else []
        if root is not None:
            qtrace.emit_trace_metrics(self.emitter, query, qid, spans)
        # the slow-query alert fires from the wall clock alone — a query
        # opting out of TRACING ({"trace": false}) still breaches the
        # threshold, it just alerts with an empty phase breakdown
        if self.slow_query_ms is not None and ms > self.slow_query_ms:
            self.emitter.alert(
                "slow query: query/time above threshold",
                queryId=qid, dataSource=query.datasource,
                type=query.query_type, durationMs=round(ms, 3),
                thresholdMs=self.slow_query_ms,
                breakdown=qtrace.phase_breakdown(spans))

    def run_streaming(self, query: Query, identity: Optional[str] = None):
        """Streaming variant: authorize up front, yield result batches as
        the runner produces them, emit the request log/metrics when the
        stream completes, fails, OR is abandoned (client disconnect →
        GeneratorExit). Falls back to the materialized path for runners
        without run_streaming."""
        runner_stream = getattr(self.runner, "run_streaming", None)
        if runner_stream is None:
            yield from self.run(query, identity)
            return
        query, qid = self._prepare(query, identity)
        t0 = time.monotonic()
        n = 0
        release = lambda: None
        try:
            query, release = self._admit(query, qid)
            for batch in runner_stream(query):
                n += 1    # top-level results (scan batches), like run()'s
                yield batch   # len(rows) over the materialized batch list
            self._log(query, qid, (time.monotonic() - t0) * 1000, True,
                      n_rows=n)
            if self.on_result:
                self.on_result(True)
        except GeneratorExit:
            # consumer walked away mid-stream — the query still happened
            self._log(query, qid, (time.monotonic() - t0) * 1000, False,
                      error="stream abandoned", n_rows=n)
            if self.on_result:
                self.on_result(False)
            raise
        except Exception as e:
            self._log(query, qid, (time.monotonic() - t0) * 1000, False,
                      error=str(e))
            if self.on_result:
                self.on_result(False)
            raise
        finally:
            release()
            if self.query_manager is not None:
                self.query_manager.unregister(qid)

    def _log(self, query: Query, qid: str, ms: float, ok: bool,
             error: Optional[str] = None, n_rows: int = 0) -> None:
        if self.emitter is not None:
            from druid_tpu_torch.server.querymanager import context_priority
            self.emitter.metric("query/time", ms, dataSource=query.datasource,
                                type=query.query_type, id=qid,
                                priority=context_priority(query),
                                success=str(ok).lower())
        if self.request_logger is not None:
            self.request_logger.log({
                "timestamp": int(time.time() * 1000), "queryId": qid,
                "queryType": query.query_type,
                "dataSource": query.datasource, "query/time": ms,
                "success": ok, "error": error, "rows": n_rows})


def _count_rows(rows) -> int:
    try:
        return len(rows)
    except TypeError:
        return 0
