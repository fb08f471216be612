"""qtrace: end-to-end distributed query tracing (the port's own copy of the
reference package's `obs/trace.py`).

Reference analogs:
  processing/.../query/QueryMetrics.java + MetricsEmittingQueryRunner — the
    per-phase timing dims the reference sprinkles through its runner stack
  opentelemetry-emitter (druid extensions) — span-per-phase query tracing

One trace per query: the trace id IS the queryId (a fresh id when the query
carries none), spans are (name, service, start, duration, attrs) nodes in a
parent tree. Spans cost two monotonic clock reads and a dict — no device
syncs, no locks on the hot path (the store append takes the store lock once
per finished span) — and the whole subsystem no-ops unless a ROOT span is
open on the current thread, so untraced paths pay one thread-local read.

Propagation:
  * thread-local span stack: `span(name)` children nest under the current
    span; `attach(s)` re-activates a span on a worker thread (the broker's
    scatter pool).
  * wire: `with_traceparent(query, span)` stamps "traceId:spanId" into the
    query context the broker POSTs; the data node's `root_span` re-roots its
    spans under that remote parent; the node's finished spans travel back in
    the partials/rows response and the broker ingests them into its store —
    ONE assembled trace per query.
  * opt-out: context {"trace": false} disables tracing for the query
    everywhere (the stamp is simply never created).

Storage: a bounded per-process ring buffer (TraceStore), read by trace id.
In this package the broker and its data nodes share one process, so their
spans land in one store directly.

The port opens the broker's spans (broker/query, broker/plan,
broker/scatter, broker/node, broker/merge), engine/partials around each
partial production and pool/h2d around each device-pool build. It has no
compile spans: its kernels are built once per process, not per query.
"""
from __future__ import annotations

import collections
import threading
import time
import uuid
from typing import Dict, List, Optional

#: context key carrying the remote parent ("traceId:spanId"); the span id is
#: always our own hex (no ":"), so rsplit from the right survives arbitrary
#: user queryIds as trace ids
TRACEPARENT_KEY = "traceparent"
#: context key opting a query out of tracing ({"trace": false})
TRACE_KEY = "trace"

#: well-known span names (phase attribution keys — see obs/catalog.py for
#: the metrics derived from them)
H2D_SPAN = "pool/h2d"
NODE_SPAN = "broker/node"


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One timed phase. Mutated only by the thread that opened it; finished
    spans are immutable JSON dicts in the store/collector."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "service",
                 "start_ms", "duration_ms", "attrs", "_t0", "_store",
                 "_collector")

    def __init__(self, trace_id: str, span_id: str, parent_id: Optional[str],
                 name: str, service: str, attrs: Optional[dict] = None,
                 store: Optional["TraceStore"] = None, collector=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.service = service
        self.start_ms = time.time() * 1000.0
        self.duration_ms: Optional[float] = None
        self.attrs = dict(attrs or {})
        self._t0 = time.monotonic()
        self._store = store
        self._collector = collector

    def to_json(self) -> dict:
        return {"traceId": self.trace_id, "spanId": self.span_id,
                "parentId": self.parent_id, "name": self.name,
                "service": self.service,
                "startMs": round(self.start_ms, 3),
                "durationMs": None if self.duration_ms is None
                else round(self.duration_ms, 3),
                "attrs": self.attrs}

    def finish(self) -> None:
        if self.duration_ms is not None:
            return                       # idempotent (double __exit__)
        self.duration_ms = (time.monotonic() - self._t0) * 1000.0
        j = self.to_json()
        if self._store is not None:
            self._store.add_json(j)
        if self._collector is not None:
            self._collector.append(j)

    def collected(self) -> List[dict]:
        """Finished spans of this span's request-local collector (the data
        node's response payload); empty unless opened with collect=True."""
        return list(self._collector) if self._collector is not None else []


# ---------------------------------------------------------------------------
# Thread-local current-span stack
# ---------------------------------------------------------------------------

_TLS = threading.local()


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def current_span() -> Optional[Span]:
    st = getattr(_TLS, "stack", None)
    return st[-1] if st else None


class _NullCtx:
    """Inactive span context — tracing off / no root open."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class _SpanCtx:
    __slots__ = ("_span",)

    def __init__(self, s: Span):
        self._span = s

    def __enter__(self) -> Span:
        _stack().append(self._span)
        return self._span

    def __exit__(self, et, ev, tb):
        st = _stack()
        if st and st[-1] is self._span:
            st.pop()
        elif self._span in st:       # unbalanced exit: still unwind
            st.remove(self._span)
        if et is not None:
            self._span.attrs.setdefault("error", f"{et.__name__}: {ev}")
        self._span.finish()
        return False


class _AttachCtx:
    """Re-activate an EXISTING span on this thread (no finish on exit) —
    the broker's scatter workers parent their per-node spans this way."""
    __slots__ = ("_span",)

    def __init__(self, s: Span):
        self._span = s

    def __enter__(self) -> Span:
        _stack().append(self._span)
        return self._span

    def __exit__(self, *exc):
        st = _stack()
        if st and st[-1] is self._span:
            st.pop()
        elif self._span in st:
            st.remove(self._span)
        return False


def attach(s: Optional[Span]):
    return _AttachCtx(s) if s is not None else _NULL_CTX


def span(name: str, **attrs):
    """Child span under the current span; a no-op context when no trace is
    active on this thread (the one thread-local read untraced paths pay)."""
    parent = current_span()
    if parent is None:
        return _NULL_CTX
    return _SpanCtx(Span(
        trace_id=parent.trace_id, span_id=_new_id(),
        parent_id=parent.span_id, name=name, service=parent.service,
        attrs=attrs, store=parent._store, collector=parent._collector))


def span_when(cond: bool, name: str, **attrs):
    """`span(name)` when `cond`, else the inactive context: a site whose
    span is conditional opens it without duplicating the call in an
    if/else."""
    return span(name, **attrs) if cond else _NULL_CTX


def trace_enabled(query) -> bool:
    v = query.context_map.get(TRACE_KEY, True)
    return str(v).strip().lower() not in ("0", "false", "no")


def root_span(name: str, query=None, service: str = "", store=None,
              collect: bool = False, **attrs):
    """Open a trace root for a query (trace id = queryId), re-rooting under
    a remote parent when the query context carries a traceparent stamp.
    When a trace is ALREADY active on this thread (the lifecycle opened the
    root and the broker re-enters), this degrades to a plain child span.
    Inactive (_NULL_CTX) when the query opts out via {"trace": false}."""
    if query is not None and not trace_enabled(query):
        return _NULL_CTX
    if current_span() is not None:
        return span(name, **attrs)
    ctxm = query.context_map if query is not None else {}
    parent_id = None
    tp = ctxm.get(TRACEPARENT_KEY)
    if isinstance(tp, str) and ":" in tp:
        trace_id, parent_id = tp.rsplit(":", 1)
    else:
        qid = ctxm.get("queryId")
        trace_id = str(qid) if qid else _new_id()
    if query is not None:
        attrs.setdefault("queryType", getattr(query, "query_type", ""))
        attrs.setdefault("dataSource", getattr(query, "datasource", ""))
    st = store if store is not None else trace_store()
    # the collector rides back in the response payload — bound it like the
    # store bounds a trace, or a span-heavy query bloats every reply
    return _SpanCtx(Span(
        trace_id=trace_id, span_id=_new_id(), parent_id=parent_id,
        name=name, service=service, attrs=attrs, store=st,
        collector=collections.deque(maxlen=st.max_spans_per_trace)
        if collect else None))


def with_traceparent(query, s: Span):
    """Copy of `query` whose context carries this span as the remote
    parent — what the broker POSTs to a data node."""
    from dataclasses import replace
    ctx = dict(query.context_map)
    ctx[TRACEPARENT_KEY] = f"{s.trace_id}:{s.span_id}"
    return replace(query, context=tuple(sorted(ctx.items())))


# ---------------------------------------------------------------------------
# TraceStore: bounded per-process ring buffer of assembled traces
# ---------------------------------------------------------------------------

class TraceStore:
    """trace id -> span list, LRU-by-creation ring: the oldest trace is
    evicted when `max_traces` is exceeded; spans beyond
    `max_spans_per_trace` are counted, not kept (a runaway span producer
    must not eat the process). Span ids dedupe — a data node sharing this
    process with the broker (in-process tests) records spans locally AND
    ships them back in the response; both paths land once."""

    def __init__(self, max_traces: int = 256,
                 max_spans_per_trace: int = 2048):
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        self._lock = threading.Lock()
        self._traces: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()

    def add(self, s: Span) -> None:
        self.add_json(s.to_json())

    def add_json(self, j: dict) -> None:
        tid = j.get("traceId")
        sid = j.get("spanId")
        if not tid or not sid:
            return
        with self._lock:
            t = self._traces.get(tid)
            if t is None:
                t = self._traces[tid] = {"spans": [], "ids": set(),
                                         "dropped": 0}
                while len(self._traces) > self.max_traces:
                    self._traces.popitem(last=False)
            if sid in t["ids"]:
                return
            if len(t["spans"]) >= self.max_spans_per_trace:
                t["dropped"] += 1
                return
            t["ids"].add(sid)
            t["spans"].append(j)

    def ingest(self, spans) -> None:
        """Add remote span dicts (a data node's response payload)."""
        for j in spans or ():
            if isinstance(j, dict):
                self.add_json(j)

    def get(self, trace_id: str) -> Optional[dict]:
        """The assembled trace, spans sorted by start time; None when the
        id is unknown (or already evicted)."""
        with self._lock:
            t = self._traces.get(trace_id)
            if t is None:
                return None
            spans = sorted(t["spans"],
                           key=lambda s: (s.get("startMs") or 0.0))
            return {"traceId": trace_id, "spanCount": len(spans),
                    "droppedSpans": t["dropped"], "spans": spans}

    def spans(self, trace_id: str) -> List[dict]:
        got = self.get(trace_id)
        return got["spans"] if got else []

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()


_STORE = TraceStore()


def trace_store() -> TraceStore:
    """The process-wide default store (every node type in this process)."""
    return _STORE


# ---------------------------------------------------------------------------
# Phase attribution -> per-query metrics
# ---------------------------------------------------------------------------

def spans_under(spans, root_span_id: Optional[str]) -> List[dict]:
    """The spans of ONE run: the root plus everything reachable from it by
    parentage. A client may legally reuse a queryId, landing several runs'
    spans in one store entry — per-run metrics must not sum across runs."""
    if root_span_id is None:
        return list(spans)
    children: Dict[Optional[str], List[dict]] = {}
    for s in spans:
        children.setdefault(s.get("parentId"), []).append(s)
    out = [s for s in spans if s.get("spanId") == root_span_id]
    stack = [root_span_id]
    while stack:
        for s in children.get(stack.pop(), ()):
            out.append(s)
            stack.append(s.get("spanId"))
    return out


def phase_breakdown(spans) -> Dict[str, float]:
    """Total duration per span name — the slow-query log's payload.
    Wire-ingested span dicts are unvalidated: nameless ones are skipped."""
    out: Dict[str, float] = {}
    for s in spans:
        d = s.get("durationMs")
        name = s.get("name")
        if d is not None and name:
            out[name] = round(out.get(name, 0.0) + d, 3)
    return out


def emit_trace_metrics(emitter, query, qid: str, spans) -> None:
    """Druid-authentic per-query phase metrics derived from the assembled
    trace: query/stage/h2d/time (device-pool cold staging) and
    query/node/time (per data-node wait). Emitted once per query — phases
    that did not occur (cache-hit runs) emit nothing, which is itself the
    signal. (The reference's query/compile/time has no counterpart here:
    no span times a compile.)"""
    base = dict(dataSource=query.datasource, type=query.query_type, id=qid)
    h2d_ms = sum(s["durationMs"] for s in spans
                 if s.get("name") == H2D_SPAN
                 and s.get("durationMs") is not None)
    if h2d_ms:
        emitter.metric("query/stage/h2d/time", h2d_ms, **base)
    for s in spans:
        if s.get("name") == NODE_SPAN and s.get("durationMs") is not None:
            emitter.metric("query/node/time", s["durationMs"],
                           server=str(s.get("attrs", {}).get("server", "")),
                           **base)
