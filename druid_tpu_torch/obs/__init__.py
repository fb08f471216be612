"""Observability: distributed query tracing (qtrace) and device-dispatch
accounting. See trace.py for the span model and propagation contract and
dispatch.py for the dispatch counter. The reference's metrics catalog and
Prometheus sink come with the HTTP server."""
from druid_tpu_torch.obs.dispatch import DispatchMonitor, DispatchStats
from druid_tpu_torch.obs.trace import (H2D_SPAN, NODE_SPAN, Span, TraceStore,
                                       attach, current_span,
                                       emit_trace_metrics, phase_breakdown,
                                       root_span, span, trace_enabled,
                                       trace_store, with_traceparent)

__all__ = [
    "DispatchMonitor", "DispatchStats",
    "H2D_SPAN", "NODE_SPAN", "Span", "TraceStore",
    "attach", "current_span", "emit_trace_metrics", "phase_breakdown",
    "root_span", "span", "trace_enabled", "trace_store", "with_traceparent",
]
