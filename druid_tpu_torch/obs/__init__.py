"""Observability: distributed query tracing (qtrace), device-dispatch
accounting, the metrics catalog and the Prometheus exposition sink. See
trace.py for the span model and propagation contract, dispatch.py for the
dispatch counter, catalog.py for the declared metric names and
prometheus.py for /metrics."""
from druid_tpu_torch.obs.catalog import METRICS, render_table
from druid_tpu_torch.obs.dispatch import DispatchMonitor, DispatchStats
from druid_tpu_torch.obs.prometheus import MetricRegistry
from druid_tpu_torch.obs.trace import (H2D_SPAN, NODE_SPAN, Span, TraceStore,
                                       attach, current_span,
                                       emit_trace_metrics, phase_breakdown,
                                       root_span, span, trace_enabled,
                                       trace_store, with_traceparent)

__all__ = [
    "METRICS", "render_table", "MetricRegistry",
    "DispatchMonitor", "DispatchStats",
    "H2D_SPAN", "NODE_SPAN", "Span", "TraceStore",
    "attach", "current_span", "emit_trace_metrics", "phase_breakdown",
    "root_span", "span", "trace_enabled", "trace_store", "with_traceparent",
]
