"""MetricRegistry: a Prometheus text-exposition sink for the emitter chain
(the port's own copy of the reference package's `obs/prometheus.py`).

Reference analog: the statsd/prometheus emitter extensions — a sink that
turns the event stream into a scrapeable surface, so any node type answers
GET /metrics without new plumbing (cluster/dataserver.py and
server/http.py serve `exposition()`).

Model: last-value gauges keyed by (metric, label set). High-cardinality
labels (the per-query `id`) are dropped before keying so series stay
bounded; `max_series` hard-caps the table and counts what it refused.
Exposition follows the text format v0.0.4: HELP/TYPE per metric (help text
from obs/catalog.py), one sample line per label set, deterministic order.
"""
from __future__ import annotations

import re
import threading
from typing import Dict, Tuple

from druid_tpu_torch.obs import catalog
from druid_tpu_torch.utils.emitter import Emitter

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: per-query/per-segment dims whose values are unbounded — dropped from
#: series keys so a query storm cannot blow the registry
DEFAULT_DROP_LABELS = frozenset({"id", "segment"})

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")


def metric_name(name: str) -> str:
    """'query/batch/fillRatio' -> 'druid_query_batch_fillRatio'."""
    return "druid_" + _NAME_BAD.sub("_", name)


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt(v: float) -> str:
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def compose_sink(emitter, registry: "MetricRegistry"):
    """Chain `registry` onto a caller-owned emitter's sink IN PLACE and
    return a restore() undoing it. The restore is identity-guarded: it
    only un-wraps if the sink is still the one installed here, so server
    generations sharing one emitter can stop() in any order without
    clobbering each other's chains."""
    from druid_tpu_torch.utils.emitter import ComposingEmitter
    prev = emitter.sink
    emitter.sink = ComposingEmitter([prev, registry])
    installed = emitter.sink

    def restore() -> None:
        if emitter.sink is installed:
            emitter.sink = prev
    return restore


class MetricRegistry(Emitter):
    """Emitter sink exposing the latest value per (metric, labels)."""

    def __init__(self, max_series: int = 4096,
                 drop_labels=DEFAULT_DROP_LABELS):
        self.max_series = max_series
        self.drop_labels = frozenset(drop_labels)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] \
            = {}
        self._dropped_series = 0

    def emit(self, event) -> None:
        if event.kind != "metric":
            return
        try:
            value = float(event.value)
        except (TypeError, ValueError):
            return
        labels = tuple(sorted(
            (_LABEL_BAD.sub("_", str(k)), str(v))
            for k, v in event.dims.items() if k not in self.drop_labels))
        key = (event.metric, labels)
        with self._lock:
            if key not in self._series \
                    and len(self._series) >= self.max_series:
                self._dropped_series += 1
                return
            # gauge semantics: the latest value per series wins by
            # design — the miss check above only enforces the cap
            self._series[key] = value

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def exposition(self) -> str:
        """Prometheus text format, deterministically ordered."""
        with self._lock:
            items = sorted(self._series.items())
            dropped = self._dropped_series
        out = []
        last_metric = None
        for (metric, labels), value in items:
            if metric != last_metric:
                pname = metric_name(metric)
                out.append(f"# HELP {pname} {catalog.help_for(metric)}")
                out.append(f"# TYPE {pname} gauge")
                last_metric = metric
            else:
                pname = metric_name(metric)
            if labels:
                lbl = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
                out.append(f"{pname}{{{lbl}}} {_fmt(value)}")
            else:
                out.append(f"{pname} {_fmt(value)}")
        if dropped:
            out.append("# HELP druid_metric_registry_dropped_series series "
                       "refused by the max_series cap")
            out.append("# TYPE druid_metric_registry_dropped_series gauge")
            out.append(f"druid_metric_registry_dropped_series {dropped}")
        return "\n".join(out) + "\n"
