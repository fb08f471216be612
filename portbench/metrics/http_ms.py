"""Serving: each query's client latency less its `broker/query` span (the
HTTP exchange, the lifecycle and the JSON reply); median over the
window's traced queries."""
from portbench.harness import median
from portbench.metrics import _spans


def read(run):
    out = []
    for r in run.completed():
        q = _spans.total(run.spans.get(r["qid"], ()), "broker/query")
        if q is not None:
            out.append((r["t_done"] - r["t_send"]) * 1e3 - q)
    return median(out)
