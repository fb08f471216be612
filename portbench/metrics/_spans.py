"""Span sums by query, for the span readers."""
from portbench.harness import median


def total(spans, name):
    ds = [s["durationMs"] for s in spans
          if s.get("name") == name and s.get("durationMs") is not None]
    return sum(ds) if ds else None


def median_total(run, name):
    out = [total(run.spans.get(r["qid"], ()), name) for r in run.completed()]
    return median([x for x in out if x is not None])
