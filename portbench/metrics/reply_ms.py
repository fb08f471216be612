"""Serving: each query's `http/reply` span (the JSON reply's dump, its
headers and the socket write); median over the window's queries."""
from portbench.metrics import _spans


def read(run):
    return _spans.median_total(run, "http/reply")
