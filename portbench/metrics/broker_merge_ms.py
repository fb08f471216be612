"""Broker: the `broker/merge` span of each query (the merge of the data
nodes' partials and the finish); median over the window's queries."""
from portbench.metrics import _spans


def read(run):
    return _spans.median_total(run, "broker/merge")
