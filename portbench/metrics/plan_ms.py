"""Planning: each query's `engine/plan` spans (the host planning of its
runs: the query's segments and key dimensions, each segment's plan, the
shape buckets, each run's strategy) summed over both data nodes; median
over the window's queries."""
from portbench.metrics import _spans


def read(run):
    return _spans.median_total(run, "engine/plan")
