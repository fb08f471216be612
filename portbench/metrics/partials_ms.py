"""Engine: the `engine/partials` spans of one query summed over both data
nodes; median over the window's queries. The span ends after batching
has copied the partial states to the host, so it holds the device's
time."""
from portbench.metrics import _spans


def read(run):
    return _spans.median_total(run, "engine/partials")
