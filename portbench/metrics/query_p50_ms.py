"""Median latency of the queries the window sent, all clients together,
from the send to the reply's last byte on the client's clock. Those in
flight at the close are waited for and count: leaving them out would
leave out the slowest queries of the mix, which are the likeliest to be
in flight."""
from portbench.harness import median


def read(run):
    return median(run.latencies_ms())
