"""90th percentile (nearest rank) of the latencies of the queries the
window sent (as `query_p50_ms`); a query that failed counts as
infinite."""
from portbench.harness import percentile


def read(run):
    failed = [r for r in run.sent_in_window() if r["status"] != 200]
    xs = run.latencies_ms() + [float("inf")] * len(failed)
    return percentile(xs, 90) if xs else None
