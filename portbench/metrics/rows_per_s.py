"""Druid's scan rate: the rows in the intervals of every query of the
window, counted from the generated data before filters, over the
window's seconds. A query still in flight at the close counts the share
of its rows that its time inside the window bears to its whole time
(its work is spread over its latency), so that the rate does not jump
by a whole query at the close. A failed query counts 0."""


def read(run):
    a, b = run.window
    rows = 0.0
    for r in run.records:
        if r["status"] != 200 or r["t_done"] is None:
            continue
        share = 1.0 if r["t_done"] <= b else \
            max(0.0, b - r["t_send"]) / (r["t_done"] - r["t_send"])
        rows += run.queries[r["index"]].rows * share
    return rows / run.seconds
