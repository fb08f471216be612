"""Batching: segments run over runs made in the window, a stacked run of
K segments counting one run and a segment run alone one run
(`BatchStats`)."""


def read(run):
    b = run.batches
    runs = b.get("batches", 0) + b.get("fallbackSegments", 0)
    if not runs:
        return None
    return (b.get("batchedSegments", 0) + b.get("fallbackSegments", 0)) \
        / runs
