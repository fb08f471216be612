"""The queries answered inside the traced slice of the window."""


def answered(run):
    if run.trace is None:
        return []
    a, b = run.trace.window
    return [r for r in run.completed() if a <= r["t_done"] <= b]
