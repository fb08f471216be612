"""Device: the share of the traced slice of the window in which no
operation ran on a card (torch.profiler, CPU and CUDA), averaged over
the layout's cards."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
