"""Kernels: the profiler's CUDA kernel time in the traced slice, summed
over the cards, over the queries answered inside it."""
from portbench.metrics import _slice


def read(run):
    t = run.trace
    done = _slice.answered(run)
    if t is None or not t.kernels or not done:
        return None
    return t.kernel_s * 1e3 / len(done)
