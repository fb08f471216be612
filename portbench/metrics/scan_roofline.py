"""Kernels: the least time of the queries answered inside the traced
slice (their logical input bytes, `roofline.logical_bytes`, at the
card's peak memory rate) over the profiler's kernel time in the
slice."""
from portbench import roofline
from portbench.metrics import _slice


def read(run):
    t = run.trace
    done = _slice.answered(run)
    peak = roofline.PEAK_BYTES_PER_S.get(run.device_name)
    if t is None or not t.kernels or not done or peak is None:
        return None
    least = sum(run.queries[r["index"]].logical_bytes for r in done) / peak
    return 100.0 * least / t.kernel_s
