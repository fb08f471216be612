"""Kernels: the least time of the queries answered inside the traced
slice (their logical input bytes, `roofline.logical_bytes`, at one
card's peak memory rate) over the profiler's kernel time in the slice
summed over the cards: a share of the cards' combined bandwidth, which
several cards cannot take over 100%."""
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
