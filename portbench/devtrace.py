"""A slice of the window traced by `torch.profiler` (CPU and CUDA): the
device's busy time, its kernels by name and its idle gaps, each gap named
by the host operation running at its middle."""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch


@dataclass
class DeviceTrace:
    window: Tuple[float, float]           # wall clock s of the slice
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    copies: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def kernel_s(self) -> float:
        return sum(d for _, _, d in self.kernels)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """Union of the device's operations (kernels, copies, sets), in
        the profiler's clock (s)."""
        spans = sorted((s, s + d) for _, s, d in self.kernels + self.copies)
        out: List[List[float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return min(self.window_s,
                   sum(b - a for a, b in self.busy_intervals()))

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for name, _, d in self.kernels + self.copies:
            name = short_name(name)
            by_name[name] = by_name.get(name, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        gaps = sorted(((busy[i][1], busy[i + 1][0])
                       for i in range(len(busy) - 1)),
                      key=lambda g: g[0] - g[1])[:top]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        named = []
        for a, b in gaps:
            mid = (a + b) / 2
            label = "no host operation traced"
            # the latest-starting host operation that covers the middle
            for j in range(bisect.bisect_right(starts, mid) - 1,
                           max(-1, bisect.bisect_right(starts, mid) - 4000),
                           -1):
                name, s, d = host[j]
                if s + d >= mid:
                    label = name
                    break
            named.append([short_name(label), b - a])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without its return type, cut to `limit`
    characters (template arguments run to thousands)."""
    name = name[5:] if name.startswith("void ") else name
    return name[:limit]


def _event_fields(e):
    name = e.name()
    start = e.start_ns() / 1e9 if hasattr(e, "start_ns") \
        else e.start_us() / 1e6
    dur = e.duration_ns() / 1e9 if hasattr(e, "duration_ns") \
        else e.duration_us() / 1e6
    return name, start, dur


def record(start: float, seconds: float, device) -> DeviceTrace:
    """Sleep until the wall-clock time `start`, then profile the process
    for `seconds`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    wait = start - time.time()
    if wait > 0:
        time.sleep(wait)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    try:
        # the program's threads (HTTP handlers, the broker's scatter pool)
        # exist before the slice starts: trace them all
        from torch._C._profiler import _ExperimentalConfig
        prof = profile(activities=activities, experimental_config=
                       _ExperimentalConfig(profile_all_threads=True))
    except TypeError:
        prof = profile(activities=activities)
    prof.start()
    t0 = time.time()
    time.sleep(seconds)
    t1 = time.time()
    prof.stop()
    out = DeviceTrace((t0, t1))
    for e in prof.profiler.kineto_results.events():
        name, s, d = _event_fields(e)
        if e.device_type() == DeviceType.CUDA:
            low = name.lower()
            (out.copies if low.startswith(("memcpy", "memset"))
             else out.kernels).append((name, s, d))
        else:
            out.host.append((name, s, d))
    return out
