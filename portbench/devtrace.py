"""A slice of the window traced by `torch.profiler` (CPU and CUDA): each
card's busy time, the kernels by name and the idle gaps, each gap named
by the host operation running at its middle.

The profiler starts before the window's start is fixed (`Recorder`: its
start holds the process for seconds) and stops at the slice's end; only
the events inside the slice count, each cut to it (`clip`). The CUDA
events are split by card (`device_index`): a card's busy time is the
union of its own operations, `busy_s` the mean over the layout's cards,
and `kernel_s` the kernels' time summed over every card."""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

#: a device operation: (name, start s, seconds, card)
Op = Tuple[str, float, float, int]


@dataclass
class DeviceTrace:
    window: Tuple[float, float]           # wall clock s of the slice
    kernels: List[Op] = field(default_factory=list)
    copies: List[Op] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    cards: Tuple[int, ...] = (0,)         # the layout's cards

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def kernel_s(self) -> float:
        """The kernels' time summed over every card."""
        return sum(op[2] for op in self.kernels)

    def busy_intervals(self, card: int) -> List[Tuple[float, float]]:
        """Union of `card`'s operations (kernels, copies, sets), in the
        profiler's clock (s)."""
        return union((s, s + d) for _, s, d, c in self.kernels + self.copies
                     if c == card)

    def card_busy_s(self, card: int) -> float:
        return min(self.window_s,
                   sum(b - a for a, b in self.busy_intervals(card)))

    @property
    def busy_s(self) -> float:
        """The mean over the layout's cards of each card's busy time."""
        return sum(map(self.card_busy_s, self.cards)) / len(self.cards)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations with most time, summed over the cards,
        and the longest idle gaps between a card's operations, named
        "cardN <host operation>" where the layout has several cards."""
        by_name: Dict[str, float] = {}
        for name, _, d, _ in self.kernels + self.copies:
            name = short_name(name)
            by_name[name] = by_name.get(name, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        for card in self.cards:
            busy = self.busy_intervals(card)
            gaps += [(busy[i][1], busy[i + 1][0], card)
                     for i in range(len(busy) - 1)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        prefix = len(self.cards) > 1
        named = []
        for a, b, card in gaps:
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
            label = short_name(label)
            named.append([f"card{card} {label}" if prefix else label,
                          b - a])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def union(intervals) -> List[Tuple[float, float]]:
    """Sorted disjoint (start, end) pairs covering `intervals`."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(events, window: Tuple[float, float]) -> list:
    """The events (name, start, seconds, ...) that meet `window`, each cut
    to it."""
    lo, hi = window
    out = []
    for ev in events:
        a, b = max(ev[1], lo), min(ev[1] + ev[2], hi)
        if b >= a:
            out.append((ev[0], a, b - a) + tuple(ev[3:]))
    return out


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


class Recorder:
    """The profiler over the process's threads, started on construction;
    `stop` ends it at a slice's end and keeps what lies inside the
    slice."""

    def __init__(self, kind: str):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if kind == "cuda":
            activities.append(ProfilerActivity.CUDA)
        try:
            # the program's threads (HTTP handlers, the broker's scatter
            # pool) exist before the profile starts: trace them all
            from torch._C._profiler import _ExperimentalConfig
            self.prof = profile(activities=activities, experimental_config=
                                _ExperimentalConfig(profile_all_threads=True))
        except TypeError:
            self.prof = profile(activities=activities)
        self.prof.start()

    def stop(self, window: Tuple[float, float],
             cards: Sequence[int]) -> DeviceTrace:
        """Sleep until the wall-clock end of `window`, stop, and return
        the events inside it, the CUDA ones by card."""
        from torch.autograd import DeviceType
        wait = window[1] - time.time()
        if wait > 0:
            time.sleep(wait)
        self.prof.stop()
        kernels, copies, host = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            name, s, d = _event_fields(e)
            if e.device_type() == DeviceType.CUDA:
                (copies if name.lower().startswith(("memcpy", "memset"))
                 else kernels).append((name, s, d, int(e.device_index())))
            else:
                host.append((name, s, d))
        return DeviceTrace(window, clip(kernels, window),
                           clip(copies, window), clip(host, window),
                           tuple(cards))
