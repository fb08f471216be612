"""What every generator shares: the calendar, the week segments and the
per-segment random stream.

Rows are spread evenly over the days of the data's range (`rows_per_day`
rows each day), so every full week segment holds the same number of rows
and the rows an interval covers are counted from the calendar alone.
"""
from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

DAY_MS = 86_400_000
_EPOCH = _dt.date(1970, 1, 1)


def day_of(iso: str) -> int:
    """Days since 1970-01-01 of an ISO date ("1992-01-01")."""
    return (_dt.date.fromisoformat(iso[:10]) - _EPOCH).days


def iso_of(day: int) -> str:
    return (_EPOCH + _dt.timedelta(days=int(day))).isoformat()


def year_starts(first_year: int = 1970, last_year: int = 2100
                ) -> List[int]:
    return [(_dt.date(y, 1, 1) - _EPOCH).days
            for y in range(first_year, last_year + 1)]


def month_starts(first_year: int = 1970, last_year: int = 2100
                 ) -> List[int]:
    return [(_dt.date(y, m, 1) - _EPOCH).days
            for y in range(first_year, last_year + 1) for m in range(1, 13)]


@dataclass(frozen=True)
class SegmentSpec:
    """One segment: its index, the data days it holds [day0, day1) and
    its interval in epoch ms (the whole granularity period)."""
    index: int
    day0: int
    day1: int
    start_ms: int
    end_ms: int


def week_start(day: int) -> int:
    """Monday on or before `day` (ISO weeks, as Druid's WEEK)."""
    return day - (day - 4) % 7          # 1970-01-05 was a Monday


def layout(cfg: dict) -> List[SegmentSpec]:
    """The configuration's segments in time order."""
    gran = cfg["segment_granularity"]
    if gran != "week":
        raise ValueError(f"segment granularity {gran!r} is not supported")
    first, last = day_of(cfg["first_day"]), day_of(cfg["last_day"])
    out, w = [], week_start(first)
    while w <= last:
        d0, d1 = max(w, first), min(w + 7, last + 1)
        out.append(SegmentSpec(len(out), d0, d1, w * DAY_MS,
                               (w + 7) * DAY_MS))
        w += 7
    return out


def rows_per_day(cfg: dict) -> int:
    days = day_of(cfg["last_day"]) - day_of(cfg["first_day"]) + 1
    return max(1, int(cfg["scale_factor"] * cfg["rows_per_sf"]) // days)


def total_rows(cfg: dict) -> int:
    return sum((s.day1 - s.day0) for s in layout(cfg)) * rows_per_day(cfg)


def rows_in_intervals(cfg: dict, intervals: Sequence[Tuple[int, int]]
                      ) -> int:
    """Rows whose time lies in any of the [start, end) ms intervals (the
    intervals must not overlap). Every row of a day has that day's
    midnight as its time."""
    first, last = day_of(cfg["first_day"]), day_of(cfg["last_day"])
    n = 0
    for a, b in intervals:
        d0 = max(first, -(-a // DAY_MS))          # first midnight >= a
        d1 = min(last + 1, -(-b // DAY_MS))       # first midnight >= b
        n += max(0, d1 - d0)
    return n * rows_per_day(cfg)


def generator(seed: int, segment: int, device) -> torch.Generator:
    """The random stream of one segment: the same (seed, segment) gives
    the same stream, whatever other segments were made first."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + segment * 7_919 + 17)
                  % (2 ** 63 - 1))
    return g


def randint(g: torch.Generator, low: int, high: int, n: int,
            device) -> torch.Tensor:
    """n int64 draws, uniform in [low, high)."""
    return torch.randint(low, high, (n,), generator=g, device=device,
                         dtype=torch.int64)


def day_rows(spec: SegmentSpec, per_day: int, device) -> torch.Tensor:
    """Each row's day number, `per_day` rows a day, in time order."""
    days = torch.arange(spec.day0, spec.day1, device=device,
                        dtype=torch.int64)
    return days.repeat_interleave(per_day)


def retail_cents(partkey: torch.Tensor) -> torch.Tensor:
    """dbgen's P_RETAILPRICE in cents: 90000 + (pk/10 mod 20001) +
    100 (pk mod 1000)."""
    return 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1_000)


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A fixed scramble of non-negative int64 keys into [0, 2^32): stands
    in for dbgen's per-key random attributes, the same on every run."""
    x = (x * 0x9E3779B1) & 0xFFFFFFFF
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    return x ^ (x >> 13)


@dataclass
class Columns:
    """One segment's generated columns, on the device that made them.
    `dims` maps a name to (int64 ids into `values`, the schema's value
    list); the ids index the schema's list, not a per-segment one."""
    spec: SegmentSpec
    time_day: torch.Tensor
    dims: dict
    metrics: dict          # name -> (value type, tensor)

    @property
    def n_rows(self) -> int:
        return int(self.time_day.numel())
