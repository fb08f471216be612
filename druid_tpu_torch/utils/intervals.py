"""Time intervals in epoch milliseconds.

Equivalent role to org.joda.time.Interval as used throughout the reference
(e.g. common/src/main/java/org/apache/druid/timeline/VersionedIntervalTimeline.java).
All timestamps in the framework are UTC epoch millis (int64).
"""
from __future__ import annotations

import datetime as _dt
import re
from dataclasses import dataclass
from typing import Iterable, List, Optional

_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)

ETERNITY_START = -(2**62)
ETERNITY_END = 2**62


def parse_ts(value) -> int:
    """Parse a timestamp (ISO string / datetime / int millis) to epoch millis."""
    if isinstance(value, bool):
        raise TypeError("bool is not a timestamp")
    if isinstance(value, int):
        return value
    if isinstance(value, float):
        return int(value)
    if isinstance(value, _dt.datetime):
        if value.tzinfo is None:
            value = value.replace(tzinfo=_dt.timezone.utc)
        return int(value.timestamp() * 1000)
    if isinstance(value, str):
        s = value.strip()
        # eternity bounds round-trip through their own wire tokens —
        # an unbounded query serialized to a remote node must parse back
        if s == "-eternity":
            return ETERNITY_START
        if s in ("+eternity", "eternity"):
            return ETERNITY_END
        # Normalize bare date / missing tz
        m = re.match(r"^(\d{4})-(\d{2})-(\d{2})$", s)
        if m:
            d = _dt.datetime(int(m.group(1)), int(m.group(2)), int(m.group(3)),
                             tzinfo=_dt.timezone.utc)
            return int(d.timestamp() * 1000)
        if s.endswith("Z"):
            s = s[:-1] + "+00:00"
        d = _dt.datetime.fromisoformat(s)
        if d.tzinfo is None:
            d = d.replace(tzinfo=_dt.timezone.utc)
        return int(d.timestamp() * 1000)
    raise TypeError(f"cannot parse timestamp from {value!r}")


def ts_to_iso(ms: int) -> str:
    if ms <= ETERNITY_START:
        return "-eternity"
    if ms >= ETERNITY_END:
        return "+eternity"
    d = _EPOCH + _dt.timedelta(milliseconds=int(ms))
    return d.strftime("%Y-%m-%dT%H:%M:%S.") + f"{ms % 1000:03d}Z"


@dataclass(frozen=True, order=True)
class Interval:
    """Half-open [start, end) interval in epoch millis."""
    start: int
    end: int

    def __post_init__(self):
        if self.end < self.start:
            raise ValueError(f"end < start: {self}")

    @staticmethod
    def of(start, end) -> "Interval":
        return Interval(parse_ts(start), parse_ts(end))

    @staticmethod
    def parse(s: str) -> "Interval":
        a, b = s.split("/")
        return Interval.of(a, b)

    @staticmethod
    def eternity() -> "Interval":
        return Interval(ETERNITY_START, ETERNITY_END)

    def overlaps(self, other: "Interval") -> bool:
        return self.start < other.end and other.start < self.end

    def intersect(self, other: "Interval") -> Optional["Interval"]:
        s, e = max(self.start, other.start), min(self.end, other.end)
        if s >= e:
            return None
        return Interval(s, e)

    @property
    def width(self) -> int:
        return self.end - self.start

    def __str__(self) -> str:
        return f"{ts_to_iso(self.start)}/{ts_to_iso(self.end)}"


def condense(intervals: Iterable[Interval]) -> List[Interval]:
    """Merge overlapping/abutting intervals (JodaUtils.condenseIntervals analog)."""
    out: List[Interval] = []
    for iv in sorted(intervals, key=lambda i: (i.start, i.end)):
        if out and iv.start <= out[-1].end:
            if iv.end > out[-1].end:
                out[-1] = Interval(out[-1].start, iv.end)
        else:
            out.append(Interval(iv.start, iv.end))
    return out


def normalize_intervals(spec) -> List[Interval]:
    """Accept an Interval, 'start/end' string, or sequence of either."""
    if spec is None:
        return [Interval.eternity()]
    if isinstance(spec, Interval):
        return [spec]
    if isinstance(spec, str):
        return [Interval.parse(spec)]
    if isinstance(spec, (list, tuple)):
        out = []
        for item in spec:
            out.extend(normalize_intervals(item))
        return out
    raise TypeError(f"cannot normalize interval spec {spec!r}")
