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

    def contains(self, ms: int) -> bool:
        return self.start <= ms < self.end

    def intersect(self, other: "Interval") -> Optional["Interval"]:
        s, e = max(self.start, other.start), min(self.end, other.end)
        if s >= e:
            return None
        return Interval(s, e)

    def contains_interval(self, other: "Interval") -> bool:
        return self.start <= other.start and other.end <= self.end

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


_PERIOD_RE = re.compile(
    r"^P(?:(?P<y>\d+)Y)?(?:(?P<mo>\d+)M)?(?:(?P<w>\d+)W)?(?:(?P<d>\d+)D)?"
    r"(?:T(?:(?P<h>\d+)H)?(?:(?P<m>\d+)M)?(?:(?P<s>\d+)S)?)?$")

#: chunk-count ceiling for split_by_period: beyond it splitting is pure
#: overhead (an eternity-scale interval would try ~10^11 edges)
MAX_PERIOD_CHUNKS = 4096


def parse_period_ms(period) -> int:
    """ISO-8601 duration ('P1D', 'PT6H', 'P1W', 'P1M') or plain millis ->
    milliseconds. Calendar units approximate (month = 30 d, year = 365 d):
    the only consumer sizes chunks, and results do not depend on where a
    query's intervals are split."""
    if isinstance(period, bool):
        raise TypeError("bool is not a period")
    if isinstance(period, (int, float)):
        return int(period)
    m = _PERIOD_RE.match(str(period).strip().upper())
    if not m or not any(m.groups()):
        raise ValueError(f"cannot parse period {period!r}")
    g = {k: int(v) if v else 0 for k, v in m.groupdict().items()}
    days = g["y"] * 365 + g["mo"] * 30 + g["w"] * 7 + g["d"]
    return ((days * 24 + g["h"]) * 60 + g["m"]) * 60_000 + g["s"] * 1000


def split_by_period(interval: Interval, period_ms: int,
                    origin_ms: int = 0) -> List[Interval]:
    """Split one interval at period boundaries aligned to `origin_ms` (the
    reference's IntervalChunkingQueryRunner). An interval that would give
    more than MAX_PERIOD_CHUNKS chunks (eternity) passes through whole."""
    if period_ms <= 0 or interval.width <= period_ms \
            or interval.width // period_ms > MAX_PERIOD_CHUNKS:
        return [interval]
    edges = [interval.start]
    b = ((interval.start - origin_ms) // period_ms + 1) * period_ms \
        + origin_ms
    while b < interval.end:
        edges.append(b)
        b += period_ms
    edges.append(interval.end)
    return [Interval(a, b) for a, b in zip(edges, edges[1:]) if b > a]


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
