"""Query granularities: time bucketing.

Capability parity with the reference's Granularity/Granularities
(java-util/src/main/java/org/apache/druid/java/util/common/granularity/).
Design difference (TPU-first): a granularity compiles to *bucket ids* — an
int32 array mapping each row to a dense bucket index for a query interval —
so that on-device aggregation is one `segment_sum` with a static bucket count,
instead of the reference's per-bucket cursor
(processing/.../segment/QueryableIndexStorageAdapter.java makeCursors).

Uniform (fixed-period) granularities bucket on-device from the segment's
int32 time-offset column; calendar granularities (month/quarter/year) are
bucketed host-side with vectorized numpy datetime64 arithmetic.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import numpy as np

from druid_tpu_torch.utils.intervals import Interval

MS_SECOND = 1000
MS_MINUTE = 60 * MS_SECOND
MS_HOUR = 60 * MS_MINUTE
MS_DAY = 24 * MS_HOUR
MS_WEEK = 7 * MS_DAY
# 1969-12-29 was a Monday; weeks bucket to Monday boundaries like Joda/Druid.
WEEK_ORIGIN_MS = -3 * MS_DAY


class GranularityType(enum.Enum):
    ALL = "all"
    NONE = "none"  # millisecond granularity
    SECOND = "second"
    MINUTE = "minute"
    FIVE_MINUTE = "five_minute"
    TEN_MINUTE = "ten_minute"
    FIFTEEN_MINUTE = "fifteen_minute"
    THIRTY_MINUTE = "thirty_minute"
    HOUR = "hour"
    SIX_HOUR = "six_hour"
    DAY = "day"
    WEEK = "week"
    MONTH = "month"
    QUARTER = "quarter"
    YEAR = "year"


_UNIFORM_MS = {
    GranularityType.NONE: 1,
    GranularityType.SECOND: MS_SECOND,
    GranularityType.MINUTE: MS_MINUTE,
    GranularityType.FIVE_MINUTE: 5 * MS_MINUTE,
    GranularityType.TEN_MINUTE: 10 * MS_MINUTE,
    GranularityType.FIFTEEN_MINUTE: 15 * MS_MINUTE,
    GranularityType.THIRTY_MINUTE: 30 * MS_MINUTE,
    GranularityType.HOUR: MS_HOUR,
    GranularityType.SIX_HOUR: 6 * MS_HOUR,
    GranularityType.DAY: MS_DAY,
    GranularityType.WEEK: MS_WEEK,
}

_CALENDAR_UNIT = {
    GranularityType.MONTH: "M",
    GranularityType.QUARTER: "M",  # 3-month groups, handled specially
    GranularityType.YEAR: "Y",
}


def _floor_div(a, b):
    return a // b  # python/numpy ints already floor-divide


@dataclass(frozen=True)
class Granularity:
    kind: GranularityType

    # ---- constructors -------------------------------------------------
    @staticmethod
    def of(name) -> "Granularity":
        if isinstance(name, Granularity):
            return name
        if isinstance(name, GranularityType):
            return Granularity(name)
        return Granularity(GranularityType(str(name).lower()))

    ALL: "Granularity" = None  # set below
    DAY: "Granularity" = None
    HOUR: "Granularity" = None

    # ---- properties ---------------------------------------------------
    @property
    def is_all(self) -> bool:
        return self.kind is GranularityType.ALL

    @property
    def is_uniform(self) -> bool:
        """True when buckets are fixed-width in millis (device-bucketable)."""
        return self.kind in _UNIFORM_MS

    @property
    def period_ms(self) -> Optional[int]:
        return _UNIFORM_MS.get(self.kind)

    @property
    def origin_ms(self) -> int:
        return WEEK_ORIGIN_MS if self.kind is GranularityType.WEEK else 0

    # ---- scalar ops ---------------------------------------------------
    def bucket_start(self, ms: int) -> int:
        """Truncate a timestamp to its bucket start."""
        if self.is_all:
            return ms
        if self.is_uniform:
            p, o = self.period_ms, self.origin_ms
            return _floor_div(ms - o, p) * p + o
        return int(self.bucket_start_array(np.asarray([ms], dtype=np.int64))[0])

    def bucket_start_array(self, ms: np.ndarray) -> np.ndarray:
        """Vectorized truncation to bucket starts (host-side)."""
        ms = np.asarray(ms, dtype=np.int64)
        if self.is_all:
            return ms
        if self.is_uniform:
            p, o = self.period_ms, self.origin_ms
            return (ms - o) // p * p + o
        dt = ms.astype("datetime64[ms]")
        if self.kind is GranularityType.YEAR:
            return dt.astype("datetime64[Y]").astype("datetime64[ms]").astype(np.int64)
        months = dt.astype("datetime64[M]")
        if self.kind is GranularityType.QUARTER:
            mi = months.astype(np.int64)
            months = ((mi // 3) * 3).astype("datetime64[M]")
        return months.astype("datetime64[ms]").astype(np.int64)

    def next_bucket(self, bucket_start_ms: int) -> int:
        if self.is_all:
            raise ValueError("ALL granularity has one unbounded bucket")
        if self.is_uniform:
            return bucket_start_ms + self.period_ms
        dt = np.int64(bucket_start_ms).astype("datetime64[ms]")
        if self.kind is GranularityType.YEAR:
            nxt = (dt.astype("datetime64[Y]") + 1).astype("datetime64[ms]")
        elif self.kind is GranularityType.QUARTER:
            nxt = (dt.astype("datetime64[M]") + 3).astype("datetime64[ms]")
        else:
            nxt = (dt.astype("datetime64[M]") + 1).astype("datetime64[ms]")
        return int(nxt.astype(np.int64))

    # ---- bucket enumeration for a query interval ----------------------
    def bucket_starts(self, interval: Interval) -> np.ndarray:
        """All bucket start timestamps whose bucket overlaps `interval`.

        For ALL, returns a single entry = interval.start (one global bucket),
        mirroring the reference's AllGranularity cursor behavior.
        """
        if self.is_all:
            return np.asarray([interval.start], dtype=np.int64)
        first = self.bucket_start(interval.start)
        if self.is_uniform:
            p = self.period_ms
            n = (interval.end - first + p - 1) // p
            n = max(int(n), 0)
            return first + np.arange(n, dtype=np.int64) * p
        starts = []
        cur = first
        while cur < interval.end:
            starts.append(cur)
            cur = self.next_bucket(cur)
        return np.asarray(starts, dtype=np.int64)

    def num_buckets(self, interval: Interval) -> int:
        return int(len(self.bucket_starts(interval)))

    def bucket_ids(self, ms: np.ndarray, interval: Interval) -> np.ndarray:
        """Map timestamps to dense bucket indices within `interval` (host path).

        Out-of-interval rows map to -1 (they must be masked out anyway).
        """
        ms = np.asarray(ms, dtype=np.int64)
        if self.is_all:
            ids = np.zeros(ms.shape, dtype=np.int32)
        else:
            starts = self.bucket_starts(interval)
            trunc = self.bucket_start_array(ms)
            ids = np.searchsorted(starts, trunc).astype(np.int32)
            ids[(trunc < starts[0]) | (trunc > starts[-1])] = -1
        ids[(ms < interval.start) | (ms >= interval.end)] = -1
        return ids

    def __str__(self):
        return self.kind.value


# canonical instances
Granularity.ALL = Granularity(GranularityType.ALL)
Granularity.DAY = Granularity(GranularityType.DAY)
Granularity.HOUR = Granularity(GranularityType.HOUR)
