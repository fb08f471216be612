"""VersionedIntervalTimeline: the MVCC (interval, version, partition) map
(the port's own copy of the reference package's `cluster/timeline.py`).

Capability parity with the reference's core data structure
(common/.../timeline/VersionedIntervalTimeline.java:68): atomic segment
replacement by version string, overshadowing, partition-chunk completeness,
interval splitting on lookup. In this package the broker's cluster view
(cluster/view.py) uses it; the coordinator and ingestion come later.

Semantics mirrored from the reference:
  * versions compare LEXICOGRAPHICALLY (they are timestamps in practice);
  * a (interval, version) entry becomes visible only when its partition set
    is complete (ShardSpec.complete_set);
  * for any instant, the visible entry is the highest-version complete entry
    whose interval covers it; lower versions show through where a higher
    version does NOT cover (partial overshadowing splits holders);
  * removing a chunk resurrects what it overshadowed.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Generic, List, Optional, Tuple, TypeVar

from druid_tpu_torch.cluster.shardspec import NoneShardSpec, ShardSpec
from druid_tpu_torch.utils.intervals import Interval, condense

T = TypeVar("T")


@dataclass(frozen=True)
class PartitionChunk(Generic[T]):
    shard_spec: ShardSpec
    obj: T

    @property
    def partition_num(self) -> int:
        return self.shard_spec.partition_num


class PartitionHolder(Generic[T]):
    """partition_num -> chunk (reference timeline/partition/PartitionHolder)."""

    def __init__(self):
        self.chunks: Dict[int, PartitionChunk[T]] = {}

    def add(self, chunk: PartitionChunk[T]):
        self.chunks[chunk.partition_num] = chunk

    def remove(self, partition_num: int) -> Optional[PartitionChunk[T]]:
        return self.chunks.pop(partition_num, None)

    def is_complete(self) -> bool:
        if not self.chunks:
            return False
        specs = [c.shard_spec for c in self.chunks.values()]
        return specs[0].complete_set(specs)

    def __iter__(self):
        return iter(sorted(self.chunks.values(),
                           key=lambda c: c.partition_num))

    def __len__(self):
        return len(self.chunks)


@dataclass(frozen=True)
class TimelineObjectHolder(Generic[T]):
    interval: Interval
    version: str
    partitions: Tuple[PartitionChunk[T], ...]

    def payloads(self) -> List[T]:
        return [c.obj for c in self.partitions]


class VersionedIntervalTimeline(Generic[T]):
    """Thread-safe MVCC timeline."""

    def __init__(self):
        # (interval, version) -> PartitionHolder
        self._entries: Dict[Tuple[Interval, str], PartitionHolder[T]] = {}
        self._lock = threading.RLock()

    # -- mutation --------------------------------------------------------
    def add(self, interval: Interval, version: str,
            chunk: PartitionChunk[T]):
        with self._lock:
            holder = self._entries.get((interval, version))
            if holder is None:
                holder = self._entries[(interval, version)] = PartitionHolder()
            holder.add(chunk)

    def remove(self, interval: Interval, version: str,
               partition_num: int = 0) -> Optional[PartitionChunk[T]]:
        with self._lock:
            holder = self._entries.get((interval, version))
            if holder is None:
                return None
            chunk = holder.remove(partition_num)
            if not len(holder):
                del self._entries[(interval, version)]
            return chunk

    # -- lookup ----------------------------------------------------------
    def lookup(self, interval: Interval) -> List[TimelineObjectHolder[T]]:
        """Visible holders overlapping `interval`, split at overshadowing
        boundaries, clipped to `interval`, ordered by time."""
        return self._lookup(interval, complete_only=True)

    def lookup_with_incomplete(self, interval: Interval) \
            -> List[TimelineObjectHolder[T]]:
        return self._lookup(interval, complete_only=False)

    def _lookup(self, interval: Interval, complete_only: bool):
        with self._lock:
            cands = [
                (iv, ver, holder)
                for (iv, ver), holder in self._entries.items()
                if iv.overlaps(interval)
                and (not complete_only or holder.is_complete())
            ]
            if not cands:
                return []
            # sweep over elementary boundaries
            pts = set()
            for iv, _, _ in cands:
                pts.add(max(iv.start, interval.start))
                pts.add(min(iv.end, interval.end))
            pts.add(interval.start)
            pts.add(interval.end)
            bounds = sorted(p for p in pts
                            if interval.start <= p <= interval.end)
            out: List[TimelineObjectHolder[T]] = []
            for a, b in zip(bounds, bounds[1:]):
                if a >= b:
                    continue
                best = None
                for iv, ver, holder in cands:
                    if iv.start <= a and b <= iv.end:
                        if best is None or ver > best[1]:
                            best = (iv, ver, holder)
                if best is None:
                    continue
                iv, ver, holder = best
                piece = Interval(a, b)
                if out and out[-1].version == ver \
                        and self._same_holder(out[-1], holder) \
                        and out[-1].interval.end == a:
                    # merge adjacent pieces of the same entry
                    out[-1] = TimelineObjectHolder(
                        Interval(out[-1].interval.start, b), ver,
                        out[-1].partitions)
                else:
                    out.append(TimelineObjectHolder(
                        piece, ver, tuple(holder)))
            return out

    @staticmethod
    def _same_holder(holder_out: TimelineObjectHolder,
                     holder: PartitionHolder) -> bool:
        return list(holder_out.partitions) == list(holder)

    # -- overshadowing ---------------------------------------------------
    def is_overshadowed(self, interval: Interval, version: str) -> bool:
        """Would an entry at (interval, version) be fully hidden by
        higher-version complete entries?"""
        with self._lock:
            covers = [
                iv for (iv, ver), holder in self._entries.items()
                if ver > version and holder.is_complete()
                and iv.overlaps(interval)
            ]
            return _covered(interval, covers)

    def find_fully_overshadowed(self) -> List[TimelineObjectHolder[T]]:
        """All entries completely hidden by higher versions — what the
        coordinator marks unused (DruidCoordinatorCleanupOvershadowed)."""
        with self._lock:
            out = []
            for (iv, ver), holder in self._entries.items():
                if self.is_overshadowed(iv, ver):
                    out.append(TimelineObjectHolder(iv, ver, tuple(holder)))
            return out

    # -- introspection ---------------------------------------------------
    def all_entries(self) -> List[TimelineObjectHolder[T]]:
        with self._lock:
            return [TimelineObjectHolder(iv, ver, tuple(holder))
                    for (iv, ver), holder in sorted(
                        self._entries.items(),
                        key=lambda kv: (kv[0][0], kv[0][1]))]

    def is_empty(self) -> bool:
        with self._lock:
            return not self._entries

    def first_entry_interval(self) -> Optional[Interval]:
        with self._lock:
            if not self._entries:
                return None
            return min(iv for iv, _ in self._entries)


def _covered(interval: Interval, covers: List[Interval]) -> bool:
    """Is `interval` fully covered by the union of `covers`?"""
    return any(iv.contains_interval(interval) for iv in condense(covers))
