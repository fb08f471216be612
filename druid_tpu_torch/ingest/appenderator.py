"""Realtime appenderator: in-process streaming ingest + query + publish.

The port's own copy of the reference package's `ingest/appenderator.py`,
over the port's MetadataStore, shard specs, deep storage and Segment.

Reference analogs (server/src/main/java/org/apache/druid/segment/realtime/
appenderator/):
  Appenderator/AppenderatorImpl.java — manages per-segment Sinks, each a
    chain of FireHydrants (IncrementalIndexes), incremental persists,
    background merge+push
  plumber/Sink.java — hydrant chain for one segment
  StreamAppenderatorDriver.java / BaseAppenderatorDriver — the add →
    persist → publish → handoff state machine with exactly-once
    transactional publish (SegmentTransactionalInsertAction)
  SinkQuerySegmentWalker.java — makes in-flight data queryable
  SegmentAllocateAction — allocates (interval, version, partition) against
    the metadata store

Hydrants are vectorized-rollup IncrementalIndexes whose snapshots are
ordinary immutable Segments, so realtime queries run through the same
engines (and kernels) as historical ones: there is no separate realtime
path.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from druid_tpu_torch.cluster.metadata import MetadataStore, SegmentDescriptor
from druid_tpu_torch.cluster.shardspec import NumberedShardSpec
from druid_tpu_torch.data.segment import Segment, SegmentId
from druid_tpu_torch.ingest.incremental import IncrementalIndex
from druid_tpu_torch.ingest.input import RowBatch
from druid_tpu_torch.ingest.merger import merge_segments
from druid_tpu_torch.query import aggregators as A
from druid_tpu_torch.storage.deep import DeepStorage
from druid_tpu_torch.utils.granularity import Granularity
from druid_tpu_torch.utils.intervals import Interval


@dataclass(frozen=True)
class SegmentIdWithShard:
    """Allocated identity for an in-flight segment."""
    datasource: str
    interval: Interval
    version: str
    partition: int

    @property
    def id(self) -> str:
        return (f"{self.datasource}_{self.interval}_{self.version}"
                f"_{self.partition}")


class SegmentAllocator:
    """Allocates segment identities via the metadata store's atomic
    pending-segments transaction (SegmentAllocateAction analog): one
    (interval, version) per segment-granularity bucket; concurrent
    allocators for the same bucket receive the SAME version and unique
    partitions, so streamed appends are siblings, never overshadowing."""

    def __init__(self, metadata: MetadataStore,
                 segment_granularity: str | Granularity = "hour"):
        self.metadata = metadata
        self.granularity = (segment_granularity
                            if isinstance(segment_granularity, Granularity)
                            else Granularity.of(segment_granularity))

    def bucket(self, ts_ms: int) -> Interval:
        if self.granularity.is_all:
            raise ValueError("segmentGranularity must be uniform")
        start = self.granularity.bucket_start(ts_ms)
        return Interval(start, self.granularity.next_bucket(start))

    def allocate(self, datasource: str, ts_ms: int,
                 version: Optional[str] = None) -> SegmentIdWithShard:
        iv = self.bucket(ts_ms)
        version, part = self.metadata.allocate_segment(datasource, iv, version)
        return SegmentIdWithShard(datasource, iv, version, part)


class Sink:
    """One in-flight segment: the current writable hydrant + persisted
    (immutable snapshot) hydrants (reference: plumber/Sink.java)."""

    def __init__(self, ident: SegmentIdWithShard,
                 metric_specs: Sequence[A.AggregatorSpec],
                 dimensions: Optional[Sequence[str]],
                 query_granularity: str,
                 max_rows_per_hydrant: int):
        self.ident = ident
        self.metric_specs = list(metric_specs)
        self.dimensions = dimensions
        self.query_granularity = query_granularity
        self.max_rows_per_hydrant = max_rows_per_hydrant
        self.hydrants: List[Segment] = []      # persisted snapshots
        self.index = self._new_index()
        self.num_rows_added = 0

    def _new_index(self) -> IncrementalIndex:
        return IncrementalIndex(
            self.ident.datasource, self.ident.interval, self.metric_specs,
            dimensions=self.dimensions,
            query_granularity=self.query_granularity,
            max_rows_in_memory=self.max_rows_per_hydrant)

    def add_batch(self, batch: RowBatch) -> None:
        self.index.add_batch(batch)
        self.num_rows_added += len(batch.timestamps)

    def persist_hydrant(self) -> None:
        """Seal the writable hydrant into an immutable snapshot (the
        incremental-persist step that bounds ingest memory)."""
        if self.index.n_rows == 0:
            return
        self.hydrants.append(
            self.index.to_segment(self.ident.version, self.ident.partition))
        self.index = self._new_index()

    def needs_persist(self) -> bool:
        return not self.index.can_append()

    def query_segments(self) -> List[Segment]:
        out = list(self.hydrants)
        if self.index.n_rows > 0:
            out.append(self.index.to_segment(self.ident.version,
                                             self.ident.partition))
        return out

    def merged_segment(self) -> Optional[Segment]:
        """Merge all hydrants into the final pushable segment
        (the IndexMergerV9.mergeQueryableIndex step)."""
        segs = self.query_segments()
        if not segs:
            return None
        if len(segs) == 1:
            s = segs[0]
            return Segment(SegmentId(self.ident.datasource,
                                     self.ident.interval, self.ident.version,
                                     self.ident.partition),
                           s.time_ms, s.dims, s.metrics)
        return merge_segments(segs, self.metric_specs,
                              datasource=self.ident.datasource,
                              interval=self.ident.interval,
                              version=self.ident.version,
                              partition=self.ident.partition,
                              query_granularity=self.query_granularity)


class Appenderator:
    """Manages sinks; add/persist/push; exposes in-flight data as ordinary
    segments for querying (SinkQuerySegmentWalker analog)."""

    def __init__(self, datasource: str,
                 metric_specs: Sequence[A.AggregatorSpec],
                 dimensions: Optional[Sequence[str]] = None,
                 query_granularity: str = "none",
                 max_rows_per_hydrant: int = 500_000):
        self.datasource = datasource
        self.metric_specs = list(metric_specs)
        self.dimensions = dimensions
        self.query_granularity = query_granularity
        self.max_rows_per_hydrant = max_rows_per_hydrant
        self._sinks: Dict[str, Sink] = {}
        self._lock = threading.RLock()
        # sink lifecycle listeners (cluster.realtime.RealtimeServer announces
        # created sinks into the broker's InventoryView — the
        # SinkQuerySegmentWalker announcement step)
        self._listeners: List[object] = []

    def add_listener(self, listener) -> None:
        """listener gets sink_created(ident) / sink_dropped(ident), and —
        when it defines them — sink_published(descriptor, segment) just
        before a publishing sink drops (the standing-query cutover hook,
        engine/standing.py)."""
        with self._lock:
            self._listeners.append(listener)
            existing = [s.ident for s in self._sinks.values()]
        for ident in existing:
            listener.sink_created(ident)

    def remove_listener(self, listener) -> None:
        with self._lock:
            try:
                self._listeners.remove(listener)
            except ValueError:
                pass

    def add(self, ident: SegmentIdWithShard, batch: RowBatch) -> None:
        created = False
        with self._lock:
            sink = self._sinks.get(ident.id)
            if sink is None:
                sink = self._sinks[ident.id] = Sink(
                    ident, self.metric_specs, self.dimensions,
                    self.query_granularity, self.max_rows_per_hydrant)
                created = True
            sink.add_batch(batch)
            if sink.needs_persist():
                sink.persist_hydrant()
            listeners = list(self._listeners) if created else ()
        for ln in listeners:
            ln.sink_created(ident)

    def persist_all(self) -> None:
        with self._lock:
            for sink in self._sinks.values():
                sink.persist_hydrant()

    def sink_ids(self) -> List[SegmentIdWithShard]:
        with self._lock:
            return [s.ident for s in self._sinks.values()]

    def rows_in(self, ident: SegmentIdWithShard) -> int:
        with self._lock:
            sink = self._sinks.get(ident.id)
            return sink.num_rows_added if sink else 0

    # ---- realtime querying (SinkQuerySegmentWalker) --------------------
    def query_segments(self) -> List[Segment]:
        with self._lock:
            out: List[Segment] = []
            for sink in self._sinks.values():
                out += sink.query_segments()
            return out

    def sink_segments(self, segment_id: str) -> Optional[List[Segment]]:
        """Queryable snapshots of ONE in-flight sink (hydrants + a snapshot
        of the live index), or None if no such sink."""
        with self._lock:
            sink = self._sinks.get(str(segment_id))
            return None if sink is None else sink.query_segments()

    def standing_states(self) -> List[Tuple]:
        """[(ident, immutable hydrant snapshots, live IncrementalIndex)]
        per sink — the standing-query fold surface (engine/standing.py):
        hydrants are append-only so the caller folds only the ones past
        its high-water mark, and the live index exposes change_marker()
        so an unchanged tick costs zero snapshots. Snapshot production
        (to_segment) is the caller's, OUTSIDE this lock."""
        with self._lock:
            return [(s.ident, tuple(s.hydrants), s.index)
                    for s in self._sinks.values()]

    def note_published(self, pairs) -> None:
        """Notify listeners that these sinks' merged historical segments
        now exist ((descriptor, segment) pairs, about to hand off). Fires
        BEFORE drop() so a standing listener can swap the contribution
        exactly-once at the publish boundary."""
        with self._lock:
            listeners = list(self._listeners)
        for desc, seg in pairs:
            for ln in listeners:
                fn = getattr(ln, "sink_published", None)
                if fn is not None:
                    fn(desc, seg)

    # ---- push -----------------------------------------------------------
    def push(self, idents: Sequence[SegmentIdWithShard]
             ) -> List[Tuple[SegmentDescriptor, Segment]]:
        """Merge each sink's hydrants into its final segment. Does NOT drop
        the sinks — data stays queryable until handoff (drop())."""
        out = []
        with self._lock:
            for ident in idents:
                sink = self._sinks.get(ident.id)
                if sink is None:
                    continue
                seg = sink.merged_segment()
                if seg is None:
                    continue
                spec = NumberedShardSpec(ident.partition, 0)
                desc = SegmentDescriptor(
                    ident.datasource, ident.interval, ident.version,
                    ident.partition, spec, num_rows=seg.n_rows)
                out.append((desc, seg))
        return out

    def drop(self, idents: Sequence[SegmentIdWithShard]) -> None:
        """Handoff complete: historicals serve these now."""
        dropped = []
        with self._lock:
            for ident in idents:
                if self._sinks.pop(ident.id, None) is not None:
                    dropped.append(ident)
            listeners = list(self._listeners)
        for ident in dropped:
            for ln in listeners:
                ln.sink_dropped(ident)


class StreamAppenderatorDriver:
    """The add → publish → handoff state machine with transactional
    (exactly-once) publish: segments and stream offsets commit in ONE
    metadata transaction (reference: StreamAppenderatorDriver +
    SegmentTransactionalInsertAction)."""

    def __init__(self, appenderator: Appenderator,
                 allocator: SegmentAllocator,
                 metadata: MetadataStore,
                 handoff: Optional[Callable[
                     [List[Tuple[SegmentDescriptor, Segment]]], None]] = None,
                 deep_storage: Optional["DeepStorage"] = None):
        self.appenderator = appenderator
        self.allocator = allocator
        self.metadata = metadata
        self.handoff = handoff        # e.g. load onto a DataNode + announce
        self.deep_storage = deep_storage  # durable home before publish
        self._active: Dict[int, SegmentIdWithShard] = {}  # bucket start → id
        # serializes add_batch vs publish_all so a concurrently-allocated
        # sink can't be evicted from _active without being published
        self._lock = threading.Lock()

    def add_batch(self, batch: RowBatch) -> List[SegmentIdWithShard]:
        """Route rows to per-bucket allocated segments."""
        ts = np.asarray(batch.timestamps, dtype=np.int64)
        if len(ts) == 0:
            return []
        gran = self.allocator.granularity
        starts = gran.bucket_start_array(ts)
        touched = []
        with self._lock:
            for st in np.unique(starts):
                sel = starts == st
                ident = self._active.get(int(st))
                if ident is None:
                    ident = self.allocator.allocate(
                        self.appenderator.datasource, int(st))
                    self._active[int(st)] = ident
                sub = RowBatch(ts[sel],
                               {k: [v for v, m in zip(col, sel) if m]
                                if isinstance(col, list) else np.asarray(col)[sel]
                                for k, col in batch.columns.items()})
                self.appenderator.add(ident, sub)
                touched.append(ident)
        return touched

    def publish_all(self, start_metadata: Optional[dict],
                    end_metadata: dict) -> bool:
        """Transactionally publish every active segment with the stream
        offset CAS. On success, hand off and drop the sinks. On CAS
        failure nothing is committed (another task already advanced the
        offsets — the duplicate is discarded, preserving exactly-once)."""
        with self._lock:
            idents = list(self._active.values())
            pushed = self.appenderator.push(idents)
            if self.deep_storage is not None:
                # durable copy BEFORE the metadata commit, so the published
                # descriptors are loadable by the coordinator forever —
                # without this, the only copy dies with this process
                pushed = [(self.deep_storage.push(seg, d), seg)
                          for d, seg in pushed]
            ok = self.metadata.publish_segments(
                [d for d, _ in pushed],
                (self.appenderator.datasource, start_metadata, end_metadata))
            if ok:
                if self.handoff is not None and pushed:
                    self.handoff(pushed)
                # published segments exist (and are handed off) BEFORE the
                # sinks drop: standing listeners swap their incremental
                # partials for the published contribution exactly-once,
                # and the broker's ReplicaSet never has a serving gap
                self.appenderator.note_published(pushed)
                self.appenderator.drop(idents)
                for key in [k for k, v in self._active.items()
                            if v in idents]:
                    del self._active[key]
            # on CAS failure sinks stay intact so the caller may retry with
            # re-read metadata (or discard the task)
            return ok
