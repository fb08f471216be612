"""Streaming ingestion with exactly-once semantics.

The port's own copy of the reference package's `ingest/streaming.py`.

Reference analogs (extensions-core/kafka-indexing-service/):
  KafkaSupervisor.java — run loop: partitions → task groups, spawns
    replicated index tasks, checkpoint coordination (:523), reconciliation
    of failed tasks from last committed offsets
  KafkaIndexTask / IncrementalPublishingKafkaIndexTaskRunner.java:229 —
    poll → parse → appenderator add → transactional publish where
    (startOffsets → endOffsets) CAS against datasource metadata commits
    atomically with the segments = exactly-once

The stream source is an SPI (`StreamSource`) with an in-process
`SimulatedStream` implementation (the role Kafka's consumer plays; a real
deployment implements StreamSource over a network consumer).
Tasks here are pollable objects driven by the supervisor's run loop —
deterministic for tests, threadable in deployment.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from druid_tpu_torch.cluster.metadata import MetadataStore
from druid_tpu_torch.ingest.appenderator import (Appenderator,
                                                 SegmentAllocator,
                                                 StreamAppenderatorDriver)
from druid_tpu_torch.ingest.input import (InputRowParser, RowBatch,
                                          TransformSpec)
from druid_tpu_torch.query import aggregators as A


# ---------------------------------------------------------------------------
# Stream source SPI + simulated implementation
# ---------------------------------------------------------------------------

class StreamSource:
    """Partitioned, offset-addressable record stream (Kafka consumer SPI)."""

    def partitions(self) -> List[int]:
        raise NotImplementedError

    def read(self, partition: int, offset: int, max_records: int
             ) -> List[Tuple[int, dict]]:
        """Records [(offset, record)] starting at `offset`."""
        raise NotImplementedError

    def latest_offset(self, partition: int) -> int:
        """One past the last available offset."""
        raise NotImplementedError


class SimulatedStream(StreamSource):
    """In-memory partitioned log for tests/local runs."""

    def __init__(self, n_partitions: int = 2):
        self._logs: Dict[int, List[dict]] = {i: [] for i in range(n_partitions)}
        self._lock = threading.Lock()

    def append(self, partition: int, records: Sequence[dict]) -> None:
        with self._lock:
            self._logs[partition].extend(records)

    def partitions(self) -> List[int]:
        with self._lock:
            return sorted(self._logs)

    def read(self, partition: int, offset: int, max_records: int):
        with self._lock:
            log = self._logs[partition]
            end = min(len(log), offset + max_records)
            return [(i, log[i]) for i in range(offset, end)]

    def latest_offset(self, partition: int) -> int:
        with self._lock:
            return len(self._logs[partition])


# ---------------------------------------------------------------------------
# Streaming task
# ---------------------------------------------------------------------------

@dataclass
class StreamTuningConfig:
    max_rows_per_hydrant: int = 500_000
    max_records_per_poll: int = 10_000
    segment_granularity: str = "hour"
    query_granularity: str = "none"


class StreamIngestTask:
    """One exactly-once ingestion task over a set of partitions
    (KafkaIndexTask analog). Drive with poll_once(); checkpoint() publishes
    everything read so far atomically with the new offsets."""

    def __init__(self, task_id: str, datasource: str,
                 source: StreamSource, partitions: Sequence[int],
                 start_offsets: Dict[int, int],
                 metric_specs: Sequence[A.AggregatorSpec],
                 metadata: MetadataStore,
                 parser: Optional[InputRowParser] = None,
                 transform: Optional[TransformSpec] = None,
                 dimensions: Optional[Sequence[str]] = None,
                 tuning: Optional[StreamTuningConfig] = None,
                 handoff: Optional[Callable] = None,
                 deep_storage=None, realtime=None):
        self.task_id = task_id
        self.datasource = datasource
        self.source = source
        self.partitions = list(partitions)
        self.start_offsets = dict(start_offsets)   # committed base
        self.current_offsets = dict(start_offsets)
        self.metadata = metadata
        self.parser = parser
        self.transform = transform
        self.tuning = tuning or StreamTuningConfig()
        appender = Appenderator(
            datasource, metric_specs, dimensions=dimensions,
            query_granularity=self.tuning.query_granularity,
            max_rows_per_hydrant=self.tuning.max_rows_per_hydrant)
        if realtime is not None:
            # announce in-flight sinks into the broker view
            # (cluster.realtime.RealtimeServer — SinkQuerySegmentWalker)
            realtime.attach(appender)
        allocator = SegmentAllocator(metadata,
                                     self.tuning.segment_granularity)
        self.driver = StreamAppenderatorDriver(appender, allocator, metadata,
                                               handoff, deep_storage)
        self.paused = False
        self.status = "READING"
        self.rows_read = 0

    # ---- the ingest loop body -------------------------------------------
    def poll_once(self) -> int:
        """consumer.poll → parse → driver.add. Returns records consumed."""
        if self.paused or self.status != "READING":
            return 0
        n = 0
        for p in self.partitions:
            records = self.source.read(p, self.current_offsets[p],
                                       self.tuning.max_records_per_poll)
            if not records:
                continue
            rows = [r for _, r in records]
            batch = self._parse(rows)
            if len(batch):
                self.driver.add_batch(batch)
                self.rows_read += len(batch)
            self.current_offsets[p] = records[-1][0] + 1
            n += len(records)
        return n

    def _parse(self, rows: List[dict]) -> RowBatch:
        if self.parser is not None:
            batch = self.parser.parse_batch(rows)
        else:
            # rows are already {"timestamp": ms, **columns}
            ts = [r["timestamp"] for r in rows]
            cols: Dict[str, list] = {}
            keys = {k for r in rows for k in r if k != "timestamp"}
            for k in sorted(keys):
                cols[k] = [r.get(k) for r in rows]
            batch = RowBatch(ts, cols)
        if self.transform is not None:
            batch = self.transform.apply(batch)
        return batch

    # ---- pause/resume protocol (chat handler analog) -------------------
    def pause(self):
        self.paused = True

    def resume(self):
        self.paused = False

    # ---- transactional checkpoint --------------------------------------
    def checkpoint(self, cas_attempts: int = 3) -> bool:
        """Publish all in-flight segments + advance committed offsets in one
        metadata transaction. The task owns a SUBSET of partitions, so the
        comparison/merge is per-partition (KafkaDataSourceMetadata.matches /
        .plus): our partitions must be exactly at our start offsets in the
        committed map; other task groups' partitions pass through untouched.
        False = offsets conflict (another replica already committed past us)
        — our work is discarded, no duplicates."""
        for _ in range(cas_attempts):
            current = self.metadata.datasource_metadata(self.datasource)
            cur_parts = dict(current["partitions"]) if current else {}
            for p in self.partitions:
                if int(cur_parts.get(str(p), 0)) != self.start_offsets[p]:
                    self.status = "FAILED"   # stale replica: genuinely lost
                    return False
            merged = dict(cur_parts)
            for p in self.partitions:
                merged[str(p)] = self.current_offsets[p]
            ok = self.driver.publish_all(current, {"partitions": merged})
            if ok:
                self.start_offsets = dict(self.current_offsets)
                return True
            # CAS raced with a concurrent commit on OTHER partitions:
            # re-read and retry; a conflict on OUR partitions exits above
        self.status = "FAILED"
        return False

    def finish(self) -> bool:
        ok = self.checkpoint()
        if ok:
            self.status = "SUCCESS"
        return ok


# ---------------------------------------------------------------------------
# Supervisor
# ---------------------------------------------------------------------------

@dataclass
class StreamSupervisorSpec:
    datasource: str
    metric_specs: Sequence[A.AggregatorSpec]
    dimensions: Optional[Sequence[str]] = None
    task_count: int = 1
    max_rows_per_task: int = 1_000_000
    tuning: StreamTuningConfig = field(default_factory=StreamTuningConfig)


class StreamSupervisor:
    """Assigns stream partitions to task groups, rolls tasks over at
    checkpoints, and recreates failed tasks from the last committed offsets
    (KafkaSupervisor's reconciliation loop)."""

    def __init__(self, spec: StreamSupervisorSpec, source: StreamSource,
                 metadata: MetadataStore,
                 parser: Optional[InputRowParser] = None,
                 transform: Optional[TransformSpec] = None,
                 handoff: Optional[Callable] = None,
                 deep_storage=None, realtime=None):
        self.spec = spec
        self.source = source
        self.metadata = metadata
        self.parser = parser
        self.transform = transform
        self.handoff = handoff
        self.deep_storage = deep_storage
        self.realtime = realtime
        self.tasks: Dict[int, StreamIngestTask] = {}   # group → task
        self._task_seq = 0
        self.metadata.set_supervisor(
            spec.datasource, {"datasource": spec.datasource,
                              "taskCount": spec.task_count})

    # ---- offset recovery (the exactly-once resume point) ----------------
    def committed_offsets(self) -> Dict[int, int]:
        meta = self.metadata.datasource_metadata(self.spec.datasource)
        if meta is None:
            return {p: 0 for p in self.source.partitions()}
        parts = {int(k): v for k, v in meta["partitions"].items()}
        for p in self.source.partitions():
            parts.setdefault(p, 0)
        return parts

    def _groups(self) -> Dict[int, List[int]]:
        groups: Dict[int, List[int]] = {i: [] for i in
                                        range(self.spec.task_count)}
        for p in self.source.partitions():
            groups[p % self.spec.task_count].append(p)
        return groups

    def run_once(self) -> None:
        """One supervisor period: ensure a healthy task per group (recreate
        failed/missing ones from committed offsets), drive polls, roll over
        tasks that exceeded max_rows_per_task."""
        committed = self.committed_offsets()
        for group, partitions in self._groups().items():
            if not partitions:
                continue
            task = self.tasks.get(group)
            if task is None or task.status == "FAILED":
                self._task_seq += 1
                task = StreamIngestTask(
                    f"index_stream_{self.spec.datasource}_{self._task_seq}",
                    self.spec.datasource, self.source, partitions,
                    {p: committed[p] for p in partitions},
                    list(self.spec.metric_specs), self.metadata,
                    parser=self.parser, transform=self.transform,
                    dimensions=self.spec.dimensions, tuning=self.spec.tuning,
                    handoff=self.handoff, deep_storage=self.deep_storage,
                    realtime=self.realtime)
                self.tasks[group] = task
                self.metadata.insert_task(task.task_id, self.spec.datasource,
                                          "RUNNING", {"group": group})
            task.poll_once()
            if task.rows_read >= self.spec.max_rows_per_task:
                self._complete(group, task)

    def _complete(self, group: int, task: StreamIngestTask) -> None:
        ok = task.finish()
        self.metadata.update_task_status(
            task.task_id, "SUCCESS" if ok else "FAILED")
        del self.tasks[group]

    def checkpoint_all(self) -> bool:
        """Force-publish every running task (supervisor checkpoint notice)."""
        ok = True
        for group, task in list(self.tasks.items()):
            if not task.checkpoint():
                ok = False
                self.metadata.update_task_status(task.task_id, "FAILED")
                del self.tasks[group]
        return ok

    def stop(self, publish: bool = True) -> bool:
        ok = True
        for group, task in list(self.tasks.items()):
            if publish:
                ok = task.finish() and ok
            elif task.status == "READING":
                task.status = "FAILED"   # discarded without publishing
            self.metadata.update_task_status(task.task_id, task.status)
            del self.tasks[group]
        return ok

    # ---- realtime query surface ----------------------------------------
    def query_segments(self):
        """In-flight (unpublished) segments across tasks — what
        SinkQuerySegmentWalker announces to the broker."""
        out = []
        for task in self.tasks.values():
            out += task.driver.appenderator.query_segments()
        return out
