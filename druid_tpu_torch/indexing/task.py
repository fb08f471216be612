"""Task model: batch index, compaction, kill.

The port's copy of the reference package's `indexing/task.py`: host
code over the port's modules.

Reference analogs (indexing-service/src/main/java/org/apache/druid/indexing/):
  common/task/Task.java      — JSON-polymorphic task SPI
  common/task/IndexTask.java:406 — batch index: determineShardSpecs (:435)
    then generateAndPublishSegments (:872)
  common/task/CompactionTask.java — re-index an interval into fewer/newer
    segments (drives auto-compaction)
  common/task/KillTask.java  — permanently delete unused segments
  §3.3 call stack: firehose → IncrementalIndex.add (rollup hot loop) →
    persist → merge → push → SegmentTransactionalInsertAction

Vectorized: the ingest hot loop is the vectorized IncrementalIndex; shard
determination is a single pass over parsed batches (numpy bucketing), not a
separate M/R-style cardinality job.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, TYPE_CHECKING

import numpy as np

from druid_tpu_torch.cluster.metadata import SegmentDescriptor
from druid_tpu_torch.cluster.shardspec import (HashBasedNumberedShardSpec,
                                               NoneShardSpec, NumberedShardSpec)
from druid_tpu_torch.data.segment import Segment
from druid_tpu_torch.ingest.incremental import IncrementalIndex
from druid_tpu_torch.ingest.input import (Firehose, InputRowParser, RowBatch,
                                          TransformSpec)
from druid_tpu_torch.ingest.merger import merge_segments
from druid_tpu_torch.query import aggregators as A
from druid_tpu_torch.utils.granularity import Granularity
from druid_tpu_torch.utils.intervals import Interval, condense

if TYPE_CHECKING:
    from druid_tpu_torch.indexing.overlord import TaskToolbox


@dataclass
class TaskStatus:
    task_id: str
    state: str                   # RUNNING | SUCCESS | FAILED
    error: Optional[str] = None

    @staticmethod
    def success(task_id):
        return TaskStatus(task_id, "SUCCESS")

    @staticmethod
    def failure(task_id, error):
        return TaskStatus(task_id, "FAILED", str(error))


class Task:
    """SPI: id, type, datasource, priority; run(toolbox) does the work."""
    task_type = "base"
    priority = 0

    def __init__(self, task_id: Optional[str], datasource: str):
        self.id = task_id or f"{self.task_type}_{datasource}_{uuid.uuid4().hex[:8]}"
        self.datasource = datasource

    def run(self, toolbox: "TaskToolbox") -> TaskStatus:
        raise NotImplementedError

    def to_json(self) -> dict:
        return {"type": self.task_type, "id": self.id,
                "dataSource": self.datasource}


@dataclass
class IndexTuningConfig:
    max_rows_per_segment: int = 5_000_000
    max_rows_in_memory: int = 1_000_000
    partition_dimensions: Sequence[str] = ()   # hash partitioning dims


class IndexTask(Task):
    """Single-phase batch ingest (reference IndexTask 'index' type).

    determineShardSpecs + generateAndPublishSegments collapse into one
    vectorized pass: parse → transform → bucket by segment granularity →
    split buckets over max_rows_per_segment into hash partitions → rollup
    per partition → push + transactional publish under the task lock's
    version."""
    task_type = "index"
    priority = 50   # batch replaces: above compaction, below streaming

    def __init__(self, datasource: str, firehose: Firehose,
                 parser: Optional[InputRowParser],
                 metric_specs: Sequence[A.AggregatorSpec],
                 dimensions: Optional[Sequence[str]] = None,
                 transform: Optional[TransformSpec] = None,
                 segment_granularity: str = "day",
                 query_granularity: str = "none",
                 rollup: bool = True,
                 tuning: Optional[IndexTuningConfig] = None,
                 task_id: Optional[str] = None,
                 appending: bool = False):
        super().__init__(task_id, datasource)
        self.firehose = firehose
        self.parser = parser
        self.metric_specs = list(metric_specs)
        self.dimensions = list(dimensions) if dimensions else None
        self.transform = transform
        self.segment_granularity = Granularity.of(segment_granularity)
        self.query_granularity = query_granularity
        self.rollup = rollup
        self.tuning = tuning or IndexTuningConfig()
        self.appending = appending

    def to_json(self) -> dict:
        schema = {
            "dataSource": self.datasource,
            "metricsSpec": [a.to_json() for a in self.metric_specs],
            "granularitySpec": {
                "segmentGranularity": str(self.segment_granularity),
                "queryGranularity": self.query_granularity,
                "rollup": self.rollup},
        }
        if self.parser is not None:
            schema["parser"] = self.parser.to_json()
        if self.dimensions is not None:
            schema["dimensionsSpec"] = {"dimensions": list(self.dimensions)}
        if self.transform is not None:
            schema["transformSpec"] = self.transform.to_json()
        return {"type": "index", "id": self.id, "appending": self.appending,
                "spec": {
                    "ioConfig": {"type": "index",
                                 "firehose": self.firehose.to_json()},
                    "dataSchema": schema,
                    "tuningConfig": {
                        "maxRowsPerSegment": self.tuning.max_rows_per_segment,
                        "maxRowsInMemory": self.tuning.max_rows_in_memory,
                        "partitionDimensions":
                            list(self.tuning.partition_dimensions)}}}

    def _parse(self, raw: List) -> RowBatch:
        if self.parser is not None:
            batch = self.parser.parse_batch(raw)
        else:
            ts = [r["timestamp"] for r in raw]
            keys = {k for r in raw for k in r if k != "timestamp"}
            batch = RowBatch(ts, {k: [r.get(k) for r in raw]
                                  for k in sorted(keys)})
        if self.transform is not None:
            batch = self.transform.apply(batch)
        return batch

    def run(self, toolbox: "TaskToolbox") -> TaskStatus:
        # phase 1: read + bucket (determineShardSpecs analog)
        buckets: Dict[int, List[RowBatch]] = {}
        bucket_rows: Dict[int, int] = {}
        for raw in self.firehose.batches(self.tuning.max_rows_in_memory):
            batch = self._parse(raw)
            if not len(batch):
                continue
            ts = np.asarray(batch.timestamps, dtype=np.int64)
            starts = self.segment_granularity.bucket_start_array(ts)
            for st in np.unique(starts):
                sel = starts == st
                sub = RowBatch(
                    ts[sel].tolist(),
                    {k: [v for v, m in zip(col, sel) if m]
                     for k, col in batch.columns.items()})
                buckets.setdefault(int(st), []).append(sub)
                bucket_rows[int(st)] = bucket_rows.get(int(st), 0) + len(sub)
        if not buckets:
            return TaskStatus.success(self.id)

        intervals = condense([
            Interval(st, self.segment_granularity.next_bucket(st))
            for st in buckets])
        from druid_tpu_torch.indexing.locks import LockType
        lock = toolbox.lock(self, intervals,
                            lock_type=LockType.SHARED if self.appending
                            else LockType.EXCLUSIVE)
        if lock is None:
            return TaskStatus.failure(self.id, "could not acquire lock")

        # phase 2: build + publish per bucket
        published: List[SegmentDescriptor] = []
        pushed_segments: List[Segment] = []
        for st, batches in sorted(buckets.items()):
            iv = Interval(st, self.segment_granularity.next_bucket(st))
            n_parts = max(1, -(-bucket_rows[st] //
                               self.tuning.max_rows_per_segment))
            part_batches: List[List[RowBatch]] = [[] for _ in range(n_parts)]
            for b in batches:
                if n_parts == 1:
                    part_batches[0].append(b)
                    continue
                pids = self._partition_ids(b, n_parts)
                for p in range(n_parts):
                    sel = pids == p
                    if not sel.any():
                        continue
                    part_batches[p].append(RowBatch(
                        [t for t, m in zip(b.timestamps, sel) if m],
                        {k: [v for v, m in zip(col, sel) if m]
                         for k, col in b.columns.items()}))
            hash_partitioned = (n_parts > 1
                                and bool(self.tuning.partition_dimensions)
                                and not self.appending)
            for p, pbs in enumerate(part_batches):
                if not pbs and not hash_partitioned:
                    continue
                # hash partitioning publishes EMPTY partitions too — the
                # timeline only shows a numbered set once it is complete
                index = IncrementalIndex(
                    self.datasource, iv, self.metric_specs,
                    dimensions=self.dimensions,
                    query_granularity=self.query_granularity,
                    rollup=self.rollup,
                    max_rows_in_memory=10 ** 12)
                for b in pbs:
                    index.add_batch(b)
                if self.appending:
                    version, pnum = toolbox.metadata.allocate_segment(
                        self.datasource, iv)
                else:
                    version, pnum = lock.version, p
                seg = index.to_segment(version, pnum)
                if n_parts == 1 and not self.appending:
                    spec = NoneShardSpec(0)
                elif self.tuning.partition_dimensions and not self.appending:
                    spec = HashBasedNumberedShardSpec(
                        pnum, n_parts,
                        tuple(self.tuning.partition_dimensions))
                else:
                    spec = NumberedShardSpec(pnum,
                                             0 if self.appending else n_parts)
                desc = SegmentDescriptor(self.datasource, iv, version, pnum,
                                         spec, num_rows=seg.n_rows)
                desc = toolbox.push(seg, desc)
                published.append(desc)
                pushed_segments.append(seg)
        if toolbox.lockbox.is_revoked(self.id):
            return TaskStatus.failure(self.id, "lock revoked")
        if not toolbox.publish(self, published):
            return TaskStatus.failure(self.id, "transactional publish failed")
        return TaskStatus.success(self.id)

    def _partition_ids(self, batch: RowBatch, n_parts: int) -> np.ndarray:
        dims = list(self.tuning.partition_dimensions)
        if dims:
            # MUST match HashBasedNumberedShardSpec's routing hash, or the
            # broker's shard pruning drops rows the spec claims aren't here
            from druid_tpu_torch.cluster.shardspec import _hash_row
            cols = [batch.columns.get(d, [None] * len(batch)) for d in dims]
            return np.asarray(
                [_hash_row([None if v is None else str(v)
                            for v in (col[i] for col in cols)]) % n_parts
                 for i in range(len(batch))], dtype=np.int64)
        return np.arange(len(batch), dtype=np.int64) % n_parts


class ParallelIndexTask(IndexTask):
    """Parallel single-phase batch ingest (reference:
    indexing-service/.../parallel/ParallelIndexSupervisorTask.java, dynamic
    partitioning mode): the supervisor splits the firehose, fans sub-
    IndexTasks out over the task runner (forked peons under
    ForkingTaskRunner), and each sub-task allocates + transactionally
    publishes its own appended segments — the same per-bucket allocator
    streaming uses, so concurrent sub-tasks get sibling partitions, never
    overshadowing ones.

    Retry contract: resubmitting with the SAME task id is idempotent —
    sub-task ids are deterministic and the overlord's publish marker makes
    an already-committed sub-task's publish a no-op (a resubmission under
    a NEW id re-appends everything a previous partial run committed)."""
    task_type = "index_parallel"
    priority = 50

    def __init__(self, *args, max_num_subtasks: int = 4, **kwargs):
        kwargs.pop("appending", None)
        super().__init__(*args, appending=False, **kwargs)
        self.max_num_subtasks = max_num_subtasks

    def _subtasks(self) -> List[IndexTask]:
        return [IndexTask(
            self.datasource, split, self.parser, self.metric_specs,
            dimensions=self.dimensions, transform=self.transform,
            segment_granularity=str(self.segment_granularity),
            query_granularity=self.query_granularity, rollup=self.rollup,
            tuning=self.tuning, task_id=f"{self.id}_sub{i}", appending=True)
            for i, split in enumerate(
                self.firehose.splits(self.max_num_subtasks))]

    def run(self, toolbox: "TaskToolbox") -> TaskStatus:
        subtasks = self._subtasks()
        runner = getattr(toolbox, "task_runner", None)
        if runner is not None:
            for t in subtasks:
                runner.submit(t)
            statuses = [runner.await_task(t.id) for t in subtasks]
        else:
            # no runner surface: degrade to sequential in-process
            # execution — same results, no fan-out. Sub-task lock ids must
            # be released here; no runner will ever do it for them.
            statuses = []
            for t in subtasks:
                try:
                    statuses.append(t.run(toolbox))
                finally:
                    release = getattr(toolbox.lockbox, "release_all", None)
                    if callable(release):
                        release(t.id)
        failed = [s for s in statuses if s.state != "SUCCESS"]
        if failed:
            return TaskStatus.failure(
                self.id, f"{len(failed)}/{len(statuses)} sub-tasks failed: "
                f"{failed[0].error}")
        return TaskStatus.success(self.id)

    def to_json(self) -> dict:
        j = super().to_json()
        j["type"] = "index_parallel"
        j["spec"]["tuningConfig"]["maxNumConcurrentSubTasks"] = \
            self.max_num_subtasks
        del j["appending"]
        return j


class CompactionTask(Task):
    """Merge an interval's segments into one new-version segment
    (reference CompactionTask; scheduled by the coordinator's
    auto-compaction — NewestSegmentFirstPolicy)."""
    task_type = "compact"
    priority = 25   # below batch/streaming: loses lock races to fresh data

    def __init__(self, datasource: str, interval: Interval,
                 metric_specs: Sequence[A.AggregatorSpec],
                 query_granularity: str = "none",
                 task_id: Optional[str] = None):
        super().__init__(task_id, datasource)
        self.interval = interval
        self.metric_specs = list(metric_specs)
        self.query_granularity = query_granularity

    def to_json(self) -> dict:
        return {"type": "compact", "id": self.id,
                "dataSource": self.datasource,
                "interval": str(self.interval),
                "metricsSpec": [a.to_json() for a in self.metric_specs],
                "queryGranularity": self.query_granularity}

    def run(self, toolbox: "TaskToolbox") -> TaskStatus:
        # lock FIRST, then snapshot: reading before the lock races a batch
        # replace — the stale snapshot would republish replaced data under
        # a newer version, silently reverting the replacement
        lock = toolbox.lock(self, [self.interval])
        if lock is None:
            return TaskStatus.failure(self.id, "could not acquire lock")
        # only MVCC-visible segments: merging a not-yet-cleaned overshadowed
        # version would resurrect replaced data
        descs = [d for d in
                 toolbox.metadata.visible_segments(self.datasource,
                                                   self.interval)
                 if self.interval.contains_interval(d.interval)]
        if not descs:
            return TaskStatus.success(self.id)
        segments = [toolbox.pull(d) for d in descs]
        if any(s is None for s in segments):
            return TaskStatus.failure(self.id, "segment missing from deep storage")
        merged = merge_segments(
            segments, self.metric_specs, datasource=self.datasource,
            interval=self.interval, version=lock.version, partition=0,
            query_granularity=self.query_granularity)
        desc = SegmentDescriptor(self.datasource, self.interval, lock.version,
                                 0, NoneShardSpec(0), num_rows=merged.n_rows)
        desc = toolbox.push(merged, desc)
        if toolbox.lockbox.is_revoked(self.id):
            return TaskStatus.failure(self.id, "lock revoked")
        if not toolbox.publish(self, [desc]):
            return TaskStatus.failure(self.id, "transactional publish failed")
        return TaskStatus.success(self.id)


class KillTask(Task):
    """Permanently remove UNUSED segments in an interval: metadata rows and
    deep-storage files (reference KillTask)."""
    task_type = "kill"
    priority = 0

    def __init__(self, datasource: str, interval: Interval,
                 task_id: Optional[str] = None):
        super().__init__(task_id, datasource)
        self.interval = interval

    def to_json(self) -> dict:
        return {"type": "kill", "id": self.id,
                "dataSource": self.datasource,
                "interval": str(self.interval)}

    def run(self, toolbox: "TaskToolbox") -> TaskStatus:
        # exclusive lock: without it a concurrent move/restore over the
        # same interval interleaves with the deletes (kill misses the
        # moved files, then deletes their metadata rows — orphaned files)
        lock = toolbox.lock(self, [self.interval])
        if lock is None:
            return TaskStatus.failure(self.id, "could not acquire lock")
        descs = toolbox.metadata.unused_segments(self.datasource,
                                                 self.interval)
        for d in descs:
            toolbox.deep_storage.kill(d)
        toolbox.metadata.delete_segments([d.id for d in descs])
        return TaskStatus.success(self.id)


class MoveTask(Task):
    """Relocate UNUSED segments' deep-storage files to a target location
    and rewrite their loadSpecs (reference MoveTask: unused data migrates
    to cheaper storage without leaving the metadata catalog)."""
    task_type = "move"
    priority = 0

    def __init__(self, datasource: str, interval: Interval, target: str,
                 task_id: Optional[str] = None):
        super().__init__(task_id, datasource)
        self.interval = interval
        self.target = target

    def to_json(self) -> dict:
        return {"type": self.task_type, "id": self.id,
                "dataSource": self.datasource,
                "interval": str(self.interval), "target": self.target}

    def run(self, toolbox: "TaskToolbox") -> TaskStatus:
        # exclusive lock: a concurrent kill/restore over the same interval
        # must not interleave with the file moves
        lock = toolbox.lock(self, [self.interval])
        if lock is None:
            return TaskStatus.failure(self.id, "could not acquire lock")
        missing = []
        for d in toolbox.metadata.unused_segments(self.datasource,
                                                  self.interval):
            nd = toolbox.deep_storage.move(d, self.target)
            if nd is None or \
                    not toolbox.metadata.update_segment_payload(nd):
                # files absent, or the metadata row vanished underneath
                # (concurrent kill) leaving the moved files orphaned
                missing.append(d.id)
        if missing:
            # a green move over unpullable segments would hide data loss
            return TaskStatus.failure(
                self.id, f"segments missing from deep storage: {missing}")
        return TaskStatus.success(self.id)


class ArchiveTask(MoveTask):
    """MoveTask specialization targeting the configured archive location
    (reference ArchiveTask / DataSegmentArchiver)."""
    task_type = "archive"
    ARCHIVE_LOCATION = "archive"

    def __init__(self, datasource: str, interval: Interval,
                 task_id: Optional[str] = None):
        super().__init__(datasource, interval, self.ARCHIVE_LOCATION,
                         task_id)

    def to_json(self) -> dict:
        return {"type": "archive", "id": self.id,
                "dataSource": self.datasource,
                "interval": str(self.interval)}


class RestoreTask(Task):
    """Bring archived (unused) segments back: move files to the base
    location and mark the segments used so load rules serve them again
    (reference RestoreTask)."""
    task_type = "restore"
    priority = 0

    def __init__(self, datasource: str, interval: Interval,
                 task_id: Optional[str] = None):
        super().__init__(task_id, datasource)
        self.interval = interval

    def to_json(self) -> dict:
        return {"type": "restore", "id": self.id,
                "dataSource": self.datasource,
                "interval": str(self.interval)}

    def run(self, toolbox: "TaskToolbox") -> TaskStatus:
        from druid_tpu_torch.storage.deep import DeepStorage
        lock = toolbox.lock(self, [self.interval])
        if lock is None:
            return TaskStatus.failure(self.id, "could not acquire lock")
        restored = []
        for d in toolbox.metadata.unused_segments(self.datasource,
                                                  self.interval):
            nd = toolbox.deep_storage.move(d, DeepStorage.BASE_LOCATION)
            if nd is None:
                return TaskStatus.failure(
                    self.id, f"segment {d.id} missing from deep storage")
            toolbox.metadata.update_segment_payload(nd)
            restored.append(nd.id)
        toolbox.metadata.mark_used(restored)
        return TaskStatus.success(self.id)


def task_from_json(j: dict) -> Task:
    t = j["type"]
    if t == "index_parallel":
        base = task_from_json({**j, "type": "index"})
        return ParallelIndexTask(
            base.datasource, base.firehose, base.parser, base.metric_specs,
            dimensions=base.dimensions, transform=base.transform,
            segment_granularity=str(base.segment_granularity),
            query_granularity=base.query_granularity, rollup=base.rollup,
            tuning=base.tuning,
            max_num_subtasks=j["spec"].get("tuningConfig", {}).get(
                "maxNumConcurrentSubTasks", 4),
            task_id=j.get("id"))
    if t == "index":
        from druid_tpu_torch.ingest.input import firehose_from_json
        spec = j["spec"]
        io = spec["ioConfig"]
        schema = spec["dataSchema"]
        parser = InputRowParser.from_json(schema["parser"]) \
            if "parser" in schema else None
        gran = schema.get("granularitySpec", {})
        dims_spec = schema.get("dimensionsSpec")
        tuning_j = spec.get("tuningConfig", {})
        tuning = IndexTuningConfig(
            max_rows_per_segment=tuning_j.get("maxRowsPerSegment", 5_000_000),
            max_rows_in_memory=tuning_j.get("maxRowsInMemory", 1_000_000),
            partition_dimensions=tuple(
                tuning_j.get("partitionDimensions", ())))
        transform = TransformSpec.from_json(schema.get("transformSpec")) \
            if schema.get("transformSpec") else None
        return IndexTask(
            schema["dataSource"], firehose_from_json(io["firehose"]), parser,
            [A.agg_from_json(a) for a in schema.get("metricsSpec", [])],
            dimensions=(dims_spec or {}).get("dimensions") or None,
            transform=transform,
            segment_granularity=gran.get("segmentGranularity", "day"),
            query_granularity=gran.get("queryGranularity", "none"),
            rollup=gran.get("rollup", True),
            tuning=tuning,
            task_id=j.get("id"),
            appending=j.get("appending", False))
    if t == "compact":
        return CompactionTask(
            j["dataSource"], Interval.parse(j["interval"]),
            [A.agg_from_json(a) for a in j.get("metricsSpec", [])],
            query_granularity=j.get("queryGranularity", "none"),
            task_id=j.get("id"))
    if t == "kill":
        return KillTask(j["dataSource"], Interval.parse(j["interval"]),
                        task_id=j.get("id"))
    if t == "move":
        return MoveTask(j["dataSource"], Interval.parse(j["interval"]),
                        j["target"], task_id=j.get("id"))
    if t == "archive":
        return ArchiveTask(j["dataSource"], Interval.parse(j["interval"]),
                           task_id=j.get("id"))
    if t == "restore":
        return RestoreTask(j["dataSource"], Interval.parse(j["interval"]),
                           task_id=j.get("id"))
    raise ValueError(f"unknown task type {t!r}")
