"""Segment descriptors and the metadata store's errors.

The port's own copy of the part of the reference package's
`cluster/metadata.py` that the broker and its cluster view need:
`SegmentDescriptor` (the DataSegment analog: identity, shard spec and size,
without the column data), `SegmentAllocationError` and `StaleTermError`.
The SQL `MetadataStore` itself waits for the coordinator (ROADMAP A18).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from druid_tpu_torch.cluster.shardspec import ShardSpec, shardspec_from_json
from druid_tpu_torch.utils.intervals import Interval


class SegmentAllocationError(RuntimeError):
    """Allocation refused: the bucket conflicts with differently-aligned
    committed segments (SegmentAllocateAction returns null there)."""


class StaleTermError(RuntimeError):
    """A fenced write carried a term older than the current lease term:
    the writer's lease was taken over and it must stop acting as leader
    (the fencing-token rejection of a zombie leader's writes)."""


@dataclass(frozen=True)
class SegmentDescriptor:
    """DataSegment analog (api/.../timeline/DataSegment.java): identity +
    shard spec + size/location metadata, without the column data."""
    datasource: str
    interval: Interval
    version: str
    partition: int = 0
    shard_spec: Optional[ShardSpec] = None
    size_bytes: int = 0
    num_rows: int = 0
    load_spec: Optional[dict] = None   # where the segment file lives

    @property
    def id(self) -> str:
        return (f"{self.datasource}_{self.interval}_{self.version}"
                f"_{self.partition}")

    def to_json(self) -> dict:
        return {"dataSource": self.datasource, "interval": str(self.interval),
                "version": self.version,
                "shardSpec": (self.shard_spec.to_json() if self.shard_spec
                              else {"type": "numbered",
                                    "partitionNum": self.partition,
                                    "partitions": 0}),
                "size": self.size_bytes, "numRows": self.num_rows,
                "loadSpec": self.load_spec}

    @staticmethod
    def from_json(j: dict) -> "SegmentDescriptor":
        spec = shardspec_from_json(j.get("shardSpec"))
        return SegmentDescriptor(
            j["dataSource"], Interval.parse(j["interval"]), j["version"],
            getattr(spec, "partition_num", 0), spec,
            j.get("size", 0), j.get("numRows", 0), j.get("loadSpec"))
