"""Shard specs: secondary partitioning within a time chunk (the port's own
copy of the reference package's `cluster/shardspec.py`).

Capability parity with the reference's shard specs
(common/.../timeline/partition/ — NoneShardSpec, LinearShardSpec,
NumberedShardSpec, HashBasedNumberedShardSpec, SingleDimensionShardSpec).
Shard specs drive (a) partition-set completeness in the timeline MVCC,
(b) broker-side pruning (hash/range), (c) ingest-time row routing.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence


class ShardSpec:
    partition_num: int = 0

    def is_in_chunk(self, dim_values: Dict[str, Optional[str]]) -> bool:
        """Row routing at ingest (reference ShardSpec.isInChunk)."""
        return True

    def possible_in_domain(self, domain: Dict[str, List[Optional[str]]]) -> bool:
        """Broker pruning: can any row matching `domain` (dim -> candidate
        values; absent = unconstrained) live in this shard?"""
        return True

    def complete_set(self, specs: Sequence["ShardSpec"]) -> bool:
        """Is this collection of sibling specs a complete partition set?"""
        return True

    def to_json(self) -> dict:
        raise NotImplementedError


@dataclass(frozen=True)
class NoneShardSpec(ShardSpec):
    """Single unsharded chunk (reference NoneShardSpec)."""
    partition_num: int = 0

    def to_json(self):
        return {"type": "none"}


@dataclass(frozen=True)
class LinearShardSpec(ShardSpec):
    """Append-friendly: any subset is complete (reference LinearShardSpec)."""
    partition_num: int = 0

    def to_json(self):
        return {"type": "linear", "partitionNum": self.partition_num}


@dataclass(frozen=True)
class NumberedShardSpec(ShardSpec):
    """partNum of a fixed set of `partitions` core partitions; the set is
    visible only when all core partitions are present
    (reference NumberedShardSpec)."""
    partition_num: int = 0
    partitions: int = 0

    def complete_set(self, specs):
        if self.partitions == 0:
            return True  # open-ended (streaming appends)
        present = {s.partition_num for s in specs}
        return all(i in present for i in range(self.partitions))

    def to_json(self):
        return {"type": "numbered", "partitionNum": self.partition_num,
                "partitions": self.partitions}


def _hash_row(values: Sequence[Optional[str]]) -> int:
    payload = json.dumps([v if v is not None else "" for v in values])
    return int.from_bytes(
        hashlib.md5(payload.encode()).digest()[:4], "big", signed=False)


@dataclass(frozen=True)
class HashBasedNumberedShardSpec(NumberedShardSpec):
    """Rows hash-routed on partitionDimensions; the broker prunes shards
    when a filter pins every partition dimension
    (reference HashBasedNumberedShardSpec + DetermineHashedPartitionsJob)."""
    partition_num: int = 0
    partitions: int = 1
    partition_dimensions: tuple = ()

    def is_in_chunk(self, dim_values):
        if not self.partition_dimensions or self.partitions <= 1:
            return True
        vals = [dim_values.get(d) for d in self.partition_dimensions]
        return _hash_row(vals) % self.partitions == self.partition_num

    def possible_in_domain(self, domain):
        if not self.partition_dimensions or self.partitions <= 1:
            return True
        candidate_lists = []
        for d in self.partition_dimensions:
            if d not in domain:
                return True  # unconstrained dim: cannot prune
            candidate_lists.append(domain[d])
        # cartesian check (domains are small filter value sets)
        def rec(i, acc):
            if i == len(candidate_lists):
                return _hash_row(acc) % self.partitions == self.partition_num
            return any(rec(i + 1, acc + [v]) for v in candidate_lists[i])
        return rec(0, [])

    def to_json(self):
        return {"type": "hashed", "partitionNum": self.partition_num,
                "partitions": self.partitions,
                "partitionDimensions": list(self.partition_dimensions)}


@dataclass(frozen=True)
class SingleDimensionShardSpec(ShardSpec):
    """Contiguous [start, end) value range on one dimension
    (reference SingleDimensionShardSpec)."""
    dimension: str = ""
    start: Optional[str] = None  # None = unbounded below
    end: Optional[str] = None    # None = unbounded above
    partition_num: int = 0

    def _contains(self, v: Optional[str]) -> bool:
        v = "" if v is None else v
        if self.start is not None and v < self.start:
            return False
        if self.end is not None and v >= self.end:
            return False
        return True

    def is_in_chunk(self, dim_values):
        return self._contains(dim_values.get(self.dimension))

    def possible_in_domain(self, domain):
        if self.dimension not in domain:
            return True
        return any(self._contains(v) for v in domain[self.dimension])

    def complete_set(self, specs):
        # complete iff ranges tile (-inf, +inf) contiguously
        rs = sorted(specs, key=lambda s: ("" if s.start is None else s.start,))
        if not rs or rs[0].start is not None or rs[-1].end is not None:
            return False
        for a, b in zip(rs, rs[1:]):
            if a.end is None or b.start is None or a.end != b.start:
                return False
        return True

    def to_json(self):
        return {"type": "single", "dimension": self.dimension,
                "start": self.start, "end": self.end,
                "partitionNum": self.partition_num}


def shardspec_from_json(j: Optional[dict]) -> ShardSpec:
    if not j:
        return NoneShardSpec()
    t = j.get("type", "none")
    if t == "none":
        return NoneShardSpec()
    if t == "linear":
        return LinearShardSpec(j.get("partitionNum", 0))
    if t == "numbered":
        return NumberedShardSpec(j.get("partitionNum", 0),
                                 j.get("partitions", 0))
    if t == "hashed":
        return HashBasedNumberedShardSpec(
            j.get("partitionNum", 0), j.get("partitions", 1),
            tuple(j.get("partitionDimensions", [])))
    if t == "single":
        return SingleDimensionShardSpec(
            j.get("dimension", ""), j.get("start"), j.get("end"),
            j.get("partitionNum", 0))
    raise ValueError(f"unknown shardSpec type {t!r}")
