"""Per-host query executor: run aggregate queries over local segments.

The port's counterpart of the reference package's `engine/executor.py`:
segments grouped by datasource, timeseries/topN/groupBy dispatched to the
engines. Queries run on CUDA unless the caller passes device="cpu".
Shape-compatible small segments batch into one stacked run per chunk
(engine/batching.py; a query opts out with the context {"batchSegments":
false}).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from druid_tpu_torch import device as device_mod
from druid_tpu_torch.data.devicepool import device_pool
from druid_tpu_torch.data.segment import Segment
from druid_tpu_torch.engine import engines
from druid_tpu_torch.query.model import (GroupByQuery, Query,
                                         TimeseriesQuery, TopNQuery,
                                         query_from_json)


class QueryExecutor:
    """Runs queries over an in-process set of segments on one device."""

    def __init__(self, segments: Optional[Sequence[Segment]] = None,
                 device=None, device_pool_bytes: Optional[int] = None):
        """`device`: None or "cuda" runs on the current CUDA device and
        raises when there is none; "cpu" runs the plain PyTorch versions.
        `device_pool_bytes`: the byte budget of the process-wide device
        pool (data/devicepool.py; 0 = unbounded); None keeps the current
        one."""
        self.device = device_mod.resolve(device)
        if device_pool_bytes is not None:
            device_pool().configure(device_pool_bytes)
        self._by_ds: Dict[str, List[Segment]] = {}
        for s in segments or ():
            self.add_segment(s)

    def add_segment(self, segment: Segment):
        self._by_ds.setdefault(segment.id.datasource, []).append(segment)

    def run(self, query: Query, segments: Optional[Sequence[Segment]] = None):
        segs = list(segments) if segments is not None \
            else self._by_ds.get(query.datasource, [])
        if query.context_map.get("bySegment"):
            raise NotImplementedError("bySegment context")
        if query.context_map.get("chunkPeriod"):
            raise NotImplementedError("chunkPeriod context")
        if isinstance(query, TimeseriesQuery):
            return engines.run_timeseries(query, segs, self.device)
        if isinstance(query, TopNQuery):
            return engines.run_topn(query, segs, self.device)
        if isinstance(query, GroupByQuery):
            return engines.run_groupby(query, segs, self.device)
        raise NotImplementedError(f"query type {type(query).__name__}")

    def run_json(self, query_json: dict):
        """Execute a reference-wire-format JSON query."""
        return self.run(query_from_json(query_json))
