"""Per-host query executor: run queries over local segments.

The port's counterpart of the reference package's `engine/executor.py`:
segments grouped by datasource, the ten query types dispatched to the
engines, over a table, union or query dataSource (a query dataSource's
inner groupBy rows become a segment, `subquery_segment`), with the
`chunkPeriod` and `bySegment` contexts. Queries run on CUDA unless the
caller passes device="cpu". With a mesh (parallel/context.py), an eligible
grouped aggregate runs as one sharded run over it, merged on the card
(parallel/distributed.py); without one, shape-compatible small segments
batch into one stacked run per chunk (engine/batching.py; a query opts out
with the context {"batchSegments": false}).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Sequence

from druid_tpu_torch import device as device_mod
from druid_tpu_torch.data.devicepool import device_pool
from druid_tpu_torch.data.segment import Segment, SegmentBuilder
from druid_tpu_torch.engine import engines
from druid_tpu_torch.parallel import context as mesh_context
from druid_tpu_torch.query.model import (DataSourceMetadataQuery,
                                         GroupByQuery, Query, ScanQuery,
                                         SearchQuery, SegmentMetadataQuery,
                                         SelectQuery, TimeBoundaryQuery,
                                         TimeseriesQuery, TopNQuery,
                                         query_from_json)
from druid_tpu_torch.utils.intervals import (Interval, condense,
                                             parse_period_ms,
                                             split_by_period)


def apply_interval_chunking(query: Query) -> Query:
    """The `chunkPeriod` context: split the query's intervals into chunks
    aligned to the period (Druid's IntervalChunkingQueryRunner). The engines
    test every interval in one mask, so chunking changes no row."""
    p = query.context_map.get("chunkPeriod")
    if not p:
        return query
    period = parse_period_ms(p)
    chunks: list = []
    for iv in condense(query.intervals):
        chunks.extend(split_by_period(iv, period))
    if tuple(chunks) == tuple(query.intervals):
        return query
    return replace(query, intervals=tuple(chunks))


class QueryExecutor:
    """Runs queries over an in-process set of segments on one device."""

    def __init__(self, segments: Optional[Sequence[Segment]] = None,
                 device=None, device_pool_bytes: Optional[int] = None,
                 mesh: Optional[mesh_context.Mesh] = None):
        """`device`: None or "cuda" runs on the current CUDA device and
        raises when there is none; "cpu" runs the plain PyTorch versions.
        `device_pool_bytes`: the byte budget of the process-wide device
        pool (data/devicepool.py; 0 = unbounded); None keeps the current
        one. `mesh` (parallel.make_mesh): eligible grouped aggregates run
        as one sharded run over it; its devices must be of the executor's
        device type (a CUDA mesh with device="cpu", or a CPU mesh on CUDA,
        raises)."""
        self.device = device_mod.resolve(device)
        mesh_context.check_device(mesh, self.device)
        self.mesh = mesh
        if device_pool_bytes is not None:
            device_pool().configure(device_pool_bytes)
        self._by_ds: Dict[str, List[Segment]] = {}
        for s in segments or ():
            self.add_segment(s)

    def add_segment(self, segment: Segment):
        self._by_ds.setdefault(segment.id.datasource, []).append(segment)

    def drop_segment(self, segment_id) -> bool:
        """Drop the segment whose id (or its string form) is `segment_id`;
        False when none is loaded."""
        for segs in self._by_ds.values():
            for s in segs:
                if s.id == segment_id or str(s.id) == str(segment_id):
                    segs.remove(s)
                    return True
        return False

    def segments_of(self, datasource: str) -> List[Segment]:
        return list(self._by_ds.get(datasource, ()))

    @property
    def datasources(self) -> List[str]:
        return sorted(self._by_ds)

    def _table_segments(self, query: Query) -> List[Segment]:
        """The segments of a table or union dataSource."""
        if query.union_datasources:
            return [s for d in query.union_datasources
                    for s in self._by_ds.get(d, [])]
        return self._by_ds.get(query.datasource, [])

    def run(self, query: Query, segments: Optional[Sequence[Segment]] = None):
        query = apply_interval_chunking(query)
        if segments is not None:
            segs = list(segments)
        elif query.inner_query is not None:
            # a query dataSource: the inner rows become one segment, which
            # the outer query reads through the ordinary engines
            inner_rows = self.run(query.inner_query)
            segs = [subquery_segment(query.inner_query, inner_rows)]
        else:
            segs = self._table_segments(query)
        if self.mesh is not None:
            with mesh_context.use_mesh(self.mesh):
                return self._dispatch(query, segs)
        return self._dispatch(query, segs)

    def run_streaming(self, query: Query,
                      segments: Optional[Sequence[Segment]] = None):
        """An iterator of result batches. A scan streams lazily: a segment
        is masked and decoded only when its batch is pulled, so a limit
        stops the scan early. Any other query's rows exist only after its
        merge; they are computed here and yielded one at a time."""
        if isinstance(query, ScanQuery) and query.inner_query is None:
            query = apply_interval_chunking(query)
            segs = list(segments) if segments is not None \
                else self._table_segments(query)
            return engines.iter_scan(query, segs, self.device)
        return iter(self.run(query, segments))

    def _dispatch(self, query: Query, segs: List[Segment]):
        dev = self.device
        if isinstance(query, (TimeseriesQuery, TopNQuery, GroupByQuery)) \
                and query.context_map.get("bySegment"):
            return engines.run_by_segment(query, segs, dev)
        if isinstance(query, TimeseriesQuery):
            return engines.run_timeseries(query, segs, dev)
        if isinstance(query, TopNQuery):
            return engines.run_topn(query, segs, dev)
        if isinstance(query, GroupByQuery):
            return engines.run_groupby(query, segs, dev)
        if isinstance(query, ScanQuery):
            return engines.run_scan(query, segs, dev)
        if isinstance(query, SelectQuery):
            return engines.run_select(query, segs, dev)
        if isinstance(query, SearchQuery):
            return engines.run_search(query, segs, dev)
        if isinstance(query, TimeBoundaryQuery):
            return engines.run_time_boundary(query, segs, dev)
        if isinstance(query, SegmentMetadataQuery):
            return engines.run_segment_metadata(query, segs)
        if isinstance(query, DataSourceMetadataQuery):
            return engines.run_datasource_metadata(query, segs)
        raise ValueError(f"unsupported query type {type(query).__name__}")

    def run_json(self, query_json: dict):
        """Execute a reference-wire-format JSON query."""
        return self.run(query_from_json(query_json))


def subquery_segment(inner_query: Query, rows) -> Segment:
    """The rows of an inner groupBy as a segment, so that the outer query
    runs through the ordinary engines (Druid re-groups subquery rows
    through an incremental index, GroupByStrategyV2.processSubqueryResult).
    An inner dimension whose first non-null value is a number becomes a
    numeric column, its nulls 0 (Druid's default null handling); the other
    dimensions stay strings, and every numeric event value that is not a
    dimension becomes a metric."""
    if not isinstance(inner_query, GroupByQuery):
        raise ValueError("query dataSource requires a groupBy inner query")
    dim_names = [d.output_name for d in inner_query.dimensions]
    ivs = condense(inner_query.intervals)
    interval = Interval(min(iv.start for iv in ivs),
                        max(iv.end for iv in ivs)) if ivs \
        else Interval.eternity()
    numeric_dims = set()
    for d in dim_names:
        for r in rows:
            v = r["event"].get(d)
            if v is None:
                continue
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                numeric_dims.add(d)
            break
    b = SegmentBuilder("__subquery__", interval, version="sub")
    for r in rows:
        event = r["event"]
        dims = {d: (None if event.get(d) is None else str(event.get(d)))
                for d in dim_names if d not in numeric_dims}
        metrics = {k: v for k, v in event.items()
                   if k not in dims and isinstance(v, (int, float))
                   and not isinstance(v, bool)}
        b.add_row(int(r["timestamp"]), dims, metrics)
    return b.build()
