"""Per-query-type engines over the grouped-aggregate program.

The port's counterpart of the reference package's `engine/engines.py` for
timeseries, topN and groupBy. Partials come from one grouped-aggregate run
per segment (no batching, no sharding), merge on the host
(engine/merge.py), and finish into the reference's JSON row shapes
(timestamps as epoch millis ints).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from druid_tpu_torch.data.segment import Segment
from druid_tpu_torch.engine.grouping import KeyDim, run_grouped_aggregate
from druid_tpu_torch.engine.merge import merge_partials
from druid_tpu_torch.query.model import (DefaultDimensionSpec,
                                         DefaultLimitSpec, GroupByQuery,
                                         TimeseriesQuery, TopNQuery)
from druid_tpu_torch.query.postaggs import compute_postaggs
from druid_tpu_torch.utils.granularity import Granularity
from druid_tpu_torch.utils.intervals import Interval, condense


def _segments_for(segments: Sequence[Segment],
                  intervals: Sequence[Interval]) -> List[Segment]:
    return [s for s in segments
            if any(s.interval.overlaps(iv) for iv in intervals)]


def _clamp_to_data(intervals: Sequence[Interval],
                   segs: Sequence[Segment]) -> List[Interval]:
    """Intersect query intervals with the extent of the matched segments.
    The reference never materializes buckets outside segment data (cursors
    exist per granularity bucket *within* segments —
    QueryableIndexStorageAdapter.makeCursors); clamping keeps eternity-
    interval queries from enumerating unbounded bucket ranges."""
    if not segs:
        return list(intervals)
    lo = min(s.min_time for s in segs)
    hi = max(s.max_time for s in segs) + 1
    data = Interval(lo, hi)
    out = []
    for iv in intervals:
        x = iv.intersect(data)
        if x is not None and x.width > 0:
            out.append(x)
    return out


def _bucket_starts(granularity: Granularity,
                   intervals: Sequence[Interval]) -> np.ndarray:
    if granularity.is_all:
        # single global bucket (matches grouping.make_group_spec)
        first = min((iv.start for iv in intervals), default=0)
        return np.asarray([first], dtype=np.int64) if intervals \
            else np.zeros(0, dtype=np.int64)
    parts = [granularity.bucket_starts(iv) for iv in intervals]
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)


def _covered_buckets(granularity: Granularity, starts: np.ndarray,
                     data_spans: Sequence[Tuple[int, int]],
                     intervals: Sequence[Interval]) -> np.ndarray:
    """Buckets whose span intersects actual segment data (mirrors the
    reference emitting one row per cursor bucket). `data_spans` are
    (min_time, max_time) extents of the contributing segments."""
    if len(starts) == 0:
        return np.zeros(0, dtype=bool)
    spans = []
    for mn, mx in data_spans:
        for iv in intervals:
            lo = max(mn, iv.start)
            hi = min(mx + 1, iv.end)
            if lo < hi:
                spans.append((lo, hi))
    if not spans:
        return np.zeros(len(starts), dtype=bool)
    if granularity.is_all:
        return np.ones(len(starts), dtype=bool)
    if granularity.is_uniform:
        ends = starts + granularity.period_ms
    else:
        ends = np.asarray([granularity.next_bucket(int(st)) for st in starts],
                          dtype=np.int64)
    los = np.asarray([lo for lo, _ in spans], dtype=np.int64)
    his = np.asarray([hi for _, hi in spans], dtype=np.int64)
    # bucket i covered iff any span overlaps [starts[i], ends[i])
    return ((starts[:, None] < his[None, :])
            & (ends[:, None] > los[None, :])).any(axis=1)


def _vectorized_postaggs(postaggs, value_arrays: Dict[str, np.ndarray]):
    out = dict(value_arrays)
    for pa in postaggs:
        out[pa.name] = pa.compute(out)
    return out


def _keydim_for(segment: Segment,
                spec: DefaultDimensionSpec) -> Tuple[KeyDim, List[str]]:
    """KeyDim + local id -> output value list for one dimension spec. A
    column the segment lacks groups as the single value ""."""
    col = segment.dims.get(spec.dimension)
    if col is None:
        if spec.dimension in segment.metrics:
            raise NotImplementedError(
                f"grouping on numeric column {spec.dimension!r}")
        return KeyDim(None, 1), [""]
    return KeyDim(spec.dimension, col.cardinality), col.dictionary.values


def _keydims_for_query(query, segs: Sequence[Segment]):
    """Per-segment KeyDims + decode value lists for an aggregate query."""
    if isinstance(query, TimeseriesQuery):
        dims = ()
    elif isinstance(query, TopNQuery):
        dims = (query.dimension,)
    elif isinstance(query, GroupByQuery):
        dims = query.dimensions
    else:
        raise TypeError(f"not an aggregate query: {type(query).__name__}")
    kds_per_seg, vals_per_seg = [], []
    for s in segs:
        pairs = [_keydim_for(s, d) for d in dims]
        kds_per_seg.append([kd for kd, _ in pairs])
        vals_per_seg.append([v for _, v in pairs])
    return kds_per_seg, vals_per_seg


class AggregatePartials:
    """Per-segment partial states of one query, before the merge: states
    are host arrays, dim_values the per-segment decode lists, spans the
    (min_time, max_time) data extents for bucket-coverage accounting."""

    def __init__(self, partials, dim_values, spans, intervals):
        self.partials = partials          # List[SegmentPartial]
        self.dim_values = dim_values      # parallel: List[List[List[str]]]
        self.spans = spans                # List[(min_ms, max_ms)]
        self.intervals = intervals        # intervals partials were built with


def make_aggregate_partials(query, segments: Sequence[Segment],
                            device: torch.device) -> AggregatePartials:
    """Partial states for a timeseries/topN/groupBy query over local
    segments, one grouped-aggregate run per segment on `device`."""
    intervals = condense(query.intervals)
    segs = _segments_for(segments, intervals)
    if not query.granularity.is_all:
        intervals = _clamp_to_data(intervals, segs)
    if not segs:
        return AggregatePartials([], [], [], intervals)
    kds_per_seg, vals_per_seg = _keydims_for_query(query, segs)
    partials = [run_grouped_aggregate(s, intervals, query.granularity, kds,
                                      query.aggregations, query.filter,
                                      device)
                for s, kds in zip(segs, kds_per_seg)]
    spans = [(s.min_time, s.max_time) for s in segs]
    return AggregatePartials(partials, vals_per_seg, spans, intervals)


def run_timeseries(query: TimeseriesQuery, segments: Sequence[Segment],
                   device: torch.device) -> List[dict]:
    return finish_timeseries(query, make_aggregate_partials(query, segments,
                                                            device))


def run_topn(query: TopNQuery, segments: Sequence[Segment],
             device: torch.device) -> List[dict]:
    return finish_topn(query, make_aggregate_partials(query, segments, device))


def run_groupby(query: GroupByQuery, segments: Sequence[Segment],
                device: torch.device) -> List[dict]:
    return finish_groupby(query, make_aggregate_partials(query, segments,
                                                         device))


def finish_timeseries(query: TimeseriesQuery,
                      ap: AggregatePartials) -> List[dict]:
    intervals = ap.intervals
    starts = _bucket_starts(query.granularity, intervals)
    if not ap.partials or len(starts) == 0:
        return []
    buckets, _, counts, states, kernels = merge_partials(
        ap.partials, [[] for _ in ap.partials])
    finalized = {k.name: k.finalize_array(states[k.name]) for k in kernels}

    covered = _covered_buckets(query.granularity, starts, ap.spans, intervals)
    empty_defaults = {k.name: k.finalize_array(k.empty_state(1))[0]
                      for k in kernels}

    by_bucket = {int(b): i for i, b in enumerate(buckets)}
    rows = []
    for bi, st in enumerate(starts):
        gi = by_bucket.get(bi)
        if gi is None:
            if not covered[bi] or query.skip_empty_buckets:
                continue
            vals = {name: _scalar(v) for name, v in empty_defaults.items()}
        else:
            if query.skip_empty_buckets and counts[gi] == 0:
                continue
            vals = {k.name: _scalar(finalized[k.name][gi]) for k in kernels}
        vals = compute_postaggs(query.post_aggregations, vals)
        rows.append({"timestamp": int(st), "result": vals})
    if query.descending:
        rows.reverse()
    return rows


def _scalar(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray) and v.ndim == 0:
        return v.item()
    return v


def finish_topn(query: TopNQuery, ap: AggregatePartials) -> List[dict]:
    intervals = ap.intervals
    starts = _bucket_starts(query.granularity, intervals)
    if not ap.partials or len(starts) == 0:
        return []
    buckets, dim_vals, counts, states, kernels = merge_partials(
        ap.partials, ap.dim_values)
    finalized = {k.name: k.finalize_array(states[k.name]) for k in kernels}
    arrays = _vectorized_postaggs(query.post_aggregations, finalized)
    values = dim_vals[0] if dim_vals else np.zeros(0, dtype=object)
    out_name = query.dimension.output_name

    # live groups only
    live = counts > 0
    buckets, values = buckets[live], values[live]
    arrays = {k: np.asarray(v)[live] for k, v in arrays.items()}

    ordering = query.metric_ordering
    rows = []
    covered = _covered_buckets(query.granularity, starts, ap.spans, intervals)
    for bi, st in enumerate(starts):
        sel = buckets == bi
        if not sel.any():
            if covered[bi]:
                rows.append({"timestamp": int(st), "result": []})
            continue
        idx = np.flatnonzero(sel)
        if ordering in ("lexicographic",):
            order = np.argsort(values[idx].astype(str))
        elif ordering == "inverted_lexicographic":
            order = np.argsort(values[idx].astype(str))[::-1]
        elif ordering == "strlen":
            order = np.argsort([len(str(v)) for v in values[idx]])
        else:
            metric_arr = np.asarray(arrays[query.metric], dtype=np.float64)
            order = np.argsort(-metric_arr[idx], kind="stable")
            if ordering == "inverted":
                order = order[::-1]
        top = idx[order[: query.threshold]]
        result = []
        for gi in top:
            entry = {out_name: values[gi]}
            for name, arr in arrays.items():
                entry[name] = _scalar(np.asarray(arr)[gi])
            result.append(entry)
        rows.append({"timestamp": int(st), "result": result})
    return rows


def finish_groupby(query: GroupByQuery, ap: AggregatePartials) -> List[dict]:
    intervals = ap.intervals
    starts = _bucket_starts(query.granularity, intervals)
    if not ap.partials or len(starts) == 0:
        return []
    buckets, dim_vals, counts, states, kernels = merge_partials(
        ap.partials, ap.dim_values)
    finalized = {k.name: k.finalize_array(states[k.name]) for k in kernels}
    arrays = _vectorized_postaggs(query.post_aggregations, finalized)

    live = counts > 0
    out_names = [d.output_name for d in query.dimensions]
    rows = _emit_groupby_rows(starts, buckets, dim_vals, arrays, live, out_names,
                              kernels, query)
    rows = _apply_limit_spec(rows, query.limit_spec, out_names)
    return rows


def _emit_groupby_rows(starts, buckets, dim_vals, arrays, live, out_names,
                       kernels, query) -> List[dict]:
    # columnar → row dicts via one .tolist() per column: at 100k+ groups the
    # per-element numpy scalar extraction would dominate the whole query
    idxs = np.flatnonzero(live)
    n = len(idxs)
    if len(starts):
        ts = np.asarray(starts)[np.asarray(buckets)[idxs]].tolist()
    else:
        ts = [0] * n
    agg_names = [k.name for k in kernels] + [p.name for p in query.post_aggregations]
    cols = [(name, np.asarray(vals)[idxs].tolist())
            for name, vals in zip(out_names, dim_vals)]
    cols += [(name, np.asarray(arrays[name])[idxs].tolist())
             for name in agg_names]
    rows = []
    for i in range(n):
        event = {name: lst[i] for name, lst in cols}
        rows.append({"version": "v1", "timestamp": int(ts[i]),
                     "event": event})
    return rows


def _apply_limit_spec(rows: List[dict], limit_spec: Optional[DefaultLimitSpec],
                      dim_names: List[str]) -> List[dict]:
    if limit_spec is None:
        return rows
    if limit_spec.columns:
        # stable multi-column sort: apply columns in reverse significance order
        for c in reversed(limit_spec.columns):
            descending = c.direction == "descending"

            def one_key(row, col=c):
                # "__timestamp" orders by the granularity bucket (used by
                # SQL ORDER BY on a FLOOR(__time TO ...) projection)
                v = row["timestamp"] if col.dimension == "__timestamp" \
                    else row["event"].get(col.dimension)
                if col.dimension_order == "numeric" or not isinstance(v, str):
                    try:
                        v = float(v)
                    except (TypeError, ValueError):
                        v = float("-inf")
                return v
            rows = sorted(rows, key=one_key, reverse=descending)
    start = limit_spec.offset
    end = None if limit_spec.limit is None else start + limit_spec.limit
    return rows[start:end]
