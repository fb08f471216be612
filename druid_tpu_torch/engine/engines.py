"""Per-query-type engines over the grouped-aggregate program.

The port's counterpart of the reference package's `engine/engines.py` for
timeseries, topN and groupBy. Dimension specs become KeyDims here
(`_keydim_for`: extraction and listFiltered remaps, numeric and expression
dimensions as query-time dictionaries, unified across the query's segments
by `unify_query_dims`). Partials come from `_make_partials`: batching
first (engine/batching.py: one stacked run per chunk of shape-compatible
small segments), then one grouped-aggregate run per segment for whatever it
returns None for (no sharding: the mesh is not ported). They merge on the
host (engine/merge.py) and finish into the reference's JSON row shapes
(timestamps as epoch millis ints).
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from druid_tpu_torch.data.segment import Segment
from druid_tpu_torch.engine import batching
from druid_tpu_torch.engine.filters import _bind_string_dims
from druid_tpu_torch.engine.grouping import KeyDim, run_grouped_aggregate
from druid_tpu_torch.engine.merge import merge_partials
from druid_tpu_torch.query.model import (DefaultLimitSpec, DimensionSpec,
                                         ExpressionDimensionSpec,
                                         GroupByQuery,
                                         ListFilteredDimensionSpec,
                                         TimeseriesQuery, TopNQuery)
from druid_tpu_torch.query.postaggs import compute_postaggs
from druid_tpu_torch.utils.expression import parse_expression
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
                spec: DimensionSpec) -> Tuple[KeyDim, List]:
    """KeyDim + local id -> output value list for one dimension spec.

    Extraction fns and listFiltered run on the host over the dictionary
    into an id remap table (cached per segment; -1 drops the row), the
    reference's per-row ExtractionFn at O(cardinality). A numeric column
    groups through a query-time dictionary of its values (np.unique, cached
    per segment), staged as a derived id column. A column the segment lacks
    groups as the single value ""."""
    if isinstance(spec, ExpressionDimensionSpec):
        return _expr_keydim(segment, spec)
    col = segment.dims.get(spec.dimension)
    num_ids = num_vals = None
    dim_col = spec.dimension
    if col is None:
        m = segment.metrics.get(spec.dimension)
        if m is None:
            return KeyDim(None, 1), [""]

        def _compute_num():
            uniq, inv = np.unique(m.values, return_inverse=True)
            return inv.astype(np.int32), [v.item() for v in uniq]
        num_ids, num_vals = segment.aux_cached(("numdim", spec.dimension),
                                               _compute_num)
        dim_col = f"__numdim_{spec.dimension}"

    fn = spec.extraction_fn
    whitelist = None
    is_white = True
    if isinstance(spec, ListFilteredDimensionSpec):
        whitelist = set(spec.values)
        is_white = spec.is_whitelist

    ids_key = ("numdim_ids", spec.dimension) if num_ids is not None else None
    if fn is None and whitelist is None:
        if col is None:
            return KeyDim(dim_col, max(len(num_vals), 1), None,
                          host_ids=num_ids, ids_key=ids_key), \
                (num_vals or [""])
        return KeyDim(spec.dimension, col.cardinality), \
            col.dictionary.values

    cache_key = ("keydim", spec.dimension,
                 json.dumps(fn.cache_key(), sort_keys=True) if fn else None,
                 tuple(sorted(whitelist)) if whitelist is not None else None,
                 is_white)

    def _compute():
        # extraction fns see the STRING form of numeric values (the
        # reference's ExtractionFn contract)
        vals = [str(v) for v in num_vals] if col is None \
            else col.dictionary.values
        raw = fn.apply_all(vals) if fn else vals
        outs = ["" if o is None else str(o) for o in raw]
        keep = [True] * len(outs)
        if whitelist is not None:
            for i, o in enumerate(outs):
                inside = o in whitelist
                keep[i] = inside if is_white else not inside
        uniq = sorted({o for o, k in zip(outs, keep) if k})
        index = {v: i for i, v in enumerate(uniq)}
        remap = np.asarray(
            [index[o] if k else -1 for o, k in zip(outs, keep)],
            dtype=np.int32)
        return remap, uniq

    remap, uniq = segment.aux_cached(cache_key, _compute)
    return KeyDim(dim_col, max(len(uniq), 1), remap, host_ids=num_ids,
                  ids_key=ids_key), (uniq or [""])


def _expr_keydim(segment: Segment,
                 spec: ExpressionDimensionSpec) -> Tuple[KeyDim, List]:
    """An expression dimension: evaluated on the host over the segment's
    columns (numpy; string dimensions bind decoded, so string comparisons
    work), then np.unique into a per-segment value dictionary, as the
    reference does. The device groups by the derived ids."""
    cache_key = ("exprdim", spec.expression, spec.output_type)

    def _compute():
        expr = parse_expression(spec.expression)
        bindings: Dict[str, np.ndarray] = {"__time": segment.time_ms}
        bindings.update((n, m.values) for n, m in segment.metrics.items())
        _bind_string_dims(expr, segment, bindings)
        vals = np.broadcast_to(np.asarray(expr.evaluate(bindings)),
                               (segment.n_rows,))
        uniq, inv = np.unique(vals, return_inverse=True)
        out = [v.item() if hasattr(v, "item") else v for v in uniq]
        if spec.output_type == "string":
            out = [str(v) for v in out]
        return inv.astype(np.int32), out

    ids, vals = segment.aux_cached(cache_key, _compute)
    return KeyDim(f"__exprdim_{spec.output_name}", max(len(vals), 1), None,
                  host_ids=ids,
                  ids_key=("exprdim_ids", spec.expression,
                           spec.output_type)), (vals or [""])


def unify_query_dims(segs: Sequence[Segment], kds_per_seg,
                     vals_per_seg) -> None:
    """Unify per-segment query-time dictionaries (numeric and expression
    dimensions: KeyDim.host_ids) into one id space across the query's
    segments, in place: each segment's local ids remap on the host into the
    sorted union of every segment's values. Ids decode to the same values;
    the space is merely shared. One remapped id column per (segment,
    dimension) is kept, replaced when the union changes."""
    if len(segs) < 2 or not kds_per_seg or not kds_per_seg[0]:
        return
    for j in range(len(kds_per_seg[0])):
        col = [kds[j] for kds in kds_per_seg]
        if not all(kd.host_ids is not None and kd.remap is None
                   and kd.ids_key is not None for kd in col):
            continue
        lists = [vals[j] for vals in vals_per_seg]
        if all(v == lists[0] for v in lists[1:]):
            continue                  # already one id space
        try:
            union = sorted(set().union(*map(set, lists)))
        except TypeError:
            continue                  # unorderable mixed types: per segment
        udig = hashlib.sha1(repr(union).encode()).hexdigest()[:16]
        index = {v: i for i, v in enumerate(union)}
        for s, kds, vals in zip(segs, kds_per_seg, vals_per_seg):
            kd = kds[j]
            slot = s.aux_cached(("unidim",) + tuple(kd.ids_key), dict)
            new_ids = slot.get(udig)
            if new_ids is None:
                remap = np.asarray([index[v] for v in vals[j]],
                                   dtype=np.int32)
                new_ids = remap[kd.host_ids]
                slot.clear()
                slot[udig] = new_ids
            kds[j] = KeyDim(kd.column, max(len(union), 1), None,
                            host_ids=new_ids,
                            ids_key=("unidim",) + tuple(kd.ids_key)
                            + (udig,))
            vals[j] = list(union)


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
    unify_query_dims(segs, kds_per_seg, vals_per_seg)
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


def _make_partials(segs, intervals, query, kds_per_seg,
                   device: torch.device, check=None):
    """One partial per segment: batched runs over shape-compatible
    segments, and one run per segment for the rest (or for all, where
    batching returns None). `check` (a cancel or timeout probe) runs at
    every run boundary."""
    if check is not None:
        check()
    partials = batching.run_with_batching(
        segs, intervals, query.granularity, kds_per_seg, query.aggregations,
        query.filter, device, query.virtual_columns,
        context=query.context_map, check=check)
    if partials is None:
        partials = []
        for s, kds in zip(segs, kds_per_seg):
            if check is not None and partials:
                check()
            partials.append(run_grouped_aggregate(
                s, intervals, query.granularity, kds, query.aggregations,
                query.filter, device, query.virtual_columns))
    return partials


def _query_plan(query, segments: Sequence[Segment]):
    """(intervals, matched segments, per-segment KeyDims, value lists): the
    host derivation every partial-producing path shares."""
    intervals = condense(query.intervals)
    segs = _segments_for(segments, intervals)
    if not query.granularity.is_all:
        intervals = _clamp_to_data(intervals, segs)
    if not segs:
        return intervals, segs, [], []
    kds_per_seg, vals_per_seg = _keydims_for_query(query, segs)
    return intervals, segs, kds_per_seg, vals_per_seg


def make_aggregate_partials(query, segments: Sequence[Segment],
                            device: torch.device,
                            check=None) -> AggregatePartials:
    """Partial states for a timeseries/topN/groupBy query over local
    segments on `device`."""
    intervals, segs, kds_per_seg, vals_per_seg = _query_plan(query,
                                                             segments)
    if not segs:
        return AggregatePartials([], [], [], intervals)
    partials = _make_partials(segs, intervals, query, kds_per_seg, device,
                              check=check)
    spans = [(s.min_time, s.max_time) for s in segs]
    return AggregatePartials(partials, vals_per_seg, spans, intervals)


def make_aggregate_partials_multi(items, device: torch.device,
                                  on_batch=None) -> List[object]:
    """Partials of several queries in one call, their segments batched
    across queries. `items` are (query, segments, check) triples over local
    segments. Returns one entry per item: its AggregatePartials, or the
    exception its planning or its `check` raised. Each query's host
    derivation is the single-query path's, so each result equals that
    query's make_aggregate_partials. `on_batch(n_queries, n_segments,
    fill)` observes each stacked run."""
    work: List[batching.BatchWork] = []
    meta: List[object] = []   # per item: (intervals, segs, vals) or result
    for query, segments, check in items:
        try:
            intervals, segs, kds_per_seg, vals_per_seg = _query_plan(
                query, segments)
        except Exception as e:
            meta.append(e)
            continue
        if not segs:
            meta.append(AggregatePartials([], [], [], intervals))
            continue
        meta.append((intervals, segs, vals_per_seg))
        work.append(batching.BatchWork(
            segs=segs, intervals=intervals, granularity=query.granularity,
            kds_per_seg=kds_per_seg, aggs=query.aggregations,
            flt=query.filter, virtual_columns=query.virtual_columns,
            context=query.context_map, check=check))
    multi = iter(batching.run_multi_with_batching(work, device,
                                                  on_batch=on_batch))
    out: List[object] = []
    for m in meta:
        if not isinstance(m, tuple):
            out.append(m)
            continue
        intervals, segs, vals_per_seg = m
        got = next(multi)
        if isinstance(got, BaseException):
            out.append(got)
            continue
        spans = [(s.min_time, s.max_time) for s in segs]
        out.append(AggregatePartials(got, list(vals_per_seg), spans,
                                     intervals))
    return out


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
