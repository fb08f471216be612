"""Per-query-type engines: the grouped-aggregate program and the six
non-aggregate engines.

The port's counterpart of the reference package's `engine/engines.py`. For
timeseries, topN and groupBy (with having, subtotals and bySegment),
dimension specs become KeyDims here
(`_keydim_for`: extraction and listFiltered remaps, numeric and expression
dimensions as query-time dictionaries, unified across the query's segments
by `unify_query_dims`). Partials come from `_make_partials`: with a mesh
installed (parallel/context.py), one sharded run over the whole segment set
first (parallel/distributed.py), whose states merge on the card into one
partial; else batching (engine/batching.py: one stacked run per chunk of
shape-compatible small segments), then one grouped-aggregate run per
segment for whatever it returns None for. The partials merge on the host
(engine/merge.py) and finish into the reference's JSON row shapes
(timestamps as epoch millis ints).

Scan, select, search and timeBoundary mask each segment on the device
(`filters.host_mask` and the interval test); only the surviving row ids,
or search's value counts (`torch.bincount`) and timeBoundary's masked
min/max, come back to the host, which decodes rows as the reference does.
segmentMetadata and dataSourceMetadata read host metadata.
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
import weakref
from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from druid_tpu_torch.data.segment import Segment
from druid_tpu_torch.engine import batching
from druid_tpu_torch.engine.filters import (_bind_string_dims,
                                            _dictionary_lut, masked_columns)
from druid_tpu_torch.engine.grouping import KeyDim, run_grouped_aggregate
from druid_tpu_torch.engine.merge import merge_partials
from druid_tpu_torch.obs.trace import span as trace_span
from druid_tpu_torch.parallel import distributed
from druid_tpu_torch.query.model import (DataSourceMetadataQuery,
                                         DefaultLimitSpec, DimensionSpec,
                                         ExpressionDimensionSpec,
                                         GroupByQuery,
                                         ListFilteredDimensionSpec, ScanQuery,
                                         SearchQuery, SegmentMetadataQuery,
                                         SelectQuery, TimeBoundaryQuery,
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


#: seconds a union-remap slot may stay untouched before the sweep clears
#: it: a rolling set of segments retires union digests, and each (segment,
#: dimension) slot would otherwise pin its last n_rows x 4 B remap for the
#: segment's life. Hot dashboards, re-touched every query, never expire.
#: <= 0 disables expiry. `set_unidim_ttl` is the one way to change it.
_UNIDIM_TTL_S = 900.0
_UNIDIM_LOCK = threading.Lock()


class _UnidimSlot(dict):
    """Weakref-able remap slot ({union digest: remapped ids}) with a
    last-touch stamp; the registry holds weak references only, so a
    collected segment's slots vanish without bookkeeping. Identity
    hash/eq: dict is unhashable and content-equality would collide
    distinct (empty) slots inside the WeakSet registry."""
    __slots__ = ("__weakref__", "touched")
    __hash__ = object.__hash__

    def __eq__(self, other):
        return self is other

    def __ne__(self, other):
        return self is not other


_UNIDIM_SLOTS: "weakref.WeakSet[_UnidimSlot]" = weakref.WeakSet()


def set_unidim_ttl(seconds: float) -> float:
    """Set the union-remap TTL in seconds; returns the previous value."""
    global _UNIDIM_TTL_S
    with _UNIDIM_LOCK:
        prev = _UNIDIM_TTL_S
        _UNIDIM_TTL_S = float(seconds)
        return prev


def _sweep_unidim(now: float) -> int:
    """Clear every union-remap slot idle past the TTL; returns the number
    of slots cleared. Runs at each unify_query_dims entry: the only growth
    source is that path, so no background thread is needed."""
    cleared = 0
    with _UNIDIM_LOCK:
        ttl = _UNIDIM_TTL_S
        if ttl <= 0:
            return 0
        for slot in list(_UNIDIM_SLOTS):
            if slot and now - getattr(slot, "touched", now) > ttl:
                slot.clear()
                cleared += 1
    return cleared


def unify_query_dims(segs: Sequence[Segment], kds_per_seg,
                     vals_per_seg) -> None:
    """Unify per-segment query-time dictionaries (numeric and expression
    dimensions: KeyDim.host_ids) into one id space across the query's
    segments, in place: each segment's local ids remap on the host into the
    sorted union of every segment's values. Ids decode to the same values;
    the space is merely shared. One remapped id column per (segment,
    dimension) is kept, replaced when the union changes and cleared by the
    TTL sweep when idle."""
    if len(segs) < 2 or not kds_per_seg or not kds_per_seg[0]:
        return
    now = time.monotonic()
    _sweep_unidim(now)
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
            slot = s.aux_cached(("unidim",) + tuple(kd.ids_key),
                                _UnidimSlot)
            with _UNIDIM_LOCK:
                _UNIDIM_SLOTS.add(slot)
            slot.touched = now
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

    @staticmethod
    def concat(parts: Sequence["AggregatePartials"]) -> "AggregatePartials":
        """One AggregatePartials of several producers' (data nodes',
        cached segments'), in the order given; the first producer's
        intervals stand for all (the broker bounds them alike)."""
        parts = [p for p in parts if p is not None]
        out = AggregatePartials([], [], [], None)
        for p in parts:
            out.partials += list(p.partials)
            out.dim_values += list(p.dim_values)
            out.spans += list(p.spans)
            if out.intervals is None:
                out.intervals = p.intervals
        return out


def _make_partials(segs, intervals, query, kds_per_seg, vals_per_seg,
                   device: torch.device, check=None):
    """(partials, dim_values): one sharded run merged on the card where a
    mesh is installed and the segments agree on their plan (one partial,
    decoded through the first segment's values); else one partial per
    segment, from batched runs over shape-compatible segments and one run
    per segment for the rest (or for all, where batching returns None).
    `check` (a cancel or timeout probe) runs at every run boundary, and
    before the sharded run."""
    if check is not None:
        check()
    with trace_span("engine/partials", segments=len(segs)):
        merged = distributed.try_sharded(
            segs, intervals, query.granularity, kds_per_seg,
            query.aggregations, query.filter, query.virtual_columns)
        if merged is not None:
            return [merged], [vals_per_seg[0]]
        partials = batching.run_with_batching(
            segs, intervals, query.granularity, kds_per_seg,
            query.aggregations, query.filter, device, query.virtual_columns,
            context=query.context_map, check=check)
        if partials is None:
            partials = []
            for s, kds in zip(segs, kds_per_seg):
                if check is not None and partials:
                    check()
                partials.append(run_grouped_aggregate(
                    s, intervals, query.granularity, kds, query.aggregations,
                    query.filter, device, query.virtual_columns))
    return partials, list(vals_per_seg)


def _query_plan(query, segments: Sequence[Segment], clamp: bool = True):
    """(intervals, matched segments, per-segment KeyDims, value lists): the
    host derivation every partial-producing path shares. With `clamp` (and
    a granularity other than all) the intervals shrink to the matched
    segments' data; the broker path passes clamp=False, having bounded the
    intervals itself, so that every node's bucket index space is the
    same."""
    intervals = condense(query.intervals)
    segs = _segments_for(segments, intervals)
    if clamp and not query.granularity.is_all:
        intervals = _clamp_to_data(intervals, segs)
    if not segs:
        return intervals, segs, [], []
    kds_per_seg, vals_per_seg = _keydims_for_query(query, segs)
    return intervals, segs, kds_per_seg, vals_per_seg


def _partials_with_segs(query, segments: Sequence[Segment],
                        device: torch.device, clamp: bool, check
                        ) -> Tuple[AggregatePartials, List[Segment]]:
    with trace_span("engine/plan"):
        intervals, segs, kds_per_seg, vals_per_seg = _query_plan(
            query, segments, clamp)
    if not segs:
        return AggregatePartials([], [], [], intervals), segs
    partials, dim_values = _make_partials(segs, intervals, query,
                                          kds_per_seg, vals_per_seg, device,
                                          check=check)
    spans = [(s.min_time, s.max_time) for s in segs]
    return AggregatePartials(partials, dim_values, spans, intervals), segs


def make_aggregate_partials(query, segments: Sequence[Segment],
                            device: torch.device, clamp: bool = True,
                            check=None) -> AggregatePartials:
    """Partial states for a timeseries/topN/groupBy query over local
    segments on `device`. `clamp=False` is the broker path's: it bounds
    the query intervals across the whole cluster, so bucket index spaces
    align across nodes. `check` (an optional cancel or timeout probe)
    fires at run boundaries."""
    return _partials_with_segs(query, segments, device, clamp, check)[0]


def make_partials_by_segment(query, segments: Sequence[Segment],
                             device: torch.device, clamp: bool = False,
                             check=None) -> List[AggregatePartials]:
    """One single-segment AggregatePartials per input segment (parallel to
    `segments`; a segment outside the query intervals yields an empty one).
    The data node's segment-cache miss path runs its whole miss set through
    here: one call, so shape-compatible misses batch into shared runs
    (engine/batching.py), split back into per-segment cache entries."""
    ap, segs = _partials_with_segs(query, segments, device, clamp, check)
    if len(ap.partials) != len(segs):
        # a mesh merged the set into one partial, which cannot split back:
        # each segment runs alone (the cancel probe between runs)
        out = []
        for i, s in enumerate(segments):
            if check is not None and i:
                check()
            out.append(make_aggregate_partials(query, [s], device,
                                               clamp=clamp))
        return out
    return _split_by_segment(ap, segs, segments)


def _split_by_segment(ap: AggregatePartials, segs: Sequence[Segment],
                      segments: Sequence[Segment]
                      ) -> List[AggregatePartials]:
    """Split a per-segment AggregatePartials (partials parallel to `segs`)
    into one entry per input segment; a segment absent from `segs` (outside
    the query intervals) yields an empty partials object, as the per-miss
    cache loop would have stored for it."""
    remaining: Dict[int, List[int]] = {}
    for i, s in enumerate(segs):
        remaining.setdefault(id(s), []).append(i)
    out = []
    for s in segments:
        idxs = remaining.get(id(s))
        if idxs:
            i = idxs.pop(0)
            out.append(AggregatePartials([ap.partials[i]],
                                         [ap.dim_values[i]],
                                         [ap.spans[i]], ap.intervals))
        else:
            out.append(AggregatePartials([], [], [], ap.intervals))
    return out


def split_partials_by_segment(ap: AggregatePartials,
                              segments: Sequence[Segment]
                              ) -> List[AggregatePartials]:
    """The splitter for make_aggregate_partials_multi's items:
    `ap.partials` is parallel to `_segments_for(segments, ap.intervals)`
    by construction, so the per-input-segment split is exact. The data
    node's fused segment-cache path turns one wave's results back into
    per-segment cache entries with it."""
    segs = _segments_for(segments, ap.intervals or [])
    if len(ap.partials) != len(segs):
        raise ValueError("split_partials_by_segment needs one partial per "
                         "matched segment")
    return _split_by_segment(ap, segs, segments)


def make_aggregate_partials_multi(items, device: torch.device,
                                  on_batch=None,
                                  clamp: bool = True) -> List[object]:
    """Partials of several queries in one call, their segments batched
    across queries. `items` are (query, segments, check) triples over local
    segments. Returns one entry per item: its AggregatePartials, or the
    exception its planning or its `check` raised. Each query's host
    derivation is the single-query path's, so each result equals that
    query's make_aggregate_partials with the same `clamp` (the data node
    passes False, as the reference's fused path never clamps).
    `on_batch(n_queries, n_segments, fill)` observes each stacked run."""
    work: List[batching.BatchWork] = []
    meta: List[object] = []   # per item: (intervals, segs, vals) or result
    with trace_span("engine/plan"):
        for query, segments, check in items:
            try:
                intervals, segs, kds_per_seg, vals_per_seg = _query_plan(
                    query, segments, clamp)
            except Exception as e:
                meta.append(e)
                continue
            if not segs:
                meta.append(AggregatePartials([], [], [], intervals))
                continue
            meta.append((intervals, segs, vals_per_seg))
            work.append(batching.BatchWork(
                segs=segs, intervals=intervals,
                granularity=query.granularity, kds_per_seg=kds_per_seg,
                aggs=query.aggregations, flt=query.filter,
                virtual_columns=query.virtual_columns,
                context=query.context_map, check=check))
    with trace_span("engine/partials", queries=len(work),
                    segments=sum(len(w.segs) for w in work)):
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


def run_by_segment(query, segments: Sequence[Segment],
                   device: torch.device) -> List[dict]:
    """The bySegment context: each segment's unmerged result, wrapped with
    the segment's identity (Druid's BySegmentQueryRunner)."""
    inner = replace(query, context=tuple(
        (k, v) for k, v in query.context_map.items() if k != "bySegment"))
    finish = finish_timeseries if isinstance(query, TimeseriesQuery) \
        else finish_topn if isinstance(query, TopNQuery) else finish_groupby
    out: List[dict] = []
    for s in _segments_for(segments, condense(query.intervals)):
        rows = finish(inner, make_aggregate_partials(inner, [s], device))
        out.append({
            "timestamp": rows[0]["timestamp"] if rows else None,
            "result": {"results": rows, "segment": str(s.id),
                       "interval": str(s.interval)},
            "bySegment": True,
        })
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
    if query.subtotals:
        rows = rows + _subtotal_rows(query, starts, buckets, dim_vals, counts,
                                     states, kernels)
    if query.having is not None:
        rows = [r for r in rows if query.having.evaluate(r["event"])]
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


def _subtotal_rows(query, starts, buckets, dim_vals, counts, states,
                   kernels) -> List[dict]:
    """The rows of each subtotal spec: the merged groups re-grouped by the
    spec's dimensions, their states folded with `AggKernel.combine`
    (Druid's GroupByStrategyV2.processSubtotalsSpec), in the reference's
    order."""
    out_names = [d.output_name for d in query.dimensions]
    rows = []
    live = np.flatnonzero(counts > 0)
    for subset in query.subtotals:
        keep = [i for i, n in enumerate(out_names) if n in subset]
        groups: Dict[tuple, dict] = {}
        for gi in live:
            key = (int(buckets[gi]),) + tuple(dim_vals[i][gi] for i in keep)
            g = groups.get(key)
            if g is None:
                groups[key] = {k.name: _state_at(states[k.name], gi)
                               for k in kernels}
            else:
                for k in kernels:
                    g[k.name] = k.combine(g[k.name],
                                          _state_at(states[k.name], gi))
        for key, g in sorted(groups.items(), key=lambda kv: str(kv[0])):
            event = {out_names[i]: key[1 + j] for j, i in enumerate(keep)}
            vals = {k.name: _scalar(k.finalize_array(g[k.name])[0])
                    for k in kernels}
            event.update(compute_postaggs(query.post_aggregations, vals))
            rows.append({"version": "v1",
                         "timestamp": int(starts[key[0]]) if len(starts)
                         else 0,
                         "event": event})
    return rows


def _state_at(state, gi):
    """Group `gi`'s state, as a state of one group."""
    if isinstance(state, dict):
        return {k: _state_at(v, gi) for k, v in state.items()}
    return np.asarray(state)[gi:gi + 1]


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


# ---------------------------------------------------------------------------
# Scan / select: raw rows, masked on the device, decoded on the host
# ---------------------------------------------------------------------------

def _query_mask(segment: Segment, query, device: torch.device,
                columns: Sequence[str] = ()):
    """(mask, staged columns): the rows in the query's intervals that pass
    its filter, on `device`."""
    return masked_columns(query.filter, segment,
                          getattr(query, "virtual_columns", ()), device,
                          condense(query.intervals), columns)


def _masked_row_ids(segment: Segment, query,
                    device: torch.device) -> np.ndarray:
    """The ascending row ids that pass the query; only they reach the
    host."""
    mask, _ = _query_mask(segment, query, device)
    return torch.nonzero(mask).flatten().cpu().numpy()


def _decode_rows(segment: Segment, row_ids: np.ndarray,
                 columns: Sequence[str]) -> List[dict]:
    cols: Dict[str, np.ndarray] = {}
    for c in columns:
        if c == "__time":
            cols[c] = segment.time_ms[row_ids]
        elif c in segment.dims:
            col = segment.dims[c]
            vals = np.asarray(col.dictionary.values, dtype=object)
            cols[c] = vals[col.ids[row_ids]] if col.cardinality else \
                np.full(len(row_ids), "", dtype=object)
        elif c in segment.metrics:
            cols[c] = segment.metrics[c].values[row_ids]
    return [{c: _scalar(v[i]) for c, v in cols.items()}
            for i in range(len(row_ids))]


def iter_scan(query: ScanQuery, segments: Sequence[Segment],
              device: torch.device):
    """A lazy scan: one batch of at most `batch_size` events at a time; a
    segment is masked and decoded only when its batch is pulled, so a
    limit stops the scan early (Druid's ScanQueryEngine sequence)."""
    intervals = condense(query.intervals)
    segs = sorted(_segments_for(segments, intervals),
                  key=lambda s: s.min_time,
                  reverse=query.order == "descending")
    remaining = query.limit
    to_skip = query.offset
    batch = max(int(query.batch_size), 1)
    for s in segs:
        if remaining is not None and remaining <= 0:
            return
        row_ids = _masked_row_ids(s, query, device)
        if query.order == "descending":
            row_ids = row_ids[::-1]
        if to_skip:
            if to_skip >= len(row_ids):
                to_skip -= len(row_ids)
                continue
            row_ids = row_ids[to_skip:]
            to_skip = 0
        if remaining is not None:
            row_ids = row_ids[:remaining]
            remaining -= len(row_ids)
        columns = list(query.columns) or (
            ["__time"] + list(s.dims.keys()) + list(s.metrics.keys()))
        for i in range(0, len(row_ids), batch):
            events = _decode_rows(s, row_ids[i:i + batch], columns)
            if events:
                yield {"segmentId": str(s.id), "columns": columns,
                       "events": events}


def run_scan(query: ScanQuery, segments: Sequence[Segment],
             device: torch.device) -> List[dict]:
    return list(iter_scan(query, segments, device))


def run_select(query: SelectQuery, segments: Sequence[Segment],
               device: torch.device) -> List[dict]:
    """Druid's paged select: `threshold` events a page, resumed after each
    segment's offset in `paging_spec`."""
    intervals = condense(query.intervals)
    segs = sorted(_segments_for(segments, intervals),
                  key=lambda s: s.min_time, reverse=query.descending)
    paging = dict(query.paging_spec)
    threshold = query.threshold
    events = []
    new_paging: Dict[str, int] = {}
    for s in segs:
        if threshold <= 0:
            break
        row_ids = _masked_row_ids(s, query, device)
        if query.descending:
            row_ids = row_ids[::-1]
        start = paging.get(str(s.id), -1) + 1
        row_ids = row_ids[start:start + threshold]
        threshold -= len(row_ids)
        columns = (["__time"] + (list(query.dimensions) or list(s.dims.keys()))
                   + (list(query.metrics) or list(s.metrics.keys())))
        for off, ev in zip(range(start, start + len(row_ids)),
                           _decode_rows(s, row_ids, columns)):
            events.append({"segmentId": str(s.id), "offset": off, "event": ev})
            new_paging[str(s.id)] = off
    ts = int(min((s.min_time for s in segs), default=0))
    return [{"timestamp": ts,
             "result": {"pagingIdentifiers": new_paging, "events": events}}]


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------

def run_search(query: SearchQuery, segments: Sequence[Segment],
               device: torch.device) -> List[dict]:
    """Dimension values containing the search string, with the count of
    the query's rows holding each: the values are matched once per
    dictionary on the host, and each dimension's masked ids are counted on
    the device (`torch.bincount`)."""
    intervals = condense(query.intervals)
    segs = _segments_for(segments, intervals)
    if not segs:
        return []
    needle = query.value if query.case_sensitive else query.value.lower()

    def matches(v: str) -> bool:
        h = v if query.case_sensitive else v.lower()
        return needle in h

    hits: Dict[Tuple[str, str], int] = {}
    for s in segs:
        dims = [d for d in (list(query.search_dimensions) or list(s.dims))
                if d in s.dims]
        luts = {d: _dictionary_lut(s.dims[d].dictionary, matches)
                for d in dims}
        dims = [d for d in dims if luts[d].any()]
        if not dims:
            continue
        mask, cols = _query_mask(s, query, device, dims)
        for d in dims:
            card = s.dims[d].cardinality
            # masked-out rows count in an extra bin past the dictionary
            cnt = torch.bincount(torch.where(mask, cols[d], card),
                                 minlength=card + 1)[:card].cpu().numpy()
            values = s.dims[d].dictionary.values
            for vid in np.flatnonzero((cnt > 0) & luts[d]):
                key = (d, values[vid])
                hits[key] = hits.get(key, 0) + int(cnt[vid])

    entries = [{"dimension": d, "value": v, "count": c}
               for (d, v), c in hits.items()]
    if query.sort == "strlen":
        entries.sort(key=lambda e: (len(e["value"]), e["value"],
                                    e["dimension"]))
    else:
        entries.sort(key=lambda e: (e["value"], e["dimension"]))
    entries = entries[: query.limit]
    ts = int(min(iv.start for iv in intervals))
    return [{"timestamp": ts, "result": entries}]


# ---------------------------------------------------------------------------
# TimeBoundary / SegmentMetadata / DataSourceMetadata
# ---------------------------------------------------------------------------

_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def run_time_boundary(query: TimeBoundaryQuery, segments: Sequence[Segment],
                      device: torch.device) -> List[dict]:
    """The least and greatest time of the query's rows: a segment inside
    the one interval of an unfiltered query answers from its metadata; any
    other is masked on the device, which reduces the masked time offsets to
    their min and max."""
    intervals = condense(query.intervals)
    segs = _segments_for(segments, intervals)
    min_t, max_t = None, None
    for s in segs:
        if query.filter is None and len(intervals) == 1 \
                and intervals[0].contains_interval(
                    Interval(s.min_time, s.max_time + 1)):
            lo, hi = s.min_time, s.max_time
        else:
            mask, cols = _query_mask(s, query, device)
            off = cols["__time_offset"]
            any_, lo, hi = torch.stack([
                mask.any().to(torch.int64),
                torch.where(mask, off, _I32_MAX).amin().to(torch.int64),
                torch.where(mask, off, _I32_MIN).amax().to(torch.int64),
            ]).tolist()
            if not any_:
                continue
            lo, hi = lo + s.interval.start, hi + s.interval.start
        min_t = lo if min_t is None else min(min_t, lo)
        max_t = hi if max_t is None else max(max_t, hi)
    if min_t is None:
        return []
    result = {}
    if query.bound in (None, "minTime"):
        result["minTime"] = min_t
    if query.bound in (None, "maxTime"):
        result["maxTime"] = max_t
    ts = min_t if query.bound != "maxTime" else max_t
    return [{"timestamp": ts, "result": result}]


def _analyze_segment(segment: Segment, query: SegmentMetadataQuery) -> dict:
    """One segment's analysis (Druid's SegmentAnalyzer), from host
    metadata."""
    cols = {}
    names = list(query.to_include) or (
        ["__time"] + list(segment.dims.keys()) + list(segment.metrics.keys()))
    want = set(query.analysis_types)
    for c in names:
        info: Dict[str, object] = {"hasMultipleValues": False,
                                   "errorMessage": None}
        if c == "__time":
            info["type"] = "LONG"
            if "size" in want:
                info["size"] = int(segment.time_ms.nbytes)
            if "minmax" in want:
                info["minValue"] = segment.min_time
                info["maxValue"] = segment.max_time
        elif c in segment.dims:
            col = segment.dims[c]
            info["type"] = "STRING"
            if "cardinality" in want:
                info["cardinality"] = col.cardinality
            if "size" in want:
                info["size"] = int(col.ids.nbytes)
            if "minmax" in want and col.cardinality:
                info["minValue"] = col.dictionary.values[0]
                info["maxValue"] = col.dictionary.values[-1]
        elif c in segment.metrics:
            m = segment.metrics[c]
            info["type"] = m.type.value.upper()
            if "size" in want:
                info["size"] = int(m.values.nbytes)
            if "minmax" in want and segment.n_rows:
                info["minValue"] = _scalar(m.values.min())
                info["maxValue"] = _scalar(m.values.max())
        else:
            continue
        cols[c] = info
    return {"id": str(segment.id),
            "intervals": [str(segment.interval)] if "interval" in want
            else None,
            "columns": cols,
            "size": segment.size_bytes(),
            "numRows": segment.n_rows}


def run_segment_metadata(query: SegmentMetadataQuery,
                         segments: Sequence[Segment]) -> List[dict]:
    intervals = condense(query.intervals)
    analyses = [_analyze_segment(s, query)
                for s in _segments_for(segments, intervals)]
    if not query.merge or not analyses:
        return analyses
    merged = analyses[0]
    for a in analyses[1:]:
        merged["size"] += a["size"]
        merged["numRows"] += a["numRows"]
        if merged["intervals"] is not None and a["intervals"]:
            merged["intervals"] = sorted(set(merged["intervals"]
                                             + a["intervals"]))
        for c, info in a["columns"].items():
            if c not in merged["columns"]:
                merged["columns"][c] = info
                continue
            tgt = merged["columns"][c]
            if "size" in info and "size" in tgt:
                tgt["size"] += info["size"]
            if "cardinality" in info and "cardinality" in tgt:
                tgt["cardinality"] = max(tgt["cardinality"],
                                         info["cardinality"])
            if "minValue" in info and "minValue" in tgt:
                tgt["minValue"] = min(tgt["minValue"], info["minValue"])
                tgt["maxValue"] = max(tgt["maxValue"], info["maxValue"])
    merged["id"] = "merged"
    return [merged]


def run_datasource_metadata(query: DataSourceMetadataQuery,
                            segments: Sequence[Segment]) -> List[dict]:
    if not segments:
        return []
    mx = max(s.max_time for s in segments)
    return [{"timestamp": mx, "result": {"maxIngestedEventTime": mx}}]
