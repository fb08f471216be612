"""Segment merging: n-way merge with dictionary reconciliation + re-rollup.

The port's own copy of the reference package's `ingest/merger.py` (host
numpy), so a merged segment equals the reference's column for column.

Capability parity with the reference's IndexMergerV9.mergeQueryableIndex
(processing/.../segment/IndexMergerV9.java:801 — n-way sorted dictionary
merge via DimensionMergerV9, row merge with rollup re-aggregation). Here
merge is a vectorized concat + remap + grouped re-aggregation (the same
np.unique/ufunc.at pass the IncrementalIndex uses), not a per-row iterator
merge.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from druid_tpu_torch.data.dictionary import (Dictionary, NULL,
                                             merge_dictionaries)
from druid_tpu_torch.data.segment import Segment, SegmentId, StringDimColumn
from druid_tpu_torch.query import aggregators as A
from druid_tpu_torch.utils.granularity import Granularity
from druid_tpu_torch.utils.intervals import Interval


def merge_segments(segments: Sequence[Segment],
                   metric_specs: Sequence[A.AggregatorSpec],
                   datasource: Optional[str] = None,
                   interval: Optional[Interval] = None,
                   version: str = "merged",
                   partition: int = 0,
                   rollup: bool = True,
                   query_granularity: str | Granularity = "none") -> Segment:
    """Merge segments into one. `metric_specs` are the ORIGINAL ingest specs;
    re-aggregation uses their combining form (count re-merges as longSum —
    reference AggregatorFactory.getCombiningFactory)."""
    from druid_tpu_torch.ingest.incremental import (make_metric_state,
                                                    time_sorted_segment)

    assert segments
    datasource = datasource or segments[0].id.datasource
    if interval is None:
        interval = Interval(min(s.interval.start for s in segments),
                            max(s.interval.end for s in segments))
    gran = (query_granularity if isinstance(query_granularity, Granularity)
            else Granularity.of(query_granularity))

    # 1. unified dim set (order: first-seen across segments)
    dim_order: List[str] = []
    for s in segments:
        for d in s.dims:
            if d not in dim_order:
                dim_order.append(d)

    # 2. merged dictionaries + per-segment remaps (DimensionMergerV9 analog)
    merged_dicts: Dict[str, Dictionary] = {}
    remaps: Dict[str, List[Optional[np.ndarray]]] = {}
    for d in dim_order:
        per_seg = []
        for s in segments:
            col = s.dims.get(d)
            per_seg.append(col.dictionary if col else Dictionary([NULL]))
        # ensure NULL present for segments lacking the dim
        if any(d not in s.dims for s in segments):
            per_seg.append(Dictionary([NULL]))
            md, rm = merge_dictionaries(per_seg)
            rm = rm[:-1]
        else:
            md, rm = merge_dictionaries(per_seg)
        merged_dicts[d] = md
        remaps[d] = rm

    # 3. concat columns (remapped)
    n_total = sum(s.n_rows for s in segments)
    time_cat = np.concatenate([s.time_ms for s in segments]) if n_total \
        else np.zeros(0, dtype=np.int64)
    ids_cat: Dict[str, np.ndarray] = {}
    for d in dim_order:
        parts = []
        for s, rm in zip(segments, remaps[d]):
            col = s.dims.get(d)
            if col is None:
                null_id = merged_dicts[d].id_of(NULL)
                parts.append(np.full(s.n_rows, null_id, dtype=np.int32))
            else:
                parts.append(rm[col.ids])
        ids_cat[d] = np.concatenate(parts) if parts else np.zeros(0, np.int32)

    # 4. metric columns concat (as combining inputs); hidden pair-time
    # columns (__ft_<name>) ride along when every segment has them, so
    # first/last re-merge by true event time
    states = [make_metric_state(spec.combining()) for spec in metric_specs]
    metric_cols: Dict[str, np.ndarray] = {}
    names = [spec.name for spec in metric_specs]
    names += [h for spec in metric_specs
              for h in (f"__ft_{spec.name}",)
              if all(h in s.metrics for s in segments)]
    for name in names:
        parts = []
        for s in segments:
            col = s.metrics.get(name)
            if col is None:
                raise ValueError(
                    f"segment {s.id} lacks metric {name!r} for merge")
            parts.append(col.values)
        metric_cols[name] = (np.concatenate(parts) if parts
                             else np.zeros(0, dtype=np.float64))

    if gran.is_all:
        t_trunc = np.full(n_total, interval.start, dtype=np.int64)
    else:
        t_trunc = gran.bucket_start_array(time_cat)
    if rollup and n_total:
        from druid_tpu_torch.ingest.incremental import fuse_group_keys
        key = fuse_group_keys(
            t_trunc, ids_cat,
            {d: merged_dicts[d].cardinality for d in dim_order}, dim_order)
        uniq, first_idx, gids = np.unique(key, return_index=True,
                                          return_inverse=True)
        n_groups = len(uniq)
        g_time = t_trunc[first_idx]
        g_ids = {d: ids_cat[d][first_idx] for d in dim_order}
        g_states = [st.from_batch(gids, n_groups, metric_cols, time_cat)
                    for st in states]
    else:
        order = np.argsort(t_trunc, kind="stable")
        g_time = t_trunc[order]
        g_ids = {d: ids_cat[d][order] for d in dim_order}
        gids = np.arange(n_total, dtype=np.int64)
        g_states = [st.from_batch(gids, n_total,
                                  {k: v[order]
                                   for k, v in metric_cols.items()},
                                  time_cat[order]) for st in states]

    dims = {d: StringDimColumn(g_ids[d].astype(np.int32), merged_dicts[d])
            for d in dim_order}
    metrics: Dict[str, object] = {}
    for st, s in zip(states, g_states):
        metrics[st.name] = st.final_column(s)
        metrics.update(st.extra_columns(s))
    return time_sorted_segment(
        SegmentId(datasource, interval, version, partition), g_time, dims,
        metrics)


