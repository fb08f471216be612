"""The grouped-aggregate program of one segment.

The port's counterpart of the reference package's `engine/grouping.py`. One
program serves the three aggregating engines:
  * timeseries — key = time bucket
  * topN       — key = bucket x cardinality + dimension id
  * groupBy    — key = fused dimension ids
mask = valid AND time in the query intervals AND filter; key = fused
(bucket, dimension ids); one grouped reduction per aggregator. PyTorch runs
eagerly, so there is no program cache: each call runs the tensor ops on the
segment's staged block.

Reduction strategies (`select_strategy`):
  * "projection" — under the reference's own conditions (a group space above
    MM_GROUP_LIMIT over a segment of at least PROJECTION_MIN_ROWS rows, every
    aggregator blocked-eligible, the sorted-projection caps met): the segment
    is sorted by compacted key once (`build_projection`, cached) and reduced
    by kernel B1 (engine/sorted_reduce.py).
  * "megakernel" — "projection" when the filter's root or top-level AND
    conjuncts are fused bitmap nodes (engine/megakernel.py): the row mask
    goes to kernel B2 as words.
  * "mixed" — torch scatter (`index_add_` / `scatter_reduce`) everywhere else.
A CUDA tensor goes through the kernel or the call raises; nothing falls back.

On the projection and megakernel strategies the value columns B1/B2 read
stage as packed words where they fit (data/packed.py); every other column
stages dense. The program top splits the block (`cascade.split_resident`):
B1 and B2 read the packed columns as words, and every other consumer reads
a `DecodedView`, which decodes a column the first time it is read in the
query (a filter's residual on a packed metric). A column that only the
kernels read is never decoded.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from druid_tpu_torch.data import cascade as cascade_mod
from druid_tpu_torch.data.segment import Segment
from druid_tpu_torch.engine import megakernel
from druid_tpu_torch.engine import sorted_reduce as sorted_reduce_mod
from druid_tpu_torch.engine.filters import (ConstNode, FilterNode,
                                            interval_offsets, perm_digest,
                                            plan_filter, stage_device_bitmaps,
                                            time_mask)
from druid_tpu_torch.engine.kernels import AggKernel, make_kernel
from druid_tpu_torch.utils.granularity import Granularity
from druid_tpu_torch.utils.intervals import Interval

DENSE_GROUP_LIMIT = 1 << 21  # max dense key space per (bucket x groups) grid
MM_GROUP_LIMIT = 4096        # the reference's one-hot-matmul group cap
WINDOW_BLOCK = 1024          # rows per block Projection.max_span measures
#: below this many padded rows the one-time sort outweighs the kernel's win
PROJECTION_MIN_ROWS = 1 << 20
#: test override: "projection" (when every aggregator is eligible) or "mixed"
FORCE_STRATEGY: Optional[str] = None


def pad_pow2(n: int, floor: int = 8) -> int:
    return max(floor, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


@dataclass
class KeyDim:
    """One grouping dimension: an ids column with its cardinality.
    column=None means the dimension is absent from the segment — it
    contributes the constant id 0 (value "")."""
    column: Optional[str]
    cardinality: int


@dataclass
class GroupSpec:
    """Bucketing + grouping config for one segment execution."""
    bucket_starts: np.ndarray          # int64 [B] bucket start timestamps
    bucket_mode: str                   # "all" | "uniform" | "host"
    uniform_period: int = 0
    uniform_first_offset: int = 0      # first bucket start - segment time0
    host_bucket_ids: Optional[np.ndarray] = None  # int32 [n_rows]
    key_mode: str = "dense"            # "dense" | "host"
    dims: Tuple[KeyDim, ...] = ()
    host_keys: Optional[np.ndarray] = None        # int32 [n_rows] compact ids
    host_unique: Optional[np.ndarray] = None      # raw fused key per compact id
    num_total: int = 1                 # padded key-space size
    strategy: str = "mixed"
    window: int = 0                    # projection span (B1/B2 strategies)
    host_keys_cache: Optional[Tuple] = None
    host_bucket_cache: Optional[Tuple] = None

    @property
    def num_buckets(self) -> int:
        return int(len(self.bucket_starts))


@dataclass
class SegmentPartial:
    """Per-segment partial aggregation result (host-side)."""
    segment: Segment
    spec: GroupSpec
    counts: np.ndarray                    # int64 [num_total]
    states: Dict[str, np.ndarray]         # agg name -> host state
    kernels: List[AggKernel]


def _dims_key(dims: Sequence[KeyDim]) -> Tuple:
    return tuple((d.column, d.cardinality) for d in dims)


def _fused_raw_keys(segment: Segment, spec: GroupSpec) -> np.ndarray:
    """Host: int64 fused (bucket, dim ids) key per row; -1 = invalid row
    (out of the bucket range)."""
    if spec.bucket_mode == "all":
        b = np.zeros(segment.n_rows, dtype=np.int64)
    elif spec.bucket_mode == "uniform":
        b = (segment.time_ms - int(spec.bucket_starts[0])) \
            // spec.uniform_period
        b = np.where((b < 0) | (b >= spec.num_buckets), -1, b)
    else:
        b = spec.host_bucket_ids.astype(np.int64)
    key = b
    valid = b >= 0
    for d in spec.dims:
        if d.column is None:
            continue
        key = key * d.cardinality + segment.dims[d.column].ids
    return np.where(valid, key, -1)


@dataclass
class Projection:
    """A sorted, key-compacted view of one segment for one key structure:
    the row permutation clusters equal group keys, so a block of rows spans
    a small window of keys."""
    order: np.ndarray       # int32 [n] row permutation (invalid rows first)
    keys: np.ndarray        # int32 [n] sorted compact ids (-1 = invalid)
    unique: np.ndarray      # int64 [G] raw fused key per compact id
    max_span: int           # max key span over WINDOW_BLOCK-row blocks


def build_projection(segment: Segment, intervals: Sequence[Interval],
                     granularity: Granularity, spec: GroupSpec) -> Projection:
    cache_key = ("projection", str(granularity),
                 tuple((iv.start, iv.end) for iv in intervals),
                 _dims_key(spec.dims))

    def _compute():
        raw = _fused_raw_keys(segment, spec)
        n = raw.shape[0]
        order = np.argsort(raw, kind="stable")
        sr = raw[order]
        n_invalid = int(np.searchsorted(sr, 0))  # -1 rows sort first
        valid_sorted = sr[n_invalid:]
        keys = np.full(n, -1, dtype=np.int32)
        if valid_sorted.size:
            newgrp = np.empty(valid_sorted.shape, dtype=bool)
            newgrp[0] = True
            np.not_equal(valid_sorted[1:], valid_sorted[:-1], out=newgrp[1:])
            unique = valid_sorted[newgrp]
            keys[n_invalid:] = np.cumsum(newgrp) - 1
        else:
            unique = np.zeros(0, dtype=np.int64)
        big = np.iinfo(np.int32).max
        npad = max(-(-n // WINDOW_BLOCK), 1) * WINDOW_BLOCK
        kp = np.full(npad, big, dtype=np.int64)
        kp[:n] = np.where(keys >= 0, keys.astype(np.int64), big)
        lo = kp.reshape(-1, WINDOW_BLOCK).min(axis=1)
        hi = np.where(kp == big, np.iinfo(np.int64).min, kp) \
            .reshape(-1, WINDOW_BLOCK).max(axis=1)
        span = np.maximum(hi - lo + 1, 1)
        span = int(span[hi >= 0].max()) if (hi >= 0).any() else 1
        return Projection(order=order.astype(np.int32), keys=keys,
                          unique=unique, max_span=span)

    return segment.aux_cached(cache_key, _compute)


def make_group_spec(segment: Segment, intervals: Sequence[Interval],
                    granularity: Granularity,
                    dims: Sequence[KeyDim]) -> GroupSpec:
    """Choose bucket mode + key mode for this (segment, query) pair."""
    if granularity.is_all:
        first = min((iv.start for iv in intervals), default=0)
        bucket_starts_list = [np.asarray([first], dtype=np.int64)]
        bucket_starts = bucket_starts_list[0]
    else:
        bucket_starts_list = [granularity.bucket_starts(iv)
                              for iv in intervals]
        bucket_starts = (np.concatenate(bucket_starts_list)
                         if bucket_starts_list
                         else np.zeros(0, dtype=np.int64))
    B = max(int(len(bucket_starts)), 1)

    host_bucket_cache = None
    if granularity.is_all:
        bucket_mode, period, first_off, host_bucket = "all", 0, 0, None
    elif granularity.is_uniform and len(intervals) == 1:
        bucket_mode = "uniform"
        period = granularity.period_ms
        first_off = int(bucket_starts[0] - segment.interval.start)
        host_bucket = None
    else:
        bucket_mode, period, first_off = "host", 0, 0
        key = ("bucket_ids", str(granularity),
               tuple((iv.start, iv.end) for iv in intervals))

        def _compute():
            offset = 0
            out = np.full(segment.n_rows, -1, dtype=np.int32)
            for iv, starts in zip(intervals, bucket_starts_list):
                ids = granularity.bucket_ids(segment.time_ms, iv)
                sel = ids >= 0
                out[sel] = ids[sel] + offset
                offset += len(starts)
            return out
        host_bucket = segment.aux_cached(key, _compute)
        host_bucket_cache = key

    dims = tuple(dims)
    group_card = 1
    for d in dims:
        group_card *= max(d.cardinality, 1)
    dense_total = B * group_card
    spec = GroupSpec(bucket_starts=bucket_starts, bucket_mode=bucket_mode,
                     uniform_period=period, uniform_first_offset=first_off,
                     host_bucket_ids=host_bucket, dims=dims,
                     num_total=pad_pow2(dense_total),
                     host_bucket_cache=host_bucket_cache)
    if not dims or dense_total <= DENSE_GROUP_LIMIT:
        return spec

    # host-compacted key path: fuse (bucket, dim ids) on the host + np.unique
    cache_key = ("fused_keys", str(granularity),
                 tuple((iv.start, iv.end) for iv in intervals),
                 _dims_key(dims))

    def _compute_keys():
        key = _fused_raw_keys(segment, spec)
        uniq, compact = np.unique(key, return_inverse=True)
        if len(uniq) and uniq[0] == -1:
            compact = compact - 1  # -1 rows get id -1
            uniq = uniq[1:]
        return uniq, compact.astype(np.int32)

    uniq, compact = segment.aux_cached(cache_key, _compute_keys)
    spec.key_mode = "host"
    spec.host_keys, spec.host_unique = compact, uniq
    spec.num_total = pad_pow2(max(len(uniq), 1))
    spec.host_keys_cache = cache_key
    return spec


def select_strategy(spec: GroupSpec, kernels: Sequence[AggKernel],
                    col_dtypes: Dict, padded_rows: int) -> str:
    """"projection" under the reference's conditions for it, else "mixed"."""
    blocked_ok = all(k.blocked_supported(col_dtypes) for k in kernels)
    if FORCE_STRATEGY == "mixed":
        return "mixed"
    if FORCE_STRATEGY == "projection" and blocked_ok:
        return "projection"
    if blocked_ok and spec.num_total > MM_GROUP_LIMIT \
            and padded_rows >= PROJECTION_MIN_ROWS:
        return "projection"
    return "mixed"


def fuse_filter_update(arrays: Dict[str, torch.Tensor], mask: torch.Tensor,
                       key: torch.Tensor, dims: Sequence[KeyDim],
                       filter_node: Optional[FilterNode],
                       kernels: Sequence[AggKernel], num_total: int,
                       strategy: str = "mixed", span: int = 0,
                       packed_cols: Optional[Dict] = None):
    """Fuse dimension ids into the key, apply the filter mask, and run every
    kernel's reduction by the strategy. `arrays` is the dense view (a dict
    or a cascade.DecodedView); `packed_cols` are the packed columns that
    kernels B1/B2 read as words. Returns (counts, per-kernel states) as
    device tensors."""
    key = key.to(torch.int64)
    for d in dims:
        if d.column is not None:
            key = key * d.cardinality + arrays[d.column].to(torch.int64)
    if strategy == "megakernel":
        # top-level mega conjuncts stay words into kernel B2; only the
        # residual tree builds a row mask
        mega_nodes, residual = megakernel.split_for_kernel(filter_node)
        if residual is not None:
            mask = mask & residual.build(arrays)
        key = key.clamp(0, num_total - 1).to(torch.int32)
        return megakernel.mega_reduce(arrays, mask, key, mega_nodes, kernels,
                                      num_total, span,
                                      packed_cols=packed_cols)
    if filter_node is not None:
        mask = mask & filter_node.build(arrays)
    key = key.clamp(0, num_total - 1)

    if strategy == "projection":
        return sorted_reduce_mod.sorted_reduce(
            arrays, mask, key.to(torch.int32), kernels, num_total, span,
            packed_cols=packed_cols)
    counts = torch.zeros(num_total, dtype=torch.int64, device=key.device) \
        .index_add_(0, key, mask.to(torch.int64))
    return counts, tuple(k.update(arrays, mask, key, num_total)
                         for k in kernels)


def _pad_device(segment: Segment, cache_key: Tuple, arr: np.ndarray,
                padded: int, fill, device: torch.device) -> torch.Tensor:
    """Padded device copy of a derived host column, cached on the segment."""
    def _build():
        out = np.full((padded,), fill, dtype=arr.dtype)
        out[: arr.shape[0]] = arr
        return torch.from_numpy(out).to(device)
    return segment.device_cached(("devpad", cache_key, padded, fill,
                                  str(device)), _build)


def run_grouped_aggregate(segment: Segment, intervals: Sequence[Interval],
                          granularity: Granularity, dims: Sequence[KeyDim],
                          aggs: Sequence, flt,
                          device: torch.device) -> SegmentPartial:
    """Execute the grouped aggregation for one segment on `device`; returns
    host partials."""
    spec = make_group_spec(segment, intervals, granularity, dims)
    filter_node = plan_filter(flt, segment)
    kernels = [make_kernel(a, segment) for a in aggs]

    if isinstance(filter_node, ConstNode) and not filter_node.value:
        # constant-false filter: nothing matches, no device work
        return SegmentPartial(
            segment=segment, spec=spec,
            counts=np.zeros(spec.num_total, dtype=np.int64),
            states={k.name: k.empty_state(spec.num_total) for k in kernels},
            kernels=kernels)

    base_needed = set()
    if filter_node is not None:
        # the PLANNED tree's columns: a bitmap node reads words, not its
        # dimensions
        base_needed |= filter_node.required_device_columns()
    for a in aggs:
        base_needed |= a.required_columns()
    base_needed = {c for c in base_needed
                   if c in segment.dims or c in segment.metrics}
    needed = set(base_needed)
    if spec.key_mode == "dense":
        needed |= {d.column for d in spec.dims if d.column is not None}

    padded_rows = segment.padded_rows()
    col_dtypes = {c: segment.staged_dtype(c) for c in needed}
    spec.strategy = select_strategy(spec, kernels, col_dtypes, padded_rows)

    perm, perm_key, words = None, None, ()
    if spec.strategy == "projection":
        proj = build_projection(segment, intervals, granularity, spec)
        spec.key_mode = "host"
        spec.host_keys = proj.keys
        spec.host_unique = proj.unique
        spec.num_total = pad_pow2(max(len(proj.unique), 1))
        perm = proj.order
        perm_key = ("projection", str(granularity),
                    tuple((iv.start, iv.end) for iv in intervals),
                    _dims_key(spec.dims))
        spec.host_keys_cache = perm_key
        needed = base_needed  # key prefused: dim columns stay on the host
        col_dtypes = {c: segment.staged_dtype(c) for c in needed}
        if sorted_reduce_mod.usable(kernels, col_dtypes, proj.max_span,
                                    spec.num_total):
            spec.window = proj.max_span
            # B1 (or B2) reads these as words where they pack
            words = sorted_reduce_mod.value_fields(kernels, col_dtypes)
        else:
            spec.strategy = "mixed"

    # bitmap subtrees whose combined words are not cached fuse into the
    # aggregation (engine/megakernel.py); cached ones keep the bit test
    if megakernel.enabled():
        filter_node = megakernel.megaize(filter_node, segment, padded_rows,
                                         device, perm_digest(perm_key))
    else:
        megakernel.record_disabled_fallback(filter_node)

    block = segment.device_block(sorted(needed), device, perm=perm,
                                 perm_key=perm_key, words=words)
    # packed value columns go to B1/B2 as words; everything else reads the
    # dense view, which decodes a column on its first read
    packed_cols, arrays = cascade_mod.split_resident(block.arrays)
    # staged combined words and fused leaf words, in the projection's row
    # order on that path
    arrays.update(stage_device_bitmaps(segment, filter_node,
                                       block.padded_rows, device, perm,
                                       perm_key))
    arrays.update(megakernel.stage_mega_leaves(
        segment, filter_node, block.padded_rows, device, perm, perm_key))
    if spec.strategy == "projection" \
            and megakernel.split_for_kernel(filter_node)[0]:
        spec.strategy = "megakernel"
    t = arrays["__time_offset"]
    mask = arrays["__valid"] & time_mask(
        t, interval_offsets(intervals, segment.interval.start))

    key_dims: Sequence[KeyDim] = spec.dims
    if spec.key_mode == "host":
        key = _pad_device(segment, spec.host_keys_cache, spec.host_keys,
                          block.padded_rows, -1, device)
        mask = mask & (key >= 0)
        key_dims = ()
    elif spec.bucket_mode == "all":
        key = torch.zeros(t.shape, dtype=torch.int64, device=device)
    elif spec.bucket_mode == "uniform":
        # int32 offsets, floor division like the reference's bucket math
        b = (t.to(torch.int64) - spec.uniform_first_offset) \
            // spec.uniform_period
        mask = mask & (b >= 0) & (b < spec.num_buckets)
        key = b
    else:
        key = _pad_device(segment, spec.host_bucket_cache,
                          spec.host_bucket_ids, block.padded_rows, -1, device)
        mask = mask & (key >= 0)

    counts, states = fuse_filter_update(
        arrays, mask, key, key_dims, filter_node, kernels, spec.num_total,
        strategy=spec.strategy, span=spec.window,
        packed_cols=packed_cols or None)
    host_states = {k.name: k.host_post(st) for k, st in zip(kernels, states)}
    return SegmentPartial(segment=segment, spec=spec,
                          counts=counts.cpu().numpy().astype(np.int64),
                          states=host_states, kernels=kernels)
