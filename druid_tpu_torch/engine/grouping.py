"""The grouped-aggregate program of one segment.

The port's counterpart of the reference package's `engine/grouping.py`. One
program serves the three aggregating engines:
  * timeseries — key = time bucket
  * topN       — key = bucket x cardinality + dimension id
  * groupBy    — key = fused dimension ids
mask = valid AND time in the query intervals AND filter; key = fused
(bucket, dimension ids); one grouped reduction per aggregator. PyTorch runs
eagerly, so there is no per-segment program cache: each call runs the tensor
ops on the segment's staged block. Planning (`plan_grouped_aggregate`: the
group spec, the filter tree, the kernels, the virtual columns) is split from
the run, so the batched path (engine/batching.py) plans each segment once
and hands the plan back for the segments it runs alone.

The batched path runs a chunk of K shape-compatible segments, each staged
at one ladder rung of R rows, as one stacked run over [K, R] columns
(`make_stacked_segment_fn`, `fuse_filter_update_stacked`): the mask, the
buckets and the keys are computed once over the stack; "mixed" scatters
into one [K * G] grid with the key offset by k * G, while "blocked" and
"mm" keep a batch axis (a key offset would multiply their work by K).

Before any of these, `rundomain.run_planned` (the reference's code-domain
path, planned by `rundomain._plan_run_domain`) takes a segment whose
referenced columns are constant within one shared run partition: the
aggregate runs over run tables, no row block stages, and the partial's
strategy is "runDomain".

Reduction strategies (`select_strategy`, the reference's order and
thresholds; `FORCE_STRATEGY` forces an eligible one):
  * "blocked"  — G <= 64 (or <= BLOCKED_GROUP_LIMIT when mm is not
    eligible), every aggregator blocked-eligible: a masked broadcast-reduce
    over [G, rows] per step (`_blocked_reduce`).
  * "mm"       — G <= 2048 (<= MM_GROUP_LIMIT after blocked), every
    aggregator sum-decomposable: the one-hot matmul (engine/mmagg.py).
  * "windowed" — a dense group space above BLOCKED_GROUP_LIMIT over a
    segment whose 1024-row blocks each span fewer than W keys (the rollup
    sort order; `windowed_window`, a host span check cached per segment):
    each block reduces into a local [W] grid, and the grids combine into the
    full grid (`_windowed_reduce`).
  * "projection" — under the reference's own conditions (a group space above
    MM_GROUP_LIMIT over a segment of at least PROJECTION_MIN_ROWS rows, every
    aggregator blocked-eligible): the segment is sorted by compacted key once
    (`build_projection`, cached) and reduced by kernel B1
    (engine/sorted_reduce.py) when its caps hold, else by "windowed" over
    the sorted layout when the span allows, else by "mixed"
    (`_projection_strategy`).
  * "megakernel" — "projection" when the filter's root or top-level AND
    conjuncts are fused bitmap nodes (engine/megakernel.py): the row mask
    goes to kernel B2 as words.
  * "mixed"    — everything else: with G <= BLOCKED_GROUP_LIMIT the
    blocked-eligible aggregators (and the row counts) go through
    `_blocked_reduce`, the rest through torch scatter (`index_add_` /
    `scatter_reduce`); above it, all scatter.
A CUDA tensor goes through the kernel or the call raises; nothing falls back.
Every strategy gives the same counts, long sums and min/max bit for bit;
float sums differ by summation order only. Only "mixed" uses float atomics
(its scatters), so every other strategy repeats its float bits run to run.

Staging follows `cascade.plan_pair`: the cascade rungs (RLE, delta, FOR,
LZ4) stage encoded where the rows keep their order, and on the projection
and megakernel strategies the value columns B1/B2 read stage as packed
words where they fit (data/packed.py); every other column stages dense. The
derived `__key`/`__bucket` columns take the FOR rung where their range
packs. The program top splits the block (`cascade.split_resident`): B1 and
B2 read the packed columns as words, and every other consumer reads a
`DecodedView`, which decodes a column on the card the first time it is read
in the query (`__time_offset` for the time mask, a filter's residual on a
packed metric). A column that only the kernels read is never decoded.
`cascade.set_enabled(False)` stages every rung dense and turns off
code-domain aggregation, as in the reference.
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from druid_tpu_torch.data import cascade as cascade_mod
from druid_tpu_torch.data import packed as packed_mod
from druid_tpu_torch.data.bitmap import stable_argsort
from druid_tpu_torch.data.segment import Segment
from druid_tpu_torch.engine import megakernel, rundomain
from druid_tpu_torch.engine.contracts import (BATCH_MAX_SEGMENTS,
                                              BATCH_STEP_CELLS)
from druid_tpu_torch.engine import sorted_reduce as sorted_reduce_mod
from druid_tpu_torch.engine.filters import (ConstNode, FilterNode,
                                            assign_bitmap_slots,
                                            expression_bindings,
                                            interval_offsets, perm_digest,
                                            plan_filter, stage_device_bitmaps,
                                            time_mask)
from druid_tpu_torch.engine.kernels import (AggKernel, count_true,
                                            expand_batch, make_kernel)
from druid_tpu_torch.obs import dispatch as dispatch_mod
from druid_tpu_torch.obs.trace import fold_span
from druid_tpu_torch.engine.mmagg import (MM_GROUP_LIMIT, mm_reduce,
                                          mm_reduce_stacked)
from druid_tpu_torch.utils.expression import (lut_for_site, parse_expression,
                                              rewrite_string_sites)
from druid_tpu_torch.utils.granularity import Granularity
from druid_tpu_torch.utils.intervals import Interval

DENSE_GROUP_LIMIT = 1 << 21  # max dense key space per (bucket x groups) grid
#: below this many padded rows the one-time sort outweighs the kernel's win
PROJECTION_MIN_ROWS = 1 << 20
BLOCKED_GROUP_LIMIT = 2048   # largest group space of the blocked reduction
BLOCK_ROWS = 2048            # a blocked step's rows are a multiple of this
WINDOW_BLOCK = 1024          # rows per local-window block (and per block
                             # Projection.max_span measures)
WINDOW_CHOICES = (128, 256, 512)
#: elements of one step's [groups, rows] broadcast in the blocked and
#: windowed reductions: the step's bool mask is this many bytes (1 GiB), its
#: largest temporary (a masked int32/float32 copy of a value column) four
#: times that. A 12.5M-row segment takes one step at G = 32, 12 at G = 1024
#: and 7 windowed at W = 512.
STEP_CELLS = 1 << 30
#: measurement override: force an ELIGIBLE strategy ("mm", "blocked",
#: "windowed", "projection" or "mixed"), as the reference's FORCE_STRATEGY
#: does; an ineligible force falls through to normal selection
FORCE_STRATEGY: Optional[str] = None


def pad_pow2(n: int, floor: int = 8) -> int:
    return max(floor, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


@dataclass
class KeyDim:
    """One grouping dimension: an ids column (through an optional remap)
    with its output cardinality. column=None means the dimension is absent
    from the segment — it contributes the constant id 0 (value "").

    `remap` (int32 [input cardinality] -> output id, or -1 to drop the row)
    carries an extraction or listFiltered dimension spec. `host_ids` set
    means the ids are a derived host array, not a segment column (a numeric
    or expression dimension's query-time dictionary): `column` is then a
    synthetic name the block stages the array under, and `ids_key` its
    cache identity."""
    column: Optional[str]
    cardinality: int
    remap: Optional[np.ndarray] = None
    host_ids: Optional[np.ndarray] = None
    ids_key: Optional[Tuple] = None

    def ids(self, segment: Segment) -> np.ndarray:
        """The input ids per row (host), before the remap."""
        return self.host_ids if self.host_ids is not None \
            else segment.dims[self.column].ids


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
    #: rundomain._plan_run_domain's memo: (plan or None,)
    _cascade_run_plan: Optional[Tuple] = None

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
    return tuple((d.column, d.cardinality,
                  None if d.remap is None else d.remap.tobytes(), d.ids_key)
                 for d in dims)


def _fused_raw_keys(segment: Segment, spec: GroupSpec) -> np.ndarray:
    """Host: int64 fused (bucket, dim ids) key per row; -1 = invalid row
    (out of the bucket range, or a value its dimension's remap drops)."""
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
        ids = d.ids(segment)
        if d.remap is not None:
            ids = d.remap[ids]
            valid &= ids >= 0
        key = key * d.cardinality + ids
    return np.where(valid, key, -1)


def _max_block_span(keys: np.ndarray, live: np.ndarray) -> int:
    """The widest key range (hi - lo + 1) over the live rows of any
    WINDOW_BLOCK-row block; 1 when no row is live."""
    keys = keys.astype(np.int64, copy=False)
    n = keys.shape[0]
    big, small = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    npad = max(-(-n // WINDOW_BLOCK), 1) * WINDOW_BLOCK
    lo = np.full(npad, big, dtype=np.int64)
    hi = np.full(npad, small, dtype=np.int64)
    lo[:n] = np.where(live, keys, big)
    hi[:n] = np.where(live, keys, small)
    lo = lo.reshape(-1, WINDOW_BLOCK).min(axis=1)
    hi = hi.reshape(-1, WINDOW_BLOCK).max(axis=1)
    some = lo <= hi
    return int((hi[some] - lo[some] + 1).max()) if some.any() else 1


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
        order = stable_argsort(raw)
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
        return Projection(order=order.astype(np.int32), keys=keys,
                          unique=unique,
                          max_span=_max_block_span(keys, keys >= 0))

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


def windowed_window(segment: Segment, intervals: Sequence[Interval],
                    granularity: Granularity, spec: GroupSpec) -> int:
    """Host-side eligibility for the windowed strategy: the smallest W in
    WINDOW_CHOICES covering every WINDOW_BLOCK-row block's fused-key span, or
    0. Spans are measured over all interval-valid rows; a query filter only
    shrinks the row set, so it never widens a block's span. Cached per
    (segment, key structure)."""
    key = ("windowed_span", str(granularity),
           tuple((iv.start, iv.end) for iv in intervals),
           _dims_key(spec.dims))

    def _compute():
        n = segment.n_rows
        if n == 0:
            return 1
        if spec.bucket_mode == "all":
            b = np.zeros(n, dtype=np.int64)
            ok = np.ones(n, dtype=bool)
        elif spec.bucket_mode == "uniform":
            b = (segment.time_ms - int(spec.bucket_starts[0])) \
                // spec.uniform_period
            ok = (b >= 0) & (b < spec.num_buckets)
        else:
            b = spec.host_bucket_ids[:n].astype(np.int64)
            ok = b >= 0
        k = b
        for d in spec.dims:
            if d.column is None:
                continue
            ids = d.ids(segment)
            if d.remap is not None:
                ids = d.remap[ids]
                ok = ok & (ids >= 0)
            k = k * d.cardinality + np.maximum(ids, 0)
        return _max_block_span(k, ok)

    span = segment.aux_cached(key, _compute)
    for w in WINDOW_CHOICES:
        if span <= w:
            return w
    return 0


def select_strategy(spec: GroupSpec, kernels: Sequence[AggKernel],
                    col_dtypes: Dict, padded_rows: int,
                    windowed_w: Union[int, Callable[[], int]],
                    vc_dtypes: Optional[Dict] = None) -> Tuple[str, int]:
    """The reference's choice of reduction strategy for one (segment, query)
    plan: (strategy, window). `col_dtypes` are the staged dtypes (never read
    off tensors), without the virtual columns, as the reference plans;
    `windowed_w` is W or 0, or a callable run only when the windowed
    strategy is a candidate (the host span check).

    `vc_dtypes` are the virtual columns' output dtypes. A kernel over a
    virtual column plans as over a missing column, except that mm needs its
    plan over the computed dtype: the reference takes mm with a LONG or
    DOUBLE virtual sum, which has no mm plan, and fails at trace time; the
    port goes on down the reference's order."""
    num = spec.num_total
    mm_ok = all(k.mm_plan({**col_dtypes, **(vc_dtypes or {})},
                          padded_rows) is not None for k in kernels)
    blocked_ok = all(k.blocked_supported(col_dtypes) for k in kernels)

    def window() -> int:
        return windowed_w() if callable(windowed_w) else windowed_w

    f = FORCE_STRATEGY
    if f == "mixed":
        return "mixed", 0
    if f == "mm" and mm_ok and num <= MM_GROUP_LIMIT:
        return "mm", 0
    if f == "blocked" and blocked_ok and num <= BLOCKED_GROUP_LIMIT:
        return "blocked", 0
    if f == "windowed" and blocked_ok:
        w = window()
        if w:
            return "windowed", w
    if f == "projection" and blocked_ok:
        return "projection", 0
    if blocked_ok and num <= 64:
        return "blocked", 0      # near-streaming
    if mm_ok and num <= 2048:
        return "mm", 0
    if num > BLOCKED_GROUP_LIMIT and blocked_ok and spec.key_mode == "dense":
        w = window()
        if w:
            return "windowed", w
    if blocked_ok and num <= BLOCKED_GROUP_LIMIT:
        return "blocked", 0
    if mm_ok and num <= MM_GROUP_LIMIT:
        return "mm", 0
    if blocked_ok and num > MM_GROUP_LIMIT \
            and padded_rows >= PROJECTION_MIN_ROWS:
        return "projection", 0
    return "mixed", 0


def _projection_strategy(proj: Projection, kernels: Sequence[AggKernel],
                         col_dtypes: Dict, num_total: int,
                         vc_dtypes: Optional[Dict] = None) -> Tuple[str, int]:
    """The reduction over the sorted compacted layout: kernel B1 when its
    caps hold, else the windowed reduction when the span fits a window, else
    scatter. B1 takes the virtual columns at their computed dtypes
    (`vc_dtypes`): the reference plans them as missing columns, and its
    kernel then has no op for a DOUBLE or LONG virtual sum; the port goes
    on to the windowed reduction there."""
    span = proj.max_span
    if sorted_reduce_mod.usable(kernels, {**col_dtypes, **(vc_dtypes or {})},
                                span, num_total):
        return "projection", span
    for w in WINDOW_CHOICES:
        if span <= w:
            return "windowed", w
    return "mixed", 0


def _step_rows(width: int, unit: int, cells: int = STEP_CELLS) -> int:
    """Rows per step of a [width, rows] broadcast: the most whole `unit`s
    within `cells`."""
    return max(unit, cells // max(width, 1) // unit * unit)


def _value_columns(arrays: Dict, kernels: Sequence[AggKernel]) -> Dict:
    """The columns the kernels' blocked steps read (decoded)."""
    fields = sorted({k.spec.field for k in kernels
                     if getattr(k.spec, "field", None) in arrays})
    return {f: arrays[f] for f in fields}


def _blocked_reduce(arrays: Dict, mask: torch.Tensor, key: torch.Tensor,
                    kernels: Sequence[AggKernel], num_total: int):
    """Masked broadcast-reduce over steps of rows: per step the bool
    [num_total, rows] matrix of (key == group AND mask), reduced over rows by
    each kernel's blocked step. Returns (counts int64 [num_total], per-kernel
    states) shaped like the scatter path's. No atomics: the bits repeat.

    A batched stack ([K, R] mask, key and columns) keeps its batch axis:
    the step is [K, num_total, rows], its rows sized so that a stack of
    BATCH_MAX_SEGMENTS fits BATCH_STEP_CELLS (the same steps, hence the
    same launches, whatever K), and the results are [K, num_total]."""
    cols = _value_columns(arrays, kernels)
    dev = key.device
    batch = tuple(mask.shape[:-1])
    iota = torch.arange(num_total, dtype=key.dtype, device=dev)
    counts = torch.zeros(batch + (num_total,), dtype=torch.int64, device=dev)
    states = [k.blocked_init(num_total, cols, dev) for k in kernels]
    step = _step_rows(num_total, BLOCK_ROWS) if not batch \
        else _step_rows(BATCH_MAX_SEGMENTS * num_total, BLOCK_ROWS,
                        BATCH_STEP_CELLS)
    for s in range(0, mask.shape[-1], step):
        valid = (iota[:, None] == key[..., None, s:s + step]) \
            & mask[..., None, s:s + step]
        counts = counts + count_true(valid)
        cb = {f: c[..., s:s + step] for f, c in cols.items()}
        states = [k.blocked_step(st, cb, valid, num_total)
                  for k, st in zip(kernels, states)]
    return counts, tuple(expand_batch(k.blocked_finish(st), batch)
                         for k, st in zip(kernels, states))


def _combine_grids(flat: torch.Tensor, flat_keys: torch.Tensor,
                   num_total: int, kind: str, ident, runs) -> torch.Tensor:
    """Reduce per-block grid slots into the [num_total] grid. Integers go
    through integer scatters (order-free, so exact and repeatable); floats
    through a segmented reduction over `runs` = (the slots' stable sort
    order by key, each run's key, its length), so in block order with no
    float atomics, with NaN carried explicitly for min/max."""
    if not flat.dtype.is_floating_point:
        if kind == "sum":
            return torch.zeros(num_total, dtype=flat.dtype,
                               device=flat.device) \
                .index_add_(0, flat_keys, flat)
        out = torch.full((num_total,), ident, dtype=flat.dtype,
                         device=flat.device)
        return out.scatter_reduce_(0, flat_keys, flat,
                                   "amax" if kind == "max" else "amin")
    order, uniq, lengths = runs
    v = flat[order]
    if kind == "sum":
        red = torch.segment_reduce(v, "sum", lengths=lengths)
    else:
        nan = torch.isnan(v)
        red = torch.segment_reduce(torch.where(nan, ident, v), kind,
                                   lengths=lengths)
        has_nan = torch.segment_reduce(nan.to(v.dtype), "max",
                                       lengths=lengths) > 0
        red = torch.where(has_nan, float("nan"), red)
    out = torch.full((num_total,), 0.0 if kind == "sum" else ident,
                     dtype=flat.dtype, device=flat.device)
    out[uniq] = red
    return out


def _windowed_reduce(arrays: Dict, mask: torch.Tensor, key: torch.Tensor,
                     kernels: Sequence[AggKernel], num_total: int, W: int):
    """Big-G reduction for segments whose rows are clustered by key: each
    WINDOW_BLOCK-row block's live keys span fewer than W, so the block
    reduces into a local [W] grid based at its least live key (L1, the
    kernels' blocked steps over [blocks, W, WINDOW_BLOCK]), and the
    #blocks x W grid slots combine into the [num_total] grid (L2,
    `_combine_grids`). Returns (counts int64, per-kernel states)."""
    cols = _value_columns(arrays, kernels)
    n = mask.shape[0]
    dev = key.device
    nb = max(1, -(-n // WINDOW_BLOCK))
    pad = nb * WINDOW_BLOCK - n

    def blocks(t: torch.Tensor) -> torch.Tensor:
        if pad:
            t = torch.nn.functional.pad(t, (0, pad))
        return t.view(nb, WINDOW_BLOCK)

    keyb, maskb = blocks(key), blocks(mask)
    colsb = {f: blocks(c) for f, c in cols.items()}
    iota = torch.arange(W, dtype=key.dtype, device=dev)
    big = torch.iinfo(key.dtype).max
    inits = [k.blocked_init(W, cols, dev) for k in kernels]
    bases, cnts, grids = [], [], [[] for _ in kernels]
    step = _step_rows(W, WINDOW_BLOCK) // WINDOW_BLOCK
    for b in range(0, nb, step):
        kb, mb = keyb[b:b + step], maskb[b:b + step]
        base = torch.where(mb, kb, big).amin(1)
        base = torch.where(base == big, 0, base)     # fully masked block
        valid = (iota[None, :, None] == (kb - base[:, None])[:, None, :]) \
            & mb[:, None, :]                           # [blocks, W, rows]
        bases.append(base)
        cnts.append(count_true(valid))
        cb = {f: c[b:b + step] for f, c in colsb.items()}
        for i, (k, i0) in enumerate(zip(kernels, inits)):
            g = k.blocked_step(i0, cb, valid, W)
            grids[i].append(g.expand(kb.shape[0], W))
    # slots past num_total hold identities (keys were clamped), so clamping
    # their targets cannot touch a real group
    flat_keys = (torch.cat(bases)[:, None] + iota[None, :]) \
        .clamp(0, num_total - 1).reshape(-1)
    flats = [torch.cat(g).reshape(-1) for g in grids]
    runs = None
    if any(f.dtype.is_floating_point for f in flats):
        order = torch.argsort(flat_keys, stable=True)
        runs = (order,) + tuple(torch.unique_consecutive(
            flat_keys[order], return_counts=True))
    counts = _combine_grids(torch.cat(cnts).reshape(-1).to(torch.int64),
                            flat_keys, num_total, "sum", 0, runs)
    states = []
    for k, flat in zip(kernels, flats):
        ident = 0 if k.reduce_kind == "sum" else k.ident_for(flat.dtype)
        states.append(k.blocked_finish(_combine_grids(
            flat, flat_keys, num_total, k.reduce_kind, ident, runs)))
    return counts, tuple(states)


#: a virtual column's dtype per outputType (anything else: double)
_VC_DTYPES = {"long": "int64", "double": "float64", "float": "float32"}


def vc_dtype(output_type: str) -> str:
    return _VC_DTYPES.get(output_type, "float64")


def plan_virtual_columns(segment: Segment, virtual_columns: Sequence
                         ) -> Tuple[Tuple, List[np.ndarray]]:
    """Per-(segment, query) virtual-column plan: each expression parsed, its
    string-dimension comparisons rewritten into per-dictionary-id LUT
    gathers (`rewrite_string_sites`; any other use of a string dimension
    raises). Returns ((name, rewritten expr, output type, LUT count), ...)
    and the LUTs in order."""
    plans = []
    luts: List[np.ndarray] = []
    string_dims = frozenset(segment.dims)
    for v in virtual_columns:
        expr, sites = rewrite_string_sites(parse_expression(v.expression),
                                           string_dims)
        luts.extend(lut_for_site(site, segment.dims[site[0]].dictionary
                                 .values) for site in sites)
        plans.append((v.name, expr, v.output_type, len(sites)))
    return tuple(plans), luts


def eval_virtual_columns(arrays, time0: int, vc_plans: Tuple,
                         luts: Sequence[np.ndarray]):
    """Evaluate the planned virtual columns over the staged block on its
    device (the reference's ExpressionVirtualColumn): each becomes a
    [padded_rows] tensor of its output dtype in `arrays` (a dict or a
    DecodedView, updated in place and returned); a later virtual column
    may read an earlier one. `__time` is the absolute time (int64 offset
    + time0) of the block's rows, in its (possibly permuted) order."""
    bindings = expression_bindings(arrays, time0, luts)
    all_luts = bindings.extra["__luts"]
    shape = arrays["__valid"].shape
    at = 0
    for name, expr, out_type, n_luts in vc_plans:
        bindings.extra["__luts"] = all_luts[at:at + n_luts]
        at += n_luts
        val = expr.evaluate(bindings)
        dt = getattr(torch, vc_dtype(out_type))
        if torch.is_tensor(val):
            val = val.to(dt).expand(shape).contiguous()
        else:
            val = torch.full(shape, val, dtype=dt,
                             device=arrays["__valid"].device)
        arrays[name] = val
        bindings.extra[name] = val
    return arrays


def _fuse_dims(arrays, mask: torch.Tensor, key: torch.Tensor,
               dims: Sequence[KeyDim]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask, int64 key) with each dimension's ids fused into the key; a
    dimension's remap maps its ids first, and a -1 drops the row."""
    key = key.to(torch.int64)
    for d in dims:
        if d.column is None:
            continue
        ids = arrays[d.column].to(torch.int64)
        if d.remap is not None:
            ids = torch.from_numpy(d.remap).to(ids.device)[ids] \
                .to(torch.int64)
            mask = mask & (ids >= 0)
        key = key * d.cardinality + ids.clamp_min(0)
    return mask, key


def fuse_filter_update(arrays: Dict[str, torch.Tensor], mask: torch.Tensor,
                       key: torch.Tensor, dims: Sequence[KeyDim],
                       filter_node: Optional[FilterNode],
                       kernels: Sequence[AggKernel], num_total: int,
                       strategy: str = "mixed", span: int = 0,
                       packed_cols: Optional[Dict] = None):
    """Fuse dimension ids into the key, apply the filter mask, and run every
    kernel's reduction by the strategy (`span` is B1/B2's projection span or
    the windowed strategy's W). `arrays` is the dense view (a dict or a
    cascade.DecodedView); `packed_cols` are the packed columns that kernels
    B1/B2 read as words. A dimension's remap maps its ids first, and a -1
    drops the row. Returns (counts, per-kernel states) as device tensors."""
    mask, key = _fuse_dims(arrays, mask, key, dims)
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
    if strategy == "mm":
        col_dtypes = cascade_mod.column_dtypes(arrays)
        plans = [k.mm_plan(col_dtypes, mask.shape[0]) for k in kernels]
        missing = [k.name for k, p in zip(kernels, plans) if p is None]
        if missing:
            raise RuntimeError(f"mm strategy selected but {missing} have no "
                               f"mm plan at run time")
        return mm_reduce(arrays, mask, key, kernels, plans, num_total)
    if strategy == "windowed":
        return _windowed_reduce(arrays, mask, key, kernels, num_total, span)

    # blocked, and the reference's mixed hybrid: blocked-eligible kernels
    # (and the row counts) through the blocked reduction, the rest scatter
    blocked_idx = []
    if strategy in ("blocked", "mixed") and num_total <= BLOCKED_GROUP_LIMIT:
        col_dtypes = cascade_mod.column_dtypes(arrays)
        blocked_idx = [i for i, k in enumerate(kernels)
                       if k.blocked_supported(col_dtypes)]
    blocked_states = {}
    if blocked_idx:
        counts, bstates = _blocked_reduce(
            arrays, mask, key, [kernels[i] for i in blocked_idx], num_total)
        blocked_states = dict(zip(blocked_idx, bstates))
    else:
        counts = torch.zeros(num_total, dtype=torch.int64,
                             device=key.device) \
            .index_add_(0, key, mask.to(torch.int64))
    return counts, tuple(blocked_states[i] if i in blocked_states
                         else k.update(arrays, mask, key, num_total)
                         for i, k in enumerate(kernels))


def _pad_device(segment: Segment, cache_key: Tuple, arr: np.ndarray,
                padded: int, fill, device: torch.device,
                value_range: Optional[Tuple[int, int]] = None):
    """Padded device copy of a derived host column, cached on the segment.

    `value_range=(lo, hi)` marks an int32 column whose exact range is a
    plan constant (`__key`, `__bucket`): where the cascade's FOR rung
    covers it (`cascade.for_encode_derived`), it stages as range-packed
    words (a cascade.ForColumn) that the program decodes on first read."""
    plan = cascade_mod.for_encode_derived(*value_range) \
        if value_range is not None and arr.dtype == np.int32 else None

    def _padded() -> np.ndarray:
        out = np.full((padded,), fill, dtype=arr.dtype)
        out[: arr.shape[0]] = arr
        return out
    if plan is not None:
        w, base = plan
        return segment.device_cached(
            ("devpadfor", cache_key, padded, fill, w, base, str(device)),
            lambda: cascade_mod.ForColumn(
                packed_mod.pack_device(torch.from_numpy(_padded()).to(device),
                                       w, base), w, base, padded,
                str(arr.dtype)))
    return segment.device_cached(
        ("devpad", cache_key, padded, fill, str(device)),
        lambda: torch.from_numpy(_padded()).to(device))


def staged_col_dtypes(segment: Segment, spec: GroupSpec,
                      needed) -> Dict[str, np.dtype]:
    """{column: dtype} of what a block for `needed` stages, and of the
    derived key columns, as the reference's planner lists them: read from
    the segment (`staged_dtype`), never off a tensor, which would decode a
    packed column."""
    col_dtypes = {"__time_offset": np.dtype(np.int32),
                  "__valid": np.dtype(bool)}
    col_dtypes.update({c: segment.staged_dtype(c) for c in needed})
    if spec.key_mode == "dense":
        col_dtypes.update({d.column: np.dtype(np.int32) for d in spec.dims
                           if d.host_ids is not None})
    if spec.key_mode == "host":
        col_dtypes["__key"] = np.dtype(np.int32)
    elif spec.bucket_mode == "host":
        col_dtypes["__bucket"] = np.dtype(np.int32)
    return col_dtypes


_NO_NODE = object()   # "the caller did not plan the filter"


def _value_needs(segment: Segment, aggs: Sequence, flt, virtual_columns,
                 filter_node, kernels, vc_plans) -> set:
    """The real columns the filter, the aggregators and the virtual columns
    read. The PLANNED tree's and kernels' needs where given, which are
    narrower: a bitmap node reads words, a constant sum reads nothing."""
    needed = set()
    if filter_node is _NO_NODE:
        if flt is not None:
            needed |= flt.required_columns()
    elif filter_node is not None:
        needed |= filter_node.required_device_columns()
    for i, a in enumerate(aggs):
        kc = kernels[i].required_device_columns() \
            if kernels is not None else None
        needed |= a.required_columns() if kc is None else kc
    # a virtual column's inputs stage; the column itself is computed
    if vc_plans is not None:
        for _, expr, _, _ in vc_plans:
            needed |= expr.required_columns()
    else:
        for v in virtual_columns:
            needed |= parse_expression(v.expression).required_columns()
    needed -= {v.name for v in virtual_columns}
    return {c for c in needed if c in segment.dims or c in segment.metrics}


def needed_columns(segment: Segment, kds: Sequence[KeyDim], aggs: Sequence,
                   flt, virtual_columns: Sequence, filter_node=_NO_NODE,
                   kernels: Optional[Sequence[AggKernel]] = None,
                   vc_plans: Optional[Tuple] = None):
    """(every referenced column name, the sorted subset present in the
    segment, which is what stages). With the planned `filter_node` (None
    counts: the filter folded away) and `kernels`, their planned needs
    replace the raw filter's and aggregators'."""
    needed = {d.column for d in kds if d.column is not None}
    needed |= _value_needs(segment, aggs, flt, virtual_columns, filter_node,
                           kernels, vc_plans)
    present = tuple(sorted(c for c in needed
                           if c in segment.dims or c in segment.metrics))
    return needed, present


@dataclass
class GroupPlan:
    """The host-side planning of one segment's grouped aggregate, before
    any staging: the group spec, the planned filter tree, the kernels and
    the virtual-column plans. Single-use: a run mutates `spec` (strategy,
    the projection's key rewrite), so a plan serves one run."""
    spec: GroupSpec
    filter_node: Optional[FilterNode]
    kernels: List[AggKernel]
    vc_plans: Tuple
    vc_luts: List[np.ndarray]


def plan_grouped_aggregate(segment: Segment, intervals: Sequence[Interval],
                           granularity: Granularity, dims: Sequence[KeyDim],
                           aggs: Sequence, flt,
                           virtual_columns: Sequence = ()) -> GroupPlan:
    """Host-side planning for one segment (no staging, no device work)."""
    spec = make_group_spec(segment, intervals, granularity, dims)
    vc_plans, vc_luts = plan_virtual_columns(segment, virtual_columns)
    filter_node = plan_filter(flt, segment, virtual_columns)
    kernels = [make_kernel(a, segment) for a in aggs]
    # one `__fbmpN` / mega leaf namespace for the query filter's and the
    # filtered aggregators' bitmap nodes
    assign_bitmap_slots(filter_node, kernels)
    return GroupPlan(spec=spec, filter_node=filter_node, kernels=kernels,
                     vc_plans=vc_plans, vc_luts=vc_luts)


def run_grouped_aggregate(segment: Segment, intervals: Sequence[Interval],
                          granularity: Granularity, dims: Sequence[KeyDim],
                          aggs: Sequence, flt, device: torch.device,
                          virtual_columns: Sequence = (),
                          plan: Optional[GroupPlan] = None
                          ) -> SegmentPartial:
    """Execute the grouped aggregation for one segment on `device`; returns
    host partials. `virtual_columns` are evaluated over the staged block on
    `device` before the filter and every reduction. `plan` (from
    plan_grouped_aggregate over the same arguments) skips the planning: the
    batched path passes the plan it built for bucketing."""
    with fold_span("engine/plan"):
        if plan is None:
            plan = plan_grouped_aggregate(segment, intervals, granularity,
                                          dims, aggs, flt, virtual_columns)
        spec, filter_node, kernels = plan.spec, plan.filter_node, \
            plan.kernels
        vc_plans, vc_luts = plan.vc_plans, plan.vc_luts
        if isinstance(filter_node, ConstNode) and not filter_node.value:
            # constant-false filter: nothing matches, no device work
            return SegmentPartial(
                segment=segment, spec=spec,
                counts=np.zeros(spec.num_total, dtype=np.int64),
                states={k.name: k.empty_state(spec.num_total)
                        for k in kernels},
                kernels=kernels)
        # code-domain aggregation (engine/rundomain.py): when every column
        # the query reads is constant within one shared run partition, the
        # aggregate runs over run tables; no row-width column stages
        rd_plan = rundomain._plan_run_domain(
            segment, intervals, granularity, spec, kernels, flt,
            virtual_columns) if cascade_mod.enabled() else None
        if rd_plan is None:
            filter_node, perm, perm_key, words, needed = _plan_row_run(
                segment, intervals, granularity, aggs, flt, virtual_columns,
                plan, device)

    if rd_plan is not None:
        with fold_span("engine/reduce"):
            counts, states = rundomain.run_planned(segment, spec, rd_plan,
                                                   device)
        spec.strategy = "runDomain"
        with fold_span("engine/to_host"):
            return SegmentPartial(
                segment=segment, spec=spec,
                counts=counts.cpu().numpy().astype(np.int64),
                states={k.name: k.host_post(st, segment)
                        for k, st in zip(kernels, states)},
                kernels=kernels)

    with fold_span("engine/stage"):
        block = segment.device_block(sorted(needed), device, perm=perm,
                                     perm_key=perm_key, words=words)
        # packed value columns go to B1/B2 as words; everything else reads
        # the dense view, which decodes a column on its first read
        packed_cols, arrays = cascade_mod.split_resident(block.arrays)
        rows = block.padded_rows
        # the derived columns join the view after the virtual columns, so
        # a derived column of a virtual column's name wins, as it always did
        derived: Dict[str, object] = {}
        if spec.key_mode == "dense":
            for d in spec.dims:
                if d.host_ids is not None:
                    # a derived id column (numeric or expression dimension)
                    derived[d.column] = _pad_device(
                        segment, d.ids_key, d.host_ids, rows, 0, device)
        # staged combined words and fused leaf words, in the projection's
        # row order on that path
        derived.update(stage_device_bitmaps(segment, filter_node, rows,
                                            device, perm, perm_key, kernels))
        derived.update(megakernel.stage_mega_leaves(
            segment, filter_node, rows, device, perm, perm_key, kernels))
        if spec.key_mode == "host":
            # derived keys ride the FOR rung where their range [-1, G)
            # packs
            derived["__key"] = _pad_device(
                segment, spec.host_keys_cache, spec.host_keys, rows, -1,
                device, value_range=(-1, spec.num_total - 1))
        elif spec.bucket_mode not in ("all", "uniform"):
            derived["__bucket"] = _pad_device(
                segment, spec.host_bucket_cache, spec.host_bucket_ids, rows,
                -1, device, value_range=(-1, spec.num_buckets - 1))

    with fold_span("engine/reduce"):
        if vc_plans:
            # over the staged (on the projection path, permuted) rows,
            # before the filter and every reduction
            eval_virtual_columns(arrays, segment.interval.start, vc_plans,
                                 vc_luts)
        arrays.update(derived)
        t = arrays["__time_offset"]
        mask = arrays["__valid"] & time_mask(
            t, interval_offsets(intervals, segment.interval.start))
        key_dims: Sequence[KeyDim] = spec.dims
        if spec.key_mode == "host":
            key = arrays["__key"]
            mask = mask & (key >= 0)
            key_dims = ()
        elif spec.bucket_mode == "all":
            key = torch.zeros(t.shape, dtype=torch.int64, device=device)
        elif spec.bucket_mode == "uniform":
            # int32 offsets, floor division like the reference's bucket
            # math
            b = (t.to(torch.int64) - spec.uniform_first_offset) \
                // spec.uniform_period
            mask = mask & (b >= 0) & (b < spec.num_buckets)
            key = b
        else:
            key = arrays["__bucket"]
            mask = mask & (key >= 0)
        counts, states = fuse_filter_update(
            arrays, mask, key, key_dims, filter_node, kernels,
            spec.num_total, strategy=spec.strategy, span=spec.window,
            packed_cols=packed_cols or None)
    dispatch_mod.record("segment")
    with fold_span("engine/to_host"):
        host_states = {k.name: k.host_post(st, segment)
                       for k, st in zip(kernels, states)}
        return SegmentPartial(segment=segment, spec=spec,
                              counts=counts.cpu().numpy().astype(np.int64),
                              states=host_states, kernels=kernels)


def _plan_row_run(segment: Segment, intervals: Sequence[Interval],
                  granularity: Granularity, aggs: Sequence, flt,
                  virtual_columns: Sequence, plan: GroupPlan,
                  device: torch.device):
    """The row program's host planning of one segment, after the run
    domain refused it: the strategy (and on the projection path the
    sorted layout and its key rewrite, in `plan.spec`) and the megakernel's
    fused filter trees (the filtered kernels' in place). Returns (the
    filter tree, perm, perm_key, packed words, the columns to stage)."""
    spec, filter_node, kernels = plan.spec, plan.filter_node, plan.kernels
    vc_plans = plan.vc_plans
    base_needed = _value_needs(segment, aggs, flt, virtual_columns,
                               filter_node, kernels, vc_plans)
    needed = set(base_needed)
    if spec.key_mode == "dense":
        needed |= {d.column for d in spec.dims
                   if d.column is not None and d.host_ids is None}

    padded_rows = segment.padded_rows()
    col_dtypes = staged_col_dtypes(segment, spec, needed)
    vc_dtypes = {v.name: vc_dtype(v.output_type) for v in virtual_columns}
    spec.strategy, spec.window = select_strategy(
        spec, kernels, col_dtypes, padded_rows,
        lambda: windowed_window(segment, intervals, granularity, spec),
        vc_dtypes)

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
        col_dtypes = staged_col_dtypes(segment, spec, needed)
        spec.strategy, spec.window = _projection_strategy(
            proj, kernels, col_dtypes, spec.num_total, vc_dtypes)
        if spec.strategy == "projection":
            # B1 (or B2) reads these as words where they pack; a virtual
            # column is not staged (it plans as a missing column), so it is
            # never asked for as words and B1/B2 read it dense
            words = sorted_reduce_mod.value_fields(kernels, col_dtypes)

    # bitmap subtrees whose combined words are not cached fuse into the
    # aggregation (engine/megakernel.py); cached ones keep the bit test
    if megakernel.enabled():
        filter_node = megakernel.megaize(filter_node, segment, padded_rows,
                                         device, perm_digest(perm_key))
        megakernel.megaize_kernels(kernels, segment, padded_rows, device,
                                   perm_digest(perm_key))
    else:
        megakernel.record_disabled_fallback(filter_node, kernels)
    if spec.strategy == "projection" \
            and megakernel.split_for_kernel(filter_node)[0]:
        spec.strategy = "megakernel"
    return filter_node, perm, perm_key, words, needed


# ---------------------------------------------------------------------------
# Stacked (batched) execution: one run over a chunk of K segments
# ---------------------------------------------------------------------------

def _structure_sig(spec: GroupSpec, n_intervals: int,
                   filter_node: Optional[FilterNode],
                   kernels: Sequence[AggKernel], vc_plans: Tuple,
                   packs: Tuple = (), cascades: Tuple = ()) -> str:
    """The reference's structure signature of a plan: what two segments
    must share to run in one stacked program (values excluded: those are
    `aux_equal`'s)."""
    dims_sig = ",".join(
        f"{d.column}:{'remap' if d.remap is not None else 'raw'}"
        for d in spec.dims)
    vc_sig = ";".join(f"{name}={expr!r}:{out_type}:l{n_luts}"
                      for name, expr, out_type, n_luts in vc_plans)
    return "|".join([
        f"bucket={spec.bucket_mode}",
        f"key={spec.key_mode}",
        f"dims={dims_sig}",
        f"iv={n_intervals}",
        f"vc={vc_sig}",
        f"filt={filter_node.signature() if filter_node else 'none'}",
        f"aggs={';'.join(k.signature() for k in kernels)}",
        f"total={spec.num_total}",
        f"strat={spec.strategy}:{spec.window}",
        f"packs={packs}",
        f"casc={cascades}",
    ])


def aux_equal(a: Sequence[np.ndarray], b: Sequence[np.ndarray]) -> bool:
    """Plan constants equal across segments (same dtypes, shapes, values)."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype != y.dtype or x.shape != y.shape \
                or not np.array_equal(x, y):
            return False
    return True


def keydims_equal(a: Sequence[KeyDim], b: Sequence[KeyDim]) -> bool:
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.column != y.column or x.cardinality != y.cardinality:
            return False
        if (x.remap is None) != (y.remap is None):
            return False
        if x.remap is not None and not np.array_equal(x.remap, y.remap):
            return False
    return True


@dataclass
class StackedAux:
    """A chunk's shared plan constants, equal across its segments by
    construction (`batching._compatible`): the key dimensions (their
    remaps), the planned filter tree and kernels (their LUTs and tables),
    the virtual columns' string LUTs, and the uniform bucket period and
    count. The per-segment origins ride the run's [K] arguments instead."""
    kds: Tuple[KeyDim, ...]
    filter_node: Optional[FilterNode]
    kernels: List[AggKernel]
    vc_luts: List[np.ndarray]
    period: int
    num_buckets: int


def assemble_stacked_aux(spec: GroupSpec, kds: Sequence[KeyDim],
                         filter_node: Optional[FilterNode],
                         kernels: Sequence[AggKernel],
                         granularity: Granularity,
                         vc_luts: Sequence[np.ndarray] = ()) -> StackedAux:
    period = int(granularity.period_ms) if spec.bucket_mode == "uniform" \
        else 0
    return StackedAux(tuple(kds), filter_node, list(kernels), list(vc_luts),
                      period, spec.num_buckets)


def make_stacked_segment_fn(spec: GroupSpec, vc_plans: Tuple, K: int,
                            device: torch.device):
    """The stacked run of one structure (bucket mode "all" or "uniform",
    dense keys): fn(arrays, time0s, iv_rel, bucket_off, aux) over a chunk's
    [K, R] columns (complex columns [K, R, width]), int64 time0s [K], int32
    iv_rel [K, n_iv, 2] (interval bounds relative to each segment's
    start), int64 bucket_off [K] (each segment's first bucket start less
    its start) and a StackedAux; returns (counts int64 [K, G], per-kernel
    states with a leading K axis). Built once per structure and cached by
    engine/batching.py, and per shard by the mesh's sharded run
    (parallel/distributed.py): it holds the structure and its device
    constants (the k * G slot offsets), never a value of a plan."""
    bucket_mode, num_total = spec.bucket_mode, spec.num_total
    strategy, window = spec.strategy, spec.window
    slot_base = torch.arange(K, dtype=torch.int64, device=device)[:, None] \
        * num_total

    def run(arrays: Dict[str, object], time0s: torch.Tensor,
            iv_rel: torch.Tensor, bucket_off: torch.Tensor,
            aux: StackedAux):
        # stacked encoded columns decode here, each [K, R] slot on its
        # first read (cascade.split_resident, as the per-segment top)
        arrays = cascade_mod.split_resident(arrays)[1]
        t = arrays["__time_offset"]
        mask = arrays["__valid"]
        if vc_plans:
            eval_virtual_columns(arrays, time0s[:, None], vc_plans,
                                 aux.vc_luts)
        within = torch.zeros_like(mask)
        for j in range(iv_rel.shape[1]):
            within |= (t >= iv_rel[:, j, 0:1]) & (t < iv_rel[:, j, 1:2])
        mask = mask & within
        if bucket_mode == "all":
            key = torch.zeros(t.shape, dtype=torch.int64, device=t.device)
        else:
            # int64 like the per-segment path's bucket math
            key = (t.to(torch.int64) - bucket_off[:, None]) // aux.period
            mask = mask & (key >= 0) & (key < aux.num_buckets)
        return fuse_filter_update_stacked(
            arrays, mask, key, aux.kds, aux.filter_node, aux.kernels,
            num_total, slot_base, strategy=strategy, span=window)

    return run


class _FlatView(Mapping):
    """A stack's [K, R] columns read as [K * R], each flattened (and, being
    read through the stack's DecodedView, decoded) on its first read."""

    def __init__(self, arrays):
        self.arrays = arrays
        self._flat: Dict = {}

    def __getitem__(self, name):
        if name not in self._flat:
            self._flat[name] = self.arrays[name].flatten(0, 1)
        return self._flat[name]

    def __contains__(self, name):
        return name in self.arrays

    def __iter__(self):
        return iter(self.arrays)

    def __len__(self):
        return len(self.arrays)


def _unstack_state(state, K: int, num_total: int):
    """A scatter state over the [K * G] grid -> [K, G, ...] (tuples
    leafwise)."""
    if isinstance(state, tuple):
        return tuple(_unstack_state(s, K, num_total) for s in state)
    return state.view((K, num_total) + tuple(state.shape[1:]))


def fuse_filter_update_stacked(arrays: Dict[str, torch.Tensor],
                               mask: torch.Tensor, key: torch.Tensor,
                               dims: Sequence[KeyDim],
                               filter_node: Optional[FilterNode],
                               kernels: Sequence[AggKernel], num_total: int,
                               slot_base: torch.Tensor,
                               strategy: str = "mixed", span: int = 0):
    """fuse_filter_update over a [K, R] stack: the dimension fusion and the
    filter mask once over the stack, then each strategy with a number of
    launches that does not grow with K, where its working set allows:
    "mixed" scatters into one [K * G] grid (the key offset by `slot_base`,
    k * G), "blocked" and the mixed hybrid's blocked part keep a batch
    axis ([K, G, rows] steps), "mm" takes batched one-hot products
    (mmagg.mm_reduce_stacked), and "windowed" reduces the flattened rows
    with offset keys (each 1024-row block lies in one segment). Returns
    (counts [K, G], per-kernel states [K, G, ...])."""
    K = mask.shape[0]
    mask, key = _fuse_dims(arrays, mask, key, dims)
    if filter_node is not None:
        mask = mask & filter_node.build(arrays)
    key = key.clamp(0, num_total - 1)
    if strategy == "mm":
        col_dtypes = cascade_mod.column_dtypes(arrays)
        plans = [k.mm_plan(col_dtypes, mask.shape[-1]) for k in kernels]
        missing = [k.name for k, p in zip(kernels, plans) if p is None]
        if missing:
            raise RuntimeError(f"mm strategy selected but {missing} have no "
                               f"mm plan at run time")
        return mm_reduce_stacked(arrays, mask, key, kernels, plans,
                                 num_total)

    flat = None

    def flattened():
        nonlocal flat
        if flat is None:
            flat = (_FlatView(arrays), mask.flatten(),
                    (key + slot_base).flatten())
        return flat

    if strategy == "windowed":
        cols, fmask, fkey = flattened()
        counts, states = _windowed_reduce(cols, fmask, fkey, kernels,
                                          K * num_total, span)
        return counts.view(K, num_total), tuple(
            _unstack_state(st, K, num_total) for st in states)

    blocked_idx = []
    if strategy in ("blocked", "mixed") and num_total <= BLOCKED_GROUP_LIMIT:
        col_dtypes = cascade_mod.column_dtypes(arrays)
        blocked_idx = [i for i, k in enumerate(kernels)
                       if k.blocked_supported(col_dtypes)]
    blocked_states = {}
    if blocked_idx:
        counts, bstates = _blocked_reduce(
            arrays, mask, key, [kernels[i] for i in blocked_idx], num_total)
        blocked_states = dict(zip(blocked_idx, bstates))
    else:
        _, fmask, fkey = flattened()
        counts = torch.zeros(K * num_total, dtype=torch.int64,
                             device=key.device) \
            .index_add_(0, fkey, fmask.to(torch.int64)).view(K, num_total)
    states = []
    for i, k in enumerate(kernels):
        if i in blocked_states:
            states.append(blocked_states[i])
            continue
        cols, fmask, fkey = flattened()
        states.append(_unstack_state(
            k.update_stacked(cols, fmask, fkey, K, num_total), K,
            num_total))
    return counts, tuple(states)
