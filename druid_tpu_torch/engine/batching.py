"""Batched multi-segment execution: one stacked run per shape bucket.

The port's counterpart of the reference package's `engine/batching.py`. A
query over many small segments (the hourly hand-offs of streaming
ingestion) pays the per-segment host cost (planning, staging, launching)
once per segment on the per-segment path. Here:

  1. each segment is planned once (`grouping.plan_grouped_aggregate`) and
     the eligible plans are grouped by their constants (structure
     signature, staged dtypes and shapes, ladder rung, filter and kernel
     constants, key-dimension remaps) into SHAPE BUCKETS, with the
     reference's eligibility checks in the reference's order (`_plan_for`);
  2. rows pad up a powers-of-two ladder (rungs 2^i x BATCH_ROW_ALIGN) and
     a bucket splits into power-of-two chunks of at most BATCH_MAX_SEGMENTS
     (`_pow2_chunks`), as the reference bounds its compiles;
  3. each chunk runs as ONE stacked run (`_run_batch`): its K pooled
     blocks, staged at the rung R, stack into [K, R] columns, and
     `grouping.make_stacked_segment_fn` computes the mask, the buckets and
     the keys once over the stack and runs the strategy, selected once for
     the chunk at R rows as the reference does, so that the number of
     device launches does not grow with K where the working set allows;
  4. the states split into one SegmentPartial per segment and pass through
     each kernel's host_post.

Stragglers (ineligible segments, run-domain segments, the remainders of
`_pow2_chunks`) run alone through `run_grouped_aggregate(plan=...)` with the
plan already built: no segment is planned twice. Integer results equal the
per-segment path's exactly; float sums may differ in their last bits (a
batch axis can change a reduction's order), within the port's rule.

Where the reference's batched program is its per-segment body unrolled K
times in one jitted program, eager PyTorch has no such program; the stacked
run is the port's design. What the port builds once per structure (the
run's closure and its device constants) is cached per signature, K, R and
device (`_PROGRAM_CACHE`, capped at 64 like the reference's jit cache).

The mesh's sharded run (parallel/distributed.py) is this module's stacked
run once per shard: it shares the plan-constant check (`plan_constants`,
`constants_equal`), the window rule (`windowed_all`), the stacker
(`stack_blocks`) and the program cache (`stacked_program`).

Switches: `set_enabled` (the process default, on) and the per-query context
{"batchSegments": false}. An exception inside a batched run is raised, never
turned into a per-segment retry.
"""
from __future__ import annotations

import collections
import functools
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from druid_tpu_torch.data import cascade
from druid_tpu_torch.data.segment import DEFAULT_ROW_ALIGN, Segment
from druid_tpu_torch.engine import filters as filters_mod
from druid_tpu_torch.engine import grouping, rundomain
from druid_tpu_torch.engine.contracts import (BATCH_MAX_SEGMENT_ROWS,
                                              BATCH_MAX_SEGMENTS,
                                              BATCH_MIN_SEGMENTS,
                                              BATCH_ROW_ALIGN)
from druid_tpu_torch.engine.filters import ConstNode, interval_offsets
from druid_tpu_torch.engine.grouping import (GroupPlan, GroupSpec, KeyDim,
                                             SegmentPartial,
                                             assemble_stacked_aux, aux_equal,
                                             keydims_equal,
                                             make_stacked_segment_fn,
                                             needed_columns,
                                             plan_grouped_aggregate,
                                             run_grouped_aggregate,
                                             staged_col_dtypes, vc_dtype,
                                             windowed_window)
from druid_tpu_torch.engine.kernels import AggKernel
from druid_tpu_torch.obs import dispatch as dispatch_mod
from druid_tpu_torch.obs.trace import span as trace_span
from druid_tpu_torch.utils.emitter import Monitor
from druid_tpu_torch.utils.granularity import Granularity
from druid_tpu_torch.utils.intervals import Interval

# a rung is a valid row_align for Segment.device_block, so chunk-mates stage
# to exactly R rows
assert BATCH_ROW_ALIGN == DEFAULT_ROW_ALIGN, \
    "contracts.BATCH_ROW_ALIGN must equal data.segment.DEFAULT_ROW_ALIGN"

#: process default (on, as in the reference); per query, the context
#: {"batchSegments": false} opts out
_ENABLED = True
_ENABLED_LOCK = threading.Lock()


def set_enabled(on: bool) -> bool:
    """Flip the process-wide batching default; returns the previous value."""
    global _ENABLED
    with _ENABLED_LOCK:
        prev = _ENABLED
        _ENABLED = bool(on)
        return prev


def enabled() -> bool:
    return _ENABLED


def query_enabled(context: Optional[Dict]) -> bool:
    """Whether batching applies to one query: the process switch and the
    query's {"batchSegments": false} opt-out."""
    if not _ENABLED:
        return False
    return not (context
                and str(context.get("batchSegments", "true")).lower()
                in ("0", "false", "no"))


#: the stacked runs built so far, by signature, K, R and device (LRU)
_PROGRAM_CACHE: "collections.OrderedDict[str, object]" = \
    collections.OrderedDict()
_PROGRAM_CACHE_CAP = 64
_PROGRAM_CACHE_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# Dispatch statistics
# ---------------------------------------------------------------------------

class BatchStats:
    """Counters of the batched runs, and a bounded queue of (segments, fill
    ratio) per run."""

    EVENT_CAP = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self.batches = 0
        self.batched_segments = 0
        self.stacked_rows = 0
        self.stacked_slots = 0          # K x R summed over the runs
        self.fallback_segments = 0
        self.dropped_events = 0         # events lost to the cap
        self._events: "collections.deque[Tuple[int, float]]" = \
            collections.deque(maxlen=self.EVENT_CAP)

    def record_batch(self, n_segments: int, rows: int, slots: int) -> None:
        fill = rows / slots if slots else 0.0
        with self._lock:
            self.batches += 1
            self.batched_segments += n_segments
            self.stacked_rows += rows
            self.stacked_slots += slots
            if len(self._events) == self.EVENT_CAP:
                self.dropped_events += 1
            self._events.append((n_segments, fill))

    def record_fallback(self, n_segments: int) -> None:
        with self._lock:
            self.fallback_segments += n_segments

    def drain_events(self) -> Tuple[List[Tuple[int, float]], int]:
        """(events, events dropped since the last drain)."""
        with self._lock:
            out = list(self._events)
            self._events.clear()
            dropped, self.dropped_events = self.dropped_events, 0
            return out, dropped

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            fill = (self.stacked_rows / self.stacked_slots
                    if self.stacked_slots else 0.0)
            return {"batches": self.batches,
                    "batchedSegments": self.batched_segments,
                    "fallbackSegments": self.fallback_segments,
                    "stackedRows": self.stacked_rows,
                    "stackedSlots": self.stacked_slots,
                    "fillRatio": fill}


_STATS = BatchStats()


def stats() -> BatchStats:
    return _STATS


class BatchMetricsMonitor(Monitor):
    """Emits one query/batch/segments + query/batch/fillRatio pair per
    recorded stacked run (drained at tick, the CacheMonitor discipline)."""

    def __init__(self, source: Optional[BatchStats] = None):
        self.source = source or _STATS

    def do_monitor(self, emitter):
        events, dropped = self.source.drain_events()
        for n_segments, fill in events:
            emitter.metric("query/batch/segments", n_segments)
            emitter.metric("query/batch/fillRatio", fill)
        if dropped:
            emitter.metric("query/batch/droppedEvents", dropped)


# ---------------------------------------------------------------------------
# Planning and eligibility
# ---------------------------------------------------------------------------

def row_rung(n_rows: int) -> int:
    """The ladder rung of a segment: the least 2^i x BATCH_ROW_ALIGN that
    holds n_rows."""
    blocks = -(-max(n_rows, 1) // BATCH_ROW_ALIGN)
    return BATCH_ROW_ALIGN * (1 << (blocks - 1).bit_length())


@dataclass
class _Plan:
    """One segment's plan for one query, the unit of bucketing: the
    GroupPlan (a straggler runs through it, not planned again) with the
    batching-only derivations. It carries its own query's intervals,
    granularity and virtual columns, since a chunk may mix plans of several
    queries; `req` names the query."""
    segment: Segment
    kds: Tuple[KeyDim, ...]
    index: int                       # position in the query's segment list
    gplan: GroupPlan
    intervals: Tuple[Interval, ...] = ()
    granularity: Granularity = None
    virtual_columns: Tuple = ()
    req: int = 0
    #: False = straggler (runs alone, through this gplan)
    eligible: bool = False
    consts: Tuple = ()               # plan_constants(gplan)
    columns: Tuple[str, ...] = ()
    col_dtypes: Dict[str, np.dtype] = None
    rung: int = 0
    packs: Tuple = ()
    cascades: Tuple = ()
    digest: Tuple = None             # hashable bucket prefilter

    @property
    def spec(self) -> GroupSpec:
        return self.gplan.spec

    @property
    def filter_node(self):
        return self.gplan.filter_node

    @property
    def kernels(self) -> List[AggKernel]:
        return self.gplan.kernels

    @property
    def vc_plans(self) -> Tuple:
        return self.gplan.vc_plans

    @property
    def vc_luts(self) -> List[np.ndarray]:
        return self.gplan.vc_luts


def plan_constants(gplan: GroupPlan) -> Tuple[List[np.ndarray], ...]:
    """The array constants one stacked run shares over its segments, in
    the reference's order: the filter's tables, the kernels' tables, the
    virtual columns' LUTs."""
    f_aux = gplan.filter_node.aux_arrays() if gplan.filter_node else []
    k_aux = [a for k in gplan.kernels for a in k.aux_arrays()]
    return (f_aux, k_aux, gplan.vc_luts)


def constants_equal(a: Tuple, b: Tuple) -> bool:
    """Two plans' `plan_constants` equal (dtypes, shapes and values)."""
    return all(aux_equal(x, y) for x, y in zip(a, b))


def _plan_for(segment: Segment, kds: Sequence[KeyDim], index: int,
              intervals: Sequence[Interval], granularity: Granularity,
              aggs: Sequence, flt, virtual_columns: Sequence) -> _Plan:
    """Plan one segment; the reference's eligibility checks, in its order,
    decide whether the plan can join a bucket. The pack and cascade
    descriptors join the digest as in the reference (the batched blocks
    stage dense, since no batched strategy reads words, but the buckets
    stay the reference's)."""
    kds = tuple(kds)
    gplan = plan_grouped_aggregate(segment, intervals, granularity, kds,
                                   aggs, flt, virtual_columns)
    plan = _Plan(segment=segment, kds=kds, index=index, gplan=gplan,
                 intervals=tuple(intervals), granularity=granularity,
                 virtual_columns=tuple(virtual_columns))
    if segment.n_rows > BATCH_MAX_SEGMENT_ROWS:
        return plan
    if rundomain.run_domain_probe(segment, intervals, granularity,
                                  gplan.spec, gplan.kernels, flt,
                                  virtual_columns):
        # run space serves it alone, without staging a row
        return plan
    if any(d.host_ids is not None and d.ids_key is None for d in kds):
        return plan
    spec, filter_node, kernels = gplan.spec, gplan.filter_node, gplan.kernels
    if spec.key_mode != "dense" or spec.bucket_mode not in ("all", "uniform"):
        return plan
    if spec.num_total > grouping.BLOCKED_GROUP_LIMIT:
        # above it the selection reads per-segment row clustering
        # (windowed, projection), which chunk-mates need not share
        return plan
    if isinstance(filter_node, ConstNode) and not filter_node.value:
        return plan                  # runs without the device at all
    _, columns = needed_columns(segment, kds, aggs, flt, virtual_columns,
                                filter_node=filter_node, kernels=kernels,
                                vc_plans=gplan.vc_plans)
    # a complex column's width is a stacking shape, so it joins the digest
    col_shapes = tuple(sorted(
        (c, np.asarray(segment.metrics[c].values).shape[1:])
        for c in columns if c in segment.metrics
        and np.asarray(segment.metrics[c].values).ndim > 1))
    plan.eligible = True
    plan.consts = plan_constants(gplan)
    plan.columns = columns
    plan.col_dtypes = staged_col_dtypes(segment, spec, columns)
    plan.rung = row_rung(segment.n_rows)
    plan.cascades, plan.packs = cascade.plan_pair(segment, columns)
    sig = grouping._structure_sig(spec, len(intervals), filter_node, kernels,
                                  gplan.vc_plans, plan.packs, plan.cascades)
    # granularity and bucket count join for cross-query chunks: the stacked
    # run shares one period and bucket count
    plan.digest = (sig, plan.rung, columns, col_shapes,
                   tuple(sorted((c, str(d))
                                for c, d in plan.col_dtypes.items())),
                   str(granularity), spec.num_buckets)
    return plan


def _compatible(ref: _Plan, cand: _Plan) -> bool:
    """Digest-equal plans still carry array constants (filter LUTs, kernel
    tables, remaps, virtual-column LUTs) that the stacked run shares: they
    must be equal."""
    return (keydims_equal(ref.kds, cand.kds)
            and constants_equal(ref.consts, cand.consts))


def _shape_buckets(plans: Sequence[_Plan]) -> List[List[_Plan]]:
    """Plans grouped into buckets: by digest, then by equal constants."""
    by_digest: Dict[Tuple, List[List[_Plan]]] = {}
    for p in plans:
        groups = by_digest.setdefault(p.digest, [])
        for g in groups:
            if _compatible(g[0], p):
                g.append(p)
                break
        else:
            groups.append([p])
    return [g for groups in by_digest.values() for g in groups]


def _pow2_chunks(group: List[_Plan]) -> Tuple[List[List[_Plan]], List[_Plan]]:
    """A bucket split into power-of-two chunks of at most BATCH_MAX_SEGMENTS
    (13 -> 8 + 4 and a straggler of 1). Returns (chunks, remainder)."""
    out: List[List[_Plan]] = []
    i, n = 0, len(group)
    while n - i >= BATCH_MIN_SEGMENTS:
        size = min(BATCH_MAX_SEGMENTS, 1 << ((n - i).bit_length() - 1))
        out.append(group[i:i + size])
        i += size
    return out, group[i:]


# ---------------------------------------------------------------------------
# The stacked run
# ---------------------------------------------------------------------------

def _build_stacked_fn(spec: GroupSpec, vc_plans: Tuple, K: int,
                      device: torch.device):
    """What the port builds once per (structure, K, R, device)."""
    return make_stacked_segment_fn(spec, vc_plans, K, device)


def stacked_program(structure: str, spec: GroupSpec, vc_plans: Tuple,
                    K: int, R: int, device: torch.device):
    """(the stacked run of `structure` over K segments of R rows on
    `device`, whether it was built now): built once, then served from the
    LRU `_PROGRAM_CACHE`. The batched chunks and the mesh's shards share
    it."""
    sig = f"{structure}|K={K}|R={R}|dev={device}"
    with _PROGRAM_CACHE_LOCK:
        fn = _PROGRAM_CACHE.get(sig)
        if fn is not None:
            _PROGRAM_CACHE.move_to_end(sig)
            return fn, False
        fn = _build_stacked_fn(spec, vc_plans, K, device)
        _PROGRAM_CACHE[sig] = fn
        while len(_PROGRAM_CACHE) > _PROGRAM_CACHE_CAP:
            _PROGRAM_CACHE.popitem(last=False)
        return fn, True


def clear_program_cache() -> int:
    """Drop the built stacked runs; returns how many there were."""
    with _PROGRAM_CACHE_LOCK:
        n = len(_PROGRAM_CACHE)
        _PROGRAM_CACHE.clear()
        return n


def windowed_all(items: Sequence[Tuple]) -> int:
    """The window one stacked run shares over its (segment, intervals,
    granularity, spec) items: the largest of theirs, or 0 where one has
    none (select_strategy calls it only when it weighs windowed)."""
    w_all = 0
    for segment, intervals, granularity, spec in items:
        w = windowed_window(segment, intervals, granularity, spec)
        if not w:
            return 0
        w_all = max(w_all, w)
    return w_all


def stack_blocks(items: Sequence[Tuple], columns: Sequence[str], R: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: [K, R, ...]} on `device` for K (segment, kds, filter_node,
    kernels) items, stacked from the pool's staged blocks: each segment's
    block of `columns` at R rows (a segment whose own padding is R shares
    the block the per-segment path stages), the id columns of numeric
    dimensions, and each item's own bitmap words (items may carry
    different filters under one structure), staged in one wave."""
    slots = []
    for segment, kds, _, _ in items:
        align = DEFAULT_ROW_ALIGN if segment.padded_rows() == R else R
        block = segment.device_block(list(columns), device, row_align=align)
        assert block.padded_rows == R, \
            "every stacked block must stage exactly R rows"
        arrs = dict(block.arrays)
        for d in kds:
            if d.host_ids is not None:
                arrs[d.column] = grouping._pad_device(
                    segment, d.ids_key, d.host_ids, R, 0, device)
        slots.append(arrs)
    words = filters_mod.stage_device_bitmaps_multi(
        [(segment, f, k) for segment, _, f, k in items], R, device)
    for arrs, w in zip(slots, words):
        arrs.update(w)
    return {name: torch.stack([s[name] for s in slots]) for name in slots[0]}


def _to_host(state):
    if isinstance(state, tuple):
        return tuple(_to_host(s) for s in state)
    return state.cpu()


def _slot(state, i: int):
    if isinstance(state, tuple):
        return tuple(_slot(s, i) for s in state)
    return state[i]


def _run_batch(chunk: List[_Plan], device: torch.device
               ) -> Optional[List[SegmentPartial]]:
    """Run one chunk as one stacked run; None when the chunk selects the
    sorted projection (a per-segment layout a stack cannot share), and its
    segments then run alone. The strategy is selected once, at the rung's
    R rows, as the reference does; every per-query origin (interval
    bounds, first bucket) comes from each plan's own query."""
    ref = chunk[0]
    R = ref.rung
    K = len(chunk)                  # a power of two (_pow2_chunks)

    vc_dtypes = {v.name: vc_dtype(v.output_type)
                 for v in ref.virtual_columns}
    strategy, window = grouping.select_strategy(
        ref.spec, ref.kernels, ref.col_dtypes, R,
        functools.partial(windowed_all, [
            (p.segment, p.intervals, p.granularity, p.spec) for p in chunk]),
        vc_dtypes)
    if strategy == "projection":
        return None
    for p in chunk:
        p.spec.strategy, p.spec.window = strategy, window

    arrays = stack_blocks(
        [(p.segment, p.kds, p.filter_node, p.kernels) for p in chunk],
        ref.columns, R, device)

    time0s = torch.tensor([p.segment.interval.start for p in chunk],
                          dtype=torch.int64, device=device)
    iv_rel = torch.from_numpy(np.stack([
        interval_offsets(p.intervals, p.segment.interval.start)
        for p in chunk])).to(device)
    bucket_off = torch.tensor(
        [p.spec.uniform_first_offset if p.spec.bucket_mode == "uniform"
         else 0 for p in chunk], dtype=torch.int64, device=device)
    aux = assemble_stacked_aux(ref.spec, ref.kds, ref.filter_node,
                               ref.kernels, ref.granularity, ref.vc_luts)
    fn, _ = stacked_program(
        grouping._structure_sig(ref.spec, len(ref.intervals),
                                ref.filter_node, ref.kernels, ref.vc_plans,
                                ref.packs, ref.cascades),
        ref.spec, ref.vc_plans, K, R, device)

    with trace_span("engine/batch/dispatch", segments=K, rows=R):
        counts, states = fn(arrays, time0s, iv_rel, bucket_off, aux)
        counts_h = counts.cpu().numpy().astype(np.int64)
    dispatch_mod.record("batched")
    states_h = [_to_host(st) for st in states]
    out: List[SegmentPartial] = []
    for i, p in enumerate(chunk):
        out.append(SegmentPartial(
            segment=p.segment, spec=p.spec, counts=counts_h[i],
            states={k.name: k.host_post(_slot(st, i), p.segment)
                    for k, st in zip(p.kernels, states_h)},
            kernels=p.kernels))
    _STATS.record_batch(K, sum(p.segment.n_rows for p in chunk), K * R)
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def run_with_batching(segs: Sequence[Segment], intervals: Sequence[Interval],
                      granularity: Granularity,
                      kds_per_seg: Sequence[Sequence[KeyDim]],
                      aggs: Sequence, flt, device: torch.device,
                      virtual_columns: Sequence = (),
                      context: Optional[Dict] = None,
                      check=None) -> Optional[List[SegmentPartial]]:
    """One SegmentPartial per segment (in `segs`' order): a stacked run for
    each chunk of a bucket of at least BATCH_MIN_SEGMENTS segments, and the
    per-segment path, through the plan already built, for the rest. None
    when batching is off for the query or there are fewer than
    BATCH_MIN_SEGMENTS segments (the caller runs each segment alone).
    `check` (a cancel or timeout probe) runs between runs."""
    if not query_enabled(context) or len(segs) < BATCH_MIN_SEGMENTS:
        return None
    plans = [_plan_for(s, kds, i, intervals, granularity, aggs, flt,
                       virtual_columns)
             for i, (s, kds) in enumerate(zip(segs, kds_per_seg))]
    buckets = _shape_buckets([p for p in plans if p.eligible])
    if not any(len(b) >= BATCH_MIN_SEGMENTS for b in buckets):
        # nothing batches; the plans run alone, not planned again
        return [_run_straggler(p, aggs, flt, device, check, first=(i == 0))
                for i, p in enumerate(plans)]

    results: List[Optional[SegmentPartial]] = [None] * len(segs)
    dispatched = 0
    for bucket in buckets:
        if len(bucket) < BATCH_MIN_SEGMENTS:
            continue
        chunks, _remainder = _pow2_chunks(bucket)
        for chunk in chunks:
            if check is not None and dispatched:
                check()
            partials = _run_batch(chunk, device)
            if partials is None:
                continue
            dispatched += 1
            for p, partial in zip(chunk, partials):
                results[p.index] = partial

    n_fallback = sum(1 for r in results if r is None)
    if dispatched and n_fallback:
        _STATS.record_fallback(n_fallback)
    for i, p in enumerate(plans):
        if results[i] is None:
            results[i] = _run_straggler(p, aggs, flt, device, check,
                                        first=not dispatched and i == 0)
    return results


def _run_straggler(p: _Plan, aggs, flt, device: torch.device, check,
                   first: bool) -> SegmentPartial:
    """One segment alone, through the plan built for bucketing."""
    if check is not None and not first:
        check()
    return run_grouped_aggregate(
        p.segment, p.intervals, p.granularity, p.kds, aggs, flt, device,
        virtual_columns=p.virtual_columns, plan=p.gplan)


@dataclass
class BatchWork:
    """One query's segment work for run_multi_with_batching: the arguments
    run_with_batching takes."""
    segs: Sequence[Segment]
    intervals: Sequence[Interval]
    granularity: Granularity
    kds_per_seg: Sequence[Sequence[KeyDim]]
    aggs: Sequence
    flt: object = None
    virtual_columns: Sequence = ()
    context: Optional[Dict] = None
    check: Optional[object] = None   # cancel or timeout probe of the query


def run_multi_with_batching(work: Sequence[BatchWork], device: torch.device,
                            on_batch=None) -> List[object]:
    """Several queries at once: every query's segments are planned, the
    plans are bucketed across queries (the digest holds what two runs must
    share, granularity and bucket count included), each chunk runs as one
    stacked run, and the partials split back by each plan's `req`.

    Returns one entry per query: its List[SegmentPartial] (in its `segs`'
    order), or the exception its `check` raised; one cancelled query does
    not fail its chunk-mates. A chunk's strategy is a function of
    constants its plans share, so a plan computes the same partial in a
    shared chunk as in its own query's. `on_batch(n_queries, n_segments,
    fill_ratio)` fires per stacked run."""
    all_plans: List[List[_Plan]] = []
    for r, w in enumerate(work):
        opted_out = not query_enabled(w.context)
        plans = []
        for i, (s, kds) in enumerate(zip(w.segs, w.kds_per_seg)):
            p = _plan_for(s, kds, i, w.intervals, w.granularity, w.aggs,
                          w.flt, w.virtual_columns)
            p.req = r
            if opted_out:
                p.eligible = False
            plans.append(p)
        all_plans.append(plans)
    buckets = _shape_buckets([p for plans in all_plans
                              for p in plans if p.eligible])

    results: List[List[Optional[SegmentPartial]]] = \
        [[None] * len(plans) for plans in all_plans]
    dead: Dict[int, BaseException] = {}

    def _poll_checks():
        for r, w in enumerate(work):
            if r in dead or w.check is None:
                continue
            try:
                w.check()
            except Exception as e:
                dead[r] = e

    dispatched = 0
    for bucket in buckets:
        if len(bucket) < BATCH_MIN_SEGMENTS:
            continue
        chunks, _remainder = _pow2_chunks(bucket)
        for chunk in chunks:
            if dispatched:
                _poll_checks()
            live = [p for p in chunk if p.req not in dead]
            if len(live) < len(chunk):
                # a cancelled mate broke the power-of-two size: the
                # survivors run alone
                continue
            partials = _run_batch(live, device)
            if partials is None:
                continue
            dispatched += 1
            if on_batch is not None:
                slots = len(live) * live[0].rung
                rows = sum(p.segment.n_rows for p in live)
                on_batch(len({p.req for p in live}), len(live),
                         rows / slots if slots else 0.0)
            for p, partial in zip(live, partials):
                results[p.req][p.index] = partial

    _poll_checks()
    out: List[object] = []
    for r, (w, plans) in enumerate(zip(work, all_plans)):
        if r in dead:
            out.append(dead[r])
            continue
        res = results[r]
        n_fallback = sum(1 for x in res if x is None)
        if dispatched and n_fallback:
            _STATS.record_fallback(n_fallback)
        try:
            for i, p in enumerate(plans):
                if res[i] is None:
                    res[i] = _run_straggler(p, w.aggs, w.flt, device,
                                            w.check,
                                            first=not dispatched and i == 0)
        except Exception as e:
            # the query's own check (or its own run) failed: that query's
            # result is the exception, its neighbours go on
            out.append(e)
            continue
        out.append(res)
    return out
