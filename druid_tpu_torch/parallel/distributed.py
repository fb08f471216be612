"""Sharded multi-segment execution: one stacked run per shard of a mesh, the
partial states merged on the card.

The port's counterpart of the reference package's `parallel/distributed.py`
(`try_sharded`), in the port's idiom:
  * the reference vmaps its per-segment body over a [K, ...] stack inside
    one shard_map program; here each shard of the mesh runs the batched
    path's stacked run (engine/batching.py: `stacked_program`, one cache
    for both) over its contiguous block of K / n segments on its own
    device. The shards are launched one after another with no host sync
    between them, so on several cards they overlap;
  * the reference merges the per-segment states with psum / pmin / pmax /
    all_gather + fold; here each shard first folds its K / n states on its
    device (`_merge_local`), then every shard's state moves to the mesh's
    first device and the states combine in shard order through each
    kernel's `device_combine` (`_merge_shards`): sum, max, min, or the
    kernel's own fold. Integer sums and counts widen to int64 before any
    fold, and a bool state ORs;
  * only `host_from_device` runs on the host: it converts the one merged
    state to the host form, as host_post does per segment. The broker-side
    host merge over segments is gone for this path.

Eligibility is the reference's, check for check (else the caller runs the
batched and per-segment paths and merges on the host): key dimensions that
are dictionary columns (not numeric dimensions' query-time ids) with EQUAL
dictionaries across segments, dense keys, bucketing "all" or "uniform",
the same structure and plan constants (batching's `plan_constants`) on
every segment, and every needed column with the same presence, kind and
dtype (2-D metric columns refuse). The strategy is selected once for the
stack, through `grouping.select_strategy` (so a test forcing a strategy
steers the mesh too); the sorted projection, a per-segment layout, becomes
"mixed", so neither B1 nor B2 runs here.

The stack (`_stack_segments`): R is the segments' largest padding (a
multiple of 1024) and K pads to a multiple of the mesh size with
all-invalid segments; each shard's block stacks on its device from the
pool's staged blocks and filter words (batching's `stack_blocks`). The
stack itself lives in the process-wide device pool under the stack owner,
counted against the pool's budget (PoolStats.stacked_*), keyed by segment
identity, the mesh's devices, the columns and the filter words' digest;
`clear_stack_cache` drops it. It is a copy beside the blocks it came from,
as the reference's stack is: the stacked run reads one [K / n, R] tensor
per column, and the pool's blocks are separate tensors.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import threading
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from druid_tpu_torch.data import devicepool
from druid_tpu_torch.data.segment import Segment
from druid_tpu_torch.engine import batching
from druid_tpu_torch.engine import filters as filters_mod
from druid_tpu_torch.engine import grouping
from druid_tpu_torch.engine.filters import ConstNode, interval_offsets
from druid_tpu_torch.engine.grouping import (GroupPlan, KeyDim,
                                             SegmentPartial,
                                             assemble_stacked_aux,
                                             keydims_equal, needed_columns,
                                             plan_grouped_aggregate,
                                             staged_col_dtypes, vc_dtype)
from druid_tpu_torch.engine.kernels import AggKernel
from druid_tpu_torch.obs import dispatch as dispatch_mod
from druid_tpu_torch.obs.trace import span as trace_span
from druid_tpu_torch.parallel import context, speclayout
from druid_tpu_torch.utils.emitter import Monitor
from druid_tpu_torch.utils.granularity import Granularity
from druid_tpu_torch.utils.intervals import Interval

# Guards the stack owner's registration against concurrent queries.
_CACHE_LOCK = threading.Lock()


class _StackOwner:
    """The anchor owning the stacked entries in the device pool; it lives
    with the module, so its entries leave only by LRU pressure or
    clear_stack_cache()."""


_STACK_ANCHOR: Optional[_StackOwner] = None
_STACK_TOKEN: Optional[int] = None
_STACK_POOL: Optional["weakref.ref"] = None


def _stack_owner_token(pool: "devicepool.DeviceSegmentPool") -> int:
    """Register the stack owner on `pool` when needed: after
    clear_stack_cache() (a purge removes the owner's slot, and the pool
    would refuse its inserts), or when the process pool was swapped (tests
    install isolated pools), whose old stacked entries are purged first, so
    there is at most one live stack owner."""
    global _STACK_ANCHOR, _STACK_TOKEN, _STACK_POOL
    with _CACHE_LOCK:
        prev = _STACK_POOL() if _STACK_POOL is not None else None
        if _STACK_TOKEN is None or prev is not pool:
            if prev is not None and _STACK_TOKEN is not None:
                # _CACHE_LOCK, then the pool's lock: the pool never takes
                # _CACHE_LOCK
                prev.purge_owner(_STACK_TOKEN)
            _STACK_ANCHOR = _StackOwner()
            _STACK_TOKEN = pool.register_owner(_STACK_ANCHOR)
            _STACK_POOL = weakref.ref(pool)
        return _STACK_TOKEN


def _same_dictionaries(segments: Sequence[Segment],
                       kds: Sequence[KeyDim]) -> bool:
    """Raw key dimensions fuse dictionary ids directly, so the
    dictionaries themselves must agree (equal cardinality is not enough:
    ids would decode through the first segment's values)."""
    for d in kds:
        if d.column is None:
            continue
        first = segments[0].dims[d.column].dictionary
        for s in segments[1:]:
            other = s.dims.get(d.column)
            if other is None:
                return False
            if other.dictionary is not first and \
                    list(other.dictionary.values) != list(first.values):
                return False
    return True


def _same_plans(plans: Sequence[GroupPlan], n_intervals: int) -> bool:
    """Every segment planned the structure (filter, kernels, virtual
    columns) and the plan constants of the first."""
    def structure(p):
        return grouping._structure_sig(p.spec, n_intervals, p.filter_node,
                                       p.kernels, p.vc_plans)
    sig0 = structure(plans[0])
    consts0 = batching.plan_constants(plans[0])
    return all(structure(p) == sig0 and batching.constants_equal(
        batching.plan_constants(p), consts0) for p in plans[1:])


def _same_columns(segments: Sequence[Segment], needed) -> bool:
    """Every needed column has the same presence, kind and dtype in every
    segment; a 2-D (complex) metric refuses, since the stack is [K, R]."""
    def desc(s):
        out = []
        for c in sorted(needed):
            met = s.metrics.get(c)
            if met is not None and np.asarray(met.values).ndim != 1:
                return None
            out.append((c, c in s.dims, None if met is None else
                        (met.type, met.values.dtype, s.staged_dtype(c))))
        return out
    d0 = desc(segments[0])
    return d0 is not None and all(desc(s) == d0 for s in segments[1:])


def try_sharded(segments: Sequence[Segment], intervals: Sequence[Interval],
                granularity: Granularity,
                kds_per_seg: Sequence[Sequence[KeyDim]],
                aggs: Sequence, flt,
                virtual_columns: Sequence = ()) -> Optional[SegmentPartial]:
    """The grouped aggregate of every segment as one sharded run over the
    active mesh: one merged SegmentPartial, or None when there is no mesh
    or the segments are ineligible (the caller then runs the other
    paths)."""
    mesh = context.get_mesh()
    if mesh is None or not segments:
        return None

    kds = list(kds_per_seg[0])
    if any(d.host_ids is not None for d in kds):
        # a numeric dimension's ids are a per-segment query-time
        # dictionary: one stacked run cannot share their id space
        return None
    if not all(keydims_equal(kds, other) for other in kds_per_seg[1:]):
        return None
    if not _same_dictionaries(segments, kds):
        return None

    plan0 = plan_grouped_aggregate(segments[0], intervals, granularity, kds,
                                   aggs, flt, virtual_columns)
    spec0 = plan0.spec
    if spec0.key_mode != "dense" \
            or spec0.bucket_mode not in ("all", "uniform"):
        return None
    plans = [plan0] + [plan_grouped_aggregate(s, intervals, granularity,
                                              kds, aggs, flt,
                                              virtual_columns)
                       for s in segments[1:]]
    if not _same_plans(plans, len(intervals)):
        return None
    filter_node, kernels = plan0.filter_node, plan0.kernels
    # only once every segment agreed is a constant-false filter a whole-
    # query zero (a column may exist in some segments only)
    if isinstance(filter_node, ConstNode) and not filter_node.value:
        return SegmentPartial(
            segment=segments[0], spec=spec0,
            counts=np.zeros(spec0.num_total, dtype=np.int64),
            states={k.name: k.empty_state(spec0.num_total) for k in kernels},
            kernels=kernels)

    needed, columns = needed_columns(segments[0], kds, aggs, flt,
                                     virtual_columns,
                                     filter_node=filter_node,
                                     kernels=kernels,
                                     vc_plans=plan0.vc_plans)
    if not _same_columns(segments, needed):
        return None

    shards, time0s, R, K = _stack_segments(mesh, segments, columns, plans)

    # through the module, so that a test forcing a strategy (patching
    # grouping.select_strategy) steers the mesh too
    spec0.strategy, spec0.window = grouping.select_strategy(
        spec0, kernels, staged_col_dtypes(segments[0], spec0, columns), R,
        functools.partial(batching.windowed_all, [
            (s, intervals, granularity, spec0) for s in segments]),
        {v.name: vc_dtype(v.output_type) for v in virtual_columns})
    if spec0.strategy == "projection":
        # the sorted projection is a per-segment layout a stack cannot
        # share: the stacked run scatters ("mixed"), and the projection
        # stays the meshless path's
        spec0.strategy, spec0.window = "mixed", 0

    iv_rel = np.zeros((K, max(len(intervals), 1), 2), dtype=np.int32)
    bucket_off = np.zeros((K,), dtype=np.int64)
    for i, s in enumerate(segments):
        t0 = s.interval.start
        iv_rel[i, :len(intervals)] = interval_offsets(intervals, t0)
        if spec0.bucket_mode == "uniform":
            bucket_off[i] = int(spec0.bucket_starts[0]) - t0
    iv_rel = speclayout.split(mesh, iv_rel)
    bucket_off = speclayout.split(mesh, bucket_off)
    aux = assemble_stacked_aux(spec0, kds, filter_node, kernels, granularity,
                               plan0.vc_luts)

    structure = grouping._structure_sig(spec0, len(intervals), filter_node,
                                        kernels, plan0.vc_plans)
    fns = [batching.stacked_program(structure, spec0, plan0.vc_plans,
                                    K // mesh.size, R, dev)
           for dev in mesh.devices]
    with trace_span("engine/sharded/dispatch", segments=K,
                    devices=mesh.size, compile=any(b for _, b in fns)):
        per_shard = []
        for (fn, _), arrays, t0s, ivr, boff, dev in zip(
                fns, shards, time0s, iv_rel, bucket_off, mesh.devices):
            with _on_device(dev):
                # a copy: the run adds its virtual columns to the dict
                counts, states = fn(dict(arrays), t0s, ivr, boff, aux)
                states = [k.device_post(st, t0s[:, None])
                          for k, st in zip(kernels, states)]
                per_shard.append((
                    counts.sum(0),
                    [_merge_local(k, st) for k, st in zip(kernels, states)]))
        counts, states = _merge_shards(kernels, per_shard, mesh.devices[0])
        counts = counts.cpu().numpy()
    dispatch_mod.record("sharded")
    _SHARDED_STATS.record(len(segments))
    # not a host merge: the states were merged on the card; this converts
    # the merged device form to the host form
    host_states = {k.name: k.host_from_device(st)
                   for k, st in zip(kernels, states)}
    return SegmentPartial(segment=segments[0], spec=spec0, counts=counts,
                          states=host_states, kernels=kernels)


def _on_device(dev: torch.device):
    """The CUDA device context of a shard's launches (a no-op on the
    CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# The stack
# ---------------------------------------------------------------------------

def _bitmap_digest(plans: Sequence[GroupPlan]) -> str:
    """Digest of every segment's bitmap nodes for the stack's pool key: the
    filter words are per-segment data, so two plans that differ only in
    which ids a leaf matches must stack under different keys."""
    h = hashlib.sha1()
    any_nodes = False
    for p in plans:
        for node in filters_mod.item_bitmap_nodes(p.filter_node, p.kernels):
            any_nodes = True
            h.update(node.col.encode())
            h.update(b"|")
            h.update(node.structure_sig().encode())
            h.update(b"|")
            h.update(node.digest().encode())
        h.update(b"||")
    return h.hexdigest()[:16] if any_nodes else ""


def _stack_segments(mesh, segments: Sequence[Segment],
                    columns: Tuple[str, ...], plans: Sequence[GroupPlan]):
    """(per-shard {name: [K / n, R]} stacks, per-shard time0s, R, K),
    pooled. Keyed by segment identity, not id strings: a rebuilt segment
    may reuse its id and must not be served stale rows; the entry pins the
    segment objects, so their id()s cannot be recycled while it lives."""
    pool = devicepool.device_pool()
    key = (devicepool.STACKED_KIND, tuple(id(s) for s in segments), columns,
           speclayout.layout_sig(mesh), _bitmap_digest(plans))
    value = pool.get_or_build(
        _stack_owner_token(pool), key,
        lambda: _build_stack(mesh, segments, columns, plans))
    return value[:4]


def _build_stack(mesh, segments: Sequence[Segment],
                 columns: Tuple[str, ...], plans: Sequence[GroupPlan]):
    R = max(s.padded_rows() for s in segments)
    K = -(-len(segments) // mesh.size) * mesh.size
    items = [(s, (), p.filter_node, p.kernels)
             for s, p in zip(segments, plans)]
    slices = speclayout.shard_slices(K, mesh.size)
    shards = [batching.stack_blocks(items[sl], columns, R, dev)
              if items[sl] else None
              for sl, dev in zip(slices, mesh.devices)]
    # padding segments (the tail of K) are zeros: no row is valid, and
    # their filter words pass none
    for i, (sl, dev) in enumerate(zip(slices, mesh.devices)):
        n_pad = (sl.stop - sl.start) - len(items[sl])
        if n_pad:
            shards[i] = {name: torch.cat(
                ([shards[i][name]] if shards[i] is not None else [])
                + [torch.zeros((n_pad,) + tuple(t.shape[1:]), dtype=t.dtype,
                               device=dev)])
                for name, t in shards[0].items()}
    time0s = np.zeros((K,), dtype=np.int64)
    time0s[:len(segments)] = [s.interval.start for s in segments]
    # the trailing segment tuple pins the objects (the id() guard); it
    # counts 0 in the pool's bytes
    return (shards, speclayout.split(mesh, time0s), R, K, tuple(segments))


def clear_stack_cache() -> int:
    """Drop the stacked segment sets from the device pool (and the segment
    objects each entry pins); returns the entries dropped.
    engine.release_device_caches() is the public surface."""
    global _STACK_TOKEN, _STACK_POOL
    with _CACHE_LOCK:
        token, _STACK_TOKEN = _STACK_TOKEN, None
        pool = _STACK_POOL() if _STACK_POOL is not None else None
        _STACK_POOL = None
    if token is None or pool is None:
        return 0
    n = pool.snapshot().stacked_entries
    pool.purge_owner(token)
    return n


# ---------------------------------------------------------------------------
# The merge
# ---------------------------------------------------------------------------

def _tree_map(fn, *states):
    """`fn` over the tensors of one or more states of one shape (a tensor,
    or a tuple of them)."""
    if isinstance(states[0], tuple):
        return tuple(_tree_map(fn, *leaves) for leaves in zip(*states))
    return fn(*states)


def _reduce_stack(kind: str, x: torch.Tensor) -> torch.Tensor:
    """One leaf of K stacked states [K, ...] reduced over its K."""
    if x.dtype == torch.bool:
        return x.all(0) if kind == "min" else x.any(0)
    if kind == "sum":
        if not x.dtype.is_floating_point:
            # exactness: integer sums and counts in int64 before any fold
            x = x.to(torch.int64)
        return x.sum(0)
    return x.amax(0) if kind == "max" else x.amin(0)


def _merge_local(kernel: AggKernel, stacked):
    """A shard's K / n per-segment states (leading axis) folded into one,
    on its device."""
    kind = kernel.reduce_kind
    if kind != "fold":
        return _tree_map(functools.partial(_reduce_stack, kind), stacked)
    n = (stacked[0] if isinstance(stacked, tuple) else stacked).shape[0]
    parts = [_tree_map(lambda x, i=i: x[i], stacked) for i in range(n)]
    return functools.reduce(kernel.device_combine, parts)


def _merge_shards(kernels: Sequence[AggKernel], per_shard: List,
                  first: torch.device):
    """Every shard's (counts, states) moved to the mesh's first device and
    combined in shard order, each kernel's through its device_combine."""
    def to_first(state):
        return _tree_map(lambda x: x.to(first), state)
    counts = functools.reduce(
        torch.add, [to_first(c) for c, _ in per_shard])
    states = [functools.reduce(k.device_combine,
                               [to_first(st[i]) for _, st in per_shard])
              for i, k in enumerate(kernels)]
    return counts, states


# ---------------------------------------------------------------------------
# Observability: query/sharded/*
# ---------------------------------------------------------------------------

class ShardedStats:
    """merged_device = sharded dispatches, every one merged on the card
    (the counter exists so that its constancy can be asserted); segments =
    the segments those dispatches covered."""

    def __init__(self):
        self._lock = threading.Lock()
        self.merged_device = 0
        self.segments = 0

    def record(self, n_segments: int) -> None:
        with self._lock:
            self.merged_device += 1
            self.segments += n_segments

    def snapshot(self) -> Tuple[int, int]:
        with self._lock:
            return (self.merged_device, self.segments)


_SHARDED_STATS = ShardedStats()


def sharded_stats() -> ShardedStats:
    """The process-wide sharded-dispatch stats (tests, ShardedMonitor)."""
    return _SHARDED_STATS


class ShardedMonitor(Monitor):
    """Emits `query/sharded/*` per tick: the dispatches merged on the card
    over the tick window, and the stacked blocks' residency from the
    device pool's stacked accounting. The catalog's
    `query/sharded/packedRatio` is not emitted: the port's stack stages
    dense, so it would always read 1.0."""

    def __init__(self, stats: Optional[ShardedStats] = None,
                 pool: Optional["devicepool.DeviceSegmentPool"] = None):
        self.stats = stats or sharded_stats()
        self.pool = pool or devicepool.device_pool()
        self._last = (0, 0)

    def do_monitor(self, emitter) -> None:
        s = self.stats.snapshot()
        last, self._last = self._last, s
        emitter.metric("query/sharded/mergeDevice", s[0] - last[0])
        p = self.pool.snapshot()
        emitter.metric("query/sharded/stackBytes", p.stacked_bytes)
