"""Code-domain aggregation: one segment's grouped aggregate over run tables.

The port's counterpart of the reference's run-domain path in
`druid_tpu/data/cascade.py` (`_RunKernel`, `_run_filter_ok`,
`_plan_run_kernel`, `_plan_run_domain`, `_joint_runs`, `_values_at_starts`,
`_run_update`, `_build_run_fn`, `try_run_domain`). When every column a query
reads (group dimensions, filter columns, aggregated columns) is constant
within one shared run partition of the segment, the joint change points of
those columns and, at a uniform granularity, of the time bucket, the whole
aggregate runs over the partition's runs instead of its rows: a run counts
its length, a LONG sum adds value x length in int64 (exact, and wrapping as
the row sums wrap), a min/max reads the run's value. No row-width column
stages and nothing decodes; the run tables (at most CASCADE_MAX_RUNS runs)
are cached on the segment. Float sums, whose bits follow the summation
order, never run here, so the results equal the row program's bit for bit.

`run_grouped_aggregate` tries this first for every segment; the plan refuses
(None) virtual columns, a dimension with derived host ids (numeric and
expression dimensions), a non-dense key, a granularity that is neither
"all" nor uniform, an interval that does not cover the segment, a filter
node that reads rows (time intervals, bitmap words, expressions, column
comparisons), an aggregator other than count, LONG sum, min/max and a
filtered one of these, and a joint partition finer than n_rows / 16 or
above CASCADE_MAX_RUNS runs. A filtered aggregator's filter is re-planned
without bitmap nodes and must pass the same node whitelist; its columns
join the partition. An extraction or listFiltered dimension's remap applies
to each run's id. PyTorch runs eagerly: there is no program cache.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from druid_tpu_torch.data import cascade
from druid_tpu_torch.data.segment import Segment, ValueType
from druid_tpu_torch.engine.contracts import CASCADE_MAX_RUNS
from druid_tpu_torch.obs import dispatch as dispatch_mod
from druid_tpu_torch.engine.filters import (AndNode, ConstNode, FilterNode,
                                            LutNode, NotNode, NumericCmpNode,
                                            NumericEqNode, NumericInNode,
                                            OrNode, plan_filter)
from druid_tpu_torch.engine.kernels import (AggKernel, CountKernel,
                                            FilteredKernel, MinMaxKernel,
                                            SumKernel)


@dataclass
class _RunKernel:
    """One kernel's run-space plan: the kernel and the run columns it reads
    (none for a count, a constant sum or a missing column); for a filtered
    kernel, its run-space filter (None: always true) and its child's
    plan."""
    kernel: AggKernel
    cols: frozenset = frozenset()
    fnode: Optional[FilterNode] = None
    child: Optional["_RunKernel"] = None

    def sig(self) -> str:
        """The reference's signature of this run kernel."""
        if self.child is not None:
            f = self.fnode.signature() if self.fnode is not None else "none"
            return f"rfiltered({f},{self.child.sig()})"
        return self.kernel.signature()

    def columns(self) -> set:
        if self.child is None:
            return set(self.cols)
        cols = self.child.columns()
        if self.fnode is not None:
            cols |= self.fnode.required_device_columns()
        return cols


def _run_filter_ok(node: Optional[FilterNode]) -> bool:
    """Whether every node of a planned filter reads only per-run values:
    dictionary LUTs, numeric compares and constants under AND/OR/NOT (no
    time intervals, which read rows, and no bitmap words)."""
    if node is None:
        return True
    if isinstance(node, (AndNode, OrNode)):
        return all(_run_filter_ok(c) for c in node.children)
    if isinstance(node, NotNode):
        return _run_filter_ok(node.child)
    return isinstance(node, (ConstNode, LutNode, NumericEqNode,
                             NumericInNode, NumericCmpNode))


def _plan_run_kernel(k: AggKernel, segment: Segment) -> Optional[_RunKernel]:
    if isinstance(k, FilteredKernel):
        child = _plan_run_kernel(k.child, segment)
        if child is None:
            return None
        # re-planned from the spec without bitmap nodes: the kernel's own
        # tree may hold words, which are row space
        fnode = plan_filter(k.spec.filter, segment, device_bitmap=False)
        if not _run_filter_ok(fnode):
            return None
        return _RunKernel(k, fnode=fnode, child=child)
    if isinstance(k, CountKernel):
        return _RunKernel(k)
    if isinstance(k, SumKernel):
        if k.vtype is not ValueType.LONG:
            return None                   # float sums reorder: row path
        if k.const_value is not None:
            return _RunKernel(k)
        f = k.spec.field
        if f in segment.dims:
            return None
        m = segment.metrics.get(f)
        if m is None:
            return _RunKernel(k)          # a missing column sums to zeros
        if m.type is not ValueType.LONG:
            return None
        return _RunKernel(k, frozenset({f}))
    if isinstance(k, MinMaxKernel):
        f = k.spec.field
        if f in segment.dims:
            return None
        if f not in segment.metrics:
            return _RunKernel(k)          # a missing column: identities
        return _RunKernel(k, frozenset({f}))
    return None


def run_domain_probe(segment: Segment, intervals, granularity, spec,
                     kernels: Sequence[AggKernel], flt,
                     virtual_columns: Sequence = ()) -> bool:
    """Whether the segment's aggregate would run in run space: batching's
    eligibility probe (such a segment runs alone, through
    run_grouped_aggregate, which takes the run domain first). It shares
    `_plan_run_domain`'s memo on the (single-use) spec, so a probed
    segment is not planned twice."""
    return _plan_run_domain(segment, intervals, granularity, spec, kernels,
                            flt, virtual_columns) is not None


def _plan_run_domain(segment: Segment, intervals, granularity, spec,
                     kernels: Sequence[AggKernel], flt,
                     virtual_columns: Sequence = ()):
    """None, or (run filter node, run kernels, partition columns, bucket,
    (starts, lengths, n_runs)) when the whole grouped aggregate can run over
    run tables. Memoized on the spec."""
    if spec._cascade_run_plan is None:
        spec._cascade_run_plan = (_plan_run_domain_uncached(
            segment, intervals, granularity, spec, kernels, flt,
            virtual_columns),)
    return spec._cascade_run_plan[0]


def _plan_run_domain_uncached(segment, intervals, granularity, spec, kernels,
                              flt, virtual_columns):
    if not cascade.run_domain_enabled() or segment.n_rows == 0 \
            or virtual_columns:
        return None                       # a virtual column reads rows
    if spec.bucket_mode not in ("all", "uniform") or spec.key_mode != "dense":
        return None
    if not any(iv.start <= segment.min_time and iv.end > segment.max_time
               for iv in intervals):
        return None                       # the time mask must be all-true
    # at a uniform granularity the bucket id joins the run partition: where
    # bucket boundaries split runs row by row, the partition prices itself
    # out in _joint_runs
    bucket = None
    if spec.bucket_mode == "uniform":
        if granularity is None or not granularity.is_uniform \
                or spec.num_buckets < 1:
            return None
        bucket = (int(spec.bucket_starts[0]), int(granularity.period_ms),
                  spec.num_buckets)
    if any(d.host_ids is not None for d in spec.dims):
        return None                       # a derived id column is row space
    cols = set()
    for d in spec.dims:
        if d.column is not None:
            if d.column not in segment.dims:
                return None
            cols.add(d.column)
    # re-planned without bitmap nodes: bitmap words are row space
    fnode = plan_filter(flt, segment, device_bitmap=False)
    if not _run_filter_ok(fnode):
        return None
    if fnode is not None:
        cols |= fnode.required_device_columns()
    rkernels = []
    for k in kernels:
        rk = _plan_run_kernel(k, segment)
        if rk is None:
            return None
        rkernels.append(rk)
        cols |= rk.columns()
    if any(c not in segment.dims and c not in segment.metrics for c in cols):
        return None
    pkey = tuple(sorted(cols))
    info = _joint_runs(segment, pkey, bucket)
    if info is None:
        return None
    return fnode, rkernels, pkey, bucket, info


def joint_partition(segment: Segment, pkey: Tuple[str, ...],
                    bucket: Optional[Tuple[int, int, int]] = None):
    """(starts, lengths, n_runs), int32, of the joint run partition over the
    named columns and, with `bucket` = (first bucket start, period, B), the
    uniform bucket id: a row starts a run where any of them changes. A
    column with run tables gives its run starts, any other is compared row
    to row. Cached per column set and bucket boundaries, (first mod period,
    period)."""
    def _compute():
        n = segment.n_rows
        change = np.zeros(n, dtype=bool)
        change[0] = True
        for c in pkey:
            info = cascade.column_run_info(segment, c)
            if info is not None:
                _, ends, nr = info
                change[ends[:nr - 1]] = True
            else:
                col = segment.dims.get(c)
                v = col.ids if col is not None else segment.metrics[c].values
                change[1:] |= v[1:] != v[:-1]
        if bucket is not None:
            first, period, _ = bucket
            bid = (segment.time_ms - first) // period
            change[1:] |= bid[1:] != bid[:-1]
        starts = np.flatnonzero(change).astype(np.int32)
        lengths = np.diff(starts, append=n).astype(np.int32)
        return starts, lengths, int(starts.shape[0])

    bkey = None if bucket is None else (bucket[0] % bucket[1], bucket[1])
    return segment.aux_cached(("cascade_runpart", pkey, bkey), _compute)


def _joint_runs(segment: Segment, pkey: Tuple[str, ...],
                bucket: Optional[Tuple[int, int, int]] = None):
    """`joint_partition`, or None when it is too fine to pay: more than
    CASCADE_MAX_RUNS runs, or fewer than RUN_DOMAIN_MIN_ROWS_PER_RUN rows a
    run on average."""
    limit = min(CASCADE_MAX_RUNS,
                segment.n_rows // cascade.RUN_DOMAIN_MIN_ROWS_PER_RUN)
    # a partition has at least as many runs as each of its columns, so a
    # column over the limit on its own (a cached count) refuses it unbuilt
    if any(cascade.column_run_count(segment, c) > limit for c in pkey):
        return None
    starts, lengths, nr = joint_partition(segment, pkey, bucket)
    if nr > limit:
        return None
    return starts, lengths, nr


def _values_at_starts(segment: Segment, name: str, starts: np.ndarray,
                      dt) -> np.ndarray:
    """A run-constant column's value in each joint run, in dtype `dt`: a
    search of its run tables where it has them and stages int32 (the run
    values are int32), else a gather from its rows."""
    if dt == np.int32:
        info = cascade.column_run_info(segment, name)
        if info is not None:
            rv, ends, nr = info
            idx = np.searchsorted(ends[:nr], starts, side="right")
            return rv[np.minimum(idx, nr - 1)].astype(np.int32)
    col = segment.dims.get(name)
    v = (col.ids if col is not None
         else segment.metrics[name].values)[starts]
    return v.astype(dt) if v.dtype != dt else v


def _run_update(rk: _RunKernel, cols: Dict[str, torch.Tensor],
                mask: torch.Tensor, key: torch.Tensor, lens: torch.Tensor,
                num: int) -> torch.Tensor:
    """One kernel's state over the runs, shaped and typed as its row-path
    `update` would return it, so host_post and the merge are unchanged."""
    if rk.child is not None:
        if rk.fnode is not None:
            mask = mask & rk.fnode.build(cols)
        return _run_update(rk.child, cols, mask, key, lens, num)
    k = rk.kernel
    dev = key.device
    if isinstance(k, CountKernel):
        return torch.zeros(num, dtype=torch.int64, device=dev) \
            .index_add_(0, key, torch.where(mask, lens, 0))
    if isinstance(k, SumKernel):
        out = torch.zeros(num, dtype=torch.int64, device=dev)
        if k.const_value is not None:
            return out.index_add_(0, key, torch.where(mask, lens, 0)) \
                * k.const_value
        f = k.spec.field
        if f not in cols:
            return out
        # sum of v * len = the rows' sum of v modulo 2^64: the row path's
        # int64 sum, wraparound included
        return out.index_add_(0, key, torch.where(
            mask, cols[f].to(torch.int64) * lens, 0))
    f = k.spec.field
    if f not in cols:
        return torch.from_numpy(k.empty_state(num)).to(dev)
    v = cols[f]
    ident = k.ident_for(v.dtype)
    red = "amax" if k.is_max else "amin"
    out = torch.full((num,), ident, dtype=v.dtype, device=dev)
    if not v.dtype.is_floating_point:
        return out.scatter_reduce_(0, key, torch.where(mask, v, ident), red)
    # NaN carried explicitly, as jnp.max/min propagate it: scatter_reduce's
    # NaN handling is not relied on
    nan = torch.isnan(v) & mask
    out.scatter_reduce_(0, key, torch.where(mask & ~nan, v, ident), red)
    has_nan = torch.zeros(num, dtype=torch.int64, device=dev) \
        .index_add_(0, key, nan.to(torch.int64)) > 0
    return torch.where(has_nan, float("nan"), out)


def try_run_domain(segment: Segment, intervals, granularity, spec,
                   kernels: Sequence[AggKernel], flt, device: torch.device,
                   virtual_columns: Sequence = ()):
    """One segment's grouped aggregate in run space when the plan allows:
    (counts int64 [num_total], per-kernel device states), else None."""
    plan = _plan_run_domain(segment, intervals, granularity, spec, kernels,
                            flt, virtual_columns)
    if plan is None:
        return None
    fnode, rkernels, pkey, bucket, (starts, lengths, nr) = plan
    rpad = cascade.pad_pow2(nr)
    # the cache key names the partition, not just its columns: a uniform
    # granularity's partition of the same columns has other run tables
    part_key = (pkey, bucket)

    def staged(name: str, values, fill=0) -> torch.Tensor:
        def _build():
            v = values()
            out = np.full(rpad, fill, dtype=v.dtype)
            out[: v.shape[0]] = v
            return torch.from_numpy(out).to(device)
        return segment.device_cached(
            ("rundom", part_key, rpad, name, str(device)), _build)

    cols: Dict[str, torch.Tensor] = {}
    for c in pkey:
        dt = np.dtype(np.int32) if c in segment.dims \
            else segment.staged_dtype(c)
        cols[c] = staged(c, lambda c=c, dt=dt: _values_at_starts(
            segment, c, starts, dt))
    # pad runs have length 0 (and bucket -1), so they drop out of the mask
    lens = staged("__runlen", lambda: lengths).to(torch.int64)
    mask = lens > 0
    cols["__valid"] = mask                # ConstNode's shape
    if bucket is not None:
        first, period, _ = bucket
        key = staged("__runbucket", lambda: (
            (segment.time_ms[starts] - first) // period).astype(np.int32),
            fill=-1).to(torch.int64)
        mask = mask & (key >= 0)
        key = key.clamp_min(0)
    else:
        key = torch.zeros(rpad, dtype=torch.int64, device=device)
    for d in spec.dims:
        if d.column is None:
            continue
        ids = cols[d.column].to(torch.int64)
        if d.remap is not None:
            # an extraction / listFiltered dimension: a -1 drops the run
            ids = torch.from_numpy(d.remap).to(device)[ids.clamp_min(0)] \
                .to(torch.int64)
            mask = mask & (ids >= 0)
        key = key * d.cardinality + ids.clamp_min(0)
    if fnode is not None:
        mask = mask & fnode.build(cols)
    key = key.clamp(0, spec.num_total - 1)
    counts = torch.zeros(spec.num_total, dtype=torch.int64, device=device) \
        .index_add_(0, key, torch.where(mask, lens, 0))
    states = tuple(_run_update(rk, cols, mask, key, lens, spec.num_total)
                   for rk in rkernels)
    dispatch_mod.record("runDomain")
    cascade.code_domain_stats().record(segment.n_rows)
    return counts, states
