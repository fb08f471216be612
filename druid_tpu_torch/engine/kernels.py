"""Aggregation kernels: one aggregator's grouped update, combine and finalize.

The port's counterpart of the reference package's `engine/kernels.py`
(CountKernel, SumKernel, MinMaxKernel, FirstLastKernel, FilteredKernel,
HllKernel). `update` is the plain scatter strategy: `index_add_` for counts
and sums, `scatter_reduce` for min/max, first/last and HLL registers, in
place of the reference's `segment_sum/min/max`. Long sums accumulate in
int64 and are exact. A state is a tensor, or a tuple of tensors that
`host_post` turns into the reference's host form (first/last: a dict of
arrays; HLL: an int32 [G, m] register grid). `pallas_op` describes the
kernel to the sorted-projection reduction (engine/sorted_reduce.py) with
the reference's op vocabulary. The blocked hooks
(`blocked_supported/init/step/finish`) serve the masked broadcast-reduce of
the blocked and windowed strategies (engine/grouping.py), and `mm_plan` the
one-hot matmul of the mm strategy (engine/mmagg.py), and the device merge
hooks (`reduce_kind`, `device_post`, `device_combine`, `host_from_device`)
the sharded run's merge on the card (parallel/distributed.py), with the
reference's merge kind for every kernel. Every eligibility rule
is the reference's, so both packages choose the same strategy for the same
plan: a first/last, filtered or HLL kernel has neither an mm plan nor a
blocked step, so a plan holding one is "mixed". Extension kernels
(druid_tpu_torch/ext/) register by spec class through `register_kernel`;
`make_kernel` looks the exact class up first, as in the reference. They
build on `_seg_sum`, `_seg_min` and `_seg_max`, the port's
segment_sum/min/max.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from druid_tpu_torch.data import cascade
from druid_tpu_torch.data.segment import Segment, ValueType
from druid_tpu_torch.engine import hll
from druid_tpu_torch.engine.contracts import AGG_FOLD_REQUIRED
from druid_tpu_torch.engine.filters import FilterNode, plan_filter
from druid_tpu_torch.query import aggregators as A

INT32_MIN = -(2**31)
INT64_MAX = np.int64(2**63 - 1)
INT64_MIN = np.int64(-(2**63))

_TORCH = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
          np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64}


@dataclass
class MMPlan:
    """A kernel's one-hot-matmul decomposition (engine/mmagg.py).

    mm_reduce builds the [G, rows] one-hot of (key AND mask) once per step
    and contracts it against every kernel's value rows in two products: int8
    rows accumulate exactly in integers (<= 7-bit limbs), and float32 rows
    holding bf16-representable parts (the hi/lo/lo2 split) accumulate in
    float32.

    fields:    columns make_rows reads
    n_i8:      number of int8 rows this kernel contributes
    n_bf16:    number of bf16-valued rows
    make_rows: (cols of one step, mask of the step) -> (list of int8 [rows]
               tensors, list of float32 [rows] tensors)
    finish:    (int64 parts [n_i8, G], float32 parts [n_bf16, G], num) ->
               the state `update` would produce
    """
    fields: Tuple[str, ...]
    n_i8: int
    n_bf16: int
    make_rows: Callable
    finish: Callable


class AggKernel:
    """One aggregator's device update + host combine/finalize."""

    #: how states combine on the device, the reference's kind: "sum", "min"
    #: or "max" elementwise, or "fold", a pairwise `device_combine`. The
    #: sharded merge (parallel/distributed.py) combines the per-segment and
    #: per-shard states by it; the blocked and windowed reductions combine
    #: one group's grid slots by it (their kernels are "sum", "min" or
    #: "max")
    reduce_kind = "fold"

    def __init__(self, spec: A.AggregatorSpec):
        self.spec = spec
        self.name = spec.name

    def signature(self) -> str:
        """The reference's structural signature (the run domain's plan and
        the batched path's bucket digest carry it)."""
        raise NotImplementedError

    def aux_arrays(self) -> List[np.ndarray]:
        """The kernel's constants, in the reference's order: plans batch
        together only where these are equal."""
        return []

    def update(self, cols: Dict[str, torch.Tensor], mask: torch.Tensor,
               keys: torch.Tensor, num: int) -> torch.Tensor:
        """Per-group partial state [num]; `keys` int64 in [0, num)."""
        raise NotImplementedError

    def update_stacked(self, cols: Dict[str, torch.Tensor],
                       mask: torch.Tensor, keys: torch.Tensor, K: int,
                       num: int):
        """`update` over the rows of K stacked segments, flattened, with
        segment k's keys offset by k * num: the state of K * num groups.
        A kernel whose limits are per segment checks them against `num`."""
        return self.update(cols, mask, keys, K * num)

    def filter_trees(self) -> List[FilterNode]:
        """The planned filter trees this kernel owns (a FilteredKernel
        chain's): bitmap slots, word staging and megaizing walk them."""
        return []

    def required_device_columns(self) -> Optional[set]:
        """The staged columns `update` reads, where narrower than the
        aggregator's `required_columns()`; None = the aggregator's."""
        return None

    def host_post(self, state, segment: Segment):
        """Device state -> host combine-ready state."""
        return state.cpu().numpy() if isinstance(state, torch.Tensor) \
            else np.asarray(state)

    # ---- the device merge (the sharded run, parallel/distributed.py) -----

    def device_post(self, state, time0):
        """One segment's device state made independent of its time origin
        (relative to absolute time), so that states of segments with
        different origins combine on the device. `time0` (int64) broadcasts
        against the state: a scalar for one segment's state, [K, 1] for a
        stack of K segments' [K, G] states."""
        return state

    def device_combine(self, a, b):
        """Pairwise combine of two device_post-ed states (a tensor, or a
        tuple of them), elementwise by reduce_kind: "sum" adds, "max" and
        "min" keep the larger and the smaller, and a bool state ORs (ANDs
        under "min"). A kernel that folds defines its own."""
        kind = self.reduce_kind
        if kind == "fold":
            raise NotImplementedError
        if isinstance(a, tuple):
            return tuple(self.device_combine(x, y) for x, y in zip(a, b))
        if a.dtype == torch.bool:
            return a & b if kind == "min" else a | b
        if kind == "sum":
            return a + b
        return torch.maximum(a, b) if kind == "max" else torch.minimum(a, b)

    def host_from_device(self, state):
        """A device_post-ed, device-combined state -> the host form
        host_post gives."""
        return self.host_post(state, None)

    def combine(self, a, b):
        raise NotImplementedError

    def empty_state(self, n: int) -> np.ndarray:
        raise NotImplementedError

    def finalize_array(self, state) -> np.ndarray:
        return state

    # ---- blocked path (small group spaces, and the windowed L1 pass) -----
    # `valid` is a bool [..., G, rows] matrix (row r of the step counts for
    # group g); a step reduces over the last axis, so the windowed strategy
    # passes a batch of blocks [blocks, W, rows] through the same code.

    def blocked_supported(self, cols_avail: Dict) -> bool:
        return False

    def blocked_init(self, num: int, cols: Dict[str, torch.Tensor],
                     device: torch.device) -> torch.Tensor:
        """Identity carry [num]; `cols` holds the full columns (dtypes)."""
        raise NotImplementedError

    def blocked_step(self, carry: torch.Tensor, cols_block: Dict,
                     valid: torch.Tensor, num: int) -> torch.Tensor:
        """carry combined with this step's per-group partial."""
        raise NotImplementedError

    def blocked_finish(self, carry: torch.Tensor) -> torch.Tensor:
        """Carry -> the same state `update` would produce."""
        return carry

    # ---- one-hot matmul path (small group spaces) -----------------------

    def mm_plan(self, cols_avail: Dict, padded_rows: int) -> Optional[MMPlan]:
        return None

    def pallas_op(self, cols_avail: Dict) -> Optional[tuple]:
        """("count",), ("sum_i32", field, chunk_rows), ("sum_f32"|"min_i32"|
        "max_i32"|"min_f32"|"max_f32", field), ("zero",)/("empty",) for a
        missing column, or None (ineligible)."""
        return None


def count_true(valid: torch.Tensor) -> torch.Tensor:
    """int32 counts of the True entries along the last axis of a bool
    broadcast: a sum in int32 (the cells cast to 4 bytes), where
    count_nonzero would cast them to int64 (8 bytes). A count stays below
    2^31: a step or block holds fewer rows."""
    return valid.sum(-1, dtype=torch.int32)


def expand_batch(state: torch.Tensor, batch: Tuple[int, ...]):
    """A batched reduction's states are [*batch, G]; one that no row
    touched (a missing column's identities) comes back [G]."""
    if batch and state.dim() == 1:
        return state.expand(tuple(batch) + tuple(state.shape)).contiguous()
    return state


class CountKernel(AggKernel):
    reduce_kind = "sum"

    def signature(self):
        return "count"

    def pallas_op(self, cols_avail):
        return ("count",)

    def update(self, cols, mask, keys, num):
        return torch.zeros(num, dtype=torch.int64, device=keys.device) \
            .index_add_(0, keys, mask.to(torch.int64))

    def host_post(self, state, segment):
        return super().host_post(state, segment).astype(np.int64)

    def combine(self, a, b):
        return a + b

    def empty_state(self, n):
        return np.zeros(n, dtype=np.int64)

    def blocked_supported(self, cols_avail):
        return True

    def blocked_init(self, num, cols, device):
        return torch.zeros(num, dtype=torch.int64, device=device)

    def blocked_step(self, carry, cols_block, valid, num):
        return carry + count_true(valid)

    def mm_plan(self, cols_avail, padded_rows):
        if padded_rows >= 2**31:
            return None

        def make(cols, mask):
            return [torch.ones(mask.shape, dtype=torch.int8,
                               device=mask.device)], []

        def fin(i8, bf, num):
            return i8[0]
        return MMPlan((), 1, 0, make, fin)


def _exact_int_sum(w: torch.Tensor, chunk: int) -> torch.Tensor:
    """int64 sums over the last axis of int32 `w`, exact: int32 sums over
    runs of at most `chunk` rows (a SumKernel's chunk_rows, under which a
    partial stays below 2^30), then int64 across runs. Summing int32 in
    int32 reads `w` once; an int64 sum of it would first write an int64
    copy. chunk 0 (no bound: an int64 column, such as a LONG virtual
    column) sums in int64 directly."""
    if not chunk:
        return w.sum(-1, dtype=torch.int64)
    n = w.shape[-1]
    full = n // chunk * chunk
    out = w[..., full:].sum(-1, dtype=torch.int32).to(torch.int64)
    if full:
        out += w[..., :full].unflatten(-1, (full // chunk, chunk)) \
            .sum(-1, dtype=torch.int32).sum(-1)
    return out


class SumKernel(AggKernel):
    reduce_kind = "sum"
    _DTYPES = {ValueType.LONG: np.dtype(np.int64),
               ValueType.FLOAT: np.dtype(np.float32),
               ValueType.DOUBLE: np.dtype(np.float64)}

    def __init__(self, spec, vtype: ValueType,
                 segment: Optional[Segment] = None):
        super().__init__(spec)
        self.vtype = vtype
        # the reference's chunk bound for int32-staged long sums: rows per
        # chunk such that a chunk's per-group partial stays below 2^30. It
        # carries the reference's eligibility rules (blocked / sum_i32) and
        # bounds the int32 runs of the blocked step (`_exact_int_sum`).
        self.chunk_rows = 0
        # the reference's one-hot matmul decomposition: <= 7-bit limb rows
        # of (v - base), base the column min when negative; eligible when
        # <= 4 limbs cover the range
        self.mm_limbs = 0
        self.mm_base = 0
        # a non-finite row would poison every group through the one-hot
        # contraction (NaN * 0 = NaN), so a float column goes through the
        # matmul only when the host has seen it all finite
        self.mm_float_ok = bool(
            vtype is ValueType.FLOAT and segment is not None
            and spec.field in segment.metrics
            and segment.column_finite(spec.field))
        # a LONG column whose min equals its max sums as constant x count
        # and never stages (with the cascade on, as in the reference); such
        # a kernel stays off the mm, blocked and sorted-projection
        # strategies, as in the reference
        self.const_value: Optional[int] = None
        if vtype is ValueType.LONG and segment is not None \
                and spec.field in segment.metrics:
            lo, hi = segment.column_minmax(spec.field)
            if lo == hi and cascade.enabled():
                self.const_value = int(lo)
        if vtype is ValueType.LONG and segment is not None \
                and spec.field in segment.metrics \
                and segment.staged_dtype(spec.field) == np.int32:
            lo, hi = segment.column_minmax(spec.field)
            r = (2 ** 30) // max(abs(lo), abs(hi), 1)
            self.chunk_rows = 1 << (r.bit_length() - 1) if r >= 1024 else 0
            base = min(int(lo), 0)
            nl = max(1, ((int(hi) - base).bit_length() + 6) // 7)
            if nl <= 4:
                self.mm_limbs, self.mm_base = nl, base

    def signature(self):
        return (f"sum({self.spec.field},{self.vtype.value},{self.chunk_rows},"
                f"mm{self.mm_limbs}:{self.mm_base}:{int(self.mm_float_ok)},"
                f"c{int(self.const_value is not None)})")

    def aux_arrays(self):
        if self.const_value is not None:
            return [np.asarray(self.const_value, dtype=np.int64)]
        return []

    def pallas_op(self, cols_avail):
        f = self.spec.field
        if self.const_value is not None:
            return None
        if f not in cols_avail:
            return ("zero",)
        dt = str(cols_avail[f])
        if self.vtype is ValueType.FLOAT and dt == "float32":
            return ("sum_f32", f)
        if self.vtype is ValueType.LONG and dt == "int32" \
                and self.chunk_rows >= 2048:
            return ("sum_i32", f, self.chunk_rows)
        return None

    def required_device_columns(self):
        # a constant column is never read, so it never stages
        return set() if self.const_value is not None else None

    def update(self, cols, mask, keys, num):
        dt = _TORCH[self._DTYPES[self.vtype]]
        out = torch.zeros(num, dtype=dt, device=keys.device)
        if self.const_value is not None:
            # constant x per-group row count, in int64 (wrapping as the
            # reference's product does)
            return out.index_add_(0, keys, mask.to(torch.int64)) \
                * self.const_value
        if self.spec.field not in cols:
            # missing column aggregates as zero (reference semantics)
            return out
        v = cols[self.spec.field]
        v = torch.where(mask, v, torch.zeros((), dtype=v.dtype,
                                             device=v.device)).to(dt)
        return out.index_add_(0, keys, v)

    def combine(self, a, b):
        return a + b

    def empty_state(self, n):
        return np.zeros(n, dtype=self._DTYPES[self.vtype])

    def blocked_supported(self, cols_avail):
        if self.const_value is not None:
            return False
        if self.spec.field not in cols_avail:
            return True
        if self.vtype is ValueType.FLOAT:
            return True
        return self.chunk_rows >= 2048

    def blocked_init(self, num, cols, device):
        # the reference's carry dtypes: a missing DOUBLE column sums as int64
        # zeros there too
        dt = torch.float32 if self.vtype is ValueType.FLOAT else torch.int64
        return torch.zeros(num, dtype=dt, device=device)

    def blocked_step(self, carry, cols_block, valid, num):
        if self.spec.field not in cols_block:
            return carry
        v = cols_block[self.spec.field].unsqueeze(-2)
        if v.dtype.is_floating_point and self.vtype is not ValueType.LONG:
            # a float column, or a DOUBLE virtual column (float64): summed
            # in its own dtype, as the scatter update sums it
            return carry + torch.where(valid, v, 0.0).sum(-1)
        if v.dtype.is_floating_point:
            # a LONG sum over a float virtual column truncates each row, as
            # the scatter update does
            v = v.to(torch.int64)
        return carry + _exact_int_sum(torch.where(valid, v, 0),
                                      self.chunk_rows)

    def mm_plan(self, cols_avail, padded_rows):
        f = self.spec.field
        if self.const_value is not None:
            return None
        if self.vtype is ValueType.FLOAT and not self.mm_float_ok:
            return None
        if f not in cols_avail:
            dt = torch.float32 if self.vtype is ValueType.FLOAT \
                else torch.int64

            def make(cols, mask):
                return [], []

            def fin(i8, bf, num):
                return torch.zeros(num, dtype=dt, device=i8.device)
            return MMPlan((), 0, 0, make, fin)
        if self.vtype is ValueType.FLOAT:
            # bf16 triple split: hi/lo/lo2 hold all 24 mantissa bits, each
            # part <= 8 significant bits, so its product with the 0/1
            # one-hot is exact and only the float32 accumulation rounds
            def make(cols, mask):
                v = torch.where(mask, cols[f], 0.0)  # off-mask NaN/Inf
                hi = v.to(torch.bfloat16).to(torch.float32)
                r1 = v - hi
                m1 = r1.to(torch.bfloat16).to(torch.float32)
                r2 = (r1 - m1).to(torch.bfloat16).to(torch.float32)
                return [], [hi, m1, r2]

            def fin(i8, bf, num):
                return bf[0] + bf[1] + bf[2]
            return MMPlan((f,), 0, 3, make, fin)
        if self.vtype is ValueType.LONG and self.mm_limbs \
                and padded_rows * 127 < 2**31:
            nl, base = self.mm_limbs, self.mm_base

            def make(cols, mask):
                v = cols[f] - base
                rows = [((v >> (7 * i)) & 127).to(torch.int8)
                        for i in range(nl)]
                if base:
                    rows.append(torch.ones(mask.shape, dtype=torch.int8,
                                           device=mask.device))
                return rows, []

            def fin(i8, bf, num):
                s = torch.zeros(num, dtype=torch.int64, device=i8.device)
                for i in range(nl):
                    s = s + (i8[i] << (7 * i))
                if base:
                    s = s + i8[nl] * base
                return s
            return MMPlan((f,), nl + (1 if base else 0), 0, make, fin)
        return None


class MinMaxKernel(AggKernel):
    def __init__(self, spec, vtype: ValueType, is_max: bool,
                 segment: Optional[Segment] = None):
        super().__init__(spec)
        self.vtype = vtype
        self.is_max = is_max
        self.reduce_kind = "max" if is_max else "min"
        # the staged dtype as the reference's signature renders it: a LONG
        # column's by its numpy scalar class, any other's by its dtype
        self.staged = ""
        if segment is not None and spec.field in segment.metrics:
            dt = segment.staged_dtype(spec.field)
            self.staged = str(dt.type if segment.metrics[spec.field].type
                              is ValueType.LONG else dt)

    def signature(self):
        return (f"{'max' if self.is_max else 'min'}"
                f"({self.spec.field},{self.vtype.value},{self.staged})")

    @property
    def identity(self):
        if self.vtype == ValueType.LONG:
            return INT64_MIN if self.is_max else INT64_MAX
        return np.float64(-np.inf) if self.is_max else np.float64(np.inf)

    def pallas_op(self, cols_avail):
        f = self.spec.field
        if f not in cols_avail:
            return ("empty",)
        dt = str(cols_avail[f])
        if dt == "int32":
            return ("max_i32" if self.is_max else "min_i32", f)
        if dt == "float32":
            return ("max_f32" if self.is_max else "min_f32", f)
        return None

    def update(self, cols, mask, keys, num):
        if self.spec.field not in cols:
            return torch.from_numpy(self.empty_state(num)).to(keys.device)
        v = cols[self.spec.field]
        # identity in the STAGED dtype (an int32-narrowed long uses int32
        # sentinels; host_post widens them)
        ident = self.ident_for(v.dtype)
        out = torch.full((num,), ident, dtype=v.dtype, device=v.device)
        v = torch.where(mask, v, torch.full((), ident, dtype=v.dtype,
                                            device=v.device))
        return out.scatter_reduce_(0, keys, v,
                                   "amax" if self.is_max else "amin")

    def host_post(self, state, segment):
        st = super().host_post(state, segment)
        if self.vtype == ValueType.LONG and st.dtype != np.int64:
            # narrow sentinels widen to the int64 identity so cross-segment
            # merges stay correct
            narrow_ident = np.iinfo(st.dtype).min if self.is_max \
                else np.iinfo(st.dtype).max
            st64 = st.astype(np.int64)
            st64[st == narrow_ident] = self.identity
            return st64
        return st

    def blocked_supported(self, cols_avail):
        if self.spec.field not in cols_avail:
            return True
        return str(cols_avail[self.spec.field]) in ("int32", "float32")

    def ident_for(self, dtype: torch.dtype):
        """The identity of this min/max in `dtype` (a staged dtype)."""
        if dtype.is_floating_point:
            return -float("inf") if self.is_max else float("inf")
        info = torch.iinfo(dtype)
        return info.min if self.is_max else info.max

    def blocked_init(self, num, cols, device):
        if self.spec.field not in cols:
            return torch.from_numpy(self.empty_state(num)).to(device)
        dt = cols[self.spec.field].dtype
        return torch.full((num,), self.ident_for(dt), dtype=dt, device=device)

    def blocked_step(self, carry, cols_block, valid, num):
        if self.spec.field not in cols_block:
            return carry
        v = cols_block[self.spec.field]
        vm = torch.where(valid, v.unsqueeze(-2), self.ident_for(v.dtype))
        # amax/amin and maximum/minimum propagate NaN, as jnp.max does
        if self.is_max:
            return torch.maximum(carry, vm.amax(-1))
        return torch.minimum(carry, vm.amin(-1))

    def combine(self, a, b):
        return np.maximum(a, b) if self.is_max else np.minimum(a, b)

    def empty_state(self, n):
        dt = (np.int64 if self.vtype == ValueType.LONG
              else np.float32 if self.vtype == ValueType.FLOAT else np.float64)
        return np.full(n, self.identity, dtype=dt)


#: copies of the grid a contended scatter writes: at most SCATTER_COPIES,
#: or as many as fill SCATTER_CELLS cells where the groups are few
SCATTER_COPIES = 64
SCATTER_CELLS = 1 << 18


def _copies(rows: int, num: int) -> int:
    """Copies of a [num] grid that a scatter of `rows` rows writes: row r
    updates copy r % copies, so the rows of one group spread over that
    many addresses instead of contending for one, and the copies reduce
    after. Never more copies than rows per group."""
    num = max(num, 1)
    return max(1, min(rows // num, max(SCATTER_COPIES,
                                       SCATTER_CELLS // num)))


def _spread(keys: torch.Tensor, num: int, copies: int) -> torch.Tensor:
    """Each row's cell in `copies` stacked copies of a [num] grid."""
    if copies == 1:
        return keys
    return keys + torch.arange(keys.shape[0], device=keys.device) \
        % copies * num


def _seg_reduce(values: torch.Tensor, keys: torch.Tensor, num: int,
                red: str) -> torch.Tensor:
    """Per-group max ("amax") or min ("amin") over the rows, as
    jax.ops.segment_max/min: a group without rows holds the dtype's least
    (max) or greatest (min) value, -inf or +inf for a float. Scattered
    into `_copies` copies of the grid, then reduced."""
    if values.dtype.is_floating_point:
        ident = -float("inf") if red == "amax" else float("inf")
    else:
        info = torch.iinfo(values.dtype)
        ident = info.min if red == "amax" else info.max
    copies = _copies(keys.shape[0], num)
    out = torch.full((copies * num,), ident, dtype=values.dtype,
                     device=values.device)
    out = out.scatter_reduce_(0, _spread(keys, num, copies), values, red) \
        .view(copies, num)
    return out.amax(0) if red == "amax" else out.amin(0)


def _seg_max(values: torch.Tensor, keys: torch.Tensor,
             num: int) -> torch.Tensor:
    return _seg_reduce(values, keys, num, "amax")


def _seg_min(values: torch.Tensor, keys: torch.Tensor,
             num: int) -> torch.Tensor:
    return _seg_reduce(values, keys, num, "amin")


def _seg_sum(values: torch.Tensor, keys: torch.Tensor,
             num: int) -> torch.Tensor:
    """Per-group sums in the values' dtype, as jax.ops.segment_sum:
    `index_add_` into `_copies` copies of the grid, then summed. Integer
    sums are exact; a float sum's order of additions is not fixed either
    way."""
    copies = _copies(keys.shape[0], num)
    out = torch.zeros(copies * num, dtype=values.dtype,
                      device=values.device)
    out = out.index_add_(0, _spread(keys, num, copies), values)
    return out.view(copies, num).sum(0, dtype=values.dtype)


#: cells past a presence grid that masked rows write instead of the grid,
#: so that no one address takes every masked row's store
SPARE_CELLS = 1024


def _presence(cell: torch.Tensor, mask: torch.Tensor, cells: int,
              dtype: torch.dtype) -> torch.Tensor:
    """A [cells] grid of 0 and 1 in `dtype`: 1 where a live row's `cell`
    (int64, any shape; `mask` broadcasts to it) points. Every write is a 1,
    so no order of writes changes the grid; a masked row writes one of
    SPARE_CELLS cells past it instead, chosen by the row's position."""
    spare = cells + torch.arange(cell.numel(), device=cell.device) \
        .view(cell.shape) % SPARE_CELLS
    idx = torch.where(mask, cell, spare).flatten()
    return torch.zeros(cells + SPARE_CELLS, dtype=dtype,
                       device=cell.device).index_fill_(0, idx, 1)[:cells]


class FirstLastKernel(AggKernel):
    """The value at the least (first) or greatest (last) time of each
    group. On the device: the best time per group, then the least row index
    among the rows at that time, then a gather of the value; the host state
    carries the absolute time, so partials combine across segments in time
    order (ties keep the earlier partial)."""

    def __init__(self, spec, vtype: ValueType, is_last: bool,
                 time_field: Optional[str] = None):
        super().__init__(spec)
        self.vtype = vtype
        self.is_last = is_last
        # a rolled-up segment's pair column __ft_<field> (absolute int64
        # event times) orders the rows where present, else __time does
        self.time_field = time_field

    def signature(self):
        return (f"{'last' if self.is_last else 'first'}"
                f"({self.spec.field},{self.vtype.value},"
                f"pt={self.time_field or ''})")

    @property
    def _ident(self):
        return INT64_MIN if self.is_last else INT64_MAX

    def update(self, cols, mask, keys, num):
        dev = keys.device
        pair = self.time_field is not None and self.time_field in cols
        if self.spec.field not in cols:
            # no row has a value: host_post gives every group the empty
            # state's time
            return (torch.zeros(num, dtype=torch.int32, device=dev),
                    torch.from_numpy(self.empty_state(num)["value"]).to(dev),
                    torch.zeros(num, dtype=torch.bool, device=dev))
        t = cols[self.time_field].to(torch.int64) if pair \
            else cols["__time_offset"]
        v = cols[self.spec.field]
        n = t.shape[0]
        info = torch.iinfo(t.dtype)
        ident_t = info.min if self.is_last else info.max
        red = "amax" if self.is_last else "amin"
        tbest = _seg_reduce(torch.where(mask, t, ident_t), keys, num, red)
        cand = mask & (t == tbest[keys])
        idx = torch.where(cand, torch.arange(n, dtype=torch.int32,
                                             device=dev), n)
        best = _seg_reduce(idx, keys, num, "amin")
        has = best < n
        val = torch.where(has, v[best.clamp(0, n - 1).to(torch.int64)],
                          torch.zeros((), dtype=v.dtype, device=dev))
        return torch.where(has, tbest, ident_t), val, has

    def host_post(self, state, segment):
        t, v, has = (s.cpu().numpy() for s in state)
        t_abs = t.astype(np.int64)
        if self.time_field is None:
            t_abs = t_abs + segment.interval.start
        return {"time": np.where(has, t_abs, self._ident), "value": v,
                "has": has}

    def device_post(self, state, time0):
        # absolute int64 time before segments of other origins combine
        t, v, has = state
        t64 = t.to(torch.int64)
        if self.time_field is None:
            t64 = t64 + time0
        return torch.where(has, t64, int(self._ident)), v, has

    def device_combine(self, a, b):
        at, av, ah = a
        bt, bv, bh = b
        if self.is_last:
            take_b = (bt > at) | (~ah & bh)
        else:
            take_b = (bt < at) | (~ah & bh)
        return (torch.where(take_b, bt, at), torch.where(take_b, bv, av),
                ah | bh)

    def host_from_device(self, state):
        t, v, has = (s.cpu().numpy() for s in state)
        return {"time": t, "value": v, "has": has}

    def combine(self, a, b):
        if self.is_last:
            take_b = (b["time"] > a["time"]) | (~a["has"] & b["has"])
        else:
            take_b = (b["time"] < a["time"]) | (~a["has"] & b["has"])
        return {"time": np.where(take_b, b["time"], a["time"]),
                "value": np.where(take_b, b["value"], a["value"]),
                "has": a["has"] | b["has"]}

    def empty_state(self, n):
        return {"time": np.full(n, self._ident, dtype=np.int64),
                "value": np.zeros(n, dtype=self.vtype.numpy_dtype),
                "has": np.zeros(n, dtype=bool)}

    def finalize_array(self, state):
        return np.where(state["has"], state["value"], 0)


class FilteredKernel(AggKernel):
    """A delegate kernel over the rows that also pass its own filter tree
    (None: the filter folded to always-true)."""

    def __init__(self, spec: A.FilteredAggregator, child: AggKernel,
                 filter_node: Optional[FilterNode]):
        super().__init__(spec)
        self.child = child
        self.filter_node = filter_node
        self.reduce_kind = child.reduce_kind

    def signature(self):
        f = "none" if self.filter_node is None \
            else self.filter_node.signature()
        return f"filtered({f},{self.child.signature()})"

    def aux_arrays(self):
        own = [] if self.filter_node is None \
            else self.filter_node.aux_arrays()
        return own + self.child.aux_arrays()

    def filter_trees(self):
        own = [] if self.filter_node is None else [self.filter_node]
        return own + self.child.filter_trees()

    def required_device_columns(self):
        child = self.child.required_device_columns()
        if child is None:
            child = set(self.spec.delegate.required_columns())
        if self.filter_node is None:
            return child
        return child | self.filter_node.required_device_columns()

    def update(self, cols, mask, keys, num):
        if self.filter_node is not None:
            mask = mask & self.filter_node.build(cols)
        return self.child.update(cols, mask, keys, num)

    def host_post(self, state, segment):
        return self.child.host_post(state, segment)

    def device_post(self, state, time0):
        return self.child.device_post(state, time0)

    def device_combine(self, a, b):
        return self.child.device_combine(a, b)

    def host_from_device(self, state):
        return self.child.host_from_device(state)

    def combine(self, a, b):
        return self.child.combine(a, b)

    def empty_state(self, n):
        return self.child.empty_state(n)

    def finalize_array(self, state):
        return self.child.finalize_array(state)


class HllKernel(AggKernel):
    """cardinality and hyperUnique: each row's (register, rho) scatter-maxed
    into an int32 [G, 2^log2m] grid (engine/hll.py). A dimension gathers
    host-hashed tables by id; a numeric column (and __time, which hashes
    its int32 offset from the segment's interval start, as the reference
    does) hashes on the device; a complex column's register rows max in
    directly. byRow folds the row's field hashes into one."""

    reduce_kind = "max"

    def __init__(self, spec, fields: Sequence[str], segment: Segment,
                 log2m: int, by_row: bool):
        super().__init__(spec)
        self.fields = tuple(fields)
        self.log2m = log2m
        self.by_row = by_row
        self._tables = []
        for f in self.fields:
            col = segment.dims.get(f)
            met = segment.metrics.get(f)
            if col is not None:
                if by_row:
                    tbl = segment.aux_cached(
                        ("hll_hash", f),
                        lambda c=col: hll.dim_hash_table(c.dictionary))
                    self._tables.append(("dim_hash", f, (tbl,)))
                else:
                    tbls = segment.aux_cached(
                        ("hll_regrho", f, log2m),
                        lambda c=col: hll.dim_register_tables(c.dictionary,
                                                              log2m))
                    self._tables.append(("dim_regrho", f, tbls))
            elif met is not None and met.type is ValueType.COMPLEX:
                if by_row:
                    raise ValueError(
                        f"byRow cardinality cannot consume pre-aggregated "
                        f"hyperUnique column {f!r}; use hyperUnique instead")
                if met.values.shape[1] != (1 << log2m):
                    raise ValueError(
                        f"hyperUnique column {f!r} has {met.values.shape[1]} "
                        f"registers, query expects {1 << log2m}")
                self._tables.append(("complex", f, ()))
            elif met is not None or f == "__time":
                self._tables.append(("numeric", f, ()))
            else:
                self._tables.append(("missing", f, ()))

    def signature(self):
        kinds = ",".join(f"{k}:{f}" for k, f, _ in self._tables)
        return f"hll({self.log2m},{self.by_row},{kinds})"

    def aux_arrays(self):
        return [t for kind, _, tables in self._tables
                if kind in ("dim_hash", "dim_regrho") for t in tables]

    @staticmethod
    def _gather(tables, ids: torch.Tensor):
        """The host tables (uint64 hashes as their int64 bits) gathered by
        dictionary id on the ids' device."""
        idx = ids.to(torch.int64)
        return [torch.from_numpy(t.view(np.int64) if t.dtype == np.uint64
                                 else t).to(ids.device)[idx]
                for t in tables]

    @staticmethod
    def _field(cols, f: str) -> torch.Tensor:
        return cols["__time_offset"] if f == "__time" else cols[f]

    def update(self, cols, mask, keys, num):
        m = 1 << self.log2m
        if self.by_row:
            h = None
            for kind, f, tables in self._tables:
                if kind == "dim_hash":
                    hf, = self._gather(tables, cols[f])
                elif kind == "numeric":
                    hf = hll.hash_numeric(self._field(cols, f))
                else:
                    continue
                h = hf if h is None else hll.splitmix64(h * 31 + hf)
            if h is None:
                h = torch.zeros(mask.shape, dtype=torch.int64,
                                device=mask.device)
            reg, rho = hll.register_of(h, self.log2m)
            return hll.update_registers(None, rho, reg, keys, mask, num,
                                        self.log2m)
        regs = None
        for kind, f, tables in self._tables:
            if kind == "complex":
                # register rows max in; a group without rows holds int32's
                # least value, as the reference's segment_max leaves it
                rows = torch.where(mask[:, None], cols[f].to(torch.int32), 0)
                part = torch.full((num, m), INT32_MIN, dtype=torch.int32,
                                  device=rows.device).scatter_reduce_(
                    0, keys[:, None].expand(-1, m), rows, "amax")
                regs = part if regs is None else torch.maximum(regs, part)
                continue
            if kind == "dim_regrho":
                reg, rho = self._gather(tables, cols[f])
            elif kind == "numeric":
                reg, rho = hll.register_of(
                    hll.hash_numeric(self._field(cols, f)), self.log2m)
            else:
                continue
            regs = hll.update_registers(regs, rho, reg, keys, mask, num,
                                        self.log2m)
        if regs is None:
            regs = torch.zeros((num, m), dtype=torch.int32,
                               device=keys.device)
        return regs

    def combine(self, a, b):
        return np.maximum(a, b)

    def empty_state(self, n):
        return np.zeros((n, 1 << self.log2m), dtype=np.int32)

    def finalize_array(self, state):
        est = hll.estimate_array(state, self.log2m)
        if self.spec.round:
            est = np.rint(est).astype(np.int64)
        return est


# extension kernels: spec class -> factory(spec, segment)
_EXTENSION_KERNELS: Dict[type, Callable] = {}


def register_kernel(spec_cls: type, factory: Callable) -> None:
    _EXTENSION_KERNELS[spec_cls] = factory


def fold_contract_missing(kernel: AggKernel) -> List[str]:
    """The methods of contracts.AGG_FOLD_REQUIRED a kernel whose
    reduce_kind is "fold" leaves to AggKernel's stubs ([] when it keeps the
    contract, or does not fold)."""
    if kernel.reduce_kind != "fold":
        return []
    return [m for m in AGG_FOLD_REQUIRED
            if getattr(type(kernel), m) is getattr(AggKernel, m)]


def make_kernel(spec: A.AggregatorSpec, segment: Segment,
                device_bitmap: Optional[bool] = None) -> AggKernel:
    """`device_bitmap` plans a filtered aggregator's filter: None follows
    the process default (filters.device_bitmap_enabled), so its
    bitmap-eligible subtrees read staged or fused words like the query
    filter's. A kernel that folds without the methods the fold needs is
    refused (contracts.AGG_FOLD_REQUIRED)."""
    kernel = _make_kernel(spec, segment, device_bitmap)
    missing = fold_contract_missing(kernel)
    if missing:
        raise TypeError(f"{type(kernel).__name__} folds (reduce_kind "
                        f"'fold') without {missing}")
    return kernel


def _make_kernel(spec: A.AggregatorSpec, segment: Segment,
                 device_bitmap: Optional[bool]) -> AggKernel:
    factory = _EXTENSION_KERNELS.get(type(spec))
    if factory is not None:
        return factory(spec, segment)
    if isinstance(spec, A.CountAggregator):
        return CountKernel(spec)
    sums = {A.LongSumAggregator: ValueType.LONG,
            A.DoubleSumAggregator: ValueType.DOUBLE,
            A.FloatSumAggregator: ValueType.FLOAT}
    if type(spec) in sums:
        return SumKernel(spec, sums[type(spec)], segment)
    minmax = {A.LongMinAggregator: (ValueType.LONG, False),
              A.LongMaxAggregator: (ValueType.LONG, True),
              A.DoubleMinAggregator: (ValueType.DOUBLE, False),
              A.DoubleMaxAggregator: (ValueType.DOUBLE, True),
              A.FloatMinAggregator: (ValueType.FLOAT, False),
              A.FloatMaxAggregator: (ValueType.FLOAT, True)}
    if type(spec) in minmax:
        return MinMaxKernel(spec, *minmax[type(spec)], segment)
    if isinstance(spec, (A.FirstAggregator, A.LastAggregator)):
        tf = f"__ft_{spec.field}"
        return FirstLastKernel(spec, ValueType(spec.kind),
                               isinstance(spec, A.LastAggregator),
                               tf if tf in segment.metrics else None)
    if isinstance(spec, A.FilteredAggregator):
        child = make_kernel(spec.delegate, segment,
                            device_bitmap=device_bitmap)
        return FilteredKernel(spec, child, plan_filter(
            spec.filter, segment, device_bitmap=device_bitmap))
    if isinstance(spec, A.HyperUniqueAggregator):
        return HllKernel(spec, (spec.field,), segment, spec.log2m,
                         by_row=False)
    if isinstance(spec, A.CardinalityAggregator):
        return HllKernel(spec, spec.fields, segment, spec.log2m, spec.by_row)
    raise ValueError(f"no kernel for aggregator {type(spec).__name__}")
