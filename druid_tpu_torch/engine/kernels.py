"""Aggregation kernels: one aggregator's grouped update, combine and finalize.

The port's counterpart of the reference package's `engine/kernels.py`
(CountKernel, SumKernel, MinMaxKernel). `update` is the plain scatter
strategy: `index_add_` for counts and sums, `scatter_reduce` for min/max, in
place of the reference's `segment_sum/min/max`. Long sums accumulate in
int64 and are exact. `pallas_op` describes the kernel to the sorted-
projection reduction (engine/sorted_reduce.py) with the reference's op
vocabulary. The blocked hooks (`blocked_supported/init/step/finish`) serve
the masked broadcast-reduce of the blocked and windowed strategies
(engine/grouping.py), and `mm_plan` the one-hot matmul of the mm strategy
(engine/mmagg.py). Every eligibility rule is the reference's, so both
packages choose the same strategy for the same plan.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from druid_tpu_torch.data.segment import Segment, ValueType
from druid_tpu_torch.query import aggregators as A

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

    #: how grid slots of one group combine: "sum", "min" or "max"
    reduce_kind = "sum"

    def __init__(self, spec: A.AggregatorSpec):
        self.spec = spec
        self.name = spec.name

    def update(self, cols: Dict[str, torch.Tensor], mask: torch.Tensor,
               keys: torch.Tensor, num: int) -> torch.Tensor:
        """Per-group partial state [num]; `keys` int64 in [0, num)."""
        raise NotImplementedError

    def required_device_columns(self) -> Optional[set]:
        """The staged columns `update` reads, where narrower than the
        aggregator's `required_columns()`; None = the aggregator's."""
        return None

    def host_post(self, state) -> np.ndarray:
        """Device state -> host combine-ready state."""
        return state.cpu().numpy() if isinstance(state, torch.Tensor) \
            else np.asarray(state)

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


class CountKernel(AggKernel):

    def pallas_op(self, cols_avail):
        return ("count",)

    def update(self, cols, mask, keys, num):
        return torch.zeros(num, dtype=torch.int64, device=keys.device) \
            .index_add_(0, keys, mask.to(torch.int64))

    def host_post(self, state):
        return super().host_post(state).astype(np.int64)

    def combine(self, a, b):
        return a + b

    def empty_state(self, n):
        return np.zeros(n, dtype=np.int64)

    def blocked_supported(self, cols_avail):
        return True

    def blocked_init(self, num, cols, device):
        return torch.zeros(num, dtype=torch.int64, device=device)

    def blocked_step(self, carry, cols_block, valid, num):
        return carry + torch.count_nonzero(valid, dim=-1)

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
        # and never stages; such a kernel stays off the mm, blocked and
        # sorted-projection strategies, as in the reference
        self.const_value: Optional[int] = None
        if vtype is ValueType.LONG and segment is not None \
                and spec.field in segment.metrics:
            lo, hi = segment.column_minmax(spec.field)
            if lo == hi:
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
    def __init__(self, spec, vtype: ValueType, is_max: bool):
        super().__init__(spec)
        self.vtype = vtype
        self.is_max = is_max
        self.reduce_kind = "max" if is_max else "min"

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

    def host_post(self, state):
        st = super().host_post(state)
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


def make_kernel(spec: A.AggregatorSpec, segment: Segment) -> AggKernel:
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
        return MinMaxKernel(spec, *minmax[type(spec)])
    raise NotImplementedError(f"no kernel for aggregator {type(spec).__name__}")
