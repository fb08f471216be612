"""Aggregation kernels: one aggregator's grouped update, combine and finalize.

The port's counterpart of the reference package's `engine/kernels.py`
(CountKernel, SumKernel, MinMaxKernel). `update` is the plain scatter
strategy: `index_add_` for counts and sums, `scatter_reduce` for min/max, in
place of the reference's `segment_sum/min/max`. Long sums accumulate in
int64 and are exact. `pallas_op` describes the kernel to the sorted-
projection reduction (engine/sorted_reduce.py) with the reference's op
vocabulary, and `blocked_supported` carries the reference's eligibility so
both packages pick the projection strategy for the same plans.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from druid_tpu_torch.data.segment import Segment, ValueType
from druid_tpu_torch.query import aggregators as A

INT64_MAX = np.int64(2**63 - 1)
INT64_MIN = np.int64(-(2**63))

_TORCH = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
          np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64}


class AggKernel:
    """One aggregator's device update + host combine/finalize."""

    def __init__(self, spec: A.AggregatorSpec):
        self.spec = spec
        self.name = spec.name

    def update(self, cols: Dict[str, torch.Tensor], mask: torch.Tensor,
               keys: torch.Tensor, num: int) -> torch.Tensor:
        """Per-group partial state [num]; `keys` int64 in [0, num)."""
        raise NotImplementedError

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

    def blocked_supported(self, cols_avail: Dict) -> bool:
        return False

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


class SumKernel(AggKernel):
    _DTYPES = {ValueType.LONG: np.dtype(np.int64),
               ValueType.FLOAT: np.dtype(np.float32),
               ValueType.DOUBLE: np.dtype(np.float64)}

    def __init__(self, spec, vtype: ValueType,
                 segment: Optional[Segment] = None):
        super().__init__(spec)
        self.vtype = vtype
        # the reference's chunk bound for int32-staged long sums: rows per
        # chunk such that a chunk's per-group partial stays below 2^30. The
        # port sums in int64 and needs no chunking; the value only carries
        # the reference's eligibility rules (blocked / sum_i32).
        self.chunk_rows = 0
        if vtype is ValueType.LONG and segment is not None \
                and spec.field in segment.metrics \
                and segment.staged_dtype(spec.field) == np.int32:
            lo, hi = segment.column_minmax(spec.field)
            r = (2 ** 30) // max(abs(lo), abs(hi), 1)
            self.chunk_rows = 1 << (r.bit_length() - 1) if r >= 1024 else 0

    def pallas_op(self, cols_avail):
        f = self.spec.field
        if f not in cols_avail:
            return ("zero",)
        dt = str(cols_avail[f])
        if self.vtype is ValueType.FLOAT and dt == "float32":
            return ("sum_f32", f)
        if self.vtype is ValueType.LONG and dt == "int32" \
                and self.chunk_rows >= 2048:
            return ("sum_i32", f, self.chunk_rows)
        return None

    def update(self, cols, mask, keys, num):
        dt = _TORCH[self._DTYPES[self.vtype]]
        out = torch.zeros(num, dtype=dt, device=keys.device)
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
        if self.spec.field not in cols_avail:
            return True
        if self.vtype is ValueType.FLOAT:
            return True
        return self.chunk_rows >= 2048


class MinMaxKernel(AggKernel):
    def __init__(self, spec, vtype: ValueType, is_max: bool):
        super().__init__(spec)
        self.vtype = vtype
        self.is_max = is_max

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
        if v.dtype.is_floating_point:
            ident = -float("inf") if self.is_max else float("inf")
        else:
            info = torch.iinfo(v.dtype)
            ident = info.min if self.is_max else info.max
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
