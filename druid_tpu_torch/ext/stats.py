"""variance and stddev.

The port of the reference package's `ext/stats.py` (Druid's
extensions-core/stats). The device state is (n int64, sum float64, sumsq
float64), three scatter-adds in one pass; `host_post` gives the
reference's dict {"n", "sum", "sumsq"}, combined by adding, and the
population or sample variance is computed on the host. The float64 sums
go through `index_add_`, whose order of additions is not fixed, so they
agree with the reference's within rounding, not bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from druid_tpu_torch.engine.kernels import (AggKernel, _seg_sum,
                                            register_kernel)
from druid_tpu_torch.query.aggregators import (AggregatorSpec,
                                               register_aggregator)
from druid_tpu_torch.query.postaggs import PostAggregator, register_postagg


@dataclass(frozen=True)
class VarianceAggregator(AggregatorSpec):
    name: str
    field: str
    estimator: str = "population"   # population | sample

    def combining(self):
        return VarianceAggregator(self.name, self.name, self.estimator)

    def to_json(self):
        return {"type": "variance", "name": self.name,
                "fieldName": self.field, "estimator": self.estimator}


class VarianceKernel(AggKernel):
    reduce_kind = "sum"

    def __init__(self, spec: VarianceAggregator, segment):
        super().__init__(spec)
        self.field = spec.field
        self.sample = spec.estimator == "sample"
        if self.field in segment.dims:
            raise ValueError(
                f"variance over string dimension {self.field!r} — it would "
                f"aggregate dictionary ids, not values")

    def signature(self):
        return f"variance({self.field},{self.sample})"

    def update(self, cols, mask, keys, num):
        v = cols[self.field] if self.field != "__time" \
            else cols["__time_offset"]
        vm = torch.where(mask, v.to(torch.float64), 0.0)
        return (_seg_sum(mask.to(torch.int64), keys, num),
                _seg_sum(vm, keys, num), _seg_sum(vm * vm, keys, num))

    def host_post(self, state, segment):
        n, s, ss = (t.cpu().numpy() for t in state)
        return {"n": n, "sum": s, "sumsq": ss}

    def combine(self, a, b):
        return {k: a[k] + b[k] for k in a}

    def empty_state(self, n):
        return {"n": np.zeros(n, dtype=np.int64),
                "sum": np.zeros(n, dtype=np.float64),
                "sumsq": np.zeros(n, dtype=np.float64)}

    def finalize_array(self, state):
        n = np.asarray(state["n"], dtype=np.float64)
        s = np.asarray(state["sum"])
        ss = np.asarray(state["sumsq"])
        denom = np.maximum(n - (1.0 if self.sample else 0.0), 1.0)
        var = np.maximum(ss - s * s / np.maximum(n, 1.0), 0.0) / denom
        return np.where(n > 0, var, 0.0)


@dataclass(frozen=True)
class StandardDeviationPostAgg(PostAggregator):
    """The square root of a variance field (Druid's stats extension
    StandardDeviationPostAggregator)."""
    name: str
    field: str

    def compute(self, row):
        v = row.get(self.field)
        return np.sqrt(np.maximum(np.asarray(v, dtype=np.float64), 0.0)) \
            if v is not None else None

    def to_json(self):
        return {"type": "stddev", "name": self.name, "fieldName": self.field}


register_aggregator(
    "variance",
    lambda j: VarianceAggregator(j["name"], j["fieldName"],
                                 j.get("estimator", "population")))
register_kernel(VarianceAggregator, VarianceKernel)
register_postagg("stddev",
                 lambda j: StandardDeviationPostAgg(j["name"], j["fieldName"]))
