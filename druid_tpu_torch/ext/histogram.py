"""approxHistogram: an equal-width bucket grid over [lowerLimit,
upperLimit) with the exact min and max, and its quantile post-aggregator.

The port of the reference package's `ext/histogram.py` (Druid's
extensions-core/histogram). Counts are one scatter-add into a [groups,
buckets] grid; min and max scatter-reduce; combine adds and takes the
min/max. A row's bucket is trunc((x - lower) / width) clipped to the grid,
with the reference's cast: XLA converts float to int32 saturating (NaN to
0), where torch on the CPU leaves an out-of-range cast undefined (x86
gives INT32_MIN). So the quotient is clamped in float64 to [-1, buckets]
first, NaN to 0, and only then truncated: the same bucket on every device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from druid_tpu_torch.engine.kernels import (AggKernel, _seg_max, _seg_min,
                                            _seg_sum, register_kernel)
from druid_tpu_torch.query.aggregators import (AggregatorSpec,
                                               register_aggregator)
from druid_tpu_torch.query.postaggs import (PostAggregator,
                                            postagg_from_json,
                                            register_postagg)


class HistogramValue:
    __slots__ = ("counts", "min", "max", "lower", "upper")

    def __init__(self, counts: np.ndarray, vmin: float, vmax: float,
                 lower: float, upper: float):
        self.counts = np.asarray(counts, dtype=np.int64)
        self.min = float(vmin)
        self.max = float(vmax)
        self.lower = lower
        self.upper = upper

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def quantile(self, q: float) -> float:
        total = self.counts.sum()
        if total == 0:
            return float("nan")
        b = len(self.counts)
        width = (self.upper - self.lower) / b
        target = q * total
        cdf = np.concatenate([[0], np.cumsum(self.counts)])
        i = int(np.searchsorted(cdf, target, side="left"))
        i = max(1, min(i, b))
        # linear interpolation within bucket i-1
        prev, cur = cdf[i - 1], cdf[i]
        frac = 0.0 if cur == prev else (target - prev) / (cur - prev)
        v = self.lower + (i - 1 + frac) * width
        return float(np.clip(v, self.min, self.max))

    def to_json(self) -> dict:
        b = len(self.counts)
        width = (self.upper - self.lower) / b
        breaks = [self.lower + i * width for i in range(b + 1)]
        return {"breaks": breaks, "counts": self.counts.tolist(),
                "min": self.min, "max": self.max}

    def __repr__(self):
        return f"HistogramValue(n={self.count}, [{self.min}, {self.max}])"


@dataclass(frozen=True)
class ApproximateHistogramAggregator(AggregatorSpec):
    name: str
    field: str
    num_buckets: int = 64
    lower_limit: float = 0.0
    upper_limit: float = 1.0

    def combining(self):
        return ApproximateHistogramAggregator(
            self.name, self.name, self.num_buckets, self.lower_limit,
            self.upper_limit)

    def to_json(self):
        return {"type": "approxHistogram", "name": self.name,
                "fieldName": self.field, "numBuckets": self.num_buckets,
                "lowerLimit": self.lower_limit, "upperLimit": self.upper_limit}


def bucket_of(x: torch.Tensor, lower: float, width: float,
              b: int) -> torch.Tensor:
    """int64 buckets of float64 `x`: trunc((x - lower) / width) clipped to
    [0, b - 1], with XLA's saturating float-to-int32 cast (NaN -> 0)."""
    q = torch.nan_to_num((x - lower) / width, nan=0.0).clamp(-1.0, float(b))
    return q.to(torch.int64).clamp(0, b - 1)


class HistogramKernel(AggKernel):
    reduce_kind = "fold"

    def __init__(self, spec: ApproximateHistogramAggregator, segment):
        super().__init__(spec)
        self.field = spec.field
        self.b = spec.num_buckets
        self.lower = spec.lower_limit
        self.upper = spec.upper_limit

    def signature(self):
        return f"hist({self.field},{self.b},{self.lower},{self.upper})"

    def update(self, cols, mask, keys, num):
        v = cols[self.field] if self.field != "__time" \
            else cols["__time_offset"]
        x = v.to(torch.float64)
        width = (self.upper - self.lower) / self.b
        flat = keys * self.b + bucket_of(x, self.lower, width, self.b)
        counts = _seg_sum(mask.to(torch.int32), flat, num * self.b) \
            .view(num, self.b)
        big = float(np.finfo(np.float64).max)
        return (counts, _seg_min(torch.where(mask, x, big), keys, num),
                _seg_max(torch.where(mask, x, -big), keys, num))

    def host_post(self, state, segment):
        counts, mn, mx = (t.cpu().numpy() for t in state)
        # keys in sorted order, as the reference's states come back from
        # the device, so both packages write the same wire bytes
        return {"counts": counts, "max": mx, "min": mn}

    def combine(self, a, b):
        return {"counts": a["counts"] + b["counts"],
                "min": np.minimum(a["min"], b["min"]),
                "max": np.maximum(a["max"], b["max"])}

    def empty_state(self, n):
        big = np.finfo(np.float64).max
        return {"counts": np.zeros((n, self.b), dtype=np.int64),
                "min": np.full(n, big), "max": np.full(n, -big)}

    def finalize_array(self, state):
        counts = np.asarray(state["counts"], dtype=np.int64)
        out = np.empty(counts.shape[0], dtype=object)
        for i in range(counts.shape[0]):
            out[i] = HistogramValue(counts[i], state["min"][i],
                                    state["max"][i], self.lower, self.upper)
        return out


@dataclass(frozen=True)
class HistogramQuantilePostAgg(PostAggregator):
    """A quantile of a histogram field (Druid's histogram extension
    QuantilePostAggregator)."""
    name: str
    field: PostAggregator = None
    probability: float = 0.5

    def compute(self, row):
        v = self.field.compute(row)
        if isinstance(v, np.ndarray):
            return np.asarray([x.quantile(self.probability) for x in v])
        return v.quantile(self.probability)

    def to_json(self):
        return {"type": "quantile", "name": self.name,
                "field": self.field.to_json(),
                "probability": self.probability}


register_aggregator(
    "approxHistogram",
    lambda j: ApproximateHistogramAggregator(
        j["name"], j["fieldName"], j.get("numBuckets", 64),
        j.get("lowerLimit", 0.0), j.get("upperLimit", 1.0)))
register_kernel(ApproximateHistogramAggregator, HistogramKernel)
register_postagg(
    "quantile",
    lambda j: HistogramQuantilePostAgg(j["name"],
                                       postagg_from_json(j["field"]),
                                       j["probability"]))
