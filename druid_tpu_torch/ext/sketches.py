"""Datasketches: theta (distinct counts with set operations) and quantiles.

The port of the reference package's `ext/sketches.py` (Druid's
extensions-core/datasketches), with the reference's reformulations:

  Theta is a one-permutation min-hash: B buckets, each keeping the least
  normalized 64-bit hash that lands in it (a scatter-min; combine is the
  elementwise min, an exact union). A dimension hashes its dictionary on
  the host (`engine/hll.dim_hash_table`) and gathers by id; a numeric
  column hashes on the device (`engine/hll.hash_numeric`). The uint64
  arithmetic runs on int64 bits: the bucket is the unsigned remainder of
  the hash by B, which need not be a power of two, and the fraction the
  hash's top 32 bits, shifted logically. An empty bucket reads 1.0.

  Quantiles are log-bucketed counts (DDSketch-style): bucket(x) =
  round(log|x| / log gamma) in float64 (half to even), clipped to +-E and
  mirrored by sign, with a zero bucket; counts are an exact integer
  scatter-add into [groups, NUM_BUCKETS]. Quantiles walk the CDF on the
  host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from druid_tpu_torch.engine import hll as hll_mod
from druid_tpu_torch.engine.kernels import (AggKernel, HllKernel, _seg_min,
                                            _seg_sum, register_kernel)
from druid_tpu_torch.query.aggregators import (AggregatorSpec,
                                               register_aggregator)
from druid_tpu_torch.query.postaggs import (PostAggregator,
                                            postagg_from_json,
                                            register_postagg)

# ---------------------------------------------------------------------------
# Theta
# ---------------------------------------------------------------------------

DEFAULT_THETA_SIZE = 4096


class ThetaSketchValue:
    """Mergeable min-hash sketch value (bucket minima in [0, 1]; 1.0 =
    empty bucket)."""

    __slots__ = ("mins",)

    def __init__(self, mins: np.ndarray):
        self.mins = np.asarray(mins, dtype=np.float64)

    @property
    def estimate(self) -> float:
        """Censored-exponential MLE. Per bucket, the min of k uniforms is
        about Exp(k) truncated at 1 (empty buckets read 1.0), so with
        lambda = n/B, E[m] = (1 - e^-lambda)/lambda. Invert sum(m)/B for
        lambda by bisection; n = lambda * B."""
        b = float(len(self.mins))
        r = float(self.mins.sum()) / b
        if r >= 1.0 - 1e-12:
            return 0.0
        lo, hi = 1e-9, 1e9
        for _ in range(100):
            mid = (lo + hi) / 2 if hi < 1e8 else min(lo * 2, hi)
            val = (1.0 - math.exp(-mid)) / mid
            if val > r:
                lo = mid
            else:
                hi = mid
            if hi - lo < 1e-9 * max(1.0, lo):
                break
        return lo * b

    def union(self, other: "ThetaSketchValue") -> "ThetaSketchValue":
        return ThetaSketchValue(np.minimum(self.mins, other.mins))

    def jaccard(self, other: "ThetaSketchValue") -> float:
        both = (self.mins < 1.0) | (other.mins < 1.0)
        if not both.any():
            return 0.0
        agree = (self.mins == other.mins) & both
        return float(agree.sum()) / float(both.sum())

    def intersect_estimate(self, other: "ThetaSketchValue") -> float:
        u = self.union(other)
        return self.jaccard(other) * u.estimate

    def __repr__(self):
        return f"ThetaSketchValue(estimate~{self.estimate:.1f})"

    def __float__(self):
        return self.estimate


@dataclass(frozen=True)
class ThetaSketchAggregator(AggregatorSpec):
    name: str
    field: str
    size: int = DEFAULT_THETA_SIZE
    should_finalize: bool = True   # True: the estimate; False: the sketch

    def combining(self):
        return ThetaSketchAggregator(self.name, self.name, self.size,
                                     self.should_finalize)

    def to_json(self):
        return {"type": "thetaSketch", "name": self.name,
                "fieldName": self.field, "size": self.size,
                "shouldFinalize": self.should_finalize}


def _unsigned_mod(h: torch.Tensor, size: int) -> torch.Tensor:
    """The remainder of int64 bits `h`, read as uint64, by `size` < 2^62:
    a negative h stands for h + 2^64, and torch's `%` is non-negative for
    a positive divisor."""
    return (h % size + torch.where(h < 0, (1 << 64) % size, 0)) % size


class ThetaKernel(AggKernel):
    reduce_kind = "min"

    def __init__(self, spec: ThetaSketchAggregator, segment):
        super().__init__(spec)
        self.field = spec.field
        self.size = spec.size
        col = segment.dims.get(self.field)
        self._numeric = col is None
        if col is not None:
            h = segment.aux_cached(
                ("hll_hash", self.field),
                lambda: hll_mod.dim_hash_table(col.dictionary))
            self._bucket_tbl = (h % np.uint64(self.size)).astype(np.int32)
            frac = (h >> np.uint64(32)).astype(np.float64) / float(2 ** 32)
            self._frac_tbl = np.maximum(frac, 1e-12)

    def signature(self):
        return f"theta({self.field},{self.size},{self._numeric})"

    def aux_arrays(self):
        if self._numeric:
            return []
        return [self._bucket_tbl, self._frac_tbl]

    def update(self, cols, mask, keys, num):
        if self._numeric:
            v = cols[self.field] if self.field != "__time" \
                else cols["__time_offset"]
            h = hll_mod.hash_numeric(v)
            bucket = _unsigned_mod(h, self.size)
            frac = (hll_mod._shr(h, 32).to(torch.float64)
                    / float(2 ** 32)).clamp_min(1e-12)
        else:
            bucket, frac = HllKernel._gather(
                (self._bucket_tbl, self._frac_tbl), cols[self.field])
        flat = keys * self.size + bucket
        mins = _seg_min(torch.where(mask, frac, 1.0), flat, num * self.size)
        # a bucket no row reached holds +inf: it reads as empty, 1.0
        return mins.clamp_max(1.0).view(num, self.size)

    def combine(self, a, b):
        return np.minimum(a, b)

    def empty_state(self, n):
        return np.ones((n, self.size), dtype=np.float64)

    def finalize_array(self, state):
        arr = np.asarray(state, dtype=np.float64)
        out = np.empty(arr.shape[0], dtype=object)
        for i in range(arr.shape[0]):
            sk = ThetaSketchValue(arr[i])
            out[i] = round(sk.estimate) if self.spec.should_finalize else sk
        return out


@dataclass(frozen=True)
class ThetaSketchEstimatePostAgg(PostAggregator):
    name: str
    field: PostAggregator = None

    def compute(self, row):
        v = self.field.compute(row)
        if isinstance(v, np.ndarray):
            return np.asarray([float(x) if x is not None else 0.0
                               for x in v])
        return float(v) if v is not None else None

    def to_json(self):
        return {"type": "thetaSketchEstimate", "name": self.name,
                "field": self.field.to_json()}


@dataclass(frozen=True)
class ThetaSketchSetOpPostAgg(PostAggregator):
    """UNION, INTERSECT or NOT over sketch-valued fields, giving an
    estimate (as the reference's: it finalizes directly)."""
    name: str
    func: str                     # UNION | INTERSECT | NOT
    fields: Tuple[PostAggregator, ...] = ()

    @staticmethod
    def _sketches(vals):
        for v in vals:
            if not isinstance(v, ThetaSketchValue):
                raise TypeError(
                    "thetaSketchSetOp needs sketch inputs — set "
                    "shouldFinalize=false on the theta aggregator")
        return list(vals)

    def compute(self, row):
        vals = [f.compute(row) for f in self.fields]
        if any(isinstance(v, np.ndarray) for v in vals):
            n = len(vals[0])
            return np.asarray([self._one([v[i] for v in vals])
                               for i in range(n)])
        return self._one(vals)

    def _one(self, vals):
        sks = self._sketches(vals)
        if self.func == "UNION":
            out = sks[0]
            for s in sks[1:]:
                out = out.union(s)
            return out.estimate
        if self.func == "INTERSECT":
            est = None
            base = sks[0]
            for s in sks[1:]:
                est = base.intersect_estimate(s) if est is None else min(
                    est, base.intersect_estimate(s))
            return est if est is not None else base.estimate
        if self.func == "NOT":
            # the subtrahends union first, so an overlap of two of them
            # inside the base is not subtracted twice
            base = sks[0]
            if len(sks) == 1:
                return base.estimate
            sub = sks[1]
            for s in sks[2:]:
                sub = sub.union(s)
            return max(base.estimate - base.intersect_estimate(sub), 0.0)
        raise ValueError(f"unknown set op {self.func!r}")

    def to_json(self):
        return {"type": "thetaSketchSetOp", "name": self.name,
                "func": self.func,
                "fields": [f.to_json() for f in self.fields]}


# ---------------------------------------------------------------------------
# Quantiles
# ---------------------------------------------------------------------------

# gamma = 1.05: ~2.4% relative value error; exponents +-E cover e^+-25.
# Bucket layout (ascending): [negative, mirrored | zero | positive], P
# buckets a sign.
GAMMA = 1.05
LOG_GAMMA = math.log(GAMMA)
E = 512
P = 2 * E + 1                     # buckets a sign (exponents -E..E)
NUM_BUCKETS = 2 * P + 1
ZERO_BUCKET = P


def _bucket_values() -> np.ndarray:
    """The value each bucket stands for."""
    exps = np.exp(np.arange(-E, E + 1) * LOG_GAMMA)    # gamma^idx
    out = np.zeros(NUM_BUCKETS)
    out[P + 1:] = exps                                  # positive ascending
    out[:P] = -exps[::-1]                               # negative ascending
    return out


_BUCKET_VALUES = _bucket_values()


class QuantilesSketchValue:
    __slots__ = ("counts",)

    def __init__(self, counts: np.ndarray):
        self.counts = np.asarray(counts, dtype=np.int64)

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def quantile(self, q: float) -> float:
        total = self.counts.sum()
        if total == 0:
            return float("nan")
        target = q * (total - 1)
        cdf = np.cumsum(self.counts)
        i = int(np.searchsorted(cdf, target, side="right"))
        i = min(i, NUM_BUCKETS - 1)
        return float(_BUCKET_VALUES[i])

    def quantiles(self, qs: Sequence[float]) -> list:
        return [self.quantile(q) for q in qs]

    def merge(self, other: "QuantilesSketchValue") -> "QuantilesSketchValue":
        return QuantilesSketchValue(self.counts + other.counts)

    def to_json(self) -> int:
        """The value in a JSON reply: the number of values the sketch has
        seen, as Druid finalizes a quantilesDoublesSketch
        (DoublesSketchAggregatorFactory.finalizeComputation). The
        reference's reply fails on it (ROADMAP §C)."""
        return self.count

    def __repr__(self):
        return f"QuantilesSketchValue(n={self.count})"


@dataclass(frozen=True)
class QuantilesSketchAggregator(AggregatorSpec):
    name: str
    field: str

    def combining(self):
        return QuantilesSketchAggregator(self.name, self.name)

    def to_json(self):
        return {"type": "quantilesDoublesSketch", "name": self.name,
                "fieldName": self.field}


def quantile_bucket(x: torch.Tensor) -> torch.Tensor:
    """int64 buckets of float64 `x` in [0, NUM_BUCKETS); NaN goes to the
    zero bucket, as in the reference."""
    idx = torch.round(torch.log(x.abs().clamp_min(1e-300)) / LOG_GAMMA) \
        .clamp(-E, E).nan_to_num(0.0).to(torch.int64)
    pos = P + 1 + (idx + E)            # [P+1, 2P]
    neg = P - 1 - (idx + E)            # [0, P-1], ascending with value
    return torch.where(x > 0, pos, torch.where(x < 0, neg, ZERO_BUCKET))


class QuantilesKernel(AggKernel):
    reduce_kind = "sum"

    def __init__(self, spec: QuantilesSketchAggregator, segment):
        super().__init__(spec)
        self.field = spec.field

    def signature(self):
        return f"quantiles({self.field})"

    def update(self, cols, mask, keys, num):
        v = cols[self.field] if self.field != "__time" \
            else cols["__time_offset"]
        flat = keys * NUM_BUCKETS + quantile_bucket(v.to(torch.float64))
        return _seg_sum(mask.to(torch.int32), flat, num * NUM_BUCKETS) \
            .view(num, NUM_BUCKETS)

    def host_post(self, state, segment):
        return state.cpu().numpy().astype(np.int64)

    def combine(self, a, b):
        return a + b

    def empty_state(self, n):
        return np.zeros((n, NUM_BUCKETS), dtype=np.int64)

    def finalize_array(self, state):
        arr = np.asarray(state, dtype=np.int64)
        out = np.empty(arr.shape[0], dtype=object)
        for i in range(arr.shape[0]):
            out[i] = QuantilesSketchValue(arr[i])
        return out


@dataclass(frozen=True)
class QuantilePostAgg(PostAggregator):
    """One quantile of a sketch field (Druid's
    DoublesSketchToQuantilePostAggregator)."""
    name: str
    field: PostAggregator = None
    fraction: float = 0.5

    def compute(self, row):
        v = self.field.compute(row)
        if isinstance(v, np.ndarray):
            return np.asarray([x.quantile(self.fraction) for x in v])
        return v.quantile(self.fraction)

    def to_json(self):
        return {"type": "quantilesDoublesSketchToQuantile", "name": self.name,
                "field": self.field.to_json(), "fraction": self.fraction}


@dataclass(frozen=True)
class QuantilesPostAgg(PostAggregator):
    """Several quantiles of a sketch field (Druid's
    DoublesSketchToQuantilesPostAggregator)."""
    name: str
    field: PostAggregator = None
    fractions: Tuple[float, ...] = ()

    def compute(self, row):
        v = self.field.compute(row)
        if isinstance(v, np.ndarray):
            return np.asarray([x.quantiles(self.fractions) for x in v],
                              dtype=object)
        return v.quantiles(self.fractions)

    def to_json(self):
        return {"type": "quantilesDoublesSketchToQuantiles",
                "name": self.name, "field": self.field.to_json(),
                "fractions": list(self.fractions)}


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

register_aggregator(
    "thetaSketch",
    lambda j: ThetaSketchAggregator(j["name"], j["fieldName"],
                                    j.get("size", DEFAULT_THETA_SIZE),
                                    j.get("shouldFinalize", True)))
register_kernel(ThetaSketchAggregator, ThetaKernel)
register_postagg(
    "thetaSketchEstimate",
    lambda j: ThetaSketchEstimatePostAgg(j["name"],
                                         postagg_from_json(j["field"])))
register_postagg(
    "thetaSketchSetOp",
    lambda j: ThetaSketchSetOpPostAgg(
        j["name"], j["func"],
        tuple(postagg_from_json(f) for f in j["fields"])))
register_aggregator(
    "quantilesDoublesSketch",
    lambda j: QuantilesSketchAggregator(j["name"], j["fieldName"]))
register_kernel(QuantilesSketchAggregator, QuantilesKernel)
register_postagg(
    "quantilesDoublesSketchToQuantile",
    lambda j: QuantilePostAgg(j["name"], postagg_from_json(j["field"]),
                              j["fraction"]))
register_postagg(
    "quantilesDoublesSketchToQuantiles",
    lambda j: QuantilesPostAgg(j["name"], postagg_from_json(j["field"]),
                               tuple(j["fractions"])))
