"""The datasketches HLL sketch types over the HLL register kernel.

The port of the reference package's `ext/hllsketch.py` (Druid's
extensions-core/datasketches hll: HLLSketchBuild, HLLSketchMerge and
HLLSketchToEstimate). The aggregators subclass the port's
HyperUniqueAggregator, so `make_kernel` gives them `HllKernel`, with lgK
as its log2m (default 12).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from druid_tpu_torch.query.aggregators import (HyperUniqueAggregator,
                                               register_aggregator)
from druid_tpu_torch.query.postaggs import (PostAggregator,
                                            postagg_from_json,
                                            register_postagg)


@dataclass(frozen=True)
class HLLSketchBuildAggregator(HyperUniqueAggregator):
    """A sketch built from a raw column."""

    def to_json(self):
        return {"type": "HLLSketchBuild", "name": self.name,
                "fieldName": self.field, "lgK": self.log2m,
                "round": self.round}


@dataclass(frozen=True)
class HLLSketchMergeAggregator(HyperUniqueAggregator):
    """Sketch columns merged; a register column and a raw column share the
    kernel, as in the reference."""

    def to_json(self):
        return {"type": "HLLSketchMerge", "name": self.name,
                "fieldName": self.field, "lgK": self.log2m,
                "round": self.round}


@dataclass(frozen=True)
class HLLSketchToEstimatePostAgg(PostAggregator):
    name: str
    field: PostAggregator = None
    round: bool = False

    def compute(self, row):
        v = self.field.compute(row)
        if isinstance(v, np.ndarray):
            out = np.asarray([float(x) if x is not None else 0.0
                              for x in v])
            return np.round(out) if self.round else out
        if v is None:
            return None
        return round(float(v)) if self.round else float(v)

    def to_json(self):
        return {"type": "HLLSketchToEstimate", "name": self.name,
                "field": self.field.to_json(), "round": self.round}


def _mk(cls):
    def from_json(j):
        return cls(j["name"], j["fieldName"], log2m=int(j.get("lgK", 12)),
                   round=bool(j.get("round", False)))
    return from_json


register_aggregator("HLLSketchBuild", _mk(HLLSketchBuildAggregator))
register_aggregator("HLLSketchMerge", _mk(HLLSketchMergeAggregator))
register_postagg(
    "HLLSketchToEstimate",
    lambda j: HLLSketchToEstimatePostAgg(
        j["name"], postagg_from_json(j["field"]),
        bool(j.get("round", False))))
