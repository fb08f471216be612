"""distinctCount: the exact number of distinct values of a string
dimension per group, within one segment.

The port of the reference package's `ext/distinctcount.py` (Druid's
extensions-contrib/distinctcount). Across segments the per-segment counts
add, so the total is exact only when each value lives in one segment
(data partitioned on the dimension), as the contrib extension documents.
On the device, each live row sets its (group, id) cell of a [groups,
cardinality] presence grid (`kernels._presence`: every write is a 1, so no
order of writes changes the grid), and a row sum counts them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from druid_tpu_torch.engine.kernels import (AggKernel, _presence,
                                            register_kernel)
from druid_tpu_torch.query.aggregators import (AggregatorSpec,
                                               register_aggregator)

#: the presence grid's cell budget per segment (groups x cardinality)
MAX_CELLS = 1 << 24


@dataclass(frozen=True)
class DistinctCountAggregator(AggregatorSpec):
    name: str
    field: str

    def to_json(self):
        return {"type": "distinctCount", "name": self.name,
                "fieldName": self.field}


class DistinctCountKernel(AggKernel):
    reduce_kind = "sum"

    def __init__(self, spec: DistinctCountAggregator, segment):
        super().__init__(spec)
        self.field = spec.field
        if spec.field in segment.metrics:
            raise ValueError(
                f"distinctCount requires a string dimension; "
                f"[{spec.field}] is a metric (use thetaSketch)")
        dim = segment.dims.get(spec.field)
        # a segment without the dimension (schema evolution) contributes 0
        self.cardinality = dim.dictionary.cardinality if dim is not None \
            else 0

    def signature(self):
        return f"distinct({self.field},{self.cardinality})"

    def _check(self, num: int):
        if num * self.cardinality > MAX_CELLS:
            raise ValueError(
                f"distinctCount presence matrix {num}x{self.cardinality} "
                f"exceeds the cell budget ({MAX_CELLS}); use thetaSketch "
                "or hyperUnique at this scale")

    def update(self, cols, mask, keys, num):
        self._check(num)
        return self._counts(cols, mask, keys, num)

    def update_stacked(self, cols, mask, keys, K, num):
        # the budget is each segment's, as when it runs alone
        self._check(num)
        return self._counts(cols, mask, keys, K * num)

    def _counts(self, cols, mask, keys, num):
        if self.field not in cols or self.cardinality == 0:
            return torch.zeros(num, dtype=torch.int64, device=keys.device)
        card = self.cardinality
        cell = keys * card + cols[self.field].to(torch.int64)
        return _presence(cell, mask, num * card, torch.bool) \
            .view(num, card).sum(1, dtype=torch.int64)

    def combine(self, a, b):
        return a + b              # per-segment counts add (contrib contract)

    def empty_state(self, n):
        return np.zeros(n, dtype=np.int64)


register_aggregator(
    "distinctCount",
    lambda j: DistinctCountAggregator(j["name"], j["fieldName"]))
register_kernel(DistinctCountAggregator, DistinctCountKernel)
