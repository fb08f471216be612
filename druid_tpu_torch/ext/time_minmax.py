"""timeMin / timeMax: the earliest and latest event time of each group.

The port of the reference package's `ext/time_minmax.py` (Druid's
extensions-contrib/time-min-max). The device reduces the staged int32
`__time_offset` (INT32_MIN or INT32_MAX for a group no row reached);
`host_post` widens it to absolute int64 epoch millis with the segment's
start, the identity to INT64_MIN or INT64_MAX, so partials of segments
with other starts combine.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from druid_tpu_torch.engine.kernels import (INT64_MAX, INT64_MIN, AggKernel,
                                            _seg_max, _seg_min,
                                            register_kernel)
from druid_tpu_torch.query.aggregators import (AggregatorSpec,
                                               register_aggregator)

INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)


@dataclass(frozen=True)
class TimeMinAggregator(AggregatorSpec):
    name: str

    def required_columns(self):
        return set()          # __time_offset always stages

    def combining(self):
        return TimeMinAggregator(self.name)

    def to_json(self):
        return {"type": "timeMin", "name": self.name,
                "fieldName": "__time"}


@dataclass(frozen=True)
class TimeMaxAggregator(AggregatorSpec):
    name: str

    def required_columns(self):
        return set()

    def combining(self):
        return TimeMaxAggregator(self.name)

    def to_json(self):
        return {"type": "timeMax", "name": self.name,
                "fieldName": "__time"}


class TimeMinMaxKernel(AggKernel):
    def __init__(self, spec, segment, is_max: bool):
        super().__init__(spec)
        self.is_max = is_max
        self.reduce_kind = "max" if is_max else "min"

    def signature(self):
        return f"time{'max' if self.is_max else 'min'}()"

    @property
    def identity(self):
        return INT64_MIN if self.is_max else INT64_MAX

    @property
    def _narrow_ident(self) -> int:
        return INT32_MIN if self.is_max else INT32_MAX

    def update(self, cols, mask, keys, num):
        t = cols["__time_offset"]
        tm = torch.where(mask, t, self._narrow_ident)
        return _seg_max(tm, keys, num) if self.is_max \
            else _seg_min(tm, keys, num)

    def host_post(self, state, segment):
        st = state.cpu().numpy()
        return np.where(st == self._narrow_ident, self.identity,
                        st.astype(np.int64) + segment.interval.start)

    def device_post(self, state, time0):
        return torch.where(state == self._narrow_ident, int(self.identity),
                           state.to(torch.int64) + time0)

    def host_from_device(self, state):
        return state.cpu().numpy()

    def combine(self, a, b):
        return np.maximum(a, b) if self.is_max else np.minimum(a, b)

    def empty_state(self, n):
        return np.full(n, self.identity, dtype=np.int64)


register_aggregator("timeMin", lambda j: TimeMinAggregator(j["name"]))
register_aggregator("timeMax", lambda j: TimeMaxAggregator(j["name"]))
register_kernel(TimeMinAggregator,
                lambda spec, seg: TimeMinMaxKernel(spec, seg, False))
register_kernel(TimeMaxAggregator,
                lambda spec, seg: TimeMinMaxKernel(spec, seg, True))
