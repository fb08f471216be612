"""Aggregator specs: the query-model side of aggregation.

The port's copy of the reference package's `query/aggregators.py`, cut to
count and the long/double/float sum, min and max. Any other aggregator
type raises NotImplementedError. The device side of each spec is an
AggKernel in engine/kernels.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


class AggregatorSpec:
    name: str

    @property
    def field_name(self) -> Optional[str]:
        return getattr(self, "field", None)

    def required_columns(self) -> set:
        f = self.field_name
        return {f} if f else set()

    def finalize(self, value):
        return value


@dataclass(frozen=True)
class CountAggregator(AggregatorSpec):
    name: str = "count"


@dataclass(frozen=True)
class _FieldAggregator(AggregatorSpec):
    name: str
    field: str


class LongSumAggregator(_FieldAggregator):
    pass


class DoubleSumAggregator(_FieldAggregator):
    pass


class FloatSumAggregator(_FieldAggregator):
    pass


class LongMinAggregator(_FieldAggregator):
    pass


class LongMaxAggregator(_FieldAggregator):
    pass


class DoubleMinAggregator(_FieldAggregator):
    pass


class DoubleMaxAggregator(_FieldAggregator):
    pass


class FloatMinAggregator(_FieldAggregator):
    pass


class FloatMaxAggregator(_FieldAggregator):
    pass


_FIELD_TYPES = {
    "longSum": LongSumAggregator, "doubleSum": DoubleSumAggregator,
    "floatSum": FloatSumAggregator, "longMin": LongMinAggregator,
    "longMax": LongMaxAggregator, "doubleMin": DoubleMinAggregator,
    "doubleMax": DoubleMaxAggregator, "floatMin": FloatMinAggregator,
    "floatMax": FloatMaxAggregator,
}


def agg_from_json(j: dict) -> AggregatorSpec:
    t = j["type"]
    if t == "count":
        return CountAggregator(j["name"])
    cls = _FIELD_TYPES.get(t)
    if cls is None:
        raise NotImplementedError(f"aggregator type {t!r}")
    return cls(j["name"], j["fieldName"])
