"""Aggregator specs: the query-model side of aggregation.

The port's copy of the reference package's `query/aggregators.py`: count,
the long/double/float sum, min, max, first and last, filtered, hyperUnique
and cardinality, and the extension registry that `druid_tpu_torch.ext`
fills (consulted first, as in the reference). An unknown type raises
ValueError, as in the reference. `to_json` gives the reference's wire
form. The device side of each spec is an AggKernel in engine/kernels.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from druid_tpu_torch.query.filters import filter_from_json


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

    def to_json(self) -> dict:
        raise NotImplementedError


@dataclass(frozen=True)
class CountAggregator(AggregatorSpec):
    name: str = "count"

    def to_json(self):
        return {"type": "count", "name": self.name}


@dataclass(frozen=True)
class _FieldAggregator(AggregatorSpec):
    name: str
    field: str

    def to_json(self):
        return {"type": _FIELD_TYPE_NAMES[type(self)], "name": self.name,
                "fieldName": self.field}


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
_FIELD_TYPE_NAMES = {cls: t for t, cls in _FIELD_TYPES.items()}


@dataclass(frozen=True)
class FirstAggregator(AggregatorSpec):
    """The value at the least time of each group; `kind` is long, double
    or float."""
    name: str
    field: str
    kind: str = "double"

    def required_columns(self):
        # a rolled-up segment keeps each row's event time in the hidden
        # pair column __ft_<field>, which then orders the rows
        return {self.field, f"__ft_{self.field}"}

    def to_json(self):
        return {"type": f"{self.kind}First", "name": self.name,
                "fieldName": self.field}


@dataclass(frozen=True)
class LastAggregator(AggregatorSpec):
    """The value at the greatest time of each group."""
    name: str
    field: str
    kind: str = "double"

    def required_columns(self):
        return {self.field, f"__ft_{self.field}"}

    def to_json(self):
        return {"type": f"{self.kind}Last", "name": self.name,
                "fieldName": self.field}


@dataclass(frozen=True)
class FilteredAggregator(AggregatorSpec):
    """A delegate aggregator over the rows that also pass `filter`."""
    name: str
    delegate: AggregatorSpec = None
    filter: object = None             # a query.filters.DimFilter

    def required_columns(self):
        return self.delegate.required_columns() \
            | self.filter.required_columns()

    def to_json(self):
        return {"type": "filtered", "name": self.name,
                "aggregator": self.delegate.to_json(),
                "filter": self.filter.to_json()}


@dataclass(frozen=True)
class HyperUniqueAggregator(AggregatorSpec):
    """HLL cardinality of a column: a register (complex) column, a
    dimension or a numeric column."""
    name: str
    field: str
    log2m: int = 11
    round: bool = False

    def to_json(self):
        return {"type": "hyperUnique", "name": self.name,
                "fieldName": self.field, "log2m": self.log2m,
                "round": self.round}


@dataclass(frozen=True)
class CardinalityAggregator(AggregatorSpec):
    """HLL cardinality of the values of `fields` (byRow: of the rows'
    combined values)."""
    name: str
    fields: Tuple[str, ...] = ()
    by_row: bool = False
    log2m: int = 11
    round: bool = False

    def required_columns(self):
        return set(self.fields)

    def to_json(self):
        return {"type": "cardinality", "name": self.name,
                "fields": list(self.fields), "byRow": self.by_row,
                "log2m": self.log2m, "round": self.round}


# extension aggregator types: type name -> from_json (druid_tpu_torch/ext/)
_EXTENSION_AGGS: dict = {}


def register_aggregator(type_name: str, from_json) -> None:
    _EXTENSION_AGGS[type_name] = from_json


def agg_from_json(j: dict) -> AggregatorSpec:
    t = j["type"]
    if t in _EXTENSION_AGGS:
        return _EXTENSION_AGGS[t](j)
    if t == "count":
        return CountAggregator(j["name"])
    cls = _FIELD_TYPES.get(t)
    if cls is not None:
        return cls(j["name"], j["fieldName"])
    if t == "hyperUnique":
        return HyperUniqueAggregator(j["name"], j["fieldName"],
                                     log2m=j.get("log2m", 11),
                                     round=j.get("round", False))
    if t == "cardinality":
        return CardinalityAggregator(j["name"], tuple(j["fields"]),
                                     j.get("byRow", False),
                                     log2m=j.get("log2m", 11),
                                     round=j.get("round", False))
    for kind in ("long", "double", "float"):
        if t == f"{kind}First":
            return FirstAggregator(j["name"], j["fieldName"], kind)
        if t == f"{kind}Last":
            return LastAggregator(j["name"], j["fieldName"], kind)
    if t == "filtered":
        return FilteredAggregator(j.get("name") or j["aggregator"]["name"],
                                  agg_from_json(j["aggregator"]),
                                  filter_from_json(j["filter"]))
    raise ValueError(f"unknown aggregator type {t!r}")
