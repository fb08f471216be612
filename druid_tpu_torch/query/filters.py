"""Dimension filter model: the JSON filter tree of a native query.

The port's copy of the reference package's `query/filters.py`, cut to the
filter types the aggregate path plans here: selector, in, bound, interval,
and/or/not and the constant true/false. Any other type, and any filter with
an extractionFn, raises NotImplementedError. Planning a filter into a row
mask lives in engine/filters.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from druid_tpu_torch.utils.intervals import Interval, normalize_intervals


class DimFilter:
    """Base filter node."""

    def required_columns(self) -> set:
        return set()

    def optimize(self) -> "DimFilter":
        return self


@dataclass(frozen=True)
class TrueFilter(DimFilter):
    pass


@dataclass(frozen=True)
class FalseFilter(DimFilter):
    pass


@dataclass(frozen=True)
class SelectorFilter(DimFilter):
    """dimension == value (reference: query/filter/SelectorDimFilter.java)."""
    dimension: str
    value: Optional[str]

    def required_columns(self):
        return {self.dimension}


@dataclass(frozen=True)
class InFilter(DimFilter):
    """dimension IN (values) (reference: query/filter/InDimFilter.java)."""
    dimension: str
    values: Tuple[Optional[str], ...]

    def required_columns(self):
        return {self.dimension}

    def optimize(self):
        if len(self.values) == 1:
            return SelectorFilter(self.dimension, self.values[0])
        return self


@dataclass(frozen=True)
class BoundFilter(DimFilter):
    """Range filter, lexicographic or numeric ordering
    (reference: query/filter/BoundDimFilter.java)."""
    dimension: str
    lower: Optional[str] = None
    upper: Optional[str] = None
    lower_strict: bool = False
    upper_strict: bool = False
    ordering: str = "lexicographic"  # or "numeric"

    def required_columns(self):
        return {self.dimension}


@dataclass(frozen=True)
class IntervalFilter(DimFilter):
    """__time within intervals (reference: query/filter/IntervalDimFilter.java)."""
    dimension: str
    intervals: Tuple[Interval, ...]

    def required_columns(self):
        return {self.dimension}


def _flatten(fields, cls, absorbing, neutral):
    flat: List[DimFilter] = []
    for f in fields:
        f = f.optimize()
        if isinstance(f, cls):
            flat.extend(f.fields)
        elif isinstance(f, neutral):
            continue
        elif isinstance(f, absorbing):
            return absorbing()
        else:
            flat.append(f)
    if not flat:
        return neutral()
    if len(flat) == 1:
        return flat[0]
    return cls(tuple(flat))


@dataclass(frozen=True)
class AndFilter(DimFilter):
    fields: Tuple[DimFilter, ...]

    def required_columns(self):
        return set().union(*(f.required_columns() for f in self.fields))

    def optimize(self):
        return _flatten(self.fields, AndFilter, FalseFilter, TrueFilter)


@dataclass(frozen=True)
class OrFilter(DimFilter):
    fields: Tuple[DimFilter, ...]

    def required_columns(self):
        return set().union(*(f.required_columns() for f in self.fields))

    def optimize(self):
        return _flatten(self.fields, OrFilter, TrueFilter, FalseFilter)


@dataclass(frozen=True)
class NotFilter(DimFilter):
    field: DimFilter

    def required_columns(self):
        return self.field.required_columns()

    def optimize(self):
        f = self.field.optimize()
        if isinstance(f, NotFilter):
            return f.field
        if isinstance(f, TrueFilter):
            return FalseFilter()
        if isinstance(f, FalseFilter):
            return TrueFilter()
        return NotFilter(f)


def filter_from_json(j: Optional[dict]) -> Optional[DimFilter]:
    """JSON-polymorphic deserialization of the supported filter types."""
    if j is None:
        return None
    t = j["type"]
    if j.get("extractionFn") is not None:
        raise NotImplementedError(f"extractionFn on a {t!r} filter")
    if t == "selector":
        return SelectorFilter(j["dimension"], j.get("value"))
    if t == "in":
        return InFilter(j["dimension"], tuple(j["values"]))
    if t == "bound":
        return BoundFilter(j["dimension"], j.get("lower"), j.get("upper"),
                           j.get("lowerStrict", False),
                           j.get("upperStrict", False),
                           j.get("ordering", "lexicographic"))
    if t == "interval":
        return IntervalFilter(j["dimension"],
                              tuple(normalize_intervals(j["intervals"])))
    if t == "and":
        return AndFilter(tuple(filter_from_json(f) for f in j["fields"]))
    if t == "or":
        return OrFilter(tuple(filter_from_json(f) for f in j["fields"]))
    if t == "not":
        return NotFilter(filter_from_json(j["field"]))
    if t == "true":
        return TrueFilter()
    if t == "false":
        return FalseFilter()
    raise NotImplementedError(f"filter type {t!r}")
