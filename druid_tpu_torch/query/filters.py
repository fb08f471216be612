"""Dimension filter model: the JSON filter tree of a native query.

The port's copy of the reference package's `query/filters.py`: selector,
in, bound, like, regex and search (each with an optional extractionFn),
interval, columnComparison, expression, and/or/not and the constant
true/false, and spatial (rectangular, radius and polygon bounds over a
dimension of "x,y[,...]" coordinate strings). JavaScriptFilter takes a
Python callable over dimension values; no JSON reaches it, and
"javascript", like any unknown type, raises ValueError, as in the
reference. Extension filter types (the bloom filter) register through
`register_filter` and are consulted first. `to_json` gives the reference's
wire form. Planning a filter into a row mask lives in engine/filters.py.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

from druid_tpu_torch.utils.expression import parse_expression
from druid_tpu_torch.utils.intervals import Interval, normalize_intervals


class DimFilter:
    """Base filter node."""

    def required_columns(self) -> set:
        return set()

    def optimize(self) -> "DimFilter":
        return self

    def to_json(self) -> dict:
        raise NotImplementedError


@dataclass(frozen=True)
class TrueFilter(DimFilter):
    def to_json(self):
        return {"type": "true"}


@dataclass(frozen=True)
class FalseFilter(DimFilter):
    def to_json(self):
        return {"type": "false"}


def _with_exfn(j: dict, fn) -> dict:
    if fn is not None:
        j["extractionFn"] = fn.to_json()
    return j


@dataclass(frozen=True)
class SelectorFilter(DimFilter):
    """dimension == value (reference: query/filter/SelectorDimFilter.java).
    An optional extraction_fn transforms each dictionary value before the
    comparison."""
    dimension: str
    value: Optional[str]
    extraction_fn: Optional[object] = None

    def required_columns(self):
        return {self.dimension}

    def to_json(self):
        return _with_exfn({"type": "selector", "dimension": self.dimension,
                           "value": self.value}, self.extraction_fn)


@dataclass(frozen=True)
class InFilter(DimFilter):
    """dimension IN (values) (reference: query/filter/InDimFilter.java)."""
    dimension: str
    values: Tuple[Optional[str], ...]
    extraction_fn: Optional[object] = None

    def required_columns(self):
        return {self.dimension}

    def to_json(self):
        return _with_exfn({"type": "in", "dimension": self.dimension,
                           "values": list(self.values)}, self.extraction_fn)

    def optimize(self):
        if len(self.values) == 1:
            return SelectorFilter(self.dimension, self.values[0],
                                  self.extraction_fn)
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
    extraction_fn: Optional[object] = None

    def required_columns(self):
        return {self.dimension}

    def to_json(self):
        return _with_exfn(
            {"type": "bound", "dimension": self.dimension,
             "lower": self.lower, "upper": self.upper,
             "lowerStrict": self.lower_strict,
             "upperStrict": self.upper_strict,
             "ordering": self.ordering}, self.extraction_fn)


@dataclass(frozen=True)
class LikeFilter(DimFilter):
    """SQL LIKE (reference: query/filter/LikeDimFilter.java)."""
    dimension: str
    pattern: str
    escape: Optional[str] = None
    extraction_fn: Optional[object] = None

    def regex(self) -> str:
        out, i = [], 0
        esc = self.escape
        p = self.pattern
        while i < len(p):
            c = p[i]
            if esc and c == esc and i + 1 < len(p):
                out.append(re.escape(p[i + 1]))
                i += 2
                continue
            if c == "%":
                out.append(".*")
            elif c == "_":
                out.append(".")
            else:
                out.append(re.escape(c))
            i += 1
        return "^" + "".join(out) + "$"

    def required_columns(self):
        return {self.dimension}

    def to_json(self):
        return _with_exfn({"type": "like", "dimension": self.dimension,
                           "pattern": self.pattern, "escape": self.escape},
                          self.extraction_fn)


@dataclass(frozen=True)
class RegexFilter(DimFilter):
    """reference: query/filter/RegexDimFilter.java"""
    dimension: str
    pattern: str
    extraction_fn: Optional[object] = None

    def required_columns(self):
        return {self.dimension}

    def to_json(self):
        return _with_exfn({"type": "regex", "dimension": self.dimension,
                           "pattern": self.pattern}, self.extraction_fn)


@dataclass(frozen=True)
class SearchFilter(DimFilter):
    """contains / insensitive contains on dimension values
    (reference: query/filter/SearchQueryDimFilter.java)."""
    dimension: str
    value: str
    case_sensitive: bool = False
    extraction_fn: Optional[object] = None

    def required_columns(self):
        return {self.dimension}

    def to_json(self):
        return _with_exfn(
            {"type": "search", "dimension": self.dimension,
             "query": {"type": "contains", "value": self.value,
                       "caseSensitive": self.case_sensitive}},
            self.extraction_fn)


@dataclass(frozen=True)
class IntervalFilter(DimFilter):
    """__time within intervals (reference: query/filter/IntervalDimFilter.java)."""
    dimension: str
    intervals: Tuple[Interval, ...]

    def required_columns(self):
        return {self.dimension}

    def to_json(self):
        return {"type": "interval", "dimension": self.dimension,
                "intervals": [str(iv) for iv in self.intervals]}


@dataclass(frozen=True)
class ColumnComparisonFilter(DimFilter):
    """dimA == dimB row by row
    (reference: query/filter/ColumnComparisonDimFilter.java)."""
    dimensions: Tuple[str, ...]

    def required_columns(self):
        return set(self.dimensions)

    def to_json(self):
        return {"type": "columnComparison", "dimensions": list(self.dimensions)}


@dataclass(frozen=True)
class ExpressionFilter(DimFilter):
    """Expression-language predicate
    (reference: query/filter/ExpressionDimFilter.java)."""
    expression: str

    def required_columns(self):
        return set(parse_expression(self.expression).required_columns())

    def to_json(self):
        return {"type": "expression", "expression": self.expression}


@dataclass(frozen=True)
class JavaScriptFilter(DimFilter):
    """The reference's stand-in for Druid's JavaScript filter: a Python
    callable over dimension values, evaluated on the host into the
    dimension's LUT. No JSON reaches it."""
    dimension: str
    predicate: object  # Callable[[str], bool]

    def required_columns(self):
        return {self.dimension}

    def to_json(self):
        return {"type": "javascript", "dimension": self.dimension,
                "function": "<python-callable>"}


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

    def to_json(self):
        return {"type": "and", "fields": [f.to_json() for f in self.fields]}


@dataclass(frozen=True)
class OrFilter(DimFilter):
    fields: Tuple[DimFilter, ...]

    def required_columns(self):
        return set().union(*(f.required_columns() for f in self.fields))

    def optimize(self):
        return _flatten(self.fields, OrFilter, TrueFilter, FalseFilter)

    def to_json(self):
        return {"type": "or", "fields": [f.to_json() for f in self.fields]}


@dataclass(frozen=True)
class NotFilter(DimFilter):
    field: DimFilter

    def required_columns(self):
        return self.field.required_columns()

    def to_json(self):
        return {"type": "not", "field": self.field.to_json()}

    def optimize(self):
        f = self.field.optimize()
        if isinstance(f, NotFilter):
            return f.field
        if isinstance(f, TrueFilter):
            return FalseFilter()
        if isinstance(f, FalseFilter):
            return TrueFilter()
        return NotFilter(f)


class SpatialBound:
    """A region of a spatial filter (Druid's spatial search Bound)."""

    @staticmethod
    def from_json(j: dict) -> "SpatialBound":
        t = j["type"]
        if t == "rectangular":
            return RectangularBound(tuple(j["minCoords"]),
                                    tuple(j["maxCoords"]))
        if t == "radius":
            return RadiusBound(tuple(j["coords"]), float(j["radius"]))
        if t == "polygon":
            return PolygonBound(tuple(j["abscissa"]), tuple(j["ordinate"]))
        raise ValueError(f"unknown spatial bound type {t!r}")

    def to_json(self) -> dict:
        raise NotImplementedError

    def contains(self, coords) -> bool:
        raise NotImplementedError


@dataclass(frozen=True)
class RectangularBound(SpatialBound):
    """An axis-aligned box in any number of dimensions."""
    min_coords: tuple
    max_coords: tuple

    def to_json(self):
        return {"type": "rectangular", "minCoords": list(self.min_coords),
                "maxCoords": list(self.max_coords)}

    def contains(self, coords):
        if len(coords) != len(self.min_coords):
            return False
        return all(lo <= c <= hi for c, lo, hi in
                   zip(coords, self.min_coords, self.max_coords))


@dataclass(frozen=True)
class RadiusBound(SpatialBound):
    """A Euclidean ball."""
    coords: tuple
    radius: float

    def to_json(self):
        return {"type": "radius", "coords": list(self.coords),
                "radius": self.radius}

    def contains(self, coords):
        if len(coords) != len(self.coords):
            return False
        return sum((c - o) ** 2 for c, o in
                   zip(coords, self.coords)) <= self.radius ** 2


@dataclass(frozen=True)
class PolygonBound(SpatialBound):
    """A 2-D polygon, by even-odd ray casting."""
    abscissa: tuple    # x of each vertex
    ordinate: tuple    # y of each vertex

    def to_json(self):
        return {"type": "polygon", "abscissa": list(self.abscissa),
                "ordinate": list(self.ordinate)}

    def contains(self, coords):
        if len(coords) != 2:
            return False
        x, y = coords
        n = len(self.abscissa)
        inside = False
        j = n - 1
        for i in range(n):
            xi, yi = self.abscissa[i], self.ordinate[i]
            xj, yj = self.abscissa[j], self.ordinate[j]
            if (yi > y) != (yj > y) and \
                    x < (xj - xi) * (y - yi) / (yj - yi) + xi:
                inside = not inside
            j = i
        return inside


@dataclass(frozen=True)
class SpatialFilter(DimFilter):
    """A spatial filter (Druid's SpatialDimFilter). The dimension holds
    joined "x,y[,...]" coordinate strings; the bound is tested once per
    dictionary value (`value_predicate`), so the filter plans to the same
    dictionary LUT as any string leaf."""
    dimension: str
    bound: SpatialBound

    def required_columns(self):
        return {self.dimension}

    def to_json(self):
        return {"type": "spatial", "dimension": self.dimension,
                "bound": self.bound.to_json()}

    def value_predicate(self):
        bound = self.bound

        def pred(v) -> bool:
            try:
                coords = tuple(float(p) for p in str(v).split(","))
            except (TypeError, ValueError):
                return False
            return bound.contains(coords)
        return pred


# extension filter types: type name -> from_json (druid_tpu_torch/ext/)
_EXTENSION_FILTERS: dict = {}


def register_filter(type_name: str, from_json) -> None:
    _EXTENSION_FILTERS[type_name] = from_json


def filter_from_json(j: Optional[dict]) -> Optional[DimFilter]:
    """JSON-polymorphic deserialization, as the reference's filter_from_json
    (Jackson @JsonSubTypes on DimFilter)."""
    if j is None:
        return None
    t = j["type"]
    if t in _EXTENSION_FILTERS:
        return _EXTENSION_FILTERS[t](j)
    if t == "spatial":
        return SpatialFilter(j["dimension"],
                             SpatialBound.from_json(j["bound"]))
    exfn = None
    if j.get("extractionFn") is not None:
        # lazy: extraction fns live in query.model, which imports this module
        from druid_tpu_torch.query.model import extractionfn_from_json
        exfn = extractionfn_from_json(j["extractionFn"])
        if t not in ("selector", "in", "bound", "like", "regex", "search"):
            # silently dropping the fn would return wrong rows
            raise ValueError(f"extractionFn unsupported on filter type {t!r}")
    if t == "selector":
        return SelectorFilter(j["dimension"], j.get("value"), exfn)
    if t == "in":
        return InFilter(j["dimension"], tuple(j["values"]), exfn)
    if t == "bound":
        return BoundFilter(j["dimension"], j.get("lower"), j.get("upper"),
                           j.get("lowerStrict", False),
                           j.get("upperStrict", False),
                           j.get("ordering", "lexicographic"), exfn)
    if t == "like":
        return LikeFilter(j["dimension"], j["pattern"], j.get("escape"),
                          exfn)
    if t == "regex":
        return RegexFilter(j["dimension"], j["pattern"], exfn)
    if t == "search":
        q = j.get("query", {})
        return SearchFilter(j["dimension"], q.get("value", ""),
                            q.get("caseSensitive", False), exfn)
    if t == "interval":
        return IntervalFilter(j["dimension"],
                              tuple(normalize_intervals(j["intervals"])))
    if t == "columnComparison":
        return ColumnComparisonFilter(tuple(j["dimensions"]))
    if t == "expression":
        return ExpressionFilter(j["expression"])
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
    raise ValueError(f"unknown filter type {t!r}")
