"""The query model: the ten native query types of the reference package.

The port's copy of the reference package's `query/model.py`: timeseries,
topN, groupBy (with having, limitSpec and subtotalsSpec), scan, select,
search, timeBoundary, segmentMetadata and dataSourceMetadata, over a table,
union or query dataSource; the reference's dimension specs (default,
extraction, listFiltered, expression), extraction functions and expression
virtual columns. An unknown query type, dataSource kind, having spec,
dimension spec or extraction function raises ValueError, as in the
reference. JSON serde mirrors the reference's Jackson wire format, and
every `to_json` gives the reference's.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

from druid_tpu_torch.query import lookup as _lookup_mod
from druid_tpu_torch.query.aggregators import AggregatorSpec, agg_from_json
from druid_tpu_torch.query.filters import DimFilter, filter_from_json
from druid_tpu_torch.query.postaggs import PostAggregator, postagg_from_json
from druid_tpu_torch.utils.granularity import Granularity
from druid_tpu_torch.utils.intervals import Interval, normalize_intervals


class ExtractionFn:
    """Host-side value transform applied to dictionary values at plan time
    (reference: query/extraction/ExtractionFn.java). Because dictionaries are
    small relative to rows, extraction is O(cardinality) host work producing
    an id remap table — never a per-row device op."""

    def apply(self, value: Optional[str]) -> Optional[str]:
        raise NotImplementedError

    def to_json(self) -> dict:
        raise NotImplementedError

    def cache_key(self) -> dict:
        """Key for per-segment id-remap caches. Defaults to the wire form;
        fns whose output depends on external state (registered lookups) must
        mix that state's version in so stale remaps are not served."""
        return self.to_json()

    def apply_all(self, values):
        """Batch apply over a dictionary's values (the engine's remap loop).
        Override where per-call setup (registry resolution) would otherwise
        repeat O(cardinality) times."""
        return [self.apply(v) for v in values]


@dataclass(frozen=True)
class SubstringExtractionFn(ExtractionFn):
    index: int
    length: Optional[int] = None

    def apply(self, value):
        if value is None or value == "":
            return None
        if self.index >= len(value):
            return None
        end = None if self.length is None else self.index + self.length
        return value[self.index:end]

    def to_json(self):
        return {"type": "substring", "index": self.index, "length": self.length}


@dataclass(frozen=True)
class RegexExtractionFn(ExtractionFn):
    expr: str
    index: int = 1
    replace_missing: bool = False
    replacement: Optional[str] = None

    def apply(self, value):
        m = re.search(self.expr, value or "")
        if m and m.groups():
            return m.group(self.index)
        if m and self.index == 0:
            return m.group(0)
        return self.replacement if self.replace_missing else value

    def to_json(self):
        return {"type": "regex", "expr": self.expr, "index": self.index,
                "replaceMissingValue": self.replace_missing,
                "replaceMissingValueWith": self.replacement}


@dataclass(frozen=True)
class UpperExtractionFn(ExtractionFn):
    def apply(self, value):
        return value.upper() if value else value

    def to_json(self):
        return {"type": "upper"}


@dataclass(frozen=True)
class LowerExtractionFn(ExtractionFn):
    def apply(self, value):
        return value.lower() if value else value

    def to_json(self):
        return {"type": "lower"}


@dataclass(frozen=True)
class LookupExtractionFn(ExtractionFn):
    """key→value map extraction (reference: query/lookup/LookupExtractionFn.java)."""
    lookup: Tuple[Tuple[str, str], ...]
    retain_missing: bool = True
    replace_missing: Optional[str] = None

    def apply(self, value):
        m = dict(self.lookup)
        if value in m:
            return m[value]
        return value if self.retain_missing else self.replace_missing

    def to_json(self):
        return {"type": "lookup", "lookup": {"type": "map", "map": dict(self.lookup)},
                "retainMissingValue": self.retain_missing,
                "replaceMissingValueWith": self.replace_missing}


@dataclass(frozen=True)
class StrlenExtractionFn(ExtractionFn):
    """reference: query/extraction/StrlenExtractionFn.java"""
    def apply(self, value):
        return str(len(value)) if value is not None else "0"

    def to_json(self):
        return {"type": "strlen"}


@dataclass(frozen=True)
class StringFormatExtractionFn(ExtractionFn):
    """reference: query/extraction/StringFormatExtractionFn.java — %-style
    format applied to the dim value; nullHandling returnNull|emptyString."""
    format: str
    null_handling: str = "nullString"

    def apply(self, value):
        if value is None:
            if self.null_handling == "returnNull":
                return None
            # nullString renders as Java's "null", emptyString as ""
            value = "" if self.null_handling == "emptyString" else "null"
        return self.format % (value,)

    def to_json(self):
        return {"type": "stringFormat", "format": self.format,
                "nullHandling": self.null_handling}


@dataclass(frozen=True)
class TimeFormatExtractionFn(ExtractionFn):
    """reference: query/extraction/TimeFormatExtractionFn.java. Parses the
    value as an ISO timestamp (or epoch millis) and reformats via strftime;
    optional granularity truncation first. Joda patterns are mapped to the
    common strftime subset (yyyy, MM, dd, HH, mm, ss, EEEE, MMMM)."""
    format: Optional[str] = None
    granularity: Optional[str] = None

    # longest-pattern-first so e.g. MMMM is not consumed by MM
    _JODA = (("yyyy", "%Y"), ("MMMM", "%B"), ("MMM", "%b"), ("MM", "%m"),
             ("dd", "%d"), ("HH", "%H"), ("mm", "%M"), ("ss", "%S"),
             ("EEEE", "%A"), ("EEE", "%a"))

    def apply(self, value):
        import datetime as _dt

        from druid_tpu_torch.utils.intervals import parse_ts, ts_to_iso
        if value is None:
            return None
        try:
            ms = parse_ts(value)
        except (ValueError, TypeError):
            # epoch-millis strings (dictionary values are always str)
            try:
                ms = int(value)
            except (ValueError, TypeError):
                return None
        if self.granularity:
            ms = Granularity.of(self.granularity).bucket_start(ms)
        if self.format is None:
            return ts_to_iso(ms)
        dt = _dt.datetime.fromtimestamp(ms / 1000.0, _dt.timezone.utc)
        fmt = self.format
        for joda, std in self._JODA:
            fmt = fmt.replace(joda, std)
        return dt.strftime(fmt)

    def to_json(self):
        return {"type": "timeFormat", "format": self.format,
                "granularity": self.granularity}


@dataclass(frozen=True)
class CascadeExtractionFn(ExtractionFn):
    """reference: query/extraction/CascadeExtractionFn.java — chain."""
    fns: Tuple[ExtractionFn, ...] = ()

    def apply(self, value):
        for fn in self.fns:
            value = fn.apply(value)
        return value

    def apply_all(self, values):
        for fn in self.fns:
            values = fn.apply_all(values)
        return list(values)

    def to_json(self):
        return {"type": "cascade",
                "extractionFns": [f.to_json() for f in self.fns]}

    def cache_key(self):
        return {"type": "cascade",
                "extractionFns": [f.cache_key() for f in self.fns]}


@dataclass(frozen=True)
class RegisteredLookupExtractionFn(ExtractionFn):
    """Named lookup resolved against the process-wide lookup registry
    (reference: query/lookup/RegisteredLookupExtractionFn.java +
    LookupReferencesManager)."""
    lookup: str
    retain_missing: bool = True
    replace_missing: Optional[str] = None

    def apply(self, value):
        return self._apply_with(_lookup_mod.get_lookup(self.lookup), value)

    def _apply_with(self, m, value):
        if value in m:
            return m[value]
        return value if self.retain_missing else self.replace_missing

    def apply_all(self, values):
        m = _lookup_mod.get_lookup(self.lookup)  # resolve registry once
        return [self._apply_with(m, v) for v in values]

    def to_json(self):
        return {"type": "registeredLookup", "lookup": self.lookup,
                "retainMissingValue": self.retain_missing,
                "replaceMissingValueWith": self.replace_missing}

    def cache_key(self):
        c = _lookup_mod.lookup_manager().get(self.lookup)
        j = self.to_json()
        j["_lookupVersion"] = c.version if c is not None else None
        return j


class DimensionSpec:
    dimension: str
    output_name: str

    @property
    def extraction_fn(self) -> Optional[ExtractionFn]:
        return None


@dataclass(frozen=True)
class DefaultDimensionSpec(DimensionSpec):
    dimension: str
    output_name: str = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.output_name is None:
            object.__setattr__(self, "output_name", self.dimension)

    def to_json(self):
        return {"type": "default", "dimension": self.dimension,
                "outputName": self.output_name}


@dataclass(frozen=True)
class ExtractionDimensionSpec(DimensionSpec):
    dimension: str
    output_name: str
    fn: ExtractionFn = None

    @property
    def extraction_fn(self):
        return self.fn

    def to_json(self):
        return {"type": "extraction", "dimension": self.dimension,
                "outputName": self.output_name, "extractionFn": self.fn.to_json()}


@dataclass(frozen=True)
class ListFilteredDimensionSpec(DimensionSpec):
    """reference: query/dimension/ListFilteredDimensionSpec.java"""
    delegate: DimensionSpec = None
    values: Tuple[str, ...] = ()
    is_whitelist: bool = True

    @property
    def dimension(self):
        return self.delegate.dimension

    @property
    def output_name(self):
        return self.delegate.output_name

    @property
    def extraction_fn(self):
        return self.delegate.extraction_fn

    def to_json(self):
        return {"type": "listFiltered", "delegate": self.delegate.to_json(),
                "values": list(self.values), "isWhitelist": self.is_whitelist}


@dataclass(frozen=True)
class ExpressionDimensionSpec(DimensionSpec):
    """Group by a computed expression (the capability of the reference's
    virtualColumn-as-dimension path). Evaluated HOST-side per segment into
    a query-time value dictionary — the device then groups by compact ids
    exactly like any other dimension (engines._keydim_for)."""
    expression: str = ""
    output_name: str = ""
    output_type: str = "long"     # long | double | string

    @property
    def dimension(self):
        return self.output_name

    def to_json(self):
        return {"type": "expression", "expression": self.expression,
                "outputName": self.output_name,
                "outputType": self.output_type}


def dimspec_from_json(j) -> DimensionSpec:
    if isinstance(j, str):
        return DefaultDimensionSpec(j, j)
    t = j.get("type", "default")
    if t == "default":
        return DefaultDimensionSpec(j["dimension"], j.get("outputName") or j["dimension"])
    if t == "expression":
        return ExpressionDimensionSpec(j["expression"],
                                       j.get("outputName") or "expr",
                                       j.get("outputType", "long"))
    if t == "extraction":
        return ExtractionDimensionSpec(j["dimension"],
                                       j.get("outputName") or j["dimension"],
                                       extractionfn_from_json(j["extractionFn"]))
    if t == "listFiltered":
        return ListFilteredDimensionSpec(dimspec_from_json(j["delegate"]),
                                         tuple(j["values"]),
                                         j.get("isWhitelist", True))
    raise ValueError(f"unknown dimension spec {t!r}")


def extractionfn_from_json(j) -> ExtractionFn:
    t = j["type"]
    if t == "substring":
        return SubstringExtractionFn(j["index"], j.get("length"))
    if t == "regex":
        return RegexExtractionFn(j["expr"], j.get("index", 1),
                                 j.get("replaceMissingValue", False),
                                 j.get("replaceMissingValueWith"))
    if t == "upper":
        return UpperExtractionFn()
    if t == "lower":
        return LowerExtractionFn()
    if t == "lookup":
        return LookupExtractionFn(tuple(j["lookup"]["map"].items()),
                                  j.get("retainMissingValue", True),
                                  j.get("replaceMissingValueWith"))
    if t == "strlen":
        return StrlenExtractionFn()
    if t == "stringFormat":
        return StringFormatExtractionFn(j["format"],
                                        j.get("nullHandling", "nullString"))
    if t == "timeFormat":
        return TimeFormatExtractionFn(j.get("format"), j.get("granularity"))
    if t == "cascade":
        return CascadeExtractionFn(
            tuple(extractionfn_from_json(f) for f in j["extractionFns"]))
    if t == "registeredLookup":
        return RegisteredLookupExtractionFn(j["lookup"],
                                            j.get("retainMissingValue", True),
                                            j.get("replaceMissingValueWith"))
    raise ValueError(f"unknown extraction fn {t!r}")


# ---------------------------------------------------------------------------
# Limit / having specs (reference: query/groupby/orderby/, query/groupby/having/)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OrderByColumnSpec:
    dimension: str
    direction: str = "ascending"   # ascending | descending
    dimension_order: str = "lexicographic"  # lexicographic | numeric

    def to_json(self):
        return {"dimension": self.dimension, "direction": self.direction,
                "dimensionOrder": self.dimension_order}


@dataclass(frozen=True)
class DefaultLimitSpec:
    columns: Tuple[OrderByColumnSpec, ...] = ()
    limit: Optional[int] = None
    offset: int = 0

    def to_json(self):
        return {"type": "default",
                "columns": [c.to_json() for c in self.columns],
                "limit": self.limit, "offset": self.offset}


class HavingSpec:
    def evaluate(self, row: Dict[str, object]) -> bool:
        raise NotImplementedError

    def to_json(self) -> dict:
        raise NotImplementedError


@dataclass(frozen=True)
class GreaterThanHaving(HavingSpec):
    aggregation: str
    value: float

    def evaluate(self, row):
        return float(row.get(self.aggregation, 0)) > self.value

    def to_json(self):
        return {"type": "greaterThan", "aggregation": self.aggregation,
                "value": self.value}


@dataclass(frozen=True)
class LessThanHaving(HavingSpec):
    aggregation: str
    value: float

    def evaluate(self, row):
        return float(row.get(self.aggregation, 0)) < self.value

    def to_json(self):
        return {"type": "lessThan", "aggregation": self.aggregation,
                "value": self.value}


@dataclass(frozen=True)
class EqualToHaving(HavingSpec):
    aggregation: str
    value: float

    def evaluate(self, row):
        return float(row.get(self.aggregation, 0)) == self.value

    def to_json(self):
        return {"type": "equalTo", "aggregation": self.aggregation,
                "value": self.value}


@dataclass(frozen=True)
class AndHaving(HavingSpec):
    specs: Tuple[HavingSpec, ...]

    def evaluate(self, row):
        return all(s.evaluate(row) for s in self.specs)

    def to_json(self):
        return {"type": "and", "havingSpecs": [s.to_json() for s in self.specs]}


@dataclass(frozen=True)
class OrHaving(HavingSpec):
    specs: Tuple[HavingSpec, ...]

    def evaluate(self, row):
        return any(s.evaluate(row) for s in self.specs)

    def to_json(self):
        return {"type": "or", "havingSpecs": [s.to_json() for s in self.specs]}


@dataclass(frozen=True)
class NotHaving(HavingSpec):
    spec: HavingSpec

    def evaluate(self, row):
        return not self.spec.evaluate(row)

    def to_json(self):
        return {"type": "not", "havingSpec": self.spec.to_json()}


@dataclass(frozen=True)
class DimSelectorHaving(HavingSpec):
    dimension: str
    value: Optional[str]

    def evaluate(self, row):
        return row.get(self.dimension) == self.value

    def to_json(self):
        return {"type": "dimSelector", "dimension": self.dimension,
                "value": self.value}


@dataclass(frozen=True)
class FilterHaving(HavingSpec):
    """reference: query/groupby/having/DimFilterHavingSpec.java — evaluated
    host-side over result rows."""
    filter: DimFilter

    def evaluate(self, row):
        from druid_tpu_torch.engine.filters import evaluate_filter_on_row
        return evaluate_filter_on_row(self.filter, row)

    def to_json(self):
        return {"type": "filter", "filter": self.filter.to_json()}


def having_from_json(j) -> Optional[HavingSpec]:
    if j is None:
        return None
    t = j["type"]
    if t == "greaterThan":
        return GreaterThanHaving(j["aggregation"], j["value"])
    if t == "lessThan":
        return LessThanHaving(j["aggregation"], j["value"])
    if t == "equalTo":
        return EqualToHaving(j["aggregation"], j["value"])
    if t == "and":
        return AndHaving(tuple(having_from_json(s) for s in j["havingSpecs"]))
    if t == "or":
        return OrHaving(tuple(having_from_json(s) for s in j["havingSpecs"]))
    if t == "not":
        return NotHaving(having_from_json(j["havingSpec"]))
    if t == "dimSelector":
        return DimSelectorHaving(j["dimension"], j.get("value"))
    if t == "filter":
        return FilterHaving(filter_from_json(j["filter"]))
    raise ValueError(f"unknown having spec {t!r}")


# ---------------------------------------------------------------------------
# Virtual columns (reference: segment/VirtualColumns.java, ExpressionVirtualColumn)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExpressionVirtualColumn:
    name: str
    expression: str
    output_type: str = "double"  # long | double | float | string

    def to_json(self):
        return {"type": "expression", "name": self.name,
                "expression": self.expression, "outputType": self.output_type}


def virtualcolumn_from_json(j) -> ExpressionVirtualColumn:
    if j["type"] != "expression":
        raise ValueError(f"unknown virtual column {j['type']!r}")
    return ExpressionVirtualColumn(j["name"], j["expression"],
                                   j.get("outputType", "double"))


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Query:
    datasource: str = ""
    intervals: Tuple[Interval, ...] = ()
    filter: Optional[DimFilter] = None
    granularity: Granularity = Granularity.ALL
    virtual_columns: Tuple[ExpressionVirtualColumn, ...] = ()
    context: Tuple[Tuple[str, object], ...] = ()
    # the dataSource kinds: a non-None inner_query makes this a query over
    # a subquery (the executor materializes the inner groupBy's rows as a
    # segment, as Druid's GroupByStrategyV2.processSubqueryResult does); a
    # non-empty union_datasources unions several tables' segments
    inner_query: Optional["Query"] = None
    union_datasources: Tuple[str, ...] = ()

    query_type: str = "base"

    @property
    def context_map(self) -> Dict[str, object]:
        return dict(self.context)

    def _datasource_json(self):
        if self.inner_query is not None:
            return {"type": "query", "query": self.inner_query.to_json()}
        if self.union_datasources:
            return {"type": "union",
                    "dataSources": list(self.union_datasources)}
        return self.datasource

    def base_json(self) -> dict:
        return {
            "queryType": self.query_type,
            "dataSource": self._datasource_json(),
            "intervals": [str(iv) for iv in self.intervals],
            "filter": self.filter.to_json() if self.filter else None,
            "granularity": str(self.granularity),
            "virtualColumns": [v.to_json() for v in self.virtual_columns],
            "context": dict(self.context),
        }

    def to_json(self) -> dict:
        return self.base_json()


def _mk(datasource, intervals, flt, granularity, virtual_columns, context):
    return dict(
        datasource=datasource,
        intervals=tuple(normalize_intervals(intervals)),
        filter=flt,
        granularity=Granularity.of(granularity),
        virtual_columns=tuple(virtual_columns or ()),
        context=tuple(sorted((context or {}).items())),
    )


@dataclass(frozen=True)
class TimeseriesQuery(Query):
    """reference: query/timeseries/TimeseriesQuery.java"""
    aggregations: Tuple[AggregatorSpec, ...] = ()
    post_aggregations: Tuple[PostAggregator, ...] = ()
    descending: bool = False
    skip_empty_buckets: bool = False
    query_type: str = "timeseries"

    @staticmethod
    def of(datasource, intervals, aggregations, granularity="all", filter=None,
           post_aggregations=(), descending=False, skip_empty_buckets=False,
           virtual_columns=(), context=None) -> "TimeseriesQuery":
        return TimeseriesQuery(
            aggregations=tuple(aggregations),
            post_aggregations=tuple(post_aggregations),
            descending=descending, skip_empty_buckets=skip_empty_buckets,
            **_mk(datasource, intervals, filter, granularity, virtual_columns,
                  context))

    def to_json(self):
        j = self.base_json()
        j.update(aggregations=[a.to_json() for a in self.aggregations],
                 postAggregations=[p.to_json() for p in self.post_aggregations],
                 descending=self.descending)
        return j


@dataclass(frozen=True)
class TopNQuery(Query):
    """reference: query/topn/TopNQuery.java"""
    dimension: DimensionSpec = None
    metric: str = ""               # ordering metric name (agg or postagg)
    metric_ordering: str = "numeric"  # numeric | lexicographic | inverted(...)
    threshold: int = 10
    aggregations: Tuple[AggregatorSpec, ...] = ()
    post_aggregations: Tuple[PostAggregator, ...] = ()
    query_type: str = "topN"

    @staticmethod
    def of(datasource, intervals, dimension, metric, threshold, aggregations,
           granularity="all", filter=None, post_aggregations=(),
           metric_ordering="numeric", virtual_columns=(), context=None) -> "TopNQuery":
        dim = dimension if isinstance(dimension, DimensionSpec) \
            else DefaultDimensionSpec(dimension, dimension)
        return TopNQuery(
            dimension=dim, metric=metric, metric_ordering=metric_ordering,
            threshold=threshold, aggregations=tuple(aggregations),
            post_aggregations=tuple(post_aggregations),
            **_mk(datasource, intervals, filter, granularity, virtual_columns,
                  context))

    def to_json(self):
        j = self.base_json()
        j.update(dimension=self.dimension.to_json(), metric=self.metric,
                 threshold=self.threshold,
                 aggregations=[a.to_json() for a in self.aggregations],
                 postAggregations=[p.to_json() for p in self.post_aggregations])
        return j


@dataclass(frozen=True)
class GroupByQuery(Query):
    """reference: query/groupby/GroupByQuery.java"""
    dimensions: Tuple[DimensionSpec, ...] = ()
    aggregations: Tuple[AggregatorSpec, ...] = ()
    post_aggregations: Tuple[PostAggregator, ...] = ()
    having: Optional[HavingSpec] = None
    limit_spec: Optional[DefaultLimitSpec] = None
    subtotals: Tuple[Tuple[str, ...], ...] = ()
    query_type: str = "groupBy"

    @staticmethod
    def of(datasource, intervals, dimensions, aggregations, granularity="all",
           filter=None, post_aggregations=(), having=None, limit_spec=None,
           subtotals=(), virtual_columns=(), context=None) -> "GroupByQuery":
        dims = tuple(d if isinstance(d, DimensionSpec)
                     else DefaultDimensionSpec(d, d) for d in dimensions)
        return GroupByQuery(
            dimensions=dims, aggregations=tuple(aggregations),
            post_aggregations=tuple(post_aggregations), having=having,
            limit_spec=limit_spec,
            subtotals=tuple(tuple(s) for s in subtotals),
            **_mk(datasource, intervals, filter, granularity, virtual_columns,
                  context))

    def to_json(self):
        j = self.base_json()
        j.update(dimensions=[d.to_json() for d in self.dimensions],
                 aggregations=[a.to_json() for a in self.aggregations],
                 postAggregations=[p.to_json() for p in self.post_aggregations],
                 having=self.having.to_json() if self.having else None,
                 limitSpec=self.limit_spec.to_json() if self.limit_spec else None,
                 subtotalsSpec=[list(s) for s in self.subtotals] or None)
        return j


@dataclass(frozen=True)
class ScanQuery(Query):
    """reference: query/scan/ScanQuery.java — streaming raw-row export."""
    columns: Tuple[str, ...] = ()
    limit: Optional[int] = None
    offset: int = 0
    order: str = "none"  # none | ascending | descending (by __time)
    batch_size: int = 20480
    query_type: str = "scan"

    @staticmethod
    def of(datasource, intervals, columns=(), limit=None, offset=0, order="none",
           filter=None, virtual_columns=(), context=None) -> "ScanQuery":
        return ScanQuery(
            columns=tuple(columns), limit=limit, offset=offset, order=order,
            **_mk(datasource, intervals, filter, "all", virtual_columns, context))

    def to_json(self):
        j = self.base_json()
        j.update(columns=list(self.columns), limit=self.limit,
                 offset=self.offset, order=self.order,
                 batchSize=self.batch_size)
        return j


@dataclass(frozen=True)
class SelectQuery(Query):
    """reference: query/select/SelectQuery.java — legacy paged scan."""
    dimensions: Tuple[str, ...] = ()
    metrics: Tuple[str, ...] = ()
    paging_spec: Tuple[Tuple[str, int], ...] = ()
    threshold: int = 100
    descending: bool = False
    query_type: str = "select"

    @staticmethod
    def of(datasource, intervals, dimensions=(), metrics=(), threshold=100,
           paging_spec=None, descending=False, filter=None, granularity="all",
           context=None) -> "SelectQuery":
        return SelectQuery(
            dimensions=tuple(dimensions), metrics=tuple(metrics),
            paging_spec=tuple(sorted((paging_spec or {}).items())),
            threshold=threshold, descending=descending,
            **_mk(datasource, intervals, filter, granularity, (), context))

    def to_json(self):
        j = self.base_json()
        j.update(dimensions=list(self.dimensions), metrics=list(self.metrics),
                 pagingSpec={"pagingIdentifiers": dict(self.paging_spec),
                             "threshold": self.threshold},
                 descending=self.descending)
        return j


@dataclass(frozen=True)
class SearchQuery(Query):
    """reference: query/search/SearchQuery.java — find dim values matching."""
    search_dimensions: Tuple[str, ...] = ()   # empty = all dims
    value: str = ""
    case_sensitive: bool = False
    limit: int = 1000
    sort: str = "lexicographic"  # lexicographic | alphanumeric | strlen
    query_type: str = "search"

    @staticmethod
    def of(datasource, intervals, value, search_dimensions=(), limit=1000,
           case_sensitive=False, filter=None, granularity="all", sort="lexicographic",
           context=None) -> "SearchQuery":
        return SearchQuery(
            search_dimensions=tuple(search_dimensions), value=value,
            case_sensitive=case_sensitive, limit=limit, sort=sort,
            **_mk(datasource, intervals, filter, granularity, (), context))

    def to_json(self):
        j = self.base_json()
        j.update(searchDimensions=list(self.search_dimensions),
                 query={"type": "contains", "value": self.value,
                        "caseSensitive": self.case_sensitive},
                 limit=self.limit, sort={"type": self.sort})
        return j


@dataclass(frozen=True)
class TimeBoundaryQuery(Query):
    """reference: query/timeboundary/TimeBoundaryQuery.java"""
    bound: Optional[str] = None  # None | minTime | maxTime
    query_type: str = "timeBoundary"

    @staticmethod
    def of(datasource, intervals=None, bound=None, filter=None,
           context=None) -> "TimeBoundaryQuery":
        return TimeBoundaryQuery(
            bound=bound,
            **_mk(datasource, intervals, filter, "all", (), context))

    def to_json(self):
        j = self.base_json()
        j.update(bound=self.bound)
        return j


@dataclass(frozen=True)
class SegmentMetadataQuery(Query):
    """reference: query/metadata/SegmentMetadataQuery.java"""
    to_include: Tuple[str, ...] = ()  # empty = all columns
    analysis_types: Tuple[str, ...] = ("cardinality", "size", "interval", "minmax")
    merge: bool = False
    query_type: str = "segmentMetadata"

    @staticmethod
    def of(datasource, intervals=None, to_include=(), merge=False,
           analysis_types=("cardinality", "size", "interval", "minmax"),
           context=None) -> "SegmentMetadataQuery":
        return SegmentMetadataQuery(
            to_include=tuple(to_include), merge=merge,
            analysis_types=tuple(analysis_types),
            **_mk(datasource, intervals, None, "all", (), context))

    def to_json(self):
        j = self.base_json()
        j.update(toInclude={"type": "list", "columns": list(self.to_include)}
                 if self.to_include else {"type": "all"},
                 analysisTypes=list(self.analysis_types), merge=self.merge)
        return j


@dataclass(frozen=True)
class DataSourceMetadataQuery(Query):
    """reference: query/datasourcemetadata/DataSourceMetadataQuery.java —
    max ingested event time."""
    query_type: str = "dataSourceMetadata"

    @staticmethod
    def of(datasource, context=None) -> "DataSourceMetadataQuery":
        return DataSourceMetadataQuery(
            **_mk(datasource, None, None, "all", (), context))


def _topn_metric(m) -> Tuple[str, str]:
    if isinstance(m, str):
        return m, "numeric"
    mt = m.get("type", "numeric")
    if mt == "numeric":
        return m.get("metric", ""), "numeric"
    if mt == "inverted":
        inner = m.get("metric", "")
        if isinstance(inner, dict):
            return inner.get("metric", ""), (
                "inverted_lexicographic"
                if inner.get("type") in ("dimension", "lexicographic")
                else "inverted")
        return inner, "inverted"
    if mt in ("dimension", "lexicographic", "alphaNumeric"):
        return "", "lexicographic"
    raise ValueError(f"unknown topN metric spec type {mt!r}")


def query_from_json(j: dict) -> Query:
    """Wire-format deserialization (reference: Jackson polymorphic Query),
    including polymorphic dataSources (table | union | query)."""
    ds_j = j.get("dataSource", "")
    inner_q = None
    union: Tuple[str, ...] = ()
    if isinstance(ds_j, dict):
        dtype = ds_j.get("type", "table")
        if dtype == "table":
            ds = ds_j["name"]
        elif dtype == "union":
            union = tuple(ds_j["dataSources"])
            ds = union[0] if union else ""
        elif dtype == "query":
            inner_q = query_from_json(ds_j["query"])
            ds = inner_q.datasource
        else:
            raise ValueError(f"unknown dataSource type {dtype!r}")
    else:
        ds = ds_j
    q = _query_body_from_json(j, ds)
    if inner_q is not None or union:
        q = replace(q, inner_query=inner_q, union_datasources=union)
    return q


def _query_body_from_json(j: dict, ds: str) -> Query:
    t = j["queryType"]
    ivs = j.get("intervals")
    if isinstance(ivs, dict):  # {"type": "intervals", "intervals": [...]}
        ivs = ivs.get("intervals")
    common = dict(
        intervals=ivs,
        filter=filter_from_json(j.get("filter")),
        granularity=j.get("granularity", "all"),
        context=j.get("context"),
    )
    vcs = tuple(virtualcolumn_from_json(v)
                for v in j.get("virtualColumns") or ())
    if t == "timeseries":
        ctx = j.get("context") or {}
        return TimeseriesQuery.of(
            ds, aggregations=[agg_from_json(a) for a in j.get("aggregations", [])],
            post_aggregations=[postagg_from_json(p)
                               for p in j.get("postAggregations", [])],
            descending=j.get("descending", False),
            skip_empty_buckets=bool(ctx.get("skipEmptyBuckets", False)),
            virtual_columns=vcs, **common)
    if t == "topN":
        metric, ordering = _topn_metric(j["metric"])
        return TopNQuery.of(
            ds, dimension=dimspec_from_json(j["dimension"]),
            metric=metric, metric_ordering=ordering,
            threshold=j["threshold"],
            aggregations=[agg_from_json(a) for a in j.get("aggregations", [])],
            post_aggregations=[postagg_from_json(p)
                               for p in j.get("postAggregations", [])],
            virtual_columns=vcs, **common)
    if t == "groupBy":
        ls = j.get("limitSpec")
        limit_spec = None
        if ls:
            limit_spec = DefaultLimitSpec(
                tuple(OrderByColumnSpec(c["dimension"], c.get("direction", "ascending"),
                                        c.get("dimensionOrder", "lexicographic"))
                      if isinstance(c, dict) else OrderByColumnSpec(c)
                      for c in ls.get("columns", [])),
                ls.get("limit"), ls.get("offset", 0))
        return GroupByQuery.of(
            ds, dimensions=[dimspec_from_json(d) for d in j.get("dimensions", [])],
            aggregations=[agg_from_json(a) for a in j.get("aggregations", [])],
            post_aggregations=[postagg_from_json(p)
                               for p in j.get("postAggregations", [])],
            having=having_from_json(j.get("having")),
            limit_spec=limit_spec,
            subtotals=j.get("subtotalsSpec") or (), virtual_columns=vcs, **common)
    if t == "scan":
        common.pop("granularity")
        q = ScanQuery.of(ds, columns=j.get("columns", ()),
                         limit=j.get("limit"), offset=j.get("offset", 0),
                         order=j.get("order", "none"), virtual_columns=vcs,
                         **common)
        if j.get("batchSize"):
            q = replace(q, batch_size=int(j["batchSize"]))
        return q
    if t == "select":
        ps = j.get("pagingSpec", {})
        return SelectQuery.of(ds, dimensions=j.get("dimensions", ()),
                              metrics=j.get("metrics", ()),
                              threshold=ps.get("threshold", 100),
                              paging_spec=ps.get("pagingIdentifiers"),
                              descending=j.get("descending", False), **common)
    if t == "search":
        q = j.get("query", {})
        return SearchQuery.of(ds, value=q.get("value", ""),
                              search_dimensions=j.get("searchDimensions", ()),
                              limit=j.get("limit", 1000),
                              case_sensitive=q.get("caseSensitive", False),
                              sort=(j.get("sort") or {}).get("type", "lexicographic"),
                              **common)
    if t == "timeBoundary":
        common.pop("granularity")
        return TimeBoundaryQuery.of(ds, bound=j.get("bound"), **common)
    if t == "segmentMetadata":
        inc = j.get("toInclude") or {}
        return SegmentMetadataQuery.of(
            ds, intervals=common["intervals"],
            to_include=inc.get("columns", ()) if inc.get("type") == "list" else (),
            merge=j.get("merge", False),
            analysis_types=tuple(j.get("analysisTypes",
                                       ("cardinality", "size", "interval", "minmax"))),
            context=j.get("context"))
    if t == "dataSourceMetadata":
        return DataSourceMetadataQuery.of(ds, context=j.get("context"))
    raise ValueError(f"unknown query type {t!r}")
