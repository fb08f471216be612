"""The aggregate query model: timeseries, topN and groupBy.

The port's copy of the reference package's `query/model.py`, cut to the three
aggregate query types over a table dataSource, with the reference's
dimension specs (default, extraction, listFiltered, expression), its
extraction functions, expression virtual columns and DefaultLimitSpec.
Other query types, dataSource kinds, having and subtotals raise
NotImplementedError. JSON serde mirrors the reference's Jackson wire
format.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
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


@dataclass(frozen=True)
class ExtractionDimensionSpec(DimensionSpec):
    dimension: str
    output_name: str
    fn: ExtractionFn = None

    @property
    def extraction_fn(self):
        return self.fn


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


@dataclass(frozen=True)
class ExpressionDimensionSpec(DimensionSpec):
    """Group by a computed expression (the reference's
    virtualColumn-as-dimension path). Evaluated on the host per segment into
    a query-time value dictionary; the device then groups by compact ids
    like any other dimension (engines._keydim_for)."""
    expression: str = ""
    output_name: str = ""
    output_type: str = "long"     # long | double | string

    @property
    def dimension(self):
        return self.output_name


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



@dataclass(frozen=True)
class ExpressionVirtualColumn:
    """reference: segment/virtual/ExpressionVirtualColumn.java"""
    name: str
    expression: str
    output_type: str = "double"  # long | double | float | string


def virtualcolumn_from_json(j) -> ExpressionVirtualColumn:
    if j["type"] != "expression":
        raise ValueError(f"unknown virtual column {j['type']!r}")
    return ExpressionVirtualColumn(j["name"], j["expression"],
                                   j.get("outputType", "double"))


@dataclass(frozen=True)
class OrderByColumnSpec:
    dimension: str
    direction: str = "ascending"   # ascending | descending
    dimension_order: str = "lexicographic"  # lexicographic | numeric


@dataclass(frozen=True)
class DefaultLimitSpec:
    columns: Tuple[OrderByColumnSpec, ...] = ()
    limit: Optional[int] = None
    offset: int = 0


@dataclass(frozen=True)
class Query:
    datasource: str = ""
    intervals: Tuple[Interval, ...] = ()
    filter: Optional[DimFilter] = None
    granularity: Granularity = Granularity.ALL
    virtual_columns: Tuple[ExpressionVirtualColumn, ...] = ()
    context: Tuple[Tuple[str, object], ...] = ()
    query_type: str = "base"

    @property
    def context_map(self) -> Dict[str, object]:
        return dict(self.context)


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
           metric_ordering="numeric", virtual_columns=(),
           context=None) -> "TopNQuery":
        dim = dimension if isinstance(dimension, DimensionSpec) \
            else DefaultDimensionSpec(dimension, dimension)
        return TopNQuery(
            dimension=dim, metric=metric, metric_ordering=metric_ordering,
            threshold=threshold, aggregations=tuple(aggregations),
            post_aggregations=tuple(post_aggregations),
            **_mk(datasource, intervals, filter, granularity, virtual_columns,
                  context))


@dataclass(frozen=True)
class GroupByQuery(Query):
    """reference: query/groupby/GroupByQuery.java"""
    dimensions: Tuple[DimensionSpec, ...] = ()
    aggregations: Tuple[AggregatorSpec, ...] = ()
    post_aggregations: Tuple[PostAggregator, ...] = ()
    limit_spec: Optional[DefaultLimitSpec] = None
    query_type: str = "groupBy"

    @staticmethod
    def of(datasource, intervals, dimensions, aggregations, granularity="all",
           filter=None, post_aggregations=(), limit_spec=None,
           virtual_columns=(), context=None) -> "GroupByQuery":
        dims = tuple(d if isinstance(d, DimensionSpec)
                     else DefaultDimensionSpec(d, d) for d in dimensions)
        return GroupByQuery(
            dimensions=dims, aggregations=tuple(aggregations),
            post_aggregations=tuple(post_aggregations),
            limit_spec=limit_spec,
            **_mk(datasource, intervals, filter, granularity, virtual_columns,
                  context))


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
    """Wire-format deserialization of a timeseries/topN/groupBy query over
    a table dataSource."""
    ds = j.get("dataSource", "")
    if isinstance(ds, dict):
        if ds.get("type", "table") != "table":
            raise NotImplementedError(f"dataSource type {ds.get('type')!r}")
        ds = ds["name"]
    for key in ("having", "subtotalsSpec"):
        if j.get(key):
            raise NotImplementedError(f"{key} in a query")
    t = j["queryType"]
    ivs = j.get("intervals")
    if isinstance(ivs, dict):  # {"type": "intervals", "intervals": [...]}
        ivs = ivs.get("intervals")
    common = dict(
        intervals=ivs,
        filter=filter_from_json(j.get("filter")),
        granularity=j.get("granularity", "all"),
        virtual_columns=tuple(virtualcolumn_from_json(v)
                              for v in j.get("virtualColumns") or ()),
        context=j.get("context"),
    )
    aggs = [agg_from_json(a) for a in j.get("aggregations", [])]
    posts = [postagg_from_json(p) for p in j.get("postAggregations", [])]
    if t == "timeseries":
        ctx = j.get("context") or {}
        return TimeseriesQuery.of(
            ds, aggregations=aggs, post_aggregations=posts,
            descending=j.get("descending", False),
            skip_empty_buckets=bool(ctx.get("skipEmptyBuckets", False)),
            **common)
    if t == "topN":
        metric, ordering = _topn_metric(j["metric"])
        return TopNQuery.of(
            ds, dimension=dimspec_from_json(j["dimension"]),
            metric=metric, metric_ordering=ordering,
            threshold=j["threshold"], aggregations=aggs,
            post_aggregations=posts, **common)
    if t == "groupBy":
        ls = j.get("limitSpec")
        limit_spec = None
        if ls:
            limit_spec = DefaultLimitSpec(
                tuple(OrderByColumnSpec(c["dimension"],
                                        c.get("direction", "ascending"),
                                        c.get("dimensionOrder",
                                              "lexicographic"))
                      if isinstance(c, dict) else OrderByColumnSpec(c)
                      for c in ls.get("columns", [])),
                ls.get("limit"), ls.get("offset", 0))
        return GroupByQuery.of(
            ds, dimensions=[dimspec_from_json(d)
                            for d in j.get("dimensions", [])],
            aggregations=aggs, post_aggregations=posts,
            limit_spec=limit_spec, **common)
    raise NotImplementedError(f"query type {t!r}")
