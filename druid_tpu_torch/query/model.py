"""The aggregate query model: timeseries, topN and groupBy.

The port's copy of the reference package's `query/model.py`, cut to the three
aggregate query types over a table dataSource, default dimension specs and
DefaultLimitSpec. Other query types, dataSource kinds, dimension specs,
having, subtotals and virtual columns raise NotImplementedError. JSON serde
mirrors the reference's Jackson wire format.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from druid_tpu_torch.query.aggregators import AggregatorSpec, agg_from_json
from druid_tpu_torch.query.filters import DimFilter, filter_from_json
from druid_tpu_torch.query.postaggs import PostAggregator, postagg_from_json
from druid_tpu_torch.utils.granularity import Granularity
from druid_tpu_torch.utils.intervals import Interval, normalize_intervals


@dataclass(frozen=True)
class DefaultDimensionSpec:
    dimension: str
    output_name: str = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.output_name is None:
            object.__setattr__(self, "output_name", self.dimension)


def dimspec_from_json(j) -> DefaultDimensionSpec:
    if isinstance(j, str):
        return DefaultDimensionSpec(j, j)
    t = j.get("type", "default")
    if t != "default":
        raise NotImplementedError(f"dimension spec {t!r}")
    return DefaultDimensionSpec(j["dimension"],
                                j.get("outputName") or j["dimension"])


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
    context: Tuple[Tuple[str, object], ...] = ()
    query_type: str = "base"

    @property
    def context_map(self) -> Dict[str, object]:
        return dict(self.context)


def _mk(datasource, intervals, flt, granularity, context):
    return dict(
        datasource=datasource,
        intervals=tuple(normalize_intervals(intervals)),
        filter=flt,
        granularity=Granularity.of(granularity),
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
           context=None) -> "TimeseriesQuery":
        return TimeseriesQuery(
            aggregations=tuple(aggregations),
            post_aggregations=tuple(post_aggregations),
            descending=descending, skip_empty_buckets=skip_empty_buckets,
            **_mk(datasource, intervals, filter, granularity, context))


@dataclass(frozen=True)
class TopNQuery(Query):
    """reference: query/topn/TopNQuery.java"""
    dimension: DefaultDimensionSpec = None
    metric: str = ""               # ordering metric name (agg or postagg)
    metric_ordering: str = "numeric"  # numeric | lexicographic | inverted(...)
    threshold: int = 10
    aggregations: Tuple[AggregatorSpec, ...] = ()
    post_aggregations: Tuple[PostAggregator, ...] = ()
    query_type: str = "topN"

    @staticmethod
    def of(datasource, intervals, dimension, metric, threshold, aggregations,
           granularity="all", filter=None, post_aggregations=(),
           metric_ordering="numeric", context=None) -> "TopNQuery":
        dim = dimension if isinstance(dimension, DefaultDimensionSpec) \
            else DefaultDimensionSpec(dimension, dimension)
        return TopNQuery(
            dimension=dim, metric=metric, metric_ordering=metric_ordering,
            threshold=threshold, aggregations=tuple(aggregations),
            post_aggregations=tuple(post_aggregations),
            **_mk(datasource, intervals, filter, granularity, context))


@dataclass(frozen=True)
class GroupByQuery(Query):
    """reference: query/groupby/GroupByQuery.java"""
    dimensions: Tuple[DefaultDimensionSpec, ...] = ()
    aggregations: Tuple[AggregatorSpec, ...] = ()
    post_aggregations: Tuple[PostAggregator, ...] = ()
    limit_spec: Optional[DefaultLimitSpec] = None
    query_type: str = "groupBy"

    @staticmethod
    def of(datasource, intervals, dimensions, aggregations, granularity="all",
           filter=None, post_aggregations=(), limit_spec=None,
           context=None) -> "GroupByQuery":
        dims = tuple(d if isinstance(d, DefaultDimensionSpec)
                     else DefaultDimensionSpec(d, d) for d in dimensions)
        return GroupByQuery(
            dimensions=dims, aggregations=tuple(aggregations),
            post_aggregations=tuple(post_aggregations),
            limit_spec=limit_spec,
            **_mk(datasource, intervals, filter, granularity, context))


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
    for key in ("virtualColumns", "having", "subtotalsSpec"):
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
