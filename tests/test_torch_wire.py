"""Wire serialization in the port: every query, dimension spec, limit spec,
having spec, virtual column, filter, aggregator and post-aggregator.

Each JSON below parses in both packages; the port's `to_json` must equal
the reference's, and parsing the port's `to_json` must give back an equal
object (`query_from_json(q.to_json()) == q`).
"""
import json

import pytest

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.query.model import query_from_json as ref_query_json

from druid_tpu_torch.query.model import query_from_json as port_query_json

IV = ["2026-01-01/2026-01-02"]
FILTERS = [
    {"type": "selector", "dimension": "d", "value": "x"},
    {"type": "selector", "dimension": "d", "value": None,
     "extractionFn": {"type": "substring", "index": 1, "length": 2}},
    {"type": "in", "dimension": "d", "values": ["a", "b"],
     "extractionFn": {"type": "upper"}},
    {"type": "bound", "dimension": "m", "lower": "1", "upper": "9",
     "lowerStrict": True, "ordering": "numeric"},
    {"type": "like", "dimension": "d", "pattern": "a\\_%", "escape": "\\"},
    {"type": "regex", "dimension": "d", "pattern": "^v0+1"},
    {"type": "search", "dimension": "d",
     "query": {"type": "contains", "value": "Ab", "caseSensitive": True}},
    {"type": "interval", "dimension": "__time",
     "intervals": ["2026-01-01T01:00:00Z/2026-01-01T02:00:00Z"]},
    {"type": "columnComparison", "dimensions": ["a", "b"]},
    {"type": "expression", "expression": "m * 2 > 3 && d == 'x'"},
    {"type": "spatial", "dimension": "loc",
     "bound": {"type": "rectangular", "minCoords": [0, 1],
               "maxCoords": [2.5, 3]}},
    {"type": "spatial", "dimension": "loc",
     "bound": {"type": "polygon", "abscissa": [0, 1, 1],
               "ordinate": [0, 0, 1]}},
    {"type": "and", "fields": [{"type": "true"}, {"type": "not", "field": {
        "type": "or", "fields": [{"type": "false"},
                                 {"type": "selector", "dimension": "d",
                                  "value": "y"}]}}]},
]
AGGS = [
    {"type": "count", "name": "n"},
    {"type": "longSum", "name": "a", "fieldName": "m"},
    {"type": "doubleSum", "name": "b", "fieldName": "m"},
    {"type": "floatSum", "name": "c", "fieldName": "m"},
    {"type": "longMin", "name": "d", "fieldName": "m"},
    {"type": "doubleMax", "name": "e", "fieldName": "m"},
    {"type": "floatMin", "name": "f", "fieldName": "m"},
    {"type": "floatLast", "name": "g", "fieldName": "m"},
    {"type": "longFirst", "name": "h", "fieldName": "m"},
    {"type": "hyperUnique", "name": "i", "fieldName": "d", "log2m": 12,
     "round": True},
    {"type": "cardinality", "name": "j", "fields": ["x", "y"],
     "byRow": True},
    {"type": "filtered", "name": "k",
     "aggregator": {"type": "longMax", "name": "k", "fieldName": "m"},
     "filter": FILTERS[3]},
]
POSTS = [
    {"type": "arithmetic", "name": "avg", "fn": "/", "fields": [
        {"type": "fieldAccess", "fieldName": "a"},
        {"type": "finalizingFieldAccess", "name": "nn", "fieldName": "n"}]},
    {"type": "arithmetic", "name": "q", "fn": "quotient", "fields": [
        {"type": "constant", "name": "one", "value": 1},
        {"type": "hyperUniqueCardinality", "name": "hu",
         "fieldName": "i"}]},
    {"type": "doubleGreatest", "name": "dg", "fields": [
        {"type": "fieldAccess", "fieldName": "a"},
        {"type": "fieldAccess", "fieldName": "b"}]},
    {"type": "longLeast", "name": "ll", "fields": [
        {"type": "fieldAccess", "fieldName": "a"},
        {"type": "constant", "name": "z", "value": 0}]},
]
DIMS = [
    "dimA",
    {"type": "default", "dimension": "dimB", "outputName": "b"},
    {"type": "extraction", "dimension": "dimC", "outputName": "c",
     "extractionFn": {"type": "cascade", "extractionFns": [
         {"type": "regex", "expr": "v(\\d)", "replaceMissingValue": True,
          "replaceMissingValueWith": "none"},
         {"type": "lookup", "lookup": {"type": "map", "map": {"1": "one"}},
          "retainMissingValue": False},
         {"type": "timeFormat", "format": "yyyy", "granularity": "day"},
         {"type": "stringFormat", "format": "[%s]"}, {"type": "strlen"},
         {"type": "lower"}]}},
    {"type": "listFiltered", "delegate": {
        "type": "extraction", "dimension": "dimD", "outputName": "dd",
        "extractionFn": {"type": "registeredLookup", "lookup": "lk"}},
     "values": ["a", "b"], "isWhitelist": False},
    {"type": "expression", "expression": "m / 10", "outputName": "e",
     "outputType": "long"},
]
VCS = [{"type": "expression", "name": "v", "expression": "m * 2",
        "outputType": "float"}]


def _base(query_type, **kw):
    return {"queryType": query_type, "dataSource": "ds", "intervals": IV,
            **kw}


GROUPBY = _base(
    "groupBy", granularity="hour", dimensions=DIMS, aggregations=AGGS,
    postAggregations=POSTS, virtualColumns=VCS, filter=FILTERS[12],
    having={"type": "or", "havingSpecs": [
        {"type": "not", "havingSpec": {"type": "equalTo",
                                       "aggregation": "n", "value": 3}},
        {"type": "filter", "filter": FILTERS[0]},
        {"type": "and", "havingSpecs": [
            {"type": "lessThan", "aggregation": "a", "value": 1.5},
            {"type": "dimSelector", "dimension": "b", "value": "x"}]}]},
    limitSpec={"type": "default", "limit": 10, "offset": 3, "columns": [
        "b", {"dimension": "a", "direction": "descending",
              "dimensionOrder": "numeric"}]},
    subtotalsSpec=[["b"], []], context={"queryId": "x", "timeout": 5})
WIRE = {
    "timeseries": _base("timeseries", granularity="day", aggregations=AGGS,
                        postAggregations=POSTS, descending=True,
                        virtualColumns=VCS, filter=FILTERS[3],
                        context={"skipEmptyBuckets": True}),
    "topN": _base("topN", dimension=DIMS[2], metric="a", threshold=7,
                  aggregations=AGGS, postAggregations=POSTS,
                  filter=FILTERS[6]),
    "groupBy": GROUPBY,
    "groupBy_intervals_object": {**GROUPBY, "intervals": {
        "type": "intervals", "intervals": IV}},
    "scan": _base("scan", columns=["__time", "d"], limit=5, offset=2,
                  order="descending", batchSize=99, filter=FILTERS[9],
                  virtualColumns=VCS),
    "select": _base("select", dimensions=["d"], metrics=["m"],
                    pagingSpec={"pagingIdentifiers": {"s1": 4},
                                "threshold": 20},
                    descending=True, granularity="day"),
    "search": _base("search", searchDimensions=["d", "e"],
                    query={"type": "contains", "value": "Q",
                           "caseSensitive": True},
                    limit=12, sort={"type": "strlen"}, filter=FILTERS[1]),
    "timeBoundary": _base("timeBoundary", bound="maxTime",
                          filter=FILTERS[10]),
    "segmentMetadata": _base("segmentMetadata", merge=True,
                             toInclude={"type": "list", "columns": ["d"]},
                             analysisTypes=["cardinality", "size"]),
    "segmentMetadata_all": {"queryType": "segmentMetadata",
                            "dataSource": {"type": "table", "name": "ds"}},
    "dataSourceMetadata": {"queryType": "dataSourceMetadata",
                           "dataSource": "ds", "context": {"a": 1}},
    "union": {**GROUPBY, "dataSource": {"type": "union",
                                        "dataSources": ["ds", "ds2"]}},
    "query": _base("timeseries", aggregations=AGGS[:2], dataSource={
        "type": "query", "query": GROUPBY}),
    "nested_query": _base("groupBy", dimensions=["b"], aggregations=AGGS[:1],
                          dataSource={"type": "query", "query": _base(
                              "groupBy", dimensions=["b"],
                              aggregations=AGGS[:2], dataSource={
                                  "type": "query", "query": GROUPBY})}),
}
for _i, _f in enumerate(FILTERS):
    WIRE[f"filter_{_i}"] = _base("timeseries", aggregations=AGGS[:1],
                                 filter=_f)


@pytest.mark.parametrize("name", sorted(WIRE))
def test_to_json_equals_reference(name):
    j = WIRE[name]
    q = port_query_json(j)
    got = q.to_json()
    assert got == ref_query_json(j).to_json()
    json.dumps(got)                      # plain JSON all the way down
    assert port_query_json(got) == q
    assert port_query_json(got).to_json() == got
