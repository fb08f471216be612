"""Having, subtotalsSpec and the greatest/least post-aggregators in the port.

The same segments (made by the reference's DataGenerator, carried into the
port as plain arrays) and the same groupBy JSON through both
`QueryExecutor`s, the port's with device="cpu". Every having type (and the
reference's tests/test_topn_groupby.py having case) and subtotals over
count, sums, min/max, first/last and HLL aggregators: equal rows (counts,
long sums, min/max, first/last and HLL estimates bit for bit).

greatest/least (a divergence on purpose): the reference computes the
post-aggregator with float() over each field, so on groupBy and topN,
whose finish passes whole columns, it raises ValueError. Druid computes it
row by row; the port computes it element by element over the columns: the
test holds the reference to its ValueError and the port's column to
np.maximum / np.minimum over the fields (a null read as 0.0, the
reference's rule). On timeseries, where the reference answers, the rows
are equal.
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.query.model import having_from_json as ref_having_json

from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.query.model import having_from_json as port_having_json
from tests.test_torch_native_queries import make_segments, run_both, same

torch.set_num_threads(1)

SPAN = "2026-01-01/2026-01-04"
AGGS = [{"type": "count", "name": "rows"},
        {"type": "longSum", "name": "sumLong", "fieldName": "metLong"},
        {"type": "longMax", "name": "maxLong", "fieldName": "metLong"},
        {"type": "floatMin", "name": "minFloat", "fieldName": "metFloat"}]


@pytest.fixture(scope="module")
def segs():
    return make_segments()


def _gb(dims=("dimA", "dimB"), aggs=AGGS, **kw):
    return {"queryType": "groupBy", "dataSource": "test",
            "intervals": [SPAN], "granularity": "all",
            "dimensions": list(dims), "aggregations": aggs, **kw}


def _sel(dim, value):
    return {"type": "dimSelector", "dimension": dim, "value": value}


HAVINGS = {
    "greaterThan": {"type": "greaterThan", "aggregation": "rows",
                    "value": 20},
    "lessThan": {"type": "lessThan", "aggregation": "sumLong",
                 "value": 900},
    "equalTo": {"type": "equalTo", "aggregation": "maxLong", "value": 99},
    "and": {"type": "and", "havingSpecs": [
        {"type": "greaterThan", "aggregation": "rows", "value": 3},
        {"type": "lessThan", "aggregation": "minFloat", "value": 5.0}]},
    "or": {"type": "or", "havingSpecs": [
        _sel("dimA", "v00000002"),
        {"type": "greaterThan", "aggregation": "sumLong", "value": 2_000}]},
    "not": {"type": "not", "havingSpec": _sel("dimB", "v00000000")},
    "dimSelector": _sel("dimB", "v00000003"),
    "dimSelector_missing": _sel("nosuch", None),
    "filter": {"type": "filter", "filter": {
        "type": "and", "fields": [
            {"type": "bound", "dimension": "sumLong", "lower": "500",
             "ordering": "numeric"},
            {"type": "regex", "dimension": "dimA", "pattern": "[13579]$"}]}},
    "filter_on_aggregate_in": {"type": "filter", "filter": {
        "type": "in", "dimension": "maxLong", "values": ["97", "98"]}},
}


@pytest.mark.parametrize("name", sorted(HAVINGS))
def test_having_matches_reference(segs, name):
    q = _gb(having=HAVINGS[name])
    want, got = run_both(segs, q)
    same(want, got)
    everything, _ = run_both(segs, _gb())
    assert 0 < len(want) < len(everything) or name == "dimSelector_missing"


@pytest.mark.parametrize("name", sorted(HAVINGS))
def test_having_json_matches_reference(name):
    h = port_having_json(HAVINGS[name])
    assert h.to_json() == ref_having_json(HAVINGS[name]).to_json()
    assert port_having_json(h.to_json()) == h


def test_groupby_having_and_limit(segs):
    """The reference's test_topn_groupby.py case: having greaterThan with a
    numeric descending limitSpec."""
    q = _gb(dims=["dimA"], aggs=AGGS[:2],
            having={"type": "greaterThan", "aggregation": "rows",
                    "value": 100},
            limitSpec={"type": "default", "limit": 3, "columns": [
                {"dimension": "sumLong", "direction": "descending",
                 "dimensionOrder": "numeric"}]})
    want, got = run_both(segs, q)
    same(want, got)
    vals = [r["event"]["sumLong"] for r in got]
    assert len(got) == 3 and vals == sorted(vals, reverse=True)
    assert all(r["event"]["rows"] > 100 for r in got)


SUB_AGGS = AGGS + [
    {"type": "longFirst", "name": "firstLong", "fieldName": "metLong"},
    {"type": "floatLast", "name": "lastFloat", "fieldName": "metFloat"},
    {"type": "cardinality", "name": "cardB", "fields": ["dimB"]},
    {"type": "hyperUnique", "name": "huA", "fieldName": "dimA",
     "round": True},
    {"type": "filtered", "name": "f3",
     "aggregator": {"type": "count", "name": "f3"},
     "filter": {"type": "selector", "dimension": "dimB",
                "value": "v00000003"}},
]
SUBTOTALS = {
    "dims_and_total": ([["dimA"], ["dimB"], []], "all"),
    "daily": ([["dimA"], []], "day"),
    "unknown_dimension": ([["nosuch"]], "all"),
}


@pytest.mark.parametrize("name", sorted(SUBTOTALS))
def test_subtotals_match_reference(segs, name):
    spec, gran = SUBTOTALS[name]
    q = _gb(aggs=SUB_AGGS, subtotalsSpec=spec, granularity=gran,
            postAggregations=[{"type": "arithmetic", "name": "avg",
                               "fn": "/", "fields": [
                                   {"type": "fieldAccess",
                                    "fieldName": "sumLong"},
                                   {"type": "fieldAccess",
                                    "fieldName": "rows"}]}])
    want, got = run_both(segs, q)
    same(want, got)
    base, _ = run_both(segs, {**q, "subtotalsSpec": None})
    assert len(got) > len(base)
    if name == "dims_and_total":
        total = got[-1]["event"]
        assert set(total) == {a["name"] for a in SUB_AGGS} | {"avg"}
        assert total["rows"] == sum(s.n_rows for s in segs[1])


def test_subtotals_with_having_and_limit(segs):
    q = _gb(aggs=AGGS, subtotalsSpec=[["dimA"], []],
            having={"type": "greaterThan", "aggregation": "rows",
                    "value": 30},
            limitSpec={"type": "default", "limit": 15, "offset": 2,
                       "columns": [{"dimension": "rows",
                                    "direction": "descending",
                                    "dimensionOrder": "numeric"}]})
    want, got = run_both(segs, q)
    same(want, got)


GREATEST = [
    {"type": "doubleGreatest", "name": "g", "fields": [
        {"type": "fieldAccess", "fieldName": "sumLong"},
        {"type": "fieldAccess", "fieldName": "minFloat"},
        {"type": "constant", "name": "c", "value": 150}]},
    {"type": "longLeast", "name": "l", "fields": [
        {"type": "fieldAccess", "fieldName": "rows"},
        {"type": "fieldAccess", "fieldName": "maxLong"},
        {"type": "fieldAccess", "fieldName": "nosuch"}]},
    {"type": "doubleLeast", "name": "l2", "fields": [
        {"type": "fieldAccess", "fieldName": "rows"},
        {"type": "arithmetic", "name": "x", "fn": "*", "fields": [
            {"type": "fieldAccess", "fieldName": "minFloat"},
            {"type": "constant", "name": "k", "value": 2}]}]},
]


def _expected(row):
    """The reference's rule, field by field: float(v or 0.0)."""
    return {"g": max(float(row["sumLong"]), float(row["minFloat"]), 150.0),
            "l": min(float(row["rows"]), float(row["maxLong"]), 0.0),
            "l2": min(float(row["rows"]), float(row["minFloat"]) * 2.0)}


@pytest.mark.parametrize("shape", ["groupBy", "topN"])
def test_greatest_least_pinned(segs, shape):
    """The reference raises on groupBy and topN; the port's column is
    np.maximum / np.minimum over the fields."""
    ref, port = segs
    if shape == "groupBy":
        q = _gb(postAggregations=GREATEST)
    else:
        q = {"queryType": "topN", "dataSource": "test",
             "intervals": [SPAN], "granularity": "all", "dimension": "dimB",
             "metric": "g", "threshold": 15, "aggregations": AGGS,
             "postAggregations": GREATEST}
    with pytest.raises(ValueError, match="truth value"):
        RefExecutor(ref).run_json(q)
    got = PortExecutor(port, device="cpu").run_json(q)
    rows = [r["event"] for r in got] if shape == "groupBy" \
        else got[0]["result"]
    assert rows
    cols = {k: np.asarray([r[k] for r in rows], dtype=np.float64)
            for k in ("rows", "sumLong", "maxLong", "minFloat", "g", "l",
                      "l2")}
    np.testing.assert_array_equal(cols["g"], np.maximum.reduce(
        [cols["sumLong"], cols["minFloat"], np.full(len(rows), 150.0)]))
    np.testing.assert_array_equal(cols["l"], np.minimum.reduce(
        [cols["rows"], cols["maxLong"], np.zeros(len(rows))]))
    np.testing.assert_array_equal(cols["l2"], np.minimum(
        cols["rows"], cols["minFloat"] * 2.0))
    for r in rows:
        assert {k: r[k] for k in ("g", "l", "l2")} == _expected(r)
    if shape == "topN":
        assert cols["g"].tolist() == sorted(cols["g"], reverse=True)


def test_greatest_least_timeseries_equal(segs):
    q = {"queryType": "timeseries", "dataSource": "test",
         "intervals": [SPAN], "granularity": "day", "aggregations": AGGS,
         "postAggregations": GREATEST}
    want, got = run_both(segs, q)
    assert len(want) == 3
    same(want, got)
