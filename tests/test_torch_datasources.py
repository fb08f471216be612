"""Union and query dataSources and the chunkPeriod context in the port.

The cases of the reference's tests/test_datasources.py and
tests/test_chunking.py at the executor (their broker cases wait for the
port's serving layer): the same segments, made by the reference's
DataGenerator and carried into the port as plain arrays, the same JSON
through both `QueryExecutor`s (the port's with device="cpu"), equal rows.
A query dataSource's inner groupBy rows become a segment
(`subquery_segment`), which the outer query reads through the ordinary
engines.
"""
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.engine.executor import subquery_segment as ref_subquery
from druid_tpu.query.model import query_from_json as ref_query_json
from druid_tpu.utils.intervals import Interval
from druid_tpu.utils.intervals import parse_period_ms as ref_period
from druid_tpu.utils.intervals import split_by_period as ref_split

from druid_tpu_torch.data.convert import segment_from_arrays
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine.executor import apply_interval_chunking
from druid_tpu_torch.engine.executor import subquery_segment as port_subquery
from druid_tpu_torch.query.model import query_from_json as port_query_json
from druid_tpu_torch.utils.intervals import Interval as PortInterval
from druid_tpu_torch.utils.intervals import parse_period_ms, split_by_period
from tests.test_torch_native_queries import make_segments, run_both, same

torch.set_num_threads(1)

WEEK = "2026-01-01/2026-01-08"
AGGS = [{"type": "count", "name": "rows"},
        {"type": "longSum", "name": "ls", "fieldName": "metLong"}]


@pytest.fixture(scope="module")
def segs():
    """3 segments of "test" and 2 of "other", each package its own copy."""
    ref, port = make_segments()
    ref_o, port_o = make_segments(2, 2_000, seed=5, datasource="other")
    return ref + ref_o, port + port_o


def _inner(**kw):
    return {"queryType": "groupBy", "dataSource": "test",
            "intervals": [WEEK], "granularity": "all",
            "dimensions": ["dimA", "dimB"],
            "aggregations": [{"type": "count", "name": "cnt"},
                             {"type": "longSum", "name": "s",
                              "fieldName": "metLong"},
                             {"type": "floatMax", "name": "fm",
                              "fieldName": "metFloat"}], **kw}


QUERIES = {
    "union_timeseries": {
        "queryType": "timeseries",
        "dataSource": {"type": "union", "dataSources": ["test", "other"]},
        "intervals": [WEEK], "granularity": "all",
        "aggregations": [{"type": "count", "name": "n"}]},
    "union_groupby": {
        "queryType": "groupBy",
        "dataSource": {"type": "union", "dataSources": ["other", "test"]},
        "intervals": [WEEK], "granularity": "day", "dimensions": ["dimA"],
        "aggregations": AGGS},
    "subquery_groupby": {
        "queryType": "groupBy",
        "dataSource": {"type": "query", "query": _inner()},
        "intervals": [WEEK], "granularity": "all", "dimensions": ["dimA"],
        "aggregations": [{"type": "count", "name": "pairs"},
                         {"type": "longSum", "name": "rows",
                          "fieldName": "cnt"},
                         {"type": "doubleMax", "name": "fmax",
                          "fieldName": "fm"}]},
    "subquery_timeseries": {
        "queryType": "timeseries",
        "dataSource": {"type": "query", "query": _inner(
            dimensions=["dimA"])},
        "intervals": [WEEK], "granularity": "all",
        "aggregations": [{"type": "count", "name": "groups"},
                         {"type": "longSum", "name": "total",
                          "fieldName": "s"}]},
    "subquery_numeric_dimension": {
        "queryType": "groupBy",
        "dataSource": {"type": "query", "query": _inner(
            dimensions=["metLong"], granularity="day")},
        "intervals": [WEEK], "granularity": "all", "dimensions": [],
        "aggregations": [{"type": "longSum", "name": "keys",
                          "fieldName": "metLong"},
                         {"type": "longSum", "name": "rows",
                          "fieldName": "cnt"}]},
    "subquery_scan": {
        "queryType": "scan",
        "dataSource": {"type": "query", "query": _inner(
            dimensions=["dimB"])},
        "intervals": [WEEK], "columns": ["dimB", "cnt", "s"], "limit": 40},
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_datasource_matches_reference(segs, name):
    want, got = run_both(segs, QUERIES[name])
    assert want
    same(want, got)


def test_union_counts_both_tables(segs):
    _, port = segs
    rows = PortExecutor(port, device="cpu").run_json(
        QUERIES["union_timeseries"])
    assert rows[0]["result"]["n"] == sum(s.n_rows for s in port)


def test_subquery_serde_round_trip():
    j = {"queryType": "timeseries",
         "dataSource": {"type": "query", "query": _inner()},
         "intervals": [WEEK], "granularity": "all",
         "aggregations": [{"type": "longSum", "name": "s",
                           "fieldName": "cnt"}]}
    q = port_query_json(j)
    assert q.inner_query is not None
    j2 = q.to_json()
    assert j2["dataSource"]["type"] == "query"
    assert port_query_json(j2).to_json() == j2
    assert port_query_json(j2) == q
    assert j2 == ref_query_json(j).to_json()
    u = port_query_json(QUERIES["union_groupby"])
    assert u.union_datasources == ("other", "test")
    assert port_query_json(u.to_json()) == u


def test_subquery_requires_groupby(segs):
    _, port = segs
    j = {"queryType": "timeseries",
         "dataSource": {"type": "query", "query": {
             "queryType": "timeseries", "dataSource": "test",
             "intervals": [WEEK], "aggregations": AGGS}},
         "intervals": [WEEK], "granularity": "all",
         "aggregations": [{"type": "count", "name": "n"}]}
    with pytest.raises(ValueError):
        PortExecutor(port, device="cpu").run_json(j)


def test_subquery_segment_matches_reference(segs):
    """The materialized segment: same rows, dictionaries and metric types."""
    ref, port = segs
    inner = _inner(dimensions=["dimA", "metLong"])
    r_seg = ref_subquery(ref_query_json(inner),
                         RefExecutor(ref).run_json(inner))
    p_seg = port_subquery(port_query_json(inner),
                          PortExecutor(port, device="cpu").run_json(inner))
    assert p_seg.time_ms.tolist() == r_seg.time_ms.tolist()
    assert {n: (c.dictionary.values, c.ids.tolist())
            for n, c in p_seg.dims.items()} == \
        {n: (c.dictionary.values, c.ids.tolist())
         for n, c in r_seg.dims.items()}
    assert {n: (m.type.value, m.values.tolist())
            for n, m in p_seg.metrics.items()} == \
        {n: (m.type.value, m.values.tolist())
         for n, m in r_seg.metrics.items()}
    assert str(p_seg.id) == str(r_seg.id)


# ---- tests/test_chunking.py ------------------------------------------------

def test_parse_period_ms():
    for p in ("P1D", "PT6H", "P1W", "PT30M", "P1DT12H", 5000, "P1M",
              "P1Y", "PT45S"):
        assert parse_period_ms(p) == ref_period(p)
    assert parse_period_ms("P1DT12H") == 129_600_000
    for bad in ("1 day", "P", True):
        with pytest.raises((ValueError, TypeError)):
            parse_period_ms(bad)


@pytest.mark.parametrize("iv,period", [
    (("2026-01-01T06:00:00", "2026-01-03T18:00:00"), 86_400_000),
    (("2026-01-01", "2026-01-01T02:00:00"), 86_400_000),
    (("2026-01-01T01:00:00", "2026-01-02T03:30:00"), 6 * 3_600_000),
    (("1970-01-01", "2100-01-01"), 3_600_000),
])
def test_split_by_period_matches_reference(iv, period):
    got = split_by_period(PortInterval.of(*iv), period)
    want = ref_split(Interval.of(*iv), period)
    assert [(c.start, c.end) for c in got] == \
        [(c.start, c.end) for c in want]
    assert got[0].start == PortInterval.of(*iv).start
    assert got[-1].end == PortInterval.of(*iv).end


def _chunked(q):
    return {**q, "context": {"chunkPeriod": "P1D"}}


CHUNK_QUERIES = {
    "timeseries_all": {"queryType": "timeseries", "granularity": "all",
                       "aggregations": AGGS},
    "timeseries_day": {"queryType": "timeseries", "granularity": "day",
                       "aggregations": AGGS},
    "timeseries_hour": {"queryType": "timeseries", "granularity": "hour",
                        "aggregations": AGGS},
    "groupby_day": {"queryType": "groupBy", "granularity": "day",
                    "dimensions": ["dimA"], "aggregations": AGGS},
    "topn": {"queryType": "topN", "granularity": "all", "dimension": "dimB",
             "metric": "ls", "threshold": 5, "aggregations": AGGS},
    "scan": {"queryType": "scan", "columns": ["__time", "dimA"],
             "limit": 30, "offset": 4000},
}


@pytest.mark.parametrize("name", sorted(CHUNK_QUERIES))
def test_chunked_equals_unchunked(segs, name):
    q = {"dataSource": "test", "intervals": [WEEK], **CHUNK_QUERIES[name]}
    ex = PortExecutor(segs[1], device="cpu")
    plain = ex.run_json(q)
    assert plain and ex.run_json(_chunked(q)) == plain
    want, got = run_both(segs, _chunked(q))
    same(want, got)


def test_chunking_splits_the_intervals():
    q = port_query_json(_chunked({"queryType": "timeseries",
                                  "dataSource": "test",
                                  "intervals": [WEEK],
                                  "aggregations": AGGS}))
    assert len(apply_interval_chunking(q).intervals) == 7
    plain = port_query_json({"queryType": "timeseries", "dataSource": "test",
                             "intervals": [WEEK], "aggregations": AGGS})
    assert apply_interval_chunking(plain) is plain


def test_union_reads_the_same_arrays_under_two_names(segs):
    """A second datasource over two segments' arrays (segment_from_arrays,
    no copy) adds their rows to a union's counts."""
    _, port = segs
    relabeled = [segment_from_arrays(
        s.time_ms,
        {n: (c.ids, c.dictionary.values) for n, c in s.dims.items()},
        {n: (m.type.value, m.values) for n, m in s.metrics.items()},
        "test_b", (s.interval.start, s.interval.end)) for s in port[:2]]
    assert relabeled[0].dims["dimA"].ids is port[0].dims["dimA"].ids
    ex = PortExecutor(port + relabeled, device="cpu")
    q = {"queryType": "timeseries", "dataSource": "test",
         "intervals": [WEEK], "aggregations": AGGS}
    one = ex.run_json(q)[0]["result"]
    two = ex.run_json({**q, "dataSource": {
        "type": "union", "dataSources": ["test", "test_b"]}})[0]["result"]
    assert two["rows"] == one["rows"] + sum(s.n_rows for s in port[:2])
    assert two["ls"] == one["ls"] + sum(
        int(s.metrics["metLong"].values.sum()) for s in port[:2])
