"""The port's non-aggregate engines and query surface against the reference.

Scan, select, search, timeBoundary, segmentMetadata and dataSourceMetadata,
the cases of the reference's tests/test_other_queries.py and the executor
cases of tests/test_streaming_scan.py, over 3 segments of 3,000 rows made by
the reference's DataGenerator (seed 42) and carried into the port as plain
arrays (`segment_from_arrays`). Each query runs through both
`QueryExecutor`s, the port's with device="cpu"; the rows must be equal
(scan, select, search, timeBoundary and metadata rows exactly, counts, long
sums and min/max bit for bit). The broker and HTTP cases of those files
wait for the port's serving layer.
"""
import json

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.data.segment import SegmentBuilder as RefBuilder
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.query import agg_from_json as ref_agg_json
from druid_tpu.query import filter_from_json as ref_filter_json
from druid_tpu.query.model import query_from_json as ref_query_json
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.data.segment import SegmentBuilder as PortBuilder
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import engines as port_engines
from druid_tpu_torch.query.aggregators import agg_from_json as port_agg_json
from druid_tpu_torch.query.filters import filter_from_json as port_filter_json
from druid_tpu_torch.query.model import query_from_json as port_query_json
from druid_tpu_torch.utils.intervals import Interval as PortInterval
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

SCHEMA = (
    ColumnSpec("dimA", "string", cardinality=10, distribution="uniform"),
    ColumnSpec("dimB", "string", cardinality=100, distribution="zipf"),
    ColumnSpec("metLong", "long", low=0, high=100),
    ColumnSpec("metFloat", "float", distribution="normal", mean=10.0,
               std=3.0),
    ColumnSpec("metDouble", "double", low=0.0, high=1.0),
)
SPAN = "2026-01-01/2026-01-04"
DAY = "2026-01-01/2026-01-02"


def make_segments(n=3, rows=3_000, seed=42, datasource="test"):
    """(reference segments, the same arrays as port segments)."""
    ref = DataGenerator(SCHEMA, seed=seed).segments(
        n, rows, Interval.parse(SPAN), datasource=datasource)
    return ref, [_carry(s) for s in ref]


@pytest.fixture(scope="module")
def segs():
    return make_segments()


def same(want, got):
    """Equal rows, types included (json keeps 1 and 1.0 apart)."""
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def run_both(segs, q):
    ref, port = segs
    want = RefExecutor(ref).run_json(q)
    got = PortExecutor(port, device="cpu").run_json(q)
    return want, got


def _q(query_type, **kw):
    return {"queryType": query_type, "dataSource": "test",
            "intervals": [SPAN], **kw}


AGGS = [{"type": "count", "name": "rows"},
        {"type": "longSum", "name": "sumLong", "fieldName": "metLong"}]

#: the reference's test_other_queries.py cases, as JSON through both
QUERIES = {
    "scan_basic": _q("scan", columns=["__time", "dimA", "metLong"],
                     limit=100),
    "scan_all_columns": _q("scan", limit=25, order="descending"),
    "scan_filtered_and_offset": _q(
        "scan", columns=["dimA"], limit=10, offset=5,
        filter={"type": "selector", "dimension": "dimA",
                "value": "v00000004"}),
    "scan_offset_past_a_segment": _q("scan", columns=["metLong"],
                                     offset=3_100, limit=7),
    "scan_filter_on_virtual_column": _q(
        "scan", columns=["metLong"], limit=50,
        virtualColumns=[{"type": "expression", "name": "doubled",
                         "expression": "metLong * 2", "outputType": "long"}],
        filter={"type": "bound", "dimension": "doubled", "lower": "100",
                "ordering": "numeric"}),
    "select_paging": _q("select", dimensions=["dimA"], metrics=["metLong"],
                        pagingSpec={"threshold": 50}),
    "select_descending": _q("select", descending=True,
                            pagingSpec={"threshold": 40},
                            filter={"type": "in", "dimension": "dimB",
                                    "values": ["v00000001", "v00000002"]}),
    "search": _q("search", searchDimensions=["dimA", "dimB"],
                 query={"type": "contains", "value": "0003"}),
    "search_all_dims_strlen": _q("search", query={"type": "contains",
                                                  "value": "1"},
                                 sort={"type": "strlen"}, limit=7),
    "search_filtered": _q("search", query={"type": "contains",
                                           "value": "V0000000",
                                           "caseSensitive": False},
                          filter={"type": "bound", "dimension": "metLong",
                                  "upper": "20", "ordering": "numeric"}),
    "time_boundary": {"queryType": "timeBoundary", "dataSource": "test"},
    "time_boundary_max": {"queryType": "timeBoundary", "dataSource": "test",
                          "bound": "maxTime"},
    "time_boundary_filtered": _q(
        "timeBoundary", bound="minTime",
        filter={"type": "selector", "dimension": "dimB",
                "value": "v00000050"}),
    "time_boundary_two_intervals": {
        "queryType": "timeBoundary", "dataSource": "test",
        "intervals": ["2026-01-01T05:00:00/2026-01-01T06:00:00",
                      "2026-01-02T10:00:00/2026-01-02T11:00:00"]},
    "segment_metadata": {"queryType": "segmentMetadata",
                         "dataSource": "test"},
    "segment_metadata_merge": {"queryType": "segmentMetadata",
                               "dataSource": "test", "merge": True},
    "segment_metadata_some": {"queryType": "segmentMetadata",
                              "dataSource": "test", "merge": True,
                              "toInclude": {"type": "list",
                                            "columns": ["dimA", "metFloat"]},
                              "analysisTypes": ["cardinality", "minmax"]},
    "datasource_metadata": {"queryType": "dataSourceMetadata",
                            "dataSource": "test"},
    "cardinality_agg": _q("timeseries", intervals=[DAY], aggregations=[
        {"type": "cardinality", "name": "cardB", "fields": ["dimB"]},
        {"type": "cardinality", "name": "cardA", "fields": ["dimA"]}]),
    "cardinality_multi_segment_fold": _q("timeseries", aggregations=[
        {"type": "cardinality", "name": "card", "fields": ["dimB"]}]),
    "cardinality_by_row": _q("timeseries", intervals=[DAY], aggregations=[
        {"type": "cardinality", "name": "c", "fields": ["dimA", "dimB"],
         "byRow": True}]),
    "filtered_aggregator": _q("timeseries", intervals=[DAY], aggregations=[
        {"type": "count", "name": "rows"},
        {"type": "filtered", "name": "f",
         "aggregator": {"type": "longSum", "name": "f",
                        "fieldName": "metLong"},
         "filter": {"type": "selector", "dimension": "dimA",
                    "value": "v00000001"}}]),
    "topn_inverted_metric": _q("topN", intervals=[DAY], dimension="dimA",
                               threshold=3, aggregations=AGGS[:1],
                               metric={"type": "inverted",
                                       "metric": "rows"}),
    "topn_dimension_metric": _q("topN", intervals=[DAY], dimension="dimA",
                                threshold=3, aggregations=AGGS[:1],
                                metric={"type": "dimension"}),
    "time_bound_filter_outside_segment": _q(
        "timeseries", intervals=[DAY], aggregations=AGGS[:1],
        filter={"type": "bound", "dimension": "__time", "lower": "0",
                "ordering": "numeric"}),
    "all_granularity_disjoint_intervals": {
        "queryType": "timeseries", "dataSource": "test",
        "intervals": ["2026-01-01T00:00:00Z/2026-01-01T02:00:00Z",
                      "2026-01-01T10:00:00Z/2026-01-01T12:00:00Z"],
        "aggregations": AGGS[:1]},
    "timeseries_skip_empty_buckets": _q(
        "timeseries", intervals=[DAY], granularity="minute",
        aggregations=[{"type": "count", "name": "n"}],
        context={"skipEmptyBuckets": True}),
    "by_segment_results": _q("timeseries", aggregations=AGGS,
                             context={"bySegment": True}),
    "by_segment_topn": _q("topN", dimension="dimB", metric="sumLong",
                          threshold=4, aggregations=AGGS,
                          context={"bySegment": True}),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_reference(segs, name):
    want, got = run_both(segs, QUERIES[name])
    assert want
    same(want, got)


def test_query_json_roundtrip(segs):
    """A query's to_json runs to the same rows, in both packages."""
    q = _q("groupBy", dimensions=["dimA"], aggregations=AGGS,
           granularity="hour",
           filter={"type": "selector", "dimension": "dimB",
                   "value": "v00000001"})
    ref, port = segs
    pq = port_query_json(q)
    assert pq.to_json() == ref_query_json(q).to_json()
    ex = PortExecutor(port, device="cpu")
    assert ex.run(port_query_json(pq.to_json())) == ex.run(pq)
    same(RefExecutor(ref).run_json(q), ex.run(pq))


def test_filter_json_roundtrip():
    j = {"type": "and", "fields": [
        {"type": "selector", "dimension": "d", "value": "x"},
        {"type": "or", "fields": [
            {"type": "bound", "dimension": "m", "lower": "1", "upper": "2",
             "lowerStrict": True, "upperStrict": False,
             "ordering": "numeric"},
            {"type": "not", "field": {"type": "in", "dimension": "d",
                                      "values": ["a", "b"]}},
        ]},
        {"type": "like", "dimension": "d", "pattern": "foo%"},
        {"type": "regex", "dimension": "d", "pattern": "^x"},
    ]}
    f = port_filter_json(j)
    assert port_filter_json(f.to_json()) == f
    assert f.to_json() == ref_filter_json(j).to_json()


def test_agg_json_roundtrip():
    specs = [
        {"type": "count", "name": "n"},
        {"type": "longSum", "name": "a", "fieldName": "m"},
        {"type": "doubleMax", "name": "b", "fieldName": "m"},
        {"type": "doubleFirst", "name": "c", "fieldName": "m"},
        {"type": "hyperUnique", "name": "d", "fieldName": "m"},
        {"type": "cardinality", "name": "e", "fields": ["x", "y"],
         "byRow": True},
        {"type": "filtered", "name": "f",
         "aggregator": {"type": "count", "name": "f"},
         "filter": {"type": "selector", "dimension": "d", "value": "v"}},
    ]
    for j in specs:
        a = port_agg_json(j)
        assert port_agg_json(a.to_json()) == a
        assert a.to_json() == ref_agg_json(j).to_json()


def test_builder_type_widening():
    """A LONG metric widens to DOUBLE when a float arrives later, and the
    rows come out sorted by time, as in the reference's builder."""
    out = []
    for builder, iv in ((RefBuilder, Interval), (PortBuilder, PortInterval)):
        day = iv.of("2026-01-01", "2026-01-02")
        b = builder("w", day)
        b.add_row(day.start + 5, {"d": "b"}, {"m": 0})
        b.add_row(day.start + 1, {"d": None, "e": "x"}, {"m": 2.5, "k": 3})
        b.add_row(day.start + 3, {"d": "a"}, {"k": 4})
        seg = b.build()
        out.append((seg.time_ms.tolist(),
                    {n: (c.dictionary.values, c.ids.tolist())
                     for n, c in seg.dims.items()},
                    {n: (m.type.value, m.values.tolist())
                     for n, m in seg.metrics.items()},
                    seg.size_bytes()))
    assert out[0] == out[1]
    assert out[1][2]["m"] == ("double", [2.5, 0.0, 0.0])


def test_column_capabilities(segs):
    ref, port = segs
    for name in ("__time", "dimA", "metLong", "metFloat", "nosuch"):
        r = ref[0].column_capabilities(name)
        p = port[0].column_capabilities(name)
        assert (None if r is None else (r.type.value, r.dictionary_encoded,
                                        r.has_bitmap_index,
                                        r.has_multiple_values)) \
            == (None if p is None else (p.type.value, p.dictionary_encoded,
                                        p.has_bitmap_index,
                                        p.has_multiple_values))


# ---- tests/test_streaming_scan.py, the executor's cases --------------------

WEEK = "2026-01-01/2026-01-08"


def test_iter_scan_is_lazy(segs, monkeypatch):
    """Pulling the first batch masks and decodes one segment only."""
    _, port = segs
    decoded, masked = [], []
    real_decode, real_ids = port_engines._decode_rows, \
        port_engines._masked_row_ids

    def spy_decode(seg, row_ids, columns):
        decoded.append(str(seg.id))
        return real_decode(seg, row_ids, columns)

    def spy_ids(seg, query, device):
        masked.append(str(seg.id))
        return real_ids(seg, query, device)

    monkeypatch.setattr(port_engines, "_decode_rows", spy_decode)
    monkeypatch.setattr(port_engines, "_masked_row_ids", spy_ids)
    q = port_query_json({"queryType": "scan", "dataSource": "test",
                         "intervals": [WEEK], "order": "ascending",
                         "columns": ["dimA", "metLong"]})
    gen = PortExecutor(port, device="cpu").run_streaming(q)
    next(gen)
    assert len(set(decoded)) == 1 and len(set(masked)) == 1


def test_batch_size_bounds_events(segs):
    _, port = segs
    ex = PortExecutor(port, device="cpu")
    q = {"queryType": "scan", "dataSource": "test", "intervals": [WEEK],
         "columns": ["dimA"]}
    batches = list(ex.run_streaming(port_query_json({**q, "batchSize": 100})))
    assert all(len(b["events"]) <= 100 for b in batches)
    assert sum(len(b["events"]) for b in batches) == sum(
        len(b["events"]) for b in ex.run_json(q)) == 9_000


@pytest.mark.parametrize("order", ["ascending", "descending", "none"])
def test_streaming_matches_materialized(segs, order):
    ref, port = segs
    q = {"queryType": "scan", "dataSource": "test", "intervals": [WEEK],
         "columns": ["dimA", "metLong"], "order": order, "limit": 500,
         "offset": 37, "batchSize": 64,
         "filter": {"type": "bound", "dimension": "metLong", "lower": "20",
                    "ordering": "numeric"}}
    ex = PortExecutor(port, device="cpu")
    streamed = list(ex.run_streaming(port_query_json(q)))
    assert streamed == ex.run_json(q)
    same(list(RefExecutor(ref).run_streaming(ref_query_json(q))), streamed)


def test_streaming_aggregate_yields_rows(segs):
    _, port = segs
    ex = PortExecutor(port, device="cpu")
    q = port_query_json(QUERIES["by_segment_results"])
    assert list(ex.run_streaming(q)) == ex.run(q)


def test_scan_batchsize_wire_roundtrip():
    j = {"queryType": "scan", "dataSource": "x", "intervals": [WEEK],
         "batchSize": 777}
    q = port_query_json(j)
    assert q.batch_size == 777
    assert port_query_json(q.to_json()).batch_size == 777
    assert q.to_json() == ref_query_json(j).to_json()


# ---- the executor's segment management ------------------------------------

def test_drop_segment_and_datasources(segs):
    _, port = segs
    ex = PortExecutor(port, device="cpu")
    assert ex.datasources == ["test"]
    assert ex.segments_of("test") == port
    assert ex.drop_segment(str(port[1].id))
    assert not ex.drop_segment(str(port[1].id))
    assert ex.segments_of("test") == [port[0], port[2]]
    rows = ex.run_json({"queryType": "timeseries", "dataSource": "test",
                        "intervals": [SPAN],
                        "aggregations": [{"type": "count", "name": "n"}]})
    assert rows[0]["result"]["n"] == port[0].n_rows + port[2].n_rows


def test_unknown_query_type_raises_value_error(segs):
    _, port = segs
    for j in ({"queryType": "nosuch", "dataSource": "test"},
              {"queryType": "scan", "dataSource": {"type": "nosuch"}}):
        for parse in (ref_query_json, port_query_json):
            with pytest.raises(ValueError):
                parse(j)


def test_scan_masks_on_the_query_device(segs, monkeypatch):
    """The scan's row mask is built as a tensor on the executor's device,
    and only the ids of the surviving rows reach the host."""
    _, port = segs
    seen = []
    real = port_engines.masked_columns

    def spy(*a, **k):
        mask, cols = real(*a, **k)
        seen.append((mask.device.type, mask.dtype, int(mask.sum())))
        return mask, cols
    monkeypatch.setattr(port_engines, "masked_columns", spy)
    rows = PortExecutor(port, device="cpu").run_json(
        QUERIES["scan_filtered_and_offset"])
    assert [e["dimA"] for b in rows for e in b["events"]] \
        == ["v00000004"] * 10
    assert seen and all(d == "cpu" and t == torch.bool for d, t, _ in seen)
    n = sum(int((s.dims["dimA"].ids == s.dims["dimA"].dictionary.id_of(
        "v00000004")).sum()) for s in port[:len(seen)])
    assert sum(c for _, _, c in seen) == n
    assert np.all(np.asarray([c for _, _, c in seen]) >= 0)
