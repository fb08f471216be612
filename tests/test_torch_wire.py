"""Wire serialization in the port: every query, dimension spec, limit spec,
having spec, virtual column, filter, aggregator and post-aggregator; and
the partials wire (druid_tpu_torch/cluster/wire.py, the "DTPW" tensor
bundle a data node answers the broker with).

Each query JSON below parses in both packages; the port's `to_json` must
equal the reference's, and parsing the port's `to_json` must give back an
equal object (`query_from_json(q.to_json()) == q`).

The partials wire is the contract between a broker and its data nodes, so
it must stay byte-compatible with the reference's both ways: each core and
extension aggregator's partials (a groupBy on dimA by day over two
segments of tests/conftest.py's schema) round-trip through the port's
dumps/loads, plain and compressed, to the same rows; the reference's bytes
load in the port and finish to the reference's rows; the port's bytes load
in the reference and finish to the port's rows; and for the count, longSum,
longMin and longMax partials (and every other whose states are computed
alike) the two packages write the same bytes. One difference is on
purpose, named in BLOOM_REF_LOAD and ROADMAP §C: the reference cannot
rebuild a bloom aggregator's kernel on the merge side, so it loads no bloom
payload, its own included; the port can.
"""
import json
import math

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import druid_tpu.ext  # noqa: F401  (the reference's extension aggregators)
from druid_tpu.cluster import wire as ref_wire
from druid_tpu.cluster.view import DataNode as RefNode
from druid_tpu.data.generator import DataGenerator
from druid_tpu.data.segment import SegmentBuilder
from druid_tpu.engine import engines as ref_engines
from druid_tpu.query.model import query_from_json as ref_query_json
from druid_tpu.utils.intervals import Interval as RefInterval

import druid_tpu_torch.ext  # noqa: F401  (the port's extension aggregators)
from druid_tpu_torch.cluster import wire
from druid_tpu_torch.cluster.view import DataNode
from druid_tpu_torch.engine import engines
from druid_tpu_torch.query.model import query_from_json as port_query_json
from tests.conftest import TEST_SCHEMA
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

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


# ---------------------------------------------------------------------------
# The partials wire
# ---------------------------------------------------------------------------

PIV = "2026-01-01/2026-01-03"
WIRE_AGGS = {a["type"] if "name" not in a else a["name"]: a for a in (
    [{"type": "count", "name": "count"}]
    + [{"type": t, "name": t, "fieldName": f} for t, f in (
        ("longSum", "metLong"), ("doubleSum", "metDouble"),
        ("floatSum", "metFloat"), ("longMin", "metLong"),
        ("longMax", "metLong"), ("doubleMin", "metDouble"),
        ("doubleMax", "metDouble"), ("floatMin", "metFloat"),
        ("floatMax", "metFloat"), ("longFirst", "metLong"),
        ("longLast", "metLong"), ("doubleFirst", "metDouble"),
        ("doubleLast", "metDouble"), ("floatFirst", "metFloat"),
        ("floatLast", "metFloat"), ("hyperUnique", "dimHi"),
        ("variance", "metFloat"), ("thetaSketch", "dimHi"),
        ("quantilesDoublesSketch", "metFloat"), ("distinctCount", "dimHi"),
        ("bloom", "dimB"), ("HLLSketchBuild", "dimHi"),
        ("HLLSketchMerge", "dimHi"), ("timeMin", "__time"),
        ("timeMax", "__time"))]
    + [{"type": "cardinality", "name": "cardinality",
        "fields": ["dimA", "dimB"], "byRow": True},
       {"type": "approxHistogram", "name": "approxHistogram",
        "fieldName": "metFloat", "lowerLimit": 0, "upperLimit": 20,
        "numBuckets": 16},
       {"type": "filtered", "name": "filtered",
        "filter": {"type": "selector", "dimension": "dimB",
                   "value": "v00000001"},
        "aggregator": {"type": "longSum", "name": "filtered",
                       "fieldName": "metLong"}}])}
#: the aggregators whose partials the two packages compute alike: the
#: same bytes on the wire, plain and compressed (the float sums and the
#: variance sum in another order, so their last bits differ)
BYTE_IDENTICAL = sorted(set(WIRE_AGGS) - {"floatSum", "variance"})
#: the reference rebuilds a bloom kernel from its segment's dictionary and
#: so cannot load a bloom payload on the merge side; the port can
BLOOM_REF_LOAD = {"bloom"}


def _wire_query(agg):
    return {"queryType": "groupBy", "dataSource": "test", "intervals": [PIV],
            "granularity": "day", "dimensions": ["dimA"],
            "aggregations": [agg]}


@pytest.fixture(scope="module")
def wire_nodes():
    ref = DataGenerator(TEST_SCHEMA, seed=42).segments(
        2, 3_000, RefInterval.of("2026-01-01", "2026-01-03"),
        datasource="test")
    rn, pn = RefNode("w"), DataNode("w", device="cpu")
    for s in ref:
        rn.load_segment(s)
        pn.load_segment(_carry(s))
    return rn, pn, [str(s.id) for s in ref]


def _value(v):
    """A finished value as plain data: sketch and filter objects by their
    state (the same attribute names in both packages)."""
    for attr in ("counts", "bits", "mins", "registers"):
        if hasattr(v, attr):
            return _value(getattr(v, attr))
    if hasattr(v, "estimate"):
        return _value(v.estimate)
    if isinstance(v, (np.ndarray, np.generic)):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_value(x) for x in v]
    if isinstance(v, float) and math.isnan(v):
        return "nan"
    return v


def _finish(eng, q, ap):
    return _value(eng.finish_groupby(q, ap))


@pytest.mark.parametrize("name", sorted(WIRE_AGGS))
def test_partials_round_trip_every_aggregator(wire_nodes, name):
    """The port's payload, plain and compressed, loads back to partials
    that finish to the rows of the partials it was made from."""
    _, pn, sids = wire_nodes
    q = port_query_json(_wire_query(WIRE_AGGS[name]))
    ap, served = pn.run_partials(q, sids)
    want = _finish(engines, q, ap)
    for compress in (False, True):
        got, got_served, spans = wire.loads_partials(
            wire.dumps_partials(ap, served, compress=compress))
        assert got_served == served and spans == []
        assert _finish(engines, q, got) == want


@pytest.mark.parametrize("name", sorted(WIRE_AGGS))
def test_partials_cross_package(wire_nodes, name):
    """The reference's bytes load in the port and finish to the
    reference's rows; the port's bytes load in the reference and finish to
    the port's rows (not for BLOOM_REF_LOAD)."""
    rn, pn, sids = wire_nodes
    j = _wire_query(WIRE_AGGS[name])
    rq, pq = ref_query_json(j), port_query_json(j)
    rap, rserved = rn.run_partials(rq, sids)
    pap, pserved = pn.run_partials(pq, sids)
    for compress in (False, True):
        ref_bytes = ref_wire.dumps_partials(rap, rserved, compress=compress)
        assert _finish(engines, pq, wire.loads_partials(ref_bytes)[0]) \
            == _finish(ref_engines, rq, rap)
        port_bytes = wire.dumps_partials(pap, pserved, compress=compress)
        if name in BLOOM_REF_LOAD:
            with pytest.raises(ValueError, match="string dimension"):
                ref_wire.loads_partials(port_bytes)
            continue
        assert _finish(ref_engines, rq,
                       ref_wire.loads_partials(port_bytes)[0]) \
            == _finish(engines, pq, pap)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "rle"])
@pytest.mark.parametrize("name", BYTE_IDENTICAL)
def test_partials_bytes_identical_to_reference(wire_nodes, name, compress):
    rn, pn, sids = wire_nodes
    j = _wire_query(WIRE_AGGS[name])
    rap, rserved = rn.run_partials(ref_query_json(j), sids)
    pap, pserved = pn.run_partials(port_query_json(j), sids)
    assert wire.dumps_partials(pap, pserved, compress=compress) \
        == ref_wire.dumps_partials(rap, rserved, compress=compress)


def test_partials_bytes_identical_count_sum_min_max(wire_nodes):
    """The broker's headline aggregators together, by hour (many empty
    buckets: the compressed form takes its rle and narrow encodings)."""
    rn, pn, sids = wire_nodes
    j = dict(_wire_query(None), granularity="hour", aggregations=[
        {"type": "count", "name": "n"},
        {"type": "longSum", "name": "s", "fieldName": "metLong"},
        {"type": "longMin", "name": "mi", "fieldName": "metLong"},
        {"type": "longMax", "name": "ma", "fieldName": "metLong"}])
    rap, rserved = rn.run_partials(ref_query_json(j), sids)
    pap, pserved = pn.run_partials(port_query_json(j), sids)
    for compress in (False, True):
        got = wire.dumps_partials(pap, pserved, missing=["x"],
                                  compress=compress)
        assert got == ref_wire.dumps_partials(rap, rserved, missing=["x"],
                                              compress=compress)
        assert got[4] == (wire.VERSION_COMPRESSED if compress
                          else wire.VERSION)


def test_wire_roundtrip_groupby_with_trace(wire_nodes):
    """tests/test_dataplane.py's round trip: served ids and the node's
    trace spans ride along, and the rows are unchanged."""
    _, pn, sids = wire_nodes
    q = port_query_json(dict(_wire_query(None), aggregations=[
        WIRE_AGGS[k] for k in ("count", "longSum", "doubleMax",
                               "cardinality", "filtered")]))
    ap, served = pn.run_partials(q, sids)
    span = {"traceId": "t", "spanId": "s", "name": "datanode/query"}
    ap2, served2, trace = wire.loads_partials(
        wire.dumps_partials(ap, served, trace=[span]))
    assert served2 == set(sids) and trace == [span]
    assert engines.finish_groupby(q, ap2) == engines.finish_groupby(q, ap)


def test_wire_rejects_garbage(wire_nodes):
    """Bad magic, an unknown version and every truncation raise WireError,
    never another exception or a silently short partial."""
    _, pn, sids = wire_nodes
    q = port_query_json(_wire_query(WIRE_AGGS["longSum"]))
    good = wire.dumps_partials(*pn.run_partials(q, sids))
    with pytest.raises(wire.WireError, match="magic"):
        wire.loads_partials(b"NOPE" + b"\x00" * 16)
    with pytest.raises(wire.WireError, match="version"):
        wire.loads_partials(good[:4] + bytes([9]) + good[5:])
    for cut in (5, 9, 40, len(good) // 2, len(good) - 1):
        with pytest.raises(wire.WireError):
            wire.loads_partials(good[:cut])


def _rollup_segment(rows=8192):
    """tests/test_format_v2.py's RLE-friendly rollup shape:
    dimension-sorted rows, a constant count, a run-aligned value metric."""
    iv = RefInterval.of("2026-01-01", "2026-01-02")
    card, reps = 16, -(-rows // 16)
    b = SegmentBuilder("roll", iv, version="v0", partition=0)
    b.add_columns(
        iv.start + (np.arange(rows, dtype=np.int64) // 64),
        {"dimA": np.repeat([f"a{i:02d}" for i in range(card)],
                           reps)[:rows].tolist()},
        {"cnt": np.ones(rows, dtype=np.int64),
         "val": np.repeat((np.arange(card) * 37) % 1000, reps)[:rows]
                .astype(np.int64)})
    return _carry(b.build())


def test_wire_compressed_partials_parity_and_ratio():
    """tests/test_format_v2.py:370 — compressed partials merge bit for bit
    and the wire bytes drop at least 4x on the rollup shape."""
    seg = _rollup_segment()
    q = port_query_json({
        "queryType": "groupBy", "dataSource": "roll",
        "intervals": ["2026-01-01/2026-01-02"], "granularity": "hour",
        "dimensions": ["dimA"],
        "aggregations": [{"type": "count", "name": "rows"},
                         {"type": "longSum", "name": "c",
                          "fieldName": "cnt"}]})
    ap = engines.make_aggregate_partials(q, [seg], torch.device("cpu"),
                                         clamp=False)
    raw = wire.dumps_partials(ap, served=[str(seg.id)], compress=False)
    comp = wire.dumps_partials(ap, served=[str(seg.id)], compress=True)
    assert len(raw) / len(comp) >= 4.0, (len(raw), len(comp))
    ap_raw, served_raw, _ = wire.loads_partials(raw)
    ap_comp, served_comp, _ = wire.loads_partials(comp)
    assert served_raw == served_comp == {str(seg.id)}
    assert engines.finish_groupby(q, ap_comp) \
        == engines.finish_groupby(q, ap_raw) \
        == engines.finish_groupby(q, ap)


def test_wire_uncompressed_payload_is_version_1():
    """tests/test_format_v2.py:397 — compress=False stays wire VERSION 1,
    so a broker that reads only version 1 keeps reading new nodes."""
    seg = _rollup_segment(1024)
    q = port_query_json({
        "queryType": "timeseries", "dataSource": "roll",
        "intervals": ["2026-01-01/2026-01-02"], "granularity": "all",
        "aggregations": [{"type": "count", "name": "n"}]})
    ap = engines.make_aggregate_partials(q, [seg], torch.device("cpu"))
    raw = wire.dumps_partials(ap, compress=False)
    assert raw[:4] == wire.MAGIC and raw[4] == wire.VERSION


def test_wire_round_trips_missing_report(wire_nodes):
    """tests/test_resilience.py:186 — the explicit partial-result report
    rides the wire, sorted; a payload without one loads with an empty
    report; the 3-tuple unpack is kept."""
    _, pn, sids = wire_nodes
    q = port_query_json({"queryType": "timeseries", "dataSource": "test",
                         "intervals": [PIV], "aggregations": [
                             WIRE_AGGS["count"]]})
    ap, _ = pn.run_partials(q, sids[:1])
    payload = wire.loads_partials(wire.dumps_partials(
        ap, served=sids[:1], missing=["lost-b", "lost-a"]))
    got_ap, served, spans = payload
    assert served == set(sids[:1]) and spans == []
    assert payload.missing == ["lost-a", "lost-b"]
    assert wire.loads_partials(
        wire.dumps_partials(ap, served=sids[:1])).missing == []


def test_wire_stats_monitor_emits_deltas(wire_nodes):
    """WireStats counts logical and emitted bytes; WireStatsMonitor emits
    query/wire/{bytes,compressedBytes} as deltas over its tick."""
    from druid_tpu_torch.utils.emitter import InMemoryEmitter, ServiceEmitter
    _, pn, sids = wire_nodes
    q = port_query_json(dict(_wire_query(WIRE_AGGS["count"]),
                             granularity="hour"))
    ap, served = pn.run_partials(q, sids)
    stats = wire.WireStats()
    mon = wire.WireStatsMonitor(stats)
    before = wire.wire_stats().snapshot()
    comp = wire.dumps_partials(ap, served, compress=True)
    after = wire.wire_stats().snapshot()
    assert after["compressedPayloads"] == before["compressedPayloads"] + 1
    stats.record(after["logicalBytes"] - before["logicalBytes"],
                 after["wireBytes"] - before["wireBytes"], True)
    sink = InMemoryEmitter()
    mon.do_monitor(ServiceEmitter("historical", "h", sink))
    got = {e.metric: e.value for e in sink.metrics()}
    assert got["query/wire/compressedBytes"] < got["query/wire/bytes"]
    assert got["query/wire/compressedBytes"] < len(comp)
    sink2 = InMemoryEmitter()
    mon.do_monitor(ServiceEmitter("historical", "h", sink2))
    assert {e.metric: e.value for e in sink2.metrics()} == {
        "query/wire/bytes": 0, "query/wire/compressedBytes": 0}
