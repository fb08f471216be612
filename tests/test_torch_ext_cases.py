"""The reference's extension suite (tests/test_extensions.py), case by case,
on the port: the same data (the reference's TEST_SCHEMA, carried as plain
arrays), the same queries through `druid_tpu_torch.engine.QueryExecutor`
on the CPU, the same checks against numpy, plus the JSON round trip of
every type the port registers.

test_extension_sql is in tests/test_torch_sql.py. test_extension_sharded_merge
runs the extension states through the broker over two data nodes and
through the port's mesh (8 CPU shards) besides. The URI namespace lookup
cases are in tests/test_torch_lookups.py, the protobuf parser cases in
tests/test_torch_protobuf.py.
"""
import numpy as np
import pytest
import torch

from druid_tpu.data.generator import DataGenerator
from tests.conftest import DAY, TEST_SCHEMA, rows_as_frame

import druid_tpu_torch.ext  # noqa: F401  (registers the port's extensions)
from druid_tpu_torch.data.segment import SegmentBuilder
from druid_tpu_torch.engine import QueryExecutor
from druid_tpu_torch.ext import (ApproximateHistogramAggregator,
                                 BloomDimFilter, BloomFilterAggregator,
                                 BloomFilterValue, HistogramQuantilePostAgg,
                                 QuantilePostAgg, QuantilesSketchAggregator,
                                 StandardDeviationPostAgg,
                                 ThetaSketchAggregator,
                                 ThetaSketchSetOpPostAgg, VarianceAggregator)
from druid_tpu_torch.query import aggregators as A
from druid_tpu_torch.query.aggregators import agg_from_json
from druid_tpu_torch.query.filters import (BoundFilter, InFilter,
                                           filter_from_json)
from druid_tpu_torch.query.model import (DefaultDimensionSpec, GroupByQuery,
                                         TimeseriesQuery, query_from_json)
from druid_tpu_torch.query.postaggs import (FieldAccessPostAgg,
                                            postagg_from_json)
from druid_tpu_torch.utils.intervals import Interval, parse_ts
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

PDAY = Interval(DAY.start, DAY.end)
PDAY_S = "2026-01-01/2026-01-02"


@pytest.fixture(scope="module")
def data():
    ref = DataGenerator(TEST_SCHEMA, seed=42).segment(20_000, DAY,
                                                      datasource="test")
    seg = _carry(ref)
    return seg, rows_as_frame(ref)


@pytest.fixture(scope="module")
def ex(data):
    return QueryExecutor([data[0]], device="cpu")


@pytest.fixture(scope="module")
def week():
    ref = DataGenerator(TEST_SCHEMA, seed=43).segments(
        4, 5_000, Interval.of("2026-01-01", "2026-01-05"), datasource="test")
    return [_carry(s) for s in ref], [rows_as_frame(s) for s in ref]


def test_variance_and_stddev(ex, data):
    frame = data[1]
    q = TimeseriesQuery.of(
        "test", [PDAY],
        [VarianceAggregator("var", "metFloat"),
         VarianceAggregator("vars", "metFloat", "sample")],
        post_aggregations=[StandardDeviationPostAgg("sd", "var")])
    r = ex.run(q)[0]["result"]
    x = frame["metFloat"].astype(np.float64)
    assert r["var"] == pytest.approx(x.var(), rel=1e-6)
    assert r["vars"] == pytest.approx(x.var(ddof=1), rel=1e-6)
    assert r["sd"] == pytest.approx(x.std(), rel=1e-6)


def test_variance_grouped(ex, data):
    frame = data[1]
    q = GroupByQuery.of("test", [PDAY], [DefaultDimensionSpec("dimA")],
                        [VarianceAggregator("var", "metLong")])
    rows = ex.run(q)
    assert len(rows) == 10
    for r in rows:
        sel = frame["dimA"] == r["event"]["dimA"]
        want = frame["metLong"][sel].astype(np.float64).var()
        assert r["event"]["var"] == pytest.approx(want, rel=1e-6)


def test_theta_fractional_doubles_distinct():
    """Distinct fractional values count distinctly (bit-pattern hash, not
    integer truncation), in theta and in byRow cardinality."""
    from druid_tpu.data.generator import ColumnSpec
    from druid_tpu.utils.intervals import Interval as RefInterval
    iv = RefInterval.of("2026-01-01", "2026-01-02")
    gen = DataGenerator((ColumnSpec("m", "double", low=0.0, high=1.0),),
                        seed=1)
    seg = _carry(gen.segment(20_000, iv, datasource="frac"))
    exact = len(set(seg.metrics["m"].values.tolist()))
    piv = Interval(iv.start, iv.end)
    ex = QueryExecutor([seg], device="cpu")
    r = ex.run(TimeseriesQuery.of("frac", [piv],
                                  [ThetaSketchAggregator("u", "m")]))
    assert r[0]["result"]["u"] == pytest.approx(exact, rel=0.06)
    r2 = ex.run(TimeseriesQuery.of(
        "frac", [piv], [A.CardinalityAggregator("u", ("m",), by_row=True)]))
    assert r2[0]["result"]["u"] == pytest.approx(exact, rel=0.08)


def test_theta_estimate(ex, data):
    frame = data[1]
    r = ex.run(TimeseriesQuery.of(
        "test", [PDAY], [ThetaSketchAggregator("u", "dimHi")]))[0]["result"]
    assert r["u"] == pytest.approx(len(set(frame["dimHi"])), rel=0.06)


def test_theta_set_ops(ex, data):
    frame = data[1]
    lo = A.FilteredAggregator(
        "lo", ThetaSketchAggregator("lo", "dimHi", should_finalize=False),
        BoundFilter("metLong", upper="60", ordering="numeric"))
    hi = A.FilteredAggregator(
        "hi", ThetaSketchAggregator("hi", "dimHi", should_finalize=False),
        BoundFilter("metLong", lower="40", ordering="numeric"))
    fields = (FieldAccessPostAgg("lo", "lo"), FieldAccessPostAgg("hi", "hi"))
    q = TimeseriesQuery.of(
        "test", [PDAY], [lo, hi], post_aggregations=[
            ThetaSketchSetOpPostAgg("u", "UNION", fields),
            ThetaSketchSetOpPostAgg("i", "INTERSECT", fields)])
    r = ex.run(q)[0]["result"]
    m = frame["metLong"]
    a = set(frame["dimHi"][m <= 60])
    b = set(frame["dimHi"][m >= 40])
    assert r["u"] == pytest.approx(len(a | b), rel=0.08)
    assert r["i"] == pytest.approx(len(a & b), rel=0.15)


def test_quantiles_sketch(ex, data):
    frame = data[1]
    q = TimeseriesQuery.of(
        "test", [PDAY], [QuantilesSketchAggregator("qs", "metFloat")],
        post_aggregations=[
            QuantilePostAgg("p50", FieldAccessPostAgg("qs", "qs"), 0.5),
            QuantilePostAgg("p95", FieldAccessPostAgg("qs", "qs"), 0.95)])
    r = ex.run(q)[0]["result"]
    x = np.sort(frame["metFloat"].astype(np.float64))
    assert r["p50"] == pytest.approx(np.quantile(x, 0.5), rel=0.05)
    assert r["p95"] == pytest.approx(np.quantile(x, 0.95), rel=0.05)


def test_quantiles_negative_values():
    from druid_tpu.data.generator import ColumnSpec
    from druid_tpu.utils.intervals import Interval as RefInterval
    iv = RefInterval.of("2026-01-01", "2026-01-02")
    gen = DataGenerator((ColumnSpec("m", "double", distribution="normal",
                                    mean=0.0, std=100.0),), seed=3)
    seg = _carry(gen.segment(50_000, iv, datasource="neg"))
    q = TimeseriesQuery.of(
        "neg", [Interval(iv.start, iv.end)],
        [QuantilesSketchAggregator("qs", "m")],
        post_aggregations=[
            QuantilePostAgg("p10", FieldAccessPostAgg("qs", "qs"), 0.10),
            QuantilePostAgg("p90", FieldAccessPostAgg("qs", "qs"), 0.90)])
    r = QueryExecutor([seg], device="cpu").run(q)[0]["result"]
    x = seg.metrics["m"].values.astype(np.float64)
    assert r["p10"] == pytest.approx(np.quantile(x, 0.10), rel=0.06)
    assert r["p90"] == pytest.approx(np.quantile(x, 0.90), rel=0.06)


def test_histogram(ex, data):
    frame = data[1]
    q = TimeseriesQuery.of(
        "test", [PDAY],
        [ApproximateHistogramAggregator("h", "metLong", 50, 0.0, 101.0)],
        post_aggregations=[
            HistogramQuantilePostAgg("med", FieldAccessPostAgg("h", "h"),
                                     0.5)])
    r = ex.run(q)[0]["result"]
    x = frame["metLong"].astype(np.float64)
    assert r["h"].count == len(x)
    assert r["h"].min == x.min() and r["h"].max == x.max()
    assert r["med"] == pytest.approx(np.quantile(x, 0.5), abs=3.0)
    j = r["h"].to_json()
    assert sum(j["counts"]) == len(x) and len(j["breaks"]) == 51


def test_bloom_aggregator_and_filter(ex, data):
    frame = data[1]
    blm = ex.run(TimeseriesQuery.of(
        "test", [PDAY],
        [BloomFilterAggregator("b", "dimA")]))[0]["result"]["b"]
    for v in set(frame["dimA"]):
        assert blm.test(v)
    misses = sum(blm.test(f"nope{i}") for i in range(1000))
    assert misses < 30                      # ~1% target fpp
    restored = BloomFilterValue.deserialize(blm.serialize(), blm.m_bits)
    assert np.array_equal(restored.bits, blm.bits)
    some = sorted(set(frame["dimA"]))[:3]
    partial = TimeseriesQuery.of(
        "test", [PDAY], [BloomFilterAggregator("b", "dimA")],
        filter=InFilter("dimA", tuple(some)))
    blm2 = ex.run(partial)[0]["result"]["b"]
    flt = BloomDimFilter("dimA", blm2.serialize(), blm2.m_bits)
    n = ex.run(TimeseriesQuery.of("test", [PDAY], [A.CountAggregator("n")],
                                  filter=flt))[0]["result"]["n"]
    assert n == int(np.isin(frame["dimA"], some).sum())


def test_extension_json_serde(data):
    for j in [
        {"type": "variance", "name": "v", "fieldName": "m"},
        {"type": "thetaSketch", "name": "t", "fieldName": "d"},
        {"type": "quantilesDoublesSketch", "name": "q", "fieldName": "m"},
        {"type": "approxHistogram", "name": "h", "fieldName": "m",
         "numBuckets": 10, "lowerLimit": 0.0, "upperLimit": 1.0},
        {"type": "bloom", "name": "b", "fieldName": "d"},
    ]:
        j2 = agg_from_json(j).to_json()
        assert agg_from_json(j2).to_json() == j2
    pa = postagg_from_json({
        "type": "quantilesDoublesSketchToQuantile", "name": "p",
        "field": {"type": "fieldAccess", "fieldName": "q"}, "fraction": 0.9})
    assert pa.to_json()["fraction"] == 0.9
    q = query_from_json({
        "queryType": "timeseries", "dataSource": "test",
        "intervals": [PDAY_S], "granularity": "all",
        "aggregations": [{"type": "variance", "name": "v",
                          "fieldName": "metFloat"}]})
    assert QueryExecutor([data[0]], device="cpu").run(q)[0]["result"]["v"] > 0


def _fa(name):
    return {"type": "fieldAccess", "fieldName": name}


#: one of every aggregator, post-aggregator and filter type the port's
#: ext registers, in the reference's wire form
WIRE_AGGS = [
    {"type": "variance", "name": "v", "fieldName": "m",
     "estimator": "sample"},
    {"type": "thetaSketch", "name": "t", "fieldName": "d", "size": 1000,
     "shouldFinalize": False},
    {"type": "quantilesDoublesSketch", "name": "q", "fieldName": "m"},
    {"type": "approxHistogram", "name": "h", "fieldName": "m",
     "numBuckets": 10, "lowerLimit": -1.0, "upperLimit": 1e-9},
    {"type": "bloom", "name": "b", "fieldName": "d", "maxNumEntries": 77},
    {"type": "HLLSketchBuild", "name": "hb", "fieldName": "d", "lgK": 11,
     "round": True},
    {"type": "HLLSketchMerge", "name": "hm", "fieldName": "d", "lgK": 12,
     "round": False},
    {"type": "distinctCount", "name": "dc", "fieldName": "d"},
    {"type": "timeMin", "name": "tmin", "fieldName": "__time"},
    {"type": "timeMax", "name": "tmax", "fieldName": "__time"},
]
WIRE_POST = [
    {"type": "stddev", "name": "sd", "fieldName": "v"},
    {"type": "thetaSketchEstimate", "name": "te", "field": _fa("t")},
    {"type": "thetaSketchSetOp", "name": "ts", "func": "NOT",
     "fields": [_fa("t"), _fa("t")]},
    {"type": "quantilesDoublesSketchToQuantile", "name": "p",
     "field": _fa("q"), "fraction": 0.9},
    {"type": "quantilesDoublesSketchToQuantiles", "name": "ps",
     "field": _fa("q"), "fractions": [0.1, 0.5]},
    {"type": "quantile", "name": "hq", "field": _fa("h"),
     "probability": 0.25},
    {"type": "HLLSketchToEstimate", "name": "he", "field": _fa("hb"),
     "round": True},
]


def _wire(j):
    """JSON with the nested fieldAccess names filled in (to_json writes
    them)."""
    if isinstance(j, dict):
        out = {k: _wire(v) for k, v in j.items()}
        if out.get("type") == "fieldAccess":
            out.setdefault("name", out["fieldName"])
        return out
    if isinstance(j, list):
        return [_wire(v) for v in j]
    return j


@pytest.mark.parametrize("j", WIRE_AGGS, ids=lambda j: j["type"])
def test_aggregator_round_trip_matches_reference(j):
    import druid_tpu.ext  # noqa: F401
    from druid_tpu.query.aggregators import agg_from_json as ref_agg
    spec = agg_from_json(j)
    assert spec.to_json() == j == ref_agg(j).to_json()
    assert agg_from_json(spec.to_json()) == spec


@pytest.mark.parametrize("j", WIRE_POST, ids=lambda j: j["type"])
def test_postagg_round_trip_matches_reference(j):
    import druid_tpu.ext  # noqa: F401
    from druid_tpu.query.postaggs import postagg_from_json as ref_post
    pa = postagg_from_json(j)
    assert pa.to_json() == _wire(j) == ref_post(j).to_json()
    assert postagg_from_json(pa.to_json()) == pa


def test_bloom_filter_round_trip_matches_reference():
    import druid_tpu.ext  # noqa: F401
    from druid_tpu.query.filters import filter_from_json as ref_filter
    bits = np.zeros(100, dtype=np.uint8)
    bits[::7] = 1
    j = {"type": "bloom", "dimension": "d",
         "bloomKFilter": BloomFilterValue(bits).serialize(), "mBits": 100}
    flt = filter_from_json(j)
    assert flt.to_json() == j == ref_filter(j).to_json()
    assert filter_from_json(flt.to_json()) == flt
    assert np.array_equal(BloomFilterValue.deserialize(
        j["bloomKFilter"], 100).bits, bits)
    # an unknown type still raises in every registry
    for parse in (agg_from_json, postagg_from_json, filter_from_json):
        with pytest.raises(ValueError):
            parse({"type": "nosuchType", "name": "x"})


def test_hllsketch_build_and_estimate(ex, data):
    frame = data[1]
    rows = ex.run_json({
        "queryType": "timeseries", "dataSource": "test",
        "intervals": [PDAY_S], "granularity": "all",
        "aggregations": [{"type": "HLLSketchBuild", "name": "u",
                          "fieldName": "dimHi", "lgK": 12}],
        "postAggregations": [{"type": "HLLSketchToEstimate", "name": "est",
                              "round": True, "field": _fa("u")}]})
    exact = len(np.unique(frame["dimHi"]))
    assert abs(rows[0]["result"]["est"] - exact) / exact < 0.1
    m = agg_from_json({"type": "HLLSketchMerge", "name": "u",
                       "fieldName": "dimHi", "lgK": 11, "round": True})
    assert m.log2m == 11 and m.round
    assert m.to_json()["type"] == "HLLSketchMerge"


def test_hllsketch_grouped_matches_hyperunique(ex):
    def q(agg):
        return {"queryType": "groupBy", "dataSource": "test",
                "intervals": [PDAY_S], "granularity": "all",
                "dimensions": ["dimA"], "aggregations": [agg]}
    got = ex.run_json(q({"type": "HLLSketchBuild", "name": "u",
                         "fieldName": "dimB", "lgK": 11, "round": True}))
    want = ex.run_json(q({"type": "hyperUnique", "name": "u",
                          "fieldName": "dimB", "round": True}))

    def key(rows):
        return {r["event"]["dimA"]: r["event"]["u"] for r in rows}
    assert key(got) == key(want)


def test_extension_sharded_merge(week):
    """Extension states merge across segments: on the host, through the
    broker over two data nodes, and on a mesh of 8 CPU shards (the sharded
    merge: variance sums, quantile counts and theta minima exactly as the
    host merge has them)."""
    from druid_tpu_torch.cluster import (Broker, DataNode, InventoryView,
                                         descriptor_for)
    from druid_tpu_torch.parallel import distributed, make_mesh
    segs, frames = week
    allf = np.concatenate([f["metFloat"] for f in frames]).astype(np.float64)
    q = TimeseriesQuery.of(
        "test", [Interval.of("2026-01-01", "2026-01-08")],
        [VarianceAggregator("v", "metFloat"),
         QuantilesSketchAggregator("qs", "metFloat"),
         ThetaSketchAggregator("u", "dimHi")],
        post_aggregations=[
            QuantilePostAgg("p50", FieldAccessPostAgg("qs", "qs"), 0.5)])
    local = QueryExecutor(segs, device="cpu").run(q)[0]["result"]
    assert local["v"] == pytest.approx(allf.var(), rel=1e-6)
    assert local["p50"] == pytest.approx(np.quantile(allf, 0.5), rel=0.05)
    view = InventoryView()
    nodes = [DataNode(f"n{i}", device="cpu") for i in range(2)]
    for n in nodes:
        view.register(n)
    for i, s in enumerate(segs):
        nodes[i % 2].load_segment(s)
        view.announce(nodes[i % 2].name, descriptor_for(s))
    broker = Broker(view, device="cpu")
    try:
        remote = broker.run(q)[0]["result"]
    finally:
        broker.stop()
    assert remote["v"] == pytest.approx(local["v"], rel=1e-12)
    assert remote["p50"] == local["p50"]
    assert remote["u"] == local["u"]       # exact state merge across nodes
    before = distributed.sharded_stats().snapshot()[0]
    mesh = QueryExecutor(segs, device="cpu",
                         mesh=make_mesh(8, device="cpu")).run(q)[0]["result"]
    assert distributed.sharded_stats().snapshot()[0] == before + 1
    assert mesh["v"] == pytest.approx(local["v"], rel=1e-12)
    assert mesh["p50"] == local["p50"]
    assert mesh["u"] == local["u"]


def test_time_min_max_grouped(ex, data):
    frame = data[1]
    rows = ex.run_json({
        "queryType": "groupBy", "dataSource": "test",
        "intervals": [PDAY_S], "granularity": "all",
        "dimensions": ["dimA"],
        "aggregations": [{"type": "timeMin", "name": "tmin"},
                         {"type": "timeMax", "name": "tmax"}]})
    t = frame["__time"]
    assert len(rows) == 10
    for r in rows:
        sel = frame["dimA"] == r["event"]["dimA"]
        assert r["event"]["tmin"] == int(t[sel].min())
        assert r["event"]["tmax"] == int(t[sel].max())


def test_time_min_max_filtered_timeseries(ex, data):
    frame = data[1]
    rows = ex.run_json({
        "queryType": "timeseries", "dataSource": "test",
        "intervals": [PDAY_S], "granularity": "all",
        "filter": {"type": "bound", "dimension": "metLong",
                   "lower": "50", "ordering": "numeric"},
        "aggregations": [{"type": "timeMin", "name": "tmin"},
                         {"type": "timeMax", "name": "tmax"}]})
    sel = frame["metLong"] >= 50
    assert rows[0]["result"]["tmin"] == int(frame["__time"][sel].min())
    assert rows[0]["result"]["tmax"] == int(frame["__time"][sel].max())


def test_time_min_max_multi_segment_merge(week):
    """Cross-segment merge keeps absolute-time semantics."""
    segs, frames = week
    rows = QueryExecutor(segs, device="cpu").run_json({
        "queryType": "groupBy", "dataSource": "test",
        "intervals": ["2026-01-01/2026-01-08"], "granularity": "all",
        "dimensions": ["dimA"],
        "aggregations": [{"type": "timeMin", "name": "tmin"},
                         {"type": "timeMax", "name": "tmax"}]})
    assert rows
    for r in rows:
        sels = [(f, f["dimA"] == r["event"]["dimA"]) for f in frames]
        lo = min(int(f["__time"][s].min()) for f, s in sels if s.any())
        hi = max(int(f["__time"][s].max()) for f, s in sels if s.any())
        assert r["event"]["tmin"] == lo and r["event"]["tmax"] == hi


def test_distinct_count_single_segment_exact(ex, data):
    frame = data[1]
    rows = ex.run_json({
        "queryType": "groupBy", "dataSource": "test",
        "intervals": [PDAY_S], "granularity": "all",
        "dimensions": ["dimA"],
        "aggregations": [{"type": "distinctCount", "name": "u",
                          "fieldName": "dimB"}]})
    assert len(rows) == 10
    for r in rows:
        sel = frame["dimA"] == r["event"]["dimA"]
        assert r["event"]["u"] == len(set(frame["dimB"][sel]))


def test_distinct_count_filtered_timeseries(ex, data):
    frame = data[1]
    rows = ex.run_json({
        "queryType": "timeseries", "dataSource": "test",
        "intervals": [PDAY_S], "granularity": "all",
        "filter": {"type": "bound", "dimension": "metLong",
                   "lower": "50", "ordering": "numeric"},
        "aggregations": [{"type": "distinctCount", "name": "u",
                          "fieldName": "dimB"}]})
    sel = frame["metLong"] >= 50
    assert rows[0]["result"]["u"] == len(set(frame["dimB"][sel]))


def test_distinct_count_partitioned_segments_exact():
    """The contrib accuracy contract: exact across segments when each
    value lives in one segment."""
    t0 = parse_ts("2026-05-01")
    iv = Interval.of("2026-05-01", "2026-05-02")
    segs = []
    for part, vals in enumerate((["u1", "u2", "u3"], ["u4", "u5"])):
        b = SegmentBuilder("pd", iv, version="v1", partition=part)
        b.add_columns([t0 + i for i in range(30)],
                      dims={"user": [vals[i % len(vals)] for i in range(30)]},
                      metrics={})
        segs.append(b.build())
    rows = QueryExecutor(segs, device="cpu").run_json({
        "queryType": "timeseries", "dataSource": "pd",
        "intervals": [str(iv)], "granularity": "all",
        "aggregations": [{"type": "distinctCount", "name": "u",
                          "fieldName": "user"}]})
    assert rows[0]["result"]["u"] == 5


def test_distinct_count_schema_evolution_contributes_zero():
    t0 = parse_ts("2026-05-01")
    a = SegmentBuilder("se", Interval(t0, t0 + 86_400_000), version="v1")
    a.add_columns([t0, t0 + 1], dims={"user": ["u1", "u2"]}, metrics={})
    b = SegmentBuilder("se", Interval(t0 + 86_400_000, t0 + 2 * 86_400_000),
                       version="v1")
    b.add_columns([t0 + 86_400_000], dims={"other": ["x"]}, metrics={})
    rows = QueryExecutor([a.build(), b.build()], device="cpu").run_json({
        "queryType": "timeseries", "dataSource": "se",
        "intervals": [str(Interval(t0, t0 + 2 * 86_400_000))],
        "granularity": "all",
        "aggregations": [{"type": "distinctCount", "name": "u",
                          "fieldName": "user"}]})
    assert rows[0]["result"]["u"] == 2
