"""The port's extension aggregators, post-aggregators and the bloom filter
(druid_tpu_torch/ext/) against the reference package's, query by query.

Small segments made by the reference's DataGenerator cross into the port as
plain arrays (`tests/test_torch_slice._carry`); the same Druid JSON runs
through both `QueryExecutor`s (the reference with JAX on the CPU, the port
with device="cpu"). Every aggregator of the seven modules with its
post-aggregators, in timeseries (hourly), groupBy and topN, each with the
segments alone ({"batchSegments": false}) and batched (one stacked run,
checked through `batching.stats()`); filtered aggregators over ext
children with device bitmaps on and off; the bloom filter, built from a
BloomFilterValue, through the device-bitmap fill and the row program;
a rollup-order segment, which the run domain refuses in both packages;
distinctCount's cell budget alone and batched; the schema-evolution zero
and variance over a dimension.

The rule: the rows are equal, values, types and the sketch objects' states
(theta minima, quantile and histogram counts, histogram min/max, bloom
bits) included, but for variance and stddev, whose float64 sums add in no
fixed order: within 1e-9 relative.
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import druid_tpu.ext  # noqa: F401  (registers the reference's extensions)
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.engine import batching as ref_batching
from druid_tpu.ext import distinctcount as ref_distinct
from druid_tpu.utils.intervals import Interval

import druid_tpu_torch.ext  # noqa: F401  (registers the port's extensions)
from druid_tpu_torch.data import cascade as port_cascade
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import batching
from druid_tpu_torch.engine import filters as port_filters
from druid_tpu_torch.ext import BloomFilterValue
from druid_tpu_torch.ext import distinctcount as port_distinct
from tests.test_torch_run_domain import DAY as RD_DAY
from tests.test_torch_run_domain import _pair, _rollup
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

IV = "2026-07-01/2026-07-02"
SCHEMA = (
    ColumnSpec("dimA", "string", cardinality=6),
    ColumnSpec("dimB", "string", cardinality=60, distribution="zipf"),
    ColumnSpec("metLong", "long", low=-50, high=9000),
    ColumnSpec("metFloat", "float", distribution="normal", mean=100.0,
               std=25.0),
)
#: compared within 1e-9 relative; everything else is exact
CLOSE = {"var", "vars", "sd", "fvar"}


@pytest.fixture(autouse=True)
def _batching_on(monkeypatch):
    monkeypatch.setattr(ref_batching, "_ENABLED", True)
    monkeypatch.setattr(batching, "_ENABLED", True)


@pytest.fixture(scope="module")
def segs():
    ref = DataGenerator(SCHEMA, seed=5).segments(4, 2500, Interval.parse(IV),
                                                 datasource="ds")
    return ref, [_carry(s) for s in ref]


def _fa(name):
    return {"type": "fieldAccess", "fieldName": name}


AGGS = [
    {"type": "variance", "name": "var", "fieldName": "metFloat"},
    {"type": "variance", "name": "vars", "fieldName": "metLong",
     "estimator": "sample"},
    {"type": "thetaSketch", "name": "th", "fieldName": "dimB"},
    {"type": "thetaSketch", "name": "thn", "fieldName": "metLong",
     "size": 1000, "shouldFinalize": False},
    {"type": "quantilesDoublesSketch", "name": "qs", "fieldName": "metFloat"},
    {"type": "approxHistogram", "name": "h", "fieldName": "metFloat",
     "numBuckets": 20, "lowerLimit": 0.0, "upperLimit": 200.0},
    {"type": "approxHistogram", "name": "h2", "fieldName": "metLong",
     "numBuckets": 8, "lowerLimit": 0.0, "upperLimit": 1e-9},
    {"type": "bloom", "name": "b", "fieldName": "dimB"},
    {"type": "HLLSketchBuild", "name": "hs", "fieldName": "dimB"},
    {"type": "distinctCount", "name": "dc", "fieldName": "dimB"},
    {"type": "timeMin", "name": "tmin"},
    {"type": "timeMax", "name": "tmax"},
]
POST = [
    {"type": "stddev", "name": "sd", "fieldName": "var"},
    {"type": "quantilesDoublesSketchToQuantile", "name": "p50",
     "field": _fa("qs"), "fraction": 0.5},
    {"type": "quantilesDoublesSketchToQuantiles", "name": "ps",
     "field": _fa("qs"), "fractions": [0.9, 0.99]},
    {"type": "quantile", "name": "hq", "field": _fa("h"),
     "probability": 0.95},
    {"type": "HLLSketchToEstimate", "name": "hse", "field": _fa("hs"),
     "round": True},
    {"type": "thetaSketchEstimate", "name": "the", "field": _fa("thn")},
    {"type": "thetaSketchSetOp", "name": "tu", "func": "UNION",
     "fields": [_fa("thn"), _fa("thn")]},
]


def _state(v):
    """A value as comparable plain data: the sketch objects of either
    package by their state."""
    n = type(v).__name__
    if n == "ThetaSketchValue":
        return (n, v.mins.tobytes())
    if n == "QuantilesSketchValue":
        return (n, v.counts.tolist())
    if n == "HistogramValue":
        return (n, v.counts.tolist(), v.min, v.max, v.lower, v.upper)
    if n == "BloomFilterValue":
        return (n, v.bits.tobytes())
    if isinstance(v, np.ndarray):
        return ("ndarray", [_state(x) for x in v.tolist()])
    if isinstance(v, list):
        return [_state(x) for x in v]
    return v


def _close(want, got, where=()):
    if isinstance(want, dict):
        assert set(want) == set(got), where
        for k in want:
            if k in CLOSE:
                assert type(got[k]) is type(want[k]), (where, k)
                assert got[k] == pytest.approx(want[k], rel=1e-9), (where, k)
            else:
                _close(want[k], got[k], where + (k,))
    elif isinstance(want, list) and not isinstance(want, tuple):
        assert isinstance(got, list) and len(want) == len(got), where
        for i, (a, b) in enumerate(zip(want, got)):
            _close(a, b, where + (i,))
    elif isinstance(want, float) and np.isnan(want):
        assert isinstance(got, float) and np.isnan(got), where
    else:
        a, b = _state(want), _state(got)
        assert a == b and type(got).__name__ == type(want).__name__, \
            (where, a, b)


def _both(ref, port, q):
    want = RefExecutor(ref).run_json(q)
    got = PortExecutor(port, device="cpu").run_json(q)
    _close(want, got)
    return want, got


def _query(qt, aggs=AGGS, post=POST, **kw):
    q = {"queryType": qt, "dataSource": "ds", "intervals": [IV],
         "granularity": "hour" if qt == "timeseries" else "all",
         "aggregations": aggs, "postAggregations": post}
    if qt == "groupBy":
        q["dimensions"] = ["dimA"]
    if qt == "topN":
        q.update(dimension="dimA", metric="dc", threshold=4)
    q.update(kw)
    return q


@pytest.mark.parametrize("mode", ["alone", "batched"])
@pytest.mark.parametrize("qt", ["timeseries", "groupBy", "topN"])
def test_queries_match_reference(segs, qt, mode):
    ref, port = segs
    q = _query(qt)
    if mode == "alone":
        q["context"] = {"batchSegments": False}
    before = batching.stats().snapshot()
    want, got = _both(ref, port, q)
    ran = batching.stats().snapshot()["batchedSegments"] \
        - before["batchedSegments"]
    assert ran == (len(port) if mode == "batched" else 0)
    assert len(got) == (24 if qt == "timeseries" else 6 if qt == "groupBy"
                        else 1)


def _set(name, field, flt):
    return {"type": "filtered", "name": name, "filter": flt,
            "aggregator": {"type": "thetaSketch", "name": name,
                           "fieldName": field, "shouldFinalize": False}}


LOW = {"type": "bound", "dimension": "metLong", "upper": "5000",
       "upperStrict": True, "ordering": "numeric"}
HIGH = {"type": "bound", "dimension": "metFloat", "lower": "100",
        "lowerStrict": True, "ordering": "numeric"}
IN_B = {"type": "in", "dimension": "dimB",
        "values": [f"v{i:08d}" for i in range(0, 60, 3)]}
FILTERED = [
    _set("lo", "dimB", LOW), _set("hi", "dimB", HIGH),
    {"type": "filtered", "name": "fq", "filter": IN_B,
     "aggregator": {"type": "quantilesDoublesSketch", "name": "fq",
                    "fieldName": "metFloat"}},
    {"type": "filtered", "name": "ftmax", "filter": {"type": "not",
                                                     "field": IN_B},
     "aggregator": {"type": "timeMax", "name": "ftmax"}},
    {"type": "filtered", "name": "fvar", "filter": LOW,
     "aggregator": {"type": "variance", "name": "fvar",
                    "fieldName": "metFloat"}},
    {"type": "filtered", "name": "fdc", "filter": HIGH,
     "aggregator": {"type": "distinctCount", "name": "fdc",
                    "fieldName": "dimB"}},
    {"type": "HLLSketchBuild", "name": "u", "fieldName": "dimB", "lgK": 12},
]
SET_POST = [{"type": "thetaSketchSetOp", "name": f.lower(), "func": f,
             "fields": [_fa("lo"), _fa("hi")]}
            for f in ("UNION", "INTERSECT", "NOT")] + [
    {"type": "thetaSketchEstimate", "name": "loe", "field": _fa("lo")},
    {"type": "HLLSketchToEstimate", "name": "ue", "field": _fa("u")},
    {"type": "quantilesDoublesSketchToQuantile", "name": "fp90",
     "field": _fa("fq"), "fraction": 0.9}]


@pytest.mark.parametrize("bitmaps", [True, False])
def test_filtered_ext_children(segs, bitmaps):
    """The retention query of Druid's theta docs: filtered sketches, their
    set operations and estimates, under a query filter on dimB."""
    ref, port = segs
    prev = port_filters.set_device_bitmap_enabled(bitmaps)
    try:
        _both(ref, port, _query("groupBy", FILTERED, SET_POST,
                                filter={"type": "not", "field": {
                                    "type": "selector", "dimension": "dimB",
                                    "value": "v00000001"}}))
    finally:
        port_filters.set_device_bitmap_enabled(prev)


@pytest.mark.parametrize("bitmaps", [True, False])
def test_bloom_filter_paths(segs, bitmaps):
    """A bloom filter built host-side from 10 dimB values, through the
    device-bitmap fill and the row program, with a bloom aggregator."""
    ref, port = segs
    vals = [f"v{i:08d}" for i in range(0, 40, 4)]
    blm = BloomFilterValue(np.zeros(200, dtype=np.uint8))
    from druid_tpu_torch.ext.bloom import _bit_positions
    for v in vals:
        blm.bits[_bit_positions(v, 200)] = 1
    flt = {"type": "bloom", "dimension": "dimB",
           "bloomKFilter": blm.serialize(), "mBits": 200}
    aggs = [{"type": "count", "name": "n"},
            {"type": "bloom", "name": "b", "fieldName": "dimB",
             "maxNumEntries": 50}]
    prev = port_filters.set_device_bitmap_enabled(bitmaps)
    try:
        for qt in ("timeseries", "groupBy"):
            want, got = _both(ref, port, _query(qt, aggs, [], filter=flt,
                                                granularity="all"))
        # the bloom bits of each group hold the values that passed
        for r in got:
            assert all(r["event"]["b"].test(v) for v in vals
                       if r["event"]["n"]) or r["event"]["n"] == 0
    finally:
        port_filters.set_device_bitmap_enabled(prev)


def test_rollup_order_segment_runs_the_row_program():
    """The run domain serves a count over rollup-order segments but refuses
    a plan holding an ext kernel, in both packages; the rows agree."""
    ref, port = _pair(_rollup(n_seg=2, rows=4096))
    q = {"queryType": "groupBy", "dataSource": "rd", "intervals": [RD_DAY],
         "granularity": "all", "dimensions": ["d0"],
         "aggregations": [{"type": "count", "name": "n"}]}
    stats = port_cascade.code_domain_stats()
    hits = stats.snapshot()["hits"]
    PortExecutor(port, device="cpu").run_json(q)
    assert stats.snapshot()["hits"] == hits + 2
    q["aggregations"] = q["aggregations"] + [
        {"type": "timeMin", "name": "tmin"},
        {"type": "quantilesDoublesSketch", "name": "qs", "fieldName": "m1"},
        {"type": "thetaSketch", "name": "th", "fieldName": "d1",
         "size": 64},
        {"type": "variance", "name": "var", "fieldName": "m0"}]
    hits = stats.snapshot()["hits"]
    _both(ref, port, q)
    assert stats.snapshot()["hits"] == hits


@pytest.mark.parametrize("batched", [False, True])
def test_distinct_count_cell_budget(segs, monkeypatch, batched):
    """The budget is each segment's groups x cardinality, also in a stacked
    run of K segments: over it both packages raise the same ValueError,
    at it both answer."""
    ref, port = segs
    q = _query("groupBy", [{"type": "distinctCount", "name": "dc",
                            "fieldName": "dimA"}], [],
               dimensions=["dimB"],
               context={"batchSegments": batched})
    cells = 64 * 6           # G (dimB's 60 padded to 64) x cardinality (dimA)
    for mod in (ref_distinct, port_distinct):
        monkeypatch.setattr(mod, "MAX_CELLS", cells - 1)
    with pytest.raises(ValueError) as rerr:
        RefExecutor(ref).run_json(q)
    with pytest.raises(ValueError) as perr:
        PortExecutor(port, device="cpu").run_json(q)
    assert str(perr.value) == str(rerr.value)
    for mod in (ref_distinct, port_distinct):
        monkeypatch.setattr(mod, "MAX_CELLS", cells)
    _both(ref, port, q)


def test_schema_evolution_contributes_zero():
    """A segment without the dimension counts 0 distinct values."""
    from druid_tpu.data.segment import SegmentBuilder as RefBuilder
    from druid_tpu.utils.intervals import parse_ts
    t0 = parse_ts("2026-05-01")
    day = 86_400_000
    a = RefBuilder("se", Interval(t0, t0 + day), version="v1")
    a.add_columns([t0, t0 + 1, t0 + 2], dims={"user": ["u1", "u2", "u1"]},
                  metrics={"m": np.asarray([1.5, 2.5, 4.0])})
    b = RefBuilder("se", Interval(t0 + day, t0 + 2 * day), version="v1")
    b.add_columns([t0 + day], dims={"other": ["x"]},
                  metrics={"m": np.asarray([8.0])})
    ref = [a.build(), b.build()]
    port = [_carry(s) for s in ref]
    q = {"queryType": "timeseries", "dataSource": "se",
         "intervals": ["2026-05-01/2026-05-03"], "granularity": "day",
         "aggregations": [
             {"type": "distinctCount", "name": "u", "fieldName": "user"},
             {"type": "timeMax", "name": "tmax"},
             {"type": "quantilesDoublesSketch", "name": "qs",
              "fieldName": "m"}]}
    want, got = _both(ref, port, q)
    assert [r["result"]["u"] for r in got] == [2, 0]
    q["granularity"] = "all"
    want, got = _both(ref, port, q)
    assert got[0]["result"]["u"] == 2
    # the column-reading kernels (theta, quantiles, histogram, variance)
    # raise KeyError on a segment without the column, in both packages
    q["aggregations"] = [{"type": "thetaSketch", "name": "t",
                          "fieldName": "user", "size": 16}]
    with pytest.raises(KeyError):
        RefExecutor(ref).run_json(q)
    with pytest.raises(KeyError):
        PortExecutor(port, device="cpu").run_json(q)


def test_variance_over_a_dimension_raises(segs):
    ref, port = segs
    q = _query("timeseries", [{"type": "variance", "name": "v",
                               "fieldName": "dimA"}], [])
    with pytest.raises(ValueError) as rerr:
        RefExecutor(ref).run_json(q)
    with pytest.raises(ValueError) as perr:
        PortExecutor(port, device="cpu").run_json(q)
    assert str(perr.value) == str(rerr.value)
