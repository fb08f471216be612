"""The port's aggregate path against the reference package, end to end.

Segments come from the reference's DataGenerator and cross into the port
through `segment_from_arrays` as plain numpy arrays. The same Druid JSON
queries (timeseries at granularity all and hour, topN, groupBy with filters,
a missing column, an empty interval) run through both `QueryExecutor`s; the
port runs on the CPU, so kernel B1 takes its plain version. Counts, long
sums and min/max must match exactly; float sums within 1e-5 * sum|v| per
row, where sum|v| is the row's floatSum over the column |metFloat|.
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.data.segment import NumericColumn, ValueType
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.engine import grouping as ref_grouping
from druid_tpu.engine import pallas_agg
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.data import generator as port_generator
from druid_tpu_torch.data.convert import segment_from_arrays
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import grouping as port_grouping
from druid_tpu_torch.engine import megakernel, sorted_reduce
from druid_tpu_torch.utils.intervals import Interval as PortInterval

# One intra-op thread: these tensors are small, and an OpenMP pool in every
# test worker would compete for cores with the suite's timing tests.
torch.set_num_threads(1)

IV = "2026-07-01/2026-07-02"
SCHEMA = (
    ColumnSpec("dimA", "string", cardinality=20),
    ColumnSpec("dimB", "string", cardinality=300, distribution="zipf"),
    ColumnSpec("metLong", "long", low=-500, high=9_000),
    ColumnSpec("metFloat", "float", distribution="normal", mean=10.0,
               std=400.0),
)
#: float-sum aggregate -> the aggregate holding sum|v| over the same rows
FLOAT_SUMS = {"fsum": "fabs", "dsum": "fabs", "fabs": "fabs"}


def _carry(seg):
    """A reference Segment handed to the port as plain arrays."""
    return segment_from_arrays(
        seg.time_ms,
        {n: (c.ids, c.dictionary.values) for n, c in seg.dims.items()},
        {n: (m.type.value, m.values) for n, m in seg.metrics.items()},
        seg.id.datasource, (seg.interval.start, seg.interval.end),
        seg.id.version, seg.id.partition)


@pytest.fixture(scope="module")
def segs():
    gen = DataGenerator(SCHEMA, seed=77)
    ref = gen.segments(2, 12_000, Interval.parse(IV), datasource="ds")
    for s in ref:
        s.metrics["absFloat"] = NumericColumn(
            np.abs(s.metrics["metFloat"].values), ValueType.FLOAT)
    return ref, [_carry(s) for s in ref]


AGGS = [{"type": "count", "name": "rows"},
        {"type": "longSum", "name": "lsum", "fieldName": "metLong"},
        {"type": "floatSum", "name": "fsum", "fieldName": "metFloat"},
        {"type": "doubleSum", "name": "dsum", "fieldName": "metFloat"},
        {"type": "floatSum", "name": "fabs", "fieldName": "absFloat"},
        {"type": "longMin", "name": "lmin", "fieldName": "metLong"},
        {"type": "longMax", "name": "lmax", "fieldName": "metLong"},
        {"type": "floatMax", "name": "fmax", "fieldName": "metFloat"},
        {"type": "doubleMin", "name": "dmin", "fieldName": "metFloat"}]

#: the projection strategy needs every aggregator blocked-eligible, which a
#: doubleSum is not (in both packages)
PROJ_AGGS = [a for a in AGGS if a["type"] != "doubleSum"]

POST = [{"type": "arithmetic", "name": "avg", "fn": "/",
         "fields": [{"type": "fieldAccess", "fieldName": "lsum"},
                    {"type": "fieldAccess", "fieldName": "rows"}]}]


def _in_a(k=10):
    return {"type": "in", "dimension": "dimA",
            "values": [f"v{i:08d}" for i in range(0, 2 * k, 2)]}


BOUND = {"type": "bound", "dimension": "metLong", "lower": "100",
         "upper": "8000", "ordering": "numeric"}
SEL_B = {"type": "selector", "dimension": "dimB", "value": "v00000000"}


def _compare_values(r, p, where):
    assert set(r) == set(p), where
    for k, rv in r.items():
        pv = p[k]
        if k in FLOAT_SUMS:
            tol = 1e-5 * abs(r[FLOAT_SUMS[k]])
            assert abs(pv - rv) <= tol, (where, k, rv, pv)
        elif isinstance(rv, float) and k == "avg":
            assert pv == pytest.approx(rv, rel=1e-12), (where, k)
        elif isinstance(rv, float) and np.isnan(rv):
            assert np.isnan(pv), (where, k)
        else:
            assert pv == rv and type(pv) is type(rv), (where, k, rv, pv)


def _compare(ref_rows, port_rows):
    assert len(ref_rows) == len(port_rows)
    for i, (r, p) in enumerate(zip(ref_rows, port_rows)):
        assert r["timestamp"] == p["timestamp"], i
        if "event" in r:
            _compare_values(r["event"], p["event"], i)
        elif isinstance(r["result"], list):
            assert len(r["result"]) == len(p["result"]), i
            for j, (a, b) in enumerate(zip(r["result"], p["result"])):
                _compare_values(a, b, (i, j))
        else:
            _compare_values(r["result"], p["result"], i)


def _both(segs, q):
    ref, port = segs
    want = RefExecutor(ref).run_json(q)
    got = PortExecutor(port, device="cpu").run_json(q)
    _compare(want, got)
    return want, got


@pytest.mark.parametrize("gran,flt", [
    ("all", None), ("hour", BOUND), ("hour", {"type": "not", "field": SEL_B}),
    ("all", {"type": "interval", "dimension": "__time",
             "intervals": ["2026-07-01T03:00/2026-07-01T09:30"]}),
])
def test_timeseries_matches_reference(segs, gran, flt):
    q = {"queryType": "timeseries", "dataSource": "ds", "intervals": [IV],
         "granularity": gran, "aggregations": AGGS, "postAggregations": POST,
         "filter": flt}
    want, _ = _both(segs, q)
    assert want


@pytest.mark.parametrize("flt", [None, _in_a(), {"type": "and", "fields": [
    _in_a(), BOUND]}])
def test_topn_matches_reference(segs, flt):
    q = {"queryType": "topN", "dataSource": "ds", "intervals": [IV],
         "granularity": "all", "dimension": "dimB", "metric": "lsum",
         "threshold": 25, "aggregations": AGGS, "filter": flt}
    want, _ = _both(segs, q)
    assert len(want[0]["result"]) == 25


@pytest.mark.parametrize("flt", [
    BOUND,
    _in_a(),
    SEL_B,
    {"type": "or", "fields": [SEL_B, {"type": "bound", "dimension": "dimA",
                                      "upper": "v00000004"}]},
    {"type": "and", "fields": [BOUND, {"type": "not", "field": _in_a(3)}]},
])
def test_groupby_projection_matches_reference(segs, flt, monkeypatch):
    """dimA x dimB = 6000 groups > 4096: both packages take the sorted
    projection (the reference's Pallas kernels in interpret mode, the port's
    kernels in their plain versions): B1 for the numeric filter, B2 (the
    row mask as words) where the filter names a dimension."""
    monkeypatch.setattr(ref_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(port_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(pallas_agg, "_FORCE_INTERPRET", True)
    before = (sorted_reduce.PLAIN_CALLS, megakernel.PLAIN_CALLS)
    q = {"queryType": "groupBy", "dataSource": "ds", "intervals": [IV],
         "granularity": "all", "dimensions": ["dimA", "dimB"],
         "aggregations": PROJ_AGGS, "postAggregations": POST,
         "filter": flt, "limitSpec": {"type": "default", "limit": 400,
                       "columns": [{"dimension": "lsum",
                                    "direction": "descending",
                                    "dimensionOrder": "numeric"}]}}
    want, _ = _both(segs, q)
    assert want
    calls = (sorted_reduce.PLAIN_CALLS - before[0],
             megakernel.PLAIN_CALLS - before[1])
    assert calls == ((2, 0) if flt is BOUND else (0, 2))   # one per segment


def test_force_mixed_matches_reference_projection(segs, monkeypatch):
    """FORCE_STRATEGY="mixed" keeps the port off B1; its scatter results
    still match the reference's projection (Pallas, interpret mode)."""
    monkeypatch.setattr(ref_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(port_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(port_grouping, "FORCE_STRATEGY", "mixed")
    monkeypatch.setattr(pallas_agg, "_FORCE_INTERPRET", True)
    before = sorted_reduce.PLAIN_CALLS
    q = {"queryType": "groupBy", "dataSource": "ds", "intervals": [IV],
         "granularity": "all", "dimensions": ["dimA", "dimB"],
         "aggregations": PROJ_AGGS, "filter": BOUND}
    want, _ = _both(segs, q)
    assert want and sorted_reduce.PLAIN_CALLS == before


def test_groupby_hourly_mixed_matches_reference(segs):
    q = {"queryType": "groupBy", "dataSource": "ds", "intervals": [IV],
         "granularity": "hour", "dimensions": ["dimA"],
         "aggregations": AGGS, "filter": BOUND}
    want, _ = _both(segs, q)
    assert want


def test_missing_columns_match_reference(segs):
    aggs = AGGS + [{"type": "longSum", "name": "ghostSum",
                    "fieldName": "ghost"},
                   {"type": "floatMax", "name": "ghostMax",
                    "fieldName": "ghost"}]
    q = {"queryType": "groupBy", "dataSource": "ds", "intervals": [IV],
         "granularity": "all", "dimensions": ["dimA", "nope"],
         "aggregations": aggs,
         "filter": {"type": "or", "fields": [
             {"type": "selector", "dimension": "ghost", "value": "3"},
             _in_a(4)]}}
    want, _ = _both(segs, q)
    assert want and all(r["event"]["nope"] == "" for r in want)
    q = {"queryType": "timeseries", "dataSource": "ds", "intervals": [IV],
         "granularity": "all", "aggregations": AGGS,
         "filter": {"type": "selector", "dimension": "ghost", "value": "3"}}
    _both(segs, q)


@pytest.mark.parametrize("qtype", ["timeseries", "groupBy", "topN"])
def test_empty_interval_matches_reference(segs, qtype):
    q = {"queryType": qtype, "dataSource": "ds",
         "intervals": ["2027-01-01/2027-01-02"], "granularity": "all",
         "aggregations": AGGS, "dimensions": ["dimA"], "dimension": "dimA",
         "metric": "lsum", "threshold": 5}
    want, got = _both(segs, q)
    assert want == [] and got == []


def test_generator_copy_matches_reference():
    ref = DataGenerator(SCHEMA, seed=1234).segments(
        2, 3_000, Interval.parse(IV))
    port_schema = tuple(port_generator.ColumnSpec(**vars(c)) for c in SCHEMA)
    port = port_generator.DataGenerator(port_schema, seed=1234).segments(
        2, 3_000, PortInterval.parse(IV))
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(r.time_ms, p.time_ms)
        for n in r.dims:
            np.testing.assert_array_equal(r.dims[n].ids, p.dims[n].ids)
            assert r.dims[n].dictionary.values == p.dims[n].dictionary.values
        for n in r.metrics:
            np.testing.assert_array_equal(r.metrics[n].values,
                                          p.metrics[n].values)


# ---------------------------------------------------------------------------
# the headline queries over packed staging
# ---------------------------------------------------------------------------

HEAD_IV = "2026-01-01T00:00/2026-01-01T00:04"
HEAD_SCHEMA = (       # chip_smoke.py's headline schema
    ColumnSpec("dimA", "string", cardinality=100),
    ColumnSpec("dimB", "string", cardinality=1000, distribution="zipf"),
    ColumnSpec("metLong", "long", low=0, high=10_000),
    ColumnSpec("metFloat", "float", distribution="normal", mean=100.0,
               std=25.0),
)


@pytest.fixture(scope="module")
def head_segs():
    """Two time-ordered segments of 20,000 rows over two minutes each (the
    largest gap between rows fits 8 bits, as at the headline's full size,
    so the reference plans `__time_offset` as deltas off the projection)."""
    ref = DataGenerator(HEAD_SCHEMA, seed=1234).segments(
        2, 20_000, Interval.parse(HEAD_IV), datasource="bench")
    for s in ref:
        s.metrics["absFloat"] = NumericColumn(
            np.abs(s.metrics["metFloat"].values), ValueType.FLOAT)
    return ref


def _head_queries(seg):
    """chip_smoke.py's four main-path queries (the timeseries by minute, to
    have buckets in four minutes), with |metFloat| sums beside the float
    sums for the tolerance."""
    dim_a = list(seg.dims["dimA"].dictionary.values)
    head = seg.dims["dimB"].dictionary.values[
        int(np.bincount(seg.dims["dimB"].ids).argmax())]
    bound = {"type": "bound", "dimension": "metLong", "lower": "100",
             "upper": "9900", "ordering": "numeric"}
    base = {"dataSource": "bench", "intervals": [HEAD_IV],
            "granularity": "all"}
    groupby = dict(base, queryType="groupBy", dimensions=["dimA", "dimB"],
                   aggregations=[
                       {"type": "count", "name": "rows"},
                       {"type": "longSum", "name": "lsum",
                        "fieldName": "metLong"},
                       {"type": "floatMax", "name": "fmax",
                        "fieldName": "metFloat"}], filter=bound)
    return {
        "groupby": groupby,
        "topn": dict(base, queryType="topN", dimension="dimB", metric="lsum",
                     threshold=100, aggregations=[
                         {"type": "count", "name": "rows"},
                         {"type": "longSum", "name": "lsum",
                          "fieldName": "metLong"}],
                     filter={"type": "in", "dimension": "dimA",
                             "values": dim_a[0:100:2]}),
        "timeseries": dict(base, queryType="timeseries", granularity="minute",
                           aggregations=[
                               {"type": "count", "name": "rows"},
                               {"type": "longSum", "name": "lsum",
                                "fieldName": "metLong"},
                               {"type": "floatMax", "name": "fmax",
                                "fieldName": "metFloat"},
                               {"type": "doubleSum", "name": "dsum",
                                "fieldName": "metFloat"},
                               {"type": "floatSum", "name": "fabs",
                                "fieldName": "absFloat"}]),
        "groupby_filtered": dict(groupby, filter={"type": "and", "fields": [
            {"type": "in", "dimension": "dimA", "values": dim_a[0:100:2]},
            {"type": "not", "field": {"type": "selector",
                                      "dimension": "dimB", "value": head}},
            bound]}),
    }


def _blocks(seg):
    return [v for k, v in seg.device_entries().items() if k[0] == "block"]


@pytest.mark.parametrize("name", ["groupby", "topn", "timeseries",
                                  "groupby_filtered"])
def test_headline_queries_packed_and_cascaded_match_reference(
        head_segs, name, monkeypatch):
    """Packing and cascading on in both packages (their defaults): the
    port's rows are the reference's. On the projection (B1, B2) metLong
    stages as w16 words; off it (topN, timeseries: no kernel reads words)
    every column stages dense."""
    from druid_tpu_torch.data import packed
    monkeypatch.setattr(ref_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(port_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(pallas_agg, "_FORCE_INTERPRET", True)
    assert packed.enabled()
    port = [_carry(s) for s in head_segs]
    q = _head_queries(head_segs[0])[name]
    before = (sorted_reduce.PLAIN_CALLS, megakernel.PLAIN_CALLS)
    _compare(RefExecutor(head_segs).run_json(q),
             PortExecutor(port, device="cpu").run_json(q))
    calls = (sorted_reduce.PLAIN_CALLS - before[0],
             megakernel.PLAIN_CALLS - before[1])
    assert calls == {"groupby": (2, 0), "groupby_filtered": (0, 2)} \
        .get(name, (0, 0))
    for seg in port:
        (block,) = _blocks(seg)
        met = block.arrays["metLong"]
        if name.startswith("groupby"):
            assert block.packs == (("metLong", 16, 0),)
            assert isinstance(met, packed.PackedColumn)
            assert block.resident_nbytes < block.logical_nbytes
        else:
            assert block.packs == ()
            assert block.resident_nbytes == block.logical_nbytes
        assert all(torch.is_tensor(v) for k, v in block.arrays.items()
                   if k != "metLong")


@pytest.mark.parametrize("name", ["groupby", "topn", "timeseries",
                                  "groupby_filtered"])
def test_headline_queries_same_rows_packing_on_and_off(head_segs, name,
                                                       monkeypatch):
    """The port alone, packing on against off: identical rows, floats
    included (every decode is exact)."""
    from druid_tpu_torch.data import packed
    monkeypatch.setattr(port_grouping, "PROJECTION_MIN_ROWS", 0)
    q = _head_queries(head_segs[0])[name]
    on = PortExecutor([_carry(s) for s in head_segs],
                      device="cpu").run_json(q)
    prev = packed.set_enabled(False)
    try:
        port = [_carry(s) for s in head_segs]
        off = PortExecutor(port, device="cpu").run_json(q)
    finally:
        packed.set_enabled(prev)
    assert all(torch.is_tensor(v) for seg in port
               for b in _blocks(seg) for v in b.arrays.values())
    assert on and on == off

