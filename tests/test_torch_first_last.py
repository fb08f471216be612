"""The port's first/last aggregators (FirstLastKernel) against the reference
package, through both `QueryExecutor`s: values exact and of the same type.

Each kind (long, double, float) x first/last over a LONG, a FLOAT and a
DOUBLE column;
ties within a segment (the lowest row index at the best time wins) and across
segments (the earlier partial wins on equal times, so partials merge in the
segments' order); rolled-up segments whose hidden `__ft_<field>` pair column
(from the reference's IncrementalIndex) orders the rows by event time;
groups and buckets without a value (a filtered first, timeseries empty
buckets); a missing field; and a topN ordered by a last metric.
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.dictionary import Dictionary
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.data.segment import (NumericColumn, Segment, SegmentId,
                                    StringDimColumn, ValueType)
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.ingest import IncrementalIndex
from druid_tpu.query.aggregators import (CountAggregator, FirstAggregator,
                                         LastAggregator)
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from tests.test_torch_slice import _carry, _compare

# One intra-op thread: these tensors are small, and an OpenMP pool in every
# test worker would compete for cores with the suite's timing tests.
torch.set_num_threads(1)

IV = "2026-07-01/2026-07-02"
SCHEMA = (
    ColumnSpec("dimA", "string", cardinality=8),
    ColumnSpec("dimB", "string", cardinality=200, distribution="zipf"),
    ColumnSpec("metLong", "long", low=-5_000, high=5_000),
    ColumnSpec("metFloat", "float", distribution="normal", mean=3.0,
               std=90.0),
    ColumnSpec("metDouble", "double", distribution="normal", mean=0.0,
               std=1e6),
)
KINDS = [(kind, fl, field) for kind in ("long", "double", "float")
         for fl in ("First", "Last")
         for field in ("metLong", "metFloat", "metDouble")]


def _both(ref_segs, port_segs, q):
    want = RefExecutor(ref_segs).run_json(q)
    got = PortExecutor(port_segs, device="cpu").run_json(q)
    _compare(want, got)
    return want


@pytest.fixture(scope="module")
def segs():
    """Three segments with coarse times (many rows share an instant, so the
    tie rule decides), in time order and shuffled."""
    gen = DataGenerator(SCHEMA, seed=31)
    iv = Interval.parse(IV)
    rng = np.random.default_rng(3)
    ref = []
    for p in range(3):
        s = gen.segment(5_000, iv, datasource="ds")
        # 40 instants, shared across the segments
        t = iv.start + rng.integers(0, 40, s.n_rows) * 1_800_000
        if p == 1:
            t.sort()
        ref.append(Segment(SegmentId("ds", iv, "v1", p), t, s.dims,
                           s.metrics))
    return ref, [_carry(s) for s in ref]


@pytest.mark.parametrize("kind,fl,field", KINDS)
def test_first_last_matches_reference(segs, kind, fl, field):
    agg = {"type": f"{kind}{fl}", "name": "v", "fieldName": field}
    aggs = [{"type": "count", "name": "rows"}, agg]
    for q in (
            {"queryType": "timeseries", "granularity": "all"},
            {"queryType": "timeseries", "granularity": "hour"},
            {"queryType": "groupBy", "granularity": "all",
             "dimensions": ["dimA", "dimB"]},
            {"queryType": "groupBy", "granularity": "hour",
             "dimensions": ["dimA"], "filter": {
                 "type": "bound", "dimension": "metLong", "lower": "0",
                 "ordering": "numeric"}}):
        q = dict(q, dataSource="ds", intervals=[IV], aggregations=aggs)
        assert _both(*segs, q)


def _tie_segments():
    """Rows at a handful of instants: within each segment several rows of a
    group share the best time with different values; across the segments
    the same instants carry different values."""
    iv = Interval.parse(IV)
    out = []
    for p, vals in enumerate(([5, 1, 9, 4, 7, 2], [3, 8, 6, 0, 11, 10])):
        t = iv.start + np.asarray([60_000, 0, 0, 60_000, 60_000, 0],
                                  dtype=np.int64)
        out.append(Segment(
            SegmentId("tie", iv, "v1", p), t,
            {"g": StringDimColumn(np.zeros(6, np.int32), Dictionary(["a"]))},
            {"v": NumericColumn(np.asarray(vals, np.int64), ValueType.LONG),
             "f": NumericColumn(np.asarray(vals, np.float32) / 4,
                                ValueType.FLOAT)}))
    return out


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_ties_within_and_across_segments(order):
    ref = [_tie_segments()[i] for i in order]
    port = [_carry(s) for s in ref]
    aggs = [{"type": "longFirst", "name": "lf", "fieldName": "v"},
            {"type": "longLast", "name": "ll", "fieldName": "v"},
            {"type": "floatFirst", "name": "ff", "fieldName": "f"},
            {"type": "doubleLast", "name": "dl", "fieldName": "f"}]
    q = {"queryType": "timeseries", "dataSource": "tie", "intervals": [IV],
         "granularity": "all", "aggregations": aggs}
    got = _both(ref, port, q)[0]["result"]
    # the lowest row index at the best time, in the first segment given
    first_seg = ref[0].metrics["v"].values
    assert got["lf"] == int(first_seg[1])
    assert got["ll"] == int(first_seg[0])
    # each segment alone
    for s, p in zip(ref, port):
        _both([s], [p], q)


def _rollup_pairs(n_seg=3):
    """Rolled-up segments (hour granularity) of the reference's
    IncrementalIndex: first/last metrics with their `__ft_` pair columns."""
    specs = [CountAggregator("count"),
             FirstAggregator("fv", "val", "long"),
             LastAggregator("lv", "val", "long"),
             FirstAggregator("ff", "fval", "float"),
             LastAggregator("ld", "fval", "double")]
    iv = Interval.parse(IV)
    rng = np.random.default_rng(9)
    out = []
    for p in range(n_seg):
        idx = IncrementalIndex("fl", iv, specs, dimensions=["d"],
                               query_granularity="hour")
        for i in range(600):
            t = iv.start + int(rng.integers(0, 86_400_000))
            idx.add({"timestamp": t, "d": f"g{i % 5}",
                     "val": int(rng.integers(-1000, 1000)),
                     "fval": float(rng.normal(0, 10))})
        out.append(idx.to_segment(partition=p))
    return out


def test_pair_columns_from_rollup_order_by_event_time():
    ref = _rollup_pairs()
    assert "__ft_fv" in ref[0].metrics
    port = [_carry(s) for s in ref]
    aggs = [{"type": "longFirst", "name": "f", "fieldName": "fv"},
            {"type": "longLast", "name": "l", "fieldName": "lv"},
            {"type": "floatFirst", "name": "ff", "fieldName": "ff"},
            {"type": "doubleLast", "name": "ld", "fieldName": "ld"},
            {"type": "longSum", "name": "n", "fieldName": "count"}]
    for q in ({"queryType": "timeseries", "granularity": "all"},
              {"queryType": "timeseries", "granularity": "six_hour"},
              {"queryType": "groupBy", "granularity": "all",
               "dimensions": ["d"]}):
        q = dict(q, dataSource="fl", intervals=[IV], aggregations=aggs)
        assert _both(ref, port, q)


def test_groups_and_buckets_without_a_value(segs):
    ref, port = segs
    # a filtered first: groups whose rows all fail the filter have none
    aggs = [{"type": "count", "name": "rows"},
            {"type": "filtered", "aggregator": {
                "type": "longFirst", "name": "lf", "fieldName": "metLong"},
             "filter": {"type": "selector", "dimension": "dimA",
                        "value": ref[0].dims["dimA"].dictionary.values[2]}},
            {"type": "floatLast", "name": "nope", "fieldName": "missing"}]
    q = {"queryType": "groupBy", "dataSource": "ds", "intervals": [IV],
         "granularity": "all", "dimensions": ["dimA"], "aggregations": aggs}
    rows = _both(ref, port, q)
    assert sum(r["event"]["lf"] == 0 for r in rows) >= len(rows) - 1
    assert all(r["event"]["nope"] == 0.0 for r in rows)
    # timeseries at minute granularity: most buckets are empty
    q = {"queryType": "timeseries", "dataSource": "ds", "intervals": [IV],
         "granularity": "minute", "aggregations": [
             {"type": "doubleLast", "name": "dl", "fieldName": "metDouble"},
             {"type": "longFirst", "name": "lf", "fieldName": "metLong"}]}
    rows = _both(ref, port, q)
    assert any(r["result"]["dl"] == 0.0 for r in rows)
    q["skipEmptyBuckets"] = True
    assert _both(ref, port, q)


@pytest.mark.parametrize("metric", ["last", "first"])
def test_topn_ordered_by_a_first_or_last_metric(segs, metric):
    q = {"queryType": "topN", "dataSource": "ds", "intervals": [IV],
         "granularity": "all", "dimension": "dimB", "metric": metric,
         "threshold": 12, "aggregations": [
             {"type": "count", "name": "rows"},
             {"type": "floatLast", "name": "last", "fieldName": "metFloat"},
             {"type": "longFirst", "name": "first", "fieldName": "metLong"}]}
    rows = _both(*segs, q)
    vals = [r[metric] for r in rows[0]["result"]]
    assert vals == sorted(vals, reverse=True)


def test_groupby_limit_ordered_by_a_last_metric(segs):
    q = {"queryType": "groupBy", "dataSource": "ds", "intervals": [IV],
         "granularity": "all", "dimensions": ["dimB"], "aggregations": [
             {"type": "doubleLast", "name": "dl", "fieldName": "metDouble"}],
         "limitSpec": {"type": "default", "limit": 9, "columns": [
             {"dimension": "dl", "direction": "ascending"}]}}
    assert len(_both(*segs, q)) == 9
