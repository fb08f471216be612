"""The port's filtered aggregator (FilteredKernel) against the reference
package.

(a) Each delegate type under a bitmap-eligible filter, through both
    `QueryExecutor`s, with the filter fused (megakernel on), staged as
    combined words (megakernel off) and planned without bitmap nodes (device
    bitmaps off): counts, long sums, min/max, first/last and HLL estimates
    exact, float sums within 1e-5 * sum|v| per row.
(b) A query filter and filtered aggregators on the same dimension with other
    values (their bitmap words would collide under one slot), against the
    reference and numpy; every bitmap node of an execution gets its own
    slot. Filtered of filtered, and a filter on a missing column.
(c) The run domain: `_plan_run_domain` refuses exactly where the reference
    refuses, and where both plan, every run kernel's signature (`rfiltered(
    ...)`) and the partition equal the reference's; the rows equal the
    reference's and the row program's, bit for bit.
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data import cascade as ref_cascade
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.data.segment import NumericColumn, ValueType
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.engine import filters as ref_filters
from druid_tpu.engine import grouping as ref_grouping
from druid_tpu.engine import kernels as ref_kernels
from druid_tpu.engine import megakernel as ref_megakernel
from druid_tpu.query import aggregators as RA
from druid_tpu.utils.granularity import Granularity as RefGranularity
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.data import cascade as port_cascade
from druid_tpu_torch.data.devicepool import device_pool
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import batching as port_batching
from druid_tpu_torch.engine import filters as port_filters
from druid_tpu_torch.engine import grouping as port_grouping
from druid_tpu_torch.engine import kernels as port_kernels
from druid_tpu_torch.engine import megakernel as port_megakernel
from druid_tpu_torch.engine import rundomain
from druid_tpu_torch.query import aggregators as PA
from druid_tpu_torch.query import filters as PF
from druid_tpu_torch.utils.granularity import Granularity as PortGranularity
from druid_tpu_torch.utils.intervals import Interval as PortInterval
from tests.test_torch_run_domain import _exact, _hits, _pair, _rollup, _run
from tests.test_torch_slice import _carry, _compare

# One intra-op thread: these tensors are small, and an OpenMP pool in every
# test worker would compete for cores with the suite's timing tests.
torch.set_num_threads(1)

IV = "2026-07-01/2026-07-02"
SCHEMA = (
    ColumnSpec("dimA", "string", cardinality=16),
    ColumnSpec("dimB", "string", cardinality=250, distribution="zipf"),
    ColumnSpec("metLong", "long", low=-800, high=6_000),
    ColumnSpec("metFloat", "float", distribution="normal", mean=5.0,
               std=300.0),
)


@pytest.fixture(scope="module")
def segs():
    ref = DataGenerator(SCHEMA, seed=41).segments(
        2, 8_000, Interval.parse(IV), datasource="ds")
    for s in ref:
        s.metrics["absFloat"] = NumericColumn(
            np.abs(s.metrics["metFloat"].values), ValueType.FLOAT)
    return ref, [_carry(s) for s in ref]


def _vals(segs, dim, idx):
    return [segs[0][0].dims[dim].dictionary.values[i] for i in idx]


MODES = {"fused": (True, True), "staged": (False, True),
         "rows": (True, False)}


@pytest.fixture
def mode(request, monkeypatch):
    """(megakernel, device bitmaps) in both packages; a fresh device cache,
    so the fused run does not meet a staged run's combined words."""
    mega, bitmap = MODES[request.param]
    # the fused mode is the per-segment megakernel path, which batching
    # bypasses for these shape-compatible segments
    monkeypatch.setattr(port_batching, "_ENABLED", False)
    for mk, fl in ((ref_megakernel, ref_filters),
                   (port_megakernel, port_filters)):
        monkeypatch.setattr(mk, "_ENABLED", mega)
        monkeypatch.setattr(fl, "_DEVICE_BITMAP", bitmap)
    return request.param


def _both(segs, q):
    ref, port = segs
    device_pool().clear()
    want = RefExecutor(ref).run_json(q)
    got = PortExecutor(port, device="cpu").run_json(q)
    _compare(want, got)
    return want, got


DELEGATES = {
    "count": {"type": "count"},
    "longSum": {"type": "longSum", "fieldName": "metLong"},
    "doubleSum": {"type": "doubleSum", "fieldName": "metFloat"},
    "floatSum": {"type": "floatSum", "fieldName": "metFloat"},
    "longMin": {"type": "longMin", "fieldName": "metLong"},
    "longMax": {"type": "longMax", "fieldName": "metLong"},
    "doubleMin": {"type": "doubleMin", "fieldName": "metFloat"},
    "floatMax": {"type": "floatMax", "fieldName": "metFloat"},
    "longFirst": {"type": "longFirst", "fieldName": "metLong"},
    "floatLast": {"type": "floatLast", "fieldName": "metFloat"},
    "cardinality": {"type": "cardinality", "fields": ["dimB"]},
    "hyperUnique": {"type": "hyperUnique", "fieldName": "metLong"},
}
#: the names test_torch_slice._compare holds to the float-sum tolerance
SUM_NAMES = {"doubleSum": "dsum", "floatSum": "fsum"}


@pytest.mark.parametrize("mode", sorted(MODES), indirect=True)
@pytest.mark.parametrize("delegate", sorted(DELEGATES))
def test_each_delegate_matches_reference(segs, delegate, mode):
    flt = {"type": "and", "fields": [
        {"type": "in", "dimension": "dimA",
         "values": _vals(segs, "dimA", range(0, 16, 3))},
        {"type": "not", "field": {"type": "selector", "dimension": "dimB",
                                  "value": _vals(segs, "dimB", [0])[0]}}]}
    name = SUM_NAMES.get(delegate, "v")
    aggs = [{"type": "count", "name": "rows"},
            {"type": "filtered", "filter": flt,
             "aggregator": dict(DELEGATES[delegate], name=name)},
            {"type": "filtered", "filter": flt, "aggregator": {
                "type": "floatSum", "name": "fabs", "fieldName": "absFloat"}}]
    hits = port_megakernel.stats().snapshot()["hits"]
    for q in ({"queryType": "timeseries", "granularity": "hour"},
              {"queryType": "groupBy", "granularity": "all",
               "dimensions": ["dimA"]}):
        q = dict(q, dataSource="ds", intervals=[IV], aggregations=aggs)
        want, _ = _both(segs, q)
        assert want
    fused = port_megakernel.stats().snapshot()["hits"] - hits
    assert (fused > 0) == (mode == "fused")


def _numpy_counts(segs, dim_a_sets):
    """Rows per dimA value passing each set of dimA values, over both
    segments, and the rows of the query filter."""
    out = []
    for keep in dim_a_sets:
        n = 0
        for s in segs[0]:
            vals = np.asarray(s.dims["dimA"].dictionary.values)
            n += int(np.isin(vals[s.dims["dimA"].ids], keep).sum())
        out.append(n)
    return out


@pytest.mark.parametrize("mode", sorted(MODES), indirect=True)
def test_slots_do_not_collide(segs, mode):
    """A query filter on dimA and filtered aggregators on dimA with other
    values: each tree keeps its own words."""
    qf = _vals(segs, "dimA", [1, 2, 3, 4])
    f1 = _vals(segs, "dimA", [2])
    f2 = _vals(segs, "dimA", [3, 9])
    aggs = [{"type": "count", "name": "rows"},
            {"type": "filtered", "name": "one", "aggregator": {
                "type": "count", "name": "x"},
             "filter": {"type": "selector", "dimension": "dimA",
                        "value": f1[0]}},
            {"type": "filtered", "name": "two", "aggregator": {
                "type": "longSum", "name": "y", "fieldName": "metLong"},
             "filter": {"type": "not", "field": {
                 "type": "in", "dimension": "dimA", "values": f2}}},
            {"type": "filtered", "name": "three", "aggregator": {
                "type": "count", "name": "z"},
             "filter": {"type": "in", "dimension": "dimA", "values": f2}}]
    q = {"queryType": "timeseries", "dataSource": "ds", "intervals": [IV],
         "granularity": "all", "aggregations": aggs,
         "filter": {"type": "in", "dimension": "dimA", "values": qf}}
    want, got = _both(segs, q)
    rows, one, three = _numpy_counts(segs, [qf, f1, sorted(set(f2) & set(qf))])
    res = got[0]["result"]
    assert (res["rows"], res["one"], res["three"]) == (rows, one, three)
    # every bitmap node of the execution has its own slot and names
    seg = segs[1][0]
    flt = port_filters.plan_filter(PF.filter_from_json(q["filter"]), seg,
                                   device_bitmap=True)
    kernels = [port_kernels.make_kernel(PA.agg_from_json(a), seg,
                                        device_bitmap=True) for a in aggs]
    n = port_filters.assign_bitmap_slots(flt, kernels)
    nodes = port_filters.item_bitmap_nodes(flt, kernels)
    assert n == len(nodes) == 4
    assert sorted(nd.slot for nd in nodes) == [0, 1, 2, 3]
    assert len({nd.col for nd in nodes}) == 4


@pytest.mark.parametrize("mode", sorted(MODES), indirect=True)
def test_filtered_of_filtered_and_missing_columns(segs, mode):
    inner = {"type": "filtered", "name": "s", "aggregator": {
        "type": "longSum", "name": "s", "fieldName": "metLong"},
        "filter": {"type": "in", "dimension": "dimA",
                   "values": _vals(segs, "dimA", range(8))}}
    aggs = [{"type": "count", "name": "rows"},
            {"type": "filtered", "aggregator": inner, "filter": {
                "type": "bound", "dimension": "metLong", "lower": "100",
                "ordering": "numeric"}},
            {"type": "filtered", "name": "gone", "aggregator": {
                "type": "count", "name": "g"},
             "filter": {"type": "selector", "dimension": "nope",
                        "value": "x"}},
            {"type": "filtered", "name": "all_null", "aggregator": {
                "type": "longMax", "name": "m", "fieldName": "metLong"},
             "filter": {"type": "selector", "dimension": "nope",
                        "value": None}},
            {"type": "filtered", "name": "no_metric", "aggregator": {
                "type": "count", "name": "k"},
             "filter": {"type": "bound", "dimension": "noMetric",
                        "upper": "5", "ordering": "numeric"}}]
    q = {"queryType": "groupBy", "dataSource": "ds", "intervals": [IV],
         "granularity": "hour", "dimensions": ["dimB"],
         "aggregations": aggs}
    want, _ = _both(segs, q)
    assert all(r["event"]["gone"] == 0 for r in want)


def test_filtered_topn_ordered_by_its_metric(segs):
    q = {"queryType": "topN", "dataSource": "ds", "intervals": [IV],
         "granularity": "all", "dimension": "dimB", "metric": "fs",
         "threshold": 15, "aggregations": [
             {"type": "filtered", "aggregator": {
                 "type": "longSum", "name": "fs", "fieldName": "metLong"},
              "filter": {"type": "in", "dimension": "dimA",
                         "values": _vals(segs, "dimA", [0, 5])}}]}
    assert _both(segs, q)[0]


# ---------------------------------------------------------------------------
# (c) the run domain
# ---------------------------------------------------------------------------

IN_D1 = {"type": "in", "dimension": "d1", "values": ["d1_001", "d1_003",
                                                      "d1_004"]}
BOUND_M0 = {"type": "bound", "dimension": "m0", "lower": "2", "upper": "9",
            "ordering": "numeric"}
NOT_OR = {"type": "not", "field": {"type": "or", "fields": [
    {"type": "selector", "dimension": "d0", "value": "d0_001"},
    {"type": "selector", "dimension": "m1", "value": "3"}]}}


def _f(agg, flt, name=None):
    out = {"type": "filtered", "aggregator": agg, "filter": flt}
    if name:
        out["name"] = name
    return out


COUNT = {"type": "count", "name": "n"}
LSUM = {"type": "longSum", "name": "s", "fieldName": "m0"}
#: aggregator mixes for the plan grid (JSON, so both packages parse them)
RUN_MIXES = {
    "count_in": [COUNT, _f(COUNT, IN_D1, "fn")],
    "sum_bound": [_f(LSUM, BOUND_M0)],
    "min_not_or": [_f({"type": "longMin", "name": "lm",
                       "fieldName": "m1"}, NOT_OR)],
    "const_in": [_f({"type": "longSum", "name": "c", "fieldName": "cnt"},
                    IN_D1)],
    "nested": [_f(_f(LSUM, IN_D1), BOUND_M0, "ns")],
    "missing_col": [_f(COUNT, {"type": "selector", "dimension": "nope",
                               "value": "x"}, "mc")],
    "missing_null": [_f(COUNT, {"type": "selector", "dimension": "nope",
                                "value": None}, "mn")],
    # refused: row-space filters, float sums, first/last, HLL
    "time": [_f(COUNT, {"type": "interval", "dimension": "__time",
                        "intervals": ["2026-01-01T00:00/2026-01-01T02:00"]},
                "ft")],
    "expression": [_f(COUNT, {"type": "expression",
                              "expression": "m0 > 3"}, "fe")],
    "double_sum": [_f({"type": "doubleSum", "name": "d", "fieldName": "f"},
                      IN_D1)],
    "first": [_f({"type": "longFirst", "name": "lf", "fieldName": "m0"},
                 IN_D1)],
    "hll": [_f({"type": "cardinality", "name": "h", "fields": ["d0"]},
               IN_D1)],
    "noise": [_f(COUNT, {"type": "bound", "dimension": "noise",
                         "upper": "250", "ordering": "numeric"}, "fz")],
}
RUN_SHAPES = [((), "all"), (("d0",), "all"), (("d1",), "hour"),
              (("d0", "d1"), "all")]
DAY = "2026-01-01/2026-01-02"


def _ref_plan(seg, dims, gran, aggs):
    g = RefGranularity.of(gran)
    ivs = [Interval.parse(DAY)]
    spec = ref_grouping.make_group_spec(
        seg, ivs, g, [ref_grouping.KeyDim(d, seg.dims[d].cardinality, None)
                      for d in dims])
    kernels = [ref_kernels.make_kernel(RA.agg_from_json(a), seg)
               for a in aggs]
    return ref_cascade._plan_run_domain(seg, ivs, g, spec, kernels, None, [])


def _port_plan(seg, dims, gran, aggs):
    g = PortGranularity.of(gran)
    ivs = [PortInterval.parse(DAY)]
    spec = port_grouping.make_group_spec(
        seg, ivs, g, [port_grouping.KeyDim(d, seg.dims[d].cardinality)
                      for d in dims])
    kernels = [port_kernels.make_kernel(PA.agg_from_json(a), seg)
               for a in aggs]
    return rundomain._plan_run_domain(seg, ivs, g, spec, kernels, None)


REFUSED = {"time", "expression", "double_sum", "first", "hll"}


@pytest.mark.parametrize("order", ["rollup", "hour", "unsorted"])
def test_run_plan_matches_reference(order):
    ref = _rollup(1, hours=4 if order == "hour" else 1, seed=11,
                  order="unsorted" if order == "unsorted" else "rollup")[0]
    port = _carry(ref)
    planned = set()
    for dims, gran in RUN_SHAPES:
        for mix, aggs in RUN_MIXES.items():
            want = _ref_plan(ref, dims, gran, aggs)
            got = _port_plan(port, dims, gran, aggs)
            where = (order, dims, gran, mix)
            assert (got is None) == (want is None), where
            if want is None:
                continue
            assert mix not in REFUSED, where
            planned.add(mix)
            _, rkernels, pkey, bucket, (starts, lengths, nr) = got
            assert [rk.sig() for rk in rkernels] \
                == [rk.sig() for rk in want[3]], where
            assert pkey == want[4] and bucket == want[5], where
            assert nr == want[6][2] and np.array_equal(starts, want[6][0]) \
                and np.array_equal(lengths, want[6][1]), where
    if order != "unsorted":
        assert {"count_in", "sum_bound", "nested"} <= planned


def test_run_signature_names_the_filter():
    ref = _rollup(1, seed=12)[0]
    got = _port_plan(_carry(ref), ("d0",), "all", RUN_MIXES["nested"])
    want = _ref_plan(ref, ("d0",), "all", RUN_MIXES["nested"])
    sig = got[1][0].sig()
    assert sig == want[3][0].sig()
    assert sig.startswith("rfiltered(numcmp(m0,") \
        and "rfiltered(lut(d1),sum(m0," in sig


@pytest.fixture(scope="module")
def hour_ordered():
    return _pair(_rollup(hours=4, seed=13))


@pytest.mark.parametrize("gran", ["all", "hour"])
def test_run_domain_rows_match_reference(hour_ordered, gran):
    ref, port = hour_ordered
    aggs = (RUN_MIXES["count_in"] + RUN_MIXES["sum_bound"]
            + RUN_MIXES["min_not_or"] + RUN_MIXES["const_in"]
            + RUN_MIXES["nested"] + RUN_MIXES["missing_col"])
    for q in ({"queryType": "timeseries"},
              {"queryType": "groupBy", "dimensions": ["d0"],
               "filter": {"type": "not", "field": {
                   "type": "selector", "dimension": "d1",
                   "value": "d1_002"}}},
              {"queryType": "topN", "dimension": "d1", "metric": "s",
               "threshold": 3}):
        q = dict(q, dataSource="rd", intervals=[DAY], granularity=gran,
                 aggregations=aggs)
        stats = (ref_cascade.code_domain_stats(),
                 port_cascade.code_domain_stats())
        before = [_hits(s) for s in stats]
        want = RefExecutor(ref).run_json(q)
        got = _run(port, q)
        assert [_hits(s) - b for s, b in zip(stats, before)] \
            == [len(ref), len(port)]
        assert want and _exact(got) == _exact(want)
        assert _exact(_run(port, q, run_domain=False)) == _exact(want)


def test_run_domain_refuses_where_the_reference_does(hour_ordered):
    ref, port = hour_ordered
    for mix in sorted(REFUSED):
        q = {"queryType": "timeseries", "dataSource": "rd",
             "intervals": [DAY], "granularity": "all",
             "aggregations": RUN_MIXES[mix]}
        stats = (ref_cascade.code_domain_stats(),
                 port_cascade.code_domain_stats())
        before = [_hits(s) for s in stats]
        want = RefExecutor(ref).run_json(q)
        got = _run(port, q)
        assert [_hits(s) - b for s, b in zip(stats, before)] == [0, 0], mix
        _compare(want, got)
