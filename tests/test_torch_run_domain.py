"""The port's code-domain aggregation and run-table filter leaves against the
reference package.

(a) Queries over rollup-order segments (rows sorted by dimension within an
    hour, run-aligned metrics, a constant `cnt`): groupBy, timeseries and
    topN at granularity all and hour. The port equals the reference, row for
    row and bit for bit (floats included, the reference's own bar in
    tests/test_cascade.py), and equals its own row program under
    `set_run_domain_enabled(False)`.
(b) Plan parity: over a grid of segments (sorted, hour-ordered, unsorted),
    granularities, intervals, aggregators and filters, and joint run counts
    just under and over CASCADE_MAX_RUNS and n_rows / 16, the port's
    `_plan_run_domain` is None exactly where the reference's is; where both
    plan, the partitions are equal.
(c) `column_run_info` and `_run_leaf_payload` equal the reference's.
(d) The staged fill from a run leaf and the run-built mega leaves give the
    row-built words bit for bit, and queries through them (megakernel off
    and on) equal the reference.
(e) A constant LONG sum never stages its column and equals the reference.
(f) `code_domain_stats` counts one hit and the rows of each segment served.
The reference runs as its own tests run it, with JAX on the CPU.
"""
import json

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data import cascade as ref_cascade
from druid_tpu.data.dictionary import Dictionary as RefDictionary
from druid_tpu.data.segment import NumericColumn as RefNumericColumn
from druid_tpu.data.segment import Segment as RefSegment
from druid_tpu.data.segment import SegmentId as RefSegmentId
from druid_tpu.data.segment import StringDimColumn as RefStringDimColumn
from druid_tpu.data.segment import ValueType as RefValueType
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.engine import filters as ref_filters
from druid_tpu.engine import grouping as ref_grouping
from druid_tpu.engine import kernels as ref_kernels
from druid_tpu.engine import megakernel as ref_megakernel
from druid_tpu.query import aggregators as RA
from druid_tpu.query import filters as RF
from druid_tpu.utils.granularity import Granularity as RefGranularity
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.data import cascade as port_cascade
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import batching as port_batching
from druid_tpu_torch.engine import filters as port_filters
from druid_tpu_torch.engine import grouping as port_grouping
from druid_tpu_torch.engine import kernels as port_kernels
from druid_tpu_torch.engine import megakernel as port_megakernel
from druid_tpu_torch.engine import rundomain
from druid_tpu_torch.engine.contracts import CASCADE_MAX_RUNS
from druid_tpu_torch.query import aggregators as PA
from druid_tpu_torch.query import filters as PF
from druid_tpu_torch.utils.granularity import Granularity as PortGranularity
from druid_tpu_torch.utils.intervals import Interval as PortInterval
from tests.test_torch_slice import _carry

# One intra-op thread: these tensors are small, and an OpenMP pool in every
# test worker would compete for cores with the suite's timing tests.
torch.set_num_threads(1)

DAY = "2026-01-01/2026-01-02"
HOUR_MS = 3_600_000


def _segment(time_ms, dims, mets, partition=0):
    """A reference Segment from arrays: dims name -> ids (dictionary
    f"{name}_{id:03d}"), mets name -> (value type, values)."""
    iv = Interval.parse(DAY)
    dim_cols = {n: RefStringDimColumn(
        ids.astype(np.int32),
        RefDictionary([f"{n}_{j:03d}" for j in range(int(ids.max()) + 1)]))
        for n, ids in dims.items()}
    met_cols = {n: RefNumericColumn(v, RefValueType(t))
                for n, (t, v) in mets.items()}
    return RefSegment(RefSegmentId("rd", iv, "v1", partition),
                      np.asarray(time_ms, dtype=np.int64), dim_cols,
                      met_cols, sorted_by_time=True, time_ordered=False)


def _rollup(n_seg=2, rows=4096, hours=1, order="rollup", nan=False, seed=0,
            spread=True):
    """Rollup-shaped segments: d0 (card 8) and d1 (card 6) sorted within an
    hour bucket (`order="rollup"`), or rows shuffled ("unsorted"); metrics
    constant within a (d0, d1) run: m0 (from d0), m1 (negative, from d0 and
    d1), wide (int64, sums wrap), f (float32; with `nan`, NaN on the first
    row of (d0, d1) = (2, 1): NaN != NaN, so each NaN row is a run of its
    own);
    cnt constant 1; noise row-random. `spread=False` keeps every row within
    the first second (the reference's rollup_segments time)."""
    rng = np.random.default_rng(seed)
    t0 = Interval.parse(DAY).start
    out = []
    for si in range(n_seg):
        hour = rng.integers(0, hours, rows)
        d0 = rng.integers(0, 8, rows)
        d1 = rng.integers(0, 6, rows)
        if order == "rollup":
            o = np.lexsort((d1, d0, hour))
        else:
            o = rng.permutation(rows)
        hour, d0, d1 = hour[o], d0[o], d1[o]
        t = t0 + hour * HOUR_MS + (rng.integers(0, HOUR_MS, rows) if spread
                                   else np.arange(rows) // 64)
        f = (d0 * 0.5 - 1.25).astype(np.float32)
        if nan:
            f[np.flatnonzero((d0 == 2) & (d1 == 1))[0]] = np.nan
        mets = {"cnt": ("long", np.ones(rows, dtype=np.int64)),
                "m0": ("long", ((d0 * 7) % 13).astype(np.int64)),
                "m1": ("long", ((d0 * 5 + d1) % 11 - 5).astype(np.int64)),
                "wide": ("long", ((d0 % 3) + 1).astype(np.int64) << 61),
                "f": ("float", f),
                "noise": ("long", rng.integers(0, 500, rows)
                          .astype(np.int64))}
        out.append(_segment(t, {"d0": d0, "d1": d1}, mets, si))
    return out


def _pair(ref):
    return ref, [_carry(s) for s in ref]


def _exact(rows):
    """Rows as one string: equal strings mean equal rows, value types and
    float bits (NaN included)."""
    return json.dumps(rows, sort_keys=True)


def _run(segs, q, run_domain=True):
    prev = port_cascade.set_run_domain_enabled(run_domain)
    try:
        return PortExecutor(segs, device="cpu").run_json(q)
    finally:
        port_cascade.set_run_domain_enabled(prev)


def _hits(stats):
    return stats.snapshot()["hits"]


# ---------------------------------------------------------------------------
# (a) query parity
# ---------------------------------------------------------------------------

IN_D1 = {"type": "in", "dimension": "d1", "values": ["d1_001", "d1_003",
                                                      "d1_004"]}
RUN_AGGS = [{"type": "count", "name": "n"},
            {"type": "longSum", "name": "c", "fieldName": "cnt"},
            {"type": "longSum", "name": "s", "fieldName": "m0"},
            {"type": "longMin", "name": "lm", "fieldName": "m1"},
            {"type": "longMax", "name": "lx", "fieldName": "m1"},
            {"type": "longSum", "name": "w", "fieldName": "wide"},
            {"type": "floatMax", "name": "fx", "fieldName": "f"},
            {"type": "doubleMin", "name": "dn", "fieldName": "f"},
            {"type": "longSum", "name": "z", "fieldName": "nope"},
            {"type": "longMax", "name": "zx", "fieldName": "nope"}]


def _queries(gran):
    groupby = {"queryType": "groupBy", "dataSource": "rd",
               "intervals": [DAY], "granularity": gran,
               "dimensions": ["d0"], "aggregations": RUN_AGGS,
               "filter": IN_D1}
    timeseries = {"queryType": "timeseries", "dataSource": "rd",
                  "intervals": [DAY], "granularity": gran,
                  "aggregations": RUN_AGGS[:6],
                  "filter": {"type": "bound", "dimension": "m0",
                             "lower": "2", "upper": "9",
                             "ordering": "numeric"}}
    topn = {"queryType": "topN", "dataSource": "rd", "intervals": [DAY],
            "granularity": gran, "dimension": "d1", "metric": "s",
            "threshold": 4, "aggregations": RUN_AGGS[:4],
            "filter": {"type": "not", "field": {
                "type": "selector", "dimension": "d0", "value": "d0_005"}}}
    return {"groupby": groupby, "timeseries": timeseries, "topn": topn}


@pytest.fixture(scope="module")
def hour_ordered():
    """Rows ordered by (hour, d0, d1) over 4 hours, with a NaN float run."""
    return _pair(_rollup(hours=4, nan=True, seed=1))


@pytest.mark.parametrize("name", ["groupby", "timeseries", "topn"])
@pytest.mark.parametrize("gran", ["all", "hour"])
def test_queries_match_reference_and_row_program(hour_ordered, gran, name):
    ref, port = hour_ordered
    q = _queries(gran)[name]
    ref_stats, port_stats = (ref_cascade.code_domain_stats(),
                             port_cascade.code_domain_stats())
    r0, p0 = _hits(ref_stats), _hits(port_stats)
    want = RefExecutor(ref).run_json(q)
    got = _run(port, q)
    # both packages served every segment in run space
    assert _hits(ref_stats) - r0 == len(ref)
    assert _hits(port_stats) - p0 == len(port)
    assert want and _exact(got) == _exact(want)
    rows = _run(port, q, run_domain=False)
    assert _hits(port_stats) - p0 == len(port)
    assert _exact(rows) == _exact(want)


def test_wrapping_long_sum_and_nan_runs():
    """`wide` sums past 2^63 (the int64 wrap of the row path) and `f` holds
    a NaN run: run space gives the reference's bits."""
    ref, port = _pair(_rollup(n_seg=1, nan=True, seed=2))
    q = _queries("all")["groupby"]
    want = RefExecutor(ref).run_json(q)
    got = _run(port, q)
    assert _exact(got) == _exact(want)
    ws = [r["event"]["w"] for r in got]
    assert any(w < 0 for w in ws)         # wrapped
    assert any(np.isnan(r["event"]["fx"]) for r in got)


def test_query_partials_say_run_domain(hour_ordered):
    from druid_tpu_torch.engine import engines
    from druid_tpu_torch.query.model import query_from_json
    _, port = hour_ordered
    ap = engines.make_aggregate_partials(
        query_from_json(_queries("hour")["groupby"]), port,
        torch.device("cpu"))
    assert [p.spec.strategy for p in ap.partials] == ["runDomain"] * 2
    prev = port_cascade.set_run_domain_enabled(False)
    try:
        ap = engines.make_aggregate_partials(
            query_from_json(_queries("hour")["groupby"]), port,
            torch.device("cpu"))
    finally:
        port_cascade.set_run_domain_enabled(prev)
    assert "runDomain" not in [p.spec.strategy for p in ap.partials]


# ---------------------------------------------------------------------------
# (b) plan parity
# ---------------------------------------------------------------------------

def _runs_segment(n_runs, rows):
    """One segment whose LONG column `rl` has exactly `n_runs` runs."""
    t0 = Interval.parse(DAY).start
    rl = np.repeat(np.arange(n_runs, dtype=np.int64),
                   np.diff(np.linspace(0, rows, n_runs + 1).astype(int)))
    d0 = np.zeros(rows, dtype=np.int32)
    return _segment(t0 + np.arange(rows) // 64, {"d0": d0},
                    {"rl": ("long", rl)})


def _grid_segments():
    cap = CASCADE_MAX_RUNS
    out = {
        "sorted": _rollup(1, seed=3)[0],
        "sorted_nan": _rollup(1, nan=True, seed=3)[0],
        "hour_ordered": _rollup(1, hours=4, seed=4)[0],
        "one_second": _rollup(1, spread=False, seed=5)[0],
        "unsorted": _rollup(1, order="unsorted", seed=6)[0],
        # the two price-outs: nr > CASCADE_MAX_RUNS, nr * 16 > n_rows
        "cap": _runs_segment(cap, 16 * (cap + 1)),
        "cap+1": _runs_segment(cap + 1, 16 * (cap + 1)),
        "rows/16": _runs_segment(256, 4096),
        "rows/16+1": _runs_segment(257, 4096),
    }
    return {k: (s, _carry(s)) for k, s in out.items()}


_AGG_CLASSES = {"count": "CountAggregator", "longSum": "LongSumAggregator",
                "floatSum": "FloatSumAggregator",
                "doubleSum": "DoubleSumAggregator",
                "floatMax": "FloatMaxAggregator",
                "longMin": "LongMinAggregator",
                "doubleMin": "DoubleMinAggregator"}

#: aggregator mixes: (kind, field)
MIXES = {
    "count": [("count", None)],
    "long": [("count", None), ("longSum", "m0"), ("longMin", "m1")],
    "const": [("longSum", "cnt")],
    "missing": [("longSum", "nope"), ("longMin", "nope")],
    "float_sum": [("count", None), ("floatSum", "f")],
    "double_sum": [("doubleSum", "f")],
    "dim_sum": [("longSum", "d0")],
    "float_minmax": [("floatMax", "f"), ("doubleMin", "f")],
    "noise": [("longMin", "noise")],
    "runs": [("longMin", "rl")],
}

FILTERS = {
    "none": None,
    "in": IN_D1,
    "bound": {"type": "bound", "dimension": "m0", "lower": "2",
              "upper": "9", "ordering": "numeric"},
    "not_or": {"type": "not", "field": {"type": "or", "fields": [
        {"type": "selector", "dimension": "d0", "value": "d0_001"},
        {"type": "selector", "dimension": "m1", "value": "3"}]}},
    "time": {"type": "interval", "dimension": "__time",
             "intervals": ["2026-01-01T00:00/2026-01-01T02:00"]},
    "missing": {"type": "selector", "dimension": "nope", "value": None},
    "noise": {"type": "bound", "dimension": "noise", "upper": "250",
              "ordering": "numeric"},
}

#: (dimensions, granularity, interval)
SHAPES = [((), "all", DAY), (("d0",), "all", DAY), (("d0", "d1"), "all", DAY),
          (("d1",), "hour", DAY), ((), "hour", DAY), (("d0",), "minute", DAY),
          (("d0",), "all", "2026-01-01T00:30/2026-01-02"),
          ((), "hour", "2026-01-01T00:00/2026-01-01T02:30")]


def _specs(module, mix):
    out = []
    for i, (kind, field) in enumerate(MIXES[mix]):
        cls = getattr(module, _AGG_CLASSES[kind])
        out.append(cls(f"a{i}") if field is None else cls(f"a{i}", field))
    return out


def _ref_plan(seg, dims, gran, iv, mix, flt):
    g = RefGranularity.of(gran)
    ivs = [Interval.parse(iv)]
    kdims = [ref_grouping.KeyDim(d, seg.dims[d].cardinality, None)
             for d in dims]
    spec = ref_grouping.make_group_spec(seg, ivs, g, kdims)
    kernels = [ref_kernels.make_kernel(a, seg) for a in _specs(RA, mix)]
    return ref_cascade._plan_run_domain(seg, ivs, g, spec, kernels,
                                        RF.filter_from_json(flt), [])


def _port_plan(seg, dims, gran, iv, mix, flt):
    g = PortGranularity.of(gran)
    ivs = [PortInterval.parse(iv)]
    kdims = [port_grouping.KeyDim(d, seg.dims[d].cardinality) for d in dims]
    spec = port_grouping.make_group_spec(seg, ivs, g, kdims)
    kernels = [port_kernels.make_kernel(a, seg) for a in _specs(PA, mix)]
    return rundomain._plan_run_domain(seg, ivs, g, spec, kernels,
                                      PF.filter_from_json(flt))


_GRID = {}


@pytest.mark.parametrize("name", ["sorted", "sorted_nan", "hour_ordered",
                                  "one_second", "unsorted"])
def test_plan_matches_reference(name):
    if not _GRID:
        _GRID.update(_grid_segments())
    ref, port = _GRID[name]
    planned = []
    for dims, gran, iv in SHAPES:
        for mix in MIXES:
            if mix == "runs":
                continue
            for fname, flt in FILTERS.items():
                want = _ref_plan(ref, dims, gran, iv, mix, flt)
                got = _port_plan(port, dims, gran, iv, mix, flt)
                where = (dims, gran, iv, mix, fname)
                assert (got is None) == (want is None), where
                if want is None:
                    continue
                _, _, pkey, bucket, (starts, lengths, nr) = got
                planned.append(pkey)
                assert pkey == want[4] and bucket == want[5], where
                ws, wl, wn = want[6]
                assert nr == wn and np.array_equal(starts, ws) \
                    and np.array_equal(lengths, wl), where
                assert starts.dtype == ws.dtype == np.int32, where
    # unsorted rows plan only where the query reads no column
    assert planned
    assert all(not p for p in planned) == (name == "unsorted")


@pytest.mark.parametrize("name,plans", [("cap", True), ("cap+1", False),
                                        ("rows/16", True),
                                        ("rows/16+1", False)])
def test_plan_price_outs_match_reference(name, plans):
    if not _GRID:
        _GRID.update(_grid_segments())
    ref, port = _GRID[name]
    want = _ref_plan(ref, (), "all", DAY, "runs", None)
    got = _port_plan(port, (), "all", DAY, "runs", None)
    assert (want is not None) == plans and (got is not None) == plans
    if plans:
        assert got[4][2] == want[6][2]
        assert np.array_equal(got[4][0], want[6][0])
        assert np.array_equal(got[4][1], want[6][1])
    # priced out or not, the partition is the one the reference built
    ref_part = ref._aux_cache[("cascade_runpart", ("rl",), None)]
    for a, b in zip(rundomain.joint_partition(port, ("rl",)), ref_part):
        assert np.array_equal(a, b)


def test_run_domain_switch_refuses_plans():
    ref, port = _pair(_rollup(1, seed=7))
    assert _port_plan(port[0], ("d0",), "all", DAY, "long", None) is not None
    prev = port_cascade.set_run_domain_enabled(False)
    try:
        assert _port_plan(port[0], ("d0",), "all", DAY, "long",
                          None) is None
    finally:
        assert port_cascade.set_run_domain_enabled(prev) is False


# ---------------------------------------------------------------------------
# (c) run tables and leaf payloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sorted", "hour_ordered", "unsorted",
                                  "cap", "rows/16+1"])
def test_column_run_info_matches_reference(name):
    if not _GRID:
        _GRID.update(_grid_segments())
    ref, port = _GRID[name]
    cols = sorted(set(ref.dims) | set(ref.metrics)) + ["nope"]
    for c in cols:
        for max_runs in (None, 4, 64, 1 << 20):
            want = ref_cascade.column_run_info(ref, c, max_runs)
            got = port_cascade.column_run_info(port, c, max_runs)
            assert (got is None) == (want is None), (c, max_runs)
            if want is not None:
                assert got[2] == want[2], (c, max_runs)
                for a, b in zip(got[:2], want[:2]):
                    assert a.dtype == b.dtype and np.array_equal(a, b)
    for v in (np.zeros(0, np.int64), np.array([5]), np.array([1, 1, 2, 1])):
        for a, b in zip(port_cascade.rle_encode(v),
                        ref_cascade.rle_encode(v)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", ["sorted", "hour_ordered", "unsorted"])
def test_run_leaf_payload_matches_reference(name):
    if not _GRID:
        _GRID.update(_grid_segments())
    ref, port = _GRID[name]
    padded = port.padded_rows()
    rng = np.random.default_rng(8)
    for dim in ("d0", "d1"):
        lut = rng.random(port.dims[dim].cardinality) < 0.5
        for rows in (padded, 1 << 14):
            want = ref_filters._run_leaf_payload(ref, dim, lut, rows)
            got = port_filters._run_leaf_payload(port, dim, lut, rows)
            assert (got is None) == (want is None), (dim, rows)
            if want is not None:
                assert got.dtype == want.dtype
                assert np.array_equal(got, want), (dim, rows)
    assert (port_filters._run_leaf_payload(
        port, "d0", np.ones(8, bool), 1 << 14) is None) \
        == (name == "unsorted")


# ---------------------------------------------------------------------------
# (d) run-table leaf words
# ---------------------------------------------------------------------------

def _row_words(seg, dim, lut, padded):
    return port_filters.host_words(
        port_filters.leaf_bits(seg, dim, lut, padded))


@pytest.mark.parametrize("hours", [1, 4])
def test_run_leaf_words_equal_row_built_words(hours):
    # 60,000 rows: d1's 48 runs an hour stay under padded_rows / 256
    _, port = _pair(_rollup(1, rows=60_000, hours=hours, seed=9))
    seg = port[0]
    padded = seg.padded_rows()
    dev = torch.device("cpu")
    rng = np.random.default_rng(10)
    for dim in ("d0", "d1"):
        for lut in (rng.random(seg.dims[dim].cardinality) < 0.5,
                    np.zeros(seg.dims[dim].cardinality, bool),
                    np.ones(seg.dims[dim].cardinality, bool)):
            want = _row_words(seg, dim, lut, padded)
            payload = port_filters._run_leaf_payload(seg, dim, lut, padded)
            assert payload is not None
            staged = port_filters.runs_leaf_words(
                torch.from_numpy(payload), padded)
            assert np.array_equal(staged.numpy(), want), dim
            mega = port_megakernel.mega_leaf_words(seg, dim, lut, padded,
                                                   dev)
            assert np.array_equal(mega.numpy(), want), dim


BITMAP_Q = {"queryType": "groupBy", "dataSource": "rd", "intervals": [DAY],
            "granularity": "hour", "dimensions": ["d0"],
            "aggregations": [{"type": "count", "name": "n"},
                             {"type": "longMin", "name": "nm",
                              "fieldName": "noise"}],
            "filter": {"type": "or", "fields": [
                IN_D1, {"type": "selector", "dimension": "d0",
                        "value": "d0_006"}]}}


@pytest.mark.parametrize("mega", [False, True], ids=["staged", "mega"])
def test_bitmap_filter_through_run_leaves(mega, monkeypatch):
    """A row-program query (noise is row-random) whose bitmap filter's
    leaves come from run tables: the rows equal the reference's, the leaf
    run tables were cached under their own key, and the combined words
    equal the row-built ones."""
    ref, port = _pair(_rollup(2, rows=60_000, hours=4, seed=11))
    # the per-segment staged fill and fused leaves, which batching bypasses
    # for these shape-compatible segments
    monkeypatch.setattr(port_batching, "_ENABLED", False)
    prev = port_megakernel.set_enabled(mega)
    prev_ref = ref_megakernel.set_enabled(mega)
    try:
        want = RefExecutor(ref).run_json(BITMAP_Q)
        got = _run(port, BITMAP_Q)
    finally:
        port_megakernel.set_enabled(prev)
        ref_megakernel.set_enabled(prev_ref)
    assert want and _exact(got) == _exact(want)
    kind = "megaleafruns" if mega else "fbmpleaf"
    for seg in port:
        keys = [k for k in seg.device_entries() if k[0] == kind]
        assert {k[1] for k in keys} == {"d0", "d1"}
        assert not any(k[0] == "leafwords" for k in seg.device_entries())
        node = port_filters.plan_filter(PF.filter_from_json(
            BITMAP_Q["filter"]), seg, device_bitmap=True)
        padded = seg.padded_rows()
        rows_built = port_filters.structure_words(
            node.structure, [torch.from_numpy(_row_words(
                seg, d, lut, padded)) for d, lut in node.leaves].__getitem__)
        filled = port_filters._fill_single(seg, node, padded,
                                           torch.device("cpu"))
        assert torch.equal(filled, rows_built)


# ---------------------------------------------------------------------------
# (e) the constant-LONG sum
# ---------------------------------------------------------------------------

def test_const_sum_column_never_stages():
    ref, port = _pair(_rollup(2, rows=2048, seed=12))
    k = port_kernels.make_kernel(PA.LongSumAggregator("c", "cnt"), port[0])
    assert k.const_value == 1 and k.required_device_columns() == set()
    rk = ref_kernels.make_kernel(RA.LongSumAggregator("c", "cnt"), ref[0])
    assert rk.required_device_columns() == set()
    assert port_kernels.make_kernel(PA.LongSumAggregator("s", "m0"),
                                    port[0]).required_device_columns() \
        is None
    # a row program: noise is row-random, so the run domain refuses
    q = {"queryType": "timeseries", "dataSource": "rd", "intervals": [DAY],
         "granularity": "hour",
         "aggregations": [{"type": "count", "name": "n"},
                          {"type": "longSum", "name": "c",
                           "fieldName": "cnt"},
                          {"type": "longMax", "name": "nx",
                           "fieldName": "noise"}]}
    h0 = _hits(port_cascade.code_domain_stats())
    want = RefExecutor(ref).run_json(q)
    got = _run(port, q)
    assert _hits(port_cascade.code_domain_stats()) == h0
    assert want and _exact(got) == _exact(want)
    for r in got:
        assert r["result"]["c"] == r["result"]["n"]
    for seg in port:
        blocks = [k[1] for k in seg.device_entries() if k[0] == "block"]
        assert blocks and all("cnt" not in cols and "noise" in cols
                              for cols in blocks)


def test_const_sum_update_is_count_times_value():
    _, port = _pair(_rollup(1, rows=2048, seed=13))
    seg = port[0]
    seg.metrics["big"] = type(seg.metrics["cnt"])(
        np.full(seg.n_rows, 2**62, dtype=np.int64), seg.metrics["cnt"].type)
    k = port_kernels.make_kernel(PA.LongSumAggregator("b", "big"), seg)
    assert k.const_value == 2**62
    keys = torch.arange(seg.n_rows) % 4
    mask = torch.arange(seg.n_rows) % 3 != 0
    got = k.update({}, mask, keys, 4)
    n = np.bincount(keys.numpy()[mask.numpy()], minlength=4)
    want = (n.astype(np.uint64) * np.uint64(2**62)).astype(np.int64)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# (f) code-domain counters
# ---------------------------------------------------------------------------

def test_code_domain_stats_count_hits_and_rows():
    ref, port = _pair(_rollup(3, rows=3000, seed=14))
    # the third segment's rows are shuffled: it stays on the row program
    shuffled = _rollup(1, rows=3000, order="unsorted", seed=15)[0]
    port.append(_carry(shuffled))
    stats = port_cascade.code_domain_stats()
    s0 = stats.snapshot()
    q = _queries("all")["timeseries"]
    _run(port, q)
    s1 = stats.snapshot()
    assert s1["hits"] - s0["hits"] == 3
    assert s1["rows"] - s0["rows"] == 3 * 3000
    _run(port, q, run_domain=False)
    assert stats.snapshot() == s1
