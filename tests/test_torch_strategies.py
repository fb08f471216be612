"""The port's reduction strategies against the reference package.

(a) Selection parity: over a grid of group spaces (8 ... 2^17, dense and
    host key modes), aggregator mixes (one over a FLOAT virtual column,
    which both packages plan as a missing column; ones holding a first/last,
    filtered or HLL kernel, which select mixed), long ranges (small,
    negative, wide, constant), a float column with a NaN, sorted and unsorted segments, the
    projection's row floor on and off, and every FORCE_STRATEGY value, the
    port's `select_strategy` returns the reference's (strategy, window).
(b) Query parity per strategy: mm, blocked, windowed, the mixed hybrid and
    the projection's windowed fallback, each reached naturally and forced,
    run through both `QueryExecutor`s; a spy shows the port took the
    strategy. Counts, long sums and min/max exact; float sums within
    1e-5 * sum|v| per group.
(c) The reductions called directly on random keys and masks, against the
    reference's own functions: fully masked blocks, row counts that are no
    multiple of any block, negative longs (the limb base), and a float
    column holding Inf on masked rows.
The reference runs as its own tests run it on the CPU; the port runs on the
CPU, where every strategy is torch ops.
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import jax.numpy as jnp
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.data.segment import NumericColumn, ValueType
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.engine import grouping as ref_grouping
from druid_tpu.engine import kernels as ref_kernels
from druid_tpu.engine import mmagg as ref_mmagg
from druid_tpu.engine import pallas_agg
from druid_tpu.query import aggregators as RA
from druid_tpu.utils.granularity import Granularity as RefGranularity
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import batching as port_batching
from druid_tpu_torch.engine import grouping as port_grouping
from druid_tpu_torch.engine import kernels as port_kernels
from druid_tpu_torch.engine import mmagg as port_mmagg
from druid_tpu_torch.engine import sorted_reduce
from druid_tpu_torch.query import aggregators as PA
from druid_tpu_torch.utils.granularity import Granularity as PortGranularity
from druid_tpu_torch.utils.intervals import Interval as PortInterval
from tests.test_torch_slice import _carry, _compare

# One intra-op thread: these tensors are small, and an OpenMP pool in every
# test worker would compete for cores with the suite's timing tests.
torch.set_num_threads(1)

DAY = "2026-01-01/2026-01-02"

# ---------------------------------------------------------------------------
# (a) selection parity
# ---------------------------------------------------------------------------

LONG_RANGES = {"small": (0, 10_000), "negative": (-4_000, -1),
               "wide": (-(2**40), 2**40), "const": (7, 7)}


def _grid_segment(sort_by_dims, lrange, nan):
    lo, hi = LONG_RANGES[lrange]
    schema = (
        ColumnSpec("d5", "string", cardinality=5),
        ColumnSpec("d40", "string", cardinality=40),
        ColumnSpec("d200", "string", cardinality=200, distribution="zipf"),
        ColumnSpec("d1000", "string", cardinality=1000),
        ColumnSpec("d2000", "string", cardinality=2000),
        ColumnSpec("d3000", "string", cardinality=3000),
        ColumnSpec("d100k", "string", cardinality=100_000),
        ColumnSpec("metLong", "long", low=lo, high=hi),
        ColumnSpec("metFloat", "float", distribution="normal", mean=10.0,
                   std=400.0),
    )
    seg = DataGenerator(schema, seed=5).segment(
        6_000, Interval.parse(DAY), datasource="g",
        sort_by_dims=sort_by_dims)
    if nan:
        seg.metrics["metFloat"].values[11] = np.nan
    return seg, _carry(seg)


#: (dimensions, granularity): group spaces from 8 to 2^17 in the dense key
#: mode, and two host-mode ones (the fused space above 2^21)
SHAPES = [
    ((), "all"), ((), "hour"), (("d5",), "all"), (("d40",), "all"),
    (("d40",), "hour"), (("d200",), "all"), (("d1000",), "all"),
    (("d2000",), "all"), (("d3000",), "all"), (("d1000",), "hour"),
    (("d5", "d40", "d200"), "all"), (("d5", "d40"), "hour"),
    (("d100k",), "all"), (("d2000", "d3000"), "all"),
    (("d5", "d40", "d200", "d1000"), "all"),
]

#: aggregator mixes: tests/test_strategies.py's AGGS and MM_AGGS, a
#: doubleSum (neither mm- nor blocked-eligible), a count alone, and
#: long max / double min
MIXES = {
    "aggs": [("count", None), ("longSum", "metLong"),
             ("floatSum", "metFloat"), ("floatMax", "metFloat"),
             ("longMin", "metLong")],
    "mm_aggs": [("count", None), ("longSum", "metLong"),
                ("floatSum", "metFloat")],
    "dsum": [("count", None), ("doubleSum", "metFloat")],
    "count": [("count", None)],
    "minmax": [("count", None), ("longMax", "metLong"),
               ("doubleMin", "metFloat")],
    # "vf": a FLOAT virtual column (computed, never staged)
    "vc": [("count", None), ("longSum", "metLong"), ("floatMax", "vf"),
           ("floatSum", "vf")],
    # the kernels that have no mm plan and no blocked step: first/last,
    # filtered and HLL, beside eligible ones
    "first_last": [("count", None), ("longSum", "metLong"),
                   ("longFirst", "metLong"), ("floatLast", "metFloat")],
    "filtered": [("count", None), ("floatSum", "metFloat"),
                 ("filtered", "metLong")],
    "hll": [("count", None), ("longSum", "metLong"), ("cardinality", "d5"),
            ("hyperUnique", "metLong")],
}
#: the mixes holding a kernel that has neither an mm plan nor a blocked step
NO_MM_NO_BLOCKED = ("first_last", "filtered", "hll")
#: the output dtypes of the virtual columns the mixes read
VC_DTYPES = {"vf": "float32"}

_AGG_CLASSES = {"count": "CountAggregator", "longSum": "LongSumAggregator",
                "floatSum": "FloatSumAggregator",
                "doubleSum": "DoubleSumAggregator",
                "floatMax": "FloatMaxAggregator",
                "longMin": "LongMinAggregator", "longMax": "LongMaxAggregator",
                "doubleMin": "DoubleMinAggregator"}


#: the new kernels' aggregators, as JSON (each package parses its own)
_JSON_AGGS = {
    "longFirst": lambda n, f: {"type": "longFirst", "name": n,
                               "fieldName": f},
    "floatLast": lambda n, f: {"type": "floatLast", "name": n,
                               "fieldName": f},
    "filtered": lambda n, f: {"type": "filtered", "name": n, "aggregator": {
        "type": "longSum", "name": n, "fieldName": f}, "filter": {
        "type": "selector", "dimension": "d5", "value": "v00000001"}},
    "cardinality": lambda n, f: {"type": "cardinality", "name": n,
                                 "fields": [f]},
    "hyperUnique": lambda n, f: {"type": "hyperUnique", "name": n,
                                 "fieldName": f},
}


def _specs(module, mix):
    out = []
    for i, (kind, field) in enumerate(MIXES[mix]):
        if kind in _JSON_AGGS:
            out.append(module.agg_from_json(_JSON_AGGS[kind](f"a{i}", field)))
            continue
        cls = getattr(module, _AGG_CLASSES[kind])
        out.append(cls(f"a{i}") if field is None else cls(f"a{i}", field))
    return out


def _kernel_columns(aggs, kernels):
    """The columns the planned kernels read, as both packages'
    run_grouped_aggregate take them: a kernel's required_device_columns()
    where it has one (a constant LONG sum reads none), else its
    aggregator's required_columns()."""
    out = set()
    for a, k in zip(aggs, kernels):
        kc = k.required_device_columns()
        out |= set(a.required_columns()) if kc is None else kc
    return out


def _ref_selection(seg, dims, gran, mix):
    """The reference's plan-time inputs to select_strategy, as its
    run_grouped_aggregate builds them (grouping.py:1126-1166)."""
    g = RefGranularity.of(gran)
    ivs = [Interval.parse(DAY)]
    kdims = [ref_grouping.KeyDim(d, seg.dims[d].cardinality, None)
             for d in dims]
    spec = ref_grouping.make_group_spec(seg, ivs, g, kdims)
    aggs = _specs(RA, mix)
    kernels = [ref_kernels.make_kernel(a, seg) for a in aggs]
    needed = {c for c in _kernel_columns(aggs, kernels)
              if c in seg.dims or c in seg.metrics}
    if spec.key_mode == "dense":
        needed |= set(dims)
    padded = max(1024, -(-seg.n_rows // 1024) * 1024)
    col_dtypes = {"__time_offset": np.dtype(np.int32),
                  "__valid": np.dtype(bool)}
    for c in needed:
        col_dtypes[c] = np.dtype(np.int32) if c in seg.dims \
            else np.dtype(seg.staged_dtype(c))
    if spec.key_mode == "host":
        col_dtypes["__key"] = np.dtype(np.int32)
    elif spec.bucket_mode == "host":
        col_dtypes["__bucket"] = np.dtype(np.int32)
    return ref_grouping.select_strategy(
        spec, kernels, col_dtypes, padded,
        lambda: ref_grouping.windowed_window(seg, ivs, g, spec))


def _port_selection(seg, dims, gran, mix):
    """The port's, through its own planning helpers."""
    g = PortGranularity.of(gran)
    ivs = [PortInterval.parse(DAY)]
    kdims = [port_grouping.KeyDim(d, seg.dims[d].cardinality) for d in dims]
    spec = port_grouping.make_group_spec(seg, ivs, g, kdims)
    aggs = _specs(PA, mix)
    kernels = [port_kernels.make_kernel(a, seg) for a in aggs]
    needed = {c for c in _kernel_columns(aggs, kernels)
              if c in seg.dims or c in seg.metrics}
    if spec.key_mode == "dense":
        needed |= set(dims)
    return port_grouping.select_strategy(
        spec, kernels, port_grouping.staged_col_dtypes(seg, spec, needed),
        seg.padded_rows(),
        lambda: port_grouping.windowed_window(seg, ivs, g, spec),
        {f: VC_DTYPES[f] for _, f in MIXES[mix] if f in VC_DTYPES})


_GRID_SEGMENTS = {}


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("lrange", sorted(LONG_RANGES))
@pytest.mark.parametrize("sort_by_dims", [False, True],
                         ids=["unsorted", "sorted"])
def test_selection_matches_reference(sort_by_dims, lrange, nan, monkeypatch):
    key = (sort_by_dims, lrange, nan)
    if key not in _GRID_SEGMENTS:
        _GRID_SEGMENTS[key] = _grid_segment(*key)
    ref_seg, port_seg = _GRID_SEGMENTS[key]
    seen = set()
    for proj_min in (1 << 20, 0):
        monkeypatch.setattr(ref_grouping, "PROJECTION_MIN_ROWS", proj_min)
        monkeypatch.setattr(port_grouping, "PROJECTION_MIN_ROWS", proj_min)
        for force in (None, "mm", "blocked", "windowed", "projection",
                      "mixed"):
            monkeypatch.setattr(ref_grouping, "FORCE_STRATEGY", force)
            monkeypatch.setattr(port_grouping, "FORCE_STRATEGY", force)
            for dims, gran in SHAPES:
                for mix in MIXES:
                    want = _ref_selection(ref_seg, dims, gran, mix)
                    got = _port_selection(port_seg, dims, gran, mix)
                    assert got == want, (dims, gran, mix, force, proj_min)
                    seen.add(want[0])
                    if mix in NO_MM_NO_BLOCKED:
                        # under every force and shape
                        assert want == ("mixed", 0), (dims, gran, mix)
    # the grid reaches every strategy the selection can return
    assert {"blocked", "mm", "projection", "mixed"} <= seen
    if sort_by_dims:
        assert "windowed" in seen


def test_selection_with_a_double_virtual_sum(monkeypatch):
    """A DOUBLE virtual sum has no mm plan over its computed float64
    column. The reference plans it as a missing column and can select mm
    (then fails at trace time); the port selects as the reference does
    everywhere else, and where the reference says mm it goes on down the
    reference's order."""
    key = (False, "small", False)
    if key not in _GRID_SEGMENTS:
        _GRID_SEGMENTS[key] = _grid_segment(*key)
    ref_seg, port_seg = _GRID_SEGMENTS[key]
    monkeypatch.setitem(MIXES, "vd", [("count", None),
                                      ("doubleSum", "vd")])
    monkeypatch.setitem(VC_DTYPES, "vd", "float64")
    seen = set()
    for dims, gran in SHAPES:
        want = _ref_selection(ref_seg, dims, gran, "vd")
        got = _port_selection(port_seg, dims, gran, "vd")
        seen.add(want[0])
        if want[0] == "mm":
            assert got[0] in ("blocked", "mixed"), (dims, gran)
        else:
            assert got == want, (dims, gran)
    assert "mm" in seen


def test_selection_grid_spans_the_group_spaces():
    """The grid's group spaces run from 8 to 2^17, in both key modes."""
    seg = _GRID_SEGMENTS.get((True, "small", False)) \
        or _grid_segment(True, "small", False)
    _, port_seg = seg
    totals, modes = set(), set()
    for dims, gran in SHAPES:
        spec = port_grouping.make_group_spec(
            port_seg, [PortInterval.parse(DAY)], PortGranularity.of(gran),
            [port_grouping.KeyDim(d, port_seg.dims[d].cardinality)
             for d in dims])
        totals.add(spec.num_total)
        modes.add(spec.key_mode)
    assert min(totals) == 8 and max(totals) == 1 << 17
    assert modes == {"dense", "host"}


# ---------------------------------------------------------------------------
# (b) query parity per strategy
# ---------------------------------------------------------------------------

IV = "2026-01-01/2026-01-02"


def _segments(sort_by_dims=False, card_a=30, card_b=200, n=40_000, lo=-500,
              hi=9_000, seed=77):
    """tests/test_strategies.py::_gen, with |metFloat| beside metFloat for
    the float-sum tolerance; (reference segments, port segments)."""
    schema = (
        ColumnSpec("dimA", "string", cardinality=card_a),
        ColumnSpec("dimB", "string", cardinality=card_b, distribution="zipf"),
        ColumnSpec("metLong", "long", low=lo, high=hi),
        ColumnSpec("metFloat", "float", distribution="normal", mean=10.0,
                   std=400.0),
    )
    ref = DataGenerator(schema, seed=seed).segments(
        2, n // 2, Interval.parse(IV), datasource="s",
        sort_by_dims=sort_by_dims)
    for s in ref:
        s.metrics["absFloat"] = NumericColumn(
            np.abs(s.metrics["metFloat"].values), ValueType.FLOAT)
    return ref, [_carry(s) for s in ref]


AGGS = [{"type": "count", "name": "rows"},
        {"type": "longSum", "name": "lsum", "fieldName": "metLong"},
        {"type": "floatSum", "name": "fsum", "fieldName": "metFloat"},
        {"type": "floatMax", "name": "fmax", "fieldName": "metFloat"},
        {"type": "longMin", "name": "lmin", "fieldName": "metLong"},
        {"type": "floatSum", "name": "fabs", "fieldName": "absFloat"}]
MM_AGGS = [a for a in AGGS if a["name"] in ("rows", "lsum", "fsum", "fabs")]
DSUM = {"type": "doubleSum", "name": "dsum", "fieldName": "metFloat"}
BOUND = {"type": "bound", "dimension": "metLong", "lower": "-100",
         "upper": "8000", "ordering": "numeric"}


def _groupby(dims, aggs, flt=None, gran="all"):
    return {"queryType": "groupBy", "dataSource": "s", "intervals": [IV],
            "granularity": gran, "dimensions": list(dims),
            "aggregations": aggs, "filter": flt}


class _Spy:
    """Records which of the port's reductions ran, and the (strategy,
    window) its selection returned. `per_segment` keeps the port's
    segments on the per-segment path, where the counts below are one per
    segment (batching would run shape-compatible segments as one stacked
    run; tests/test_torch_batching.py spies on that path)."""

    def __init__(self, monkeypatch, per_segment=False):
        if per_segment:
            monkeypatch.setattr(port_batching, "_ENABLED", False)
        self.calls, self.selected = [], []
        for name in ("mm_reduce", "_blocked_reduce", "_windowed_reduce"):
            self._wrap(monkeypatch, name)
        orig = port_grouping.select_strategy

        def select(*a, **k):
            out = orig(*a, **k)
            self.selected.append(out)
            return out
        monkeypatch.setattr(port_grouping, "select_strategy", select)
        self.plain = sorted_reduce.PLAIN_CALLS

    def _wrap(self, monkeypatch, name):
        orig = getattr(port_grouping, name)

        def spy(arrays, mask, key, kernels, *a, **k):
            self.calls.append((name, tuple(kr.name for kr in kernels)))
            return orig(arrays, mask, key, kernels, *a, **k)
        monkeypatch.setattr(port_grouping, name, spy)

    def names(self):
        return [c[0] for c in self.calls]

    def b1_calls(self):
        return sorted_reduce.PLAIN_CALLS - self.plain


def _both(segs, q):
    ref, port = segs
    want = RefExecutor(ref).run_json(q)
    got = PortExecutor(port, device="cpu").run_json(q)
    _compare(want, got)
    assert want
    return want, got


@pytest.fixture(scope="module")
def unsorted_segs():
    return _segments()


@pytest.fixture(scope="module")
def sorted_segs():
    return _segments(sort_by_dims=True)


@pytest.mark.parametrize("flt", [None, BOUND], ids=["all", "bound"])
def test_mm_natural_matches_reference(unsorted_segs, flt, monkeypatch):
    """dimB pads to 256 groups: above blocked's 64, inside mm's 2048."""
    spy = _Spy(monkeypatch)
    _both(unsorted_segs, _groupby(["dimB"], MM_AGGS, flt))
    assert spy.selected == [("mm", 0)] * 2
    assert spy.names() == ["mm_reduce"] * 2


def test_mm_negative_longs_exact(monkeypatch):
    """Longs in -4000..-1: two limbs of (v - base) and the base row."""
    segs = _segments(card_b=40, lo=-4_000, hi=-1)
    spy = _Spy(monkeypatch, per_segment=True)
    monkeypatch.setattr(port_grouping, "FORCE_STRATEGY", "mm")
    monkeypatch.setattr(ref_grouping, "FORCE_STRATEGY", "mm")
    _both(segs, _groupby(["dimB"], MM_AGGS))
    assert spy.names() == ["mm_reduce"] * 2
    k = port_kernels.make_kernel(PA.LongSumAggregator("s", "metLong"),
                                 segs[1][0])
    lo = int(segs[1][0].metrics["metLong"].values.min())
    assert lo < 0 and (k.mm_limbs, k.mm_base) == (2, lo)


@pytest.mark.parametrize("force,dims,aggs,sort_by_dims", [
    ("mm", ["dimA", "dimB"], MM_AGGS, False),       # 8192 groups > 4096
    ("mm", ["dimB"], MM_AGGS, False),
    ("blocked", ["dimB"], AGGS, False),
    ("blocked", ["dimA"], AGGS, False),
    ("windowed", ["dimA", "dimB"], AGGS, True),
    ("mixed", ["dimB"], AGGS, False),
    ("mixed", ["dimA", "dimB"], AGGS, False),
], ids=["mm-ineligible-falls-through", "mm", "blocked-256", "blocked-32",
        "windowed", "mixed-hybrid", "mixed-scatter"])
def test_forced_strategy_matches_reference(force, dims, aggs, sort_by_dims,
                                           unsorted_segs, sorted_segs,
                                           monkeypatch):
    """FORCE_STRATEGY in both packages: the same (strategy, window) per
    segment, the port's reductions as the strategy says, the same rows."""
    segs = sorted_segs if sort_by_dims else unsorted_segs
    monkeypatch.setattr(port_grouping, "FORCE_STRATEGY", force)
    monkeypatch.setattr(ref_grouping, "FORCE_STRATEGY", force)
    want_sel = []
    orig = ref_grouping.select_strategy

    def ref_select(*a, **k):
        out = orig(*a, **k)
        want_sel.append(out)
        return out
    monkeypatch.setattr(ref_grouping, "select_strategy", ref_select)
    spy = _Spy(monkeypatch)
    _both(segs, _groupby(dims, aggs, BOUND))
    assert spy.selected == want_sel and len(want_sel) == 2
    strategy = spy.selected[0][0]
    expect = {"mm": ["mm_reduce"] * 2, "blocked": ["_blocked_reduce"] * 2,
              "windowed": ["_windowed_reduce"] * 2}
    if force == "mm" and len(dims) == 2:
        # 30 x 200 pads to 8192 > MM_GROUP_LIMIT: falls through to the
        # reference's normal selection (windowed needs sorted rows)
        assert strategy == "mixed" and spy.names() == []
    elif force == "mixed" and len(dims) == 1:
        # the reference's hybrid: G <= 2048, every kernel blocked-eligible
        assert strategy == "mixed"
        assert spy.calls == [("_blocked_reduce", tuple(
            a["name"] for a in aggs))] * 2
    elif force == "mixed":
        assert strategy == "mixed" and spy.names() == []
    else:
        assert strategy == force and spy.names() == expect[force]
        if force == "windowed":
            assert spy.selected[0][1] in port_grouping.WINDOW_CHOICES


def test_blocked_natural_small_group_space(unsorted_segs, monkeypatch):
    """dimA pads to 32 <= 64 groups: blocked, in both packages."""
    spy = _Spy(monkeypatch)
    _both(unsorted_segs, _groupby(["dimA"], AGGS, BOUND))
    assert spy.selected == [("blocked", 0)] * 2
    assert spy.names() == ["_blocked_reduce"] * 2


def test_windowed_natural_on_sorted_segments(sorted_segs, monkeypatch):
    """30 x 200 = 6000 dense groups over the rollup order: windowed."""
    spy = _Spy(monkeypatch)
    _both(sorted_segs, _groupby(["dimA", "dimB"], AGGS, BOUND))
    assert [s for s, _ in spy.selected] == ["windowed"] * 2
    assert spy.names() == ["_windowed_reduce"] * 2


def test_windowed_ineligible_on_unsorted(unsorted_segs, monkeypatch):
    spy = _Spy(monkeypatch)
    _both(unsorted_segs, _groupby(["dimA", "dimB"], AGGS))
    assert spy.selected == [("mixed", 0)] * 2 and spy.names() == []


@pytest.mark.parametrize("gran", ["hour", "all"])
def test_mixed_hybrid_matches_reference(unsorted_segs, gran, monkeypatch):
    """A doubleSum is neither blocked- nor mm-eligible: the mixed strategy
    runs every other aggregator, and the row counts, blocked, and scatters
    the doubleSum (the headline timeseries' shape)."""
    spy = _Spy(monkeypatch)
    q = _groupby(["dimA"], AGGS + [DSUM], gran=gran)
    _both(unsorted_segs, q)
    assert spy.selected == [("mixed", 0)] * 2
    assert spy.calls == [("_blocked_reduce", tuple(
        a["name"] for a in AGGS))] * 2


def test_timeseries_hybrid_matches_reference(unsorted_segs, monkeypatch):
    """The headline timeseries' aggregators, hourly (24 buckets)."""
    spy = _Spy(monkeypatch)
    q = {"queryType": "timeseries", "dataSource": "s", "intervals": [IV],
         "granularity": "hour", "aggregations": [
             {"type": "count", "name": "rows"},
             {"type": "longSum", "name": "lsum", "fieldName": "metLong"},
             {"type": "floatMax", "name": "fmax", "fieldName": "metFloat"},
             DSUM, {"type": "floatSum", "name": "fabs",
                    "fieldName": "absFloat"}]}
    _both(unsorted_segs, q)
    assert spy.calls == [("_blocked_reduce",
                          ("rows", "lsum", "fmax", "fabs"))] * 2


def test_projection_windowed_fallback(unsorted_segs, monkeypatch):
    """When kernel B1 cannot take the projection (the reference on the CPU
    without interpret mode; the port with B1's caps made to fail), the
    projection reduces through the windowed strategy over the sorted
    layout."""
    monkeypatch.setattr(ref_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(port_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(sorted_reduce, "usable", lambda *a, **k: False)
    inner = {"ref": [], "port": []}
    for tag, mod in (("ref", ref_grouping), ("port", port_grouping)):
        orig = mod._projection_strategy

        def spy_inner(*a, _orig=orig, _tag=tag, **k):
            out = _orig(*a, **k)
            inner[_tag].append(out)
            return out
        monkeypatch.setattr(mod, "_projection_strategy", spy_inner)
    spy = _Spy(monkeypatch)
    _both(unsorted_segs, _groupby(["dimA", "dimB"], AGGS, BOUND))
    assert inner["port"] == inner["ref"] and len(inner["ref"]) == 2
    assert all(s == "windowed" for s, _ in inner["port"])
    assert spy.names() == ["_windowed_reduce"] * 2
    assert spy.b1_calls() == 0


def test_projection_stays_on_b1(unsorted_segs, monkeypatch):
    """With B1's caps met the projection stays first in line: the port
    runs B1 (its plain version here), the reference its Pallas kernel in
    interpret mode."""
    monkeypatch.setattr(ref_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(port_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(pallas_agg, "_FORCE_INTERPRET", True)
    spy = _Spy(monkeypatch)
    _both(unsorted_segs, _groupby(["dimA", "dimB"], AGGS, BOUND))
    assert spy.selected == [("projection", 0)] * 2
    assert spy.names() == [] and spy.b1_calls() == 2


def test_mm_float_nan_confined_to_its_group(monkeypatch):
    """A NaN float row NaNs only its own group: a column with a non-finite
    value is not mm-eligible (it would poison every group through the
    one-hot), in both packages."""
    ref, _ = _segments(card_b=200)
    vals = ref[0].metrics["metFloat"].values
    vals[7] = np.nan
    col = ref[0].dims["dimB"]
    poison = col.dictionary.values[col.ids[7]]
    port = [_carry(s) for s in ref]
    spy = _Spy(monkeypatch)
    q = _groupby(["dimB"], [a for a in MM_AGGS if a["name"] != "fabs"])
    want = RefExecutor(ref).run_json(q)
    got = PortExecutor(port, device="cpu").run_json(q)
    assert spy.selected[0][0] != "mm" and spy.selected[1] == ("mm", 0)
    assert "mm_reduce" in spy.names()
    by_ref = {r["event"]["dimB"]: r["event"] for r in want}
    for r in got:
        e = r["event"]
        w = by_ref[e["dimB"]]
        assert (e["rows"], e["lsum"]) == (w["rows"], w["lsum"])
        if e["dimB"] == poison:
            assert np.isnan(e["fsum"]) and np.isnan(w["fsum"])
        else:
            assert np.isfinite(e["fsum"])
            assert e["fsum"] == pytest.approx(w["fsum"], rel=1e-4, abs=1e-2)


@pytest.mark.parametrize("bad", [np.inf, -np.inf])
def test_mm_float_nonfinite_column_not_mm(bad, monkeypatch):
    ref, _ = _segments(card_b=200)
    ref[0].metrics["metFloat"].values[3] = bad
    port = [_carry(s) for s in ref]
    spy = _Spy(monkeypatch)
    q = _groupby(["dimB"], [a for a in MM_AGGS if a["name"] != "fabs"])
    want = RefExecutor(ref).run_json(q)
    got = PortExecutor(port, device="cpu").run_json(q)
    assert spy.selected[0][0] != "mm"
    assert len(got) == len(want)


def test_mm_double_sum_falls_back(unsorted_segs, monkeypatch):
    spy = _Spy(monkeypatch, per_segment=True)
    _both(unsorted_segs, _groupby(["dimB"], [AGGS[0], AGGS[5], DSUM]))
    assert spy.selected == [("mixed", 0)] * 2
    assert spy.calls == [("_blocked_reduce", ("rows", "fabs"))] * 2


def test_constant_long_column_keeps_the_reference_strategy(monkeypatch):
    """A constant LONG column: both packages keep its longSum off mm,
    blocked and the projection and sum it as constant x count, with the
    same rows."""
    segs = _segments(card_b=200, lo=7, hi=7)
    spy = _Spy(monkeypatch, per_segment=True)
    _both(segs, _groupby(["dimB"], MM_AGGS))
    assert spy.selected == [("mixed", 0)] * 2
    assert spy.calls == [("_blocked_reduce", ("rows", "fsum", "fabs"))] * 2


@pytest.mark.parametrize("force", ["mm", "blocked", "projection", "mixed"])
def test_force_strategy_same_rows_as_natural(unsorted_segs, force,
                                             monkeypatch):
    """The port alone: every eligible force gives the natural run's counts
    and long sums, and float sums within the rule."""
    monkeypatch.setattr(port_grouping, "PROJECTION_MIN_ROWS", 0)
    q = _groupby(["dimB"], MM_AGGS, BOUND)
    _, port = unsorted_segs
    want = PortExecutor(port, device="cpu").run_json(q)
    spy = _Spy(monkeypatch)
    monkeypatch.setattr(port_grouping, "FORCE_STRATEGY", force)
    got = PortExecutor(port, device="cpu").run_json(q)
    assert spy.selected[0][0] == force
    _compare(want, got)


# ---------------------------------------------------------------------------
# (c) the reductions called directly
# ---------------------------------------------------------------------------

def _direct_segment(n, lo, hi):
    schema = (ColumnSpec("d", "string", cardinality=4),
              ColumnSpec("metLong", "long", low=lo, high=hi),
              ColumnSpec("metFloat", "float", distribution="normal",
                         mean=10.0, std=400.0))
    ref = DataGenerator(schema, seed=3).segment(n, Interval.parse(IV))
    return ref, _carry(ref)


DIRECT_AGGS = [("count", None), ("longSum", "metLong"),
               ("floatSum", "metFloat"), ("floatMax", "metFloat"),
               ("longMin", "metLong")]


def _direct_kernels(ref_seg, port_seg, mix):
    specs = []
    for i, (kind, field) in enumerate(mix):
        specs.append([getattr(m, _AGG_CLASSES[kind])(
            *((f"a{i}",) if field is None else (f"a{i}", field)))
            for m in (RA, PA)])
    return ([ref_kernels.make_kernel(r, ref_seg) for r, _ in specs],
            [port_kernels.make_kernel(p, port_seg) for _, p in specs])


def _direct_inputs(ref_seg, keys, mask, inf_off_mask):
    """The staged value columns (int32 longs, float32 floats) of the
    segment as both packages' arrays; Inf on masked rows when asked."""
    ml = ref_seg.metrics["metLong"].values.astype(np.int32)
    mf = ref_seg.metrics["metFloat"].values.astype(np.float32).copy()
    if inf_off_mask:
        off = np.flatnonzero(~mask)
        mf[off[::3]] = np.inf
        mf[off[1::3]] = -np.inf
    ref_arrays = {"metLong": jnp.asarray(ml), "metFloat": jnp.asarray(mf)}
    port_arrays = {"metLong": torch.from_numpy(ml),
                   "metFloat": torch.from_numpy(mf)}
    return (ref_arrays, jnp.asarray(mask), jnp.asarray(keys.astype(np.int32)),
            port_arrays, torch.from_numpy(mask),
            torch.from_numpy(keys.astype(np.int64)))


def _compare_direct(ref_out, port_out, ref_ks, mask, keys, absf, num):
    (rc, rs), (pc, ps) = ref_out, port_out
    np.testing.assert_array_equal(np.asarray(rc).astype(np.int64),
                                  pc.numpy())
    # sum |metFloat| per group over the live rows: the float-sum tolerance
    tol = 1e-5 * np.bincount(keys[mask], weights=absf[mask], minlength=num)
    for k, r, p in zip(ref_ks, rs, ps):
        r, p = np.asarray(r), p.numpy()
        if isinstance(k, ref_kernels.SumKernel) \
                and k.vtype is ValueType.FLOAT:
            assert np.all(np.abs(r - p) <= tol + 1e-6), k.name
        else:
            if isinstance(k, ref_kernels.MinMaxKernel):
                assert r.dtype == p.dtype, k.name     # the staged dtype
            np.testing.assert_array_equal(r.astype(p.dtype), p,
                                          err_msg=k.name)


def _random_case(n, groups, seed, sort_keys=False):
    """Keys in [0, groups), a mask with three fully masked runs (one of
    them longer than any block), about 70% of the rest live."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, groups, n)
    if sort_keys:
        keys = np.sort(keys)
    mask = rng.random(n) < 0.7
    mask[100:9_000] = False                  # > MM_BLOCK and WINDOW_BLOCK
    mask[n // 2:n // 2 + 2_048] = False
    mask[-1_500:] = False
    return keys, mask


@pytest.mark.parametrize("lo,hi", [(-500, 9_000), (-4_000, -1), (0, 100)],
                         ids=["mixed-sign", "negative", "small"])
@pytest.mark.parametrize("inf_off_mask", [False, True],
                         ids=["finite", "inf-off-mask"])
@pytest.mark.parametrize("groups", [8, 300, 1024])
def test_mm_reduce_direct_matches_reference(lo, hi, inf_off_mask, groups):
    n = 21_011                               # no multiple of any block
    ref_seg, port_seg = _direct_segment(n, lo, hi)
    keys, mask = _random_case(n, groups, seed=groups)
    mix = [m for m in DIRECT_AGGS if m[0] in ("count", "longSum",
                                              "floatSum")]
    ref_ks, port_ks = _direct_kernels(ref_seg, port_seg, mix)
    ra, rm, rk, pa, pm, pk = _direct_inputs(ref_seg, keys, mask,
                                            inf_off_mask)
    num = port_grouping.pad_pow2(groups)
    dt = {c: str(a.dtype) for c, a in pa.items()}
    ref_plans = [k.mm_plan({c: a.dtype for c, a in ra.items()}, n)
                 for k in ref_ks]
    port_plans = [k.mm_plan(dt, n) for k in port_ks]
    assert all(p is not None for p in ref_plans + port_plans)
    assert [(p.n_i8, p.n_bf16) for p in port_plans] \
        == [(p.n_i8, p.n_bf16) for p in ref_plans]
    ref_out = ref_mmagg.mm_reduce(ra, rm, rk, ref_ks, ref_plans, num)
    port_out = port_mmagg.mm_reduce(pa, pm, pk, port_ks, port_plans, num)
    absf = np.abs(ref_seg.metrics["metFloat"].values.astype(np.float64))
    _compare_direct(ref_out, port_out, ref_ks, mask, keys, absf, num)


def test_mm_reduce_steps_agree(monkeypatch):
    """Several steps (a one-hot budget of one MM_BLOCK) give the one-step
    counts and long sums exactly, float sums within the rule."""
    n = 50_001
    ref_seg, port_seg = _direct_segment(n, -500, 9_000)
    keys, mask = _random_case(n, 300, seed=9)
    _, port_ks = _direct_kernels(ref_seg, port_seg, DIRECT_AGGS[:3])
    _, _, _, pa, pm, pk = _direct_inputs(ref_seg, keys, mask, True)
    dt = {c: str(a.dtype) for c, a in pa.items()}
    plans = [k.mm_plan(dt, n) for k in port_ks]
    one = port_mmagg.mm_reduce(pa, pm, pk, port_ks, plans, 512)
    monkeypatch.setattr(port_mmagg, "MM_ONEHOT_BYTES", 1)
    assert port_mmagg.step_rows(512) == port_mmagg.MM_BLOCK
    many = port_mmagg.mm_reduce(pa, pm, pk, port_ks, plans, 512)
    assert torch.equal(one[0], many[0]) and torch.equal(one[1][1], many[1][1])
    torch.testing.assert_close(one[1][2], many[1][2], rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("inf_off_mask", [False, True],
                         ids=["finite", "inf-off-mask"])
@pytest.mark.parametrize("groups", [8, 64, 2048])
def test_blocked_reduce_direct_matches_reference(inf_off_mask, groups,
                                                 monkeypatch):
    n = 21_011
    ref_seg, port_seg = _direct_segment(n, -500, 9_000)
    keys, mask = _random_case(n, groups, seed=groups + 1)
    ref_ks, port_ks = _direct_kernels(ref_seg, port_seg, DIRECT_AGGS)
    ra, rm, rk, pa, pm, pk = _direct_inputs(ref_seg, keys, mask,
                                            inf_off_mask)
    num = port_grouping.pad_pow2(groups)
    ref_out = ref_grouping._blocked_reduce(ra, rm, rk, ref_ks, num)
    # several steps, the last one ragged
    monkeypatch.setattr(port_grouping, "STEP_CELLS", num * 4096)
    port_out = port_grouping._blocked_reduce(pa, pm, pk, port_ks, num)
    absf = np.abs(ref_seg.metrics["metFloat"].values.astype(np.float64))
    _compare_direct(ref_out, port_out, ref_ks, mask, keys, absf, num)


@pytest.mark.parametrize("inf_off_mask", [False, True],
                         ids=["finite", "inf-off-mask"])
@pytest.mark.parametrize("n,groups", [(21_011, 6_000), (40_960, 12_000)])
def test_windowed_reduce_direct_matches_reference(n, groups, inf_off_mask,
                                                  monkeypatch):
    ref_seg, port_seg = _direct_segment(n, -500, 9_000)
    keys, mask = _random_case(n, groups, seed=n, sort_keys=True)
    ref_seg.metrics["metFloat"].values[n // 3] = np.nan
    mask[n // 3] = True
    pad = -n % 1024
    live = np.concatenate([mask, np.zeros(pad, bool)]).reshape(-1, 1024)
    kp = np.concatenate([keys, np.zeros(pad, keys.dtype)]).reshape(-1, 1024)
    lo = np.where(live, kp, keys.max()).min(1)
    hi = np.where(live, kp, 0).max(1)
    span = int(np.maximum(hi - lo + 1, 1).max())
    W = next(w for w in port_grouping.WINDOW_CHOICES if span <= w)
    ref_ks, port_ks = _direct_kernels(ref_seg, port_seg, DIRECT_AGGS)
    ra, rm, rk, pa, pm, pk = _direct_inputs(ref_seg, keys, mask,
                                            inf_off_mask)
    num = port_grouping.pad_pow2(groups)
    ref_out = ref_grouping._windowed_reduce(ra, rm, rk, ref_ks, num, W)
    # several steps of blocks
    monkeypatch.setattr(port_grouping, "STEP_CELLS", W * 1024 * 5)
    port_out = port_grouping._windowed_reduce(pa, pm, pk, port_ks, num, W)
    absf = np.abs(np.nan_to_num(
        ref_seg.metrics["metFloat"].values.astype(np.float64)))
    (rc, rs), (pc, ps) = ref_out, port_out
    # the NaN row's group: NaN float sum and max in both
    g = keys[n // 3]
    assert np.isnan(np.asarray(rs[2])[g]) and np.isnan(ps[2][g].item())
    assert np.isnan(np.asarray(rs[3])[g]) and np.isnan(ps[3][g].item())
    keep = np.ones(num, bool)
    keep[g] = False
    np.testing.assert_array_equal(np.asarray(rc).astype(np.int64), pc.numpy())
    tol = 1e-5 * np.bincount(keys[mask], weights=absf[mask], minlength=num)
    for k, r, p in zip(ref_ks, rs, ps):
        r, p = np.asarray(r)[keep], p.numpy()[keep]
        if k.name == "a2":
            assert np.all(np.abs(r - p) <= tol[keep] + 1e-6)
        else:
            np.testing.assert_array_equal(r.astype(p.dtype), p, k.name)


@pytest.mark.parametrize("groups,r8,width", [(32, 8, 4096), (1024, 8, 8192),
                                             (64, 16, 2048), (32, 128, 1024)])
def test_int8_product_is_the_plain_product(groups, r8, width):
    """The block-diagonal int8 product equals the plain one-hot product."""
    rng = np.random.default_rng(groups + r8)
    keys = torch.from_numpy(rng.integers(0, groups, width))
    mask = torch.from_numpy(rng.random(width) < 0.8)
    rows = torch.from_numpy(rng.integers(0, 128, (r8, width))
                            .astype(np.int8))
    oh = port_mmagg.onehot(keys, mask, groups)
    nsl = port_mmagg.slices(r8)
    lhs = rows.view(r8, nsl, width // nsl).transpose(0, 1).contiguous()
    got = port_mmagg.int8_product(oh, lhs)
    want = oh.long() @ rows.long().t()
    assert got.dtype == torch.int64 and torch.equal(got, want)


def test_blocked_long_sum_exact_past_int32(monkeypatch):
    """Longs near the chunk bound (chunk_rows 4096), group totals past
    2^31: the blocked step's int32 runs stay exact (several steps, the
    last ragged)."""
    segs = _segments(card_a=2, card_b=3, n=80_000, lo=200_000, hi=260_000)
    monkeypatch.setattr(port_grouping, "STEP_CELLS", 8 * 10_240)
    spy = _Spy(monkeypatch, per_segment=True)
    aggs = [AGGS[0], AGGS[1], AGGS[4]]
    want, _ = _both(segs, _groupby(["dimA", "dimB"], aggs))
    assert spy.selected == [("blocked", 0)] * 2
    assert any(r["event"]["lsum"] > 2**31 for r in want)


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 3 * 4096 + 5])
def test_exact_int_sum_matches_int64(n):
    rng = np.random.default_rng(n)
    w = torch.from_numpy(rng.integers(200_000, 262_144, (3, n))
                         .astype(np.int32))
    got = port_kernels._exact_int_sum(w, 4096)
    assert torch.equal(got, w.long().sum(-1))


def test_projection_span_matches_reference(unsorted_segs):
    """The projection's max span (B1's window, the windowed fallback's W)
    is the reference's, over int32 compact keys with invalid rows (hours
    outside the interval)."""
    ref, port = unsorted_segs
    iv = "2026-01-01T05:00/2026-01-01T20:00"
    for r, p in zip(ref, port):
        rg, pg = RefGranularity.of("hour"), PortGranularity.of("hour")
        rspec = ref_grouping.make_group_spec(
            r, [Interval.parse(iv)], rg,
            [ref_grouping.KeyDim(d, r.dims[d].cardinality, None)
             for d in ("dimA", "dimB")])
        pspec = port_grouping.make_group_spec(
            p, [PortInterval.parse(iv)], pg,
            [port_grouping.KeyDim(d, p.dims[d].cardinality)
             for d in ("dimA", "dimB")])
        rp = ref_grouping.build_projection(r, [Interval.parse(iv)], rg,
                                           rspec)
        pp = port_grouping.build_projection(p, [PortInterval.parse(iv)], pg,
                                            pspec)
        assert (pp.keys < 0).any()
        np.testing.assert_array_equal(pp.order, np.asarray(rp.order))
        np.testing.assert_array_equal(pp.keys, rp.keys)
        assert pp.max_span == rp.max_span


def test_max_block_span_ignores_dead_rows():
    """Dead rows (int32 keys, -1) never widen a block's span; a block with
    no live row counts for nothing."""
    keys = np.full(3 * 1024, -1, dtype=np.int32)
    keys[500:1024] = 70_000                  # block 0: one live key
    keys[1024:1030] = [5, 6, 7, 9, 9, 12]    # block 1: keys 5..12
    got = port_grouping._max_block_span(keys, keys >= 0)
    assert got == 8
    assert port_grouping._max_block_span(keys, keys > 100_000) == 1


@pytest.mark.parametrize("n", [0, 1, 5000])
@pytest.mark.parametrize("span", [1, 200, (1 << 16) - 1, 1 << 16, 1 << 20,
                                  (1 << 32) - 1, 1 << 40])
def test_stable_argsort_is_numpys(span, n):
    """The projection's radix argsort gives np.argsort's stable order for
    keys of every span (one 16-bit digit, two, or numpy's own sort), with
    invalid rows (-1) and many ties."""
    rng = np.random.default_rng(span % 9973 + n)
    keys = rng.integers(-1, span, size=n, dtype=np.int64)
    keys[rng.random(n) < 0.3] = -1
    if n:
        keys[0] = span - 1
    got = port_grouping.stable_argsort(keys)
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))


# ---------------------------------------------------------------------------
# (d) the batched path's selection: once per chunk, at the rung's rows
# ---------------------------------------------------------------------------

class _SelectLog:
    """Each (strategy, window) a package's selection returns, with the row
    count it selected at."""

    def __init__(self, monkeypatch, module):
        self.calls = []
        orig = module.select_strategy

        def select(spec, kernels, col_dtypes, padded_rows, windowed_w, *a,
                   **k):
            out = orig(spec, kernels, col_dtypes, padded_rows, windowed_w,
                       *a, **k)
            self.calls.append((out, padded_rows))
            return out
        monkeypatch.setattr(module, "select_strategy", select)


@pytest.fixture(scope="module")
def rung_segs():
    """Two segments of 20,000 rows: each pads to 20,480 alone and to the
    rung 32,768 in a batch. Longs from 0, so that both plan the mm limbs'
    base 0 (a negative least value is the base, and two segments that
    differ in it bucket apart, in both packages)."""
    return _segments(card_a=30, card_b=200, n=40_000, lo=0)


@pytest.mark.parametrize("dims,gran,aggs,force", [
    ((), "hour", AGGS, None),
    ((), "all", [AGGS[0], AGGS[5], DSUM], None),
    (("dimA",), "all", AGGS, None),
    (("dimA",), "hour", MM_AGGS, None),
    (("dimB",), "all", MM_AGGS, None),
    (("dimB",), "all", AGGS, "mm"),
    (("dimB",), "all", MM_AGGS, "blocked"),
    (("dimA",), "all", AGGS, "windowed"),
    (("dimA",), "all", AGGS, "projection"),
    (("dimB",), "all", [AGGS[0], AGGS[5], DSUM], "mixed"),
])
def test_batched_selection_at_the_rung_matches_reference(
        rung_segs, dims, gran, aggs, force, monkeypatch):
    monkeypatch.setattr(port_batching, "_ENABLED", True)
    monkeypatch.setattr(port_grouping, "FORCE_STRATEGY", force)
    monkeypatch.setattr(ref_grouping, "FORCE_STRATEGY", force)
    from druid_tpu.engine import batching as ref_batching
    monkeypatch.setattr(ref_batching, "_ENABLED", True)
    ref_log = _SelectLog(monkeypatch, ref_grouping)
    port_log = _SelectLog(monkeypatch, port_grouping)
    before = port_batching.stats().snapshot()["batches"]
    _both(rung_segs, _groupby(dims, aggs, gran=gran))
    assert port_log.calls == ref_log.calls
    # the chunk selects once, at the rung; a forced projection refuses the
    # stack, and both segments then select alone at their own rows
    rows = [r for _, r in port_log.calls]
    if force == "projection":
        assert rows == [32_768, 20_480, 20_480]
        assert port_batching.stats().snapshot()["batches"] == before
    else:
        assert rows == [32_768]
        assert port_batching.stats().snapshot()["batches"] == before + 1
