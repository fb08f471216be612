"""The fused bitmap-filter path end to end, port against reference.

Segments come from the reference's DataGenerator and cross into the port as
plain arrays. Filtered queries run through both `QueryExecutor`s with
device bitmaps and the megakernel on (both packages' defaults):
  * groupBys on the sorted projection (PROJECTION_MIN_ROWS patched to 0 in
    both, the reference's Pallas kernels in interpret mode): the reference
    takes its "megakernel" strategy and the port runs kernel B2's plain
    version; rows agree under the B1 rule (counts, long sums, min/max exact,
    float sums within 1e-5 * sum|v| per group);
  * a dozen random filter trees on a timeseries (the blocked strategy in
    both packages, the mega nodes expand to bools): rows agree exactly, and
    the count equals the reference's numpy host-mask count.
The port against itself: the fused path, the staged path (megakernel off)
and the row path (device bitmaps off) give the same rows, floats included.
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.data.segment import NumericColumn, ValueType
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.engine import filters as ref_filters
from druid_tpu.engine import grouping as ref_grouping
from druid_tpu.engine import megakernel as ref_mk
from druid_tpu.engine import pallas_agg
from druid_tpu.engine.filters import host_mask
from druid_tpu.query import filters as F
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import batching as port_batching
from druid_tpu_torch.engine import filters as port_filters
from druid_tpu_torch.engine import grouping as port_grouping
from druid_tpu_torch.engine import megakernel as port_mk
from druid_tpu_torch.engine import sorted_reduce
from tests.test_torch_slice import _carry, _compare

# One intra-op thread: these tensors are small, and an OpenMP pool in every
# test worker would compete for cores with the suite's timing tests.
torch.set_num_threads(1)

IV = Interval.of("2026-05-01", "2026-05-05")


@pytest.fixture(autouse=True)
def _defaults_on():
    """Both packages' defaults (device bitmaps and the megakernel on),
    restored after each test."""
    prev = (ref_mk.set_enabled(True),
            ref_filters.set_device_bitmap_enabled(True),
            port_mk.set_enabled(True),
            port_filters.set_device_bitmap_enabled(True))
    yield
    ref_mk.set_enabled(prev[0])
    ref_filters.set_device_bitmap_enabled(prev[1])
    port_mk.set_enabled(prev[2])
    port_filters.set_device_bitmap_enabled(prev[3])


# ---------------------------------------------------------------------------
# the projection groupBy: reference "megakernel" strategy vs port B2
# ---------------------------------------------------------------------------

PROJ_SCHEMA = (        # tests/test_megakernel.py::_proj_setup
    ColumnSpec("dimA", "string", cardinality=30),
    ColumnSpec("dimB", "string", cardinality=200, distribution="zipf"),
    ColumnSpec("metLong", "long", low=-500, high=9000),
    ColumnSpec("metFloat", "float", distribution="normal", mean=10.0,
               std=400.0),
)


def _proj_segments(seed=77):
    ref = DataGenerator(PROJ_SCHEMA, seed=seed).segments(2, 20000, IV,
                                                         datasource="pj")
    for s in ref:
        s.metrics["absFloat"] = NumericColumn(
            np.abs(s.metrics["metFloat"].values), ValueType.FLOAT)
    return ref, [_carry(s) for s in ref]


@pytest.fixture(scope="module")
def proj_segs():
    return _proj_segments()


def _proj_filters(seg):
    vals = list(seg.dims["dimA"].dictionary.values)
    head = seg.dims["dimB"].dictionary.values[
        int(np.bincount(seg.dims["dimB"].ids).argmax())]
    in_a = {"type": "in", "dimension": "dimA", "values": vals[:20]}
    return {
        "in": in_a,                    # the reference's _proj_setup filter
        "dashboard": {"type": "and", "fields": [
            {"type": "in", "dimension": "dimA", "values": vals[0:30:2]},
            {"type": "not", "field": {"type": "selector",
                                      "dimension": "dimB", "value": head}},
            {"type": "bound", "dimension": "metLong", "lower": "100",
             "upper": "8000", "ordering": "numeric"}]},
    }


def _proj_query(flt):
    return {"queryType": "groupBy", "dataSource": "pj",
            "intervals": [str(IV)], "granularity": "all",
            "dimensions": ["dimA", "dimB"],
            "aggregations": [
                {"type": "count", "name": "rows"},
                {"type": "longSum", "name": "lsum", "fieldName": "metLong"},
                {"type": "floatSum", "name": "fsum", "fieldName": "metFloat"},
                {"type": "floatSum", "name": "fabs",
                 "fieldName": "absFloat"},
                {"type": "longMin", "name": "lmin", "fieldName": "metLong"},
                {"type": "floatMax", "name": "fmax",
                 "fieldName": "metFloat"}],
            "filter": flt}


@pytest.mark.parametrize("which", ["in", "dashboard"])
def test_projection_groupby_takes_b2_and_matches_reference(
        proj_segs, which, monkeypatch):
    ref_segs, port_segs = proj_segs
    monkeypatch.setattr(ref_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(port_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(pallas_agg, "_FORCE_INTERPRET", True)
    seen = []
    orig = ref_grouping.fuse_filter_update

    def spy(*a, **k):
        seen.append(k.get("strategy"))
        return orig(*a, **k)
    monkeypatch.setattr(ref_grouping, "fuse_filter_update", spy)
    q = _proj_query(_proj_filters(ref_segs[0])[which])
    want = RefExecutor(ref_segs).run_json(q)
    assert "megakernel" in seen, seen
    before = (sorted_reduce.PLAIN_CALLS, port_mk.PLAIN_CALLS)
    got = PortExecutor(port_segs, device="cpu").run_json(q)
    assert (sorted_reduce.PLAIN_CALLS - before[0],
            port_mk.PLAIN_CALLS - before[1]) == (0, 2)   # B2 per segment
    assert len(want) > 100
    _compare(want, got)


def test_mega_staged_and_row_paths_agree_exactly():
    """The three paths reduce the same mask bits in the same order: B2 on
    words, B1 on the staged words' bit test, B1 on the row-domain mask."""
    q = _proj_query(_proj_filters(_proj_segments()[0][0])["dashboard"])
    prev = port_grouping.PROJECTION_MIN_ROWS
    port_grouping.PROJECTION_MIN_ROWS = 0
    try:
        # fresh segments: a staged run caches combined words on its segment
        port_segs = _proj_segments()[1]
        s0 = port_mk.stats().snapshot()
        b2 = port_mk.PLAIN_CALLS
        fused = PortExecutor(port_segs, device="cpu").run_json(q)
        assert port_mk.PLAIN_CALLS - b2 == 2
        assert port_mk.stats().snapshot()["hits"] - s0["hits"] == 4
        f0 = port_filters.filter_bitmap_stats().snapshot()
        b1 = sorted_reduce.PLAIN_CALLS
        port_mk.set_enabled(False)
        staged = PortExecutor(port_segs, device="cpu").run_json(q)
        assert sorted_reduce.PLAIN_CALLS - b1 == 2
        f1 = port_filters.filter_bitmap_stats().snapshot()
        assert f1["misses"] - f0["misses"] == 4
        # megakernel on again: the cached combined words keep the bit test
        port_mk.set_enabled(True)
        s1 = port_mk.stats().snapshot()
        cached = PortExecutor(port_segs, device="cpu").run_json(q)
        assert port_mk.stats().snapshot()["fallbacks"] \
            - s1["fallbacks"] == 4
        assert port_filters.filter_bitmap_stats().snapshot()["hits"] \
            - f1["hits"] == 4
        port_filters.set_device_bitmap_enabled(False)
        rowpath = PortExecutor(port_segs, device="cpu").run_json(q)
    finally:
        port_grouping.PROJECTION_MIN_ROWS = prev
    assert fused and fused == staged == cached == rowpath


def test_filter_only_dimension_is_not_staged(proj_segs):
    """A dimension that only the filter names stays on the host: the
    bitmap node reads words, not the column."""
    _, port_segs = proj_segs
    seg = port_segs[0]
    q = {"queryType": "timeseries", "dataSource": "pj",
         "intervals": [str(IV)], "granularity": "all",
         "aggregations": [{"type": "count", "name": "n"}],
         "filter": _proj_filters(seg)["in"]}
    PortExecutor([seg], device="cpu").run_json(q)
    blocks = [k for k in seg.device_entries() if k[0] == "block"]
    assert blocks and all("dimA" not in k[1] for k in blocks)


# ---------------------------------------------------------------------------
# random filter trees on a timeseries (blocked strategy)
# ---------------------------------------------------------------------------

TREE_SCHEMA = (        # tests/test_megakernel.py
    ColumnSpec("dLo", "string", cardinality=8),
    ColumnSpec("dMid", "string", cardinality=60),
    ColumnSpec("dHi", "string", cardinality=800),
    ColumnSpec("metLong", "long", low=0, high=1000),
)


@pytest.fixture(scope="module")
def tree_segs():
    # 3333 rows: n % 32 != 0, so word-boundary rows are exercised
    ref = DataGenerator(TREE_SCHEMA, seed=21).segments(2, 3333, IV,
                                                       datasource="mk")
    return ref, [_carry(s) for s in ref]


def _rand_leaf(rng, seg):        # tests/test_megakernel.py::_rand_leaf
    dim = ("dLo", "dMid", "dHi")[rng.integers(3)]
    vals = list(seg.dims[dim].dictionary.values)
    kind = rng.integers(3)
    if kind == 0:
        v = vals[rng.integers(len(vals))] if rng.random() < 0.85 \
            else "zzz-missing"
        return F.SelectorFilter(dim, v)
    if kind == 1:
        k = int(rng.integers(1, 5))
        return F.InFilter(dim, tuple(vals[rng.integers(len(vals))]
                                     for _ in range(k)))
    lo = vals[rng.integers(len(vals))]
    hi = vals[rng.integers(len(vals))]
    lo, hi = (lo, hi) if lo <= hi else (hi, lo)
    return F.BoundFilter(dim, lower=lo, upper=hi,
                         lower_strict=bool(rng.integers(2)))


def _rand_tree(rng, seg, depth):  # tests/test_megakernel.py::_rand_tree
    if depth == 0 or rng.random() < 0.35:
        return _rand_leaf(rng, seg)
    op = rng.integers(3)
    if op == 0:
        return F.NotFilter(_rand_tree(rng, seg, depth - 1))
    kids = tuple(_rand_tree(rng, seg, depth - 1)
                 for _ in range(int(rng.integers(2, 4))))
    return F.AndFilter(kids) if op == 1 else F.OrFilter(kids)


def _tree_query(flt):
    return {"queryType": "timeseries", "dataSource": "mk",
            "intervals": [str(IV)], "granularity": "all",
            "aggregations": [
                {"type": "count", "name": "n"},
                {"type": "longSum", "name": "s", "fieldName": "metLong"},
                {"type": "longMin", "name": "lo", "fieldName": "metLong"},
                {"type": "longMax", "name": "hi", "fieldName": "metLong"}],
            "filter": flt.to_json()}


@pytest.mark.parametrize("i", range(12))
def test_random_tree_matches_reference_and_numpy(tree_segs, i, monkeypatch):
    ref_segs, port_segs = tree_segs
    # the per-segment megakernel path, which batching bypasses for these
    # shape-compatible segments (tests/test_torch_batching.py runs the
    # trees batched)
    monkeypatch.setattr(port_batching, "_ENABLED", False)
    rng = np.random.default_rng(1000 + i)
    flt = _rand_tree(rng, ref_segs[0], depth=3 if i % 2 else 2)
    q = _tree_query(flt)
    want = RefExecutor(ref_segs).run_json(q)
    s0 = port_mk.stats().snapshot()["hits"]
    got = PortExecutor(port_segs, device="cpu").run_json(q)
    assert port_mk.stats().snapshot()["hits"] > s0   # fused, expanded
    assert got == want, flt
    n = sum(int(host_mask(flt, s).sum()) for s in ref_segs)
    assert (got[0]["result"]["n"] if got else 0) == n


def test_random_trees_mega_staged_row_agree():
    """Fresh segments per path, so that each path runs cold."""
    rng = np.random.default_rng(7)
    ref = DataGenerator(TREE_SCHEMA, seed=23).segments(2, 3333, IV,
                                                       datasource="mk")
    flts = [_rand_tree(rng, ref[0], depth=3) for _ in range(6)]
    out = []
    for mega, bitmap in ((True, True), (False, True), (True, False)):
        port_mk.set_enabled(mega)
        port_filters.set_device_bitmap_enabled(bitmap)
        ex = PortExecutor([_carry(s) for s in ref], device="cpu")
        out.append([ex.run_json(_tree_query(f)) for f in flts])
    assert out[0] == out[1] == out[2]
