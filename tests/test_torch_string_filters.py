"""The port's string filters against the reference package: like (with an
escape), regex, search, an extractionFn on each type that takes one,
columnComparison and expression filters.

(a) Dictionary LUTs: every leaf's LUT equals the reference's, and planning
    with device bitmaps gives the reference's bitmap nodes (structure,
    signature, digest, leaves).
(b) Leaf words: the staged fill (run-table leaves where the dimension has
    few runs) and the fused mega leaves equal the row-built words.
(c) Rows: groupBy, topN and an hourly timeseries through both
    `QueryExecutor`s on unsorted segments, and a groupBy on the projection
    (B2 with an expression or column comparison as its residual mask); a groupBy on segments in the rollup order (run
    tables) with device bitmaps and the megakernel on and off.
(d) Errors: the reference's ValueErrors, raised by the port as well.
Counts and long sums exact.
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.engine import filters as ref_filters
from druid_tpu.engine import grouping as ref_grouping
from druid_tpu.engine import megakernel as ref_mk
from druid_tpu.engine import pallas_agg
from druid_tpu.query.filters import filter_from_json as ref_filter_json
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import filters as port_filters
from druid_tpu_torch.engine import grouping as port_grouping
from druid_tpu_torch.engine import megakernel as port_mk
from druid_tpu_torch.query.filters import filter_from_json as port_filter_json
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

IV = "2026-07-01/2026-07-02"
SCHEMA = (
    ColumnSpec("dimA", "string", cardinality=20),
    ColumnSpec("dimB", "string", cardinality=300, distribution="zipf"),
    ColumnSpec("metLong", "long", low=-500, high=9_000),
    ColumnSpec("metFloat", "float", distribution="normal", mean=10.0,
               std=400.0),
)
CPU = torch.device("cpu")

LIKE = {"type": "like", "dimension": "dimB", "pattern": "v000001%"}
LIKE_ESC = {"type": "like", "dimension": "dimA", "pattern": "v000000!1_",
            "escape": "!"}
LIKE_ONE = {"type": "like", "dimension": "dimA", "pattern": "v0000001_"}
REGEX = {"type": "regex", "dimension": "dimB", "pattern": "[13579]$"}
SEARCH = {"type": "search", "dimension": "dimA",
          "query": {"type": "contains", "value": "5"}}
SEARCH_CS = {"type": "search", "dimension": "dimB",
             "query": {"type": "contains", "value": "00001",
                       "caseSensitive": True}}
SEARCH_CI = {"type": "search", "dimension": "dimB",
             "query": {"type": "contains", "value": "V0000002"}}


def _ex(flt, fn):
    return dict(flt, extractionFn=fn)


SUBSTR = {"type": "substring", "index": 6, "length": 2}
EXTRACTED = [
    _ex({"type": "selector", "dimension": "dimA", "value": "1"},
        {"type": "regex", "expr": "0*([1-9][0-9]*)$"}),
    _ex({"type": "in", "dimension": "dimB", "values": ["00", "01", "12"]},
        SUBSTR),
    _ex({"type": "bound", "dimension": "dimB", "lower": "V00000100",
         "upper": "V00000150", "upperStrict": True}, {"type": "upper"}),
    _ex({"type": "bound", "dimension": "dimB", "lower": "5", "upper": "20",
         "ordering": "numeric"}, {"type": "substring", "index": 6}),
    _ex({"type": "like", "dimension": "dimA", "pattern": "x%"},
        {"type": "lookup", "lookup": {"type": "map", "map": {
            "v00000003": "x3", "v00000007": "x7"}},
            "retainMissingValue": True}),
    _ex({"type": "regex", "dimension": "dimB", "pattern": "^3$"},
        {"type": "cascade", "extractionFns": [
            {"type": "lookup", "lookup": {"type": "map", "map": {
                "v00000003": "abc", "v00000005": "abcd"}},
             "retainMissingValue": True}, {"type": "strlen"}]}),
    _ex({"type": "search", "dimension": "dimA",
         "query": {"type": "contains", "value": "[v0000001"}},
        {"type": "stringFormat", "format": "[%s]"}),
    _ex({"type": "selector", "dimension": "dimA", "value": "01"},
        {"type": "cascade", "extractionFns": [
            {"type": "upper"}, {"type": "substring", "index": 7},
            {"type": "lower"}]}),
]
COLCMP = {"type": "columnComparison", "dimensions": ["dimA", "dimB"]}
EXPR = {"type": "expression",
        "expression": "metLong % 10 < 7 && dimA != 'v00000004'"}
EXPR_TIME = {"type": "expression",
             "expression": "timestamp_extract(__time, 'HOUR') >= 12 "
                           "|| strlen(dimB) > 9"}

LEAVES = [LIKE, LIKE_ESC, LIKE_ONE, REGEX, SEARCH, SEARCH_CS,
          SEARCH_CI] + EXTRACTED

FILTERS = {
    "like": LIKE, "like-escape": LIKE_ESC, "regex": REGEX,
    "search": SEARCH, "search-case": SEARCH_CS,
    **{f"extraction-{i}": f for i, f in enumerate(EXTRACTED)},
    "and-mixed": {"type": "and", "fields": [
        {"type": "in", "dimension": "dimA",
         "values": [f"v{i:08d}" for i in range(0, 20, 2)]}, REGEX, EXPR]},
    "or-mixed": {"type": "or", "fields": [SEARCH, {
        "type": "not", "field": LIKE}]},
    "colcmp": COLCMP, "not-colcmp": {"type": "not", "field": COLCMP},
    "expression": EXPR, "expression-time": EXPR_TIME,
}


def _segments(sort_by_dims):
    ref = DataGenerator(SCHEMA, seed=91).segments(
        2, 8_192, Interval.parse(IV), datasource="sf",
        sort_by_dims=sort_by_dims)
    return ref, [_carry(s) for s in ref]


@pytest.fixture(scope="module")
def unsorted():
    return _segments(False)


@pytest.fixture(scope="module")
def rollup():
    return _segments(True)


# ---------------------------------------------------------------------------
# (a) LUTs and bitmap planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(LEAVES)))
def test_leaf_lut_matches_reference(unsorted, i):
    ref, port = unsorted
    j = LEAVES[i]
    rf, pf = ref_filter_json(j), port_filter_json(j)
    dim = j["dimension"]
    want = ref_filters._dictionary_lut(ref[0].dims[dim].dictionary,
                                       ref_filters._string_predicate(rf))
    got = port_filters._dictionary_lut(port[0].dims[dim].dictionary,
                                       port_filters._string_predicate(pf))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size, "the leaf must split the dictionary"


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_bitmap_planning_matches_reference(unsorted, name):
    ref, port = unsorted
    j = FILTERS[name]
    prev = ref_filters.set_device_bitmap_enabled(True)
    try:
        rn = ref_filters.simplify_node(ref_filters.plan_filter(
            ref_filter_json(j), ref[0]))
        ref_filters.assign_bitmap_slots(rn, [])
    finally:
        ref_filters.set_device_bitmap_enabled(prev)
    pn = port_filters.plan_filter(port_filter_json(j), port[0],
                                  device_bitmap=True)
    rb = ref_filters.collect_bitmap_nodes(rn)
    pb = port_filters.collect_bitmap_nodes(pn)
    assert [(b.slot, b.structure, b.structure_sig(), b.digest())
            for b in rb] == [(b.slot, b.structure, b.structure_sig(),
                              b.digest()) for b in pb]
    # the residual nodes B2 would take as its row mask
    rm = ref_mk.megaize(rn, ref[0], port[0].padded_rows())
    pm = port_mk.megaize(pn, port[0], port[0].padded_rows(), CPU)
    (rmeg, rres), (pmeg, pres) = (ref_mk.split_for_kernel(rm),
                                  port_mk.split_for_kernel(pm))
    assert len(rmeg) == len(pmeg)
    assert type(rres).__name__ == type(pres).__name__


def test_expression_conjunct_is_the_residual_mask(unsorted):
    """and(in, regex, expression): the two bitmap leaves fuse (B2's words),
    the expression stays the residual row mask."""
    _, port = unsorted
    pn = port_filters.plan_filter(port_filter_json(FILTERS["and-mixed"]),
                                  port[0], device_bitmap=True)
    megas, residual = port_mk.split_for_kernel(
        port_mk.megaize(pn, port[0], port[0].padded_rows(), CPU))
    assert [len(m.leaves) for m in megas] == [1, 1]
    assert isinstance(residual, port_filters.ExpressionNode)


# ---------------------------------------------------------------------------
# (b) leaf words
# ---------------------------------------------------------------------------

def _row_words(seg, dim, lut, padded):
    return port_filters.host_words(
        port_filters.leaf_bits(seg, dim, lut, padded))


@pytest.mark.parametrize("order", ["unsorted", "rollup"])
def test_fill_and_mega_leaf_words_equal_row_built(unsorted, rollup, order):
    _, port = unsorted if order == "unsorted" else rollup
    seg = port[0]
    padded = seg.padded_rows()
    runs = 0
    for j in LEAVES:
        node = port_filters.plan_filter(port_filter_json(j), seg,
                                        device_bitmap=True)
        assert isinstance(node, port_filters.DeviceBitmapNode)
        (dim, lut), = node.leaves
        want = _row_words(seg, dim, lut, padded)
        filled = port_filters._fill_single(seg, node, padded, CPU)
        assert np.array_equal(filled.numpy(), want), j
        mega = port_mk.mega_leaf_words(seg, dim, lut, padded, CPU)
        assert np.array_equal(mega.numpy(), want), j
        runs += port_filters._run_leaf_payload(seg, dim, lut,
                                               padded) is not None
    # the rollup order gives dimA run tables, and its leaves use them
    assert (runs > 0) == (order == "rollup")


# ---------------------------------------------------------------------------
# (c) rows
# ---------------------------------------------------------------------------

AGGS = [{"type": "count", "name": "rows"},
        {"type": "longSum", "name": "lsum", "fieldName": "metLong"},
        {"type": "longMax", "name": "lmax", "fieldName": "metLong"}]


def _queries(flt):
    base = {"dataSource": "sf", "intervals": [IV], "aggregations": AGGS,
            "filter": flt}
    return {
        "groupBy": dict(base, queryType="groupBy", granularity="all",
                        dimensions=["dimA", "dimB"]),
        "topN": dict(base, queryType="topN", granularity="all",
                     dimension="dimB", metric="lsum", threshold=20),
        "timeseries": dict(base, queryType="timeseries",
                           granularity="hour"),
    }


def _run_both(segs, queries):
    ref, port = segs
    for kind, q in queries.items():
        want = RefExecutor(ref).run_json(q)
        got = PortExecutor(port, device="cpu").run_json(q)
        assert got == want, kind
        if kind == "groupBy":
            assert want


@pytest.fixture
def projection(monkeypatch):
    """Projection at a 0-row floor: B1/B2 (plain versions here) and the
    reference's Pallas kernels in interpret mode."""
    monkeypatch.setattr(ref_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(port_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(pallas_agg, "_FORCE_INTERPRET", True)


#: filters whose groupBy also runs on the projection (B1/B2 plain here,
#: the reference's Pallas kernels in interpret mode): B2's residual row
#: mask is an expression or a column comparison
PROJECTED = ("and-mixed", "not-colcmp", "expression", "like",
             "extraction-4")


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_rows_match_reference(unsorted, name, monkeypatch):
    """Every filter, device bitmaps and the megakernel on (the default):
    groupBy, topN and an hourly timeseries."""
    qs = _queries(FILTERS[name])
    _run_both(unsorted, qs)
    if name in PROJECTED:
        monkeypatch.setattr(ref_grouping, "PROJECTION_MIN_ROWS", 0)
        monkeypatch.setattr(port_grouping, "PROJECTION_MIN_ROWS", 0)
        monkeypatch.setattr(pallas_agg, "_FORCE_INTERPRET", True)
        _run_both(unsorted, {"groupBy": qs["groupBy"]})


@pytest.mark.parametrize("mode", ["mega", "staged", "rows"])
@pytest.mark.parametrize("name", ["like-escape", "extraction-2",
                                  "and-mixed", "not-colcmp",
                                  "expression-time"])
def test_rows_match_reference_in_rollup_order(rollup, name, mode,
                                              projection):
    """Rollup-order segments (run tables: staged fill and mega leaves from
    runs), with the fused path, the staged combined words and the row
    domain."""
    bitmap, mega = mode != "rows", mode == "mega"
    prev = (ref_filters.set_device_bitmap_enabled(bitmap),
            port_filters.set_device_bitmap_enabled(bitmap),
            ref_mk.set_enabled(mega), port_mk.set_enabled(mega))
    try:
        _run_both(rollup, {"groupBy": _queries(FILTERS[name])["groupBy"]})
    finally:
        ref_filters.set_device_bitmap_enabled(prev[0])
        port_filters.set_device_bitmap_enabled(prev[1])
        ref_mk.set_enabled(prev[2])
        port_mk.set_enabled(prev[3])


# ---------------------------------------------------------------------------
# (d) errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("j,where", [
    (_ex(COLCMP, {"type": "upper"}), "json"),
    (_ex({"type": "interval", "dimension": "__time",
          "intervals": [IV]}, {"type": "upper"}), "json"),
    (_ex({"type": "expression", "expression": "1"}, {"type": "upper"}),
     "json"),
    (_ex({"type": "selector", "dimension": "metLong", "value": "1"},
         {"type": "upper"}), "plan"),
    (_ex({"type": "bound", "dimension": "__time", "lower": "1"},
         {"type": "upper"}), "plan"),
    ({"type": "columnComparison", "dimensions": ["dimA", "metLong"]},
     "plan"),
    ({"type": "expression", "expression": "dimA + 1 > 0"}, "plan"),
    ({"type": "regex", "dimension": "metLong", "pattern": "1"}, "plan"),
    ({"type": "nosuch", "dimension": "dimA"}, "json"),
], ids=["exfn-colcmp", "exfn-interval", "exfn-expression",
        "exfn-numeric", "exfn-time", "colcmp-numeric", "expr-string-dim",
        "regex-numeric", "unknown-type"])
def test_value_errors_match_reference(unsorted, j, where):
    ref, port = unsorted
    for parse, seg, plan in (
            (ref_filter_json, ref[0],
             lambda f, s: ref_filters.plan_filter(f, s)),
            (port_filter_json, port[0],
             lambda f, s: port_filters.plan_filter(f, s))):
        if where == "json":
            with pytest.raises(ValueError):
                parse(j)
        else:
            flt = parse(j)
            with pytest.raises(ValueError):
                plan(flt, seg)


def test_unported_filter_types_raise():
    """Spatial parses as the reference's; "javascript" has no JSON branch in
    either package (a ValueError, as any unknown type)."""
    j = {"type": "spatial", "dimension": "dimA",
         "bound": {"type": "radius", "coords": [1.0, 2.0], "radius": 3.0}}
    assert port_filter_json(j).to_json() == ref_filter_json(j).to_json()
    for parse in (ref_filter_json, port_filter_json):
        with pytest.raises(ValueError):
            parse({"type": "javascript", "dimension": "dimA"})
