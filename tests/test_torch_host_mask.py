"""The port's `host_mask` against the reference's, leaf by leaf.

`host_mask` is the row mask of the non-aggregate engines (scan, select,
search, timeBoundary). Its semantics differ from the aggregate planner's in
places (the int/float conversion of numeric bounds, a selector on a missing
column, columnComparison through merged dictionaries, expression filters
over decoded strings), so the port keeps the reference's, leaf by leaf, as
a bool tensor on the query's device. Two segments of 3,000 rows (the
reference's DataGenerator, seed 42, plus a "loc" dimension of "x,y"
coordinate strings and a NaN in metFloat), carried into the port as plain
arrays; every filter below gives the same mask in both packages, also under
not(), and with virtual columns. The masks must be equal bit for bit.
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.dictionary import Dictionary as RefDictionary
from druid_tpu.data.segment import StringDimColumn as RefDimColumn
from druid_tpu.engine.filters import evaluate_filter_on_row as ref_on_row
from druid_tpu.engine.filters import host_mask as ref_host_mask
from druid_tpu.query import filter_from_json as ref_filter_json
from druid_tpu.query.model import virtualcolumn_from_json as ref_vc_json

from druid_tpu_torch.engine import filters as port_filters
from druid_tpu_torch.query.filters import JavaScriptFilter
from druid_tpu_torch.query.filters import filter_from_json as port_filter_json
from druid_tpu_torch.query.model import virtualcolumn_from_json as port_vc_json
from tests.test_torch_native_queries import make_segments
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

T0 = 1767225600000          # 2026-01-01


@pytest.fixture(scope="module")
def segs():
    ref, _ = make_segments(2, 3_000)
    rng = np.random.default_rng(3)
    for s in ref:
        xy = rng.uniform(-5, 5, (s.n_rows, 2)).round(1)
        loc = np.asarray([f"{x},{y}" for x, y in xy], dtype=object)
        loc[::97] = ""
        d = RefDictionary.from_values(loc)
        s.dims["loc"] = RefDimColumn(d.encode(loc), d)
        s.metrics["metFloat"].values[11] = np.nan
    return ref, [_carry(s) for s in ref]


def _value(segs, name, i):
    """The string of a metric's value in segment 0, row i."""
    return repr(float(segs[0][0].metrics[name].values[i])) \
        if name != "metLong" else str(int(segs[0][0].metrics[name].values[i]))


def _filters(segs):
    ref = segs[0][0]
    t = int(ref.time_ms[1234])
    f_val = _value(segs, "metFloat", 5)
    d_val = _value(segs, "metDouble", 7)
    sel = lambda d, v: {"type": "selector", "dimension": d, "value": v}
    bound = lambda d, lo=None, hi=None, **kw: dict(
        {"type": "bound", "dimension": d, "lower": lo, "upper": hi,
         "ordering": "numeric"}, **kw)
    return {
        "dim_selector": sel("dimA", "v00000003"),
        "dim_selector_null": sel("dimA", None),
        "dim_in": {"type": "in", "dimension": "dimB",
                   "values": ["v00000001", "v00000005", "nope"]},
        "dim_bound_lex": {"type": "bound", "dimension": "dimB",
                          "lower": "v00000010", "upper": "v00000030",
                          "upperStrict": True},
        "dim_bound_numeric": bound("dimB", "5", "50"),
        "dim_like": {"type": "like", "dimension": "dimB",
                     "pattern": "v%1_"},
        "dim_regex": {"type": "regex", "dimension": "dimA",
                      "pattern": "[2468]$"},
        "dim_search": {"type": "search", "dimension": "dimB", "query": {
            "type": "contains", "value": "V0000001"}},
        "dim_extraction": {"type": "selector", "dimension": "dimB",
                           "value": "8",
                           "extractionFn": {"type": "substring",
                                            "index": 8}},
        "spatial_rect": {"type": "spatial", "dimension": "loc", "bound": {
            "type": "rectangular", "minCoords": [-2, -1],
            "maxCoords": [3, 4.5]}},
        "spatial_radius": {"type": "spatial", "dimension": "loc", "bound": {
            "type": "radius", "coords": [1, 1], "radius": 2.5}},
        "spatial_polygon": {"type": "spatial", "dimension": "loc", "bound": {
            "type": "polygon", "abscissa": [-4, 4, 0],
            "ordinate": [-4, -4, 4]}},
        "missing_selector_null": sel("nosuch", None),
        "missing_selector_empty": sel("nosuch", ""),
        "missing_selector_value": sel("nosuch", "x"),
        "missing_bound": bound("nosuch", "1"),
        "long_selector": sel("metLong", _value(segs, "metLong", 3)),
        "long_in": {"type": "in", "dimension": "metLong",
                    "values": ["3", "17", str(2**40), None]},
        "long_bound": bound("metLong", "10", "60", lowerStrict=True),
        "long_bound_outside_int32": bound("metLong", str(-2**40),
                                          str(2**40)),
        "long_bound_above_int32": bound("metLong", str(2**33)),
        "float_selector": sel("metFloat", f_val),
        "float_in": {"type": "in", "dimension": "metFloat",
                     "values": [f_val, "10.5"]},
        "float_bound": bound("metFloat", "9.5", "11.25", upperStrict=True),
        "double_selector": sel("metDouble", d_val),
        "double_in": {"type": "in", "dimension": "metDouble",
                      "values": [d_val]},
        "double_bound": bound("metDouble", "0.25", "0.5"),
        "time_selector": sel("__time", str(t)),
        "time_in": {"type": "in", "dimension": "__time",
                    "values": [str(t), str(t + 1), "0"]},
        "time_bound": bound("__time", str(T0 + 3_600_000),
                            str(T0 + 86_400_000 + 60_000)),
        "time_bound_far": bound("__time", "0", str(2**62)),
        "interval": {"type": "interval", "dimension": "__time", "intervals": [
            "2026-01-01T03:00:00Z/2026-01-01T04:00:00Z",
            "2026-01-02T00:00:00Z/2026-01-05T00:00:00Z"]},
        "column_comparison": {"type": "columnComparison",
                              "dimensions": ["dimA", "dimB"]},
        "expression_string_dim": {
            "type": "expression",
            "expression": "dimA == 'v00000003' || (metLong > 50 && "
                          "dimB < 'v00000020')"},
        "expression_numeric": {"type": "expression",
                               "expression": "metLong % 7 == 2"},
        "vc_long_bound": bound("vl", "100", "300"),
        "vc_double_selector": sel("vd", "1.5"),
        "vc_bool_bound": bound("vb", "0.5"),
        "vc_string_dim_in": {"type": "in", "dimension": "vs",
                             "values": ["1", "7"]},
        "and_or": {"type": "and", "fields": [
            {"type": "or", "fields": [sel("dimA", "v00000001"),
                                      bound("metLong", None, "20")]},
            {"type": "not", "field": sel("dimB", "v00000000")}]},
        "constants": {"type": "or", "fields": [{"type": "false"}, {
            "type": "and", "fields": [{"type": "true"},
                                      sel("dimA", "v00000002")]}]},
    }


VCS = [{"type": "expression", "name": "vl", "expression": "metLong * 5",
        "outputType": "long"},
       {"type": "expression", "name": "vd", "expression": "metLong * 0.5",
        "outputType": "double"},
       {"type": "expression", "name": "vb", "expression": "metLong > 40",
        "outputType": "long"},
       {"type": "expression", "name": "vs",
        "expression": "dimA == 'v00000004'", "outputType": "long"}]


def _masks(segs, j, negate=False):
    if negate:
        j = {"type": "not", "field": j}
    rf, pf = ref_filter_json(j), port_filter_json(j)
    rv = [ref_vc_json(v) for v in VCS]
    pv = [port_vc_json(v) for v in VCS]
    out = []
    for r, p in zip(*segs):
        want = ref_host_mask(rf, r, rv)
        got = port_filters.host_mask(pf, p, pv, torch.device("cpu"))
        assert got.dtype == torch.bool and got.shape == (p.n_rows,)
        out.append((want, got.numpy()))
    return out


#: leaves whose outcome is the same on every row of this data
CONSTANT = {"dim_selector_null", "dim_bound_numeric",
            "long_bound_outside_int32", "long_bound_above_int32",
            "time_bound_far", "missing_selector_null",
            "missing_selector_empty", "missing_selector_value",
            "missing_bound"}
FILTER_NAMES = [
    "dim_selector", "dim_selector_null", "dim_in", "dim_bound_lex",
    "dim_bound_numeric", "dim_like", "dim_regex", "dim_search",
    "dim_extraction", "spatial_rect", "spatial_radius", "spatial_polygon",
    "missing_selector_null", "missing_selector_empty",
    "missing_selector_value", "missing_bound", "long_selector", "long_in",
    "long_bound", "long_bound_outside_int32", "long_bound_above_int32",
    "float_selector", "float_in", "float_bound", "double_selector",
    "double_in", "double_bound", "time_selector", "time_in", "time_bound",
    "time_bound_far", "interval", "column_comparison",
    "expression_string_dim", "expression_numeric", "vc_long_bound",
    "vc_double_selector", "vc_bool_bound", "vc_string_dim_in", "and_or",
    "constants"]


@pytest.mark.parametrize("negate", [False, True], ids=["as_is", "negated"])
@pytest.mark.parametrize("name", FILTER_NAMES)
def test_host_mask_matches_reference(segs, name, negate):
    j = _filters(segs)[name]
    pairs = _masks(segs, j, negate)
    for want, got in pairs:
        np.testing.assert_array_equal(got, want)
    if not negate and name not in CONSTANT:
        # the leaf selects some rows and not all of them somewhere
        hits = sum(int(w.sum()) for w, _ in pairs)
        assert 0 < hits < sum(len(w) for w, _ in pairs), name


def test_every_filter_is_listed(segs):
    assert sorted(FILTER_NAMES) == sorted(_filters(segs))


def test_host_mask_with_intervals_and_columns(segs):
    """masked_columns ANDs the intervals in and hands back the staged
    columns it was computed beside."""
    _, port = segs
    seg = port[1]
    flt = port_filter_json({"type": "selector", "dimension": "dimA",
                            "value": "v00000006"})
    from druid_tpu_torch.utils.intervals import Interval
    ivs = [Interval.of("2026-01-01T06:00:00", "2026-01-02T06:00:00")]
    mask, cols = port_filters.masked_columns(flt, seg, (),
                                             torch.device("cpu"), ivs,
                                             ["dimB"])
    t = seg.time_ms
    want = (seg.dims["dimA"].ids == seg.dims["dimA"].dictionary.id_of(
        "v00000006")) & (t >= ivs[0].start) & (t < ivs[0].end)
    np.testing.assert_array_equal(mask.numpy(), want)
    np.testing.assert_array_equal(cols["dimB"].numpy(), seg.dims["dimB"].ids)
    np.testing.assert_array_equal(cols["__time_offset"].numpy(),
                                  t - seg.interval.start)


def test_javascript_filter_is_a_lut_leaf(segs):
    ref, port = segs
    flt = JavaScriptFilter("dimB", lambda v: v.endswith("7"))
    got = port_filters.host_mask(flt, port[0], (), torch.device("cpu"))
    vals = np.asarray(port[0].dims["dimB"].dictionary.values)[
        port[0].dims["dimB"].ids]
    np.testing.assert_array_equal(got.numpy(),
                                  np.char.endswith(vals.astype(str), "7"))
    node = port_filters.plan_filter(flt, port[0], device_bitmap=False)
    assert isinstance(node, port_filters.LutNode)


ROWS = [{"dimA": "v00000003", "n": 12, "s": 40.5, "none": None},
        {"dimA": "v00000004", "n": 3, "s": -1.0, "none": None}]


@pytest.mark.parametrize("j", [
    {"type": "selector", "dimension": "dimA", "value": "v00000003"},
    {"type": "bound", "dimension": "n", "lower": "5", "ordering": "numeric"},
    {"type": "bound", "dimension": "s", "upper": "10", "upperStrict": True,
     "ordering": "numeric"},
    {"type": "selector", "dimension": "none", "value": ""},
    {"type": "in", "dimension": "n", "values": ["3", "4"]},
    {"type": "and", "fields": [
        {"type": "regex", "dimension": "dimA", "pattern": "3$"},
        {"type": "not", "field": {"type": "selector", "dimension": "n",
                                  "value": "3"}}]},
], ids=["selector", "bound", "bound_strict", "null", "in", "and_not"])
def test_evaluate_filter_on_row_matches_reference(j):
    for row in ROWS:
        assert port_filters.evaluate_filter_on_row(port_filter_json(j), row) \
            == ref_on_row(ref_filter_json(j), row)
