"""Expression virtual columns in the port against the reference package.

Segments: tests/test_torch_slice.py's schema (negative longs, a zipf
dimension) with a NaN in metFloat, 2 segments of 4,000 rows. Each query
names virtual columns (float, long and double outputs; string-dimension
sites; `__time`), aggregates them and filters on them, and runs through both
`QueryExecutor`s under every FORCE_STRATEGY value of both packages, with the
projection's row floor at 0 and the reference's Pallas kernels in interpret
mode (the port's B1/B2 take their plain versions on the CPU).

Two oracles:
  * the reference with the same virtual columns;
  * the reference over the same values materialized as metric columns (each
    virtual column evaluated by the reference's evaluator over the
    segment's staged columns and cast to its output dtype).
The port must match the reference with virtual columns wherever that one
runs, and the materialized oracle where it does not and under the natural
selection. Where it does not (REF_FAILS), the
test checks that it indeed fails. The reference plans a virtual column as a
missing column: with a DOUBLE virtual sum it can select mm, and then raises
at trace time, or its Pallas kernel, which then has no op and falls back to
its windowed strategy; that strategy sums the float64 column through its
integer path. The port plans the same, but takes mm and kernel B1 only
where the computed column's dtype allows them.

Counts and long sums exact; float sums within 1e-5 * sum|v| per row; float
min/max of a virtual column within 1e-6 relative (XLA may contract a*b+c
into an FMA, torch does not).
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
from druid_tpu.engine import pallas_agg
from druid_tpu.utils import expression as ref_expr
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import grouping as port_grouping
from druid_tpu_torch.engine import sorted_reduce
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
FORCES = [None, "mm", "blocked", "windowed", "projection", "mixed"]

VF = {"type": "expression", "name": "vf",
      "expression": "metFloat * 2 + metLong", "outputType": "float"}
VABS = {"type": "expression", "name": "vabs",
        "expression": "abs(metFloat * 2 + metLong)", "outputType": "float"}
VL = {"type": "expression", "name": "vl", "expression": "metLong * 3 - 7",
      "outputType": "long"}
VD = {"type": "expression", "name": "vd", "expression": "metLong * 0.01",
      "outputType": "double"}
VS = {"type": "expression", "name": "vs",
      "expression": "if(dimA == 'v00000003' || strlen(dimB) > 8, metLong, 0)",
      "outputType": "long"}
VH = {"type": "expression", "name": "vh",
      "expression": "timestamp_extract(__time, 'HOUR') * 100 + metLong % 7",
      "outputType": "long"}


def _agg(kind, name, field=None):
    a = {"type": kind, "name": name}
    if field:
        a["fieldName"] = field
    return a


#: name -> (virtual columns, dimensions, aggregators, filter); the float sum
#: `vfsum` takes its tolerance from `vfabs`
QUERIES = {
    "float-2d": ([VF, VABS], ["dimA", "dimB"], [
        _agg("count", "rows"), _agg("longSum", "lsum", "metLong"),
        _agg("floatMax", "vfmax", "vf"), _agg("floatMin", "vfmin", "vf"),
        _agg("floatSum", "vfsum", "vf"), _agg("floatSum", "vfabs", "vabs")],
        {"type": "bound", "dimension": "vf", "lower": "-1000",
         "ordering": "numeric"}),
    "float-1d": ([VF, VABS], ["dimB"], [
        _agg("count", "rows"), _agg("floatSum", "vfsum", "vf"),
        _agg("floatSum", "vfabs", "vabs"), _agg("floatMax", "vfmax", "vf")],
        {"type": "expression", "expression": "vf > 0 && metLong % 3 != 1"}),
    "long-1d": ([VL, VS], ["dimA"], [
        _agg("count", "rows"), _agg("longSum", "vlsum", "vl"),
        _agg("longMax", "vlmax", "vl"), _agg("longSum", "vssum", "vs")],
        {"type": "bound", "dimension": "vl", "upper": "20000",
         "ordering": "numeric"}),
    "long-2d": ([VL], ["dimA", "dimB"], [
        _agg("count", "rows"), _agg("longSum", "vlsum", "vl"),
        _agg("longMin", "vlmin", "vl")],
        {"type": "selector", "dimension": "dimA", "value": "V00000002",
         "extractionFn": {"type": "upper"}}),
    "double-2d": ([VD], ["dimA", "dimB"], [
        _agg("count", "rows"), _agg("doubleSum", "vdsum", "vd"),
        _agg("doubleMax", "vdmax", "vd")],
        {"type": "not", "field": {"type": "columnComparison",
                                  "dimensions": ["dimA", "dimB"]}}),
    "double-a": ([VD], ["dimA"], [
        _agg("count", "rows"), _agg("doubleSum", "vdsum", "vd")],
        {"type": "in", "dimension": "dimB",
         "values": [f"v{i:08d}" for i in range(0, 300, 3)]}),
    "double-1d": ([VD, VH], ["dimB"], [
        _agg("count", "rows"), _agg("doubleSum", "vdsum", "vd"),
        _agg("longMax", "vhmax", "vh")], None),
    "timeseries": ([VF, VABS, VH], None, [
        _agg("count", "rows"), _agg("floatSum", "vfsum", "vf"),
        _agg("floatSum", "vfabs", "vabs"), _agg("longMax", "vhmax", "vh")],
        {"type": "bound", "dimension": "vh", "lower": "300",
         "ordering": "numeric"}),
}
FLOAT_SUMS = {"vfsum": "vfabs", "vfabs": "vfabs"}
#: float min/max of a virtual column: within 1e-6 relative
FLOAT_EXTREMA = {"vfmax", "vfmin"}
#: sums of a DOUBLE virtual column: the reference's order against the
#: port's, within 1e-9 relative (|vd| <= 90, a few thousand rows)
DOUBLE_SUMS = {"vdsum"}

#: (query, force) where the reference with virtual columns does not give
#: the rows: "raises" = its trace-time assertion (mm selected for a DOUBLE
#: virtual sum, which has no mm plan); "sums wrong" = its windowed strategy,
#: taken directly or as the fallback when its Pallas kernel has no op for a
#: DOUBLE virtual sum, sums the float64 column through its integer path
REF_FAILS = {
    ("double-a", "mm"): "raises",
    ("double-a", "windowed"): "sums wrong",
    ("double-a", "projection"): "sums wrong",
    ("double-1d", "windowed"): "sums wrong",
    ("double-1d", "projection"): "sums wrong",
    **{("double-2d", f): "sums wrong" for f in FORCES if f != "mixed"},
}


@pytest.fixture(scope="module")
def segs():
    ref, mat = (DataGenerator(SCHEMA, seed=77).segments(
        2, 4_000, Interval.parse(IV), datasource="ds") for _ in range(2))
    for s, m in zip(ref, mat):
        s.metrics["metFloat"].values[13] = np.nan
        m.metrics["metFloat"].values[13] = np.nan
        _materialize(s, m)
    return ref, mat, [_carry(s) for s in ref]


def _materialize(seg, out):
    """Every virtual column of QUERIES as a metric of `out`, evaluated by
    the reference's evaluator over `seg`'s columns in their staged dtypes."""
    bindings = {"__time": jnp.asarray(seg.time_ms)}
    for name, m in seg.metrics.items():
        bindings[name] = jnp.asarray(m.values.astype(seg.staged_dtype(name)))
    types = {"long": (np.int64, ValueType.LONG),
             "double": (np.float64, ValueType.DOUBLE),
             "float": (np.float32, ValueType.FLOAT)}
    for vc in (VF, VABS, VL, VD, VS, VH):
        expr, sites = ref_expr.rewrite_string_sites(
            ref_expr.parse_expression(vc["expression"]), frozenset(seg.dims))
        b = dict(bindings)
        b.update({d: jnp.asarray(seg.dims[d].ids) for d in seg.dims})
        b["__luts"] = [jnp.asarray(ref_expr.lut_for_site(
            s, seg.dims[s[0]].dictionary.values)) for s in sites]
        dt, vt = types[vc["outputType"]]
        vals = np.broadcast_to(np.asarray(expr.evaluate(b)), (seg.n_rows,))
        out.metrics[vc["name"]] = NumericColumn(vals.astype(dt), vt)


def _query(name, with_vcs=True):
    vcs, dims, aggs, flt = QUERIES[name]
    q = {"dataSource": "ds", "intervals": [IV], "granularity": "all",
         "aggregations": aggs, "filter": flt}
    if with_vcs:
        q["virtualColumns"] = vcs
    if dims is None:
        q.update(queryType="timeseries", granularity="hour")
    else:
        q.update(queryType="groupBy", dimensions=dims)
    return q


def _values(r, p, where):
    assert set(r) == set(p), where
    for k, rv in r.items():
        pv = p[k]
        if k in FLOAT_SUMS and not np.isnan(rv):
            assert abs(pv - rv) <= 1e-5 * abs(r[FLOAT_SUMS[k]]), (where, k)
        elif k in DOUBLE_SUMS:
            assert pv == pytest.approx(rv, rel=1e-9, abs=1e-9), (where, k)
        elif k in FLOAT_EXTREMA and not np.isnan(rv):
            assert pv == pytest.approx(rv, rel=1e-6), (where, k, rv, pv)
        elif isinstance(rv, float) and np.isnan(rv):
            assert np.isnan(pv), (where, k)
        else:
            assert pv == rv and type(pv) is type(rv), (where, k, rv, pv)


def _compare(want, got):
    assert len(want) == len(got)
    for i, (r, p) in enumerate(zip(want, got)):
        assert r["timestamp"] == p["timestamp"], i
        _values(r.get("event", r.get("result")),
                p.get("event", p.get("result")), i)


def _force(monkeypatch, force):
    monkeypatch.setattr(ref_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(port_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(pallas_agg, "_FORCE_INTERPRET", True)
    # the reference latches Pallas off after a kernel it cannot build (a
    # DOUBLE virtual sum); the latch must not outlive the test
    monkeypatch.setattr(pallas_agg, "_BROKEN", None)
    monkeypatch.setattr(ref_grouping, "FORCE_STRATEGY", force)
    monkeypatch.setattr(port_grouping, "FORCE_STRATEGY", force)


@pytest.mark.parametrize("force", FORCES, ids=lambda f: f or "natural")
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_virtual_columns_match_reference(segs, name, force, monkeypatch):
    ref, mat, port = segs
    _force(monkeypatch, force)
    got = PortExecutor(port, device="cpu").run_json(_query(name))
    fails = REF_FAILS.get((name, force))
    if fails or force is None:
        want_mat = RefExecutor(mat).run_json(_query(name, with_vcs=False))
        assert want_mat
        _compare(want_mat, got)
    if fails == "raises":
        with pytest.raises(AssertionError, match="no mm plan at trace time"):
            RefExecutor(ref).run_json(_query(name))
        return
    want = RefExecutor(ref).run_json(_query(name))
    if fails == "sums wrong":
        with pytest.raises(AssertionError):
            _compare(want, got)
        return
    _compare(want, got)


def test_projection_reads_the_virtual_column_dense(segs, monkeypatch):
    """Forced projection on the float query: B1 runs (its plain version
    here), the virtual column is evaluated over the permuted block and read
    dense, and the staged block is the one the same query stages without
    the virtual column (its key and pack descriptor do not change)."""
    _, _, port = segs
    _force(monkeypatch, "projection")
    seen = []
    orig = sorted_reduce.sorted_reduce

    def spy(arrays, mask, key, kernels, num_total, span, packed_cols=None):
        seen.append((arrays["vf"].dtype, tuple(arrays["vf"].shape),
                     sorted(packed_cols or {})))
        return orig(arrays, mask, key, kernels, num_total, span,
                    packed_cols=packed_cols)
    monkeypatch.setattr(sorted_reduce, "sorted_reduce", spy)
    q = _query("float-2d")
    q["filter"] = {"type": "bound", "dimension": "metLong", "lower": "0",
                   "ordering": "numeric"}
    PortExecutor(port, device="cpu").run_json(q)
    monkeypatch.setattr(sorted_reduce, "sorted_reduce", orig)
    padded = port[0].padded_rows()
    assert seen == [(torch.float32, (padded,), ["metLong"])] * 2
    blocks = [k for k in port[0].device_entries() if k[0] == "block"]
    plain = dict(q, virtualColumns=[], aggregations=[
        _agg("count", "rows"), _agg("longSum", "lsum", "metLong"),
        _agg("floatMax", "fmax", "metFloat")])
    PortExecutor(port, device="cpu").run_json(plain)
    assert [k for k in port[0].device_entries() if k[0] == "block"] == blocks


@pytest.mark.parametrize("out_type,dtype", [
    ("long", torch.int64), ("double", torch.float64),
    ("float", torch.float32), ("string", torch.float64)])
def test_virtual_column_dtypes(segs, out_type, dtype):
    """outputType decides the computed column's dtype, whatever torch's
    promotion gives (metLong * 0.5 is float64 in the reference, where torch
    alone would give float32)."""
    _, _, port = segs
    seg = port[0]
    from druid_tpu_torch.query.model import ExpressionVirtualColumn
    vcs = [ExpressionVirtualColumn("v", "metLong * 0.5 + 1", out_type),
           ExpressionVirtualColumn("c", "3", out_type)]
    plans, luts = port_grouping.plan_virtual_columns(seg, vcs)
    block = seg.device_block(["metLong"], torch.device("cpu"))
    arrays = port_grouping.eval_virtual_columns(dict(block.arrays),
                                                seg.interval.start, plans,
                                                luts)
    for name in ("v", "c"):
        assert arrays[name].dtype == dtype
        assert arrays[name].shape == (block.padded_rows,)
    ml = seg.metrics["metLong"].values
    np.testing.assert_array_equal(
        arrays["v"][:seg.n_rows].numpy(),
        (ml.astype(np.int32) * 0.5 + 1).astype(
            str(dtype).replace("torch.", "")))


def test_string_dimension_outside_a_comparison_raises(segs):
    _, _, port = segs
    q = _query("long-1d")
    q["virtualColumns"] = [{"type": "expression", "name": "bad",
                            "expression": "dimA + 1", "outputType": "long"}]
    with pytest.raises(ValueError, match="string dimension"):
        PortExecutor(port, device="cpu").run_json(q)
