"""Spatial filters in the port: the cases of the reference's
tests/test_spatial.py (its ingest case waits for the port's ingestion).

One segment of 4,000 rows built by each package's SegmentBuilder from the
same columns: a "loc" dimension of "x,y" coordinate strings (numpy, seed
12) and a "city" dimension. A spatial filter tests its bound once per
dictionary value, so it plans as an ordinary LUT leaf: the counts must
equal numpy's on the coordinates and the reference's rows, through the row
program, the device-bitmap fill and the megakernel alike, and through
groupBy and scan.
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.segment import SegmentBuilder as RefBuilder
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.utils.intervals import Interval, parse_ts

from druid_tpu_torch.data.segment import SegmentBuilder as PortBuilder
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import filters as port_filters
from druid_tpu_torch.engine import grouping as port_grouping
from druid_tpu_torch.engine import megakernel
from druid_tpu_torch.query.filters import (PolygonBound, RadiusBound,
                                           RectangularBound, SpatialFilter,
                                           filter_from_json)
from druid_tpu_torch.utils.intervals import Interval as PortInterval
from tests.test_torch_native_queries import same

torch.set_num_threads(1)

DAY = "2026-06-01/2026-06-02"
T0 = parse_ts("2026-06-01")


@pytest.fixture(scope="module")
def geo():
    rng = np.random.default_rng(12)
    n = 4000
    xs = rng.uniform(-10, 10, n).round(3)
    ys = rng.uniform(-10, 10, n).round(3)
    cols = (np.asarray([T0 + i for i in range(n)], dtype=np.int64),
            {"loc": [f"{x},{y}" for x, y in zip(xs, ys)],
             "city": [f"c{i % 5}" for i in range(n)]},
            {"m": np.ones(n, dtype=np.int64)})
    segs = []
    for builder, iv in ((RefBuilder, Interval), (PortBuilder, PortInterval)):
        b = builder("geo", iv.parse(DAY))
        b.add_columns(*cols)
        segs.append(b.build())
    return segs, xs, ys


def _count(seg, flt_json, executor=PortExecutor, **kw):
    q = {"queryType": "timeseries", "dataSource": "geo", "intervals": [DAY],
         "aggregations": [{"type": "count", "name": "n"}],
         "filter": flt_json}
    rows = executor([seg], **kw).run_json(q)
    return rows[0]["result"]["n"] if rows else 0


def _polygon_truth(xs, ys, vx, vy):
    inside = np.zeros(len(xs), dtype=bool)
    j = len(vx) - 1
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(len(vx)):
            cond = ((vy[i] > ys) != (vy[j] > ys)) & \
                (xs < (vx[j] - vx[i]) * (ys - vy[i]) / (vy[j] - vy[i])
                 + vx[i])
            inside ^= cond
            j = i
    return inside


BOUNDS = {
    "rectangular": {"type": "rectangular", "minCoords": [-5.0, -2.0],
                    "maxCoords": [5.0, 8.0]},
    "radius": {"type": "radius", "coords": [1.0, 1.0], "radius": 4.0},
    "polygon": {"type": "polygon", "abscissa": [-8.0, 8.0, 0.0],
                "ordinate": [-8.0, -8.0, 8.0]},
}


def _truth(name, xs, ys):
    if name == "rectangular":
        return (xs >= -5) & (xs <= 5) & (ys >= -2) & (ys <= 8)
    if name == "radius":
        return (xs - 1) ** 2 + (ys - 1) ** 2 <= 16.0
    return _polygon_truth(xs, ys, [-8.0, 8.0, 0.0], [-8.0, -8.0, 8.0])


@pytest.mark.parametrize("path", ["row", "bitmap", "megakernel"])
@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_spatial_bound(geo, name, path, monkeypatch):
    """The row program, the staged bitmap fill, and the megakernel (the
    projection forced: kernel B2's plain version here) give numpy's
    count."""
    (ref, port), xs, ys = geo
    monkeypatch.setattr(port_filters, "_DEVICE_BITMAP", path != "row")
    if path == "megakernel":
        monkeypatch.setattr(port_grouping, "PROJECTION_MIN_ROWS", 0)
        monkeypatch.setattr(port_grouping, "FORCE_STRATEGY", "projection")
    prev = megakernel.set_enabled(path == "megakernel")
    calls = megakernel.PLAIN_CALLS
    try:
        flt = {"type": "spatial", "dimension": "loc",
               "bound": BOUNDS[name]}
        want = int(_truth(name, xs, ys).sum())
        assert want > 0
        assert _count(port, flt, device="cpu") == want
        assert (megakernel.PLAIN_CALLS > calls) == (path == "megakernel")
        assert _count(ref, flt, RefExecutor) == want
    finally:
        megakernel.set_enabled(prev)


def test_spatial_plans_as_a_lut_leaf(geo):
    (_, port), _, _ = geo
    flt = filter_from_json({"type": "spatial", "dimension": "loc",
                            "bound": BOUNDS["radius"]})
    node = port_filters.plan_filter(flt, port, device_bitmap=False)
    assert isinstance(node, port_filters.LutNode)
    bitmap = port_filters.plan_filter(flt, port, device_bitmap=True)
    assert isinstance(bitmap, port_filters.DeviceBitmapNode)


def test_spatial_composes_with_other_filters(geo):
    (ref, port), xs, ys = geo
    flt = {"type": "and", "fields": [
        {"type": "spatial", "dimension": "loc", "bound": {
            "type": "rectangular", "minCoords": [-5.0, -5.0],
            "maxCoords": [5.0, 5.0]}},
        {"type": "selector", "dimension": "city", "value": "c1"}]}
    city = np.asarray([f"c{i % 5}" for i in range(len(xs))])
    want = int(((xs >= -5) & (xs <= 5) & (ys >= -5) & (ys <= 5)
                & (city == "c1")).sum())
    assert _count(port, flt, device="cpu") == want
    # groupBy and scan share the predicate machinery
    gb = {"queryType": "groupBy", "dataSource": "geo", "intervals": [DAY],
          "dimensions": ["city"],
          "aggregations": [{"type": "count", "name": "n"}], "filter": flt}
    rows = PortExecutor([port], device="cpu").run_json(gb)
    assert sum(r["event"]["n"] for r in rows) == want
    same(RefExecutor([ref]).run_json(gb), rows)
    scan = {"queryType": "scan", "dataSource": "geo", "intervals": [DAY],
            "columns": ["loc"], "filter": flt}
    batches = PortExecutor([port], device="cpu").run_json(scan)
    assert sum(len(b["events"]) for b in batches) == want
    same(RefExecutor([ref]).run_json(scan), batches)


def test_spatial_filter_json_roundtrip():
    for bound in (RectangularBound((0.0, 0.0), (1.0, 2.0)),
                  RadiusBound((3.0, 4.0), 5.0),
                  PolygonBound((0.0, 1.0, 1.0), (0.0, 0.0, 1.0))):
        flt = SpatialFilter("loc", bound)
        assert filter_from_json(flt.to_json()) == flt
    with pytest.raises(ValueError):
        filter_from_json({"type": "spatial", "dimension": "loc",
                          "bound": {"type": "hexagon"}})


def test_spatial_bounds_refuse_other_dimensionality():
    assert not RectangularBound((0.0,), (1.0,)).contains((0.5, 0.5))
    assert not RadiusBound((0.0, 0.0), 1.0).contains((0.0,))
    assert not PolygonBound((0.0, 1.0, 1.0), (0.0, 0.0, 1.0)).contains(
        (0.5, 0.1, 0.0))
    pred = SpatialFilter("loc", RadiusBound((0.0, 0.0), 1.0)) \
        .value_predicate()
    assert pred("0.5,0.5") and not pred("") and not pred("a,b")
