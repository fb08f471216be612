"""The port's HyperLogLog (engine/hll.py, HllKernel, the cardinality and
hyperUnique aggregators) against the reference package.

(a) Hashing and registers, bit for bit: splitmix64 and register_of over
    int64 bit patterns on edge hashes (0, 1, 2^63, 2^64 - 1, hashes whose
    rest is 0) and 10^5 random ones, against the reference's numpy and its
    jitted device functions; string hashes; numeric hashing (a float's
    float64 bits, so -0.0 and 0.0 differ).
(b) update_registers and estimate_array against the reference's.
(c) Queries through both `QueryExecutor`s: cardinality by value and byRow
    over 1-3 fields (a dimension, a FLOAT and a LONG column, __time), a
    missing field, log2m 11 and 12, hyperUnique over a register column
    built by the reference's IncrementalIndex rollup, and
    hyperUniqueCardinality. Estimates are exact (the same registers give the
    same float64).
(d) __time hashes its offset from the segment's interval start, in both
    packages: the same instants in two segments with different starts count
    twice.
(e) The reference's two ValueErrors (byRow over a register column, a log2m
    mismatch) are the port's.
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import jax.numpy as jnp
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.engine import hll as ref_hll
from druid_tpu.ingest import IncrementalIndex
from druid_tpu.query.aggregators import (CountAggregator,
                                         HyperUniqueAggregator)
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import hll as port_hll
from tests.test_torch_slice import _carry, _compare

# One intra-op thread: these tensors are small, and an OpenMP pool in every
# test worker would compete for cores with the suite's timing tests.
torch.set_num_threads(1)

IV = "2026-07-01/2026-07-02"
SCHEMA = (
    ColumnSpec("dimA", "string", cardinality=12),
    ColumnSpec("dimB", "string", cardinality=400, distribution="zipf"),
    ColumnSpec("metLong", "long", low=-300, high=3_000),
    ColumnSpec("metFloat", "float", distribution="normal", mean=0.0,
               std=50.0),
)


def _bits(u64: np.ndarray) -> torch.Tensor:
    """uint64 hashes as the port holds them: int64 bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(u64).view(np.int64))


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _edge_hashes(log2m: int) -> np.ndarray:
    m = 1 << log2m
    edges = [0, 1, 2, 2**63, 2**64 - 1, 2**63 - 1, m - 1, m, m + 1,
             (2**64 - 1) ^ (m - 1), 1 << 63 | (m - 1), 5 << log2m]
    rng = np.random.default_rng(log2m)
    rand = rng.integers(0, 2**64 - 1, 100_000, dtype=np.uint64,
                        endpoint=True)
    return np.concatenate([np.asarray(edges, dtype=np.uint64), rand])


# ---------------------------------------------------------------------------
# (a) hashing and registers
# ---------------------------------------------------------------------------

def test_splitmix64_matches_reference():
    h = _edge_hashes(11)
    want = ref_hll._splitmix64_np(h)
    assert np.array_equal(port_hll._splitmix64_np(h), want)
    assert np.array_equal(_u64(port_hll.splitmix64(_bits(h))), want)
    dev = np.asarray(ref_hll.splitmix64_device(jnp.asarray(h)))
    assert np.array_equal(dev, want)


@pytest.mark.parametrize("log2m", [4, 11, 12, 16])
def test_register_of_matches_reference(log2m):
    h = _edge_hashes(log2m)
    want_reg, want_rho = ref_hll.hash_to_register(h, log2m)
    reg, rho = port_hll.register_of(_bits(h), log2m)
    assert reg.dtype == rho.dtype == torch.int32
    assert np.array_equal(reg.numpy(), want_reg)
    assert np.array_equal(rho.numpy(), want_rho)
    dreg, drho = ref_hll.register_of_device(jnp.asarray(h), log2m)
    assert np.array_equal(np.asarray(dreg), want_reg)
    assert np.array_equal(np.asarray(drho), want_rho)
    hreg, hrho = port_hll.hash_to_register(h, log2m)
    assert np.array_equal(hreg, want_reg) and np.array_equal(hrho, want_rho)
    # the edges: a zero rest gives 65 - log2m, the top bit set gives 1
    assert rho[0].item() == 65 - log2m
    assert rho[3].item() == 1 and rho[4].item() == 1


def test_string_hashes_match_reference():
    vals = ["", "a", "é", "v00000001", "x" * 300, "中文", "0", "-0"]
    assert np.array_equal(port_hll.hash_strings(vals),
                          ref_hll.hash_strings(vals))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32,
                                   np.float64])
def test_numeric_hashes_match_reference(dtype):
    rng = np.random.default_rng(7)
    if np.issubdtype(dtype, np.floating):
        v = np.concatenate([[0.0, -0.0, np.inf, -np.inf, 1e-300],
                            rng.normal(0, 1e6, 5000)]).astype(dtype)
        want = ref_hll._splitmix64_np(v.astype(np.float64).view(np.uint64))
    else:
        info = np.iinfo(dtype)
        v = np.concatenate([[0, -1, info.min, info.max],
                            rng.integers(info.min, info.max, 5000)]
                           ).astype(dtype)
        want = ref_hll._splitmix64_np(v.astype(np.int64).astype(np.uint64))
    got = _u64(port_hll.hash_numeric(torch.from_numpy(v)))
    assert np.array_equal(got, want)
    if np.issubdtype(dtype, np.floating):
        assert got[0] != got[1]           # -0.0 and 0.0 differ


# ---------------------------------------------------------------------------
# (b) update_registers, estimate_array
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("log2m", [6, 11])
def test_update_registers_matches_reference(log2m):
    rng = np.random.default_rng(log2m)
    n, num = 20_000, 37
    h = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    keys = rng.integers(0, num, n)
    mask = rng.random(n) < 0.7
    reg, rho = ref_hll.hash_to_register(h, log2m)
    prior = rng.integers(0, 20, (num, 1 << log2m)).astype(np.int32)
    for start in (None, prior):
        want = np.asarray(ref_hll.update_registers(
            None if start is None else jnp.asarray(start), jnp.asarray(rho),
            jnp.asarray(reg), jnp.asarray(keys.astype(np.int32)),
            jnp.asarray(mask), num, log2m))
        got = port_hll.update_registers(
            None if start is None else torch.from_numpy(start),
            torch.from_numpy(rho), torch.from_numpy(reg),
            torch.from_numpy(keys), torch.from_numpy(mask), num, log2m)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("log2m", [4, 11, 12])
def test_estimate_matches_reference(log2m):
    m = 1 << log2m
    rng = np.random.default_rng(log2m)
    grids = [np.zeros((3, m), np.int32),
             rng.integers(0, 3, (5, m)).astype(np.int32),
             rng.integers(0, 30, (5, m)).astype(np.int32),
             np.full((2, m), 60, np.int32)]
    with np.errstate(invalid="ignore"):   # the all-60 grids: NaN in both
        for g in grids:
            assert np.array_equal(port_hll.estimate_array(g, log2m),
                                  ref_hll.estimate_array(g, log2m),
                                  equal_nan=True)
            for row in g:
                assert np.array_equal(port_hll.estimate(row, log2m),
                                      ref_hll.estimate(row, log2m),
                                      equal_nan=True)


# ---------------------------------------------------------------------------
# (c) queries
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def segs():
    ref = DataGenerator(SCHEMA, seed=21).segments(
        2, 6_000, Interval.parse(IV), datasource="ds")
    return ref, [_carry(s) for s in ref]


def _both(ref_segs, port_segs, q):
    want = RefExecutor(ref_segs).run_json(q)
    got = PortExecutor(port_segs, device="cpu").run_json(q)
    _compare(want, got)
    return want


CARD = {
    "dim": {"fields": ["dimB"]},
    "dim_round": {"fields": ["dimB"], "round": True},
    "two_dims": {"fields": ["dimA", "dimB"]},
    "byrow_two_dims": {"fields": ["dimA", "dimB"], "byRow": True},
    "byrow_three": {"fields": ["dimA", "metLong", "metFloat"],
                    "byRow": True, "round": True},
    "float": {"fields": ["metFloat"]},
    "long": {"fields": ["metLong"]},
    "time": {"fields": ["__time"]},
    "byrow_time": {"fields": ["__time", "dimA"], "byRow": True},
    "missing": {"fields": ["nope"]},
    "byrow_missing": {"fields": ["nope"], "byRow": True},
    "byrow_dim_missing": {"fields": ["dimA", "nope"], "byRow": True},
}


@pytest.mark.parametrize("log2m", [11, 12])
@pytest.mark.parametrize("card", sorted(CARD))
def test_cardinality_matches_reference(segs, card, log2m):
    agg = dict(CARD[card], type="cardinality", name="c", log2m=log2m)
    aggs = [{"type": "count", "name": "rows"}, agg]
    for q in (
            {"queryType": "timeseries", "granularity": "hour"},
            {"queryType": "groupBy", "granularity": "all",
             "dimensions": ["dimA"]},
            {"queryType": "topN", "granularity": "all", "dimension": "dimA",
             "metric": "c", "threshold": 5}):
        q = dict(q, dataSource="ds", intervals=[IV], aggregations=aggs)
        rows = _both(*segs, q)
        assert rows


def test_hyperunique_on_columns_and_postagg(segs):
    q = {"queryType": "groupBy", "dataSource": "ds", "intervals": [IV],
         "granularity": "all", "dimensions": ["dimA"],
         "aggregations": [
             {"type": "hyperUnique", "name": "u", "fieldName": "dimB"},
             {"type": "hyperUnique", "name": "ul", "fieldName": "metLong",
              "log2m": 12, "round": True}],
         "postAggregations": [
             {"type": "hyperUniqueCardinality", "name": "pu",
              "fieldName": "u"},
             {"type": "arithmetic", "name": "ratio", "fn": "/",
              "fields": [{"type": "hyperUniqueCardinality",
                          "fieldName": "u", "name": "a"},
                         {"type": "fieldAccess", "fieldName": "ul"}]}],
         "limitSpec": {"type": "default", "limit": 7, "columns": [
             {"dimension": "u", "direction": "descending"}]}}
    rows = _both(*segs, q)
    assert len(rows) == 7
    assert all(r["event"]["pu"] == r["event"]["u"] for r in rows)


def _rolled_up(log2m, n_seg=2):
    """Segments with an ingest-time hyperUnique register column (int8
    [n, 2^log2m]) from the reference's rollup at hour granularity."""
    specs = [CountAggregator("count"),
             HyperUniqueAggregator("uu", "user", log2m=log2m)]
    iv = Interval.parse(IV)
    rng = np.random.default_rng(log2m)
    out = []
    for p in range(n_seg):
        idx = IncrementalIndex("hll", iv, specs, dimensions=["d"],
                               query_granularity="hour")
        for i in range(900):
            idx.add({"timestamp": iv.start + int(rng.integers(0, 86_400_000)),
                     "d": f"x{i % 7}", "user": f"u{rng.integers(0, 300)}"})
        out.append(idx.to_segment(partition=p))
    return out


@pytest.mark.parametrize("log2m", [6, 11])
def test_hyperunique_over_register_columns(log2m):
    ref = _rolled_up(log2m)
    assert ref[0].metrics["uu"].values.ndim == 2
    port = [_carry(s) for s in ref]
    assert port[0].metrics["uu"].values.shape == ref[0].metrics["uu"] \
        .values.shape
    hu = {"type": "hyperUnique", "name": "u", "fieldName": "uu",
          "log2m": log2m}
    for q in (
            {"queryType": "groupBy", "granularity": "all",
             "dimensions": ["d"], "aggregations": [
                 hu, {"type": "longSum", "name": "n", "fieldName": "count"}],
             "filter": {"type": "not", "field": {
                 "type": "selector", "dimension": "d", "value": "x0"}}},
            {"queryType": "timeseries", "granularity": "hour",
             "aggregations": [hu, dict(hu, name="r", round=True)]},
            {"queryType": "groupBy", "granularity": "all",
             "dimensions": ["d"], "aggregations": [
                 {"type": "filtered", "aggregator": hu, "filter": {
                     "type": "selector", "dimension": "d", "value": "x3"}}]}):
        q = dict(q, dataSource="hll", intervals=[IV])
        assert _both(ref, port, q)


def test_register_column_errors_match_reference():
    ref = _rolled_up(6)
    port = [_carry(s) for s in ref]
    for agg in ({"type": "cardinality", "name": "c", "fields": ["uu"],
                 "byRow": True, "log2m": 6},
                {"type": "hyperUnique", "name": "u", "fieldName": "uu",
                 "log2m": 11}):
        q = {"queryType": "timeseries", "dataSource": "hll",
             "intervals": [IV], "granularity": "all", "aggregations": [agg]}
        with pytest.raises(ValueError) as want:
            RefExecutor(ref).run_json(q)
        with pytest.raises(ValueError) as got:
            PortExecutor(port, device="cpu").run_json(q)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# (d) __time hashes its offset from the interval start
# ---------------------------------------------------------------------------

def test_time_hashes_the_offset_from_the_interval_start():
    gen = DataGenerator(SCHEMA, seed=4)
    a = gen.segment(3_000, Interval.parse(IV), datasource="t")
    # the same rows in a segment whose interval starts 12 hours earlier
    b = gen.segment(3_000, Interval.parse(IV), datasource="t")
    b.time_ms[:] = a.time_ms
    from druid_tpu.data.segment import Segment, SegmentId
    b = Segment(SegmentId("t", Interval.parse(
        "2026-06-30T12:00/2026-07-02"), "v1", 1), b.time_ms, b.dims,
        b.metrics)
    ref = [a, b]
    port = [_carry(s) for s in ref]
    q = {"queryType": "timeseries", "dataSource": "t", "intervals": [
        "2026-06-30T12:00/2026-07-02"], "granularity": "all",
         "aggregations": [{"type": "cardinality", "name": "c",
                           "fields": ["__time"], "round": True}]}
    both = _both(ref, port, q)[0]["result"]["c"]
    one = _both(ref[:1], port[:1], q)[0]["result"]["c"]
    distinct = len(np.unique(a.time_ms))
    assert abs(one - distinct) < 0.05 * distinct
    # the same instants count again under the second segment's offsets
    assert both > 1.8 * one
