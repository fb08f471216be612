"""The port's mesh (druid_tpu_torch/parallel/) against the reference's.

tests/test_distributed.py's twelve cases, each run three ways on the same
seeded segments and query JSON: through the reference under its mesh of 8
virtual CPU devices (tests/conftest.py), through the port on
make_mesh(8, device="cpu") (8 CPU shards), and through the port without a
mesh. Counts, long sums, min/max, first/last and sketch estimates must be
equal bit for bit across the three, and float sums within 1e-5 * sum|v|
per group (the summed columns are non-negative, so sum|v| is the sum
itself). An eligible query makes one `sharded` dispatch; the fall-back
cases (different dictionaries, a filter or metric column in some segments
only, a numeric dimension) make none and still answer the same rows.

Also the mesh cases of tests/test_strategies.py (forced mm and windowed on
a 2-shard mesh), tests/test_timeseries.py (a virtual column over a string
dimension), tests/test_jit_cache.py (a repeated query builds its stacked
run once) and tests/test_devicepool.py (stacked bytes count against the
pool's budget), and the mesh surface itself: make_mesh, the layout's
split, the cache keys, release_device_caches, DataNode(mesh=) behind the
broker, ShardedMonitor and initialize_multihost.
"""
import collections

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.generator import DataGenerator
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.parallel import make_mesh as ref_make_mesh
from druid_tpu.parallel import use_mesh as ref_use_mesh
from tests.conftest import TEST_SCHEMA

from druid_tpu_torch.data import devicepool
from druid_tpu_torch.data.segment import SegmentBuilder
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import (batching, grouping,
                                    release_device_caches)
from druid_tpu_torch.obs import dispatch
from druid_tpu_torch.parallel import (context, distributed, make_mesh,
                                      speclayout, use_mesh)
from druid_tpu_torch.utils.intervals import Interval
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

WEEK = "2026-01-01/2026-01-08"
DAY1 = "2026-01-01/2026-01-02"

AGGS = [{"type": "count", "name": "rows"},
        {"type": "longSum", "name": "lsum", "fieldName": "metLong"},
        {"type": "doubleSum", "name": "dsum", "fieldName": "metDouble"},
        {"type": "longMin", "name": "lmin", "fieldName": "metLong"},
        {"type": "doubleMax", "name": "dmax", "fieldName": "metFloat"}]
#: the float sum: within 1e-5 * |sum| (metDouble is non-negative)
FLOAT_SUMS = {"dsum"}


def _mesh8():
    return make_mesh(8, device="cpu")


def _same(want, got, where=()):
    """Equal rows: every value exact and of the same type, except the float
    sums (FLOAT_SUMS) within 1e-5 of their magnitude."""
    if isinstance(want, dict):
        assert list(want) == list(got), where
        for k in want:
            if k in FLOAT_SUMS and isinstance(want[k], float):
                assert isinstance(got[k], float), (where, k)
                assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), \
                    (where, k, want[k], got[k])
            else:
                _same(want[k], got[k], where + (k,))
    elif isinstance(want, list):
        assert len(want) == len(got), where
        for i, (a, b) in enumerate(zip(want, got)):
            _same(a, b, where + (i,))
    elif isinstance(want, float) and np.isnan(want):
        assert isinstance(got, float) and np.isnan(got), where
    else:
        assert got == want and type(got) is type(want), (where, want, got)


def _three(ref_segs, port_segs, q, sharded=True):
    """(reference under its mesh, port on 8 CPU shards, port without a
    mesh); the mesh run made one `sharded` dispatch (or none, for a
    fall-back case) and the three agree."""
    with ref_use_mesh(ref_make_mesh()):
        ref = RefExecutor(ref_segs).run_json(q)
    before = distributed.sharded_stats().snapshot()
    d0 = dispatch.stats().snapshot().get("sharded", 0)
    got = PortExecutor(port_segs, device="cpu", mesh=_mesh8()).run_json(q)
    after = distributed.sharded_stats().snapshot()
    assert after[0] - before[0] == int(sharded), (before, after)
    assert dispatch.stats().snapshot().get("sharded", 0) - d0 == int(sharded)
    if sharded:
        assert after[1] - before[1] == len(port_segs)
    plain = PortExecutor(port_segs, device="cpu").run_json(q)
    _same(ref, got)
    _same(plain, got)
    return ref, got, plain


@pytest.fixture(scope="module")
def segs(segments):
    """conftest's 4 segments over 4 days (shared dictionaries), and the
    port's copies."""
    return segments, [_carry(s) for s in segments]


def _timeseries(aggs, gran, flt=None, ds="test", iv=WEEK):
    return {"queryType": "timeseries", "dataSource": ds, "intervals": [iv],
            "granularity": gran, "aggregations": aggs, "filter": flt}


# ---------------------------------------------------------------------------
# tests/test_distributed.py, case by case
# ---------------------------------------------------------------------------

def test_timeseries_sharded_matches(segs):
    q = _timeseries(AGGS, "day", {"type": "bound", "dimension": "metLong",
                                  "lower": "10", "upper": "80",
                                  "ordering": "numeric"})
    _three(*segs, q)


def test_timeseries_first_last_sharded(segs):
    """First/last merge across segments of different time origins (4 days,
    one segment a day) to the reference's result."""
    q = _timeseries([{"type": "longFirst", "name": "f",
                      "fieldName": "metLong"},
                     {"type": "doubleLast", "name": "l",
                      "fieldName": "metDouble"}], "day")
    _three(*segs, q)
    q = _timeseries(q["aggregations"], "all")
    _three(*segs, q)


def test_timeseries_hll_sharded(segs):
    q = _timeseries([{"type": "cardinality", "name": "card",
                      "fields": ["dimHi"]},
                     {"type": "count", "name": "rows"}], "all")
    _three(*segs, q)


def test_topn_sharded_matches(segs):
    q = {"queryType": "topN", "dataSource": "test", "intervals": [WEEK],
         "granularity": "all", "dimension": "dimB", "metric": "lsum",
         "threshold": 10, "aggregations": AGGS,
         "filter": {"type": "in", "dimension": "dimA",
                    "values": [f"v{i:08d}" for i in range(4)]}}
    _, got, _ = _three(*segs, q)
    assert len(got[0]["result"]) == 10


def test_groupby_sharded_matches(segs):
    q = {"queryType": "groupBy", "dataSource": "test", "intervals": [WEEK],
         "granularity": "day", "dimensions": ["dimA", "dimB"],
         "aggregations": AGGS + [{
             "type": "filtered", "name": "fsum",
             "filter": {"type": "selector", "dimension": "dimA",
                        "value": "v00000001"},
             "aggregator": {"type": "longSum", "name": "fsum",
                            "fieldName": "metLong"}}],
         "filter": {"type": "and", "fields": [
             {"type": "not", "field": {"type": "selector",
                                       "dimension": "dimA",
                                       "value": "v00000009"}},
             {"type": "bound", "dimension": "metLong", "lower": "5",
              "ordering": "numeric"}]}}
    _, got, _ = _three(*segs, q)
    assert len(got) > 100
    assert {r["event"]["dimA"] for r in got} == {f"v{i:08d}"
                                                 for i in range(9)}
    assert any(r["event"]["fsum"] for r in got)


def test_groupby_uneven_segments():
    """5 segments on 8 shards: K pads to 8 with all-invalid segments."""
    ref = DataGenerator(TEST_SCHEMA, seed=5).segments(
        5, 3_000, Interval.parse(WEEK), datasource="uneven")
    q = {"queryType": "groupBy", "dataSource": "uneven", "intervals": [WEEK],
         "granularity": "all", "dimensions": ["dimA"],
         "aggregations": AGGS[:2]}
    _three(ref, [_carry(s) for s in ref], q)


def _built(pkg, name, rows_by_part):
    """Segments built row by row in either package: rows_by_part[p] is a
    list of (dims, metrics) added at T0 + i."""
    iv = pkg.Interval.of("2026-01-01", "2026-01-02")
    out = []
    for p, rows in enumerate(rows_by_part):
        b = pkg.SegmentBuilder(name, iv, partition=p)
        for i, (dims, mets) in enumerate(rows):
            b.add_row(iv.start + i, dims, mets)
        out.append(b.build())
    return out


def _both_built(name, rows_by_part):
    from druid_tpu.data import segment as r_segment
    from druid_tpu.utils.intervals import Interval as RInterval

    class R:
        SegmentBuilder = r_segment.SegmentBuilder
        Interval = RInterval

    class P:
        SegmentBuilder = SegmentBuilder
        Interval = Interval
    return _built(R, name, rows_by_part), _built(P, name, rows_by_part)


def test_heterogeneous_column_presence():
    """A filter column in some segments only must not shortcut to a
    whole-query zero: the plans differ, the mesh falls back."""
    rows = [[({"common": f"c{i % 3}"}, {"m": i}) for i in range(100)],
            [({"common": f"c{i % 3}", "extra": f"e{i % 2}"}, {"m": i})
             for i in range(100)]]
    ref, port = _both_built("het", rows)
    q = _timeseries(AGGS[:1] + [{"type": "longSum", "name": "ms",
                                 "fieldName": "m"}], "all",
                    {"type": "selector", "dimension": "extra",
                     "value": "e0"}, ds="het", iv=DAY1)
    _, got, _ = _three(ref, port, q, sharded=False)
    assert got[0]["result"]["rows"] == 50


def test_differing_dictionaries_fall_back():
    """Equal cardinality, different dictionaries: ids must not fuse."""
    rows = [[({"d": v}, {"m": 1}) for v in ["apple", "berry"] * 4],
            [({"d": v}, {"m": 1}) for v in ["cherry", "date"] * 4]]
    ref, port = _both_built("dicts", rows)
    q = {"queryType": "groupBy", "dataSource": "dicts", "intervals": [DAY1],
         "granularity": "all", "dimensions": ["d"],
         "aggregations": AGGS[:1]}
    _, got, _ = _three(ref, port, q, sharded=False)
    assert [r["event"]["d"] for r in got] == ["apple", "berry", "cherry",
                                              "date"]


def test_executor_mesh_arg(segs):
    _three(*segs, _timeseries(AGGS, "hour"))


def test_missing_metric_column_in_later_segment():
    """A metric in segment 0 only falls back (missing aggregates as 0)."""
    rows = [[({"d": "x"}, {"m": 1, "m2": i}) for i in range(50)],
            [({"d": "x"}, {"m": 1}) for i in range(50)]]
    ref, port = _both_built("mm", rows)
    q = _timeseries(AGGS[:1] + [{"type": "longSum", "name": "s",
                                 "fieldName": "m2"}], "all", ds="mm",
                    iv=DAY1)
    _, got, _ = _three(ref, port, q, sharded=False)
    assert got[0]["result"] == {"rows": 100, "s": 1225}


def test_rebuilt_segments_not_served_stale():
    """Segments rebuilt with identical ids must not hit a stale stack (the
    stack is keyed by object identity)."""
    q = _timeseries([{"type": "longSum", "name": "s",
                      "fieldName": "metLong"}], "all",
                    iv="2026-01-01/2026-01-05")
    got = []
    for seed in (1, 2):
        ref = DataGenerator(TEST_SCHEMA, seed=seed).segments(
            4, 2_000, Interval.of("2026-01-01", "2026-01-05"),
            datasource="test")
        got.append(_three(ref, [_carry(s) for s in ref], q)[1])
    assert got[0] != got[1]


def test_two_cardinality_aggs_different_columns(segs):
    """Two HLL fields must not share a cached run."""
    for field, lo, hi in (("dimA", 8, 12), ("dimB", 80, 120)):
        q = _timeseries([{"type": "cardinality", "name": "c",
                          "fields": [field]}], "all")
        _, got, _ = _three(*segs, q)
        assert lo <= got[0]["result"]["c"] <= hi


def test_numeric_dimension_falls_back(segs):
    """A numeric dimension's ids are a per-segment query-time dictionary:
    no sharded run, the same rows."""
    q = {"queryType": "groupBy", "dataSource": "test", "intervals": [WEEK],
         "granularity": "all", "dimensions": ["metLong"],
         "aggregations": AGGS[:2]}
    _three(*segs, q, sharded=False)


# ---------------------------------------------------------------------------
# the mesh cases of the reference's strategy, timeseries, jit-cache and
# device-pool suites
# ---------------------------------------------------------------------------

def _forced(segs, q, force, monkeypatch, mesh):
    """The port's rows with the selection forced to `force` ("mixed" or
    the strategy the selection must pick), as tests/test_strategies.py
    forces it, through grouping.select_strategy."""
    orig = grouping.select_strategy
    seen = []

    def fake(*a, **k):
        s, w = orig(*a, **k)
        seen.append(s)
        if force == "mixed":
            return "mixed", 0
        assert s == force, f"expected strategy {force}, selected {s}"
        return s, w
    monkeypatch.setattr(grouping, "select_strategy", fake)
    try:
        rows = PortExecutor(segs, device="cpu", mesh=mesh).run_json(q)
    finally:
        monkeypatch.setattr(grouping, "select_strategy", orig)
    assert seen
    return rows


def _strategy_segments(sort_by_dims, card_b=200):
    from druid_tpu.data.generator import ColumnSpec
    schema = (ColumnSpec("dimA", "string", cardinality=30),
              ColumnSpec("dimB", "string", cardinality=card_b,
                         distribution="zipf"),
              ColumnSpec("metLong", "long", low=0, high=9_000),
              ColumnSpec("metFloat", "float", distribution="normal",
                         mean=10.0, std=400.0))
    ref = DataGenerator(schema, seed=77).segments(
        2, 20_000, Interval.parse(DAY1), datasource="bench",
        sort_by_dims=sort_by_dims)
    return ref, [_carry(s) for s in ref]


def _by_key(rows, dims):
    return {tuple(r["event"][d] for d in dims):
            {k: v for k, v in r["event"].items() if k not in dims}
            for r in rows}


def _strategy_compare(a, b, float_keys=("fsum", "fmax")):
    assert set(a) == set(b)
    for k in a:
        for m in a[k]:
            if m in float_keys:
                assert a[k][m] == pytest.approx(b[k][m], rel=1e-4, abs=1e-2)
            else:
                assert a[k][m] == b[k][m], (k, m)


STRAT_AGGS = [{"type": "count", "name": "rows"},
              {"type": "longSum", "name": "lsum", "fieldName": "metLong"},
              {"type": "floatSum", "name": "fsum", "fieldName": "metFloat"},
              {"type": "floatMax", "name": "fmax", "fieldName": "metFloat"},
              {"type": "longMin", "name": "lmin", "fieldName": "metLong"}]


@pytest.mark.parametrize("force", ["mm", "windowed"])
def test_mesh_forced_strategy_matches_mixed(force, monkeypatch):
    """tests/test_strategies.py's mesh cases on a 2-shard mesh: forced mm
    (card 200 pads to 256, inside mm's range) and forced windowed (the
    rollup order) against forced mixed, and against the reference's
    forced run on its 2-device mesh. metLong starts at 0 here, not -500: a
    negative column's mm base is each segment's own minimum, so the two
    segments' longSum plans differ and the mesh falls back (in both
    packages), which would leave the sharded run untested."""
    from druid_tpu.engine import grouping as ref_grouping
    if force == "mm":
        ref, port = _strategy_segments(False)
        dims, aggs = ["dimB"], STRAT_AGGS[:3]
        flt = {"type": "bound", "dimension": "metLong", "lower": "-100",
               "upper": "8000", "ordering": "numeric"}
    else:
        ref, port = _strategy_segments(True)
        dims, aggs = ["dimA", "dimB"], STRAT_AGGS
        flt = {"type": "bound", "dimension": "metLong", "lower": "0",
               "upper": "8500", "ordering": "numeric"}
    q = {"queryType": "groupBy", "dataSource": "bench", "intervals": [DAY1],
         "granularity": "all", "dimensions": dims, "aggregations": aggs,
         "filter": flt}
    mesh = make_mesh(2, device="cpu")
    before = distributed.sharded_stats().snapshot()[0]
    got = _by_key(_forced(port, q, force, monkeypatch, mesh), dims)
    want = _by_key(_forced(port, q, "mixed", monkeypatch, mesh), dims)
    assert distributed.sharded_stats().snapshot()[0] - before == 2
    _strategy_compare(got, want)
    monkeypatch.setattr(ref_grouping, "FORCE_STRATEGY", force)
    with ref_use_mesh(ref_make_mesh(2)):
        ref_rows = RefExecutor(ref).run_json(q)
    _strategy_compare(got, _by_key(ref_rows, dims))


def test_virtual_column_string_dim_sharded(segs):
    """tests/test_timeseries.py: a virtual column comparing a string
    dimension through the sharded run (its LUT is a plan constant)."""
    ref, port = segs
    val = ref[0].dims["dimA"].dictionary.values[int(ref[0].dims["dimA"]
                                                    .ids[0])]
    q = _timeseries([{"type": "longSum", "name": "sv", "fieldName": "v"}],
                    "all", iv="2026-01-01/2026-01-05")
    q["virtualColumns"] = [{"type": "expression", "name": "v",
                            "expression": f"if(dimA == '{val}', metLong, 0)",
                            "outputType": "long"}]
    want = sum(int(s.metrics["metLong"].values[
        np.asarray(s.dims["dimA"].dictionary.values)[s.dims["dimA"].ids]
        == val].sum()) for s in ref)
    got = PortExecutor(port, device="cpu",
                       mesh=make_mesh(2, device="cpu")).run_json(q)
    assert want > 0 and got[0]["result"]["sv"] == want


class _BuildCounter:
    def __init__(self, fn):
        self.fn, self.count = fn, 0

    def __call__(self, *a, **k):
        self.count += 1
        return self.fn(*a, **k)


def test_repeated_sharded_query_builds_once(segs, monkeypatch):
    """tests/test_jit_cache.py: a repeated query over the mesh builds its
    stacked run once (the batched path's _PROGRAM_CACHE, keyed per shard
    by structure, K / n, R and device: the 8 CPU shards share one)."""
    monkeypatch.setattr(batching, "_PROGRAM_CACHE",
                        collections.OrderedDict())
    counter = _BuildCounter(batching._build_stacked_fn)
    monkeypatch.setattr(batching, "_build_stacked_fn", counter)
    q = _timeseries(AGGS[:2], "day", iv="2026-01-01/2026-01-05")
    ex = PortExecutor(segs[1], device="cpu", mesh=_mesh8())
    first = ex.run_json(q)
    assert counter.count == 1
    for _ in range(3):
        assert ex.run_json(q) == first
    assert counter.count == 1
    # a mesh of another shard count stacks K / n otherwise: another run
    PortExecutor(segs[1], device="cpu",
                 mesh=make_mesh(2, device="cpu")).run_json(q)
    assert counter.count == 2


POOL_SCHEMA_Q = {"queryType": "timeseries", "dataSource": "pool",
                 "intervals": ["2026-04-01/2026-04-02"], "granularity": "all",
                 "aggregations": [{"type": "count", "name": "rows"}]}


@pytest.fixture
def fresh_pool(monkeypatch):
    pool = devicepool.DeviceSegmentPool(budget_bytes=0)
    monkeypatch.setattr(devicepool, "_POOL", pool)
    yield pool
    distributed.clear_stack_cache()


def _pool_segments(seed, n=8, rows=3000):
    from druid_tpu_torch.data.generator import ColumnSpec
    from druid_tpu_torch.data.generator import DataGenerator as PortGen
    schema = (ColumnSpec("dimA", "string", cardinality=5),
              ColumnSpec("metLong", "long", low=0, high=100))
    return PortGen(schema, seed=seed).segments(
        n, rows, Interval.of("2026-04-01", "2026-04-02"), datasource="pool")


def test_stacked_blocks_evict_under_byte_pressure(fresh_pool):
    """tests/test_devicepool.py: the stacks are device-pool entries: their
    bytes count against the budget, evict LRU under pressure, and restage
    with the same rows."""
    segs_a, segs_b = _pool_segments(11), _pool_segments(12)
    mesh = _mesh8()
    r1 = PortExecutor(segs_a, device="cpu", mesh=mesh).run_json(POOL_SCHEMA_Q)
    s1 = fresh_pool.snapshot()
    assert s1.stacked_entries == 1
    assert 0 < s1.stacked_bytes <= s1.resident_bytes
    budget = s1.resident_bytes + s1.stacked_bytes // 2
    fresh_pool.configure(budget)
    PortExecutor(segs_b, device="cpu", mesh=mesh).run_json(POOL_SCHEMA_Q)
    s2 = fresh_pool.snapshot()
    assert s2.evictions > s1.evictions
    assert s2.stacked_entries == 1 and s2.resident_bytes <= budget
    assert PortExecutor(segs_a, device="cpu",
                        mesh=mesh).run_json(POOL_SCHEMA_Q) == r1
    assert fresh_pool.snapshot().stacked_entries == 1


def test_stacked_accounting_counts_only_stacked_keys(fresh_pool):
    """PoolStats.stacked_* follow the STACKED_KIND entries through insert,
    replace and purge; other entries leave them alone."""
    owner = object.__new__(distributed._StackOwner)
    token = fresh_pool.register_owner(owner)
    fresh_pool.get_or_build(token, (devicepool.STACKED_KIND, "k1"),
                            lambda: torch.zeros(512, dtype=torch.int32))
    fresh_pool.get_or_build(token, ("plain", "k2"),
                            lambda: torch.zeros(16, dtype=torch.int8))
    s = fresh_pool.snapshot()
    assert (s.stacked_entries, s.stacked_bytes) == (1, 2048)
    assert s.resident_bytes == 2048 + 16
    fresh_pool.purge_owner(token)
    s = fresh_pool.snapshot()
    assert (s.stacked_entries, s.stacked_bytes, s.resident_bytes) \
        == (0, 0, 0)


def test_release_device_caches_frees_the_stack(fresh_pool):
    segs = _pool_segments(13, n=3)
    PortExecutor(segs, device="cpu", mesh=_mesh8()).run_json(POOL_SCHEMA_Q)
    assert fresh_pool.snapshot().stacked_bytes > 0
    out = release_device_caches()
    assert out["stack_entries"] == 1 and out["stacked_programs"] >= 1
    assert fresh_pool.snapshot().stacked_bytes == 0
    out = release_device_caches(clear_pool=True)
    assert out["stack_entries"] == 0
    assert fresh_pool.snapshot().resident_bytes == 0


# ---------------------------------------------------------------------------
# the mesh surface
# ---------------------------------------------------------------------------

def test_make_mesh(monkeypatch):
    m = make_mesh(3, device="cpu")
    assert m.size == 3 and m.axis == context.SEGMENT_AXIS
    assert m.devices == (torch.device("cpu"),) * 3
    assert make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = make_mesh()
    assert cuda.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="3 cards"):
        make_mesh(3)


def test_mesh_device_type_must_match(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda_mesh = make_mesh()
    with pytest.raises(ValueError, match="does not run on"):
        PortExecutor([], device="cpu", mesh=cuda_mesh)
    from druid_tpu_torch.cluster import DataNode
    with pytest.raises(ValueError, match="does not run on"):
        DataNode("n", device="cpu", mesh=cuda_mesh)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="does not run on"):
        PortExecutor([], mesh=make_mesh(2, device="cpu"))


def test_use_mesh_is_thread_local_and_restores():
    m = make_mesh(2, device="cpu")
    assert context.get_mesh() is None
    with use_mesh(m):
        assert context.get_mesh() is m
        seen = []
        import threading
        t = threading.Thread(target=lambda: seen.append(context.get_mesh()))
        t.start()
        t.join(timeout=10)
        assert seen == [None]
    assert context.get_mesh() is None


def test_layout_splits_contiguous_blocks():
    mesh = make_mesh(4, device="cpu")
    assert speclayout.shard_slices(8, 4) == [slice(0, 2), slice(2, 4),
                                             slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError):
        speclayout.shard_slices(6, 4)
    stacked = np.repeat(np.arange(8, dtype=np.int32)[:, None], 3, axis=1)
    shards = speclayout.split(mesh, stacked)
    assert [s.tolist() for s in shards] == [
        [[0] * 3, [1] * 3], [[2] * 3, [3] * 3], [[4] * 3, [5] * 3],
        [[6] * 3, [7] * 3]]
    t0 = speclayout.split(mesh, torch.arange(8, dtype=torch.int64))
    assert [t.tolist() for t in t0] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError):
        speclayout.split(mesh, np.int64(3))
    one = make_mesh(1, device="cpu")
    assert speclayout.layout_sig(mesh) != speclayout.layout_sig(one)


def test_stack_keys_carry_the_mesh(segs, fresh_pool):
    """A 2-shard and a 1-shard mesh stack the same segments under two
    entries (the key carries the mesh's devices)."""
    port = segs[1]
    q = _timeseries(AGGS[:2], "all", iv="2026-01-01/2026-01-05")
    a = PortExecutor(port, device="cpu",
                     mesh=make_mesh(2, device="cpu")).run_json(q)
    b = PortExecutor(port, device="cpu",
                     mesh=make_mesh(1, device="cpu")).run_json(q)
    assert a == b
    assert fresh_pool.snapshot().stacked_entries == 2


def test_const_false_filter_is_a_sharded_zero(segs):
    """Every segment plans the filter to constant false: a whole-query zero
    without a run, as in the reference."""
    q = _timeseries(AGGS[:2], "all",
                    {"type": "selector", "dimension": "nope", "value": "x"},
                    iv="2026-01-01/2026-01-05")
    with ref_use_mesh(ref_make_mesh()):
        ref = RefExecutor(segs[0]).run_json(q)
    got = PortExecutor(segs[1], device="cpu", mesh=_mesh8()).run_json(q)
    assert got == ref == PortExecutor(segs[1], device="cpu").run_json(q)


def test_data_node_mesh_behind_broker(segs):
    """DataNode(mesh=) behind the in-process broker: each node runs its
    segments as one sharded run (one timing over the set), the rows equal
    the meshless executor's, and a mesh node is not a flush-mate."""
    from druid_tpu_torch.cluster import (Broker, DataNode, InventoryView,
                                         descriptor_for)
    from druid_tpu_torch.cluster.cache import LruCache
    from druid_tpu_torch.query.model import query_from_json
    port = segs[1]
    q = {"queryType": "groupBy", "dataSource": "test",
         "intervals": ["2026-01-01/2026-01-05"], "granularity": "all",
         "dimensions": ["dimA"], "aggregations": AGGS[:2]}
    view = InventoryView()
    nodes = [DataNode(f"n{i}", device="cpu", mesh=make_mesh(2, device="cpu"))
             for i in range(2)]
    for n in nodes:
        view.register(n)
    for i, s in enumerate(port):
        nodes[i % 2].load_segment(s)
        view.announce(nodes[i % 2].name, descriptor_for(s))
    broker = Broker(view, device="cpu")
    try:
        before = distributed.sharded_stats().snapshot()
        got = broker.run_json(q)
        after = distributed.sharded_stats().snapshot()
    finally:
        broker.stop()
    assert after[0] - before[0] == 2 and after[1] - before[1] == 4
    assert got == PortExecutor(port, device="cpu").run_json(q)
    assert not nodes[0].fusable(query_from_json(q))
    # the segment cache keeps per-segment entries: the miss set runs per
    # miss under the mesh
    cached = DataNode("c", device="cpu", cache=LruCache(),
                      mesh=make_mesh(2, device="cpu"))
    for s in port:
        cached.load_segment(s)
    ap, served = cached.run_partials(query_from_json(q),
                                     [str(s.id) for s in port])
    assert len(ap.partials) == 4 and len(served) == 4


def test_sharded_monitor_emits(segs):
    from druid_tpu_torch.utils.emitter import InMemoryEmitter, ServiceEmitter
    sink = InMemoryEmitter()
    em = ServiceEmitter("test", "h", sink)
    mon = distributed.ShardedMonitor()
    mon.do_monitor(em)
    PortExecutor(segs[1], device="cpu", mesh=_mesh8()).run_json(
        _timeseries(AGGS[:1], "all", iv="2026-01-01/2026-01-05"))
    sink.events.clear()
    mon.do_monitor(em)
    got = {e.metric: e.value for e in sink.events}
    assert got["query/sharded/mergeDevice"] == 1
    assert got["query/sharded/stackBytes"] > 0
    # the dense stack's constant packedRatio is not emitted
    assert "query/sharded/packedRatio" not in got


def test_initialize_multihost_gloo_world_of_one(tmp_path):
    import torch.distributed as dist
    assert not dist.is_initialized()
    try:
        n = context.initialize_multihost(
            f"file://{tmp_path / 'store'}", num_processes=1, process_id=0)
        assert n == 1 and dist.get_backend() == "gloo"
        # idempotent
        assert context.initialize_multihost() == 1
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
