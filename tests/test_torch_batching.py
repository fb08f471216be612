"""The port's batched multi-segment path (druid_tpu_torch/engine/batching.py)
against the reference package's, on the CPU.

Small segments of mixed sizes, made by the reference's DataGenerator and
carried into the port as plain arrays, go through the reference's
QueryExecutor (JAX on the CPU, batching on) and the port's (device="cpu",
batching on):
  * rows: timeseries, topN, groupBy with a filter and virtual columns, an
    int64-staged long column, a straggler of another schema; counts, long
    sums and min/max exact, float sums within 1e-5 * sum|v| per row (every
    summed float column here is positive, so sum|v| is the reference's own
    sum);
  * bucket structure: the batched runs, the segments of each (and its fill
    ratio) and the stragglers equal the reference's `batching.stats()`;
  * batched against alone: each port result equals the port's
    {"batchSegments": false} run under the same rule;
  * planning: `row_rung`, `_pow2_chunks`, stragglers planned once, the
    context switch, a repeated query building its stacked run once, a large
    group space falling back;
  * the strategies on the stack (mm, blocked, the mixed hybrid, mixed,
    windowed) and the launches of a stacked run not growing with K;
  * bitmap filters and filtered aggregators (words staged in one wave),
    register columns stacked [K, R, width], and random filter trees;
  * cross-query: `make_aggregate_partials_multi` equals each query alone;
  * a first bucket more than 2^31 ms before a segment's start, where the
    port counts every row and the reference does not (ROADMAP §C).
"""
import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data import cascade as ref_cascade
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.data.segment import SegmentBuilder, ValueType
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.engine import batching as ref_batching
from druid_tpu.engine import grouping as ref_grouping
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.data import cascade as port_cascade
from druid_tpu_torch.data.devicepool import device_pool
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import batching, engines
from druid_tpu_torch.engine import filters as port_filters
from druid_tpu_torch.engine import grouping as port_grouping
from druid_tpu_torch.query.model import query_from_json
from tests.test_torch_hll import _rolled_up
from tests.test_torch_mega_slice import TREE_SCHEMA, _rand_tree
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

IV = Interval.of("2026-03-01", "2026-03-03")

SCHEMA = (
    ColumnSpec("dimA", "string", cardinality=8, distribution="uniform"),
    ColumnSpec("dimB", "string", cardinality=40, distribution="zipf"),
    ColumnSpec("metLong", "long", low=0, high=1000),
    ColumnSpec("metFloat", "float", distribution="normal", mean=5.0,
               std=2.0),
    ColumnSpec("metDouble", "double", low=0.0, high=1.0),
)

#: the float sums the rule holds to 1e-5 * sum|v| (their columns are
#: positive); everything else compares exactly
FLOAT_SUMS = {"ds", "ws", "fs"}


@pytest.fixture(autouse=True)
def _batching_on(monkeypatch):
    monkeypatch.setattr(ref_batching, "_ENABLED", True)
    monkeypatch.setattr(batching, "_ENABLED", True)


def _pair(ref):
    return ref, [_carry(s) for s in ref]


@pytest.fixture(scope="module")
def mixed():
    """Same schema, mixed sizes: two rungs (3000 -> 4096, 9000 -> 16384)."""
    gen = DataGenerator(SCHEMA, seed=7)
    return _pair(gen.segments(4, 3000, IV, datasource="mix")
                 + gen.segments(4, 9000, IV, datasource="mix"))


AGGS = [{"type": "count", "name": "n"},
        {"type": "longSum", "name": "ls", "fieldName": "metLong"},
        {"type": "doubleSum", "name": "ds", "fieldName": "metDouble"},
        {"type": "floatMax", "name": "fx", "fieldName": "metFloat"},
        {"type": "longMin", "name": "lm", "fieldName": "metLong"}]


def _close(want, got, where=()):
    """The rule: exact, but float sums within 1e-5 of their (positive)
    value."""
    if isinstance(want, dict):
        assert set(want) == set(got), where
        for k in want:
            if k in FLOAT_SUMS:
                assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), \
                    (where, k, want[k], got[k])
            else:
                _close(want[k], got[k], where + (k,))
    elif isinstance(want, list):
        assert len(want) == len(got), where
        for i, (a, b) in enumerate(zip(want, got)):
            _close(a, b, where + (i,))
    elif isinstance(want, float) and np.isnan(want):
        assert isinstance(got, float) and np.isnan(got), where
    else:
        assert got == want and type(got) is type(want), (where, want, got)


def _stats_delta(mod, before):
    after = mod.stats().snapshot()
    events, dropped = mod.stats().drain_events()
    return ({k: after[k] - before[k]
             for k in ("batches", "batchedSegments", "fallbackSegments")},
            sorted(events), dropped)


def _run_both(segs, q):
    """(reference rows, port rows, reference stats, port stats, the port's
    rows alone); every port result is held to the reference's and to its
    own per-segment run."""
    ref, port = segs
    ref_batching.stats().drain_events()
    batching.stats().drain_events()
    r0 = ref_batching.stats().snapshot()
    want = RefExecutor(ref).run_json(q)
    rs = _stats_delta(ref_batching, r0)
    p0 = batching.stats().snapshot()
    got = PortExecutor(port, device="cpu").run_json(q)
    ps = _stats_delta(batching, p0)
    alone = PortExecutor(port, device="cpu").run_json(
        dict(q, context={"batchSegments": False}))
    _close(want, got)
    _close(got, alone)
    return want, got, rs, ps


QUERIES = {
    "timeseries": {"queryType": "timeseries", "granularity": "hour",
                   "aggregations": AGGS},
    "topn": {"queryType": "topN", "granularity": "all", "dimension": "dimB",
             "metric": "ls", "threshold": 9, "aggregations": AGGS},
    "groupby": {
        "queryType": "groupBy", "granularity": "day",
        "virtualColumns": [
            {"type": "expression", "name": "v",
             "expression": "metLong * 2 + 1", "outputType": "long"},
            {"type": "expression", "name": "w",
             "expression": "if(dimA == 'v00000000', 10.0, 1.0)",
             "outputType": "double"}],
        "dimensions": ["dimA"],
        "filter": {"type": "bound", "dimension": "metLong", "lower": 10,
                   "upper": 900, "ordering": "numeric"},
        "aggregations": [{"type": "longSum", "name": "vs", "fieldName": "v"},
                         {"type": "doubleSum", "name": "ws",
                          "fieldName": "w"},
                         {"type": "longFirst", "name": "lf",
                          "fieldName": "metLong"}]},
}


def _q(name, ds="mix"):
    return dict(QUERIES[name], dataSource=ds, intervals=[str(IV)])


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_rows_and_buckets_match_reference(mixed, name):
    want, got, rs, ps = _run_both(mixed, _q(name))
    assert want
    assert rs == ps
    stats, events, _ = ps
    # one run per rung: 4 segments each, no straggler
    assert stats == {"batches": 2, "batchedSegments": 8,
                     "fallbackSegments": 0}
    assert [n for n, _ in events] == [4, 4]


def _long_segment(lo, hi, n=1500, partition=0):
    """A segment whose long column spans [lo, hi): past 2**31 it stages
    int64, small ones narrow to int32."""
    rng = np.random.default_rng(100 + partition)
    b = SegmentBuilder("longs", IV, version="v1", partition=partition)
    t = np.sort(rng.integers(IV.start, IV.end, n))
    b.add_columns(
        t, {"dimA": [f"a{int(x)}" for x in rng.integers(0, 5, n)]},
        {"big": rng.integers(lo, hi, n, dtype=np.int64)},
        metric_types={"big": ValueType.LONG})
    return b.build()


def test_int64_staged_long_parity():
    """Two int32-staged and two int64-staged segments: two buckets, both
    batch, and the 64-bit sums stay exact."""
    segs = _pair([_long_segment(0, 1000, partition=i) for i in (0, 1)]
                 + [_long_segment(2**40, 2**40 + 10**6, partition=i)
                    for i in (2, 3)])
    assert segs[1][0].staged_dtype("big") == np.int32
    assert segs[1][2].staged_dtype("big") == np.int64
    q = {"queryType": "groupBy", "dataSource": "longs",
         "intervals": [str(IV)], "granularity": "all",
         "dimensions": ["dimA"],
         "aggregations": [{"type": "longSum", "name": "s",
                           "fieldName": "big"},
                          {"type": "longMax", "name": "m",
                           "fieldName": "big"}]}
    _, got, rs, ps = _run_both(segs, q)
    assert rs == ps and ps[0]["batches"] == 2
    assert sum(r["event"]["s"] for r in got) == sum(
        int(s.metrics["big"].values.sum()) for s in segs[0])


def _odd_segment(partition=99, n=500):
    """A segment of another schema (no dimB, metFloat, metDouble)."""
    rng = np.random.default_rng(9)
    b = SegmentBuilder("mix", IV, version="odd", partition=partition)
    t = np.sort(rng.integers(IV.start, IV.end, n))
    b.add_columns(t, {"dimA": [f"dimA_{int(x)}"
                               for x in rng.integers(0, 3, n)]},
                  {"metLong": rng.integers(0, 1000, n, dtype=np.int64)},
                  metric_types={"metLong": ValueType.LONG})
    return b.build()


def test_straggler_falls_back_and_merges(mixed):
    segs = (mixed[0] + [_odd_segment()], mixed[1] + [_carry(_odd_segment())])
    q = {"queryType": "groupBy", "dataSource": "mix", "intervals": [str(IV)],
         "granularity": "all", "dimensions": ["dimA"],
         "aggregations": [{"type": "longSum", "name": "ls",
                           "fieldName": "metLong"}]}
    _, _, rs, ps = _run_both(segs, q)
    assert rs == ps
    assert ps[0] == {"batches": 2, "batchedSegments": 8,
                     "fallbackSegments": 1}


def test_uneven_bucket_chunks_and_remainder():
    """A bucket of 7: chunks of 4 and 2 and a straggler of 1, as the
    reference splits it."""
    segs = _pair(DataGenerator(SCHEMA, seed=3).segments(7, 2000, IV,
                                                        datasource="mix"))
    _, _, rs, ps = _run_both(segs, _q("timeseries"))
    assert rs == ps
    assert ps[0] == {"batches": 2, "batchedSegments": 6,
                     "fallbackSegments": 1}
    assert [n for n, _ in ps[1]] == [2, 4]


def test_context_disables_batching(mixed):
    q = dict(_q("timeseries"), context={"batchSegments": False})
    before = batching.stats().snapshot()
    PortExecutor(mixed[1], device="cpu").run_json(q)
    assert batching.stats().snapshot()["batches"] == before["batches"]
    assert not batching.query_enabled({"batchSegments": "false"})
    assert batching.query_enabled({"batchSegments": True})
    assert batching.query_enabled(None)
    prev = batching.set_enabled(False)
    try:
        assert not batching.enabled() and not batching.query_enabled(None)
        PortExecutor(mixed[1], device="cpu").run_json(_q("timeseries"))
        assert batching.stats().snapshot()["batches"] == before["batches"]
    finally:
        batching.set_enabled(prev)


def test_repeated_batched_query_builds_once(mixed, monkeypatch):
    """One build of the stacked run per (structure, K, R, device); repeats
    take it from the cache."""
    monkeypatch.setattr(batching, "_PROGRAM_CACHE",
                        collections.OrderedDict())
    calls = []
    real = batching._build_stacked_fn

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(batching, "_build_stacked_fn", counted)
    # a pure count is run-domain eligible: pinned off, this is about the
    # stacked run's cache
    monkeypatch.setattr(port_cascade, "_RUN_DOMAIN", False)
    q = dict(_q("timeseries"), aggregations=[{"type": "count", "name": "n"}])
    ex = PortExecutor(mixed[1], device="cpu")
    first = ex.run_json(q)
    built = len(calls)
    assert built == 2                    # one per rung
    for _ in range(3):
        assert ex.run_json(q) == first
    assert len(calls) == built, "repeated queries rebuilt the stacked run"


def test_program_cache_is_capped(mixed, monkeypatch):
    monkeypatch.setattr(batching, "_PROGRAM_CACHE",
                        collections.OrderedDict())
    monkeypatch.setattr(batching, "_PROGRAM_CACHE_CAP", 1)
    PortExecutor(mixed[1], device="cpu").run_json(_q("timeseries"))
    assert len(batching._PROGRAM_CACHE) == 1


def test_row_rung_ladder():
    assert batching.row_rung(0) == 1024
    assert batching.row_rung(1) == 1024
    assert batching.row_rung(1024) == 1024
    assert batching.row_rung(1025) == 2048
    assert batching.row_rung(3000) == 4096
    assert batching.row_rung(9000) == 16384
    for n in (1, 999, 4097, 100_000, 1_000_000, 2**21):
        assert batching.row_rung(n) >= n
        assert batching.row_rung(n) == ref_batching.row_rung(n)


def test_pow2_chunks():
    for n in (1, 2, 6, 13, 48, 49, 130):
        got = batching._pow2_chunks(list(range(n)))
        assert got == ref_batching._pow2_chunks(list(range(n)))
    chunks, rem = batching._pow2_chunks(list(range(13)))
    assert [len(c) for c in chunks] == [8, 4] and len(rem) == 1
    chunks, rem = batching._pow2_chunks(list(range(48)))
    assert [len(c) for c in chunks] == [32, 16] and rem == []
    chunks, rem = batching._pow2_chunks(list(range(130)))
    assert [len(c) for c in chunks] == [64, 64, 2] and rem == []


def test_fill_ratio_recorded(mixed, monkeypatch):
    monkeypatch.setattr(port_cascade, "_RUN_DOMAIN", False)
    batching.stats().drain_events()
    q = dict(_q("timeseries"), aggregations=[{"type": "count", "name": "n"}])
    PortExecutor(mixed[1], device="cpu").run_json(q)
    events, dropped = batching.stats().drain_events()
    assert sorted(events) == sorted([(4, 3000 / 4096), (4, 9000 / 16384)])
    assert dropped == 0


def test_event_overflow_is_counted():
    stats = batching.BatchStats()
    for _ in range(stats.EVENT_CAP + 5):
        stats.record_batch(2, 100, 200)
    events, dropped = stats.drain_events()
    assert len(events) == stats.EVENT_CAP and dropped == 5
    assert stats.drain_events()[1] == 0


def test_large_group_space_falls_back():
    """Group spaces above BLOCKED_GROUP_LIMIT run alone."""
    gen = DataGenerator(
        (ColumnSpec("hi", "string", cardinality=3000),
         ColumnSpec("metLong", "long", low=0, high=100)), seed=13)
    segs = _pair(gen.segments(4, 2000, IV, datasource="big"))
    q = {"queryType": "groupBy", "dataSource": "big", "intervals": [str(IV)],
         "granularity": "all", "dimensions": ["hi"],
         "aggregations": [{"type": "longSum", "name": "s",
                           "fieldName": "metLong"}]}
    _, _, rs, ps = _run_both(segs, q)
    assert rs == ps and ps[0]["batches"] == 0


def test_run_domain_segments_run_alone():
    """Segments the run domain serves are stragglers, as in the
    reference: its probe shares the run plan's memo."""
    schema = (ColumnSpec("dimA", "string", cardinality=4),
              ColumnSpec("metLong", "long", low=0, high=10))
    ref = DataGenerator(schema, seed=2).segments(
        4, 3000, IV, datasource="rd", sort_by_dims=True)
    segs = _pair(ref)
    q = {"queryType": "timeseries", "dataSource": "rd",
         "intervals": [str(IV)], "granularity": "all",
         "aggregations": [{"type": "count", "name": "n"}]}
    hits = port_cascade.code_domain_stats().snapshot()
    _, _, rs, ps = _run_both(segs, q)
    assert rs == ps and ps[0]["batches"] == 0
    assert port_cascade.code_domain_stats().snapshot() != hits


def test_far_bucket_origin():
    """Two segments 32 days apart in one chunk: the later one's first
    bucket lies more than 2^31 ms before its start. The port's batched and
    per-segment rows agree and count every row; the reference keeps the
    offset in int32, so its per-segment path raises and its batched path
    drops the later segment's rows (a divergence, ROADMAP §C)."""
    schema = (ColumnSpec("dimA", "string", cardinality=4),
              ColumnSpec("metLong", "long", low=0, high=100))
    gen = DataGenerator(schema, seed=3)
    ref = [gen.segment(2000, Interval.of("2026-01-01", "2026-01-02"),
                       datasource="far"),
           gen.segment(2000, Interval.of("2026-02-02", "2026-02-03"),
                       datasource="far")]
    port = [_carry(s) for s in ref]
    q = {"queryType": "timeseries", "dataSource": "far",
         "intervals": ["2026-01-01/2026-02-03"], "granularity": "hour",
         "aggregations": [{"type": "count", "name": "n"},
                          {"type": "longSum", "name": "s",
                           "fieldName": "metLong"}]}
    before = batching.stats().snapshot()["batches"]
    got = PortExecutor(port, device="cpu").run_json(q)
    assert batching.stats().snapshot()["batches"] == before + 1
    alone = PortExecutor(port, device="cpu").run_json(
        dict(q, context={"batchSegments": False}))
    assert got == alone
    assert sum(r["result"]["n"] for r in got) == 4000
    want = RefExecutor(ref).run_json(q)
    assert sum(r["result"]["n"] for r in want) == 2000
    with pytest.raises(OverflowError):
        RefExecutor(ref).run_json(dict(q, context={"batchSegments": False}))


# ---------------------------------------------------------------------------
# planning once
# ---------------------------------------------------------------------------

def _counting_planner(monkeypatch):
    calls = collections.Counter()
    real = port_grouping.plan_grouped_aggregate

    def counted(segment, *a, **kw):
        calls[id(segment)] += 1
        return real(segment, *a, **kw)

    monkeypatch.setattr(port_grouping, "plan_grouped_aggregate", counted)
    monkeypatch.setattr(batching, "plan_grouped_aggregate", counted)
    return calls


def test_stragglers_are_planned_once(monkeypatch):
    """A bucket of 4 and an incompatible straggler: every segment is
    planned exactly once; the straggler runs through its plan."""
    segs = DataGenerator(SCHEMA, seed=11).segments(4, 3000, IV,
                                                   datasource="mix")
    b = SegmentBuilder("mix", IV)
    for i in range(256):
        b.add_row(IV.start + i * 1000, {"dimA": f"v{i % 3}"},
                  {"metLong": 2**40 + i})
    segs.append(b.build())
    port = [_carry(s) for s in segs]
    calls = _counting_planner(monkeypatch)
    q = {"queryType": "timeseries", "dataSource": "mix",
         "intervals": [str(IV)], "granularity": "all",
         "aggregations": [{"type": "longSum", "name": "ls",
                           "fieldName": "metLong"}]}
    before = batching.stats().snapshot()
    got = PortExecutor(port, device="cpu").run_json(q)
    after = batching.stats().snapshot()
    assert after["batches"] > before["batches"]
    assert after["fallbackSegments"] == before["fallbackSegments"] + 1
    assert set(calls.values()) == {1}, dict(calls)
    assert len(calls) == len(port)
    assert got == RefExecutor(segs).run_json(q)


def test_nothing_batches_still_plans_once(monkeypatch):
    """No bucket of two: run_with_batching runs each plan alone itself,
    one planning pass per segment and run."""
    segs = []
    for i, rows in enumerate((1000, 3000, 9000, 17000)):
        segs += DataGenerator(SCHEMA, seed=20 + i).segments(
            1, rows, IV, datasource="mix")
    segs = _pair(segs)
    calls = _counting_planner(monkeypatch)
    q = {"queryType": "timeseries", "dataSource": "mix",
         "intervals": [str(IV)], "granularity": "all",
         "aggregations": [{"type": "doubleSum", "name": "ds",
                           "fieldName": "metDouble"}]}
    _, _, rs, ps = _run_both(segs, q)
    assert rs == ps and ps[0]["batches"] == 0
    # batched and alone: each plans each segment once
    assert set(calls.values()) == {2}, dict(calls)


# ---------------------------------------------------------------------------
# strategies on the stack
# ---------------------------------------------------------------------------

class _StackSpy:
    """The strategy and K of every stacked run."""

    def __init__(self, monkeypatch):
        self.runs = []
        orig = port_grouping.fuse_filter_update_stacked

        def spy(arrays, mask, key, dims, filter_node, kernels, num_total,
                slot_base, strategy="mixed", span=0):
            self.runs.append((strategy, span, mask.shape[0]))
            return orig(arrays, mask, key, dims, filter_node, kernels,
                        num_total, slot_base, strategy=strategy, span=span)
        monkeypatch.setattr(port_grouping, "fuse_filter_update_stacked", spy)


STRAT_AGGS = [{"type": "count", "name": "n"},
              {"type": "longSum", "name": "ls", "fieldName": "metLong"},
              {"type": "floatSum", "name": "fs", "fieldName": "metDouble"},
              {"type": "longMax", "name": "lx", "fieldName": "metLong"}]


@pytest.fixture(scope="module")
def equal_segs():
    """Four segments of one rung, dimB over 128 groups (mm, not blocked,
    when natural), metLong in -4000..-1 (the mm limbs' base, the
    segment's least value: segments that differ in it bucket apart, as in
    the reference), plus a positive float column."""
    schema = (ColumnSpec("dimA", "string", cardinality=8),
              ColumnSpec("dimB", "string", cardinality=100),
              ColumnSpec("metLong", "long", low=-4000, high=-1),
              ColumnSpec("metDouble", "float", low=0.0, high=1.0))
    return _pair(DataGenerator(schema, seed=31).segments(
        4, 2500, IV, datasource="st"))


@pytest.mark.parametrize("force,dims,aggs,want", [
    (None, ["dimB"], STRAT_AGGS[:3], "mm"),
    ("mm", ["dimA"], STRAT_AGGS[:3], "mm"),
    (None, ["dimA"], STRAT_AGGS, "blocked"),
    ("blocked", ["dimB"], STRAT_AGGS, "blocked"),
    (None, ["dimB"], STRAT_AGGS + [{"type": "longFirst", "name": "f",
                                    "fieldName": "metLong"}], "mixed"),
    ("mixed", ["dimA"], STRAT_AGGS, "mixed"),
    ("windowed", ["dimA"], STRAT_AGGS, "windowed"),
], ids=["mm", "mm-forced", "blocked", "blocked-forced", "hybrid",
        "mixed-forced", "windowed-forced"])
def test_strategies_on_the_stack(equal_segs, force, dims, aggs, want,
                                 monkeypatch):
    monkeypatch.setattr(port_grouping, "FORCE_STRATEGY", force)
    monkeypatch.setattr(ref_grouping, "FORCE_STRATEGY", force)
    spy = _StackSpy(monkeypatch)
    q = {"queryType": "groupBy", "dataSource": "st", "intervals": [str(IV)],
         "granularity": "all", "dimensions": dims, "aggregations": aggs}
    _, _, rs, ps = _run_both(equal_segs, q)
    assert rs == ps and ps[0]["batches"] == 1
    assert [(s, k) for s, _, k in spy.runs] \
        == [(want, ps[0]["batchedSegments"])]


def test_blocked_steps_on_the_stack(equal_segs, monkeypatch):
    """Several steps of the batched blocked reduction."""
    monkeypatch.setattr(port_grouping, "BATCH_STEP_CELLS", 4 * 8 * 2048 * 3)
    q = {"queryType": "groupBy", "dataSource": "st", "intervals": [str(IV)],
         "granularity": "all", "dimensions": ["dimA"],
         "aggregations": STRAT_AGGS}
    _, _, rs, ps = _run_both(equal_segs, q)
    assert rs == ps and ps[0]["batches"] == 1


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name,aggs", [
    ("blocked", STRAT_AGGS),
    ("mixed", STRAT_AGGS + [{"type": "longFirst", "name": "f",
                             "fieldName": "metLong"}])])
def test_stacked_ops_do_not_grow_with_k(name, aggs):
    """The tensor ops of a stacked run at K = 2 and K = 4 are as many (the
    device launches on the card follow them)."""
    gen = DataGenerator(SCHEMA, seed=5)
    port = [_carry(s) for s in gen.segments(4, 2000, IV, datasource="k")]
    q = query_from_json({"queryType": "groupBy", "dataSource": "k",
                         "intervals": [str(IV)], "granularity": "hour",
                         "dimensions": ["dimA"], "aggregations": aggs})
    counts = []
    for k in (2, 4):
        plans = [batching._plan_for(s, [port_grouping.KeyDim(
            "dimA", s.dims["dimA"].cardinality)], i, q.intervals,
            q.granularity, q.aggregations, None, ()) for i, s in
            enumerate(port[:k])]
        assert all(p.eligible for p in plans)
        ops = _OpCount()
        orig = port_grouping.fuse_filter_update_stacked

        def counted(*a, **kw):
            with ops:
                return orig(*a, **kw)
        port_grouping.fuse_filter_update_stacked = counted
        try:
            batching._run_batch(plans, torch.device("cpu"))
        finally:
            port_grouping.fuse_filter_update_stacked = orig
        assert plans[0].spec.strategy == name
        counts.append(ops.n)
    assert counts[0] == counts[1] > 0


# ---------------------------------------------------------------------------
# filters, registers, trees
# ---------------------------------------------------------------------------

def _dim_values(segs, dim, idx):
    return [segs[0][0].dims[dim].dictionary.values[i] for i in idx]


def test_bitmap_filters_and_filtered_aggregators(mixed):
    """A query filter and filtered aggregators with bitmap-eligible trees:
    each plan's words are staged in one wave and stacked."""
    head = _dim_values(mixed, "dimB", [0])[0]
    flt = {"type": "in", "dimension": "dimA",
           "values": _dim_values(mixed, "dimA", range(0, 8, 2))}
    q = {"queryType": "groupBy", "dataSource": "mix", "intervals": [str(IV)],
         "granularity": "all", "dimensions": ["dimA"], "filter": flt,
         "aggregations": [
             {"type": "count", "name": "n"},
             {"type": "filtered", "aggregator": {"type": "count",
                                                 "name": "h"},
              "filter": {"type": "selector", "dimension": "dimB",
                         "value": head}},
             {"type": "filtered", "aggregator": {
                 "type": "longSum", "name": "ls", "fieldName": "metLong"},
              "filter": {"type": "not", "field": {
                  "type": "selector", "dimension": "dimB", "value": head}}}]}
    stats = port_filters.filter_bitmap_stats().snapshot()
    _, got, rs, ps = _run_both(mixed, q)
    assert rs == ps and ps[0]["batches"] == 2
    assert port_filters.filter_bitmap_stats().snapshot()["misses"] \
        > stats["misses"]
    assert all(r["event"]["h"] <= r["event"]["n"] for r in got)


def test_multi_wave_words_equal_single_fills(mixed):
    """stage_device_bitmaps_multi's words equal each segment's own fill,
    and a (segment, key) pair twice in a wave is built once."""
    from druid_tpu_torch.query import filters as PF
    port = mixed[1][:4]
    cpu = torch.device("cpu")
    head = _dim_values(mixed, "dimB", [0])[0]
    fl = PF.filter_from_json({"type": "or", "fields": [
        {"type": "selector", "dimension": "dimB", "value": head},
        {"type": "not", "field": {"type": "in", "dimension": "dimA",
                                  "values": _dim_values(mixed, "dimA",
                                                        [1, 2])}}]})
    R = 4096
    device_pool().clear()
    nodes = [port_filters.plan_filter(fl, s, device_bitmap=True)
             for s in port]
    assert all(isinstance(n, port_filters.DeviceBitmapNode) for n in nodes)
    items = [(s, n, ()) for s, n in zip(port, nodes)] + [(port[0], nodes[0],
                                                          ())]
    before = port_filters.filter_bitmap_stats().snapshot()
    out = port_filters.stage_device_bitmaps_multi(items, R, cpu)
    after = port_filters.filter_bitmap_stats().snapshot()
    assert after["misses"] - before["misses"] == 4
    assert after["hits"] - before["hits"] == 1
    assert out[4][nodes[0].col] is out[0][nodes[0].col]
    for s, n, words in zip(port, nodes, out):
        assert torch.equal(words[n.col],
                           port_filters._fill_single(s, n, R, cpu))
        assert s.device_contains(port_filters.bitmap_pool_key(n, R, None,
                                                              cpu))


def test_register_columns_stack():
    """A hyperUnique over an int8 register column: the columns stack as
    [K, R, width], the width in the digest."""
    ref = _rolled_up(6, n_seg=4)
    segs = _pair(ref)
    q = {"queryType": "groupBy", "dataSource": "hll", "intervals": [
        "2026-07-01/2026-07-02"], "granularity": "all", "dimensions": ["d"],
        "aggregations": [{"type": "hyperUnique", "name": "u",
                          "fieldName": "uu", "log2m": 6},
                         {"type": "longSum", "name": "n",
                          "fieldName": "count"}]}
    _, _, rs, ps = _run_both(segs, q)
    assert rs == ps and ps[0]["batches"] >= 1
    plan = batching._plan_for(segs[1][0], [port_grouping.KeyDim(
        "d", segs[1][0].dims["d"].cardinality)], 0,
        query_from_json(q).intervals, query_from_json(q).granularity,
        query_from_json(q).aggregations, None, ())
    assert ("uu", (64,)) in plan.digest[3]


@pytest.mark.parametrize("i", range(4))
def test_random_trees_batched(i):
    """Random filter trees (tests/test_torch_mega_slice.py) on the stacked
    path: rows equal the reference's."""
    ref = DataGenerator(TREE_SCHEMA, seed=60 + i).segments(
        4, 2500, IV, datasource="mk")
    rng = np.random.default_rng(2000 + i)
    flt = _rand_tree(rng, ref[0], depth=3)
    q = {"queryType": "timeseries", "dataSource": "mk",
         "intervals": [str(IV)], "granularity": "all",
         "aggregations": [{"type": "count", "name": "n"},
                          {"type": "longSum", "name": "s",
                           "fieldName": "metLong"},
                          {"type": "longMin", "name": "lo",
                           "fieldName": "metLong"}],
         "filter": flt.to_json()}
    _, _, rs, ps = _run_both(_pair(ref), q)
    assert rs == ps


# ---------------------------------------------------------------------------
# cross-query
# ---------------------------------------------------------------------------

def _finish(q, ap):
    if q.__class__.__name__ == "TimeseriesQuery":
        return engines.finish_timeseries(q, ap)
    if q.__class__.__name__ == "TopNQuery":
        return engines.finish_topn(q, ap)
    return engines.finish_groupby(q, ap)


def test_cross_query_matches_each_alone(mixed):
    cpu = torch.device("cpu")
    port = mixed[1]
    def in_a(idx):
        return {"type": "in", "dimension": "dimA",
                "values": _dim_values(mixed, "dimA", idx)}

    # two timeseries of one structure, each filter a bitmap node with its
    # own words, share their chunks
    qs = [query_from_json(dict(_q("timeseries"), filter=in_a([1]))),
          query_from_json(dict(_q("timeseries"), filter=in_a([2, 3, 5]))),
          query_from_json(_q("topn")),
          query_from_json(dict(_q("groupby"),
                               context={"batchSegments": False}))]
    fired = []
    before = batching.stats().snapshot()
    multi = engines.make_aggregate_partials_multi(
        [(q, port, None) for q in qs], cpu,
        on_batch=lambda *a: fired.append(a))
    after = batching.stats().snapshot()
    # the two timeseries share their chunks (one per rung); the topN has
    # its own; the opted-out groupBy runs alone
    assert after["batches"] - before["batches"] == 4
    assert sorted(f[:2] for f in fired) == [(1, 4), (1, 4), (2, 8), (2, 8)]
    for q, ap in zip(qs, multi):
        alone = engines.make_aggregate_partials(q, port, cpu)
        _close(_finish(q, alone), _finish(q, ap))


def test_cross_query_check_fails_one_query(mixed):
    cpu = torch.device("cpu")
    port = mixed[1]
    q = query_from_json(_q("timeseries"))

    def cancelled():
        raise TimeoutError("cancelled")

    multi = engines.make_aggregate_partials_multi(
        [(q, port, None), (q, port, cancelled)], cpu)
    assert isinstance(multi[1], TimeoutError)
    _close(_finish(q, engines.make_aggregate_partials(q, port, cpu)),
           _finish(q, multi[0]))


def test_check_runs_between_runs(mixed):
    calls = []
    engines.make_aggregate_partials(query_from_json(_q("timeseries")),
                                    mixed[1], torch.device("cpu"),
                                    check=lambda: calls.append(1))
    assert len(calls) == 2        # before the first run, between the two
