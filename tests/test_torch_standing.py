"""The port's standing queries (druid_tpu_torch/engine/standing.py) on the
CPU, against the reference package's.

THE gate is incremental parity: every emitted snapshot equals, bit for bit
(floats included: dict == compares float bits), the port's from-scratch
re-scan of the same sinks and an ordinary port QueryExecutor run over the
same world, under randomized append/persist/publish schedules, through the
exactly-once publish cutover; and it equals the reference's snapshot after
the same schedule (counts and longs exact, the double sums within 1e-5 of
their magnitude: their inputs are non-negative). `standing.set_enabled
(False)` (the reference's DRUID_TPU_STANDING=0; the port reads no
environment flag) restores the re-scan world.

The reference's carry-bridge case tests `Segment.adopt_carries_from`,
which the port does not have (ROADMAP A7): its counterpart here holds the
device pool's entry count flat across refolds of a live hydrant, with every
refold equal to the re-scan (no snapshot serves a block staged for an
earlier generation). The reference's compile-once case becomes the
batching's stacked-program cache: same-shape ticks build no new program.
"""
import gc
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import druid_tpu.cluster.metadata as r_metadata
import druid_tpu.engine.standing as r_standing
import druid_tpu.ingest as r_ingest
import druid_tpu.query.aggregators as r_aggs
import druid_tpu.query.model as r_model
from druid_tpu.utils.intervals import Interval as RInterval

import druid_tpu_torch.cluster.metadata as p_metadata
import druid_tpu_torch.engine.standing as standing_mod
import druid_tpu_torch.ingest as p_ingest
import druid_tpu_torch.query.aggregators as p_aggs
import druid_tpu_torch.query.model as p_model
from druid_tpu_torch.data.devicepool import device_pool
from druid_tpu_torch.engine import QueryExecutor
from druid_tpu_torch.engine.standing import (StandingIneligible,
                                             StandingMetricsMonitor,
                                             StandingQuery)
from druid_tpu_torch.ingest import (Appenderator, RowBatch, SegmentAllocator,
                                    StreamAppenderatorDriver)
from druid_tpu_torch.query.aggregators import (DoubleSumAggregator,
                                               LongMaxAggregator,
                                               LongSumAggregator)
from druid_tpu_torch.query.model import (GroupByQuery, ScanQuery,
                                         TimeseriesQuery)
from druid_tpu_torch.utils.intervals import Interval
from tests.test_torch_ingest import close

torch.set_num_threads(1)

DAY = Interval.of("2026-03-01", "2026-03-02")
T0 = DAY.start
HOUR = 3_600_000

REF = SimpleNamespace(MD=r_metadata, I=r_ingest, A=r_aggs, M=r_model,
                      S=r_standing, DAY=RInterval.of("2026-03-01",
                                                     "2026-03-02"), dev={})
PORT = SimpleNamespace(MD=p_metadata, I=p_ingest, A=p_aggs, M=p_model,
                       S=standing_mod, DAY=DAY, dev={"device": "cpu"})


def SPECS(pk=PORT):
    return [pk.A.CountAggregator("rows"), pk.A.LongSumAggregator("v", "value"),
            pk.A.DoubleSumAggregator("d", "dvalue")]


# rolled-up data re-queries through the combining forms
def QSPECS(pk=PORT):
    return [pk.A.LongSumAggregator("rows", "rows"),
            pk.A.LongSumAggregator("v", "v"),
            pk.A.DoubleSumAggregator("d", "d"),
            pk.A.LongMaxAggregator("mx", "v")]


def _batch_cols(rng, n, t_lo=0, t_hi=24 * HOUR, card=5):
    ts = (T0 + rng.integers(t_lo, t_hi, size=n)).astype(np.int64)
    return ts.tolist(), {
        "page": [f"p{int(x)}" for x in rng.integers(card, size=n)],
        "value": [int(x) for x in rng.integers(0, 100, size=n)],
        "dvalue": [float(x) for x in rng.random(n)]}


def _batch(rng, n, **kw):
    return RowBatch(*_batch_cols(rng, n, **kw))


def _rig(max_rows_per_hydrant=200, granularity="day", pk=PORT):
    md = pk.MD.MetadataStore()
    app = pk.I.Appenderator("rt", SPECS(pk), query_granularity="none",
                            max_rows_per_hydrant=max_rows_per_hydrant)
    driver = pk.I.StreamAppenderatorDriver(
        app, pk.I.SegmentAllocator(md, granularity), md)
    return md, app, driver


def QUERIES(pk=PORT):
    A, M, D = pk.A, pk.M, pk.DAY
    return [
        M.TimeseriesQuery.of("rt", [D], QSPECS(pk), granularity="hour"),
        M.TimeseriesQuery.of("rt", [D], QSPECS(pk), granularity="all"),
        M.GroupByQuery.of("rt", [D], ["page"],
                          [A.LongSumAggregator("rows", "rows"),
                           A.DoubleSumAggregator("d", "d")],
                          granularity="hour"),
        M.TopNQuery.of("rt", [D], "page", "rows", 3,
                       [A.LongSumAggregator("rows", "rows"),
                        A.DoubleSumAggregator("d", "d")]),
    ]


def _schedule(seed, steps=30):
    """The ops of one randomized schedule: ("add", ts, cols), ("persist",)
    or ("publish",), made from a seed with numpy."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(steps):
        op = rng.random()
        if op < 0.70:
            ops.append(("add",) + _batch_cols(rng,
                                              int(rng.integers(20, 120))))
        elif op < 0.88:
            ops.append(("persist",))
        else:
            ops.append(("publish",))
    return ops


def _drive(pk, qi, ops, on_step=None):
    """Run one schedule through package `pk`; returns each step's rows."""
    md, app, driver = _rig(pk=pk)
    sq = pk.S.StandingQuery(QUERIES(pk)[qi], [app], **pk.dev)
    publishes = 0
    out = []
    try:
        for op in ops:
            if op[0] == "add":
                driver.add_batch(pk.I.RowBatch(op[1], op[2]))
            elif op[0] == "persist":
                app.persist_all()
            else:
                cur = md.datasource_metadata("rt")
                assert driver.publish_all(
                    cur, {"partitions": {"0": publishes + 1}})
                publishes += 1
            sq.tick()
            out.append(sq.rows())
            if on_step is not None:
                on_step(sq)
    finally:
        sq.close()
    return out


@pytest.mark.parametrize("qi", range(4))
def test_incremental_parity_randomized_schedule(qi):
    """Randomized append/persist/publish churn: after every mutation the
    port's snapshot equals its own re-scan and an executor run over the
    same world bit for bit, and the reference's snapshot after the same
    schedule."""
    ops = _schedule(100 + qi)
    q = QUERIES()[qi]

    def gate(sq):
        rows = sq.rows()
        assert rows == sq.rescan_rows()
        assert rows == QueryExecutor(device="cpu").run(
            q, segments=sq.world_segments())
    got = _drive(PORT, qi, ops, gate)
    want = _drive(REF, qi, ops)
    for step, (w, g) in enumerate(zip(want, got)):
        close(w, g, (step,))


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_randomized_schedules_bit_identical_to_rescan(seed):
    """More schedules, with a groupBy by page and hour carrying a min, a
    max and a double sum, on two hourly sinks: every step's snapshot is
    bit-identical to the re-scan, each hydrant folds once, and the publish
    cutovers count each row exactly once."""
    rng = np.random.default_rng(seed)
    md, app, driver = _rig(max_rows_per_hydrant=90, granularity="hour")
    q = GroupByQuery.of("rt", [DAY], ["page"],
                        [LongSumAggregator("rows", "rows"),
                         LongMaxAggregator("mx", "v"),
                         p_aggs.LongMinAggregator("mn", "v"),
                         DoubleSumAggregator("d", "d")], granularity="hour")
    sq = StandingQuery(q, [app], device="cpu")
    ingested = publishes = 0
    try:
        for _ in range(25):
            op = rng.random()
            if op < 0.75:
                n = int(rng.integers(10, 150))
                driver.add_batch(_batch(rng, n, t_hi=3 * HOUR))
                ingested += n
            elif op < 0.9:
                app.persist_all()
            else:
                cur = md.datasource_metadata("rt")
                assert driver.publish_all(
                    cur, {"partitions": {"0": publishes + 1}})
                publishes += 1
            s0 = standing_mod.stats().snapshot()
            world_before = {id(s) for s in sq.world_segments()}
            sq.tick()
            s1 = standing_mod.stats().snapshot()
            world = sq.world_segments()
            new = [s for s in world if id(s) not in world_before]
            # a tick folds at most the segments new to the world (a
            # sealed-live promotion folds nothing)
            assert s1["folds"] - s0["folds"] <= len(new)
            rows = sq.rows()
            assert rows == sq.rescan_rows()
            assert sum(r["event"]["rows"] for r in rows) == ingested
    finally:
        sq.close()


def test_standing_disabled_restores_rescan_world():
    """set_enabled(False): every tick recomputes from scratch — results
    identical, but the fold counter shows the whole world refolding."""
    rng = np.random.default_rng(7)
    md, app, driver = _rig(max_rows_per_hydrant=50)
    sq = StandingQuery(QUERIES()[0], [app], device="cpu")
    try:
        for _ in range(4):
            driver.add_batch(_batch(rng, 60))
            app.persist_all()
        sq.tick()
        baseline = sq.rows()
        n_world = len(sq.world_segments())
        assert n_world > 2
        prev = standing_mod.set_enabled(False)
        try:
            assert standing_mod.enabled() is False
            s0 = standing_mod.stats().snapshot()
            sq.tick()
            s1 = standing_mod.stats().snapshot()
            assert s1["folds"] - s0["folds"] >= n_world
            assert sq.rows() == baseline
        finally:
            assert standing_mod.set_enabled(prev) is False
        sq.tick()
        s2 = standing_mod.stats().snapshot()
        sq.tick()
        s3 = standing_mod.stats().snapshot()
        assert s3["folds"] == s2["folds"]
        assert sq.rows() == baseline
    finally:
        sq.close()


def test_ticks_fold_only_the_delta():
    rng = np.random.default_rng(3)
    md, app, driver = _rig(max_rows_per_hydrant=100)
    sq = StandingQuery(QUERIES()[0], [app], device="cpu")
    try:
        for _ in range(5):
            driver.add_batch(_batch(rng, 120))
            app.persist_all()
        sq.tick()
        assert len(sq.world_segments()) >= 5
        stats0 = standing_mod.stats().snapshot()
        assert sq.tick() is None                  # quiet tick: no fold
        stats1 = standing_mod.stats().snapshot()
        assert stats1["folds"] == stats0["folds"]
        driver.add_batch(_batch(rng, 10))         # one fold: the live one
        assert sq.tick() is not None
        stats2 = standing_mod.stats().snapshot()
        assert stats2["folds"] - stats1["folds"] == 1
        assert sq.rows() == sq.rescan_rows()
        assert sq.tick() is None                  # post-compaction marker
        assert standing_mod.stats().snapshot()["folds"] == stats2["folds"]
        app.persist_all()                         # sealed-live promotion
        sq.tick()
        stats3 = standing_mod.stats().snapshot()
        assert stats3["folds"] == stats2["folds"]
        assert sq.rows() == sq.rescan_rows()
    finally:
        sq.close()


def test_publish_cutover_exactly_once():
    rng = np.random.default_rng(11)
    md, app, driver = _rig()
    q = TimeseriesQuery.of("rt", [DAY], [LongSumAggregator("rows", "rows")],
                           granularity="all")
    sq = StandingQuery(q, [app], device="cpu")
    try:
        driver.add_batch(_batch(rng, 300))
        sq.tick()
        assert sq.rows()[0]["result"]["rows"] == 300
        c0 = standing_mod.stats().snapshot()["cutovers"]
        assert driver.publish_all(None, {"partitions": {"0": 1}})
        assert sq.tick() is not None
        assert standing_mod.stats().snapshot()["cutovers"] == c0 + 1
        assert sq.rows()[0]["result"]["rows"] == 300
        world = sq.world_segments()
        assert len(world) == 1
        assert sq.rows() == QueryExecutor(device="cpu").run(q, segments=world)
        driver.add_batch(_batch(rng, 50))
        sq.tick()
        assert sq.rows()[0]["result"]["rows"] == 350
        assert sq.rows() == sq.rescan_rows()
    finally:
        sq.close()


def test_dropped_without_publish_removes_contribution():
    rng = np.random.default_rng(13)
    md, app, driver = _rig()
    q = TimeseriesQuery.of("rt", [DAY], [LongSumAggregator("rows", "rows")],
                           granularity="all")
    sq = StandingQuery(q, [app], device="cpu")
    try:
        idents = driver.add_batch(_batch(rng, 100))
        sq.tick()
        assert sq.rows()[0]["result"]["rows"] == 100
        app.drop(idents)
        sq.tick()
        assert sq.rows() == [] and sq.world_segments() == []
    finally:
        sq.close()


def test_same_shape_ticks_reuse_the_stacked_program(monkeypatch):
    """The compile-once contract, in the port's terms: ticks whose new
    hydrants share one shape run through one stacked program
    (engine/batching.py builds it once per structure); later same-shape
    ticks build none."""
    import collections
    from druid_tpu_torch.engine import batching
    monkeypatch.setattr(batching, "_PROGRAM_CACHE",
                        collections.OrderedDict())
    builds = []
    real = batching._build_stacked_fn

    def counted(*a, **k):
        builds.append(1)
        return real(*a, **k)
    monkeypatch.setattr(batching, "_build_stacked_fn", counted)
    md, app, driver = _rig(max_rows_per_hydrant=10 ** 6, granularity="hour")
    q = TimeseriesQuery.of("rt", [DAY], [LongSumAggregator("rows", "rows"),
                                         LongSumAggregator("v", "v")],
                           granularity="hour")
    sq = StandingQuery(q, [app], device="cpu")

    def feed(k):
        # two hourly sinks, 100 rows each, every page and the value range's
        # ends present: each tick seals two hydrants of one shape
        for h in range(2):
            ts = [int(T0 + h * HOUR + k * 1000 + i) for i in range(100)]
            driver.add_batch(RowBatch(ts, {
                "page": [f"p{i % 5}" for i in range(100)],
                "value": [(i * 37) % 100 for i in range(100)],
                "dvalue": [0.5] * 100}))
        app.persist_all()
    try:
        feed(0)
        sq.tick()
        first = len(builds)
        assert first >= 1
        b0 = batching.stats().snapshot()
        for k in range(1, 5):
            feed(k)
            sq.tick()
        assert len(builds) == first, \
            "later same-shape ticks must not rebuild the stacked program"
        assert batching.stats().snapshot()["batches"] - b0["batches"] >= 4
        assert sq.rows() == sq.rescan_rows()
    finally:
        sq.close()


def test_watermark_bucket_emission():
    md, app, driver = _rig()
    q = TimeseriesQuery.of("rt", [DAY], [LongSumAggregator("rows", "rows")],
                           granularity="hour",
                           context={"standingEmit": "bucket"})
    sq = StandingQuery(q, [app], device="cpu")
    try:
        def add_at(ms, n=5):
            ts = [int(T0 + ms + i) for i in range(n)]
            driver.add_batch(RowBatch(ts, {
                "page": ["a"] * n, "value": [1] * n, "dvalue": [0.0] * n}))
        add_at(10 * HOUR)
        snap = sq.tick()
        assert snap is not None and snap.sealed_through == T0 + 10 * HOUR
        add_at(10 * HOUR + 1000)
        assert sq.tick() is None
        add_at(11 * HOUR)
        snap = sq.tick()
        assert snap is not None and snap.sealed_through == T0 + 11 * HOUR
        assert snap.rows == sq.rescan_rows()
        add_at(2 * HOUR)                  # late data into a sealed bucket
        snap = sq.tick()
        assert snap is not None and snap.rows == sq.rescan_rows()
        assert snap.watermark == T0 + 11 * HOUR + 4
    finally:
        sq.close()


def test_eligibility_rejections():
    md, app, driver = _rig()
    with pytest.raises(StandingIneligible):
        StandingQuery(ScanQuery.of("rt", [DAY]), [app], device="cpu")
    with pytest.raises(StandingIneligible):
        StandingQuery(TimeseriesQuery.of("rt", [DAY], QSPECS(),
                                         context={"bySegment": True}),
                      [app], device="cpu")
    with pytest.raises(StandingIneligible):
        StandingQuery(TimeseriesQuery.of(
            "rt", [Interval.of("2000-01-01", "2100-01-01")], QSPECS(),
            granularity="minute"), [app], device="cpu")
    with pytest.raises(StandingIneligible):
        StandingQuery(TimeseriesQuery.of(
            "rt", [Interval.eternity()], QSPECS(), granularity="minute"),
            [app], device="cpu")
    with pytest.raises(StandingIneligible):
        StandingQuery(TimeseriesQuery.of(
            "rt", [Interval.eternity()], QSPECS(), granularity="month"),
            [app], device="cpu")
    with pytest.raises(StandingIneligible):
        StandingQuery(TimeseriesQuery.of(
            "rt", [DAY], QSPECS(), context={"standingEmit": "sometimes"}),
            [app], device="cpu")
    with pytest.raises(ValueError):
        StandingQuery(TimeseriesQuery.of("other_ds", [DAY], QSPECS()), [app],
                      device="cpu")
    assert standing_mod.resolve_emit(TimeseriesQuery.of(
        "rt", [DAY], QSPECS(), granularity="month",
        context={"standingEmit": "bucket"})) == "change"


def test_refolds_of_a_live_hydrant_keep_the_pool_flat():
    """The port's counterpart of the reference's carry bridge: a live
    hydrant refolded on every tick (a new snapshot Segment each time)
    leaves the device pool's entry count and resident bytes flat, since the
    previous snapshot's entries leave with it; and every refold equals the
    re-scan, so no snapshot answers from an earlier generation's block."""
    rng = np.random.default_rng(29)
    md, app, driver = _rig(max_rows_per_hydrant=10 ** 6)
    q = GroupByQuery.of("rt", [DAY], ["page"],
                        [LongSumAggregator("rows", "rows"),
                         DoubleSumAggregator("d", "d")], granularity="hour")
    sq = StandingQuery(q, [app], device="cpu")
    pool = device_pool()
    counts = []
    try:
        driver.add_batch(_batch(rng, 400))
        for i in range(12):
            driver.add_batch(_batch(rng, 3))
            assert sq.tick() is not None
            assert sq.rows() == sq.rescan_rows()
            gc.collect()
            snap = pool.snapshot()
            counts.append((snap.entries, snap.resident_bytes))
        assert len(sq.world_segments()) == 1
    finally:
        sq.close()
    steady = counts[2:]
    assert len({c for c, _ in steady}) == 1, counts
    assert max(b for _, b in steady) <= min(b for _, b in steady) * 1.05


def test_concurrent_reader_exactly_once_through_persist_publish():
    """A reader hammering the broker while persist_hydrant/publish_all
    churn counts each row exactly once in EVERY observation."""
    from druid_tpu_torch.cluster import Broker, DataNode, InventoryView
    from druid_tpu_torch.cluster.realtime import RealtimeServer

    rng = np.random.default_rng(23)
    md = p_metadata.MetadataStore()
    app = Appenderator("rt", SPECS(), query_granularity="none",
                       max_rows_per_hydrant=64)
    view = InventoryView()
    rts = RealtimeServer("rt-node", view, device="cpu")
    rts.attach(app)
    historical = DataNode("hist", device="cpu")
    view.register(historical)

    def handoff(pairs):
        for desc, seg in pairs:
            historical.load_segment(seg, desc)
            view.announce(historical.name, desc)

    driver = StreamAppenderatorDriver(app, SegmentAllocator(md, "day"), md,
                                      handoff=handoff)
    broker = Broker(view, device="cpu")
    n = 600
    driver.add_batch(_batch(rng, n))
    q = TimeseriesQuery.of("rt", [DAY], [LongSumAggregator("rows", "rows")],
                           granularity="all")
    errors, counts = [], []
    stop = threading.Event()

    def reader():
        try:
            while not stop.is_set():
                rows = broker.run(q)
                counts.append(rows[0]["result"]["rows"] if rows else 0)
        except Exception as e:            # pragma: no cover - must not
            errors.append(e)

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for _ in range(3):
            app.persist_all()
        assert driver.publish_all(None, {"partitions": {"0": 1}})
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    try:
        assert all(not t.is_alive() for t in threads)
        assert errors == [] and counts
        assert {c for c in counts} == {n}
        assert broker.run(q)[0]["result"]["rows"] == n
    finally:
        broker.stop()


def test_standing_monitor_names_in_catalog():
    from druid_tpu_torch.obs.catalog import validate_emitted
    from druid_tpu_torch.utils.emitter import InMemoryEmitter, ServiceEmitter
    sink = InMemoryEmitter()
    StandingMetricsMonitor().do_monitor(ServiceEmitter("t", "h", sink))
    names = {e.metric for e in sink.events}
    assert names == {"query/standing/ticks", "query/standing/folds",
                     "query/standing/rows", "query/standing/cutovers"}
    assert validate_emitted(names) == []
