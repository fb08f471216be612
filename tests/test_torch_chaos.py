"""The data-plane chaos harness in the port (druid_tpu_torch/cluster/chaos.py):
the cases of tests/test_chaos_dataplane.py on the port's broker and data
nodes, on the CPU. Under every injected data-node fault a query returns
exact rows (equal to the fault-free oracle, the port's QueryExecutor), a
typed partial with an accurate missingSegments report, or a typed error,
inside its deadline; hedged execution equals unhedged, and the loser's
cancellation is observed through the remote-cancel hook. The
subscription-hub cases (tests/test_chaos_dataplane.py:399, :422, :455) run
on the port's SubscriptionHub: a slow consumer's poll parks for the hub's
clamp, a mid-poll teardown frees the waiter with a typed error, and a tick
hook wakes a parked poll inside its deadline."""
import threading
import time

import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.generator import DataGenerator
from druid_tpu.engine.executor import QueryExecutor as RefExecutor
from druid_tpu.query.model import query_from_json as ref_query
from druid_tpu.utils.intervals import Interval

import druid_tpu_torch.cluster.chaos as chaos_mod
from druid_tpu_torch.cluster import (Broker, DataNode, InventoryView,
                                     ResiliencePolicy, descriptor_for)
from druid_tpu_torch.cluster.chaos import (ChaosDataNode,
                                           DataPlaneChaosHarness, FaultSpec)
from druid_tpu_torch.query.model import query_from_json
from druid_tpu_torch.server.querymanager import (QueryCapacityError,
                                                 QueryInterruptedError,
                                                 QueryTimeoutError)
from tests.conftest import TEST_SCHEMA
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

WEEK = "2026-01-01/2026-01-08"
#: a double sum keeps the parity gate honest: a double-merged partial or a
#: reordered merge shows in its bits
AGGS = [{"type": "count", "name": "rows"},
        {"type": "longSum", "name": "ls", "fieldName": "metLong"},
        {"type": "doubleSum", "name": "ds", "fieldName": "metDouble"}]
_QID = [0]


def _ctx(**extra):
    _QID[0] += 1
    return {"timeout": 15_000, "queryId": f"chaos-{_QID[0]}", **extra}


def _ts_json(**extra):
    return {"queryType": "timeseries", "dataSource": "test",
            "intervals": [WEEK], "granularity": "day", "aggregations": AGGS,
            "context": _ctx(**extra)}


def _ts(**extra):
    return query_from_json(_ts_json(**extra))


def _gb(**extra):
    return query_from_json({
        "queryType": "groupBy", "dataSource": "test", "intervals": [WEEK],
        "granularity": "day", "dimensions": ["dimA"], "aggregations": AGGS,
        "context": _ctx(**extra)})


def _scan(**extra):
    return query_from_json({
        "queryType": "scan", "dataSource": "test", "intervals": [WEEK],
        "columns": ["dimA", "metLong"], "context": _ctx(**extra)})


@pytest.fixture(scope="module")
def ref_segments():
    return DataGenerator(TEST_SCHEMA, seed=42).segments(
        4, 5_000, Interval.of("2026-01-01", "2026-01-05"), datasource="test")


@pytest.fixture(scope="module")
def segments(ref_segments):
    return [_carry(s) for s in ref_segments]


def _harness(segments, **kw):
    return DataPlaneChaosHarness(segments, device="cpu", **kw)


@pytest.fixture()
def harness(segments):
    h = _harness(segments, n_nodes=3, replication=2, seed=11)
    yield h
    h.stop()


def test_oracle_equals_the_reference(harness, ref_segments):
    """The harness's oracle (the port's executor over every segment) gives
    the reference executor's rows."""
    q = _ts_json()
    assert harness.oracle(query_from_json(q)) \
        == RefExecutor(ref_segments).run(ref_query(q))


# ---------------------------------------------------------------------------
# one faulted node, replication covers it: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    FaultSpec("dead"),
    FaultSpec("flap", flap_period=1),
    FaultSpec("error"),
    FaultSpec("shed", retry_after_s=0.01),
    FaultSpec("slow", delay_ms=120),
    FaultSpec("slow", delay_ms=60, heavy_tail_ms=250, tail_prob=0.4),
], ids=["dead", "flap", "error", "shed", "slow", "slow-heavy-tail"])
def test_single_fault_recovers_exact(harness, spec):
    harness.fault("chaos0", spec)
    for q in (_ts(), _gb()):
        o = harness.run_classified(q)
        assert o.kind == "exact", (o.kind, o.error)
        assert o.elapsed_s < 15.0
        harness.verify(q, o)


def test_unknown_fault_mode_rejected():
    with pytest.raises(ValueError, match="unknown fault mode"):
        FaultSpec("melt")


def test_scenarios_are_seeded_deterministic():
    spec = FaultSpec("slow", delay_ms=1, heavy_tail_ms=50, tail_prob=0.3)
    q = _ts()

    def draws(seed):
        node = ChaosDataNode(DataNode("x", device="cpu"), seed=seed)
        node.fault(spec)
        seen = []
        real_sleep = time.sleep
        chaos_mod.time.sleep = lambda s: seen.append(round(s, 6))
        try:
            for _ in range(30):
                node.run_partials(q, [])
        finally:
            chaos_mod.time.sleep = real_sleep
        return seen

    a, b = draws(5), draws(5)
    assert a == b
    assert len(set(a)) == 2, "both the fixed and the heavy-tail delay hit"
    assert draws(6) != a


# ---------------------------------------------------------------------------
# hang: the no-hang contract
# ---------------------------------------------------------------------------

def test_hang_node_hedge_rescues_within_deadline(segments):
    pol = ResiliencePolicy(hedge_min_delay_ms=40,
                           hedge_latency_multiplier=2.0)
    h = _harness(segments, seed=3, policy=pol)
    try:
        warm = _ts()
        h.verify(warm, h.run_classified(warm))
        h.fault("chaos0", FaultSpec("hang", max_hang_s=30.0))
        q = _ts(timeout=5_000)
        o = h.run_classified(q)
        assert o.kind == "exact", (o.kind, o.error)
        assert o.elapsed_s < 5.0
        h.verify(q, o)
        stats = h.broker.resilience.stats.snapshot()
        assert stats["hedges_issued"] >= 1
        assert stats["hedges_won"] >= 1
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline \
                and not h.nodes["chaos0"].cancel_calls:
            time.sleep(0.01)
        assert h.nodes["chaos0"].cancel_calls
    finally:
        h.heal()
        h.stop()


def test_hang_everywhere_degrades_to_typed_partial(segments):
    h = _harness(segments, seed=4)
    try:
        warm = _ts()
        h.verify(warm, h.run_classified(warm))
        for name in h.nodes:
            h.fault(name, FaultSpec("hang", max_hang_s=30.0))
        q = _ts(timeout=900, allowPartialResults=True, hedge=False)
        t0 = time.monotonic()
        o = h.run_classified(q)
        assert o.kind == "partial", (o.kind, o.error)
        assert time.monotonic() - t0 < 3.0, "no hang: deadline bounds it"
        assert set(o.missing) == {str(s.id) for s in segments}
        h.verify(q, o)
    finally:
        h.heal()
        h.stop()


def test_hang_everywhere_strict_is_typed_timeout(segments):
    h = _harness(segments, seed=5)
    try:
        warm = _ts()
        h.verify(warm, h.run_classified(warm))
        for name in h.nodes:
            h.fault(name, FaultSpec("hang", max_hang_s=30.0))
        q = _ts(timeout=900, hedge=False)
        t0 = time.monotonic()
        o = h.run_classified(q)
        assert o.kind == "error"
        assert isinstance(o.error, QueryTimeoutError)
        assert time.monotonic() - t0 < 3.0
    finally:
        h.heal()
        h.stop()


# ---------------------------------------------------------------------------
# storms on every replica: a typed error, or a typed partial when allowed
# ---------------------------------------------------------------------------

def test_429_storm_surfaces_typed_capacity_error(harness):
    for name in harness.nodes:
        harness.fault(name, FaultSpec("shed", retry_after_s=0.01))
    o = harness.run_classified(_ts())
    assert o.kind == "error"
    assert isinstance(o.error, QueryCapacityError)


def test_429_storm_with_partials_degrades(harness):
    for name in harness.nodes:
        harness.fault(name, FaultSpec("shed", retry_after_s=0.01))
    q = _ts(allowPartialResults=True)
    o = harness.run_classified(q)
    assert o.kind == "partial"
    harness.verify(q, o)


def test_error_storm_surfaces_the_node_error(harness):
    for name in harness.nodes:
        harness.fault(name, FaultSpec("error"))
    o = harness.run_classified(_ts())
    assert o.kind == "error"
    assert "error storm" in str(o.error)


def test_dead_cluster_with_partials_returns_typed_empty(harness, segments):
    for name in harness.nodes:
        harness.fault(name, FaultSpec("dead"))
    q = _ts(allowPartialResults=True)
    o = harness.run_classified(q)
    assert o.kind == "partial" and o.rows == []
    assert set(o.missing) == {str(s.id) for s in segments}
    harness.verify(q, o)


# ---------------------------------------------------------------------------
# the hedge parity gate
# ---------------------------------------------------------------------------

def test_hedge_parity_gate(segments):
    slow = FaultSpec("slow", delay_ms=400)
    hedge_on = ResiliencePolicy(hedge_min_delay_ms=30,
                                hedge_latency_multiplier=1.0)
    hedge_off = ResiliencePolicy(hedge_enabled=False)
    results = {}
    for label, pol in (("hedged", hedge_on), ("unhedged", hedge_off)):
        h = _harness(segments, seed=21, policy=pol)
        try:
            warm = _gb()
            h.verify(warm, h.run_classified(warm))
            h.fault("chaos0", slow)
            q = _gb(timeout=20_000)
            o = h.run_classified(q)
            assert o.kind == "exact", (label, o.kind, o.error)
            h.verify(q, o)
            results[label] = o.rows
            stats = h.broker.resilience.stats.snapshot()
            if label == "hedged":
                assert stats["hedges_issued"] >= 1
                assert stats["hedges_won"] >= 1
                deadline = time.monotonic() + 2.0
                while time.monotonic() < deadline and not any(
                        n.cancel_calls for n in h.nodes.values()):
                    time.sleep(0.01)
                assert any(n.cancel_calls for n in h.nodes.values())
                assert stats["hedges_cancelled"] >= 1
            else:
                assert stats["hedges_issued"] == 0
        finally:
            h.heal()
            h.stop()
    assert results["hedged"] == results["unhedged"]


# ---------------------------------------------------------------------------
# the row path under faults
# ---------------------------------------------------------------------------

def test_scan_rows_path_survives_dead_replica(harness):
    harness.fault("chaos0", FaultSpec("dead"))
    q = _scan()
    rows = harness.broker.run(q)
    expect = harness.oracle(q)
    assert sum(len(b["events"]) for b in rows) == \
        sum(len(b["events"]) for b in expect) == 20_000


def test_scan_partial_reports_missing(segments):
    h = _harness(segments, n_nodes=1, replication=1, seed=9)
    try:
        h.fault("chaos0", FaultSpec("dead"))
        o = h.run_classified(_scan(allowPartialResults=True))
        assert o.kind == "partial" and o.rows == []
        assert set(o.missing) == {str(s.id) for s in segments}
    finally:
        h.stop()


def test_chaos_gate_wraps_checkless_clients():
    """Remote clients (RemoteDataNodeClient) take no check kwarg: the gate
    forwards none it was not given."""

    class _ChecklessClient:
        name, tier, alive = "remote", "_default_tier", True

        def run_partials(self, query, segment_ids):
            return "ap", set(segment_ids)

    node = ChaosDataNode(_ChecklessClient(), seed=0)
    assert node.run_partials(_ts(), ["s1"]) == ("ap", {"s1"})

    def checked(query, segment_ids, check=None):
        return ("checked", check)

    node.inner.run_partials = checked
    probe = object()
    assert node.run_partials(_ts(), [], check=probe) == ("checked", probe)


def test_node_side_interrupt_surfaces_typed(segments):
    """A node-side cancellation aborts with the interrupt; it never turns
    into a MissingSegmentsError blaming replica availability."""

    class _InterruptedNode(DataNode):
        def run_partials(self, query, segment_ids, check=None):
            raise QueryInterruptedError("cancelled node-side")

    view = InventoryView()
    n = _InterruptedNode("n1", device="cpu")
    view.register(n)
    for s in segments:
        n.load_segment(s)
        view.announce("n1", descriptor_for(s))
    broker = Broker(view, device="cpu")
    try:
        with pytest.raises(QueryInterruptedError):
            broker.run(_ts(hedge=False))
    finally:
        broker.stop()


def test_heal_restores_exact_service_and_closes_circuits(harness):
    harness.fault("chaos0", FaultSpec("dead"))
    q1 = _ts()
    for _ in range(4):
        o = harness.run_classified(q1)
        assert o.kind == "exact"
    harness.heal("chaos0")
    q2 = _gb()
    o = harness.run_classified(q2)
    assert o.kind == "exact"
    harness.verify(q2, o)


# ---------------------------------------------------------------------------
# long-poll hang scenarios on the port's subscription hub
# (tests/test_chaos_dataplane.py:399, :422, :455)
# ---------------------------------------------------------------------------

def _sub_rig():
    import numpy as np

    from druid_tpu_torch.cluster.metadata import MetadataStore
    from druid_tpu_torch.ingest import (Appenderator, RowBatch,
                                        SegmentAllocator,
                                        StreamAppenderatorDriver)
    from druid_tpu_torch.query.aggregators import (CountAggregator,
                                                   LongSumAggregator)
    from druid_tpu_torch.query.model import TimeseriesQuery
    from druid_tpu_torch.server.subscriptions import SubscriptionHub
    from druid_tpu_torch.utils.intervals import Interval as PInterval

    day = PInterval.of("2026-03-01", "2026-03-02")
    md = MetadataStore()
    app = Appenderator("rt", [CountAggregator("rows"),
                              LongSumAggregator("v", "value")],
                       query_granularity="none")
    driver = StreamAppenderatorDriver(app, SegmentAllocator(md, "day"), md)
    hub = SubscriptionHub(idle_timeout_s=0, device="cpu")
    hub.attach(app)
    rng = np.random.default_rng(7)

    def feed(n, off=0):
        ts = [int(day.start + (off + i) * 1000) for i in range(n)]
        driver.add_batch(RowBatch(ts, {
            "page": [f"p{int(x)}" for x in rng.integers(5, size=n)],
            "value": [int(x) for x in rng.integers(10, size=n)]}))

    q = TimeseriesQuery.of(
        "rt", [day],
        [LongSumAggregator("rows", "rows"), LongSumAggregator("v", "v")],
        granularity="all")
    return hub, feed, q


def test_slow_consumer_poll_parks_clamped_not_wire_bounded():
    """A consumer that asks for an hour of long-poll parks for the hub's
    clamp, not the hour."""
    hub, feed, q = _sub_rig()
    try:
        sid, etag = hub.subscribe(q)
        feed(100)
        hub.tick()
        _rows, etag, _ch = hub.poll(sid, etag=None)
        hub.MAX_POLL_TIMEOUT_S = 0.5      # instance override: fast test
        t0 = time.monotonic()
        rows, new_etag, changed = hub.poll(sid, etag=etag,
                                           timeout_s=3600.0)
        elapsed = time.monotonic() - t0
        assert not changed and rows is None and new_etag == etag
        assert 0.4 <= elapsed < 5.0, (
            f"poll parked {elapsed:.2f}s against a 0.5s clamp")
    finally:
        hub.stop()


def test_mid_poll_hub_teardown_frees_waiter_with_typed_error():
    """stop() while a consumer is parked mid-poll wakes the waiter promptly
    with UnknownSubscriptionError, and the waiter thread joins."""
    from druid_tpu_torch.server.subscriptions import UnknownSubscriptionError

    hub, feed, q = _sub_rig()
    sid, etag = hub.subscribe(q)
    feed(50)
    hub.tick()
    _rows, etag, _ch = hub.poll(sid, etag=None)
    outcome = []

    def poller():
        try:
            outcome.append(hub.poll(sid, etag=etag, timeout_s=30.0))
        except UnknownSubscriptionError as e:
            outcome.append(e)

    t = threading.Thread(target=poller, name="chaos-slow-poller")
    t.start()
    time.sleep(0.2)
    t0 = time.monotonic()
    hub.stop()
    t.join(timeout=5.0)
    elapsed = time.monotonic() - t0
    assert not t.is_alive(), "mid-poll teardown leaked the waiter"
    assert elapsed < 5.0, f"teardown took {elapsed:.2f}s to free the waiter"
    assert len(outcome) == 1
    assert isinstance(outcome[0], UnknownSubscriptionError)


def test_tick_hook_wakes_parked_poll_within_deadline():
    """The scheduler-driven tick path: a poll parked on an unchanged etag
    is woken by the tick hook observing new data, well inside its
    deadline; teardown removes the hook from the driver."""
    class _TickDriver:
        def __init__(self):
            self.hooks = []
            self._stop = threading.Event()
            self._t = None

        def add_tick_hook(self, fn):
            self.hooks.append(fn)

        def remove_tick_hook(self, fn):
            self.hooks.remove(fn)

        def start(self):
            def loop():
                while not self._stop.wait(0.05):
                    for fn in list(self.hooks):
                        fn()
            self._t = threading.Thread(target=loop, name="chaos-ticker")
            self._t.start()

        def stop(self):
            self._stop.set()
            self._t.join(timeout=5.0)
            assert not self._t.is_alive()

    hub, feed, q = _sub_rig()
    driver = _TickDriver()
    hub.drive_with(driver)
    driver.start()
    try:
        sid, etag = hub.subscribe(q)
        feed(60)
        deadline_wait = time.monotonic() + 10.0
        while time.monotonic() < deadline_wait:
            rows, etag, changed = hub.poll(sid, etag=etag, timeout_s=0.0)
            if changed:
                break
            time.sleep(0.05)
        t0 = time.monotonic()
        feed(40, off=60)
        rows, new_etag, changed = hub.poll(sid, etag=etag, timeout_s=10.0)
        elapsed = time.monotonic() - t0
        assert changed and rows is not None
        assert rows[0]["result"]["rows"] == 100
        assert elapsed < 5.0, (
            f"tick hook took {elapsed:.2f}s to wake a 10s poll")
    finally:
        hub.stop()
        driver.stop()
        assert driver.hooks == [], "hub.stop() left its tick hook behind"
