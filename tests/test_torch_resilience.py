"""The port's broker-side fault tolerance (druid_tpu_torch/cluster/
resilience.py): the host cases of tests/test_resilience.py on the port's
copies — decorrelated jitter, circuit breakers and their half-open probe,
the latency EWMA and hedge delay, typed partial results, the broker's
circuit, partial results, a partial never cached, strict mode, the latency
feed, the scatter pool hoisted and released, and the monitor's deltas
(held against the reference's metrics catalog). The jitter and the
breakers' cooldowns also match the reference's draw for draw. The wire and
HTTP cases wait for the HTTP data node."""
import json
import random
import time

import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.cluster import resilience as ref_resilience
from druid_tpu.data.generator import DataGenerator
from druid_tpu.obs import catalog
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.cluster import (Broker, DataNode, InventoryView,
                                     LruCache, MissingSegmentsError,
                                     PartialResult, ResiliencePolicy,
                                     descriptor_for)
from druid_tpu_torch.cluster.resilience import (CLOSED, HALF_OPEN, OPEN,
                                                BrokerResilience,
                                                CircuitBreaker,
                                                CircuitRegistry,
                                                ResilienceMetricsMonitor,
                                                decorrelated_jitter)
from druid_tpu_torch.engine import QueryExecutor
from tests.conftest import TEST_SCHEMA
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

Q = {"queryType": "timeseries", "dataSource": "test",
     "intervals": ["2026-01-01/2026-01-08"], "granularity": "all",
     "aggregations": [{"type": "count", "name": "rows"},
                      {"type": "longSum", "name": "ls",
                       "fieldName": "metLong"}]}
PARTIAL_Q = dict(Q, context={"allowPartialResults": True})


@pytest.fixture(scope="module")
def segments():
    return [_carry(s) for s in DataGenerator(TEST_SCHEMA, seed=42).segments(
        4, 5_000, Interval.of("2026-01-01", "2026-01-05"),
        datasource="test")]


def _local(segs, q=Q):
    return QueryExecutor(segs, device="cpu").run_json(q)


# ---------------------------------------------------------------------------
# decorrelated jitter
# ---------------------------------------------------------------------------

def test_jitter_within_bounds_and_decorrelated():
    rng = random.Random(0)
    prev = 1.0
    sleeps = []
    for _ in range(200):
        s = decorrelated_jitter(rng, 1.0, prev, 30.0)
        assert 1.0 <= s <= 30.0
        sleeps.append(s)
        prev = s
    assert len({round(s, 6) for s in sleeps}) > 100
    assert max(sleeps) > 2.0


def test_jitter_respects_cap_and_base():
    rng = random.Random(1)
    for _ in range(100):
        assert decorrelated_jitter(rng, 5.0, 100.0, 8.0) <= 8.0
        assert decorrelated_jitter(rng, 5.0, 0.0, 8.0) >= 5.0
    assert decorrelated_jitter(rng, 50.0, 1.0, 8.0) == pytest.approx(8.0)


def test_jitter_deterministic_and_equal_to_reference():
    for seed in (7, 11):
        got, want = random.Random(seed), random.Random(seed)
        prev_g = prev_w = 1.0
        for _ in range(50):
            prev_g = decorrelated_jitter(got, 1.0, prev_g, 10.0)
            prev_w = ref_resilience.decorrelated_jitter(want, 1.0, prev_w,
                                                        10.0)
            assert prev_g == prev_w


# ---------------------------------------------------------------------------
# circuit breakers
# ---------------------------------------------------------------------------

def _clocked(mod, threshold=3, cooldown=5.0):
    now = [0.0]
    reg = mod.CircuitRegistry(
        mod.ResiliencePolicy(circuit_failure_threshold=threshold,
                             circuit_cooldown_s=cooldown,
                             circuit_cooldown_cap_s=cooldown * 6),
        seed=0, clock=lambda: now[0])
    return reg, now


def _registry(threshold=3, cooldown=5.0):
    import druid_tpu_torch.cluster.resilience as mod
    return _clocked(mod, threshold, cooldown)


def test_breaker_opens_after_consecutive_failures():
    reg, _ = _registry(threshold=3)
    for _ in range(2):
        reg.on_failure("s1")
    assert reg.state_of("s1") == CLOSED and reg.closed("s1")
    reg.on_failure("s1")
    assert reg.state_of("s1") == OPEN and not reg.closed("s1")
    assert reg.snapshot() == {"open": 1, "trips": 1, "probes": 0}
    assert reg.failures_by_server() == {"s1": 3}


def test_success_resets_consecutive_count():
    reg, _ = _registry(threshold=3)
    reg.on_failure("s1")
    reg.on_failure("s1")
    reg.on_success("s1")
    reg.on_failure("s1")
    reg.on_failure("s1")
    assert reg.state_of("s1") == CLOSED
    # the cumulative count is not reset by a success
    assert reg.failures_by_server() == {"s1": 4}


def test_half_open_probe_cycle():
    reg, now = _registry(threshold=1, cooldown=5.0)
    reg.on_failure("s1")
    assert reg.state_of("s1") == OPEN
    assert not reg.probe_candidate("s1"), "cooldown not elapsed"
    now[0] = 100.0
    assert reg.probe_candidate("s1")
    reg.begin_probe("s1")
    assert reg.state_of("s1") == HALF_OPEN
    assert not reg.probe_candidate("s1"), "one probe in flight"
    reg.on_success("s1")
    assert reg.state_of("s1") == CLOSED
    assert reg.snapshot()["probes"] == 1


def test_half_open_failure_reopens_with_fresh_cooldown():
    reg, now = _registry(threshold=1, cooldown=5.0)
    reg.on_failure("s1")
    now[0] = 100.0
    reg.begin_probe("s1")
    reg.on_failure("s1")
    assert reg.state_of("s1") == OPEN
    assert not reg.probe_candidate("s1"), "fresh cooldown started"
    assert reg.snapshot()["trips"] == 2


def test_cooldown_is_jittered_and_equal_to_reference():
    pol = ResiliencePolicy(circuit_failure_threshold=1,
                           circuit_cooldown_s=1.0,
                           circuit_cooldown_cap_s=30.0)
    rpol = ref_resilience.ResiliencePolicy(circuit_failure_threshold=1,
                                           circuit_cooldown_s=1.0,
                                           circuit_cooldown_cap_s=30.0)
    b = CircuitBreaker(pol, random.Random(3), clock=lambda: 0.0)
    rb = ref_resilience.CircuitBreaker(rpol, random.Random(3),
                                       clock=lambda: 0.0)
    spans = []
    for _ in range(20):
        b.trip()
        rb.trip()
        assert 1.0 <= b._cooldown_until <= 30.0
        assert b._cooldown_until == rb._cooldown_until
        spans.append(b._cooldown_until)
    assert len(set(spans)) > 10


def test_disabled_policy_keeps_everything_closed():
    reg = CircuitRegistry(ResiliencePolicy(circuit_enabled=False), seed=0)
    for _ in range(10):
        reg.on_failure("s1")
    assert reg.closed("s1")


# ---------------------------------------------------------------------------
# the view's latency EWMA and the hedge delay
# ---------------------------------------------------------------------------

def test_view_latency_ewma():
    view = InventoryView()
    assert view.latency_ms("a") is None
    view.note_latency("a", 100.0, alpha=0.5)
    assert view.latency_ms("a") == 100.0
    view.note_latency("a", 50.0, alpha=0.5)
    assert view.latency_ms("a") == pytest.approx(75.0)


def test_hedge_delay_derives_from_ewma():
    view = InventoryView()
    res = BrokerResilience(ResiliencePolicy(hedge_min_delay_ms=50,
                                            hedge_latency_multiplier=3.0))
    assert res.hedge_delay_s(view, "a") == pytest.approx(0.05)
    view.note_latency("a", 200.0, alpha=1.0)
    assert res.hedge_delay_s(view, "a") == pytest.approx(0.6)


def test_partial_result_is_a_typed_list():
    rows = [{"a": 1}, {"a": 2}]
    p = PartialResult(rows, ["seg2", "seg1", "seg2"])
    assert list(p) == rows and len(p) == 2
    assert p.missing_segments == ["seg1", "seg2"], "sorted and deduped"
    assert p.response_context() == {"partial": True,
                                    "missingSegments": ["seg1", "seg2"]}
    assert json.dumps(p)


# ---------------------------------------------------------------------------
# the broker: circuits, partial results, the EWMA feed
# ---------------------------------------------------------------------------

class _DeadNode(DataNode):
    def __init__(self, name):
        super().__init__(name, device="cpu")
        self.calls = 0

    def run_partials(self, query, segment_ids, check=None):
        self.calls += 1
        raise ConnectionError(f"[{self.name}] down")


def _two_replica_cluster(segments, policy=None, seed=0):
    view = InventoryView()
    dead = _DeadNode("dead")
    good = DataNode("good", device="cpu")
    for n in (dead, good):
        view.register(n)
        for s in segments:
            n.load_segment(s)
            view.announce(n.name, descriptor_for(s))
    return view, dead, good, Broker(view, seed=seed, device="cpu",
                                    resilience_policy=policy)


def _heal(node):
    node.run_partials = lambda query, sids, check=None: \
        DataNode.run_partials(node, query, sids, check=check)


def test_broker_opens_circuit_and_stops_paying_the_dead_node(segments):
    pol = ResiliencePolicy(circuit_failure_threshold=2,
                           circuit_cooldown_s=60.0,
                           circuit_cooldown_cap_s=60.0,
                           hedge_enabled=False)
    view, dead, good, broker = _two_replica_cluster(segments, pol)
    expect = _local(segments)
    for _ in range(12):
        assert broker.run_json(Q) == expect
    assert broker.resilience.circuits.state_of("dead") == OPEN
    calls_at_trip = dead.calls
    for _ in range(5):
        assert broker.run_json(Q) == expect
    assert dead.calls == calls_at_trip
    assert set(broker.resilience.circuits.failures_by_server()) == {"dead"}
    broker.stop()


def test_broker_half_open_probe_recovers(segments):
    pol = ResiliencePolicy(circuit_failure_threshold=1,
                           circuit_cooldown_s=0.01,
                           circuit_cooldown_cap_s=0.02,
                           hedge_enabled=False)
    view, dead, good, broker = _two_replica_cluster(segments, pol)
    expect = _local(segments)
    for _ in range(3):
        assert broker.run_json(Q) == expect
    assert broker.resilience.circuits.state_of("dead") == OPEN
    _heal(dead)
    time.sleep(0.05)
    for _ in range(20):
        assert broker.run_json(Q) == expect
        if broker.resilience.circuits.state_of("dead") == CLOSED:
            break
    assert broker.resilience.circuits.state_of("dead") == CLOSED
    assert broker.resilience.circuits.snapshot()["probes"] >= 1
    broker.stop()


def test_broker_partial_results_on_exhausted_replicas(segments):
    view = InventoryView()
    only = _DeadNode("only")
    live = DataNode("live", device="cpu")
    view.register(only)
    view.register(live)
    for i, s in enumerate(segments):
        n = only if i % 2 == 0 else live
        n.load_segment(s)
        view.announce(n.name, descriptor_for(s))
    broker = Broker(view, device="cpu")
    rows = broker.run_json(PARTIAL_Q)
    assert isinstance(rows, PartialResult)
    lost = {str(s.id) for i, s in enumerate(segments) if i % 2 == 0}
    assert set(rows.missing_segments) == lost
    survivors = [s for i, s in enumerate(segments) if i % 2 == 1]
    assert list(rows) == _local(survivors, PARTIAL_Q)
    snap = broker.resilience.stats.snapshot()
    assert snap["partial_queries"] == 1
    assert snap["partial_missing_segments"] == len(lost)
    broker.stop()


def test_partial_never_populates_result_cache(segments):
    view = InventoryView()
    flaky = _DeadNode("flaky")
    view.register(flaky)
    for s in segments:
        flaky.load_segment(s)
        view.announce("flaky", descriptor_for(s))
    broker = Broker(view, cache=LruCache(), device="cpu")
    rows = broker.run_json(PARTIAL_Q)
    assert isinstance(rows, PartialResult) and list(rows) == []
    _heal(flaky)
    expect = _local(segments, PARTIAL_Q)
    got = None
    for _ in range(10):
        got = broker.run_json(PARTIAL_Q)
        if not getattr(got, "missing_segments", None):
            break
    assert list(got) == expect
    assert getattr(got, "missing_segments", None) is None
    broker.stop()


def test_strict_mode_unchanged_without_context_flag(segments):
    view = InventoryView()
    only = _DeadNode("only")
    view.register(only)
    for s in segments:
        only.load_segment(s)
        view.announce("only", descriptor_for(s))
    broker = Broker(view, device="cpu")
    with pytest.raises(MissingSegmentsError):
        broker.run_json(Q)
    broker.stop()


def test_broker_feeds_latency_ewma(segments):
    view = InventoryView()
    node = DataNode("n1", device="cpu")
    view.register(node)
    for s in segments:
        node.load_segment(s)
        view.announce("n1", descriptor_for(s))
    broker = Broker(view, device="cpu")
    assert view.latency_ms("n1") is None
    broker.run_json(Q)
    assert view.latency_ms("n1") is not None and view.latency_ms("n1") > 0
    broker.stop()


def test_broker_pool_is_hoisted_and_released(segments):
    view, dead, good, broker = _two_replica_cluster(segments)
    broker.run_json(Q)
    pool1 = broker._pool
    assert pool1 is not None, "the scatter created the broker's pool"
    broker.run_json(Q)
    assert broker._pool is pool1, "retry rounds reuse one pool"
    broker.stop()
    assert broker._pool is None
    assert pool1._shutdown
    assert broker.run_json(Q) == _local(segments)
    broker.stop()


def test_resilience_monitor_emits_declared_deltas():
    res = BrokerResilience(ResiliencePolicy(circuit_failure_threshold=1))
    res.circuits.on_failure("s1")
    res.stats.note_hedge_issued()
    res.stats.note_hedge_won()
    res.stats.note_partial(3)
    events = []

    class _Emitter:
        def metric(self, name, value, **dims):
            events.append((name, value))

    mon = ResilienceMetricsMonitor(res)
    mon.do_monitor(_Emitter())
    got = dict(events)
    assert catalog.validate_emitted(got) == []
    assert got["broker/circuit/open"] == 1
    assert got["broker/circuit/trips"] == 1
    assert got["query/hedge/issued"] == 1
    assert got["query/hedge/won"] == 1
    assert got["query/partial/missingSegments"] == 3
    events.clear()
    mon.do_monitor(_Emitter())
    got = dict(events)
    assert got["broker/circuit/trips"] == 0
    assert got["query/partial/missingSegments"] == 0
    assert got["broker/circuit/open"] == 1
