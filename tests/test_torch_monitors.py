"""The port's emitter, monitors and trace spans against the reference's,
on the CPU.

* the two pool-monitor cases tests/test_devicepool.py holds for the
  reference pool, on the port's pool;
* the seven monitors (DevicePoolMonitor, BatchMetricsMonitor,
  CodeDomainMonitor, FilterBitmapMonitor, MegakernelMonitor,
  DispatchMonitor, ResilienceMetricsMonitor), each ticked after the same
  queries over the same arrays in both packages: the same metric names and
  dimensions in the same order, and the same values for every count of
  queries, segments, rows, probes and dispatches (the pool's resident
  bytes and its packed and cascade ratios differ: the reference stages
  cascade rungs, the port does not yet);
* the emitter cases of tests/test_obs_metrics.py (query-count deltas, the
  batching emitter's background flush and close, the composing emitter's
  close) and the qtrace cases of tests/test_qtrace.py (no-op without a
  root, nesting, attach across threads, traceparent re-rooting and
  opt-out, the store's ring);
* the TTL sweep of the query-time dimension remaps (a swept slot
  recomputes the same rows);
* `query_cache_key` equal across the packages for the same JSON of every
  query type.
"""
import json
import threading
import time

import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu import cluster as ref_cluster
from druid_tpu.cluster import cache as ref_cache
from druid_tpu.cluster import resilience as ref_resilience
from druid_tpu.data import cascade as ref_cascade
from druid_tpu.data import devicepool as ref_devicepool
from druid_tpu.data.generator import DataGenerator
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.engine import batching as ref_batching
from druid_tpu.engine import filters as ref_filters
from druid_tpu.engine import megakernel as ref_megakernel
from druid_tpu.obs import dispatch as ref_dispatch
from druid_tpu.query.model import query_from_json as ref_query
from druid_tpu.utils import emitter as ref_emitter
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch import cluster as port_cluster
from druid_tpu_torch.cluster import cache as port_cache
from druid_tpu_torch.cluster import resilience as port_resilience
from druid_tpu_torch.data import cascade as port_cascade
from druid_tpu_torch.data import devicepool as port_devicepool
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import batching as port_batching
from druid_tpu_torch.engine import engines
from druid_tpu_torch.engine import filters as port_filters
from druid_tpu_torch.engine import megakernel as port_megakernel
from druid_tpu_torch.obs import dispatch as port_dispatch
from druid_tpu_torch.obs import trace as qtrace
from druid_tpu_torch.query.model import TimeseriesQuery, query_from_json
from druid_tpu_torch.query.aggregators import (CountAggregator,
                                               LongSumAggregator)
from druid_tpu_torch.utils import emitter as port_emitter
from druid_tpu_torch.utils.intervals import Interval as PortInterval
from druid_tpu_torch.utils.emitter import (BatchingEmitter, CacheMonitor,
                                           ComposingEmitter, Event,
                                           FileEmitter, InMemoryEmitter,
                                           MonitorScheduler, ProcessMonitor,
                                           QueryCountStatsMonitor,
                                           ServiceEmitter, SysMonitor,
                                           emitter_from_config)
from tests.conftest import TEST_SCHEMA
from tests.test_torch_devicepool import COUNT_Q, _segments, fresh_pool  # noqa: F401
from tests.test_torch_slice import _carry
from tests.test_torch_wire import WIRE

torch.set_num_threads(1)

WEEK = "2026-01-01/2026-01-08"
AGGS = [{"type": "count", "name": "rows"},
        {"type": "longSum", "name": "ls", "fieldName": "metLong"}]


# ---------------------------------------------------------------------------
# the pool monitor (tests/test_devicepool.py's cases on the port's pool)
# ---------------------------------------------------------------------------

def test_pool_monitor_emits_metrics(fresh_pool):  # noqa: F811
    segs = _segments(2)
    ex = PortExecutor(segs, device="cpu")
    sink = InMemoryEmitter()
    emitter = ServiceEmitter("historical", "host1", sink)
    mon = port_devicepool.DevicePoolMonitor(fresh_pool)
    ex.run_json(COUNT_Q)               # misses (cold)
    ex.run_json(COUNT_Q)               # hits (warm)
    mon.do_monitor(emitter)
    names = {e.metric for e in sink.metrics()}
    assert {"segment/devicePool/hitRate", "segment/devicePool/hits",
            "segment/devicePool/misses", "segment/devicePool/evictedBytes",
            "segment/devicePool/residentBytes",
            "segment/devicePool/entries"} <= names
    rate = sink.metrics("segment/devicePool/hitRate")[-1].value
    assert 0.0 < rate <= 1.0
    # second tick with no traffic: deltas go quiet, no rate emitted
    sink.events.clear()
    mon.do_monitor(emitter)
    assert not sink.metrics("segment/devicePool/hitRate")


def test_pool_monitor_emits_packed_ratio(fresh_pool):  # noqa: F811
    sink = InMemoryEmitter()
    emitter = ServiceEmitter("historical", "host1", sink)
    mon = port_devicepool.DevicePoolMonitor(fresh_pool)
    mon.do_monitor(emitter)
    ratios = sink.metrics("segment/devicePool/packedRatio")
    assert ratios and ratios[-1].value == 1.0             # empty pool


# ---------------------------------------------------------------------------
# the seven monitors, ticked after the same work in both packages
# ---------------------------------------------------------------------------

#: metrics whose values are device bytes (the packages stage differently)
BYTE_METRICS = {"segment/devicePool/residentBytes",
                "segment/devicePool/packedRatio",
                "segment/devicePool/cascadeRatio"}

MON_QUERIES = [
    # batched hourly timeseries over the small segments
    {"queryType": "timeseries", "dataSource": "test", "intervals": [WEEK],
     "granularity": "hour", "aggregations": AGGS},
    # staged bitmap fills (batched): in + bound
    {"queryType": "groupBy", "dataSource": "test", "intervals": [WEEK],
     "granularity": "all", "dimensions": ["dimA"], "aggregations": AGGS,
     "filter": {"type": "and", "fields": [
         {"type": "in", "dimension": "dimB",
          "values": ["v00000001", "v00000002"]},
         {"type": "bound", "dimension": "metLong", "lower": "5",
          "upper": "90", "ordering": "numeric"}]}},
    # per segment: the bitmap subtree fuses (megakernel)
    {"queryType": "groupBy", "dataSource": "test", "intervals": [WEEK],
     "granularity": "all", "dimensions": ["dimA", "dimB"],
     "aggregations": AGGS, "context": {"batchSegments": False},
     "filter": {"type": "in", "dimension": "dimA",
                "values": ["v00000001", "v00000004"]}},
    # a count by dimA: the rollup-ordered segments run in run space
    {"queryType": "groupBy", "dataSource": "test", "intervals": [WEEK],
     "granularity": "all", "dimensions": ["dimA"],
     "aggregations": [{"type": "count", "name": "rows"}],
     "context": {"batchSegments": False}},
    {"queryType": "topN", "dataSource": "test", "intervals": [WEEK],
     "granularity": "all", "dimension": "dimA", "metric": "ls",
     "threshold": 3, "aggregations": AGGS},
]


def _mon_segs():
    ref = DataGenerator(TEST_SCHEMA, seed=42).segments(
        4, 5_000, Interval.of("2026-01-01", "2026-01-05"),
        datasource="test")
    ref += DataGenerator(TEST_SCHEMA, seed=43).segments(
        2, 5_000, Interval.of("2026-01-05", "2026-01-07"),
        datasource="test", sort_by_dims=True)
    return ref, [_carry(s) for s in ref]


def _engine_monitors(dp, b, c, f, m, d):
    return [dp.DevicePoolMonitor(), b.BatchMetricsMonitor(),
            c.CodeDomainMonitor(), f.FilterBitmapMonitor(),
            m.MegakernelMonitor(), d.DispatchMonitor()]


def _tick(emitter_mod, monitors):
    sink = emitter_mod.InMemoryEmitter()
    em = emitter_mod.ServiceEmitter("historical", "h", sink)
    for mon in monitors:
        mon.do_monitor(em)
    return [(e.metric, e.value, sorted(e.dims.items()))
            for e in sink.metrics()]


def _dead_node_broker(pkg, segments, **kw):
    view = pkg.InventoryView()

    class Dead(pkg.DataNode):
        def run_partials(self, query, segment_ids, check=None):
            raise ConnectionError("down")
    nodes = [Dead("dead", **kw), pkg.DataNode("good", **kw)]
    for n in nodes:
        view.register(n)
        for s in segments:
            n.load_segment(s)
            view.announce(n.name, pkg.descriptor_for(s))
    return pkg.Broker(
        view, seed=3, resilience_policy=pkg.ResiliencePolicy(
            circuit_failure_threshold=1, hedge_enabled=False),
        **({"device": kw["device"]} if kw else {}))


def test_seven_monitors_agree_with_reference(monkeypatch):
    """Each package gets a fresh device pool before its segments are
    built, and every monitor is ticked once before the work, so that each
    tick covers exactly this test's queries."""
    monkeypatch.setattr(ref_batching, "_ENABLED", True)
    monkeypatch.setattr(port_batching, "_ENABLED", True)
    monkeypatch.setattr(ref_devicepool, "_POOL",
                        ref_devicepool.DeviceSegmentPool(budget_bytes=1 << 40))
    monkeypatch.setattr(port_devicepool, "_POOL",
                        port_devicepool.DeviceSegmentPool(
                            budget_bytes=1 << 40))
    ref, port = _mon_segs()
    got = {}
    for tag, mods, em, ex, segs, pkg, res, kw in (
            ("reference", (ref_devicepool, ref_batching, ref_cascade,
                           ref_filters, ref_megakernel, ref_dispatch),
             ref_emitter, RefExecutor(ref), ref, ref_cluster,
             ref_resilience, {}),
            ("port", (port_devicepool, port_batching, port_cascade,
                      port_filters, port_megakernel, port_dispatch),
             port_emitter, PortExecutor(port, device="cpu"), port,
             port_cluster, port_resilience, {"device": "cpu"})):
        monitors = _engine_monitors(*mods)
        _tick(em, monitors)                  # the baseline
        for q in MON_QUERIES:
            ex.run_json(q)
            ex.run_json(q)
        broker = _dead_node_broker(pkg, segs[:4], **kw)
        monitors.append(res.ResilienceMetricsMonitor(broker.resilience))
        for _ in range(3):
            broker.run_json(MON_QUERIES[0])
        broker.stop()
        got[tag] = _tick(em, monitors)
    want, have = got["reference"], got["port"]
    assert [(n, d) for n, _, d in want] == [(n, d) for n, _, d in have]
    for (name, a, _), (_, b, _) in zip(want, have):
        if name not in BYTE_METRICS:
            assert a == b, (name, a, b)
    values = {n: v for n, v, _ in have}
    assert values["query/codeDomain/hits"] > 0
    assert values["query/megakernel/hits"] > 0
    assert values["query/dispatch/count"] > 0
    assert values["query/filter/deviceBitmapMisses"] > 0
    assert values["broker/circuit/trips"] >= 1
    assert any(n == "query/batch/segments" for n, _, _ in have)


def test_dispatch_kinds_counted():
    before = port_dispatch.stats().snapshot()
    segs = _segments(3)
    PortExecutor(segs, device="cpu").run_json(
        dict(COUNT_Q, context={"batchSegments": False}))
    after = port_dispatch.stats().snapshot()
    assert after["segment"] - before.get("segment", 0) == 3
    assert after["total"] - before["total"] == 3


# ---------------------------------------------------------------------------
# the emitter (tests/test_obs_metrics.py's cases)
# ---------------------------------------------------------------------------

def test_query_count_deltas_per_period():
    sink = InMemoryEmitter()
    em = ServiceEmitter("s", "h", sink)
    qc = QueryCountStatsMonitor()
    qc.on_query(True)
    qc.on_query(True)
    qc.on_query(False)
    qc.do_monitor(em)
    qc.on_query(True)
    qc.do_monitor(em)
    qc.do_monitor(em)       # idle tick: zero deltas, stable cumulatives
    assert [e.value for e in sink.metrics("query/count")] == [3, 4, 4]
    assert [e.value for e in sink.metrics("query/count/delta")] == [3, 1, 0]
    assert [e.value for e in
            sink.metrics("query/success/count/delta")] == [2, 1, 0]
    assert [e.value for e in
            sink.metrics("query/failed/count/delta")] == [1, 0, 0]


def test_batching_emitter_background_flush():
    sent = []
    be = BatchingEmitter(sent.append, batch_size=100, flush_seconds=0.05)
    try:
        be.emit(Event("metric", "query/time", 1.0, 0))
        deadline = time.monotonic() + 5.0
        while not sent and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sent and sent[0][0]["metric"] == "query/time"
    finally:
        be.close()


def test_batching_emitter_close_joins_and_flushes():
    sent = []
    be = BatchingEmitter(sent.append, batch_size=100, flush_seconds=60.0)
    be.emit(Event("metric", "query/time", 1.0, 0))
    be.close()
    assert sent and len(sent[0]) == 1
    assert not be._flusher.is_alive()


def test_composing_emitter_closes_children(tmp_path):
    f1 = FileEmitter(str(tmp_path / "a.log"))
    f2 = FileEmitter(str(tmp_path / "b.log"))
    comp = ComposingEmitter([f1, f2])
    comp.emit(Event("metric", "query/time", 1.0, 0))
    comp.close()
    assert f1._fh.closed and f2._fh.closed


def test_service_emitter_stamps_dims():
    sink = InMemoryEmitter()
    em = ServiceEmitter("druid-tpu/test", "h1", sink)
    em.metric("query/time", 12.5, dataSource="wiki")
    e = sink.metrics("query/time")[0]
    assert e.dims == {"dataSource": "wiki", "service": "druid-tpu/test",
                      "host": "h1"}
    j = e.to_json()
    assert j["feed"] == "metrics" and j["value"] == 12.5


def test_batching_emitter_batches_and_file_emitter(tmp_path):
    batches = []
    be = BatchingEmitter(batches.append, batch_size=3)
    try:
        em = ServiceEmitter("s", "h", be)
        for i in range(7):
            em.metric("m", i)
        assert len(batches) == 2 and all(len(b) == 3 for b in batches)
        be.flush()
        assert sum(len(b) for b in batches) == 7
    finally:
        be.close()
    path = str(tmp_path / "metrics.log")
    em = ServiceEmitter("s", "h", FileEmitter(path))
    em.metric("a", 1)
    em.metric("b", 2)
    em.flush()
    with open(path) as f:
        assert [json.loads(line)["metric"] for line in f] == ["a", "b"]


def test_process_cache_and_query_monitors_through_the_scheduler():
    sink = InMemoryEmitter()
    em = ServiceEmitter("s", "h", sink)
    qc = QueryCountStatsMonitor()
    qc.on_query(True)
    qc.on_query(False)
    cache = port_cluster.LruCache()
    cache.put("x", "k", 1)
    cache.get("x", "k")
    sched = MonitorScheduler(em, [SysMonitor(), ProcessMonitor(), qc,
                                  CacheMonitor(cache)], 999)
    sched.tick()
    sched.tick()   # SysMonitor's cpu needs two samples
    names = {e.metric for e in sink.metrics()}
    assert {"proc/rss", "query/count", "query/success/count",
            "query/cache/total/hits"} <= names
    assert sink.metrics("query/success/count")[0].value == 1
    assert sink.metrics("query/cache/total/hits")[0].value == 1
    sched.start()
    sched.stop()
    assert not sched._thread.is_alive()


def test_emitter_from_config(tmp_path):
    assert isinstance(emitter_from_config("noop"), port_emitter.NoopEmitter)
    assert isinstance(emitter_from_config("memory"), InMemoryEmitter)
    f = emitter_from_config("file", path=str(tmp_path / "e.log"))
    assert isinstance(f, FileEmitter)
    f.close()
    with pytest.raises(ValueError):
        emitter_from_config("carrier-pigeon")


def test_event_json_equals_reference():
    e = Event("metric", "query/time", 2.5, 123, {"dataSource": "d"})
    r = ref_emitter.Event("metric", "query/time", 2.5, 123,
                          {"dataSource": "d"})
    assert e.to_json() == r.to_json()


# ---------------------------------------------------------------------------
# qtrace (tests/test_qtrace.py's span-model cases)
# ---------------------------------------------------------------------------

def test_span_noop_without_root():
    with qtrace.span("engine/dispatch") as s:
        assert s is None
    assert qtrace.current_span() is None


def test_root_and_children_nest():
    store = qtrace.TraceStore()
    with qtrace.root_span("query", service="svc", store=store,
                          queryId="t-nest") as root:
        assert root is not None and qtrace.current_span() is root
        with qtrace.span("child", k=1) as c:
            assert c.parent_id == root.span_id
            assert c.trace_id == root.trace_id
            assert c.service == "svc"
    got = store.get(root.trace_id)
    assert [s["name"] for s in got["spans"]] == ["query", "child"]
    assert all(s["durationMs"] >= 0 for s in got["spans"])


def test_attach_propagates_across_threads():
    store = qtrace.TraceStore()
    seen = {}
    with qtrace.root_span("query", service="svc", store=store) as root:
        def worker():
            with qtrace.attach(root), qtrace.span("worker") as s:
                seen["span"] = s
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen["span"].parent_id == root.span_id


def test_traceparent_reroot_and_opt_out():
    store = qtrace.TraceStore()
    aggs = [CountAggregator("rows"), LongSumAggregator("ls", "metLong")]
    week = PortInterval.of("2026-01-01", "2026-01-08")
    q = TimeseriesQuery.of("t", [week],
                           aggs, context={"queryId": "qq",
                                          "traceparent": "remote-trace:abc"})
    with qtrace.root_span("datanode/query", q, service="n",
                          store=store) as root:
        assert root.trace_id == "remote-trace"
        assert root.parent_id == "abc"
    off = TimeseriesQuery.of("t", [week], aggs,
                             context={"queryId": "qq", "trace": False})
    with qtrace.root_span("datanode/query", off, service="n",
                          store=store) as root:
        assert root is None


def test_trace_store_ring_eviction():
    store = qtrace.TraceStore(max_traces=3, max_spans_per_trace=2)
    for i in range(5):
        store.add_json({"traceId": f"t{i}", "spanId": f"s{i}", "name": "x",
                        "startMs": i})
    assert store.trace_ids() == ["t2", "t3", "t4"]


def test_broker_trace_has_every_phase():
    """One broker query assembles one trace: broker/query over plan,
    scatter, a node span per node call, the engine's partials and the
    merge; emit_trace_metrics turns the node spans into query/node/time."""
    segs = [_carry(s) for s in DataGenerator(TEST_SCHEMA, seed=42).segments(
        2, 1_000, Interval.of("2026-01-01", "2026-01-03"),
        datasource="test")]
    view = port_cluster.InventoryView()
    node = port_cluster.DataNode("n0", device="cpu")
    view.register(node)
    for s in segs:
        node.load_segment(s)
        view.announce("n0", port_cluster.descriptor_for(s))
    broker = port_cluster.Broker(view, device="cpu")
    q = {"queryType": "timeseries", "dataSource": "test",
         "intervals": [WEEK], "granularity": "all", "aggregations": AGGS,
         "context": {"queryId": "trace-all-phases"}}
    broker.run_json(q)
    spans = qtrace.trace_store().spans("trace-all-phases")
    names = set(qtrace.phase_breakdown(spans))
    assert {"broker/query", "broker/plan", "broker/scatter", "broker/node",
            "engine/partials", "broker/merge"} <= names
    sink = InMemoryEmitter()
    qtrace.emit_trace_metrics(ServiceEmitter("broker", "h", sink),
                              query_from_json(q), "trace-all-phases", spans)
    assert [e.dims["server"] for e in sink.metrics("query/node/time")] \
        == ["n0"]
    off = dict(q, context={"queryId": "trace-off", "trace": False})
    broker.run_json(off)
    assert qtrace.trace_store().spans("trace-off") == []
    broker.stop()


# ---------------------------------------------------------------------------
# the TTL sweep of the query-time dimension remaps
# ---------------------------------------------------------------------------

def test_unidim_ttl_sweep_recomputes_the_same_rows():
    """A groupBy on a numeric dimension unifies the segments' query-time
    dictionaries into remap slots (30 rows a segment: their value sets
    differ); a TTL sweep clears the idle slots, and the next query
    recomputes them and gives the same rows."""
    segs = _segments(3, rows=30)
    ex = PortExecutor(segs, device="cpu")
    q = {"queryType": "groupBy", "dataSource": "pool",
         "intervals": COUNT_Q["intervals"], "granularity": "all",
         "dimensions": ["metLong"],
         "aggregations": [{"type": "count", "name": "n"}]}
    prev = engines.set_unidim_ttl(900.0)
    try:
        rows = ex.run_json(q)
        slots = [s for seg in segs for k, s in seg._aux_cache.items()
                 if k[0] == "unidim"]
        assert len(slots) == 3 and all(slots)
        assert engines._sweep_unidim(time.monotonic()) == 0   # fresh
        engines.set_unidim_ttl(1e-6)
        time.sleep(0.01)
        assert engines._sweep_unidim(time.monotonic()) == 3
        assert not any(slots)
        assert ex.run_json(q) == rows                          # recomputed
        assert all(slots)
        engines.set_unidim_ttl(0)                              # no expiry
        time.sleep(0.01)
        assert engines._sweep_unidim(time.monotonic()) == 0
        assert all(slots)
    finally:
        engines.set_unidim_ttl(prev)
    assert engines.set_unidim_ttl(prev) == 900.0


def test_unidim_ttl_default_is_900_seconds():
    assert engines._UNIDIM_TTL_S == 900.0


# ---------------------------------------------------------------------------
# the cache key across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(WIRE))
def test_query_cache_key_equals_reference(name):
    j = WIRE[name]
    got = port_cache.query_cache_key(query_from_json(j))
    assert got == ref_cache.query_cache_key(ref_query(j))
    assert port_cache.result_level_key(query_from_json(j), ["b", "a"]) \
        == ref_cache.result_level_key(ref_query(j), ["a", "b"])
    # the context never enters the key
    other = dict(j, context={"queryId": "another"})
    assert port_cache.query_cache_key(query_from_json(other)) == got


def test_resilience_policy_defaults_equal_reference():
    assert port_resilience.ResiliencePolicy().__dict__ \
        == ref_resilience.ResiliencePolicy().__dict__
