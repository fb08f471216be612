"""The port's metrics surfaces (druid_tpu_torch/obs/prometheus.py and
obs/catalog.py) on the CPU: the cases of tests/test_obs_metrics.py — the
Prometheus registry and the /metrics endpoints of the broker's query
resource and of a data node, and the catalog contract run over the port's
own monitors. The catalog and the exposition text are held against the
reference package's for the same events. (The emitter cases of that file,
BatchingEmitter, ComposingEmitter and the query-count deltas, are in
test_torch_monitors.py.)"""
import json
import urllib.request

import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.generator import DataGenerator
from druid_tpu.obs import catalog as ref_catalog
from druid_tpu.obs.prometheus import MetricRegistry as RefRegistry
from druid_tpu.utils.emitter import ServiceEmitter as RefServiceEmitter
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.obs import catalog
from druid_tpu_torch.obs.prometheus import (MetricRegistry, compose_sink,
                                            metric_name)
from druid_tpu_torch.utils.emitter import (InMemoryEmitter,
                                           QueryCountStatsMonitor,
                                           ServiceEmitter)
from tests.conftest import TEST_SCHEMA
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

TIMEOUT = 30
TS = {"queryType": "timeseries", "dataSource": "test",
      "intervals": ["2026-01-01/2026-01-08"], "granularity": "all",
      "aggregations": [{"type": "count", "name": "rows"}]}


@pytest.fixture(scope="module")
def segs():
    ref = DataGenerator(TEST_SCHEMA, seed=42).segments(
        2, 2_000, Interval.of("2026-01-01", "2026-01-03"), datasource="test")
    return [_carry(s) for s in ref]


# ---------------------------------------------------------------------------
# Prometheus exposition
# ---------------------------------------------------------------------------

def test_prometheus_exposition_golden():
    """Exact text-format output: HELP/TYPE from the catalog, sorted label
    sets, the high-cardinality `id` label dropped."""
    reg = MetricRegistry()
    em = ServiceEmitter("svc", "h1", reg)
    em.metric("query/time", 12.5, dataSource="d", type="timeseries",
              id="q-abc")
    em.metric("segment/devicePool/entries", 3)
    assert reg.exposition() == (
        '# HELP druid_query_time end-to-end query wall time (ms)\n'
        '# TYPE druid_query_time gauge\n'
        'druid_query_time{dataSource="d",host="h1",service="svc",'
        'type="timeseries"} 12.5\n'
        '# HELP druid_segment_devicePool_entries current pool entry count '
        '(count)\n'
        '# TYPE druid_segment_devicePool_entries gauge\n'
        'druid_segment_devicePool_entries{host="h1",service="svc"} 3\n')


def test_exposition_equals_reference():
    """The same events give the reference's text, byte for byte."""
    events = [("query/time", 1.5, {"dataSource": 'a"b', "id": "x"}),
              ("query/wire/bytes", 1024, {}),
              ("query/queue/depth", 0, {"lane": "interactive"}),
              ("not/declared", 7, {"segment": "s1", "k": "v"})]
    regs = []
    for reg_cls, em_cls in ((MetricRegistry, ServiceEmitter),
                            (RefRegistry, RefServiceEmitter)):
        reg = reg_cls(max_series=3)
        em = em_cls("svc", "h", reg)
        for name, value, dims in events:
            em.metric(name, value, **dims)
        regs.append(reg.exposition())
    assert regs[0] == regs[1]


def test_prometheus_last_value_and_escaping():
    reg = MetricRegistry()
    em = ServiceEmitter("s", "h", reg)
    em.metric("query/time", 1.0, dataSource='we"ird\nname')
    em.metric("query/time", 2.0, dataSource='we"ird\nname')
    text = reg.exposition()
    assert text.count("druid_query_time{") == 1     # last value wins
    assert r'dataSource="we\"ird\nname"' in text
    assert " 2\n" in text


def test_prometheus_series_cap():
    reg = MetricRegistry(max_series=2)
    em = ServiceEmitter("s", "h", reg)
    for i in range(5):
        em.metric("query/time", float(i), dataSource=f"d{i}")
    assert reg.series_count() == 2
    assert "druid_metric_registry_dropped_series 3" in reg.exposition()


def test_metric_name_sanitization():
    assert metric_name("query/batch/fillRatio") == \
        "druid_query_batch_fillRatio"
    assert metric_name("sys/mem-used") == "druid_sys_mem_used"


def test_compose_sink_restores_only_its_own_chain():
    """compose_sink chains the registry onto a caller's emitter and its
    restore undoes that only while the chain is still the one it put
    there."""
    sink = InMemoryEmitter()
    em = ServiceEmitter("s", "h", sink)
    r1, r2 = MetricRegistry(), MetricRegistry()
    undo1 = compose_sink(em, r1)
    undo2 = compose_sink(em, r2)
    em.metric("query/time", 1.0)
    assert sink.metrics("query/time") and r1.series_count() == 1 \
        and r2.series_count() == 1
    undo1()                          # not the top of the chain: no-op
    assert em.sink is not sink
    undo2()                          # back to r1's wrap
    undo1()                          # now the top: back to the caller's
    assert em.sink is sink


# ---------------------------------------------------------------------------
# The catalog
# ---------------------------------------------------------------------------

def test_catalog_equals_reference():
    """The catalog is the contract between nodes and dashboards: the
    port's declares the reference's names with the same units, dims and
    help text."""
    assert catalog.METRICS == ref_catalog.METRICS
    assert catalog.declared_names() == ref_catalog.declared_names()
    assert catalog.render_table() == ref_catalog.render_table()
    assert catalog.help_for("nope") == "(undeclared metric)"
    assert catalog.validate_emitted(["query/time", "x/y"]) == ["x/y"]


def test_every_monitor_metric_is_cataloged(segs):
    """Drive every monitor the port has against an in-memory sink (after a
    broker query over a data node, so the engine monitors have something
    to say) and check the names it emits are all declared."""
    from druid_tpu_torch.cluster import (Broker, DataNode, InventoryView,
                                         LruCache, ResilienceMetricsMonitor,
                                         descriptor_for, wire)
    from druid_tpu_torch.data.cascade import CodeDomainMonitor
    from druid_tpu_torch.data.devicepool import DevicePoolMonitor
    from druid_tpu_torch.engine.batching import BatchMetricsMonitor
    from druid_tpu_torch.engine.filters import FilterBitmapMonitor
    from druid_tpu_torch.engine.megakernel import MegakernelMonitor
    from druid_tpu_torch.obs.dispatch import DispatchMonitor
    from druid_tpu_torch.parallel.distributed import ShardedMonitor
    from druid_tpu_torch.query.model import query_from_json
    from druid_tpu_torch.server.scheduler import (DataNodeScheduler,
                                                  SchedulerConfig,
                                                  SchedulerMetricsMonitor)
    from druid_tpu_torch.utils.emitter import (CacheMonitor,
                                               MonitorScheduler,
                                               ProcessMonitor, SysMonitor)
    view = InventoryView()
    node = DataNode("mon", device="cpu")
    view.register(node)
    for s in segs:
        node.load_segment(s)
        view.announce(node.name, descriptor_for(s))
    broker = Broker(view, device="cpu")
    sched = DataNodeScheduler(node, SchedulerConfig(batch_window_ms=1.0))
    try:
        broker.run(query_from_json(TS))
        sched.start()
        sched.submit(query_from_json(dict(TS, context={"queryId": "m"})),
                     [str(s.id) for s in segs])
    finally:
        sched.stop()
        broker.stop()
    sink = InMemoryEmitter()
    em = ServiceEmitter("s", "h", sink)
    qc = QueryCountStatsMonitor()
    qc.on_query(True)
    cache = LruCache()
    cache.put("x", "k", 1)
    monitors = MonitorScheduler(
        em, [SysMonitor(), ProcessMonitor(), qc, CacheMonitor(cache),
             DevicePoolMonitor(), BatchMetricsMonitor(),
             FilterBitmapMonitor(), MegakernelMonitor(),
             CodeDomainMonitor(), DispatchMonitor(), ShardedMonitor(),
             ResilienceMetricsMonitor(broker.resilience),
             wire.WireStatsMonitor(), SchedulerMetricsMonitor(sched)], 999)
    monitors.tick()
    monitors.tick()
    names = {e.metric for e in sink.metrics()}
    assert {"query/queue/depth", "query/wire/bytes",
            "segment/devicePool/entries", "query/count",
            "query/sharded/stackBytes"} <= names
    missing = catalog.validate_emitted(names)
    assert not missing, f"monitors emit uncataloged metrics: {missing}"


# ---------------------------------------------------------------------------
# /metrics on the broker's query resource and on a data node
# ---------------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return r.read().decode(), r.headers.get("Content-Type", "")


def test_broker_http_wires_query_counts(segs):
    """The broker server path calls on_query: a query through the HTTP
    resource shows up in the monitor's counts and on GET /metrics."""
    from druid_tpu_torch.engine import QueryExecutor
    from druid_tpu_torch.server import QueryHttpServer, QueryLifecycle
    lc = QueryLifecycle(QueryExecutor(list(segs), device="cpu"))
    http = QueryHttpServer(lc).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{http.port}/druid/v2",
            data=json.dumps(TS).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            assert r.status == 200
        assert http.query_counts.success == 1
        http.metrics_tick()
        text, ctype = _get(f"http://127.0.0.1:{http.port}/metrics")
        assert "text/plain" in ctype
        lines = text.splitlines()
        assert any(ln.startswith("druid_query_success_count{")
                   and ln.endswith(" 1") for ln in lines), text
        assert any(ln.startswith("druid_query_count_delta{")
                   and ln.endswith(" 1") for ln in lines), text
    finally:
        http.stop()


def test_broker_http_chains_existing_on_result(segs):
    """Wiring the monitor does not clobber a caller-supplied on_result,
    and stop() puts the caller's hook back."""
    from druid_tpu_torch.engine import QueryExecutor
    from druid_tpu_torch.server import QueryHttpServer, QueryLifecycle
    seen = []
    lc = QueryLifecycle(QueryExecutor(list(segs), device="cpu"),
                        on_result=seen.append)
    http = QueryHttpServer(lc).start()
    try:
        lc.run_json(TS)
        assert seen == [True]
        assert http.query_counts.success == 1
    finally:
        http.stop()
    assert lc.on_result == seen.append


def test_data_node_metrics_endpoint(segs):
    """GET /metrics on a data node: Prometheus text including query/time,
    the devicePool gauges and the wire bytes."""
    from druid_tpu_torch.cluster import (DataNode, DataNodeServer,
                                         RemoteDataNodeClient)
    from druid_tpu_torch.query.model import query_from_json
    node = DataNode("promnode", device="cpu")
    srv = DataNodeServer(node).start()
    try:
        for s in segs:
            node.load_segment(s)
        client = RemoteDataNodeClient(node.name, srv.url)
        client.run_partials(
            query_from_json(dict(TS, context={"queryId": "prom-1"})),
            [str(s.id) for s in segs])
        srv.metrics_tick()
        text, _ = _get(srv.url + "/metrics")
        assert 'druid_query_time{' in text
        assert 'success="true"' in text
        assert "druid_segment_devicePool_residentBytes" in text
        assert "druid_segment_devicePool_entries" in text
        assert "druid_query_wire_bytes" in text
        assert any(ln.startswith("druid_query_count{")
                   and ln.endswith(" 1") for ln in text.splitlines()), text
    finally:
        srv.stop()


def test_data_node_composes_caller_emitter():
    """A caller-supplied emitter keeps receiving events AND the registry
    sees them (the sink is composed, not replaced); stop() unwraps it."""
    from druid_tpu_torch.cluster import DataNode, DataNodeServer
    sink = InMemoryEmitter()
    em = ServiceEmitter("historical", "h", sink)
    srv = DataNodeServer(DataNode("cnode", device="cpu"), emitter=em).start()
    try:
        srv.metrics_tick()
        assert sink.metrics("segment/devicePool/entries")
        assert "druid_segment_devicePool_entries" in \
            srv.registry.exposition()
    finally:
        srv.stop()
    assert em.sink is sink
