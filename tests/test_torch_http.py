"""The port's query resource (druid_tpu_torch/server/http.py: the
QueryHttpServer over a QueryLifecycle) on the CPU, over real sockets on
127.0.0.1: the HTTP cases of the reference package's tests, each over the
port's executor or broker, with rows held against the reference's
QueryExecutor on the same segments (tests/conftest.py's `segments` data,
carried as plain arrays; counts, long sums and min/max bit for bit, float
sums within 1e-5 * sum|v|).

  tests/test_aux.py:177,197       native query, /status, datasources, 400
  tests/test_cluster.py:444-484   the broker's 429 handling
  tests/test_cluster.py:546,593   ETag / If-None-Match 304, 403 not 304
  tests/test_resilience.py:379,445,511 (their SQL parts are in
                                  tests/test_torch_sql.py)
                                  Retry-After jitter, the partial-result
                                  header, the resilience monitor
  tests/test_streaming_scan.py:119,150,170  NDJSON scan streaming
  tests/test_qtrace.py:146-290    the assembled trace over the wire and
                                  GET /druid/v2/trace/<id> on both servers
  tests/test_router_security.py:133-255     401 / 403 and the auth chain

tests/test_qtrace.py:185 (compile against cached attribution) has no
counterpart: the port builds its kernels once per process, so no span
times a compile. Every server binds 127.0.0.1 port 0 and is stopped in a
finalizer; every urlopen has a timeout.
"""
import base64
import http.client
import json
import urllib.error
import urllib.request

import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.utils.intervals import Interval

import druid_tpu_torch.ext  # noqa: F401  (bloom and histogram values)
from druid_tpu_torch.cluster import (Broker, DataNode, DataNodeServer,
                                     InventoryView, LruCache,
                                     RemoteDataNodeClient, descriptor_for)
from druid_tpu_torch.engine import QueryExecutor
from druid_tpu_torch.obs import trace as qtrace
from druid_tpu_torch.query.model import query_from_json
from druid_tpu_torch.server import (AllowAllAuthenticator,
                                    AllowAllAuthorizer, AuthChain,
                                    BasicHTTPAuthenticator, Permission,
                                    QueryCapacityError, QueryHttpServer,
                                    QueryLifecycle, QueryManager,
                                    RequestLogger, RoleBasedAuthorizer,
                                    RouterHttpServer, TieredBrokerSelector,
                                    Unauthorized, authorizer_for_query)
from druid_tpu_torch.server.security import READ
from druid_tpu_torch.utils.emitter import InMemoryEmitter, ServiceEmitter
from tests.conftest import TEST_SCHEMA
from tests.test_torch_cluster import _close
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

WEEK = "2026-01-01/2026-01-08"
DAY = "2026-01-01/2026-01-02"
AGGS = [{"type": "count", "name": "rows"},
        {"type": "longSum", "name": "ls", "fieldName": "metLong"}]
TS = {"queryType": "timeseries", "dataSource": "test", "intervals": [WEEK],
      "granularity": "all", "aggregations": [{"type": "count", "name": "n"}]}
TIMEOUT = 30


@pytest.fixture(scope="module")
def segs():
    ref = DataGenerator(TEST_SCHEMA, seed=42).segments(
        4, 5_000, Interval.of("2026-01-01", "2026-01-05"), datasource="test")
    return ref, [_carry(s) for s in ref]


def _ex(segs):
    return QueryExecutor(list(segs[1]), device="cpu")


@pytest.fixture()
def served():
    """start(server) -> server, stopped at teardown (also on failure)."""
    started = []

    def start(srv):
        started.append(srv)
        return srv.start()
    yield start
    for srv in reversed(started):
        srv.stop()


def _post(port, payload, headers=None, path="/druid/v2"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null"), dict(e.headers)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ---------------------------------------------------------------------------
# the native resource (tests/test_aux.py)
# ---------------------------------------------------------------------------

def test_http_native_query(segs, served):
    srv = served(QueryHttpServer(QueryLifecycle(_ex(segs))))
    q = dict(TS, granularity="day", aggregations=AGGS)
    status, rows, _ = _post(srv.port, q)
    assert status == 200
    _close(RefExecutor(segs[0]).run_json(q), rows)


def test_http_status_and_errors(segs, served):
    srv = served(QueryHttpServer(QueryLifecycle(_ex(segs))))
    status, body = _get(srv.port, "/status")
    assert status == 200 and body["version"].startswith("druid-tpu")
    assert _get(srv.port, "/druid/v2/datasources") == (200, ["test"])
    status, err, _ = _post(srv.port, {"queryType": "bogus"})
    assert status == 400 and "error" in err
    # the surfaces that wait for later slices answer 404, as the
    # reference's do when they are not enabled
    assert _post(srv.port, {"query": "SELECT 1"},
                 path="/druid/v2/sql")[:2] == (404,
                                               {"error": "SQL not enabled"})
    assert _post(srv.port, TS, path="/druid/v2/subscriptions")[0] == 404
    assert _get(srv.port, "/druid/v2/subscriptions/x")[0] == 404
    assert _get(srv.port, "/druid/coordinator/v1/leader")[0] == 404


@pytest.mark.parametrize("arg,item", [
    ("leader_clients", "A18"), ("subscription_hub", "A15"),
    ("coordination", "A18"), ("overlord", "A18")])
def test_waiting_surfaces_refuse_construction(segs, arg, item):
    """The router's control-plane proxy (`leader_clients`) waits with the
    coordination endpoints; SQL is served since A16
    (tests/test_torch_sql.py)."""
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        if arg == "leader_clients":
            RouterHttpServer(TieredBrokerSelector({"_default": []},
                                                  "_default"),
                             leader_clients={"coordinator": object()})
        else:
            QueryHttpServer(QueryLifecycle(_ex(segs)), **{arg: object()})


def test_http_serializes_extension_values(segs, served):
    srv = served(QueryHttpServer(QueryLifecycle(
        QueryExecutor([segs[1][0]], device="cpu"))))
    status, rows, _ = _post(srv.port, {
        "queryType": "timeseries", "dataSource": "test",
        "intervals": [DAY], "granularity": "all",
        "aggregations": [
            {"type": "bloom", "name": "b", "fieldName": "dimA"},
            {"type": "approxHistogram", "name": "h", "fieldName": "metLong",
             "numBuckets": 8, "lowerLimit": 0.0, "upperLimit": 101.0}]})
    assert status == 200
    r = rows[0]["result"]
    assert isinstance(r["b"], str)                       # base64 bloom
    assert sum(r["h"]["counts"]) == segs[1][0].n_rows    # structured hist


# ---------------------------------------------------------------------------
# the broker behind the resource (tests/test_cluster.py)
# ---------------------------------------------------------------------------

def _cpu_node(name):
    return DataNode(name, device="cpu")


def _cluster(segments, cls=_cpu_node, names=("node0", "node1", "node2"),
             replicas=2, **broker_kw):
    """tests/test_cluster.py's cluster: a node from `cls` per name, the
    segments round-robin with `replicas` copies, a broker."""
    view = InventoryView()
    nodes = [cls(n) for n in names]
    for n in nodes:
        view.register(n)
    for i, s in enumerate(segments):
        for j in range(replicas):
            node = nodes[(i + j) % len(nodes)]
            node.load_segment(s)
            view.announce(node.name, descriptor_for(s))
    return view, nodes, Broker(view, device="cpu", **broker_kw)


def _cached_node(name):
    return DataNode(name, device="cpu", cache=LruCache())


@pytest.fixture()
def cluster(segs):
    view, nodes, broker = _cluster(segs[1], cls=_cached_node,
                                   cache=LruCache())
    yield view, nodes, broker
    broker.stop()


def test_http_etag_and_not_modified(cluster, segs, served):
    """X-Druid-ETag on aggregate results; If-None-Match answers 304 without
    running the query; a timeline change (segment drop) changes the
    etag."""
    view, nodes, broker = cluster
    srv = served(QueryHttpServer(QueryLifecycle(broker)))
    payload = json.dumps(TS)
    c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=TIMEOUT)
    c.request("POST", "/druid/v2", payload,
              {"Content-Type": "application/json"})
    r1 = c.getresponse()
    etag = r1.headers.get("X-Druid-ETag")
    body1 = json.loads(r1.read())
    assert r1.status == 200 and etag
    assert body1[0]["result"]["n"] == sum(s.n_rows for s in segs[1])
    def lookups():
        return [(n.cache.stats.hits, n.cache.stats.misses) for n in nodes]
    before = lookups()
    c.request("POST", "/druid/v2", payload,
              {"Content-Type": "application/json", "If-None-Match": etag})
    r2 = c.getresponse()
    assert r2.status == 304
    assert r2.read() == b""
    assert r2.headers.get("X-Druid-ETag") == etag
    assert lookups() == before           # no node was asked for anything
    # a timeline change invalidates: drop a segment from BOTH replicas
    sid = descriptor_for(segs[1][0]).id
    view.unannounce(nodes[0].name, sid)
    view.unannounce(nodes[1].name, sid)
    c.request("POST", "/druid/v2", payload,
              {"Content-Type": "application/json", "If-None-Match": etag})
    r3 = c.getresponse()
    assert r3.status == 200
    new_etag = r3.headers.get("X-Druid-ETag")
    r3.read()
    assert new_etag and new_etag != etag
    c.close()


def test_etag_denied_identity_gets_403_not_304(cluster, served):
    """If-None-Match must not leak whether forbidden data changed: a denied
    identity gets 403 on the conditional request too, and 304s still hit
    the request log and the success count."""
    _, _, broker = cluster
    results = []
    logger = RequestLogger()
    lc = QueryLifecycle(broker, request_logger=logger,
                        authorizer=lambda ident, q: ident != "evil",
                        on_result=results.append)
    srv = served(QueryHttpServer(lc))
    payload = json.dumps(TS)
    c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=TIMEOUT)
    c.request("POST", "/druid/v2", payload,
              {"Content-Type": "application/json"})
    r1 = c.getresponse()
    etag = r1.headers["X-Druid-ETag"]
    r1.read()
    c.request("POST", "/druid/v2", payload,
              {"Content-Type": "application/json", "If-None-Match": etag,
               "X-Druid-Identity": "evil"})
    r2 = c.getresponse()
    assert r2.status == 403, r2.status
    r2.read()
    n_logs = len(logger.entries)
    c.request("POST", "/druid/v2", payload,
              {"Content-Type": "application/json", "If-None-Match": etag})
    r3 = c.getresponse()
    assert r3.status == 304
    r3.read()
    assert len(logger.entries) == n_logs + 1
    assert results[-1] is True
    # bySegment yields a DIFFERENT etag (a different result shape)
    by_seg = json.dumps(dict(TS, context={"bySegment": True}))
    c.request("POST", "/druid/v2", by_seg,
              {"Content-Type": "application/json", "If-None-Match": etag})
    r4 = c.getresponse()
    assert r4.status == 200
    assert r4.headers.get("X-Druid-ETag") not in (None, etag)
    r4.read()
    c.close()


class _SheddingNode(DataNode):
    """Answers every partials request with a capacity shed (the admission
    path, stubbed: reachable, saturated)."""

    def __init__(self, name, sheds=10**9):
        super().__init__(name, device="cpu")
        self.sheds = sheds
        self.shed_calls = 0

    def run_partials(self, query, segment_ids, check=None):
        if self.sheds > 0:
            self.sheds -= 1
            self.shed_calls += 1
            raise QueryCapacityError("stub shed", retry_after_s=0.01)
        return super().run_partials(query, segment_ids, check)


def test_broker_lane_aware_retry_on_429(segs):
    """A data-node 429 fails over ONCE to another replica of the segment
    set before surfacing: a saturated node is not a saturated tier."""
    view, (shedding, _), broker = _cluster(
        segs[1], cls=lambda n: _SheddingNode(n) if n == "shedding"
        else _cpu_node(n), names=("shedding", "good"),
        seed=3)
    q = dict(TS, granularity="day", aggregations=AGGS,
             context={"lane": "interactive"})
    want = RefExecutor(segs[0]).run_json(q)
    hit_shed = False
    try:
        for _ in range(6):
            _close(want, broker.run(query_from_json(q)))
            hit_shed = hit_shed or shedding.shed_calls > 0
            shedding.sheds = 10**9
    finally:
        broker.stop()
    assert hit_shed
    assert view.capacity_sheds("shedding") > 0


@pytest.mark.parametrize("names", [("shed1", "shed2"), ("only",)],
                         ids=["every_replica_sheds", "no_other_replica"])
def test_broker_surfaces_429(segs, names):
    _, _, broker = _cluster(segs[1], cls=_SheddingNode, names=names,
                            replicas=len(names))
    try:
        with pytest.raises(QueryCapacityError):
            broker.run(query_from_json(TS))
    finally:
        broker.stop()


# ---------------------------------------------------------------------------
# resilience surfaces (tests/test_resilience.py)
# ---------------------------------------------------------------------------

def test_client_retry_after_sleep_is_jittered(monkeypatch):
    """The one 429 retry sleeps a decorrelated-jittered time seeded from
    the node's Retry-After, capped at MAX_RETRY_AFTER_SLEEP."""
    from druid_tpu_torch.cluster import resilience as R
    from tests.test_torch_scheduler import _stub_shedding_server
    seen = {}

    def fake_jitter(rng, base, prev, cap):
        seen["args"] = (base, prev, cap)
        return 0.0                        # no real sleep in the test

    monkeypatch.setattr(R, "decorrelated_jitter", fake_jitter)
    monkeypatch.setattr(RemoteDataNodeClient, "MAX_RETRY_AFTER_SLEEP", 0.05)
    seg = _carry(DataGenerator(TEST_SCHEMA, seed=42).segments(
        1, 512, Interval.of("2026-01-01", "2026-01-02"),
        datasource="test")[0])
    httpd, handler, q = _stub_shedding_server([seg], shed_n=1)
    try:
        client = RemoteDataNodeClient(
            "stub", f"http://127.0.0.1:{httpd.server_address[1]}",
            jitter_seed=0)
        client.run_partials(q, [str(seg.id)])
        base, prev, cap = seen["args"]
        assert base == prev > 0           # seeded from the Retry-After
        assert cap == 0.05
        assert len(handler.calls) == 2
    finally:
        httpd.shutdown()
        httpd.server_close()


class _DeadNode(DataNode):
    def __init__(self, name):
        super().__init__(name, device="cpu")

    def run_partials(self, query, segment_ids, check=None):
        raise ConnectionError(f"[{self.name}] down")


def test_partial_contract_over_http(segs, served):
    """The missing-segments report rides the X-Druid-Response-Context
    header, exactly once and without the complete result's ETag, with the
    body rows equal to the reference's over the surviving segments; a
    strict query over the same cluster answers 500 without the header.
    (The SQL half of tests/test_resilience.py:445 is in
    tests/test_torch_sql.py.)"""
    view = InventoryView()
    dead, live = _DeadNode("dead"), DataNode("live", device="cpu")
    view.register(dead)
    view.register(live)
    for i, s in enumerate(segs[1]):
        n = dead if i % 2 == 0 else live
        n.load_segment(s)
        view.announce(n.name, descriptor_for(s))
    broker = Broker(view, device="cpu")
    srv = served(QueryHttpServer(QueryLifecycle(broker)))
    lost = {str(s.id) for i, s in enumerate(segs[1]) if i % 2 == 0}
    survivors = [s for i, s in enumerate(segs[0]) if i % 2 == 1]
    try:
        q = dict(TS, granularity="day", aggregations=AGGS,
                 context={"allowPartialResults": True})
        status, body, headers = _post(srv.port, q)
        assert status == 200
        rc = json.loads(headers["X-Druid-Response-Context"])
        assert rc["partial"] is True
        assert set(rc["missingSegments"]) == lost
        _close(RefExecutor(survivors).run_json(q), body)
        assert headers.get("X-Druid-ETag") is None
        status, _, headers = _post(srv.port, dict(TS, aggregations=AGGS))
        assert status == 500
        assert headers.get("X-Druid-Response-Context") is None
    finally:
        broker.stop()


def test_http_server_wires_resilience_monitor(segs, served):
    """A broker-backed QueryHttpServer surfaces broker/circuit/* on its
    /metrics registry after a tick."""
    _, _, broker = _cluster(segs[1], names=("n1",), replicas=1)
    srv = served(QueryHttpServer(QueryLifecycle(broker)))
    try:
        broker.resilience.circuits.on_failure("n1")
        srv.metrics_tick()
        expo = srv.registry.exposition()
        assert "broker_circuit_open" in expo
        assert "query_hedge_issued" in expo
    finally:
        broker.stop()


# ---------------------------------------------------------------------------
# NDJSON scan streaming (tests/test_streaming_scan.py)
# ---------------------------------------------------------------------------

SCAN = {"queryType": "scan", "dataSource": "test", "intervals": [WEEK],
        "columns": ["dimA"], "batchSize": 1000, "limit": 3500,
        "order": "ascending"}


def _ndjson(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/druid/v2", json.dumps(payload).encode(),
        headers={"Content-Type": "application/json",
                 "Accept": "application/x-ndjson"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        assert r.headers["Content-Type"] == "application/x-ndjson"
        return [json.loads(line) for line in r if line.strip()]


@pytest.mark.parametrize("runner", ["executor", "broker_over_http"])
def test_http_ndjson_streaming(segs, served, runner):
    """Chunked NDJSON: one scan batch a line, the rows of the one-shot
    JSON array (plain Accept), and the reference's rows."""
    if runner == "executor":
        lc_runner = _ex(segs)
    else:
        view = InventoryView()
        for i in range(2):
            n = DataNode(f"scan{i}", device="cpu")
            srv = served(DataNodeServer(n))
            view.register(RemoteDataNodeClient(n.name, srv.url))
            for s in segs[1][2 * i:2 * i + 2]:
                n.load_segment(s)
                view.announce(n.name, descriptor_for(s))
        lc_runner = Broker(view, device="cpu")
    srv = served(QueryHttpServer(QueryLifecycle(lc_runner)))
    try:
        batches = _ndjson(srv.port, SCAN)
        assert sum(len(b["events"]) for b in batches) == 3500
        assert len(batches) >= 4        # chunked, not one blob
        status, arr, _ = _post(srv.port, SCAN)
        assert status == 200
        events = [e for b in batches for e in b["events"]]
        assert events == [e for b in arr for e in b["events"]]
        assert events == [e for b in RefExecutor(segs[0]).run_json(SCAN)
                          for e in b["events"]]
    finally:
        if runner != "executor":
            lc_runner.stop()


def test_abandoned_stream_is_accounted(segs):
    """A client disconnect (generator close) still emits the request log
    and the failure count; a fully consumed stream counts success."""
    results = []
    logger = RequestLogger()
    lc = QueryLifecycle(_ex(segs), request_logger=logger,
                        on_result=results.append)
    q = query_from_json(dict(SCAN, batchSize=10, limit=None))
    gen = lc.run_streaming(q)
    next(gen)
    gen.close()
    assert results == [False]
    assert logger.entries and "abandoned" in str(logger.entries[-1])
    rows = list(lc.run_streaming(q))
    assert rows and results == [False, True]


def test_streaming_stamps_query_id_for_cancel():
    """run_streaming stamps its generated queryId into the query it runs,
    so cancel tokens act on the running scatter."""
    seen = {}

    class Probe:
        def run_streaming(self, query):
            seen["qid"] = query.context_map.get("queryId")
            yield {"events": []}

        def run(self, query):
            return []

    lc = QueryLifecycle(Probe(), query_manager=QueryManager())
    list(lc.run_streaming(query_from_json(SCAN)))
    assert seen["qid"]


# ---------------------------------------------------------------------------
# distributed tracing over the wire (tests/test_qtrace.py)
# ---------------------------------------------------------------------------

@pytest.fixture()
def traced_cluster(segs, served):
    """2 DataNodeServers with their OWN TraceStores: their spans reach the
    broker's process store only through the response payload."""
    view = InventoryView()
    nodes = [DataNode(f"tnode{i}", device="cpu") for i in range(2)]
    servers, node_stores = [], []
    for node in nodes:
        st = qtrace.TraceStore()
        node_stores.append(st)
        srv = served(DataNodeServer(node, trace_store=st))
        servers.append(srv)
        view.register(RemoteDataNodeClient(node.name, srv.url))
    for i, s in enumerate(segs[1]):
        nodes[i % 2].load_segment(s)
        view.announce(nodes[i % 2].name, descriptor_for(s))
    broker = Broker(view, device="cpu")
    yield nodes, servers, node_stores, broker
    broker.stop()


def _groupby(qid, **ctx):
    return query_from_json({
        "queryType": "groupBy", "dataSource": "test", "intervals": [WEEK],
        "granularity": "day", "dimensions": ["dimA"], "aggregations": AGGS,
        "context": {"queryId": qid, **ctx}})


def test_distributed_trace_assembly(traced_cluster):
    nodes, _, node_stores, broker = traced_cluster
    broker.run(_groupby("trace-e2e-1"))
    tr = qtrace.trace_store().get("trace-e2e-1")
    assert tr is not None and tr["traceId"] == "trace-e2e-1"
    spans = tr["spans"]
    by_id = {s["spanId"]: s for s in spans}
    names = [s["name"] for s in spans]
    for phase in ("broker/query", "broker/plan", "broker/scatter",
                  "broker/node", "broker/merge", "engine/partials"):
        assert phase in names, f"missing {phase} in {sorted(set(names))}"
    # BOTH nodes' remote spans made it back over the wire
    node_roots = [s for s in spans if s["name"] == "datanode/query"]
    assert {s["service"] for s in node_roots} == {"tnode0", "tnode1"}
    # every span but the one root resolves to a parent in the same trace;
    # node roots hang off broker/node spans
    roots = [s for s in spans if s["parentId"] is None]
    assert len(roots) == 1 and roots[0]["name"] == "broker/query"
    for s in spans:
        if s["parentId"] is not None:
            assert s["parentId"] in by_id, f"orphan span {s['name']}"
    for nr in node_roots:
        assert by_id[nr["parentId"]]["name"] == "broker/node"
    # a node-local store only ever saw that node's own spans
    for st, node in zip(node_stores, nodes):
        local = st.spans("trace-e2e-1")
        assert local and all(s["service"] == node.name for s in local)


def test_trace_false_yields_no_spans(traced_cluster):
    _, _, node_stores, broker = traced_cluster
    broker.run(_groupby("trace-off-1", trace=False))
    assert qtrace.trace_store().get("trace-off-1") is None
    for st in node_stores:
        assert st.get("trace-off-1") is None


def test_trace_endpoint_on_data_node(traced_cluster):
    """GET /druid/v2/trace/<queryId> on a data node serves its span tree;
    an unknown id is a 404."""
    nodes, servers, _, broker = traced_cluster
    broker.run(_groupby("node-endpoint-1"))
    with urllib.request.urlopen(
            servers[0].url + "/druid/v2/trace/node-endpoint-1",
            timeout=TIMEOUT) as r:
        got = json.loads(r.read())
    assert got["traceId"] == "node-endpoint-1"
    assert all(s["service"] == nodes[0].name for s in got["spans"])
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(
            servers[0].url + "/druid/v2/trace/no-such-query",
            timeout=TIMEOUT)
    assert ei.value.code == 404


def test_trace_endpoint_on_broker_http(traced_cluster, served):
    """The broker's QueryHttpServer serves the ASSEMBLED trace — broker
    spans AND both nodes' remote spans — for a query run through it."""
    _, _, _, broker = traced_cluster
    srv = served(QueryHttpServer(QueryLifecycle(broker)))
    status, _, _ = _post(srv.port, _groupby("http-trace-1").to_json())
    assert status == 200
    status, got = _get(srv.port, "/druid/v2/trace/http-trace-1")
    assert status == 200
    names = {s["name"] for s in got["spans"]}
    assert {"query", "broker/node", "datanode/query"} <= names
    assert {"tnode0", "tnode1"} <= {s["service"] for s in got["spans"]}


def test_lifecycle_emits_phase_metrics():
    """query/stage/h2d/time emits on the first run over FRESH segments (a
    cold device pool) and not on the second; broker/node spans feed
    query/node/time on both. (query/compile/time has no counterpart.)"""
    gen = DataGenerator((ColumnSpec("dimA", "string", cardinality=10),
                         ColumnSpec("metLong", "long", low=0, high=100)),
                        seed=99)
    fresh = [_carry(s) for s in gen.segments(
        2, 1000, Interval.of("2026-01-01", "2026-01-03"), datasource="test")]
    _, _, broker = _cluster(fresh, names=("mnode",), replicas=1)
    sink = InMemoryEmitter()
    lc = QueryLifecycle(broker, ServiceEmitter("broker", "h", sink))
    try:
        lc.run(_groupby("metrics-1"))
        lc.run(_groupby("metrics-2"))
    finally:
        broker.stop()
    assert [e.dims["id"] for e in sink.metrics("query/stage/h2d/time")] \
        == ["metrics-1"]
    assert sink.metrics("query/compile/time") == []
    node_events = sink.metrics("query/node/time")
    assert {e.dims["id"] for e in node_events} == {"metrics-1", "metrics-2"}
    assert all(e.dims["server"] == "mnode" for e in node_events)


def test_slow_query_log_threshold(segs):
    """Queries over the threshold emit an alert with the phase breakdown;
    under it, nothing; {"trace": false} still alerts, with an empty
    breakdown."""
    def run(qid, threshold, **ctx):
        sink = InMemoryEmitter()
        QueryLifecycle(_ex(segs), ServiceEmitter("broker", "h", sink),
                       slow_query_ms=threshold).run(_groupby(qid, **ctx))
        return [e for e in sink.events if e.kind == "alert"]

    alerts = run("slow-1", 0.0)
    assert len(alerts) == 1 and alerts[0].dims["queryId"] == "slow-1"
    bd = alerts[0].dims["breakdown"]
    assert isinstance(bd, dict) and bd and all(v >= 0 for v in bd.values())
    assert run("slow-2", 1e9) == []
    alerts = run("slow-3", 0.0, trace=False)
    assert len(alerts) == 1 and alerts[0].dims["breakdown"] == {}


# ---------------------------------------------------------------------------
# security (tests/test_router_security.py)
# ---------------------------------------------------------------------------

def _chain():
    authz = RoleBasedAuthorizer(
        role_permissions={
            "analyst": [Permission("test", actions=(READ,))],
            "admin": [Permission("*")]},
        user_roles={"alice": ["analyst"], "root": ["admin"]})
    return AuthChain(
        authenticators=[BasicHTTPAuthenticator(
            {"alice": "pw1", "root": "pw2"}, authorizer_name="rbac")],
        authorizers={"rbac": authz, "allowAll": AllowAllAuthorizer()})


def _basic(user, pw):
    return {"Authorization":
            "Basic " + base64.b64encode(f"{user}:{pw}".encode()).decode()}


def test_authenticator_chain():
    chain = _chain()
    assert chain.authenticate(_basic("alice", "pw1")).identity == "alice"
    assert chain.authenticate(_basic("alice", "wrong")) is None
    assert chain.authenticate({}) is None
    assert chain.escalator.escalate().authorizer_name == "allowAll"


def test_rbac_authorization_per_datasource(segs):
    chain = _chain()
    lc = QueryLifecycle(_ex(segs), authorizer=authorizer_for_query(chain))
    alice = chain.authenticate(_basic("alice", "pw1"))
    assert lc.run_json(TS, identity=alice)[0]["result"]["n"] > 0
    with pytest.raises(Unauthorized):
        lc.run_json(dict(TS, dataSource="secret"), identity=alice)
    root = chain.authenticate(_basic("root", "pw2"))
    assert lc.run_json(TS, identity=root)
    with pytest.raises(Unauthorized):
        lc.run_json(TS, identity=None)


def test_http_auth_401_and_403(segs, served):
    chain = _chain()
    lc = QueryLifecycle(_ex(segs), authorizer=authorizer_for_query(chain))
    srv = served(QueryHttpServer(lc, auth_chain=chain))
    assert _post(srv.port, TS)[0] == 401                   # no credentials
    assert _post(srv.port, TS, _basic("alice", "nope"))[0] == 401
    status, rows, _ = _post(srv.port, TS, _basic("alice", "pw1"))
    assert status == 200 and rows[0]["result"]["n"] > 0
    assert _post(srv.port, dict(TS, dataSource="secret"),
                 _basic("alice", "pw1"))[0] == 403        # denied


def test_get_and_delete_require_auth(segs, served):
    """tests/test_router_security.py:235 — every other resource sits behind
    the chain too; /status stays open for health checks."""
    chain = _chain()
    lc = QueryLifecycle(_ex(segs), authorizer=authorizer_for_query(chain))
    srv = served(QueryHttpServer(lc, auth_chain=chain))
    assert _get(srv.port, "/druid/v2/datasources")[0] == 401
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/druid/v2/q1",
                                 method="DELETE")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=TIMEOUT)
    assert e.value.code == 401
    assert _get(srv.port, "/status")[0] == 200


def test_bad_basic_credentials_do_not_fall_through():
    """A wrong password on a PRESENT Basic header denies the request; it
    does not launder into a weaker downstream authenticator."""
    chain = AuthChain(
        authenticators=[BasicHTTPAuthenticator({"alice": "pw1"}),
                        AllowAllAuthenticator()],
        authorizers={"allowAll": AllowAllAuthorizer()})
    assert chain.authenticate(_basic("alice", "WRONG")) is None
    assert chain.authenticate({}).identity == "allowAll"
