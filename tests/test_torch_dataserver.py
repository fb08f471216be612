"""The port's HTTP data plane (druid_tpu_torch/cluster/dataserver.py: the
DataNodeServer and the broker's RemoteDataNodeClient) on the CPU: the
cases of tests/test_dataplane.py over real sockets on 127.0.0.1, each
query's rows against the reference package's QueryExecutor on the same
segments (tests/conftest.py's `segments` data, carried into the port as
plain arrays). The rule: counts, long sums, min/max and HLL estimates equal
bit for bit, float sums within 1e-5 * sum|v| per row.

Beyond the reference's cases: a longSum past 2^31 with a count through
HTTP (the wire keeps the node's int64 states), the compressed wire against
the plain one, JSON-native replies, the `missing` report of a node asked
for a segment it does not hold, the resource's 504, and that a node's
failure reaches the broker as its typed error (504, 500 cancelled, any
other status). The wire's own cases are in test_torch_wire.py.

Every server binds 127.0.0.1 port 0 and is stopped in its fixture's
finalizer; every urlopen has a timeout.
"""
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.generator import DataGenerator
from druid_tpu.data.segment import SegmentBuilder
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.utils.intervals import Interval as RefInterval

from druid_tpu_torch.cluster import (Broker, DataNode, DataNodeServer,
                                     InventoryView, RemoteDataNodeClient,
                                     RemoteQueryError, descriptor_for, wire)
from druid_tpu_torch.query.model import query_from_json
from druid_tpu_torch.server import (QueryHttpServer, QueryInterruptedError,
                                    QueryLifecycle, QueryManager,
                                    QueryTimeoutError)
from druid_tpu_torch.server.querymanager import cancel_path_id
from tests.conftest import TEST_SCHEMA
from tests.test_torch_cluster import _close
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

WEEK = "2026-01-01/2026-01-08"
AGGS = [{"type": "count", "name": "rows"},
        {"type": "longSum", "name": "ls", "fieldName": "metLong"}]
TIMEOUT = 30


@pytest.fixture(scope="module")
def segs():
    ref = DataGenerator(TEST_SCHEMA, seed=42).segments(
        4, 5_000, RefInterval.of("2026-01-01", "2026-01-05"),
        datasource="test")
    return ref, [_carry(s) for s in ref]


def _ref_rows(segs, q):
    return RefExecutor(segs[0]).run_json(q)


def _ts(gran="day", aggs=AGGS, **kw):
    return {"queryType": "timeseries", "dataSource": "test",
            "intervals": [WEEK], "granularity": gran,
            "aggregations": aggs, **kw}


def _serve(nodes, segments, replicas=2, broker_kw=None):
    """A DataNodeServer per node, a RemoteDataNodeClient per server in one
    InventoryView, the segments round-robin over the nodes with
    `replicas` copies, and a Broker that sees only the clients. Returns
    (servers, clients, broker)."""
    view = InventoryView()
    servers, clients = [], []
    for n in nodes:
        srv = DataNodeServer(n).start()
        servers.append(srv)
        c = RemoteDataNodeClient(n.name, srv.url)
        clients.append(c)
        view.register(c)
    for i, s in enumerate(segments):
        for j in range(replicas):
            node = nodes[(i + j) % len(nodes)]
            node.load_segment(s)
            view.announce(node.name, descriptor_for(s))
    return servers, clients, Broker(view, device="cpu", **(broker_kw or {}))


def _stop(servers, broker):
    broker.stop()
    for s in servers:
        s.stop()


@pytest.fixture()
def http_cluster(segs):
    """2 data nodes behind real HTTP servers; the broker only sees
    RemoteDataNodeClients — every query crosses a socket."""
    nodes = [DataNode(f"http-node{i}", device="cpu") for i in range(2)]
    servers, clients, broker = _serve(nodes, segs[1])
    yield nodes, servers, broker
    _stop(servers, broker)


def _through(broker, segs, q):
    got = broker.run(query_from_json(q))
    _close(_ref_rows(segs, q), got)
    return got


def test_http_timeseries_matches_reference(http_cluster, segs):
    _through(http_cluster[2], segs, _ts())


def test_http_topn_matches_reference(http_cluster, segs):
    _through(http_cluster[2], segs, {
        "queryType": "topN", "dataSource": "test", "intervals": [WEEK],
        "granularity": "all", "dimension": "dimB", "metric": "ls",
        "threshold": 10, "aggregations": AGGS})


def test_http_groupby_with_filter_matches_reference(http_cluster, segs):
    _through(http_cluster[2], segs, {
        "queryType": "groupBy", "dataSource": "test", "intervals": [WEEK],
        "granularity": "day", "dimensions": ["dimA"], "aggregations": AGGS,
        "filter": {"type": "bound", "dimension": "metLong", "lower": "10",
                   "upper": "90", "ordering": "numeric"}})


def test_http_hll_state_merge_exact(http_cluster, segs):
    """HLL registers survive the wire: broker == single process."""
    _through(http_cluster[2], segs, _ts("all", [
        {"type": "cardinality", "name": "u", "fields": ["dimHi"]}]))


def test_http_row_queries(http_cluster, segs):
    broker = http_cluster[2]
    _through(broker, segs, {"queryType": "timeBoundary",
                            "dataSource": "test", "intervals": [WEEK]})
    got = broker.run(query_from_json({
        "queryType": "scan", "dataSource": "test", "intervals": [WEEK],
        "columns": ["dimA", "metLong"], "limit": 17,
        "order": "ascending"}))
    assert sum(len(b["events"]) for b in got) == 17
    _through(broker, segs, {
        "queryType": "search", "dataSource": "test", "intervals": [WEEK],
        "query": {"type": "insensitive_contains", "value": "v0000000"},
        "limit": 10})


def test_http_node_death_fails_over(http_cluster, segs):
    nodes, servers, broker = http_cluster
    servers[0].stop()   # node 0's server goes dark; replicas live on node 1
    _through(broker, segs, _ts())
    assert broker.resilience.circuits.failures_by_server().get(
        "http-node0", 0) >= 1


def test_http_long_sum_past_2_31_keeps_int64(segs):
    """Per-group long sums past 2^31 and counts cross the wire as the
    node's int64 states; the broker's combine adds them without wrapping,
    and the rows equal the reference executor's."""
    rng = np.random.default_rng(7)
    n, start = 4_096, RefInterval.of("2026-02-01", "2026-02-02").start
    ref_segs = []
    for p in range(2):
        b = SegmentBuilder("wide", RefInterval(start, start + 86_400_000),
                           version="v1", partition=p)
        b.add_columns(start + np.sort(rng.integers(0, 86_400_000, n)),
                      {"g": [f"g{i}" for i in rng.integers(0, 4, n)]},
                      {"big": rng.integers(2 ** 30, 2 ** 31 - 1, n)})
        ref_segs.append(b.build())
    port_segs = [_carry(s) for s in ref_segs]
    nodes = [DataNode(f"wide{i}", device="cpu") for i in range(2)]
    servers, _, broker = _serve(nodes, port_segs, replicas=1)
    try:
        q = {"queryType": "groupBy", "dataSource": "wide",
             "intervals": ["2026-02-01/2026-02-02"], "granularity": "all",
             "dimensions": ["g"],
             "aggregations": [{"type": "count", "name": "n"},
                              {"type": "longSum", "name": "s",
                               "fieldName": "big"},
                              {"type": "longMax", "name": "mx",
                               "fieldName": "big"}]}
        got = broker.run(query_from_json(q))
        want = RefExecutor(ref_segs).run_json(q)
        _close(want, got)
        assert all(r["event"]["s"] > 2 ** 31 for r in got)
        # each node's states travel as int64
        sid = str(port_segs[0].id)
        ap, _ = nodes[0].run_partials(query_from_json(q), [sid])
        ap2, _, _ = wire.loads_partials(wire.dumps_partials(ap, [sid]))
        assert ap2.partials[0].counts.dtype == np.int64
        assert ap2.partials[0].states["s"].dtype == np.int64
    finally:
        _stop(servers, broker)


def _post(url, body, headers=None, method="POST"):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method=method)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_partials_endpoint_compress_and_missing(http_cluster, segs):
    """/druid/v2/partials: the compressed wire (asked for by the request
    and not refused by the query's context) loads to the same partials as
    the plain one and is smaller; a segment the node does not hold comes
    back in `missing`; a bare query JSON (no "query" key) is a 400."""
    nodes, servers, _ = http_cluster
    sids = sorted(nodes[0].served_segment_ids())
    q = {"queryType": "groupBy", "dataSource": "test", "intervals": [WEEK],
         "granularity": "hour", "dimensions": ["dimA"], "aggregations": AGGS}
    url = servers[0].url + "/druid/v2/partials"
    out = {}
    for tag, body in (
            ("plain", {"query": q, "segments": sids}),
            ("compressed", {"query": q, "segments": sids,
                            "wireCompress": True}),
            ("refused", {"query": dict(q, context={"wireCompress": False}),
                         "segments": sids, "wireCompress": True})):
        code, hdrs, data = _post(url, body)
        assert code == 200 and hdrs["Content-Type"] == wire.CONTENT_TYPE
        out[tag] = data
    assert out["plain"][4] == out["refused"][4] == wire.VERSION
    assert out["compressed"][4] == wire.VERSION_COMPRESSED
    assert len(out["compressed"]) < len(out["plain"])
    pq = query_from_json(q)
    from druid_tpu_torch.engine import engines
    rows = [engines.finish_groupby(pq, wire.loads_partials(d)[0])
            for d in out.values()]
    assert rows[0] == rows[1] == rows[2]
    code, _, data = _post(url, {"query": q, "segments": sids + ["gone"]})
    assert code == 200 and wire.loads_partials(data).missing == ["gone"]
    code, _, _ = _post(url, q)
    assert code == 400


def test_http_replies_are_json_native(http_cluster, segs):
    """No numpy or torch scalar leaks into a reply: the broker's rows of
    every aggregate query type and the HLL estimate dump with plain json
    (no default hook) and equal what the HTTP resource answers."""
    broker = http_cluster[2]
    http = QueryHttpServer(QueryLifecycle(broker)).start()
    try:
        for q in (_ts(), _ts("all", AGGS + [{"type": "cardinality",
                                              "name": "u",
                                              "fields": ["dimHi"]}]),
                  {"queryType": "topN", "dataSource": "test",
                   "intervals": [WEEK], "granularity": "all",
                   "dimension": "dimB", "metric": "ls", "threshold": 5,
                   "aggregations": AGGS}):
            rows = broker.run(query_from_json(q))
            code, _, data = _post(f"http://127.0.0.1:{http.port}/druid/v2",
                                  q)
            assert code == 200
            assert json.loads(json.dumps(rows)) == json.loads(data)
    finally:
        http.stop()


# ---------------------------------------------------------------------------
# Cancel + timeout
# ---------------------------------------------------------------------------

class _SlowNode(DataNode):
    """DataNode whose partials path stalls, to give cancel/timeout a window."""

    def __init__(self, name, delay=1.0):
        super().__init__(name, device="cpu")
        self.delay = delay

    def run_partials(self, query, segment_ids, check=None):
        time.sleep(self.delay)
        return super().run_partials(query, segment_ids, check=check)


@pytest.fixture()
def slow_http_cluster(segs):
    node = _SlowNode("slow-node", delay=1.0)
    servers, _, broker = _serve([node], segs[1], replicas=1,
                                broker_kw={"max_retries": 0})
    yield node, servers[0], broker
    _stop(servers, broker)


def test_http_timeout(slow_http_cluster):
    broker = slow_http_cluster[2]
    q = query_from_json(_ts("all", context={"timeout": 200,
                                            "queryId": "to-1"}))
    t0 = time.monotonic()
    with pytest.raises(QueryTimeoutError):
        broker.run(q)
    assert time.monotonic() - t0 < 0.9   # did not wait out the full delay


def test_http_cancel_mid_flight(slow_http_cluster):
    broker = slow_http_cluster[2]
    qid = "cancel-1"
    q = query_from_json(_ts("all", context={"queryId": qid}))
    broker.query_manager.register(qid)
    errors = []

    def run():
        try:
            broker.run(q)
        except Exception as e:
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    time.sleep(0.3)          # request is in flight on the slow node
    assert broker.query_manager.cancel(qid)
    t.join(timeout=10)
    assert not t.is_alive()
    assert errors and isinstance(errors[0], QueryInterruptedError), errors


def test_cancel_before_scatter(segs):
    """A token tripped before execution stops the query at the first
    checkpoint, without touching any node."""
    view = InventoryView()
    node = DataNode("n0", device="cpu")
    view.register(node)
    for s in segs[1]:
        node.load_segment(s)
        view.announce(node.name, descriptor_for(s))
    broker = Broker(view, device="cpu")
    qid = "pre-cancel"
    broker.query_manager.register(qid)
    broker.query_manager.cancel(qid)
    try:
        with pytest.raises(QueryInterruptedError):
            broker.run(query_from_json(_ts("all",
                                           context={"queryId": qid})))
    finally:
        broker.stop()


def test_remote_query_error_propagates(segs):
    """A node-side query error (HTTP 500 from a kernel crash) reaches the
    caller with the node's message, not a MissingSegmentsError, and the
    call counts as failed on that server."""

    class BrokenNode(DataNode):
        def run_partials(self, query, segment_ids, check=None):
            raise RuntimeError("kernel exploded: device OOM")

    servers, _, broker = _serve([BrokenNode("broken", device="cpu")],
                                segs[1], replicas=1)
    try:
        with pytest.raises(RemoteQueryError, match="kernel exploded"):
            broker.run(query_from_json(_ts("all")))
    finally:
        _stop(servers, broker)


def test_duplicate_queryid_refcounted():
    """Two in-flight registrations of one id share a token that survives
    the first unregister (a client retry reusing its queryId)."""
    qm = QueryManager()
    t1 = qm.register("dup")
    t2 = qm.register("dup")
    assert t1 is t2
    qm.unregister("dup")
    assert qm.cancel("dup")          # second flight still cancellable
    qm.unregister("dup")
    assert not qm.cancel("dup")      # fully released


def test_cancel_path_id_exactness():
    assert cancel_path_id("/druid/v2/abc-123") == "abc-123"
    assert cancel_path_id("/druid/v2/abc-123/") == "abc-123"
    assert cancel_path_id("/druid/v2/datasources") is None
    assert cancel_path_id("/druid/v2/") is None
    assert cancel_path_id("/druid/v2") is None
    assert cancel_path_id("/other/v2/abc") is None
    assert cancel_path_id("/druid/v2/a/b") is None


def test_http_delete_cancel_endpoint(slow_http_cluster):
    """DELETE /druid/v2/{id} at the broker's HTTP resource trips the broker
    token (QueryResource.cancelQuery analog)."""
    broker = slow_http_cluster[2]
    http = QueryHttpServer(QueryLifecycle(broker)).start()
    url = f"http://127.0.0.1:{http.port}/druid/v2"
    try:
        results = []
        t = threading.Thread(target=lambda: results.append(_post(
            url, _ts("all", context={"queryId": "http-cancel"}))))
        t.start()
        time.sleep(0.3)
        code, _, _ = _post(url + "/http-cancel", None, method="DELETE")
        assert code == 202
        t.join(timeout=10)
        assert not t.is_alive()
        code, _, body = results[0]
        assert code == 500 and b"cancel" in body.lower(), results
    finally:
        http.stop()


def test_http_resource_answers_504_on_timeout(slow_http_cluster):
    """A query whose context timeout the slow node cannot meet is a 504
    "Query timed out" at the broker's resource, well before the node's
    delay is out."""
    broker = slow_http_cluster[2]
    http = QueryHttpServer(QueryLifecycle(broker)).start()
    try:
        t0 = time.monotonic()
        code, _, body = _post(f"http://127.0.0.1:{http.port}/druid/v2",
                              _ts("all", context={"timeout": 200}))
        assert time.monotonic() - t0 < 0.9
        assert code == 504 and json.loads(body)["error"] == \
            "Query timed out"
    finally:
        http.stop()


class _Answer(BaseHTTPRequestHandler):
    """A node that answers every POST with one status and body."""
    code, body = 500, b"{}"

    def log_message(self, fmt, *args):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        self.send_response(self.code)
        self.send_header("Content-Length", str(len(self.body)))
        self.end_headers()
        self.wfile.write(self.body)


@pytest.mark.parametrize("code,body,err", [
    (504, b'{"error": "Query timed out"}', QueryTimeoutError),
    (500, b'{"error": "Query cancelled"}', QueryInterruptedError),
    (500, b'{"error": "RuntimeError: boom"}', RemoteQueryError),
    (400, b'{"error": "ValueError: bad"}', RemoteQueryError),
    (404, b'{"error": "unknown path"}', RemoteQueryError)],
    ids=["504", "500_cancelled", "500", "400", "404"])
def test_client_maps_node_status_to_typed_errors(code, body, err):
    """RemoteDataNodeClient turns a node's HTTP status back into the
    error the node raised; a query error is never retried away."""
    handler = type("H", (_Answer,), {"code": code, "body": body})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        client = RemoteDataNodeClient(
            "stub", f"http://127.0.0.1:{httpd.server_address[1]}")
        with pytest.raises(err):
            client.run_partials(query_from_json(_ts("all")), ["s"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=5)


def test_status_lists_descriptors_and_client_syncs(http_cluster):
    """/status carries the node's segment descriptors; the client's ping
    and served_descriptors read them; a stopped server reads as dead."""
    nodes, servers, _ = http_cluster
    c = RemoteDataNodeClient(nodes[0].name, servers[0].url,
                             connect_timeout=2.0)
    assert c.ping()
    assert {d.id for d in c.served_descriptors()} \
        == nodes[0].served_segment_ids() == c.served_segment_ids()
    servers[0].stop()
    assert not c.ping()
    assert c.served_segment_ids() == set()
    with pytest.raises(ConnectionError):
        c.served_descriptors()
