"""The router cases of tests/test_router_security.py (:46-131, :205 and
:258) on the port (druid_tpu_torch/server/router.py), and the router in
front of a port broker over real sockets on 127.0.0.1.

The tier selection is deterministic: every selector case runs through
both packages' TieredBrokerSelector/Router over fake brokers, and the
picks must be equal. The proxy cases send native JSON, SQL and an Avatica
round trip through the port's RouterHttpServer to a QueryHttpServer over
the port's Broker, and the rows must equal the reference's SqlExecutor /
QueryExecutor over the same segments (tests/conftest.py's `segments`,
carried as plain arrays): counts and long sums bit for bit, float sums
within 1e-5 relative to the reference's (non-negative columns, so within
1e-5 * sum|v| per group).
"""
import json
import urllib.request

import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.server import router as ref_router
from druid_tpu.sql import SqlExecutor as RefSql
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch import cluster as port_cluster
from druid_tpu_torch.engine import QueryExecutor
from druid_tpu_torch.server import (QueryHttpServer, QueryLifecycle, Router,
                                    RouterHttpServer, TieredBrokerSelector,
                                    authorizer_for_query)
from druid_tpu_torch.server import router as port_router
from druid_tpu_torch.sql import SqlExecutor
from tests.test_torch_cluster import _build
from tests.test_torch_http import _basic, _chain, _post
from tests.test_torch_slice import _carry
from tests.test_torch_sql import check_rows

torch.set_num_threads(1)

TIMEOUT = 60
TS_Q = {"queryType": "timeseries", "dataSource": "test",
        "intervals": ["2026-01-01/2026-01-08"], "granularity": "all",
        "aggregations": [{"type": "count", "name": "n"}]}


class FakeBroker:
    def __init__(self, name):
        self.name = name
        self.calls = []

    def run_json(self, payload):
        self.calls.append(payload)
        return [{"broker": self.name}]


# ---------------------------------------------------------------------------
# tier selection, through both packages
# ---------------------------------------------------------------------------

def _selector_cases():
    """(id, tiers, selector kwargs, [(payload, now_ms)])"""
    now = Interval.of("2026-01-07", "2026-01-08").start
    return [
        ("manual_and_default", ["hot", "_default"],
         {"default_tier": "_default"},
         [(TS_Q, None), ({**TS_Q, "context": {"brokerService": "hot"}},
                         None)]),
        ("priority_tier", ["hot", "low"],
         {"default_tier": "hot", "min_priority": 0, "priority_tier": "low"},
         [({**TS_Q, "context": {"priority": -5}}, None), (TS_Q, None)]),
        ("datasource_period_rule", ["hot", "_default"],
         {"default_tier": "_default",
          "rules": {"test": [{"periodMs": 30 * 86_400_000,
                              "tier": "hot"}]}},
         [(TS_Q, now), ({**TS_Q, "intervals": ["2020-01-01/2020-01-02"]},
                        now)]),
        ("period_string_rule", ["hot", "_default"],
         {"default_tier": "_default",
          "rules": {"test": [{"period": "P30D", "tier": "hot"}]}},
         [(TS_Q, now), ({**TS_Q, "intervals": ["2020-01-01/2020-01-02"]},
                        now)]),
        ("priority_tier_without_brokers", ["hot"],
         {"default_tier": "hot", "min_priority": 0, "priority_tier": "cold"},
         [({**TS_Q, "context": {"priority": -5}}, None)]),
    ]


@pytest.mark.parametrize("case", _selector_cases(), ids=lambda c: c[0])
def test_selector_matches_reference(case):
    _, tiers, kw, payloads = case
    picks = []
    for pkg in (ref_router, port_router):
        brokers = {t: [FakeBroker(t)] for t in tiers}
        sel = pkg.TieredBrokerSelector(brokers, **kw)
        router = pkg.Router(sel)
        got = []
        for payload, now in payloads:
            tier, b = sel.pick(payload, now_ms=now)
            got.append((tier, b.name))
            if now is None:
                got.append(router.run_json(payload))
        picks.append(got)
    assert picks[1] == picks[0]


def test_router_round_robin_within_tier():
    b1, b2 = FakeBroker("a"), FakeBroker("b")
    router = Router(TieredBrokerSelector({"_default": [b1, b2]},
                                         default_tier="_default"))
    seen = {router.run_json(TS_Q)[0]["broker"] for _ in range(4)}
    assert seen == {"a", "b"}
    assert len(b1.calls) == len(b2.calls) == 2


def test_avatica_affinity_pins_a_connection():
    """Every request of one Avatica connection lands on one broker, the
    same one in both packages."""
    picks = []
    for pkg in (ref_router, port_router):
        sel = pkg.TieredBrokerSelector(
            {"_default": [FakeBroker(f"b{i}") for i in range(3)]},
            default_tier="_default")
        picks.append([sel.pick({}, affinity_key=f"conn-{i}")[1].name
                      for i in range(8) for _ in range(2)])
    assert picks[1] == picks[0]
    assert all(picks[1][i] == picks[1][i + 1] for i in range(0, 16, 2))


# ---------------------------------------------------------------------------
# the router in front of a port broker
# ---------------------------------------------------------------------------

SQL, AVATICA = "/druid/v2/sql", "/druid/v2/sql/avatica/"


@pytest.fixture(scope="module")
def stack(segments):
    """The router's port: router -> QueryHttpServer(SqlExecutor(broker))
    -> tests/test_cluster.py's 3 data nodes, replica 2."""
    _, _, broker = _build(port_cluster, [_carry(s) for s in segments],
                          {"device": "cpu"}, {"device": "cpu"})
    srv = QueryHttpServer(QueryLifecycle(broker),
                          sql_executor=SqlExecutor(broker)).start()
    router = RouterHttpServer(TieredBrokerSelector(
        {"_default": [f"http://127.0.0.1:{srv.port}"]},
        default_tier="_default")).start()
    yield router.port
    router.stop()
    srv.stop()
    broker.stop()


def test_router_proxies_native(stack, segments):
    q = dict(TS_Q, granularity="day", aggregations=[
        {"type": "count", "name": "n"},
        {"type": "longSum", "name": "s", "fieldName": "metLong"}])
    status, rows, _ = _post(stack, q)
    assert status == 200 and rows == RefExecutor(segments).run_json(q)


@pytest.mark.parametrize("stmt,rules", [
    ("SELECT dimA, COUNT(*) n, SUM(metLong) s, MAX(metFloat) m FROM test "
     "GROUP BY dimA", ["exact"] * 4),
    ("SELECT dimB, SUM(metLong) s FROM test GROUP BY dimB ORDER BY s DESC "
     "LIMIT 5", ["exact"] * 2),
    ("SELECT FLOOR(__time TO DAY) d, COUNT(*) n, SUM(metFloat) f FROM test "
     "GROUP BY 1", ["exact", "exact", "sum"]),
])
def test_router_proxies_sql(stack, segments, stmt, rules):
    status, rows, _ = _post(stack, {"query": stmt, "resultFormat": "array"},
                            path=SQL)
    assert status == 200
    want = RefSql(RefExecutor(segments)).execute(stmt)[1]
    check_rows(want, rows, rules, stmt)


def test_router_proxies_avatica(stack, segments):
    _, r, _ = _post(stack, {"request": "openConnection"}, path=AVATICA)
    cid = r["connectionId"]
    _, r, _ = _post(stack, {"request": "prepareAndExecute",
                            "connectionId": cid, "statementId": 0,
                            "sql": "SELECT dimA, COUNT(*) n FROM test "
                                   "GROUP BY dimA", "maxRowCount": -1},
                    path=AVATICA)
    rows = r["results"][0]["firstFrame"]["rows"]
    want = RefSql(RefExecutor(segments)).execute(
        "SELECT dimA, COUNT(*) n FROM test GROUP BY dimA")[1]
    assert rows == want
    _, r, _ = _post(stack, {"request": "closeConnection",
                            "connectionId": cid}, path=AVATICA)
    assert r == {"response": "closeConnection"}


def test_router_paths(stack):
    """The control-plane paths wait with coordination (A18): without
    leader clients they answer 404, as the reference's do."""
    assert _post(stack, {}, path="/druid/coordinator/v1/leader")[0] == 404
    assert _post(stack, {}, path="/druid/indexer/v1/task")[0] == 404
    with urllib.request.urlopen(f"http://127.0.0.1:{stack}/status",
                                timeout=TIMEOUT) as r:
        assert json.loads(r.read()) == {"service": "router"}
    with pytest.raises(NotImplementedError, match="ROADMAP A18"):
        RouterHttpServer(TieredBrokerSelector({"_default": []}, "_default"),
                         leader_clients={"overlord": object()})


def test_sql_endpoint_authorizes_tables(segments):
    """tests/test_router_security.py:205: the SQL resource's per-table
    READ check (403 on an ungranted table, as the native path), with the
    credentials carried through the router."""
    chain = _chain()
    ex = QueryExecutor([_carry(s) for s in segments], device="cpu")
    srv = QueryHttpServer(
        QueryLifecycle(ex, authorizer=authorizer_for_query(chain)),
        sql_executor=SqlExecutor(ex), auth_chain=chain).start()
    router = RouterHttpServer(TieredBrokerSelector(
        {"_default": [f"http://127.0.0.1:{srv.port}"]},
        default_tier="_default")).start()
    try:
        alice = _basic("alice", "pw1")
        for port in (srv.port, router.port):
            status, rows, _ = _post(port, {"query": "SELECT COUNT(*) c "
                                                    "FROM test"}, alice, SQL)
            assert status == 200
            assert rows == [{"c": sum(s.n_rows for s in segments)}]
            status, _, _ = _post(port, {"query": "SELECT COUNT(*) FROM "
                                                 "test2"}, alice, SQL)
            assert status == 403
            assert _post(port, {"query": "SELECT COUNT(*) FROM test"},
                         path=SQL)[0] == 401
            status, rows, _ = _post(port, {
                "query": "SELECT TABLE_NAME FROM INFORMATION_SCHEMA.TABLES"},
                alice, SQL)
            assert status == 200 and rows == [{"TABLE_NAME": "test"}]
    finally:
        router.stop()
        srv.stop()
