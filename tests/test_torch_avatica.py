"""tests/test_avatica.py on the port: the Avatica JSON-RPC statement
lifecycle at POST /druid/v2/sql/avatica of the port's QueryHttpServer
(druid_tpu_torch/server/avatica.py), over real sockets on 127.0.0.1. The
same requests go to the reference's server over the same segments
(tests/conftest.py's `segments`, carried as plain arrays), and every reply
must equal the reference's, but for the connection ids (random uuids):
signatures, frames and the rows in them (counts and long sums bit for bit;
these statements hold no float sum). Per-identity connections and the
per-table READ check run on the port alone.
"""
import json
import urllib.request

import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.server.http import QueryHttpServer as RefHttpServer
from druid_tpu.server.lifecycle import QueryLifecycle as RefLifecycle
from druid_tpu.sql import SqlExecutor as RefSql

from druid_tpu_torch.engine import QueryExecutor
from druid_tpu_torch.server import (AuthChain, BasicHTTPAuthenticator,
                                    Permission, QueryHttpServer,
                                    QueryLifecycle, RoleBasedAuthorizer,
                                    authorizer_for_query)
from druid_tpu_torch.server.security import READ
from druid_tpu_torch.sql import SqlExecutor
from tests.test_torch_http import _basic
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

PATH = "/druid/v2/sql/avatica/"


@pytest.fixture(scope="module")
def port_segments(segments):
    return [_carry(s) for s in segments]


@pytest.fixture()
def urls(segments, port_segments):
    """(reference URL, port URL) of two servers over the same data."""
    rex = RefExecutor(segments)
    ref = RefHttpServer(RefLifecycle(rex), sql_executor=RefSql(rex)).start()
    pex = QueryExecutor(port_segments, device="cpu")
    port = QueryHttpServer(QueryLifecycle(pex),
                           sql_executor=SqlExecutor(pex)).start()
    yield (f"http://127.0.0.1:{ref.port}{PATH}",
           f"http://127.0.0.1:{port.port}{PATH}")
    port.stop()
    ref.stop()


def _rpc(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


def _strip(reply, cid):
    """A reply without its connection id, also where a message names it."""
    if isinstance(reply, dict):
        return {k: _strip(v, cid) for k, v in reply.items()
                if k != "connectionId"}
    if isinstance(reply, list):
        return [_strip(v, cid) for v in reply]
    if isinstance(reply, str) and cid:
        return reply.replace(cid, "<connection>")
    return reply


def _both(urls, cids, payload):
    """Send `payload` to both servers (each with its own connection id
    where the payload names one); the replies must agree."""
    replies = []
    for url, cid in zip(urls, cids):
        p = dict(payload)
        if "connectionId" in p:
            p["connectionId"] = cid
        if "statementHandle" in p:
            p["statementHandle"] = dict(p["statementHandle"],
                                        connectionId=cid)
        replies.append(_rpc(url, p))
    assert _strip(replies[1], cids[1]) == _strip(replies[0], cids[0]), \
        payload
    return replies[1]


def _open(urls):
    return [_rpc(u, {"request": "openConnection"})["connectionId"]
            for u in urls]


def test_avatica_statement_lifecycle(urls, segments):
    cids = _open(urls)
    sid = _both(urls, cids, {"request": "createStatement",
                             "connectionId": ""})["statementId"]
    r = _both(urls, cids, {
        "request": "prepareAndExecute", "connectionId": "",
        "statementId": sid, "maxRowCount": -1,
        "sql": "SELECT COUNT(*) c, SUM(metLong) s FROM test"})
    rs = r["results"][0]
    assert r["response"] == "executeResults" and rs["firstFrame"]["done"]
    assert [c["columnName"] for c in rs["signature"]["columns"]] == ["c", "s"]
    assert rs["signature"]["columns"][0]["type"]["name"] == "BIGINT"
    assert rs["firstFrame"]["rows"][0][0] == sum(s.n_rows for s in segments)
    _both(urls, cids, {"request": "closeStatement", "connectionId": "",
                       "statementId": sid})
    _both(urls, cids, {"request": "closeConnection", "connectionId": ""})
    r = _both(urls, cids, {"request": "createStatement", "connectionId": ""})
    assert r["response"] == "error"


def test_avatica_prepare_execute_with_params(urls):
    cids = _open(urls)
    handle = _both(urls, cids, {
        "request": "prepare", "connectionId": "",
        "sql": "SELECT dimA, COUNT(*) c, SUM(metLong) s FROM test "
               "WHERE dimA = ? GROUP BY dimA"})["statement"]
    r = _both(urls, cids, {
        "request": "execute", "maxRowCount": -1,
        "statementHandle": {"connectionId": "", "id": handle["id"]},
        "parameterValues": [{"type": "STRING", "value": "v00000001"}]})
    rows = r["results"][0]["firstFrame"]["rows"]
    assert len(rows) == 1 and rows[0][0] == "v00000001"


def test_avatica_fetch_pagination(urls):
    cids = _open(urls)
    sid = _both(urls, cids, {"request": "createStatement",
                             "connectionId": ""})["statementId"]
    r = _both(urls, cids, {"request": "prepareAndExecute",
                           "connectionId": "", "statementId": sid,
                           "sql": "SELECT DISTINCT dimB FROM test",
                           "maxRowCount": -1})
    total = len(r["results"][0]["firstFrame"]["rows"])
    assert total > 10
    f = _both(urls, cids, {"request": "fetch", "connectionId": "",
                           "statementId": sid, "offset": 5,
                           "fetchMaxRowCount": 7})
    assert len(f["frame"]["rows"]) == 7 and not f["frame"]["done"]
    f = _both(urls, cids, {"request": "fetch", "connectionId": "",
                           "statementId": sid, "offset": total - 2,
                           "fetchMaxRowCount": 100})
    assert len(f["frame"]["rows"]) == 2 and f["frame"]["done"]


def test_avatica_errors_are_protocol_errors(urls):
    cids = _open(urls)
    r = _both(urls, cids, {"request": "prepareAndExecute",
                           "connectionId": "", "statementId": 0,
                           "sql": "SELECT FROM nope"})
    assert r["response"] == "error" and r["errorMessage"]
    assert _both(urls, cids, {"request": "teleport"})["response"] == "error"
    r = _both(urls, cids, {"request": "databaseProperty"})
    assert r["response"] == "databaseProperty"


@pytest.fixture()
def secured(port_segments):
    chain = AuthChain(
        authenticators=[BasicHTTPAuthenticator(
            {"alice": "pw", "bob": "pw2"}, authorizer_name="rbac")],
        authorizers={"rbac": RoleBasedAuthorizer(
            {"r": [Permission("test", actions=(READ,))]},
            {"alice": ["r"]})})
    ex = QueryExecutor(port_segments, device="cpu")
    srv = QueryHttpServer(
        QueryLifecycle(ex, authorizer=authorizer_for_query(chain)),
        sql_executor=SqlExecutor(ex), auth_chain=chain).start()
    yield f"http://127.0.0.1:{srv.port}{PATH}"
    srv.stop()


def test_avatica_respects_authorization(secured):
    alice = _basic("alice", "pw")
    cid = _rpc(secured, {"request": "openConnection"}, alice)["connectionId"]
    sid = _rpc(secured, {"request": "createStatement", "connectionId": cid},
               alice)["statementId"]
    ok = _rpc(secured, {"request": "prepareAndExecute", "connectionId": cid,
                        "statementId": sid,
                        "sql": "SELECT COUNT(*) FROM test"}, alice)
    assert ok["response"] == "executeResults"
    denied = _rpc(secured, {"request": "prepareAndExecute",
                            "connectionId": cid, "statementId": sid,
                            "sql": "SELECT COUNT(*) FROM secret"}, alice)
    assert denied["response"] == "error"


def test_avatica_connection_bound_to_identity(secured):
    """bob cannot fetch alice's buffered rows with her connection id."""
    alice, bob = _basic("alice", "pw"), _basic("bob", "pw2")
    cid = _rpc(secured, {"request": "openConnection"}, alice)["connectionId"]
    sid = _rpc(secured, {"request": "createStatement", "connectionId": cid},
               alice)["statementId"]
    ok = _rpc(secured, {"request": "prepareAndExecute", "connectionId": cid,
                        "statementId": sid,
                        "sql": "SELECT COUNT(*) FROM test"}, alice)
    assert ok["response"] == "executeResults"
    stolen = _rpc(secured, {"request": "fetch", "connectionId": cid,
                            "statementId": sid, "offset": 0}, bob)
    assert stolen["response"] == "error"
    reopen = _rpc(secured, {"request": "openConnection",
                            "connectionId": cid}, bob)
    assert reopen["response"] == "error"
