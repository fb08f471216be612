"""The port's SQL layer (druid_tpu_torch/sql/: parser, planner, executor)
against the reference package's, on the CPU.

tests/conftest.py's `segments` (4 segments of 5,000 rows over four days,
seed 42) are carried into the port as plain arrays
(`tests/test_torch_slice._carry`); every statement runs through the
reference's SqlExecutor over its QueryExecutor and through the port's over
its own. Each case asserts that the two `explain()` dicts are equal and
that the rows are equal under one rule (`check_rows`):

  - integers, strings, NULLs, timestamps and min/max/first/last values
    bit for bit, with the same Python types (COUNT(*) is an `int`);
  - float sums (doubleSum/floatSum, and post-aggregators over them)
    within 1e-5 relative to the reference's value. The float columns of
    these data are non-negative, so that is within 1e-5 * sum|v| per
    group;
  - variance and stddev within 1e-9 relative, and the sketches' values
    equal, as tests/test_torch_ext.py holds the ext aggregators.

Errors must be of the reference's type (same class name, the port's own
module) with the same message. The cases mirror tests/test_sql.py case by
case, the parse trees of `parse_sql` field by field, and the SQL halves
of tests/test_cluster.py:229 (SQL over the broker), tests/test_aux.py:186
(/druid/v2/sql), tests/test_resilience.py:445 (the partial contract over
SQL) and tests/test_extensions.py:211 (the ext aggregators in SQL); plus
schema discovery over HTTP data nodes, by segmentMetadata.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import druid_tpu.ext  # noqa: F401  (the reference's ext aggregators)
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.sql import SqlExecutor as RefSql
from druid_tpu.sql import parse_sql as ref_parse

import druid_tpu_torch.ext  # noqa: F401  (the port's ext aggregators)
from druid_tpu_torch import cluster as port_cluster
from druid_tpu_torch.cluster import (Broker, DataNode, DataNodeServer,
                                     InventoryView, RemoteDataNodeClient,
                                     descriptor_for)
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.server import QueryHttpServer, QueryLifecycle
from druid_tpu_torch.sql import PlannerError, SqlExecutor, parse_sql
from druid_tpu_torch.sql import parser as port_parser
from tests.conftest import rows_as_frame
from tests.test_torch_cluster import _build
from tests.test_torch_ext import _state
from tests.test_torch_http import _DeadNode, _post, served  # noqa: F401
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

TIMEOUT = 30

#: aggregator types whose float values are sums (added in no fixed order)
FLOAT_SUMS = {"doubleSum", "floatSum"}
#: compared within 1e-9 relative, as tests/test_torch_ext.py
CLOSE_AGGS = {"variance"}
CLOSE_POSTS = {"stddev"}


# ---------------------------------------------------------------------------
# the shared comparison (imported by the other tests/test_torch_sql*.py)
# ---------------------------------------------------------------------------

def sql_pair(ref_segments, ref_runner=None, port_runner=None):
    """(reference SqlExecutor, port SqlExecutor) over the same segments."""
    ref = RefSql(ref_runner or RefExecutor(list(ref_segments)))
    port = SqlExecutor(port_runner or PortExecutor(
        [_carry(s) for s in ref_segments], device="cpu"))
    return ref, port


def _native_rules(native) -> dict:
    """native output name -> "sum" | "close" for the approximate ones."""
    rules = {}
    for a in native.aggregations:
        j = a.to_json()
        t = j["type"]
        if t == "filtered":
            t = j["aggregator"]["type"]
        if t in FLOAT_SUMS:
            rules[a.name] = "sum"
        elif t in CLOSE_AGGS:
            rules[a.name] = "close"
    for p in native.post_aggregations:
        rules[p.name] = "close" if p.to_json()["type"] in CLOSE_POSTS \
            else "sum"
    return rules


def column_rules(port_sql, stmt, params=()):
    """The rule of each output column: "exact", "sum" or "close" (the
    loosest over UNION ALL arms)."""
    parsed = parse_sql(stmt, params)
    arms = parsed.arms if isinstance(parsed, port_parser.Union) \
        else (parsed,)
    order = {"exact": 0, "sum": 1, "close": 2}
    out = []
    for arm in arms:
        planned = port_sql._plan(port_sql._stub_semijoins(arm, []))
        native = planned.native
        if native is None:
            rules = [("exact") for _ in planned.meta_select.items]
        else:
            kinds = (_native_rules(native)
                     if hasattr(native, "aggregations") else {})
            rules = [kinds.get(o.key, "exact") if o.kind == "value"
                     else "exact" for o in planned.outputs]
        out = rules if not out else [
            max(a, b, key=order.get) for a, b in zip(out, rules)]
    return out


def _same(want, got, rule, where):
    assert type(got) is type(want) or (
        _state(want) is not want and type(got).__name__ ==
        type(want).__name__), (where, type(want), type(got))
    if isinstance(want, float) and rule != "exact":
        rel = 1e-5 if rule == "sum" else 1e-9
        assert abs(got - want) <= rel * abs(want) or (
            math.isnan(want) and math.isnan(got)), (where, want, got)
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), (where, want, got)
    else:
        assert _state(got) == _state(want), (where, want, got)


def check_rows(want, got, rules, where=""):
    """`got` (the port's rows) equals `want` (the reference's) under the
    module's rule, order included."""
    assert len(got) == len(want), (where, len(want), len(got))
    for i, (w, g) in enumerate(zip(want, got)):
        assert len(g) == len(w), (where, i, w, g)
        for j, (wv, gv) in enumerate(zip(w, g)):
            _same(wv, gv, rules[j] if j < len(rules) else "exact",
                  (where, i, j))


def check(ref_sql, port_sql, stmt, params=(), context=None, explain=True):
    """Same plan, same columns, same rows; returns the port's (cols,
    rows)."""
    if explain:
        assert port_sql.explain(stmt, params) == \
            ref_sql.explain(stmt, params), stmt
    want_cols, want = ref_sql.execute(stmt, params, context)
    got_cols, got = port_sql.execute(stmt, params, context)
    assert got_cols == want_cols, stmt
    rules = (column_rules(port_sql, stmt, params)
             if not parse_sql(stmt, params).explain else [])
    check_rows(want, got, rules, stmt)
    return got_cols, got


def check_error(ref_call, port_call, match=None):
    """Both raise: the same class name, the port's module for the
    reference's, the same message."""
    with pytest.raises(Exception) as want:
        ref_call()
    with pytest.raises(Exception) as got:
        port_call()
    w, g = want.value, got.value
    assert type(g).__name__ == type(w).__name__, (w, g)
    assert type(g).__module__ == type(w).__module__.replace(
        "druid_tpu.", "druid_tpu_torch.", 1), (type(w), type(g))
    assert str(g) == str(w)
    if match is not None:
        assert match in str(g)
    return g


def tree(node):
    """A parse tree as plain data, field by field, class names included
    (the port's AST classes keep the reference's names)."""
    if dataclasses.is_dataclass(node):
        return (type(node).__name__,
                {f.name: tree(getattr(node, f.name))
                 for f in dataclasses.fields(node)})
    if isinstance(node, (tuple, list)):
        return [tree(x) for x in node]
    return node


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(segments):
    return sql_pair(segments)


@pytest.fixture(scope="module")
def frames(segments):
    return [rows_as_frame(s) for s in segments]


def _concat(frames, col):
    return np.concatenate([f[col] for f in frames])


# ---------------------------------------------------------------------------
# tests/test_sql.py, statement by statement
# ---------------------------------------------------------------------------

#: (id, statement, parameters): the reference's plan goldens and result
#: goldens
STATEMENTS = [
    ("plan_timeseries", "SELECT COUNT(*) FROM test", ()),
    ("plan_groupby", "SELECT dimA, COUNT(*) FROM test GROUP BY dimA", ()),
    ("plan_topn", "SELECT dimA, COUNT(*) c FROM test GROUP BY dimA "
     "ORDER BY c DESC LIMIT 5", ()),
    ("plan_scan", "SELECT __time, dimA FROM test LIMIT 3", ()),
    ("plan_time_boundary", "SELECT MAX(__time) FROM test", ()),
    ("plan_floor_day", "SELECT FLOOR(__time TO DAY), COUNT(*) FROM test "
     "GROUP BY 1", ()),
    ("plan_distinct", "SELECT DISTINCT dimA FROM test", ()),
    ("plan_order_by_dim", "SELECT dimA, COUNT(*) c FROM test GROUP BY dimA "
     "ORDER BY dimA LIMIT 5", ()),
    ("plan_having", "SELECT dimA, COUNT(*) c FROM test GROUP BY dimA "
     "HAVING COUNT(*) > 1 ORDER BY c DESC LIMIT 5", ()),
    ("filter_shape", "SELECT COUNT(*) FROM test WHERE dimA = 'x' "
     "AND metLong >= 5 AND dimB IN ('a','b')", ()),
    ("time_interval", "SELECT COUNT(*) FROM test WHERE __time >= "
     "TIMESTAMP '2026-01-01' AND __time < TIMESTAMP '2026-01-02'", ()),
    ("count_star", "SELECT COUNT(*) n FROM test", ()),
    ("filtered_sum", "SELECT SUM(metLong) s FROM test WHERE dimA = ?",
     ("v00000003",)),
    ("groupby_results", "SELECT dimA, COUNT(*) n, SUM(metLong) s FROM test "
     "GROUP BY dimA ORDER BY dimA", ()),
    ("topn", "SELECT dimB, SUM(metLong) s FROM test GROUP BY dimB "
     "ORDER BY s DESC LIMIT 7", ()),
    ("topn_as_groupby", "SELECT dimB, SUM(metLong) s FROM test GROUP BY dimB "
     "HAVING SUM(metLong) > -1 ORDER BY s DESC LIMIT 7", ()),
    ("avg_postagg", "SELECT AVG(metFloat) a FROM test", ()),
    ("time_floor_day", "SELECT FLOOR(__time TO DAY) d, COUNT(*) n "
     "FROM test GROUP BY 1 ORDER BY d", ()),
    ("having", "SELECT dimB, COUNT(*) n FROM test GROUP BY dimB "
     "HAVING COUNT(*) > 500 ORDER BY n DESC", ()),
    ("scan_filter_limit", "SELECT __time, dimA, metLong FROM test "
     "WHERE metLong > 90 ORDER BY __time LIMIT 10", ()),
    ("count_distinct", "SELECT COUNT(DISTINCT dimHi) u FROM test", ()),
    ("case_aggregate", "SELECT SUM(CASE WHEN metLong > 50 THEN 1 ELSE 0 END)"
     " hi FROM test", ()),
    ("filter_clause", "SELECT COUNT(*) FILTER (WHERE metLong > 50) hi, "
     "COUNT(*) n FROM test", ()),
    ("between", "SELECT COUNT(*) n FROM test WHERE metLong BETWEEN 10 "
     "AND 20", ()),
    ("arithmetic_over_aggs", "SELECT SUM(metLong) / COUNT(*) r FROM test",
     ()),
    ("substring_group", "SELECT SUBSTRING(dimA, 1, 6) p, COUNT(*) n "
     "FROM test GROUP BY 1 ORDER BY p", ()),
    ("min_max_time", "SELECT MIN(__time) mn, MAX(__time) mx FROM test", ()),
    ("information_schema_tables",
     "SELECT TABLE_NAME FROM INFORMATION_SCHEMA.TABLES", ()),
    ("information_schema_columns",
     "SELECT COLUMN_NAME, DATA_TYPE FROM INFORMATION_SCHEMA.COLUMNS "
     "WHERE TABLE_NAME = 'test' AND DATA_TYPE = 'VARCHAR'", ()),
    ("count_col_filter_clause", "SELECT COUNT(dimA) FILTER "
     "(WHERE metLong > 50) c FROM test", ()),
    ("timeseries_order_by_agg", "SELECT FLOOR(__time TO DAY) d, "
     "SUM(metLong) s FROM test GROUP BY 1 ORDER BY s DESC LIMIT 1", ()),
    ("time_between", "SELECT COUNT(*) n FROM test WHERE __time BETWEEN "
     "TIMESTAMP '2026-01-01' AND TIMESTAMP '2026-01-02'", ()),
    ("time_bound_under_or", "SELECT COUNT(*) n FROM test WHERE "
     "__time >= TIMESTAMP '2026-01-03' OR dimA = 'nope'", ()),
    ("contradictory_time_range", "SELECT COUNT(*) n FROM test WHERE "
     "__time >= TIMESTAMP '2026-02-01' AND __time < "
     "TIMESTAMP '2026-01-01'", ()),
    ("floor_unit_in_where", "SELECT COUNT(*) FROM test "
     "WHERE FLOOR(__time TO DAY) = TIMESTAMP '2026-01-01'", ()),
    ("explain_statement", "EXPLAIN PLAN FOR SELECT dimA, SUM(metLong) s "
     "FROM test GROUP BY dimA", ()),
    # the shapes chip_smoke's phase 19 sends (at this data's widths)
    ("headline_groupby", "SELECT dimA, dimB, COUNT(*) AS rows_, "
     "SUM(metLong) AS lsum, MAX(metFloat) AS fmax FROM test "
     "WHERE metLong BETWEEN 10 AND 90 GROUP BY dimA, dimB", ()),
    ("float_sums_by_group", "SELECT dimB, SUM(metFloat) f, SUM(metDouble) d, "
     "MIN(metFloat) mn FROM test GROUP BY dimB", ()),
    ("hourly_timeseries", "SELECT FLOOR(__time TO HOUR) h, COUNT(*) n, "
     "SUM(metLong) s, MIN(metLong) mn FROM test GROUP BY 1", ()),
    ("filtered_groupby", "SELECT dimA, dimB, COUNT(*) n, SUM(metLong) s "
     "FROM test WHERE dimA IN ('v00000001', 'v00000002', 'v00000003') "
     "AND dimB <> 'v00000000' AND metLong >= 20 GROUP BY dimA, dimB", ()),
]


@pytest.mark.parametrize("stmt,params", [s[1:] for s in STATEMENTS],
                         ids=[s[0] for s in STATEMENTS])
def test_statement_matches_reference(pair, stmt, params):
    check(*pair, stmt, params)


def test_results_match_numpy(pair, frames):
    """A few of tests/test_sql.py's numpy goldens on the port's rows."""
    _, port = pair
    a, m = _concat(frames, "dimA"), _concat(frames, "metLong")
    _, rows = port.execute("SELECT dimA, COUNT(*) n, SUM(metLong) s "
                           "FROM test GROUP BY dimA ORDER BY dimA")
    assert rows == [[v, int((a == v).sum()), int(m[a == v].sum())]
                    for v in sorted(set(a))]
    _, rows = port.execute("SELECT COUNT(*) n FROM test")
    assert rows == [[len(a)]] and type(rows[0][0]) is int
    _, rows = port.execute("SELECT COUNT(*) FILTER (WHERE metLong > 50) hi,"
                           " COUNT(*) n FROM test")
    assert rows == [[int((m > 50).sum()), len(m)]]


@pytest.mark.parametrize("stmt,match", [
    ("SELECT nosuchcol FROM test", None),
    ("SELECT * FROM nosuchtable", "unknown table"),
    ("SELECT dimA FROM test ORDER BY dimA", None),
    ("SELECT COUNT(*) FROM test WHERE FLOOR(__time TO MONTH) = "
     "TIMESTAMP '2026-01-01'", None),
    ("SELECT FROM x", None),
    ("SELECT a FROM t WHERE", None),
    ("SELECT a FROM t extra garbage ,", None),
])
def test_errors_match_reference(pair, stmt, match):
    ref, port = pair
    check_error(lambda: ref.execute(stmt), lambda: port.execute(stmt),
                match)


@pytest.mark.parametrize("stmt", ["SELECT FROM x", "SELECT a FROM t WHERE",
                                  "SELECT a FROM t extra garbage ,"])
def test_parse_errors(stmt):
    err = check_error(lambda: ref_parse(stmt), lambda: parse_sql(stmt))
    assert isinstance(err, port_parser.SqlParseError)


def test_planner_error_type(pair):
    _, port = pair
    with pytest.raises(PlannerError):
        port.execute("SELECT nosuchcol FROM test")


#: statements whose parse trees are compared field by field
PARSE_CASES = [s[1] for s in STATEMENTS] + [
    "SELECT CAST(l1 AS VARCHAR) c, EXTRACT(DOW FROM __time) d FROM foo",
    "SELECT TRIM(s), SUBSTRING(s, 2, 3), COALESCE(a, 0) FROM t",
    "SELECT a FROM t WHERE b NOT IN (SELECT b FROM u GROUP BY b) "
    "AND c NOT LIKE 'x%' AND d IS NOT NULL",
    "SELECT x FROM (SELECT a x, SUM(b) s FROM t GROUP BY 1) AS q "
    "WHERE s > 2.5e3",
    "SELECT a FROM t UNION ALL SELECT b FROM u ORDER BY 1 DESC LIMIT 3 "
    "OFFSET 1",
    "SELECT TIMESTAMPADD(DAY, 2, __time), INTERVAL '1' DAY, "
    "DATE '2026-01-01' FROM t",
    "SELECT * FROM INFORMATION_SCHEMA.COLUMNS",
]


@pytest.mark.parametrize("stmt", PARSE_CASES)
def test_parse_tree_matches_reference(stmt):
    params = ("v00000003",) if "?" in stmt else ()
    assert tree(parse_sql(stmt, params)) == tree(ref_parse(stmt, params))


# ---------------------------------------------------------------------------
# the SQL halves that waited for the SQL layer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_segments(segments):
    return [_carry(s) for s in segments]


def test_sql_over_broker(pair, segments, port_segments, frames):
    """tests/test_cluster.py:229: SQL over the broker, against the
    reference's SqlExecutor and numpy."""
    ref, _ = pair
    _, _, broker = _build(port_cluster, port_segments, {"device": "cpu"},
                          {"device": "cpu"})
    try:
        port = SqlExecutor(broker)
        stmt = ("SELECT dimA, SUM(metLong) s FROM test GROUP BY dimA "
                "ORDER BY s DESC")
        _, rows = check(ref, port, stmt)
        a, m = _concat(frames, "dimA"), _concat(frames, "metLong")
        want = sorted(((v, int(m[a == v].sum())) for v in set(a)),
                      key=lambda kv: -kv[1])
        assert [(r[0], r[1]) for r in rows] == want
        check(ref, port, "SELECT FLOOR(__time TO DAY) d, COUNT(*) n, "
                         "SUM(metDouble) s FROM test GROUP BY 1")
    finally:
        broker.stop()


SQL = "/druid/v2/sql"


def test_http_sql(segments, port_segments, served):
    """tests/test_aux.py:186 and :197: /druid/v2/sql in both result
    formats, with parameters and context, and a 400 on a parse error."""
    ex = PortExecutor(port_segments, device="cpu")
    srv = served(QueryHttpServer(QueryLifecycle(ex),
                                 sql_executor=SqlExecutor(ex)))
    n = sum(s.n_rows for s in segments)
    status, rows, _ = _post(srv.port, {"query": "SELECT COUNT(*) n "
                                       "FROM test"}, path=SQL)
    assert status == 200 and rows == [{"n": n}]
    status, rows, _ = _post(srv.port, {"query": "SELECT COUNT(*) FROM test",
                                       "resultFormat": "array"}, path=SQL)
    assert status == 200 and rows == [[n]]
    ref = RefSql(RefExecutor(segments))
    stmt = ("SELECT dimA, SUM(metLong) s, SUM(metFloat) f FROM test "
            "WHERE dimA <> ? GROUP BY dimA")
    status, rows, _ = _post(srv.port, {
        "query": stmt, "parameters": [{"type": "VARCHAR",
                                       "value": "v00000001"}],
        "resultFormat": "array", "context": {"queryId": "sql-http-1"}},
        path=SQL)
    assert status == 200
    want = ref.execute(stmt, [{"type": "VARCHAR", "value": "v00000001"}])[1]
    check_rows(want, rows, ["exact", "exact", "sum"], stmt)
    status, err, _ = _post(srv.port, {"query": "SELECT x FROM"}, path=SQL)
    assert status == 400 and "error" in err


def test_partial_contract_over_sql(segments, port_segments, served):
    """tests/test_resilience.py:445, its SQL half: the SQL payload's
    context reaches the native query, the missing-segments report reaches
    the X-Druid-Response-Context header, and the rows equal the
    reference's over the surviving segments; a strict statement answers
    500 without the header."""
    view = InventoryView()
    dead, live = _DeadNode("dead"), DataNode("live", device="cpu")
    view.register(dead)
    view.register(live)
    for i, s in enumerate(port_segments):
        node = dead if i % 2 == 0 else live
        node.load_segment(s)
        view.announce(node.name, descriptor_for(s))
    broker = Broker(view, device="cpu")
    srv = served(QueryHttpServer(QueryLifecycle(broker),
                                 sql_executor=SqlExecutor(broker)))
    lost = {str(s.id) for i, s in enumerate(port_segments) if i % 2 == 0}
    survivors = [s for i, s in enumerate(segments) if i % 2 == 1]
    try:
        stmt = "SELECT COUNT(*) AS c, SUM(metLong) AS s FROM test"
        status, rows, headers = _post(srv.port, {
            "query": stmt, "context": {"allowPartialResults": True}},
            path=SQL)
        assert status == 200
        rc = json.loads(headers["X-Druid-Response-Context"])
        assert rc["partial"] is True and set(rc["missingSegments"]) == lost
        want = RefSql(RefExecutor(survivors)).execute_dicts(stmt)
        assert rows == want
        port = SqlExecutor(broker)
        cols, shaped = port.execute(stmt, context={
            "allowPartialResults": True})
        assert set(shaped.missing_segments) == lost
        status, _, headers = _post(srv.port, {"query": stmt}, path=SQL)
        assert status == 500
        assert headers.get("X-Druid-Response-Context") is None
    finally:
        broker.stop()


def test_extension_sql(segment):
    """tests/test_extensions.py:211: VARIANCE/STDDEV, APPROX_QUANTILE
    (one sketch for both fractions) and DS_THETA, against the reference
    and numpy; the planner's lazy ext imports build the port's
    aggregators."""
    ref, port = sql_pair([segment])
    stmt = ("SELECT STDDEV(metFloat) sd, STDDEV_POP(metFloat) sdp, "
            "VARIANCE(metFloat) v, APPROX_QUANTILE(metFloat, 0.5) med, "
            "APPROX_QUANTILE(metFloat, 0.9) p90, DS_THETA(dimHi) u FROM test")
    _, rows = check(ref, port, stmt)
    frame = rows_as_frame(segment)
    x = frame["metFloat"].astype(np.float64)
    sd, sdp, v, med, p90, u = rows[0]
    assert sd == pytest.approx(x.std(ddof=1), rel=1e-6)
    assert sdp == pytest.approx(x.std(), rel=1e-6)
    assert v == pytest.approx(x.var(ddof=1), rel=1e-6)
    assert med == pytest.approx(np.quantile(x, 0.5), rel=0.05)
    assert p90 == pytest.approx(np.quantile(x, 0.9), rel=0.05)
    assert u == pytest.approx(len(set(frame["dimHi"])), rel=0.06)
    stmt = ("SELECT APPROX_QUANTILE(metFloat, 0.5), "
            "APPROX_QUANTILE(metFloat, 0.9) FROM test")
    plan = port.explain(stmt)
    assert len(plan["aggregations"]) == 1 and plan == ref.explain(stmt)
    planned = port._plan(parse_sql("SELECT VARIANCE(metFloat) v, "
                                   "DS_THETA(dimHi) u FROM test"))
    assert {type(a).__module__ for a in planned.native.aggregations} == {
        "druid_tpu_torch.ext.stats", "druid_tpu_torch.ext.sketches"}
    check(ref, port, "SELECT dimA, VARIANCE(metLong) v, DS_THETA(dimB) u "
                     "FROM test GROUP BY dimA")


def test_schema_discovery_over_http_nodes(segments, port_segments, pair):
    """A broker over RemoteDataNodeClients holds no segment objects: the
    executor discovers the schema by one merged segmentMetadata query per
    datasource and caches it; the schema equals the local one."""
    servers, view = [], InventoryView()
    try:
        for i in range(2):
            node = DataNode(f"http{i}", device="cpu")
            for s in port_segments[i::2]:
                node.load_segment(s)
            srv = DataNodeServer(node).start()
            servers.append(srv)
            client = RemoteDataNodeClient(node.name, srv.url)
            view.register(client)
            for d in client.served_descriptors():
                view.announce(node.name, d)
        broker = Broker(view, device="cpu")
        try:
            remote = SqlExecutor(broker)
            assert broker.segments_of("test") == []
            local = SqlExecutor(PortExecutor(port_segments, device="cpu"))
            assert remote.schema().tables == local.schema().tables
            assert remote.schema() is remote.schema()     # cached
            ref, _ = pair
            assert local.schema().tables == ref.schema().tables
            check(ref, remote, "SELECT dimB, COUNT(*) n, MAX(metFloat) m "
                               "FROM test GROUP BY dimB ORDER BY n DESC "
                               "LIMIT 5")
        finally:
            broker.stop()
    finally:
        for srv in servers:
            srv.stop()
