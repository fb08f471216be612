"""tests/test_sql_union_semijoin.py on the port: UNION ALL chains and
IN (SELECT ...) semi-joins, through the reference's SqlExecutor and the
port's over tests/conftest.py's `segments` (carried as plain arrays). Each
case asserts that the two `explain()` dicts are equal (EXPLAIN lists a
union's arms and a semi-join's sub-plans) and the rows are equal under
tests/test_torch_sql.py's rule (integers and min/max bit for bit; float
sums within 1e-5 relative to the reference's, on non-negative columns
within 1e-5 * sum|v| per group); errors are of the reference's type with
its message.
"""
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)

from druid_tpu_torch.server.http import QueryHttpServer
from druid_tpu_torch.server.security import (READ, AuthChain,
                                             AuthenticationResult,
                                             Permission,
                                             RoleBasedAuthorizer)
from druid_tpu_torch.sql import PlannerError, SqlExecutor
from tests.conftest import rows_as_frame
from tests.test_torch_sql import check, check_error, sql_pair

torch.set_num_threads(1)

TOP2 = ("(SELECT dimA FROM test GROUP BY dimA ORDER BY SUM(metLong) DESC "
        "LIMIT 2)")


@pytest.fixture(scope="module")
def pair(segments):
    return sql_pair(segments)


STATEMENTS = {
    "union_all_concatenates":
        "SELECT dimA, COUNT(*) n FROM test GROUP BY dimA UNION ALL "
        "SELECT dimB, COUNT(*) n FROM test GROUP BY dimB",
    "union_order_and_limit":
        "SELECT dimA v, SUM(metLong) s FROM test GROUP BY dimA UNION ALL "
        "SELECT dimB v, SUM(metLong) s FROM test GROUP BY dimB "
        "ORDER BY s DESC LIMIT 5",
    "union_order_by_ordinal":
        "SELECT dimA FROM test GROUP BY dimA UNION ALL SELECT dimB FROM test "
        "GROUP BY dimB ORDER BY 1",
    "union_order_by_ordinal_offset":
        "SELECT dimA FROM test GROUP BY dimA UNION ALL SELECT dimB FROM test "
        "GROUP BY dimB ORDER BY 1 LIMIT 3 OFFSET 2",
    "union_three_arms_scalar":
        "SELECT COUNT(*) FROM test UNION ALL SELECT COUNT(*) FROM test "
        "UNION ALL SELECT COUNT(*) FROM test",
    "union_float_sums":
        "SELECT dimA v, SUM(metFloat) s FROM test GROUP BY dimA UNION ALL "
        "SELECT dimB v, SUM(metDouble) s FROM test GROUP BY dimB",
    "in_subquery_filters_outer":
        f"SELECT dimA, COUNT(*) n FROM test WHERE dimA IN {TOP2} "
        "GROUP BY dimA ORDER BY dimA",
    "not_in_subquery":
        f"SELECT COUNT(DISTINCT dimA) FROM test WHERE dimA NOT IN {TOP2}",
    "in_subquery_with_other_predicates":
        f"SELECT COUNT(*) FROM test WHERE metLong > 3 AND dimA IN {TOP2}",
    "empty_in_subquery":
        "SELECT COUNT(*) FROM test WHERE dimA IN (SELECT dimA FROM test "
        "WHERE dimA = 'no_such_value' GROUP BY dimA)",
    "zero_row_pruned":
        "SELECT COUNT(*) c, SUM(metLong) s, MAX(metFloat) mx, "
        "APPROX_COUNT_DISTINCT(dimA) u FROM test "
        "WHERE __time >= TIMESTAMP '3000-01-01'",
    "zero_row_no_match":
        "SELECT COUNT(*) c, SUM(metLong) s, MAX(metFloat) mx, "
        "APPROX_COUNT_DISTINCT(dimA) u FROM test WHERE dimA = 'no_such_value'",
}


@pytest.mark.parametrize("stmt", list(STATEMENTS.values()),
                         ids=list(STATEMENTS))
def test_statement_matches_reference(pair, stmt):
    check(*pair, stmt)


def test_results_match_numpy(pair, segments):
    """A few of the reference suite's numpy goldens on the port's rows."""
    _, port = pair
    frames = [rows_as_frame(s) for s in segments]
    total = sum(len(f["dimA"]) for f in frames)
    cols, rows = port.execute(STATEMENTS["union_all_concatenates"])
    assert cols == ["dimA", "n"] and sum(r[1] for r in rows) == 2 * total
    _, rows = port.execute(STATEMENTS["union_three_arms_scalar"])
    assert rows == [[total]] * 3
    _, rows = port.execute(STATEMENTS["zero_row_pruned"])
    assert rows == port.execute(STATEMENTS["zero_row_no_match"])[1]
    _, page = port.execute(STATEMENTS["union_order_by_ordinal_offset"])
    assert page == port.execute(STATEMENTS["union_order_by_ordinal"])[1][2:5]


@pytest.mark.parametrize("stmt,match", [
    ("SELECT dimA, COUNT(*) FROM test GROUP BY dimA UNION ALL "
     "SELECT dimB FROM test GROUP BY dimB", "same number of columns"),
    ("SELECT dimA FROM test GROUP BY dimA ORDER BY dimA UNION ALL "
     "SELECT dimB FROM test GROUP BY dimB", "UNION"),
    ("SELECT COUNT(*) FROM test WHERE dimA IN "
     "(SELECT dimA, dimB FROM test GROUP BY dimA, dimB)",
     "exactly one column"),
    ("SELECT dimA, COUNT(*) FROM test GROUP BY dimA "
     "HAVING COUNT(*) IN (SELECT metLong FROM test LIMIT 1)",
     "only supported in WHERE"),
])
def test_errors_match_reference(pair, stmt, match):
    ref, port = pair
    check_error(lambda: ref.execute(stmt), lambda: port.execute(stmt), match)


def test_not_in_subquery_with_null_matches_nothing(pair, monkeypatch):
    """Three-valued logic: a NULL in the materialized inner result empties
    `x NOT IN (...)`."""
    _, port = pair
    real = SqlExecutor._execute_select

    def fake(self, sel, depth, context=None):
        names, rows = real(self, sel, depth, context)
        return names, (rows + [[None]] if depth > 0 else rows)

    monkeypatch.setattr(SqlExecutor, "_execute_select", fake)
    _, rows = port.execute(
        f"SELECT COUNT(*) FROM test WHERE dimA NOT IN {TOP2}")
    assert rows == [[0]]


@pytest.mark.parametrize("stmt", [
    "SELECT COUNT(*) FROM test WHERE dimA IN (SELECT dimA FROM test "
    "GROUP BY dimA)",
    "SELECT dimA, COUNT(*) FROM test GROUP BY dimA HAVING COUNT(*) IN "
    "(SELECT metLong FROM test LIMIT 1)"])
def test_semijoin_never_executes_early(pair, monkeypatch, stmt):
    """EXPLAIN is plan-only, and an IN-subquery outside WHERE is refused
    before its inner query runs."""
    ref, port = pair

    def boom(self, sub, depth):
        raise AssertionError("a subquery was executed")

    monkeypatch.setattr(SqlExecutor, "_materialize_semijoin", boom)
    if "HAVING" in stmt:
        with pytest.raises(PlannerError, match="only supported in WHERE"):
            port.execute(stmt)
        return
    plan = port.explain(stmt)
    assert plan == ref.explain(stmt)
    assert plan["queryType"] == "timeseries"
    assert [p["queryType"] for p in plan["semiJoinSubPlans"]] == ["groupBy"]


@pytest.mark.parametrize("stmt,tables", [
    ("SELECT COUNT(*) FROM test WHERE dimA IN (SELECT dimA FROM test "
     "GROUP BY dimA)", (["test"], False)),
    ("SELECT dimA FROM test UNION ALL SELECT TABLE_NAME FROM "
     "INFORMATION_SCHEMA.TABLES", (["test"], True)),
    ("SELECT TABLE_NAME FROM INFORMATION_SCHEMA.TABLES", ([], True)),
])
def test_tables_of_matches_reference(pair, stmt, tables):
    ref, port = pair
    assert port.tables_of(stmt) == ref.tables_of(stmt) == tables


def test_mixed_meta_statement_still_authorizes_real_tables(pair):
    """INFORMATION_SCHEMA alone needs no grant; a statement that mixes it
    with a real table still needs the table's READ."""
    _, port = pair
    server = QueryHttpServer.__new__(QueryHttpServer)
    server.sql_executor = port
    server.auth_chain = AuthChain(authorizers={"rbac": RoleBasedAuthorizer(
        {"meta_only": [Permission("INFORMATION_SCHEMA", actions=(READ,))]},
        {"bob": ["meta_only"]})})
    bob = AuthenticationResult("bob", "rbac")
    assert server._authorize_sql(
        bob, "SELECT TABLE_NAME FROM INFORMATION_SCHEMA.TABLES")
    assert not server._authorize_sql(
        bob, "SELECT dimA FROM test UNION ALL "
             "SELECT TABLE_NAME FROM INFORMATION_SCHEMA.TABLES")
    assert not server._authorize_sql(
        bob, "SELECT COUNT(*) FROM test WHERE dimA IN "
             "(SELECT TABLE_NAME FROM INFORMATION_SCHEMA.TABLES)")
