"""tests/test_sql_nested.py on the port: FROM (SELECT ...) subqueries,
planned onto the native `query` dataSource, through the reference's
SqlExecutor and the port's over tests/conftest.py's `segments` (carried as
plain arrays). Each case asserts that the two `explain()` dicts are equal
and the rows are equal under tests/test_torch_sql.py's rule (integers and
min/max bit for bit; float sums and the post-aggregators over them within
1e-5 relative to the reference's, on non-negative columns within
1e-5 * sum|v| per group); errors are of the reference's type with its
message.
"""
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)

from druid_tpu_torch.server.security import (READ, AllowAllAuthorizer,
                                             AuthChain,
                                             AuthenticationResult,
                                             Permission,
                                             RoleBasedAuthorizer,
                                             authorizer_for_query)
from druid_tpu_torch.sql import parse_sql
from tests.conftest import rows_as_frame
from tests.test_torch_sql import check, check_error, sql_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair(segments):
    return sql_pair(segments)


STATEMENTS = {
    "avg_of_grouped_sums":
        "SELECT AVG(s) a, COUNT(*) n FROM "
        "(SELECT dimA, SUM(metLong) s FROM test GROUP BY dimA)",
    "regroup_inner_dims":
        "SELECT p, COUNT(*) n, SUM(total) t FROM "
        "(SELECT SUBSTRING(dimB, 1, 3) p2, dimA p, SUM(metLong) total "
        " FROM test GROUP BY 1, 2) GROUP BY p ORDER BY p",
    "filter_on_inner_aggregate":
        "SELECT COUNT(*) FROM (SELECT dimB, COUNT(*) c FROM test "
        "GROUP BY dimB) WHERE c > 100",
    "explain_shows_query_datasource":
        "SELECT AVG(s) FROM (SELECT dimA, SUM(metLong) s FROM test "
        "GROUP BY dimA)",
    "alias_and_deeper_nesting":
        "SELECT MAX(a) FROM (SELECT p, AVG(s) a FROM "
        " (SELECT dimA p, dimB, SUM(metLong) s FROM test GROUP BY 1, 2) t1 "
        " GROUP BY p) AS t2",
    "numeric_expression_dim":
        "SELECT SUM(e) FROM (SELECT MOD(metLong, 10) e, dimA FROM test "
        "GROUP BY 1, 2)",
    "float_sums_nested":
        "SELECT dimA, SUM(f) sf, MAX(f) mf FROM (SELECT dimA, dimB, "
        "SUM(metFloat) f FROM test GROUP BY 1, 2) GROUP BY dimA",
}


@pytest.mark.parametrize("stmt", list(STATEMENTS.values()),
                         ids=list(STATEMENTS))
def test_nested_matches_reference(pair, stmt):
    check(*pair, stmt)


def test_nested_results_match_numpy(pair, segments):
    """tests/test_sql_nested.py:test_avg_of_grouped_sums's numpy golden on
    the port's rows, and the plan's query dataSource."""
    _, port = pair
    sums = {}
    for f in map(rows_as_frame, segments):
        for d, v in zip(f["dimA"], f["metLong"]):
            sums[d] = sums.get(d, 0) + int(v)
    _, rows = port.execute(STATEMENTS["avg_of_grouped_sums"])
    assert rows[0][1] == len(sums)
    assert rows[0][0] == pytest.approx(sum(sums.values()) / len(sums),
                                       rel=1e-9)
    plan = port.explain(STATEMENTS["explain_shows_query_datasource"])
    assert plan["dataSource"]["type"] == "query"
    assert plan["dataSource"]["query"]["queryType"] == "groupBy"


@pytest.mark.parametrize("stmt,match", [
    ("SELECT COUNT(*) FROM (SELECT __time, dimA FROM test LIMIT 5)", None),
    ("SELECT SUM(a) sa, SUM(b) sb FROM (SELECT dimA, SUM(metLong) a, "
     "SUM(metLong) b FROM test GROUP BY dimA)", "two aliases"),
])
def test_nested_errors_match_reference(pair, stmt, match):
    ref, port = pair
    check_error(lambda: ref.execute(stmt), lambda: port.execute(stmt), match)


def test_nested_authorization_uses_real_tables(pair):
    """The outer plan's resource is the inner query's real table."""
    _, port = pair
    stmt = ("SELECT SUM(s) FROM (SELECT dimA, SUM(metLong) s FROM test "
            "GROUP BY dimA)")
    assert port.tables_of(stmt) == (["test"], False)
    chain = AuthChain(authorizers={
        "rbac": RoleBasedAuthorizer(
            {"r": [Permission("test", actions=(READ,))]}, {"alice": ["r"]}),
        "allowAll": AllowAllAuthorizer()})
    check_fn = authorizer_for_query(chain)
    plan = port._plan(parse_sql(stmt))
    assert check_fn(AuthenticationResult("alice", "rbac"), plan.native)
    assert not check_fn(AuthenticationResult("bob", "rbac"), plan.native)
