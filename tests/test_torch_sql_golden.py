"""tests/test_sql_golden.py on the port: the same SQL over the same
literal six-row dataset `foo`, through the reference's SqlExecutor and the
port's, with the two `explain()` dicts equal and the rows equal under
tests/test_torch_sql.py's rule (integers, strings and min/max bit for bit;
float sums within 1e-5 relative to the reference's, which on these
non-negative columns is within 1e-5 * sum|v| per group). Each case also
holds the port's rows against the reference suite's hand-computed rows,
with that suite's tolerance (1e-5 relative, 1e-6 absolute).
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.segment import SegmentBuilder, ValueType

from tests.test_sql_golden import CASES, DAY, IV, ROWS, T0
from tests.test_torch_sql import check, check_error, sql_pair

torch.set_num_threads(1)


def _foo(name="foo", dims=None, metrics=None, n=6):
    b = SegmentBuilder(name, IV)
    b.add_columns(
        np.asarray([T0 + i * DAY for i in range(n)], dtype=np.int64),
        dims if dims is not None else
        {"dim1": [r[0] for r in ROWS], "dim2": [r[1] for r in ROWS]},
        metrics if metrics is not None else
        {"l1": np.asarray([r[2] for r in ROWS], dtype=np.int64),
         "f1": np.asarray([r[3] for r in ROWS], dtype=np.float32),
         "d1": np.asarray([r[4] for r in ROWS], dtype=np.float64)},
        metric_types=None if metrics is not None else
        {"l1": ValueType.LONG, "f1": ValueType.FLOAT, "d1": ValueType.DOUBLE})
    return b.build()


@pytest.fixture(scope="module")
def pair():
    return sql_pair([_foo()])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sql_golden(pair, case):
    name, stmt, expected, ordered = case[0], case[1], case[2], case[3]
    params = case[4] if len(case) > 4 else ()
    _, rows = check(*pair, stmt, params)

    def norm(row):
        return tuple(round(v, 6) if isinstance(v, float) else v for v in row)

    got = [norm(r) for r in rows]
    want = [norm(r) for r in expected]
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want), (name, got)
    for g, w in zip(got, want):
        for gv, wv in zip(g, w):
            if isinstance(wv, float):
                assert gv == pytest.approx(wv, rel=1e-5, abs=1e-6), (name, g)
            else:
                assert gv == wv, (name, g, w)


#: the reference suite's single-purpose tests, statement by statement
STATEMENTS = [
    # test_approx_quantile_bounded
    "SELECT APPROX_QUANTILE(f1, 0.1), APPROX_QUANTILE(f1, 0.9) FROM foo",
    # test_explain_returns_plan, test_information_schema_tables
    "EXPLAIN PLAN FOR SELECT COUNT(*) FROM foo",
    "SELECT TABLE_NAME FROM INFORMATION_SCHEMA.TABLES",
    # test_string_fn_filters
    "SELECT COUNT(*) FROM foo WHERE UPPER(dim1) = 'A'",
    "SELECT COUNT(*) FROM foo WHERE LOWER(dim2) = 'x'",
    "SELECT COUNT(*) FROM foo WHERE SUBSTRING(dim1, 1, 1) = 'b'",
    "SELECT COUNT(*) FROM foo WHERE CHAR_LENGTH(dim1) >= 1",
    "SELECT COUNT(*) FROM foo WHERE CHAR_LENGTH(dim1) > 1",
    "SELECT COUNT(*) FROM foo WHERE REGEXP_EXTRACT(dim1, '(a|c)', 1) = 'c'",
    "SELECT COUNT(*) FROM foo WHERE UPPER(SUBSTRING(dim1, 1, 1)) LIKE 'A%'",
    "SELECT COUNT(*) FROM foo WHERE LEFT(dim1, 1) = 'c'",
    "SELECT COUNT(*) FROM foo WHERE RIGHT(dim2, 1) = 'y'",
    "SELECT COUNT(*) FROM foo WHERE TRIM(dim1) = 'a'",
    "SELECT COUNT(*) FROM foo WHERE UPPER(dim1) <> 'A'",
    "SELECT COUNT(*) FROM foo WHERE UPPER(dim1) IN ('A', 'C')",
    # test_string_fn_group_by
    "SELECT UPPER(dim1) u, COUNT(*) n, SUM(l1) s FROM foo "
    "GROUP BY UPPER(dim1) ORDER BY u",
    # test_extended_math_functions
    "SELECT MAX(ROUND(DEGREES(PI()), 3)) FROM foo",
    "SELECT MAX(ROUND(RADIANS(180) / PI(), 3)) FROM foo",
    "SELECT MAX(ROUND(ATAN2(1, 1) * 4 / PI(), 3)) FROM foo",
    "SELECT MAX(ROUND(ASIN(1) * 2 / PI(), 3)) FROM foo",
    "SELECT MAX(ROUND(ACOS(0) * 2 / PI(), 3)) FROM foo",
    "SELECT MAX(ROUND(COT(ATAN(l1 * 0 + 1)), 3)) FROM foo",
    "SELECT SUM(ROUND(ATAN(l1 - l1), 3)) FROM foo",
    # test_varchar_cast_keeps_column_identity
    "SELECT COUNT(*) FROM foo WHERE CAST(l1 AS VARCHAR) = '7'",
    "SELECT COUNT(*) FROM foo WHERE CAST(l1 AS VARCHAR) IN ('3', '9', '10')",
    "SELECT COUNT(*) FROM foo WHERE CAST(dim1 AS VARCHAR) LIKE 'a%'",
    "SELECT COUNT(*) FROM foo WHERE CAST(dim1 AS VARCHAR) = 'b'",
    # test_timestampadd_timestampdiff
    "SELECT MAX(TIMESTAMPDIFF(DAY, TIMESTAMP '2026-02-01', __time)) FROM foo",
    "SELECT COUNT(*) FROM foo WHERE "
    "TIMESTAMPDIFF(HOUR, TIMESTAMP '2026-02-01', __time) >= 48",
    "SELECT COUNT(*) FROM foo WHERE "
    "TIMESTAMPADD(DAY, 2, __time) > TIMESTAMP '2026-02-06'",
    "SELECT COUNT(*) FROM foo WHERE "
    "TIMESTAMPADD(DAY, 2, __time) >= TIMESTAMP '2026-02-06'",
    # test_varchar_cast_unwrap_is_semantics_safe
    "SELECT COUNT(*) FROM foo WHERE CAST(l1 AS VARCHAR) = '07'",
    "SELECT COUNT(*) FROM foo WHERE CAST(l1 AS VARCHAR) = '7a'",
    "SELECT COUNT(*) FROM foo WHERE CAST(l1 AS VARCHAR) IN ('07', '3')",
    # test_varchar_cast_canonicality_is_type_aware
    "SELECT COUNT(*) FROM foo WHERE CAST(d1 AS VARCHAR) = '0'",
    "SELECT COUNT(*) FROM foo WHERE CAST(d1 AS VARCHAR) = '0.0'",
    "SELECT COUNT(*) FROM foo WHERE CAST(d1 AS VARCHAR) = '1.7'",
    "SELECT COUNT(*) FROM foo WHERE CAST(l1 AS VARCHAR) = '7.0'",
    "SELECT COUNT(*) FROM foo WHERE CAST(l1 AS VARCHAR) <> '7.0'",
    "SELECT COUNT(*) FROM foo WHERE CAST(l1 AS VARCHAR) IN ('7.0', '9')",
    "SELECT COUNT(*) FROM foo WHERE CAST(l1 AS VARCHAR) IN ('7.0')",
    "SELECT COUNT(*) FROM foo WHERE CAST(f1 AS VARCHAR) = '1.0'",
    "SELECT COUNT(*) FROM foo WHERE CAST(f1 AS VARCHAR) = '1'",
    "SELECT COUNT(*) FROM foo WHERE CAST(f1 AS VARCHAR) <> '1'",
    # test_strlen_strpos_in_expressions, test_strpos_semantics_and_literals
    "SELECT MAX(CHAR_LENGTH(dim1)) FROM foo",
    "SELECT SUM(CHAR_LENGTH(dim1) + CHAR_LENGTH(dim2)) FROM foo",
    "SELECT SUM(STRPOS(dim1, 'a')) FROM foo",
    "SELECT SUM(STRPOS(dim2, 'z')) FROM foo",
    "SELECT SUM(CASE WHEN STRPOS(dim1, 'b') > 0 THEN l1 ELSE 0 END) FROM foo",
    "SELECT SUM(l1 * CHAR_LENGTH(dim2)) FROM foo",
    "SELECT MAX(STRPOS(dim2, 'x')) FROM foo",
    "SELECT MIN(STRPOS(dim2, 'x')) FROM foo",
    "SELECT MAX(CHAR_LENGTH('abc') + l1 * 0) FROM foo",
    "SELECT MAX(STRPOS('hello', 'll') + l1 * 0) FROM foo",
]


@pytest.mark.parametrize("stmt", STATEMENTS)
def test_statement_matches_reference(pair, stmt):
    check(*pair, stmt)


#: ROUND(x, n) of a FLOAT value divides by 10^n. The reference's jitted
#: XLA program multiplies by the float32 reciprocal instead, one float32
#: ulp off where the quotient is exact (5500 / 1000 gives 5.5000005); the
#: port divides, as numpy does (ROADMAP §C). (statement, the port's and
#: numpy's value, the reference's value)
ROUND_QUOTIENT = [
    ("SELECT MAX(ROUND(LOG10(l1 * 0 + 1000), 3)) FROM foo", 3.0,
     float(np.float32(3000) * np.float32(0.001))),
    ("SELECT MAX(ROUND(f1, 3)) FROM foo", 5.5,
     float(np.float32(5500) * np.float32(0.001))),
]


@pytest.mark.parametrize("stmt,port_value,ref_value", ROUND_QUOTIENT)
def test_round_quotient_divergence(pair, stmt, port_value, ref_value):
    ref, port = pair
    assert port.explain(stmt) == ref.explain(stmt)
    assert ref.execute(stmt)[1] == [[ref_value]]
    assert port.execute(stmt)[1] == [[port_value]]
    f1 = np.asarray([r[3] for r in ROWS], dtype=np.float32)
    numpy_max = float((np.floor(np.abs(f1) * np.float32(1000) + 0.5)
                       / np.float32(1000)).max())
    assert numpy_max == 5.5 and ref_value != port_value


@pytest.mark.parametrize("stmt,match", [
    # test_non_literal_extraction_args_rejected_cleanly
    ("SELECT COUNT(*) FROM foo WHERE "
     "SUBSTRING(dim1, 1, CHAR_LENGTH(dim2)) = 'a'", "not translatable"),
    # test_timestampadd_timestampdiff (calendar units)
    ("SELECT MAX(TIMESTAMPDIFF(MONTH, TIMESTAMP '2026-01-01', __time)) "
     "FROM foo", "calendar-variable"),
    # test_varchar_cast_unwrap_is_semantics_safe (ordering)
    ("SELECT COUNT(*) FROM foo WHERE CAST(l1 AS VARCHAR) > '5'",
     "lexicographic ordering"),
])
def test_planner_errors_match_reference(pair, stmt, match):
    ref, port = pair
    check_error(lambda: ref.execute(stmt), lambda: port.execute(stmt), match)


def test_string_fn_wire_roundtrip(pair):
    """The planned extraction filter survives the port's JSON serde."""
    from druid_tpu_torch.query.model import query_from_json
    _, port = pair
    plan = port.explain("SELECT COUNT(*) FROM foo WHERE UPPER(dim1) = 'A'")
    assert plan["filter"]["extractionFn"]["type"] == "upper"
    assert query_from_json(plan).filter.extraction_fn is not None


def test_trim_strips_spaces_only():
    """SQL TRIM trims spaces only: a tab survives, in both packages."""
    seg = _foo("ws", dims={"s": [" x", "\tx", "x "]}, metrics={}, n=3)
    _, rows = check(*sql_pair([seg]),
                    "SELECT COUNT(*) FROM ws WHERE TRIM(s) = 'x'")
    assert rows == [[2]]
