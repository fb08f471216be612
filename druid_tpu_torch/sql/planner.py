"""SQL → native query planner (the port's own copy of the reference
package's `sql/planner.py`, building the port's query objects).

Reference analog: sql/src/main/java/org/apache/druid/sql/calcite/rel/
DruidQuery.java (1054 LoC — decides scan | timeseries | topN | groupBy from
the rel tree) plus Expressions.java (SQL operator → Druid expression /
filter translation) and Aggregations.java (SQL aggregate → AggregatorFactory).

Planning is type-directed by a SqlSchema (table → column types), the analog
of DruidSchema's segmentMetadata-driven table discovery.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from druid_tpu_torch.query import aggregators as A
from druid_tpu_torch.query import filters as F
from druid_tpu_torch.query import postaggs as PA
from druid_tpu_torch.query.model import (
    AndHaving, DefaultDimensionSpec, DefaultLimitSpec, DimensionSpec,
    EqualToHaving, ExpressionDimensionSpec, ExpressionVirtualColumn,
    ExtractionDimensionSpec, FilterHaving, GreaterThanHaving, GroupByQuery,
    HavingSpec, LessThanHaving, LowerExtractionFn, NotHaving, OrderByColumnSpec,
    OrHaving, Query, RegisteredLookupExtractionFn, ScanQuery,
    SubstringExtractionFn, TimeBoundaryQuery, TimeseriesQuery, TopNQuery,
    UpperExtractionFn)
from druid_tpu_torch.sql import parser as P
from druid_tpu_torch.utils.intervals import (ETERNITY_END, ETERNITY_START,
                                             Interval, parse_ts, ts_to_iso)

TIME_COL = "__time"
TOPN_MAX_THRESHOLD = 1000

_FLOOR_UNITS = {"SECOND": "second", "MINUTE": "minute", "HOUR": "hour",
                "DAY": "day", "WEEK": "week", "MONTH": "month",
                "QUARTER": "quarter", "YEAR": "year"}


class PlannerError(ValueError):
    pass


@dataclass
class OutputColumn:
    """How one SQL projection maps onto the native result row."""
    alias: str
    kind: str          # "time" | "dim" | "value" | "column" | "constant"
    key: str = ""      # native field name (dim output / agg / postagg / col)
    constant: object = None


@dataclass
class PlannedQuery:
    native: Optional[Query]
    outputs: List[OutputColumn]
    # meta-queries (INFORMATION_SCHEMA) are answered by the executor
    meta_table: Optional[str] = None
    meta_select: Optional[P.Select] = None
    sort_in_executor: List[Tuple[str, bool]] = field(default_factory=list)
    limit_in_executor: Optional[int] = None
    offset_in_executor: int = 0


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

class SqlSchema:
    """table → {column: type}; types: string | long | float | double.
    The reference discovers this via segmentMetadata queries
    (sql/.../calcite/schema/DruidSchema.java); here the executor feeds it
    from live segments."""

    def __init__(self, tables: Optional[Dict[str, Dict[str, str]]] = None):
        self.tables = dict(tables or {})

    def columns(self, table: str) -> Dict[str, str]:
        if table not in self.tables:
            raise PlannerError(f"unknown table [{table}]")
        return self.tables[table]

    def type_of(self, table: str, col: str) -> Optional[str]:
        if col == TIME_COL:
            return "long"
        return self.columns(table).get(col)


# ---------------------------------------------------------------------------
# Expression → Druid expression string (druid_tpu_torch/utils/expression.py syntax)
# ---------------------------------------------------------------------------

_SQL_TO_EXPR_OP = {"=": "==", "<>": "!=", "<": "<", "<=": "<=", ">": ">",
                   ">=": ">=", "AND": "&&", "OR": "||", "+": "+", "-": "-",
                   "*": "*", "/": "/", "%": "%"}

_SQL_FN_TO_EXPR = {"ABS": "abs", "CEIL": "ceil", "FLOOR": "floor",
                   "EXP": "exp", "LN": "log", "LOG10": "log10",
                   "SQRT": "sqrt", "SIN": "sin", "COS": "cos", "TAN": "tan",
                   "POWER": "pow", "POW": "pow", "COALESCE": "nvl",
                   "NVL": "nvl", "MOD": "mod", "ROUND": "round",
                   "SIGN": "sign", "TRUNCATE": "trunc", "TRUNC": "trunc",
                   "GREATEST": "greatest", "LEAST": "least",
                   "SAFE_DIVIDE": "safe_divide",
                   "ASIN": "asin", "ACOS": "acos", "ATAN": "atan",
                   "ATAN2": "atan2", "COT": "cot", "DEGREES": "degrees",
                   "RADIANS": "radians", "PI": "pi",
                   # string→numeric fns: per-dictionary-value LUT gathers
                   # (utils.expression._STR_NUM_FNS)
                   "CHAR_LENGTH": "strlen", "LENGTH": "strlen",
                   "STRLEN": "strlen"}


_UNIT_MS = {"SECOND": 1000, "MINUTE": 60_000, "HOUR": 3_600_000,
            "DAY": 86_400_000, "WEEK": 7 * 86_400_000}
#: ISO weeks are Monday-aligned; epoch day 0 is a Thursday
_WEEK_ORIGIN_MS = -3 * 86_400_000

def _check_extract_unit(unit: str) -> None:
    from druid_tpu_torch.utils.expression import EXTRACT_UNITS
    if unit not in EXTRACT_UNITS:
        raise PlannerError(
            f"EXTRACT unit {unit!r} not supported "
            f"(supported: {', '.join(sorted(EXTRACT_UNITS))})")


def _period_literal_ms(e) -> Tuple[int, int]:
    """(period_ms, origin_ms) for a UNIFORM ISO period literal. Calendar
    periods (months/years) are non-uniform in millis and reject — an
    approximation here would return silently wrong buckets (those belong
    in the GROUP BY granularity path). Week periods align to ISO Mondays."""
    from druid_tpu_torch.utils.intervals import parse_period_ms
    if not isinstance(e, P.Lit):
        raise PlannerError("period argument must be a literal")
    s = str(e.value).strip().upper()
    # months appear before any T section; minutes only after it
    if re.search(r"\d+Y", s) or re.match(r"^P[^T]*?\d+M", s):
        raise PlannerError(
            f"calendar period {e.value!r} is non-uniform in millis; use "
            f"FLOOR(__time TO ...) in GROUP BY for month/year bucketing")
    ms = parse_period_ms(e.value)
    origin = _WEEK_ORIGIN_MS if re.match(r"^P\d+W$", s) else 0
    return ms, origin


def _expr_str(e, table: str, schema: SqlSchema) -> str:
    """Render a SQL AST node as a Druid expression-language string."""
    if isinstance(e, P.Lit):
        if e.type == "string":
            return "'" + str(e.value).replace("\\", "\\\\").replace("'", "\\'") + "'"
        if e.type == "timestamp":
            return str(parse_ts(e.value))
        if e.type == "bool":
            return "1" if e.value else "0"
        if e.value is None:
            return "''"
        return repr(e.value)
    if isinstance(e, P.Col):
        return e.name
    if isinstance(e, P.Bin):
        op = _SQL_TO_EXPR_OP.get(e.op)
        if op is None:
            raise PlannerError(f"operator {e.op!r} not translatable")
        return f"({_expr_str(e.left, table, schema)} {op} {_expr_str(e.right, table, schema)})"
    if isinstance(e, P.Un):
        if e.op == "-":
            return f"(0 - {_expr_str(e.operand, table, schema)})"
        return f"(1 - ({_expr_str(e.operand, table, schema)}))"  # NOT
    if isinstance(e, P.Case):
        out = None
        for cond, val in reversed(e.whens):
            tail = _expr_str(e.else_, table, schema) if out is None and e.else_ is not None \
                else (out if out is not None else "0")
            out = f"if({_expr_str(cond, table, schema)}, {_expr_str(val, table, schema)}, {tail})"
        return out or "0"
    if isinstance(e, P.Cast):
        return f"cast({_expr_str(e.operand, table, schema)}, '{e.to_type}')"
    if isinstance(e, P.BetweenExpr):
        lo = _expr_str(e.low, table, schema)
        hi = _expr_str(e.high, table, schema)
        x = _expr_str(e.operand, table, schema)
        s = f"(({x} >= {lo}) && ({x} <= {hi}))"
        return f"(1 - {s})" if e.negated else s
    if isinstance(e, P.Fn):
        if e.extra is not None:
            unit = str(e.extra).upper()
            x = _expr_str(e.args[0], table, schema)
            if e.name == "EXTRACT":
                _check_extract_unit(unit)
                return f"timestamp_extract({x}, '{unit}')"
            if e.name in ("FLOOR", "CEIL") and unit in _UNIT_MS:
                period = _UNIT_MS[unit]
                origin = _WEEK_ORIGIN_MS if unit == "WEEK" else 0
                if e.name == "FLOOR":
                    return f"timestamp_floor({x}, {period}, {origin})"
                return (f"timestamp_floor(({x}) + {period - 1}, {period}, "
                        f"{origin})")
            # calendar (month/year) floors are non-uniform in millis; only
            # the GROUP BY granularity path understands those
            raise PlannerError(
                f"{e.name}(... TO {e.extra}) not expressible in millis "
                f"arithmetic (use it in GROUP BY)")
        if e.name == "TIME_FLOOR":
            if len(e.args) != 2:
                # origin/timezone arguments would be silently dropped —
                # reject rather than return offset buckets
                raise PlannerError(
                    "TIME_FLOOR(expr, period) supports exactly 2 arguments")
            x = _expr_str(e.args[0], table, schema)
            period, origin = _period_literal_ms(e.args[1])
            return f"timestamp_floor({x}, {period}, {origin})"
        if e.name == "TIME_SHIFT" and len(e.args) == 3:
            x = _expr_str(e.args[0], table, schema)
            period, _ = _period_literal_ms(e.args[1])
            n = _expr_str(e.args[2], table, schema)
            return f"timestamp_shift({x}, {period}, {n})"
        if e.name == "TIME_EXTRACT" and len(e.args) == 2 \
                and isinstance(e.args[1], P.Lit):
            x = _expr_str(e.args[0], table, schema)
            unit = str(e.args[1].value).upper()
            _check_extract_unit(unit)
            return f"timestamp_extract({x}, '{unit}')"
        if e.name in ("TIMESTAMP_TO_MILLIS", "MILLIS_TO_TIMESTAMP") \
                and len(e.args) == 1:
            return _expr_str(e.args[0], table, schema)   # millis both ways
        if e.name in ("TIMESTAMPADD", "TIMESTAMPDIFF") and len(e.args) == 3:
            u = e.args[0]
            unit = (u.name if isinstance(u, P.Col)
                    else str(getattr(u, "value", u))).upper()
            period = _UNIT_MS.get(unit)
            if period is None:
                raise PlannerError(
                    f"{e.name} supports uniform units "
                    f"({', '.join(sorted(_UNIT_MS))}); {unit} is "
                    "calendar-variable")
            if e.name == "TIMESTAMPADD":
                n = _expr_str(e.args[1], table, schema)
                x = _expr_str(e.args[2], table, schema)
                return f"timestamp_shift({x}, {period}, {n})"
            a = _expr_str(e.args[1], table, schema)
            b = _expr_str(e.args[2], table, schema)
            return f"div(({b}) - ({a}), {period})"
        if e.name == "STRPOS" and len(e.args) == 2:
            # SQL STRPOS is 1-based with 0 for absent; the native
            # expression strpos is Druid's 0-based/-1 form
            x = _expr_str(e.args[0], table, schema)
            lit = _expr_str(e.args[1], table, schema)
            return f"(strpos({x}, {lit}) + 1)"
        fn = _SQL_FN_TO_EXPR.get(e.name)
        if fn is not None:
            args = ", ".join(_expr_str(a, table, schema) for a in e.args)
            return f"{fn}({args})"
        raise PlannerError(f"function {e.name} not translatable to expression")
    raise PlannerError(f"cannot translate {type(e).__name__} to expression")


# ---------------------------------------------------------------------------
# WHERE → (intervals, DimFilter)
# ---------------------------------------------------------------------------

def _is_time_col(e) -> bool:
    return isinstance(e, P.Col) and e.name == TIME_COL


def _lit_ms(e) -> Optional[int]:
    if isinstance(e, P.Lit):
        if e.type == "timestamp":
            return parse_ts(e.value)
        if e.type in ("long", "double"):
            return int(e.value)
        if e.type == "string":
            try:
                return parse_ts(e.value)
            except (ValueError, TypeError):
                return None
    return None


def split_where(e, table: str, schema: SqlSchema
                ) -> Tuple[Optional[Interval], Optional[F.DimFilter]]:
    """Split the WHERE conjunction into a __time interval + a DimFilter
    (the analog of Calcite's interval extraction in DruidQuery/Expressions)."""
    lo, hi = None, None
    rest: List[F.DimFilter] = []

    def add_bound(which: str, ms: int):
        nonlocal lo, hi
        if which == "lo":
            lo = ms if lo is None else max(lo, ms)
        else:
            hi = ms if hi is None else min(hi, ms)

    def walk(node):
        if isinstance(node, P.Bin) and node.op == "AND":
            walk(node.left)
            walk(node.right)
            return
        if isinstance(node, P.BetweenExpr) and _is_time_col(node.operand) \
                and not node.negated:
            blo, bhi = _lit_ms(node.low), _lit_ms(node.high)
            if blo is not None and bhi is not None:
                add_bound("lo", blo)
                add_bound("hi", bhi + 1)  # BETWEEN is inclusive
                return
        b = _time_bound(node)
        if b is not None:
            add_bound(*b)
            return
        rest.append(to_filter(node, table, schema))

    if e is not None:
        walk(e)
    interval = None
    if lo is not None or hi is not None:
        start = lo if lo is not None else ETERNITY_START
        end = hi if hi is not None else ETERNITY_END
        # contradictory bounds → legal empty range, not an error
        interval = Interval(start, max(start, end))
    flt = None
    if rest:
        flt = rest[0] if len(rest) == 1 else F.AndFilter(tuple(rest))
    return interval, flt


def _time_bound(node) -> Optional[Tuple[str, int]]:
    """__time <cmp> TIMESTAMP → ("lo"/"hi", ms). Intervals are [lo, hi)."""
    if not isinstance(node, P.Bin):
        return None
    l, r, op = node.left, node.right, node.op
    if _is_time_col(r) and not _is_time_col(l):
        # flip: 't' < __time  →  __time > 't'
        l, r = r, l
        op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
    if not _is_time_col(l):
        return None
    ms = _lit_ms(r)
    if ms is None:
        return None
    if op == ">=":
        return ("lo", ms)
    if op == ">":
        return ("lo", ms + 1)
    if op == "<":
        return ("hi", ms)
    if op == "<=":
        return ("hi", ms + 1)
    return None


def _lit_str(e) -> str:
    if not isinstance(e, P.Lit):
        raise PlannerError("expected literal")
    if e.type == "timestamp":
        # __time comparisons that escape interval extraction (e.g. under OR)
        # filter against numeric epoch millis
        return str(parse_ts(e.value))
    return "" if e.value is None else str(e.value)


def _peel_varchar_casts(e):
    while isinstance(e, P.Cast) and \
            str(e.to_type).upper() in ("VARCHAR", "CHAR", "STRING"):
        e = e.operand
    return e


def _canonical_number(s: str, ctype: Optional[str] = None) -> bool:
    """Does this literal round-trip the COLUMN TYPE's stringification?
    Only then is CAST(numcol AS VARCHAR) = lit the same as numcol =
    number. Long columns stringify via str(int): '7' matches, '7.0'/'07'/
    '7a' never can. Double/float columns stringify via str(float): '7.0'
    matches but '7' never can (the cast yields '7.0'). With no ctype,
    either canonical form passes (pre-type-awareness callers)."""
    if ctype == "long":
        try:
            return str(int(s)) == s
        except ValueError:
            return False
    if ctype in ("float", "double"):
        try:
            return s in (str(float(s)), repr(float(s)))
        except ValueError:
            return False
    try:
        if str(int(s)) == s:
            return True
    except ValueError:
        pass
    try:
        return s in (str(float(s)), repr(float(s)))
    except ValueError:
        return False


class _NeverMatch:
    """Sentinel from _unwrap_varchar_cast: the comparison is statically
    false — the literal can never equal the column's stringification
    (e.g. CAST(double AS VARCHAR) = '7', which stringifies to '7.0')."""


_NEVER = _NeverMatch()


def _unwrap_varchar_cast(e, table: str, schema: SqlSchema,
                         op: str = "=", literals=()):
    """CAST(x AS VARCHAR) unwraps ONLY where string-compare semantics
    equal the column's own: always for string columns (pure identity);
    for numeric columns only under =/<>/IN with literals canonical FOR
    THAT TYPE (ordering and LIKE compare strings lexicographically —
    numeric planning would return different rows). Non-canonical =/<>
    literals return _NEVER: the equality is statically false, so the
    caller plans zero rows (or all rows for <>) instead of handing the
    engine a number-vs-string comparison that crashes or silently
    mismatches (int('7.0') → ValueError → 500)."""
    inner = _peel_varchar_casts(e)
    if inner is e:
        return e
    if not isinstance(inner, P.Col):
        return inner          # fn trees: the extraction path type-checks
    ctype = schema.type_of(table, inner.name)
    if ctype == "string":
        return inner
    if op in ("=", "<>", "in") and literals:
        if all(_canonical_number(str(v), ctype) for v in literals):
            return inner
        return _NEVER
    if op in ("<", "<=", ">", ">="):
        # SQL compares the STRINGS lexicographically; numeric columns
        # have no dictionary to realize that on the device, and the
        # expression fallback would crash comparing number to string
        raise PlannerError(
            "lexicographic ordering over CAST(numeric AS VARCHAR) is not "
            "supported — compare the numeric column directly")
    return e


def _extraction_of(e, table: str, schema: SqlSchema):
    """String-function call tree over ONE column → (column name,
    ExtractionFn), or None. Nested calls cascade (reference:
    Expressions.toSimpleExtraction — UPPER/LOWER/SUBSTRING/TRIM/LEFT/
    RIGHT/CHAR_LENGTH/REGEXP_EXTRACT/LOOKUP compose on a dimension)."""
    from druid_tpu_torch.query.model import (CascadeExtractionFn,
                                             ExtractionFn, RegexExtractionFn,
                                             StrlenExtractionFn)

    def inner(node):
        if isinstance(node, P.Col):
            if schema.type_of(table, node.name) != "string":
                return None           # extraction reads string dims only
            return node.name, ()
        if not isinstance(node, P.Fn) or not node.args:
            return None
        base = inner(node.args[0])
        if base is None:
            return None
        col, chain = base

        def lit(i, default=None):
            if len(node.args) > i and isinstance(node.args[i], P.Lit):
                return node.args[i].value
            return default

        nm = node.name
        if nm == "UPPER" and len(node.args) == 1:
            return col, chain + (UpperExtractionFn(),)
        if nm == "LOWER" and len(node.args) == 1:
            return col, chain + (LowerExtractionFn(),)
        if nm == "SUBSTRING" and len(node.args) >= 2:
            start = lit(1)
            if start is None:
                return None
            if len(node.args) > 2 and lit(2) is None:
                return None    # non-literal length → expression path
            return col, chain + (SubstringExtractionFn(
                int(start) - 1,
                None if len(node.args) < 3 else int(lit(2))),)
        if nm == "LEFT" and len(node.args) == 2 and lit(1) is not None:
            return col, chain + (SubstringExtractionFn(0, int(lit(1))),)
        if nm == "RIGHT" and len(node.args) == 2 and lit(1) is not None:
            n = int(lit(1))
            return col, chain + (RegexExtractionFn(
                f"(.{{0,{n}}})$", 1),)
        if nm == "TRIM" and len(node.args) == 1:
            # SQL TRIM strips SPACE characters only — \s would also eat
            # tabs/newlines and match values the reference would not
            return col, chain + (RegexExtractionFn(
                "^ *(.*?) *$", 1),)
        if nm in ("CHAR_LENGTH", "LENGTH", "STRLEN") \
                and len(node.args) == 1:
            return col, chain + (StrlenExtractionFn(),)
        if nm == "REGEXP_EXTRACT" and len(node.args) >= 2 \
                and lit(1) is not None:
            if len(node.args) > 2 and lit(2) is None:
                return None    # non-literal group index → expression path
            return col, chain + (RegexExtractionFn(
                str(lit(1)), int(lit(2, 0)),
                replace_missing=True, replacement=None),)
        if nm == "LOOKUP" and len(node.args) == 2 and lit(1) is not None:
            return col, chain + (RegisteredLookupExtractionFn(str(lit(1))),)
        return None

    got = inner(e)
    if got is None or not got[1]:
        return None
    col, chain = got
    fn: ExtractionFn = chain[0] if len(chain) == 1 \
        else CascadeExtractionFn(tuple(chain))
    return col, fn


def to_filter(e, table: str, schema: SqlSchema) -> F.DimFilter:
    """SQL boolean AST → DimFilter tree (reference: Expressions.toFilter)."""
    if isinstance(e, P.Bin) and e.op in ("AND", "OR"):
        parts = (to_filter(e.left, table, schema),
                 to_filter(e.right, table, schema))
        return F.AndFilter(parts) if e.op == "AND" else F.OrFilter(parts)
    if isinstance(e, P.Un) and e.op == "NOT":
        return F.NotFilter(to_filter(e.operand, table, schema))
    if isinstance(e, P.IsNullExpr):
        if not isinstance(e.operand, P.Col):
            raise PlannerError("IS NULL supported on columns only")
        flt = F.SelectorFilter(e.operand.name, None)
        return F.NotFilter(flt) if e.negated else flt
    if isinstance(e, P.InExpr):
        if e.subquery is not None:
            raise PlannerError(
                "IN (SELECT ...) must be materialized by the SQL executor")
        operand = _peel_varchar_casts(e.operand)
        if operand is not e.operand and isinstance(operand, P.Col) \
                and schema.type_of(table, operand.name) != "string":
            # CAST(numcol AS VARCHAR) IN (...): only literals canonical
            # for the COLUMN TYPE can ever equal its stringification —
            # keep those, drop the rest ('7.0' against a long column, '7'
            # against a double); an all-dropped list matches nothing
            ctype = schema.type_of(table, operand.name)
            vals = tuple(_lit_str(v) for v in e.values
                         if _canonical_number(_lit_str(v), ctype))
            if not vals:
                return F.NotFilter(F.FalseFilter()) if e.negated \
                    else F.FalseFilter()
            flt = F.InFilter(operand.name, vals)
            return F.NotFilter(flt) if e.negated else flt
        if isinstance(operand, P.Col):
            vals = tuple(_lit_str(v) for v in e.values)
            flt = F.InFilter(operand.name, vals)
            return F.NotFilter(flt) if e.negated else flt
        ext = _extraction_of(operand, table, schema)
        if ext is not None:
            vals = tuple(_lit_str(v) for v in e.values)
            flt = F.InFilter(ext[0], vals, extraction_fn=ext[1])
            return F.NotFilter(flt) if e.negated else flt
        raise PlannerError("IN supported on columns only")
    if isinstance(e, P.LikeExpr):
        if isinstance(e.pattern, P.Lit):
            # LIKE is string-lexical: unwrap applies to string columns only
            operand = _unwrap_varchar_cast(e.operand, table, schema,
                                           op="like")
            if isinstance(operand, P.Col):
                flt = F.LikeFilter(operand.name, str(e.pattern.value))
                return F.NotFilter(flt) if e.negated else flt
            ext = _extraction_of(operand, table, schema)
            if ext is not None:
                flt = F.LikeFilter(ext[0], str(e.pattern.value),
                                   extraction_fn=ext[1])
                return F.NotFilter(flt) if e.negated else flt
        raise PlannerError("LIKE needs column and literal pattern")
    if isinstance(e, P.BetweenExpr):
        if isinstance(e.operand, P.Col):
            ctype = schema.type_of(table, e.operand.name)
            ordering = "numeric" if ctype in ("long", "float", "double") \
                else "lexicographic"
            flt = F.BoundFilter(e.operand.name,
                                lower=_lit_str(e.low), upper=_lit_str(e.high),
                                lower_strict=False, upper_strict=False,
                                ordering=ordering)
            return F.NotFilter(flt) if e.negated else flt
        raise PlannerError("BETWEEN supported on columns only")
    if isinstance(e, P.Bin) and e.op in ("=", "<>", "<", "<=", ">", ">="):
        l, r, op = e.left, e.right, e.op
        # CAST(col AS VARCHAR) compared to a literal: unwrap where that is
        # value-identity (see _unwrap_varchar_cast) so it plans as a
        # proper column filter instead of a number-vs-string expression
        # that silently matches nothing
        if isinstance(r, P.Lit):
            l = _unwrap_varchar_cast(l, table, schema, op,
                                     (_lit_str(r),))
        if isinstance(l, P.Lit):
            r = _unwrap_varchar_cast(r, table, schema, op,
                                     (_lit_str(l),))
        if l is _NEVER or r is _NEVER:
            # statically-false equality: CAST(numcol AS VARCHAR) can never
            # stringify to this literal — zero rows for =, all rows for <>
            if op == "=":
                return F.FalseFilter()
            if op == "<>":
                return F.TrueFilter()
            return F.FalseFilter()   # unreachable: ordering ops raise
        if isinstance(r, P.Col) and not isinstance(l, P.Col):
            l, r = r, l
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        if isinstance(l, P.Col) and isinstance(r, P.Lit):
            name = l.name
            ctype = schema.type_of(table, name)
            numeric = ctype in ("long", "float", "double")
            ordering = "numeric" if numeric else "lexicographic"
            v = _lit_str(r)
            if op == "=":
                if numeric:
                    return F.BoundFilter(name, lower=v, upper=v,
                                         ordering="numeric")
                return F.SelectorFilter(name, v)
            if op == "<>":
                if numeric:
                    return F.NotFilter(F.BoundFilter(name, lower=v, upper=v,
                                                     ordering="numeric"))
                return F.NotFilter(F.SelectorFilter(name, v))
            if op == "<":
                return F.BoundFilter(name, upper=v, upper_strict=True,
                                     ordering=ordering)
            if op == "<=":
                return F.BoundFilter(name, upper=v, ordering=ordering)
            if op == ">":
                return F.BoundFilter(name, lower=v, lower_strict=True,
                                     ordering=ordering)
            if op == ">=":
                return F.BoundFilter(name, lower=v, ordering=ordering)
        if isinstance(l, P.Col) and isinstance(r, P.Col) and op == "=":
            return F.ColumnComparisonFilter((l.name, r.name))
        if isinstance(r, P.Lit) and not isinstance(l, P.Col):
            # string-function call over a dimension: filter through an
            # extraction fn on the dictionary (Expressions.toSimpleExtraction)
            ext = _extraction_of(l, table, schema)
            if ext is not None:
                name, fn = ext
                v = _lit_str(r)
                ordering = "numeric" if isinstance(r.value, (int, float)) \
                    and not isinstance(r.value, bool) else "lexicographic"
                if op == "=":
                    return F.SelectorFilter(name, v, extraction_fn=fn)
                if op == "<>":
                    return F.NotFilter(
                        F.SelectorFilter(name, v, extraction_fn=fn))
                strict = op in ("<", ">")
                if op in ("<", "<="):
                    return F.BoundFilter(name, upper=v, upper_strict=strict,
                                         ordering=ordering,
                                         extraction_fn=fn)
                return F.BoundFilter(name, lower=v, lower_strict=strict,
                                     ordering=ordering, extraction_fn=fn)
        # fall through to expression filter
        return F.ExpressionFilter(_expr_str(e, table, schema))
    if isinstance(e, P.Lit) and e.type == "bool":
        return F.TrueFilter() if e.value else F.FalseFilter()
    # general fallback
    return F.ExpressionFilter(_expr_str(e, table, schema))


# ---------------------------------------------------------------------------
# Aggregates
# ---------------------------------------------------------------------------

def _is_aggregate(e) -> bool:
    if isinstance(e, P.Fn) and e.name in P._AGG_FNS:
        return True
    if isinstance(e, P.Bin):
        return _is_aggregate(e.left) or _is_aggregate(e.right)
    if isinstance(e, P.Un):
        return _is_aggregate(e.operand)
    if isinstance(e, P.Cast):
        return _is_aggregate(e.operand)
    return False


class _AggBuilder:
    """Accumulates AggregatorSpecs / PostAggregators / virtual columns while
    translating aggregate projections (reference: Aggregations.java +
    GroupByRules)."""

    def __init__(self, table: str, schema: SqlSchema):
        self.table = table
        self.schema = schema
        self.aggs: List[A.AggregatorSpec] = []
        self.postaggs: List[PA.PostAggregator] = []
        self.vcols: List[ExpressionVirtualColumn] = []
        self._n = 0
        self._agg_by_key: Dict[str, str] = {}   # dedup: ast-repr → agg name

    def fresh(self, prefix: str = "a") -> str:
        self._n += 1
        return f"_{prefix}{self._n - 1}"

    def _field_for(self, e) -> Tuple[str, str]:
        """Aggregation input → (column name, type). Non-column exprs become
        virtual columns (double-typed)."""
        if isinstance(e, P.Col):
            t = self.schema.type_of(self.table, e.name)
            if t is None:
                raise PlannerError(f"unknown column [{e.name}]")
            return e.name, t
        name = self.fresh("v")
        self.vcols.append(ExpressionVirtualColumn(
            name, _expr_str(e, self.table, self.schema), "double"))
        return name, "double"

    def _simple(self, kind: str, col: str, ctype: str, name: str) -> A.AggregatorSpec:
        table = {
            ("SUM", "long"): A.LongSumAggregator,
            ("SUM", "float"): A.FloatSumAggregator,
            ("SUM", "double"): A.DoubleSumAggregator,
            ("MIN", "long"): A.LongMinAggregator,
            ("MIN", "float"): A.FloatMinAggregator,
            ("MIN", "double"): A.DoubleMinAggregator,
            ("MAX", "long"): A.LongMaxAggregator,
            ("MAX", "float"): A.FloatMaxAggregator,
            ("MAX", "double"): A.DoubleMaxAggregator,
        }
        cls = table.get((kind, ctype))
        if cls is None:
            if ctype == "string":
                raise PlannerError(f"{kind} over string column [{col}]")
            cls = table[(kind, "double")]
        return cls(name, col)

    def translate(self, e, alias: str) -> str:
        """Translate an aggregate projection; returns the native output
        field name carrying its value (agg name or postagg name)."""
        if isinstance(e, P.Fn) and e.name in P._AGG_FNS:
            return self._agg_fn(e, alias)
        if isinstance(e, P.Bin):
            # arithmetic over aggregates → post-aggregator
            l = self._operand(e.left)
            r = self._operand(e.right)
            fn = {"+": "+", "-": "-", "*": "*", "/": "/", "%": "%"}.get(e.op)
            if fn is None:
                raise PlannerError(f"operator {e.op!r} over aggregates")
            self.postaggs.append(PA.ArithmeticPostAgg(alias, fn, (l, r)))
            return alias
        if isinstance(e, P.Cast):
            return self.translate(e.operand, alias)
        raise PlannerError(f"cannot translate aggregate {e!s}")

    def _operand(self, e) -> PA.PostAggregator:
        if isinstance(e, P.Lit) and e.type in ("long", "double"):
            return PA.ConstantPostAgg("c", float(e.value))
        name = self.translate(e, self.fresh())
        return PA.FieldAccessPostAgg(name, name)

    def _agg_fn(self, e: P.Fn, alias: str) -> str:
        key = repr((e.name, e.args, e.distinct, e.filter, e.extra))
        hit = self._agg_by_key.get(key)
        if hit is not None:
            return hit

        def reg(agg: A.AggregatorSpec) -> str:
            if e.filter is not None:
                agg = A.FilteredAggregator(
                    agg.name, agg, to_filter(e.filter, self.table, self.schema))
            self.aggs.append(agg)
            self._agg_by_key[key] = agg.name
            return agg.name

        if e.name == "COUNT":
            if e.distinct:
                col, _ = self._field_for(e.args[0])
                return reg(A.CardinalityAggregator(alias, (col,), round=True))
            if e.args:
                # COUNT(col) = rows where col is not null; an attached
                # FILTER clause ANDs with the not-null predicate
                col = e.args[0]
                if not isinstance(col, P.Col):
                    raise PlannerError("COUNT(expr) not supported; use COUNT(*)")
                flt = F.NotFilter(F.SelectorFilter(col.name, None))
                if e.filter is not None:
                    flt = F.AndFilter(
                        (flt, to_filter(e.filter, self.table, self.schema)))
                self.aggs.append(A.FilteredAggregator(
                    alias, A.CountAggregator(alias), flt))
                # structural dedupe: the FIRST planner alias is shared
                # by every identical aggregate expression on purpose
                self._agg_by_key[key] = alias  # druidlint: disable=unkeyed-trace-input
                return alias
            return reg(A.CountAggregator(alias))
        if e.name == "APPROX_COUNT_DISTINCT":
            col, _ = self._field_for(e.args[0])
            return reg(A.CardinalityAggregator(alias, (col,), round=True))
        if e.name in ("SUM", "MIN", "MAX"):
            col, ctype = self._field_for(e.args[0])
            return reg(self._simple(e.name, col, ctype, alias))
        if e.name == "AVG":
            col, ctype = self._field_for(e.args[0])
            sname, cname = self.fresh(), self.fresh()
            ssum = self._simple("SUM", col, ctype, sname)
            cnt = A.CountAggregator(cname)
            if e.filter is not None:
                flt = to_filter(e.filter, self.table, self.schema)
                ssum = A.FilteredAggregator(sname, ssum, flt)
                cnt = A.FilteredAggregator(cname, cnt, flt)
            self.aggs += [ssum, cnt]
            self.postaggs.append(PA.ArithmeticPostAgg(
                alias, "/", (PA.FieldAccessPostAgg(sname, sname),
                             PA.FieldAccessPostAgg(cname, cname))))
            # structural dedupe: first alias shared by design (see COUNT)
            self._agg_by_key[key] = alias  # druidlint: disable=unkeyed-trace-input
            return alias
        if e.name in ("EARLIEST", "LATEST"):
            col, ctype = self._field_for(e.args[0])
            cls = A.FirstAggregator if e.name == "EARLIEST" else A.LastAggregator
            kind = "long" if ctype == "long" else "double"
            return reg(cls(alias, col, kind))
        if e.name in ("VARIANCE", "VAR_POP", "VAR_SAMP", "STDDEV",
                      "STDDEV_POP", "STDDEV_SAMP"):
            from druid_tpu_torch.ext.stats import (
                StandardDeviationPostAgg, VarianceAggregator)
            col, _ = self._field_for(e.args[0])
            # SQL/Druid default: VARIANCE ≡ VAR_SAMP, STDDEV ≡ STDDEV_SAMP
            estimator = "population" if e.name.endswith("_POP") else "sample"
            if e.name.startswith("STDDEV"):
                vname = self.fresh("var")
                reg(VarianceAggregator(vname, col, estimator))
                self.postaggs.append(StandardDeviationPostAgg(alias, vname))
                # structural dedupe: first alias shared by design
                self._agg_by_key[key] = alias  # druidlint: disable=unkeyed-trace-input
                return alias
            return reg(VarianceAggregator(alias, col, estimator))
        if e.name == "APPROX_QUANTILE":
            from druid_tpu_torch.ext.sketches import (
                QuantilePostAgg, QuantilesSketchAggregator)
            col, _ = self._field_for(e.args[0])
            if len(e.args) < 2 or not isinstance(e.args[1], P.Lit):
                raise PlannerError("APPROX_QUANTILE needs a literal fraction")
            # one sketch per (column, filter) feeds every fraction over it
            skey = repr(("__qsketch", col, e.filter))
            sname = self._agg_by_key.get(skey)
            if sname is None:
                sname = self.fresh("qs")
                agg = QuantilesSketchAggregator(sname, col)
                if e.filter is not None:
                    agg = A.FilteredAggregator(
                        sname, agg, to_filter(e.filter, self.table,
                                              self.schema))
                self.aggs.append(agg)
                self._agg_by_key[skey] = sname
            self.postaggs.append(QuantilePostAgg(
                alias, PA.FieldAccessPostAgg(sname, sname),
                float(e.args[1].value)))
            # structural dedupe: first alias shared by design
            self._agg_by_key[key] = alias  # druidlint: disable=unkeyed-trace-input
            return alias
        if e.name == "DS_THETA":
            from druid_tpu_torch.ext.sketches import ThetaSketchAggregator
            col, _ = self._field_for(e.args[0])
            return reg(ThetaSketchAggregator(alias, col, should_finalize=True))
        raise PlannerError(f"aggregate {e.name} not supported")


# ---------------------------------------------------------------------------
# Grouping expressions → dimension specs / granularity
# ---------------------------------------------------------------------------

def _floor_unit(e) -> Optional[str]:
    """FLOOR(__time TO unit) → granularity name."""
    if isinstance(e, P.Fn) and e.name == "FLOOR" and e.extra \
            and len(e.args) == 1 and _is_time_col(e.args[0]):
        unit = _FLOOR_UNITS.get(e.extra)
        if unit is None:
            raise PlannerError(f"FLOOR unit {e.extra} unsupported")
        return unit
    return None


def _dimension_spec(e, alias: str, table: str, schema: SqlSchema,
                    builder: _AggBuilder) -> DimensionSpec:
    if isinstance(e, P.Col):
        t = schema.type_of(table, e.name)
        if t is None:
            raise PlannerError(f"unknown column [{e.name}]")
        # numeric columns group through the engine's numeric dimension
        # handler (query-time value dictionary)
        return DefaultDimensionSpec(e.name, alias)
    if isinstance(e, P.Fn) and e.name == "LOOKUP" \
            and isinstance(e.args[0], P.Col) and isinstance(e.args[1], P.Lit):
        return ExtractionDimensionSpec(
            e.args[0].name, alias,
            RegisteredLookupExtractionFn(str(e.args[1].value)))
    ext = _extraction_of(e, table, schema)
    if ext is not None:
        # the whole string-fn family (SUBSTRING/UPPER/LOWER/TRIM/LEFT/
        # RIGHT/CHAR_LENGTH/REGEXP_EXTRACT, nested) groups through one
        # extraction dimension spec
        return ExtractionDimensionSpec(ext[0], alias, ext[1])
    # anything translatable to an expression groups as a computed
    # dimension (EXTRACT, TIME_FLOOR, MOD, CASE, arithmetic, ...): the
    # engine host-evaluates it into a per-segment value dictionary
    try:
        expr_s = _expr_str(e, table, schema)
    except PlannerError as err:
        raise PlannerError(f"cannot group by {e!s}: {err}") from err
    return ExpressionDimensionSpec(expr_s, alias, "long")


# ---------------------------------------------------------------------------
# HAVING
# ---------------------------------------------------------------------------

def _having(e, alias_to_field: Dict[str, str], builder: _AggBuilder,
            table: str, schema: SqlSchema) -> HavingSpec:
    if isinstance(e, P.Bin) and e.op in ("AND", "OR"):
        parts = (_having(e.left, alias_to_field, builder, table, schema),
                 _having(e.right, alias_to_field, builder, table, schema))
        return AndHaving(parts) if e.op == "AND" else OrHaving(parts)
    if isinstance(e, P.Un) and e.op == "NOT":
        return NotHaving(_having(e.operand, alias_to_field, builder, table,
                                 schema))
    if isinstance(e, P.Bin) and e.op in ("=", "<", ">", "<=", ">="):
        l, r = e.left, e.right
        if isinstance(r, P.Lit) and r.type in ("long", "double"):
            field_name = _having_field(l, alias_to_field, builder)
            v = float(r.value)
            if e.op == ">":
                return GreaterThanHaving(field_name, v)
            if e.op == "<":
                return LessThanHaving(field_name, v)
            if e.op == "=":
                return EqualToHaving(field_name, v)
            if e.op == ">=":
                return NotHaving(LessThanHaving(field_name, v))
            if e.op == "<=":
                return NotHaving(GreaterThanHaving(field_name, v))
    raise PlannerError(f"cannot translate HAVING {e!s}")


def _having_field(e, alias_to_field: Dict[str, str],
                  builder: _AggBuilder) -> str:
    if isinstance(e, P.Col) and e.name in alias_to_field:
        return alias_to_field[e.name]
    if _is_aggregate(e):
        return builder.translate(e, builder.fresh("h"))
    raise PlannerError(f"HAVING references non-aggregate {e!s}")


# ---------------------------------------------------------------------------
# Top-level planning
# ---------------------------------------------------------------------------

def _ast_eq(a, b) -> bool:
    return repr(a) == repr(b)


def plan_sql(sel: P.Select, schema: SqlSchema) -> PlannedQuery:
    if sel.schema is not None:
        if sel.schema.upper() == "INFORMATION_SCHEMA":
            return PlannedQuery(None, [], meta_table=sel.table.upper(),
                                meta_select=sel)
        raise PlannerError(f"unknown schema [{sel.schema}]")
    if sel.subquery is not None:
        return _plan_nested(sel, schema)
    if sel.table is None:
        raise PlannerError("SELECT without FROM not supported")
    table = sel.table
    schema.columns(table)  # validate

    interval, flt = split_where(sel.where, table, schema)
    intervals = [interval if interval is not None else Interval.eternity()]

    # resolve GROUP BY ordinals (GROUP BY 1)
    group_by = []
    for g in sel.group_by:
        if isinstance(g, P.Lit) and g.type == "long":
            idx = int(g.value) - 1
            if not (0 <= idx < len(sel.items)):
                raise PlannerError(f"GROUP BY ordinal {g.value} out of range")
            group_by.append(sel.items[idx].expr)
        else:
            group_by.append(g)

    has_agg = any(_is_aggregate(it.expr) for it in sel.items) \
        or (sel.having is not None)

    if sel.distinct and not has_agg and not group_by:
        # SELECT DISTINCT a, b → GROUP BY a, b
        group_by = [it.expr for it in sel.items if not isinstance(it.expr, P.Star)]
        has_agg = True

    if not has_agg and not group_by:
        return _plan_scan(sel, table, schema, intervals, flt)
    return _plan_grouped(sel, table, schema, intervals, flt, group_by)


def _plan_nested(sel: P.Select, schema: SqlSchema) -> PlannedQuery:
    """FROM (SELECT ...): plan the inner statement, expose its output
    aliases as the synthetic __subquery__ table, and nest the natives via
    Query.inner_query — the executor/broker materialize inner groupBy rows
    as an in-memory segment (reference: DruidOuterQueryRel +
    GroupByStrategyV2.processSubqueryResult)."""
    from dataclasses import replace as _dc_replace
    inner = plan_sql(sel.subquery, schema)
    if not isinstance(inner.native, GroupByQuery):
        raise PlannerError(
            "FROM (subquery) requires the inner statement to plan as a "
            "groupBy (add a GROUP BY)")
    if inner.sort_in_executor or inner.limit_in_executor is not None \
            or inner.offset_in_executor:
        raise PlannerError(
            "inner ORDER BY/LIMIT handled outside the native query is not "
            "nestable — put the ordering on the outer statement")

    # inner outputs become the outer table's columns, typed from the
    # inner aggregators (dims → string except expression dims → long)
    agg_types: Dict[str, str] = {}
    for a in inner.native.aggregations:
        t = type(a).__name__
        agg_types[a.name] = "long" if t in ("CountAggregator",
                                            "LongSumAggregator",
                                            "LongMinAggregator",
                                            "LongMaxAggregator") else "double"
    for pa in inner.native.post_aggregations:
        agg_types[pa.name] = "double"
    expr_dims = {d.output_name for d in inner.native.dimensions
                 if isinstance(d, ExpressionDimensionSpec)}
    cols: Dict[str, str] = {}
    for o in inner.outputs:
        if o.kind == "time":
            continue      # outer references __time directly
        if o.kind == "dim":
            cols[o.alias] = "long" if o.key in expr_dims or \
                o.alias in expr_dims else "string"
        else:
            cols[o.alias] = agg_types.get(o.key, "double")
    inner_schema = SqlSchema({"__subquery__": cols})

    # the OUTER statement plans against the synthetic table; the inner's
    # native output columns are exposed under their SQL aliases, so remap
    # the inner outputs to emit alias-named event fields (mapped by the
    # NATIVE output name — projection order can differ from GROUP BY order)
    outer = plan_sql(_dc_replace(sel, subquery=None), inner_schema)
    inner_native = inner.native
    dim_alias_by_key: Dict[str, str] = {}
    value_renames: Dict[str, str] = {}
    for o in inner.outputs:
        ren = dim_alias_by_key if o.kind == "dim" else (
            value_renames if o.kind == "value" else None)
        if ren is None:
            continue
        if o.key in ren and ren[o.key] != o.alias:
            # two SQL aliases share one deduped native field; a last-wins
            # rename would silently drop one column — fail loudly
            raise PlannerError(
                f"inner column projected under two aliases "
                f"({ren[o.key]!r}, {o.alias!r}) — project it once and "
                f"reference the single alias in the outer statement")
        ren[o.key] = o.alias
    value_renames = {k: v for k, v in value_renames.items() if k != v}
    needs_rename = value_renames or any(
        dim_alias_by_key.get(d.output_name, d.output_name) != d.output_name
        for d in inner_native.dimensions)
    if needs_rename and inner_native.limit_spec is not None:
        raise PlannerError(
            "inner ORDER BY/LIMIT references pre-alias field names — put "
            "the ordering on the outer statement")
    ren_dims = []
    for d in inner_native.dimensions:
        alias = dim_alias_by_key.get(d.output_name, d.output_name)
        if alias == d.output_name:
            ren_dims.append(d)
        elif isinstance(d, ExpressionDimensionSpec):
            ren_dims.append(_dc_replace(d, output_name=alias))
        elif isinstance(d, DefaultDimensionSpec):
            ren_dims.append(DefaultDimensionSpec(d.dimension, alias))
        else:
            raise PlannerError(f"cannot alias nested dimension {d!r}")
    if value_renames:
        inner_native = _dc_replace(
            inner_native,
            aggregations=tuple(
                _rename_agg(a, value_renames.get(a.name)) for a in
                inner_native.aggregations),
            post_aggregations=tuple(
                _rename_postagg(pa, value_renames.get(pa.name)) for pa in
                inner_native.post_aggregations))
    inner_native = _dc_replace(inner_native, dimensions=tuple(ren_dims))
    outer_native = _dc_replace(outer.native, inner_query=inner_native)
    return PlannedQuery(outer_native, outer.outputs,
                        sort_in_executor=outer.sort_in_executor,
                        limit_in_executor=outer.limit_in_executor,
                        offset_in_executor=outer.offset_in_executor)


def _rename_agg(a, new_name):
    from dataclasses import replace as _dc_replace
    return a if new_name is None else _dc_replace(a, name=new_name)


def _rename_postagg(pa, new_name):
    from dataclasses import replace as _dc_replace
    return pa if new_name is None else _dc_replace(pa, name=new_name)


def _alias_of(it: P.SelectItem, i: int) -> str:
    if it.alias:
        return it.alias
    if isinstance(it.expr, P.Col):
        return it.expr.name
    return f"EXPR${i}"


def _plan_scan(sel: P.Select, table: str, schema: SqlSchema,
               intervals, flt) -> PlannedQuery:
    cols: List[str] = []
    outputs: List[OutputColumn] = []
    for i, it in enumerate(sel.items):
        if isinstance(it.expr, P.Star):
            allcols = [TIME_COL] + sorted(schema.columns(table))
            cols += [c for c in allcols if c not in cols]
            outputs += [OutputColumn(c, "column", c) for c in allcols]
        elif isinstance(it.expr, P.Col):
            name = it.expr.name
            if schema.type_of(table, name) is None:
                raise PlannerError(f"unknown column [{name}]")
            if name not in cols:
                cols.append(name)
            outputs.append(OutputColumn(_alias_of(it, i), "column", name))
        else:
            raise PlannerError("scan projections must be plain columns")
    order = "none"
    if sel.order_by:
        if len(sel.order_by) != 1 or not _is_time_col(sel.order_by[0].expr):
            raise PlannerError("non-aggregate ORDER BY supports __time only")
        order = "descending" if sel.order_by[0].descending else "ascending"
    q = ScanQuery.of(table, intervals, columns=tuple(cols), limit=sel.limit,
                     offset=sel.offset, order=order, filter=flt)
    return PlannedQuery(q, outputs)


def _plan_grouped(sel: P.Select, table: str, schema: SqlSchema,
                  intervals, flt, group_by) -> PlannedQuery:
    builder = _AggBuilder(table, schema)

    # split grouping exprs: time floor → granularity; rest → dimensions
    granularity = "all"
    time_expr = None
    dim_exprs: List[object] = []
    for g in group_by:
        unit = _floor_unit(g)
        if unit is not None:
            if time_expr is not None:
                raise PlannerError("multiple time FLOORs in GROUP BY")
            granularity = unit
            time_expr = g
        else:
            dim_exprs.append(g)

    # projections
    outputs: List[OutputColumn] = []
    dimspecs: List[DimensionSpec] = []
    dim_alias: Dict[str, str] = {}      # repr(expr) → output name
    alias_to_field: Dict[str, str] = {}  # SQL alias → native field
    for i, it in enumerate(sel.items):
        alias = _alias_of(it, i)
        e = it.expr
        if isinstance(e, P.Star):
            raise PlannerError("SELECT * incompatible with GROUP BY")
        if time_expr is not None and _ast_eq(e, time_expr):
            outputs.append(OutputColumn(alias, "time"))
            alias_to_field[alias] = "__timestamp"
            continue
        matched = next((g for g in dim_exprs if _ast_eq(e, g)), None)
        if matched is not None:
            key = repr(matched)
            if key not in dim_alias:
                dim_alias[key] = alias
                dimspecs.append(_dimension_spec(matched, alias, table, schema,
                                                builder))
            outputs.append(OutputColumn(alias, "dim", dim_alias[key]))
            alias_to_field[alias] = dim_alias[key]
            continue
        if _is_aggregate(e):
            name = builder.translate(e, alias)
            outputs.append(OutputColumn(alias, "value", name))
            alias_to_field[alias] = name
            continue
        if isinstance(e, P.Lit):
            outputs.append(OutputColumn(alias, "constant", constant=e.value))
            continue
        raise PlannerError(
            f"projection {e!s} is neither grouped nor aggregate")

    # grouping exprs not projected still need dimension specs
    for g in dim_exprs:
        key = repr(g)
        if key not in dim_alias:
            name = builder.fresh("d")
            dim_alias[key] = name
            dimspecs.append(_dimension_spec(g, name, table, schema, builder))

    having = None
    if sel.having is not None:
        having = _having(sel.having, alias_to_field, builder, table, schema)

    # ORDER BY → limit columns
    order_cols: List[OrderByColumnSpec] = []
    for ob in sel.order_by:
        e = ob.expr
        if isinstance(e, P.Lit) and isinstance(e.value, int) \
                and not isinstance(e.value, bool):
            # ordinal: ORDER BY 1 refers to the first projection
            if not (1 <= e.value <= len(outputs)):
                raise PlannerError(f"ORDER BY position {e.value} out of "
                                   f"range")
            e = P.Col(outputs[e.value - 1].alias)
        fname = None
        numeric = True
        if isinstance(e, P.Col) and e.name in alias_to_field:
            fname = alias_to_field[e.name]
            out = next(o for o in outputs if o.alias == e.name)
            numeric = out.kind in ("value", "time")
        elif time_expr is not None and _ast_eq(e, time_expr):
            fname = "__timestamp"
        elif repr(e) in dim_alias:
            fname = dim_alias[repr(e)]
            numeric = False
        elif _is_aggregate(e):
            fname = builder.translate(e, builder.fresh("o"))
        elif isinstance(e, P.Col):
            raise PlannerError(f"ORDER BY unknown column [{e.name}]")
        else:
            raise PlannerError(f"cannot ORDER BY {e!s}")
        direction = "descending" if ob.descending else "ascending"
        order_cols.append(OrderByColumnSpec(
            fname, direction, "numeric" if numeric else "lexicographic"))

    vcols = tuple(builder.vcols)

    # ---- timeseries: no dimensions
    if not dimspecs:
        # pure ungrouped MIN/MAX(__time) → timeBoundary (a time-bucketed or
        # HAVING-filtered variant must keep the timeseries machinery)
        if granularity == "all" and sel.having is None:
            tb = _time_boundary(sel, table, intervals, flt)
            if tb is not None:
                return tb
        for a in builder.aggs:
            if TIME_COL in a.required_columns():
                raise PlannerError("aggregating __time requires timeBoundary "
                                   "(pure MIN/MAX(__time) select)")
        descending = any(o.dimension == "__timestamp"
                         and o.direction == "descending" for o in order_cols)
        # non-time orderings (e.g. ORDER BY an aggregate) sort the shaped
        # rows in the executor — timeseries results are per-bucket
        sort_exec = [(o.dimension, o.direction == "descending")
                     for o in order_cols if o.dimension != "__timestamp"]
        # scalar aggregates (granularity 'all') must emit their one row even
        # when nothing matches — SELECT COUNT(*) WHERE <false> is 0, not
        # empty; time-floored buckets skip empties like the reference's
        # Calcite-planned timeseries
        q = TimeseriesQuery.of(
            table, intervals, builder.aggs, granularity=granularity,
            filter=flt, post_aggregations=tuple(builder.postaggs),
            descending=descending, skip_empty_buckets=(granularity != "all"),
            virtual_columns=vcols)
        return PlannedQuery(q, outputs,
                            sort_in_executor=sort_exec,
                            limit_in_executor=sel.limit,
                            offset_in_executor=sel.offset)

    # ---- topN: 1 dim, ordered by one agg desc, limited, no having/offset
    if (len(dimspecs) == 1 and granularity == "all" and having is None
            and sel.limit is not None and sel.limit <= TOPN_MAX_THRESHOLD
            and sel.offset == 0 and len(order_cols) == 1
            and order_cols[0].direction == "descending"
            and order_cols[0].dimension not in
            (dimspecs[0].output_name, "__timestamp")
            and not builder.vcols):
        metric = order_cols[0].dimension
        q = TopNQuery.of(
            table, intervals, dimspecs[0], metric, sel.limit, builder.aggs,
            granularity="all", filter=flt,
            post_aggregations=tuple(builder.postaggs))
        return PlannedQuery(q, outputs)

    limit_spec = None
    if order_cols or sel.limit is not None or sel.offset:
        limit_spec = DefaultLimitSpec(tuple(order_cols), sel.limit, sel.offset)
    q = GroupByQuery.of(
        table, intervals, dimspecs, builder.aggs, granularity=granularity,
        filter=flt, post_aggregations=tuple(builder.postaggs), having=having,
        limit_spec=limit_spec, virtual_columns=vcols)
    return PlannedQuery(q, outputs)


def _time_boundary(sel: P.Select, table: str, intervals, flt
                   ) -> Optional[PlannedQuery]:
    """SELECT MIN(__time)[, MAX(__time)] FROM t → timeBoundary."""
    bounds = []
    for i, it in enumerate(sel.items):
        e = it.expr
        if isinstance(e, P.Fn) and e.name in ("MIN", "MAX") \
                and len(e.args) == 1 and _is_time_col(e.args[0]) \
                and e.filter is None and not e.distinct:
            bounds.append(("minTime" if e.name == "MIN" else "maxTime",
                           _alias_of(it, i)))
        else:
            return None
    if not bounds:
        return None
    bound = bounds[0][0] if len(bounds) == 1 else None
    q = TimeBoundaryQuery.of(table, intervals, bound=bound, filter=flt)
    outputs = [OutputColumn(alias, "value", key) for key, alias in bounds]
    return PlannedQuery(q, outputs)
