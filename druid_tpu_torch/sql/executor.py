"""SQL execution entry point (the port's own copy of the reference
package's `sql/executor.py`; it runs on the port's QueryExecutor or
Broker).

Reference analog: sql/src/main/java/org/apache/druid/sql/http/SqlResource.java
(POST /druid/v2/sql) + QueryMaker (runs the planned native query through
QueryLifecycle and shapes native result sequences back into SQL rows), and
calcite/schema/DruidSchema.java (table discovery from live segments) +
the INFORMATION_SCHEMA tables.
"""
from __future__ import annotations

import logging
import time

from typing import Dict, List, Optional, Sequence, Tuple

from druid_tpu_torch.query.model import (GroupByQuery, ScanQuery,
                                         TimeBoundaryQuery, TimeseriesQuery,
                                         TopNQuery)
from druid_tpu_torch.sql import parser as P
from druid_tpu_torch.sql.parser import Select, Union, parse_sql
from druid_tpu_torch.sql.planner import (OutputColumn, PlannedQuery,
                                         PlannerError, SqlSchema, plan_sql)
from druid_tpu_torch.utils.intervals import ts_to_iso

#: materialized IN-subquery row cap
#: (reference: sql/.../planner/PlannerConfig.java maxSemiJoinRowsInMemory)
MAX_SEMIJOIN_ROWS = 100_000

#: expression AST node types the semi-join rewriter walks
_AST_NODES = (P.Fn, P.Bin, P.Un, P.InExpr, P.LikeExpr, P.BetweenExpr,
              P.IsNullExpr, P.Case, P.Cast, P.SelectItem, P.Lit, P.Col)


class SqlExecutor:
    """Plans SQL against the live segment schema and runs it on a
    QueryExecutor (or any object with .run(query) and .datasources /
    .segments_of)."""

    def __init__(self, query_executor, schema_ttl: float = 30.0,
                 min_refresh_interval: float = 1.0):
        self.qe = query_executor
        self.schema_ttl = schema_ttl
        #: floor between unknown-table-triggered rebuilds — a client
        #: looping on a typo'd table must not reduce the TTL to zero and
        #: hammer historicals with segmentMetadata scatters
        self.min_refresh_interval = min_refresh_interval
        self._schema_cache = None   # (expiry monotonic, SqlSchema)
        self._last_build = 0.0

    # ---- schema discovery (DruidSchema analog) ------------------------
    def schema(self) -> SqlSchema:
        """TTL-cached: remote-broker discovery costs a segmentMetadata
        scatter per datasource; the reference's DruidSchema likewise
        refreshes on a period, not per statement. invalidate_schema()
        forces the next call to rebuild."""
        cached = self._schema_cache
        if cached is not None and time.monotonic() < cached[0]:
            return cached[1]
        schema = self._build_schema()
        self._schema_cache = (time.monotonic() + self.schema_ttl, schema)
        self._last_build = time.monotonic()
        return schema

    def invalidate_schema(self) -> None:
        self._schema_cache = None

    def _plan(self, sel):
        """Plan with one invalidate-and-retry on an unknown table — a
        datasource announced since the last schema refresh must be
        queryable immediately, not after the TTL."""
        try:
            return plan_sql(sel, self.schema())
        except PlannerError as e:
            if "unknown table" in str(e) \
                    and self._schema_cache is not None \
                    and time.monotonic() - self._last_build \
                    >= self.min_refresh_interval:
                self.invalidate_schema()
                return plan_sql(sel, self.schema())
            raise

    def _build_schema(self) -> SqlSchema:
        tables: Dict[str, Dict[str, str]] = {}
        for ds in self.qe.datasources:
            cols: Dict[str, str] = {}
            for seg in self.qe.segments_of(ds):
                for d in seg.dims:
                    cols.setdefault(d, "string")
                for m, col in seg.metrics.items():
                    t = col.type.value if hasattr(col.type, "value") else str(col.type)
                    cols.setdefault(m, t)
            if not cols:
                # no local segment objects (broker over REMOTE nodes):
                # discover via a merged segmentMetadata query — exactly the
                # reference's DruidSchema refresh
                cols = self._metadata_schema(ds)
            tables[ds] = cols
        return SqlSchema(tables)

    def _metadata_schema(self, datasource: str) -> Dict[str, str]:
        from druid_tpu_torch.query.model import SegmentMetadataQuery
        try:
            rows = self.qe.run(SegmentMetadataQuery.of(
                datasource, merge=True, analysis_types=()))
        except Exception:
            # schema stays numeric-default; queries still parse
            logging.getLogger(__name__).debug(
                "segment metadata scan for [%s] failed", datasource,
                exc_info=True)
            return {}
        out: Dict[str, str] = {}
        for analysis in rows:
            for name, info in (analysis.get("columns") or {}).items():
                if name == "__time":
                    continue
                t = str(info.get("type", "STRING")).lower()
                out.setdefault(
                    name, t if t in ("string", "long", "float", "double")
                    else "string")
        return out

    # ---- IN (SELECT ...) materialization (DruidSemiJoin analog) -------
    def _expand_select(self, sel: Select, depth: int = 0) -> Select:
        """Replace every `IN (SELECT ...)` in WHERE/HAVING (and the nested
        FROM subquery) with the inner query's materialized value list."""
        def on_in(node):
            vals, had_null = self._materialize_semijoin(node.subquery, depth)
            if node.negated and had_null:
                # three-valued logic: `x NOT IN (..., NULL)` is never true
                return P.Lit(False, "bool")
            return P.InExpr(_map_expr(node.operand, on_in), vals,
                            node.negated)

        return _map_select(
            sel, on_where=on_in, on_other=_reject_in,
            on_subselect=lambda s: self._expand_select(s, depth))

    def _materialize_semijoin(self, sub: Select, depth: int
                              ) -> Tuple[Tuple[P.Lit, ...], bool]:
        """(literal values, whether the inner result contained NULL)."""
        if depth >= 3:
            raise PlannerError("IN subqueries nested too deeply (max 3)")
        names, rows = self._execute_select(sub, depth + 1)
        if len(names) != 1:
            raise PlannerError(
                f"IN subquery must select exactly one column, got {names}")
        if len(rows) > MAX_SEMIJOIN_ROWS:
            raise PlannerError(
                f"IN subquery returned {len(rows)} rows "
                f"(max {MAX_SEMIJOIN_ROWS})")
        vals, had_null = [], False
        for r in rows:
            v = r[0]
            if v is None:
                had_null = True   # NULL never matches `=`
                continue
            t = "string" if isinstance(v, str) else \
                "double" if isinstance(v, float) else "long"
            vals.append(P.Lit(v, t))
        return tuple(vals), had_null

    # ---- entry points --------------------------------------------------
    def explain(self, sql: str, parameters: Sequence[object] = ()) -> dict:
        stmt = parse_sql(sql, parameters)
        if isinstance(stmt, Union):
            return {"queryType": "unionAll",
                    "arms": [self._explain_select(a) for a in stmt.arms]}
        return self._explain_select(stmt)

    def _explain_select(self, sel: Select) -> dict:
        """EXPLAIN never executes IN-subqueries (the reference's explain
        surface is plan-only): each is planned separately and listed under
        `semiJoinSubPlans`, with an empty IN standing in on the outer plan."""
        sub_plans: List[dict] = []
        sel = self._stub_semijoins(sel, sub_plans)
        planned = self._plan(sel)
        if planned.native is None:
            out = {"queryType": "metadata", "table": planned.meta_table}
        else:
            out = planned.native.to_json()
        if sub_plans:
            out = dict(out)
            out["semiJoinSubPlans"] = sub_plans
        return out

    def _stub_semijoins(self, sel: Select, sub_plans: List[dict]) -> Select:
        def on_in(node):
            sub_plans.append(self._explain_select(node.subquery))
            return P.InExpr(node.operand, (), node.negated)

        return _map_select(
            sel, on_where=on_in, on_other=_reject_in,
            on_subselect=lambda s: self._stub_semijoins(s, sub_plans))

    def execute(self, sql: str, parameters: Sequence[object] = (),
                context: Optional[Dict] = None
                ) -> Tuple[List[str], List[list]]:
        """Returns (column names, rows as lists) — the SQL resource's
        array-result format. `context` (the SQL payload's "context"
        object, reference SqlQuery.context) merges into the planned
        native query's context: queryId, timeout, allowPartialResults
        and the other data-plane flags reach the broker. Semi-join
        INNER subqueries deliberately do NOT inherit it — a silently
        partial inner row set would corrupt the outer result, exactly
        the failure mode allowPartialResults must never cause."""
        stmt = parse_sql(sql, parameters)
        if stmt.explain:
            import json as _json
            planned_json = self.explain(_strip_explain(sql), parameters)
            return (["PLAN"], [[_json.dumps(planned_json, sort_keys=True)]])
        if isinstance(stmt, Union):
            return self._execute_union(stmt, context)
        return self._execute_select(stmt, 0, context)

    def _execute_select(self, sel: Select, depth: int,
                        context: Optional[Dict] = None
                        ) -> Tuple[List[str], List[list]]:
        planned = self._plan(self._expand_select(sel, depth))
        if planned.meta_table is not None:
            return self._run_meta(planned)
        native = planned.native
        if context:
            from dataclasses import replace as _replace
            native = _replace(native, context=tuple(sorted(
                {**native.context_map, **dict(context)}.items())))
        rows = self.qe.run(native)
        cols, shaped = self._shape(planned, rows)
        missing = getattr(rows, "missing_segments", None)
        if missing is not None:
            # a degraded native result (allowPartialResults) stays typed
            # through SQL shaping: the report must reach the SQL client,
            # never vanish into an ordinary row list
            from druid_tpu_torch.cluster.resilience import PartialResult
            shaped = PartialResult(shaped, missing)
        return cols, shaped

    def _execute_union(self, un: Union,
                       context: Optional[Dict] = None
                       ) -> Tuple[List[str], List[list]]:
        """Arms execute independently and concatenate; union-level ORDER
        BY/LIMIT apply to the combined rows; column names come from the
        first arm (reference: DruidUnionRel)."""
        names: Optional[List[str]] = None
        rows: List[list] = []
        missing: List[str] = []
        for arm in un.arms:
            cols, arm_rows = self._execute_select(arm, 0, context)
            if names is None:
                names = cols
            elif len(cols) != len(names):
                raise PlannerError(
                    "UNION ALL arms must select the same number of columns "
                    f"({len(names)} vs {len(cols)})")
            rows.extend(arm_rows)
            missing.extend(getattr(arm_rows, "missing_segments", ()))
        for oi in reversed(un.order_by):
            ix = self._union_order_index(oi, names)
            rows.sort(key=lambda r: _order_key(r[ix]),
                      reverse=oi.descending)
        if un.limit is not None or un.offset:
            rows = rows[un.offset:
                        un.offset + un.limit if un.limit is not None
                        else None]
        if missing:
            # one arm degrading degrades the union — typed, with the
            # combined report
            from druid_tpu_torch.cluster.resilience import PartialResult
            rows = PartialResult(rows, missing)
        return names, rows

    @staticmethod
    def _union_order_index(oi, names: List[str]) -> int:
        e = oi.expr
        if isinstance(e, P.Col) and e.name in names:
            return names.index(e.name)
        if isinstance(e, P.Lit) and isinstance(e.value, int) \
                and 1 <= e.value <= len(names):
            return e.value - 1
        raise PlannerError(
            "UNION ALL ORDER BY must name an output column or ordinal")

    def tables_of(self, sql: str, parameters: Sequence[object] = ()
                  ) -> Tuple[List[str], bool]:
        """(datasources a statement reads, is_information_schema) — the
        authorization surface (reference: SqlResource resource-action
        collection before execution). Purely syntactic: authorization must
        not execute subqueries."""
        stmt = parse_sql(sql, parameters)
        tables: set = set()
        meta = [False]
        arms = stmt.arms if isinstance(stmt, Union) else (stmt,)
        for arm in arms:
            _collect_tables(arm, tables, meta)
        return sorted(tables), meta[0]

    def execute_dicts(self, sql: str, parameters: Sequence[object] = (),
                      context: Optional[Dict] = None
                      ) -> List[dict]:
        cols, rows = self.execute(sql, parameters, context)
        return [dict(zip(cols, r)) for r in rows]

    # ---- result shaping (QueryMaker analog) ---------------------------
    def _shape(self, planned: PlannedQuery, rows) -> Tuple[List[str], List[list]]:
        q = planned.native
        outs = planned.outputs
        names = [o.alias for o in outs]
        table: List[list] = []
        if isinstance(q, TimeseriesQuery):
            # executor-side ORDER BY (non-time orderings of bucket rows);
            # sorts the native rows so non-projected order fields work too
            for fname, desc in reversed(planned.sort_in_executor):
                rows = sorted(rows, key=lambda r, f=fname:
                              (r["result"].get(f) is None,
                               r["result"].get(f) or 0), reverse=desc)
            for r in rows:
                table.append(_emit(outs, r["result"], r["timestamp"]))
            if not table and not q.skip_empty_buckets \
                    and q.granularity.is_all:
                # scalar aggregate whose time bound pruned every segment:
                # still one row of aggregate identities, consistent with the
                # engine's covered-but-empty bucket (COUNT()=0, SUM()=0)
                table.append(_emit(outs, _empty_agg_row(q), None))
        elif isinstance(q, TopNQuery):
            for r in rows:
                for entry in r["result"]:
                    table.append(_emit(outs, entry, r["timestamp"]))
        elif isinstance(q, GroupByQuery):
            for r in rows:
                table.append(_emit(outs, r["event"], r["timestamp"]))
        elif isinstance(q, TimeBoundaryQuery):
            for r in rows:
                table.append([_iso(r["result"].get(o.key)) for o in outs])
        elif isinstance(q, ScanQuery):
            for batch in rows:
                for ev in batch["events"]:
                    table.append(_emit(outs, ev, ev.get("__time")))
        else:
            raise PlannerError(f"cannot shape {type(q).__name__} results")
        if planned.limit_in_executor is not None or planned.offset_in_executor:
            off = planned.offset_in_executor
            lim = planned.limit_in_executor
            table = table[off:off + lim if lim is not None else None]
        return names, table

    # ---- INFORMATION_SCHEMA -------------------------------------------
    def _run_meta(self, planned: PlannedQuery) -> Tuple[List[str], List[list]]:
        sel = planned.meta_select
        schema = self.schema()
        if planned.meta_table == "SCHEMATA":
            data = [{"CATALOG_NAME": "druid", "SCHEMA_NAME": s}
                    for s in ("druid", "INFORMATION_SCHEMA")]
        elif planned.meta_table == "TABLES":
            data = [{"TABLE_CATALOG": "druid", "TABLE_SCHEMA": "druid",
                     "TABLE_NAME": t, "TABLE_TYPE": "TABLE"}
                    for t in sorted(schema.tables)]
        elif planned.meta_table == "COLUMNS":
            data = []
            for t in sorted(schema.tables):
                cols = [("__time", "TIMESTAMP")] + sorted(
                    (c, _sql_type(ty)) for c, ty in schema.tables[t].items())
                for i, (c, ty) in enumerate(cols):
                    data.append({"TABLE_CATALOG": "druid",
                                 "TABLE_SCHEMA": "druid", "TABLE_NAME": t,
                                 "COLUMN_NAME": c, "ORDINAL_POSITION": i + 1,
                                 "DATA_TYPE": ty,
                                 "IS_NULLABLE": "YES" if ty == "VARCHAR" else "NO"})
        else:
            raise PlannerError(
                f"unknown INFORMATION_SCHEMA table [{planned.meta_table}]")
        return _meta_select(sel, data)


def _map_expr(node, on_in):
    """Bottom-up expression-AST rewrite; `on_in` handles (and replaces)
    every `IN (SELECT ...)` node. The single walker behind semi-join
    expansion, EXPLAIN stubbing and table collection."""
    import dataclasses
    if isinstance(node, P.InExpr) and node.subquery is not None:
        return on_in(node)
    if isinstance(node, _AST_NODES):
        changes = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, _AST_NODES):
                nv = _map_expr(v, on_in)
            elif isinstance(v, tuple):
                nv = tuple(tuple(_map_expr(y, on_in) for y in x)
                           if isinstance(x, tuple) else _map_expr(x, on_in)
                           for x in v)
                if nv == v:
                    continue
            else:
                continue
            if nv is not v:
                changes[f.name] = nv
        return dataclasses.replace(node, **changes) if changes else node
    return node


def _map_select(sel: Select, on_where, on_other, on_subselect) -> Select:
    """Map every expression position of ONE Select: `on_where` handles
    IN-subqueries in WHERE, `on_other` those in select items / GROUP BY /
    HAVING / ORDER BY, `on_subselect` the nested FROM subquery."""
    import dataclasses
    changes = {}
    if sel.subquery is not None:
        sub = on_subselect(sel.subquery)
        if sub is not sel.subquery:
            changes["subquery"] = sub
    if sel.where is not None:
        ne = _map_expr(sel.where, on_where)
        if ne is not sel.where:
            changes["where"] = ne
    if sel.having is not None:
        ne = _map_expr(sel.having, on_other)
        if ne is not sel.having:
            changes["having"] = ne
    items = tuple(_map_expr(it, on_other) for it in sel.items)
    if items != sel.items:
        changes["items"] = items
    gb = tuple(_map_expr(e, on_other) for e in sel.group_by)
    if gb != sel.group_by:
        changes["group_by"] = gb
    ob = []
    for o in sel.order_by:
        ne = _map_expr(o.expr, on_other)
        ob.append(dataclasses.replace(o, expr=ne) if ne is not o.expr else o)
    if tuple(ob) != sel.order_by:
        changes["order_by"] = tuple(ob)
    return dataclasses.replace(sel, **changes) if changes else sel


def _reject_in(node):
    raise PlannerError(
        "IN (SELECT ...) is only supported in WHERE — not in select items, "
        "GROUP BY, HAVING or ORDER BY")


def _empty_agg_row(q) -> dict:
    """Aggregate identities for a zero-row scalar result — the SAME
    kernel empty states the engine emits for a covered-but-empty bucket
    (engines.finish_timeseries empty_defaults), so both zero-row paths
    agree for every aggregator type."""
    from druid_tpu_torch.cluster.wire import rebuild_kernels
    kernels = rebuild_kernels([a.to_json() for a in q.aggregations])
    fields = {}
    for k in kernels:
        v = k.finalize_array(k.empty_state(1))[0]
        fields[k.spec.name] = v.item() if hasattr(v, "item") else v
    for pa in q.post_aggregations:
        try:
            fields[pa.name] = pa.compute(fields)
        except Exception:
            # SQL NULL on an uncomputable post-agg (reference behavior)
            logging.getLogger(__name__).debug(
                "post-aggregator [%s] failed on empty-result fields",
                pa.name, exc_info=True)
            fields[pa.name] = None
    return fields


def _order_key(v):
    """Mixed-type sort key for union-level ORDER BY: NULLs first, then
    numbers, then strings."""
    if v is None:
        return (0, 0.0, "")
    if isinstance(v, bool):
        return (1, float(v), "")
    if isinstance(v, (int, float)):
        return (1, float(v), "")
    return (2, 0.0, str(v))


def _collect_tables(sel: Select, out: set, meta: List[bool]) -> None:
    """Syntactic datasource collection over FROM, nested FROM subqueries
    and IN-subqueries in EVERY expression position — the authorization
    surface must over-collect, never miss a table."""
    if sel.schema is not None:
        meta[0] = True
    elif sel.subquery is None and sel.table:
        out.add(sel.table)

    def on_in(node):
        _collect_tables(node.subquery, out, meta)
        return node

    def recurse(sub):
        _collect_tables(sub, out, meta)
        return sub

    _map_select(sel, on_where=on_in, on_other=on_in, on_subselect=recurse)


def _strip_explain(sql: str) -> str:
    import re
    return re.sub(r"(?is)^\s*EXPLAIN\s+PLAN\s+FOR\s+", "", sql)


def _sql_type(t: str) -> str:
    return {"string": "VARCHAR", "long": "BIGINT", "float": "FLOAT",
            "double": "DOUBLE"}.get(t, t.upper())


def _iso(v):
    return ts_to_iso(v) if v is not None else None


def _emit(outs: List[OutputColumn], fields: dict, ts) -> list:
    row = []
    for o in outs:
        if o.kind == "time":
            row.append(_iso(ts))
        elif o.kind == "constant":
            row.append(o.constant)
        elif o.kind == "column" and o.key == "__time":
            row.append(_iso(fields.get("__time", ts)))
        else:
            row.append(fields.get(o.key))
    return row


def _meta_select(sel: Select, data: List[dict]) -> Tuple[List[str], List[list]]:
    """Evaluate a (restricted) select over an in-memory metadata table:
    column projections, simple equality/IN where, ORDER BY columns, LIMIT."""
    from druid_tpu_torch.sql import parser as P

    def match(row, e) -> bool:
        if e is None:
            return True
        if isinstance(e, P.Bin) and e.op == "AND":
            return match(row, e.left) and match(row, e.right)
        if isinstance(e, P.Bin) and e.op == "OR":
            return match(row, e.left) or match(row, e.right)
        if isinstance(e, P.Un) and e.op == "NOT":
            return not match(row, e.operand)
        if isinstance(e, P.Bin) and e.op in ("=", "<>"):
            l, r = e.left, e.right
            if isinstance(r, P.Col):
                l, r = r, l
            if isinstance(l, P.Col) and isinstance(r, P.Lit):
                eq = str(row.get(l.name)) == str(r.value)
                return eq if e.op == "=" else not eq
        if isinstance(e, P.InExpr) and isinstance(e.operand, P.Col):
            hit = str(row.get(e.operand.name)) in {str(v.value) for v in e.values}
            return hit != e.negated
        if isinstance(e, P.LikeExpr) and isinstance(e.operand, P.Col):
            import re as _re
            pat = "^" + "".join(
                ".*" if ch == "%" else "." if ch == "_" else _re.escape(ch)
                for ch in str(e.pattern.value)) + "$"
            hit = bool(_re.match(pat, str(row.get(e.operand.name, ""))))
            return hit != e.negated
        raise PlannerError("unsupported WHERE on INFORMATION_SCHEMA")

    rows = [r for r in data if match(r, sel.where)]
    if sel.order_by:
        for ob in reversed(sel.order_by):
            if not isinstance(ob.expr, P.Col):
                raise PlannerError("ORDER BY columns only on INFORMATION_SCHEMA")
            rows.sort(key=lambda r: str(r.get(ob.expr.name)),
                      reverse=ob.descending)
    if sel.limit is not None:
        rows = rows[sel.offset:sel.offset + sel.limit]
    elif sel.offset:
        rows = rows[sel.offset:]

    if len(sel.items) == 1 and isinstance(sel.items[0].expr, P.Star):
        names = keys = list(data[0].keys()) if data else []
    else:
        names, keys = [], []
        for it in sel.items:
            if not isinstance(it.expr, P.Col):
                raise PlannerError("INFORMATION_SCHEMA projections are columns")
            names.append(it.alias or it.expr.name)
            keys.append(it.expr.name)
    return names, [[r.get(k) for k in keys] for r in rows]
