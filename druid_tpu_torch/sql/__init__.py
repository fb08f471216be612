"""SQL layer: parser → planner → native queries (reference: sql/ module,
Calcite-based DruidPlanner → DruidQuery → native query types).

The port's own copy of the reference package's `sql/`: a self-contained
recursive-descent SQL parser and a direct planner that picks the native
query type exactly like DruidQuery.toDruidQuery (sql/.../calcite/rel/
DruidQuery.java): scan for non-aggregate selects, timeseries for
time-bucketed aggregates, topN for single-dimension ordered-limited
aggregates, groupBy otherwise. The planned queries are the port's query
objects and run on its QueryExecutor or Broker.
"""
from druid_tpu_torch.sql.executor import SqlExecutor
from druid_tpu_torch.sql.parser import parse_sql
from druid_tpu_torch.sql.planner import PlannerError, plan_sql

__all__ = ["SqlExecutor", "parse_sql", "plan_sql", "PlannerError"]
