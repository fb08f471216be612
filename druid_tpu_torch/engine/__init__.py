"""Query execution: planning, grouped reduction, merge, engines.

`QueryExecutor` loads on first use, so that the data modules can import
`engine.contracts` without importing the whole engine."""

__all__ = ["QueryExecutor"]


def __getattr__(name):
    if name == "QueryExecutor":
        from druid_tpu_torch.engine.executor import QueryExecutor
        return QueryExecutor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
