"""Query execution: planning, grouped reduction, merge, engines."""
from druid_tpu_torch.engine.executor import QueryExecutor

__all__ = ["QueryExecutor"]
