"""Query execution: planning, grouped reduction, merge, engines.

`QueryExecutor` loads on first use, so that the data modules can import
`engine.contracts` without importing the whole engine."""

__all__ = ["QueryExecutor", "release_device_caches"]


def __getattr__(name):
    if name == "QueryExecutor":
        from druid_tpu_torch.engine.executor import QueryExecutor
        return QueryExecutor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def release_device_caches(clear_pool: bool = False) -> dict:
    """Drop every process-wide cache that holds device memory, or what
    builds on it, across queries: the mesh's stacked segment sets (and the
    segment objects each entry pins), the built stacked runs (the batched
    path's and the mesh's shards', one cache), and with `clear_pool=True`
    every entry of the device pool. Reclaims the card's memory without a
    restart; returns the count dropped from each."""
    from druid_tpu_torch.engine import batching
    from druid_tpu_torch.parallel import distributed

    out = {"stack_entries": distributed.clear_stack_cache(),
           "stacked_programs": batching.clear_program_cache()}
    if clear_pool:
        from druid_tpu_torch.data.devicepool import device_pool
        pool = device_pool()
        out["pool_resident_bytes"] = pool.snapshot().resident_bytes
        pool.clear()
    return out
