"""The port's sharded run is bit-identical to its meshless run and to the
reference's mesh run, for the exact aggregators.

tests/test_sharded_parity.py, in process: 11 segments on 8 CPU shards (K
pads to 16, so the padding segments' all-invalid rows are part of what
parity covers), a groupBy, a timeseries and a topN with count, longSum,
longMin, doubleMax and doubleMin, whose merges (int64 sums, max, min) do
not depend on order: the rows compare with `==`, floats included. The mesh
run makes exactly one sharded dispatch per query and no batched or
per-segment one, and its stack is resident in the device pool. The
reference's packed/cascade switches are import-time environment latches,
hence its subprocesses; the port's is `packed.set_enabled`, flipped here in
process: parity does not depend on it.
"""
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.parallel import make_mesh as ref_make_mesh
from druid_tpu.parallel import use_mesh as ref_use_mesh
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.data import devicepool, packed
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import batching, engines
from druid_tpu_torch.obs import dispatch
from druid_tpu_torch.parallel import distributed, make_mesh
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

IV = "2026-03-01/2026-03-09"
SCHEMA = (ColumnSpec("dimA", "string", cardinality=7),
          ColumnSpec("dimB", "string", cardinality=31),
          ColumnSpec("metLong", "long", low=0, high=1000),
          ColumnSpec("metDouble", "double", low=-5.0, high=5.0))
AGGS = [{"type": "count", "name": "rows"},
        {"type": "longSum", "name": "lsum", "fieldName": "metLong"},
        {"type": "longMin", "name": "lmin", "fieldName": "metLong"},
        {"type": "doubleMax", "name": "dmax", "fieldName": "metDouble"},
        {"type": "doubleMin", "name": "dmin", "fieldName": "metDouble"}]
FLT = {"type": "in", "dimension": "dimA",
       "values": [f"v{i:08d}" for i in range(5)]}
QUERIES = {
    "groupby": {"queryType": "groupBy", "dataSource": "parity",
                "intervals": [IV], "granularity": "day",
                "dimensions": ["dimA", "dimB"], "aggregations": AGGS,
                "filter": FLT},
    "timeseries": {"queryType": "timeseries", "dataSource": "parity",
                   "intervals": [IV], "granularity": "day",
                   "aggregations": AGGS,
                   "filter": {"type": "bound", "dimension": "metLong",
                              "lower": "10", "upper": "900",
                              "ordering": "numeric"}},
    "topn": {"queryType": "topN", "dataSource": "parity", "intervals": [IV],
             "granularity": "all", "dimension": "dimB", "metric": "lsum",
             "threshold": 10, "aggregations": AGGS, "filter": FLT},
}


@pytest.fixture(scope="module")
def data():
    ref = DataGenerator(SCHEMA, seed=23).segments(
        11, 2000, Interval.parse(IV), datasource="parity")
    with ref_use_mesh(ref_make_mesh(8)):
        want = {n: RefExecutor(ref).run_json(q) for n, q in QUERIES.items()}
    return [_carry(s) for s in ref], want


@pytest.mark.parametrize("packing", [True, False], ids=["packed", "dense"])
def test_sharded_bit_identical(data, packing, monkeypatch):
    port, want = data
    prev = packed.set_enabled(packing)
    try:
        plain = {n: PortExecutor(port, device="cpu").run_json(q)
                 for n, q in QUERIES.items()}
        calls = {"batched": 0, "per_segment": 0}
        orig = batching.run_with_batching

        def count_batch(*a, **k):
            calls["batched"] += 1
            return orig(*a, **k)

        def per_segment(*a, **k):
            calls["per_segment"] += 1
            raise AssertionError("per-segment run on the sharded path")
        monkeypatch.setattr(batching, "run_with_batching", count_batch)
        monkeypatch.setattr(engines, "run_grouped_aggregate", per_segment)
        before = distributed.sharded_stats().snapshot()
        kinds = dispatch.stats().snapshot()
        ex = PortExecutor(port, device="cpu", mesh=make_mesh(8, device="cpu"))
        got = {n: ex.run_json(q) for n, q in QUERIES.items()}
        after = distributed.sharded_stats().snapshot()
        kinds_after = dispatch.stats().snapshot()
    finally:
        packed.set_enabled(prev)
    assert calls == {"batched": 0, "per_segment": 0}
    assert after[0] - before[0] == len(QUERIES)
    assert after[1] - before[1] == len(QUERIES) * len(port)
    for kind in ("segment", "batched", "runDomain"):
        assert kinds_after.get(kind, 0) == kinds.get(kind, 0), kind
    assert kinds_after["sharded"] - kinds.get("sharded", 0) == len(QUERIES)
    assert devicepool.device_pool().snapshot().stacked_entries >= 1
    for name in QUERIES:
        assert len(want[name]) > 0, name
        assert got[name] == want[name], name    # floats included
        assert got[name] == plain[name], name
