"""floatSum over a column that is not FLOAT: a divergence on purpose.

The column is a LONG or DOUBLE metric, or a virtual column that computes
int64 or float64. Wherever the reference's plan takes its blocked
reduction (the blocked strategy, or the mixed hybrid at G <= 2048), it
raises TypeError: its SumKernel.blocked_step adds a float64 part to a
float32 carry inside lax.scan. The port's blocked step sums the column, so
the port answers. The test holds the reference to its TypeError there, and
the port's rows to numpy's sums of the values cast to float32, within
1e-5 * sum|v| per group, alone and batched; where the reference answers
(dimB x dimA, G above the blocked limit), to the reference's rows as well.
Two segments of 4,000 rows (the reference's DataGenerator, seed 7),
carried into the port as plain arrays.
"""
import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.engine import grouping as ref_grouping
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import batching
from druid_tpu_torch.engine import grouping as port_grouping
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

IV = "2026-07-01/2026-07-02"
SCHEMA = (
    ColumnSpec("dimA", "string", cardinality=20),
    ColumnSpec("dimB", "string", cardinality=300, distribution="zipf"),
    ColumnSpec("metLong", "long", low=-500, high=9_000),
    ColumnSpec("metDouble", "double", low=-10.0, high=10.0),
)
#: field -> (virtual columns, the values numpy sums, from a segment)
FIELDS = {
    "metLong": ([], lambda s: s.metrics["metLong"].values),
    "metDouble": ([], lambda s: s.metrics["metDouble"].values),
    "vl": ([{"type": "expression", "name": "vl",
             "expression": "metLong * 3", "outputType": "long"}],
           lambda s: s.metrics["metLong"].values * 3),
    "vd": ([{"type": "expression", "name": "vd",
             "expression": "metLong * 0.5", "outputType": "double"}],
           lambda s: s.metrics["metLong"].values * 0.5),
}


@pytest.fixture(scope="module")
def segs():
    ref = DataGenerator(SCHEMA, seed=7).segments(2, 4_000, Interval.parse(IV),
                                                 datasource="ds")
    return ref, [_carry(s) for s in ref]


def _query(field, dims, batched):
    vcs, _ = FIELDS[field]
    return {"queryType": "groupBy", "dataSource": "ds", "intervals": [IV],
            "granularity": "all", "dimensions": dims, "virtualColumns": vcs,
            "aggregations": [{"type": "count", "name": "n"},
                             {"type": "floatSum", "name": "fs",
                              "fieldName": field}],
            "context": {"batchSegments": batched}}


def _numpy(ref, field, dims):
    """{group: (count, sum of float32-cast values, sum |v|)}."""
    out = {}
    for s in ref:
        vals = FIELDS[field][1](s).astype(np.float32).astype(np.float64)
        keys = list(zip(*[np.asarray(s.dims[d].dictionary.values)[
            s.dims[d].ids] for d in dims]))
        for k, v in zip(keys, vals):
            n, t, a = out.get(k, (0, 0.0, 0.0))
            out[k] = (n + 1, t + v, a + abs(v))
    return out


def _check(rows, want, dims):
    assert len(rows) == len(want)
    for r in rows:
        e = r["event"]
        n, t, a = want[tuple(e[d] for d in dims)]
        assert e["n"] == n
        assert abs(e["fs"] - t) <= 1e-5 * a, (e, t)


@pytest.mark.parametrize("batched", [False, True], ids=["alone", "batched"])
@pytest.mark.parametrize("force", [None, "blocked"],
                         ids=["hybrid", "blocked"])
@pytest.mark.parametrize("field", sorted(FIELDS))
def test_float_sum_where_the_reference_raises(segs, field, force, batched,
                                              monkeypatch):
    ref, port = segs
    monkeypatch.setattr(ref_grouping, "FORCE_STRATEGY", force)
    monkeypatch.setattr(port_grouping, "FORCE_STRATEGY", force)
    q = _query(field, ["dimA"], batched)
    with pytest.raises(TypeError, match="carry"):
        RefExecutor(ref).run_json(q)
    before = batching.stats().snapshot()["batches"]
    rows = PortExecutor(port, device="cpu").run_json(q)
    assert (batching.stats().snapshot()["batches"] > before) == batched
    _check(rows, _numpy(ref, field, ["dimA"]), ["dimA"])


@pytest.mark.parametrize("batched", [False, True], ids=["alone", "batched"])
@pytest.mark.parametrize("field", sorted(FIELDS))
def test_float_sum_where_the_reference_answers(segs, field, batched):
    ref, port = segs
    dims = ["dimB", "dimA"]
    q = _query(field, dims, batched)
    want = RefExecutor(ref).run_json(q)
    got = PortExecutor(port, device="cpu").run_json(q)
    truth = _numpy(ref, field, dims)
    _check(got, truth, dims)
    _check(want, truth, dims)
    for r, p in zip(want, got):
        assert r["event"]["n"] == p["event"]["n"]
        a = truth[tuple(r["event"][d] for d in dims)][2]
        assert abs(r["event"]["fs"] - p["event"]["fs"]) <= 2e-5 * a
