"""The port's non-default dimension specs against the reference package:
extraction dimensions (every extraction-fn type, registeredLookup through
each package's own lookup registry), listFiltered (white- and blacklist),
expression dimensions (long, double and string outputs, a string dimension
compared inside) and numeric dimensions (a LONG and a FLOAT column), on
groupBy and topN, through both `QueryExecutor`s on the CPU. Rows must be
equal. `unify_query_dims` over segments whose value sets differ gives the
reference's shared id space; an extraction dimension takes the reference's
strategies, the projection and the run domain among them.
"""
import json

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.dictionary import Dictionary
from druid_tpu.data.generator import ColumnSpec, DataGenerator
from druid_tpu.data.segment import StringDimColumn
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.engine import engines as ref_engines
from druid_tpu.engine import grouping as ref_grouping
from druid_tpu.engine import pallas_agg
from druid_tpu.query import lookup as ref_lookup
from druid_tpu.query.model import query_from_json as ref_query_json
from druid_tpu.utils.intervals import Interval

from druid_tpu_torch.data import cascade as port_cascade
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.engine import engines as port_engines
from druid_tpu_torch.engine import grouping as port_grouping
from druid_tpu_torch.query import lookup as port_lookup
from druid_tpu_torch.query.model import query_from_json as port_query_json
from tests.test_torch_run_domain import _pair, _rollup
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

IV = "2026-07-01/2026-07-02"
SCHEMA = (
    ColumnSpec("dimA", "string", cardinality=20),
    ColumnSpec("dimB", "string", cardinality=300, distribution="zipf"),
    ColumnSpec("metLong", "long", low=-500, high=9_000),
    ColumnSpec("metFloat", "float", distribution="normal", mean=10.0,
               std=400.0),
)
#: dictionary of the `when` dimension: timestamps, epoch millis, junk
WHEN = sorted(["2026-07-01T00:00:00.000Z", "2026-07-01T06:30:00.000Z",
               "2026-07-02T23:59:59.000Z", "2025-12-31T12:00:00.000Z",
               "1782864000000", "not a time"])
LOOKUP = {f"v{i:08d}": f"L{i % 4}" for i in range(0, 20, 3)}


@pytest.fixture(scope="module")
def segs():
    ref = DataGenerator(SCHEMA, seed=23).segments(
        2, 3_000, Interval.parse(IV), datasource="dsp")
    rng = np.random.default_rng(3)
    for i, s in enumerate(ref):
        s.dims["when"] = StringDimColumn(
            rng.integers(0, len(WHEN), s.n_rows).astype(np.int32),
            Dictionary(WHEN))
        # metLong % 50 as a LONG column: few values, differing by segment
        s.metrics["small"] = type(s.metrics["metLong"])(
            (s.metrics["metLong"].values % 50) + 100 * i,
            s.metrics["metLong"].type)
    return ref, [_carry(s) for s in ref]


@pytest.fixture(scope="module", autouse=True)
def registered_lookup():
    ref_lookup.register_lookup("dimspec_test", LOOKUP)
    port_lookup.register_lookup("dimspec_test", LOOKUP)
    yield
    ref_lookup.lookup_manager().remove("dimspec_test")
    port_lookup.lookup_manager().remove("dimspec_test")


def _extraction(dim, fn, name="x"):
    return {"type": "extraction", "dimension": dim, "outputName": name,
            "extractionFn": fn}


EXTRACTION_FNS = {
    "substring": ("dimB", {"type": "substring", "index": 5, "length": 3}),
    "substring-past-end": ("dimA", {"type": "substring", "index": 8}),
    "regex": ("dimB", {"type": "regex", "expr": "v0*([1-9][0-9]?)"}),
    "regex-missing": ("dimB", {"type": "regex", "expr": "(7)$",
                               "replaceMissingValue": True,
                               "replaceMissingValueWith": "none"}),
    "upper": ("dimA", {"type": "upper"}),
    "lower": ("when", {"type": "lower"}),
    "lookup": ("dimA", {"type": "lookup", "lookup": {
        "type": "map", "map": LOOKUP}, "retainMissingValue": False,
        "replaceMissingValueWith": "other"}),
    "lookup-retain": ("dimA", {"type": "lookup", "lookup": {
        "type": "map", "map": LOOKUP}, "retainMissingValue": True}),
    "strlen": ("when", {"type": "strlen"}),
    "stringFormat": ("dimA", {"type": "stringFormat", "format": "<%s>"}),
    "timeFormat": ("when", {"type": "timeFormat", "format": "yyyy-MM dd"}),
    "timeFormat-day": ("when", {"type": "timeFormat", "granularity": "day"}),
    "cascade": ("dimB", {"type": "cascade", "extractionFns": [
        {"type": "substring", "index": 6}, {"type": "regex",
                                            "expr": "^(.)"}]}),
    "registeredLookup": ("dimA", {"type": "registeredLookup",
                                  "lookup": "dimspec_test",
                                  "retainMissingValue": True}),
    "numeric-substring": ("small", {"type": "substring", "index": 0,
                                    "length": 1}),
}

DIMSPECS = {
    **{f"extraction-{k}": _extraction(d, fn)
       for k, (d, fn) in EXTRACTION_FNS.items()},
    "listFiltered-white": {"type": "listFiltered", "delegate": "dimA",
                           "values": ["v00000001", "v00000004", "nope"]},
    "listFiltered-black": {"type": "listFiltered", "delegate": "dimB",
                           "values": ["v00000000", "v00000001"],
                           "isWhitelist": False},
    "listFiltered-extraction": {
        "type": "listFiltered", "values": ["L0", "L2"],
        "delegate": _extraction("dimA", EXTRACTION_FNS["lookup"][1])},
    "expression-long": {"type": "expression", "outputName": "x",
                        "expression": "div(metLong, 1000)"},
    "expression-double": {"type": "expression", "outputName": "x",
                          "outputType": "double",
                          "expression": "round(metFloat / 100) * 0.5"},
    "expression-string": {"type": "expression", "outputName": "x",
                          "outputType": "string",
                          "expression": "if(dimA == 'v00000002', 1, "
                                        "metLong % 3)"},
    "expression-time": {"type": "expression", "outputName": "x",
                        "expression": "timestamp_extract(__time, 'HOUR')"},
    "numeric-long": "small",
    "numeric-float": {"type": "default", "dimension": "metFloat",
                      "outputName": "x"},
}


def _groupby(dims, flt=None):
    return {"queryType": "groupBy", "dataSource": "dsp", "intervals": [IV],
            "granularity": "all", "dimensions": dims, "filter": flt,
            "aggregations": [{"type": "count", "name": "rows"},
                             {"type": "longSum", "name": "lsum",
                              "fieldName": "metLong"}]}


def _same(a, b):
    """Equal rows, value types and float bits (NaN included)."""
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


@pytest.mark.parametrize("name", sorted(DIMSPECS))
def test_groupby_dimension_spec_matches_reference(segs, name):
    ref, port = segs
    for dims in ([DIMSPECS[name]], [DIMSPECS[name], "dimA"]):
        q = _groupby(dims)
        want = RefExecutor(ref).run_json(q)
        got = PortExecutor(port, device="cpu").run_json(q)
        assert want
        _same(got, want)


@pytest.mark.parametrize("name", ["extraction-substring", "extraction-lookup",
                                  "listFiltered-black", "expression-long",
                                  "numeric-long"])
def test_topn_dimension_spec_matches_reference(segs, name):
    ref, port = segs
    q = {"queryType": "topN", "dataSource": "dsp", "intervals": [IV],
         "granularity": "all", "dimension": DIMSPECS[name],
         "metric": "lsum", "threshold": 7,
         "filter": {"type": "search", "dimension": "dimB",
                    "query": {"type": "contains", "value": "1"}},
         "aggregations": [{"type": "count", "name": "rows"},
                          {"type": "longSum", "name": "lsum",
                           "fieldName": "metLong"}]}
    want = RefExecutor(ref).run_json(q)
    got = PortExecutor(port, device="cpu").run_json(q)
    assert want and want[0]["result"]
    _same(got, want)


def test_unify_query_dims_matches_reference(segs):
    """Numeric and expression dimensions over 2 segments whose value sets
    differ: one shared id space, the reference's ids and decode lists."""
    ref, port = segs
    q = _groupby([DIMSPECS["numeric-long"], DIMSPECS["expression-double"],
                  "dimA"])
    rq, pq = ref_query_json(q), port_query_json(q)
    rk, rv = ref_engines._keydims_for_query(rq, ref)
    pk, pv = port_engines._keydims_for_query(pq, port)
    assert pv == rv
    assert rv[0][0] != sorted(set(ref[0].metrics["small"].values.tolist()))
    for rks, pks in zip(rk, pk):
        for r, p in zip(rks, pks):
            assert (p.column, p.cardinality) == (r.column, r.cardinality)
            assert (p.host_ids is None) == (r.host_ids is None)
            if r.host_ids is not None:
                np.testing.assert_array_equal(p.host_ids, r.host_ids)


@pytest.mark.parametrize("force", [None, "mm", "blocked", "projection",
                                   "mixed"], ids=lambda f: f or "natural")
def test_extraction_dims_under_each_strategy(segs, force, monkeypatch):
    """An extraction x listFiltered x numeric groupBy (remaps, a dropped
    value, derived ids) with the projection's row floor at 0."""
    ref, port = segs
    monkeypatch.setattr(ref_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(port_grouping, "PROJECTION_MIN_ROWS", 0)
    monkeypatch.setattr(pallas_agg, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(ref_grouping, "FORCE_STRATEGY", force)
    monkeypatch.setattr(port_grouping, "FORCE_STRATEGY", force)
    q = _groupby([DIMSPECS["extraction-substring"],
                  DIMSPECS["listFiltered-black"]],
                 {"type": "bound", "dimension": "metLong", "lower": "0",
                  "ordering": "numeric"})
    q["dimensions"][1] = dict(q["dimensions"][1], delegate={
        "type": "default", "dimension": "dimB", "outputName": "b"})
    want = RefExecutor(ref).run_json(q)
    got = PortExecutor(port, device="cpu").run_json(q)
    assert want
    _same(got, want)


def test_extraction_dim_in_run_space():
    """Rollup-order segments: an extraction dimension groups in run space
    (its remap applied per run) in both packages, with the same rows."""
    ref, port = _pair(_rollup(2, rows=4096, seed=5))
    q = {"queryType": "groupBy", "dataSource": "rd",
         "intervals": ["2026-01-01/2026-01-02"], "granularity": "all",
         "dimensions": [_extraction("d0", {
             "type": "lookup", "lookup": {"type": "map", "map": {
                 "d0_001": "a", "d0_002": "a", "d0_005": "b"}},
             "retainMissingValue": False}, "e"), "d1"],
         "aggregations": [{"type": "count", "name": "n"},
                          {"type": "longSum", "name": "s",
                           "fieldName": "m1"}]}
    before = port_cascade.code_domain_stats().snapshot()["hits"]
    want = RefExecutor(ref).run_json(q)
    got = PortExecutor(port, device="cpu").run_json(q)
    assert port_cascade.code_domain_stats().snapshot()["hits"] \
        == before + 2
    _same(got, want)
    assert {r["event"]["e"] for r in got} == {"a", "b", ""}


def test_unknown_dimension_spec_raises():
    for parse in (ref_query_json, port_query_json):
        with pytest.raises(ValueError):
            parse(_groupby([{"type": "nosuch", "dimension": "dimA"}]))


def test_registered_lookup_replaced_by_a_newer_version(segs):
    """A lookup re-registered under a newer version re-keys the cached id
    remap (its version joins the extraction fn's cache key); an older
    version does not replace it. Rows follow the reference's registry."""
    ref, port = segs
    q = _groupby([_extraction("dimA", {"type": "registeredLookup",
                                       "lookup": "dimspec_versioned",
                                       "retainMissingValue": True})])
    try:
        for version, mapping in (("v1", {"v00000002": "two"}),
                                 ("v2", {"v00000002": "deux",
                                         "v00000005": "cinq"}),
                                 ("v10", {"v00000005": "five"}),
                                 ("v9", {"v00000001": "stale"})):
            for mod in (ref_lookup, port_lookup):
                mod.register_lookup("dimspec_versioned", mapping, version)
            want = RefExecutor(ref).run_json(q)
            got = PortExecutor(port, device="cpu").run_json(q)
            _same(got, want)
        values = {r["event"]["x"] for r in got}
        assert "five" in values and "stale" not in values
    finally:
        ref_lookup.lookup_manager().remove("dimspec_versioned")
        port_lookup.lookup_manager().remove("dimspec_versioned")


@pytest.mark.parametrize("shape", ["numeric-dim", "virtual-column"])
def test_run_space_refuses_derived_ids_and_virtual_columns(shape):
    """Rollup-order segments the run domain would serve, with a numeric
    dimension (derived host ids) or a virtual column added: both packages
    refuse run space and take the row program; the rows are equal."""
    ref, port = _pair(_rollup(2, rows=4096, seed=6))
    q = {"queryType": "groupBy", "dataSource": "rd",
         "intervals": ["2026-01-01/2026-01-02"], "granularity": "all",
         "dimensions": ["d0"],
         "aggregations": [{"type": "count", "name": "n"},
                          {"type": "longSum", "name": "s",
                           "fieldName": "m1"}]}
    before = port_cascade.code_domain_stats().snapshot()["hits"]
    PortExecutor(port, device="cpu").run_json(q)
    assert port_cascade.code_domain_stats().snapshot()["hits"] \
        == before + 2, "without them, both segments run in run space"
    q = dict(q, aggregations=list(q["aggregations"]))
    if shape == "numeric-dim":
        q["dimensions"] = ["d0", "m0"]
    else:
        q["virtualColumns"] = [{"type": "expression", "name": "v",
                                "expression": "m1 * 2",
                                "outputType": "long"}]
        q["aggregations"].append({"type": "longSum", "name": "vs",
                                  "fieldName": "v"})
    before = port_cascade.code_domain_stats().snapshot()["hits"]
    want = RefExecutor(ref).run_json(q)
    got = PortExecutor(port, device="cpu").run_json(q)
    assert port_cascade.code_domain_stats().snapshot()["hits"] == before
    assert want
    _same(got, want)
