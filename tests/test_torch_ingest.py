"""The port's ingestion layer (druid_tpu_torch/ingest/: parsers and
firehoses, the IncrementalIndex, merge_segments) against the reference
package's, on the CPU.

Every case of tests/test_ingest.py runs through BOTH packages with the
same rows, made from a seed with numpy: the reference's assertions hold on
the port, and the port's snapshot equals the reference's column for column
(time, dictionaries, ids and metric bits: the rollup is the same host numpy
in both). Queries over the snapshots run through the reference's
QueryExecutor and the port's (device "cpu"); counts, long sums and min/max
equal bit for bit, float sums within 1e-5 * sum|v| (their inputs here are
non-negative, so sum|v| is the sum). Then the two cases of
tests/test_representations.py, the cross-package identity of the index and
of the persisted hydrant's V2 bytes, and merge_segments in both packages.

The reference's two mesh cases run each package with and without its mesh
(the reference's 8 virtual CPU devices, the port's 8 CPU shards): a complex
column and a dtype mismatch keep both off the sharded run, and the four
runs agree.
"""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
import druid_tpu.ingest as r_ingest
import druid_tpu.ingest.input as r_input
import druid_tpu.query.aggregators as r_aggs
import druid_tpu.query.filters as r_filters
import druid_tpu.query.model as r_model
from druid_tpu.data import segment as r_segment
from druid_tpu.engine import QueryExecutor as RefExecutor
from druid_tpu.utils.intervals import Interval as RInterval

import druid_tpu_torch.ingest as p_ingest
import druid_tpu_torch.ingest.input as p_input
import druid_tpu_torch.query.aggregators as p_aggs
import druid_tpu_torch.query.filters as p_filters
import druid_tpu_torch.query.model as p_model
from druid_tpu_torch.data import segment as p_segment
from druid_tpu_torch.engine import QueryExecutor as PortExecutor
from druid_tpu_torch.utils.intervals import Interval as PInterval
from tests.conftest import DAY as REF_DAY
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

IV_TEXT = ("2026-03-01", "2026-03-02")
T0 = RInterval.of(*IV_TEXT).start


def _pkg(ref: bool):
    if ref:
        from druid_tpu import storage
        return SimpleNamespace(
            name="ref", ingest=r_ingest, input=r_input, A=r_aggs,
            F=r_filters, M=r_model, S=r_segment, Interval=RInterval,
            IV=RInterval.of(*IV_TEXT), storage=storage,
            executor=lambda segs: RefExecutor(segs))
    from druid_tpu_torch import storage
    return SimpleNamespace(
        name="port", ingest=p_ingest, input=p_input, A=p_aggs, F=p_filters,
        M=p_model, S=p_segment, Interval=PInterval,
        IV=PInterval.of(*IV_TEXT), storage=storage,
        executor=lambda segs: PortExecutor(segs, device="cpu"))


REF, PORT = _pkg(True), _pkg(False)


# ---------------------------------------------------------------------------
# comparison helpers (shared by the slice's other test files)
# ---------------------------------------------------------------------------

def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "f":
        return a.view(np.uint32 if a.itemsize == 4 else np.uint64)
    return a


def same_segment(r, p, where=""):
    """The port's Segment equals the reference's column for column, bit for
    bit: id, time, dictionaries, ids, metric values and dtypes."""
    assert str(p.id) == str(r.id), where
    assert p.n_rows == r.n_rows, where
    assert np.array_equal(p.time_ms, r.time_ms), where
    assert list(p.dims) == list(r.dims), where
    for d in r.dims:
        assert p.dims[d].dictionary.values == r.dims[d].dictionary.values, \
            (where, d)
        assert p.dims[d].ids.dtype == r.dims[d].ids.dtype, (where, d)
        assert np.array_equal(p.dims[d].ids, r.dims[d].ids), (where, d)
    assert list(p.metrics) == list(r.metrics), where
    for m in r.metrics:
        rv, pv = r.metrics[m].values, p.metrics[m].values
        assert pv.dtype == rv.dtype and pv.shape == rv.shape, (where, m)
        assert np.array_equal(_bits(pv), _bits(rv)), (where, m)
        assert p.metrics[m].type.value == r.metrics[m].type.value, (where, m)


def close(want, got, where=()):
    """Rows equal: ints, strings and types exact; a float within 1e-5 of
    its magnitude (the float sums' rule over non-negative inputs) and NaN
    for NaN."""
    if isinstance(want, dict):
        assert set(want) == set(got), where
        for k in want:
            close(want[k], got[k], where + (k,))
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), where
        for i, (a, b) in enumerate(zip(want, got)):
            close(a, b, where + (i,))
    elif isinstance(want, float):
        assert isinstance(got, float), (where, want, got)
        if np.isnan(want):
            assert np.isnan(got), where
        else:
            assert abs(got - want) <= 1e-5 * abs(want), (where, want, got)
    else:
        assert got == want and type(got) is type(want), (where, want, got)


def both(fn):
    """fn(pkg) -> result for each package: (reference's, port's)."""
    return fn(REF), fn(PORT)


def _mk_index(pk, **kw):
    defaults = dict(
        datasource="ing", interval=pk.IV,
        metric_specs=[pk.A.CountAggregator("count"),
                      pk.A.LongSumAggregator("val_sum", "val")],
        dimensions=["d1", "d2"], query_granularity="hour")
    defaults.update(kw)
    return pk.ingest.IncrementalIndex(**defaults)


def _value(seg, dim, i):
    return seg.dims[dim].dictionary.values[int(seg.dims[dim].ids[i])]


# ---------------------------------------------------------------------------
# tests/test_ingest.py's cases, through both packages
# ---------------------------------------------------------------------------

def test_rollup_basic():
    def run(pk):
        idx = _mk_index(pk, flush_rows=4)  # force multiple compactions
        for i in range(100):
            idx.add({"timestamp": T0 + (i % 3) * 3_600_000,
                     "d1": f"a{i % 2}", "d2": "z", "val": 1})
        assert idx.n_rows == 6
        seg = idx.to_segment()
        q = pk.M.TimeseriesQuery.of(
            "ing", [pk.IV], [pk.A.LongSumAggregator("rows", "count"),
                             pk.A.LongSumAggregator("v", "val_sum")],
            granularity="all")
        return seg, pk.executor([seg]).run(q)
    (rs, rrows), (ps, prows) = both(run)
    same_segment(rs, ps)
    assert ps.n_rows == 6
    assert int(ps.metrics["count"].values.sum()) == 100
    assert prows[0]["result"] == {"rows": 100, "v": 100}
    close(rrows, prows)


def test_no_rollup_keeps_rows():
    def run(pk):
        idx = _mk_index(pk, rollup=False, flush_rows=7)
        for i in range(50):
            idx.add({"timestamp": T0 + i, "d1": "a", "d2": "b", "val": 2})
        return idx.to_segment()
    rs, ps = both(run)
    assert ps.n_rows == 50
    same_segment(rs, ps)


def test_rollup_matches_recomputed_golden():
    rng = np.random.default_rng(0)
    rows = [{"timestamp": T0 + int(rng.integers(0, 4)) * 3_600_000 + i,
             "d1": f"k{int(rng.integers(0, 3))}", "d2": "c",
             "val": int(rng.integers(0, 100))} for i in range(500)]

    def run(pk):
        idx = _mk_index(pk, metric_specs=[
            pk.A.CountAggregator("count"), pk.A.LongSumAggregator("s", "val"),
            pk.A.LongMaxAggregator("mx", "val"),
            pk.A.FirstAggregator("first_v", "val", "long"),
            pk.A.LastAggregator("last_v", "val", "long")], flush_rows=13)
        for r in rows:
            idx.add(dict(r))
        return idx.to_segment()
    rs, seg = both(run)
    same_segment(rs, seg)
    golden = {}
    for r in rows:
        hour = (r["timestamp"] // 3_600_000) * 3_600_000
        g = golden.setdefault((hour, r["d1"], r["d2"]), {
            "count": 0, "s": 0, "mx": -1, "ft": None, "fv": None,
            "lt": None, "lv": None})
        g["count"] += 1
        g["s"] += r["val"]
        g["mx"] = max(g["mx"], r["val"])
        if g["ft"] is None or r["timestamp"] < g["ft"]:
            g["ft"], g["fv"] = r["timestamp"], r["val"]
        if g["lt"] is None or r["timestamp"] > g["lt"]:
            g["lt"], g["lv"] = r["timestamp"], r["val"]
    assert seg.n_rows == len(golden)
    for i in range(seg.n_rows):
        g = golden[(int(seg.time_ms[i]), _value(seg, "d1", i), "c")]
        assert int(seg.metrics["count"].values[i]) == g["count"]
        assert int(seg.metrics["s"].values[i]) == g["s"]
        assert int(seg.metrics["mx"].values[i]) == g["mx"]
        assert int(seg.metrics["first_v"].values[i]) == g["fv"]
        assert int(seg.metrics["last_v"].values[i]) == g["lv"]


def test_schemaless_dimension_discovery():
    def run(pk):
        idx = _mk_index(pk, dimensions=None, flush_rows=3)
        idx.add({"timestamp": T0, "d1": "x", "val": 1})
        idx.add({"timestamp": T0 + 1, "newdim": "y", "val": 2})
        idx.add({"timestamp": T0 + 2, "d1": "x", "newdim": "y", "val": 3})
        idx.add({"timestamp": T0 + 3, "d1": "x", "newdim": "y", "val": 4})
        return idx.to_segment()
    rs, seg = both(run)
    same_segment(rs, seg)
    assert set(seg.dims) == {"d1", "newdim"}
    assert "" in seg.dims["newdim"].dictionary.values


def test_out_of_interval_rows_dropped():
    def run(pk):
        idx = _mk_index(pk)
        idx.add({"timestamp": T0 - 1, "d1": "x", "val": 1})
        idx.add({"timestamp": T0, "d1": "x", "val": 1})
        idx.add({"timestamp": pk.IV.end, "d1": "x", "val": 1})
        return idx.n_rows, idx.rows_out_of_interval
    assert both(run) == ((1, 2), (1, 2))


def test_hyperunique_ingest_metric_roundtrip(tmp_path):
    def run(pk):
        idx = _mk_index(pk, metric_specs=[
            pk.A.CountAggregator("count"),
            pk.A.HyperUniqueAggregator("uniq", "user")],
            dimensions=["d1"], flush_rows=11)
        for i in range(300):
            idx.add({"timestamp": T0 + i % 2, "d1": f"g{i % 2}",
                     "user": f"user_{i % 57}"})
        seg = idx.to_segment()
        q = pk.M.TimeseriesQuery.of(
            "ing", [pk.IV], [pk.A.HyperUniqueAggregator("u", "uniq")],
            granularity="all")
        est = pk.executor([seg]).run(q)[0]["result"]["u"]
        d = str(tmp_path / f"hll_{pk.name}")
        pk.storage.persist_segment(seg, d)
        est2 = pk.executor([pk.storage.load_segment(d)]).run(q)[0][
            "result"]["u"]
        gq = pk.M.GroupByQuery.of(
            "ing", [pk.IV], [pk.M.DefaultDimensionSpec("d1")],
            [pk.A.HyperUniqueAggregator("u", "uniq")], granularity="all")
        return seg, est, est2, pk.executor([seg]).run(gq)
    (rs, rest, rest2, rrows), (ps, est, est2, rows) = both(run)
    same_segment(rs, ps)
    assert ps.metrics["uniq"].values.ndim == 2
    assert 50 <= est <= 64 and est2 == est and est == rest == rest2
    assert len(rows) == 2 and all(50 <= r["event"]["u"] <= 64 for r in rows)
    close(rrows, rows)


def test_merge_segments_equals_single_index():
    rng = np.random.default_rng(7)
    rows = [{"timestamp": T0 + int(rng.integers(0, 5)) * 3_600_000,
             "d1": f"v{int(rng.integers(0, 4))}",
             "d2": f"w{int(rng.integers(0, 3))}",
             "val": int(rng.integers(0, 10)),
             "dval": float(rng.random())} for _ in range(400)]

    def run(pk):
        specs = [pk.A.CountAggregator("count"),
                 pk.A.LongSumAggregator("s", "val"),
                 pk.A.DoubleSumAggregator("d", "dval")]
        idx_all, idx_a, idx_b = (_mk_index(pk, metric_specs=specs,
                                           flush_rows=17) for _ in range(3))
        for i, row in enumerate(rows):
            idx_all.add(dict(row))
            (idx_a if i % 2 else idx_b).add(dict(row))
        merged = pk.ingest.merge_segments(
            [idx_a.to_segment(), idx_b.to_segment()], specs,
            query_granularity="hour")
        single = idx_all.to_segment()
        q = pk.M.GroupByQuery.of(
            "ing", [pk.IV],
            [pk.M.DefaultDimensionSpec("d1"), pk.M.DefaultDimensionSpec("d2")],
            [pk.A.LongSumAggregator("c", "count"),
             pk.A.LongSumAggregator("s", "s")], granularity="hour")
        return (merged, single, pk.executor([merged]).run(q),
                pk.executor([single]).run(q))
    (rm, rsg, rra, rrb), (pm, psg, ra, rb) = both(run)
    same_segment(rm, pm)
    same_segment(rsg, psg)
    assert pm.n_rows == psg.n_rows
    assert ra == rb
    close(rra, ra)


def test_merge_heterogeneous_dims():
    def run(pk):
        specs = [pk.A.CountAggregator("count")]
        a = pk.ingest.IncrementalIndex("m", pk.IV, specs, dimensions=["x"])
        a.add({"timestamp": T0, "x": "1"})
        b = pk.ingest.IncrementalIndex("m", pk.IV, specs, dimensions=["y"])
        b.add({"timestamp": T0, "y": "2"})
        return pk.ingest.merge_segments([a.to_segment(), b.to_segment()],
                                        specs, rollup=False)
    rm, merged = both(run)
    same_segment(rm, merged)
    assert set(merged.dims) == {"x", "y"} and merged.n_rows == 2
    assert {(_value(merged, "x", i), _value(merged, "y", i))
            for i in range(2)} == {("1", ""), ("", "2")}


def test_json_parser():
    def run(pk):
        p = pk.input.InputRowParser(pk.input.TimestampSpec("ts", "iso"),
                                    pk.input.DimensionsSpec(("a",)),
                                    fmt="json")
        b = p.parse_batch([json.dumps({"ts": "2026-03-01T00:00:00Z",
                                       "a": "x", "m": 5})])
        return b.timestamps, b.columns
    (rt, rc), (pt, pc) = both(run)
    assert pt == rt == [T0] and pc == rc and pc["a"] == ["x"]


def test_csv_tsv_regex_parsers():
    def run(pk):
        I = pk.input
        csv_p = I.InputRowParser(I.TimestampSpec("t", "millis"),
                                 I.DimensionsSpec(), fmt="csv",
                                 columns=["t", "a", "b"])
        tsv_p = I.InputRowParser(I.TimestampSpec("t", "millis"),
                                 I.DimensionsSpec(), fmt="tsv",
                                 columns=["t", "a"])
        rx_p = I.InputRowParser(I.TimestampSpec("t", "millis"),
                                I.DimensionsSpec(), fmt="regex",
                                columns=["t", "w"], pattern=r"(\d+) (\w+)")
        return (csv_p.parse_batch([f"{T0},x,3", f"{T0 + 1},y,4"]).columns,
                tsv_p.parse_batch([f"{T0}\tz"]).columns,
                rx_p.parse_batch([f"{T0} hello"]).columns,
                [p.to_json() for p in (csv_p, tsv_p, rx_p)])
    r, p = both(run)
    assert p == r
    assert p[0]["a"] == ["x", "y"] and p[1]["a"] == ["z"] \
        and p[2]["w"] == ["hello"]


def test_timestamp_formats():
    for pk in (REF, PORT):
        TS = pk.input.TimestampSpec
        assert TS(format="millis").parse(T0) == T0
        assert TS(format="posix").parse(T0 // 1000) == T0
        assert TS(format="auto").parse(str(T0)) == T0
        assert TS(format="auto").parse("2026-03-01") == T0
        assert TS(format="%d/%m/%Y %H:%M").parse("01/03/2026 00:00") == T0
        assert TS(format="nano").parse(T0 * 1_000_000) == T0
        with pytest.raises(ValueError):
            TS().parse(None)
        assert TS(missing_value=123).parse(None) == 123


def test_transform_spec():
    def run(pk):
        ts = pk.input.TransformSpec(
            transforms=(pk.input.ExpressionTransform("doubled", "v * 2"),),
            filter=pk.F.BoundFilter("v", lower="3", ordering="numeric"))
        batch = pk.input.RowBatch([T0, T0 + 1, T0 + 2],
                                  {"v": [2, 3, 10], "d": ["a", "b", "c"]})
        out = ts.apply(batch)
        return (len(out), out.timestamps, out.columns["d"],
                [float(x) for x in out.columns["doubled"]],
                json.dumps(ts.to_json(), sort_keys=True))
    r, p = both(run)
    assert p == r
    assert p[0] == 2 and p[2] == ["b", "c"] and p[3] == [6.0, 20.0]


@pytest.mark.parametrize("flt", [
    {"type": "selector", "dimension": "d", "value": "b"},
    {"type": "in", "dimension": "d", "values": ["a", "c"]},
    {"type": "not", "field": {"type": "bound", "dimension": "v",
                              "upper": "3", "ordering": "numeric"}},
    {"type": "or", "fields": [
        {"type": "regex", "dimension": "d", "pattern": "^[ab]"},
        {"type": "like", "dimension": "d", "pattern": "c%"}]},
    {"type": "expression", "expression": "v * 2 > 5"},
    {"type": "interval", "dimension": "__time",
     "intervals": ["2026-03-01T00:00:00.001Z/2026-03-01T00:00:00.003Z"]},
    {"type": "columnComparison", "dimensions": ["d", "e"]},
    {"type": "search", "dimension": "d",
     "query": {"type": "contains", "value": "B", "caseSensitive": False}},
], ids=["selector", "in", "not_bound", "or_regex_like", "expression",
        "interval", "column_comparison", "search"])
def test_transform_filter_row_matcher(flt):
    """The ingest-time row matcher (engine/filters.make_row_matcher) keeps
    the same rows as the reference's, leaf by leaf, nulls included."""
    def run(pk):
        ts = pk.input.TransformSpec(filter=pk.F.filter_from_json(flt))
        batch = pk.input.RowBatch(
            [T0, T0 + 1, T0 + 2, T0 + 3, T0 + 4],
            {"v": [2, 3, 10, None, "7"], "d": ["a", "b", "c", None, "b"],
             "e": ["a", "x", "c", "", None]})
        out = ts.apply(batch)
        return out.timestamps, out.columns
    r, p = both(run)
    assert p == r


def test_local_firehose(tmp_path):
    import gzip
    (tmp_path / "a.json").write_text('{"t": 1, "d": "x"}\n{"t": 2, "d": "y"}\n')
    with gzip.open(tmp_path / "b.json.gz", "wt") as f:
        f.write('{"t": 3, "d": "z"}\n')

    def run(pk):
        fh = pk.input.LocalFirehose(str(tmp_path), "*.json*")
        lines = [l for batch in fh.batches() for l in batch]
        splits = [s.to_json() for s in fh.splits(2)]
        back = pk.input.firehose_from_json(fh.to_json())
        return lines, splits, back.paths
    r, p = both(run)
    assert p == r and len(p[0]) == 3


def test_firehose_to_index_end_to_end():
    records = [json.dumps({"ts": T0 + i, "d1": f"p{i % 3}", "val": i})
               for i in range(100)]

    def run(pk):
        parser = pk.input.InputRowParser(
            pk.input.TimestampSpec("ts", "millis"),
            pk.input.DimensionsSpec(("d1",)))
        idx = _mk_index(pk, dimensions=["d1"], query_granularity="all")
        for raw in pk.input.InlineFirehose(records).batches(batch_size=16):
            idx.add_batch(parser.parse_batch(raw))
        return idx.to_segment()
    rs, seg = both(run)
    same_segment(rs, seg)
    assert seg.n_rows == 3
    assert int(seg.metrics["val_sum"].values.sum()) == sum(range(100))


def test_schemaless_backfill_is_null():
    def run(pk):
        idx = _mk_index(pk, dimensions=None, flush_rows=2)
        idx.add({"timestamp": T0, "d1": "a", "val": 1})
        idx.add({"timestamp": T0 + 1, "d1": "b", "val": 1})
        idx.add({"timestamp": T0 + 2, "newdim": "y", "val": 1})
        idx.add({"timestamp": T0 + 3, "newdim": "y", "val": 1})
        return idx.to_segment()
    rs, seg = both(run)
    same_segment(rs, seg)
    nd = seg.dims["newdim"]
    assert sorted(nd.dictionary.values[int(i)] for i in nd.ids) == \
        ["", "", "y"]


def test_first_last_merge_uses_event_time():
    def run(pk):
        specs = [pk.A.FirstAggregator("fv", "val", "long"),
                 pk.A.LastAggregator("lv", "val", "long")]
        a = pk.ingest.IncrementalIndex("fl", pk.IV, specs, dimensions=["d"],
                                       query_granularity="hour")
        a.add({"timestamp": T0 + 10, "d": "g", "val": 1})
        b = pk.ingest.IncrementalIndex("fl", pk.IV, specs, dimensions=["d"],
                                       query_granularity="hour")
        b.add({"timestamp": T0 + 5, "d": "g", "val": 2})
        b.add({"timestamp": T0 + 20, "d": "g", "val": 3})
        merged = pk.ingest.merge_segments([a.to_segment(), b.to_segment()],
                                          specs, query_granularity="hour")
        q = pk.M.TimeseriesQuery.of(
            "fl", [pk.IV], [pk.A.FirstAggregator("f", "fv", "long"),
                            pk.A.LastAggregator("l", "lv", "long")],
            granularity="all")
        return merged, pk.executor([a.to_segment(), b.to_segment()]).run(q)
    (rm, rres), (merged, res) = both(run)
    same_segment(rm, merged)
    assert merged.n_rows == 1
    assert int(merged.metrics["fv"].values[0]) == 2
    assert int(merged.metrics["lv"].values[0]) == 3
    assert merged.metrics["fv"].values.dtype == np.int64
    assert res[0]["result"] == {"f": 2, "l": 3}
    close(rres, res)


def test_complex_column_segments_match_reference_plain_and_sharded():
    """The reference's test_sharded_complex_column_falls_back: hyperUnique
    complex columns over 2 segments; the port's plain and mesh rows equal
    the reference's plain and mesh runs."""
    from druid_tpu.parallel import make_mesh, use_mesh
    from druid_tpu_torch.parallel import make_mesh as port_mesh
    from druid_tpu_torch.parallel.distributed import sharded_stats

    def run(pk):
        specs = [pk.A.CountAggregator("count"),
                 pk.A.HyperUniqueAggregator("uu", "user")]
        segs = []
        for p in range(2):
            idx = pk.ingest.IncrementalIndex("hc", pk.IV, specs,
                                             dimensions=["d"],
                                             query_granularity="hour")
            for i in range(100):
                idx.add({"timestamp": T0 + i, "d": f"x{i % 3}",
                         "user": f"u{p}_{i % 20}"})
            segs.append(idx.to_segment(partition=p))
        q = pk.M.TimeseriesQuery.of(
            "hc", [pk.IV], [pk.A.HyperUniqueAggregator("u", "uu")],
            granularity="all")
        return segs, q
    (rsegs, rq), (psegs, pq) = both(run)
    for a, b in zip(rsegs, psegs):
        same_segment(a, b)
    plain = RefExecutor(rsegs).run(rq)
    with use_mesh(make_mesh()):
        sharded = RefExecutor(rsegs).run(rq)
    got = PortExecutor(psegs, device="cpu").run(pq)
    before = sharded_stats().snapshot()
    on_mesh = PortExecutor(psegs, device="cpu",
                           mesh=port_mesh(8, device="cpu")).run(pq)
    assert sharded_stats().snapshot() == before      # fell back
    assert plain == sharded == got == on_mesh
    assert 36 <= got[0]["result"]["u"] <= 44


def test_dtype_mismatch_segments_match_reference_plain_and_sharded():
    """The reference's test_sharded_dtype_mismatch_falls_back: a LONG and a
    DOUBLE metric of one name in two segments."""
    from druid_tpu.parallel import make_mesh, use_mesh
    from druid_tpu_torch.parallel import make_mesh as port_mesh
    from druid_tpu_torch.parallel.distributed import sharded_stats

    def run(pk):
        b1 = pk.S.SegmentBuilder("dm", pk.IV, partition=0)
        for i in range(10):
            b1.add_row(T0 + i, {"d": "x"}, {"m": i})
        b2 = pk.S.SegmentBuilder("dm", pk.IV, partition=1)
        for i in range(10):
            b2.add_row(T0 + i, {"d": "x"}, {"m": i + 0.5})
        q = pk.M.TimeseriesQuery.of(
            "dm", [pk.IV], [pk.A.DoubleSumAggregator("s", "m")],
            granularity="all")
        return [b1.build(), b2.build()], q
    (rsegs, rq), (psegs, pq) = both(run)
    plain = RefExecutor(rsegs).run(rq)
    with use_mesh(make_mesh()):
        sharded = RefExecutor(rsegs).run(rq)
    got = PortExecutor(psegs, device="cpu").run(pq)
    before = sharded_stats().snapshot()
    on_mesh = PortExecutor(psegs, device="cpu",
                           mesh=port_mesh(8, device="cpu")).run(pq)
    assert sharded_stats().snapshot() == before      # fell back
    assert abs(got[0]["result"]["s"] - (45 + 50)) < 1e-9
    assert plain == sharded
    assert got == on_mesh
    close(plain, got)


# ---------------------------------------------------------------------------
# Cross-package identity: the index, the persisted hydrant, merge_segments
# ---------------------------------------------------------------------------

def _random_rows(seed, n, schemaless=False, hours=6):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        r = {"timestamp": int(T0 + rng.integers(0, hours * 3_600_000)),
             "page": f"p{int(rng.zipf(1.5)) % 40}",
             "user": f"u{int(rng.integers(0, 300))}",
             "value": int(rng.integers(-50, 1000)),
             "fvalue": float(np.float32(rng.normal(10, 3))),
             "dvalue": float(rng.random())}
        if schemaless and i % 7 == 3:
            r["late_dim"] = f"l{int(rng.integers(0, 5))}"
        if i % 11 == 5:
            r.pop("page")              # a null dimension value
        rows.append(r)
    return rows


def _all_specs(pk):
    A = pk.A
    return [A.CountAggregator("rows"), A.LongSumAggregator("v", "value"),
            A.DoubleSumAggregator("d", "dvalue"),
            A.FloatSumAggregator("f", "fvalue"),
            A.LongMinAggregator("vmin", "value"),
            A.LongMaxAggregator("vmax", "value"),
            A.FloatMinAggregator("fmin", "fvalue"),
            A.DoubleMaxAggregator("dmax", "dvalue"),
            A.FirstAggregator("vfirst", "value", "long"),
            A.LastAggregator("dlast", "dvalue", "double"),
            A.HyperUniqueAggregator("uu", "user")]


INDEX_CASES = [
    dict(gran="none", rollup=True, schemaless=False, flush=97),
    dict(gran="minute", rollup=True, schemaless=False, flush=1000),
    dict(gran="hour", rollup=True, schemaless=True, flush=53),
    dict(gran="all", rollup=True, schemaless=True, flush=4096),
    dict(gran="none", rollup=False, schemaless=False, flush=211),
]


def _build_index(pk, case, rows, batch=150):
    idx = pk.ingest.IncrementalIndex(
        "ids", pk.Interval.of("2026-03-01", "2026-03-02"), _all_specs(pk),
        dimensions=None if case["schemaless"] else ["page", "user"],
        query_granularity=case["gran"], rollup=case["rollup"],
        flush_rows=case["flush"])
    for i in range(0, len(rows), batch):
        chunk = rows[i:i + batch]
        cols = {}
        for k in sorted({k for r in chunk for k in r if k != "timestamp"}):
            cols[k] = [r.get(k) for r in chunk]
        idx.add_batch(pk.input.RowBatch([r["timestamp"] for r in chunk],
                                        cols))
    return idx


@pytest.mark.parametrize("ci", range(len(INDEX_CASES)),
                         ids=[f"{c['gran']}-rollup{int(c['rollup'])}"
                              f"-schemaless{int(c['schemaless'])}"
                              for c in INDEX_CASES])
def test_index_snapshot_identical_across_packages(ci):
    """The same rows through both IncrementalIndexes: equal dictionaries,
    ids, time and metric columns (every ingest metric kind), equal change
    markers, and the same snapshot object while nothing changed."""
    case = INDEX_CASES[ci]
    rows = _random_rows(100 + ci, 2500, case["schemaless"])
    r_idx = _build_index(REF, case, rows)
    p_idx = _build_index(PORT, case, rows)
    assert p_idx.change_marker() == r_idx.change_marker()
    assert p_idx.n_rows == r_idx.n_rows
    rs, ps = r_idx.to_segment("v1", 3), p_idx.to_segment("v1", 3)
    same_segment(rs, ps)
    assert p_idx.to_segment("v1", 3) is ps          # cached per generation
    assert bool(np.all(np.diff(ps.time_ms) >= 0))   # rows in time order
    seg, marker = p_idx.snapshot_with_marker("v1", 3)
    assert seg is ps and marker == r_idx.snapshot_with_marker("v1", 3)[1]


@pytest.mark.parametrize("ci", [0, 2, 4],
                         ids=["none", "hour-schemaless", "no-rollup"])
def test_persisted_hydrant_v2_bytes_equal(ci, tmp_path):
    """IncrementalIndex.persist (format V2) writes the same bytes in both
    packages, part for part, index.json included."""
    case = INDEX_CASES[ci]
    rows = _random_rows(200 + ci, 1500, case["schemaless"])
    rdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    _build_index(REF, case, rows).persist(rdir, "v2", 1)
    _build_index(PORT, case, rows).persist(pdir, "v2", 1)
    rfiles, pfiles = sorted(os.listdir(rdir)), sorted(os.listdir(pdir))
    assert pfiles == rfiles and rfiles
    for f in rfiles:
        with open(os.path.join(rdir, f), "rb") as a, \
                open(os.path.join(pdir, f), "rb") as b:
            assert a.read() == b.read(), f


MERGE_CASES = [
    dict(gran="none", rollup=True, parts=2),
    dict(gran="hour", rollup=True, parts=3),
    dict(gran="all", rollup=True, parts=4),
    dict(gran="none", rollup=False, parts=3),
]


@pytest.mark.parametrize("mi", range(len(MERGE_CASES)),
                         ids=[f"{c['gran']}-rollup{int(c['rollup'])}"
                              f"-{c['parts']}" for c in MERGE_CASES])
def test_merge_segments_identical_across_packages(mi):
    """merge_segments over hydrants with different dictionaries (and one
    with a dimension the others lack) equals the reference's, and the
    merged segment answers like the hydrants it replaced."""
    case = MERGE_CASES[mi]
    rows = _random_rows(300 + mi, 3000, schemaless=True)
    cuts = np.linspace(0, len(rows), case["parts"] + 1).astype(int)
    icase = dict(gran=case["gran"], rollup=case["rollup"], schemaless=True,
                 flush=500)

    def run(pk):
        hyd = [_build_index(pk, icase, rows[a:b]).to_segment("v", 0)
               for a, b in zip(cuts[:-1], cuts[1:])]
        merged = pk.ingest.merge_segments(
            hyd, _all_specs(pk), version="v", partition=0,
            rollup=case["rollup"], query_granularity=case["gran"])
        A = pk.A
        q = pk.M.GroupByQuery.of(
            "ids", [pk.Interval.of("2026-03-01", "2026-03-02")],
            [pk.M.DefaultDimensionSpec("page")],
            [A.LongSumAggregator("rows", "rows"),
             A.LongSumAggregator("v", "v"), A.LongMinAggregator("vmin", "vmin"),
             A.LongMaxAggregator("vmax", "vmax"),
             A.DoubleSumAggregator("d", "d")], granularity="hour")
        return merged, pk.executor([merged]).run(q), pk.executor(hyd).run(q)
    (rm, rrows, _), (pm, rows_m, rows_h) = both(run)
    same_segment(rm, pm)
    close(rrows, rows_m)
    close(rows_h, rows_m)
    assert sum(r["event"]["rows"] for r in rows_m) == len(rows)


# ---------------------------------------------------------------------------
# tests/test_representations.py's two cases, in the port
# ---------------------------------------------------------------------------

INGEST_SPEC_JSON = [
    {"type": "longSum", "name": "metLong", "fieldName": "metLong"},
    {"type": "floatMax", "name": "metFloat", "fieldName": "metFloat"},
    {"type": "doubleSum", "name": "metDouble", "fieldName": "metDouble"}]


def _frame(seg):
    out = {"__time": seg.time_ms.copy()}
    for name, col in seg.dims.items():
        out[name] = np.asarray(col.dictionary.values, dtype=object)[col.ids]
    for name, m in seg.metrics.items():
        out[name] = m.values.copy()
    return out


def _index_of(seg, lo, hi, version, part):
    specs = [p_aggs.agg_from_json(j) for j in INGEST_SPEC_JSON]
    frame = _frame(seg)
    idx = p_ingest.IncrementalIndex(
        seg.id.datasource, seg.interval, specs, dimensions=list(seg.dims),
        query_granularity="none", rollup=False, max_rows_in_memory=10 ** 12)
    idx.add_batch(p_input.RowBatch(
        frame["__time"][lo:hi].tolist(),
        {c: list(frame[c][lo:hi]) for c in frame if c != "__time"}))
    return idx.to_segment(version, part)


@pytest.fixture(scope="module")
def forms(generator, tmp_path_factory):
    """The port's four representations of one reference segment: as
    generated (carried as arrays), persisted and loaded, rebuilt through
    the IncrementalIndex, and split into 3 persisted spills merged."""
    from druid_tpu_torch.storage import load_segment, persist_segment
    ref = generator.segment(12_000, REF_DAY, datasource="test")
    base = _carry(ref)
    tmp = tmp_path_factory.mktemp("reprs")
    persist_segment(base, str(tmp / "persisted"))
    n = base.n_rows
    cuts = [0, n // 3, 2 * n // 3, n]
    spills = []
    for i in range(3):
        spill = _index_of(base, cuts[i], cuts[i + 1], "spill", i)
        persist_segment(spill, str(tmp / f"spill{i}"))
        spills.append(load_segment(str(tmp / f"spill{i}")))
    merged = p_ingest.merge_segments(
        spills, [p_aggs.agg_from_json(j) for j in INGEST_SPEC_JSON],
        datasource="test", interval=base.interval, version=base.id.version,
        partition=base.id.partition, rollup=False, query_granularity="none")
    return ref, {
        "generated": base,
        "persisted": load_segment(str(tmp / "persisted")),
        "incremental": _index_of(base, 0, n, base.id.version,
                                 base.id.partition),
        "merged": merged}


AGGS_J = [{"type": "count", "name": "rows"},
          {"type": "longSum", "name": "ls", "fieldName": "metLong"},
          {"type": "floatMax", "name": "fm", "fieldName": "metFloat"},
          {"type": "doubleSum", "name": "ds", "fieldName": "metDouble"}]
DAY_J = ["2026-01-01/2026-01-02"]


def _sorted_rows(rows, keys):
    return sorted(tuple((k, r.get("event", r).get(k)) for k in keys)
                  for r in rows)


REPR_QUERIES = [
    ("timeseries", {"queryType": "timeseries", "dataSource": "test",
                    "intervals": DAY_J, "granularity": "hour",
                    "aggregations": AGGS_J}, lambda rows: rows),
    ("topn", {"queryType": "topN", "dataSource": "test", "intervals": DAY_J,
              "granularity": "all", "dimension": "dimB", "metric": "ls",
              "threshold": 10, "aggregations": AGGS_J,
              "filter": {"type": "bound", "dimension": "metLong",
                         "lower": 10, "upper": 90, "ordering": "numeric"}},
     lambda rows: rows),
    ("groupby_filtered", {
        "queryType": "groupBy", "dataSource": "test", "intervals": DAY_J,
        "granularity": "all", "dimensions": ["dimA", "dimB"],
        "aggregations": AGGS_J,
        "filter": {"type": "or", "fields": [
            {"type": "selector", "dimension": "dimA", "value": "v00000003"},
            {"type": "in", "dimension": "dimA",
             "values": ["v00000001", "v00000005"]}]}},
     lambda rows: _sorted_rows(rows, ("dimA", "dimB", "rows", "ls"))),
    ("groupby_hicard", {
        "queryType": "groupBy", "dataSource": "test", "intervals": DAY_J,
        "granularity": "all", "dimensions": ["dimHi"],
        "aggregations": [{"type": "count", "name": "rows"},
                         {"type": "longMax", "name": "lm",
                          "fieldName": "metLong"}]},
     lambda rows: _sorted_rows(rows, ("dimHi", "rows", "lm"))),
    ("search", {"queryType": "search", "dataSource": "test",
                "intervals": DAY_J, "searchDimensions": ["dimA"],
                "query": {"type": "insensitive_contains",
                          "value": "v0000000"}, "limit": 20},
     lambda rows: rows),
    ("scan_multiset", {"queryType": "scan", "dataSource": "test",
                       "intervals": DAY_J, "columns": ["dimA", "metLong"]},
     lambda rows: sorted((e["dimA"], e["metLong"])
                         for b in rows for e in b["events"])),
]


@pytest.mark.parametrize("name,q,norm", REPR_QUERIES,
                         ids=[q[0] for q in REPR_QUERIES])
def test_query_equivalence_across_representations(forms, name, q, norm):
    """The same query over the port's four forms of one segment gives the
    same rows, and those equal the reference's over the generated one."""
    ref, port_forms = forms
    want = norm(RefExecutor([ref]).run_json(q))
    for form, seg in port_forms.items():
        got = norm(PortExecutor([seg], device="cpu").run_json(q))
        close(want, got, (name, form))


def test_representation_row_counts(forms):
    ref, port_forms = forms
    for form, seg in port_forms.items():
        assert seg.n_rows == ref.n_rows, form


# ---------------------------------------------------------------------------
# combining forms, and the HTTP push firehose
# ---------------------------------------------------------------------------

COMBINING_SPECS = [
    {"type": "count", "name": "c"},
    {"type": "longSum", "name": "s", "fieldName": "x"},
    {"type": "doubleSum", "name": "s", "fieldName": "x"},
    {"type": "floatSum", "name": "s", "fieldName": "x"},
    {"type": "longMin", "name": "m", "fieldName": "x"},
    {"type": "floatMax", "name": "m", "fieldName": "x"},
    {"type": "doubleMax", "name": "m", "fieldName": "x"},
    {"type": "longFirst", "name": "f", "fieldName": "x"},
    {"type": "floatLast", "name": "f", "fieldName": "x"},
    {"type": "filtered", "name": "fl",
     "aggregator": {"type": "longSum", "name": "fl", "fieldName": "x"},
     "filter": {"type": "selector", "dimension": "d", "value": "a"}},
    {"type": "hyperUnique", "name": "u", "fieldName": "x", "log2m": 12},
    {"type": "cardinality", "name": "u", "fields": ["d", "e"],
     "byRow": True, "log2m": 12, "round": True},
    {"type": "variance", "name": "v", "fieldName": "x",
     "estimator": "sample"},
    {"type": "thetaSketch", "name": "t", "fieldName": "x", "size": 1024},
    {"type": "quantilesDoublesSketch", "name": "q", "fieldName": "x"},
    {"type": "approxHistogram", "name": "h", "fieldName": "x",
     "numBuckets": 32, "lowerLimit": 0.0, "upperLimit": 10.0},
    {"type": "bloom", "name": "b", "fieldName": "d", "maxNumEntries": 500},
    {"type": "distinctCount", "name": "dc", "fieldName": "d"},
    {"type": "timeMin", "name": "tmin"},
    {"type": "timeMax", "name": "tmax"},
]


@pytest.mark.parametrize("spec", COMBINING_SPECS,
                         ids=[s["type"] for s in COMBINING_SPECS])
def test_combining_forms_match_reference(spec):
    """Every aggregator spec, the extensions' included, combines as the
    reference's does: the same combining spec (merge_segments and the
    merge side re-aggregate with it)."""
    import druid_tpu.ext  # noqa: F401  (registers the reference's types)
    import druid_tpu_torch.ext  # noqa: F401
    want = r_aggs.agg_from_json(spec).combining()
    got = p_aggs.agg_from_json(spec).combining()
    assert type(got).__name__ == type(want).__name__
    assert got.to_json() == want.to_json()


def test_event_receiver_firehose_push_and_drain():
    """The HTTP push firehose (ingest/receiver.py): batches POSTed to
    push-events drain through batches() until /shutdown, a batch over the
    buffer bound is refused whole (503), a push after close is a 409; the
    events drained build the same index as the reference's receiver."""
    import urllib.error
    import urllib.request

    def run(pk):
        fh = pk.ingest.EventReceiverFirehose("svc", max_buffered=50)
        try:
            def post(path, body):
                req = urllib.request.Request(
                    f"{fh.url}/{path}", data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=30) as r:
                        return r.status, json.loads(r.read())
                except urllib.error.HTTPError as e:
                    return e.code, json.loads(e.read())
            events = [{"timestamp": T0 + i, "d1": f"p{i % 3}", "d2": "z",
                       "val": i} for i in range(40)]
            codes = [post("push-events", events[:30])[0],
                     post("push-events", events[30:] + events * 2)[0],
                     post("push-events", events[30:])[0],
                     post("shutdown", {})[0],
                     post("push-events", events[:1])[0]]
            assert fh.to_json() == {"type": "receiver", "serviceName": "svc"}
            idx = _mk_index(pk, query_granularity="all")
            parser = pk.input.InputRowParser(
                pk.input.TimestampSpec("timestamp", "millis"),
                pk.input.DimensionsSpec(("d1", "d2")))
            drained = 0
            for batch in fh.batches(batch_size=16):
                drained += len(batch)
                idx.add_batch(parser.parse_batch(batch))
            return codes, drained, fh.events_received, idx.to_segment()
        finally:
            fh.stop()
    r, p = both(run)
    assert p[0] == r[0] == [200, 503, 200, 200, 409]
    assert p[1:3] == r[1:3] == (40, 40)
    same_segment(r[3], p[3])
