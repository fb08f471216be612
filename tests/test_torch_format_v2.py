"""Segment format V2 in the port (druid_tpu_torch/storage/format_v2.py): the
cases of tests/test_format_v2.py on the port's writer, loader and engines.
Persist, deep-storage push/pull, mmap load and query are bit-identical to
the in-memory segment (NaN and -0.0 compared as integer bits); a V2 load
is lazy and counts its host decodes; a run-domain query over a loaded
segment decodes no row; the golden fixtures the reference wrote
(tests/golden/segment_v{1,2}) load in the port and answer; the port's V2
raw parts are byte-stable against them; SegmentLoadMonitor emits the load
deltas. The reference's environment switch (DRUID_TPU_SEGMENT_FORMAT) is
the port's `format_version` argument, and its historical's skip of a
corrupt directory is the load queue's recorded failure."""
import os
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.engine.executor import QueryExecutor as RefExecutor
from druid_tpu.storage.format import load_segment as ref_load

from druid_tpu_torch.cluster import DataNode, InventoryView, descriptor_for
from druid_tpu_torch.cluster import wire
from druid_tpu_torch.cluster.loadqueue import LoadQueuePeon
from druid_tpu_torch.data import cascade
from druid_tpu_torch.engine import QueryExecutor, engines
from druid_tpu_torch.query.model import query_from_json
from druid_tpu_torch.storage.deep import LocalDeepStorage
from druid_tpu_torch.storage.format import (FORMAT_VERSION,
                                            FORMAT_VERSION_V2, load_segment,
                                            read_format_version,
                                            read_segment_meta)
from druid_tpu_torch.storage.format_v2 import (SegmentLoadMonitor,
                                               SegmentLoadStats,
                                               load_segment_v2,
                                               persist_segment_auto,
                                               persist_segment_v2,
                                               segment_load_stats)
from druid_tpu_torch.storage.smoosh import (CorruptSegmentError,
                                            SmooshedFileMapper)
from druid_tpu_torch.utils.emitter import InMemoryEmitter, ServiceEmitter
from tests.test_format_v2 import (_golden_segment, _mixed_segment,
                                  _rollup_segment, _rows_equal)
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

IV = ["2026-01-01/2026-01-02"]
GOLDEN_DIR = Path(__file__).resolve().parent / "golden"


def _mixed():
    return _carry(_mixed_segment())


def _rollup(datasource="roll", rows=4096):
    return _carry(_rollup_segment(rows=rows, datasource=datasource))


def _assert_bit_identical(a, b):
    """Segment equality down to the float bits (NaN payloads, -0.0)."""
    assert a.id == b.id and a.n_rows == b.n_rows
    np.testing.assert_array_equal(a.time_ms, b.time_ms)
    assert set(a.dims) == set(b.dims)
    for name, col in a.dims.items():
        np.testing.assert_array_equal(b.dims[name].ids, col.ids)
        assert b.dims[name].dictionary == col.dictionary
    assert set(a.metrics) == set(b.metrics)
    for name, m in a.metrics.items():
        assert b.metrics[name].type == m.type
        x, y = np.asarray(m.values), np.asarray(b.metrics[name].values)
        assert x.dtype == y.dtype
        if np.issubdtype(x.dtype, np.floating):
            iw = np.dtype(f"<i{x.dtype.itemsize}")
            np.testing.assert_array_equal(x.view(iw), y.view(iw))
        else:
            np.testing.assert_array_equal(x, y)


def _run(segs, q):
    return QueryExecutor(segs, device="cpu").run_json(q)


# ---------------------------------------------------------------------------
# round trip + encodings
# ---------------------------------------------------------------------------

def test_v2_roundtrip_bit_identical(tmp_path):
    seg = _mixed()
    d = str(tmp_path / "v2")
    assert persist_segment_v2(seg, d) > 0
    assert read_format_version(d) == FORMAT_VERSION_V2
    _assert_bit_identical(seg, load_segment(d))


def test_v2_specs_cover_every_encoding(tmp_path):
    d = str(tmp_path / "v2")
    persist_segment_v2(_mixed(), d)
    meta = read_segment_meta(d)
    assert meta["format"] == 2
    specs = meta["v2"]["columns"]
    assert specs["d"]["enc"] == "rle"
    assert specs["cnt"]["enc"] == "rle"
    assert specs["val"]["enc"] == "rle"
    assert specs["sm"]["enc"] == "pack"
    assert specs["dbl"]["enc"] == "lz4"
    assert specs["noise"]["enc"] == "block"
    assert meta["v2"]["staging"]["cascades"]


def test_v2_load_is_lazy_and_counts_decodes(tmp_path):
    seg = _mixed()
    d = str(tmp_path / "v2")
    persist_segment_v2(seg, d)
    loaded = load_segment_v2(d)
    lazy = [loaded.dims["d"], loaded.metrics["cnt"], loaded.metrics["sm"],
            loaded.metrics["dbl"]]
    assert all(not c.materialized() for c in lazy)
    # what the load planned from reads no row (size, plan, stats)
    assert loaded.size_bytes() == seg.size_bytes()
    cascade.reset_decode_stats()
    np.testing.assert_array_equal(loaded.dims["d"].ids, seg.dims["d"].ids)
    _ = loaded.metrics["sm"].values
    _ = loaded.metrics["dbl"].values
    _ = loaded.metrics["sm"].values           # once a column
    stats = cascade.decode_stats()
    assert stats == {"host:rle": 1, "host:packed": 1, "host:lz4": 1}
    assert not loaded.metrics["cnt"].materialized()
    cascade.reset_decode_stats()


def test_v2_column_subset(tmp_path):
    d = str(tmp_path / "v2")
    persist_segment_v2(_mixed(), d)
    loaded = load_segment_v2(d, columns=["d", "sm"])
    assert list(loaded.dims) == ["d"]
    assert list(loaded.metrics) == ["sm"]


def test_v2_bitmap_index_matches(tmp_path):
    seg = _mixed()
    d = str(tmp_path / "v2")
    persist_segment_v2(seg, d)
    loaded = load_segment_v2(d)
    for name in seg.dims:
        held = loaded.dims[name].held_bitmap_index()
        assert held is not None               # persisted, not built
        np.testing.assert_array_equal(
            held.bitmap(1).to_bool(),
            seg.dims[name].bitmap_index().bitmap(1).to_bool())
    assert not loaded.dims["d"].materialized()


def test_persist_auto_routes_on_format_version(tmp_path):
    seg = _rollup()
    d2 = str(tmp_path / "auto_v2")
    persist_segment_auto(seg, d2)
    assert read_format_version(d2) == FORMAT_VERSION_V2
    d1 = str(tmp_path / "auto_v1")
    persist_segment_auto(seg, d1, format_version=1)
    assert read_format_version(d1) == FORMAT_VERSION
    _assert_bit_identical(load_segment(d1), load_segment(d2))
    with pytest.raises(ValueError, match="format version 3"):
        persist_segment_auto(seg, str(tmp_path / "bad"), format_version=3)


# ---------------------------------------------------------------------------
# deep-storage push/pull + query parity + zero host decodes
# ---------------------------------------------------------------------------

def _queries(datasource):
    aggs = [{"type": "count", "name": "rows"},
            {"type": "longSum", "name": "s", "fieldName": "val"}]
    base = {"dataSource": datasource, "intervals": IV}
    return [
        dict(base, queryType="groupBy", dimensions=["dimA"],
             aggregations=aggs, granularity="hour"),
        dict(base, queryType="timeseries", aggregations=aggs,
             granularity="hour"),
        dict(base, queryType="topN", dimension="dimA", metric="s",
             threshold=5, aggregations=aggs, granularity="all")]


@pytest.mark.parametrize("format_version", [1, 2])
def test_v2_push_pull_query_parity(tmp_path, format_version):
    seg = _rollup()
    deep = LocalDeepStorage(str(tmp_path / "deep"),
                            format_version=format_version)
    desc = deep.push(seg, descriptor_for(seg))
    assert desc.load_spec["type"] == "local" and desc.size_bytes > 0
    assert read_format_version(desc.load_spec["path"]) \
        == (FORMAT_VERSION_V2 if format_version == 2 else FORMAT_VERSION)
    pulled = deep.pull(desc)
    _assert_bit_identical(seg, pulled)
    ref_seg = ref_load(desc.load_spec["path"])
    for q in _queries("roll"):
        got = _run([pulled], q)
        assert got == _run([seg], q)
        assert got == RefExecutor([ref_seg]).run_json(q)
    assert deep.kill(desc) and deep.pull(desc) is None


def test_v2_mixed_query_parity_with_floats(tmp_path):
    seg = _mixed()
    d = str(tmp_path / "v2")
    persist_segment_v2(seg, d)
    loaded = load_segment(d)
    q = {"queryType": "groupBy", "dataSource": "fmt", "intervals": IV,
         "granularity": "all", "dimensions": ["d"],
         "aggregations": [{"type": "count", "name": "rows"},
                          {"type": "longSum", "name": "s", "fieldName": "sm"},
                          {"type": "doubleSum", "name": "x",
                           "fieldName": "noise"}]}
    assert _run([loaded], q) == _run([seg], q)


def test_v2_run_domain_query_zero_host_decodes(tmp_path):
    """On the run-domain-eligible shape a V2 load plus a granularity-all
    groupBy longSum touches no decompressed row: planning reads persisted
    metadata, aggregation rides the seeded run tables, and the lazy
    columns never materialize."""
    seg = _rollup(datasource="rd")
    d = str(tmp_path / "v2")
    persist_segment_v2(seg, d)
    loaded = load_segment_v2(d)
    q = {"queryType": "groupBy", "dataSource": "rd", "intervals": IV,
         "granularity": "all", "dimensions": ["dimA"],
         "aggregations": [{"type": "count", "name": "rows"},
                          {"type": "longSum", "name": "c", "fieldName": "cnt"},
                          {"type": "longSum", "name": "v",
                           "fieldName": "val"}]}
    expected = _run([seg], q)
    hits = cascade.code_domain_stats().snapshot()["hits"]
    cascade.reset_decode_stats()
    got = _run([loaded], q)
    stats = cascade.decode_stats()
    cascade.reset_decode_stats()
    assert got == expected
    assert stats == {}, f"decodes on the zero-decode path: {stats}"
    assert cascade.code_domain_stats().snapshot()["hits"] == hits + 1
    assert not loaded.dims["dimA"].materialized()
    assert not loaded.metrics["cnt"].materialized()
    assert not loaded.metrics["val"].materialized()


def test_v2_load_stats_accumulate(tmp_path):
    seg = _rollup()
    d = str(tmp_path / "v2")
    persist_segment_v2(seg, d)
    before = segment_load_stats().snapshot()
    load_segment_v2(d)
    after = segment_load_stats().snapshot()
    assert after["bytes"] - before["bytes"] == seg.size_bytes()
    assert after["compressedBytes"] - before["compressedBytes"] \
        == sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    assert after["time_ms"] >= before["time_ms"]


def test_segment_load_monitor_emits_deltas():
    stats = SegmentLoadStats()
    mon = SegmentLoadMonitor(stats)
    stats.record(0.25, 1000, 300)
    stats.record(0.5, 24, 10)

    def tick():
        sink = InMemoryEmitter()
        mon.do_monitor(ServiceEmitter("historical", "h", sink))
        return {e.metric: e.value for e in sink.metrics()}
    assert tick() == {"segment/load/time": 750, "segment/load/bytes": 1024,
                      "segment/load/compressedBytes": 310}
    assert tick() == {"segment/load/time": 0, "segment/load/bytes": 0,
                      "segment/load/compressedBytes": 0}


# ---------------------------------------------------------------------------
# corruption: typed errors
# ---------------------------------------------------------------------------

def test_corrupt_truncated_chunk(tmp_path):
    d = str(tmp_path / "v2")
    persist_segment_v2(_rollup(), d)
    chunk = os.path.join(d, "chunk_00000.bin")
    with open(chunk, "r+b") as f:
        f.truncate(os.path.getsize(chunk) // 2)
    with pytest.raises(CorruptSegmentError) as ei:
        load_segment(d)
    assert d in str(ei.value)


def test_corrupt_part_size_mismatch(tmp_path):
    d = str(tmp_path / "v2")
    persist_segment_v2(_rollup(), d)
    meta_path = os.path.join(d, "meta.smoosh")
    out = []
    for ln in open(meta_path).read().splitlines():
        cols = ln.split(",")
        if cols[0] == "col.dimA.rle.values":
            cols[-1] = str(int(cols[-1]) - 4)
            ln = ",".join(cols)
        out.append(ln)
    open(meta_path, "w").write("\n".join(out) + "\n")
    with pytest.raises(CorruptSegmentError) as ei:
        load_segment(d)
    assert ei.value.part == "col.dimA.rle.values"
    assert "col.dimA.rle.values" in str(ei.value)


def test_corrupt_bad_version(tmp_path):
    d = str(tmp_path / "v2")
    persist_segment_v2(_rollup(), d)
    with open(os.path.join(d, "version.bin"), "wb") as f:
        f.write(struct.pack("<I", 99))
    with pytest.raises(CorruptSegmentError):
        load_segment(d)


def test_corrupt_garbage_index_json(tmp_path):
    d = str(tmp_path / "v2")
    persist_segment_v2(_rollup(), d)
    open(os.path.join(d, "meta.smoosh"), "w").write(
        "v1,2048,1\nnot,a,valid,line\n")
    with pytest.raises(CorruptSegmentError):
        read_segment_meta(d)


def test_load_queue_skips_and_records_corrupt_segment(tmp_path):
    """One damaged directory must not keep a node from serving its healthy
    segments: the load queue records the failure and loads the rest."""
    good, bad = _rollup(datasource="good"), _rollup(datasource="bad")
    deep = LocalDeepStorage(str(tmp_path / "deep"))
    d_good = deep.push(good, descriptor_for(good))
    d_bad = deep.push(bad, descriptor_for(bad))
    with open(os.path.join(d_bad.load_spec["path"], "chunk_00000.bin"),
              "r+b") as f:
        f.truncate(16)
    view, node = InventoryView(), DataNode("h-corrupt", device="cpu")
    view.register(node)
    peon = LoadQueuePeon(node, view, deep.pull)
    try:
        assert peon.load(d_bad) and peon.load(d_good)
        assert peon.wait_idle(30.0)
    finally:
        peon.stop()
    assert peon.loads_done == 1
    assert node.served_segment_ids() == {d_good.id}
    assert len(peon.failures) == 1
    assert peon.failures[0].startswith(f"load {d_bad.id}: corrupt segment")


# ---------------------------------------------------------------------------
# compressed wire partials over a loaded segment
# ---------------------------------------------------------------------------

def test_wire_compressed_partials_parity_and_ratio(tmp_path):
    d = str(tmp_path / "v2")
    persist_segment_v2(_rollup(rows=8192), d)
    seg = load_segment(d)
    q = query_from_json({
        "queryType": "groupBy", "dataSource": "roll", "intervals": IV,
        "granularity": "hour", "dimensions": ["dimA"],
        "aggregations": [{"type": "count", "name": "rows"},
                         {"type": "longSum", "name": "c",
                          "fieldName": "cnt"}]})
    ap = engines.make_aggregate_partials(q, [seg], torch.device("cpu"),
                                         clamp=False)
    raw = wire.dumps_partials(ap, served=[str(seg.id)], compress=False)
    comp = wire.dumps_partials(ap, served=[str(seg.id)], compress=True)
    assert len(raw) / len(comp) >= 4.0, (len(raw), len(comp))
    ap_raw, served_raw, _ = wire.loads_partials(raw)
    ap_comp, served_comp, _ = wire.loads_partials(comp)
    assert served_raw == served_comp == {str(seg.id)}
    assert engines.finish_groupby(q, ap_comp) \
        == engines.finish_groupby(q, ap_raw) \
        == engines.finish_groupby(q, ap)


def test_wire_uncompressed_payload_unchanged(tmp_path):
    d = str(tmp_path / "v2")
    persist_segment_v2(_rollup(rows=1024), d)
    q = query_from_json({"queryType": "timeseries", "dataSource": "roll",
                         "intervals": IV, "granularity": "all",
                         "aggregations": [{"type": "count", "name": "n"}]})
    ap = engines.make_aggregate_partials(q, [load_segment(d)],
                                         torch.device("cpu"))
    raw = wire.dumps_partials(ap, compress=False)
    assert raw[:4] == wire.MAGIC
    assert raw[4] == wire.VERSION


# ---------------------------------------------------------------------------
# golden fixtures: the bytes the reference wrote load in the port
# ---------------------------------------------------------------------------

GOLDEN_Q = {"queryType": "groupBy", "dataSource": "golden", "intervals": IV,
            "granularity": "all", "dimensions": ["dim"],
            "aggregations": [{"type": "count", "name": "rows"},
                             {"type": "longSum", "name": "s",
                              "fieldName": "lng"},
                             {"type": "doubleSum", "name": "x",
                              "fieldName": "dbl"}]}


@pytest.mark.parametrize("name,version", [("segment_v1", FORMAT_VERSION),
                                          ("segment_v2", FORMAT_VERSION_V2)])
def test_golden_fixture_loads_and_answers(name, version):
    d = str(GOLDEN_DIR / name)
    assert read_format_version(d) == version
    loaded = load_segment(d)
    fresh = _carry(_golden_segment())
    _assert_bit_identical(fresh, loaded)
    got = _run([loaded], GOLDEN_Q)
    assert _rows_equal(got, _run([fresh], GOLDEN_Q))
    assert _rows_equal(got, RefExecutor([ref_load(d)]).run_json(GOLDEN_Q))
    # numpy: 8 groups of 32 rows; lng = 7r mod 13; dbl has a NaN each 4
    lng = (np.arange(256) * 7) % 13
    for i, row in enumerate(got):
        ev = row["event"]
        assert ev["dim"] == f"g{i}" and ev["rows"] == 32
        assert ev["s"] == int(lng[32 * i:32 * (i + 1)].sum())
        assert np.isnan(ev["x"])


def test_golden_v2_parts_byte_stable(tmp_path):
    """The port's V2 writer persists the golden segment to the fixture's
    bytes: every raw part (rle tables, pack words, lz4 blobs) and every
    other part, block-codec parts and index.json included."""
    d = str(tmp_path / "fresh")
    persist_segment_v2(_carry(_golden_segment()), d)
    with SmooshedFileMapper(str(GOLDEN_DIR / "segment_v2")) as golden, \
            SmooshedFileMapper(d) as fresh:
        assert set(golden.names()) == set(fresh.names())
        raw = [p for p in golden.names()
               if ".rle." in p or p.endswith((".pack", ".lz4"))]
        assert raw
        for part in golden.names():
            assert bytes(golden.part(part)) == bytes(fresh.part(part)), \
                f"part {part} drifted"
