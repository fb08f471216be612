"""The port's segment storage (druid_tpu_torch/storage/) against the
reference's (druid_tpu/storage/): the cases of tests/test_storage.py on
the port (codecs, smoosh, the dictionary, value encodings, writeout files,
the bitmap index part, persist/load and queries over a loaded segment);
cross-loading, where a segment persisted by either package in V1 or V2
loads in the other with bit-identical columns and equal groupBy, topN and
timeseries rows; the writers' byte identity, part by part with equal
index.json files; and corrupt directories, which raise CorruptSegmentError
naming the same part in both packages."""
import json
import os

import numpy as np
import pytest
import torch

import druid_tpu.engine  # noqa: F401  (x64 on before jax numerics)
from druid_tpu.data.generator import DataGenerator
from druid_tpu.engine.executor import QueryExecutor as RefExecutor
from druid_tpu.storage import codec as ref_codecs
from druid_tpu.storage.format import load_segment as ref_load
from druid_tpu.storage.format import persist_segment as ref_persist_v1
from druid_tpu.storage.format_v2 import persist_segment_v2 as ref_persist_v2
from druid_tpu.storage.smoosh import CorruptSegmentError as RefCorrupt

from druid_tpu_torch import native
from druid_tpu_torch.data.bitmap import BitmapIndex
from druid_tpu_torch.data.dictionary import Dictionary
from druid_tpu_torch.engine import QueryExecutor
from druid_tpu_torch.storage import codec as codecs
from druid_tpu_torch.storage.format import (LazyBitmapIndex,
                                            _decode_dictionary,
                                            _encode_bitmap_index,
                                            _encode_dictionary, load_segment,
                                            persist_segment,
                                            read_segment_meta)
from druid_tpu_torch.storage.format_v2 import persist_segment_v2
from druid_tpu_torch.storage.smoosh import (CorruptSegmentError,
                                            FileSmoosher, SmooshedFileMapper)
from tests.conftest import DAY, TEST_SCHEMA
from tests.test_format_v2 import _golden_segment, _mixed_segment
from tests.test_torch_slice import _carry

torch.set_num_threads(1)

IV = ["2026-01-01/2026-01-02"]


@pytest.fixture(scope="module")
def ref_segment():
    return DataGenerator(TEST_SCHEMA, seed=42).segment(20_000, DAY,
                                                       datasource="test")


@pytest.fixture(scope="module", params=("generated", "persisted"))
def segment(request, ref_segment, tmp_path_factory):
    """The port's engine-facing segment in both forms: built in memory, and
    persisted (V1) and loaded again by the port."""
    seg = _carry(ref_segment)
    if request.param == "persisted":
        d = str(tmp_path_factory.mktemp("seg") / "test")
        persist_segment(seg, d)
        return load_segment(d)
    return seg


# ---------------------------------------------------------------------------
# tests/test_storage.py's cases on the port
# ---------------------------------------------------------------------------

def test_native_available():
    assert native.available()


@pytest.mark.parametrize("codec", [codecs.LZ4, codecs.ZLIB, codecs.NONE])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32,
                                   np.float64, np.uint8])
def test_codec_roundtrip(codec, dtype):
    rng = np.random.default_rng(3)
    for n in [0, 1, 7, 1000, 65536 // np.dtype(dtype).itemsize, 200_001]:
        if np.issubdtype(dtype, np.integer):
            arr = rng.integers(0, 50, n).astype(dtype)
        else:
            arr = rng.normal(size=n).astype(dtype)
        buf = codecs.compress_array(arr, codec)
        out = codecs.decompress_array(buf)
        assert out.dtype == arr.dtype
        np.testing.assert_array_equal(out, arr)
        # the reference writes the same part and reads the port's
        assert buf == ref_codecs.compress_array(arr, codec)
        np.testing.assert_array_equal(ref_codecs.decompress_array(buf), arr)


def test_codec_incompressible_falls_back_to_raw():
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 2**63 - 1, 50_000).astype(np.int64)
    buf = codecs.compress_array(arr, codecs.LZ4)
    assert len(buf) < arr.nbytes * 1.01 + 1024
    np.testing.assert_array_equal(codecs.decompress_array(buf), arr)


def test_smoosh_roundtrip(tmp_path):
    d = str(tmp_path / "sm")
    parts = {f"part{i}": bytes([i]) * (1000 * (i + 1)) for i in range(5)}
    with FileSmoosher(d, chunk_size=2500) as sm:
        for k, v in parts.items():
            sm.add(k, v)
    with SmooshedFileMapper(d) as m:
        assert set(m.names()) == set(parts)
        for k, v in parts.items():
            assert bytes(m.part(k)) == v
    chunks = [f for f in os.listdir(d) if f.startswith("chunk_")]
    assert len(chunks) > 1


def test_smoosh_duplicate_name(tmp_path):
    with FileSmoosher(str(tmp_path / "sm")) as sm:
        sm.add("a", b"x")
        with pytest.raises(ValueError):
            sm.add("a", b"y")


def test_dictionary_roundtrip():
    d = Dictionary(sorted(["", "a", "héllo", "zz", "中文", "a b,c"]))
    out = _decode_dictionary(_encode_dictionary(d))
    assert out.values == d.values


def test_delta_encoding_roundtrip_and_wins():
    from druid_tpu_torch.storage.codec import (ENC_DELTA, _pick_encoding,
                                               compress_array,
                                               decompress_array)
    t0 = 1_750_000_000_000
    ts = t0 + np.cumsum(np.random.default_rng(1).integers(
        0, 2000, 500_000)).astype(np.int64)
    enc = compress_array(ts)
    assert np.array_equal(decompress_array(enc), ts)
    raw = compress_array(ts, encoding="none")
    assert np.array_equal(decompress_array(raw), ts)
    assert len(enc) < len(raw) * 0.75, (len(enc), len(raw))
    vals = np.random.default_rng(2).integers(-(2**62), 2**62, 10_000)
    assert np.array_equal(decompress_array(compress_array(vals)), vals)
    edge = np.asarray([-(2**63), 2**63 - 1, -(2**63) + 5], dtype=np.int64)
    assert np.array_equal(
        decompress_array(compress_array(edge, encoding="delta")), edge)
    u = np.sort(np.random.default_rng(4).integers(
        0, 2**64, 10_000, dtype=np.uint64))
    assert np.array_equal(decompress_array(compress_array(u)), u)
    nm = np.asarray([10, 3, 7, 1], dtype=np.uint64)
    assert _pick_encoding(nm, "auto") != ENC_DELTA
    assert np.array_equal(decompress_array(compress_array(nm)), nm)
    with pytest.raises(ValueError):
        compress_array(ts, encoding="tabel")
    assert np.array_equal(
        decompress_array(compress_array(ts, encoding="table")), ts)
    f = np.random.default_rng(3).normal(size=1000).astype(np.float32)
    assert np.array_equal(decompress_array(compress_array(f)), f)
    m = np.arange(64, dtype=np.int64).reshape(8, 8)
    assert np.array_equal(decompress_array(compress_array(m)), m)


def test_tmpfile_writeout_byte_identical(tmp_path, segment):
    d_mem, d_wo = str(tmp_path / "mem"), str(tmp_path / "wo")
    persist_segment(segment, d_mem)
    persist_segment(segment, d_wo, writeout="tmpfile")
    files_mem = sorted(os.listdir(d_mem))
    assert files_mem == sorted(os.listdir(d_wo))
    for f in files_mem:
        with open(os.path.join(d_mem, f), "rb") as a, \
                open(os.path.join(d_wo, f), "rb") as b:
            assert a.read() == b.read(), f
    back = load_segment(d_wo)
    assert back.n_rows == segment.n_rows
    assert np.array_equal(back.time_ms, segment.time_ms)
    assert not [f for f in files_mem if f.startswith("writeout_")]


def test_bitmap_index_roundtrip():
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 17, 5000).astype(np.int32)
    idx = BitmapIndex.build(ids, 17)
    buf = _encode_bitmap_index(idx, codecs.LZ4)
    lazy = LazyBitmapIndex(buf)
    assert lazy.n_rows == idx.n_rows and lazy.cardinality == idx.cardinality
    for vid in [0, 5, 16]:
        np.testing.assert_array_equal(lazy.bitmap(vid).to_bool(),
                                      idx.bitmap(vid).to_bool())
    np.testing.assert_array_equal(
        lazy.union_of(np.array([1, 3, 9])).to_bool(),
        idx.union_of(np.array([1, 3, 9])).to_bool())
    # the reference's encoder writes the same part
    from druid_tpu.data.bitmap import BitmapIndex as RefIndex
    from druid_tpu.storage.format import _encode_bitmap_index as ref_encode
    assert buf == ref_encode(RefIndex.build(ids, 17), ref_codecs.LZ4)


def test_segment_persist_load_roundtrip(tmp_path, segment):
    d = str(tmp_path / "seg")
    assert persist_segment(segment, d) > 0
    loaded = load_segment(d)
    assert loaded.id == segment.id
    assert loaded.n_rows == segment.n_rows
    np.testing.assert_array_equal(loaded.time_ms, segment.time_ms)
    for name, col in segment.dims.items():
        np.testing.assert_array_equal(loaded.dims[name].ids, col.ids)
        assert loaded.dims[name].dictionary == col.dictionary
        np.testing.assert_array_equal(
            loaded.dims[name].bitmap_index().bitmap(1).to_bool(),
            col.bitmap_index().bitmap(1).to_bool())
    for name, m in segment.metrics.items():
        assert loaded.metrics[name].type == m.type
        np.testing.assert_array_equal(loaded.metrics[name].values, m.values)
    assert read_segment_meta(d)["n_rows"] == segment.n_rows


def test_segment_load_column_subset(tmp_path, segment):
    d = str(tmp_path / "seg2")
    persist_segment(segment, d, build_bitmaps=False)
    first_dim = next(iter(segment.dims))
    first_met = next(iter(segment.metrics))
    loaded = load_segment(d, columns=[first_dim, first_met])
    assert list(loaded.dims) == [first_dim]
    assert list(loaded.metrics) == [first_met]


def test_loaded_segment_queries_match(tmp_path, segment):
    d = str(tmp_path / "seg3")
    persist_segment(segment, d)
    loaded = load_segment(d)
    dim = next(iter(segment.dims))
    val = segment.dims[dim].dictionary.values[1]
    q = {"queryType": "timeseries", "dataSource": "test", "intervals": IV,
         "granularity": "hour",
         "filter": {"type": "selector", "dimension": dim, "value": val},
         "aggregations": [{"type": "count", "name": "rows"},
                          {"type": "longSum", "name": "s",
                           "fieldName": "metLong"}]}
    assert QueryExecutor([loaded], device="cpu").run_json(q) \
        == QueryExecutor([segment], device="cpu").run_json(q)


def test_vsize_packing_roundtrip_and_shrink():
    from druid_tpu_torch.storage.codec import (ENC_VSIZE8, ENC_VSIZE16,
                                               _pick_encoding, compress_array,
                                               decompress_array)
    rng = np.random.default_rng(5)
    for hi, enc in ((250, ENC_VSIZE8), (60_000, ENC_VSIZE16)):
        arr = rng.integers(0, hi, size=200_000).astype(np.int64)
        assert _pick_encoding(arr, "auto") == enc
        buf = compress_array(arr, encoding="auto")
        assert np.array_equal(decompress_array(buf), arr)
        raw = compress_array(arr, encoding="none")
        assert len(buf) < len(raw) * 0.7
    neg = rng.integers(-5, 5, size=1000).astype(np.int64)
    assert _pick_encoding(neg, "auto") == 0
    assert np.array_equal(
        decompress_array(compress_array(neg, encoding="auto")), neg)


def test_table_encoding_roundtrip():
    from druid_tpu_torch.storage.codec import (ENC_TABLE, _pick_encoding,
                                               compress_array,
                                               decompress_array)
    rng = np.random.default_rng(6)
    vals = np.array([10**12 + v * 10**9 for v in range(40)], dtype=np.int64)
    arr = vals[rng.integers(0, 40, size=100_000)]
    assert _pick_encoding(arr, "table") == ENC_TABLE
    buf = compress_array(arr, encoding="table")
    assert np.array_equal(decompress_array(buf), arr)
    wide = rng.integers(0, 10**12, size=5000).astype(np.int64)
    assert _pick_encoding(wide, "table") == 0


def test_vsize_writeout_file_byte_identical(tmp_path):
    from druid_tpu_torch.storage.codec import (compress_array,
                                               compress_array_to_file)
    rng = np.random.default_rng(7)
    arr = rng.integers(0, 200, size=300_000).astype(np.int64)
    p = str(tmp_path / "part.bin")
    compress_array_to_file(arr, p, encoding="auto")
    with open(p, "rb") as f:
        assert f.read() == compress_array(arr, encoding="auto")


# ---------------------------------------------------------------------------
# the writers' bytes and cross-loading
# ---------------------------------------------------------------------------

SEGMENTS = {"mixed": _mixed_segment, "golden": _golden_segment,
            "generated": lambda: DataGenerator(TEST_SCHEMA, seed=7).segment(
                6000, DAY, datasource="test")}
WRITERS = {"v1": (ref_persist_v1, persist_segment),
           "v2": (ref_persist_v2, persist_segment_v2)}


@pytest.mark.parametrize("fmt", sorted(WRITERS))
@pytest.mark.parametrize("which", sorted(SEGMENTS))
def test_writers_write_the_same_parts(tmp_path, which, fmt):
    """For the same segment both packages' writers produce the same part
    names and bytes, block-codec parts included (one C++ source), and
    index.json files that parse to equal objects."""
    ref = SEGMENTS[which]()
    ref_write, port_write = WRITERS[fmt]
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_write(ref, a)
    port_write(_carry(ref), b)
    with SmooshedFileMapper(a) as ma, SmooshedFileMapper(b) as mb:
        assert ma.names() == mb.names()
        for part in ma.names():
            assert bytes(ma.part(part)) == bytes(mb.part(part)), part
        assert json.loads(bytes(ma.part("index.json"))) \
            == json.loads(bytes(mb.part("index.json")))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))


def _bits(a):
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.floating):
        return a.view(np.dtype(f"<i{a.dtype.itemsize}"))
    return a


def _same_columns(ref, port):
    assert str(ref.id) == str(port.id) and ref.n_rows == port.n_rows
    np.testing.assert_array_equal(ref.time_ms, port.time_ms)
    assert list(ref.dims) == list(port.dims)
    for name, col in ref.dims.items():
        np.testing.assert_array_equal(col.ids, port.dims[name].ids)
        assert col.dictionary.values == port.dims[name].dictionary.values
    assert list(ref.metrics) == list(port.metrics)
    for name, m in ref.metrics.items():
        p = port.metrics[name]
        assert m.type.value == p.type.value
        assert np.asarray(m.values).dtype == np.asarray(p.values).dtype
        np.testing.assert_array_equal(_bits(m.values), _bits(p.values))


def _cross_queries(dim):
    aggs = [{"type": "count", "name": "rows"},
            {"type": "longSum", "name": "ls", "fieldName": "lng"},
            {"type": "longMax", "name": "lx", "fieldName": "lng"}]
    return [
        {"queryType": "groupBy", "dataSource": "cross", "intervals": IV,
         "granularity": "all", "dimensions": [dim], "aggregations": aggs},
        {"queryType": "topN", "dataSource": "cross", "intervals": IV,
         "granularity": "all", "dimension": dim, "metric": "ls",
         "threshold": 5, "aggregations": aggs},
        {"queryType": "timeseries", "dataSource": "cross", "intervals": IV,
         "granularity": "hour", "aggregations": aggs}]


def _cross_segment():
    from druid_tpu.data.segment import SegmentBuilder
    from druid_tpu.utils.intervals import Interval as RefInterval
    rng = np.random.default_rng(21)
    rows = 5000
    iv = RefInterval.of("2026-01-01", "2026-01-02")
    b = SegmentBuilder("cross", iv, version="v0", partition=0)
    b.add_columns(
        iv.start + np.sort(rng.integers(0, 86_400_000, rows)),
        {"d": np.repeat([f"k{i:02d}" for i in range(20)], rows // 20)
              .tolist(),
         "r": [f"x{v:03d}" for v in rng.integers(0, 300, rows)]},
        {"lng": rng.integers(-50, 50, rows).astype(np.int64),
         "cnt": np.ones(rows, dtype=np.int64),
         "dbl": np.tile(np.array([1.5, -0.0, np.nan, 2.0]), rows // 4),
         "noise": rng.random(rows)})
    return b.build()


@pytest.mark.parametrize("fmt", sorted(WRITERS))
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_cross_load(tmp_path, direction, fmt):
    """A segment persisted by either package loads in the other with
    bit-identical columns, and groupBy, topN and timeseries rows over it
    are equal in both packages."""
    ref = _cross_segment()
    ref_write, port_write = WRITERS[fmt]
    d = str(tmp_path / "seg")
    if direction == "ref_to_port":
        ref_write(ref, d)
    else:
        port_write(_carry(ref), d)
    port_seg, ref_seg = load_segment(d), ref_load(d)
    _same_columns(ref, port_seg)
    _same_columns(ref, ref_seg)
    for dim in ("d", "r"):
        for q in _cross_queries(dim):
            want = RefExecutor([ref_seg]).run_json(q)
            got = QueryExecutor([port_seg], device="cpu").run_json(q)
            assert json.dumps(got, sort_keys=True) \
                == json.dumps(want, sort_keys=True), q["queryType"]


# ---------------------------------------------------------------------------
# corrupt directories: the same typed error, naming the same part
# ---------------------------------------------------------------------------

def _truncate_chunk(d):
    chunk = os.path.join(d, "chunk_00000.bin")
    with open(chunk, "r+b") as f:
        f.truncate(os.path.getsize(chunk) // 2)


def _shrink_part(name):
    def corrupt(d):
        meta_path = os.path.join(d, "meta.smoosh")
        out = []
        for ln in open(meta_path).read().splitlines():
            cols = ln.split(",")
            if cols[0] == name:
                cols[-1] = str(int(cols[-1]) - 4)
                ln = ",".join(cols)
            out.append(ln)
        open(meta_path, "w").write("\n".join(out) + "\n")
    return corrupt


def _bad_version(d):
    with open(os.path.join(d, "version.bin"), "wb") as f:
        f.write((99).to_bytes(4, "little"))


def _garbage_meta(d):
    open(os.path.join(d, "meta.smoosh"), "w").write(
        "v1,2048,1\nnot,a,valid,line\n")


def _drop_part(name):
    def corrupt(d):
        meta_path = os.path.join(d, "meta.smoosh")
        lines = [ln for ln in open(meta_path).read().splitlines()
                 if ln.split(",")[0] != name]
        open(meta_path, "w").write("\n".join(lines) + "\n")
    return corrupt


CORRUPTIONS = {"truncated_chunk": _truncate_chunk,
               "rle_values_short": _shrink_part("col.d.rle.values"),
               "pack_short": _shrink_part("col.sm.pack"),
               "bad_version": _bad_version, "garbage_meta": _garbage_meta,
               "missing_index": _drop_part("index.json"),
               "missing_dict": _drop_part("dim.r.dict")}


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("how", sorted(CORRUPTIONS))
def test_corrupt_segment_same_error_and_part(tmp_path, how, writer):
    seg = _mixed_segment()
    d = str(tmp_path / "v2")
    if writer == "ref":
        ref_persist_v2(seg, d)
    else:
        persist_segment_v2(_carry(seg), d)
    CORRUPTIONS[how](d)
    with pytest.raises(RefCorrupt) as want:
        ref_load(d)
    with pytest.raises(CorruptSegmentError) as got:
        load_segment(d)
    assert got.value.part == want.value.part
    assert got.value.path == want.value.path == d
    assert str(got.value) == str(want.value)
