"""On-disk segment format (V1): columnar parts in a smoosh container.

The port's copy of the reference package's `storage/format.py`: the same
parts and bytes, so either package loads the other's segments. Capability
parity with Druid's V9 segment format
(processing/.../segment/IndexIO.java:86-116 — version.bin, meta.smoosh,
index.drd, per-column ColumnDescriptor parts;
segment/serde/DictionaryEncodedColumnPartSerde.java:57). TPU-first layout
decisions:
  * every physical column part is a dense block-compressed array (the host
    C++ LZ4 codec) that decodes straight into the numpy array device
    staging expects: no per-row varint decoding on the critical path;
  * string dims store (sorted dictionary blob, int32 id column, per-value
    bitmap index), exactly the planning structures the host filter planner
    uses; the device never sees strings;
  * bitmaps load lazily (the reference mmaps them on demand too).

Layout: <dir>/version.bin (u32=1), meta.smoosh + chunk files. Parts:
  index.json                segment identity + schema + row count
  __time                    int64 millis, block-compressed
  dim.<name>.dict           utf8 dictionary (n, offsets[n+1], bytes)
  dim.<name>.ids            int32 ids, block-compressed
  dim.<name>.bitmaps        per-value packed-word bitmaps, LZ4 per value
  met.<name>                numeric column, block-compressed
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional, Sequence

import numpy as np

from druid_tpu_torch.data.bitmap import Bitmap, BitmapIndex
from druid_tpu_torch.data.dictionary import Dictionary
from druid_tpu_torch.data.segment import (ComplexColumn, NumericColumn,
                                          Segment, SegmentId,
                                          StringDimColumn, ValueType)
from druid_tpu_torch.storage import codec as codecs
from druid_tpu_torch.storage.smoosh import (CorruptSegmentError,
                                            FileSmoosher, SmooshedFileMapper)
from druid_tpu_torch.utils.intervals import Interval

FORMAT_VERSION = 3  # v3: value-encoding byte in column parts (delta longs)
FORMAT_VERSION_V2 = 4  # "segment format V2": cascade-form column parts


def read_format_version(directory: str) -> int:
    """The version.bin tag that routes load_segment between V1 (block-codec
    columns, eager decode) and V2 (cascade-form parts, lazy columns)."""
    path = os.path.join(directory, "version.bin")
    if not os.path.exists(path):
        raise CorruptSegmentError(directory, "missing version.bin")
    with open(path, "rb") as f:
        raw = f.read(4)
    if len(raw) != 4:
        raise CorruptSegmentError(directory, "truncated version.bin")
    (version,) = struct.unpack("<I", raw)
    return version


def _encode_dictionary(d: Dictionary) -> bytes:
    blobs = [v.encode("utf-8") for v in d.values]
    offsets = np.zeros(len(blobs) + 1, dtype=np.int32)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    return (struct.pack("<i", len(blobs)) + offsets.tobytes()
            + b"".join(blobs))


def _decode_dictionary(buf) -> Dictionary:
    buf = memoryview(buf)
    (n,) = struct.unpack_from("<i", buf, 0)
    offsets = np.frombuffer(buf, dtype=np.int32, count=n + 1, offset=4)
    base = 4 + (n + 1) * 4
    blob = bytes(buf[base:base + int(offsets[-1])])
    values = [blob[offsets[i]:offsets[i + 1]].decode("utf-8")
              for i in range(n)]
    return Dictionary(values)


def _bitmap_parts(index: BitmapIndex, codec: int):
    """Per-value compressed bitmap parts — the one layout definition the
    in-memory and writeout-file encoders share. Each part compresses
    `index.bitmap(vid).words`. Where the index holds its sorted row order
    (a built index), the value's row bits are set into one reused word
    buffer and cleared after, without materializing (and caching) each
    bitmap: the same bytes, at a cost in the value's rows rather than the
    segment's."""
    words = np.zeros((index.n_rows + 7) // 8, dtype=np.uint8)
    for vid in range(index.cardinality):
        rows = index.rows_of(vid)
        if rows is None:
            yield codecs.compress_block(codec,
                                        index.bitmap(vid).words.tobytes())
            continue
        at = rows >> 3
        np.bitwise_or.at(words, at, (0x80 >> (rows & 7)).astype(np.uint8))
        # NONE returns its input: hand it a copy of the reused buffer
        yield codecs.compress_block(
            codec, words.tobytes() if codec == codecs.NONE else words)
        words[at] = 0


def _bitmap_header(index: BitmapIndex, codec: int,
                   sizes: Sequence[int]) -> bytes:
    offsets = np.zeros(index.cardinality + 1, dtype=np.int64)
    np.cumsum(np.asarray(sizes, dtype=np.int64), out=offsets[1:])
    return (struct.pack("<qiB", index.n_rows, index.cardinality, codec)
            + offsets.tobytes())


def _encode_bitmap_index(index: BitmapIndex, codec: int) -> bytes:
    parts = list(_bitmap_parts(index, codec))
    return _bitmap_header(index, codec, [len(p) for p in parts]) \
        + b"".join(parts)


def _encode_bitmap_index_to_file(index: BitmapIndex, codec: int,
                                 out_path: str) -> None:
    """Byte-identical to _encode_bitmap_index (shared _bitmap_parts /
    _bitmap_header) with O(one bitmap) peak memory."""
    from druid_tpu_torch.storage.codec import _copy_file_into
    blocks_path = out_path + ".blocks"
    sizes: list = []
    with open(blocks_path, "wb") as bf:
        for part in _bitmap_parts(index, codec):
            sizes.append(len(part))
            bf.write(part)
    with open(out_path, "wb") as f:
        f.write(_bitmap_header(index, codec, sizes))
        _copy_file_into(f, blocks_path)
    os.remove(blocks_path)


class LazyBitmapIndex(BitmapIndex):
    """BitmapIndex that decompresses per-value bitmaps on first access —
    the analog of the reference mmapping bitmap parts on demand."""

    def __init__(self, buf):
        buf = memoryview(buf)
        n_rows, cardinality, codec = struct.unpack_from("<qiB", buf, 0)
        off = 13
        self._offsets = np.frombuffer(buf, dtype=np.int64,
                                      count=cardinality + 1, offset=off)
        self._blob = buf[off + (cardinality + 1) * 8:]
        self._codec = codec
        self._word_bytes = (n_rows + 7) // 8
        super().__init__(n_rows, cardinality,
                         [None] * cardinality)  # type: ignore[list-item]

    def bitmap(self, value_id: int) -> Bitmap:
        if value_id < 0 or value_id >= self.cardinality:
            return Bitmap.empty(self.n_rows)
        with self._lock:
            b = self._bitmaps[value_id]
            if b is None:
                lo, hi = (int(self._offsets[value_id]),
                          int(self._offsets[value_id + 1]))
                words = np.frombuffer(
                    codecs.decompress_block(self._codec, self._blob[lo:hi],
                                            self._word_bytes), dtype=np.uint8)
                b = Bitmap(words.copy(), self.n_rows)
                # decompressed bitmaps live under the index's LRU byte
                # budget exactly like lazily-built ones
                self._cache_put(value_id, b)
            elif value_id in self._lru:
                self._lru.move_to_end(value_id)
            return b

    def union_of(self, value_ids: np.ndarray) -> Bitmap:
        """Stream the OR into one accumulator: a wide IN/regex union over
        thousands of values must neither hold every decompressed bitmap at
        once nor thrash the LRU cache."""
        valid = [int(v) for v in value_ids if 0 <= v < self.cardinality]
        if not valid:
            return Bitmap.empty(self.n_rows)
        acc = np.zeros(self._word_bytes, dtype=np.uint8)
        for v in valid:
            with self._lock:
                cached = self._bitmaps[v]
            if cached is not None:
                words = cached.words
            else:
                lo, hi = int(self._offsets[v]), int(self._offsets[v + 1])
                words = np.frombuffer(
                    codecs.decompress_block(self._codec, self._blob[lo:hi],
                                            self._word_bytes),
                    dtype=np.uint8)
            np.bitwise_or(acc, words, out=acc)
        return Bitmap(acc, self.n_rows)

    def size_bytes(self) -> int:
        return int(self._offsets[-1])


def persist_segment(segment: Segment, directory: str,
                    codec: Optional[int] = None,
                    build_bitmaps: bool = True,
                    chunk_size: int = 1 << 31,
                    writeout: str = "memory") -> int:
    """Write a segment to `directory`; returns total bytes written.

    writeout="tmpfile" streams every compressed part through temp writeout
    files (peak extra memory O(64KB block) instead of O(largest compressed
    part)) — the reference's FileWriteOutMedium vs OnHeapMemory
    WriteOutMedium choice (processing/.../segment/writeout/). The on-disk
    result is byte-identical.

    Reference analog: IndexMergerV9.persist
    (processing/.../segment/IndexMergerV9.java:729)."""
    if codec is None:
        codec = codecs.default_codec()
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "version.bin"), "wb") as f:
        f.write(struct.pack("<I", FORMAT_VERSION))

    meta = {
        "datasource": segment.id.datasource,
        "interval": [segment.id.interval.start, segment.id.interval.end],
        "version": segment.id.version,
        "partition": segment.id.partition,
        "n_rows": segment.n_rows,
        "dimensions": list(segment.dims.keys()),
        "metrics": {k: (f"complex:{v.type_name}"
                        if v.type is ValueType.COMPLEX else v.type.value)
                    for k, v in segment.metrics.items()},
        "min_time": segment.min_time,
        "max_time": segment.max_time,
        "codec": codec,
    }
    with FileSmoosher(directory, chunk_size) as sm:
        if writeout == "tmpfile":
            import tempfile
            wo_dir = tempfile.mkdtemp(prefix="writeout_", dir=directory)

            def add_array(name, arr):
                path = os.path.join(wo_dir, "part")
                codecs.compress_array_to_file(arr, path, codec)
                sm.add_from_file(name, path)
                os.remove(path)

            def add_bitmaps(name, index):
                path = os.path.join(wo_dir, "part")
                _encode_bitmap_index_to_file(index, codec, path)
                sm.add_from_file(name, path)
                os.remove(path)
        else:
            def add_array(name, arr):
                sm.add(name, codecs.compress_array(arr, codec))

            def add_bitmaps(name, index):
                sm.add(name, _encode_bitmap_index(index, codec))

        sm.add("index.json", json.dumps(meta).encode())
        add_array("__time", segment.time_ms)
        for name, col in segment.dims.items():
            sm.add(f"dim.{name}.dict", _encode_dictionary(col.dictionary))
            add_array(f"dim.{name}.ids", col.ids)
            if build_bitmaps:
                add_bitmaps(f"dim.{name}.bitmaps", col.bitmap_index())
        for name, m in segment.metrics.items():
            add_array(f"met.{name}", m.values)
        if writeout == "tmpfile":
            os.rmdir(wo_dir)
    total = 0
    for fn in os.listdir(directory):
        total += os.path.getsize(os.path.join(directory, fn))
    return total


def load_segment(directory: str,
                 columns: Optional[Sequence[str]] = None) -> Segment:
    """mmap + decode a persisted segment. Column values decode eagerly via
    the C++ codec's batch LZ4 (multi-threaded); bitmap indexes attach
    lazily. A format-V2 directory routes to load_segment_v2.

    Reference analog: IndexIO.loadIndex (segment/IndexIO.java:116)."""
    version = read_format_version(directory)
    if version == FORMAT_VERSION_V2:
        from druid_tpu_torch.storage.format_v2 import load_segment_v2
        return load_segment_v2(directory, columns=columns)
    if version != FORMAT_VERSION:
        raise CorruptSegmentError(
            directory, f"unknown segment format version {version}")
    mapper = SmooshedFileMapper(directory)
    try:
        meta = json.loads(bytes(mapper.part("index.json")))
    except (ValueError, KeyError) as e:
        if isinstance(e, CorruptSegmentError):
            raise
        raise CorruptSegmentError(directory, f"bad index.json: {e}",
                                  part="index.json") from None
    seg_id = SegmentId(meta["datasource"],
                       Interval(meta["interval"][0], meta["interval"][1]),
                       meta["version"], meta["partition"])
    time_ms = decompress_part(mapper, "__time")
    dims: Dict[str, StringDimColumn] = {}
    for name in meta["dimensions"]:
        if columns is not None and name not in columns:
            continue
        d = _decode_dictionary(mapper.part(f"dim.{name}.dict"))
        ids = decompress_part(mapper, f"dim.{name}.ids").copy()
        col = StringDimColumn(ids, d)
        bm_part = f"dim.{name}.bitmaps"
        if mapper.has(bm_part):
            col.set_bitmap_index(LazyBitmapIndex(mapper.part(bm_part)))
        dims[name] = col
    metrics: Dict[str, object] = {}
    for name, tname in meta["metrics"].items():
        if columns is not None and name not in columns:
            continue
        vals = decompress_part(mapper, f"met.{name}").copy()
        if tname.startswith("complex:"):
            metrics[name] = ComplexColumn(vals, tname.split(":", 1)[1])
        else:
            metrics[name] = NumericColumn(vals, ValueType(tname))
    seg = Segment(seg_id, time_ms.copy(), dims, metrics)
    # keep the mmaps alive for the lazy bitmap loads (`seg` has no other
    # referent until this return)
    seg._mapper = mapper
    return seg


def decompress_part(mapper: SmooshedFileMapper, name: str) -> np.ndarray:
    return codecs.decompress_array(mapper.part(name))


def read_segment_meta(directory: str) -> dict:
    """index.json of a persisted segment — both V1 and V2 carry the same
    identity/schema keys (V2 adds a "v2" section with the cascade
    descriptors). Raises CorruptSegmentError on any structural damage."""
    with SmooshedFileMapper(directory) as mapper:
        try:
            return json.loads(bytes(mapper.part("index.json")))
        except (ValueError, KeyError) as e:
            if isinstance(e, CorruptSegmentError):
                raise
            raise CorruptSegmentError(directory, f"bad index.json: {e}",
                                      part="index.json") from None
