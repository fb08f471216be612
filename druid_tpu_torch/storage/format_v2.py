"""Segment format V2: the cascade form is the on-disk column format.

The port's copy of the reference package's `storage/format_v2.py`: the
same parts, bytes and `index.json`, so either package loads the other's
segments. V1 (storage/format.py) persists decoded columns behind a block
codec and decodes every part at load. V2 persists an eligible column in the
encoded form the planner picks for it (storage/plan.py, the reference's
persist-time planner) --

  col.<name>.rle.values / .rle.ends   int32 run tables, raw little-endian
  col.<name>.pack                     tile-planar packed words (int32), raw
  col.<name>.lz4                      LZ4-block blob (float columns)

-- with the `(col, codec, width, base, ...)` descriptors in index.json, so
`load_segment` is mmap plus zero-copy descriptor reconstruction: run and
word tables are `np.frombuffer` views over the page cache, and decoded rows
exist only as lazy columns that decode (and count a `host:<kind>` decode in
`cascade.decode_stats`) when a host path first reads them. The load seeds
the segment's cached stats from the descriptors (run counts, run tables,
min/max, finiteness, the largest time gap), so planning a loaded segment,
run-domain aggregation over its run tables, and filter leaves from its
persisted bitmap indexes decode no row. Ineligible columns keep the V1
block-codec part (`dim.<name>.ids` / `met.<name>`) and load eagerly; V1
segments keep loading through the version.bin route in
storage/format.load_segment.

The port stages packed words only in the projection's permuted row order
(engine/grouping.py), and a staged LZ4 or RLE rung is not ported (ROADMAP
A6). So a loaded packed, RLE or LZ4 column that a query stages is decoded
on the host once, the first time it is staged, and kept decoded for the
segment's life; the persisted words are not uploaded as they are. The
mmap stays open as long as the segment (`Segment._mapper`).

The writer streams each bitmap index through a writeout file (one bitmap
in memory at a time); its bytes equal the in-memory encoder's.
`persist_segment_auto(segment, directory, format_version=2)` is the product
entry point (deep-storage push); `format_version=1` writes V1. The port
reads no environment variable for it (the reference's
DRUID_TPU_SEGMENT_FORMAT).
"""
from __future__ import annotations

import json
import os
import struct
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from druid_tpu_torch.data import cascade as cascade_mod
from druid_tpu_torch.data import packed as packed_mod
from druid_tpu_torch.data.segment import (DEFAULT_ROW_ALIGN, ComplexColumn,
                                          NumericColumn, Segment, SegmentId,
                                          StringDimColumn, ValueType)
from druid_tpu_torch.engine.contracts import PACK_WORD_BITS
from druid_tpu_torch.storage import codec as codecs
from druid_tpu_torch.storage import plan as plan_mod
from druid_tpu_torch.storage.format import (FORMAT_VERSION_V2,
                                            LazyBitmapIndex,
                                            _decode_dictionary,
                                            _encode_bitmap_index_to_file,
                                            _encode_dictionary)
from druid_tpu_torch.storage.smoosh import (CorruptSegmentError,
                                            FileSmoosher, SmooshedFileMapper)
from druid_tpu_torch.utils.emitter import Monitor
from druid_tpu_torch.utils.intervals import Interval


def persist_segment_auto(segment: Segment, directory: str,
                         format_version: int = 2, **kw) -> int:
    """The product persist entry point (deep-storage push): format V2 by
    default, V1 with `format_version=1` (for readers older than V2)."""
    if format_version == 1:
        from druid_tpu_torch.storage.format import persist_segment
        return persist_segment(segment, directory, **kw)
    if format_version != 2:
        raise ValueError(f"unknown segment format version {format_version}")
    return persist_segment_v2(segment, directory, **kw)


# ---------------------------------------------------------------------------
# Load metrics (segment/load/* — wired as a dataserver monitor)
# ---------------------------------------------------------------------------

class SegmentLoadStats:
    """Cumulative segment-load accounting: wall time, logical (decoded)
    bytes served, and on-disk (compressed) bytes mapped."""

    def __init__(self):
        self._lock = threading.Lock()
        self.time_ms = 0.0
        self.bytes = 0
        self.compressed_bytes = 0

    def record(self, seconds: float, logical: int, on_disk: int) -> None:
        with self._lock:
            self.time_ms += seconds * 1000.0
            self.bytes += int(logical)
            self.compressed_bytes += int(on_disk)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"time_ms": self.time_ms, "bytes": self.bytes,
                    "compressedBytes": self.compressed_bytes}


_LOAD_STATS = SegmentLoadStats()


def segment_load_stats() -> SegmentLoadStats:
    return _LOAD_STATS


class SegmentLoadMonitor(Monitor):
    """Emits segment/load/{time,bytes,compressedBytes} per tick (deltas
    over the tick window, the CodeDomainMonitor discipline)."""

    def __init__(self, source: Optional[SegmentLoadStats] = None):
        self.source = source or _LOAD_STATS
        self._last = self.source.snapshot()

    def do_monitor(self, emitter):
        s = self.source.snapshot()
        last, self._last = self._last, s
        emitter.metric("segment/load/time",
                       int(s["time_ms"] - last["time_ms"]))
        emitter.metric("segment/load/bytes",
                       int(s["bytes"] - last["bytes"]))
        emitter.metric("segment/load/compressedBytes",
                       int(s["compressedBytes"] - last["compressedBytes"]))


# ---------------------------------------------------------------------------
# Lazy columns: descriptors now, rows only if a host path asks
# ---------------------------------------------------------------------------

class LazyStringDimColumn(StringDimColumn):
    """StringDimColumn whose ids materialize on first host access from the
    persisted cascade form (staging such a column reads its ids, so it
    decodes once on its first staging). Materialization counts a host
    decode in cascade.decode_stats, the witness the zero-decode tests
    assert on."""

    # no __slots__: the `ids` property shadows the parent slot descriptor
    # and the instance dict carries the lazy state

    def __init__(self, n_rows: int, dictionary, decoder, kind: str):
        # parent __init__ bypassed: it type-checks a materialized ids array
        self.dictionary = dictionary
        self._bitmap_index = None
        self._lock = threading.Lock()
        self._n_rows = int(n_rows)
        self._decoder = decoder
        self._kind = kind
        self._mat_lock = threading.Lock()  # separate from _lock: the lazy
        self._ids = None                   # bitmap build holds _lock while
        #                                    reading .ids

    @property
    def ids(self) -> np.ndarray:
        with self._mat_lock:
            if self._ids is None:
                cascade_mod.record_decode(f"host:{self._kind}")
                self._ids = self._decoder()
            return self._ids

    @property
    def logical_nbytes(self) -> int:
        return self._n_rows * 4

    def materialized(self) -> bool:
        with self._mat_lock:
            return self._ids is not None


class LazyNumericColumn(NumericColumn):
    """NumericColumn twin of LazyStringDimColumn (rle longs, packed longs,
    lz4 floats)."""

    def __init__(self, n_rows: int, vtype: ValueType, decoder, kind: str):
        self.type = vtype
        self._n_rows = int(n_rows)
        self._decoder = decoder
        self._kind = kind
        self._mat_lock = threading.Lock()
        self._values = None

    @property
    def values(self) -> np.ndarray:
        with self._mat_lock:
            if self._values is None:
                cascade_mod.record_decode(f"host:{self._kind}")
                self._values = self._decoder()
            return self._values

    @property
    def logical_nbytes(self) -> int:
        return self._n_rows * np.dtype(self.type.numpy_dtype).itemsize

    def materialized(self) -> bool:
        with self._mat_lock:
            return self._values is not None


# ---------------------------------------------------------------------------
# Persist
# ---------------------------------------------------------------------------

def _padded_rows(n_rows: int, row_align: int = DEFAULT_ROW_ALIGN) -> int:
    return max(row_align,
               ((n_rows + row_align - 1) // row_align) * row_align)


def _pack_words(values: np.ndarray, width: int, base: int,
                pad_n: int) -> np.ndarray:
    out = np.zeros(pad_n, dtype=values.dtype)
    out[: values.shape[0]] = values
    return packed_mod.pack_padded(out, width, base)


def persist_segment_v2(segment: Segment, directory: str,
                       codec: Optional[int] = None,
                       build_bitmaps: bool = True,
                       chunk_size: int = 1 << 31) -> int:
    """Write a segment in format V2; returns total bytes written.

    Column encodings are the persist-time planner's (storage/plan.py: the
    reference's plan_pair over all columns), so both packages write the
    same parts for the same segment:
      rle   -> raw int32 run tables (col.<name>.rle.values/.rle.ends)
      pack  -> raw tile-planar words at DEFAULT_ROW_ALIGN padding
      lz4   -> the LZ4-block blob itself (col.<name>.lz4)
      else  -> the V1 block-codec part (dim.<name>.ids / met.<name>)
    Dictionary and bitmap parts are byte-identical to V1; each bitmap
    index streams through a writeout file under `directory`."""
    if codec is None:
        codec = codecs.default_codec()
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "version.bin"), "wb") as f:
        f.write(struct.pack("<I", FORMAT_VERSION_V2))

    cols = list(segment.dims.keys()) + list(segment.metrics.keys())
    cascades, packs = plan_mod.plan_pair(segment, cols)
    cascade_for = {e[0]: e for e in cascades}
    pack_for = {name: (w, base) for name, w, base in packs}
    pad_n = _padded_rows(segment.n_rows)
    _, _, max_delta = cascade_mod._time_stats(segment)

    specs: Dict[str, dict] = {}
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
        "format": 2,
        "row_align": DEFAULT_ROW_ALIGN,
    }

    wo_dir = tempfile.mkdtemp(prefix="writeout_", dir=directory)
    with FileSmoosher(directory, chunk_size) as sm:
        def add_bitmaps(name: str, index) -> None:
            path = os.path.join(wo_dir, "part")
            _encode_bitmap_index_to_file(index, codec, path)
            sm.add_from_file(name, path)
            os.remove(path)

        def add_rle(name: str):
            values, ends = cascade_mod._rle_encoded(segment, name)
            sm.add(f"col.{name}.rle.values", values.tobytes())
            sm.add(f"col.{name}.rle.ends", ends.tobytes())
            return {"enc": "rle", "runs": int(values.shape[0])}

        def add_pack(name: str, values: np.ndarray, w: int, base: int):
            words = _pack_words(values, w, base, pad_n)
            sm.add(f"col.{name}.pack", words.tobytes())
            return {"enc": "pack", "width": w, "base": base, "rows": pad_n}

        for name, col in segment.dims.items():
            sm.add(f"dim.{name}.dict", _encode_dictionary(col.dictionary))
            c = cascade_for.get(name)
            if c is not None and c[1] == "rle":
                spec = add_rle(name)
            elif name in pack_for:
                w, base = pack_for[name]
                spec = add_pack(name, col.ids, w, base)
            else:
                sm.add(f"dim.{name}.ids",
                       codecs.compress_array(col.ids, codec))
                spec = {"enc": "block"}
            spec["dtype"] = "int32"
            # raw run count for EVERY column: load-time planning asks
            # column_run_count even for pack/block columns, and without the
            # seed that read would materialize a lazy column
            spec["raw_runs"] = int(cascade_mod.column_run_count(segment,
                                                                name))
            specs[name] = spec
            if build_bitmaps:
                add_bitmaps(f"dim.{name}.bitmaps", col.bitmap_index())

        for name, m in segment.metrics.items():
            spec: dict = {"enc": "block"}
            c = cascade_for.get(name)
            if m.type is ValueType.LONG:
                lo, hi = segment.column_minmax(name)
                if c is not None and c[1] == "rle":
                    spec = add_rle(name)
                elif name in pack_for:
                    w, base = pack_for[name]
                    spec = add_pack(name, m.values.astype(np.int32),
                                    w, base)
                spec["min"], spec["max"] = int(lo), int(hi)
                spec["raw_runs"] = int(
                    cascade_mod.column_run_count(segment, name))
            elif m.type in (ValueType.FLOAT, ValueType.DOUBLE) \
                    and c is not None and c[1] == "lz4":
                from druid_tpu_torch.native import lz4block
                raw = np.ascontiguousarray(m.values).tobytes()
                blob = lz4block.compress(raw)
                if lz4block.decompress(blob, len(raw)) == raw:
                    sm.add(f"col.{name}.lz4", blob)
                    spec = {"enc": "lz4", "raw": len(raw),
                            "comp": len(blob), "n": segment.n_rows,
                            "finite": segment.column_finite(name)}
            if spec["enc"] == "block":
                sm.add(f"met.{name}", codecs.compress_array(m.values, codec))
            spec["dtype"] = str(m.values.dtype) \
                if m.type is ValueType.COMPLEX else \
                str(np.dtype(m.type.numpy_dtype))
            specs[name] = spec

        sm.add("__time", codecs.compress_array(segment.time_ms, codec))
        meta["v2"] = {
            "columns": specs,
            "time": {"max_delta": int(max_delta)},
            "staging": {
                "cascades": plan_mod.descriptor_to_json(cascades),
                "packs": plan_mod.descriptor_to_json(packs),
            },
        }
        sm.add("index.json", json.dumps(meta).encode())
    os.rmdir(wo_dir)
    total = 0
    for fn in os.listdir(directory):
        total += os.path.getsize(os.path.join(directory, fn))
    return total


# ---------------------------------------------------------------------------
# Load: mmap + zero-copy descriptor reconstruction
# ---------------------------------------------------------------------------

def _raw_part(mapper: SmooshedFileMapper, directory: str, name: str,
              dtype, count: int) -> np.ndarray:
    """Zero-copy typed view of a raw little-endian part (mmap-backed,
    read-only); size-validated so a truncated part fails typed, not with a
    frombuffer ValueError deep in staging."""
    buf = mapper.part(name)
    need = int(count) * np.dtype(dtype).itemsize
    if len(buf) != need:
        raise CorruptSegmentError(
            directory, f"part is {len(buf)} bytes, descriptor needs {need}",
            part=name)
    return np.frombuffer(buf, dtype=dtype)


def _rle_decoder(values: np.ndarray, ends: np.ndarray, dtype_str: str):
    def decode():
        lengths = np.diff(ends, prepend=np.int32(0))
        return np.repeat(values, lengths).astype(dtype_str)
    return decode


def _pack_decoder(words: np.ndarray, width: int, base: int, rows: int,
                  n_rows: int, dtype_str: str):
    def decode():
        full = packed_mod.unpack_host(words, width, base, rows,
                                      dtype=dtype_str)
        return full[:n_rows].copy()
    return decode


def _lz4_decoder(blob, raw_len: int, n: int, dtype_str: str):
    def decode():
        from druid_tpu_torch.native import lz4block
        raw = lz4block.decompress(bytes(blob), raw_len)
        return np.frombuffer(raw, dtype=dtype_str)[:n].copy()
    return decode


def load_segment_v2(directory: str,
                    columns: Optional[Sequence[str]] = None) -> Segment:
    """mmap a V2 segment: run/word tables become zero-copy frombuffer views
    over the page cache, decoded rows become lazy columns, and the cached
    stats (run counts, rle tables, min/max, finiteness, the largest time
    gap) seed from the persisted descriptors, so planning reads no decoded
    row. The LZ4 token tables the reference also seeds feed only its device
    LZ4 decoder, which the port does not have; `time_ordered` is computed
    from the decoded `__time` (the port's Segment takes it from no one)."""
    t_start = time.perf_counter()
    mapper = SmooshedFileMapper(directory)
    try:
        meta = json.loads(bytes(mapper.part("index.json")))
    except (ValueError, KeyError) as e:
        if isinstance(e, CorruptSegmentError):
            raise
        raise CorruptSegmentError(directory, f"bad index.json: {e}",
                                  part="index.json") from None
    v2 = meta.get("v2")
    if not isinstance(v2, dict) or "columns" not in v2:
        raise CorruptSegmentError(directory,
                                  "format-V2 segment missing v2 metadata",
                                  part="index.json")
    specs = v2["columns"]
    n_rows = int(meta["n_rows"])
    seg_id = SegmentId(meta["datasource"],
                       Interval(meta["interval"][0], meta["interval"][1]),
                       meta["version"], meta["partition"])
    time_ms = codecs.decompress_array(mapper.part("__time")).copy()
    # aux seeds applied after Segment construction (key -> value)
    seeds: List[Tuple[Tuple, object]] = []

    def load_rle(name: str, spec: dict):
        nr = int(spec["runs"])
        rv = _raw_part(mapper, directory, f"col.{name}.rle.values",
                       np.int32, nr)
        re_ = _raw_part(mapper, directory, f"col.{name}.rle.ends",
                        np.int32, nr)
        if nr and int(re_[-1]) != n_rows:
            raise CorruptSegmentError(
                directory, f"rle ends terminate at {int(re_[-1])}, "
                f"segment has {n_rows} rows", part=f"col.{name}.rle.ends")
        seeds.append((("cascade_runs", name), nr))
        seeds.append((("cascade_rleenc", name), (rv, re_)))
        return _rle_decoder(rv, re_, spec["dtype"])

    def load_pack(name: str, spec: dict):
        w, base = int(spec["width"]), int(spec["base"])
        rows = int(spec["rows"])
        vpw = PACK_WORD_BITS // w
        words = _raw_part(mapper, directory, f"col.{name}.pack",
                          np.int32, rows // vpw)
        return _pack_decoder(words, w, base, rows, n_rows, spec["dtype"])

    dims: Dict[str, StringDimColumn] = {}
    for name in meta["dimensions"]:
        if columns is not None and name not in columns:
            continue
        d = _decode_dictionary(mapper.part(f"dim.{name}.dict"))
        spec = specs.get(name, {"enc": "block", "dtype": "int32"})
        enc = spec["enc"]
        if enc == "rle":
            col = LazyStringDimColumn(n_rows, d, load_rle(name, spec),
                                      "rle")
        elif enc == "pack":
            col = LazyStringDimColumn(n_rows, d, load_pack(name, spec),
                                      "packed")
        else:
            ids = codecs.decompress_array(
                mapper.part(f"dim.{name}.ids")).copy()
            col = StringDimColumn(ids, d)
        bm_part = f"dim.{name}.bitmaps"
        if mapper.has(bm_part):
            col.set_bitmap_index(LazyBitmapIndex(mapper.part(bm_part)))
        if "raw_runs" in spec and enc != "rle":
            seeds.append((("cascade_runs", name), int(spec["raw_runs"])))
        dims[name] = col

    metrics: Dict[str, object] = {}
    for name, tname in meta["metrics"].items():
        if columns is not None and name not in columns:
            continue
        if tname.startswith("complex:"):
            vals = codecs.decompress_array(mapper.part(f"met.{name}")).copy()
            metrics[name] = ComplexColumn(vals, tname.split(":", 1)[1])
            continue
        vtype = ValueType(tname)
        spec = specs.get(name, {"enc": "block",
                                "dtype": str(np.dtype(vtype.numpy_dtype))})
        enc = spec["enc"]
        if enc == "rle":
            m = LazyNumericColumn(n_rows, vtype, load_rle(name, spec),
                                  "rle")
        elif enc == "pack":
            m = LazyNumericColumn(n_rows, vtype, load_pack(name, spec),
                                  "packed")
        elif enc == "lz4":
            blob = mapper.part(f"col.{name}.lz4")
            raw_len, comp_len = int(spec["raw"]), int(spec["comp"])
            if len(blob) != comp_len:
                raise CorruptSegmentError(
                    directory, f"lz4 blob is {len(blob)} bytes, "
                    f"descriptor says {comp_len}", part=f"col.{name}.lz4")
            m = LazyNumericColumn(
                n_rows, vtype,
                _lz4_decoder(blob, raw_len, n_rows, spec["dtype"]), "lz4")
            seeds.append((("finite", name), bool(spec.get("finite", True))))
        else:
            vals = codecs.decompress_array(mapper.part(f"met.{name}")).copy()
            m = NumericColumn(vals, vtype)
        if "min" in spec:
            seeds.append((("minmax", name),
                          (int(spec["min"]), int(spec["max"]))))
        if "raw_runs" in spec and enc != "rle":
            seeds.append((("cascade_runs", name), int(spec["raw_runs"])))
        metrics[name] = m

    seg = Segment(seg_id, time_ms, dims, metrics)
    # the largest time gap, where the rows are in time order (the port's
    # cascade reads -1 otherwise, whatever the writer recorded)
    md = int(v2.get("time", {}).get("max_delta", -1))
    seeds.append((("cascade_tdelta",), md if seg.time_ordered else -1))
    for key, value in seeds:
        seg.aux_cached(key, lambda v=value: v)
    # keep the mmaps alive for the zero-copy views (no other referent yet)
    seg._mapper = mapper
    on_disk = sum(os.path.getsize(os.path.join(directory, f))
                  for f in os.listdir(directory))
    _LOAD_STATS.record(time.perf_counter() - t_start, seg.size_bytes(),
                       on_disk)
    return seg
