"""Block compression codecs for columnar storage.

The port's copy of the reference package's `storage/codec.py`, byte for
byte in what it writes. Capability parity with Druid's CompressionStrategy
(processing/.../segment/data/CompressionStrategy.java:48-108: LZF=0x0,
LZ4=0x1 default, UNCOMPRESSED=0xFF) and its 64KB block layout
(BlockLayoutColumnarLongsSupplier.java). LZ4 runs in the port's host C++
codec (csrc/host_codec.cpp) with multi-threaded batch decompression at
load; it is always the default, and a codec library that cannot be built
raises instead of switching codecs. ZLIB and NONE stay explicit codecs, so
a segment written with them (the reference writes ZLIB where it has no
native library) still loads; NONE is also what an incompressible block
stores.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

from druid_tpu_torch import native

BLOCK_SIZE = 1 << 16  # 64KB, matching the reference's default block size

LZ4 = 0x1
ZLIB = 0x2
NONE = 0xFF


def default_codec() -> int:
    return LZ4


def compress_block(codec: int, data: bytes) -> bytes:
    if codec == LZ4:
        return native.lz4_compress(data)
    if codec == ZLIB:
        return zlib.compress(data, 1)
    if codec == NONE:
        return data
    raise ValueError(f"unknown codec {codec}")


def decompress_block(codec: int, data, out_size: int) -> bytes:
    if codec == LZ4:
        return native.lz4_decompress(data, out_size).tobytes()
    if codec == ZLIB:
        return zlib.decompress(bytes(data))
    if codec == NONE:
        return bytes(data)
    raise ValueError(f"unknown codec {codec}")


# ---------------------------------------------------------------------------
# Value encodings applied BEFORE block compression (reference: the
# CompressionFactory long encodings — delta/table — in
# processing/.../segment/data/CompressionFactory.java). Delta stores
# element[0] followed by wrapped differences in the SAME dtype; the decoder
# reconstructs with a wrapping cumulative sum. A sorted time column's small
# deltas compress dramatically better than raw epoch millis.
# ---------------------------------------------------------------------------

ENC_NONE = 0
ENC_DELTA = 1
ENC_VSIZE8 = 2     # byte-packed non-negative ints (VSizeLongSerde)
ENC_VSIZE16 = 3
ENC_VSIZE32 = 4
ENC_TABLE = 5      # ≤256 distinct values: table in header + u8 indexes

_VSIZE_DTYPE = {ENC_VSIZE8: np.dtype(np.uint8),
                ENC_VSIZE16: np.dtype(np.uint16),
                ENC_VSIZE32: np.dtype(np.uint32)}


def _stream_dtype(dtype: np.dtype, encoding_id: int) -> np.dtype:
    """dtype of the ENCODED value stream (what the blocks actually hold)."""
    if encoding_id in _VSIZE_DTYPE:
        return _VSIZE_DTYPE[encoding_id]
    if encoding_id == ENC_TABLE:
        return np.dtype(np.uint8)
    return dtype


def _vsize_id(arr: np.ndarray) -> int:
    """Narrowest byte-packing for a non-negative int array, or ENC_NONE
    when packing wouldn't shrink the stream."""
    mx = int(arr.max())
    if int(arr.min()) < 0:
        return ENC_NONE
    for enc in (ENC_VSIZE8, ENC_VSIZE16, ENC_VSIZE32):
        dt = _VSIZE_DTYPE[enc]
        if mx <= np.iinfo(dt).max:
            return enc if dt.itemsize < arr.dtype.itemsize else ENC_NONE
    return ENC_NONE


def _pick_encoding(arr: np.ndarray, encoding: str) -> int:
    """Resolve the requested encoding to an id. 'auto' picks delta for
    NON-DECREASING 1-D integer arrays (element comparison — wrapped deltas
    of unsigned/overflowing data would look falsely monotonic), else VSize
    byte-packing when the value range allows a narrower width; 'table'
    (explicit only — the distinct-scan costs a pass) stores ≤256 distinct
    values once and u8 indexes per row (CompressionFactory TABLE)."""
    if encoding == "none":
        return ENC_NONE
    if encoding not in ("auto", "delta", "vsize", "table"):
        raise ValueError(f"unknown value encoding {encoding!r}")
    if arr.ndim != 1 or arr.size < 2 \
            or not np.issubdtype(arr.dtype, np.integer):
        return ENC_NONE
    if encoding == "table":
        return _pick_encoding_ex(arr, "table")[0]
    if encoding == "vsize":
        return _vsize_id(arr)
    if encoding == "auto" and not bool((arr[1:] >= arr[:-1]).all()):
        return _vsize_id(arr)
    return ENC_DELTA


def _pick_encoding_ex(arr: np.ndarray, encoding: str):
    """(encoding id, table or None) — computes the TABLE distinct scan
    once for both eligibility and serialization."""
    if encoding == "table" and arr.ndim == 1 and arr.size >= 2 \
            and np.issubdtype(arr.dtype, np.integer):
        table = np.unique(arr)
        return (ENC_TABLE, table) if table.size <= 256 else (ENC_NONE, None)
    return _pick_encoding(arr, encoding), None


def _value_chunks(arr: np.ndarray, encoding_id: int,
                  table: "np.ndarray | None" = None):
    """Yield the ENCODED value stream as BLOCK_SIZE uint8 chunks with
    O(block) peak memory — delta encodes per chunk carrying one element
    across the boundary, vsize/table re-pack per chunk (the writeout
    path's memory guarantee holds)."""
    if encoding_id == ENC_NONE:
        raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        for i in range(0, raw.shape[0], BLOCK_SIZE):
            yield raw[i:i + BLOCK_SIZE]
        return
    if encoding_id in _VSIZE_DTYPE:
        dt = _VSIZE_DTYPE[encoding_id]
        epb = BLOCK_SIZE // dt.itemsize
        for i in range(0, arr.shape[0], epb):
            yield np.ascontiguousarray(
                arr[i:i + epb].astype(dt)).view(np.uint8)
        return
    if encoding_id == ENC_TABLE:
        epb = BLOCK_SIZE
        for i in range(0, arr.shape[0], epb):
            ix = np.searchsorted(table, arr[i:i + epb]).astype(np.uint8)
            yield np.ascontiguousarray(ix).view(np.uint8)
        return
    epb = BLOCK_SIZE // arr.dtype.itemsize
    prev = None
    with np.errstate(over="ignore"):
        for i in range(0, arr.shape[0], epb):
            chunk = arr[i:i + epb]
            enc = np.empty_like(chunk)
            enc[0] = chunk[0] if prev is None else chunk[0] - prev
            np.subtract(chunk[1:], chunk[:-1], out=enc[1:])
            prev = chunk[-1]
            yield np.ascontiguousarray(enc).view(np.uint8)


def _decode_values(arr: np.ndarray, encoding_id: int,
                   dtype: "np.dtype | None" = None,
                   table: "np.ndarray | None" = None) -> np.ndarray:
    if encoding_id == ENC_NONE:
        return arr
    if encoding_id == ENC_DELTA:
        # wrapping cumsum restores the original exactly (two's complement)
        wide = np.cumsum(arr.astype(np.int64))
        return wide.astype(arr.dtype)
    if encoding_id in _VSIZE_DTYPE:
        return arr.astype(dtype)
    if encoding_id == ENC_TABLE:
        return table[arr]
    raise ValueError(f"unknown value encoding {encoding_id}")


def _array_blocks(chunks, codec: int):
    """Yield (block_codec, compressed_bytes) per value chunk — the ONE
    definition of the block layout both the in-memory and writeout-file
    writers share."""
    for c in chunks:
        chunk = c.tobytes()
        comp = compress_block(codec, chunk)
        if len(comp) >= len(chunk):  # incompressible block — store raw
            yield NONE, compress_block(NONE, chunk)
        else:
            yield codec, comp


def _array_header(arr: np.ndarray, codec: int,
                  block_meta: "list[Tuple[int, int]]",
                  encoding_id: int = ENC_NONE,
                  table: "np.ndarray | None" = None) -> bytes:
    """[codec u8][dtype_len u8][dtype str][ndim u8][shape i64 * ndim]
       [encoding u8][table: n u16 + values (ENC_TABLE only)]
       [block_size i32][n_blocks i32][(size i32, codec u8) * n_blocks]"""
    dtype_s = arr.dtype.str.encode()
    header = struct.pack("<BB", codec, len(dtype_s)) + dtype_s
    header += struct.pack("<B", arr.ndim)
    header += struct.pack(f"<{arr.ndim}q", *arr.shape)
    header += struct.pack("<B", encoding_id)
    if encoding_id == ENC_TABLE:
        header += struct.pack("<H", table.size)
        header += np.ascontiguousarray(table).tobytes()
    header += struct.pack("<ii", BLOCK_SIZE, len(block_meta))
    header += b"".join(struct.pack("<iB", sz, bc) for bc, sz in block_meta)
    return header


def compress_array(arr: np.ndarray, codec: int | None = None,
                   encoding: str = "auto") -> bytes:
    """Serialize a numpy array (any rank) as a block-compressed column part
    (layout: _array_header + blocks); `encoding` applies a value transform
    first ('auto' = delta for monotonic int columns)."""
    if codec is None:
        codec = default_codec()
    arr = np.ascontiguousarray(arr)
    enc_id, table = _pick_encoding_ex(arr, encoding)
    blocks = list(_array_blocks(_value_chunks(arr, enc_id, table), codec))
    header = _array_header(arr, codec, [(bc, len(c)) for bc, c in blocks],
                           enc_id, table)
    return header + b"".join(c for _, c in blocks)


def _copy_file_into(dst, path: str, copy_chunk: int = 1 << 20) -> None:
    with open(path, "rb") as src:
        while True:
            buf = src.read(copy_chunk)
            if not buf:
                break
            dst.write(buf)


def compress_array_to_file(arr: np.ndarray, out_path: str,
                           codec: int | None = None,
                           encoding: str = "auto") -> None:
    """compress_array with O(block) peak memory: blocks stream to a temp
    writeout file while sizes accumulate, then the final part file is
    header + streamed blocks (the WriteOutMedium capability —
    processing/.../segment/writeout/FileWriteOutMedium.java). Byte-
    identical output by construction: both writers share _value_chunks /
    _array_blocks / _array_header."""
    if codec is None:
        codec = default_codec()
    arr = np.ascontiguousarray(arr)
    enc_id, table = _pick_encoding_ex(arr, encoding)
    blocks_path = out_path + ".blocks"
    meta: list = []
    with open(blocks_path, "wb") as bf:
        for bc, comp in _array_blocks(_value_chunks(arr, enc_id, table),
                                      codec):
            meta.append((bc, len(comp)))
            bf.write(comp)
    with open(out_path, "wb") as f:
        f.write(_array_header(arr, codec, meta, enc_id, table))
        _copy_file_into(f, blocks_path)
    os.remove(blocks_path)


def decompress_array(buf) -> np.ndarray:
    """Inverse of compress_array; uses the C++ codec's multi-threaded batch
    decompression when every block is LZ4."""
    buf = memoryview(buf)
    codec, dlen = struct.unpack_from("<BB", buf, 0)
    dtype = np.dtype(bytes(buf[2:2 + dlen]).decode())
    off = 2 + dlen
    (ndim,) = struct.unpack_from("<B", buf, off)
    off += 1
    shape = struct.unpack_from(f"<{ndim}q", buf, off)
    off += 8 * ndim
    (encoding_id,) = struct.unpack_from("<B", buf, off)
    off += 1
    table = None
    if encoding_id == ENC_TABLE:
        (n_table,) = struct.unpack_from("<H", buf, off)
        off += 2
        table = np.frombuffer(buf, dtype=dtype, count=n_table,
                              offset=off).copy()
        off += n_table * dtype.itemsize
    n_elems = int(np.prod(shape)) if ndim else 1
    block_size, n_blocks = struct.unpack_from("<ii", buf, off)
    off += 8
    sizes = np.zeros(n_blocks, dtype=np.int64)
    codecs = np.zeros(n_blocks, dtype=np.uint8)
    for i in range(n_blocks):
        sizes[i], codecs[i] = struct.unpack_from("<iB", buf, off)
        off += 5
    sdtype = _stream_dtype(dtype, encoding_id)
    total = n_elems * sdtype.itemsize
    src_offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]) if n_blocks else np.zeros(0, np.int64)
    dst_sizes = np.full(n_blocks, block_size, dtype=np.int64)
    if n_blocks:
        dst_sizes[-1] = total - block_size * (n_blocks - 1)
    dst_offsets = np.arange(n_blocks, dtype=np.int64) * block_size
    blob = buf[off:off + int(sizes.sum())]
    if n_blocks and (codecs == LZ4).all():
        out = native.lz4_decompress_batch(blob, src_offsets, sizes,
                                          dst_offsets, dst_sizes, total)
        return _decode_values(out.view(sdtype)[:n_elems], encoding_id,
                              dtype, table).reshape(shape)
    out = np.empty(total, dtype=np.uint8)
    for i in range(n_blocks):
        chunk = decompress_block(
            int(codecs[i]), blob[int(src_offsets[i]):int(src_offsets[i] + sizes[i])],
            int(dst_sizes[i]))
        out[int(dst_offsets[i]):int(dst_offsets[i] + dst_sizes[i])] = \
            np.frombuffer(chunk, dtype=np.uint8)
    return _decode_values(out.view(sdtype)[:n_elems], encoding_id,
                          dtype, table).reshape(shape)
