"""ctypes loader of the port's host codec (csrc/host_codec.cpp).

The port's own copy of the reference package's `native` loader, for the
entry points segment storage needs: the LZ4 block codec, its multi-threaded
batch decompression, and the bitmap-word unpack. The library builds with
g++ into `build/host/` the first time a call needs it
(`druid_tpu_torch._build.load_host`). There is no fallback: a failed build
raises with the compiler's output, so a segment is never written with
another codec than the one asked for. The pure-Python LZ4 codec
(`native/lz4block.py`'s `py_compress`/`py_decompress`) is the plain version
the tests hold this library against.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: each thread's compression output buffer, grown as needed: a fresh buffer
#: per call would map and unmap pages every call, which serializes the
#: threads of a parallel persist
_scratch = threading.local()


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from druid_tpu_torch import _build
        lib = _build.load_host("host_codec")
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.druid_lz4_compress_bound.restype = ctypes.c_int64
        lib.druid_lz4_compress_bound.argtypes = [ctypes.c_int64]
        lib.druid_lz4_compress.restype = ctypes.c_int64
        lib.druid_lz4_compress.argtypes = [u8p, ctypes.c_int64, u8p,
                                           ctypes.c_int64]
        lib.druid_lz4_decompress.restype = ctypes.c_int64
        lib.druid_lz4_decompress.argtypes = [u8p, ctypes.c_int64, u8p,
                                             ctypes.c_int64]
        lib.druid_lz4_decompress_batch.restype = ctypes.c_int64
        lib.druid_lz4_decompress_batch.argtypes = [
            u8p, i64p, i64p, u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int64]
        lib.druid_unpack_bits.restype = None
        lib.druid_unpack_bits.argtypes = [u8p, ctypes.c_int64, u8p]
        _lib = lib
        return _lib


def available() -> bool:
    """True once the library is built and loaded; raises when it cannot be
    built (no silent fallback)."""
    return _load() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def lz4_compress(data) -> bytes:
    """One LZ4 block of `data` (bytes-like or a numpy array's bytes)."""
    lib = _load()
    src = np.frombuffer(data, dtype=np.uint8) \
        if isinstance(data, (bytes, bytearray, memoryview)) \
        else np.ascontiguousarray(data).view(np.uint8).ravel()
    n = src.shape[0]
    bound = int(lib.druid_lz4_compress_bound(n))
    dst = getattr(_scratch, "dst", None)
    if dst is None or dst.shape[0] < bound:
        dst = _scratch.dst = np.empty(max(bound, 1 << 20), dtype=np.uint8)
    got = lib.druid_lz4_compress(_u8(src), n, _u8(dst), bound)
    if got < 0:
        raise ValueError("lz4 compression overflow")
    return dst[:got].tobytes()


def lz4_decompress(data, decompressed_size: int) -> np.ndarray:
    """uint8 [decompressed_size] of one LZ4 block; ValueError when the block
    is malformed or decodes to another size."""
    lib = _load()
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.empty(decompressed_size, dtype=np.uint8)
    got = lib.druid_lz4_decompress(_u8(src), src.shape[0], _u8(dst),
                                   decompressed_size)
    if got != decompressed_size:
        raise ValueError(f"lz4 malformed block (got {got}, "
                         f"want {decompressed_size})")
    return dst


def lz4_decompress_batch(blob, src_offsets: np.ndarray, src_sizes: np.ndarray,
                         dst_offsets: np.ndarray, dst_sizes: np.ndarray,
                         total_out: int, n_threads: int = 0) -> np.ndarray:
    """Decompress many blocks of one blob into one contiguous buffer, on up
    to `n_threads` native threads (default: min(8, cores))."""
    lib = _load()
    src = np.frombuffer(blob, dtype=np.uint8)
    dst = np.empty(total_out, dtype=np.uint8)
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    so = np.ascontiguousarray(src_offsets, dtype=np.int64)
    ss = np.ascontiguousarray(src_sizes, dtype=np.int64)
    do = np.ascontiguousarray(dst_offsets, dtype=np.int64)
    ds = np.ascontiguousarray(dst_sizes, dtype=np.int64)
    if len(so) and (int((so + ss).max()) > src.shape[0]
                    or int((do + ds).max()) > total_out):
        raise ValueError("lz4 batch: a block lies outside its buffer")
    rc = lib.druid_lz4_decompress_batch(
        _u8(src), _i64(so), _i64(ss), _u8(dst), _i64(do), _i64(ds),
        len(so), n_threads)
    if rc != 0:
        raise ValueError(f"lz4 batch decompression failed at block {-rc - 1}")
    return dst


def unpack_bits(words: np.ndarray, n_rows: int) -> np.ndarray:
    """uint8 0/1 [n_rows] of MSB-first packed words (np.unpackbits's
    layout)."""
    words = np.ascontiguousarray(words, dtype=np.uint8)
    if words.shape[0] * 8 < n_rows:
        raise ValueError(f"{words.shape[0]} words hold fewer than {n_rows} "
                         f"rows")
    lib = _load()
    out = np.empty(n_rows, dtype=np.uint8)
    lib.druid_unpack_bits(_u8(words), n_rows, _u8(out))
    return out
