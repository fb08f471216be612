"""LZ4 block-format host codec and token view (the LZ4 rung's host half).

The port's copy of the reference package's `native/lz4block.py`. Druid
compresses float/long column chunks with lz4-java
(processing/.../segment/data/CompressionStrategy.java:48); here the block
codec has two host layers:

  * the C++ library (csrc/host_codec.cpp, loaded by
    druid_tpu_torch/native/__init__.py), which `compress`/`decompress` call;
    it builds at first use and raises when it cannot, with no fallback;
  * a pure-Python encoder and decoder below (`py_compress`,
    `py_decompress`), producing and consuming the same standard LZ4 block
    format (greedy 4-byte hash matcher): the plain version the tests hold
    the C++ codec against;
  * `tokenize()`, which parses any LZ4 block into flat token arrays
    (literal stream + per-sequence literal/match lengths and offsets): the
    device-decodable form the staged LZ4 rung reads
    (data/cascade.py's Lz4Column), and what the persist-time planner
    counts (storage/plan.py).

Every compress that a segment keeps is verified by a host decompress
round trip at its call site (storage/plan.py, storage/format_v2.py), so a
codec bug can never corrupt a column: it just keeps the column off the LZ4
rung.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

#: LZ4 block-format constants
_MINMATCH = 4
#: spec: the last 5 bytes are always literals, and a match must not start
#: within the last 12 bytes of the input
_END_LITERALS = 5
_MFLIMIT = 12
_MAX_OFFSET = 0xFFFF


def _native():
    from druid_tpu_torch import native as nat
    return nat


# ---------------------------------------------------------------------------
# Pure-python encoder / decoder (standard LZ4 block format)
# ---------------------------------------------------------------------------

def _emit_length(out: bytearray, n: int) -> None:
    while n >= 255:
        out.append(255)
        n -= 255
    out.append(n)


def py_compress(src: bytes) -> bytes:
    """Greedy hash-matcher LZ4 block encoder (exact, slow: the plain
    version of the C++ codec). Emits the standard block format the native
    decoder, py_decompress, and tokenize all accept."""
    src = bytes(src)
    n = len(src)
    out = bytearray()
    if n == 0:
        out.append(0)                     # one empty-literal sequence
        return bytes(out)
    table: dict = {}
    i = 0
    anchor = 0
    # matches may not start within the last MFLIMIT bytes
    limit = n - _MFLIMIT
    while i <= limit - 1 and i + _MINMATCH <= n:
        key = src[i:i + _MINMATCH]
        j = table.get(key)
        table[key] = i
        if j is None or i - j > _MAX_OFFSET or src[j:j + _MINMATCH] != key:
            i += 1
            continue
        # extend the match; it must end at least END_LITERALS from the end
        m = _MINMATCH
        max_m = (n - _END_LITERALS) - i
        while m < max_m and src[j + m] == src[i + m]:
            m += 1
        lit = src[anchor:i]
        ml = m - _MINMATCH
        token = (min(len(lit), 15) << 4) | min(ml, 15)
        out.append(token)
        if len(lit) >= 15:
            _emit_length(out, len(lit) - 15)
        out += lit
        out += (i - j).to_bytes(2, "little")
        if ml >= 15:
            _emit_length(out, ml - 15)
        i += m
        anchor = i
    # final sequence: literals only
    lit = src[anchor:]
    out.append(min(len(lit), 15) << 4)
    if len(lit) >= 15:
        _emit_length(out, len(lit) - 15)
    out += lit
    return bytes(out)


def py_decompress(block: bytes, out_size: int) -> bytes:
    """Sequential decoder (the plain version of the C++ decoder)."""
    src = bytes(block)
    out = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        ll = token >> 4
        if ll == 15:
            while True:
                b = src[i]
                i += 1
                ll += b
                if b != 255:
                    break
        out += src[i:i + ll]
        i += ll
        if i >= n:
            break                          # last sequence has no match part
        off = int.from_bytes(src[i:i + 2], "little")
        i += 2
        ml = token & 15
        if ml == 15:
            while True:
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        ml += _MINMATCH
        if off <= 0 or off > len(out):
            raise ValueError("lz4 block: invalid match offset")
        for _ in range(ml):               # byte-at-a-time: overlap-correct
            out.append(out[-off])
    if len(out) != out_size:
        raise ValueError(f"lz4 block: decoded {len(out)} bytes, "
                         f"want {out_size}")
    return bytes(out)


# ---------------------------------------------------------------------------
# Entry points (the C++ codec)
# ---------------------------------------------------------------------------

def compress(data) -> bytes:
    """One LZ4 block of `data`, compressed by the C++ library."""
    raw = bytes(data) if isinstance(data, (bytes, bytearray, memoryview)) \
        else np.ascontiguousarray(data).tobytes()
    return _native().lz4_compress(raw)


def decompress(block: bytes, out_size: int) -> bytes:
    """The `out_size` bytes of one LZ4 block, decoded by the C++ library;
    ValueError when the block is malformed."""
    return _native().lz4_decompress(block, out_size).tobytes()


# ---------------------------------------------------------------------------
# Token view (the device-decodable form)
# ---------------------------------------------------------------------------

def tokenize(block: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]:
    """Parse an LZ4 block into (literals uint8[L], lit_lens int32[T],
    match_lens int32[T], offsets int32[T]): one entry per sequence, the
    final literal-only sequence carrying match_len = offset = 0. The
    concatenated literal runs ARE `literals`, so
    Σ lit_lens + Σ match_lens = decoded size and the block is fully
    reconstructable from the four arrays (the input
    contract of a device LZ4 decoder)."""
    src = bytes(block)
    n = len(src)
    lits = bytearray()
    lit_lens, match_lens, offsets = [], [], []
    i = 0
    while i < n:
        token = src[i]
        i += 1
        ll = token >> 4
        if ll == 15:
            while True:
                b = src[i]
                i += 1
                ll += b
                if b != 255:
                    break
        lits += src[i:i + ll]
        i += ll
        if i >= n:
            lit_lens.append(ll)
            match_lens.append(0)
            offsets.append(0)
            break
        off = int.from_bytes(src[i:i + 2], "little")
        i += 2
        ml = token & 15
        if ml == 15:
            while True:
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        lit_lens.append(ll)
        match_lens.append(ml + _MINMATCH)
        offsets.append(off)
    return (np.frombuffer(bytes(lits), dtype=np.uint8),
            np.asarray(lit_lens, dtype=np.int32),
            np.asarray(match_lens, dtype=np.int32),
            np.asarray(offsets, dtype=np.int32))
