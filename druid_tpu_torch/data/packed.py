"""Bit-packed device columns: narrow value columns the kernels read as words.

The port's counterpart of the reference package's `data/packed.py`. A
dictionary-id column or a small-range long column can stage as int32 words
that hold 32 // width values each, instead of one int32 per row. Kernels B1
and B2 (engine/sorted_reduce.py, csrc/sorted_reduce.cu) read the words and
unpack each row themselves, so `Segment.device_block` packs only the value
columns they read (its `words`); a dense consumer of such a column reads it
decoded (`unpack_device`, torch shift/mask ops on the column's device).

Encoding, the reference's bit for bit:
  * width w in contracts.PACK_WIDTHS (4/8/16 bits); vpw = 32 // w values
    share one word and no value crosses a word boundary;
  * stored = value - base, base a pow2-quantized lower bound (0 for
    dictionary ids), so negative values pack without sign bits;
  * tile-planar order: view the padded column [n] as [n // 128, 128]; word
    [q, l] packs rows q*vpw + s of that view at bit slot s (s = 0..vpw-1).
    A block of BLK rows (a multiple of 128 * vpw) therefore reads BLK / vpw
    contiguous words, and the 32 consecutive rows of a warp read 32
    consecutive words.

Eligibility is a pure function of column stats (dictionary cardinality,
cached min/max), so identical stats give identical descriptors. Floats,
int64-staged longs and dictionaries above 2^16 values never pack (the
cascade's rungs, data/cascade.py, claim their columns first).
`set_enabled(False)` plans no pack; `cascade.set_enabled` is the rungs'
switch.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from druid_tpu_torch.engine.contracts import (LANE, PACK_WIDTHS,
                                              PACK_WORD_BITS)

#: process default (on, as in the reference); tests flip it with set_enabled
_ENABLED = True
_ENABLED_LOCK = threading.Lock()


def set_enabled(on: bool) -> bool:
    """Flip the process-wide packing default; returns the previous value."""
    global _ENABLED
    with _ENABLED_LOCK:
        prev = _ENABLED
        _ENABLED = bool(on)
        return prev


def enabled() -> bool:
    return _ENABLED


class PackedColumn:
    """A bit-packed column: int32 `words` (a tensor, or a numpy array on the
    host) and its descriptor. `rows` is the decoded (padded) length; words
    holds rows // vpw entries. `dtype_str` names the decoded dtype."""

    __slots__ = ("words", "width", "base", "rows", "dtype_str")

    def __init__(self, words, width: int, base: int, rows: int,
                 dtype_str: str = "int32"):
        self.words = words
        self.width = int(width)
        self.base = int(base)
        self.rows = int(rows)
        self.dtype_str = dtype_str

    @property
    def vpw(self) -> int:
        return PACK_WORD_BITS // self.width

    @property
    def nbytes(self) -> int:
        """Bytes resident (the words)."""
        return int(self.words.nbytes)

    @property
    def logical_nbytes(self) -> int:
        """Bytes of the decoded column."""
        return int(self.rows * np.dtype(self.dtype_str).itemsize)

    def descriptor(self) -> Tuple[int, int, int, str]:
        return (self.width, self.base, self.rows, self.dtype_str)

    def __repr__(self):
        return (f"{type(self).__name__}(w{self.width}, base={self.base}, "
                f"rows={self.rows}, {self.dtype_str})")


# ---------------------------------------------------------------------------
# Planning (pure functions of column stats)
# ---------------------------------------------------------------------------

def width_for(hi: int, base: int) -> int:
    """Smallest contract width holding values in [base, hi], or 0."""
    span = max(int(hi) - int(base), 0)
    bits = max(span.bit_length(), 1)
    for w in PACK_WIDTHS:
        if bits <= w:
            return w
    return 0


def plan_column(segment, name: str) -> Optional[Tuple[int, int]]:
    """(width, base) when `name` packs in `segment`, else None: string
    dimensions by dictionary cardinality, int32-staged long metrics by their
    cached min/max. Floats, int64-staged longs and dictionaries above 2^16
    values stage decoded."""
    dim = segment.dims.get(name)
    if dim is not None:
        w = width_for(max(int(dim.cardinality) - 1, 0), 0)
        return (w, 0) if w else None
    m = segment.metrics.get(name)
    if m is None or getattr(m.type, "value", None) != "long":
        return None
    if segment.staged_dtype(name) != np.int32:
        return None
    lo, hi = segment.column_minmax(name)
    # a pow2-quantized base keeps descriptors coarse across segments
    base = 0 if lo >= 0 else -(1 << ((-int(lo) - 1).bit_length()))
    w = width_for(hi, base)
    return (w, base) if w else None


def plan_columns(segment, columns: Sequence[str]) -> Tuple:
    """((name, width, base), ...) for the packable subset of `columns`,
    sorted by name; () when packing is off. This tuple is the pack
    descriptor: it joins the staging cache key."""
    if not _ENABLED:
        return ()
    out = []
    for c in sorted(set(columns)):
        p = plan_column(segment, c)
        if p is not None:
            out.append((c, p[0], p[1]))
    return tuple(out)


# ---------------------------------------------------------------------------
# Host-side pack / unpack
# ---------------------------------------------------------------------------

def pack_padded(padded: np.ndarray, width: int, base: int) -> np.ndarray:
    """Pack a padded decoded column (length a multiple of 128 * vpw) into
    int32 words in the tile-planar layout. Stored values are masked to the
    width, so a padding fill outside [base, base + 2^width) wraps instead of
    spilling into a neighbour slot; consumers mask padding rows out."""
    vpw = PACK_WORD_BITS // width
    n = int(padded.shape[0])
    assert n % (LANE * vpw) == 0, \
        f"packed column length {n} not a multiple of {LANE * vpw}"
    mask = np.uint32((1 << width) - 1)
    u = ((padded.astype(np.int64) - base)
         & np.int64((1 << width) - 1)).astype(np.uint32)
    v3 = u.reshape(-1, vpw, LANE)
    words = np.zeros((v3.shape[0], LANE), dtype=np.uint32)
    for s in range(vpw):
        words |= (v3[:, s, :] & mask) << np.uint32(s * width)
    return words.reshape(-1).view(np.int32)


def pack_device(padded: torch.Tensor, width: int,
                base: int) -> torch.Tensor:
    """pack_padded on the tensor's device: the same int32 words bit for
    bit (a stack of encoded columns packs where its rows already are)."""
    vpw = PACK_WORD_BITS // width
    n = int(padded.shape[0])
    assert n % (LANE * vpw) == 0, \
        f"packed column length {n} not a multiple of {LANE * vpw}"
    v3 = ((padded.to(torch.int64) - base) & ((1 << width) - 1)) \
        .reshape(-1, vpw, LANE)
    words = v3[:, 0, :].clone()
    for s in range(1, vpw):
        words |= v3[:, s, :] << (s * width)
    # the uint32 pattern as int32 (two's complement), as the host's view
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).reshape(-1)


def unpack_host(pc_or_words, width: Optional[int] = None,
                base: Optional[int] = None, rows: Optional[int] = None,
                dtype="int32") -> np.ndarray:
    """Exact host inverse of pack_padded."""
    if isinstance(pc_or_words, PackedColumn):
        pc = pc_or_words
        words = pc.words.cpu().numpy() if torch.is_tensor(pc.words) \
            else np.asarray(pc.words)
        width, base, rows, dtype = pc.width, pc.base, pc.rows, pc.dtype_str
    else:
        words = np.asarray(pc_or_words)
    vpw = PACK_WORD_BITS // width
    w2 = words.view(np.uint32).reshape(-1, LANE)
    out = np.empty((w2.shape[0], vpw, LANE), dtype=np.uint32)
    for s in range(vpw):
        out[:, s, :] = (w2 >> np.uint32(s * width)) \
            & np.uint32((1 << width) - 1)
    return (out.reshape(rows).astype(np.int64) + base).astype(dtype)


# ---------------------------------------------------------------------------
# Device-side unpack
# ---------------------------------------------------------------------------

def unpack_device(pc: PackedColumn) -> torch.Tensor:
    """Decode a PackedColumn to its full-width tensor on its device (a
    stack of words [K, W] decodes to [K, rows]).
    torch's int32 >> is arithmetic; the mask cuts the sign bits, so a word
    with its top bit set (w16 slot 1) decodes exactly."""
    from druid_tpu_torch.data import cascade
    cascade.record_decode("packed")
    lead = tuple(pc.words.shape[:-1])   # a stack's leading [K] axis
    w2 = pc.words.reshape(lead + (-1, LANE))
    sh = torch.arange(pc.vpw, dtype=torch.int32,
                      device=pc.words.device)[:, None] * pc.width
    v = ((w2.unsqueeze(-2) >> sh) & ((1 << pc.width) - 1)) \
        .reshape(lead + (pc.rows,))
    if pc.base:
        v = v + pc.base
    dt = getattr(torch, pc.dtype_str)
    return v if v.dtype == dt else v.to(dt)
