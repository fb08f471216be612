"""Bitmap indexes: per-dimension-value row bitmaps with AND/OR/NOT algebra.

The port's copy of the reference package's `data/bitmap.py`. Capability
parity with the reference's CONCISE/Roaring bitmap indexes
(extendedset/src/main/java/org/apache/druid/extendedset/intset/ImmutableConciseSet.java,
processing/.../collections/bitmap/BitmapFactory.java). TPU-first design: the
bitmap index is a host-side planning structure. Bitmaps are bit-packed numpy
uint8 words (np.packbits layout); algebra is vectorized bitwise ops. The
output of filter planning is either
  * a packed bitmap shipped to the device and unpacked into a bool mask, or
  * a row-selectivity estimate used to decide bitmap-vs-device-predicate
    (the same decision as Filters.shouldUseBitmapIndex, reference
    processing/.../segment/filter/Filters.java).

Density adaptivity (the CONCISE/Roaring capability, not the format): a
value matching few rows stores a sorted row-id list (memory ∝ matches),
a dense value stores packed words (memory ∝ rows/8); per-value bitmaps
materialize lazily under an LRU byte budget, and multi-value unions build
straight from the index's sorted row order without materializing any
per-value bitmap at all.
"""
from __future__ import annotations

import collections
import threading
from typing import List, Optional, Sequence, Union

import numpy as np


def stable_argsort(keys: np.ndarray) -> np.ndarray:
    """`np.argsort(keys, kind="stable")`, the same permutation: keys that
    span fewer than 2**32 values sort as two 16-bit digits, the low one
    first, each by numpy's radix sort (a stable sort is unique)."""
    if keys.size == 0:
        return np.argsort(keys, kind="stable")
    lo = int(keys.min())
    span = int(keys.max()) - lo
    if span >= 1 << 32:
        return np.argsort(keys, kind="stable")
    k = (keys - lo).astype(np.uint32)
    # the cast to uint16 keeps the low 16 bits
    order = np.argsort(k.astype(np.uint16), kind="stable")
    if span < 1 << 16:
        return order
    high = (k[order] >> 16).astype(np.uint16)
    return order[np.argsort(high, kind="stable")]


class Bitmap:
    """Fixed-length packed bitset over row ids [0, n_rows)."""

    __slots__ = ("words", "n_rows")

    def __init__(self, words: np.ndarray, n_rows: int):
        if words.dtype != np.uint8:
            raise TypeError(f"bitmap words must be uint8, got {words.dtype}")
        self.words = words
        self.n_rows = n_rows

    # ---- constructors -------------------------------------------------
    @staticmethod
    def from_bool(mask: np.ndarray) -> "Bitmap":
        mask = np.asarray(mask, dtype=bool)
        return Bitmap(np.packbits(mask), mask.shape[0])

    @staticmethod
    def from_indices(indices: np.ndarray, n_rows: int) -> "Bitmap":
        mask = np.zeros(n_rows, dtype=bool)
        mask[indices] = True
        return Bitmap.from_bool(mask)

    @staticmethod
    def empty(n_rows: int) -> "Bitmap":
        return Bitmap(np.zeros((n_rows + 7) // 8, dtype=np.uint8), n_rows)

    @staticmethod
    def full(n_rows: int) -> "Bitmap":
        b = Bitmap(np.full((n_rows + 7) // 8, 0xFF, dtype=np.uint8), n_rows)
        return b._trim()

    def _trim(self) -> "Bitmap":
        # zero the tail bits past n_rows
        extra = self.words.shape[0] * 8 - self.n_rows
        if extra:
            tail_mask = np.uint8(0xFF << extra & 0xFF)
            self.words[-1] &= tail_mask
        return self

    # ---- algebra ------------------------------------------------------
    def __and__(self, other) -> "AnyBitmap":
        if isinstance(other, SparseBitmap):
            return bitmap_and(other, self)
        return Bitmap(self.words & other.words, self.n_rows)

    def __or__(self, other) -> "AnyBitmap":
        if isinstance(other, SparseBitmap):
            return bitmap_or(other, self)
        return Bitmap(self.words | other.words, self.n_rows)

    def __xor__(self, other) -> "AnyBitmap":
        if isinstance(other, SparseBitmap):
            return bitmap_xor(other, self)
        return Bitmap(self.words ^ other.words, self.n_rows)

    def __invert__(self) -> "Bitmap":
        return Bitmap(~self.words, self.n_rows)._trim()

    @staticmethod
    def union(bitmaps: Sequence["Bitmap"], n_rows: int) -> "Bitmap":
        if not bitmaps:
            return Bitmap.empty(n_rows)
        out = bitmaps[0].words.copy()
        for b in bitmaps[1:]:
            np.bitwise_or(out, b.words, out=out)
        return Bitmap(out, n_rows)

    @staticmethod
    def intersection(bitmaps: Sequence["Bitmap"], n_rows: int) -> "Bitmap":
        if not bitmaps:
            return Bitmap.full(n_rows)
        out = bitmaps[0].words.copy()
        for b in bitmaps[1:]:
            np.bitwise_and(out, b.words, out=out)
        return Bitmap(out, n_rows)

    # ---- materialization ---------------------------------------------
    def to_bool(self) -> np.ndarray:
        return np.unpackbits(self.words, count=self.n_rows).astype(bool)

    def to_indices(self) -> np.ndarray:
        return np.flatnonzero(self.to_bool())

    def test_ids(self, ids: np.ndarray) -> np.ndarray:
        """Membership of each row id — a word probe per id, no unpack
        (np.packbits stores row r at bit 7 - r%8 of byte r//8)."""
        ids = np.asarray(ids, dtype=np.int64)
        return ((self.words[ids >> 3] >> (7 - (ids & 7))) & 1).astype(bool)

    def cardinality(self) -> int:
        return int(np.unpackbits(self.words, count=self.n_rows).sum())

    def size_bytes(self) -> int:
        return int(self.words.nbytes)

    def __eq__(self, other):
        if not isinstance(other, Bitmap):
            # defer to the reflected __eq__ (SparseBitmap compares content)
            return NotImplemented
        return (self.n_rows == other.n_rows
                and np.array_equal(self.words, other.words))


class SparseBitmap:
    """Row-id-list bitmap for low-density values: memory scales with the
    matching rows, not the segment rows (the capability ImmutableConciseSet
    :79 / RoaringBitmap provide in the reference). Duck-types Bitmap.
    Algebra against another sparse operand stays sparse (sorted-id set
    ops); against a dense operand it probes the dense words at its own ids
    — the operand that is sparse is NEVER densified. Only complement
    (`~`), whose result is inherently dense, materializes words."""

    __slots__ = ("ids", "n_rows")

    def __init__(self, ids: np.ndarray, n_rows: int):
        self.ids = np.asarray(ids, dtype=np.int32)
        self.n_rows = n_rows

    @property
    def words(self) -> np.ndarray:
        return np.packbits(self.to_bool())

    def _dense(self) -> Bitmap:
        return Bitmap.from_bool(self.to_bool())

    def to_bool(self) -> np.ndarray:
        mask = np.zeros(self.n_rows, dtype=bool)
        mask[self.ids] = True
        return mask

    def to_indices(self) -> np.ndarray:
        return self.ids

    def cardinality(self) -> int:
        return int(self.ids.shape[0])

    def size_bytes(self) -> int:
        return int(self.ids.nbytes)

    def __and__(self, other):
        return bitmap_and(self, other)

    def __or__(self, other):
        return bitmap_or(self, other)

    def __xor__(self, other):
        return bitmap_xor(self, other)

    def __invert__(self):
        # the complement of a sparse set is dense by definition — this is
        # the one NECESSARY densification (callers wanting only the
        # cardinality use n_rows - cardinality(), no materialization)
        return ~self._dense()

    def __eq__(self, other):
        if isinstance(other, SparseBitmap):
            return (self.n_rows == other.n_rows
                    and np.array_equal(self.ids, other.ids))
        if isinstance(other, Bitmap):
            return self._dense() == other
        return NotImplemented


AnyBitmap = Union[Bitmap, SparseBitmap]

#: a value stores sparse when 4·matches < rows/8 (int32 ids vs packed words)
SPARSE_DENSITY_DIVISOR = 32
#: default budget for LRU-cached materialized per-value bitmaps per index
BITMAP_CACHE_BUDGET = 16 << 20


# ---------------------------------------------------------------------------
# Representation-aware algebra (the Roaring container-combine capability):
# sparse×sparse stays sparse via sorted-id set ops, sparse×dense probes the
# dense words at the sparse ids — a SparseBitmap operand is never densified.
# ---------------------------------------------------------------------------

def bitmap_and(a: AnyBitmap, b: AnyBitmap) -> AnyBitmap:
    if isinstance(a, SparseBitmap) and isinstance(b, SparseBitmap):
        return SparseBitmap(np.intersect1d(a.ids, b.ids, assume_unique=True),
                            a.n_rows)
    if isinstance(b, SparseBitmap):
        a, b = b, a
    if isinstance(a, SparseBitmap):
        return SparseBitmap(a.ids[b.test_ids(a.ids)], a.n_rows)
    return a & b


def bitmap_or(a: AnyBitmap, b: AnyBitmap) -> AnyBitmap:
    if isinstance(a, SparseBitmap) and isinstance(b, SparseBitmap):
        return SparseBitmap(np.union1d(a.ids, b.ids), a.n_rows)
    if isinstance(b, SparseBitmap):
        a, b = b, a
    if isinstance(a, SparseBitmap):
        # the union is at least as dense as the dense operand: fold the
        # sparse ids into a copy of its words (per-id bit set, no unpack)
        words = b.words.copy()
        ids = a.ids.astype(np.int64)
        np.bitwise_or.at(words, ids >> 3,
                         (1 << (7 - (ids & 7))).astype(np.uint8))
        return Bitmap(words, a.n_rows)
    return a | b


def bitmap_xor(a: AnyBitmap, b: AnyBitmap) -> AnyBitmap:
    if isinstance(a, SparseBitmap) and isinstance(b, SparseBitmap):
        return SparseBitmap(np.setxor1d(a.ids, b.ids), a.n_rows)
    if isinstance(b, SparseBitmap):
        a, b = b, a
    if isinstance(a, SparseBitmap):
        words = b.words.copy()
        ids = a.ids.astype(np.int64)
        np.bitwise_xor.at(words, ids >> 3,
                          (1 << (7 - (ids & 7))).astype(np.uint8))
        return Bitmap(words, a.n_rows)._trim()
    return a ^ b


def sparse_if_small(bm: AnyBitmap) -> AnyBitmap:
    """Demote a dense result to the id-list representation when that is
    the smaller container (the Roaring array/bitmap container cutover)."""
    if isinstance(bm, SparseBitmap):
        return bm
    if bm.cardinality() < bm.n_rows // SPARSE_DENSITY_DIVISOR:
        return SparseBitmap(bm.to_indices().astype(np.int32), bm.n_rows)
    return bm


# ---------------------------------------------------------------------------
# Device representation: packed uint32 words (LSB-first — row r lives at bit
# r % 32 of word r // 32) for the device-side bitmap algebra
# (engine/filters.py leaf_words). Density-adaptive shipping: a sparse bitmap ships its
# sorted id list (scattered into words ON DEVICE), a dense one ships the
# packed words directly — the host-decided Roaring container split.
# ---------------------------------------------------------------------------

#: bits per device bitmap word: the port's filter words
#: (engine/filters.py) are int32, row r at bit r % 32 of word r // 32
WORD_BITS = 32


def to_words32(bm: AnyBitmap, padded_rows: int) -> np.ndarray:
    """Packed uint32 row words over [0, padded_rows); rows past n_rows are
    0. padded_rows must be a multiple of 32 (any device row alignment is)."""
    if padded_rows % WORD_BITS or padded_rows < bm.n_rows:
        raise ValueError(f"padded_rows {padded_rows} is not a multiple of "
                         f"{WORD_BITS} covering {bm.n_rows} rows")
    mask = np.zeros(padded_rows, dtype=bool)
    mask[: bm.n_rows] = bm.to_bool()
    return np.packbits(mask, bitorder="little").view(np.uint32)


def device_repr(bm: AnyBitmap, padded_rows: int):
    """("sparse", int32 ids padded to a pow2 rung with `padded_rows` as the
    out-of-range sentinel) when the id list is the smaller transfer, else
    ("dense", uint32 words). The rung quantization bounds distinct device
    shapes (compile keys) exactly like the batching row ladder."""
    m = bm.cardinality()
    rung = 8
    while rung < m:
        rung <<= 1
    if rung * 4 < padded_rows // 8:
        ids = np.full(rung, padded_rows, dtype=np.int32)
        ids[:m] = np.sort(bm.to_indices())[:m]
        return "sparse", ids
    return "dense", to_words32(bm, padded_rows)


class BitmapIndex:
    """Per-dimension inverted index: dictionary id -> row bitmap.

    Reference analog: segment/column/BitmapIndex.java:27 backed by one
    compressed bitmap per dictionary value. The index keeps ONE sorted row
    order (built lazily from the id column); per-value bitmaps materialize
    on demand — dense packed words or sparse row-id lists by density — and
    live under an LRU byte budget, so a card-5000 dim on a 12.5M-row
    segment costs ~index order (n·4B), not card · n/8 bytes."""

    def __init__(self, n_rows: int, cardinality: int,
                 bitmaps: List[Optional[AnyBitmap]],
                 ids: Optional[np.ndarray] = None):
        self.n_rows = n_rows
        self.cardinality = cardinality
        self._bitmaps = bitmaps
        self._ids = ids
        self._order: Optional[np.ndarray] = None
        self._boundaries: Optional[np.ndarray] = None
        self._lru: "collections.OrderedDict[int, int]" = \
            collections.OrderedDict()          # vid -> size_bytes
        self._cached_bytes = 0
        self._budget = BITMAP_CACHE_BUDGET
        self._lock = threading.Lock()

    @staticmethod
    def build(ids: np.ndarray, cardinality: int) -> "BitmapIndex":
        ids = np.asarray(ids)
        return BitmapIndex(int(ids.shape[0]), cardinality,
                           [None] * cardinality, ids=ids)

    # ---- lazy sorted order ---------------------------------------------
    def _sorted(self):
        if self._order is None:
            order = stable_argsort(self._ids).astype(np.int32)
            self._boundaries = np.searchsorted(
                self._ids[order], np.arange(self.cardinality + 1))
            self._order = order
        return self._order, self._boundaries

    def _materialize(self, value_id: int) -> AnyBitmap:
        order, bounds = self._sorted()
        rows = order[bounds[value_id]:bounds[value_id + 1]]
        if rows.size < self.n_rows // SPARSE_DENSITY_DIVISOR:
            return SparseBitmap(np.sort(rows), self.n_rows)
        return Bitmap.from_indices(rows, self.n_rows)

    def _cache_put(self, value_id: int, b: AnyBitmap) -> None:
        size = b.size_bytes()
        self._bitmaps[value_id] = b
        self._lru[value_id] = size
        self._lru.move_to_end(value_id)
        self._cached_bytes += size
        while self._cached_bytes > self._budget and len(self._lru) > 1:
            vid, sz = self._lru.popitem(last=False)
            self._bitmaps[vid] = None
            self._cached_bytes -= sz

    # ---- lookups --------------------------------------------------------
    def rows_of(self, value_id: int) -> Optional[np.ndarray]:
        """The ascending row ids of one value, from the sorted row order, or
        None for an index without a backing id column (a persisted one)."""
        if self._ids is None:
            return None
        with self._lock:
            order, bounds = self._sorted()
        return order[bounds[value_id]:bounds[value_id + 1]]

    def bitmap(self, value_id: int) -> AnyBitmap:
        if value_id < 0 or value_id >= self.cardinality:
            return Bitmap.empty(self.n_rows)
        with self._lock:
            b = self._bitmaps[value_id]
            if b is not None:
                if value_id in self._lru:
                    self._lru.move_to_end(value_id)
                return b
            b = self._materialize(value_id)
            self._cache_put(value_id, b)
            return b

    def union_of(self, value_ids: np.ndarray) -> AnyBitmap:
        """Union over many values straight from the sorted row order — no
        per-value bitmaps are materialized (an OR / IN / regex over
        thousands of values touches each row id exactly once). A
        low-density result stays a SparseBitmap (id list), so downstream
        algebra and selectivity estimation never pay words for it."""
        import functools
        valid = [int(v) for v in value_ids if 0 <= v < self.cardinality]
        if not valid:
            return SparseBitmap(np.zeros(0, dtype=np.int32), self.n_rows)
        if self._ids is None:       # subclass without a backing id column
            return sparse_if_small(functools.reduce(
                bitmap_or, [self.bitmap(v) for v in valid]))
        with self._lock:
            order, bounds = self._sorted()
            parts = [order[bounds[v]:bounds[v + 1]] for v in valid]
        ids = np.concatenate(parts)
        if ids.size < self.n_rows // SPARSE_DENSITY_DIVISOR:
            return SparseBitmap(np.sort(ids).astype(np.int32), self.n_rows)
        return Bitmap.from_indices(ids, self.n_rows)

    def size_bytes(self) -> int:
        n = 0 if self._order is None else int(self._order.nbytes)
        with self._lock:
            return n + self._cached_bytes
