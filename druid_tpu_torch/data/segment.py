"""Segments: immutable columnar data blocks, host-resident with device staging.

The port's counterpart of the reference package's `data/segment.py`. The host
side is the same: int32 dictionary ids for string dimensions, int64/float32/
float64 numeric columns, and an int64 `__time` column sorted ascending.

`device_block` stages a column subset, padded to a multiple of
DEFAULT_ROW_ALIGN rows, plus `__time_offset` (int32 millis from the interval
start) and `__valid` (False on padding rows). A column that kernels B1/B2
read as words (the caller's `words`) stages as bit-packed words
(data/packed.py) where `cascade.plan_pair` packs it; every other column
stages as a decoded tensor, since a consumer that reads it decoded would
unpack it on every query. A permuted layout (the sorted projection) packs
after the permutation. Staged blocks are cached per segment in a plain dict
keyed by the columns, device, permutation and pack descriptor; there is no
byte budget.
"""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from druid_tpu_torch.data import cascade, packed
from druid_tpu_torch.data.dictionary import Dictionary
from druid_tpu_torch.utils.intervals import Interval

#: staged row counts are padded to a multiple of this
DEFAULT_ROW_ALIGN = 1024


class ValueType(enum.Enum):
    STRING = "string"
    LONG = "long"
    FLOAT = "float"
    DOUBLE = "double"

    @property
    def numpy_dtype(self):
        return {
            ValueType.LONG: np.int64,
            ValueType.FLOAT: np.float32,
            ValueType.DOUBLE: np.float64,
        }[self]


@dataclass(frozen=True)
class SegmentId:
    """Reference analog: DataSegment identity (api/.../DataSegment)."""
    datasource: str
    interval: Interval
    version: str
    partition: int = 0

    def __str__(self):
        return (f"{self.datasource}_{self.interval}_{self.version}"
                f"_{self.partition}")


class StringDimColumn:
    """Dictionary-encoded single-value string dimension."""

    __slots__ = ("ids", "dictionary")

    def __init__(self, ids: np.ndarray, dictionary: Dictionary):
        if ids.dtype != np.int32:
            raise TypeError(f"dimension ids must be int32, got {ids.dtype}")
        self.ids = ids
        self.dictionary = dictionary

    @property
    def cardinality(self) -> int:
        return self.dictionary.cardinality


class NumericColumn:
    __slots__ = ("values", "type")

    def __init__(self, values: np.ndarray, vtype: ValueType):
        self.values = values
        self.type = vtype


@dataclass
class DeviceBlock:
    """A segment staged on a device, every column `padded_rows` long once
    decoded: "__time_offset" int32, "__valid" bool, dimension ids int32,
    metrics in their staged dtype. An entry is a tensor or a
    packed.PackedColumn; `packs` is the descriptor it was staged under."""
    segment_id: SegmentId
    n_rows: int
    padded_rows: int
    time0: int
    arrays: Dict[str, object]
    packs: Tuple = ()

    @property
    def resident_nbytes(self) -> int:
        """Bytes the block holds on its device."""
        return sum(int(v.nbytes) for v in self.arrays.values())

    @property
    def logical_nbytes(self) -> int:
        """Bytes the block would hold with every column decoded."""
        return sum(int(getattr(v, "logical_nbytes", v.nbytes))
                   for v in self.arrays.values())

    def encodings(self) -> Dict[str, str]:
        """{column: its staged representation}, for reports."""
        return {k: repr(v) if not torch.is_tensor(v)
                else f"dense {str(v.dtype).replace('torch.', '')}"
                for k, v in sorted(self.arrays.items())}


class Segment:
    """Immutable columnar segment (host representation)."""

    def __init__(self, segment_id: SegmentId, time_ms: np.ndarray,
                 dims: Dict[str, StringDimColumn],
                 metrics: Dict[str, NumericColumn]):
        """Rows keep the order they are given in."""
        self.id = segment_id
        self.time_ms = np.asarray(time_ms, dtype=np.int64)
        self.dims = dims
        self.metrics = metrics
        self.n_rows = int(self.time_ms.shape[0])
        self.min_time = int(self.time_ms.min()) if self.n_rows else 0
        self.max_time = int(self.time_ms.max()) if self.n_rows else 0
        self._aux_cache: Dict[Tuple, object] = {}
        self._device_cache: Dict[Tuple, object] = {}
        self._lock = threading.Lock()

    @property
    def interval(self) -> Interval:
        return self.id.interval

    @property
    def time_ordered(self) -> bool:
        """Whether the rows are ascending in time, computed once from the
        data (the reference's Segment takes it from its caller)."""
        return self.aux_cached(("time_ordered",), lambda: bool(
            np.all(self.time_ms[1:] >= self.time_ms[:-1])))

    def padded_rows(self, row_align: int = DEFAULT_ROW_ALIGN) -> int:
        return max(row_align, -(-self.n_rows // row_align) * row_align)

    # ---- device staging ------------------------------------------------
    def device_block(self, columns: Sequence[str], device: torch.device,
                     perm: Optional[np.ndarray] = None, perm_key=None,
                     words: Sequence[str] = ()) -> DeviceBlock:
        """Stage `columns` (plus `__time_offset` and `__valid`) on `device`.

        `perm` applies a row permutation on the host before staging (the
        sorted-projection path); it needs a stable hashable `perm_key` so the
        cache tells layouts apart. `words` names the value columns kernels
        B1/B2 will read as words: each stages packed where
        `cascade.plan_pair` packs it (a cascade rung claims a column first,
        and it then stages dense). Cached per (columns, device, perm_key,
        pack descriptor): flipping packing never serves a block staged the
        other way."""
        if perm is not None and perm_key is None:
            raise ValueError("device_block(perm=...) requires perm_key")
        packs = ()
        if words:
            _, packs = cascade.plan_pair(self, columns,
                                         permuted=perm is not None)
            want = set(words)
            packs = tuple(p for p in packs if p[0] in want)
        key = ("block", tuple(sorted(set(columns))), str(device), perm_key,
               packs)
        return self.device_cached(
            key, lambda: self._stage_block(columns, device, perm, packs))

    def _stage_block(self, columns: Sequence[str], device: torch.device,
                     perm: Optional[np.ndarray],
                     packs: Tuple = ()) -> DeviceBlock:
        pack_for = {name: (w, base) for name, w, base in packs}
        pad_n = self.padded_rows()
        time0 = self.interval.start
        off = self.time_ms - time0
        if off.size and (off.min() < 0 or off.max() >= 2**31):
            raise ValueError(
                f"segment rows outside int32 ms-offset range of interval "
                f"{self.interval}")

        def _pad(a: np.ndarray, fill=0) -> np.ndarray:
            if perm is not None:
                a = a[perm]
            out = np.full((pad_n,), fill, dtype=a.dtype)
            out[: a.shape[0]] = a
            return out

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        def _stage(name: str, padded: np.ndarray):
            p = pack_for.get(name)
            if p is None:
                return put(padded)
            return packed.PackedColumn(
                put(packed.pack_padded(padded, *p)), p[0], p[1],
                padded.shape[0], str(padded.dtype))

        arrays: Dict[str, object] = {
            "__time_offset": put(_pad(off.astype(np.int32))),
            "__valid": put(_pad(np.ones(self.n_rows, dtype=bool), False)),
        }
        for name in columns:
            if name in self.dims:
                arrays[name] = _stage(name, _pad(self.dims[name].ids))
            elif name in self.metrics:
                dt = self.staged_dtype(name)
                vals = self.metrics[name].values
                arrays[name] = _stage(name, _pad(vals if vals.dtype == dt
                                                 else vals.astype(dt)))
            elif name not in ("__time", "__time_offset", "__valid"):
                raise KeyError(f"no such column {name!r} in segment {self.id}")
        return DeviceBlock(segment_id=self.id, n_rows=self.n_rows,
                           padded_rows=pad_n, time0=time0, arrays=arrays,
                           packs=packs)

    def device_cached(self, key: Tuple, fn):
        """Memoize a device tensor (or block) built by `fn` under `key`."""
        with self._lock:
            if key in self._device_cache:
                return self._device_cache[key]
        value = fn()
        with self._lock:
            return self._device_cache.setdefault(key, value)

    def device_contains(self, key: Tuple) -> bool:
        """Whether `device_cached` holds `key` (a residency probe)."""
        with self._lock:
            return key in self._device_cache

    def column_minmax(self, name: str) -> Tuple[int, int]:
        """Cached (min, max) of a numeric column (0, 0 when empty)."""
        def _compute():
            v = self.metrics[name].values
            if v.size == 0:
                return (0, 0)
            return (v.min().item(), v.max().item())
        return self.aux_cached(("minmax", name), _compute)

    def column_finite(self, name: str) -> bool:
        """Cached: True when a float column contains no NaN/Inf. Gates the
        one-hot-matmul float path, where a single non-finite value would
        poison every group (NaN·0 = NaN in the one-hot contraction)."""
        def _compute():
            m = self.metrics.get(name)
            if m is None or not np.issubdtype(m.values.dtype, np.floating):
                return True
            return bool(np.isfinite(m.values).all())
        return self.aux_cached(("finite", name), _compute)

    def staged_dtype(self, name: str):
        """Dtype a column stages as. LONG columns whose values fit int32
        stage narrow, as in the reference; the kernels restore exact 64-bit
        sums at group granularity."""
        if name in self.dims or name == "__time_offset":
            return np.dtype(np.int32)
        m = self.metrics.get(name)
        if m is None:
            return None
        if m.type is ValueType.LONG:
            lo, hi = self.column_minmax(name)
            if -(2**31) <= lo and hi < 2**31:
                return np.dtype(np.int32)
            return np.dtype(np.int64)
        return np.dtype(m.type.numpy_dtype)

    def aux_cached(self, key: Tuple, fn):
        """Memoize derived host arrays (bucket ids, fused keys, projections)
        per segment."""
        with self._lock:
            if key in self._aux_cache:
                return self._aux_cache[key]
        value = fn()
        with self._lock:
            return self._aux_cache.setdefault(key, value)

    def __repr__(self):
        return f"Segment({self.id}, rows={self.n_rows})"
