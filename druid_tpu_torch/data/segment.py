"""Segments: immutable columnar data blocks, host-resident with device staging.

The port's counterpart of the reference package's `data/segment.py`. The host
side is the same: int32 dictionary ids for string dimensions, int64/float32/
float64 numeric columns, and an int64 `__time` column sorted ascending.

`device_block` stages a column subset as DECODED torch tensors, padded to a
multiple of DEFAULT_ROW_ALIGN rows, plus `__time_offset` (int32 millis from
the interval start) and `__valid` (False on padding rows). Staged blocks are
cached per segment in a plain dict keyed like the reference's pool entries;
there is no byte budget, no bit-packing and no cascade encoding here.
"""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

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
    """A segment staged on a device as padded tensors (all `padded_rows` long):
    "__time_offset" int32, "__valid" bool, dimension ids int32, metrics in
    their staged dtype."""
    segment_id: SegmentId
    n_rows: int
    padded_rows: int
    time0: int
    arrays: Dict[str, torch.Tensor]


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

    def padded_rows(self, row_align: int = DEFAULT_ROW_ALIGN) -> int:
        return max(row_align, -(-self.n_rows // row_align) * row_align)

    # ---- device staging ------------------------------------------------
    def device_block(self, columns: Sequence[str], device: torch.device,
                     perm: Optional[np.ndarray] = None,
                     perm_key=None) -> DeviceBlock:
        """Stage `columns` (plus `__time_offset` and `__valid`) on `device`.

        `perm` applies a row permutation on the host before staging (the
        sorted-projection path); it needs a stable hashable `perm_key` so the
        cache tells layouts apart. Cached per (columns, device, perm_key)."""
        if perm is not None and perm_key is None:
            raise ValueError("device_block(perm=...) requires perm_key")
        key = ("block", tuple(sorted(set(columns))), str(device), perm_key)
        return self.device_cached(
            key, lambda: self._stage_block(columns, device, perm))

    def _stage_block(self, columns: Sequence[str], device: torch.device,
                     perm: Optional[np.ndarray]) -> DeviceBlock:
        pad_n = self.padded_rows()
        time0 = self.interval.start
        off = self.time_ms - time0
        if off.size and (off.min() < 0 or off.max() >= 2**31):
            raise ValueError(
                f"segment rows outside int32 ms-offset range of interval "
                f"{self.interval}")

        def _pad(a: np.ndarray, fill=0) -> torch.Tensor:
            if perm is not None:
                a = a[perm]
            out = np.full((pad_n,), fill, dtype=a.dtype)
            out[: a.shape[0]] = a
            return torch.from_numpy(out).to(device)

        arrays: Dict[str, torch.Tensor] = {
            "__time_offset": _pad(off.astype(np.int32)),
            "__valid": _pad(np.ones(self.n_rows, dtype=bool), False),
        }
        for name in columns:
            if name in self.dims:
                arrays[name] = _pad(self.dims[name].ids)
            elif name in self.metrics:
                dt = self.staged_dtype(name)
                vals = self.metrics[name].values
                arrays[name] = _pad(vals if vals.dtype == dt
                                    else vals.astype(dt))
            elif name not in ("__time", "__time_offset", "__valid"):
                raise KeyError(f"no such column {name!r} in segment {self.id}")
        return DeviceBlock(segment_id=self.id, n_rows=self.n_rows,
                           padded_rows=pad_n, time0=time0, arrays=arrays)

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
