"""Segments: immutable columnar data blocks, host-resident with device staging.

The port's counterpart of the reference package's `data/segment.py`. The host
side is the same: int32 dictionary ids for string dimensions, int64/float32/
float64 numeric columns, 2-D complex columns (one state vector a row, such
as HLL registers), and an int64 `__time` column sorted ascending.

`device_block` stages a column subset, padded to a multiple of
DEFAULT_ROW_ALIGN rows, plus `__time_offset` (int32 millis from the interval
start) and `__valid` (False on padding rows). A column that kernels B1/B2
read as words (the caller's `words`) stages as bit-packed words
(data/packed.py) where `cascade.plan_pair` packs it; every other column
stages as a decoded tensor, since a consumer that reads it decoded would
unpack it on every query. A complex column stages as-is, padded by rows. A
permuted layout (the sorted projection) packs
after the permutation. Staged blocks, and every other device tensor a
segment keeps (`device_cached`), live in the process-wide byte-budgeted
device pool (data/devicepool.py), keyed by the columns, row alignment,
device, permutation and pack descriptor; the pool evicts the least recently
used entry by bytes and drops a segment's entries when it is collected.

`SegmentBuilder` makes a segment from rows or columns (the reference's, for
a subquery's rows and for tests); its rows come out sorted by time.
"""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from druid_tpu_torch.data import cascade, packed
from druid_tpu_torch.data.bitmap import BitmapIndex
from druid_tpu_torch.data.devicepool import device_pool
from druid_tpu_torch.data.dictionary import NULL, Dictionary
from druid_tpu_torch.utils.intervals import Interval

#: staged row counts are padded to a multiple of this
DEFAULT_ROW_ALIGN = 1024


class ValueType(enum.Enum):
    STRING = "string"
    LONG = "long"
    FLOAT = "float"
    DOUBLE = "double"
    COMPLEX = "complex"

    @property
    def numpy_dtype(self):
        return {
            ValueType.LONG: np.int64,
            ValueType.FLOAT: np.float32,
            ValueType.DOUBLE: np.float64,
        }[self]


@dataclass(frozen=True)
class ColumnCapabilities:
    """What a column is (Druid's ColumnCapabilities)."""
    type: ValueType
    dictionary_encoded: bool = False
    has_bitmap_index: bool = False
    has_multiple_values: bool = False


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
    """Dictionary-encoded single-value string dimension. Its bitmap index
    (data/bitmap.py) is built from the ids the first time `bitmap_index()`
    asks, or set by a segment loader from the persisted bitmaps."""

    __slots__ = ("ids", "dictionary", "_bitmap_index", "_lock")

    def __init__(self, ids: np.ndarray, dictionary: Dictionary):
        if ids.dtype != np.int32:
            raise TypeError(f"dimension ids must be int32, got {ids.dtype}")
        self.ids = ids
        self.dictionary = dictionary
        self._bitmap_index: Optional[BitmapIndex] = None
        self._lock = threading.Lock()

    @property
    def cardinality(self) -> int:
        return self.dictionary.cardinality

    def bitmap_index(self) -> BitmapIndex:
        """The column's bitmap index, built from the ids on first use."""
        with self._lock:
            if self._bitmap_index is None:
                self._bitmap_index = BitmapIndex.build(self.ids,
                                                       self.cardinality)
            return self._bitmap_index

    def held_bitmap_index(self) -> Optional[BitmapIndex]:
        """The bitmap index where the column holds one (persisted, or built
        already), else None; builds nothing."""
        with self._lock:
            return self._bitmap_index

    def set_bitmap_index(self, index: BitmapIndex):
        # the lazy build's lock: an unlocked store could be overwritten by a
        # concurrent bitmap_index() builder
        with self._lock:
            self._bitmap_index = index

    def capabilities(self) -> ColumnCapabilities:
        return ColumnCapabilities(ValueType.STRING, dictionary_encoded=True,
                                  has_bitmap_index=True)


class NumericColumn:
    __slots__ = ("values", "type")

    def __init__(self, values: np.ndarray, vtype: ValueType):
        self.values = values
        self.type = vtype

    def capabilities(self) -> ColumnCapabilities:
        return ColumnCapabilities(self.type)


class ComplexColumn:
    """A fixed-width complex metric: one row is one state vector (HLL
    registers: int8 [n, 2^log2m]), so the device reduces the rows
    directly."""

    __slots__ = ("values", "type_name")
    type = ValueType.COMPLEX

    def __init__(self, values: np.ndarray, type_name: str):
        if values.ndim != 2:
            raise ValueError(f"a complex column is 2-D, got {values.shape}")
        self.values = values
        self.type_name = type_name


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
        self._aux_inflight: Dict[Tuple, threading.Event] = {}
        self._lock = threading.Lock()
        # device tensors live in the process-wide pool, dropped when this
        # segment is collected
        self._pool = device_pool()
        self._pool_owner = self._pool.register_owner(self)

    @property
    def interval(self) -> Interval:
        return self.id.interval

    @property
    def time_ordered(self) -> bool:
        """Whether the rows are ascending in time, computed once from the
        data (the reference's Segment takes it from its caller)."""
        return self.aux_cached(("time_ordered",), lambda: bool(
            np.all(self.time_ms[1:] >= self.time_ms[:-1])))

    def column_capabilities(self, name: str) -> Optional[ColumnCapabilities]:
        if name == "__time":
            return ColumnCapabilities(ValueType.LONG)
        if name in self.dims:
            return ColumnCapabilities(ValueType.STRING,
                                      dictionary_encoded=True,
                                      has_bitmap_index=True)
        m = self.metrics.get(name)
        return None if m is None else ColumnCapabilities(m.type)

    def size_bytes(self) -> int:
        """Host bytes of the rows: time, dimension ids and metric values. A
        lazily loaded column (storage/format_v2.py) reports its decoded
        bytes (`logical_nbytes`) without decoding."""
        n = self.time_ms.nbytes
        for c in list(self.dims.values()) + list(self.metrics.values()):
            hint = getattr(c, "logical_nbytes", None)
            n += hint if hint is not None else (
                c.ids if isinstance(c, StringDimColumn) else c.values).nbytes
        return int(n)

    def padded_rows(self, row_align: int = DEFAULT_ROW_ALIGN) -> int:
        return max(row_align, -(-self.n_rows // row_align) * row_align)

    # ---- device staging ------------------------------------------------
    def device_block(self, columns: Sequence[str], device: torch.device,
                     perm: Optional[np.ndarray] = None, perm_key=None,
                     words: Sequence[str] = (),
                     row_align: int = DEFAULT_ROW_ALIGN) -> DeviceBlock:
        """Stage `columns` (plus `__time_offset` and `__valid`) on `device`,
        padded to a multiple of `row_align` rows: the batched path stages at
        its ladder rung (row_align >= n_rows pads to exactly row_align).

        `perm` applies a row permutation on the host before staging (the
        sorted-projection path); it needs a stable hashable `perm_key` so the
        cache tells layouts apart. `words` names the value columns kernels
        B1/B2 will read as words: each stages packed where
        `cascade.plan_pair` packs it (a cascade rung claims a column first,
        and it then stages dense). Pooled per (columns, row_align, device,
        perm_key, pack descriptor): flipping packing never serves a block
        staged the other way, and a block padded to a rung never stands in
        for one padded to DEFAULT_ROW_ALIGN."""
        if perm is not None and perm_key is None:
            raise ValueError("device_block(perm=...) requires perm_key")
        packs = ()
        if words:
            _, packs = cascade.plan_pair(self, columns,
                                         permuted=perm is not None)
            want = set(words)
            packs = tuple(p for p in packs if p[0] in want)
        key = ("block", tuple(sorted(set(columns))), row_align, str(device),
               perm_key, packs)
        return self._pool.get_or_build(
            self._pool_owner, key,
            lambda: self._stage_block(columns, device, perm, packs,
                                      row_align))

    def _stage_block(self, columns: Sequence[str], device: torch.device,
                     perm: Optional[np.ndarray], packs: Tuple = (),
                     row_align: int = DEFAULT_ROW_ALIGN) -> DeviceBlock:
        pack_for = {name: (w, base) for name, w, base in packs}
        pad_n = self.padded_rows(row_align)
        time0 = self.interval.start
        off = self.time_ms - time0
        if off.size and (off.min() < 0 or off.max() >= 2**31):
            raise ValueError(
                f"segment rows outside int32 ms-offset range of interval "
                f"{self.interval}")

        def _pad(a: np.ndarray, fill=0) -> np.ndarray:
            if perm is not None:
                a = a[perm]
            out = np.full((pad_n,) + a.shape[1:], fill, dtype=a.dtype)
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
        """Memoize a derived device tensor built by `fn` under `key`, in the
        same byte-budgeted pool as the staged blocks."""
        return self._pool.get_or_build(self._pool_owner, ("aux",) + key, fn)

    def device_contains(self, key: Tuple) -> bool:
        """Whether the pool holds `device_cached`'s `key` (a residency
        probe that touches neither the LRU order nor the pool's counts)."""
        return self._pool.peek(self._pool_owner, ("aux",) + key)

    def device_entries(self) -> Dict[Tuple, object]:
        """{key: value} of this segment's resident pool entries: blocks
        under ("block", ...), `device_cached` entries under their own
        key."""
        return {(k[1:] if k[0] == "aux" else k): v
                for k, v in self._pool.owner_entries(self._pool_owner).items()}

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
        if m.type is ValueType.COMPLEX:
            return m.values.dtype
        return np.dtype(m.type.numpy_dtype)

    def aux_cached(self, key: Tuple, fn):
        """Memoize derived host arrays (bucket ids, fused keys, projections)
        per segment. One `fn` per key at a time: a concurrent caller (two
        broker threads on one cold segment) waits for the running one
        rather than repeating a projection's sort."""
        while True:
            with self._lock:
                if key in self._aux_cache:
                    return self._aux_cache[key]
                pending = self._aux_inflight.get(key)
                if pending is None:
                    done = self._aux_inflight[key] = threading.Event()
                    break
            pending.wait()
        try:
            value = fn()
            with self._lock:
                return self._aux_cache.setdefault(key, value)
        finally:
            with self._lock:
                self._aux_inflight.pop(key, None)
            done.set()

    def __repr__(self):
        return f"Segment({self.id}, rows={self.n_rows})"


class SegmentBuilder:
    """Builds a Segment from rows or from columns, as the reference's
    SegmentBuilder: dimension values as strings (None reads as ""), a
    metric LONG while every value is an int and DOUBLE from the first float,
    and the rows sorted by time (stable) when built."""

    def __init__(self, datasource: str, interval: Interval,
                 version: str = "v0", partition: int = 0):
        self.segment_id = SegmentId(datasource, interval, version, partition)
        self._time: List[int] = []
        self._dim_values: Dict[str, List[str]] = {}
        self._metric_values: Dict[str, list] = {}
        self._metric_types: Dict[str, ValueType] = {}
        self._n = 0

    def add_row(self, ts_ms: int, dims: Dict[str, Optional[str]],
                metrics: Dict[str, float]):
        for name in dims:
            if name not in self._dim_values:
                self._dim_values[name] = [NULL] * self._n
        for name in metrics:
            if name not in self._metric_values:
                self._metric_values[name] = [0] * self._n
                self._metric_types.setdefault(
                    name, ValueType.LONG if isinstance(metrics[name], int)
                    else ValueType.DOUBLE)
            elif (self._metric_types.get(name) == ValueType.LONG
                  and isinstance(metrics.get(name), float)):
                # a float arriving later widens the column, rather than
                # truncating at build time
                self._metric_types[name] = ValueType.DOUBLE
        self._time.append(int(ts_ms))
        for name, vals in self._dim_values.items():
            v = dims.get(name)
            vals.append(NULL if v is None else str(v))
        for name, vals in self._metric_values.items():
            vals.append(metrics.get(name, 0))
        self._n += 1

    def add_columns(self, time_ms: np.ndarray,
                    dims: Dict[str, Sequence[str]],
                    metrics: Dict[str, np.ndarray],
                    metric_types: Optional[Dict[str, ValueType]] = None):
        if self._n:
            raise ValueError("add_columns on non-empty builder unsupported")
        self._time = list(np.asarray(time_ms, dtype=np.int64))
        for k, v in dims.items():
            self._dim_values[k] = [NULL if x is None else str(x) for x in v]
        for k, v in metrics.items():
            arr = np.asarray(v)
            self._metric_values[k] = arr
            if metric_types and k in metric_types:
                self._metric_types[k] = metric_types[k]
            else:
                self._metric_types[k] = (
                    ValueType.LONG if np.issubdtype(arr.dtype, np.integer)
                    else ValueType.DOUBLE if arr.dtype == np.float64
                    else ValueType.FLOAT)
        self._n = len(self._time)

    def build(self) -> Segment:
        time_ms = np.asarray(self._time, dtype=np.int64)
        order = np.argsort(time_ms, kind="stable")
        dims: Dict[str, StringDimColumn] = {}
        for name, values in self._dim_values.items():
            d = Dictionary.from_values(values)
            dims[name] = StringDimColumn(d.encode(values)[order], d)
        metrics: Dict[str, NumericColumn] = {}
        for name, values in self._metric_values.items():
            vtype = self._metric_types[name]
            arr = np.asarray(values, dtype=vtype.numpy_dtype)[order]
            metrics[name] = NumericColumn(arr, vtype)
        return Segment(self.segment_id, time_ms[order], dims, metrics)
