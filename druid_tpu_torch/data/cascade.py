"""Cascaded encodings: the planning half of the reference's `data/cascade.py`
and the one decode entry point of staged columns.

`plan_pair` is the reference's planner, a pure function of cached column
stats: the cascade rungs claim their columns first (RLE for a low-run-count
int32 column, delta or FOR for `__time_offset` when its gaps or its range
fit 8 bits), and packing (data/packed.py) covers the rest. A permuted layout
(the sorted projection) cascades nothing, since a permutation destroys runs
and order.

The port stages no cascade rung. No consumer reads one encoded yet (the
reference's first is code-domain aggregation), so each would be decoded on
every query, and with no byte budget its resident bytes buy nothing.
`Segment.device_block` therefore stages a claimed column dense and packs
only the value columns kernels B1/B2 read as words.

`split_resident` returns the packed columns for the kernels and a
`DecodedView` that decodes a column the first time a dense consumer reads
it, so a column only B1/B2 read is never decoded. `decode_stats` counts the
decodes that ran (one per column per query).

The host run tables (`rle_encode`, `column_run_info`, cached on the
segment) feed code-domain aggregation (engine/rundomain.py) and the run-table
filter leaves (engine/filters.py, engine/megakernel.py); `code_domain_stats`
counts the segments served in run space. `set_run_domain_enabled(False)`
pins the row program.

Not here yet: the LZ4 rung (`_plan_lz4` plans nothing, so float columns
stage decoded).
"""
from __future__ import annotations

import collections
import threading
from collections.abc import MutableMapping
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from druid_tpu_torch.data import packed as packed_mod
from druid_tpu_torch.engine.contracts import CASCADE_MAX_RUNS
from druid_tpu_torch.utils.emitter import Monitor

#: RLE is planned only when its run arrays are at least this many times
#: smaller than the packed or decoded column
RLE_MIN_WIN = 2
#: widest FOR or delta encoding of `__time_offset`
TIME_MAX_WIDTH = 8
#: code-domain aggregation needs at least this many rows per joint run on
#: average: below it the row program is already cheap
RUN_DOMAIN_MIN_ROWS_PER_RUN = 16

_RUN_DOMAIN = True
_STATE_LOCK = threading.Lock()


def set_run_domain_enabled(on: bool) -> bool:
    """Turn code-domain aggregation on or off for the process (on by
    default); returns the previous value. Off pins the row program."""
    global _RUN_DOMAIN
    with _STATE_LOCK:
        prev = _RUN_DOMAIN
        _RUN_DOMAIN = bool(on)
        return prev


def run_domain_enabled() -> bool:
    return _RUN_DOMAIN


def pad_pow2(n: int, floor: int = 8) -> int:
    n = max(int(n), 1)
    p = floor
    while p < n:
        p <<= 1
    return p


# ---------------------------------------------------------------------------
# Decode counter
# ---------------------------------------------------------------------------

_DECODES: "collections.Counter" = collections.Counter()
_DECODES_LOCK = threading.Lock()


def record_decode(kind: str, n: int = 1) -> None:
    """Count one decode of a column of `kind` ("packed" in the port)."""
    with _DECODES_LOCK:
        _DECODES[kind] += n


def decode_stats() -> Dict[str, int]:
    with _DECODES_LOCK:
        return dict(_DECODES)


def reset_decode_stats() -> None:
    with _DECODES_LOCK:
        _DECODES.clear()


# ---------------------------------------------------------------------------
# Cached column stats (host, per segment)
# ---------------------------------------------------------------------------

def _raw(segment, name: str) -> np.ndarray:
    col = segment.dims.get(name)
    return col.ids if col is not None else segment.metrics[name].values


def column_run_count(segment, name: str) -> int:
    """Cached run count of a column's raw values (dims: dictionary ids)."""
    def _compute():
        v = _raw(segment, name)
        if v.shape[0] == 0:
            return 0
        return 1 + int(np.count_nonzero(v[1:] != v[:-1]))
    return segment.aux_cached(("cascade_runs", name), _compute)


def rle_encode(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(run values as int32, exclusive run ends as int32: the start of the
    next run, the last one the row count) of a raw 1-D column."""
    v = np.asarray(values)
    if v.shape[0] == 0:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32)
    b = np.empty(v.shape[0], dtype=bool)
    b[0] = True
    np.not_equal(v[1:], v[:-1], out=b[1:])
    starts = np.flatnonzero(b)
    ends = np.concatenate([starts[1:], [v.shape[0]]]).astype(np.int32)
    return v[starts].astype(np.int32), ends


def _rle_encoded(segment, name: str) -> Tuple[np.ndarray, np.ndarray]:
    """Cached `rle_encode` of a column's raw values."""
    return segment.aux_cached(("cascade_rleenc", name),
                              lambda: rle_encode(_raw(segment, name)))


def column_run_info(segment, name: str, max_runs: Optional[int] = None
                    ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """(run values, exclusive run ends, run count) of a dimension or metric
    whose run count is within `max_runs` (by default n_rows // 8), never
    above CASCADE_MAX_RUNS; else None."""
    if name not in segment.dims and name not in segment.metrics:
        return None
    nr = column_run_count(segment, name)
    if nr == 0:
        return None
    limit = min(max(segment.n_rows // 8, 1) if max_runs is None
                else max_runs, CASCADE_MAX_RUNS)
    if nr > limit:
        return None
    values, ends = _rle_encoded(segment, name)
    return values, ends, nr


def _time_stats(segment) -> Tuple[int, int, int]:
    """(min offset, max offset, largest gap between consecutive rows, or -1
    when the segment is not time-ordered)."""
    t0 = segment.interval.start
    lo = segment.min_time - t0
    hi = segment.max_time - t0

    def _compute():
        if not segment.time_ordered or segment.n_rows < 2:
            return 0 if segment.time_ordered else -1
        return int(np.max(np.diff(segment.time_ms)))
    md = segment.aux_cached(("cascade_tdelta",), _compute)
    return int(lo), int(hi), md


# ---------------------------------------------------------------------------
# Planning (pure functions of cached stats)
# ---------------------------------------------------------------------------

def _plan_time(segment) -> Optional[Tuple]:
    if segment.n_rows == 0:
        return None
    lo, hi, md = _time_stats(segment)
    base = (1 << (lo.bit_length() - 1)) if lo > 0 else 0
    wf = packed_mod.width_for(hi, base)
    wd = packed_mod.width_for(md, 0) if md >= 0 else 0
    if wf > TIME_MAX_WIDTH:
        wf = 0
    if wd > TIME_MAX_WIDTH:
        wd = 0
    if wd and (not wf or wd < wf):
        return ("delta", wd)
    if wf:
        return ("for", wf, base)
    return None


def _plan_rle(segment, name: str) -> Optional[Tuple]:
    nr = column_run_count(segment, name)
    if nr == 0:
        return None
    padded_runs = pad_pow2(nr)
    if padded_runs > CASCADE_MAX_RUNS:
        return None
    rle_bytes = padded_runs * 8           # two int32 arrays
    p = packed_mod.plan_column(segment, name)
    alt_bytes = segment.n_rows * p[0] // 8 if p is not None \
        else segment.n_rows * 4
    if rle_bytes * RLE_MIN_WIN > alt_bytes:
        return None
    return ("rle", padded_runs)


def _plan_lz4(segment, name: str) -> Optional[Tuple]:
    """The LZ4 rung is not ported: float columns stage decoded."""
    return None


def plan_column(segment, name: str) -> Optional[Tuple]:
    """Cascade descriptor tail for one column, or None."""
    if name == "__time_offset":
        return _plan_time(segment)
    if name in segment.dims:
        return _plan_rle(segment, name)
    m = segment.metrics.get(name)
    if m is None:
        return None
    t = getattr(m.type, "value", None)
    if t == "long":
        if segment.staged_dtype(name) != np.int32:
            return None
        return _plan_rle(segment, name)
    if t in ("float", "double"):
        return _plan_lz4(segment, name)
    return None


def plan_columns(segment, columns: Sequence[str],
                 permuted: bool = False) -> Tuple:
    """((name, kind, *params), ...) for the cascade-eligible subset of
    `columns` plus `__time_offset`, sorted by name; () when the layout is
    permuted (a permutation destroys runs and order)."""
    if permuted:
        return ()
    out = []
    for c in sorted(set(columns) | {"__time_offset"}):
        p = plan_column(segment, c)
        if p is not None:
            out.append((c,) + p)
    return tuple(out)


def plan_pair(segment, columns: Sequence[str],
              permuted: bool = False) -> Tuple[Tuple, Tuple]:
    """(cascade descriptor, pack descriptor), cascade claims first: a column
    is planned under at most one encoding."""
    cascades = plan_columns(segment, columns, permuted)
    claimed = {e[0] for e in cascades}
    packs = packed_mod.plan_columns(
        segment, [c for c in columns if c not in claimed])
    return cascades, packs


# ---------------------------------------------------------------------------
# The decode entry point
# ---------------------------------------------------------------------------

def dtype_name(v) -> str:
    """The decoded dtype of a staged entry, without decoding it."""
    if isinstance(v, packed_mod.PackedColumn):
        return v.dtype_str
    return str(v.dtype).replace("torch.", "")


class DecodedView(MutableMapping):
    """The staged columns as dense tensors: a packed column decodes the
    first time it is read and is kept for the rest of the query, so a
    column that only the kernels read (as words) is never decoded. Writes
    replace the staged entry."""

    def __init__(self, staged: Dict):
        self.staged = dict(staged)
        self._dense: Dict = {}

    def __getitem__(self, name):
        if name in self._dense:
            return self._dense[name]
        v = self.staged[name]
        if isinstance(v, packed_mod.PackedColumn):
            v = self._dense[name] = packed_mod.unpack_device(v)
        return v

    def __setitem__(self, name, value):
        self.staged[name] = value
        self._dense.pop(name, None)

    def __delitem__(self, name):
        del self.staged[name]
        self._dense.pop(name, None)

    def __contains__(self, name):
        return name in self.staged

    def __iter__(self):
        return iter(self.staged)

    def __len__(self):
        return len(self.staged)

    def decoded(self) -> Tuple[str, ...]:
        """Names decoded so far, in order."""
        return tuple(self._dense)


def column_dtypes(arrays) -> Dict[str, str]:
    """{name: decoded dtype name} of a dict or DecodedView, decoding
    nothing."""
    items = arrays.staged.items() if isinstance(arrays, DecodedView) \
        else arrays.items()
    return {c: dtype_name(v) for c, v in items}


def split_resident(arrays: Dict) -> Tuple[Dict, DecodedView]:
    """(packed columns for the kernels' word inputs, a DecodedView of every
    column)."""
    packed_cols = {k: v for k, v in arrays.items()
                   if isinstance(v, packed_mod.PackedColumn)}
    return packed_cols, DecodedView(arrays)


# ---------------------------------------------------------------------------
# Code-domain counters
# ---------------------------------------------------------------------------

class CodeDomainStats:
    """hits = segment executions served in run space; rows = the rows those
    executions covered."""

    def __init__(self):
        self._lock = threading.Lock()
        self.hits = 0
        self.rows = 0

    def record(self, rows: int) -> None:
        with self._lock:
            self.hits += 1
            self.rows += int(rows)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "rows": self.rows}


_CODE_STATS = CodeDomainStats()


def code_domain_stats() -> CodeDomainStats:
    return _CODE_STATS


class CodeDomainMonitor(Monitor):
    """Emits query/codeDomain/{hits,rows} per tick (deltas over the tick
    window, the FilterBitmapMonitor discipline)."""

    def __init__(self, source: Optional[CodeDomainStats] = None):
        self.source = source or _CODE_STATS
        self._last = self.source.snapshot()

    def do_monitor(self, emitter):
        s = self.source.snapshot()
        last, self._last = self._last, s
        emitter.metric("query/codeDomain/hits", s["hits"] - last["hits"])
        emitter.metric("query/codeDomain/rows", s["rows"] - last["rows"])
