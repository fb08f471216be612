"""Cascaded encodings: the staged rungs of the reference's `data/cascade.py`,
its staging planner and the one decode entry point of staged columns.

`plan_pair` is the reference's planner, a pure function of cached column
stats: the cascade rungs claim their columns first, and packing
(data/packed.py) covers the rest. A permuted layout (the sorted projection)
cascades nothing, since a permutation destroys runs and order. The rungs:
  * RLE (`RleColumn`): an int32 column of few runs (dimension-sorted rollup
    dims, near-constant metrics) stages as run values and exclusive run
    ends, both padded to a power of two; the decode is one searchsorted and
    one gather.
  * delta and FOR (`DeltaColumn`, `ForColumn`): `__time_offset` stages as
    width-packed gaps with a cumsum decode (time-ordered segments) or as
    base-biased range-packed words, when the gaps or the range fit 8 bits.
    The derived `__key`/`__bucket` columns of the grouped program take the
    FOR rung where their exact range packs (`for_encode_derived`).
  * LZ4 (`Lz4Column`): a float column whose raw bytes LZ4 compresses at
    least LZ4_MIN_RATIO times stays a block of literals and per-sequence
    token arrays on the device; the decode resolves match back-references
    by pointer doubling and is exact, padding included.

`Segment.device_block` stages every rung `plan_pair` plans; packed words
stage only where kernels B1/B2 read them (or a loaded segment holds them).
The decoders are torch ops on the column's device, bit for bit the
reference's, and work over leading batch axes, so a stack of encoded
columns (`stack_columns`, the batched and the sharded runs) decodes each
[K, R] slot the same way.

`split_resident` returns the packed columns for the kernels and a
`DecodedView` that decodes a column the first time a dense consumer reads
it, once per query, so a column only B1/B2 read is never decoded.
`decode_stats` counts the decodes that ran, by kind ("packed", "rle",
"delta", "lz4"; a host decode of a loaded column counts "host:<kind>").

`set_enabled(False)` turns every rung off, and with it code-domain
aggregation, the run-table filter leaves and the constant-LONG sum, as the
reference's switch does; `set_lz4_mode` picks the LZ4 rung's mode
("device", "host": decompressed on the host before staging, or "0": off).
Both are set by function; the port reads no environment variable.

The host run tables (`rle_encode`, `column_run_info`, cached on the
segment) feed code-domain aggregation (engine/rundomain.py) and the
run-table filter leaves (engine/filters.py, engine/megakernel.py);
`code_domain_stats` counts the segments served in run space.
`set_run_domain_enabled(False)` pins the row program.
"""
from __future__ import annotations

import collections
import copy
import threading
from collections.abc import MutableMapping
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from druid_tpu_torch.data import packed as packed_mod
from druid_tpu_torch.engine.contracts import CASCADE_MAX_RUNS, LANE
from druid_tpu_torch.utils.emitter import Monitor

#: RLE is planned only when its run arrays are at least this many times
#: smaller than the packed or decoded column
RLE_MIN_WIN = 2
#: widest FOR or delta encoding of `__time_offset`
TIME_MAX_WIDTH = 8
#: code-domain aggregation needs at least this many rows per joint run on
#: average: below it the row program is already cheap
RUN_DOMAIN_MIN_ROWS_PER_RUN = 16
#: LZ4 is planned only at this compression of the column's raw bytes
LZ4_MIN_RATIO = 2.0

#: process defaults, the reference's: the rungs on, LZ4 decoded on the card
_ENABLED = True
_LZ4_MODE = "device"
_RUN_DOMAIN = True
_STATE_LOCK = threading.Lock()


def set_enabled(on: bool) -> bool:
    """Turn the cascade rungs (and code-domain work) on or off for the
    process; returns the previous value."""
    global _ENABLED
    with _STATE_LOCK:
        prev = _ENABLED
        _ENABLED = bool(on)
        return prev


def enabled() -> bool:
    return _ENABLED


def set_lz4_mode(mode: str) -> str:
    """"device" (decode on the card), "host" (decompress on the host and
    stage decoded, the comparison mode) or "0" (the rung off); returns the
    previous mode."""
    global _LZ4_MODE
    with _STATE_LOCK:
        prev = _LZ4_MODE
        _LZ4_MODE = str(mode)
        return prev


def lz4_mode() -> str:
    return _LZ4_MODE


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
    """Count one decode of a column of `kind`."""
    with _DECODES_LOCK:
        _DECODES[kind] += n


def decode_stats() -> Dict[str, int]:
    with _DECODES_LOCK:
        return dict(_DECODES)


def reset_decode_stats() -> None:
    with _DECODES_LOCK:
        _DECODES.clear()


# ---------------------------------------------------------------------------
# Gathers along the last axis (int32 indices, leading batch axes allowed)
# ---------------------------------------------------------------------------

def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src[..., idx] along the last axis, slot by slot over the leading
    axes (shared by src and idx). `index_select` takes int32 indices, so
    no int64 copy of a byte-sized index array is made."""
    if src.dim() == 1:
        return src.index_select(0, idx.reshape(-1)).reshape(idx.shape)
    n = src.shape[-1]
    slots = idx[..., :1].numel()
    dt = torch.int64 if src.numel() >= 2**31 else idx.dtype
    off = torch.arange(slots, dtype=dt, device=idx.device) * n
    flat = (idx.reshape(slots, -1).to(dt) + off[:, None]).reshape(-1)
    return src.reshape(-1).index_select(0, flat).reshape(idx.shape)


def _lead_scalar(t: torch.Tensor, lead) -> torch.Tensor:
    """A per-column scalar (staged as [] or [1], stacked as [K] or [K, 1])
    shaped to broadcast over the rows: lead + (1,)."""
    return t.reshape(tuple(lead) + (1,))


# ---------------------------------------------------------------------------
# RleColumn
# ---------------------------------------------------------------------------

class RleColumn:
    """Run-length-encoded int column: run values and exclusive run ends
    (ends[j] is one past run j's last row; the last real end is the row
    count), both int32 and padded to a power of two, pad entries repeating
    the last end so the searchsorted decode stays monotone. Rows past
    `n_rows` (a device scalar) decode to 0, the staging fill.
    `padded_rows` is the decoded length of one column."""

    cascade_kind = "rle"
    __slots__ = ("values", "ends", "n_rows", "padded_rows", "dtype_str")
    fields = ("values", "ends", "n_rows")

    def __init__(self, values, ends, n_rows, padded_rows: int,
                 dtype_str: str = "int32"):
        self.values = values
        self.ends = ends
        self.n_rows = n_rows
        self.padded_rows = int(padded_rows)
        self.dtype_str = dtype_str

    def static(self) -> Tuple:
        return (self.padded_rows, self.dtype_str,
                tuple(self.values.shape[-1:]))

    @property
    def nbytes(self) -> int:
        return int(sum(getattr(self, f).nbytes for f in self.fields))

    @property
    def logical_nbytes(self) -> int:
        return int(self.padded_rows * np.dtype(self.dtype_str).itemsize)

    def __repr__(self):
        return (f"RleColumn(runs={self.values.shape[-1]}, "
                f"rows={self.padded_rows}, {self.dtype_str})")


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


def rle_decode_device(rc: RleColumn) -> torch.Tensor:
    """The padded decoded column on the run tables' device: a row finds its
    run among the exclusive ends and takes its value; padding rows read 0."""
    record_decode("rle")
    ends = rc.ends
    lead = ends.shape[:-1]
    iota = torch.arange(rc.padded_rows, dtype=torch.int32,
                        device=ends.device)
    q = iota.expand(tuple(lead) + (rc.padded_rows,)).contiguous() \
        if lead else iota
    idx = torch.searchsorted(ends, q, right=True, out_int32=True)
    idx = idx.clamp_(0, ends.shape[-1] - 1)
    v = _take(rc.values, idx)
    v = torch.where(iota < _lead_scalar(rc.n_rows, lead), v,
                    torch.zeros((), dtype=v.dtype, device=v.device))
    dt = getattr(torch, rc.dtype_str)
    return v if v.dtype == dt else v.to(dt)


# ---------------------------------------------------------------------------
# ForColumn: base-biased range packing, a PackedColumn with a cascade kind
# ---------------------------------------------------------------------------

class ForColumn(packed_mod.PackedColumn):
    """The frame-of-reference rung: PackedColumn's words, layout and
    in-kernel unpack, planned by the cascade for the columns
    `packed.plan_column` never claims (`__time_offset`, the derived
    `__key`/`__bucket`) and counted in the pool's cascade bytes."""

    cascade_kind = "for"


# ---------------------------------------------------------------------------
# DeltaColumn
# ---------------------------------------------------------------------------

class DeltaColumn:
    """Width-packed non-negative gaps between consecutive rows and the first
    value as a device scalar; decode = first + cumsum(gaps). For columns
    that never decrease (a time-ordered `__time_offset`); padding rows
    repeat the last value, which `__valid` masks."""

    cascade_kind = "delta"
    __slots__ = ("words", "first", "width", "rows", "dtype_str")
    fields = ("words", "first")

    def __init__(self, words, first, width: int, rows: int,
                 dtype_str: str = "int32"):
        self.words = words
        self.first = first
        self.width = int(width)
        self.rows = int(rows)
        self.dtype_str = dtype_str

    @property
    def vpw(self) -> int:
        return packed_mod.PACK_WORD_BITS // self.width

    def static(self) -> Tuple:
        return (self.width, self.rows, self.dtype_str)

    @property
    def nbytes(self) -> int:
        return int(self.words.nbytes + self.first.nbytes)

    @property
    def logical_nbytes(self) -> int:
        return int(self.rows * np.dtype(self.dtype_str).itemsize)

    def __repr__(self):
        return f"DeltaColumn(w{self.width}, rows={self.rows})"


def delta_encode(padded: torch.Tensor, n_rows: int,
                 width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(packed gap words, first value) of a padded non-decreasing column,
    on its device. The first gap and every padding row's gap are 0, so
    padding rows decode to the last real value."""
    v = padded.to(torch.int64)
    d = torch.zeros_like(v)
    d[1:] = v[1:] - v[:-1]
    d[n_rows:] = 0
    if d.shape[0] and (int(d.min()) < 0 or int(d.max()) >= (1 << width)):
        raise ValueError("delta rung planned on stale stats: a gap is "
                         f"outside [0, 2^{width})")
    return (packed_mod.pack_device(d, width, 0),
            padded[:1].to(torch.int32).clone())


def delta_decode_device(dc: DeltaColumn) -> torch.Tensor:
    """The exact inverse of delta_encode: an int32 cumsum (the prefixes are
    value - first, which fit int32 where the values do)."""
    record_decode("delta")
    words = dc.words
    lead = tuple(words.shape[:-1])
    w2 = words.reshape(lead + (-1, LANE))
    sh = torch.arange(dc.vpw, dtype=torch.int32,
                      device=words.device)[:, None] * dc.width
    d = ((w2.unsqueeze(-2) >> sh) & ((1 << dc.width) - 1)) \
        .reshape(lead + (dc.rows,))
    v = torch.cumsum(d, dim=-1, dtype=torch.int32) \
        + _lead_scalar(dc.first, lead)
    dt = getattr(torch, dc.dtype_str)
    return v if v.dtype == dt else v.to(dt)


# ---------------------------------------------------------------------------
# Lz4Column
# ---------------------------------------------------------------------------

class Lz4Column:
    """An LZ4-block-compressed float column on the device: the literal
    bytes and one (literal length, match length, offset) per sequence,
    each padded to a power of two with zeros. The decode rebuilds the raw
    bytes exactly, reads them as the column's dtype and pads with zeros to
    `padded_rows`, as dense staging pads."""

    cascade_kind = "lz4"
    __slots__ = ("literals", "lit_lens", "match_lens", "offsets",
                 "n_values", "padded_rows", "dtype_str")
    fields = ("literals", "lit_lens", "match_lens", "offsets")

    def __init__(self, literals, lit_lens, match_lens, offsets,
                 n_values: int, padded_rows: int, dtype_str: str):
        self.literals = literals
        self.lit_lens = lit_lens
        self.match_lens = match_lens
        self.offsets = offsets
        self.n_values = int(n_values)
        self.padded_rows = int(padded_rows)
        self.dtype_str = dtype_str

    @property
    def out_bytes(self) -> int:
        return self.n_values * np.dtype(self.dtype_str).itemsize

    def static(self) -> Tuple:
        return (self.n_values, self.padded_rows, self.dtype_str,
                tuple(self.literals.shape[-1:]),
                tuple(self.lit_lens.shape[-1:]))

    @property
    def nbytes(self) -> int:
        return int(sum(getattr(self, f).nbytes for f in self.fields))

    @property
    def logical_nbytes(self) -> int:
        return int(self.padded_rows * np.dtype(self.dtype_str).itemsize)

    def __repr__(self):
        return (f"Lz4Column({self.dtype_str}[{self.n_values}], "
                f"{self.nbytes}B compressed)")


def _lz4_bytes(literals: torch.Tensor, ll: torch.Tensor, ml: torch.Tensor,
               offsets: torch.Tensor, nb: int) -> torch.Tensor:
    """One block's nb decoded bytes (uint8) from its token arrays. Byte i
    lies in the sequence whose output range holds it; a literal byte points
    at itself, a match byte at i - offset, and ceil(log2(nb)) rounds of
    ptr = ptr[ptr] carry every match chain (overlapping copies included)
    to the literal it ends at."""
    dev = ll.device
    tok_total = ll + ml
    tok_end = torch.cumsum(tok_total, 0, dtype=torch.int32)
    out_start = tok_end - tok_total
    lit_start = torch.cumsum(ll, 0, dtype=torch.int32) - ll
    i = torch.arange(nb, dtype=torch.int32, device=dev)
    t = torch.searchsorted(tok_end, i, right=True, out_int32=True)
    t = t.clamp_(0, ll.shape[0] - 1)
    rel = i - out_start.index_select(0, t)
    is_lit = rel < ll.index_select(0, t)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    litpos = torch.where(is_lit, lit_start.index_select(0, t) + rel, zero)
    ptr = torch.where(is_lit, i, i - offsets.index_select(0, t))
    del t, rel, is_lit
    ptr = ptr.clamp_(0, nb - 1)
    for _ in range(max(int(nb - 1).bit_length(), 1)):
        ptr = ptr.index_select(0, ptr)
    src = litpos.index_select(0, ptr).clamp_(0, literals.shape[0] - 1)
    return literals.index_select(0, src)


def lz4_decode_device(col: Lz4Column) -> torch.Tensor:
    """The padded decoded column on the token arrays' device, bit for bit
    the reference's: the rebuilt little-endian bytes read as the column's
    dtype, zeros on padding rows."""
    record_decode("lz4")
    lead = tuple(col.lit_lens.shape[:-1])
    dt = getattr(torch, col.dtype_str)
    parts = []
    flat = [getattr(col, f).reshape((-1,) + tuple(getattr(col, f)
                                                   .shape[-1:]))
            for f in Lz4Column.fields]
    for k in range(flat[0].shape[0]):
        raw = _lz4_bytes(flat[0][k], flat[1][k], flat[2][k], flat[3][k],
                         col.out_bytes)
        v = raw.view(dt)
        out = torch.zeros(col.padded_rows, dtype=dt, device=v.device)
        out[: v.shape[0]] = v
        parts.append(out)
    if not lead:
        return parts[0]
    return torch.stack(parts).reshape(lead + (col.padded_rows,))


# ---------------------------------------------------------------------------
# Cached column stats and encodings (host, per segment)
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


def _lz4_stat(segment, name: str) -> Tuple[int, int, int]:
    """Cached (raw bytes, compressed bytes, padded token count) of a float
    column; compressed 0 marks a block that does not round-trip (the rung
    is then off for the column). The token count, which only a column the
    ratio admits needs, is 0 where the ratio fails."""
    def _compute():
        from druid_tpu_torch.native import lz4block
        raw = np.ascontiguousarray(segment.metrics[name].values).tobytes()
        try:
            comp = lz4block.compress(raw)
            if lz4block.decompress(comp, len(raw)) != raw:
                return (len(raw), 0, 0)
            if len(comp) * LZ4_MIN_RATIO > len(raw):
                return (len(raw), len(comp), 0)
            _, ll, _, _ = lz4block.tokenize(comp)
        except (ValueError, IndexError):
            return (len(raw), 0, 0)
        return (len(raw), len(comp), pad_pow2(ll.shape[0]))
    return segment.aux_cached(("cascade_lz4stat", name), _compute)


def lz4_tokens(block: bytes, n_values: int) -> Tuple:
    """(literals, lit_lens, match_lens, offsets, n_values) of an LZ4 block,
    each array padded to a power of two with zeros: what an Lz4Column
    stages."""
    from druid_tpu_torch.native import lz4block
    lits, ll, ml, off = lz4block.tokenize(block)
    tp = pad_pow2(ll.shape[0])
    lp = pad_pow2(max(lits.shape[0], 1))

    def padto(a, n, dt):
        out = np.zeros(n, dtype=dt)
        out[: a.shape[0]] = a
        return out
    return (padto(lits, lp, np.uint8), padto(ll, tp, np.int32),
            padto(ml, tp, np.int32), padto(off, tp, np.int32),
            int(n_values))


def _lz4_encoded(segment, name: str) -> Tuple:
    """Cached token arrays of a planned LZ4 column (`lz4_tokens`)."""
    def _compute():
        from druid_tpu_torch.native import lz4block
        vals = np.ascontiguousarray(segment.metrics[name].values)
        return lz4_tokens(lz4block.compress(vals.tobytes()),
                          vals.shape[0])
    return segment.aux_cached(("cascade_lz4enc", name), _compute)


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
    if lz4_mode() not in ("device", "host"):
        return None
    raw, comp, tpad = _lz4_stat(segment, name)
    if not comp or comp * LZ4_MIN_RATIO > raw:
        return None
    if tpad > CASCADE_MAX_RUNS:
        return None
    if lz4_mode() == "host":
        return ("lz4host",)
    lits, ll, _, _, nv = _lz4_encoded(segment, name)
    # the value count is a decode shape: it joins the descriptor
    return ("lz4", int(lits.shape[0]), int(ll.shape[0]), int(nv))


def plan_column(segment, name: str) -> Optional[Tuple]:
    """Cascade descriptor tail for one column, or None. Reads column
    metadata and cached stats only, so a lazily loaded column plans
    without decoding."""
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
    `columns` plus `__time_offset`, sorted by name; () when the rungs are
    off or the layout is permuted (a permutation destroys runs and order).
    This tuple is the cascade descriptor: it joins the staging pool key,
    the structure signature and the batching digest."""
    if not _ENABLED or permuted:
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


def descriptor_to_json(entries: Tuple) -> list:
    """JSON form of a cascade or pack descriptor tuple."""
    return [list(e) for e in entries]


def descriptor_from_json(obj) -> Tuple:
    """The exact inverse of descriptor_to_json (hashable tuples again)."""
    return tuple(tuple(e) for e in obj)


# ---------------------------------------------------------------------------
# Staging-time encoding (Segment._stage_block, the mesh's stack)
# ---------------------------------------------------------------------------

def encode_column(segment, name: str, entry: Tuple, padded, put):
    """One planned column, encoded for staging. `padded` is the padded
    column dense staging would ship, a host array or already a tensor on
    the device (for "rle" and "lz4" only its shape and dtype are read:
    their tables are cached on the segment); `put` moves a host array to
    the device. FOR and delta words are packed on the device
    (`packed.pack_device`), the host's `pack_padded` bit for bit."""
    kind = entry[1]
    rows = int(padded.shape[0])
    dtype_str = str(padded.dtype).replace("torch.", "") \
        if torch.is_tensor(padded) else str(np.dtype(padded.dtype))
    if kind == "rle":
        values, ends = _rle_encoded(segment, name)
        rpad = entry[2]

        def padto(a, fill):
            out = np.full(rpad, fill, dtype=np.int32)
            out[: a.shape[0]] = a
            return out
        n_rows = int(ends[-1]) if ends.shape[0] else 0
        return RleColumn(put(padto(values, 0)), put(padto(ends, n_rows)),
                         put(np.asarray([n_rows], dtype=np.int32)), rows,
                         dtype_str)
    if kind in ("for", "delta"):
        dense = padded if torch.is_tensor(padded) else put(padded)
        if kind == "for":
            w, base = entry[2], entry[3]
            return ForColumn(packed_mod.pack_device(dense, w, base), w,
                             base, rows, dtype_str)
        words, first = delta_encode(dense, segment.n_rows, entry[2])
        return DeltaColumn(words, first, entry[2], rows, dtype_str)
    if kind == "lz4":
        lits, ll, ml, off, nv = _lz4_encoded(segment, name)
        return Lz4Column(put(lits), put(ll), put(ml), put(off), nv, rows,
                         dtype_str)
    if kind == "lz4host":
        # the comparison mode: through the codec on the host, then staged
        # decoded (the bytes the device decode saves)
        from druid_tpu_torch.native import lz4block
        vals = np.ascontiguousarray(segment.metrics[name].values)
        raw = lz4block.decompress(lz4block.compress(vals.tobytes()),
                                  vals.nbytes)
        out = np.zeros(rows, dtype=vals.dtype)
        out[: vals.shape[0]] = np.frombuffer(raw, dtype=vals.dtype)
        return put(out)
    raise ValueError(f"unknown cascade kind {kind!r}")


def for_encode_derived(lo: int, hi: int) -> Optional[Tuple[int, int]]:
    """(width, base) where a derived int32 column with values in [lo, hi]
    (the `__key`/`__bucket` columns, whose range the plan knows exactly)
    range-packs, else None."""
    if not _ENABLED:
        return None
    base = int(lo)
    w = packed_mod.width_for(int(hi), base)
    return (w, base) if w else None


# ---------------------------------------------------------------------------
# The decode entry point
# ---------------------------------------------------------------------------

_ENCODED = (RleColumn, DeltaColumn, Lz4Column, packed_mod.PackedColumn)


def is_encoded(v) -> bool:
    return isinstance(v, _ENCODED)


def decode(v):
    """A staged entry as a dense tensor (decoding an encoded column on its
    device; a tensor comes back as it is)."""
    if isinstance(v, RleColumn):
        return rle_decode_device(v)
    if isinstance(v, DeltaColumn):
        return delta_decode_device(v)
    if isinstance(v, Lz4Column):
        return lz4_decode_device(v)
    if isinstance(v, packed_mod.PackedColumn):
        return packed_mod.unpack_device(v)
    return v


def dtype_name(v) -> str:
    """The decoded dtype of a staged entry, without decoding it."""
    if is_encoded(v):
        return v.dtype_str
    return str(v.dtype).replace("torch.", "")


class DecodedView(MutableMapping):
    """The staged columns as dense tensors: an encoded column decodes the
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
        if is_encoded(v):
            v = self._dense[name] = decode(v)
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
    """(packed columns for the kernels' word inputs, ForColumn included, a
    DecodedView of every column)."""
    packed_cols = {k: v for k, v in arrays.items()
                   if isinstance(v, packed_mod.PackedColumn)}
    return packed_cols, DecodedView(arrays)


# ---------------------------------------------------------------------------
# Stacks of encoded columns (the batched and the sharded runs)
# ---------------------------------------------------------------------------

def _fields(v) -> Tuple[str, ...]:
    return getattr(v, "fields", ("words",))


def _static(v) -> Tuple:
    if isinstance(v, packed_mod.PackedColumn):
        return v.descriptor()
    return v.static()


def _replace(v, **fields):
    out = copy.copy(v)
    for f, t in fields.items():
        setattr(out, f, t)
    return out


def stack_columns(cols: Sequence) -> object:
    """K staged entries of one column stacked on a leading axis: tensors
    with torch.stack, encoded columns of one class and one static
    descriptor field by field (per-column row counts and first values as
    [K, 1] fields), so each [K, R] slot decodes at the top of the run.
    Where the slots differ in representation, the encoded ones decode and
    the dense slots stack."""
    first = cols[0]
    if is_encoded(first) and all(
            type(c) is type(first) and _static(c) == _static(first)
            for c in cols[1:]):
        return _replace(first, **{
            f: torch.stack([getattr(c, f).reshape(
                getattr(first, f).shape) for c in cols])
            for f in _fields(first)})
    return torch.stack([decode(c) for c in cols])


def zeros_like_column(v, device=None) -> object:
    """An all-zero stand-in of a staged entry (a padding slot of a stack)
    on `device` (v's by default): RLE zeros hold no row, packed and delta
    zeros decode to their base, LZ4 zeros to 0; `__valid` masks every row
    of such a slot."""
    if not is_encoded(v):
        return torch.zeros_like(v, device=device)
    return _replace(v, **{f: torch.zeros_like(getattr(v, f), device=device)
                          for f in _fields(v)})


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
