"""IncrementalIndex: the in-memory mutable ingestion index with rollup.

The port's own copy of the reference package's `ingest/incremental.py`,
host numpy as there, so that the ids, dictionaries and row order of a
snapshot come out bit for bit the reference's (the rollup never runs on
the card; snapshots are ordinary Segments that the engines stage).

Capability parity with the reference's IncrementalIndex
(processing/.../segment/incremental/IncrementalIndex.java:102,601 — facts map
keyed (truncated time, dims) with per-row Aggregator.aggregate calls;
OnheapIncrementalIndex). Inverted here: there is no per-row facts map.
Rows buffer into columnar batches; a vectorized compaction pass
(factorize keys → np.unique → ufunc.at scatter aggregation) rolls the whole
batch up at once, then merges it with the accumulated grouped state.

Dictionaries grow in arrival order during ingest (unsorted, exactly like the
reference's ingest-time dims) and are sorted + remapped only at snapshot
(the job IndexMergerV9 does at persist).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from druid_tpu_torch.data.dictionary import Dictionary, NULL
from druid_tpu_torch.data.segment import (ComplexColumn, NumericColumn,
                                          Segment, SegmentId, StringDimColumn,
                                          ValueType)
from druid_tpu_torch.engine import hll as hll_mod
from druid_tpu_torch.ingest.input import RowBatch
from druid_tpu_torch.query import aggregators as A
from druid_tpu_torch.utils.granularity import Granularity
from druid_tpu_torch.utils.intervals import Interval

_KEY_BITS_LIMIT = 62


def time_sorted_segment(segment_id: SegmentId, time_ms: np.ndarray,
                        dims: Dict[str, StringDimColumn],
                        metrics: Dict[str, object]) -> Segment:
    """A Segment over the rows re-sorted by time (a stable argsort), which
    the reference's `Segment(..., sorted_by_time=False)` does in its
    constructor; the port's Segment keeps the order it is given."""
    time_ms = np.asarray(time_ms, dtype=np.int64)
    if len(time_ms):
        order = np.argsort(time_ms, kind="stable")
        time_ms = time_ms[order]
        for d in dims.values():
            d.ids = d.ids[order]
        for m in metrics.values():
            m.values = m.values[order]
    return Segment(segment_id, time_ms, dims, metrics)


def fuse_group_keys(t: np.ndarray, ids: Dict[str, np.ndarray],
                    cards: Dict[str, int],
                    dim_order: Sequence[str]) -> np.ndarray:
    """Fuse (time, dim ids...) into one int64 key per row, compacting via
    np.unique whenever the packed width would overflow 62 bits. Shared by
    IncrementalIndex rollup and segment merge (single source of truth for
    the key-packing semantics)."""
    _, key = np.unique(t, return_inverse=True)
    key = key.astype(np.int64)
    bits = max(int(key.max(initial=0)).bit_length(), 1)
    for d in dim_order:
        card = max(cards[d], 1)
        cbits = (card - 1).bit_length() or 1
        if bits + cbits > _KEY_BITS_LIMIT:
            _, key = np.unique(key, return_inverse=True)
            key = key.astype(np.int64)
            bits = max(int(key.max(initial=0)).bit_length(), 1)
        if cbits > _KEY_BITS_LIMIT:
            # a single dimension wider than the key space: compact its ids
            _, did = np.unique(ids[d], return_inverse=True)
            did = did.astype(np.int64)
            card = max(int(did.max(initial=0)) + 1, 1)
            cbits = (card - 1).bit_length() or 1
            key = key * card + did
        else:
            key = key * card + ids[d]
        bits += cbits
    return key


class GrowingDictionary:
    """Arrival-order value -> id map (unsorted during ingest)."""

    __slots__ = ("values", "index")

    def __init__(self):
        self.values: List[str] = []
        self.index: Dict[str, int] = {}

    def encode_list(self, vals: Sequence) -> np.ndarray:
        index = self.index
        values = self.values
        out = np.empty(len(vals), dtype=np.int32)
        for i, v in enumerate(vals):
            s = NULL if v is None else str(v)
            j = index.get(s)
            if j is None:
                j = len(values)
                index[s] = j
                values.append(s)
            out[i] = j
        return out

    @property
    def cardinality(self) -> int:
        return len(self.values)


class _MetricState:
    """Per-aggregator grouped state arrays + vectorized scatter update."""

    def __init__(self, spec: A.AggregatorSpec):
        self.spec = spec
        self.name = spec.name

    # hooks -------------------------------------------------------------
    def from_batch(self, gids: np.ndarray, n_groups: int,
                   batch_cols: Dict[str, list], t_raw: np.ndarray) -> dict:
        raise NotImplementedError

    def merge(self, a: dict, b: dict, map_a: np.ndarray, map_b: np.ndarray,
              n_groups: int) -> dict:
        raise NotImplementedError

    def final_column(self, state: dict):
        raise NotImplementedError

    def extra_columns(self, state: dict) -> Dict[str, NumericColumn]:
        """Auxiliary persisted columns (e.g. first/last pair times)."""
        return {}


def _numeric_field(batch_cols, field, t_raw, n, dtype):
    if field == "__time":
        return t_raw.astype(dtype)
    vals = batch_cols.get(field)
    if vals is None:
        return np.zeros(n, dtype=dtype)
    if isinstance(vals, np.ndarray) and vals.dtype != object:
        return vals.astype(dtype)  # merge path: already-numeric columns
    out = np.zeros(n, dtype=dtype)
    for i, v in enumerate(vals):
        if v is None:
            continue
        try:
            out[i] = v
        except (TypeError, ValueError):
            try:
                out[i] = float(v)
            except (TypeError, ValueError):
                pass
    return out


class _CountState(_MetricState):
    def from_batch(self, gids, n_groups, batch_cols, t_raw):
        out = np.zeros(n_groups, dtype=np.int64)
        np.add.at(out, gids, 1)
        return {"v": out}

    def merge(self, a, b, map_a, map_b, n_groups):
        out = np.zeros(n_groups, dtype=np.int64)
        np.add.at(out, map_a, a["v"])
        np.add.at(out, map_b, b["v"])
        return {"v": out}

    def final_column(self, state):
        return NumericColumn(state["v"], ValueType.LONG)


class _SumState(_MetricState):
    _DT = {ValueType.LONG: np.int64, ValueType.FLOAT: np.float32,
           ValueType.DOUBLE: np.float64}

    def __init__(self, spec, vtype: ValueType):
        super().__init__(spec)
        self.vtype = vtype
        self.dtype = self._DT[vtype]

    def from_batch(self, gids, n_groups, batch_cols, t_raw):
        v = _numeric_field(batch_cols, self.spec.field, t_raw, len(gids),
                           self.dtype)
        out = np.zeros(n_groups, dtype=self.dtype)
        np.add.at(out, gids, v)
        return {"v": out}

    def merge(self, a, b, map_a, map_b, n_groups):
        out = np.zeros(n_groups, dtype=self.dtype)
        np.add.at(out, map_a, a["v"])
        np.add.at(out, map_b, b["v"])
        return {"v": out}

    def final_column(self, state):
        return NumericColumn(state["v"], self.vtype)


class _MinMaxState(_MetricState):
    def __init__(self, spec, vtype: ValueType, is_max: bool):
        super().__init__(spec)
        self.vtype = vtype
        self.is_max = is_max
        self.dtype = _SumState._DT[vtype]
        if vtype == ValueType.LONG:
            self.ident = np.int64(-(2**63)) if is_max else np.int64(2**63 - 1)
        else:
            self.ident = self.dtype(-np.inf) if is_max else self.dtype(np.inf)

    def from_batch(self, gids, n_groups, batch_cols, t_raw):
        v = _numeric_field(batch_cols, self.spec.field, t_raw, len(gids),
                           self.dtype)
        out = np.full(n_groups, self.ident, dtype=self.dtype)
        (np.maximum if self.is_max else np.minimum).at(out, gids, v)
        return {"v": out}

    def merge(self, a, b, map_a, map_b, n_groups):
        out = np.full(n_groups, self.ident, dtype=self.dtype)
        op = np.maximum if self.is_max else np.minimum
        op.at(out, map_a, a["v"])
        op.at(out, map_b, b["v"])
        return {"v": out}

    def final_column(self, state):
        return NumericColumn(state["v"], self.vtype)


class _FirstLastState(_MetricState):
    """State = (event time, value) pairs per group. The event time persists
    as a hidden `__ft_<name>` LONG column so re-merges and queries over
    rolled-up segments order by TRUE event time, not the truncated group
    time (the reference stores SerializablePair(long, value) for this)."""

    def __init__(self, spec, vtype: ValueType, is_last: bool):
        super().__init__(spec)
        self.vtype = vtype
        self.is_last = is_last
        self.dtype = _SumState._DT[vtype]

    def from_batch(self, gids, n_groups, batch_cols, t_raw):
        v = _numeric_field(batch_cols, self.spec.field, t_raw, len(gids),
                           self.dtype)
        t_col = batch_cols.get(f"__ft_{self.spec.field}")
        if t_col is not None:  # merge path: restored pair times
            t_used = np.asarray(t_col, dtype=np.int64)
        else:
            t_used = t_raw
        # order rows so the winner (first by min time / last by max time)
        # lands LAST in the scatter, then plain assignment keeps it
        order = np.argsort(t_used, kind="stable")
        if not self.is_last:
            order = order[::-1]
        t_out = np.full(n_groups, -(2**63) if self.is_last else 2**63 - 1,
                        dtype=np.int64)
        v_out = np.zeros(n_groups, dtype=self.dtype)
        t_out[gids[order]] = t_used[order]
        v_out[gids[order]] = v[order]
        return {"t": t_out, "v": v_out}

    def merge(self, a, b, map_a, map_b, n_groups):
        better = (np.greater if self.is_last else np.less)
        t_out = np.full(n_groups, -(2**63) if self.is_last else 2**63 - 1,
                        dtype=np.int64)
        v_out = np.zeros(n_groups, dtype=self.dtype)
        for st, mp in ((a, map_a), (b, map_b)):
            take = better(st["t"], t_out[mp])
            idx = mp[take]
            t_out[idx] = st["t"][take]
            v_out[idx] = st["v"][take]
        return {"t": t_out, "v": v_out}

    def final_column(self, state):
        return NumericColumn(state["v"], self.vtype)

    def extra_columns(self, state):
        return {f"__ft_{self.name}": NumericColumn(state["t"],
                                                   ValueType.LONG)}


class _HllState(_MetricState):
    """hyperUnique ingest metric: per-group HLL register arrays
    (reference: HyperUniquesAggregatorFactory at ingest)."""

    def __init__(self, spec, log2m: int):
        super().__init__(spec)
        self.log2m = log2m
        self.m = 1 << log2m

    def from_batch(self, gids, n_groups, batch_cols, t_raw):
        vals = batch_cols.get(self.spec.field)
        regs = np.zeros((n_groups, self.m), dtype=np.int8)
        if vals is None or len(vals) == 0:
            return {"v": regs}
        first = vals[0]
        if isinstance(first, np.ndarray) and first.ndim == 1 \
                and first.shape[0] == self.m:
            # merge path: rows are already register arrays (complex column)
            arr = (vals if isinstance(vals, np.ndarray)
                   else np.stack(list(vals))).astype(np.int8)
            np.maximum.at(regs, gids, arr)
        else:
            h = hll_mod.hash_strings(["" if v is None else str(v)
                                      for v in vals])
            reg, rho = hll_mod.hash_to_register(h, self.log2m)
            np.maximum.at(regs, (gids, reg), rho.astype(np.int8))
        return {"v": regs}

    def merge(self, a, b, map_a, map_b, n_groups):
        out = np.zeros((n_groups, self.m), dtype=np.int8)
        np.maximum.at(out, map_a, a["v"])
        np.maximum.at(out, map_b, b["v"])
        return {"v": out}

    def final_column(self, state):
        return ComplexColumn(state["v"], "hyperUnique")


def make_metric_state(spec: A.AggregatorSpec) -> _MetricState:
    if isinstance(spec, A.CountAggregator):
        return _CountState(spec)
    if isinstance(spec, A.LongSumAggregator):
        return _SumState(spec, ValueType.LONG)
    if isinstance(spec, A.DoubleSumAggregator):
        return _SumState(spec, ValueType.DOUBLE)
    if isinstance(spec, A.FloatSumAggregator):
        return _SumState(spec, ValueType.FLOAT)
    if isinstance(spec, A.LongMinAggregator):
        return _MinMaxState(spec, ValueType.LONG, False)
    if isinstance(spec, A.LongMaxAggregator):
        return _MinMaxState(spec, ValueType.LONG, True)
    if isinstance(spec, A.DoubleMinAggregator):
        return _MinMaxState(spec, ValueType.DOUBLE, False)
    if isinstance(spec, A.DoubleMaxAggregator):
        return _MinMaxState(spec, ValueType.DOUBLE, True)
    if isinstance(spec, A.FloatMinAggregator):
        return _MinMaxState(spec, ValueType.FLOAT, False)
    if isinstance(spec, A.FloatMaxAggregator):
        return _MinMaxState(spec, ValueType.FLOAT, True)
    if isinstance(spec, A.FirstAggregator):
        return _FirstLastState(spec, ValueType(spec.kind), False)
    if isinstance(spec, A.LastAggregator):
        return _FirstLastState(spec, ValueType(spec.kind), True)
    if isinstance(spec, A.HyperUniqueAggregator):
        return _HllState(spec, spec.log2m)
    raise ValueError(
        f"aggregator {type(spec).__name__} unsupported at ingest")


class IncrementalIndex:
    """Mutable rollup index; thread-safe add; snapshot to immutable Segment."""

    def __init__(self, datasource: str, interval: Interval,
                 metric_specs: Sequence[A.AggregatorSpec],
                 dimensions: Optional[Sequence[str]] = None,
                 query_granularity: str | Granularity = "none",
                 rollup: bool = True,
                 max_rows_in_memory: int = 1_000_000,
                 flush_rows: int = 65536):
        self.datasource = datasource
        self.interval = interval
        self.metric_states = [make_metric_state(s) for s in metric_specs]
        self.metric_specs = list(metric_specs)
        self.explicit_dims = list(dimensions) if dimensions else None
        self.query_granularity = (query_granularity
                                  if isinstance(query_granularity, Granularity)
                                  else Granularity.of(query_granularity))
        self.rollup = rollup
        self.max_rows_in_memory = max_rows_in_memory
        self.flush_rows = flush_rows

        self._dicts: Dict[str, GrowingDictionary] = {}
        self._dim_order: List[str] = list(self.explicit_dims or [])
        for d in self._dim_order:
            self._dicts[d] = GrowingDictionary()
        # accumulated grouped state
        self._time = np.zeros(0, dtype=np.int64)
        self._dim_ids: Dict[str, np.ndarray] = {
            d: np.zeros(0, dtype=np.int32) for d in self._dim_order}
        self._states: List[dict] = [
            {k: np.zeros((0,) + v.shape[1:], dtype=v.dtype)
             for k, v in s.from_batch(np.zeros(0, dtype=np.int64), 0, {},
                                      np.zeros(0, dtype=np.int64)).items()}
            for s in self.metric_states]
        # pending raw rows
        self._pending_t: List[int] = []
        self._pending_cols: Dict[str, list] = {}
        self._lock = threading.Lock()
        self._generation = 0
        self._snapshot_cache: Optional[Tuple[int, Segment]] = None
        self.rows_out_of_interval = 0

    # -- ingestion ------------------------------------------------------
    def add(self, row: dict, timestamp: Optional[int] = None):
        """Add one row: {'timestamp': ms | via arg, dims..., metrics...}."""
        raw_ts = row.get("timestamp") if timestamp is None else timestamp
        if raw_ts is None:
            raise ValueError(
                "row has no 'timestamp' key and no timestamp argument")
        ts = int(raw_ts)
        cols = {k: v for k, v in row.items() if k != "timestamp"}
        self.add_batch(RowBatch([ts], {k: [v] for k, v in cols.items()}))

    def add_batch(self, batch: RowBatch):
        if not len(batch):
            return
        with self._lock:
            keep: Optional[np.ndarray] = None
            ts = np.asarray(batch.timestamps, dtype=np.int64)
            inside = (ts >= self.interval.start) & (ts < self.interval.end)
            if not inside.all():
                self.rows_out_of_interval += int((~inside).sum())
                keep = inside
            n_before = len(self._pending_t)
            for i, t in enumerate(batch.timestamps):
                if keep is not None and not keep[i]:
                    continue
                self._pending_t.append(int(t))
            for name, vals in batch.columns.items():
                col = self._pending_cols.get(name)
                if col is None:
                    col = self._pending_cols[name] = [None] * n_before
                if keep is None:
                    col.extend(vals)
                else:
                    col.extend(v for v, k in zip(vals, keep) if k)
            n_after = len(self._pending_t)
            for name, col in self._pending_cols.items():
                if len(col) < n_after:
                    col.extend([None] * (n_after - len(col)))
            if n_after >= self.flush_rows:
                self._compact_locked()

    def _metric_names(self) -> set:
        return {s.name for s in self.metric_states} | {
            s.spec.field for s in self.metric_states
            if getattr(s.spec, "field", None)}

    def _compact_locked(self):
        n = len(self._pending_t)
        if n == 0:
            return
        t_raw = np.asarray(self._pending_t, dtype=np.int64)
        # queryGranularity ALL collapses every row's time to the interval
        # start (one time bucket per segment, like the reference's rollup)
        if self.query_granularity.is_all:
            t_trunc = np.full(n, self.interval.start, dtype=np.int64)
        else:
            t_trunc = self.query_granularity.bucket_start_array(t_raw)

        # dims = declared order, else discovery order (non-metric columns)
        metric_fields = self._metric_names()
        for name in self._pending_cols:
            if self.explicit_dims is None and name not in metric_fields \
                    and name not in self._dicts:
                gd = GrowingDictionary()
                # register null FIRST so pre-existing rows backfill with the
                # null id, not whatever value happens to be seen first
                null_id = int(gd.encode_list([None])[0])
                self._dicts[name] = gd
                self._dim_order.append(name)
                self._dim_ids[name] = np.full(len(self._time), null_id,
                                              dtype=np.int32)

        ids: Dict[str, np.ndarray] = {}
        for d in self._dim_order:
            vals = self._pending_cols.get(d)
            if vals is None:
                ids[d] = np.full(n, self._dicts[d].encode_list([None])[0],
                                 dtype=np.int32)
            else:
                ids[d] = self._dicts[d].encode_list(vals)

        if self.rollup:
            key = self._fuse_keys(t_trunc, ids)
            uniq_keys, first_idx, gids = np.unique(
                key, return_index=True, return_inverse=True)
            n_groups = len(uniq_keys)
            g_time = t_trunc[first_idx]
            g_ids = {d: ids[d][first_idx] for d in self._dim_order}
            g_states = [s.from_batch(gids, n_groups, self._pending_cols,
                                     t_raw) for s in self.metric_states]
        else:
            g_time = t_trunc
            g_ids = ids
            gids = np.arange(n, dtype=np.int64)
            g_states = [s.from_batch(gids, n, self._pending_cols, t_raw)
                        for s in self.metric_states]

        self._merge_accumulated(g_time, g_ids, g_states)
        self._pending_t = []
        self._pending_cols = {}
        self._generation += 1

    def _fuse_keys(self, t: np.ndarray, ids: Dict[str, np.ndarray]) -> np.ndarray:
        return fuse_group_keys(
            t, ids, {d: self._dicts[d].cardinality for d in self._dim_order},
            self._dim_order)

    def _merge_accumulated(self, g_time, g_ids, g_states):
        if len(self._time) == 0:
            self._time = g_time
            self._dim_ids = dict(g_ids)
            self._states = g_states
            return
        # align dims (new discovered dims get null id for old rows — null is
        # whatever id the dictionary gave "")
        a_n, b_n = len(self._time), len(g_time)
        cat_t = np.concatenate([self._time, g_time])
        cat_ids = {}
        for d in self._dim_order:
            a = self._dim_ids.get(d)
            if a is None:
                a = np.full(a_n, self._dicts[d].encode_list([None])[0],
                            dtype=np.int32)
            cat_ids[d] = np.concatenate([a, g_ids[d]])
        if not self.rollup:
            self._time = cat_t
            self._dim_ids = cat_ids
            self._states = [
                {k: np.concatenate([a[k], b[k]]) for k in a}
                for a, b in zip(self._states, g_states)]
            return
        key = self._fuse_keys(cat_t, cat_ids)
        uniq_keys, first_idx, all_gids = np.unique(
            key, return_index=True, return_inverse=True)
        n_groups = len(uniq_keys)
        map_a, map_b = all_gids[:a_n], all_gids[a_n:]
        self._time = cat_t[first_idx]
        self._dim_ids = {d: cat_ids[d][first_idx] for d in self._dim_order}
        self._states = [
            s.merge(a, b, map_a, map_b, n_groups)
            for s, a, b in zip(self.metric_states, self._states, g_states)]

    # -- introspection ---------------------------------------------------
    @property
    def n_rows(self) -> int:
        with self._lock:
            return len(self._time) + len(self._pending_t)

    def change_marker(self) -> Tuple[int, int]:
        """(generation, pending rows): lexicographically advances on every
        content change — compaction bumps the generation, appends grow the
        pending tail. Standing queries (engine/standing.py) compare markers
        across ticks so an unchanged live hydrant costs zero snapshots."""
        with self._lock:
            return (self._generation, len(self._pending_t))

    def can_append(self) -> bool:
        return self.n_rows < self.max_rows_in_memory

    # -- snapshot --------------------------------------------------------
    def to_segment(self, version: str = "v0", partition: int = 0) -> Segment:
        """Immutable queryable snapshot: sort dictionaries, remap ids, build
        a Segment (the reference queries the live index through
        IncrementalIndexStorageAdapter; here realtime queries see cheap
        immutable snapshots, cached per generation)."""
        with self._lock:
            return self._to_segment_locked(version, partition)

    def snapshot_with_marker(self, version: str = "v0",
                             partition: int = 0
                             ) -> Tuple[Segment, Tuple[int, int]]:
        """(snapshot, change marker) where the marker describes EXACTLY the
        snapshot's content — taken under one lock hold, post-compaction,
        so standing queries (engine/standing.py) can store a high-water
        mark that neither re-folds an unchanged snapshot (the compaction
        bumped the generation the caller saw pre-snapshot) nor misses
        rows appended concurrently with snapshotting."""
        with self._lock:
            seg = self._to_segment_locked(version, partition)
            return seg, (self._generation, 0)

    def _to_segment_locked(self, version: str, partition: int) -> Segment:
        self._compact_locked()
        gen = self._generation
        if self._snapshot_cache is not None \
                and self._snapshot_cache[0] == gen:
            return self._snapshot_cache[1]
        dims: Dict[str, StringDimColumn] = {}
        for d in self._dim_order:
            gd = self._dicts[d]
            sorted_dict = Dictionary(sorted(gd.index))
            remap = np.asarray(
                [sorted_dict.id_of(v) for v in gd.values],
                dtype=np.int32) if gd.values else np.zeros(0, np.int32)
            null_id = sorted_dict.id_of(NULL)
            raw = self._dim_ids[d]
            if null_id < 0:
                sorted_dict = Dictionary(sorted(set(gd.index) | {NULL}))
                remap = np.asarray(
                    [sorted_dict.id_of(v) for v in gd.values],
                    dtype=np.int32)
            dims[d] = StringDimColumn(
                remap[raw] if len(raw) else raw.copy(), sorted_dict)
        metrics: Dict[str, object] = {}
        for s, st in zip(self.metric_states, self._states):
            metrics[s.name] = s.final_column(st)
            metrics.update(s.extra_columns(st))
        seg = time_sorted_segment(
            SegmentId(self.datasource, self.interval, version, partition),
            self._time.copy(), dims, metrics)
        self._snapshot_cache = (gen, seg)
        return seg

    def persist(self, directory: str, version: str = "v0",
                partition: int = 0) -> Segment:
        # format V2: ingest pays the cascade encodings once here, load and
        # staging reuse them verbatim
        from druid_tpu_torch.storage.format_v2 import persist_segment_auto
        seg = self.to_segment(version, partition)
        persist_segment_auto(seg, directory)
        return seg
