"""Standing queries over streaming ingest: incremental folds on the device.

The port's own copy of the reference package's `engine/standing.py`. A
dashboard watching a live datasource would pay a full re-scan of every
sink on every refresh. A `StandingQuery` compiles an eligible aggregate
query ONCE against the live datasource and, on every tick, folds ONLY what
was appended since its last high-water mark per sink:

  * The incremental quantum is the HYDRANT. Persisted hydrants are
    immutable, so their per-group partial states are computed exactly once,
    ever, and cached; a tick pays device work only for hydrants sealed
    since the sink's high-water mark plus the (size-bounded) live hydrant
    when its change marker advanced. A from-scratch re-scan computes the
    SAME per-hydrant partials through the SAME engine and merges them in
    the SAME order.
  * All of a tick's folds across every sink go through ONE
    make_partials_by_segment call on the owner's device, so
    shape-compatible hydrants fuse into shared runs (engine/batching.py),
    and N structurally identical subscriptions (server/subscriptions.py)
    share one StandingQuery, so the whole dashboard fleet costs one
    program per tick.
  * Emission is watermark-driven: with a uniform granularity the standing
    query (context {"standingEmit": "bucket"}) emits when the event-time
    watermark seals a granularity bucket (or late data lands in a sealed
    one); the default ("change") emits on any fold. Every emission is a
    full consistent snapshot of the current world.
  * Publish cutover is exactly-once: when a sink publishes, the published
    segment's contribution replaces the sink's incremental partials in ONE
    locked swap — no emission can ever see a row twice or not at all
    across the persist/publish boundary.

The parity each snapshot holds against `rescan_rows()` (the re-scan of the
same world):
  * on the CPU, bit for bit, floats included, as in the reference;
  * on the card, counts, long sums and min/max bit for bit, and float sums
    within 1e-5 · Σ|v| per group: a live hydrant large enough to take the
    `mixed` strategy adds floats with atomics whose order does not repeat
    from run to run. That difference is never a reason to fold again: each
    hydrant folds exactly once.

The reference's live-hydrant folds hand the previous snapshot's megakernel
carry grids to the next one (`Segment.adopt_carries_from`). The port has
no carries: a refold's snapshot is a new Segment whose pool entries are
its own, and the previous snapshot's entries leave the pool when it is
collected (PyTorch's caching allocator reuses the freed grids).

The port reads no environment flag: `set_enabled(False)` (the reference's
DRUID_TPU_STANDING=0) restores the re-scan world, where ticks discard
cached partials and recompute everything from scratch, with identical
results.
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from druid_tpu_torch import device as device_mod
from druid_tpu_torch.engine import engines
from druid_tpu_torch.query.model import (GroupByQuery, Query, TimeseriesQuery,
                                         TopNQuery)
from druid_tpu_torch.utils.emitter import Monitor
from druid_tpu_torch.utils.intervals import condense

_ENABLED = True


def set_enabled(on: bool) -> bool:
    """Toggle incremental standing execution; returns the previous value.
    Disabled, every tick re-scans from scratch (the pre-standing world) —
    results are identical, only the incremental caching is off."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


def enabled() -> bool:
    return _ENABLED


class StandingIneligible(ValueError):
    """The query shape cannot compile to a standing program."""


#: refuse standing programs whose fixed bucket index space would be
#: enormous (an eternity interval at minute granularity); dashboards query
#: bounded windows, and the re-scan path still serves anything else
MAX_STANDING_BUCKETS = 1 << 16


def _bucket_count_bounded(granularity, iv) -> int:
    """Bucket count of `iv`, computed WITHOUT materializing bucket arrays
    (an eternity interval at minute granularity would otherwise try to
    allocate petabytes inside the eligibility check) and capped just past
    the standing limit — callers only need 'over or not'."""
    if granularity.is_uniform:
        p = granularity.period_ms
        first = granularity.bucket_start(iv.start)
        return max(int((iv.end - first + p - 1) // p), 0)
    # calendar granularities: months are the narrowest (≥ 28 days) — an
    # interval too wide even at that floor is over the cap without
    # iterating; otherwise the bounded walk is at most ~cap steps
    from druid_tpu_torch.utils.granularity import MS_DAY
    if iv.width > (MAX_STANDING_BUCKETS + 1) * 28 * MS_DAY:
        return MAX_STANDING_BUCKETS + 1
    n = 0
    cur = granularity.bucket_start(iv.start)
    while cur < iv.end and n <= MAX_STANDING_BUCKETS:
        n += 1
        cur = granularity.next_bucket(cur)
    return n


def check_eligible(query: Query) -> None:
    """Raise StandingIneligible unless `query` can run standing: an
    aggregate type over plain (non-union, non-nested) datasources, no
    bySegment, and a FINITE bucket space — the standing program's bucket
    index space is fixed at subscribe time (the broker's bounded-intervals
    discipline), so unbounded windows cannot compile."""
    if not isinstance(query, (TimeseriesQuery, TopNQuery, GroupByQuery)):
        raise StandingIneligible(
            f"standing queries must aggregate; got {query.query_type}")
    if query.inner_query is not None or query.union_datasources:
        raise StandingIneligible("nested/union datasources cannot stand")
    if query.context_map.get("bySegment"):
        raise StandingIneligible("bySegment results cannot stand")
    ivs = condense(query.intervals)
    if not ivs:
        raise StandingIneligible("no query intervals")
    if not query.granularity.is_all:
        n = sum(_bucket_count_bounded(query.granularity, iv) for iv in ivs)
        if n > MAX_STANDING_BUCKETS:
            raise StandingIneligible(
                f"granularity buckets exceed the standing limit "
                f"({MAX_STANDING_BUCKETS}); bound the query interval")


# ---------------------------------------------------------------------------
# Stats (the query/standing/* metric source)
# ---------------------------------------------------------------------------

class StandingStats:
    """Process-wide counters for every standing program's tick activity."""

    def __init__(self):
        self._lock = threading.Lock()
        self.ticks = 0
        self.folds = 0
        self.rows = 0
        self.cutovers = 0

    def record_tick(self, folds: int, rows: int, cutovers: int) -> None:
        with self._lock:
            self.ticks += 1
            self.folds += folds
            self.rows += rows
            self.cutovers += cutovers

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"ticks": self.ticks, "folds": self.folds,
                    "rows": self.rows, "cutovers": self.cutovers}


_STATS = StandingStats()


def stats() -> StandingStats:
    return _STATS


class StandingMetricsMonitor(Monitor):
    """Per-tick deltas of the standing subsystem's counters."""

    def __init__(self, source: Optional[StandingStats] = None):
        self.source = source or stats()
        self._last = self.source.snapshot()

    def do_monitor(self, emitter):
        s = self.source.snapshot()
        last, self._last = self._last, s
        emitter.metric("query/standing/ticks", s["ticks"] - last["ticks"])
        emitter.metric("query/standing/folds", s["folds"] - last["folds"])
        emitter.metric("query/standing/rows", s["rows"] - last["rows"])
        emitter.metric("query/standing/cutovers",
                       s["cutovers"] - last["cutovers"])


def resolve_emit(query: Query, emit: Optional[str] = None) -> str:
    """Normalize the emission policy a query asks for: context
    `standingEmit` ("change" | "bucket"), with "bucket" degrading to
    "change" for non-uniform granularities. The hub's dedupe key includes
    this (the structure signature strips context, and two subscribers
    with different emission policies must NOT share one program)."""
    emit = emit or str(query.context_map.get("standingEmit") or "change")
    if emit not in ("change", "bucket"):
        raise StandingIneligible(f"unknown standingEmit {emit!r}")
    if emit == "bucket" and not query.granularity.is_uniform:
        # bucket sealing needs fixed-width buckets; "all"/calendar
        # granularities emit on change
        emit = "change"
    return emit


def _with_marker(index, ident, n_hydrants: int):
    """Produce (live snapshot, its exact high-water marker) — one lock
    hold inside the index (IncrementalIndex.snapshot_with_marker), so the
    marker can neither lag the compaction nor include concurrent
    appends the snapshot does not cover."""
    seg, m = index.snapshot_with_marker(ident.version, ident.partition)
    return seg, (n_hydrants,) + m


# ---------------------------------------------------------------------------
# Per-sink incremental state
# ---------------------------------------------------------------------------

@dataclass
class _SinkState:
    """One sink's folded contribution. Mode "live": per-hydrant cached
    partials + the live hydrant's latest fold. Mode "published": the
    published segment's fold replaced everything (the cutover)."""
    ident: object
    mode: str = "live"                       # "live" | "published"
    hydrant_partials: List[object] = field(default_factory=list)
    hydrant_segs: List[object] = field(default_factory=list)
    live_partial: Optional[object] = None
    live_seg: Optional[object] = None
    live_marker: Optional[Tuple] = None
    published_seg: Optional[object] = None   # pending until the swap folds
    published_partial: Optional[object] = None

    def partials(self) -> List[object]:
        if self.mode == "published":
            return [self.published_partial] \
                if self.published_partial is not None else []
        out = list(self.hydrant_partials)
        if self.live_partial is not None:
            out.append(self.live_partial)
        return out

    def segments(self) -> List[object]:
        if self.mode == "published":
            return [self.published_seg] \
                if self.published_partial is not None else []
        out = list(self.hydrant_segs)
        if self.live_partial is not None:
            out.append(self.live_seg)
        return out


@dataclass(frozen=True)
class StandingSnapshot:
    """One emission: the rows, their identity (etag), and the event-time
    watermark state at emission time."""
    rows: list
    etag: str
    version: int
    watermark: Optional[int]
    sealed_through: Optional[int]


class StandingQuery:
    """One compiled standing program over the live sinks of one or more
    Appenderators (all sharing the query's datasource).

    Listener protocol (Appenderator.add_listener): sink_created /
    sink_published / sink_dropped arrive from ingest threads; tick() from
    the driver (scheduler flush loop or SubscriptionHub); snapshot()/rows()
    from serving threads. Device folds always run OUTSIDE the lock — the
    lock only guards the state dictionaries and the version counter.

    `device`: where the folds run (None: CUDA, through device.resolve;
    "cpu" runs the plain PyTorch versions)."""

    def __init__(self, query: Query,
                 appenderators: Sequence[object] = (),
                 emit: Optional[str] = None, device=None):
        check_eligible(query)
        self.query = query
        self.device = device_mod.resolve(device)
        from druid_tpu_torch.cluster.cache import query_cache_key
        self.signature = query_cache_key(query)
        self._sig_digest = hashlib.sha1(
            self.signature.encode()).hexdigest()[:16]
        self.emit = resolve_emit(query, emit)
        self._lock = threading.RLock()
        # sink id -> state, in first-appearance order: the merge order is
        # part of the bit-parity contract (float combines associate in
        # world order, exactly like the re-scan's per-segment partials)
        self._sinks: "Dict[str, _SinkState]" = {}
        self._order: List[str] = []
        self._apps: List[object] = []
        self._version = 0
        self._watermark: Optional[int] = None
        self._sealed_through: Optional[int] = None
        self._pending_structural = False     # sink add/drop since last tick
        self._rows_cache: Optional[Tuple[int, list]] = None
        self._closed = False
        for app in appenderators:
            self.attach(app)

    # ---- wiring --------------------------------------------------------
    def attach(self, appenderator) -> None:
        """Start standing over an appenderator's sinks (existing + future).
        Datasources must match — a standing program is one datasource.
        Idempotent: racing retro-wire paths (hub attach vs subscribe)
        cannot double-attach."""
        if appenderator.datasource != self.query.datasource:
            raise ValueError(
                f"appenderator [{appenderator.datasource}] does not serve "
                f"[{self.query.datasource}]")
        with self._lock:
            if self._closed:
                raise RuntimeError("standing query closed")
            if any(a is appenderator for a in self._apps):
                return
            self._apps.append(appenderator)
        appenderator.add_listener(self)

    def close(self) -> None:
        """Detach from every appenderator and drop all folded state."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            apps, self._apps = self._apps, []
            self._sinks.clear()
            self._order.clear()
            self._rows_cache = None
        for app in apps:
            app.remove_listener(self)

    # ---- Appenderator listener protocol --------------------------------
    def sink_created(self, ident) -> None:
        with self._lock:
            if self._closed or ident.id in self._sinks:
                return
            self._sinks[ident.id] = _SinkState(ident=ident)
            self._order.append(ident.id)
            self._pending_structural = True

    def sink_published(self, ident, segment) -> None:
        """The sink's merged historical segment exists (the driver is about
        to hand off + drop). Remember it; the NEXT tick performs the
        exactly-once cutover swap."""
        with self._lock:
            st = self._sinks.get(ident.id)
            if st is not None:
                st.published_seg = segment

    def sink_dropped(self, ident) -> None:
        with self._lock:
            st = self._sinks.get(ident.id)
            if st is None:
                return
            if st.published_seg is None:
                # dropped WITHOUT publish (discarded task): the rows are
                # gone from the world — remove the contribution whole
                del self._sinks[ident.id]
                self._order.remove(ident.id)
            else:
                st.mode = "published"        # swap folds on the next tick
            self._pending_structural = True

    # ---- the tick ------------------------------------------------------
    def tick(self) -> Optional[StandingSnapshot]:
        """Fold everything appended since the last high-water marks; emit
        (returns a snapshot, bumping the version) per the emission policy,
        or None when nothing warranted an emission.

        Ticks are lock-free across their device folds and safe to run
        concurrently: installs are idempotent (hydrant slots are indexed,
        live folds carry lexicographically monotonic markers), so a
        racing duplicate tick wastes work but can never double-count or
        regress state."""
        emit = self._tick_once()
        return self.snapshot() if emit else None

    def _tick_once(self) -> bool:
        with self._lock:
            if self._closed:
                return False
            if not enabled():
                # re-scan world: forget every cached fold so the pass
                # below recomputes all of it from scratch
                for st in self._sinks.values():
                    st.hydrant_partials = []
                    st.hydrant_segs = []
                    st.live_partial = None
                    st.live_seg = None
                    st.live_marker = None
                    st.published_partial = None
                self._rows_cache = None
            work = self._plan_folds_locked()
        folded = self._fold(work)
        with self._lock:
            changed, rows_folded, cutovers, late = \
                self._install_locked(work, folded)
            emit = self._emission_locked(changed, cutovers, late)
        n_folds = sum(1 for g in folded if g is not None)
        _STATS.record_tick(n_folds, rows_folded, cutovers)
        return emit

    def _plan_folds_locked(self) -> List[Tuple]:
        """Work items (kind, sink_id, marker, segment-producer) for every
        fold this tick owes. Snapshot production (to_segment) is deferred
        to outside the lock — it compacts the live index."""
        work: List[Tuple] = []
        for app in self._apps:
            for ident, hydrants, index in app.standing_states():
                st = self._sinks.get(ident.id)
                if st is None:
                    # raced sink_created: adopt it now, same world order
                    st = self._sinks[ident.id] = _SinkState(ident=ident)
                    self._order.append(ident.id)
                    self._pending_structural = True
                if st.mode != "live":
                    continue
                n_folded = len(st.hydrant_partials)
                for j, h in enumerate(hydrants[n_folded:], start=n_folded):
                    work.append(("hydrant", ident.id, j, h))
                # the high-water mark: (sealed hydrants, live generation,
                # pending rows) advances on every content change — id()
                # reuse across index rollovers cannot fake staleness
                marker = (len(hydrants),) + index.change_marker()
                if index.n_rows > 0 and marker != st.live_marker:
                    # the producer returns (snapshot, post-compaction
                    # marker): snapshotting compacts the index (bumping
                    # its generation), and storing the PRE-compaction
                    # marker would make the very next quiet tick look
                    # changed and re-fold the whole live hydrant
                    work.append((
                        "live", ident.id, marker,
                        lambda ix=index, iv=ident, h=len(hydrants):
                        _with_marker(ix, iv, h)))
                elif index.n_rows == 0 and st.live_partial is not None \
                        and marker != st.live_marker:
                    # live index rolled over empty (persist sealed it all)
                    work.append(("live-empty", ident.id, marker, None))
        for sid, st in self._sinks.items():
            if st.mode == "published" and st.published_partial is None \
                    and st.published_seg is not None:
                work.append(("published", sid, None, st.published_seg))
        return work

    def _fold(self, work: List[Tuple]) -> List[Optional[object]]:
        """Run every owed fold in ONE batched partial-production call
        (shape-compatible hydrants fuse across sinks). Returns per-item
        AggregatePartials (None for non-fold items)."""
        segs = []
        idx = []
        for i, (kind, sid, marker, seg) in enumerate(work):
            if kind == "live-empty":
                continue
            if kind == "hydrant":
                with self._lock:
                    st = self._sinks.get(sid)
                    # a persist sealed the previously-folded LIVE snapshot
                    # verbatim: its fold IS the hydrant's fold, no device
                    # work owed (the common quiet-persist case)
                    if st is not None and st.live_seg is seg \
                            and st.live_partial is not None:
                        continue
            if callable(seg):
                seg, post_marker = seg()
                # install compares and stores the post-compaction marker
                # the snapshot actually describes
                work[i] = (kind, sid, post_marker, seg)
            segs.append(seg)
            idx.append(i)
        out: List[Optional[object]] = [None] * len(work)
        if segs:
            parts = engines.make_partials_by_segment(self.query, segs,
                                                     self.device,
                                                     clamp=False)
            for i, seg, ap in zip(idx, segs, parts):
                out[i] = (seg, ap)
        return out

    def _install_locked(self, work, folded):
        """Install fold results; returns (changed, rows_folded, cutovers,
        late_data). A sink that changed mode while its fold was in flight
        discards the stale result."""
        changed = False
        rows_folded = 0
        cutovers = 0
        late = False
        sealed = self._sealed_through
        def fresher(st, marker):
            return st.live_marker is None or marker > st.live_marker

        for item, got in zip(work, folded):
            kind, sid, marker, item_seg = item
            st = self._sinks.get(sid)
            if st is None:
                continue
            if kind == "live-empty":
                if st.mode == "live" and fresher(st, marker):
                    st.live_partial = None
                    st.live_seg = None
                    st.live_marker = marker
                    changed = True
                continue
            if got is None:
                if kind == "hydrant" and st.mode == "live" \
                        and marker == len(st.hydrant_partials) \
                        and st.live_seg is item_seg \
                        and st.live_partial is not None:
                    # sealed-live reuse: the persist sealed the snapshot
                    # we already folded — promote that fold to hydrant
                    # rank, zero device work
                    st.hydrant_partials.append(st.live_partial)
                    st.hydrant_segs.append(st.live_seg)
                    st.live_partial = None
                    st.live_seg = None
                    changed = True
                continue
            seg, ap = got
            if kind == "hydrant" and st.mode == "live" \
                    and marker == len(st.hydrant_partials):
                # `marker` is the hydrant SLOT index: a duplicate install
                # (concurrent tick) misses the slot and drops out
                self._note_watermark(seg)
                late = late or (sealed is not None
                                and seg.n_rows > 0
                                and seg.min_time < sealed)
                st.hydrant_partials.append(ap)
                st.hydrant_segs.append(seg)
                rows_folded += seg.n_rows
                changed = True
            elif kind == "live" and st.mode == "live" \
                    and fresher(st, marker):
                self._note_watermark(seg)
                late = late or (sealed is not None
                                and seg.n_rows > 0
                                and seg.min_time < sealed)
                prev_rows = st.live_seg.n_rows \
                    if st.live_seg is not None else 0
                st.live_partial = ap
                st.live_seg = seg
                st.live_marker = marker
                rows_folded += max(seg.n_rows - prev_rows, 0)
                changed = True
            elif kind == "published" and st.mode == "published" \
                    and st.published_partial is None:
                # THE exactly-once cutover: one atomic swap — the
                # incremental partials leave and the published segment's
                # contribution arrives in the same locked mutation
                st.published_partial = ap
                st.hydrant_partials = []
                st.hydrant_segs = []
                st.live_partial = None
                st.live_seg = None
                st.live_marker = None
                cutovers += 1
                changed = True
        if self._pending_structural:
            self._pending_structural = False
            changed = True
        return changed, rows_folded, cutovers, late

    def _note_watermark(self, seg) -> None:
        if seg.n_rows and (self._watermark is None
                           or seg.max_time > self._watermark):
            self._watermark = seg.max_time

    def _emission_locked(self, changed: bool, cutovers: int,
                         late: bool) -> bool:
        if not changed:
            return False
        if self.emit == "bucket":
            boundary = None if self._watermark is None else \
                self.query.granularity.bucket_start(self._watermark)
            advance = boundary is not None and (
                self._sealed_through is None
                or boundary > self._sealed_through)
            if not (advance or late or cutovers):
                return False
            if advance:
                self._sealed_through = boundary
        self._version += 1
        self._rows_cache = None
        return True

    # ---- serving surface ------------------------------------------------
    def _etag_of(self, version: int) -> str:
        return f'"standing-{self._sig_digest}-{version}"'

    def etag(self) -> str:
        with self._lock:
            return self._etag_of(self._version)

    def version(self) -> int:
        with self._lock:
            return self._version

    def watermark(self) -> Optional[int]:
        with self._lock:
            return self._watermark

    def world_segments(self) -> List[object]:
        """The segments the current folded state represents, in merge
        order — the from-scratch re-scan oracle's exact input (tests; the
        set_enabled(False) path recomputes from these)."""
        with self._lock:
            out: List[object] = []
            for sid in self._order:
                out.extend(self._sinks[sid].segments())
            return [s for s in out if s is not None]

    def rows(self) -> list:
        """The finished result rows of the current version (cached; the
        merge recomputes only after an emission changed the state)."""
        return self._rows_versioned()[1]

    def _rows_versioned(self) -> Tuple[int, list]:
        """(version, rows) as ONE consistent pair: rows computed against
        version v are never handed out labeled v+1 — a concurrent tick
        bumping the version mid-merge triggers a recompute, so a
        subscriber can never get 304-stuck on stale rows under a fresh
        etag."""
        while True:
            with self._lock:
                version = self._version
                if self._rows_cache is not None \
                        and self._rows_cache[0] == version:
                    return version, self._rows_cache[1]
                parts = []
                for sid in self._order:
                    parts.extend(self._sinks[sid].partials())
            rows = self._finish(self._merged(parts))
            with self._lock:
                if self._version == version:
                    self._rows_cache = (version, rows)
                    return version, rows
            # version moved while merging: recompute against the new state

    def _merged(self, parts) -> "engines.AggregatePartials":
        """Concat in world order; a fresh object carries the query's fixed
        interval space when no partial named one (empty world)."""
        ap = engines.AggregatePartials.concat(parts)
        ivs = ap.intervals if ap.intervals is not None \
            else condense(self.query.intervals)
        return engines.AggregatePartials(ap.partials, ap.dim_values,
                                         ap.spans, ivs)

    def _finish(self, ap) -> list:
        if isinstance(self.query, TimeseriesQuery):
            return engines.finish_timeseries(self.query, ap)
        if isinstance(self.query, TopNQuery):
            return engines.finish_topn(self.query, ap)
        return engines.finish_groupby(self.query, ap)

    def snapshot(self) -> StandingSnapshot:
        version, rows = self._rows_versioned()
        with self._lock:
            return StandingSnapshot(
                rows=rows, etag=self._etag_of(version), version=version,
                watermark=self._watermark,
                sealed_through=self._sealed_through)

    def rescan_rows(self) -> list:
        """From-scratch oracle: recompute the same world with no cached
        state (the parity gate's other half; also the bench baseline)."""
        ap = engines.make_aggregate_partials(self.query,
                                             self.world_segments(),
                                             self.device, clamp=False)
        return self._finish(self._merged([ap]))
