"""Data nodes and the broker's cluster view (the port's own copy of the
reference package's `cluster/view.py`, over the port's engines).

Reference analogs:
  DataNode       — historical process: ServerManager (server/coordination/
                   ServerManager.java:74 — per-segment query serving) +
                   SegmentLoadDropHandler (load/drop lifecycle) +
                   SegmentManager (local timeline of loaded segments).
  InventoryView  — BrokerServerView (client/BrokerServerView.java:57) +
                   HttpServerInventoryView: the broker's live map of which
                   server holds which segment, maintained via announcements
                   (here: direct callbacks standing in for ZK/HTTP sync),
                   building per-datasource VersionedIntervalTimeline whose
                   payloads are replica sets (ServerSelector analog).

The node boundary (run_partials / run_rows) is in-process here; a real
multi-host deployment serializes AggregatePartials' numpy states over the
wire — shapes and dtypes are all plain host arrays by construction.

Every DataNode runs its segments on one torch device (CUDA unless the
caller passes device="cpu"); nodes of one process may share a card and the
process-wide device pool, and a segment held by two nodes of one process
stages once. A node given a mesh (parallel.make_mesh, of its device's type)
runs its aggregate partials as one sharded run over it, merged on the card
(parallel/distributed.py): one timing over the set, the segment-cache miss
set run per miss (a merged partial cannot split back into per-segment
entries), and no cross-query fusion with flush-mates.
"""
from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from druid_tpu_torch import device as device_mod
from druid_tpu_torch.cluster.cache import (CacheConfig, LruCache,
                                           query_cache_key)
from druid_tpu_torch.cluster.metadata import SegmentDescriptor
from druid_tpu_torch.cluster.shardspec import NoneShardSpec
from druid_tpu_torch.cluster.timeline import (PartitionChunk,
                                              VersionedIntervalTimeline)
from druid_tpu_torch.data.segment import Segment
from druid_tpu_torch.engine import engines
from druid_tpu_torch.engine.engines import (AggregatePartials,
                                            make_aggregate_partials)
from druid_tpu_torch.parallel import context as mesh_context
from druid_tpu_torch.query.model import (GroupByQuery, Query, TimeseriesQuery,
                                         TopNQuery)

log = logging.getLogger(__name__)


def descriptor_for(segment: Segment,
                   shard_spec=None) -> SegmentDescriptor:
    """Pass the real shard spec for multi-partition sets (numbered/hashed) —
    the timeline's completeness check depends on it. The defaults (none for
    partition 0, linear otherwise) are always-complete append semantics."""
    from druid_tpu_torch.cluster.shardspec import LinearShardSpec
    if shard_spec is None:
        shard_spec = NoneShardSpec(0) if segment.id.partition == 0 \
            else LinearShardSpec(segment.id.partition)
    return SegmentDescriptor(
        segment.id.datasource, segment.id.interval, segment.id.version,
        segment.id.partition, shard_spec, num_rows=segment.n_rows)


def _is_aggregate(query: Query) -> bool:
    return isinstance(query, (TimeseriesQuery, TopNQuery, GroupByQuery))


class DataNode:
    """One data server: loaded segments + the per-node query engine."""

    #: results from this server may be cached and the coordinator may manage
    #: its segments (False on realtime servers whose sinks mutate in place)
    segment_replicatable = True

    def __init__(self, name: str, tier: str = "_default_tier",
                 max_segments: Optional[int] = None,
                 cache: Optional[LruCache] = None,
                 cache_config: Optional[CacheConfig] = None,
                 device=None, emitter=None,
                 per_segment_metrics: bool = False,
                 mesh: Optional[mesh_context.Mesh] = None):
        """device: where this node's segments run (None: CUDA, through
        device.resolve; "cpu" runs the plain PyTorch versions).
        mesh: the node's aggregate partials run sharded over it (its
        devices of the node's device type).
        emitter: optional ServiceEmitter — per-segment query metrics
        (query/segment/time, query/segmentAndCache/time, query/cpu/time)
        emit here, the MetricsEmittingQueryRunner layer of the reference.
        per_segment_metrics=True additionally runs the uncached path
        segment-by-segment so each gets its own timing — an observability/
        throughput trade (the fused multi-segment program is faster); off,
        fused executions emit ONE aggregate timing."""
        self.name = name
        self.tier = tier
        self.max_segments = max_segments
        self.cache = cache
        self.cache_config = cache_config or CacheConfig()
        self.device = device_mod.resolve(device)
        mesh_context.check_device(mesh, self.device)
        self.mesh = mesh
        self.emitter = emitter
        self.per_segment_metrics = per_segment_metrics
        self._segments: Dict[str, Segment] = {}
        self._descriptors: Dict[str, SegmentDescriptor] = {}
        self._lock = threading.RLock()
        self.alive = True

    def _emit_segment(self, query, segment_id: str, wall_ms: float,
                      cpu_ms: float, cached: bool) -> None:
        if self.emitter is None:
            return
        qid = query.context_map.get("queryId", "")
        dims = dict(dataSource=query.datasource, type=query.query_type,
                    id=qid, segment=str(segment_id), server=self.name)
        if not cached:
            self.emitter.metric("query/segment/time", wall_ms, **dims)
            self.emitter.metric("query/cpu/time", cpu_ms, **dims)
        self.emitter.metric("query/segmentAndCache/time", wall_ms, **dims)

    # ---- load/drop (SegmentLoadDropHandler analog) ---------------------
    def load_segment(self, segment: Segment,
                     descriptor: Optional[SegmentDescriptor] = None) -> bool:
        """`descriptor` (when the loader has it) preserves the REAL shard
        spec for /status inventory listings — descriptor_for can only
        reconstruct default specs, and the timeline completeness check
        depends on the real one."""
        with self._lock:
            if self.max_segments is not None \
                    and len(self._segments) >= self.max_segments \
                    and str(segment.id) not in self._segments:
                return False
            self._segments[str(segment.id)] = segment
            if descriptor is not None:
                self._descriptors[str(segment.id)] = descriptor
            return True

    def drop_segment(self, segment_id: str) -> bool:
        with self._lock:
            self._descriptors.pop(str(segment_id), None)
            return self._segments.pop(str(segment_id), None) is not None

    def served_descriptors(self) -> List[SegmentDescriptor]:
        """Descriptors for every served segment — stored ones (real shard
        specs) where known, reconstructed defaults otherwise."""
        with self._lock:
            return [self._descriptors.get(sid) or descriptor_for(s)
                    for sid, s in self._segments.items()]

    def served_segment_ids(self) -> Set[str]:
        with self._lock:
            return set(self._segments)

    def ping(self) -> bool:
        """Liveness probe (the heartbeat a ZK ephemeral node implies)."""
        return self.alive

    def segment_count(self) -> int:
        with self._lock:
            return len(self._segments)

    def segments(self) -> List[Segment]:
        with self._lock:
            return list(self._segments.values())

    # ---- query serving (ServerManager analog) --------------------------
    def _select(self, segment_ids: Sequence[str]) -> Tuple[List[Segment], Set[str]]:
        with self._lock:
            found, served = [], set()
            for sid in segment_ids:
                s = self._segments.get(str(sid))
                if s is not None:
                    found.append(s)
                    served.add(str(sid))
            return found, served

    def run_partials(self, query: Query, segment_ids: Sequence[str],
                     check: Optional[Callable[[], None]] = None
                     ) -> Tuple[AggregatePartials, Set[str]]:
        """Aggregate path: produce partial states for the requested segments
        (clamp=False — the broker pre-bounds intervals so bucket index
        spaces align across nodes). Per-segment partials are cached when the
        segment cache is enabled (CachingQueryRunner analog).

        `check` (cancel/timeout probe) runs at every dispatch boundary —
        between per-segment runs, between batched shape-bucket runs, and
        before the sharded run (the engine threads it through
        make_aggregate_partials); an individual device run is
        uninterruptible once launched. With a mesh the partials run under
        it."""
        if not self.alive:
            raise ConnectionError(f"server [{self.name}] is down")
        with mesh_context.use_mesh(self.mesh):
            return self._run_partials(query, segment_ids, check)

    def _run_partials(self, query: Query, segment_ids: Sequence[str],
                      check: Optional[Callable[[], None]]
                      ) -> Tuple[AggregatePartials, Set[str]]:
        segs, served = self._select(segment_ids)
        use_cache = self._segment_cache_active(query)
        if not use_cache:
            if not (self.emitter is not None and self.per_segment_metrics) \
                    or self.mesh is not None or len(segs) <= 1:
                t0, c0 = time.monotonic(), time.thread_time()
                ap = make_aggregate_partials(query, segs, self.device,
                                             clamp=False, check=check)
                if segs:
                    # fused/mesh/batched execution: one timing over the set
                    self._emit_segment(
                        query, f"{len(segs)}-segments",
                        (time.monotonic() - t0) * 1e3,
                        (time.thread_time() - c0) * 1e3, cached=False)
                if check is not None:
                    check()
            else:
                parts = []
                for s in segs:
                    if check is not None:
                        check()
                    t0, c0 = time.monotonic(), time.thread_time()
                    parts.append(make_aggregate_partials(
                        query, [s], self.device, clamp=False))
                    self._emit_segment(query, s.id,
                                       (time.monotonic() - t0) * 1e3,
                                       (time.thread_time() - c0) * 1e3,
                                       cached=False)
                ap = AggregatePartials.concat(parts)
            return ap, served
        qkey, parts, to_compute = self._cache_scan(query, segs)
        if to_compute and (self.mesh is not None
                           or (self.emitter is not None
                               and self.per_segment_metrics)):
            # mesh: the sharded run may merge the miss set into one partial
            # that cannot split back into per-segment cache entries — keep
            # the per-miss loop. per_segment_metrics: observability trade,
            # per-segment timings require per-segment dispatches
            for s in to_compute:
                if check is not None:
                    check()
                t0, c0 = time.monotonic(), time.thread_time()
                ap = make_aggregate_partials(query, [s], self.device,
                                             clamp=False)
                self._emit_segment(query, s.id,
                                   (time.monotonic() - t0) * 1e3,
                                   (time.thread_time() - c0) * 1e3,
                                   cached=False)
                self._cache_put(qkey, [(s, ap)])
                parts.append(ap)
        elif to_compute:
            # the whole miss set in ONE wave: shape-compatible misses fuse
            # into batched dispatches (engine/batching.py) instead of one
            # device program per miss; the per-segment partials come back
            # split, so cache entries stay identical to the per-miss path
            if check is not None:
                check()
            t0, c0 = time.monotonic(), time.thread_time()
            per_seg = engines.make_partials_by_segment(
                query, to_compute, self.device, clamp=False, check=check)
            self._emit_segment(query, f"{len(to_compute)}-segment-misses",
                               (time.monotonic() - t0) * 1e3,
                               (time.thread_time() - c0) * 1e3,
                               cached=False)
            self._cache_put(qkey, zip(to_compute, per_seg))
            parts.extend(per_seg)
        return AggregatePartials.concat(parts), served

    def _cache_scan(self, query: Query, segs: Sequence[Segment]
                    ) -> Tuple[str, List[AggregatePartials], List[Segment]]:
        """(qkey, hit partials, miss segments): the timed per-segment cache
        scan — THE one hit/miss discipline; run_partials (request thread)
        and run_partials_group (scheduler flush) both use it, so cache
        semantics cannot diverge between the two execution paths."""
        qkey = query_cache_key(query)
        hit_parts: List[AggregatePartials] = []
        to_compute: List[Segment] = []
        for s in segs:
            t0 = time.monotonic()
            hit = self.cache.get("segment", f"{s.id}|{qkey}")
            if hit is not None:
                hit_parts.append(hit)
                self._emit_segment(query, s.id,
                                   (time.monotonic() - t0) * 1e3, 0.0,
                                   cached=True)
            else:
                to_compute.append(s)
        return qkey, hit_parts, to_compute

    def _cache_put(self, qkey: str, pairs) -> None:
        """Populate per-segment cache entries (gated on the config), the
        counterpart of _cache_scan shared by both serving paths."""
        if not self.cache_config.populate_segment_cache:
            return
        for s, ap in pairs:
            self.cache.put("segment", f"{s.id}|{qkey}", ap)

    def _segment_cache_active(self, query: Query) -> bool:
        """Whether the per-segment results cache takes this query — the
        ONE eligibility condition run_partials and run_partials_group must
        agree on (a fused request must never bypass cache population the
        serial path would have done)."""
        return (self.cache is not None
                and self.cache_config.cacheable(query)
                and self.cache_config.use_segment_cache)

    def fusable(self, query: Query) -> bool:
        """Whether run_partials_group would FUSE this query with its
        flush-mates. Work this node cannot fuse — mesh execution,
        per-segment metrics, non-aggregate queries, batching opted out
        (process switch or {"batchSegments": false}) — gains nothing from a
        scheduler hold and runs through run_partials instead.

        Segment-cache-active queries DO fuse: run_partials_group resolves
        cache hits inline during the flush and sends only the MISS set into
        the fused wave, splitting the results back into per-segment cache
        entries."""
        from druid_tpu_torch.engine import batching
        return (_is_aggregate(query) and self.mesh is None
                and batching.query_enabled(query.context_map)
                and not (self.emitter is not None
                         and self.per_segment_metrics))

    def run_partials_group(self, requests, on_batch=None) -> List[object]:
        """Cross-query serving: one call for a whole scheduler flush.
        `requests` is a sequence of (query, segment_ids, check) triples;
        returns one entry per request — (AggregatePartials, served) or the
        Exception that request failed with (one query's cancel/timeout
        must not fail its flush-mates).

        Plan-compatible segment work FUSES across the requests into shared
        device dispatches (engines.make_aggregate_partials_multi). Requests
        this node cannot fuse (see `fusable`) run via the normal
        run_partials path, so semantics (cache population, per-segment
        metrics) stay identical. The fused wave never clamps its
        intervals to this node's data, as run_partials does not, so bucket
        spaces line up across nodes. `on_batch` observes each fused
        dispatch (query/crossBatch/*)."""
        if not self.alive:
            err = ConnectionError(f"server [{self.name}] is down")
            return [err for _ in requests]
        fused_idx: List[int] = []
        fused_items = []        # ((query, segs, check), (served, cache_meta))
        out: List[object] = [None] * len(requests)
        for i, (query, segment_ids, check) in enumerate(requests):
            if not self.fusable(query):
                try:
                    out[i] = self.run_partials(query, segment_ids,
                                               check=check)
                except Exception as e:
                    out[i] = e
                continue
            segs, served = self._select(segment_ids)
            if self._segment_cache_active(query):
                # cache hits resolve INSIDE the flush (no device work, no
                # per-query routing); only the miss set joins the fused
                # wave, and its results split back into per-segment cache
                # entries identical to the serial path's (the scan/put
                # discipline is _cache_scan/_cache_put — shared with
                # run_partials, so the two paths cannot drift)
                qkey, hit_parts, to_compute = self._cache_scan(query, segs)
                if not to_compute:
                    # the hot-datasource shape: a fully-cached query costs
                    # the flush nothing at all
                    out[i] = (AggregatePartials.concat(hit_parts), served)
                    continue
                fused_idx.append(i)
                fused_items.append(((query, to_compute, check),
                                    (served, (hit_parts, to_compute, qkey))))
            else:
                fused_idx.append(i)
                fused_items.append(((query, segs, check), (served, None)))
        if fused_items:
            t0, c0 = time.monotonic(), time.thread_time()
            results = engines.make_aggregate_partials_multi(
                [item for item, _ in fused_items], self.device,
                on_batch=on_batch, clamp=False)
            wall_ms = (time.monotonic() - t0) * 1e3
            cpu_ms = (time.thread_time() - c0) * 1e3
            for i, got, ((query, segs, _), (served, cache_meta)) \
                    in zip(fused_idx, results, fused_items):
                if isinstance(got, BaseException):
                    out[i] = got
                    continue
                if cache_meta is None:
                    if segs:
                        # one fused timing per request, as run_partials
                        # emits for a batched set — the flush is shared,
                        # so the wall/cpu cost is the whole group's, not
                        # this query's alone
                        self._emit_segment(query, f"{len(segs)}-segments",
                                           wall_ms, cpu_ms, cached=False)
                    out[i] = (got, served)
                    continue
                hit_parts, to_compute, qkey = cache_meta
                per_seg = engines.split_partials_by_segment(got, to_compute)
                self._cache_put(qkey, zip(to_compute, per_seg))
                self._emit_segment(query,
                                   f"{len(to_compute)}-segment-misses",
                                   wall_ms, cpu_ms, cached=False)
                # hit parts first, computed parts after — the same order
                # run_partials' cached path concatenates in
                out[i] = (AggregatePartials.concat(hit_parts + per_seg),
                          served)
        return out

    def run_rows(self, query: Query, segment_ids: Sequence[str]
                 ) -> Tuple[List[dict], Set[str]]:
        """Row path (scan/select/search/timeBoundary/metadata queries):
        run the local engine to finished rows on this node's device; the
        broker row-merges."""
        if not self.alive:
            raise ConnectionError(f"server [{self.name}] is down")
        segs, served = self._select(segment_ids)
        from druid_tpu_torch.engine.executor import QueryExecutor
        ex = QueryExecutor(device=self.device, mesh=self.mesh)
        rows = ex.run(query, segments=segs)
        return rows, served


class ServerSelectorStrategy:
    """Replica-choice SPI (client/selector/ServerSelectorStrategy.java +
    TierSelectorStrategy): given candidate server names, pick one."""

    def pick(self, candidates: List[str], view: Optional["InventoryView"],
             rng: random.Random) -> str:
        raise NotImplementedError


class RandomServerSelectorStrategy(ServerSelectorStrategy):
    def pick(self, candidates, view, rng):
        return candidates[rng.randrange(len(candidates))]


class ConnectionCountServerSelectorStrategy(ServerSelectorStrategy):
    """Least-loaded replica by open query count
    (client/selector/ConnectionCountServerSelectorStrategy.java); the view
    tracks in-flight queries per server. Ties break RANDOMLY — on an idle
    cluster every replica shows zero connections and a deterministic
    tie-break would route everything to one server."""

    def pick(self, candidates, view, rng):
        if view is None:
            return candidates[rng.randrange(len(candidates))]
        loads = [(view.open_connections(s), s) for s in candidates]
        lo = min(l for l, _ in loads)
        pool = [s for l, s in loads if l == lo]
        return pool[rng.randrange(len(pool))]


class TierPreferenceStrategy(ServerSelectorStrategy):
    """Prefer replicas on the listed tiers in order (Highest/Lowest
    PriorityTierSelectorStrategy capability), falling back to `delegate`
    within the chosen tier."""

    def __init__(self, preferred_tiers: Sequence[str],
                 delegate: Optional[ServerSelectorStrategy] = None):
        self.preferred_tiers = list(preferred_tiers)
        self.delegate = delegate or RandomServerSelectorStrategy()

    def pick(self, candidates, view, rng):
        if view is not None:
            by_tier: Dict[str, List[str]] = {}
            for s in candidates:
                node = view.node(s)
                by_tier.setdefault(
                    getattr(node, "tier", "_default_tier"), []).append(s)
            for tier in self.preferred_tiers:
                if by_tier.get(tier):
                    return self.delegate.pick(by_tier[tier], view, rng)
        return self.delegate.pick(candidates, view, rng)


class ReplicaSet:
    """Which servers hold one segment chunk (ServerSelector analog);
    pick() delegates to the configured ServerSelectorStrategy
    (client/selector/TierSelectorStrategy.java)."""

    def __init__(self, descriptor: SegmentDescriptor):
        self.descriptor = descriptor
        self.servers: Set[str] = set()
        #: per-server announce sequence (sync_server stale-round guard)
        self.server_seq: Dict[str, int] = {}

    def pick(self, rng: random.Random,
             exclude: Optional[Set[str]] = None,
             strategy: Optional[ServerSelectorStrategy] = None,
             view: Optional["InventoryView"] = None,
             circuits=None) -> Optional[str]:
        """`circuits` (resilience.CircuitRegistry): selection NEVER
        returns an excluded server, and skips open-circuit servers that
        are still cooling down. A cooled-down open server rejoins the
        pool as the half-open PROBE candidate (picking it routes exactly
        one query through and tags it via begin_probe — without this, a
        sick server could never recover while a healthy replica keeps
        absorbing the traffic). Only when EVERY candidate is open-and-
        uncooled does selection fall back to an open server anyway,
        tagged as a probe: a guaranteed no-replica failure is worse than
        one fail-fast attempt on a sick server."""
        pool = sorted(self.servers - (exclude or set()))
        if not pool:
            return None
        probe_set: Set[str] = set()
        if circuits is not None:
            closed = [s for s in pool if circuits.closed(s)]
            cooled = [s for s in pool if circuits.probe_candidate(s)]
            if closed or cooled:
                pool = sorted(closed + cooled)
                probe_set = set(cooled)
            else:
                probe_set = set(pool)      # all-open last resort
        if strategy is None:
            chosen = pool[rng.randrange(len(pool))]
        else:
            chosen = strategy.pick(pool, view, rng)
        if chosen in probe_set:
            circuits.begin_probe(chosen)
        return chosen


class InventoryView:
    """The live cluster map: node registry + per-datasource timelines whose
    payloads are ReplicaSets. Announcements are direct method calls (the
    in-process stand-in for ZK ephemeral nodes / HTTP sync)."""

    def __init__(self):
        self._nodes: Dict[str, DataNode] = {}
        self._timelines: Dict[str, VersionedIntervalTimeline] = {}
        self._replicas: Dict[str, ReplicaSet] = {}   # segment id → replicas
        self._probe_failures: Dict[str, int] = {}    # consecutive ping fails
        self._connections: Dict[str, int] = {}       # in-flight per server
        self._capacity_sheds: Dict[str, int] = {}    # cumulative 429s seen
        self._latency_ewma: Dict[str, float] = {}    # per-server ms EWMA
        self._announce_seq = 0                       # monotonic, under lock
        self._lock = threading.RLock()
        self._listeners: List[Callable[[str, str, str], None]] = []

    # ---- capacity-shed accounting (broker lane-aware retry) ------------
    def note_capacity_shed(self, server: str) -> None:
        """A data node answered 429 for a query wave. The broker records it
        here before retrying the segment set on ONE other replica, so
        operators can see per-server shed pressure alongside connection
        counts."""
        with self._lock:
            self._capacity_sheds[server] = \
                self._capacity_sheds.get(server, 0) + 1

    def capacity_sheds(self, server: str) -> int:
        with self._lock:
            return self._capacity_sheds.get(server, 0)

    # ---- latency accounting (hedged-request delay input) ---------------
    def note_latency(self, server: str, wall_ms: float,
                     alpha: float = 0.2) -> None:
        """Feed one broker/node response time into the server's latency
        EWMA — the broker reports every successful scatter call here, and
        the hedge delay derives from the estimate (resilience.
        BrokerResilience.hedge_delay_s)."""
        with self._lock:
            prev = self._latency_ewma.get(server)
            self._latency_ewma[server] = wall_ms if prev is None \
                else alpha * wall_ms + (1.0 - alpha) * prev

    def latency_ms(self, server: str) -> Optional[float]:
        with self._lock:
            return self._latency_ewma.get(server)

    # ---- in-flight accounting (ConnectionCount strategy input) ---------
    def connection_started(self, server: str) -> None:
        with self._lock:
            self._connections[server] = self._connections.get(server, 0) + 1

    def connection_finished(self, server: str) -> None:
        with self._lock:
            n = self._connections.get(server, 0) - 1
            if n <= 0:
                self._connections.pop(server, None)
            else:
                self._connections[server] = n

    def open_connections(self, server: str) -> int:
        with self._lock:
            return self._connections.get(server, 0)

    # ---- node lifecycle ------------------------------------------------
    def register(self, node: DataNode) -> None:
        with self._lock:
            self._nodes[node.name] = node

    def remove_node(self, name: str) -> None:
        """Server death: drop it from every replica set instantly; segments
        it was the last holder of leave the timeline (the broker's reaction
        to a ZK ephemeral node vanishing)."""
        with self._lock:
            node = self._nodes.pop(name, None)
            if node is None:
                return
            orphaned = []
            for sid, rs in self._replicas.items():
                rs.servers.discard(name)
                if not rs.servers:
                    orphaned.append(sid)
            for sid in orphaned:
                d = self._replicas.pop(sid).descriptor
                tl = self._timelines.get(d.datasource)
                if tl is not None:
                    tl.remove(d.interval, d.version,
                              d.shard_spec.partition_num if d.shard_spec
                              else d.partition)

    def node(self, name: str) -> Optional[DataNode]:
        with self._lock:
            return self._nodes.get(name)

    def nodes(self) -> List[DataNode]:
        with self._lock:
            return list(self._nodes.values())

    def sync_server(self, node) -> Tuple[int, int]:
        """One inventory-sync round for a node exposing
        served_descriptors() (a DataNode here; the remote client of the
        HTTP slice later): announce segments the
        node now serves, unannounce ones it no longer does — the poll loop
        of HttpServerInventoryView, replacing hand-registration. Returns
        (announced, unannounced)."""
        with self._lock:
            fetch_seq = self._announce_seq
        descs = node.served_descriptors() \
            if hasattr(node, "served_descriptors") else \
            [descriptor_for(s) for s in node.segments()]
        current = {d.id: d for d in descs}
        added = removed = 0
        with self._lock:
            known = {sid: rs for sid, rs in self._replicas.items()
                     if node.name in rs.servers}
            for sid, d in current.items():
                if sid not in known:
                    self.announce(node.name, d)
                    added += 1
            for sid, rs in known.items():
                if sid in current:
                    continue
                # an announce NEWER than our /status fetch (e.g. a load
                # peon finishing mid-sync) must not be reverted by this
                # round's stale snapshot
                if rs.server_seq.get(node.name, 0) > fetch_seq:
                    continue
                self.unannounce(node.name, sid)
                removed += 1
        return added, removed

    def sync_all(self) -> Tuple[int, int]:
        """Sync every registered node (the periodic inventory refresh)."""
        a = r = 0
        for node in self.nodes():
            try:
                da, dr = self.sync_server(node)
                a += da
                r += dr
            except Exception:
                # liveness handles dead nodes; keep syncing the rest
                log.debug("inventory sync for [%s] failed", node.name,
                          exc_info=True)
                continue
        return a, r

    def check_liveness(self, failures_required: int = 1) -> List[str]:
        """Probe every node (concurrently — a dead remote must not stall
        the cycle by its timeout) and drop the dead ones from the view: the
        stand-in for ZK ephemeral-node expiry (curator/announcement/
        Announcer.java). Removal retracts all of the server's announcements,
        so brokers stop routing to it and the coordinator's rule run sees
        the replica deficit and re-replicates.

        failures_required > 1 adds a grace period: a node is removed only
        after that many CONSECUTIVE failed cycles (ZK's session timeout is
        likewise multiple missed heartbeats, not one). A recovered node
        re-registers + re-announces to rejoin."""
        from concurrent.futures import ThreadPoolExecutor
        nodes = self.nodes()
        if not nodes:
            return []

        def probe(node) -> bool:
            try:
                ping = getattr(node, "ping", None)
                return bool(ping()) if callable(ping) \
                    else bool(getattr(node, "alive", True))
            except Exception:
                log.debug("liveness probe for [%s] raised", node.name,
                          exc_info=True)
                return False

        with ThreadPoolExecutor(max_workers=min(len(nodes), 16)) as pool:
            results = list(pool.map(probe, nodes))
        dead = []
        with self._lock:
            for node, ok in zip(nodes, results):
                if ok:
                    self._probe_failures.pop(node.name, None)
                    continue
                n = self._probe_failures.get(node.name, 0) + 1
                self._probe_failures[node.name] = n
                if n >= failures_required:
                    dead.append(node.name)
                    del self._probe_failures[node.name]
        for name in dead:
            self.remove_node(name)
        return dead

    # ---- announcements -------------------------------------------------
    def announce(self, server: str, descriptor: SegmentDescriptor) -> None:
        with self._lock:
            sid = descriptor.id
            rs = self._replicas.get(sid)
            if rs is None:
                rs = self._replicas[sid] = ReplicaSet(descriptor)
                tl = self._timelines.setdefault(
                    descriptor.datasource, VersionedIntervalTimeline())
                spec = descriptor.shard_spec or NoneShardSpec(descriptor.partition)
                tl.add(descriptor.interval, descriptor.version,
                       PartitionChunk(spec, rs))
            rs.servers.add(server)
            self._announce_seq += 1
            rs.server_seq[server] = self._announce_seq
        for fn in list(self._listeners):
            fn("announce", server, sid)

    def unannounce(self, server: str, segment_id: str) -> None:
        with self._lock:
            rs = self._replicas.get(segment_id)
            if rs is None:
                return
            rs.servers.discard(server)
            rs.server_seq.pop(server, None)
            if not rs.servers:
                d = rs.descriptor
                tl = self._timelines.get(d.datasource)
                if tl is not None:
                    tl.remove(d.interval, d.version,
                              d.shard_spec.partition_num if d.shard_spec
                              else d.partition)
                del self._replicas[segment_id]
        for fn in list(self._listeners):
            fn("unannounce", server, segment_id)

    def add_listener(self, fn: Callable[[str, str, str], None]) -> None:
        self._listeners.append(fn)

    # ---- lookup ---------------------------------------------------------
    def timeline(self, datasource: str) -> Optional[VersionedIntervalTimeline]:
        with self._lock:
            return self._timelines.get(datasource)

    def datasources(self) -> List[str]:
        with self._lock:
            return sorted(ds for ds, tl in self._timelines.items()
                          if not tl.is_empty())

    def replica_set(self, segment_id: str) -> Optional[ReplicaSet]:
        with self._lock:
            return self._replicas.get(segment_id)

    def served_segments(self, server: str) -> List[SegmentDescriptor]:
        with self._lock:
            return [rs.descriptor for rs in self._replicas.values()
                    if server in rs.servers]
