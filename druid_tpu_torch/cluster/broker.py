"""Broker: cluster-wide scatter-gather query execution (the port's own
copy of the reference package's `cluster/broker.py`, over the port's
engines).

Reference analog: CachingClusteredClient (client/CachingClusteredClient.java:93
— the broker's QuerySegmentWalker): timeline lookup (computeSegmentsToQuery
:290) → shard pruning → cache probe (pruneSegmentsWithCachedResults :397) →
group by server → per-server fan-out (addSequencesFromServer :536) → merge;
plus RetryQueryRunner (query/RetryQueryRunner.java:71 — re-fans-out segments
reported missing) and ResultLevelCachingQueryRunner.

Difference from Druid: data nodes return *partial aggregation states*
(AggregatePartials — dense per-key host arrays), and the broker merge is the
same vectorized sparse merge used across segments
(druid_tpu_torch/engine/merge.py) — HLL and sketch merges stay exact
because states, not finalized estimates, cross the node boundary. The
partials concatenate in node-call order, so a float sum's last bits may
differ from one process's run over the same segments; counts, integer
sums, min/max and HLL registers do not.
"""
from __future__ import annotations

import logging
import random
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as wait_futures
from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Set, Tuple

from druid_tpu_torch import device as device_mod
from druid_tpu_torch.cluster.cache import (CacheConfig, LruCache,
                                           result_level_key)
from druid_tpu_torch.cluster.metadata import SegmentDescriptor
from druid_tpu_torch.cluster.resilience import (BrokerResilience,
                                                PartialResult,
                                                ResiliencePolicy,
                                                allows_partial,
                                                hedging_enabled)
from druid_tpu_torch.cluster.view import InventoryView, _is_aggregate
from druid_tpu_torch.engine import engines
from druid_tpu_torch.engine.engines import AggregatePartials
from druid_tpu_torch.obs import trace as qtrace
from druid_tpu_torch.query import filters as F
from druid_tpu_torch.query.model import (DataSourceMetadataQuery, GroupByQuery,
                                         Query, ScanQuery, SearchQuery,
                                         SegmentMetadataQuery, SelectQuery,
                                         TimeBoundaryQuery, TimeseriesQuery,
                                         TopNQuery, query_from_json)
from druid_tpu_torch.server.querymanager import (Deadline, QueryCapacityError,
                                                 QueryInterruptedError,
                                                 QueryManager,
                                                 QueryTimeoutError, QueryToken,
                                                 context_timeout_ms)
from druid_tpu_torch.utils.intervals import Interval, condense


class MissingSegmentsError(RuntimeError):
    def __init__(self, segment_ids: Sequence[str]):
        super().__init__(f"segments not served after retries: "
                         f"{sorted(segment_ids)}")
        self.segment_ids = sorted(segment_ids)


def _slice_scan_batches(batches, skip: int, remaining):
    """Apply a global offset/limit across scan batches. Returns
    (sliced batches, skip left, remaining left) so streaming callers can
    carry the counters across waves; `remaining` None means unlimited."""
    out = []
    for b in batches:
        ev = b["events"]
        if skip:
            if skip >= len(ev):
                skip -= len(ev)
                continue
            ev = ev[skip:]
            skip = 0
        if remaining is not None:
            ev = ev[:remaining]
            remaining -= len(ev)
        if ev:
            out.append({**b, "events": ev})
        if remaining is not None and remaining <= 0:
            break
    return out, skip, remaining


def _filter_domain(flt) -> Dict[str, List[Optional[str]]]:
    """Extract dim → candidate-values constraints for shard pruning
    (the broker's hash-pruning of secondary partitions)."""
    if getattr(flt, "extraction_fn", None) is not None:
        # the raw dictionary values behind fn(v) == target are unknowable
        # here — no pruning constraint may be derived
        return {}
    if isinstance(flt, F.SelectorFilter):
        return {flt.dimension: [flt.value]}
    if isinstance(flt, F.InFilter):
        return {flt.dimension: list(flt.values)}
    if isinstance(flt, F.AndFilter):
        out: Dict[str, List[Optional[str]]] = {}
        for f in flt.fields:
            for d, vals in _filter_domain(f).items():
                if d in out:
                    out[d] = [v for v in out[d] if v in set(vals)]
                else:
                    out[d] = vals
        return out
    return {}


class _ScatterCall:
    """One in-flight scatter call (primary or hedge) within a wave."""

    __slots__ = ("server", "sids", "is_hedge", "started", "cancel_sent")

    def __init__(self, server: str, sids: Sequence[str], is_hedge: bool):
        self.server = server
        self.sids = list(sids)
        self.is_hedge = is_hedge
        self.started = time.monotonic()
        self.cancel_sent = False


class Broker:
    """QuerySegmentWalker over the cluster. Also provides the QueryExecutor
    surface (run / run_json / datasources / segments_of) so SqlExecutor can
    plan and execute cluster-wide."""

    #: ceiling on one wave's park between completions: a query with no
    #: timeout context must still re-check liveness each quantum instead
    #: of parking a request thread on the pool indefinitely
    MAX_WAVE_POLL_S = 60.0

    def __init__(self, view: InventoryView,
                 cache: Optional[LruCache] = None,
                 cache_config: Optional[CacheConfig] = None,
                 max_retries: int = 2, seed: int = 0,
                 max_threads: int = 8,
                 query_manager: Optional[QueryManager] = None,
                 selector_strategy=None,
                 resilience_policy: Optional[ResiliencePolicy] = None,
                 device=None):
        """selector_strategy: view.ServerSelectorStrategy for replica
        choice (default: random within the replica set).
        device: where the broker-local outer query of a nested groupBy
        runs (None: CUDA, through device.resolve; "cpu" for the plain
        PyTorch versions).
        resilience_policy: every data-plane fault-tolerance knob —
        circuit breakers, hedged requests, partial-result degradation
        (cluster/resilience.py; default policy when None)."""
        self.view = view
        self.cache = cache
        self.cache_config = cache_config or CacheConfig()
        self.max_retries = max_retries
        self.rng = random.Random(seed)
        self.max_threads = max_threads
        self.query_manager = query_manager or QueryManager()
        self.selector_strategy = selector_strategy
        self.resilience = BrokerResilience(resilience_policy, seed=seed)
        self.device = device_mod.resolve(device)
        # ONE broker-owned scatter pool (created on first scatter, shut
        # down in stop()) — retry rounds and hedges stop paying per-round
        # pool spin-up
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()

    def _ensure_pool(self) -> ThreadPoolExecutor:
        """The broker-owned scatter pool. Unlike the old per-round pool
        (one per retry round per query), this one is shared by EVERY
        concurrent query's waves — so it is sized at a multiple of
        max_threads plus hedge headroom: one query's hung stragglers
        must not starve another query's primaries or hedges of workers
        (workers spawn lazily, so the headroom costs nothing while
        idle; deadline-abandoned calls are remote-cancelled, which
        frees their workers on nodes that honor the cancel)."""
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=4 * (self.max_threads
                                     + self.resilience.policy
                                     .hedge_max_per_query),
                    thread_name_prefix="broker-scatter")
            return self._pool

    def stop(self) -> None:
        """Release the scatter pool (idempotent). The broker stays
        usable — the next scatter recreates the pool."""
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)

    # ---- QueryExecutor-compatible surface ------------------------------
    @property
    def datasources(self) -> List[str]:
        return self.view.datasources()

    def segments_of(self, datasource: str):
        """Segment objects for schema discovery. In-process convenience —
        a multi-host deployment answers this with segmentMetadata queries
        (DruidSchema does exactly that)."""
        out, seen = [], set()
        for node in self.view.nodes():
            for s in node.segments():
                if s.id.datasource == datasource and str(s.id) not in seen:
                    seen.add(str(s.id))
                    out.append(s)
        return out

    def run_json(self, j: dict):
        return self.run(query_from_json(j))

    # ---- the signature path (§3.1) -------------------------------------
    def run(self, query: Query):
        # the trace root for a query entering at the broker (trace id =
        # queryId); when the lifecycle already opened the root this is a
        # plain child span, and {"trace": false} makes it (and every span
        # below it) a no-op
        with qtrace.root_span("broker/query", query,
                              service="druid/broker"):
            return self._run(query)

    def _run(self, query: Query):
        from druid_tpu_torch.engine.executor import apply_interval_chunking
        query = apply_interval_chunking(query)
        if query.inner_query is not None:
            # subquery: inner runs cluster-wide; the outer re-groups the
            # materialized inner rows broker-locally (as the reference's
            # broker does for nested groupBys)
            from druid_tpu_torch.engine.executor import (QueryExecutor,
                                                         subquery_segment)
            inner_rows = self.run(query.inner_query)
            seg = subquery_segment(query.inner_query, inner_rows)
            return QueryExecutor(device=self.device).run(query,
                                                         segments=[seg])
        with qtrace.span("broker/plan"):
            segments = self._segments_to_query(query)
        if not segments:
            return []
        if _is_aggregate(query):
            if query.context_map.get("bySegment"):
                # per-segment unmerged results: the row path concatenates
                # what every node's BySegmentQueryRunner produced
                return self._run_rows(query, segments)
            return self._run_aggregate(query, segments)
        return self._run_rows(query, segments)

    def run_streaming(self, query: Query):
        """Streaming scan through the scatter path: segments are queried
        in per-segment waves (time-ordered when the scan is ordered) and
        each wave's batches yield before the next segment is touched, so
        a satisfied limit stops the scatter early and rows reach the
        caller incrementally. Non-scan queries are merge-shaped: they
        fall back to the materialized run()."""
        if not isinstance(query, ScanQuery) or query.inner_query is not None:
            yield from self.run(query)
            return
        from druid_tpu_torch.engine.executor import apply_interval_chunking
        query = apply_interval_chunking(query)
        segments = self._segments_to_query(query)
        if not segments:
            return
        if query.order != "none":
            segments.sort(key=lambda d: d.interval.start,
                          reverse=(query.order == "descending"))
        skip = query.offset
        remaining = query.limit
        for d in segments:
            if remaining is not None and remaining <= 0:
                return
            # per-node offsets don't compose globally: request raw rows
            # (bounded by what could still be needed) and slice here
            want = None if remaining is None else remaining + skip
            sub = replace(query, limit=want, offset=0)
            wave, missing = self._scatter(sub, [d], rows_mode=True)
            if missing:
                # a streamed scan cannot attach a missing-segments report
                # to rows already on the wire — surface the typed error
                # instead of silently skipping the segment
                raise MissingSegmentsError(list(missing))
            batches = self._merge_rows(
                replace(sub, limit=None, offset=0), wave, [d])
            sliced, skip, remaining = _slice_scan_batches(
                batches, skip, remaining)
            yield from sliced

    def _segments_to_query(self, query: Query) -> List[SegmentDescriptor]:
        """Timeline lookup + shard pruning (computeSegmentsToQuery)."""
        datasources = query.union_datasources or (query.datasource,)
        out, seen = [], set()
        for ds in datasources:
            tl = self.view.timeline(ds)
            if tl is not None:
                self._collect(tl, query, out, seen)
        return out

    def _collect(self, tl, query: Query, out, seen) -> None:
        domain = _filter_domain(query.filter) if query.filter is not None else {}
        for iv in condense(query.intervals):
            for holder in tl.lookup(iv):
                for chunk in holder.partitions:
                    rs = chunk.obj
                    d = rs.descriptor
                    if d.id in seen:
                        continue
                    seen.add(d.id)
                    if domain and d.shard_spec is not None \
                            and not d.shard_spec.possible_in_domain(domain):
                        continue
                    out.append(d)

    # ---- aggregate path: partials + broker-side finish -----------------
    def _run_aggregate(self, query: Query,
                       segments: List[SegmentDescriptor]):
        use_rcache = (self.cache is not None
                      and self.cache_config.cacheable(query)
                      and self.cache_config.use_result_cache
                      and self._all_replicatable(segments))
        rkey = None
        if use_rcache:
            rkey = result_level_key(
                query, [f"{d.id}" for d in segments])
            hit = self.cache.get("result", rkey)
            if hit is not None:
                return hit

        # bound intervals by the queried segments' extents so every node
        # (and the broker finish) shares one finite bucket index space;
        # granularity "all" has a single bucket stamped with the query
        # interval start — leave it unbounded so the timestamp matches
        # single-process execution
        q2 = query
        if not query.granularity.is_all:
            lo = min(d.interval.start for d in segments)
            hi = max(d.interval.end for d in segments)
            bounded = []
            for iv in condense(query.intervals):
                x = iv.intersect(Interval(lo, hi))
                if x is not None and x.width > 0:
                    bounded.append(x)
            if not bounded:
                return []
            q2 = replace(query, intervals=tuple(bounded))

        parts, missing = self._scatter(q2, segments, rows_mode=False)
        if missing and not parts:
            # every replica exhausted with partials allowed: typed empty
            # partial — the caller learns exactly what is missing
            return PartialResult([], missing)
        ap = AggregatePartials.concat(parts)
        with qtrace.span("broker/merge", partials=len(ap.partials)):
            if isinstance(query, TimeseriesQuery):
                rows = engines.finish_timeseries(q2, ap)
            elif isinstance(query, TopNQuery):
                rows = engines.finish_topn(q2, ap)
            elif isinstance(query, GroupByQuery):
                rows = engines.finish_groupby(q2, ap)
            else:  # pragma: no cover
                raise TypeError(type(query).__name__)
        if missing:
            # a partial must never populate the result cache: the next
            # identical query would be served the hole forever
            return PartialResult(rows, missing)
        if use_rcache and self.cache_config.populate_result_cache:
            self.cache.put("result", rkey, rows)
        return rows

    def etag(self, query: Query):
        """Result-set identity for this query over the CURRENT timeline:
        hashed query key + exact segment-id set (the reference's
        X-Druid-ETag from CachingClusteredClient's etag computation).
        None when any replica is realtime (rows mutate under a stable
        segment id) or for nested/non-aggregate queries."""
        from druid_tpu_torch.engine.executor import apply_interval_chunking
        import hashlib
        if query.inner_query is not None or not _is_aggregate(query):
            return None
        try:
            q = apply_interval_chunking(query)
            segments = self._segments_to_query(q)
            if not segments or not self._all_replicatable(segments):
                return None
            raw = result_level_key(q, [f"{d.id}" for d in segments])
            # result-SHAPING context must distinguish etags (bySegment
            # returns unmerged per-segment rows under the same cache key);
            # volatile per-request keys must not
            ctx = {k: v for k, v in query.context_map.items()
                   if k not in ("queryId", "timeout", "priority", "lane")}
            if ctx:
                import json as _json
                raw += "|ctx:" + _json.dumps(ctx, sort_keys=True)
            return hashlib.sha1(raw.encode()).hexdigest()
        except Exception:
            # etag is an optimization, never a failure
            logging.getLogger(__name__).debug(
                "etag computation failed; serving without one",
                exc_info=True)
            return None

    def _all_replicatable(self, segments: List[SegmentDescriptor]) -> bool:
        """True when no queried segment is served by a realtime server.
        A sink's rows grow between queries under a STABLE segment id, so a
        result cached while any replica is realtime would be served stale
        forever (the reference's CachingClusteredClient caches only
        segment-replicatable servers)."""
        for d in segments:
            rs = self.view.replica_set(d.id)
            if rs is None:
                continue
            for server in rs.servers:
                node = self.view.node(server)
                if node is not None and \
                        not getattr(node, "segment_replicatable", True):
                    return False
        return True

    # ---- row path -------------------------------------------------------
    def _run_rows(self, query: Query, segments: List[SegmentDescriptor]):
        q2 = query
        if isinstance(query, ScanQuery) and (query.limit is not None
                                             or query.offset):
            # nodes can't apply the global offset; ask for offset+limit rows
            # (unlimited when limit is None) and apply offset at the broker
            lim = None if query.limit is None else query.limit + query.offset
            q2 = replace(query, limit=lim, offset=0)
        results, missing = self._scatter(q2, segments, rows_mode=True)
        rows = self._merge_rows(query, results, segments)
        return PartialResult(rows, missing) if missing else rows

    # ---- scatter + retry + hedging (RetryQueryRunner) ------------------
    def _scatter(self, query: Query, segments: List[SegmentDescriptor],
                 rows_mode: bool):
        """Returns (gathered results, missing segment ids). The missing
        set is non-empty ONLY when the query allows partial results —
        otherwise exhausted replicas raise exactly as before."""
        with qtrace.span("broker/scatter",
                         segments=len(segments)) as scatter_span:
            return self._scatter_rounds(query, segments, rows_mode,
                                        scatter_span)

    def _scatter_rounds(self, query: Query,
                        segments: List[SegmentDescriptor],
                        rows_mode: bool, scatter_span):
        # cancel token + deadline ride the whole scatter (QueryContexts
        # timeout; DELETE /druid/v2/{id} trips the token)
        qid = query.context_map.get("queryId")
        token = self.query_manager.token(qid)
        deadline = Deadline.for_query(query)
        total_ms = context_timeout_ms(query)
        res = self.resilience
        allow_partial = allows_partial(query)
        circuits = res.circuits if res.policy.circuit_enabled else None
        pending: Dict[str, SegmentDescriptor] = {d.id: d for d in segments}
        tried: Dict[str, Set[str]] = {d.id: set() for d in segments}
        seg_errors: Dict[str, BaseException] = {}
        # 429 sheds per segment: ONE other replica gets a chance to absorb
        # a shed segment set before the capacity error surfaces
        capacity_attempts: Dict[str, int] = {}
        gathered = []
        hedges_left = res.policy.hedge_max_per_query \
            if hedging_enabled(res.policy, query) else 0
        for _ in range(self.max_retries + 1):
            if not pending:
                break
            if token is not None:
                token.check()
            if deadline.expired() \
                    or res.deadline_nearly_spent(deadline, total_ms):
                if allow_partial:
                    # another round cannot finish inside the remaining
                    # budget: degrade to a typed partial now instead of
                    # burning the rest of the deadline into a 504
                    break
                deadline.check()
            # each round carries only the REMAINING time budget, so retries
            # cannot stretch the query past its context timeout
            remaining = deadline.remaining_ms()
            q_round = query if remaining is None else replace(
                query, context=tuple(sorted(
                    {**query.context_map, "timeout": remaining}.items())))
            # group by chosen server (selection skips open circuits while
            # any closed replica remains; all-open falls back as a probe)
            by_server: Dict[str, List[str]] = {}
            for sid in pending:
                rs = self.view.replica_set(sid)
                server = rs.pick(self.rng, exclude=tried[sid],
                                 strategy=self.selector_strategy,
                                 view=self.view,
                                 circuits=circuits) if rs else None
                if server is not None:
                    by_server.setdefault(server, []).append(sid)
            if not by_server:
                break
            hedges_left = self._run_wave(
                q_round, by_server, rows_mode, scatter_span, token, qid,
                deadline, allow_partial, hedges_left, pending, tried,
                seg_errors, capacity_attempts, gathered)
            saturated = [sid for sid, shed in capacity_attempts.items()
                         if sid in pending and shed > 1]
            if saturated:
                # the one-other-replica retry was shed too: the tier is
                # saturated — surface the 429 now (one saturated node is
                # not a saturated tier, but two are — don't hammer the
                # rest), or degrade when the query allows partials
                if allow_partial:
                    break
                raise seg_errors[saturated[-1]]
        if pending:
            if allow_partial:
                # typed degradation: the caller wraps the merged rows in
                # a PartialResult carrying this exact missing set
                res.stats.note_partial(len(pending))
                return gathered, set(pending)
            # a spent deadline is a timeout, not a replica problem — the
            # wave abandons in-flight stragglers when it expires, so the
            # strict contract surfaces the 504 here
            deadline.check()
            errs = [seg_errors[sid] for sid in pending if sid in seg_errors]
            if errs:
                raise errs[-1]
            raise MissingSegmentsError(list(pending))
        return gathered, set()

    def _run_wave(self, q_round: Query, by_server: Dict[str, List[str]],
                  rows_mode: bool, scatter_span, token, qid,
                  deadline: Deadline, allow_partial: bool,
                  hedges_left: int, pending, tried, seg_errors,
                  capacity_attempts, gathered) -> int:
        """One scatter wave with tail hedging. Primaries fan out on the
        broker pool; when a straggler exceeds its EWMA-derived hedge
        delay, its still-pending segment set is re-issued on one other
        replica. Responses CLAIM the segments they served under a
        first-complete-wins rule: a response whose served set intersects
        segments already claimed by its rival is dropped WHOLE (a fused
        AggregatePartials cannot be split per segment), which makes
        double-merging a hedge-won segment structurally impossible. A
        call that can no longer win anything is remote-cancelled through
        the same node.cancel hook the query token registers. Returns the
        remaining per-query hedge budget."""
        res = self.resilience
        pool = self._ensure_pool()
        claimed: Set[str] = set()
        futures: Dict[object, _ScatterCall] = {}
        for server, sids in by_server.items():
            call = _ScatterCall(server, sids, is_hedge=False)
            futures[pool.submit(self._call_node, call, q_round, rows_mode,
                                scatter_span, token, qid)] = call
            for sid in sids:
                tried[sid].add(server)
        live = set(futures)
        hedged: Set[str] = set()

        def collect(f):
            # collect() only ever receives futures from wait_futures'
            # `done` set — result() returns immediately, it cannot park
            call, result, served, exc = f.result()
            if exc is None:
                if result is not None and not (served & claimed):
                    claimed.update(served)
                    gathered.append(result)
                    for sid in served:
                        pending.pop(sid, None)
                    if call.is_hedge and served:
                        res.stats.note_hedge_won()
                    return
                # a response racing a rival that already claimed any of
                # its segments is dropped WHOLE — never double-merged.
                # The server answered fine though: segments of its that
                # nobody claimed must stay retryable THERE, or a
                # partially-overlapping hedge win would strand them with
                # no untried replica (found by the dead+hedge chaos
                # scenario)
                for sid in served - claimed:
                    if sid in pending:
                        tried[sid].discard(call.server)
                return
            unclaimed = [sid for sid in call.sids if sid not in claimed]
            if isinstance(exc, QueryInterruptedError):
                if token is not None and token.cancelled():
                    raise exc     # genuine DELETE: abort the scatter
                if not unclaimed:
                    # our own loser-cancel answered with the interrupt —
                    # nothing to record, its segments are all claimed
                    return
                if not allow_partial:
                    # segments still live means this was NOT our loser
                    # cancel: someone interrupted the query node-side —
                    # surface the true error (the old abort contract),
                    # don't let it degrade into MissingSegmentsError
                    raise exc
                res.circuits.on_failure(call.server)
                for sid in unclaimed:
                    seg_errors[sid] = exc
                return
            if isinstance(exc, QueryTimeoutError) and not allow_partial:
                raise exc         # deadline: abort (the strict contract)
            # everything below is a per-server failure the circuit
            # breaker counts: sheds, timeouts (partial mode), dead and
            # sick nodes alike
            res.circuits.on_failure(call.server)
            if isinstance(exc, QueryCapacityError):
                # the node shed the query (and the client's one
                # Retry-After retry was shed again): ONE other replica
                # of the segment set gets a lane-aware try — the query
                # context (lane, priority) is resent unchanged
                self.view.note_capacity_shed(call.server)
                for sid in unclaimed:
                    seg_errors[sid] = exc
                    capacity_attempts[sid] = \
                        capacity_attempts.get(sid, 0) + 1
                return
            if isinstance(exc, ConnectionError):
                # unreachable server: plain failover; exhausting
                # replicas is a MissingSegmentsError
                return
            # a sick node (HTTP 500, crash mid-query) is retried on
            # another replica exactly like a missing segment (reference:
            # query/RetryQueryRunner.java:71-80); the error is kept PER
            # SEGMENT so exhausting replicas reports the real failure
            # for a segment that actually failed — not a recovered one's
            # stale error
            for sid in unclaimed:
                seg_errors[sid] = exc

        while live:
            if all(set(futures[f].sids) <= claimed for f in live):
                # nothing left to win: end the wave now instead of
                # paying the slowest straggler's full response time
                break
            timeout = self._wave_timeout(live, futures, hedged, deadline,
                                         hedges_left)
            done, live = wait_futures(live, timeout=timeout,
                                      return_when=FIRST_COMPLETED)
            for f in done:
                collect(f)
            self._cancel_stale_calls(live, futures, claimed, qid)
            if deadline.expired():
                # the bounded wait IS the no-hang guarantee: abandon
                # what is still in flight (best-effort cancel) and let
                # the terminal classification decide 504 vs partial
                self._abandon_calls(live, futures, qid)
                break
            if hedges_left > 0:
                hedges_left = self._issue_hedges(
                    live, futures, hedged, claimed, pending, tried,
                    hedges_left, pool, q_round, rows_mode, scatter_span,
                    token, qid)
        return hedges_left

    def _call_node(self, call: "_ScatterCall", q_round: Query,
                   rows_mode: bool, scatter_span, token, qid):
        """One server call on the broker pool. Never raises: the outcome
        (call, result, served, error) is classified by the wave collector,
        which knows whether the call's segments were already claimed by a
        hedge rival."""
        server, sids = call.server, call.sids
        node = self.view.node(server)
        if node is None:
            return call, None, set(), None
        # propagate a cancel to remote nodes with work in flight
        # (deduped per server across retry rounds)
        if token is not None and qid and hasattr(node, "cancel"):
            token.add_remote_cancel(lambda n=node: n.cancel(qid),
                                    key=server)
        # the pool worker re-activates the scatter span, times this
        # node's response as broker/node, and stamps the span as the
        # remote parent into the context it POSTs — the data node
        # re-roots its spans under it (qtrace wire propagation)
        with qtrace.attach(scatter_span), \
                qtrace.span("broker/node", server=server,
                            segments=len(sids),
                            hedge=call.is_hedge) as nsp:
            q_call = q_round if nsp is None \
                else qtrace.with_traceparent(q_round, nsp)
            self.view.connection_started(server)
            t0 = time.monotonic()
            try:
                if rows_mode:
                    result, served = node.run_rows(q_call, sids)
                else:
                    result, served = node.run_partials(q_call, sids)
                # feed the response time back into the view's per-server
                # EWMA — the NEXT wave's hedge delay derives from it
                self.view.note_latency(
                    server, (time.monotonic() - t0) * 1e3,
                    alpha=self.resilience.policy.latency_alpha)
                self.resilience.circuits.on_success(server)
                return call, result, set(served), None
            except BaseException as e:
                return call, None, set(), e
            finally:
                self.view.connection_finished(server)

    def _wave_timeout(self, live, futures, hedged: Set[str],
                      deadline: Deadline,
                      hedges_left: int) -> float:
        """How long the wave may block before something needs attention:
        the earliest un-hedged straggler's hedge deadline, bounded by the
        query deadline — and ALWAYS by MAX_WAVE_POLL_S: with no timeout
        context and hedging exhausted the wave re-arms each quantum
        instead of parking on the pool until the last straggler answers
        (every in-flight call carries its own connect/read timeout, so
        the re-armed wait is a liveness re-check, not a busy loop)."""
        cands = [self.MAX_WAVE_POLL_S]
        rem = deadline.remaining()
        if rem is not None:
            cands.append(rem)
        if hedges_left > 0:
            now = time.monotonic()
            for f in live:
                c = futures[f]
                if not c.is_hedge and c.server not in hedged:
                    delay = self.resilience.hedge_delay_s(self.view,
                                                          c.server)
                    cands.append(c.started + delay - now)
        return max(0.005, min(cands))

    def _issue_hedges(self, live, futures, hedged: Set[str],
                      claimed: Set[str], pending, tried, hedges_left: int,
                      pool, q_round: Query, rows_mode: bool, scatter_span,
                      token, qid) -> int:
        """Speculatively re-issue each overdue straggler's still-pending
        segment set on one other replica (one hedge per straggler call,
        bounded by the per-query hedge budget)."""
        res = self.resilience
        circuits = res.circuits if res.policy.circuit_enabled else None
        now = time.monotonic()
        for f in list(live):
            call = futures[f]
            if call.is_hedge or call.server in hedged:
                continue
            if now - call.started < res.hedge_delay_s(self.view,
                                                      call.server):
                continue
            hedged.add(call.server)
            h_by_server: Dict[str, List[str]] = {}
            for sid in call.sids:
                if sid not in pending or sid in claimed:
                    continue
                rs = self.view.replica_set(sid)
                srv = rs.pick(self.rng, exclude=tried[sid],
                              strategy=self.selector_strategy,
                              view=self.view,
                              circuits=circuits) if rs else None
                if srv is not None:
                    h_by_server.setdefault(srv, []).append(sid)
            for srv, sids in h_by_server.items():
                if hedges_left <= 0:
                    break
                hedges_left -= 1
                res.stats.note_hedge_issued()
                hcall = _ScatterCall(srv, sids, is_hedge=True)
                fut = pool.submit(self._call_node, hcall, q_round,
                                  rows_mode, scatter_span, token, qid)
                futures[fut] = hcall
                live.add(fut)
                for sid in sids:
                    tried[sid].add(srv)
        return hedges_left

    def _cancel_stale_calls(self, live, futures, claimed: Set[str],
                            qid) -> None:
        """Remote-cancel in-flight calls that can no longer win anything
        (every segment they carry is claimed by a rival response) —
        unless the same server still runs another live call for this
        query, because the cancel is qid-wide on the node. Fired through
        the same node.cancel hook the query token's remote-cancel
        propagation uses (QueryToken._fire: off-thread, best-effort)."""
        if not qid:
            return
        for f in list(live):
            call = futures[f]
            if call.cancel_sent or not call.sids \
                    or not set(call.sids) <= claimed:
                continue
            if any(g is not f and futures[g].server == call.server
                   and not set(futures[g].sids) <= claimed
                   for g in live):
                continue
            call.cancel_sent = True
            node = self.view.node(call.server)
            if node is None or not hasattr(node, "cancel"):
                continue
            self.resilience.stats.note_hedge_cancelled()
            QueryToken._fire([lambda n=node: n.cancel(qid)])

    def _abandon_calls(self, live, futures, qid) -> None:
        """Deadline-abandoned calls: best-effort cancel per server so a
        hung node stops holding broker pool workers past the query."""
        if not qid:
            return
        seen: Set[str] = set()
        for f in live:
            call = futures[f]
            if call.cancel_sent or call.server in seen:
                continue
            seen.add(call.server)
            call.cancel_sent = True
            node = self.view.node(call.server)
            if node is None or not hasattr(node, "cancel"):
                continue
            QueryToken._fire([lambda n=node: n.cancel(qid)])

    # ---- row merges (QueryToolChest.mergeResults analogs) --------------
    def _merge_rows(self, query: Query, results: List[List[dict]],
                    segments: List[SegmentDescriptor]):
        if _is_aggregate(query) and query.context_map.get("bySegment"):
            merged = [r for rows in results for r in rows]
            merged.sort(key=lambda r: r["result"]["segment"])
            return merged
        if isinstance(query, ScanQuery):
            batches = [b for rows in results for b in rows]
            if query.order != "none":
                iv_of = {d.id: d.interval.start for d in segments}
                batches.sort(key=lambda b: iv_of.get(b["segmentId"], 0),
                             reverse=(query.order == "descending"))
            if query.limit is not None or query.offset:
                batches, _, _ = _slice_scan_batches(
                    batches, query.offset, query.limit)
            return batches
        if isinstance(query, TimeBoundaryQuery):
            mn, mx = None, None
            for rows in results:
                for r in rows:
                    res = r["result"]
                    if "minTime" in res:
                        mn = res["minTime"] if mn is None \
                            else min(mn, res["minTime"])
                    if "maxTime" in res:
                        mx = res["maxTime"] if mx is None \
                            else max(mx, res["maxTime"])
            if mn is None and mx is None:
                return []
            result = {}
            if query.bound in (None, "minTime"):
                result["minTime"] = mn
            if query.bound in (None, "maxTime"):
                result["maxTime"] = mx
            ts = mn if query.bound != "maxTime" else mx
            return [{"timestamp": ts, "result": result}]
        if isinstance(query, SearchQuery):
            hits: Dict[Tuple[str, str], int] = {}
            ts = None
            for rows in results:
                for r in rows:
                    ts = r["timestamp"] if ts is None \
                        else min(ts, r["timestamp"])
                    for e in r["result"]:
                        key = (e["dimension"], e["value"])
                        hits[key] = hits.get(key, 0) + e["count"]
            if not hits:
                return []
            entries = [{"dimension": d, "value": v, "count": c}
                       for (d, v), c in hits.items()]
            if query.sort == "strlen":
                entries.sort(key=lambda e: (len(e["value"]), e["value"],
                                            e["dimension"]))
            else:
                entries.sort(key=lambda e: (e["value"], e["dimension"]))
            return [{"timestamp": ts, "result": entries[: query.limit]}]
        if isinstance(query, (SegmentMetadataQuery, SelectQuery)):
            merged: List[dict] = []
            for rows in results:
                merged += rows
            return merged
        if isinstance(query, DataSourceMetadataQuery):
            best = None
            for rows in results:
                for r in rows:
                    t = r["result"].get("maxIngestedEventTime")
                    if best is None or (t is not None and t > best):
                        best = t
            return [] if best is None else \
                [{"timestamp": best,
                  "result": {"maxIngestedEventTime": best}}]
        raise TypeError(f"cannot merge {type(query).__name__}")
