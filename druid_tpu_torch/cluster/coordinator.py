"""Coordinator: the cluster control loop.

The port's copy of the reference package's `cluster/coordinator.py`: host
code over the port's modules.

Reference analogs (server/src/main/java/org/apache/druid/server/coordinator/):
  DruidCoordinator.java:95            — leader control loop
  helper/DruidCoordinatorRuleRunner   — apply load/drop rules
  rules/LoadRule.java, PeriodLoadRule, IntervalLoadRule, ForeverLoadRule,
  *DropRule                           — retention rules
  CostBalancerStrategy.java           — segment placement cost
  helper/DruidCoordinatorBalancer     — move segments between nodes
  ReplicationThrottler.java           — bound replica creation per run
  "markAsUnusedOvershadowedSegments"  — MVCC cleanup of overshadowed versions
  CoordinatorDynamicConfig.java       — runtime knobs

One `run_once()` = one coordinator period. Segments are pulled from a
`segment_source` (the deep-storage puller analog — see
storage/deep.py and storage/format_v2.py) and announced into the
InventoryView, which is what the broker routes by.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from druid_tpu_torch.cluster.metadata import MetadataStore, SegmentDescriptor
from druid_tpu_torch.cluster.timeline import (PartitionChunk,
                                              VersionedIntervalTimeline)
from druid_tpu_torch.cluster.view import DataNode, InventoryView
from druid_tpu_torch.cluster.shardspec import NoneShardSpec
from druid_tpu_torch.data.segment import Segment
from druid_tpu_torch.utils.intervals import Interval

MS_PER_DAY = 86_400_000


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

class Rule:
    def applies(self, d: SegmentDescriptor, now_ms: int) -> bool:
        raise NotImplementedError

    def is_load(self) -> bool:
        raise NotImplementedError

    tiered_replicants: Dict[str, int] = {}


@dataclass
class ForeverLoadRule(Rule):
    tiered_replicants: Dict[str, int] = field(
        default_factory=lambda: {"_default_tier": 2})

    def applies(self, d, now_ms):
        return True

    def is_load(self):
        return True


@dataclass
class PeriodLoadRule(Rule):
    """Load segments younger than `period_ms` (measured from segment
    interval end to now — reference PeriodLoadRule.appliesTo)."""
    period_ms: int = 30 * MS_PER_DAY
    include_future: bool = True
    tiered_replicants: Dict[str, int] = field(
        default_factory=lambda: {"_default_tier": 2})

    def applies(self, d, now_ms):
        if d.interval.end >= now_ms - self.period_ms:
            return self.include_future or d.interval.start <= now_ms
        return False

    def is_load(self):
        return True


@dataclass
class IntervalLoadRule(Rule):
    interval: Interval = None
    tiered_replicants: Dict[str, int] = field(
        default_factory=lambda: {"_default_tier": 2})

    def applies(self, d, now_ms):
        return self.interval.contains_interval(d.interval)

    def is_load(self):
        return True


@dataclass
class ForeverDropRule(Rule):
    def applies(self, d, now_ms):
        return True

    def is_load(self):
        return False


@dataclass
class PeriodDropRule(Rule):
    """Drop segments entirely older than `period_ms`."""
    period_ms: int = 365 * MS_PER_DAY

    def applies(self, d, now_ms):
        return d.interval.end < now_ms - self.period_ms

    def is_load(self):
        return False


@dataclass
class IntervalDropRule(Rule):
    interval: Interval = None

    def applies(self, d, now_ms):
        return self.interval.contains_interval(d.interval)

    def is_load(self):
        return False


def rule_from_json(j: dict) -> Rule:
    t = j["type"]
    reps = j.get("tieredReplicants", {"_default_tier": 2})
    if t == "loadForever":
        return ForeverLoadRule(dict(reps))
    if t == "loadByPeriod":
        return PeriodLoadRule(int(j.get("periodMs", 30 * MS_PER_DAY)),
                              j.get("includeFuture", True), dict(reps))
    if t == "loadByInterval":
        return IntervalLoadRule(Interval.parse(j["interval"]), dict(reps))
    if t == "dropForever":
        return ForeverDropRule()
    if t == "dropByPeriod":
        return PeriodDropRule(int(j.get("periodMs", 365 * MS_PER_DAY)))
    if t == "dropByInterval":
        return IntervalDropRule(Interval.parse(j["interval"]))
    raise ValueError(f"unknown rule type {t!r}")


DEFAULT_RULES = [ForeverLoadRule()]


# ---------------------------------------------------------------------------
# Placement cost (CostBalancerStrategy)
# ---------------------------------------------------------------------------

_HALF_LIFE_MS = 7 * MS_PER_DAY


def _interval_cost(a: Interval, b: Interval) -> float:
    """Exponential-decay proximity cost between two segment intervals —
    co-locating temporally-close segments is expensive because queries hit
    them together (the insight of CostBalancerStrategy.computeJointSegmentsCost)."""
    gap = max(b.start - a.end, a.start - b.end, 0)
    return math.exp(-gap / _HALF_LIFE_MS)


def placement_cost(d: SegmentDescriptor, server_segments:
                   Sequence[SegmentDescriptor]) -> float:
    cost = 0.0
    for s in server_segments:
        c = _interval_cost(d.interval, s.interval)
        if s.datasource == d.datasource:
            c *= 2.0
        cost += c
    return cost


@dataclass
class DynamicConfig:
    """CoordinatorDynamicConfig analog."""
    max_segments_to_move: int = 5
    replication_throttle_limit: int = 10
    max_non_primary_replicants: int = 10_000
    max_segments_in_node_loading_queue: int = 100


@dataclass
class CoordinatorStats:
    assigned: int = 0
    dropped: int = 0
    moved: int = 0
    overshadowed_marked: int = 0
    deleted: int = 0
    unassigned: int = 0
    nodes_removed: int = 0
    #: True when the cycle was a no-op because this node is not the leader
    skipped_not_leader: bool = False
    #: fencing term the cycle's writes carried (-1 when unfenced)
    leader_term: int = -1


class Coordinator:
    """Leader-elected control loop. With a `leader` participant attached
    (coordination.LeaderParticipant — the CuratorDruidLeaderSelector
    analog) the duty cycle runs ONLY while holding the lease, and every
    metadata write carries the lease's fencing term so a deposed
    coordinator's in-flight writes are rejected by the store
    (StaleTermError) instead of corrupting its successor's state."""

    def __init__(self, metadata: MetadataStore, view: InventoryView,
                 segment_source: Callable[[SegmentDescriptor], Segment],
                 config: Optional[DynamicConfig] = None,
                 async_loading: bool = False,
                 leader=None):
        """async_loading=True assigns loads through per-server
        LoadQueuePeons (bounded queues, background workers) instead of
        blocking the cycle on each segment pull — the reference's
        LoadQueuePeon model. The announcement then happens when the worker
        finishes, so a load counts as `assigned` when enqueued."""
        self.metadata = metadata
        self.view = view
        self.segment_source = segment_source
        self.config = config or DynamicConfig()
        self.async_loading = async_loading
        self.leader = leader
        self._peons: Dict[str, "LoadQueuePeon"] = {}

    def _fence(self) -> Optional[tuple]:
        return self.leader.fence() if self.leader is not None else None

    def _peon_for(self, node: DataNode) -> "LoadQueuePeon":
        from druid_tpu_torch.cluster.loadqueue import LoadQueuePeon
        peon = self._peons.get(node.name)
        if peon is None:
            peon = self._peons[node.name] = LoadQueuePeon(
                node, self.view, self.segment_source,
                max_queue_size=self.config.max_segments_in_node_loading_queue)
        return peon

    def wait_loads(self, timeout: float = 30.0) -> bool:
        """Drain every peon queue (tests / controlled handover)."""
        return all(p.wait_idle(timeout) for p in self._peons.values())

    def stop(self) -> None:
        for p in self._peons.values():
            p.stop()

    # ---- one coordinator period ---------------------------------------
    def run_once(self, now_ms: Optional[int] = None) -> CoordinatorStats:
        now_ms = int(time.time() * 1000) if now_ms is None else now_ms
        stats = CoordinatorStats()
        if self.leader is not None:
            # duty loops idle entirely on non-leaders — not even liveness
            # probes run, so a standby is invisible to the cluster until
            # promoted (DruidCoordinator.coordinatorLeaderSelector gating)
            if not self.leader.is_leader():
                stats.skipped_not_leader = True
                return stats
            stats.leader_term = self.leader.term
        # failure detection first: dead servers leave the view (their
        # announcements retract), so this same cycle's rule run sees the
        # replica deficit and re-replicates from deep storage
        dead = self.view.check_liveness()
        stats.nodes_removed = len(dead)
        for name in dead:
            # a removed server's peon must stop, or its queued loads would
            # ghost-announce for a node no broker can reach. No join: a
            # worker mid-pull must not stall failure detection (the worker
            # already refuses to announce for unregistered nodes)
            peon = self._peons.pop(name, None)
            if peon is not None:
                peon.stop(join=False)
        self._mark_overshadowed(stats)
        used = self.metadata.used_segments()
        self._run_rules(used, now_ms, stats)
        self._balance(stats)
        return stats

    # ---- MVCC cleanup ---------------------------------------------------
    def _mark_overshadowed(self, stats: CoordinatorStats) -> None:
        """Build a metadata timeline per datasource and mark fully
        overshadowed segments unused (atomic replacement completion)."""
        by_ds: Dict[str, List[SegmentDescriptor]] = {}
        for d in self.metadata.used_segments():
            by_ds.setdefault(d.datasource, []).append(d)
        for ds, descs in by_ds.items():
            tl: VersionedIntervalTimeline = VersionedIntervalTimeline()
            for d in descs:
                spec = d.shard_spec or NoneShardSpec(d.partition)
                tl.add(d.interval, d.version, PartitionChunk(spec, d))
            doomed = []
            for holder in tl.find_fully_overshadowed():
                doomed += [c.obj.id for c in holder.partitions]
            if doomed:
                stats.overshadowed_marked += self.metadata.mark_unused(
                    doomed, fence=self._fence())

    # ---- rules ----------------------------------------------------------
    def _rules_for(self, datasource: str) -> List[Rule]:
        payload = self.metadata.rules_for(datasource)
        if not payload:
            return list(DEFAULT_RULES)
        return [rule_from_json(j) for j in payload]

    def _nodes_by_tier(self) -> Dict[str, List[DataNode]]:
        # only segment-replicatable (historical) servers participate in
        # rule-driven load/drop/balancing — realtime servers announce their
        # own in-flight sinks and manage their own lifecycle (the reference's
        # DruidCluster keeps realtime servers out of coordinator duties)
        tiers: Dict[str, List[DataNode]] = {}
        for n in self.view.nodes():
            if getattr(n, "segment_replicatable", True):
                tiers.setdefault(n.tier, []).append(n)
        return tiers

    def _run_rules(self, used: List[SegmentDescriptor], now_ms: int,
                   stats: CoordinatorStats) -> None:
        tiers = self._nodes_by_tier()
        served_by: Dict[str, List[SegmentDescriptor]] = {
            n.name: self.view.served_segments(n.name)
            for ns in tiers.values() for n in ns}
        # one pending-set snapshot per peon per cycle (not one lock take
        # per segment x peon)
        pending_by_server = {name: peon.pending_ids()
                             for name, peon in self._peons.items()} \
            if self.async_loading else {}
        replicas_created = 0
        rules_cache: Dict[str, List[Rule]] = {}
        for d in used:
            rules = rules_cache.get(d.datasource)
            if rules is None:
                rules = rules_cache[d.datasource] = \
                    self._rules_for(d.datasource)
            rule = next((r for r in rules if r.applies(d, now_ms)), None)
            if rule is None or not rule.is_load():
                # drop from every HISTORICAL server holding it; a realtime
                # server's sink announcement is its own to retract (handoff)
                rs = self.view.replica_set(d.id)
                if rs is not None:
                    for server in sorted(rs.servers):
                        node = self.view.node(server)
                        if node is not None and \
                                not getattr(node, "segment_replicatable", True):
                            continue
                        if node is not None:
                            node.drop_segment(d.id)
                        self.view.unannounce(server, d.id)
                        stats.dropped += 1
                continue
            rs = self.view.replica_set(d.id)
            announced = set(rs.servers) if rs is not None else set()
            holders = set(announced)
            pending_holders = set()
            if self.async_loading:
                # an enqueued-but-unannounced load counts as a holder, or
                # every cycle until the worker finishes would pile extra
                # replicas onto OTHER nodes (currentlyLoading accounting)
                pending_holders = {name for name, ids in pending_by_server
                                   .items() if d.id in ids}
                holders |= pending_holders
            for tier, wanted in rule.tiered_replicants.items():
                nodes = tiers.get(tier, [])
                tier_holders = [n for n in nodes if n.name in holders]
                deficit = wanted - len(tier_holders)
                # drop excess ANNOUNCED replicas — but never while a load
                # for this segment is in flight: the "excess" may be a
                # balancer move's still-serving source, and dropping it
                # opens a zero-replica window until (or forever if) the
                # destination's load completes
                droppable = [] if pending_holders else \
                    [n for n in tier_holders if n.name in announced]
                while deficit < 0 and droppable:
                    victim = droppable.pop()
                    victim.drop_segment(d.id)
                    self.view.unannounce(victim.name, d.id)
                    served_by[victim.name] = [
                        s for s in served_by[victim.name] if s.id != d.id]
                    stats.dropped += 1
                    deficit += 1
                # assign missing replicas, throttled
                candidates = [n for n in nodes if n.name not in holders]
                while deficit > 0 and candidates:
                    is_primary = not holders
                    if not is_primary and \
                            replicas_created >= self.config.replication_throttle_limit:
                        break
                    best = min(candidates, key=lambda n: placement_cost(
                        d, served_by[n.name]))
                    if not self._load_on(best, d):
                        candidates.remove(best)
                        continue
                    served_by[best.name].append(d)
                    holders.add(best.name)
                    candidates.remove(best)
                    stats.assigned += 1
                    if not is_primary:
                        replicas_created += 1
                    deficit -= 1
                if deficit > 0:
                    stats.unassigned += deficit

    def _load_on(self, node: DataNode, d: SegmentDescriptor) -> bool:
        if self.async_loading:
            # enqueue-and-continue: the peon's worker pulls, loads, and
            # announces; a full queue defers to the next cycle
            return self._peon_for(node).load(d)
        segment = self.segment_source(d)
        if segment is None or not node.load_segment(segment, d):
            return False
        self.view.announce(node.name, d)
        return True

    # ---- balancing ------------------------------------------------------
    def _balance(self, stats: CoordinatorStats) -> None:
        """Move segments from loaded → underloaded nodes within a tier,
        min-cost placement (DruidCoordinatorBalancer + CostBalancerStrategy)."""
        for tier, nodes in self._nodes_by_tier().items():
            if len(nodes) < 2:
                continue
            moves_left = self.config.max_segments_to_move
            in_flight_out: Dict[str, int] = {}
            while moves_left > 0:
                # async: a scheduled move means src WILL lose one and dst
                # WILL gain one — account for it, or a gated worker makes
                # the stale counts re-move everything src holds
                counts = {}
                for n in nodes:
                    c = n.segment_count() - in_flight_out.get(n.name, 0)
                    if self.async_loading and n.name in self._peons:
                        c += self._peons[n.name].pending_count()
                    counts[n.name] = c
                src = max(nodes, key=lambda n: counts[n.name])
                dst = min(nodes, key=lambda n: counts[n.name])
                if counts[src.name] - counts[dst.name] < 2:
                    break
                dst_served = self.view.served_segments(dst.name)
                dst_ids = {d.id for d in dst_served}
                movable = [d for d in self.view.served_segments(src.name)
                           if d.id not in dst_ids]
                if self.async_loading:
                    dst_peon = self._peon_for(dst)
                    movable = [m for m in movable
                               if not dst_peon.is_pending(m.id)]
                if not movable:
                    break
                d = min(movable,
                        key=lambda m: placement_cost(m, dst_served))
                if self.async_loading:
                    # load-then-drop: the source replica must stay
                    # announced until the destination's worker FINISHES —
                    # dropping on enqueue would leave a window (or, on a
                    # failed load, an eternity) with zero replicas
                    def after(ok, s=src, dd=d):
                        if ok:
                            s.drop_segment(dd.id)
                            self.view.unannounce(s.name, dd.id)
                    if not self._peon_for(dst).load(d, callback=after):
                        break
                    in_flight_out[src.name] = \
                        in_flight_out.get(src.name, 0) + 1
                else:
                    if not self._load_on(dst, d):
                        break
                    src.drop_segment(d.id)
                    self.view.unannounce(src.name, d.id)
                stats.moved += 1
                moves_left -= 1

    # ---- auto-compaction (DruidCoordinatorSegmentCompactor +
    # NewestSegmentFirstPolicy) -------------------------------------------
    def schedule_compaction(self, overlord, datasource: str,
                            metric_specs,
                            min_segments_per_bucket: int = 2,
                            max_tasks: int = 1) -> List[str]:
        """Submit CompactionTasks for the newest intervals fragmented into
        >= min_segments_per_bucket MVCC-visible segments."""
        from druid_tpu_torch.indexing.task import CompactionTask
        by_bucket: Dict[Tuple[int, int], List[SegmentDescriptor]] = {}
        for d in self.metadata.visible_segments(datasource):
            by_bucket.setdefault((d.interval.start, d.interval.end),
                                 []).append(d)
        candidates = sorted(
            (b for b, descs in by_bucket.items()
             if len(descs) >= min_segments_per_bucket),
            key=lambda b: -b[0])    # newest first
        out = []
        for start, end in candidates[:max_tasks]:
            task = CompactionTask(datasource, Interval(start, end),
                                  metric_specs)
            out.append(overlord.submit(task))
        return out

    # ---- kill (permanent deletion of unused segments) -------------------
    def kill_unused(self, datasource: str) -> int:
        """KillTask analog: permanently delete unused segments' metadata."""
        ids = [d.id for d in self.metadata.unused_segments(datasource)]
        return self.metadata.delete_segments(ids, fence=self._fence())
