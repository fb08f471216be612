"""Realtime query serving: in-flight sinks announced into the broker view.

The port's own copy of the reference package's `cluster/realtime.py`. The
server runs its sinks' hydrants on its own device (`device=None`: CUDA,
through device.resolve; "cpu" runs the plain PyTorch versions), as a
DataNode does.

Reference analog: SinkQuerySegmentWalker (server/src/main/java/org/apache/
druid/segment/realtime/appenderator/SinkQuerySegmentWalker.java) — the piece
that makes streaming data queryable seconds after ingest THROUGH THE NORMAL
BROKER PATH, not via a side channel. The indexing process announces each
allocated sink as a served segment (the reference announces via ZK from the
peon; here the announcement goes straight into the InventoryView), the
broker's timeline then routes the segment to this server, and partials from
the sink's hydrants merge with historical partials exactly like any other
scatter-gather leg.

Handoff is seamless by identity: the published historical segment carries
the SAME (datasource, interval, version, partition) id, so its announcement
joins the sink's ReplicaSet; when the driver drops the sink after a
successful publish, unannouncing here leaves the historical replica serving.
"""
from __future__ import annotations

import threading
from typing import List, Sequence, Set, Tuple

from druid_tpu_torch import device as device_mod
from druid_tpu_torch.cluster.metadata import SegmentDescriptor
from druid_tpu_torch.cluster.shardspec import NumberedShardSpec
from druid_tpu_torch.cluster.view import InventoryView
from druid_tpu_torch.data.segment import Segment
from druid_tpu_torch.engine.engines import (AggregatePartials,
                                            make_aggregate_partials)
from druid_tpu_torch.query.model import Query


class RealtimeServer:
    """A queryable node surface over one or more Appenderators.

    Implements the same duck-typed node API the broker drives (DataNode /
    RemoteDataNodeClient): run_partials / run_rows / segments / alive.
    Results are never cached (in-flight data mutates between queries — the
    reference's CachingClusteredClient also skips caching realtime sinks).
    """

    #: broker result caching + coordinator segment management are disabled
    #: for this server (CachingClusteredClient.segmentReplicatable analog)
    segment_replicatable = False

    def __init__(self, name: str, view: InventoryView,
                 tier: str = "_realtime", device=None):
        self.name = name
        self.view = view
        self.tier = tier
        self.device = device_mod.resolve(device)
        self.alive = True
        self.cache = None
        self._apps: List[object] = []
        self._lock = threading.RLock()
        view.register(self)

    def attach(self, appenderator) -> None:
        """Start announcing an appenderator's sinks (existing + future)."""
        with self._lock:
            self._apps.append(appenderator)
        appenderator.add_listener(self)

    # ---- Appenderator sink lifecycle listener --------------------------
    def sink_created(self, ident) -> None:
        self.view.announce(self.name, self._descriptor(ident))

    def sink_dropped(self, ident) -> None:
        self.view.unannounce(self.name, ident.id)

    @staticmethod
    def _descriptor(ident) -> SegmentDescriptor:
        return SegmentDescriptor(
            ident.datasource, ident.interval, ident.version, ident.partition,
            NumberedShardSpec(ident.partition, 0))

    # ---- node query surface (duck-typed DataNode) ----------------------
    def _select(self, segment_ids: Sequence[str]
                ) -> Tuple[List[Segment], Set[str]]:
        segs: List[Segment] = []
        served: Set[str] = set()
        with self._lock:
            apps = list(self._apps)
        for sid in segment_ids:
            for app in apps:
                hydrants = app.sink_segments(str(sid))
                if hydrants is not None:
                    segs += hydrants
                    served.add(str(sid))
                    break
        return segs, served

    def run_partials(self, query: Query, segment_ids: Sequence[str],
                     check=None) -> Tuple[AggregatePartials, Set[str]]:
        if not self.alive:
            raise ConnectionError(f"server [{self.name}] is down")
        segs, served = self._select(segment_ids)
        ap = make_aggregate_partials(query, segs, self.device, clamp=False)
        return ap, served

    def run_rows(self, query: Query, segment_ids: Sequence[str]
                 ) -> Tuple[List[dict], Set[str]]:
        if not self.alive:
            raise ConnectionError(f"server [{self.name}] is down")
        from druid_tpu_torch.engine.executor import QueryExecutor
        segs, served = self._select(segment_ids)
        rows = QueryExecutor(device=self.device).run(query, segments=segs)
        return rows, served

    # ---- inventory surface ---------------------------------------------
    def segments(self) -> List[Segment]:
        with self._lock:
            apps = list(self._apps)
        out: List[Segment] = []
        for app in apps:
            out += app.query_segments()
        return out

    def served_segment_ids(self) -> Set[str]:
        with self._lock:
            apps = list(self._apps)
        out: Set[str] = set()
        for app in apps:
            for ident in app.sink_ids():
                out.add(ident.id)
        return out

    def segment_count(self) -> int:
        return len(self.served_segment_ids())

    # the coordinator never manages realtime sinks; keep the node surface
    # total so a misdirected call is a no-op, not a crash
    def load_segment(self, segment, descriptor=None) -> bool:
        return False

    def drop_segment(self, segment_id: str) -> bool:
        return False

    def ping(self) -> bool:
        return self.alive
