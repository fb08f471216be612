"""The serving path: a Broker that finds segments on each datasource's
timeline (InventoryView), scatters to the DataNodes holding their replicas
(in process, or over HTTP through a RemoteDataNodeClient per
DataNodeServer), retries, hedges and caches, and merges the nodes' partial
states (cluster/wire.py carries them over HTTP). `cluster/loadqueue.py`
loads segments from deep storage into a node (storage/deep.py), and
`cluster/chaos.py` faults the data plane. A RealtimeServer
(`cluster/realtime.py`) announces streaming ingestion's in-flight sinks
beside the DataNodes, so they answer through the broker before publish;
the MetadataStore (`cluster/metadata.py`) records published segments with
their stream offsets. The Coordinator (`cluster/coordinator.py`) decides
from the MetadataStore's used segments and their load/drop rules which
node loads which segment (through LoadQueuePeons when loading is
asynchronous), marks overshadowed versions unused and balances the nodes;
`cluster/lookups.py` keeps the nodes' lookups in step with the specs the
coordinator stores."""
from druid_tpu_torch.cluster.broker import Broker, MissingSegmentsError
from druid_tpu_torch.cluster.cache import (Cache, CacheConfig, HybridCache,
                                           LruCache, RemoteCacheClient,
                                           RemoteCacheServer)
from druid_tpu_torch.cluster.coordinator import (CoordinatorStats,
                                                 Coordinator, DynamicConfig,
                                                 ForeverDropRule,
                                                 ForeverLoadRule,
                                                 IntervalDropRule,
                                                 IntervalLoadRule,
                                                 PeriodDropRule,
                                                 PeriodLoadRule,
                                                 placement_cost,
                                                 rule_from_json)
from druid_tpu_torch.cluster.dataserver import (DataNodeServer,
                                                RemoteDataNodeClient,
                                                RemoteQueryError)
from druid_tpu_torch.cluster.lookups import (LookupCoordinatorManager,
                                             LookupNodeSync,
                                             register_namespace_loader)
from druid_tpu_torch.cluster.metadata import (MetadataStore,
                                              SegmentAllocationError,
                                              SegmentDescriptor,
                                              StaleTermError)
from druid_tpu_torch.cluster.realtime import RealtimeServer
from druid_tpu_torch.cluster.resilience import (BrokerResilience,
                                                PartialResult,
                                                ResilienceMetricsMonitor,
                                                ResiliencePolicy)
from druid_tpu_torch.cluster.shardspec import (HashBasedNumberedShardSpec,
                                               LinearShardSpec, NoneShardSpec,
                                               NumberedShardSpec, ShardSpec,
                                               SingleDimensionShardSpec,
                                               shardspec_from_json)
from druid_tpu_torch.cluster.timeline import (PartitionChunk, PartitionHolder,
                                              TimelineObjectHolder,
                                              VersionedIntervalTimeline)
from druid_tpu_torch.cluster.view import (DataNode, InventoryView,
                                          descriptor_for)

__all__ = [
    "ShardSpec", "NoneShardSpec", "LinearShardSpec", "NumberedShardSpec",
    "HashBasedNumberedShardSpec", "SingleDimensionShardSpec",
    "shardspec_from_json", "PartitionChunk", "PartitionHolder",
    "TimelineObjectHolder", "VersionedIntervalTimeline",
    "SegmentDescriptor", "SegmentAllocationError", "StaleTermError",
    "DataNode", "InventoryView", "descriptor_for", "Broker",
    "MissingSegmentsError", "LruCache", "Cache", "HybridCache",
    "RemoteCacheClient", "RemoteCacheServer", "CacheConfig",
    "ResiliencePolicy", "BrokerResilience", "PartialResult",
    "ResilienceMetricsMonitor", "DataNodeServer", "RemoteDataNodeClient",
    "RemoteQueryError", "MetadataStore", "RealtimeServer", "Coordinator",
    "CoordinatorStats", "DynamicConfig", "ForeverLoadRule", "PeriodLoadRule",
    "IntervalLoadRule", "ForeverDropRule", "PeriodDropRule",
    "IntervalDropRule", "rule_from_json", "placement_cost",
    "LookupCoordinatorManager", "LookupNodeSync",
    "register_namespace_loader",
]
