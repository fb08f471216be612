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
their stream offsets. The coordinator and lookups wait for a later slice
(ROADMAP A18)."""
from druid_tpu_torch.cluster.broker import Broker, MissingSegmentsError
from druid_tpu_torch.cluster.cache import (Cache, CacheConfig, HybridCache,
                                           LruCache, RemoteCacheClient,
                                           RemoteCacheServer)
from druid_tpu_torch.cluster.dataserver import (DataNodeServer,
                                                RemoteDataNodeClient,
                                                RemoteQueryError)
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
    "RemoteQueryError", "MetadataStore", "RealtimeServer",
]
