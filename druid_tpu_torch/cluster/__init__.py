"""The serving path: a Broker that finds segments on each datasource's
timeline (InventoryView), scatters to the DataNodes holding their replicas
(in process, or over HTTP through a RemoteDataNodeClient per
DataNodeServer), retries, hedges and caches, and merges the nodes' partial
states (cluster/wire.py carries them over HTTP). `cluster/loadqueue.py`
loads segments from deep storage into a node (storage/deep.py), and
`cluster/chaos.py` faults the data plane. The coordinator, realtime
servers, lookups and the MetadataStore wait for later slices (ROADMAP)."""
from druid_tpu_torch.cluster.broker import Broker, MissingSegmentsError
from druid_tpu_torch.cluster.cache import (Cache, CacheConfig, HybridCache,
                                           LruCache, RemoteCacheClient,
                                           RemoteCacheServer)
from druid_tpu_torch.cluster.dataserver import (DataNodeServer,
                                                RemoteDataNodeClient,
                                                RemoteQueryError)
from druid_tpu_torch.cluster.metadata import (SegmentAllocationError,
                                              SegmentDescriptor,
                                              StaleTermError)
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
    "RemoteQueryError",
]
