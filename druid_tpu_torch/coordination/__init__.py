"""HA coordination: lease-based leader election, fencing, discovery.

The port's copy of the reference package's `coordination/__init__.py`: host
code over the port's modules.

The control-plane counterpart of the reference's DruidLeaderSelector /
CuratorDruidLeaderSelector / DruidLeaderClient triple, backed by the SQL
metadata store instead of ZooKeeper, with fencing terms enforced at the
metadata-write layer and a chaos harness for failover testing.
"""
from druid_tpu_torch.coordination.chaos import (ChaosHarness, ManualClock,
                                                PartitionedError)
from druid_tpu_torch.coordination.discovery import (LeaderClient,
                                                    NoLeaderError)
from druid_tpu_torch.coordination.latch import (LeaderLease, LeaderMonitor,
                                                LeaderParticipant,
                                                LeaseStore,
                                                MetadataLeaseStore,
                                                NotLeaderError,
                                                StaleTermError)

__all__ = [
    "ChaosHarness", "ManualClock", "PartitionedError",
    "LeaderClient", "NoLeaderError",
    "LeaderLease", "LeaderMonitor", "LeaderParticipant", "LeaseStore",
    "MetadataLeaseStore", "NotLeaderError", "StaleTermError",
]
