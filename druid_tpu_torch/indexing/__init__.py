"""The indexing service: task locks, the task model (batch index, parallel
index, compaction, kill, move, archive, restore), the overlord with its
thread runner, the forking runner whose peons are subprocesses, and worker
autoscaling. The port's copy of the reference package's `indexing/`; every
task is host work (numpy), as in the reference."""
from druid_tpu_torch.indexing.locks import LockType, TaskLock, TaskLockbox
from druid_tpu_torch.indexing.task import (ArchiveTask, CompactionTask,
                                           IndexTask, KillTask, MoveTask,
                                           ParallelIndexTask, RestoreTask,
                                           Task, TaskStatus, task_from_json)
from druid_tpu_torch.indexing.overlord import Overlord, TaskToolbox
from druid_tpu_torch.indexing.forking import (ForkingTaskRunner,
                                              TaskActionServer)
from druid_tpu_torch.indexing.autoscaling import (
    PendingTaskProvisioningStrategy, ProvisioningConfig, ScalingMonitor,
    WorkerInfo)

__all__ = [
    "TaskLockbox", "TaskLock", "LockType", "Task", "TaskStatus", "IndexTask",
    "CompactionTask", "KillTask", "MoveTask", "ArchiveTask", "RestoreTask",
    "task_from_json", "Overlord", "TaskToolbox",
    "ForkingTaskRunner", "TaskActionServer", "ParallelIndexTask",
    "PendingTaskProvisioningStrategy", "ProvisioningConfig",
    "ScalingMonitor", "WorkerInfo",
]
