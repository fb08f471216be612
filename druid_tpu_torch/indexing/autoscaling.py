"""Worker autoscaling: provisioning decisions from task-queue pressure.

The port's copy of the reference package's `indexing/autoscaling.py`: host
code over the port's modules.

Reference analogs (indexing-service/src/main/java/org/apache/druid/
indexing/overlord/autoscaling/):
  PendingTaskBasedWorkerProvisioningStrategy.java — provision when pending
    tasks exceed spare capacity, terminate idle workers past the cooldown
  SimpleWorkerProvisioningStrategy.java — the threshold variant
  AutoScaler.java (EC2/GCE impls) — the SPI that actually creates and
    destroys workers; here a callable pair so deployments plug in
    k8s / GCE / anything

The strategy is pure decision logic over (pending tasks, workers) so it is
testable without any cloud; ScalingMonitor drives it from the overlord's
queue state on a period.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence


@dataclass
class WorkerInfo:
    """One worker the scaler manages (reference: Worker + its capacity).
    last_task_time defaults to NOW — a freshly provisioned worker must not
    read as idle-past-cooldown before its first task."""
    worker_id: str
    capacity: int = 1
    running_tasks: int = 0
    last_task_time: float = field(default_factory=time.monotonic)


@dataclass
class ProvisioningConfig:
    """(workerCapacityHints + ProvisioningSchedulerConfig subset)."""
    min_workers: int = 0
    max_workers: int = 8
    worker_capacity: int = 2            # tasks per worker
    scale_up_step: int = 1              # workers per decision
    idle_seconds_before_terminate: float = 600.0


@dataclass
class ScalingDecision:
    provision: int = 0                  # workers to create
    terminate: List[str] = field(default_factory=list)  # worker ids to kill


class PendingTaskProvisioningStrategy:
    """Provision when pending tasks exceed spare slots; terminate workers
    idle past the cooldown, never dropping below min_workers."""

    def __init__(self, config: Optional[ProvisioningConfig] = None):
        self.config = config or ProvisioningConfig()

    def compute(self, pending_tasks: int, workers: Sequence[WorkerInfo],
                now: Optional[float] = None) -> ScalingDecision:
        cfg = self.config
        now = time.monotonic() if now is None else now
        decision = ScalingDecision()

        # the floor provisions itself (reference strategy's minNumWorkers)
        if len(workers) < cfg.min_workers:
            decision.provision = min(cfg.min_workers - len(workers),
                                     cfg.scale_up_step)
            return decision

        spare = sum(max(w.capacity - w.running_tasks, 0) for w in workers)
        if pending_tasks > spare and len(workers) < cfg.max_workers:
            needed = -(-(pending_tasks - spare) // max(cfg.worker_capacity, 1))
            decision.provision = min(needed, cfg.scale_up_step,
                                     cfg.max_workers - len(workers))
            return decision      # never provision and terminate together

        idle = [w for w in workers
                if w.running_tasks == 0
                and now - w.last_task_time >= cfg.idle_seconds_before_terminate]
        # terminate oldest-idle first, keeping min_workers
        can_drop = len(workers) - cfg.min_workers
        if pending_tasks == 0 and can_drop > 0 and idle:
            idle.sort(key=lambda w: w.last_task_time)
            decision.terminate = [w.worker_id for w in idle[:can_drop]]
        return decision


class ScalingMonitor:
    """Drives the strategy on a period and applies decisions through the
    AutoScaler callables (ProvisioningScheduler analog). Callers provide
    `pending()` (e.g. overlord queue depth) and `workers()` snapshots."""

    def __init__(self, strategy: PendingTaskProvisioningStrategy,
                 pending: Callable[[], int],
                 workers: Callable[[], List[WorkerInfo]],
                 provision: Callable[[int], None],
                 terminate: Callable[[List[str]], None]):
        self.strategy = strategy
        self.pending = pending
        self.workers = workers
        self.provision = provision
        self.terminate = terminate
        self.history: List[ScalingDecision] = []

    def run_once(self, now: Optional[float] = None) -> ScalingDecision:
        decision = self.strategy.compute(self.pending(), self.workers(), now)
        if decision.provision:
            self.provision(decision.provision)
        if decision.terminate:
            self.terminate(decision.terminate)
        self.history.append(decision)
        return decision
