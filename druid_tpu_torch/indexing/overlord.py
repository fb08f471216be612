"""Overlord: task queue, toolbox, and the local task runner.

The port's copy of the reference package's `indexing/overlord.py`: host
code over the port's modules.

Reference analogs (indexing-service/.../overlord/):
  TaskMaster/TaskQueue.java — task submission, state machine, persistence
  TaskLockbox.java          — via druid_tpu_torch/indexing/locks.py
  ForkingTaskRunner         — here a thread-pool runner (tasks are
    host-bound numpy work; indexing/forking.py is the process runner —
    multi-host runners would dispatch over the wire like RemoteTaskRunner)
  TaskToolbox + TaskActionClient — the peon-side service locator whose
    actions (lock acquire, segment push, transactional insert) all land on
    the overlord/metadata exactly like actions/SegmentTransactionalInsertAction
"""
from __future__ import annotations

import logging
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

from typing import TYPE_CHECKING

if TYPE_CHECKING:        # runtime import would cycle through coordination
    from druid_tpu_torch.coordination.latch import LeaderParticipant

from druid_tpu_torch.cluster.metadata import (MetadataStore, SegmentDescriptor,
                                              StaleTermError)
from druid_tpu_torch.data.segment import Segment
from druid_tpu_torch.indexing.locks import TaskLock, TaskLockbox
from druid_tpu_torch.indexing.task import Task, TaskStatus
from druid_tpu_torch.storage.deep import DeepStorage, InMemoryDeepStorage
from druid_tpu_torch.utils.intervals import Interval, condense

log = logging.getLogger(__name__)


class TaskToolbox:
    """What a running task may touch (reference TaskToolbox): metadata
    actions, the lockbox, deep storage push/pull, and (for supervisor
    tasks) the task runner to fan sub-tasks out on."""

    def __init__(self, metadata: MetadataStore, lockbox: TaskLockbox,
                 deep_storage: DeepStorage, task_runner=None,
                 fence_source: Optional[Callable[[], Optional[tuple]]] = None):
        """fence_source: supplies the overlord's CURRENT (service, term,
        holder) fencing token at publish time — read late, not captured at
        toolbox construction, so a task that outlives a leadership change
        publishes with the stale term and is rejected."""
        self.metadata = metadata
        self.lockbox = lockbox
        self.deep_storage = deep_storage
        self.task_runner = task_runner
        self.fence_source = fence_source

    def lock(self, task: Task, intervals: Sequence[Interval],
             lock_type=None) -> Optional[TaskLock]:
        """LockAcquireAction: one lock covering the task's intervals.
        Appending tasks take SHARED locks so parallel sub-tasks / streaming
        replicas can append to one interval concurrently."""
        from druid_tpu_torch.indexing.locks import LockType
        lt = lock_type or LockType.EXCLUSIVE
        locks = []
        for iv in condense(intervals):
            l = self.lockbox.acquire(task.id, task.datasource, iv,
                                     priority=task.priority, lock_type=lt)
            if l is None:
                self.lockbox.release_all(task.id)
                return None
            locks.append(l)
        return locks[0] if locks else None

    def push(self, segment: Segment, descriptor: SegmentDescriptor
             ) -> SegmentDescriptor:
        return self.deep_storage.push(segment, descriptor)

    def pull(self, descriptor: SegmentDescriptor) -> Optional[Segment]:
        return self.deep_storage.pull(descriptor)

    def publish(self, task: Task,
                descriptors: Sequence[SegmentDescriptor]) -> bool:
        """SegmentTransactionalInsertAction: the revocation check and the
        metadata commit run in one lockbox critical section so a revoke
        cannot interleave between them (TaskLockbox.doInCriticalSection)."""
        fence = self.fence_source() if self.fence_source is not None else None
        return self.lockbox.critical_section(
            task.id, lambda: self.metadata.publish_segments(descriptors,
                                                            fence=fence))


class Overlord:
    """Task queue + local thread runner + status persistence.

    With a `leader` participant attached (coordination.LeaderParticipant —
    the TaskMaster leadership gating) task submission is accepted ONLY on
    the leader (NotLeaderError carries the leader's URL for redirect), and
    every task-metadata write and segment publish is fenced with the
    current term, so tasks started under a deposed overlord cannot commit
    past its successor's takeover."""

    def __init__(self, metadata: MetadataStore,
                 deep_storage: Optional[DeepStorage] = None,
                 max_workers: int = 4,
                 leader: Optional["LeaderParticipant"] = None):
        self.metadata = metadata
        self.deep_storage = deep_storage or InMemoryDeepStorage()
        self.lockbox = TaskLockbox()
        self.leader = leader
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._futures: Dict[str, Future] = {}
        self._statuses: Dict[str, TaskStatus] = {}
        self._lock = threading.Lock()
        self._listeners: List[Callable[[TaskStatus], None]] = []

    def _fence(self) -> Optional[tuple]:
        return self.leader.fence() if self.leader is not None else None

    def _require_leader(self) -> None:
        if self.leader is not None and not self.leader.is_leader():
            from druid_tpu_torch.coordination.latch import NotLeaderError
            url = None
            try:
                lease = self.leader.store.read(self.leader.service)
                if lease is not None:
                    url = lease.url
            except Exception:
                log.debug("could not resolve current leader url for "
                          "redirect", exc_info=True)
            raise NotLeaderError(
                f"overlord [{self.leader.node_id}] is not the leader",
                leader_url=url)

    def toolbox(self) -> TaskToolbox:
        # sub-tasks get DEDICATED threads: a supervisor task blocks one of
        # the bounded pool's workers while awaiting its sub-tasks, so
        # scheduling those on the same pool deadlocks under exhaustion
        return TaskToolbox(self.metadata, self.lockbox, self.deep_storage,
                           task_runner=_DedicatedSubtaskRunner(self),
                           fence_source=self._fence)

    def add_listener(self, fn: Callable[[TaskStatus], None]) -> None:
        self._listeners.append(fn)

    # ---- submission -----------------------------------------------------
    def submit(self, task: Task) -> str:
        self._require_leader()
        with self._lock:
            if task.id in self._futures:
                return task.id
            self.metadata.insert_task(task.id, task.datasource, "RUNNING",
                                      task.to_json(), fence=self._fence())
            self._statuses[task.id] = TaskStatus(task.id, "RUNNING")
            self._futures[task.id] = self._pool.submit(self._run, task)
            return task.id

    def _run(self, task: Task) -> TaskStatus:
        try:
            status = task.run(self.toolbox())
        except Exception as e:          # task crash = failure, not overlord crash
            status = TaskStatus.failure(task.id, e)
        finally:
            self.lockbox.release_all(task.id)
        with self._lock:
            self._statuses[task.id] = status
        try:
            self.metadata.update_task_status(task.id, status.state,
                                             fence=self._fence())
        except StaleTermError as e:
            # a deposed overlord may not record statuses — its successor
            # re-adopts the task row; in-memory status stands
            log.warning("status write for [%s] fenced off: %s", task.id, e)
        for fn in list(self._listeners):
            fn(status)
        return status

    # ---- status ---------------------------------------------------------
    def status(self, task_id: str) -> Optional[TaskStatus]:
        with self._lock:
            return self._statuses.get(task_id)

    def await_task(self, task_id: str, timeout: float = 300.0) -> TaskStatus:
        fut = self._futures.get(task_id)
        if fut is None:
            raise KeyError(task_id)
        return fut.result(timeout=timeout)

    def run_task(self, task: Task, timeout: float = 300.0) -> TaskStatus:
        self.submit(task)
        return self.await_task(task.id, timeout)

    def shutdown(self):
        self._pool.shutdown(wait=True)


class _DedicatedSubtaskRunner:
    """Runs sub-tasks on their own threads (never the overlord's bounded
    pool) — see Overlord.toolbox. Status/lock bookkeeping goes through the
    overlord's _run so sub-tasks are observable like any other task."""

    def __init__(self, overlord: Overlord):
        self.overlord = overlord
        self._threads: Dict[str, threading.Thread] = {}
        self._results: Dict[str, TaskStatus] = {}

    def submit(self, task: Task) -> str:
        if task.id in self._threads:
            return task.id
        self.overlord.metadata.insert_task(task.id, task.datasource,
                                           "RUNNING", task.to_json(),
                                           fence=self.overlord._fence())

        def run():
            self._results[task.id] = self.overlord._run(task)

        t = threading.Thread(target=run, daemon=True)
        self._threads[task.id] = t
        t.start()
        return task.id

    def await_task(self, task_id: str, timeout: float = 600.0) -> TaskStatus:
        t = self._threads[task_id]
        t.join(timeout)
        if t.is_alive():
            raise TimeoutError(f"sub-task {task_id} still running")
        return self._results[task_id]
