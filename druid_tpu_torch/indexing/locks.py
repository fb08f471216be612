"""Task interval locks.

The port's copy of the reference package's `indexing/locks.py`: host
code over the port's modules.

Reference analog: indexing-service/.../overlord/TaskLockbox.java — per
(datasource, interval) locks with priorities and revocation: a
higher-priority task may revoke a lower-priority task's lock; the revoked
task discovers this at its next action and fails. Lock versions become
segment versions (batch replace = new version over the interval).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import List, Optional

from druid_tpu_torch.utils.intervals import Interval, ts_to_iso


class LockType(Enum):
    EXCLUSIVE = "exclusive"
    SHARED = "shared"        # streaming appends to one interval share


@dataclass
class TaskLock:
    task_id: str
    datasource: str
    interval: Interval
    version: str
    priority: int = 0
    lock_type: LockType = LockType.EXCLUSIVE
    revoked: bool = False


class LockConflictError(RuntimeError):
    pass


class TaskLockbox:
    def __init__(self):
        self._locks: List[TaskLock] = []
        self._lock = threading.Lock()

    def acquire(self, task_id: str, datasource: str, interval: Interval,
                priority: int = 0,
                lock_type: LockType = LockType.EXCLUSIVE,
                version: Optional[str] = None) -> Optional[TaskLock]:
        """None = conflict with an equal/higher-priority lock. A strictly
        higher priority revokes conflicting lower-priority locks
        (TaskLockbox.revokeLock)."""
        with self._lock:
            conflicts = [l for l in self._locks
                         if l.datasource == datasource
                         and l.interval.overlaps(interval)
                         and l.task_id != task_id
                         and not l.revoked
                         and not (l.lock_type == LockType.SHARED
                                  and lock_type == LockType.SHARED)]
            for c in conflicts:
                if c.priority >= priority:
                    return None
            for c in conflicts:
                c.revoked = True
            # reuse this task's existing covering lock
            for l in self._locks:
                if l.task_id == task_id and l.datasource == datasource \
                        and l.interval.contains_interval(interval) \
                        and not l.revoked:
                    return l
            lock = TaskLock(task_id, datasource, interval,
                            version or ts_to_iso(int(time.time() * 1000)),
                            priority, lock_type)
            self._locks.append(lock)
            return lock

    def critical_section(self, task_id: str, fn):
        """Run fn() under the lockbox lock iff none of the task's locks are
        revoked (TaskLockbox.doInCriticalSection): revocation by a
        higher-priority task cannot interleave between the check and the
        action (e.g. a metadata publish)."""
        with self._lock:
            if any(l.task_id == task_id and l.revoked
                   for l in self._locks):
                return False
            return fn()

    def is_revoked(self, task_id: str) -> bool:
        with self._lock:
            return any(l.task_id == task_id and l.revoked
                       for l in self._locks)

    def locks_for(self, task_id: str) -> List[TaskLock]:
        with self._lock:
            return [l for l in self._locks if l.task_id == task_id]

    def release_all(self, task_id: str) -> None:
        with self._lock:
            self._locks = [l for l in self._locks if l.task_id != task_id]
