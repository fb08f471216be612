"""Per-server asynchronous segment load/drop queues.

The port's copy of the reference package's `cluster/loadqueue.py`. Reference
analog: server/src/main/java/org/apache/druid/server/coordinator/
LoadQueuePeon.java (+ HttpLoadQueuePeon): the coordinator never blocks on a
segment download — it enqueues load/drop requests per server, a worker
drains them (pull from deep storage, load, announce), callbacks fire on
completion, and the per-server queue depth bounds how much one cycle can
pile onto a node (maxSegmentsInNodeLoadingQueue).
"""
from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, List, Optional, Set

from druid_tpu_torch.cluster.metadata import SegmentDescriptor


class LoadQueuePeon:
    """One server's load/drop queue + worker thread."""

    def __init__(self, node, view, segment_source: Callable,
                 max_queue_size: Optional[int] = None):
        """segment_source: descriptor -> Segment (deep-storage pull, e.g.
        LocalDeepStorage.pull); a source that raises (a corrupt segment
        directory) records a failure and the worker goes on."""
        self.node = node
        self.view = view
        self.segment_source = segment_source
        self.max_queue_size = max_queue_size
        self._q: "queue.Queue[tuple]" = queue.Queue()
        self._pending: Set[str] = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self.loads_done = 0
        self.drops_done = 0
        self.failures: List[str] = []

    # ---- enqueue (coordinator side) ------------------------------------
    def load(self, descriptor: SegmentDescriptor,
             callback: Optional[Callable[[bool], None]] = None) -> bool:
        """Enqueue a load; False when the queue is full or already pending
        (the coordinator retries next cycle — exactly the reference's
        bounded-queue behavior)."""
        with self._lock:
            if descriptor.id in self._pending:
                return False
            if self.max_queue_size is not None \
                    and len(self._pending) >= self.max_queue_size:
                return False
            self._pending.add(descriptor.id)
        self._idle.clear()
        self._q.put(("load", descriptor, callback))
        return True

    def drop(self, descriptor: SegmentDescriptor,
             callback: Optional[Callable[[bool], None]] = None) -> bool:
        with self._lock:
            if descriptor.id in self._pending:
                return False
            self._pending.add(descriptor.id)
        self._idle.clear()
        self._q.put(("drop", descriptor, callback))
        return True

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def is_pending(self, segment_id: str) -> bool:
        with self._lock:
            return str(segment_id) in self._pending

    def pending_ids(self) -> Set[str]:
        """Snapshot of queued/in-flight segment ids (one lock hold — the
        coordinator's rules loop must not take this lock per segment)."""
        with self._lock:
            return set(self._pending)

    # ---- worker ---------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                op, d, callback = self._q.get(timeout=0.05)
            except queue.Empty:
                # set idle ONLY while provably drained: a load() racing
                # this branch must not let wait_idle() pass early
                with self._lock:
                    if not self._pending:
                        self._idle.set()
                continue
            ok = False
            try:
                if op == "load":
                    segment = self.segment_source(d)
                    ok = segment is not None \
                        and self.node.load_segment(segment, d)
                    if ok:
                        if self.view.node(self.node.name) is not None:
                            self.view.announce(self.node.name, d)
                            self.loads_done += 1
                        else:
                            # the server died while this sat queued: do
                            # not ghost-announce for an unregistered node
                            self.node.drop_segment(d.id)
                            ok = False
                else:
                    ok = self.node.drop_segment(d.id)
                    if ok:
                        self.view.unannounce(self.node.name, d.id)
                        self.drops_done += 1
                    else:
                        self.failures.append(f"drop {d.id}: not loaded")
            except Exception as e:   # a bad segment must not kill the peon
                self.failures.append(f"{op} {d.id}: {e}")
            finally:
                # callback BEFORE the idle signal: wait_idle() returning
                # means every completion effect (e.g. a balancer move's
                # drop-source) has been applied, not merely scheduled
                if callback is not None:
                    try:
                        callback(ok)
                    except Exception:
                        logging.getLogger(__name__).exception(
                            "completion callback for [%s %s] failed",
                            op, d.id)
                with self._lock:
                    self._pending.discard(d.id)
                    if not self._pending:
                        self._idle.set()

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until the queue drains (tests / graceful handover)."""
        return self._idle.wait(timeout)

    def stop(self, join: bool = True) -> None:
        self._stop.set()
        if join:
            self._worker.join(timeout=5.0)
