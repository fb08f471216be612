"""Ordered service lifecycle.

The port's copy of the reference package's `utils/lifecycle.py`: host
code over the port's modules.

Reference analog: java-util/src/main/java/org/apache/druid/java/util/
common/lifecycle/Lifecycle.java — services register in a stage
(INIT → NORMAL → SERVER → COORDINATION → ANNOUNCEMENTS), start runs stages
in order and registration order within a stage, stop runs the exact
reverse, and a failed start unwinds whatever already started.
ANNOUNCEMENTS last means a node only becomes discoverable once everything
beneath it is serving — the property the ad-hoc try/finally assemblies
could not guarantee. COORDINATION (leader-latch participation) sits after
SERVER so a node only competes for leadership once its advertised
endpoint is live, and before ANNOUNCEMENTS so a winning node is leading
by the time it is discoverable; on stop the reverse order steps down from
the latch (releasing the lease for fast standby promotion) before the
HTTP server goes away.
"""
from __future__ import annotations

import enum
import logging
import threading
from typing import Callable, List, Optional

log = logging.getLogger(__name__)


class Stage(enum.IntEnum):
    INIT = 0            # metadata stores, config, extension registries
    NORMAL = 1          # coordinators, overlords, monitors
    SERVER = 2          # HTTP/socket servers begin accepting
    COORDINATION = 3    # leader-latch participation (heartbeats begin)
    ANNOUNCEMENTS = 4   # node announces itself into the cluster


class Lifecycle:
    """start() brings handlers up stage by stage; stop() tears down in
    exact reverse; a mid-start failure unwinds the started prefix and
    re-raises. Usable as a context manager."""

    def __init__(self):
        self._handlers: List[tuple] = []   # (stage, seq, name, start, stop)
        self._seq = 0
        self._started: List[tuple] = []
        self._lock = threading.Lock()
        self._stop_event = threading.Event()
        self.running = False
        self._in_start = False
        self._stop_requested = False

    def add(self, obj=None, *, start: Optional[Callable] = None,
            stop: Optional[Callable] = None, stage: Stage = Stage.NORMAL,
            name: Optional[str] = None) -> "Lifecycle":
        """Register `obj` (anything with .start()/.stop()) or explicit
        start/stop callables. Registration after start() is rejected —
        the reference's Lifecycle likewise refuses late joiners outside
        managed stages."""
        with self._lock:
            if self.running:
                raise RuntimeError("lifecycle already started")
            s = start if start is not None else getattr(obj, "start", None)
            t = stop if stop is not None else getattr(obj, "stop", None)
            if s is None and t is None:
                raise ValueError("nothing to manage: no start or stop")
            label = name or type(obj).__name__ if obj is not None \
                else (name or getattr(s, "__name__", "handler"))
            self._handlers.append((stage, self._seq, label, s, t))
            self._seq += 1
        return self

    def start(self) -> "Lifecycle":
        with self._lock:
            if self.running:
                return self
            self.running = True
            self._in_start = True
            self._stop_requested = False
            # restart after stop(): join() must block again
            self._stop_event.clear()
        aborted = False
        try:
            for h in sorted(self._handlers, key=lambda h: (h[0], h[1])):
                with self._lock:
                    if self._stop_requested:
                        aborted = True
                        break
                stage, _, label, start_fn, _ = h
                try:
                    if start_fn is not None:
                        start_fn()
                except BaseException:
                    log.exception("start failed at %s (stage %s); unwinding",
                                  label, stage.name)
                    self._unwind()
                    with self._lock:
                        self.running = False
                    raise
                with self._lock:
                    self._started.append(h)
        finally:
            with self._lock:
                self._in_start = False
                aborted = aborted or self._stop_requested
        if aborted:
            # a concurrent stop() arrived mid-start: this thread owns the
            # unwind so no just-started handler can leak
            self._unwind()
            with self._lock:
                self.running = False
            self._stop_event.set()
        return self

    def stop(self) -> None:
        with self._lock:
            if not self.running:
                return
            self._stop_requested = True
            if self._in_start:
                # the starting thread sees the flag and unwinds everything
                # it started — stopping here would race its handler loop
                return
            self.running = False
        self._unwind()
        self._stop_event.set()

    def _unwind(self) -> None:
        while True:
            # pop under the lock: start() appends under it, and a start
            # thread racing a stop() must not tear a list resize
            with self._lock:
                if not self._started:
                    return
                stage, _, label, _, stop_fn = self._started.pop()
            if stop_fn is None:
                continue
            try:
                stop_fn()
            except Exception:
                # teardown keeps going: one bad stop must not leak the rest
                log.exception("stop failed at %s (stage %s)", label,
                              stage.name)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Block until stop() (e.g. from a signal handler)."""
        return self._stop_event.wait(timeout)

    def __enter__(self) -> "Lifecycle":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
