"""Metric/alert emission + monitors: the port's own copy of the reference
package's `utils/emitter.py` (host Python, no device work).

Reference analogs:
  java-util/.../emitter/core/Emitter.java + HttpPostEmitter.java — batched
    async event emission with pluggable sinks
  emitter/service/ServiceEmitter.java — stamps service/host dims
  java-util/.../metrics/MonitorScheduler.java, JvmMonitor, SysMonitor,
    server/metrics/QueryCountStatsMonitor.java, CacheMonitor — periodic
    metric producers
  server/emitter/EmitterModule.java — sink selection by config

Python-host equivalents: /proc-based system metrics (the Sigar JNI role),
process RSS/CPU, cache hit rates, query counts.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


@dataclass
class Event:
    kind: str                    # "metric" | "alert"
    metric: str
    value: float
    timestamp_ms: int
    dims: Dict[str, object] = field(default_factory=dict)

    def to_json(self) -> dict:
        out = {"feed": "metrics" if self.kind == "metric" else "alerts",
               "timestamp": self.timestamp_ms, "metric": self.metric,
               "value": self.value}
        out.update(self.dims)
        return out


class Emitter:
    def emit(self, event: Event) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class NoopEmitter(Emitter):
    def emit(self, event):
        pass


class InMemoryEmitter(Emitter):
    """Test/inspection sink (the reference's stub emitters)."""

    def __init__(self):
        self.events: List[Event] = []
        self._lock = threading.Lock()

    def emit(self, event):
        with self._lock:
            self.events.append(event)

    def metrics(self, name: Optional[str] = None) -> List[Event]:
        with self._lock:
            return [e for e in self.events
                    if e.kind == "metric" and (name is None or e.metric == name)]


class LoggingEmitter(Emitter):
    def __init__(self, logger=None):
        import logging
        self.logger = logger or logging.getLogger("druid_tpu_torch.emitter")

    def emit(self, event):
        self.logger.info("%s", json.dumps(event.to_json()))


class FileEmitter(Emitter):
    """Newline-delimited JSON events (the file request-logger pattern)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._fh = open(path, "a")

    def emit(self, event):
        with self._lock:
            if self._fh.closed:
                return        # late tick racing shutdown: drop, don't raise
            self._fh.write(json.dumps(event.to_json()) + "\n")

    def flush(self):
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()

    def close(self):
        with self._lock:
            self._fh.close()


class BatchingEmitter(Emitter):
    """Buffers events and hands batches to a sender callable — the
    HttpPostEmitter's batch/flush discipline with the transport abstracted
    (a real deployment posts JSON arrays over HTTP).

    A background flush timer (daemon, joined on close()) drains the buffer
    every `flush_seconds` even when NO further emit arrives — previously the
    time-based path only fired on the next emit, so a trickle of events
    could sit buffered forever. The timer thread acquires only self._lock
    (briefly, to swap the buffer) and sends outside it — witness-clean."""

    def __init__(self, send: Callable[[List[dict]], None],
                 batch_size: int = 500, flush_seconds: float = 60.0):
        self.send = send
        self.batch_size = batch_size
        self.flush_seconds = flush_seconds
        self._buf: List[dict] = []
        self._lock = threading.Lock()
        self._last_flush = time.monotonic()
        self._stop = threading.Event()
        self._flusher = threading.Thread(target=self._flush_loop,
                                         daemon=True,
                                         name="batching-emitter-flush")
        self._flusher.start()

    def _flush_loop(self):
        while not self._stop.wait(self.flush_seconds):
            self.flush()

    def emit(self, event):
        flush_now = False
        with self._lock:
            self._buf.append(event.to_json())
            if len(self._buf) >= self.batch_size \
                    or time.monotonic() - self._last_flush > self.flush_seconds:
                flush_now = True
        if flush_now:
            self.flush()

    def flush(self):
        with self._lock:
            buf, self._buf = self._buf, []
            self._last_flush = time.monotonic()
        if buf:
            self.send(buf)

    def close(self):
        """Stop AND join the flush timer before the final flush: a tick
        mid-send while the owner tears down its transport would race."""
        self._stop.set()
        t = self._flusher
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=5.0)
        self.flush()


class ComposingEmitter(Emitter):
    def __init__(self, children: Sequence[Emitter]):
        self.children = list(children)

    def emit(self, event):
        for c in self.children:
            c.emit(event)

    def flush(self):
        for c in self.children:
            c.flush()

    def close(self):
        """Close children too — a composed FileEmitter's handle previously
        leaked because only flush() propagated."""
        for c in self.children:
            c.close()


class ServiceEmitter(Emitter):
    """Stamps service/host dimensions onto every event."""

    def __init__(self, service: str, host: str, sink: Emitter):
        self.service = service
        self.host = host
        self.sink = sink

    def emit(self, event):
        event.dims.setdefault("service", self.service)
        event.dims.setdefault("host", self.host)
        self.sink.emit(event)

    def metric(self, name: str, value: float, **dims) -> None:
        self.emit(Event("metric", name, value, int(time.time() * 1000),
                        dict(dims)))

    def alert(self, description: str, **dims) -> None:
        self.emit(Event("alert", description, 1.0, int(time.time() * 1000),
                        dict(dims)))

    def flush(self):
        self.sink.flush()


def emitter_from_config(kind: str, **kw) -> Emitter:
    """EmitterModule's sink selection (noop/logging/file/composing…)."""
    if kind in ("noop", "none"):
        return NoopEmitter()
    if kind == "logging":
        return LoggingEmitter()
    if kind == "file":
        return FileEmitter(kw["path"])
    if kind == "memory":
        return InMemoryEmitter()
    raise ValueError(f"unknown emitter {kind!r}")


# ---------------------------------------------------------------------------
# Monitors
# ---------------------------------------------------------------------------

class Monitor:
    def do_monitor(self, emitter: ServiceEmitter) -> None:
        raise NotImplementedError


class SysMonitor(Monitor):
    """Host cpu/mem/disk via /proc (the Sigar JNI role)."""

    def __init__(self):
        self._last_cpu: Optional[tuple] = None

    def do_monitor(self, emitter):
        try:
            with open("/proc/stat") as f:
                parts = f.readline().split()[1:8]
            vals = [int(x) for x in parts]
            total, idle = sum(vals), vals[3]
            if self._last_cpu is not None:
                dt = total - self._last_cpu[0]
                didle = idle - self._last_cpu[1]
                if dt > 0:
                    emitter.metric("sys/cpu", 100.0 * (dt - didle) / dt)
            self._last_cpu = (total, idle)
            with open("/proc/meminfo") as f:
                mem = {}
                for line in f:
                    k, v = line.split(":", 1)
                    mem[k] = int(v.strip().split()[0]) * 1024
            emitter.metric("sys/mem/used",
                           mem["MemTotal"] - mem["MemAvailable"])
            emitter.metric("sys/mem/max", mem["MemTotal"])
        except (OSError, KeyError, ValueError):
            pass


class ProcessMonitor(Monitor):
    """This process's RSS + cpu time (JvmMonitor's heap/GC role)."""

    def do_monitor(self, emitter):
        try:
            with open("/proc/self/statm") as f:
                rss_pages = int(f.read().split()[1])
            emitter.metric("proc/rss", rss_pages * os.sysconf("SC_PAGE_SIZE"))
            emitter.metric("proc/cpu", time.process_time())
        except (OSError, ValueError):
            pass


class CacheMonitor(Monitor):
    """Cache hit-rate metrics (client/cache/CacheMonitor.java)."""

    def __init__(self, cache):
        self.cache = cache

    def do_monitor(self, emitter):
        s = self.cache.stats
        emitter.metric("query/cache/total/hits", s.hits)
        emitter.metric("query/cache/total/misses", s.misses)
        emitter.metric("query/cache/total/evictions", s.evictions)
        emitter.metric("query/cache/total/entries", len(self.cache))


class QueryCountStatsMonitor(Monitor):
    """query success/failed counts (QueryCountStatsMonitor.java): emits the
    cumulative totals AND the per-period deltas since the last tick (the
    reference's KeyedDiff semantics — rate dashboards read the deltas,
    uptime counters the totals)."""

    def __init__(self):
        self.success = 0
        self.failed = 0
        self._last_success = 0
        self._last_failed = 0
        self._lock = threading.Lock()

    def on_query(self, ok: bool):
        with self._lock:
            if ok:
                self.success += 1
            else:
                self.failed += 1

    def do_monitor(self, emitter):
        with self._lock:
            succ, fail = self.success, self.failed
            d_succ = succ - self._last_success
            d_fail = fail - self._last_failed
            self._last_success, self._last_failed = succ, fail
        emitter.metric("query/count", succ + fail)
        emitter.metric("query/success/count", succ)
        emitter.metric("query/failed/count", fail)
        emitter.metric("query/count/delta", d_succ + d_fail)
        emitter.metric("query/success/count/delta", d_succ)
        emitter.metric("query/failed/count/delta", d_fail)


class MonitorScheduler:
    """Periodic monitor driver (MonitorScheduler.java). start() spawns a
    daemon thread; tick() drives manually (tests)."""

    def __init__(self, emitter: ServiceEmitter,
                 monitors: Sequence[Monitor], period_seconds: float = 60.0):
        self.emitter = emitter
        self.monitors = list(monitors)
        self.period = period_seconds
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def tick(self):
        for m in self.monitors:
            m.do_monitor(self.emitter)

    def start(self):
        def loop():
            while not self._stop.wait(self.period):
                self.tick()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self, join_timeout: float = 5.0):
        """Signal the loop AND wait for it: callers close their emitter
        right after stop(), and a tick still in flight would write to the
        closed sink (FileEmitter additionally drops late writes — belt and
        suspenders, since a tick may be mid-emit when stop() is called)."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=join_timeout)
