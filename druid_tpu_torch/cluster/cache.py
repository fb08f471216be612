"""Query caches (the port's own copy of the reference package's
`cluster/cache.py`).

Reference analogs: client/cache/Cache.java SPI with Caffeine local cache
(client/cache/CaffeineCache.java) + CacheConfig; used at the segment level
by the historical's CachingQueryRunner and at the result level by the
broker's ResultLevelCachingQueryRunner. Cache keys come from per-query-type
CacheStrategy (query/CacheStrategy.java).

Here: an LRU local cache keyed by (namespace, key). Segment-level entries
hold per-segment partial states (exact merges — the analog of caching
non-finalized per-segment results); result-level entries hold final rows,
keyed by the query plus the exact segment-version set so any timeline
change (new version, compaction) invalidates naturally (the reference's
etag mechanism).
"""
from __future__ import annotations

import json
import logging
import threading
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

log = logging.getLogger(__name__)


class CacheStats:
    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.puts = 0
        #: puts a remote tier refused to ship (value not wire-serializable)
        self.dropped_puts = 0


class Cache:
    """Pluggable cache SPI (reference: client/cache/Cache.java — local
    Caffeine, memcached, hybrid impls chosen by config)."""

    def get(self, namespace: str, key: str):
        raise NotImplementedError

    def put(self, namespace: str, key: str, value) -> None:
        raise NotImplementedError

    def invalidate_namespace(self, namespace: str) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass


class LruCache(Cache):
    """Thread-safe LRU with entry-count bound (the CaffeineCache role)."""

    def __init__(self, max_entries: int = 10_000):
        self.max_entries = max_entries
        self._data: "OrderedDict[Tuple[str, str], object]" = OrderedDict()
        self._lock = threading.Lock()
        self.stats = CacheStats()

    def get(self, namespace: str, key: str):
        with self._lock:
            k = (namespace, key)
            if k in self._data:
                self._data.move_to_end(k)
                self.stats.hits += 1
                return self._data[k]
            self.stats.misses += 1
            return None

    def put(self, namespace: str, key: str, value) -> None:
        with self._lock:
            k = (namespace, key)
            self._data[k] = value
            self._data.move_to_end(k)
            self.stats.puts += 1
            while len(self._data) > self.max_entries:
                self._data.popitem(last=False)
                self.stats.evictions += 1

    def invalidate_namespace(self, namespace: str) -> int:
        with self._lock:
            doomed = [k for k in self._data if k[0] == namespace]
            for k in doomed:
                del self._data[k]
            return len(doomed)

    def __len__(self):
        with self._lock:
            return len(self._data)


class HybridCache(Cache):
    """L1 local + L2 remote with L1 population on L2 hits (reference:
    client/cache/HybridCache.java — Caffeine in front of memcached)."""

    def __init__(self, l1: Cache, l2: Cache, populate_l1: bool = True):
        self.l1 = l1
        self.l2 = l2
        self.populate_l1 = populate_l1
        self.stats = CacheStats()
        # counter increments are read-modify-write: broker pool threads
        # hitting both tiers concurrently would lose updates unguarded
        self._stats_lock = threading.Lock()

    def get(self, namespace, key):
        v = self.l1.get(namespace, key)
        if v is None:
            v = self.l2.get(namespace, key)
            if v is not None and self.populate_l1:
                self.l1.put(namespace, key, v)
        with self._stats_lock:
            if v is None:
                self.stats.misses += 1
            else:
                self.stats.hits += 1
        return v

    def put(self, namespace, key, value):
        self.l1.put(namespace, key, value)
        self.l2.put(namespace, key, value)
        with self._stats_lock:
            self.stats.puts += 1

    def invalidate_namespace(self, namespace):
        n = self.l1.invalidate_namespace(namespace)
        return max(n, self.l2.invalidate_namespace(namespace))

    def close(self):
        self.l1.close()
        self.l2.close()


class RemoteCacheServer:
    """Shared cache node: the memcached role. Length-prefixed JSON frames
    over TCP — data-only on the wire, so a peer that can reach the port
    can at worst poison cache entries, never execute code (the pickle
    frames this replaces were arbitrary-code-execution for anyone who
    could connect). Values that do not JSON-serialize are dropped by the
    client's put (a cache is allowed to forget)."""

    def __init__(self, max_entries: int = 100_000, port: int = 0,
                 host: str = "127.0.0.1"):
        import socketserver

        if host not in ("127.0.0.1", "localhost", "::1"):
            # loud by design: there is no authentication on this protocol
            log.warning(
                "RemoteCacheServer binding to NON-LOOPBACK host %r — the "
                "cache protocol is unauthenticated; anyone who can reach "
                "this port can read and poison cache entries. Bind to "
                "127.0.0.1 or firewall the port to the cluster.", host)

        store = LruCache(max_entries)
        self.store = store

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        req = _recv_frame(self.request)
                        if req is None:
                            return
                        op = req.get("op")
                        if op == "get":
                            out = {"value": store.get(req["ns"], req["key"])}
                        elif op == "put":
                            store.put(req["ns"], req["key"], req["value"])
                            out = {"ok": True}
                        elif op == "invalidate":
                            out = {"n": store.invalidate_namespace(req["ns"])}
                        else:
                            out = {"error": f"bad op {op!r}"}
                        _send_frame(self.request, out)
                except (ConnectionError, OSError, ValueError):
                    # ValueError covers malformed frames (non-JSON bytes —
                    # e.g. a legacy/hostile pickle payload): drop the
                    # connection, never interpret the bytes
                    return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        # reap the serve_forever thread: a stop() that returns while the
        # acceptor still winds down strands one thread per server cycle
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)


class RemoteCacheClient(Cache):
    """Cache over a RemoteCacheServer. Degrades like memcached: any
    connection failure is a miss / dropped put, never a query failure."""

    def __init__(self, host: str, port: int, timeout: float = 2.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.stats = CacheStats()
        self._sock = None
        self._lock = threading.Lock()
        # separate from the socket lock: a counter bump must not queue
        # behind a remote round-trip
        self._stats_lock = threading.Lock()
        self._warned_drop = False

    def _call(self, req):
        import socket
        with self._lock:
            try:
                if self._sock is None:
                    self._sock = socket.create_connection(
                        (self.host, self.port), timeout=self.timeout)
                _send_frame(self._sock, req)
                return _recv_frame(self._sock)
            except (ConnectionError, OSError, ValueError):
                # ValueError: non-JSON reply (legacy/misbehaving peer) —
                # the stream is desynced, so drop the socket; like any
                # failure here it degrades to a miss, never a query error
                try:
                    if self._sock is not None:
                        self._sock.close()
                finally:
                    self._sock = None
                return None

    def get(self, namespace, key):
        out = self._call({"op": "get", "ns": namespace, "key": key})
        v = out.get("value") if out else None
        with self._stats_lock:
            if v is None:
                self.stats.misses += 1
            else:
                self.stats.hits += 1
        return v

    def put(self, namespace, key, value):
        try:
            # encode ONCE: serializability probe and wire bytes in one go
            payload = _encode_frame({"op": "put", "ns": namespace,
                                     "key": key, "value": value})
        except (TypeError, ValueError):
            # non-JSON-serializable value (e.g. device partial states):
            # drop the put — remote tiers carry data-only entries. Counted
            # (and logged once) so a pure-remote deployment whose values
            # never serialize shows WHY its hit rate is zero, instead of
            # silently recomputing everything forever.
            with self._stats_lock:
                self.stats.dropped_puts += 1
                warn_now = not self._warned_drop
                self._warned_drop = True
            if warn_now:
                log.warning(
                    "remote cache dropping non-serializable puts (first: "
                    "namespace %r, %s) — these entries only cache in a "
                    "local tier; see CacheStats.dropped_puts", namespace,
                    type(value).__name__)
            return
        self._call(payload)
        with self._stats_lock:
            self.stats.puts += 1

    def invalidate_namespace(self, namespace):
        out = self._call({"op": "invalidate", "ns": namespace})
        return out.get("n", 0) if out else 0

    def close(self):
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None


#: refuse absurd frames before allocating for them (a hostile peer on the
#: unauthenticated port must not be able to OOM the process with a header)
MAX_FRAME_BYTES = 64 * 1024 * 1024


def _frame_json_default(obj):
    """Data-only lowering for the wire: numpy scalars/arrays become plain
    JSON numbers/lists (the only non-builtin types result rows carry).
    Anything else is a TypeError — the put is then dropped client-side."""
    import numpy as np
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"not cacheable over the wire: {type(obj).__name__}")


def _encode_frame(obj) -> bytes:
    return json.dumps(obj, default=_frame_json_default).encode()


def _send_frame(sock, obj) -> None:
    """`obj` may be pre-encoded bytes (a caller that already probed
    serializability) or any JSON-able value."""
    import struct
    payload = obj if isinstance(obj, bytes) else _encode_frame(obj)
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def _recv_frame(sock):
    import struct
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (n,) = struct.unpack(">I", hdr)
    if n > MAX_FRAME_BYTES:
        raise ConnectionError(f"cache frame of {n} bytes exceeds the "
                              f"{MAX_FRAME_BYTES}-byte bound")
    body = _recv_exact(sock, n)
    if body is None:
        return None
    return json.loads(body.decode())


def _recv_exact(sock, n: int):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class CacheConfig:
    """Which levels populate/use cache (reference: CacheConfig +
    CacheStrategy.isCacheable per query type)."""

    UNCACHEABLE = {"scan", "select", "dataSourceMetadata"}

    def __init__(self, use_segment_cache: bool = True,
                 populate_segment_cache: bool = True,
                 use_result_cache: bool = True,
                 populate_result_cache: bool = True):
        self.use_segment_cache = use_segment_cache
        self.populate_segment_cache = populate_segment_cache
        self.use_result_cache = use_result_cache
        self.populate_result_cache = populate_result_cache

    def cacheable(self, query) -> bool:
        return query.query_type not in self.UNCACHEABLE


def query_cache_key(query) -> str:
    """Canonical per-query cache key from the wire format, excluding
    context (reference: per-toolchest computeCacheKey). The port's
    `to_json` writes the reference's wire format, so the same Druid JSON
    gives the same key in both packages."""
    j = query.to_json()
    j.pop("context", None)
    return json.dumps(j, sort_keys=True)


def result_level_key(query, segment_versions: Sequence[str]) -> str:
    """Result-level key: query + exact segment-id/version set (etag)."""
    return query_cache_key(query) + "|" + ",".join(sorted(segment_versions))
