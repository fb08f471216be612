"""Leader discovery + request redirect for clients.

The port's copy of the reference package's `coordination/discovery.py`: host
code over the port's modules.

Reference analogs:
  discovery/DruidLeaderClient.java — clients of the coordinator/overlord
    APIs resolve the current leader, send there, and on a redirect or
    connection failure re-resolve and retry (the HTTP 307 dance every
    non-leader coordinator/overlord answers with)
  server/http/security + CliBroker wiring — resolution is cheap reads of
    the same lease row the latch heartbeats through, never a query-path
    dependency.
"""
from __future__ import annotations

import json
import logging
import time
import urllib.error
import urllib.request
from typing import Callable, Optional

from druid_tpu_torch.coordination.latch import LeaderLease, LeaseStore

log = logging.getLogger(__name__)


class NoLeaderError(RuntimeError):
    """No live leader for the service after the configured retries."""


class LeaderClient:
    """Resolve + talk to the current leader of one service.

    The resolved URL is cached and invalidated on failure/redirect, so the
    common case is zero extra store reads per request (DruidLeaderClient
    caches `currentKnownLeader` the same way)."""

    def __init__(self, store: LeaseStore, service: str,
                 clock: Optional[Callable[[], int]] = None):
        self.store = store
        self.service = service
        self.clock = clock or (lambda: int(time.time() * 1000))
        self._cached_url: Optional[str] = None

    def leader(self) -> Optional[LeaderLease]:
        """The current UNEXPIRED lease, or None (election in progress)."""
        try:
            lease = self.store.read(self.service)
        except Exception:
            log.debug("lease read for [%s] failed; reporting no leader",
                      self.service, exc_info=True)
            return None
        if lease is None or self.clock() >= lease.expires_ms:
            return None
        return lease

    def leader_url(self, use_cache: bool = True) -> Optional[str]:
        if use_cache and self._cached_url is not None:
            return self._cached_url
        lease = self.leader()
        self._cached_url = lease.url if lease is not None else None
        return self._cached_url

    def invalidate(self) -> None:
        self._cached_url = None

    def request(self, send: Callable[[str], object], retries: int = 3,
                backoff_s: float = 0.05):
        """Run `send(leader_url)`, re-resolving and retrying on connection
        failures — the pattern DruidLeaderClient.go implements over HTTP,
        transport-agnostic here so in-process targets work too."""
        last: Optional[BaseException] = None
        for attempt in range(retries):
            url = self.leader_url(use_cache=(attempt == 0))
            if url is None:
                last = NoLeaderError(
                    f"no live leader for [{self.service}]")
            else:
                try:
                    return send(url)
                except urllib.error.HTTPError:
                    # a definitive HTTP answer FROM the leader (404/403/
                    # 500…) is the caller's to see — retrying would re-send
                    # non-idempotent requests a live leader already judged
                    raise
                except (ConnectionError, OSError, urllib.error.URLError) as e:
                    last = e
            self.invalidate()
            if attempt < retries - 1 and backoff_s:
                time.sleep(backoff_s * (attempt + 1))
        if isinstance(last, NoLeaderError):
            raise last
        raise NoLeaderError(
            f"leader of [{self.service}] unreachable after {retries} "
            f"attempts: {last}")

    # ---- HTTP convenience (the literal DruidLeaderClient.go) -----------
    def go(self, path: str, payload: Optional[dict] = None,
           timeout: float = 30.0, retries: int = 3):
        """GET (payload None) or POST JSON `path` on the current leader,
        following one same-request 307 hop (a just-deposed leader redirects
        to its successor before the lease row catches up)."""

        def send(url: str):
            target = url.rstrip("/") + path
            data = None if payload is None else json.dumps(payload).encode()
            req = urllib.request.Request(
                target, data=data,
                headers={"Content-Type": "application/json"},
                method="GET" if payload is None else "POST")
            try:
                with urllib.request.urlopen(req, timeout=timeout) as r:
                    return json.loads(r.read() or b"null")
            except urllib.error.HTTPError as e:
                if e.code in (302, 307) and e.headers.get("Location"):
                    loc = e.headers["Location"]
                    base = loc.split("/druid/", 1)[0]
                    self._cached_url = base
                    req2 = urllib.request.Request(
                        loc, data=data,
                        headers={"Content-Type": "application/json"},
                        method="GET" if payload is None else "POST")
                    with urllib.request.urlopen(req2, timeout=timeout) as r:
                        return json.loads(r.read() or b"null")
                raise

        return self.request(send, retries=retries)
