"""Router: query forwarding to tiered brokers (the port's own copy of the
reference package's `server/router.py`, stdlib only).

Reference analogs (server/src/main/java/org/apache/druid/server/):
  AsyncQueryForwardingServlet.java — the router process: parses just enough
    of the request (datasource, context) to pick a broker, then proxies the
    raw request/response
  router/TieredBrokerHostSelector.java + rule-based / priority / manual
    strategies — which broker tier serves a query: explicit
    context.brokerService wins, then priority thresholds, then the
    datasource's load rules mapped through tierToBrokerMap, else default
  router/AvaticaConnectionBalancer — (JDBC; out of scope)

In-process brokers (cluster.Broker) and remote broker base-URLs are both
valid targets; the HTTP front proxies to remote targets byte-for-byte.
"""
from __future__ import annotations

import itertools
import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

from druid_tpu_torch.utils.intervals import parse_period_ms


class TieredBrokerSelector:
    """Pick a broker tier for one query payload."""

    def __init__(self, tier_to_brokers: Dict[str, Sequence[object]],
                 default_tier: str,
                 rules: Optional[Dict[str, List[dict]]] = None,
                 min_priority: Optional[int] = None,
                 max_priority: Optional[int] = None,
                 priority_tier: Optional[str] = None):
        """tier_to_brokers: tier name → broker targets (round-robin within).
        rules: datasource → [{"periodMs"|"period":..., "tier": ...}] — a
        query whose FIRST interval starts within the period routes to that
        tier (the rule-based strategy over load rules).
        min/max_priority + priority_tier: queries with context.priority
        outside [min, max] route to priority_tier (PriorityTieredBroker
        SelectorStrategy pair)."""
        self.tiers = {t: list(bs) for t, bs in tier_to_brokers.items()}
        self.default_tier = default_tier
        self.rules = rules or {}
        self.min_priority = min_priority
        self.max_priority = max_priority
        self.priority_tier = priority_tier
        self._rr = {t: itertools.cycle(range(max(len(b), 1)))
                    for t, b in self.tiers.items()}
        self._lock = threading.Lock()

    def select_tier(self, payload: dict, now_ms: Optional[int] = None) -> str:
        ctx = payload.get("context") or {}
        # 1. manual: context.brokerService
        manual = ctx.get("brokerService")
        if manual in self.tiers:
            return manual
        # 2. priority thresholds
        if self.priority_tier is not None:
            try:
                pri = int(ctx.get("priority", 0))
            except (TypeError, ValueError):
                pri = 0
            if (self.min_priority is not None and pri < self.min_priority) \
                    or (self.max_priority is not None
                        and pri > self.max_priority):
                return self.priority_tier
        # 3. datasource rules (hot/cold tiering by interval recency)
        ds = payload.get("dataSource")
        if isinstance(ds, dict):
            ds = ds.get("name")
        for rule in self.rules.get(str(ds), ()):
            tier = rule.get("tier")
            if tier not in self.tiers:
                continue
            period = rule.get("periodMs", rule.get("period"))
            if period is None:
                return tier
            import time
            now = int(time.time() * 1000) if now_ms is None else now_ms
            horizon = now - parse_period_ms(period)
            for iv in payload.get("intervals") or ():
                try:
                    start = str(iv).split("/", 1)[0]
                    from druid_tpu_torch.utils.intervals import parse_ts
                    if parse_ts(start) >= horizon:
                        return tier
                except (ValueError, TypeError):
                    continue
        return self.default_tier

    def pick(self, payload: dict, now_ms: Optional[int] = None,
             affinity_key: Optional[str] = None):
        """(tier, broker target) for one query payload. A selected tier
        with no brokers falls back to the default tier. affinity_key pins
        a key to ONE broker in the tier (Avatica connections are broker-
        local state — the AvaticaConnectionBalancer's job)."""
        tier = self.select_tier(payload, now_ms)
        if not self.tiers.get(tier):
            tier = self.default_tier
        brokers = self.tiers.get(tier)
        if not brokers:
            raise ValueError(f"no brokers in tier {tier!r}")
        if affinity_key is not None:
            import hashlib
            h = int(hashlib.md5(affinity_key.encode()).hexdigest()[:8], 16)
            return tier, brokers[h % len(brokers)]
        with self._lock:
            i = next(self._rr[tier]) % len(brokers)
        return tier, brokers[i]


class Router:
    """In-process router facade: run_json forwards to the selected broker
    (duck-typed: anything with run_json, or a base-URL string proxied over
    HTTP)."""

    def __init__(self, selector: TieredBrokerSelector):
        self.selector = selector

    def run_json(self, payload: dict):
        tier, target = self.selector.pick(payload)
        if isinstance(target, str):
            body = json.dumps(payload).encode()
            req = urllib.request.Request(
                target.rstrip("/") + "/druid/v2", data=body,
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=300.0) as r:
                return json.loads(r.read())
        return target.run_json(payload)


class RouterHttpServer:
    """HTTP front that proxies /druid/v2 and /druid/v2/sql to the selected
    broker's HTTP endpoint (AsyncQueryForwardingServlet)."""

    def __init__(self, selector: TieredBrokerSelector,
                 host: str = "127.0.0.1", port: int = 0,
                 leader_clients=None):
        """leader_clients: in the reference, {"coordinator"|"overlord":
        coordination.LeaderClient} — the router then also fronts the
        control plane, proxying /druid/coordinator/* and /druid/indexer/*
        to the CURRENT leader of that service. The port's coordination
        layer waits for a later slice (ROADMAP A18): given, it raises
        NotImplementedError; without it those paths answer 404, as the
        reference's do when no leader client is configured."""
        if leader_clients:
            raise NotImplementedError(
                "RouterHttpServer(leader_clients=...) is not ported yet "
                "(ROADMAP A18)")
        outer_selector = selector

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _proxy(self):
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                try:
                    payload = json.loads(raw or b"{}")
                except ValueError:
                    payload = {}
                affinity = None
                if self.path.rstrip("/").endswith("/avatica"):
                    # Avatica connections are broker-local state: every
                    # request of one connection must land on one broker
                    affinity = payload.get("connectionId") or \
                        (payload.get("statementHandle") or {}).get(
                            "connectionId")
                try:
                    _, target = outer_selector.pick(
                        payload, affinity_key=affinity)
                except Exception as e:
                    self._send(500, json.dumps(
                        {"error": str(e)}).encode())
                    return
                url = str(target).rstrip("/") + self.path
                # credentials travel with the proxied request (the
                # reference servlet forwards headers; the broker behind the
                # router does its own authentication)
                fwd = {"Content-Type": self.headers.get(
                    "Content-Type", "application/json")}
                for h in ("Authorization", "X-Druid-Identity"):
                    if self.headers.get(h):
                        fwd[h] = self.headers[h]
                req = urllib.request.Request(url, data=raw, headers=fwd,
                                             method="POST")
                try:
                    with urllib.request.urlopen(req, timeout=300.0) as r:
                        self._send(r.status, r.read())
                except urllib.error.HTTPError as e:
                    self._send(e.code, e.read())
                except Exception as e:
                    self._send(502, json.dumps(
                        {"error": f"broker unreachable: {e}"}).encode())

            def _send(self, code: int, data: bytes):
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                try:
                    self.wfile.write(data)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_POST(self):
                if self.path.rstrip("/") in ("/druid/v2", "/druid/v2/sql",
                                             "/druid/v2/sql/avatica"):
                    self._proxy()
                else:
                    self._send(404, b'{"error": "unknown path"}')

            def do_GET(self):
                if self.path == "/status":
                    self._send(200, b'{"service": "router"}')
                else:
                    self._send(404, b'{"error": "unknown path"}')

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "RouterHttpServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
