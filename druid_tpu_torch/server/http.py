"""HTTP query endpoints (the port's own copy of the reference package's
`server/http.py`: the native query resource).

Reference analogs:
  server/QueryResource.java:77,126,153-156 — POST /druid/v2/ (native JSON),
    DELETE /druid/v2/{id} cancel, datasource listing
  sql/.../http/SqlResource.java:58,75-78 — POST /druid/v2/sql
  sql/.../avatica/DruidAvaticaJsonHandler — POST /druid/v2/sql/avatica
  /status — the common status endpoint every node serves
  POST/GET/DELETE /druid/v2/subscriptions[/<id>] — standing-query
    subscriptions (server/subscriptions.py) with long-poll and ETag/304
  /druid/coordinator/v1/*, /druid/indexer/v1/* — leader discovery
    (/leader, /isLeader), the 307 to the leader (503 while none is live)
    and, on the overlord's leader, task submission and status
    (DruidLeaderClient's redirect contract), given `coordination=` and
    `overlord=`

Paths of a surface that is not enabled answer 404: the coordination paths
without `coordination`, the SQL paths without `sql_executor`, the
subscription paths without `subscription_hub`.

stdlib ThreadingHTTPServer stands in for Jetty; the wire format (JSON
payloads/results) matches the reference so existing Druid HTTP clients map
1:1. Streaming chunked responses collapse to one JSON body — results are
materialized host-side anyway after device execution.
"""
from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from druid_tpu_torch.server.lifecycle import QueryLifecycle, Unauthorized
from druid_tpu_torch.server.querymanager import (QueryCapacityError,
                                                 QueryInterruptedError,
                                                 QueryTimeoutError)


def _json_value(obj):
    """Render extension values (sketches, histograms, bloom filters) the way
    the reference serializes complex agg results: structured JSON where the
    type defines one (histogram), base64 where it's opaque bits (bloom),
    estimates for sketches."""
    if hasattr(obj, "serialize"):
        return obj.serialize()
    if hasattr(obj, "to_json"):
        return obj.to_json()
    if hasattr(obj, "estimate"):
        return obj.estimate
    import numpy as np
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"not JSON serializable: {type(obj).__name__}")


class QueryHttpServer:
    """Serves a QueryLifecycle (+ optional SqlExecutor) over HTTP."""

    def __init__(self, lifecycle: QueryLifecycle, sql_executor=None,
                 host: str = "127.0.0.1", port: int = 0,
                 auth_chain=None, coordination=None, overlord=None,
                 monitor_period_seconds: float = 60.0,
                 subscription_hub=None):
        """auth_chain: optional server.security.AuthChain — requests
        authenticate at the HTTP boundary (401 on failure) and the
        resulting AuthenticationResult flows into the lifecycle, whose
        authorizer makes the per-datasource decision (403).

        Observability: a MetricRegistry always backs GET /metrics (the
        lifecycle emitter's sink is composed with it, or a registry-only
        ServiceEmitter is created), GET /druid/v2/trace/<queryId> serves
        the assembled qtrace trace, and a QueryCountStatsMonitor is wired
        into the lifecycle's on_result hook (chained with any existing
        hook) so query success/failure counts emit per monitor tick.

        sql_executor: optional sql.SqlExecutor — serves POST
        /druid/v2/sql and, through an AvaticaServer over it, POST
        /druid/v2/sql/avatica; both answer 404 "SQL not enabled" without
        it.

        coordination: optional {"coordinator"|"overlord":
        LeaderParticipant} — adds the leader discovery endpoints
        (/druid/coordinator/v1/leader, .../isLeader and the indexer
        equivalents) and the DruidLeaderClient redirect contract: any
        other coordinator/overlord API request on a NON-leader answers
        307 with Location on the current leader (503 while no leader is
        live). overlord: the local Overlord — leader-only task submission
        (POST /druid/indexer/v1/task) and status reads serve from it.

        subscription_hub: optional server.subscriptions.SubscriptionHub —
        adds the standing-query subscription surface (POST/GET/DELETE
        /druid/v2/subscriptions[/<id>]): long-poll fan-out composing with
        the same ETag/If-None-Match contract the one-shot query path
        speaks, so an unchanged window is a 304."""
        self.lifecycle = lifecycle
        self.subscription_hub = subscription_hub
        self.sql_executor = sql_executor
        self.auth_chain = auth_chain
        self.avatica = None
        if sql_executor is not None:
            from druid_tpu_torch.server.avatica import AvaticaServer
            self.avatica = AvaticaServer(sql_executor)
        self.coordination = coordination or {}
        self.overlord = overlord
        # one lease-liveness reader per hosted service — the SAME
        # expiry/None semantics clients use (no duplicated logic here)
        self._leader_clients = {}
        if self.coordination:
            from druid_tpu_torch.coordination.discovery import LeaderClient
            self._leader_clients = {
                svc: LeaderClient(p.store, p.service, clock=p.clock)
                for svc, p in self.coordination.items()}

        # ---- observability: /metrics registry + query-count monitor ----
        from druid_tpu_torch.obs.prometheus import MetricRegistry, compose_sink
        from druid_tpu_torch.utils.emitter import (MonitorScheduler,
                                                   QueryCountStatsMonitor,
                                                   ServiceEmitter)
        self.registry = MetricRegistry()
        # the sink rewrap + on_result chain below mutate the caller-owned
        # lifecycle IN PLACE; stop() undoes both (guarded by identity) so
        # a lifecycle reused across server generations doesn't accumulate
        # dead registries and double-counting monitors
        self._restore_sink = lambda: None
        if lifecycle.emitter is not None:
            self._restore_sink = compose_sink(lifecycle.emitter,
                                              self.registry)
            scrape_emitter = lifecycle.emitter
        else:
            scrape_emitter = ServiceEmitter("druid/broker", host,
                                            self.registry)
        self.query_counts = QueryCountStatsMonitor()
        self._prev_on_result = prev_on_result = lifecycle.on_result
        if prev_on_result is None:
            lifecycle.on_result = self.query_counts.on_query
        else:
            def _chained(ok, _prev=prev_on_result,
                         _qc=self.query_counts):
                _prev(ok)
                _qc.on_query(ok)
            lifecycle.on_result = _chained
        self._installed_on_result = lifecycle.on_result
        monitors = [self.query_counts]
        resilience = getattr(lifecycle.runner, "resilience", None)
        if resilience is not None:
            # broker-backed lifecycles surface the fault-tolerance layer
            # (broker/circuit/*, query/hedge/*, query/partial/*)
            from druid_tpu_torch.cluster.resilience import \
                ResilienceMetricsMonitor
            monitors.append(ResilienceMetricsMonitor(resilience))
        if subscription_hub is not None:
            from druid_tpu_torch.engine.standing import StandingMetricsMonitor
            from druid_tpu_torch.server.subscriptions import \
                SubscriptionMetricsMonitor
            monitors.append(SubscriptionMetricsMonitor(subscription_hub))
            monitors.append(StandingMetricsMonitor())
        self._monitors = MonitorScheduler(
            scrape_emitter, monitors,
            period_seconds=monitor_period_seconds)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # chunked streaming requires 1.1; every non-streaming reply
            # sends Content-Length so keep-alive works unchanged
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):   # quiet
                pass

            def _reply(self, code: int, body: dict | list,
                       extra_headers: dict | None = None):
                data = json.dumps(body, default=_json_value).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def _authenticated(self) -> bool:
                """Non-POST paths also sit behind the chain (the reference
                wraps EVERY resource in the auth filter); /status stays
                open for load-balancer health checks."""
                if outer.auth_chain is None:
                    return True
                if outer.auth_chain.authenticate(dict(self.headers)) is None:
                    self._reply(401, {"error": "unauthenticated"})
                    return False
                return True

            # ---- coordination (leader discovery + redirect) ------------
            def _leader_lease(self, service: str):
                """The current UNEXPIRED lease, or None (mid-election /
                store unreachable) — read through the same LeaderClient
                semantics redirecting clients use."""
                return outer._leader_clients[service].leader()

            def _redirect_to_leader(self, service: str) -> None:
                """307 on the live leader (DruidLeaderClient contract);
                503 while no leader is live — clients retry, they never
                get a non-leader's answer."""
                lease = self._leader_lease(service)
                if lease is None or not lease.url:
                    self._reply(503, {"error": "no live leader for "
                                      f"[{service}]"})
                    return
                self.send_response(307)
                self.send_header("Location",
                                 lease.url.rstrip("/") + self.path)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def _handle_coordination(self, service: str, payload) -> None:
                """One coordinator/overlord API request (payload None for
                GET). Leader/isLeader serve everywhere; everything else
                redirects off non-leaders."""
                p = outer.coordination[service]
                prefix = ("/druid/coordinator/v1" if service == "coordinator"
                          else "/druid/indexer/v1")
                sub = self.path.rstrip("/")[len(prefix):]
                if sub == "/leader":
                    lease = self._leader_lease(service)
                    if lease is None:
                        self._reply(503, {"error": "no live leader for "
                                          f"[{p.service}]"})
                    else:
                        self._reply(200, {"leader": lease.url,
                                          "term": lease.term,
                                          "holder": lease.holder})
                    return
                if sub == "/isLeader":
                    # Druid's semantics: 200 on the leader, 404 elsewhere
                    code = 200 if p.is_leader() else 404
                    self._reply(code, {"leader": p.is_leader()})
                    return
                if not p.is_leader():
                    self._redirect_to_leader(service)
                    return
                if service == "overlord" and outer.overlord is not None:
                    from druid_tpu_torch.coordination.latch import NotLeaderError
                    if sub == "/task" and payload is not None:
                        from druid_tpu_torch.indexing.task import task_from_json
                        try:
                            tid = outer.overlord.submit(
                                task_from_json(payload))
                        except NotLeaderError:
                            # deposed between is_leader() and submit()
                            self._redirect_to_leader(service)
                            return
                        self._reply(200, {"task": tid})
                        return
                    if sub.startswith("/task/") and sub.endswith("/status") \
                            and payload is None:
                        tid = sub[len("/task/"):-len("/status")]
                        st = outer.overlord.status(tid)
                        if st is None:
                            self._reply(404,
                                        {"error": f"unknown task {tid!r}"})
                        else:
                            self._reply(200, {"task": tid,
                                              "status": st.state})
                        return
                self._reply(404, {"error": "unknown path", "leader": True,
                                  "term": p.term, "node": p.node_id})

            def do_GET(self):
                if self.path == "/status":
                    self._reply(200, {"version": "druid-tpu-0.1",
                                      "modules": []})
                elif self.path.rstrip("/") == "/metrics":
                    # scrape surface: open like /status (Prometheus
                    # scrapers do not carry Druid credentials)
                    from druid_tpu_torch.obs.prometheus import \
                        CONTENT_TYPE as PROM_CTYPE
                    data = outer.registry.exposition().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", PROM_CTYPE)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path.startswith("/druid/v2/trace/"):
                    if self._authenticated():
                        import urllib.parse
                        from druid_tpu_torch.obs.trace import trace_store
                        qid = urllib.parse.unquote(
                            self.path[len("/druid/v2/trace/"):].rstrip("/"))
                        got = trace_store().get(qid)
                        if got is None:
                            self._reply(404, {"error": "unknown trace",
                                              "queryId": qid})
                        else:
                            self._reply(200, got)
                elif self.path.startswith("/druid/v2/subscriptions/"):
                    # long-poll fan-out: the handler thread parks in the
                    # hub until the standing program's version moves past
                    # the presented If-None-Match etag (or the timeout
                    # lapses → 304, the unchanged-window contract)
                    if outer.subscription_hub is None:
                        self._reply(404, {"error": "subscriptions not "
                                          "enabled"})
                    elif self._authenticated():
                        self._poll_subscription()
                elif self.path in ("/druid/v2/datasources",
                                   "/druid/v2/datasources/"):
                    if self._authenticated():
                        self._reply(200, outer._datasources())
                elif outer._coord_service(self.path) is not None:
                    if self._authenticated():
                        try:
                            self._handle_coordination(
                                outer._coord_service(self.path), None)
                        except Exception as e:
                            self._reply(500,
                                        {"error": f"{type(e).__name__}: {e}"})
                else:
                    self._reply(404, {"error": "unknown path"})

            def do_POST(self):
                try:
                    # read the body BEFORE any early reply: on a keep-alive
                    # (HTTP/1.1) connection an unread body would be parsed
                    # as the next request line, desyncing the stream
                    payload = self._body()
                    identity = self.headers.get("X-Druid-Identity")
                    if outer.auth_chain is not None:
                        auth = outer.auth_chain.authenticate(
                            dict(self.headers))
                        if auth is None:
                            self._reply(401, {"error": "unauthenticated"})
                            return
                        identity = auth
                    svc = outer._coord_service(self.path)
                    if svc is not None:
                        self._handle_coordination(svc, payload)
                    elif self.path.rstrip("/") == \
                            "/druid/v2/subscriptions":
                        if outer.subscription_hub is None:
                            self._reply(404, {"error": "subscriptions not "
                                              "enabled"})
                        else:
                            self._subscribe(payload, identity)
                    elif self.path.rstrip("/") == "/druid/v2/sql/avatica":
                        if outer.avatica is None:
                            self._reply(404, {"error": "SQL not enabled"})
                            return
                        authorize = None
                        if outer.auth_chain is not None:
                            def authorize(stmt, params=(), _id=identity):
                                return outer._authorize_sql(_id, stmt,
                                                            params)
                        self._reply(200, outer.avatica.handle(
                            payload, authorize, identity=identity))
                    elif self.path.rstrip("/") == "/druid/v2/sql":
                        if outer.sql_executor is None:
                            self._reply(404, {"error": "SQL not enabled"})
                            return
                        if outer.auth_chain is not None and not \
                                outer._authorize_sql(
                                    identity, payload["query"],
                                    payload.get("parameters") or ()):
                            self._reply(403, {"error": "unauthorized"})
                            return
                        cols, rows = outer.sql_executor.execute(
                            payload["query"],
                            payload.get("parameters") or (),
                            payload.get("context") or None)
                        # SQL surface of the partial-result contract:
                        # the shaped rows stay typed through the executor
                        missing = getattr(rows, "missing_segments", None)
                        headers = None if missing is None else {
                            "X-Druid-Response-Context": json.dumps(
                                {"partial": True,
                                 "missingSegments": missing})}
                        fmt = payload.get("resultFormat", "object")
                        if fmt == "array":
                            self._reply(200, list(rows), headers)
                        else:
                            self._reply(200, [dict(zip(cols, r))
                                              for r in rows], headers)
                    elif self.path.rstrip("/") == "/druid/v2":
                        if payload.get("queryType") == "scan" and \
                                "application/x-ndjson" in (
                                    self.headers.get("Accept") or ""):
                            self._stream_scan(payload, identity)
                            return
                        # ETag over the (query, exact segment set) identity
                        # (QueryResource's If-None-Match / X-Druid-ETag).
                        # Parsed ONCE; lifecycle.etag authorizes before any
                        # 304 so a match never leaks forbidden data's state
                        from druid_tpu_torch.query.model import query_from_json
                        try:
                            query = query_from_json(payload)
                        except (ValueError, KeyError, TypeError):
                            # malformed queries count as failures, like
                            # run_json's resource-layer accounting
                            if outer.lifecycle.on_result:
                                outer.lifecycle.on_result(False)
                            raise
                        etag = outer.lifecycle.etag(query,
                                                    identity=identity)
                        if etag is not None and \
                                self.headers.get("If-None-Match") == etag:
                            outer.lifecycle.log_conditional_hit(query, etag)
                            self.send_response(304)
                            self.send_header("X-Druid-ETag", etag)
                            self.send_header("Content-Length", "0")
                            self.end_headers()
                            return
                        rows = outer.lifecycle.run(query,
                                                   identity=identity)
                        headers = {}
                        # a degraded result (allowPartialResults) stamps
                        # its missing-segments report on the response
                        # context header — the contract is EXPLICIT,
                        # exactly once, never a silent hole in the rows.
                        # It must NOT carry the ETag: the etag names the
                        # COMPLETE result over this segment set, and a
                        # client caching the partial body against it
                        # would be confirmed 304-fresh forever after the
                        # cluster heals — the conditional-request twin of
                        # 'partials never populate the result cache'
                        missing = getattr(rows, "missing_segments", None)
                        if missing is not None:
                            headers["X-Druid-Response-Context"] = \
                                json.dumps({"partial": True,
                                            "missingSegments": missing})
                        elif etag:
                            headers["X-Druid-ETag"] = etag
                        self._reply(200, rows, headers or None)
                    else:
                        self._reply(404, {"error": "unknown path"})
                except Unauthorized as e:
                    self._reply(403, {"error": str(e)})
                except QueryTimeoutError as e:
                    self._reply(504, {"error": "Query timed out",
                                      "errorMessage": str(e)})
                except QueryCapacityError as e:
                    # a saturated data tier shed the query (scheduler
                    # admission): surface the same 429 + Retry-After
                    # contract to the original client
                    self._reply(429, {"error": "Query capacity exceeded",
                                      "errorMessage": str(e)},
                                {"Retry-After": e.retry_after_header()})
                except QueryInterruptedError as e:
                    self._reply(500, {"error": "Query cancelled",
                                      "errorMessage": str(e)})
                except (ValueError, KeyError) as e:
                    # bad query = client error (QueryResource's
                    # BadJsonQueryException handling)
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                except Exception as e:
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

            def _stream_scan(self, payload: dict, identity) -> None:
                """Chunked NDJSON scan results: one batch per line, written
                as the engine produces it — rows reach the client before
                the scan finishes (the Sequence-streaming surface of
                QueryResource). A failure after the first chunk can only
                truncate: the missing terminal chunk tells the client."""
                from druid_tpu_torch.query.model import query_from_json
                try:
                    query = query_from_json(payload)
                except (ValueError, KeyError, TypeError):
                    # malformed queries count as failures here too, like
                    # run_json's resource-layer accounting
                    if outer.lifecycle.on_result:
                        outer.lifecycle.on_result(False)
                    raise
                gen = outer.lifecycle.run_streaming(query,
                                                    identity=identity)
                # pull the first batch BEFORE sending headers so pre-stream
                # failures (auth, planning) take the normal error path
                first = next(gen, None)
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(b: dict) -> None:
                    line = json.dumps(
                        b, default=_json_value).encode() + b"\n"
                    self.wfile.write(f"{len(line):X}\r\n".encode()
                                     + line + b"\r\n")

                try:
                    if first is not None:
                        chunk(first)
                    for batch in gen:
                        chunk(batch)
                    self.wfile.write(b"0\r\n\r\n")
                except Exception:
                    # client gone: close the generator NOW so the
                    # lifecycle's abandoned-stream accounting fires
                    # deterministically, then drop the connection (the
                    # missing terminal chunk marks truncation)
                    logging.getLogger(__name__).debug(
                        "result stream aborted mid-flight", exc_info=True)
                    gen.close()
                    self.close_connection = True

            # ---- standing-query subscriptions (server/subscriptions.py)
            def _poll_subscription(self) -> None:
                import urllib.parse
                from druid_tpu_torch.server.subscriptions import \
                    UnknownSubscriptionError
                parsed = urllib.parse.urlparse(self.path)
                sub_id = parsed.path[len("/druid/v2/subscriptions/"):] \
                    .rstrip("/")
                params = urllib.parse.parse_qs(parsed.query)
                try:
                    timeout_s = float(params.get("timeoutMs",
                                                 ["0"])[0]) / 1000.0
                except ValueError:
                    timeout_s = 0.0
                etag = self.headers.get("If-None-Match")
                try:
                    rows, new_etag, changed = outer.subscription_hub.poll(
                        sub_id, etag=etag, timeout_s=timeout_s)
                except UnknownSubscriptionError:
                    # swept as idle or never registered: the client
                    # re-subscribes
                    self._reply(404, {"error": "unknown subscription",
                                      "subscriptionId": sub_id})
                    return
                if not changed:
                    self.send_response(304)
                    self.send_header("X-Druid-ETag", new_etag)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self._reply(200, rows, {"X-Druid-ETag": new_etag})

            def _subscribe(self, payload, identity) -> None:
                """POST /druid/v2/subscriptions: body = a native aggregate
                query; authorizes (with the identity do_POST already
                authenticated) exactly like a one-shot run of it."""
                from druid_tpu_torch.engine.standing import StandingIneligible
                from druid_tpu_torch.query.model import query_from_json
                query = query_from_json(payload)
                authorizer = getattr(outer.lifecycle, "authorizer", None)
                if authorizer is not None \
                        and not authorizer(identity, query):
                    self._reply(403, {"error": "unauthorized"})
                    return
                try:
                    sub_id, etag = outer.subscription_hub.subscribe(query)
                except StandingIneligible as e:
                    self._reply(400, {"error": f"StandingIneligible: {e}"})
                    return
                self._reply(200, {"subscriptionId": sub_id, "etag": etag},
                            {"X-Druid-ETag": etag})

            def do_DELETE(self):
                # DELETE /druid/v2/{id} — QueryResource.cancelQuery:
                # 202 accepted whether or not the id was in flight
                from druid_tpu_torch.server.querymanager import cancel_path_id
                if not self._authenticated():
                    return
                if self.path.startswith("/druid/v2/subscriptions/"):
                    if outer.subscription_hub is None:
                        self._reply(404, {"error": "subscriptions not "
                                          "enabled"})
                        return
                    sub_id = self.path[
                        len("/druid/v2/subscriptions/"):].rstrip("/")
                    found = outer.subscription_hub.unsubscribe(sub_id)
                    self._reply(202, {"subscriptionId": sub_id,
                                      "active": bool(found)})
                    return
                qid = cancel_path_id(self.path)
                if qid is not None:
                    found = outer.lifecycle.cancel(qid)
                    self._reply(202, {"queryId": qid,
                                      "inFlight": bool(found)})
                else:
                    self._reply(404, {"error": "unknown path"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _datasources(self):
        r = self.lifecycle.runner
        return list(getattr(r, "datasources", []) or [])

    def _coord_service(self, path: str) -> Optional[str]:
        """Which coordination service a path addresses (None when it is
        not a coordination path or that service is not hosted here)."""
        for prefix, svc in (("/druid/coordinator/v1", "coordinator"),
                            ("/druid/indexer/v1", "overlord")):
            if (path == prefix or path.startswith(prefix + "/")) \
                    and svc in self.coordination:
                return svc
        return None

    def _authorize_sql(self, identity, statement: str,
                       parameters=()) -> bool:
        """Per-table READ authorization for a SQL statement — shared by
        the plain SQL resource and the Avatica endpoint (SqlResource's
        resource-action collection)."""
        from druid_tpu_torch.server.security import (READ, Resource,
                                                     ResourceAction)
        tables, is_meta = self.sql_executor.tables_of(statement, parameters)
        # INFORMATION_SCHEMA itself needs no table grant, but a statement
        # mixing it with real tables (UNION ALL arm, IN-subquery) must still
        # pass the real tables' READ checks — is_meta alone is not a bypass
        if is_meta and not tables:
            return True
        return self.auth_chain.authorize_all(
            identity, [ResourceAction(Resource(t), READ) for t in tables])

    def metrics_tick(self) -> None:
        """Drive the query-count monitor once (tests; the scheduler drives
        it periodically after start())."""
        self._monitors.tick()

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        self._monitors.start()
        return self

    def stop(self):
        self._monitors.stop()
        # un-chain what __init__ installed on the shared lifecycle — only
        # if still ours (a later server generation may have re-chained)
        if self.lifecycle.on_result is self._installed_on_result:
            self.lifecycle.on_result = self._prev_on_result
        self._restore_sink()
        self._httpd.shutdown()
        self._httpd.server_close()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
