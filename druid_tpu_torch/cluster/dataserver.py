"""The network data plane: data-node HTTP server + the broker's per-server
HTTP query client (the port's own copy of the reference package's
`cluster/dataserver.py`, over the port's DataNode and engines).

Reference analogs:
  server/QueryResource.java:153 — the historical/realtime query endpoint the
    broker hits per server (here split into /partials for aggregate queries,
    which return binary partial-state bundles, and /rows for row queries)
  server/QueryResource.java:126 — DELETE /druid/v2/{id} cancel
  client/DirectDruidClient.java:98 — the broker-side per-server client
    (async Netty there; blocking-in-threadpool here — the broker already
    fans out across servers on a ThreadPoolExecutor)

Wire formats: queries travel as Druid-native JSON; aggregate partials come
back as the tensor-bundle binary (cluster/wire.py); row results as JSON.
Server-side the node enforces the query's context timeout and honors
cancellation between per-segment computations (a batched run over several
segments is uninterruptible once launched — the check runs before and
after it).

Each request runs on its own ThreadingHTTPServer thread; the node's engines
run on the node's device (CUDA unless it was built with device="cpu"), on
that thread's current stream. Nothing here falls back: a node error answers
with its typed HTTP status, and the client raises the matching typed error.

The server's monitors are the reference's less ShardedMonitor, which waits
for the multi-GPU slice (ROADMAP A12); SegmentLoadMonitor emits the
segment/load/* metrics of storage/format_v2.py's loads.
"""
from __future__ import annotations

import json
import random
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence, Set, Tuple

from druid_tpu_torch.cluster import wire
from druid_tpu_torch.cluster.view import DataNode
from druid_tpu_torch.obs import trace as qtrace
from druid_tpu_torch.obs.prometheus import CONTENT_TYPE as PROM_CONTENT_TYPE
from druid_tpu_torch.obs.prometheus import MetricRegistry, compose_sink
from druid_tpu_torch.query.model import Query, query_from_json
from druid_tpu_torch.server.http import _json_value
from druid_tpu_torch.server.querymanager import (DEFAULT_TIMEOUT_MS, Deadline,
                                                 QueryCapacityError,
                                                 QueryInterruptedError,
                                                 QueryManager,
                                                 QueryTimeoutError,
                                                 cancel_path_id)
from druid_tpu_torch.server.scheduler import (DataNodeScheduler,
                                              SchedulerConfig,
                                              SchedulerMetricsMonitor)
from druid_tpu_torch.utils.emitter import (QueryCountStatsMonitor,
                                           ServiceEmitter)


class RemoteQueryError(RuntimeError):
    """A data node answered with a query error (HTTP 4xx/5xx). Distinct from
    ConnectionError on purpose: the broker retries unreachable servers on
    other replicas, but a deterministic query error must propagate with the
    node's actual message, not degrade into MissingSegmentsError."""

    def __init__(self, server: str, code: int, detail: str):
        super().__init__(f"server [{server}] HTTP {code}: {detail}")
        self.server = server
        self.code = code
        self.detail = detail


class DataNodeServer:
    """Serves one DataNode's query surface over HTTP.

    Observability/pool plumbing: `emitter` (a ServiceEmitter) wires the
    device-pool and batched-execution monitors — segment/devicePool/hitRate,
    segment/devicePool/evictedBytes, query/batch/segments,
    query/batch/fillRatio — on a MonitorScheduler owned by this server
    (start()/stop() manage it; metrics_tick() drives it manually in tests).
    `device_pool_bytes` sets the process-wide device-memory budget staged
    segment blocks LRU-evict against (the data node is where segments
    live, so its server is where the budget is configured — the analog of
    the historical's druid.server.maxSize); the pool is one per process,
    so the last server to set it wins."""

    def __init__(self, node: DataNode, host: str = "127.0.0.1",
                 port: int = 0, emitter=None,
                 device_pool_bytes: Optional[int] = None,
                 monitor_period_seconds: float = 60.0,
                 trace_store: Optional[qtrace.TraceStore] = None,
                 scheduler_config: Optional[SchedulerConfig] = None):
        """`trace_store` (default: the process singleton) receives this
        node's qtrace spans and backs GET /druid/v2/trace/<queryId>; a
        MetricRegistry always backs GET /metrics — the given `emitter`'s
        sink is composed with it, or a registry-only ServiceEmitter is
        created so every data node is scrapeable out of the box.

        `scheduler_config` turns on the admission-controlled cross-query
        scheduler (server/scheduler.py): aggregate /partials requests are
        held for the batching window and fused across queries; saturation
        answers HTTP 429 + Retry-After instead of queueing unboundedly."""
        self.node = node
        self.query_manager = QueryManager()
        self.scheduler: Optional[DataNodeScheduler] = None
        self._scheduler_config = scheduler_config
        self.trace_store = trace_store if trace_store is not None \
            else qtrace.trace_store()
        self.registry = MetricRegistry()
        self._query_counts = QueryCountStatsMonitor()
        if device_pool_bytes is not None:
            from druid_tpu_torch.data.devicepool import device_pool
            device_pool().configure(device_pool_bytes)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, code: int, ctype: str, data: bytes,
                      headers=None):
                # the client may have hung up already (its own timeout
                # fired) — a late reply to a dead socket is not an error
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(data)))
                    for k, v in (headers or {}).items():
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.write(data)
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True

            def _reply_json(self, code: int, body, headers=None):
                self._send(code, "application/json",
                           json.dumps(body, default=_json_value).encode(),
                           headers=headers)

            def _reply_bytes(self, data: bytes):
                self._send(200, wire.CONTENT_TYPE, data)

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def do_GET(self):
                if self.path == "/status":
                    descs = [d.to_json()
                             for d in outer.node.served_descriptors()]
                    self._reply_json(200, {
                        "version": "druid-tpu-0.2",
                        "server": outer.node.name,
                        "tier": outer.node.tier,
                        "segments": sorted(outer.node.served_segment_ids()),
                        # full descriptors so a broker's inventory sync can
                        # announce without being hand-fed
                        # (HttpServerInventoryView's segment listing)
                        "segmentDescriptors": descs})
                elif self.path.rstrip("/") == "/metrics":
                    self._send(200, PROM_CONTENT_TYPE,
                               outer.registry.exposition().encode())
                elif self.path.startswith("/druid/v2/trace/"):
                    qid = urllib.parse.unquote(
                        self.path[len("/druid/v2/trace/"):].rstrip("/"))
                    got = outer.trace_store.get(qid)
                    if got is None:
                        self._reply_json(404, {"error": "unknown trace",
                                               "queryId": qid})
                    else:
                        self._reply_json(200, got)
                else:
                    self._reply_json(404, {"error": "unknown path"})

            def do_POST(self):
                path = self.path.rstrip("/")
                try:
                    payload = self._body()
                    if path == "/druid/v2/partials":
                        self._partials(payload)
                    elif path == "/druid/v2/rows":
                        self._rows(payload)
                    else:
                        self._reply_json(404, {"error": "unknown path"})
                except QueryInterruptedError as e:
                    self._reply_json(500, {"error": "Query cancelled",
                                           "errorMessage": str(e)})
                except QueryTimeoutError as e:
                    self._reply_json(504, {"error": "Query timed out",
                                           "errorMessage": str(e)})
                except QueryCapacityError as e:
                    # the scheduler shed at admission: the 429 contract —
                    # not a hang, not a 500 — with the drain estimate as
                    # Retry-After so a well-behaved client backs off
                    self._reply_json(
                        429, {"error": "Query capacity exceeded",
                              "errorMessage": str(e)},
                        headers={"Retry-After": e.retry_after_header()})
                except (ValueError, KeyError) as e:
                    self._reply_json(400,
                                     {"error": f"{type(e).__name__}: {e}"})
                except Exception as e:
                    self._reply_json(500,
                                     {"error": f"{type(e).__name__}: {e}"})

            def _run(self, payload, rows_mode: bool):
                """Returns ((result, served), spans): the request's finished
                qtrace spans ride back in the response so the broker can
                assemble one end-to-end trace."""
                query = query_from_json(payload["query"])
                sids = payload.get("segments") or []
                qid = query.context_map.get("queryId")
                token = outer.query_manager.register(qid) if qid else None
                deadline = Deadline.for_query(query)

                def check():
                    if token is not None:
                        token.check()
                    deadline.check()

                t0 = time.monotonic()
                ok = False
                try:
                    # re-root this node's spans under the broker's remote
                    # parent (context traceparent); collect=True captures
                    # the request's spans for the response payload
                    with qtrace.root_span("datanode/query", query,
                                          service=outer.node.name,
                                          store=outer.trace_store,
                                          collect=True) as root:
                        check()
                        if rows_mode:
                            out = outer.node.run_rows(query, sids)
                        elif outer.scheduler is not None \
                                and outer.node.fusable(query):
                            # admission-controlled cross-query path: the
                            # hold opens a queue/wait span under THIS
                            # request's root; saturation raises
                            # QueryCapacityError (429 above). Work the
                            # node cannot fuse (per-segment metrics)
                            # skips the queue — it would only serialize on
                            # the dispatcher thread. Segment-cache queries
                            # DO queue: hits resolve inline in the flush,
                            # misses join the fused wave
                            out = outer.scheduler.submit(query, sids,
                                                         check=check)
                        else:
                            out = outer.node.run_partials(query, sids,
                                                          check=check)
                        check()
                    ok = True
                    return out, (root.collected()
                                 if root is not None else [])
                finally:
                    if qid:
                        outer.query_manager.unregister(qid)
                    outer._query_counts.on_query(ok)
                    outer.emitter.metric(
                        "query/time", (time.monotonic() - t0) * 1e3,
                        dataSource=query.datasource, type=query.query_type,
                        id=qid or "", success=str(ok).lower())

            def _partials(self, payload):
                (ap, served), spans = self._run(payload, rows_mode=False)
                # the explicit wire half of the partial-result contract:
                # requested-but-unserved ids (the broker degrades on them
                # when the query allows partials)
                missing = [s for s in (payload.get("segments") or [])
                           if str(s) not in served]
                # compressed payload mode: requester advertised support
                # AND the query context did not opt out
                ctx = (payload.get("query") or {}).get("context") or {}
                compress = bool(payload.get("wireCompress")) \
                    and ctx.get("wireCompress", True) is not False
                self._reply_bytes(wire.dumps_partials(ap, served,
                                                      trace=spans,
                                                      missing=missing,
                                                      compress=compress))

            def _rows(self, payload):
                (rows, served), spans = self._run(payload, rows_mode=True)
                self._reply_json(200, {"rows": rows,
                                       "served": sorted(served),
                                       "trace": spans})

            def do_DELETE(self):
                qid = cancel_path_id(self.path)
                if qid is not None:
                    outer.query_manager.cancel(qid)
                    self._reply_json(202, {"queryId": qid})
                else:
                    self._reply_json(404, {"error": "unknown path"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        # every node is scrapeable: the registry joins the given emitter's
        # sink chain (undone on stop(), so an emitter reused across server
        # generations doesn't feed dead registries), or becomes the sink
        # of a fresh ServiceEmitter
        self._restore_sink = lambda: None
        if emitter is None:
            emitter = ServiceEmitter("druid/historical",
                                     f"{self.host}:{self.port}",
                                     self.registry)
        else:
            self._restore_sink = compose_sink(emitter, self.registry)
        self.emitter = emitter
        from druid_tpu_torch.data.cascade import CodeDomainMonitor
        from druid_tpu_torch.data.devicepool import DevicePoolMonitor
        from druid_tpu_torch.engine.batching import BatchMetricsMonitor
        from druid_tpu_torch.engine.filters import FilterBitmapMonitor
        from druid_tpu_torch.engine.megakernel import MegakernelMonitor
        from druid_tpu_torch.obs.dispatch import DispatchMonitor
        from druid_tpu_torch.parallel.distributed import ShardedMonitor
        from druid_tpu_torch.storage.format_v2 import SegmentLoadMonitor
        from druid_tpu_torch.utils.emitter import MonitorScheduler
        monitors = [DevicePoolMonitor(), BatchMetricsMonitor(),
                    FilterBitmapMonitor(), MegakernelMonitor(),
                    CodeDomainMonitor(), DispatchMonitor(),
                    ShardedMonitor(), wire.WireStatsMonitor(),
                    SegmentLoadMonitor(), self._query_counts]
        if self._scheduler_config is not None:
            self.scheduler = DataNodeScheduler(
                node, self._scheduler_config, emitter=emitter)
            monitors.append(SchedulerMetricsMonitor(self.scheduler))
        self._monitors = MonitorScheduler(
            emitter, monitors, period_seconds=monitor_period_seconds)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def metrics_tick(self) -> None:
        """Drive the pool/batch monitors once (tests; the scheduler drives
        them periodically after start())."""
        if self._monitors is not None:
            self._monitors.tick()

    def start(self) -> "DataNodeServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        if self.scheduler is not None:
            self.scheduler.start()
        if self._monitors is not None:
            self._monitors.start()
        return self

    def stop(self) -> None:
        if self._monitors is not None:
            self._monitors.stop()
        self._restore_sink()
        self._httpd.shutdown()
        self._httpd.server_close()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        if self.scheduler is not None:
            # after the listener: no new submits can arrive; queued
            # waiters fail fast instead of hanging on a dead dispatcher
            self.scheduler.stop()


class RemoteDataNodeClient:
    """The broker's per-server query client (DirectDruidClient analog).

    Exposes the same (run_partials / run_rows) surface as an in-process
    DataNode so the broker's scatter path is transport-agnostic; registered
    into the InventoryView exactly like a local node. Socket timeouts follow
    the query's context timeout; cancel() propagates the DELETE."""

    def __init__(self, name: str, base_url: str,
                 connect_timeout: float = 5.0,
                 jitter_seed: Optional[int] = None):
        """jitter_seed: seeds the Retry-After jitter rng (deterministic
        tests); None draws from entropy, which is what production wants —
        identical seeds across a client fleet would defeat the point."""
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.connect_timeout = connect_timeout
        self.tier = "_default_tier"
        self.alive = True
        self._retry_rng = random.Random(jitter_seed)

    # ---- InventoryView/DataNode surface the broker touches -------------
    def segments(self) -> List:
        return []            # schema discovery uses segmentMetadata queries

    def served_segment_ids(self) -> Set[str]:
        try:
            st = self._status()
            return set(st.get("segments", []))
        except ConnectionError:
            return set()

    def served_descriptors(self) -> List:
        """Full segment descriptors from the node's /status — the sync
        loop's announcement source. PROPAGATES ConnectionError: a blip must
        abort the sync round for this server (liveness handles real
        deaths), not read as 'serves nothing' and mass-unannounce."""
        st = self._status()
        from druid_tpu_torch.cluster.metadata import SegmentDescriptor
        return [SegmentDescriptor.from_json(j)
                for j in st.get("segmentDescriptors", [])]

    def ping(self) -> bool:
        """Liveness probe: a /status round-trip within connect_timeout,
        retried once — one dropped packet must not read as a dead server
        (the view additionally supports multi-cycle grace via
        check_liveness(failures_required=...))."""
        for attempt in (0, 1):
            try:
                self._status()
                return True
            except ConnectionError:
                if attempt:
                    return False
                time.sleep(0.05)
        return False

    def _status(self) -> dict:
        try:
            with urllib.request.urlopen(self.base_url + "/status",
                                        timeout=self.connect_timeout) as r:
                return json.loads(r.read())
        except (urllib.error.URLError, OSError) as e:
            raise ConnectionError(f"server [{self.name}] unreachable: {e}")

    def _timeout_for(self, query: Query) -> float:
        t = query.context_map.get("timeout")
        try:
            t = float(t) if t is not None else 0.0
        except (TypeError, ValueError):
            t = 0.0
        # socket timeout covers connect + full response read; the broker
        # rewrites the context timeout to the REMAINING deadline each
        # scatter round, so this never exceeds the original budget
        return (t / 1000.0) if t > 0 else DEFAULT_TIMEOUT_MS / 1000.0

    #: never sleep longer than this on a Retry-After before the one 429
    #: retry — a long drain estimate should fail fast at the broker, not
    #: camp on a scatter thread
    MAX_RETRY_AFTER_SLEEP = 2.0

    def _post(self, path: str, query: Query, segment_ids: Sequence[str]):
        # wireCompress advertises this client reads compressed tensor
        # entries (wire VERSION_COMPRESSED) — the server only emits them
        # when asked, so old clients keep receiving version-1 bytes
        body = json.dumps({"query": query.to_json(),
                           "segments": [str(s) for s in segment_ids],
                           "wireCompress": True},
                          default=_json_value).encode()
        # ONE total budget across the shed retry: the context timeout is
        # the query's, not per-attempt
        deadline = Deadline.after_s(self._timeout_for(query))
        for attempt in (0, 1):
            req = urllib.request.Request(
                self.base_url + path, data=body,
                headers={"Content-Type": "application/json"},
                method="POST")
            try:
                with urllib.request.urlopen(
                        req, timeout=max(0.1, deadline.remaining())) as r:
                    return r.headers.get_content_type(), r.read()
            except urllib.error.HTTPError as e:
                detail = e.read().decode(errors="replace")
                if e.code == 429:
                    # admission shed: distinguishable from query errors.
                    # Retry ONCE after Retry-After (within the remaining
                    # budget); a second shed propagates as a clear
                    # capacity error, not an opaque RemoteQueryError
                    try:
                        retry_after = float(
                            e.headers.get("Retry-After") or 1.0)
                    except (TypeError, ValueError):
                        retry_after = 1.0
                    # a drain estimate past the cap means the retry is
                    # near-certain to shed again — fail fast instead of
                    # sleeping the cap and reissuing a doomed request.
                    # The actual sleep is decorrelated-jittered ABOVE the
                    # server's estimate: under a 429 storm every client
                    # hears the same Retry-After, and sleeping it exactly
                    # re-synchronizes the whole fleet onto one retry
                    # instant — the next shed wave
                    from druid_tpu_torch.cluster.resilience import \
                        decorrelated_jitter
                    sleep_s = decorrelated_jitter(
                        self._retry_rng, retry_after, retry_after,
                        self.MAX_RETRY_AFTER_SLEEP)
                    if attempt == 0 \
                            and retry_after <= self.MAX_RETRY_AFTER_SLEEP \
                            and sleep_s < deadline.remaining():
                        time.sleep(sleep_s)
                        continue
                    raise QueryCapacityError(
                        f"server [{self.name}] shed the query: {detail}",
                        retry_after_s=retry_after, server=self.name)
                if e.code == 504:
                    raise QueryTimeoutError(detail)
                if e.code == 500 and "cancelled" in detail.lower():
                    raise QueryInterruptedError(detail)
                # a served HTTP error is a QUERY error — propagate the
                # node's message instead of retrying into
                # MissingSegmentsError
                raise RemoteQueryError(self.name, e.code, detail)
            except socket.timeout:
                raise QueryTimeoutError(
                    f"server [{self.name}] did not respond in time")
            except (urllib.error.URLError, OSError) as e:
                if isinstance(getattr(e, "reason", None), socket.timeout):
                    raise QueryTimeoutError(
                        f"server [{self.name}] did not respond in time")
                raise ConnectionError(
                    f"server [{self.name}] unreachable: {e}")

    def run_partials(self, query: Query, segment_ids: Sequence[str]
                     ) -> Tuple[object, Set[str]]:
        ctype, data = self._post("/druid/v2/partials", query, segment_ids)
        if ctype != wire.CONTENT_TYPE:
            raise ConnectionError(
                f"server [{self.name}] returned {ctype}, expected partials")
        ap, served, spans = wire.loads_partials(data)
        self._ingest_trace(spans)
        return ap, served

    def run_rows(self, query: Query, segment_ids: Sequence[str]
                 ) -> Tuple[List[dict], Set[str]]:
        _, data = self._post("/druid/v2/rows", query, segment_ids)
        out = json.loads(data)
        self._ingest_trace(out.get("trace"))
        return out["rows"], set(out["served"])

    def _ingest_trace(self, spans) -> None:
        """Merge the node's returned span tree into this (broker) process's
        trace store — the gather half of qtrace propagation. Span-id dedupe
        in the store makes this idempotent when broker and node share one
        process (in-process tests)."""
        if spans:
            qtrace.trace_store().ingest(spans)

    def cancel(self, query_id: str) -> None:
        req = urllib.request.Request(
            f"{self.base_url}/druid/v2/{query_id}", method="DELETE")
        try:
            urllib.request.urlopen(req, timeout=self.connect_timeout).read()
        except (urllib.error.URLError, OSError):
            pass   # best-effort, server may already be gone
