"""Push-based ingestion: the HTTP event-receiver firehose.

The port's own copy of the reference package's `ingest/receiver.py`.

Reference analog: server/src/main/java/org/apache/druid/segment/realtime/
firehose/EventReceiverFirehoseFactory.java — clients POST batches of JSON
events to /druid/worker/v1/chat/{serviceName}/push-events; the firehose
buffers them (bounded) until the producer closes the stream, and an index
task drains it like any other firehose.
"""
from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator, List

from druid_tpu_torch.ingest.input import Firehose


class EventReceiverFirehose(Firehose):
    """Bounded-buffer push firehose with an HTTP front.

    batches() blocks on the buffer and ends when close() is called (or the
    producer POSTs to /shutdown) and the buffer drains — exactly the
    EventReceiverFirehose lifecycle."""

    def __init__(self, service_name: str, host: str = "127.0.0.1",
                 port: int = 0, max_buffered: int = 100_000):
        self.service_name = service_name
        self.max_buffered = max_buffered
        self._q: "queue.Queue[object]" = queue.Queue()
        self._closed = threading.Event()
        self.events_received = 0
        self._recv_lock = threading.Lock()
        outer = self
        base = f"/druid/worker/v1/chat/{service_name}"

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _reply(self, code: int, body: dict):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                try:
                    self.wfile.write(data)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                if self.path == f"{base}/push-events":
                    if outer._closed.is_set():
                        self._reply(409, {"error": "firehose closed"})
                        return
                    try:
                        events = json.loads(self.rfile.read(n) or b"[]")
                    except ValueError as e:
                        self._reply(400, {"error": str(e)})
                        return
                    if not isinstance(events, list):
                        events = [events]
                    # all-or-nothing admission: a partially-enqueued batch
                    # answered 503 would be retried by the client and its
                    # accepted prefix ingested twice
                    with outer._recv_lock:
                        if outer._q.qsize() + len(events) > \
                                outer.max_buffered:
                            self._reply(503, {"error": "buffer full"})
                            return
                        for e in events:
                            outer._q.put(e)
                        outer.events_received += len(events)
                    self._reply(200, {"eventCount": len(events)})
                elif self.path == f"{base}/shutdown":
                    outer.close()
                    self._reply(200, {"shutdown": True})
                else:
                    self._reply(404, {"error": "unknown path"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return (f"http://127.0.0.1:{self.port}"
                f"/druid/worker/v1/chat/{self.service_name}")

    def to_json(self) -> dict:
        """Factory form (EventReceiverFirehoseFactory): a task carrying
        this spec OPENS the endpoint where it runs — a forked peon hosts
        its own chat handler, exactly like the reference."""
        return {"type": "receiver", "serviceName": self.service_name}

    def close(self) -> None:
        self._closed.set()

    def stop(self) -> None:
        self.close()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    # ---- Firehose ------------------------------------------------------
    def batches(self, batch_size: int = 65536) -> Iterator[List]:
        buf: List = []
        while True:
            try:
                buf.append(self._q.get(timeout=0.05))
                if len(buf) >= batch_size:
                    yield buf
                    buf = []
            except queue.Empty:
                if buf:
                    yield buf
                    buf = []
                if self._closed.is_set() and self._q.empty():
                    return
