"""Closed-loop clients, run in a child process of the harness so that
their clocks do not wait on the server's interpreter lock.

Reads one JSON object on standard input: {"url", "clients", "seed",
"start", "seconds", "queries": [{"name", "query"}], "grace_s"}. From
the wall-clock time `start` until `start + seconds` the clients take
the queries in turn in the mix's order (`Queue`), and each posts each
to `url` only after the reply to the one before has been read in full.
A query in flight at the close is waited for up to `grace_s`. Prints
one JSON object: {"records": [...]}, a record a query sent, with its
send and reply times (wall clock, s), its status and its reply body
(None where no reply came).

Imports only the standard library.
"""
from __future__ import annotations

import json
import sys
import threading
import time
import urllib.error
import urllib.request


def post(url: str, body: bytes, timeout: float):
    req = urllib.request.Request(url, data=body, method="POST", headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except (OSError, urllib.error.URLError) as e:
        return 0, str(e).encode()


class Queue:
    """The mix's queries in their listed order, endlessly, shared by the
    clients: a client that is free takes the next. Whatever the seed (it
    changes the data, not the work) and the timing, the queries sent by
    any moment are a prefix of that order, so every window holds the
    same share of each query."""

    def __init__(self, n: int):
        self.n = n
        self.pos = 0
        self.lock = threading.Lock()

    def next(self) -> int:
        with self.lock:
            k = self.pos % self.n
            self.pos += 1
            return k


def client(spec: dict, c: int, queue: Queue, out: list) -> None:
    queries = spec["queries"]
    end = spec["start"] + spec["seconds"]
    timeout = spec["seconds"] + spec["grace_s"]
    i = 0
    while time.time() < end:
        k = queue.next()
        q = dict(queries[k]["query"])
        qid = f"pb-{spec['seed']}-{c}-{i}"
        q["context"] = {**q.get("context", {}), "queryId": qid}
        body = json.dumps(q).encode()
        rec = {"client": c, "index": k, "name": queries[k]["name"],
               "qid": qid, "t_send": time.time(), "t_done": None,
               "status": None, "body": None}
        out.append(rec)           # a query that never returns stays
        status, reply = post(spec["url"], body, timeout)
        rec.update(t_done=time.time(), status=status,
                   body=reply.decode("utf-8", "replace"))
        i += 1


def main() -> int:
    spec = json.loads(sys.stdin.read())
    wait = spec["start"] - time.time()
    if wait > 0:
        time.sleep(wait)
    outs = [[] for _ in range(spec["clients"])]
    queue = Queue(len(spec["queries"]))
    threads = [threading.Thread(target=client,
                                args=(spec, c, queue, outs[c]),
                                daemon=True)
               for c in range(spec["clients"])]
    for t in threads:
        t.start()
    deadline = spec["start"] + spec["seconds"] + spec["grace_s"]
    for t in threads:
        t.join(max(0.0, deadline - time.time()))
    records = [r for o in outs for r in o]
    json.dump({"records": records,
               "unfinished": sum(t.is_alive() for t in threads)},
              sys.stdout)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
