"""The port's engine stage spans and their profiler ranges
(druid_tpu_torch/obs/trace.py), on the CPU.

  * a groupBy over four segments that batch and one straggler opens
    engine/plan, engine/stage, engine/reduce and engine/to_host under
    engine/partials, through the executor and through the broker over a
    data node; no engine/plan nests in another; the segments that run
    alone fold into one span a stage, their runs counted;
  * a full trace store still keeps the parents of the spans it holds;
  * every span's cpuMs lies in [0, durationMs + 1];
  * {"trace": false} stores no span, builds no Span and opens no profiler
    range: a CPU profile holds no range named after a span;
  * traced over HTTP under a CPU profile of every thread, each stored span
    has a host range of its name starting within 2 ms of its startMs;
  * an HTTP query with or without a queryId is one trace holding
    http/request, http/reply and query.
"""
import json
import threading
import time
import urllib.request
import uuid

import numpy as np
import pytest
import torch

from druid_tpu_torch.cluster import (Broker, DataNode, InventoryView,
                                     descriptor_for)
from druid_tpu_torch.data.convert import segment_from_arrays
from druid_tpu_torch.engine import QueryExecutor, batching
from druid_tpu_torch.obs import trace as qtrace
from druid_tpu_torch.query.model import query_from_json
from druid_tpu_torch.server import QueryHttpServer, QueryLifecycle

torch.set_num_threads(1)

DAY_MS = 86_400_000
T0 = 1_767_225_600_000          # 2026-01-01
STAGES = ("engine/plan", "engine/stage", "engine/reduce", "engine/to_host")
#: every span name the port opens (PERF.md's list)
SPAN_NAMES = {"http/request", "http/reply", "query", "queue/wait",
              "sched/flush", "broker/query", "broker/plan", "broker/scatter",
              "broker/node", "broker/merge", "datanode/query",
              "engine/partials", "pool/h2d", *STAGES}


def _segment(day: int, rows: int, rng):
    start = T0 + day * DAY_MS
    time_ms = np.sort(rng.integers(start, start + DAY_MS, rows))
    return segment_from_arrays(
        time_ms, {"dimA": (rng.integers(0, 5, rows),
                           ["a", "b", "c", "d", "e"])},
        {"metLong": ("long", rng.integers(0, 100, rows))},
        "test", (start, start + DAY_MS))


@pytest.fixture(scope="module")
def segs():
    """Four segments on one batching rung, and a straggler on another."""
    rng = np.random.default_rng(5)
    return [_segment(d, 3_000, rng) for d in range(4)] \
        + [_segment(4, 20_000, rng)]


@pytest.fixture(autouse=True)
def _batching_on(monkeypatch):
    monkeypatch.setattr(batching, "_ENABLED", True)


def _groupby(qid=None, **ctx):
    if qid is not None:
        ctx["queryId"] = qid
    return {"queryType": "groupBy", "dataSource": "test",
            "intervals": ["2026-01-01/2026-01-06"], "granularity": "all",
            "dimensions": ["dimA"],
            "aggregations": [{"type": "count", "name": "rows"},
                             {"type": "longSum", "name": "ls",
                              "fieldName": "metLong"}],
            "context": ctx}


def _broker(segments):
    view = InventoryView()
    node = DataNode("node0", device="cpu")
    view.register(node)
    for s in segments:
        node.load_segment(s)
        view.announce(node.name, descriptor_for(s))
    return Broker(view, device="cpu")


@pytest.fixture(params=["executor", "broker"])
def runner(request, segs):
    r = QueryExecutor(list(segs), device="cpu") \
        if request.param == "executor" else _broker(segs)
    yield r
    if request.param == "broker":
        r.stop()


def _fresh_thread(fn):
    """fn() on a thread of its own, so that no span another test left open
    on this thread's stack parents the query's."""
    out = {}

    def go():
        try:
            out["value"] = fn()
        except BaseException as e:      # re-raised on the caller's thread
            out["error"] = e
    t = threading.Thread(target=go)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    return out["value"]


def _run(runner, payload):
    return _fresh_thread(
        lambda: QueryLifecycle(runner).run(query_from_json(payload)))


def _ancestors(span, by_id):
    p = by_id.get(span["parentId"])
    while p is not None:
        yield p
        p = by_id.get(p["parentId"])


@pytest.mark.parametrize("batched", [True, False])
def test_stage_spans_under_partials(runner, monkeypatch, batched):
    monkeypatch.setattr(batching, "_ENABLED", batched)
    qid = f"stages-{uuid.uuid4().hex[:8]}"
    _run(runner, _groupby(qid))
    spans = qtrace.trace_store().spans(qid)
    by_id = {s["spanId"]: s for s in spans}
    under = [s for s in spans
             if any(a["name"] == "engine/partials"
                    for a in _ancestors(s, by_id))]
    assert set(STAGES) <= {s["name"] for s in under}
    reduces = [s for s in under if s["name"] == "engine/reduce"]
    if batched:
        # one stacked run of four segments, and the straggler's fold
        assert len(reduces) == 2
        assert sorted(s["attrs"].get("runs", 0) for s in reduces) == [0, 1]
    else:
        # five segments alone: one span a stage, five runs each
        for name in STAGES:
            got = [s for s in under if s["name"] == name]
            assert [s["attrs"]["runs"] for s in got] == [5], name
    assert all(a["name"] != "engine/plan"
               for s in spans if s["name"] == "engine/plan"
               for a in _ancestors(s, by_id))
    for s in spans:
        assert 0.0 <= s["attrs"]["cpuMs"] <= s["durationMs"] + 1.0, s


def test_full_store_keeps_the_parents_of_its_spans():
    """Parents finish after their children: past the cap a leaf is
    dropped, a parent of a kept span is kept."""
    store = qtrace.TraceStore(max_spans_per_trace=2)

    def add(sid, parent):
        store.add_json({"traceId": "t", "spanId": sid, "parentId": parent,
                        "name": sid, "startMs": 0.0})
    for i in range(3):
        add(f"leaf{i}", "partials")
    add("partials", "root")
    add("root", None)
    got = store.get("t")
    assert {s["spanId"] for s in got["spans"]} == \
        {"leaf0", "leaf1", "partials", "root"}
    assert got["droppedSpans"] == 1


def _host_ranges(fn):
    """fn() run under a CPU profile of every thread: [(name, start s,
    thread)], the thread 0 for the events of the thread that ran fn."""
    from torch.profiler import ProfilerActivity, profile
    try:
        from torch._C._profiler import _ExperimentalConfig
        prof = profile(activities=[ProfilerActivity.CPU],
                       experimental_config=_ExperimentalConfig(
                           profile_all_threads=True))
    except (ImportError, TypeError):
        prof = profile(activities=[ProfilerActivity.CPU])

    def marked():
        with torch.profiler.record_function("fn-thread"):
            pass
        return fn()
    with prof:
        _fresh_thread(marked)
    events = list(prof.profiler.kineto_results.events())
    me = next(e.start_thread_id() for e in events if e.name() == "fn-thread")
    return [(e.name(), e.start_ns() / 1e9,
             0 if e.start_thread_id() == me else e.start_thread_id())
            for e in events]


@pytest.mark.parametrize("traced", [False, True])
def test_untraced_query_opens_nothing(runner, monkeypatch, traced):
    """{"trace": false} builds no Span of the query and enters no profiler
    range; the traced run of the same query does both (the counters hook).
    Threads that other tests left running may trace their own work: the
    counters take the query's trace id, the profile the query's thread."""
    qid = f"off-{uuid.uuid4().hex[:8]}"
    calls = {"span": 0, "range": 0}
    mine = threading.local()
    init, rf = qtrace.Span.__init__, qtrace._profiler_range

    def counted_init(self, *a, **kw):
        mine.flag = kw.get("trace_id") == qid
        calls["span"] += mine.flag
        init(self, *a, **kw)

    def counted_rf(name):
        calls["range"] += getattr(mine, "flag", False)
        return rf(name)
    monkeypatch.setattr(qtrace.Span, "__init__", counted_init)
    monkeypatch.setattr(qtrace, "_profiler_range", counted_rf)
    ranges = _host_ranges(lambda: QueryLifecycle(runner).run(
        query_from_json(_groupby(qid, trace=traced))))
    if traced:
        assert calls["span"] > 0 and calls["range"] == calls["span"]
        assert set(STAGES) <= {n for n, _, _ in ranges}
    else:
        assert calls == {"span": 0, "range": 0}
        assert qtrace.trace_store().get(qid) is None
        assert not {n for n, _, t in ranges if t == 0} & SPAN_NAMES


def test_spans_open_across_a_profile_start_and_stop():
    """Spans open on other threads while a profile starts and stops end
    cleanly (a range entered before the profile has nothing to end), and
    those opened inside it are in it."""
    errors, stop = [], threading.Event()

    def work():
        while not stop.is_set():
            try:
                with qtrace.root_span("query", store=qtrace.TraceStore()):
                    with qtrace.span("engine/plan"):
                        time.sleep(0.002)
            except Exception as e:          # reported below
                errors.append(e)
    threads = [threading.Thread(target=work) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        names = set()
        for _ in range(3):
            time.sleep(0.03)
            names |= {n for n, _, _ in _host_ranges(lambda: time.sleep(0.05))}
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert {"query", "engine/plan"} <= names


@pytest.fixture()
def http_port(segs):
    broker = _broker(segs)
    srv = QueryHttpServer(QueryLifecycle(broker)).start()
    yield srv.port
    srv.stop()
    broker.stop()


def _spans_once_closed(tid):
    """The trace's spans once its root is stored: the root closes after the
    reply's last byte, so the client can read the reply first."""
    deadline = time.monotonic() + 10.0
    while True:
        spans = qtrace.trace_store().spans(tid)
        if any(s["name"] == "http/request" for s in spans) \
                or time.monotonic() > deadline:
            return spans
        time.sleep(0.01)


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/druid/v2", json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200
        return json.loads(r.read())


def test_spans_are_profiler_ranges_over_http(http_port):
    qid = f"prof-{uuid.uuid4().hex[:8]}"
    ranges = _host_ranges(lambda: (_post(http_port, _groupby(qid)),
                                   _spans_once_closed(qid)))
    spans = qtrace.trace_store().spans(qid)
    assert {"http/request", "http/reply", *STAGES} <= \
        {s["name"] for s in spans}
    for s in spans:
        gaps = [abs(t * 1e3 - s["startMs"]) for n, t, _ in ranges
                if n == s["name"]]
        assert gaps and min(gaps) <= 2.0, (s["name"], gaps)


@pytest.mark.parametrize("with_id", [False, True])
def test_http_query_is_one_trace(http_port, with_id):
    qid = f"http-{uuid.uuid4().hex[:8]}" if with_id else None
    before = set(qtrace.trace_store().trace_ids())
    _post(http_port, _groupby(qid))
    new = set(qtrace.trace_store().trace_ids()) - before
    assert len(new) == 1
    tid = new.pop()
    if with_id:
        assert tid == qid
    spans = _spans_once_closed(tid)
    by_name = {s["name"]: s for s in spans}
    assert {"http/request", "http/reply", "query"} <= set(by_name)
    root = by_name["http/request"]
    assert root["parentId"] is None
    assert by_name["query"]["parentId"] == root["spanId"]
    assert by_name["http/reply"]["parentId"] == root["spanId"]
